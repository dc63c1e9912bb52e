"""Kernels K8 and K9 (the port's per-stage FIR rows): their plain versions
against the JAX package's Pallas FIR bodies in interpret mode, on the
shapes of the app's per-radio step (the 304-tap decimator, the 159-tap
complex pilot band-pass, the path's polyphase ratios), at 1, 2 and 16
rows and D in {1, 2, 4}.  float32 throughout; the bar is 100 dB (the two
sides sum the same products in another order, ~130 dB apart).  Also the
dispatch: FIR, RealFIR and PolyphaseResampler reach the kernels' plain
versions on CPU tensors and stream exactly across calls."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.ops import pallas_fir as jpf
from sdrplusplusbrown_tpu.ops import resampler as jres
from sdrplusplusbrown_tpu.ops import taps as jtaps
from sdrplusplusbrown_tpu_torch.ops import fir, fir_kernel, resampler

from torch_parity import port_f32_handoff, snr_db  # noqa: F401

BAR_DB = 100.0
K_DECIM = 304        # the WFM front end's 2.4 MS/s → 600 kHz stage
PILOT = jtaps.band_pass_complex(18750.0, 19250.0, 3000.0, 125000.0, True)


def _block(rng, rows, n, cplx):
    shape = (n,) if rows == 1 else (rows, n)
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(np.complex64 if cplx else np.float32)


def _split(ext, hist):
    """ext → (block, tail) torch tensors."""
    return (torch.from_numpy(np.ascontiguousarray(ext[..., hist:])),
            torch.from_numpy(np.ascontiguousarray(ext[..., :hist])))


@pytest.mark.parametrize("rows", [1, 2, 16])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("cplx", [False, True])
def test_fir_rows_matches_pallas_fir(rows, D, cplx):
    """Stride 1: ``fir_apply_any`` (flat ``_fir_kernel`` below 4 rows, the
    channel-blocked decimator at D = 1 above); D > 1:
    ``fir_decim_apply_any`` (``_fir_decim_kernel`` / ``_cb_kernel``)."""
    rng = np.random.default_rng(rows * 10 + D)
    taps = jres.PowerDecimator(2.4e6, 4).stages[0].taps
    assert taps.shape == (K_DECIM,)
    M = 2048 + 5                     # not a multiple of any tile
    ext = _block(rng, rows, M * D + K_DECIM - 1, cplx)
    if D == 1:
        want = jpf.fir_apply_any(jnp.asarray(ext), taps, interpret=True)
    else:
        want = jpf.fir_decim_apply_any(jnp.asarray(ext), taps, D,
                                       interpret=True)
    x, tail = _split(ext, K_DECIM - 1)
    kern = torch.from_numpy(taps.astype(np.float32))[None]
    got, new_tail = fir_kernel.fir_rows_ref(x, tail, kern, 1, D)
    assert got.shape == np.asarray(want).shape and got.dtype == x.dtype
    assert snr_db(np.asarray(want), got.numpy()) >= BAR_DB
    np.testing.assert_array_equal(new_tail.numpy(),
                                  ext[..., -(K_DECIM - 1):])


@pytest.mark.parametrize("rows", [1, 2, 16])
@pytest.mark.parametrize("D", [1, 2, 4])
def test_fir_cplx_matches_pallas_fir_cplx(rows, D):
    """Complex taps on complex rows: ``fir_cplx_apply_any`` (the flat
    ``_fir_cplx_kernel`` below 4 rows, ``_fir_cplx_cb_kernel`` above)."""
    rng = np.random.default_rng(100 + rows * 10 + D)
    K = len(PILOT)
    M = 1024 + 3
    ext = _block(rng, rows, M * D + K - 1, True)
    want = np.asarray(jpf.fir_cplx_apply_any(jnp.asarray(ext), PILOT, D,
                                             interpret=True))
    x, tail = _split(ext, K - 1)
    taps = torch.from_numpy(np.stack([PILOT.real, PILOT.imag])
                            .astype(np.float32))
    got, new_tail = fir_kernel.fir_cplx_ref(x, tail, taps, D)
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert snr_db(want, got.numpy()) >= BAR_DB
    np.testing.assert_array_equal(new_tail.numpy(), ext[..., -(K - 1):])


def _path_resampler(I, D):
    """The path's polyphase stages: WFM 5/6 and NFM 2/3 in the VFO, the
    NFM AF 24/25, the WFM audio 48/125 (de-emphasis folded as the Radio
    folds it)."""
    if (I, D) == (48, 125):
        from sdrplusplusbrown_tpu.models.radio import Radio, DEMOD_WFM
        return Radio(2.4e6, DEMOD_WFM).demod.audio_poly
    fs_in, fs_out = {(5, 6): (600e3, 500e3), (2, 3): (75e3, 50e3),
                     (24, 25): (50e3, 48e3)}[(I, D)]
    rs = jres.RationalResampler(fs_in, fs_out)
    poly = dict(rs.chain.named_blocks)["resamp"]
    assert (poly.interp, poly.decim) == (I, D)
    return poly


@pytest.mark.parametrize("rows", [1, 2, 16])
@pytest.mark.parametrize("I,D,use_roll", [(5, 6, False), (5, 6, True),
                                          (2, 3, False), (2, 3, True),
                                          (24, 25, False), (24, 25, True),
                                          (48, 125, True)])
def test_poly_rows_match_pallas_banded(rows, I, D, use_roll):
    """``poly_resample_apply_any``: the aligned banded bodies
    (``_banded_kernel`` / ``_banded_cb_kernel``) and the rolled ones
    (``_banded_roll_kernel`` / ``_banded_roll_cb_kernel``).  At 48/125 the
    aligned form needs mt = 128 and a 16 368 × 6 144 tap matrix (402 MB),
    which poly_pallas_ok never picks: only the rolled form runs there."""
    jp = _path_resampler(I, D)
    hist = jp.tpp - 1
    rng = np.random.default_rng(I * 1000 + D + rows)
    T = D * 300
    ext = _block(rng, rows, T + hist, False)
    mt = 128 // math.gcd(I, 128) if use_roll else 64
    want = np.asarray(jpf.poly_resample_apply_any(
        jnp.asarray(ext), jp.kernel, I, D, mt=mt, use_roll=use_roll,
        interpret=True))
    pp = resampler.PolyphaseResampler.__new__(resampler.PolyphaseResampler)
    pp.__dict__.update(interp=I, decim=D, tpp=jp.tpp, kernel=jp.kernel)
    x, tail = _split(ext, hist)
    got, new_tail = fir_kernel.fir_rows_ref(
        x, tail, fir.device_taps(pp, pp.kernel, "cpu"), I, D)
    assert got.shape == want.shape == ext.shape[:-1] + (300 * I,)
    assert snr_db(want, got.numpy()) >= BAR_DB
    np.testing.assert_array_equal(new_tail.numpy(), ext[..., -hist:])


@pytest.mark.parametrize("cplx_taps", [False, True])
def test_fir_blocks_stream_through_the_plain_kernels(cplx_taps):
    """FIR.apply over two blocks equals a float64 numpy correlation of the
    whole zero-started stream; PolyphaseResampler over two blocks equals
    one call over both."""
    rng = np.random.default_rng(7)
    taps = PILOT if cplx_taps else jtaps.low_pass(50e3, 10e3, 600e3)
    f = fir.FIR(taps, decim=2)
    x = torch.from_numpy(_block(rng, 3, 4000, True))
    st = f.init_state((3,))
    y1, st = f.apply(None, st, x[:, :2000])
    y2, st = f.apply(None, st, x[:, 2000:])
    ext = np.concatenate([np.zeros((3, f.K - 1)), x.numpy()], axis=-1)
    whole = np.stack([np.convolve(row, taps[::-1], "valid")[::2]
                      for row in ext])
    assert snr_db(whole, torch.cat([y1, y2], -1).numpy()) > 120.0
    assert st.shape == (3, f.K - 1)
    poly = resampler.PolyphaseResampler(5, 6, jtaps.low_pass(
        100e3, 20e3, 3e6) * 5)
    xr = torch.from_numpy(_block(rng, 2, 1200, False))
    s = poly.init_state((2,), torch.float32)
    a, s = poly.apply(None, s, xr[:, :600])
    b, s = poly.apply(None, s, xr[:, 600:])
    one, _ = poly.apply(None, poly.init_state((2,), torch.float32), xr)
    assert snr_db(one.numpy(), torch.cat([a, b], -1).numpy()) > 120.0


def test_fir_rows_rejects_bad_geometry():
    kern = torch.ones(1, 300)
    with pytest.raises(ValueError):        # shorter than the taps
        fir_kernel.fir_rows_ref(torch.zeros(2, 100), torch.zeros(2, 10),
                                kern, 1, 1)
    with pytest.raises(ValueError):        # tail and block rows differ
        fir_kernel.fir_rows_ref(torch.zeros(2, 400), torch.zeros(3, 299),
                                kern, 1, 1)
    with pytest.raises(ValueError):        # real taps given to K9
        fir_kernel.fir_cplx_ref(torch.zeros(2, 400, dtype=torch.complex64),
                                torch.zeros(2, 299, dtype=torch.complex64),
                                kern, 1)
