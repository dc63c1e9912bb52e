"""The whole broadcast-FM slice: the port's ``Radio.apply_shared`` with the
spectrum (plain versions of K1-K4) against the JAX package's
``apply_shared(..., _force_fused=True, spectrum=...)`` (its Pallas kernels
in interpret mode), C = 4, over three blocks with a retune before the
third.  Both handoff dtypes: the state bound is 80 dB in float32 and 70 dB
in bf16, where a rounding on the other side of a tie costs a bf16 ulp."""

import numpy as np
import pytest

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio, DEMOD_WFM
from sdrplusplusbrown_tpu.ops import precision as jax_precision
from sdrplusplusbrown_tpu.ops.spectrum import SpectrumPath as JaxSpectrum
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models.radio import Radio
from sdrplusplusbrown_tpu_torch.ops import precision as port_precision
from sdrplusplusbrown_tpu_torch.ops.spectrum import SpectrumPath

from torch_parity import (FS, assert_spectra_close, assert_state_close,
                          planes, port_f32_handoff, snr_db, tone_oracles,
                          wfm_iq)  # noqa: F401

C = 4
FFT = 4096
FFT_RATE = 200.0        # 12 000-sample frame interval: T holds 4 frames
OFFSETS = np.linspace(-0.9e6, 0.9e6, C)
RETUNED = OFFSETS + np.array([0.0, 50e3, -30e3, 0.0])

# Block 1 starts every filter from zero state, and the normalize VCO
# divides by the pilot while the pilot band-pass is still filling; there
# the JAX package's own kernel and XLA paths agree to only 38.3 dB, so the
# bound is 35 dB.  Measured here: 98.9 dB in float32 and 63.0 dB in bf16
# (port vs JAX kernel path).
BLOCK1_MIN_DB = 35.0


@pytest.mark.parametrize("handoff,state_min_db", [("float32", 80.0),
                                                  ("bf16", 70.0)])
def test_apply_shared_matches_jax(handoff, state_min_db):
    jax_precision.set_handoff_dtype(handoff)
    port_precision.set_handoff_dtype(handoff)
    jr = JaxRadio(FS, DEMOD_WFM, pll_mode="normalize")
    pr = Radio(FS, DEMOD_WFM, device="cpu")
    jsp = JaxSpectrum(FS, FFT, FFT_RATE)
    psp = SpectrumPath(FS, FFT, FFT_RATE, device="cpu")
    T = 4 * int(np.lcm(pr.in_multiple, psp.in_multiple))
    assert T == 48_000
    # the JAX path computes the spectrum inside its front-end kernel (and
    # so with the kernel path's frame starts) only where this holds
    assert jr._build_vfo_shared()._mono_pipe(C).spectrum_ok(
        T, jsp.reshaper.keep, jsp.reshaper.interval, FFT)
    x = wfm_iq(3 * T, OFFSETS, seed=21)
    js = jr.init_state_shared(C)
    ps = pr.init_state_shared(C)
    for b in range(3):
        offs = OFFSETS if b < 2 else RETUNED
        xb = x[b * T:(b + 1) * T]
        (ja, jspec), js = jr.apply_shared(
            jr.make_params_shared(offs), js,
            (jnp.asarray(xb.real), jnp.asarray(xb.imag)),
            _force_fused=True, spectrum=jsp)
        (pa, pspec), ps = pr.apply_shared(pr.make_params_shared(offs), ps,
                                          planes(xb), spectrum=psp)
        ja, pa = np.asarray(ja), pa.numpy()
        assert pa.shape == ja.shape == (C, 2, T // 50)
        s = snr_db(ja, pa)
        assert s >= (70.0 if b else BLOCK1_MIN_DB), (b, s)
        assert_spectra_close(np.asarray(jspec), pspec.numpy())
        assert_state_close(js, ps, state_min_db)
        if b == 1:
            tone_snr, sep = tone_oracles(pa, list(range(C)))
            assert tone_snr > 35.0 and sep > 25.0, (tone_snr, sep)
        if b == 2:          # channels the retune left on their carrier
            tone_snr, sep = tone_oracles(pa, [0, 3])
            assert tone_snr > 35.0 and sep > 25.0, (tone_snr, sep)


def test_apply_shared_streams_exactly():
    """Two half blocks give the one-block output (state carries across
    calls) and the block length is checked."""
    pr = Radio(FS, DEMOD_WFM, device="cpu")
    T = 2 * pr.in_multiple * 10
    x = wfm_iq(2 * T, OFFSETS, seed=4)
    params = pr.make_params_shared(OFFSETS)
    one, _ = pr.apply_shared(params, pr.init_state_shared(C), planes(x))
    st = pr.init_state_shared(C)
    a, st = pr.apply_shared(params, st, planes(x[:T]))
    b, st = pr.apply_shared(params, st, planes(x[T:]))
    two = np.concatenate([a.numpy(), b.numpy()], axis=-1)
    assert snr_db(one.numpy(), two) > 100.0
    with pytest.raises(ValueError):
        pr.apply_shared(params, st, planes(x[:T + 1]))
    back = convert.state_to_jax(st)
    assert back["vfo"]["fused"]["tail"].shape == (303,)
