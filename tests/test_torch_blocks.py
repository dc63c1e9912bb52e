"""The port's plain PyTorch blocks (the building blocks of the kernels'
plain versions) against the JAX package's blocks on the CPU: same inputs
from a seeded numpy generator, same state in and out."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models.rx_vfo import RxVFO as JaxRxVFO
from sdrplusplusbrown_tpu.ops import demod as jdemod, delay as jdelay
from sdrplusplusbrown_tpu.ops import fir as jfir, resampler as jres
from sdrplusplusbrown_tpu.ops import xlator as jxl
from sdrplusplusbrown_tpu.ops import taps as jtaps
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models.rx_vfo import RxVFO
from sdrplusplusbrown_tpu_torch.ops import demod, delay, fir, resampler
from sdrplusplusbrown_tpu_torch.ops import xlator

from torch_parity import port_f32_handoff, snr_db  # noqa: F401


def _cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _stream(jblk, pblk, jst, blocks):
    """Run both blocks over consecutive blocks; yield (jax y, port y)."""
    pst = convert.state_from_jax(jst, device="cpu")
    for xb in blocks:
        jy, jst = jblk.apply(None, jst, jnp.asarray(xb))
        py, pst = pblk.apply(None, pst, torch.from_numpy(xb))
        yield np.asarray(jy), py.numpy(), jst, pst


@pytest.mark.parametrize("kind,decim", [("real", 1), ("real", 4),
                                        ("complex", 1), ("complex", 2)])
def test_fir_streams_like_jax(kind, decim):
    rng = np.random.default_rng(1)
    taps = (jtaps.band_pass_complex(18750.0, 19250.0, 3000.0, 125000.0,
                                    True) if kind == "complex"
            else jtaps.low_pass(50e3, 10e3, 600e3))
    jf, pf = jfir.FIR(taps, decim=decim), fir.FIR(taps, decim=decim)
    blocks = [_cplx(rng, 3, 400 * decim) for _ in range(3)]
    for jy, py, jst, pst in _stream(jf, pf, jf.init_state((3,)), blocks):
        assert jy.shape == py.shape
        assert snr_db(jy, py) > 100.0
        assert snr_db(np.asarray(jst), pst.numpy()) > 100.0


def test_real_fir_and_polyphase_like_jax():
    rng = np.random.default_rng(2)
    taps = jtaps.low_pass(15e3, 4e3, 48e3)
    jf, pf = jfir.RealFIR(taps), fir.RealFIR(taps)
    blocks = [rng.standard_normal((2, 500)).astype(np.float32)
              for _ in range(2)]
    for jy, py, _, _ in _stream(jf, pf, jf.init_state((2,)), blocks):
        assert snr_db(jy, py) > 100.0
    proto = jtaps.low_pass(15e3, 4e3, 125e3 * 48) * 48
    jp = jres.PolyphaseResampler(48, 125, proto)
    pp = resampler.PolyphaseResampler(48, 125, proto)
    np.testing.assert_array_equal(pp.kernel, jp.kernel)
    blocks = [rng.standard_normal((2, 1000)).astype(np.float32)
              for _ in range(2)]
    for jy, py, jst, pst in _stream(jp, pp, jp.init_state((2,), jnp.float32),
                                    blocks):
        assert jy.shape == py.shape == (2, 384)
        assert snr_db(jy, py) > 100.0
        np.testing.assert_array_equal(np.asarray(jst), pst.numpy())


def test_rational_resampler_like_jax():
    rng = np.random.default_rng(3)
    jr = jres.RationalResampler(2.4e6, 500e3)
    pr = resampler.RationalResampler(2.4e6, 500e3)
    assert (pr.in_multiple, pr.ratio) == (jr.in_multiple, jr.ratio)
    blocks = [_cplx(rng, 2, 4800) for _ in range(2)]
    for jy, py, jst, pst in _stream(jr, pr, jr.init_state((2,)), blocks):
        assert jy.shape == py.shape == (2, 1000)
        assert snr_db(jy, py) > 100.0


@pytest.mark.parametrize("T", [700, 5000])
def test_xlator_rotor_and_phase_like_jax(T):
    offs = np.array([-987_654.3, 12_345.6, 1.1e6])
    jp, pp = jxl.nco_params(offs, 2.4e6), xlator.nco_params(offs, 2.4e6)
    for k in jp:
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jp[k]))
    ph = np.array([0.3, -2.0, 6.0], np.float32)
    want = np.asarray(jxl.rotor(ph, jp["omega"], jp["omega_span"], T))
    got = xlator.rotor(torch.from_numpy(ph), pp["omega"], pp["omega_span"],
                       T).numpy()
    assert snr_db(want, got) > 110.0
    np.testing.assert_array_equal(
        xlator.advance_phase(torch.from_numpy(ph), pp["omega"],
                             pp["omega_span"], T).numpy(),
        np.asarray(jxl.advance_phase(ph, jp["omega"], jp["omega_span"], T)))


def test_rx_vfo_like_jax():
    rng = np.random.default_rng(4)
    offs = np.array([-300e3, 250e3])
    jv = JaxRxVFO(2.4e6, 500e3, 150e3)
    pv = RxVFO(2.4e6, 500e3, 150e3)
    jp, pp = jv.make_params(offs), pv.make_params(offs)
    jst = jv.init_state((2,))
    pst = convert.state_from_jax(jst, device="cpu")
    for _ in range(2):
        xb = _cplx(rng, 2, 4800)
        jy, jst = jv.apply(jp, jst, jnp.asarray(xb))
        py, pst = pv.apply(pp, pst, torch.from_numpy(xb))
        assert np.asarray(jy).shape == py.shape == (2, 1000)
        assert snr_db(np.asarray(jy), py.numpy()) > 90.0


def test_quadrature_and_delay_like_jax():
    rng = np.random.default_rng(5)
    jq, pq = jdemod.Quadrature(75e3, 500e3), demod.Quadrature(75e3, 500e3)
    assert pq.inv_deviation == jq.inv_deviation
    x = _cplx(rng, 2, 300)
    x[:, 10] = 0                     # a zero sample: exact silence
    jst = jq.init_state((2,))
    jy, jst2 = jq.apply(None, jst, jnp.asarray(x))
    py, pst2 = pq.apply(None, convert.state_from_jax(jst, device="cpu"),
                        torch.from_numpy(x))
    assert snr_db(np.asarray(jy), py.numpy()) > 120.0
    assert py[0, 10] == 0 and py[0, 11] == 0
    jy2, _ = jq.apply_planes(jst, jnp.asarray(x.real), jnp.asarray(x.imag))
    py2, _ = pq.apply_planes(convert.state_from_jax(jst, device="cpu"),
                             torch.from_numpy(x.real.copy()),
                             torch.from_numpy(x.imag.copy()))
    assert snr_db(np.asarray(jy2), py2.numpy()) > 120.0
    np.testing.assert_array_equal(pst2.numpy(), np.asarray(jst2))
    jd, pd = jdelay.Delay(80), delay.Delay(80)
    xr = rng.standard_normal((2, 100)).astype(np.float32)
    jy, jds = jd.apply(None, jd.init_state((2,)), jnp.asarray(xr))
    py, pds = pd.apply(None, pd.init_state((2,)), torch.from_numpy(xr))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(pds.numpy(), np.asarray(jds))
