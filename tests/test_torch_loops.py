"""Kernel K13's plain versions (the scan PLL, the Costas loop, the M&M
clock recovery) and K12's complex form against the JAX package's
``lax.scan`` blocks on the CPU (under ``jax.jit``:
torch_parity.jit_methods), with the same seeded inputs over three
carried blocks, at batch () and (3,) where the JAX block takes a batch
(its M&M runs one stream):

  * outputs >= 80 dB (each block), float state >= 80 dB, integer state
    equal;
  * PLL and Costas phases equal modulo 2π (within 1e-5 rad): a phase on
    either side of the ±π wrap is the same phase;
  * M&M: ``valid`` and ``offset`` equal, and every symbol within 1e-5 of
    the JAX package's: a one-step change of a symbol's polyphase index
    (1/128 of a sample) moves it by far more, so the indices are equal;
    the next symbol's index, int(phase·128), equal after every block;
    the fractional sample position itself within 1e-5 of a sample
    (torch_parity.assert_mm_state says why not in dB).

The two packages round differently by ulps (XLA:CPU's atan2, cos/sin and
its fused multiply-adds against torch's separately rounded operations),
which a locked loop keeps at rounding level.  Also ``AMDemod`` with the
carrier AGC (K12's complex form on the IF), audio and state >= 80 dB."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.ops import agc as jax_agc
from sdrplusplusbrown_tpu.ops import clock_recovery as jax_mm
from sdrplusplusbrown_tpu.ops import costas as jax_costas
from sdrplusplusbrown_tpu.ops import demod as jax_demod
from sdrplusplusbrown_tpu.ops import pll as jax_pll
from sdrplusplusbrown_tpu_torch.ops import (agc, clock_recovery, costas,
                                            demod, pll)

from torch_parity import (assert_mm_state, assert_state_close, jit_methods,
                          snr_db)

MIN_DB = 80.0
T = 1000
BLOCKS = 3


def _phase_equal(a, b, tol: float = 1e-5):
    d = np.angle(np.exp(1j * (np.asarray(a, np.float64)
                              - np.asarray(b, np.float64))))
    assert np.abs(d).max() <= tol, d


def _batched(fn, batch, seed):
    """``fn(rng, n)`` for each row of ``batch``, stacked: [*batch, n]."""
    rng = np.random.default_rng(seed)
    n = BLOCKS * T
    if batch == ():
        return fn(rng, n)
    return np.stack([fn(rng, n) for _ in range(int(np.prod(batch)))]) \
        .reshape(batch + (n,))


def _tone(rng, n):
    """A carrier 0.2 % off the loop's centre with a slow phase wobble in
    noise (SNR ~17 dB)."""
    k = np.arange(n)
    ph = 0.31 * k + 0.4 * np.sin(2 * np.pi * k / 700.0) + rng.uniform(0, 6)
    return (np.exp(1j * ph) + 0.1 * (rng.standard_normal(n)
                                     + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_pll_scan_matches_jax(batch):
    """The WFM pilot PLL's configuration (bandwidth 25 kHz / fs, limits
    ±1.3 % of the centre) on a noisy carrier; vco and ``phase``/``freq``."""
    w0 = 0.3
    kw = dict(init_freq=w0, min_freq=w0 * 0.987, max_freq=w0 * 1.013)
    jb, pb = jit_methods(jax_pll.PLL(0.2, **kw)), pll.PLL(0.2, **kw)
    x = _batched(_tone, batch, 1)
    js, ps = jb.init_state(batch), pb.init_state(batch)
    for b in range(BLOCKS):
        xb = x[..., b * T:(b + 1) * T]
        jy, js = jb.apply(None, js, jnp.asarray(xb))
        py, ps = pb.apply(None, ps, torch.from_numpy(xb))
        assert py.shape == xb.shape and py.dtype == torch.complex64
        assert snr_db(np.asarray(jy), py.numpy()) >= MIN_DB, b
        _phase_equal(js["phase"], ps["phase"].numpy())
        assert snr_db(np.asarray(js["freq"]), ps["freq"].numpy()) >= MIN_DB


def test_carrier_tracking_pll_matches_jax():
    jb = jit_methods(jax_pll.CarrierTrackingPLL(0.05, init_freq=0.3))
    pb = pll.CarrierTrackingPLL(0.05, init_freq=0.3)
    x = _batched(_tone, (2,), 2)
    js, ps = jb.init_state((2,)), pb.init_state((2,))
    for b in range(BLOCKS):
        xb = x[..., b * T:(b + 1) * T]
        jy, js = jb.apply(None, js, jnp.asarray(xb))
        py, ps = pb.apply(None, ps, torch.from_numpy(xb))
        assert snr_db(np.asarray(jy), py.numpy()) >= MIN_DB, b
        _phase_equal(js["phase"], ps["phase"].numpy())


def _psk(order):
    """PSK of ``order`` at 8 samples a symbol, 0.01 rad a sample off, in
    noise."""
    def fn(rng, n):
        sym = rng.integers(0, order, n // 8 + 1)
        k = np.arange(n)
        x = np.repeat(np.exp(2j * np.pi * sym / order), 8)[:n] \
            * np.exp(1j * (0.01 * k + rng.uniform(0, 6)))
        return (x + 0.05 * (rng.standard_normal(n)
                            + 1j * rng.standard_normal(n))
                ).astype(np.complex64)
    return fn


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("order", [2, 4, 8])
def test_costas_matches_jax(order, batch):
    jb = jit_methods(jax_costas.Costas(order, 0.02))
    pb = costas.Costas(order, 0.02)
    x = _batched(_psk(order), batch, 10 + order)
    js, ps = jb.init_state(batch), pb.init_state(batch)
    for b in range(BLOCKS):
        xb = x[..., b * T:(b + 1) * T]
        jy, js = jb.apply(None, js, jnp.asarray(xb))
        py, ps = pb.apply(None, ps, torch.from_numpy(xb))
        assert snr_db(np.asarray(jy), py.numpy()) >= MIN_DB, b
        _phase_equal(js["phase"], ps["phase"].numpy())
        assert snr_db(np.asarray(js["freq"]), ps["freq"].numpy()) >= MIN_DB


def test_costas_error_fn_runs_on_the_host():
    """A custom detector runs in the plain loop (the Meteor variant's
    form), and is the order-2 detector's result when it computes that."""
    fn = costas.Costas(2, 0.02, error_fn=lambda v: v.real * v.imag)
    ref = costas.Costas(2, 0.02)
    x = torch.from_numpy(_batched(_psk(2), (2,), 3)[..., :T])
    y1, s1 = fn.apply(None, fn.init_state((2,)), x)
    y2, s2 = ref.apply(None, ref.init_state((2,)), x)
    assert torch.equal(y1, y2) and torch.equal(s1["phase"], s2["phase"])


def _bpsk_stream(cplx):
    """±1 symbols at 4.21 samples a symbol (the RDS clock's ω), band
    limited by a 5-tap average, in noise; complex: a second stream in
    quadrature."""
    def fn(rng, n):
        t = np.arange(n) / 4.21 + rng.uniform(0, 1)
        s = np.sign(rng.standard_normal(int(t[-1]) + 2))[t.astype(int)]
        s = np.convolve(s, np.ones(5) / 5.0, "same")
        s = s + 0.05 * rng.standard_normal(n)
        if cplx:
            q = np.sign(rng.standard_normal(int(t[-1]) + 2))[t.astype(int)]
            s = s + 1j * np.convolve(q, np.ones(5) / 5.0, "same")
            return s.astype(np.complex64)
        return s.astype(np.float32)
    return fn


@pytest.mark.parametrize("cplx", [False, True])
def test_mm_clock_recovery_matches_jax(cplx):
    jb = jit_methods(jax_mm.MMClockRecovery(4.21, complex_data=cplx))
    pb = clock_recovery.MMClockRecovery(4.21, complex_data=cplx)
    np.testing.assert_array_equal(pb.bank, jb.bank)
    x = _batched(_bpsk_stream(cplx), (), 20 + cplx)
    js, ps = jb.init_state(()), pb.init_state(())
    for b in range(BLOCKS):
        xb = x[b * T:(b + 1) * T]
        (jo, jv), js = jb.apply(None, js, jnp.asarray(xb))
        (po, pv), ps = pb.apply(None, ps, torch.from_numpy(xb))
        jo, jv = np.asarray(jo), np.asarray(jv)
        assert po.shape == jo.shape == (pb.max_out(T),)
        np.testing.assert_array_equal(pv.numpy(), jv)
        assert jv.sum() > 200 and not jv[-1]       # the mask cut the tail
        assert snr_db(jo[jv], po.numpy()[jv]) >= MIN_DB, b
        assert np.abs(po.numpy() - jo).max() <= 1e-5, b
        assert int(ps["offset"]) == int(js["offset"])
        assert int(float(ps["phase"]) * 128) == int(float(js["phase"]) * 128)
        assert_mm_state(js, ps)


def test_mm_rows_batch_is_per_row():
    """The port's rows (the JAX block takes one stream): each row of a
    [3, T] block is that stream alone."""
    pb = clock_recovery.MMClockRecovery(4.21, complex_data=False)
    x = torch.from_numpy(_batched(_bpsk_stream(False), (3,), 5)[..., :T])
    (po, pv), ps = pb.apply(None, pb.init_state((3,)), x)
    for r in range(3):
        (o1, v1), s1 = pb.apply(None, pb.init_state(()), x[r])
        assert torch.equal(po[r], o1) and torch.equal(pv[r], v1)
        assert torch.equal(ps["phase"][r], s1["phase"])
        assert torch.equal(ps["tail"][r], s1["tail"])


def _am_cplx(rng, n):
    """An AM carrier (1 kHz tone, 50 %) with a rising level, a gap of
    zeros and noise."""
    k = np.arange(n)
    x = 0.3 * (1 + 0.5 * np.sin(2 * np.pi * 1e3 * k / 15e3)) \
        * np.exp(2j * np.pi * 300.0 * k / 15e3) * np.linspace(0.05, 2.0, n)
    x = x + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x[300:360] = 0.0
    return x.astype(np.complex64)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_complex_agc_matches_jax(batch):
    """K12's complex form: |x| drives the envelope, the gain and ramp
    scale both planes; block 1 frozen; ``env`` exact."""
    kw = dict(attack=50 / 15e3, decay=5 / 15e3)
    ja, pa = jit_methods(jax_agc.AGC(**kw)), agc.AGC(**kw)
    x = _batched(_am_cplx, batch, 30)
    js, ps = ja.init_state(batch), pa.init_state(batch)
    for b in range(BLOCKS):
        xb = x[..., b * T:(b + 1) * T]
        frozen = b == 1
        jy, js = ja.apply({"frozen": jnp.asarray(frozen)}, js,
                          jnp.asarray(xb))
        py, ps = pa.apply({"frozen": torch.tensor(frozen)}, ps,
                          torch.from_numpy(xb))
        assert py.dtype == torch.complex64 and py.shape == xb.shape
        assert snr_db(np.asarray(jy), py.numpy()) >= MIN_DB, b
        assert_state_close(js, ps, MIN_DB)


def test_am_carrier_agc_matches_jax():
    """``AMDemod(carrier_agc=True)``: the AGC on the complex IF, the
    envelope, the DC blocker, no audio AGC, the low-pass; batch (3,)."""
    jd = jit_methods(jax_demod.AMDemod(15e3, carrier_agc=True))
    pd = demod.AMDemod(15e3, carrier_agc=True)
    x = _batched(_am_cplx, (3,), 31)
    js, ps = jd.init_state((3,)), pd.init_state((3,))
    for b in range(BLOCKS):
        xb = x[..., b * T:(b + 1) * T]
        jy, js = jd.apply(None, js, jnp.asarray(xb))
        py, ps = pd.apply(None, ps, torch.from_numpy(xb))
        assert snr_db(np.asarray(jy), py.numpy()) >= MIN_DB, b
        assert_state_close(js, ps, MIN_DB)
    # the audio AGC's state never moved
    np.testing.assert_array_equal(ps["aagc"]["env"].numpy(), [0, 0, 0])
