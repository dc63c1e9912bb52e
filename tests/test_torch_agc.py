"""The multi-mode bank's demod blocks against the JAX package's, op by op
without jit, on the same input over three blocks (float32):

  * ``linear_recurrence`` and ``DCBlocker``: bit-identical (the port pairs
    the elements as ``jax.lax.associative_scan`` does);
  * ``AGC`` (K12's plain version; ``frozen``, zero samples, the start
    ramp's end inside a block): output and ``amp`` >= 100 dB, ``env``
    exact.  XLA:CPU compiles the scan's attack/decay update to a fused
    multiply-add; the port rounds each operation, so ``amp`` differs by an
    ulp at some steps;
  * ``AMDemod``, ``SSBDemod`` (USB, LSB, DSB) and ``CWDemod``: audio and
    every state leaf >= 100 dB."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.ops import agc as jax_agc
from sdrplusplusbrown_tpu.ops import demod as jax_demod
from sdrplusplusbrown_tpu.ops import recurrence as jax_rec
from sdrplusplusbrown_tpu_torch.ops import agc, demod, recurrence

from torch_parity import assert_state_close, snr_db

MIN_DB = 100.0


@pytest.mark.parametrize("T", [1, 2, 7, 64, 1500, 2401])
def test_linear_recurrence_bit_identical(T):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 1.0, (3, T)).astype(np.float32)
    b = rng.standard_normal((3, T)).astype(np.float32)
    y0 = rng.standard_normal(3).astype(np.float32)
    for aa in (a, np.float32(0.99)):
        want = np.asarray(jax_rec.linear_recurrence(
            jnp.asarray(aa), jnp.asarray(b), jnp.asarray(y0)))
        got = recurrence.linear_recurrence(
            torch.from_numpy(aa) if np.ndim(aa) else float(aa),
            torch.from_numpy(b), torch.from_numpy(y0))
        np.testing.assert_array_equal(got.numpy(), want)


def test_dc_blocker_bit_identical():
    jb, pb = jax_rec.DCBlocker(100 / 15e3), recurrence.DCBlocker(100 / 15e3)
    js = jb.init_state((4,), jnp.float32)
    ps = pb.init_state((4,), torch.float32)
    rng = np.random.default_rng(1)
    for b in range(3):
        x = (rng.standard_normal((4, 1500)) + 0.5).astype(np.float32)
        jy, js = jb.apply(None, js, jnp.asarray(x))
        py, ps = pb.apply(None, ps, torch.from_numpy(x))
        np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("batch", [(), (4,)])
def test_agc_matches_jax(batch):
    """Three 2 000-sample blocks: the ramp ends inside block 0 for one
    row, zeros hold the envelope, block 1 is frozen."""
    ja = jax_agc.AGC(attack=50 / 24e3, decay=5 / 24e3)
    pa = agc.AGC(attack=50 / 24e3, decay=5 / 24e3)
    rng = np.random.default_rng(2)
    shape = batch + (2000,)
    js, ps = ja.init_state(batch), pa.init_state(batch)
    env0 = np.full(batch, 3800, np.int32)
    if batch:
        env0[1:] = [0, 5000, 1 << 30]
    js = {"amp": js["amp"], "env": jnp.asarray(env0)}
    ps = {"amp": ps["amp"], "env": torch.from_numpy(env0.copy())}
    for b in range(3):
        x = (rng.standard_normal(shape)
             * np.linspace(0.01, 3.0, 2000)).astype(np.float32)
        x[..., 100:160] = 0.0
        frozen = b == 1
        jy, js = ja.apply({"frozen": jnp.asarray(frozen)}, js, jnp.asarray(x))
        py, ps = pa.apply({"frozen": torch.tensor(frozen)}, ps,
                          torch.from_numpy(x))
        assert py.shape == shape
        assert snr_db(np.asarray(jy), py.numpy()) >= MIN_DB, b
        assert_state_close(js, ps, MIN_DB)
        np.testing.assert_array_equal(ps["env"].numpy(), np.asarray(js["env"]))


def test_agc_unported_forms_raise():
    """The AGC's other forms run: a complex block (K12's complex form:
    the envelope of |x|, the gain on both planes) and the AM carrier
    AGC; ``fast_agc`` is one rate."""
    a = agc.AGC()
    x = torch.ones(2, 8, dtype=torch.complex64) * (0.6 + 0.8j)
    y, st = a.apply(None, a.init_state((2,)), x)
    assert y.dtype == torch.complex64 and y.shape == (2, 8)
    # |x| = 1 = the set point: gain 1, the ramp alone scales both planes
    ramp = torch.arange(8, dtype=torch.float32) / 4800.0
    torch.testing.assert_close(y, x * ramp, rtol=0, atol=0)
    assert st["env"].tolist() == [8, 8]
    am = demod.AMDemod(15e3, carrier_agc=True)
    assert am.carrier_agc
    fa = agc.fast_agc()
    assert fa.attack == fa.decay == 0.1


def _am_if(T, seed):
    """[4, 3T] complex IF: a 50 % AM carrier (1 kHz tone) at 300 Hz with
    a per-row level, plus a little noise."""
    rng = np.random.default_rng(seed)
    n = np.arange(3 * T)
    x = (0.3 * (1 + 0.5 * np.sin(2 * np.pi * 1e3 * n / 15e3))
         * np.exp(2j * np.pi * 300 * n / 15e3))[None] \
        * np.linspace(0.5, 2, 4)[:, None]
    x = x + 1e-3 * (rng.standard_normal((4, 3 * T))
                    + 1j * rng.standard_normal((4, 3 * T)))
    return x.astype(np.complex64)


@pytest.mark.parametrize("name", ["am", "usb", "lsb", "dsb", "cw"])
def test_demod_matches_jax(name):
    blocks = {
        "am": (jax_demod.AMDemod(15e3, 10e3), demod.AMDemod(15e3, 10e3)),
        "usb": (jax_demod.SSBDemod("usb", 2800, 24e3),
                demod.SSBDemod("usb", 2800, 24e3)),
        "lsb": (jax_demod.SSBDemod("lsb", 2800, 24e3),
                demod.SSBDemod("lsb", 2800, 24e3)),
        "dsb": (jax_demod.SSBDemod("dsb", 4600, 24e3),
                demod.SSBDemod("dsb", 4600, 24e3)),
        "cw": (jax_demod.CWDemod(800, 3e3), demod.CWDemod(800, 3e3)),
    }
    jd, pd = blocks[name]
    T = 1500
    x = _am_if(T, seed=len(name))
    js, ps = jd.init_state((4,)), pd.init_state((4,))
    for b in range(3):
        xb = x[:, b * T:(b + 1) * T]
        jy, js = jd.apply(None, js, jnp.asarray(xb))
        py, ps = pd.apply(None, ps, torch.from_numpy(xb))
        assert py.shape == (4, T) and py.dtype == torch.float32
        assert snr_db(np.asarray(jy), py.numpy()) >= MIN_DB, b
        assert_state_close(js, ps, MIN_DB)
