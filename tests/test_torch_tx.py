"""The port's transmit path against the JAX package on the CPU: every
modulator (``ops/mod.py``), ``TxChain`` in its four modes, ``Prebuffer``,
``ServerTxPath`` and the DSP-state checkpoint (``runtime/checkpoint.py``),
from the same numpy-seeded inputs over three carried blocks.

Tolerances: SSB, AM, PSK/RRC and the resampler at >= 70 dB on every
output and state leaf (their plain versions sum in the JAX package's
order, so most agree exactly); the FM phase carried between blocks
within 1e-4 rad of the JAX package's (a float32 ``cumsum`` is summed in
another order by each package: the phase is held in radians, not in
bits) and the phasors within 1e-4 of each other.  The JAX blocks with an
AGC run under ``jax.jit`` (one compile for the test's blocks)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdrplusplusbrown_tpu.ops import mod as jmod
from sdrplusplusbrown_tpu.models import trx as jtrx
from sdrplusplusbrown_tpu.runtime import checkpoint as jckpt
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.ops import mod as pmod
from sdrplusplusbrown_tpu_torch.models import trx as ptrx
from sdrplusplusbrown_tpu_torch.runtime import checkpoint as pckpt
from torch_parity import assert_close, assert_state_close, jit_methods

FS = 48_000.0
BLOCKS = 3
MIN_DB = 70.0
PHASE_TOL = 1e-4          # rad, the FM phase carried between blocks


def _audio(T, seed, blocks=BLOCKS):
    """Speech-band audio: two tones and a little noise, 0.5 peak."""
    rng = np.random.default_rng(seed)
    t = np.arange(T * blocks) / FS
    x = (0.3 * np.sin(2 * np.pi * 700 * t) + 0.15 * np.sin(
        2 * np.pi * 1900 * t) + 0.05 * rng.standard_normal(t.size))
    return x.astype(np.float32).reshape(blocks, T)


def _run(jblk, pblk, blocks, jstate=None):
    """Both packages over ``blocks`` from one initial state (the JAX
    one's, converted): [(jax y, jax state, port y, port state)]."""
    js = jblk.init_state(()) if jstate is None else jstate
    ps = convert.state_from_jax(js, device="cpu")
    out = []
    for x in blocks:
        jy, js = jblk.apply(None, js, jnp.asarray(x))
        py, ps = pblk.apply(None, ps, torch.from_numpy(np.array(x)))
        out.append((np.asarray(jy), js, py.numpy(), ps))
    return out


def _phase_err(a, b) -> float:
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.max(np.abs(np.angle(np.exp(1j * d)))))


def test_quadrature_mod_phase():
    x = _audio(4800, 1)
    for jy, js, py, ps in _run(jmod.QuadratureMod(5000.0, FS),
                               pmod.QuadratureMod(5000.0, FS), x):
        assert ps.dtype == torch.float32 and ps.shape == ()
        assert _phase_err(js, ps.numpy()) <= PHASE_TOL
        assert np.max(np.abs(jy - py)) <= PHASE_TOL


@pytest.mark.parametrize("phase", [-3.1, 0.0, 3.14159])
def test_wrap_phase_matches_jnp_mod(phase):
    """The wrap at the block's edges, bit for bit: a ramp across ±π."""
    p = (phase + np.linspace(-20, 20, 4001)).astype(np.float32)
    want = np.asarray(jnp.mod(jnp.asarray(p) + np.pi, 2 * np.pi) - np.pi)
    np.testing.assert_array_equal(pmod.wrap_phase(torch.from_numpy(p)),
                                  want)


def test_am_mod():
    x = _audio(960, 2)
    for jy, js, py, ps in _run(jmod.AMMod(0.8), pmod.AMMod(0.8), x):
        assert js is None and ps is None
        np.testing.assert_array_equal(py, jy)


@pytest.mark.parametrize("mode", [jmod.SSBMod.USB, jmod.SSBMod.LSB])
def test_ssb_mod(mode):
    x = _audio(4800, 3)
    jb, pb = jmod.SSBMod(mode, 2800.0, FS), pmod.SSBMod(mode, 2800.0, FS)
    assert pb.fir.K == 651 and pb.fir._complex_taps
    for jy, js, py, ps in _run(jb, pb, x):
        assert_close(jy, py, "ssb", MIN_DB)
        assert_state_close(js, ps, MIN_DB)


@pytest.mark.parametrize("order", [2, 4])
def test_psk_rrc(order):
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (BLOCKS, 240)).astype(np.int32)
    jpsk, ppsk = jmod.PSKMod(order), pmod.PSKMod(order)
    syms = []
    for b in bits:
        js_, _ = jpsk.apply(None, None, jnp.asarray(b))
        ps_, _ = ppsk.apply(None, None, torch.from_numpy(b))
        assert_close(js_, ps_, "psk", MIN_DB)
        syms.append(np.asarray(js_))
    jr, pr = jmod.RRCInterpolator(2400.0, FS), pmod.RRCInterpolator(2400.0,
                                                                   FS)
    assert pr.in_multiple == jr.in_multiple and pr.ratio == jr.ratio
    for jy, js, py, ps in _run(jr, pr, syms):
        assert_close(jy, py, "rrc", MIN_DB)
        assert_state_close(js, ps, MIN_DB)


def test_gfsk_mod():
    rng = np.random.default_rng(5)
    nrz = (1.0 - 2.0 * rng.integers(0, 2, (BLOCKS, 40)).repeat(40, -1)
           ).astype(np.float32)
    for jy, js, py, ps in _run(jmod.GFSKMod(FS, 1200.0, 1200.0),
                               pmod.GFSKMod(FS, 1200.0, 1200.0), nrz):
        assert_close(js["g"], ps["g"], "gauss tail", MIN_DB)
        assert _phase_err(js["fm"], ps["fm"].numpy()) <= PHASE_TOL
        assert np.max(np.abs(jy - py)) <= PHASE_TOL


@pytest.mark.parametrize("mode", ["FM", "USB", "LSB", "AM"])
def test_tx_chain(mode):
    """The AGC (K12's plain version), then the modulator."""
    x = _audio(2400, 6)
    jc = jit_methods(jtrx.TxChain(mode))
    for jy, js, py, ps in _run(jc, ptrx.TxChain(mode), x):
        assert_close(js["agc"]["amp"], ps["agc"]["amp"], "amp", MIN_DB)
        np.testing.assert_array_equal(np.asarray(js["agc"]["env"]),
                                      ps["agc"]["env"].numpy())
        if mode == "FM":
            assert _phase_err(js["mod"], ps["mod"].numpy()) <= PHASE_TOL
            assert np.max(np.abs(jy - py)) <= PHASE_TOL
        else:
            assert_close(jy, py, mode, MIN_DB)
            assert_state_close(js["mod"], ps["mod"], MIN_DB)


def test_prebuffer_sequence():
    """One script of pushes and pulls (priming, steady pulls, an underrun
    and the re-prime) through both prebuffers: the same answers."""
    rng = np.random.default_rng(7)
    pbs = (jtrx.Prebuffer(FS, 10.0), ptrx.Prebuffer(FS, 10.0))
    for step in range(40):
        x = (rng.standard_normal(int(rng.integers(0, 400)))
             ).astype(np.complex64)
        n = int(rng.integers(50, 700))
        got = []
        for pb in pbs:
            pb.push(x)
            got.append(pb.pull(n))
        if got[0] is None:
            assert got[1] is None, step
        else:
            np.testing.assert_array_equal(got[0], got[1])


def _wire(n_blocks, seed, n=1200):
    """Wire blocks at 6 kHz: a 1 kHz tone in a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n * n_blocks) / 6000.0
    x = 0.5 * np.exp(2j * np.pi * 1000.0 * t) + 0.01 * (
        rng.standard_normal(t.size) + 1j * rng.standard_normal(t.size))
    return x.astype(np.complex64).reshape(n_blocks, n)


def test_server_tx_path_packets():
    """ServerTxPath: the 48 kHz packets the transmitter receives, 960
    samples each after the prebuffer, against the JAX path's (a short
    last block padded by both)."""
    txs = (jtrx.LoopbackTransmitter(), ptrx.LoopbackTransmitter())
    jp = jtrx.ServerTxPath(txs[0], prebuffer_ms=40.0)
    pp = ptrx.ServerTxPath(txs[1], prebuffer_ms=40.0, device="cpu")
    assert pp.resamp.in_multiple == jp.resamp.in_multiple
    for blk in list(_wire(BLOCKS, 8)) + [_wire(1, 9, 700)[0]]:
        jp.push_wire_block(blk)
        pp.push_wire_block(blk)
        assert len(txs[0].blocks) == len(txs[1].blocks)
    assert len(txs[1].blocks) >= 3
    for a, b in zip(*(t.blocks for t in txs)):
        assert b.shape == (960,) and b.dtype == np.complex64
        assert_close(a, b, "tx packet", MIN_DB)
    assert_state_close(jp.rs_state, pp.rs_state, MIN_DB)


def test_server_tx_path_device_rule():
    """Entry-point rule: CUDA unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ptrx.ServerTxPath(ptrx.LoopbackTransmitter())


# ---------------------------------------------------------------------
# checkpoints

def test_jax_checkpoint_continues_in_port(tmp_path):
    """A TxChain's state saved mid-stream by the JAX package, loaded by
    the port (its own ``load_state`` on the port's fresh state, and the
    JAX ``load_state`` tree through ``convert``), then continued: the
    port's next block against the JAX package's own continuation."""
    x = _audio(2400, 10, blocks=2)
    jc = jit_methods(jtrx.TxChain("USB"))
    js = jc.init_state(())
    _, js = jc.apply(None, js, jnp.asarray(x[0]))
    ck = str(tmp_path / "tx.npz")
    jckpt.save_state(ck, js, {"mode": "USB"})
    jy, js2 = jc.apply(None, js, jnp.asarray(x[1]))

    pc = ptrx.TxChain("USB")
    ps_a, meta = pckpt.load_state(ck, pc.init_state(()))
    assert meta == {"mode": "USB"}
    jtree, _ = jckpt.load_state(ck, jtrx.TxChain("USB").init_state(()))
    ps_b = convert.state_from_jax(jtree, device="cpu")
    for ps in (ps_a, ps_b):
        assert_state_close(js, ps, 300.0)          # loaded exactly
        py, ps2 = pc.apply(None, ps, torch.from_numpy(x[1]))
        assert_close(jy, py, "continued", MIN_DB)
        assert_state_close(js2, ps2, MIN_DB)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The other way, on a nested tree (a Radio's dicts and lists): the
    port's file holds the leaves in the JAX package's order."""
    from sdrplusplusbrown_tpu.models.radio import Radio as JRadio
    from sdrplusplusbrown_tpu_torch.models.radio import Radio as PRadio
    pr = PRadio(240_000.0, 0, offset_hz=5e3, device="cpu")
    ps = pr.init_state(())
    rng = np.random.default_rng(11)
    for leaf in pckpt.flatten(ps):
        if leaf.is_floating_point() or leaf.is_complex():
            leaf.copy_(torch.from_numpy(rng.standard_normal(
                tuple(leaf.shape)).astype(leaf.numpy().dtype)))
    ck = str(tmp_path / "radio.npz")
    pckpt.save_state(ck, ps)
    jtree, meta = jckpt.load_state(ck, JRadio(240_000.0, 0,
                                              offset_hz=5e3).init_state(()))
    assert meta == {}
    assert_state_close(jtree, ps, 300.0)
    back, _ = pckpt.load_state(ck, pr.init_state(()))
    assert_state_close(convert.state_to_jax(ps), back, 300.0)


def test_checkpoint_mismatch_rejected(tmp_path):
    ck = str(tmp_path / "s.npz")
    pckpt.save_state(ck, ptrx.TxChain("USB").init_state(()))
    with pytest.raises(ValueError, match="mismatch"):
        pckpt.load_state(ck, ptrx.TxChain("FM").init_state(()))
