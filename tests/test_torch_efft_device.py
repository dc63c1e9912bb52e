"""The EFFT on the port against the JAX package on the CPU: the host
compressor (``ops/efft.py``, a numpy copy: frame for frame equal), the
device compressor (``ops/efft_device.py``) against the JAX block
(``ops/efft_jax.py``) under ``jax.jit``, ``efft_decompress`` and the
device feed (``io/feed.py``) in its three modes.

The device compressor at FS = 40 kHz (1 024-point frames), 24 frames a
call, two calls with the state carried: each frame's nonzero pattern and
``readys`` equal, the emitted frames >= 60 dB (the JAX package's own bar,
tests/test_efft_device.py), ``count`` equal, the rings >= 80 dB, and a
JAX state converted into the port continues the same way.  Its allowance
EMA is held to the float64 host compressor within 1e-5 relative and to
the JAX block within 5e-5: the JAX block takes its moving averages from
float32 running sums, which put its allowance 5e-6 to 2.6e-5 (relative)
from the host compressor's on these inputs, while the port sums in
float64 (``efft_device``'s docstring says why).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sdrplusplusbrown_tpu.io.feed import DeviceFeed as JaxFeed
from sdrplusplusbrown_tpu.ops import efft as jefft
from sdrplusplusbrown_tpu.ops.efft_jax import (EFFTCompressorJax,
                                               centered_sma_j,
                                               efft_decompress_j,
                                               interpolate_holes_j,
                                               moving_variance_j)
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.io.feed import DeviceFeed
from sdrplusplusbrown_tpu_torch.ops import efft as pefft
from sdrplusplusbrown_tpu_torch.ops import efft_device

from torch_parity import port_f32_handoff, snr_db  # noqa: F401

FS = 40_000.0
N = 1024                 # the EFFT frame at FS (50 ms → 2 000 → 1 024)
FRAMES = 24              # a call
CALLS = 2


def band_signal(T: int, seed: int) -> np.ndarray:
    """Light noise and two carriers (the JAX package's EFFT test signal,
    at FS)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / FS
    return (0.001 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
            + 0.05 * np.exp(2j * np.pi * 3_000 * t)
            + 0.02 * np.exp(2j * np.pi * -7_000 * t)).astype(np.complex64)


# ---------------------------------------------------------------------
# the host compressor: a numpy copy

@pytest.mark.parametrize("variant", ["plain", "masked", "tx_mode",
                                     "no_loss"])
def test_host_efft_frames_equal(variant):
    x = band_signal(30 * N + 333, 1)
    comps = []
    for mod in (jefft, pefft):
        c = mod.EFFTCompressor(FS, loss_rate=0.0 if variant == "no_loss"
                               else 4.0)
        if variant == "masked":
            c.set_masked_frequencies([-8_000, -6_000, 2_500, 3_500])
        c.tx_mode = variant == "tx_mode"
        comps.append(c)
    for i in range(0, len(x), 5_000):           # blocks across frames
        fj = comps[0].process(x[i:i + 5_000])
        fp = comps[1].process(x[i:i + 5_000])
        assert len(fj) == len(fp)
        for a, b in zip(fj, fp):
            np.testing.assert_array_equal(b, a)
    assert comps[1].noise_figure == comps[0].noise_figure
    assert comps[1].prev_allowance == comps[0].prev_allowance
    dj = jefft.EFFTDecompressor(N).process(fj)
    np.testing.assert_array_equal(pefft.EFFTDecompressor(N).process(fp), dj)


# ---------------------------------------------------------------------
# the device compressor's helpers

@pytest.mark.parametrize("w", [1, 2, 5, 16, 70, 350])
def test_sma_and_variance_match_jax(w):
    """On zero-mean rows (the JAX package's own test input) the JAX
    block's float32 running sums are a reference to 1e-5; on dB-like rows
    (~−100) they are not (up to 0.011 at w = 1), so there the port is held
    to the float64 definition (``np.convolve``) to its float32 output."""
    rng = np.random.default_rng(w)
    a = rng.standard_normal((3, N)).astype(np.float32)
    got = efft_device.centered_sma(torch.from_numpy(a), w).numpy()
    np.testing.assert_allclose(
        got, np.asarray(centered_sma_j(jnp.asarray(a), w)), rtol=0,
        atol=1e-5)
    # the variance's second running sum rounds by up to 2.7e-5 there
    mv = efft_device.moving_variance(torch.from_numpy(a), w).numpy()
    np.testing.assert_allclose(
        mv, np.asarray(moving_variance_j(jnp.asarray(a), w)), rtol=0,
        atol=1e-4)
    np.testing.assert_allclose(mv, np.stack([jefft.moving_variance(
        r.astype(np.float64), w) for r in a]), rtol=1e-5, atol=1e-7)
    db = (a * 10 - 100).astype(np.float32)
    got = efft_device.centered_sma(torch.from_numpy(db), w).numpy()
    ref = np.stack([jefft.centered_sma(r.astype(np.float64), w)
                    for r in db])
    np.testing.assert_allclose(got, ref, rtol=2e-7, atol=0)


def test_interpolate_holes_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((4, N)).astype(np.float32)
    a[rng.random((4, N)) < 0.5] = 0.0
    a[1, :] = 0.0                                  # no support at all
    a[2, :] = 0.0
    a[2, 500] = 3.0                                # one point
    a[3, :7] = 0.0                                 # edge holes
    a[3, -9:] = 0.0
    got = efft_device.interpolate_holes(torch.from_numpy(a)).numpy()
    want = np.stack([np.asarray(interpolate_holes_j(jnp.asarray(r)))
                     for r in a])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(efft_device.interpolate_holes(
        torch.tensor([0, 2.0, 0, 0, 8.0, 0])).numpy(), [2, 2, 4, 6, 8, 8])


# ---------------------------------------------------------------------
# the device compressor against the JAX block under jax.jit

@pytest.fixture(scope="module")
def efft_runs():
    """Both blocks on CALLS calls of FRAMES frames with the state carried,
    the port also from the JAX state after call 1 (converted), and the
    host compressor on the same samples."""
    x = band_signal(CALLS * FRAMES * N, 7)
    cj = EFFTCompressorJax(FS)
    cp = efft_device.EFFTCompressorDevice(FS, device="cpu")
    host = jefft.EFFTCompressor(FS)
    assert cj.fft_size == cp.fft_size == N
    step = jax.jit(lambda s, xx: cj.apply(None, s, xx))
    sj, sp = cj.init_state(()), cp.init_state(())
    out = {"jax": [], "port": [], "host_allowance": []}
    for c in range(CALLS):
        xx = x[c * FRAMES * N:(c + 1) * FRAMES * N]
        (ej, rj), sj = step(sj, jnp.asarray(xx))
        (ep, rp), sp = cp.apply(None, sp, torch.from_numpy(xx))
        out["jax"].append((np.asarray(ej), np.asarray(rj),
                           jax.tree_util.tree_map(np.asarray, sj)))
        out["port"].append((ep.numpy(), rp.numpy(),
                            convert.state_to_jax(sp)))
        host.process(xx)
        out["host_allowance"].append(host.prev_allowance)
        if c == 0:
            s0 = convert.state_from_jax(out["jax"][0][2], device="cpu")
            (ec, rc), sc = cp.apply(None, s0, torch.from_numpy(
                x[FRAMES * N:2 * FRAMES * N]))
            out["converted"] = (ec.numpy(), rc.numpy(),
                                convert.state_to_jax(sc))
    return out


@pytest.mark.parametrize("call", range(CALLS))
def test_device_efft_matches_jax(efft_runs, call):
    ej, rj, sj = efft_runs["jax"][call]
    ep, rp, sp = efft_runs["port"][call]
    assert ep.shape == ej.shape == (FRAMES, N) and ep.dtype == np.complex64
    np.testing.assert_array_equal(rp, rj)
    assert rj.sum() == (FRAMES - 9 if call == 0 else FRAMES)
    for f in range(FRAMES):
        np.testing.assert_array_equal(ep[f] != 0, ej[f] != 0, err_msg=f)
    assert np.mean(ep[rp] == 0) > 0.05             # the mask zeroes bins
    assert snr_db(ej, ep) >= 60.0, snr_db(ej, ep)
    assert sorted(sp) == sorted(sj)
    for k in sj:
        assert sp[k].shape == sj[k].shape and sp[k].dtype == sj[k].dtype, k
    assert sp["count"] == sj["count"] == (call + 1) * FRAMES
    a_host = efft_runs["host_allowance"][call]
    assert abs(sp["prev_allowance"] - a_host) <= 1e-5 * a_host
    assert abs(sp["prev_allowance"] - sj["prev_allowance"]) \
        <= 5e-5 * sj["prev_allowance"]
    for k in ("clean_freq", "clean_mag", "win_mag"):
        assert snr_db(sj[k], sp[k]) >= 80.0, (k, snr_db(sj[k], sp[k]))


def test_converted_jax_state_continues(efft_runs):
    ej, rj, sj = efft_runs["jax"][1]
    ec, rc, sc = efft_runs["converted"]
    np.testing.assert_array_equal(rc, rj)
    for f in range(FRAMES):
        np.testing.assert_array_equal(ec[f] != 0, ej[f] != 0, err_msg=f)
    assert snr_db(ej, ec) >= 60.0
    assert sc["count"] == sj["count"]
    for k in ("clean_freq", "clean_mag", "win_mag"):
        assert snr_db(sj[k], sc[k]) >= 80.0, k


def test_efft_decompress_matches_jax(efft_runs):
    ej, rj, _ = efft_runs["jax"][1]
    want = np.asarray(efft_decompress_j(jnp.asarray(ej)))
    got = efft_device.efft_decompress(torch.from_numpy(ej.copy()))
    assert got.dtype == torch.complex64 and got.shape == (FRAMES * N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------
# the device feed

@pytest.mark.parametrize("mode", ["none", "int8", "efft"])
def test_device_feed_matches_jax(mode):
    x = band_signal(16 * N, 11)
    jf, pf = JaxFeed(mode, samplerate=FS), DeviceFeed(mode, samplerate=FS,
                                                      device="cpu")
    outs = []
    for i in range(0, len(x), 4 * N):
        a, b = jf.push(x[i:i + 4 * N]), pf.push(x[i:i + 4 * N])
        assert (a is None) == (b is None)
        if a is not None:
            assert b.dtype == torch.complex64 and b.device.type == "cpu"
            outs.append((np.asarray(a), b.numpy()))
    assert len(outs) == (2 if mode == "efft" else 4)
    assert pf.stats() == jf.stats()
    for a, b in outs:
        if mode == "efft":
            assert snr_db(a, b) >= 60.0, snr_db(a, b)
        else:
            np.testing.assert_array_equal(b, a)


def test_entry_points_need_a_device(monkeypatch):
    """Without a card, a default device feed or compressor raises rather
    than running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceFeed("int8")
    with pytest.raises(RuntimeError, match="CUDA"):
        efft_device.EFFTCompressorDevice(FS)
