"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs its Pallas kernels in interpret mode, the port its plain
PyTorch versions (its CUDA kernels need the card and are checked against
those same plain versions by chip_smoke.py).
"""

import glob
import importlib.util
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.ops import precision as port_precision

FS = 2_400_000.0


@pytest.fixture(autouse=True)
def port_f32_handoff():
    """Pin the port's kernel-to-kernel handoff to float32 (the JAX side is
    pinned by tests/conftest.py)."""
    prev = port_precision.get_handoff_name()
    port_precision.set_handoff_dtype("float32")
    yield
    port_precision.set_handoff_dtype(prev)


def tone_hz(k: int) -> float:
    return 500.0 + 60.0 * k


def wfm_iq(T: int, offsets, seed: int = 0) -> np.ndarray:
    """One stereo FM broadcast per carrier offset (tone 500 + 60·k Hz in
    L only, 19 kHz pilot) plus a little noise, as tests/test_raw_handoff.py
    builds it: off-carrier channels would see a near-zero pilot."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / FS
    x = np.zeros(T, np.complex64)
    for k, off in enumerate(offsets):
        tone = np.sin(2 * np.pi * tone_hz(k) * t)
        mpx = (0.45 * tone + 0.45 * tone * -np.cos(2 * np.pi * 38_000.0 * t)
               + 0.1 * np.sin(2 * np.pi * 19_000.0 * t))
        phase = 2 * np.pi * (off * t + 75_000.0 * np.cumsum(mpx) / FS)
        x = x + (0.3 * np.exp(1j * phase)).astype(np.complex64)
    x = x + 1e-3 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    return x.astype(np.complex64)


def nfm_iq(T: int, offsets, channels, seed: int = 0, amp: float = 0.3,
           noise: float = 1e-3) -> np.ndarray:
    """An NFM carrier (tone 700 + 100·k Hz, 2 kHz peak deviation) on each
    channel k of ``channels`` at its offset, plus complex noise of
    ``noise`` per component elsewhere — the scanner input of
    tests/test_chan_frontend.py, with a tone per carrier."""
    rng = np.random.default_rng(seed)
    n = np.arange(T)
    x = noise * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    for k in channels:
        tone = 0.8 * np.sin(2 * np.pi * (700.0 + 100.0 * k) * n / FS)
        phase = 2 * np.pi * (offsets[k] * n / FS
                             + 2500.0 * np.cumsum(tone) / FS)
        x = x + amp * np.exp(1j * phase)
    return x.astype(np.complex64)


def planes(x: np.ndarray):
    """complex numpy block → (xr, xi) float32 torch planes."""
    return (torch.from_numpy(np.ascontiguousarray(x.real, np.float32)),
            torch.from_numpy(np.ascontiguousarray(x.imag, np.float32)))


def snr_db(ref, got) -> float:
    """Agreement of ``got`` with ``ref`` in dB (complex as re/im pairs)."""
    ref = np.asarray(ref)
    got = np.asarray(got)
    if np.iscomplexobj(ref):
        ref = np.stack([ref.real, ref.imag])
        got = np.stack([got.real, got.imag])
    ref = ref.astype(np.float64)
    err = got.astype(np.float64) - ref
    return float(10 * np.log10(np.mean(ref ** 2)
                               / max(np.mean(err ** 2), 1e-300)))


def leaves(tree, path=""):
    """(path, leaf) pairs of a dict/list tree, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_state_close(jax_state, port_state, min_db: float):
    """Same keys, shapes and dtypes; every leaf equal, or within
    ``min_db`` of the JAX package's where it is nonzero (any state tree:
    the shared-VFO and the channelized layouts alike)."""
    j = list(leaves(jax_state))
    p = list(leaves(convert.state_to_jax(port_state)))
    assert [k for k, _ in j] == [k for k, _ in p]
    for (path, a), (_, b) in zip(j, p):
        if a is None or b is None:       # a stateless block (RAW)
            assert a is None and b is None, path
            continue
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (path, a.shape, b.shape, a.dtype, b.dtype)
        if not np.any(a) or np.array_equal(a, b):
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            s = snr_db(a, b)
            assert s >= min_db, (path, s)


def assert_spectra_close(want: np.ndarray, got: np.ndarray):
    """dB spectra: <= 0.01 dB within 60 dB of each frame's peak, <= 0.1 dB
    within 80 dB."""
    assert want.shape == got.shape
    pk = want.max(axis=-1, keepdims=True)
    d = np.abs(got.astype(np.float64) - want)
    assert d[want > pk - 60].max() <= 0.01, d[want > pk - 60].max()
    assert d[want > pk - 80].max() <= 0.1, d[want > pk - 80].max()
    assert np.isfinite(got).all()


def tone_oracles(audio: np.ndarray, channels, fs_audio: float = 48_000.0):
    """(mean tone SNR, L/R separation) in dB of ``audio`` [C, 2, n] on
    ``channels``, channel k carrying tone_hz(k) in L only — the signal
    oracles of tests/test_bf16_handoff.py."""
    L = audio[channels, 0].astype(np.float64)
    R = audio[channels, 1].astype(np.float64)
    sep = 10 * np.log10(np.mean(L ** 2) / max(np.mean(R ** 2), 1e-15))
    n = L.shape[-1]
    tt = np.arange(n) / fs_audio
    snrs = []
    for i, k in enumerate(channels):
        f = tone_hz(k)
        A = np.stack([np.cos(2 * np.pi * f * tt), np.sin(2 * np.pi * f * tt),
                      np.ones(n)], 1)
        coef, *_ = np.linalg.lstsq(A, L[i], rcond=None)
        r = L[i] - A @ coef
        snrs.append(10 * np.log10(np.mean((A[:, :2] @ coef[:2]) ** 2)
                                  / np.mean(r ** 2)))
    return float(np.mean(snrs)), float(sep)


def multimode_iq(T: int, fs: float, carriers, seed: int = 0) -> np.ndarray:
    """chip_smoke.py's multi-mode bank signal (``multimode_wideband``):
    one carrier per (demod id, offset) pair, plus a little noise."""
    return _chip_smoke().multimode_wideband(T, fs, carriers, seed)


# ---------------------------------------------------------------------
# the noise path (tests/test_torch_noise*.py, tests/test_torch_app.py)

def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def assert_close(want, got, what="", min_db: float = 80.0):
    """Equal, or within ``min_db`` of the JAX package's output (arrays
    or tensors)."""
    want, got = _np(want), _np(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if not np.array_equal(want, got):
        assert snr_db(want, got) >= min_db, (what, snr_db(want, got))


def jit_methods(block, *names: str):
    """``block`` with its methods ``names`` (``apply`` by default) under
    ``jax.jit``: one XLA compile serves every block of a test, where op by
    op each operation compiles on its first shape and each ``lax.scan``
    body again at every call.  XLA:CPU then fuses and contracts
    multiply-adds, a last-bit difference that the tests' 80 dB bars hold;
    a test whose comparison it breaks keeps the JAX side op by op and says
    why."""
    import jax
    for name in names or ("apply",):
        setattr(block, name, jax.jit(getattr(block, name)))
    return block


def assert_nr_state(jax_state, port_state):
    """Same leaves (of two trees, either side's arrays or tensors); float
    leaves within 80 dB (or equal), integer and bool leaves equal."""
    j = list(leaves(jax_state))
    p = list(leaves(port_state))
    assert [k for k, _ in j] == [k for k, _ in p]
    for (path, a), (_, b) in zip(j, p):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape and a.dtype == b.dtype, \
            (path, a.shape, b.shape, a.dtype, b.dtype)
        if a.dtype.kind in "biu" or not np.any(a):
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            assert_close(a, b, path)


def speech_like(T: int, fs: float, seed: int) -> np.ndarray:
    """A tone at fs/20 gated at 1.5 Hz (0.3 amplitude) in complex noise
    (0.2 per component)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / fs
    x = 0.3 * np.exp(2j * np.pi * 0.05 * fs * t) * (np.sin(2 * np.pi * 1.5
                                                            * t) > 0)
    x = x + 0.2 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    return x.astype(np.complex64)


# ---------------------------------------------------------------------
# the served app (tests/test_torch_app.py against the JAX app on the CPU,
# tests/test_torch_cuda.py on the card against the CPU)

SERVED_FS = 1_000_000.0
SERVED_RADIOS = ("W", "N", "Q")
SERVED_BLOCKS = 4
SERVED_SWITCH_BEFORE = 2       # the retune and the demod switch, before block 3


def served_config(capture: str) -> dict:
    """A WFM radio on the station, an NFM radio on the carrier and a
    second NFM radio off the signal; manual pump, the DC blocker on."""
    return {"source": {"type": "file", "path": capture, "loop": True},
            "fftSize": 4096, "fftRate": 20, "pump": "manual",
            "dcBlocking": True,
            "modules": {
                "W": {"type": "radio", "demod": "WFM", "offset": -200e3},
                "N": {"type": "radio", "demod": "NFM", "offset": 300e3},
                "Q": {"type": "radio", "demod": "NFM", "offset": 450e3}}}


def served_capture(path: str):
    """A 1 s WAV capture (float32 IQ at SERVED_FS) of a stereo FM station
    (1 kHz tone in L, 19 kHz pilot) at −200 kHz, an NFM carrier (1 kHz
    tone, 2 kHz deviation) at +300 kHz, a little noise and a DC offset of
    0.1 + 0.05j."""
    from sdrplusplusbrown_tpu_torch.io.wav import write_wav
    fs = SERVED_FS
    T = int(fs)
    t = np.arange(T) / fs
    tone = np.sin(2 * np.pi * 1000.0 * t)
    mpx = (0.45 * tone + 0.1 * np.sin(2 * np.pi * 19_000.0 * t)
           + 0.45 * tone * -np.cos(2 * np.pi * 38_000.0 * t))
    x = 0.3 * np.exp(2j * np.pi * (-200e3 * t + 75_000.0 * np.cumsum(mpx)
                                   / fs))
    x = x + 0.3 * np.exp(2j * np.pi * (300e3 * t + 2000.0 * np.cumsum(tone)
                                       / fs))
    rng = np.random.default_rng(5)
    x = x + 1e-3 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    write_wav(path, (x + (0.1 + 0.05j)).astype(np.complex64), fs, bits=32)


def _served_snapshot(app, port: bool):
    """Every radio's carried state and the front end's (the pump's own
    ``fstate``); the port's copied to the CPU."""
    st = {n: app.modules[n].state for n in SERVED_RADIOS}
    st["frontend"] = app._pump_gen.gi_frame.f_locals["fstate"]
    if not port:
        return st
    return convert.state_from_jax(convert.state_to_jax(st), device="cpu")


def run_served(app, root: str, port: bool) -> dict:
    """The scripted session on one app (either package's): the squelched
    radio at −30 dB, a recorder on W, four blocks with a retune of W and
    N's switch NFM → USB before the third.  Returns per block each
    radio's audio, the waterfall lines pushed, the last spectrum line,
    each radio's vfo_snr and the state snapshots; the state right after
    the switch, the status and the recording's bytes."""
    app.start()
    app.modules["Q"].handle_debug_command("set_squelch", "-30")
    assert app.select_sink("W", "recorder")
    got = {n: [] for n in SERVED_RADIOS}
    for n in SERVED_RADIOS:
        app.modules[n].audio_event.bind(
            lambda blk, n=n: got[n].append(np.asarray(blk)))
    out = {"audio": [], "lines": [], "last": [], "snr": [], "state": []}
    seen = 0
    for b in range(SERVED_BLOCKS):
        if b == SERVED_SWITCH_BEFORE:
            assert app.set_vfo_offset("W", -180e3)
            r = app.modules["N"].handle_debug_command("set_demod", "USB")
            assert r == {"status": "ok", "demod": "USB", "id": 4}, r
            out["switched"] = _served_snapshot(app, port)
        assert app.pump_step(1) == 1
        out["audio"].append({n: np.concatenate(got[n], axis=-1)
                             for n in SERVED_RADIOS})
        for n in SERVED_RADIOS:
            got[n].clear()
        k = app.waterfall._count - seen
        out["lines"].append(app.waterfall.lines(k))
        seen += k
        out["last"].append(app.last_spectrum.copy())
        out["snr"].append({n: app.vfo_snr(n) for n in SERVED_RADIOS})
        out["state"].append(_served_snapshot(app, port))
    out["status"] = app.status()
    app.shutdown()
    rec, = glob.glob(os.path.join(root, "recordings", "sink_W_*.wav"))
    with open(rec, "rb") as f:
        out["recording"] = f.read()
    return out


# ---------------------------------------------------------------------
# the served app's noise path (tests/test_torch_app.py)

NOISE_FS = 240_000.0
NOISE_RADIOS = ("U", "N")
NOISE_BLOCKS = 9


def noise_capture(path: str):
    """A 1 s WAV capture at NOISE_FS: USB voice-like tone bursts (700 and
    1 540 Hz, 4 Hz on/off) at −40 kHz, an NFM carrier (1 kHz tone) at
    +50 kHz, an impulse of 5 every 3 001 samples, complex noise 0.02 per
    component and a DC offset of 0.05."""
    from sdrplusplusbrown_tpu_torch.io.wav import write_wav
    fs = NOISE_FS
    T = int(fs)
    t = np.arange(T) / fs
    gate = (np.floor(t * 8.0) % 2) == 0
    voice = gate * (np.exp(2j * np.pi * 700.0 * t)
                    + 0.5 * np.exp(2j * np.pi * 1540.0 * t))
    x = 0.2 * voice * np.exp(-2j * np.pi * 40e3 * t)
    tone = np.sin(2 * np.pi * 1000.0 * t)
    x = x + 0.3 * np.exp(2j * np.pi * (50e3 * t + 2000.0 * np.cumsum(tone)
                                       / fs))
    rng = np.random.default_rng(17)
    x = x + 0.02 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    x[::3001] += 5.0
    write_wav(path, (x + 0.05).astype(np.complex64), fs, bits=32)


def noise_config(capture: str, ifnr: bool) -> dict:
    """A USB radio on the voice and an NFM radio on the carrier; manual
    pump, the DC blocker on, the IF NR from the config when ``ifnr``."""
    return {"source": {"type": "file", "path": capture, "loop": True},
            "fftSize": 4096, "fftRate": 20, "pump": "manual",
            "dcBlocking": True, "ifnr": ifnr,
            "modules": {
                "U": {"type": "radio", "demod": "USB", "offset": -40e3},
                "N": {"type": "radio", "demod": "NFM", "offset": 50e3}}}


def _noise_snapshot(app, port: bool) -> dict:
    """The radios' states, their AF NR states, the pump's two front-end
    states (where they exist), as numpy trees."""
    f = app._pump_gen.gi_frame.f_locals
    st = {n: app.modules[n].state for n in NOISE_RADIOS}
    for n in NOISE_RADIOS:
        if app.modules[n].afnr_state is not None:
            st[f"afnr_{n}"] = app.modules[n].afnr_state
    for k in ("fstate", "fstate_nr"):
        if f.get(k) is not None:
            st[k] = f[k]
    return convert.state_to_jax(st) if port else st


def run_noise(app, script: str, port: bool) -> dict:
    """A scripted noise-path session on one app (either package's), the
    real-time guard on a clock that only the script moves:

      * "config": the IF NR from the config, ``set_afnr logmmse`` on U,
        ``set_nb`` and ``set_fmif`` on N before block 1;
      * "midrun": no IF NR in the config; before block 3
        ``set_ifnr_enabled(True)`` and ``set_afnr logmmse`` on U, from a
        fresh state mid-run;
      * "shed": the IF NR from the config on a clock that takes a second
        a block once it is primed, so the guard sheds it.

    Returns per block each radio's audio, the baseband, the state
    snapshot, the status and whether the IF NR is primed; and each
    radio's last Radio and params."""
    clock = [0.0]

    def tick():
        if script == "shed" and app.ifnr_primed:
            clock[0] += 1.0
        return clock[0]
    app._clock = tick
    app.start()
    if script == "config":
        assert app.modules["U"].handle_debug_command(
            "set_afnr", "logmmse") == {"status": "ok", "afnr": "logmmse"}
        for cmd in ("set_nb", "set_fmif"):
            r = app.modules["N"].handle_debug_command(cmd, "on")
            assert r == {"status": "ok", cmd[4:]: True}, r
    got = {n: [] for n in NOISE_RADIOS}
    for n in NOISE_RADIOS:
        app.modules[n].audio_event.bind(
            lambda blk, n=n: got[n].append(np.asarray(blk)))
    bbs = []
    app.baseband_event.bind(lambda bb: bbs.append(np.asarray(bb)))
    out = {"audio": [], "bb": [], "state": [], "status": [], "primed": []}
    for b in range(NOISE_BLOCKS):
        if script == "midrun" and b == 2:
            app.set_ifnr_enabled(True)
            assert app.modules["U"].handle_debug_command(
                "set_afnr", "logmmse") == {"status": "ok",
                                           "afnr": "logmmse"}
        assert app.pump_step(1) == 1
        out["audio"].append({n: np.concatenate(got[n], axis=-1) if got[n]
                             else np.zeros((2, 0), np.float32)
                             for n in NOISE_RADIOS})
        for n in NOISE_RADIOS:
            got[n].clear()
        out["bb"].append(bbs.pop())
        out["state"].append(_noise_snapshot(app, port))
        out["status"].append(app.status())
        out["primed"].append(app.ifnr_primed)
    out["afnr"] = {n: app.modules[n].handle_debug_command("get_afnr", "")
                   for n in NOISE_RADIOS}
    out["radio"] = {n: (app.modules[n].radio, app.modules[n].params)
                    for n in NOISE_RADIOS}
    app.shutdown()
    return out


def _chip_smoke():
    """chip_smoke.py as a module (its helpers need no card)."""
    global _SMOKE
    if _SMOKE is None:
        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        _SMOKE = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_SMOKE)
    return _SMOKE


_SMOKE = None


# ---------------------------------------------------------------------
# RDS (tests/test_torch_rds.py, tests/test_torch_app.py)

RDS_PI, RDS_PS, RDS_RT = 0xABCD, "TESTFM  ", "HELLO RADIO TEXT"


def rds_bits(repeats: int = 1) -> np.ndarray:
    """The PS groups (0A, addresses 0-3) then the RadioText groups (2A,
    addresses 0-3) of RDS_PI / RDS_PS / RDS_RT, PTY 5, as bits."""
    from sdrplusplusbrown_tpu_torch.models.rds import (rds_encode_group,
                                                       rds_group_bits)
    groups = []
    for a in range(4):
        groups.append(rds_encode_group(
            RDS_PI, 0, False, 5, a, 0,
            (ord(RDS_PS[2 * a]) << 8) | ord(RDS_PS[2 * a + 1])))
    for a in range(4):
        c = RDS_RT[4 * a:4 * a + 4].ljust(4)
        groups.append(rds_encode_group(
            RDS_PI, 2, False, 5, a, (ord(c[0]) << 8) | ord(c[1]),
            (ord(c[2]) << 8) | ord(c[3])))
    return np.tile(np.concatenate([rds_group_bits(g) for g in groups]),
                   repeats)


def rds_biphase(t: np.ndarray, bits: np.ndarray,
                fbit: float = 1187.5) -> np.ndarray:
    """The differentially encoded, biphase (Manchester) RDS data signal
    at times ``t`` (s), bit k over [k/fbit, (k+1)/fbit)."""
    d = 1.0 - 2.0 * (np.cumsum(bits) % 2)
    pos = t * fbit
    idx = np.minimum(pos.astype(int), len(bits) - 1)
    return d[idx] * np.where(pos - np.floor(pos) < 0.5, 1.0, -1.0)


def rds_fm_iq(T: int, fs: float, offset: float = 0.0,
              seed: int = 0) -> np.ndarray:
    """A stereo FM station at ``offset`` carrying RDS: the MPX is a 1 kHz
    tone in L (0.4 L+R, 0.4 L−R on −cos 38 kHz), the 19 kHz pilot (0.1)
    and the RDS biphase on cos 57 kHz (0.08), at 75 kHz deviation, plus
    a little noise."""
    t = np.arange(T) / fs
    bits = rds_bits(int(T / fs * 1187.5) // 832 + 1)
    tone = np.sin(2 * np.pi * 1000.0 * t)
    mpx = (0.4 * tone + 0.4 * tone * -np.cos(2 * np.pi * 38_000.0 * t)
           + 0.1 * np.sin(2 * np.pi * 19_000.0 * t)
           + 0.08 * rds_biphase(t, bits) * np.cos(2 * np.pi * 57_000.0 * t))
    x = 0.5 * np.exp(2j * np.pi * (offset * t + 75_000.0 * np.cumsum(mpx)
                                   / fs))
    rng = np.random.default_rng(seed)
    x = x + 1e-3 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
    return x.astype(np.complex64)


def assert_mm_state(jax_state, port_state):
    """An M&M clock recovery's state (or a tree holding one under
    ``recov``): every leaf as ``assert_nr_state``, but the fractional
    sample position ``phase`` (in [0, 1)) within 1e-5 of a sample.  Each
    symbol adds ω ≈ 4.2 to it and takes the floor off, so it carries the
    rounding of ω's scale (4.8e-7) a symbol, which XLA:CPU's fused
    multiply-adds round differently from the port's separate operations:
    the two walk apart by ~1e-6 over a block, a fraction of a polyphase
    step (1/128), which a phase near 0 would turn into a relative error
    of -80 dB or worse."""
    j, p = _np_tree(jax_state), _np_tree(port_state)
    jph = j.get("recov", j).pop("phase")
    pph = p.get("recov", p).pop("phase")
    assert_nr_state(j, p)
    assert np.abs(jph.astype(np.float64) - pph).max() <= 1e-5, (jph, pph)


def _np_tree(tree):
    """A copy of a dict/list tree with numpy leaves."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return _np(tree)


# ---------------------------------------------------------------------
# the network path (tests/test_torch_stream.py, test_torch_rigctl.py,
# test_torch_iq_exporter.py)

NET_FS = 240_000.0


def net_capture(path: str, seconds: float = 1.0):
    """A WAV capture (float32 IQ at NET_FS) of an NFM carrier at +50 kHz
    (1 kHz tone, 2.5 kHz peak deviation) in light noise: the capture of
    tests/test_torch_http_e2e.py."""
    from sdrplusplusbrown_tpu_torch.io.wav import write_wav
    T = int(NET_FS * seconds)
    n = np.arange(T)
    audio = 0.8 * np.sin(2 * np.pi * 1000 * n / NET_FS)
    phase = 2 * np.pi * np.cumsum(2500 * audio) / NET_FS
    rng = np.random.default_rng(9)
    x = (0.6 * np.exp(1j * (2 * np.pi * 50e3 * n / NET_FS + phase))
         + 0.01 * (rng.standard_normal(T) + 1j * rng.standard_normal(T)))
    write_wav(path, x.astype(np.complex64), NET_FS, bits=32)


def net_config(source: dict, **modules) -> dict:
    """A manual-pump config on ``source`` with an NFM radio "Radio" on the
    carrier and any further ``modules``."""
    return {"source": source, "fftSize": 4096, "fftRate": 20,
            "pump": "manual",
            "modules": {"Radio": {"type": "radio", "demod": "NFM",
                                  "offset": 50e3}, **modules}}


def equal_tree(a, b) -> bool:
    """Equal results: arrays by value, tuples, lists and dicts element by
    element, anything else by ``==``."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(equal_tree(a[k], b[k])
                                            for k in a)
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(equal_tree(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return a is not None and b is not None and np.array_equal(a, b)
    return a == b


def wait_for(pred, what: str, timeout: float = 10.0):
    """Poll ``pred`` until it holds; fail with ``what`` after
    ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(what)
        time.sleep(0.01)


# ---- K14 and K15 (the served block's host-bound recurrences) --------------


def logmmse_frames_inputs(core, batch, frames, count, seed):
    """K14's inputs (tests/test_torch_host_path_kernels.py,
    tests/test_torch_cuda.py): a LogMMSE state as a stream leaves it,
    the rings filled with |spectra|-like values to ``count`` frames, the
    slot after them, a PSD and the last frame's X; and ``frames`` frames
    of magnitudes."""
    rng = np.random.default_rng(seed)
    N, H = core.nFFT, core.H
    st = core.init_state(batch)
    mag = lambda *s: (rng.rayleigh(1.0, s) + 1e-3).astype(np.float32)
    filled = min(count, H)
    hist = np.zeros(batch + (H, N), np.float32)
    hist[..., :filled, :] = mag(*batch, filled, N)
    dev = np.zeros_like(hist)
    dev[..., :filled, :] = mag(*batch, filled, N) ** 2
    st.update(
        hist=torch.from_numpy(hist), dev_hist=torch.from_numpy(dev),
        sums=torch.from_numpy(hist.sum(-2)),
        devs=torch.from_numpy(dev.sum(-2)),
        count=torch.tensor(count, dtype=torch.int32),
        pos=torch.tensor(count % H, dtype=torch.int32),
        noise_mu2=torch.from_numpy(mag(*batch, N) ** 2),
        Xk_prev=torch.from_numpy(mag(*batch, N) ** 2),
        has_prev=torch.from_numpy(np.arange(int(np.prod(batch, dtype=int)))
                                  .reshape(batch) % 2 == 0)
        if batch else torch.tensor(count > 0))
    return st, torch.from_numpy(mag(*batch, frames, N) * 2.0)


def _fma(a, y, b):
    """a·y + b rounded once to float32 (csrc/recurrence.cu's __fmaf_rn;
    the exact product in float64, then the sum: a double rounding that
    differs from the card's in a last bit at rare ties), each part of a
    complex y, b; exact in float64 inputs."""
    y, b = np.asarray(y), np.asarray(b)
    dt = np.result_type(y.dtype, b.dtype)
    if dt in (np.float64, np.complex128):
        return a * y + b
    if np.iscomplexobj(y) or np.iscomplexobj(b):
        out = np.empty(np.broadcast_shapes(np.shape(a), y.shape, b.shape),
                       dt)
        out.real = _fma(a, y.real, b.real)
        out.imag = _fma(a, y.imag, b.imag)
        return out
    return (np.float64(1) * a * y.astype(np.float64)
            + b.astype(np.float64)).astype(np.float32)


def _warp_scan(A, B):
    """csrc/recurrence.cu:warp_scan on maps [..., 32] (lanes last)."""
    d = 1
    while d < 32:
        Ap = np.concatenate([A[..., :d], A[..., :-d]], axis=-1)
        Bp = np.concatenate([B[..., :d], B[..., :-d]], axis=-1)
        lanes = np.arange(32) >= d
        A, B = np.where(lanes, Ap * A, A), np.where(lanes, _fma(A, Bp, B), B)
        d *= 2
    return A, B


#: samples a lane, warps a block and the largest cluster of K15
#: (csrc/recurrence.cu: K, WARPS, CLUSTER_MAX)
RECURRENCE_K, RECURRENCE_WARPS, RECURRENCE_CLUSTER = 4, 32, 16


def recurrence_cluster_size(T: int, cmax: int = RECURRENCE_CLUSTER) -> int:
    """Blocks (one cluster) K15 gives a row of T samples
    (csrc/recurrence.cu:cluster_size): as many as give each warp a batch
    of 32 lanes × RECURRENCE_K samples, at most ``cmax`` (16 on an H100,
    where a GPC holds 16 of its blocks)."""
    batches = -(-T // (32 * RECURRENCE_K))
    return max(1, min(cmax, -(-batches // RECURRENCE_WARPS)))


def recurrence_segments(T, cluster):
    """K15's partition of a row of T samples (csrc/recurrence.cu): the
    sample index of [block, warp, batch, lane, k], −1 past a warp's
    segment.  A cluster of ``cluster`` blocks takes runs of whole batches
    of 32 lanes × RECURRENCE_K samples, a block's run cut into
    RECURRENCE_WARPS segments."""
    W, K = RECURRENCE_WARPS, RECURRENCE_K
    batch = 32 * K
    nb = -(-T // batch)
    per_block = -(-nb // cluster)
    per_warp = -(-per_block // W)
    b0 = np.minimum(np.arange(cluster) * per_block, nb)[:, None]
    b1 = np.minimum(b0 + per_block, nb)
    sb = np.minimum(b0 + np.arange(W) * per_warp, b1)          # [C, W]
    se = np.minimum(sb + per_warp, b1)
    bt = sb[..., None] + np.arange(per_warp)                   # [C, W, j]
    i = (bt[..., None, None] * batch + np.arange(32)[:, None] * K
         + np.arange(K))
    ok = (bt < se[..., None])[..., None, None] & (i < T)
    return np.where(ok, i, -1)


def recurrence_chunks_model(a, b, y0, cluster=None):
    """K15's arithmetic (csrc/recurrence.cu) in numpy on rows [R, T]: a
    cluster of ``cluster`` blocks a row (default
    ``recurrence_cluster_size(T)``), each block's run of batches cut into
    RECURRENCE_WARPS segments (``recurrence_segments``), each batch's
    lane maps composed sample by sample and scanned, folded into its
    segment's; a block's segment maps scanned; each block's start the
    blocks before it applied to y0 in order, each segment's the prefix
    of the segments before it applied to that; each segment walked batch
    by batch from its start; at a segment's last sample short of the
    row's end the next segment's start is written (after a block's last
    segment the next block's).  Every a·y + b is one rounding
    (``_fma``); the identity, a = 1 and b = 0, past a segment's end."""
    R, T = b.shape
    C = recurrence_cluster_size(T) if cluster is None else cluster
    idx = recurrence_segments(T, C)          # [C, W, per, 32, K]
    per = idx.shape[2]
    wide = b.dtype in (np.float64, np.complex128)
    a = np.broadcast_to(np.asarray(a, np.float64 if wide else np.float32),
                        b.shape)
    one, zero = a.dtype.type(1), b.dtype.type(0)
    ok = idx >= 0
    av = np.where(ok, a[:, np.maximum(idx, 0)], one)   # [R, C, W, per, 32, K]
    bv = np.where(ok, b[:, np.maximum(idx, 0)], zero)

    def lane_maps(j):
        A = np.full(av.shape[:3] + (32,), one, a.dtype)
        B = np.full(av.shape[:3] + (32,), zero, b.dtype)
        for k in range(RECURRENCE_K):
            A, B = A * av[..., j, :, k], _fma(av[..., j, :, k], B,
                                             bv[..., j, :, k])
        return _warp_scan(A, B)

    As = np.full(av.shape[:3], one, a.dtype)        # [R, C, W]
    Bs = np.full(av.shape[:3], zero, b.dtype)
    for j in range(per):
        A, B = lane_maps(j)
        As, Bs = As * A[..., 31], _fma(A[..., 31], Bs, B[..., 31])
    Aw, Bw = _warp_scan(As, Bs)                     # warps' prefix maps
    y = np.asarray(y0, b.dtype).copy()
    start = np.empty((R, C), b.dtype)
    for c in range(C):                              # the blocks in order
        start[:, c] = y
        y = _fma(Aw[:, c, 31], y, Bw[:, c, 31])
    carry = np.concatenate([start[..., None], _fma(
        Aw[..., :-1], start[..., None], Bw[..., :-1])], axis=-1)
    # the next segment's start, written at a segment's last sample short
    # of the row's end: the next warp's, or after the block's last
    # segment the next block's
    nxt = np.concatenate([carry[..., 1:], np.concatenate(
        [start[:, 1:], y[:, None]], axis=1)[..., None]], axis=-1)
    out = np.zeros((R, T), b.dtype)
    for j in range(per):
        A, B = lane_maps(j)
        yv = np.concatenate([carry[..., None], _fma(
            A[..., :-1], carry[..., None], B[..., :-1])], axis=-1)
        for k in range(RECURRENCE_K):
            yv = _fma(av[..., j, :, k], yv, bv[..., j, :, k])
            i = idx[:, :, j, :, k]
            out[:, i[i >= 0]] = yv[:, i >= 0]
        carry = yv[..., 31]
    seg_end = idx.reshape(C, RECURRENCE_WARPS, -1).max(-1) + 1   # 0: empty
    run_end = seg_end.max(-1)
    for c in range(C):
        for w in range(RECURRENCE_WARPS):
            s1 = seg_end[c, w]
            if 0 < s1 < T:
                out[:, s1 - 1] = (nxt[:, c, RECURRENCE_WARPS - 1]
                                  if s1 == run_end[c] else nxt[:, c, w])
    return out


def dc_blocker_model(pole, gain, x, y0):
    """K15's "dc" form in numpy: b = gain·x, the recurrence as
    ``recurrence_chunks_model``, out[n] = x[n] − o[n−1] → (out, o[:, −1])."""
    o = recurrence_chunks_model(pole, x * np.float32(gain), y0)
    prev = np.concatenate([np.asarray(y0, x.dtype)[:, None], o[:, :-1]],
                          axis=1)
    return x - prev, o[:, -1]


def noise_blanker_model(pole, gain, level, x, y0):
    """K15's "nb" form in numpy: m = |x|, the envelope's recurrence (held
    over m = 0) as ``recurrence_chunks_model``, e = m / amp, the gain 1/e
    where e > level → (x · gain, amp[:, −1])."""
    f = np.float32
    m = np.abs(x).astype(f)
    nz = m != 0
    a = np.where(nz, f(pole), f(1)).astype(f)
    b = np.where(nz, m * f(gain), f(0)).astype(f)
    amp = recurrence_chunks_model(a, b, np.asarray(y0, f))
    with np.errstate(divide="ignore", invalid="ignore"):
        e = np.where(nz, m / amp, f(1)).astype(f)
        g = np.where(e > f(level), f(1) / e, f(1)).astype(f)
    return (x * g).astype(x.dtype), amp[:, -1]


def recurrence_cases():
    """(name, a, b, y0) of K15 at the paths' poles and row shapes."""
    rng = np.random.default_rng(5)
    T = 120_000
    x = (rng.standard_normal(T) + 1j * rng.standard_normal(T) + 0.1
         + 0.1j).astype(np.complex64)[None] * np.float32(0.3)
    r = np.float32(50.0 / 2.4e6)       # the front end's DC blocker
    yield ("front end DC", float(np.float32(1) - r), x * r,
           np.array([0.05 + 0.02j], np.complex64))
    amp = np.abs(x).astype(np.float32)
    amp[0, ::977] = 0.0                 # the blanker holds zero samples
    rb = np.float32(500.0 / 24000.0)
    nz = amp != 0
    yield ("noise blanker", np.where(nz, np.float32(1) - rb, np.float32(1))
           .astype(np.float32), np.where(nz, amp * rb, 0).astype(np.float32),
           np.array([1.0], np.float32))
    m = rng.standard_normal((4, 2_400)).astype(np.float32) + 0.5
    ra = np.float32(100.0 / 24_000.0)   # the AM demod's DC blocker rows
    yield ("AM DC rows", float(np.float32(1) - ra),
           (m * ra).astype(np.complex64), np.zeros(4, np.complex64))
    yield ("short row", 0.5, rng.standard_normal((3, 100)).astype(np.float32),
           np.ones(3, np.float32))


def recurrence_fused_cases():
    """(name, form, pole, gain, level, x, y0) at the fused forms' paths:
    the front end's DC blocker (50/SR, one 120 000-sample complex row),
    the AM demod's (100/IF, 4 float32 envelope rows), the noise blanker
    (500/24000, level 10) on a complex row with impulses (blanked) and
    zero samples (held), and on 2 rows with a level tensor."""
    rng = np.random.default_rng(7)
    f = np.float32
    T = 120_000
    x = ((rng.standard_normal(T) + 1j * rng.standard_normal(T) + 0.1
          + 0.1j) * 0.3).astype(np.complex64)[None]
    r = f(50.0 / 2.4e6)
    yield ("front end DC", "dc", float(f(1) - r), float(r), 0.0, x,
           np.array([0.05 + 0.02j], np.complex64))
    m = rng.standard_normal((4, 2_400)).astype(f) + 0.5
    ra = f(100.0 / 24_000.0)
    yield ("AM DC rows", "dc", float(f(1) - ra), float(ra), 0.0, m,
           rng.standard_normal(4).astype(f))
    xi = x.copy()
    xi[0, ::1000] *= 60.0
    xi[0, 5::977] = 0.0
    rb = f(500.0 / 24_000.0)
    yield ("noise blanker", "nb", float(f(1) - rb), float(rb), 10.0, xi,
           np.ones(1, f))
    yield ("noise blanker, level 4, 2 rows", "nb", float(f(1) - rb),
           float(rb), 4.0, xi.reshape(2, -1), np.array([1.0, 0.3], f))
