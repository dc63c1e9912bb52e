"""The port's first decoders against the JAX package on the CPU: M17,
KG-SSTV, RyFi and Meteor, each on one seeded signal made by the port's own
modulators (``chip_smoke.py``'s generators: ``RRCInterpolator``,
``QuadratureMod``), decoded by the JAX package and by the port with
``device="cpu"`` (the plain versions of K8, K12c, K13, K16); and the four
module types on the port's app (``--device cpu``) against the JAX app's,
answering their debug commands.

Tolerances: the decoded products (M17's LSF callsigns and stream
payloads, KG-SSTV's frames, RyFi's packets) equal the JAX package's and
the transmitted ones, exactly; Meteor's soft symbols (a float chain of
loops) >= 80 dB to the JAX package's except the few that a step of the
clock's polyphase index moves (tests/test_torch_digital.py says why), and
stage by stage on the JAX stage's input; the chain's decisions after
lock equal the transmitted QPSK symbols up to rotation (the broken
constellation and OQPSK: the JAX tests' bars); the recorded int8 stream
within one step of the JAX app's but for at most 1 % of its values.  The JAX demods run under ``jax.jit``, built once a module.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sdrplusplusbrown_tpu.app import SDRApp as JaxApp
from sdrplusplusbrown_tpu.models import kg_sstv as jax_kg
from sdrplusplusbrown_tpu.models import m17 as jax_m17
from sdrplusplusbrown_tpu.models import meteor as jax_meteor
from sdrplusplusbrown_tpu.models import ryfi as jax_ryfi
from sdrplusplusbrown_tpu_torch.app import SDRApp
from sdrplusplusbrown_tpu_torch.models import kg_sstv, m17, meteor, ryfi

from torch_parity import _chip_smoke, snr_db

SMOKE = _chip_smoke()


def _noisy(x: np.ndarray, seed: int, sigma: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (x + sigma * (rng.standard_normal(len(x))
                         + 1j * rng.standard_normal(len(x)))
            ).astype(np.complex64)


def _jax_run(block, x):
    """The JAX block on one stream under jax.jit: its outputs as numpy."""
    out, _ = jax.jit(lambda s, v: block.apply(None, s, v))(
        block.init_state(()), jnp.asarray(x))
    return [np.asarray(v) for v in out]


def _port_run(block, x):
    out, _ = block.apply(None, block.init_state(()), torch.from_numpy(x))
    return [v.numpy() for v in out]


@pytest.fixture(scope="module")
def m17_case():
    iq, payloads = SMOKE.m17_signal(14_400.0)
    return _noisy(iq, 17, 0.02), payloads


def test_m17_loopback(m17_case):
    """The station's LSF arrives through the LICH and every stream frame
    from the third on (the demod settles over the first two, in both
    packages) decodes to its payload, in both packages alike."""
    iq, payloads = m17_case
    jb, jv = _jax_run(jax_m17.M17Demod(14_400.0), iq)
    pb, pv = _port_run(m17.M17Demod(14_400.0), iq)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pb[pv], jb[jv])
    jf, pf = jax_m17.M17FrameDecoder(), m17.M17FrameDecoder(device="cpu")
    jf.push_bits(jb[jv])
    pf.push_bits(pb[pv])
    assert pf.stream_frames == jf.stream_frames
    assert [fn for fn, _ in pf.stream_frames] == list(range(2, len(payloads)))
    assert all(payloads[fn] == by for fn, by in pf.stream_frames)
    assert dataclasses.asdict(pf.lsf) == dataclasses.asdict(jf.lsf)
    assert pf.lsf.valid
    assert (pf.lsf.dst, pf.lsf.src) == (SMOKE.M17_DST, SMOKE.M17_SRC)


def test_m17_lsf_frame_decodes():
    """An LSF frame with four bit errors (the punctured K = 5 Viterbi with
    neutral soft bits) in both packages."""
    lsf = m17.encode_lsf("AB1CDE", "N0CALL")
    frame = m17.build_lsf_frame(lsf)
    np.testing.assert_array_equal(frame, jax_m17.build_lsf_frame(lsf))
    frame[[20, 90, 200, 333]] ^= 1
    jf, pf = jax_m17.M17FrameDecoder(), m17.M17FrameDecoder(device="cpu")
    jf.push_bits(frame)
    pf.push_bits(frame)
    assert dataclasses.asdict(pf.lsf) == dataclasses.asdict(jf.lsf)
    assert pf.lsf.src == "N0CALL"


def test_kg_sstv_loopback():
    fs = 48_000.0
    iq = _noisy(SMOKE.kg_sstv_signal(fs, np.random.default_rng(5)), 6,
                0.02)
    js, jv = _jax_run(jax_kg.KGSSTVDemod(fs), iq)
    ps, pv = _port_run(kg_sstv.KGSSTVDemod(fs), iq)
    np.testing.assert_array_equal(pv, jv)
    assert snr_db(js[jv], ps[pv]) >= 80.0
    jd, pd = jax_kg.KGSSTVDeframer(), kg_sstv.KGSSTVDeframer(device="cpu")
    jd.push_symbols(js[jv])
    pd.push_symbols(ps[pv])
    assert pd.frames == jd.frames == list(SMOKE.KG_PAYLOADS)


def test_ryfi_loopback():
    """240 kBd at 720 kS/s: both packets exact, no bad frame."""
    baud, fs = 240_000.0, 720_000.0
    rng = np.random.default_rng(68)
    iq = _noisy(SMOKE.ryfi_signal(baud, fs, SMOKE.RYFI_PACKETS, rng,
                                  idle=1000), 69, 0.01)
    jr = jax_ryfi.RyfiReceiver(baud, fs)
    pr = ryfi.RyfiReceiver(baud, fs, device="cpu")
    want = [bytes(p) for p in SMOKE.RYFI_PACKETS]
    assert jr.process(iq) == want
    assert pr.process(iq) == want
    assert (pr.frames_decoded, pr.frames_bad) == (jr.frames_decoded, 0)
    assert pr.frames_decoded == len(ryfi.pack_packets(want))


def _jax_stage(block, state, x):
    out, _ = jax.jit(lambda s, v: block.apply(None, s, v))(state, x)
    return out


def _meteor_grid_deg(soft: np.ndarray, skip: int) -> float:
    """The median distance of ``soft`` past ``skip`` from the ±45° grid,
    in degrees (tests/test_decoders_wave1.py's OQPSK bar: 10)."""
    dev = np.abs((np.angle(soft[skip:]) % (np.pi / 2)) - np.pi / 4)
    return float(np.rad2deg(np.median(dev)))


@pytest.mark.parametrize("kind", ["qpsk", "broken", "oqpsk"])
def test_meteor_loopback(kind):
    """Stage by stage on the JAX stage's input (RRC, AGC, Costas — with
    the nearest-phase detector for ``broken`` —, the OQPSK Q delay, M&M):
    >= 80 dB, the symbols within 1e-5 and ``valid`` equal.  Then each
    package's whole chain, the port's over two blocks (``last_q`` carried
    across them): QPSK decisions after lock equal the transmitted symbols
    up to rotation; the broken constellation within a median 25° of its
    phases, OQPSK within 10° of the ±45° grid (the JAX tests' bars).  The
    JAX chain is its stages composed."""
    rng = np.random.default_rng(3)
    sym = SMOKE.meteor_symbols(kind, 3000, rng)
    iq = _noisy(SMOKE.meteor_signal(kind, 150_000.0, sym), 4, 0.02)
    kw = dict(broken_modulation=kind == "broken", oqpsk=kind == "oqpsk")
    jd, pd = jax_meteor.MeteorDemod(**kw), meteor.MeteorDemod(**kw)
    jst, pst = jd.init_state(()), pd.init_state(())
    x = jnp.asarray(iq)
    for name in ("rrc", "agc", "costas"):
        want = _jax_stage(getattr(jd, name), jst[name], x)
        got, _ = getattr(pd, name).apply(None, pst[name],
                                         torch.from_numpy(np.array(x)))
        assert snr_db(np.asarray(want), got.numpy()) >= 80.0, name
        x = want
    if kind == "oqpsk":
        y = np.asarray(x)
        x = jnp.asarray((y.real + 1j * np.concatenate(
            [[0.0], y.imag[:-1]])).astype(np.complex64))
    (jo, jv) = [np.asarray(v) for v in _jax_stage(jd.recov, jst["recov"],
                                                  x)]
    (po, pv), _ = pd.recov.apply(None, pst["recov"],
                                 torch.from_numpy(np.array(x)))
    np.testing.assert_array_equal(pv.numpy(), jv)
    assert np.abs(po.numpy() - jo).max() <= 1e-5
    half = len(iq) // 2
    st, outs = pd.init_state(()), []
    for blk in (iq[:half], iq[half:]):
        (s, v), st = pd.apply(None, st, torch.from_numpy(blk))
        outs.append(s[v].numpy())
    chains = {"jax": jo[jv], "port": np.concatenate(outs)}
    for pkg, soft in chains.items():
        if kind == "broken":
            assert SMOKE.broken_deviation_deg(soft, 1500) < 25.0, pkg
        elif kind == "oqpsk":
            assert _meteor_grid_deg(soft, 1500) < 10.0, pkg
        else:
            m, err = SMOKE.qpsk_decisions(soft, sym, 1500)
            assert m > 1000 and err == 0, (pkg, m, err)
    np.testing.assert_array_equal(meteor.soft_to_int8(chains["port"]),
                                  jax_meteor.soft_to_int8(chains["port"]))


# ---- the app's module types -------------------------------------------
def _apps(tmp_path, config: dict):
    """The JAX app and the port's app (``device="cpu"``) from one
    config.json in two roots."""
    apps = []
    for name, cls, kw in (("jax", JaxApp, {}), ("port", SDRApp,
                                                {"device": "cpu"})):
        root = tmp_path / name
        os.makedirs(root, exist_ok=True)
        with open(root / "config.json", "w") as f:
            json.dump(config, f)
        apps.append(cls(str(root), run_pump=False, **kw))
    return apps


def _feed(mod, iq, pad_blocks: int = 1):
    """``iq`` and zeros to ``pad_blocks`` whole blocks more through the
    module's baseband handler."""
    blk = mod.rc.out_len
    mod._on_baseband(np.concatenate(
        [iq, np.zeros((-len(iq)) % blk + pad_blocks * blk, np.complex64)]))


def _replies(mod, script):
    return [mod.handle_debug_command(c, a) for c, a in script]


def test_app_m17_and_kg_sstv_modules(tmp_path):
    """One app of each package at 48 kS/s with an M17 decoder at +6 kHz
    and a KG-SSTV decoder at −9 kHz; the same baseband through both; the
    modules' commands answer alike."""
    fs = 48_000.0
    m17_bb = SMOKE.m17_signal(fs)[0]
    kg = SMOKE.kg_sstv_signal(fs, np.random.default_rng(5))
    n = np.arange(len(m17_bb))
    kg_bb = np.zeros(len(n), np.complex64)
    kg_bb[:min(len(kg), len(n))] = kg[:len(n)]
    bb = _noisy(0.5 * m17_bb * np.exp(2j * np.pi * 6e3 * n / fs)
                + 0.5 * kg_bb * np.exp(-2j * np.pi * 9e3 * n / fs), 8, 0.005)
    config = {"source": {"type": "none", "samplerate": fs},
              "fftSize": 4096,
              "modules": {"M": {"type": "m17_decoder", "offset": 6e3},
                          "K": {"type": "kg_sstv_decoder", "offset": -9e3}}}
    script = [("get_lsf", ""), ("get_stream", ""), ("set_offset", "x"),
              ("status", ""), ("get_frames", ""), ("bogus", "")]
    jax_app, port_app = _apps(tmp_path, config)
    try:
        out = []
        for app in (jax_app, port_app):
            for name in ("M", "K"):
                _feed(app.modules[name], bb)
            out.append({k: _replies(app.modules[k], script)
                        for k in ("M", "K")})
        assert out[0] == out[1]
        lsf = out[1]["M"][0]
        assert lsf["valid"] and (lsf["dst"], lsf["src"]) == (
            SMOKE.M17_DST, SMOKE.M17_SRC), lsf
        assert out[1]["M"][1]["total"] >= 12
        assert out[1]["K"][4]["frames"] == [p.hex()
                                            for p in SMOKE.KG_PAYLOADS]
        assert port_app.modules["M"].handle_debug_command(
            "set_offset", "6000") == {"status": "ok", "offset": 6000.0}
    finally:
        jax_app.shutdown()
        port_app.shutdown()


def test_app_ryfi_module(tmp_path):
    """tests/test_ryfi.py's module surface on both apps: one packet
    through ``process_iq`` at 3 samples a symbol with no VFO (here 100 kBd
    at 300 kS/s: one 0.1 s block holds the frame); status and
    packets."""
    config = {"source": {"type": "none", "samplerate": 300_000.0},
              "fftSize": 4096,
              "modules": {"RyFi": {"type": "ryfi_decoder",
                                   "baudrate": 100_000.0,
                                   "channel_sr": 300_000.0}}}
    pkts = [b"module packet"]
    iq = SMOKE.ryfi_signal(100_000.0, 300_000.0, pkts,
                           np.random.default_rng(2), idle=500)
    script = [("status", ""), ("get_packets", "4"), ("get_packets", "x")]
    jax_app, port_app = _apps(tmp_path, config)
    try:
        out = []
        for app in (jax_app, port_app):
            mod = app.modules["RyFi"]
            blk = mod.rc.out_len
            mod.process_iq(np.concatenate(
                [iq, np.zeros((-len(iq)) % blk, np.complex64)]))
            out.append(_replies(mod, script))
        assert out[0] == out[1]
        assert out[1][0]["packets"] == 1 and out[1][0]["bad_frames"] == 0
        assert out[1][1]["packets"] == [pkts[0].hex()]
    finally:
        jax_app.shutdown()
        port_app.shutdown()


def test_app_meteor_module(tmp_path):
    """The Meteor demodulator at 300 kS/s (its RxVFO to 150 kS/s) on both
    apps: the status, a recording (the int8 soft symbols within one step
    of the JAX app's, past the first 500 symbols: the loops' transient)
    and the settings commands).  The int8 values past the first 500
    symbols are within one step of the JAX app's but for at most 1 % of
    them (the symbols a polyphase step of the clock moves)."""
    fs = 300_000.0
    rng = np.random.default_rng(12)
    sym = SMOKE.meteor_symbols("qpsk", 7300, rng)
    iq = _noisy(SMOKE.meteor_signal("qpsk", fs, sym)[:30_000], 13, 0.01)
    config = {"source": {"type": "none", "samplerate": fs},
              "fftSize": 4096,
              "modules": {"Met": {"type": "meteor_demodulator"}}}
    jax_app, port_app = _apps(tmp_path, config)
    try:
        recs, out = [], []
        for app in (jax_app, port_app):
            mod = app.modules["Met"]
            path = mod.handle_debug_command("start_record", "")["path"]
            _feed(mod, iq, pad_blocks=0)
            stop = mod.handle_debug_command("stop_record", "")
            with open(path, "rb") as f:
                recs.append(np.frombuffer(f.read(), np.int8))
            st = mod.handle_debug_command("get_status", "")
            amp = st.pop("constellation_amp")
            out.append((stop, st, _replies(mod, [
                ("set_symbolrate", "1"), ("set_symbolrate", "80000"),
                ("set_broken", "on"), ("set_oqpsk", "0"),
                ("set_offset", "x"), ("get_status", "")])))
            assert amp > 0.1
        assert out[0] == out[1]
        assert len(recs[0]) == len(recs[1]) > 10_000
        d = np.abs(recs[0][1000:].astype(int) - recs[1][1000:])
        assert np.mean(d > 1) <= 0.01, np.mean(d > 1)
    finally:
        jax_app.shutdown()
        port_app.shutdown()
