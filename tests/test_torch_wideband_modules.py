"""The wideband decoders' module types on the port's app (``device="cpu"``)
against the JAX app's, from one config.json each: ``vor_receiver``,
``weather_sat_decoder``, ``atv_decoder``, ``falcon9_decoder`` and
``dab_decoder``, fed the same small blocks through their baseband
handlers or ``process_iq``, then asked the same debug commands.

Tolerances: the replies equal the JAX app's, but DAB's constellation
points, which go through each package's RxVFO (agreeing to rounding)
before the host OFDM front end: each within 2e-4 of the JAX app's (the
replies round to 1e-4).  The weather-satellite module's 0.1 s block is
300 000 samples, whose plain per-sample loops (the AGC, the PLL, the
clock recovery) take about a minute on the CPU: both apps' modules are
given the same rechunker of 6 000 samples instead, and the framer's
products (a whole frame's lines and TIP words) are read after both
framers take the same frame's symbol bits.
"""

import json
import os

import numpy as np
import pytest
from scipy.signal import resample_poly

from sdrplusplusbrown_tpu.app import SDRApp as JaxApp
from sdrplusplusbrown_tpu_torch.app import SDRApp
from sdrplusplusbrown_tpu_torch.models import atv, dab, falcon9, hrpt, vor
from sdrplusplusbrown_tpu_torch.runtime.pump import Rechunker


def _apps(tmp_path, sr: float, modules: dict):
    """The JAX app and the port's app (``device="cpu"``) at ``sr`` with
    ``modules`` from one config.json in two roots."""
    config = {"source": {"type": "none", "samplerate": sr},
              "fftSize": 4096, "modules": modules}
    apps = []
    for name, cls, kw in (("jax", JaxApp, {}), ("port", SDRApp,
                                                {"device": "cpu"})):
        root = tmp_path / name
        os.makedirs(root, exist_ok=True)
        with open(root / "config.json", "w") as f:
            json.dump(config, f)
        apps.append(cls(str(root), run_pump=False, **kw))
    return apps


def _padded(iq: np.ndarray, blk: int) -> np.ndarray:
    return np.concatenate([iq, np.zeros((-len(iq)) % blk, np.complex64)])


def _run(tmp_path, sr, modules, feed, script):
    """Each app's module "M" fed by ``feed(mod)``, then ``script``'s
    replies; [jax replies, port replies]."""
    apps = _apps(tmp_path, sr, modules)
    try:
        out = []
        for app in apps:
            mod = app.modules["M"]
            feed(mod)
            out.append([mod.handle_debug_command(c, a) for c, a in script])
        return out
    finally:
        for app in apps:
            app.shutdown()


def test_vor_module(tmp_path):
    """A VOR at +20 kHz on a 100 kS/s baseband (the module's RxVFO to 25
    kHz), 4 s through the baseband handler: one reply of bearing,
    quality and windows each, as the JAX app's; the bearing on the
    radial."""
    fs, az = 100_000.0, 137.0
    x = vor.synthesize_vor(np.deg2rad(az), 4.0, fs=fs, noise=0.05, seed=3)
    x = (x * np.exp(2j * np.pi * 20e3 * np.arange(len(x)) / fs)
         ).astype(np.complex64)
    script = [("get_bearing", ""), ("set_offset", "x"),
              ("set_offset", "20000"), ("bogus", "")]
    out = _run(tmp_path, fs, {"M": {"type": "vor_receiver",
                                    "offset": 20e3}},
               lambda m: m._on_baseband(x), script)
    assert out[0] == out[1]
    got = out[1][0]
    assert got["windows"] == 4 and got["quality"] > 90.0, got
    assert abs(((got["bearing"] - az + 180.0) % 360.0) - 180.0) < 2.0


def test_weather_sat_module(tmp_path):
    """HRPT's PM channel at 3 MS/s through the baseband handler (two
    6 000-sample blocks), then one frame's Manchester symbols into each
    framer: the status, a line, the TIP words and the RGB221 composite
    as the JAX app's and the sent frame's."""
    rng = np.random.default_rng(31)
    bits = hrpt.manchester_encode(rng.integers(0, 2, 3000))
    iq = hrpt.pm_modulate(bits)[:12_000]
    av = rng.integers(0, 1024, (5, 2048))
    tip = rng.integers(0, 1024, 520)
    frame = hrpt.frames_signal(rng, [hrpt.build_frame(av, tip)],
                               preamble=100)
    rgb = []

    def feed(mod):
        assert mod.rc.out_len == 300_000
        mod.rc = Rechunker(6000)
        mod._on_baseband(iq)
        mod.framer.push_symbols(frame)
        rgb.append(mod.rgb221_line(0))
    script = [("status", ""), ("get_line", "2,0"), ("get_line", "x"),
              ("get_tip", "0"), ("get_tip", "3")]
    out = _run(tmp_path, hrpt.HRPT_VFO_SR,
               {"M": {"type": "weather_sat_decoder"}}, feed, script)
    assert out[0] == out[1]
    assert out[1][0] == {"frames": 1, "lines": 1, "pixels_per_line": 2048}
    want = (av[2].astype(np.float32) * 255.0 / 1024.0).astype(np.uint8)
    assert out[1][1]["pixels"] == want[:64].tolist()
    assert out[1][3]["tip"] == tip[:32].tolist()
    assert rgb[0] == rgb[1] and len(rgb[1]) == 2048


def test_atv_module(tmp_path):
    """Negative-AM PAL at 500 kS/s (no VFO: the 1/25 s block is 20 000
    samples), 43 lines through ``process_iq``: the line sync's and the
    assembler's status and a row as the JAX app's."""
    pattern = np.full(atv.VISIBLE_W, 0.8, np.float32)
    sig = atv.video_signal(pattern, n_normal=14, reps=1)[:40_000]
    iq = ((0.8 - 0.45 * sig) * np.exp(1j * 0.1)).astype(np.complex64)
    script = [("status", ""), ("get_row", "100"), ("get_row", "x")]
    out = _run(tmp_path, 500_000.0, {"M": {"type": "atv_decoder"}},
               lambda m: m.process_iq(_padded(iq, m.rc.out_len)), script)
    assert out[0] == out[1]
    assert out[1][0]["lines"] == 42 and len(out[1][1]["pixels"]) == 64


def test_falcon9_module(tmp_path):
    """One Falcon 9 frame (tests/test_falcon9.py's module signal) through
    ``process_iq`` on a 300 kS/s app (no VFO: the demod takes the samples
    as 6 MS/s ones; the 0.1 s block is 30 000 samples): the frame and its
    packet as the JAX app's and the sent one."""
    rng = np.random.default_rng(32)
    pkts = [falcon9.make_packet(b"\x00" * 8 + b"module")]
    wire = falcon9.falcon_rs_encode(
        falcon9.build_frame_payload(1, b"".join(pkts), 0))
    iq = falcon9.falcon_signal(falcon9.frame_bits(wire, rng))
    script = [("status", ""), ("get_packets", "4"), ("get_packets", "x")]
    out = _run(tmp_path, 300_000.0, {"M": {"type": "falcon9_decoder"}},
               lambda m: m.process_iq(_padded(iq, m.rc.out_len)), script)
    assert out[0] == out[1]
    assert out[1][0] == {"frames_ok": 1, "frames_bad": 0, "packets": 1}
    assert out[1][1]["packets"] == [pkts[0].hex()]


def test_dab_module(tmp_path):
    """Three DAB frames at +100 kHz on a 2.4 MS/s baseband (the module's
    RxVFO to 2.048 MS/s, 64/75), one block through the baseband handler:
    the status and the dibits as the JAX app's, the constellation within
    2e-4."""
    rng = np.random.default_rng(33)
    sig = np.concatenate([dab.build_frame(10, rng)[0] for _ in range(3)])
    x = resample_poly(sig, 75, 64)
    x = (x * np.exp(2j * np.pi * 100e3 * np.arange(len(x)) / 2.4e6)
         ).astype(np.complex64)
    script = [("status", ""), ("get_constellation", ""), ("get_dibits", "")]
    out = _run(tmp_path, 2_400_000.0, {"M": {"type": "dab_decoder",
                                             "offset": 100e3}},
               lambda m: m._on_baseband(_padded(x, m.rc.out_len)), script)
    (js, jc, jd), (ps, pc, pd) = out
    assert ps == js and pd == jd
    assert ps["frames"] >= 2 and len(pd["dibits"]) == 128
    assert len(pc["points"]) == len(jc["points"]) == 256
    np.testing.assert_allclose(pc["points"], jc["points"], atol=2e-4)


@pytest.mark.parametrize("mtype", ["vor_receiver", "weather_sat_decoder",
                                   "atv_decoder", "falcon9_decoder",
                                   "dab_decoder"])
def test_module_types_built(tmp_path, mtype):
    """Each type from the JAX app's config keys on the port's app: its
    module type, and its rechunker's block equal to the JAX module's at
    a source rate that needs its RxVFO."""
    sr = {"vor_receiver": 250_000.0, "weather_sat_decoder": 6e6,
          "atv_decoder": 20e6, "falcon9_decoder": 10e6,
          "dab_decoder": 2.4e6}[mtype]
    conf = {"type": mtype, "offset": 1000.0}
    if mtype == "vor_receiver":
        conf["integration_time"] = 2.0
    apps = _apps(tmp_path, sr, {"M": conf})
    try:
        jm, pm = (a.modules["M"] for a in apps)
        assert pm.module_type() == jm.module_type() == mtype
        assert pm.rc.out_len == jm.rc.out_len
        assert pm.offset_hz == 1000.0
    finally:
        for app in apps:
            app.shutdown()
