"""The voice and trunking decoders on the card: the DSD frame sync's
correlation, the CTCSS Goertzel bank and the D-STAR header's Viterbi (K16
at K = 3) on CUDA tensors against the same calls on the host CPU;
``FourFSKDemod`` (K8, K13m's real form) and ``Pi4DQPSKDemod`` (K12c, K8,
K13m's complex form, a granule a call) on the card against the host CPU;
and the ``ch_extravhf_decoder`` and ``ch_tetra_demodulator`` modules on a
CUDA app against a CPU app, with no plain version on the card
(``chip_smoke.no_plain_on_card``).  These need an NVIDIA GPU and skip
without one; on the GPU machine, which has no JAX, run

    python -m pytest --noconftest -m cuda -q tests/test_torch_voice_cuda.py

Tolerances: the sync hits, the headers and the modules' products equal
(the card's discriminator and loops differ from the host's by rounding,
which moves no decision on these signals); the CTCSS powers within 1e-5
relative (one float32 matmul, TF32 off); the demods' dibits equal but for
at most 0.1 % (a symbol a step of the clock's polyphase index moves
across a threshold); the modules' statuses equal but the two rounded
float readings (the CTCSS ratio, the DCS bit error rate).
"""

import json
import os

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch.app import SDRApp
from sdrplusplusbrown_tpu_torch.models import dstar, dsd
from sdrplusplusbrown_tpu_torch.ops import ctcss
from sdrplusplusbrown_tpu_torch.ops.demod_digital import FourFSKDemod, \
    Pi4DQPSKDemod
from sdrplusplusbrown_tpu_torch.runtime.block import to_device

from torch_parity import _chip_smoke

pytestmark = pytest.mark.cuda
SMOKE = _chip_smoke()


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def test_frame_sync_on_card(gpu):
    r = np.random.default_rng(1)
    db = r.integers(0, 4, 5000)
    for k, (name, pat, _) in enumerate(dsd.SYNC_PATTERNS):
        e = 100 + 150 * k
        db[e - len(pat) + 1:e + 1] = np.argsort([3, 2, 0, 1])[
            SMOKE.sync_air(name)]
    a, b = dsd.DSDFrameSync(device=gpu), dsd.DSDFrameSync(device="cpu")
    for lo in range(0, len(db), 777):
        assert a.push(db[lo:lo + 777]) == b.push(db[lo:lo + 777])
    assert a.summary() == b.summary()
    assert a.summary()["totalSyncs"] >= len(dsd.SYNC_PATTERNS)


def test_ctcss_on_card(gpu):
    r = np.random.default_rng(2)
    t = np.arange(32_000) / 16_000.0
    x = (0.15 * np.sin(2 * np.pi * 100.0 * t) + 0.3 * r.standard_normal(
        len(t))).astype(np.float32)
    a = ctcss.CTCSSDetector(16_000.0, device=gpu)
    b = ctcss.CTCSSDetector(16_000.0, device="cpu")
    for lo in range(0, len(x), 1600):
        assert a.push(x[lo:lo + 1600]) == b.push(x[lo:lo + 1600])
        np.testing.assert_allclose(a.powers, b.powers, rtol=1e-5, atol=0)
    assert a.detected == 100.0


def test_dstar_header_on_card(gpu):
    r = np.random.default_rng(3)
    bits = dstar.encode_header(b"\x00\x00\x00", *SMOKE.VO_DSTAR_CALLS)
    with SMOKE.no_plain_on_card():
        for n in (0, 6, 40):
            rx = bits.copy()
            rx[r.choice(660, n, replace=False)] ^= 1
            got = dstar.decode_header(rx, device=gpu)
            assert got == dstar.decode_header(rx, device="cpu")
            assert got["crc_ok"] == (n < 40)


@pytest.mark.parametrize("kind", ["4fsk", "pi4"])
def test_demods_on_card(gpu, kind):
    """The demods on the card in their modules' blocks (a 0.1 s block of
    1 600 samples; a 24-sample granule) against the host CPU's."""
    r = np.random.default_rng(4)
    if kind == "4fsk":
        x = SMOKE.fsk4_iq(r.integers(0, 4, 4800).astype(np.uint8), 16_000.0)
        dem, blk = FourFSKDemod(4_800.0, 16_000.0, 1_944.0), 1600
    else:
        x = SMOKE.pi4_iq(SMOKE.tetra_downlink_bits(r, 1), 36_000.0)
        dem, blk = Pi4DQPSKDemod(18_000.0, 36_000.0), 24
    n = len(x) // blk * blk
    out = {}
    for dev in (gpu, torch.device("cpu")):
        st, got = to_device(dem.init_state(()), dev), []
        ctx = SMOKE.no_plain_on_card() if dev.type == "cuda" else \
            torch.no_grad()
        with ctx:
            for i in range(0, n, blk):
                (_, d, v), st = dem.apply(None, st, torch.from_numpy(
                    x[i:i + blk]).to(dev))
                got.append(d[v].cpu().numpy())
        out[dev.type] = np.concatenate(got)
    a, b = out["cuda"], out["cpu"]
    assert len(a) == len(b)
    assert np.mean(a != b) <= 1e-3


def _app(root, dev, fs, modules):
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"source": {"type": "none", "samplerate": fs},
                   "fftSize": 4096, "modules": modules}, f)
    return SDRApp(root, run_pump=False, device=dev)


@pytest.mark.parametrize("fs,channels", [
    (96_000.0, {"DMR": -30e3, "P25": -10e3, "DSTAR": 15e3,
                "CTCSS": 32e3, "DCS": 45e3}),
    (2_400_000.0, {"TETRA": 700e3})])
def test_voice_modules_on_card(gpu, tmp_path, fs, channels):
    """Phase 31's stations through the module types on a CUDA app and on a
    CPU app: equal statuses (but the rounded float readings), the
    products there."""
    x = SMOKE.voice_capture(None, fs=fs, seconds=1.5 if fs < 1e6 else 0.4,
                            channels=channels)["iq"]
    mods = {n: {"type": "ch_tetra_demodulator" if n == "TETRA" else
                "ch_extravhf_decoder", "offset": o}
            for n, o in channels.items()}
    st = {}
    for dev in (gpu, "cpu"):
        app = _app(str(tmp_path / str(dev)), dev, fs, mods)
        try:
            ctx = SMOKE.no_plain_on_card() if dev != "cpu" else \
                torch.no_grad()
            with ctx:
                for i in range(0, len(x), 120_000):
                    for m in app.modules.values():
                        m._on_baseband(x[i:i + 120_000])
            st[str(dev)] = SMOKE.voice_statuses(app)
        finally:
            app.shutdown()
    a, b = st[str(gpu)], st["cpu"]
    assert {n: SMOKE.voice_summary(s) for n, s in a.items()} == \
        {n: SMOKE.voice_summary(s) for n, s in b.items()}
    if "TETRA" in a:
        c = a["TETRA"]["cell"]
        assert (c["mcc"], c["mnc"], c["colour"]) == SMOKE.VO_TETRA_CELL
        assert bytes.fromhex(a["TETRA"]["last_tm_sdu"]["userData"]) == \
            SMOKE.VO_TETRA_TEXT
    else:
        assert a["CTCSS"]["ctcss"]["tone"] == SMOKE.VO_CTCSS_HZ
        assert a["DCS"]["dcs"]["code"] == f"{SMOKE.VO_DCS_CODE:03o}"
        assert a["DSTAR"]["dstar"]["headerCrcOk"] == 2
        assert a["P25"]["p25"]["lastTSBK"]["opcodeName"] == "IDEN_UP"
        assert a["DMR"]["fullLcDecodes"] == 2
