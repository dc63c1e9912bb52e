"""The wideband decoders on the card: ``PMDemod`` (HRPT: K12c, K13's PLL
form, K8, K13m's real form), ``FalconDemod`` (K8, K13m) and
``ATVFrontEnd`` (K12c) on CUDA tensors against the same blocks on the
host CPU (the plain versions), and the five module types on a CUDA app
against a CPU app, with no plain version on the card
(``chip_smoke.no_plain_on_card``).  These need an NVIDIA GPU and skip
without one; on the GPU machine, which has no JAX, run

    python -m pytest --noconftest -m cuda -q tests/test_torch_wideband_cuda.py

Tolerances: the card's transcendentals (atan2f, cosf, sinf) differ from
the host CPU's by ulps, which the locked loops keep at rounding level and
a chain of loops carries through its acquisition: a stage's output >= 80
dB (the front end), a chain's (PMDemod's PLL, de-rotation, RRC and clock
recovery from cold) >= 60 dB, chip_smoke.py phase 29's bar for the
Meteor chain on the card against the host CPU; the valid masks equal; the hard symbols equal but
for at most 0.1 % (a symbol a step of the clock's polyphase index moves
across zero); the modules' replies equal, but the rounded floats of
VOR's bearing (0.02 deg) and quality (0.2 %) and of ATV's servo (1e-3)
and pixels (one step).
"""

import json
import os

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch.app import SDRApp
from sdrplusplusbrown_tpu_torch.models import atv, falcon9, hrpt, vor
from sdrplusplusbrown_tpu_torch.ops.digital import valid_hard_bits
from sdrplusplusbrown_tpu_torch.runtime.block import to_device
from sdrplusplusbrown_tpu_torch.runtime.pump import Rechunker

from torch_parity import _chip_smoke, snr_db

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _blocks(block, x: np.ndarray, dev, n: int):
    """``block`` over ``x`` in blocks of ``n`` on ``dev``: each output's
    pieces joined, as host arrays."""
    st, outs = to_device(block.init_state(()), dev), []
    for i in range(0, len(x), n):
        y, st = block.apply(None, st, torch.from_numpy(x[i:i + n]).to(dev))
        outs.append(y)
    return outs


def test_pm_demod_on_card(gpu):
    rng = np.random.default_rng(1)
    iq = hrpt.pm_modulate(hrpt.manchester_encode(rng.integers(0, 2, 6000)))
    k = np.arange(len(iq))
    iq = (iq * np.exp(1j * (2 * np.pi * 150.0 * k / 3e6 + 0.4))
          + 0.02 * (rng.standard_normal(len(iq))
                    + 1j * rng.standard_normal(len(iq)))
          ).astype(np.complex64)[:24_000]
    dem = hrpt.PMDemod()
    smoke = _chip_smoke()
    with smoke.no_plain_on_card():
        card = _blocks(dem, iq, gpu, 12_000)
    host = _blocks(dem, iq, torch.device("cpu"), 12_000)
    for (cs, cv), (hs, hv) in zip(card, host):
        np.testing.assert_array_equal(cv.cpu().numpy(), hv.numpy())
        assert snr_db(hs[hv].numpy(), cs[cv].cpu().numpy()) >= 60.0
    a = np.concatenate([valid_hard_bits(s, v) for s, v in card])
    b = np.concatenate([valid_hard_bits(s, v) for s, v in host])
    assert len(a) == len(b) > 10_000 and np.mean(a != b) <= 1e-3


def test_falcon_demod_on_card(gpu):
    """tests/test_falcon9.py's frame: the packet exact from the card's
    bits, which equal the host CPU's (but for at most 0.1 %)."""
    rng = np.random.default_rng(0)
    pkts = [falcon9.make_packet(b"\x00" * 8 + b"telemetry hello world")]
    wire = falcon9.falcon_rs_encode(
        falcon9.build_frame_payload(1, b"".join(pkts), 0))
    iq = falcon9.falcon_signal(falcon9.frame_bits(wire, rng), 0.05, 0.2,
                               rng)
    dem = falcon9.FalconDemod()
    with _chip_smoke().no_plain_on_card():
        card = _blocks(dem, iq, gpu, 14_000)
    host = _blocks(dem, iq, torch.device("cpu"), 14_000)
    a = np.concatenate([valid_hard_bits(s, v) for s, v in card])
    b = np.concatenate([valid_hard_bits(s, v) for s, v in host])
    assert len(a) == len(b) > 16_000 and np.mean(a != b) <= 1e-3
    df, ps = falcon9.FalconDeframer(), falcon9.FalconPacketSync()
    df.push_bits(a)
    assert len(df.frames) == 1
    ps.push_frame(falcon9.falcon_rs_decode(df.frames[0]))
    assert ps.packets == pkts


def test_atv_front_end_on_card(gpu):
    sig = atv.video_signal(np.full(atv.VISIBLE_W, 0.5, np.float32),
                           n_normal=20, reps=1)
    iq = ((0.8 - 0.45 * sig) * np.exp(1j * 0.3)).astype(np.complex64)
    fe = atv.ATVFrontEnd()
    with _chip_smoke().no_plain_on_card():
        card = _blocks(fe, iq, gpu, 20_000)
    host = _blocks(fe, iq, torch.device("cpu"), 20_000)
    for c, h in zip(card, host):
        assert c.dtype == torch.float32 and c.is_cuda
        assert snr_db(h.numpy(), c.cpu().numpy()) >= 80.0


def _app(root, sr, modules, device):
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"source": {"type": "none", "samplerate": sr},
                   "fftSize": 4096, "modules": modules}, f)
    return SDRApp(str(root), run_pump=False, device=device)


@pytest.mark.parametrize("mtype", ["vor_receiver", "weather_sat_decoder",
                                   "atv_decoder", "falcon9_decoder"])
def test_module_on_card_answers_as_on_cpu(gpu, tmp_path, mtype):
    """Each module type on a CUDA app and on a CPU app, fed the same small
    blocks (the weather-satellite module through a rechunker of 6 000
    samples, as tests/test_torch_wideband_modules.py does): the same
    replies (the module docstring's tolerances)."""
    rng = np.random.default_rng(4)
    if mtype == "vor_receiver":
        sr, x = vor.VOR_IN_SR, vor.synthesize_vor(1.0, 3.0, noise=0.05)
        script = [("get_bearing", "")]
    elif mtype == "weather_sat_decoder":
        sr = hrpt.HRPT_VFO_SR
        x = hrpt.pm_modulate(hrpt.manchester_encode(
            rng.integers(0, 2, 3000)))[:12_000]
        script = [("status", "")]
    elif mtype == "atv_decoder":
        sr = 500_000.0
        x = ((0.8 - 0.45 * atv.video_signal(
            np.full(atv.VISIBLE_W, 0.8, np.float32), n_normal=14,
            reps=1)[:40_000]) * np.exp(1j * 0.1)).astype(np.complex64)
        script = [("status", ""), ("get_row", "100")]
    else:
        sr = 300_000.0
        wire = falcon9.falcon_rs_encode(falcon9.build_frame_payload(
            1, falcon9.make_packet(b"card"), 0))
        x = falcon9.falcon_signal(falcon9.frame_bits(wire, rng))
        script = [("status", ""), ("get_packets", "")]
    out = []
    for dev in (gpu, "cpu"):
        app = _app(tmp_path / str(dev), sr, {"M": {"type": mtype}}, dev)
        try:
            mod = app.modules["M"]
            if mtype == "weather_sat_decoder":
                mod.rc = Rechunker(6000)
            blk = mod.rc.out_len
            feed = np.concatenate([x, np.zeros((-len(x)) % blk,
                                               np.complex64)])
            if dev == gpu:
                with _chip_smoke().no_plain_on_card():
                    mod._on_baseband(feed)
            else:
                mod._on_baseband(feed)
            out.append([mod.handle_debug_command(c, a) for c, a in script])
        finally:
            app.shutdown()
    card, host = out
    if mtype == "vor_receiver":
        (c,), (h,) = card, host
        assert c["windows"] == h["windows"] == 3
        assert abs(c["bearing"] - h["bearing"]) <= 0.02
        assert abs(c["quality"] - h["quality"]) <= 0.2
    elif mtype == "atv_decoder":
        (c, cr), (h, hr) = card, host
        for k in ("h_locked", "h_lock", "v_locked", "v_lock", "lines",
                  "frames"):
            assert c[k] == h[k], k
        assert abs(c["gain"] - h["gain"]) <= 1e-3
        assert abs(c["offset"] - h["offset"]) <= 1e-3
        assert np.abs(np.subtract(cr["pixels"], hr["pixels"])).max() <= 1
    else:
        assert card == host
