"""The app's scanner, frequency manager, recorder and scheduler modules on
the port's app against the JAX app's, on the CPU: both apps are built from
one config.json (a 240 kS/s capture with an NFM carrier at +50 kHz, the
NFM radio "Radio" on it, the four modules, the manual pump) and answer one
script of commands given to each module's ``handle_debug_command``.  The
replies, the saved ``frequencyManager`` config, the radio's offset, demod
and bandwidth after a bookmark is applied and the scheduler's task list
are equal; the recording of the radio's audio is >= 80 dB to the JAX
app's.  Every wait has a deadline (``torch_parity.wait_for``)."""

import json
import os
import re

import numpy as np
import pytest

from sdrplusplusbrown_tpu.app import SDRApp as JaxApp
from sdrplusplusbrown_tpu_torch.app import SDRApp
from sdrplusplusbrown_tpu_torch.io.wav import read_wav_iq

from torch_parity import (net_capture, net_config,  # noqa: F401
                          port_f32_handoff, snr_db, wait_for)

MODULES = {
    "Scan": {"type": "scanner", "vfo": "Radio", "start_freq": -100e3,
             "stop_freq": 100e3, "interval": 10e3, "level": -50.0},
    "FM": {"type": "frequency_manager",
           "bookmarks": {"Carrier": {"frequency": 100_050_000.0,
                                     "mode": "NFM", "bandwidth": 12500.0,
                                     "vfo": "Radio"}}},
    "Rec": {"type": "recorder"},
    "Sched": {"type": "scheduler"},
}
#: (module, command, args): the bookmark list, then the scheduler's tasks
FM_SCRIPT = [
    ("FM", "get_lists", ""), ("FM", "get_current_list", ""),
    ("FM", "get_bookmarks", ""),
    ("FM", "add_bookmark", "Ham|100020000|2700|4|Radio"),
    ("FM", "add_bookmark", "Short"), ("FM", "add_bookmark", "Bad|x"),
    ("FM", "add", json.dumps({"name": "Json", "frequency": 100_010_000.0,
                              "mode": "AM"})),
    ("FM", "add", "{not json"), ("FM", "set_current_list", "Nope"),
    ("FM", "set_current_list", "Default"), ("FM", "remove_bookmark", "Json"),
    ("FM", "remove", "Json"), ("FM", "list", ""),
    ("FM", "apply_bookmark", "Missing"), ("FM", "apply_bookmark", "Ham"),
    ("FM", "get_bookmarks", ""), ("FM", "frobnicate", ""),
    ("Sched", "add", json.dumps({"at": 4_102_444_800.0, "module": "FM",
                                 "cmd": "get_lists"})),
    ("Sched", "add", json.dumps({"at": 4_102_444_801.0, "module": "Rec",
                                 "cmd": "status", "args": 3})),
    ("Sched", "add", "{}"), ("Sched", "list", ""), ("Sched", "remove", "1"),
    ("Sched", "remove", "1"), ("Sched", "remove", "x"),
    ("Sched", "list", ""), ("Scan", "status", ""),
    ("Scan", "configure", "level=oops"), ("Scan", "bogus", ""),
]


def _session(app, root: str) -> dict:
    """The script on one app: the recorder on the radio's audio and three
    blocks; the scanner across ±100 kHz (on the last spectrum) until it
    reports ``receiving``, then stopped; four more blocks and the
    recording stopped; the frequency manager's and the scheduler's
    commands; a scheduled ``set_demod`` that is due at once, until it has
    fired.  Returns the replies (the recording's path checked and
    replaced by its directory), the radio and the saved config."""
    out = {"replies": []}
    app.start()
    r = app.modules["Rec"].handle_debug_command("start", "Radio,audio")
    path = r.pop("path")
    assert r == {"status": "ok"}, r
    assert os.path.dirname(path) == os.path.join(root, "recordings")
    assert re.fullmatch(r"audio_100000000Hz_[-\d_]+\.wav",
                        os.path.basename(path)), path
    out["replies"].append(app.modules["Rec"].handle_debug_command("status",
                                                                  ""))
    assert app.pump_step(3) == 3
    scan = app.modules["Scan"]
    out["replies"].append(scan.handle_debug_command(
        "configure", "interval=10000 level=-50"))
    out["replies"].append(scan.handle_debug_command("start", ""))

    wait_for(lambda: scan.receiving, "the scanner found no signal")
    out["replies"].append(scan.handle_debug_command("stop", ""))
    out["replies"].append(scan.handle_debug_command("status", ""))
    assert app.pump_step(4) == 4
    out["replies"].append(app.modules["Rec"].handle_debug_command("stop",
                                                                  ""))
    for mod, cmd, args in FM_SCRIPT:
        out["replies"].append(app.modules[mod].handle_debug_command(cmd,
                                                                    args))
    out["replies"].append(app.modules["Sched"].handle_debug_command(
        "add", json.dumps({"at": 0.0, "module": "Radio", "cmd": "set_demod",
                           "args": "AM"})))
    radio = app.modules["Radio"]
    # the JAX app sets the demod id, then builds the radio (~0.4 s)
    wait_for(lambda: radio.radio.demod_name == "AM"
             and radio.bandwidth is not None,
             "the scheduled set_demod did not fire")
    wait_for(lambda: len(app.modules["Sched"].tasks) == 1,
             "the fired task stayed listed")
    out["replies"].append(app.modules["Sched"].handle_debug_command("list",
                                                                    ""))
    out["radio"] = (radio.offset_hz, radio.demod_id, radio.bandwidth)
    with app.config.acquire(False) as conf:
        out["saved"] = json.loads(json.dumps(conf.get("frequencyManager")))
    app.shutdown()
    for m in ("Scan", "Sched"):
        t = app.modules[m]._thread
        assert t is None or not t.is_alive(), m
    out["audio"], out["fs"] = read_wav_iq(path)
    return out


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    cap_dir = tmp_path_factory.mktemp("cap")
    cap = str(cap_dir / "baseband_100000000Hz_10-00-00_01-01-2024.wav")
    net_capture(cap)
    out = {}
    for side, cls in (("jax", JaxApp), ("port", SDRApp)):
        root = str(tmp_path_factory.mktemp(side))
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump(net_config({"type": "file", "path": cap,
                                  "loop": True}, **MODULES), f)
        kw = {"device": "cpu"} if side == "port" else {}
        out[side] = _session(cls(root, run_pump=False, **kw), root)
    return out


def test_replies_equal_to_jax(sessions):
    want, got = sessions["jax"]["replies"], sessions["port"]["replies"]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        assert b == a, (i, a, b)
    scan = got[4]
    assert scan["receiving"] and abs(scan["current"] - 50e3) <= 1e3, scan


def test_bookmark_moves_the_radio_and_is_saved(sessions):
    """``apply_bookmark Ham`` (100.02 MHz, USB, 2.7 kHz) moved the radio
    to +20 kHz and switched it to USB; the scheduler then switched it to
    AM at its default 10 kHz; the saved list is the JAX app's."""
    assert sessions["port"]["radio"] == sessions["jax"]["radio"] == (
        20e3, 2, 10000.0)
    saved = sessions["port"]["saved"]
    assert saved == sessions["jax"]["saved"]
    assert sorted(saved["FM"]["lists"]["Default"]) == ["Carrier", "Ham"]


def test_recording_matches_jax(sessions):
    """The recorder's WAV of the NFM radio (seven blocks, stereo) is
    >= 80 dB to the JAX app's and carries the 1 kHz tone."""
    want, got = sessions["jax"]["audio"], sessions["port"]["audio"]
    assert sessions["port"]["fs"] == sessions["jax"]["fs"] == 48_000.0
    assert got.shape == want.shape and got.size > 0
    assert snr_db(want, got) >= 80.0, snr_db(want, got)
    a = got.real[got.size // 2:].astype(np.float64)
    spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
    assert abs(np.argmax(spec) * 48_000.0 / a.size - 1000.0) < 20.0
