"""The port's entry point over HTTP on the CPU: ``python -m
sdrplusplusbrown_tpu_torch --device cpu`` spawned with a temp config root
and a file source, driven over its control plane as tests/test_e2e_http.py
drives the JAX package's.  The manual pump (``/pump/step``) makes progress
a count of blocks, not of seconds; one app runs the threaded pump.

Mirrored from tests/test_e2e_http.py: the status shape, list_demods,
get/set demod and bandwidth, the VFO offset and the SNR oracle (> 20 dB on
the carrier, < 20 dB off it), get_spectrum, modules/streams/sinks,
/sdr/status progress, two radios at once, and a recording through the
sink select.  The noise path is served: the audio NR (logmmse, omlsa),
the noise blanker and the FM IF filter are accepted over the control
plane and the radio still steps, and so is the IF NR from the config
(``ifnr``) and through the ``ifnr/enabled`` proc entry.  RDS
(``set_rds``, ``get_rds``, ``rds`` in the config) and the RAW demod are
served.  The entry point's ``--server`` streams the capture to a client
that completes the handshake, and ``--rigctl`` answers ``f``; each exits
0.  The network sink streams the radio's audio to a local listener; a
config with a loopback transmitter, or an rtl_tcp, SpyServer, network,
KiwiSDR or Hermes Lite 2 source (each against a fake peer), builds.  And
the refusals: the module types the port lacks answer "not ported yet",
and without a CUDA device the entry point exits nonzero naming CUDA
unless it is given ``--device cpu``."""

import glob
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error

import numpy as np
import pytest

from e2e_harness import free_port, http_get, http_post
from torch_parity import _chip_smoke, wait_for
from sdrplusplusbrown_tpu_torch.app import SDRApp
from sdrplusplusbrown_tpu_torch.io.wav import write_wav
from sdrplusplusbrown_tpu_torch.server.rigctl_client import RigctlClient
from sdrplusplusbrown_tpu_torch.server.stream_client import StreamClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_capture(tmp_path, fs=240_000.0, seconds=2.0):
    """NFM carrier at +50 kHz with a 1 kHz tone in light noise (the
    capture of tests/test_e2e_http.py)."""
    rng = np.random.default_rng(9)
    T = int(fs * seconds)
    n = np.arange(T)
    audio = 0.8 * np.sin(2 * np.pi * 1000 * n / fs)
    phase = 2 * np.pi * np.cumsum(2500 * audio) / fs
    x = (0.6 * np.exp(1j * (2 * np.pi * 50e3 * n / fs + phase))
         + 0.01 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
         ).astype(np.complex64)
    p = str(tmp_path / "baseband_14000000Hz_10-00-00_01-01-2024.wav")
    write_wav(p, x, fs, bits=32)
    return p


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env.update(extra)
    return env


class TorchAppContext:
    """The port's headless app in a subprocess (the counterpart of
    tests/e2e_harness.py:AppContext): a config.json under ``root``,
    ``--http`` on a free port, ``--device cpu``."""

    def __init__(self, root: str, config: dict, autostart: bool = True,
                 extra=()):
        self.root = root
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump(config, f)
        self.port = free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        args = [sys.executable, "-m", "sdrplusplusbrown_tpu_torch",
                "--root", root, "--http", str(self.port), "--device", "cpu"]
        if autostart:
            args.append("--autostart")
        args += list(extra)
        self.log_path = os.path.join(root, "app.log")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(args, stdout=self._log,
                                     stderr=subprocess.STDOUT, env=_env(),
                                     cwd=REPO)

    def wait_ready(self, timeout: float = 60.0) -> bool:
        t0 = time.time()
        while time.time() - t0 < timeout:
            if self.proc.poll() is not None:
                return False
            try:
                if self.get("/status", timeout=0.5).get("mainLoopStarted"):
                    return True
            except OSError:
                pass
            time.sleep(0.2)
        return False

    def get(self, path: str, timeout: float = 10.0) -> dict:
        return http_get(self.base, path, timeout=timeout)

    def post(self, path: str, obj: dict, timeout: float = 10.0) -> dict:
        return http_post(self.base, path, obj, timeout=timeout)

    def module_cmd(self, inst: str, cmd: str, args: str = "") -> dict:
        return self.post(f"/module/{inst}/command",
                         {"cmd": cmd, "args": args}, timeout=60.0)

    def pump_step(self, blocks: int) -> dict:
        return self.post("/pump/step", {"blocks": blocks}, timeout=300.0)

    def close(self) -> int:
        """/exit, then the process's exit code."""
        try:
            self.get("/exit", timeout=5)
        except OSError:
            pass
        try:
            rc = self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait(timeout=5)
        self._log.close()
        return rc

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()


def config_for(cap: str, pump: str) -> dict:
    return {"source": {"type": "file", "path": cap, "loop": True},
            "fftSize": 4096, "fftRate": 20, "pump": pump,
            "modules": {
                "Radio": {"type": "radio", "demod": "NFM", "offset": 50e3},
                "Radio2": {"type": "radio", "demod": "NFM",
                           "offset": -80e3}}}


@pytest.fixture(scope="module")
def app(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_e2e")
    ctx = TorchAppContext(str(tmp / "root"),
                          config_for(make_capture(tmp), "manual"))
    ok = ctx.wait_ready(timeout=120)
    assert ok, ctx.log()[-3000:]
    yield ctx
    assert ctx.close() == 0, ctx.log()[-3000:]


def test_status_shape(app):
    st = app.get("/status")
    assert st["ready"] and st["mainLoopStarted"]
    assert set(st) == {"ready", "httpListening", "mainLoopStarted",
                       "rtFactor", "secondsBehind", "ifnrEnabled",
                       "ifnrStopReason"}


def test_list_demods(app):
    r = app.module_cmd("Radio", "list_demods")
    ids = {d["name"]: d["id"] for d in r["demods"]}
    # reference radio_module_interface.h:6-16 enum order
    assert ids == {"NFM": 0, "WFM": 1, "AM": 2, "DSB": 3, "USB": 4,
                   "CW": 5, "LSB": 6, "RAW": 7}


def test_get_set_demod_and_bandwidth(app):
    assert app.module_cmd("Radio", "get_demod")["demod"] == "NFM"
    # reference test_lsb_startup.py: LSB default bandwidth ≈ 2.7-2.8 kHz
    r = app.module_cmd("Radio", "set_demod", "LSB")
    assert r["status"] == "ok" and r["demod"] == "LSB"
    assert app.pump_step(1)["stepped"] == 1        # the LSB chain runs
    bw = app.module_cmd("Radio", "get_vfo_bandwidth")
    assert 2000.0 <= bw["vfo_bandwidth"] <= 3500.0
    assert bw["min_bandwidth"] == 500.0
    r = app.module_cmd("Radio", "set_vfo_bandwidth", "3000")
    assert r == {"status": "ok", "bandwidth": 3000.0}
    assert app.module_cmd("Radio", "get_vfo_bandwidth")[
        "vfo_bandwidth"] == 3000.0
    assert "error" in app.module_cmd("Radio", "set_vfo_bandwidth", "wide")
    r = app.module_cmd("Radio", "set_demod", "0")
    assert r["demod"] == "NFM" and r["id"] == 0
    assert app.module_cmd("Radio", "get_demod") == {"demod": "NFM", "id": 0}
    assert app.pump_step(1)["stepped"] == 1


def _snr_after(app, name, blocks=2):
    app.pump_step(blocks)
    return app.module_cmd(name, "get_snr")["snr"]


def test_vfo_offset_and_snr_oracle(app):
    r = app.get("/vfo/set_offset?name=Radio&offset=50000")
    assert r == {"status": "ok", "vfo": "Radio", "offset_hz": 50000.0}
    snr_on = _snr_after(app, "Radio")
    app.get("/vfo/set_offset?name=Radio&offset=-80000")
    snr_off = _snr_after(app, "Radio")
    app.get("/vfo/set_offset?name=Radio&offset=50000")
    assert snr_on > 20.0 and snr_off < 20.0, (snr_on, snr_off)
    assert "error" in app.get("/vfo/set_offset?name=Nope&offset=1")


def test_get_spectrum(app):
    app.pump_step(1)
    r = app.module_cmd("Radio", "get_spectrum", ",128")
    assert r["num_buckets"] == 128 and len(r["spectrum"]) == 128
    assert max(r["spectrum"]) <= 0.0 + 1e-6
    assert r["fft_size"] == 16384


def test_modules_streams_sinks(app):
    mods = app.get("/modules")
    assert mods == {"Radio": {"module": "radio", "enabled": True},
                    "Radio2": {"module": "radio", "enabled": True}}
    streams = app.get("/streams")
    assert streams["streams"][0]["name"] == "Radio"
    assert app.get("/sinks") == {"sinks": ["network", "null_audio_sink",
                                           "recorder"]}
    r = app.post("/sink/select", {"stream": "Radio",
                                  "sink": "null_audio_sink"})
    assert r["status"] == "ok"
    assert "error" in app.post("/sink/select", {"stream": "Nope",
                                                "sink": "x"})
    r = app.post("/stream/add_substream", {"stream": "Radio"})
    assert r == {"status": "ok", "name": "Radio__##1"}


def test_proc_and_log(app):
    ls = app.get("/ls")
    assert {"path": "source/samplerate", "type": "string",
            "writable": False} in ls["entries"]
    assert app.get("/proc/source/samplerate")["value"] == "240000.0"
    log = app.get("/log")["log"]
    assert "SDRApp started" in log and "device cpu" in log


def test_sdr_status_progress(app):
    b0 = app.get("/sdr/status")["blocks"]
    r = app.pump_step(3)
    assert r["stepped"] == 3 and r["blocks"] == b0 + 3
    st = app.get("/sdr/status")
    assert st["blocks"] == b0 + 3 and st["samplerate"] == 240000.0
    assert st["blockLen"] >= 12_000 and st["running"]


def test_two_radios_simultaneously(app):
    """Two radio instances demodulate one baseband: the on-carrier one
    hears the signal, the other does not."""
    app.pump_step(2)
    snr1 = app.module_cmd("Radio", "get_snr")["snr"]
    snr2 = app.module_cmd("Radio2", "get_snr")["snr"]
    assert snr1 > 20.0 and snr2 < 20.0, (snr1, snr2)
    assert set(app.module_cmd("Radio2", "get_level")) == {"level_db"}


def test_sink_select_records(app):
    r = app.post("/sink/select", {"stream": "Radio", "sink": "recorder"})
    assert r["status"] == "ok"
    r = app.pump_step(4)
    n, block_len = r["stepped"], r["blockLen"]
    r = app.post("/sink/select", {"stream": "Radio",
                                  "sink": "null_audio_sink"})
    assert r["status"] == "ok"
    recs = glob.glob(os.path.join(app.root, "recordings", "sink_Radio_*"))
    assert len(recs) == 1
    # 48 kHz stereo int16: a fifth of the 240 kS/s input samples
    assert os.path.getsize(recs[0]) == 44 + n * (block_len // 5) * 2 * 2


@pytest.mark.parametrize("cmd,args,error", [
    ("set_afnr", "bogus", "unknown afnr mode"),
    ("set_demod", "DMR", "unknown demod"),
    ("set_demod", "99", "unknown demod"),
])
def test_unported_commands_refused(app, cmd, args, error):
    before = app.module_cmd("Radio", "get_demod")
    r = app.module_cmd("Radio", cmd, args)
    assert error in r.get("error", ""), r
    assert app.module_cmd("Radio", "get_demod") == before
    assert app.pump_step(1)["stepped"] == 1        # the radio still runs


@pytest.mark.parametrize("cmd,args,want", [
    ("set_rds", "1", {"status": "ok", "rds": True}),
    ("set_demod", "RAW", {"status": "ok", "demod": "RAW", "id": 7}),
])
def test_rds_and_raw_accepted(app, cmd, args, want):
    """RDS and the RAW demod over the control plane: ``set_rds 1`` (on
    this NFM radio the decoder stays off, as in the JAX app: RDS rides
    WFM only) and ``set_demod RAW``; the radio steps, then goes back."""
    assert app.module_cmd("Radio", cmd, args) == want
    assert app.pump_step(1)["stepped"] == 1
    if cmd == "set_rds":
        assert app.module_cmd("Radio", "get_rds") == {
            "error": "rds not enabled"}
        assert app.module_cmd("Radio", "set_rds", "0") == {
            "status": "ok", "rds": False}
    else:
        assert app.module_cmd("Radio", "get_demod") == {"demod": "RAW",
                                                        "id": 7}
        assert app.module_cmd("Radio", "set_demod", "NFM")["id"] == 0
    assert app.pump_step(1)["stepped"] == 1


@pytest.mark.parametrize("feature", [
    ("set_afnr", "logmmse"), ("set_afnr", "omlsa"), ("set_nb", "on"),
    ("set_fmif", "on"), ("config", "ifnr")])
def test_noise_features_accepted(app, tmp_path, feature):
    """What this slice serves: each is accepted and the radio still
    steps.  The module commands over HTTP (switched off again after), the
    IF NR from a config with ``ifnr: true`` (in process: primed after
    five blocks, its proc entry read and written)."""
    cmd, arg = feature
    if cmd == "config":
        cfg = config_for(make_capture(tmp_path, seconds=0.5), "manual")
        cfg["ifnr"] = True
        with open(tmp_path / "config.json", "w") as f:
            json.dump(cfg, f)
        a = SDRApp(str(tmp_path), run_pump=False, device="cpu")
        a._clock = lambda: 0.0     # a busy host must not shed the IF NR
        got = []
        a.modules["Radio"].audio_event.bind(got.append)
        try:
            a.start()
            assert a.pump_step(6) == 6 and a.ifnr_primed
            assert a.status()["ifnrEnabled"] and got
            assert np.abs(np.concatenate(got, axis=-1)).max() > 0
            a.set_ifnr_enabled(False)
            assert a.pump_step(1) == 1 and not a.status()["ifnrEnabled"]
        finally:
            a.shutdown()
        return
    r = app.module_cmd("Radio", cmd, arg)
    key = cmd[4:]
    assert r == {"status": "ok", key: arg if cmd == "set_afnr" else True}, r
    if cmd == "set_afnr":
        assert app.module_cmd("Radio", "get_afnr") == {"afnr": arg}
    # the AF NR primes on its first 12 frames (0.24 s of audio) and
    # then lags by its remainder: the radio steps throughout
    assert app.pump_step(6)["stepped"] == 6
    assert app.module_cmd("Radio", "get_demod")["demod"] == "NFM"
    assert app.module_cmd("Radio", "get_snr")["snr"] > 20.0
    assert "afnr error" not in app.get("/log")["log"]
    off = app.module_cmd("Radio", cmd, "off")
    assert off["status"] == "ok", off


def test_ifnr_proc_entry(app):
    """``ifnr/enabled`` sets and reads the app's IF NR switch (built on
    first use); ``ifnr/stop_reason`` is empty while it runs, and names
    the cause if the real-time guard shed it (a busy host can be too
    slow for it on the CPU)."""
    assert app.get("/proc/ifnr/enabled")["value"] == "false"
    r = app.get("/proc/ifnr/enabled?value=true")
    assert r["status"] == "ok", r
    try:
        assert app.get("/proc/ifnr/enabled")["value"] == "true"
        assert app.get("/status")["ifnrEnabled"]
        assert app.pump_step(6)["stepped"] == 6
        on = app.get("/status")["ifnrEnabled"]
        assert app.get("/proc/ifnr/enabled")["value"] == str(on).lower()
        assert app.get("/proc/ifnr/stop_reason")["value"] == (
            "" if on else "Slow processing. Reduce sample rate.")
        assert "IF NR primed" in app.get("/log")["log"]
    finally:
        app.get("/proc/ifnr/enabled?value=false")
    assert not app.get("/status")["ifnrEnabled"]


def test_off_switches_and_levels(app):
    for cmd in ("set_afnr", "set_rds", "set_nb", "set_fmif"):
        assert app.module_cmd("Radio", cmd, "off")["status"] == "ok"
    assert app.module_cmd("Radio", "get_afnr") == {"afnr": "off"}
    r = app.module_cmd("Radio", "set_squelch", "-80")
    assert r == {"status": "ok", "level": -80.0}
    assert app.module_cmd("Radio", "set_volume", "0.5")["volume"] == 0.5
    assert app.module_cmd("Radio", "set_volume", "1")["volume"] == 1.0
    # the network sink streams the radio's audio (int16 over UDP)
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(10)
    try:
        r = app.post("/sink/select", {"stream": "Radio", "sink": "network",
                                      "host": "127.0.0.1", "protocol":
                                      "udp", "port": rx.getsockname()[1]})
        assert r == {"status": "ok", "stream": "Radio", "sink": "network"}
        assert app.pump_step(2)["stepped"] == 2
        pcm = np.frombuffer(rx.recv(1 << 16), "<i2")
        assert pcm.shape == (500,) and np.abs(pcm).max() > 1000
    finally:
        app.post("/sink/select", {"stream": "Radio",
                                  "sink": "null_audio_sink"})
        rx.close()


def test_threaded_pump_over_http(tmp_path):
    """The free-running pump thread: blocks flow without /pump/step, the
    status reports the real-time factor, /exit stops the process with
    exit code 0."""
    cfg = config_for(make_capture(tmp_path, seconds=0.5), "thread")
    ctx = TorchAppContext(str(tmp_path / "root"), cfg)
    try:
        assert ctx.wait_ready(timeout=120), ctx.log()[-3000:]
        assert "error" in ctx.pump_step(1)           # not in manual mode
        deadline = time.time() + 60
        blocks = 0
        while time.time() < deadline and blocks < 5:
            blocks = ctx.get("/sdr/status")["blocks"]
            time.sleep(0.2)
        assert blocks >= 5, ctx.log()[-3000:]
        st = ctx.get("/status")
        assert st["rtFactor"] > 0.0 and st["secondsBehind"] >= 0.0
        assert ctx.module_cmd("Radio", "get_snr")["snr"] > 20.0
        # exit with a recorder attached: the recording is closed once
        r = ctx.post("/sink/select", {"stream": "Radio", "sink": "recorder"})
        assert r["status"] == "ok"
    finally:
        rc = ctx.close()
    assert rc == 0, ctx.log()[-3000:]
    rec, = glob.glob(str(tmp_path / "root" / "recordings" / "sink_Radio_*"))
    with open(rec, "rb") as f:
        head = f.read(44)
    assert int.from_bytes(head[40:44], "little") == os.path.getsize(rec) - 44


@pytest.mark.parametrize("server", ["stream", "rigctl"])
def test_servers_serve(tmp_path, server):
    """``--server --port P``: a client completes the handshake (the
    capture's rate) and receives int8 blocks; ``--rigctl Q``: ``f``
    answers the capture's frequency.  /exit, then exit code 0."""
    port = free_port()
    flags = (["--server", "--port", str(port)] if server == "stream"
             else ["--rigctl", str(port)])
    cfg = config_for(make_capture(tmp_path, seconds=0.5), "manual")
    ctx = TorchAppContext(str(tmp_path / "root"), cfg, extra=flags)
    try:
        assert ctx.wait_ready(timeout=120), ctx.log()[-3000:]
        if server == "stream":
            cli = StreamClient("127.0.0.1", port, compression="int8")
            try:
                assert cli.samplerate == 240_000.0
                got = []
                for blk in cli.blocks(timeout=10):
                    got.append(blk)
                    if len(got) == 3:
                        break
            finally:
                cli.close()
            assert [b.shape for b in got] == [(1200,)] * 3, ctx.log()[-3000:]
            assert all(np.abs(b).max() > 0.1 for b in got)
        else:
            cli = RigctlClient("127.0.0.1", port)
            try:
                assert cli.get_frequency() == 14_000_000.0
            finally:
                cli.close()
    finally:
        rc = ctx.close()
    assert rc == 0, ctx.log()[-3000:]


def test_no_cuda_device_exits_naming_cuda(tmp_path):
    """Without a card and without --device cpu the app does not fall back
    to the host: it exits nonzero and says why."""
    res = subprocess.run(
        [sys.executable, "-m", "sdrplusplusbrown_tpu_torch", "--root",
         str(tmp_path), "--http", str(free_port())], cwd=REPO,
        env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0 and "CUDA" in res.stderr, res
    assert not os.path.exists(tmp_path / "config.json")


@pytest.mark.parametrize("conf,what", [
    ({"modules": {"S": {"type": "signal_detector"}}}, "signal_detector"),
    ({"modules": {"F": {"type": "ft8_decoder"}}}, "ft8_decoder"),
])
def test_unported_config_refused(tmp_path, conf, what):
    with open(tmp_path / "config.json", "w") as f:
        json.dump(conf, f)
    with pytest.raises(NotImplementedError, match=what):
        SDRApp(str(tmp_path), run_pump=False, device="cpu").shutdown()


def _spyserver_peer(conn):
    """Enough of a SpyServer for the client's constructor: the hello
    read, the device info sent, the seven settings of ``start_stream``
    read, then closed (so that the client's reader ends at once)."""
    from sdrplusplusbrown_tpu_torch.io import spyserver_source as spy
    conn.recv(4096)
    di = struct.pack("<12I", 3, 1, 2_000_000, 1_600_000, 4, 1, 29,
                     24_000_000, 1_700_000_000, 8, 1, 0)
    conn.sendall(struct.pack("<IIIII", spy.PROTOCOL_VERSION,
                             spy.MSG_DEVICE_INFO, 0, 0, len(di)) + di)
    _read(conn, 7 * 16)


def _rtl_tcp_peer(conn):
    """The banner, then the two commands the app sends (the rate and its
    frequency), then closed."""
    conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
    _read(conn, 2 * 5)


def _read(conn, n: int):
    """``n`` bytes from ``conn`` (fewer if it closes)."""
    got = 0
    while got < n:
        part = conn.recv(n - got)
        if not part:
            return
        got += len(part)


def _kiwi_peer(conn):
    while b"\r\n\r\n" not in conn.recv(4096):
        pass
    conn.sendall(b"HTTP/1.1 101 Switching Protocols\r\n\r\n")
    conn.recv(4096)


class OnePeer:
    """A TCP peer on 127.0.0.1:0 serving one connection with ``serve``."""

    def __init__(self, serve):
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(1)
        self.srv.settimeout(10)
        self.port = self.srv.getsockname()[1]

        def run():
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            conn.settimeout(10)
            with conn:
                try:
                    serve(conn)
                except OSError:
                    pass
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def close(self):
        self.srv.close()
        self.thread.join(timeout=15)


@pytest.mark.parametrize("what", ["transmitter", "rtl_tcp", "spyserver",
                                  "network", "kiwisdr", "hl2"])
def test_config_builds(tmp_path, what):
    """What the port refused before builds from a config the JAX app
    accepts, against a fake peer (or as a loopback): the source and its
    rate, and the transmitter (the HL2 source is its own), then shuts
    down cleanly."""
    peer, conf = None, {}
    if what == "transmitter":
        conf = {"transmitter": {"type": "loopback"}}
    elif what == "network":
        conf = {"source": {"type": "network", "host": "127.0.0.1",
                           "port": 0, "protocol": "udp",
                           "sampleType": "int8", "samplerate": 96_000.0}}
    elif what == "hl2":
        peer = _chip_smoke().FakeHL2(np.zeros(126, np.complex64), 48_000)
        conf = {"source": {"type": "hl2", "host": "127.0.0.1",
                           "port": peer.port, "samplerate": 48_000}}
    else:
        peer = OnePeer({"rtl_tcp": _rtl_tcp_peer, "spyserver":
                        _spyserver_peer, "kiwisdr": _kiwi_peer}[what])
        conf = {"source": {"type": what, "host": "127.0.0.1",
                           "port": peer.port}}
    with open(tmp_path / "config.json", "w") as f:
        json.dump(conf, f)
    try:
        app = SDRApp(str(tmp_path), run_pump=False, device="cpu")
        try:
            # the source's rate, or the config's default (1 MS/s)
            rate = {"transmitter": 1_000_000.0, "rtl_tcp": 1_000_000.0,
                    "spyserver": 1_000_000.0, "network": 96_000.0,
                    "kiwisdr": 12_000.0, "hl2": 48_000.0}[what]
            assert app.samplerate == rate
            if what == "transmitter":
                assert app.source is None
                assert type(app.transmitter).__name__ == \
                    "LoopbackTransmitter"
            elif what == "hl2":
                assert app.transmitter is app.source
                wait_for(lambda: peer.started.is_set(), "no Metis start")
            else:
                assert app.transmitter is None
                assert type(app.source).__module__.startswith(
                    "sdrplusplusbrown_tpu_torch.io.")
        finally:
            app.shutdown()
    finally:
        if peer is not None:
            peer.close()


@pytest.mark.parametrize("demod,decoder", [("WFM", True), ("NFM", False)])
def test_rds_config_accepted(tmp_path, demod, decoder):
    """``rds: true`` on a radio in the config builds the RDS demod and
    decoder on a WFM radio (and nothing on another demod, as the JAX
    app); get_rds answers from the decoder."""
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"source": {"type": "none", "samplerate": 1_000_000.0},
                   "modules": {"R": {"type": "radio", "demod": demod,
                                     "rds": True}}}, f)
    app = SDRApp(str(tmp_path), run_pump=False, device="cpu")
    try:
        m = app.modules["R"]
        assert m.rds_enabled and (m.rds_decoder is not None) == decoder
        assert getattr(m.radio.demod, "rds_out", False) == decoder
        r = m.handle_debug_command("get_rds", "")
        if decoder:
            assert r == {"synced": False, "pi": None, "pty": None,
                         "ps": " " * 8, "radiotext": "", "groups": 0}
        else:
            assert r == {"error": "rds not enabled"}
    finally:
        app.shutdown()


def test_unknown_module_type_warns(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"modules": {"X": {"type": "no_such_module"}}}, f)
    app = SDRApp(str(tmp_path), run_pump=False, device="cpu")
    try:
        assert app.modules == {} and app.source is None
        assert app.status()["mainLoopStarted"]
    finally:
        app.shutdown()


def test_refused_switch_leaves_radio_untouched(tmp_path):
    """A demod the port cannot build leaves the radio object, its state
    and its settings as they were; a good switch migrates the state."""
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"source": {"type": "none", "samplerate": 240_000.0},
                   "modules": {"R": {"type": "radio", "demod": "NFM",
                                     "offset": 5e3}}}, f)
    app = SDRApp(str(tmp_path), run_pump=False, device="cpu")
    try:
        m = app.modules["R"]
        r0, s0 = m.radio, m.state
        for args in ("DMR", "99"):
            assert "error" in m.handle_debug_command("set_demod", args)
            assert m.radio is r0 and m.state is s0
            assert (m.demod_id, m.bandwidth) == (0, 12_500.0)
        r = m.handle_debug_command("set_demod", "USB")
        assert r == {"status": "ok", "demod": "USB", "id": 4}
        assert m.radio is not r0 and m.bandwidth == 2_800.0
        assert m.state["vfo"].keys() == s0["vfo"].keys()
        r = m.handle_debug_command("set_demod", "RAW")
        assert r == {"status": "ok", "demod": "RAW", "id": 7}
        assert m.bandwidth == 48_000.0 and m.state["demod"] is None
    finally:
        app.shutdown()
