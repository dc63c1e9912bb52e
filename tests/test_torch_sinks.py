"""The port's audio sinks against the JAX package's on the CPU: the
network sink's packets (UDP and TCP, mono mixdown and stereo interleave,
the packer's carried remainder) and the MPEG sink's Layer I frames (the
encoder, the frame parser, the synthesis bank and the TCP stream) byte
for byte from the same writes; and the app's ``select_sink`` for both,
whose streams carry the radio's audio exactly as the app hands it to
its sinks.  Every socket binds port 0 and has a timeout."""

import json
import socket
import threading

import numpy as np
import pytest

from sdrplusplusbrown_tpu.io import mpeg_sink as jmpeg
from sdrplusplusbrown_tpu.io import network_sink as jnet
from sdrplusplusbrown_tpu_torch.app import SDRApp
from sdrplusplusbrown_tpu_torch.io import mpeg_sink as pmpeg
from sdrplusplusbrown_tpu_torch.io import network_sink as pnet
from torch_parity import net_capture, net_config

PKGS = {"jax": (jnet, jmpeg), "port": (pnet, pmpeg)}


def _writes(seed: int, stereo_in: bool):
    """Blocks of audio of uneven lengths, over full scale now and then
    (the sinks clip)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (450, 130, 1, 777, 384, 1000):
        shape = (2, n) if stereo_in else (n,)
        out.append((0.6 * rng.standard_normal(shape)).astype(np.float32))
    return out


class TcpSink:
    """A TCP listener on 127.0.0.1:0 that keeps every byte of its one
    connection until it closes."""

    def __init__(self):
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(1)
        self.srv.settimeout(10)
        self.port = self.srv.getsockname()[1]
        self.data = bytearray()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            conn, _ = self.srv.accept()
        except OSError:
            return
        conn.settimeout(10)
        with conn:
            while True:
                try:
                    b = conn.recv(65536)
                except OSError:
                    return
                if not b:
                    return
                self.data.extend(b)

    def result(self) -> bytes:
        self.thread.join(timeout=10)
        self.srv.close()
        return bytes(self.data)


@pytest.mark.parametrize("stereo_out", [False, True])
@pytest.mark.parametrize("stereo_in", [False, True])
def test_network_sink_udp_packets(stereo_in, stereo_out):
    """Each package's sink to a listener of its own: the same datagrams,
    one by one."""
    got = {}
    for name, (net, _) in PKGS.items():
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(2.0)
        sink = net.NetworkSink("127.0.0.1", rx.getsockname()[1], "udp",
                               stereo=stereo_out, packer_block=300)
        try:
            for blk in _writes(1, stereo_in):
                sink.write(blk)
            pkts = []
            while sum(map(len, pkts)) < 2 * sink.samples_sent * (
                    2 if stereo_out else 1):
                pkts.append(rx.recv(1 << 16))
            got[name] = (pkts, sink.samples_sent)
        finally:
            sink.close()
            rx.close()
    assert got["port"] == got["jax"]
    assert got["port"][1] == 2700


def test_network_sink_tcp_stream():
    got = {}
    for name, (net, _) in PKGS.items():
        peer = TcpSink()
        sink = net.NetworkSink("127.0.0.1", peer.port, "tcp", stereo=True)
        for blk in _writes(2, True):
            sink.write(blk)
        sink.close()
        got[name] = peer.result()
    assert got["port"] == got["jax"] and len(got["port"]) == 2 * 2 * 2500


def test_mpeg_codec():
    """The encoder's frames from the same audio, the parser's header and
    subband samples, and the synthesis bank's output: equal."""
    rng = np.random.default_rng(3)
    x = (0.5 * np.sin(2 * np.pi * 1000.0 * np.arange(384 * 9) / 48000)
         + 0.05 * rng.standard_normal(384 * 9)).astype(np.float32)
    enc = {k: m.MpegL1Encoder(48000, 288) for k, (_, m) in PKGS.items()}
    data = {k: e.encode(x[:1000]) + e.encode(x[1000:]) for k, e in
            enc.items()}
    assert data["port"] == data["jax"]
    fb = enc["port"].frame_bytes
    assert len(data["port"]) == 9 * fb
    syn = {k: m._Synthesis() for k, (_, m) in PKGS.items()}
    for f in range(9):
        frame = data["port"][f * fb:(f + 1) * fb]
        (hj, sj), (hp, sp) = (m.mpeg_l1_decode_frame(frame, fb)
                              for _, m in PKGS.values())
        assert hp == hj
        np.testing.assert_array_equal(sp, sj)
        np.testing.assert_array_equal(syn["port"].push(sp),
                                      syn["jax"].push(sj))


def test_mpeg_sink_tcp_stream():
    got = {}
    for name, (_, mpeg) in PKGS.items():
        peer = TcpSink()
        sink = mpeg.MpegNetworkSink("127.0.0.1", peer.port, 48000, 288)
        for blk in _writes(4, True):
            sink.write(blk)
        sent = sink.bytes_sent
        sink.close()
        got[name] = peer.result()
        assert len(got[name]) == sent
    assert got["port"] == got["jax"] and len(got["port"]) == 7 * 288


def test_app_streams_to_network_and_mpeg_sinks(tmp_path):
    """The app's ``select_sink`` builds both sinks from the config's
    ``network_sink``/``mpeg_sink`` and the request; after four manual
    blocks each listener holds the radio's audio (as its audio event
    carries it) in the sink's encoding, byte for byte."""
    cap = str(tmp_path / "baseband_14000000Hz_10-00-00_01-01-2024.wav")
    net_capture(cap, seconds=0.5)
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(2.0)
    peer = TcpSink()
    conf = net_config({"type": "file", "path": cap, "loop": True})
    conf["modules"]["R2"] = dict(conf["modules"]["Radio"])
    conf["network_sink"] = {"host": "127.0.0.1", "protocol": "udp",
                            "port": rx.getsockname()[1]}
    with open(tmp_path / "config.json", "w") as f:
        json.dump(conf, f)
    app = SDRApp(str(tmp_path), run_pump=False, device="cpu")
    audio = {"Radio": [], "R2": []}
    for k, v in audio.items():
        app.modules[k].audio_event.bind(v.append)
    try:
        assert app.select_sink("Radio", "network")
        assert app.select_sink("R2", "mpeg", host="127.0.0.1",
                               port=peer.port)
        app.start()
        assert app.pump_step(4) == 4
        sent = app.sinks["Radio"].samples_sent
        pkts = []
        while sum(map(len, pkts)) < 2 * sent:
            pkts.append(rx.recv(1 << 16))
        with app.config.acquire(False) as c:
            saved = dict(c["sinks"])
    finally:
        app.shutdown()
        rx.close()
    assert saved == {"Radio": "network", "R2": "mpeg"}
    mono = {k: np.concatenate(v, axis=-1).mean(axis=0)
            for k, v in audio.items()}
    pcm = np.clip(mono["Radio"][:sent] * 32768.0, -32768, 32767)
    assert b"".join(pkts) == pcm.astype("<i2").tobytes()
    assert sent == 9500            # 4 blocks of 50 ms, in 500-sample packets
    mp = peer.result()
    assert mp == jmpeg.MpegL1Encoder(48000, 288).encode(mono["R2"])
    assert len(mp) == 288 * (len(mono["R2"]) // 384) > 0


def test_app_sink_connect_failure(tmp_path):
    """A sink that cannot connect leaves the stream without one and
    answers False, as the JAX app does."""
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"source": {"type": "none", "samplerate": 240_000.0},
                   "modules": {"R": {"type": "radio", "demod": "NFM"}}}, f)
    app = SDRApp(str(tmp_path), run_pump=False, device="cpu")
    try:
        with socket.socket() as s:           # a port with no listener
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        assert not app.select_sink("R", "mpeg", host="127.0.0.1",
                                   port=port)
        assert not app.select_sink("R", "network", host="127.0.0.1",
                                   port=port, protocol="tcp")
        assert "R" not in app.sinks
    finally:
        app.shutdown()
