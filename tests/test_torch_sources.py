"""The port's sources against the JAX package's on the CPU: the host
codecs byte for byte (the wire conversions, the Hermes Lite 2's RX and TX
frames, ``encode_tx_samples``, its register words and packets, its
telemetry; the WebSocket and KiwiSDR frames), the samples each source
yields against the JAX source's, both fed by one fake peer (a fake
server serves each package a connection of its own; the HL2's fake is
``chip_smoke.FakeHL2``, one a package, with the same stream), the source
manager, and the JAX app against the port's app on one fake rtl_tcp
server (manual pump, the app-parity tolerance of
tests/test_torch_stream.py) and the port's app on it against the same
app fed the quantized samples from a file, bit for bit.

Every socket binds port 0 and has a timeout; every wait has a deadline
(``torch_parity.wait_for``)."""

import json
import os
import re
import socket
import struct
import threading
import time

import numpy as np
import pytest

from sdrplusplusbrown_tpu.app import SDRApp as JaxApp
from sdrplusplusbrown_tpu.io import hl2_source as jhl2
from sdrplusplusbrown_tpu.io import kiwisdr_source as jkiwi
from sdrplusplusbrown_tpu.io import network_source as jnet
from sdrplusplusbrown_tpu.io import source_manager as jsm
from sdrplusplusbrown_tpu.io import spyserver_source as jspy
from sdrplusplusbrown_tpu.server import websocket as jws
from sdrplusplusbrown_tpu_torch.app import SDRApp
from sdrplusplusbrown_tpu_torch.io import hl2_source as phl2
from sdrplusplusbrown_tpu_torch.io import kiwisdr_source as pkiwi
from sdrplusplusbrown_tpu_torch.io import network_source as pnet
from sdrplusplusbrown_tpu_torch.io import source_manager as psm
from sdrplusplusbrown_tpu_torch.io import spyserver_source as pspy
from sdrplusplusbrown_tpu_torch.io.wav import write_wav
from sdrplusplusbrown_tpu_torch.server import websocket as pws
from torch_parity import (NET_FS, _chip_smoke, net_capture, net_config,
                          snr_db, wait_for)

PKGS = {"jax": (jnet, jspy, jkiwi, jhl2, jsm),
        "port": (pnet, pspy, pkiwi, phl2, psm)}
MIN_DB = 80.0                 # tests/test_torch_stream.py's app parity
BLOCKS = 4


def _collect(src, n: int, timeout: float = 10.0) -> np.ndarray:
    """The first ``n`` samples ``src`` yields (fewer if it ends), within
    ``timeout`` seconds."""
    got, total = [], 0
    deadline = time.monotonic() + timeout
    for blk in src.blocks(timeout=timeout):
        got.append(blk)
        total += len(blk)
        if total >= n or time.monotonic() > deadline:
            break
    out = np.concatenate(got) if got else np.zeros(0, np.complex64)
    return out[:n]


class TcpPeer:
    """A TCP server on 127.0.0.1:0 that runs ``handler(conn, i)`` for
    each of its first ``conns`` connections (i: the connection's index),
    each on a thread of its own, with a timeout on the socket."""

    def __init__(self, handler, conns: int = 2):
        self.srv = socket.socket()
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(conns)
        self.srv.settimeout(10)
        self.port = self.srv.getsockname()[1]
        self.threads = []

        def run():
            for i in range(conns):
                try:
                    conn, _ = self.srv.accept()
                except OSError:
                    return
                conn.settimeout(5)
                t = threading.Thread(target=self._serve,
                                     args=(handler, conn, i), daemon=True)
                t.start()
                self.threads.append(t)
        self.acceptor = threading.Thread(target=run, daemon=True)
        self.acceptor.start()

    @staticmethod
    def _serve(handler, conn, i):
        try:
            handler(conn, i)
        except OSError:
            pass
        finally:
            conn.close()

    def close(self):
        self.srv.close()
        self.acceptor.join(timeout=10)
        for t in self.threads:
            t.join(timeout=10)


# ---------------------------------------------------------------------
# the wire conversions

@pytest.mark.parametrize("stype", sorted(jnet.SAMPLE_TYPES))
def test_sample_conversion(stype):
    assert pnet.SAMPLE_TYPES == jnet.SAMPLE_TYPES
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, 8 * 1001 + 4).astype(np.uint8).tobytes()
    dt = jnet.SAMPLE_TYPES[stype][0]
    if dt == np.float32:        # finite float32 words
        raw = rng.standard_normal(2 * 1001 + 1).astype(np.float32).tobytes()
    np.testing.assert_array_equal(pnet._to_complex(raw, stype),
                                  jnet._to_complex(raw, stype))
    np.testing.assert_array_equal(pnet._u8_iq(raw), jnet._u8_iq(raw))


def _pcm(stype, n, seed):
    rng = np.random.default_rng(seed)
    dt, scale = jnet.SAMPLE_TYPES[stype]
    if dt == np.float32:
        return (0.3 * rng.standard_normal(2 * n)).astype(np.float32)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, 2 * n, dtype=np.int64
                        ).astype(dt)


@pytest.mark.parametrize("stype", sorted(jnet.SAMPLE_TYPES))
def test_network_source_tcp(stype):
    """One server, a connection a package, the same bytes, then a clean
    close (the partial last frame flushed): the same samples."""
    fs = 51_200.0
    pcm = _pcm(stype, 3 * 256 + 100, 2).tobytes()
    peer = TcpPeer(lambda conn, i: (conn.sendall(pcm), time.sleep(0.2)))
    got = {}
    try:
        for name, (net, *_) in PKGS.items():
            src = net.NetworkSource("127.0.0.1", peer.port, "tcp", stype, fs)
            try:
                got[name] = _collect(src, 10 ** 6, timeout=5.0)
            finally:
                src.close()
    finally:
        peer.close()
    assert len(got["port"]) == 3 * 256 + 100
    np.testing.assert_array_equal(got["port"], got["jax"])


@pytest.mark.parametrize("stype", sorted(jnet.SAMPLE_TYPES))
def test_network_source_udp(stype):
    """The same datagrams to a source of each package: the same blocks."""
    srcs = {name: net.NetworkSource("127.0.0.1", 0, "udp", stype, 48_000.0)
            for name, (net, *_) in PKGS.items()}
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    pcm = _pcm(stype, 1000, 3).tobytes()
    try:
        for i in range(0, len(pcm), 800):
            for s in srcs.values():
                tx.sendto(pcm[i:i + 800], ("127.0.0.1",
                                           s.sock.getsockname()[1]))
        got = {k: _collect(s, 1000, timeout=5.0) for k, s in srcs.items()}
    finally:
        tx.close()
        for s in srcs.values():
            s.close()
    assert len(got["port"]) == 1000
    np.testing.assert_array_equal(got["port"], got["jax"])


# ---------------------------------------------------------------------
# rtl_tcp

def test_rtl_tcp_source():
    """``chip_smoke.FakeRtlTcp``, a connection a package: the banner, the
    samples, and every command's 5 bytes, in order."""
    cs = _chip_smoke()
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, 2 * 5000).astype(np.uint8)
    fake = cs.FakeRtlTcp(u8, 256_000.0, limit=12_800)
    got, srcs = {}, []
    try:
        for name, (net, *_) in PKGS.items():
            src = net.RtlTcpSource("127.0.0.1", fake.port, 256_000.0)
            srcs.append(src)
            src.tune(100_000_000)
            src.set_gain_mode(True)
            src.set_gain_index(7)
            src.set_ppm(3)
            src.set_agc_mode(False)
            src.set_direct_sampling(2)
            src.set_offset_tuning(True)
            src.set_bias_tee(True)
            got[name] = _collect(src, 12_800)    # ten of its blocks
            assert (src.tuner_type, src.tuner_gain_count) == (5, 29)
        wait_for(lambda: len(fake.commands) == 2 and all(
            len(c) == 9 for c in fake.commands), "commands not logged")
    finally:
        fake.close()              # first: its EOF ends each source's read
        for s in srcs:
            s.close()
    C = pnet.RtlTcpSource
    assert fake.commands[0] == fake.commands[1] == [
        (C.CMD_SAMPLERATE, 256_000), (C.CMD_FREQ, 100_000_000),
        (C.CMD_GAIN_MODE, 1), (C.CMD_GAIN_INDEX, 7), (C.CMD_PPM, 3),
        (C.CMD_AGC_MODE, 0), (C.CMD_DIRECT_SAMPLING, 2),
        (C.CMD_OFFSET_TUNING, 1), (C.CMD_BIAS_TEE, 1)]
    assert len(got["port"]) == 12_800
    np.testing.assert_array_equal(got["port"], got["jax"])
    want = jnet._u8_iq(np.tile(u8, 3).tobytes())[:12_800]
    np.testing.assert_array_equal(got["port"], want)


# ---------------------------------------------------------------------
# SpyServer

def _spyserver(log, iq16):
    """A SpyServer's handler (tests/test_network_io.py's): the hello, the
    device info, the settings logged until streaming is on, one int16 IQ
    message, then the late settings."""
    def read_exact(conn, n):
        buf = b""
        while len(buf) < n:
            part = conn.recv(n - len(buf))
            if not part:
                raise ConnectionError
            buf += part
        return buf

    def handler(conn, i):
        S = jspy
        hello = read_exact(conn, 8)
        body = read_exact(conn, struct.unpack("<II", hello)[1])
        log[i].append(("hello", hello + body))
        di = struct.pack("<12I", 3, 12345, 2_000_000, 1_600_000, 4, 1, 29,
                         24_000_000, 1_700_000_000, 8, 1, 0)
        conn.sendall(struct.pack("<IIIII", S.PROTOCOL_VERSION,
                                 S.MSG_DEVICE_INFO, 0, 0, len(di)) + di)
        streaming = False
        try:
            while True:
                ctype, n = struct.unpack("<II", read_exact(conn, 8))
                setting = struct.unpack("<II", read_exact(conn, n))
                log[i].append((ctype, setting))
                if setting == (S.SETTING_IQ_FREQUENCY, 14_200_000):
                    return            # the retune: the session is over
                if setting == (S.SETTING_STREAMING_ENABLED, 1) and \
                        not streaming:
                    streaming = True
                    pcm = np.empty(2 * len(iq16), "<i2")
                    pcm[0::2], pcm[1::2] = iq16.real, iq16.imag
                    conn.sendall(struct.pack(
                        "<IIIII", S.PROTOCOL_VERSION, S.MSG_INT16_IQ, 1, 1,
                        2 * pcm.size) + pcm.tobytes())
        except (ConnectionError, socket.timeout, OSError):
            pass
    return handler


def test_spyserver_source():
    rng = np.random.default_rng(5)
    iq16 = rng.integers(-20000, 20000, 2048) + 1j * rng.integers(
        -20000, 20000, 2048)
    log = [[], []]
    peer = TcpPeer(_spyserver(log, iq16))
    got, info = {}, {}
    try:
        for name, (_, spy, *_) in PKGS.items():
            src = spy.SpyServerSource("127.0.0.1", peer.port, srate_index=1,
                                      gain=5)
            try:
                src.start_stream(7_100_000.0)
                got[name] = _collect(src, 2048)
                src.tune(14_200_000.0)
                info[name] = (src.samplerate, dict(src.device_info))
                i = len(got) - 1
                wait_for(lambda: (pspy.SETTING_IQ_FREQUENCY, 14_200_000)
                         in [s for _, s in log[i][1:]],
                         "the retune never reached the server")
            finally:
                src.close()
    finally:
        peer.close()
    assert info["port"] == info["jax"] and info["port"][0] == 500_000.0
    assert log[0] == log[1] and len(log[0]) > 3
    assert len(got["port"]) == 2048
    np.testing.assert_array_equal(got["port"], got["jax"])


# ---------------------------------------------------------------------
# KiwiSDR and the WebSocket frames

@pytest.mark.parametrize("n", [0, 5, 125, 126, 4000, 65535, 65536, 70000])
def test_websocket_frames(n):
    payload = bytes(np.random.default_rng(n).integers(0, 256, n,
                                                      dtype=np.uint8))
    for op in (0x1, 0x2, 0x8, 0x9, 0xA):
        assert pws.build_frame(op, payload) == jws.build_frame(op, payload)
    key = "dGhlIHNhbXBsZSBub25jZQ=="
    assert pws._accept_key(key) == jws._accept_key(key)


def _ws_read(conn, buf: bytearray, n: int) -> bytes:
    while len(buf) < n:
        part = conn.recv(65536)
        if not part:
            raise ConnectionError
        buf.extend(part)
    out = bytes(buf[:n])
    del buf[:n]
    return out


def _kiwi(raw_log, iq_pkts):
    """A KiwiSDR's raw WebSocket handler: the upgrade, every client byte
    logged, the IQ packets sent once ``SET mod=iq`` has come."""
    def handler(conn, i):
        buf = bytearray()
        while b"\r\n\r\n" not in buf:
            part = conn.recv(4096)
            if not part:
                return
            buf.extend(part)
        head, _, rest = bytes(buf).partition(b"\r\n\r\n")
        raw_log[i].append(head)
        buf = bytearray(rest)
        conn.sendall(b"HTTP/1.1 101 Switching Protocols\r\nUpgrade: "
                     b"websocket\r\nConnection: Upgrade\r\n\r\n")
        sent = False
        try:
            while True:
                hdr = _ws_read(conn, buf, 2)
                n = hdr[1] & 0x7F
                ext = _ws_read(conn, buf, 2) if n == 126 else b""
                if ext:
                    n = struct.unpack(">H", ext)[0]
                mask = _ws_read(conn, buf, 4)
                body = _ws_read(conn, buf, n)
                raw_log[i].append(hdr + ext + mask + body)
                text = bytes(b ^ mask[k % 4] for k, b in enumerate(body))
                if b"freq=7074.000" in text:
                    return            # the retune: the session is over
                if text.startswith(b"SET mod=iq") and not sent:
                    sent = True
                    for p in iq_pkts:
                        conn.sendall(pws.build_frame(0x2, p))
        except (ConnectionError, OSError):
            pass
    return handler


def test_kiwisdr_source(monkeypatch):
    """One raw fake KiwiSDR: each package's client sends the same bytes
    (its masks and key made the same), takes the same IQ and retunes the
    same way (the request line's millisecond stamp aside)."""
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(1, n + 1)))
    rng = np.random.default_rng(6)
    pkts = []
    for _ in range(3):
        pcm = rng.integers(-30000, 30000, 1024).astype(">i2")
        pkts.append(b"SND\x08" + bytes(16) + pcm.tobytes())
    log = [[], []]
    peer = TcpPeer(_kiwi(log, pkts))
    got = {}
    try:
        for i, (name, (*_, kiwi, _h, _m)) in enumerate(PKGS.items()):
            src = kiwi.KiwiSDRSource("127.0.0.1", peer.port,
                                     freq_hz=14_074_000.0)
            try:
                got[name] = _collect(src, 3 * 512)
                src.tune(7_074_000.0)
                wait_for(lambda: any(b"freq=7074.000" in bytes(
                    c ^ r[2 + k % 4] for k, c in enumerate(r[6:]))
                    for r in log[i][1:]), "the retune never arrived")
            finally:
                src.close()
    finally:
        peer.close()
    stamp = re.compile(rb"/kiwi/\d+/SND")
    assert stamp.sub(b"", log[0][0]) == stamp.sub(b"", log[1][0])
    assert log[0][1:] == log[1][1:] and len(log[0]) >= 8
    assert len(got["port"]) == 3 * 512
    np.testing.assert_array_equal(got["port"], got["jax"])


# ---------------------------------------------------------------------
# Hermes Lite 2

def _frames(rng, n, receivers=1, sync=True):
    fr = rng.integers(0, 256, (n, jhl2.FRAME_BYTES)).astype(np.uint8)
    if sync:
        fr[:, :3] = jhl2.SYNC
    return fr


@pytest.mark.parametrize("receivers", [1, 2])
def test_hl2_rx_frame_codec(receivers):
    rng = np.random.default_rng(7)
    for fr in list(_frames(rng, 20, receivers)) + [
            _frames(rng, 1, sync=False)[0]]:
        want = jhl2.decode_rx_frame(fr, receivers)
        got = phl2.decode_rx_frame(fr, receivers)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)


def test_hl2_tx_codec():
    """``encode_tx_samples`` on samples under and over full scale (its
    clip guard), at three software powers: the same bytes and count."""
    rng = np.random.default_rng(8)
    for scale in (1.0, 0.7, 200 / 255):
        x = (0.9 * (rng.standard_normal(63) + 1j * rng.standard_normal(63))
             ).astype(np.complex64)
        bufs = [rng.integers(0, 256, 512).astype(np.uint8)] * 2
        bufs = [b.copy() for b in bufs]
        n = [m.encode_tx_samples(b, x, scale)
             for m, b in zip((jhl2, phl2), bufs)]
        assert n[0] == n[1] > 0
        np.testing.assert_array_equal(bufs[1], bufs[0])
    f = np.linspace(0, 70e6, 3001)
    assert [phl2.relays_for_frequency(v) for v in f] == [
        jhl2.relays_for_frequency(v) for v in f]


def test_hl2_register_words_and_packets():
    """Both devices through one script of setters, TX samples and PTT:
    the same register file and, packet by packet, the same EP2 bytes
    (the frame round robin and the RQST handshake), then the same
    telemetry from the same control words."""
    devs = [m.HL2Device(("127.0.0.1", 9), None, 192_000)
            for m in (jhl2, phl2)]
    rng = np.random.default_rng(9)
    tx = (0.4 * np.exp(2j * np.pi * rng.random(400))).astype(np.complex64)
    ctrl = [np.array(c, np.uint8) for c in (
        [0x80 | (jhl2.REG_RX_FREQ << 1), 0, 0x6C, 0x5C, 0xE0],
        [0x00, 1, 0, 0x8A, 0], [0x08, 0x0C, 0x80, 0x03, 0x10],
        [0x10, 0x01, 0x20, 0, 0], [0xE0, 33, 0, 0, 0], [0x08, 9, 9, 9, 9])]
    try:
        pk, tel = [], []
        for d in devs:
            d.set_adc_gain(20)
            d.set_frequency(7_100_000)
            d.set_tx_frequency(7_150_000)
            d.set_seven_relays(phl2.relays_for_frequency(7.1e6))
            d.set_software_power(200)
            d.set_hardware_power(0xA7)
            d.set_pa_enabled(True)
            d.set_tune(False)
            d.set_hang_latency(10, 0x20)
            d.set_duplex(True)
            pk.append([d._prepare_request(s) for s in range(-1, 13)])
            d.set_ptt(True)
            d.queue_tx_samples(tx)
            pk[-1] += [d._prepare_request(s % 11) for s in range(40)]
            d.set_ptt(False)
            d.set_frequency(14_200_000)
            pk[-1] += [d._prepare_request(s % 11) for s in range(40)]
            t = []
            for c in ctrl:
                d._process_control(c)
                t.append((d.confirmed_frequency, d.adc_overload,
                          d.fill_level, d.temperature, d.fwd, d.rev, d.swr,
                          d.alex_forward_power, d.alex_reverse_power))
            tel.append(t)
            np.testing.assert_array_equal(d.registers, devs[0].registers)
            assert d.get_rx_sample_rate() == 192_000
    finally:
        for d in devs:
            d._sock.close()
    assert pk[0] == pk[1] and tel[0] == tel[1]
    assert devs[1].clipped_tx_samples == devs[0].clipped_tx_samples


def test_hl2_source_against_fake():
    """Each package's ``HL2Source`` on a ``chip_smoke.FakeHL2`` of its own
    (one stream): the same RX samples (the port queues them in SR/200
    blocks, the JAX source a frame at a time), then PTT and the same TX
    IQ and registers at the fake."""
    cs = _chip_smoke()
    fs = 48_000
    fakes = [cs.FakeHL2(cs.hl2_wideband(), fs) for _ in range(2)]
    srcs, got = [], []
    tx = (0.5 * np.exp(2j * np.pi * 1000.0 * np.arange(2016) / fs)
          ).astype(np.complex64)
    try:
        for m, fk in zip((jhl2, phl2), fakes):
            s = m.HL2Source("127.0.0.1", fk.port, samplerate=fs)
            srcs.append(s)
            s.tune(7_100_000.0)
            got.append(_collect(s, 12_000))
        for s in srcs:
            s.set_tx_frequency(7_120_000.0)
            s.set_tx_gain(0.5)
            s.set_ptt(True)
            s.send_iq(tx)
        wait_for(lambda: all(sum(map(len, f.tx_iq)) >= len(tx)
                             for f in fakes), "the TX IQ never arrived",
                 timeout=10.0)
        assert [s.get_ptt() for s in srcs] == [True, True]
        assert srcs[1].get_swr() == srcs[0].get_swr()
    finally:
        for s in srcs:
            s.close()
        try:
            wait_for(lambda: all(f.stopped.is_set() for f in fakes),
                     "the Metis stop never arrived")
            res = [f.results() for f in fakes]
        finally:
            for f in fakes:
                f.close()
    assert len(got[1]) == 12_000
    np.testing.assert_array_equal(got[1], got[0])
    want = np.tile(cs.hl2_wideband(), 2)[:12_000]
    assert np.max(np.abs(got[1] - want)) < 2e-7        # 24-bit codec
    np.testing.assert_array_equal(res[1]["tx_iq"], res[0]["tx_iq"])
    assert len(res[1]["tx_iq"]) == len(tx)
    assert res[0]["mox_frames"] > 0 and res[1]["mox_frames"] > 0
    assert res[1]["registers"][jhl2.REG_TX_FREQ] == \
        res[0]["registers"][jhl2.REG_TX_FREQ] == 7_120_000
    assert res[0]["acked"][:1] == res[1]["acked"][:1] == [7_000_000]
    assert res[0]["stopped"] and res[1]["stopped"]


# ---------------------------------------------------------------------
# the source manager

def test_source_manager():
    out = []
    for *_, sm in PKGS.values():
        mgr = sm.SourceManager()
        seen = []
        mgr.on_tune.bind(seen.append)
        mgr.on_select.bind(seen.append)
        mgr.register("b", lambda **c: sm.NullSource(c.get("sr", 8e3),
                                                    realtime=False))
        mgr.register("a", lambda **c: sm.NullSource(realtime=False))
        sel = mgr.select("b", sr=16e3), mgr.select("zz")
        mgr.tune(7.1e6)
        blk = next(mgr.blocks())
        mgr.unregister("b")
        out.append((mgr.names(), sel, mgr.tuned_hz, mgr.selected,
                    mgr.source.samplerate, seen, blk.shape, blk.dtype))
    assert out[0] == out[1]
    assert out[1][:3] == (["a"], (True, False), 7.1e6)


# ---------------------------------------------------------------------
# the app on an rtl_tcp source

@pytest.fixture(scope="module")
def rtl_runs(tmp_path_factory):
    """The JAX app, the port's app (each on its own connection to one
    fake rtl_tcp server) and the port's app on a file of the quantized
    samples: BLOCKS manual pump steps each."""
    cs = _chip_smoke()
    tmp = str(tmp_path_factory.mktemp("rtl"))
    cap = os.path.join(tmp, "baseband_14000000Hz_10-00-00_01-01-2024.wav")
    net_capture(cap, seconds=0.5)
    from sdrplusplusbrown_tpu_torch.io.wav import read_wav_iq
    x, _ = read_wav_iq(cap)
    u8 = cs.u8_quantize(0.9 * x)
    qcap = os.path.join(tmp, "baseband_14000000Hz_10-00-00_01-01-2024_q"
                             ".wav")
    write_wav(qcap, pnet._u8_iq(u8.tobytes()), NET_FS, bits=32)
    fake = cs.FakeRtlTcp(u8, None, limit=200_000)
    runs = {}
    try:
        for name in ("file", "port", "jax"):
            root = os.path.join(tmp, name)
            os.makedirs(root)
            src = {"type": "file", "path": qcap, "loop": True} \
                if name == "file" else {"type": "rtl_tcp",
                                        "host": "127.0.0.1",
                                        "port": fake.port,
                                        "samplerate": NET_FS}
            conf = net_config(src)
            conf["frequency"] = 14_000_000.0
            with open(os.path.join(root, "config.json"), "w") as f:
                json.dump(conf, f)
            app = JaxApp(root, run_pump=False) if name == "jax" else \
                SDRApp(root, run_pump=False, device="cpu")
            runs[name] = _pump(app)
        wait_for(lambda: len(fake.commands) == 2, "no connections")
        runs["commands"] = fake.commands
    finally:
        fake.close()
    return runs


def _pump(app) -> dict:
    bb, au, got = [], [], []
    app.baseband_event.bind(lambda b: bb.append(np.asarray(b).copy()))
    app.modules["Radio"].audio_event.bind(
        lambda a: got.append(np.asarray(a).copy()))
    app.start()
    try:
        for _ in range(BLOCKS):
            assert app.pump_step(1) == 1
            au.append(np.concatenate(got, axis=-1))
            got.clear()
    finally:
        app.shutdown()
    return {"bb": bb, "audio": au, "samplerate": app.samplerate,
            "block_len": app.pump_block_len}


def test_rtl_tcp_app_is_the_file_app(rtl_runs):
    f, p = rtl_runs["file"], rtl_runs["port"]
    assert p["samplerate"] == f["samplerate"] == NET_FS
    assert p["block_len"] == f["block_len"]
    for a, b in zip(f["bb"] + f["audio"], p["bb"] + p["audio"]):
        np.testing.assert_array_equal(b, a)
    C = pnet.RtlTcpSource
    assert rtl_runs["commands"] == [[(C.CMD_SAMPLERATE, int(NET_FS)),
                                     (C.CMD_FREQ, 14_000_000)]] * 2


def test_rtl_tcp_app_matches_jax(rtl_runs):
    j, p = rtl_runs["jax"], rtl_runs["port"]
    assert len(p["audio"]) == len(j["audio"]) == BLOCKS
    for b in range(BLOCKS):
        np.testing.assert_array_equal(p["bb"][b], j["bb"][b])
        assert np.mean(j["audio"][b] ** 2) > 1e-4
        assert snr_db(j["audio"][b], p["audio"][b]) >= MIN_DB, b
