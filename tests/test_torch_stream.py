"""The network path of the port against the JAX package on the CPU: the
wire code (zstd, the sample compression, the protocol's packing and
``sign_challenge``, the host EFFT), the stream server and its client, and
the app fed from a remote server (the ``sdrpp_server`` source).

* Byte equality of every encoder: F32, I16 and I8 blocks (seeded, empty
  and all-zero), zstd frames, packets and the PBKDF2 challenge response.
* The wire: the JAX ``StreamServer`` and the port's on one stub app, one
  scripted session over a real socket (the challenge fixed by
  monkeypatching ``make_challenge`` in each server module): every byte
  the client receives is equal, and so are the retunes the app records.
* Clients across packages: the port's client on the JAX server and the
  JAX client on the port's server receive the same blocks.
* The slice: the port's app with an ``sdrpp_server`` source on the
  port's server, on a 240 kS/s capture with an NFM radio: in ``none``
  mode its baseband and audio are bit-identical to the app fed from the
  file; in ``int8`` mode they agree to >= 80 dB with the JAX app on the
  JAX server; ``tune`` reaches the server app, ``shutdown`` disconnects.
* The app's two repairs: ``tune`` passes the retune to a source that has
  one, and ``shutdown`` closes the source.

Every socket has a timeout and every wait a deadline, so a hang fails one
test.
"""

import json
import os
import socket
import struct
import zlib

import numpy as np
import pytest

from sdrplusplusbrown_tpu.app import SDRApp as JaxApp
from sdrplusplusbrown_tpu.ops import compression as jcomp
from sdrplusplusbrown_tpu.ops import efft as jefft
from sdrplusplusbrown_tpu.server import protocol as jproto
from sdrplusplusbrown_tpu.server import stream_client as jclient
from sdrplusplusbrown_tpu.server import stream_server as jserver
from sdrplusplusbrown_tpu.utils import zstd as jzstd
from sdrplusplusbrown_tpu_torch.app import SDRApp
from sdrplusplusbrown_tpu_torch.ops import compression as pcomp
from sdrplusplusbrown_tpu_torch.server import protocol as pproto
from sdrplusplusbrown_tpu_torch.server import stream_client as pclient
from sdrplusplusbrown_tpu_torch.server import stream_server as pserver
from sdrplusplusbrown_tpu_torch.utils import zstd as pzstd

from torch_parity import (net_capture, net_config, port_f32_handoff,
                          snr_db, wait_for)  # noqa: F401

SERVERS = {"jax": jserver, "port": pserver}
CLIENTS = {"jax": jclient, "port": pclient}
STUB_FS = 40_000.0          # the stub app's rate: EFFT frames of 1 024
MIN_DB = 80.0


def _iq(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / STUB_FS
    return (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            + 0.5 * np.exp(2j * np.pi * 3_000.0 * t)).astype(np.complex64)


# ---------------------------------------------------------------------
# byte equality of the encoders

@pytest.mark.parametrize("kind", ["seeded", "empty", "zeros"])
@pytest.mark.parametrize("pcm", ["F32", "I16", "I8"])
def test_sample_compression_bytes_equal(pcm, kind):
    x = {"seeded": _iq(3_001, 1), "empty": np.zeros(0, np.complex64),
         "zeros": np.zeros(512, np.complex64)}[kind]
    jb = jcomp.compress_samples(x, jcomp.PCMType[pcm])
    pb = pcomp.compress_samples(x, pcomp.PCMType[pcm])
    assert jb == pb
    ej, ep = jcomp.entropy_encode(jb), pcomp.entropy_encode(pb)
    assert ej == ep
    np.testing.assert_array_equal(pcomp.decompress_samples(
        pcomp.entropy_decode(ej)), jcomp.decompress_samples(jb))


def test_zstd_and_zlib_sniff_equal():
    assert pzstd.available() == jzstd.available()
    assert pzstd.ZSTD_MAGIC == jzstd.ZSTD_MAGIC
    data = _iq(4_096, 2).tobytes() + bytes(10_000)
    if pzstd.available():
        assert pzstd.compress(data) == jzstd.compress(data)
        assert pzstd.decompress(jzstd.compress(data)) == data
    # a zlib stream (no zstd magic) is sniffed and decoded as the JAX
    # package decodes it: wire behaviour, not a fallback of the device
    z = zlib.compress(data, 1)
    assert pcomp.entropy_decode(z) == jcomp.entropy_decode(z) == data


def test_protocol_packing_and_challenge_equal():
    for name in ("MAGIC", "TX_WIRE_SAMPLERATE", "PASSWORD_SALT"):
        assert getattr(pproto, name) == getattr(jproto, name)
    assert {e.name: int(e) for e in pproto.PacketType} == \
        {e.name: int(e) for e in jproto.PacketType}
    assert {e.name: int(e) for e in pproto.Command} == \
        {e.name: int(e) for e in jproto.Command}
    args = {"frequency": 101.5e6, "ranges": [-5000, 3000], "mode": "efft"}
    for cmd in pproto.Command:
        assert pproto.pack_command(cmd, args) == \
            jproto.pack_command(jproto.Command(int(cmd)), args)
    pkt = pproto.pack_packet(pproto.PacketType.BASEBAND, b"\x01\x02\x03")
    assert pkt == jproto.pack_packet(jproto.PacketType.BASEBAND,
                                     b"\x01\x02\x03")
    assert pproto.unpack_command(pproto.pack_command(
        pproto.Command.START, {"magic": 7})[8:]) == (2, {"magic": 7})
    ch = bytes(range(32))
    assert pproto.sign_challenge("pw", ch) == jproto.sign_challenge("pw",
                                                                    ch)
    assert pproto.sign_challenge("pw", ch) != pproto.sign_challenge("px",
                                                                    ch)


# ---------------------------------------------------------------------
# the wire: one scripted session on either server

class StubApp:
    """What the server reads of an app: no source (no stream loop), the
    rate, the frequency and a ``tune`` that records."""

    def __init__(self):
        self.source = None
        self.samplerate = STUB_FS
        self.frequency = 100e6
        self.tunes = []

    def tune(self, freq):
        self.tunes.append(freq)
        self.frequency = float(freq)


CHALLENGE = bytes(range(100, 132))


def _scripted_session(server_mod, monkeypatch):
    """Every packet the client receives, as raw bytes, and the app's
    recorded retunes."""
    P = pproto
    monkeypatch.setattr(server_mod, "make_challenge", lambda: CHALLENGE)
    app = StubApp()
    srv = server_mod.StreamServer(app, port=0, host="127.0.0.1",
                                  password="pw")
    srv.start()
    got = []
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    sock.settimeout(10)

    def read(k):
        for _ in range(k):
            ptype, payload = P.recv_packet(sock)
            got.append(P.pack_packet(ptype, payload))

    def cmd(c, args=None, replies=1):
        sock.sendall(P.pack_command(c, args))
        read(replies)

    def barrier():
        """GET_SAMPLERATE, then read up to its SET_SAMPLERATE reply: what
        a broadcast sent comes before it."""
        sock.sendall(P.pack_command(P.Command.GET_SAMPLERATE))
        while True:
            ptype, payload = P.recv_packet(sock)
            got.append(P.pack_packet(ptype, payload))
            if ptype == P.PacketType.COMMAND and P.unpack_command(
                    payload)[0] == P.Command.SET_SAMPLERATE:
                return

    try:
        read(2)                                   # challenge, samplerate
        cmd(P.Command.SET_FREQUENCY, {"frequency": 1.0})    # not authed
        cmd(P.Command.SECURE_CHALLENGE, {"response": "00" * 32})
        cmd(P.Command.SECURE_CHALLENGE, {
            "response": P.sign_challenge("pw", CHALLENGE).hex()})
        cmd(P.Command.START, {"magic": 123})      # bad magic
        cmd(P.Command.START, {"magic": P.MAGIC}, replies=2)
        srv.broadcast_baseband(_iq(1_000, 10))    # raw f32
        read(1)
        cmd(P.Command.SET_COMPRESSION, {"mode": "none"})
        srv.broadcast_baseband(_iq(1_200, 11))
        read(1)
        cmd(P.Command.SET_COMPRESSION, {"mode": "int8"})
        srv.broadcast_baseband(_iq(2_400, 12))
        read(1)
        cmd(P.Command.SET_COMPRESSION, {"mode": "efft"})
        cmd(P.Command.SET_EFFT_LOSS_RATE, {"loss_rate": 2.0})
        cmd(P.Command.SET_EFFT_MASKED_FREQUENCIES, {"ranges": [-6000,
                                                               -4000]})
        srv.broadcast_baseband(_iq(12 * 1024 + 100, 13))
        barrier()
        cmd(P.Command.SET_FREQUENCY, {"frequency": 101.5e6})
        sock.sendall(P.pack_packet(P.PacketType.TRANSMIT_DATA,
                                   pcomp.entropy_encode(pcomp.compress_samples(
                                       _iq(600, 14), pcomp.PCMType.I16))))
        barrier()
        cmd(P.Command.STOP)
        srv.broadcast_baseband(_iq(1_000, 15))    # stopped: nothing
        sock.sendall(P.pack_command(P.Command.DISCONNECT))
        tail = b""
        while True:
            b = sock.recv(4096)
            if not b:
                break
            tail += b
        got.append(tail)
    finally:
        sock.close()
        srv.stop()
    return got, app.tunes


def test_wire_bytes_equal_to_jax_server(monkeypatch):
    jgot, jtunes = _scripted_session(jserver, monkeypatch)
    pgot, ptunes = _scripted_session(pserver, monkeypatch)
    assert len(pgot) == len(jgot)
    for i, (a, b) in enumerate(zip(jgot, pgot)):
        assert a == b, i
    assert ptunes == jtunes == [101.5e6]
    # the session reached every branch: errors 2, 1, 3, the transmitter
    # announcement, three EFFT frames and no tail after DISCONNECT
    P = pproto
    types = [struct.unpack("<I", p[:4])[0] for p in pgot[:-1]]
    errors = [p[8:] for p in pgot if p[:4] == struct.pack(
        "<I", P.PacketType.ERROR)]
    assert errors == [b"\x02", b"\x01", b"\x03"]
    assert types.count(P.PacketType.BASEBAND) == 2
    assert types.count(P.PacketType.BASEBAND_COMPRESSED) == 1
    assert types.count(P.PacketType.BASEBAND_EXPERIMENTAL_FFT) == 3
    assert P.pack_command(P.Command.SET_TRANSMITTER_NOT_SUPPORTED) in pgot
    assert pgot[-1] == b""


# ---------------------------------------------------------------------
# clients across packages

def _expected_blocks(blocks, mode):
    if mode == "none":
        return blocks
    if mode == "int8":
        return [jcomp.decompress_samples(jcomp.compress_samples(
            b, jcomp.PCMType.I8)) for b in blocks]
    comp = jefft.EFFTCompressor(STUB_FS)
    frames = [f for b in blocks for f in comp.process(b)]
    dec = jefft.EFFTDecompressor(comp.fft_size)
    return [dec.process([jcomp.decompress_samples(jcomp.compress_samples(
        f, jcomp.PCMType.I8))]) for f in frames]


@pytest.mark.parametrize("mode", ["none", "int8", "efft"])
@pytest.mark.parametrize("server,client", [("jax", "port"),
                                           ("port", "jax")])
def test_clients_across_packages(server, client, mode):
    srv = SERVERS[server].StreamServer(StubApp(), port=0,
                                       host="127.0.0.1")
    srv.start()
    cli = CLIENTS[client].StreamClient("127.0.0.1", srv.port,
                                       compression=mode)
    try:
        assert cli.samplerate == STUB_FS
        wait_for(lambda: any(c.running for c in srv._clients.values()),
                 "the server never saw START")
        blocks = [_iq(4 * 1024, 20 + i) for i in range(4)]
        for b in blocks:
            srv.broadcast_baseband(b)
        want = _expected_blocks(blocks, mode)
        got = [cli._q.get(timeout=10) for _ in want]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        assert cli._q.empty()
    finally:
        cli.close()
        srv.stop()


def test_stop_ends_the_accept_loop():
    """stop() wakes the accept loop blocked on the listener: no thread of
    the server outlives it."""
    srv = pserver.StreamServer(StubApp(), port=0, host="127.0.0.1")
    srv.start()
    assert srv._accept_thread.is_alive()
    srv.stop()
    srv._accept_thread.join(timeout=10)
    assert not srv._accept_thread.is_alive()


def _tx_session(server_mod, trx_mod, device=None):
    """A client's TX session on a server whose app has a loopback
    transmitter: the handshake, TX_BLOCKS wire blocks of TRANSMIT_DATA
    (6 kHz, int16 on the wire, as StreamClient.transmit sends them), a
    GET_SAMPLERATE barrier.  Every packet the client received, as raw
    bytes, and the 48 kHz packets the transmitter got."""
    P = pproto
    app = StubApp()
    app.transmitter = trx_mod.LoopbackTransmitter()
    if device is not None:
        app.device = device
    srv = server_mod.StreamServer(app, port=0, host="127.0.0.1")
    srv.start()
    got = []
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    sock.settimeout(10)

    def read_until(cmd):
        while True:
            ptype, payload = P.recv_packet(sock)
            got.append(P.pack_packet(ptype, payload))
            if ptype == P.PacketType.COMMAND and \
                    P.unpack_command(payload)[0] == cmd:
                return
    try:
        read_until(P.Command.SET_SAMPLERATE)
        sock.sendall(P.pack_command(P.Command.START, {"magic": P.MAGIC}))
        read_until(P.Command.SET_TRANSMITTER_SUPPORTED)
        rng = np.random.default_rng(16)
        t = np.arange(TX_BLOCKS * 1200) / 6000.0
        wire = (0.5 * np.exp(2j * np.pi * 1000.0 * t) + 0.01 * (
            rng.standard_normal(t.size) + 1j * rng.standard_normal(t.size))
            ).astype(np.complex64).reshape(TX_BLOCKS, 1200)
        for blk in wire:
            sock.sendall(P.pack_packet(
                P.PacketType.TRANSMIT_DATA, pcomp.entropy_encode(
                    pcomp.compress_samples(blk, pcomp.PCMType.I16))))
        sock.sendall(P.pack_command(P.Command.GET_SAMPLERATE))
        read_until(P.Command.SET_SAMPLERATE)
    finally:
        sock.close()
        srv.stop()
    return got, app.transmitter.blocks


TX_BLOCKS = 5


def test_server_refuses_a_transmitter():
    """The refusal is gone: a server whose app has a transmitter announces
    SET_TRANSMITTER_SUPPORTED with the JAX server's bytes, and the
    client's TX audio reaches the transmitter through ServerTxPath (the
    port's 6 k → 48 k resampler on the app's device, here the CPU): the
    same 960-sample 48 kHz packets as the JAX server's, each >= MIN_DB."""
    from sdrplusplusbrown_tpu.models import trx as jtrx
    from sdrplusplusbrown_tpu_torch.models import trx as ptrx
    jgot, jpk = _tx_session(jserver, jtrx)
    pgot, ppk = _tx_session(pserver, ptrx, device="cpu")
    assert pgot == jgot
    # ten 20 ms packets a 200 ms block: the 200 ms prebuffer primes on
    # the first block's 9 600 samples and drains whole
    assert len(ppk) == len(jpk) == TX_BLOCKS * 10
    for a, b in zip(jpk, ppk):
        assert b.shape == (960,) and b.dtype == np.complex64
        assert snr_db(a, b) >= MIN_DB


# ---------------------------------------------------------------------
# the app over the network

BLOCKS = 4


def _run_app(app, server_srv=None, server_app=None) -> dict:
    """BLOCKS manual pump steps: the baseband and the radio's audio a
    block; with a server, then a retune that must reach the server app
    and the shutdown that must drop the server's client."""
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
        out = {"bb": bb, "audio": au, "block_len": app.pump_block_len,
               "samplerate": app.samplerate}
        if server_srv is not None:
            app.tune(101.3e6)
            wait_for(lambda: server_app.frequency == 101.3e6,
                     "the retune never reached the server app")
    finally:
        app.shutdown()
    if server_srv is not None:
        wait_for(lambda: not server_srv._clients,
                 "the client did not disconnect at shutdown")
    return out


def _served_run(tmp, name, cap, mode, pkg):
    """The app of ``pkg`` on an ``sdrpp_server`` source in ``mode``,
    served from ``cap`` by a fresh server of the same package (so the
    stream starts at the capture's first sample)."""
    root = os.path.join(tmp, name)
    os.makedirs(os.path.join(root, "server"))
    with open(os.path.join(root, "server", "config.json"), "w") as f:
        json.dump({"source": {"type": "file", "path": cap, "loop": True}},
                  f)
    if pkg == "port":
        sapp = SDRApp(os.path.join(root, "server"), run_pump=False,
                      device="cpu")
    else:
        sapp = JaxApp(os.path.join(root, "server"), run_pump=False)
    srv = SERVERS[pkg].StreamServer(sapp, port=0, host="127.0.0.1")
    srv.start()
    try:
        os.makedirs(os.path.join(root, "client"))
        with open(os.path.join(root, "client", "config.json"), "w") as f:
            json.dump(net_config({"type": "sdrpp_server",
                                  "host": "127.0.0.1", "port": srv.port,
                                  "compression": mode}), f)
        if pkg == "port":
            app = SDRApp(os.path.join(root, "client"), run_pump=False,
                         device="cpu")
        else:
            app = JaxApp(os.path.join(root, "client"), run_pump=False)
        return _run_app(app, srv, sapp)
    finally:
        srv.stop()
        sapp.shutdown()


@pytest.fixture(scope="module")
def net_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("net"))
    cap = os.path.join(tmp, "baseband_14000000Hz_10-00-00_01-01-2024.wav")
    net_capture(cap)
    os.makedirs(os.path.join(tmp, "file"))
    with open(os.path.join(tmp, "file", "config.json"), "w") as f:
        json.dump(net_config({"type": "file", "path": cap, "loop": True}),
                  f)
    runs = {"file": _run_app(SDRApp(os.path.join(tmp, "file"),
                                    run_pump=False, device="cpu"))}
    for name, mode, pkg in (("none", "none", "port"),
                            ("int8", "int8", "port"),
                            ("jax_int8", "int8", "jax")):
        runs[name] = _served_run(tmp, name, cap, mode, pkg)
    return runs


def test_app_over_network_is_the_file_app(net_runs):
    """``none`` mode moves float32 IQ unchanged: the same baseband and
    audio, bit for bit, as the app fed from the file."""
    f, n = net_runs["file"], net_runs["none"]
    assert n["samplerate"] == f["samplerate"] == 240_000.0
    assert n["block_len"] == f["block_len"]
    assert len(n["bb"]) == len(f["bb"]) == BLOCKS
    for a, b in zip(f["bb"] + f["audio"], n["bb"] + n["audio"]):
        np.testing.assert_array_equal(b, a)


def test_app_over_network_int8_matches_jax(net_runs):
    j, p, f = net_runs["jax_int8"], net_runs["int8"], net_runs["file"]
    assert len(p["audio"]) == len(j["audio"]) == BLOCKS
    for b in range(BLOCKS):
        assert snr_db(j["bb"][b], p["bb"][b]) >= MIN_DB, b
        assert np.mean(j["audio"][b] ** 2) > 1e-4
        assert snr_db(j["audio"][b], p["audio"][b]) >= MIN_DB, b
        # int8 is lossy: the quantised stream is not the file's
        assert not np.array_equal(p["bb"][b], f["bb"][b])
        assert snr_db(f["bb"][b], p["bb"][b]) > 25.0


# ---------------------------------------------------------------------
# the app's two repairs

class RecordingSource:
    samplerate = 240_000.0

    def __init__(self):
        self.tunes, self.closed = [], 0

    def tune(self, freq):
        self.tunes.append(freq)

    def close(self):
        self.closed += 1

    def blocks(self):
        return iter(())


def test_tune_reaches_the_source_and_shutdown_closes_it(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"source": {"type": "none", "samplerate": 240_000.0}}, f)
    app = SDRApp(str(tmp_path), run_pump=False, device="cpu")
    src = app.source = RecordingSource()
    app.tune(7.1e6)
    assert src.tunes == [7.1e6] and app.frequency == 7.1e6
    app.shutdown()
    assert src.closed == 1
