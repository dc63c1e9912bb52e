"""Headless IQ streaming server (counterpart of
sdrplusplusbrown_tpu/server/stream_server.py; host code, the same bytes
on the wire).

reference: core/src/server.cpp:84-180 — the --server mode: source →
[compression: raw f32 | int8 PCM | lossy EFFT] → entropy coding → TCP;
command channel for start/stop/tune/samplerate/compression; PBKDF2
challenge auth; TX backchannel at 6 kHz wire rate upsampled server-side.

The compression runs on the host, as the JAX server runs it, so that the
wire bytes stay equal.  With a transmitter on the app the server
announces SET_TRANSMITTER_SUPPORTED and each TRANSMIT_DATA block goes
through ``models.trx.ServerTxPath`` on the app's device (the 6 k → 48 k
resampler on K8); without one it announces SET_TRANSMITTER_NOT_SUPPORTED
and decodes and drops the block, as the JAX server does.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Dict, Optional

import numpy as np

from ..utils.flog import flog
from ..ops.compression import (PCMType, compress_samples, entropy_encode,
                               entropy_decode, decompress_samples)
from ..ops.efft import EFFTCompressor
from .protocol import (MAGIC, Command, PacketType,
                       pack_packet, pack_command, unpack_command,
                       recv_packet, make_challenge, sign_challenge)


class _ClientState:
    def __init__(self, sock):
        self.sock = sock
        self.running = False
        self.compression = "none"        # none | int8 | efft
        self.efft: Optional[EFFTCompressor] = None
        self.authed = True
        self.lock = threading.Lock()

    def send(self, data: bytes):
        with self.lock:
            self.sock.sendall(data)


class StreamServer:
    def __init__(self, app, port: int = 5259, host: str = "0.0.0.0",
                 password: Optional[str] = None):
        self.app = app
        self.password = password
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(4)
        self.port = self._listener.getsockname()[1]
        self._clients: Dict[int, _ClientState] = {}
        self._next_id = 0
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        # TX backchannel: 6 kHz wire → 48 kHz → transmitter
        # (reference server.cpp:113-123), on the app's device
        self.tx_path = None
        tx = getattr(app, "transmitter", None)
        if tx is not None:
            from ..models.trx import ServerTxPath
            self.tx_path = ServerTxPath(tx, device=app.device)

    # ------------------------------------------------------------------
    def start(self):
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        # feed baseband to clients from the app's radio-agnostic tap
        if self.app.source is not None:
            threading.Thread(target=self._stream_loop, daemon=True).start()
        flog.info("stream server on port {}", self.port)

    def stop(self):
        self._stop.set()
        try:
            # wakes the accept loop (closing alone leaves it blocked)
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        for c in list(self._clients.values()):
            try:
                c.sock.close()
            except OSError:
                pass

    # ------------------------------------------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            cid = self._next_id
            self._next_id += 1
            cs = _ClientState(sock)
            if self.password:
                cs.authed = False
            self._clients[cid] = cs
            threading.Thread(target=self._client_loop, args=(cid, cs),
                             daemon=True).start()
            flog.info("stream client {} connected from {}", cid, addr)

    def _client_loop(self, cid: int, cs: _ClientState):
        challenge = None
        try:
            if self.password:
                challenge = make_challenge()
                cs.send(pack_command(Command.SECURE_CHALLENGE,
                                     {"challenge": challenge.hex()}))
            cs.send(pack_command(Command.SET_SAMPLERATE,
                                 {"samplerate": self.app.samplerate}))
            while not self._stop.is_set():
                ptype, payload = recv_packet(cs.sock)
                if ptype == PacketType.COMMAND:
                    cmd, args = unpack_command(payload)
                    self._handle_command(cs, cmd, args, challenge)
                elif ptype == PacketType.TRANSMIT_DATA:
                    # 6 kHz complex wire rate; upsampled by the TX chain
                    # (without a transmitter: decoded, then dropped)
                    iq = decompress_samples(entropy_decode(payload))
                    if self.tx_path is not None:
                        self.tx_path.push_wire_block(iq)
        except (ConnectionError, OSError):
            pass
        finally:
            self._clients.pop(cid, None)
            try:
                cs.sock.close()
            except OSError:
                pass
            flog.info("stream client {} disconnected", cid)

    def _handle_command(self, cs: _ClientState, cmd: int, args: dict,
                        challenge):
        if cmd == Command.SECURE_CHALLENGE:
            resp = bytes.fromhex(args.get("response", ""))
            if challenge is not None and resp == sign_challenge(
                    self.password, challenge):
                cs.authed = True
                cs.send(pack_packet(PacketType.COMMAND_ACK,
                                    struct.pack("<I", cmd)))
            else:
                cs.send(pack_packet(PacketType.ERROR, b"\x01"))
            return
        if not cs.authed:
            cs.send(pack_packet(PacketType.ERROR, b"\x02"))
            return
        if cmd == Command.START:
            if args.get("magic", MAGIC) != MAGIC:
                cs.send(pack_packet(PacketType.ERROR, b"\x03"))
                return
            cs.running = True
            cs.send(pack_command(
                Command.SET_TRANSMITTER_SUPPORTED if self.tx_path
                else Command.SET_TRANSMITTER_NOT_SUPPORTED, {}))
        elif cmd == Command.STOP:
            cs.running = False
        elif cmd == Command.SET_FREQUENCY:
            self.app.tune(float(args.get("frequency", self.app.frequency)))
        elif cmd == Command.SET_COMPRESSION:
            mode = args.get("mode", "none")
            cs.compression = mode
            if mode == "efft" and cs.efft is None:
                cs.efft = EFFTCompressor(self.app.samplerate)
        elif cmd == Command.SET_EFFT_LOSS_RATE:
            if cs.efft is not None:
                cs.efft.loss_rate = float(args.get("loss_rate", 1.0))
        elif cmd == Command.SET_EFFT_MASKED_FREQUENCIES:
            if cs.efft is not None:
                cs.efft.set_masked_frequencies(
                    [int(v) for v in args.get("ranges", [])])
        elif cmd == Command.GET_SAMPLERATE or cmd == Command.SET_SAMPLERATE:
            cs.send(pack_command(Command.SET_SAMPLERATE,
                                 {"samplerate": self.app.samplerate}))
            return
        elif cmd == Command.DISCONNECT:
            raise ConnectionError("client requested disconnect")
        cs.send(pack_packet(PacketType.COMMAND_ACK,
                            struct.pack("<I", cmd)))

    # ------------------------------------------------------------------
    def _stream_loop(self):
        import time
        sr = float(getattr(self.app.source, "samplerate", 1e6))
        t0 = time.monotonic()
        sent = 0
        for blk in self.app.source.blocks():
            if self._stop.is_set():
                return
            # idle (cheaply) until someone is listening
            while not any(c.running for c in self._clients.values()):
                if self._stop.is_set():
                    return
                time.sleep(0.1)
                t0 = time.monotonic()
                sent = 0
            self.broadcast_baseband(blk)
            # pace to real time: live consumers expect the sample rate
            sent += len(blk)
            due = t0 + sent / sr
            now = time.monotonic()
            if due > now:
                time.sleep(due - now)

    def broadcast_baseband(self, blk: np.ndarray):
        for cs in list(self._clients.values()):
            if not cs.running or not cs.authed:
                continue
            try:
                if cs.compression == "int8":
                    payload = entropy_encode(
                        compress_samples(blk, PCMType.I8))
                    cs.send(pack_packet(PacketType.BASEBAND_COMPRESSED,
                                        payload))
                elif cs.compression == "efft" and cs.efft is not None:
                    for frame in cs.efft.process(blk):
                        payload = entropy_encode(
                            compress_samples(frame, PCMType.I8))
                        cs.send(pack_packet(
                            PacketType.BASEBAND_EXPERIMENTAL_FFT, payload))
                else:
                    cs.send(pack_packet(
                        PacketType.BASEBAND,
                        compress_samples(blk, PCMType.F32)))
            except (ConnectionError, OSError):
                cs.running = False
