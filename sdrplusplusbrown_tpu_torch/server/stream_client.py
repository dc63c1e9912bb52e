"""Streaming client — the analog of sdrpp_server_source: connects to a
StreamServer and yields IQ blocks like a local source (a copy of
sdrplusplusbrown_tpu/server/stream_client.py; host numpy blocks, which the
app moves to its device with the rest of the pump's input)
(reference: source_modules/sdrpp_server_source/src/main.cpp).
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Iterator, Optional

import numpy as np

from ..ops.compression import decompress_samples, entropy_decode
from ..ops.efft import EFFTDecompressor
from .protocol import (MAGIC, Command, PacketType, pack_command,
                       recv_packet, sign_challenge)


class StreamClient:
    def __init__(self, host: str, port: int, password: str = "",
                 compression: str = "none"):
        self.sock = socket.create_connection((host, port), timeout=10)
        self.samplerate: Optional[float] = None
        self.compression = compression
        self.password = password
        self._q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=256)
        self._efft_dec: Optional[EFFTDecompressor] = None
        self._stop = threading.Event()
        self._rx = threading.Thread(target=self._rx_loop, daemon=True)
        self._rx.start()
        self._handshake()

    def _handshake(self, timeout: float = 10.0):
        import time
        t0 = time.time()
        while self.samplerate is None and time.time() - t0 < timeout:
            time.sleep(0.01)
        if self.samplerate is None:
            raise TimeoutError("no samplerate from server")
        if self.compression != "none":
            self.send_command(Command.SET_COMPRESSION,
                              {"mode": self.compression})
        self.send_command(Command.START, {"magic": MAGIC})

    def send_command(self, cmd: Command, args: dict | None = None):
        self.sock.sendall(pack_command(cmd, args))

    def tune(self, freq: float):
        self.send_command(Command.SET_FREQUENCY, {"frequency": freq})

    def set_efft_masked(self, ranges):
        self.send_command(Command.SET_EFFT_MASKED_FREQUENCIES,
                          {"ranges": list(ranges)})

    def transmit(self, iq6k: np.ndarray):
        """Send TX audio baseband at the 6 kHz wire rate
        (reference server_protocol.h:11, server.cpp:113-123)."""
        from ..ops.compression import PCMType, compress_samples, \
            entropy_encode
        from .protocol import pack_packet
        payload = entropy_encode(compress_samples(
            np.asarray(iq6k, np.complex64), PCMType.I16))
        self.sock.sendall(pack_packet(PacketType.TRANSMIT_DATA, payload))

    def _rx_loop(self):
        try:
            while not self._stop.is_set():
                ptype, payload = recv_packet(self.sock)
                if ptype == PacketType.COMMAND:
                    from .protocol import unpack_command
                    cmd, args = unpack_command(payload)
                    if cmd == Command.SET_SAMPLERATE:
                        self.samplerate = float(args["samplerate"])
                    elif cmd == Command.SECURE_CHALLENGE:
                        ch = bytes.fromhex(args["challenge"])
                        resp = sign_challenge(self.password, ch)
                        self.send_command(Command.SECURE_CHALLENGE,
                                          {"response": resp.hex()})
                elif ptype == PacketType.BASEBAND:
                    self._put(decompress_samples(payload))
                elif ptype == PacketType.BASEBAND_COMPRESSED:
                    self._put(decompress_samples(entropy_decode(payload)))
                elif ptype == PacketType.BASEBAND_EXPERIMENTAL_FFT:
                    frame = decompress_samples(entropy_decode(payload))
                    if self._efft_dec is None:
                        self._efft_dec = EFFTDecompressor(len(frame))
                    self._put(self._efft_dec.process([frame]))
        except (ConnectionError, OSError):
            pass

    def _put(self, blk):
        """Queue a block, waiting while the queue is full (the JAX
        client's backpressure) but not past ``close``."""
        while not self._stop.is_set():
            try:
                self._q.put(blk, timeout=0.2)
                return
            except queue.Full:
                pass

    def blocks(self, timeout: float = 10.0) -> Iterator[np.ndarray]:
        while not self._stop.is_set():
            try:
                yield self._q.get(timeout=timeout)
            except queue.Empty:
                return

    def close(self):
        self._stop.set()
        try:
            self.send_command(Command.DISCONNECT)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
