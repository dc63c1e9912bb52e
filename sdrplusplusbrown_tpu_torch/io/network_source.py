"""Network IQ sources: raw UDP/TCP streams and the rtl_tcp protocol (a copy
of sdrplusplusbrown_tpu/io/network_source.py; host code, the same bytes on
the wire).

reference: source_modules/network_source/src/main.cpp — receives raw IQ
over TCP (client) or UDP, converts int8/int16/int32/float32 interleaved
samples to complex float (scales 128 / 32768 / 2^31-1, main.cpp:294-309)
and pushes fixed blocks (samplerate/200 per read, :279-281).

reference: source_modules/rtl_tcp_source/src/rtl_tcp_client.{h,cpp} — a
TCP client of the standard ``rtl_tcp`` server: 5-byte command packets
``{uint8 cmd, uint32 param (network order)}`` (rtl_tcp_client.cpp:70-73),
unsigned-8-bit IQ scaled ``(x-128)/128`` (:84-89), block size SR/200
(:35).  Command ids: 1 freq, 2 samplerate, 3 gain mode, 4 gain, 5 ppm,
8 agc mode, 9 direct sampling, 10 offset tuning, 13 gain index,
14 bias tee (rtl_tcp_client.cpp:28-67).
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
from typing import Iterator, Optional

import numpy as np

from ..utils.flog import flog

#: interleaved wire formats → (dtype, scale) (network_source main.cpp:37-42,294-309)
SAMPLE_TYPES = {
    "int8": (np.int8, 128.0),
    "int16": (np.int16, 32768.0),
    "int32": (np.int32, 2147483647.0),
    "float32": (np.float32, 1.0),
}


def _to_complex(raw: bytes, sample_type: str) -> np.ndarray:
    dtype, scale = SAMPLE_TYPES[sample_type]
    flat = np.frombuffer(raw, dtype=dtype)
    if len(flat) % 2:
        flat = flat[:-1]
    f = flat.astype(np.float32) / np.float32(scale)
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


class _QueueSource:
    """Shared rx-thread + bounded-queue plumbing for network sources."""

    def __init__(self, samplerate: float):
        self.samplerate = float(samplerate)
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(
            maxsize=256)
        self._stop = threading.Event()
        self._rx: Optional[threading.Thread] = None

    def _start_rx(self):
        self._rx = threading.Thread(target=self._rx_loop, daemon=True)
        self._rx.start()

    def _rx_loop(self):  # pragma: no cover — overridden
        raise NotImplementedError

    def _push(self, samples: np.ndarray):
        if len(samples) == 0:
            return
        try:
            self._q.put(samples, timeout=1.0)
        except queue.Full:
            pass  # drop on overrun, like a saturated stream buffer

    def blocks(self, timeout: float = 10.0) -> Iterator[np.ndarray]:
        while not self._stop.is_set():
            try:
                blk = self._q.get(timeout=timeout)
            except queue.Empty:
                return
            if blk is None:
                return
            yield blk

    def close(self):
        self._stop.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        if self._rx is not None and self._rx.is_alive():
            self._rx.join(timeout=2.0)


class NetworkSource(_QueueSource):
    """Raw IQ over TCP (client) or UDP.

    ``protocol`` ∈ {"tcp", "udp"}; ``sample_type`` per SAMPLE_TYPES.
    TCP reads exactly SR/200-sample frames; UDP yields one block per
    datagram (network_source main.cpp:279-292).
    """

    def __init__(self, host: str = "localhost", port: int = 1234,
                 protocol: str = "udp", sample_type: str = "int16",
                 samplerate: float = 1_000_000.0):
        if sample_type not in SAMPLE_TYPES:
            raise ValueError(f"unknown sample type {sample_type!r}")
        super().__init__(samplerate)
        self.protocol = protocol
        self.sample_type = sample_type
        dtype, _ = SAMPLE_TYPES[sample_type]
        self._sample_bytes = 2 * np.dtype(dtype).itemsize
        if protocol == "tcp":
            self.sock = socket.create_connection((host, port), timeout=10)
        elif protocol == "udp":
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self.sock.bind(("0.0.0.0", port))
            self.sock.settimeout(1.0)
        else:
            raise ValueError(f"unknown protocol {protocol!r}")
        self._start_rx()

    def tune(self, freq_hz: float):
        """The raw stream carries no tuning channel (main.cpp:203-209)."""
        flog.info("network source: tune {} (no-op on raw streams)",
                  freq_hz)

    def _rx_loop(self):
        frame = self._sample_bytes * max(int(self.samplerate // 200), 256)
        try:
            while not self._stop.is_set():
                if self.protocol == "tcp":
                    raw = b""
                    while len(raw) < frame and not self._stop.is_set():
                        part = self.sock.recv(frame - len(raw))
                        if not part:
                            # flush the partial frame on a clean close
                            self._push(_to_complex(raw, self.sample_type))
                            raise ConnectionError("peer closed")
                        raw += part
                else:
                    try:
                        raw, _ = self.sock.recvfrom(1 << 16)
                    except socket.timeout:
                        continue
                self._push(_to_complex(raw, self.sample_type))
        except (OSError, ConnectionError) as e:
            if not self._stop.is_set():
                flog.warn("network source rx ended: {}", repr(e))
        finally:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass

    def close(self):
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass
        super().close()


class RtlTcpSource(_QueueSource):
    """Client of an ``rtl_tcp`` server (rtl_tcp_client.{h,cpp}).

    Parses the optional 12-byte ``RTL0`` dongle-info banner the standard
    server sends first (tuner type + gain count), then streams u8 IQ.
    """

    # command ids (rtl_tcp_client.cpp:28-67)
    CMD_FREQ = 1
    CMD_SAMPLERATE = 2
    CMD_GAIN_MODE = 3
    CMD_GAIN = 4
    CMD_PPM = 5
    CMD_AGC_MODE = 8
    CMD_DIRECT_SAMPLING = 9
    CMD_OFFSET_TUNING = 10
    CMD_GAIN_INDEX = 13
    CMD_BIAS_TEE = 14

    def __init__(self, host: str = "localhost", port: int = 1234,
                 samplerate: float = 2_400_000.0):
        super().__init__(samplerate)
        self.sock = socket.create_connection((host, port), timeout=10)
        self.tuner_type: Optional[int] = None
        self.tuner_gain_count: Optional[int] = None
        self._banner_pending = True
        self.set_samplerate(samplerate)
        self._start_rx()

    # -- control channel ---------------------------------------------------
    def _send_command(self, cmd: int, param: int):
        """5-byte packed command, param in network byte order
        (rtl_tcp_client.cpp:70-73)."""
        self.sock.sendall(struct.pack(">BI", cmd, int(param) & 0xFFFFFFFF))

    def tune(self, freq_hz: float):
        self._send_command(self.CMD_FREQ, int(round(freq_hz)))

    def set_samplerate(self, sr: float):
        self.samplerate = float(sr)
        self._send_command(self.CMD_SAMPLERATE, int(round(sr)))

    def set_gain_mode(self, manual: bool):
        self._send_command(self.CMD_GAIN_MODE, int(manual))

    def set_gain_index(self, index: int):
        self._send_command(self.CMD_GAIN_INDEX, index)

    def set_ppm(self, ppm: int):
        self._send_command(self.CMD_PPM, ppm)

    def set_agc_mode(self, on: bool):
        self._send_command(self.CMD_AGC_MODE, int(on))

    def set_direct_sampling(self, mode: int):
        self._send_command(self.CMD_DIRECT_SAMPLING, mode)

    def set_offset_tuning(self, on: bool):
        self._send_command(self.CMD_OFFSET_TUNING, int(on))

    def set_bias_tee(self, on: bool):
        self._send_command(self.CMD_BIAS_TEE, int(on))

    # -- data channel --------------------------------------------------
    def _rx_loop(self):
        block = 2 * max(int(self.samplerate // 200), 256)
        try:
            if self._banner_pending:
                head = self._recv_exact(12)
                if head[:4] == b"RTL0":
                    self.tuner_type, self.tuner_gain_count = \
                        struct.unpack(">II", head[4:12])
                else:
                    # no banner: the 12 bytes are already IQ samples
                    self._push(_u8_iq(head))
                self._banner_pending = False
            while not self._stop.is_set():
                self._push(_u8_iq(self._recv_exact(block)))
        except (OSError, ConnectionError) as e:
            if not self._stop.is_set():
                flog.warn("rtl_tcp rx ended: {}", repr(e))
        finally:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass

    def _recv_exact(self, n: int) -> bytes:
        raw = b""
        while len(raw) < n:
            part = self.sock.recv(n - len(raw))
            if not part:
                raise ConnectionError("peer closed")
            raw += part
        return raw

    def close(self):
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass
        super().close()


def _u8_iq(raw: bytes) -> np.ndarray:
    """(x-128)/128 unsigned-8-bit IQ (rtl_tcp_client.cpp:84-89)."""
    flat = np.frombuffer(raw, dtype=np.uint8)
    if len(flat) % 2:
        flat = flat[:-1]
    f = (flat.astype(np.float32) - 128.0) / 128.0
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)
