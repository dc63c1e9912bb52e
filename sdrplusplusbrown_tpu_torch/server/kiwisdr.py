"""KiwiSDR WebSocket client — remote receiver audio for websdr_view (a copy
of sdrplusplusbrown_tpu/server/kiwisdr.py; host code, the same bytes on
the wire).

reference: core/src/utils/proto/kiwisdr.h — connects to
``/kiwi/<millis>/SND``, sends the handshake command sequence
(:53-65: ``SET auth t=kiwi p=#``, ``SET AR OK in=12000 out=48000``,
``SERVER DE CLIENT sdr++brown SND``, compression/agc, ``SET mod=…``),
keeps alive (:179) and parses binary ``SND`` packets (REAL mode:
10-byte header + 512 big-endian int16 samples, :98-120).
"""

from __future__ import annotations

import base64
import os
import socket
import struct
import threading
import time
from typing import Callable, Optional

import numpy as np

from .websocket import build_frame

IQDATA_FREQUENCY = 12_000


class WSClient:
    """Minimal stdlib WebSocket client (masked frames)."""

    def __init__(self, host: str, port: int, path: str,
                 timeout: float = 10.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        req = (f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
               "Upgrade: websocket\r\nConnection: Upgrade\r\n"
               f"Sec-WebSocket-Key: {key}\r\n"
               "Sec-WebSocket-Version: 13\r\n\r\n")
        self.sock.sendall(req.encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("handshake EOF")
            resp += chunk
        if b"101" not in resp.split(b"\r\n", 1)[0]:
            raise ConnectionError("handshake rejected")
        self._buf = resp.split(b"\r\n\r\n", 1)[1]
        self.open = True

    def send_text(self, text: str):
        payload = text.encode()
        mask = os.urandom(4)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        n = len(payload)
        head = bytes([0x81])
        if n < 126:
            head += bytes([0x80 | n])
        else:
            head += bytes([0x80 | 126]) + struct.pack(">H", n)
        self.sock.sendall(head + mask + masked)

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("EOF")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def recv_message(self):
        hdr = self._read_exact(2)
        op = hdr[0] & 0x0F
        n = hdr[1] & 0x7F
        if n == 126:
            n = struct.unpack(">H", self._read_exact(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", self._read_exact(8))[0]
        return op, self._read_exact(n)

    def close(self):
        self.open = False
        try:
            self.sock.close()
        except OSError:
            pass


class KiwiSDRClient:
    """One remote KiwiSDR connection producing audio or IQ samples.

    Two tune modes mirroring kiwisdr.h:185-205: ``usb`` (TUNE_REAL —
    512 s16be mono samples per SND packet, 10-byte header including the
    tag) and ``iq`` (TUNE_IQ — 512 s16be I/Q pairs, 20-byte header,
    flags byte 0x08).
    """

    def __init__(self, host: str, port: int, freq_khz: float = 14_100.0,
                 mode: str = "usb",
                 on_audio: Optional[Callable] = None,
                 on_iq: Optional[Callable] = None):
        self.host, self.port = host, int(port)
        self.freq_khz = float(freq_khz)
        self.mode = mode
        self.on_audio = on_audio
        self.on_iq = on_iq
        self.status = "disconnected"
        self.packets = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ws: Optional[WSClient] = None

    def _mod_command(self) -> str:
        """The SET mod=… line for the current mode/freq (kiwisdr.h:193-204)."""
        if self.mode == "iq":
            return (f"SET mod=iq low_cut=-7000 high_cut=7000 "
                    f"freq={self.freq_khz:0.3f}")
        return (f"SET mod={self.mode} low_cut=300 high_cut=2700 "
                f"freq={self.freq_khz:0.3f}")

    def tune(self, freq_hz: float):
        """Retune the remote receiver (kiwisdr_source main.cpp:234-238)."""
        self.freq_khz = float(freq_hz) / 1000.0
        ws = self._ws
        if ws is not None and self.status in ("connected", "receiving"):
            try:
                ws.send_text(self._mod_command())
            except OSError:
                pass

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._ws is not None:
            self._ws.close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self):
        try:
            path = f"/kiwi/{int(time.time() * 1000)}/SND"
            ws = WSClient(self.host, self.port, path)
            self._ws = ws
            # kiwisdr.h:53-65 handshake
            ws.send_text("SET auth t=kiwi p=#")
            ws.send_text(f"SET AR OK in={IQDATA_FREQUENCY} out=48000")
            ws.send_text("SERVER DE CLIENT sdr++brown SND")
            ws.send_text("SET compression=0")
            ws.send_text("SET agc=0 hang=0 thresh=-100 slope=6 "
                         "decay=1000 manGain=50")
            ws.send_text(self._mod_command())
            self.status = "connected"
            last_keepalive = time.monotonic()
            while not self._stop.is_set():
                op, payload = ws.recv_message()
                if op == 8:
                    break
                tag = payload[:3].decode(errors="replace")
                if tag == "SND" and len(payload) >= 10:
                    # header sizes INCLUDE the 3-byte tag
                    # (kiwisdr.h:97-99: REAL=10, IQ=20)
                    if len(payload) == 1024 + 10:          # REAL data
                        raw = np.frombuffer(payload[10:], ">i2")
                        audio = raw.astype(np.float32) / 32767.0
                        self.packets += 1
                        self.status = "receiving"
                        if self.on_audio:
                            self.on_audio(audio)
                    elif (len(payload) == 2048 + 20
                          and payload[3] == 0x08):         # IQ data
                        raw = np.frombuffer(payload[20:], ">i2") \
                            .astype(np.float32) / 32767.0
                        iq = (raw[0::2] + 1j * raw[1::2]) \
                            .astype(np.complex64)
                        self.packets += 1
                        self.status = "receiving"
                        if self.on_iq:
                            self.on_iq(iq)
                if time.monotonic() - last_keepalive > 5.0:
                    ws.send_text("SET keepalive")
                    last_keepalive = time.monotonic()
        except (OSError, ConnectionError) as e:
            self.status = f"error: {e}"
        finally:
            if self._ws is not None:
                self._ws.close()
            if self.status.startswith(("connected", "receiving")):
                self.status = "disconnected"
