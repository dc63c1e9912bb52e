"""rigctl client (a copy of sdrplusplusbrown_tpu/server/rigctl_client.py)
— drive an external (or our own) rig over the hamlib
NET rigctl protocol (reference: misc_modules/rigctl_client, used to keep
an external transceiver tuned in sync with the SDR)."""

from __future__ import annotations

import socket
from typing import Tuple


class RigctlClient:
    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""

    def _cmd(self, line: str, nlines: int = 1):
        self.sock.sendall((line + "\n").encode())
        out = []
        while len(out) < nlines:
            while b"\n" not in self._buf:
                data = self.sock.recv(1024)
                if not data:
                    raise ConnectionError("rigctl server closed")
                self._buf += data
            ln, self._buf = self._buf.split(b"\n", 1)
            out.append(ln.decode())
        return out

    def set_frequency(self, hz: float) -> bool:
        return self._cmd(f"F {hz:.0f}")[0] == "RPRT 0"

    def get_frequency(self) -> float:
        return float(self._cmd("f")[0])

    def set_mode(self, mode: str, passband: int = 0) -> bool:
        return self._cmd(f"M {mode} {passband}")[0] == "RPRT 0"

    def get_mode(self) -> Tuple[str, int]:
        mode, bw = self._cmd("m", nlines=2)
        return mode, int(bw)

    def set_ptt(self, on: bool) -> bool:
        return self._cmd(f"T {1 if on else 0}")[0] == "RPRT 0"

    def get_ptt(self) -> bool:
        return self._cmd("t")[0].strip() == "1"

    def close(self):
        try:
            self.sock.sendall(b"q\n")
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
