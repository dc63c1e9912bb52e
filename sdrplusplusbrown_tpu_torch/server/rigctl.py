"""Hamlib rigctl-protocol server (counterpart of
sdrplusplusbrown_tpu/server/rigctl.py; host code over the app) — CAT
control for loggers/digital-mode apps.
apps.

reference: misc_modules/rigctl_server — a TCP text protocol speaking the
hamlib NET rigctl dialect: ``F <hz>`` set frequency, ``f`` get,
``M <mode> <passband>`` set mode, ``m`` get, ``T 0|1`` PTT, ``t`` get
PTT, ``\\dump_state``, ``q`` quit.  Set commands answer ``RPRT 0``.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional

from ..utils.flog import flog

# hamlib mode names ↔ our demod names
MODE_MAP = {"FM": "NFM", "WFM": "WFM", "AM": "AM", "USB": "USB",
            "LSB": "LSB", "CW": "CW", "DSB": "DSB", "PKTUSB": "USB",
            "PKTLSB": "LSB", "RAW": "RAW"}
MODE_BACK = {"NFM": "FM", "WFM": "WFM", "AM": "AM", "USB": "USB",
             "LSB": "LSB", "CW": "CW", "DSB": "DSB", "RAW": "RAW"}

DUMP_STATE = """0
2
2
150000.000000 1500000000.000000 0x1ff -1 -1 0x10000003 0x3
0 0 0 0 0 0 0
0 0 0 0 0 0 0
0x1ff 1
0x1ff 0
0 0
0x1e 2400
0x2 500
0x1 8000
0x1 2400
0x20 15000
0x20 8000
0x40 230000
0 0
9990
9990
10000
0
10
10 20 30
0x3effffff
0x3effffff
0x7fffffff
0x7fffffff
0x7fffffff
0x7fffffff
done
"""


class RigctlServer:
    def __init__(self, app, port: int = 4532, host: str = "127.0.0.1",
                 vfo_module: str = "Radio"):
        self.app = app
        self.vfo_module = vfo_module
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(4)
        self.port = self._listener.getsockname()[1]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._accept, daemon=True)
        self._thread.start()
        flog.info("rigctl server on port {}", self.port)

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

    def _accept(self):
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._client, args=(sock,),
                             daemon=True).start()

    # ------------------------------------------------------------------
    def _radio(self):
        m = self.app.modules.get(self.vfo_module)
        return m if m is not None and m.module_type() == "radio" else None

    def _handle(self, line: str) -> Optional[str]:
        line = line.strip()
        if not line:
            return None
        if line in ("q", "Q"):
            return "__quit__"
        if line.startswith("\\dump_state"):
            return DUMP_STATE
        cmd, *args = line.split()
        m = self._radio()
        if cmd == "F" and args:
            try:
                self.app.tune(float(args[0]))
                return "RPRT 0\n"
            except ValueError:
                return "RPRT -1\n"
        if cmd == "f":
            return f"{self.app.frequency:.6f}\n"
        if cmd == "M" and args:
            name = MODE_MAP.get(args[0].upper())
            if name is None or m is None:
                return "RPRT -9\n"
            r = m.handle_debug_command("set_demod", name)
            return "RPRT 0\n" if r.get("status") == "ok" else "RPRT -1\n"
        if cmd == "m":
            if m is None:
                return "RPRT -9\n"
            name = MODE_BACK.get(m.radio.demod_name, m.radio.demod_name)
            return f"{name}\n{int(m.bandwidth)}\n"
        if cmd == "T" and args:
            tx = self.app.transmitter
            if tx is None:
                return "RPRT -9\n"
            tx.set_ptt(args[0] == "1")
            return "RPRT 0\n"
        if cmd == "t":
            tx = self.app.transmitter
            return f"{int(tx.get_ptt()) if tx else 0}\n"
        if cmd == "V" and args:
            return "RPRT 0\n"
        if cmd == "v":
            return "VFOA\n"
        if cmd == "s":
            return "0\nVFOA\n"
        return "RPRT -11\n"     # unimplemented

    def _client(self, sock: socket.socket):
        try:
            buf = b""
            while not self._stop.is_set():
                data = sock.recv(1024)
                if not data:
                    return
                buf += data
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    resp = self._handle(line.decode(errors="replace"))
                    if resp == "__quit__":
                        return
                    if resp is not None:
                        sock.sendall(resp.encode())
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass
