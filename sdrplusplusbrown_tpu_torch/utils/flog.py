"""Leveled logging with an optional in-memory ring served over HTTP /log
(a copy of sdrplusplusbrown_tpu/utils/flog.py; host code).

reference: core/src/utils/flog.{h,cpp} plus the SDRPP_ENABLE_MEMORY_LOG
ring (core.cpp:460-463, http_debug_server_impl.cpp:796).
"""

from __future__ import annotations

import collections
import sys
import threading
import time


class _Flog:
    LEVELS = ("debug", "info", "warn", "error")

    def __init__(self, ring_size: int = 4096):
        self.ring = collections.deque(maxlen=ring_size)
        self.level = "info"
        self._mtx = threading.Lock()
        self.echo = True

    def _log(self, level: str, msg: str, *args):
        if self.LEVELS.index(level) < self.LEVELS.index(self.level):
            return
        text = msg.format(*args) if args else msg
        line = (f"[{time.strftime('%H:%M:%S')}] "
                f"[{level.upper():5s}] {text}")
        with self._mtx:
            self.ring.append(line)
        if self.echo:
            print(line, file=sys.stderr, flush=True)

    def debug(self, msg, *args):
        self._log("debug", msg, *args)

    def info(self, msg, *args):
        self._log("info", msg, *args)

    def warn(self, msg, *args):
        self._log("warn", msg, *args)

    def error(self, msg, *args):
        self._log("error", msg, *args)

    def dump(self) -> str:
        with self._mtx:
            return "\n".join(self.ring)


flog = _Flog()
