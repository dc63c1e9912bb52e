"""Scanner — frequency stepping with level detection (counterpart of
sdrplusplusbrown_tpu/modules/scanner.py).

reference: misc_modules/scanner/src/main.cpp:16-250 — a 10 Hz worker steps
the selected VFO by ``interval`` between ``startFreq`` and ``stopFreq``;
at each step the max spectrum level inside the VFO passband (scaled by
passbandRatio) is compared to ``level``; above level → "receiving" until
the signal stays quiet for ``lingerTime``; direction reverses at band
edges; ``tuningTime`` debounces retunes.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from ..app import ModuleInstance
from ..ops.spectrum import raw_fft_index
from ..utils.flog import flog


class ScannerModule(ModuleInstance):
    def __init__(self, name: str, app, vfo: str = "Radio",
                 start_freq: float = -100e3, stop_freq: float = 100e3,
                 interval: float = 25e3, level: float = -50.0,
                 passband_ratio: float = 10.0, tuning_time_ms: int = 250,
                 linger_time_ms: int = 1000):
        super().__init__(name)
        self.app = app
        self.vfo = vfo
        self.start_freq = float(start_freq)   # offsets relative to center
        self.stop_freq = float(stop_freq)
        self.interval = float(interval)
        self.level = float(level)
        self.passband_ratio = float(passband_ratio)
        self.tuning_time = tuning_time_ms / 1000.0
        self.linger_time = linger_time_ms / 1000.0
        self.current = self.start_freq
        self.scan_up = True
        self.receiving = False
        self.running = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._mtx = threading.Lock()
        self._last_signal = 0.0

    def module_type(self) -> str:
        return "scanner"

    # ------------------------------------------------------------------
    def _max_level(self, freq: float, width: float) -> float:
        spec = self.app.last_spectrum
        if spec is None:
            return -np.inf
        sr = self.app.frontend.effective_sr
        n = len(spec)
        lo = raw_fft_index(freq - width / 2, sr, n)
        hi = raw_fft_index(freq + width / 2, sr, n)
        lo, hi = max(lo, 0), min(hi, n - 1)
        if hi <= lo:
            return -np.inf
        return float(np.max(spec[lo:hi + 1]))

    def _vfo_width(self) -> float:
        m = self.app.modules.get(self.vfo)
        return getattr(m, "bandwidth", 12500.0) or 12500.0

    def _worker(self):
        while not self._stop.wait(0.1):          # 10 Hz loop
            with self._mtx:
                vfow = self._vfo_width()
                now = time.monotonic()
                if self.receiving:
                    if self._max_level(self.current, vfow) >= self.level:
                        self._last_signal = now
                    elif now - self._last_signal > self.linger_time:
                        self.receiving = False
                    continue
                # seek in scan direction, then the other
                if self._seek(self.scan_up, vfow) or \
                        self._seek(not self.scan_up, vfow):
                    continue
                step = self.interval if self.scan_up else -self.interval
                self.current += step
                if self.current > self.stop_freq:
                    self.current = self.start_freq
                if self.current < self.start_freq:
                    self.current = self.stop_freq
                self.app.set_vfo_offset(self.vfo, self.current)

    def _seek(self, up: bool, vfow: float) -> bool:
        step = self.interval if up else -self.interval
        freq = self.current + step
        pw = vfow * self.passband_ratio * 0.01
        while self.start_freq <= freq <= self.stop_freq:
            if self._max_level(freq, pw) >= self.level:
                self.current = freq
                self.receiving = True
                self._last_signal = time.monotonic()
                self.scan_up = up
                self.app.set_vfo_offset(self.vfo, freq)
                flog.info("scanner[{}]: signal at offset {}", self.name,
                          freq)
                return True
            freq += step
        return False

    # ------------------------------------------------------------------
    def start(self):
        if self.running:
            return
        self.running = True
        self._stop.clear()
        self.current = self.start_freq
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def stop(self):
        if not self.running:
            return
        self.running = False
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3)
            self._thread = None

    def shutdown(self):
        self.stop()

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "start":
            self.start()
            return {"status": "ok", "running": True}
        if cmd == "stop":
            self.stop()
            return {"status": "ok", "running": False}
        if cmd == "status":
            return {"running": self.running, "current": self.current,
                    "receiving": self.receiving, "level": self.level}
        if cmd == "configure":
            try:
                kv = dict(p.split("=") for p in args.split() if "=" in p)
                for k in ("start_freq", "stop_freq", "interval", "level",
                          "passband_ratio"):
                    if k in kv:
                        setattr(self, k, float(kv[k]))
                return {"status": "ok"}
            except ValueError:
                return {"error": f"bad args: '{args}'"}
        return super().handle_debug_command(cmd, args)
