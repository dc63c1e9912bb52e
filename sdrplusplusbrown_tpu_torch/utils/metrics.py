"""Throughput and level metrics the app reports (the part of
sdrplusplusbrown_tpu/utils/metrics.py the app uses).

reference: utils/stream_tracker.h (rolling samples/s) and
bench/peak_level_meter.h.
"""

from __future__ import annotations

import time

import numpy as np


class StreamTracker:
    """Rolling samples/s over a sliding window
    (reference utils/stream_tracker.h:8-40)."""

    def __init__(self, window_s: float = 2.0):
        self.window_s = float(window_s)
        self._events = []  # (t, n)
        self.total = 0

    def add(self, n: int):
        now = time.monotonic()
        self._events.append((now, n))
        self.total += n
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.pop(0)

    def rate(self) -> float:
        if not self._events:
            return 0.0
        now = time.monotonic()
        t0 = self._events[0][0]
        span = max(now - t0, 1e-6)
        return sum(n for _, n in self._events) / span


class PeakLevelMeter:
    """Peak + decaying level in dB (reference bench/peak_level_meter.h)."""

    def __init__(self, decay: float = 0.95):
        self.decay = float(decay)
        self.level = 0.0
        self.peak = 0.0

    def push(self, samples: np.ndarray):
        m = float(np.max(np.abs(samples))) if len(samples) else 0.0
        self.peak = max(self.peak, m)
        self.level = max(m, self.level * self.decay)

    def level_db(self) -> float:
        return 20.0 * np.log10(max(self.level, 1e-10))
