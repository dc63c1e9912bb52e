"""Waterfall data model: raw FFT line ring, zoomed view, SNR taps (a copy
of sdrplusplusbrown_tpu/models/waterfall.py; numpy on the host lines).

reference: core/src/gui/widgets/waterfall.cpp — the fork's tiled GPU
waterfall is UI, but its *data products* are framework responsibilities:
the raw dB line ring pushed from the DSP thread (pushFFT), the zoomed
view (max-aggregation of raw bins into view bins, doZoom), latest-line
access for the scanner (acquireLatestFFT), and the per-VFO SNR estimate
(calculateVFOSignalInfo — implemented in ops/spectrum.py).
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np

from ..ops.spectrum import calculate_vfo_signal_info


class Waterfall:
    def __init__(self, fft_size: int, history: int = 512):
        self.fft_size = int(fft_size)
        self.history = int(history)
        self._lines = np.full((history, fft_size), -300.0, np.float32)
        self._count = 0
        self._pos = 0
        self._mtx = threading.Lock()

    def push_fft(self, line_db: np.ndarray):
        """DSP-side: append one raw dB line (reference pushFFT)."""
        line_db = np.asarray(line_db, np.float32)
        assert line_db.shape == (self.fft_size,)
        with self._mtx:
            self._lines[self._pos] = line_db
            self._pos = (self._pos + 1) % self.history
            self._count += 1

    def latest(self) -> Optional[np.ndarray]:
        with self._mtx:
            if self._count == 0:
                return None
            return self._lines[(self._pos - 1) % self.history].copy()

    def lines(self, n: int) -> np.ndarray:
        """Last ``n`` lines, newest last."""
        with self._mtx:
            n = min(n, min(self._count, self.history))
            idx = (self._pos - n + np.arange(n)) % self.history
            return self._lines[idx].copy()

    # ------------------------------------------------------------------
    def zoom(self, view_offset_hz: float, view_bw_hz: float,
             samplerate: float, out_bins: int,
             line: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """Max-aggregate raw bins into ``out_bins`` view bins over
        [offset−bw/2, offset+bw/2] (reference doZoom semantics: peak
        hold within each view bin so narrow carriers stay visible)."""
        if line is None:
            line = self.latest()
        if line is None:
            return None
        n = self.fft_size
        lo_f = view_offset_hz - view_bw_hz / 2.0
        edges = ((lo_f + np.arange(out_bins + 1) * (view_bw_hz / out_bins))
                 / samplerate + 0.5) * n
        edges = np.clip(edges.astype(int), 0, n)
        out = np.full(out_bins, -300.0, np.float32)
        for i in range(out_bins):
            a, b = edges[i], max(edges[i + 1], edges[i] + 1)
            if a < n:
                out[i] = line[a:b].max()
        return out

    def vfo_signal_info(self, center_offset: float, bandwidth: float,
                        samplerate: float) -> Optional[Tuple[float, float]]:
        line = self.latest()
        if line is None:
            return None
        return calculate_vfo_signal_info(line, center_offset, bandwidth,
                                         samplerate)
