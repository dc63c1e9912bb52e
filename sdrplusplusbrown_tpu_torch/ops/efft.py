"""Experimental FFT (EFFT) lossy baseband compression (a copy of
sdrplusplusbrown_tpu/ops/efft.py; host numpy, frame for frame the same).

reference: core/src/dsp/compression/experimental_fft_compressor.h (612 LoC)
— the fork's bandwidth-saving trick for remote SDR links: 50 ms FFT
frames; a noise-floor estimate from the moving variance of the (Blackman-)
windowed spectrum; every bin that does not rise above floor+allowance is
zeroed (except explicitly masked VFO regions), making the zero-heavy
spectrum compress extremely well; amplitudes are ∜-companded for int8
quantization.  The decompressor re-expands and inverse-FFTs.

This transport stage runs host-side (numpy): it processes ~20 tiny frames
per second next to the socket — the heavy DSP stays on-device.  Structure
follows the reference's filterSignal (fft_compressor.h:118-179) with its
queue of ``minRecents=10`` frames for spectrum averaging and one-frame-
delayed emission.
"""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np


def centered_sma(x: np.ndarray, w: int) -> np.ndarray:
    """Centered moving average with edge-clamped counts."""
    w = max(int(w), 1)
    k = np.ones(w)
    s = np.convolve(x, k, mode="same")
    c = np.convolve(np.ones_like(x), k, mode="same")
    return s / c


def moving_variance(x: np.ndarray, w: int) -> np.ndarray:
    """SMA((x − SMA(x))²) — the reference's definition
    (arrays.cpp movingVariance), which reports ~zero on smooth slopes
    where the E[x²]−E[x]² form would report slope-induced spread."""
    m = centered_sma(x, w)
    d = x - m
    return centered_sma(d * d, w)


def interpolate_holes(a: np.ndarray) -> np.ndarray:
    """Linear interpolation across zero-valued holes, clamped edges
    (reference arrays.cpp:433-469)."""
    nz = np.flatnonzero(a)
    if len(nz) == 0:
        return a
    idx = np.arange(len(a))
    return np.interp(idx, nz, a[nz])


def blackman(i, N):
    return (0.42 - 0.5 * np.cos(2 * np.pi * i / (N - 1))
            + 0.08 * np.cos(4 * np.pi * i / (N - 1)))


class EFFTCompressor:
    MIN_RECENTS = 10
    NOISE_NPOINTS = 16
    SIGNAL_WIDTH = 300.0  # Hz

    def __init__(self, samplerate: float, slice_msec: int = 50,
                 loss_rate: float = 4.0):
        # loss_rate scales the over-floor allowance (reference default 1.0
        # relies on the unaligned-floor slack; with the aligned floor,
        # 4.0 ≈ "zero everything below ~4 dB over the noise floor" and
        # blanks >80 % of bins on a quiet band while keeping carriers)
        self.samplerate = float(samplerate)
        fft_size = int(samplerate * slice_msec / 1000)
        self.fft_size = 1 << int(np.floor(np.log2(fft_size)))
        n = self.fft_size
        # reference uses blackman(i+5, N+10) to avoid exact zeros at edges
        self.window = blackman(np.arange(n) + 5, n + 10)
        self.hz_tick = self.samplerate / n
        self.small_tick = max(int(self.SIGNAL_WIDTH / self.hz_tick), 1)
        self.large_tick = self.small_tick * 10
        # the reference estimates the noise floor from the *windowed*
        # spectrum but thresholds the *unwindowed* magnitudes against it
        # (fft_compressor.h:152-156), leaving a ~10·log10(mean(w²)) scale
        # gap that users must absorb into lossRate; we align the floor so
        # loss_rate = 1.0 means "at the measured noise variance".
        self.window_power_db = float(10.0 * np.log10(
            np.mean(self.window ** 2)))
        self.loss_rate = float(loss_rate)
        self.masked_frequencies: List[int] = []   # [from, to, from, to...]
        self.tx_mode = False
        self.prev_allowance = 0.0
        self._clean_freq: deque = deque(maxlen=self.MIN_RECENTS)
        self._clean_mag: deque = deque(maxlen=self.MIN_RECENTS)
        self._win_mag: deque = deque(maxlen=self.MIN_RECENTS)
        self._residue = np.zeros(0, np.complex64)
        self.noise_figure: List[float] = []

    # ------------------------------------------------------------------
    def set_masked_frequencies(self, ranges: List[int]):
        self.masked_frequencies = list(ranges)

    def _db(self, spec: np.ndarray) -> np.ndarray:
        n = self.fft_size
        p = (np.abs(spec) ** 2) / (n * n)
        return 10.0 * np.log10(np.maximum(p, 1e-30))

    def _filter_signal(self, wmags, cmags, frame):
        n = self.fft_size
        mvar = moving_variance(wmags, self.NOISE_NPOINTS)
        new_allow = self.loss_rate * np.percentile(mvar, 15)
        allowance = new_allow * 0.1 + self.prev_allowance * 0.9
        self.prev_allowance = allowance

        cma = centered_sma(wmags, self.large_tick)
        cma = np.where(mvar > allowance, 0.0, cma)
        cma = interpolate_holes(cma)
        cma = centered_sma(cma, self.large_tick)
        cmax = centered_sma(cma, 5 * self.large_tick)
        diff = np.abs(cma - cmax)
        cmax_allow = np.percentile(diff, 15)
        cma = np.where(diff > cmax_allow, 0.0, cma)
        cma = interpolate_holes(cma)
        cma = centered_sma(cma, self.large_tick)

        mask = np.zeros(n)
        if not self.tx_mode:
            floor = cma - self.window_power_db   # align to unwindowed scale
            mask[cmags > floor + allowance] = 1.0
        mf = self.masked_frequencies
        for i in range(0, len(mf) - 1, 2):
            t0 = int(n / 2 + mf[i] / self.hz_tick)
            t1 = int(n / 2 + mf[i + 1] / self.hz_tick)
            mask[max(t0, 0):max(min(t1, n), 0)] = 1.0
        mask = centered_sma(mask, max(int(self.SIGNAL_WIDTH / 8), 1))
        frame[mask == 0.0] = 0.0
        return cma

    def _estimate_noise(self, floor_db: np.ndarray) -> List[float]:
        nslices = 30
        sl = self.fft_size // nslices
        return [7.0 + float(floor_db[i * sl + sl // 2])
                for i in range(nslices)]

    # ------------------------------------------------------------------
    def process(self, x: np.ndarray) -> List[np.ndarray]:
        """Push samples; emit a list of masked+companded spectrum frames
        (complex64 [fft_size], DC-centered).  Each output frame lags
        MIN_RECENTS-1 input frames (the reference's averaging queue)."""
        n = self.fft_size
        buf = np.concatenate([self._residue, x])
        out = []
        pos = 0
        while len(buf) - pos >= n:
            frame = buf[pos:pos + n]
            pos += n
            spec = np.fft.fftshift(np.fft.fft(frame))
            self._clean_freq.append(spec.astype(np.complex64))
            self._clean_mag.append(self._db(spec))
            wspec = np.fft.fftshift(np.fft.fft(frame * self.window))
            self._win_mag.append(self._db(wspec))
            if len(self._clean_freq) < self.MIN_RECENTS:
                continue
            emit = self._clean_freq[0].copy()
            wavg = np.mean(self._win_mag, axis=0)
            cavg = np.mean(self._clean_mag, axis=0)
            if self.loss_rate > 0:
                nf = self._filter_signal(wavg, cavg, emit)
                if not self.tx_mode:
                    self.noise_figure = self._estimate_noise(nf)
            # ∜ amplitude companding for int8 scaling
            amp = np.abs(emit)
            nzm = amp > 0
            emit[nzm] *= (amp[nzm] ** 0.25) / amp[nzm]
            out.append(emit)
        self._residue = buf[pos:]
        return out


class EFFTDecompressor:
    """Inverse: re-expand the ∜ companding and inverse-FFT each frame
    (reference: experimental_fft_decompressor.h)."""

    def __init__(self, fft_size: int):
        self.fft_size = int(fft_size)

    def process(self, frames: List[np.ndarray]) -> np.ndarray:
        out = []
        for f in frames:
            f = np.asarray(f, np.complex64).copy()
            amp = np.abs(f)
            nzm = amp > 0
            f[nzm] *= (amp[nzm] ** 4) / amp[nzm]
            td = np.fft.ifft(np.fft.ifftshift(f))
            out.append(td.astype(np.complex64))
        if not out:
            return np.zeros(0, np.complex64)
        return np.concatenate(out)
