"""Spectrum path: keep/skip framing, windowed FFT → dB power (counterpart
of sdrplusplusbrown_tpu/ops/spectrum.py).

  * framing parameters — IQFrontEnd::genReshapeParams
    (reference signal_path/iq_frontend.h:88-92);
  * window with the alternating-sign DC-centering factor
    (reference iq_frontend.cpp:304-311);
  * 10·log10(|X|²/N²) (reference iq_frontend.cpp:282).

``SpectrumPath.apply`` frames a complex block as the reshaper does, at
exactly f·interval (kernel K4f, the JAX package's ``spectrum_path_db``
route), and (xr, xi) float32 planes as the TPU front-end kernel path
does, at rup(f·interval, 1024) (kernel K4); ops/fft_kernel.py.
``calculate_vfo_signal_info`` is the app's per-VFO SNR estimate on one
dB line, on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..runtime.block import Block, entry_device
from . import windows


def gen_reshape_params(samplerate: float, fft_size: int,
                       fft_rate: float) -> Tuple[int, int]:
    """(nz_samp_count, skip) — reference iq_frontend.h:88-92."""
    fft_interval = int(round(samplerate / fft_rate))
    nz = min(fft_interval, fft_size)
    return nz, fft_interval - nz


class Reshaper(Block):
    """Keep/skip framing parameters: frames of ``keep`` samples every
    ``keep + skip``."""

    def __init__(self, keep: int, skip: int):
        self.keep = int(keep)
        self.skip = int(skip)
        self.interval = self.keep + self.skip
        self.in_multiple = self.interval


def make_fft_window(name: str, nz_size: int) -> np.ndarray:
    """Window including the (−1)^i DC-centering factor."""
    w = windows.fft_window(name, nz_size)
    signs = np.where(np.arange(nz_size) % 2 == 1, -1.0, 1.0)
    return (w * signs).astype(np.float32)


class SpectrumPath(Block):
    """Wideband block → [n_frames, fft_size] dB spectra at ``fft_rate`` Hz
    (defaults 65536 bins @ 20 fps Nuttall, reference core.cpp:559-561).
    An entry point: it runs on ``device`` (CUDA unless the caller asks for
    the CPU), keeps its window there and moves only the input to it."""

    def __init__(self, samplerate: float, fft_size: int = 65536,
                 fft_rate: float = 20.0, window: str = "nuttall",
                 device="cuda"):
        self.samplerate = float(samplerate)
        self.device = torch.device(device)
        nz, skip = gen_reshape_params(samplerate, fft_size, fft_rate)
        self.reshaper = Reshaper(nz, skip)
        self.window = make_fft_window(window, nz)
        self.floor_db = -300.0       # dB floor of an empty bin
        self.fft_size = int(fft_size)
        self.in_multiple = self.reshaper.in_multiple
        self._dev_window = None

    def apply(self, params, state, x):
        """x: a complex [T] block (frames at f·interval, K4f) or (xr, xi)
        float32 [T] planes (frames at rup(f·interval, 1024), K4) →
        ([n_frames, fft_size] dB, state)."""
        from .fft_kernel import spectrum_frames_db, spectrum_path_db
        dev = entry_device(self.device)
        if self._dev_window is None:
            self._dev_window = torch.from_numpy(self.window).to(dev)
        args = (self.reshaper.keep, self.reshaper.interval, self.fft_size,
                self.floor_db, self._dev_window)
        if not isinstance(x, tuple):
            x = x.to(dev, torch.complex64).contiguous()
            return spectrum_path_db(x, *args), state
        xr, xi = (p.to(dev, torch.float32).contiguous() for p in x)
        return spectrum_frames_db(xr, xi, *args), state


# ----------------------------------------------------------------------
# Host-side per-VFO SNR estimator (the JAX package's, numpy on one dB
# line; it runs at fft_rate on tiny data, on the host like the
# reference's GUI-thread implementation).

def raw_fft_index(freq: float, samplerate: float, fft_size: int) -> int:
    """Bin index of ``freq`` (Hz, relative to center) in a DC-centered
    spectrum — truncating and clamped like the reference's rawFFTIndex
    (waterfall.cpp)."""
    idx = int((freq / samplerate + 0.5) * fft_size)
    return max(0, min(idx, fft_size))


def calculate_vfo_signal_info(fft_line_db: np.ndarray, center_offset: float,
                              bandwidth: float, samplerate: float):
    """(strength, snr) in dB — reference waterfall.cpp:688-756."""
    fft_line_db = np.asarray(fft_line_db)
    n = fft_line_db.shape[-1]
    lo_side = raw_fft_index(center_offset - bandwidth, samplerate, n)
    lo = raw_fft_index(center_offset - bandwidth / 2.0, samplerate, n)
    hi = raw_fft_index(center_offset + bandwidth / 2.0, samplerate, n)
    hi_side = raw_fft_index(center_offset + bandwidth, samplerate, n)
    if min(lo_side, lo, hi, hi_side) < 0 or hi_side >= n:
        return None
    side = np.concatenate([fft_line_db[..., lo_side:lo],
                           fft_line_db[..., hi + 1:hi_side]], axis=-1)
    if side.shape[-1] == 0:
        return None
    avg = side.mean(axis=-1)
    svals = np.sort(side, axis=-1)
    lower = side.shape[-1] // 4
    if lower <= 0:
        return None
    kth = svals[..., lower:lower + 1]
    mask = side <= kth
    qavg = np.sum(np.where(mask, side, 0.0), axis=-1) / lower
    avgdiff = avg - qavg
    mx = fft_line_db[..., lo:hi + 1].max(axis=-1)
    strength = mx - avgdiff
    snr = mx - avg - avgdiff
    return strength, snr
