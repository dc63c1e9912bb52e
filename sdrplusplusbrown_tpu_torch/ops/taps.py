"""FIR filter tap designers (design-time, numpy float64).

Re-implements the reference's windowed-sinc tap design so filters built here
are numerically interchangeable with the reference's:

  * tap-count rule  taps ~= 3.8 * samplerate / transitionWidth
    (reference: core/src/dsp/taps/estimate_tap_count.h:4-6)
  * windowed sinc with Nuttall window and half-sample-centred time grid
    (reference: core/src/dsp/taps/windowed_sinc.h:8-39)
  * lowPass / highPass / bandPass (real symmetric & complex asymmetric)
    (reference: core/src/dsp/taps/{low_pass,high_pass,band_pass}.h)
  * root-raised-cosine for digital demods
    (reference: core/src/dsp/taps/root_raised_cosine.h)

Taps are float64 numpy arrays; runtime kernels cast to float32 on device.
Note on orientation: the reference applies taps as a *correlation*
(out[i] = sum_k buf[i+k]*taps[k], reference: core/src/dsp/filter/fir.h:64-92);
all runtime kernels in ops/fir.py use the same convention, so asymmetric
(complex band-pass) taps are generated pre-flipped exactly like the
reference does ("the offset is negative to flip the taps",
reference: core/src/dsp/taps/band_pass.h).
"""

from __future__ import annotations

import numpy as np

from . import windows


def estimate_tap_count(trans_width: float, samplerate: float) -> int:
    """reference: core/src/dsp/taps/estimate_tap_count.h:4-6 (int truncation)."""
    return int(3.8 * samplerate / trans_width)


def hz_to_rads(freq: float, samplerate: float) -> float:
    return 2.0 * np.pi * (freq / samplerate)


def _sinc(x: np.ndarray) -> np.ndarray:
    """sin(x)/x with sinc(0)=1 — the unnormalised sinc the reference uses."""
    return np.sinc(np.asarray(x, dtype=np.float64) / np.pi)


def windowed_sinc(count: int, omega: float, window=windows.nuttall,
                  norm: float = 1.0) -> np.ndarray:
    """Real windowed-sinc prototype, reference windowed_sinc.h:8-33.

    t = i - count/2 + 0.5 ; tap[i] = sinc(t*omega) * window(t - count/2, count)
    * (norm * omega / pi).
    """
    half = count / 2.0
    corr = norm * omega / np.pi
    i = np.arange(count, dtype=np.float64)
    t = i - half + 0.5
    return _sinc(t * omega) * window(t - half, count) * corr


def windowed_sinc_hz(count: int, cutoff: float, samplerate: float,
                     window=windows.nuttall, norm: float = 1.0) -> np.ndarray:
    return windowed_sinc(count, hz_to_rads(cutoff, samplerate), window, norm)


def low_pass(cutoff: float, trans_width: float, samplerate: float,
             odd_tap_count: bool = False) -> np.ndarray:
    """reference: core/src/dsp/taps/low_pass.h:7-17."""
    count = estimate_tap_count(trans_width, samplerate)
    if odd_tap_count and count % 2 == 0:
        count += 1
    count = max(count, 1)
    return windowed_sinc_hz(count, cutoff, samplerate, windows.nuttall)


def high_pass(cutoff: float, trans_width: float, samplerate: float,
              odd_tap_count: bool = False) -> np.ndarray:
    """reference: core/src/dsp/taps/high_pass.h:8-16 — lowpass at
    (fs/2 - cutoff) with alternating-sign modulation folded into the window."""
    count = estimate_tap_count(trans_width, samplerate)
    if odd_tap_count and count % 2 == 0:
        count += 1
    count = max(count, 1)
    half = count / 2.0
    omega = hz_to_rads(samplerate / 2.0 - cutoff, samplerate)
    corr = omega / np.pi
    i = np.arange(count, dtype=np.float64)
    t = i - half + 0.5
    n = t - half
    # C++ round() is half-away-from-zero (n always has .5 fraction here)
    r = np.where(n > 0, np.floor(n) + 1, np.ceil(n) - 1).astype(np.int64)
    sign = np.where(r % 2 != 0, -1.0, 1.0)
    return _sinc(t * omega) * windows.nuttall(n, count) * sign * corr


def band_pass_real(band_start: float, band_stop: float, trans_width: float,
                   samplerate: float, odd_tap_count: bool = False) -> np.ndarray:
    """Real symmetric band-pass, reference band_pass.h (float branch):
    lowpass of half-bandwidth modulated by 2*cos(offsetOmega*n)."""
    assert band_stop > band_start
    offset_omega = hz_to_rads((band_start + band_stop) / 2.0, samplerate)
    count = estimate_tap_count(trans_width, samplerate)
    if odd_tap_count and count % 2 == 0:
        count += 1
    half = count / 2.0
    omega = hz_to_rads((band_stop - band_start) / 2.0, samplerate)
    corr = omega / np.pi
    i = np.arange(count, dtype=np.float64)
    t = i - half + 0.5
    n = t - half
    mod = 2.0 * np.cos(offset_omega * n)
    return _sinc(t * omega) * mod * windows.nuttall(n, count) * corr


def band_pass_complex(band_start: float, band_stop: float, trans_width: float,
                      samplerate: float, odd_tap_count: bool = False) -> np.ndarray:
    """Complex asymmetric band-pass, reference band_pass.h (complex branch):
    lowpass modulated by exp(-j*offsetOmega*n); negative sign pre-flips the
    taps for the correlation convention."""
    assert band_stop > band_start
    offset_omega = hz_to_rads((band_start + band_stop) / 2.0, samplerate)
    count = estimate_tap_count(trans_width, samplerate)
    if odd_tap_count and count % 2 == 0:
        count += 1
    half = count / 2.0
    omega = hz_to_rads((band_stop - band_start) / 2.0, samplerate)
    corr = omega / np.pi
    i = np.arange(count, dtype=np.float64)
    t = i - half + 0.5
    n = t - half
    mod = np.exp(-1j * offset_omega * n)
    return (_sinc(t * omega) * windows.nuttall(n, count) * corr) * mod


def root_raised_cosine(count: int, beta: float, Ts: float) -> np.ndarray:
    """Root-raised-cosine pulse for digital demods (RDS BPSK clock shaping).
    Standard closed form; reference: core/src/dsp/taps/root_raised_cosine.h.
    ``Ts`` is samples-per-symbol, ``beta`` the roll-off."""
    t = np.arange(count, dtype=np.float64) - (count - 1) / 2.0
    h = np.zeros(count, dtype=np.float64)
    for idx, ti in enumerate(t):
        if abs(ti) < 1e-12:
            h[idx] = (1.0 + beta * (4.0 / np.pi - 1.0)) / Ts
        elif abs(abs(ti) - Ts / (4.0 * beta)) < 1e-9:
            h[idx] = (beta / (Ts * np.sqrt(2.0))) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            num = (np.sin(np.pi * ti / Ts * (1 - beta))
                   + 4 * beta * ti / Ts * np.cos(np.pi * ti / Ts * (1 + beta)))
            den = np.pi * ti / Ts * (1 - (4 * beta * ti / Ts) ** 2)
            h[idx] = num / den / Ts
    return h / np.sqrt(np.sum(h ** 2))
