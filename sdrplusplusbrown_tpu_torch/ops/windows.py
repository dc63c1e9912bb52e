"""Window functions.

Design-time (numpy, float64) implementations of the cosine-sum window family
used by the reference (reference: core/src/dsp/window/{cosine,nuttall,
blackman,hamming,hann,rectangular}.h).  Windows are evaluated with the same
``w(n, N)`` convention as the reference so that filter taps designed here
match the reference's taps to float64 accuracy:

    cosine(n, N, coefs) = sum_i (-1)^i * coefs[i] * cos(2*pi*i*n / N)

The filter designers call these with ``n`` centred/offset exactly like the
reference's windowedSinc (see ops/taps.py).
"""

from __future__ import annotations

import numpy as np

# Cosine-sum coefficient tables (reference: core/src/dsp/window/*.h).
NUTTALL = (0.355768, 0.487396, 0.144232, 0.012604)
BLACKMAN = (0.42, 0.5, 0.08)
# "blackman-harris" in the reference's iq_frontend window list is the
# 4-term minimum-sidelobe Blackman-Harris window.
BLACKMAN_HARRIS = (0.35875, 0.48829, 0.14128, 0.01168)
HAMMING = (0.54, 0.46)
HANN = (0.5, 0.5)


def cosine(n, N, coefs) -> np.ndarray:
    """Alternating-sign cosine-sum window, reference core/src/dsp/window/cosine.h."""
    n = np.asarray(n, dtype=np.float64)
    win = np.zeros_like(n)
    sign = 1.0
    for i, c in enumerate(coefs):
        win += sign * c * np.cos(i * 2.0 * np.pi * n / N)
        sign = -sign
    return win


def nuttall(n, N):
    return cosine(n, N, NUTTALL)


def blackman(n, N):
    return cosine(n, N, BLACKMAN)


def blackman_harris(n, N):
    return cosine(n, N, BLACKMAN_HARRIS)


def hamming(n, N):
    return cosine(n, N, HAMMING)


def hann(n, N):
    return cosine(n, N, HANN)


def rectangular(n, N):
    return np.ones_like(np.asarray(n, dtype=np.float64))


#: Registry used by the spectrum path (reference: core/src/signal_path/
#: iq_frontend.h FFTWindow enum: RECTANGULAR, BLACKMAN, NUTTALL).
BY_NAME = {
    "rectangular": rectangular,
    "blackman": blackman,
    "blackman_harris": blackman_harris,
    "nuttall": nuttall,
    "hamming": hamming,
    "hann": hann,
}


def fft_window(name: str, size: int) -> np.ndarray:
    """Symmetric analysis window sampled at i = 0..size-1 over N = size-1.

    This is the convention the reference uses for its FFT windows
    (e.g. reference: core/src/dsp/noise_reduction/fm_if.h initBuffers:
    ``fftWin[i] = window::nuttall(i, bins - 1)``).
    """
    i = np.arange(size, dtype=np.float64)
    return BY_NAME[name](i, size - 1)


def hanning_periodic(size: int) -> np.ndarray:
    """numpy-style ``np.hanning`` window (symmetric), as used by the logmmse
    noise reducer (reference: core/src/utils/arrays.cpp nphanning)."""
    return np.hanning(size)
