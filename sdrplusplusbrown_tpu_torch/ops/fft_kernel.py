"""Framed power spectrum — kernel K4 and its plain version (counterpart of
the spectrum kernels of sdrplusplusbrown_tpu/ops/pallas_fft.py).

Frame f covers [rup(f·interval, 1024), +keep) of the wideband planes — the
TPU kernel path's frame starts, a ≤1023-sample shift from the reshaper's
f·interval — windowed (the window includes the (−1)^i DC-centering
factor), zero-padded to ``fft_size`` and returned as
10·log10(max(|X|²/N², floor)) in natural bin order, [n_frames, fft_size].

Dispatch follows the input: CPU tensors run ``spectrum_frames_db_ref``
(torch.fft), CUDA tensors launch ``spectrum_frames_db_kernel``
(csrc/spectrum_fft.cu: a 4-step N1·N2 FFT in two launches) or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build

LANES = 16       # short FFTs per block (csrc/spectrum_fft.cu)
MAX_N12 = 256    # longest short FFT the kernel holds in shared memory


def frame_starts(T: int, keep: int, interval: int) -> list:
    """Start of every frame in a block of T samples; raises when the last
    frame would run past the block."""
    n = T // interval
    starts = [(f * interval + 1023) // 1024 * 1024 for f in range(n)]
    if n < 1 or starts[-1] + keep > T:
        raise ValueError(f"spectrum frames of {keep} every {interval} do not "
                         f"fit a block of {T}")
    return starts


def _check(xr, xi, keep, interval, fft_size, window):
    T = xr.shape[-1]
    if xr.dim() != 1 or xi.shape != xr.shape:
        raise ValueError("xr/xi must be 1-D planes of one length")
    if keep > fft_size or (window is not None and window.shape != (keep,)):
        raise ValueError("window must have ``keep`` <= fft_size samples")
    return frame_starts(T, keep, interval)


def spectrum_frames_db_ref(xr, xi, keep: int, interval: int, fft_size: int,
                           floor_db: float, window) -> torch.Tensor:
    """Plain PyTorch K4 (torch.fft in float32)."""
    starts = _check(xr, xi, keep, interval, fft_size, window)
    fr = torch.stack([torch.complex(xr[p:p + keep].float(),
                                    xi[p:p + keep].float()) for p in starts])
    if window is not None:
        fr = fr * window
    X = torch.fft.fft(fr, n=fft_size, dim=-1)
    p = (X.real * X.real + X.imag * X.imag) / float(fft_size) ** 2
    return 10.0 * torch.log10(torch.clamp(p, min=10.0 ** (floor_db / 10.0)))


@_build.counted
def spectrum_frames_db_kernel(xr, xi, keep: int, interval: int,
                              fft_size: int, floor_db: float,
                              window) -> torch.Tensor:
    """K4 on the card (csrc/spectrum_fft.cu); same contract as
    ``spectrum_frames_db_ref``."""
    dev = xr.device
    f32 = torch.float32
    starts = _check(xr, xi, keep, interval, fft_size, window)
    lg = int(np.log2(fft_size))
    if 1 << lg != fft_size or not (2 * np.log2(LANES) <= lg
                                   <= 2 * np.log2(MAX_N12)):
        raise ValueError(f"fft size {fft_size}: the kernel takes powers of "
                         f"2 from {LANES ** 2} to {MAX_N12 ** 2}")
    if window is None:
        window = torch.ones(keep, dtype=f32, device=dev)
    N1 = 1 << ((lg + 1) // 2)
    N2 = fft_size // N1
    n = len(starts)
    cr = torch.empty((n, N1, N2), dtype=f32, device=dev)
    ci = torch.empty_like(cr)
    out = torch.empty((n, fft_size), dtype=f32, device=dev)
    _build.launch(
        "sdr_fft_cols", dev, _build.check(xr, "xr", f32, device=dev),
        _build.check(xi, "xi", f32, device=dev), xr.shape[-1],
        _build.check(window, "window", f32, (keep,), dev), keep, interval,
        n, N1, N2, cr.data_ptr(), ci.data_ptr())
    _build.launch(
        "sdr_fft_rows", dev, cr.data_ptr(), ci.data_ptr(), n, N1, N2,
        1.0 / float(fft_size) ** 2, 10.0 ** (floor_db / 10.0),
        out.data_ptr())
    return out


def spectrum_frames_db(xr, xi, keep: int, interval: int, fft_size: int,
                       floor_db: float, window) -> torch.Tensor:
    """K4 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = spectrum_frames_db_kernel if xr.is_cuda else spectrum_frames_db_ref
    return fn(xr, xi, keep, interval, fft_size, floor_db, window)
