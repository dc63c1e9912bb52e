"""Framed power spectrum — kernels K4 and K4f with their plain versions
(counterpart of the spectrum kernels of
sdrplusplusbrown_tpu/ops/pallas_fft.py).

Frame f is ``keep`` samples of the wideband, windowed (the window
includes the (−1)^i DC-centering factor), zero-padded to ``fft_size`` and
returned as 10·log10(max(|X|²/N², floor)) in natural bin order,
[n_frames, fft_size].  The two kernels differ in where frame f starts:

  * K4 (``spectrum_frames_db``) on (xr, xi) float32 planes: at
    rup(f·interval, 1024), the frames of the TPU front-end kernel path
    (``_fft_pow_frames_kernel``, the spectrum fused into ``_mono_kernel``);
  * K4f (``spectrum_path_db``) on a complex64 block: at exactly
    f·interval, the reshaper's frames, as ``spectrum_path_db`` frames them
    for ``_fft_pow_kernel``.

Pre-framed [F, N] frames (``fft_power_db_planes``' input) are the block
``frames.reshape(-1)`` with interval = keep = N: complex frames take
K4f, (xr, xi) planes K4, whose 1024-aligned starts are the same frames
for every N >= 1024.

Dispatch follows the input: CPU tensors run the ``*_ref`` versions
(torch.fft), CUDA tensors launch the kernels (csrc/spectrum_fft.cu: a
4-step N1·N2 FFT in two launches; K4f reads the interleaved complex block
in place) or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build

LANES = 16       # short FFTs per block (csrc/spectrum_fft.cu)
MAX_N12 = 512    # longest short FFT the kernel holds in shared memory


def frame_starts(T: int, keep: int, interval: int, align: int = 1024) -> list:
    """Start of every frame in a block of T samples, rup(f·interval,
    align); raises when the last frame would run past the block."""
    n = T // interval
    starts = [(f * interval + align - 1) // align * align for f in range(n)]
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


def _frames_db(fr, fft_size: int, floor_db: float, window) -> torch.Tensor:
    """[n, keep] complex frames → windowed, zero-padded dB spectra."""
    if window is not None:
        fr = fr * window
    X = torch.fft.fft(fr, n=fft_size, dim=-1)
    p = (X.real * X.real + X.imag * X.imag) / float(fft_size) ** 2
    return 10.0 * torch.log10(torch.clamp(p, min=10.0 ** (floor_db / 10.0)))


def _split(fft_size: int):
    """(N1, N2) of the kernel's 4-step split; raises on a size it lacks."""
    lg = int(np.log2(fft_size))
    if 1 << lg != fft_size or not (2 * np.log2(LANES) <= lg
                                   <= 2 * np.log2(MAX_N12)):
        raise ValueError(f"fft size {fft_size}: the kernel takes powers of "
                         f"2 from {LANES ** 2} to {MAX_N12 ** 2}")
    N1 = 1 << ((lg + 1) // 2)
    return N1, fft_size // N1


def _launch_fft(xr_ptr, xi_ptr, es, T, dev, keep, interval, align, n,
                fft_size, floor_db, window) -> torch.Tensor:
    """Both launches of the 4-step FFT over ``n`` frames."""
    f32 = torch.float32
    N1, N2 = _split(fft_size)
    if window is None:
        window = torch.ones(keep, dtype=f32, device=dev)
    cr = torch.empty((n, N1, N2), dtype=f32, device=dev)
    ci = torch.empty_like(cr)
    out = torch.empty((n, fft_size), dtype=f32, device=dev)
    _build.launch(
        "sdr_fft_cols", dev, xr_ptr, xi_ptr, es, T,
        _build.check(window, "window", f32, (keep,), dev), keep, interval,
        align, n, N1, N2, cr.data_ptr(), ci.data_ptr())
    _build.launch(
        "sdr_fft_rows", dev, cr.data_ptr(), ci.data_ptr(), n, N1, N2,
        1.0 / float(fft_size) ** 2, 10.0 ** (floor_db / 10.0),
        out.data_ptr())
    return out


# ---- K4: (xr, xi) planes, 1024-aligned frame starts ------------------------

def spectrum_frames_db_ref(xr, xi, keep: int, interval: int, fft_size: int,
                           floor_db: float, window) -> torch.Tensor:
    """Plain PyTorch K4 (torch.fft in float32)."""
    starts = _check(xr, xi, keep, interval, fft_size, window)
    fr = torch.stack([torch.complex(xr[p:p + keep].float(),
                                    xi[p:p + keep].float()) for p in starts])
    return _frames_db(fr, fft_size, floor_db, window)


@_build.counted
def spectrum_frames_db_kernel(xr, xi, keep: int, interval: int,
                              fft_size: int, floor_db: float,
                              window) -> torch.Tensor:
    """K4 on the card (csrc/spectrum_fft.cu); same contract as
    ``spectrum_frames_db_ref``."""
    dev = xr.device
    f32 = torch.float32
    starts = _check(xr, xi, keep, interval, fft_size, window)
    return _launch_fft(_build.check(xr, "xr", f32, device=dev),
                       _build.check(xi, "xi", f32, device=dev), 1,
                       xr.shape[-1], dev, keep, interval, 1024, len(starts),
                       fft_size, floor_db, window)


def spectrum_frames_db(xr, xi, keep: int, interval: int, fft_size: int,
                       floor_db: float, window) -> torch.Tensor:
    """K4 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = spectrum_frames_db_kernel if xr.is_cuda else spectrum_frames_db_ref
    return fn(xr, xi, keep, interval, fft_size, floor_db, window)


# ---- K4f: a complex64 block, frames at exactly f·interval -----------------

def _check_block(x, keep, interval, fft_size, window):
    if x.dim() != 1 or x.dtype != torch.complex64:
        raise ValueError(f"spectrum block: a 1-D complex64 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if keep > fft_size or (window is not None and window.shape != (keep,)):
        raise ValueError("window must have ``keep`` <= fft_size samples")
    return frame_starts(x.shape[0], keep, interval, align=1)


def spectrum_path_db_ref(x, keep: int, interval: int, fft_size: int,
                         floor_db: float, window) -> torch.Tensor:
    """Plain PyTorch K4f (torch.fft in float32)."""
    starts = _check_block(x, keep, interval, fft_size, window)
    fr = torch.stack([x[p:p + keep] for p in starts])
    return _frames_db(fr, fft_size, floor_db, window)


@_build.counted
def spectrum_path_db_kernel(x, keep: int, interval: int, fft_size: int,
                            floor_db: float, window) -> torch.Tensor:
    """K4f on the card (csrc/spectrum_fft.cu, exact starts, the block's
    re and im parts read in place); same contract as
    ``spectrum_path_db_ref``."""
    dev = x.device
    starts = _check_block(x, keep, interval, fft_size, window)
    p = _build.check(x, "spectrum block", torch.complex64, device=dev)
    return _launch_fft(p, p + 4, 2, x.shape[0], dev, keep, interval, 1,
                       len(starts), fft_size, floor_db, window)


def spectrum_path_db(x, keep: int, interval: int, fft_size: int,
                     floor_db: float, window) -> torch.Tensor:
    """K4f dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = spectrum_path_db_kernel if x.is_cuda else spectrum_path_db_ref
    return fn(x, keep, interval, fft_size, floor_db, window)
