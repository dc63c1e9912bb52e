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

Pre-framed [F, N] frames are the block ``frames.reshape(-1)`` with
interval = keep = N: complex frames take K4f, (xr, xi) planes K4, whose
1024-aligned starts are the same frames for every N >= 1024.

  * K4r (``fft_power_db_planes``, the JAX package's function of that name
    on ``_fft_pow_kernel``) takes pre-framed [..., F, N] re/im plane views,
    float32 or bf16, unwindowed: every row's frames in one launch,
    read in place through the views' row stride (the channelizer's [2M,
    W] bins, the columns past the valid frames skipped).

Dispatch follows the input: CPU tensors run the ``*_ref`` versions
(torch.fft), CUDA tensors launch the kernels (csrc/spectrum_fft.cu) or
raise.  ``plan`` picks the kernels' route by size: up to 4 096 points one
launch holds whole frames in shared memory (K4r's 1024-point frames);
from 8 192 on a four-step N1·N2 FFT runs in two launches sized to fill
the card.  Both take their twiddles from ``twiddles``, a table per size
made on the device at first use.  K4f reads the interleaved complex block
in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build

E = 16               # complex values a thread holds: the radix (csrc)
BLOCK = 256          # threads of a block at most
SMS = 132            # the H100 SXM's SMs: four-step launches aim at >= 1 each
MIN_N, ONE_PASS_MAX, MAX_N = 256, 4096, 262_144


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


def radices(L: int) -> tuple:
    """Radix of each Stockham pass of an L-point sequence: 16 while 16
    divides what is left, then the remainder (1024 → 16, 16, 4)."""
    out = []
    while L > E:
        out.append(E)
        L //= E
    return tuple(out + [L])


def seq_smem(L: int, per_block: int) -> int:
    """Shared-memory bytes of ``per_block`` L-point sequences: complex64,
    one slot in 16 padding."""
    return 8 * (L + L // 16) * per_block


def _per_block(n_seq: int, L: int) -> int:
    """Sequences of L points a four-step block takes: as many as 256
    threads hold, halved while the launch has fewer than SMS blocks."""
    b = BLOCK // (L // E)
    while b > 1 and n_seq // b < SMS:
        b //= 2
    return b


def plan(fft_size: int, n_frames: int) -> dict:
    """How the kernels run ``n_frames`` transforms of ``fft_size`` points:
    the route ("one-pass" up to ONE_PASS_MAX, else "four-step"), the
    sequence lengths and their pass radices (N, or N1 then N2), and per
    launch its C entry, sequences per block, blocks, threads and
    shared-memory bytes.  Raises on a size the kernels lack."""
    lg = int(fft_size).bit_length() - 1
    if 1 << lg != fft_size or not MIN_N <= fft_size <= MAX_N:
        raise ValueError(f"fft size {fft_size}: the kernels take powers of "
                         f"2 from {MIN_N} to {MAX_N}")

    def launch(entry, L, per, n_seq):
        return {"entry": entry, "per_block": per, "blocks": -(-n_seq // per),
                "threads": per * L // E, "smem": seq_smem(L, per)}
    if fft_size <= ONE_PASS_MAX:
        per = BLOCK // (fft_size // E)
        return {"route": "one-pass", "sizes": (fft_size,),
                "radices": (radices(fft_size),),
                "launches": (launch("sdr_fft_frames", fft_size, per,
                                    n_frames),)}
    N1 = 1 << ((lg + 1) // 2)
    N2 = fft_size // N1
    return {"route": "four-step", "sizes": (N1, N2),
            "radices": (radices(N1), radices(N2)),
            "launches": (
                launch("sdr_fft_cols", N1, _per_block(n_frames * N2, N1),
                       n_frames * N2),
                launch("sdr_fft_rows", N2, _per_block(n_frames * N1, N2),
                       n_frames * N1))}


_TWIDDLES: dict = {}
_FOUR_STEP: dict = {}


def twiddles(n: int, device) -> torch.Tensor:
    """[n, 2] float32 (cos, sin) of exp(−2πik/n), k < n: computed in
    float64 and rounded once, made on ``device`` at first use and cached
    per (n, device), so a step copies nothing from the host."""
    key = (int(n), torch.device(device))
    if key not in _TWIDDLES:
        ang = torch.arange(n, dtype=torch.float64, device=key[1]) * (
            -2.0 * np.pi / n)
        _TWIDDLES[key] = torch.stack([torch.cos(ang), torch.sin(ang)],
                                     dim=-1).to(torch.float32)
    return _TWIDDLES[key]


def four_step_twiddles(N1: int, N2: int, device) -> torch.Tensor:
    """[N1·N2, 2] float32: entry k1·N2 + n2 is ``twiddles(N1·N2)``'s entry
    n2·k1 mod N, the four-step twiddle W_N^(n2·k1) in the order the column
    kernel reads it (adjacent columns adjacent); gathered on ``device`` at
    first use and cached."""
    key = (int(N1), int(N2), torch.device(device))
    if key not in _FOUR_STEP:
        N = N1 * N2
        k1 = torch.arange(N1, device=key[2])[:, None]
        n2 = torch.arange(N2, device=key[2])[None, :]
        _FOUR_STEP[key] = twiddles(N, key[2])[((k1 * n2) % N).reshape(-1)]
    return _FOUR_STEP[key]


def _launch_fft(xr_ptr, xi_ptr, es, T, dev, keep, interval, align, n,
                fft_size, floor_db, window, in_bf16: int = 0,
                rows: int = 1, row_stride: int = 0) -> torch.Tensor:
    """``n`` frames in ``rows`` rows of ``row_stride`` elements through
    the route ``plan`` picks (``window`` None: unwindowed)."""
    f32 = torch.float32
    p = plan(fft_size, n)
    win = None if window is None else _build.check(window, "window", f32,
                                                   (keep,), dev)
    tw = twiddles(fft_size, dev).data_ptr()
    out = torch.empty((n, fft_size), dtype=f32, device=dev)
    floor_p = 10.0 ** (floor_db / 10.0)
    frames = (xr_ptr, xi_ptr, in_bf16, es, T, win, keep, interval, align, n,
              n // rows, row_stride)
    per = [ln["per_block"] for ln in p["launches"]]
    if p["route"] == "one-pass":
        _build.launch("sdr_fft_frames", dev, *frames, fft_size, per[0], tw,
                      floor_p, out.data_ptr())
        return out
    N1, N2 = p["sizes"]
    scratch = torch.empty((n, fft_size), dtype=torch.complex64, device=dev)
    _build.launch("sdr_fft_cols", dev, *frames, N1, N2, per[0], tw,
                  four_step_twiddles(N1, N2, dev).data_ptr(),
                  scratch.data_ptr())
    _build.launch("sdr_fft_rows", dev, scratch.data_ptr(), n, N1, N2, per[1],
                  tw, floor_p, out.data_ptr())
    return out


# ---- K4: (xr, xi) planes, 1024-aligned frame starts ------------------------

def spectrum_frames_db_ref(xr, xi, keep: int, interval: int, fft_size: int,
                           floor_db: float, window) -> torch.Tensor:
    """Plain PyTorch K4 (torch.fft in float32)."""
    starts = _check(xr, xi, keep, interval, fft_size, window)
    fr = torch.stack([torch.complex(xr[p:p + keep].float(),
                                    xi[p:p + keep].float()) for p in starts])
    return _frames_db(fr, fft_size, floor_db, window)


@_build.counted_launches
def spectrum_frames_db_kernel(xr, xi, keep: int, interval: int,
                              fft_size: int, floor_db: float,
                              window) -> torch.Tensor:
    """K4 on the card (csrc/spectrum_fft.cu, ``plan``'s launches, each
    counted in ``launches``); same contract as ``spectrum_frames_db_ref``."""
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


@_build.counted_launches
def spectrum_path_db_kernel(x, keep: int, interval: int, fft_size: int,
                            floor_db: float, window) -> torch.Tensor:
    """K4f on the card (csrc/spectrum_fft.cu, exact starts, the block's
    re and im parts read in place; ``plan``'s launches, each counted in
    ``launches``); same contract as ``spectrum_path_db_ref``."""
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


# ---- K4r: pre-framed [..., F, N] plane views, every row in one launch ----

def _check_framed(xr, xi, fft_size):
    if xr.shape != xi.shape or xr.dim() < 2 or xr.shape[-1] != fft_size:
        raise ValueError(f"framed planes: [..., F, {fft_size}] re and im of "
                         f"one shape, got {tuple(xr.shape)} and "
                         f"{tuple(xi.shape)}")


def fft_power_db_planes_ref(xr, xi, fft_size: int,
                            floor_db: float = -300.0) -> torch.Tensor:
    """Plain PyTorch K4r (torch.fft in float32): [..., F, N] → dB."""
    _check_framed(xr, xi, fft_size)
    return _frames_db(torch.complex(xr.float(), xi.float()), fft_size,
                      floor_db, None)


@_build.counted_launches
def fft_power_db_planes_kernel(xr, xi, fft_size: int,
                               floor_db: float = -300.0) -> torch.Tensor:
    """K4r on the card (csrc/spectrum_fft.cu, ``plan``'s launches, each
    counted in ``launches``); same contract as ``fft_power_db_planes_ref``.  The views' frames must be contiguous
    (strides N and 1) and their leading axes one uniform row stride; xr
    and xi share dtype (float32 or bf16) and strides."""
    _check_framed(xr, xi, fft_size)
    dev = xr.device
    for t, what in ((xr, "xr"), (xi, "xi")):
        if t.device.type != "cuda" or t.device != xi.device:
            raise ValueError(f"{what}: expected a CUDA tensor on {dev}")
        if t.dtype not in (torch.float32, torch.bfloat16) or \
                t.dtype != xr.dtype:
            raise ValueError(f"{what}: dtype {t.dtype}, expected float32 or "
                             f"bfloat16 for both planes")
    lead, F = xr.shape[:-2], xr.shape[-2]
    rows = int(np.prod(lead)) if lead else 1
    v = xr.reshape(rows, F, fft_size) if xr.is_contiguous() else xr
    if xr.stride() != xi.stride() or xr.stride(-1) != 1 or \
            xr.stride(-2) != fft_size or v.dim() != 3 or \
            not 0 <= v.stride(0) < 2 ** 31:
        raise ValueError(f"framed planes: strides {xr.stride()} and "
                         f"{xi.stride()}: frames must be contiguous rows of "
                         f"one uniform stride")
    out = _launch_fft(xr.data_ptr(), xi.data_ptr(), 1, F * fft_size, dev,
                      fft_size, fft_size, 1, rows * F, fft_size, floor_db,
                      None, int(xr.dtype == torch.bfloat16), rows,
                      v.stride(0) if rows > 1 else 0)
    return out.reshape(xr.shape)


def fft_power_db_planes(xr, xi, fft_size: int,
                        floor_db: float = -300.0) -> torch.Tensor:
    """K4r dispatch: xr/xi [..., F, N] re/im planes → [..., F, N] float32
    dB power, natural bin order; the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = fft_power_db_planes_kernel if xr.is_cuda \
        else fft_power_db_planes_ref
    return fn(xr, xi, fft_size, floor_db)
