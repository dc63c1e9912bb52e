"""Per-stage FIR kernels K8 and K9 with their plain versions (counterpart of
sdrplusplusbrown_tpu/ops/pallas_fir.py).

K8 (``fir_rows``): real taps on real float32 or complex64 rows,
    y[..., m·I + r] = Σ_l kern[r, l] · ext[..., m·D + l]
    ext            = concat(tail, x)          # tail = last ``hist`` inputs
with ``kern`` [I, kw] — a stride-1 FIR (I = D = 1, kern = taps[None]), a
decimating FIR (I = 1) or the widened L/M polyphase kernel of
ops/resampler.py.  A complex row is its re and im parts, each filtered by
the real taps.  It serves every real-tap body of the TPU file: the flat
and channel-blocked stride-1, decimating and banded-polyphase kernels.

K9 (``fir_cplx``): complex taps [2, K] (re row, im row) on complex64 rows
at stride D, the complex-tap bodies (flat and channel-blocked).

Both return (y, new_tail) with new_tail = ext[..., -hist:], the carried
state of the next block.  Dispatch follows the input: CPU tensors run the
``*_ref`` versions (``F.conv1d``), CUDA tensors launch the kernels
(csrc/fir_rows.cu, csrc/fir_cplx.cu) or raise.  The kernels read the tail
and the block through separate pointers and write the new tail
themselves: no concat, split or recombine pass on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import _build

_DTYPES = (torch.float32, torch.complex64)


def poly_rows(ext: torch.Tensor, kernel, interp: int,
              decim: int) -> torch.Tensor:
    """Widened-polyphase correlation of real float32 rows ``ext`` [N, W]
    with ``kernel`` [interp, kw] (numpy, or a float32 tensor, e.g.
    storage-rounded): out[:, m*interp + r] = Σ_l kernel[r, l]·ext[:, m*decim
    + l] → [N, ((W - kw)//decim + 1)·interp].  The plain building block of
    every FIR kernel's plain version (one ``F.conv1d``)."""
    ker = torch.as_tensor(kernel, dtype=torch.float32).to(ext.device)
    y = F.conv1d(ext.reshape(-1, 1, ext.shape[-1]), ker[:, None, :],
                 stride=decim)                     # [N, interp, M]
    return y.transpose(1, 2).reshape(ext.shape[0], -1)


def _check(x, tail, kern, I: int, D: int, n_kern_rows: int):
    """Output length per row (m count · I); raises on a bad geometry."""
    if x.dtype not in _DTYPES or tail.dtype != x.dtype:
        raise ValueError(f"FIR rows: dtypes {x.dtype}/{tail.dtype}, expected "
                         f"one of {_DTYPES} for both")
    if x.dim() < 1 or tail.shape[:-1] != x.shape[:-1]:
        raise ValueError(f"FIR rows: block {tuple(x.shape)} and tail "
                         f"{tuple(tail.shape)} differ in their leading axes")
    if kern.dim() != 2 or kern.shape[0] != n_kern_rows or \
            kern.dtype != torch.float32:
        raise ValueError(f"FIR taps: {tuple(kern.shape)} {kern.dtype}")
    kw = kern.shape[1]
    n_m = (tail.shape[-1] + x.shape[-1] - kw) // D + 1
    if n_m < 1:
        raise ValueError(f"FIR rows: block of {x.shape[-1]} with "
                         f"{tail.shape[-1]} carried samples is shorter "
                         f"than {kw} taps")
    return n_m * I


# ---- K8: real taps ---------------------------------------------------------

def fir_rows_ref(x, tail, kern, I: int, D: int):
    """Plain PyTorch K8: (y [..., n_out] of x's dtype, new tail)."""
    _check(x, tail, kern, I, D, I)
    ext = torch.cat([tail, x], dim=-1)
    W = ext.shape[-1]
    lead = x.shape[:-1]
    if x.is_complex():
        rows = torch.cat([ext.real.reshape(-1, W), ext.imag.reshape(-1, W)])
        y = poly_rows(rows, kern, I, D)
        n = y.shape[0] // 2
        y = torch.complex(y[:n], y[n:])
    else:
        y = poly_rows(ext.reshape(-1, W), kern, I, D)
    return y.reshape(lead + (y.shape[-1],)), ext[..., W - tail.shape[-1]:]


@_build.counted
def fir_rows_kernel(x, tail, kern, I: int, D: int):
    """K8 on the card (csrc/fir_rows.cu); same contract as
    ``fir_rows_ref``."""
    dev = x.device
    n_out = _check(x, tail, kern, I, D, I)
    lead, T, hist = x.shape[:-1], x.shape[-1], tail.shape[-1]
    y = torch.empty(lead + (n_out,), dtype=x.dtype, device=dev)
    new_tail = torch.empty_like(tail)
    _build.launch(
        "sdr_fir_rows", dev, _build.check(tail, "FIR tail", _DTYPES,
                                          device=dev), hist,
        _build.check(x, "FIR block", _DTYPES, device=dev), T,
        _build.check(kern, "FIR taps", torch.float32, device=dev), I, D,
        kern.shape[1], y.data_ptr(), n_out, new_tail.data_ptr(),
        math.prod(lead), 2 if x.is_complex() else 1)
    return y, new_tail


def fir_rows(x, tail, kern, I: int, D: int):
    """K8 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = fir_rows_kernel if x.is_cuda else fir_rows_ref
    return fn(x, tail, kern, I, D)


# ---- K9: complex taps on complex rows -------------------------------------

def fir_cplx_ref(x, tail, taps, D: int):
    """Plain PyTorch K9: taps [2, K] float32 (re row, im row) → (y
    complex64 [..., n_out], new tail)."""
    _check(x, tail, taps, 1, D, 2)
    if not x.is_complex():
        raise ValueError("complex-tap FIR: complex64 rows only")
    ext = torch.cat([tail, x], dim=-1)
    W = ext.shape[-1]
    rows = torch.cat([ext.real.reshape(-1, W), ext.imag.reshape(-1, W)])
    n = rows.shape[0] // 2
    y_hr = poly_rows(rows, taps[:1], 1, D)
    y_hi = poly_rows(rows, taps[1:], 1, D)
    y = torch.complex(y_hr[:n] - y_hi[n:], y_hr[n:] + y_hi[:n])
    return y.reshape(x.shape[:-1] + (y.shape[-1],)), \
        ext[..., W - tail.shape[-1]:]


@_build.counted
def fir_cplx_kernel(x, tail, taps, D: int):
    """K9 on the card (csrc/fir_cplx.cu); same contract as
    ``fir_cplx_ref``."""
    dev = x.device
    c64 = torch.complex64
    n_out = _check(x, tail, taps, 1, D, 2)
    lead, T, hist = x.shape[:-1], x.shape[-1], tail.shape[-1]
    y = torch.empty(lead + (n_out,), dtype=c64, device=dev)
    new_tail = torch.empty_like(tail)
    _build.launch(
        "sdr_fir_cplx", dev, _build.check(tail, "FIR tail", c64, device=dev),
        hist, _build.check(x, "FIR block", c64, device=dev), T,
        _build.check(taps, "FIR taps", torch.float32, device=dev),
        taps.shape[1], D, y.data_ptr(), n_out, new_tail.data_ptr(),
        math.prod(lead))
    return y, new_tail


def fir_cplx(x, tail, taps, D: int):
    """K9 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = fir_cplx_kernel if x.is_cuda else fir_cplx_ref
    return fn(x, tail, taps, D)
