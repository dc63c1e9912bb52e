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

``fir_plan`` sizes the polyphase FIR tile (csrc/fir_tile.cuh) that K8, K9
and K3 (ops/wfm_kernel.py) launch: outputs per lane, phase rows and output
chunks per block, warps and grid.
"""

from __future__ import annotations

import functools
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


# ---- the polyphase FIR tile's plan (csrc/fir_tile.cuh) ----------------------

SMS = 132                 # the H100 SXM's SMs: a launch aims at >= 1 block each
SMEM_MAX = 232_448        # shared memory a block may take (227 KB)
MAX_WARPS = 8
MAX_CHUNKS = 4
OUTS_PER_LANE = (5, 3, 1)   # odd: a warp's stride-P reads hit 32 banks


def _r4(n: int) -> int:
    return (n + 3) & ~3


def tile_smem(D: int, kw: int, n_m: int, P: int, G: int, C: int,
              comps: int, tcomps: int = 1) -> int:
    """Shared-memory bytes of one block (csrc/fir_tile.cuh:fir_tile_layout):
    G phase rows of taps (``tcomps`` floats a tap: 2 for complex taps),
    their bands, the output tile [m, G | 1] and the input staged
    de-interleaved by input phase, [min(D, kw), S] samples with S = (m +
    (kw − 1) // D) | 1, m = min(C·32·P, n_m), plus P."""
    mb = min(C * 32 * P, n_m)
    stride = (mb + (kw - 1) // D) | 1
    return 4 * (_r4(G * kw * tcomps) + _r4(2 * G)
                + _r4(mb * (G | 1) * comps)
                + _r4((min(D, kw) * stride + P) * comps))


@functools.lru_cache(maxsize=None)
def fir_plan(I: int, D: int, kw: int, n_out: int, rows: int,
             comps: int, tcomps: int = 1) -> dict:
    """How the tile computes ``rows`` rows of n_out = n_m·I outputs (of
    ``comps`` floats, with taps of ``tcomps``):
    ``P`` outputs per lane (consecutive m), ``G`` phase rows and ``C``
    chunks of 32·P outputs per block, ``warps`` per block (each takes one
    (phase row, chunk) unit at a time), the ``grid`` (m tiles, phase
    groups, rows), ``blocks`` and ``smem`` bytes.

    P is the largest that leaves at most a quarter of the last chunk's
    lanes idle and still gives 4·SMS warp units; else 1.  A block starts
    at one unit a warp: G = min(I, 8) phase rows, which share its staged
    input, and as many chunks as fill 8 warps, at most MAX_CHUNKS.  While
    its shared memory exceeds SMEM_MAX it gives up phase rows (where the
    taps take half of it), chunks, outputs per lane, then phase rows;
    while the launch has fewer than SMS blocks, chunks, then phase rows.
    (scripts/fir_rows_sweep.py --plans times the alternatives.)"""
    if I < 1 or D < 1 or kw < 1 or rows < 1 or comps not in (1, 2) or \
            tcomps not in (1, 2) or n_out < I or n_out % I:
        raise ValueError(f"FIR tile: I={I} D={D} kw={kw} n_out={n_out} "
                         f"rows={rows} comps={comps} tcomps={tcomps}")
    n_m = n_out // I

    def chunks(P):
        return -(-n_m // (32 * P))

    fits = [P for P in OUTS_PER_LANE
            if 4 * (chunks(P) * 32 * P - n_m) <= chunks(P) * 32 * P] or [1]
    P = next((P for P in fits if rows * I * chunks(P) >= 4 * SMS), fits[-1])
    n_c = chunks(P)
    G = min(I, MAX_WARPS)
    C = min(n_c, MAX_CHUNKS, max(1, MAX_WARPS // G))

    def blocks(G, C):
        return rows * -(-I // G) * -(-n_c // C)

    while True:
        smem = tile_smem(D, kw, n_m, P, G, C, comps, tcomps)
        if smem > SMEM_MAX:
            if G > 1 and 4 * G * kw * tcomps >= smem // 2:
                G = (G + 1) // 2
            elif C > 1:
                C = (C + 1) // 2
            elif P > 1:
                P = OUTS_PER_LANE[OUTS_PER_LANE.index(P) + 1]
                n_c = chunks(P)
            elif G > 1:
                G = (G + 1) // 2
            else:
                raise ValueError(f"FIR tile: {kw} taps at D={D} do not "
                                 f"fit {SMEM_MAX} bytes")
        elif blocks(G, C) < SMS and C > 1:
            C = (C + 1) // 2
        elif blocks(G, C) < SMS and G > 1:
            G = (G + 1) // 2
        else:
            break
    warps = min(MAX_WARPS, max(4, G * C))
    grid = (-(-n_c // C), -(-I // G), rows)
    return {"P": P, "G": G, "C": C, "warps": warps, "threads": 32 * warps,
            "grid": grid, "blocks": math.prod(grid), "smem": smem,
            "n_m": n_m, "m_block": C * 32 * P}


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
    """K8 on the card (csrc/fir_rows.cu, one launch of ``fir_plan``'s
    grid); same contract as ``fir_rows_ref``."""
    dev = x.device
    n_out = _check(x, tail, kern, I, D, I)
    lead, T, hist = x.shape[:-1], x.shape[-1], tail.shape[-1]
    rows, comps = math.prod(lead), 2 if x.is_complex() else 1
    p = fir_plan(I, D, kern.shape[1], n_out, rows, comps)
    y = torch.empty(lead + (n_out,), dtype=x.dtype, device=dev)
    new_tail = torch.empty_like(tail)
    _build.launch(
        "sdr_fir_rows", dev, _build.check(tail, "FIR tail", _DTYPES,
                                          device=dev), hist,
        _build.check(x, "FIR block", _DTYPES, device=dev), T,
        _build.check(kern, "FIR taps", torch.float32, device=dev), I, D,
        kern.shape[1], y.data_ptr(), n_out, new_tail.data_ptr(), rows,
        comps, p["P"], p["G"], p["C"], p["warps"])
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


def cplx_plan(D: int, K: int, n_out: int, rows: int) -> dict:
    """K9's grid: ``fir_plan``'s for one phase row of complex outputs and
    complex taps (196 blocks of P = 1 for the pilot's one row of 12 500
    outputs)."""
    return fir_plan(1, D, K, n_out, rows, 2, 2)


@_build.counted
def fir_cplx_kernel(x, tail, taps, D: int):
    """K9 on the card (csrc/fir_cplx.cu, one launch of ``cplx_plan``'s
    grid on the FIR tile); same contract as ``fir_cplx_ref``."""
    return _fir_cplx_launch(x, tail, taps, D)


def _fir_cplx_launch(x, tail, taps, D: int, plan: dict | None = None):
    """K9's launch on ``plan`` (``cplx_plan``'s by default)."""
    dev = x.device
    c64 = torch.complex64
    n_out = _check(x, tail, taps, 1, D, 2)
    lead, T, hist = x.shape[:-1], x.shape[-1], tail.shape[-1]
    rows = math.prod(lead)
    p = plan or cplx_plan(D, taps.shape[1], n_out, rows)
    y = torch.empty(lead + (n_out,), dtype=c64, device=dev)
    new_tail = torch.empty_like(tail)
    _build.launch(
        "sdr_fir_cplx", dev, _build.check(tail, "FIR tail", c64, device=dev),
        hist, _build.check(x, "FIR block", c64, device=dev), T,
        _build.check(taps, "FIR taps", torch.float32, device=dev),
        taps.shape[1], D, y.data_ptr(), n_out, new_tail.data_ptr(), rows,
        p["P"], p["C"], p["warps"])
    return y, new_tail


def fir_cplx(x, tail, taps, D: int):
    """K9 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = fir_cplx_kernel if x.is_cuda else fir_cplx_ref
    return fn(x, tail, taps, D)
