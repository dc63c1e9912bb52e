"""Overlap-save block FIR filtering (counterpart of
sdrplusplusbrown_tpu/ops/fir.py).

    y[..., i] = sum_k ext[..., i*decim + k] * taps[k]
    ext       = concat(state, x)          # state = last taps-1 inputs

which is the reference's indexing (reference filter/fir.h:64-92,
filter/decimating_fir.h:45-68).  Real taps run kernel K8 on real or
complex data and complex taps kernel K9 (ops/fir_kernel.py), as the JAX
package routes them to its real-tap and complex-tap Pallas bodies
(ops/fir.py:154-251 there): on a CUDA tensor the kernel or an error, on a
CPU tensor the kernel's plain version (``F.conv1d``).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..runtime.block import Block, device_const
from .fir_kernel import fir_cplx, fir_rows


def device_taps(owner, taps: np.ndarray, device) -> torch.Tensor:
    """``taps`` as the kernels take them, made once per device and kept on
    ``owner``: real [K] → [1, K] and real [I, kw] as it is, float32;
    complex [K] → [2, K] (re row, im row)."""
    def rows():
        r = np.stack([np.real(taps), np.imag(taps)]) \
            if np.iscomplexobj(taps) else np.atleast_2d(taps)
        return r.astype(np.float32)
    return device_const(owner, "taps", rows, device)


def _as_rows(x: torch.Tensor, complex_taps: bool) -> torch.Tensor:
    """The block as contiguous float32 or complex64 rows (complex taps
    take complex rows: a real block gets a zero imaginary part)."""
    if complex_taps or x.is_complex():
        return x.to(torch.complex64).contiguous()
    return x.float().contiguous()


def carried(state: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A block's carried state as the kernels take it: contiguous, of
    the block's dtype.  A CPU block takes its state along; on the card
    the kernel raises on a state held anywhere else."""
    dev = state.device if x.is_cuda else x.device
    return state.to(dev, x.dtype).contiguous()


class FIR(Block):
    """Stateful streaming FIR, optionally decimating (reference
    filter::FIR / filter::DecimatingFIR with the fractional offset pinned
    to zero by the static-granularity rule, in_multiple == decim)."""

    def __init__(self, taps: np.ndarray, decim: int = 1):
        taps = np.asarray(taps)
        self.taps = taps
        self.K = int(taps.shape[-1])
        self.decim = int(decim)
        self.ratio = Fraction(1, self.decim)
        self.in_multiple = self.decim
        self._complex_taps = bool(np.iscomplexobj(taps))

    def init_state(self, batch_shape=(), dtype=torch.complex64):
        return torch.zeros(batch_shape + (max(self.K - 1, 0),), dtype=dtype)

    def apply(self, params, state, x):
        if self.K == 1 and not self._complex_taps and self.decim == 1:
            return x * float(np.real(self.taps[0])), state
        x = _as_rows(x, self._complex_taps)
        state = carried(state, x)
        h = device_taps(self, self.taps, x.device)
        if self._complex_taps:
            return fir_cplx(x, state, h, self.decim)
        return fir_rows(x, state, h, 1, self.decim)


class RealFIR(FIR):
    """FIR for real float32 streams (audio-path filters)."""

    def init_state(self, batch_shape=(), dtype=torch.float32):
        return super().init_state(batch_shape, dtype)
