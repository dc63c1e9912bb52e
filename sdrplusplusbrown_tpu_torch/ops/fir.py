"""Overlap-save block FIR filtering (counterpart of
sdrplusplusbrown_tpu/ops/fir.py).

    y[..., i] = sum_k ext[..., i*decim + k] * taps[k]
    ext       = concat(state, x)          # state = last taps-1 inputs

which is the reference's indexing (reference filter/fir.h:64-92,
filter/decimating_fir.h:45-68).  This is the plain PyTorch block; the
main path's FIR stages run inside the hand-written front-end and demod
kernels (ops/mono_frontend.py, ops/wfm_kernel.py), whose plain versions
are built from these blocks.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime.block import Block


def _corr_rows(xf: torch.Tensor, h: np.ndarray, stride: int) -> torch.Tensor:
    """Real correlation of rows ``xf`` [N, W] float32 with real taps."""
    w = torch.tensor(np.asarray(h, np.float32), device=xf.device)
    y = F.conv1d(xf.reshape(-1, 1, xf.shape[-1]), w.view(1, 1, -1),
                 stride=stride)
    return y.reshape(xf.shape[0], -1)


def correlate(x: torch.Tensor, taps: np.ndarray, stride: int = 1):
    """out[..., i] = sum_k x[..., i*stride + k] * taps[k].

    ``x`` real float32 or complex64, ``taps`` a real or complex numpy
    array; batched over all leading axes."""
    taps = np.asarray(taps)
    lead, W = x.shape[:-1], x.shape[-1]
    if not x.is_complex():
        y = _corr_rows(x.reshape(-1, W).float(), np.real(taps), stride)
        if np.iscomplexobj(taps):
            yi = _corr_rows(x.reshape(-1, W).float(), np.imag(taps), stride)
            y = torch.complex(y, yi)
        return y.reshape(lead + (y.shape[-1],))
    xr = x.real.reshape(-1, W)
    xi = x.imag.reshape(-1, W)
    n = xr.shape[0]
    both = torch.cat([xr, xi], dim=0)
    yr_hr = _corr_rows(both, np.real(taps), stride)
    yr, yi = yr_hr[:n], yr_hr[n:]
    if np.iscomplexobj(taps):
        y_hi = _corr_rows(both, np.imag(taps), stride)
        yr, yi = yr - y_hi[n:], yi + y_hi[:n]
    out = torch.complex(yr, yi)
    return out.reshape(lead + (out.shape[-1],))


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
        ext = torch.cat([state.to(x.device, x.dtype), x], dim=-1)
        y = correlate(ext, self.taps, stride=self.decim)
        new_state = ext[..., ext.shape[-1] - (self.K - 1):] if self.K > 1 \
            else state
        return y, new_state


class RealFIR(FIR):
    """FIR for real float32 streams (audio-path filters)."""

    def init_state(self, batch_shape=(), dtype=torch.float32):
        return super().init_state(batch_shape, dtype)
