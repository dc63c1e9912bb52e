"""2×-oversampled polyphase channelizer (counterpart of the
OversampledChannelizer of sdrplusplusbrown_tpu/ops/channelizer.py).

M bins spaced fs/M, each emitted at 2·fs/M (frame hop M/2).  The JAX block
runs two critically-sampled branch-FIR passes: even frames on the input
delayed by M/2 with the (−1)^m phase-continuity twiddle, odd frames on
the input itself, then an M-point DFT across the branches:

    x_p[k] = x[kM + p],  v_p = h_p ⊛ x_p,  y_m[k] = Σ_p v_p[k]·e^{−j2πmp/M}

This block holds the branch taps and that block's state dict.  Its plain
``apply`` is the plain version of kernel K5 at float32
(ops/channelizer_kernel.py:pfb_bins_ref, the same function in closed
form), so the port keeps one plain PFB; the wide-bank path runs K5 on the
same state dict.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..runtime.block import Block
from .channelizer_kernel import PFBChannelizer, pfb_bins_ref


class OversampledChannelizer(Block):
    def __init__(self, samplerate: float, n_channels: int,
                 proto_taps: np.ndarray):
        self.samplerate = float(samplerate)
        M = int(n_channels)
        if M % 2:
            raise ValueError(f"OversampledChannelizer: M={M} must be even")
        self.M = M
        proto = np.asarray(proto_taps, np.float64)
        tpp = -(-proto.shape[0] // M)
        proto = np.pad(proto, (0, tpp * M - proto.shape[0]))
        #: [M, tpp]: branch p holds proto[i·M + p]
        self.branches = proto.reshape(tpp, M).T.copy()
        self.tpp = tpp
        self.ratio = Fraction(2, M)
        self.in_multiple = M
        self._pfb = None

    def init_state(self, batch_shape=()):
        z = torch.zeros(batch_shape + (self.M, self.tpp - 1),
                        dtype=torch.complex64)
        return {"tail_a": z, "tail_b": z.clone(),
                "delay": torch.zeros(batch_shape + (self.M // 2,),
                                     dtype=torch.complex64)}

    def pfb(self) -> PFBChannelizer:
        """This channelizer's K5 configuration, built once."""
        if self._pfb is None:
            self._pfb = PFBChannelizer(self)
        return self._pfb

    def apply(self, params, state, x):
        """x [T] complex → (bins [M, 2T/M] complex64, state')."""
        (yr, yi), st = self.apply_planes(state, x)
        return torch.complex(yr, yi), st

    def apply_planes(self, state, x, pad_to: int | None = None):
        """``apply`` emitting float32 planes: (yr, yi) [M, 2T/M], or with
        ``pad_to`` one [2M, pad_to] stack (re rows over im rows,
        zero-padded columns) — the post-channelizer's input layout."""
        if x.dim() != 1:
            raise ValueError("OversampledChannelizer: x must be one [T] "
                             "stream")
        pipe, M = self.pfb(), self.M
        xr = x.real.float().contiguous()
        xi = x.imag.float().contiguous()
        xw = pipe.state_to_xw(state)
        Tb = 2 * x.shape[-1] // M
        bins = pfb_bins_ref(pipe, xr, xi, xw.real.contiguous(),
                            xw.imag.contiguous(), Tb, torch.float32,
                            torch.float32)
        st = pipe.next_state(xw, xr, xi)
        if pad_to is None:
            return (bins[:M], bins[M:]), st
        if pad_to < Tb:
            raise ValueError(f"pad_to {pad_to} < {Tb} frames")
        return torch.nn.functional.pad(bins, (0, pad_to - Tb)), st
