"""Polyphase channelizers (counterparts of the PolyphaseChannelizer and the
OversampledChannelizer of sdrplusplusbrown_tpu/ops/channelizer.py).

PolyphaseChannelizer is critically sampled: M channels spaced fs/M, each at
fs/M (BASELINE config 4, bench.py:build_channelizer64).  Its frames are K5's
critical form (ops/channelizer_kernel.py:PFBCritical):

    x_p[k] = x[kM + p],  v_p = h_p ⊛ x_p,  y_m[k] = Σ_p v_p[k]·e^{−j2πmp/M}

with the prototype the framework's windowed-sinc lowpass, cutoff fs/(2M).
Its plain ``apply`` and ``apply_planes`` are K5's plain version; on a CUDA
tensor both launch the kernel (never ``torch.fft``).

OversampledChannelizer emits M bins spaced fs/M, each at 2·fs/M (frame
hop M/2).  The JAX block
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

from ..runtime.block import Block, entry_device
from . import taps as taps_mod
from .channelizer_kernel import PFBChannelizer, PFBCritical, pfb_bins_ref


class PolyphaseChannelizer(Block):
    """Critically sampled PFB: x [T] → y [M, T/M].  An entry point: it runs
    on its ``device`` (CUDA unless the caller asks for the CPU), creates
    its state there and moves only the input to it."""

    def __init__(self, samplerate: float, n_channels: int,
                 trans_frac: float = 0.2, atten_taps: int | None = None,
                 device="cuda"):
        self.samplerate = float(samplerate)
        self.M = M = int(n_channels)
        self.device = torch.device(device)
        ch_bw = self.samplerate / M
        proto = taps_mod.low_pass(ch_bw / 2.0, ch_bw * trans_frac,
                                  self.samplerate)
        tpp = -(-proto.shape[0] // M)
        proto = np.pad(proto, (0, tpp * M - proto.shape[0]))
        #: [M, tpp]: branch p holds proto[i·M + p]
        self.branches = proto.reshape(tpp, M).T.copy()
        self.tpp = tpp
        self.ratio = Fraction(1, 1)     # [M, T/M]: samples conserved
        self.in_multiple = M
        self._pfb = None

    def channel_freqs(self) -> np.ndarray:
        """Center frequency (Hz) of each output channel."""
        m = np.arange(self.M)
        m = np.where(m <= self.M // 2, m, m - self.M)
        return m * self.samplerate / self.M

    def init_state(self, batch_shape=()):
        if batch_shape:
            raise NotImplementedError("one stream per PolyphaseChannelizer")
        return torch.zeros((self.M, self.tpp - 1), dtype=torch.complex64,
                           device=entry_device(self.device))

    def pfb(self) -> PFBCritical:
        """This channelizer's K5 configuration, built once."""
        if self._pfb is None:
            self._pfb = PFBCritical(self)
        return self._pfb

    def _planes(self, x):
        """x [T] complex or (xr, xi) planes → float32 planes on the
        device, the length checked."""
        xr, xi = x if isinstance(x, tuple) else (x.real, x.imag)
        if xr.dim() != 1 or xr.shape[-1] % self.M:
            raise ValueError(f"PolyphaseChannelizer: x must be one [T] "
                             f"stream, T a multiple of M={self.M}")
        dev = entry_device(self.device)
        return (xr.to(dev, torch.float32).contiguous(),
                xi.to(dev, torch.float32).contiguous())

    def apply(self, params, state, x):
        """x [T] complex (or (xr, xi) planes) → (y [M, T/M] complex64,
        state'), float32 taps and bins."""
        xr, xi = self._planes(x)
        f32 = torch.float32
        bins, st = self.pfb().apply(state, (xr, xi), xr.shape[-1] // self.M,
                                    out_dtype=f32, tap_dtype=f32)
        return torch.complex(bins[:self.M], bins[self.M:]), st

    def apply_planes(self, state, x, width_out: int | None = None,
                     out_dtype=None):
        """x [T] complex or (xr, xi) float32 planes → (bins [2M, W] re rows
        over im rows in ``out_dtype`` (default: the handoff dtype), the
        taps rounded to the handoff dtype, state').  W defaults to T/M
        rounded up to 256 frames (the TPU kernel's width); frames past
        T/M are garbage.  The state interchanges exactly with
        ``apply``'s."""
        xr, xi = self._planes(x)
        k = xr.shape[-1] // self.M
        W = -(-k // 256) * 256 if width_out is None else int(width_out)
        return self.pfb().apply(state, (xr, xi), W, out_dtype=out_dtype)


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
