"""The 2×-oversampled WOLA PFB — kernel K5 and its plain version
(counterpart of sdrplusplusbrown_tpu/ops/pallas_channelizer.py, whose V3
``_chz3_kernel`` and the V2 / V1 forms compute this same function).

With s = [last K0 − M/2 wideband samples | x | zeros], h = M/2 and
K0 = tpp·M, every output frame F is one window of the stream:

    v_F[p]     = Σ_i br[p, i] · s[F·h + i·M + p]
    bins[m, F] = σ_m^{[F even]} · Σ_p v_F[p] · e^{−2πi·mp/M},  σ_m = (−1)^m

The even frames are the delayed pass of OversampledChannelizer (the (−1)^m
twiddle), the odd ones its plain pass.  The output is the stacked
[2M, width] plane pair (re rows over im rows) in the handoff storage
dtype; frames past 2T/M are computed from the zero-extended stream and
are garbage for the consumer to ignore, as on the TPU.  The branch taps
and the DFT matrix are float64 designs rounded to float32 and then to
the handoff dtype, where the JAX kernel rounds them.

Dispatch follows the input: CPU tensors run ``pfb_bins_ref``; CUDA
tensors launch ``pfb_bins_kernel`` (csrc/pfb_channelizer.cu) or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build
from .precision import get_handoff_dtype, round_to

_STORAGE = (torch.float32, torch.bfloat16)
PFB_FRAMES = 32      # frames per CUDA block (csrc/pfb_channelizer.cu)


class PFBChannelizer:
    """K5 configuration built from an OversampledChannelizer."""

    def __init__(self, chz):
        self.M = M = int(chz.M)
        self.h = M // 2
        self.tpp = int(chz.tpp)
        self.K0 = self.tpp * M
        if self.tpp < 2 or M % 2 or M > 64:
            raise NotImplementedError(f"PFB geometry M={M}, tpp={self.tpp}")
        self.branches = np.asarray(chz.branches, np.float32)     # [M, tpp]
        ang = 2.0 * np.pi * np.outer(np.arange(M), np.arange(M)) / M
        self.cos = np.cos(ang).astype(np.float32)
        self.sin = np.sin(ang).astype(np.float32)
        self._dev = {}

    @property
    def n_hist(self) -> int:
        """Wideband samples carried between calls (K0 − M/2)."""
        return self.K0 - self.h

    def operands(self, device, dtype):
        """(branches [M, tpp], cos [M, M], sin [M, M]) float32 device
        tensors rounded to the storage ``dtype``."""
        key = (str(device), dtype)
        if key not in self._dev:
            self._dev[key] = tuple(
                round_to(torch.from_numpy(a), dtype).to(device).contiguous()
                for a in (self.branches, self.cos, self.sin))
        return self._dev[key]

    # ---- OversampledChannelizer state <-> the last n_hist samples -------
    def state_to_xw(self, state) -> torch.Tensor:
        tb = state["tail_b"].transpose(-1, -2).reshape(
            state["tail_b"].shape[:-2] + ((self.tpp - 1) * self.M,))
        return torch.cat([tb, state["delay"]], dim=-1)

    def xw_to_state(self, xw: torch.Tensor) -> dict:
        n, M, h = (self.tpp - 1) * self.M, self.M, self.h
        lead = xw.shape[:-1]
        return {"tail_a": xw[..., h:h + n].reshape(lead + (self.tpp - 1, M))
                .transpose(-1, -2).contiguous(),
                "tail_b": xw[..., :n].reshape(lead + (self.tpp - 1, M))
                .transpose(-1, -2).contiguous(),
                "delay": xw[..., n:n + h].contiguous()}

    def apply(self, state, x, width_out: int, out_dtype=None):
        """x: (xr, xi) float32 [T] planes → (bins [2M, width_out] in
        ``out_dtype`` (default: the handoff dtype), state')."""
        h_dt = get_handoff_dtype()
        out_dtype = h_dt if out_dtype is None else out_dtype
        xr, xi = x
        xr = xr.float().contiguous()
        xi = xi.float().contiguous()
        xw = self.state_to_xw(state)
        bins = pfb_bins(self, xr, xi, xw.real.contiguous(),
                        xw.imag.contiguous(), width_out, h_dt, out_dtype)
        return bins, self.next_state(xw, xr, xi)

    def next_state(self, xw, xr, xi) -> dict:
        """The state after a call on (xr, xi) from history ``xw``: the
        last n_hist samples of [xw | x], in the block's layout."""
        T, nh = xr.shape[-1], self.n_hist
        tail = (torch.complex(xr[T - nh:], xi[T - nh:]) if T >= nh
                else torch.cat([xw, torch.complex(xr, xi)])[-nh:])
        return self.xw_to_state(tail)


def _check_pfb(pipe, xr, xi, xwr, xwi, width_out):
    T = xr.shape[-1]
    if xr.dim() != 1 or xi.shape != xr.shape:
        raise ValueError("xr/xi must be 1-D planes of one length")
    if T % pipe.M:
        raise ValueError(f"block length {T} not a multiple of M={pipe.M}")
    if xwr.shape != (pipe.n_hist,) or xwi.shape != (pipe.n_hist,):
        raise ValueError(f"history planes must hold {pipe.n_hist} samples")
    if width_out < 2 * T // pipe.M:
        raise ValueError(f"width {width_out} < {2 * T // pipe.M} frames")
    return T


def pfb_bins_ref(pipe, xr, xi, xwr, xwi, width_out: int, tap_dtype,
                 out_dtype) -> torch.Tensor:
    """Plain PyTorch K5: bins [2M, width_out] in ``out_dtype``."""
    T = _check_pfb(pipe, xr, xi, xwr, xwi, width_out)
    M, h, K0, tpp = pipe.M, pipe.h, pipe.K0, pipe.tpp
    br, cm, sm = pipe.operands(xr.device, tap_dtype)
    need = (width_out - 1) * h + K0
    pad = max(0, need - pipe.n_hist - T)
    planes = []
    for hist, xx in ((xwr, xr), (xwi, xi)):
        s = torch.cat([hist.float(), xx.float(),
                       torch.zeros(pad, device=xx.device)])
        win = s.unfold(0, K0, h)[:width_out].reshape(width_out, tpp, M)
        planes.append((win * br.t()[None]).sum(dim=1))        # [W, M]
    vr, vi = planes
    re = vr @ cm.t() + vi @ sm.t()
    im = vi @ cm.t() - vr @ sm.t()
    sgn = torch.where(torch.arange(M, device=xr.device) % 2 == 0, 1.0, -1.0)
    even = (torch.arange(width_out, device=xr.device) % 2 == 0)[:, None]
    re = torch.where(even, re * sgn, re)
    im = torch.where(even, im * sgn, im)
    return torch.cat([re.t(), im.t()]).to(out_dtype).contiguous()


@_build.counted
def pfb_bins_kernel(pipe, xr, xi, xwr, xwi, width_out: int, tap_dtype,
                    out_dtype) -> torch.Tensor:
    """K5 on the card (csrc/pfb_channelizer.cu); same contract as
    ``pfb_bins_ref``."""
    dev = xr.device
    f32 = torch.float32
    T = _check_pfb(pipe, xr, xi, xwr, xwi, width_out)
    if out_dtype not in _STORAGE:
        raise ValueError(f"output dtype {out_dtype}")
    br, cm, sm = pipe.operands(dev, tap_dtype)
    out = torch.empty((2 * pipe.M, width_out), dtype=out_dtype, device=dev)
    _build.launch(
        "sdr_pfb_bins", dev,
        _build.check(xr, "xr", f32, device=dev),
        _build.check(xi, "xi", f32, (T,), dev), T,
        _build.check(xwr, "history re", f32, device=dev),
        _build.check(xwi, "history im", f32, device=dev), pipe.n_hist,
        _build.check(br, "branch taps", f32, device=dev),
        _build.check(cm, "dft cos", f32, device=dev),
        _build.check(sm, "dft sin", f32, device=dev), pipe.M, pipe.tpp,
        out.data_ptr(), int(out_dtype == torch.bfloat16), width_out)
    return out


def pfb_bins(pipe, xr, xi, xwr, xwi, width_out: int, tap_dtype, out_dtype):
    """K5 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = pfb_bins_kernel if xr.is_cuda else pfb_bins_ref
    return fn(pipe, xr, xi, xwr, xwi, width_out, tap_dtype, out_dtype)
