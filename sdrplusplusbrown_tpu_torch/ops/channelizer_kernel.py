"""The polyphase WOLA channelizer, 2×-oversampled and critically sampled —
kernel K5 and its plain version (counterpart of
sdrplusplusbrown_tpu/ops/pallas_channelizer.py, whose V3 ``_chz3_kernel``
and the V2 / V1 forms compute this same function in both forms).

With s = [last K0 − h wideband samples | x | zeros], hop h and K0 = tpp·M,
every output frame F is one window of the stream:

    v_F[p]     = Σ_i br[p, i] · s[F·h + i·M + p]
    bins[m, F] = σ_{m,F} · Σ_p v_F[p] · e^{−2πi·mp/M}

  * 2×-oversampled (OversampledChannelizer, h = M/2): σ_{m,F} = (−1)^m on
    even frames and 1 on odd ones.  The even frames are the delayed pass
    of that block (its (−1)^m twiddle), the odd ones its plain pass.
  * critically sampled (PolyphaseChannelizer, h = M): σ = 1.  Frame F is
    the block's k = F output, v_F[p] = Σ_i br[p, i]·s[(F + i)·M + p], the
    history tpp − 1 whole rows of M samples.

The output is the stacked [2M, width] plane pair (re rows over im rows) in
the handoff storage dtype; frames past T/h are computed from the
zero-extended stream and are garbage for the consumer to ignore, as on the
TPU.  The branch taps and the DFT matrix are float64 designs rounded to
float32 and then to the handoff dtype, where the JAX kernel rounds them.

Dispatch follows the input: CPU tensors run ``pfb_bins_ref``; CUDA
tensors launch csrc/pfb_channelizer.cu (``pfb_bins_kernel`` for the
oversampled form, ``pfb_critical_bins_kernel`` for the critical one) or
raise, also on a geometry the kernel cannot take.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build
from .precision import get_handoff_dtype, round_to

_STORAGE = (torch.float32, torch.bfloat16)
PFB_FRAMES = 32      # frames per CUDA block (csrc/pfb_channelizer.cu)


class PFBChannelizer:
    """K5 configuration built from an OversampledChannelizer: hop M/2, the
    (−1)^m sign on even frames, the block's {tail_a, tail_b, delay} state
    dict."""

    critical = False

    def __init__(self, chz):
        self.M = M = int(chz.M)
        self.h = M if self.critical else M // 2
        self.tpp = int(chz.tpp)
        self.K0 = self.tpp * M
        self.branches = np.asarray(chz.branches, np.float32)     # [M, tpp]
        ang = 2.0 * np.pi * np.outer(np.arange(M), np.arange(M)) / M
        self.cos = np.cos(ang).astype(np.float32)
        self.sin = np.sin(ang).astype(np.float32)
        self._dev = {}

    @property
    def n_hist(self) -> int:
        """Wideband samples carried between calls (K0 − h)."""
        return self.K0 - self.h

    def check_kernel_geometry(self) -> None:
        """Raise unless csrc/pfb_channelizer.cu takes this geometry: even
        M <= 64 (the DFT matrices and the frames' span in shared memory),
        at least two taps per branch."""
        if self.tpp < 2 or self.M % 2 or self.M > 64:
            raise NotImplementedError(
                f"PFB kernel geometry M={self.M}, tpp={self.tpp}")

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

    def apply(self, state, x, width_out: int, out_dtype=None,
              tap_dtype=None):
        """x: (xr, xi) float32 [T] planes → (bins [2M, width_out] in
        ``out_dtype`` (default: the handoff dtype), state'); the taps
        rounded to ``tap_dtype`` (default: the handoff dtype)."""
        h_dt = get_handoff_dtype()
        out_dtype = h_dt if out_dtype is None else out_dtype
        tap_dtype = h_dt if tap_dtype is None else tap_dtype
        xr, xi = x
        xr = xr.float().contiguous()
        xi = xi.float().contiguous()
        xw = self.state_to_xw(state)
        bins = pfb_bins(self, xr, xi, xw.real.contiguous(),
                        xw.imag.contiguous(), width_out, tap_dtype, out_dtype)
        return bins, self.next_state(xw, xr, xi)

    def next_state(self, xw, xr, xi):
        """The state after a call on (xr, xi) from history ``xw``: the
        last n_hist samples of [xw | x], in the block's layout."""
        T, nh = xr.shape[-1], self.n_hist
        tail = (torch.complex(xr[T - nh:], xi[T - nh:]) if T >= nh
                else torch.cat([xw, torch.complex(xr, xi)])[-nh:])
        return self.xw_to_state(tail)


class PFBCritical(PFBChannelizer):
    """K5's critically sampled configuration, built from a
    PolyphaseChannelizer: hop M, no sign, the block's [M, tpp − 1] branch
    history (column j of row p is sample j·M + p of the last (tpp − 1)·M),
    converted exactly as the JAX package's ``PallasPolyChannelizer`` does."""

    critical = True

    def state_to_xw(self, state) -> torch.Tensor:
        return state.transpose(-1, -2).reshape(
            state.shape[:-2] + ((self.tpp - 1) * self.M,))

    def xw_to_state(self, xw: torch.Tensor) -> torch.Tensor:
        return xw.reshape(xw.shape[:-1] + (self.tpp - 1, self.M)) \
            .transpose(-1, -2).contiguous()


def _check_pfb(pipe, xr, xi, xwr, xwi, width_out):
    T = xr.shape[-1]
    if xr.dim() != 1 or xi.shape != xr.shape:
        raise ValueError("xr/xi must be 1-D planes of one length")
    if T % pipe.M:
        raise ValueError(f"block length {T} not a multiple of M={pipe.M}")
    if xwr.shape != (pipe.n_hist,) or xwi.shape != (pipe.n_hist,):
        raise ValueError(f"history planes must hold {pipe.n_hist} samples")
    if width_out < T // pipe.h:
        raise ValueError(f"width {width_out} < {T // pipe.h} frames")
    return T


def pfb_bins_ref(pipe, xr, xi, xwr, xwi, width_out: int, tap_dtype,
                 out_dtype) -> torch.Tensor:
    """Plain PyTorch K5, either form: bins [2M, width_out] in
    ``out_dtype``."""
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
    if not pipe.critical:
        sgn = torch.where(torch.arange(M, device=xr.device) % 2 == 0,
                          1.0, -1.0)
        even = (torch.arange(width_out, device=xr.device) % 2 == 0)[:, None]
        re = torch.where(even, re * sgn, re)
        im = torch.where(even, im * sgn, im)
    return torch.cat([re.t(), im.t()]).to(out_dtype).contiguous()


def _launch_pfb(pipe, xr, xi, xwr, xwi, width_out: int, tap_dtype,
                out_dtype) -> torch.Tensor:
    """One launch of csrc/pfb_channelizer.cu, either form."""
    dev = xr.device
    f32 = torch.float32
    T = _check_pfb(pipe, xr, xi, xwr, xwi, width_out)
    if out_dtype not in _STORAGE:
        raise ValueError(f"output dtype {out_dtype}")
    pipe.check_kernel_geometry()
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
        pipe.h, int(not pipe.critical), out.data_ptr(),
        int(out_dtype == torch.bfloat16), width_out)
    return out


@_build.counted
def pfb_bins_kernel(pipe, xr, xi, xwr, xwi, width_out: int, tap_dtype,
                    out_dtype) -> torch.Tensor:
    """K5 on the card, 2×-oversampled form; same contract as
    ``pfb_bins_ref``."""
    if pipe.critical:
        raise ValueError("a critically sampled PFB: pfb_critical_bins_kernel")
    return _launch_pfb(pipe, xr, xi, xwr, xwi, width_out, tap_dtype,
                       out_dtype)


@_build.counted
def pfb_critical_bins_kernel(pipe, xr, xi, xwr, xwi, width_out: int,
                             tap_dtype, out_dtype) -> torch.Tensor:
    """K5 on the card, critically sampled form (hop M, no sign); same
    contract as ``pfb_bins_ref``."""
    if not pipe.critical:
        raise ValueError("a 2×-oversampled PFB: pfb_bins_kernel")
    return _launch_pfb(pipe, xr, xi, xwr, xwi, width_out, tap_dtype,
                       out_dtype)


#: the plain version of the critical form is ``pfb_bins_ref``
pfb_critical_bins_ref = pfb_bins_ref


def pfb_bins(pipe, xr, xi, xwr, xwi, width_out: int, tap_dtype, out_dtype):
    """K5 dispatch: the form's kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if not xr.is_cuda:
        fn = pfb_bins_ref
    elif pipe.critical:
        fn = pfb_critical_bins_kernel
    else:
        fn = pfb_bins_kernel
    return fn(pipe, xr, xi, xwr, xwi, width_out, tap_dtype, out_dtype)
