"""Post-channelizer front end — kernel K6 and its plain version
(counterpart of sdrplusplusbrown_tpu/ops/chan_frontend.py, whose
``_chan_kernel`` body also runs inside ``_chan_fused_kernel_v3``).

Per channel c, from the stacked PFB bins [2P, Tb_pad] (ops/
channelizer_kernel.py): the whole plane pair (P = M), or the rows a
channelized bank had K5 compute, channel c's at rows c and C + c (P = C,
the bin index 0 .. C − 1):

  1. gather row ``bin[c]`` of each plane and rotate by the residual NCO,
         z[n] = (bins[bin[c], n] + j·bins[P + bin[c], n]) · e^{jθ_c(n)},
         θ_c(n) = ((ph0 + span·i) + bs·b) + ω·j,  n = i·adv0 + 128·b + j,
     each operation rounded to float32 on its own, as the TPU kernel
     evaluates it (the spans are host-float64 products reduced mod 2π);
  2. the 2:1 anti-alias FIR (``d2``) and the bandwidth FIR (``fir``),
     overlap-save over the carried complex tails;
  3. Σ|y| over the VALID outputs (the squelch's whole-block mean; the
     padded tail of the output is garbage by design).

The output is the untrimmed [2C, n_super·adv_f] IF buffer (re rows over
im rows) plus its valid width; taps and carried tails are rounded to the
handoff storage dtype where the JAX kernel rounds them.

Dispatch follows the input: CPU tensors run ``chan_post_ref``; CUDA
tensors launch ``chan_post_kernel`` (csrc/chan_post.cu: the gather and
NCO in the 2:1 FIR's staging, both FIRs on the polyphase FIR tile, in
``chan_post_plan``'s two launches) or raise.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import _build
from .fir_kernel import SMS, tile_smem
from .precision import get_handoff_dtype, round_to
from .xlator import advance_phase

BS = 128          # NCO block (the TPU kernel's lane width)
SPAN = 2048       # baked span of the ``xl_sup`` param (bin-rate samples)
# outputs a lane each launch may take, first choice first
# (csrc/chan_post.cu instantiates these)
D2_OUTS_PER_LANE = (5, 3, 1)
FIR_OUTS_PER_LANE = (7, 5, 3, 1)

_STORAGE = (torch.float32, torch.bfloat16)


def _rup(n: int, a: int) -> int:
    return (n + a - 1) // a * a


class ChanPostPipeline:
    """K6 configuration built from a ChannelizedRxVFOBank: the d2 and
    bandwidth FIR designs and the TPU kernel's step geometry (adv0 bin
    samples in, adv_f IF samples out per step), which fixes the NCO's
    (i, b, j) decomposition and the padded output width."""

    def __init__(self, bank):
        self.M = int(bank.M)
        if not bank.filter_needed:
            raise NotImplementedError("post-channelizer without a "
                                      "bandwidth FIR")
        blocks = [("d2", bank.decim2), ("fir", bank.fir)]
        if bank.decim2.decim != 2 or bank.fir.decim != 1:
            raise NotImplementedError("post-channelizer stages must be "
                                      "a 2:1 FIR then a 1:1 FIR")
        self.names = [n for n, _ in blocks]
        self.taps = [np.asarray(b.taps, np.float32) for _, b in blocks]
        if any(np.iscomplexobj(t) for t in self.taps):
            raise NotImplementedError("complex-tap post-channelizer stage")
        self.hists = [len(t) - 1 for t in self.taps]
        # the TPU kernel's choice of advances (its VMEM cap aside)
        for k in (4, 8, 2, 16, 1):
            advs = [128 * k]
            for _, b in reversed(blocks):
                advs.insert(0, advs[0] * b.decim)
            if all(_rup(h, 128) + a >= max(127 * b.decim + h + 1,
                                            _rup(h + 127, 128))
                   for h, a, (_, b) in zip(self.hists, advs, blocks)):
                break
        else:
            raise NotImplementedError("no step geometry for these stages")
        self.adv0, self.adv_f = advs[0], advs[-1]
        self._dev = {}

    def plan(self, Tb: int) -> dict:
        """Valid lengths after each stage, the step count and the padded
        bin width for ``Tb`` valid bin samples."""
        m = [Tb, Tb // 2, Tb // 2]
        n_super = -(-m[-1] // self.adv_f)
        return {"m": m, "n_super": n_super, "Tb_pad": n_super * self.adv0,
                "n_out": n_super * self.adv_f}

    def dev_taps(self, device, dtype) -> List[torch.Tensor]:
        key = (str(device), dtype)
        if key not in self._dev:
            self._dev[key] = [round_to(torch.from_numpy(t), dtype)
                              .to(device).contiguous() for t in self.taps]
        return self._dev[key]

    def apply(self, params, state, bins, Tb: int, raw: bool = False,
              bin_idx=None):
        """bins: [2M, Tb_pad] stacked PFB planes with ``Tb`` valid frames,
        or [2C, Tb_pad] of the channels' gathered rows with ``bin_idx``
        0 .. C − 1 (default: ``params["bin"]``, the whole plane's bins) →
        (y, sq_sums [C], state') with y the complex [C, m_if] IF, or with
        ``raw`` (buf [2C, n_out] in the handoff dtype, m_if)."""
        plan = self.plan(Tb)
        C = params["xl"]["omega"].shape[0]
        if tuple(bins.shape) not in ((2 * self.M, plan["Tb_pad"]),
                                     (2 * C, plan["Tb_pad"])):
            raise ValueError(f"bins shape {tuple(bins.shape)}, expected "
                             f"{(2 * self.M, plan['Tb_pad'])} or "
                             f"{(2 * C, plan['Tb_pad'])}")
        h_dt = get_handoff_dtype()
        om = params["xl"]["omega"]
        phase0 = state["xl"]
        a_sup, rem = divmod(self.adv0, SPAN)
        span_adv = params["xl_sup"] * a_sup + params["xl_bs"] * (rem // BS)
        tails = [round_to(torch.cat([state[n].real, state[n].imag])
                          .float(), h_dt).contiguous() for n in self.names]
        out, sq, new_tails = chan_post(
            self, bins, params["bin"] if bin_idx is None else bin_idx,
            om.contiguous(), phase0.contiguous(),
            span_adv.contiguous(), params["xl_bs"].contiguous(), tails, Tb,
            h_dt if raw else torch.float32, h_dt)
        C = om.shape[0]
        m_out = plan["m"][-1]
        y = (out, m_out) if raw else torch.complex(out[:C, :m_out],
                                                   out[C:, :m_out])
        new_state = dict(state)
        new_state["xl"] = advance_phase(phase0, om,
                                        params["xl"]["omega_span"], Tb)
        for name, t in zip(self.names, new_tails):
            new_state[name] = torch.complex(t[:C], t[C:])
        return y, sq, new_state


def _check_post(pipe, bins, bin_idx, om, tails, Tb):
    C = om.shape[0]
    plan = pipe.plan(Tb)
    if bins.dim() != 2 or bins.shape[0] not in (2 * pipe.M, 2 * C) or \
            bins.shape[1] != plan["Tb_pad"]:
        raise ValueError(f"bins shape {tuple(bins.shape)}")
    if tuple(bin_idx.shape) != (C,):
        raise ValueError(f"bin index shape {tuple(bin_idx.shape)}")
    for h, t in zip(pipe.hists, tails):
        if tuple(t.shape) != (2 * C, h):
            raise ValueError(f"tail shape {tuple(t.shape)}")
    return C, plan


def nco_phase(pipe, om, ph0, span_adv, sbs, n: int) -> torch.Tensor:
    """[C, n] NCO angles of bin samples 0..n−1, evaluated as the TPU
    kernel does: ((ph0 + span·i) + bs·b) + ω·j, one rounding per op."""
    dev = om.device
    idx = torch.arange(n, device=dev)
    i = (idx // pipe.adv0).float()
    b = ((idx % pipe.adv0) // BS).float()
    j = (idx % BS).float()
    return ((ph0[:, None] + span_adv[:, None] * i)
            + sbs[:, None] * b) + om[:, None] * j


def _fir_rows(ext: torch.Tensor, taps: torch.Tensor, decim: int):
    return F.conv1d(ext[:, None, :], taps[None, None, :],
                    stride=decim)[:, 0]


def chan_post_ref(pipe, bins, bin_idx, om, ph0, span_adv, sbs, tails, Tb,
                  out_dtype, tail_dtype):
    """Plain PyTorch K6: (out [2C, n_out] ``out_dtype``, Σ|y| over the
    valid outputs [C] float32, next-call tails [[2C, hist] float32
    rounded to ``tail_dtype``]).  ``bins`` [2P, Tb_pad]: channel c's rows
    bin_idx[c] and P + bin_idx[c]."""
    return _chan_post_ref(pipe, bins, bin_idx, om, ph0, span_adv, sbs,
                          tails, Tb, out_dtype, tail_dtype)[:3]


def _chan_post_ref(pipe, bins, bin_idx, om, ph0, span_adv, sbs, tails, Tb,
                   out_dtype, tail_dtype):
    """``chan_post_ref``'s three results, then the rotated bins z
    complex64 [C, Tb_pad] and the 2:1 FIR's output y1 complex64
    [C, n_out]."""
    C, plan = _check_post(pipe, bins, bin_idx, om, tails, Tb)
    taps = pipe.dev_taps(bins.device, tail_dtype)
    n = plan["Tb_pad"]
    b = bins.float()
    P = bins.shape[0] // 2
    zr, zi = b[bin_idx.long()], b[P + bin_idx.long()]
    ang = nco_phase(pipe, om, ph0, span_adv, sbs, n)
    co, si = torch.cos(ang), torch.sin(ang)
    y = torch.cat([zr * co - zi * si, zr * si + zi * co])      # [2C, n]
    new_tails, ins = [], []
    for s, (h, t, tp) in enumerate(zip(pipe.hists, tails, taps)):
        ins.append(torch.complex(y[:C], y[C:]))
        ext = torch.cat([t, y], dim=1)
        m_in = plan["m"][s]
        new_tails.append(round_to(ext[:, m_in:m_in + h], tail_dtype))
        y = _fir_rows(ext, tp, 2 if s == 0 else 1)
    m_out = plan["m"][-1]
    mag = torch.sqrt(y[:C, :m_out] ** 2 + y[C:, :m_out] ** 2)
    return (y[:, :plan["n_out"]].to(out_dtype).contiguous(), mag.sum(-1),
            new_tails, *ins)


# ---- K6's plan (csrc/chan_post.cu) ------------------------------------------

def _post_grid(n: int, C: int, D: int, kw: int, Ps: tuple) -> dict:
    """One launch's FIR-tile grid over C rows of n complex outputs: 8
    warps a block, ``P`` outputs a lane, the first of ``Ps`` that still
    gives SMS blocks, and ``C`` chunks of 32·P outputs a block (a warp
    each), halved from 8 until the launch has 2 blocks an SM (or C = 1):
    larger blocks stage less halo (K2 − 1 samples a block)."""
    for P in Ps:
        n_c = -(-n // (32 * P))
        Cc = min(8, n_c)
        while Cc > 1 and C * -(-n_c // Cc) < 2 * SMS:
            Cc = (Cc + 1) // 2
        if C * -(-n_c // Cc) >= SMS:
            break
    grid = (-(-n_c // Cc), 1, C)
    return {"P": P, "G": 1, "C": Cc, "warps": 8, "grid": grid,
            "blocks": math.prod(grid), "n_m": n,
            "smem": tile_smem(D, kw, n, P, 1, Cc, 2)}


def chan_post_plan(pipe, Tb: int, C: int) -> dict:
    """How K6 runs C channels of ``Tb`` bin frames in two launches on the
    FIR tile, each over the n_out outputs of its stage (y1 [C, n_out]
    through an HBM scratch, the IF [2C, n_out]): the 2:1 FIR's grid
    ``d2`` (P up to 5) and the bandwidth FIR's ``fir`` (P up to 7: its
    304 taps take 2P multiply-adds a tap read; the d2 launch's staging
    gains nothing from 7, the bandwidth launch loses at 9), each
    ``_post_grid``'s; ``n_tiles``, the fir launch's chunks of a row (one
    squelch partial each).
    ``scripts/chan_post_sweep.py --plans`` ranks both grids."""
    n_out = pipe.plan(Tb)["n_out"]
    d2 = _post_grid(n_out, C, 2, len(pipe.taps[0]), D2_OUTS_PER_LANE)
    fir = _post_grid(n_out, C, 1, len(pipe.taps[1]), FIR_OUTS_PER_LANE)
    return {"n1": n_out, "d2": d2, "fir": fir, "n_tiles": fir["grid"][0],
            "launches": 2}


@_build.counted_launches
def chan_post_kernel(pipe, bins, bin_idx, om, ph0, span_adv, sbs, tails, Tb,
                     out_dtype, tail_dtype):
    """K6 on the card (csrc/chan_post.cu, ``chan_post_plan``'s two
    launches, each counted in ``launches``); same contract as
    ``chan_post_ref``.  The squelch sums come back per output tile and
    are summed over the tiles by one torch reduction on the device (no
    atomics, no host copy)."""
    return _chan_post_launches(pipe, bins, bin_idx, om, ph0, span_adv, sbs,
                               tails, Tb, out_dtype, tail_dtype)[:3]


def _chan_post_launches(pipe, bins, bin_idx, om, ph0, span_adv, sbs, tails,
                        Tb, out_dtype, tail_dtype, probe: bool = False,
                        plan: dict | None = None):
    """K6's launches on ``plan`` (``chan_post_plan``'s by default):
    ``chan_post_kernel``'s three results, then [z (with ``probe``, else
    None) complex64 [C, Tb_pad], y1 complex64 [C, n_out]]."""
    dev = bins.device
    f32 = torch.float32
    C, geo = _check_post(pipe, bins, bin_idx, om, tails, Tb)
    if out_dtype not in _STORAGE or tail_dtype not in _STORAGE:
        raise ValueError(f"dtypes {out_dtype}, {tail_dtype}")
    p = plan or chan_post_plan(pipe, Tb, C)
    taps = pipe.dev_taps(dev, tail_dtype)
    m1, m_out, n_out = geo["m"][1], geo["m"][-1], geo["n_out"]
    n1 = p["n1"]
    out = torch.empty((2 * C, n_out), dtype=out_dtype, device=dev)
    sq = torch.empty((C, p["n_tiles"]), dtype=f32, device=dev)
    t_d2 = torch.empty((2 * C, pipe.hists[0]), dtype=f32, device=dev)
    t_fir = torch.empty((2 * C, pipe.hists[1]), dtype=f32, device=dev)
    y1 = torch.empty((C, n1), dtype=torch.complex64, device=dev)
    z = torch.empty((C, geo["Tb_pad"]), dtype=torch.complex64,
                    device=dev) if probe else None
    t_bf16 = int(tail_dtype == torch.bfloat16)
    a, b = p["d2"], p["fir"]
    _build.launch(
        "sdr_chan_post_d2", dev,
        _build.check(bins, "bins", _STORAGE, device=dev),
        int(bins.dtype == torch.bfloat16), bins.shape[0] // 2, geo["Tb_pad"],
        Tb,
        _build.check(bin_idx, "bin index", torch.int32, (C,), dev),
        _build.check(om, "omega", f32, (C,), dev),
        _build.check(ph0, "phase", f32, (C,), dev),
        _build.check(span_adv, "span", f32, (C,), dev),
        _build.check(sbs, "block span", f32, (C,), dev), pipe.adv0,
        _build.check(tails[0], "d2 tail", f32, device=dev),
        _build.check(taps[0], "d2 taps", f32, device=dev), taps[0].shape[0],
        y1.data_ptr(), n1, t_d2.data_ptr(), t_bf16,
        None if z is None else z.data_ptr(), C, a["P"], a["C"], a["warps"])
    _build.launch(
        "sdr_chan_post_fir", dev,
        _build.check(tails[1], "fir tail", f32, device=dev), y1.data_ptr(),
        n1, _build.check(taps[1], "fir taps", f32, device=dev),
        taps[1].shape[0], out.data_ptr(), int(out_dtype == torch.bfloat16),
        n_out, m_out, sq.data_ptr(), p["n_tiles"], m1, t_fir.data_ptr(),
        t_bf16, C, b["P"], b["C"], b["warps"])
    return out, sq.sum(-1), [t_d2, t_fir], [z, y1]


def chan_post(pipe, bins, bin_idx, om, ph0, span_adv, sbs, tails, Tb,
              out_dtype, tail_dtype):
    """K6 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = chan_post_kernel if bins.is_cuda else chan_post_ref
    return fn(pipe, bins, bin_idx, om, ph0, span_adv, sbs, tails, Tb,
              out_dtype, tail_dtype)
