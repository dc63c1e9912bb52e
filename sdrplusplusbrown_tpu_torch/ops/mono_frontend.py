"""Shared-VFO front end — kernel K1 and its plain version (counterpart of
sdrplusplusbrown_tpu/ops/mono_frontend.py).

The whole decimation chain of ``SharedRxVFOBank`` for C channels of one
shared wideband: stage 0 mixes each channel by its NCO and decimates
through the channel-independent first FIR (ops/fused_frontend.py), then
the chained stages (polyphase resampler, bandwidth FIR) follow on the
[2C, m] re/im planes.  The output is the raw handoff buffer [2C, m_if]
(re rows, then im rows) in the handoff storage dtype (ops/precision.py).

The mix phase is the TPU kernel's, bit for bit in float32: per TPU grid
window i (``adv_x`` wideband samples) and 1024-sample block u a base
phase built from host-float64 params, plus omega·j for j < 1024, each
operation rounded on its own (a fused multiply-add differs by an ulp of
the ~1e3 rad sum, which costs ~40 dB of agreement).  The window geometry
therefore comes from the same solver as the JAX package
(``_solve_geometry``), though nothing here runs a sequential grid.

Every stage computes its new carried tail (the last ``carry`` samples of
concat(tail, input)) rounded to the tail dtype, so the caller keeps no
concat, slice or rounding of its own.  ``mix_plan`` sizes stage 0's grid
on the card: blocks of one channel's outputs inside one TPU window.

Dispatch follows the input: CPU tensors run ``mono_frontend_ref``; CUDA
tensors launch ``mono_frontend_kernel`` (csrc/mono_frontend.cu) or raise.
"""

from __future__ import annotations

import functools
from math import gcd
from typing import List

import numpy as np
import torch

from ..kernels import _build
from .precision import get_handoff_dtype, round_to
from .fir_kernel import (OUTS_PER_LANE, SMEM_MAX, SMS, fir_plan, poly_rows,
                         tile_smem)
from .xlator import _TWO_PI, advance_phase, fmod_floor

ALIGN1D = 1024       # mix-phase block (the TPU kernel's 1-D DMA granularity)
BS = 256             # decimated advance granularity of a window
SUP_SPAN = 2048      # omega_dec_sup span baked into the fused params
MAX_ADVX = 1 << 18
MIN_ADVX = 8192
MIX_CHUNKS = (4, 2, 1)   # stage 0: chunks of 32·P outputs a block, tried
_STORAGE = (torch.float32, torch.bfloat16)   # the handoff's storage dtypes


def _solve_geometry(stages_raw, D0: int):
    """The TPU kernel's per-window advances (adv list incl. adv0 at index
    0, adv_x), which fix the mix phase's window boundaries; None when no
    geometry fits."""
    for k in range(1, 4097):
        adv_f = 128 * k
        advs = [adv_f]
        ok = True
        for st in reversed(stages_raw):
            a = advs[0]
            if a % st["tile"]:
                ok = False
                break
            if st["kind"] == "poly":
                if a % st["interp"]:
                    ok = False
                    break
                a = a * st["decim"] // st["interp"]
            else:
                a = a * st["D"]
            if a % 128:
                ok = False
                break
            advs.insert(0, a)
        if not ok:
            continue
        adv0 = advs[0]
        adv_x = adv0 * D0
        if adv0 % BS or adv_x % ALIGN1D or adv_x < MIN_ADVX:
            continue
        if adv_x > MAX_ADVX:
            return None
        return advs, adv_x
    return None


def _chain(bank):
    """(stage list for ``_solve_geometry``, stage list for the kernel) of
    a SharedRxVFOBank's chain after stage 0."""
    raw, stages = [], []
    for blk in bank.stage_blocks():
        if hasattr(blk, "interp"):
            I, M = int(blk.interp), int(blk.decim)
            mt = 128 // gcd(I, 128)
            raw.append({"kind": "poly", "interp": I, "decim": M,
                        "tile": mt * I})
            stages.append({"I": I, "D": M, "carry": blk.tpp - 1,
                           "kernel": np.asarray(blk.kernel)})
        else:
            if blk._complex_taps:
                raise NotImplementedError("complex-tap front-end stage")
            raw.append({"kind": "decim", "D": int(blk.decim), "tile": 128})
            stages.append({"I": 1, "D": int(blk.decim), "carry": blk.K - 1,
                           "kernel": np.asarray(blk.taps)[None, :]})
    return raw, stages


def solves(bank) -> bool:
    """True when K1 takes this bank's chain: the JAX package's window
    solver finds a geometry, as its ``_mono_kernel`` needs."""
    return _solve_geometry(_chain(bank)[0], int(bank.fused.decim)) is not None


class MonoVFOPipeline:
    """Static geometry of a SharedRxVFOBank's chain; ``apply`` runs it."""

    def __init__(self, bank):
        self.h0 = np.asarray(bank.fused.taps, np.float64)
        self.K0 = len(self.h0)
        self.D0 = int(bank.fused.decim)
        self.bank = bank
        raw, self.stages = _chain(bank)
        sol = _solve_geometry(raw, self.D0)
        if sol is None:
            raise NotImplementedError("no window geometry for this chain")
        advs, self.adv_x = sol
        self.adv0, self.adv_f = advs[0], advs[-1]
        self._dev_taps = {}

    def lengths(self, T: int) -> List[int]:
        """Valid length after each stage, stage 0 first."""
        if T % self.D0:
            raise ValueError(f"block length {T} not a multiple of {self.D0}")
        m = [T // self.D0]
        for st in self.stages:
            if (m[-1] * st["I"]) % st["D"]:
                raise ValueError(f"stage length {m[-1]} not a multiple of "
                                 f"{st['D']}")
            m.append(m[-1] * st["I"] // st["D"])
        return m

    def n_super(self, T: int) -> int:
        return -(-self.lengths(T)[-1] // self.adv_f)

    def taps(self, device, dtype):
        """(h0, [stage kernels]) as float32 device tensors whose values are
        rounded to the handoff storage ``dtype`` (the JAX kernel stores
        its tap matrices in that dtype)."""
        key = (str(device), dtype)
        if key not in self._dev_taps:
            def t(a):
                return round_to(torch.tensor(np.asarray(a, np.float32)),
                                dtype).to(device).contiguous()
            self._dev_taps[key] = (t(self.h0),
                                   [t(st["kernel"]) for st in self.stages])
        return self._dev_taps[key]

    def base_phases(self, params, phase, T: int) -> torch.Tensor:
        """[C, n_super, nbw] float32 mix base phases, the TPU kernel's
        expression evaluated op by op in float32."""
        dev = phase.device
        n_super = self.n_super(T)
        phase0 = fmod_floor(phase + np.pi, _TWO_PI) - np.pi
        a_sup, rem = divmod(self.adv0, SUP_SPAN)
        span_adv = (params["omega_dec_sup"] * a_sup
                    + params["omega_dec_bs"] * (rem // BS))
        om_mb = params["omega_mb"]
        nbw = (ALIGN1D + self.adv_x) // ALIGN1D
        ii = torch.arange(n_super, dtype=torch.float32, device=dev)
        uu = torch.arange(nbw, dtype=torch.float32, device=dev)
        return (phase0[:, None, None] - om_mb[:, None, None]
                + span_adv[:, None, None] * ii[None, :, None]
                + om_mb[:, None, None] * uu[None, None, :]).contiguous()

    def apply(self, params, state, x, raw: bool = True):
        """x: (xr, xi) float32 [T] planes of the shared wideband →
        (buf [2C, m_if], new_state): the handoff dtype for ``raw`` (the
        K2/K7 consumers), float32 otherwise, as the JAX kernel writes its
        trimmed outputs; the taps are rounded to the handoff dtype
        either way."""
        xr, xi = x
        xr = xr.float().contiguous()
        xi = xi.float().contiguous()
        T = xr.shape[-1]
        omega = params["omega"].contiguous()
        C = omega.shape[0]
        fused = state["fused"]
        tail = fused["tail"]
        phase = fused["phase"]
        h_dt = get_handoff_dtype()
        # narrow banks keep float32 tails, as the JAX kernel does
        t_dt = h_dt if C >= 16 else torch.float32
        tails = [t.contiguous() for t in self.bank.stage_tails(state)]
        base = self.base_phases(params, phase, T)
        buf, new_tails = mono_frontend(
            self, xr, xi, tail.contiguous(), omega, base, tails,
            h_dt if raw else torch.float32, h_dt, t_dt)

        new_state = dict(state)
        K0 = self.K0
        new_tail = (torch.complex(xr[T - (K0 - 1):], xi[T - (K0 - 1):])
                    if T >= K0 - 1 else
                    torch.cat([tail, torch.complex(xr, xi)])[T:])
        new_phase = advance_phase(phase, omega, params["omega_span"], T)
        new_state["fused"] = {"tail": new_tail,
                              "phase": torch.broadcast_to(new_phase,
                                                          (C,)).clone()}
        self.bank.write_tails(new_state, new_tails)
        return buf, new_state


@functools.lru_cache(maxsize=None)
def mix_plan(m0: int, adv0: int, C: int, K0: int, D0: int) -> dict:
    """Stage 0's grid on the card (csrc/mono_frontend.cu:sdr_mono_mix): a
    block takes mb = Cc·32·P consecutive outputs of one channel inside one
    TPU window (the windows' overlap samples are mixed at each window's
    own base phase, so a block that straddled two would mix some at the
    wrong one): ``bpw`` = ceil(adv0 / mb) blocks a window, the last of a
    window and those of a partial last window shorter.  The first (P, Cc)
    in order of OUTS_PER_LANE and MIX_CHUNKS whose blocks leave at most a
    quarter of their lanes idle, fit SMEM_MAX and number >= SMS; else,
    of those that fit and idle at most a quarter, the one with the most
    blocks; else P = Cc = 1.  4 warps a block: a warp a chunk.  Returns
    P, Cc, warps, bpw, grid, blocks, smem, m_block."""
    if min(m0, adv0, C, K0, D0) < 1:
        raise ValueError(f"stage-0 plan: m0={m0} adv0={adv0} C={C} K0={K0}")
    n_win = -(-m0 // adv0)
    last = m0 - (n_win - 1) * adv0
    best = None
    for P in OUTS_PER_LANE:
        for Cc in MIX_CHUNKS:
            mb = Cc * 32 * P
            bpw = -(-adv0 // mb)
            gx = (n_win - 1) * bpw + -(-last // mb)
            smem = tile_smem(D0, K0, m0, P, 1, Cc, 2)
            plan = {"P": P, "Cc": Cc, "warps": 4, "bpw": bpw,
                    "grid": (gx, 1, C), "blocks": gx * C, "smem": smem,
                    "m_block": mb}
            if (P, Cc) == (1, 1) and best is None:
                best = plan
            if smem > SMEM_MAX or 4 * (gx * mb - m0) > gx * mb:
                continue
            if plan["blocks"] >= SMS:
                return plan
            if best is None or plan["blocks"] > best["blocks"]:
                best = plan
    if best["smem"] > SMEM_MAX:
        raise ValueError(f"stage-0 plan: {K0} taps at D={D0} do not fit "
                         f"{SMEM_MAX} bytes")
    return best


def _check_args(pipe, xr, xi, tail, omega, base, tails):
    T = xr.shape[-1]
    C = omega.shape[0]
    if xr.shape != (T,) or xi.shape != (T,):
        raise ValueError("xr/xi must be 1-D planes of one length")
    if tail.shape != (pipe.K0 - 1,):
        raise ValueError(f"tail shape {tuple(tail.shape)}")
    if tuple(base.shape) != (C, pipe.n_super(T),
                             (ALIGN1D + pipe.adv_x) // ALIGN1D):
        raise ValueError(f"base shape {tuple(base.shape)}")
    if len(tails) != len(pipe.stages):
        raise ValueError(f"{len(tails)} stage tails for "
                         f"{len(pipe.stages)} stages")
    for st, tc in zip(pipe.stages, tails):
        if tuple(tc.shape) != (C, st["carry"]) or not tc.is_complex():
            raise ValueError(f"stage tail {tuple(tc.shape)} {tc.dtype}")
    return T, C


def mix_window(pipe, ext_r, ext_i, omega, base, i: int):
    """Plain stage 0's input for TPU window i: (e_lo, the mixed planes
    [2C, n] float32) of ext[e_lo, e_lo + n) (ext = concat(tail, x), as
    planes ``ext_r``, ``ext_i``), the samples window i's outputs read,
    mixed at window i's base phases (the K0 − D0 samples it shares with
    window i + 1 get that window's phases there)."""
    K0, D0 = pipe.K0, pipe.D0
    m0 = (ext_r.shape[-1] - (K0 - 1)) // D0
    m_lo, m_hi = i * pipe.adv0, min((i + 1) * pipe.adv0, m0)
    e_lo, e_hi = m_lo * D0, (m_hi - 1) * D0 + K0
    tw = (torch.arange(e_lo, e_hi, device=ext_r.device)
          - (K0 - 1) + ALIGN1D - i * pipe.adv_x)
    ang = (base[:, i, tw // ALIGN1D]
           + omega[:, None] * (tw % ALIGN1D).float()[None, :])
    co, si = torch.cos(ang), torch.sin(ang)
    sr, sx = ext_r[e_lo:e_hi], ext_i[e_lo:e_hi]
    return e_lo, torch.cat([sr * co - sx * si, sr * si + sx * co])


def mono_mix_ref(pipe, xr, xi, tail, omega, base, h0):
    """Plain stage 0: the mixed, decimated planes [2C, m0] float32 (re
    rows, then im rows), window by window."""
    ext_r = torch.cat([tail.real.float(), xr])
    ext_i = torch.cat([tail.imag.float(), xi])
    n_win = -(-pipe.lengths(xr.shape[-1])[0] // pipe.adv0)
    return torch.cat([
        poly_rows(mix_window(pipe, ext_r, ext_i, omega, base, i)[1],
                  h0[None, :], 1, pipe.D0) for i in range(n_win)], dim=1)


def mono_stages_ref(pipe, y, tails, kernels, out_dtype, tail_dtype):
    """Plain chained stages on the planes ``y`` [2C, m0]: (buf [2C, m_if]
    ``out_dtype``, [each stage's new tail, complex64 [C, carry] rounded to
    ``tail_dtype``], [each stage's output but the last, [2C, m]])."""
    C = y.shape[0] // 2
    new_tails, outs = [], []
    for st, tc, ker in zip(pipe.stages, tails, kernels):
        tp = round_to(torch.cat([tc.real, tc.imag]).float(), tail_dtype)
        ext = torch.cat([tp, y], dim=1)
        nt = round_to(ext[:, -st["carry"]:], tail_dtype)
        new_tails.append(torch.complex(nt[:C], nt[C:]))
        y = poly_rows(ext, ker, st["I"], st["D"])
        outs.append(y)
    return y.to(out_dtype), new_tails, outs[:-1]


def mono_frontend_ref(pipe, xr, xi, tail, omega, base, tails, out_dtype,
                      tap_dtype, tail_dtype):
    """Plain PyTorch K1: returns (buf [2C, m_if] ``out_dtype``, [each
    chained stage's new carried tail, complex64 [C, carry] with values
    rounded to ``tail_dtype``]); the stage tails ``tails`` (complex [C,
    carry]) are read rounded to ``tail_dtype`` too, the taps to
    ``tap_dtype``."""
    _check_args(pipe, xr, xi, tail, omega, base, tails)
    h0, kernels = pipe.taps(xr.device, tap_dtype)
    y = mono_mix_ref(pipe, xr, xi, tail, omega, base, h0)
    buf, new_tails, _ = mono_stages_ref(pipe, y, tails, kernels, out_dtype,
                                        tail_dtype)
    return buf, new_tails


def mono_mix_kernel(pipe, xr, xi, tail, omega, base, h0):
    """Stage 0 on the card (csrc/mono_frontend.cu:sdr_mono_mix, one
    launch of ``mix_plan``'s grid): y0 complex64 [C, m0]."""
    dev = xr.device
    f32 = torch.float32
    T, C = xr.shape[0], omega.shape[0]
    m0 = pipe.lengths(T)[0]
    p = mix_plan(m0, pipe.adv0, C, pipe.K0, pipe.D0)
    y = torch.empty((C, m0), dtype=torch.complex64, device=dev)
    _build.launch(
        "sdr_mono_mix", dev, _build.check(xr, "xr", f32, device=dev),
        _build.check(xi, "xi", f32, (T,), dev), T,
        _build.check(tail, "tail", torch.complex64, device=dev),
        _build.check(h0, "h0", f32, (pipe.K0,), dev), pipe.K0, pipe.D0,
        _build.check(omega, "omega", f32, (C,), dev),
        _build.check(base, "base", f32, device=dev), base.shape[1],
        base.shape[2], pipe.adv0, pipe.adv_x, C, m0, y.data_ptr(), p["P"],
        p["Cc"], p["warps"])
    return y


def mono_stages_kernel(pipe, y, tails, kernels, out_dtype, tail_dtype):
    """The chained stages on the card (csrc/mono_frontend.cu:
    sdr_mono_stage, one launch each on ``fir_plan``'s grid) on y0
    complex64 [C, m0]: (buf [2C, m_if] ``out_dtype``, [new tails], [each
    stage's output but the last, complex64 [C, m]])."""
    dev = y.device
    c64 = torch.complex64
    C, m_in = y.shape
    if out_dtype not in _STORAGE or tail_dtype not in _STORAGE:
        raise ValueError(f"dtypes {out_dtype}, {tail_dtype}")
    m = pipe.lengths(m_in * pipe.D0)
    new_tails, outs = [], []
    for s, (st, tc, ker) in enumerate(zip(pipe.stages, tails, kernels)):
        last = s == len(pipe.stages) - 1
        I, D, kw, hist = st["I"], st["D"], ker.shape[1], st["carry"]
        n_out = m[s + 1]
        p = fir_plan(I, D, kw, n_out, C, 2)
        out = torch.empty((2 * C, n_out) if last else (C, n_out),
                          dtype=out_dtype if last else c64, device=dev)
        nt = torch.empty((C, hist), dtype=c64, device=dev)
        mode = 0 if not last else 2 if out_dtype == torch.bfloat16 else 1
        _build.launch(
            "sdr_mono_stage", dev,
            _build.check(tc, "stage tail", c64, (C, hist), dev), hist,
            int(tail_dtype == torch.bfloat16),
            _build.check(y, "stage input", c64, (C, m_in), dev), m_in,
            _build.check(ker, "stage kernel", torch.float32, device=dev), I,
            D, kw, out.data_ptr(), mode, n_out, C, nt.data_ptr(), p["P"],
            p["G"], p["C"], p["warps"])
        new_tails.append(nt)
        outs.append(out)
        y, m_in = out, n_out
    return y, new_tails, outs[:-1]


def frontend_launches(pipe) -> int:
    """CUDA launches of one ``mono_frontend_kernel`` call: stage 0 and one
    a chained stage."""
    return 1 + len(pipe.stages)


@_build.counted_launches
def mono_frontend_kernel(pipe, xr, xi, tail, omega, base, tails, out_dtype,
                         tap_dtype, tail_dtype):
    """K1 on the card (csrc/mono_frontend.cu: stage 0, then one launch a
    chained stage, each launch counted in ``launches``); same contract as
    ``mono_frontend_ref``."""
    _check_args(pipe, xr, xi, tail, omega, base, tails)
    if pipe.K0 > 1024:
        raise ValueError("front-end geometry not supported by the kernel")
    h0, kernels = pipe.taps(xr.device, tap_dtype)
    y = mono_mix_kernel(pipe, xr, xi, tail, omega, base, h0)
    buf, new_tails, _ = mono_stages_kernel(pipe, y, tails, kernels,
                                           out_dtype, tail_dtype)
    return buf, new_tails


def mono_frontend(pipe, xr, xi, tail, omega, base, tails, out_dtype,
                  tap_dtype, tail_dtype):
    """K1 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = mono_frontend_kernel if xr.is_cuda else mono_frontend_ref
    return fn(pipe, xr, xi, tail, omega, base, tails, out_dtype, tap_dtype,
              tail_dtype)
