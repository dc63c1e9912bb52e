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

Dispatch follows the input: CPU tensors run ``mono_frontend_ref``; CUDA
tensors launch ``mono_frontend_kernel`` (csrc/mono_frontend.cu) or raise.
"""

from __future__ import annotations

from math import gcd
from typing import List

import numpy as np
import torch

from ..kernels import _build
from .precision import get_handoff_dtype, round_to
from .fir_kernel import poly_rows
from .xlator import _TWO_PI, advance_phase, fmod_floor

ALIGN1D = 1024       # mix-phase block (the TPU kernel's 1-D DMA granularity)
BS = 256             # decimated advance granularity of a window
SUP_SPAN = 2048      # omega_dec_sup span baked into the fused params
MAX_ADVX = 1 << 18
MIN_ADVX = 8192
MIX_TM = 128         # stage-0 outputs per CUDA block (csrc/mono_frontend.cu)


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
        tail_planes = []
        for tc in self.bank.stage_tails(state):
            tail_planes.append(round_to(
                torch.cat([tc.real, tc.imag], dim=0).float(), t_dt)
                .contiguous())
        base = self.base_phases(params, phase, T)
        buf, stage_ins = mono_frontend(self, xr, xi, tail, omega, base,
                                       tail_planes,
                                       h_dt if raw else torch.float32, h_dt)

        new_state = dict(state)
        K0 = self.K0
        new_tail = (torch.complex(xr[T - (K0 - 1):], xi[T - (K0 - 1):])
                    if T >= K0 - 1 else
                    torch.cat([tail, torch.complex(xr, xi)])[T:])
        new_phase = advance_phase(phase, omega, params["omega_span"], T)
        new_state["fused"] = {"tail": new_tail,
                              "phase": torch.broadcast_to(new_phase,
                                                          (C,)).clone()}
        new_tails = []
        for st, tp, yin in zip(self.stages, tail_planes, stage_ins):
            ext_end = torch.cat([tp, yin], dim=1)[:, -st["carry"]:]
            ext_end = round_to(ext_end, t_dt)
            new_tails.append(torch.complex(ext_end[:C], ext_end[C:]))
        self.bank.write_tails(new_state, new_tails)
        return buf, new_state


def _check_args(pipe, xr, xi, tail, omega, base, tail_planes):
    T = xr.shape[-1]
    C = omega.shape[0]
    if xr.shape != (T,) or xi.shape != (T,):
        raise ValueError("xr/xi must be 1-D planes of one length")
    if tail.shape != (pipe.K0 - 1,):
        raise ValueError(f"tail shape {tuple(tail.shape)}")
    if tuple(base.shape) != (C, pipe.n_super(T),
                             (ALIGN1D + pipe.adv_x) // ALIGN1D):
        raise ValueError(f"base shape {tuple(base.shape)}")
    for st, tp in zip(pipe.stages, tail_planes):
        if tuple(tp.shape) != (2 * C, st["carry"]):
            raise ValueError(f"stage tail shape {tuple(tp.shape)}")
    return T, C


def mono_frontend_ref(pipe, xr, xi, tail, omega, base, tail_planes,
                      out_dtype, tap_dtype):
    """Plain PyTorch K1: returns (buf [2C, m_if] ``out_dtype``, [input of
    each chained stage, [2C, m] float32]); the taps rounded to
    ``tap_dtype``."""
    T, C = _check_args(pipe, xr, xi, tail, omega, base, tail_planes)
    K0, D0 = pipe.K0, pipe.D0
    h0, kernels = pipe.taps(xr.device, tap_dtype)
    m0 = pipe.lengths(T)[0]
    ext_r = torch.cat([tail.real.float(), xr])
    ext_i = torch.cat([tail.imag.float(), xi])
    parts = []
    for i in range(pipe.n_super(T)):
        m_lo, m_hi = i * pipe.adv0, min((i + 1) * pipe.adv0, m0)
        if m_lo >= m_hi:
            break
        e_lo, e_hi = m_lo * D0, (m_hi - 1) * D0 + K0
        tw = (torch.arange(e_lo, e_hi, device=xr.device)
              - (K0 - 1) + ALIGN1D - i * pipe.adv_x)
        ang = (base[:, i, tw // ALIGN1D]
               + omega[:, None] * (tw % ALIGN1D).float()[None, :])
        co, si = torch.cos(ang), torch.sin(ang)
        sr, sx = ext_r[e_lo:e_hi], ext_i[e_lo:e_hi]
        mixed = torch.cat([sr * co - sx * si, sr * si + sx * co])
        parts.append(poly_rows(mixed, h0[None, :], 1, D0))
    y = torch.cat(parts, dim=1)
    ins = []
    for st, tp, ker in zip(pipe.stages, tail_planes, kernels):
        ins.append(y)
        y = poly_rows(torch.cat([tp, y], dim=1), ker, st["I"], st["D"])
    return y.to(out_dtype), ins


@_build.counted
def mono_frontend_kernel(pipe, xr, xi, tail, omega, base, tail_planes,
                         out_dtype, tap_dtype):
    """K1 on the card (csrc/mono_frontend.cu); same contract as
    ``mono_frontend_ref``."""
    dev = xr.device
    T, C = _check_args(pipe, xr, xi, tail, omega, base, tail_planes)
    if pipe.adv0 % MIX_TM or pipe.K0 > 1024:
        raise ValueError("front-end geometry not supported by the kernel")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"output dtype {out_dtype}")
    f32 = torch.float32
    h0, kernels = pipe.taps(dev, tap_dtype)
    m = pipe.lengths(T)
    tail_r = tail.real.float().contiguous()
    tail_i = tail.imag.float().contiguous()
    y = torch.empty((2 * C, m[0]), dtype=f32, device=dev)
    n_super = pipe.n_super(T)
    _build.launch(
        "sdr_mono_mix_decim", dev,
        _build.check(xr, "xr", f32, device=dev),
        _build.check(xi, "xi", f32, (T,), dev), T,
        _build.check(tail_r, "tail re", f32, device=dev),
        _build.check(tail_i, "tail im", f32, device=dev),
        _build.check(h0, "h0", f32, (pipe.K0,), dev), pipe.K0, pipe.D0,
        _build.check(omega, "omega", f32, (C,), dev),
        _build.check(base, "base", f32, device=dev), n_super,
        base.shape[-1], pipe.adv0, pipe.adv_x, C, m[0],
        y.data_ptr())
    ins = []
    for s, (st, tp, ker) in enumerate(zip(pipe.stages, tail_planes,
                                          kernels)):
        ins.append(y)
        last = s == len(pipe.stages) - 1
        out = torch.empty((2 * C, m[s + 1]),
                          dtype=out_dtype if last else f32, device=dev)
        _build.launch(
            "sdr_mono_poly_stage", dev,
            _build.check(tp, "stage tail", f32, device=dev), st["carry"],
            _build.check(y, "stage input", f32, device=dev), m[s],
            _build.check(ker, "stage kernel", f32, device=dev),
            st["I"], st["D"], ker.shape[1], out.data_ptr(),
            int(out.dtype == torch.bfloat16), m[s + 1], 2 * C)
        y = out
    return y, ins


def mono_frontend(pipe, xr, xi, tail, omega, base, tail_planes, out_dtype,
                  tap_dtype):
    """K1 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = mono_frontend_kernel if xr.is_cuda else mono_frontend_ref
    return fn(pipe, xr, xi, tail, omega, base, tail_planes, out_dtype,
              tap_dtype)
