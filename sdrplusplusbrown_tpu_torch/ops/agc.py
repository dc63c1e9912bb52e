"""Automatic gain control — kernel K12 and its plain version (counterpart
of sdrplusplusbrown_tpu/ops/agc.py).

The reference's attack/decay envelope follower (loop/agc.h:85-139), per
row of a [..., T] float32 or complex64 block (|x| is hypot(re, im) for a
complex block — the AM carrier AGC, RDSDemod's AGC — and the gain and
ramp scale both planes: K12's complex form):

    amp  ← amp·(1−attack) + |x|·attack   where |x| > amp, else the same
           with ``decay``; held where x is 0 (or subnormal) or ``frozen``
    gain = min(set_point / amp, max_gain)   (1 where amp was held)
    y    = x · gain · min((env0 + n) / 4800, 1)

The envelope's coefficient switches on a comparison with its own output,
so no associative scan computes it: the JAX package runs a ``lax.scan``;
the port runs K12 (csrc/agc.cu: a block of two warps a row, one walking
the envelope, one computing the gains and writing the outputs, and for
a complex block the |x| the chain walks, handed over through a ring whose
order ``ring_schedule`` models) on a CUDA tensor and ``agc_rows_ref``,
the same per-sample loop, on a CPU tensor.
Both round each operation on its own; XLA:CPU contracts the update into
a fused multiply-add (which product it fuses depends on the scan's
unrolled copy), so the two packages' ``amp`` differ by an ulp at some
steps.  A subnormal sample counts as zero (the envelope is held), as
on the TPU and XLA:CPU, which flush subnormals: the IF of a cold start
rises through them, and each sample held or not moves ``amp`` by a
factor 1 − decay.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import _build
from ..runtime.block import Block

ENVELOPE_LEN = 4800  # reference loop/agc.h:163 (_totalEnvelopeLength)
ENV_MAX = 1 << 30
_TINY = float(np.finfo(np.float32).tiny)

#: K12's rings (csrc/agc.cu): envelope batches from the chain warp to the
#: output warp; K12c's |x| batches from the output warp to the chain
#: warp, written AHEAD batches before the output warp's own batch; the
#: named barriers: slot s full 1 + s, free 1 + SLOTS + s, START (|x| of
#: batches 0 .. AHEAD-1 written)
SLOTS, MAGS, AHEAD = 2, 8, 5
START = 1 + 2 * SLOTS


def ring_schedule(T: int, cplx: bool, frozen: bool = False) -> dict:
    """The order of K12's two warps on one row of T samples, as
    csrc/agc.cu runs them: for "chain" and "output", the events in
    program order, ("arrive", id) and ("sync", id) on a named barrier of
    the two warps (64 threads), ("write" | "read", ring, slot, batch) of
    a shared-memory ring ("env": the envelopes; "mag": K12c's |x|)."""
    nb = (T + 31) // 32
    chain, out = [], []
    if cplx and not frozen:
        out += [("write", "mag", q, q) for q in range(AHEAD)]
        out.append(("arrive", START))
    for b in range(nb):
        s = b % SLOTS
        if cplx and not frozen:
            out += [("write", "mag", (b + AHEAD) % MAGS, b + AHEAD),
                    ("read", "mag", b % MAGS, b)]
        if not frozen:
            out += [("sync", 1 + s), ("read", "env", s, b),
                    ("arrive", 1 + SLOTS + s)]
    if frozen:
        return {"chain": chain, "output": out}
    if cplx:
        chain += [("sync", START)] + [("read", "mag", q, q)
                                      for q in range(3)]
    for b in range(nb):
        s = b % SLOTS
        if b >= SLOTS:
            chain.append(("sync", 1 + SLOTS + s))
        chain += [("write", "env", s, b), ("arrive", 1 + s)]
        if cplx:
            chain.append(("read", "mag", (b + 3) % MAGS, b + 3))
    chain += [("sync", 1 + SLOTS + b % SLOTS)
              for b in range(max(nb, SLOTS), nb + SLOTS)]
    return {"chain": chain, "output": out}


def fast_agc(set_point: float = 1.0, max_gain: float = 10e6,
             rate: float = 0.1):
    """Single-rate AGC of the digital demod front ends (reference
    dsp/loop/fast_agc.h)."""
    return AGC(set_point=set_point, attack=rate, decay=rate,
               max_gain=max_gain)


def _coefs(agc) -> tuple:
    """The float32 constants of the update, rounded as the JAX package
    rounds them: (attack, 1 − attack, decay, 1 − decay, set_point,
    max_gain)."""
    f = np.float32
    atk, dec = f(agc.attack), f(agc.decay)
    return tuple(float(v) for v in (atk, f(1.0) - atk, dec, f(1.0) - dec,
                                    f(agc.set_point), f(agc.max_gain)))


def _check(x, amp, env):
    if x.dtype not in (torch.float32, torch.complex64) or x.dim() != 2:
        raise ValueError(f"AGC rows: {tuple(x.shape)} {x.dtype}, expected "
                         f"float32 or complex64 [rows, T]")
    if amp.shape != (x.shape[0],) or amp.dtype != torch.float32 or \
            env.shape != (x.shape[0],) or env.dtype != torch.int32:
        raise ValueError("AGC state: amp float32 [rows], env int32 [rows]")


def agc_rows_ref(agc, x, amp, env, frozen: bool):
    """Plain PyTorch K12, both forms: (y [R, T] of x's dtype, amp' [R],
    env' [R])."""
    _check(x, amp, env)
    atk, one_atk, dec, one_dec, sp, mg = _coefs(agc)
    T = x.shape[1]
    ia = torch.hypot(x.real, x.imag) if x.is_complex() else x.abs()
    gains = torch.ones_like(ia)
    a = amp.clone()
    if not frozen:
        for t in range(T):
            v = ia[:, t]
            up = torch.where(v > a, a * one_atk + v * atk,
                             a * one_dec + v * dec)
            upd = v >= _TINY          # 0 after a flush to zero
            a = torch.where(upd, up, a)
            gains[:, t] = torch.where(upd, torch.clamp(sp / a, max=mg),
                                      torch.ones_like(a))
    n = env[:, None] + torch.arange(T, dtype=torch.int32, device=x.device)
    ramp = torch.clamp(n.float() / float(ENVELOPE_LEN), max=1.0)
    env = torch.clamp(env + T, max=ENV_MAX)
    if x.is_complex():
        return torch.complex((x.real * gains) * ramp,
                             (x.imag * gains) * ramp), a, env
    return (x * gains) * ramp, a, env


def _launch(entry, agc, x, amp, env, frozen: bool, clk):
    dev = x.device
    _check(x, amp, env)
    R, T = x.shape
    y = torch.empty_like(x)
    amp_out = torch.empty_like(amp)
    env_out = torch.empty_like(env)
    atk, one_atk, dec, one_dec, sp, mg = _coefs(agc)
    _build.launch(
        entry, dev, _build.check(x, "AGC input", x.dtype, device=dev), R, T,
        _build.check(amp, "AGC amp", torch.float32, (R,), dev),
        _build.check(env, "AGC env", torch.int32, (R,), dev),
        int(bool(frozen)), atk, one_atk, dec, one_dec, sp, mg, ENVELOPE_LEN,
        y.data_ptr(), amp_out.data_ptr(), env_out.data_ptr(),
        _build.chain_clock(clk, R, dev))
    return y, amp_out, env_out


@_build.counted
def agc_rows_kernel(agc, x, amp, env, frozen: bool, clk=None):
    """K12 on the card (csrc/agc.cu), float32 rows; same contract as
    ``agc_rows_ref``.  ``clk``: see ``_build.chain_clock``."""
    if x.dtype != torch.float32:
        raise ValueError(f"K12: {x.dtype} rows, expected float32")
    return _launch("sdr_agc_rows", agc, x, amp, env, frozen, clk)


@_build.counted
def agc_cplx_rows_kernel(agc, x, amp, env, frozen: bool, clk=None):
    """K12's complex form on the card (csrc/agc.cu), complex64 rows; same
    contract as ``agc_rows_ref``, its plain version too.  A wrapper of
    its own so that its launches count apart from K12's real form."""
    if x.dtype != torch.complex64:
        raise ValueError(f"K12c: {x.dtype} rows, expected complex64")
    return _launch("sdr_agc_cplx_rows", agc, x, amp, env, frozen, clk)


def agc_rows(agc, x, amp, env, frozen: bool):
    """K12 dispatch: the kernel (its complex form for complex rows) for
    CUDA tensors, the plain version for CPU tensors."""
    if not x.is_cuda:
        return agc_rows_ref(agc, x, amp, env, frozen)
    fn = agc_cplx_rows_kernel if x.is_complex() else agc_rows_kernel
    return fn(agc, x, amp, env, frozen)


class AGC(Block):
    def __init__(self, set_point: float = 1.0,
                 attack: float = 50.0 / 48000.0,
                 decay: float = 5.0 / 48000.0, max_gain: float = 10e6,
                 init_gain: float = 1.0):
        self.set_point = float(set_point)
        self.attack = float(attack)
        self.decay = float(decay)
        self.max_gain = float(max_gain)
        self.init_gain = float(init_gain)

    def init_state(self, batch_shape=()):
        return {"amp": torch.full(batch_shape,
                                  self.set_point / self.init_gain,
                                  dtype=torch.float32),
                "env": torch.zeros(batch_shape, dtype=torch.int32)}

    def apply(self, params, state, x):
        """x: real or complex [..., T] → (y float32 or complex64, new
        state).  ``frozen`` is read on the host (a CUDA tensor there costs
        one copy per call; pass a Python bool to avoid it)."""
        if self.attack <= 0:        # reference agc.h:96-99: pass-through
            return x, state
        frozen = bool(params["frozen"]) if params else False
        lead, T = x.shape[:-1], x.shape[-1]
        rows = math.prod(lead)
        dev = x.device
        dt = torch.complex64 if x.is_complex() else torch.float32
        y, amp, env = agc_rows(
            self, x.to(dt).reshape(rows, T).contiguous(),
            state["amp"].to(dev).reshape(rows).contiguous(),
            state["env"].to(dev).reshape(rows).contiguous(), frozen)
        return y.reshape(x.shape), {"amp": amp.reshape(lead),
                                    "env": env.reshape(lead)}
