"""Costas loops — carrier recovery for PSK (counterpart of
sdrplusplusbrown_tpu/ops/costas.py; reference dsp/loop/costas.h).

A PLL whose phase error comes from the derotated constellation, per
sample:
    out   = x · exp(−j·phase)
    err   = clamp(detector(out), −1, 1): order 2 re·im; order 4
            step(re)·im − step(im)·re; order 8 the (√2 − 1)-weighted form
    freq  = clamp(freq + β·err, minFreq, maxFreq)
    phase = normalizePhase(phase + freq + α·err)

The rotor depends on the carried phase, so the loop is sequential: the
JAX package runs a ``lax.scan``; the port runs kernel K13's Costas form
(csrc/loops.cu: one warp a row walking the chain, its samples loaded in
batches of 32 two batches ahead and its outputs stored a batch at a time;
the rotor cosf/sinf of the phase from one inline range reduction,
``rotor_kernel``) on a CUDA tensor and
``costas_rows_ref``, the same loop vectorised over rows, on a CPU
tensor.

A custom ``error_fn`` is a Python function of the derotated sample: the
plain loop runs it on a CPU tensor.  One has a kernel form: the
nearest-of-four-phases detector that ``nearest_phase_detector`` builds
(Meteor's "broken modulation", models/meteor.py), which carries its form
and phases as attributes; K13b runs it on the card.  Any other custom
``error_fn`` raises on a CUDA tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import _build
from ..runtime.block import Block
from .pll import (check_loop_rows, critically_damped, loop_coefs,
                  loop_rows, loop_update)

K8 = float(np.float32(np.sqrt(2.0) - 1.0))


def _step(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0.0, 1.0, -1.0)


def costas_error(order: int, re: torch.Tensor,
                 im: torch.Tensor) -> torch.Tensor:
    """The order-``order`` phase detector on the derotated (re, im),
    clamped to [−1, 1], each operation rounded."""
    if order == 2:
        err = re * im
    elif order == 4:
        err = _step(re) * im - _step(im) * re
    elif order == 8:
        hi = _step(re) * im - (_step(im) * re) * K8
        lo = (_step(re) * im) * K8 - _step(im) * re
        err = torch.where(re.abs() >= im.abs(), hi, lo)
    else:
        raise ValueError(f"invalid costas order {order}")
    return torch.clamp(err, -1.0, 1.0)


#: float32(π) and float32(2π), as the JAX detector rounds them
PI_F = float(np.float32(np.pi))
TWO_PI_F = float(np.float32(2.0 * np.pi))


def nearest_phase_detector(phases):
    """The detector err = d·|v|, d the wrapped difference
    mod(angle(v) − p + π, 2π) − π (floored modulo) to the first of the
    four ``phases`` p with the smallest |d| (reference meteor_costas.h:
    33-51).  It carries ``costas_form`` = "nearest4" and its float32
    ``phases``, by which K13's wrapper runs it as K13b on the card."""
    if len(phases) != 4:
        raise ValueError("the nearest-phase detector takes four phases")
    ps = tuple(float(np.float32(p)) for p in phases)

    def detector(v: torch.Tensor) -> torch.Tensor:
        re, im = v.real, v.imag
        ang = torch.atan2(im, re)
        p = torch.tensor(ps, dtype=torch.float32, device=v.device)
        two_pi = torch.tensor(TWO_PI_F, dtype=torch.float32, device=v.device)
        d = torch.remainder((ang[..., None] - p) + PI_F, two_pi) - PI_F
        # argmin takes the first of equal |d|: the reference's strict <
        best = d.gather(-1, d.abs().argmin(-1, keepdim=True))[..., 0]
        return best * torch.hypot(re, im)
    detector.costas_form = "nearest4"
    detector.phases = ps
    return detector


def nearest_form(costas) -> bool:
    """Whether ``costas`` carries the nearest-phase detector (K13b)."""
    return getattr(costas.error_fn, "costas_form", None) == "nearest4"


def rotor_ref(x: torch.Tensor) -> tuple:
    """Plain PyTorch form of K13c's rotor and rotation: 1 turned by x with
    ``costas_rows_ref``'s products and sums, (1·cos x − 0·sin x,
    1·sin x + 0·cos x).  That is (cos x, sin x) but for the sine of −0,
    which comes out +0."""
    c, s = torch.cos(x), torch.sin(x)
    return c * 1.0 - s * 0.0, s * 1.0 + c * 0.0


@_build.counted
def rotor_kernel(x: torch.Tensor) -> tuple:
    """K13c's rotor and rotation (csrc/loops.cu:turn, as the chain calls
    it) turning 1 by each value of a float32 CUDA tensor: cosf and sinf as
    the card's library gives them, computed from one range reduction where
    |x| <= π (the library's functions elsewhere), their quadrant's selects
    and signs applied to the sample; the card tests hold it to
    ``rotor_ref`` bit for bit."""
    dev = x.device
    y = torch.empty(x.shape, dtype=torch.complex64, device=dev)
    _build.launch("sdr_costas_rotor", dev,
                  _build.check(x, "rotor input", torch.float32, device=dev),
                  x.numel(), y.data_ptr())
    return y.real, y.imag


def costas_rows_ref(costas, x, phase, freq):
    """Plain PyTorch K13 (Costas form): x complex64 [R, T] → (out [R, T]
    complex64, phase' [R], freq' [R])."""
    check_loop_rows(x, phase, freq, "Costas")
    coefs = loop_coefs(costas)
    xr, xi = x.real, x.imag
    out_r, out_i = torch.empty_like(xr), torch.empty_like(xi)
    ph, fr = phase.clone(), freq.clone()
    for t in range(x.shape[1]):
        c, s = torch.cos(-ph), torch.sin(-ph)
        o_r = xr[:, t] * c - xi[:, t] * s
        o_i = xr[:, t] * s + xi[:, t] * c
        out_r[:, t], out_i[:, t] = o_r, o_i
        if costas.error_fn is None:
            err = costas_error(costas.order, o_r, o_i)
        else:
            err = torch.clamp(costas.error_fn(torch.complex(o_r, o_i)),
                              -1.0, 1.0)
        ph, fr = loop_update(ph, fr, err, coefs)
    return torch.complex(out_r, out_i), ph, fr


@_build.counted
def costas_rows_kernel(costas, x, phase, freq, clk=None):
    """K13's Costas form on the card (csrc/loops.cu); same contract as
    ``costas_rows_ref``.  ``clk``: see ``_build.chain_clock``."""
    if costas.error_fn is not None:
        raise NotImplementedError("a Costas loop with a custom error_fn "
                                  "has no kernel form")
    dev = x.device
    check_loop_rows(x, phase, freq, "Costas")
    R, T = x.shape
    y = torch.empty_like(x)
    ph_out, fr_out = torch.empty_like(phase), torch.empty_like(freq)
    _build.launch(
        "sdr_costas_rows", dev,
        _build.check(x, "Costas input", torch.complex64, device=dev), R, T,
        costas.order,
        _build.check(phase, "Costas phase", torch.float32, (R,), dev),
        _build.check(freq, "Costas freq", torch.float32, (R,), dev),
        *loop_coefs(costas), K8, y.data_ptr(), ph_out.data_ptr(),
        fr_out.data_ptr(), _build.chain_clock(clk, R, dev))
    return y, ph_out, fr_out


def costas_nearest_rows_ref(costas, x, phase, freq):
    """Plain PyTorch K13b: ``costas_rows_ref`` with the nearest-phase
    detector."""
    if not nearest_form(costas):
        raise ValueError("K13b takes a nearest-phase detector")
    return costas_rows_ref(costas, x, phase, freq)


@_build.counted
def costas_nearest_rows_kernel(costas, x, phase, freq, clk=None):
    """K13b, the Costas form with the nearest-of-four-phases detector, on
    the card (csrc/loops.cu); same contract as ``costas_rows_ref``."""
    if not nearest_form(costas):
        raise ValueError("K13b takes a nearest-phase detector")
    dev = x.device
    check_loop_rows(x, phase, freq, "Costas")
    R, T = x.shape
    y = torch.empty_like(x)
    ph_out, fr_out = torch.empty_like(phase), torch.empty_like(freq)
    _build.launch(
        "sdr_costas_nearest_rows", dev,
        _build.check(x, "Costas input", torch.complex64, device=dev), R, T,
        _build.check(phase, "Costas phase", torch.float32, (R,), dev),
        _build.check(freq, "Costas freq", torch.float32, (R,), dev),
        *loop_coefs(costas), *costas.error_fn.phases, y.data_ptr(),
        ph_out.data_ptr(), fr_out.data_ptr(), _build.chain_clock(clk, R, dev))
    return y, ph_out, fr_out


def costas_rows(costas, x, phase, freq):
    """K13 (Costas form) dispatch: the kernel for CUDA tensors (K13b for
    the nearest-phase detector), the plain version for CPU tensors."""
    if nearest_form(costas):
        fn = costas_nearest_rows_kernel if x.is_cuda \
            else costas_nearest_rows_ref
    else:
        fn = costas_rows_kernel if x.is_cuda else costas_rows_ref
    return fn(costas, x, phase, freq)


class Costas(Block):
    def __init__(self, order: int, bandwidth: float,
                 init_phase: float = 0.0, init_freq: float = 0.0,
                 min_freq: float = -np.pi, max_freq: float = np.pi,
                 error_fn=None):
        """``error_fn(v) -> err`` replaces the order's phase detector (v
        the derotated complex sample, [rows])."""
        if order not in (2, 4, 8):
            raise ValueError(f"invalid costas order {order}")
        self.order = order
        self.error_fn = error_fn
        self.alpha, self.beta = critically_damped(bandwidth)
        self.init_phase = float(init_phase)
        self.init_freq = float(init_freq)
        self.min_freq = float(min_freq)
        self.max_freq = float(max_freq)

    def init_state(self, batch_shape=()):
        return {"phase": torch.full(batch_shape, self.init_phase,
                                    dtype=torch.float32),
                "freq": torch.full(batch_shape, self.init_freq,
                                   dtype=torch.float32)}

    def apply(self, params, state, x):
        """x: complex [..., T] → (derotated [..., T] complex64, state')."""
        xr, ph, fr, lead = loop_rows(x, state)
        y, ph, fr = costas_rows(self, xr, ph, fr)
        return y.reshape(x.shape), {"phase": ph.reshape(lead),
                                    "freq": fr.reshape(lead)}
