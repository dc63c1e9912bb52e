"""Phase-locked loops and pilot recovery (counterpart of
sdrplusplusbrown_tpu/ops/pll.py; reference dsp/loop/pll.h:15-90,
loop/phase_control_loop.h).

  * ``PLL`` — the second-order loop emitting the VCO exp(j·phase), per
    sample (reference pll.h:64-70, phase_control_loop.h advance()):
        out   = exp(j·phase)
        err   = normalizePhase(∠in − phase)
        freq  = clamp(freq + β·err, minFreq, maxFreq)
        phase = normalizePhase(phase + freq + α·err)
    It is the WFM stereo section's pilot recovery with
    ``pll_mode="scan"``.  The phase carries a wrap of its own output, so
    no associative scan computes it: the JAX package runs a ``lax.scan``;
    the port runs kernel K13's PLL form (csrc/loops.cu: the atan2s in
    parallel, one thread walking the chain, the cos/sin in parallel) on a
    CUDA tensor and ``pll_rows_ref``, the same per-sample loop vectorised
    over rows, on a CPU tensor;
  * ``CarrierTrackingPLL`` — the same loop, out x·conj(vco) (reference
    loop/carrier_tracking_pll.h);
  * ``pilot_normalize`` — the unit-magnitude band-passed pilot, the VCO
    the PLL converges to (the normalize-mode WFM path).

Both the kernel and the plain version round each operation on its own
(no fused multiply-add); XLA:CPU's atan2 and cos/sin differ from torch's
by ulps, so the two packages agree to rounding, with the phase compared
modulo 2π.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import _build
from ..runtime.block import Block

PI = float(np.float32(np.pi))
TWO_PI = float(np.float32(2.0 * np.pi))


def critically_damped(bandwidth: float):
    """reference: loop/phase_control_loop.h criticallyDamped()."""
    df = np.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * df * bandwidth + bandwidth * bandwidth
    alpha = (4.0 * df * bandwidth) / denom
    beta = (4.0 * bandwidth * bandwidth) / denom
    return float(alpha), float(beta)


def normalize_phase(d: torch.Tensor) -> torch.Tensor:
    """Wrap to (−π, π] in one step (reference math/normalize_phase.h)."""
    d = torch.where(d > PI, d - TWO_PI, d)
    return torch.where(d <= -PI, d + TWO_PI, d)


def loop_coefs(loop) -> tuple:
    """(α, β, min_freq, max_freq) of a loop as float32 values, rounded as
    the JAX package rounds them."""
    f = np.float32
    return tuple(float(f(v)) for v in (loop.alpha, loop.beta, loop.min_freq,
                                       loop.max_freq))


def loop_update(phase, freq, err, coefs):
    """One step of the second-order loop on [R] tensors: (phase', freq')
    with freq' = clamp(freq + β·err) and phase' = wrap((phase + freq') +
    α·err), each operation rounded."""
    a, b, lo, hi = coefs
    freq = torch.clamp(freq + b * err, lo, hi)
    return normalize_phase((phase + freq) + a * err), freq


def check_loop_rows(x, phase, freq, what: str):
    if x.dtype != torch.complex64 or x.dim() != 2:
        raise ValueError(f"{what} rows: {tuple(x.shape)} {x.dtype}, "
                         f"expected complex64 [rows, T]")
    for t in (phase, freq):
        if t.shape != (x.shape[0],) or t.dtype != torch.float32:
            raise ValueError(f"{what} state: phase, freq float32 [rows]")


def pll_rows_ref(pll, x, phase, freq):
    """Plain PyTorch K13 (PLL form): x complex64 [R, T] → (vco [R, T],
    phase' [R], freq' [R])."""
    check_loop_rows(x, phase, freq, "PLL")
    coefs = loop_coefs(pll)
    ang = torch.atan2(x.imag, x.real)
    out = torch.empty_like(ang)
    ph, fr = phase.clone(), freq.clone()
    for t in range(x.shape[1]):
        out[:, t] = ph
        err = normalize_phase(ang[:, t] - ph)
        ph, fr = loop_update(ph, fr, err, coefs)
    return torch.complex(torch.cos(out), torch.sin(out)), ph, fr


@_build.counted
def pll_rows_kernel(pll, x, phase, freq, clk=None):
    """K13's PLL form on the card (csrc/loops.cu); same contract as
    ``pll_rows_ref``.  ``clk``: see ``_build.chain_clock``."""
    dev = x.device
    check_loop_rows(x, phase, freq, "PLL")
    R, T = x.shape
    y = torch.empty_like(x)
    ph_out, fr_out = torch.empty_like(phase), torch.empty_like(freq)
    _build.launch(
        "sdr_pll_rows", dev,
        _build.check(x, "PLL input", torch.complex64, device=dev), R, T,
        _build.check(phase, "PLL phase", torch.float32, (R,), dev),
        _build.check(freq, "PLL freq", torch.float32, (R,), dev),
        *loop_coefs(pll), y.data_ptr(), ph_out.data_ptr(), fr_out.data_ptr(),
        _build.chain_clock(clk, R, dev))
    return y, ph_out, fr_out


def pll_rows(pll, x, phase, freq):
    """K13 (PLL form) dispatch: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    fn = pll_rows_kernel if x.is_cuda else pll_rows_ref
    return fn(pll, x, phase, freq)


def loop_rows(x, state):
    """A loop's [..., T] complex block and its [...] phase/freq state as
    contiguous rows: (x [R, T], phase [R], freq [R], lead shape)."""
    lead, T = x.shape[:-1], x.shape[-1]
    rows = math.prod(lead)
    dev = x.device
    return (x.to(torch.complex64).reshape(rows, T).contiguous(),
            state["phase"].to(dev).reshape(rows).contiguous(),
            state["freq"].to(dev).reshape(rows).contiguous(), lead)


class PLL(Block):
    """Second-order PLL emitting the VCO phasor exp(j·phase)."""

    def __init__(self, bandwidth: float, init_phase: float = 0.0,
                 init_freq: float = 0.0, min_freq: float = -np.pi,
                 max_freq: float = np.pi):
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
        """x: complex [..., T] → (vco [..., T] complex64, new state)."""
        xr, ph, fr, lead = loop_rows(x, state)
        vco, ph, fr = pll_rows(self, xr, ph, fr)
        return vco.reshape(x.shape), {"phase": ph.reshape(lead),
                                      "freq": fr.reshape(lead)}


class CarrierTrackingPLL(PLL):
    """The PLL with the de-rotated input x·conj(vco) as its output —
    carrier recovery for synchronous AM and RDS (reference
    loop/carrier_tracking_pll.h)."""

    def apply(self, params, state, x):
        vco, new_state = super().apply(params, state, x)
        return x.to(torch.complex64) * vco.conj(), new_state


def pilot_normalize(p: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-magnitude band-passed pilot (the VCO the PLL converges to)."""
    return p / torch.clamp(p.abs(), min=eps)
