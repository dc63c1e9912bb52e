"""Pilot recovery (counterpart of sdrplusplusbrown_tpu/ops/pll.py).

Only what the normalize-mode WFM path needs: ``pilot_normalize`` (the
unit-magnitude band-passed pilot used as the VCO) and the ``PLL`` state
layout, which BroadcastFM carries unchanged so its state converts
one-to-one with the JAX package's.  The sequential scan PLL is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.block import Block


def critically_damped(bandwidth: float):
    """reference: loop/phase_control_loop.h criticallyDamped()."""
    df = np.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * df * bandwidth + bandwidth * bandwidth
    alpha = (4.0 * df * bandwidth) / denom
    beta = (4.0 * bandwidth * bandwidth) / denom
    return float(alpha), float(beta)


class PLL(Block):
    """Second-order PLL configuration and carried state (phase, freq)."""

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


def pilot_normalize(p: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-magnitude band-passed pilot (the VCO the PLL converges to)."""
    return p / torch.clamp(p.abs(), min=eps)
