"""Shared-wideband mix-down folded into the first decimating FIR
(counterpart of sdrplusplusbrown_tpu/ops/fused_frontend.py).

    y_c[m] = Σ_k h[k]·x[mD+k−(K−1)]·e^{jθ_c(mD+k−(K−1))}

The per-channel NCO lives entirely in the mix phase θ_c, so the
decimating taps are channel-independent and the wideband is read once
for all C channels.  The stage runs inside the front-end kernel
(ops/mono_frontend.py); this module holds its design, its state layout
and the host-float64 runtime params.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..runtime.block import Block
from .xlator import SPAN, _TWO_PI


def fused_params(offset_hz, samplerate: float, decim: int) -> dict:
    """Host-float64 runtime params, every span product reduced mod 2π
    before the float32 cast (same keys and values as the JAX package)."""
    omega = -np.asarray(offset_hz, np.float64) * (_TWO_PI / samplerate)
    om_d = omega * decim

    def f32(v):
        return torch.tensor(v, dtype=torch.float32)
    return {
        "omega": f32(omega),
        "omega_span": f32(np.mod(omega * SPAN, _TWO_PI)),
        "omega_dec": f32(np.mod(om_d + np.pi, _TWO_PI) - np.pi),
        "omega_dec_span": f32(np.mod(om_d * SPAN, _TWO_PI)),
        "omega_dec_sup": f32(np.mod(om_d * 2048, _TWO_PI)),
        "omega_dec_bs": f32(np.mod(om_d * 256, _TWO_PI)),
        # full-rate 1024-sample span for the front end's per-block mix
        # phases, wrapped to (−π, π] in float64
        "omega_mb": f32(np.mod(omega * 1024 + np.pi, _TWO_PI) - np.pi),
    }


class SharedXlateDecimFIR(Block):
    """x[T] shared complex → y[C, T/decim], per-channel ω.  The overlap
    tail is the RAW wideband tail, shared by every channel; the NCO phase
    is the only per-channel state."""

    def __init__(self, taps: np.ndarray, samplerate: float, decim: int):
        self.taps = np.asarray(taps, np.float64)
        self.K = len(self.taps)
        self.samplerate = float(samplerate)
        self.decim = int(decim)
        self.ratio = Fraction(1, self.decim)
        self.in_multiple = self.decim

    def init_state(self, batch_shape=()):
        (C,) = batch_shape
        return {"tail": torch.zeros((self.K - 1,), dtype=torch.complex64),
                "phase": torch.zeros((C,), dtype=torch.float32)}
