"""Frequency translation (counterpart of sdrplusplusbrown_tpu/ops/xlator.py).

    y[n] = x[n] * exp(j*(phase0 + omega*n))

float32 phase accuracy over long blocks: the angle grid is factored as
exp(j*A*m) ⊗ exp(j*omega*k), n = m*SPAN + k, where A = (omega*SPAN) mod 2π
is computed on the host in float64 and shipped as a param beside omega, so
float32 never sees a large phase product.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.block import Block

_TWO_PI = 2.0 * np.pi
SPAN = 1024


def fmod_floor(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.mod`` semantics on float32: the exact ``fmod`` remainder,
    shifted by ``y`` where its sign differs from ``y``'s
    (``torch.remainder`` computes ``x - y*floor(x/y)``, which rounds)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def nco_params(offset_hz, samplerate: float) -> dict:
    """Host float64 NCO params; ``offset_hz`` scalar or per-channel."""
    omega = np.asarray(offset_hz, np.float64) * (_TWO_PI / samplerate)
    omega_span = np.mod(omega * SPAN, _TWO_PI)
    return {"omega": torch.tensor(omega, dtype=torch.float32),
            "omega_span": torch.tensor(omega_span, dtype=torch.float32)}


def rotor(phase0, omega, omega_span, T: int) -> torch.Tensor:
    """Unit phasor table exp(j*(phase0 + omega*arange(T))), batch-broadcast."""
    phase0, omega, omega_span = torch.broadcast_tensors(
        torch.as_tensor(phase0, dtype=torch.float32),
        torch.as_tensor(omega, dtype=torch.float32),
        torch.as_tensor(omega_span, dtype=torch.float32))
    dev = omega.device
    if T <= SPAN:
        n = torch.arange(T, dtype=torch.float32, device=dev)
        ang = phase0[..., None] + omega[..., None] * n
        return torch.polar(torch.ones_like(ang), ang)
    M = -(-T // SPAN)
    m = torch.arange(M, dtype=torch.float32, device=dev)
    k = torch.arange(SPAN, dtype=torch.float32, device=dev)
    ang_m = phase0[..., None] + fmod_floor(omega_span[..., None] * m,
                                           _TWO_PI)
    ang_k = omega[..., None] * k
    pm = torch.polar(torch.ones_like(ang_m), ang_m)
    pk = torch.polar(torch.ones_like(ang_k), ang_k)
    full = (pm[..., :, None] * pk[..., None, :]).reshape(
        omega.shape + (M * SPAN,))
    return full[..., :T]


def advance_phase(phase0, omega, omega_span, T: int) -> torch.Tensor:
    phase0 = torch.as_tensor(phase0, dtype=torch.float32)
    if T <= SPAN:
        return fmod_floor(phase0 + omega * T, _TWO_PI)
    M, rem = divmod(T, SPAN)
    acc = fmod_floor(omega_span * M, _TWO_PI)
    if rem:
        acc = acc + omega * rem
    return fmod_floor(phase0 + acc, _TWO_PI)


class FrequencyXlator(Block):
    """y = x * exp(j*(phase + omega*n)); carried scalar phase per channel.
    RxVFO translates by -offset (reference rx_vfo.h:27)."""

    def __init__(self, offset_hz: float, samplerate: float):
        self.offset_hz = float(offset_hz)
        self.samplerate = float(samplerate)

    def init_state(self, batch_shape=()):
        return torch.zeros(batch_shape, dtype=torch.float32)

    def init_params(self):
        return nco_params(self.offset_hz, self.samplerate)

    def make_params(self, offset_hz):
        return nco_params(offset_hz, self.samplerate)

    def apply(self, params, state, x):
        if params is None:
            params = self.init_params()
        dev = x.device
        omega = params["omega"].to(dev)
        omega_span = params["omega_span"].to(dev)
        state = state.to(dev)
        T = x.shape[-1]
        y = x * rotor(state, omega, omega_span, T)
        new_phase = advance_phase(state, omega, omega_span, T)
        return y, torch.broadcast_to(new_phase, state.shape).clone()
