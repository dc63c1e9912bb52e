"""TX modulators (counterpart of sdrplusplusbrown_tpu/ops/mod.py).

reference: core/src/dsp/mod/{quadrature,am,ssb,psk,gfsk}.h and
multirate/rrc_interpolator.h.  The FM phasor integration
(phase += deviation·x[n], out = e^{jφ}) is a prefix sum with a carried
phase scalar, in the JAX package's order: ``cumsum(x)·ω``, then the
carried phase, then one wrap a block.  The filters run on the port's
blocks: ``SSBMod``'s complex band-pass on ``FIR`` (kernel K9 on a CUDA
tensor), ``RRCInterpolator`` on ``PolyphaseResampler`` and ``GFSKMod``'s
Gaussian on ``RealFIR`` (K8); on a CPU tensor their plain versions.
"""

from __future__ import annotations

from math import gcd

import numpy as np
import torch

from ..runtime.block import Block
from . import taps as taps_mod
from .fir import FIR, RealFIR
from .resampler import PolyphaseResampler

_TWO_PI = 2.0 * np.pi


def wrap_phase(phase: torch.Tensor) -> torch.Tensor:
    """``jnp.mod(phase + π, 2π) − π`` in float32, as jnp.mod computes it
    (the C fmod, exact, then the divisor added where the remainder's sign
    differs from its)."""
    two_pi = torch.tensor(_TWO_PI, dtype=torch.float32, device=phase.device)
    r = torch.fmod(phase + np.pi, two_pi)
    r = torch.where((r != 0) & (r < 0), r + two_pi, r)
    return r - np.pi


class QuadratureMod(Block):
    """FM modulator: out[n] = exp(j·(φ + deviation·Σx)).

    reference: mod/quadrature.h:44-49 (normalizePhase per step; here the
    cumulative phase is wrapped once per block — identical phasors).  A
    float32 ``cumsum`` sums in a different order on the card than on the
    host, so the carried phase agrees with the JAX package's to a
    tolerance in radians, not bit for bit.
    """

    def __init__(self, deviation_hz: float, samplerate: float):
        self.omega_dev = float(2.0 * np.pi * deviation_hz / samplerate)
        self.samplerate = float(samplerate)

    def init_state(self, batch_shape=()):
        return torch.zeros(batch_shape, dtype=torch.float32)

    def apply(self, params, state, x):
        inc = torch.cumsum(x.float(), dim=-1) * float(
            np.float32(self.omega_dev))
        phase = wrap_phase(state.to(x.device)[..., None] + inc)
        out = torch.complex(torch.cos(phase), torch.sin(phase))
        return out, phase[..., -1]


class AMMod(Block):
    """AM: out = (carrier + depth·x) as complex (reference mod/am.h)."""

    def __init__(self, depth: float = 1.0, carrier: float = 1.0):
        self.depth = float(depth)
        self.carrier = float(carrier)

    def apply(self, params, state, x):
        env = self.carrier + self.depth * x.float()
        return env.to(torch.complex64), state


class SSBMod(Block):
    """SSB: analytic signal via complex band-pass, then shift by ±bw/2
    (the TX inverse of demod/ssb.h's sideband translate)."""

    USB, LSB = 0, 1

    def __init__(self, mode: int, bandwidth: float, samplerate: float):
        self.mode = mode
        lo = 0.0 if mode == self.USB else -bandwidth
        hi = bandwidth if mode == self.USB else 0.0
        self.fir = FIR(taps_mod.band_pass_complex(lo, hi, bandwidth * 0.1,
                                                  samplerate))

    def init_state(self, batch_shape=()):
        return self.fir.init_state(batch_shape)

    def apply(self, params, state, x):
        return self.fir.apply(None, state, x.to(torch.complex64))


class RRCInterpolator(Block):
    """Upsample symbols with root-raised-cosine shaping
    (reference multirate/rrc_interpolator.h: PolyphaseResampler with RRC
    prototype scaled by the interpolation factor)."""

    def __init__(self, symbolrate: float, samplerate: float,
                 beta: float = 0.35, tap_count: int = 31):
        s, f = round(symbolrate), round(samplerate)
        g = gcd(s, f)
        self.interp = f // g
        self.decim = s // g
        # one sample per symbol in, so the symbol period at the
        # zero-stuffed prototype rate is exactly ``interp``; the pulse
        # peak is 1, so an isolated symbol keeps unit amplitude
        proto = taps_mod.root_raised_cosine(tap_count * self.interp, beta,
                                            float(self.interp))
        proto = proto / np.max(np.abs(proto))
        self.resamp = PolyphaseResampler(self.interp, self.decim, proto)
        self.ratio = self.resamp.ratio
        self.in_multiple = self.resamp.in_multiple

    def init_state(self, batch_shape=(), dtype=torch.complex64):
        return self.resamp.init_state(batch_shape, dtype)

    def apply(self, params, state, x):
        return self.resamp.apply(None, state, x)


class PSKMod(Block):
    """BPSK/QPSK symbol mapper (reference mod/psk.h): bits → constellation
    points; shape with RRCInterpolator downstream."""

    def __init__(self, order: int = 2):
        assert order in (2, 4)
        self.order = order

    def apply(self, params, state, bits):
        bits = torch.as_tensor(bits).to(torch.int32)
        if self.order == 2:
            return (1.0 - 2.0 * bits.float()).to(torch.complex64), state
        b = bits.reshape(bits.shape[:-1] + (-1, 2)).float()
        i = 1.0 - 2.0 * b[..., 0]
        q = 1.0 - 2.0 * b[..., 1]
        return torch.complex(i, q) / float(np.float32(np.sqrt(2.0))), state


class GFSKMod(Block):
    """GFSK: gaussian-filtered NRZ → FM phasor (reference mod/gfsk.h)."""

    def __init__(self, samplerate: float, deviation_hz: float,
                 symbolrate: float, bt: float = 0.5):
        sps = samplerate / symbolrate
        n = int(round(4 * sps)) | 1
        t = (np.arange(n) - n // 2) / sps
        sigma = np.sqrt(np.log(2)) / (2 * np.pi * bt)
        g = np.exp(-t * t / (2 * sigma * sigma))
        self.gauss = RealFIR(g / g.sum())
        self.fm = QuadratureMod(deviation_hz, samplerate)

    def init_state(self, batch_shape=()):
        return {"g": self.gauss.init_state(batch_shape),
                "fm": self.fm.init_state(batch_shape)}

    def apply(self, params, state, nrz):
        y, gs = self.gauss.apply(None, state["g"], nrz)
        out, fs = self.fm.apply(None, state["fm"], y)
        return out, {"g": gs, "fm": fs}
