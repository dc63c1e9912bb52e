"""Digital demodulators: PSK (BPSK/QPSK/8PSK), GFSK, 4FSK and π/4-DQPSK
(counterpart of sdrplusplusbrown_tpu/ops/demod_digital.py; reference
core/src/dsp/demod/psk.h: AGC → Costas → RRC matched filter → M&M clock
recovery → symbols, and demod/gfsk.h: quadrature discriminator → RRC →
M&M → soft symbols), used by the decoder modules (M17, KG-SSTV, RyFi,
Meteor, and later the pager, DMR and TETRA front ends).

Each block is a chain of the port's blocks, so on a CUDA tensor each
stage runs its kernel: the AGC K12's complex form (K12c), the Costas loop
K13c, the RRC matched filter K9 on complex data (real taps on a complex
block: K8, ops/fir.py) or K8 on the discriminator's real output, the
clock recovery K13m (its complex or real form).  ``FourFSKDemod``'s six
Lloyd steps and ``Pi4DQPSKDemod``'s fourth-power AFC are a few batched
operations a block, not a chain a sample: plain torch on either device.
As in the JAX package each block runs one stream (batch ()).
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.block import Block
from . import taps as taps_mod
from .agc import AGC
from .costas import Costas
from .fir import FIR, RealFIR
from .demod import Quadrature
from .clock_recovery import MMClockRecovery

PI_F = float(np.float32(np.pi))


def _rrc_taps(tap_count: int, beta: float, symbolrate: float,
              samplerate: float) -> np.ndarray:
    return taps_mod.root_raised_cosine(tap_count, beta,
                                       samplerate / symbolrate)


class PSKDemod(Block):
    """complex baseband → (symbols, valid): matched-filtered, carrier- and
    clock-recovered constellation points."""

    def __init__(self, order: int, symbolrate: float, samplerate: float,
                 rrc_tap_count: int = 31, rrc_beta: float = 0.35,
                 agc_rate: float = 0.1, costas_bandwidth: float = 0.005,
                 omega_gain: float = 1e-6, mu_gain: float = 0.01,
                 omega_rel_limit: float = 0.01):
        self.order = order
        self.agc = AGC(set_point=1.0, attack=agc_rate, decay=agc_rate,
                       max_gain=10e6)
        self.costas = Costas(order, costas_bandwidth)
        self.rrc = FIR(_rrc_taps(rrc_tap_count, rrc_beta, symbolrate,
                                 samplerate))
        self.recov = MMClockRecovery(samplerate / symbolrate, omega_gain,
                                     mu_gain, omega_rel_limit,
                                     complex_data=True)

    def init_state(self, batch_shape=()):
        assert batch_shape == ()
        return {"agc": self.agc.init_state(()),
                "costas": self.costas.init_state(()),
                "rrc": self.rrc.init_state(()),
                "recov": self.recov.init_state(())}

    def apply(self, params, state, x):
        st = dict(state)
        y, st["agc"] = self.agc.apply(None, state["agc"], x)
        y, st["costas"] = self.costas.apply(None, state["costas"], y)
        y, st["rrc"] = self.rrc.apply(None, state["rrc"], y)
        (sym, valid), st["recov"] = self.recov.apply(None, state["recov"],
                                                     y)
        return (sym, valid), st


class GFSKDemod(Block):
    """complex baseband → (soft float symbols, valid)."""

    def __init__(self, symbolrate: float, samplerate: float,
                 deviation_hz: float, rrc_tap_count: int = 31,
                 rrc_beta: float = 0.35, omega_gain: float = 1e-6,
                 mu_gain: float = 0.01, omega_rel_limit: float = 0.01):
        self.quad = Quadrature(deviation_hz, samplerate)
        self.rrc = RealFIR(_rrc_taps(rrc_tap_count, rrc_beta, symbolrate,
                                     samplerate))
        self.recov = MMClockRecovery(samplerate / symbolrate, omega_gain,
                                     mu_gain, omega_rel_limit,
                                     complex_data=False)

    def init_state(self, batch_shape=()):
        assert batch_shape == ()
        return {"quad": self.quad.init_state(()),
                "rrc": self.rrc.init_state(()),
                "recov": self.recov.init_state(())}

    def apply(self, params, state, x):
        st = dict(state)
        y, st["quad"] = self.quad.apply(None, state["quad"], x)
        y, st["rrc"] = self.rrc.apply(None, state["rrc"], y)
        (sym, valid), st["recov"] = self.recov.apply(None, state["recov"],
                                                     y)
        return (sym, valid), st


class FourFSKDemod(Block):
    """4-level FSK demodulator (DMR/dPMR/NXDN family): GFSK soft symbols
    sliced into dibits with adaptive level tracking (reference: the
    DSD-based ch_extravhf_decoder's min/max tracker, dsd.h ``lmin/lmax``).

    Per block the inner/outer cluster centres of |soft| are estimated by
    six steps of a 1-D 2-means (Lloyd's) over the valid symbols; the
    magnitude threshold is their midpoint, EMA-blended into the carried
    state.  The soft symbols are returned normalised so that the outer
    clusters land at ±1."""

    def __init__(self, symbolrate: float, samplerate: float,
                 deviation_hz: float, level_gain: float = 0.5, **kw):
        self.gfsk = GFSKDemod(symbolrate, samplerate, deviation_hz, **kw)
        self.level_gain = float(level_gain)

    def init_state(self, batch_shape=()):
        return {"gfsk": self.gfsk.init_state(batch_shape),
                "c_in": torch.full(batch_shape, 1.0 / 3.0,
                                   dtype=torch.float32),
                "c_out": torch.ones(batch_shape, dtype=torch.float32)}

    def apply(self, params, state, x):
        (soft, valid), gst = self.gfsk.apply(None, state["gfsk"], x)
        dev = soft.device
        c_in0, c_out0 = state["c_in"].to(dev), state["c_out"].to(dev)
        a = soft.abs()
        w = valid.to(torch.float32)      # stats over symbol instants only
        t = 0.5 * (c_in0 + c_out0)
        for _ in range(6):
            lo = (a < t[..., None]).to(torch.float32) * w
            hi = w - lo
            ci = (lo * a).sum(-1) / torch.clamp(lo.sum(-1), min=1.0)
            co = (hi * a).sum(-1) / torch.clamp(hi.sum(-1), min=1.0)
            t = 0.5 * (ci + co)
        # silent / degenerate / too-short blocks keep the carried levels
        good = (co > 1e-3) & (co > ci * 1.5) & (w.sum(-1) >= 64.0)
        g = self.level_gain * good.to(torch.float32)
        c_in = (1.0 - g) * c_in0 + g * ci
        c_out = (1.0 - g) * c_out0 + g * co
        thr = (0.5 * (c_in + c_out))[..., None]
        dibit = torch.where(soft > thr, 3, torch.where(
            soft > 0.0, 2, torch.where(soft > -thr, 1, 0))).to(torch.int32)
        soft_n = soft / torch.clamp(c_out[..., None], min=1e-6)
        return (soft_n, dibit, valid), {"gfsk": gst, "c_in": c_in,
                                        "c_out": c_out}


class Pi4DQPSKDemod(Block):
    """π/4-DQPSK demodulator (TETRA's modulation — the front half of the
    reference's ch_tetra_demodulator).  Carrier-free: AGC → RRC matched
    filter → M&M symbol recovery → differential phase → dibits on the
    {±45°, ±135°} grid."""

    def __init__(self, symbolrate: float, samplerate: float,
                 rrc_tap_count: int = 31, rrc_beta: float = 0.35,
                 omega_gain: float = 1e-6, mu_gain: float = 0.01):
        self.agc = AGC(set_point=1.0, attack=0.1, decay=0.1, max_gain=1e6)
        self.rrc = FIR(_rrc_taps(rrc_tap_count, rrc_beta, symbolrate,
                                 samplerate))
        self.recov = MMClockRecovery(samplerate / symbolrate, omega_gain,
                                     mu_gain, 0.01, complex_data=True)

    def init_state(self, batch_shape=()):
        assert batch_shape == ()
        return {"agc": self.agc.init_state(()),
                "rrc": self.rrc.init_state(()),
                "recov": self.recov.init_state(()),
                "prev": torch.ones((), dtype=torch.complex64),
                "bias": torch.zeros((), dtype=torch.float32)}

    def apply(self, params, state, x):
        st = dict(state)
        y, st["agc"] = self.agc.apply(None, state["agc"], x)
        y, st["rrc"] = self.rrc.apply(None, state["rrc"], y)
        (sym, valid), st["recov"] = self.recov.apply(None, state["recov"],
                                                     y)
        dev = sym.device
        prev0 = state["prev"].to(dev)
        prev = torch.cat([prev0[None], sym[:-1]])
        d = sym * prev.conj()
        # fourth-power AFC: a carrier offset adds a constant bias to every
        # differential phase; d⁴ maps all four ±45°/±135° clusters onto
        # 180° + 4·bias (estimated a block)
        z = d / torch.clamp(d.abs(), min=1e-9)
        vm = valid.to(torch.complex64)
        z2 = z * z
        z4 = (z2 * z2 * vm).sum() / torch.clamp(vm.real.sum(), min=1.0)
        # wrap (∠z⁴ − π) into (−π, π] before /4, else positive offsets
        # alias a quadrant away (bias must land in (−45°, 45°])
        raw = torch.angle(z4) - PI_F
        raw = torch.remainder(raw + PI_F, 2.0 * PI_F) - PI_F
        bias = raw / 4.0
        st["bias"] = bias       # exposed for telemetry (a block's estimate)
        d = d * torch.exp(torch.complex(torch.zeros_like(bias), -bias))
        ph = torch.angle(d)
        # dibit: which of the four ±45°/±135° decision regions
        dibit = torch.remainder(torch.floor(ph / (PI_F / 2)), 4) \
            .to(torch.int32)
        n_valid = valid.to(torch.int32).sum()
        st["prev"] = torch.where(
            n_valid > 0, sym[torch.clamp(n_valid - 1, min=0)], prev0)
        return (d, dibit, valid), st
