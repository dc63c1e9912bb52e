"""Demodulator blocks (counterpart of sdrplusplusbrown_tpu/ops/demod.py):

  * ``Quadrature`` — out[n] = angle(x[n]·conj(x[n−1])) / deviation with
    the previous sample as one-sample state (reference
    demod/quadrature.h:39-46);
  * ``FMDemod`` — NFM: quadrature then the audio low-pass FIR, or the
    300 Hz high-pass, or both as a band-pass, or no filter (reference
    demod/fm.h:25-160);
  * ``Squelch`` — block-mean power gate (reference
    noise_reduction/squelch.h:55-69);
  * ``AMDemod`` — envelope, DC blocker, audio AGC, low-pass FIR; or with
    ``carrier_agc`` the AGC on the complex IF first and none on the audio
    (reference demod/am.h:101-133);
  * ``SSBDemod`` — USB/LSB/DSB product detector: translate by ±bw/2 (0),
    real part, AGC (reference demod/ssb.h:82-123);
  * ``CWDemod`` — translate by the sidetone, real part, AGC (reference
    demod/cw.h:17-95).

The AGCs run kernel K12 (ops/agc.py; the carrier AGC its complex form)
and the FIRs kernel K8 on a CUDA tensor.

The shared-VFO and scanner paths run the discriminator inside kernels K2
(ops/wfm_kernel.py) and K7 (ops/demod_kernel.py); one radio's step
(``Radio.apply``) runs these blocks, its FIRs on kernel K8.

Two discriminators stay, because the JAX package computes two: its Pallas
WFM kernel multiplies float32 planes, each product rounded on its own
(``quad_planes``, K2's plain version), while its ``Quadrature`` block is
XLA's complex multiply, which XLA:CPU compiles to fused multiply-adds with
signed flush-to-zero (``quad_xla``).  They differ only where the products
are subnormal or cancel, that is on the cold-start IF, where the sign of a
flushed zero picks +π or −π.  Either one in place of the other fails its
reference there: ``quad_xla`` in K2's plain version drops the first block
of ``apply_shared`` to 19 dB against the JAX kernel, and ``quad_planes``
in ``Quadrature`` drops the first block of ``Radio.apply`` to 4–14 dB
against the JAX ``Radio.apply``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.block import Block
from . import taps as taps_mod
from .agc import AGC
from .fir import RealFIR
from .recurrence import DCBlocker
from .xlator import FrequencyXlator


_TINY = float(np.finfo(np.float32).tiny)


def quad_planes(er, ei, erp, eip, inv_deviation: float) -> torch.Tensor:
    """Discriminator on re/im planes given the one-sample-lagged planes,
    in the JAX Pallas WFM kernel's arithmetic (K2's plain version); a zero
    product (e.g. a closed squelch gate) gives exact silence.  Subnormal
    products count as zero, as on the TPU and XLA:CPU (which flush them):
    the cold-start IF ramps through subnormals, whose angle is noise."""
    re = er * erp + ei * eip
    im = ei * erp - er * eip
    re = torch.where(re.abs() < _TINY, torch.zeros_like(re), re)
    im = torch.where(im.abs() < _TINY, torch.zeros_like(im), im)
    y = torch.atan2(im, re)
    return torch.where((re == 0) & (im == 0), torch.zeros_like(y), y) \
        * inv_deviation


def _ftz(v: torch.Tensor) -> torch.Tensor:
    """Flush subnormals to a zero of the same sign, as XLA:CPU's
    flush-to-zero does to each arithmetic result."""
    return torch.where(v.abs() < _TINY, v * 0.0, v)


def _fma(a, b, c) -> torch.Tensor:
    """a·b + c rounded once to float32 (the product is exact in
    float64)."""
    return (a.double() * b.double() + c.double()).float()


def quad_xla(er, ei, erp, eip, inv_deviation: float) -> torch.Tensor:
    """The JAX package's XLA discriminator, angle(x[n]·conj(x[n−1])), in
    the arithmetic XLA:CPU compiles its complex multiply to: one product
    of each part fused into a multiply-add with the other, rounded and
    flushed to a signed zero (flush-to-zero),
        re = fma(er, erp, ftz(ei·eip)),  im = fma(ei, erp, −ftz(er·eip)).
    On the cold-start IF the products are subnormal or cancel to a
    subnormal, and the sign of the flushed zero picks +π or −π.  The
    float64 multiply-add is a dozen elementwise launches more than
    ``quad_planes`` on the card (chip_smoke.py prints both costs)."""
    re = _ftz(_fma(er, erp, _ftz(ei * eip)))
    im = _ftz(_fma(ei, erp, -_ftz(er * eip)))
    y = torch.atan2(im, re)
    return torch.where((re == 0) & (im == 0), torch.zeros_like(y), y) \
        * inv_deviation


class Quadrature(Block):
    def __init__(self, deviation_hz: float, samplerate: float):
        self.inv_deviation = float(
            1.0 / (2.0 * np.pi * deviation_hz / samplerate))
        self.samplerate = samplerate

    def init_state(self, batch_shape=()):
        # reference phase starts at 0 ⇒ carried phasor 1+0j
        return torch.ones(batch_shape + (1,), dtype=torch.complex64)

    def apply(self, params, state, x):
        ext = torch.cat([state.to(x.device), x], dim=-1)
        y = quad_xla(ext.real[..., 1:], ext.imag[..., 1:],
                     ext.real[..., :-1], ext.imag[..., :-1],
                     self.inv_deviation)
        return y, x[..., -1:]

    def apply_planes(self, state, xr, xi):
        state = state.to(xr.device)
        er = torch.cat([state.real, xr], dim=-1)
        ei = torch.cat([state.imag, xi], dim=-1)
        y = quad_xla(er[..., 1:], ei[..., 1:], er[..., :-1], ei[..., :-1],
                     self.inv_deviation)
        return y, torch.complex(xr[..., -1:], xi[..., -1:])


class Squelch(Block):
    """Zero the block where 10·log10(mean |x|) < level, per row of a
    [..., T] block; the gate stays on the device (no host sync)."""

    def __init__(self, level: float = -100.0):
        self.default_level = float(level)

    @staticmethod
    def gate(sum_abs: torch.Tensor, n: int, level) -> torch.Tensor:
        """1.0 where the block mean of |x| (from its sum over ``n``
        samples) reaches ``level`` dB, else 0.0, in float32."""
        mean_amp = sum_abs / float(n)      # float32, no host copy
        power_db = 10.0 * torch.log10(torch.clamp(mean_amp, min=1e-20))
        return (power_db >= level).float()

    def apply(self, params, state, x):
        level = params["level"] if params else self.default_level
        g = self.gate(x.abs().sum(-1), x.shape[-1], level)
        return x * g[..., None], state


class FMDemod(Block):
    """NFM demodulator: quadrature (deviation bw/2) then the audio FIR:
    low-pass (cutoff bw/2, transition bw/2·0.1), high-pass (300 Hz,
    transition 100 Hz), both as a band-pass (300 Hz to bw/2, transition
    100 Hz), or none."""

    def __init__(self, samplerate: float, bandwidth: float,
                 low_pass: bool = True, high_pass: bool = False):
        self.samplerate = float(samplerate)
        self.quad = Quadrature(bandwidth / 2.0, samplerate)
        self.filtering = low_pass or high_pass
        if low_pass and high_pass:
            t = taps_mod.band_pass_real(300.0, bandwidth / 2.0, 100.0,
                                        samplerate)
        elif high_pass:
            t = taps_mod.high_pass(300.0, 100.0, samplerate)
        elif low_pass:
            t = taps_mod.low_pass(bandwidth / 2.0, (bandwidth / 2.0) * 0.1,
                                  samplerate)
        else:
            t = np.ones(1)
        self.fir = RealFIR(t)

    def init_state(self, batch_shape=()):
        return {"quad": self.quad.init_state(batch_shape),
                "fir": self.fir.init_state(batch_shape)}

    def _filter(self, state, y):
        if not self.filtering:
            return y, state["fir"]
        return self.fir.apply(None, state["fir"], y)

    def apply(self, params, state, x):
        """Complex IF [..., T] → (audio [..., T] float32, new state)."""
        y, qs = self.quad.apply(None, state["quad"], x)
        y, fs = self._filter(state, y)
        return y, {"quad": qs, "fir": fs}

    def apply_planes(self, params, state, planes):
        """The same demod on (re, im) float32 planes."""
        y, qs = self.quad.apply_planes(state["quad"], *planes)
        y, fs = self._filter(state, y)
        return y, {"quad": qs, "fir": fs}


def xlator_params(demod, device, attr: str = "xlator") -> dict:
    """The fixed params of a demod's translator ``attr`` on ``device``,
    made once (so a step on the card copies nothing from the host)."""
    cache = demod.__dict__.setdefault("_xl_params", {})
    key = (attr, str(device))
    if key not in cache:
        cache[key] = {k: v.to(device) for k, v in
                      getattr(demod, attr).init_params().items()}
    return cache[key]


class AMDemod(Block):
    """AM: envelope → DC block → audio AGC → low-pass FIR; with
    ``carrier_agc`` the AGC runs on the complex IF before the envelope
    (K12's complex form) and the audio AGC is skipped.  Attack 50/IF,
    decay 5/IF, DC rate 100/IF (reference demodulators/am.h:34,76,97-98)."""

    def __init__(self, samplerate: float, bandwidth: float = 10000.0,
                 agc_attack: float = 50.0, agc_decay: float = 5.0,
                 carrier_agc: bool = False):
        self.carrier_agc = bool(carrier_agc)
        atk = agc_attack / samplerate
        dec = agc_decay / samplerate
        self.c_agc = AGC(set_point=1.0, attack=atk, decay=dec,
                         max_gain=10e6)
        self.a_agc = AGC(set_point=1.0, attack=atk, decay=dec,
                         max_gain=10e6)
        self.dc = DCBlocker(100.0 / samplerate)
        self.lpf = RealFIR(taps_mod.low_pass(
            bandwidth / 2.0, (bandwidth / 2.0) * 0.1, samplerate))

    def init_state(self, batch_shape=()):
        return {"cagc": self.c_agc.init_state(batch_shape),
                "aagc": self.a_agc.init_state(batch_shape),
                "dc": self.dc.init_state(batch_shape, torch.float32),
                "lpf": self.lpf.init_state(batch_shape)}

    def apply(self, params, state, x):
        """Complex IF [..., T] → (audio [..., T] float32, new state)."""
        st = dict(state)
        if self.carrier_agc:
            x, st["cagc"] = self.c_agc.apply(None, state["cagc"], x)
        env, st["dc"] = self.dc.apply(None, state["dc"], x.abs().float())
        if not self.carrier_agc:
            env, st["aagc"] = self.a_agc.apply(None, state["aagc"], env)
        y, st["lpf"] = self.lpf.apply(None, state["lpf"], env)
        return y, st


class SSBDemod(Block):
    """Product detector: translate by +bw/2 (USB), −bw/2 (LSB) or 0 (DSB),
    take the real part, AGC at 50/IF attack, 5/IF decay (reference
    demodulators/{usb,lsb,dsb}.h)."""

    USB, LSB, DSB = "usb", "lsb", "dsb"

    def __init__(self, mode: str, bandwidth: float, samplerate: float,
                 agc_attack: float = 50.0, agc_decay: float = 5.0):
        self.mode = mode
        offset = {self.USB: bandwidth / 2.0, self.LSB: -bandwidth / 2.0,
                  self.DSB: 0.0}[mode]
        self.xlator = FrequencyXlator(offset, samplerate)
        self.agc = AGC(set_point=1.0, attack=agc_attack / samplerate,
                       decay=agc_decay / samplerate, max_gain=10e6)

    def init_state(self, batch_shape=()):
        return {"xl": self.xlator.init_state(batch_shape),
                "agc": self.agc.init_state(batch_shape)}

    def apply(self, params, state, x):
        """Complex IF [..., T] → (audio [..., T] float32, new state)."""
        y, xs = self.xlator.apply(
            params.get("xl") if params else xlator_params(self, x.device),
            state["xl"], x)
        y, ags = self.agc.apply(None, state["agc"], y.real.float())
        return y, {"xl": xs, "agc": ags}


class CWDemod(Block):
    """CW: translate by the sidetone (800 Hz), real part, AGC at 100/IF
    attack, 5/IF decay (reference demodulators/cw.h:37,82,109-110)."""

    def __init__(self, tone_hz: float, samplerate: float,
                 agc_attack: float = 100.0, agc_decay: float = 5.0):
        self.xlator = FrequencyXlator(tone_hz, samplerate)
        self.agc = AGC(set_point=1.0, attack=agc_attack / samplerate,
                       decay=agc_decay / samplerate, max_gain=10e6)

    def init_state(self, batch_shape=()):
        return {"xl": self.xlator.init_state(batch_shape),
                "agc": self.agc.init_state(batch_shape)}

    def apply(self, params, state, x):
        """Complex IF [..., T] → (audio [..., T] float32, new state)."""
        y, xs = self.xlator.apply(xlator_params(self, x.device),
                                  state["xl"], x)
        y, ags = self.agc.apply(None, state["agc"], y.real.float())
        return y, {"xl": xs, "agc": ags}
