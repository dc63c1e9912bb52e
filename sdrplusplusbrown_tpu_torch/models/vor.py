"""VOR receiver — bearing from the phase between the 30 Hz AM (variable)
and the 30 Hz FM-on-9960 Hz-subcarrier (reference) components
(counterpart of sdrplusplusbrown_tpu/models/vor.py).

reference: decoder_modules/vor_receiver/src/vor_receiver.h:30-78 —
the chain at a hard-coded 25 kHz IQ rate is

    |x|  ─┬─ delay(groupDelay) ─────────────► RxVFO(offset 30 Hz → 1 kHz) ─┐
          └─ xlate(−9960) → FIR → quad(600) ► RxVFO(offset 30 Hz → 1 kHz) ─┤
                                                   conj-multiply → atan2 ──┘

and decoder_modules/vor_receiver/src/vor_decoder.cpp:32-49 integrates the
1 kHz phase stream over `integrationTime` windows: bearing = −mean (wrapped
to [0, 2π)), quality = max(1 − stddev/(2π/√12), 0).

On a CUDA tensor the filters run their kernels: the 520 Hz subcarrier FIR
and every FIR, decimator and polyphase stage of the two RxVFOs on K8;
the envelope, translator, discriminator, delay and the windows' moments
are elementwise torch ops on the card.  The NCO params of the translator
and the RxVFOs are made on the device once (``_params``), so a block
moves nothing between the host and the card.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from ..runtime.block import Block, to_device
from ..ops import taps as taps_mod
from ..ops.fir import FIR
from ..ops.delay import Delay
from ..ops.demod import Quadrature
from ..ops.xlator import FrequencyXlator
from .rx_vfo import RxVFO

VOR_IN_SR = 25_000.0           # reference vor_receiver.h:14
SUBCARRIER_HZ = 9_960.0        # reference vor_receiver.h:34
SUBCARRIER_DEV = 600.0         # quadrature deviation, vor_receiver.h:37
TONE_HZ = 30.0                 # the bearing tone
PHASE_SR = 1_000.0             # RxVFO output rate, vor_receiver.h:39-40
# 2π/√12: stddev of a uniform phase over one turn (vor_decoder.cpp:3)
STDDEV_NORM = 2.0 * np.pi / math.sqrt(12.0)


class VORReceiver(Block):
    """25 kHz IQ → 1 kHz AM/FM 30 Hz phase-difference stream (radians)."""

    def __init__(self):
        sr = VOR_IN_SR
        self.fm_taps = taps_mod.low_pass(520.0, 60.0, sr)
        # FrequencyXlator(offset) brings the +offset component to DC when
        # given the negated offset, as RxVFO does (vor_receiver.h:34)
        self.fmx = FrequencyXlator(-SUBCARRIER_HZ, sr)
        self.fmf = FIR(self.fm_taps)
        self.quad = Quadrature(SUBCARRIER_DEV, sr)
        # the AM channel delayed by the FIR's group delay
        # (vor_receiver.h:38: Delay(FM_TAPS_COUNT / 2))
        self.amde = Delay(len(self.fm_taps) // 2)
        self.amv = RxVFO(sr, PHASE_SR, TONE_HZ, offset_hz=TONE_HZ)
        self.fmv = RxVFO(sr, PHASE_SR, TONE_HZ, offset_hz=TONE_HZ)
        self.ratio = Fraction(int(PHASE_SR), int(VOR_IN_SR))
        self.in_multiple = math.lcm(self.amv.in_multiple,
                                    self.fmv.in_multiple)
        self._dev_params = {}

    def init_state(self, batch_shape=()):
        return {
            "fmx": self.fmx.init_state(batch_shape),
            "fmf": self.fmf.init_state(batch_shape),
            "quad": self.quad.init_state(batch_shape),
            "amde": self.amde.init_state(batch_shape, torch.complex64),
            "amv": self.amv.init_state(batch_shape),
            "fmv": self.fmv.init_state(batch_shape),
        }

    def _params(self, dev) -> dict:
        """The translator's and the RxVFOs' fixed NCO params on ``dev``,
        made at first use."""
        key = str(dev)
        if key not in self._dev_params:
            self._dev_params[key] = to_device(
                {"fmx": self.fmx.init_params(),
                 "amv": self.amv.init_params(),
                 "fmv": self.fmv.init_params()}, dev)
        return self._dev_params[key]

    def apply(self, params, state, x):
        p = self._params(x.device)
        st = dict(state)
        # AM envelope of the outer modulation (vor_receiver.h:47-48)
        env = x.abs().to(torch.complex64)
        # isolate and demodulate the FM subcarrier (vor_receiver.h:50-57)
        fm, st["fmx"] = self.fmx.apply(p["fmx"], state["fmx"], env)
        fm, st["fmf"] = self.fmf.apply(None, state["fmf"], fm)
        fmd, st["quad"] = self.quad.apply(None, state["quad"], fm)
        fmc = fmd.to(torch.complex64)
        # align the AM channel with the FM group delay (vor_receiver.h:59)
        amd, st["amde"] = self.amde.apply(None, state["amde"], env)
        # isolate the 30 Hz component of both (vor_receiver.h:61-63)
        am30, st["amv"] = self.amv.apply(p["amv"], state["amv"], amd)
        fm30, st["fmv"] = self.fmv.apply(p["fmv"], state["fmv"], fmc)
        # conj(FM)·AM → phase difference (vor_receiver.h:69-75)
        prod = am30 * fm30.conj()
        return torch.atan2(prod.imag, prod.real), st


class VORDecoder(Block):
    """Receiver + integration: emits (bearing_rad, quality) per window.

    reference: vor_decoder.cpp:6-49 (Reshaper to 1000·integrationTime
    samples, then stddev/mean → quality/bearing)."""

    def __init__(self, integration_time: float = 1.0):
        self.rx = VORReceiver()
        self.window = int(round(PHASE_SR * integration_time))
        self.in_multiple = math.lcm(
            self.rx.in_multiple,
            self.window * int(VOR_IN_SR / PHASE_SR))
        self.ratio = Fraction(1, self.in_multiple)

    def init_state(self, batch_shape=()):
        return self.rx.init_state(batch_shape)

    def apply(self, params, state, x):
        phase, state = self.rx.apply(None, state, x)
        W = self.window
        nw = phase.shape[-1] // W
        ph = phase[..., :nw * W].reshape(phase.shape[:-1] + (nw, W))
        mean = ph.mean(dim=-1)
        stddev = ph.std(dim=-1, correction=0)
        quality = torch.clamp(1.0 - stddev / STDDEV_NORM, min=0.0)
        bearing = -mean
        bearing = torch.where(bearing < 0, 2.0 * np.pi + bearing, bearing)
        return (bearing, quality), state


def synthesize_vor(azimuth_rad: float, seconds: float,
                   fs: float = VOR_IN_SR, am_depth: float = 0.3,
                   sub_depth: float = 0.3, noise: float = 0.0,
                   seed: int = 0) -> np.ndarray:
    """Baseband IQ of a VOR signal whose radial is `azimuth_rad`.

    Variable (AM) 30 Hz tone lags the FM reference by the azimuth; the
    9960 Hz subcarrier is FM-modulated ±480 Hz at 30 Hz (the reference
    tone exists only inside it)."""
    t = np.arange(int(round(seconds * fs)), dtype=np.float64) / fs
    var = np.cos(2 * np.pi * TONE_HZ * t - azimuth_rad)
    sub = np.cos(2 * np.pi * SUBCARRIER_HZ * t
                 + (480.0 / TONE_HZ) * np.sin(2 * np.pi * TONE_HZ * t))
    env = 1.0 + am_depth * var + sub_depth * sub
    x = env.astype(np.complex128)
    if noise > 0:
        rng = np.random.default_rng(seed)
        x = x + noise * (rng.standard_normal(len(t))
                         + 1j * rng.standard_normal(len(t)))
    return x.astype(np.complex64)
