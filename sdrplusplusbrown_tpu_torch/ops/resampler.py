"""Polyphase rational resampling and power-of-two decimation (counterpart
of sdrplusplusbrown_tpu/ops/resampler.py).

  * ``build_polyphase_bank`` — prototype split into ``interp`` phases,
    reversed phase order (reference multirate/polyphase_bank.h:14-48).
  * ``PolyphaseResampler`` — with the block length a multiple of ``decim``
    the (phase, offset) carry is identically zero, and every output is
        y[m*interp + r] = sum_l kernel[r, l] * ext[m*decim + l]
    over the widened kernel [interp, tpp + decim - 1]
    (reference multirate/polyphase_resampler.h:69-99): kernel K8
    (ops/fir_kernel.py) on a CUDA tensor, its plain version on a CPU one.
  * ``PowerDecimator`` / ``RationalResampler`` — the reference's multirate
    orchestration (multirate/rational_resampler.h:128-173), with the
    decimation stages designed at build time (decimating ``FIR``s, K8).

Tap design is numpy float64 and identical to the JAX package's.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import List

import numpy as np
import torch

from . import taps as taps_mod
from .fir import FIR, carried, device_taps
from .fir_kernel import fir_rows
from ..runtime.block import Block, Chain


def build_polyphase_bank(interp: int, prototype: np.ndarray) -> np.ndarray:
    """[interp, tapsPerPhase]; phases[(interp-1) - (i % interp), i//interp]
    = prototype[i]  (reference polyphase_bank.h:31-37)."""
    size = prototype.shape[0]
    tpp = (size + interp - 1) // interp
    bank = np.zeros((interp, tpp), dtype=prototype.dtype)
    idx = np.arange(interp * tpp)
    vals = np.where(idx < size,
                    np.pad(prototype, (0, interp * tpp - size)), 0)
    bank[(interp - 1) - (idx % interp), idx // interp] = vals
    return bank


class PolyphaseResampler(Block):
    """Rational L/M resampler as one strided correlation with ``interp``
    output phases (offsets c_r folded into the widened kernel)."""

    def __init__(self, interp: int, decim: int, prototype: np.ndarray):
        self.interp = int(interp)
        self.decim = int(decim)
        bank = build_polyphase_bank(self.interp,
                                    np.asarray(prototype, np.float64))
        self.tpp = bank.shape[1]
        K = self.tpp
        kw = K + self.decim - 1
        kernel = np.zeros((self.interp, kw), dtype=np.float64)
        for r in range(self.interp):
            p_r = (r * self.decim) % self.interp
            c_r = (r * self.decim) // self.interp
            kernel[r, c_r:c_r + K] = bank[p_r]
        self.kernel = kernel
        self.ratio = Fraction(self.interp, self.decim)
        self.in_multiple = self.decim

    def init_state(self, batch_shape=(), dtype=torch.complex64):
        return torch.zeros(batch_shape + (self.tpp - 1,), dtype=dtype)

    def apply(self, params, state, x):
        if x.shape[-1] % self.decim:
            raise ValueError(
                f"PolyphaseResampler: block length {x.shape[-1]} is not a "
                f"multiple of decim={self.decim}")
        x = x.contiguous() if x.is_complex() else x.float().contiguous()
        return fir_rows(x, carried(state, x),
                        device_taps(self, self.kernel, x.device),
                        self.interp, self.decim)


def fold_output_fir(poly: PolyphaseResampler,
                    fir_taps: np.ndarray) -> PolyphaseResampler:
    """Fold a causal output-rate FIR h (z[o] = Σ_j h[j]·y[o−j]) INTO a
    polyphase L/M resampler: with S = ⌈(K−1)/I⌉ extra input blocks of
    history,
        k″[r, λ] = Σ_j h[j]·kernel[(r−j) mod I, λ − D·(S + ⌊(r−j)/I⌋)].
    The longer ``tpp`` (= +S·D) is the whole state of the cascade."""
    h = np.asarray(fir_taps, np.float64)
    K = h.shape[0]
    I, D = poly.interp, poly.decim
    S = (K - 1 + I - 1) // I
    kern = np.asarray(poly.kernel, np.float64)
    kw = kern.shape[1]
    kw2 = kw + S * D
    k2 = np.zeros((I, kw2), np.float64)
    for r in range(I):
        for j in range(K):
            rp = (r - j) % I
            sh = D * (S + (r - j) // I)
            k2[r, sh:sh + kw] += h[j] * kern[rp]
    out = PolyphaseResampler.__new__(PolyphaseResampler)
    out.interp = I
    out.decim = D
    out.tpp = poly.tpp + S * D
    out.kernel = k2
    out.ratio = poly.ratio
    out.in_multiple = poly.in_multiple
    return out


def design_decim_stage(fs_in: float, decim: int,
                       protect: float) -> np.ndarray:
    """One decimate-by-``decim`` lowpass stage protecting [0, protect] Hz
    (stopband from fs_in/decim - protect, transition centred)."""
    pass_edge = protect
    stop_edge = fs_in / float(decim) - protect
    if not stop_edge > pass_edge:
        raise ValueError(f"no transition band: {(fs_in, decim, protect)}")
    trans = (stop_edge - pass_edge) / 2.0
    cutoff = (pass_edge + stop_edge) / 2.0
    count = max(taps_mod.estimate_tap_count(trans, fs_in), 7)
    return taps_mod.windowed_sinc_hz(count, cutoff, fs_in, norm=1.0)


def design_halfband_stage(fs_in: float, protect: float) -> np.ndarray:
    """Decimate-by-2 special case of :func:`design_decim_stage`."""
    return design_decim_stage(fs_in, 2, protect)


class PowerDecimator(Block):
    """Power-of-2 decimation via cascaded decimating FIR stages, by 4
    where the tap budget allows (reference power_decimator.h)."""

    MAX_RATIO = 8192
    MAX_STAGE_TAPS = 320

    def __init__(self, fs_in: float, ratio: int, protect_frac: float = 0.45):
        if not (2 <= ratio <= self.MAX_RATIO and ratio & (ratio - 1) == 0):
            raise ValueError(f"ratio {ratio} is not a power of 2 in range")
        self.ratio_int = ratio
        fs_out = fs_in / ratio
        protect = protect_frac * fs_out
        stages: List[FIR] = []
        fs = fs_in
        rem = ratio
        while rem > 1:
            d = 4 if rem % 4 == 0 else 2
            if d == 4:
                if fs / 4.0 - protect <= protect:
                    d = 2
                else:
                    taps = design_decim_stage(fs, 4, protect)
                    if len(taps) > self.MAX_STAGE_TAPS:
                        d = 2
            if d == 2:
                taps = design_decim_stage(fs, 2, protect)
            stages.append(FIR(taps, decim=d))
            fs /= d
            rem //= d
        self.stages = stages
        self.ratio = Fraction(1, ratio)
        self.in_multiple = ratio

    def init_state(self, batch_shape=(), dtype=torch.complex64):
        return [s.init_state(batch_shape, dtype) for s in self.stages]

    def apply(self, params, state, x):
        new_state = []
        for s, st in zip(self.stages, state):
            x, nst = s.apply(None, st, x)
            new_state.append(nst)
        return x, new_state


class RationalResampler(Block):
    """PowerDecimator then PolyphaseResampler (reference
    rational_resampler.h:128-173 reconfigure(), with the power-of-2
    predecimation backed off until it divides fs_in exactly)."""

    def __init__(self, fs_in: float, fs_out: float):
        self.fs_in = float(fs_in)
        self.fs_out = float(fs_out)
        predec_power = 0
        if fs_in > fs_out:
            predec_power = min(int(math.floor(math.log2(fs_in / fs_out))), 13)
        while predec_power > 0 and (fs_in / (1 << predec_power)
                                    != round(fs_in / (1 << predec_power))):
            predec_power -= 1
        predec_ratio = min(1 << predec_power, PowerDecimator.MAX_RATIO)
        use_decim = fs_in > fs_out and predec_power > 0
        int_sr = fs_in / predec_ratio if use_decim else fs_in

        int_i = round(int_sr)
        out_i = round(fs_out)
        g = math.gcd(int_i, out_i)
        interp = out_i // g
        decim = int_i // g
        actual_out = int_sr * interp / decim
        self.rate_error_pct = abs((actual_out - fs_out) / fs_out) * 100.0

        blocks = []
        if use_decim:
            blocks.append(("decim", PowerDecimator(fs_in, predec_ratio)))
        if interp != decim:
            tap_sr = int_sr * interp
            bw = min(fs_in, fs_out) / 2.0
            proto = taps_mod.low_pass(bw, bw * 0.1, tap_sr) * interp
            blocks.append(("resamp", PolyphaseResampler(interp, decim, proto)))
        self.chain = Chain(blocks)
        self.ratio = self.chain.ratio
        self.in_multiple = self.chain.in_multiple

    def init_state(self, batch_shape=(), dtype=torch.complex64):
        return {name: blk.init_state(batch_shape, dtype)
                for name, blk in self.chain.named_blocks}

    def apply(self, params, state, x):
        return self.chain.apply(None, state, x)
