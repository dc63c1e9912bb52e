"""NOAA HRPT weather-satellite decoder — PM demod at 3 MS/s, Manchester
deframing on the 60-bit sync, 10-bit word demux into AVHRR image lines
(counterpart of sdrplusplusbrown_tpu/models/hrpt.py).

reference: decoder_modules/weather_sat_decoder/src/noaa_hrpt_decoder.h —
PMDemod(3 MS/s, 2×665 400 baud, RRC 32/0.6, PLL bw (0.06²)/2, clock
gains 0.01/0.005, noaa_hrpt_decoder.h:22) → ManchesterDeframer
(11090·10·2 symbol bits per frame, 60-bit sync, :31) → Manchester decode
→ 10-bit BitPacker → HRPTDemux → 5×2048-pixel AVHRR lines rendered as
(val·255/1024) grayscale (:315-389) and an RGB221 composite (:291-313).
The reference's TIP/HIRS fan-out terminates in empty handlers/null sinks
(:392-470,506-511); here TIP words are surfaced as data instead.

The frame layout constants are the public NOAA KLM HRPT minor-frame
format: 11090 words of 10 bits; words 0-5 sync (0x0284 0x016F 0x035C
0x019D 0x083C 0x095A), words 103-622 TIP, words 750-10989 AVHRR video
with the 5 channels interleaved per pixel.

On a CUDA tensor the demod runs on the card: the complex AGC on K12c,
the carrier PLL on K13's PLL form, the de-rotation and the phase
(elementwise), the RRC on K8 and the clock recovery on K13m's real form.
The framer is host numpy at word rate, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..runtime.block import Block
from ..ops.agc import AGC
from ..ops.pll import PLL
from ..ops.fir import RealFIR
from ..ops import taps as taps_mod
from ..ops.clock_recovery import MMClockRecovery

HRPT_VFO_SR = 3_000_000.0        # noaa_hrpt_decoder.h:12
HRPT_BAUD = 665_400.0 * 2.0      # Manchester symbol rate, :22
FRAME_WORDS = 11090
WORD_BITS = 10
FRAME_BITS = FRAME_WORDS * WORD_BITS
# Public NOAA KLM sync words (6 × 10 bits)
SYNC_WORDS = (0x0284, 0x016F, 0x035C, 0x019D, 0x083C, 0x095A)
AVHRR_START = 750                # first video word
AVHRR_PIXELS = 2048
TIP_START, TIP_WORDS = 103, 520


def words_to_bits(words) -> np.ndarray:
    w = np.asarray(words, np.int64)
    shifts = np.arange(WORD_BITS - 1, -1, -1)
    return ((w[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1)


SYNC_BITS = words_to_bits(SYNC_WORDS)                      # 60 bits


def manchester_encode(bits: np.ndarray) -> np.ndarray:
    """bit 1 → (1,0), bit 0 → (0,1)."""
    b = np.asarray(bits, np.uint8)
    out = np.empty(b.size * 2, np.uint8)
    out[0::2] = b
    out[1::2] = 1 - b
    return out


def manchester_decode(symbols: np.ndarray) -> np.ndarray:
    """(first half of each pair carries the bit)."""
    return np.asarray(symbols, np.uint8)[0::2]


class PMDemod(Block):
    """complex 3 MS/s → (soft symbol bits, valid): carrier PLL phase
    detector → RRC matched filter → M&M clock recovery.

    reference: the old-API dsp::PMDemod chain configured at
    noaa_hrpt_decoder.h:22 (AGC → PLL(bw (0.06²)/2) → RRC(32, 0.6) →
    recovery).  The JAX package's clock gains 1e-6/0.01 (its note:
    0.01 as the frequency gain random-walks into one-symbol slips every
    ~10^5 symbols on this loop), with omega_rel_limit 0.01."""

    def __init__(self, samplerate: float = HRPT_VFO_SR,
                 baud: float = HRPT_BAUD, agc_rate: float = 0.02e-3,
                 pll_bw: float = (0.06 ** 2) / 2.0,
                 rrc_tap_count: int = 32, rrc_beta: float = 0.6,
                 omega_gain: float = 1e-6, mu_gain: float = 0.01):
        self.samplerate = float(samplerate)
        self.baud = float(baud)
        self.agc = AGC(set_point=1.0, attack=agc_rate, decay=agc_rate,
                       max_gain=10e6)
        self.pll = PLL(pll_bw)
        self.rrc = RealFIR(taps_mod.root_raised_cosine(
            rrc_tap_count, rrc_beta, samplerate / baud))
        self.recov = MMClockRecovery(samplerate / baud, omega_gain,
                                     mu_gain, omega_rel_limit=0.01,
                                     complex_data=False)

    def init_state(self, batch_shape=()):
        assert batch_shape == ()
        return {"agc": self.agc.init_state(()),
                "pll": self.pll.init_state(()),
                "rrc": self.rrc.init_state(()),
                "recov": self.recov.init_state(())}

    def apply(self, params, state, x):
        st = dict(state)
        y, st["agc"] = self.agc.apply(None, state["agc"], x)
        vco, st["pll"] = self.pll.apply(None, state["pll"], y)
        d = y * vco.conj()              # de-rotate by the carrier
        m = torch.atan2(d.imag, d.real)     # PM modulation
        m, st["rrc"] = self.rrc.apply(None, state["rrc"], m)
        (sym, valid), st["recov"] = self.recov.apply(None, state["recov"],
                                                     m)
        return (sym, valid), st


class HRPTFramer:
    """Host-side symbol-bit stream → frames → AVHRR lines / TIP words.

    reference: ManchesterDeframer + ManchesterDecoder + BitPacker +
    HRPTDemux (noaa_hrpt_decoder.h:31-36,491-496)."""

    def __init__(self):
        self._bits = np.zeros(0, np.uint8)
        self.sync = manchester_encode(SYNC_BITS)       # 120 symbol bits
        self.frames = 0
        self.avhrr_lines: List[np.ndarray] = []        # each [5, 2048] u16
        self.tip: List[np.ndarray] = []                # each [520] u16

    def _demux(self, words: np.ndarray):
        video = words[AVHRR_START:AVHRR_START + AVHRR_PIXELS * 5]
        self.avhrr_lines.append(
            video.reshape(AVHRR_PIXELS, 5).T.astype(np.uint16))
        self.tip.append(words[TIP_START:TIP_START + TIP_WORDS]
                        .astype(np.uint16))
        self.frames += 1

    def push_symbols(self, symbols: np.ndarray):
        """symbols: hard Manchester symbol bits (0/1)."""
        self._bits = np.concatenate([self._bits,
                                     np.asarray(symbols, np.uint8)])
        L = len(self.sync)
        need = FRAME_BITS * 2
        while True:
            n = len(self._bits)
            if n < need:
                return
            # correlate for the sync pattern (exact match on 120 bits)
            view = np.lib.stride_tricks.sliding_window_view(
                self._bits[:n - need + L + 1], L)
            hits = np.flatnonzero((view == self.sync).all(axis=1))
            if len(hits) == 0:
                self._bits = self._bits[-(need + L):]
                return
            start = int(hits[0])
            if n - start < need:
                self._bits = self._bits[start:]
                return
            frame_syms = self._bits[start:start + need]
            bits = manchester_decode(frame_syms)
            words = np.packbits(
                bits.reshape(FRAME_WORDS, WORD_BITS), axis=-1,
                bitorder="big")
            # packbits pads 10→16 in two bytes: recombine
            words = (words[:, 0].astype(np.uint16) << 2) \
                | (words[:, 1].astype(np.uint16) >> 6)
            self._demux(words)
            self._bits = self._bits[start + need:]


def build_frame(avhrr5x2048: np.ndarray,
                tip: Optional[np.ndarray] = None) -> np.ndarray:
    """Assemble one 11090-word minor frame (for TX/tests)."""
    words = np.zeros(FRAME_WORDS, np.uint16)
    words[0:6] = SYNC_WORDS
    if tip is not None:
        words[TIP_START:TIP_START + TIP_WORDS] = tip
    v = np.asarray(avhrr5x2048, np.uint16)
    assert v.shape == (5, AVHRR_PIXELS)
    words[AVHRR_START:AVHRR_START + AVHRR_PIXELS * 5] = v.T.reshape(-1)
    return words


def pm_modulate(symbol_bits: np.ndarray, samplerate: float = HRPT_VFO_SR,
                baud: float = HRPT_BAUD,
                index_rad: float = 1.17) -> np.ndarray:
    """NRZ phase modulation of Manchester symbol bits (test generator)."""
    sps = samplerate / baud
    n_out = int(math.ceil(len(symbol_bits) * sps))
    t_idx = np.minimum((np.arange(n_out) / sps).astype(np.int64),
                       len(symbol_bits) - 1)
    nrz = 2.0 * np.asarray(symbol_bits, np.float64)[t_idx] - 1.0
    return np.exp(1j * index_rad * nrz).astype(np.complex64)


def frames_signal(rng, frames, preamble: int = 15_000) -> np.ndarray:
    """Manchester symbol bits of ``preamble`` random bits, then each
    frame's words, then 4 000 symbols of idle pattern (the generator of
    tests/test_hrpt.py)."""
    bits = [manchester_encode(rng.integers(0, 2, preamble))]
    for words in frames:
        bits.append(manchester_encode(words_to_bits(words)))
    bits.append(np.tile([1, 0], 2000))
    return np.concatenate(bits)
