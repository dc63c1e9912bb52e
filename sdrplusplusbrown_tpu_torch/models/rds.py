"""RDS demodulation and group decoding (counterpart of
sdrplusplusbrown_tpu/models/rds.py; reference
decoder_modules/radio/src/rds_demod.h and rds.{h,cpp}).

``RDSDemod`` takes the WFM demod's 5 kS/s complex RDS tap (BroadcastFM
with ``rds_out``) to hard bits (reference rds_demod.h:19-41):

    AGC → Costas<2>(bw 0.005) → band-pass 0–2375 Hz (trans 100) →
    Costas<2>(bw 0.01, init ω = 2π·1187.5/5000, ±10 %) → Re{} →
    M&M clock recovery (ω = 5000/1187.5) → slicer → differential decode

On the card the AGC is kernel K12's complex form, both Costas loops and
the clock recovery kernel K13 (ops/costas.py, ops/clock_recovery.py) and
the band-pass kernel K9; the slicer and the differential decode are
elementwise, the carried bit taken by a gather at the valid count, so a
block reads nothing back.  Its output is a fixed-size (hard bits, valid)
pair, as the JAX block's.

The group codec and ``RDSDecoder`` (26-bit blocks, offset words A/B/C/C'/D,
sync by syndrome, PI / PTY / PS / RadioText; the public RDS standard,
IEC 62106) are host Python on the bits the app reads back once a block,
a copy of the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..runtime.block import Block
from ..ops import taps as taps_mod
from ..ops.agc import AGC
from ..ops.clock_recovery import MMClockRecovery
from ..ops.costas import Costas
from ..ops.fir import FIR


class RDSDemod(Block):
    """5000 S/s complex RDS baseband → (hard bits, valid) per block."""

    def __init__(self, samplerate: float = 5000.0, baud: float = 2375.0 / 2):
        self.samplerate = float(samplerate)
        self.agc = AGC(set_point=1.0, attack=0.1, decay=0.1, max_gain=1e6)
        self.costas = Costas(2, 0.005)
        self.fir = FIR(taps_mod.band_pass_complex(0.0, 2375.0, 100.0,
                                                  samplerate))
        baudfreq = 2.0 * np.pi * baud / samplerate
        self.costas2 = Costas(2, 0.01, init_freq=baudfreq,
                              min_freq=baudfreq * 0.9,
                              max_freq=baudfreq * 1.1)
        self.recov = MMClockRecovery(samplerate / baud, 1e-6, 0.01, 0.01,
                                     complex_data=False)

    def init_state(self, batch_shape=()):
        if batch_shape != ():
            raise ValueError("RDSDemod is per-stream")
        return {
            "agc": self.agc.init_state(()),
            "costas": self.costas.init_state(()),
            "fir": self.fir.init_state(()),
            "costas2": self.costas2.init_state(()),
            "recov": self.recov.init_state(()),
            "diff_prev": torch.zeros((), dtype=torch.int32),
        }

    def apply(self, params, state, x):
        """x: [T] complex64 → ((hard [max_out] uint8, valid [max_out]
        bool), new state); the valid symbols come first."""
        st = dict(state)
        y, st["agc"] = self.agc.apply(None, state["agc"], x)
        y, st["costas"] = self.costas.apply(None, state["costas"], y)
        y, st["fir"] = self.fir.apply(None, state["fir"], y)
        y, st["costas2"] = self.costas2.apply(None, state["costas2"], y)
        (sym, valid), st["recov"] = self.recov.apply(
            None, state["recov"], y.real.contiguous())
        bits = (sym > 0.0).to(torch.int32)
        prev = state["diff_prev"].to(bits.device)
        hard = torch.remainder(bits - torch.cat([prev[None], bits[:-1]]),
                               2).to(torch.uint8)
        # carry the last valid bit: a gather at the valid count, no read
        n_valid = valid.sum(dtype=torch.int32)
        last = bits.gather(0, torch.clamp(n_valid - 1, min=0).long()[None])
        st["diff_prev"] = torch.where(n_valid > 0, last[0], prev)
        return (hard, valid), st


# ----------------------------------------------------------------------
# Group codec (host side — tiny bit-level logic at 1187.5 bps)

_GENERATOR = 0x5B9   # g(x) = x^10+x^8+x^7+x^5+x^4+x^3+1
_OFFSETS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "Cp": 0x350, "D": 0x1B4}
_BLOCK_SEQ = ["A", "B", "C", "D"]


def rds_checkword(data16: int) -> int:
    """10-bit CRC of a 16-bit block (polynomial division by g(x))."""
    reg = data16 << 10
    for bit in range(25, 9, -1):
        if reg & (1 << bit):
            reg ^= _GENERATOR << (bit - 10)
    return reg & 0x3FF


def rds_encode_block(data16: int, offset: str) -> int:
    return (data16 << 10) | (rds_checkword(data16) ^ _OFFSETS[offset])


def rds_syndrome(block26: int) -> int:
    data = block26 >> 10
    return (block26 & 0x3FF) ^ rds_checkword(data)


def identify_block(block26: int) -> Optional[str]:
    s = rds_syndrome(block26)
    for name, off in _OFFSETS.items():
        if s == off:
            return name
    return None


class RDSDecoder:
    """Bit stream → synchronized groups → PI / PTY / PS / RadioText."""

    def __init__(self):
        self.synced = False
        self.block_idx = 0
        self.group: List[Optional[int]] = [None] * 4
        self.pi: Optional[int] = None
        self.pty: Optional[int] = None
        self.ps = [" "] * 8
        self.radiotext = [" "] * 64
        self.groups_decoded = 0
        self._window: List[int] = []

    def push_bits(self, bits):
        for b in np.asarray(bits).reshape(-1):
            self._push(int(b) & 1)

    def _push(self, bit: int):
        self._window.append(bit)
        if len(self._window) > 26:
            self._window.pop(0)
        if len(self._window) < 26:
            return
        word = int("".join(map(str, self._window)), 2)
        if not self.synced:
            if identify_block(word) == "A":
                self.synced = True
                self._handle_block(word, "A")
                self._window.clear()
            return
        expect = _BLOCK_SEQ[self.block_idx]
        kind = identify_block(word)
        if kind == "Cp" and expect == "C":
            kind = "C"
        if kind == expect:
            self._handle_block(word, kind)
        else:
            # lost sync: restart the search
            self.synced = False
            self.block_idx = 0
            self.group = [None] * 4
        self._window.clear()

    def _handle_block(self, word: int, kind: str):
        self.group[self.block_idx] = word >> 10
        self.block_idx += 1
        if self.block_idx == 4:
            self._decode_group(list(self.group))
            self.block_idx = 0
            self.group = [None] * 4

    def _decode_group(self, g: List[int]):
        self.groups_decoded += 1
        self.pi = g[0]
        gtype = (g[1] >> 12) & 0xF
        version_b = (g[1] >> 11) & 1
        self.pty = (g[1] >> 5) & 0x1F
        if gtype == 0:
            addr = g[1] & 0x3
            chars = g[3]
            self.ps[addr * 2] = chr((chars >> 8) & 0xFF)
            self.ps[addr * 2 + 1] = chr(chars & 0xFF)
        elif gtype == 2 and not version_b:
            addr = g[1] & 0xF
            self.radiotext[addr * 4] = chr((g[2] >> 8) & 0xFF)
            self.radiotext[addr * 4 + 1] = chr(g[2] & 0xFF)
            self.radiotext[addr * 4 + 2] = chr((g[3] >> 8) & 0xFF)
            self.radiotext[addr * 4 + 3] = chr(g[3] & 0xFF)

    def ps_name(self) -> str:
        return "".join(self.ps)

    def radio_text(self) -> str:
        return "".join(self.radiotext).rstrip()

    def status(self) -> Dict:
        return {"synced": self.synced,
                "pi": self.pi, "pty": self.pty,
                "ps": self.ps_name(), "radiotext": self.radio_text(),
                "groups": self.groups_decoded}


def rds_encode_group(pi: int, gtype: int, version_b: bool, pty: int,
                     payload2: int, block3: int, block4: int) -> List[int]:
    """The 4 × 26-bit blocks of one group (test and transmit helper)."""
    b2 = ((gtype & 0xF) << 12) | (int(version_b) << 11) \
        | ((pty & 0x1F) << 5) | (payload2 & 0x1F)
    return [rds_encode_block(pi, "A"),
            rds_encode_block(b2, "B"),
            rds_encode_block(block3, "Cp" if version_b else "C"),
            rds_encode_block(block4, "D")]


def rds_group_bits(blocks26: List[int]) -> np.ndarray:
    bits = []
    for b in blocks26:
        bits.extend((b >> i) & 1 for i in range(25, -1, -1))
    return np.array(bits, np.uint8)
