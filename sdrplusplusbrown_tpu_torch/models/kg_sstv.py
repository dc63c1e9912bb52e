"""KG-SSTV decoder — 1200 baud narrow FM digital SSTV frames
(counterpart of sdrplusplusbrown_tpu/models/kg_sstv.py).

reference: decoder_modules/kg_sstv_decoder/src/kg_sstv_dsp.h —
FM demod (±300 Hz deviation) → RRC(31, α=0.7) → M&M (1e-6/0.01) →
soft symbols; Deframer: 63-bit sync word matched on hard decisions with
≤4 errors (:145-163), then 108 soft symbols, descrambled by inverting
the positions flagged in the 115-bit scrambling sequence (:184-191),
soft-Viterbi decoded with K=7 polys 0o155/0o117 (:55,194).

Note: upstream passes num_encoded_bits=124 to the conv decoder while
only 108 soft symbols exist (reading stale buffer bytes) and swaps 7
output bytes; here the honest 108 coded bits → 48 data bits = 6 payload
bytes per frame.  The sync/scrambler bit arrays are small protocol
constants carried as data (kg_sstv_dsp.h:30-46).

The demod runs on the card (GFSKDemod: K8, K13m) and so does each frame's
K = 7 Viterbi (K16, 54 steps); the sync search is host numpy.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..runtime.block import entry_device
from ..ops.demod_digital import GFSKDemod
from ..ops.fec import conv_encode, viterbi_decode

KGSSTV_DEVIATION = 300.0
KGSSTV_BAUD = 1200.0
KGSSTV_RRC_ALPHA = 0.7
CONV_G1, CONV_G2, CONV_K = 0o155, 0o117, 7
FRAME_SOFT_BITS = 108
FRAME_BYTES = (FRAME_SOFT_BITS // 2 - (CONV_K - 1)) // 8      # 6

SYNC_WORD = np.array([
    0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 1, 0, 0, 1, 0,
    0, 0, 1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0,
    1, 1, 1, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1,
    0, 1, 0, 1, 0, 0, 1, 1, 1, 1, 1, 1, 0, 1, 0], np.uint8)

SCRAMBLING = np.array([
    1, 1, 1, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1, 0, 0,
    1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 1, 1, 0, 0, 1,
    0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 0, 1, 0, 1, 0,
    1, 0, 0, 1, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 0,
    0, 0, 0, 1, 0, 1, 1, 0, 0, 0, 0, 1, 1, 0, 0, 1,
    0, 1, 1, 1, 1, 1, 1, 1, 0, 1, 0, 1, 1, 0, 1, 1,
    1, 0, 1, 1, 1, 1, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0,
    0, 1, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1], np.uint8)


class KGSSTVDemod(GFSKDemod):
    def __init__(self, samplerate: float):
        super().__init__(KGSSTV_BAUD, samplerate, KGSSTV_DEVIATION,
                         rrc_tap_count=31, rrc_beta=KGSSTV_RRC_ALPHA,
                         omega_gain=1e-6, mu_gain=0.01,
                         omega_rel_limit=0.01)


class KGSSTVDeframer:
    """Soft symbol stream → 6-byte frames; the Viterbi on ``device``
    (CUDA unless the caller asks for the CPU)."""

    def __init__(self, device="cuda"):
        self.device = entry_device(device)
        self._soft = np.zeros(0, np.float32)
        self.frames: List[bytes] = []
        self.frames_seen = 0

    def push_symbols(self, soft: np.ndarray):
        self._soft = np.concatenate([self._soft,
                                     np.asarray(soft, np.float32)])
        L = len(SYNC_WORD)
        while True:
            n = len(self._soft)
            if n < L + FRAME_SOFT_BITS:
                return
            hard = (self._soft[:n - FRAME_SOFT_BITS + 1] > 0) \
                .astype(np.uint8)
            win = np.lib.stride_tricks.sliding_window_view(hard, L) \
                if len(hard) >= L else np.zeros((0, L), np.uint8)
            dist = (win != SYNC_WORD).sum(axis=1)
            hits = np.flatnonzero(dist <= 4)
            if len(hits) == 0:
                self._soft = self._soft[-(L + FRAME_SOFT_BITS):]
                return
            start = int(hits[0]) + L
            if n - start < FRAME_SOFT_BITS:
                self._soft = self._soft[start - L:]
                return
            frame = self._soft[start:start + FRAME_SOFT_BITS].copy()
            # descramble: invert flagged soft symbols (kg_sstv_dsp.h:186)
            frame[SCRAMBLING[:FRAME_SOFT_BITS] == 1] *= -1.0
            soft01 = np.clip(frame / 2.0 + 0.5, 0.0, 1.0)
            bits = viterbi_decode(soft01.astype(np.float32), CONV_G1,
                                  CONV_G2, CONV_K, device=self.device)
            self.frames.append(np.packbits(
                bits[:FRAME_BYTES * 8]).tobytes())
            self.frames_seen += 1
            self._soft = self._soft[start + FRAME_SOFT_BITS:]


def build_frame_symbols(payload: bytes) -> np.ndarray:
    """6-byte payload → sync + 108 scrambled NRZ symbols (TX/tests)."""
    payload = bytes(payload)
    assert len(payload) == FRAME_BYTES
    bits = np.unpackbits(np.frombuffer(payload, np.uint8))
    coded = conv_encode(bits, CONV_G1, CONV_G2, CONV_K)
    assert len(coded) == FRAME_SOFT_BITS
    nrz = 2.0 * coded.astype(np.float32) - 1.0
    nrz[SCRAMBLING[:FRAME_SOFT_BITS] == 1] *= -1.0
    sync = 2.0 * SYNC_WORD.astype(np.float32) - 1.0
    return np.concatenate([sync, nrz])
