"""Falcon-9 telemetry downlink decoder — 3.571 Mbaud FSK, CCSDS ASM
deframing, dual-basis RS(255,239)×5 FEC, packet reassembly (counterpart
of sdrplusplusbrown_tpu/models/falcon9.py).

reference: decoder_modules/falcon9_decoder/src/ —
  * FM demod at 6 MS/s (dev 2 MHz) → M&M recovery at 6e6/3 571 400
    samples/symbol → threshold to bits (main.cpp:52-59);
  * Deframer: 32-bit CCSDS ASM 0x1ACFFC1D, 10 232-bit frames
    (main.cpp:60,232);
  * FalconRS (falcon_fec.h:96-180): skip 4 bytes, deinterleave depth 5,
    dual-basis→conventional, RS(255,239) (CCSDS poly 0x187, fcr 120,
    gap 11) per column, then re-interleave through the dual basis and
    XOR the CCSDS randomizer — the exact (idiosyncratic) upstream order;
  * FalconPacketSync (falcon_packet.h): frame header {19-bit counter,
    11-bit first-packet offset}, length-prefixed packets spanning frames.

The demod runs on the card (``GFSKDemod``: the discriminator, the RRC on
K8, the clock recovery on K13m's real form); the deframer, the RS and the
packet layer are host numpy, as in the JAX package.  The byte tables are
generated from the public CCSDS constants (ops/fec.py).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..ops.fec import (ReedSolomon, ccsds_randomizer, TO_DUAL_BASIS,
                       FROM_DUAL_BASIS)
from ..ops.demod_digital import GFSKDemod

FALCON_SR = 6_000_000.0          # main.cpp:35
FALCON_BAUD = 3_571_400.0        # main.cpp:53
FALCON_DEV = 2_000_000.0         # main.cpp:52
ASM = 0x1ACFFC1D                 # main.cpp:232 bit pattern
FRAME_BITS = 10_232              # main.cpp:60
FRAME_BYTES = FRAME_BITS // 8    # 1279
RS_COLS, RS_N, RS_K = 5, 255, 239
DATA_LEN = 1191                  # falcon_packet.h:39

_RS = ReedSolomon(16, 120, 11, 0x187)
_RAND = ccsds_randomizer(255)

ASM_BITS = np.array([(ASM >> (31 - i)) & 1 for i in range(32)], np.uint8)


class FalconDemod(GFSKDemod):
    """6 MS/s FSK front end (FM demod → M&M at ~1.68 samples/symbol)."""

    def __init__(self):
        super().__init__(FALCON_BAUD, FALCON_SR, FALCON_DEV,
                         rrc_tap_count=31, rrc_beta=0.6,
                         omega_gain=(0.01 ** 2) / 4.0, mu_gain=0.01,
                         omega_rel_limit=100e-6)


class FalconDeframer:
    """Hard bit stream → 1279-byte frames on the CCSDS ASM (≤2 bit
    errors tolerated in the sync word)."""

    def __init__(self):
        self._bits = np.zeros(0, np.uint8)
        self.frames: List[np.ndarray] = []

    def push_bits(self, bits: np.ndarray):
        self._bits = np.concatenate([self._bits,
                                     np.asarray(bits, np.uint8)])
        need = FRAME_BITS
        while True:
            n = len(self._bits)
            if n < 32 + need:
                return
            win = np.lib.stride_tricks.sliding_window_view(
                self._bits[:n - need + 1], 32)
            dist = (win != ASM_BITS).sum(axis=1)
            hits = np.flatnonzero(dist <= 2)
            if len(hits) == 0:
                self._bits = self._bits[-(need + 32):]
                return
            start = int(hits[0]) + 32
            if n - start < need:
                self._bits = self._bits[start - 32:]
                return
            frame_bits = self._bits[start:start + need]
            self.frames.append(np.packbits(frame_bits))
            self._bits = self._bits[start + need:]


def falcon_rs_decode(frame: np.ndarray) -> Optional[np.ndarray]:
    """1279-byte frame → 1275-byte corrected output (falcon_fec.h:106-167
    order: +4 skip, deinterleave, fromDB, RS, toDB + randomizer)."""
    data = np.asarray(frame, np.uint8)[4:4 + RS_N * RS_COLS]
    cols = FROM_DUAL_BASIS[data].reshape(RS_N, RS_COLS).T
    out_cols = np.zeros((RS_COLS, RS_N), np.uint8)
    for c in range(RS_COLS):
        dec = _RS.decode(cols[c].tobytes())
        if dec is None:
            return None
        out_cols[c, :RS_K] = np.frombuffer(dec, np.uint8)
    inter = out_cols.T.reshape(-1)        # re-interleave
    return TO_DUAL_BASIS[inter] ^ np.tile(_RAND, RS_COLS)[:RS_N * RS_COLS]


def falcon_rs_encode(payload: np.ndarray) -> np.ndarray:
    """Inverse of falcon_rs_decode for loopback tests: payload is the
    1195 post-chain bytes the packet layer consumes (header+data)."""
    payload = np.asarray(payload, np.uint8)
    assert len(payload) == RS_K * RS_COLS
    scram = payload ^ np.tile(_RAND, RS_COLS)[:RS_K * RS_COLS]
    cols = FROM_DUAL_BASIS[scram].reshape(RS_K, RS_COLS).T
    enc_cols = np.zeros((RS_COLS, RS_N), np.uint8)
    for c in range(RS_COLS):
        enc_cols[c] = np.frombuffer(_RS.encode(cols[c].tobytes()),
                                    np.uint8)
    wire = TO_DUAL_BASIS[enc_cols.T.reshape(-1)]
    return np.concatenate([np.zeros(4, np.uint8), wire])


class FalconPacketSync:
    """Corrected frames → packets (falcon_packet.h:28-105)."""

    def __init__(self):
        self.last_counter = 0
        self.partial = np.zeros(0, np.uint8)
        self.reading = False
        self.packets: List[bytes] = []

    def push_frame(self, out: np.ndarray):
        b = np.asarray(out, np.uint8)
        pkt_off = int(b[3]) | ((int(b[2]) & 0b111) << 8)
        counter = (int(b[2]) >> 3) | (int(b[1]) << 5) \
            | ((int(b[0]) & 0b111111) << 13)
        data = b[4:4 + DATA_LEN]
        if self.last_counter + 1 != counter:
            self.reading = False
        self.last_counter = counter
        if pkt_off == 2047:          # continuation-only frame
            if self.reading:
                self.partial = np.concatenate([self.partial, data])
            return
        if self.reading:
            self.partial = np.concatenate([self.partial,
                                           data[:pkt_off]])
            # upstream flushes the partial at the next packet boundary
            self._finish_partial()
        i = pkt_off
        while i < DATA_LEN:
            if DATA_LEN - i < 4:
                self.partial = data[i:].copy()
                self.reading = True
                return
            length = (((int(data[i]) & 0b1111) << 8)
                      | int(data[i + 1])) + 2
            if length <= 2:
                self.reading = False
                return
            if DATA_LEN - i < length:
                self.partial = data[i:].copy()
                self.reading = True
                return
            self.packets.append(data[i:i + length].tobytes())
            i += length
        self.reading = False

    def _finish_partial(self):
        if len(self.partial) >= 2:
            self.packets.append(self.partial.tobytes())
        self.partial = np.zeros(0, np.uint8)
        self.reading = False


def build_frame_payload(counter: int, packets_chunk: bytes,
                        first_packet: int) -> np.ndarray:
    """Assemble the 1195-byte header+data payload for TX tests."""
    out = np.zeros(RS_K * RS_COLS, np.uint8)
    out[0] = (counter >> 13) & 0b111111
    out[1] = (counter >> 5) & 0xFF
    out[2] = ((counter & 0b11111) << 3) | ((first_packet >> 8) & 0b111)
    out[3] = first_packet & 0xFF
    chunk = np.frombuffer(packets_chunk[:DATA_LEN], np.uint8)
    out[4:4 + len(chunk)] = chunk
    return out


def make_packet(payload: bytes) -> bytes:
    """Length-prefixed packet: 12-bit length (len(payload)+2 total)."""
    ln = len(payload)
    assert ln + 2 <= 0xFFF + 2
    return bytes([(ln >> 8) & 0b1111, ln & 0xFF]) + payload


def falcon_signal(bits: np.ndarray, noise: float = 0.0, phase0: float = 0.0,
                  rng=None, fs: float = FALCON_SR) -> np.ndarray:
    """The FSK of ``bits`` at FALCON_BAUD, ±FALCON_DEV, sampled at ``fs``,
    starting at ``phase0``, with complex noise of ``noise`` per component
    (the test generator of tests/test_falcon9.py at 6 MS/s)."""
    sps = fs / FALCON_BAUD
    n_out = int(len(bits) * sps)
    bidx = np.minimum((np.arange(n_out) / sps).astype(np.int64),
                      len(bits) - 1)
    nrz = 2.0 * np.asarray(bits, np.float64)[bidx] - 1.0
    phase = 2 * np.pi * np.cumsum(nrz) * FALCON_DEV / fs
    iq = np.exp(1j * (phase + phase0))
    if noise > 0:
        iq = iq + noise * (rng.standard_normal(n_out)
                           + 1j * rng.standard_normal(n_out))
    return iq.astype(np.complex64)


def frame_bits(wire: np.ndarray, rng, lead: int = 4000,
               trail: int = 2000) -> np.ndarray:
    """``wire`` (falcon_rs_encode's bytes) behind the ASM, between
    ``lead`` and ``trail`` random bits."""
    return np.concatenate([rng.integers(0, 2, lead).astype(np.uint8),
                           ASM_BITS, np.unpackbits(wire),
                           rng.integers(0, 2, trail).astype(np.uint8)])
