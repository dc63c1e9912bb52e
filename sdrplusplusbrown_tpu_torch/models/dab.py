"""DAB (mode I) OFDM front end — cyclic-prefix symbol sync, null-symbol
frame sync, phase-reference CFO estimation, differential-QPSK carriers
(counterpart of sdrplusplusbrown_tpu/models/dab.py).

reference: decoder_modules/dab_decoder/src/dab_dsp.h —
  * CyclicSync (:8-140): moving cross-correlation of x·conj(x delayed by
    Tu=2048) over the 504-sample cyclic prefix; a correlation peak marks
    each symbol start; emits Tu-sample symbols.
  * FrameFreqSync (:142-279): a symbol whose mean amplitude drops below
    half the running average is the null symbol → next symbol is the
    phase reference; correlating it (bin-wise multiply by the conjugate
    reference + FFT) gives the integer+fractional carrier frequency
    offset, servo'd at 0.1; data symbols emit the π/4-rotated
    carrier-differential QPSK constellation (k vs k−1 bins) exactly as
    the upstream does for its constellation display.

The 2048-point phase reference is generated from the ETSI EN 300 401
tables 38/39 (h-table + per-block (k',i,n)).  Upstream decodes no further
(no FIC/MSC Viterbi — the module renders the constellation); this matches
that scope and also exposes per-symbol carrier DQPSK dibits.

All of it is host numpy at symbol rate (~400 Hz), as in the JAX package:
the module's RxVFO (where the source is wider than 2.048 MS/s) is the
only part on the card.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

DAB_SR = 2_048_000.0
TU = 2048                 # useful symbol samples (1 ms)
CP = 504                  # cyclic prefix samples (246 µs, main.cpp:50)
TS = TU + CP
CARRIERS = 1536

# ETSI EN 300 401 Table 39 (h-table) — protocol constants
H_TABLE = np.array([
    [0, 2, 0, 0, 0, 0, 1, 1, 2, 0, 0, 0, 2, 2, 1, 1,
     0, 2, 0, 0, 0, 0, 1, 1, 2, 0, 0, 0, 2, 2, 1, 1],
    [0, 3, 2, 3, 0, 1, 3, 0, 2, 1, 2, 3, 2, 3, 3, 0,
     0, 3, 2, 3, 0, 1, 3, 0, 2, 1, 2, 3, 2, 3, 3, 0],
    [0, 0, 0, 2, 0, 2, 1, 3, 2, 2, 0, 2, 2, 0, 1, 3,
     0, 0, 0, 2, 0, 2, 1, 3, 2, 2, 0, 2, 2, 0, 1, 3],
    [0, 1, 2, 1, 0, 3, 3, 2, 2, 3, 2, 1, 2, 1, 3, 2,
     0, 1, 2, 1, 0, 3, 3, 2, 2, 3, 2, 1, 2, 1, 3, 2]])

# ETSI Table 38 (mode I): (k', i, n) per 32-carrier block
T38 = [(-768, 0, 1), (-736, 1, 2), (-704, 2, 0), (-672, 3, 1),
       (-640, 0, 3), (-608, 1, 2), (-576, 2, 2), (-544, 3, 3),
       (-512, 0, 2), (-480, 1, 1), (-448, 2, 2), (-416, 3, 3),
       (-384, 0, 1), (-352, 1, 2), (-320, 2, 3), (-288, 3, 3),
       (-256, 0, 2), (-224, 1, 2), (-192, 2, 2), (-160, 3, 1),
       (-128, 0, 1), (-96, 1, 3), (-64, 2, 1), (-32, 3, 2),
       (1, 0, 3), (33, 3, 1), (65, 2, 1), (97, 1, 1),
       (129, 0, 2), (161, 3, 2), (193, 2, 1), (225, 1, 0),
       (257, 0, 2), (289, 3, 2), (321, 2, 3), (353, 1, 3),
       (385, 0, 0), (417, 3, 2), (449, 2, 1), (481, 1, 3),
       (513, 0, 3), (545, 3, 3), (577, 2, 3), (609, 1, 0),
       (641, 0, 3), (673, 3, 0), (705, 2, 1), (737, 1, 1)]


def phase_reference_freq() -> np.ndarray:
    """Frequency-domain phase reference Z[2048] (fft bin order)."""
    Z = np.zeros(TU, complex)
    for kp, i, n in T38:
        for j in range(32):
            k = kp + j
            Z[k % TU] = np.exp(0.5j * np.pi * (H_TABLE[i][j] + n))
    return Z


def phase_reference_time() -> np.ndarray:
    """Time-domain reference symbol (the upstream table is its conj)."""
    return np.fft.ifft(phase_reference_freq())


class CyclicSync:
    """IQ at 2.048 MS/s → Tu-sample symbols via CP correlation.

    Vectorized redesign of dab_dsp.h:47-117: the per-sample moving sum
    over the 504-long prefix window becomes one cumsum; the symbol-start
    decision picks the correlation peak inside each nominal Ts window.
    """

    TRACK = 64          # ± tracking window once locked

    def __init__(self, agc_rate: float = 1e-3):
        self._buf = np.zeros(0, np.complex64)
        self.avg_corr = 0.0
        self.agc_rate = float(agc_rate)
        self.symbols: List[np.ndarray] = []
        self.positions: List[int] = []   # absolute body-start positions
        self._locked = False
        self._abs = 0                    # input samples consumed so far

    def push(self, x: np.ndarray):
        """Acquire on a full-period correlation search, then track the
        boundary in a ±TRACK window (the per-sample reference loop's
        peak-chasing collapses to this once the cadence is steady)."""
        self._buf = np.concatenate([self._buf,
                                    np.asarray(x, np.complex64)])
        W = self.TRACK
        while len(self._buf) >= TU + 2 * TS:
            seg = self._buf[:TU + 2 * TS]
            prod = np.conj(seg[:-TU]) * seg[TU:]
            c = np.concatenate([[0.0 + 0.0j], np.cumsum(prod)])
            win = np.abs(c[CP:] - c[:-CP])      # sum prod[i:i+CP]
            if not self._locked:
                peak = int(np.argmax(win[:TS]))
                self._locked = True
            else:
                # buffer was trimmed so the expected peak sits at W
                cand = int(np.argmax(win[:2 * W + 1]))
                weak = self.avg_corr > 0 and \
                    win[cand] < 0.3 * self.avg_corr
                peak = W if weak else cand      # freewheel over nulls
            if win[min(peak, len(win) - 1)] >= 0.3 * self.avg_corr \
                    or self.avg_corr == 0.0:
                self.avg_corr = (self.agc_rate * float(win[peak])
                                 + (1 - self.agc_rate) * self.avg_corr)
            self.symbols.append(
                self._buf[peak + CP:peak + CP + TU].copy())
            self.positions.append(self._abs + peak + CP)
            # leave a W guard so the next expected peak lands at W
            cut = max(peak + TS - W, 1)
            self._buf = self._buf[cut:]
            self._abs += cut


class FrameFreqSync:
    """Tu symbols → (constellations, CFO servo) per dab_dsp.h:142-279."""

    def __init__(self, agc_rate: float = 0.01):
        self.conj_ref = np.conj(phase_reference_time()).astype(
            np.complex64)
        self.agc_rate = float(agc_rate)
        self.avg_lvl = 0.0
        self.offset = 0.0            # rad/sample servo
        self.sym = 99                # symbol index since null (no false
                                     # phase-ref before the first null)
        self.constellations: List[np.ndarray] = []
        self.ffts: List[np.ndarray] = []       # per-symbol bins (demap)
        self.frames_seen = 0
        self.last_cfo_hz = 0.0

    def push_symbol(self, s: np.ndarray, pos: Optional[int] = None):
        """``pos`` (CyclicSync.positions) compensates inter-symbol timing
        jitter: a body taken δ samples late rotates bin k by
        +2πkδ/Tu — ±1 sample flips the outer carriers by ±135°, so the
        per-carrier differential demod needs the correction."""
        s = np.asarray(s, np.complex64)
        self._delta = 0
        if pos is not None:
            if not hasattr(self, "_pos_ref") or self._pos_ref is None:
                self._pos_ref = pos
                self._pos_n = 0
            self._delta = pos - self._pos_ref - self._pos_n * TS
            self._pos_n += 1
        # frequency shift by the servo'd offset — phase-continuous
        # across symbols (anchored at the absolute sample position) so
        # the per-carrier time differential doesn't pick up the
        # 2π·f_cfo·Ts inter-symbol jump (the upstream's restart-at-zero
        # rotator is fine only for its carrier-differential display)
        if self.offset != 0.0:
            base = pos if pos is not None else 0
            s = s * np.exp(1j * self.offset * (base + np.arange(TU)))
        level = float(np.sum(np.abs(s)))
        if self.avg_lvl == 0.0:
            self.avg_lvl = level               # cold start
        if level < self.avg_lvl * 0.5:
            self.sym = 1                       # null symbol detected
            self.frames_seen += 1
            self.avg_lvl = (self.agc_rate * level
                            + (1 - self.agc_rate) * self.avg_lvl)
            return
        self.avg_lvl = (self.agc_rate * level
                        + (1 - self.agc_rate) * self.avg_lvl)
        if self.sym == 1:
            # phase reference symbol: carrier-differential constellation
            F = self._fft_comp(s)
            self.ffts = [F]
            self._emit_constellation(F)
            # CFO from the conjugate-reference correlation peak
            corr = np.fft.fft(s * self.conj_ref)
            amps = np.abs(corr)
            peak = int(np.argmax(amps))
            pl = amps[(peak - 1) % TU]
            pr = amps[(peak + 1) % TU]
            off_int = float(peak if peak < TU // 2 else peak - TU)
            off = np.pi * (off_int + (pr - pl) / (pr + pl)) / (TU / 2)
            self.offset -= 0.1 * off
            self.last_cfo_hz = self.offset * DAB_SR / (2 * np.pi)
        elif self.sym > 1:
            F = self._fft_comp(s)
            self.ffts.append(F)
            self._emit_constellation(F)
        self.sym += 1

    def _fft_comp(self, s: np.ndarray) -> np.ndarray:
        F = np.fft.fft(s)
        if self._delta:
            k = ((np.arange(TU) + TU // 2) % TU) - TU // 2
            F = F * np.exp(-2j * np.pi * k * self._delta / TU)
        return F

    def demap_time_differential(self) -> List[np.ndarray]:
        """Per-carrier DQPSK dibits between consecutive symbols (the
        actual DAB modulation; upstream stops at the display)."""
        ks = np.array([k for k in range(-768, 769) if k != 0])
        out = []
        for a, b in zip(self.ffts[:-1], self.ffts[1:]):
            d = b[ks % TU] * np.conj(a[ks % TU])
            ph = np.angle(d) - np.pi / 4
            out.append((np.round(ph / (np.pi / 2)) % 4).astype(np.int32))
        return out

    def _emit_constellation(self, F: np.ndarray):
        """π/4-rotated k vs k−1 bin differential (dab_dsp.h:219-229)."""
        ks = np.array([k for k in range(-767, 768) if k != 0])
        cid1 = ks % TU
        cid0 = (ks - 1) % TU
        pi4 = np.exp(0.25j * np.pi)
        d = pi4 * F[cid1] * np.conj(F[cid0]) \
            / np.maximum(np.abs(F[cid0]) ** 2, 1e-12)
        self.constellations.append(d.astype(np.complex64))


def symbol_dqpsk_dibits(const: np.ndarray) -> np.ndarray:
    """Constellation points → dibits on the ±45°/±135° grid."""
    ph = np.angle(const)
    return (np.floor(ph / (np.pi / 2)) % 4).astype(np.int32)


# ----------------------------------------------------------------------
# Synthetic DAB frame generator (tests)

def build_symbol(Z: np.ndarray) -> np.ndarray:
    td = np.fft.ifft(Z)
    return np.concatenate([td[-CP:], td])        # cyclic prefix + body


def build_frame(n_data: int, rng) -> tuple:
    """→ (iq, list of per-symbol carrier phase indices) — null + phase
    ref + n_data DQPSK data symbols."""
    ks = np.array([k for k in range(-768, 769) if k != 0])
    null = np.zeros(TS, complex)
    ref_Z = phase_reference_freq()
    syms = [null, build_symbol(ref_Z)]
    prev_phase = {int(k): np.angle(ref_Z[k % TU]) for k in ks}
    dibits = []
    for _ in range(n_data):
        Z = np.zeros(TU, complex)
        d = rng.integers(0, 4, len(ks))
        for k, db in zip(ks, d):
            ph = prev_phase[int(k)] + np.pi / 2 * db + np.pi / 4
            Z[k % TU] = np.exp(1j * ph)
            prev_phase[int(k)] = ph
        syms.append(build_symbol(Z))
        dibits.append(d)
    return np.concatenate(syms), dibits
