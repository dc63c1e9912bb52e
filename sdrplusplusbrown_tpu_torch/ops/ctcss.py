"""CTCSS tone and DCS code detectors (subaudible squelch signalling;
counterpart of sdrplusplusbrown_tpu/ops/ctcss.py).

reference behavior: decoder_modules/ch_extravhf_decoder/src/dsp/ctcss.h
(per-tone Goertzel energies over the standard EIA tone set with a
detect/compare threshold) and dcs.h (slice the subaudible band at
134.366 bps, match the repeating 23-bit Golay(23,12) words of the
standard code set).

The Goertzel bank is one matmul, ``x @ basis`` of each 4 096-sample audio
block against a [4 096, 2F] cos/sin basis held on the detector's device
(CUDA unless the caller asks for the CPU), float32 with TF32 off
(PyTorch's default for matmul).  The blocks a push completes go through
in one matmul, and their powers cross to the host in one copy; the EMA
and the decision are host float64, as in the JAX package.  ``stage`` and
``take`` split a push in two, so that a caller can fold the powers into a
copy of its own.  The DCS detector is host numpy, as in the JAX package
(134 bps is control-plane scale).

Frequencies/codes are the standard EIA/TIA values (category-b protocol
constants).  The DCS detector accepts both normal and inverted polarity
like the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..runtime.block import entry_device

#: standard EIA CTCSS tone set (Hz), reference ctcss.h tone table
CTCSS_TONES = np.array([
    67.0, 69.3, 71.9, 74.4, 77.0, 79.7, 82.5, 85.4, 88.5, 91.5,
    94.8, 97.4, 100.0, 103.5, 107.2, 110.9, 114.8, 118.8, 123.0,
    127.3, 131.8, 136.5, 141.3, 146.2, 151.4, 156.7, 159.8, 162.2,
    165.5, 167.9, 171.3, 173.8, 177.3, 179.9, 183.5, 186.2, 189.9,
    192.8, 196.6, 199.5, 203.5, 206.5, 210.7, 218.1, 225.7, 229.1,
    233.6, 241.8, 250.3, 254.1], np.float64)

#: standard DCS codes (octal, "DPL" set), reference dcs.h code table
DCS_CODES = [
    0o023, 0o025, 0o026, 0o031, 0o032, 0o036, 0o043, 0o047, 0o051,
    0o053, 0o054, 0o065, 0o071, 0o072, 0o073, 0o074, 0o114, 0o115,
    0o116, 0o122, 0o125, 0o131, 0o132, 0o134, 0o143, 0o145, 0o152,
    0o155, 0o156, 0o162, 0o165, 0o172, 0o174, 0o205, 0o212, 0o223,
    0o225, 0o226, 0o243, 0o244, 0o245, 0o246, 0o251, 0o252, 0o255,
    0o261, 0o263, 0o265, 0o266, 0o271, 0o274, 0o306, 0o311, 0o315,
    0o325, 0o331, 0o332, 0o343, 0o346, 0o351, 0o356, 0o364, 0o365,
    0o371, 0o411, 0o412, 0o413, 0o423, 0o431, 0o432, 0o445, 0o446,
    0o452, 0o454, 0o455, 0o462, 0o464, 0o465, 0o466, 0o503, 0o506,
    0o516, 0o523, 0o526, 0o532, 0o546, 0o565, 0o606, 0o612, 0o624,
    0o627, 0o631, 0o632, 0o654, 0o662, 0o664, 0o703, 0o712, 0o723,
    0o731, 0o732, 0o734, 0o743, 0o754,
]

DCS_BITRATE = 134.366


def goertzel_bank(x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """x [B, T] float32, basis [T, 2F] → per-tone power [B, F] (one
    matmul)."""
    proj = x @ basis
    f = basis.shape[1] // 2
    c, s = proj[:, :f], proj[:, f:]
    return (c * c + s * s) / float(np.float32(x.shape[1]) ** 2)


class CTCSSDetector:
    """Streaming CTCSS detector: block-accumulated Goertzel-bank powers
    with an EMA, detect = strongest tone dominating the rest."""

    def __init__(self, samplerate: float, block_len: int = 4096,
                 dominance: float = 6.0, abs_floor: float = 1e-7,
                 ema: float = 0.4, device="cuda"):
        self.sr = float(samplerate)
        self.block_len = int(block_len)
        self.dominance = float(dominance)
        self.abs_floor = float(abs_floor)
        self.ema = float(ema)
        self.device = entry_device(device)
        t = np.arange(self.block_len) / self.sr
        w = 2 * np.pi * CTCSS_TONES[None, :] * t[:, None]
        self._basis = torch.from_numpy(
            np.concatenate([np.cos(w), np.sin(w)], axis=1)
            .astype(np.float32)).to(self.device)
        self._buf = torch.zeros(0, dtype=torch.float32, device=self.device)
        self.powers = np.zeros(len(CTCSS_TONES), np.float64)
        self.detected: Optional[float] = None
        self.ratio_db = 0.0

    def stage(self, audio) -> torch.Tensor:
        """Buffer ``audio`` (a host array or a tensor) on the device and
        return the powers [B, F] of the B blocks it completes, still on
        the device (B may be 0); ``take`` consumes them."""
        a = torch.as_tensor(audio).to(self.device, torch.float32) \
            .reshape(-1)
        buf = torch.cat([self._buf, a])
        nb = buf.shape[0] // self.block_len
        used = nb * self.block_len
        self._buf = buf[used:]
        return goertzel_bank(buf[:used].reshape(nb, self.block_len),
                             self._basis)

    def take(self, powers: np.ndarray):
        """The EMA and the decision over each block's powers, in order."""
        for p in np.asarray(powers).reshape(-1, len(CTCSS_TONES)):
            self.powers = (1 - self.ema) * self.powers + self.ema * p
            self._decide()
        return self.detected

    def push(self, audio):
        p = self.stage(audio)
        if p.shape[0]:
            self.take(p.cpu().numpy())
        return self.detected

    def _decide(self):
        i = int(np.argmax(self.powers))
        best = self.powers[i]
        rest = np.delete(self.powers, i)
        med = float(np.median(rest)) + 1e-30
        self.ratio_db = 10.0 * np.log10(best / med + 1e-30)
        if best > self.abs_floor and self.ratio_db > self.dominance:
            self.detected = float(CTCSS_TONES[i])
        else:
            self.detected = None

    def summary(self) -> dict:
        return {"tone": self.detected,
                "ratio_db": round(self.ratio_db, 1)}


def _golay23_parity(data12: int) -> int:
    """Golay(23,12) check bits: remainder of data12 · x^11 divided by
    the generator 0xC75 (x^11+x^10+x^6+x^5+x^4+x^2+1)."""
    reg = data12 << 11
    for i in range(22, 10, -1):
        if reg & (1 << i):
            reg ^= 0xC75 << (i - 11)
    return reg & 0x7FF


def dcs_codeword(code: int) -> int:
    """23-bit DCS word for a 9-bit octal code: bits 0-8 code (LSB
    first on air), bits 9-11 = 0b100 marker, bits 12-22 Golay parity."""
    data12 = (0b100 << 9) | (code & 0x1FF)
    return (_golay23_parity(data12) << 12) | data12


_DCS_WORDS: Optional[np.ndarray] = None
_DCS_ROTS: Optional[np.ndarray] = None


def _dcs_table() -> np.ndarray:
    """[n_codes, 23] bit patterns in transmit (LSB-first) order."""
    global _DCS_WORDS
    if _DCS_WORDS is None:
        t = np.zeros((len(DCS_CODES), 23), np.uint8)
        for i, c in enumerate(DCS_CODES):
            w = dcs_codeword(c)
            t[i] = [(w >> b) & 1 for b in range(23)]
        _DCS_WORDS = t
    return _DCS_WORDS


def _dcs_rotations() -> np.ndarray:
    """[23, n_codes, 23]: every cyclic rotation of every codeword,
    precomputed once so a detect pass is a single vectorized compare."""
    global _DCS_ROTS
    if _DCS_ROTS is None:
        tab = _dcs_table()
        _DCS_ROTS = np.stack([np.roll(tab, r, axis=1)
                              for r in range(23)])
    return _DCS_ROTS


class DCSDetector:
    """Streaming DCS decoder: subaudible low-pass → decimate to
    8x the 134.366 bps bit rate → sign-slice → cyclic-correlate the
    23-bit frame against the standard code table (both polarities)."""

    def __init__(self, samplerate: float, min_frames: float = 2.0,
                 max_ber: float = 0.05):
        self.sr = float(samplerate)
        self.os = 8                              # samples per bit
        self.min_bits = int(23 * min_frames)
        self.max_ber = float(max_ber)
        # a windowed-sinc LPF at 250 Hz (keeps the 134 bps fundamental
        # and harmonics, kills voice)
        ntaps = 255
        fc = 250.0 / self.sr
        n = np.arange(ntaps) - (ntaps - 1) / 2
        h = 2 * fc * np.sinc(2 * fc * n) * np.hanning(ntaps)
        self._lpf = (h / h.sum()).astype(np.float32)
        self._tail = np.zeros(ntaps - 1, np.float32)
        self._phase = 0.0
        self._step = self.sr / (DCS_BITRATE * self.os)
        self._soft = np.zeros(0, np.float32)
        self._since_decide = 0
        self.detected: Optional[int] = None
        self.inverted = False
        self.ber = 1.0

    def push(self, audio: np.ndarray):
        x = np.concatenate([self._tail, np.asarray(audio, np.float32)])
        y = np.convolve(x, self._lpf, mode="valid")
        self._tail = x[-(len(self._lpf) - 1):]
        # fractional decimation to os * bitrate
        idx = []
        p = self._phase
        while p < len(y):
            idx.append(int(p))
            p += self._step
        self._phase = p - len(y)
        if idx:
            self._soft = np.concatenate([self._soft, y[np.asarray(idx)]])
            self._since_decide += len(idx)
        # keep a few frames of history
        keep = self.os * 23 * 8
        if len(self._soft) > keep:
            self._soft = self._soft[-keep:]
        # decide at most once per received frame's worth of bits
        if self._since_decide >= self.os * 23:
            self._since_decide = 0
            self._decide()
        return self.detected

    def _decide(self):
        s = self._soft
        if len(s) < self.os * self.min_bits:
            return
        # remove DC (frequency offset) then slice at bit centers: pick
        # the sampling phase with the largest mean |soft|
        s = s - np.median(s)
        if np.mean(np.abs(s)) < 1e-6:
            self.detected = None
            return
        nbits = len(s) // self.os
        mat = s[:nbits * self.os].reshape(nbits, self.os)
        phase = int(np.argmax(np.abs(mat).mean(axis=0)))
        bits = (mat[:, phase] > 0).astype(np.uint8)
        best = (None, False, 1.0)
        n_use = (nbits // 23) * 23
        if n_use < self.min_bits:
            return
        frames = bits[:n_use].reshape(-1, 23)
        rots = _dcs_rotations()                      # [23, C, 23]
        d = (frames[None, None, :, :] ^ rots[:, :, None, :]
             ).mean(axis=(2, 3))                     # [23, C]
        # polarity preference: inverted codes alias to other normal
        # codes (inverted 023 ≡ 047: the code set is rotation-unique but
        # not inversion-unique), so like real DCS squelches the normal
        # polarity's reading is reported when one fits
        for pol, dd in ((False, d), (True, 1.0 - d)):
            r, i = np.unravel_index(int(np.argmin(dd)), dd.shape)
            if dd[r, i] < best[2]:
                best = (DCS_CODES[i], pol, float(dd[r, i]))
            if best[2] <= self.max_ber:
                break
        self.ber = best[2]
        if best[2] <= self.max_ber:
            self.detected, self.inverted = best[0], best[1]
        else:
            self.detected = None

    def summary(self) -> dict:
        return {"code": (None if self.detected is None
                         else f"{self.detected:03o}"),
                "inverted": self.inverted,
                "ber": round(self.ber, 3)}
