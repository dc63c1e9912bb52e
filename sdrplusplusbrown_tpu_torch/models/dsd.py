"""DSD-style digital-voice frame sync (DMR / P25 / X2-TDMA / D-STAR /
NXDN / ProVoice) on the 4FSK dibit stream (counterpart of
sdrplusplusbrown_tpu/models/dsd.py).

reference behavior: decoder_modules/ch_extravhf_decoder/src/dsp/
dsd_demod.cpp:136 (``findFrameSync``) with the sync pattern set from
dsd.h:206-226 — every incoming dibit is reduced to its SIGN character
('1' for the positive-deviation dibits, '3' for negative), appended to
a rolling window, and the last characters are string-compared against
the known sync words; a hit latches the frame state (DATA vs VOICE, and
the protocol family) that the burst processors then consume.

The exact match over every position is a ±1 correlation of the sign
stream against all templates at once: one ``conv1d`` [1, 1, N] ×
[P, 1, 32] on the search's device (CUDA unless the caller asks for the
CPU), match ⟺ corr == pattern length.  The sums are small integers, so
they are exact in float32 (TF32 too: ±1 and 0 are exact in its 10-bit
mantissa).  The block's match matrix crosses to the host in one copy.
Streaming calls carry the last 31 signs so syncs straddling block
boundaries are found exactly once.

The pattern set is the reference's (ETSI TS 102 361-1 §9.1.1 DMR sync
words, TIA-102.BAAA P25 frame sync, expressed as dibit signs).
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.block import entry_device

#: sync id → (name, pattern of '1'/'3' chars, is_voice).  The full DSD
#: family (reference dsd.h:633-668): DMR, P25, X2-TDMA, D-STAR, NXDN
#: (18-symbol) and ProVoice (32-symbol) — variable-length templates.
SYNC_PATTERNS = [
    ("DMR_BS_DATA", "313333111331131131331131", False),
    ("DMR_BS_VOICE", "131111333113313313113313", True),
    ("DMR_MS_DATA", "311131133313133331131113", False),
    ("DMR_MS_VOICE", "133313311131311113313331", True),
    ("DMR_DM_TS1_DATA", "331333313111313133311111", False),
    ("DMR_DM_TS1_VOICE", "113111131333131311133333", True),
    ("DMR_DM_TS2_DATA", "311311111333113333133311", False),
    ("DMR_DM_TS2_VOICE", "133133333111331111311133", True),
    ("P25P1", "111113113311333313133333", False),
    ("P25P1_INV", "333331331133111131311111", False),
    ("X2TDMA_BS_VOICE", "113131333331313331113311", True),
    ("X2TDMA_BS_DATA", "331313111113131113331133", False),
    ("X2TDMA_MS_DATA", "313113333111111133333313", False),
    ("X2TDMA_MS_VOICE", "131331111333333311111131", True),
    ("DSTAR_HD", "131313131333133113131111", False),
    ("DSTAR_HD_INV", "313131313111311331313333", False),
    ("DSTAR_SYNC", "313131313133131113313111", True),
    ("DSTAR_SYNC_INV", "131313131311313331131333", True),
    ("NXDN_MS_DATA", "313133113131111333", False),
    ("NXDN_MS_DATA_INV", "131311331313333111", False),
    ("NXDN_MS_VOICE", "313133113131113133", True),
    ("NXDN_MS_VOICE_INV", "131311331313331311", True),
    ("NXDN_BS_DATA", "313133113131111313", False),
    ("NXDN_BS_DATA_INV", "131311331313333131", False),
    ("NXDN_BS_VOICE", "313133113131113113", True),
    ("NXDN_BS_VOICE_INV", "131311331313331331", True),
    ("PROVOICE", "13131333111311311133113311331133", True),
    ("PROVOICE_INV", "31313111333133133311331133113311", True),
    ("PROVOICE_EA", "31131311331331111133131311311133", True),
    ("PROVOICE_EA_INV", "13313133113113333311313133133311", True),
]

#: DMR/P25/X2TDMA/D-STAR sync length (NXDN is 18, ProVoice 32)
SYNC_LEN = 24
MAX_SYNC_LEN = max(len(p) for _, p, _ in SYNC_PATTERNS)


def _templates() -> np.ndarray:
    """LEFT-zero-padded ±1 templates, all ending at the same position
    (sync-end alignment — matches the reference's rolling-window
    end-compare).  A padded position contributes 0 to the correlation,
    so an exact match ⟺ corr == pattern length."""
    t = np.zeros((len(SYNC_PATTERNS), MAX_SYNC_LEN), np.float32)
    for p, (_, pat, _) in enumerate(SYNC_PATTERNS):
        t[p, MAX_SYNC_LEN - len(pat):] = \
            [1.0 if ch == "1" else -1.0 for ch in pat]
    return t


def _lengths() -> np.ndarray:
    return np.array([len(p) for _, p, _ in SYNC_PATTERNS], np.float32)


def sync_correlate(signs: torch.Tensor, templates: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """signs [N] ∈ {+1, −1, 0} float32 → match matrix [P, N−maxlen+1]
    bool (exact pattern agreement at each END position, like the
    reference's strcmp of the rolling window).  ``conv1d`` is a
    correlation (no kernel flip), as XLA's convolution is."""
    corr = torch.nn.functional.conv1d(signs[None, None, :],
                                      templates[:, None, :])[0]
    return corr >= lengths[:, None] - 0.5


class DSDFrameSync:
    """Streaming frame-sync search over dibit blocks.

    ``push(dibits)`` consumes int dibits (FourFSKDemod convention:
    {2,3} = positive deviation → '1', {0,1} → '3'; the reference's
    slicer emits {0b00,0b01} for positive, dsd_demod.cpp:143) and
    returns a list of (global_symbol_index, sync_name, is_voice).
    Per-pattern hit counters accumulate in ``counts``.  The correlation
    runs on ``device`` (CUDA unless the caller asks for the CPU).
    """

    def __init__(self, device="cuda"):
        self.device = entry_device(device)
        self._templates = torch.from_numpy(_templates()).to(self.device)
        self._lengths = torch.from_numpy(_lengths()).to(self.device)
        self._carry = np.zeros((0,), np.float32)
        self._pos = 0                       # global index of carry[0]
        self.counts = {name: 0 for name, _, _ in SYNC_PATTERNS}
        self.last_sync = None               # (index, name, is_voice)

    def push(self, dibits: np.ndarray):
        db = np.asarray(dibits)
        if db.size == 0:
            return []
        # sign-correlate, but only OUTER (±3) symbols count: every DSD
        # sync word uses outer symbols exclusively, and the magnitude
        # gate mirrors the reference's lmin/lmax level validation
        # (dsd.h framesynclbuf) — without it an 18-symbol NXDN pattern
        # false-fires about once per minute on DMR payload bits
        signs = np.where(db >= 2, 1.0, -1.0).astype(np.float32)
        signs *= ((db == 0) | (db == 3)).astype(np.float32)
        buf = np.concatenate([self._carry, signs])
        hits = []
        if len(buf) >= MAX_SYNC_LEN:
            m = sync_correlate(torch.from_numpy(buf).to(self.device),
                               self._templates, self._lengths).cpu().numpy()
            ps, js = np.nonzero(m)
            order = np.argsort(js, kind="stable")
            for p, j in zip(ps[order], js[order]):
                name, _, voice = SYNC_PATTERNS[p]
                # j indexes the window END at j + MAX_SYNC_LEN - 1; each
                # global end position is scanned exactly once (the carry
                # keeps MAX_SYNC_LEN-1 signs, and scanning starts at the
                # first end position past it), so no duplicate hits
                idx = self._pos + int(j) + MAX_SYNC_LEN - 1
                self.counts[name] += 1
                self.last_sync = (idx, name, voice)
                hits.append((idx, name, voice))
        keep = min(MAX_SYNC_LEN - 1, len(buf))
        self._pos += len(buf) - keep
        self._carry = buf[len(buf) - keep:]
        return hits

    # -- summaries (status surface) ------------------------------------
    def summary(self) -> dict:
        total = sum(self.counts.values())
        fam = {}
        for k, v in self.counts.items():
            f = k.split("_")[0]
            fam[f] = fam.get(f, 0) + v
        dmr = fam.get("DMR", 0)
        voice = sum(self.counts[k] for k, _, v in SYNC_PATTERNS if v)
        return {
            "totalSyncs": total,
            "dmrSyncs": dmr,
            "p25Syncs": fam.get("P25P1", 0),
            "familySyncs": fam,
            "voiceSyncs": voice,
            "dataSyncs": total - voice,
            "counts": dict(self.counts),
            "lastSync": (None if self.last_sync is None else {
                "index": self.last_sync[0],
                "type": self.last_sync[1],
                "voice": bool(self.last_sync[2]),
            }),
        }
