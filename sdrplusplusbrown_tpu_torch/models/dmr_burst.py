"""DMR burst-layer processing past frame sync: CACH/TACT, slot type,
voice-superframe tracking and embedded-LC assembly (counterpart of
sdrplusplusbrown_tpu/models/dmr_burst.py; host numpy past the frame
sync, whose correlation runs on the processor's device).

reference behavior: decoder_modules/ch_extravhf_decoder/src/dsp/
dsd_dmr.cpp:15-371 — after ``findFrameSync`` the reference extracts the
CACH slot bit, reads the slot-type colour code + burst type RAW (its
CACH decode is a TODO and it applies no FEC), and tracks the 6-burst
voice superframe to feed AMBE frames to the vendored MBE vocoder.  This
implementation goes deeper than the reference on the signalling side
(full TACT/CACH decode, Golay-checked slot type, embedded-LC assembly
with Hamming(16,11,4) + 5-bit checksum — all of which the reference
skips) while leaving the vendored AMBE vocoder out of scope.

One place differs from the JAX package, a fault fixed here: the full
LC's RS(12,9) parity (``rs_12_9_parity``) is the remainder modulo
g(x) = (x+α)(x+α²)(x+α³) = x³ + 14x² + 56x + 64, MMDVM's RS129 update;
the JAX package applies the taps in reversed order (data 1..9 gives
[46, 231, 230] there, [188, 112, 31] here), so a standard voice-LC
header or terminator passes ``decode_full_lc`` only here.

On-air validation: the embedded-LC path decodes 13/13 voice superframes
checksum-clean on the golden ``dmr_sample.wav`` capture (group call,
FLCO 0, dst 16777215, src 150587), which pins the Hamming(16,11,4)
parity equations, the stride-16 mod-127 fragment interleave, the LC/
checksum bit layout and the dibit→on-air bit mapping.  The slot-type
Golay(20,8) and CACH codes are loopback-gated (the golden capture is
direct-mode voice and carries neither) with a computed-dmin sanity
check in the tests.

Dibit convention: the 4FSK demod emits OUR dibits {3:+3, 2:+1, 1:−1,
0:−3}; on-air ETSI TS 102 361-1 §10.2 maps +3→01, +1→00, −1→10,
−3→11, hence the translation LUT below.  All protocol constants here
are ETSI TS 102 361-1 values (category-b unavoidable data).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .dsd import DSDFrameSync, SYNC_LEN

#: our demod dibit -> on-air ETSI dibit (bit1=sign, bit0=magnitude)
OUR_TO_AIR = np.array([3, 2, 0, 1], np.uint8)

#: dibits per two-slot TDMA frame: same-slot bursts repeat every 288
DIBITS_PER_FRAME = 288
#: voice superframe = 6 same-slot bursts (A..F)
SUPERFRAME_BURSTS = 6

BURST_TYPE_NAMES = {
    0: "PI Header", 1: "VOICE Header", 2: "TLC", 3: "CSBK",
    4: "MBC Header", 5: "MBC", 6: "DATA Header", 7: "RATE 1/2 DATA",
    8: "RATE 3/4 DATA", 9: "Idle", 10: "RATE 1 DATA",
}

FLCO_NAMES = {0: "Group Voice", 3: "Unit to Unit"}


def bits_of_air(dibits: np.ndarray) -> np.ndarray:
    """On-air dibits -> bit array (bit1 first, per ETSI transmit order)."""
    out = np.empty(2 * len(dibits), np.uint8)
    out[0::2] = (dibits >> 1) & 1
    out[1::2] = dibits & 1
    return out


# ---------------------------------------------------------------------------
# FEC primitives (ETSI TS 102 361-1 Annex B)
# ---------------------------------------------------------------------------

def hamming_16_11_4_encode(d: np.ndarray) -> np.ndarray:
    """Hamming(16,11,4) row code of the embedded-LC matrix (B.3.2).

    Parity equations validated ON-AIR: with them the golden capture's
    embedded LC checksums verify 13/13 (see module docstring)."""
    c0 = d[0] ^ d[1] ^ d[2] ^ d[3] ^ d[5] ^ d[7] ^ d[8]
    c1 = d[1] ^ d[2] ^ d[3] ^ d[4] ^ d[6] ^ d[8] ^ d[9]
    c2 = d[2] ^ d[3] ^ d[4] ^ d[5] ^ d[7] ^ d[9] ^ d[10]
    c3 = d[0] ^ d[1] ^ d[2] ^ d[4] ^ d[6] ^ d[7] ^ d[10]
    c4 = d[0] ^ d[2] ^ d[5] ^ d[6] ^ d[8] ^ d[9] ^ d[10]
    return np.concatenate([d, np.array([c0, c1, c2, c3, c4], np.uint8)])


_H16114_SYN: Dict[tuple, int] = {}


def _h16114_syndrome(row: np.ndarray) -> tuple:
    enc = hamming_16_11_4_encode(row[:11])
    return tuple((enc[11:] ^ row[11:]).tolist())


def _h16114_table() -> Dict[tuple, int]:
    if not _H16114_SYN:
        for e in range(16):
            r = np.zeros(16, np.uint8)
            r[e] = 1
            _H16114_SYN[_h16114_syndrome(r)] = e
    return _H16114_SYN


def hamming_16_11_4_correct(row: np.ndarray):
    """-> (corrected_row, n_corrected) with n=-1 for uncorrectable
    (detected double error — d=4)."""
    s = _h16114_syndrome(row)
    if not any(s):
        return row, 0
    e = _h16114_table().get(s)
    if e is None:
        return row, -1
    r = row.copy()
    r[e] ^= 1
    return r, 1


def _cyclic_parity(data_bits: np.ndarray, genpoly: int, ncheck: int
                   ) -> np.ndarray:
    """Systematic cyclic-code parity: remainder of d(x)·x^ncheck / g(x)."""
    reg = 0
    top = 1 << ncheck
    for b in data_bits:
        reg = (reg << 1) | int(b)
        if reg & top:
            reg ^= genpoly
    # flush ncheck zero bits
    for _ in range(ncheck):
        reg <<= 1
        if reg & top:
            reg ^= genpoly
    return np.array([(reg >> (ncheck - 1 - i)) & 1
                     for i in range(ncheck)], np.uint8)


def golay_20_8_encode(d8: np.ndarray) -> np.ndarray:
    """DMR slot-type Golay(20,8) (B.3.1): 8 data + 12 parity, built
    from the degree-12 generator x^12+x^11+x^10+x^9+x^8+x^5+x^2+1 =
    (x+1)·g23(x) — i.e. the extended Golay(24,12,8) shortened by 4 data
    bits (measured dmin 8; corrects ≤3 errors).  On-air validation is
    pending a data-burst capture (the golden capture is voice-only);
    note the reference applies NO FEC here at all."""
    return np.concatenate([
        d8.astype(np.uint8),
        _cyclic_parity(d8, 0b1111100100101, 12)])


_G208_TABLE: Optional[np.ndarray] = None


def _golay_20_8_table() -> np.ndarray:
    global _G208_TABLE
    if _G208_TABLE is None:
        t = np.zeros((256, 20), np.uint8)
        for v in range(256):
            d = np.array([(v >> (7 - i)) & 1 for i in range(8)], np.uint8)
            t[v] = golay_20_8_encode(d)
        _G208_TABLE = t
    return _G208_TABLE


def golay_20_8_decode(bits20: np.ndarray):
    """ML decode -> (value8, hamming_distance); correct for <= 3 errors."""
    t = _golay_20_8_table()
    dist = np.count_nonzero(t != bits20[None, :], axis=1)
    v = int(np.argmin(dist))
    return v, int(dist[v])


def hamming_7_4_encode(d4: np.ndarray) -> np.ndarray:
    """TACT Hamming(7,4,3) (B.3.3), g(x)=x^3+x+1 systematic."""
    return np.concatenate([d4.astype(np.uint8),
                           _cyclic_parity(d4, 0b1011, 3)])


_H74_TABLE: Optional[np.ndarray] = None


def hamming_7_4_decode(bits7: np.ndarray):
    global _H74_TABLE
    if _H74_TABLE is None:
        _H74_TABLE = np.zeros((16, 7), np.uint8)
        for v in range(16):
            d = np.array([(v >> (3 - i)) & 1 for i in range(4)], np.uint8)
            _H74_TABLE[v] = hamming_7_4_encode(d)
    dist = np.count_nonzero(_H74_TABLE != bits7[None, :], axis=1)
    v = int(np.argmin(dist))
    return v, int(dist[v])


def hamming_17_12_3_encode(d12: np.ndarray) -> np.ndarray:
    """Short-LC row Hamming(17,12,3) (B.3.4): shortened (31,26) Hamming
    with the primitive g(x)=x^5+x^2+1 (x^5+x^4+x^2+1 is divisible by
    x+1 and gives an ambiguous syndrome map)."""
    return np.concatenate([d12.astype(np.uint8),
                           _cyclic_parity(d12, 0b100101, 5)])


def hamming_17_12_3_correct(row: np.ndarray):
    syn_tab = {}
    for e in range(17):
        r = np.zeros(17, np.uint8)
        r[e] = 1
        enc = hamming_17_12_3_encode(r[:12])
        syn_tab[tuple((enc[12:] ^ r[12:]).tolist())] = e
    enc = hamming_17_12_3_encode(row[:12])
    s = tuple((enc[12:] ^ row[12:]).tolist())
    if not any(s):
        return row, 0
    e = syn_tab.get(s)
    if e is None:
        return row, -1
    r = row.copy()
    r[e] ^= 1
    return r, 1


def lc_checksum5(lc_bytes: np.ndarray) -> int:
    """Full-LC 5-bit checksum: sum of the nine octets mod 31 (B.3.11).
    On-air validated (13/13 on the golden capture)."""
    return int(lc_bytes.astype(np.int64).sum() % 31)


def crc8(bits: np.ndarray, poly: int = 0x107) -> int:
    """CRC-8 over a bit array (short LC, ETSI B.3.9 polynomial
    x^8+x^2+x+1)."""
    reg = 0
    for b in bits:
        reg = (reg << 1) | int(b)
        if reg & 0x100:
            reg ^= poly
    for _ in range(8):
        reg <<= 1
        if reg & 0x100:
            reg ^= poly
    return reg & 0xFF


# ---------------------------------------------------------------------------
# Field codecs
# ---------------------------------------------------------------------------

#: TACT bit positions inside the 24-bit CACH (ETSI §9.3.5 interleave);
#: the other 17 positions carry the short-LC payload fragment
TACT_POS = np.array([0, 4, 8, 12, 14, 18, 22])
CACH_PAYLOAD_POS = np.array([i for i in range(24)
                             if i not in set(TACT_POS.tolist())])


def decode_cach(bits24: np.ndarray) -> dict:
    """CACH -> TACT fields + payload fragment.  The reference reads only
    the slot bit (dsd_dmr.cpp:19-21, 'TODO: use CACH')."""
    tact = bits24[TACT_POS]
    v, dist = hamming_7_4_decode(tact)
    at, tc = (v >> 3) & 1, (v >> 2) & 1
    lcss = v & 3
    return {"at": at, "tc": tc, "lcss": lcss, "tact_errs": dist,
            "payload": bits24[CACH_PAYLOAD_POS]}


def decode_slot_type(bits20: np.ndarray) -> dict:
    """Slot type (CC 4 + DataType 4 + Golay(20,8) parity 12).  The
    reference reads CC/type raw with no FEC (dsd_dmr.cpp:24-45)."""
    v, dist = golay_20_8_decode(bits20)
    return {"cc": (v >> 4) & 0xF, "data_type": v & 0xF,
            "errs": dist, "ok": dist <= 3,
            "type_name": BURST_TYPE_NAMES.get(v & 0xF, "UNK")}


def decode_emb(bits16: np.ndarray) -> dict:
    """EMB (CC 4, PI 1, LCSS 2 + QR(16,7,6) parity 9) — fields read raw
    and majority-voted across the superframe by the caller."""
    cc = int("".join(map(str, bits16[:4])), 2)
    return {"cc": cc, "pi": int(bits16[4]),
            "lcss": int("".join(map(str, bits16[5:7])), 2)}


def decode_embedded_lc(frag128: np.ndarray) -> Optional[dict]:
    """4x32-bit fragments (bursts B..E) -> full LC, or None.

    Deinterleave stride 16 mod 127 -> 8x16 matrix; rows 0-6
    Hamming(16,11,4), row 7 column parity; LC = rows0-1 bits0-10 +
    rows2-6 bits0-9; checksum bits = rows2-6 bit10 (MSB first);
    verify sum(9 octets) % 31."""
    data = np.zeros(128, np.uint8)
    b = 0
    for a in range(128):
        data[b] = frag128[a]
        b += 16
        if b > 127:
            b -= 127
    rows = data.reshape(8, 16)
    fixed: List[np.ndarray] = []
    for r in range(7):
        row, n = hamming_16_11_4_correct(rows[r].astype(np.uint8))
        if n < 0:
            return None
        fixed.append(row)
    lc_bits = np.concatenate([fixed[0][:11], fixed[1][:11]]
                             + [fixed[r][:10] for r in range(2, 7)])
    got = 0
    for r in range(2, 7):
        got = (got << 1) | int(fixed[r][10])
    lc = np.packbits(lc_bits)
    if lc_checksum5(lc) != got:
        return None
    return _parse_lc_octets(lc[:9])


def decode_short_lc(bits68: np.ndarray) -> Optional[dict]:
    """4x17-bit CACH payload fragments -> short LC, or None.

    Deinterleave stride 17 mod 67 -> 4x17 matrix; rows 0-2
    Hamming(17,12,3), row 3 column parity; 36 data bits =
    28-bit short LC + CRC-8."""
    data = np.zeros(68, np.uint8)
    b = 0
    for a in range(68):
        data[b] = bits68[a]
        b += 17
        if b > 67:
            b -= 67
    rows = data.reshape(4, 17)
    fixed = []
    for r in range(3):
        row, n = hamming_17_12_3_correct(rows[r].astype(np.uint8))
        if n < 0:
            return None
        fixed.append(row)
    bits36 = np.concatenate([row[:12] for row in fixed])
    if crc8(bits36[:28]) != int("".join(map(str, bits36[28:36])), 2):
        return None
    opcode = int("".join(map(str, bits36[:4])), 2)
    return {"opcode": opcode,
            "data": int("".join(map(str, bits36[4:28])), 2)}


def encode_embedded_lc(lc9: np.ndarray) -> np.ndarray:
    """9 LC octets -> 128-bit embedded-signalling stream (the 4x32-bit
    fragments of bursts B..E, in transmit order) — exact inverse of
    ``decode_embedded_lc`` (loopback-tested)."""
    lc9 = np.asarray(lc9, np.uint8)
    cs = lc_checksum5(lc9)
    bits72 = np.unpackbits(lc9)
    rows = [hamming_16_11_4_encode(bits72[0:11]),
            hamming_16_11_4_encode(bits72[11:22])]
    for r in range(5):
        d11 = np.concatenate([
            bits72[22 + 10 * r: 32 + 10 * r],
            np.array([(cs >> (4 - r)) & 1], np.uint8)])
        rows.append(hamming_16_11_4_encode(d11))
    rows.append(np.bitwise_xor.reduce(np.stack(rows), axis=0))
    data = np.concatenate(rows)
    raw = np.zeros(128, np.uint8)
    b = 0
    for a in range(128):
        raw[a] = data[b]
        b += 16
        if b > 127:
            b -= 127
    return raw


def encode_short_lc(opcode: int, data24: int) -> np.ndarray:
    """(opcode, 24-bit payload) -> 68-bit CACH payload stream (4x17-bit
    fragments in transmit order) — inverse of ``decode_short_lc``."""
    bits28 = np.array([(opcode >> (3 - i)) & 1 for i in range(4)]
                      + [(data24 >> (23 - i)) & 1 for i in range(24)],
                      np.uint8)
    c = crc8(bits28)
    bits36 = np.concatenate([bits28, np.array(
        [(c >> (7 - i)) & 1 for i in range(8)], np.uint8)])
    rows = [hamming_17_12_3_encode(bits36[12 * r: 12 * r + 12])
            for r in range(3)]
    rows.append(np.bitwise_xor.reduce(np.stack(rows), axis=0))
    data = np.concatenate(rows)
    raw = np.zeros(68, np.uint8)
    b = 0
    for a in range(68):
        raw[a] = data[b]
        b += 17
        if b > 67:
            b -= 67
    return raw


def encode_cach(at: int, tc: int, lcss: int,
                payload17: np.ndarray) -> np.ndarray:
    """TACT fields + 17-bit payload fragment -> 24-bit CACH."""
    v = ((at & 1) << 3) | ((tc & 1) << 2) | (lcss & 3)
    tact = hamming_7_4_encode(np.array(
        [(v >> (3 - i)) & 1 for i in range(4)], np.uint8))
    out = np.zeros(24, np.uint8)
    out[TACT_POS] = tact
    out[CACH_PAYLOAD_POS] = payload17
    return out


def encode_slot_type(cc: int, data_type: int) -> np.ndarray:
    """(colour code, data type) -> 20-bit slot-type field."""
    v = ((cc & 0xF) << 4) | (data_type & 0xF)
    return golay_20_8_encode(np.array(
        [(v >> (7 - i)) & 1 for i in range(8)], np.uint8))


# ---------------------------------------------------------------------------
# Streaming burst processor
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Data-burst payloads: BPTC(196,96) -> full LC (voice header / TLC) and
# CSBK (ETSI TS 102 361-1 B.1.1 / B.2.1 / B.3.6)
#
# BEYOND the reference: dsd_dmr.cpp classifies the slot type and skips
# the 196-bit data payload entirely.  Loopback-gated — the shipped
# golden capture carries only direct-mode voice bursts (census: zero
# DATA syncs), so there is no on-air vector for these paths.
# ---------------------------------------------------------------------------

#: BPTC(196,96) bit interleave: transmitted position of payload bit k
_BPTC_IL = np.array([(181 * k) % 196 for k in range(196)], np.int64)

_H15_POLY, _H13_POLY = 0b10011, 0b11001   # x^4+x+1, x^4+x^3+1


def _hamming_cyclic_correct(row: np.ndarray, poly: int, k: int):
    """(corrected row, n_errors) for a systematic cyclic Hamming row
    (n = k+4); single-error correcting, None on failure."""
    row = np.asarray(row, np.uint8)
    if np.array_equal(_cyclic_parity(row[:k], poly, 4), row[k:]):
        return row, 0
    for i in range(len(row)):
        t = row.copy()
        t[i] ^= 1
        if np.array_equal(_cyclic_parity(t[:k], poly, 4), t[k:]):
            return t, 1
    return None, -1


def bptc_196_96_encode(bits96: np.ndarray) -> np.ndarray:
    """96 info bits -> 196 transmitted bits.  Matrix: bit 0 reserved,
    then 13 rows x 15 cols; rows 0-8 Hamming(15,11,3), each column
    Hamming(13,9,3); data = row0 cols 3-10 + rows 1-8 cols 0-10."""
    bits96 = np.asarray(bits96, np.uint8)
    m = np.zeros((13, 15), np.uint8)
    m[0, 3:11] = bits96[:8]
    m[1:9, :11] = bits96[8:].reshape(8, 11)
    for r in range(9):
        m[r, 11:] = _cyclic_parity(m[r, :11], _H15_POLY, 4)
    for c in range(15):
        m[9:, c] = _cyclic_parity(m[:9, c], _H13_POLY, 4)
    flat = np.concatenate([[0], m.reshape(-1)]).astype(np.uint8)
    tx = np.empty(196, np.uint8)
    tx[_BPTC_IL] = flat
    return tx


def bptc_196_96_decode(bits196: np.ndarray):
    """196 received bits -> (96 info bits, n_corrected) or (None, -1)."""
    flat = np.asarray(bits196, np.uint8)[_BPTC_IL]
    m = flat[1:].reshape(13, 15).copy()
    n_fix = 0
    for c in range(15):                    # column pass first (d=3)
        col, n = _hamming_cyclic_correct(m[:, c], _H13_POLY, 9)
        if col is not None:
            m[:, c] = col
            n_fix += n
    for r in range(9):
        row, n = _hamming_cyclic_correct(m[r], _H15_POLY, 11)
        if row is None:
            return None, -1
        m[r] = row
        n_fix += n
    out = np.concatenate([m[0, 3:11], m[1:9, :11].reshape(-1)])
    return out.astype(np.uint8), n_fix


# RS(12,9) over GF(256), field poly 0x11D, generator (x+a)(x+a^2)(x+a^3)
# — the full-LC parity; masks B.3.11: 0x969696 voice header, 0x999999
# terminator-with-LC
_RS129_MASKS = {1: 0x96, 2: 0x99}


def _gf256_tables():
    exp = np.zeros(510, np.int64)
    log = np.zeros(256, np.int64)
    v = 1
    for i in range(255):
        exp[i] = exp[i + 255] = v
        log[v] = i
        v <<= 1
        if v & 0x100:
            v ^= 0x11D
    return exp, log


_RS_EXP, _RS_LOG = _gf256_tables()


def rs_12_9_parity(data9: np.ndarray) -> np.ndarray:
    """9 octets -> 3 parity octets (polynomial division by g(x))."""
    exp, log = _RS_EXP, _RS_LOG
    # g(x) = (x+a)(x+a^2)(x+a^3)
    g = [1]
    for r in (1, 2, 3):
        a = int(exp[r])
        ng = [0] * (len(g) + 1)
        for i, c in enumerate(g):
            ng[i] ^= (exp[log[c] + r] if c else 0)
            ng[i + 1] ^= c
        g = ng
    # g is in ascending powers (g[0] = 64, g[1] = 56, g[2] = 14); reg[0]
    # holds the highest-order remainder term, so it takes g[2]
    reg = [0, 0, 0]
    for d in np.asarray(data9, np.int64):
        fb = int(d) ^ reg[0]
        reg = reg[1:] + [0]
        if fb:
            for i in range(3):
                reg[i] ^= int(exp[log[g[2 - i]] + log[fb]])
    return np.array(reg, np.uint8)


def encode_full_lc(lc9: np.ndarray, data_type: int) -> np.ndarray:
    """9 LC octets -> 96 BPTC info bits (RS(12,9) parity XOR the
    burst-type CRC mask)."""
    par = rs_12_9_parity(lc9) ^ _RS129_MASKS[data_type]
    return np.unpackbits(np.concatenate([np.asarray(lc9, np.uint8),
                                         par.astype(np.uint8)]))


def decode_full_lc(bits96: np.ndarray, data_type: int):
    """96 BPTC info bits -> LC dict (parity-gated) or None."""
    octets = np.packbits(np.asarray(bits96, np.uint8))
    want = rs_12_9_parity(octets[:9]) ^ _RS129_MASKS[data_type]
    if not np.array_equal(want.astype(np.uint8), octets[9:]):
        return None
    return _parse_lc_octets(octets[:9])


def _parse_lc_octets(lc: np.ndarray) -> dict:
    flco = int(lc[0]) & 0x3F
    return {
        "flco": flco,
        "flco_name": FLCO_NAMES.get(flco, f"FLCO {flco}"),
        "pf": int(lc[0]) >> 7, "fid": int(lc[1]), "svc": int(lc[2]),
        "dst": (int(lc[3]) << 16) | (int(lc[4]) << 8) | int(lc[5]),
        "src": (int(lc[6]) << 16) | (int(lc[7]) << 8) | int(lc[8]),
    }


#: CSBK opcode names (TS 102 361-2 7.1.2 subset)
CSBKO_NAMES = {4: "UU_V_Req", 5: "UU_Ans_Rsp", 38: "NACK_Rsp",
               56: "BS_Dwn_Act", 61: "Preamble"}


def encode_csbk(csbko: int, fid: int, data64: np.ndarray,
                lb: bool = True) -> np.ndarray:
    """-> 96 BPTC info bits (CRC-CCITT XOR the 0xA5A5 CSBK mask)."""
    from .p25 import crc16_ccitt
    bits = np.zeros(96, np.uint8)
    bits[0] = int(lb)
    for b in range(6):
        bits[2 + b] = (csbko >> (5 - b)) & 1
    for b in range(8):
        bits[8 + b] = (fid >> (7 - b)) & 1
    bits[16:80] = np.asarray(data64, np.uint8)
    crc = crc16_ccitt(bits[:80]) ^ 0xA5A5
    for b in range(16):
        bits[80 + b] = (crc >> (15 - b)) & 1
    return bits


def decode_csbk(bits96: np.ndarray):
    from .p25 import crc16_ccitt
    bits = np.asarray(bits96, np.uint8)
    got = 0
    for b in bits[80:96]:
        got = (got << 1) | int(b)
    if (crc16_ccitt(bits[:80]) ^ 0xA5A5) != got:
        return None
    csbko = 0
    for b in bits[2:8]:
        csbko = (csbko << 1) | int(b)
    fid = 0
    for b in bits[8:16]:
        fid = (fid << 1) | int(b)
    out = {"lb": int(bits[0]), "csbko": csbko,
           "csbkoName": CSBKO_NAMES.get(csbko, f"CSBKO {csbko}"),
           "fid": fid}
    a = bits[16:80]
    if csbko in (4, 5, 56):                # dst/src address pair
        dst = src = 0
        for b in a[16:40]:
            dst = (dst << 1) | int(b)
        for b in a[40:64]:
            src = (src << 1) | int(b)
        out.update(dst=dst, src=src)
    return out


class DMRBurstProcessor:
    """Streaming DMR burst decoder over the 4FSK dibit stream.

    Wraps DSDFrameSync; on each DMR sync hit it decodes the surrounding
    burst structure once the dibits are available (bursts straddle block
    boundaries, so decoding is deferred until the ring holds the full
    window).  Voice superframes are tracked at the 288-dibit same-slot
    cadence (A..F; reference dsd_dmr.cpp:137-356).  The frame sync's
    correlation and the D-STAR header's Viterbi run on ``device`` (CUDA
    unless the caller asks for the CPU)."""

    #: dibits needed BEFORE a sync end (CACH + payload1 + sync)
    LOOKBACK = 90
    #: dibits needed AFTER a voice sync end (bursts B..F center fields)
    LOOKAHEAD = DIBITS_PER_FRAME * (SUPERFRAME_BURSTS - 1) + 1

    def __init__(self, device="cuda"):
        from .p25 import P25NidProcessor
        from .dstar import DStarProcessor
        self.sync = DSDFrameSync(device=device)
        self._ring = np.zeros(0, np.uint8)     # on-air dibits
        self._start = 0                        # global index of ring[0]
        self._pending_data: List[dict] = []
        self._pending_voice: List[dict] = []
        self._pending_p25: List[dict] = []
        self.p25 = P25NidProcessor()
        self._pending_dstar: List[dict] = []
        self.dstar = DStarProcessor(device=device)
        # products
        self.burst_counts: Dict[str, int] = {}
        self.slot_last_type = ["", ""]
        self.color_code: Optional[int] = None
        self.cc_votes: Dict[int, int] = {}
        self.voice_superframes = 0
        self.voice_bursts = 0
        self.lc_decodes = 0
        self.last_lc: Optional[dict] = None
        self.short_lc_decodes = 0
        self.last_short_lc: Optional[dict] = None
        self._slc_frags: List[np.ndarray] = []
        self.full_lc_decodes = 0
        self.last_full_lc: Optional[dict] = None
        self.csbk_decodes = 0
        self.last_csbk: Optional[dict] = None
        self._pending_x2: List[dict] = []
        self.x2_burst_counts: Dict[str, int] = {}
        self.x2_color_code: Optional[int] = None
        self.x2_slot: Optional[int] = None

    # -- ring helpers ---------------------------------------------------
    def _have(self, lo: int, hi: int) -> bool:
        return lo >= self._start and hi <= self._start + len(self._ring)

    def _dibits(self, lo: int, hi: int) -> np.ndarray:
        return self._ring[lo - self._start:hi - self._start]

    def _bits(self, lo: int, hi: int) -> np.ndarray:
        return bits_of_air(self._dibits(lo, hi))

    # -- field extraction ----------------------------------------------
    def _center_field(self, end: int) -> np.ndarray:
        """48 bits of the burst's center (sync or EMB+fragment);
        ``end`` = index of the last center dibit (inclusive)."""
        return self._bits(end - (SYNC_LEN - 1), end + 1)

    def _process_data(self, p: dict) -> bool:
        idx, name = p["idx"], p["name"]
        s0 = idx - (SYNC_LEN - 1)               # first sync dibit
        if not self._have(idx - self.LOOKBACK, idx + 55):
            return False
        st_bits = np.concatenate([self._bits(s0 - 5, s0),
                                  self._bits(idx + 1, idx + 6)])
        st = decode_slot_type(st_bits)
        self.burst_counts[st["type_name"]] = \
            self.burst_counts.get(st["type_name"], 0) + 1
        if st["ok"]:
            self.cc_votes[st["cc"]] = self.cc_votes.get(st["cc"], 0) + 1
            self.color_code = max(self.cc_votes, key=self.cc_votes.get)
        if st["ok"] and st["data_type"] in (1, 2, 3):
            # BPTC(196,96) payload: 49 dibits on each side of the
            # slot-type/sync center (beyond the reference, which skips
            # the data payload after classifying the slot type)
            pay = np.concatenate([self._bits(s0 - 54, s0 - 5),
                                  self._bits(idx + 6, idx + 55)])
            info, _n = bptc_196_96_decode(pay)
            if info is not None:
                if st["data_type"] in (1, 2):
                    lc = decode_full_lc(info, st["data_type"])
                    if lc is not None:
                        self.full_lc_decodes += 1
                        self.last_full_lc = dict(
                            lc, burst=st["type_name"])
                else:
                    csbk = decode_csbk(info)
                    if csbk is not None:
                        self.csbk_decodes += 1
                        self.last_csbk = csbk
        slot = 0
        if name.startswith("DMR_BS"):           # CACH precedes BS bursts
            cach = decode_cach(self._bits(s0 - 66, s0 - 54))
            slot = cach["tc"]
            self._push_slc(cach)
        elif "TS2" in name:
            slot = 1
        self.slot_last_type[slot] = st["type_name"]
        return True

    def _push_slc(self, cach: dict):
        """Short-LC fragment assembly keyed by LCSS (1 first, 3
        continue, 2 last, 0 single/null)."""
        if cach["tact_errs"] > 1:
            return
        if cach["lcss"] == 1:
            self._slc_frags = [cach["payload"]]
        elif cach["lcss"] == 3 and self._slc_frags:
            self._slc_frags.append(cach["payload"])
        elif cach["lcss"] == 2 and len(self._slc_frags) == 3:
            self._slc_frags.append(cach["payload"])
            slc = decode_short_lc(np.concatenate(self._slc_frags))
            self._slc_frags = []
            if slc is not None:
                self.short_lc_decodes += 1
                self.last_short_lc = slc
        else:
            self._slc_frags = []

    def _process_voice(self, p: dict) -> bool:
        idx = p["idx"]
        while p["k"] <= SUPERFRAME_BURSTS - 1:
            end = idx + DIBITS_PER_FRAME * p["k"]
            if not self._have(end - (SYNC_LEN - 1), end + 1):
                return False
            cf = self._center_field(end)
            # a new sync in the center field ends the superframe early
            # (handled naturally: sync hits spawn their own trackers)
            emb = decode_emb(np.concatenate([cf[:8], cf[40:48]]))
            p["embs"].append(emb)
            if 1 <= p["k"] <= 4:
                p["frags"].append(cf[8:40])
            p["k"] += 1
        # superframe complete: A..F seen
        self.voice_superframes += 1
        self.voice_bursts += SUPERFRAME_BURSTS
        lc = decode_embedded_lc(np.concatenate(p["frags"]))
        if lc is not None:
            self.lc_decodes += 1
            self.last_lc = lc
            # EMB carries no FEC here (raw read) — only let verified
            # superframes vote for the colour code, else loop seams /
            # squelch noise pollute the majority
            for emb in p["embs"]:
                self.cc_votes[emb["cc"]] = \
                    self.cc_votes.get(emb["cc"], 0) + 1
            self.color_code = max(self.cc_votes, key=self.cc_votes.get)
        slot = 1 if "TS2" in p["name"] else 0
        self.slot_last_type[slot] = "VOICE"
        self.burst_counts["VOICE"] = \
            self.burst_counts.get("VOICE", 0) + SUPERFRAME_BURSTS
        return True

    # -- main entry -----------------------------------------------------
    def push(self, dibits: np.ndarray) -> List[tuple]:
        """Consume demod dibits (OUR convention); returns the sync hits
        found in this block (global index, name, is_voice)."""
        hits = self.sync.push(dibits)
        air = OUR_TO_AIR[np.asarray(dibits, np.uint8) & 3]
        self._ring = np.concatenate([self._ring, air]) \
            if self._ring.size else air
        for (idx, name, voice) in hits:
            if name == "DSTAR_SYNC" or name == "DSTAR_SYNC_INV":
                self.dstar.voice_syncs += 1
                continue
            if name.startswith("DSTAR_HD"):
                self._pending_dstar.append(
                    {"idx": idx, "inv": name.endswith("_INV")})
                continue
            if name.startswith("P25"):
                self._pending_p25.append(
                    {"idx": idx, "inv": name.endswith("_INV")})
                continue
            if name.startswith("X2TDMA") and "DATA" in name:
                self._pending_x2.append({"idx": idx, "name": name})
                continue
            if not name.startswith("DMR"):
                continue
            if voice:
                self._pending_voice.append(
                    {"idx": idx, "name": name, "k": 1, "frags": [],
                     "embs": []})
            else:
                self._pending_data.append({"idx": idx, "name": name})
        self._pending_data = [p for p in self._pending_data
                              if not self._process_data(p)]
        self._pending_x2 = [p for p in self._pending_x2
                            if not self._process_x2(p)]
        self._pending_p25 = [p for p in self._pending_p25
                             if not self._process_p25(p)]
        self._pending_dstar = [p for p in self._pending_dstar
                               if not self._process_dstar(p)]
        self._pending_voice = [p for p in self._pending_voice
                               if not self._process_voice(p)]
        # trim: keep enough for the oldest pending window + lookback
        keep_from = self._start + len(self._ring) - (self.LOOKAHEAD
                                                     + self.LOOKBACK + 64)
        for p in (self._pending_voice + self._pending_data
                  + self._pending_x2):
            keep_from = min(keep_from, p["idx"] - self.LOOKBACK)
        for p in self._pending_p25 + self._pending_dstar:
            keep_from = min(keep_from, p["idx"])
        n_drop = max(0, keep_from - self._start)
        if n_drop:
            self._ring = self._ring[n_drop:]
            self._start += n_drop
        return hits

    def _process_x2(self, p: dict) -> bool:
        """X2-TDMA data burst: CACH slot bit + 3-bit colour code + AIEI
        + 4-bit burst type, read at the reference's exact offsets
        (dsd_x2tdma.cpp:4-108 processX2TDMAdata — CACH 12 dibits at
        sync-start−66, slot type = the 5 dibits before the sync; the
        reference reads all fields raw, no FEC, and so do we).  The
        X2 voice path beyond sync counting is the vendored-MBE
        boundary, as upstream."""
        idx = p["idx"]
        s0 = idx - (SYNC_LEN - 1)
        if not self._have(s0 - 66, idx + 1):
            return False
        cach = self._bits(s0 - 66, s0 - 54)
        self.x2_slot = int(cach[4])            # cachdata[2] bit 1
        st = self._bits(s0 - 5, s0)
        self.x2_color_code = int(st[0]) * 4 + int(st[1]) * 2 + int(st[2])
        bt = (int(st[4]) * 8 + int(st[5]) * 4 + int(st[6]) * 2
              + int(st[7]))
        name = BURST_TYPE_NAMES.get(bt, "UNK")
        self.x2_burst_counts[name] = \
            self.x2_burst_counts.get(name, 0) + 1
        return True

    def _process_p25(self, p: dict) -> bool:
        """NID (NAC + DUID) decode past a P25 sync, then LDU1 link
        control (models/p25.py; reference dsd_p25.cpp).  Inverted sync
        = inverted polarity: flip the sign bit of every dibit."""
        from .p25 import P25NidProcessor
        idx = p["idx"]
        nd = P25NidProcessor.NID_DIBITS
        if "nid" not in p:
            if not self._have(idx + 1, idx + 1 + nd):
                return False
            d = self._dibits(idx + 1, idx + 1 + nd)
            if p["inv"]:
                d = d ^ 2
            p["nid"] = self.p25.process(d)
        nid = p["nid"]
        if nid is None:
            return True
        # signalling DUIDs: defer until the frame body is in the ring
        lw = self.p25.frame_window(nid["duid"])
        if lw == 0:
            return True
        if not self._have(idx + 1 + nd, idx + 1 + nd + lw):
            return False
        w = self._dibits(idx + 1 + nd, idx + 1 + nd + lw)
        if p["inv"]:
            w = w ^ 2
        self.p25.process_frame_body(nid["duid"], w)
        return True

    def _process_dstar(self, p: dict) -> bool:
        """660-bit radio-header decode past a D-STAR header sync
        (models/dstar.py; reference dsd_dstar.cpp).  D-STAR is binary
        GMSK — each dibit contributes its SIGN bit; polarity resolved
        by the sync variant with a CRC-gated fallback flip."""
        from .dstar import HEADER_BITS
        idx = p["idx"]
        if not self._have(idx + 1, idx + 1 + HEADER_BITS):
            return False
        d = self._dibits(idx + 1, idx + 1 + HEADER_BITS)
        bits = ((d >> 1) & 1).astype(np.uint8)
        if p["inv"]:
            bits ^= 1
        h = self.dstar.process_header(bits)
        if h is not None and not h["crc_ok"]:
            self.dstar.process_header(bits ^ 1)
        return True

    # -- status surface -------------------------------------------------
    def summary(self) -> dict:
        out = self.sync.summary()
        out.update({
            "colorCode": self.color_code,
            "burstTypes": dict(self.burst_counts),
            "slot0LastType": self.slot_last_type[0],
            "slot1LastType": self.slot_last_type[1],
            "voiceSuperframes": self.voice_superframes,
            "voiceBursts": self.voice_bursts,
            "lcDecodes": self.lc_decodes,
            "lastLC": self.last_lc,
            "shortLcDecodes": self.short_lc_decodes,
            "lastShortLC": self.last_short_lc,
            "fullLcDecodes": self.full_lc_decodes,
            "lastFullLC": self.last_full_lc,
            "csbkDecodes": self.csbk_decodes,
            "lastCSBK": self.last_csbk,
            "x2BurstTypes": dict(self.x2_burst_counts),
            "x2ColorCode": self.x2_color_code,
            "x2Slot": self.x2_slot,
            "p25": self.p25.summary(),
            "dstar": self.dstar.summary(),
        })
        return out
