"""The voice and trunking codecs of the port against the JAX package's, on
random inputs made from numpy seeds: DMR (Hamming (16,11,4), (7,4) and
(17,12,3), Golay (20,8), BPTC(196,96), CRC-8, CACH, slot type, EMB,
embedded and short LC, CSBK), P25 (BCH(63,16), RS(24,12) and the other
GF(64) Reed-Solomon lengths, Golay (18,6) and (24,12), Hamming (10,6,3),
the 1/2-rate trellis, the NID and the HDU / LDU1 / LDU2 / TDULC / TSDU
frames), D-STAR (the radio header), TETRA (the lower MAC, RM(30,14), the
rate-1/4 K = 5 Viterbi, the MAC and TM-SDU parsers) and POCSAG (the
codewords and the transmission).  Each is host numpy in both packages
but the D-STAR header's Viterbi (ops/fec.py, its plain version here).

Tolerances: none; every output is equal, encode and decode, with and
without corrected errors, but in the four places where the port fixes the
JAX package, each pinned by a known answer that also asserts the JAX
package's differing output: the RS(12,9) parity of the DMR full LC, the
sign of the P25 IDEN_UP transmit offset, ``parse_tsdu`` past a bad block,
and the trellis's traceback from the flush state 0.
"""

import numpy as np
import pytest

from sdrplusplusbrown_tpu.models import dmr_burst as jd
from sdrplusplusbrown_tpu.models import dstar as js
from sdrplusplusbrown_tpu.models import p25 as jp
from sdrplusplusbrown_tpu.models import pocsag as jpg
from sdrplusplusbrown_tpu.models import tetra as jt
from sdrplusplusbrown_tpu_torch.models import dmr_burst as pd
from sdrplusplusbrown_tpu_torch.models import dstar as ps
from sdrplusplusbrown_tpu_torch.models import p25 as pp
from sdrplusplusbrown_tpu_torch.models import pocsag as ppg
from sdrplusplusbrown_tpu_torch.models import tetra as pt

from torch_parity import _chip_smoke, equal_tree as _eq


def _flip(x, n, r):
    y = np.array(x, np.uint8).copy()
    if n:
        y[r.choice(len(y), n, replace=False)] ^= 1
    return y


# ---------------------------------------------------------------------------
# DMR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", ["h16", "h74", "h17", "g208", "bptc"])
def test_dmr_block_codes(code):
    """Encode, then decode with 0-3 bit errors: the port's words, values,
    corrections and distances equal the JAX package's."""
    r = np.random.default_rng(100)
    enc, dec, k, errs = {
        "h16": ("hamming_16_11_4_encode", "hamming_16_11_4_correct", 11,
                (0, 1, 2)),
        "h74": ("hamming_7_4_encode", "hamming_7_4_decode", 4, (0, 1)),
        "h17": ("hamming_17_12_3_encode", "hamming_17_12_3_correct", 12,
                (0, 1, 2)),
        "g208": ("golay_20_8_encode", "golay_20_8_decode", 8, (0, 1, 3, 5)),
        "bptc": ("bptc_196_96_encode", "bptc_196_96_decode", 96,
                 (0, 1, 3, 6)),
    }[code]
    for trial in range(12):
        d = r.integers(0, 2, k).astype(np.uint8)
        cw = getattr(pd, enc)(d)
        assert np.array_equal(cw, getattr(jd, enc)(d))
        for n in errs:
            rx = _flip(cw, n, r)
            assert _eq(getattr(pd, dec)(rx), getattr(jd, dec)(rx)), \
                (code, trial, n)


def test_dmr_crc8_lc_checksum_and_parity():
    r = np.random.default_rng(101)
    for _ in range(20):
        bits = r.integers(0, 2, int(r.integers(8, 80))).astype(np.uint8)
        assert pd.crc8(bits) == jd.crc8(bits)
        lc = r.integers(0, 256, 9).astype(np.uint8)
        assert pd.lc_checksum5(lc) == jd.lc_checksum5(lc)
        for poly, nc in ((0b10011, 4), (0b11001, 4), (0b1011, 3)):
            assert np.array_equal(pd._cyclic_parity(bits, poly, nc),
                                  jd._cyclic_parity(bits, poly, nc))


def test_dmr_field_codecs():
    """CACH, slot type, EMB, embedded LC, short LC and CSBK: encode equal,
    and decode equal on clean and corrupted fields."""
    r = np.random.default_rng(102)
    for trial in range(8):
        at, tc, lcss = (int(v) for v in r.integers(0, [2, 2, 4]))
        pay = r.integers(0, 2, 17).astype(np.uint8)
        c = pd.encode_cach(at, tc, lcss, pay)
        assert np.array_equal(c, jd.encode_cach(at, tc, lcss, pay))
        for n in (0, 1, 2):
            rx = _flip(c, n, r)
            assert _eq(pd.decode_cach(rx), jd.decode_cach(rx))
        cc, dt = int(r.integers(0, 16)), int(r.integers(0, 16))
        st = pd.encode_slot_type(cc, dt)
        assert np.array_equal(st, jd.encode_slot_type(cc, dt))
        for n in (0, 2, 4):
            rx = _flip(st, n, r)
            assert _eq(pd.decode_slot_type(rx), jd.decode_slot_type(rx))
        emb = r.integers(0, 2, 16).astype(np.uint8)
        assert pd.decode_emb(emb) == jd.decode_emb(emb)
        lc = r.integers(0, 256, 9).astype(np.uint8)
        raw = pd.encode_embedded_lc(lc)
        assert np.array_equal(raw, jd.encode_embedded_lc(lc))
        for n in (0, 1, 3):
            rx = _flip(raw, n, r)
            assert _eq(pd.decode_embedded_lc(rx), jd.decode_embedded_lc(rx))
        op, data = int(r.integers(0, 16)), int(r.integers(0, 1 << 24))
        s = pd.encode_short_lc(op, data)
        assert np.array_equal(s, jd.encode_short_lc(op, data))
        for n in (0, 1, 4):
            rx = _flip(s, n, r)
            assert _eq(pd.decode_short_lc(rx), jd.decode_short_lc(rx))
        csbko, fid = int(r.choice([4, 5, 38, 56, 61, 17])), \
            int(r.integers(0, 256))
        a = r.integers(0, 2, 64).astype(np.uint8)
        cb = pd.encode_csbk(csbko, fid, a, lb=bool(trial % 2))
        assert np.array_equal(cb, jd.encode_csbk(csbko, fid, a,
                                                 lb=bool(trial % 2)))
        for n in (0, 1):
            rx = _flip(cb, n, r)
            assert _eq(pd.decode_csbk(rx), jd.decode_csbk(rx))


def test_dmr_full_lc_parse_equal_on_both_parities():
    """The full LC parse past its parity: each package decodes what it
    encodes, to the same LC fields; the terminator's mask does not pass
    the header's."""
    r = np.random.default_rng(103)
    for _ in range(6):
        lc = r.integers(0, 256, 9).astype(np.uint8)
        for dt in (1, 2):
            got = pd.decode_full_lc(pd.encode_full_lc(lc, dt), dt)
            assert got == jd.decode_full_lc(jd.encode_full_lc(lc, dt), dt)
            assert got == pd._parse_lc_octets(lc)
        assert pd.decode_full_lc(pd.encode_full_lc(lc, 1), 2) is None


def _mmdvm_rs129(data9) -> list:
    """MMDVM's RS129 encoder (RS129.cpp) restated: POLY = {64, 56, 14},
    parity sent as parity[2], parity[1], parity[0]."""
    exp, log = pd._RS_EXP, pd._RS_LOG

    def gmul(a, b):
        return 0 if a == 0 or b == 0 else int(exp[log[a] + log[b]])
    par = [0, 0, 0]
    for d in data9:
        fb = int(d) ^ par[2]
        par = [gmul(64, fb), par[0] ^ gmul(56, fb), par[1] ^ gmul(14, fb)]
    return [par[2], par[1], par[0]]


def test_rs_12_9_known_answer():
    """Fixed in the port: data 1..9 gives the standard remainder [188, 112,
    31] (MMDVM's RS(12,9)); the JAX package gives [46, 231, 230]."""
    d = np.arange(1, 10, dtype=np.uint8)
    assert pd.rs_12_9_parity(d).tolist() == [188, 112, 31]
    assert jd.rs_12_9_parity(d).tolist() == [46, 231, 230]
    r = np.random.default_rng(104)
    for _ in range(20):
        d = r.integers(0, 256, 9).astype(np.uint8)
        assert pd.rs_12_9_parity(d).tolist() == _mmdvm_rs129(d)


def test_standard_voice_lc_header_decodes_in_the_port_only():
    """A voice LC header whose parity is the standard RS(12,9) XOR the
    0x969696 mask (as MMDVM sends it) passes the port's decode_full_lc and
    fails the JAX package's."""
    lc = np.array([0, 0, 0, 0, 0x10, 0x65, 2, 0x4C, 0x3B], np.uint8)
    par = np.array(_mmdvm_rs129(lc), np.uint8) ^ 0x96
    bits = np.unpackbits(np.concatenate([lc, par]))
    got = pd.decode_full_lc(bits, 1)
    assert got is not None and (got["dst"], got["src"]) == (0x1065, 150587)
    assert jd.decode_full_lc(bits, 1) is None


# ---------------------------------------------------------------------------
# P25
# ---------------------------------------------------------------------------

def test_p25_bch_nid():
    r = np.random.default_rng(110)
    assert pp.bch_63_16_generator() == jp.bch_63_16_generator()
    for _ in range(6):
        info = int(r.integers(0, 1 << 16))
        cw = pp.bch_63_16_encode(info)
        assert cw == jp.bch_63_16_encode(info)
        bits = np.array([(cw >> (62 - i)) & 1 for i in range(63)], np.uint8)
        for n in (0, 5, 11, 14):
            rx = _flip(bits, n, r)
            assert pp.bch_63_16_decode(rx) == jp.bch_63_16_decode(rx)


@pytest.mark.parametrize("nroots,k", [(12, 12), (16, 20), (8, 16)])
def test_p25_reed_solomon(nroots, k):
    r = np.random.default_rng(111 + nroots)
    for trial in range(6):
        data = r.integers(0, 64, k).astype(np.uint8)
        par = pp.rs_gf64_encode(data, nroots)
        assert np.array_equal(par, jp.rs_gf64_encode(data, nroots))
        for ne in (0, 2, nroots // 2, nroots // 2 + 2):
            wd, wp = data.copy(), par.copy()
            for p in r.choice(k + nroots, ne, replace=False):
                e = int(r.integers(1, 64))
                if p < k:
                    wd[p] ^= e
                else:
                    wp[p - k] ^= e
            assert _eq(pp.rs_gf64_decode(wd, wp, nroots),
                       jp.rs_gf64_decode(wd, wp, nroots)), (trial, ne)


@pytest.mark.parametrize("code", ["g186", "g2412", "h1063"])
def test_p25_word_codes(code):
    r = np.random.default_rng(112)
    enc, dec, k, errs = {
        "g186": ("golay_18_6_encode", "golay_18_6_decode", 6, (0, 2, 4)),
        "g2412": ("golay_24_12_encode", "golay_24_12_decode", 12,
                  (0, 1, 3, 5)),
        "h1063": ("hamming_10_6_3_encode", "hamming_10_6_3_decode", 6,
                  (0, 1, 2)),
    }[code]
    for _ in range(10):
        d = r.integers(0, 2, k).astype(np.uint8)
        cw = getattr(pp, enc)(d)
        assert np.array_equal(cw, getattr(jp, enc)(d))
        for n in errs:
            rx = _flip(cw, n, r)
            assert getattr(pp, dec)(rx) == getattr(jp, dec)(rx)


def test_p25_trellis_and_crc():
    """The 1/2-rate trellis: encode equal; decode equal on the sent word
    and with scattered errors away from the code's end (where both
    tracebacks end on state 0); CRC-CCITT equal."""
    r = np.random.default_rng(113)
    for _ in range(10):
        bits = r.integers(0, 2, 96).astype(np.uint8)
        assert pp.crc16_ccitt(bits[:80]) == jp.crc16_ccitt(bits[:80])
        tx = pp.trellis_1_2_encode(bits)
        assert np.array_equal(tx, jp.trellis_1_2_encode(bits))
        for n in (0, 1, 2, 3):
            rx = tx.copy()
            pos = r.choice(np.arange(0, 150), n, replace=False)
            rx[pp._TSBK_DEINT_TB[pos]] ^= 1
            got, want = pp.trellis_1_2_decode(rx), jp.trellis_1_2_decode(rx)
            assert _eq(got, want)
            assert np.array_equal(got[0], bits)


def test_p25_trellis_ends_on_the_flush_state_known_answer():
    """Fixed in the port: the traceback starts from state 0, where the
    flush dibit leaves the encoder.  With two bit errors in the code's
    last words (deinterleaved positions 190 and 192 of seed 3's block)
    another end state has the smaller metric: the JAX package's argmin
    traces back from it and returns other bits at distance 1; the port
    returns the sent bits at distance 2."""
    bits = np.random.default_rng(3).integers(0, 2, 96).astype(np.uint8)
    rx = pp.trellis_1_2_encode(bits)
    rx[pp._TSBK_DEINT_TB[[190, 192]]] ^= 1
    got, dist = pp.trellis_1_2_decode(rx)
    assert np.array_equal(got, bits) and dist == 2
    jgot, jdist = jp.trellis_1_2_decode(rx)
    assert not np.array_equal(jgot, bits) and jdist == 1


def test_p25_tsbk_parse():
    """Every opcode's fields equal but IDEN_UP's (its known answer
    below): the encoders' blocks and the parses, clean and with bit
    errors."""
    r = np.random.default_rng(114)
    for opcode in (0x00, 0x02, 0x04, 0x3A, 0x3B, 0x21):
        a = r.integers(0, 2, 64).astype(np.uint8)
        mfid, lb = int(r.integers(0, 256)), bool(r.integers(0, 2))
        blk = pp.encode_tsbk(opcode, mfid, a, lb=lb)
        assert np.array_equal(blk, jp.encode_tsbk(opcode, mfid, a, lb=lb))
        for n in (0, 2):
            rx = _flip(blk, n, r)
            assert _eq(pp.parse_tsbk(rx), jp.parse_tsbk(rx)), opcode


def _iden_args(sign, mag, spacing=100, base=170_201_250):
    a = np.zeros(64, np.uint8)
    a[0:4] = [0, 0, 0, 1]
    a[4:13] = [(100 >> (8 - i)) & 1 for i in range(9)]
    a[13:22] = [(((sign << 8) | mag) >> (8 - i)) & 1 for i in range(9)]
    a[22:32] = [(spacing >> (9 - i)) & 1 for i in range(10)]
    a[32:64] = [(base >> (31 - i)) & 1 for i in range(32)]
    return a


def test_iden_up_signed_offset_known_answer():
    """Fixed in the port: the 9-bit transmit offset is a sign bit (1:
    positive) and 8 bits of channel spacings.  Magnitude 80 at 12.5 kHz:
    -1.0 MHz with the sign bit clear, +1.0 MHz with it set; the JAX
    package reads the field unsigned in 0.25 MHz (+20.0 and +84.0)."""
    for sign, want, jax_want in ((0, -1.0, 20.0), (1, 1.0, 84.0)):
        blk = pp.encode_tsbk(0x3D, 0, _iden_args(sign, 80), lb=True)
        got = pp.parse_tsbk(blk)
        assert got["opcodeName"] == "IDEN_UP"
        assert got["txOffsetMhz"] == pytest.approx(want, abs=1e-12)
        assert (got["spacingKhz"], got["bwKhz"]) == (12.5, 12.5)
        assert got["baseFreqMhz"] == pytest.approx(851.00625)
        jgot = jp.parse_tsbk(blk)
        assert jgot["txOffsetMhz"] == jax_want
        assert {k: v for k, v in got.items() if k != "txOffsetMhz"} == \
            {k: v for k, v in jgot.items() if k != "txOffsetMhz"}


def test_parse_tsdu_past_a_bad_block_known_answer():
    """Fixed in the port: a TSDU whose first block fails its trellis (40
    bit errors) still yields its second, the last block; the JAX package
    stops at the bad one and returns nothing.  Clean TSDUs parse alike."""
    r = np.random.default_rng(115)
    grant = pp.encode_tsbk(0x00, 0, r.integers(0, 2, 64).astype(np.uint8))
    net = pp.encode_tsbk(0x3B, 0, r.integers(0, 2, 64).astype(np.uint8),
                         lb=True)
    bad = _flip(grant, 40, r)
    assert pp.parse_tsbk(bad) is None
    body = pp.encode_tsdu([bad, net])
    got = pp.parse_tsdu(body)
    assert [t["opcodeName"] for t in got] == ["NET_STS_BCST"]
    assert jp.parse_tsdu(body) == []
    clean = pp.encode_tsdu([grant, net])
    assert np.array_equal(clean, jp.encode_tsdu([grant, net]))
    assert _eq(pp.parse_tsdu(clean), jp.parse_tsdu(clean))
    assert [t["opcodeName"] for t in pp.parse_tsdu(clean)] == [
        "GRP_V_CH_GRANT", "NET_STS_BCST"]


def test_p25_frame_parsers():
    """HDU, LDU1, LDU2 and TDULC: the encoders' dibits equal (same seed),
    the parsers' dicts equal, clean and with dibit errors; the NID
    processor's products equal; the frame windows equal."""
    r = np.random.default_rng(116)
    for trial in range(3):
        mi = r.integers(0, 2, 72).astype(np.uint8)
        lcinfo = r.integers(0, 2, 56).astype(np.uint8)
        args = {
            "hdu": ("encode_hdu", "parse_hdu", (mi, 0, 0x84, 0x2222,
                                                int(r.integers(0, 65536)))),
            "ldu1": ("encode_ldu1", "parse_ldu1_lc", (0x00, 0x00, lcinfo)),
            "ldu2": ("encode_ldu2", "parse_ldu2", (mi, 0xAA, 0xBEEF)),
            "tdulc": ("encode_tdulc", "parse_tdulc", (0x00, 0x00, lcinfo)),
        }
        for name, (enc, dec, a) in args.items():
            d = getattr(pp, enc)(*a, rng=np.random.default_rng(trial))
            assert np.array_equal(d, getattr(jp, enc)(
                *a, rng=np.random.default_rng(trial))), name
            for n in (0, 4, 12):
                rx = d.copy()
                pos = r.choice(len(rx), n, replace=False)
                rx[pos] ^= r.integers(1, 4, n).astype(np.uint8)
                assert _eq(getattr(pp, dec)(rx), getattr(jp, dec)(rx)), \
                    (name, n)
    for duid in ("LDU1", "LDU2", "HDU", "TDULC", "TSDU", "TDU"):
        assert pp.P25NidProcessor.frame_window(duid) == \
            jp.P25NidProcessor.frame_window(duid)
    pn, jn = pp.P25NidProcessor(), jp.P25NidProcessor()
    for k in range(8):
        if k % 2:
            d = r.integers(0, 4, 33).astype(np.uint8)
        else:
            cw = pp.bch_63_16_encode(int(r.integers(0, 1 << 16)))
            b = [(cw >> (62 - i)) & 1 for i in range(63)] + [0]
            b = _flip(b, 2 * k, r)
            d = np.array([b[2 * i] * 2 + b[2 * i + 1] for i in range(11)]
                         + [1] + [b[2 * i] * 2 + b[2 * i + 1]
                                  for i in range(11, 32)], np.uint8)
        assert _eq(pn.process(d), jn.process(d))
    assert pn.summary() == jn.summary()


# ---------------------------------------------------------------------------
# D-STAR
# ---------------------------------------------------------------------------

def test_dstar_header():
    """The header's scrambler, interleaver, FCS and encoder equal; the
    decode (the port's Viterbi on the CPU) equal with 0, 4 and 12 channel
    errors and on random bits (an FCS failure)."""
    r = np.random.default_rng(120)
    assert np.array_equal(ps.scramble_sequence(660),
                          js.scramble_sequence(660))
    assert np.array_equal(ps.deinterleave_indices(),
                          js.deinterleave_indices())
    body = bytes(r.integers(0, 256, 39).astype(np.uint8))
    assert ps.crc16_dstar(body) == js.crc16_dstar(body)
    bits = ps.encode_header(b"\x40\x00\x00", "DB0TPU G", "DB0TPU B",
                            "CQCQCQ", "TP9UZT", "73")
    assert np.array_equal(bits, js.encode_header(
        b"\x40\x00\x00", "DB0TPU G", "DB0TPU B", "CQCQCQ", "TP9UZT", "73"))
    for n in (0, 4, 12):
        rx = _flip(bits, n, r)
        got = ps.decode_header(rx, device="cpu")
        assert got == js.decode_header(rx)
        if n <= 4:
            assert got["crc_ok"] and got["my"] == "TP9UZT"
    junk = r.integers(0, 2, 660).astype(np.uint8)
    got = ps.decode_header(junk, device="cpu")
    assert got == js.decode_header(junk) and not got["crc_ok"]


# ---------------------------------------------------------------------------
# TETRA
# ---------------------------------------------------------------------------

def test_tetra_lower_mac_primitives():
    r = np.random.default_rng(130)
    for init in (pt.SCRAMB_INIT, pt.cell_scramb_init(250, 13, 22),
                 pt.cell_scramb_init(901, 16383, 63)):
        assert np.array_equal(pt.scramble_sequence(init, 432),
                              jt.scramble_sequence(init, 432))
    assert pt.cell_scramb_init(262, 1010, 5) == \
        jt.cell_scramb_init(262, 1010, 5)
    for K, a in ((120, 11), (216, 101), (432, 103), (30, 7)):
        b = r.integers(0, 2, K).astype(np.uint8)
        assert np.array_equal(pt.block_deinterleave(b, a),
                              jt.block_deinterleave(b, a))
    for n2 in (80, 144, 288):
        b = r.integers(0, 2, 3 * n2 // 2).astype(np.uint8)
        assert np.array_equal(pt.depuncture_23(b, n2),
                              jt.depuncture_23(b, n2))
    for _ in range(4):
        b = r.integers(0, 2, int(r.integers(16, 300))).astype(np.uint8)
        assert pt.crc16_itut(b) == jt.crc16_itut(b)
    d = r.integers(0, 4, 200)
    assert np.array_equal(pt.dibits_to_bits(d), jt.dibits_to_bits(d))


def test_tetra_viterbi_and_reed_muller():
    """The rate-1/4 K = 5 Viterbi on ±1 soft bits with erasures and noise,
    and the RM(30,14) ML decode with 0-4 errors: equal."""
    r = np.random.default_rng(131)
    for _ in range(4):
        soft = np.sign(r.standard_normal(4 * 80)).astype(np.float32)
        soft[r.choice(len(soft), 100, replace=False)] = 0.0
        soft += 0.8 * r.standard_normal(len(soft)).astype(np.float32)
        assert np.array_equal(pt.viterbi_k5_r14(soft),
                              jt.viterbi_k5_r14(soft))
    for _ in range(6):
        cw = pt._RM_CODE[int(r.integers(0, 1 << 14))]
        for n in (0, 2, 4):
            rx = _flip(cw, n, r)
            assert _eq(pt.rm3014_decode(rx), jt.rm3014_decode(rx))


def test_tetra_bursts_and_mac_parsers(smoke_tetra_bits):
    """The SDS loopback's bursts: the sync and normal-burst searches, the
    BSCH, AACH, SCH/HD and SCH/F chains, the MAC PDU and TM-SDU parsers
    equal, on the clean stream and with scattered bit errors."""
    bits = smoke_tetra_bits
    r = np.random.default_rng(132)
    init = pt.cell_scramb_init(250, 13, 22)
    for n in (0, 6):
        b = _flip(bits, n, r)
        assert pt.find_sync_bursts(b) == jt.find_sync_bursts(b)
        assert pt.find_normal_bursts(b) == jt.find_normal_bursts(b)
        for s in range(0, len(b) - pt.BURST_BITS + 1, pt.BURST_BITS):
            burst = b[s:s + pt.BURST_BITS]
            got, want = pt.decode_bsch(burst), jt.decode_bsch(burst)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.as_dict() == want.as_dict()
            for is_sb in (True, False):
                assert pt.decode_aach(burst, init, is_sb) == \
                    jt.decode_aach(burst, init, is_sb)
            for blk in (1, 2):
                g, w = pt.decode_sch_hd(burst, init, blk), \
                    jt.decode_sch_hd(burst, init, blk)
                assert _eq(g, w)
                if g is not None:
                    assert _eq(pt.parse_mac_pdu(g), jt.parse_mac_pdu(g))
            assert _eq(pt.decode_sch_f(burst, init),
                       jt.decode_sch_f(burst, init))
    for _ in range(40):
        t1 = r.integers(0, 2, 268).astype(np.uint8)
        assert _eq(pt.parse_mac_pdu(t1), jt.parse_mac_pdu(t1))
        sdu = t1[:int(r.integers(20, 268))]
        assert _eq(pt.parse_tm_sdu(sdu), jt.parse_tm_sdu(sdu))


@pytest.fixture
def smoke_tetra_bits():
    return _chip_smoke().tetra_sds_bits(None)


# ---------------------------------------------------------------------------
# POCSAG
# ---------------------------------------------------------------------------

def test_pocsag_codewords_and_transmission():
    r = np.random.default_rng(140)
    for _ in range(20):
        data = int(r.integers(0, 1 << 21))
        cw = ppg.encode_codeword(data)
        assert cw == jpg.encode_codeword(data)
        for n in (0, 1, 3):
            rx = cw
            for b in r.choice(32, n, replace=False):
                rx ^= 1 << int(b)
            assert ppg.check_codeword(rx) == jpg.check_codeword(rx)
        addr = int(r.integers(0, 1 << 21))
        assert ppg.encode_address(addr, 2) == jpg.encode_address(addr, 2)
    text = "TPU PAGER OK " * 3
    assert ppg.encode_message_words(text) == jpg.encode_message_words(text)
    bits = ppg.encode_transmission(0x15ABC8, text, function=3)
    assert np.array_equal(bits, jpg.encode_transmission(0x15ABC8, text,
                                                        function=3))
    rx = _flip(bits, 4, r)
    p, j = ppg.POCSAGDecoder(), jpg.POCSAGDecoder()
    for lo in range(0, len(rx), 397):
        p.push_bits(rx[lo:lo + 397])
        j.push_bits(rx[lo:lo + 397])
    assert p.messages == j.messages and p.messages
