"""The port's streaming voice and trunking decoders against the JAX
package's, fed the same seeded streams in uneven chunks: ``DSDFrameSync``
on every one of its 30 sync patterns (the port's correlation on the CPU,
one ``conv1d``); ``DMRBurstProcessor`` on tests/test_dmr_burst.py's
streams (a DMR voice superframe, data bursts with slot type, CACH short
LC, full LC and CSBK payloads, X2-TDMA data bursts, P25 NID / LDU1 / HDU /
TSDU frames, D-STAR headers in both polarities); the TETRA downlink
decoder on tests/test_tetra_mac.py's fragmented SDS loopback; the CTCSS
and DCS detectors.

Tolerances: the sync hits, the burst processors' summaries and the TETRA
decoder's products equal, but where a fix of the port applies (the full
LC's RS(12,9) parity, ``parse_tsdu`` past a bad block), where each
divergence is asserted explicitly beside the JAX package's output; the
CTCSS powers within 1e-5 relative (one float32 matmul on either side)
and the detected tone equal; the DCS detector exact.
"""

import numpy as np
import pytest

from sdrplusplusbrown_tpu.models import dmr_burst as jd
from sdrplusplusbrown_tpu.models import dsd as jdsd
from sdrplusplusbrown_tpu.models import tetra as jt
from sdrplusplusbrown_tpu.ops import ctcss as jc
from sdrplusplusbrown_tpu_torch.models import dmr_burst as pd
from sdrplusplusbrown_tpu_torch.models import dsd as pdsd
from sdrplusplusbrown_tpu_torch.models import dstar as ps
from sdrplusplusbrown_tpu_torch.models import p25 as pp
from sdrplusplusbrown_tpu_torch.models import tetra as pt
from sdrplusplusbrown_tpu_torch.ops import ctcss as pc

from torch_parity import _chip_smoke, equal_tree

SMOKE = _chip_smoke()
AIR_TO_OUR = np.argsort(pd.OUR_TO_AIR)


def _chunks(n: int, seed: int, lo: int = 50, hi: int = 900):
    """Uneven chunk bounds over n samples."""
    r = np.random.default_rng(seed)
    out, i = [], 0
    while i < n:
        j = min(n, i + int(r.integers(lo, hi)))
        out.append((i, j))
        i = j
    return out


def _both_bursts(air: np.ndarray, seed: int):
    """The port's and the JAX package's DMRBurstProcessor fed the same
    on-air stream (translated to the demod's dibits) in the same uneven
    chunks; (port summary, JAX summary), each chunk's hits equal."""
    ours = AIR_TO_OUR[air]
    p, j = pd.DMRBurstProcessor(device="cpu"), jd.DMRBurstProcessor()
    for lo, hi in _chunks(len(ours), seed):
        assert p.push(ours[lo:hi]) == j.push(ours[lo:hi])
    return p.summary(), j.summary()


# ---------------------------------------------------------------------------
# frame sync
# ---------------------------------------------------------------------------

def test_sync_patterns_and_templates_equal():
    assert pdsd.SYNC_PATTERNS == jdsd.SYNC_PATTERNS
    assert np.array_equal(pdsd._templates(), jdsd._templates())
    assert pdsd.MAX_SYNC_LEN == jdsd.MAX_SYNC_LEN == 32


@pytest.mark.parametrize("seed", [1, 2])
def test_frame_sync_every_pattern(seed):
    """Each of the 30 patterns twice, at random places in random dibits, the
    stream fed in uneven chunks (syncs straddle chunk boundaries): every
    chunk's hits, the counts and the summary equal the JAX package's, and
    every inserted sync is found."""
    r = np.random.default_rng(seed)
    n = 200 + 2 * 60 * len(pdsd.SYNC_PATTERNS)
    air = r.integers(0, 4, n).astype(np.uint8)
    ends = []
    for k, (name, pat, _) in enumerate(pdsd.SYNC_PATTERNS):
        for c in range(2):
            e = 100 + (2 * k + c) * 60 + int(r.integers(0, 20))
            air[e - len(pat) + 1:e + 1] = SMOKE.sync_air(name)
            ends.append((e, name))
    ours = AIR_TO_OUR[air]
    p, j = pdsd.DSDFrameSync(device="cpu"), jdsd.DSDFrameSync()
    hits = []
    # three chunk lengths (the JAX correlation compiles a shape each),
    # short ones among them: syncs straddle one and two boundaries
    sizes = (37, 211, 13)
    bounds = np.cumsum([0] + [sizes[i % 3] for i in range(n)])
    for lo, hi in zip(bounds[:-1], np.minimum(bounds[1:], n)):
        if lo >= n:
            break
        h = p.push(ours[lo:hi])
        assert h == j.push(ours[lo:hi])
        hits += h
    assert p.summary() == j.summary()
    got = {(i, name) for i, name, _ in hits}
    assert all(e in got for e in ends), sorted(set(ends) - got)


def test_sync_correlate_matches_an_exact_compare():
    """The conv1d correlation's match matrix equals a string compare of
    every window end, on a stream with inner symbols (0 sign) too."""
    r = np.random.default_rng(3)
    db = r.integers(0, 4, 3000)
    db[1000:1024] = AIR_TO_OUR[SMOKE.sync_air("DMR_MS_VOICE")]
    signs = (np.where(db >= 2, 1.0, -1.0) * ((db == 0) | (db == 3))) \
        .astype(np.float32)
    import torch
    m = pdsd.sync_correlate(torch.from_numpy(signs),
                            torch.from_numpy(pdsd._templates()),
                            torch.from_numpy(pdsd._lengths())).numpy()
    want = np.zeros_like(m)
    for p, (_, pat, _) in enumerate(pdsd.SYNC_PATTERNS):
        t = np.array([1.0 if ch == "1" else -1.0 for ch in pat])
        for e in range(pdsd.MAX_SYNC_LEN - 1, len(signs)):
            want[p, e - pdsd.MAX_SYNC_LEN + 1] = np.array_equal(
                signs[e - len(pat) + 1:e + 1], t)
    assert np.array_equal(m, want) and m.sum() >= 1


# ---------------------------------------------------------------------------
# DMR / X2-TDMA / P25 / D-STAR through the burst processor
# ---------------------------------------------------------------------------

def _bits_to_air(bits):
    return SMOKE.air_of_bits(np.asarray(bits, np.uint8))


def test_dmr_voice_superframe():
    r = np.random.default_rng(20)
    air = r.integers(0, 4, 4000).astype(np.uint8)
    frag = pd.encode_embedded_lc(np.array([0, 0, 0, 0, 0, 9, 0, 0x12, 0x34],
                                          np.uint8))
    a_end = 500
    air[a_end - 23:a_end + 1] = SMOKE.sync_air("DMR_BS_VOICE")
    for k, lcss in enumerate([1, 3, 3, 2, 0], start=1):
        emb = np.zeros(16, np.uint8)
        emb[:4] = SMOKE.bits_msb(7, 4)
        emb[5:7] = SMOKE.bits_msb(lcss, 2)
        f = frag[32 * (k - 1):32 * k] if k <= 4 else np.zeros(32, np.uint8)
        e = a_end + 288 * k
        air[e - 23:e + 1] = _bits_to_air(np.concatenate([emb[:8], f,
                                                         emb[8:]]))
    ps_, js_ = _both_bursts(air, 21)
    assert ps_ == js_
    assert ps_["voiceSuperframes"] == 1 and ps_["lcDecodes"] == 1
    assert (ps_["lastLC"]["dst"], ps_["lastLC"]["src"]) == (9, 0x1234)


def test_dmr_data_bursts_and_the_full_lc_fix():
    """tests/test_dmr_burst.py's data bursts (a voice header and a
    terminator with the JAX package's RS(12,9) parity, a CSBK, the short
    LC in the CACHs), then the same two LCs with the standard parity.
    Equal summaries but the full LC's: the JAX package decodes only its
    own parity (2 full LCs, its last the first TLC), the port only the
    standard one (2, its last the second TLC)."""
    r = np.random.default_rng(22)
    lc = np.array([0, 0, 0, 0, 0x10, 0x65, 2, 0x4C, 0x3B], np.uint8)
    lc2 = np.array([0, 0, 0, 0, 0x00, 0x5B, 0x2F, 0x9B, 0xE5], np.uint8)
    a = np.zeros(64, np.uint8)
    a[16:40] = SMOKE.bits_msb(4197, 24)
    a[40:64] = SMOKE.bits_msb(150587, 24)
    payloads = [(1, jd.encode_full_lc(lc, 1)), (3, pd.encode_csbk(56, 0, a)),
                (2, jd.encode_full_lc(lc, 2)), (1, pd.encode_full_lc(lc2, 1)),
                (9, None), (2, pd.encode_full_lc(lc2, 2))]
    air = r.integers(0, 4, 2600).astype(np.uint8)
    slc = pd.encode_short_lc(0x1, 0x00AB12)
    for k, (dt, info) in enumerate(payloads):
        e = 300 + 288 * k
        st = pd.encode_slot_type(cc=7, data_type=dt)
        cach = pd.encode_cach(1, 0, [1, 3, 3, 2, 0, 0][k],
                              slc[17 * (k % 4):17 * (k % 4) + 17])
        air[e - 89:e - 77] = _bits_to_air(cach)
        if info is not None:
            pay = pd.bptc_196_96_encode(info)
            air[e - 77:e - 28] = _bits_to_air(pay[:98])
            air[e + 6:e + 55] = _bits_to_air(pay[98:])
        air[e - 28:e - 23] = _bits_to_air(st[:10])
        air[e - 23:e + 1] = SMOKE.sync_air("DMR_BS_DATA")
        air[e + 1:e + 6] = _bits_to_air(st[10:])
    ps_, js_ = _both_bursts(air, 23)
    fixed = ("fullLcDecodes", "lastFullLC")
    assert {k: v for k, v in ps_.items() if k not in fixed} == \
        {k: v for k, v in js_.items() if k not in fixed}
    assert js_["fullLcDecodes"] == 2 and ps_["fullLcDecodes"] == 2
    assert (js_["lastFullLC"]["dst"], js_["lastFullLC"]["src"]) == \
        (0x1065, 150587)
    assert (ps_["lastFullLC"]["dst"], ps_["lastFullLC"]["src"]) == \
        (0x5B, 0x2F9BE5)
    assert ps_["lastFullLC"]["burst"] == "TLC"
    assert ps_["lastShortLC"] == {"opcode": 1, "data": 0x00AB12}
    assert ps_["csbkDecodes"] == 1 and ps_["colorCode"] == 7


def test_x2tdma_data_bursts():
    r = np.random.default_rng(24)
    air = r.integers(0, 4, 2000).astype(np.uint8)
    for k, bt in enumerate([3, 9]):
        e = 400 + 288 * k
        st = np.zeros(10, np.uint8)
        st[:3] = SMOKE.bits_msb(5, 3)
        st[4:8] = SMOKE.bits_msb(bt, 4)
        cach = np.zeros(24, np.uint8)
        cach[4] = 1
        air[e - 89:e - 77] = _bits_to_air(cach)
        air[e - 28:e - 23] = _bits_to_air(st)
        air[e - 23:e + 1] = SMOKE.sync_air("X2TDMA_BS_DATA")
    ps_, js_ = _both_bursts(air, 25)
    assert ps_ == js_
    assert ps_["x2BurstTypes"] == {"CSBK": 1, "Idle": 1}


@pytest.mark.parametrize("inv", [False, True])
def test_p25_frames(inv):
    """P25 frames of every parsed DUID (NIDs with bit errors, an HDU, LDU1
    and LDU2 with link control, a TDULC, a TSDU with two TSBKs), both
    polarities: equal summaries."""
    r = np.random.default_rng(26)
    mi = r.integers(0, 2, 72).astype(np.uint8)
    lcinfo = np.zeros(56, np.uint8)
    lcinfo[16:32] = SMOKE.bits_msb(4321, 16)
    lcinfo[32:56] = SMOKE.bits_msb(778899, 24)
    grant = pp.encode_tsbk(0x00, 0, r.integers(0, 2, 64).astype(np.uint8))
    net = pp.encode_tsbk(0x3B, 0, r.integers(0, 2, 64).astype(np.uint8),
                         lb=True)
    frames = [(0x0, pp.encode_hdu(mi, 0, 0x84, 0x2222, 4242, r)),
              (0x5, pp.encode_ldu1(0, 0, lcinfo, r)),
              (0xA, pp.encode_ldu2(mi, 0xAA, 0xBEEF, r)),
              (0xF, pp.encode_tdulc(0, 0, lcinfo, r)),
              (0x7, pp.encode_tsdu([grant, net])),
              (0x3, np.zeros(0, np.uint8))]
    parts = [r.integers(0, 4, 200).astype(np.uint8)]
    for duid, body in frames:
        nid = SMOKE.p25_sync_nid(0x293, duid)
        nid[24 + 2] ^= 1                      # a NID bit error
        parts += [nid, body, r.integers(0, 4, 60).astype(np.uint8)]
    air = np.concatenate(parts)
    if inv:
        air = air ^ 2
    ps_, js_ = _both_bursts(air, 27)
    assert ps_ == js_
    p = ps_["p25"]
    assert p["nac"] == 0x293 and p["nidOk"] == 6
    assert (p["hduDecodes"], p["ldu2Decodes"], p["lcDecodes"],
            p["tsbkDecodes"]) == (1, 1, 2, 2)


def test_p25_tsdu_past_a_bad_block():
    """Fixed in the port: a TSDU whose first block fails its trellis and
    whose second is an IDEN_UP (last block, a negative offset) gives the
    port the IDEN_UP (-1.0 MHz); the JAX package stops at the bad block
    and keeps its earlier TSBK.  Everything else equal."""
    r = np.random.default_rng(28)
    bad = pp.encode_tsbk(0x00, 0, r.integers(0, 2, 64).astype(np.uint8))
    bad[r.choice(196, 40, replace=False)] ^= 1
    iden = pp.encode_tsbk(0x3D, 0, SMOKE.p25_tsbk_args(0x3D), lb=True)
    net = pp.encode_tsbk(0x3B, 0, SMOKE.p25_tsbk_args(0x3B), lb=True)
    air = np.concatenate([
        r.integers(0, 4, 150).astype(np.uint8),
        SMOKE.p25_sync_nid(0x293, 0x7), pp.encode_tsdu([net]),
        r.integers(0, 4, 60).astype(np.uint8),
        SMOKE.p25_sync_nid(0x293, 0x7), pp.encode_tsdu([bad, iden]),
        r.integers(0, 4, 60).astype(np.uint8)])
    ps_, js_ = _both_bursts(air, 29)
    fixed = ("tsbkDecodes", "lastTSBK")
    assert {k: v for k, v in ps_["p25"].items() if k not in fixed} == \
        {k: v for k, v in js_["p25"].items() if k not in fixed}
    assert {k: v for k, v in ps_.items() if k != "p25"} == \
        {k: v for k, v in js_.items() if k != "p25"}
    assert js_["p25"]["tsbkDecodes"] == 1
    assert js_["p25"]["lastTSBK"]["opcodeName"] == "NET_STS_BCST"
    assert ps_["p25"]["tsbkDecodes"] == 2
    assert ps_["p25"]["lastTSBK"]["opcodeName"] == "IDEN_UP"
    assert ps_["p25"]["lastTSBK"]["txOffsetMhz"] == pytest.approx(-1.0)


@pytest.mark.parametrize("inv", [False, True])
def test_dstar_headers(inv):
    """Two D-STAR headers (one with 5 channel errors) after their header
    syncs and a voice sync, both polarities: equal summaries, the headers
    decoded (the port's Viterbi on the CPU)."""
    r = np.random.default_rng(30)
    bits = ps.encode_header(b"\x00\x00\x00", "", "XLX999 B", "CQCQCQ",
                            "TP9UZT", "73")
    air = r.integers(0, 4, 2600).astype(np.uint8)
    for e, nerr in ((500, 0), (1400, 5)):
        b = bits.copy()
        b[r.choice(660, nerr, replace=False)] ^= 1
        air[e - 23:e + 1] = SMOKE.sync_air("DSTAR_HD")
        air[e + 1:e + 661] = np.where(b == 1, 3, 1)
    air[2400 - 23:2401] = SMOKE.sync_air("DSTAR_SYNC")
    if inv:
        air = air ^ 2
    ps_, js_ = _both_bursts(air, 31)
    assert ps_ == js_
    d = ps_["dstar"]
    assert d["headerCrcOk"] == 2 and d["voiceSyncs"] == 1
    assert d["lastHeader"]["my"] == "TP9UZT"


# ---------------------------------------------------------------------------
# TETRA
# ---------------------------------------------------------------------------

def _tetra_products(dec):
    return {"sync": [s.as_dict() for s in dec.sync_infos],
            "aach": list(dec.aach), "bursts": dec.bursts_seen,
            "ndb": dec.ndb_seen, "hd": dec.sch_hd_decodes,
            "f": dec.sch_f_decodes, "counts": dict(dec.mac_pdu_counts),
            "sysinfo": dec.sysinfo, "res": dec.mac_resource,
            "done": dec.reassembler.completed}


@pytest.mark.parametrize("rng_fill", [False, True])
def test_tetra_sds_loopback(rng_fill):
    """tests/test_tetra_mac.py's fragmented SDS loopback (a BSCH, then a
    D-SDS-DATA in three SCH/HD fragments), with zeros or random traffic
    around, fed in uneven chunks: every product equal, "HELLO TPU"
    reassembled."""
    bits = SMOKE.tetra_sds_bits(np.random.default_rng(33) if rng_fill
                                else None)
    dib = SMOKE.tetra_dibits(bits)
    p, j = pt.TetraDownlinkDecoder(), jt.TetraDownlinkDecoder()
    for lo, hi in _chunks(len(dib), 34, 7, 700):
        p.push(dib[lo:hi])
        j.push(dib[lo:hi])
    assert equal_tree(_tetra_products(p), _tetra_products(j))
    done = p.reassembler.completed
    assert len(done) == 1 and done[0]["fragments"] == 3
    assert bytes.fromhex(done[0]["userData"]) == b"HELLO TPU"
    assert done[0]["callingSsi"] == 0x123456


# ---------------------------------------------------------------------------
# CTCSS / DCS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tone", [127.3, 67.0, None])
def test_ctcss(tone):
    """Tone + voice + noise (or noise alone) in uneven chunks: after every
    push the powers within 1e-5 relative and the detection equal; the tone
    found (none on noise)."""
    r = np.random.default_rng(40)
    sr = 16_000.0
    t = np.arange(int(1.6 * sr)) / sr
    a = 0.5 * np.sin(2 * np.pi * 1100.0 * t) + 0.2 * r.standard_normal(len(t))
    if tone:
        a += 0.15 * np.sin(2 * np.pi * tone * t)
    a = a.astype(np.float32)
    p, j = pc.CTCSSDetector(sr, device="cpu"), jc.CTCSSDetector(sr)
    for lo, hi in _chunks(len(a), 41, 300, 5000):
        assert p.push(a[lo:hi]) == j.push(a[lo:hi])
        np.testing.assert_allclose(p.powers, j.powers, rtol=1e-5, atol=0)
        assert p.summary() == j.summary()
    assert p.detected == tone


@pytest.mark.parametrize("code,inverted", [(0o023, False), (0o023, True),
                                           (0o754, False)])
def test_dcs(code, inverted):
    """tests/test_dmr_burst.py's DCS signal in uneven chunks: every
    decision and the summary exact."""
    r = np.random.default_rng(42)
    sr = 16_000.0
    w = pc.dcs_codeword(code)
    assert w == jc.dcs_codeword(code)
    bits = np.array([(w >> b) & 1 for b in range(23)], np.float64)
    if inverted:
        bits = 1.0 - bits
    n = int(2.0 * sr)
    tt = np.arange(n) / sr
    audio = (0.2 * (2.0 * bits - 1.0)[(tt * pc.DCS_BITRATE).astype(
        np.int64) % 23] + 0.05 * r.standard_normal(n)
        + 0.4 * np.sin(2 * np.pi * 1000.0 * tt)).astype(np.float32)
    p, j = pc.DCSDetector(sr), jc.DCSDetector(sr)
    for lo, hi in _chunks(n, 43, 500, 4000):
        assert p.push(audio[lo:hi]) == j.push(audio[lo:hi])
        assert p.summary() == j.summary()
    assert p.detected in ((code,) if not inverted else (code, 0o047))
