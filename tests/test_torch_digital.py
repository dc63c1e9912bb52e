"""The digital substrate of the port against the JAX package on the CPU:
the Viterbi decoder's plain version (kernel K16's), the host FEC, the
differential decoder, the FD clock recovery (K13f's plain version), the
Costas loop with Meteor's nearest-phase detector (K13b's) and the four
digital demods, with the same seeded numpy inputs; the JAX blocks under
``jax.jit`` (torch_parity.jit_methods), built once a module.

Tolerances:
  * the Viterbi: the decoded bits and the final path metrics equal, bit
    for bit (both round each operation of the branch metric and the
    add-compare-select alike: float32 sums of squares of 0, 0.5 and 1 are
    exact, and on soft input XLA:CPU's scan and the port's operations
    round the same);
  * the host FEC (convolutional encoder, Reed–Solomon, randomizer,
    dual-basis tables) and the differential decoder: equal;
  * the loops and the demods, three carried blocks: outputs >= 80 dB,
    ``valid``, dibits and integer state equal, float state >= 80 dB,
    the clock's fractional position within 1e-5 of a sample
    (torch_parity.assert_mm_state says why not in dB), the Costas phase
    within 1e-5 rad modulo 2π (tests/test_torch_loops.py's bars); a JAX
    state converted by ``convert.state_from_jax`` continues the stream
    in the port to the same bars.  In a demod's chain the two packages'
    fractional positions walk ~1e-6 apart (XLA:CPU's fused multiply-adds
    against the port's separate roundings), and now and then one lies
    either side of one of the bank's 1/128 steps: that symbol (and, in
    π/4-DQPSK, the differential symbol after it) moves by up to 2 % of
    the constellation, and the loop's update moves the position by
    α·Δerr ≈ 1e-4, which it pulls back within ~100 symbols.  At most
    four such symbols a block are allowed, each within 2 % of the
    constellation's peak; every other symbol is held to the bars above,
    and the position to 1e-4 of a sample in a block that had one.

Also the end state of every caller's frames: each caller flushes its
encoder to state 0, so on a frame with a correctable number of errors
the argmin of the final metrics is state 0 and the payload is the
transmitted one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models import kg_sstv as jax_kg
from sdrplusplusbrown_tpu.models import m17 as jax_m17
from sdrplusplusbrown_tpu.models import meteor as jax_meteor
from sdrplusplusbrown_tpu.models import ryfi as jax_ryfi
from sdrplusplusbrown_tpu.ops import clock_recovery as jax_cr
from sdrplusplusbrown_tpu.ops import costas as jax_costas
from sdrplusplusbrown_tpu.ops import demod_digital as jax_dd
from sdrplusplusbrown_tpu.ops import digital as jax_digital
from sdrplusplusbrown_tpu.ops import fec as jax_fec
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models import kg_sstv, m17, meteor, ryfi
from sdrplusplusbrown_tpu_torch.ops import (clock_recovery, costas,
                                            demod_digital, digital, fec)
from sdrplusplusbrown_tpu_torch.ops.mod import RRCInterpolator

from torch_parity import (assert_mm_state, assert_nr_state,
                          assert_state_close, jit_methods, snr_db)

MIN_DB = 80.0
BLOCKS = 3


# ---- the Viterbi ------------------------------------------------------
def _hard_flips(rng):
    """K = 7 hard bits with 8 % flipped: ties in nearly every step."""
    c = jax_fec.conv_encode(rng.integers(0, 2, 200)).astype(np.float32)
    idx = rng.choice(len(c), 32, replace=False)
    c[idx] = 1.0 - c[idx]
    return c, (jax_fec.G1, jax_fec.G2, 7)


def _soft_noise(rng):
    c = jax_fec.conv_encode(rng.integers(0, 2, 300)).astype(np.float32)
    return (np.clip(c + 0.35 * rng.standard_normal(len(c)), 0.0, 1.0)
            .astype(np.float32), (jax_fec.G1, jax_fec.G2, 7))


def _m17_lsf(rng):
    """An M17 LSF as the frame decoder feeds it: punctured (P1), 6 bits
    flipped, depunctured with 0.5 at the punctured places (K = 5)."""
    lsf = jax_m17.encode_lsf("SP5WWP", "N0CALL")
    enc = jax_m17.conv_encode_m17(jax_m17._bytes_to_bits(lsf))
    punct = jax_m17._puncture(enc, jax_m17.PUNCTURE_P1)
    punct[rng.choice(len(punct), 6, replace=False)] ^= 1
    soft, _ = jax_m17._depuncture(punct, jax_m17.PUNCTURE_P1,
                                  jax_m17.ENCODED_LSF_SIZE)
    return soft, (jax_m17.CONV_G1, jax_m17.CONV_G2, jax_m17.CONV_K)


def _ryfi_frame(rng):
    """A RyFi frame's soft bits (K = 7, 8 168 steps) from its QPSK
    symbols in noise."""
    frame = jax_ryfi.pack_packets([bytes(rng.integers(0, 256, 700)
                                         .tolist())])[0]
    syms = jax_ryfi.encode_frame_symbols(frame)[jax_ryfi.SYNC_SYMS:]
    syms = syms + 0.03 * (rng.standard_normal(len(syms))
                          + 1j * rng.standard_normal(len(syms)))
    return ryfi.frame_soft(syms), (jax_ryfi.CONV_G1, jax_ryfi.CONV_G2,
                                   jax_ryfi.CONV_K)


def _dstar(soft: bool):
    """A D-STAR header's 330 trellis steps (K = 3, g1 0b111, g2 0b101,
    the JAX package's models/dstar.py): 328 random bits encoded, 8 %
    flipped (hard: ties in many steps) or in noise (soft, with erasures
    at 0.5).  K16's warp form takes it with four states a warp."""
    def make(rng):
        code = (0b111, 0b101, 3)
        c = jax_fec.conv_encode(rng.integers(0, 2, 328), *code).astype(
            np.float32)
        if soft:
            c = np.clip(c + 0.35 * rng.standard_normal(c.size), 0.0, 1.0)
            c[rng.choice(c.size, c.size // 16, replace=False)] = 0.5
        else:
            idx = rng.choice(c.size, c.size // 12, replace=False)
            c[idx] = 1.0 - c[idx]
        return c.astype(np.float32), code
    return make


#: each case's input and its seed (fixed: a case added does not move the
#: others' inputs)
VITERBI_CASES = {"hard_flips": (_hard_flips, 0),
                 "soft_noise": (_soft_noise, 3), "m17_lsf": (_m17_lsf, 1),
                 "ryfi_frame": (_ryfi_frame, 2),
                 "dstar_hard": (_dstar(False), 4),
                 "dstar_soft": (_dstar(True), 5)}


def _jax_final_metrics(soft, g1, g2, k):
    """The final path metrics of the JAX package's trellis (its scan's
    carry, which ``viterbi_decode`` does not return)."""
    import jax
    S = 1 << (k - 1)
    nxt, outs = jax_fec._branch_tables(g1, g2, k)
    nxt, outs = jnp.asarray(nxt).reshape(-1), jnp.asarray(outs)
    big = jnp.float32(1e9)

    def step(m, obs):
        bm = jnp.sum((obs[None, None, :] - outs) ** 2, axis=-1)
        return jnp.full((S,), big).at[nxt].min(
            (m[:, None] + bm).reshape(-1)), None
    final, _ = jax.lax.scan(step, jnp.full((S,), big).at[0].set(0.0),
                            jnp.asarray(soft).reshape(-1, 2))
    return np.asarray(final)


@pytest.mark.parametrize("case", sorted(VITERBI_CASES))
def test_viterbi_matches_jax_bit_for_bit(case):
    make, seed = VITERBI_CASES[case]
    soft, (g1, g2, k) = make(np.random.default_rng(seed))
    want = jax_fec.viterbi_decode(jnp.asarray(soft), g1, g2, k)
    bits, final = fec.viterbi_rows_ref(torch.from_numpy(soft)[None], g1, g2,
                                       k)
    np.testing.assert_array_equal(bits[0].numpy(), want)
    np.testing.assert_array_equal(final[0].numpy(),
                                  _jax_final_metrics(soft, g1, g2, k))
    np.testing.assert_array_equal(
        fec.viterbi_decode(soft, g1, g2, k, device="cpu"), want)


def test_viterbi_rows_are_frames():
    """A batch of frames decodes as each frame alone; the decode helpers
    take the batch in one call."""
    rng = np.random.default_rng(9)
    frames = [_soft_noise(rng)[0] for _ in range(3)]
    bits, final = fec.viterbi_rows_ref(torch.from_numpy(np.stack(frames)))
    got = fec.viterbi_decode_frames(frames, device="cpu")
    for r, f in enumerate(frames):
        b1, f1 = fec.viterbi_rows_ref(torch.from_numpy(f)[None])
        assert torch.equal(bits[r], b1[0]) and torch.equal(final[r], f1[0])
        np.testing.assert_array_equal(got[r], b1[0].numpy())


def _end_state_m17_lsf(rng):
    lsf = m17.encode_lsf("SP5WWP", "N0CALL")
    data = m17._bytes_to_bits(lsf)
    punct = m17._puncture(m17.conv_encode_m17(data), m17.PUNCTURE_P1)
    punct[rng.choice(len(punct), 5, replace=False)] ^= 1
    soft, _ = m17._depuncture(punct, m17.PUNCTURE_P1, m17.ENCODED_LSF_SIZE)
    return soft, data, (m17.CONV_G1, m17.CONV_G2, m17.CONV_K)


def _end_state_m17_stream(rng):
    data = m17._bytes_to_bits(b"\x00\x07" + bytes(range(16)))
    punct = m17._puncture(m17.conv_encode_m17(data), m17.PUNCTURE_P2)
    punct[rng.choice(len(punct), 4, replace=False)] ^= 1
    soft, _ = m17._depuncture(punct, m17.PUNCTURE_P2,
                              m17.ENCODED_PAYLOAD_SIZE)
    return soft, data, (m17.CONV_G1, m17.CONV_G2, m17.CONV_K)


def _end_state_kg_sstv(rng):
    data = np.unpackbits(np.frombuffer(b"\x12\x34\x56\x78\x9a\xbc",
                                       np.uint8))
    c = fec.conv_encode(data, kg_sstv.CONV_G1, kg_sstv.CONV_G2,
                        kg_sstv.CONV_K).astype(np.float32)
    c[rng.choice(len(c), 3, replace=False)] = 0.5
    flip = rng.choice(len(c), 2, replace=False)
    c[flip] = 1.0 - c[flip]
    return c, data, (kg_sstv.CONV_G1, kg_sstv.CONV_G2, kg_sstv.CONV_K)


def _end_state_ryfi(rng):
    frame = ryfi.pack_packets([bytes(rng.integers(0, 256, 500).tolist())])[0]
    syms = ryfi.encode_frame_symbols(frame)[ryfi.SYNC_SYMS:]
    soft = ryfi.frame_soft(syms)
    soft[rng.choice(len(soft), 60, replace=False)] = 0.5
    enc = np.zeros(ryfi.RS_BLOCK_ENC * ryfi.RS_BLOCKS, np.uint8)
    raw = frame.serialize()
    for b in range(ryfi.RS_BLOCKS):
        enc[b * 255:(b + 1) * 255] = np.frombuffer(fec.rs_encode(
            raw[b * 223:(b + 1) * 223].tobytes(), 32), np.uint8)
    data = np.unpackbits(enc ^ ryfi.SCRAMBLER)
    return soft, data, (ryfi.CONV_G1, ryfi.CONV_G2, ryfi.CONV_K)


END_STATE_CASES = {"m17_lsf": _end_state_m17_lsf,
                   "m17_stream": _end_state_m17_stream,
                   "kg_sstv": _end_state_kg_sstv, "ryfi": _end_state_ryfi}


@pytest.mark.parametrize("case", sorted(END_STATE_CASES))
def test_callers_frames_end_in_state_zero(case):
    """Known answer: each caller's frame, with errors or erasures it can
    correct, ends in state 0 and decodes to the transmitted data."""
    soft, data, (g1, g2, k) = END_STATE_CASES[case](
        np.random.default_rng(40 + sorted(END_STATE_CASES).index(case)))
    bits, final = fec.viterbi_rows_ref(torch.from_numpy(
        np.asarray(soft, np.float32))[None], g1, g2, k)
    assert int(torch.argmin(final[0])) == 0
    assert float(final[0, 0]) < float(final[0, 1:].min())
    np.testing.assert_array_equal(bits[0].numpy()[:len(data)], data)


# ---- the host FEC -----------------------------------------------------
@pytest.mark.parametrize("g1,g2,k", [(fec.G1, fec.G2, 7),
                                     (0b11001, 0b10111, 5),
                                     (0o155, 0o117, 7), (0o161, 0o127, 7)])
def test_conv_encode_matches_jax(g1, g2, k):
    bits = np.random.default_rng(k + g1).integers(0, 2, 257)
    np.testing.assert_array_equal(fec.conv_encode(bits, g1, g2, k),
                                  jax_fec.conv_encode(bits, g1, g2, k))
    np.testing.assert_array_equal(fec.predecessor_outputs(g1, g2, k)[:, 0],
                                  jax_fec._branch_tables(g1, g2, k)[1][
                                      np.arange(1 << (k - 1)) >> 1,
                                      np.arange(1 << (k - 1)) & 1])


@pytest.mark.parametrize("n_err", [0, 5, 16, 17])
def test_rs_matches_jax(n_err):
    rng = np.random.default_rng(n_err)
    data = bytes(rng.integers(0, 256, 223).tolist())
    block = fec.rs_encode(data, 32)
    assert block == jax_fec.rs_encode(data, 32)
    bad = bytearray(block)
    for p in rng.choice(255, n_err, replace=False):
        bad[p] ^= int(rng.integers(1, 256))
    got = fec.rs_decode(bytes(bad), 32)
    assert got == jax_fec.rs_decode(bytes(bad), 32)
    if n_err <= 16:
        assert got == data


def test_generalized_rs_and_ccsds_tables_match_jax():
    """The Falcon-9 RS(255, 239) (0x187, fcr 120, gap 11) with 8 errors,
    the CCSDS randomizer and the dual-basis tables."""
    rng = np.random.default_rng(3)
    ours, theirs = fec.ReedSolomon(), jax_fec.ReedSolomon()
    data = bytes(rng.integers(0, 256, 239).tolist())
    block = ours.encode(data)
    assert block == theirs.encode(data)
    bad = bytearray(block)
    for p in rng.choice(255, 8, replace=False):
        bad[p] ^= 0x5A
    assert ours.decode(bytes(bad)) == theirs.decode(bytes(bad)) == data
    np.testing.assert_array_equal(fec.ccsds_randomizer(),
                                  jax_fec.ccsds_randomizer())
    np.testing.assert_array_equal(fec.TO_DUAL_BASIS, jax_fec.TO_DUAL_BASIS)
    np.testing.assert_array_equal(fec.FROM_DUAL_BASIS,
                                  jax_fec.FROM_DUAL_BASIS)


@pytest.mark.parametrize("modulus", [2, 4])
def test_differential_decoder_matches_jax(modulus):
    rng = np.random.default_rng(modulus)
    x = rng.integers(0, modulus, (2, BLOCKS * 50))
    jb, pb = jax_digital.DifferentialDecoder(modulus), \
        digital.DifferentialDecoder(modulus)
    js, ps = jb.init_state((2,)), pb.init_state((2,))
    for b in range(BLOCKS):
        xb = x[:, b * 50:(b + 1) * 50]
        jy, js = jb.apply(None, js, jnp.asarray(xb))
        py, ps = pb.apply(None, ps, torch.from_numpy(xb))
        np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    enc = digital.DifferentialEncoder(modulus).encode(x[0])
    np.testing.assert_array_equal(
        enc, jax_digital.DifferentialEncoder(modulus).encode(x[0]))
    assert np.array_equal(digital.manchester_decode(
        digital.manchester_encode(x[0] & 1)), x[0] & 1)


# ---- the loops --------------------------------------------------------
def _rrc(symbols: np.ndarray, baud: float, fs: float, beta: float = 0.35,
         taps: int = 31) -> np.ndarray:
    """Symbols shaped by the port's RRCInterpolator on the CPU."""
    sh = RRCInterpolator(baud, fs, beta=beta, tap_count=taps)
    n = (len(symbols) // sh.in_multiple) * sh.in_multiple
    y, _ = sh.apply(None, sh.init_state(()), torch.from_numpy(
        symbols[:n].astype(np.complex64)))
    return y.numpy()


def test_fd_clock_recovery_matches_jax():
    """tests/test_demod_digital.py:81's stream (BPSK, RRC, 10 samples a
    symbol, in noise), three carried blocks."""
    rng = np.random.default_rng(81)
    T = 1600
    sym = 1.0 - 2.0 * rng.integers(0, 2, BLOCKS * T // 10 + 8)
    y = (_rrc(sym, 4800.0, 48_000.0).real[:BLOCKS * T]
         + 0.02 * rng.standard_normal(BLOCKS * T)).astype(np.float32)
    jb = jit_methods(jax_cr.FDClockRecovery(10.0))
    pb = clock_recovery.FDClockRecovery(10.0)
    np.testing.assert_array_equal(pb.bank, jb.bank)
    js, ps = jb.init_state(()), pb.init_state(())
    assert sorted(js) == sorted(ps)
    for b in range(BLOCKS):
        xb = y[b * T:(b + 1) * T]
        (jo, jv), js = jb.apply(None, js, jnp.asarray(xb))
        (po, pv), ps = pb.apply(None, ps, torch.from_numpy(xb))
        jo, jv = np.asarray(jo), np.asarray(jv)
        np.testing.assert_array_equal(pv.numpy(), jv)
        assert jv.sum() > 150 and not jv[-1]
        assert snr_db(jo[jv], po.numpy()[jv]) >= MIN_DB, b
        assert np.abs(po.numpy() - jo).max() <= 1e-5, b
        assert_mm_state(js, ps)
    assert abs(float(ps["freq"]) - 10.0) < 0.1


def test_fd_clock_recovery_other_tap_count_matches_jax():
    """An ``interp_tap_count`` other than the kernel's 8 runs the plain
    version on a CPU tensor (the card refuses it), still the JAX loop."""
    rng = np.random.default_rng(82)
    T = 1600
    sym = 1.0 - 2.0 * rng.integers(0, 2, T // 10 + 8)
    y = (_rrc(sym, 4800.0, 48_000.0).real[:T]
         + 0.02 * rng.standard_normal(T)).astype(np.float32)
    jb = jit_methods(jax_cr.FDClockRecovery(10.0, interp_tap_count=4))
    pb = clock_recovery.FDClockRecovery(10.0, interp_tap_count=4)
    assert pb.K == 4 != clock_recovery.KERNEL_TAPS
    (jo, jv), js = jb.apply(None, jb.init_state(()), jnp.asarray(y))
    (po, pv), ps = pb.apply(None, pb.init_state(()), torch.from_numpy(y))
    jo, jv = np.asarray(jo), np.asarray(jv)
    np.testing.assert_array_equal(pv.numpy(), jv)
    assert jv.sum() > 150
    assert np.abs(po.numpy() - jo).max() <= 1e-5
    assert_mm_state(js, ps)


def _phase_equal(a, b, tol: float = 1e-5):
    d = np.angle(np.exp(1j * (np.asarray(a, np.float64)
                              - np.asarray(b, np.float64))))
    assert np.abs(d).max() <= tol, d


@pytest.mark.parametrize("batch", [(), (2,)])
def test_costas_meteor_detector_matches_jax(batch):
    """Costas(4) with Meteor's nearest-of-four-phases detector on the
    asymmetric constellation at 8 samples a symbol, 0.01 rad a sample
    off, in noise; the port's detector is K13b's form."""
    assert costas.nearest_form(costas.Costas(4, 0.02, error_fn=meteor
                                             .broken_modulation_error))
    jb = jit_methods(jax_costas.Costas(
        4, 0.02, error_fn=jax_meteor.broken_modulation_error))
    pb = costas.Costas(4, 0.02, error_fn=meteor.broken_modulation_error)
    rng = np.random.default_rng(36)
    T, rows = 1000, int(np.prod(batch))
    ph = np.asarray(meteor.BROKEN_PHASES)
    x = np.stack([np.repeat(np.exp(1j * ph[rng.integers(0, 4, BLOCKS * T
                                                        // 8)]), 8)
                  * np.exp(1j * (0.01 * np.arange(BLOCKS * T)
                                 + rng.uniform(0, 6)))
                  + 0.05 * (rng.standard_normal(BLOCKS * T)
                            + 1j * rng.standard_normal(BLOCKS * T))
                  for _ in range(rows)]).astype(np.complex64)
    x = x.reshape(batch + (BLOCKS * T,))
    js, ps = jb.init_state(batch), pb.init_state(batch)
    for b in range(BLOCKS):
        xb = x[..., b * T:(b + 1) * T]
        jy, js = jb.apply(None, js, jnp.asarray(xb))
        py, ps = pb.apply(None, ps, torch.from_numpy(xb))
        assert snr_db(np.asarray(jy), py.numpy()) >= MIN_DB, b
        _phase_equal(js["phase"], ps["phase"].numpy())
        assert snr_db(np.asarray(js["freq"]), ps["freq"].numpy()) >= MIN_DB
    v = torch.from_numpy(x.reshape(-1)[:500])
    np.testing.assert_allclose(
        meteor.broken_modulation_error(v).numpy(),
        np.asarray(jax_meteor.broken_modulation_error(jnp.asarray(
            v.numpy()))), rtol=1e-5, atol=1e-6)


# ---- the demods -------------------------------------------------------
def _qpsk_stream(rng, n: int, baud: float, fs: float, beta: float = 0.35,
                 f_off: float = 3.0, noise: float = 0.02) -> np.ndarray:
    sym = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(
        0, 4, int(n * baud / fs) + 40)))
    y = _rrc(sym, baud, fs, beta)[:n]
    k = np.arange(n)
    return (0.4 * y * np.exp(1j * (2 * np.pi * f_off * k / fs + 0.6))
            + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def _fsk_stream(rng, n: int, baud: float, fs: float, dev_hz: float,
                levels) -> np.ndarray:
    """FM of an NRZ of ``levels`` at ``baud``, smoothed over a fifth of a
    symbol, in noise."""
    sps = fs / baud
    lv = np.asarray(levels)[rng.integers(0, len(levels),
                                         int(n / sps) + 2)]
    f = lv[(np.arange(n) / sps).astype(int)]
    f = np.convolve(f, np.ones(int(sps / 5)) / int(sps / 5), "same")
    ph = 2 * np.pi * dev_hz * np.cumsum(f) / fs
    return (np.exp(1j * (ph + 0.3)) + 0.02 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    ).astype(np.complex64)


def _pi4_stream(rng, n: int, baud: float, fs: float) -> np.ndarray:
    """tests/test_demod_digital.py's π/4-DQPSK at +300 Hz, in noise."""
    sps = int(fs / baud)
    ph = np.cumsum(rng.integers(0, 4, n // sps + 1) * (np.pi / 2)
                   + np.pi / 4)
    tx = np.repeat(np.exp(1j * ph), sps)[:n]
    k = np.arange(n)
    return (tx * np.exp(2j * np.pi * 300.0 * k / fs) + 0.02 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    ).astype(np.complex64)


#: name → (JAX block, port block, block length, stream)
DEMODS = {
    "psk": (lambda m: m.PSKDemod(4, 4800.0, 48_000.0), 2400,
            lambda rng, n: _qpsk_stream(rng, n, 4800.0, 48_000.0)),
    "gfsk": (lambda m: m.GFSKDemod(1200.0, 24_000.0, 1200.0), 2400,
             lambda rng, n: _fsk_stream(rng, n, 1200.0, 24_000.0, 1200.0,
                                        (-1.0, 1.0))),
    "4fsk": (lambda m: m.FourFSKDemod(4800.0, 48_000.0, 2400.0), 4800,
             lambda rng, n: _fsk_stream(rng, n, 4800.0, 48_000.0, 2400.0,
                                        (-1.0, -1 / 3, 1 / 3, 1.0))),
    "pi4dqpsk": (lambda m: m.Pi4DQPSKDemod(9000.0, 36_000.0), 3600,
                 lambda rng, n: _pi4_stream(rng, n, 9000.0, 36_000.0)),
}


def _split_state(st):
    """(the clock recovery's state, the rest) of a demod's state tree."""
    st = dict(st)
    if "gfsk" in st:
        g = dict(st.pop("gfsk"))
        return g.pop("recov"), {**st, "gfsk": g}
    return st.pop("recov"), st


#: symbols a block that a step of the bank's polyphase index may move
MAX_STEPPED = 4


def _assert_demod_state(js, ps, stepped: bool):
    """The module docstring's state bars; ``stepped``: the block had a
    symbol on either side of a polyphase step (the position within 1e-4
    of a sample)."""
    jr, jrest = _split_state(js)
    pr, prest = _split_state(ps)
    if stepped:
        jr, pr = dict(jr), dict(pr)
        jph, pph = np.asarray(jr.pop("phase")), pr.pop("phase").numpy()
        assert np.abs(jph.astype(np.float64) - pph).max() <= 1e-4
        assert_nr_state(jr, pr)
    else:
        assert_mm_state(jr, pr)
    assert_state_close(jrest, prest, MIN_DB)


def _assert_demod_out(jout, pout, what) -> bool:
    """The module docstring's output bars; returns whether a symbol was
    on either side of a polyphase step."""
    jout = [np.asarray(v) for v in jout]
    pout = [v.numpy() for v in pout]
    jv, pv = jout[-1], pout[-1]
    np.testing.assert_array_equal(pv, jv, err_msg=what)
    assert jv.sum() > 50, what
    js, ps = jout[0][jv], pout[0][jv]
    d = np.abs(ps.astype(np.complex128) - js)
    step = d > 1e-5
    assert step.sum() <= MAX_STEPPED, (what, np.flatnonzero(step))
    assert np.all(d[step] <= 0.02 * np.abs(js).max()), (what, d[step])
    assert snr_db(js[~step], ps[~step]) >= MIN_DB, what
    if len(jout) == 3:                   # the dibits
        np.testing.assert_array_equal(pout[1][pv][~step],
                                      jout[1][jv][~step], err_msg=what)
    return bool(step.any())


@pytest.mark.parametrize("name", sorted(DEMODS))
def test_demod_matches_jax(name):
    """Three carried blocks; then the JAX state after the third block,
    converted, continues in the port for a fourth."""
    make, T, stream = DEMODS[name]
    jb, pb = jit_methods(make(jax_dd)), make(demod_digital)
    x = stream(np.random.default_rng(len(name)), (BLOCKS + 1) * T)
    js, ps = jb.init_state(()), pb.init_state(())
    for b in range(BLOCKS + 1):
        xb = x[b * T:(b + 1) * T]
        if b == BLOCKS:
            ps = convert.state_from_jax(js, device="cpu")
        jout, js = jb.apply(None, js, jnp.asarray(xb))
        pout, ps = pb.apply(None, ps, torch.from_numpy(xb))
        stepped = _assert_demod_out(jout, pout, f"{name} block {b}")
        _assert_demod_state(js, ps, stepped)
