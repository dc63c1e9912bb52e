"""The port's wideband decoders against the JAX package on the CPU: VOR,
NOAA HRPT (``PMDemod`` and the framer), ATV (the front end, the line sync
and the frame assembler), Falcon 9 (the demod, the deframer, the RS and
the packet layer) and DAB (the OFDM front end), on seeded numpy inputs
(the JAX package's own test generators, which the port's models carry),
the JAX blocks under ``jax.jit``, compiled once a configuration, the
port's with ``device="cpu"`` (the plain versions of K8, K12c, K13 and
K13m).

Tolerances:
  * VOR: bearings and qualities within 1e-3 (rad, and of quality) of the
    JAX decoder's at 3 azimuths from the second 1 s window on, and the
    1 kHz phase stream >= 70 dB to the JAX stream past its first 0.2 s.
    Before that the two 30 Hz RxVFOs' outputs rise from exact zeros, so
    their product is rounding noise whose angle is arbitrary in either
    package (samples 32-80 differ by up to pi): the first window's
    bearing is held finite and in [0, 2 pi) only;
  * HRPT ``PMDemod``, stage by stage on the JAX stage's input over 12 000
    samples (test_torch_loops.py's and test_torch_digital.py's bars):
    the AGC (K12c), the PLL's VCO (K13), the de-rotated phase and the RRC
    (K8) >= 80 dB; the M&M (K13m) ``valid`` equal and every symbol within
    1e-5; the whole chain's hard symbols equal to the JAX package's but
    for at most 0.1 % of them (a symbol that a one-step change of the
    clock's polyphase index moves across zero; none on this input);
  * the framers (``HRPTFramer``, ``LineSync``, ``FrameAssembler``,
    ``FalconDeframer``, ``FalconPacketSync``, ``CyclicSync``,
    ``FrameFreqSync``), the RS, and the generators on the same inputs
    equal the JAX classes' output exactly;
  * Falcon 9's RF loopback of one frame (27 323 samples) decodes the
    packet exactly in both packages, the hard bits equal;
  * ``ATVFrontEnd`` on a short block >= 80 dB, its AGC state exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sdrplusplusbrown_tpu.models import atv as jax_atv
from sdrplusplusbrown_tpu.models import dab as jax_dab
from sdrplusplusbrown_tpu.models import falcon9 as jax_f9
from sdrplusplusbrown_tpu.models import hrpt as jax_hrpt
from sdrplusplusbrown_tpu.models import vor as jax_vor
from sdrplusplusbrown_tpu_torch.models import atv, dab, falcon9, hrpt, vor
from sdrplusplusbrown_tpu_torch.ops.digital import valid_hard_bits

from torch_parity import snr_db

MIN_DB = 80.0


def _jit(block):
    """``block.apply`` under jax.jit (one compile a block and shape)."""
    return jax.jit(lambda s, x: block.apply(None, s, x))


# ---- VOR ----------------------------------------------------------------
@pytest.fixture(scope="module")
def vor_pair():
    jd = jax_vor.VORDecoder(1.0)
    return (jd, _jit(jd), _jit(jd.rx)), vor.VORDecoder(1.0)


@pytest.mark.parametrize("az_deg", [0.0, 137.0, 289.5])
def test_vor_bearings(vor_pair, az_deg):
    """tests/test_decoders_wave1.py's signal (6 s, noise 0.05): the port's
    bearings and qualities against the JAX decoder's, the phase stream
    against its receiver's, and the JAX test's bar (the last two windows
    within 2 deg, quality > 0.9) on the port's."""
    (jd, jdec, jrx), pd = vor_pair
    x = vor.synthesize_vor(np.deg2rad(az_deg), 6.0, noise=0.05)
    np.testing.assert_array_equal(
        x, jax_vor.synthesize_vor(np.deg2rad(az_deg), 6.0, noise=0.05))
    n = (len(x) // jd.in_multiple) * jd.in_multiple
    (jb, jq), _ = jdec(jd.init_state(()), jnp.asarray(x[:n]))
    (pb, pq), _ = pd.apply(None, pd.init_state(()), torch.from_numpy(x[:n]))
    jb, jq, pb, pq = map(np.asarray, (jb, jq, pb, pq))
    assert pb.shape == jb.shape == (6,)
    assert np.all(np.isfinite(pb)) and 0.0 <= pb[0] < 2 * np.pi
    assert np.abs(pb[1:] - jb[1:]).max() <= 1e-3
    assert np.abs(pq[1:] - jq[1:]).max() <= 1e-3
    err = np.abs(((np.rad2deg(pb[-2:]) - az_deg + 180.0) % 360.0) - 180.0)
    assert np.all(err < 2.0) and np.all(pq[-2:] > 0.9), (pb, pq)
    jp, _ = jrx(jd.rx.init_state(()), jnp.asarray(x[:n]))
    pp, _ = pd.rx.apply(None, pd.rx.init_state(()), torch.from_numpy(x[:n]))
    jp = np.asarray(jp, np.float64)[200:]
    d = np.angle(np.exp(1j * (pp.numpy().astype(np.float64)[200:] - jp)))
    assert 10 * np.log10(np.mean(jp ** 2) / np.mean(d ** 2)) >= 70.0


def test_vor_quality_collapses_on_noise(vor_pair):
    (jd, jdec, _), pd = vor_pair
    rng = np.random.default_rng(7)
    T = 6 * int(vor.VOR_IN_SR)
    x = (0.3 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
         ).astype(np.complex64)
    (_, jq), _ = jdec(jd.init_state(()), jnp.asarray(x))
    (_, pq), _ = pd.apply(None, pd.init_state(()), torch.from_numpy(x))
    assert np.abs(pq.numpy()[1:] - np.asarray(jq)[1:]).max() <= 1e-3
    assert np.all(pq.numpy()[-2:] < 0.5), pq


# ---- HRPT ---------------------------------------------------------------
def _hrpt_iq(rng, n_bits: int, n: int) -> np.ndarray:
    """tests/test_hrpt.py's channel: PM at 3 MS/s, 150 Hz off, noise."""
    iq = hrpt.pm_modulate(hrpt.manchester_encode(rng.integers(0, 2,
                                                              n_bits)))
    k = np.arange(len(iq))
    iq = iq * np.exp(1j * (2 * np.pi * 150.0 * k / 3e6 + 0.4))
    iq = iq + 0.02 * (rng.standard_normal(len(iq))
                      + 1j * rng.standard_normal(len(iq)))
    return iq.astype(np.complex64)[:n]


def test_pm_demod_stages():
    iq = _hrpt_iq(np.random.default_rng(1), 3000, 12_000)
    jd, pd = jax_hrpt.PMDemod(), hrpt.PMDemod()
    js, ps = jd.init_state(()), pd.init_state(())
    np.testing.assert_array_equal(pd.rrc.taps, jd.rrc.taps)
    np.testing.assert_array_equal(pd.recov.bank, jd.recov.bank)
    x = jnp.asarray(iq)
    ya, _ = _jit(jd.agc)(js["agc"], x)
    pa, _ = pd.agc.apply(None, ps["agc"], torch.from_numpy(iq))
    assert snr_db(np.asarray(ya), pa.numpy()) >= MIN_DB
    y = np.array(ya)
    vj, _ = _jit(jd.pll)(js["pll"], ya)
    vp, _ = pd.pll.apply(None, ps["pll"], torch.from_numpy(y))
    assert snr_db(np.asarray(vj), vp.numpy()) >= MIN_DB
    dj = y * np.conj(np.asarray(vj))
    mj = np.arctan2(dj.imag, dj.real).astype(np.float32)
    d = torch.from_numpy(y) * torch.from_numpy(np.array(vj)).conj()
    assert snr_db(mj, torch.atan2(d.imag, d.real).numpy()) >= MIN_DB
    rj, _ = _jit(jd.rrc)(js["rrc"], jnp.asarray(mj))
    rp, _ = pd.rrc.apply(None, ps["rrc"], torch.from_numpy(mj))
    assert snr_db(np.asarray(rj), rp.numpy()) >= MIN_DB
    (sj, vj2), _ = _jit(jd.recov)(js["recov"], rj)
    (sp, vp2), _ = pd.recov.apply(None, ps["recov"],
                                  torch.from_numpy(np.array(rj)))
    np.testing.assert_array_equal(vp2.numpy(), np.asarray(vj2))
    assert np.abs(sp.numpy() - np.asarray(sj)).max() <= 1e-5
    # the whole chain, the port's over two carried blocks
    (aj, av), _ = _jit(jd)(js, x)
    hj = (np.asarray(aj)[np.asarray(av)] > 0).astype(np.uint8)
    st, hp = ps, []
    for blk in (iq[:5000], iq[5000:]):
        (s, v), st = pd.apply(None, st, torch.from_numpy(blk))
        hp.append(valid_hard_bits(s, v))
    hp = np.concatenate(hp)
    assert len(hp) == len(hj) > 5000
    assert np.mean(hp != hj) <= 1e-3


def _hrpt_frames(rng):
    av1 = np.stack([(np.arange(2048) * k + 7) % 1024 for k in range(1, 6)])
    av2 = rng.integers(0, 1024, (5, 2048))
    tip = rng.integers(0, 1024, 520)
    return av1, av2, tip


@pytest.mark.parametrize("chunk", [None, 7777])
def test_hrpt_framer(chunk):
    """tests/test_hrpt.py's framer vectors (two frames, and one split
    across pushes of 7 777 symbols) through both framers: the same
    frames, lines and TIP words, and the sent ones."""
    rng = np.random.default_rng(5)
    av1, av2, tip = _hrpt_frames(rng)
    frames = [hrpt.build_frame(av1, tip), hrpt.build_frame(av2)]
    for f, (a, t) in zip(frames, ((av1, tip), (av2, None))):
        np.testing.assert_array_equal(f, jax_hrpt.build_frame(a, t))
    np.testing.assert_array_equal(hrpt.words_to_bits(frames[0]),
                                  jax_hrpt.words_to_bits(frames[0]))
    sig = hrpt.frames_signal(rng, frames, preamble=400)
    np.testing.assert_array_equal(hrpt.pm_modulate(sig[:999]),
                                  jax_hrpt.pm_modulate(sig[:999]))
    fr, jf = hrpt.HRPTFramer(), jax_hrpt.HRPTFramer()
    step = chunk or len(sig)
    for i in range(0, len(sig), step):
        fr.push_symbols(sig[i:i + step])
        jf.push_symbols(sig[i:i + step])
    assert fr.frames == jf.frames == 2
    for a, b in ((fr.avhrr_lines, jf.avhrr_lines), (fr.tip, jf.tip)):
        assert all(np.array_equal(u, v) and u.dtype == v.dtype
                   for u, v in zip(a, b))
    np.testing.assert_array_equal(fr.avhrr_lines[0], av1)
    np.testing.assert_array_equal(fr.avhrr_lines[1], av2)
    np.testing.assert_array_equal(fr.tip[0], tip)


# ---- ATV ----------------------------------------------------------------
def test_atv_line_sync_and_frames():
    """tests/test_atv.py's warped video (a fractional delay, a 5e-5 rate
    error, noise) through both packages' line sync and frame assembler:
    every line, the lock, the servo and the image equal; the JAX test's
    bars on the port's."""
    rng = np.random.default_rng(11)
    pattern = np.linspace(0, 1, atv.VISIBLE_W).astype(np.float32)
    sig = atv.video_signal(pattern)
    jlines = [jax_atv.make_line(k, video=pattern if k == "normal" else None)
              for k in (["normal"] * 100 + list(atv.ODD_SEQ)
                        + ["normal"] * 100 + list(atv.EVEN_SEQ)) * 3]
    np.testing.assert_array_equal(sig, np.concatenate(jlines))
    t = np.arange(len(sig))
    grid = np.arange(0, len(sig) - 2, 1.00005)
    warped = (np.interp(grid + 0.37, t, sig)
              + 0.01 * rng.standard_normal(len(grid))).astype(np.float32)
    ports, jaxs = (atv.LineSync(), atv.FrameAssembler()), \
        (jax_atv.LineSync(), jax_atv.FrameAssembler())
    np.testing.assert_array_equal(ports[0].bank, jaxs[0].bank)
    for (ls, fa) in (ports, jaxs):
        fa.lines = []
        for i in range(0, len(warped), 50_000):
            for line in ls.push(warped[i:i + 50_000]):
                fa.push_line(line)
                fa.lines.append(line)
    (pl, pf), (jl, jf) = ports, jaxs
    assert len(pf.lines) == len(jf.lines) > 600
    assert all(np.array_equal(a, b) for a, b in zip(pf.lines, jf.lines))
    assert (pl.locked, pl.period, pl.pos, pl.consumed) == \
        (jl.locked, jl.period, jl.pos, jl.consumed)
    assert (pf.offset, pf.gain, pf.frames, pf.vlock, pf.ypos) == \
        (jf.offset, jf.gain, jf.frames, jf.vlock, jf.ypos)
    np.testing.assert_array_equal(pf.image, jf.image)
    assert pl.locked > 500 and pf.frames >= 1
    rows = pf.image[pf.image.max(axis=1) > 50]
    mid = rows[len(rows) // 2].astype(float)
    assert len(rows) > 100 and mid[-100:].mean() > mid[:100].mean() + 100


@pytest.mark.parametrize("seq,frames,ypos", [("even", 1, 0), ("odd", 0, 1)])
def test_atv_field_sync(seq, frames, ypos):
    kinds = atv.EVEN_SEQ if seq == "even" else atv.ODD_SEQ
    pa, ja = atv.FrameAssembler(), jax_atv.FrameAssembler()
    for k in kinds:
        pa.push_line(atv.make_line(k))
        ja.push_line(jax_atv.make_line(k))
    assert (pa.ypos, pa.frames, pa.sync_history) == \
        (ja.ypos, ja.frames, ja.sync_history)
    assert (pa.ypos, pa.frames) == (ypos, frames)


def test_atv_front_end():
    rng = np.random.default_rng(12)
    pattern = (0.5 + 0.4 * np.sin(2 * np.pi * np.arange(atv.VISIBLE_W)
                                  / 128.0)).astype(np.float32)
    sig = atv.video_signal(pattern, n_normal=6, reps=1)[:12_000]
    iq = ((0.8 - 0.45 * sig) * np.exp(1j * 0.3)).astype(np.complex64)
    iq += 0.004 * (rng.standard_normal(len(iq))
                   + 1j * rng.standard_normal(len(iq))).astype(np.complex64)
    jf, pf = jax_atv.ATVFrontEnd(), atv.ATVFrontEnd()
    jv, js = _jit(jf)(jf.init_state(()), jnp.asarray(iq))
    st, outs = pf.init_state(()), []
    for blk in (iq[:5000], iq[5000:]):
        v, st = pf.apply(None, st, torch.from_numpy(blk))
        assert v.dtype == torch.float32
        outs.append(v.numpy())
    assert snr_db(np.asarray(jv), np.concatenate(outs)) >= MIN_DB
    assert snr_db(np.asarray(js["amp"]), st["amp"].numpy()) >= MIN_DB
    assert int(st["env"]) == int(js["env"])


# ---- Falcon 9 -----------------------------------------------------------
def test_falcon_rs_and_packets():
    """tests/test_falcon9.py's FEC vectors in both packages: the encoded
    wire equal, 15 byte errors corrected, the packets; a packet spanning
    two frames."""
    rng = np.random.default_rng(9)
    pkts = [falcon9.make_packet(b"\x00" * 8 + b"hello"),
            falcon9.make_packet(bytes(rng.integers(0, 256, 300).tolist()))]
    payload = falcon9.build_frame_payload(1, b"".join(pkts), 0)
    np.testing.assert_array_equal(
        payload, jax_f9.build_frame_payload(1, b"".join(pkts), 0))
    wire = falcon9.falcon_rs_encode(payload)
    np.testing.assert_array_equal(wire, jax_f9.falcon_rs_encode(payload))
    w = wire.copy()
    idx = rng.choice(len(w) - 4, 15, replace=False) + 4
    w[idx] ^= rng.integers(1, 256, 15).astype(np.uint8)
    out, jout = falcon9.falcon_rs_decode(w), jax_f9.falcon_rs_decode(w)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out[:len(payload)], payload)
    w[4:204] ^= 0xFF                    # 40 errors a column: beyond t = 8
    assert falcon9.falcon_rs_decode(w) is None
    assert jax_f9.falcon_rs_decode(w) is None
    big = falcon9.make_packet(bytes(rng.integers(0, 256, 1500).tolist()))
    stream = big + falcon9.make_packet(b"after")
    frames = [falcon9.build_frame_payload(1, stream[:falcon9.DATA_LEN], 0),
              falcon9.build_frame_payload(2, stream[falcon9.DATA_LEN:],
                                          len(big) - falcon9.DATA_LEN)]
    for sync in (falcon9.FalconPacketSync(), jax_f9.FalconPacketSync()):
        sync.push_frame(out)
        for f in frames:
            sync.push_frame(f)
        assert sync.packets == pkts + [big, falcon9.make_packet(b"after")]


def test_falcon9_rf_loopback():
    """tests/test_falcon9.py's RF loopback (one frame behind 4 000 random
    bits, noise 0.05): the hard bits equal, one frame, the packet exact
    in both packages."""
    rng = np.random.default_rng(0)
    pkts = [falcon9.make_packet(b"\x00" * 8 + b"telemetry hello world")]
    wire = falcon9.falcon_rs_encode(
        falcon9.build_frame_payload(1, b"".join(pkts), 0))
    iq = falcon9.falcon_signal(falcon9.frame_bits(wire, rng), 0.05, 0.2,
                               rng)
    assert len(iq) == 27_323
    jd, pd = jax_f9.FalconDemod(), falcon9.FalconDemod()
    (js, jv), _ = _jit(jd)(jd.init_state(()), jnp.asarray(iq))
    (ps, pv), _ = pd.apply(None, pd.init_state(()), torch.from_numpy(iq))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    hj = (np.asarray(js)[np.asarray(jv)] > 0).astype(np.uint8)
    hp = valid_hard_bits(ps, pv)
    np.testing.assert_array_equal(hp, hj)
    got = []
    for df, sync, dec in (
            (falcon9.FalconDeframer(), falcon9.FalconPacketSync(),
             falcon9.falcon_rs_decode),
            (jax_f9.FalconDeframer(), jax_f9.FalconPacketSync(),
             jax_f9.falcon_rs_decode)):
        for i in range(0, len(hp), 5000):
            df.push_bits(hp[i:i + 5000])
        assert len(df.frames) == 1
        sync.push_frame(dec(df.frames[0]))
        got.append((df.frames[0], sync.packets))
    np.testing.assert_array_equal(got[0][0], got[1][0])
    assert got[0][1] == got[1][1] == pkts


# ---- DAB ----------------------------------------------------------------
def test_dab_front_end():
    """Five DAB frames 350 Hz off in noise (tests/test_dab_kgsstv.py's
    signal, shorter) through both packages' CyclicSync and FrameFreqSync:
    every symbol, position, constellation, the CFO servo and the dibits
    equal."""
    rng = np.random.default_rng(21)
    np.testing.assert_array_equal(dab.phase_reference_freq(),
                                  jax_dab.phase_reference_freq())
    frames = []
    for _ in range(5):
        iq, _ = dab.build_frame(6, rng)
        frames.append(iq)
    sig = np.concatenate(frames)
    k = np.arange(len(sig))
    sig = sig * np.exp(2j * np.pi * 350.0 * k / dab.DAB_SR)
    sig = (sig + 0.005 * (rng.standard_normal(len(sig))
                          + 1j * rng.standard_normal(len(sig)))
           ).astype(np.complex64)
    out = []
    for cs, ff in ((dab.CyclicSync(), dab.FrameFreqSync()),
                   (jax_dab.CyclicSync(), jax_dab.FrameFreqSync())):
        for i in range(0, len(sig), 40_000):
            cs.push(sig[i:i + 40_000])
        for s, p in zip(cs.symbols, cs.positions):
            ff.push_symbol(s, pos=p)
        out.append((cs, ff))
    (pc, pf), (jc, jf) = out
    assert pc.positions == jc.positions and len(pc.symbols) > 30
    assert all(np.array_equal(a, b) for a, b in zip(pc.symbols,
                                                    jc.symbols))
    assert (pf.frames_seen, pf.offset, pf.last_cfo_hz) == \
        (jf.frames_seen, jf.offset, jf.last_cfo_hz)
    assert pf.frames_seen >= 4
    assert all(np.array_equal(a, b) for a, b in zip(pf.constellations,
                                                    jf.constellations))
    dp, dj = pf.demap_time_differential(), jf.demap_time_differential()
    assert len(dp) == len(dj) > 0
    assert all(np.array_equal(a, b) for a, b in zip(dp, dj))
    np.testing.assert_array_equal(
        dab.symbol_dqpsk_dibits(pf.constellations[-1]),
        jax_dab.symbol_dqpsk_dibits(jf.constellations[-1]))
