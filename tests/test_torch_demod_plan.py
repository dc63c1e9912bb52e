"""K7's plan and staging, and K12's batched walk, on the CPU (csrc/fm_audio.cu
and csrc/agc.cu run only on the card).

``demod_kernel.fm_plan`` sizes K7's two launches: the audio FIR on the
FIR tile over the u samples that can be nonzero (d is 0 from m_if on),
then the polyphase.  Each must cover every output once, fit the H100's
227 KB a block, and launch >= 132 blocks at the paths' shapes
(scanner128, scanner256 and multimode8's NFM group at 2.4 and 10 MS/s).

``disc_model`` mirrors the audio FIR's staging hook (DiscSrc): each
staged sample of [ftail | d] in float32, one rounding per operation (the
gate product, the complex product's two rounded products and rounded
sum, the subnormal flush, the minimax atan2).  Staged block by block as
the plan's grid stages it, it must equal ``_fm_audio_ref``'s [ftail | d]
bit for bit, the tail, the carried sample at n = 0 and the zero IF past
m_if included; and the tails the kernels write from what they staged
(the block holding m_if; the polyphase's first block) must equal the
plain version's.

``agc_model`` mirrors K12's walk: 32-sample batches, the chain warp's
envelope after each step of a batch (h[k]) handed to the output warp's
lane k through a shared slot, held samples (zero or subnormal) marked
by that lane from its own sample, a partial last batch padded with zeros
(which the chain holds), frozen rows; it must equal ``agc_rows_ref``
exactly, output and state (set point 1, as every caller of the port
sets it: the plain version's ``sp / a`` is then the IEEE division the
kernel does)."""

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_NFM
from sdrplusplusbrown_tpu_torch.ops import agc, demod_kernel as dk
from sdrplusplusbrown_tpu_torch.ops import fir_kernel

SMS, SMEM = 132, 232_448
F32 = np.float32

# (C, m_if): scanner128, scanner256 (0.1 s at 50 kHz), multimode8's NFM
# group at 2.4 MS/s and at 10 MS/s
PATH_SHAPES = [(128, 5000), (256, 5000), (4, 5000), (4, 5200)]
# the card tests' shapes and short calls
OTHER_SHAPES = [(8, 5000), (1, 2000), (3, 25), (16, 3200)]


def pipe():
    return Radio(2.4e6, DEMOD_NFM, squelch_enabled=True,
                 device="cpu").fm_audio_pipe()


def _ids(shape):
    return "C{}-m{}".format(*shape)


def fir_blocks(p, C):
    """The FIR launch's blocks of one row: (m0, mb) over n_u outputs."""
    f = p["fir"]
    per = f["C"] * 32 * f["P"]
    assert f["grid"][1:] == (1, C)
    for bx in range(f["grid"][0]):
        m0 = bx * per
        yield m0, min(per, p["n_u"] - m0)


@pytest.mark.parametrize("shape", PATH_SHAPES + OTHER_SHAPES, ids=_ids)
def test_two_launch_plan_covers_every_output_once_and_fits(shape):
    C, m_if = shape
    pp = pipe()
    p = dk.fm_plan(pp, m_if, C)
    assert p["launches"] == 2
    plan = pp.plan(m_if)
    assert p["n_u"] == min(plan["n_if"], m_if + pp.histF) >= m_if
    hits = np.zeros(p["n_u"], int)
    for m0, mb in fir_blocks(p, C):
        assert 1 <= mb
        hits[m0:m0 + mb] += 1
    assert (hits == 1).all()
    f = p["fir"]
    assert f["smem"] == fir_kernel.tile_smem(1, len(pp.hf), p["n_u"], f["P"],
                                             1, f["C"], 1) <= SMEM
    # the polyphase: every (group, phase row) once
    q = p["poly"]
    I, D, kw = pp.I, pp.D, pp.kernel.shape[1]
    n_m = plan["n_aud"] // I
    P, G, Cc = q["P"], q["G"], q["C"]
    assert P in (1, 3, 5) and 1 <= G <= I and 4 <= q["warps"] <= 8
    gx, gy, gz = q["grid"]
    assert gz == C and q["blocks"] == gx * gy * gz
    assert q["smem"] == fir_kernel.tile_smem(D, kw, n_m, P, G, Cc, 1) <= SMEM
    hits = np.zeros((n_m, I), int)
    for bx in range(gx):
        m0 = bx * Cc * 32 * P
        assert m0 < n_m
        for by in range(gy):
            assert by * G < I
            hits[m0:m0 + Cc * 32 * P, by * G:(by + 1) * G] += 1
    assert (hits == 1).all()
    if G < I:      # fewer blocks than SMs with all rows a block
        assert q == fir_kernel.fir_plan(I, D, kw, plan["n_aud"], C, 1)


@pytest.mark.parametrize("shape", PATH_SHAPES, ids=_ids)
def test_path_route_fills_the_card(shape):
    C, m_if = shape
    p = dk.fm_plan(pipe(), m_if, C)
    for g in (p["fir"], p["poly"]):
        assert g["blocks"] == np.prod(g["grid"]) >= SMS
        assert g["smem"] <= SMEM


def atan2_model(im, re):
    """csrc/fm_audio.cu:atan2_poly in numpy float32."""
    a, b = np.abs(im), np.abs(re)
    mx = np.maximum(a, b)
    z = np.minimum(a, b) / np.where(mx == 0, F32(1), mx)
    z2 = z * z
    p = np.full_like(z, F32(dk._ATAN_C[8]))
    for c in reversed(dk._ATAN_C[:8]):
        p = p * z2 + F32(c)
    t = z * p
    t = np.where(a > b, F32(np.pi / 2) - t, t)
    t = np.where(re < 0, F32(np.pi) - t, t)
    t = np.where(im < 0, -t, t)
    return np.where((re == 0) & (im == 0), F32(0), t).astype(F32)


def disc_model(iq, m_if, g, qr, qi, inv_dev, tail, c, e):
    """DiscSrc on ext sample indices ``e`` of channel c: the tail for
    e < hist, else d[e − hist]."""
    C = iq.shape[0] // 2
    hist = tail.shape[1]
    n = e - hist
    out = np.zeros(e.shape, F32)
    out[n < 0] = tail[c, e[n < 0]]
    n = n[n >= 0]

    def x(row, k):
        v = np.zeros(k.shape, F32)
        ok = (k >= 0) & (k < m_if)
        v[ok] = iq[row, k[ok]] * g
        return v
    er, ei = x(c, n), x(C + c, n)
    erp, eip = x(c, n - 1), x(C + c, n - 1)
    erp[n == 0], eip[n == 0] = qr, qi
    re = er * erp + ei * eip
    im = ei * erp - er * eip
    tiny = np.finfo(F32).tiny
    re[np.abs(re) < tiny] = 0
    im[np.abs(im) < tiny] = 0
    out[e >= hist] = atan2_model(im, re) * F32(inv_dev)
    return out


def fm_case(C, m_if, bf16, seed):
    """Kernel arguments in the plain version's form: an FM-like IF with a
    noise floor, a closed gate on every third channel, random tails and
    carried sample (the stride wider than m_if)."""
    pp = pipe()
    rng = np.random.default_rng(seed)
    n = m_if + 37
    dphi = 0.3 * np.sin(np.arange(n) / 15.0) \
        + 0.05 * rng.standard_normal((C, n))
    z = np.exp(1j * np.cumsum(dphi, axis=1)) \
        + 1e-3 * rng.standard_normal((C, n))
    z[:, 5:9] = 0            # a silent stretch: exact zero products
    dt = torch.bfloat16 if bf16 else torch.float32
    iq = torch.from_numpy(np.concatenate([z.real, z.imag])
                          .astype(np.float32)).to(dt)
    gate = torch.from_numpy((np.arange(C) % 3 != 1).astype(np.float32))
    qprev = torch.from_numpy(rng.standard_normal(2 * C).astype(np.float32))
    ftail = torch.from_numpy(
        rng.standard_normal((C, pp.histF)).astype(np.float32))
    ptail = torch.from_numpy(
        rng.standard_normal((C, pp.histP)).astype(np.float32))
    return pp, (pp, iq, m_if, gate, qprev, ftail, ptail, torch.float32,
                torch.float32)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 5000), (3, 2000), (4, 25)],
                         ids=_ids)
def test_disc_staging_model_matches_the_plain_discriminator(shape, bf16):
    C, m_if = shape
    pp, args = fm_case(C, m_if, bf16, C + m_if)
    _, iq, _, gate, qprev, ftail, ptail = args[:7]
    audio, nq, nf, np_, d, u = dk._fm_audio_ref(*args)
    extf = torch.cat([ftail, d], dim=1).numpy()
    iqn = iq.float().numpy()
    p = dk.fm_plan(pp, m_if, C)
    n_u, Kf = p["n_u"], len(pp.hf)
    per = p["fir"]["C"] * 32 * p["fir"]["P"]
    tail_block = min(m_if // per, p["fir"]["grid"][0] - 1)
    for c in range(C):
        args_c = (iqn, m_if, F32(gate[c]), qprev[c].numpy(),
                  qprev[C + c].numpy(), pp.inv_dev, ftail.numpy(), c)
        for bx, (m0, mb) in enumerate(fir_blocks(p, C)):
            e = np.arange(m0, m0 + mb + Kf - 1)
            staged = disc_model(*args_c, e)
            np.testing.assert_array_equal(staged, extf[c, e])
            if bx == tail_block:      # nf: the staged [m_if, m_if + Kf − 1)
                np.testing.assert_array_equal(
                    staged[m_if - m0:m_if - m0 + Kf - 1], nf[c].numpy())
    # the kernel computes u on [0, n_u): past it u is +0 exactly
    rest = u[:, n_u:]
    assert not rest.any() and not torch.signbit(rest).any()
    # the polyphase tail from [ptail | u] at m_if, as ScratchSrc reads it
    extp = torch.cat([ptail, u[:, :n_u]], dim=1)
    assert torch.equal(extp[:, m_if:m_if + pp.histP], np_)
    last = (iq[:, m_if - 1].float() * torch.cat([gate, gate]))
    assert torch.equal(last, nq)


@pytest.mark.parametrize("m_if", [0, -1])
def test_empty_if_block_is_refused(m_if):
    """K7 needs m_if >= 1 (its next-call quad sample is x[m_if − 1]): the
    plain version refuses a shorter block as the kernel's entry does."""
    _, args = fm_case(3, m_if, False, 7)
    with pytest.raises(ValueError, match="at least one sample"):
        dk.fm_audio(*args)


def agc_model(blk, x, amp, env, frozen):
    """csrc/agc.cu's walk in numpy float32, rows at once."""
    atk, one_atk, dec, one_dec, sp, mg = (F32(v) for v in agc._coefs(blk))
    R, T = x.shape
    amp = amp.copy()
    y = np.zeros_like(x)
    tiny = np.finfo(F32).tiny
    lane = np.arange(32)
    for s0 in range(0, T, 32):
        xv = np.zeros((R, 32), F32)
        xv[:, :min(32, T - s0)] = x[:, s0:s0 + 32]
        a = np.full((R, 32), F32(-1))
        if not frozen:
            h = []
            for k in range(32):
                ia = np.abs(xv[:, k])
                va = amp * one_atk + ia * atk
                vd = amp * one_dec + ia * dec
                amp = np.where(ia >= tiny, np.where(ia > amp, va, vd), amp)
                h.append(amp)
            slot = np.stack(h, axis=1)         # [R, 32]: the shared slot
            a = np.where(np.abs(xv) >= tiny, slot[:, lane], a)
        n = s0 + lane
        gain = np.where(a < 0, F32(1), np.minimum(sp / a, mg))
        ramp = np.minimum((env[:, None] + n).astype(F32)
                          / F32(agc.ENVELOPE_LEN), F32(1))
        # the kernel skips the division where the batch starts past the
        # ramp's end
        ramp[env + s0 >= agc.ENVELOPE_LEN] = F32(1)
        yb = (xv * gain) * ramp
        keep = n < T
        y[:, s0:s0 + 32] = yb[:, keep]
    env_out = np.minimum(env.astype(np.int64) + T, agc.ENV_MAX) \
        .astype(np.int32)
    return y, amp, env_out


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("R,T", [(1, 1), (2, 31), (3, 32), (2, 33), (1, 37),
                                 (4, 1500), (4, 2400), (4, 2496)])
def test_agc_walk_model_matches_the_plain_version(R, T, frozen):
    """Zero and subnormal samples (held), the ramp's end and the env cap
    inside the rows."""
    blk = agc.AGC(attack=50 / 24e3, decay=5 / 24e3)
    rng = np.random.default_rng(R * T)
    x = (rng.standard_normal((R, T)) * np.linspace(0.01, 3, T)) \
        .astype(F32)
    x[:, T // 3:T // 3 + 5] = 0.0
    x[:, T // 2] = F32(1e-39)                        # subnormal: held
    amp = rng.uniform(0.01, 1.0, R).astype(F32)
    env = rng.choice(np.array([0, 4000, 4799, 1 << 30], np.int32), R)
    y, a, e = agc_model(blk, x, amp, env, frozen)
    yr, ar, er = agc.agc_rows_ref(blk, torch.from_numpy(x),
                                  torch.from_numpy(amp),
                                  torch.from_numpy(env), frozen)
    np.testing.assert_array_equal(y, yr.numpy())
    np.testing.assert_array_equal(a, ar.numpy())
    np.testing.assert_array_equal(e, er.numpy())
    if frozen:
        np.testing.assert_array_equal(a, amp)
