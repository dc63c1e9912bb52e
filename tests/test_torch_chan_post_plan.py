"""K6's plan, staging and two launches on the CPU (csrc/chan_post.cu runs
only on the card).

``chan_frontend.chan_post_plan`` sizes K6's two launches on the FIR tile:
the 2:1 FIR (d2) with the bin gather and the NCO in its staging, y1
through an HBM scratch, then the 304-tap bandwidth FIR.  Each launch must
cover every output of every channel once, fit the H100's 227 KB a block
(the bandwidth launch's 128-byte squelch scratch beside the tile's), and
launch >= 132 blocks at scanner128, scanner256 and the card tests'
shapes; each channel's tails are written by its first block of each
launch, from samples its stage's staging hook computes.

``z_model`` mirrors the d2 launch's staging hook (ZSrc): the carried tail
for ext0 index e < K1 − 1, else bin ``bin[c]`` gathered at n = e − K1 + 1
and rotated, the NCO's angle ((ph0 + span·i) + bs·b) + ω·j formed one
float32 rounding an operation from n = i·adv0 + 128·b + j (``nco_model``,
which must equal ``nco_phase`` bit for bit), the rotate's two products
and their sum rounded apart.  sin and cos are torch's on the whole
[C, Tb_pad] angle array, as in the plain version (torch's CPU cos and sin
can round an element differently with its place in a shorter array; the
card's sincosf is held against them there).
Staged block by block as the plan's grid stages it, it must equal
``_chan_post_ref``'s z bit for bit, float32 and bf16 bins alike.

``post_model`` runs both launches on ``tile_model``
(tests/test_torch_fir_plan.py, the tile's schedule in numpy) with the
hooks' reads (ZSrc, then [fir tail | y1]), the tails each row's first
block writes and the squelch partials in the store hook's and the
block's reduction order; on integer data it equals ``chan_post_ref``
exactly."""

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_NFM
from sdrplusplusbrown_tpu_torch.ops import chan_frontend as cf
from sdrplusplusbrown_tpu_torch.ops import fir_kernel
from sdrplusplusbrown_tpu_torch.ops.precision import round_to

from test_torch_fir_plan import tile_model

SMS, SMEM = 132, 232_448
F32 = np.float32
SCAN_TB = 10_000          # bin frames of a 0.1 s scanner block (M = 48)

# (C, Tb): scanner128, scanner256, the scanner slice's C = 16 and the card
# tests' C = 8 and odd C = 5 (tests/test_torch_cuda.py), all at the
# scanner block
PATH_SHAPES = [(128, SCAN_TB), (256, SCAN_TB)]
CARD_SHAPES = [(8, SCAN_TB), (5, SCAN_TB), (16, SCAN_TB)]
# short calls: m1 = n_out (Tb a multiple of 2·adv_f), one output chunk, a
# call shorter than the d2 tail
OTHER_SHAPES = [(3, 2048), (2, 2000), (1, 600), (4, 10)]


def bank():
    return Radio(2.4e6, DEMOD_NFM, squelch_enabled=True,
                 device="cpu")._build_vfo_channelized()


def post_pipe():
    return bank().pipes()[1]


def _ids(shape):
    return "C{}-Tb{}".format(*shape)


def blocks(g: dict):
    """A launch's blocks of one row: (bx, m0, mb)."""
    per = g["C"] * 32 * g["P"]
    for bx in range(g["grid"][0]):
        m0 = bx * per
        yield bx, m0, min(per, g["n_m"] - m0)


@pytest.mark.parametrize("shape", PATH_SHAPES + CARD_SHAPES + OTHER_SHAPES,
                         ids=_ids)
def test_plan_covers_every_output_once_and_fits(shape):
    C, Tb = shape
    pp = post_pipe()
    p = cf.chan_post_plan(pp, Tb, C)
    geo = pp.plan(Tb)
    n_out, m1 = geo["n_out"], geo["m"][1]
    assert p["launches"] == 2 and p["n1"] == n_out
    assert p["n_tiles"] == p["fir"]["grid"][0]
    for name, D, kw, n, Ps in (
            ("d2", 2, len(pp.taps[0]), p["n1"], (5, 3, 1)),
            ("fir", 1, len(pp.taps[1]), n_out, (7, 5, 3, 1))):
        g = p[name]
        P, Cc, W = g["P"], g["C"], g["warps"]
        assert P in Ps and g["G"] == 1 and Cc >= 1 and 4 <= W <= 8
        assert g["n_m"] == n and g["grid"][1:] == (1, C)
        assert g["blocks"] == np.prod(g["grid"])
        assert g["smem"] == fir_kernel.tile_smem(D, kw, n, P, 1, Cc, 2)
        assert g["smem"] + 4 * 32 <= SMEM
        hits = np.zeros(n, int)
        for _, m0, mb in blocks(g):
            assert mb >= 1
            units = [u for w in range(W) for u in range(w, Cc, W)]
            assert sorted(units) == list(range(Cc))
            for u in units:
                mm = u * 32 * P + np.arange(32 * P)
                hits[m0 + mm[mm < mb]] += 1
        assert (hits == 1).all(), name
    # the d2 launch stages ext0 up to 2·(n1 − 1) + K1 − 1 < K1 − 1 + Tb_pad
    # (bins in range); each tail's samples, which the row's first block
    # computes through its hook, lie in what the hook can read
    h1, h2 = pp.hists
    assert 2 * (p["n1"] - 1) + h1 < h1 + geo["Tb_pad"]
    assert Tb + h1 - 1 < h1 + geo["Tb_pad"] and m1 + h2 - 1 < h2 + p["n1"]


@pytest.mark.parametrize("shape", PATH_SHAPES + CARD_SHAPES, ids=_ids)
def test_plan_fills_the_card(shape):
    C, Tb = shape
    p = cf.chan_post_plan(post_pipe(), Tb, C)
    for name in ("d2", "fir"):
        assert p[name]["blocks"] >= SMS, (name, p[name])


def post_case(C, Tb, bins_dt, seed, integer=False):
    """(pipe, kernel arguments) of a scanner bank's K6 call: bench.py's
    offsets (both band edges, two channels beside DC), seeded phases and
    tails, bins noise; or with ``integer``, small integers everywhere and
    the NCO at rest (integer taps on a copy of the pipe)."""
    bk = bank()
    pp = bk.pipes()[1]
    offs = np.linspace(-1.1e6, 1.1e6, C) + 917.0
    if C >= 4:
        offs[C // 2 - 1:C // 2 + 1] = [-30e3, 10e3]
    params = bk.make_params(offs)
    rng = np.random.default_rng(seed)
    W = pp.plan(Tb)["Tb_pad"]
    if integer:
        pp.taps = [rng.integers(-3, 4, len(t)).astype(F32)
                   for t in pp.taps]
        pp.taps[1][:7] = 0.0                 # a band: the first taps zero
        pp._dev = {}
        bins = rng.integers(-7, 8, (2 * pp.M, W)).astype(F32)
        tails = [torch.from_numpy(rng.integers(-7, 8, (2 * C, h))
                                  .astype(F32)) for h in pp.hists]
        zero = torch.zeros(C)
        nco = (zero, zero, zero, zero)
    else:
        bins = rng.standard_normal((2 * pp.M, W)).astype(F32)
        tails = [round_to(torch.from_numpy(rng.standard_normal((2 * C, h))
                                           .astype(F32)), bins_dt)
                 for h in pp.hists]
        a_sup, rem = divmod(pp.adv0, cf.SPAN)
        span = params["xl_sup"] * a_sup + params["xl_bs"] * (rem // cf.BS)
        ph0 = torch.from_numpy(rng.uniform(-np.pi, np.pi, C).astype(F32))
        nco = (params["xl"]["omega"], ph0, span, params["xl_bs"])
    om, ph0, span, sbs = nco
    args = (pp, torch.from_numpy(bins).to(bins_dt), params["bin"], om, ph0,
            span, sbs, tails, Tb, torch.float32, bins_dt)
    return pp, args


def nco_model(args) -> np.ndarray:
    """ZSrc's NCO angles [C, Tb_pad] in numpy float32: n = i·adv0 + 128·b
    + j, ((ph0 + span·i) + bs·b) + ω·j, each operation rounded."""
    pp, bins, _, om, ph0, span, sbs = args[:7]
    n = np.arange(bins.shape[1])
    i, r = np.divmod(n, pp.adv0)
    bb, jj = np.divmod(r, cf.BS)
    w, p0, sp, bs = (v.numpy().astype(F32)[:, None]
                     for v in (om, ph0, span, sbs))
    ang = ((p0 + sp * i.astype(F32)) + bs * bb.astype(F32)) \
        + w * jj.astype(F32)
    assert ang.dtype == F32
    return ang


_ROTOR: dict = {}


def rotor(args) -> tuple:
    """(cos, sin) of ``nco_model``'s angles, kept for the call's bins."""
    bins = args[1]
    if _ROTOR.get("bins") is not bins:
        ang = torch.from_numpy(nco_model(args))
        _ROTOR.update(bins=bins, cs=(torch.cos(ang).numpy(),
                                     torch.sin(ang).numpy()))
    return _ROTOR["cs"]


def z_model(args, c: int, e: np.ndarray) -> np.ndarray:
    """ZSrc on ext0 indices ``e`` of channel c (complex128 holding the
    float32 parts): the d2 tail for e < K1 − 1, else z[e − K1 + 1]."""
    pp, bins, bin_idx, om, ph0, span, sbs, tails, Tb = args[:9]
    C, hist = om.shape[0], pp.hists[0]
    t = tails[0].numpy()
    b = bins.float().numpy()
    out = np.zeros(e.shape, np.complex128)
    old = e < hist
    out[old] = t[c, e[old]] + 1j * t[C + c, e[old]]
    n = e[~old] - hist
    co, s = (v[c, n] for v in rotor(args))
    k = int(bin_idx[c])
    xr, xi = b[k, n], b[pp.M + k, n]
    re, im = xr * co - xi * s, xr * s + xi * co
    assert re.dtype == F32 and im.dtype == F32
    out[~old] = re.astype(np.float64) + 1j * im.astype(np.float64)
    return out


@pytest.mark.parametrize("bins_dt", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
@pytest.mark.parametrize("shape", [(4, SCAN_TB), (3, 2048), (1, 600)],
                         ids=_ids)
def test_staging_model_matches_the_plain_z(shape, bins_dt):
    C, Tb = shape
    pp, args = post_case(C, Tb, bins_dt, C + Tb)
    np.testing.assert_array_equal(
        nco_model(args), cf.nco_phase(pp, *args[3:7], args[1].shape[1]))
    z = cf._chan_post_ref(*args)[3]
    t = args[7][0]
    ext0 = torch.cat([torch.complex(t[:C], t[C:]), z], dim=1).numpy()
    g = cf.chan_post_plan(pp, Tb, C)["d2"]
    K1 = len(pp.taps[0])
    for c in range(C):
        for _, m0, mb in blocks(g):
            e = np.arange(2 * m0, 2 * m0 + 2 * (mb - 1) + K1)
            np.testing.assert_array_equal(z_model(args, c, e), ext0[c, e])
        # the d2 tail's samples, ext0[Tb, Tb + K1 − 1), as its writer reads
        e = Tb + np.arange(K1 - 1)
        np.testing.assert_array_equal(z_model(args, c, e), ext0[c, e])


def squelch_partials(mag, g) -> np.ndarray:
    """The store hook's and the block's float32 reduction of |y| over one
    row's valid outputs (``mag``, zero past m_out): thread t sums outputs
    t, t + nth, ... of its block in order, the warps reduce by shuffles
    (lane l += lane l + off, off = 16 ... 1), thread 0 adds the warps'."""
    nth = 32 * g["warps"]
    out = []
    for _, m0, mb in blocks(g):
        acc = np.zeros(nth, F32)
        for i in range(mb):
            acc[i % nth] += mag[m0 + i]
        acc = acc.reshape(-1, 32)
        for off in (16, 8, 4, 2, 1):
            acc[:, :32 - off] += acc[:, off:]
        tot = F32(0)
        for v in acc[:, 0]:
            tot += v
        out.append(tot)
    return np.array(out, F32)


def post_model(args, plan):
    """Both launches on ``tile_model``: (out [2C, n_out], the squelch
    partials [C, n_tiles], tails [d2, fir] as [2C, hist] planes, y1
    [C, n_out])."""
    pp, bins, bin_idx, om = args[:4]
    tails, Tb = args[7], args[8]
    C = om.shape[0]
    geo = pp.plan(Tb)
    h1, h2 = pp.hists
    K1, K2 = len(pp.taps[0]), len(pp.taps[1])
    W0 = 2 * (plan["n1"] - 1) + K1            # the ext0 samples y1 reads
    ext0 = np.stack([z_model(args, c, np.arange(W0)) for c in range(C)])
    y1 = tile_model(ext0, pp.taps[0][None], 1, 2, plan["d2"])
    t = tails[1].numpy()
    ext1 = np.concatenate([t[:C] + 1j * t[C:], y1], axis=1)
    y = tile_model(ext1, pp.taps[1][None], 1, 1, plan["fir"])
    out = np.concatenate([y.real, y.imag]).astype(F32)
    yr, yi = out[:C, :geo["m"][-1]], out[C:, :geo["m"][-1]]
    mag = np.sqrt(yr * yr + yi * yi)
    sq = np.stack([squelch_partials(
        np.pad(m, (0, geo["n_out"] - m.size)), plan["fir"]) for m in mag])
    d2_tail = np.stack([z_model(args, c, Tb + np.arange(h1))
                        for c in range(C)])
    m1 = geo["m"][1]
    fir_tail = ext1[:, m1:m1 + h2]
    return (out, sq, [np.concatenate([v.real, v.imag]).astype(F32)
                      for v in (d2_tail, fir_tail)], y1)


@pytest.mark.parametrize("P", [7, 5, 3, 1])
@pytest.mark.parametrize("shape", [(3, 2048), (2, 2000), (1, 600), (4, 10)],
                         ids=_ids)
def test_two_launch_model_equals_the_plain_version_on_integers(shape, P):
    """Integer bins, taps and tails with the NCO at rest: every sum is
    exact in float32, so the model of both launches (at the plan's own
    grids, and at each P with two chunks a block) equals ``chan_post_ref``
    bit for bit: the IF, y1, both tails; the squelch sums to 1e-6."""
    C, Tb = shape
    pp, args = post_case(C, Tb, torch.float32, 7 * C + Tb, integer=True)
    out, sq, tails, _, y1 = cf._chan_post_ref(*args)
    own = cf.chan_post_plan(pp, Tb, C)
    n = own["n1"]
    n_c = -(-n // (32 * P))
    grid = {"P": P, "G": 1, "C": 2, "warps": 4, "n_m": n,
            "grid": (-(-n_c // 2), 1, C)}
    for plan in (own, dict(own, d2=grid, fir=grid,
                           n_tiles=grid["grid"][0])):
        m_out, m_sq, m_tails, m_y1 = post_model(args, plan)
        np.testing.assert_array_equal(m_out, out.numpy())
        np.testing.assert_array_equal(m_y1, y1.numpy())
        for got, want in zip(m_tails, tails):
            np.testing.assert_array_equal(got, want.numpy())
        assert m_sq.shape == (C, plan["n_tiles"])
        np.testing.assert_allclose(m_sq.astype(np.float64).sum(-1),
                                   sq.numpy(), rtol=1e-6)


@pytest.mark.parametrize("shape", PATH_SHAPES + CARD_SHAPES[:2], ids=_ids)
def test_chip_smoke_holds_k6_to_its_plan(shape):
    """chip_smoke.py holds K6's wrapper count over a main-path run to its
    calls' planned CUDA launches (two a call, ``chan_post_plan``'s) and
    its bound stays the operations' (the 304-tap stage)."""
    from torch_parity import _chip_smoke
    smoke = _chip_smoke()
    C, Tb = shape
    pp, args = post_case(C, Tb, torch.bfloat16, 3)
    assert smoke.planned_launches("K6", args) == \
        cf.chan_post_plan(pp, Tb, C)["launches"] == 2
    assert smoke.PLANNERS["K6"] == ("chan_post_plan", ("post_d2_kernel",
                                                       "post_fir_kernel"))
    ms, by = smoke.bound("K6", args)
    assert by == "operations" and ms > 0


def block_step_model(b: np.ndarray, q: int) -> np.ndarray:
    """ZSrc::rotate's i = b // q (b = n // 128, q = adv0 // 128): the
    float32 product with the rounded reciprocal, truncated, then one
    correction step either way."""
    rq = F32(1) / F32(q)
    i = (b.astype(F32) * rq).astype(np.int64)        # truncates (b >= 0)
    i -= i * q > b
    i += (i + 1) * q <= b
    return i


@pytest.mark.parametrize("q", range(1, 33))
def test_nco_block_index_is_exact(q):
    """Every 128-sample block index b < 2^17 (Tb_pad <= 2^24, which the
    d2 entry point requires) and every step of q blocks up to 4 096 bin
    samples: the kernel's reciprocal division equals b // q."""
    b = np.arange(1 << 17)
    np.testing.assert_array_equal(block_step_model(b, q), b // q)
