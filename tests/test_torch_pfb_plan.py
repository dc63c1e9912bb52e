"""K5's plan, its fold's index arithmetic and its split-precision DFT, on
the CPU (csrc/pfb_channelizer.cu runs only on the card).

``channelizer_kernel.pfb_plan`` must cover every frame exactly once
(persistent blocks walking tiles; the warp-specialised kernel for a
one-part matrix), fit the H100's 227 KB of shared memory
a block (and its blocks an SM in the SM's 228 KB), launch >= 132 blocks
wherever the call has 132 tiles, at scanner128/256's and channelizer64's
shapes and every shape the card tests use, and take every geometry the
earlier kernel took.

``fold_model`` runs the kernel's fold loop in numpy: items (branch p,
class c, run of PFB_NF frames), a ring of PFB_NF window registers, taps
in ascending i, whole chunks of PFB_NF taps without a branch; every
(frame, branch, tap) must read s[F·hop + i·M + p] in ascending i, and
every load stay inside the span and its slack.

``split_model`` is the kernel's DFT in torch: the folded frames (the
plain version's, read through an identity matrix) split into three bf16
parts, the host's bf16 parts of [[C, S], [−S, C]], each product of
``MMA_PASSES`` rounded to bf16 operands and summed in float32.  It must
hold >= 100 dB against ``pfb_bins_ref``'s float32 bins at M = 8, 16, 48
and 64, tpp = 19 and 2, both forms, float32 and bf16 taps; where the
matrix is exact in bf16 its host split has one part.

Every patch that ``scripts/chz_mix_sweep.py`` builds on the card
(``--parts`` variants, ``--phases`` stamps) must find its sites in the
committed sources."""

import copy
import functools

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_NFM
from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel as ck
from sdrplusplusbrown_tpu_torch.ops.channelizer import (
    OversampledChannelizer, PolyphaseChannelizer)

from torch_parity import snr_db

SMS, SMEM = 132, 232_448


def scanner_pfb():
    bank = Radio(2.4e6, DEMOD_NFM, squelch_enabled=True,
                 device="cpu")._build_vfo_channelized()
    return bank.pipes()


def path_shapes():
    """[(M, tpp, hop, width)] of the paths and the card tests."""
    pfb, post = scanner_pfb()
    out = [(pfb.M, pfb.tpp, pfb.h, post.plan(240_000 // pfb.h)["Tb_pad"]),
           (pfb.M, pfb.tpp, pfb.h, post.plan(2 * 384 * 30 // 48)["Tb_pad"]),
           (64, 19, 64, (1 << 21) // 64)]
    for M, tf in ((8, 0.2), (16, 2.0), (48, 0.2), (64, 0.2), (64, 2.0)):
        pipe = PolyphaseChannelizer(10e6, M, trans_frac=tf,
                                    device="cpu").pfb()
        out.append((M, pipe.tpp, M, 1000))
    return out


@pytest.mark.parametrize("na", [1, 3])
def test_pfb_plan_covers_fits_and_fills(na):
    for M, tpp, h, W in path_shapes():
        p = ck.pfb_plan(M, tpp, h, W, na)
        assert p["smem"] == ck.pfb_smem(M, tpp, h, p["nt"], p["nbuf"],
                                        2 if p["ws"] else 1)
        assert p["ws"] == (na == 1)
        assert p["smem"] <= SMEM
        assert p["per_sm"] * (p["smem"] + 1024) <= ck.SM_SMEM
        assert p["nt"] % 8 == 0 and p["nt"] // (M // h) % ck.PFB_NF == 0
        count = np.zeros(W, np.int64)
        for b in range(p["grid"]):
            for tile in range(b, p["tiles"], p["grid"]):
                count[tile * p["nt"]:(tile + 1) * p["nt"]] += 1
        assert (count == 1).all(), (M, tpp, h, W)
        assert p["grid"] >= min(SMS, p["tiles"]), (M, tpp, h, W, p)
        assert p["launches"] == 1


def test_pfb_plan_at_the_paths():
    """channelizer64 and scanner128/256: with the bf16 matrix (the bench's
    handoff) the warp-specialised kernel, 32-frame tiles, one span, two
    frame buffers, two blocks an SM; with float32 taps every warp in
    every phase, two spans, one block an SM (96 fragment registers)."""
    for M, tpp, h, W in path_shapes()[:3]:
        p = ck.pfb_plan(M, tpp, h, W, 1)
        assert (p["ws"], p["nt"], p["nbuf"], p["per_sm"]) == (True, 32, 1, 2)
        assert p["grid"] == min(p["tiles"], 2 * SMS)
        p = ck.pfb_plan(M, tpp, h, W, 3)
        assert (p["ws"], p["nt"], p["nbuf"], p["per_sm"]) == (False, 32, 2, 1)


@pytest.mark.parametrize("na", [1, 3])
def test_pfb_plan_reads_in_place_where_no_span_fits(na):
    """M = 8, tpp = 2 381, 2×-oversampled (the largest tpp the earlier
    kernel took there): no input span fits, so either kernel (bf16 taps:
    the warp-specialised one) reads the stream in place, 16 frames a
    tile."""
    p = ck.pfb_plan(8, 2381, 4, 300, na)
    assert (p["ws"], p["nt"], p["nbuf"]) == (na == 1, 16, 0)
    assert p["smem"] <= SMEM
    assert ck.pfb_smem(8, 2381, 4, 16, 1, 2 if na == 1 else 1) > SMEM


def earlier_smem(M, tpp, hop):
    """Shared-memory bytes of the earlier direct-DFT kernel (32 frames a
    block, the span, the frames padded to M + 1, cos, sin and the taps)."""
    span = 31 * hop + tpp * M
    return 4 * (2 * span + 2 * 32 * (M + 1) + 2 * M * M + M * tpp)


def test_pfb_plan_takes_every_geometry_the_earlier_kernel_took():
    for M in range(2, 65, 2):
        for hop in (M // 2, M):
            tpp = 2
            while earlier_smem(M, tpp + 1, hop) <= SMEM:
                tpp += 1
            for t in (2, 3, tpp // 2, tpp):
                for na in (1, 3):
                    if t >= 2:
                        assert ck.pfb_plan(M, t, hop, 1000, na)["smem"] \
                            <= SMEM


def fold_model(M, tpp, h, nt):
    """({(local frame, branch): [(i, span index)]}, the largest span index
    loaded) of the kernel's fold on one tile of ``nt`` frames: whole
    chunks of PFB_NF taps (every slot reloaded), then the rest."""
    Rt, NF = M // h, ck.PFB_NF
    runs = nt // Rt // NF
    out, top = {}, 0
    for item in range(M * Rt * runs):
        p, rest = item % M, item // M
        c, Gl = rest % Rt, (rest // Rt) * NF
        base = Gl * M + c * h + p
        w = [base + f * M for f in range(NF)]
        top = max(top, *w)

        def tap(i, ii, reload):
            for f in range(NF):
                out.setdefault((Rt * (Gl + f) + c, p), []).append(
                    (i, w[(f + ii) % NF]))
            if reload:
                w[ii] = base + (i + NF) * M
        i0 = 0
        while i0 + NF <= tpp:
            for ii in range(NF):
                tap(i0 + ii, ii, True)
            i0 += NF
        for ii in range(NF):
            if i0 + ii >= tpp:
                break
            tap(i0 + ii, ii, i0 + ii + 1 < tpp)
        top = max(top, *w)
    return out, top


@pytest.mark.parametrize("M,tpp,h", [(48, 6, 24), (64, 19, 64), (8, 19, 8),
                                     (16, 2, 16), (16, 5, 8), (8, 3, 4)])
@pytest.mark.parametrize("nt", [16, 32])
def test_fold_model_reads_each_tap_in_order(M, tpp, h, nt):
    reads, top = fold_model(M, tpp, h, nt)
    assert sorted(reads) == [(f, p) for f in range(nt) for p in range(M)]
    span = (nt - 1) * h + tpp * M
    for (f, p), seq in reads.items():
        assert [i for i, _ in seq] == list(range(tpp))
        assert [s for _, s in seq] == [f * h + i * M + p
                                       for i in range(tpp)]
        assert max(s for _, s in seq) < span
    # loads past the span (a whole chunk's last reloads) stay in its slack
    SC = (((nt - 1) * h + tpp * M + M + 3) & ~3) + 4
    assert top < span + M and 3 + top < SC


def identity_pipe(pipe):
    p = copy.copy(pipe)
    p.cos = np.eye(pipe.M, dtype=np.float32)
    p.sin = np.zeros((pipe.M, pipe.M), np.float32)
    p._dev = {}
    return p


def split_model(pipe, xr, xi, xwr, xwi, W, tdt):
    """The kernel's bins [2M, W] float32 (see the module docstring)."""
    M = pipe.M
    v = ck.pfb_bins_ref(identity_pipe(pipe), xr, xi, xwr, xwi, W, tdt,
                        torch.float32)
    sign = torch.ones(2 * M, W)
    if not pipe.critical:       # (−1)^m on even frames, undone and redone
        odd = (torch.arange(2 * M) % M) % 2 == 1
        sign[odd[:, None] & (torch.arange(W) % 2 == 0)[None]] = -1.0
    v = v * sign
    parts, na = pipe.dft_parts("cpu", tdt)
    KP = parts.shape[-1]
    vp = torch.zeros(KP, W)
    vp[:2 * M] = v
    b = ck.split_bf16(vp)
    out = torch.zeros(KP, W)
    for ia, ib in ck.MMA_PASSES[na]:
        out = out + parts[ia].float() @ b[ib].float()
    return out[:2 * M] * sign


def pipes():
    out = []
    rng = np.random.default_rng(5)
    for M in (8, 16, 48, 64):
        for tf, tpp in ((0.2, 19), (2.0, 2)):
            crit = PolyphaseChannelizer(10e6, M, trans_frac=tf,
                                        device="cpu").pfb()
            assert crit.tpp == tpp
            out.append((f"critical M={M} tpp={tpp}", crit))
            proto = np.hanning(tpp * M + 2)[1:-1] * (
                1 + 0.1 * rng.standard_normal(tpp * M))
            over = OversampledChannelizer(1e6, M, proto).pfb()
            assert over.tpp == tpp
            out.append((f"oversampled M={M} tpp={tpp}", over))
    return out


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["float32 taps", "bf16 taps"])
@pytest.mark.parametrize("label,pipe", pipes(), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_split_dft_holds_100db(label, pipe, tdt):
    M = pipe.M
    rng = np.random.default_rng(M + pipe.tpp)
    T = M * 40
    xr, xi, xwr, xwi = (torch.from_numpy(
        (0.1 * rng.standard_normal(n)).astype(np.float32))
        for n in (T, T, pipe.n_hist, pipe.n_hist))
    W = T // pipe.h + 3
    want = ck.pfb_bins_ref(pipe, xr, xi, xwr, xwi, W, tdt, torch.float32)
    got = split_model(pipe, xr, xi, xwr, xwi, W, tdt)
    db = snr_db(want.numpy(), got.numpy())
    assert db >= 100.0, (label, db)


@pytest.mark.parametrize("M", [8, 16, 48, 64])
def test_host_split_of_the_dft_matrix(M):
    """bf16 taps: the matrix is exact in bf16, its split one part (the lo
    parts zero); float32 taps: three parts summing to it exactly."""
    pipe = PolyphaseChannelizer(10e6, M, device="cpu").pfb()
    KP = -(-2 * M // 16) * 16
    for tdt, want_na in ((torch.bfloat16, 1), (torch.float32, 3)):
        parts, na = pipe.dft_parts("cpu", tdt)
        assert na == want_na and parts.shape == (na, KP, KP)
        assert parts.dtype == torch.bfloat16
        _, cm, sm = pipe.operands("cpu", tdt)
        A = torch.zeros(KP, KP, dtype=torch.float64)
        A[:2 * M, :2 * M] = ck.dft_matrix(cm, sm).double()
        full = ck.split_bf16(A.float())
        if na == 1:
            assert not full[1].float().any() and not full[2].float().any()
        assert torch.equal(parts.double().sum(0), A)


def sweep_module():
    """scripts/chz_mix_sweep.py as a module (it imports no torch at the
    top)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "chz_mix_sweep.py")
    spec = importlib.util.spec_from_file_location("chz_mix_sweep", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", [n for _, n, _ in sweep_module().patch_sets()])
def test_sweep_patch_sites_are_in_the_sources(name):
    """Every patch that ``chz_mix_sweep.py --parts`` and ``--phases`` build
    on the card finds its sites in the committed K11 and K5 sources."""
    import os
    from sdrplusplusbrown_tpu_torch.kernels import _build
    sweep = sweep_module()
    (src, subs), = [(f, s) for f, n, s in sweep.patch_sets() if n == name]
    with open(os.path.join(_build.CSRC, src)) as fh:
        text = fh.read()
    assert sweep.patched(text, subs, name) != text


@functools.lru_cache(maxsize=None)
def bank_pfbs():
    """[(label, pipe, width)]: the channelized banks' PFBs at 2.4 MS/s
    above M = 64 (AM 160, USB and DSB 100, CW 800) at 0.1 s, and the
    critical form at M = 128 (2^21 samples at 10 MS/s)."""
    from sdrplusplusbrown_tpu_torch.models.radio import (DEMOD_AM, DEMOD_CW,
                                                         DEMOD_DSB,
                                                         DEMOD_USB)
    out = []
    for d in (DEMOD_AM, DEMOD_USB, DEMOD_DSB, DEMOD_CW):
        pfb, post = Radio(2.4e6, d, device="cpu")._build_vfo_channelized() \
            .pipes()
        out.append((f"oversampled M={pfb.M}", pfb,
                    post.plan(2 * 243_200 // pfb.M)["Tb_pad"]))
    crit = PolyphaseChannelizer(10e6, 128, device="cpu").pfb()
    out.append(("critical M=128", crit, (1 << 21) // 128))
    return out


def bank_rows(M, seed):
    """A bank's row list [bin | M + bin] of 16 bins at M: bins 0 and
    M − 1, a duplicate, odd and even bins."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, M, 16)
    b[:4] = [0, M - 1, 1, 1]
    b = torch.from_numpy(b.astype(np.int32))
    return torch.cat([b, b + M])


@pytest.mark.parametrize("na", [1, 3])
def test_pfb_plan_large_m_at_the_banks(na):
    """Above M = 64 either matrix takes the large-M kernel, at the banks'
    0.1 s widths and the critical M = 128, on a bank's 32 gathered rows
    and on every row: its shared memory (``pfb_big_smem``, two blocks an
    SM counted with the SM's share) fits; the tiles hold every valid
    frame and no tile past them; the row groups hold every row; wgmma
    from 128 rows (nt 64, 256 rows a block), mma.sync under them; and, on
    a bank's rows and the critical form, the blocks fill the 132 SMs, or
    the plan is the most blocks mma.sync makes (16 frames by 16 rows).
    (Every row of a bank, its C >= M case, takes wgmma's fixed tiles.)"""
    for label, pipe, W in bank_pfbs():
        M, h = pipe.M, pipe.h
        V = (1 << 21) // M if pipe.critical else 2 * 243_200 // M
        for R in ((2 * M,) if pipe.critical else (32, 2 * M)):
            p = ck.pfb_plan(M, pipe.tpp, h, W, na, R, V)
            assert p["big"] and not p["ws"], label
            assert p["wg"] == (R >= ck.PFB_WG_ROWS), (label, R)
            assert p["smem"] == ck.pfb_big_smem(
                M, pipe.tpp, h, p["nt"], p["kc"], p["rbp"], na,
                p["staged"], p["wg"], p["ring"], p["threads"]) <= SMEM, \
                (label, R)
            assert p["per_sm"] * (p["smem"] + 1024) <= ck.SM_SMEM
            assert p["nt"] // (M // h) % ck.PFB_NF == 0
            assert (p["tiles"] - 1) * p["nt"] < V <= p["tiles"] * p["nt"]
            assert p["tiles"] * p["nt"] <= W
            assert (p["rgroups"] - 1) * p["rbp"] < R <= \
                p["rgroups"] * p["rbp"]
            assert p["kc"] >= 16 and p["kc"] & (p["kc"] - 1) == 0
            if p["wg"]:
                assert (p["nt"], p["rbp"], p["kc"]) == (
                    64, 256, 64 if na == 1 else 16)
            else:
                assert p["rbp"] in (16, 32)
                assert p["rbp"] // 16 * (p["nt"] // 8) <= 32
            assert p["blocks"] == p["tiles"] * p["rgroups"]
            assert p["threads"] == (512 if not p["wg"] and p["blocks"] <= SMS
                                    else 256)
            if R == 32 or pipe.critical:    # a bank's rows; the critical
                assert p["blocks"] >= ck.SMS or \
                    (p["nt"], p["rbp"]) == (16, 16), (label, R, p)
                assert p["staged"], (label, R)
    assert not ck.pfb_plan(64, 19, 64, 1000, 1)["big"]


@pytest.mark.parametrize("idx", range(5), ids=["am160", "usb100", "dsb100",
                                                "cw800", "critical128"])
def test_plain_rows_are_the_full_planes_rows(idx):
    """``pfb_bins_ref`` with a row list is the full plane's rows bit for
    bit, at M = 100, 160, 800 and the critical 128: duplicate bins, bins 0
    and M − 1, odd bins on even frames (the oversampled form's sign), both
    output dtypes."""
    label, pipe, _ = bank_pfbs()[idx]
    rng = np.random.default_rng(pipe.M + 1)
    T = pipe.M * 12
    x = tuple(torch.from_numpy((0.1 * rng.standard_normal(n)).astype(
        np.float32)) for n in (T, T, pipe.n_hist, pipe.n_hist))
    W = T // pipe.h + 5
    rows = bank_rows(pipe.M, pipe.M)
    for odt in (torch.float32, torch.bfloat16):
        full = ck.pfb_bins_ref(pipe, *x, W, torch.float32, odt)
        got = ck.pfb_bins_ref(pipe, *x, W, torch.float32, odt, rows)
        assert got.shape == (32, W) and got.dtype == odt
        assert torch.equal(got, full[rows.long()]), label
    if not pipe.critical:   # bin 1 (odd) carries the sign on even frames
        ident = ck.pfb_bins_ref(identity_pipe(pipe), *x, W, torch.float32,
                                torch.float32, rows)[2].double()
        s_ = torch.cat([x[2], x[0], torch.zeros(W * pipe.h)]).double()
        br = torch.from_numpy(pipe.branches).double()
        v = torch.stack([sum(br[1, i] * s_[F * pipe.h + i * pipe.M + 1]
                             for i in range(pipe.tpp)) for F in range(W)])
        sign = torch.where(torch.arange(W) % 2 == 0, -1.0, 1.0).double()
        assert torch.allclose(ident, sign * v, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError):
        ck.pfb_bins_ref(pipe, *x, W, torch.float32, torch.float32,
                        rows.long())


def big_model(pipe, xr, xi, xwr, xwi, W, tdt, group: int = 1):
    """The large-M kernel's bins [2M, W] float32: ``split_model``'s
    products, summed apart for each group of ``group`` 16-wide k-steps
    (its accumulator of one k-step on mma.sync, of a chunk's kc / 16 on
    wgmma: the k-steps in order, each k-step's MMA_PASSES) and the
    groups' sums added in float32, ascending."""
    M = pipe.M
    v = ck.pfb_bins_ref(identity_pipe(pipe), xr, xi, xwr, xwi, W, tdt,
                        torch.float32)
    sign = torch.ones(2 * M, W)
    if not pipe.critical:
        odd = (torch.arange(2 * M) % M) % 2 == 1
        sign[odd[:, None] & (torch.arange(W) % 2 == 0)[None]] = -1.0
    v = v * sign
    parts, na = pipe.dft_parts("cpu", tdt)
    KP = parts.shape[-1]
    vp = torch.zeros(KP, W)
    vp[:2 * M] = v
    b = ck.split_bf16(vp)
    out = torch.zeros(KP, W)
    for k0 in range(0, KP, 16 * group):
        e = torch.zeros(KP, W)
        for k in range(k0, min(KP, k0 + 16 * group), 16):
            for ia, ib in ck.MMA_PASSES[na]:
                e = e + parts[ia][:, k:k + 16].float() @ \
                    b[ib][k:k + 16].float()
        out = out + e
    return out[:2 * M] * sign


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["float32 taps", "bf16 taps"])
@pytest.mark.parametrize("idx", range(5), ids=["am160", "usb100", "dsb100",
                                                "cw800", "critical128"])
def test_big_kernel_sum_holds_100db(idx, tdt):
    """``big_model`` against ``pfb_bins_ref``'s float32 bins at the banks'
    geometries, 24 frames: >= 100 dB."""
    label, pipe, _ = bank_pfbs()[idx]
    rng = np.random.default_rng(pipe.M)
    T = pipe.h * 24
    xr, xi, xwr, xwi = (torch.from_numpy(
        (0.1 * rng.standard_normal(n)).astype(np.float32))
        for n in (T, T, pipe.n_hist, pipe.n_hist))
    want = ck.pfb_bins_ref(pipe, xr, xi, xwr, xwi, 24, tdt, torch.float32)
    got = big_model(pipe, xr, xi, xwr, xwi, 24, tdt)
    db = snr_db(want.numpy(), got.numpy())
    assert db >= 100.0, (label, db)


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["float32 taps", "bf16 taps"])
@pytest.mark.parametrize("idx", range(5), ids=["am160", "usb100", "dsb100",
                                                "cw800", "critical128"])
def test_wgmma_sum_at_the_plans_chunk_holds_100db(idx, tdt):
    """On every row (the wgmma route) a chunk's kc / 16 k-steps share one
    accumulator: ``big_model`` at the plan's chunk against
    ``pfb_bins_ref``'s float32 bins, 24 frames: >= 100 dB."""
    label, pipe, W = bank_pfbs()[idx]
    na = pipe.dft_parts("cpu", tdt)[1]
    p = ck.pfb_plan(pipe.M, pipe.tpp, pipe.h, W, na)
    assert p["wg"]
    rng = np.random.default_rng(pipe.M + 2)
    T = pipe.h * 24
    xr, xi, xwr, xwi = (torch.from_numpy(
        (0.1 * rng.standard_normal(n)).astype(np.float32))
        for n in (T, T, pipe.n_hist, pipe.n_hist))
    want = ck.pfb_bins_ref(pipe, xr, xi, xwr, xwi, 24, tdt, torch.float32)
    got = big_model(pipe, xr, xi, xwr, xwi, 24, tdt, p["kc"] // 16)
    db = snr_db(want.numpy(), got.numpy())
    assert db >= 100.0, (label, p["kc"], db)


def ab_module():
    """scripts/pfb_big_ab.py as a module."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "pfb_big_ab.py")
    spec = importlib.util.spec_from_file_location("pfb_big_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", [n for n, _ in ab_module().patch_sets()])
def test_big_ab_patch_sites_are_in_the_source(name):
    """Every variant that ``pfb_big_ab.py --parts`` and ``--phases`` build
    on the card finds its sites in the committed large-M kernel."""
    import os
    from sdrplusplusbrown_tpu_torch.kernels import _build
    ab = ab_module()
    subs, = [s for n, s in ab.patch_sets() if n == name]
    with open(os.path.join(_build.CSRC, "pfb_channelizer.cu")) as fh:
        text = fh.read()
    assert ab.patched(text, subs, name) != text
