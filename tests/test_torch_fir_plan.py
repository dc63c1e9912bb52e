"""The polyphase FIR tile's plan and index arithmetic, on the CPU
(csrc/fir_tile.cuh, the body of K3 and K8, runs only on the card).

``fir_plan`` must cover every output of every row exactly once, fit the
H100's 227 KB of shared memory a block and launch >= 132 blocks wherever
the call has that many warps of outputs, at every geometry the paths give
K3 and K8 and every shape the card tests use.  ``tile_model`` runs the
kernel's schedule in numpy: the input staged de-interleaved by input
phase into the layout ``tile_smem`` sizes (unstaged slots NaN), each phase
row's nonzero band found from its taps, each warp's (phase row, chunk)
units, each lane's P consecutive outputs over the band in ascending tap
order (through the register ring at D = 1, 2 and 4), complex rows as one
sample of two parts, and the output tile written in order of y.  In float64 it agrees with ``poly_rows``'s
correlation to 1e-12; on integer data with float32 ``poly_rows`` itself,
exactly."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
from sdrplusplusbrown_tpu_torch.ops import fir_kernel
from sdrplusplusbrown_tpu_torch.ops.resampler import RationalResampler

SMS, SMEM = 132, 232_448


def resampler_kernel(fs_in: float, fs_out: float) -> np.ndarray:
    return dict(RationalResampler(fs_in, fs_out).chain.named_blocks)[
        "resamp"].kernel


def folded_audio_kernel() -> np.ndarray:
    """WFM's de-emphasis-folded 48/125 audio kernel (K3's)."""
    return Radio(2.4e6, DEMOD_WFM, device="cpu").demod.audio_poly.kernel


def row_bands(kern) -> tuple:
    """(lo, hi) of each phase row: first nonzero tap, last + 1; (kw, 0)
    for an all-zero row (the kernel's warp reduction)."""
    kw = kern.shape[1]
    lo = np.full(kern.shape[0], kw)
    hi = np.zeros(kern.shape[0], int)
    for r, row in enumerate(kern):
        nz = np.flatnonzero(row)
        if nz.size:
            lo[r], hi[r] = nz[0], nz[-1] + 1
    return lo, hi


# (I, D, kw, n_out, rows, comps): every K3 and K8 geometry of the paths
# (app WFM () and (8,), NFM (), multimode8 at 2.4 and 10 MS/s, WFM-8's
# K3), other polyphase ratios the resamplers give, and the plane decimator
PATH_GEOMETRIES = [
    (1, 4, 304, 60_000, 1, 2), (1, 4, 304, 60_000, 8, 2),
    (1, 1, 253, 50_000, 1, 2), (1, 1, 253, 50_000, 8, 2),
    (5, 6, 97, 50_000, 1, 2), (5, 6, 97, 50_000, 8, 2),
    (1, 2, 26, 25_000, 1, 1), (1, 2, 26, 25_000, 8, 1),
    (1, 2, 105, 12_500, 1, 1), (1, 2, 105, 12_500, 8, 1),
    (48, 125, 493, 4_800, 2, 1), (48, 125, 493, 4_800, 16, 1),
    (1, 1, 304, 5_000, 1, 2), (1, 1, 304, 5_000, 1, 1),
    (1, 2, 152, 7_500, 1, 2), (1, 4, 34, 60_000, 1, 2),
    (1, 4, 55, 15_000, 1, 2), (2, 3, 116, 5_000, 1, 2),
    (24, 25, 104, 4_800, 1, 1), (4, 5, 99, 4_800, 4, 1),
    (96, 125, 223, 4_800, 4, 1), (4, 25, 499, 4_800, 4, 1),
    (24, 625, 2_604, 1_560, 8, 1), (192, 625, 872, 2_496, 8, 1),
    (1, 4, 34, 65_000, 8, 1), (1, 4, 55, 16_250, 8, 1),
    (1, 2, 152, 8_125, 8, 1), (16, 25, 143, 5_200, 8, 1),
    (24, 125, 520, 1_560, 8, 1), (1, 1, 651, 2_496, 8, 1),
    (1, 1, 304, 5_200, 8, 1), (1, 1, 114, 1_560, 8, 1),
    (1, 1, 114, 1_500, 4, 1), (2, 1, 76, 4_800, 4, 1),
    (16, 5, 80, 4_800, 4, 1), (16, 5, 80, 4_992, 4, 1),
]


def card_test_geometries() -> list:
    """The shapes of ``test_fir_rows_kernel_matches_plain``
    (tests/test_torch_cuda.py): each kernel, one row or 17, real or
    complex, blocks of D·1037 and D·3 after its tail."""
    out = []
    for K, I, D in [(304, 1, 4), (600, 1, 1), (253, 1, 1), (63, 1, 2),
                    (97, 5, 6), (493, 48, 125), (116, 2, 3), (1, 1, 2),
                    (872, 192, 625), (143, 16, 25)]:
        hist = max(K - D, K - 1) if I > 1 else K - 1
        for T in (D * 1037, D * 3):
            n_m = (hist + T - K) // D + 1
            if n_m >= 1:
                out += [(I, D, K, n_m * I, rows, comps)
                        for rows in (1, 17) for comps in (1, 2)]
    return out


def _ids(g):
    return "I{}-D{}-kw{}-n{}-r{}-c{}".format(*g)


@pytest.mark.parametrize("geom", PATH_GEOMETRIES + card_test_geometries(),
                         ids=_ids)
def test_plan_covers_every_output_once_and_fits(geom):
    I, D, kw, n_out, rows, comps = geom
    p = fir_kernel.fir_plan(*geom)
    P, G, C, W = p["P"], p["G"], p["C"], p["warps"]
    n_m = n_out // I
    assert P in (1, 3, 5) and 1 <= G <= I and 1 <= C and 4 <= W <= 8
    assert p["threads"] == 32 * W and p["m_block"] == C * 32 * P
    assert p["smem"] == fir_kernel.tile_smem(D, kw, n_m, P, G, C, comps)
    assert p["smem"] <= SMEM
    gx, gy, gz = p["grid"]
    assert gz == rows and p["blocks"] == gx * gy * gz
    # block (bx, by) → warps' (phase row, chunk) units → lanes' P outputs
    hits = np.zeros((n_m, I), int)
    for bx in range(gx):
        m0 = bx * C * 32 * P
        mb = min(C * 32 * P, n_m - m0)
        assert mb >= 1
        for by in range(gy):
            r0 = by * G
            gn = min(G, I - r0)
            assert gn >= 1
            units = [u for w in range(W) for u in range(w, gn * C, W)]
            assert sorted(units) == list(range(gn * C))
            for u in units:
                mm = ((u // gn) * 32 * P + np.arange(32 * P))
                mm = mm[mm < mb]
                hits[m0 + mm, r0 + u % gn] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("geom", PATH_GEOMETRIES, ids=_ids)
def test_plan_fills_the_card(geom):
    """>= 132 blocks wherever the call has >= 132 warps of outputs (32
    outputs of one phase row a warp)."""
    I, D, kw, n_out, rows, comps = geom
    p = fir_kernel.fir_plan(*geom)
    if rows * I * -(-(n_out // I) // 32) >= SMS:
        assert p["blocks"] >= SMS, p


def test_plan_rejects_what_the_tile_cannot_take():
    for bad in [(48, 125, 493, 4_801, 1, 1), (1, 1, 10, 0, 1, 1),
                (1, 1, 10, 10, 1, 3), (1, 1, 60_000, 100, 1, 2)]:
        with pytest.raises(ValueError):
            fir_kernel.fir_plan(*bad)


def _read(sx, idx):
    assert idx.max() < sx.size, "a read past the block's layout"
    return sx[idx]


def taps_any_d(sx, xs, kr, S, D, P, lo, hi):
    """csrc: taps_any_d, for the lanes whose first output reads xs: taps
    l = a·D + p in ascending order (a outer, p inner); output j reads xs
    + p·S + a + j."""
    acc = np.zeros((xs.size, P), sx.dtype)
    a, p = divmod(lo, D)
    while a * D < hi:
        for p in range(p, min(D, hi - a * D)):
            acc += kr[a * D + p] * _read(sx, (xs + a + p * S)[:, None]
                                         + np.arange(P))
        a, p = a + 1, 0
    return acc


def taps_ring(sx, xs, kr, S, D, P, lo, hi):
    """csrc: taps_ring, the register ring of R = P·D slots: offset e of
    output 0 in slot (e − l0) mod R, loaded R − 1 taps ahead; output j at
    tap l + s reads slot (s + j·D) mod R."""
    R = P * D
    l = lo - lo % D
    x = xs + l // D
    w = [None] * R
    for e in range(R - 1):
        w[e] = _read(sx, x + (e % D) * S + e // D)
    acc = np.zeros((xs.size, P), sx.dtype)

    def step(s):
        w[(s + R - 1) % R] = _read(sx, x + ((s + R - 1) % D) * S
                                   + (s + R - 1) // D)
        for j in range(P):
            acc[:, j] += kr[l + s] * w[(s + j * D) % R]
    while l + R <= hi:
        for s in range(R):
            step(s)
        l, x = l + R, x + P
    for s in range(R - 1):
        if l + s < hi:
            step(s)
    return acc


def tile_model(ext, kern, I: int, D: int, plan: dict,
               bands=None) -> np.ndarray:
    """The tile's schedule on rows ``ext`` [rows, W] (float64 or
    complex128, a complex sample the float2 of one row) with ``kern`` [I,
    kw] → y [rows, n_m·I].  Raises if a read leaves the block's layout or
    an output's read finds a slot that was not staged.  ``bands`` (lo,
    hi), each [I], replaces the rows' own (a complex tap's band is where
    either of its parts is nonzero)."""
    rows = ext.shape[0]
    kw = kern.shape[1]
    P, G, C, n_m = plan["P"], plan["G"], plan["C"], plan["n_m"]
    gx, gy, _ = plan["grid"]
    y = np.full((rows, n_m * I), np.nan, ext.dtype)
    lanes = np.arange(32)[:, None] * P + np.arange(P)[None, :]
    for b in range(rows):
        for by in range(gy):
            r0 = by * G
            gn = min(G, I - r0)
            taps = kern[r0:r0 + gn].astype(np.float64)
            lo, hi = row_bands(taps) if bands is None else (
                bands[0][r0:r0 + gn], bands[1][r0:r0 + gn])
            for bx in range(gx):
                m0 = bx * C * 32 * P
                mb = min(C * 32 * P, n_m - m0)
                prow = min(D, kw)
                S = (mb + (kw - 1) // D) | 1
                # the input area: prow rows of S samples, + P slack
                sx = np.full(prow * S + P, np.nan, ext.dtype)
                j, p = np.meshgrid(np.arange(mb + (kw - 1) // D),
                                   np.arange(prow), indexing="ij")
                keep = j * D + p < (mb - 1) * D + kw
                sx[(p * S + j)[keep]] = ext[b, m0 * D + (j * D + p)[keep]]
                out = np.full((mb, G | 1), np.nan, ext.dtype)
                for u in range(gn * C):
                    g = u % gn
                    mm = (u // gn) * 32 * P + lanes          # [32, P]
                    live = mm[:, 0] < mb
                    acc = np.zeros(mm.shape, ext.dtype)
                    if hi[g] > lo[g] and live.any():
                        xs = mm[live, 0]                     # xs = sx + mm0
                        fn = taps_ring if D in (1, 2, 4) and kw >= D \
                            else taps_any_d
                        acc[live] = fn(sx, xs, taps[g], S, D, P, lo[g],
                                       hi[g])
                    ok = mm < mb
                    out[mm[ok], g] = acc[ok]
                blk = out[:, :gn]
                assert not np.isnan(blk).any(), "a read of an unstaged slot"
                for mm_ in range(mb):
                    y[b, (m0 + mm_) * I + r0:(m0 + mm_) * I + r0 + gn] = \
                        blk[mm_]
    return y


def poly_rows64(ext, kern, I: int, D: int) -> np.ndarray:
    """``poly_rows``'s correlation (one conv1d, phases interleaved) in
    float64: poly_rows itself casts its kernel to float32."""
    x = torch.from_numpy(np.ascontiguousarray(ext, np.float64))
    k = torch.from_numpy(np.asarray(kern, np.float64))
    y = F.conv1d(x[:, None], k[:, None], stride=D)
    return y.transpose(1, 2).reshape(x.shape[0], -1).numpy()


def _model_vs_poly_rows(ext, kern, I, D, plan):
    got = tile_model(ext, kern, I, D, plan)
    if np.iscomplexobj(ext):
        want = poly_rows64(ext.real, kern, I, D) + 1j * poly_rows64(
            ext.imag, kern, I, D)
    else:
        want = poly_rows64(ext, kern, I, D)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def _ext(rng, rows, n_m, D, kw, cplx):
    W = (n_m - 1) * D + kw
    e = rng.standard_normal((rows, W))
    return e + 1j * rng.standard_normal((rows, W)) if cplx else e


@pytest.mark.parametrize("name,rows,n_m,cplx", [
    ("folded 48/125", 2, 100, False), ("usb 192/625", 1, 13, False),
    ("usb 192/625", 1, 13, True), ("vfo 16/25", 2, 80, True),
    ("zero row 5/6", 1, 300, True)])
def test_model_matches_poly_rows_on_path_kernels(name, rows, n_m, cplx):
    """The paths' widened kernels, zero bands and all, at the plans their
    calls get (one with an all-zero phase row)."""
    if name == "folded 48/125":
        kern, I, D = folded_audio_kernel(), 48, 125
    else:
        I, D, fs_in, fs_out = {"usb 192/625": (192, 625, 10e6, 24e3),
                               "vfo 16/25": (16, 25, 10e6, 50e3),
                               "zero row 5/6": (5, 6, 2.4e6, 250e3)}[name]
        kern = resampler_kernel(fs_in, fs_out).copy()
        if name == "zero row 5/6":
            kern[2] = 0.0
    assert kern.shape[0] == I
    kern = kern.astype(np.float32)
    rng = np.random.default_rng(I + D)
    plan = fir_kernel.fir_plan(I, D, kern.shape[1], n_m * I, rows,
                               2 if cplx else 1)
    _model_vs_poly_rows(_ext(rng, rows, n_m, D, kern.shape[1], cplx), kern,
                        I, D, plan)


@pytest.mark.parametrize("P", [1, 3, 5])
@pytest.mark.parametrize("K,I,D,n_m,G,C", [(304, 1, 4, 700, 1, 2),
                                           (97, 5, 6, 250, 3, 2),
                                           (26, 1, 2, 900, 1, 3),
                                           (493, 48, 125, 100, 16, 1)])
def test_model_matches_poly_rows_at_every_outputs_per_lane(P, K, I, D, n_m,
                                                          G, C):
    """Each P the plan may pick, on blocks with partial chunks, partial
    phase groups and a band (the first third of each row zero)."""
    rng = np.random.default_rng(P * 100 + K)
    kern = rng.standard_normal((I, K)).astype(np.float32)
    kern[:, :K // 3] = 0.0
    n_c = -(-n_m // (32 * P))
    plan = {"P": P, "G": G, "C": C, "n_m": n_m,
            "grid": (-(-n_c // C), -(-I // G), 2)}
    assert fir_kernel.tile_smem(D, K, n_m, P, G, C, 2) <= SMEM
    _model_vs_poly_rows(_ext(rng, 2, n_m, D, K, True), kern, I, D, plan)


@pytest.mark.parametrize("K,I,D,n_m", [(97, 5, 6, 400), (872, 192, 625, 13)])
def test_model_equals_poly_rows_exactly_on_integers(K, I, D, n_m):
    """Integer taps and samples: float32 ``poly_rows`` (conv1d) sums
    exactly, and so does the model."""
    rng = np.random.default_rng(K)
    kern = rng.integers(-3, 4, (I, K)).astype(np.float32)
    kern[:, :K // 4] = 0.0
    ext = rng.integers(-7, 8, (3, (n_m - 1) * D + K)).astype(np.float64)
    plan = fir_kernel.fir_plan(I, D, K, n_m * I, 3, 1)
    want = fir_kernel.poly_rows(torch.from_numpy(ext.astype(np.float32)),
                                kern, I, D).numpy()
    np.testing.assert_array_equal(tile_model(ext, kern, I, D, plan), want)


def test_path_kernels_have_the_measured_bands():
    """Each phase row's nonzero band: K3's folded [48, 493] 256-257 taps
    (52 %), the bank's USB 192/625 [192, 872] 247-248 (28.4 %)."""
    for kern, I, kw, lo_band, hi_band, share in (
            (folded_audio_kernel(), 48, 493, 256, 257, 0.52),
            (resampler_kernel(10e6, 24e3), 192, 872, 247, 248, 0.284)):
        k = kern.astype(np.float32)
        assert k.shape == (I, kw)
        lo, hi = row_bands(k)
        band = hi - lo
        assert band.min() == lo_band and band.max() == hi_band
        assert abs(band.sum() / k.size - share) < 0.005


# ---- K9: complex taps on the tile (csrc/fir_cplx.cu) -----------------------

def cplx_geometries() -> list:
    """(D, K, n_out, rows) of K9: the WFM pilot band-pass (159 complex
    taps, one row of 12 500 outputs), and the shapes of
    ``test_fir_cplx_kernel_matches_plain`` (tests/test_torch_cuda.py)."""
    out = [(1, 159, 12_500, 1)]
    for K, D in [(159, 1), (159, 2), (600, 4), (3, 1)]:
        for T in (D * 12_500, D * 5):
            n = (K - 1 + T - K) // D + 1
            out += [(D, K, n, rows) for rows in (1, 17)]
    return out


@pytest.mark.parametrize("geom", cplx_geometries(),
                         ids=lambda g: "D{}-K{}-n{}-r{}".format(*g))
def test_cplx_plan_covers_every_output_once_and_fits(geom):
    D, K, n, rows = geom
    p = fir_kernel.cplx_plan(*geom)
    assert p == fir_kernel.fir_plan(1, D, K, n, rows, 2, 2)
    P, C = p["P"], p["C"]
    assert p["G"] == 1 and p["grid"][1:] == (1, rows)
    assert p["smem"] == fir_kernel.tile_smem(D, K, n, P, 1, C, 2, 2) <= SMEM
    # the taps take two floats each: twice the real-tap layout's
    assert p["smem"] - fir_kernel.tile_smem(D, K, n, P, 1, C, 2) == \
        4 * (fir_kernel._r4(2 * K) - fir_kernel._r4(K))
    hits = np.zeros(n, int)
    for bx in range(p["grid"][0]):
        m0 = bx * C * 32 * P
        units = [u for w in range(p["warps"]) for u in range(w, C,
                                                             p["warps"])]
        for u in units:
            mm = m0 + u * 32 * P + np.arange(32 * P)
            hits[mm[mm < min(m0 + C * 32 * P, n)]] += 1
    assert (hits == 1).all()


def test_cplx_plan_fills_the_card_for_the_pilot():
    """The pilot's one row of 12 500 outputs takes >= 132 blocks (the
    one-thread-an-output kernel gave it 49)."""
    p = fir_kernel.cplx_plan(1, 159, 12_500, 1)
    assert p["blocks"] >= SMS, p


def four_sum_model(ext, taps, D: int, plan: dict) -> np.ndarray:
    """K9 on the tile: the four real sums (rr, ii, ri, ir), each on the
    tile's schedule over the complex taps' band (where hr or hi is
    nonzero) in ascending tap order, then (rr − ii) + j(ri + ir)."""
    hr, hi = taps[:1].astype(np.float64), taps[1:].astype(np.float64)
    nz = np.flatnonzero((taps[0] != 0) | (taps[1] != 0))
    bands = (np.array([nz[0]]), np.array([nz[-1] + 1]))

    def run(x, k):
        return tile_model(np.ascontiguousarray(x), k, 1, D, plan, bands)
    rr, ii = run(ext.real, hr), run(ext.imag, hi)
    ri, ir = run(ext.real, hi), run(ext.imag, hr)
    return (rr - ii) + 1j * (ri + ir)


@pytest.mark.parametrize("P", [1, 3, 5])
@pytest.mark.parametrize("D,K,n_m,rows,C", [(1, 159, 700, 1, 2),
                                            (2, 159, 300, 2, 1),
                                            (4, 600, 90, 1, 1),
                                            (1, 3, 50, 3, 4),
                                            (3, 40, 100, 2, 2)])
def test_four_sum_model_equals_fir_cplx_ref_exactly_on_integers(
        P, D, K, n_m, rows, C):
    """Integer taps and samples (float32 sums exact): the four-sum model
    on each P the plan may pick, partial chunks, a band whose ends differ
    between hr and hi, equals ``fir_cplx_ref`` bit for bit, and at the
    plan's own P too."""
    rng = np.random.default_rng(P * 1000 + K + D)
    taps = rng.integers(-3, 4, (2, K)).astype(np.float32)
    taps[:, :K // 5] = 0.0
    taps[0, K // 5:K // 4] = 0.0          # hr starts later than hi
    taps[1, K - K // 6:] = 0.0            # hi ends earlier than hr
    taps[:, -1] = 0.0
    hist = K - 1
    T = (n_m - 1) * D + K - hist
    x = (rng.integers(-7, 8, (rows, T))
         + 1j * rng.integers(-7, 8, (rows, T))).astype(np.complex64)
    tail = (rng.integers(-7, 8, (rows, hist))
            + 1j * rng.integers(-7, 8, (rows, hist))).astype(np.complex64)
    want, _ = fir_kernel.fir_cplx_ref(torch.from_numpy(x),
                                      torch.from_numpy(tail),
                                      torch.from_numpy(taps), D)
    ext = np.concatenate([tail, x], axis=1).astype(np.complex128)
    n_c = -(-n_m // (32 * P))
    for plan in ({"P": P, "G": 1, "C": C, "n_m": n_m,
                  "grid": (-(-n_c // C), 1, rows)},
                 fir_kernel.cplx_plan(D, K, n_m, rows)):
        np.testing.assert_array_equal(four_sum_model(ext, taps, D, plan),
                                      want.numpy())
