"""K1's and K2's plans and K1's mix staging, on the CPU (csrc/mono_frontend.cu
and csrc/wfm_demod.cu run only on the card).

``mono_frontend.mix_plan`` sizes stage 0's grid: blocks of one channel's
consecutive outputs inside one TPU window of adv0 outputs.  It must cover
every output once, never let a block straddle a window end, fit the
H100's 227 KB a block and launch >= 132 blocks on the paths (WFM-8 and
multimode8's three K1 chains).  The chained stages run
``fir_kernel.fir_plan``'s grid, K2's and K10's launches
``wfm_kernel.demod_plan``'s: each output once, within 227 KB, and the
card filled.

The trap the window rule guards: the mix phase of a wideband sample
depends on the window of the OUTPUT that reads it, so the K0 − D0 samples
two windows share are mixed twice, at two base phases.  ``mix_model``
mirrors the staging hook (MixSrc): each block stages its samples mixed at
its own window's phase, each operation rounded to float32 as the kernel
pins it.  It must give ``mono_frontend.mix_window``'s values (the plain
version's per-window mixing) bit for bit, the shared samples included;
mixed at the window of the sample instead, the shared samples differ."""

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch.models import radio_bank as rb
from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
from sdrplusplusbrown_tpu_torch.ops import fir_kernel, mono_frontend as mf
from sdrplusplusbrown_tpu_torch.ops import wfm_kernel

import test_torch_fir_plan as fir_plan_tests

SMS, SMEM = 132, 232_448
FS = 2.4e6


def wfm_bank():
    return Radio(FS, DEMOD_WFM, device="cpu")._build_vfo_shared()


def multimode_banks() -> dict:
    bank = rb.RadioBank(FS, rb.multimode8_vfos(), device="cpu")
    return {r.demod_name: (r._build_vfo_shared(), bank._padded_c(d))
            for d, r in bank.radios.items()}


def path_pipes() -> dict:
    """{path: (K1 pipeline, C, T)}: WFM-8 and multimode8's K1 groups at
    2.4 MS/s, 240 000-sample steps."""
    out = {"WFM-8": (wfm_bank().pipe(), 8, 240_000)}
    for name, (vb, C) in multimode_banks().items():
        out[f"multimode8 {name}"] = (vb.pipe(), C, 240_000)
    return out


def blocks(plan, m0, adv0):
    """csrc/mono_frontend.cu:mix_kernel's block → (window, first output,
    count), for one channel."""
    mb, bpw = plan["m_block"], plan["bpw"]
    for bx in range(plan["grid"][0]):
        w = bx // bpw
        lo = w * adv0 + (bx - w * bpw) * mb
        yield w, lo, min(mb, min((w + 1) * adv0, m0) - lo)


# (m0, adv0, C, K0, D0): the paths' stage 0 (WFM-8; multimode8's NFM, AM,
# USB), the card tests' and the CPU tests' shapes, a step shorter than
# one window and one whose window the blocks tile exactly
MIX_GEOMETRIES = [
    (60_000, 2304, 8, 304, 4), (60_000, 3072, 4, 34, 4),
    (60_000, 20_480, 4, 31, 4), (60_000, 51_200, 4, 32, 4),
    (9_000, 2304, 3, 304, 4), (9_000, 2304, 16, 304, 4),
    (6_000, 2304, 1, 304, 4), (12_000, 2304, 16, 304, 4),
    (500, 2304, 2, 304, 4), (7_680, 2560, 4, 63, 4),
]


@pytest.mark.parametrize("geom", MIX_GEOMETRIES,
                         ids=lambda g: "m{}-adv{}-C{}-K{}-D{}".format(*g))
def test_mix_plan_covers_every_output_once_inside_one_window(geom):
    m0, adv0, C, K0, D0 = geom
    p = mf.mix_plan(*geom)
    assert p["P"] in (1, 3, 5) and p["Cc"] in mf.MIX_CHUNKS
    assert p["m_block"] == p["Cc"] * 32 * p["P"]
    assert 4 <= p["warps"] <= 8 and p["grid"][1:] == (1, C)
    assert p["blocks"] == p["grid"][0] * C
    assert p["smem"] == fir_kernel.tile_smem(D0, K0, m0, p["P"], 1, p["Cc"],
                                             2) <= SMEM
    hits = np.zeros(m0, int)
    for w, lo, n in blocks(p, m0, adv0):
        assert 1 <= n <= p["m_block"]
        assert lo // adv0 == (lo + n - 1) // adv0 == w
        hits[lo:lo + n] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("path", ["WFM-8", "multimode8 NFM",
                                  "multimode8 AM", "multimode8 USB"])
def test_mix_plan_fills_the_card_on_the_paths(path):
    pipe, C, T = path_pipes()[path]
    m0 = pipe.lengths(T)[0]
    p = mf.mix_plan(m0, pipe.adv0, C, pipe.K0, pipe.D0)
    assert p["blocks"] >= SMS and p["smem"] <= SMEM
    # no more than a quarter of the lanes idle
    assert 4 * (p["grid"][0] * p["m_block"] - m0) <= p["grid"][0] * p[
        "m_block"]


def test_mix_plan_geometries_are_the_paths():
    """MIX_GEOMETRIES' first four are the paths' stage 0."""
    got = [(pipe.lengths(T)[0], pipe.adv0, C, pipe.K0, pipe.D0)
           for pipe, C, T in path_pipes().values()]
    assert sorted(got) == sorted(MIX_GEOMETRIES[:4])


def chained_geometries() -> list:
    """(I, D, kw, n_out, rows, comps) of every chained K1 stage on the
    paths (C complex rows)."""
    out = []
    for pipe, C, T in path_pipes().values():
        m = pipe.lengths(T)
        out += [(st["I"], st["D"], st["kernel"].shape[1], m[s + 1], C, 2)
                for s, st in enumerate(pipe.stages)]
    return out


@pytest.mark.parametrize("geom", chained_geometries(), ids=fir_plan_tests._ids)
def test_chained_stage_plans_cover_and_fill(geom):
    fir_plan_tests.test_plan_covers_every_output_once_and_fits(geom)
    fir_plan_tests.test_plan_fills_the_card(geom)


# (D, kw, n_out, rows): K2's halfbands and stereo section at WFM-8 (C =
# 8), K10 at app WFM (8,), one radio, and a call shorter than a chunk
DEMOD_GEOMETRIES = [(2, 26, 25_000, 8), (2, 105, 12_500, 8),
                    (1, 159, 12_500, 8), (2, 26, 25_000, 1),
                    (1, 159, 1_250, 1), (2, 105, 40, 3)]


@pytest.mark.parametrize("geom", DEMOD_GEOMETRIES,
                         ids=lambda g: "D{}-kw{}-n{}-r{}".format(*g))
def test_demod_plan_covers_every_output_once_and_fills(geom):
    """``wfm_kernel.demod_plan``: each row's outputs once, over chunks of
    32·P; >= 4 blocks an SM unless a block already takes one chunk; the
    halfbands' tile within 227 KB."""
    D, kw, n_out, rows = geom
    p = wfm_kernel.demod_plan(n_out, rows)
    P, C = p["P"], p["C"]
    gx, gy, gz = p["grid"]
    assert (P, p["warps"], gy, gz) == (3, 8, 1, rows) and 1 <= C <= 4
    hits = np.zeros(n_out, int)
    for bx in range(gx):
        m0 = bx * C * 32 * P
        assert m0 < n_out
        hits[m0:m0 + C * 32 * P] += 1
    assert (hits == 1).all()
    assert C == 1 or gx * rows >= 4 * SMS
    if D == 2:
        assert fir_kernel.tile_smem(D, kw, n_out, P, 1, C, 1) <= SMEM


def mix_model(pipe, ext_r, ext_i, omega, base, c, w, lo, n):
    """The staging hook on the block (channel c, window w, outputs lo ..
    lo + n − 1): (e0, the staged complex samples of ext[e0, e0 + span))
    in float32, each operation rounded (the phase __fmul_rn then
    __fadd_rn, the product's two rounded products and rounded sum);
    cos and sin as the plain version takes them."""
    K0, D0 = pipe.K0, pipe.D0
    e = np.arange(lo * D0, (lo + n - 1) * D0 + K0)
    tw = e + 1024 - (K0 - 1) - w * pipe.adv_x
    assert tw.min() >= 0 and (tw >> 10).max() < base.shape[2]
    f32 = np.float32
    ang = (base[c, w].numpy()[tw >> 10]
           + f32(omega[c].item()) * (tw & 1023).astype(f32)).astype(f32)
    co = torch.from_numpy(ang).cos().numpy()
    si = torch.from_numpy(ang).sin().numpy()
    a, b = ext_r.numpy()[e], ext_i.numpy()[e]
    return e[0], (a * co - b * si).astype(f32), (a * si + b * co).astype(f32)


@pytest.mark.parametrize("C", [3, 8])
def test_mix_staging_model_matches_the_plain_windows(C):
    """Every block's staged samples equal ``mix_window``'s for the block's
    window, sample for sample, the window ends included.  The samples two
    windows share are mixed at base phases 2πk apart, each rounded: for
    most channels and window pairs the two mixes differ in some sample, so
    a block that took the next window's (a straddle) would show here."""
    vb = wfm_bank()
    pipe = vb.pipe()
    T = 36_000                      # windows of 2 304 outputs: 3 and a part
    rng = np.random.default_rng(C)
    xr, xi = (torch.from_numpy(rng.standard_normal(T).astype(np.float32))
              for _ in range(2))
    tail = torch.from_numpy((rng.standard_normal(pipe.K0 - 1)
                             + 1j * rng.standard_normal(pipe.K0 - 1))
                            .astype(np.complex64))
    # offsets off any power-of-two fraction of the rate, whose phases
    # would wrap exactly
    params = vb.make_params(rng.uniform(-1e6, 1e6, C))["fused"]
    phase = torch.from_numpy(rng.uniform(-3, 3, C).astype(np.float32))
    base = pipe.base_phases(params, phase, T)
    omega = params["omega"]
    ext_r = torch.cat([tail.real, xr])
    ext_i = torch.cat([tail.imag, xi])
    m0 = pipe.lengths(T)[0]
    p = mf.mix_plan(m0, pipe.adv0, C, pipe.K0, pipe.D0)
    n_win = -(-m0 // pipe.adv0)
    assert n_win == 4
    win = [mf.mix_window(pipe, ext_r, ext_i, omega, base, i)
           for i in range(n_win)]
    pairs = differ = 0
    for c in range(C):
        for w, lo, n in blocks(p, m0, pipe.adv0):
            e0, re, im = mix_model(pipe, ext_r, ext_i, omega, base, c, w,
                                   lo, n)
            w_lo, planes = win[w]
            k = e0 - w_lo
            np.testing.assert_array_equal(re, planes[c, k:k + re.size])
            np.testing.assert_array_equal(im, planes[C + c, k:k + re.size])
            # the window's last block: its samples past the next
            # window's first belong to that window too
            if w + 1 < n_win and lo + n == (w + 1) * pipe.adv0:
                e_next, nxt = win[w + 1]
                j = e_next - e0
                ov = re.size - j
                assert ov == pipe.K0 - pipe.D0
                pairs += 1
                differ += not np.array_equal(re[j:], nxt[c, :ov])
    assert pairs == C * (n_win - 1) and 2 * differ >= pairs
