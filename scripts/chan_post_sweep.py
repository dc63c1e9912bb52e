#!/usr/bin/env python3
"""K6 (csrc/chan_post.cu) and K9 (csrc/fir_cplx.cu) of one tree on one
NVIDIA GPU, for a parent / change comparison:

    python3 scripts/chan_post_sweep.py [--tree DIR] [--save F]
                                       [--against F] [--plans]

K6 at scanner128 and scanner256 (C = 128 and 256 channels of the scanner
bank, M = 48, 10 000 bin frames of a 0.1 s block) and at the card tests'
odd C = 5, each in the float32 and the bf16 handoff (bins, IF and tails
in that dtype); K9 on the WFM pilot band-pass (159 complex taps, one row
of 12 500 MPX samples, as the app's WFM `()` step gives it) and on 17
rows of it.  Inputs, phases and tails are made from seeds, so two trees
see the same bits.  For each it prints the kernel's device µs a call and
CUDA launches a call (``chip_smoke.call_profile``), K6's split by launch,
the bound (``chip_smoke.bound``) and the agreement with the plain version
on the card (bit-identical, or max|err| and dB; K6's squelch sums as the
largest relative error).  It keeps every output: K6's IF [2C, n_out],
squelch sums and both tails, K9's outputs and new tail.

``--plans`` (this design's trees only) also times K6 at scanner128 and
scanner256 (bf16) under a grid of plans, each launch under every (P, C,
warps) beside the other on ``chan_post_plan``'s own, and K9 on the pilot
under every (P, C, warps), and ranks the plan's choice among them.
``--tree DIR`` imports the port from another checkout (a parent commit
unpacked with ``git archive``).  ``--save F`` writes every output to F
(torch.save); ``--against F`` compares each with F's and exits 1 where a
K6 IF output, a K6 tail or a K9 output is not bit-identical, or a squelch
sum is off by more than rtol 1e-5.  Run it parent / change / change /
parent in one call, each against the previous.  Needs CUDA; imports no
JAX.
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 2_400_000.0
TB = 10_000                  # bin frames of a 0.1 s scanner block
K6_SHAPES = [("scanner128", 128), ("scanner256", 256), ("C = 5", 5)]
K9_ROWS = [1, 17]
PILOT_T = 12_500             # the app WFM () step's MPX samples a block


def agree(got, want, smoke) -> str:
    import torch
    g, w = got.float(), want.float()
    if torch.equal(g, w):
        return "bit-identical"
    return (f"max|err| {float((g - w).abs().max()):.3e}, "
            f"{smoke.snr_db(w.double(), g.double()):.1f} dB")


def k6_case(dev, C, handoff):
    """Kernel arguments of a scanner bank's K6 call: the bank's offsets
    (linspace(−1.1, 1.1) MHz + 917 Hz), seeded phases, bins noise and
    tails, in the handoff dtype."""
    import torch
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_NFM
    from sdrplusplusbrown_tpu_torch.ops import precision
    precision.set_handoff_dtype(handoff)
    dt = precision.get_handoff_dtype()
    bank = Radio(FS, DEMOD_NFM, squelch_enabled=True,
                 device=dev)._build_vfo_channelized()
    post = bank.pipes()[1]
    params = bank.make_params(np.linspace(-1.1e6, 1.1e6, C) + 917.0)
    rng = np.random.default_rng(C)
    W = post.plan(TB)["Tb_pad"]
    bins = torch.from_numpy(rng.standard_normal((2 * post.M, W)).astype(
        np.float32)).to(dev).to(dt)
    ph0 = torch.from_numpy(rng.uniform(-np.pi, np.pi, C).astype(
        np.float32)).to(dev)
    a_sup, rem = divmod(post.adv0, 2048)
    span = (params["xl_sup"] * a_sup + params["xl_bs"] * (rem // 128)) \
        .contiguous()
    tails = [precision.round_to(torch.from_numpy(rng.standard_normal(
        (2 * C, h)).astype(np.float32)), dt).to(dev).contiguous()
        for h in post.hists]
    return (post, bins, params["bin"], params["xl"]["omega"].contiguous(),
            ph0, span, params["xl_bs"].contiguous(), tails, TB, dt, dt)


def run_k6(dev, smoke, res):
    import torch
    from sdrplusplusbrown_tpu_torch.ops import chan_frontend as cf
    for (name, C), handoff in itertools.product(K6_SHAPES,
                                                ("float32", "bf16")):
        args = k6_case(dev, C, handoff)
        label = f"K6 {name} {handoff}"
        out, sq, tails = cf.chan_post_kernel(*args)
        w_out, w_sq, w_tails = cf.chan_post_ref(*args)
        split = {}
        us, n = smoke.call_profile(lambda: cf.chan_post_kernel(*args),
                                   by_kernel=split)
        bms, by = smoke.bound("K6", args)
        m = args[0].plan(TB)["m"][-1]
        rel = float(((sq - w_sq).abs() / w_sq.abs()).max())
        parts = ", ".join(f"{k} {v:.1f}" for k, v in split.items())
        print(f"{label}: {us:.1f} us in {n} launches ({parts}); bound "
              f"{bms * 1e3:.2f} us ({by}); against the plain version: IF "
              f"{agree(out[:, :m], w_out[:, :m], smoke)}, squelch sums rel "
              f"err {rel:.1e}, tails "
              + ", ".join(agree(g, w, smoke) for g, w in zip(tails,
                                                             w_tails)))
        torch.cuda.synchronize()
        res[f"{label}/out"] = out.float().cpu()
        res[f"{label}/sq"] = sq.cpu()
        for key, t in zip(("d2 tail", "fir tail"), tails):
            res[f"{label}/{key}"] = t.cpu()


def k9_case(dev, rows):
    """(x, tail, taps, D): the WFM pilot band-pass's complex taps [2, 159]
    on ``rows`` seeded complex rows of PILOT_T samples and their tails."""
    import torch
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
    h = np.asarray(Radio(FS, DEMOD_WFM, device="cpu").demod.pilot_taps)
    taps = torch.from_numpy(np.stack([h.real, h.imag]).astype(
        np.float32)).to(dev)
    rng = np.random.default_rng(rows)
    lead = () if rows == 1 else (rows,)

    def cplx(n):
        v = rng.standard_normal(lead + (n,)) \
            + 1j * rng.standard_normal(lead + (n,))
        return torch.from_numpy(v.astype(np.complex64)).to(dev)
    return cplx(PILOT_T), cplx(taps.shape[1] - 1), taps, 1


def run_k9(dev, smoke, res):
    import torch
    from sdrplusplusbrown_tpu_torch.ops import fir_kernel as fk
    for rows in K9_ROWS:
        args = k9_case(dev, rows)
        label = f"K9 pilot, {rows} row{'s' if rows > 1 else ''}"
        y, t = fk.fir_cplx_kernel(*args)
        wy, wt = fk.fir_cplx_ref(*args)
        us, n = smoke.call_profile(lambda: fk.fir_cplx_kernel(*args))
        bms, by = smoke.bound("K9", args)
        y, wy = torch.view_as_real(y), torch.view_as_real(wy)
        t, wt = torch.view_as_real(t), torch.view_as_real(wt.contiguous())
        print(f"{label}: {us:.1f} us in {n} launches; bound "
              f"{bms * 1e3:.2f} us ({by}); against the plain version: y "
              f"{agree(y, wy, smoke)}, tail {agree(t, wt, smoke)}")
        torch.cuda.synchronize()
        res[f"{label}/y"] = y.cpu()
        res[f"{label}/tail"] = t.cpu()


def fastest(label, own, rows) -> float:
    """Prints ``own``'s time and rank among ``rows`` [(µs, plan)] and the
    fastest five; returns the fastest time."""
    rows = sorted((r for r in rows if r[0] > 0), key=lambda r: r[0])
    rank = next(i for i, r in enumerate(rows) if r[1] == own) + 1
    print(f"  plans for {label}: own {own} {rows[rank - 1][0]:.1f} us, rank "
          f"{rank} of {len(rows)}; fastest: "
          + "; ".join(f"{p} {us:.1f}" for us, p in rows[:5]))
    return rows[0][0]


def plans(dev, smoke):
    """K6's two launches under grids of plans at scanner128 and
    scanner256, bf16 handoff (each beside the other on chan_post_plan's
    own), and K9's on the pilot."""
    from sdrplusplusbrown_tpu_torch.ops import chan_frontend as cf
    from sdrplusplusbrown_tpu_torch.ops import fir_kernel as fk
    grid = list(itertools.product((5, 3, 1), (8, 4, 2, 1), (4, 8)))
    for name, C in K6_SHAPES[:2]:
        args = k6_case(dev, C, "bf16")
        post = args[0]
        own = cf.chan_post_plan(post, TB, C)
        n = own["n1"]

        def timed(plan, kernel=None):
            split = {}
            us = smoke.call_profile(lambda: cf._chan_post_launches(
                *args, plan=plan), 10, by_kernel=split)[0]
            return split.get(kernel, 0.0) if kernel else us
        best = 0.0
        for launch, D, kw, kernel in (
                ("d2", 2, len(post.taps[0]), "post_d2_kernel"),
                ("fir", 1, len(post.taps[1]), "post_fir_kernel")):
            rows = []
            Ps = cf.FIR_OUTS_PER_LANE if launch == "fir" else \
                cf.D2_OUTS_PER_LANE
            for P, Cc, W in itertools.product(Ps, (8, 4, 2, 1), (4, 8)):
                if Cc > W or fk.tile_smem(D, kw, n, P, 1, Cc, 2) + 128 > \
                        fk.SMEM_MAX:
                    continue
                n_c = -(-n // (32 * P))
                g = {"P": P, "G": 1, "C": Cc, "warps": W, "n_m": n,
                     "grid": (-(-n_c // Cc), 1, C)}
                p = dict(own, **{launch: g})
                if launch == "fir":
                    p["n_tiles"] = g["grid"][0]
                rows.append((timed(p, kernel), (P, Cc, W)))
            o = own[launch]
            best += fastest(f"K6 {name} {launch} launch (P, C, warps)",
                            (o["P"], o["C"], o["warps"]), rows)
        print(f"  K6 {name}: chan_post_plan's pair {timed(own):.1f} us; "
              f"fastest pair {best:.1f} us")
    args = k9_case(dev, 1)
    n = PILOT_T
    own = fk.cplx_plan(1, 159, n, 1)
    rows = []
    for P, Cc, W in grid:
        if Cc > W:
            continue
        n_c = -(-n // (32 * P))
        p = {"P": P, "C": Cc, "warps": W, "grid": (-(-n_c // Cc), 1, 1)}
        us = smoke.call_profile(lambda: fk._fir_cplx_launch(*args, plan=p),
                                10)[0]
        rows.append((us, (P, Cc, W)))
    fastest("K9 pilot (P, C, warps)", (own["P"], own["C"], own["warps"]),
            rows)


def compare(res, against) -> int:
    """Every output bit-identical to the other tree's, the squelch sums
    within rtol 1e-5.  Returns the number that differ."""
    import torch
    bad = 0
    for key, t in res.items():
        o = against.get(key)
        sums = key.endswith("/sq")
        if o is None or o.shape != t.shape:
            ok, d = False, "missing"
        elif sums:
            rel = float(((o.double() - t.double()).abs()
                         / o.double().abs()).max())
            ok, d = rel <= 1e-5, f"rel err {rel:.1e}"
        else:
            ok = torch.equal(o, t)
            diff = float((o.double() - t.double()).abs().max())
            d = f"max|diff| {diff:.3e}"
        if not ok:
            what = "within rtol 1e-5" if sums else "bit-identical"
            print(f"NOT {what}: {key} ({d})")
            bad += 1
        elif sums:
            print(f"{key}: {d} against the other tree's (bound 1e-5)")
    print(f"{len(res) - bad} of {len(res)} outputs agree with the other "
          f"tree's (bit-identical; squelch sums within rtol 1e-5)")
    return bad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--save")
    ap.add_argument("--against")
    ap.add_argument("--plans", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chan_post_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke       # this tree's, whatever --tree is
    sys.path.insert(0, os.path.abspath(a.tree))
    from sdrplusplusbrown_tpu_torch.kernels import _build
    parent = "sdr_chan_post" in _build.SIGNATURES
    tree = os.path.relpath(os.path.dirname(os.path.dirname(
        _build.__file__)), ROOT)
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    # a second of matrix products first, so the card is at its clocks
    m = torch.randn((4096, 4096), generator=g, device=dev)
    for _ in range(150):
        m = torch.tanh(m @ m)
    torch.cuda.synchronize()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    design = ("one-block-a-tile K6, one-thread-an-output K9" if parent
              else "K6 and K9 on the FIR tile")
    print(f"tree {tree} ({design}): {smi}; TF32 off")
    _build.lib()
    res = {}
    run_k6(dev, smoke, res)
    run_k9(dev, smoke, res)
    if a.plans and not parent:
        plans(dev, smoke)
    if a.save:
        os.makedirs(os.path.dirname(os.path.abspath(a.save)), exist_ok=True)
        torch.save(res, a.save)
    if a.against:
        return 1 if compare(res, torch.load(a.against)) else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
