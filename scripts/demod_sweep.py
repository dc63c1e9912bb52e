#!/usr/bin/env python3
"""K12 (csrc/agc.cu) and K7 (csrc/fm_audio.cu) of one tree on one NVIDIA
GPU, for a parent / change comparison:

    python3 scripts/demod_sweep.py [--tree DIR] [--save F] [--against F]
                                   [--plans]

K12 at 4 × 1 500, 4 × 2 400, 4 × 2 496 (multimode8's AM and USB rows at
both rates) and 64 × 2 400, each frozen and not; K7 at scanner128 (C =
128, 5 000 IF samples), scanner256 and multimode8's NFM group (C = 4;
5 000 IF samples at 2.4 MS/s, 5 200 at 10 MS/s), each in the float32 and
the bf16 handoff (IF, audio and tails in that dtype).  Inputs are made
from seeds, so two trees see the same bits.  For each it prints the
kernel's device µs a call and CUDA launches a call
(``chip_smoke.call_profile``), K7's split by launch, the bound
(``chip_smoke.bound``), K12's chain floor (T steps of
``chip_smoke.CHAIN_CYCLES`` dependent cycles at the SM clock), and the
agreement with the plain version on the card (bit-identical, or max|err|
and dB).  It keeps every output: K12's y, amp and env, K7's audio, quad
sample, FIR tail and polyphase tail.

``--plans`` (this design's trees only) also times K7 at each shape under
a grid of plans: its FIR launch under every (P, C, warps) and its
polyphase under every (P, G, C, warps) that fits, each beside the other
launch on ``fm_plan``'s own; it ranks ``fm_plan``'s choice of each among
them and prints ``fm_plan``'s pair beside the fastest.  ``--tree DIR``
imports the port from another checkout (a parent commit unpacked with
``git archive``).
``--save F`` writes every output to F (torch.save); ``--against F``
compares each with F's and exits 1 where one is not bit-identical.  Run
it parent / change / change / parent in one call, each against the
previous.  Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGC_SHAPES = [(4, 1500), (4, 2400), (4, 2496), (64, 2400)]
# (label, C, m_if)
K7_SHAPES = [("scanner128", 128, 5000), ("scanner256", 256, 5000),
             ("multimode8 NFM 2.4 MS/s", 4, 5000),
             ("multimode8 NFM 10 MS/s", 4, 5200)]


def run_agc(dev, smoke, res, clock_mhz):
    import torch
    from sdrplusplusbrown_tpu_torch.ops import agc
    blk = agc.AGC(attack=50 / 24e3, decay=5 / 24e3)
    for R, T in AGC_SHAPES:
        rng = np.random.default_rng(R * T)
        x = (rng.standard_normal((R, T)) * np.linspace(0.01, 3, T)) \
            .astype(np.float32)
        x[:, T // 3:T // 3 + 5] = 0.0
        amp = rng.uniform(0.01, 1.0, R).astype(np.float32)
        env = rng.choice(np.array([0, 4000, 4799, 1 << 30], np.int32), R)
        for frozen in (False, True):
            args = (blk, torch.from_numpy(x).to(dev),
                    torch.from_numpy(amp).to(dev),
                    torch.from_numpy(env).to(dev), frozen)
            label = f"K12 {R} x {T}{' frozen' if frozen else ''}"
            got = agc.agc_rows_kernel(*args)
            want = agc.agc_rows_ref(*args)
            us, n = smoke.call_profile(lambda: agc.agc_rows_kernel(*args))
            bms, by = smoke.bound("K12", args)
            floor = T * smoke.CHAIN_CYCLES / clock_mhz
            state = torch.equal(got[1], want[1]) and torch.equal(got[2],
                                                                 want[2])
            print(f"{label}: {us:.1f} us in {n} launches; chain floor "
                  f"{floor:.1f} us ({T} x {smoke.CHAIN_CYCLES} cycles at "
                  f"{clock_mhz:.0f} MHz), bound {bms * 1e3:.3f} us ({by}); "
                  f"against the plain version on the card: y "
                  f"{agree(got[0], want[0], smoke)}, state "
                  f"{'exact' if state else 'NOT exact'}")
            torch.cuda.synchronize()
            for key, t in zip(("y", "amp", "env"), got):
                res[f"{label}/{key}"] = t.cpu()


def agree(got, want, smoke) -> str:
    import torch
    g, w = got.float(), want.float()
    if torch.equal(g, w):
        return "bit-identical"
    return (f"max|err| {float((g - w).abs().max()):.3e}, "
            f"{smoke.snr_db(w.double(), g.double()):.1f} dB")


def k7_case(dev, C, m_if, handoff):
    """(pipe, kernel arguments): an FM-like IF on every channel (a tone's
    phase plus noise), every third channel's gate closed, seeded tails and
    carried sample, all rounded to the handoff dtype."""
    import torch
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_NFM
    from sdrplusplusbrown_tpu_torch.ops import precision
    precision.set_handoff_dtype(handoff)
    dt = precision.get_handoff_dtype()
    pipe = Radio(2.4e6, DEMOD_NFM, squelch_enabled=True,
                 device=dev).fm_audio_pipe()
    rng = np.random.default_rng(C + m_if)
    n = m_if + 120
    dphi = 0.3 * np.sin(np.arange(n) / 15.0) \
        + 0.05 * rng.standard_normal((C, n))
    z = np.exp(1j * np.cumsum(dphi, axis=1)) \
        + 1e-3 * rng.standard_normal((C, n))
    iq = torch.from_numpy(np.concatenate([z.real, z.imag]).astype(
        np.float32)).to(dev).to(dt)
    gate = torch.from_numpy((np.arange(C) % 3 != 1).astype(np.float32))

    def rounded(shape):
        return precision.round_to(torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)), dt).to(
                dev).contiguous()
    args = (pipe, iq, m_if, gate.to(dev), rounded((2 * C,)),
            rounded((C, pipe.histF)), rounded((C, pipe.histP)), dt, dt)
    return pipe, args


def run_k7(dev, smoke, res):
    import torch
    from sdrplusplusbrown_tpu_torch.ops import demod_kernel as dk
    for (name, C, m_if), handoff in itertools.product(
            K7_SHAPES, ("float32", "bf16")):
        pipe, args = k7_case(dev, C, m_if, handoff)
        label = f"K7 {name} {handoff}"
        got = dk.fm_audio_kernel(*args)
        want = dk.fm_audio_ref(*args)
        split = {}
        us, n = smoke.call_profile(lambda: dk.fm_audio_kernel(*args),
                                   by_kernel=split)
        bms, by = smoke.bound("K7", args)
        parts = ", ".join(f"{k} {v:.1f}" for k, v in split.items())
        print(f"{label}: {us:.1f} us in {n} launches ({parts}); bound "
              f"{bms * 1e3:.2f} us ({by}); against the plain version: "
              + "; ".join(f"{k} {agree(g, w, smoke)}" for k, g, w in zip(
                  ("audio", "quad", "FIR tail", "polyphase tail"), got,
                  want)))
        torch.cuda.synchronize()
        for key, t in zip(("audio", "quad", "fir", "resamp"), got):
            res[f"{label}/{key}"] = t.float().cpu()


def fastest(label, own, rows) -> float:
    """Prints ``own``'s time and rank among ``rows`` [(µs, plan)] and the
    fastest five; returns the fastest time."""
    rows = sorted((r for r in rows if r[0] > 0), key=lambda r: r[0])
    rank = next(i for i, r in enumerate(rows) if r[1] == own) + 1
    print(f"  plans for {label}: own {own} {rows[rank - 1][0]:.1f} us, rank "
          f"{rank} of {len(rows)}; fastest: "
          + "; ".join(f"{p} {us:.1f}" for us, p in rows[:5]))
    return rows[0][0]


def plans_k7(dev, smoke):
    """K7 under grids of plans at every shape, bf16 handoff: each of its
    two launches (the other on fm_plan's); fm_plan's pair against the
    fastest."""
    from sdrplusplusbrown_tpu_torch.ops import demod_kernel as dk
    from sdrplusplusbrown_tpu_torch.ops import fir_kernel as fk
    for name, C, m_if in K7_SHAPES:
        pipe, args = k7_case(dev, C, m_if, "bf16")
        I, D, kw, Kf = pipe.I, pipe.D, pipe.kernel.shape[1], len(pipe.hf)
        own = dk.fm_plan(pipe, m_if, C)
        n_u, n_m = own["n_u"], own["n_aud"] // I

        def timed(plan, kernel=None):
            split = {}
            us = smoke.call_profile(lambda: dk._fm_audio_launches(
                *args, plan=plan), 10, by_kernel=split)[0]
            return split.get(kernel, 0.0) if kernel else us
        rows = []
        for P, Cc, W in itertools.product((5, 3, 1), (8, 4, 2, 1), (4, 8)):
            per = Cc * 32 * P
            p = dict(own, fir={"P": P, "C": Cc, "warps": W,
                               "grid": (-(-n_u // per), 1, C)})
            rows.append((timed(p, "fir_kernel"), (P, Cc, W)))
        f = own["fir"]
        best_fir = fastest(f"K7 {name} FIR launch (P, C, warps)",
                           (f["P"], f["C"], f["warps"]), rows)
        rows = []
        for P, G, Cc, W in itertools.product((5, 3, 1), (1, 4, 8, 12, 24),
                                             (4, 2, 1), (4, 8)):
            if fk.tile_smem(D, kw, n_m, P, G, Cc, 1) > fk.SMEM_MAX:
                continue
            per = Cc * 32 * P
            p = dict(own, poly={"P": P, "G": G, "C": Cc, "warps": W,
                                "grid": (-(-n_m // per), -(-I // G), C)})
            rows.append((timed(p, "poly_kernel"), (P, G, Cc, W)))
        q = own["poly"]
        best_poly = fastest(f"K7 {name} polyphase launch (P, G, C, warps)",
                            (q["P"], q["G"], q["C"], q["warps"]), rows)
        t_own = timed(own)
        print(f"  K7 {name}: fm_plan's pair {t_own:.1f} us; fastest pair "
              f"{best_fir + best_poly:.1f} us (FIR {best_fir:.1f} + "
              f"polyphase {best_poly:.1f})")


def compare(res, against) -> int:
    """Bit-identity of every output.  Returns the number that differ."""
    import torch
    bad = 0
    for key, t in res.items():
        o = against.get(key)
        if o is None or o.shape != t.shape or not torch.equal(o, t):
            d = "missing" if o is None or o.shape != t.shape else \
                f"max|diff| {float((o.double() - t.double()).abs().max()):.3e}"
            print(f"NOT bit-identical: {key} ({d})")
            bad += 1
    print(f"{len(res) - bad} of {len(res)} outputs bit-identical to the "
          f"other tree's")
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
        print("demod_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke       # this tree's, whatever --tree is
    sys.path.insert(0, os.path.abspath(a.tree))
    from sdrplusplusbrown_tpu_torch.kernels import _build
    parent = "sdr_fm_audio" in _build.SIGNATURES
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
    clock = float(smi.split(",")[-1].split()[0])
    print(f"tree {tree} ({'one-thread-a-row K12, one-thread-an-output K7' if parent else 'warp-a-row K12, K7 on the FIR tile'}): "
          f"{smi}; TF32 off")
    res = {}
    run_agc(dev, smoke, res, clock)
    run_k7(dev, smoke, res)
    if a.plans and not parent:
        plans_k7(dev, smoke)
    if a.save:
        os.makedirs(os.path.dirname(os.path.abspath(a.save)), exist_ok=True)
        torch.save(res, a.save)
    if a.against:
        return 1 if compare(res, torch.load(a.against)) else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
