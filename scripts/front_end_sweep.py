#!/usr/bin/env python3
"""K1 (csrc/mono_frontend.cu), K2 and K10 (csrc/wfm_demod.cu) of one tree
on one NVIDIA GPU, for a parent / change comparison:

    python3 scripts/front_end_sweep.py [--tree DIR] [--save F] [--against F]
                                       [--plans]

Geometries: K1 on every call the paths make — WFM-8 (C = 8, 240 000
samples, the float32 and the bf16 handoff) and multimode8 at 2.4 MS/s
(its NFM, AM and USB groups, C = 4, bf16 handoff, each group's own IF
dtype); K2 at WFM-8's shape (C = 8, 50 000 IF samples, float32 and bf16);
K10 at app WFM (8,)'s (8 × 12 500 MPX).  Inputs are made from seeds, so
two trees see the same bits.  For each geometry it prints the kernel's
device µs and CUDA launches a call (``chip_smoke.call_profile``), K1's
split into the mix stage and the chained stages, and the bound
(``chip_smoke.bound``).  K1's stage 0 is held against its plain version
on the wideband (max|err|, dB); its chained stages then run on a seeded
stage-0 output, so that each stage's output and new tail depend on the
chain's kernels only.  K2 gives its discriminator output, each halfband's
output, the L/R planes and the new state; K10 its L/R planes.

``--plans`` (this design's trees only) also times K1's mix stage and
each chained stage, and each of K2's launches, under every plan of a
grid, and ranks the plan in use (``mix_plan``, ``fir_plan``,
``demod_plan``) among them.  ``--tree DIR`` imports the port from
another checkout (a parent commit
unpacked with ``git archive``; a tree from before K1 and K2 moved to the
FIR tile runs their former entry points, and the new tails are then the
former wrapper's cat-slice-round of the stage inputs).  ``--save F``
writes every output to F (torch.save); ``--against F`` compares each
with F's and exits 1 where a chained K1 stage, a new tail, K2's
discriminator, halfbands, L/R or state, or K10 is not bit-identical.
Run it parent / change / change / parent in one call, each against the
previous.  Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M_IF = 50_000          # WFM-8's IF samples a step (500 kS/s, 0.1 s)
K10_SHAPE = (8, 12_500)


def complex_rows(rng, shape, scale=0.3):
    import torch
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.from_numpy((scale * z).astype(np.complex64))


def rounded(t, dtype):
    """``t`` with its values (both parts) rounded to ``dtype`` storage."""
    import torch
    if dtype == torch.float32:
        return t
    if t.is_complex():
        return torch.complex(t.real.to(dtype).float(),
                             t.imag.to(dtype).float())
    return t.to(dtype).float()


def planes(y):
    """complex [C, m] → [2C, m] float32 (re rows, im rows); planes pass."""
    import torch
    if y.is_complex():
        return torch.cat([y.real, y.imag]).float()
    return y.float()


def k1_cases(dev, smoke):
    """(label, VFO bank, its fused params, C, T, out dtype, handoff) of
    every K1 call of the paths."""
    from sdrplusplusbrown_tpu_torch.models import radio_bank as rb
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
    import torch
    radio = Radio(smoke.FS, DEMOD_WFM, device=dev)
    g = radio.in_multiple
    T8 = (smoke.STEP + g - 1) // g * g
    vb = radio._build_vfo_shared()
    out = []
    for h in ("float32", "bf16"):
        dt = torch.float32 if h == "float32" else torch.bfloat16
        out.append((f"K1 WFM-8 {h}", vb, vb.make_params(smoke.OFFSETS)[
            "fused"], smoke.C, T8, dt, h))
    bank = rb.RadioBank(smoke.BANK_FS[0], rb.multimode8_vfos(), device=dev)
    gb = bank.in_multiple
    Tb = -(-int(smoke.BANK_FS[0] * smoke.BANK_SECONDS) // gb) * gb
    params = bank.make_params()
    for d, r in bank.radios.items():
        p = params[d]["vfo"]["fused"]
        # the NFM group hands K7 the raw buffer, AM and USB a float32 IF
        dt = torch.bfloat16 if r.demod_name == "NFM" else torch.float32
        out.append((f"K1 multimode8 {r.demod_name} bf16",
                    r._build_vfo_shared(), p, p["omega"].shape[0], Tb, dt,
                    "bf16"))
    return out


def run_k1(label, bank, params, C, T, out_dt, handoff, dev, smoke, parent,
           res):
    import torch
    from sdrplusplusbrown_tpu_torch.kernels import _build
    from sdrplusplusbrown_tpu_torch.ops import mono_frontend as mf
    from sdrplusplusbrown_tpu_torch.ops import precision
    precision.set_handoff_dtype(handoff)
    h_dt = precision.get_handoff_dtype()
    t_dt = h_dt if C >= 16 else torch.float32
    pipe = bank.pipe()
    rng = np.random.default_rng(T + C)
    xr, xi = (torch.from_numpy((0.1 * rng.standard_normal(T))
                               .astype(np.float32)).to(dev)
              for _ in range(2))
    state = bank.init_state(C)
    tail = complex_rows(rng, (pipe.K0 - 1,), 0.1).to(dev)
    omega = params["omega"].contiguous()
    base = pipe.base_phases(params, state["fused"]["phase"], T)
    tails = [rounded(complex_rows(rng, (C, st["carry"])), t_dt).to(dev)
             for st in pipe.stages]
    h0, kernels = pipe.taps(dev, h_dt)
    m = pipe.lengths(T)
    if parent:
        tps = [rounded(planes(t), t_dt).contiguous() for t in tails]
        args = (pipe, xr, xi, tail, omega, base, tps, out_dt, h_dt)
        y0 = mf.mono_frontend_kernel(*args)[1][0]
        y0_ref = mf.mono_frontend_ref(*args)[1][0]
    else:
        args = (pipe, xr, xi, tail, omega, base, tails, out_dt, h_dt, t_dt)
        y0 = planes(mf.mono_mix_kernel(pipe, xr, xi, tail, omega, base, h0))
        y0_ref = mf.mono_mix_ref(pipe, xr, xi, tail, omega, base, h0)
    split = {}
    us, n = smoke.call_profile(lambda: mf.mono_frontend_kernel(*args),
                               by_kernel=split)
    mix = sum(v for k, v in split.items() if "mix" in k)
    bms, by = smoke.bound("K1", args)
    err = float((y0 - y0_ref).abs().max())
    snr = smoke.snr_db(y0_ref.double(), y0.double())
    buf, want = (mf.mono_frontend_kernel(*args)[0].float(),
                 mf.mono_frontend_ref(*args)[0].float())
    print(f"{label}: {us:.1f} us in {n} launches (mix stage {mix:.1f}, "
          f"chained stages {us - mix:.1f}); bound {bms * 1e3:.2f} us ({by}); "
          f"stage 0 against its plain version: max|err| {err:.3e}, "
          f"{snr:.1f} dB; the IF against the plain version's: max|err| "
          f"{float((buf - want).abs().max()):.3e}, "
          f"{smoke.snr_db(want.double(), buf.double()):.1f} dB")
    res[f"{label}/stage0 dB"] = snr
    # the chained stages on a seeded stage-0 output
    y0f = complex_rows(rng, (C, m[0])).to(dev)
    outs, new_tails = [], []
    if parent:
        y = planes(y0f).contiguous()
        for s, (st, tp, ker) in enumerate(zip(pipe.stages, tps, kernels)):
            last = s == len(pipe.stages) - 1
            out = torch.empty((2 * C, m[s + 1]), device=dev,
                              dtype=out_dt if last else torch.float32)
            _build.launch(
                "sdr_mono_poly_stage", dev, tp.data_ptr(), st["carry"],
                y.data_ptr(), m[s], ker.data_ptr(), st["I"], st["D"],
                ker.shape[1], out.data_ptr(), int(out.dtype != torch.float32),
                m[s + 1], 2 * C)
            nt = rounded(torch.cat([tp, y], dim=1)[:, -st["carry"]:], t_dt)
            new_tails.append(torch.complex(nt[:C], nt[C:]))
            outs.append(out)
            y = out
    else:
        buf, new_tails, mids = mf.mono_stages_kernel(pipe, y0f, tails,
                                                     kernels, out_dt, t_dt)
        outs = mids + [buf]
    torch.cuda.synchronize()
    for s, y in enumerate(outs):
        res[f"{label}/stage {s + 1}"] = planes(y).cpu()
    for s, t in enumerate(new_tails):
        res[f"{label}/tail {s + 1}"] = torch.view_as_real(t).cpu()


def stereo_if(C: int, n: int, seed: int) -> np.ndarray:
    """[2C, n] IF planes: channel k a stereo FM broadcast at baseband."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 500e3
    x = np.zeros((C, n), np.complex128)
    for k in range(C):
        tone = np.sin(2 * np.pi * (400 + 100 * k) * t)
        mpx = (0.45 * tone - 0.45 * tone * np.cos(2 * np.pi * 38e3 * t)
               + 0.1 * np.sin(2 * np.pi * 19e3 * t))
        x[k] = np.exp(2j * np.pi * 75e3 * np.cumsum(mpx) / 500e3)
    x += 1e-3 * (rng.standard_normal(x.shape)
                 + 1j * rng.standard_normal(x.shape))
    return np.concatenate([x.real, x.imag]).astype(np.float32)


def run_k2(handoff, dev, smoke, parent, res):
    import torch
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
    from sdrplusplusbrown_tpu_torch.ops import precision
    from sdrplusplusbrown_tpu_torch.ops import wfm_kernel as wk
    precision.set_handoff_dtype(handoff)
    dt = precision.get_handoff_dtype()
    pipe = Radio(smoke.FS, DEMOD_WFM, device=dev).demod.pipes()[0]
    C = smoke.C
    rng = np.random.default_rng(7)
    iq = torch.from_numpy(stereo_if(C, M_IF, 7)).to(dev).to(dt)
    quad = rounded(complex_rows(rng, (C, 1)), dt).to(dev)
    hbt = [rounded(torch.from_numpy(rng.standard_normal(
        (C, len(h) - 1)).astype(np.float32)), dt).to(dev)
        for h in pipe.hb_taps]
    hist = rounded(torch.from_numpy(rng.standard_normal(
        (C, pipe.K)).astype(np.float32)), dt).to(dev)
    label = f"K2 WFM-8 {handoff}"
    if parent:
        q = quad[:, 0]
        args = (pipe, iq, M_IF, torch.cat([q.real, q.imag]).contiguous(),
                hbt, hist, dt)
        lr, ins = wk.wfm_demod_kernel(*args)
        last = rounded(iq[:, M_IF - 1].float(), dt)
        new_q = torch.complex(last[:C], last[C:])[:, None]
        new_t = [rounded(torch.cat([t, y], dim=1)[:, -t.shape[1]:], dt)
                 for t, y in zip(hbt, ins[:-1])]
        new_h = rounded(torch.cat([hist, ins[-1]], dim=1)[:, -pipe.K:], dt)
        mids = ins
    else:
        args = (pipe, iq, M_IF, quad, hbt, hist, dt)
        lr, new_q, new_t, new_h, mids = wk._wfm_demod_launches(*args,
                                                               probe=True)
    us, n = smoke.call_profile(lambda: wk.wfm_demod_kernel(*args))
    bms, by = smoke.bound("K2", args)
    want = wk.wfm_demod_ref(*args)[0].float()
    print(f"{label}: {us:.1f} us in {n} launches; bound {bms * 1e3:.2f} us "
          f"({by}); L/R against the plain version's: max|err| "
          f"{float((lr.float() - want).abs().max()):.3e}, "
          f"{smoke.snr_db(want.double(), lr.double()):.1f} dB")
    torch.cuda.synchronize()
    for key, t in (("discriminator", mids[0]), ("halfband 1", mids[1]),
                   ("halfband 2", mids[2]), ("L/R", lr),
                   ("quad", torch.view_as_real(new_q)),
                   ("mpx_decim 0", new_t[0]), ("mpx_decim 1", new_t[1]),
                   ("mpx_hist", new_h)):
        res[f"{label}/{key}"] = t.float().cpu()


def run_k10(dev, smoke, res):
    import torch
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
    from sdrplusplusbrown_tpu_torch.ops import wfm_kernel as wk
    pipe = Radio(smoke.FS, DEMOD_WFM, device=dev).demod.pipes()[0]
    rng = np.random.default_rng(10)
    mpx = torch.from_numpy(rng.standard_normal(K10_SHAPE).astype(
        np.float32)).to(dev)
    hist = torch.from_numpy(rng.standard_normal(
        (K10_SHAPE[0], pipe.K)).astype(np.float32)).to(dev)
    args = (pipe, mpx, hist)
    us, n = smoke.call_profile(lambda: wk.wfm_stereo_kernel(*args))
    bms, by = smoke.bound("K10", args)
    got, want = wk.wfm_stereo_kernel(*args), wk.wfm_stereo_ref(*args)
    print(f"K10 app WFM (8,): {us:.1f} us in {n} launches; bound "
          f"{bms * 1e3:.2f} us ({by}); against the plain version: max|err| "
          f"{float((got - want).abs().max()):.3e}")
    res["K10 app WFM (8,)/L/R"] = got.cpu()


def fastest(label, own, rows) -> None:
    """Prints ``own``'s time and rank among ``rows`` [(µs, plan)] and the
    fastest five (a plan the profiler saw no kernel of is left out)."""
    rows = sorted((r for r in rows if r[0] > 0), key=lambda r: r[0])
    rank = next(i for i, r in enumerate(rows) if r[1] == own) + 1
    print(f"  plans for {label}: own {own} {rows[rank - 1][0]:.1f} us, rank "
          f"{rank} of {len(rows)}; fastest: "
          + "; ".join(f"{p} {us:.1f}" for us, p in rows[:5]))


def plans_k1(label, bank, params, C, T, out_dt, handoff, dev, smoke):
    """K1's mix stage under every (P, Cc, warps) of a grid (mix_plan
    forced), and each chained stage under every (P, C, G, warps) that
    fits (launched alone, fir_plan's own first)."""
    import itertools
    import torch
    from sdrplusplusbrown_tpu_torch.kernels import _build
    from sdrplusplusbrown_tpu_torch.ops import fir_kernel as fk
    from sdrplusplusbrown_tpu_torch.ops import mono_frontend as mf
    from sdrplusplusbrown_tpu_torch.ops import precision
    precision.set_handoff_dtype(handoff)
    h_dt = precision.get_handoff_dtype()
    pipe = bank.pipe()
    rng = np.random.default_rng(T + C)
    xr, xi = (torch.from_numpy((0.1 * rng.standard_normal(T))
                               .astype(np.float32)).to(dev)
              for _ in range(2))
    state = bank.init_state(C)
    tail = state["fused"]["tail"].contiguous()
    base = pipe.base_phases(params, state["fused"]["phase"], T)
    h0, kernels = pipe.taps(dev, h_dt)
    m = pipe.lengths(T)
    real = mf.mix_plan
    own = real(m[0], pipe.adv0, C, pipe.K0, pipe.D0)
    rows = []
    try:
        for P, Cc, W in itertools.product((5, 3, 1), (8, 4, 2, 1), (4, 8)):
            if fk.tile_smem(pipe.D0, pipe.K0, m[0], P, 1, Cc, 2) > \
                    fk.SMEM_MAX:
                continue
            mf.mix_plan = lambda *a, p={"P": P, "Cc": Cc, "warps": W}: p
            rows.append((smoke.call_profile(lambda: mf.mono_mix_kernel(
                pipe, xr, xi, tail, params["omega"], base, h0), 10)[0],
                (P, Cc, W)))
    finally:
        mf.mix_plan = real
    fastest(f"{label} mix stage (P, Cc, warps)",
            (own["P"], own["Cc"], own["warps"]), rows)
    for s, (st, ker) in enumerate(zip(pipe.stages, kernels)):
        I, D, kw, hist = st["I"], st["D"], ker.shape[1], st["carry"]
        y = complex_rows(rng, (C, m[s])).to(dev)
        tl = complex_rows(rng, (C, hist)).to(dev)
        out = torch.empty((C, m[s + 1]), dtype=torch.complex64, device=dev)
        nt = torch.empty_like(tl)

        def run(p):
            _build.launch(
                "sdr_mono_stage", dev, tl.data_ptr(), hist, 0, y.data_ptr(),
                m[s], ker.data_ptr(), I, D, kw, out.data_ptr(), 0, m[s + 1],
                C, nt.data_ptr(), *p)
        own = fk.fir_plan(I, D, kw, m[s + 1], C, 2)
        own = (own["P"], own["G"], own["C"], own["warps"])
        grid = {own} | {
            (P, G, Cc, W) for P, Cc, G, W in itertools.product(
                (5, 3, 1), (8, 4, 2, 1), {1, min(I, 4), min(I, 8)}, (4, 8))
            if fk.tile_smem(D, kw, m[s + 1] // I, P, G, Cc, 2)
            <= fk.SMEM_MAX}
        rows = [(smoke.call_profile(lambda p=p: run(p), 10)[0], p)
                for p in sorted(grid)]
        fastest(f"{label} stage {s + 1} {I}/{D} kw {kw} (P, G, C, warps)",
                own, rows)


def plans_k2(dev, smoke):
    """Each of K2's three launches at WFM-8 (bf16) under every (P, C,
    warps) of a grid, the other two on demod_plan's; per-kernel device
    µs from the profiler."""
    import itertools
    import torch
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
    from sdrplusplusbrown_tpu_torch.ops import precision
    from sdrplusplusbrown_tpu_torch.ops import wfm_kernel as wk
    precision.set_handoff_dtype("bf16")
    dt = precision.get_handoff_dtype()
    pipe = Radio(smoke.FS, DEMOD_WFM, device=dev).demod.pipes()[0]
    C = smoke.C
    iq = torch.from_numpy(stereo_if(C, M_IF, 7)).to(dev).to(dt)
    args = (pipe, iq, M_IF, torch.zeros((C, 1), dtype=torch.complex64,
                                        device=dev),
            [torch.zeros((C, len(h) - 1), device=dev) for h in pipe.hb_taps],
            torch.zeros((C, pipe.K), device=dev), dt)
    real = wk.demod_plan
    names = ("quad_halfband_kernel", "halfband_kernel", "stereo_kernel")
    for k, name in enumerate(names):
        rows = []
        for P, Cc, W in itertools.product((5, 3, 1), (8, 4, 2, 1), (4, 8)):
            calls = []

            def forced(n_out, rows_, P=P, Cc=Cc, W=W):
                p = dict(real(n_out, rows_))
                if len(calls) % 3 == k:
                    p.update(P=P, C=Cc, warps=W,
                             grid=(-(-n_out // (32 * P * Cc)), 1, rows_))
                calls.append(p)
                return p
            wk.demod_plan = forced
            split = {}
            try:
                smoke.call_profile(lambda: wk.wfm_demod_kernel(*args), 10,
                                   by_kernel=split)
            finally:
                wk.demod_plan = real
            rows.append((split.get(name, 0.0), (P, Cc, W)))
        p = real(M_IF >> (k + 1) if k < 2 else M_IF >> 2, C)
        own = (p["P"], p["C"], p["warps"])
        fastest(f"K2 WFM-8 bf16 {name} (P, C, warps)", own, rows)


def compare(res, against) -> int:
    """Bit-identity of every output but stage 0's agreement; prints both
    trees' stage-0 agreement.  Returns the number of differing outputs."""
    import torch
    bad = 0
    for key, t in res.items():
        o = against.get(key)
        if key.endswith("stage0 dB"):
            print(f"{key}: this tree {t:.1f}, the other {o:.1f}")
            continue
        if o is None or o.shape != t.shape or not torch.equal(o, t):
            d = "missing" if o is None or o.shape != t.shape else \
                f"max|diff| {float((o.double() - t.double()).abs().max()):.3e}"
            print(f"NOT bit-identical: {key} ({d})")
            bad += 1
    n = sum(not k.endswith("dB") for k in res)
    print(f"{n - bad} of {n} outputs bit-identical to the other tree's")
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
        print("front_end_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke       # this tree's, whatever --tree is
    sys.path.insert(0, os.path.abspath(a.tree))
    from sdrplusplusbrown_tpu_torch.kernels import _build
    parent = "sdr_mono_poly_stage" in _build.SIGNATURES
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
        check=True).stdout.strip()
    print(f"tree {tree} ({'one-thread-an-output' if parent else 'FIR tile'}"
          f" K1/K2): {smi}; TF32 off")
    res = {}
    for case in k1_cases(dev, smoke):
        run_k1(*case, dev, smoke, parent, res)
    for h in ("float32", "bf16"):
        run_k2(h, dev, smoke, parent, res)
    run_k10(dev, smoke, res)
    if a.plans and not parent:
        for case in k1_cases(dev, smoke)[1:]:
            plans_k1(*case, dev, smoke)
        plans_k2(dev, smoke)
    if a.save:
        os.makedirs(os.path.dirname(os.path.abspath(a.save)), exist_ok=True)
        torch.save(res, a.save)
    if a.against:
        return 1 if compare(res, torch.load(a.against)) else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
