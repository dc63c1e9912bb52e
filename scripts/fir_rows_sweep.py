#!/usr/bin/env python3
"""Device time of the port's polyphase FIR kernels, K3
(csrc/mpx_poly.cu) and K8 (csrc/fir_rows.cu), at every geometry the main
paths give them, on one NVIDIA GPU:

    python3 scripts/fir_rows_sweep.py [--tree DIR] [--plans]

Drives two steps of each path on bench-style noise with the wrappers
recording their arguments: WFM-8's ``apply_shared`` (K3, float32 and bf16
handoff), the app step (IQFrontEnd then ``Radio.apply``: WFM at batch ()
and (8,), NFM at ()) and multimode8 at 2.4 and 10 MS/s (K8).  For each
distinct geometry it holds the kernel against its plain version (K8 100
dB and the new tail exact, K3 70 dB in float32 and 50 dB in bf16), then
prints the kernel's device µs a call and its CUDA launches a call
(``chip_smoke.call_profile``), one ``F.conv1d`` of the same function
(TF32 off), the band-counted bound (``chip_smoke.bound``) and the calls a
step on each path.  ``--tree DIR`` imports the port from another
checkout (a parent commit unpacked with ``git archive``), so that one
call can time parent and change in turns on the same card.  ``--plans``
also times, for K3 and the K8 geometries of more than 10 µs, every plan
of a grid (outputs per lane P, phase rows G and output chunks C a block;
``fir_kernel.fir_plan``'s warps rule) and marks ``fir_plan``'s own.
Exits nonzero on a disagreement.  Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2


def capture_paths(dev, smoke) -> dict:
    """{geometry label: (tag, args of its last call, {path: calls a
    step})} over STEPS steps of every path that runs K3 or K8."""
    import torch
    from sdrplusplusbrown_tpu_torch.models import radio_bank as rb
    from sdrplusplusbrown_tpu_torch.models.iq_frontend import IQFrontEnd
    from sdrplusplusbrown_tpu_torch.models.radio import (Radio, DEMOD_NFM,
                                                         DEMOD_WFM)
    from sdrplusplusbrown_tpu_torch.ops import precision

    out = {}

    def record(path, tag, calls, label):
        for call in calls:
            key = label(call)
            _, _, per = out.get(key, (tag, None, {}))
            per[path] = per.get(path, 0) + 1 / STEPS
            out[key] = (tag, call, per)

    fs, T, C = smoke.FS, smoke.STEP, smoke.C
    radio = Radio(fs, DEMOD_WFM, device=dev)
    T8 = (T + radio.in_multiple - 1) // radio.in_multiple * radio.in_multiple
    xr, xi = smoke.noise_planes(T8, dev)
    for handoff in ("float32", "bf16"):
        precision.set_handoff_dtype(handoff)
        params = radio.make_params_shared(smoke.OFFSETS)

        def wfm8(params=params):
            st = radio.init_state_shared(C)
            for _ in range(STEPS):
                _, st = radio.apply_shared(params, st, (xr, xi))
            torch.cuda.synchronize()
        _, cap = smoke.capture(("K3",), wfm8)
        record(f"WFM-8 {handoff}", "K3", cap["K3"],
               lambda call, h=handoff: f"K3 48/125 rows "
               f"{call[1].shape[0]}, {h} handoff")
    precision.set_handoff_dtype("float32")

    fe = IQFrontEnd(fs, decim_ratio=1, fft_size=smoke.FFT, fft_rate=20.0,
                    device=dev)
    wfm = Radio(fs, DEMOD_WFM, squelch_enabled=True, device=dev)
    nfm = Radio(fs, DEMOD_NFM, squelch_enabled=True, device=dev)
    g = int(np.lcm.reduce([fe.in_multiple, wfm.in_multiple,
                           nfm.in_multiple]))
    Ta = (T + g - 1) // g * g
    xa = torch.complex(*smoke.noise_planes(Ta, dev))
    for path, r, batch, offs in (
            ("app WFM ()", wfm, (), smoke.APP_WFM[0]),
            ("app NFM ()", nfm, (), smoke.APP_NFM[0]),
            (f"app WFM ({C},)", wfm, (C,), smoke.OFFSETS)):
        def app(r=r, batch=batch, offs=offs):
            fst, st = fe.init_state(), r.init_state(batch)
            for _ in range(STEPS):
                (bb, _), fst = fe.apply(None, fst, xa)
                _, st = r.apply(r.make_params(offs), st, bb)
            torch.cuda.synchronize()
        _, cap = smoke.capture(("K8",), app)
        record(path, "K8", cap["K8"], smoke.app_stage)

    for bfs in smoke.BANK_FS:
        bank = rb.RadioBank(bfs, rb.multimode8_vfos(), device=dev)
        gb = bank.in_multiple
        Tb = -(-int(bfs * smoke.BANK_SECONDS) // gb) * gb
        xb = smoke.noise_planes(Tb, dev)

        def run_bank(bank=bank, xb=xb):
            params, st = bank.make_params(), bank.init_state()
            for _ in range(STEPS):
                _, st = bank.apply(params, st, xb, mono_out=True)
            torch.cuda.synchronize()
        _, cap = smoke.capture(("K8",), run_bank)
        record(smoke.bank_label(bfs), "K8", cap["K8"], smoke.app_stage)
    return out


def plan_grid(fir_kernel, tag, args) -> list:
    """Every plan of the grid that fits the card, for K3 or K8 ``args``
    (the plan's dict form), ``fir_plan``'s own first."""
    if tag == "K3":
        pipe, raw, m_in = args[:3]
        I, D, kw, rows, comps = pipe.I, pipe.D, pipe.kernel.shape[1], \
            raw.shape[0], 1
        n_m = m_in // D
    else:
        x, tail, kern, I, D = args
        kw, rows = kern.shape[1], x.numel() // x.shape[-1]
        comps = 2 if x.is_complex() else 1
        n_m = (tail.shape[-1] + x.shape[-1] - kw) // D + 1
    own = fir_kernel.fir_plan(I, D, kw, n_m * I, rows, comps)
    out = [own]
    for P in fir_kernel.OUTS_PER_LANE:
        n_c = -(-n_m // (32 * P))
        for G in sorted({g for g in (1, 2, 4, 8, 16, 48, I) if g <= I}):
            for C in (1, 2, 4, 8):
                if C > n_c or fir_kernel.tile_smem(
                        D, kw, n_m, P, G, C, comps) > fir_kernel.SMEM_MAX:
                    continue
                if (P, G, C) == (own["P"], own["G"], own["C"]):
                    continue
                grid = (-(-n_c // C), -(-I // G), rows)
                out.append({"P": P, "G": G, "C": C, "grid": grid,
                            "warps": min(fir_kernel.MAX_WARPS,
                                         max(4, G * C))})
    return out


def time_plans(smoke, fir_kernel, wfm_kernel, label, tag, args, kern):
    """Device µs a call of ``kern(*args)`` under each plan of
    ``plan_grid``: the fastest five and fir_plan's own."""
    rows = []
    real = fir_kernel.fir_plan
    try:
        for p in plan_grid(fir_kernel, tag, args):
            forced = (lambda *_, p=p: p)
            fir_kernel.fir_plan = wfm_kernel.fir_plan = forced
            for _ in range(5):
                kern(*args)
            rows.append((smoke.call_profile(lambda: kern(*args),
                                            reps=10)[0], p))
    finally:
        fir_kernel.fir_plan = wfm_kernel.fir_plan = real
    own = rows[0]
    best = sorted(rows, key=lambda r: r[0])
    print(f"  plans for {tag} {label}: fir_plan's P {own[1]['P']} G "
          f"{own[1]['G']} C {own[1]['C']} {own[0]:.1f} us, rank "
          f"{best.index(own) + 1} of {len(rows)}; fastest: "
          + "; ".join(f"P {p['P']} G {p['G']} C {p['C']} w {p['warps']} "
                      f"{us:.1f}" for us, p in best[:5]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--plans", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fir_rows_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke       # this tree's, whatever --tree is
    sys.path.insert(0, os.path.abspath(a.tree))
    from sdrplusplusbrown_tpu_torch.ops import fir_kernel, wfm_kernel
    tree = os.path.relpath(os.path.dirname(os.path.dirname(
        fir_kernel.__file__)), ROOT)
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
    print(f"tree {tree}: {smi}; TF32 off")
    bad = 0
    for label, (tag, args, per) in sorted(capture_paths(dev, smoke).items()):
        mod = wfm_kernel if tag == "K3" else fir_kernel
        name = "mpx_audio_poly" if tag == "K3" else "fir_rows"
        kern = getattr(mod, name + "_kernel")
        ref = getattr(mod, name + "_ref")
        got, want = kern(*args), ref(*args)
        ok = True
        if tag == "K8":
            ok = torch.equal(got[1], want[1])
            got, want = got[0], want[0]
        if got.is_complex():
            got, want = torch.view_as_real(got), torch.view_as_real(want)
        bar = 100.0 if tag == "K8" else (50.0 if "bf16" in label else 70.0)
        sn = smoke.snr_db(want.float(), got.float()) if want.any() else (
            float("inf") if not got.any() else 0.0)
        ok = ok and sn >= bar and bool(torch.isfinite(got).all())
        bad += not ok
        for _ in range(30):
            kern(*args)
        us, n = smoke.call_profile(lambda: kern(*args))
        lib = smoke.library_call(tag, args)
        lib_us = smoke.device_us(lib)
        bms, by = smoke.bound(tag, args)
        print(f"[{tree}] {tag} {label}: {us:.1f} us in {n} launches; "
              f"conv1d {lib_us:.1f} us; bound {bms * 1e3:.2f} us ({by}); "
              f"{sn:.1f} dB (bar {bar:.0f}){'' if ok else ' FAILED'}; "
              "calls a step: " + ", ".join(f"{p} {v:g}" for p, v in
                                           per.items()))
        if a.plans and (tag == "K3" or us > 10.0):
            time_plans(smoke, fir_kernel, wfm_kernel, label, tag, args, kern)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
