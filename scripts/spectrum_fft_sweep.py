#!/usr/bin/env python3
"""Device time of the port's spectrum FFT kernels (csrc/spectrum_fft.cu)
at the main paths' shapes, on one NVIDIA GPU:

    python3 scripts/spectrum_fft_sweep.py [--tree DIR] [--blocking]

Times, with ``chip_smoke.call_profile`` (the profiler's device µs per
call and the kernels a call launches), K4 on two 65 536-point frames of
(xr, xi) planes (WFM-8's spectrum), K4f on two frames of 65 536 and of
262 144 points of a complex block (the app step's), and K4r on
channelizer64's 64 × 32 frames of 1 024 from bf16 bins, each beside one
``torch.fft.fft`` of the same frames.  ``--tree DIR`` imports the port
from another checkout (a parent commit unpacked with ``git archive``), so
that one call can time parent and change in turns on the same card.
``--blocking`` also runs every columns- and rows-per-block choice of the
four-step route at 2 × 65 536 and 2 × 262 144 points and 1, 2 or 4
frames a block of the one-pass route at channelizer64, marking ``plan``'s
own.  Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--blocking", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("spectrum_fft_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke                # this tree's, whatever --tree is
    sys.path.insert(0, os.path.abspath(a.tree))
    from sdrplusplusbrown_tpu_torch.ops import fft_kernel as fk
    tree = os.path.relpath(os.path.dirname(os.path.dirname(fk.__file__)),
                           ROOT)
    dev = torch.device("cuda", 0)
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
    print(f"tree {tree}: {smi}")

    def timed(label, fn, lib=None):
        split = {}
        for _ in range(30):
            fn()
        us, n = chip_smoke.call_profile(fn, by_kernel=split)
        print(f"[{tree}] {label}: {us:.1f} us in {n} launches ("
              + ", ".join(f"{k} {v:.1f}" for k, v in split.items()) + ")"
              + ("" if lib is None else
                 f"; torch.fft.fft {chip_smoke.device_us(lib):.1f} us"))

    x = torch.randn(240_000, generator=g, device=dev, dtype=torch.complex64)
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    for N, keep in ((65_536, 65_536), (262_144, 120_000)):
        win = torch.rand(keep, generator=g, device=dev)
        fr = torch.stack([x[p:p + keep] for p in (0, 120_000)]) * win
        timed(f"K4f 2 x {N}", lambda: fk.spectrum_path_db(
            x, keep, 120_000, N, -300.0, win),
            lambda: torch.fft.fft(fr, n=N, dim=-1))
    win = torch.rand(65_536, generator=g, device=dev)
    fr = torch.stack([torch.complex(xr[p:p + 65_536], xi[p:p + 65_536])
                      for p in (0, 120_832)]) * win
    timed("K4 2 x 65536", lambda: fk.spectrum_frames_db(
        xr, xi, 65_536, 120_000, 65_536, -300.0, win),
        lambda: torch.fft.fft(fr, dim=-1))
    bins = torch.randn((128, 32 * 1024 + 512), generator=g,
                       device=dev).to(torch.bfloat16)
    v = (bins[:64, :32 * 1024].reshape(64, 32, 1024),
         bins[64:, :32 * 1024].reshape(64, 32, 1024))
    fr = torch.complex(v[0].float(), v[1].float())
    timed("K4r 64 x 32 x 1024 bf16", lambda: fk.fft_power_db_planes(
        *v, 1024), lambda: torch.fft.fft(fr, dim=-1))
    if not a.blocking:
        return 0
    plan = fk.plan

    def forced(per):
        """``plan`` with every launch at ``per`` sequences a block."""
        def p(N, n):
            out = plan(N, n)
            out["launches"] = tuple(dict(ln, per_block=per)
                                    for ln in out["launches"])
            return out
        return p

    cases = [(N, keep, plan(N, 2)) for N, keep in ((65_536, 65_536),
                                                   (262_144, 120_000))]
    for N, keep, p in cases:
        win = torch.rand(keep, generator=g, device=dev)
        per = 1
        while per * p["sizes"][0] // fk.E <= fk.BLOCK:
            fk.plan = forced(per)
            mark = " (plan)" if per == p["launches"][0]["per_block"] else ""
            try:
                timed(f"K4f 2 x {N}, {per} a block{mark}",
                      lambda: fk.spectrum_path_db(x, keep, 120_000, N,
                                                  -300.0, win))
            finally:
                fk.plan = plan
            per *= 2
    for per in (1, 2, 4):
        fk.plan = forced(per)
        mark = " (plan)" if per == plan(1024, 2048)["launches"][0][
            "per_block"] else ""
        try:
            timed(f"K4r 64 x 32 x 1024 bf16, {per} a block{mark}",
                  lambda: fk.fft_power_db_planes(*v, 1024))
        finally:
            fk.plan = plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
