#!/usr/bin/env python3
"""Where the polyphase FIR tile's time goes (csrc/fir_tile.cuh, the body
of K3 and K8), on one NVIDIA GPU:

    python3 scripts/fir_tile_parts.py [P,G,C ...]

Builds ``sdr_fir_rows`` four more times from patched copies of
``csrc/`` (under the package's ``_build/parts/``, one ``nvcc`` each, all
started together): without the tap loop ("no_compute"), without staging
the input ("no_input"), without either ("no_both"), and with every
phase row's band set to the whole row ("no_band").  Each variant, and
the unpatched source ("base"), is timed with ``chip_smoke.call_profile``
(device µs a call) at four geometries of the paths: K3's (16 real rows,
48/125, its folded kernel), the bank's USB 192/625 on 8 real rows, the
5/6 VFO resampler and the 304-tap stage-0 decimator on 8 complex rows,
under ``fir_kernel.fir_plan``'s plan and each extra ``P,G,C`` given
(warps by the plan's rule).  The variants' outputs are wrong by design;
only their times mean anything.  Needs CUDA and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPUTE = "    if (hi > lo) {\n      const E* xs"
STAGE = ("        if (e < hist)\n          stage(d, tail + e);\n"
         "        else\n          stage(d, x + (e - hist));")
BAND = ("    lo = __reduce_min_sync(0xffffffffu, lo);\n"
        "    hi = __reduce_max_sync(0xffffffffu, hi);")
VARIANTS = {
    "base": [],
    "no_compute": [(COMPUTE, COMPUTE.replace("hi > lo", "false"))],
    "no_input": [(STAGE, "        (void)d;")],
    "no_both": [(COMPUTE, COMPUTE.replace("hi > lo", "false")),
                (STAGE, "        (void)d;")],
    "no_band": [(BAND, "    lo = 0;\n    hi = kw;")],
}


def build_variants(_build) -> dict:
    """{variant: the ctypes sdr_fir_rows of its library}."""
    src = _build.CSRC
    out_dir = os.path.join(_build.BUILD_DIR, "parts")
    procs = []
    for name, subs in VARIANTS.items():
        d = os.path.join(out_dir, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        path = os.path.join(d, "fir_tile.cuh")
        with open(path) as fh:
            text = fh.read()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the tile no longer has {old!r}")
            text = text.replace(old, new)
        with open(path, "w") as fh:
            fh.write(text)
        procs.append((name, d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "fir_rows.cu"),
             os.path.join(d, "runtime.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for name, d, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        fn = ctypes.CDLL(os.path.join(d, "lib.so")).sdr_fir_rows
        fn.argtypes = _build.SIGNATURES["sdr_fir_rows"] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fir_tile_parts: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from sdrplusplusbrown_tpu_torch.kernels import _build
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
    from sdrplusplusbrown_tpu_torch.ops import fir_kernel as fk
    from sdrplusplusbrown_tpu_torch.ops.resampler import RationalResampler

    fns = build_variants(_build)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    m = torch.randn((4096, 4096), generator=g, device=dev)
    for _ in range(150):         # a second of work: the card at its clocks
        m = torch.tanh(m @ m)
    torch.cuda.synchronize()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())

    def resampler(fs, out):
        return dict(RationalResampler(fs, out).chain.named_blocks)[
            "resamp"].kernel

    rng = np.random.default_rng(0)
    cases = [("K3 16 real 48/125", Radio(2.4e6, DEMOD_WFM, device="cpu")
              .demod.audio_poly.kernel, 48, 125, 16, 12_500, False),
             ("8 real 192/625", resampler(10e6, 24e3), 192, 625, 8, 8_125,
              False),
             ("8 cplx 5/6", resampler(2.4e6, 250e3), 5, 6, 8, 60_000, True),
             ("8 cplx 1/4 304", rng.standard_normal((1, 304)), 1, 4, 8,
              240_000, True)]
    extra = [tuple(map(int, a.split(","))) for a in sys.argv[1:]]
    for label, kern, I, D, rows, T, cplx in cases:
        kern = torch.from_numpy(np.asarray(kern, np.float32)).to(dev)
        kw, comps = kern.shape[1], 2 if cplx else 1
        hist = kw - 1
        dt = torch.complex64 if cplx else torch.float32
        x = torch.randn((rows, T), dtype=dt, device=dev, generator=g)
        tail = torch.randn((rows, hist), dtype=dt, device=dev, generator=g)
        n_m = (hist + T - kw) // D + 1
        plans = [fk.fir_plan(I, D, kw, n_m * I, rows, comps)]
        for P, G, C in extra:
            if G <= I and C <= -(-n_m // (32 * P)) and fk.tile_smem(
                    D, kw, n_m, P, G, C, comps) <= fk.SMEM_MAX:
                plans.append({"P": P, "G": G, "C": C, "warps": min(
                    fk.MAX_WARPS, max(4, G * C))})
        y = torch.empty((rows, n_m * I), dtype=dt, device=dev)
        nt = torch.empty_like(tail)
        for p in plans:
            times = []
            for name, fn in fns.items():
                def call(fn=fn, p=p):
                    rc = fn(tail.data_ptr(), hist, x.data_ptr(), T,
                            kern.data_ptr(), I, D, kw, y.data_ptr(),
                            n_m * I, nt.data_ptr(), rows, comps, p["P"],
                            p["G"], p["C"], p["warps"],
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                for _ in range(5):
                    call()
                times.append(f"{name} {smoke.call_profile(call)[0]:.1f}")
            print(f"{label} P{p['P']} G{p['G']} C{p['C']} w{p['warps']}: "
                  + ", ".join(times) + " us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
