#!/usr/bin/env python3
"""K11 (csrc/fused_mix.cu) and K5 in both forms (csrc/pfb_channelizer.cu)
of one tree on one NVIDIA GPU, for a parent / change comparison:

    python3 scripts/chz_mix_sweep.py [--tree DIR] [--save F] [--against F]
                                     [--plans] [--parts] [--phases]
                                     [--sass]

K11 at multimode8's 10 MS/s shapes (each group's stage 0: C = 4 of the
bank's own taps and params, T = 1 040 000) and at C = 12 (the three
groups' worth of channels on the NFM group's stage 0), then at the
2.4 MS/s groups' stage 0 and the card tests' shapes; K5 at scanner128's
and scanner256's shape (2×-oversampled, M = 48, tpp = 6, T = 240 000,
10 240 frames) and channelizer64's (critical, M = 64, tpp = 19, T = 2^21,
32 768 frames), then at the card tests' critical shapes, each with
float32 and with bf16 taps (K5: float32 bins, and the production bf16
ones timed beside them).  Inputs, tails and
phases are made from seeds, so two trees see the same bits.  For each it
prints the kernel's device µs a call and CUDA launches
(``chip_smoke.call_profile``), the bound (``chip_smoke.bound``) and the
agreement with the plain version on the card.  It keeps every K11 output,
K5's float32 bins and K5's folded frames: the tree's own probe
(``channelizer_kernel._launch_pfb(..., probe=True)``) where it has one,
else the bins of an identity DFT matrix (cos = I, sin = 0, the (−1)^m
sign undone), which the direct-DFT kernel of earlier trees returns as the
folded frames exactly.

``--plans`` (trees with ``fused_plan``) also times K11 at the bank shape
under every block size and K5 at each shape under every tile and grid
that fits, each beside the plan's own choice.  ``--parts`` (the same
trees) builds patched copies of the two sources (one ``nvcc`` each, all
started together, under the package's ``_build/chz_parts/``) without
K11's twiddle, its taps or its staging, without K5's tensor-core
products, its fold, its staging or its store, and times each at the path
shapes: what each part costs.  Their outputs are wrong by design; only
the times mean anything.  ``--phases`` times the phases of a
warp-specialised K5 block with clock64 stamps (``phases``).  Both check
every patch site (``check_patches``) before anything runs on the card.
``--sass`` prints the static SASS opcode counts of both kernels
(``cuobjdump -sass``).
``--tree DIR`` imports the port from another checkout (a parent commit
unpacked with ``git archive``).  ``--save F`` writes every kept output to
F (torch.save); ``--against F`` compares with F's and exits 1 where a K11
output or a folded frame is not bit-identical, or where float32 bins are
under 100 dB.  Run it parent / change / change / parent in one call, each
against the previous.  Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import itertools
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BINS_DB = 100.0


def agree(got, want, smoke) -> str:
    import torch
    g, w = got.float(), want.float()
    if torch.equal(g, w):
        return "bit-identical"
    return (f"max|err| {float((g - w).abs().max()):.3e}, "
            f"{smoke.snr_db(w.double(), g.double()):.1f} dB")


def k11_cases(dev, smoke):
    """[(label, K11 arguments)]: each 10 MS/s group's stage 0, and C = 12."""
    import torch
    from sdrplusplusbrown_tpu_torch.models import radio_bank as rb
    from sdrplusplusbrown_tpu_torch.ops import fused_frontend as ff
    fs = smoke.BANK_FS[1]
    bank = rb.RadioBank(fs, rb.multimode8_vfos(), device=dev)
    g = bank.in_multiple
    T = -(-int(fs * smoke.BANK_SECONDS) // g) * g
    rng = np.random.default_rng(11)
    xr, xi = (torch.from_numpy((0.1 * rng.standard_normal(T)).astype(
        np.float32)).to(dev) for _ in range(2))
    out, first = [], None
    params = bank.make_params()
    for d, r in bank.radios.items():
        fused = r._build_vfo_shared().fused
        p = params[d]["vfo"]["fused"]
        C = p["omega"].shape[0]
        tail = [torch.from_numpy((0.1 * rng.standard_normal(fused.K - 1))
                                 .astype(np.float32)).to(dev)
                for _ in range(2)]
        phase = torch.from_numpy(rng.uniform(-3, 3, C).astype(np.float32))
        args = (xr, xi, *tail, fused.h(dev), fused.decim, p["omega"],
                phase.to(dev), p["omega_dec"], p["omega_dec_span"])
        out.append((f"K11 10 MS/s {r.demod_name} C={C} K={fused.K} "
                     f"D={fused.decim}", args))
        first = first or (fused, args)
    fused, args = first
    offs = np.linspace(-4.5e6, 4.4e6, 12) + 917.0
    p = ff.fused_params(offs, fs, fused.decim)
    phase = torch.from_numpy(rng.uniform(-3, 3, 12).astype(np.float32))
    out.append((f"K11 10 MS/s C=12 K={fused.K} D={fused.decim}",
                args[:6] + (p["omega"].to(dev), phase.to(dev),
                            p["omega_dec"].to(dev),
                            p["omega_dec_span"].to(dev))))
    return out


def k11_more(dev, smoke):
    """[(label, K11 arguments)] held bit for bit but not timed in the plan
    and part grids: each 2.4 MS/s group's stage 0 (off the path, as
    ``chip_smoke.py`` phase 13 holds them) and the card tests' shapes."""
    import torch
    from sdrplusplusbrown_tpu_torch.models import radio_bank as rb
    from sdrplusplusbrown_tpu_torch.ops import fused_frontend as ff
    out = []
    rng = np.random.default_rng(24)
    bank = rb.RadioBank(smoke.BANK_FS[0], rb.multimode8_vfos(), device=dev)
    T = -(-int(smoke.BANK_FS[0] * smoke.BANK_SECONDS) // bank.in_multiple) \
        * bank.in_multiple
    xr, xi = (torch.from_numpy((0.1 * rng.standard_normal(T)).astype(
        np.float32)).to(dev) for _ in range(2))
    params = bank.make_params()
    for d, r in bank.radios.items():
        fused = r._build_vfo_shared().fused
        p = params[d]["vfo"]["fused"]
        tail = [torch.from_numpy((0.1 * rng.standard_normal(fused.K - 1))
                                 .astype(np.float32)).to(dev)
                for _ in range(2)]
        out.append((f"K11 2.4 MS/s {r.demod_name} stage 0 K={fused.K}",
                    (xr, xi, *tail, fused.h(dev), fused.decim, p["omega"],
                     torch.zeros_like(p["omega"]), p["omega_dec"],
                     p["omega_dec_span"])))
    for (C, K, T), span in itertools.product(
            [(1, 31, 4 * 1000), (4, 31, 4 * 260_017), (4, 320, 4 * 777),
             (64, 34, 2 * 4 * 9999)], (10e3, 4.9e6)):
        D = 2 if C == 64 else 4
        x = (rng.standard_normal((2, T)) * 0.3).astype(np.float32)
        tail = (rng.standard_normal((2, K - 1)) * 0.3).astype(np.float32)
        p = ff.fused_params(np.linspace(-span, 0.98 * span, C) + 917.0, 10e6,
                            D)
        taps = (np.hanning(K + 2)[1:-1] / K).astype(np.float32)
        args = tuple(torch.from_numpy(a.copy()).to(dev)
                     for a in (x[0], x[1], tail[0], tail[1], taps))
        args += (D, p["omega"].to(dev), torch.from_numpy(
            rng.uniform(-3, 3, C).astype(np.float32)).to(dev),
            p["omega_dec"].to(dev), p["omega_dec_span"].to(dev))
        out.append((f"K11 C={C} K={K} T={T} span {span:.0f}", args))
    return out


def run_k11(dev, smoke, res, cases):
    from sdrplusplusbrown_tpu_torch.ops import fused_frontend as ff
    for label, args in cases:
        got = ff.fused_mix_kernel(*args)
        want = ff.fused_mix_ref(*args)
        us, n = smoke.call_profile(lambda: ff.fused_mix_kernel(*args))
        bms, by = smoke.bound("K11", args)
        print(f"{label}: {us:.1f} us in {n} launches; bound "
              f"{bms * 1e3:.1f} us ({by}); against the plain version: "
              f"{agree(got, want, smoke)}")
        res[f"{label}/y"] = got.cpu()


def k5_cases(dev):
    """[(label, pipe, (xr, xi, xwr, xwi), width)]."""
    import torch
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_NFM
    from sdrplusplusbrown_tpu_torch.ops.channelizer import \
        PolyphaseChannelizer
    out = []
    bank = Radio(2.4e6, DEMOD_NFM, squelch_enabled=True,
                 device=dev)._build_vfo_channelized()
    pfb, post = bank.pipes()
    T = 240_000
    out.append(("K5 scanner128/256", pfb, T,
                post.plan(T // pfb.h)["Tb_pad"]))
    ch = PolyphaseChannelizer(10e6, 64, device=dev)
    out.append(("K5c channelizer64", ch.pfb(), 1 << 21, (1 << 21) // 64))
    cases = []
    for label, pipe, T, W in out:
        rng = np.random.default_rng(pipe.M)

        def planes(n):
            return tuple(torch.from_numpy((0.1 * rng.standard_normal(n))
                                          .astype(np.float32)).to(dev)
                         for _ in range(2))
        cases.append((label, pipe, planes(T) + planes(pipe.n_hist), W))
    return cases


def k5_more(dev):
    """K5c at the card tests' shapes (M = 8, 16, 48, 64; tpp 19 and 2;
    1 000 frames), held like ``k5_cases``' but not timed in the grids."""
    import torch
    from sdrplusplusbrown_tpu_torch.ops.channelizer import \
        PolyphaseChannelizer
    cases = []
    for M, tf in ((8, 0.2), (16, 2.0), (48, 0.2), (64, 0.2), (64, 2.0)):
        pipe = PolyphaseChannelizer(10e6, M, trans_frac=tf, device=dev).pfb()
        rng = np.random.default_rng(M + pipe.tpp)
        x = tuple(torch.from_numpy((0.1 * rng.standard_normal(n)).astype(
            np.float32)).to(dev) for n in (M * 1000, M * 1000, pipe.n_hist,
                                            pipe.n_hist))
        cases.append((f"K5c M={M} tpp={pipe.tpp}", pipe, x, 1000))
    return cases


def identity_pipe(pipe):
    """A copy of ``pipe`` whose DFT matrix is the identity."""
    p = copy.copy(pipe)
    p.cos = np.eye(pipe.M, dtype=np.float32)
    p.sin = np.zeros((pipe.M, pipe.M), np.float32)
    p._dev = {}
    return p


def folded(ck, pipe, x, W, tdt):
    """The folded frames v_F [2M, W] float32 of this tree's kernel."""
    import torch
    if hasattr(ck, "pfb_plan"):
        return ck._launch_pfb(pipe, *x, W, tdt, torch.float32,
                              probe=True)[1]
    fn = ck.pfb_critical_bins_kernel if pipe.critical else ck.pfb_bins_kernel
    v = fn(identity_pipe(pipe), *x, W, tdt, torch.float32)
    if not pipe.critical:       # undo (−1)^m on even frames
        M = pipe.M
        odd = (torch.arange(2 * M, device=v.device) % M) % 2 == 1
        even = torch.arange(W, device=v.device) % 2 == 0
        v = torch.where(odd[:, None] & even[None], -v, v)
    return v


def run_k5(dev, smoke, res, cases):
    import torch
    from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel as ck
    for (label, pipe, x, W), tdt in itertools.product(
            cases, (torch.float32, torch.bfloat16)):
        tag = "K5c" if pipe.critical else "K5"
        fn = ck.pfb_critical_bins_kernel if pipe.critical \
            else ck.pfb_bins_kernel
        name = f"{label} {str(tdt)[6:]} taps"
        for odt in (torch.float32, torch.bfloat16):
            args = (pipe, *x, W, tdt, odt)
            got = fn(*args)
            want = ck.pfb_bins_ref(*args)
            us, n = smoke.call_profile(lambda: fn(*args))
            bms, by = smoke.bound(tag, args)
            print(f"{name}, {str(odt)[6:]} bins: {us:.1f} us in {n} "
                  f"launches; bound {bms * 1e3:.1f} us ({by}); against the "
                  f"plain version: {agree(got, want, smoke)}")
            if odt == torch.float32:
                res[f"{name}/bins32"] = got.cpu()
        res[f"{name}/fold"] = folded(ck, pipe, x, W, tdt).cpu()


def plans(dev, smoke, k11, k5):
    """Every K11 block size at the bank's shapes, every K5 tile and grid
    at each shape (bf16 taps and bins), each beside the plan's own."""
    import torch
    from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel as ck
    from sdrplusplusbrown_tpu_torch.ops import fused_frontend as ff
    for label, args in k11:
        T, K, D, C = (args[0].shape[0], args[4].shape[0], args[5],
                      args[6].shape[0])
        own = ff.fused_plan(T, K, D, C)
        rows = []
        for B in ff.MIX_BLOCKS:
            if ff.mix_smem(B, K, D, own["ncm"]) > ff.SMEM_MAX:
                continue
            p = dict(own, B=B, threads=B // ff.MIX_R,
                     blocks=-(-own["M"] // B) * len(own["chunks"]))
            fn = (lambda p=p: ff._launch_mix(*args, plan=p))
            us = smoke.call_profile(fn, 10)[0]
            rows.append((us, f"B={B} ({p['blocks']} blocks, events "
                             f"{smoke.event_ms(fn) * 1e3:.1f})"))
        print(f"  plans for {label}: own B={own['B']}; "
              + "; ".join(f"{p} {us:.1f} us" for us, p in sorted(rows)))
    for label, pipe, x, W in k5:
        _, na = pipe.dft_parts(dev, torch.bfloat16)
        own = ck.pfb_plan(pipe.M, pipe.tpp, pipe.h, W, na)
        rows = []
        ws = own["ws"]
        for nt, nbuf in ck.PFB_WS_TILES if ws else ck.PFB_TILES:
            smem = ck.pfb_smem(pipe.M, pipe.tpp, pipe.h, nt, nbuf,
                               2 if ws else 1)
            if smem > ck.SMEM_MAX:
                continue
            tiles = -(-W // nt)
            for grid in sorted(g for g in {132, 264, tiles} if g <= tiles):
                p = dict(own, ws=ws, nt=nt, nbuf=nbuf, grid=grid,
                         tiles=tiles)
                us = smoke.call_profile(lambda p=p: ck._launch_pfb(
                    pipe, *x, W, torch.bfloat16, torch.bfloat16, plan=p),
                    10)[0]
                rows.append((us, f"{'ws ' if ws else ''}nt={nt} nbuf={nbuf}"
                                 f" grid={grid} ({smem // 1024} KB)"))
        print(f"  plans for {label} (bf16): own {'ws ' if own['ws'] else ''}"
              f"nt={own['nt']} nbuf={own['nbuf']} grid={own['grid']}; "
              + "; ".join(f"{p} {us:.1f} us" for us, p in sorted(rows)))


# (file, variant, [(old, new)]): each part of K11's and K5's time
PARTS = [
    ("fused_mix.cu", "K11 no twiddle",
     [("        sincos_call(__fmul_rn(od, static_cast<float>(m & 1023)), "
       "&sk, &ck);", "        sk = od; ck = 1.f;")]),
    ("fused_mix.cu", "K11 no taps",
     [("  for (int pass = 0; pass < 2; ++pass)",
       "  for (int pass = 0; pass < 0; ++pass)")]),
    ("pfb_channelizer.cu", "K5 no tensor-core products",
     [("    if (mma_on) {\n      float d[4][4];",
       "    if (mma_on && fold_out == br) {\n      float d[4][4];"),
      ("    if (on0) {\n      const unsigned* Bb",
       "    if (on0 && fold_out == br) {\n      const unsigned* Bb")]),
    ("pfb_channelizer.cu", "K5 no fold",
     [("  for (int item = t0; item < M * Rt * runs; item += nthr) {",
       "  for (int item = t0; item < 0; item += nthr) {")]),
    ("fused_mix.cu", "K11 no staging",
     [("  for (int u = tid; u < nv; u += nt) {",
       "  for (int u = tid; u < 0; u += nt) {")]),
    ("pfb_channelizer.cu", "K5 no staging",
     [("stage_span(g, ", "if (fold_out == br) stage_span(g, ")]),
    ("pfb_channelizer.cu", "K5 no store",
     [("  for (int idx = t0; idx < 2 * M * q_row; idx += nthr) {",
       "  for (int idx = t0; idx < 0; idx += nthr) {")]),
]


ENTRY = {"K11": "sdr_fused_mix", "K5": "sdr_pfb_bins"}


def patched(text: str, subs, what: str) -> str:
    """``text`` with each (old, new) of ``subs`` replaced; raises where an
    old string is not in it."""
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{what}: patch site not found: {old!r}")
        text = text.replace(old, new)
    return text


def patch_sets():
    """[(source file, name, [(old, new)])]: the ``--parts`` variants and
    the ``--phases`` stamps."""
    return PARTS + [("pfb_channelizer.cu", "K5 phase stamps", STAMPS)]


def check_patches(csrc: str) -> None:
    """Raise unless every patch of ``patch_sets`` finds its sites in the
    sources under ``csrc``."""
    for src, name, subs in patch_sets():
        with open(os.path.join(csrc, src)) as fh:
            patched(fh.read(), subs, name)


def build_parts(_build, variants) -> dict:
    """{variant: ctypes library of its patched copy of csrc/}."""
    out_dir = os.path.join(_build.BUILD_DIR, "chz_parts")
    procs = {}
    for i, (src, name, subs) in enumerate(variants):
        d = os.path.join(out_dir, str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        path = os.path.join(d, src)
        with open(path) as fh:
            text = patched(fh.read(), subs, name)
        with open(path, "w") as fh:
            fh.write(text)
        so = os.path.join(d, "lib.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, path,
             os.path.join(d, "runtime.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        used = [ln.split(":")[-1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f"  {name}: ptxas {'; '.join(used)}")
        lib = ctypes.CDLL(so)
        fn = ENTRY[name.split()[0]]
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn] + [_build._P]
        getattr(lib, fn).restype = ctypes.c_int
        lib.sdr_error_string.argtypes = [ctypes.c_int]
        lib.sdr_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def parts(dev, smoke, k11, k5):
    """Each variant's device µs a call beside the unpatched kernel's, at
    the bank's NFM group and C = 12 (K11), and each K5 shape (bf16)."""
    import torch
    from sdrplusplusbrown_tpu_torch.kernels import _build
    from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel as ck
    from sdrplusplusbrown_tpu_torch.ops import fused_frontend as ff
    libs = build_parts(_build, PARTS)
    calls = [(label, lambda a=args: ff.fused_mix_kernel(*a))
             for label, args in (k11[0], k11[-1])]
    for label, pipe, x, W in k5:
        fn = ck.pfb_critical_bins_kernel if pipe.critical \
            else ck.pfb_bins_kernel
        calls.append((f"{label} bf16", lambda f=fn, p=pipe, xx=x, w=W: f(
            p, *xx, w, torch.bfloat16, torch.bfloat16)))
    base = _build.lib()
    for label, fn in calls:
        row = [f"base {smoke.call_profile(fn, 10)[0]:.1f}"]
        kernel = "K11" if label.startswith("K11") else "K5"
        for name, lib in libs.items():
            if name.split()[0] != kernel:
                continue
            _build._LIB[0] = lib
            try:
                row.append(f"{name} {smoke.call_profile(fn, 10)[0]:.1f}")
            finally:
                _build._LIB[0] = base
        print(f"  parts of {label} (device us a call): " + "; ".join(row))


# clock64 stamps in K5's warp-specialised kernel: per block and tile (the
# first 8 of each block), folder thread 0: span landed (0), frame buffer
# free (1), fold done (2); product thread 128: buffer full (3), products
# done (4), bins stored (5)
STAMPS = [
    ("#include \"common.cuh\"\n",
     "#include \"common.cuh\"\n__device__ long long sdr_stamps[1024 * 64];\n"
     "#define STAMP(i, k) if (threadIdx.x % 128 == 0 && (i) < 8) "
     "sdr_stamps[blockIdx.x * 64 + (i) * 8 + (k)] = clock64() - t_base;\n"),
    ("  const bool folder = tid < PFB_HALF;",
     "  const bool folder = tid < PFB_HALF;\n  const long long t_base = clock64();"),
    ("      bar_sync(5, PFB_HALF);  // tile i's span has landed",
     "      bar_sync(5, PFB_HALF);  // tile i's span has landed\n      STAMP(i, 0);"),
    ("      if (i >= 2) bar_sync(3 + b, PFB_THREADS);",
     "      if (i >= 2) bar_sync(3 + b, PFB_THREADS);\n      STAMP(i, 1);"),
    ("      bar_arrive(1 + b, PFB_THREADS);",
     "      STAMP(i, 2);\n      bar_arrive(1 + b, PFB_THREADS);"),
    ("    bar_sync(1 + b, PFB_THREADS);",
     "    bar_sync(1 + b, PFB_THREADS);\n    STAMP(i, 3);"),
    ("    if (tile + 2 * grid < ntiles) bar_arrive(3 + b, PFB_THREADS);",
     "    STAMP(i, 4);\n    if (tile + 2 * grid < ntiles) bar_arrive(3 + b, PFB_THREADS);"),
    ("               tid - PFB_HALF, PFB_HALF);",
     "               tid - PFB_HALF, PFB_HALF);\n    STAMP(i, 5);"),
    ("extern \"C\" int sdr_pfb_bins(",
     "extern \"C\" int sdr_stamps_read(long long* dst, int n) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(dst, sdr_stamps, n * 8));\n}\n\n"
     "extern \"C\" int sdr_pfb_bins("),
]


def phases(dev, smoke, k5) -> None:
    """Where a warp-specialised K5 block's time goes, from clock64 stamps
    (a patched build, ``STAMPS``) over one call at each shape (bf16):
    per tile, the folders' wait for the span and for a free frame buffer
    and their fold; the product warps' wait for a full buffer, their
    products and their store; in SM cycles, the mean over blocks."""
    import torch
    from sdrplusplusbrown_tpu_torch.kernels import _build
    from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel as ck
    d = os.path.join(_build.BUILD_DIR, "chz_phases")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    path = os.path.join(d, "pfb_channelizer.cu")
    with open(path) as fh:
        text = patched(fh.read(), STAMPS, "K5 phase stamps")
    with open(path, "w") as fh:
        fh.write(text)
    so = os.path.join(d, "lib.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
                    path, os.path.join(d, "runtime.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.sdr_pfb_bins.argtypes = _build.SIGNATURES["sdr_pfb_bins"] + [_build._P]
    lib.sdr_pfb_bins.restype = ctypes.c_int
    lib.sdr_error_string.argtypes = [ctypes.c_int]
    lib.sdr_error_string.restype = ctypes.c_char_p
    lib.sdr_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    base = _build.lib()
    names = ("span wait", "buffer-free wait", "fold", "full wait",
             "products", "store")
    for label, pipe, x, W in k5:
        _build._LIB[0] = lib
        try:
            for _ in range(3):
                ck.pfb_bins(pipe, *x, W, torch.bfloat16, torch.bfloat16)
            torch.cuda.synchronize()
        finally:
            _build._LIB[0] = base
        plan = ck.pfb_plan(pipe.M, pipe.tpp, pipe.h, W, 1)
        n = plan["grid"] * 64
        st = np.zeros(n, np.int64)
        lib.sdr_stamps_read(st.ctypes.data, n)
        st = st.reshape(plan["grid"], 8, 8).astype(np.float64)
        tiles = min(8, plan["tiles"] // plan["grid"])
        rows = []
        for i in range(tiles):
            prev_f = st[:, i - 1, 2] if i else 0.0
            prev_w = st[:, i - 1, 5] if i else 0.0
            dur = [st[:, i, 0] - prev_f, st[:, i, 1] - st[:, i, 0],
                   st[:, i, 2] - st[:, i, 1], st[:, i, 3] - prev_w,
                   st[:, i, 4] - st[:, i, 3], st[:, i, 5] - st[:, i, 4]]
            rows.append(f"tile {i}: " + ", ".join(
                f"{k} {v.mean():.0f}" for k, v in zip(names, dur)))
        print(f"  phases of {label} (SM cycles, mean of {plan['grid']} "
              f"blocks; ws nt={plan['nt']}): " + "; ".join(rows))


def sass_mix(_build) -> None:
    """Static SASS opcode counts of K11's and K5's kernels in this tree's
    build (``cuobjdump -sass``): which pipes their code leans on."""
    import collections
    import re
    so = _build.build()
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    func, counts = None, {}
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            func = m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if m and func and ("fused_mix" in func or "pfb_" in func):
            counts.setdefault(func, collections.Counter())[m.group(1)] += 1
    for func, c in counts.items():
        print(f"  SASS of {func[:72]}: {sum(c.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in c.most_common(14)))


def compare(res, against) -> int:
    """K11 outputs and folded frames bit-identical, float32 bins >= 100 dB;
    returns the number of failures."""
    import torch
    from chip_smoke import snr_db
    bad = 0
    for key, t in res.items():
        o = against.get(key)
        if o is None or o.shape != t.shape:
            print(f"MISSING in the other tree: {key}")
            bad += 1
        elif key.endswith("/bins32"):
            db = snr_db(o.double(), t.double())
            if db < BINS_DB:
                print(f"UNDER {BINS_DB:.0f} dB: {key} ({db:.1f} dB)")
                bad += 1
            else:
                print(f"{key}: {db:.1f} dB against the other tree's")
        elif not torch.equal(o, t):
            d = float((o.double() - t.double()).abs().max())
            print(f"NOT bit-identical: {key} (max|diff| {d:.3e})")
            bad += 1
    n_bits = sum(not k.endswith("/bins32") for k in res)
    print(f"{len(res) - bad} of {len(res)} kept outputs hold against the "
          f"other tree's ({n_bits} bit for bit, the float32 bins at "
          f"{BINS_DB:.0f} dB)")
    return bad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--save")
    ap.add_argument("--against")
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--phases", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chz_mix_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke       # this tree's, whatever --tree is
    sys.path.insert(0, os.path.abspath(a.tree))
    from sdrplusplusbrown_tpu_torch.kernels import _build
    from sdrplusplusbrown_tpu_torch.ops import fused_frontend as ff
    redesigned = hasattr(ff, "fused_plan")
    if (a.parts or a.phases) and redesigned:
        check_patches(_build.CSRC)
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
    design = ("register-blocked K11, tensor-core K5" if redesigned else
              "one-thread-an-output K11, direct-DFT K5")
    print(f"tree {tree} ({design}): {smi}; TF32 off")
    _build.lib()
    res = {}
    k11, k5 = k11_cases(dev, smoke), k5_cases(dev)
    run_k11(dev, smoke, res, k11 + k11_more(dev, smoke))
    run_k5(dev, smoke, res, k5 + k5_more(dev))
    if a.plans and redesigned:
        plans(dev, smoke, k11, k5)
    if a.parts and redesigned:
        parts(dev, smoke, k11, k5)
    if a.sass:
        sass_mix(_build)
    if a.phases and redesigned:
        phases(dev, smoke, k5)
    if a.save:
        os.makedirs(os.path.dirname(os.path.abspath(a.save)), exist_ok=True)
        torch.save(res, a.save)
    if a.against:
        return 1 if compare(res, torch.load(a.against)) else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
