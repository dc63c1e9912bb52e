#!/usr/bin/env python3
"""K5's large-M kernel (csrc/pfb_channelizer.cu:pfb_big_kernel) of one tree
on one NVIDIA GPU, for a parent / change comparison:

    python3 scripts/pfb_big_ab.py [--tree DIR] [--save F] [--against F]

At the channelized banks' PFBs at 2.4 MS/s (AM M = 160, USB M = 100, DSB
M = 100, CW M = 800; T = 243 200, chip_smoke phase 27's block, the bins of
phase 27's 16 VFOs a group) and the critical form at M = 128 (T = 2^21,
every row), each with float32 and bf16 taps.  Inputs are made from seeds,
so two trees see the same bits.  A tree whose wrappers take a row list
computes the gathered rows [bin | M + bin]; an earlier tree computes the
whole plane and the same rows are taken from it.  For each case it prints
the kernel's device µs a call (``chip_smoke.call_profile``) in the bf16
handoff (bf16 taps, bf16 bins) beside the bound and the agreement of the
float32 bins with the plain version on the T/h valid frames, and keeps
those float32 rows.  ``--tree DIR`` imports the port from another checkout
(a parent commit unpacked with ``git archive``); ``--save F`` writes the
kept rows to F (torch.save); ``--against F`` prints, for each case,
whether the rows are bit-identical to F's or their agreement in dB.  Run
it parent / change / change / parent in one call.  ``--parts`` (this
design's tree) builds patched copies of the kernel's source (one ``nvcc``
each, all started together, under the package's ``_build/big_parts/``)
without its products, its fold, its row-slice copies, its span staging or
its stores, and times each beside the unpatched kernel at every case
(bf16): what each part costs.  Their outputs are wrong by design; only
the times mean anything.  ``--phases`` builds a copy that stamps each
block's clock (clock64) at its phases and the global timer at its start
and end, and prints, for every case, the mean over blocks of its setup,
its wait for the span, each chunk's fold, wait for its row slices and
products, and its store, and the blocks' spread over the launch.
``--plans`` (this design's tree) times each
case under every plan that fits (on mma.sync every tile, row group,
k-chunk, block size and a ring of two or of every chunk; on wgmma every
ring depth; staged or not),
beside the plan's own, the fastest eight printed.
Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_BANK = 243_200


def cases(dev, smoke):
    """[(label, pipe, (xr, xi, xwr, xwi), width, rows or None)]."""
    import torch
    from sdrplusplusbrown_tpu_torch.models.radio import (DEMOD_AM, DEMOD_CW,
                                                         DEMOD_DSB,
                                                         DEMOD_USB, Radio)
    from sdrplusplusbrown_tpu_torch.ops.channelizer import \
        PolyphaseChannelizer
    groups = {name: (f0, df) for name, f0, df in smoke.MODES_GROUPS}
    offs = {"am": groups["am"], "usb": groups["usb"], "cw": groups["cw"]}
    out = []
    for name, demod in (("am", DEMOD_AM), ("usb", DEMOD_USB),
                        ("dsb", DEMOD_DSB), ("cw", DEMOD_CW)):
        bank = Radio(smoke.FS, demod, device=dev)._build_vfo_channelized()
        pfb, post = bank.pipes()
        if name in offs:
            f0, df = offs[name]
            o = f0 + df * np.arange(smoke.MODES_C) + 317.0
        else:
            o = np.linspace(-1.1e6, 1.1e6, smoke.MODES_C) + 317.0
        b = bank.make_params(o)["bin"].to(dev)
        rows = torch.cat([b, b + pfb.M]).to(torch.int32)
        W = post.plan(2 * T_BANK // pfb.M)["Tb_pad"]
        out.append((f"{name} M={pfb.M} (gathered, C = {smoke.MODES_C})",
                    pfb, T_BANK, W, rows))
    ch = PolyphaseChannelizer(10e6, 128, device=dev)
    out.append(("critical M=128 (every row)", ch.pfb(), 1 << 21,
                (1 << 21) // 128, None))
    res = []
    for label, pipe, T, W, rows in out:
        rng = np.random.default_rng(pipe.M)
        x = tuple(torch.from_numpy((0.1 * rng.standard_normal(n)).astype(
            np.float32)).to(dev) for n in (T, T, pipe.n_hist, pipe.n_hist))
        res.append((label, pipe, x, W, rows))
    return res


#: (name, [(old, new)]) of the ``--parts`` variants of pfb_channelizer.cu
PARTS = [
    ("no products", [
        ("    const unsigned char* ms = mat + (c % ring) * NA * rbp * RSB;\n",
         "    const unsigned char* ms = mat + (c % ring) * NA * rbp * RSB;\n"
         "    if (g.R > 0) continue;\n")]),
    ("no fold", [
        ("    if (g.staged) {\n      const SpanSmem sr{dr}, si{di};",
         "    if (g.R > 0) {\n    } else if (g.staged) {\n"
         "      const SpanSmem sr{dr}, si{di};")]),
    ("no row copies", [
        ("    if (lane == 0) mbar_expect_tx(&bar[s], NA * nrows * RSB);",
         "    if (lane == 0) mbar_expect_tx(&bar[s], 0);"),
        ("    if (contig) {\n      if (lane < NA)",
         "    if (g.R > 0) {\n    } else if (contig) {\n      if (lane < NA)"),
        ("      for (int idx = lane; idx < NA * nrows; idx += 32) {",
         "      for (int idx = lane; idx < 0; idx += 32) {")]),
    ("fold without its stores", [
        ("        put_parts(reinterpret_cast<__nv_bfloat16*>(col + fl * 16), PS / 2,\n"
         "                  x);",
         "        if (x == 1234.5f)\n"
         "          put_parts(reinterpret_cast<__nv_bfloat16*>(col + fl * 16), "
         "PS / 2,\n                    x);")]),
    ("fold stores without its sums", [
        ("    fold_runs<IT>(src, brT, M, g.tpp, base, p, v);",
         "#pragma unroll\n    for (int u = 0; u < IT; ++u)\n#pragma unroll\n"
         "      for (int f = 0; f < PFB_NF; ++f) v[u][f] = base[u] + f;")]),
    ("no span staging", [
        ("      mbar_expect_tx(&bar[ring], 2 * bytes);\n      if (bytes) {",
         "      mbar_expect_tx(&bar[ring], 0);\n      if (bytes && g.R < 0) {"),
        ("  if (g.staged && warp > 0) {\n",
         "  if (g.staged && warp > 0 && g.R < 0) {\n")]),
    ("no stores", [
        ("  if (F < g.width) sdr::st(g.out, at, v0, g.out_bf16);\n"
         "  if (F + 1 < g.width) sdr::st(g.out, at + 1, v1, g.out_bf16);",
         "  if (F < -g.width) sdr::st(g.out, at, v0, g.out_bf16);\n"
         "  if (F + 1 < -g.width) sdr::st(g.out, at + 1, v1, g.out_bf16);")]),
]


#: the ``--phases`` stamps: clock64 at point i (0 entry, 1 after the
#: setup's sync, 2 span landed; 3 + 4c fold done, 4 + 4c slices landed,
#: 5 + 4c products issued, for chunks c < 12; 63 the end), the global
#: timer at the entry (62) and the end (61)
STAMPS = [
    ("#include \"common.cuh\"\n",
     "#include \"common.cuh\"\n"
     "__device__ long long sdr_big_stamps[8192 * 64];\n"
     "#define STAMP(i) if (threadIdx.x == 0) sdr_big_stamps[(blockIdx.y * "
     "gridDim.x + blockIdx.x) * 64 + (i)] = clock64();\n"
     "#define GSTAMP(i) if (threadIdx.x == 0) sdr_big_stamps[(blockIdx.y * "
     "gridDim.x + blockIdx.x) * 64 + (i)] = "
     "static_cast<long long>(sdr::ns_now());\n"),
    ("  const bool probe = g.fold_out && blockIdx.y == 0;\n",
     "  const bool probe = g.fold_out && blockIdx.y == 0;\n"
     "  GSTAMP(62);\n  STAMP(0);\n"),
    ("  __syncthreads();\n  if (g.staged) mbar_wait(&bar[ring], 0);\n",
     "  __syncthreads();\n  STAMP(1);\n"
     "  if (g.staged) mbar_wait(&bar[ring], 0);\n  STAMP(2);\n"),
    ("      fold_chunk_any<NT>(g, gr, gi, brT, k0, fb, L.LBO, L.PS, F0, "
     "probe,\n                         tid);\n    }\n",
     "      fold_chunk_any<NT>(g, gr, gi, brT, k0, fb, L.LBO, L.PS, F0, "
     "probe,\n                         tid);\n    }\n"
     "    if (c < 12) STAMP(3 + 4 * c);\n"),
    ("    mbar_wait(&bar[c % ring], (c / ring) & 1);\n",
     "    mbar_wait(&bar[c % ring], (c / ring) & 1);\n"
     "    if (c < 12) STAMP(4 + 4 * c);\n"),
    ("      wg_commit();\n    }\n  }\n",
     "      wg_commit();\n    }\n    if (c < 12) STAMP(5 + 4 * c);\n  }\n"),
    ("  }\n}\n\n}  // namespace",
     "  }\n  STAMP(63);\n  GSTAMP(61);\n}\n\n}  // namespace"),
    ("extern \"C\" int sdr_pfb_big(",
     "extern \"C\" int sdr_big_stamps_read(long long* dst, int n) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(dst, sdr_big_stamps, "
     "n * 8));\n}\n\n"
     "extern \"C\" int sdr_big_occupancy(int na, int wg, int threads, "
     "int smem) {\n"
     "  auto* k = wg ? (na == 3 ? pfb_big_kernel<3, true, 256>\n"
     "                          : pfb_big_kernel<1, true, 256>)\n"
     "           : threads == 512 ? (na == 3 ? pfb_big_kernel<3, false, 512>\n"
     "                                       : pfb_big_kernel<1, false, 512>)\n"
     "                            : (na == 3 ? pfb_big_kernel<3, false, 256>\n"
     "                                       : pfb_big_kernel<1, false, 256>);\n"
     "  sdr::allow_smem(k, smem);\n"
     "  cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,\n"
     "                       cudaSharedmemCarveoutMaxShared);\n"
     "  int n = -1;\n"
     "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, threads, smem);\n"
     "  return n;\n}\n\nextern \"C\" int sdr_pfb_big("),
]


def patch_sets():
    """[(name, [(old, new)])]: the ``--parts`` variants and the
    ``--phases`` stamps."""
    return PARTS + [("K5 large-M phase stamps", STAMPS)]


def patched(text: str, subs, what: str) -> str:
    """``text`` with each (old, new) of ``subs`` replaced; raises where an
    old string is not in it."""
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{what}: patch site not found: {old!r}")
        text = text.replace(old, new)
    return text


def build_parts(_build) -> dict:
    """{variant: ctypes library of its patched pfb_channelizer.cu}."""
    out_dir = os.path.join(_build.BUILD_DIR, "big_parts")
    procs = {}
    for i, (name, subs) in enumerate(PARTS):
        d = os.path.join(out_dir, str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        path = os.path.join(d, "pfb_channelizer.cu")
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
        lib = ctypes.CDLL(so)
        lib.sdr_pfb_big.argtypes = _build.SIGNATURES["sdr_pfb_big"] + [
            _build._P]
        lib.sdr_pfb_big.restype = ctypes.c_int
        lib.sdr_error_string.argtypes = [ctypes.c_int]
        lib.sdr_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def parts(smoke, dev, items) -> None:
    """Each ``PARTS`` variant's device µs a call beside the unpatched
    kernel's, at every case (bf16 taps and bins)."""
    import torch
    from sdrplusplusbrown_tpu_torch.kernels import _build
    from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel as ck
    libs = build_parts(_build)
    base = _build.lib()
    for label, pipe, x, W, rows in items:
        fn = ck.pfb_critical_bins_kernel if pipe.critical \
            else ck.pfb_bins_kernel
        args = (pipe, *x, W, torch.bfloat16, torch.bfloat16, rows)
        row = [f"base {smoke.call_profile(lambda: fn(*args), 10)[0]:.1f}"]
        for name, lib in libs.items():
            _build._LIB[0] = lib
            try:
                row.append(f"{name} "
                           f"{smoke.call_profile(lambda: fn(*args), 10)[0]:.1f}")
            finally:
                _build._LIB[0] = base
        print(f"  parts of {label} (device us a call): " + "; ".join(row))


def phases(smoke, dev, items) -> None:
    """Where a block's time goes, from the ``STAMPS`` build: for every
    case (bf16) the mean over blocks, in µs at the SM clock, of the setup
    (0 → 1), the span's wait (1 → 2), each chunk's fold, wait for its row
    slices and products (the first 12 chunks), the end (last stamp →
    63); and from the global timer the blocks' start spread and mean
    length against the launch's span."""
    import torch
    from sdrplusplusbrown_tpu_torch.kernels import _build
    from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel as ck
    d = os.path.join(_build.BUILD_DIR, "big_phases")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    path = os.path.join(d, "pfb_channelizer.cu")
    with open(path) as fh:
        text = patched(fh.read(), STAMPS, "K5 large-M phase stamps")
    with open(path, "w") as fh:
        fh.write(text)
    so = os.path.join(d, "lib.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
                    path, os.path.join(d, "runtime.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.sdr_pfb_big.argtypes = _build.SIGNATURES["sdr_pfb_big"] + [_build._P]
    lib.sdr_pfb_big.restype = ctypes.c_int
    lib.sdr_error_string.argtypes = [ctypes.c_int]
    lib.sdr_error_string.restype = ctypes.c_char_p
    lib.sdr_big_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sdr_big_occupancy.argtypes = [ctypes.c_int] * 4
    mhz = smoke.sm_clock_mhz()
    base = _build.lib()
    for label, pipe, x, W, rows in items:
        R = 2 * pipe.M if rows is None else rows.shape[0]
        V = x[0].shape[0] // pipe.h
        plan = ck.pfb_plan(pipe.M, pipe.tpp, pipe.h, W, 1, R, V)
        fn = ck.pfb_critical_bins_kernel if pipe.critical \
            else ck.pfb_bins_kernel
        _build._LIB[0] = lib
        try:
            for _ in range(3):
                fn(pipe, *x, W, torch.bfloat16, torch.bfloat16, rows)
            torch.cuda.synchronize()
        finally:
            _build._LIB[0] = base
        nb = plan["blocks"]
        st = np.zeros(nb * 64, np.int64)
        lib.sdr_big_stamps_read(st.ctypes.data, nb * 64)
        st = st.reshape(nb, 64).astype(np.float64)
        us = 1.0 / mhz      # µs a cycle
        nch = min(12, -(-(-(-2 * pipe.M // 16) * 16) // plan["kc"]))
        fold = np.mean([st[:, 3 + 4 * c] - (st[:, 2] if c == 0 else
                                            st[:, 1 + 4 * c])
                        for c in range(nch)], axis=1)
        wait = np.mean([st[:, 4 + 4 * c] - st[:, 3 + 4 * c]
                        for c in range(nch)], axis=1)
        prod = np.mean([st[:, 5 + 4 * c] - st[:, 4 + 4 * c]
                        for c in range(nch)], axis=1)
        start = (st[:, 62] - st[:, 62].min()) / 1e3
        length = (st[:, 61] - st[:, 62]) / 1e3
        span = (st[:, 61].max() - st[:, 62].min()) / 1e3
        print(f"  phases of {label} ({nb} blocks, {nch} chunks; us a block, "
              f"mean over blocks, at {mhz:.0f} MHz): setup "
              f"{np.mean(st[:, 1] - st[:, 0]) * us:.2f}, span wait "
              f"{np.mean(st[:, 2] - st[:, 1]) * us:.2f}; a chunk: fold "
              f"{np.mean(fold) * us:.2f}, slices wait "
              f"{np.mean(wait) * us:.2f}, products {np.mean(prod) * us:.2f}"
              f"; the end {np.mean(st[:, 63] - st[:, 1 + 4 * nch]) * us:.2f}"
              f"; block length {length.mean():.2f} (max {length.max():.2f}),"
              f" starts spread over {start.max():.2f}, the launch's span "
              f"{span:.2f}; occupancy "
              f"{lib.sdr_big_occupancy(1, int(plan['wg']), plan['threads'], plan['smem'])}"
              f" blocks an SM")


def plans(smoke, dev, items) -> None:
    """Each case (bf16) under every plan that fits, beside ``pfb_plan``'s
    own choice: on mma.sync every tile (16, 32, 64 frames), row group (16,
    32 rows) and k-chunk (2048 / nt, 4096 / nt), two ring slots; on wgmma
    ring depths 2 to 4; staged or read in place."""
    import torch
    from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel as ck
    for label, pipe, x, W, rows in items:
        R = 2 * pipe.M if rows is None else rows.shape[0]
        V = x[0].shape[0] // pipe.h
        own = ck.pfb_plan(pipe.M, pipe.tpp, pipe.h, W, 1, R, V)
        if own["wg"]:
            shapes = [(own["nt"], own["rbp"], own["kc"], ring, 256)
                      for ring in (2, 3, 4)]
        else:
            KP = -(-2 * pipe.M // 16) * 16
            shapes = [(nt, rbp, kc, ring, th) for nt in ck.PFB_BIG_TILES
                      for rbp in (16, 32) for kc in (2048 // nt, 4096 // nt)
                      for ring in sorted({2, max(2, min(-(-KP // kc),
                                                        ck.PFB_MAX_RING))})
                      for th in (256, 512)]
        out = []
        for nt, rbp, kc, ring, th in shapes:
            for staged in (True, False):
                smem = ck.pfb_big_smem(pipe.M, pipe.tpp, pipe.h, nt, kc, rbp,
                                       1, staged, own["wg"], ring, th)
                if smem > ck.SMEM_MAX:
                    continue
                tiles = min(-(-V // nt), -(-W // nt))
                p = dict(own, nt=nt, rbp=rbp, kc=kc, ring=ring, threads=th,
                         staged=staged, smem=smem, tiles=tiles,
                         rgroups=-(-R // rbp))
                us = smoke.call_profile(lambda p=p: ck._launch_pfb(
                    pipe, *x, W, torch.bfloat16, torch.bfloat16, rows,
                    plan=p), 10)[0]
                out.append((us, f"nt={nt} rbp={rbp} kc={kc} ring={ring} "
                                f"threads={th} staged={int(staged)} "
                                f"({smem // 1024} KB, "
                                f"{tiles * p['rgroups']} blocks)"))
        print(f"  plans of {label} (own nt={own['nt']} rbp={own['rbp']} "
              f"kc={own['kc']} ring={own['ring']} threads="
              f"{own['threads']} staged={int(own['staged'])}): "
              + "; ".join(f"{p} {us:.1f}" for us, p in sorted(out)[:8]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--save")
    ap.add_argument("--against")
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--phases", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pfb_big_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke       # this tree's, whatever --tree is
    sys.path.insert(0, os.path.abspath(a.tree))
    from sdrplusplusbrown_tpu_torch.kernels import _build
    from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel as ck
    tree = os.path.relpath(os.path.dirname(os.path.dirname(
        _build.__file__)), ROOT)
    gathers = "rows" in inspect.signature(ck.pfb_bins).parameters
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    m = torch.randn((4096, 4096), generator=g, device=dev)
    for _ in range(150):     # the card at its clocks
        m = torch.tanh(m @ m)
    torch.cuda.synchronize()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"tree {tree} ({'gathered rows' if gathers else 'whole plane'}): "
          f"{smi}")
    _build.lib()
    res, against = {}, (torch.load(a.against) if a.against else None)
    items = cases(dev, smoke)
    for label, pipe, x, W, rows in items:
        V = x[0].shape[0] // pipe.h
        fn = ck.pfb_critical_bins_kernel if pipe.critical \
            else ck.pfb_bins_kernel
        extra = (rows,) if gathers else ()

        def pick(bins):
            return bins if gathers or rows is None else bins[rows.long()]
        for tdt in (torch.float32, torch.bfloat16):
            name = f"{label} {str(tdt)[6:]} taps"
            args = (pipe, *x, W, tdt, torch.float32)
            got = pick(fn(*args, *extra))[:, :V].float()
            want = ck.pfb_bins_ref(*args)
            want = (want if rows is None else want[rows.long()])[:, :V]
            s = smoke.snr_db(want, got)
            targs = (pipe, *x, W, tdt, torch.bfloat16)
            us, n = smoke.call_profile(lambda: fn(*targs, *extra))
            bms, by = smoke.bound("K5c" if pipe.critical else "K5",
                                  targs + extra)
            line = (f"{name}: {us:.1f} us a call in {n} launch(es) (bf16 "
                    f"bins), bound {bms * 1e3:.1f} us ({by}); float32 bins "
                    f"{s:.1f} dB against the plain version")
            if against is not None:
                old = against[name]
                line += ("; bit-identical to the saved tree's" if
                         torch.equal(old, got.cpu()) else
                         f"; {smoke.snr_db(old, got.cpu()):.1f} dB against "
                         f"the saved tree's")
            print(line + f" [{smi}]")
            res[name] = got.cpu()
    if a.save:
        torch.save(res, a.save)
    if a.parts and gathers:
        parts(smoke, dev, items)
    if a.plans and gathers:
        plans(smoke, dev, items)
    if a.phases and gathers:
        phases(smoke, dev, items)
    return 0


if __name__ == "__main__":
    sys.exit(main())
