#!/usr/bin/env python3
"""The port's loop kernels of one tree at the shapes of their callers, for
a parent / change comparison on one NVIDIA GPU:

    python3 scripts/k13_chain_ab.py [--tree DIR] [--runs N] [--tags T,..]
                                    [--latency] [--sass FILE]

Times K13c (the Costas forms), K13m (M&M), K13b and K13f as the port's
callers launch them: RDSDemod's two Costas loops (order 2) and its M&M
clock (real, 4.21 samples a symbol) on 1 x 1 000 and 4 x 1 000 samples,
a Meteor demod's Costas (order 4) and clock (complex, 2.08) and the
"broken" detector (K13b) on 1 x 15 000, RyFi's (order 4; complex, 3.0)
on 1 x 72 000, FDClockRecovery (K13f, 10) on 1 x 20 000 and the complex
clock at Falcon9's 1.68 on 1 x 20 000; K12c (the complex AGC) at RDS's 1
x 1 000, Meteor's 1 x 15 000, RyFi's 1 x 72 000 and the AM carrier AGC's
4 x 2 400, K12 (the real form) at 4 x 2 400; K16 (the Viterbi) at RyFi's
9 x 8 168 steps, M17's 1 x 244 and 1 x 148 and KG-SSTV's 1 x 54, its
trellis and its traceback clocked apart where the tree's kernel clocks
them.  ``--tags`` keeps the cases of those kernels only (e.g.
``K12,K12c,K16``).  Each case prints the wrapper's
time by CUDA events (median of N runs of 20 calls), the device µs a
launch from a profiler window (``chip_smoke.call_profile``) and the
chain's cycles a step as the kernel clocks them (``chip_smoke.
chain_clock_runs``: the slowest row, N runs).  ``--tree DIR`` imports the
port from another checkout (a parent commit unpacked with ``git
archive``), whose kernels build there; run it parent / change / change /
parent in one call.

``--latency`` also compiles and runs a dependent-chain microbenchmark of
the card's instruction latencies (one thread, 64 x 16 dependent
operations a kind, ``clock64``) and prints, for every port-only loop
kernel (K12, K12c, K13's PLL, Costas and M&M forms, K13b, K13f, K16's
two forms), the least chain of its recurrence a step: the operations
from one step's state to the next that the plain version's bits require
(``CHAINS``), at those latencies.  ``--sass FILE`` writes ``cuobjdump
-sass`` of the tree's loop kernels to FILE (gzip) and prints each one's
count of BSSY / BSYNC, local-memory and shared-memory instructions, each
of its loops with its instructions by kind (``loops``: K12c's walk, K16's
trellis step and traceback among them) and the instructions from each
global load to the first use of its register, and ptxas's registers and
spills from the build log.  Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---- the cases -----------------------------------------------------------


def _psk(rng, R, T, order, sps, w0):
    """R rows of PSK of ``order`` at ``sps`` samples a symbol, a carrier
    offset of w0 rad a sample, in noise."""
    k = np.arange(T)
    sym = rng.integers(0, order, (R, T // max(1, int(sps)) + 2))
    x = np.exp(2j * np.pi * sym[:, (k / sps).astype(int)] / order
               + 1j * (w0 * k[None] + rng.uniform(0, 6, (R, 1))))
    x = x + 0.05 * (rng.standard_normal((R, T))
                    + 1j * rng.standard_normal((R, T)))
    return x.astype(np.complex64)


def _symbols(rng, R, T, sps, cplx):
    """R rows of +-1 symbols at ``sps`` samples a symbol, band-limited by a
    3-tap average, in noise (complex: a quadrature stream too)."""
    t = (np.arange(T) / sps).astype(int)

    def stream():
        s = np.sign(rng.standard_normal((R, t[-1] + 2)))
        return np.stack([np.convolve(r[t], np.ones(3) / 3, "same")
                         for r in s])
    x = stream() + 0.05 * rng.standard_normal((R, T))
    if cplx:
        x = x + 1j * stream()
    return x.astype(np.complex64 if cplx else np.float32)


def cases(dev, smoke):
    """(label, tag, wrapper, args, steps) of every timed shape."""
    import torch
    from sdrplusplusbrown_tpu_torch.models import kg_sstv, m17
    from sdrplusplusbrown_tpu_torch.models import ryfi as ryfi_model
    from sdrplusplusbrown_tpu_torch.models.meteor import MeteorDemod
    from sdrplusplusbrown_tpu_torch.models.rds import RDSDemod
    from sdrplusplusbrown_tpu_torch.ops import agc
    from sdrplusplusbrown_tpu_torch.ops import clock_recovery as cr
    from sdrplusplusbrown_tpu_torch.ops import costas, fec
    from sdrplusplusbrown_tpu_torch.ops.demod import AMDemod
    from sdrplusplusbrown_tpu_torch.ops.demod_digital import PSKDemod
    from sdrplusplusbrown_tpu_torch.runtime.block import to_device
    rng = np.random.default_rng(22)
    rds, met = RDSDemod(), MeteorDemod()
    metb = MeteorDemod(broken_modulation=True)
    ryfi = PSKDemod(4, 240_000.0, 720_000.0)
    falcon = cr.MMClockRecovery(1.68)
    fd = cr.FDClockRecovery(10.0)
    out = []

    def loop(label, blk, R, T, sps, order=2, w0=0.3):
        x = torch.from_numpy(_psk(rng, R, T, order, sps, w0)).to(dev)
        st = to_device(blk.init_state((R,)), dev)
        kern = costas.costas_nearest_rows_kernel if costas.nearest_form(
            blk) else costas.costas_rows_kernel
        tag = "K13b" if costas.nearest_form(blk) else "K13c"
        out.append((label, tag, kern, (blk, x, st["phase"], st["freq"]), T))

    def clock(label, blk, R, T):
        cplx = blk.complex_data
        x = torch.from_numpy(_symbols(rng, R, T, blk.omega, cplx)).to(dev)
        st = to_device(blk.init_state((R,)), dev)
        fdf = isinstance(blk, cr.FDClockRecovery)
        kern = cr.fd_rows_kernel if fdf else cr.mm_rows_kernel
        out.append((label, "K13f" if fdf else "K13m", kern, (blk, x, st),
                    blk.max_out(T)))

    for R in (1, 4):
        loop(f"RDS costas (order 2), {R} x 1000", rds.costas, R, 1000, 4.21,
             w0=0.0)
        loop(f"RDS costas2 (order 2, 1.49 rad a sample), {R} x 1000",
             rds.costas2, R, 1000, 4.21, w0=1.49)
        clock(f"RDS M&M (real, 4.21), {R} x 1000", rds.recov, R, 1000)
    loop("Meteor costas (order 4), 1 x 15000", met.costas, 1, 15_000, 2.08,
         order=4, w0=0.002)
    clock("Meteor M&M (complex, 2.08), 1 x 15000", met.recov, 1, 15_000)
    loop("MeteorB costas (K13b), 1 x 15000", metb.costas, 1, 15_000, 2.08,
         order=4, w0=0.002)
    loop("RyFi costas (order 4), 1 x 72000", ryfi.costas, 1, 72_000, 3.0,
         order=4, w0=0.002)
    clock("RyFi M&M (complex, 3.0), 1 x 72000", ryfi.recov, 1, 72_000)
    clock("FD clock (K13f, 10), 1 x 20000", fd, 1, 20_000)
    clock("Falcon9 M&M (complex, 1.68), 1 x 20000", falcon, 1, 20_000)

    def gain(label, blk, R, T, cplx=True):
        x = rng.standard_normal((R, T)) * np.linspace(0.2, 2.0, T)
        if cplx:
            x = x + 1j * rng.standard_normal((R, T))
        x = torch.from_numpy(x.astype(np.complex64 if cplx
                                      else np.float32)).to(dev)
        st = to_device(blk.init_state((R,)), dev)
        out.append((label, "K12c" if cplx else "K12",
                    agc.agc_cplx_rows_kernel if cplx
                    else agc.agc_rows_kernel,
                    (blk, x, st["amp"], st["env"], False), T))

    gain("RDS AGC (complex), 1 x 1000", rds.agc, 1, 1000)
    gain("Meteor AGC (complex), 1 x 15000", met.agc, 1, 15_000)
    gain("RyFi AGC (complex), 1 x 72000", ryfi.agc, 1, 72_000)
    gain("AM carrier AGC (complex), 4 x 2400",
         AMDemod(15e3, carrier_agc=True).c_agc, 4, 2400)
    gain("AM audio AGC (real), 4 x 2400",
         agc.AGC(attack=50 / 24e3, decay=5 / 24e3), 4, 2400, cplx=False)

    def trellis(label, R, N, code):
        soft = smoke.viterbi_frames(R, N, code, False, N).to(dev)
        out.append((label, "K16", fec.viterbi_rows_kernel, (soft, *code),
                    N))

    trellis("RyFi Viterbi (K = 7), 9 x 8168", 9, ryfi_model.FRAME_SYMS,
            (ryfi_model.CONV_G1, ryfi_model.CONV_G2, ryfi_model.CONV_K))
    m17c = (m17.CONV_G1, m17.CONV_G2, m17.CONV_K)
    trellis("M17 LSF Viterbi (K = 5), 1 x 244", 1, 244, m17c)
    trellis("M17 stream Viterbi (K = 5), 1 x 148", 1, 148, m17c)
    trellis("KG-SSTV Viterbi (K = 7), 1 x 54", 1, 54,
            (kg_sstv.CONV_G1, kg_sstv.CONV_G2, kg_sstv.CONV_K))
    return out


def time_cases(smoke, dev, runs, label, card, tags=None):
    import torch
    smoke.LOOP_RUNS = runs
    for name, tag, kern, args, steps in cases(dev, smoke):
        if tags and tag not in tags:
            continue
        x = smoke.loop_input(tag, args)
        kern(*args)
        torch.cuda.synchronize()
        ms = np.array([smoke.event_ms(lambda: kern(*args))
                       for _ in range(runs)])
        us, n = smoke.call_profile(lambda: kern(*args))
        parts = []
        cpi, mhz = smoke.chain_clock_runs(kern, args, steps, x, parts)
        split = ""
        if len(parts[0]) > 1:      # K16: the trellis, then the traceback
            tr, tb = np.median(np.array(parts), axis=0)
            split = f" (trellis {tr:.2f}, argmin and traceback {tb:.2f})"
        print(f"tree {label}: {tag} {name}: {np.median(ms):.4f} ms "
              f"({ms.min():.4f}-{ms.max():.4f}), {us:.1f} us device a call "
              f"({n} launches), chain {np.median(cpi):.2f} cycles a step "
              f"({cpi.min():.2f}-{cpi.max():.2f}){split} over {steps} "
              f"steps at {np.median(mhz):.0f} MHz [{card}]", flush=True)


# ---- the latency microbenchmark ------------------------------------------

LATENCY_CU = r"""
#include <cuda_runtime.h>
// One thread's chain of REPS x 64 dependent operations of one kind,
// clocked around the whole loop: the loop's body cannot move across the
// clock reads, and the value chained is a load's or a conversion's
// result where the kind would otherwise fold.
#define KERNEL(NAME, BODY, KEEP)                                             \
  __global__ void NAME(const float* in, int reps, long long* cyc,            \
                       float* keep) {                                        \
    __shared__ unsigned sm[128];                                             \
    __shared__ float sf[128];                                                \
    float x = in[0], y = in[1], z = in[2], fv[16];                           \
    int i = (int)in[3], j = (int)in[4];                                      \
    const unsigned long long w64 =                                           \
        ((unsigned long long)__float_as_uint(y) << 32) | __float_as_uint(z);  \
    bool p[16];                                                              \
    for (int k = 0; k < 16; ++k) {                                           \
      fv[k] = in[5 + k];                                                     \
      p[k] = in[21 + k] != 0.f;                                              \
    }                                                                        \
    for (int k = threadIdx.x; k < 128; k += blockDim.x) {                    \
      sm[k] = (unsigned)__cvta_generic_to_shared(&sm[k]);                    \
      sf[k] = (k + 0.5f) / 128.f;                                            \
    }                                                                        \
    __syncthreads();                                                         \
    unsigned a = (unsigned)__cvta_generic_to_shared(&sm[threadIdx.x & 63]);  \
    const long long t0 = clock64();                                          \
    x += (float)(int)(t0 >> 62);                                             \
    i += (int)(t0 >> 62);                                                    \
    a += (unsigned)(t0 >> 62);                                               \
    _Pragma("unroll 1") for (int r = 0; r < reps; ++r) {                     \
      _Pragma("unroll") for (int k = 0; k < 64; ++k) { BODY; }               \
    }                                                                        \
    keep[threadIdx.x] = KEEP;                                                \
    const long long t1 = clock64();                                          \
    if (threadIdx.x == 0) cyc[0] = t1 - t0;                                  \
  }
KERNEL(k_fadd, x = __fadd_rn(x, y), x)
KERNEL(k_fmul, x = __fmul_rn(x, y), x)
KERNEL(k_ffma, x = __fmaf_rn(x, y, z), x)
KERNEL(k_fmnmx, x = (k & 1) ? fmaxf(x, fv[k & 15]) : fminf(x, fv[k & 15]),
       x)
KERNEL(k_fsel, x = p[k & 15] ? x : fv[k & 15], x)
KERNEL(k_fsetp_fsel, x = x > y ? fv[k & 15] : x, x)
KERNEL(k_fmul_f2i_i2f,
       x = __int2float_rn(__float2int_rn(__fmul_rn(x, z))), x)
KERNEL(k_fmul_frnd, x = rintf(__fmul_rn(x, z)), x)
KERNEL(k_row_lds,
       x = sf[__float_as_int(__fadd_rd(__fmul_rn(x, 128.f), 0x1.8p+23f)) &
              127],
       x)
KERNEL(k_lds, asm volatile("ld.shared.u32 %0, [%0];" : "+r"(a)), (float)a)
KERNEL(k_shf_iadd, i = (i >> 1) + j, (float)i)
KERNEL(k_cosf, x = cosf(x), x)
KERNEL(k_atan2f, x = atan2f(x, y), x)
KERNEL(k_hypotf, x = hypotf(x, y), x)
// a value through shared memory and a barrier to the other warp (K16's
// step): store into this step's buffer, __syncthreads, load the other
// warp's word of it
KERNEL(k_smem_bar,
       {
         sm[64 * (k & 1) + threadIdx.x] = __float_as_uint(x);
         __syncthreads();
         x = __uint_as_float(sm[64 * (k & 1) + (threadIdx.x ^ 32)]);
       },
       x)
// a shuffle of the value just shuffled (K16's warp form: the metrics)
KERNEL(k_shfl, x = __shfl_sync(0xffffffffu, x, (threadIdx.x + 1) & 31), x)
// K16's traceback step: the decision bit of state i from a 64-bit word,
// shifted up to the register's top, or'd with i >> 1, masked
KERNEL(k_trace,
       i = (int)((((unsigned)(w64 >> i)) << 5 | ((unsigned)i >> 1)) & 63),
       (float)i)

// a pointer chase through global memory cached in L2 only (ld.global.cg:
// a load whose address is the previous load's value; ``keep`` holds the
// 64-entry ring)
__global__ void k_ldg_l2(const float* in, int reps, long long* cyc,
                         float* keep) {
  unsigned* g = reinterpret_cast<unsigned*>(keep);
  if (threadIdx.x == 0)
    for (int k = 0; k < 64; ++k) g[k] = (k + 17) & 63;
  __syncthreads();
  __threadfence();
  unsigned i = (unsigned)in[3];
  const long long t0 = clock64();
  i += (unsigned)(t0 >> 62);
  _Pragma("unroll 1") for (int r = 0; r < reps; ++r) {
    _Pragma("unroll") for (int k = 0; k < 64; ++k)
      asm volatile("ld.global.cg.u32 %0, [%1];" : "=r"(i) : "l"(g + i));
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) cyc[0] = t1 - t0;
  __syncthreads();
  keep[threadIdx.x] = (float)i;
}

extern "C" int lat_run(int which, const float* in, int reps, long long* cyc,
                       float* keep) {
  void (*ks[])(const float*, int, long long*, float*) = {
      k_fadd, k_fmul, k_ffma, k_fmnmx, k_fsel, k_fsetp_fsel,
      k_fmul_f2i_i2f, k_fmul_frnd, k_row_lds, k_lds, k_shf_iadd, k_cosf,
      k_atan2f, k_hypotf, k_smem_bar, k_shfl, k_trace, k_ldg_l2};
  ks[which]<<<1, which == 14 ? 64 : 32>>>(in, reps, cyc, keep);
  return (int)cudaDeviceSynchronize();
}
"""

#: the microbenchmark's kinds, in lat_run's order, each measured as a
#: chain of dependent operations: FMUL_F2I_I2F a multiply, its rint to an
#: int and back (the Costas rotor's quadrant: F2I_I2F = it less FMUL);
#: FMUL_FRND the same by rintf; ROW_LDS x = table[floor(x 128) & 127] in
#: shared memory (M&M's bank row: a multiply, floor by an add rounding
#: down to 1.5 2^23, a mask of its bits, the address, the load); LDS a
#: pointer chase; SHF_IADD a shift and an add (K16's traceback step);
#: SMEM_BAR a store, __syncthreads and the other warp's load (K16's block
#: form's step); SHFL a shuffle of the shuffled value (K16's warp form);
#: SHR64_SHL_LOP3 K16's traceback step (a 64-bit shift by the state, a
#: shift up, an or with the state's half and a mask); LDG_L2 a load from
#: L2 whose address is the last load's value
OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP_FSEL",
       "FMUL_F2I_I2F", "FMUL_FRND", "ROW_LDS", "LDS", "SHF_IADD", "COSF",
       "ATAN2F", "HYPOTF", "SMEM_BAR", "SHFL", "SHR64_SHL_LOP3", "LDG_L2")

# The least chain of each loop's recurrence a step, in operations of
# OPS: from one step's state to the next, the operations the plain
# version's bits require, the others (inputs, outputs, stores, sums off
# the chain) left out.  WRAP = max(FADD, FSETP) then two selects;
# CLAMP = two FMNMX.  The Costas rotor is the library's cosf/sinf fast
# path (the reduction's multiply, rint by two adds about 1.5 2^23, three
# FFMA, t*t, four FFMA of the cosine's polynomial), the rotation a product
# and a sum.
_WRAP = {"FADD": 1, "FSEL": 2}
_CLAMP = {"FMNMX": 2}
# fr = clamp(fr + b err), raw = (ph + fr) + a err (M&M's next phase is
# raw - floor(raw), off the chain: the next row comes from raw)
_LOOP = {"FMUL": 1, "FADD": 3, "FMNMX": 2}
_ROTOR = {"FMUL": 2, "FADD": 3, "FFMA": 7}    # with the rotation's sum
# the bank row from raw and the taps' load (ROW_LDS), the sum
_INTERP = {"ROW_LDS": 1, "FMUL": 1, "FADD": 7}


def _add(*parts) -> dict:
    out = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0) + v
    return out


_ENVELOPE = {"FMUL": 1, "FADD": 1, "FSEL": 1}
_WARP_TRELLIS = {"SHFL": 1, "FADD": 1, "FMNMX": 2}
_WARP_TRACE = {"SHR64_SHL_LOP3": 1}

CHAINS = {
    # amp = ia > amp ? amp(1 - atk) + ia atk : amp(1 - dec) + ia dec
    "K12 / K12c (the envelope)": _ENVELOPE,
    # K12c's earlier walk: the envelope, and at each batch's top a load
    # (from L2 at best) and its hypotf before the walk could go on
    "K12c, the earlier design (the envelope; a load and a hypotf a batch)":
        _add(_ENVELOPE, {"LDG_L2": 1 / 32, "HYPOTF": 1 / 32}),
    # err = wrap(a - ph); fr = clamp(fr + b err); ph = wrap((ph+fr) + a err)
    "K13 PLL": _add({"FADD": 1}, _WRAP, _LOOP, _WRAP),
    # rotor and rotation, err = clamp(re im), the loop, the wrap
    "K13c order 2": _add(_ROTOR, {"FMUL": 2}, _CLAMP, _LOOP, _WRAP),
    # err = clamp(s(re) im - s(im) re): a compare and select, a sum
    "K13c order 4": _add(_ROTOR, {"FMUL": 1, "FSETP_FSEL": 1, "FADD": 1},
                         _CLAMP, _LOOP, _WRAP),
    # the nearest of four phases: atan2f, (a - p) + pi, the modulo's
    # select and fix-up, - pi, three running-minimum selects, x |v|
    "K13b": _add(_ROTOR, {"FMUL": 2, "ATAN2F": 1, "FADD": 4,
                          "FSETP_FSEL": 5, "FSEL": 1}, _CLAMP, _LOOP, _WRAP),
    # the row, the taps' load and the sum, err = s(last) o - last s(o)
    "K13m real": _add(_INTERP, {"FMUL": 1, "FADD": 1}, _CLAMP, _LOOP),
    # err = Re{(p0 - p2) c1*} - Re{(c0 - c2) p1*}: a difference, a
    # product, two sums
    "K13m complex": _add(_INTERP, {"FADD": 3, "FMUL": 1}, _CLAMP, _LOOP),
    # the rows either side (their clamps beside the row's mask), the
    # slope (hi - lo) 0.5 and its select, x s(out)
    "K13f": _add(_INTERP, {"FADD": 1, "FMUL": 2, "FSEL": 1}, _CLAMP,
                 _LOOP),
    # the block form (S > 64; the earlier design for every S): the
    # predecessor's metric through shared memory and the step's barrier,
    # + branch, min, min(., 1e9); the traceback's step: the decision
    # word's load, a shift and an add
    "K16 block form (trellis + traceback)": {
        "SMEM_BAR": 1, "FADD": 1, "FMNMX": 2, "LDS": 1, "SHF_IADD": 1},
    # the warp form (S <= 64): the predecessor's metric by a shuffle, +
    # branch, min, min(., 1e9); the traceback's step on the word loaded a
    # group ahead
    "K16 warp form, trellis": _WARP_TRELLIS,
    "K16 warp form, traceback": _WARP_TRACE,
    "K16 warp form (trellis + traceback)": _add(_WARP_TRELLIS, _WARP_TRACE),
}


def latencies(tmp: str) -> dict:
    """Cycles an operation of each kind of OPS, from the microbenchmark
    built with nvcc in ``tmp`` (the least of 5 runs of 16 x 64)."""
    import torch
    from sdrplusplusbrown_tpu_torch.kernels import _build
    src = os.path.join(tmp, "latency.cu")
    so = os.path.join(tmp, "liblatency.so")
    with open(src, "w") as fh:
        fh.write(LATENCY_CU)
    subprocess.run([_build._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-w", "-shared",
                    "-Xcompiler", "-fPIC", "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    lib.lat_run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p]
    vals = [0.5, 0.9999, 1.0001, 3.0, 1.0] + [0.25 + k / 64 for k in
                                               range(16)] + [1.0] * 16
    inp = torch.tensor(vals, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    keep = torch.zeros(64, device="cuda")
    reps = 16
    out = {}
    for w, op in enumerate(OPS):
        best = None
        for _ in range(5):
            rc = lib.lat_run(w, inp.data_ptr(), reps, cyc.data_ptr(),
                             keep.data_ptr())
            if rc:
                raise RuntimeError(f"latency kernel {op}: CUDA error {rc}")
            c = int(cyc.item()) / (reps * 64)
            best = c if best is None else min(best, c)
        out[op] = best
    out["F2I_I2F"] = out["FMUL_F2I_I2F"] - out["FMUL"]
    return out


def chain_bounds(lat: dict, card: str) -> None:
    print("op latency, cycles: " + ", ".join(f"{k} {v:.2f}"
                                             for k, v in lat.items())
          + f" [{card}]")
    for name, ops in CHAINS.items():
        cyc = sum(n * lat[k] for k, n in ops.items())
        print(f"least chain a step, {name}: {cyc:.1f} cycles ("
              + ", ".join(f"{n:g} {k}" for k, n in ops.items())
              + f") [{card}]")


# ---- SASS ------------------------------------------------------------------

#: the instructions of a chain's step by which ``chain_loop`` finds the
#: walk's loop, and how many a step has: the rotor's reduction (K13c,
#: K13b), the floors of the row and the advance (K13m, K13f; the parent's
#: F2I.FLOOR, one a step)
STEP_MARK = (("0.63661974668502807617", 1), ("FADD.RM", 2),
             ("F2I.FLOOR", 1))


def chain_loop(fn: str) -> str:
    """The loop (a backward branch and its target) densest in a chain's
    steps (``STEP_MARK``, the first kind the function has): its steps,
    instructions and BSSY, BSYNC, local-memory (LDL, STL), shared-memory
    (LDS, STS), conversion (F2I, I2F, FRND) and branch counts; '' without
    one."""
    ins = [(int(a, 16), i.strip()) for a, i in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
    mark = next(((k, n) for k, n in STEP_MARK if k in fn), None)
    best = None
    for addr, i in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", i)
        if not mark or not m or int(m.group(1), 16) >= addr:
            continue
        body = [b for a, b in ins if int(m.group(1), 16) <= a <= addr]
        steps = sum(mark[0] in b for b in body) / mark[1]
        if steps >= 1 and (best is None or
                           steps / len(body) > best[0] / len(best[1])):
            best = (steps, body)
    if best is None:
        return ""
    steps, body = best
    ops = [b.split()[1] if b.startswith("@") else b.split()[0]
           for b in body]
    count = {k: sum(o.startswith(k) for o in ops)
             for k in ("BSSY", "BSYNC", "LDL", "STL", "LDS", "STS", "F2I",
                       "I2F", "FRND", "BRA")}
    return (f"{steps:g} steps, {len(ops)} instructions ("
            f"{len(ops) / steps:.1f} a step), "
            + ", ".join(f"{k} {v}" for k, v in count.items()))


#: the opcodes ``loops`` counts in each loop
LOOP_OPS = ("SHFL", "VOTE", "FMNMX", "FSEL", "MUFU", "LDS", "STS", "LDG",
            "LD.", "STG", "ST.", "BAR", "WARPSYNC", "BSSY", "BSYNC", "LDL",
            "STL", "BRA")


def _opcode(ins: str) -> str:
    return ins.split()[1] if ins.startswith("@") else ins.split()[0]


def _sources(ins: str) -> str:
    """The operand text an instruction reads: a store's every operand,
    else all but its destination."""
    op = _opcode(ins)
    rest = ins.split(op, 1)[1]
    if op.startswith(("ST", "RED", "ATOM", "BAR", "BRA")):
        return rest
    return rest.split(",", 1)[1] if "," in rest else ""


def loops(fn: str) -> list:
    """Every loop of a function's SASS (a backward branch and its
    target): its instructions, the count of each of ``LOOP_OPS`` and, for
    each global load in it, how many instructions later (around the
    loop) an instruction first reads the register it loads: a load whose
    first use comes soon is waited for there."""
    ins = [(int(a, 16), i.strip()) for a, i in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
    out = []
    for addr, i in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", i)
        if not m or int(m.group(1), 16) >= addr:
            continue
        body = [b for a, b in ins if int(m.group(1), 16) <= a <= addr]
        ops = [_opcode(b) for b in body]
        count = {k: sum(o.startswith(k) for o in ops) for k in LOOP_OPS}
        uses = []
        for n, b in enumerate(body):
            if not ops[n].startswith(("LDG", "LD.")):
                continue
            dst = re.match(r"\S+\s+(R\d+)", b.split(None, 1)[1]
                           if b.startswith("@") else b)
            if not dst:
                continue
            reg = re.compile(rf"\b{dst.group(1)}\b")
            for d in range(1, len(body) + 1):
                if reg.search(_sources(body[(n + d) % len(body)])):
                    uses.append(d)
                    break
        out.append(f"loop {m.group(1)}-{addr:#x}: {len(body)} "
                   f"instructions, " + ", ".join(
                       f"{k.rstrip('.')} {v}" for k, v in count.items()
                       if v)
                   + (f"; a global load's first use {min(uses)} "
                      f"instructions on (of {len(uses)} loads)"
                      if uses else ""))
    return out


def sass(path: str, label: str) -> None:
    """``cuobjdump -sass`` of the tree's loop kernels (K12, K12c, K13's
    forms, K16) into ``path`` (gzip), and for each its instruction count
    and BSSY, BSYNC, local (LDL, STL) and shared (LDS, STS) memory
    instructions, K13's chain loop (``chain_loop``) and, for K12, K12c
    and K16, every loop (``loops``); ptxas's lines for loops.cu, agc.cu
    and viterbi.cu from the build log."""
    import gzip
    from sdrplusplusbrown_tpu_torch.kernels import _build
    so = _build.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    keep = []
    for fn in re.split(r"\n\s+Function : ", text)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if not re.search(r"costas_kernel|mm_kernel|pll_kernel|"
                         r"agc_rows_kernel|viterbi", name):
            continue
        keep.append(f"Function : {fn}")
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", fn)
        ops = [i.split()[1] if i.startswith("@") else i.split()[0]
               for i in ins]
        count = {k: sum(o.startswith(k) for o in ops)
                 for k in ("BSSY", "BSYNC", "LDL", "STL", "LDS", "STS",
                           "BRA", "MUFU", "F2I", "I2F", "FRND", "SHFL")}
        print(f"tree {label}: SASS {name}: {len(ops)} instructions, "
              + ", ".join(f"{k} {v}" for k, v in count.items()))
        walk = chain_loop(fn)
        if walk:
            print(f"tree {label}: SASS {name}: the chain's loop "
                  + walk)
        if re.search(r"agc_rows_kernel|viterbi", name):
            for lp in loops(fn):
                print(f"tree {label}: SASS {name}: {lp}")
    with gzip.open(path, "wt") as fh:
        fh.write("\n".join(keep))
    log = so[:-3] + ".log"
    if os.path.exists(log):
        with open(log) as fh:
            text = fh.read()
        for src in ("loops.cu", "agc.cu", "viterbi.cu"):
            lines = text.split(f"== {src}", 1)[-1].split("== ", 1)[0] \
                if f"== {src}" in text else ""
            for ln in lines.splitlines():
                if "registers" in ln or "spill" in ln or "Compiling" in ln:
                    print(f"tree {label}: ptxas {src}: {ln.strip()}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--latency", action="store_true")
    ap.add_argument("--sass", default=None)
    ap.add_argument("--tags", default="",
                    help="comma-separated kernels to time (default all)")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k13_chain_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke       # this tree's, whatever --tree is
    sys.path.insert(0, os.path.abspath(a.tree))
    import sdrplusplusbrown_tpu_torch as port
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    label = os.path.relpath(os.path.dirname(os.path.dirname(
        os.path.abspath(port.__file__))), ROOT)
    print(f"k13_chain_ab: tree {label} ({port.__file__}) [{card}]",
          flush=True)
    dev = torch.device("cuda", 0)
    if a.sass:
        sass(a.sass, label)
    time_cases(smoke, dev, a.runs, label, card,
               set(filter(None, a.tags.split(","))))
    if a.latency:
        with tempfile.TemporaryDirectory(prefix="k13_latency_") as tmp:
            chain_bounds(latencies(tmp), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
