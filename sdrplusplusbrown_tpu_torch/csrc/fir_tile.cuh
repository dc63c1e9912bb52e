// The polyphase FIR tile of K3 (mpx_poly.cu) and K8 (fir_rows.cu).
//
// What it computes, on one row of real (float) or complex (float2) samples:
//     y[m·I + r] = Σ_l kern[r, l] · ext[m·D + l],   m < n_m, r < I
//     ext        = concat(tail (hist samples), x)
// with kern [I, kw] float32: a stride-1 FIR (I = D = 1), a decimating FIR
// (I = 1) or the widened L/M polyphase kernel of ops/resampler.py.
//
// K1's stages (mono_frontend.cu), K2's halfbands (wfm_demod.cu) and K6's
// two stages (chan_post.cu) run it too, with their own staging and store
// hooks (point 7); K9 (fir_cplx.cu) on complex taps (point 8).
//
// What bounds it on the H100: the path's geometries do 26-2 604 taps an
// output on a few MB a call, so the operations bound (non-tensor float32)
// and the bytes bound are both 0.1-3 µs; what a one-thread-an-output tile
// (a serial loop over every tap, the taps read through the read-only
// cache) loses is memory access and latency.  The design, point by point:
//
//  1. Warp-uniform phase.  A warp's lanes share one phase row r, so every
//     tap read is one shared-memory broadcast.  A block stages the taps
//     of its group of G phase rows (fir_plan chooses G where I·kw does
//     not fit) beside its input span.
//  2. Nonzero band only.  Each phase row loops over its own band [lo_r,
//     hi_r), found on the card from the staged taps (a warp reduction a
//     row): no host sync, no argument for the callers to follow.  The
//     consequence: a NaN or inf in ext outside a row's band (at D = 2 and
//     4, outside the band's start rounded down to a multiple of D) no
//     longer reaches that output, where conv1d and the TPU's banded
//     matmul both multiply it by zero.
//  3. Conflict-free input reads.  The span is staged de-interleaved by
//     input phase, sx[p][j] = ext[e0 + j·D + p], so ext[m·D + l] =
//     sx[l mod D][m − m0 + l div D]: for a fixed tap, consecutive outputs
//     read consecutive words of one row, for every D.  float32 data is
//     staged with cp.async (4 or 8 bytes a sample, no register round
//     trip), in the same commit group as the taps; bf16 data (K3 in the
//     bf16 handoff) is upcast once, on staging.
//  4. A register tile.  Lane t of a warp computes P (odd: 1, 3, 5; 7 in
//     K6's bandwidth launch)
//     consecutive outputs m0 + t·P + j with independent accumulators, and
//     one broadcast tap read feeds all P.  At D = 1, 2 and 4 (the
//     decimators and stride-1 FIRs, the dense stages) the inputs slide
//     through a ring of P·D registers, so one shared-memory input read
//     feeds P multiply-adds (2P on complex rows); at other D (the
//     polyphase ratios, 1-3 taps an input phase) each output reads its
//     own.  The lanes' stride P is odd, so a warp's 32 reads hit 32
//     distinct banks.  Every output sums its taps in ascending order,
//     one fused multiply-add each, as the one-thread-an-output tile did:
//     a zero tap's multiply-add is exact, so the outputs are the same
//     bits, and a cold-start block, which amplifies rounding, matches the
//     CPU's conv1d as closely as before.
//  5. Complex rows in one block.  A complex64 row is read as float2: the
//     re and im of one output share each tap read and each staging copy.
//  6. A host-side plan (ops/fir_kernel.py:fir_plan) picks P, G, the
//     output chunks a block takes (C of 32·P outputs each) and the warps,
//     so that a call with enough work launches >= 132 blocks and the
//     block's shared memory (fir_tile_layout) stays within 227 KB.
//  7. Hooks.  The caller hands the tile its block's outputs [m0, m0 + mb)
//     (at most C·32·P), a staging hook that puts ext sample e into shared
//     memory (TailThen: the copy above; K2 runs its discriminator there;
//     K1's stage 0 copies the raw wideband with cp.async, then, in a
//     second pass once the copies have landed, mixes each sample by its
//     NCO in place) and a store hook for output i of y (StoreTo: y[i];
//     K1's last stage splits a complex row into the re and im planes of
//     the handoff).  The tap loops take any accumulator
//     and tap type that fma_e pairs with the sample: K2's stereo section
//     sums two real tap rows (a float2 tap) on one real input.
//  8. Complex taps.  With a float2 tap type the kernel is two planes,
//     [2, I, kw] (re, then im), staged interleaved; a tap is in a row's
//     band where either part is nonzero.  K9 sums them into a float4
//     accumulator, its four real sums apart (rr, ii, ri, ir), each in
//     ascending tap order, and an output is (rr − ii, ri + ir): the
//     one-thread-an-output kernel's sums and combine, so the same bits.
//
// Outputs go through a shared-memory tile, so that a block writes its
// [m, r] outputs in order of y.  No tensor cores, on purpose: taps and
// data are float32 and the parity bar is 100 dB.  TF32 keeps ~10
// mantissa bits and fails it; a 3×TF32 split triples the matrix work,
// where the operations bound is already ~1 µs a call.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace sdr {

constexpr int FIR_SMEM_MAX = 232448;     // the H100's 227 KB a block

__host__ __device__ inline int fir_r4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int fir_imin(int a, int b) { return a < b ? a : b; }

// Float offsets of a block's shared memory: the G phase rows' taps (of
// tcomps floats each), their bands (lo[G], hi[G] as ints), the output tile
// [m][G | 1] and the de-interleaved input [min(D, kw)][S]; ``total`` floats
// in all.  ops/fir_kernel.py:tile_smem mirrors it.
struct FirLayout {
  int band, out, in, stride, total;
};

__host__ __device__ inline FirLayout fir_tile_layout(int D, int kw, int n_m,
                                                     int P, int G, int C,
                                                     int comps,
                                                     int tcomps = 1) {
  const int mb = fir_imin(C * 32 * P, n_m);
  FirLayout f;
  f.band = fir_r4(G * kw * tcomps);
  f.out = f.band + fir_r4(2 * G);
  f.in = f.out + fir_r4(mb * (G | 1) * comps);
  // odd, so that consecutive input phases of one j fall in distinct banks
  f.stride = (mb + (kw - 1) / D) | 1;
  // + P samples: the lanes past a block's last output read (and discard)
  // up to P samples beyond the last input row
  f.total = f.in + fir_r4((fir_imin(D, kw) * f.stride + P) * comps);
  return f;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async(float2* dst, const float2* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// One ext sample into shared memory: float32 and complex64 by cp.async,
// bf16 upcast through a register.
__device__ __forceinline__ void stage(float* dst, const float* src) {
  cp_async(dst, src);
}
__device__ __forceinline__ void stage(float2* dst, const float2* src) {
  cp_async(dst, src);
}
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}

// bf16 rounding of a float32 value (the handoff's storage), read back.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float2 bf16_round(float2 v) {
  return make_float2(bf16_round(v.x), bf16_round(v.y));
}

// One tap into shared memory: a real tap, or a complex one from its two
// planes ``plane`` floats apart (re, then im).
__device__ __forceinline__ void stage_tap(float* d, const float* k, long) {
  cp_async(d, k);
}
__device__ __forceinline__ void stage_tap(float2* d, const float* k,
                                          long plane) {
  cp_async(&d->x, k);
  cp_async(&d->y, k + plane);
}

__device__ __forceinline__ bool tap_nonzero(float k) { return k != 0.f; }
__device__ __forceinline__ bool tap_nonzero(float2 k) {
  return k.x != 0.f || k.y != 0.f;
}

// An accumulator as the output it sums to: itself, or K9's four real sums
// (rr, ii, ri, ir) as (rr − ii, ri + ir).
__device__ __forceinline__ float acc_value(float a) { return a; }
__device__ __forceinline__ float2 acc_value(float2 a) { return a; }
__device__ __forceinline__ float2 acc_value(float4 a) {
  return make_float2(a.x - a.y, a.z + a.w);
}

// Staging hook of a plain FIR: ext = concat(tail (hist samples), x).
template <typename E, typename X>
struct TailThen {
  const E* tail;
  int hist;
  const X* x;
  __device__ __forceinline__ void operator()(E* d, long e) const {
    if (e < hist)
      stage(d, tail + e);
    else
      stage(d, x + (e - hist));
  }
};

// ``v`` rounded to bf16 where ``bf16`` is set (a carried tail stored so).
template <typename E>
__device__ __forceinline__ E bf16_round_if(E v, int bf16) {
  return bf16 ? bf16_round(v) : v;
}

// Staging hook of a stage whose carried tail may be stored in bf16: ext =
// concat(tail, read rounded to bf16 where ``bf16`` is set, x).
template <typename E>
struct RoundedTailThen {
  const E* tail;
  int hist, bf16;
  const E* x;
  __device__ __forceinline__ void operator()(E* d, long e) const {
    if (e >= hist)
      stage(d, x + (e - hist));
    else if (bf16)
      *d = bf16_round(tail[e]);
    else
      stage(d, tail + e);
  }
};

// A staging hook with a finish(d, e) pass: its operator() only starts
// the copies of sample e's inputs into d; after they land, finish(d, e)
// turns them into the sample, each thread on the slots it staged.
template <typename S, typename = void>
struct two_pass : std::false_type {};
template <typename S>
struct two_pass<S, std::void_t<decltype(&S::finish)>> : std::true_type {};

// Store hook of a plain FIR: y[i].
template <typename E>
struct StoreTo {
  E* y;
  __device__ __forceinline__ void operator()(long i, E v) const { y[i] = v; }
};

// One tap on an accumulator: real taps on real or complex (float2)
// samples, or two real tap rows (a float2 tap) on a real sample.
__device__ __forceinline__ void fma_e(float& acc, float k, float v) {
  acc = fmaf(k, v, acc);
}
__device__ __forceinline__ void fma_e(float2& acc, float k, float2 v) {
  acc.x = fmaf(k, v.x, acc.x);
  acc.y = fmaf(k, v.y, acc.y);
}
__device__ __forceinline__ void fma_e(float2& acc, float2 k, float v) {
  acc.x = fmaf(k.x, v, acc.x);
  acc.y = fmaf(k.y, v, acc.y);
}
// a complex tap (hr, hi) on a complex sample (xr, xi), K9's four sums
// apart: acc = (Σ xr·hr, Σ xi·hi, Σ xr·hi, Σ xi·hr)
__device__ __forceinline__ void fma_e(float4& acc, float2 k, float2 v) {
  acc.x = fmaf(v.x, k.x, acc.x);
  acc.y = fmaf(v.y, k.y, acc.y);
  acc.z = fmaf(v.x, k.y, acc.z);
  acc.w = fmaf(v.y, k.x, acc.w);
}

// Taps [lo, hi) of a phase row, in ascending order, on P consecutive
// outputs, the first of which reads xs = sx + mm0: ext[(mm0 + j)·D + l] =
// xs[(l mod D)·S + l div D + j].  Any D: tap l = a·D + p, a outer and the
// input phase p inner, so that the inner loop is a plain stride-S walk;
// each tap costs one broadcast tap read and P input reads.
template <int P, typename A, typename E, typename T>
__device__ __forceinline__ void taps_any_d(A (&acc)[P], const E* xs,
                                           const T* kr, int S, int D,
                                           int lo, int hi) {
  int a = lo / D, p = lo - a * D;
  for (int base = a * D; base < hi; base += D, ++a, p = 0) {
    const int pe = fir_imin(D, hi - base);
    const E* x = xs + a + p * S;
#pragma unroll 4
    for (; p < pe; ++p, x += S) {
      const T k = kr[base + p];
#pragma unroll
      for (int j = 0; j < P; ++j) fma_e(acc[j], k, x[j]);
    }
  }
}

// The same for D = DT (1, 2 or 4; kw >= D): the inputs slide through a
// ring of R = P·DT registers, so each tap costs one input read, one tap
// read and P multiply-adds.  At tap t the ring holds the offsets [t, t +
// R − 1] of output 0, offset e in slot (e − l0) mod R, and output j reads
// offset t + j·DT.  The taps go in chunks of R from lo rounded down to a
// multiple of DT (the taps below lo are zero), so that every slot and
// input row is a compile-time constant.  A value loaded beyond what the
// last tap needs is never read.
template <int P, int DT, typename A, typename E, typename T>
__device__ __forceinline__ void taps_ring(A (&acc)[P], const E* xs,
                                          const T* kr, int S, int lo,
                                          int hi) {
  constexpr int R = P * DT;
  int l = lo - lo % DT;
  const E* x = xs + l / DT;         // offset l + e at x[(e % DT)·S + e / DT]
  E w[R];
#pragma unroll
  for (int e = 0; e < R - 1; ++e) w[e] = x[(e % DT) * S + e / DT];
  for (; l + R <= hi; l += R, x += P) {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      w[(s + R - 1) % R] = x[((s + R - 1) % DT) * S + (s + R - 1) / DT];
      const T k = kr[l + s];
#pragma unroll
      for (int j = 0; j < P; ++j) fma_e(acc[j], k, w[(s + j * DT) % R]);
    }
  }
#pragma unroll
  for (int s = 0; s < R - 1; ++s) {
    if (l + s < hi) {
      w[(s + R - 1) % R] = x[((s + R - 1) % DT) * S + (s + R - 1) / DT];
      const T k = kr[l + s];
#pragma unroll
      for (int j = 0; j < P; ++j) fma_e(acc[j], k, w[(s + j * DT) % R]);
    }
  }
}

// One block: phase rows r0 = blockIdx.y·G ... (at most G), outputs m0
// ... m0 + mb − 1 (mb <= C·32·P) of the row whose staging hook ``src``
// (src(d, e) puts ext sample e at d) and store hook ``dst`` (dst(i, v)
// stores y[i]) the caller gives.  E is the sample, float or float2; T the
// tap, float or float2 (point 8); A the accumulator an output sums into.
template <int P, typename E, typename T = float, typename A = E,
          typename Src, typename Dst>
__device__ __forceinline__ void fir_tile(
    const Src& src, const float* __restrict__ kern, int I, int D, int kw,
    const Dst& dst, int n_m, int m0, int mb, int G, int C, float* smem) {
  constexpr int comps = sizeof(E) / sizeof(float);
  constexpr int tcomps = sizeof(T) / sizeof(float);
  const FirLayout f = fir_tile_layout(D, kw, n_m, P, G, C, comps, tcomps);
  T* taps = reinterpret_cast<T*>(smem);
  int* band = reinterpret_cast<int*>(smem + f.band);
  E* out = reinterpret_cast<E*>(smem + f.out);
  E* sx = reinterpret_cast<E*>(smem + f.in);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nth >> 5;
  const int r0 = blockIdx.y * G, gn = fir_imin(G, I - r0);
  const int S = f.stride, prow = fir_imin(D, kw);

  // 1. the group's taps and the block's input span, one commit group;
  // a two-pass hook then finishes, in place, each sample it staged
  const float* kg = kern + static_cast<long>(r0) * kw;
  for (int i = tid; i < gn * kw; i += nth)
    stage_tap(taps + i, kg + i, static_cast<long>(I) * kw);
  const auto each_sample = [&](auto&& fn) {
    const int J = mb + (kw - 1) / D;          // samples a row holds
    const int need = (mb - 1) * D + kw;       // ext samples the block reads
    const long e0 = static_cast<long>(m0) * D;
    const int dj = nth / prow, dp = nth - dj * prow;
    int j = tid / prow, p = tid - j * prow;   // sample e0 + j·D + p
    // unrolled, so that a bf16 block's loads are in flight together
#pragma unroll 8
    for (int i = tid; i < J * prow; i += nth) {
      const int off = j * D + p;
      if (off < need) fn(sx + p * S + j, e0 + off);
      j += dj;
      p += dp;
      if (p >= prow) {
        p -= prow;
        ++j;
      }
    }
  };
  each_sample([&](E* d, long e) { src(d, e); });
  cp_async_wait_all();
  if constexpr (two_pass<Src>::value)
    each_sample([&](E* d, long e) { src.finish(d, e); });
  __syncthreads();

  // 2. each phase row's nonzero band [lo, hi), one warp a row
  for (int g = warp; g < gn; g += nw) {
    int lo = kw, hi = 0;
    for (int l = lane; l < kw; l += 32) {
      if (tap_nonzero(taps[g * kw + l])) {
        lo = fir_imin(lo, l);
        hi = l + 1;
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      band[g] = lo;
      band[G + g] = hi;
    }
  }
  __syncthreads();

  // 3. each warp a (phase row, chunk of 32·P outputs) unit at a time
  const int Gp = G | 1;
  for (int u = warp; u < gn * C; u += nw) {
    const int g = u % gn;
    const int mm0 = (u / gn) * 32 * P + lane * P;
    if (mm0 >= mb) continue;
    A acc[P] = {};
    const int lo = band[g], hi = band[G + g];
    if (hi > lo) {
      const E* xs = sx + mm0;
      const T* kr = taps + g * kw;
      if (D == 1)
        taps_ring<P, 1>(acc, xs, kr, S, lo, hi);
      else if (D == 2 && kw >= 2)
        taps_ring<P, 2>(acc, xs, kr, S, lo, hi);
      else if (D == 4 && kw >= 4)
        taps_ring<P, 4>(acc, xs, kr, S, lo, hi);
      else
        taps_any_d<P>(acc, xs, kr, S, D, lo, hi);
    }
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (mm0 + j < mb) out[(mm0 + j) * Gp + g] = acc_value(acc[j]);
  }
  __syncthreads();

  // 4. the block's outputs in order of y
  for (int i = tid; i < mb * gn; i += nth) {
    const int mm = i / gn, g = i - mm * gn;
    dst(static_cast<long>(m0 + mm) * I + r0 + g, out[mm * Gp + g]);
  }
}

// The plain grid's block: outputs blockIdx.x·C·32·P ... of a row's n_m,
// read through ``tail`` then ``x`` and written to ``y``.
template <int P, typename E, typename X>
__device__ __forceinline__ void fir_tile_grid(
    const E* __restrict__ tail, int hist, const X* __restrict__ x,
    const float* __restrict__ kern, int I, int D, int kw,
    E* __restrict__ y, int n_m, int G, int C, float* smem) {
  const int m0 = blockIdx.x * C * 32 * P;
  fir_tile<P, E>(TailThen<E, X>{tail, hist, x}, kern, I, D, kw,
                 StoreTo<E>{y}, n_m, m0, fir_imin(C * 32 * P, n_m - m0), G,
                 C, smem);
}

// Opt the kernel in to its shared memory and launch it on ``grid``.
template <typename Kernel, typename... Args>
inline cudaError_t fir_launch(Kernel* kernel, dim3 grid, int warps,
                              size_t smem, cudaStream_t stream,
                              Args... args) {
  if (smem > static_cast<size_t>(FIR_SMEM_MAX)) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 32 * warps, smem, stream>>>(args...);
  return cudaGetLastError();
}

// fir_launch of the instance for P outputs a lane, ks[i] that of P =
// 2i + 1 (P odd: a warp's stride-P reads hit 32 banks).
template <typename Kernel, int N, typename... Args>
inline cudaError_t fir_launch_p(int P, Kernel* const (&ks)[N], dim3 grid,
                                int warps, size_t smem, cudaStream_t stream,
                                Args... args) {
  if (P < 1 || P % 2 == 0 || P / 2 >= N) return cudaErrorInvalidValue;
  return fir_launch(ks[P / 2], grid, warps, smem, stream, args...);
}

// The same for P = 1, 3 or 5 (k1, k3, k5).
template <typename Kernel, typename... Args>
inline cudaError_t fir_launch_p(int P, Kernel* k1, Kernel* k3, Kernel* k5,
                                dim3 grid, int warps, size_t smem,
                                cudaStream_t stream, Args... args) {
  Kernel* const ks[] = {k1, k3, k5};
  return fir_launch_p(P, ks, grid, warps, smem, stream, args...);
}

}  // namespace sdr
