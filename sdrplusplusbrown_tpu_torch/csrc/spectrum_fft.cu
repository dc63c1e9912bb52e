// K4 / K4f / K4r — framed power spectrum in dB: a register-radix FFT.
//
// Replaces: sdrplusplusbrown_tpu/ops/pallas_fft.py:_fft_pow_frames_kernel
// (:279, the framed spectrum of the TPU front end, with fft_pow_db_tile,
// :253, and _dft_n1_split, :190): K4, frames at 1024-aligned starts of
// (xr, xi) planes; and :_fft_pow_kernel (:64, the windowed 4-step FFT
// behind spectrum_path_db and fft_power_db_planes): K4f, frames at exact
// starts of an interleaved complex64 block read in place, and K4r, the
// channelizer's [2M, W] bin planes, every channel's frames at once, read
// in place through the row stride (bench.py:build_channelizer64).
//
// What it computes: the frames come in rows of ``frames_per_row``; frame
// f of row r, ``keep`` samples, starts at r·row_stride + rup(f·interval,
// align) of (xr, xi) — one shared wideband (one row; align 1024 for K4, 1
// for K4f) or the rows of a plane view (K4r: row_stride the view's row
// stride, interval = keep = N) — read with element stride ``es`` (1 for
// planes, 2 for the parts of an interleaved complex64 block), in float32
// or bfloat16 storage (``in_bf16``); it is multiplied by the window (which
// includes the (−1)^i DC-centering factor; none when the pointer is null),
// zero-padded to N, transformed, and each bin becomes
// 10·log10(max(|X|²/N², floor)), in natural bin order: [n_frames, N].
//
// The transform.  An L-point sequence sits in shared memory as complex64,
// one slot in 16 left as padding against bank conflicts.  It goes through
// Stockham radix passes: each thread holds E = 16 complex values in
// registers, multiplies them by their twiddles, runs one radix-16 DFT in
// registers (16/R radix-R DFTs on the last pass when 16 does not divide
// what is left: R = 2, 4 or 8) and writes them back.  A Stockham pass
// leaves its output in natural order, so there is no digit reversal, and
// L = 1024 = 16·16·4 takes three passes with two exchanges between them.
// Twiddles come from one table a transform size, tw[m] = exp(−2πim/N) for
// m < N, computed in float64 and rounded once to float32 on the device
// (ops/fft_kernel.py:twiddles, cached per size and device).  A pass's
// twiddle W_(Ns·R)^(r·k) is entry r·k·(L/(Ns·R))·(N/L), and r·k < Ns·R, so
// the index stays below N; the four-step twiddle W_N^(n2·k1) is entry
// n2·k1 mod N, gathered once into the order the column launch reads it
// (ops/fft_kernel.py:four_step_twiddles).  A correctly rounded entry is at
// least as accurate as the sincospif of an exactly reduced angle that the
// radix-2 design called per butterfly, and costs one cached load.  The dB
// are 10·log10(2)·log2 of the power, one MUFU.LG2 (~1e-5 dB off log10f).
//
// Two routes; the wrapper's plan (ops/fft_kernel.py:plan) picks one by N:
//   * one pass, 256 ≤ N ≤ 4 096 (sdr_fft_frames): a block holds
//     256·16/N frames (one at 4 096; 34 KB of shared memory), loads each
//     with 16-byte loads (8 bf16, 4 float32 or 2 complex64 samples a
//     thread, neighbours on neighbouring addresses) where the frame is
//     16-byte aligned, all in flight before the first store to shared
//     memory; transforms it; and on the last pass gives each thread E/R
//     adjacent bins, whose dB leave in natural order with 16-byte stores
//     (4 bins a store at N = 1 024).  One launch, no device-memory
//     scratch; K4r's 2 048 frames of 1 024 are 512 blocks.
//   * four-step, 8 192 ≤ N ≤ 262 144 (sdr_fft_cols, then sdr_fft_rows):
//     N = N1·N2 (N1 = 2^ceil(log2(N)/2)); the first launch runs the N1-point
//     column FFTs over n1 of a[n1·N2 + n2], times W_N^(n2·k1), into a
//     complex64 scratch C[f, k1, n2] (1 MB at two 65 536-point frames, so
//     it stays in the 50 MB L2); the second the N2-point row FFTs of C,
//     whose bin k1 + N1·k2 gets power and dB.  Both stage their strided
//     side in shared memory: the column launch reads and writes with the
//     block's adjacent columns on adjacent threads, the row launch writes
//     its adjacent rows' dB of a bin k2 in one store; either way a warp's
//     access covers whole runs, where one warp a sequence touched a sector
//     a bin for 4 or 8 bytes.  Each block takes as many columns (rows) as
//     keep it at one sequence per 16 threads, at most 256 threads, while
//     the launch still has 132 blocks or more: two 65 536-point frames
//     give 256 blocks of 32 threads in each launch.
//
// What bounds it on the H100.  K4r at channelizer64 (2 048 frames of 1 024
// from bf16 bins): 8.4 MB in and 8.4 MB of dB out, 5.0 µs of HBM time; the
// FFT's ~0.1 GFLOP is 1.5 µs at the FP32 peak, so bytes bound it, and the
// one-pass route moves only those bytes, though its instructions (a
// radix-16 DFT and 32 shared-memory accesses a thread and pass) take about
// as long again, and a block's load, passes and store do not overlap.
// K4 and K4f (1–2 frames of 65 536 or 262 144 a call): 0.5–1.2 µs of
// bytes, so launch latency, each block's serial chain (global load,
// passes, twiddle loads, store) and the L2 requests of the transpose bound
// them; the four-step route fills every SM and keeps each chain to two or
// three register passes.  The radix-2 design this
// replaces called sincospif per butterfly, ran log2(L) barrier-separated
// stages in shared memory, passed K4r's frames through a 33.5 MB scratch
// round trip in two launches and gave two 65 536-point frames 32 blocks
// on 132 SMs.
//
// Left for later: the four-step's transpose in a thread-block cluster's
// distributed shared memory (one launch, no scratch), and fusing K4 into
// K1's read of the wideband (as the TPU did).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int E = 16;        // complex values a thread holds: the radix
constexpr int BLOCK = 256;   // threads of a block at most

// An L-point sequence takes padded(L) float2 slots of shared memory: one
// in 16 is padding, so the 16 threads of a half-warp that store with
// stride 16 (a radix-16 pass's output) or 8, 4, 2 (the loads) reach 16
// different bank pairs.
__host__ __device__ constexpr int padded(int n) { return n + (n >> 4); }

__device__ __forceinline__ int pad(int a) { return a + (a >> 4); }

// Radix of the last Stockham pass of an L-point sequence.
__host__ __device__ constexpr int last_radix(int L) {
  while (L > E) L /= E;
  return L;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 mul_mi(float2 a) {   // a · (−i)
  return make_float2(a.y, -a.x);
}

// exp(−2πi·m/16); m is a constant wherever it is called.
__device__ __forceinline__ float2 w16(int m) {
  constexpr float C = 0.92387953251128674f;   // cos(π/8)
  constexpr float S = 0.38268343236508977f;   // sin(π/8)
  constexpr float H = 0.70710678118654752f;   // cos(π/4)
  switch (m & 15) {
    case 1: return make_float2(C, -S);
    case 2: return make_float2(H, -H);
    case 3: return make_float2(S, -C);
    case 5: return make_float2(-S, -C);
    case 6: return make_float2(-H, -H);
    case 7: return make_float2(-C, -S);
    case 9: return make_float2(-C, S);
    case 10: return make_float2(-H, H);
    case 11: return make_float2(-S, C);
    case 13: return make_float2(S, C);
    case 14: return make_float2(H, H);
    case 15: return make_float2(C, S);
    default: return make_float2(1.f, 0.f);   // 0, 4, 8, 12 are not called
  }
}

// DFTs in registers, natural order in and out: v[k] = Σ_n v[n]·W_R^(nk).
__device__ __forceinline__ void dft2(float2* v) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

// The 4-point DFT of v[0], v[S], v[2S], v[3S], in place.
template <int S>
__device__ __forceinline__ void dft4(float2* v) {
  const float2 s02 = cadd(v[0], v[2 * S]), d02 = csub(v[0], v[2 * S]);
  const float2 s13 = cadd(v[S], v[3 * S]);
  const float2 d13 = mul_mi(csub(v[S], v[3 * S]));
  v[0] = cadd(s02, s13);
  v[2 * S] = csub(s02, s13);
  v[S] = cadd(d02, d13);
  v[3 * S] = csub(d02, d13);
}

// n = 4·n1 + n2: radix 2 over n1, W_8^(n2·k1), radix 4 over n2; bin
// k1 + 2·k2 comes out in v[4·k1 + k2].
__device__ __forceinline__ void dft8(float2* v) {
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) {
    const float2 a = v[n2];
    v[n2] = cadd(a, v[4 + n2]);
    v[4 + n2] = csub(a, v[4 + n2]);
  }
  v[5] = cmul(v[5], w16(2));
  v[6] = mul_mi(v[6]);
  v[7] = cmul(v[7], w16(6));
  dft4<1>(v);
  dft4<1>(v + 4);
  float2 t[8];
#pragma unroll
  for (int k1 = 0; k1 < 2; ++k1)
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) t[k1 + 2 * k2] = v[4 * k1 + k2];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = t[i];
}

// n = 4·n1 + n2: radix 4 over n1, W_16^(n2·k1), radix 4 over n2; bin
// k1 + 4·k2 comes out in v[4·k1 + k2].
__device__ __forceinline__ void dft16(float2* v) {
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) dft4<4>(v + n2);
  v[5] = cmul(v[5], w16(1));
  v[6] = cmul(v[6], w16(2));
  v[7] = cmul(v[7], w16(3));
  v[9] = cmul(v[9], w16(2));
  v[10] = mul_mi(v[10]);
  v[11] = cmul(v[11], w16(6));
  v[13] = cmul(v[13], w16(3));
  v[14] = cmul(v[14], w16(6));
  v[15] = cmul(v[15], w16(9));
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) dft4<1>(v + 4 * k1);
  float2 t[16];
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1)
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) t[k1 + 4 * k2] = v[4 * k1 + k2];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = t[i];
}

template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) dft2(v);
  else if constexpr (R == 4) dft4<1>(v);
  else if constexpr (R == 8) dft8(v);
  else dft16(v);
}

// Stockham radix-R pass over an L-point sequence s (thread t of its L/E):
// group j reads sample j + r·L/R, r < R, times W_(Ns·R)^(r·k), k = j mod
// Ns, from the table with stride ``ts`` = N/L.  Group j is thread t's g-th,
// j = t + (L/E)·g, or with BLOCKED j = (E/R)·t + g, so that on the last
// pass a thread holds E/R adjacent bins of each r.
template <int L, int R, int NS, bool BLOCKED>
__device__ __forceinline__ void pass_load(const float2* s, int t,
                                          const float2* tw, int ts,
                                          float2 (&v)[E]) {
  constexpr int TL = L / E;
#pragma unroll
  for (int g = 0; g < E / R; ++g) {
    const int j = BLOCKED ? (E / R) * t + g : t + TL * g;
    const int k = j & (NS - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float2 z = s[pad(j + r * (L / R))];
      if (NS > 1 && r > 0)
        z = cmul(z, __ldg(tw + r * k * (L / (NS * R)) * ts));
      v[g * R + r] = z;
    }
    dft<R>(v + g * R);
  }
}

// ... and writes bin r of group j to (j / Ns)·Ns·R + k + r·Ns.
template <int L, int R, int NS>
__device__ __forceinline__ void pass_store(float2* s, int t,
                                           const float2 (&v)[E]) {
  constexpr int TL = L / E;
#pragma unroll
  for (int g = 0; g < E / R; ++g) {
    const int j = t + TL * g;
    const int d = (j / NS) * NS * R + (j & (NS - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) s[pad(d + r * NS)] = v[g * R + r];
  }
}

// Every pass from stride NS on.  The sequence is in shared memory and
// synced; on return v[g·R + r] holds bin out_bin<L, BLOCKED>(t, g, r) and
// every thread of the block has met the same barriers.
template <int L, int NS, bool BLOCKED>
__device__ __forceinline__ void fft_passes(float2* s, int t,
                                           const float2* tw, int ts,
                                           float2 (&v)[E]) {
  constexpr int R = L / NS >= E ? E : L / NS;
  constexpr bool last = NS * R == L;
  pass_load<L, R, NS, last && BLOCKED>(s, t, tw, ts, v);
  if constexpr (!last) {
    __syncthreads();
    pass_store<L, R, NS>(s, t, v);
    __syncthreads();
    fft_passes<L, NS * R, BLOCKED>(s, t, tw, ts, v);
  }
}

// The bin that v[g·R + r] holds after fft_passes<L, 1, BLOCKED>
// (R = last_radix(L)).
template <int L, bool BLOCKED>
__device__ __forceinline__ int out_bin(int t, int g, int r) {
  constexpr int R = last_radix(L);
  return (BLOCKED ? (E / R) * t + g : t + (L / E) * g) + r * (L / R);
}

// First element of frame f: its row's offset, then rup(fr·interval,
// align) samples of es elements.
__device__ __forceinline__ long frame_origin(int f, int frames_per_row,
                                             int row_stride, int interval,
                                             int align, int es) {
  const int row = f / frames_per_row;
  const int fr = f - row * frames_per_row;
  const long p0 =
      (static_cast<long>(fr) * interval + align - 1) / align * align;
  return static_cast<long>(row) * row_stride + p0 * es;
}

// Sample n of a frame starting at element e0, unwindowed; 0 from keep on.
__device__ __forceinline__ float2 sample(const void* xr, const void* xi,
                                         int bf16, int es, long e0, int keep,
                                         int n) {
  if (n >= keep) return make_float2(0.f, 0.f);
  const long i = e0 + static_cast<long>(n) * es;
  return make_float2(sdr::ld(xr, i, bf16), sdr::ld(xi, i, bf16));
}

__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// A thread's E samples of an N-point frame, V consecutive ones per load:
// sample V·(t + (N/E)·q) + i is z[V·q + i] (q < E/V, i < V).  Every load
// is issued before the first store to shared memory, so all are in flight
// at once; then each sample is windowed and stored.
template <int N, int V>
__device__ __forceinline__ void store_frame(float2* s, int t, float2 (&z)[E],
                                            const float* window, int keep) {
  constexpr int TL = N / E;
#pragma unroll
  for (int q = 0; q < E / V; ++q)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int n = V * (t + TL * q) + i;
      if (window && n < keep) {
        const float w = __ldg(window + n);
        z[V * q + i] = make_float2(z[V * q + i].x * w, z[V * q + i].y * w);
      }
    }
#pragma unroll
  for (int q = 0; q < E / V; ++q)
#pragma unroll
    for (int i = 0; i < V; ++i) s[pad(V * (t + TL * q) + i)] = z[V * q + i];
}

// The V samples from n on, one by one (a chunk that runs past keep).
template <int V>
__device__ __forceinline__ void scalar_chunk(float2* z, const void* xr,
                                             const void* xi, int bf16, int es,
                                             long e0, int keep, int n) {
#pragma unroll
  for (int i = 0; i < V; ++i) z[i] = sample(xr, xi, bf16, es, e0, keep, n + i);
}

// Interleaved complex64 (the parts of a complex block read in place).
__device__ __forceinline__ bool interleaved(const void* xr, const void* xi,
                                            int bf16, int es) {
  return es == 2 && !bf16 && static_cast<const char*>(xi) ==
                                 static_cast<const char*>(xr) + 4;
}

// One N-point frame into s by its N/E threads: 16-byte loads (float32 or
// bf16 planes, or an interleaved complex64 block) where the frame's start
// is 16-byte aligned, scalar ones else; each thread takes neighbouring
// addresses to its neighbours'.
template <int N>
__device__ void load_frame(float2* s, int t, const void* xr, const void* xi,
                           int bf16, int es, long e0, const float* window,
                           int keep) {
  constexpr int TL = N / E;
  const int esz = bf16 ? 2 : 4;
  const char* pr = static_cast<const char*>(xr) + e0 * esz;
  const char* pi = static_cast<const char*>(xi) + e0 * esz;
  const bool al = (reinterpret_cast<uintptr_t>(pr) & 15) == 0;
  const bool al2 = al && (reinterpret_cast<uintptr_t>(pi) & 15) == 0;
  float2 z[E];
  if (es == 1 && !bf16 && al2) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const int n = 4 * (t + TL * q);
      if (n + 4 > keep) {
        scalar_chunk<4>(z + 4 * q, xr, xi, 0, 1, e0, keep, n);
        continue;
      }
      const float4 a = *reinterpret_cast<const float4*>(pr + 4 * n);
      const float4 b = *reinterpret_cast<const float4*>(pi + 4 * n);
      z[4 * q] = make_float2(a.x, b.x);
      z[4 * q + 1] = make_float2(a.y, b.y);
      z[4 * q + 2] = make_float2(a.z, b.z);
      z[4 * q + 3] = make_float2(a.w, b.w);
    }
    store_frame<N, 4>(s, t, z, window, keep);
  } else if (es == 1 && bf16 && al2) {
#pragma unroll
    for (int q = 0; q < E / 8; ++q) {
      const int n = 8 * (t + TL * q);
      if (n + 8 > keep) {
        scalar_chunk<8>(z + 8 * q, xr, xi, 1, 1, e0, keep, n);
        continue;
      }
      const uint4 a = *reinterpret_cast<const uint4*>(pr + 2 * n);
      const uint4 b = *reinterpret_cast<const uint4*>(pi + 2 * n);
      const unsigned wa[4] = {a.x, a.y, a.z, a.w};
      const unsigned wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        z[8 * q + 2 * i] = make_float2(bf16_lo(wa[i]), bf16_lo(wb[i]));
        z[8 * q + 2 * i + 1] = make_float2(bf16_hi(wa[i]), bf16_hi(wb[i]));
      }
    }
    store_frame<N, 8>(s, t, z, window, keep);
  } else if (interleaved(xr, xi, bf16, es) && al) {
#pragma unroll
    for (int q = 0; q < E / 2; ++q) {
      const int n = 2 * (t + TL * q);
      if (n + 2 > keep) {
        scalar_chunk<2>(z + 2 * q, xr, xi, 0, 2, e0, keep, n);
        continue;
      }
      const float4 a = *reinterpret_cast<const float4*>(pr + 8 * n);
      z[2 * q] = make_float2(a.x, a.y);
      z[2 * q + 1] = make_float2(a.z, a.w);
    }
    store_frame<N, 2>(s, t, z, window, keep);
  } else {
#pragma unroll
    for (int q = 0; q < E; ++q)
      z[q] = sample(xr, xi, bf16, es, e0, keep, t + TL * q);
    store_frame<N, 1>(s, t, z, window, keep);
  }
}

// 10·log10(max(|z|²·inv, floor)) as 10·log10(2)·log2: one MUFU.LG2
// (relative error ~2^-22) instead of log10f's reduction and polynomial.
__device__ __forceinline__ float power_db(float2 z, float inv, float floor_p) {
  return 3.01029995663981195f *
         __log2f(fmaxf((z.x * z.x + z.y * z.y) * inv, floor_p));
}

// C adjacent floats to o: 16-byte stores where C allows.
template <int C>
__device__ __forceinline__ void store_run(float* o, const float (&d)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      reinterpret_cast<float4*>(o)[q] =
          make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(d[0], d[1]);
  } else {
    o[0] = d[0];
  }
}

// One-pass route: frames_per_block frames of N points a block, N/E
// threads each; power and dB from the last pass's registers, E/R adjacent
// bins a thread (4 at N = 1 024: one 16-byte store per r).
template <int LOGN>
__global__ void __launch_bounds__(BLOCK)
    fft_frames_kernel(const void* __restrict__ xr,
                      const void* __restrict__ xi, int in_bf16, int es,
                      const float* __restrict__ window, int keep,
                      int interval, int align, int n_frames,
                      int frames_per_row, int row_stride,
                      int frames_per_block, const float2* __restrict__ tw,
                      float floor_p, float* __restrict__ out) {
  constexpr int N = 1 << LOGN, TL = N / E, RL = last_radix(N), C = E / RL;
  extern __shared__ float2 sm[];
  const int sq = threadIdx.x / TL;
  const int t = threadIdx.x - sq * TL;
  const int f = blockIdx.x * frames_per_block + sq;
  float2* s = sm + sq * padded(N);
  if (f < n_frames)
    load_frame<N>(s, t, xr, xi, in_bf16, es,
                  frame_origin(f, frames_per_row, row_stride, interval,
                               align, es),
                  window, keep);
  __syncthreads();
  float2 v[E];
  fft_passes<N, 1, true>(s, t, tw, 1, v);
  if (f >= n_frames) return;
  const float inv = 1.f / (static_cast<float>(N) * static_cast<float>(N));
  float* o = out + static_cast<long>(f) * N;
#pragma unroll
  for (int r = 0; r < RL; ++r) {
    float d[C];
#pragma unroll
    for (int g = 0; g < C; ++g) d[g] = power_db(v[g * RL + r], inv, floor_p);
    store_run<C>(o + out_bin<N, true>(t, 0, r), d);
  }
}

// Four-step, launch 1: cols_per_block columns n2 of one frame, N1/E
// threads each; the N1-point FFT over n1 of a[n1·N2 + n2], times
// W_N^(n2·k1) (tw4[k1·N2 + n2]: adjacent columns adjacent), into scratch
// C[f, k1, n2].  Loads and stores take element (n1 or k1, c) with the
// block's columns c fastest.
template <int LOG1>
__global__ void __launch_bounds__(BLOCK)
    fft_cols_kernel(const void* __restrict__ xr, const void* __restrict__ xi,
                    int in_bf16, int es, const float* __restrict__ window,
                    int keep, int interval, int align, int frames_per_row,
                    int row_stride, int N2, int cols_per_block,
                    const float2* __restrict__ tw,
                    const float2* __restrict__ tw4,
                    float2* __restrict__ scratch) {
  constexpr int N1 = 1 << LOG1, TL = N1 / E;
  extern __shared__ float2 sm[];
  const int cb = cols_per_block;
  const int lcb = __ffs(cb) - 1;   // cb is a power of two: shifts, no divides
  const int f = blockIdx.x / (N2 / cb);
  const int n2_0 = (blockIdx.x - f * (N2 / cb)) * cb;
  const long e0 = frame_origin(f, frames_per_row, row_stride, interval,
                               align, es);
  const bool cplx = interleaved(xr, xi, in_bf16, es);
  // element (n1, c) = sample n1·N2 + n2_0 + c, columns fastest: E a
  // thread, every load in flight before the first store
  float2 z[E];
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int i = threadIdx.x + blockDim.x * q;
    const int n = (i >> lcb) * N2 + n2_0 + (i & (cb - 1));
    if (n >= keep) {
      z[q] = make_float2(0.f, 0.f);
      continue;
    }
    z[q] = cplx ? *reinterpret_cast<const float2*>(
                      static_cast<const float*>(xr) + e0 + 2L * n)
                : sample(xr, xi, in_bf16, es, e0, keep, n);
    if (window) {
      const float w = __ldg(window + n);
      z[q] = make_float2(z[q].x * w, z[q].y * w);
    }
  }
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int i = threadIdx.x + blockDim.x * q;
    sm[(i & (cb - 1)) * padded(N1) + pad(i >> lcb)] = z[q];
  }
  __syncthreads();
  const int c = threadIdx.x / TL;
  const int t = threadIdx.x - c * TL;
  float2 v[E];
  fft_passes<N1, 1, false>(sm + c * padded(N1), t, tw, N2, v);
  constexpr int RL = last_radix(N1);
  // Back to shared memory in bin order, then out with the columns
  // fastest, as the load: a warp's loads of tw4 and stores to C cover
  // whole runs of the block's adjacent columns, where one warp a column
  // would touch a sector a bin for 8 bytes.
  __syncthreads();
#pragma unroll
  for (int g = 0; g < E / RL; ++g)
#pragma unroll
    for (int r = 0; r < RL; ++r)
      sm[c * padded(N1) + pad(out_bin<N1, false>(t, g, r))] = v[g * RL + r];
  __syncthreads();
  float2 w[E];
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int i = threadIdx.x + blockDim.x * q;
    w[q] = __ldg(tw4 + static_cast<long>(i >> lcb) * N2 + n2_0 +
                 (i & (cb - 1)));
  }
  float2* dst = scratch + static_cast<long>(f) * N1 * N2 + n2_0;
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int i = threadIdx.x + blockDim.x * q;
    dst[static_cast<long>(i >> lcb) * N2 + (i & (cb - 1))] = cmul(
        sm[(i & (cb - 1)) * padded(N1) + pad(i >> lcb)], w[q]);
  }
}

// Four-step, launch 2: rows_per_block rows k1 of C, N2/E threads each;
// the N2-point FFT over n2 gives bin k1 + N1·k2.  The dB go through
// shared memory, so that the block's rb adjacent bins k1_0 .. k1_0 + rb − 1
// of each k2 leave in one store (16-byte ones from rb = 4 on).
template <int LOG2>
__global__ void __launch_bounds__(BLOCK)
    fft_rows_kernel(const float2* __restrict__ scratch, int N1,
                    int rows_per_block, const float2* __restrict__ tw,
                    float floor_p, float* __restrict__ out) {
  constexpr int N2 = 1 << LOG2, TL = N2 / E, RL = last_radix(N2);
  extern __shared__ float2 sm[];
  const int rb = rows_per_block;
  const int f = blockIdx.x / (N1 / rb);
  const int k1_0 = (blockIdx.x - f * (N1 / rb)) * rb;
  const long N = static_cast<long>(N1) * N2;
  const float2* src = scratch + f * N + static_cast<long>(k1_0) * N2;
  float2 z[E];   // E a thread, every load in flight before the first store
#pragma unroll
  for (int q = 0; q < E; ++q) z[q] = src[threadIdx.x + blockDim.x * q];
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const int i = threadIdx.x + blockDim.x * q;
    sm[(i >> LOG2) * padded(N2) + pad(i & (N2 - 1))] = z[q];
  }
  __syncthreads();
  const int rr = threadIdx.x / TL;
  const int t = threadIdx.x - rr * TL;
  float2 v[E];
  fft_passes<N2, 1, false>(sm + rr * padded(N2), t, tw, N1, v);
  const float inv = 1.f / (static_cast<float>(N) * static_cast<float>(N));
  __syncthreads();   // every row's last pass has read it: sm takes the dB
  // row rr's dB at d[rr·(N2 + TL) + k2]: a warp's rows on other banks
  float* d = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int g = 0; g < E / RL; ++g)
#pragma unroll
    for (int r = 0; r < RL; ++r)
      d[rr * (N2 + TL) + out_bin<N2, false>(t, g, r)] =
          power_db(v[g * RL + r], inv, floor_p);
  __syncthreads();
  for (int k2 = threadIdx.x; k2 < N2; k2 += blockDim.x) {
    float* o = out + f * N + k1_0 + static_cast<long>(N1) * k2;
    const float* src = d + k2;
    int q = 0;
    for (; q + 4 <= rb; q += 4)
      *reinterpret_cast<float4*>(o + q) = make_float4(
          src[q * (N2 + TL)], src[(q + 1) * (N2 + TL)],
          src[(q + 2) * (N2 + TL)], src[(q + 3) * (N2 + TL)]);
    if (rb == 2)
      *reinterpret_cast<float2*>(o) =
          make_float2(src[0], src[N2 + TL]);
    else if (rb == 1)
      o[0] = src[0];
  }
}

bool pow2_in(int v, int lo, int hi) {
  return v >= lo && v <= hi && (v & (v - 1)) == 0;
}

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// Frames f < n_frames of ``keep`` samples lie inside the T-sample rows.
bool frames_fit(int es, int T, int keep, int n, int interval, int align,
                int n_frames, int frames_per_row, int row_stride) {
  return keep <= n && align >= 1 && es >= 1 && n_frames >= 1 &&
         frames_per_row >= 1 && n_frames % frames_per_row == 0 &&
         row_stride >= 0 &&
         (static_cast<long>(frames_per_row - 1) * interval + align - 1) /
                     align * align + keep <= T;
}

// Sequences of L points per block: a power of two, at most BLOCK threads.
bool per_block_ok(int per, int L) {
  return pow2_in(per, 1, BLOCK) && per * (L / E) <= BLOCK;
}

size_t seq_smem(int L, int per) { return sizeof(float2) * padded(L) * per; }

template <typename Kernel, typename... Args>
int run(Kernel* kernel, int blocks, int threads, size_t smem,
        cudaStream_t stream, Args... args) {
  const cudaError_t e = sdr::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sdr_fft_frames(const void* xr, const void* xi, int in_bf16,
                              int es, int T, const float* window, int keep,
                              int interval, int align, int n_frames,
                              int frames_per_row, int row_stride, int N,
                              int frames_per_block, const float2* tw,
                              float floor_p, float* out,
                              cudaStream_t stream) {
  if (!pow2_in(N, 256, 4096) || !per_block_ok(frames_per_block, N) ||
      !frames_fit(es, T, keep, N, interval, align, n_frames, frames_per_row,
                  row_stride))
    return cudaErrorInvalidValue;
  const int blocks = (n_frames + frames_per_block - 1) / frames_per_block;
  const int threads = frames_per_block * (N / E);
  const size_t smem = seq_smem(N, frames_per_block);
#define SDR_FRAMES(LG)                                                     \
  case LG:                                                                 \
    return run(fft_frames_kernel<LG>, blocks, threads, smem, stream, xr,  \
               xi, in_bf16, es, window, keep, interval, align, n_frames,  \
               frames_per_row, row_stride, frames_per_block, tw, floor_p, \
               out);
  switch (log2i(N)) {
    SDR_FRAMES(8)
    SDR_FRAMES(9)
    SDR_FRAMES(10)
    SDR_FRAMES(11)
    SDR_FRAMES(12)
  }
#undef SDR_FRAMES
  return cudaErrorInvalidValue;
}

extern "C" int sdr_fft_cols(const void* xr, const void* xi, int in_bf16,
                            int es, int T, const float* window, int keep,
                            int interval, int align, int n_frames,
                            int frames_per_row, int row_stride, int N1,
                            int N2, int cols_per_block, const float2* tw,
                            const float2* tw4, float2* scratch,
                            cudaStream_t stream) {
  if (!pow2_in(N1, 128, 512) || !pow2_in(N2, 64, 512) ||
      !per_block_ok(cols_per_block, N1) || cols_per_block > N2 ||
      !frames_fit(es, T, keep, N1 * N2, interval, align, n_frames,
                  frames_per_row, row_stride))
    return cudaErrorInvalidValue;
  const int blocks = n_frames * (N2 / cols_per_block);
  const int threads = cols_per_block * (N1 / E);
  const size_t smem = seq_smem(N1, cols_per_block);
#define SDR_COLS(LG)                                                        \
  case LG:                                                                  \
    return run(fft_cols_kernel<LG>, blocks, threads, smem, stream, xr, xi, \
               in_bf16, es, window, keep, interval, align, frames_per_row, \
               row_stride, N2, cols_per_block, tw, tw4, scratch);
  switch (log2i(N1)) {
    SDR_COLS(7)
    SDR_COLS(8)
    SDR_COLS(9)
  }
#undef SDR_COLS
  return cudaErrorInvalidValue;
}

extern "C" int sdr_fft_rows(const float2* scratch, int n_frames, int N1,
                            int N2, int rows_per_block, const float2* tw,
                            float floor_p, float* out, cudaStream_t stream) {
  if (!pow2_in(N1, 128, 512) || !pow2_in(N2, 64, 512) || n_frames < 1 ||
      !per_block_ok(rows_per_block, N2) || rows_per_block > N1)
    return cudaErrorInvalidValue;
  const int blocks = n_frames * (N1 / rows_per_block);
  const int threads = rows_per_block * (N2 / E);
  const size_t smem = seq_smem(N2, rows_per_block);
#define SDR_ROWS(LG)                                                        \
  case LG:                                                                  \
    return run(fft_rows_kernel<LG>, blocks, threads, smem, stream, scratch, \
               N1, rows_per_block, tw, floor_p, out);
  switch (log2i(N2)) {
    SDR_ROWS(6)
    SDR_ROWS(7)
    SDR_ROWS(8)
    SDR_ROWS(9)
  }
#undef SDR_ROWS
  return cudaErrorInvalidValue;
}
