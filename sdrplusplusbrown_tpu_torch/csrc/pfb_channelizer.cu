// K5 — polyphase WOLA channelizer, 2×-oversampled or critically sampled.
//
// Replaces: sdrplusplusbrown_tpu/ops/pallas_channelizer.py:_chz3_kernel (the
// V3 phase-planar fold + DFT matmul, sequential grid) in both its forms:
// 2×-oversampled (PallasChannelizerV3; also the first half of
// ops/chan_frontend.py:_chan_fused_kernel_v3) and critically sampled
// (PallasPolyChannelizerV3, critical = True); the V2 and V1 bodies
// (_chz2_kernel, also as PallasPolyChannelizer, and _chz_kernel, the
// PallasChannelizer at pallas_channelizer.py:72) compute the same
// function.
//
// What it computes, with s = [hist (nh = K0 − hop samples) | x (T) | 0…],
// K0 = tpp·M and hop = M/2 (oversampled) or M (critical), for every output
// frame F < width:
//     v_F[p]     = Σ_i br[p, i] · s[F·hop + i·M + p]            (fold)
//     bins[m, F] = σ · Σ_p (cos[m,p] − j·sin[m,p]) · v_F[p]    (M-point DFT)
// with σ = (−1)^m on even frames when ``even_sign`` (the oversampled
// delayed pass's twiddle) and 1 otherwise (odd frames; every frame of the
// critical form); out is [2M, width] (re rows over im rows, float32 or
// bfloat16 storage).  The taps and the DFT matrix come from the host,
// designed in float64 and rounded to float32 (and to the handoff dtype) as
// the JAX package rounds them, so the kernel and its plain version use the
// same numbers.
//
// What bounds it on the H100: the bytes.  The function reads the input and
// writes the bins; its arithmetic, the fold's 2·K0 multiply-adds per frame
// and an M-point DFT counted as an FFT (5·M·log2 M flops), is smaller.
// Scanner128 (oversampled, M = 48, tpp = 6, 0.1 s at 2.4 MS/s): 1.9 MB in,
// 3.9 MB of float32 bins out, ~1.75 µs of HBM time.  Channelizer64
// (critical, M = 64, tpp = 19, 2^21 samples): 16.8 MB in, 8.4 MB of bf16
// bins out, ~7.5 µs.  The earlier design (a direct DFT in FP32 from shared
// memory, 4 loads for 4 FMA; a fold at 3 loads for 2 FMA; every block
// reloading the 2·M² matrix) took ~11× that.  This one:
//   * the DFT runs on the tensor cores as one real product,
//       [re; im] = [[C, S], [−S, C]] · [vr; vi],
//     a [2M, 2M] matrix (padded to 16) times the tile's folded frames,
//     with mma.sync m16n8k16 in bf16 and float32 accumulation.  The frames
//     are split into three bf16 parts (hi + mid + lo = v exactly), the
//     matrix into na parts on the host: one where it is exact in bf16 (the
//     bf16 handoff rounds it so), three for float32 taps; the products
//     a0·b0 + a0·b1 + a0·b2 (+ a1·b0 + a1·b1 + a2·b0) keep float32
//     accuracy, ≥ 100 dB against the float32 plain version.  An FFT would
//     compute the exact DFT, not the product with the handoff-rounded
//     matrix that the reference and the plain version multiply by;
//   * the fold is a sliding FIR in registers: v_F[p] is a tpp-tap FIR along
//     F of branch p's samples (each class of F mod M/hop on its own), so a
//     thread owns a branch and PFB_NF consecutive frames of a class, and
//     each sample loaded serves PFB_NF multiply-adds; the taps come
//     transposed from shared memory (consecutive branches, one word each).
//     Each v_F[p] keeps the earlier ascending-i fmaf order, so the folded
//     frames are bit-identical to the earlier kernel's;
//   * persistent blocks (``pfb_plan``: two an SM where they fit) walk
//     tiles of nt frames; each warp loads its m-tiles of the matrix into
//     registers once; the next tile's input span arrives by cp.async (16
//     bytes a thread) while this one works; the bins leave through a
//     shared tile in 16-byte stores along frames, the (−1)^m sign applied
//     there;
//   * with a one-part matrix (the bf16 handoff) the block is warp
//     specialised (pfb_ws_kernel): four warps fold tile i + 1 into one of
//     two frame buffers while the other four run tile i's products (two
//     m-tiles a warp, so each frame fragment loaded serves both) and
//     store its bins, handing buffers over on named barriers.  The FP32
//     fold and the tensor-core DFT then overlap in part instead of taking
//     turns, as pfb_kernel still does for a three-part matrix (96
//     fragment registers a warp leave no room for two m-tiles).  In both
//     kernels, where no span fits shared memory (thousands of taps a
//     branch), nbuf is 0 and the fold reads the spans in place from
//     ``ext``, the stream s laid out whole in device memory by the
//     wrapper.
// What bounds it now (scripts/chz_mix_sweep.py --parts and --phases; PERF.md
// has the numbers): neither pipe.  At channelizer64 a folder warp issues
// at ~0.2 instructions a cycle and a product warp one mma.sync every ~30
// cycles, i.e. each waits out its own latencies: two blocks an SM (128
// registers a thread) are too few warps to hide them, and the fold and
// the products, each ~6 µs of the ~25, still add up more than they
// overlap.
// Above M = 64 (AM's M = 160, SSB's 100, CW's 800 at 2.4 MS/s, and the
// critical form at M = 128) the [2M, 2M] matrix fits neither the fragment
// registers nor shared memory: pfb_big_kernel keeps the fold and reads the
// matrix's k-steps from L2, an m-tile at a time (see there).  It is the
// counterpart of _chz_kernel (PallasChannelizer), which the JAX package
// runs where its V3 and V2 bodies refuse 2M > 128.
// ``fold_out``, when not null, also receives the folded frames v_F (float32
// [2M, width], unsigned), for tests that hold them bit for bit.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int PFB_THREADS = 256;  // 8 warps
constexpr int PFB_HALF = 128;     // one group of a warp-specialised block
constexpr int PFB_NF = 8;         // frames a thread folds (one class)
constexpr int PFB_KC = 8;         // k-steps a chunk of pfb_big_kernel

// One block's shared memory in floats (``pfb_plan`` sizes it the same):
// the transposed taps, nbuf input spans, nbs frame buffers (three bf16
// parts each), the output tile.
struct PfbLayout {
  int K16;    // 16-wide k-steps (and m-tiles) of the padded matrix
  int KP;     // 16·K16
  int SC;     // one plane of one input span: (nt − 1)·hop + K0, + slack
  int BSW;    // words of one frame's row of one bf16 part: KP/2 + 4
  int OS;     // output tile row: nt + 8 floats
  int span, bs, os, total;  // os: the output tile (none in pfb_big_kernel)
};

__host__ __device__ inline PfbLayout pfb_layout(int M, int tpp, int h,
                                                int nt, int nbuf, int nbs,
                                                int out_tile = 1) {
  PfbLayout l;
  l.K16 = (2 * M + 15) / 16;
  l.KP = 16 * l.K16;
  l.SC = (((nt - 1) * h + tpp * M + M + 3) & ~3) + 4;  // + M: the fold's
                                                        // last whole chunk
  l.BSW = l.KP / 2 + 4;
  l.OS = nt + 8;
  l.span = (tpp * M + 3) & ~3;       // after the transposed taps
  l.bs = l.span + nbuf * 2 * l.SC;
  l.os = l.bs + nbs * 3 * nt * l.BSW;
  l.total = l.os + out_tile * l.KP * l.OS;
  return l;
}

// Offset of a span in its buffer, so that 16-byte-aligned x sits at
// 16-byte-aligned shared addresses.
__device__ __forceinline__ int span_off(long n0, int nh) {
  return static_cast<int>(((n0 - nh) % 4 + 4) % 4);
}

struct PfbArgs {
  const float* xr;
  const float* xi;
  const float* hr;
  const float* hi;
  const float* ext_r;   // nbuf 0: s whole, re and im
  const float* ext_i;
  int T, nh, M, tpp, h, nt;
};

// s[n0 .. n0 + span) of both planes into dr/di (dr[t] = s[n0 + t]), by
// threads t, t + nthr, ...
__device__ __forceinline__ void stage_span(const PfbArgs& g, long n0, int span,
                                           float* dr, float* di, int t0,
                                           int nthr) {
  const long i0 = n0 - g.nh;  // x index of dr[0]
  long a0 = (max(i0, 0L) + 3) & ~3L;
  long a1 = min(i0 + span, static_cast<long>(g.T)) & ~3L;
  if (a1 <= a0 || ((reinterpret_cast<uintptr_t>(g.xr) |
                    reinterpret_cast<uintptr_t>(g.xi)) & 15))
    a0 = a1 = i0 + span;
  auto one = [&](int t) {
    const long n = n0 + t;
    float a = 0.f, b = 0.f;
    if (n < g.nh) {
      a = g.hr[n];
      b = g.hi[n];
    } else if (n - g.nh < g.T) {
      a = g.xr[n - g.nh];
      b = g.xi[n - g.nh];
    }
    dr[t] = a;
    di[t] = b;
  };
  for (int t = t0; t < a0 - i0; t += nthr) one(t);
  for (int t = static_cast<int>(a1 - i0) + t0; t < span; t += nthr) one(t);
  const int nv = static_cast<int>((a1 - a0) >> 2);
  const int d0 = static_cast<int>(a0 - i0);
  for (int u = t0; u < nv; u += nthr) {
    sdr::cp_async16(dr + d0 + 4 * u, g.xr + a0 + 4 * u);
    sdr::cp_async16(di + d0 + 4 * u, g.xi + a0 + 4 * u);
  }
}

__device__ __forceinline__ void put_parts(__nv_bfloat16* bs, int part_stride,
                                          float v) {
  // v = b0 + b1 + b2 exactly: each residual is exact in float32 and the
  // last fits bf16's 8 bits
  const __nv_bfloat16 b0 = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(b0);
  const __nv_bfloat16 b1 = __float2bfloat16_rn(r1);
  const __nv_bfloat16 b2 = __float2bfloat16_rn(r1 - __bfloat162float(b1));
  bs[0] = b0;
  bs[part_stride] = b1;
  bs[2 * part_stride] = b2;
}

// The fold of the tile at frame F0 into the frame buffer ``bh`` (three bf16
// parts, [nt, BSW words] each, rows k = p (vr) and M + p (vi)), by threads
// t0, t0 + nthr, ...: branch p, class c, PFB_NF consecutive frames of it.
__device__ __forceinline__ void fold_tile(const PfbArgs& g, const float* sr,
                                          const float* si, const float* brT,
                                          __nv_bfloat16* bh, int BSW,
                                          int part, int F0, int width,
                                          float* fold_out, int t0, int nthr) {
  const int M = g.M, h = g.h, tpp = g.tpp, Rt = M / h;
  const int runs = g.nt / Rt / PFB_NF;
  for (int item = t0; item < M * Rt * runs; item += nthr) {
    const int p = item % M, rest = item / M;
    const int c = rest % Rt, Gl = (rest / Rt) * PFB_NF;
    const int base = Gl * M + c * h + p;
    float wr[PFB_NF], wi[PFB_NF], vr[PFB_NF], vi[PFB_NF];
#pragma unroll
    for (int f = 0; f < PFB_NF; ++f) {
      wr[f] = sr[base + f * M];
      wi[f] = si[base + f * M];
      vr[f] = vi[f] = 0.f;
    }
    // slot x holds sample n of the run with n % PFB_NF == x; at tap i
    // frame f takes n = f + i.  Whole chunks of PFB_NF taps run without a
    // branch, so their loads issue ahead of the multiply-adds (a sample
    // loaded past the last one used lands in the span's slack).
    int i0 = 0;
    for (; i0 + PFB_NF <= tpp; i0 += PFB_NF) {
      float tap[PFB_NF];
#pragma unroll
      for (int ii = 0; ii < PFB_NF; ++ii) tap[ii] = brT[(i0 + ii) * M + p];
#pragma unroll
      for (int ii = 0; ii < PFB_NF; ++ii) {
#pragma unroll
        for (int f = 0; f < PFB_NF; ++f) {
          vr[f] = fmaf(tap[ii], wr[(f + ii) % PFB_NF], vr[f]);
          vi[f] = fmaf(tap[ii], wi[(f + ii) % PFB_NF], vi[f]);
        }
        wr[ii] = sr[base + (i0 + ii + PFB_NF) * M];
        wi[ii] = si[base + (i0 + ii + PFB_NF) * M];
      }
    }
#pragma unroll
    for (int ii = 0; ii < PFB_NF; ++ii) {
      if (i0 + ii >= tpp) break;
      const float tap = brT[(i0 + ii) * M + p];
#pragma unroll
      for (int f = 0; f < PFB_NF; ++f) {
        vr[f] = fmaf(tap, wr[(f + ii) % PFB_NF], vr[f]);
        vi[f] = fmaf(tap, wi[(f + ii) % PFB_NF], vi[f]);
      }
      if (i0 + ii + 1 < tpp) {
        wr[ii] = sr[base + (i0 + ii + PFB_NF) * M];
        wi[ii] = si[base + (i0 + ii + PFB_NF) * M];
      }
    }
#pragma unroll
    for (int f = 0; f < PFB_NF; ++f) {
      const int fl = Rt * (Gl + f) + c;
      __nv_bfloat16* row = bh + fl * 2 * BSW;
      put_parts(row + p, 2 * part, vr[f]);
      put_parts(row + M + p, 2 * part, vi[f]);
      if (fold_out && F0 + fl < width) {
        fold_out[static_cast<long>(p) * width + F0 + fl] = vr[f];
        fold_out[static_cast<long>(M + p) * width + F0 + fl] = vi[f];
      }
    }
  }
}

// fold_tile on the tile at frame F0, its span in shared memory (the buffer
// at ``spans``) or, with nbuf 0, in place in ext.  Two calls, so that the
// staged route's loads stay shared-memory loads (one pointer for both
// would be generic, ~7 % slower at channelizer64).
__device__ __forceinline__ void fold_at(const PfbArgs& g, const float* spans,
                                        int SC, int nbuf, const float* brT,
                                        __nv_bfloat16* bh, int BSW, int part,
                                        int F0, int width, float* fold_out,
                                        int t0, int nthr) {
  const long n0 = static_cast<long>(F0) * g.h;
  if (nbuf) {
    const float* sr = spans + span_off(n0, g.nh);
    fold_tile(g, sr, sr + SC, brT, bh, BSW, part, F0, width, fold_out, t0,
              nthr);
  } else {
    fold_tile(g, g.ext_r + n0, g.ext_i + n0, brT, bh, BSW, part, F0, width,
              fold_out, t0, nthr);
  }
}

// Matrix part a's m-tile mt, every k-step, as mma.sync A fragments.
__device__ __forceinline__ void load_a(unsigned (&A)[8][4],
                                       const unsigned* __restrict__ ap,
                                       int a, int KP, int K16, int mt,
                                       int lane) {
  const int KW = KP / 2;
  const unsigned* w = ap + (static_cast<long>(a) * KP + mt * 16 + (lane >> 2)) *
                               KW + (lane & 3);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    if (ks < K16) {
      A[ks][0] = w[ks * 8];
      A[ks][1] = w[8 * KW + ks * 8];
      A[ks][2] = w[ks * 8 + 4];
      A[ks][3] = w[8 * KW + ks * 8 + 4];
    }
  }
}

// Two values rounded to bf16, the first in the lower half.
__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
             << 16;
}

// The tile's bins from the output tile Os to out [2M, width]: PER frames
// (16 bytes: 8 bf16 or 4 float32) a thread, threads t0, t0 + nthr, ...,
// the (−1)^m sign of the oversampled form's even frames applied on the way.
template <int PER>
__device__ __forceinline__ void store_tile(const float* Os, int OS, int M,
                                           int nt, int F0, int width,
                                           int even_sign, void* out, int t0,
                                           int nthr) {
  const int q_row = nt / PER;  // a power of two
  const int qs = __ffs(q_row) - 1;
  const bool vec = !(width & (PER - 1));
  for (int idx = t0; idx < 2 * M * q_row; idx += nthr) {
    const int r = idx >> qs, q = idx & (q_row - 1);
    const int F = F0 + q * PER;
    if (F >= width) continue;
    float v[PER];
    const float4* o = reinterpret_cast<const float4*>(Os + r * OS + q * PER);
#pragma unroll
    for (int e = 0; e < PER / 4; ++e) {
      const float4 t = o[e];
      v[4 * e] = t.x, v[4 * e + 1] = t.y, v[4 * e + 2] = t.z,
      v[4 * e + 3] = t.w;
    }
    if (even_sign && ((r < M ? r : r - M) & 1)) {
#pragma unroll
      for (int e = 0; e < PER; e += 2) v[e] = -v[e];  // F0 is even
    }
    const long at = static_cast<long>(r) * width + F;
    if (vec && F + PER <= width) {
      if constexpr (PER == 8) {
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + at) =
            make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                       bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + at) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e)
        if (F + e < width) sdr::st(out, at + e, v[e], PER == 8);
    }
  }
}

__device__ __forceinline__ void store_bins(int out_bf16, const float* Os,
                                           int OS, int M, int nt, int F0,
                                           int width, int even_sign,
                                           void* out, int t0, int nthr) {
  if (out_bf16)
    store_tile<8>(Os, OS, M, nt, F0, width, even_sign, out, t0, nthr);
  else
    store_tile<4>(Os, OS, M, nt, F0, width, even_sign, out, t0, nthr);
}

// Named barriers of the warp-specialised block (0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Every warp in every phase, in turns: a three-part matrix (96 fragment
// registers a warp, one m-tile each).
__global__ void __launch_bounds__(PFB_THREADS) pfb_kernel(
    PfbArgs g, const float* __restrict__ br, const unsigned* __restrict__ ap,
    int even_sign, void* __restrict__ out, int out_bf16, int width, int nbuf,
    float* __restrict__ fold_out) {
  extern __shared__ __align__(16) float smem[];
  const int M = g.M, tpp = g.tpp, h = g.h, nt = g.nt;
  const PfbLayout L = pfb_layout(M, tpp, h, nt, nbuf, 1);
  float* brT = smem;
  float* spans = smem + L.span;
  unsigned* Bs = reinterpret_cast<unsigned*>(smem + L.bs);
  float* Os = smem + L.os;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = (nt - 1) * h + tpp * M;
  const int ntiles = (width + nt - 1) / nt;
  const int part = nt * L.BSW;  // words of one bf16 part

  // the first tile's span is on its way while the block loads its taps
  // and its matrix fragments
  int tile = blockIdx.x;
  if (tile < ntiles && nbuf > 0) {
    const long n0 = static_cast<long>(tile) * nt * h;
    float* d = spans + span_off(n0, g.nh);
    stage_span(g, n0, span, d, d + L.SC, tid, PFB_THREADS);
  }
  sdr::cp_async_commit();
  for (int i = tid; i < tpp * M; i += PFB_THREADS) {
    const int p = i / tpp;
    brT[(i - p * tpp) * M + p] = br[i];
  }
  for (int i = tid; i < 3 * part; i += PFB_THREADS) Bs[i] = 0u;

  // ---- this warp's m-tile of the matrix, every k-step, in registers -----
  const int K16 = L.K16;
  const int wpm = max(1, 8 / K16);  // warps on one m-tile
  const int mt = warp / wpm, ng = warp - mt * wpm;
  const int ntn = nt / 8;
  const int per = (ntn + wpm - 1) / wpm;
  const int j0 = ng * per, j1 = min(ntn, j0 + per);
  const bool mma_on = mt < K16 && j0 < j1;
  const int gq = lane >> 2, tq = lane & 3;
  unsigned A[3][8][4];
  if (mma_on) {
#pragma unroll
    for (int a = 0; a < 3; ++a) load_a(A[a], ap, a, L.KP, K16, mt, lane);
  }

  for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    const int b = nbuf > 1 ? (it & 1) : 0;
    const int next = tile + gridDim.x;
    if (nbuf == 2) {
      if (next < ntiles) {
        const long n1 = static_cast<long>(next) * nt * h;
        float* d = spans + (b ^ 1) * 2 * L.SC + span_off(n1, g.nh);
        stage_span(g, n1, span, d, d + L.SC, tid, PFB_THREADS);
      }
      sdr::cp_async_commit();
      sdr::cp_async_wait<1>();
    } else {
      sdr::cp_async_wait<0>();
    }
    __syncthreads();

    const int F0 = tile * nt;
    fold_at(g, spans + b * 2 * L.SC, L.SC, nbuf, brT,
            reinterpret_cast<__nv_bfloat16*>(Bs), L.BSW, part, F0, width,
            fold_out, tid, PFB_THREADS);
    __syncthreads();
    if (nbuf == 1 && next < ntiles) {
      // the span is folded: the next one may land in its place
      const long n1 = static_cast<long>(next) * nt * h;
      float* d = spans + span_off(n1, g.nh);
      stage_span(g, n1, span, d, d + L.SC, tid, PFB_THREADS);
      sdr::cp_async_commit();
    }

    // ---- the DFT on the tensor cores: the warp's m-tile, its n-tiles ----
    if (mma_on) {
      float d[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[jj][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        if (ks >= K16) break;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (j0 + jj >= j1) break;
          const unsigned* w = Bs + ((j0 + jj) * 8 + gq) * L.BSW + ks * 8 + tq;
          const unsigned b00 = w[0], b01 = w[4];
          const unsigned b10 = w[part], b11 = w[part + 4];
          const unsigned b20 = w[2 * part], b21 = w[2 * part + 4];
          // the small products first (ops/channelizer_kernel.py:MMA_PASSES)
          sdr::mma_bf16_16816(d[jj], A[2][ks], b00, b01);
          sdr::mma_bf16_16816(d[jj], A[1][ks], b10, b11);
          sdr::mma_bf16_16816(d[jj], A[0][ks], b20, b21);
          sdr::mma_bf16_16816(d[jj], A[1][ks], b00, b01);
          sdr::mma_bf16_16816(d[jj], A[0][ks], b10, b11);
          sdr::mma_bf16_16816(d[jj], A[0][ks], b00, b01);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (j0 + jj >= j1) break;
        float* o = Os + (mt * 16 + gq) * L.OS + (j0 + jj) * 8 + 2 * tq;
        *reinterpret_cast<float2*>(o) = make_float2(d[jj][0], d[jj][1]);
        *reinterpret_cast<float2*>(o + 8 * L.OS) =
            make_float2(d[jj][2], d[jj][3]);
      }
    }
    __syncthreads();
    store_bins(out_bf16, Os, L.OS, M, nt, F0, width, even_sign, out, tid,
               PFB_THREADS);
  }
}

// Warp-specialised, a one-part matrix: warps 0-3 (F) fold tile i into frame
// buffer i % 2 and stage the next span (into the other of two span
// buffers before folding, or into the one buffer after; with nbuf 0 they
// read it in place and stage nothing); warps 4-7 (W)
// hold m-tiles w and w + 4 of the matrix, multiply tile i and store its
// bins.  Barriers: 1 + b
// buffer b full (F arrive, W wait), 3 + b buffer b free (W arrive, F wait;
// only where F will fold into it again), 5 within F, 6 within W.
__global__ void __launch_bounds__(PFB_THREADS) pfb_ws_kernel(
    PfbArgs g, const float* __restrict__ br, const unsigned* __restrict__ ap,
    int even_sign, void* __restrict__ out, int out_bf16, int width, int nbuf,
    float* __restrict__ fold_out) {
  extern __shared__ __align__(16) float smem[];
  const int M = g.M, tpp = g.tpp, h = g.h, nt = g.nt;
  const PfbLayout L = pfb_layout(M, tpp, h, nt, nbuf, 2);
  float* brT = smem;
  float* spans = smem + L.span;
  unsigned* Bs = reinterpret_cast<unsigned*>(smem + L.bs);
  float* Os = smem + L.os;
  const int tid = threadIdx.x, lane = tid & 31;
  const int span = (nt - 1) * h + tpp * M;
  const int ntiles = (width + nt - 1) / nt;
  const int part = nt * L.BSW;
  const int grid = gridDim.x;
  const bool folder = tid < PFB_HALF;

  if (folder && nbuf > 0 && static_cast<int>(blockIdx.x) < ntiles) {
    const long n0 = static_cast<long>(blockIdx.x) * nt * h;
    float* d = spans + span_off(n0, g.nh);
    stage_span(g, n0, span, d, d + L.SC, tid, PFB_HALF);
  }
  sdr::cp_async_commit();
  for (int i = tid; i < tpp * M; i += PFB_THREADS) {
    const int p = i / tpp;
    brT[(i - p * tpp) * M + p] = br[i];
  }
  for (int i = tid; i < 2 * 3 * part; i += PFB_THREADS) Bs[i] = 0u;
  __syncthreads();

  if (folder) {
    for (int i = 0, tile = blockIdx.x; tile < ntiles; tile += grid, ++i) {
      const int b = i & 1, sb = nbuf > 1 ? b : 0;
      const int next = tile + grid;
      auto stage_next = [&](int buf) {
        if (next < ntiles) {
          const long n1 = static_cast<long>(next) * nt * h;
          float* d = spans + buf * 2 * L.SC + span_off(n1, g.nh);
          stage_span(g, n1, span, d, d + L.SC, tid, PFB_HALF);
        }
        sdr::cp_async_commit();
      };
      if (nbuf > 1) {
        // the next span goes to the buffer tile i - 1 was folded from
        bar_sync(5, PFB_HALF);
        stage_next(b ^ 1);
        sdr::cp_async_wait<1>();
      } else {
        sdr::cp_async_wait<0>();
      }
      bar_sync(5, PFB_HALF);  // tile i's span has landed
      if (i >= 2) bar_sync(3 + b, PFB_THREADS);
      fold_at(g, spans + sb * 2 * L.SC, L.SC, nbuf, brT,
              reinterpret_cast<__nv_bfloat16*>(Bs + b * 3 * part), L.BSW,
              part, tile * nt, width, fold_out, tid, PFB_HALF);
      bar_arrive(1 + b, PFB_THREADS);
      if (nbuf == 1) {
        bar_sync(5, PFB_HALF);  // every folder is done with the span
        stage_next(0);
      }
    }
    return;
  }

  // ---- W: m-tiles w and w + 4, every n-tile of the tile ------------------
  const int w = (tid - PFB_HALF) >> 5;
  const int K16 = L.K16, ntn = nt / 8;
  const bool on0 = w < K16, on1 = w + 4 < K16;
  const int gq = lane >> 2, tq = lane & 3;
  unsigned A[2][8][4];
  if (on0) load_a(A[0], ap, 0, L.KP, K16, w, lane);
  // a warp without a second m-tile multiplies zeros there: no branch
  // between the products (each would cost a WARPSYNC before every one)
  if (on1) {
    load_a(A[1], ap, 0, L.KP, K16, w + 4, lane);
  } else {
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) A[1][ks][e] = 0u;
  }
  for (int i = 0, tile = blockIdx.x; tile < ntiles; tile += grid, ++i) {
    const int b = i & 1;
    bar_sync(1 + b, PFB_THREADS);
    float d[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[m][jj][e] = 0.f;
    if (on0) {
      const unsigned* Bb = Bs + b * 3 * part;
      __syncwarp();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        if (ks >= K16) break;
        // two n-tiles at a time: consecutive products go to four
        // accumulators; the small products first
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          if (2 * jp >= ntn) break;
          unsigned bq[2][3][2];
#pragma unroll
          for (int j2 = 0; j2 < 2; ++j2) {
            const unsigned* q =
                Bb + ((2 * jp + j2) * 8 + gq) * L.BSW + ks * 8 + tq;
#pragma unroll
            for (int pt = 0; pt < 3; ++pt) {
              bq[j2][pt][0] = q[pt * part];
              bq[j2][pt][1] = q[pt * part + 4];
            }
          }
#pragma unroll
          for (int pt = 2; pt >= 0; --pt)
#pragma unroll
            for (int j2 = 0; j2 < 2; ++j2) {
              sdr::mma_bf16_16816(d[0][2 * jp + j2], A[0][ks], bq[j2][pt][0],
                                  bq[j2][pt][1]);
              sdr::mma_bf16_16816(d[1][2 * jp + j2], A[1][ks], bq[j2][pt][0],
                                  bq[j2][pt][1]);
            }
        }
      }
    }
    if (tile + 2 * grid < ntiles) bar_arrive(3 + b, PFB_THREADS);
    bar_sync(6, PFB_HALF);  // the last tile's bins have left Os
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (!(m ? on1 : on0)) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj >= ntn) break;
        float* o = Os + ((w + 4 * m) * 16 + gq) * L.OS + jj * 8 + 2 * tq;
        *reinterpret_cast<float2*>(o) = make_float2(d[m][jj][0], d[m][jj][1]);
        *reinterpret_cast<float2*>(o + 8 * L.OS) =
            make_float2(d[m][jj][2], d[m][jj][3]);
      }
    }
    bar_sync(6, PFB_HALF);
    store_bins(out_bf16, Os, L.OS, M, nt, tile * nt, width, even_sign, out,
               tid - PFB_HALF, PFB_HALF);
  }
}

// Large M (2M > 128, up to thousands of rows): the matrix fits neither the
// registers nor shared memory (M = 160 in three bf16 parts: 614 KB), so it
// is tiled over m and over k and read from L2 (NA·KP·KP bf16, shared by
// every block).  Each block folds its tile as pfb_kernel does, into one
// frame buffer (three bf16 parts); warp w then takes m-tiles
// blockIdx.y·8 + w, + 8·gridDim.y, ...: for each, the A fragments of the
// NA parts come from the matrix in global memory PFB_KC k-steps at a
// time, the B fragments from the frame buffer, the products in
// MMA_PASSES' order (as in the register-resident kernels), and the
// accumulators go straight to ``out`` (the (−1)^m sign on even frames
// applied there).  gridDim.y
// splits the m-tiles of one frame tile over blocks, each folding the tile
// again, so that a short call still fills the SMs.  No output tile: the
// frame buffer and the spans have the shared memory to themselves.
template <int NA>
__global__ void __launch_bounds__(PFB_THREADS) pfb_big_kernel(
    PfbArgs g, const float* __restrict__ br, const unsigned* __restrict__ ap,
    int even_sign, void* __restrict__ out, int out_bf16, int width, int nbuf,
    float* __restrict__ fold_out) {
  extern __shared__ __align__(16) float smem[];
  const int M = g.M, tpp = g.tpp, h = g.h, nt = g.nt;
  const PfbLayout L = pfb_layout(M, tpp, h, nt, nbuf, 1, 0);
  float* brT = smem;
  float* spans = smem + L.span;
  unsigned* Bs = reinterpret_cast<unsigned*>(smem + L.bs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = (nt - 1) * h + tpp * M;
  const int ntiles = (width + nt - 1) / nt;
  const int part = nt * L.BSW;
  const int K16 = L.K16, KW = L.KP / 2, ntn = nt / 8;
  const int gq = lane >> 2, tq = lane & 3;
  const long a_part = static_cast<long>(L.KP) * KW;  // words of one part

  int tile = blockIdx.x;
  if (tile < ntiles && nbuf > 0) {
    const long n0 = static_cast<long>(tile) * nt * h;
    float* d = spans + span_off(n0, g.nh);
    stage_span(g, n0, span, d, d + L.SC, tid, PFB_THREADS);
  }
  sdr::cp_async_commit();
  for (int i = tid; i < tpp * M; i += PFB_THREADS) {
    const int p = i / tpp;
    brT[(i - p * tpp) * M + p] = br[i];
  }
  for (int i = tid; i < 3 * part; i += PFB_THREADS) Bs[i] = 0u;

  for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    const int b = nbuf > 1 ? (it & 1) : 0;
    const int next = tile + gridDim.x;
    if (nbuf == 2) {
      if (next < ntiles) {
        const long n1 = static_cast<long>(next) * nt * h;
        float* d = spans + (b ^ 1) * 2 * L.SC + span_off(n1, g.nh);
        stage_span(g, n1, span, d, d + L.SC, tid, PFB_THREADS);
      }
      sdr::cp_async_commit();
      sdr::cp_async_wait<1>();
    } else {
      sdr::cp_async_wait<0>();
    }
    __syncthreads();

    const int F0 = tile * nt;
    fold_at(g, spans + b * 2 * L.SC, L.SC, nbuf, brT,
            reinterpret_cast<__nv_bfloat16*>(Bs), L.BSW, part, F0, width,
            fold_out, tid, PFB_THREADS);
    __syncthreads();
    if (nbuf == 1 && next < ntiles) {
      const long n1 = static_cast<long>(next) * nt * h;
      float* d = spans + span_off(n1, g.nh);
      stage_span(g, n1, span, d, d + L.SC, tid, PFB_THREADS);
      sdr::cp_async_commit();
    }

    for (int mt = blockIdx.y * 8 + warp; mt < K16; mt += 8 * gridDim.y) {
      float d[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[jj][e] = 0.f;
      const unsigned* arow =
          ap + static_cast<long>(mt * 16 + gq) * KW + tq;
      // PFB_KC k-steps' A fragments at a time, their L2 loads issued
      // together: one L2 latency a chunk, not one a k-step
      for (int k0 = 0; k0 < K16; k0 += PFB_KC) {
        unsigned A[PFB_KC][NA][4];
#pragma unroll
        for (int c = 0; c < PFB_KC; ++c) {
          if (k0 + c < K16) {
#pragma unroll
            for (int a = 0; a < NA; ++a) {
              const unsigned* w = arow + a * a_part + (k0 + c) * 8;
              A[c][a][0] = __ldg(w);
              A[c][a][1] = __ldg(w + 8 * KW);
              A[c][a][2] = __ldg(w + 4);
              A[c][a][3] = __ldg(w + 8 * KW + 4);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < PFB_KC; ++c) {
          if (k0 + c >= K16) break;
          const int ks = k0 + c;
          // the frame parts of every n-tile, [n-tile][part][2]
          unsigned bq[4][3][2];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (jj >= ntn) break;
            const unsigned* w = Bs + (jj * 8 + gq) * L.BSW + ks * 8 + tq;
#pragma unroll
            for (int pt = 0; pt < 3; ++pt) {
              bq[jj][pt][0] = w[pt * part];
              bq[jj][pt][1] = w[pt * part + 4];
            }
          }
          // the small products first (ops/channelizer_kernel.py:
          // MMA_PASSES), each pass over every n-tile (independent
          // accumulators back to back), into accumulators of this k-step
          // alone, then added to the sums in float32: hundreds of k-steps
          // chained in one tensor-core accumulator lose bits at each
          // (M = 800: 99.5 dB against the float32 plain version)
          constexpr int NP = NA == 3 ? 6 : 3;
          constexpr int PA[6] = {NA == 3 ? 2 : 0, NA == 3 ? 1 : 0, 0, 1, 0,
                                 0};
          constexpr int PB[6] = {0, 1, 2, 0, 1, 0};
          constexpr int PB1[3] = {2, 1, 0};
          float e[4][4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int q = 0; q < 4; ++q) e[jj][q] = 0.f;
#pragma unroll
          for (int ps = 0; ps < NP; ++ps) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              if (jj >= ntn) break;
              const int pb = NA == 3 ? PB[ps] : PB1[ps];
              sdr::mma_bf16_16816(e[jj], A[c][NA == 3 ? PA[ps] : 0],
                                  bq[jj][pb][0], bq[jj][pb][1]);
            }
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int q = 0; q < 4; ++q) d[jj][q] += e[jj][q];
        }
      }
      // rows mt·16 + gq (+ 8), frames F0 + 8·jj + 2·tq (+ 1): the first
      // of each pair is an even frame (F0 is even)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj >= ntn) break;
        const int F = F0 + jj * 8 + 2 * tq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = mt * 16 + gq + 8 * hf;
          if (r >= 2 * M) continue;
          float v0 = d[jj][2 * hf];
          const float v1 = d[jj][2 * hf + 1];
          if (even_sign && ((r < M ? r : r - M) & 1)) v0 = -v0;
          const long at = static_cast<long>(r) * width + F;
          if (F < width) sdr::st(out, at, v0, out_bf16);
          if (F + 1 < width) sdr::st(out, at + 1, v1, out_bf16);
        }
      }
    }
  }
}

}  // namespace

// br [M, tpp] float32; ap [na, KP, KP] bf16 (KP = 2M padded to 16) as the
// host splits the DFT matrix; out [2M, width] float32 or bf16; fold_out
// null or [2M, width] float32.  kind (0: pfb_kernel, which takes na 3 and
// M <= 64; 1: the warp-specialised pfb_ws_kernel, which takes na 1 and
// M <= 64; 2: pfb_big_kernel, either na, any even M), nt (16 or 32 frames
// a tile), nbuf (0, 1 or 2 input spans in shared memory; with 0, ext_r/
// ext_i hold s whole through the last tile's span, else they are null),
// grid (persistent blocks along the frames) and mgroups (kind 2: blocks
// sharing one frame tile's m-tiles; else 1) come from
// ops/channelizer_kernel.py:pfb_plan.
extern "C" int sdr_pfb_bins(const float* xr, const float* xi, int T,
                            const float* hr, const float* hi, int nh,
                            const float* br, const void* ap, int na, int M,
                            int tpp, int hop, int even_sign, void* out,
                            int out_bf16, int width, int kind, int nt,
                            int nbuf, int grid, int mgroups,
                            const float* ext_r, const float* ext_i,
                            float* fold_out, cudaStream_t stream) {
  if (M < 2 || M % 2 || (kind != 2 && M > 64) || tpp < 2 || width < 1 ||
      (hop != M / 2 && hop != M) || nh != tpp * M - hop ||
      (na != 1 && na != 3) || (nt != 16 && nt != 32) || nbuf < 0 ||
      nbuf > 2 || grid < 1 || (nbuf == 0 && (!ext_r || !ext_i)) ||
      kind < 0 || kind > 2 || (kind < 2 && (kind != 0) != (na == 1)) ||
      mgroups < 1 || (kind < 2 && mgroups != 1) ||
      mgroups > (2 * M + 127) / 128)
    return cudaErrorInvalidValue;
  const size_t smem = pfb_layout(M, tpp, hop, nt, nbuf, kind == 1 ? 2 : 1,
                                 kind == 2 ? 0 : 1).total * sizeof(float);
  const PfbArgs g{xr, xi, hr, hi, ext_r, ext_i, T, nh, M, tpp, hop, nt};
  const unsigned* a = static_cast<const unsigned*>(ap);
  cudaError_t e;
  if (kind == 2) {
    auto* k = na == 3 ? pfb_big_kernel<3> : pfb_big_kernel<1>;
    e = sdr::allow_smem(k, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    k<<<dim3(grid, mgroups), PFB_THREADS, smem, stream>>>(
        g, br, a, even_sign, out, out_bf16, width, nbuf, fold_out);
  } else if (kind == 1) {
    e = sdr::allow_smem(pfb_ws_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    pfb_ws_kernel<<<grid, PFB_THREADS, smem, stream>>>(
        g, br, a, even_sign, out, out_bf16, width, nbuf, fold_out);
  } else {
    e = sdr::allow_smem(pfb_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    pfb_kernel<<<grid, PFB_THREADS, smem, stream>>>(
        g, br, a, even_sign, out, out_bf16, width, nbuf, fold_out);
  }
  return static_cast<int>(cudaGetLastError());
}
