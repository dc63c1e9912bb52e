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
// registers nor shared memory: pfb_big_kernel (see there) computes the
// rows a caller lists (a bank's gathered bins) at the valid frames only,
// the rows' k-slices staged by bulk copy, the products on wgmma from 128
// rows, else on mma.sync.
// ``fold_out``, when not null, also receives the folded frames v_F (float32
// [2M, width], unsigned), for tests that hold them bit for bit.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int PFB_THREADS = 256;  // 8 warps
constexpr int PFB_HALF = 128;     // one group of a warp-specialised block
constexpr int PFB_NF = 8;         // frames a thread folds (one class)

// One block's shared memory in floats (``pfb_plan`` sizes it the same):
// the transposed taps, nbuf input spans, nbs frame buffers (three bf16
// parts each), the output tile.
struct PfbLayout {
  int K16;    // 16-wide k-steps (and m-tiles) of the padded matrix
  int KP;     // 16·K16
  int SC;     // one plane of one input span: (nt − 1)·hop + K0, + slack
  int BSW;    // words of one frame's row of one bf16 part: KP/2 + 4
  int OS;     // output tile row: nt + 8 floats
  int span, bs, os, total;  // os: the output tile
};

__host__ __device__ inline PfbLayout pfb_layout(int M, int tpp, int h,
                                                int nt, int nbuf, int nbs) {
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
  l.total = l.os + l.KP * l.OS;
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

// ---- above M = 64: pfb_big_kernel -------------------------------------------
// Large M (AM's M = 160, SSB's 100 and CW's 800 at 2.4 MS/s; the critical
// form at 128): the [2M, 2M] matrix fits neither the fragment registers
// nor shared memory, and a channelized bank reads only the bins its
// channels gather.  So this kernel takes a row list ``rows`` [R] (R <= 2M,
// rows of the [re; im] plane) and writes out[r, F] = row rows[r] of the
// plane at frame F, for the frame tiles that hold the call's valid frames
// only.  A block takes one tile of ``nt`` frames (blockIdx.x) and ``rbp``
// entries of the list (blockIdx.y), and walks k (the matrix's columns,
// the folded frames' rows: vr[p] at k = p, vi[p] at k = M + p) in chunks
// of ``kc``:
//   * its input span s[F0·h, F0·h + (nt − 1)·h + K0) comes into shared
//     memory once where it fits (``staged``): the 16-byte-aligned part of x
//     by cp.async.bulk, the history, x's ragged ends and the zeros past x by
//     the threads; else the fold reads [hist | x | 0] by index;
//   * each chunk's slices of the block's rows come by cp.async.bulk into a
//     ring of slots, completing on the slot's mbarrier (complete_tx):
//     where the ring holds every chunk (the banks' 32 rows), chunk 0 from
//     warp 0 at the start and the others from every thread once the setup
//     is done; else ring − 1 chunks ahead from warp 0.  The host lays the matrix out by
//     chunk, [na, chunks, KP, kc + 8] (PFBChannelizer.chunked_parts), so a
//     row's slice with its 8 padding columns (ldmatrix without bank
//     conflicts) is one contiguous copy, and a run of consecutive rows
//     (the critical form's 0 .. 2M − 1) one copy a part: single 144-byte
//     copies a row cost the critical form half its time;
//   * every thread folds the chunk's k rows for the tile's frames into one
//     of two frame buffers (three bf16 parts, in the layout a wgmma
//     descriptor reads without swizzle: 8 frames × 8 k a 128-byte core
//     matrix, frame groups 128 bytes apart, k groups LBO apart), each
//     v_F[p] the other kernels' ascending-i fmaf chain, so the folded
//     frames are theirs bit for bit;
//   * the products.  Under 128 rows (``wg`` 0; rbp 16 or 32: a bank's 2C
//     gathered rows), mma.sync m16n8k16, the A fragments by ldmatrix from
//     the staged rows, each k-step's MMA_PASSES into an accumulator of its
//     own, added to float32 sums in k order: the earlier large-M kernel's
//     order, so its rows bit for bit (where a block has fewer (m-tile,
//     n-tile) pairs than warps, the warps split a chunk's k-steps, each
//     k-step's accumulator goes through shared memory, and the pair's warp
//     adds them in k order).  From 128 rows (``wg`` 1; rbp 256:
//     the critical form's 256), wgmma m64n64k16 with the rows on the
//     64-row side, their fragments in registers (ldmatrix of the staged
//     rows: a row-contiguous slice is what one bulk copy a row gives, and
//     only the register operand takes it as it lands), and the frames the
//     N side from the frame buffer; a chunk's products go into an
//     accumulator of their own (scale-d 0 on its first), added to float32
//     sums in k order, and run asynchronously under the next chunk's fold.
// The bins leave from the sums, the (−1)^m sign of bin m = rows[r] mod M
// applied to even frames on the way (on wgmma through the idle ring as a
// float tile, then in 16-byte rows); frames past the valid tiles are not
// written.  A block is 256 threads, or on mma.sync 512 where the blocks
// fit one wave at one an SM (more warps for the fold's latencies).  The counterpart of _chz_kernel (PallasChannelizer), which the
// JAX package runs where its V3 and V2 bodies refuse 2M > 128.
// What bounds it: the bytes, 2·T input samples in and R × T/h bins out
// (0.6–0.7 µs at the banks' 32 rows, 7.5 µs at the critical form's 2^21
// samples).  It runs at 5–41× that (scripts/pfb_big_ab.py --parts and
// --phases, PERF.md): a chunk's fold (1.1–1.7 µs a block), its products
// (0.8–1.4) and its syncs, and a block's setup (~2 µs), take the time;
// the bytes moved are not its limit.
constexpr int BIG_MAXP = 4;   // (m-tile, n-tile) pairs a warp, mma.sync

// One block's shared memory in bytes (ops/channelizer_kernel.py:
// pfb_big_smem sizes it the same): the mbarriers, the block's row ids,
// the transposed taps, the staged span (both planes), ``ring`` slots of
// the rows' k-slices (na parts, rbp rows of kc + 8 bf16), two frame
// buffers (three parts of kc / 8 k groups, LBO bytes each) and, on
// mma.sync with fewer pairs than the block's ``threads`` / 32 warps, the
// k-steps' accumulators.
struct BigLayout {
  int SC;    // floats of one plane of the span: (nt − 1)·h + K0 + M, + slack
  int RS;    // bf16 of one staged row slice: kc + 8 (ldmatrix without
             // bank conflicts)
  int LBO;   // bytes between a frame buffer's k groups: nt·16 + 16
  int PS;    // bytes of one part of a frame buffer
  int rows, taps, span, mat, frm, ebuf, total;
};

__host__ __device__ inline BigLayout big_layout(int M, int tpp, int h,
                                                int nt, int kc, int rbp,
                                                int na, int staged, int wg,
                                                int ring, int threads) {
  BigLayout l;
  l.SC = (((nt - 1) * h + tpp * M + M + 3) & ~3) + 4;
  l.RS = kc + 8;
  l.LBO = nt * 16 + 16;
  l.PS = kc / 8 * l.LBO;
  l.rows = 64;
  l.taps = l.rows + ((rbp * 4 + 15) & ~15);
  l.span = l.taps + ((tpp * M * 4 + 15) & ~15);
  l.mat = l.span + (staged ? 2 * l.SC * 4 : 0);
  l.frm = l.mat + ring * na * rbp * l.RS * 2;
  l.ebuf = l.frm + 2 * 3 * l.PS;
  const int npair = rbp / 16 * (nt / 8);
  l.total = l.ebuf +
            (!wg && npair < threads / 32 ? npair * (kc / 16) * 512 : 0);
  return l;
}

struct BigArgs {
  const float *xr, *xi, *hr, *hi;   // x [T] and the history [nh], planes
  const float* br;                  // taps [M, tpp]
  const __nv_bfloat16* ap;          // by chunk: [na, nch, KP, kc + 8]
  const int* rows;                  // [R]
  void* out;                        // [R, width]
  float* fold_out;                  // null or [2M, width]
  int T, nh, M, tpp, h, KP, R, even_sign, out_bf16, width, nt, kc, rbp,
      staged, ring;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

using sdr::mbar_init;
using sdr::mbar_wait;

// Arrive on ``b`` and expect ``bytes`` of asynchronous copies there.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(b)), "r"(bytes) : "memory");
}

// ``bytes`` (a multiple of 16; both addresses 16-byte aligned) global ->
// shared, completing on mbarrier ``b``.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(b)) : "memory");
}

// Order this thread's shared-memory accesses before later asynchronous-
// proxy ones (wgmma's operand reads, bulk copies into the same bytes).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// A wgmma shared-memory descriptor without swizzle: start, LBO (bytes
// between the two 8-wide k core matrices of a k-step), SBO (between
// 8-row groups).
__device__ __forceinline__ uint64_t wg_desc(const void* p, unsigned lbo,
                                            unsigned sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of ``d`` across a wgmma fence or
// wait (the accumulators change under it asynchronously).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a · b, one warpgroup: a the 64 rows × 16 k in registers (this
// warp's 16 rows, mma.sync's A fragment layout), b 16 k × 64 frames from
// shared memory (desc, K-major); scale_d 0 overwrites d.  Lane l of warp
// w holds d[4j + e] at row 16w + l/4 (+8 for e >= 2), frame 8j + 2(l%4)
// (+1 for odd e).
__device__ __forceinline__ void wgmma_64x64(float (&d)[32],
                                            const unsigned (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// The span in shared memory (dr[i] = s[n0 + i]), or read in place.
struct SpanSmem {
  const float* s;
  __device__ __forceinline__ float operator()(int i) const { return s[i]; }
};
struct SpanGlobal {   // s[n0 + i] of [hist | x | 0], boundaries by index
  const float* x;
  const float* hist;
  long n0;
  int nh, T;
  __device__ __forceinline__ float operator()(int i) const {
    const long n = n0 + i;
    if (n < nh) return hist[n];
    return n - nh < T ? x[n - nh] : 0.f;
  }
};

// v[u][f] = Σ_i brT[i·M + p[u]]·s[u](base[u] + (f + i)·M), f < PFB_NF, for
// IT runs at once (their loads and multiply-adds interleaved), each value
// the ascending-i fmaf chain of fold_tile (one plane).
template <int IT, typename Src>
__device__ __forceinline__ void fold_runs(const Src (&s)[IT],
                                          const float* brT, int M, int tpp,
                                          const int (&base)[IT],
                                          const int (&p)[IT],
                                          float (&v)[IT][PFB_NF]) {
  float w[IT][PFB_NF];
#pragma unroll
  for (int u = 0; u < IT; ++u)
#pragma unroll
    for (int f = 0; f < PFB_NF; ++f) {
      w[u][f] = s[u](base[u] + f * M);
      v[u][f] = 0.f;
    }
  int i0 = 0;
  for (; i0 + PFB_NF <= tpp; i0 += PFB_NF) {
    float tap[IT][PFB_NF];
#pragma unroll
    for (int u = 0; u < IT; ++u)
#pragma unroll
      for (int ii = 0; ii < PFB_NF; ++ii)
        tap[u][ii] = brT[(i0 + ii) * M + p[u]];
#pragma unroll
    for (int ii = 0; ii < PFB_NF; ++ii) {
#pragma unroll
      for (int u = 0; u < IT; ++u) {
#pragma unroll
        for (int f = 0; f < PFB_NF; ++f)
          v[u][f] = fmaf(tap[u][ii], w[u][(f + ii) % PFB_NF], v[u][f]);
        w[u][ii] = s[u](base[u] + (i0 + ii + PFB_NF) * M);
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < PFB_NF; ++ii) {
    if (i0 + ii >= tpp) break;
#pragma unroll
    for (int u = 0; u < IT; ++u) {
      const float tap = brT[(i0 + ii) * M + p[u]];
#pragma unroll
      for (int f = 0; f < PFB_NF; ++f)
        v[u][f] = fmaf(tap, w[u][(f + ii) % PFB_NF], v[u][f]);
      if (i0 + ii + 1 < tpp) w[u][ii] = s[u](base[u] + (i0 + ii + PFB_NF) * M);
    }
  }
}

// The fold of k = k0 .. k0 + kc for the tile's nt frames into frame
// buffer ``fb`` (part q at q·PS bytes; (frame f, k0 + kk) at (kk / 8)·LBO
// + f·16 + (kk % 8)·2): items (kk, class c, run of PFB_NF frames of c),
// IT a thread at once (items tid + u·NT, then the next IT·NT, NT the
// block's threads); k >= 2M folds to zeros.
template <int IT, int NT, typename Src>
__device__ __forceinline__ void fold_chunk(const BigArgs& g, const Src& sr,
                                           const Src& si, const float* brT,
                                           int k0, unsigned char* fb,
                                           int LBO, int PS, int F0,
                                           bool probe, int tid) {
  // kc is a power of two and Rt = M / h is 1 or 2: shifts, no division
  const int M = g.M, h = g.h, Rt = M / h, rs = Rt - 1;
  const int kcs = __ffs(g.kc) - 1;
  const int items = g.kc * (g.nt / PFB_NF);
  for (int item = tid; item < items; item += IT * NT) {
    int kk[IT], fl0[IT], base[IT], p[IT];
    bool live[IT];
    Src src[IT];
#pragma unroll
    for (int u = 0; u < IT; ++u) {
      const int it = item + u * NT;
      kk[u] = it & (g.kc - 1);
      const int rest = it >> kcs;
      const int c = rest & rs, Gl = (rest >> rs) * PFB_NF;
      const int k = k0 + kk[u];
      live[u] = it < items && k < 2 * M;
      p[u] = live[u] ? (k < M ? k : k - M) : 0;
      src[u] = live[u] && k >= M ? si : sr;
      base[u] = Gl * M + c * h + p[u];
      fl0[u] = Rt * Gl + c;     // frame of run slot f: fl0 + Rt·f
    }
    float v[IT][PFB_NF];
    fold_runs<IT>(src, brT, M, g.tpp, base, p, v);
#pragma unroll
    for (int u = 0; u < IT; ++u) {
      if (item + u * NT >= items) break;
      const int k = k0 + kk[u];
      unsigned char* col = fb + (kk[u] >> 3) * LBO + (kk[u] & 7) * 2;
#pragma unroll
      for (int f = 0; f < PFB_NF; ++f) {
        const int fl = fl0[u] + Rt * f;
        const float x = live[u] ? v[u][f] : 0.f;
        put_parts(reinterpret_cast<__nv_bfloat16*>(col + fl * 16), PS / 2,
                  x);
        if (probe && live[u] && F0 + fl < g.width)
          g.fold_out[static_cast<long>(k) * g.width + F0 + fl] = x;
      }
    }
  }
}

// fold_chunk, two items a thread at once where the chunk has that many.
template <int NT, typename Src>
__device__ __forceinline__ void fold_chunk_any(const BigArgs& g,
                                               const Src& sr, const Src& si,
                                               const float* brT, int k0,
                                               unsigned char* fb, int LBO,
                                               int PS, int F0, bool probe,
                                               int tid) {
  if (g.kc * (g.nt / PFB_NF) >= 2 * NT)
    fold_chunk<2, NT>(g, sr, si, brT, k0, fb, LBO, PS, F0, probe, tid);
  else
    fold_chunk<1, NT>(g, sr, si, brT, k0, fb, LBO, PS, F0, probe, tid);
}

// The wgmma route's bins from its staged tile (``tile`` [rows][
// BIG_TILE_ROW] float, the sign applied) to out: 16-byte stores along
// frames (8 bf16 or 4 float32), rows row0 .. row0 + nrows, frames F0 ..
// F0 + 64 below width, by the block's 256 threads.
constexpr int BIG_TILE_ROW = 72;   // 64 frames + 8 (2-way bank conflicts)

__device__ __forceinline__ void store_tile_rows(const BigArgs& g,
                                                const float* tile, int row0,
                                                int nrows, int F0, int tid) {
  const int per = g.out_bf16 ? 8 : 4;   // frames a 16-byte store
  const int q_row = 64 / per;
  const bool vec = !(g.width % per);
  for (int idx = tid; idx < nrows * q_row; idx += 256) {
    const int rl = idx / q_row, q = idx - rl * q_row;
    const int F = F0 + q * per;
    if (F >= g.width) continue;
    const float* v = tile + rl * BIG_TILE_ROW + q * per;
    const long at = static_cast<long>(row0 + rl) * g.width + F;
    if (vec && F + per <= g.width) {
      if (g.out_bf16)
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(g.out) + at) =
            make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                       bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
      else
        *reinterpret_cast<float4*>(static_cast<float*>(g.out) + at) =
            make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int e = 0; e < per && F + e < g.width; ++e)
        sdr::st(g.out, at + e, v[e], g.out_bf16);
    }
  }
}

// One output pair (frames F, F + 1; F even) of list entry r.
__device__ __forceinline__ void store_pair(const BigArgs& g, int r, int bin,
                                           int F, float v0, float v1) {
  const int m = bin < g.M ? bin : bin - g.M;
  if (g.even_sign && (m & 1)) v0 = -v0;
  const long at = static_cast<long>(r) * g.width + F;
  if (F + 1 < g.width && !(at & 1)) {
    if (g.out_bf16)
      *reinterpret_cast<unsigned*>(static_cast<__nv_bfloat16*>(g.out) + at) =
          bf16_pair(v0, v1);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(g.out) + at) =
          make_float2(v0, v1);
    return;
  }
  if (F < g.width) sdr::st(g.out, at, v0, g.out_bf16);
  if (F + 1 < g.width) sdr::st(g.out, at + 1, v1, g.out_bf16);
}

// NT threads a block: two warpgroups on wgmma; on mma.sync 256 (two
// blocks an SM where their shared memory fits) or 512 (one block an SM
// with twice the warps to hide the fold's latencies: the launch's
// blocks fit one wave anyway).
template <int NA, bool WG, int NT>
__global__ void __launch_bounds__(NT, WG || NT == 512 ? 1 : 2)
    pfb_big_kernel(BigArgs g) {
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  constexpr int NP = NA == 3 ? 6 : 3;   // MMA_PASSES: (matrix, frame) part
  constexpr int PA[6] = {NA == 3 ? 2 : 0, NA == 3 ? 1 : 0, 0, 1, 0, 0};
  constexpr int PB[6] = {NA == 3 ? 0 : 2, 1, NA == 3 ? 2 : 0, 0, 1, 0};
  constexpr int KCW = NA == 1 ? 64 : 16;   // the wgmma route's chunk
  constexpr int NW = NT / 32;
  const int M = g.M, tpp = g.tpp, h = g.h, nt = g.nt, kc = g.kc;
  const int rbp = g.rbp, KP = g.KP;
  const BigLayout L =
      big_layout(M, tpp, h, nt, kc, rbp, NA, g.staged, WG, g.ring, NT);
  const int ring = g.ring;   // slots of the row-slice ring
  // mbarriers: bar[0 .. ring) the ring's slots, bar[ring] the span
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* rowid = reinterpret_cast<int*>(smem + L.rows);
  float* brT = reinterpret_cast<float*>(smem + L.taps);
  unsigned char* mat = smem + L.mat;
  unsigned char* frm = smem + L.frm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int F0 = blockIdx.x * nt;
  const int row0 = blockIdx.y * rbp;
  const int nrows = min(rbp, g.R - row0);
  const int nch = (KP + kc - 1) / kc;
  const int RSB = L.RS * 2;                 // bytes of a staged row
  const bool probe = g.fold_out && blockIdx.y == 0;

  // the span: the 16-byte-aligned part of x by bulk copy, the history, x's
  // ragged ends and the zeros past x by the threads
  const long n0 = static_cast<long>(F0) * h;
  const int span = (nt - 1) * h + tpp * M;
  float* dr = reinterpret_cast<float*>(smem + L.span) + span_off(n0, g.nh);
  float* di = dr + L.SC;
  const long i0 = n0 - g.nh;   // x index of dr[0]
  long a0 = (max(i0, 0L) + 3) & ~3L;
  long a1 = min(i0 + span, static_cast<long>(g.T)) & ~3L;
  if (a1 <= a0 || ((reinterpret_cast<uintptr_t>(g.xr) |
                    reinterpret_cast<uintptr_t>(g.xi)) & 15))
    a0 = a1 = i0 + span;
  if (tid == 0) {
    for (int i = 0; i <= ring; ++i) mbar_init(&bar[i], 1);
    sdr::fence_mbar_init();
    if (g.staged) {   // first, to land while the block sets up
      const unsigned bytes = static_cast<unsigned>(a1 - a0) * 4;
      mbar_expect_tx(&bar[ring], 2 * bytes);
      if (bytes) {
        bulk_copy(dr + (a0 - i0), g.xr + a0, bytes, &bar[ring]);
        bulk_copy(di + (a0 - i0), g.xi + a0, bytes, &bar[ring]);
      }
    }
  }
  // warp 0: the block's row ids, whether they run consecutively (then one
  // copy a part takes a chunk's slices), and chunk c's row slices into
  // ring slot c % ring
  bool contig = false;
  auto issue = [&](int c) {
    const int s = c % ring;
    const long part = static_cast<long>(nch) * KP * L.RS;
    const __nv_bfloat16* src = g.ap + static_cast<long>(c) * KP * L.RS;
    fence_async_smem();
    if (lane == 0) mbar_expect_tx(&bar[s], NA * nrows * RSB);
    __syncwarp();
    if (contig) {
      if (lane < NA)
        bulk_copy(mat + (s * NA + lane) * rbp * RSB,
                  src + lane * part + static_cast<long>(rowid[0]) * L.RS,
                  nrows * RSB, &bar[s]);
    } else {
      for (int idx = lane; idx < NA * nrows; idx += 32) {
        const int a = idx / nrows, j = idx - a * nrows;
        bulk_copy(mat + ((s * NA + a) * rbp + j) * RSB,
                  src + a * part + static_cast<long>(rowid[j]) * L.RS, RSB,
                  &bar[s]);
      }
    }
  };
  if (warp == 0) {
    const int r0 = g.rows[row0];
    bool run = true;
    for (int j = lane; j < rbp; j += 32) {
      const int r = j < nrows ? g.rows[row0 + j] : 0;
      rowid[j] = r;
      run = run && (j >= nrows || r == r0 + j);
    }
    contig = __all_sync(0xffffffffu, run);
    __syncwarp();
    // chunk 0 now; with a ring of every chunk the others right after the
    // setup, by every warp; else ring − 1 chunks ahead
    for (int c = 0; c < (ring >= nch ? 1 : ring - 1); ++c) issue(c);
    if (ring >= nch && lane > 0 && lane < nch)
      mbar_expect_tx(&bar[lane], NA * nrows * RSB);
  }
  // the other warps: rows past the list zero in every slot (no copy writes
  // them), the taps, the span's edges (warp 0 is at its rows and copies)
  const int st0 = tid - 32, stn = NT - 32;
  for (int i = st0; warp > 0 && i < ring * NA * (rbp - nrows) * L.RS / 2;
       i += stn) {
    const int per = (rbp - nrows) * L.RS / 2;   // words of one (slot, part)
    const int sa = i / per, w = i - sa * per;
    reinterpret_cast<unsigned*>(mat + (sa * rbp + nrows) * RSB)[w] = 0u;
  }
  for (int i = st0; warp > 0 && i < tpp * M; i += stn) {
    const int p = i / tpp;
    brT[(i - p * tpp) * M + p] = g.br[i];
  }
  const SpanGlobal gr{g.xr, g.hr, n0, g.nh, g.T}, gi{g.xi, g.hi, n0, g.nh,
                                                     g.T};
  if (g.staged && warp > 0) {
    for (int t = st0; t < a0 - i0; t += stn) {
      dr[t] = gr(t);
      di[t] = gi(t);
    }
    for (int t = static_cast<int>(a1 - i0) + st0; t < span; t += stn) {
      dr[t] = gr(t);
      di[t] = gi(t);
    }
  }
  __syncthreads();
  if (g.staged) mbar_wait(&bar[ring], 0);

  float d[BIG_MAXP][4];      // mma.sync: this warp's pairs' sums
  // wgmma: a chunk's products (written by wgmma alone: scale-d 0 on a
  // chunk's first; any other definition serializes the wgmmas) and the sums
  float acc[2][32], sums[2][32];
#pragma unroll
  for (int j = 0; j < BIG_MAXP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
#pragma unroll
  for (int mg = 0; mg < 2; ++mg)
#pragma unroll
    for (int e = 0; e < 32; ++e) sums[mg][e] = 0.f;
  const int wgi = warp >> 2, wl = warp & 3;
  const int MT = rbp / 16, NTN = nt / 8, NPAIR = MT * NTN;

  for (int c = 0; c < nch; ++c) {
    const int k0 = c * kc;
    unsigned char* fb = frm + (c & 1) * 3 * L.PS;
    if (g.staged) {
      const SpanSmem sr{dr}, si{di};
      fold_chunk_any<NT>(g, sr, si, brT, k0, fb, L.LBO, L.PS, F0, probe,
                         tid);
    } else {
      fold_chunk_any<NT>(g, gr, gi, brT, k0, fb, L.LBO, L.PS, F0, probe,
                         tid);
    }
    if constexpr (WG) {
      if (c > 0) {           // the last chunk's products, into the sums
        wg_wait0();
        reg_fence(acc[0]);
        reg_fence(acc[1]);
#pragma unroll
        for (int mg = 0; mg < 2; ++mg)
#pragma unroll
          for (int e = 0; e < 32; ++e) sums[mg][e] += acc[mg][e];
      }
      fence_async_smem();
    }
    __syncthreads();
    if (warp == 0 && ring < nch && c + ring - 1 < nch) issue(c + ring - 1);
    if (c == 0 && ring >= nch) {   // chunks 1 .. nch − 1, a row slice a
      fence_async_smem();          // thread (their barriers armed above)
      const long part = static_cast<long>(nch) * KP * L.RS;
      for (int idx = tid; idx < (nch - 1) * NA * nrows; idx += NT) {
        const int cc = 1 + idx / (NA * nrows), r = idx % (NA * nrows);
        const int a = r / nrows, j = r - a * nrows;
        bulk_copy(mat + ((cc * NA + a) * rbp + j) * RSB,
                  g.ap + static_cast<long>(cc) * KP * L.RS + a * part +
                      static_cast<long>(rowid[j]) * L.RS,
                  RSB, &bar[cc]);
      }
    }
    mbar_wait(&bar[c % ring], (c / ring) & 1);
    const unsigned char* ms = mat + (c % ring) * NA * rbp * RSB;

    if constexpr (!WG) {
      // the k-step's products of pair pi, the small first (MMA_PASSES)
      auto kstep = [&](int pi, int ks, float (&e)[4]) {
        const int mt = pi / NTN, jn = pi - mt * NTN;
        unsigned A[NA][4];
#pragma unroll
        for (int a = 0; a < NA; ++a)
          ldmatrix_x4(A[a], ms + (a * rbp + mt * 16 + (lane & 15)) * RSB +
                                (ks * 16 + (lane >> 4) * 8) * 2);
        unsigned bq[3][2];
        const unsigned char* fq =
            fb + 2 * ks * L.LBO + (jn * 8 + gq) * 16 + tq * 4;
#pragma unroll
        for (int pt = 0; pt < 3; ++pt) {
          bq[pt][0] = *reinterpret_cast<const unsigned*>(fq + pt * L.PS);
          bq[pt][1] =
              *reinterpret_cast<const unsigned*>(fq + pt * L.PS + L.LBO);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) e[q] = 0.f;
#pragma unroll
        for (int ps = 0; ps < NP; ++ps)
          sdr::mma_bf16_16816(e, A[PA[ps]], bq[PB[ps]][0], bq[PB[ps]][1]);
      };
      const int kss = min(kc, KP - k0) / 16;   // the chunk's k-steps
      if (NPAIR >= NW) {      // each warp its pairs, every k-step
        for (int ks = 0; ks < kss; ++ks) {
#pragma unroll
          for (int j = 0; j < BIG_MAXP; ++j) {
            const int pi = warp + NW * j;
            if (pi >= NPAIR) break;
            float e[4];
            kstep(pi, ks, e);
#pragma unroll
            for (int q = 0; q < 4; ++q) d[j][q] += e[q];
          }
        }
      } else {                // the warps split the k-steps
        float4* E = reinterpret_cast<float4*>(smem + L.ebuf);
        const int pi = warp % NPAIR;
        for (int ks = warp / NPAIR; ks < kss; ks += NW / NPAIR) {
          float e[4];
          kstep(pi, ks, e);
          E[(pi * (kc / 16) + ks) * 32 + lane] =
              make_float4(e[0], e[1], e[2], e[3]);
        }
        __syncthreads();
        if (warp < NPAIR) {   // pair ``warp``'s sums, in k order
          for (int ks = 0; ks < kss; ++ks) {
            const float4 e = E[(warp * (kc / 16) + ks) * 32 + lane];
            d[0][0] += e.x;
            d[0][1] += e.y;
            d[0][2] += e.z;
            d[0][3] += e.w;
          }
        }
      }
    } else {
      constexpr int KS = KCW / 16;
      unsigned A[KS][NA][2][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (k0 + 16 * ks >= KP) break;
#pragma unroll
        for (int a = 0; a < NA; ++a)
#pragma unroll
          for (int mg = 0; mg < 2; ++mg)
            ldmatrix_x4(A[ks][a][mg],
                        ms + (a * rbp + wgi * 128 + mg * 64 + wl * 16 +
                              (lane & 15)) * RSB +
                            (ks * 16 + (lane >> 4) * 8) * 2);
      }
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (k0 + 16 * ks >= KP) break;
#pragma unroll
        for (int ps = 0; ps < NP; ++ps)
#pragma unroll
          for (int mg = 0; mg < 2; ++mg)
            wgmma_64x64(acc[mg], A[ks][PA[ps]][mg],
                        wg_desc(fb + PB[ps] * L.PS + 2 * ks * L.LBO, L.LBO,
                                128),
                        (ks | ps) ? 1 : 0);
      }
      wg_commit();
    }
  }

  if constexpr (WG) {
    wg_wait0();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    // the 256 × 64 sums through the (now idle) ring as float [row][72],
    // the sign on the way, then out in 16-byte rows: the fragments'
    // 4-byte stores left half of each sector unused
    __syncthreads();
    float* tile = reinterpret_cast<float*>(mat);
#pragma unroll
    for (int mg = 0; mg < 2; ++mg) {
#pragma unroll
      for (int e = 0; e < 32; ++e) sums[mg][e] += acc[mg][e];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int rl = wgi * 128 + mg * 64 + wl * 16 + gq + 8 * hf;
          const int bin = rowid[rl] < M ? rowid[rl] : rowid[rl] - M;
          const float v0 = sums[mg][4 * jn + 2 * hf];
          *reinterpret_cast<float2*>(tile + rl * BIG_TILE_ROW + 8 * jn +
                                     2 * tq) =
              make_float2(g.even_sign && (bin & 1) ? -v0 : v0,
                          sums[mg][4 * jn + 2 * hf + 1]);
        }
    }
    __syncthreads();
    store_tile_rows(g, tile, row0, nrows, F0, tid);
  } else {
#pragma unroll
    for (int j = 0; j < BIG_MAXP; ++j) {
      const int pi = warp + NW * j;
      if (pi >= NPAIR) break;
      const int mt = pi / NTN, jn = pi - mt * NTN;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int rl = mt * 16 + gq + 8 * hf;
        if (rl < nrows)
          store_pair(g, row0 + rl, rowid[rl], F0 + 8 * jn + 2 * tq,
                     d[j][2 * hf], d[j][2 * hf + 1]);
      }
    }
  }
}

}  // namespace

// br [M, tpp] float32; ap [na, KP, KP] bf16 (KP = 2M padded to 16) as the
// host splits the DFT matrix; out [2M, width] float32 or bf16; fold_out
// null or [2M, width] float32.  M <= 64; kind (0: pfb_kernel, which takes
// na 3; 1: the warp-specialised pfb_ws_kernel, which takes na 1), nt (16
// or 32 frames a tile), nbuf (0, 1 or 2 input spans in shared memory; with
// 0, ext_r/ext_i hold s whole through the last tile's span, else they are
// null) and grid (persistent blocks along the frames) come from
// ops/channelizer_kernel.py:pfb_plan.
extern "C" int sdr_pfb_bins(const float* xr, const float* xi, int T,
                            const float* hr, const float* hi, int nh,
                            const float* br, const void* ap, int na, int M,
                            int tpp, int hop, int even_sign, void* out,
                            int out_bf16, int width, int kind, int nt,
                            int nbuf, int grid, const float* ext_r,
                            const float* ext_i, float* fold_out,
                            cudaStream_t stream) {
  if (M < 2 || M % 2 || M > 64 || tpp < 2 || width < 1 ||
      (hop != M / 2 && hop != M) || nh != tpp * M - hop ||
      (na != 1 && na != 3) || (nt != 16 && nt != 32) || nbuf < 0 ||
      nbuf > 2 || grid < 1 || (nbuf == 0 && (!ext_r || !ext_i)) ||
      kind < 0 || kind > 1 || (kind != 0) != (na == 1))
    return cudaErrorInvalidValue;
  const size_t smem =
      pfb_layout(M, tpp, hop, nt, nbuf, kind == 1 ? 2 : 1).total *
      sizeof(float);
  const PfbArgs g{xr, xi, hr, hi, ext_r, ext_i, T, nh, M, tpp, hop, nt};
  const unsigned* a = static_cast<const unsigned*>(ap);
  cudaError_t e;
  if (kind == 1) {
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

// The large-M kernel.  x, the history and br as above; ap the matrix by
// chunk, [na, ceil(KP / kc), KP, kc + 8] bf16 (each chunk's columns of
// every row, then 8 zeros; columns past KP zero), 16-byte aligned; rows
// [R] int32, each in [0, 2M); out [R, width]
// float32 or bf16, written at frames < tiles·nt only; fold_out null or
// [2M, width] float32 (the same frames).  wg, nt, kc, rbp, staged, ring,
// threads, tiles
// (frame tiles, those that hold the T / hop valid frames) and rgroups
// (ceil(R / rbp)) come from ops/channelizer_kernel.py:pfb_plan.
extern "C" int sdr_pfb_big(const float* xr, const float* xi, int T,
                           const float* hr, const float* hi, int nh,
                           const float* br, const void* ap, int na, int M,
                           int tpp, int hop, int even_sign, const int* rows,
                           int R, void* out, int out_bf16, int width, int wg,
                           int nt, int kc, int rbp, int staged, int ring,
                           int threads, int tiles, int rgroups,
                           float* fold_out, cudaStream_t stream) {
  const int KP = (2 * M + 15) / 16 * 16;
  const bool bad_products =
      wg ? (nt != 64 || rbp != 256 || kc != (na == 1 ? 64 : 16) ||
            threads != 256)
         : ((rbp != 16 && rbp != 32) || (threads != 256 && threads != 512) ||
            rbp / 16 * (nt / 8) > threads / 32 * BIG_MAXP || kc < 16);
  if (M < 2 || M % 2 || tpp < 2 || T < 1 || width < 1 ||
      (hop != M / 2 && hop != M) || nh != tpp * M - hop ||
      (na != 1 && na != 3) || !rows || R < 1 || R > 2 * M ||
      (nt != 16 && nt != 32 && nt != 64) || bad_products ||
      (kc & (kc - 1)) || staged < 0 || staged > 1 || ring < 2 || ring > 7 ||
      tiles < 1 ||
      static_cast<long>(tiles - 1) * nt >= width ||
      rgroups != (R + rbp - 1) / rbp || rgroups > 65535 ||
      (reinterpret_cast<uintptr_t>(ap) & 15))
    return cudaErrorInvalidValue;
  const size_t smem =
      big_layout(M, tpp, hop, nt, kc, rbp, na, staged, wg, ring, threads)
          .total;
  if (smem > 232448) return cudaErrorInvalidValue;
  const BigArgs g{xr, xi, hr, hi, br,
                  static_cast<const __nv_bfloat16*>(ap), rows, out,
                  fold_out, T, nh, M, tpp, hop, KP, R, even_sign, out_bf16,
                  width, nt, kc, rbp, staged, ring};
  auto* k = wg ? (na == 3 ? pfb_big_kernel<3, true, 256>
                          : pfb_big_kernel<1, true, 256>)
           : threads == 512 ? (na == 3 ? pfb_big_kernel<3, false, 512>
                                       : pfb_big_kernel<1, false, 512>)
                            : (na == 3 ? pfb_big_kernel<3, false, 256>
                                       : pfb_big_kernel<1, false, 256>);
  cudaError_t e = sdr::allow_smem(k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the SM's whole carve-out as shared memory, so that two blocks of up
  // to ~113 KB share an SM (scripts/pfb_big_ab.py --phases counts them)
  e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  k<<<dim3(tiles, rgroups), threads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}
