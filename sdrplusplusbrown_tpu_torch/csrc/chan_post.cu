// K6 — post-channelizer: bin gather, residual NCO, 2:1 FIR, bandwidth FIR,
// squelch sums and the next-call tails.
//
// Replaces: sdrplusplusbrown_tpu/ops/chan_frontend.py:_chan_kernel (chan_body:
// one-hot gather matmul, in-kernel NCO, banded-matmul FIR stages with their
// overlap-save history rolled in VMEM across a sequential grid), which also
// runs as the second half of _chan_fused_kernel_v3.
//
// What it computes, per channel c, from the stacked PFB bins [2M, Tb_pad]
// (float32 or bfloat16 storage; valid frames n < Tb):
//   z[n]  = (bins[bin_c, n] + j·bins[M + bin_c, n]) · e^{jθ(n)},
//           θ(n) = ((ph0 + span·i) + bs·b) + ω·j,  n = i·adv0 + 128·b + j,
//           each product and sum rounded on its own (__fmul_rn/__fadd_rn):
//           the TPU kernel forms the phase so, and one fused multiply-add
//           moves the ~10² rad sum by an ulp;
//   y1[m] = Σ_k d2[k] · ext0[2m + k],  ext0 = [d2 tail (K1−1) | z]
//   y [o] = Σ_k fir[k] · ext1[o + k],  ext1 = [fir tail (K2−1) | y1]
// out [2C, n_out] (re rows over im rows); sq[c, tile] = Σ|y[o]| over the
// tile's VALID outputs (o < m_out: the padded tail is garbage by design),
// which the wrapper sums over the tiles with one torch reduction on the
// device (no atomics, no host copy); and the next-call tails ext0[Tb − (K1−1), Tb) and
// ext1[m1 − (K2−1), m1) with m1 = Tb/2, rounded to the handoff dtype.
//
// The TPU's sequential grid carried the FIR histories in VMEM from step to
// step.  Here blocks run in any order, so each (output tile, channel) block
// stages its own input span with the history in front, as K1 does: it
// computes the z it needs (2·(POST_TILE + K2 − 1) + K1 − 1 samples), then
// y1 over POST_TILE + K2 − 1 samples, then its POST_TILE outputs, all in
// shared memory.  The halo costs 1.6× the z and y1 work at POST_TILE = 512.
// The block whose tile holds output index m1 (a grid with one tile more
// when m1 falls past the padded end) also writes the tails.
//
// What bounds it on the H100: the 304-tap bandwidth FIR, 4·304 flops per
// complex output, about 0.8 GFLOP per 0.1 s block at C = 128, against a
// few MB of bins in and IF out — FP32 throughput.  Splitting the tap loop
// across a warp, tensor cores, and fusing with K5 are left for later work.
#include "common.cuh"

namespace {

constexpr int POST_TILE = 512;
constexpr int POST_THREADS = 256;
constexpr int NCO_BS = 128;   // the NCO's block (ops/chan_frontend.py BS)

__device__ __forceinline__ float stored(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__global__ void chan_post_kernel(
    const void* __restrict__ bins, int bins_bf16, int M, int Tb_pad, int Tb,
    const int* __restrict__ bin_idx, const float* __restrict__ om,
    const float* __restrict__ ph0, const float* __restrict__ span,
    const float* __restrict__ sbs, int adv0, const float* __restrict__ t_d2,
    const float* __restrict__ t_fir, const float* __restrict__ h_d2, int K1,
    const float* __restrict__ h_fir, int K2, void* __restrict__ out,
    int out_bf16, int n_out, int m_out, float* __restrict__ sq, int n_tiles,
    float* __restrict__ nt_d2, float* __restrict__ nt_fir, int tail_bf16,
    int C, int lz_max) {
  extern __shared__ float smem[];
  __shared__ float red[POST_THREADS / 32];
  const int H1 = K1 - 1;
  const int H2 = K2 - 1;
  const int L1 = POST_TILE + H2;
  float* zr = smem;
  float* zi = zr + lz_max;
  float* yr = zi + lz_max;
  float* yi = yr + L1;
  float* g1 = yi + L1;
  float* g2 = g1 + K1;

  const int c = blockIdx.y;
  const int tile = blockIdx.x;
  const int o0 = tile * POST_TILE;
  const int j0 = o0 - H2;                       // first y1 index
  const int zlo = 2 * max(j0, 0) - H1;          // first z index
  const int lz = 2 * (o0 + POST_TILE - 1) - zlo + 1;

  for (int k = threadIdx.x; k < K1; k += blockDim.x) g1[k] = h_d2[k];
  for (int k = threadIdx.x; k < K2; k += blockDim.x) g2[k] = h_fir[k];

  // ---- z: gather + NCO rotate (old d2 tail for n < 0) -------------------
  const int b = bin_idx[c];
  const long row_r = static_cast<long>(b) * Tb_pad;
  const long row_i = static_cast<long>(M + b) * Tb_pad;
  const float w = om[c], p0 = ph0[c], sp = span[c], bs = sbs[c];
  for (int t = threadIdx.x; t < lz; t += blockDim.x) {
    const int n = zlo + t;
    float a = 0.f, q = 0.f;
    if (n < 0) {
      a = t_d2[static_cast<long>(c) * H1 + n + H1];
      q = t_d2[static_cast<long>(C + c) * H1 + n + H1];
    } else if (n < Tb_pad) {
      const float xr = sdr::ld(bins, row_r + n, bins_bf16);
      const float xi = sdr::ld(bins, row_i + n, bins_bf16);
      const int i = n / adv0;
      const int r = n - i * adv0;
      const int bb = r / NCO_BS;
      const int jj = r - bb * NCO_BS;
      const float ang = __fadd_rn(
          __fadd_rn(__fadd_rn(p0, __fmul_rn(sp, static_cast<float>(i))),
                    __fmul_rn(bs, static_cast<float>(bb))),
          __fmul_rn(w, static_cast<float>(jj)));
      float s, co;
      sincosf(ang, &s, &co);
      a = __fsub_rn(__fmul_rn(xr, co), __fmul_rn(xi, s));
      q = __fadd_rn(__fmul_rn(xr, s), __fmul_rn(xi, co));
    }
    zr[t] = a;
    zi[t] = q;
  }
  __syncthreads();

  // ---- y1: 2:1 FIR (old fir tail for m < 0) -----------------------------
  for (int t = threadIdx.x; t < L1; t += blockDim.x) {
    const int m = j0 + t;
    float a = 0.f, q = 0.f;
    if (m < 0) {
      a = t_fir[static_cast<long>(c) * H2 + m + H2];
      q = t_fir[static_cast<long>(C + c) * H2 + m + H2];
    } else {
      const int e = 2 * m - H1 - zlo;
      for (int k = 0; k < K1; ++k) {
        a = fmaf(g1[k], zr[e + k], a);
        q = fmaf(g1[k], zi[e + k], q);
      }
    }
    yr[t] = a;
    yi[t] = q;
  }
  __syncthreads();

  // ---- y: bandwidth FIR, squelch partial sum ----------------------------
  float acc = 0.f;
  for (int t = threadIdx.x; t < POST_TILE; t += blockDim.x) {
    const int o = o0 + t;
    if (o >= n_out) break;
    float a = 0.f, q = 0.f;
    for (int k = 0; k < K2; ++k) {
      a = fmaf(g2[k], yr[t + k], a);
      q = fmaf(g2[k], yi[t + k], q);
    }
    sdr::st(out, static_cast<long>(c) * n_out + o, a, out_bf16);
    sdr::st(out, static_cast<long>(C + c) * n_out + o, q, out_bf16);
    if (o < m_out) acc += sqrtf(__fadd_rn(__fmul_rn(a, a), __fmul_rn(q, q)));
  }
  for (int off = 16; off; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;

  // ---- next-call tails: the block whose tile holds index m1 -------------
  const int m1 = Tb / 2;
  if (o0 <= m1 && m1 < o0 + POST_TILE) {
    for (int t = threadIdx.x; t < H1; t += blockDim.x) {
      const int s = Tb - H1 + t - zlo;
      nt_d2[static_cast<long>(c) * H1 + t] = stored(zr[s], tail_bf16);
      nt_d2[static_cast<long>(C + c) * H1 + t] = stored(zi[s], tail_bf16);
    }
    for (int t = threadIdx.x; t < H2; t += blockDim.x) {
      const int s = m1 - H2 + t - j0;
      nt_fir[static_cast<long>(c) * H2 + t] = stored(yr[s], tail_bf16);
      nt_fir[static_cast<long>(C + c) * H2 + t] = stored(yi[s], tail_bf16);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int k = 0; k < POST_THREADS / 32; ++k) tot += red[k];
    sq[static_cast<long>(c) * n_tiles + tile] = tot;
  }
}

}  // namespace

extern "C" int sdr_chan_post(
    const void* bins, int bins_bf16, int M, int Tb_pad, int Tb,
    const int* bin_idx, const float* om, const float* ph0, const float* span,
    const float* sbs, int adv0, const float* t_d2, const float* t_fir,
    const float* h_d2, int K1, const float* h_fir, int K2, void* out,
    int out_bf16, int n_out, int m_out, float* sq, int n_tiles, float* nt_d2,
    float* nt_fir, int tail_bf16, int C, cudaStream_t stream) {
  if (K1 < 2 || K2 < 2 || Tb % 2 || Tb > Tb_pad || adv0 % NCO_BS ||
      n_tiles * POST_TILE <= Tb / 2 || n_tiles * POST_TILE < n_out)
    return cudaErrorInvalidValue;
  const int lz_max = 2 * (POST_TILE + K2 - 1) + K1 - 1;
  const size_t smem = (2 * static_cast<size_t>(lz_max) +
                       2 * static_cast<size_t>(POST_TILE + K2 - 1) + K1 +
                       K2) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chan_post_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_tiles, C);
  chan_post_kernel<<<grid, POST_THREADS, smem, stream>>>(
      bins, bins_bf16, M, Tb_pad, Tb, bin_idx, om, ph0, span, sbs, adv0,
      t_d2, t_fir, h_d2, K1, h_fir, K2, out, out_bf16, n_out, m_out, sq,
      n_tiles, nt_d2, nt_fir, tail_bf16, C, lz_max);
  return static_cast<int>(cudaGetLastError());
}
