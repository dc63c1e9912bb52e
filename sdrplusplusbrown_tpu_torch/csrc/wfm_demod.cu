// K2 — broadcast-FM demodulator: discriminator, MPX halfbands, stereo.
//
// Replaces: sdrplusplusbrown_tpu/ops/wfm_kernel.py:_wfm_kernel (quad +
// MPX predecimation + stereo section in one sequential-grid Pallas
// kernel), with the stereo identities of ops/pallas_wfm.py.
//
// What it computes, per channel c, on the IF planes [2C, stride] (re rows
// then im rows, float32 or bfloat16 storage):
//   sdr_wfm_quad:     mpx0[n] = arg(x[n]·conj(x[n−1])) · inv_dev,
//                     x[−1] = the carried sample; exact 0 for a 0 product,
//                     subnormal parts counting as 0 (the TPU flushes them;
//                     the cold-start IF ramps through subnormals).
//                     atan2f stands in for the TPU's minimax polynomial
//                     (both within 2.4e-7 rad of the true angle).
//   sdr_wfm_halfband: each MPX decimate-by-2 FIR,
//                     y[j] = Σ_k ext[2j+k]·h[k]
//                     over ext = concat(carried K−1 inputs, x).
//   sdr_wfm_stereo:   with ext = concat(mpx_hist (last K MPX samples), mpx)
//                     the lagged pilot p[n−1] = (a, b) = Σ_k ext[n+k]·h_p[k]
//                     (159 complex taps), u = conj(pilot_phase_corr)²,
//                     w = (Re u·(a²−b²) + 2·Im u·ab) / max(a²+b², 1e−20),
//                     L/R = ext[n+K−d]·(1 ± 2w).
//
// The TPU kernel rolled each stage's history in VMEM across its sequential
// grid; here each stage is one launch over (time tile, channel row) that
// reads its halo from the previous stage's buffer or the carried tail.
//
// What bounds it on the H100: ~2·(26/2 + 105/4 + 2·159/4) MACs per IF
// sample and channel and one atan2f; all of it is a few MB of traffic per
// 0.1 s block, so the stages are bound by launch overhead and the serial
// tap loop per thread, not by memory or FP32 throughput.  Each tap loop
// reads its window from shared memory; taps come from shared memory
// (stereo) or the read-only cache (halfbands).  Fusing the four launches
// (keeping the MPX in shared memory, as the TPU kept it in VMEM) is left
// for later work.
//
// K10 is sdr_wfm_stereo launched alone (ops/wfm_kernel.py:wfm_stereo), on
// the MPX of batched radios' per-stage chain (Radio.apply).  It replaces
// sdrplusplusbrown_tpu/ops/pallas_wfm.py:_wfm_stereo_kernel, the same
// stereo identities over an [C, K + T] MPX extension.  Bound: 4K + 12
// operations per MPX sample and channel (65 Mflop and 1.2 MB at C = 8,
// T = 12 500: ~1 µs by operations); the time is the launch and the serial
// 159-tap loop, which a warp-split loop would shorten.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int QUAD_THREADS = 256;
constexpr int ST_TILE = 256;

__global__ void quad_kernel(const void* __restrict__ iq, int iq_bf16,
                            int stride, int C, int m_if,
                            const float* __restrict__ qprev, float inv_dev,
                            float* __restrict__ mpx) {
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long>(C) * m_if) return;
  const int c = static_cast<int>(idx / m_if);
  const int n = static_cast<int>(idx - static_cast<long>(c) * m_if);
  const long rr = static_cast<long>(c) * stride;
  const long ri = static_cast<long>(C + c) * stride;
  const float er = sdr::ld(iq, rr + n, iq_bf16);
  const float ei = sdr::ld(iq, ri + n, iq_bf16);
  const float erp = n ? sdr::ld(iq, rr + n - 1, iq_bf16) : qprev[c];
  const float eip = n ? sdr::ld(iq, ri + n - 1, iq_bf16) : qprev[C + c];
  float re = er * erp + ei * eip;
  float im = ei * erp - er * eip;
  if (fabsf(re) < FLT_MIN) re = 0.f;
  if (fabsf(im) < FLT_MIN) im = 0.f;
  mpx[idx] = (re == 0.f && im == 0.f) ? 0.f : atan2f(im, re) * inv_dev;
}

__global__ void halfband_kernel(const float* __restrict__ tail, int hist,
                                const float* __restrict__ x, int m_in,
                                const float* __restrict__ taps, int K,
                                float* __restrict__ y, int m_out) {
  extern __shared__ float sx[];
  const long row = blockIdx.y;
  sdr::poly_fir_tile(tail + row * hist, hist, x, row * m_in, 0, taps, 1, 2,
                     K, y, row * m_out, 0, m_out, sx);
}

__global__ void stereo_kernel(const float* __restrict__ mpx,
                              const float* __restrict__ hist, int K, int d,
                              int m, const float* __restrict__ hr,
                              const float* __restrict__ hi, float ur,
                              float ui2, void* __restrict__ out,
                              int out_bf16, int C) {
  extern __shared__ float sm[];
  float* sx = sm;                    // ext[n0 .. n0 + ST_TILE + K)
  float* shr = sx + ST_TILE + K;
  float* shi = shr + K;
  const int c = blockIdx.y;
  const int n0 = blockIdx.x * ST_TILE;
  for (int t = threadIdx.x; t < ST_TILE + K; t += blockDim.x) {
    const int e = n0 + t;
    float v = 0.f;
    if (e < K) {
      v = hist[static_cast<long>(c) * K + e];
    } else if (e - K < m) {
      v = mpx[static_cast<long>(c) * m + e - K];
    }
    sx[t] = v;
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    shr[k] = hr[k];
    shi[k] = hi[k];
  }
  __syncthreads();
  const int n = n0 + threadIdx.x;
  if (n >= m) return;
  const float* w = sx + threadIdx.x;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < K; ++k) {
    a = fmaf(w[k], shr[k], a);
    b = fmaf(w[k], shi[k], b);
  }
  const float lpr = w[K - d];
  const float m2 = a * a + b * b;
  const float wsub =
      (ur * (a * a - b * b) + ui2 * (a * b)) / fmaxf(m2, 1e-20f);
  const float two = 2.f * wsub;
  sdr::st(out, static_cast<long>(c) * m + n, lpr * (1.f + two), out_bf16);
  sdr::st(out, static_cast<long>(C + c) * m + n, lpr * (1.f - two), out_bf16);
}

}  // namespace

extern "C" int sdr_wfm_quad(const void* iq, int iq_bf16, int stride, int C,
                            int m_if, const float* qprev, float inv_dev,
                            float* mpx, cudaStream_t stream) {
  const long n = static_cast<long>(C) * m_if;
  const int grid = static_cast<int>((n + QUAD_THREADS - 1) / QUAD_THREADS);
  quad_kernel<<<grid, QUAD_THREADS, 0, stream>>>(iq, iq_bf16, stride, C,
                                                 m_if, qprev, inv_dev, mpx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sdr_wfm_halfband(const float* tail, int hist, const float* x,
                                int m_in, const float* taps, int K, float* y,
                                int m_out, int rows, cudaStream_t stream) {
  const size_t smem = sdr::poly_span(1, 2, K) * sizeof(float);
  const dim3 grid((m_out + sdr::POLY_TILE - 1) / sdr::POLY_TILE, rows);
  halfband_kernel<<<grid, sdr::POLY_TILE, smem, stream>>>(tail, hist, x, m_in,
                                                          taps, K, y, m_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sdr_wfm_stereo(const float* mpx, const float* hist, int K,
                              int d, int m, const float* hr, const float* hi,
                              float ur, float ui2, void* out, int out_bf16,
                              int C, cudaStream_t stream) {
  if (d > K) return cudaErrorInvalidValue;
  const size_t smem = (ST_TILE + 3 * static_cast<size_t>(K)) * sizeof(float);
  const dim3 grid((m + ST_TILE - 1) / ST_TILE, C);
  stereo_kernel<<<grid, ST_TILE, smem, stream>>>(mpx, hist, K, d, m, hr, hi,
                                                 ur, ui2, out, out_bf16, C);
  return static_cast<int>(cudaGetLastError());
}
