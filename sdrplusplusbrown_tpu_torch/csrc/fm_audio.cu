// K7 — NFM demod + audio: squelch gate, discriminator, audio low-pass FIR and
// the AF polyphase resampler, with the next-call tails.
//
// Replaces: sdrplusplusbrown_tpu/ops/demod_kernel.py:_demod_kernel (gate ×
// IF, lane-roll discriminator with a minimax atan2, banded-matmul audio FIR
// and 24/25 polyphase, histories rolled in VMEM across a sequential grid
// walked per channel chunk).
//
// What it computes, per channel c, from the raw IF buffer [2C, stride]
// (re rows over im rows, float32 or bfloat16 storage; x[n] = gate_c · IF[n]
// for n < m_if and 0 after, x[−1] the carried sample):
//   d[n]  = atan2(Im, Re)(x[n]·conj(x[n−1])) · inv_dev, with the TPU
//           kernel's degree-8 minimax atan2 (the plain version uses the same
//           polynomial, operation for operation), subnormal products
//           counting as zero (the TPU and XLA:CPU flush them) and a zero
//           product giving exact silence;
//   u[n]  = Σ_k hf[k] · [ftail | d][n + k]                 (audio FIR)
//   a[g·I + r] = Σ_l ker[r, l] · [ptail | u][g·D + l]        (I/D polyphase)
// audio [C, n_aud] (padded: outputs past m_aud come from zero IF), and the
// next-call state x[m_if − 1], d[m_if − Kf + 1, m_if), u[m_if − hp, m_if),
// rounded to the handoff dtype.  One launch covers any C: the TPU walked
// channel chunks only for its VMEM cap.
//
// As in K6, each (audio tile, channel) block stages its own d and u spans
// with the histories in front, instead of the TPU's VMEM roll; the block
// whose tile holds index m_aud writes the tails.
//
// What bounds it on the H100: the 304-tap audio FIR at the IF rate
// (2·304 flops per IF sample, about 0.4 GFLOP per 0.1 s block at C = 128)
// and the 104-tap polyphase (2·104 per audio sample): FP32 throughput; the
// IF in (2.6 MB in bf16) and the audio out are a few µs of HBM time.
// Splitting the tap loops across a warp, or tensor cores, is left for
// later work.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int AUDIO_TILE = 768;
constexpr int AUDIO_THREADS = 256;

__device__ __forceinline__ float stored(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// atan(z) = z·P(z²) on [0, 1]; the float32 values of the JAX kernel's
// _ATAN_C, one rounding per operation.
__device__ __forceinline__ float atan2_poly(float im, float re) {
  const float a = fabsf(im);
  const float b = fabsf(re);
  const float mx = fmaxf(a, b);
  const float z = __fdiv_rn(fminf(a, b), mx == 0.f ? 1.f : mx);
  const float z2 = __fmul_rn(z, z);
  float p = 0x1.438564p-9f;
  p = __fadd_rn(__fmul_rn(p, z2), -0x1.d9c91cp-7f);
  p = __fadd_rn(__fmul_rn(p, z2), 0x1.46dbc2p-5f);
  p = __fadd_rn(__fmul_rn(p, z2), -0x1.28e068p-4f);
  p = __fadd_rn(__fmul_rn(p, z2), 0x1.ae614cp-4f);
  p = __fadd_rn(__fmul_rn(p, z2), -0x1.2215e8p-3f);
  p = __fadd_rn(__fmul_rn(p, z2), 0x1.995304p-3f);
  p = __fadd_rn(__fmul_rn(p, z2), -0x1.55539p-2f);
  p = __fadd_rn(__fmul_rn(p, z2), 0x1.fffffcp-1f);
  float t = __fmul_rn(z, p);
  if (a > b) t = __fsub_rn(0x1.921fb6p+0f, t);
  if (re < 0.f) t = __fsub_rn(0x1.921fb6p+1f, t);
  if (im < 0.f) t = -t;
  return (re == 0.f && im == 0.f) ? 0.f : t;
}

__global__ void fm_audio_kernel(
    const void* __restrict__ iq, int iq_bf16, int stride, int m_if,
    const float* __restrict__ gate, const float* __restrict__ qprev,
    const float* __restrict__ ftail, const float* __restrict__ ptail,
    const float* __restrict__ hf, int Kf, const float* __restrict__ ker,
    int I, int D, int kw, float inv_dev, void* __restrict__ audio,
    int out_bf16, int n_aud, int m_aud, float* __restrict__ nq,
    float* __restrict__ nf, float* __restrict__ np, int tail_bf16, int C,
    int hp, int ld_max) {
  extern __shared__ float smem[];
  const int HF = Kf - 1;
  const int G = AUDIO_TILE / I;
  const int Lu = (G - 1) * D + kw;
  float* ds = smem;
  float* us = ds + ld_max;
  float* gf = us + Lu;
  float* gk = gf + Kf;

  const int c = blockIdx.y;
  const int a0 = blockIdx.x * AUDIO_TILE;
  const int g0 = a0 / I;
  const int ju0 = g0 * D - hp;                  // first u index
  const int dlo = max(ju0, 0) - HF;             // first d index
  const int ld = ju0 + Lu - dlo;

  for (int k = threadIdx.x; k < Kf; k += blockDim.x) gf[k] = hf[k];
  for (int k = threadIdx.x; k < I * kw; k += blockDim.x) gk[k] = ker[k];

  // ---- d: gated discriminator (old audio FIR tail for n < 0) ------------
  const float g = gate[c];
  const long rr = static_cast<long>(c) * stride;
  const long ri = static_cast<long>(C + c) * stride;
  for (int t = threadIdx.x; t < ld; t += blockDim.x) {
    const int n = dlo + t;
    float v;
    if (n < 0) {
      v = ftail[static_cast<long>(c) * HF + n + HF];
    } else {
      float er = 0.f, ei = 0.f, erp, eip;
      if (n < m_if) {
        er = __fmul_rn(sdr::ld(iq, rr + n, iq_bf16), g);
        ei = __fmul_rn(sdr::ld(iq, ri + n, iq_bf16), g);
      }
      if (n == 0) {
        erp = qprev[c];
        eip = qprev[C + c];
      } else if (n - 1 < m_if) {
        erp = __fmul_rn(sdr::ld(iq, rr + n - 1, iq_bf16), g);
        eip = __fmul_rn(sdr::ld(iq, ri + n - 1, iq_bf16), g);
      } else {
        erp = eip = 0.f;
      }
      float re = __fadd_rn(__fmul_rn(er, erp), __fmul_rn(ei, eip));
      float im = __fsub_rn(__fmul_rn(ei, erp), __fmul_rn(er, eip));
      if (fabsf(re) < FLT_MIN) re = 0.f;
      if (fabsf(im) < FLT_MIN) im = 0.f;
      v = __fmul_rn(atan2_poly(im, re), inv_dev);
    }
    ds[t] = v;
  }
  __syncthreads();

  // ---- u: audio FIR (old polyphase tail for n < 0) ----------------------
  for (int t = threadIdx.x; t < Lu; t += blockDim.x) {
    const int n = ju0 + t;
    float v = 0.f;
    if (n < 0) {
      v = ptail[static_cast<long>(c) * hp + n + hp];
    } else {
      const float* w = ds + (n - HF - dlo);
      for (int k = 0; k < Kf; ++k) v = fmaf(gf[k], w[k], v);
    }
    us[t] = v;
  }
  __syncthreads();

  // ---- audio: the I/D polyphase ------------------------------------------
  for (int t = threadIdx.x; t < AUDIO_TILE; t += blockDim.x) {
    const int o = a0 + t;
    if (o >= n_aud) break;
    const int gi = t / I;
    const int r = t - gi * I;
    const float* w = us + gi * D;
    const float* kr = gk + r * kw;
    float v = 0.f;
    for (int l = 0; l < kw; ++l) v = fmaf(kr[l], w[l], v);
    sdr::st(audio, static_cast<long>(c) * n_aud + o, v, out_bf16);
  }

  // ---- next-call state: the block whose tile holds index m_aud ----------
  if (a0 <= m_aud && m_aud < a0 + AUDIO_TILE) {
    if (threadIdx.x == 0) {
      float qr = 0.f, qi = 0.f;
      if (m_if > 0) {
        qr = __fmul_rn(sdr::ld(iq, rr + m_if - 1, iq_bf16), g);
        qi = __fmul_rn(sdr::ld(iq, ri + m_if - 1, iq_bf16), g);
      } else {
        qr = qprev[c];
        qi = qprev[C + c];
      }
      nq[c] = stored(qr, tail_bf16);
      nq[C + c] = stored(qi, tail_bf16);
    }
    for (int t = threadIdx.x; t < HF; t += blockDim.x)
      nf[static_cast<long>(c) * HF + t] =
          stored(ds[m_if - HF + t - dlo], tail_bf16);
    for (int t = threadIdx.x; t < hp; t += blockDim.x)
      np[static_cast<long>(c) * hp + t] =
          stored(us[m_if - hp + t - ju0], tail_bf16);
  }
}

}  // namespace

extern "C" int sdr_fm_audio(
    const void* iq, int iq_bf16, int stride, int m_if, const float* gate,
    const float* qprev, const float* ftail, const float* ptail,
    const float* hf, int Kf, const float* ker, int I, int D, int kw,
    float inv_dev, void* audio, int out_bf16, int n_aud, int m_aud,
    int n_tiles, float* nq, float* nf, float* np, int tail_bf16, int C,
    cudaStream_t stream) {
  const int hp = kw - D;                        // polyphase history
  if (Kf < 2 || AUDIO_TILE % I || hp < 1 || m_if > stride ||
      n_tiles * AUDIO_TILE <= m_aud || n_tiles * AUDIO_TILE < n_aud ||
      static_cast<long>(m_aud) * D != static_cast<long>(m_if) * I)
    return cudaErrorInvalidValue;
  const int Lu = (AUDIO_TILE / I - 1) * D + kw;
  const int ld_max = Lu + Kf - 1;
  const size_t smem = (static_cast<size_t>(ld_max) + Lu + Kf +
                       static_cast<size_t>(I) * kw) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fm_audio_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_tiles, C);
  fm_audio_kernel<<<grid, AUDIO_THREADS, smem, stream>>>(
      iq, iq_bf16, stride, m_if, gate, qprev, ftail, ptail, hf, Kf, ker, I,
      D, kw, inv_dev, audio, out_bf16, n_aud, m_aud, nq, nf, np, tail_bf16,
      C, hp, ld_max);
  return static_cast<int>(cudaGetLastError());
}
