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
// next-call state x[m_if − 1], [ftail | d][m_if, m_if + Kf − 1) and
// [ptail | u][m_if, m_if + hp), rounded to the handoff dtype.  d is 0 from
// m_if on, so u is exactly 0 from n_u = m_if + Kf − 1 on (each of its
// fused multiply-adds adds +0 to +0): u is computed on [0, n_u) only.
//
// What bounds it on the H100: the 304-tap audio FIR at the IF rate
// (2·304 flops an IF sample, 0.4 GFLOP per 0.1 s block at C = 128, 5.8 µs
// at the FP32 peak) and the polyphase (2·79 nonzero taps an audio
// sample); the IF in (2.6 MB in bf16) and the audio out are a few µs of
// HBM time.  Both stages run the polyphase FIR tile (fir_tile.cuh): the
// discriminator in the audio FIR's staging hook (as K2 runs its own in
// its first halfband's), the FIR on the tile's D = 1 register ring, the
// polyphase on its nested loop over each phase row's nonzero band.  Two
// launches on ops/demod_kernel.py:fm_plan's grids, sdr_fm_audio_fir then
// sdr_fm_audio_poly, u through an HBM scratch [C, n_u] (1.3-2.7 MB,
// L2-resident).
// Every output sums its taps in ascending order, one fused multiply-add
// each, and the discriminator keeps its expression: audio, u, d and the
// tails are the bits of the one-thread-an-output kernel this replaces.
// The tails are written by the block that stages them: the one whose
// outputs hold index m_if (the FIR launch), and, for the polyphase tail,
// each row's first block.
#include <cfloat>

#include "fir_tile.cuh"

namespace {

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

// The launch's gated IF: what every block needs to find its channel's.
struct Gated {
  const void* iq;
  int iq_bf16, stride, m_if, C;
  const float* gate;
  const float* qprev;     // [2C]: x[−1], re then im
};

// The audio FIR's staging hook: ext sample e is the carried FIR tail's
// (e < hist) or the discriminator's output d[n], n = e − hist.
struct DiscSrc {
  const void* iq;
  int iq_bf16, m_if;
  long rr, ri;            // the channel's re and im rows in iq
  float g, qr, qi, inv_dev;
  const float* tail;
  int hist;
  float* probe;           // where non-null, d[n] is stored there too

  __device__ DiscSrc(const Gated& x, int c, float inv_dev_,
                     const float* ftail, int hist_, float* probe_)
      : iq(x.iq), iq_bf16(x.iq_bf16), m_if(x.m_if),
        rr(static_cast<long>(c) * x.stride),
        ri(static_cast<long>(x.C + c) * x.stride), g(x.gate[c]),
        qr(x.qprev[c]), qi(x.qprev[x.C + c]), inv_dev(inv_dev_),
        tail(ftail + static_cast<long>(c) * hist_), hist(hist_),
        probe(probe_) {}

  __device__ __forceinline__ float disc(long n) const {
    float er = 0.f, ei = 0.f, erp, eip;
    if (n < m_if) {
      er = __fmul_rn(sdr::ld(iq, rr + n, iq_bf16), g);
      ei = __fmul_rn(sdr::ld(iq, ri + n, iq_bf16), g);
    }
    if (n == 0) {
      erp = qr;
      eip = qi;
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
    return __fmul_rn(atan2_poly(im, re), inv_dev);
  }

  __device__ __forceinline__ void operator()(float* d, long e) const {
    if (e < hist) {
      sdr::stage(d, tail + e);
    } else {
      *d = disc(e - hist);
      if (probe) probe[e - hist] = *d;
    }
  }

  // x[m_if − 1] (m_if >= 1)
  __device__ __forceinline__ float2 last() const {
    return make_float2(__fmul_rn(sdr::ld(iq, rr + m_if - 1, iq_bf16), g),
                       __fmul_rn(sdr::ld(iq, ri + m_if - 1, iq_bf16), g));
  }
};

// The polyphase's staging hook over u in HBM: ext = [ptail (hist) | u
// (n_u) | 0 ...].
struct ScratchSrc {
  const float* tail;
  int hist;
  const float* u;
  int n_u;
  __device__ __forceinline__ float value(long e) const {
    return e < hist ? tail[e] : e - hist < n_u ? u[e - hist] : 0.f;
  }
  __device__ __forceinline__ void operator()(float* d, long e) const {
    if (e < hist)
      sdr::stage(d, tail + e);
    else if (e - hist < n_u)
      sdr::stage(d, u + (e - hist));
    else
      *d = 0.f;
  }
};

// The store hook: audio in its storage dtype.
struct StoreAudio {
  void* y;
  long base;
  int bf16;
  __device__ __forceinline__ void operator()(long i, float v) const {
    sdr::st(y, base + i, v, bf16);
  }
};

// The next-call polyphase tail [C, hist]: ext_p[m_if + t], rounded.
__device__ __forceinline__ void write_ptail(const ScratchSrc& src, int m_if,
                                            float* np, int tail_bf16) {
  for (int t = threadIdx.x; t < src.hist; t += blockDim.x)
    np[t] = sdr::bf16_round_if(src.value(static_cast<long>(m_if) + t),
                               tail_bf16);
}

// The next-call quad sample and audio FIR tail from a block whose staged
// FIR input (sx: ext_f from index e0 on) holds [m_if, m_if + Kf − 1).
__device__ __forceinline__ void write_ftails(const DiscSrc& src, int c, int C,
                                             const float* sx, long e0,
                                             float* nq, float* nf,
                                             int tail_bf16) {
  if (threadIdx.x == 0) {
    const float2 q = src.last();
    nq[c] = sdr::bf16_round_if(q.x, tail_bf16);
    nq[C + c] = sdr::bf16_round_if(q.y, tail_bf16);
  }
  float* row = nf + static_cast<long>(c) * src.hist;
  for (int t = threadIdx.x; t < src.hist; t += blockDim.x)
    row[t] = sdr::bf16_round_if(sx[src.m_if + t - e0], tail_bf16);
}

// Launch 1 of 2, grid (chunks, 1, C): u [C, n_u] on fm_plan's "fir"
// grid, and the quad and FIR tails (the block whose outputs hold m_if).
template <int P>
__global__ void fir_kernel(Gated x, const float* __restrict__ ftail,
                           const float* __restrict__ hf, int Kf,
                           float inv_dev, float* __restrict__ u, int n_u,
                           float* __restrict__ nq, float* __restrict__ nf,
                           int tail_bf16, float* __restrict__ probe, int Cc) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.z;
  const DiscSrc src(x, c, inv_dev, ftail, Kf - 1,
                    probe ? probe + static_cast<long>(c) * n_u : nullptr);
  const int per = Cc * 32 * P;
  const int m0 = blockIdx.x * per;
  sdr::fir_tile<P, float>(src, hf, 1, 1, Kf,
                          sdr::StoreTo<float>{u + static_cast<long>(c) * n_u},
                          n_u, m0, min(per, n_u - m0), 1, Cc, smem);
  if (static_cast<int>(blockIdx.x) ==
      min(x.m_if / per, static_cast<int>(gridDim.x) - 1)) {
    const sdr::FirLayout f = sdr::fir_tile_layout(1, Kf, n_u, P, 1, Cc, 1);
    write_ftails(src, c, x.C, smem + f.in, m0, nq, nf, tail_bf16);
  }
}

// Launch 2 of 2, grid (chunks, phase groups, C): audio from [ptail | u]
// on fm_plan's "poly" grid (fir_plan's), and the polyphase tail (each
// row's first block).
template <int P>
__global__ void poly_kernel(const float* __restrict__ ptail, int hp,
                            const float* __restrict__ u, int n_u,
                            const float* __restrict__ ker, int I, int D,
                            int kw, void* __restrict__ audio, int out_bf16,
                            int n_m, int m_if, float* __restrict__ np,
                            int tail_bf16, int G, int Cc) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.z;
  const ScratchSrc src{ptail + static_cast<long>(c) * hp, hp,
                       u + static_cast<long>(c) * n_u, n_u};
  const int per = Cc * 32 * P;
  const int m0 = blockIdx.x * per;
  sdr::fir_tile<P, float>(
      src, ker, I, D, kw,
      StoreAudio{audio, static_cast<long>(c) * n_m * I, out_bf16}, n_m, m0,
      min(per, n_m - m0), G, Cc, smem);
  if (blockIdx.x == 0 && blockIdx.y == 0)
    write_ptail(src, m_if, np + static_cast<long>(c) * hp, tail_bf16);
}

bool bad_plan(int P, int C, int warps) {
  return (P != 1 && P != 3 && P != 5) || C < 1 || warps < 1 || warps > 32;
}

}  // namespace

// The first launch.  iq [2C, stride] (iq_bf16), m_if >= 1, gate [C],
// qprev [2C], ftail [C, Kf − 1] (float32, rounded by the caller),
// hf [Kf]; u [C, n_u] float32, n_u = min(n_if, m_if + Kf − 1); nq [2C],
// nf [C, Kf − 1] (tail_bf16: rounded to bf16); probe [C, n_u] or null
// (d, for the checks).  P, Cc and warps are ops/demod_kernel.py:fm_plan's.
extern "C" int sdr_fm_audio_fir(const void* iq, int iq_bf16, int stride,
                                int m_if, const float* gate,
                                const float* qprev, const float* ftail,
                                const float* hf, int Kf, float inv_dev,
                                float* u, int n_u, float* nq, float* nf,
                                int tail_bf16, float* probe, int C, int P,
                                int Cc, int warps, cudaStream_t stream) {
  if (C < 1 || C > 65535 || Kf < 2 || m_if < 1 || m_if > stride ||
      n_u < m_if || bad_plan(P, Cc, warps))
    return cudaErrorInvalidValue;
  const int per = Cc * 32 * P;
  const dim3 grid((n_u + per - 1) / per, 1, C);
  const size_t smem =
      sdr::fir_tile_layout(1, Kf, n_u, P, 1, Cc, 1).total * sizeof(float);
  const Gated x{iq, iq_bf16, stride, m_if, C, gate, qprev};
  return static_cast<int>(sdr::fir_launch_p(
      P, fir_kernel<1>, fir_kernel<3>, fir_kernel<5>, grid, warps, smem,
      stream, x, ftail, hf, Kf, inv_dev, u, n_u, nq, nf, tail_bf16, probe,
      Cc));
}

// The second.  ptail [C, hp], hp = kw − D (rounded by the caller); u
// [C, n_u] (read as 0 past n_u); ker [I, kw]; audio [C, n_aud] float32 or
// bf16 (out_bf16), n_aud a multiple of I; np [C, hp].  P, G, Cc
// and warps are fm_plan's (fir_plan's).
extern "C" int sdr_fm_audio_poly(const float* ptail, int hp, const float* u,
                                 int n_u, const float* ker, int I, int D,
                                 int kw, void* audio, int out_bf16, int n_aud,
                                 int m_if, float* np, int tail_bf16, int C,
                                 int P, int G, int Cc, int warps,
                                 cudaStream_t stream) {
  if (C < 1 || C > 65535 || I < 1 || D < 1 || hp != kw - D || hp < 1 ||
      n_aud < I || n_aud % I || m_if > n_u || G < 1 || G > I ||
      bad_plan(P, Cc, warps))
    return cudaErrorInvalidValue;
  const int n_m = n_aud / I;
  const int per = Cc * 32 * P;
  const dim3 grid((n_m + per - 1) / per, (I + G - 1) / G, C);
  const size_t smem =
      sdr::fir_tile_layout(D, kw, n_m, P, G, Cc, 1).total * sizeof(float);
  return static_cast<int>(sdr::fir_launch_p(
      P, poly_kernel<1>, poly_kernel<3>, poly_kernel<5>, grid, warps, smem,
      stream, ptail, hp, u, n_u, ker, I, D, kw, audio, out_bf16, n_m, m_if,
      np, tail_bf16, G, Cc));
}
