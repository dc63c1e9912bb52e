// K2 — broadcast-FM demodulator: discriminator, MPX halfbands, stereo.
//
// Replaces: sdrplusplusbrown_tpu/ops/wfm_kernel.py:_wfm_kernel (quad +
// MPX predecimation + stereo section in one sequential-grid Pallas
// kernel), with the stereo identities of ops/pallas_wfm.py.
//
// What it computes, per channel c, on the IF planes [2C, stride] (re rows
// then im rows, float32 or bfloat16 storage), in three launches:
//   sdr_wfm_quad_halfband: the discriminator
//       mpx0[n] = arg(x[n]·conj(x[n−1])) · inv_dev,  x[−1] = the carried
//       sample; exact 0 for a 0 product, subnormal parts counting as 0
//       (the TPU flushes them; the cold-start IF ramps through
//       subnormals); atan2f stands in for the TPU's minimax polynomial
//       (both within 2.4e-7 rad of the true angle)
//     and the first MPX decimate-by-2 FIR, y[j] = Σ_k ext[2j+k]·h[k] over
//     ext = concat(carried K−1 inputs, mpx0): the discriminator runs in
//     the FIR tile's staging hook (QuadSrc), so mpx0 never leaves the SM.
//   sdr_wfm_halfband: the second MPX halfband, the same FIR on the first's
//     output.
//   sdr_wfm_stereo: with ext = concat(mpx_hist (last K MPX samples), mpx)
//     the lagged pilot p[n−1] = (a, b) = Σ_k ext[n+k]·h_p[k] (159 complex
//     taps), u = conj(pilot_phase_corr)²,
//     w = (Re u·(a²−b²) + 2·Im u·ab) / max(a²+b², 1e−20),
//     L/R = ext[n+K−d]·(1 ± 2w).
// Each launch also writes its carried state, rounded to the handoff dtype
// where that is bf16: the last IF sample (quad), each halfband's last K−1
// inputs, the last K MPX samples (mpx_hist); it reads the carried state
// rounded the same way.
//
// K10 is sdr_wfm_stereo launched alone (ops/wfm_kernel.py:wfm_stereo), on
// the MPX of batched radios' per-stage chain (Radio.apply).  It replaces
// sdrplusplusbrown_tpu/ops/pallas_wfm.py:_wfm_stereo_kernel, the same
// stereo identities over an [C, K + T] MPX extension.
//
// What bounds it on the H100: ~2·(26/2 + 105/4) real and 2·159/4 complex
// multiply-adds per IF sample and channel, one atan2f; 4K + 12 operations
// per MPX sample for the stereo section (65 Mflop at C = 8, T = 12 500:
// ~1 µs); a few MB of traffic a 0.1 s block: the bound is ~1.5 µs, the
// operations'.  The design: the halfbands are the polyphase FIR tile
// (fir_tile.cuh) at D = 2, its register ring; the stereo section is the
// tile's D = 1 ring with a float2 tap (the pilot's re and im rows) on the
// MPX, two accumulators an output, the taps broadcast from shared memory,
// P consecutive outputs a lane, then the L/R matrix from the staged MPX.
// Each launch lasts a few µs, so latency bounds it: the grid
// (ops/wfm_kernel.py:demod_plan) takes more, smaller blocks than the FIR
// tile's K8 plan, P = 3 and 1-4 chunks of 32·P outputs a block.  Every
// output sums its taps in ascending order, one fmaf a tap, and the
// discriminator and the matrix keep their expressions: the outputs are
// the bits of the one-thread-an-output kernels this replaces.
#include <cfloat>

#include "fir_tile.cuh"

namespace {

// The first halfband's staging hook: ext sample e is the carried tail's
// (e < hist) or the discriminator's output at IF sample n = e − hist.
struct QuadSrc {
  const void* iq;
  int iq_bf16;
  long rr, ri;        // the channel's re and im rows in iq
  float qr, qi;       // x[−1], the carried sample
  float inv_dev;
  const float* tail;
  int hist, h_bf16;
  float* probe;       // where non-null, mpx0[n] is stored there too
  __device__ __forceinline__ float quad(long n) const {
    const float er = sdr::ld(iq, rr + n, iq_bf16);
    const float ei = sdr::ld(iq, ri + n, iq_bf16);
    const float erp = n ? sdr::ld(iq, rr + n - 1, iq_bf16) : qr;
    const float eip = n ? sdr::ld(iq, ri + n - 1, iq_bf16) : qi;
    float re = er * erp + ei * eip;
    float im = ei * erp - er * eip;
    if (fabsf(re) < FLT_MIN) re = 0.f;
    if (fabsf(im) < FLT_MIN) im = 0.f;
    return (re == 0.f && im == 0.f) ? 0.f : atan2f(im, re) * inv_dev;
  }
  __device__ __forceinline__ void operator()(float* d, long e) const {
    if (e < hist) {
      *d = sdr::bf16_round_if(tail[e], h_bf16);
    } else {
      *d = quad(e - hist);
      if (probe) probe[e - hist] = *d;
    }
  }
};

// grid (chunks, 1, C).  y [C, m_out]; the row's new tail (and, block 0,
// thread 0, its new carried IF sample) are written by its first block.
template <int P>
__global__ void quad_halfband_kernel(
    const void* __restrict__ iq, int iq_bf16, int stride, int m_if,
    const float2* __restrict__ quad, float inv_dev,
    const float* __restrict__ tail, int hist, const float* __restrict__ taps,
    int K, float* __restrict__ y, int m_out, int h_bf16,
    float2* __restrict__ new_quad, float* __restrict__ new_tail,
    float* __restrict__ probe, int Cc) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.z, C = gridDim.z;
  const float2 q = sdr::bf16_round_if(quad[c], h_bf16);
  const QuadSrc src{iq, iq_bf16, static_cast<long>(c) * stride,
                    static_cast<long>(C + c) * stride, q.x, q.y, inv_dev,
                    tail + c * hist, hist, h_bf16,
                    probe ? probe + static_cast<long>(c) * m_if : nullptr};
  const int m0 = blockIdx.x * Cc * 32 * P;
  sdr::fir_tile<P, float>(src, taps, 1, 2, K,
                          sdr::StoreTo<float>{y + static_cast<long>(c) * m_out},
                          m_out, m0, min(Cc * 32 * P, m_out - m0), 1, Cc,
                          smem);
  if (blockIdx.x == 0) {
    // the last K − 1 samples of ext (the probe's last, which no output
    // reads, among them)
    float* nt = new_tail + c * hist;
    for (int e = threadIdx.x; e < hist; e += blockDim.x) {
      float v;
      src(&v, static_cast<long>(m_if) + e);
      nt[e] = sdr::bf16_round_if(v, h_bf16);
    }
    if (threadIdx.x == 0)
      new_quad[c] = make_float2(
          sdr::bf16_round_if(sdr::ld(iq, src.rr + m_if - 1, iq_bf16), h_bf16),
          sdr::bf16_round_if(sdr::ld(iq, src.ri + m_if - 1, iq_bf16), h_bf16));
  }
}

template <int P>
__global__ void halfband_kernel(const float* __restrict__ tail, int hist,
                                int bf16, const float* __restrict__ x,
                                int m_in, const float* __restrict__ taps,
                                int K, float* __restrict__ y, int m_out,
                                float* __restrict__ new_tail, int Cc) {
  extern __shared__ __align__(16) float smem[];
  const long c = blockIdx.z;
  const float* tr = tail + c * hist;
  const float* xr = x + c * m_in;
  const int m0 = blockIdx.x * Cc * 32 * P;
  sdr::fir_tile<P, float>(sdr::RoundedTailThen<float>{tr, hist, bf16, xr},
                          taps, 1, 2, K,
                          sdr::StoreTo<float>{y + c * m_out}, m_out, m0,
                          min(Cc * 32 * P, m_out - m0), 1, Cc, smem);
  if (blockIdx.x == 0) {
    float* nt = new_tail + c * hist;
    for (int e = threadIdx.x; e < hist; e += blockDim.x) {
      const long s = static_cast<long>(m_in) + e;      // ext index
      nt[e] = sdr::bf16_round_if(s < hist ? tr[s] : xr[s - hist], bf16);
    }
  }
}

// Shared-memory floats of a stereo block: the taps as float2 [K], the MPX
// span ext[n0 .. n0 + mb + K) (+ P: lanes past the last output read and
// discard P samples more), the L and R tiles [mb] each.
__host__ __device__ inline int stereo_smem(int K, int mb, int P) {
  return sdr::fir_r4(2 * K) + sdr::fir_r4(mb + K + P) + 2 * sdr::fir_r4(mb);
}

// grid (chunks, C).  out: L rows then R rows, [2C, m] (float32 or bf16);
// new_hist [C, K] (written by each row's first block where non-null).
template <int P>
__global__ void stereo_kernel(const float* __restrict__ mpx,
                              const float* __restrict__ hist, int h_bf16,
                              int K, int d, int m,
                              const float* __restrict__ hr,
                              const float* __restrict__ hi, float ur,
                              float ui2, void* __restrict__ out, int out_bf16,
                              float* __restrict__ new_hist, int Cc) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.y, C = gridDim.y;
  const int per = Cc * 32 * P;
  const int n0 = blockIdx.x * per, nb = min(per, m - n0);
  float2* taps = reinterpret_cast<float2*>(smem);
  float* sx = smem + sdr::fir_r4(2 * K);
  float* oL = sx + sdr::fir_r4(per + K + P);
  float* oR = oL + sdr::fir_r4(per);
  const float* hc = hist + static_cast<long>(c) * K;
  const float* xc = mpx + static_cast<long>(c) * m;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    taps[k] = make_float2(hr[k], hi[k]);
  for (int t = threadIdx.x; t < nb + K; t += blockDim.x) {
    const int e = n0 + t;
    sx[t] = e < K ? sdr::bf16_round_if(hc[e], h_bf16) : xc[e - K];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int u = warp; u < Cc; u += blockDim.x >> 5) {
    const int mm0 = u * 32 * P + lane * P;
    if (mm0 >= nb) continue;
    float2 acc[P] = {};
    sdr::taps_ring<P, 1>(acc, sx + mm0, taps, 0, 0, K);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (mm0 + j < nb) {
        const float a = acc[j].x, b = acc[j].y;
        const float lpr = sx[mm0 + j + K - d];
        const float m2 = a * a + b * b;
        const float wsub =
            (ur * (a * a - b * b) + ui2 * (a * b)) / fmaxf(m2, 1e-20f);
        const float two = 2.f * wsub;
        oL[mm0 + j] = lpr * (1.f + two);
        oR[mm0 + j] = lpr * (1.f - two);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    sdr::st(out, static_cast<long>(c) * m + n0 + i, oL[i], out_bf16);
    sdr::st(out, static_cast<long>(C + c) * m + n0 + i, oR[i], out_bf16);
  }
  if (new_hist && blockIdx.x == 0) {
    for (int e = threadIdx.x; e < K; e += blockDim.x) {
      const int s = m + e;                               // ext index
      new_hist[static_cast<long>(c) * K + e] =
          sdr::bf16_round_if(s < K ? hc[s] : xc[s - K], h_bf16);
    }
  }
}

bool bad_plan(int P, int Cc, int warps) {
  return (P != 1 && P != 3 && P != 5) || Cc < 1 || warps < 1 || warps > 32;
}

}  // namespace

// The discriminator and the first halfband.  iq [2C, stride] (iq_bf16),
// m_if <= stride; quad [C] complex64 (x[−1]); tail [C, hist] float32,
// hist = K − 1; taps [K]; y [C, m_out] float32, m_out = m_if / 2;
// new_quad [C] complex64, new_tail [C, hist]; probe [C, m_if] or null (the
// discriminator's output, for the checks).  h_bf16: the carried state is
// bf16 (read and written rounded).  P, Cc and warps are
// ops/wfm_kernel.py:demod_plan's.
extern "C" int sdr_wfm_quad_halfband(
    const void* iq, int iq_bf16, int stride, int C, int m_if,
    const void* quad, float inv_dev, const float* tail, int hist,
    const float* taps, int K, float* y, int m_out, int h_bf16,
    void* new_quad, float* new_tail, float* probe, int P, int Cc, int warps,
    cudaStream_t stream) {
  if (C < 1 || C > 65535 || m_if < 1 || m_if > stride || hist != K - 1 ||
      K < 2 || m_out < 1 || 2 * (m_out - 1) + K > hist + m_if ||
      bad_plan(P, Cc, warps))
    return cudaErrorInvalidValue;
  const int per = Cc * 32 * P;
  const dim3 grid((m_out + per - 1) / per, 1, C);
  const size_t smem =
      sdr::fir_tile_layout(2, K, m_out, P, 1, Cc, 1).total * sizeof(float);
  return static_cast<int>(sdr::fir_launch_p(
      P, quad_halfband_kernel<1>, quad_halfband_kernel<3>,
      quad_halfband_kernel<5>, grid, warps, smem, stream, iq, iq_bf16, stride,
      m_if, static_cast<const float2*>(quad), inv_dev, tail, hist, taps, K, y,
      m_out, h_bf16, static_cast<float2*>(new_quad), new_tail, probe, Cc));
}

// The second halfband.  tail [C, hist] (bf16: rounded on read and write),
// x [C, m_in], taps [K], y [C, m_out] float32, new_tail [C, hist].
extern "C" int sdr_wfm_halfband(const float* tail, int hist, int bf16,
                                const float* x, int m_in, const float* taps,
                                int K, float* y, int m_out, int C,
                                float* new_tail, int P, int Cc, int warps,
                                cudaStream_t stream) {
  if (C < 1 || C > 65535 || hist != K - 1 || K < 2 || m_out < 1 ||
      2 * (m_out - 1) + K > hist + m_in || bad_plan(P, Cc, warps))
    return cudaErrorInvalidValue;
  const int per = Cc * 32 * P;
  const dim3 grid((m_out + per - 1) / per, 1, C);
  const size_t smem =
      sdr::fir_tile_layout(2, K, m_out, P, 1, Cc, 1).total * sizeof(float);
  return static_cast<int>(sdr::fir_launch_p(
      P, halfband_kernel<1>, halfband_kernel<3>, halfband_kernel<5>, grid,
      warps, smem, stream, tail, hist, bf16, x, m_in, taps, K, y, m_out,
      new_tail, Cc));
}

// The stereo section.  mpx [C, m] float32, hist [C, K] (h_bf16: read
// rounded to bf16, and new_hist written so), hr/hi [K]; out [2C, m]
// float32 or bf16 (out_bf16); new_hist [C, K] or null.  P, Cc and warps
// are ops/wfm_kernel.py:demod_plan's.
extern "C" int sdr_wfm_stereo(const float* mpx, const float* hist, int h_bf16,
                              int K, int d, int m, const float* hr,
                              const float* hi, float ur, float ui2, void* out,
                              int out_bf16, float* new_hist, int C, int P,
                              int Cc, int warps, cudaStream_t stream) {
  if (d > K || d < 0 || K < 1 || m < 1 || C < 1 || C > 65535 ||
      bad_plan(P, Cc, warps))
    return cudaErrorInvalidValue;
  const int per = Cc * 32 * P;
  const dim3 grid((m + per - 1) / per, C);
  const size_t smem = stereo_smem(K, per, P) * sizeof(float);
  return static_cast<int>(sdr::fir_launch_p(
      P, stereo_kernel<1>, stereo_kernel<3>, stereo_kernel<5>, grid, warps,
      smem, stream, mpx, hist, h_bf16, K, d, m, hr, hi, ur, ui2, out,
      out_bf16, new_hist, Cc));
}
