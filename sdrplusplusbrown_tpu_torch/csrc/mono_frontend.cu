// K1 — shared-VFO front end.
//
// Replaces: sdrplusplusbrown_tpu/ops/mono_frontend.py:_mono_kernel (the
// TPU's whole decimation chain in one sequential-grid Pallas kernel).
//
// What it computes, per channel c of C VFOs on one shared wideband:
//   stage 0  (sdr_mono_mix): mix by the channel's NCO and decimate
//            through the channel-independent real FIR h0 (K0 taps, D0):
//              y0[c, m] = sum_k h0[k] * x[p] * e^{j theta_c(p)},
//              p = m*D0 + k - (K0-1)   (p < 0: the carried raw tail)
//            theta_c(p) = base[c, i, u] + omega_c * j, the TPU kernel's
//            mix phase: i = m / adv0 is the TPU grid window of output m,
//            t = p + 1024 - i*adv_x its window-relative position, u = t/1024,
//            j = t % 1024, and base[] the per-(window, 1024-block) phase
//            table the wrapper builds from the host-float64 params.  A
//            plain float32 theta = phi0 + omega*n loses ~1e-2 rad by the
//            end of a 240 000-sample block.
//   stages 1.. (sdr_mono_stage): the chained polyphase resampler and
//            bandwidth FIR on C complex rows, each the widened polyphase
//            FIR (a decimating FIR is interp = 1); the last writes the
//            handoff planes [2C, m_if] (re rows, then im rows, float32 or
//            bf16).  Each stage also writes its new carried tail, the last
//            ``hist`` samples of concat(tail, input), rounded to the tail
//            dtype (bf16 or float32).
//
// What bounds it on the H100: stage 0 does K0 (304 at WFM-8) complex
// multiply-adds an output and one sincosf an input sample, ~0.6 GFLOP at
// WFM-8 (C = 8, T = 240 000): ~9 µs at the non-tensor float32 peak; the
// chained stages' bound is 0.3-6 µs a launch; the bytes are a few MB.
// The design: every stage is the polyphase FIR tile (fir_tile.cuh) on
// complex float2 rows (the taps are real: re and im share each tap read).
// Stage 0's staging hook (MixSrc) stages the block's wideband span by
// cp.async, then mixes each sample by the channel's NCO in place, so a
// block computes each sincosf once, with no load in its dependency chain
// (the one-thread-an-output kernel this replaces recomputed its whole
// span for every channel, then ran a serial 304-tap loop in 4-way
// conflicted shared memory).  Stage 0's grid is (output chunk, channel):
// a block's outputs never straddle a TPU window, because the K0 - D0
// samples two windows share are mixed at two base phases, one per
// window (ops/mono_frontend.py:mix_plan).  Rounding is pinned: the phase
// is __fmul_rn then __fadd_rn (a fused multiply-add moves it by an ulp of
// a ~1e3 rad sum, ~40 dB of agreement), the complex product two rounded
// products and a rounded sum each, as the plain version's elementwise
// ops round; each output sums its taps in ascending order, one fmaf a
// tap.  The stages stay 1 + len(stages) launches: the TPU's one-pass
// chain (each stage's tail in VMEM) is later work.
#include "fir_tile.cuh"

namespace {

// Stage 0's staging hook: ext sample e is the wideband sample p = e -
// (K0 - 1) (p < 0: the carried raw tail) times e^{j theta} at the block's
// window (tw = e + tw_off is its window-relative position).  Two passes:
// the raw sample by cp.async, then, once it has landed, the mix in place.
struct MixSrc {
  const float* xr;
  const float* xi;
  const float2* tail;
  int K0;
  const float* bc;   // base[c, i, :]
  float om;
  long tw_off;
  __device__ __forceinline__ void operator()(float2* d, long e) const {
    const long p = e - (K0 - 1);
    if (p < 0) {
      sdr::cp_async(d, tail + e);
    } else {
      sdr::cp_async(&d->x, xr + p);
      sdr::cp_async(&d->y, xi + p);
    }
  }
  __device__ __forceinline__ void finish(float2* d, long e) const {
    const float a = d->x, b = d->y;
    const int tw = static_cast<int>(e + tw_off);
    const float ang =
        __fadd_rn(bc[tw >> 10], __fmul_rn(om, static_cast<float>(tw & 1023)));
    float s, co;
    sincosf(ang, &s, &co);
    *d = make_float2(__fsub_rn(__fmul_rn(a, co), __fmul_rn(b, s)),
                     __fadd_rn(__fmul_rn(a, s), __fmul_rn(b, co)));
  }
};

// A chained stage's store hook: float2 rows, or (the last stage) the re
// and im planes of the handoff, float32 or bf16.
struct StageOut {
  void* y;
  int planes, bf16;
  long re, im;     // the row's offsets
  __device__ __forceinline__ void operator()(long i, float2 v) const {
    if (!planes) {
      static_cast<float2*>(y)[re + i] = v;
    } else {
      sdr::st(y, re + i, v.x, bf16);
      sdr::st(y, im + i, v.y, bf16);
    }
  }
};

// grid (blocks over the windows, 1, C): block x is chunk x % bpw of window
// x / bpw, mb outputs (fewer at a window's end).
template <int P>
__global__ void mix_kernel(const float* __restrict__ xr,
                           const float* __restrict__ xi,
                           const float2* __restrict__ tail,
                           const float* __restrict__ taps, int K0, int D0,
                           const float* __restrict__ omega,
                           const float* __restrict__ base, int n_super,
                           int nbw, int adv0, int adv_x, int m0, int bpw,
                           float2* __restrict__ y, int Cc) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.z;
  const int w = blockIdx.x / bpw;
  const int lo = w * adv0 + (blockIdx.x - w * bpw) * Cc * 32 * P;
  const int mb = min(Cc * 32 * P, min((w + 1) * adv0, m0) - lo);
  const MixSrc src{xr, xi, tail, K0,
                   base + (static_cast<long>(c) * n_super + w) * nbw,
                   omega[c],
                   1024 - (K0 - 1) - static_cast<long>(w) * adv_x};
  sdr::fir_tile<P, float2>(src, taps, 1, D0, K0,
                           sdr::StoreTo<float2>{y + static_cast<long>(c) * m0},
                           m0, lo, mb, 1, Cc, smem);
}

template <int P>
__global__ void stage_kernel(const float2* __restrict__ tail, int hist,
                             int tail_bf16, const float2* __restrict__ x,
                             int m_in, const float* __restrict__ kern, int I,
                             int D, int kw, void* __restrict__ y, int planes,
                             int y_bf16, int n_m, float2* __restrict__ new_tail,
                             int G, int Cc) {
  extern __shared__ __align__(16) float smem[];
  const long c = blockIdx.z, rows = gridDim.z;
  const long n_out = static_cast<long>(n_m) * I;
  const float2* tr = tail + c * hist;
  const float2* xr = x + c * m_in;
  const int m0 = blockIdx.x * Cc * 32 * P;
  const StageOut dst{y, planes, y_bf16, c * n_out, (rows + c) * n_out};
  sdr::fir_tile<P, float2>(
      sdr::RoundedTailThen<float2>{tr, hist, tail_bf16, xr}, kern, I, D, kw,
      dst, n_m, m0, min(Cc * 32 * P, n_m - m0), G, Cc, smem);
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    float2* nt = new_tail + c * hist;
    for (int e = threadIdx.x; e < hist; e += blockDim.x) {
      const long s = static_cast<long>(m_in) + e;      // ext index
      nt[e] = sdr::bf16_round_if(s < hist ? tr[s] : xr[s - hist], tail_bf16);
    }
  }
}

}  // namespace

// Stage 0.  xr, xi [T] float32; tail [K0 - 1] complex64; taps [K0];
// omega [C]; base [C, n_super, nbw]; y [C, m0] complex64.  P, Cc and warps
// are ops/mono_frontend.py:mix_plan's: blocks of mb = Cc·32·P outputs, bpw
// = ceil(adv0 / mb) a window.
extern "C" int sdr_mono_mix(const float* xr, const float* xi, int T,
                            const void* tail, const float* taps, int K0,
                            int D0, const float* omega, const float* base,
                            int n_super, int nbw, int adv0, int adv_x, int C,
                            int m0, void* y, int P, int Cc, int warps,
                            cudaStream_t stream) {
  const int mb = Cc * 32 * P;
  // the window-relative position tw of every staged sample lies in
  // [1024 − (K0 − 1), adv_x + 1024 − D0]: base[c, i, tw >> 10] exists
  if (K0 < 1 || K0 > 1024 || D0 < 1 || m0 < 1 || C < 1 || C > 65535 ||
      adv0 < 1 || adv_x != adv0 * D0 || mb < 1 || warps < 1 || warps > 32 ||
      static_cast<long>(m0 - 1) * D0 + 1 > T ||
      (m0 + adv0 - 1) / adv0 > n_super || (adv_x + 1024 - D0) >> 10 >= nbw)
    return cudaErrorInvalidValue;
  const int bpw = (adv0 + mb - 1) / mb;
  const int n_win = (m0 + adv0 - 1) / adv0;
  const int last = m0 - (n_win - 1) * adv0;
  const dim3 grid((n_win - 1) * bpw + (last + mb - 1) / mb, 1, C);
  const size_t smem =
      sdr::fir_tile_layout(D0, K0, m0, P, 1, Cc, 2).total * sizeof(float);
  return static_cast<int>(sdr::fir_launch_p(
      P, mix_kernel<1>, mix_kernel<3>, mix_kernel<5>, grid, warps, smem,
      stream, xr, xi, static_cast<const float2*>(tail), taps, K0, D0, omega,
      base, n_super, nbw, adv0, adv_x, m0, bpw, static_cast<float2*>(y), Cc));
}

// A chained stage on C complex rows.  tail [C, hist] and x [C, m_in]
// complex64; kern [I, kw]; y [C, n_out] complex64 (y_mode 0) or the planes
// [2C, n_out] float32 (1) or bf16 (2); new_tail [C, hist] complex64, bf16
// values where tail_bf16 (which also rounds the tail read).  n_out =
// ((hist + m_in − kw)/D + 1)·I.  P, G, Cc and warps are
// ops/fir_kernel.py:fir_plan's.
extern "C" int sdr_mono_stage(const void* tail, int hist, int tail_bf16,
                              const void* x, int m_in, const float* kern,
                              int I, int D, int kw, void* y, int y_mode,
                              int n_out, int C, void* new_tail, int P, int G,
                              int Cc, int warps, cudaStream_t stream) {
  if (n_out < 1 || I < 1 || D < 1 || kw < 1 || hist < 0 || C < 1 ||
      C > 65535 || n_out % I || y_mode < 0 || y_mode > 2 ||
      static_cast<long>(n_out / I - 1) * D + kw >
          static_cast<long>(hist) + m_in ||
      G < 1 || G > I || Cc < 1 || warps < 1 || warps > 32)
    return cudaErrorInvalidValue;
  const int n_m = n_out / I, per = Cc * 32 * P;
  const dim3 grid((n_m + per - 1) / per, (I + G - 1) / G, C);
  const size_t smem =
      sdr::fir_tile_layout(D, kw, n_m, P, G, Cc, 2).total * sizeof(float);
  return static_cast<int>(sdr::fir_launch_p(
      P, stage_kernel<1>, stage_kernel<3>, stage_kernel<5>, grid, warps, smem,
      stream, static_cast<const float2*>(tail), hist, tail_bf16,
      static_cast<const float2*>(x), m_in, kern, I, D, kw, y, int(y_mode > 0),
      int(y_mode == 2), n_m, static_cast<float2*>(new_tail), G, Cc));
}
