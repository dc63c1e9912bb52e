// K11 — shared-wideband mix-down folded into the first decimating FIR,
// for the front-end chains K1 cannot take.
//
// Replaces: sdrplusplusbrown_tpu/ops/pallas_fir.py:_fused_mix_kernel (the
// pre-twiddle sums, which ops/fused_frontend.py:SharedXlateDecimFIR there
// twiddles in XLA) and _fused_mix_planes_kernel (the same with the
// decimated-rate twiddle in the kernel, behind ops/plane_frontend.py).
// Both end in the twiddled IF, which is what K11 writes.  Per channel c
// of C VFOs on one shared wideband ext = concat(tail (K-1 samples),
// x (T samples)):
//     g_c[k] = h[k] * e^{j omega_c k}                 (float32 omega_c*k)
//     pre_c[m] = sum_k g_c[k] * ext[m*D + k]            m < M = T/D
//     y_c[m]   = pre_c[m] * rotor_c[m]
//     rotor_c[m] = e^{j(phase0_c + (omega_dec_span_c*(m/1024) mod 2pi))}
//                * e^{j omega_dec_c*(m%1024)}          (M > 1024)
//     phase0_c   = ((phase_c - omega_c*(K-1) + pi) mod 2pi) - pi
// written as float32 rows: re of channel c in row c, im in row C + c.
// The TPU bodies build a strided window matrix and reach the MXU through
// one-hot and selection matmuls (Mosaic has no strided lane slice); their
// in-kernel twiddle takes its base phase per 2 048-output super-tile.  The
// port applies one twiddle form for every C, the XLA route's ``rotor``,
// whose host-float64 span keeps float32 away from large phase products.
//
// What bounds it on the H100: at the 10 MS/s bank (T = 1 040 000, K = 31,
// D = 4, C = 4) the function reads 8.3 MB and writes 8.3 MB (5 us at
// 3.35 TB/s) and does 2*2*2*C*K*M = 0.26 Gflop (4 us at 67 TFLOP/s).  A
// block stages its wideband window (255*D + K samples of each plane) in
// shared memory once and computes every channel from it, eight channels
// at a time with their taps in shared memory; one thread per output keeps
// 2*8 accumulators in registers over the serial K-tap loop (the window is
// read at stride D, a D-way bank conflict).  All phase arithmetic rounds
// each operation on its own (no fused multiply-add), as the plain
// version's torch ops do.
#include "common.cuh"

namespace {

constexpr int MIX_TILE = 256;  // outputs per block
constexpr int CCH = 8;         // channels per pass over the staged window
constexpr float PI_F = 3.14159274101257324f;      // float32(pi)
constexpr float TWO_PI_F = 6.28318548202514648f;  // float32(2 pi)

// jnp.mod / torch's fmod_floor for a positive divisor: the exact fmod
// remainder, moved up by y where it is negative.
__device__ __forceinline__ float mod_floor(float x, float y) {
  const float r = fmodf(x, y);
  return (r != 0.f && r < 0.f) ? __fadd_rn(r, y) : r;
}

__global__ void fused_mix_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi, int T,
    const float* __restrict__ tail_r, const float* __restrict__ tail_i,
    const float* __restrict__ h, int K, int D,
    const float* __restrict__ omega, const float* __restrict__ phase,
    const float* __restrict__ omega_dec,
    const float* __restrict__ omega_dec_span, int C,
    float* __restrict__ y, int M) {
  extern __shared__ float smem[];
  const int span = (MIX_TILE - 1) * D + K;
  float* swr = smem;
  float* swi = swr + span;
  float* sgr = swi + span;  // [CCH][K]
  float* sgi = sgr + CCH * K;

  const int m0 = blockIdx.x * MIX_TILE;
  const long e0 = static_cast<long>(m0) * D;
  const int hist = K - 1;
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    const long e = e0 + t;
    float a = 0.f, b = 0.f;
    if (e < hist) {
      a = tail_r[e];
      b = tail_i[e];
    } else if (e - hist < T) {
      a = xr[e - hist];
      b = xi[e - hist];
    }
    swr[t] = a;
    swi[t] = b;
  }
  const int m = m0 + threadIdx.x;
  const float* wr = swr + threadIdx.x * D;
  const float* wi = swi + threadIdx.x * D;
  for (int c0 = 0; c0 < C; c0 += CCH) {
    const int nc = min(CCH, C - c0);
    __syncthreads();  // window staged / the previous chunk's taps consumed
    for (int i = threadIdx.x; i < nc * K; i += blockDim.x) {
      const int c = i / K;
      const int k = i - c * K;
      float s, co;
      sincosf(__fmul_rn(omega[c0 + c], static_cast<float>(k)), &s, &co);
      sgr[c * K + k] = __fmul_rn(h[k], co);
      sgi[c * K + k] = __fmul_rn(h[k], s);
    }
    __syncthreads();
    if (m >= M) continue;
    float ar[CCH], ai[CCH];
#pragma unroll
    for (int c = 0; c < CCH; ++c) ar[c] = ai[c] = 0.f;
    // the re plane's taps first, then the im plane's (the Pallas body's
    // accumulation order): re += gr*xr - gi*xi, im += gi*xr + gr*xi
    for (int k = 0; k < K; ++k) {
      const float v = wr[k];
#pragma unroll
      for (int c = 0; c < CCH; ++c) {
        if (c < nc) {
          ar[c] = fmaf(sgr[c * K + k], v, ar[c]);
          ai[c] = fmaf(sgi[c * K + k], v, ai[c]);
        }
      }
    }
    for (int k = 0; k < K; ++k) {
      const float v = wi[k];
#pragma unroll
      for (int c = 0; c < CCH; ++c) {
        if (c < nc) {
          ar[c] = fmaf(-sgi[c * K + k], v, ar[c]);
          ai[c] = fmaf(sgr[c * K + k], v, ai[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CCH; ++c) {
      if (c >= nc) break;
      const int ch = c0 + c;
      const float re = ar[c], im = ai[c];
      const float p0 = __fsub_rn(
          mod_floor(__fadd_rn(__fsub_rn(phase[ch],
                                        __fmul_rn(omega[ch],
                                                  static_cast<float>(K - 1))),
                              PI_F),
                    TWO_PI_F),
          PI_F);
      float tr, ti;
      if (M > 1024) {
        const float am = __fadd_rn(
            p0, mod_floor(__fmul_rn(omega_dec_span[ch],
                                    static_cast<float>(m >> 10)),
                          TWO_PI_F));
        const float ak = __fmul_rn(omega_dec[ch],
                                   static_cast<float>(m & 1023));
        float sm, cm, sk, ck;
        sincosf(am, &sm, &cm);
        sincosf(ak, &sk, &ck);
        tr = __fsub_rn(__fmul_rn(cm, ck), __fmul_rn(sm, sk));
        ti = __fadd_rn(__fmul_rn(cm, sk), __fmul_rn(sm, ck));
      } else {
        sincosf(__fadd_rn(p0, __fmul_rn(omega_dec[ch],
                                        static_cast<float>(m))),
                &ti, &tr);
      }
      y[static_cast<long>(ch) * M + m] =
          __fsub_rn(__fmul_rn(re, tr), __fmul_rn(im, ti));
      y[static_cast<long>(C + ch) * M + m] =
          __fadd_rn(__fmul_rn(re, ti), __fmul_rn(im, tr));
    }
  }
}

}  // namespace

// xr, xi [T]; tail_r, tail_i [K-1]; h [K]; omega, phase, omega_dec,
// omega_dec_span [C]; y [2C, M] with M = T / D; all float32, dense.
extern "C" int sdr_fused_mix(const float* xr, const float* xi, int T,
                             const float* tail_r, const float* tail_i,
                             const float* h, int K, int D, const float* omega,
                             const float* phase, const float* omega_dec,
                             const float* omega_dec_span, int C,
                             float* y, int M, cudaStream_t stream) {
  if (T < 1 || K < 1 || D < 1 || C < 1 || M < 1 ||
      static_cast<long>(M - 1) * D + K > static_cast<long>(T) + K - 1)
    return cudaErrorInvalidValue;
  const size_t smem =
      (2 * ((MIX_TILE - 1) * D + K) + 2 * CCH * K) * sizeof(float);
  const cudaError_t e = sdr::allow_smem(fused_mix_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_mix_kernel<<<(M + MIX_TILE - 1) / MIX_TILE, MIX_TILE, smem, stream>>>(
      xr, xi, T, tail_r, tail_i, h, K, D, omega, phase, omega_dec,
      omega_dec_span, C, y, M);
  return static_cast<int>(cudaGetLastError());
}
