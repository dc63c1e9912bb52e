// K1 — shared-VFO front end.
//
// Replaces: sdrplusplusbrown_tpu/ops/mono_frontend.py:_mono_kernel (the
// TPU's whole decimation chain in one sequential-grid Pallas kernel).
//
// What it computes, per channel c of C VFOs on one shared wideband:
//   stage 0  (sdr_mono_mix_decim): mix by the channel's NCO and decimate
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
//   stages 1.. (sdr_mono_poly_stage): the chained polyphase resampler and
//            bandwidth FIR on the [2C, m] planes, each the widened
//            polyphase FIR of common.cuh (a plain FIR is interp = 1).
//
// The TPU kernel carried each stage's overlap in VMEM from one grid step
// to the next.  Here every output tile is a function of a bounded input
// window (carried tail + this block), so blocks run in parallel over
// (time tile) for stage 0 and (time tile, plane row) for the rest; the
// halo is read from the previous stage's buffer or from the state tail.
//
// What bounds it on the H100: stage 0 does K0/D0 (76) complex MACs per
// wideband sample and channel plus one sincosf per staged sample and
// channel; it reads the wideband once per time tile (all C channels of a
// tile come from one staged copy) and writes 2C*T/D0 floats.  At WFM-8
// (T = 240 000, C = 8) every stage is far below both the memory and the
// FP32 roofline; the time is launch count and the serial K0-tap loop per
// thread.  The design keeps each tap loop in shared memory (strided by D0,
// a 4-way bank conflict at D0 = 4) and the taps in shared memory or the
// read-only cache.  Tensor cores (the TPU version's banded matmuls) and
// fusing the stages are left for later work.
#include "common.cuh"

namespace {

constexpr int MIX_TM = 128;  // stage-0 decimated outputs per block

__global__ void mix_decim_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi, int T,
    const float* __restrict__ tail_r, const float* __restrict__ tail_i,
    const float* __restrict__ taps, int K0, int D0,
    const float* __restrict__ omega, const float* __restrict__ base,
    int n_super, int nbw, int adv0, int adv_x, int C, int m0,
    float* __restrict__ out) {
  extern __shared__ float smem[];
  const int span = (MIX_TM - 1) * D0 + K0;
  float* sxr = smem;
  float* sxi = sxr + span;
  float* smr = sxi + span;
  float* smi = smr + span;
  float* sh = smi + span;

  const int mt0 = blockIdx.x * MIX_TM;
  const int i_win = mt0 / adv0;  // adv0 % MIX_TM == 0: one window per tile
  const long p0 = static_cast<long>(mt0) * D0 - (K0 - 1);
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    const long p = p0 + t;
    float a = 0.f, b = 0.f;
    if (p < 0) {
      a = tail_r[p + K0 - 1];
      b = tail_i[p + K0 - 1];
    } else if (p < T) {
      a = xr[p];
      b = xi[p];
    }
    sxr[t] = a;
    sxi[t] = b;
  }
  for (int k = threadIdx.x; k < K0; k += blockDim.x) sh[k] = taps[k];

  const long tw0 = p0 + 1024 - static_cast<long>(i_win) * adv_x;
  const int m = mt0 + threadIdx.x;
  for (int c = 0; c < C; ++c) {
    __syncthreads();  // staged input ready / previous channel's taps done
    const float om = omega[c];
    const float* bc = base + (static_cast<long>(c) * n_super + i_win) * nbw;
    for (int t = threadIdx.x; t < span; t += blockDim.x) {
      const int tw = static_cast<int>(tw0 + t);
      // two roundings, no fused multiply-add: the TPU kernel's float32
      // expression (a fused form differs by an ulp of the ~1e3 rad sum)
      const float ang = __fadd_rn(
          bc[tw >> 10], __fmul_rn(om, static_cast<float>(tw & 1023)));
      float s, co;
      sincosf(ang, &s, &co);
      smr[t] = sxr[t] * co - sxi[t] * s;
      smi[t] = sxr[t] * s + sxi[t] * co;
    }
    __syncthreads();
    if (m < m0) {
      const float* wr = smr + threadIdx.x * D0;
      const float* wi = smi + threadIdx.x * D0;
      float ar = 0.f, ai = 0.f;
      for (int k = 0; k < K0; ++k) {
        ar = fmaf(sh[k], wr[k], ar);
        ai = fmaf(sh[k], wi[k], ai);
      }
      out[static_cast<long>(c) * m0 + m] = ar;
      out[static_cast<long>(C + c) * m0 + m] = ai;
    }
  }
}

__global__ void poly_stage_kernel(const float* __restrict__ tail, int hist,
                                  const float* __restrict__ x, int m_in,
                                  const float* __restrict__ kern, int I,
                                  int D, int kw, void* __restrict__ y,
                                  int y_bf16, int m_out) {
  extern __shared__ float sx[];
  const long row = blockIdx.y;
  sdr::poly_fir_tile(tail + row * hist, hist, x, row * m_in, 0, kern, I, D,
                     kw, y, row * m_out, y_bf16, m_out, sx);
}

}  // namespace

extern "C" int sdr_mono_mix_decim(const float* xr, const float* xi, int T,
                                  const float* tail_r, const float* tail_i,
                                  const float* taps, int K0, int D0,
                                  const float* omega, const float* base,
                                  int n_super, int nbw, int adv0, int adv_x,
                                  int C, int m0, float* out,
                                  cudaStream_t stream) {
  if (adv0 % MIX_TM != 0 || K0 > 1024) return cudaErrorInvalidValue;
  const int span = (MIX_TM - 1) * D0 + K0;
  const size_t smem = (4 * static_cast<size_t>(span) + K0) * sizeof(float);
  const int grid = (m0 + MIX_TM - 1) / MIX_TM;
  mix_decim_kernel<<<grid, MIX_TM, smem, stream>>>(
      xr, xi, T, tail_r, tail_i, taps, K0, D0, omega, base, n_super, nbw,
      adv0, adv_x, C, m0, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sdr_mono_poly_stage(const float* tail, int hist,
                                   const float* x, int m_in,
                                   const float* kern, int I, int D, int kw,
                                   void* y, int y_bf16, int m_out, int rows,
                                   cudaStream_t stream) {
  const size_t smem = sdr::poly_span(I, D, kw) * sizeof(float);
  const dim3 grid((m_out + sdr::POLY_TILE - 1) / sdr::POLY_TILE, rows);
  poly_stage_kernel<<<grid, sdr::POLY_TILE, smem, stream>>>(
      tail, hist, x, m_in, kern, I, D, kw, y, y_bf16, m_out);
  return static_cast<int>(cudaGetLastError());
}
