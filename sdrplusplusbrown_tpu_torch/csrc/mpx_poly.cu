// K3 — MPX-rate audio polyphase with the de-emphasis folded in.
//
// Replaces: sdrplusplusbrown_tpu/ops/wfm_kernel.py:_mpx_poly_kernel (the
// banded-matmul polyphase over the raw L/R planes, sequential grid).
//
// What it computes, per row of the [2C, stride] L/R planes (L rows then R
// rows, float32 or bfloat16 storage) with ext = concat(carried tpp−1
// inputs, x):
//     y[m·I + r] = Σ_l kernel[r, l] · ext[m·D + l]
// over the widened, de-emphasis-folded kernel [I, kw] (I/D = 48/125 and
// kw = 493 at the WFM rates; ops/resampler.py:fold_output_fir).  One
// thread computes one output; a block stages its input span in shared
// memory (common.cuh:poly_fir_tile).
//
// What bounds it on the H100: 493 MACs per 48 kHz audio sample, ~76 800
// outputs per 0.1 s block at C = 8 — tiny; the time is the launch and the
// serial 493-tap loop per thread (the kernel rows are read through the
// read-only cache, 95 KB in all).  Splitting the tap loop across a warp,
// or tensor cores, is left for later work.
#include "common.cuh"

namespace {

__global__ void mpx_poly_kernel(const float* __restrict__ tail, int hist,
                                const void* __restrict__ x, int x_bf16,
                                int x_stride, const float* __restrict__ kern,
                                int I, int D, int kw, float* __restrict__ y,
                                int m_out) {
  extern __shared__ float sx[];
  const long row = blockIdx.y;
  sdr::poly_fir_tile(tail + row * hist, hist, x, row * x_stride, x_bf16,
                     kern, I, D, kw, y, row * m_out, 0, m_out, sx);
}

}  // namespace

extern "C" int sdr_mpx_poly(const float* tail, int hist, const void* x,
                            int x_bf16, int x_stride, const float* kern,
                            int I, int D, int kw, float* y, int m_out,
                            int rows, cudaStream_t stream) {
  const size_t smem = sdr::poly_span(I, D, kw) * sizeof(float);
  const dim3 grid((m_out + sdr::POLY_TILE - 1) / sdr::POLY_TILE, rows);
  mpx_poly_kernel<<<grid, sdr::POLY_TILE, smem, stream>>>(
      tail, hist, x, x_bf16, x_stride, kern, I, D, kw, y, m_out);
  return static_cast<int>(cudaGetLastError());
}
