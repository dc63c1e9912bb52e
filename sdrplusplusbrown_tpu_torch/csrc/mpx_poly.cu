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
// kw = 493 at the WFM rates; ops/resampler.py:fold_output_fir), whose
// phase rows are nonzero on 256-257 taps each.
//
// What bounds it on the H100: 257 nonzero multiply-adds per 48 kHz audio
// sample, ~76 800 outputs per 0.1 s block at C = 8: ~40 Mflop, ~0.6 µs
// at the non-tensor float32 peak; the bytes bound is smaller.  The design
// (warp-uniform phase rows, each over its band, the planes staged
// de-interleaved by input phase and upcast from bf16 once): fir_tile.cuh.
#include "fir_tile.cuh"

namespace {

template <int P, typename X>
__global__ void mpx_poly_kernel(const float* __restrict__ tail, int hist,
                                const X* __restrict__ x, int x_stride,
                                const float* __restrict__ kern, int I, int D,
                                int kw, float* __restrict__ y, int m_out,
                                int G, int C) {
  extern __shared__ __align__(16) float smem[];
  const long row = blockIdx.z;
  sdr::fir_tile_grid<P>(tail + row * hist, hist, x + row * x_stride, kern, I,
                        D, kw, y + row * m_out, m_out / I, G, C, smem);
}

template <typename X>
cudaError_t launch_poly(const float* tail, int hist, const X* x,
                        int x_stride, const float* kern, int I, int D, int kw,
                        float* y, int m_out, int rows, int P, int G, int C,
                        int warps, cudaStream_t stream) {
  const int n_m = m_out / I, per = C * 32 * P;
  const size_t smem =
      sdr::fir_tile_layout(D, kw, n_m, P, G, C, 1).total * sizeof(float);
  const dim3 grid((n_m + per - 1) / per, (I + G - 1) / G, rows);
  switch (P) {
    case 1:
      return sdr::fir_launch(mpx_poly_kernel<1, X>, grid, warps, smem, stream,
                             tail, hist, x, x_stride, kern, I, D, kw, y,
                             m_out, G, C);
    case 3:
      return sdr::fir_launch(mpx_poly_kernel<3, X>, grid, warps, smem, stream,
                             tail, hist, x, x_stride, kern, I, D, kw, y,
                             m_out, G, C);
    case 5:
      return sdr::fir_launch(mpx_poly_kernel<5, X>, grid, warps, smem, stream,
                             tail, hist, x, x_stride, kern, I, D, kw, y,
                             m_out, G, C);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// tail [rows, hist] float32, x [rows, x_stride] float32 or bf16 (x_bf16),
// kern [I, kw], y [rows, m_out]; m_out = (m_in/D)·I with hist + m_in <=
// hist + x_stride samples of ext read.  P, G, C and warps are
// ops/fir_kernel.py:fir_plan's.
extern "C" int sdr_mpx_poly(const float* tail, int hist, const void* x,
                            int x_bf16, int x_stride, const float* kern,
                            int I, int D, int kw, float* y, int m_out,
                            int rows, int P, int G, int C, int warps,
                            cudaStream_t stream) {
  if (m_out < 1 || I < 1 || D < 1 || kw < 1 || m_out % I || rows < 1 ||
      rows > 65535 || G < 1 || G > I || C < 1 || warps < 1 || warps > 32 ||
      static_cast<long>(m_out / I - 1) * D + kw >
          static_cast<long>(hist) + x_stride)
    return cudaErrorInvalidValue;
  if (x_bf16)
    return static_cast<int>(launch_poly(
        tail, hist, static_cast<const __nv_bfloat16*>(x), x_stride, kern, I,
        D, kw, y, m_out, rows, P, G, C, warps, stream));
  return static_cast<int>(launch_poly(tail, hist,
                                      static_cast<const float*>(x), x_stride,
                                      kern, I, D, kw, y, m_out, rows, P, G, C,
                                      warps, stream));
}
