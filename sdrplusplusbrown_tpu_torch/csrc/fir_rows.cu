// K8 — real-tap FIR rows: stride-1 FIRs, decimating FIRs and the L/M
// widened polyphase, on real or complex rows.
//
// Replaces: sdrplusplusbrown_tpu/ops/pallas_fir.py:_fir_kernel,
// _fir_decim_kernel, _fir_decim_cb_kernel, _banded_kernel,
// _banded_roll_kernel, _banded_cb_kernel and _banded_roll_cb_kernel (the
// banded-Toeplitz matmul bodies behind ops/fir.py:correlate and
// ops/resampler.py:PolyphaseResampler), and _plane_decim_kernel,
// _plane_poly_kernel and _plane_poly_roll_kernel on plane rows.  Their tap
// matrices, 1024-lane padding, aligned/roll split and 8-row channel
// blocking are Mosaic layout rules; what they compute is one function:
//     y[row, m·I + r] = Σ_l kern[r, l] · ext[row, m·D + l]
//     ext[row]        = concat(tail[row] (hist samples), x[row] (T))
// (I = 1: a decimating FIR with kern = taps; I = D = 1: a stride-1 FIR).
// The rows are float32 or complex64; a complex row is filtered as float2
// samples, re and im by the same real taps, so complex data needs no
// split or recombine pass.  The new carried state, the last ``hist``
// samples of ext, is written by the first block of each row, so the
// caller needs no concat of state and input either.
//
// What bounds it on the H100, and the design: fir_tile.cuh.  The path's
// stages do 26-872 taps an output (their nonzero bands 26-651) on a few
// MB a call: by operations and by bytes alike the bound is 0.1-3 µs.
#include "fir_tile.cuh"

namespace {

template <int P, typename E>
__global__ void fir_rows_kernel(const E* __restrict__ tail, int hist,
                                const E* __restrict__ x, int T,
                                const float* __restrict__ kern, int I, int D,
                                int kw, E* __restrict__ y, int n_m,
                                E* __restrict__ new_tail, int G, int C) {
  extern __shared__ __align__(16) float smem[];
  const long b = blockIdx.z;
  const E* tr = tail + b * hist;
  const E* xr = x + b * T;
  sdr::fir_tile_grid<P>(tr, hist, xr, kern, I, D, kw,
                        y + b * static_cast<long>(n_m) * I, n_m, G, C, smem);
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    E* nt = new_tail + b * hist;
    for (int e = threadIdx.x; e < hist; e += blockDim.x) {
      const long s = static_cast<long>(T) + e;      // ext index
      nt[e] = s < hist ? tr[s] : xr[s - hist];
    }
  }
}

template <typename E>
cudaError_t launch_rows(const E* tail, int hist, const E* x, int T,
                        const float* kern, int I, int D, int kw, E* y,
                        int n_m, E* new_tail, int rows, int P, int G, int C,
                        int warps, cudaStream_t stream) {
  const int comps = sizeof(E) / sizeof(float);
  const size_t smem =
      sdr::fir_tile_layout(D, kw, n_m, P, G, C, comps).total * sizeof(float);
  const int per = C * 32 * P;
  const dim3 grid((n_m + per - 1) / per, (I + G - 1) / G, rows);
  switch (P) {
    case 1:
      return sdr::fir_launch(fir_rows_kernel<1, E>, grid, warps, smem, stream,
                             tail, hist, x, T, kern, I, D, kw, y, n_m,
                             new_tail, G, C);
    case 3:
      return sdr::fir_launch(fir_rows_kernel<3, E>, grid, warps, smem, stream,
                             tail, hist, x, T, kern, I, D, kw, y, n_m,
                             new_tail, G, C);
    case 5:
      return sdr::fir_launch(fir_rows_kernel<5, E>, grid, warps, smem, stream,
                             tail, hist, x, T, kern, I, D, kw, y, n_m,
                             new_tail, G, C);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// tail [rows, hist, comps], x [rows, T, comps], kern [I, kw],
// y [rows, n_out, comps], new_tail [rows, hist, comps]; all float32,
// dense.  n_out = ((hist + T − kw)/D + 1)·I outputs per row.  P, G, C and
// warps are ops/fir_kernel.py:fir_plan's.
extern "C" int sdr_fir_rows(const float* tail, int hist, const float* x,
                            int T, const float* kern, int I, int D, int kw,
                            float* y, int n_out, float* new_tail, int rows,
                            int comps, int P, int G, int C, int warps,
                            cudaStream_t stream) {
  if (n_out < 1 || I < 1 || D < 1 || kw < 1 || hist < 0 || rows < 1 ||
      rows > 65535 || (comps != 1 && comps != 2) || n_out % I ||
      static_cast<long>(n_out / I - 1) * D + kw > static_cast<long>(hist) + T ||
      G < 1 || G > I || C < 1 || warps < 1 || warps > 32)
    return cudaErrorInvalidValue;
  const int n_m = n_out / I;
  if (comps == 2)
    return static_cast<int>(launch_rows(
        reinterpret_cast<const float2*>(tail), hist,
        reinterpret_cast<const float2*>(x), T, kern, I, D, kw,
        reinterpret_cast<float2*>(y), n_m, reinterpret_cast<float2*>(new_tail),
        rows, P, G, C, warps, stream));
  return static_cast<int>(launch_rows(tail, hist, x, T, kern, I, D, kw, y, n_m,
                                      new_tail, rows, P, G, C, warps,
                                      stream));
}
