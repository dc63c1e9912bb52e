// K8 — real-tap FIR rows: stride-1 FIRs, decimating FIRs and the L/M
// widened polyphase, on real or complex rows.
//
// Replaces: sdrplusplusbrown_tpu/ops/pallas_fir.py:_fir_kernel,
// _fir_decim_kernel, _fir_decim_cb_kernel, _banded_kernel,
// _banded_roll_kernel, _banded_cb_kernel and _banded_roll_cb_kernel (the
// banded-Toeplitz matmul bodies behind ops/fir.py:correlate and
// ops/resampler.py:PolyphaseResampler).  Their tap matrices, 1024-lane
// padding, aligned/roll split and 8-row channel blocking are Mosaic layout
// rules; what they compute is one function:
//     y[row, m·I + r] = Σ_l kern[r, l] · ext[row, m·D + l]
//     ext[row]        = concat(tail[row] (hist samples), x[row] (T))
// (I = 1: a decimating FIR with kern = taps; I = D = 1: a stride-1 FIR).
// The rows are float32; a complex64 row is two interleaved real rows (its
// re and im parts, element stride 2), each filtered by the real taps, so
// complex data needs no split or recombine pass.  The new carried state,
// the last ``hist`` samples of ext, is written by the first tile of each
// row, so the caller needs no concat of state and input either.
//
// What bounds it on the H100: the path's stages do 34-493 MACs per output
// on a few MB per 0.1 s block, so by operations (the 304-tap D = 4 WFM
// stage: 2·304·60 000·2 = 73 Mflop, ~1.1 µs at 67 TFLOP/s) and by bytes
// alike the bound is microseconds; the time is the launch and each
// thread's serial tap loop.  One thread computes one output from the
// tile's input span staged in shared memory (common.cuh:poly_fir_tile,
// poly_span floats: 1 328 for the 304-tap D = 4 stage, 1 243 for the
// de-emphasis-folded 48/125 audio kernel).  Splitting the tap loop over a
// warp, or tensor cores on a banded product, is left for later work.
#include "common.cuh"

namespace {

__global__ void fir_rows_kernel(const float* __restrict__ tail, int hist,
                                const float* __restrict__ x, int T,
                                const float* __restrict__ kern, int I, int D,
                                int kw, float* __restrict__ y, int n_out,
                                float* __restrict__ new_tail, int comps) {
  extern __shared__ float sx[];
  const long b = blockIdx.y / comps;
  const int c = static_cast<int>(blockIdx.y - b * comps);
  const float* tr = tail + b * hist * comps + c;
  const float* xr = x + b * T * comps + c;
  sdr::poly_fir_tile(tr, hist, xr, 0, 0, kern, I, D, kw, y,
                     b * n_out * comps + c, 0, n_out, sx, comps);
  if (blockIdx.x == 0) {
    float* nt = new_tail + b * hist * comps + c;
    for (int e = threadIdx.x; e < hist; e += blockDim.x) {
      const long s = static_cast<long>(T) + e;      // ext index
      nt[static_cast<long>(e) * comps] =
          s < hist ? tr[s * comps] : xr[(s - hist) * comps];
    }
  }
}

}  // namespace

// tail [rows, hist, comps], x [rows, T, comps], kern [I, kw],
// y [rows, n_out, comps], new_tail [rows, hist, comps]; all float32,
// dense.  n_out = ((hist + T − kw)/D + 1)·I outputs per row.
extern "C" int sdr_fir_rows(const float* tail, int hist, const float* x,
                            int T, const float* kern, int I, int D, int kw,
                            float* y, int n_out, float* new_tail, int rows,
                            int comps, cudaStream_t stream) {
  if (n_out < 1 || I < 1 || D < 1 || kw < 1 || hist < 0 || rows < 1 ||
      (comps != 1 && comps != 2) || rows * comps > 65535 ||
      static_cast<long>(n_out / I - 1) * D + kw > static_cast<long>(hist) + T)
    return cudaErrorInvalidValue;
  const size_t smem = sdr::poly_span(I, D, kw) * sizeof(float);
  const cudaError_t e = sdr::allow_smem(fir_rows_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_out + sdr::POLY_TILE - 1) / sdr::POLY_TILE,
                  rows * comps);
  fir_rows_kernel<<<grid, sdr::POLY_TILE, smem, stream>>>(
      tail, hist, x, T, kern, I, D, kw, y, n_out, new_tail, comps);
  return static_cast<int>(cudaGetLastError());
}
