// K9 — complex-tap FIR on complex rows, stride D.
//
// Replaces: sdrplusplusbrown_tpu/ops/pallas_fir.py:_fir_cplx_kernel and
// _fir_cplx_cb_kernel (one banded matmul whose tap matrix carries the
// complex cross terms, on re/im planes; flat and 8-channel-blocked).
//
// What it computes, per complex64 row with ext = concat(tail (hist
// samples), x (T samples)) and taps h = hr + j·hi:
//     yr[m] = Σ_k xr[m·D + k]·hr[k] − Σ_k xi[m·D + k]·hi[k]
//     yi[m] = Σ_k xr[m·D + k]·hi[k] + Σ_k xi[m·D + k]·hr[k]
// (the four real sums kept apart, as the plain version forms them), and
// the new state, the last ``hist`` samples of ext.  Rows stay interleaved
// complex64 in and out: no plane split, no recombine.
//
// What bounds it on the H100: on the path it is the WFM 19 kHz pilot
// band-pass, 159 complex taps on the 12 500-sample MPX of one radio per
// 0.1 s block: 8·159·12 500 = 16 Mflop and 0.2 MB, a fraction of a
// microsecond either way; the time is the launch and latency.  The design
// is the polyphase FIR tile (fir_tile.cuh, point 8) with a complex tap:
// the taps staged in shared memory as float2 and read as warp-uniform
// broadcasts, the span de-interleaved by input phase, P consecutive
// outputs a lane through the register ring at D = 1, 2 and 4, four
// accumulators an output (rr, ii, ri, ir), each summed in ascending tap
// order with one fused multiply-add a tap, then (rr − ii, ri + ir): the
// bits of the one-thread-an-output kernel this replaces.  The grid is
// ops/fir_kernel.py:fir_plan's, which gives the pilot's one row of 12 500
// outputs 196 blocks, so that every SM takes a share of the latency.
#include "fir_tile.cuh"

namespace {

// grid (chunks, 1, rows): outputs blockIdx.x·Cc·32·P ... of row
// blockIdx.z; each row's first block also writes its new tail.
template <int P>
__global__ void fir_cplx_kernel(const float2* __restrict__ tail, int hist,
                                const float2* __restrict__ x, int T,
                                const float* __restrict__ taps, int K, int D,
                                float2* __restrict__ y, int n_out,
                                float2* __restrict__ new_tail, int Cc) {
  extern __shared__ __align__(16) float smem[];
  const long b = blockIdx.z;
  const float2* tb = tail + b * hist;
  const float2* xb = x + b * T;
  const int per = Cc * 32 * P;
  const int m0 = blockIdx.x * per;
  sdr::fir_tile<P, float2, float2, float4>(
      sdr::TailThen<float2, float2>{tb, hist, xb}, taps, 1, D, K,
      sdr::StoreTo<float2>{y + b * n_out}, n_out, m0, min(per, n_out - m0),
      1, Cc, smem);
  if (blockIdx.x == 0) {
    for (int e = threadIdx.x; e < hist; e += blockDim.x) {
      const long s = static_cast<long>(T) + e;      // ext index
      new_tail[b * hist + e] = s < hist ? tb[s] : xb[s - hist];
    }
  }
}

}  // namespace

// tail [rows, hist], x [rows, T], y [rows, n_out], new_tail [rows, hist]
// complex64; taps [2, K] float32 (hr then hi); n_out = (hist + T − K)/D + 1.
// P, Cc and warps are ops/fir_kernel.py:fir_plan's (one phase row).
extern "C" int sdr_fir_cplx(const void* tail, int hist, const void* x, int T,
                            const float* taps, int K, int D, void* y,
                            int n_out, void* new_tail, int rows, int P,
                            int Cc, int warps, cudaStream_t stream) {
  if (n_out < 1 || K < 1 || D < 1 || hist < 0 || rows < 1 || rows > 65535 ||
      Cc < 1 || warps < 1 || warps > 32 ||
      static_cast<long>(n_out - 1) * D + K > static_cast<long>(hist) + T)
    return cudaErrorInvalidValue;
  const int per = Cc * 32 * P;
  const dim3 grid((n_out + per - 1) / per, 1, rows);
  const size_t smem =
      sdr::fir_tile_layout(D, K, n_out, P, 1, Cc, 2, 2).total * sizeof(float);
  return static_cast<int>(sdr::fir_launch_p(
      P, fir_cplx_kernel<1>, fir_cplx_kernel<3>, fir_cplx_kernel<5>, grid,
      warps, smem, stream, static_cast<const float2*>(tail), hist,
      static_cast<const float2*>(x), T, taps, K, D, static_cast<float2*>(y),
      n_out, static_cast<float2*>(new_tail), Cc));
}
