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
// microsecond either way; the time is the launch and each thread's serial
// 159-tap loop.  A block stages its tile's complex input span (255·D + K
// samples) in shared memory; the taps come through the read-only cache.
#include "common.cuh"

namespace {

constexpr int CPLX_TILE = 256;

__global__ void fir_cplx_kernel(const float2* __restrict__ tail, int hist,
                                const float2* __restrict__ x, int T,
                                const float* __restrict__ hr,
                                const float* __restrict__ hi, int K, int D,
                                float2* __restrict__ y, int n_out,
                                float2* __restrict__ new_tail) {
  extern __shared__ float2 sxc[];
  const long b = blockIdx.y;
  const float2* tb = tail + b * hist;
  const float2* xb = x + b * T;
  const int m0 = blockIdx.x * CPLX_TILE;
  const int m_last = min(m0 + CPLX_TILE, n_out) - 1;
  const long e0 = static_cast<long>(m0) * D;
  const int span = (m_last - m0) * D + K;
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    const long e = e0 + t;
    sxc[t] = e < hist ? tb[e] : xb[e - hist];
  }
  __syncthreads();
  const int m = m0 + threadIdx.x;
  if (m <= m_last) {
    const float2* w = sxc + threadIdx.x * D;
    float rr = 0.f, ii = 0.f, ri = 0.f, ir = 0.f;
    for (int k = 0; k < K; ++k) {
      const float2 v = w[k];
      const float a = __ldg(hr + k), bb = __ldg(hi + k);
      rr = fmaf(v.x, a, rr);
      ii = fmaf(v.y, bb, ii);
      ri = fmaf(v.x, bb, ri);
      ir = fmaf(v.y, a, ir);
    }
    y[b * n_out + m] = make_float2(rr - ii, ri + ir);
  }
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
extern "C" int sdr_fir_cplx(const void* tail, int hist, const void* x, int T,
                            const float* taps, int K, int D, void* y,
                            int n_out, void* new_tail, int rows,
                            cudaStream_t stream) {
  if (n_out < 1 || K < 1 || D < 1 || hist < 0 || rows < 1 || rows > 65535 ||
      static_cast<long>(n_out - 1) * D + K > static_cast<long>(hist) + T)
    return cudaErrorInvalidValue;
  const size_t smem =
      (static_cast<size_t>(CPLX_TILE - 1) * D + K) * sizeof(float2);
  const cudaError_t e = sdr::allow_smem(fir_cplx_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_out + CPLX_TILE - 1) / CPLX_TILE, rows);
  fir_cplx_kernel<<<grid, CPLX_TILE, smem, stream>>>(
      static_cast<const float2*>(tail), hist, static_cast<const float2*>(x),
      T, taps, taps + K, K, D, static_cast<float2*>(y), n_out,
      static_cast<float2*>(new_tail));
  return static_cast<int>(cudaGetLastError());
}
