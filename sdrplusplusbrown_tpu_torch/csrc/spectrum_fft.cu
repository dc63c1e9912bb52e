// K4 / K4f — framed wideband power spectrum in dB.
//
// Replaces: sdrplusplusbrown_tpu/ops/pallas_fft.py:fft_pow_db_tile (the
// 4-step matmul FFT fused into the TPU front end, ops/mono_frontend.py
// there) and :_fft_pow_frames_kernel (the standalone framed spectrum):
// K4, frames at 1024-aligned starts; and :_fft_pow_kernel (the windowed
// 4-step FFT on pre-framed planes behind spectrum_path_db): K4f, the same
// two launches with frames at exact starts; and, row-batched (K4r), the
// same :_fft_pow_kernel on the channelizer's [2M, W] bin planes, every
// channel's frames in one launch pair (bench.py:build_channelizer64).
//
// What it computes: the frames come in rows of ``frames_per_row``; frame
// f of row r, ``keep`` samples, starts at r·row_stride + rup(f·interval,
// align) of (xr, xi) — one shared wideband (one row; align 1024 for K4, 1
// for K4f) or the rows of a plane view (K4r: row_stride the view's row
// stride, interval = keep = N) — read with element stride ``es`` (1 for
// planes, 2 for the parts of an interleaved complex64 block), in float32
// or bfloat16 storage (``in_bf16``); it is multiplied by the window (which
// includes the (−1)^i DC-centering factor; none when the pointer is null),
// zero-padded to N, transformed, and each bin becomes
// 10·log10(max(|X|²/N², floor)), in natural bin order: [n_frames, N].
//
// A 65 536-point complex float32 frame is 512 KB, beyond the 227 KB of
// shared memory a block may use, so the transform is the 4-step split
// N = N1·N2 (the TPU's factorization, square here: 256·256, and
// 512·512 for 262 144 points):
//   sdr_fft_cols: for each column n2, X1[k1] = FFT_N1 over n1 of
//                 a[n1·N2 + n2]; times the twiddle W_N^(k1·n2); stored as
//                 scratch C[f, k1, n2] (re/im planes).
//   sdr_fft_rows: for each row k1, FFT_N2 over n2 of C[f, k1, n2] gives
//                 X[k1 + N1·k2]; then power and dB.
// Each block runs LANES (16) short radix-2 FFTs side by side in dynamic
// shared memory (2·16·N1 floats: 32 KB at 256, 64 KB at 512, above the
// 48 KB default and opted in), lanes interleaved so that a butterfly
// stage's threads touch consecutive banks and every device-memory access
// moves 16 consecutive floats.  Twiddles come from sincospif with the
// index product reduced mod N in integers, so every angle argument is an
// exact float.
//
// What bounds it on the H100: ~5·N·log2(N) flops per frame (about 5
// Mflop at N = 65 536, two frames per 0.1 s block; 24 Mflop at 262 144)
// and ~1.5 MB of traffic per 65 536-point frame including the scratch
// round trip (0.8 MB of it the function's own input and output) —
// microseconds of work; the time is the two launches and the log2(n)
// barrier-separated butterfly stages.  K4r at channelizer64 (2 048
// frames of 1 024 from bf16 bins): 8.4 MB in and 8.4 MB of dB out, 5 µs
// of HBM time, beside a 33.5 MB float32 scratch round trip and ten
// barrier-separated stages a launch.  Keeping the scratch in distributed
// shared memory of
// a cluster, or fusing with the front end's read of the wideband (as the
// TPU did), is left for later work.
#include "common.cuh"

namespace {

constexpr int FFT_THREADS = 256;
constexpr int LANES = 16;
constexpr int MAX_N12 = 512;

__device__ __forceinline__ int bit_reverse(int v, int bits) {
  return static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - bits));
}

// In-place radix-2 DIT FFT of LANES interleaved length-n sequences stored
// at s[i*LANES + lane], input already in bit-reversed order.
__device__ void fft_lanes(float* sr, float* si, int n) {
  for (int half = 1; half < n; half <<= 1) {
    __syncthreads();
    for (int b = threadIdx.x; b < (n >> 1) * LANES; b += blockDim.x) {
      const int lane = b % LANES;
      const int j = b / LANES;
      const int pos = j % half;
      const int i0 = ((j / half) * 2 * half + pos) * LANES + lane;
      const int i1 = i0 + half * LANES;
      float s, c;
      sincospif(-static_cast<float>(pos) / static_cast<float>(half), &s, &c);
      const float vr = sr[i1] * c - si[i1] * s;
      const float vi = sr[i1] * s + si[i1] * c;
      const float ur = sr[i0];
      const float ui = si[i0];
      sr[i0] = ur + vr;
      si[i0] = ui + vi;
      sr[i1] = ur - vr;
      si[i1] = ui - vi;
    }
  }
  __syncthreads();
}

__global__ void fft_cols_kernel(const void* __restrict__ xr,
                                const void* __restrict__ xi, int in_bf16,
                                int es, const float* __restrict__ window,
                                int keep, int interval, int align,
                                int frames_per_row, int row_stride,
                                int log_n1, int N2, float* __restrict__ cr,
                                float* __restrict__ ci) {
  extern __shared__ float sm[];
  const int N1 = 1 << log_n1;
  float* sr = sm;
  float* si = sm + N1 * LANES;
  const int f = blockIdx.y;
  const int row = f / frames_per_row;
  const int fr = f - row * frames_per_row;
  const int n2_0 = blockIdx.x * LANES;
  const long p0 =
      (static_cast<long>(fr) * interval + align - 1) / align * align;
  const long r0 = static_cast<long>(row) * row_stride;
  for (int idx = threadIdx.x; idx < N1 * LANES; idx += blockDim.x) {
    const int lane = idx % LANES;
    const int n1 = idx / LANES;
    const int n = n1 * N2 + n2_0 + lane;
    float a = 0.f, b = 0.f;
    if (n < keep) {
      const float w = window ? window[n] : 1.f;
      const long i = r0 + (p0 + n) * es;
      a = sdr::ld(xr, i, in_bf16) * w;
      b = sdr::ld(xi, i, in_bf16) * w;
    }
    const int dst = bit_reverse(n1, log_n1) * LANES + lane;
    sr[dst] = a;
    si[dst] = b;
  }
  fft_lanes(sr, si, N1);
  const int N = N1 * N2;
  const float inv = 2.f / static_cast<float>(N);
  for (int idx = threadIdx.x; idx < N1 * LANES; idx += blockDim.x) {
    const int lane = idx % LANES;
    const int k1 = idx / LANES;
    const int r = (k1 * (n2_0 + lane)) & (N - 1);
    float s, c;
    sincospif(-static_cast<float>(r) * inv, &s, &c);
    const float vr = sr[idx], vi = si[idx];
    const long o = (static_cast<long>(f) * N1 + k1) * N2 + n2_0 + lane;
    cr[o] = vr * c - vi * s;
    ci[o] = vr * s + vi * c;
  }
}

__global__ void fft_rows_kernel(const float* __restrict__ cr,
                                const float* __restrict__ ci, int N1,
                                int log_n2, float inv_n2, float floor_p,
                                float* __restrict__ out) {
  extern __shared__ float sm[];
  const int N2 = 1 << log_n2;
  float* sr = sm;
  float* si = sm + N2 * LANES;
  const int f = blockIdx.y;
  const int k1_0 = blockIdx.x * LANES;
  for (int idx = threadIdx.x; idx < N2 * LANES; idx += blockDim.x) {
    const int n2 = idx % N2;
    const int lane = idx / N2;
    const long src = (static_cast<long>(f) * N1 + k1_0 + lane) * N2 + n2;
    const int dst = bit_reverse(n2, log_n2) * LANES + lane;
    sr[dst] = cr[src];
    si[dst] = ci[src];
  }
  fft_lanes(sr, si, N2);
  for (int idx = threadIdx.x; idx < N2 * LANES; idx += blockDim.x) {
    const int lane = idx % LANES;
    const int k2 = idx / LANES;
    const float p = (sr[idx] * sr[idx] + si[idx] * si[idx]) * inv_n2;
    out[static_cast<long>(f) * N1 * N2 + k1_0 + lane +
        static_cast<long>(N1) * k2] = 10.f * log10f(fmaxf(p, floor_p));
  }
}

bool pow2_in_range(int v) {
  return v >= LANES && v <= MAX_N12 && (v & (v - 1)) == 0;
}

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

}  // namespace

// Shared memory of one block over n-point short FFTs.
static size_t lanes_smem(int n) { return 2 * sizeof(float) * LANES * n; }

extern "C" int sdr_fft_cols(const void* xr, const void* xi, int in_bf16,
                            int es, int T, const float* window, int keep,
                            int interval, int align, int n_frames,
                            int frames_per_row, int row_stride, int N1,
                            int N2, float* cr, float* ci,
                            cudaStream_t stream) {
  if (!pow2_in_range(N1) || !pow2_in_range(N2) || keep > N1 * N2 ||
      align < 1 || es < 1 || n_frames < 1 || frames_per_row < 1 ||
      n_frames % frames_per_row || row_stride < 0 ||
      (static_cast<long>(frames_per_row - 1) * interval + align - 1) /
                  align * align + keep > T)
    return cudaErrorInvalidValue;
  const cudaError_t e = sdr::allow_smem(fft_cols_kernel, lanes_smem(N1));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(N2 / LANES, n_frames);
  fft_cols_kernel<<<grid, FFT_THREADS, lanes_smem(N1), stream>>>(
      xr, xi, in_bf16, es, window, keep, interval, align, frames_per_row,
      row_stride, log2i(N1), N2, cr, ci);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sdr_fft_rows(const float* cr, const float* ci, int n_frames,
                            int N1, int N2, float inv_n2, float floor_p,
                            float* out, cudaStream_t stream) {
  if (!pow2_in_range(N1) || !pow2_in_range(N2) || n_frames < 1)
    return cudaErrorInvalidValue;
  const cudaError_t e = sdr::allow_smem(fft_rows_kernel, lanes_smem(N2));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(N1 / LANES, n_frames);
  fft_rows_kernel<<<grid, FFT_THREADS, lanes_smem(N2), stream>>>(
      cr, ci, N1, log2i(N2), inv_n2, floor_p, out);
  return static_cast<int>(cudaGetLastError());
}
