// K15 — the first-order linear recurrence y[n] = a[n]·y[n-1] + b[n]
// along each row, y[-1] = y0: the IQ front end's and the AM demod's DC
// blockers, the IF noise blanker's envelope and the slow de-emphasis pole.
//
// Replaces: sdrplusplusbrown_tpu/ops/recurrence.py:linear_recurrence (:22),
// ``jax.lax.associative_scan`` over affine maps (no Pallas body; XLA
// compiles the scan).  Its torch form (ops/recurrence.py:_scan, the plain
// version) is the same odd/even recursion, ~11 torch calls a level, ~195
// launches a 120 000-sample row: most of a served block's host enqueue.
//
// One block of THREADS threads a row, cut into WARPS segments of whole
// batches, one a warp.  A batch is BATCH = 32·K samples: lane l takes its K
// contiguous samples (a warp's loads and stores span BATCH adjacent
// samples).
//   1. each warp composes its segment's maps, batch by batch: each lane
//      its K samples' map, a warp scan of the 32 lanes' (shuffles), the
//      batch's map (lane 31's) folded into the segment's;
//   2. warp 0 scans the WARPS segments' maps and applies the prefix before
//      each segment to y0: each segment's y_start;
//   3. each warp walks its segment again, batch by batch: the warp scan of
//      the lanes' maps again, each lane's start the carried y through the
//      lanes before it, its K samples walked, y = a·y + b, and written;
//      lane 31's last y the next batch's carry.
// The composition is the scan's (A1·A2, B1·A2 + B2), as in the plain
// version, but grouped by lanes, batches and segments: the sums differ
// from the doubling scan's in rounding only.  Both take the pole's powers
// as float32 products, whose rounding is most of their error: at the DC
// blocker's 50/SR pole each is ~79 dB from the float64 recurrence on the
// offset, and they agree to ~109 dB (tests/test_torch_host_path_kernels.py).
// a is a scalar (``a`` null) or float32 [R, T]; b and y are float32 or
// complex64 [R, T] (CPLX: interleaved, a real a scaling both parts).
//
// What bounds it on the H100: one SM a row, and each warp's chain of
// dependent shuffles a batch.  The served block is one row of 120 000
// complex samples: 1 MB read twice (the second pass from L2) and 1 MB
// written by one SM, 30 batches a warp and pass, the next batch's loads
// issued before the current batch's scan.  (A first version gave each
// thread a contiguous chunk of T / THREADS samples: every warp load then
// touched 32 cache lines, one L1 transaction a sample, 164 µs at the
// served block.)
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int K = 4;            // contiguous samples a lane
constexpr int BATCH = 32 * K;   // samples a warp takes at once
constexpr unsigned FULL = 0xffffffffu;
static_assert(WARPS == 32, "step 2 scans the segments' maps in one warp");

template <bool CPLX>
struct Val;
template <>
struct Val<false> {
  using T = float;
  __device__ static float zero() { return 0.0f; }
  __device__ static float axpy(float a, float y, float b) {
    return a * y + b;
  }
  __device__ static float shfl_up(float v, int d) {
    return __shfl_up_sync(FULL, v, d);
  }
  __device__ static float shfl(float v, int src) {
    return __shfl_sync(FULL, v, src);
  }
};
template <>
struct Val<true> {
  using T = float2;
  __device__ static float2 zero() { return make_float2(0.0f, 0.0f); }
  __device__ static float2 axpy(float a, float2 y, float2 b) {
    return make_float2(a * y.x + b.x, a * y.y + b.y);
  }
  __device__ static float2 shfl_up(float2 v, int d) {
    return make_float2(__shfl_up_sync(FULL, v.x, d),
                       __shfl_up_sync(FULL, v.y, d));
  }
  __device__ static float2 shfl(float2 v, int src) {
    return make_float2(__shfl_sync(FULL, v.x, src),
                       __shfl_sync(FULL, v.y, src));
  }
};

// Inclusive scan of the lanes' maps: (A1, B1) then (A2, B2) is
// (A1·A2, B1·A2 + B2).
template <typename V>
__device__ __forceinline__ void warp_scan(int lane, float& A,
                                          typename V::T& B) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float Ap = __shfl_up_sync(FULL, A, d);
    const typename V::T Bp = V::shfl_up(B, d);
    if (lane >= d) {
      B = V::axpy(A, Bp, B);
      A = Ap * A;
    }
  }
}

// A lane's K samples of the batch at n; past the segment's end the
// identity (a = 1, b = 0), which leaves a map and a walk as they are.
template <typename V>
__device__ __forceinline__ void load(const float* ar, float a_scalar,
                                     const typename V::T* br, int n, int end,
                                     float (&av)[K], typename V::T (&bv)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = n + k;
    const bool in = i < end;
    av[k] = !in ? 1.0f : ar == nullptr ? a_scalar : ar[i];
    bv[k] = in ? br[i] : V::zero();
  }
}

// grid R, THREADS threads: row r of b, a (where not scalar), y0 and y.
template <bool CPLX>
__global__ void __launch_bounds__(THREADS)
    recurrence_kernel(const float* __restrict__ a, float a_scalar,
                      const typename Val<CPLX>::T* __restrict__ b,
                      const typename Val<CPLX>::T* __restrict__ y0, int T,
                      typename Val<CPLX>::T* __restrict__ y) {
  using V = Val<CPLX>;
  using VT = typename V::T;
  __shared__ float sA[WARPS];
  __shared__ VT sB[WARPS];
  __shared__ VT sY[WARPS];
  const int r = blockIdx.x, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long base = static_cast<long>(r) * T;
  const VT* br = b + base;
  const float* ar = a == nullptr ? nullptr : a + base;
  const int per_warp = ((T + BATCH - 1) / BATCH + WARPS - 1) / WARPS;
  const int s0 = min(w * per_warp * BATCH, T);
  const int s1 = min(s0 + per_warp * BATCH, T);
  float av[K], an[K];
  VT bv[K], bn[K];

  // 1. the segment's map
  float As = 1.0f;
  VT Bs = V::zero();
  if (s0 < s1) load<V>(ar, a_scalar, br, s0 + lane * K, s1, an, bn);
  for (int n = s0; n < s1; n += BATCH) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      av[k] = an[k];
      bv[k] = bn[k];
    }
    if (n + BATCH < s1)
      load<V>(ar, a_scalar, br, n + BATCH + lane * K, s1, an, bn);
    float A = 1.0f;
    VT B = V::zero();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      A = A * av[k];
      B = V::axpy(av[k], B, bv[k]);
    }
    warp_scan<V>(lane, A, B);
    const float At = __shfl_sync(FULL, A, 31);
    const VT Bt = V::shfl(B, 31);
    Bs = V::axpy(At, Bs, Bt);
    As = As * At;
  }
  if (lane == 0) {
    sA[w] = As;
    sB[w] = Bs;
  }
  __syncthreads();
  // 2. each segment's start: the segments before it applied to y0
  if (w == 0) {
    float Aw = sA[lane];
    VT Bw = sB[lane];
    warp_scan<V>(lane, Aw, Bw);
    const float Al = __shfl_up_sync(FULL, Aw, 1);
    const VT Bl = V::shfl_up(Bw, 1);
    sY[lane] = lane == 0 ? y0[r] : V::axpy(Al, y0[r], Bl);
  }
  __syncthreads();
  // 3. the walk
  VT carry = sY[w];
  VT* yr = y + base;
  if (s0 < s1) load<V>(ar, a_scalar, br, s0 + lane * K, s1, an, bn);
  for (int n = s0; n < s1; n += BATCH) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      av[k] = an[k];
      bv[k] = bn[k];
    }
    if (n + BATCH < s1)
      load<V>(ar, a_scalar, br, n + BATCH + lane * K, s1, an, bn);
    float A = 1.0f;
    VT B = V::zero();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      A = A * av[k];
      B = V::axpy(av[k], B, bv[k]);
    }
    warp_scan<V>(lane, A, B);
    const float Al = __shfl_up_sync(FULL, A, 1);
    const VT Bl = V::shfl_up(B, 1);
    VT yv = lane == 0 ? carry : V::axpy(Al, carry, Bl);
    const int i0 = n + lane * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      yv = V::axpy(av[k], yv, bv[k]);
      if (i0 + k < s1) yr[i0 + k] = yv;
    }
    carry = V::shfl(yv, 31);
  }
}

}  // namespace

// b, y [R, T] float32 (cplx 0) or complex64 (cplx 1, interleaved); a null
// (a_scalar for every sample) or float32 [R, T]; y0 [R] of b's type.  One
// launch, a block a row.
extern "C" int sdr_linear_recurrence(const float* a, float a_scalar,
                                     const float* b, const float* y0, int R,
                                     int T, int cplx, float* y,
                                     cudaStream_t stream) {
  if (R < 1 || T < 1) return cudaErrorInvalidValue;
  if (cplx) {
    recurrence_kernel<true><<<R, THREADS, 0, stream>>>(
        a, a_scalar, reinterpret_cast<const float2*>(b),
        reinterpret_cast<const float2*>(y0), T, reinterpret_cast<float2*>(y));
  } else {
    recurrence_kernel<false><<<R, THREADS, 0, stream>>>(a, a_scalar, b, y0,
                                                        T, y);
  }
  return static_cast<int>(cudaGetLastError());
}
