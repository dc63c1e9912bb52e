// Helpers shared by the port's hand-written kernels.
//
// Plane layout everywhere: a [rows, n] row-major float32 (or bfloat16
// storage) array; complex signals are two row blocks (re rows 0..C-1, im
// rows C..2C-1), as in the JAX package's raw kernel handoff.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sdr {

// bf16 is storage only: loads upcast to float before any arithmetic, and
// stores round to nearest even once.
__device__ __forceinline__ float ld(const void* p, long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, long i, float v, int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// Opt ``kernel`` in to ``bytes`` of dynamic shared memory: a launch above
// the default 48 KB needs it (the H100 allows up to 227 KB a block).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Outputs per block of the widened-polyphase FIR (one thread each).
constexpr int POLY_TILE = 256;

// Shared-memory floats one POLY_TILE needs for an (I, D, kw) geometry.
__host__ __device__ inline int poly_span(int I, int D, int kw) {
  return ((POLY_TILE - 1) / I + 1) * D + kw;
}

// One tile of the widened-polyphase FIR on one row:
//   y[m*I + r] = sum_l kern[r*kw + l] * ext[m*D + l]
//   ext        = concat(tail[0:hist], x[0:])
// Decimating FIRs are the I = 1 case (kern = taps), stride-1 FIRs
// I = D = 1.  The tile's input span is staged in shared memory ``sx``
// (poly_span floats); the taps are read through the read-only cache.
// ``es`` is the element stride of tail, x and y (2 for one part of
// interleaved complex64 rows, the re or im of each sample).
__device__ __forceinline__ void poly_fir_tile(
    const float* __restrict__ tail, int hist, const void* __restrict__ x,
    long x_off, int x_bf16, const float* __restrict__ kern, int I, int D,
    int kw, void* __restrict__ y, long y_off, int y_bf16, int n_out,
    float* sx, int es = 1) {
  const int o0 = blockIdx.x * POLY_TILE;
  const int o_last = min(o0 + POLY_TILE, n_out) - 1;
  const int m_first = o0 / I;
  const int m_last = o_last / I;
  const long e0 = static_cast<long>(m_first) * D;
  const int span = (m_last - m_first) * D + kw;
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    const long e = e0 + t;
    sx[t] = e < hist ? tail[e * es] : ld(x, x_off + (e - hist) * es, x_bf16);
  }
  __syncthreads();
  const int o = o0 + threadIdx.x;
  if (o <= o_last) {
    const int m = o / I;
    const int r = o - m * I;
    const float* kr = kern + static_cast<long>(r) * kw;
    const float* w = sx + (m - m_first) * D;
    float acc = 0.f;
    for (int l = 0; l < kw; ++l) acc = fmaf(__ldg(kr + l), w[l], acc);
    st(y, y_off + static_cast<long>(o) * es, acc, y_bf16);
  }
}

}  // namespace sdr
