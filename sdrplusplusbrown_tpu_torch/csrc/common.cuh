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

}  // namespace sdr
