// Helpers shared by the port's hand-written kernels.
//
// Plane layout everywhere: a [rows, n] row-major float32 (or bfloat16
// storage) array; complex signals are two row blocks (re rows 0..C-1, im
// rows C..2C-1), as in the JAX package's raw kernel handoff.
#pragma once

#include <cstdint>

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

// The global timer, nanoseconds.
__device__ __forceinline__ unsigned long long ns_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
  return t;
}

// A sequential kernel's chain clock (K12, K13): the SM cycles (clock64)
// and nanoseconds (globaltimer) of the chain's walks between start() and
// stop(), summed, written to clk[2 r], clk[2 r + 1] where clk is not null
// (it is null on the served path).
struct ChainClock {
  unsigned long long* clk;
  unsigned long long c0 = 0, t0 = 0, cycles = 0, ns = 0;
  __device__ explicit ChainClock(unsigned long long* p) : clk(p) {}
  __device__ __forceinline__ void start() {
    if (clk) {
      t0 = ns_now();
      c0 = clock64();
    }
  }
  __device__ __forceinline__ void stop() {
    if (clk) {
      cycles += clock64() - c0;
      ns += ns_now() - t0;
    }
  }
  __device__ __forceinline__ void write(int r) const {
    if (clk) {
      clk[2 * r] = cycles;
      clk[2 * r + 1] = ns;
    }
  }
};

// mbarriers in shared memory (K13's clock recovery): ``mbar_init`` by one
// thread for ``count`` arrivals a phase, then ``fence_mbar_init`` and a
// __syncthreads before any use; ``mbar_arrive`` releases this thread's
// earlier shared-memory writes to the thread that ``mbar_wait``s (acquire)
// for the phase of that ``parity`` to complete.
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(b))),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(b)))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(b));
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
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

// 16 bytes global -> shared without a register round trip (both
// addresses 16-byte aligned), in the current cp.async group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a . b on the tensor cores, one warp: a 16x16 bf16 tile (row major,
// four registers of two values), b 16x8 bf16 (column major, two), d 16x8
// float32.  Lane l holds, with g = l / 4 and t = l % 4: a {(g, 2t..2t+1),
// (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}, b {(2t..2t+1, g), (2t+8.., g)},
// d {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}; the lower k of a pair in
// the lower half of its register.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace sdr
