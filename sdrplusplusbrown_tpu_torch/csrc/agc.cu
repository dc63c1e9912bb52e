// K12 — automatic gain control: the attack/decay envelope follower with
// its gain and start ramp applied.
//
// Replaces: sdrplusplusbrown_tpu/ops/agc.py:AGC.apply, a ``lax.scan`` over
// time (no Pallas body; XLA compiles the scan).  Per row, sequential in
// time:
//     ia   = |x[n]|
//     amp  = ia > amp ? amp*(1-atk) + ia*atk : amp*(1-dec) + ia*dec
//            (held where ia is 0 or subnormal, as the TPU and XLA:CPU
//            flush it, or frozen)
//     gain = held ? 1 : min(set_point / amp, max_gain)
//     y[n] = (x[n] * gain) * min(float(env0 + n) / 4800, 1)
// and the row's final amp and min(env0 + T, 2^30) as the new state.  The
// coefficient switches on a comparison with the recurrence's own output,
// so no associative scan computes it.
//
// What bounds it on the H100: nothing the card offers.  The path's rows
// are C = 4 channels of 1 500-2 496 samples (AM, USB): 12 flops and 8
// bytes a sample, nanoseconds by any roofline, but one dependent chain of
// T steps per row.  So the chain does as little as it can: one block per
// row stages a chunk of the row in shared memory, one thread walks the
// envelope through it (both branches' multiply-adds, a compare and a
// select per sample, the loads from shared memory), writing each
// sample's envelope (or -1 where it was held) beside it, and
// then the whole block computes the gains, the ramp and y in parallel, so
// the division never sits on the chain.  Every operation rounds on its
// own (no fused multiply-add, an IEEE division), as the plain version's
// torch ops do.
#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 2048;    // samples of a row staged at a time
constexpr int THREADS = 256;

__global__ void agc_rows_kernel(const float* __restrict__ x, int T,
                                const float* __restrict__ amp_in,
                                const int* __restrict__ env_in, int frozen,
                                float atk, float one_atk, float dec,
                                float one_dec, float sp, float mg,
                                int env_len, float* __restrict__ y,
                                float* __restrict__ amp_out,
                                int* __restrict__ env_out) {
  __shared__ float sx[CHUNK];
  __shared__ float senv[CHUNK];   // the envelope after each sample, -1: held
  __shared__ float s_amp;
  const int r = blockIdx.x;
  const float* xr = x + static_cast<long>(r) * T;
  float* yr = y + static_cast<long>(r) * T;
  const int env0 = env_in[r];
  const float len = static_cast<float>(env_len);
  if (threadIdx.x == 0) s_amp = amp_in[r];
  for (int s0 = 0; s0 < T; s0 += CHUNK) {
    const int n = min(CHUNK, T - s0);
    for (int j = threadIdx.x; j < n; j += blockDim.x) sx[j] = xr[s0 + j];
    __syncthreads();
    if (threadIdx.x == 0) {
      float amp = s_amp;
      for (int j = 0; j < n; ++j) {
        const float ia = fabsf(sx[j]);
        const float va =
            __fadd_rn(__fmul_rn(amp, one_atk), __fmul_rn(ia, atk));
        const float vd =
            __fadd_rn(__fmul_rn(amp, one_dec), __fmul_rn(ia, dec));
        const bool upd = !frozen && ia >= FLT_MIN;
        amp = upd ? (ia > amp ? va : vd) : amp;
        senv[j] = upd ? amp : -1.f;
      }
      s_amp = amp;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float a = senv[j];
      const float gain = a < 0.f ? 1.f : fminf(__fdiv_rn(sp, a), mg);
      const float ramp =
          fminf(__fdiv_rn(__int2float_rn(env0 + s0 + j), len), 1.f);
      yr[s0 + j] = __fmul_rn(__fmul_rn(sx[j], gain), ramp);
    }
    __syncthreads();   // sx and senv are refilled by the next chunk
  }
  if (threadIdx.x == 0) {
    amp_out[r] = s_amp;
    const long e = static_cast<long>(env0) + T;
    env_out[r] = static_cast<int>(e < (1L << 30) ? e : (1L << 30));
  }
}

}  // namespace

// x, y [R, T] float32; amp [R] float32; env [R] int32 (in and out).  The
// envelope is never negative (it starts at set_point / init_gain and
// each update is a convex sum of non-negative values), so -1 marks a held
// sample.
extern "C" int sdr_agc_rows(const float* x, int R, int T, const float* amp,
                            const int* env, int frozen, float atk,
                            float one_atk, float dec, float one_dec, float sp,
                            float mg, int env_len, float* y, float* amp_out,
                            int* env_out, cudaStream_t stream) {
  if (R < 1 || T < 1 || env_len < 1) return cudaErrorInvalidValue;
  agc_rows_kernel<<<R, THREADS, 0, stream>>>(
      x, T, amp, env, frozen, atk, one_atk, dec, one_dec, sp, mg, env_len, y,
      amp_out, env_out);
  return static_cast<int>(cudaGetLastError());
}
