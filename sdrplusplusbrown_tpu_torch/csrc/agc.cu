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
// T steps per row, each a multiply, an add and a select or two.  So the
// chain's warp does nothing else.  A block of two warps a row:
//   * the chain warp: every lane walks the same chain (SIMT makes the
//     copies free).  The row arrives in batches of 32 samples, one
//     coalesced load a lane, two batches ahead; while it walks batch b
//     the shuffles that broadcast batch b + 1 into every lane's
//     registers run beside the chain, so the walk (unrolled, 32 steps)
//     reads registers only.  A batch with no held sample (the warp votes)
//     walks without the held select.  It writes the 32 envelopes into a
//     ring of shared-memory slots and signals the slot full;
//   * the output warp: waits for a slot, computes each lane's sample's
//     gain (an IEEE division), ramp and y, stores them, coalesced, and
//     signals the slot free.  Its work (the divisions' latency, the
//     stores) then overlaps the chain's next walk instead of following
//     it.
// The signals are named barriers: the chain warp arrives (no wait) on a
// slot's full barrier and waits on its free one only when it comes round
// the ring, which the output warp, the faster, has passed by then.  A
// partial last batch is padded with zeros, which the chain holds.  Every
// operation rounds on its own (__fmul_rn / __fadd_rn: no fused
// multiply-add; IEEE divisions), as the plain version's torch ops do, so
// the output and the state are the bits of the one-thread-a-row kernel
// this replaces.
//
// The complex form (sdr_agc_cplx_rows: the AM carrier AGC, RDSDemod's
// AGC) is the same kernel on complex64 rows: each lane's hypotf of its
// sample is what the chain walks, and the output warp scales both planes.
// The output warp computes the hypotfs, AHEAD batches before its own
// batch, into a ring of MAGS batches in shared memory; the chain warp
// reads a batch's |x| three batches before its walk, after the free
// signal it already waits on (ops/agc.py:ring_schedule models the order).
// So the chain warp loads nothing from global memory and computes no
// hypotf: taken by the chain warp at its load (an earlier design), the
// load's latency and hypotf's sat on the chain every batch, 38 cycles a
// step against the real form's 25.  The real form's code is unchanged.
// Both forms take ``clk`` (null on the served path): the
// chain warp's cycles and nanoseconds a row (sdr::ChainClock), the
// chain's measured cost a step.
#include <cfloat>
#include <type_traits>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SLOTS = 2;        // ring of envelope batches in shared memory
constexpr int MAGS = 8;         // K12c: ring of |x| batches in shared memory
constexpr int AHEAD = 5;        // K12c: batches the output warp's |x| leads
constexpr int START = 1 + 2 * SLOTS;   // K12c: |x| of batches 0 .. AHEAD-1

// Named barriers 1 .. 2·SLOTS (0 is __syncthreads'): slot s full, slot s
// free; START (K12c): the output warp's first AHEAD batches of |x| are
// written; 64 threads each, the two warps.
__device__ __forceinline__ void arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void wait(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int free_bar(int s) { return 1 + SLOTS + s; }

// The chain over one batch xs: the envelope after step k into h[k].  With
// HELD false every sample of the batch updates it (no zero or subnormal
// among them), and the step is a multiply, an add and one select.  Step
// k also broadcasts lane k's sample of the next batch into xn[k], 32
// steps before the walk reads it, so no shuffle's latency sits on the
// chain.
template <bool HELD>
__device__ __forceinline__ float walk(float amp, const float (&xs)[32],
                                      float (&xn)[32], float own,
                                      float (&h)[32], float atk,
                                      float one_atk, float dec,
                                      float one_dec) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    xn[k] = __shfl_sync(FULL, own, k);
    const float ia = fabsf(xs[k]);
    const float va = __fadd_rn(__fmul_rn(amp, one_atk), __fmul_rn(ia, atk));
    const float vd = __fadd_rn(__fmul_rn(amp, one_dec), __fmul_rn(ia, dec));
    const float v = ia > amp ? va : vd;
    amp = HELD && !(ia >= FLT_MIN) ? amp : v;
    h[k] = amp;
  }
  return amp;
}

// grid R, 64 threads: warp 0 the chain, warp 1 the outputs.  CPLX: x and
// y are complex64 rows (interleaved), the chain walks |x| and the gain
// and ramp scale both planes.
template <bool CPLX>
__global__ void __launch_bounds__(64)
    agc_rows_kernel(const float* __restrict__ x, int T,
                    const float* __restrict__ amp_in,
                    const int* __restrict__ env_in, int frozen, float atk,
                    float one_atk, float dec, float one_dec, float sp,
                    float mg, int env_len, float* __restrict__ y,
                    float* __restrict__ amp_out, int* __restrict__ env_out,
                    unsigned long long* __restrict__ clk) {
  __shared__ __align__(16) float ring[SLOTS][32];
  __shared__ float mag[CPLX ? MAGS : 1][32];
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const float* xr = x + static_cast<long>(r) * T * (CPLX ? 2 : 1);
  const int nb = (T + 31) / 32;
  if (threadIdx.x < 32) {
    // ---- the chain ------------------------------------------------------
    float amp = amp_in[r];
    sdr::ChainClock cc(clk);
    if (!frozen) {
      cc.start();
      // batch b: every lane's copy of its 32 samples (xs) and this lane's
      // (xv); own and nxt, this lane's of batches b + 1 and b + 2 (K12c:
      // their |x|, and far, batch b + 3's, from the output warp's ring)
      float own, nxt, far;
      if constexpr (CPLX) {
        wait(START);
        own = mag[0][lane];
        nxt = mag[1][lane];
        far = mag[2][lane];
      } else {
        own = lane < T ? xr[lane] : 0.f;
        nxt = 32 + lane < T ? xr[32 + lane] : 0.f;
      }
      float xs[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) xs[k] = __shfl_sync(FULL, own, k);
      float xv = own;
      for (int b = 0; b < nb; ++b) {
        own = nxt;
        if constexpr (CPLX)
          nxt = far;
        else
          nxt = 32 * b + 64 + lane < T ? xr[32 * b + 64 + lane] : 0.f;
        float xn[32], h[32];
        if (__all_sync(FULL, fabsf(xv) >= FLT_MIN))
          amp = walk<false>(amp, xs, xn, own, h, atk, one_atk, dec, one_dec);
        else
          amp = walk<true>(amp, xs, xn, own, h, atk, one_atk, dec, one_dec);
        const int s = b % SLOTS;
        if (b >= SLOTS) wait(free_bar(s));
        // every lane stores the same values to the same words: a store
        // by lane 0 alone costs the chain a divergent branch a batch
        float4* slot = reinterpret_cast<float4*>(ring[s]);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          slot[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                                h[4 * q + 3]);
        arrive(full_bar(s));
        // K12c: |x| of batch b + 3, which the output warp wrote before its
        // free signal for batch b - 2 (waited on above from b = SLOTS on;
        // batches 3 and 4 before START)
        if constexpr (CPLX) far = mag[(b + 3) % MAGS][lane];
#pragma unroll
        for (int k = 0; k < 32; ++k) xs[k] = xn[k];
        xv = own;
      }
      cc.stop();
      // match the output warp's last free signals: no barrier left open
      for (int b = nb > SLOTS ? nb : SLOTS; b < nb + SLOTS; ++b)
        wait(free_bar(b % SLOTS));
    }
    if (lane == 0) {
      cc.write(r);
      amp_out[r] = amp;
      const long e = static_cast<long>(env_in[r]) + T;
      env_out[r] = static_cast<int>(e < (1L << 30) ? e : (1L << 30));
    }
    return;
  }
  // ---- the outputs ----------------------------------------------------
  float* yr = y + static_cast<long>(r) * T * (CPLX ? 2 : 1);
  const int env0 = env_in[r];
  const float len = static_cast<float>(env_len);
  using V = typename std::conditional<CPLX, float2, float>::type;
  const V* xv_row = reinterpret_cast<const V*>(xr);
  V* yv_row = reinterpret_cast<V*>(yr);
  V xn = lane < T ? xv_row[lane] : V{};
  // K12c: |x| of batches 0 .. AHEAD-1 into the ring (their loads issued
  // together, then the hypotfs), then START; mraw, this lane's sample of
  // batch b + AHEAD, loaded a batch ahead
  float2 mraw{};
  if constexpr (CPLX) {
    if (!frozen) {
      float2 v[AHEAD + 1];
#pragma unroll
      for (int q = 0; q <= AHEAD; ++q) {
        const int i = 32 * q + lane;
        v[q] = i < T ? xv_row[i] : float2{};
      }
#pragma unroll
      for (int q = 0; q < AHEAD; ++q) mag[q][lane] = hypotf(v[q].x, v[q].y);
      mraw = v[AHEAD];
      arrive(START);
    }
  }
  for (int b = 0; b < nb; ++b) {
    const int s0 = 32 * b, n = s0 + lane;
    const V xv = xn;
    xn = n + 32 < T ? xv_row[n + 32] : V{};
    float ia = 0.f;
    if constexpr (CPLX) {
      if (!frozen) {
        // batch b + AHEAD's |x|, before this batch's free signal (slot
        // (b + AHEAD) % MAGS last held batch b - 3's, long read); then
        // this batch's own, written AHEAD batches ago
        mag[(b + AHEAD) % MAGS][lane] = hypotf(mraw.x, mraw.y);
        const int i = n + 32 * (AHEAD + 1);
        mraw = i < T ? xv_row[i] : float2{};
        ia = mag[b % MAGS][lane];
      }
    } else {
      ia = fabsf(xv);
    }
    float a = -1.f;    // the envelope after this lane's sample, -1: held
    if (!frozen) {
      const int s = b % SLOTS;
      wait(full_bar(s));
      if (ia >= FLT_MIN) a = ring[s][lane];
      arrive(free_bar(s));
    }
    if (n < T) {
      const float gain = a < 0.f ? 1.f : fminf(__fdiv_rn(sp, a), mg);
      // 1 from env_len on (float(n) >= len there, the quotient >= 1)
      const float ramp =
          env0 + s0 >= env_len
              ? 1.f
              : fminf(__fdiv_rn(__int2float_rn(env0 + n), len), 1.f);
      if constexpr (CPLX) {
        yv_row[n] = make_float2(__fmul_rn(__fmul_rn(xv.x, gain), ramp),
                                __fmul_rn(__fmul_rn(xv.y, gain), ramp));
      } else {
        yv_row[n] = __fmul_rn(__fmul_rn(xv, gain), ramp);
      }
    }
  }
}

}  // namespace

// x, y [R, T] float32; amp [R] float32; env [R] int32 (in and out).  The
// envelope is never negative (it starts at set_point / init_gain and
// each update is a convex sum of non-negative values), so -1 marks a held
// sample.  One block of two warps a row.  clk null, or [R, 2] uint64 for
// the chain warp's clock (sdr::ChainClock).
extern "C" int sdr_agc_rows(const float* x, int R, int T, const float* amp,
                            const int* env, int frozen, float atk,
                            float one_atk, float dec, float one_dec, float sp,
                            float mg, int env_len, float* y, float* amp_out,
                            int* env_out, unsigned long long* clk,
                            cudaStream_t stream) {
  if (R < 1 || T < 1 || env_len < 1) return cudaErrorInvalidValue;
  agc_rows_kernel<false><<<R, 64, 0, stream>>>(
      x, T, amp, env, frozen, atk, one_atk, dec, one_dec, sp, mg, env_len, y,
      amp_out, env_out, clk);
  return static_cast<int>(cudaGetLastError());
}

// K12's complex form: x, y [R, T] complex64 (interleaved), the rest as
// sdr_agc_rows.  The chain walks hypotf(re, im); both planes get the gain
// and the ramp (the AM carrier AGC, RDSDemod's AGC).
extern "C" int sdr_agc_cplx_rows(const float* x, int R, int T,
                                 const float* amp, const int* env, int frozen,
                                 float atk, float one_atk, float dec,
                                 float one_dec, float sp, float mg,
                                 int env_len, float* y, float* amp_out,
                                 int* env_out, unsigned long long* clk,
                                 cudaStream_t stream) {
  if (R < 1 || T < 1 || env_len < 1) return cudaErrorInvalidValue;
  agc_rows_kernel<true><<<R, 64, 0, stream>>>(
      x, T, amp, env, frozen, atk, one_atk, dec, one_dec, sp, mg, env_len, y,
      amp_out, env_out, clk);
  return static_cast<int>(cudaGetLastError());
}
