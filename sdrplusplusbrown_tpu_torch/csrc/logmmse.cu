// K14 — LogMMSE's per-frame recursions: the noise history's sliding
// window and the decision-directed ξ recursion of the Ephraim-Malah gain.
//
// Replaces: sdrplusplusbrown_tpu/ops/logmmse.py:LogMMSE._push_history
// (:235) and LogMMSE._gains (:327), two ``lax.scan``s over a block's
// frames (no Pallas body; XLA compiles the scans).  Per bin n of each row
// b, sequential over the block's F frames f, with s = sig[b, f, n]:
//     history (logmmse.h:117-140), the ring slot pos shared by every bin:
//       old, old_dev = hist[pos], dev_hist[pos]
//       full   = count >= H
//       sums'  = (sums + s) - (full ? old : 0)
//       count' = full ? count : count + 1
//       diff   = (s - sums' / count')²
//       devs'  = (devs + diff) - (full ? old_dev : 0)
//       hist[pos], dev_hist[pos] = s, diff;  pos' = (pos + 1) mod H
//       (with ``hold`` set: the slot rewritten with old, old_dev and every
//       counter and sum kept)
//     gain (logmmse.h:376-397), μ² = max(noise_mu2, 1e-30):
//       γ   = min(s² / μ², 40)
//       ξ   = has_prev ? max(aa·X / μ² + (1 - aa)·max(γ - 1, 0), ξ_min)
//                      : (1 - aa)·max(γ - 1, 0) + aa
//       A   = ξ / (1 + ξ)
//       hw[b, f, n] = A·exp(E1(A·γ) / 2);  X = (s·hw)²
// E1 is the float32 Abramowitz & Stegun form of ops/logmmse.py:expn_e1.
// Every operation rounds on its own (__fmul_rn and friends: no fused
// multiply-add), in the plain version's order, with torch's CUDA forms of
// its powers (x² and x³ as products, x⁴ as powf) and expf / logf, so the
// sums, counters and rings are the plain version's bits and the gains
// differ only where expf, logf or powf round differently.
//
// What bounds it on the H100: nothing but its bytes.  At the served IF NR
// (nFFT 96 000, five frames a 120 000-sample block) it reads the frames
// and five ring slots, writes the gains and the slots: ~14 MB, 4.2 µs at
// 3.35 TB/s.  The rings are the caller's, written in place at the F slots
// from ``pos`` (ops/logmmse.py hands them over to the returned state, as
// a donated buffer): no copy of the 76.8 MB rings a block.  One thread a
// bin (a row's bins are adjacent, so every load and store is coalesced),
// its frames in turn.  What it removes is the host's: the two loops were
// ~75 torch calls a frame, ~380 launches a block.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
// torch.clamp_min / clamp_max: a NaN stays NaN
__device__ __forceinline__ float lo(float x, float m) {
  return x != x ? x : fmaxf(x, m);
}
__device__ __forceinline__ float hi(float x, float m) {
  return x != x ? x : fminf(x, m);
}

// ops/logmmse.py:expn_e1, op for op
__device__ __forceinline__ float expn_e1(float x) {
  x = lo(x, 1e-8f);
  const float xs = hi(x, 1.0f);
  const float poly = add(
      0.99999193f,
      mul(xs, add(-0.24991055f,
                  mul(xs, add(0.05519968f,
                              mul(xs, add(-0.00976004f,
                                          mul(xs, 0.00107857f))))))));
  const float small = add(add(-logf(xs), -0.57721566f), mul(xs, poly));
  const float xl = lo(x, 1.0f);
  const float x2 = mul(xl, xl), x3 = mul(x2, xl), x4 = powf(xl, 4.0f);
  const float num = add(add(add(add(x4, mul(x3, 8.5733287401f)),
                                mul(x2, 18.0590169730f)),
                            mul(xl, 8.6347608925f)),
                        0.2677737343f);
  const float den = add(add(add(add(x4, mul(x3, 9.5733223454f)),
                                mul(x2, 25.6329561486f)),
                            mul(xl, 21.0996530827f)),
                        3.9584969228f);
  const float large = mul(dvd(expf(-xl), xl), dvd(num, den));
  return x <= 1.0f ? small : large;
}

// grid ⌈B·N / 256⌉ blocks of 256 threads, one thread a bin of a row.
__global__ void __launch_bounds__(256) logmmse_frames_kernel(
    const float* __restrict__ sig, const float* __restrict__ mu2,
    const float* __restrict__ xk_in, const unsigned char* __restrict__ hp_in,
    float* __restrict__ hist, float* __restrict__ dev_hist,
    const float* __restrict__ sums_in, const float* __restrict__ devs_in,
    const int* __restrict__ count_in, const int* __restrict__ pos_in,
    const unsigned char* __restrict__ hold, int B, int F, int N, int H,
    float aa, float one_m_aa, float ksi_min, float* __restrict__ hw,
    float* __restrict__ xk_out, float* __restrict__ sums_out,
    float* __restrict__ devs_out, int* __restrict__ count_out,
    int* __restrict__ pos_out, unsigned char* __restrict__ hp_out) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long>(B) * N) return;
  const int b = static_cast<int>(i / N);
  const int n = static_cast<int>(i - static_cast<long>(b) * N);
  const bool held = hold != nullptr && *hold != 0;
  int count = *count_in, pos = *pos_in;
  float sums = sums_in[i], devs = devs_in[i], xk = xk_in[i];
  bool hp = hp_in[b] != 0;
  const float m2 = lo(mu2[i], 1e-30f);
  float* hrow = hist + static_cast<long>(b) * H * N + n;
  float* drow = dev_hist + static_cast<long>(b) * H * N + n;
  const float* srow = sig + static_cast<long>(b) * F * N + n;
  float* hwrow = hw + static_cast<long>(b) * F * N + n;
  for (int f = 0; f < F; ++f) {
    const float s = srow[static_cast<long>(f) * N];
    // the history ring
    const long slot = static_cast<long>(pos) * N;
    const float old = hrow[slot], old_dev = drow[slot];
    const bool full = count >= H;
    float sums2 = sub(add(sums, s), full ? old : 0.0f);
    int count2 = full ? count : count + 1;
    const float d = sub(s, dvd(sums2, static_cast<float>(count2)));
    float diff = mul(d, d);
    float devs2 = sub(add(devs, diff), full ? old_dev : 0.0f);
    int pos2 = (pos + 1) % H;
    float noise = s;
    if (held) {
      noise = old;
      diff = old_dev;
      sums2 = sums;
      devs2 = devs;
      count2 = count;
      pos2 = pos;
    }
    hrow[slot] = noise;
    drow[slot] = diff;
    sums = sums2;
    devs = devs2;
    count = count2;
    pos = pos2;
    // the gain
    const float gammak = hi(dvd(mul(s, s), m2), 40.0f);
    const float gm = lo(sub(gammak, 1.0f), 0.0f);
    const float ksi_first = add(mul(gm, one_m_aa), aa);
    const float ksi_dd =
        lo(add(dvd(mul(xk, aa), m2), mul(gm, one_m_aa)), ksi_min);
    const float ksi = hp ? ksi_dd : ksi_first;
    const float A = dvd(ksi, add(ksi, 1.0f));
    const float g = mul(A, expf(mul(expn_e1(mul(A, gammak)), 0.5f)));
    const float sg = mul(s, g);
    xk = mul(sg, sg);
    hp = true;
    hwrow[static_cast<long>(f) * N] = g;
  }
  xk_out[i] = xk;
  sums_out[i] = sums;
  devs_out[i] = devs;
  if (n == 0) hp_out[b] = F > 0 ? 1 : hp_in[b];
  if (i == 0) {
    *count_out = count;
    *pos_out = pos;
  }
}

}  // namespace

// sig [B, F, N], hw [B, F, N]; mu2, xk, sums, devs [B, N] float32;
// hist, dev_hist [B, H, N] float32, written in place at the F slots from
// pos;
// has_prev [B] bool; count, pos int32 scalars shared by the rows; hold a
// bool scalar or null.  One launch.
extern "C" int sdr_logmmse_frames(
    const float* sig, const float* mu2, const float* xk_in,
    const unsigned char* hp_in, float* hist, float* dev_hist,
    const float* sums_in, const float* devs_in, const int* count_in,
    const int* pos_in, const unsigned char* hold, int B, int F, int N, int H,
    float aa, float one_m_aa, float ksi_min, float* hw, float* xk_out,
    float* sums_out, float* devs_out, int* count_out, int* pos_out,
    unsigned char* hp_out, cudaStream_t stream) {
  if (B < 1 || F < 1 || N < 1 || H < 1) return cudaErrorInvalidValue;
  const long bins = static_cast<long>(B) * N;
  const unsigned blocks = static_cast<unsigned>((bins + 255) / 256);
  logmmse_frames_kernel<<<blocks, 256, 0, stream>>>(
      sig, mu2, xk_in, hp_in, hist, dev_hist, sums_in, devs_in, count_in,
      pos_in, hold, B, F, N, H, aa, one_m_aa, ksi_min, hw, xk_out, sums_out,
      devs_out, count_out, pos_out, hp_out);
  return static_cast<int>(cudaGetLastError());
}
