// K16 — the soft-decision Viterbi decoder of a rate-1/2 convolutional code
// (constraint length K, S = 2^(K-1) states), one frame a block.
//
// Replaces sdrplusplusbrown_tpu/ops/fec.py:viterbi_decode (:54-99): its
// ``lax.scan`` of add-compare-select over the trellis (:91) and its host
// traceback (:93-99).  No Pallas body: XLA compiles the scan.
//
// The trellis: next state n = ((s << 1) | b) mod S, so its two
// predecessors are n >> 1 (low) and (n >> 1) + S/2 (high), both with input
// bit b = n & 1, whose full K-bit registers are n and n + S.  Thread n
// owns state n: a step reads the two predecessors' metrics from shared
// memory (double-buffered, one __syncthreads a step), adds the branch
// metrics (o0 - e0)^2 + (o1 - e1)^2, each operation rounded on its own (no
// fused multiply-add: the plain version ops/fec.py:viterbi_rows_ref rounds
// each torch operation), and keeps
//     new = min(1e9, c_lo, c_hi),
// deciding for the high predecessor where c_hi <= new + 1e-6 (float32):
// the JAX package's scatter-min from 1e9 and its "the larger origin index
// among the branches within 1e-6 of the minimum" (:84-88).  Its decision
// is one bit a state and step, written a warp a word by __ballot_sync into
// shared memory where the frame's N x ceil(S/32) words fit, else into the
// caller's global scratch.  Thread 0 then finds the first smallest final
// metric (np.argmin's tie rule) and walks the decisions back, writing the
// first N - (K - 1) bits.
//
// ``clk``: null on the served path; else [R, 2] uint64 that thread 0
// fills with the SM cycles and nanoseconds of the frame's add-compare-
// select steps and traceback (sdr::ChainClock).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TILE = 1024;          // steps of soft input staged at a time
constexpr float BIG = 1e9f;
constexpr float TIE = 1e-6f;
constexpr int DEC_SMEM_MAX = 160 * 1024;

__device__ __forceinline__ float branch(float o0, float o1, float e0,
                                        float e1) {
  const float d0 = __fsub_rn(o0, e0), d1 = __fsub_rn(o1, e1);
  return __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1));
}

// grid R, block max(S, 32) threads; dynamic shared memory: the metrics
// [2][S], the soft tile [2 TILE] and, when ``gdec`` is null, the
// decisions [N][W].
__global__ void viterbi_kernel(const float* __restrict__ soft, int N, int S,
                               int g1, int g2, int n_bits,
                               unsigned* __restrict__ gdec,
                               unsigned char* __restrict__ bits,
                               float* __restrict__ final_metrics,
                               unsigned long long* __restrict__ clk) {
  extern __shared__ __align__(16) float sm[];
  float* met = sm;                          // [2 * S]
  float* obs = met + 2 * S;                 // [2 * TILE]
  const int W = (S + 31) / 32;
  const int r = blockIdx.x;
  unsigned* dec = gdec ? gdec + static_cast<long>(r) * N * W
                       : reinterpret_cast<unsigned*>(obs + 2 * TILE);
  const float* in = soft + static_cast<long>(r) * 2 * N;
  const int n = threadIdx.x;
  const bool live = n < S;
  const int lo = n >> 1, hi = lo + S / 2;
  const float elo0 = __popc(n & g1) & 1, elo1 = __popc(n & g2) & 1;
  const float ehi0 = __popc((n + S) & g1) & 1,
              ehi1 = __popc((n + S) & g2) & 1;
  if (live) met[n] = n == 0 ? 0.f : BIG;
  sdr::ChainClock cc(n == 0 ? clk : nullptr);
  int cur = 0;
  for (int t0 = 0; t0 < N; t0 += TILE) {
    const int m = min(TILE, N - t0);
    __syncthreads();
    for (int i = n; i < 2 * m; i += blockDim.x) obs[i] = in[2 * t0 + i];
    __syncthreads();
    cc.start();
    for (int i = 0; i < m; ++i) {
      const float o0 = obs[2 * i], o1 = obs[2 * i + 1];
      bool take_hi = false;
      if (live) {
        const float c_lo = __fadd_rn(met[cur * S + lo],
                                     branch(o0, o1, elo0, elo1));
        const float c_hi = __fadd_rn(met[cur * S + hi],
                                     branch(o0, o1, ehi0, ehi1));
        const float nw = fminf(fminf(c_lo, c_hi), BIG);
        take_hi = c_hi <= __fadd_rn(nw, TIE);
        met[(cur ^ 1) * S + n] = nw;
      }
      const unsigned word = __ballot_sync(0xffffffffu, take_hi);
      if ((n & 31) == 0 && (n >> 5) < W)
        dec[static_cast<long>(t0 + i) * W + (n >> 5)] = word;
      __syncthreads();
      cur ^= 1;
    }
    cc.stop();
  }
  if (live) final_metrics[static_cast<long>(r) * S + n] = met[cur * S + n];
  if (gdec) __threadfence_block();
  __syncthreads();
  if (n == 0) {
    cc.start();
    int s = 0;
    float best = met[cur * S];
    for (int j = 1; j < S; ++j) {
      const float v = met[cur * S + j];
      if (v < best) {
        best = v;
        s = j;
      }
    }
    unsigned char* out = bits + static_cast<long>(r) * n_bits;
    for (int t = N - 1; t >= 0; --t) {
      if (t < n_bits) out[t] = static_cast<unsigned char>(s & 1);
      const unsigned w = dec[static_cast<long>(t) * W + (s >> 5)];
      s = (s >> 1) + (((w >> (s & 31)) & 1u) ? S / 2 : 0);
    }
    cc.stop();
    cc.write(r);
  }
}

}  // namespace

// soft [R, 2N] float32 (each frame's coded bits as values in [0, 1]);
// polynomials g1, g2 and constraint length k (S = 2^(k-1) <= 1024 states);
// scratch null, or [R, N, ceil(S/32)] uint32 of global memory for the
// decisions, needed where N * ceil(S/32) words exceed DEC_SMEM_MAX
// (ops/fec.py:DEC_SMEM_MAX).  Out: bits
// [R, N - (k - 1)] uint8, final_metrics [R, S] float32; clk null or
// [R, 2] uint64.
extern "C" int sdr_viterbi_rows(const float* soft, int R, int N, int g1,
                                int g2, int k, unsigned* scratch,
                                unsigned char* bits, float* final_metrics,
                                unsigned long long* clk,
                                cudaStream_t stream) {
  if (R < 1 || N < k || k < 2 || k > 11) return cudaErrorInvalidValue;
  const int S = 1 << (k - 1);
  const int W = (S + 31) / 32;
  const size_t dec = static_cast<size_t>(N) * W * sizeof(unsigned);
  if (!scratch && dec > DEC_SMEM_MAX) return cudaErrorInvalidValue;
  const size_t bytes =
      sizeof(float) * (2 * S + 2 * TILE) + (scratch ? 0 : dec);
  const cudaError_t e = sdr::allow_smem(viterbi_kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = S < 32 ? 32 : S;
  viterbi_kernel<<<R, threads, bytes, stream>>>(
      soft, N, S, g1, g2, N - (k - 1), scratch, bits, final_metrics, clk);
  return static_cast<int>(cudaGetLastError());
}
