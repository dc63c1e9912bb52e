// K16 — the soft-decision Viterbi decoder of a rate-1/2 convolutional code
// (constraint length K, S = 2^(K-1) states).
//
// Replaces sdrplusplusbrown_tpu/ops/fec.py:viterbi_decode (:54-99): its
// ``lax.scan`` of add-compare-select over the trellis (:91) and its host
// traceback (:93-99).  No Pallas body: XLA compiles the scan.
//
// The trellis: next state n = ((s << 1) | b) mod S, so its two
// predecessors are n >> 1 (low) and (n >> 1) + S/2 (high), both with input
// bit b = n & 1, whose full K-bit registers are n and n + S.  A step adds
// each predecessor's metric and its branch metric (o0 - e0)^2 + (o1 -
// e1)^2, each operation rounded on its own (no fused multiply-add: the
// plain version ops/fec.py:viterbi_rows_ref rounds each torch operation),
// and keeps
//     new = min(1e9, c_lo, c_hi),
// deciding for the high predecessor where c_hi <= new + 1e-6 (float32):
// the JAX package's scatter-min from 1e9 and its "the larger origin index
// among the branches within 1e-6 of the minimum" (:84-88).  The decisions
// are a bit a state and step, in words of 32 states, in shared memory
// where the frame's N x ceil(S/32) words fit, else in the caller's global
// scratch.  The traceback starts at the first smallest final metric
// (np.argmin's tie rule) and writes the first N - (K - 1) bits.
//
// What bounds it on the H100: a frame is N dependent steps (RyFi 8 168,
// M17 148-244, KG-SSTV 54), each ~6 S operations: nanoseconds of the
// card's rate, but the metric's recurrence is serial, and so is the
// traceback.  A frame's time is its two chains.
//
// The warp form (S <= 64: every code of the port's callers, K = 3, 5, 7)
// is one warp a frame.  Lane L owns states L and L + 32 (S = 64) or state
// L mod S (S <= 32; the lanes past S copy lane L mod S), the metrics in
// registers; a step gets its predecessors' metrics by shuffles from lanes
// (n >> 1) mod 32 (ops/fec.py:viterbi_warp_plan models the plan): on the
// metric's chain a shuffle, an add and two minima, no shared memory and
// no barrier.  The four distinct branch metrics of each step are
// computed a batch of 32 steps ahead, a step a lane, into a two-slot
// table in shared memory that each lane reads at its codes' offsets.  The
// decisions are one or two ballots a step, lane j keeping step j's, and
// go out a batch at a time.  The traceback (every lane the same chain) runs in groups of
// 32 steps from the frame's end and loads each group's decision words
// during the group before, so its chain is a shift, a shift and a logic
// operation;
// the bits go out a group at a time, a byte a lane
// (ops/fec.py:viterbi_trace_plan models the loads).
//
// The block form (S > 64: no caller; K <= 11 accepted) is one block a
// frame, a thread a state: a step reads the two predecessors' metrics
// from shared memory (double-buffered, one __syncthreads a step), and
// thread 0 walks the traceback.
//
// ``clk``: null on the served path; else [R, 4] uint64 that lane 0
// fills with the SM cycles and nanoseconds of the frame's trellis
// (clk[r, 0:2]) and of its argmin and traceback (clk[r, 2:4])
// (sdr::ChainClock).
#include <type_traits>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 1024;          // block form: steps of soft input staged
constexpr float BIG = 1e9f;
constexpr float TIE = 1e-6f;
constexpr int DEC_SMEM_MAX = 160 * 1024;
constexpr int WARP_STATES = 64;     // the warp form's largest S
constexpr int BM_TABLE = 2 * 32 * 4;   // floats: two slots of 32 steps x 4

__device__ __forceinline__ float branch(float o0, float o1, float e0,
                                        float e1) {
  const float d0 = __fsub_rn(o0, e0), d1 = __fsub_rn(o1, e1);
  return __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1));
}

// The coded pair of a full K-bit register as 2 e0 + e1: the branch
// table's column.
__device__ __forceinline__ int code(int reg, int g1, int g2) {
  return 2 * (__popc(reg & g1) & 1) + (__popc(reg & g2) & 1);
}

// A lane's step of the batch's table: its four branch metrics, by code.
__device__ __forceinline__ void branch_row(float* row, float o0, float o1) {
  reinterpret_cast<float4*>(row)[0] =
      make_float4(branch(o0, o1, 0.f, 0.f), branch(o0, o1, 0.f, 1.f),
                  branch(o0, o1, 1.f, 0.f), branch(o0, o1, 1.f, 1.f));
}

// The add-compare-select of one state: the new metric; ``hi`` whether the
// high predecessor wins (c_hi within TIE of the minimum).
__device__ __forceinline__ float acs(float m_lo, float m_hi, float b_lo,
                                     float b_hi, bool& hi) {
  const float c_lo = __fadd_rn(m_lo, b_lo), c_hi = __fadd_rn(m_hi, b_hi);
  const float nw = fminf(fminf(c_lo, c_hi), BIG);
  hi = c_hi <= __fadd_rn(nw, TIE);
  return nw;
}

// The warp form: grid R, 32 threads; REGS = 2 for S = 64 (lane L owns
// states L and L + 32), 1 for S <= 32 (lane L owns L mod S).  Dynamic
// shared memory: the branch table [2][32][4] and, when ``gdec`` is null,
// the decisions [N] of Word (bit s: state s's).
template <int REGS>
__global__ void __launch_bounds__(32)
    viterbi_warp_kernel(const float* __restrict__ soft, int N, int S, int k,
                        int g1, int g2, int n_bits, void* __restrict__ gdec,
                        unsigned char* __restrict__ bits,
                        float* __restrict__ final_metrics,
                        unsigned long long* __restrict__ clk) {
  using Word = typename std::conditional<REGS == 2, unsigned long long,
                                         unsigned>::type;
  extern __shared__ __align__(16) float sm[];
  float* table = sm;                                 // [2][32][4]
  const int r = blockIdx.x, L = threadIdx.x;
  Word* dec = gdec ? static_cast<Word*>(gdec) + static_cast<long>(r) * N
                   : reinterpret_cast<Word*>(sm + BM_TABLE);
  const float* in = soft + static_cast<long>(r) * 2 * N;
  // this lane's states; each one's predecessors lo = n >> 1 and hi = lo +
  // S/2 live in lane (n >> 1) mod 32, registers 0 and 1 (S = 64), or in
  // lanes lo and hi (S <= 32); their branch metrics' codes, from the full
  // registers n and n + S, as offsets into a table row
  int st[REGS], src[REGS][2], off[REGS][2];
  float m[REGS];
#pragma unroll
  for (int q = 0; q < REGS; ++q) {
    st[q] = REGS == 2 ? L + 32 * q : (L & (S - 1));
    const int lo = st[q] >> 1;
    src[q][0] = REGS == 2 ? lo & 31 : lo;
    src[q][1] = REGS == 2 ? lo & 31 : lo + S / 2;
    off[q][0] = code(st[q], g1, g2);
    off[q][1] = code(st[q] + S, g1, g2);
    m[q] = st[q] == 0 ? 0.f : BIG;
  }
  sdr::ChainClock tr(clk && L == 0 ? clk + 4 * r : nullptr);
  sdr::ChainClock tb(clk && L == 0 ? clk + 4 * r + 2 : nullptr);
  // batch 0's table row; o0, o1: this lane's step of the next batch
  branch_row(table + 4 * L, L < N ? in[2 * L] : 0.f,
             L < N ? in[2 * L + 1] : 0.f);
  float o0 = 32 + L < N ? in[64 + 2 * L] : 0.f;
  float o1 = 32 + L < N ? in[64 + 2 * L + 1] : 0.f;
  __syncwarp();
  const int nb = (N + 31) / 32;
  tr.start();
  // a step: the metrics' exchange and add-compare-select; lane j keeps
  // the decisions of the batch's step j (``mine``), stored after the batch:
  // no store in the step (a store that might alias the branch table would
  // hold the next step's table loads behind it)
  Word mine = 0;
  auto step = [&](const float* row, int j) {
    float pm[REGS][2];
    bool hi[REGS];
#pragma unroll
    for (int q = 0; q < REGS; ++q)
#pragma unroll
      for (int w = 0; w < 2; ++w)
        pm[q][w] = __shfl_sync(FULL, m[REGS == 2 ? w : 0], src[q][w]);
#pragma unroll
    for (int q = 0; q < REGS; ++q)
      m[q] = acs(pm[q][0], pm[q][1], row[off[q][0]], row[off[q][1]], hi[q]);
    Word word = __ballot_sync(FULL, hi[0]);
    if constexpr (REGS == 2)
      word |= static_cast<Word>(__ballot_sync(FULL, hi[1])) << 32;
    mine = L == j ? word : mine;
  };
  for (int b = 0; b < nb; ++b) {
    const int t0 = 32 * b;
    const float* cur = table + 128 * (b & 1);
    // the next batch's row, from its input loaded a batch ago, then the
    // input of the batch after
    branch_row(table + 128 * ((b + 1) & 1) + 4 * L, o0, o1);
    o0 = t0 + 64 + L < N ? in[2 * (t0 + 64 + L)] : 0.f;
    o1 = t0 + 64 + L < N ? in[2 * (t0 + 64 + L) + 1] : 0.f;
    if (t0 + 32 <= N) {
#pragma unroll 8
      for (int j = 0; j < 32; ++j) step(cur + 4 * j, j);
    } else {
#pragma unroll 1
      for (int j = 0; j < N - t0; ++j) step(cur + 4 * j, j);
    }
    if (t0 + L < N) dec[t0 + L] = mine;
    __syncwarp();
  }
  tr.stop();
  tb.start();
  // the final metrics out; the first smallest (np.argmin's tie rule)
  float best = m[0];
  unsigned s = st[0];
  if constexpr (REGS == 2) {
    if (m[1] < best) {
      best = m[1];
      s = st[1];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o);
    const unsigned os = __shfl_xor_sync(FULL, s, o);
    if (ob < best || (ob == best && os < s)) {
      best = ob;
      s = os;
    }
  }
  float* fm = final_metrics + static_cast<long>(r) * S;
  if (L < S) fm[st[0]] = m[0];
  if constexpr (REGS == 2) fm[st[1]] = m[1];
  if (gdec) __threadfence_block();
  __syncwarp();
  // the traceback, a group of 32 steps [g, g + 32) at a time from the
  // top (g = N - 32, N - 64, ...; the last group, g <= 0, partial): w,
  // the group's decision words by position (step g + 31 - j in w[j]),
  // loaded during the group before (the top group's here); step t's bit
  // s & 1 into bit t - g of ``got``, which lane L stores for step g + L
  unsigned char* out = bits + static_cast<long>(r) * n_bits;
  Word w[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) w[j] = N - 1 - j >= 0 ? dec[N - 1 - j] : 0;
  // the new bit's place (a constant at S = 64): s >> 1 is below it, so
  // the step is a shift, a shift and one three-input logic operation
  const int up = REGS == 2 ? 5 : k - 2;
  const unsigned top = 1u << up;
  // ``last``: std::true_type for the last group, whose steps below 0 are
  // not the frame's (and which loads nothing)
  auto group = [&](int g, auto last) {
    unsigned got = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int t = g + 31 - j;
      if (!decltype(last)::value || t >= 0) {
        got |= (s & 1u) << (31 - j);
        s = ((static_cast<unsigned>(w[j] >> s) << up) & top) | (s >> 1);
      }
      // then the next group's word for position j into w[j]'s registers:
      // its load has the 31 steps after this one, and no copy
      if (!decltype(last)::value)
        w[j] = g - 1 - j >= 0 ? dec[g - 1 - j] : Word(0);
    }
    if (g + L >= 0 && g + L < n_bits)
      out[g + L] = static_cast<unsigned char>((got >> L) & 1u);
  };
  int g = N - 32;
  for (; g > 0; g -= 32) group(g, std::false_type{});
  group(g, std::true_type{});
  tb.stop();
  tr.write(0);
  tb.write(0);
}

// The block form: grid R, block S threads (S > 64); dynamic shared
// memory: the metrics [2][S], the soft tile [2 TILE] and, when ``gdec``
// is null, the decisions [N][W].
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
  const int lo = n >> 1, hi = lo + S / 2;
  const float elo0 = __popc(n & g1) & 1, elo1 = __popc(n & g2) & 1;
  const float ehi0 = __popc((n + S) & g1) & 1,
              ehi1 = __popc((n + S) & g2) & 1;
  met[n] = n == 0 ? 0.f : BIG;
  sdr::ChainClock tr(n == 0 && clk ? clk + 4 * r : nullptr);
  sdr::ChainClock tb(n == 0 && clk ? clk + 4 * r + 2 : nullptr);
  int cur = 0;
  for (int t0 = 0; t0 < N; t0 += TILE) {
    const int m = min(TILE, N - t0);
    __syncthreads();
    for (int i = n; i < 2 * m; i += blockDim.x) obs[i] = in[2 * t0 + i];
    __syncthreads();
    tr.start();
    for (int i = 0; i < m; ++i) {
      const float o0 = obs[2 * i], o1 = obs[2 * i + 1];
      bool take_hi;
      met[(cur ^ 1) * S + n] =
          acs(met[cur * S + lo], met[cur * S + hi],
              branch(o0, o1, elo0, elo1), branch(o0, o1, ehi0, ehi1),
              take_hi);
      const unsigned word = __ballot_sync(FULL, take_hi);
      if ((n & 31) == 0)
        dec[static_cast<long>(t0 + i) * W + (n >> 5)] = word;
      __syncthreads();
      cur ^= 1;
    }
    tr.stop();
  }
  final_metrics[static_cast<long>(r) * S + n] = met[cur * S + n];
  if (gdec) __threadfence_block();
  __syncthreads();
  if (n == 0) {
    tb.start();
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
    tb.stop();
    tr.write(0);
    tb.write(0);
  }
}

}  // namespace

// soft [R, 2N] float32 (each frame's coded bits as values in [0, 1]);
// polynomials g1, g2 and constraint length k (S = 2^(k-1) <= 1024 states);
// scratch null, or [R, N, ceil(S/32)] uint32 of global memory for the
// decisions, needed where N * ceil(S/32) words exceed DEC_SMEM_MAX
// (ops/fec.py:DEC_SMEM_MAX).  Out: bits [R, N - (k - 1)] uint8,
// final_metrics [R, S] float32; clk null or [R, 4] uint64.  S <= 64 runs
// the warp form, a larger S the block form.
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
  const int n_bits = N - (k - 1);
  if (S <= WARP_STATES) {
    const size_t bytes = sizeof(float) * BM_TABLE + (scratch ? 0 : dec);
    auto kern = S == WARP_STATES ? viterbi_warp_kernel<2>
                                 : viterbi_warp_kernel<1>;
    const cudaError_t e = sdr::allow_smem(kern, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<R, 32, bytes, stream>>>(soft, N, S, k, g1, g2, n_bits, scratch,
                                   bits, final_metrics, clk);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes =
      sizeof(float) * (2 * S + 2 * TILE) + (scratch ? 0 : dec);
  const cudaError_t e = sdr::allow_smem(viterbi_kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  viterbi_kernel<<<R, S, bytes, stream>>>(soft, N, S, g1, g2, n_bits,
                                          scratch, bits, final_metrics, clk);
  return static_cast<int>(cudaGetLastError());
}
