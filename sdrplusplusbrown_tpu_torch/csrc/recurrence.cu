// K15 — the first-order linear recurrence y[n] = a[n]·y[n-1] + b[n]
// along each row, y[-1] = y0: the IQ front end's and the AM demod's DC
// blockers, the IF noise blanker's envelope and the slow de-emphasis pole.
//
// Replaces: sdrplusplusbrown_tpu/ops/recurrence.py:linear_recurrence (:22),
// ``jax.lax.associative_scan`` over affine maps (no Pallas body; XLA
// compiles the scan).  Its torch form (ops/recurrence.py:_scan, the plain
// version) is the same odd/even recursion, ~11 torch calls a level, ~195
// launches a 120 000-sample row.
//
// Three forms, one launch each (FORM):
//   SCAN  y = the recurrence of (a, b): a scalar pole or one a sample;
//   DC    the DC blocker on x: b = gain·x, a the pole, and out[n] = x[n] -
//         y[n-1] with y[-1] = y0; the last y is the new state;
//   NB    the noise blanker on x: m = |x|, a = m != 0 ? pole : 1, b = m != 0
//         ? gain·m : 0; the envelope y; e = m != 0 ? m / y : 1, out = x·(e >
//         level ? 1 / e : 1); the last y is the new state.
// Every elementwise step of DC and NB rounds on its own, as the torch ops
// of the plain route do (ops/recurrence.py:dc_route, nb_route): run on
// the SCAN form's output, those ops give these forms' outputs bit for bit.
// |x| is hypotf, as torch's abs of complex64 on the card.
//
// A row is one thread-block cluster of C blocks (``cluster_size``: as
// many as give each warp a batch, at most 16), so the served block's
// 120 000 samples spread over 16 SMs, not one.  Each block takes a run of whole batches,
// cut into WARPS segments, one a warp.  A batch is BATCH = 32·K samples:
// lane l takes its K contiguous samples.  Each warp's segment goes into
// shared memory first (cp.async, 16 bytes a copy, every copy in flight at
// once; what does not fit in the block's 224 KB stays in global memory).
//   1. each warp composes its segment's maps, batch by batch: each lane
//      its K samples' map, a warp scan of the 32 lanes' (shuffles), the
//      batch's map (lane 31's) folded into the segment's;
//   2. warp 0 scans the block's WARPS segment maps: the block's map, put
//      in shared memory for the cluster's later blocks;
//   3. after the cluster's barrier, warp 0 reads the maps of the blocks
//      before its own through distributed shared memory (a lane a block)
//      and applies them to y0 in order: the block's start; the prefix
//      before each segment applied to it: each segment's start; and the
//      next block's;
//   4. each warp walks its segment again, batch by batch: the warp scan of
//      the lanes' maps again, each lane's start the carried y through the
//      lanes before it, its K samples walked, their outputs written over
//      their inputs in shared memory; lane 31's last y the next batch's
//      carry.  Then the warp copies its segment out, consecutive lanes on
//      consecutive 16 bytes.
// Each y is the walked one, but at a segment's last sample (short of the
// row's end) the next segment's start: the same value, rounded as the
// next segment starts from it.  So the DC blocker's y[n-1], taken from the
// written values, is the scan form's, and the noise blanker's envelope
// too.  The blocks of a cluster are co-scheduled, so the exchange needs
// no flags in global memory and no second launch; a block leaves only
// after every block of its cluster has read its map.
// The composition is the scan's (A1·A2, B1·A2 + B2), each a·y + b one
// fused multiply-add, grouped by lanes, batches, segments and blocks: the
// sums differ from the doubling scan's in rounding only.  Both take the
// pole's powers as float32 products, whose rounding is most of their
// error, and the batches' warp scans compose those powers in trees as the
// doubling scan does: the two agree to ~138 dB at the DC blocker's pole
// (tests/torch_parity.py:recurrence_chunks_model is a numpy model of this
// grouping; a thread walking a contiguous chunk, composed sample by
// sample, was ~9 dB closer to the float64 recurrence but only 83 dB from
// the doubling scan).  x and y are float32 or complex64 [R, T] (CPLX:
// interleaved, a real a scaling both parts); NB's envelope and state are
// float32.
//
// What bounds it on the H100: the batches' chains of dependent shuffles,
// and a block's bytes through its SM (16 SMs of 132 carry a row).  The
// earlier kernel (a block a row) put one SM on the served block (77.7 µs).  In a
// first cluster version the walk's lane-strided 8-byte stores took most of
// the time (18 of 43.6 µs at 480 000 samples, globaltimer stamps by
// phase): the outputs now leave through shared memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int K = 4;                  // contiguous samples a lane
constexpr int BATCH = 32 * K;         // samples a warp takes at once
constexpr int CLUSTER_MAX = 16;       // blocks a row (non-portable maximum)
constexpr int SMEM_MAX = 224 * 1024;  // a block's staged run, at most
constexpr unsigned FULL = 0xffffffffu;
static_assert(WARPS == 32, "step 2 scans the segments' maps in one warp");
static_assert(CLUSTER_MAX <= 32, "step 3 reads a block's map a lane");

enum { SCAN = 0, DC = 1, NB = 2 };

template <bool CPLX>
struct Val;
template <>
struct Val<false> {
  using T = float;
  __device__ static float zero() { return 0.0f; }
  // a·y + b, one rounding
  __device__ static float axpy(float a, float y, float b) {
    return __fmaf_rn(a, y, b);
  }
  __device__ static float scale(float v, float g) { return __fmul_rn(v, g); }
  __device__ static float sub(float u, float v) { return __fsub_rn(u, v); }
  __device__ static float mag(float v) { return fabsf(v); }
  __device__ static float shfl_up(float v, int d) {
    return __shfl_up_sync(FULL, v, d);
  }
  __device__ static float shfl(float v, int src) {
    return __shfl_sync(FULL, v, src);
  }
  // K elements at a 16-byte aligned address
  __device__ static void ld(const float* s, float (&o)[K]) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
  __device__ static void st(float* s, const float (&o)[K]) {
    *reinterpret_cast<float4*>(s) = make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <>
struct Val<true> {
  using T = float2;
  __device__ static float2 zero() { return make_float2(0.0f, 0.0f); }
  __device__ static float2 axpy(float a, float2 y, float2 b) {
    return make_float2(__fmaf_rn(a, y.x, b.x), __fmaf_rn(a, y.y, b.y));
  }
  __device__ static float2 scale(float2 v, float g) {
    return make_float2(__fmul_rn(v.x, g), __fmul_rn(v.y, g));
  }
  __device__ static float2 sub(float2 u, float2 v) {
    return make_float2(__fsub_rn(u.x, v.x), __fsub_rn(u.y, v.y));
  }
  __device__ static float mag(float2 v) { return hypotf(v.x, v.y); }
  __device__ static float2 shfl_up(float2 v, int d) {
    return make_float2(__shfl_up_sync(FULL, v.x, d),
                       __shfl_up_sync(FULL, v.y, d));
  }
  __device__ static float2 shfl(float2 v, int src) {
    return make_float2(__shfl_sync(FULL, v.x, src),
                       __shfl_sync(FULL, v.y, src));
  }
  __device__ static void ld(const float2* s, float2 (&o)[K]) {
    const float4 u = *reinterpret_cast<const float4*>(s);
    const float4 v = *reinterpret_cast<const float4*>(s + 2);
    o[0] = make_float2(u.x, u.y);
    o[1] = make_float2(u.z, u.w);
    o[2] = make_float2(v.x, v.y);
    o[3] = make_float2(v.z, v.w);
  }
  __device__ static void st(float2* s, const float2 (&o)[K]) {
    *reinterpret_cast<float4*>(s) = make_float4(o[0].x, o[0].y, o[1].x,
                                                o[1].y);
    *reinterpret_cast<float4*>(s + 2) = make_float4(o[2].x, o[2].y, o[3].x,
                                                    o[3].y);
  }
};

// What a lane keeps of a sample from its load to its use: the scan's
// (a, b), or the fused forms' x.
template <int FORM, bool CPLX>
struct In {
  typename Val<CPLX>::T x;
};
template <bool CPLX>
struct In<SCAN, CPLX> {
  float a;
  typename Val<CPLX>::T b;
};

struct Args {
  const float* a;       // SCAN: a pole a sample [R, T], or null (pole)
  float pole;           // the scalar pole (SCAN with a null, DC, NB)
  float gain;           // DC: b = gain·x; NB: b = gain·|x|
  const float* level;   // NB: the threshold (a device scalar), or null
  float level_scalar;   // NB: the threshold where ``level`` is null
  const void* x;        // SCAN: b; DC, NB: x; [R, T]
  const void* y0;       // [R]
  int T;
  int cap;              // samples of a block's run staged in shared memory
  void* y;              // [R, T]: SCAN y, DC and NB out
  void* state;          // [R]: DC and NB, the row's last y
};

// BYTES (4, 8 or 16) global -> shared without a register round trip, in
// the current cp.async group.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(BYTES));
}

template <int BYTES>
struct Word;
template <>
struct Word<4> {
  using T = float;
};
template <>
struct Word<8> {
  using T = float2;
};

// n bytes (a multiple of ELT) from global src into shared dst by a warp's
// lanes, consecutive lanes on consecutive words: 16 bytes a copy where
// src is 16-byte aligned (dst always is), then ELT.
template <int ELT>
__device__ __forceinline__ void stage_in(unsigned char* dst,
                                         const unsigned char* src, int n,
                                         int lane) {
  int done = 0;
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    for (int j = lane; j < n / 16; j += 32)
      cp_async<16>(dst + 16 * j, src + 16 * j);
    done = n / 16 * 16;
  }
  for (int j = done / ELT + lane; j < n / ELT; j += 32)
    cp_async<ELT>(dst + ELT * j, src + ELT * j);
}

// n bytes (a multiple of ELT) from shared src out to global dst, as
// stage_in: 16-byte stores where dst is 16-byte aligned.
template <int ELT>
__device__ __forceinline__ void stage_out(unsigned char* dst,
                                          const unsigned char* src, int n,
                                          int lane) {
  using W = typename Word<ELT>::T;
  int done = 0;
  if ((reinterpret_cast<size_t>(dst) & 15) == 0) {
    for (int j = lane; j < n / 16; j += 32)
      reinterpret_cast<float4*>(dst)[j] =
          reinterpret_cast<const float4*>(src)[j];
    done = n / 16 * 16;
  }
  for (int j = done / ELT + lane; j < n / ELT; j += 32)
    reinterpret_cast<W*>(dst)[j] = reinterpret_cast<const W*>(src)[j];
}

// Where a block's run lies: [run0, staged) in shared memory (sx, and sa
// for a pole a sample), [staged, run1) in global memory.
template <bool CPLX>
struct Run {
  const typename Val<CPLX>::T* xr;  // the row in global memory
  const float* ar;                  // the row's poles, or null
  typename Val<CPLX>::T* sx;
  const float* sa;
  int run0, staged;
};

// A lane's K samples at i0 (index within the row; a batch wholly staged
// or wholly not, as ``staged`` is a batch boundary or the row's end);
// samples from ``end`` on are left for ``coeffs`` to take as the
// identity.
template <int FORM, bool CPLX>
__device__ __forceinline__ void load(const Args& p, const Run<CPLX>& run,
                                     int i0, int end,
                                     In<FORM, CPLX> (&v)[K]) {
  using XT = typename Val<CPLX>::T;
  XT xv[K];
  float av[K];
  if (i0 < run.staged) {
    Val<CPLX>::ld(run.sx + (i0 - run.run0), xv);
    if constexpr (FORM == SCAN) {
      if (run.ar != nullptr) Val<false>::ld(run.sa + (i0 - run.run0), av);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool in = i0 + k < end;
      xv[k] = in ? run.xr[i0 + k] : Val<CPLX>::zero();
      if constexpr (FORM == SCAN) {
        if (run.ar != nullptr) av[k] = in ? run.ar[i0 + k] : 1.0f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if constexpr (FORM == SCAN) {
      const bool in = i0 + k < end;
      v[k].a = !in ? 1.0f : run.ar == nullptr ? p.pole : av[k];
      v[k].b = in ? xv[k] : Val<CPLX>::zero();
    } else {
      v[k].x = xv[k];
    }
  }
}

// A sample's (a, b); past the segment's end (``in`` false) the identity,
// a = 1 and b = 0, which leaves a map and a walk as they are.
template <int FORM, bool CPLX, typename VT>
__device__ __forceinline__ void coeffs(const Args& p,
                                       const In<FORM, CPLX>& v, bool in,
                                       float& a, VT& b) {
  if constexpr (FORM == SCAN) {
    a = v.a;
    b = v.b;
  } else if constexpr (FORM == DC) {
    a = in ? p.pole : 1.0f;
    b = in ? Val<CPLX>::scale(v.x, p.gain) : Val<CPLX>::zero();
  } else {
    const float m = in ? Val<CPLX>::mag(v.x) : 0.0f;
    const bool nz = m != 0.0f;
    a = nz ? p.pole : 1.0f;
    b = nz ? __fmul_rn(m, p.gain) : 0.0f;
  }
}

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
      A = __fmul_rn(Ap, A);
    }
  }
}

// The lane's map over its K samples at i0 (samples from ``end`` on are
// the identity).
template <int FORM, bool CPLX, typename V>
__device__ __forceinline__ void lane_map(const Args& p,
                                         const In<FORM, CPLX> (&v)[K],
                                         int i0, int end, float& A,
                                         typename V::T& B) {
  A = 1.0f;
  B = V::zero();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float a;
    typename V::T b;
    coeffs<FORM, CPLX>(p, v[k], i0 + k < end, a, b);
    A = __fmul_rn(A, a);
    B = V::axpy(a, B, b);
  }
}

// The cluster's barrier in two halves (arrive has release and wait
// acquire semantics): every thread of every block arrives, then waits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// grid (C, R), clusters (C, 1, 1), THREADS threads and cap·(sizeof(x) +
// (a pole a sample ? 4 : 0)) bytes of dynamic shared memory: block c of
// row r.
template <int FORM, bool CPLX>
__global__ void __launch_bounds__(THREADS) recurrence_kernel(const Args p) {
  using XV = Val<CPLX>;
  using XT = typename XV::T;
  using V = Val<FORM == NB ? false : CPLX>;
  using VT = typename V::T;
  extern __shared__ __align__(16) unsigned char staged[];
  __shared__ float sA[WARPS];
  __shared__ VT sB[WARPS];
  __shared__ VT sY[WARPS + 1];  // each segment's start, and the next block's
  __shared__ float cA;  // this block's map, read by the cluster's later
  __shared__ VT cB;     // blocks
  const int C = gridDim.x, rank = blockIdx.x, r = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int T = p.T;
  const long base = static_cast<long>(r) * T;
  const int nb = (T + BATCH - 1) / BATCH;
  const int per_block = (nb + C - 1) / C;
  const int per_warp = (per_block + WARPS - 1) / WARPS;
  const int b0 = min(rank * per_block, nb);
  const int b1 = min(b0 + per_block, nb);
  const int wb = min(b0 + w * per_warp, b1);
  const int s0 = wb * BATCH;
  const int s1 = min(min(wb + per_warp, b1) * BATCH, T);
  const int run1 = min(b1 * BATCH, T);
  Run<CPLX> run;
  run.xr = static_cast<const XT*>(p.x) + base;
  run.ar = FORM == SCAN && p.a != nullptr ? p.a + base : nullptr;
  run.sx = reinterpret_cast<XT*>(staged);
  run.sa = reinterpret_cast<const float*>(staged + sizeof(XT) * p.cap);
  run.run0 = b0 * BATCH;
  run.staged = min(run.run0 + p.cap, run1);
  In<FORM, CPLX> cur[K], nxt[K];

  // 0. the warp's segment, as far as the block's staged part reaches it,
  // into shared memory by its lanes: every copy in flight at once, and
  // each warp waits only for its own
  const int held = max(min(s1, run.staged) - s0, 0);
  const int at = s0 - run.run0;
  stage_in<sizeof(XT)>(staged + sizeof(XT) * at,
                       reinterpret_cast<const unsigned char*>(run.xr + s0),
                       held * static_cast<int>(sizeof(XT)), lane);
  if (run.ar != nullptr)
    stage_in<4>(staged + sizeof(XT) * p.cap + 4 * at,
                reinterpret_cast<const unsigned char*>(run.ar + s0),
                4 * held, lane);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
  __syncwarp();

  // 1. the segment's map
  float As = 1.0f;
  VT Bs = V::zero();
  if (s0 < s1) load<FORM, CPLX>(p, run, s0 + lane * K, s1, nxt);
  for (int n = s0; n < s1; n += BATCH) {
#pragma unroll
    for (int k = 0; k < K; ++k) cur[k] = nxt[k];
    if (n + BATCH < s1)
      load<FORM, CPLX>(p, run, n + BATCH + lane * K, s1, nxt);
    float A;
    VT B;
    lane_map<FORM, CPLX, V>(p, cur, n + lane * K, s1, A, B);
    warp_scan<V>(lane, A, B);
    const float At = __shfl_sync(FULL, A, 31);
    const VT Bt = V::shfl(B, 31);
    Bs = V::axpy(At, Bs, Bt);
    As = __fmul_rn(As, At);
  }
  if (lane == 0) {
    sA[w] = As;
    sB[w] = Bs;
  }
  __syncthreads();
  // 2. the block's map, and in warp 0 the map of the segments before each
  float Aw = 1.0f, Al = 1.0f;
  VT Bw = V::zero(), Bl = V::zero();
  if (w == 0) {
    Aw = sA[lane];
    Bw = sB[lane];
    warp_scan<V>(lane, Aw, Bw);
    Al = __shfl_up_sync(FULL, Aw, 1);
    Bl = V::shfl_up(Bw, 1);
    if (lane == 31) {
      cA = Aw;
      cB = Bw;
    }
  }
  cluster_arrive();
  cluster_wait();
  // 3. the block's start: the blocks before it applied to y0 in order;
  // each segment's start, and after the last the next block's
  if (w == 0) {
    float Aj = 1.0f;
    VT Bj = V::zero();
    if (lane < rank) {
      cg::cluster_group cl = cg::this_cluster();
      Aj = *cl.map_shared_rank(&cA, lane);
      Bj = *cl.map_shared_rank(&cB, lane);
    }
    VT y = static_cast<const VT*>(p.y0)[r];
    for (int j = 0; j < rank; ++j)
      y = V::axpy(__shfl_sync(FULL, Aj, j), y, V::shfl(Bj, j));
    sY[lane] = lane == 0 ? y : V::axpy(Al, y, Bl);
    if (lane == 31) sY[WARPS] = V::axpy(Aw, y, Bw);
  }
  __syncthreads();
  cluster_arrive();  // this block is done with the others' maps
  // 4. the walk.  A segment's last sample short of the row's end takes
  // the next segment's start (after the block's last segment, the next
  // block's).
  float level = 0.0f;
  if constexpr (FORM == NB) level = p.level ? *p.level : p.level_scalar;
  const VT next = s1 >= T ? V::zero() : s1 == run1 ? sY[WARPS] : sY[w + 1];
  XT* out = static_cast<XT*>(p.y) + base;
  VT carry = sY[w];
  if (s0 < s1) load<FORM, CPLX>(p, run, s0 + lane * K, s1, nxt);
  for (int n = s0; n < s1; n += BATCH) {
#pragma unroll
    for (int k = 0; k < K; ++k) cur[k] = nxt[k];
    if (n + BATCH < s1)
      load<FORM, CPLX>(p, run, n + BATCH + lane * K, s1, nxt);
    const int i0 = n + lane * K;
    float A;
    VT B;
    lane_map<FORM, CPLX, V>(p, cur, i0, s1, A, B);
    warp_scan<V>(lane, A, B);
    const float Ap = __shfl_up_sync(FULL, A, 1);
    const VT Bp = V::shfl_up(B, 1);
    VT yv = lane == 0 ? carry : V::axpy(Ap, carry, Bp);
    VT yk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float a;
      VT b;
      coeffs<FORM, CPLX>(p, cur[k], i0 + k < s1, a, b);
      yv = V::axpy(a, yv, b);
      yk[k] = i0 + k == s1 - 1 && s1 < T ? next : yv;
    }
    // the sample before the lane's first: the lane before's last, or the
    // carried y
    const VT before = V::shfl_up(yk[K - 1], 1);
    VT prev = lane == 0 ? carry : before;
    XT o[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if constexpr (FORM == SCAN) {
        o[k] = yk[k];
      } else if constexpr (FORM == DC) {
        o[k] = XV::sub(cur[k].x, prev);
      } else {
        const float m = XV::mag(cur[k].x);
        const float e = m != 0.0f ? __fdiv_rn(m, yk[k]) : 1.0f;
        const float g = e > level ? __fdiv_rn(1.0f, e) : 1.0f;
        o[k] = XV::scale(cur[k].x, g);
      }
      prev = yk[k];
    }
    if (i0 < run.staged && i0 + K <= s1) {
      XV::st(run.sx + (i0 - run.run0), o);   // the run leaves below
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (i0 + k < s1) {
          if (i0 < run.staged)
            run.sx[i0 + k - run.run0] = o[k];
          else
            out[i0 + k] = o[k];
        }
      }
    }
    if constexpr (FORM != SCAN) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (i0 + k == T - 1) static_cast<VT*>(p.state)[r] = yk[k];
    }
    carry = V::shfl(yv, 31);
  }
  __syncwarp();
  stage_out<sizeof(XT)>(reinterpret_cast<unsigned char*>(out + s0),
                        staged + sizeof(XT) * at,
                        held * static_cast<int>(sizeof(XT)), lane);
  cluster_wait();  // every block of the cluster has read this one's map
}

cudaLaunchConfig_t config(int C, int R, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, R, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters above 8 blocks are non-portable, and a staged run above 48 KB
// needs the dynamic shared memory allowed: each form opts in once.
template <int FORM, bool CPLX>
cudaError_t opt_in() {
  static cudaError_t done = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        recurrence_kernel<FORM, CPLX>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(
                                  recurrence_kernel<FORM, CPLX>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM_MAX);
  }();
  return done;
}

// The largest cluster (16, 8, 4, 2 or 1 blocks) of which the card can
// hold at least one: a GPC's SMs bound it.
template <int FORM, bool CPLX>
cudaError_t cluster_max(int* out) {
  cudaError_t e = opt_in<FORM, CPLX>();
  if (e != cudaSuccess) return e;
  for (int c = CLUSTER_MAX; c > 1; c /= 2) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(c, 1, SMEM_MAX, nullptr, attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, recurrence_kernel<FORM, CPLX>,
                                       &cfg);
    if (e != cudaSuccess) return e;
    if (n > 0) {
      *out = c;
      return cudaSuccess;
    }
  }
  *out = 1;
  return cudaSuccess;
}

// The largest cluster that every form can launch with on the current
// device, asked once a device: every form then cuts a row alike, so the
// fused forms walk the scan form's segments.
cudaError_t cluster_cap(int* out) {
  constexpr int DEVICES = 64;
  static std::atomic<int> caps[DEVICES];  // 0: not asked yet
  int d = 0;
  cudaError_t e = cudaGetDevice(&d);
  if (e != cudaSuccess) return e;
  if (d < 0 || d >= DEVICES) return cudaErrorInvalidDevice;
  int best = caps[d].load();
  if (best == 0) {
    best = CLUSTER_MAX;
    int c = 0;
#define SDR_K15_MAX(F, X)                                   \
    if ((e = cluster_max<F, X>(&c)) != cudaSuccess) return e; \
    best = std::min(best, c);
    SDR_K15_MAX(SCAN, false)
    SDR_K15_MAX(SCAN, true)
    SDR_K15_MAX(DC, false)
    SDR_K15_MAX(DC, true)
    SDR_K15_MAX(NB, false)
    SDR_K15_MAX(NB, true)
#undef SDR_K15_MAX
    caps[d].store(best);
  }
  *out = best;
  return cudaSuccess;
}

// Blocks a row of T samples: as many as give each warp a batch, at most
// ``cap`` (tests/torch_parity.py:recurrence_cluster_size models it).
int cluster_size(int T, int cap) {
  const int nb = (T + BATCH - 1) / BATCH;
  return std::max(1, std::min(cap, (nb + WARPS - 1) / WARPS));
}

// Samples of a block's run staged in shared memory: the run (whole
// batches), as far as SMEM_MAX bytes hold it at ``bytes`` a sample.
int staged_cap(int T, int C, int bytes) {
  const int nb = (T + BATCH - 1) / BATCH;
  const int per_block = (nb + C - 1) / C;
  return std::min(per_block, SMEM_MAX / (bytes * BATCH)) * BATCH;
}

template <int FORM, bool CPLX>
cudaError_t launch(Args p, int R, cudaStream_t stream) {
  cudaError_t e = opt_in<FORM, CPLX>();
  if (e != cudaSuccess) return e;
  int cmax = 0;
  if ((e = cluster_cap(&cmax)) != cudaSuccess) return e;
  const int C = cluster_size(p.T, cmax);
  const int bytes = static_cast<int>(sizeof(typename Val<CPLX>::T)) +
                    (p.a != nullptr ? 4 : 0);
  p.cap = staged_cap(p.T, C, bytes);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      config(C, R, static_cast<size_t>(p.cap) * bytes, stream, attr);
  return cudaLaunchKernelEx(&cfg, recurrence_kernel<FORM, CPLX>, p);
}

}  // namespace

// form 0 (SCAN), 1 (DC) or 2 (NB); x, y [R, T] float32 (cplx 0) or
// complex64 (cplx 1, interleaved); a null (pole for every sample) or
// float32 [R, T] (SCAN only); y0 [R] and state [R] (DC, NB; null for
// SCAN) of the recurrence's type (NB: float32); level a float32 device
// scalar or null (level_scalar).  One launch, a cluster of
// ``cluster_size(T)`` blocks a row.
extern "C" int sdr_linear_recurrence(const float* a, float pole, float gain,
                                     const float* level, float level_scalar,
                                     const float* x, const float* y0, int R,
                                     int T, int form, int cplx, float* y,
                                     float* state, cudaStream_t stream) {
  if (R < 1 || R > 65535 || T < 1 || form < SCAN || form > NB ||
      (form != SCAN && (a != nullptr || state == nullptr)))
    return cudaErrorInvalidValue;
  const Args p{a, pole, gain, level, level_scalar, x, y0, T, 0, y, state};
  cudaError_t e;
  if (form == SCAN)
    e = cplx ? launch<SCAN, true>(p, R, stream)
             : launch<SCAN, false>(p, R, stream);
  else if (form == DC)
    e = cplx ? launch<DC, true>(p, R, stream)
             : launch<DC, false>(p, R, stream);
  else
    e = cplx ? launch<NB, true>(p, R, stream)
             : launch<NB, false>(p, R, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
