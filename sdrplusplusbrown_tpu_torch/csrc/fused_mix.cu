// K11 — shared-wideband mix-down folded into the first decimating FIR,
// for the front-end chains K1 cannot take.
//
// Replaces: sdrplusplusbrown_tpu/ops/pallas_fir.py:_fused_mix_kernel (the
// pre-twiddle sums, which ops/fused_frontend.py:SharedXlateDecimFIR there
// twiddles in XLA) and _fused_mix_planes_kernel (the same with the
// decimated-rate twiddle in the kernel, behind ops/plane_frontend.py).
// Both end in the twiddled IF, which is what K11 writes.  Per channel c
// of C VFOs on one shared wideband ext = concat(tail (K-1 samples),
// x (T samples)):
//     g_c[k] = h[k] * e^{j omega_c k}                 (float32 omega_c*k)
//     pre_c[m] = sum_k g_c[k] * ext[m*D + k]            m < M = T/D
//     y_c[m]   = pre_c[m] * rotor_c[m]
//     rotor_c[m] = e^{j(phase0_c + (omega_dec_span_c*(m/1024) mod 2pi))}
//                * e^{j omega_dec_c*(m%1024)}          (M > 1024)
//     phase0_c   = ((phase_c - omega_c*(K-1) + pi) mod 2pi) - pi
// written as float32 rows: re of channel c in row c, im in row C + c.
// The TPU bodies build a strided window matrix and reach the MXU through
// one-hot and selection matmuls (Mosaic has no strided lane slice); their
// in-kernel twiddle takes its base phase per 2 048-output super-tile.  The
// port applies one twiddle form for every C, the XLA route's ``rotor``,
// whose host-float64 span keeps float32 away from large phase products.
//
// What bounds it on the H100: at the 10 MS/s bank (T = 1 040 000, K = 31,
// D = 4, C = 4) the function reads 8.3 MB and writes 8.3 MB (5 us at
// 3.35 TB/s) and does 2*2*2*C*K*M = 0.26 Gflop (4 us at 67 TFLOP/s), plus
// one sincosf a channel and output for the twiddle.  The earlier design
// (one thread an output, the window read at stride D) spent its time on
// the shared-memory pipe: one window load and 2*C broadcast tap loads a
// tap, a D-way bank conflict on each window load, and 8 channel slots
// whatever C was.  This one:
//   * a block is B consecutive outputs (``fused_plan``: 512, 256 or 128,
//     inside one 1 024-output rotor group) of one chunk of channels
//     (8, 4, 2 or 1: C = 4 runs one chunk of 4, C = 12 one of 8 and one
//     of 4; grid.y walks the chunks);
//   * the window is staged once, split by input phase q = e mod D into D
//     planes, with one pad word every MIX_R words; thread t owns the
//     MIX_R consecutive outputs from t*MIX_R, so its taps of phase q read
//     consecutive words of plane q, and a warp's loads hit 32 banks;
//   * register blocking: each tap's channel values (two 16-byte broadcast
//     loads at 4 channels) serve MIX_R outputs, and for D = 2 and 4 each
//     plane's window slides through registers (one load a tap for MIX_R
//     outputs), so the FP32 pipe, not the load pipe, sets the pace;
//   * each output keeps the earlier accumulation order (the re plane's
//     taps in ascending k, then the im plane's, one fmaf a tap), so every
//     output is bit-identical to the earlier kernel's;
//   * the phase work is hoisted: phase0, the span wrap and its sincosf once
//     a channel and block, one sincosf a channel and output (one called
//     copy of its code, not sixteen inlined); the modulated taps once a
//     block, as before; y leaves in 16-byte stores;
//   * 128 threads a block, at most 96 registers a thread: five blocks an
//     SM hide the twiddle's dependent chains better than four.
// What bounds it now (scripts/chz_mix_sweep.py --parts; PERF.md has the
// numbers): neither pipe.  At the bank's shape the taps take about two
// fifths of the time, twice their FP32 issue time, the per-output
// sincosf about a fifth, staging and stores the rest: the warps wait on
// their loads and on sincosf's dependent chains more than they issue.
// All phase arithmetic rounds each operation on its own (no fused
// multiply-add), as the plain version's torch ops do.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MIX_R = 4;         // consecutive outputs a thread
constexpr int MIX_THREADS = 128;  // at most a block: 512 outputs
// (five blocks an SM: at most 96 registers a thread)
constexpr float PI_F = 3.14159274101257324f;      // float32(pi)
constexpr float TWO_PI_F = 6.28318548202514648f;  // float32(2 pi)

// jnp.mod / torch's fmod_floor for a positive divisor: the exact fmod
// remainder, moved up by y where it is negative.
__device__ __forceinline__ float mod_floor(float x, float y) {
  const float r = fmodf(x, y);
  return (r != 0.f && r < 0.f) ? __fadd_rn(r, y) : r;
}

// Layout of one block's shared memory (floats), as ``fused_plan`` sizes it.
struct MixLayout {
  int L;      // plane samples: B + ceil(K/D) + MIX_R
  int PS;     // plane stride: L padded by a word every MIX_R, + 1
  int tab;    // the chunk's taps: 2 passes x K x {a, b} x ncm
  int par;    // phase0, cos and sin of the span phase, omega_dec: 4 x ncm
  int total;
};

__host__ __device__ inline MixLayout mix_layout(int B, int K, int D,
                                                int ncm) {
  MixLayout l;
  l.L = B + (K + D - 1) / D + MIX_R;
  l.PS = l.L + l.L / MIX_R + 1;
  l.tab = (2 * D * l.PS + 3) & ~3;
  l.par = l.tab + 4 * K * ncm;
  l.total = l.par + 4 * ncm;
  return l;
}

// Chunk y of the channels: C / ncm chunks of ncm, then the rest in
// descending powers of two.
__device__ __forceinline__ void chunk_of(int y, int C, int ncm, int& c0,
                                         int& nc) {
  const int full = C / ncm;
  c0 = min(y, full) * ncm;
  nc = ncm;
  if (y < full) return;
  int idx = y - full;
  const int rem = C - full * ncm;
  for (int b = ncm >> 1; b >= 1; b >>= 1) {
    if (!(rem & b)) continue;
    if (idx == 0) {
      nc = b;
      return;
    }
    c0 += b;
    --idx;
  }
  nc = 0;
}

template <int NC>
__device__ __forceinline__ void load_taps(const float* p, float (&ga)[NC],
                                          float (&gb)[NC]) {
  if constexpr (NC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NC / 4; ++i) {
      const float4 a = reinterpret_cast<const float4*>(p)[i];
      const float4 b = reinterpret_cast<const float4*>(p + NC)[i];
      ga[4 * i] = a.x, ga[4 * i + 1] = a.y, ga[4 * i + 2] = a.z,
      ga[4 * i + 3] = a.w;
      gb[4 * i] = b.x, gb[4 * i + 1] = b.y, gb[4 * i + 2] = b.z,
      gb[4 * i + 3] = b.w;
    }
  } else if constexpr (NC == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    const float2 b = *reinterpret_cast<const float2*>(p + 2);
    ga[0] = a.x, ga[1] = a.y, gb[0] = b.x, gb[1] = b.y;
  } else {
    ga[0] = p[0];
    gb[0] = p[1];
  }
}

template <int NC>
__device__ __forceinline__ void tap_fma(const float (&ga)[NC],
                                        const float (&gb)[NC], float v, int r,
                                        float (&aa)[NC][MIX_R],
                                        float (&ab)[NC][MIX_R]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    aa[c][r] = fmaf(ga[c], v, aa[c][r]);
    ab[c][r] = fmaf(gb[c], v, ab[c][r]);
  }
}

// One plane set's taps (re or im) into every output of the thread:
// aa += ga[k] * ext, ab += gb[k] * ext for k = 0..K-1 in order.  ``pl``
// points at the thread's first window word of phase plane 0.
template <int NC, int DT>
__device__ __forceinline__ void tap_pass(const float* __restrict__ pl, int PS,
                                         const float* __restrict__ tab, int K,
                                         int D, float (&aa)[NC][MIX_R],
                                         float (&ab)[NC][MIX_R]) {
  constexpr int R = MIX_R;
  if constexpr (DT > 0) {
    // plane q's window slides through w[q]: slot x holds sample s + r of
    // the thread's run where (s + r) % R == x; word n of the run sits at
    // n + n / R
    const int S = (K + DT - 1) / DT;
    float w[DT][R];
#pragma unroll
    for (int q = 0; q < DT; ++q)
#pragma unroll
      for (int x = 0; x < R; ++x) w[q][x] = pl[q * PS + x];
    for (int s0 = 0; s0 < S; s0 += R) {
      const float* p = pl + s0 + s0 / R + R + 1;
#pragma unroll
      for (int ds = 0; ds < R; ++ds) {
        if (s0 + ds >= S) break;
#pragma unroll
        for (int q = 0; q < DT; ++q) {
          const int k = (s0 + ds) * DT + q;
          if (k < K) {
            float ga[NC], gb[NC];
            load_taps<NC>(tab + k * 2 * NC, ga, gb);
#pragma unroll
            for (int r = 0; r < R; ++r)
              tap_fma<NC>(ga, gb, w[q][(ds + r) % R], r, aa, ab);
          }
          w[q][ds] = p[q * PS + ds];
        }
      }
    }
  } else {
    // any other decimation: the run's R samples of the tap's plane are
    // loaded for each tap
    for (int k = 0; k < K; ++k) {
      const int s = k / D;
      const float* p = pl + (k - s * D) * PS;
      float ga[NC], gb[NC];
      load_taps<NC>(tab + k * 2 * NC, ga, gb);
#pragma unroll
      for (int r = 0; r < R; ++r)
        tap_fma<NC>(ga, gb, p[s + r + (s + r) / R], r, aa, ab);
    }
  }
}

// sincosf as a call: one copy of its code for the 4·NC twiddles of a
// thread, not one inlined copy each (the same function, the same bits).
__device__ __noinline__ void sincos_call(float a, float* s, float* c) {
  sincosf(a, s, c);
}

template <int NC, int DT>
__device__ __forceinline__ void mix_block(
    float* smem, const MixLayout& lay, const float* __restrict__ xr,
    const float* __restrict__ xi, int T, const float* __restrict__ tail_r,
    const float* __restrict__ tail_i, const float* __restrict__ h, int K,
    int D, const float* __restrict__ omega, const float* __restrict__ phase,
    const float* __restrict__ omega_dec,
    const float* __restrict__ omega_dec_span, int C, int c0,
    float* __restrict__ y, int M, int B) {
  constexpr int R = MIX_R;
  const int Dv = DT > 0 ? DT : D;
  const int PS = lay.PS;
  float* sre = smem;
  float* sim = smem + Dv * PS;
  float* tab = smem + lay.tab;
  float* par = smem + lay.par;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m0 = blockIdx.x * B;

  // ---- the window, split by input phase --------------------------------
  const int n = lay.L * Dv;
  const long i0 = static_cast<long>(m0) * Dv - (K - 1);  // x index of e0
  auto put = [&](int idx, float a, float b) {
    const int q = idx % Dv, j = idx / Dv;
    const int o = q * PS + j + j / R;
    sre[o] = a;
    sim[o] = b;
  };
  auto ext = [&](long i, float& a, float& b) {
    if (i < 0) {
      a = tail_r[i + K - 1];
      b = tail_i[i + K - 1];
    } else if (i < T) {
      a = xr[i];
      b = xi[i];
    } else {
      a = b = 0.f;
    }
  };
  long a0 = (max(i0, 0L) + 3) & ~3L;
  long a1 = min(i0 + n, static_cast<long>(T)) & ~3L;
  if (a1 <= a0 ||
      ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(xi)) &
       15))
    a0 = a1 = i0 + n;
  for (int idx = tid; idx < a0 - i0; idx += nt) {
    float a, b;
    ext(i0 + idx, a, b);
    put(idx, a, b);
  }
  for (int idx = static_cast<int>(a1 - i0) + tid; idx < n; idx += nt) {
    float a, b;
    ext(i0 + idx, a, b);
    put(idx, a, b);
  }
  const int nv = static_cast<int>((a1 - a0) >> 2);
  const float4* vr = reinterpret_cast<const float4*>(xr + a0);
  const float4* vi = reinterpret_cast<const float4*>(xi + a0);
  for (int u = tid; u < nv; u += nt) {
    const float4 a = __ldg(vr + u), b = __ldg(vi + u);
    const int idx = static_cast<int>(a0 - i0) + 4 * u;
    put(idx, a.x, b.x);
    put(idx + 1, a.y, b.y);
    put(idx + 2, a.z, b.z);
    put(idx + 3, a.w, b.w);
  }

  // ---- the chunk's modulated taps: pass 0 (re plane) {gr, gi}, pass 1
  // (im plane) {-gi, gr}: re += a*v, im += b*v --------------------------
  for (int i = tid; i < NC * K; i += nt) {
    const int c = i / K;
    const int k = i - c * K;
    float s, co;
    sincosf(__fmul_rn(omega[c0 + c], static_cast<float>(k)), &s, &co);
    const float gr = __fmul_rn(h[k], co), gi = __fmul_rn(h[k], s);
    float* t0 = tab + k * 2 * NC;
    float* t1 = tab + (K + k) * 2 * NC;
    t0[c] = gr;
    t0[NC + c] = gi;
    t1[c] = -gi;
    t1[NC + c] = gr;
  }
  // ---- once a channel and block: phase0, the span phase's sincosf -------
  if (tid < NC) {
    const int ch = c0 + tid;
    const float p0 = __fsub_rn(
        mod_floor(__fadd_rn(__fsub_rn(phase[ch],
                                      __fmul_rn(omega[ch],
                                                static_cast<float>(K - 1))),
                            PI_F),
                  TWO_PI_F),
        PI_F);
    float sm = 0.f, cm = 1.f;
    if (M > 1024) {
      const float am = __fadd_rn(
          p0, mod_floor(__fmul_rn(omega_dec_span[ch],
                                  static_cast<float>(m0 >> 10)),
                        TWO_PI_F));
      sincosf(am, &sm, &cm);
    }
    par[tid] = p0;
    par[NC + tid] = cm;
    par[2 * NC + tid] = sm;
    par[3 * NC + tid] = omega_dec[ch];
  }
  __syncthreads();

  // ---- the taps: re plane, then im plane, each in ascending k ----------
  float ar[NC][R], ai[NC][R];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < R; ++r) ar[c][r] = ai[c][r] = 0.f;
  const int run = tid * (R + 1);   // padded start of the thread's run
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass)  // one copy of the loop's code
    tap_pass<NC, DT>(smem + pass * Dv * PS + run, PS, tab + pass * K * 2 * NC,
                     K, Dv, ar, ai);

  // ---- twiddle and store -------------------------------------------------
  const int mt = m0 + tid * R;
  const bool vec = !(M & 3) && mt + R <= M;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float p0 = par[c], cm = par[NC + c], sm = par[2 * NC + c];
    const float od = par[3 * NC + c];
    float yr[R], yi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = mt + r;
      float tr, ti;
      if (M > 1024) {
        float sk, ck;
        sincos_call(__fmul_rn(od, static_cast<float>(m & 1023)), &sk, &ck);
        tr = __fsub_rn(__fmul_rn(cm, ck), __fmul_rn(sm, sk));
        ti = __fadd_rn(__fmul_rn(cm, sk), __fmul_rn(sm, ck));
      } else {
        sincosf(__fadd_rn(p0, __fmul_rn(od, static_cast<float>(m))), &ti,
                &tr);
      }
      yr[r] = __fsub_rn(__fmul_rn(ar[c][r], tr), __fmul_rn(ai[c][r], ti));
      yi[r] = __fadd_rn(__fmul_rn(ar[c][r], ti), __fmul_rn(ai[c][r], tr));
    }
    float* rowr = y + static_cast<long>(c0 + c) * M;
    float* rowi = y + static_cast<long>(C + c0 + c) * M;
    if (vec) {
      *reinterpret_cast<float4*>(rowr + mt) =
          make_float4(yr[0], yr[1], yr[2], yr[3]);
      *reinterpret_cast<float4*>(rowi + mt) =
          make_float4(yi[0], yi[1], yi[2], yi[3]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (mt + r < M) {
          rowr[mt + r] = yr[r];
          rowi[mt + r] = yi[r];
        }
      }
    }
  }
}

template <int DT>
__device__ __forceinline__ void mix_dispatch(
    int nc, float* smem, const MixLayout& lay, const float* xr,
    const float* xi, int T, const float* tail_r, const float* tail_i,
    const float* h, int K, int D, const float* omega, const float* phase,
    const float* omega_dec, const float* omega_dec_span, int C, int c0,
    float* y, int M, int B) {
#define SDR_MIX(N)                                                          \
  mix_block<N, DT>(smem, lay, xr, xi, T, tail_r, tail_i, h, K, D, omega,    \
                   phase, omega_dec, omega_dec_span, C, c0, y, M, B)
  switch (nc) {
    case 8: SDR_MIX(8); break;
    case 4: SDR_MIX(4); break;
    case 2: SDR_MIX(2); break;
    default: SDR_MIX(1); break;
  }
#undef SDR_MIX
}

__global__ void __launch_bounds__(MIX_THREADS, 5) fused_mix_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi, int T,
    const float* __restrict__ tail_r, const float* __restrict__ tail_i,
    const float* __restrict__ h, int K, int D,
    const float* __restrict__ omega, const float* __restrict__ phase,
    const float* __restrict__ omega_dec,
    const float* __restrict__ omega_dec_span, int C,
    float* __restrict__ y, int M, int B, int ncm) {
  extern __shared__ __align__(16) float smem[];
  int c0, nc;
  chunk_of(blockIdx.y, C, ncm, c0, nc);
  const MixLayout lay = mix_layout(B, K, D, ncm);
  if (D == 4)
    mix_dispatch<4>(nc, smem, lay, xr, xi, T, tail_r, tail_i, h, K, D, omega,
                    phase, omega_dec, omega_dec_span, C, c0, y, M, B);
  else if (D == 2)
    mix_dispatch<2>(nc, smem, lay, xr, xi, T, tail_r, tail_i, h, K, D, omega,
                    phase, omega_dec, omega_dec_span, C, c0, y, M, B);
  else
    mix_dispatch<0>(nc, smem, lay, xr, xi, T, tail_r, tail_i, h, K, D, omega,
                    phase, omega_dec, omega_dec_span, C, c0, y, M, B);
}

}  // namespace

// xr, xi [T]; tail_r, tail_i [K-1]; h [K]; omega, phase, omega_dec,
// omega_dec_span [C]; y [2C, M] with M = T / D; all float32, dense.  B
// outputs a block (128, 256 or 512) and ncm channels at most a
// chunk (1, 2, 4 or 8) come from ops/fused_frontend.py:fused_plan.
extern "C" int sdr_fused_mix(const float* xr, const float* xi, int T,
                             const float* tail_r, const float* tail_i,
                             const float* h, int K, int D, const float* omega,
                             const float* phase, const float* omega_dec,
                             const float* omega_dec_span, int C,
                             float* y, int M, int B, int ncm,
                             cudaStream_t stream) {
  if (T < 1 || K < 1 || D < 1 || C < 1 || M < 1 ||
      static_cast<long>(M - 1) * D + K > static_cast<long>(T) + K - 1 ||
      B < 32 * MIX_R || B > MIX_THREADS * MIX_R || 1024 % B || ncm < 1 ||
      ncm > 8 ||
      (ncm & (ncm - 1)) || ncm > C)
    return cudaErrorInvalidValue;
  const size_t smem = mix_layout(B, K, D, ncm).total * sizeof(float);
  const cudaError_t e = sdr::allow_smem(fused_mix_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int chunks = C / ncm;
  for (int b = ncm >> 1; b >= 1; b >>= 1) chunks += ((C % ncm) & b) ? 1 : 0;
  const dim3 grid((M + B - 1) / B, chunks);
  fused_mix_kernel<<<grid, B / MIX_R, smem, stream>>>(
      xr, xi, T, tail_r, tail_i, h, K, D, omega, phase, omega_dec,
      omega_dec_span, C, y, M, B, ncm);
  return static_cast<int>(cudaGetLastError());
}
