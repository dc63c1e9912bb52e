// K6 — post-channelizer: bin gather, residual NCO, 2:1 FIR, bandwidth FIR,
// squelch sums and the next-call tails.
//
// Replaces: sdrplusplusbrown_tpu/ops/chan_frontend.py:_chan_kernel (chan_body:
// one-hot gather matmul, in-kernel NCO, banded-matmul FIR stages with their
// overlap-save history rolled in VMEM across a sequential grid), which also
// runs as the second half of _chan_fused_kernel_v3.
//
// What it computes, per channel c, from the stacked PFB bins [2P, Tb_pad]
// (float32 or bfloat16 storage; valid frames n < Tb; P rows a plane: the
// PFB's M, or C where K5 computed only the channels' rows, bin_c = c):
//   z[n]  = (bins[bin_c, n] + j·bins[P + bin_c, n]) · e^{jθ(n)},
//           θ(n) = ((ph0 + span·i) + bs·b) + ω·j,  n = i·adv0 + 128·b + j,
//           each product and sum rounded on its own (__fmul_rn/__fadd_rn):
//           the TPU kernel forms the phase so, and one fused multiply-add
//           moves the ~10² rad sum by an ulp;
//   y1[m] = Σ_k d2[k] · ext0[2m + k],  ext0 = [d2 tail (K1−1) | z]
//   y [o] = Σ_k fir[k] · ext1[o + k],  ext1 = [fir tail (K2−1) | y1]
// out [2C, n_out] (re rows over im rows); sq[c, tile] = Σ|y[o]| over the
// tile's VALID outputs (o < m_out: the padded tail is garbage by design),
// which the wrapper sums over the tiles with one torch reduction on the
// device (no atomics, no host copy); and the next-call tails ext0[Tb, Tb +
// K1 − 1) and ext1[m1, m1 + K2 − 1) with m1 = Tb/2, rounded to the handoff
// dtype.  y1 is needed on [0, n_out) only (y[o] reads it up to index o).
//
// What bounds it on the H100: the 304-tap bandwidth FIR, 4·304 flops per
// complex output, about 0.8 GFLOP per 0.1 s block at C = 128 (12.5 µs at
// the FP32 peak), against a few MB of bins in and IF out (~1.4 µs in
// bf16): FP32 issue and the shared-memory reads that feed it.  The design:
// both FIR stages run the polyphase FIR tile (fir_tile.cuh) on complex
// float2 rows, in two launches on ops/chan_frontend.py:chan_post_plan's
// grids, y1 through an HBM scratch [C, n_out] complex64 (5.2 MB at C =
// 128, L2-resident):
//   sdr_chan_post_d2: the gather and the NCO rotate run in the tile's
//     staging hook (ZSrc; bf16 bins upcast once, there), as K2 runs its
//     discriminator, and the 20 taps on the tile's D = 2 register ring;
//   sdr_chan_post_fir: the 304 taps on the D = 1 ring over [fir tail |
//     y1], P = 7 outputs a lane (where the launch still fills the card),
//     one broadcast tap read and one input read per 2P multiply-adds; the
//     store hook (StoreIF) splits each output into the re and im planes
//     of ``out`` in the handoff dtype and sums the valid outputs' |y|
//     into the block's squelch partial.
// Each row's first block writes the row's tail of its stage, each sample
// computed as its hook stages it (ZSrc::value, Y1Src::value).  Every
// output sums its taps in ascending order, one fused multiply-add each,
// and z keeps its expression: the IF and the tails are the bits of the
// one-block-a-tile kernel this replaces (which recomputed a 1.6× halo of
// z and y1 a block); the squelch sums differ in the order of their
// partial sums only.
#include "fir_tile.cuh"

namespace {

constexpr int NCO_BS = 128;   // the NCO's block (ops/chan_frontend.py BS)

// The d2 launch's inputs: what every block needs to find its channel's z.
struct Bins {
  const void* bins;
  int bf16, P, Tb_pad, adv0, C;   // P: rows of one plane of bins
  const int* bin_idx;
  const float *om, *ph0, *span, *sbs;
  const float* tail;      // the d2 tail, [2C, hist] planes
  int hist;
};

// The d2 launch's staging hook: ext0 sample e is the carried tail's (e <
// hist) or z[n], n = e − hist: bin bin[c] gathered (bf16 bins upcast)
// and rotated by the NCO.
struct ZSrc {
  const void* bins;
  int bf16, q;            // q: the NCO's 128-sample blocks a step
  float rq;               // 1 / q
  long row_r, row_i;      // the channel's bin rows
  float w, p0, sp, bs;
  const float* tr;        // the carried tail's re and im rows
  const float* ti;
  int hist;
  float2* probe;          // where non-null, z[n] is stored there too

  __device__ ZSrc(const Bins& x, int c, float2* probe_)
      : bins(x.bins), bf16(x.bf16), q(x.adv0 / NCO_BS),
        rq(1.f / static_cast<float>(x.adv0 / NCO_BS)),
        row_r(static_cast<long>(x.bin_idx[c]) * x.Tb_pad),
        row_i(static_cast<long>(x.P + x.bin_idx[c]) * x.Tb_pad),
        w(x.om[c]), p0(x.ph0[c]), sp(x.span[c]), bs(x.sbs[c]),
        tr(x.tail + static_cast<long>(c) * x.hist),
        ti(x.tail + static_cast<long>(x.C + c) * x.hist), hist(x.hist),
        probe(probe_) {}

  // ext0[e] before the rotate: the tail sample, or the gathered bin
  __device__ __forceinline__ float2 load(long e) const {
    if (e < hist) return make_float2(tr[e], ti[e]);
    return make_float2(sdr::ld(bins, row_r + e - hist, bf16),
                       sdr::ld(bins, row_i + e - hist, bf16));
  }

  // z[n] from its gathered bin x.  n = i·adv0 + 128·bb + jj, with b =
  // n / 128 = i·q + bb (q = adv0 / 128) divided through the float
  // reciprocal and corrected by one step either way: exact for every b <
  // 2^17 (n < 2^24, which the entry point requires), where an integer
  // division by a runtime divisor is a long instruction sequence.
  __device__ __forceinline__ float2 rotate(float2 x, int n) const {
    const int b = n >> 7;
    const int jj = n & (NCO_BS - 1);
    int i = __float2int_rz(__fmul_rn(static_cast<float>(b), rq));
    if (i * q > b) --i;
    if ((i + 1) * q <= b) ++i;
    const int bb = b - i * q;
    const float ang = __fadd_rn(
        __fadd_rn(__fadd_rn(p0, __fmul_rn(sp, static_cast<float>(i))),
                  __fmul_rn(bs, static_cast<float>(bb))),
        __fmul_rn(w, static_cast<float>(jj)));
    float s, co;
    sincosf(ang, &s, &co);
    const float2 z = make_float2(
        __fsub_rn(__fmul_rn(x.x, co), __fmul_rn(x.y, s)),
        __fadd_rn(__fmul_rn(x.x, s), __fmul_rn(x.y, co)));
    if (probe) probe[n] = z;
    return z;
  }

  __device__ __forceinline__ float2 value(long e) const {
    const float2 x = load(e);
    return e < hist ? x : rotate(x, static_cast<int>(e - hist));
  }

  __device__ __forceinline__ void operator()(float2* d, long e) const {
    *d = value(e);
  }
};

// The fir launch's staging hook: ext1 = [fir tail (planes) | y1].
struct Y1Src {
  const float* tr;
  const float* ti;
  int hist;
  const float2* y1;
  __device__ __forceinline__ float2 value(long e) const {
    return e < hist ? make_float2(tr[e], ti[e]) : y1[e - hist];
  }
  __device__ __forceinline__ void operator()(float2* d, long e) const {
    if (e < hist)
      *d = make_float2(tr[e], ti[e]);
    else
      sdr::stage(d, y1 + (e - hist));
  }
};

// The fir launch's store hook: y[o] into the re and im planes of out in
// its storage dtype; |y[o]| of each valid output (o < m_out) into this
// thread's squelch partial.
struct StoreIF {
  void* out;
  long re, im;
  int bf16, m_out;
  mutable float acc;
  __device__ __forceinline__ void operator()(long o, float2 v) const {
    sdr::st(out, re + o, v.x, bf16);
    sdr::st(out, im + o, v.y, bf16);
    if (o < m_out)
      acc += sqrtf(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)));
  }
};

// A stage's next-call tail [2C, hist] planes: ext[s0 + t], rounded.
template <typename Src>
__device__ __forceinline__ void write_tail(const Src& src, long s0, int c,
                                           int C, int hist, float* nt,
                                           int tail_bf16) {
  for (int t = threadIdx.x; t < hist; t += blockDim.x) {
    const float2 v = src.value(s0 + t);
    nt[static_cast<long>(c) * hist + t] = sdr::bf16_round_if(v.x, tail_bf16);
    nt[static_cast<long>(C + c) * hist + t] =
        sdr::bf16_round_if(v.y, tail_bf16);
  }
}

// Launch 1 of 2, grid (chunks, 1, C): y1 [C, n1] on chan_post_plan's "d2"
// grid; each row's first block writes the d2 tail.
template <int P>
__global__ void post_d2_kernel(Bins x, int Tb,
                               const float* __restrict__ h_d2, int K1,
                               float2* __restrict__ y1, int n1,
                               float* __restrict__ nt_d2, int tail_bf16,
                               float2* __restrict__ probe, int Cc) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.z;
  const ZSrc src(x, c, probe ? probe + static_cast<long>(c) * x.Tb_pad
                             : nullptr);
  const int per = Cc * 32 * P;
  const int m0 = blockIdx.x * per;
  sdr::fir_tile<P, float2>(
      src, h_d2, 1, 2, K1, sdr::StoreTo<float2>{y1 + static_cast<long>(c) * n1},
      n1, m0, min(per, n1 - m0), 1, Cc, smem);
  if (blockIdx.x == 0)
    write_tail(src, Tb, c, x.C, x.hist, nt_d2, tail_bf16);
}

// Launch 2 of 2, grid (chunks, 1, C): out [2C, n_out] on chan_post_plan's
// "fir" grid, each block's squelch partial sq[c, blockIdx.x], and each
// row's first block writes the fir tail.
template <int P>
__global__ void post_fir_kernel(const float* __restrict__ t_fir, int hist,
                                const float2* __restrict__ y1, int n1,
                                const float* __restrict__ h_fir, int K2,
                                void* __restrict__ out, int out_bf16,
                                int n_out, int m_out, float* __restrict__ sq,
                                int m1, float* __restrict__ nt_fir,
                                int tail_bf16, int C, int Cc) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[32];
  const int c = blockIdx.z;
  const Y1Src src{t_fir + static_cast<long>(c) * hist,
                  t_fir + static_cast<long>(C + c) * hist, hist,
                  y1 + static_cast<long>(c) * n1};
  const StoreIF dst{out, static_cast<long>(c) * n_out,
                    static_cast<long>(C + c) * n_out, out_bf16, m_out, 0.f};
  const int per = Cc * 32 * P;
  const int m0 = blockIdx.x * per;
  sdr::fir_tile<P, float2>(src, h_fir, 1, 1, K2, dst, n_out, m0,
                           min(per, n_out - m0), 1, Cc, smem);
  float acc = dst.acc;
  for (int off = 16; off; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  if (blockIdx.x == 0)
    write_tail(src, m1, c, C, hist, nt_fir, tail_bf16);
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) tot += red[k];
    sq[static_cast<long>(c) * gridDim.x + blockIdx.x] = tot;
  }
}

// P odd (fir_launch_p refuses one past its instances), the rest in range
bool bad_plan(int P, int Cc, int warps) {
  return P < 1 || P % 2 == 0 || Cc < 1 || warps < 1 || warps > 32;
}

}  // namespace

// The first launch.  bins [2P, Tb_pad] (bins_bf16), Tb <= Tb_pad even;
// bin_idx [C] (each < P), om, ph0, span, sbs [C]; t_d2 [2C, K1 − 1] float32 (rounded by
// the caller); h_d2 [K1]; y1 [C, n1] complex64 with 2·(n1 − 1) + K1 <=
// K1 − 1 + Tb_pad; nt_d2 [2C, K1 − 1] (tail_bf16: rounded to bf16); probe
// [C, Tb_pad] complex64 or null (z, for the checks).  P, Cc and warps are
// ops/chan_frontend.py:chan_post_plan's.
extern "C" int sdr_chan_post_d2(
    const void* bins, int bins_bf16, int plane_rows, int Tb_pad, int Tb,
    const int* bin_idx, const float* om, const float* ph0, const float* span,
    const float* sbs, int adv0, const float* t_d2, const float* h_d2, int K1,
    void* y1, int n1, float* nt_d2, int tail_bf16, void* probe, int C, int P,
    int Cc, int warps, cudaStream_t stream) {
  if (C < 1 || C > 65535 || plane_rows < 1 || K1 < 2 || Tb % 2 || Tb < 2 ||
      Tb > Tb_pad || Tb_pad > (1 << 24) || adv0 < NCO_BS || adv0 % NCO_BS || n1 < 1 ||
      2L * (n1 - 1) + K1 > K1 - 1L + Tb_pad || bad_plan(P, Cc, warps))
    return cudaErrorInvalidValue;
  const int per = Cc * 32 * P;
  const dim3 grid((n1 + per - 1) / per, 1, C);
  const size_t smem =
      sdr::fir_tile_layout(2, K1, n1, P, 1, Cc, 2).total * sizeof(float);
  const Bins x{bins, bins_bf16, plane_rows, Tb_pad, adv0, C, bin_idx, om,
               ph0, span, sbs, t_d2, K1 - 1};
  return static_cast<int>(sdr::fir_launch_p(
      P, post_d2_kernel<1>, post_d2_kernel<3>, post_d2_kernel<5>, grid,
      warps, smem, stream, x, Tb, h_d2, K1, static_cast<float2*>(y1), n1,
      nt_d2, tail_bf16, static_cast<float2*>(probe), Cc));
}

// The second.  t_fir [2C, K2 − 1] float32 (rounded by the caller); y1
// [C, n1] complex64, n1 >= n_out; h_fir [K2]; out [2C, n_out] float32 or
// bf16 (out_bf16), m_out <= n_out valid; sq [C, n_tiles] float32 with
// n_tiles the grid's chunks; m1 = Tb/2 <= n1; nt_fir [2C, K2 − 1]
// (tail_bf16).  P, Cc and warps are chan_post_plan's.
extern "C" int sdr_chan_post_fir(
    const float* t_fir, const void* y1, int n1, const float* h_fir, int K2,
    void* out, int out_bf16, int n_out, int m_out, float* sq, int n_tiles,
    int m1, float* nt_fir, int tail_bf16, int C, int P, int Cc, int warps,
    cudaStream_t stream) {
  if (C < 1 || C > 65535 || K2 < 2 || n_out < 1 || n_out > n1 ||
      m_out > n_out || m1 < 1 || m1 > n1 || bad_plan(P, Cc, warps))
    return cudaErrorInvalidValue;
  const int per = Cc * 32 * P;
  const dim3 grid((n_out + per - 1) / per, 1, C);
  if (static_cast<int>(grid.x) != n_tiles) return cudaErrorInvalidValue;
  const size_t smem =
      sdr::fir_tile_layout(1, K2, n_out, P, 1, Cc, 2).total * sizeof(float);
  decltype(&post_fir_kernel<1>) const ks[] = {
      post_fir_kernel<1>, post_fir_kernel<3>, post_fir_kernel<5>,
      post_fir_kernel<7>};
  return static_cast<int>(sdr::fir_launch_p(
      P, ks, grid, warps, smem, stream, t_fir, K2 - 1,
      static_cast<const float2*>(y1), n1, h_fir, K2, out, out_bf16, n_out,
      m_out, sq, m1, nt_fir, tail_bf16, C, Cc));
}
