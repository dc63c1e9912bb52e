// K5 — polyphase WOLA channelizer, 2×-oversampled or critically sampled.
//
// Replaces: sdrplusplusbrown_tpu/ops/pallas_channelizer.py:_chz3_kernel (the
// V3 phase-planar fold + DFT matmul, sequential grid) in both its forms:
// 2×-oversampled (PallasChannelizerV3; also the first half of
// ops/chan_frontend.py:_chan_fused_kernel_v3) and critically sampled
// (PallasPolyChannelizerV3, critical = True); the V2 and V1 bodies
// (_chz2_kernel, also as PallasPolyChannelizer, and _chz_kernel) compute
// the same function.
//
// What it computes, with s = [hist (nh = K0 − hop samples) | x (T) | 0…],
// K0 = tpp·M and hop = M/2 (oversampled) or M (critical), for every output
// frame F < width:
//     v_F[p]     = Σ_i br[p, i] · s[F·hop + i·M + p]            (fold)
//     bins[m, F] = σ · Σ_p (cos[m,p] − j·sin[m,p]) · v_F[p]    (M-point DFT)
// with σ = (−1)^m on even frames when ``even_sign`` (the oversampled
// delayed pass's twiddle) and 1 otherwise (odd frames; every frame of the
// critical form); out is [2M, width] (re rows over im rows, float32 or
// bfloat16 storage).  The taps and the DFT matrix come from the host,
// designed in float64 and rounded to float32 (and to the handoff dtype) as
// the JAX package rounds them, so the kernel and its plain version use the
// same numbers.
//
// What bounds it on the H100: the bytes.  The function reads the input and
// writes the bins; its arithmetic, the fold's 2·K0 multiply-adds per frame
// and an M-point DFT counted as an FFT (5·M·log2 M flops), is smaller.
// Scanner128 (oversampled, M = 48, 0.1 s at 2.4 MS/s): 1.9 MB in, 3.9 MB
// of float32 bins out, ~1.75 µs of HBM time against ~0.4 µs at the FP32
// peak.  Channelizer64 (critical, M = 64, tpp = 19, 2^21 samples): 16.8 MB
// in, 8.4 MB of bf16 bins out, ~7.5 µs of HBM time.  This kernel does the
// DFT directly, 4·M² multiply-adds per frame, so as written its own
// arithmetic exceeds the function's bound: ~2.8 µs at the FP32 peak for
// scanner128, ~16 µs (1.07 GFLOP) for channelizer64.  A block takes
// PFB_FRAMES consecutive frames: it stages their overlapping input span
// once in shared memory (78 KB at channelizer64, opted in), folds it, and
// runs the DFT with the matrix and the folded frames in shared memory
// (rows padded to M + 1 against bank conflicts).  An FFT, or tensor cores
// for the DFT, and fusing K5 with K6 (as the TPU did) are left for later
// work.
#include "common.cuh"

namespace {

constexpr int PFB_FRAMES = 32;
constexpr int PFB_THREADS = 256;

__global__ void pfb_kernel(const float* __restrict__ xr,
                           const float* __restrict__ xi, int T,
                           const float* __restrict__ hr,
                           const float* __restrict__ hi, int nh,
                           const float* __restrict__ br,
                           const float* __restrict__ cm,
                           const float* __restrict__ sm, int M, int tpp,
                           int h, int even_sign, void* __restrict__ out,
                           int out_bf16, int width, int span_max) {
  extern __shared__ float smem[];
  const int K0 = tpp * M;
  const int vs = M + 1;
  float* sr = smem;
  float* si = sr + span_max;
  float* vr = si + span_max;
  float* vi = vr + PFB_FRAMES * vs;
  float* cs = vi + PFB_FRAMES * vs;
  float* sn = cs + M * M;
  float* tb = sn + M * M;

  const int F0 = blockIdx.x * PFB_FRAMES;
  const int nf = min(PFB_FRAMES, width - F0);
  const int span = (nf - 1) * h + K0;
  const long n0 = static_cast<long>(F0) * h;
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    const long n = n0 + t;
    float a = 0.f, b = 0.f;
    if (n < nh) {
      a = hr[n];
      b = hi[n];
    } else if (n - nh < T) {
      a = xr[n - nh];
      b = xi[n - nh];
    }
    sr[t] = a;
    si[t] = b;
  }
  for (int t = threadIdx.x; t < M * M; t += blockDim.x) {
    cs[t] = cm[t];
    sn[t] = sm[t];
  }
  for (int t = threadIdx.x; t < M * tpp; t += blockDim.x) tb[t] = br[t];
  __syncthreads();

  // fold: one (frame, branch) per thread
  for (int idx = threadIdx.x; idx < nf * M; idx += blockDim.x) {
    const int f = idx / M;
    const int p = idx - f * M;
    const float* wr = sr + f * h + p;
    const float* wi = si + f * h + p;
    float ar = 0.f, ai = 0.f;
    for (int i = 0; i < tpp; ++i) {
      const float g = tb[p * tpp + i];
      ar = fmaf(g, wr[i * M], ar);
      ai = fmaf(g, wi[i * M], ai);
    }
    vr[f * vs + p] = ar;
    vi[f * vs + p] = ai;
  }
  __syncthreads();

  // DFT: one (bin, frame) per thread, frames fastest (coalesced stores)
  for (int idx = threadIdx.x; idx < M * nf; idx += blockDim.x) {
    const int k = idx / nf;
    const int f = idx - k * nf;
    const float* c = cs + k * M;
    const float* s = sn + k * M;
    const float* ur = vr + f * vs;
    const float* ui = vi + f * vs;
    float re = 0.f, im = 0.f;
    for (int p = 0; p < M; ++p) {
      re = fmaf(c[p], ur[p], re);
      re = fmaf(s[p], ui[p], re);
      im = fmaf(c[p], ui[p], im);
      im = fmaf(-s[p], ur[p], im);
    }
    const int F = F0 + f;
    if (even_sign && !(F & 1) && (k & 1)) {
      re = -re;
      im = -im;
    }
    sdr::st(out, static_cast<long>(k) * width + F, re, out_bf16);
    sdr::st(out, static_cast<long>(M + k) * width + F, im, out_bf16);
  }
}

}  // namespace

extern "C" int sdr_pfb_bins(const float* xr, const float* xi, int T,
                            const float* hr, const float* hi, int nh,
                            const float* br, const float* cm, const float* sm,
                            int M, int tpp, int hop, int even_sign,
                            void* out, int out_bf16, int width,
                            cudaStream_t stream) {
  if (M < 2 || M % 2 || M > 64 || tpp < 2 || width < 1 ||
      (hop != M / 2 && hop != M) || nh != tpp * M - hop)
    return cudaErrorInvalidValue;
  const int span_max = (PFB_FRAMES - 1) * hop + tpp * M;
  const size_t smem =
      (2 * static_cast<size_t>(span_max) + 2 * PFB_FRAMES * (M + 1) +
       2 * static_cast<size_t>(M) * M + static_cast<size_t>(M) * tpp) *
      sizeof(float);
  const cudaError_t e = sdr::allow_smem(pfb_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (width + PFB_FRAMES - 1) / PFB_FRAMES;
  pfb_kernel<<<grid, PFB_THREADS, smem, stream>>>(
      xr, xi, T, hr, hi, nh, br, cm, sm, M, tpp, hop, even_sign, out,
      out_bf16, width, span_max);
  return static_cast<int>(cudaGetLastError());
}
