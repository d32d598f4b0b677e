// K2 tcn_masker: the whole Conv-TasNet masker (all n_blocks TCN blocks) from
// one C entry point per weight type: act_tcn_masker (float32 weights) and
// act_tcn_masker_s8 (the int8 weight stream, "K2-s8").
//
// Replaces audio_classification_tpu/ops/pallas/tcn_kernel.py
// (fused_tcn_masker -> _masker_core -> _masker_fwd_call, body _kernel). Each
// block computes, for rows f < f_len (masked gLN statistics, f32 math):
//   h1 = PReLU(x W_in + b_in)                 -> gLN-1 over (F, H)
//   h2 = PReLU(dwconv3_d(gLN-1(h1) * mask) + b_dw), d = 2^(i mod R)
//                                              -> gLN-2 over (F, H)
//   x += gLN-2(h2) W_res + b_res ; skips += gLN-2(h2) W_skip + b_skip
//
// Bound on the H100: the pointwise GEMMs (2 F C H per block for W_in and
// 4 F H C for W_res|W_skip: ~12.6 GFLOP per block at F = 32k) on SIMT f32
// units, plus the device-memory traffic of the [F, H] intermediates. The TPU
// design (a sequential grid carrying the whole sequence in VMEM and a
// deferred M-row update) does not carry over: thread blocks run in parallel
// and gLN needs statistics over the whole sequence in every block. So each
// TCN block is five launches on one stream:
//   A  tiled GEMM x W_in + bias + PReLU -> h1 (MATERIALISED in device memory,
//      f32 [B, F, H], ~65 MB at F = 32k) + masked sum (gLN-1 mean)
//   S1 masked sum of (h1 - mean)^2 (two-pass variance: no E[x^2] - mean^2
//      cancellation over ~16M elements)
//   B  gLN-1 apply + mask + 3-tap dilated depthwise conv + PReLU -> h2
//      + masked sum (gLN-2 mean)
//   S2 masked sum of (h2 - mean)^2
//   C  gLN-2 apply in the A-tile load, tiled GEMM against [W_res | W_skip],
//      x_next = x + res, skips += skip
// Statistics reduce per thread block in f32 and across blocks with double
// atomics into a [n_blocks, B, 4] buffer. h1 is materialised rather than
// recomputed per pass, so the dilated halo reads h1, never x; x still
// ping-pongs between two buffers (x is read-only within a block).
//
// The int8 weight stream (tcn_kernel.py: stack_tcn_params(weight_quant=True),
// the in-kernel dequant of _kernel under cfg.wq): w_in, w_dw and
// [w_res | w_skip] arrive as int8 with one float32 scale per block and out
// channel, in vecs rows 8 (w_in) and 9 (w_dw) and cvecs rows 2, 3 (w_res,
// w_skip). Where the TPU kernel dequantises a block's weights into VMEM at
// block entry, here every kernel is instantiated for the weight type and
// forms (float)q * scale on the operand load: in the B loader of the two
// GEMMs (act::RowMajorS8) and at the three depthwise taps. Everything after
// the load is the float path, so on a dequantised float copy of the same
// stack the float entry point gives bit-identical output. Both streams are
// bound by the GEMMs' operations; the int8 stream only shrinks the weight
// bytes (0.79 MB -> 0.20 MB per block), which never bounded the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sgemm_tile.cuh"

namespace {

using act::BKK;
constexpr float EPS = 1e-8f;  // GlobalLayerNorm eps
constexpr int TM = 4, TN = 4;  // GEMM outputs per thread: tiles of BM x BN
constexpr int BM = 16 * TM, BN = 16 * TN, GT = act::GEMM_THREADS;
constexpr int RT = 256;  // threads of the elementwise kernels

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;  // valid in thread 0
}

__device__ __forceinline__ void gln_stats(const double* st, int which, int f_len, int h,
                                          float* mean, float* rstd) {
  // st: [4] = {sum1, sq1, sum2, sq2}; which = 0 (gLN-1) or 2 (gLN-2)
  double count = fmax((double)f_len * h, 1.0);
  double mu = st[which] / count;
  double var = st[which + 1] / count;
  *mean = (float)mu;
  *rstd = (float)(1.0 / sqrt(var + (double)EPS));
}

// B-operand loader and depthwise tap for a weight type: float weights as they
// are, int8 weights times their per-out-channel scale
__device__ __forceinline__ act::RowMajor b_loader(const float* w, const float*, int n) {
  return act::RowMajor{w, n};
}
__device__ __forceinline__ act::RowMajorS8 b_loader(const int8_t* w, const float* scale, int n) {
  return act::RowMajorS8{w, scale, n};
}
__device__ __forceinline__ float tap_weight(const float* w, const float*, int i, int) {
  return w[i];
}
__device__ __forceinline__ float tap_weight(const int8_t* w, const float* scale, int i, int ch) {
  return __fmul_rn((float)w[i], scale[ch]);
}

struct LoadX {
  const float* x;  // [F, C] of this batch item
  int f, c;
  __device__ float operator()(int r, int k) const { return r < f ? x[(size_t)r * c + k] : 0.f; }
};

struct LoadGln {
  const float* h;  // [F, H] of this batch item
  const float* gamma;
  const float* beta;
  float mean, rstd;
  int f, hd;
  __device__ float operator()(int r, int k) const {
    return r < f ? (h[(size_t)r * hd + k] - mean) * rstd * gamma[k] + beta[k] : 0.f;
  }
};

// A: h1 = PReLU(x W_in + b_in); masked sum into st[b][0]
template <class W>
__global__ void __launch_bounds__(GT)
in_conv_kernel(const float* __restrict__ x, const int* __restrict__ f_len,
               const W* __restrict__ w_in, const float* __restrict__ vecs,
               float* __restrict__ h1, double* __restrict__ st, int f, int c, int hd) {
  __shared__ float smem[act::gemm_smem_floats<TM, TN>()];
  __shared__ float red[GT / 32];
  const int b = blockIdx.z, m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[TM][TN];
  act::gemm_tile(smem, LoadX{x + (size_t)b * f * c, f, c}, b_loader(w_in, vecs + 8 * hd, hd), c,
                 m0, n0, acc);
  const float* b_in = vecs;
  const float a1 = vecs[1 * hd];
  const int fl = f_len[b], tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float local = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int r = m0 + ty + 16 * i;
    if (r >= f) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int col = n0 + tx + 16 * j;
      float v = acc[i][j] + b_in[col];
      v = v >= 0.f ? v : a1 * v;
      h1[((size_t)b * f + r) * hd + col] = v;
      if (r < fl) local += v;
    }
  }
  float s = block_sum(local, red);
  if (threadIdx.x == 0) atomicAdd(&st[b * 4 + 0], (double)s);
}

// S: masked sum of (h - mean)^2 into st[b][which + 1]
__global__ void __launch_bounds__(RT)
sq_kernel(const float* __restrict__ h, const int* __restrict__ f_len, double* __restrict__ st,
          int which, int f, int hd) {
  __shared__ float red[RT / 32];
  const int b = blockIdx.y, fl = f_len[b];
  float mean, rstd;
  gln_stats(st + b * 4, which, fl, hd, &mean, &rstd);
  const size_t n = (size_t)min(fl, f) * hd;
  const float* hb = h + (size_t)b * f * hd;
  float local = 0.f;
  for (size_t i = (size_t)blockIdx.x * RT + threadIdx.x; i < n; i += (size_t)gridDim.x * RT) {
    float d = hb[i] - mean;
    local = fmaf(d, d, local);
  }
  float s = block_sum(local, red);
  if (threadIdx.x == 0) atomicAdd(&st[b * 4 + which + 1], (double)s);
}

// B: h2 = PReLU(dwconv_d(gLN-1(h1) * mask) + b_dw); masked sum into st[b][2]
template <class W>
__global__ void __launch_bounds__(RT)
dwconv_kernel(const float* __restrict__ h1, const int* __restrict__ f_len,
              const W* __restrict__ w_dw, const float* __restrict__ vecs,
              float* __restrict__ h2, double* __restrict__ st, int f, int hd, int dil) {
  __shared__ float red[RT / 32];
  const int b = blockIdx.y, fl = f_len[b];
  float mean, rstd;
  gln_stats(st + b * 4, 0, fl, hd, &mean, &rstd);
  const float* gamma1 = vecs + 2 * hd;
  const float* beta1 = vecs + 3 * hd;
  const float* b_dw = vecs + 4 * hd;
  const float a2 = vecs[5 * hd];
  const float* hb = h1 + (size_t)b * f * hd;
  const size_t n = (size_t)f * hd;
  float local = 0.f;
  for (size_t i = (size_t)blockIdx.x * RT + threadIdx.x; i < n; i += (size_t)gridDim.x * RT) {
    const int r = (int)(i / hd), ch = (int)(i % hd);
    const float g = gamma1[ch], be = beta1[ch];
    float acc = 0.f;
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
      int src = r + (tap - 1) * dil;
      if (src >= 0 && src < f && src < fl) {
        float z = (hb[(size_t)src * hd + ch] - mean) * rstd * g + be;
        acc = fmaf(z, tap_weight(w_dw, vecs + 9 * hd, tap * hd + ch, ch), acc);
      }
    }
    float v = acc + b_dw[ch];
    v = v >= 0.f ? v : a2 * v;
    h2[(size_t)b * n + i] = v;
    if (r < fl) local += v;
  }
  float s = block_sum(local, red);
  if (threadIdx.x == 0) atomicAdd(&st[b * 4 + 2], (double)s);
}

// C: [res | skip] = gLN-2(h2) [W_res | W_skip]; x_out = x_in + res + b_res,
// skips += skip + b_skip
template <class W>
__global__ void __launch_bounds__(GT)
out_conv_kernel(const float* __restrict__ h2, const int* __restrict__ f_len,
                const W* __restrict__ w_rs, const float* __restrict__ vecs,
                const float* __restrict__ cvecs, const float* __restrict__ x_in,
                float* __restrict__ x_out, float* __restrict__ skips,
                const double* __restrict__ st, int f, int c, int hd) {
  const int b = blockIdx.z, m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float mean, rstd;
  gln_stats(st + b * 4, 2, f_len[b], hd, &mean, &rstd);
  __shared__ float smem[act::gemm_smem_floats<TM, TN>()];
  float acc[TM][TN];
  const LoadGln ld{h2 + (size_t)b * f * hd, vecs + 6 * hd, vecs + 7 * hd, mean, rstd, f, hd};
  // cvecs rows 2, 3 are the scales of [W_res | W_skip]'s 2C columns
  act::gemm_tile(smem, ld, b_loader(w_rs, cvecs + 2 * c, 2 * c), hd, m0, n0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int r = m0 + ty + 16 * i;
    if (r >= f) continue;
    const size_t row = ((size_t)b * f + r) * c;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int col = n0 + tx + 16 * j;
      if (col < c) {
        x_out[row + col] = (x_in[row + col] + acc[i][j]) + cvecs[col];
      } else {
        int cc = col - c;
        skips[row + cc] = (skips[row + cc] + acc[i][j]) + cvecs[c + cc];
      }
    }
  }
}

int grid_for(size_t n) {
  size_t g = (n + RT - 1) / RT;
  return (int)(g < 1024 ? (g > 0 ? g : 1) : 1024);
}

// The five launches per TCN block for weights of type W; vecs has vrows rows
// per block and cvecs crows (8 and 2, or 10 and 4 with the int8 scales).
template <class W>
int run_masker(const float* x, const int* f_len, const W* w_in, const W* w_dw,
               const float* vecs, const W* w_rs, const float* cvecs, float* xa, float* xb,
               float* h1, float* h2, double* stats, float* skips, int batch, int f, int c,
               int hd, int n_blocks, int n_per_repeat, int vrows, int crows,
               cudaStream_t stream) {
  if (c % BKK != 0 || hd % BN != 0 || (2 * c) % BN != 0 || hd % BKK != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = cudaMemsetAsync(skips, 0, sizeof(float) * (size_t)batch * f * c, stream)) != cudaSuccess)
    return (int)e;
  if ((e = cudaMemsetAsync(stats, 0, sizeof(double) * (size_t)n_blocks * batch * 4, stream)) !=
      cudaSuccess)
    return (int)e;
  const dim3 g_in((f + BM - 1) / BM, hd / BN, batch);
  const dim3 g_out((f + BM - 1) / BM, 2 * c / BN, batch);
  const dim3 g_red(grid_for((size_t)f * hd), batch);
  const float* cur = x;
  float* bufs[2] = {xa, xb};
  for (int i = 0; i < n_blocks; ++i) {
    const W* wi = w_in + (size_t)i * c * hd;
    const W* wd = w_dw + (size_t)i * 3 * hd;
    const float* vv = vecs + (size_t)i * vrows * hd;
    const W* wr = w_rs + (size_t)i * hd * 2 * c;
    const float* cv = cvecs + (size_t)i * crows * c;
    double* st = stats + (size_t)i * batch * 4;
    float* nxt = bufs[i & 1];
    const int dil = 1 << (i % n_per_repeat);
    in_conv_kernel<W><<<g_in, GT, 0, stream>>>(cur, f_len, wi, vv, h1, st, f, c, hd);
    sq_kernel<<<g_red, RT, 0, stream>>>(h1, f_len, st, 0, f, hd);
    dwconv_kernel<W><<<g_red, RT, 0, stream>>>(h1, f_len, wd, vv, h2, st, f, hd, dil);
    sq_kernel<<<g_red, RT, 0, stream>>>(h2, f_len, st, 2, f, hd);
    out_conv_kernel<W><<<g_out, GT, 0, stream>>>(h2, f_len, wr, vv, cv, cur, nxt, skips, st, f,
                                                 c, hd);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    cur = nxt;
  }
  return 0;
}

}  // namespace

// x: [B, F, C] input (read only); f_len: [B] int32; per-block stacks
// w_in [NB, C, H], w_dw [NB, 3, H], vecs [NB, 8, H], w_rs [NB, H, 2C]
// (W_res | W_skip), cvecs [NB, 2, C]. Scratch: xa, xb [B, F, C],
// h1, h2 [B, F, H], stats [NB, B, 4] double. Output: skips [B, F, C].
extern "C" int act_tcn_masker(const float* x, const int* f_len, const float* w_in,
                              const float* w_dw, const float* vecs, const float* w_rs,
                              const float* cvecs, float* xa, float* xb, float* h1, float* h2,
                              double* stats, float* skips, int batch, int f, int c, int hd,
                              int n_blocks, int n_per_repeat, cudaStream_t stream) {
  return run_masker<float>(x, f_len, w_in, w_dw, vecs, w_rs, cvecs, xa, xb, h1, h2, stats, skips,
                           batch, f, c, hd, n_blocks, n_per_repeat, 8, 2, stream);
}

// The int8 weight stream: w_in, w_dw, w_rs as int8 in the same layouts;
// vecs [NB, 10, H] with the scales of w_in and w_dw in rows 8, 9; cvecs
// [NB, 4, C] with the scales of W_res and W_skip in rows 2, 3. Everything
// else as act_tcn_masker.
extern "C" int act_tcn_masker_s8(const float* x, const int* f_len, const int8_t* w_in,
                                 const int8_t* w_dw, const float* vecs, const int8_t* w_rs,
                                 const float* cvecs, float* xa, float* xb, float* h1, float* h2,
                                 double* stats, float* skips, int batch, int f, int c, int hd,
                                 int n_blocks, int n_per_repeat, cudaStream_t stream) {
  return run_masker<int8_t>(x, f_len, w_in, w_dw, vecs, w_rs, cvecs, xa, xb, h1, h2, stats,
                            skips, batch, f, c, hd, n_blocks, n_per_repeat, 10, 4, stream);
}
