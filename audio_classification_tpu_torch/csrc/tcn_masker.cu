// K2 tcn_masker: the whole Conv-TasNet masker (all n_blocks TCN blocks) from
// one C entry point per weight type: act_tcn_masker (float32 weights) and
// act_tcn_masker_s8 (the int8 weight stream, "K2-s8").
//
// Replaces audio_classification_tpu/ops/pallas/tcn_kernel.py
// (fused_tcn_masker -> _masker_core -> _masker_fwd_call, body _kernel). Each
// block computes, for rows f < f_len (masked gLN statistics, f32 math):
//   h1 = PReLU(x W_in + b_in)                 -> gLN-1 over (f_len, H)
//   h2 = PReLU(dwconv3_d(gLN-1(h1) * mask) + b_dw), d = 2^(i mod R)
//                                              -> gLN-2 over (f_len, H)
//   x += gLN-2(h2) W_res + b_res ; skips += gLN-2(h2) W_skip + b_skip
// Rows f >= f_len are never computed: no tile that lies past f_len runs, no
// row past it is read (loaders give 0) or written, and those rows of the
// output are exactly 0. No valid row depends on a padded one (h1 is masked
// after gLN-1 and every statistic is over valid rows), so valid rows are
// what the JAX kernel gives there; its padded rows are values no caller uses.
//
// Bound on the H100: the products. Per valid frame and block, 2 C H (W_in)
// + 4 H C (W_res | W_skip) flops: 1.90e11 at the flagship shape (F 31999,
// 19999 valid, C 128, H 512, 24 blocks). Float32 accuracy on the tensor
// cores costs three TF32 products per product (3xTF32, tf32_mma.cuh), so the
// bound is that over 495 / 3 TFLOP/s: 1.15 ms (the SIMT f32 figure 2.84);
// mma.sync reaches 312.8 TFLOP/s on the card (scripts/mma_tf32_peak.py), a
// ceiling of 1.82 ms. The [f_len, H] intermediates add 4 passes a block
// (A writes h1; B reads h1 and writes h2; C reads h2): 3.9 GB, ~1.2 ms at
// 3.35 TB/s, partly under the products.
//
// Design: three launches a TCN block on one stream.
//   A  gemm_kernel<IN>: h1 = PReLU(x W_in + b_in), gLN-1 partial statistics
//   B  dwconv_kernel: gLN-1 apply + mask in the tap loads, 3-tap dilated
//      depthwise conv, PReLU -> h2, gLN-2 partial statistics
//   C  gemm_kernel<OUT>: gLN-2 apply in the operand load, [W_res | W_skip],
//      x += res + b_res in place, skips += skip + b_skip
// The two GEMMs run mma.sync m16n8k8 TF32 in 3xTF32 with float32
// accumulation. A block of 8 warps owns BM = 128 rows x BN = 128 columns
// (warps 4 x 2, 32 x 64 each), or 64 columns where N is not a multiple of
// 128 or 128-column blocks would not fill the card (a batch-1 streaming
// window). 32-deep k-tiles arrive raw by 16-byte cp.async in a three-stage
// ring (rows past f_len zero-filled); each is then staged once a block into
// mma fragment order: A transformed (row mask, gLN-2 apply) and kept float,
// B (int8 dequantised first) split into big + small TF32 halves, so that
// every fragment is one 16-byte shared-memory load. A warp splits its A
// fragments in registers; its products over a k-tile (4 k8 steps x 3 a
// tile) are formed from zero side by side (16 independent chains at 128
// columns) and added to the accumulator in IEEE float32, so the tensor
// cores' truncating sum never runs longer than 12 products (over all of
// K = 512 it would run 192). The next k-tile is staged while the products
// run, one barrier a k-tile. The contraction index is permuted
// inside each k8 step (fragment slot t holds k = 2t, slot t + 4 holds
// k = 2t + 1) so that a lane's A quad comes from two 8-byte row loads.
// Statistics, deterministic and two-pass grade: every A or B block reduces
// its own tile (count, mean, M2 about the tile's mean, two passes over the
// values it holds in registers) and writes that partial; the last block of
// the item to finish (a __threadfence and an atomic ticket per batch item,
// reset by that block) merges the partials in a fixed order with Chan's
// formula in double and writes (mean, rstd). No float32 E[x^2] - mean^2,
// no atomics on the sums: two calls give identical bits.
// K2-s8: w_in, w_dw and [w_res | w_skip] arrive as int8 with one float32
// scale per block and out channel (vecs rows 8, 9; cvecs rows 2, 3). The
// kernels form (float)q * scale with one rounding (__fmul_rn) where they
// stage the operand, before the split, and at the depthwise taps (once a
// thread): everything after is the float path, so on a dequantised float
// copy of the stack the float entry point gives bit-identical output.
// Measured (H100 80GB HBM3, 700 W; chip_smoke.py and scripts/tcn_masker_ab.py,
// PERF.md): 7.2 ms at the flagship shape and, as K2-s8, 5.0 ms at the serving
// shape [8, 1999, 128] ragged, 0.15-0.16 of the 3xTF32 bound: the products
// run at ~40% of the mma.sync ceiling inside the k-tile loop, one block of 8
// warps an SM (C: 238 registers, 213 KB of shared memory; A 164; B 64; no
// spills), and whole tiles leave the last wave part-empty. The SIMT design
// this replaces (IEEE f32 FMA in 64 x 64 tiles over the whole bucket, five
// launches a block, double atomics) took 22.0 and 12.3 ms in the same call.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr float EPS = 1e-8f;  // GlobalLayerNorm eps
constexpr int NT = 256;       // threads a block, all three kernels
constexpr int NW = NT / 32;
constexpr int BM = 128;       // GEMM rows a block
constexpr int BK = 32;        // contraction depth of a k-tile
constexpr int KS = BK / 8;    // k8 steps a k-tile
constexpr int FRAG = 32 * 4;  // floats of one fragment: a 16-byte quad a lane
constexpr int AF = (BM / 16) * KS * FRAG;  // A k-tile in fragment order
constexpr int RAS = BK + 8;                // row stride (floats) of a raw A tile
constexpr int MAX_K = 1024;                // H <= 1024: the gLN-2 coefficients
constexpr int NSR = 3;                     // raw k-tiles in flight a block, + 1

// A GEMM block's shapes for BN columns (128, or 64 where N % 128 != 0):
// warps 4 x 2, each 32 rows x BN / 2 columns
template <int BN>
struct Tile {
  static constexpr int NP = BN / 16;          // pairs of n8 tiles a block
  static constexpr int BF = KS * NP * FRAG;   // B k-tile in fragment order, one TF32 half
  static constexpr int STAGE = AF + 2 * BF;   // A (float) + B (big, small) of a k-tile
  static constexpr int RBS = BN + 4;          // row stride (floats) of a raw float B tile
  static constexpr int RBS8 = BN + 16;        // row stride (bytes) of a raw int8 B tile
  static constexpr int RAW = BM * RAS + BK * RBS;  // floats of one raw stage
  static constexpr size_t SMEM = sizeof(float) * (2 * STAGE + NSR * RAW + 2 * MAX_K);
  static constexpr int NPW = NP / 2;          // n8 pairs a warp
  static constexpr int BQ = KS * NP / 8;      // B quads a thread stages
};
constexpr int VPT = 4;        // depthwise: rows a thread
constexpr int IN = 0, OUT = 1;

using act::mma_tf32;

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a weight as float: float weights as they are, int8 times its out channel's
// scale with one rounding (the value dequant_stack gives)
__device__ __forceinline__ float weight(float w, float) { return w; }
__device__ __forceinline__ float weight(int8_t q, float scale) {
  return __fmul_rn((float)q, scale);
}

// sum of v over the block, the same bits in every thread: a fixed shuffle
// tree per warp, then the warps in order
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) s += red[w];
  __syncthreads();  // red may be written again
  return s;
}

// (n, mean, m2) += (nb, mb, qb): Chan's parallel merge
__device__ __forceinline__ void chan(double& n, double& m, double& q, double nb, double mb,
                                     double qb) {
  if (nb == 0.0) return;
  const double nn = n + nb, d = mb - m;
  m += d * (nb / nn);
  q += qb + d * d * (n * nb / nn);
  n = nn;
}

struct Stats {
  float* part;        // [B, n_part, 3] partials (count, mean, m2)
  unsigned* tickets;  // [B], 0 between launches
  float* out;         // [B, 4]: (mean, rstd) written at out + 4 b
  int n_part;
};

// Publish a block's partial of item b (cnt values, their mean mu and m2 about
// it) into slot ``slot`` of n_live; the last block of the item to publish
// merges slots 0 .. n_live - 1 in a fixed order and writes (mean, rstd) at
// st.out + 4 b. Called by every thread of a block that did not return early.
__device__ __forceinline__ void publish_stats(float cnt, float mu, float m2, const Stats& st,
                                              int b, int slot, int n_live) {
  __shared__ double mred[NW][3];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* part = st.part + (size_t)b * st.n_part * 3;
  if (tid == 0) {
    part[3 * slot] = cnt;
    part[3 * slot + 1] = mu;
    part[3 * slot + 2] = m2;
    __threadfence();
    last = atomicAdd(st.tickets + b, 1u) == (unsigned)(n_live - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // thread t merges slots t, t + NT, ...; then a fixed tree per warp, then
  // the warps in order
  double n = 0.0, m = 0.0, q = 0.0;
  for (int i = tid; i < n_live; i += NT) {
    chan(n, m, q, __ldcg(part + 3 * i), __ldcg(part + 3 * i + 1), __ldcg(part + 3 * i + 2));
  }
  for (int o = 16; o > 0; o >>= 1) {
    const double nb = __shfl_down_sync(0xffffffffu, n, o);
    const double mb = __shfl_down_sync(0xffffffffu, m, o);
    const double qb = __shfl_down_sync(0xffffffffu, q, o);
    chan(n, m, q, nb, mb, qb);
  }
  if (lane == 0) {
    mred[warp][0] = n;
    mred[warp][1] = m;
    mred[warp][2] = q;
  }
  __syncthreads();
  if (tid == 0) {
    double tn = 0.0, tm = 0.0, tq = 0.0;
    for (int w = 0; w < NW; ++w) chan(tn, tm, tq, mred[w][0], mred[w][1], mred[w][2]);
    const double var = tq / fmax(tn, 1.0);
    st.out[4 * b] = (float)tm;
    st.out[4 * b + 1] = (float)(1.0 / sqrt(var + (double)EPS));
    st.tickets[b] = 0u;  // ready for the next launch
  }
}

struct GemmArgs {
  const float* a;       // [B, F, K]: x (IN) or h2 (OUT)
  const int* f_len;     // [B]
  const void* w;        // [K, N] weights, float or int8
  const float* wscale;  // [N] int8 scales (unused for float)
  const float* vecs;    // this block's [vrows, H]
  const float* cvecs;   // this block's [crows, C]
  Stats st;             // IN: gLN-1 partials and out = stats + 0; OUT: reads stats + 2
  const float* x_in;    // OUT: [B, F, C] residual in
  float* x_out;         // OUT: [B, F, C] residual out (may be x_in: each element is read
                        // and then written by one thread)
  float* skips;         // OUT: [B, F, C]
  float* h1;            // IN: [B, F, H]
  int f, k, n, c;
};

// A: h1 = PReLU(x W_in + b_in) + gLN-1 partials (MODE IN); C: gLN-2(h2)
// [W_res | W_skip] into x and skips (MODE OUT). Grid (N / BN, row tiles, B):
// the column blocks of a row tile run side by side, so each row of the
// operand comes from device memory once and from L2 after that.
template <class W, int MODE, int BN>
__global__ void __launch_bounds__(NT) gemm_kernel(GemmArgs p) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[NW];
  const int b = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int fl = p.f_len[b];
  if (m0 >= fl) return;  // a tile wholly past f_len: nothing to compute
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int kdim = p.k, ndim = p.n;
  const float* a = p.a + (size_t)b * p.f * kdim;
  const W* w = static_cast<const W*>(p.w);

  // staging roles. A: fragments (m16 tile sw4 + 2 i, k8 step sks), i < 4;
  // B: quads (k8 step (warp + 8 i) / NP, n8 pair snp), i < BQ
  const int sks = warp % KS, sw4 = warp / KS, snp = warp % T::NP;
  const int bcol = n0 + 16 * snp + g;  // this lane's B columns: bcol, bcol + 8
  float wsc[2] = {1.f, 1.f};
  if (sizeof(W) == 1) {
    wsc[0] = p.wscale[bcol];
    wsc[1] = p.wscale[bcol + 8];
  }
  // OUT: gLN-2 as (x - mean) * (gamma rstd) + beta, its coefficients over
  // the H contraction in shared memory (gsc: gamma rstd, then beta)
  float mean = 0.f;
  float* raw = smem + 2 * T::STAGE;
  float* gsc = raw + NSR * T::RAW;
  if (MODE == OUT) {
    mean = p.st.out[4 * b + 2];
    const float rstd = p.st.out[4 * b + 3];
    for (int k = tid; k < kdim; k += NT) {
      gsc[k] = p.vecs[6 * kdim + k] * rstd;
      gsc[kdim + k] = p.vecs[7 * kdim + k];
    }
  }

  // raw k-tiles: 16-byte cp.async copies into an NSR-stage ring, rows past
  // f_len zero-filled. A tile: BM rows of BK floats; B tile: BK rows of BN
  // weights (float or int8)
  const int n_kt = kdim / BK;
  auto fetch = [&](int kt) {
    if (kt < n_kt) {
      float* ra_s = raw + (kt % NSR) * T::RAW;
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < BM * BK / 4 / NT; ++i) {
        const int q = tid + NT * i, row = q / (BK / 4), c4 = 4 * (q % (BK / 4));
        const bool in = m0 + row < fl;
        act::cp_async16(ra_s + row * RAS + c4, a + (size_t)(in ? m0 + row : 0) * kdim + k0 + c4,
                        in);
      }
      float* rb_s = ra_s + BM * RAS;
      if (sizeof(W) == 4) {
#pragma unroll
        for (int i = 0; i < BK * BN / 4 / NT; ++i) {
          const int q = tid + NT * i, row = q / (BN / 4), c4 = 4 * (q % (BN / 4));
          act::cp_async16(rb_s + row * T::RBS + c4,
                          reinterpret_cast<const float*>(w + (size_t)(k0 + row) * ndim + n0 + c4),
                          true);
        }
      } else {
        for (int q = tid; q < BK * BN / 16; q += NT) {
          const int row = q / (BN / 16), c16 = 16 * (q % (BN / 16));
          act::cp_async16(
              reinterpret_cast<float*>(reinterpret_cast<char*>(rb_s) + row * T::RBS8 + c16),
              reinterpret_cast<const float*>(w + (size_t)(k0 + row) * ndim + n0 + c16), true);
        }
      }
    }
    act::cp_commit();
  };
  // a raw B weight (row k, column n of the tile)
  auto raw_w = [&](const float* rb_s, int k, int n) -> W {
    if constexpr (sizeof(W) == 4) {
      return rb_s[k * T::RBS + n];
    } else {
      return reinterpret_cast<const W*>(rb_s)[k * T::RBS8 + n];
    }
  };
  // k-tile kt from its raw stage into fragment stage `stage`: A fragments
  // transformed (row mask, gLN-2) and kept float, B quads (int8 dequant)
  // split into big and small TF32 halves (the small left for the mma to
  // truncate), all in fragment order
  auto stage_tile = [&](int kt, float* stage) {
    const float* ra_s = raw + (kt % NSR) * T::RAW;
    const float* rb_s = ra_s + BM * RAS;
    const int kc = 8 * sks + 2 * tg;
    float2 gm = make_float2(0.f, 0.f), be = gm;
    if (MODE == OUT) {
      gm = ld2(gsc + kt * BK + kc);
      be = ld2(gsc + kdim + kt * BK + kc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mt = sw4 + 2 * i, row = 16 * mt + g;
      float2 lo = ld2(ra_s + row * RAS + kc), hi = ld2(ra_s + (row + 8) * RAS + kc);
      if (MODE == OUT) {  // gLN-2 on valid rows; padded rows stay 0
        if (m0 + row < fl) {
          lo = make_float2(fmaf(lo.x - mean, gm.x, be.x), fmaf(lo.y - mean, gm.y, be.y));
        }
        if (m0 + row + 8 < fl) {
          hi = make_float2(fmaf(hi.x - mean, gm.x, be.x), fmaf(hi.y - mean, gm.y, be.y));
        }
      }
      // quad (a0, a1, a2, a3) = rows (g, g + 8) x k slots (t, t + 4)
      *reinterpret_cast<float4*>(stage + (mt * KS + sks) * FRAG + 4 * lane) =
          make_float4(lo.x, hi.x, lo.y, hi.y);
    }
#pragma unroll
    for (int i = 0; i < T::BQ; ++i) {
      const int ks = (warp + NW * i) / T::NP, k = 8 * ks + 2 * tg, n = 16 * snp + g;
      const float v[4] = {
          weight(raw_w(rb_s, k, n), wsc[0]), weight(raw_w(rb_s, k + 1, n), wsc[0]),
          weight(raw_w(rb_s, k, n + 8), wsc[1]), weight(raw_w(rb_s, k + 1, n + 8), wsc[1])};
      uint32_t big[4], small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) act::split_fast(v[e], big[e], small[e]);
      float* q = stage + AF + (ks * T::NP + snp) * FRAG + 4 * lane;
      *reinterpret_cast<uint4*>(q) = make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(q + T::BF) = make_uint4(small[0], small[1], small[2], small[3]);
    }
  };

  // products: warp (wm, wn) owns rows 32 wm .. + 31 (m16 tiles 2 wm, + 1) and
  // columns BN / 2 wn .. + BN / 2 - 1 (n8 pairs NPW wn ..); its products over
  // a k-tile are formed from zero side by side (4 NPW independent chains) and
  // then added to acc in IEEE float32
  const int wm = warp % 4, wn = warp / 4;
  float acc[2][2 * T::NPW][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 2 * T::NPW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

  for (int kt = 0; kt < NSR - 1; ++kt) fetch(kt);
  act::cp_wait<NSR - 2>();
  __syncthreads();
  stage_tile(0, smem);
  for (int kt = 0; kt < n_kt; ++kt) {
    // the raw slot refilled here held k-tile kt - 1, read before the last
    // barrier; after this barrier k-tile kt + 1 has landed, fragment stage
    // kt % 2 is complete and nobody reads fragment stage (kt + 1) % 2 any more
    fetch(kt + NSR - 1);
    act::cp_wait<NSR - 2>();
    __syncthreads();
    const float* stage = smem + (kt % 2) * T::STAGE;
    float tmp[2][2 * T::NPW][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 2 * T::NPW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[mi][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // this warp's A fragments, split in registers; its B quads, split
      uint32_t ab[2][4], as[2][4], bb[T::NPW][4], bs[T::NPW][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float4 x = ld4(stage + ((2 * wm + mi) * KS + ks) * FRAG + 4 * lane);
        act::split_fast(x.x, ab[mi][0], as[mi][0]);
        act::split_fast(x.y, ab[mi][1], as[mi][1]);
        act::split_fast(x.z, ab[mi][2], as[mi][2]);
        act::split_fast(x.w, ab[mi][3], as[mi][3]);
      }
#pragma unroll
      for (int pp = 0; pp < T::NPW; ++pp) {
        const float* q = stage + AF + (ks * T::NP + T::NPW * wn + pp) * FRAG + 4 * lane;
        const uint4 qb = *reinterpret_cast<const uint4*>(q);
        const uint4 qs = *reinterpret_cast<const uint4*>(q + T::BF);
        bb[pp][0] = qb.x, bb[pp][1] = qb.y, bb[pp][2] = qb.z, bb[pp][3] = qb.w;
        bs[pp][0] = qs.x, bs[pp][1] = qs.y, bs[pp][2] = qs.z, bs[pp][3] = qs.w;
      }
      // the small cross terms first, then big x big; n8 tile nt is half
      // nt % 2 of pair nt / 2
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 2 * T::NPW; ++nt)
          mma_tf32(tmp[mi][nt], as[mi], bb[nt / 2][2 * (nt % 2)], bb[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 2 * T::NPW; ++nt)
          mma_tf32(tmp[mi][nt], ab[mi], bs[nt / 2][2 * (nt % 2)], bs[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 2 * T::NPW; ++nt)
          mma_tf32(tmp[mi][nt], ab[mi], bb[nt / 2][2 * (nt % 2)], bb[nt / 2][2 * (nt % 2) + 1]);
    }
    // the next k-tile's staging while the products run
    if (kt + 1 < n_kt) stage_tile(kt + 1, smem + ((kt + 1) % 2) * T::STAGE);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 2 * T::NPW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] += tmp[mi][nt][e];
  }

  // thread holds rows g (c0, c1) and g + 8 (c2, c3) of each m16 tile,
  // columns 2 tg, 2 tg + 1 of each n8 tile
  if (MODE == IN) {
    const float* b_in = p.vecs;
    const float a1 = p.vecs[ndim];  // vecs row 1: PReLU alpha (N = H)
    float* h1 = p.h1 + (size_t)b * p.f * ndim;
    float s = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int nt = 0; nt < 2 * T::NPW; ++nt) {
        const int col = n0 + (BN / 2) * wn + 8 * nt + 2 * tg;
        const float2 bias = ld2(b_in + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = m0 + 32 * wm + 16 * mi + g + 8 * hh;
          float v0 = acc[mi][nt][2 * hh] + bias.x, v1 = acc[mi][nt][2 * hh + 1] + bias.y;
          v0 = v0 >= 0.f ? v0 : a1 * v0;
          v1 = v1 >= 0.f ? v1 : a1 * v1;
          acc[mi][nt][2 * hh] = v0;
          acc[mi][nt][2 * hh + 1] = v1;
          if (r < fl) {
            *reinterpret_cast<float2*>(h1 + (size_t)r * ndim + col) = make_float2(v0, v1);
            s += v0 + v1;
          }
        }
      }
    }
    // two passes over the tile's valid values, held in acc
    const float cnt = (float)(min(BM, fl - m0) * BN);
    const float mu = block_sum(s, red) / cnt;
    float q = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 2 * T::NPW; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (m0 + 32 * wm + 16 * mi + g + 8 * hh < fl) {
            const float d0 = acc[mi][nt][2 * hh] - mu, d1 = acc[mi][nt][2 * hh + 1] - mu;
            q = fmaf(d0, d0, fmaf(d1, d1, q));
          }
        }
    publish_stats(cnt, mu, block_sum(q, red), p.st, b, blockIdx.y * gridDim.x + blockIdx.x,
                  ((fl + BM - 1) / BM) * gridDim.x);
  } else {
    const int c = p.c;
    const size_t base = (size_t)b * p.f * c;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int nt = 0; nt < 2 * T::NPW; ++nt) {
        const int col = n0 + (BN / 2) * wn + 8 * nt + 2 * tg;
        const bool res = col < c;
        const int cc = res ? col : col - c;
        const float2 bias = ld2(p.cvecs + (res ? 0 : c) + cc);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = m0 + 32 * wm + 16 * mi + g + 8 * hh;
          if (r >= fl) continue;
          const size_t o = base + (size_t)r * c + cc;
          const float2 prev = res ? ld2(p.x_in + o) : ld2(p.skips + o);
          const float2 v = make_float2((prev.x + acc[mi][nt][2 * hh]) + bias.x,
                                       (prev.y + acc[mi][nt][2 * hh + 1]) + bias.y);
          *reinterpret_cast<float2*>((res ? p.x_out : p.skips) + o) = v;
        }
      }
    }
  }
}

// B: h2 = PReLU(dwconv_d(gLN-1(h1) * mask) + b_dw) + gLN-2 partials. A block
// of NT threads covers rb = (NT / (H / 4)) * VPT rows of one item: thread
// (row lane rl, column group cg) owns channels 4 cg .. + 3 of rows
// r0 + rl + RL v, v < VPT, its taps, bias and gLN-1 scale in registers.
template <class W>
__global__ void __launch_bounds__(NT)
dwconv_kernel(const float* __restrict__ h1, const int* __restrict__ f_len,
              const W* __restrict__ w_dw, const float* __restrict__ vecs,
              const float* __restrict__ gln1, float* __restrict__ h2, Stats st, int f, int hd,
              int dil) {
  __shared__ float red[NW];
  const int b = blockIdx.y, fl = f_len[b];
  const int tpr = hd / 4, rl_n = NT / tpr, rb = rl_n * VPT;
  const int r0 = blockIdx.x * rb;
  if (r0 >= fl) return;
  const int tid = threadIdx.x, cg = tid % tpr, rl = tid / tpr, ch = 4 * cg;
  const float mean = gln1[4 * b], rstd = gln1[4 * b + 1];
  const float4 g1 = ld4(vecs + 2 * hd + ch), be1 = ld4(vecs + 3 * hd + ch);
  const float4 bdw = ld4(vecs + 4 * hd + ch);
  const float a2 = vecs[5 * hd];
  const float* sc = vecs + 9 * hd + ch;  // int8 scales of w_dw (unused for float)
  float4 tap[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const W* wt = w_dw + t * hd + ch;
    tap[t] = make_float4(weight(wt[0], sizeof(W) == 1 ? sc[0] : 0.f),
                         weight(wt[1], sizeof(W) == 1 ? sc[1] : 0.f),
                         weight(wt[2], sizeof(W) == 1 ? sc[2] : 0.f),
                         weight(wt[3], sizeof(W) == 1 ? sc[3] : 0.f));
  }
  const float* hb = h1 + (size_t)b * f * hd + ch;
  float* ob = h2 + (size_t)b * f * hd + ch;
  float4 val[VPT];
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int r = r0 + rl + rl_n * v;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < fl) {
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int src = r + (t - 1) * dil;
        if (src >= 0 && src < fl) {  // gLN-1 then the mask: rows past f_len are 0
          const float4 y = ld4(hb + (size_t)src * hd);
          acc.x = fmaf(fmaf((y.x - mean) * rstd, g1.x, be1.x), tap[t].x, acc.x);
          acc.y = fmaf(fmaf((y.y - mean) * rstd, g1.y, be1.y), tap[t].y, acc.y);
          acc.z = fmaf(fmaf((y.z - mean) * rstd, g1.z, be1.z), tap[t].z, acc.z);
          acc.w = fmaf(fmaf((y.w - mean) * rstd, g1.w, be1.w), tap[t].w, acc.w);
        }
      }
      acc.x += bdw.x;
      acc.y += bdw.y;
      acc.z += bdw.z;
      acc.w += bdw.w;
      acc.x = acc.x >= 0.f ? acc.x : a2 * acc.x;
      acc.y = acc.y >= 0.f ? acc.y : a2 * acc.y;
      acc.z = acc.z >= 0.f ? acc.z : a2 * acc.z;
      acc.w = acc.w >= 0.f ? acc.w : a2 * acc.w;
      *reinterpret_cast<float4*>(ob + (size_t)r * hd) = acc;
      s += (acc.x + acc.y) + (acc.z + acc.w);
    }
    val[v] = acc;
  }
  const float cnt = (float)(min(rb, fl - r0) * hd);
  const float mu = block_sum(s, red) / cnt;
  float q = 0.f;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    if (r0 + rl + rl_n * v < fl) {
      const float dx = val[v].x - mu, dy = val[v].y - mu, dz = val[v].z - mu, dw = val[v].w - mu;
      q = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, fmaf(dw, dw, q))));
    }
  }
  publish_stats(cnt, mu, block_sum(q, red), st, b, blockIdx.x, (fl + rb - 1) / rb);
}

// the raise of a GEMM instance's shared-memory cap, once per device
template <class W, int MODE, int BN>
std::atomic<uint64_t>& smem_cap_raised() {
  static std::atomic<uint64_t> raised{0};
  return raised;
}

template <class W, int MODE, int BN>
cudaError_t launch_gemm_bn(const GemmArgs& p, int batch, cudaStream_t stream) {
  const cudaError_t e = act::allow_dynamic_smem(
      reinterpret_cast<const void*>(gemm_kernel<W, MODE, BN>), smem_cap_raised<W, MODE, BN>());
  if (e != cudaSuccess) return e;
  const dim3 grid(p.n / BN, (p.f + BM - 1) / BM, batch);
  gemm_kernel<W, MODE, BN><<<grid, NT, Tile<BN>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// 128-column blocks (half the operand staging per column) where N allows
// them and they still fill the card (sms: its multiprocessors); 64-column
// blocks otherwise (a batch-1 streaming window has 16 row tiles)
template <class W, int MODE>
cudaError_t launch_gemm(const GemmArgs& p, int batch, int sms, cudaStream_t stream) {
  const long blocks128 = (long)((p.f + BM - 1) / BM) * batch * (p.n / 128);
  return p.n % 128 == 0 && blocks128 >= sms ? launch_gemm_bn<W, MODE, 128>(p, batch, stream)
                                            : launch_gemm_bn<W, MODE, 64>(p, batch, stream);
}

// The three launches per TCN block for weights of type W; vecs has vrows rows
// per block and cvecs crows (8 and 2, or 10 and 4 with the int8 scales).
template <class W>
int run_masker(const float* x, const int* f_len, const W* w_in, const W* w_dw,
               const float* vecs, const W* w_rs, const float* cvecs, float* xs, float* h1,
               float* h2, float* stats, float* part, unsigned* tickets, float* skips, int batch,
               int f, int c, int hd, int n_blocks, int n_per_repeat, int n_part, int vrows,
               int crows, cudaStream_t stream) {
  if (c <= 0 || hd <= 0 || c % BK != 0 || hd % 64 != 0 || 1024 % hd != 0 || n_per_repeat <= 0)
    return (int)cudaErrorInvalidValue;
  const int rb = (NT / (hd / 4)) * VPT;  // depthwise rows a block
  // one partial a GEMM block or depthwise block of an item
  if (n_part < ((f + BM - 1) / BM) * (hd / 64) || n_part < (f + rb - 1) / rb)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = cudaMemsetAsync(skips, 0, sizeof(float) * (size_t)batch * f * c, stream)) != cudaSuccess)
    return (int)e;
  if (batch <= 0 || f <= 0 || n_blocks <= 0) return 0;
  if ((e = cudaMemsetAsync(tickets, 0, sizeof(unsigned) * batch, stream)) != cudaSuccess)
    return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const dim3 g_dw((f + rb - 1) / rb, batch);
  const float* cur = x;
  for (int i = 0; i < n_blocks; ++i) {
    const float* vv = vecs + (size_t)i * vrows * hd;
    const float* cv = cvecs + (size_t)i * crows * c;
    float* sti = stats + (size_t)i * batch * 4;
    GemmArgs pa{cur, f_len, w_in + (size_t)i * c * hd, vv + 8 * hd, vv, cv,
                Stats{part, tickets, sti, n_part}, nullptr, nullptr, nullptr, h1, f, c, hd, c};
    if ((e = launch_gemm<W, IN>(pa, batch, sms, stream)) != cudaSuccess) return (int)e;
    dwconv_kernel<W><<<g_dw, NT, 0, stream>>>(h1, f_len, w_dw + (size_t)i * 3 * hd, vv, sti, h2,
                                               Stats{part, tickets, sti + 2, n_part}, f, hd,
                                               1 << (i % n_per_repeat));
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    // cvecs rows 2, 3 are the scales of [W_res | W_skip]'s 2C columns
    GemmArgs pc{h2, f_len, w_rs + (size_t)i * hd * 2 * c, cv + 2 * c, vv, cv,
                Stats{part, tickets, sti, n_part}, cur, xs, skips, nullptr, f, hd, 2 * c, c};
    if ((e = launch_gemm<W, OUT>(pc, batch, sms, stream)) != cudaSuccess) return (int)e;
    cur = xs;  // x is read only; the residual stream lives in xs from block 0 on
  }
  return 0;
}

// ---------------------------------------------------------------------------
// bfloat16 activations: act_tcn_masker_bf16 / act_tcn_masker_s8_bf16.
//
// Replaces the same Pallas kernel at dt = bfloat16 (tcn_kernel.py:176-309,
// the int8 stream's dequant :203-212, dequant_stack :356), with its rounding
// points:
//   A  h1 = bf16(x W_in) (float32 accumulation over all of K), + b_in in
//      bf16, PReLU in bf16; gLN-1 partials over the bf16 values
//   B  y = bf16(((h1 - mean) rstd) g1 + be1) on valid rows (0 elsewhere);
//      taps (y[r-d] w0 + y[r+d] w2) + y[r] w1 in float32, rounded, + b_dw and
//      PReLU in bf16; gLN-2 partials over the bf16 values
//   C  A operand bf16(((h2 - mean) rstd) g2 + be2); res = bf16(.. W_res) +
//      b_res in bf16, x = bf16(x + res); skips = bf16(skips + bf16(.. W_skip)
//      + b_skip): the residual stream and the skip sum round at every block
// Each elementwise step is one IEEE operation (__fadd_rn / __fmul_rn: no
// contraction into an FMA; a bf16 + bf16 or bf16 x bf16 step may run as one
// bf16x2 operation, which rounds to the same bits), so the twin's float32
// ops give the same bits wherever the statistics agree. Statistics: per-tile
// partials (count, mean, m2 about the tile's mean, two passes over values
// held in registers), merged in a fixed order with Chan's formula in double
// by the launch's last CTA (a ticket): two calls give identical bits.
//
// Bound at the flagship shape (B 1, F 31999, 19999 valid, C 128, H 512, 24
// blocks): 1.90e11 flops over 989 TFLOP/s dense bf16, 0.192 ms (x in and the
// sum out are 10 MB, the bf16 weights 9.4 MB). The design's own bytes: h1
// written and read, h2 written and read, the residual and skip streams, ~107
// MB a block, ~0.77 ms a call at 3.35 TB/s (h1 and h2, 20 MB each, can stay
// in the 50 MB L2 between the launches that write and read them).
//
// Design (Hopper): three persistent launches a TCN block. Each CTA walks
// only valid work: (item, row tile, column tile) triples with rows below
// f_len, counted on the device from f_len (no host sync), in a static order
// with a stride of the grid (tcn.bf16_schedule), so no CTA exits at once
// and no wave ends part-empty of work.
//   A, C  gemm_kernel: one producer warp keeps a ring of NS stages full by
//      TMA (cp.async.bulk.tensor, 128-byte swizzle, an mbarrier pair a
//      stage); a stage is a 64-deep k-chunk of the A rows (K-major) and of
//      the weights as they lie ([K, N], N contiguous: an MN-major B operand,
//      no transpose). One or two consumer warpgroups of 64 rows run
//      wgmma.mma_async m64nNk16 (float32 accumulators) by BN = 64 or 128
//      columns, the shape picked on the host so that the tiles fill the card
//      (tcn.bf16_plan). A takes both operands from shared memory. C takes
//      its A operand from registers: each warp reads its h2 fragment from
//      the stage (ldmatrix on the swizzled rows), applies gLN-2 with the
//      IEEE operations above (rows past f_len -> 0) and issues the k16
//      step's product, which runs while the next fragment is formed: no pass
//      rewrites shared memory, no block barrier a k-chunk. The epilogues
//      round in bf16 pairs into a staging tile; its rows leave in 16-byte
//      chunks (C adds the residual and skip rows it loads first: x_out may
//      be x_in).
//   B  dwconv_kernel: chunks of 128 rows x 64 channels; a chunk stages y =
//      gLN-1(h1) once a source row in shared memory (its taps' rows: the
//      chunk's rows +- d, or three windows where d > 128), then forms h2 from
//      the staged taps (the mma.sync design applied gLN-1 three times a row).
// K2-s8 at bf16 dequantises the whole int8 stack once a call (one launch,
// bf16((float)q * scale) with one float32 product), then runs K2 bf16's
// launches on it: 73 launches a call (72 at K2 bf16) and 2 memsets.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; scripts/tcn_masker_ab.py,
// device time by CUDA-graph replay, parent and this design in one call):
// K2 bf16 2.13 / 0.59-0.61 / 1.60-1.61 ms at the flagship / streaming [1,
// 1999] / serving [8, 1999] ragged shapes, against 3.99-4.00 / 1.14-1.15 /
// 2.52 for the mma.sync design this replaces; K2-s8 bf16 2.15-2.16 / 0.61-
// 0.62 / 1.62-1.63 against 4.02-4.03 / 1.17-1.18 / 2.55-2.56. At the
// flagship GEMM A 0.58-0.59, the depthwise pass 0.73-0.74, GEMM C 0.78-0.79
// ms a call (were 1.15, 1.13-1.14, 1.73-1.74). Share of the 0.192 ms bound:
// 0.09 (was 0.048).
// The time is far from both bounds: by clock64 phases and a timeline on the
// card, C's main loop is bound by L2 (A and the weights are re-read a tile:
// ~80 MB a launch), C's 314 tiles leave a part-empty last round on 132 CTAs,
// every launch pays its ramp and the last CTA's merge (~5 us), and A's and
// B's epilogues are long dependent chains at 8 warps an SM.
}  // namespace

#include "wgmma_tma.cuh"

namespace {
namespace b16 {

using act::bf16;
using act::rb;
using act::rbf;

// Rounding to bf16 runs on the card's conversion unit: about 15 single
// values a clock an SM, about 30 pairs (F2FP; scripts/bf16_convert_rate.cu), so the
// kernels round in pairs (act::pack_bf16) and pack values that are bf16
// already by a byte permute
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
// bf16x2 arithmetic, one rounding a half: the sum or product of two bf16
// values rounded once to bf16 equals bf16 of their float32 sum or product
// (float32's 24 bits are at least 2 * 8 + 2, so the double rounding is
// innocuous), one instruction where the float path takes seven
__device__ __forceinline__ uint32_t hadd2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3F803F80u), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t hmul2(uint32_t a, uint32_t b) {
  uint32_t d;  // + (-0): a zero product keeps its sign
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}
// PReLU of a bf16 pair v, slope pair a: each half v where v >= 0, else bf16(a v)
__device__ __forceinline__ uint32_t prelu2(uint32_t v, uint32_t a) {
  const uint32_t n = hmul2(v, a);
  return __byte_perm(v, n, (act::lo_bf16(v) >= 0.f ? 0x0010u : 0x0054u) |
                               (act::hi_bf16(v) >= 0.f ? 0x3200u : 0x7600u));
}

constexpr int KC = 64;          // k-chunk of a stage: one 128-byte swizzled row of bf16
constexpr int NS = 4;           // stages in the ring
constexpr int ROW = 128;        // bytes of a swizzled row
constexpr int ATOM = KC * ROW;  // bytes of a {64, 64} box

// A GEMM's tile: NWG consumer warpgroups of 64 rows each by BN columns, and
// one producer warp; one CTA an SM at NWG 2, two at NWG 1. (Nine warps put
// three on one of the SM's four register files, which caps every thread at
// 168 registers; setmaxnreg did not lift that cap for the consumers, so a
// tile holds at most 64 accumulators a thread: BN <= 128.)
template <int NWG, int BN>
struct Cfg {
  static constexpr int BM = 64 * NWG;
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;
  static constexpr int A_BYTES = BM * ROW;
  static constexpr int B_BYTES = (BN / 64) * ATOM;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the epilogue's staging tile: bf16 [BM][BN + 8] (the pad spreads a
  // warp's 8 rows over the banks), copied out in 16-byte chunks
  static constexpr int SROW = BN + 8;
  static constexpr int CHUNKS = BM * BN / 8 / CONSUMERS;  // 16-byte chunks a consumer thread
};

// what follows the ring in shared memory
struct Scratch {
  uint64_t full[NS], empty[NS];  // TMA landed / consumers done, a stage each
  float gsc[2 * MAX_K];          // OUT: gLN-2's gamma, then beta, over K = H
  float red[8];                  // a float a consumer warp
  double mred[8][3];
  int last;
};
template <int NWG, int BN>
constexpr size_t smem_bytes() {
  using T = Cfg<NWG, BN>;  // 1024: alignment slack; the ring, the staging tile, Scratch
  return 1024 + (size_t)NS * T::STAGE + 2 * T::BM * T::SROW + sizeof(Scratch);
}

struct GemmArgs {
  const int* f_len;    // [B]
  const float* vecs;   // this block's [8+, H]
  const float* cvecs;  // this block's [2+, C]
  Stats st;            // IN: gLN-1 partials, out = stats + 0; OUT reads stats + 2
  const bf16* x_in;    // OUT: [B, F, C]
  bf16* x_out;         // OUT: [B, F, C] (may be x_in: each element is read and then
                       // written by one thread)
  bf16* skips;         // OUT: [B, F, C]
  bf16* h1;            // IN: [B, F, H]
  int batch, f, k, n, c, blk;
};

// The valid tiles of a launch in a static order: item by item, row tile by
// row tile, column tile by column tile (the column tiles of a row tile run
// side by side, so its operand rows come from device memory once); CTA k
// takes tiles k, k + grid, ... (tcn.bf16_schedule lists the same on the host)
struct Tile {
  int b, fl, rt, ct;
};
__device__ __forceinline__ int count_tiles(const int* f_len, int batch, int bm, int n_ct) {
  int n = 0;
  for (int b = 0; b < batch; ++b) n += (f_len[b] + bm - 1) / bm * n_ct;
  return n;
}
__device__ __forceinline__ Tile tile_at(int t, const int* f_len, int bm, int n_ct) {
  for (int b = 0;; ++b) {  // t < count_tiles: ends inside the batch
    const int fl = f_len[b], n = (fl + bm - 1) / bm * n_ct;
    if (t < n) return Tile{b, fl, t / n_ct, t % n_ct};
    t -= n;
  }
}

// block_sum over the consumer threads (named barrier 1; the producer warp
// takes no part)
template <int NWG>
__device__ __forceinline__ float consumer_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  act::named_sync(1, 128 * NWG);
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < 4 * NWG; ++w) s += red[w];
  act::named_sync(1, 128 * NWG);
  return s;
}

// The gLN partial of a tile: item b's slot ``slot``, plain stores (thread 0)
__device__ __forceinline__ void put_partial(float cnt, float mu, float m2, const Stats& st, int b,
                                            int slot) {
  float* part = st.part + ((size_t)b * st.n_part + slot) * 3;
  part[0] = cnt;
  part[1] = mu;
  part[2] = m2;
}

// (n, mean, m2) += (nb, mb, qb), Chan's merge as chan() with one
// correctly rounded reciprocal in place of its two divisions (a division
// takes the card's slow path: the merge tail of a launch was ~5 us)
__device__ __forceinline__ void chan_r(double& n, double& m, double& q, double nb, double mb,
                                       double qb) {
  if (nb == 0.0) return;
  const double nn = n + nb, r = nb * __drcp_rn(nn), d = mb - m;
  m += d * r;
  q += qb + d * d * (n * r);
  n = nn;
}
// a fixed shuffle tree over the 32 lanes of a warp (the result in lane 0)
__device__ __forceinline__ void chan_warp(double& n, double& m, double& q) {
  for (int o = 16; o > 0; o >>= 1) {
    const double nb = __shfl_down_sync(0xffffffffu, n, o);
    const double mb = __shfl_down_sync(0xffffffffu, m, o);
    const double qb = __shfl_down_sync(0xffffffffu, q, o);
    chan_r(n, m, q, nb, mb, qb);
  }
}

// After a CTA's last tile: one fence and one ticket a CTA (the launch's
// ticket, st.tickets[batch]), so no tile waits on a fence or an atomic. The
// last CTA to arrive merges every item's partials (slots 0 .. n_live - 1)
// with Chan's formula in double and writes (mean, rstd): the 4 NWG consumer
// warps split into groups of per = max(1, 4 NWG / batch) warps, a group an
// item, items side by side; a group's threads take slots in turn, then each
// warp's shuffle tree, then the group's warps by a shuffle tree in its first
// warp. A fixed order throughout: two calls give identical bits.
template <int NWG>
__device__ __forceinline__ void merge_stats(const Stats& st, const int* f_len, int batch, int bm,
                                            int n_ct, Scratch& sc) {
  constexpr int NC = 128 * NWG, NWARP = 4 * NWG;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  act::named_sync(1, NC);  // every partial of this CTA is stored (by thread 0)
  if (tid == 0) {
    __threadfence();
    sc.last = atomicAdd(st.tickets + batch, 1u) == gridDim.x - 1;
  }
  act::named_sync(1, NC);
  if (!sc.last) return;
  __threadfence();
  const int per = max(1, NWARP / batch), groups = NWARP / per;
  for (int b0 = 0; b0 < batch; b0 += groups) {
    const int b = b0 + warp / per;
    const bool mine = warp / per < groups && b < batch;  // uniform in the warp
    const int n_live = mine ? (f_len[b] + bm - 1) / bm * n_ct : 0;
    double n = 0.0, m = 0.0, q = 0.0;
    if (mine) {
      const float* part = st.part + (size_t)b * st.n_part * 3;
      for (int i = (warp % per) * 32 + lane; i < n_live; i += per * 32) {
        chan_r(n, m, q, __ldcg(part + 3 * i), __ldcg(part + 3 * i + 1), __ldcg(part + 3 * i + 2));
      }
      chan_warp(n, m, q);
    }
    if (lane == 0) {
      sc.mred[warp][0] = n;
      sc.mred[warp][1] = m;
      sc.mred[warp][2] = q;
    }
    act::named_sync(1, NC);
    if (mine && warp % per == 0) {  // the group's first warp: its warps, lanes 0 .. per - 1
      n = m = q = 0.0;
      if (lane < per) {
        n = sc.mred[warp + lane][0];
        m = sc.mred[warp + lane][1];
        q = sc.mred[warp + lane][2];
      }
      chan_warp(n, m, q);
      if (lane == 0 && n_live > 0) {  // no row: no tile reads this item's statistics
        st.out[4 * b] = (float)m;
        st.out[4 * b + 1] = (float)(1.0 / sqrt(q / fmax(n, 1.0) + (double)EPS));
      }
    }
    act::named_sync(1, NC);  // mred is written again for the next items
  }
  if (tid == 0) st.tickets[batch] = 0u;  // ready for the next launch
}

// A (MODE IN): h1 = PReLU(x W_in + b_in) + gLN-1 partials. C (MODE OUT):
// gLN-2(h2) [W_res | W_skip] into x and skips. ta: the A rows [B, F, K] in
// boxes {64, BM}; tw: the weight stack [NB, K, N] in boxes {64, 64}.
template <int MODE, int NWG, int BN>
__global__ void __launch_bounds__(Cfg<NWG, BN>::THREADS, Cfg<NWG, BN>::MIN_BLOCKS)
    gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                const GemmArgs p) {
  using T = Cfg<NWG, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = act::smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // the swizzle's 1024 B
  const uint32_t ring_s = act::smem_u32(ring);
  bf16* stg = reinterpret_cast<bf16*>(ring + NS * T::STAGE);
  Scratch& sc = *reinterpret_cast<Scratch*>(stg + T::BM * T::SROW);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_ct = p.n / BN, n_kc = (p.k + KC - 1) / KC;
  const int total = count_tiles(p.f_len, p.batch, T::BM, n_ct);
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      act::mbar_init(act::smem_u32(&sc.full[s]), 1);
      act::mbar_init(act::smem_u32(&sc.empty[s]), 4 * NWG);  // lane 0 of each consumer warp
    }
    act::mbar_fence_init();
  }
  if constexpr (MODE == OUT) {
    for (int k = tid; k < p.k; k += T::THREADS) {
      sc.gsc[k] = p.vecs[6 * p.k + k];
      sc.gsc[p.k + k] = p.vecs[7 * p.k + k];
    }
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer warp: one thread keeps the ring full
    if (lane == 0) {
      act::tma_prefetch_map(&ta);
      act::tma_prefetch_map(&tw);
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Tile tl = tile_at(t, p.f_len, T::BM, n_ct);
        for (int kc = 0; kc < n_kc; ++kc) {
          const uint32_t full = act::smem_u32(&sc.full[s]), st = ring_s + s * T::STAGE;
          act::mbar_wait(act::smem_u32(&sc.empty[s]), ph ^ 1);
          act::mbar_arrive_expect_tx(full, T::STAGE);
          act::tma_load_3d(st, &ta, full, kc * KC, tl.rt * T::BM, tl.b);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            act::tma_load_3d(st + T::A_BYTES + j * ATOM, &tw, full, tl.ct * BN + 64 * j, kc * KC,
                             p.blk);
          }
          if (++s == NS) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. + 63 of the tile, warp w4 of
  // it rows 16 w4 .. + 15 of those (g, g + 8 in the accumulator)
  const int wg = warp >> 2, g = lane >> 2, tg = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3);
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int s = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tl = tile_at(t, p.f_len, T::BM, n_ct);
    const int m0 = tl.rt * T::BM, n0 = tl.ct * BN;
    float mean = 0.f, rstd = 0.f;
    if constexpr (MODE == OUT) {
      mean = p.st.out[4 * tl.b + 2];
      rstd = p.st.out[4 * tl.b + 3];
    }
    for (int kc = 0; kc < n_kc; ++kc) {
      act::mbar_wait(act::smem_u32(&sc.full[s]), ph);
      const uint32_t st = ring_s + s * T::STAGE, bs = st + T::A_BYTES;
      if constexpr (MODE == IN) {
        act::fence_operands(acc);
        act::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          act::wgmma_ss<BN>(acc, act::desc_sw128(st + 64 * wg * ROW + 32 * ks, 16, 1024),
                            act::desc_sw128(bs + 16 * ROW * ks, ATOM, 1024), kc > 0 || ks > 0);
        }
        act::wgmma_commit();
        act::wgmma_wait<0>();
        act::fence_operands(acc);
      } else {
        // this warp's A fragments, a k16 step at a time: ldmatrix on the
        // swizzled rows, gLN-2 in registers (rows past f_len -> 0), then the
        // step's product, which runs while the next fragment is formed
        uint32_t af[KC / 16][4];
        act::fence_operands(acc);
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          const int row = r0 + (lane & 15), ch = 2 * ks + (lane >> 4);
          act::ldsm_x4(af[ks], st + row * ROW + ((ch ^ (row & 7)) << 4));
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // k 2 tg, + 1 (+ 8 at h = 1)
            const int k = kc * KC + 16 * ks + 2 * tg + 8 * h;
            const float2 gm = *reinterpret_cast<const float2*>(sc.gsc + k);
            const float2 be = *reinterpret_cast<const float2*>(sc.gsc + p.k + k);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {  // rows g, g + 8
              uint32_t& a = af[ks][2 * h + hr];
              const float y0 = __fadd_rn(
                  __fmul_rn(__fmul_rn(__fsub_rn(act::lo_bf16(a), mean), rstd), gm.x), be.x);
              const float y1 = __fadd_rn(
                  __fmul_rn(__fmul_rn(__fsub_rn(act::hi_bf16(a), mean), rstd), gm.y), be.y);
              a = m0 + r0 + g + 8 * hr < tl.fl ? act::pack_bf16(y0, y1) : 0u;
            }
          }
          act::wgmma_fence();
          act::wgmma_rs<BN>(acc, af[ks], act::desc_sw128(bs + 16 * ROW * ks, ATOM, 1024),
                            kc > 0 || ks > 0);
        }
        act::wgmma_commit();
        act::wgmma_wait<0>();
        act::fence_operands(acc);
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) act::fence_regs(af[ks]);  // live until done
      }
      __syncwarp();
      if (lane == 0) act::mbar_arrive(act::smem_u32(&sc.empty[s]));  // the stage is read
      if (++s == NS) {
        s = 0;
        ph ^= 1;
      }
    }

    // thread holds rows g (acc 4 j + 0, 1) and g + 8 (4 j + 2, 3) of its
    // warp's 16, columns 8 j + 2 tg, + 1. It stages its rounded values in
    // the staging tile (free once every consumer is past the last tile's
    // copy-out); the copy-out moves whole 16-byte chunks of rows.
    act::named_sync(1, T::CONSUMERS);
    if constexpr (MODE == IN) {
      const float a1 = rbf(__ldg(p.vecs + p.n));  // vecs row 1: PReLU alpha (N = H)
      const uint32_t a2 = pack_exact(a1, a1);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * tg;
        const uint32_t bias =
            act::pack_bf16(__ldg(p.vecs + n0 + col), __ldg(p.vecs + n0 + col + 1));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + g + 8 * hh;
          const uint32_t v = prelu2(
              hadd2(act::pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]), bias), a2);
          acc[4 * j + 2 * hh] = act::lo_bf16(v);
          acc[4 * j + 2 * hh + 1] = act::hi_bf16(v);
          *reinterpret_cast<uint32_t*>(stg + r * T::SROW + col) = v;
          if (m0 + r < tl.fl) sum += acc[4 * j + 2 * hh] + acc[4 * j + 2 * hh + 1];
        }
      }
      // two passes over the tile's valid values, held in acc
      const float cnt = (float)(min(T::BM, tl.fl - m0) * BN);
      const float mu = consumer_sum<NWG>(sum, sc.red) / cnt;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (m0 + r0 + g + 8 * hh < tl.fl) {
            const float d0 = acc[4 * j + 2 * hh] - mu, d1 = acc[4 * j + 2 * hh + 1] - mu;
            q = fmaf(d0, d0, fmaf(d1, d1, q));
          }
        }
      q = consumer_sum<NWG>(q, sc.red);
      if (tid == 0) put_partial(cnt, mu, q, p.st, tl.b, tl.rt * n_ct + tl.ct);
      bf16* h1 = p.h1 + ((size_t)tl.b * p.f + m0) * p.n + n0;
#pragma unroll
      for (int i = 0; i < T::CHUNKS; ++i) {
        const int e = tid + T::CONSUMERS * i, r = e / (BN / 8), ch = 8 * (e % (BN / 8));
        if (m0 + r < tl.fl) {
          *reinterpret_cast<uint4*>(h1 + (size_t)r * p.n + ch) =
              *reinterpret_cast<const uint4*>(stg + r * T::SROW + ch);
        }
      }
    } else {
      const int c = p.c;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * tg;
        // columns [0, C) are W_res's, [C, 2 C) W_skip's: cvecs rows 0, 1
        const uint32_t bias =
            act::pack_bf16(__ldg(p.cvecs + n0 + col), __ldg(p.cvecs + n0 + col + 1));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          *reinterpret_cast<uint32_t*>(stg + (r0 + g + 8 * hh) * T::SROW + col) =
              hadd2(act::pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]), bias);
        }
      }
      act::named_sync(1, T::CONSUMERS);
      // x = bf16(x + res), skips = bf16(skips + skip), 8 columns a chunk (C %
      // 32 == 0: no chunk straddles the two); every chunk this thread adds to
      // is loaded before its first store (x_out may be x_in)
      const size_t base = ((size_t)tl.b * p.f + m0) * c;
      uint4 prev[T::CHUNKS];
#pragma unroll
      for (int i = 0; i < T::CHUNKS; ++i) {
        const int e = tid + T::CONSUMERS * i, r = e / (BN / 8), col = n0 + 8 * (e % (BN / 8));
        prev[i] = m0 + r < tl.fl ? *reinterpret_cast<const uint4*>(
                                       (col < c ? p.x_in + col : p.skips + col - c) + base +
                                       (size_t)r * c)
                                 : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < T::CHUNKS; ++i) {
        const int e = tid + T::CONSUMERS * i, r = e / (BN / 8), ch = 8 * (e % (BN / 8));
        if (m0 + r >= tl.fl) continue;
        const int col = n0 + ch;
        const uint4 u = *reinterpret_cast<const uint4*>(stg + r * T::SROW + ch);
        *reinterpret_cast<uint4*>((col < c ? p.x_out + col : p.skips + col - c) + base +
                                  (size_t)r * c) =
            make_uint4(hadd2(prev[i].x, u.x), hadd2(prev[i].y, u.y), hadd2(prev[i].z, u.z),
                       hadd2(prev[i].w, u.w));
      }
    }
  }
  if constexpr (MODE == IN) merge_stats<NWG>(p.st, p.f_len, p.batch, T::BM, n_ct, sc);
}

// B at bf16, persistent: each CTA walks chunks of DR rows by DW channels
// (item, row chunk, channel slice; rows below f_len only, a static order with
// a stride of the grid, as the GEMMs' tiles). A chunk first stages y =
// bf16(((h1 - mean) rstd) g1 + be1) (0 outside [0, f_len)) for every source
// row its taps read, once a row: the rows r0 - d .. r0 + DR + d where d <=
// DR, else the three windows r0 + (t - 1) d + [0, DR); then thread (row
// lane rl, channel group cg) forms channels 8 cg .. + 7 of rows rl + 32 v,
// v < 4, from the staged taps, and the chunk's gLN-2 partial (two passes
// over the values it holds). The partials merge once a launch (merge_stats).
constexpr int DR = 128, DW = 64;
constexpr int SU = 4;  // staged 16-byte items a thread in flight
constexpr size_t DW_SMEM = 3 * DR * DW * sizeof(bf16) + sizeof(Scratch);

__device__ __forceinline__ int staged_src(int s, int r0, int d) {
  return d <= DR ? r0 - d + s : r0 + (s / DR - 1) * d + s % DR;
}
__device__ __forceinline__ int staged_row(int i, int t, int d) {  // tap t of chunk row i
  return d <= DR ? i + t * d : t * DR + i;
}

__global__ void __launch_bounds__(NT, 2)
dwconv_kernel(const bf16* __restrict__ h1, const int* __restrict__ f_len,
              const bf16* __restrict__ w_dw, const float* __restrict__ vecs,
              const float* __restrict__ gln1, bf16* __restrict__ h2, Stats st, int batch, int f,
              int hd, int dil) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  bf16* ys = reinterpret_cast<bf16*>(dw_smem);
  Scratch& sc = *reinterpret_cast<Scratch*>(dw_smem + 3 * DR * DW * sizeof(bf16));
  const int tid = threadIdx.x, cg = tid % (DW / 8), rl = tid / (DW / 8);
  const int n_cs = hd / DW, total = count_tiles(f_len, batch, DR, n_cs);
  const int n_src = dil <= DR ? DR + 2 * dil : 3 * DR;
  const uint32_t a2 = pack_exact(rbf(vecs[5 * hd]), rbf(vecs[5 * hd]));  // PReLU slope
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tl = tile_at(t, f_len, DR, n_cs);
    const int r0 = tl.rt * DR, c0 = tl.ct * DW, fl = tl.fl;
    const float mean = gln1[4 * tl.b], rstd = gln1[4 * tl.b + 1];
    const bf16* hb = h1 + (size_t)tl.b * f * hd + c0;
    // stage the taps' rows: item q = (row s, 16-byte chunk e), DW / 8 a row,
    // SU items a thread at a time, all loads before any use; a thread's
    // items share its chunk e (NT % (DW / 8) == 0), so gLN-1's gamma and
    // beta for them are loaded once
    const int se = 8 * (tid % (DW / 8));
    float g1[8], be1[8];
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      const float4 gv = *reinterpret_cast<const float4*>(vecs + 2 * hd + c0 + se + j);
      const float4 bv = *reinterpret_cast<const float4*>(vecs + 3 * hd + c0 + se + j);
      g1[j] = gv.x, g1[j + 1] = gv.y, g1[j + 2] = gv.z, g1[j + 3] = gv.w;
      be1[j] = bv.x, be1[j + 1] = bv.y, be1[j + 2] = bv.z, be1[j + 3] = bv.w;
    }
    for (int q0 = tid; q0 < n_src * (DW / 8); q0 += SU * NT) {
      uint4 raw[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int q = q0 + u * NT, s_ = q / (DW / 8), src = staged_src(s_, r0, dil);
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (q < n_src * (DW / 8) && src >= 0 && src < fl) {
          raw[u] = *reinterpret_cast<const uint4*>(hb + (size_t)src * hd + se);
        }
      }
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int q = q0 + u * NT, s_ = q / (DW / 8), src = staged_src(s_, r0, dil);
        if (q >= n_src * (DW / 8)) break;
        uint4 out = make_uint4(0u, 0u, 0u, 0u);
        if (src >= 0 && src < fl) {  // gLN-1, rounded, then the mask: rows past f_len are 0
          const uint32_t in[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
          uint32_t y[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float lo =
                __fmul_rn(__fmul_rn(__fsub_rn(act::lo_bf16(in[k]), mean), rstd), g1[2 * k]);
            const float hi =
                __fmul_rn(__fmul_rn(__fsub_rn(act::hi_bf16(in[k]), mean), rstd), g1[2 * k + 1]);
            y[k] = act::pack_bf16(__fadd_rn(lo, be1[2 * k]), __fadd_rn(hi, be1[2 * k + 1]));
          }
          out = make_uint4(y[0], y[1], y[2], y[3]);
        }
        *reinterpret_cast<uint4*>(ys + s_ * DW + se) = out;
      }
    }
    __syncthreads();
    const int ch = c0 + 8 * cg;
    float tap[3][8];
    uint32_t bdw[4];  // b_dw rounded, in pairs
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint4 w = *reinterpret_cast<const uint4*>(w_dw + k * hd + ch);
      const uint32_t wu[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tap[k][2 * j] = act::lo_bf16(wu[j]);
        tap[k][2 * j + 1] = act::hi_bf16(wu[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      const float4 bv = *reinterpret_cast<const float4*>(vecs + 4 * hd + ch + j);
      bdw[j / 2] = act::pack_bf16(bv.x, bv.y);
      bdw[j / 2 + 1] = act::pack_bf16(bv.z, bv.w);
    }
    float val[DR / 32][8];
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < DR / 32; ++v) {
      const int i = rl + 32 * v;
      float y[3][8];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint4 raw = *reinterpret_cast<const uint4*>(ys + staged_row(i, k, dil) * DW + 8 * cg);
        const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          y[k][2 * e] = act::lo_bf16(u[e]);
          y[k][2 * e + 1] = act::hi_bf16(u[e]);
        }
      }
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] = __fadd_rn(__fadd_rn(__fmul_rn(y[0][j], tap[0][j]), __fmul_rn(y[2][j], tap[2][j])),
                         __fmul_rn(y[1][j], tap[1][j]));
      }
      uint32_t hv[4];  // rounded, + b_dw, PReLU: bf16 pairs
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hv[e] = prelu2(hadd2(act::pack_bf16(o[2 * e], o[2 * e + 1]), bdw[e]), a2);
        val[v][2 * e] = act::lo_bf16(hv[e]);
        val[v][2 * e + 1] = act::hi_bf16(hv[e]);
      }
      if (r0 + i < fl) {
        *reinterpret_cast<uint4*>(h2 + ((size_t)tl.b * f + r0 + i) * hd + ch) =
            make_uint4(hv[0], hv[1], hv[2], hv[3]);
#pragma unroll
        for (int j = 0; j < 8; j += 2) sum += val[v][j] + val[v][j + 1];
      }
    }
    // the chunk's partial, two passes over the values held in val; the
    // barriers also free ys for the next chunk
    const float cnt = (float)(min(DR, fl - r0) * DW);
    const float mu = consumer_sum<2>(sum, sc.red) / cnt;
    float q = 0.f;
#pragma unroll
    for (int v = 0; v < DR / 32; ++v) {
      if (r0 + rl + 32 * v < fl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = val[v][j] - mu;
          q = fmaf(d, d, q);
        }
      }
    }
    q = consumer_sum<2>(q, sc.red);
    if (tid == 0) put_partial(cnt, mu, q, st, tl.b, tl.rt * n_cs + tl.ct);
  }
  merge_stats<2>(st, f_len, batch, DR, n_cs, sc);
}

// The whole int8 stack -> bf16 once a call, bf16((float)q * scale) with one
// float32 product: out holds w_in [NB, C, H] (scales vecs row 8), then w_dw
// [NB, 3, H] (row 9), then [W_res | W_skip] [NB, H, 2C] (cvecs rows 2, 3),
// the bf16 entry point's layouts
__global__ void dequant_kernel(const int8_t* __restrict__ w_in, const int8_t* __restrict__ w_dw,
                               const int8_t* __restrict__ w_rs, const float* __restrict__ vecs,
                               const float* __restrict__ cvecs, bf16* __restrict__ out, int c,
                               int hd, int nb) {
  const size_t n_in = (size_t)nb * c * hd, n_dw = (size_t)nb * 3 * hd;
  const size_t n = n_in + n_dw + (size_t)nb * hd * 2 * c;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float q, sc;
    if (i < n_in) {
      q = (float)w_in[i];
      sc = vecs[(i / ((size_t)c * hd) * 10 + 8) * hd + i % hd];
    } else if (i < n_in + n_dw) {
      const size_t j = i - n_in;
      q = (float)w_dw[j];
      sc = vecs[(j / (3 * (size_t)hd) * 10 + 9) * hd + j % hd];
    } else {
      const size_t j = i - n_in - n_dw;
      q = (float)w_rs[j];
      // rows 2, 3: the scales of W_res, then W_skip, one after the other
      sc = cvecs[(j / ((size_t)hd * 2 * c) * 4 + 2) * c + j % (2 * c)];
    }
    out[i] = rb(__fmul_rn(q, sc));
  }
}

template <int MODE, int NWG, int BN>
cudaError_t launch_cfg(int grid, const CUtensorMap& ta, const CUtensorMap& tw, const GemmArgs& p,
                       cudaStream_t stream) {
  static std::atomic<uint64_t> raised{0};  // the shared-memory cap, once per device
  const cudaError_t e =
      act::allow_dynamic_smem(reinterpret_cast<const void*>(gemm_kernel<MODE, NWG, BN>), raised);
  if (e != cudaSuccess) return e;
  gemm_kernel<MODE, NWG, BN><<<grid, Cfg<NWG, BN>::THREADS, smem_bytes<NWG, BN>(), stream>>>(
      ta, tw, p);
  return cudaGetLastError();
}

// the tile shapes, numbered as tcn.BF16_TILES: (consumer warpgroups, columns)
constexpr int TILES[3][2] = {{2, 128}, {2, 64}, {1, 64}};

template <int MODE>
cudaError_t launch_gemm(int cfg, int grid, const CUtensorMap& ta, const CUtensorMap& tw,
                        const GemmArgs& p, cudaStream_t stream) {
  switch (cfg) {
    case 0: return launch_cfg<MODE, 2, 128>(grid, ta, tw, p, stream);
    case 1: return launch_cfg<MODE, 2, 64>(grid, ta, tw, p, stream);
    case 2: return launch_cfg<MODE, 1, 64>(grid, ta, tw, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The launches per TCN block at bf16, GEMM A in tile shape cfg_in on
// grid_in CTAs, the depthwise pass on grid_dw, GEMM C in cfg_out on grid_out
// (tcn.bf16_plan); S8: the
// weights are the int8 stream, dequantised into wdq (NB (C H + 3 H + 2 H C)
// bf16) first.
template <bool S8>
int run_masker(const bf16* x, const int* f_len, const void* w_in, const void* w_dw,
               const float* vecs, const void* w_rs, const float* cvecs, bf16* wdq, bf16* xs,
               bf16* h1, bf16* h2, float* stats, float* part, unsigned* tickets, bf16* skips,
               int batch, int f, int c, int hd, int n_blocks, int n_per_repeat, int n_part,
               int cfg_in, int grid_in, int cfg_out, int grid_out, int grid_dw,
               cudaStream_t stream) {
  const int vrows = S8 ? 10 : 8, crows = S8 ? 4 : 2;
  if (c <= 0 || hd <= 0 || c % 32 != 0 || hd % 64 != 0 || 1024 % hd != 0 || n_per_repeat <= 0 ||
      cfg_in < 0 || cfg_in > 2 || cfg_out < 0 || cfg_out > 2 || grid_in <= 0 || grid_out <= 0)
    return (int)cudaErrorInvalidValue;
  const int bm_in = 64 * TILES[cfg_in][0], bn_in = TILES[cfg_in][1];
  const int bm_out = 64 * TILES[cfg_out][0], bn_out = TILES[cfg_out][1];
  if (hd % bn_in != 0 || 2 * c % bn_out != 0 || grid_dw <= 0 ||
      n_part < ((f + bm_in - 1) / bm_in) * (hd / bn_in) || n_part < (f + DR - 1) / DR * (hd / DW))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = cudaMemsetAsync(skips, 0, sizeof(bf16) * (size_t)batch * f * c, stream)) != cudaSuccess)
    return (int)e;
  if (batch <= 0 || f <= 0 || n_blocks <= 0) return 0;
  // a ticket an item (the depthwise pass) and the launch's (the GEMMs)
  if ((e = cudaMemsetAsync(tickets, 0, sizeof(unsigned) * (batch + 1), stream)) != cudaSuccess)
    return (int)e;
  const bf16 *wi, *wd, *wr;
  if (S8) {
    const size_t n_w = (size_t)n_blocks * ((size_t)c * hd + 3 * hd + (size_t)hd * 2 * c);
    const size_t blocks = (n_w + NT - 1) / NT;
    dequant_kernel<<<(int)(blocks < 4096 ? blocks : 4096), NT, 0, stream>>>(
        static_cast<const int8_t*>(w_in), static_cast<const int8_t*>(w_dw),
        static_cast<const int8_t*>(w_rs), vecs, cvecs, wdq, c, hd, n_blocks);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    wi = wdq;
    wd = wi + (size_t)n_blocks * c * hd;
    wr = wd + (size_t)n_blocks * 3 * hd;
  } else {
    wi = static_cast<const bf16*>(w_in);
    wd = static_cast<const bf16*>(w_dw);
    wr = static_cast<const bf16*>(w_rs);
  }
  // the A rows in boxes of {64 k, BM rows}, the weight stacks in {64 n, 64 k}
  CUtensorMap m_x, m_xs, m_h2, m_in, m_rs;
  if ((e = act::tmap_3d_bf16(&m_x, x, c, f, batch, 64, bm_in)) != cudaSuccess ||
      (e = act::tmap_3d_bf16(&m_xs, xs, c, f, batch, 64, bm_in)) != cudaSuccess ||
      (e = act::tmap_3d_bf16(&m_h2, h2, hd, f, batch, 64, bm_out)) != cudaSuccess ||
      (e = act::tmap_3d_bf16(&m_in, wi, hd, c, n_blocks, 64, 64)) != cudaSuccess ||
      (e = act::tmap_3d_bf16(&m_rs, wr, 2 * c, hd, n_blocks, 64, 64)) != cudaSuccess)
    return (int)e;
  static std::atomic<uint64_t> dw_raised{0};
  if ((e = act::allow_dynamic_smem(reinterpret_cast<const void*>(dwconv_kernel), dw_raised)) !=
      cudaSuccess)
    return (int)e;
  const bf16* cur = x;
  for (int i = 0; i < n_blocks; ++i) {
    const float* vv = vecs + (size_t)i * vrows * hd;
    const float* cv = cvecs + (size_t)i * crows * c;
    float* sti = stats + (size_t)i * batch * 4;
    const GemmArgs pa{f_len, vv, cv, Stats{part, tickets, sti, n_part}, nullptr, nullptr, nullptr,
                      h1, batch, f, c, hd, c, i};
    if ((e = launch_gemm<IN>(cfg_in, grid_in, i == 0 ? m_x : m_xs, m_in, pa, stream)) !=
        cudaSuccess)
      return (int)e;
    dwconv_kernel<<<grid_dw, NT, DW_SMEM, stream>>>(h1, f_len, wd + (size_t)i * 3 * hd, vv, sti,
                                                    h2, Stats{part, tickets, sti + 2, n_part},
                                                    batch, f, hd, 1 << (i % n_per_repeat));
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const GemmArgs pc{f_len, vv, cv, Stats{part, tickets, sti, n_part}, cur, xs, skips, nullptr,
                      batch, f, hd, 2 * c, c, i};
    if ((e = launch_gemm<OUT>(cfg_out, grid_out, m_h2, m_rs, pc, stream)) != cudaSuccess)
      return (int)e;
    cur = xs;  // x is read only; the residual stream lives in xs from block 0 on
  }
  return 0;
}

}  // namespace b16

}  // namespace

// x: [B, F, C] input (read only); f_len: [B] int32 in [0, F]; per-block
// stacks w_in [NB, C, H], w_dw [NB, 3, H], vecs [NB, 8, H], w_rs [NB, H, 2C]
// (W_res | W_skip), cvecs [NB, 2, C]. Scratch: xs [B, F, C], h1, h2
// [B, F, H], stats [NB, B, 4], part [B, n_part, 3] with n_part >= 2 ceil(F /
// 128) H / 64, tickets [B] (uint32). Output: skips [B, F, C], rows past
// f_len exactly 0. C % 32 == 0, H % 64 == 0 and H divides 1024.
extern "C" int act_tcn_masker(const float* x, const int* f_len, const float* w_in,
                              const float* w_dw, const float* vecs, const float* w_rs,
                              const float* cvecs, float* xs, float* h1, float* h2, float* stats,
                              float* part, unsigned* tickets, float* skips, int batch, int f,
                              int c, int hd, int n_blocks, int n_per_repeat, int n_part,
                              cudaStream_t stream) {
  return run_masker<float>(x, f_len, w_in, w_dw, vecs, w_rs, cvecs, xs, h1, h2, stats, part,
                           tickets, skips, batch, f, c, hd, n_blocks, n_per_repeat, n_part, 8, 2,
                           stream);
}

// The int8 weight stream: w_in, w_dw, w_rs as int8 in the same layouts;
// vecs [NB, 10, H] with the scales of w_in and w_dw in rows 8, 9; cvecs
// [NB, 4, C] with the scales of W_res and W_skip in rows 2, 3. Everything
// else as act_tcn_masker.
extern "C" int act_tcn_masker_s8(const float* x, const int* f_len, const int8_t* w_in,
                                 const int8_t* w_dw, const float* vecs, const int8_t* w_rs,
                                 const float* cvecs, float* xs, float* h1, float* h2,
                                 float* stats, float* part, unsigned* tickets, float* skips,
                                 int batch, int f, int c, int hd, int n_blocks, int n_per_repeat,
                                 int n_part, cudaStream_t stream) {
  return run_masker<int8_t>(x, f_len, w_in, w_dw, vecs, w_rs, cvecs, xs, h1, h2, stats, part,
                            tickets, skips, batch, f, c, hd, n_blocks, n_per_repeat, n_part, 10, 4,
                            stream);
}

// bfloat16 activations, bfloat16 weights: x, w_in, w_dw, w_rs, the scratch
// xs, h1, h2 and the output skips bf16; vecs [NB, 8, H] and cvecs [NB, 2, C]
// float32; tickets [B + 1]; everything else as act_tcn_masker. cfg_in and
// cfg_out: the tile shapes of GEMM A and C (0, 1, 2: 2 x 128, 2 x 64, 1 x 64
// warpgroups x columns; the columns divide H and 2 C), grid_in and grid_out
// their persistent grids, grid_dw the depthwise pass's (tcn.bf16_plan).
// Rows past f_len exactly 0.
extern "C" int act_tcn_masker_bf16(const act::bf16* x, const int* f_len, const act::bf16* w_in,
                                   const act::bf16* w_dw, const float* vecs,
                                   const act::bf16* w_rs, const float* cvecs, act::bf16* xs,
                                   act::bf16* h1, act::bf16* h2, float* stats, float* part,
                                   unsigned* tickets, act::bf16* skips, int batch, int f, int c,
                                   int hd, int n_blocks, int n_per_repeat, int n_part, int cfg_in,
                                   int grid_in, int cfg_out, int grid_out, int grid_dw,
                                   cudaStream_t stream) {
  return b16::run_masker<false>(x, f_len, w_in, w_dw, vecs, w_rs, cvecs, nullptr, xs, h1, h2,
                                stats, part, tickets, skips, batch, f, c, hd, n_blocks,
                                n_per_repeat, n_part, cfg_in, grid_in, cfg_out, grid_out, grid_dw,
                                stream);
}

// bfloat16 activations, the int8 weight stream (layouts as act_tcn_masker_s8);
// wdq: scratch of NB (C H + 3 H + 2 H C) bf16 for the stack dequantised once.
extern "C" int act_tcn_masker_s8_bf16(const act::bf16* x, const int* f_len, const int8_t* w_in,
                                      const int8_t* w_dw, const float* vecs, const int8_t* w_rs,
                                      const float* cvecs, act::bf16* wdq, act::bf16* xs,
                                      act::bf16* h1, act::bf16* h2, float* stats, float* part,
                                      unsigned* tickets, act::bf16* skips, int batch, int f,
                                      int c, int hd, int n_blocks, int n_per_repeat, int n_part,
                                      int cfg_in, int grid_in, int cfg_out, int grid_out,
                                      int grid_dw, cudaStream_t stream) {
  return b16::run_masker<true>(x, f_len, w_in, w_dw, vecs, w_rs, cvecs, wdq, xs, h1, h2, stats,
                               part, tickets, skips, batch, f, c, hd, n_blocks, n_per_repeat,
                               n_part, cfg_in, grid_in, cfg_out, grid_out, grid_dw, stream);
}

