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
// The same three launches a TCN block and the same statistics as above, with
// the JAX kernel's rounding points at dt = bfloat16 (tcn_kernel.py:176-309):
//   A  h1 = bf16(x W_in) (float32 accumulation), + b_in in bf16, PReLU in bf16;
//      gLN-1 partials over the bf16 values
//   B  y = bf16(((h1 - mean) rstd) g1 + be1) on valid rows (0 elsewhere);
//      taps (y[r-d] w0 + y[r+d] w2) + y[r] w1 in float32, rounded, + b_dw and
//      PReLU in bf16; gLN-2 partials over the bf16 values
//   C  A operand bf16(((h2 - mean) rstd) g2 + be2); res = bf16(.. W_res) +
//      b_res in bf16, x = bf16(x + res); skips = bf16(skips + bf16(.. W_skip)
//      + b_skip): the residual stream and the skip sum round at every block
// Each elementwise step is one IEEE operation (__fadd_rn / __fmul_rn: no
// contraction into an FMA), so the twin's float32 ops give the same bits
// wherever the statistics agree. Products: mma.sync m16n8k16 bf16, one
// tensor-core product where 3xTF32 takes three, accumulated in the mma's
// float32 registers over all of K (the sum is rounded to bf16 afterwards,
// which dwarfs the accumulator's own truncation). A block of 8 warps owns
// 128 rows x BN (128 or 64) columns, warps 4 x 2 of 32 x BN / 2; 32-deep
// k-tiles of A ([row][k]) and B ([k][n], as the weights lie) arrive by
// 16-byte cp.async in a three-stage ring; A fragments are 32-bit loads,
// B fragments ldmatrix .trans. GEMM C applies gLN-2 to its A tile in shared
// memory once it has landed. Bound at the flagship shape: the same 1.90e11
// flops over 989 TFLOP/s dense bf16, 0.19 ms (x in and the sum out are 10 MB,
// the bf16 weights 9.4 MB). This design also moves [f_len, H] through device
// memory four times a block (h1 written, read; h2 written, read: ~2.0 GB at
// 2 bytes, 0.59 ms at 3.35 TB/s), a floor of its own above that bound.
// K2-s8 at bf16 dequantises each block's int8 weights at the block's entry,
// bf16((float)q * scale) with one float32 product (tcn_kernel.py:203-212),
// into a scratch the block's three launches then read as bf16 weights.
namespace b16 {

using act::bf16;
using act::fb;
using act::rb;
using act::rbf;

constexpr int BK = 32;        // contraction depth of a k-tile (two k16 steps)
constexpr int NS = 3;         // k-tiles in flight
constexpr int AS = BK + 8;    // row stride (bf16) of an A tile: 80 bytes
template <int BN>
struct Tile {
  static constexpr int BS = BN + 8;  // row stride (bf16) of a B tile
  static constexpr int STAGE = BM * AS + BK * BS;
  static constexpr size_t SMEM = sizeof(bf16) * NS * STAGE + sizeof(float) * 2 * MAX_K;
  static constexpr int NT8 = BN / 16;  // n8 tiles a warp
};

struct GemmArgs {
  const bf16* a;       // [B, F, K]: x (IN) or h2 (OUT)
  const int* f_len;    // [B]
  const bf16* w;       // [K, N]
  const float* vecs;   // this block's [8+, H]
  const float* cvecs;  // this block's [2+, C]
  Stats st;            // IN: gLN-1 partials, out = stats + 0; OUT reads stats + 2
  const bf16* x_in;    // OUT: [B, F, C]
  bf16* x_out;         // OUT: [B, F, C] (may be x_in)
  bf16* skips;         // OUT: [B, F, C]
  bf16* h1;            // IN: [B, F, H]
  int f, k, n, c;
};

template <int MODE, int BN>
__global__ void __launch_bounds__(NT) gemm_kernel(GemmArgs p) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  float* gsc = reinterpret_cast<float*>(smem_raw + sizeof(bf16) * NS * T::STAGE);
  __shared__ float red[NW];
  const int b = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int fl = p.f_len[b];
  if (m0 >= fl) return;  // a tile wholly past f_len: nothing to compute
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int kdim = p.k, ndim = p.n;
  const bf16* a = p.a + (size_t)b * p.f * kdim;
  float mean = 0.f, rstd = 0.f;
  if (MODE == OUT) {  // gLN-2's gamma, beta over the H contraction
    mean = p.st.out[4 * b + 2];
    rstd = p.st.out[4 * b + 3];
    for (int k = tid; k < kdim; k += NT) {
      gsc[k] = p.vecs[6 * kdim + k];
      gsc[kdim + k] = p.vecs[7 * kdim + k];
    }
  }
  const int n_kt = kdim / BK;
  auto fetch = [&](int kt) {
    if (kt < n_kt) {
      bf16* as = smem + (kt % NS) * T::STAGE;
      bf16* bs = as + BM * AS;
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < BM * BK / 8 / NT; ++i) {
        const int q = tid + NT * i, row = q / (BK / 8), c8 = 8 * (q % (BK / 8));
        const bool in = m0 + row < fl;
        act::cp_async16b(as + row * AS + c8, a + (size_t)(in ? m0 + row : 0) * kdim + k0 + c8, in);
      }
      for (int q = tid; q < BK * BN / 8; q += NT) {
        const int row = q / (BN / 8), c8 = 8 * (q % (BN / 8));
        act::cp_async16b(bs + row * T::BS + c8, p.w + (size_t)(k0 + row) * ndim + n0 + c8, true);
      }
    }
    act::cp_commit();
  };

  const int wm = warp % 4, wn = warp / 4;
  float acc[2][T::NT8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < T::NT8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

  for (int kt = 0; kt < NS - 1; ++kt) fetch(kt);
  for (int kt = 0; kt < n_kt; ++kt) {
    // k-tile kt has landed, and every warp is past k-tile kt - 1, whose
    // slot the next fetch refills
    act::cp_wait<NS - 2>();
    __syncthreads();
    fetch(kt + NS - 1);
    bf16* as = smem + (kt % NS) * T::STAGE;
    const bf16* bs = as + BM * AS;
    if (MODE == OUT) {  // gLN-2 on the valid rows of the A tile; the rest stay 0
#pragma unroll
      for (int i = 0; i < BM * BK / 2 / NT; ++i) {
        const int q = tid + NT * i, row = q / (BK / 2), c2 = 2 * (q % (BK / 2));
        if (m0 + row < fl) {
          __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(as + row * AS + c2);
          const float2 v = __bfloat1622float2(*e);
          const int k = kt * BK + c2;
          const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.x, mean), rstd), gsc[k]),
                                     gsc[kdim + k]);
          const float y1 = __fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(v.y, mean), rstd), gsc[k + 1]), gsc[kdim + k + 1]);
          *e = __floats2bfloat162_rn(y0, y1);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int kk = 16 * ks + 2 * tg;
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* r = as + (32 * wm + 16 * mi + g) * AS + kk;
        af[mi][0] = act::ld_u32(r);
        af[mi][1] = act::ld_u32(r + 8 * AS);
        af[mi][2] = act::ld_u32(r + 8);
        af[mi][3] = act::ld_u32(r + 8 * AS + 8);
      }
#pragma unroll
      for (int np = 0; np < T::NT8 / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        act::ldsm_x4_trans(b0, b1, b2, b3,
                           bs + (16 * ks + (lane & 15)) * T::BS + (BN / 2) * wn + 16 * np +
                               8 * (lane >> 4));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          act::mma_bf16(acc[mi][2 * np], af[mi], b0, b1);
          act::mma_bf16(acc[mi][2 * np + 1], af[mi], b2, b3);
        }
      }
    }
  }
  act::cp_wait<0>();

  // thread holds rows g (c0, c1) and g + 8 (c2, c3) of each m16 tile,
  // columns 2 tg, 2 tg + 1 of each n8 tile
  if (MODE == IN) {
    const float a1 = rbf(p.vecs[ndim]);  // vecs row 1: PReLU alpha (N = H)
    bf16* h1 = p.h1 + (size_t)b * p.f * ndim;
    float s = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int nt = 0; nt < T::NT8; ++nt) {
        const int col = n0 + (BN / 2) * wn + 8 * nt + 2 * tg;
        const float bx = rbf(p.vecs[col]), by = rbf(p.vecs[col + 1]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = m0 + 32 * wm + 16 * mi + g + 8 * hh;
          float v0 = rbf(__fadd_rn(rbf(acc[mi][nt][2 * hh]), bx));
          float v1 = rbf(__fadd_rn(rbf(acc[mi][nt][2 * hh + 1]), by));
          v0 = v0 >= 0.f ? v0 : rbf(__fmul_rn(a1, v0));
          v1 = v1 >= 0.f ? v1 : rbf(__fmul_rn(a1, v1));
          acc[mi][nt][2 * hh] = v0;
          acc[mi][nt][2 * hh + 1] = v1;
          if (r < fl) {
            *reinterpret_cast<__nv_bfloat162*>(h1 + (size_t)r * ndim + col) =
                __floats2bfloat162_rn(v0, v1);
            s += v0 + v1;
          }
        }
      }
    }
    const float cnt = (float)(min(BM, fl - m0) * BN);
    const float mu = block_sum(s, red) / cnt;
    float q = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < T::NT8; ++nt)
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
      for (int nt = 0; nt < T::NT8; ++nt) {
        const int col = n0 + (BN / 2) * wn + 8 * nt + 2 * tg;
        const bool res = col < c;
        const int cc = res ? col : col - c;
        const float bx = rbf(p.cvecs[(res ? 0 : c) + cc]);
        const float by = rbf(p.cvecs[(res ? 0 : c) + cc + 1]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = m0 + 32 * wm + 16 * mi + g + 8 * hh;
          if (r >= fl) continue;
          const size_t o = base + (size_t)r * c + cc;
          const float2 prev = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>((res ? p.x_in : p.skips) + o));
          const float u0 = rbf(__fadd_rn(rbf(acc[mi][nt][2 * hh]), bx));
          const float u1 = rbf(__fadd_rn(rbf(acc[mi][nt][2 * hh + 1]), by));
          *reinterpret_cast<__nv_bfloat162*>((res ? p.x_out : p.skips) + o) =
              __floats2bfloat162_rn(__fadd_rn(prev.x, u0), __fadd_rn(prev.y, u1));
        }
      }
    }
  }
}

// B at bf16: thread (row lane rl, column group cg) owns channels 4 cg .. + 3
// of rows r0 + rl + RL v, v < VPT, as dwconv_kernel
__global__ void __launch_bounds__(NT)
dwconv_kernel(const bf16* __restrict__ h1, const int* __restrict__ f_len,
              const bf16* __restrict__ w_dw, const float* __restrict__ vecs,
              const float* __restrict__ gln1, bf16* __restrict__ h2, Stats st, int f, int hd,
              int dil) {
  __shared__ float red[NW];
  const int b = blockIdx.y, fl = f_len[b];
  const int tpr = hd / 4, rl_n = NT / tpr, rb_rows = rl_n * VPT;
  const int r0 = blockIdx.x * rb_rows;
  if (r0 >= fl) return;
  const int tid = threadIdx.x, cg = tid % tpr, rl = tid / tpr, ch = 4 * cg;
  const float mean = gln1[4 * b], rstd = gln1[4 * b + 1];
  float g1[4], be1[4], bdw[4], tap[3][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    g1[j] = vecs[2 * hd + ch + j];
    be1[j] = vecs[3 * hd + ch + j];
    bdw[j] = rbf(vecs[4 * hd + ch + j]);
#pragma unroll
    for (int t = 0; t < 3; ++t) tap[t][j] = fb(w_dw[t * hd + ch + j]);
  }
  const float a2 = rbf(vecs[5 * hd]);
  const bf16* hb = h1 + (size_t)b * f * hd + ch;
  bf16* ob = h2 + (size_t)b * f * hd + ch;
  float val[VPT][4];
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int r = r0 + rl + rl_n * v;
#pragma unroll
    for (int j = 0; j < 4; ++j) val[v][j] = 0.f;
    if (r < fl) {
      float y[3][4];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int src = r + (t - 1) * dil;
        if (src >= 0 && src < fl) {  // gLN-1, rounded, then the mask: rows past f_len are 0
          const uint2 raw = *reinterpret_cast<const uint2*>(hb + (size_t)src * hd);
          const float in[4] = {act::lo_bf16(raw.x), act::hi_bf16(raw.x), act::lo_bf16(raw.y),
                               act::hi_bf16(raw.y)};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            y[t][j] = rbf(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(in[j], mean), rstd), g1[j]),
                                    be1[j]));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) y[t][j] = 0.f;
        }
      }
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float acc = __fadd_rn(__fadd_rn(__fmul_rn(y[0][j], tap[0][j]),
                                              __fmul_rn(y[2][j], tap[2][j])),
                                    __fmul_rn(y[1][j], tap[1][j]));
        float h = rbf(__fadd_rn(rbf(acc), bdw[j]));
        h = h >= 0.f ? h : rbf(__fmul_rn(a2, h));
        o[j] = h;
        val[v][j] = h;
      }
      uint2 packed;
      packed.x = act::pack_bf16(o[0], o[1]);
      packed.y = act::pack_bf16(o[2], o[3]);
      *reinterpret_cast<uint2*>(ob + (size_t)r * hd) = packed;
      s += (o[0] + o[1]) + (o[2] + o[3]);
    }
  }
  const float cnt = (float)(min(rb_rows, fl - r0) * hd);
  const float mu = block_sum(s, red) / cnt;
  float q = 0.f;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    if (r0 + rl + rl_n * v < fl) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = val[v][j] - mu;
        q = fmaf(d, d, q);
      }
    }
  }
  publish_stats(cnt, mu, block_sum(q, red), st, b, blockIdx.x, (fl + rb_rows - 1) / rb_rows);
}

// One block's int8 weights -> bf16 at its entry: w_in [C, H] (scales vecs
// row 8), w_dw [3, H] (row 9), [W_res | W_skip] [H, 2C] (cvecs rows 2, 3),
// one after another in out
__global__ void dequant_kernel(const int8_t* __restrict__ w_in, const int8_t* __restrict__ w_dw,
                               const int8_t* __restrict__ w_rs, const float* __restrict__ vecs,
                               const float* __restrict__ cvecs, bf16* __restrict__ out, int c,
                               int hd) {
  const int n_in = c * hd, n_dw = 3 * hd, n_rs = hd * 2 * c;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_in + n_dw + n_rs;
       i += gridDim.x * blockDim.x) {
    float q, sc;
    if (i < n_in) {
      q = (float)w_in[i];
      sc = vecs[8 * hd + i % hd];
    } else if (i < n_in + n_dw) {
      q = (float)w_dw[i - n_in];
      sc = vecs[9 * hd + (i - n_in) % hd];
    } else {
      const int j = i - n_in - n_dw;
      q = (float)w_rs[j];
      sc = cvecs[2 * c + j % (2 * c)];  // rows 2, 3: the scales of W_res, then W_skip
    }
    out[i] = rb(__fmul_rn(q, sc));
  }
}

template <int MODE, int BN>
std::atomic<uint64_t>& smem_cap_raised() {
  static std::atomic<uint64_t> raised{0};
  return raised;
}

template <int MODE, int BN>
cudaError_t launch_gemm_bn(const GemmArgs& p, int batch, cudaStream_t stream) {
  const cudaError_t e = act::allow_dynamic_smem(
      reinterpret_cast<const void*>(gemm_kernel<MODE, BN>), smem_cap_raised<MODE, BN>());
  if (e != cudaSuccess) return e;
  const dim3 grid(p.n / BN, (p.f + BM - 1) / BM, batch);
  gemm_kernel<MODE, BN><<<grid, NT, Tile<BN>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_gemm(const GemmArgs& p, int batch, int sms, cudaStream_t stream) {
  const long blocks128 = (long)((p.f + BM - 1) / BM) * batch * (p.n / 128);
  return p.n % 128 == 0 && blocks128 >= sms ? launch_gemm_bn<MODE, 128>(p, batch, stream)
                                            : launch_gemm_bn<MODE, 64>(p, batch, stream);
}

// The launches per TCN block at bf16; S8: the weights are the int8 stream,
// dequantised block by block into wdq (C H + 3 H + 2 H C bf16) first.
template <bool S8>
int run_masker(const bf16* x, const int* f_len, const void* w_in, const void* w_dw,
               const float* vecs, const void* w_rs, const float* cvecs, bf16* wdq, bf16* xs,
               bf16* h1, bf16* h2, float* stats, float* part, unsigned* tickets, bf16* skips,
               int batch, int f, int c, int hd, int n_blocks, int n_per_repeat, int n_part,
               cudaStream_t stream) {
  const int vrows = S8 ? 10 : 8, crows = S8 ? 4 : 2;
  if (c <= 0 || hd <= 0 || c % BK != 0 || hd % 64 != 0 || 1024 % hd != 0 || n_per_repeat <= 0)
    return (int)cudaErrorInvalidValue;
  const int rb_rows = (NT / (hd / 4)) * VPT;
  if (n_part < ((f + BM - 1) / BM) * (hd / 64) || n_part < (f + rb_rows - 1) / rb_rows)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = cudaMemsetAsync(skips, 0, sizeof(bf16) * (size_t)batch * f * c, stream)) != cudaSuccess)
    return (int)e;
  if (batch <= 0 || f <= 0 || n_blocks <= 0) return 0;
  if ((e = cudaMemsetAsync(tickets, 0, sizeof(unsigned) * batch, stream)) != cudaSuccess)
    return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const dim3 g_dw((f + rb_rows - 1) / rb_rows, batch);
  const bf16* cur = x;
  for (int i = 0; i < n_blocks; ++i) {
    const float* vv = vecs + (size_t)i * vrows * hd;
    const float* cv = cvecs + (size_t)i * crows * c;
    float* sti = stats + (size_t)i * batch * 4;
    const bf16 *wi, *wd, *wr;
    if (S8) {
      const size_t n_w = (size_t)c * hd + 3 * hd + (size_t)hd * 2 * c;
      dequant_kernel<<<(int)((n_w + NT - 1) / NT), NT, 0, stream>>>(
          static_cast<const int8_t*>(w_in) + (size_t)i * c * hd,
          static_cast<const int8_t*>(w_dw) + (size_t)i * 3 * hd,
          static_cast<const int8_t*>(w_rs) + (size_t)i * hd * 2 * c, vv, cv, wdq, c, hd);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      wi = wdq;
      wd = wdq + (size_t)c * hd;
      wr = wd + 3 * hd;
    } else {
      wi = static_cast<const bf16*>(w_in) + (size_t)i * c * hd;
      wd = static_cast<const bf16*>(w_dw) + (size_t)i * 3 * hd;
      wr = static_cast<const bf16*>(w_rs) + (size_t)i * hd * 2 * c;
    }
    GemmArgs pa{cur, f_len, wi, vv, cv, Stats{part, tickets, sti, n_part},
                nullptr, nullptr, nullptr, h1, f, c, hd, c};
    if ((e = launch_gemm<IN>(pa, batch, sms, stream)) != cudaSuccess) return (int)e;
    dwconv_kernel<<<g_dw, NT, 0, stream>>>(h1, f_len, wd, vv, sti, h2,
                                           Stats{part, tickets, sti + 2, n_part}, f, hd,
                                           1 << (i % n_per_repeat));
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    GemmArgs pc{h2, f_len, wr, vv, cv, Stats{part, tickets, sti, n_part}, cur, xs, skips,
                nullptr, f, hd, 2 * c, c};
    if ((e = launch_gemm<OUT>(pc, batch, sms, stream)) != cudaSuccess) return (int)e;
    cur = xs;
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
// float32; everything else as act_tcn_masker. Rows past f_len exactly 0.
extern "C" int act_tcn_masker_bf16(const act::bf16* x, const int* f_len, const act::bf16* w_in,
                                   const act::bf16* w_dw, const float* vecs,
                                   const act::bf16* w_rs, const float* cvecs, act::bf16* xs,
                                   act::bf16* h1, act::bf16* h2, float* stats, float* part,
                                   unsigned* tickets, act::bf16* skips, int batch, int f, int c,
                                   int hd, int n_blocks, int n_per_repeat, int n_part,
                                   cudaStream_t stream) {
  return b16::run_masker<false>(x, f_len, w_in, w_dw, vecs, w_rs, cvecs, nullptr, xs, h1, h2,
                                stats, part, tickets, skips, batch, f, c, hd, n_blocks,
                                n_per_repeat, n_part, stream);
}

// bfloat16 activations, the int8 weight stream (layouts as act_tcn_masker_s8);
// wdq: scratch of C H + 3 H + 2 H C bf16 for one block's dequantised weights.
extern "C" int act_tcn_masker_s8_bf16(const act::bf16* x, const int* f_len, const int8_t* w_in,
                                      const int8_t* w_dw, const float* vecs, const int8_t* w_rs,
                                      const float* cvecs, act::bf16* wdq, act::bf16* xs,
                                      act::bf16* h1, act::bf16* h2, float* stats, float* part,
                                      unsigned* tickets, act::bf16* skips, int batch, int f,
                                      int c, int hd, int n_blocks, int n_per_repeat, int n_part,
                                      cudaStream_t stream) {
  return b16::run_masker<true>(x, f_len, w_in, w_dw, vecs, w_rs, cvecs, wdq, xs, h1, h2, stats,
                               part, tickets, skips, batch, f, c, hd, n_blocks, n_per_repeat,
                               n_part, stream);
}
