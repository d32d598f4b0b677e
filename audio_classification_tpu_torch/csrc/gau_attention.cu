// K4 gau_attention: the gated-attention-unit scores of the MossFormer
// separator, out[b, i] = sum_j relu((q_i . k_j) * scale * mask_j)^2 v_j,
// forward only.
//
// Replaces audio_classification_tpu/ops/pallas/attention_kernel.py
// (gau_attention -> _gau_fwd_call, body _gau_kernel): q, k [B, T, Dqk] and
// v [B, T, De] f32, a multiplicative 0/1 key mask, no softmax state. The
// [T, T] score matrix never reaches device memory. Every query row is
// computed, padded rows included, as the TPU kernel does.
//
// Bound on the H100: operations. Over the valid keys the call does
// 2 T n_valid (Dqk + De) flops (3.44e11 at the main path's [1, 15999,
// 128 | 768] with 11999 keys valid). Float32 accuracy on the tensor cores
// costs three TF32 products per product (3xTF32, tf32_mma.cuh; one TF32
// product is 4-5e-4 of max|out| off in the CPU emulation, four times the
// tolerance), so the bound is the work over 495 / 3 TFLOP/s: 2.08 ms there.
// Warp-level mma.sync reaches 312.8 of the 495 TF32 TFLOP/s on an H100 SXM
// (scripts/mma_tf32_peak.py): a ceiling of 3.30 ms for this design.
//
// Design: mma.sync m16n8k8 TF32 in 3xTF32 with float32 accumulation, both
// products. A block of 8 warps owns BM = 64 query rows and one DC = 384-wide
// chunk of the De output columns; the two chunk blocks of a row block form a
// cluster of 2 (blockIdx.y 2c, 2c + 1; a chunk past De forms scores only),
// so the scores are formed once for all 768 columns. The keys go in tiles
// of BK = 32, each staged by 16-byte cp.async copies into a two-stage ring
// (keys past T zero-filled) one tile ahead of its use. Per key tile:
// 1. Scores: each block of the cluster forms the 64 x 16 scores of its half
//    of the tile's keys (warp w: rows 16 (w % 4) .. + 15 x one n8 tile of
//    keys) and stages only that half of K. q is split into big and small
//    once a block, in shared memory, in the mma's fragment order; k is
//    split in registers. The two halves of Dqk and the big x big and small
//    cross terms of each gather apart: 6 independent chains of 8 mma.
//    Then scale, mask and relu^2 in float32, in the TPU body's order
//    ((q.k) * scale * mask). p is written split into big and small, as the
//    A fragments of p v (the score fragment of a lane is its A fragment,
//    reordered), into this block's and, through distributed shared memory
//    (st.shared::cluster), the partner's double-buffered p.
// 2. p v: warp w owns rows 32 (w % 2) .. + 31 (2 m16 tiles) and columns
//    96 (w / 2) .. + 95 of the chunk (12 n8 tiles): 96 accumulator
//    registers. It holds the tile's p fragments (one 16-byte load each) and
//    walks its columns in groups of 2 pairs of n8 tiles, whose products over
//    the tile's 32 keys are formed from zero side by side (8 independent
//    chains of 12 mma) and added to the running accumulator in IEEE
//    float32, so the tensor cores' truncating sum never runs longer than a
//    tile.
// Iteration i forms p v of tile i and then the scores of tile i + 1 into
// the other p buffer, behind one cluster barrier an iteration.
// Where V is split: in registers, by the warp that reads it. Each staged V
// element is read by the 2 row-group warps of its columns: a tile costs
// 2 x 32 x 384 = 24576 splits a block (96 a thread, 3 operations each:
// split_fast leaves the small half for the mma to truncate). Splitting once
// in shared memory would halve that but double V's shared-memory reads and
// need a second 96 KB buffer, which does not fit beside the ring.
// Row strides 136 (k) and 388 (v) floats and the fragment-ordered q and p
// make every fragment load and p store free of bank conflicts. Shared
// memory: 64 KB q (big, small), 17 KB k ring, 97 KB v ring, 32 KB p, + one
// byte a key tile: 210 KB, one block an SM. Registers: 255 a thread, 16
// bytes spilled (nvcc -Xptxas -v through _build.build(verbose=True), which
// chip_smoke.py prints).
// Cost of the cluster: one cluster barrier a key tile, in place of a block
// barrier, and blocks of a chunk past De (De % 768 in (0, 384]) that only
// form scores. It saves the 1.14x operations of scores formed per chunk and
// half the K traffic. A 16-warp block (128 registers a thread) and
// per-chunk scores without the cluster were slower on the card.
// L2 traffic: every block re-reads its V chunk and half of K for all live
// tiles: n_valid (Dqk / 2 + DC) 4 bytes = 21.5 MB a block, 500 blocks,
// 10.8 GB a call at the main path's shape; the blocks of one wave walk the
// keys in step, so the working set stays in L2. TMA multicast of the V
// tiles to the blocks of neighbouring row blocks would cut it further.
// Masked keys contribute exactly 0 (relu(0)^2 = 0), so a key tile whose mask
// bytes are all 0 is skipped (a live-tile map filled in the prologue); a
// fully masked item computes no tile and writes zeros. The key loop thus
// ends at the item's last valid key.
// The SIMT design this replaces (IEEE f32 FMA, 64 rows x 384 columns a
// block, 8 x 12 accumulators a thread) took 12.66 ms at [1, 15999,
// 128 | 768] with 11999 keys valid and 0.349 ms at [3, 1237, 128 | 768]
// ragged (H100 80GB HBM3, 700 W; PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "attention_wgmma.cuh"  // the bf16 body (namespace b16)
#include "tf32_mma.cuh"

namespace {

constexpr int BM = 64;            // query rows a block
constexpr int BK = 32;            // keys a shared-memory tile
constexpr int DC = 384;           // output columns a block (one chunk of De)
constexpr int NW = 8;             // warps a block
constexpr int NT = NW * 32;       // threads a block
constexpr int CL = 2;             // blocks a cluster: two column chunks of one row block
constexpr int BKH = BK / CL;      // keys of a tile whose scores a block forms
constexpr int MAX_DQK = 128;
constexpr int QS = MAX_DQK + 8;   // row stride (floats) of a staged K tile
constexpr int VS = DC + 4;        // row stride of a staged V tile
constexpr int NS = 2;             // stages of the cp.async ring
constexpr int KSTEPS = BK / 8;    // k-steps of p v a tile
constexpr int WC = DC / 4;        // p v: columns a warp (warps as 2 x 32 rows by 4 x 96 columns)
constexpr int NP = WC / 16;       // pairs of n8 tiles a warp
constexpr int GP = 2;             // pairs whose products are formed side by side

// mma A fragments kept in shared memory in their register order: one
// 16-byte quad a lane for each m16 tile and k-step, so that one LDS.128
// fills an operand
constexpr int FRAG = 32 * 4;                                 // floats of one fragment
constexpr int QF = (BM / 16) * (MAX_DQK / 8) * FRAG;         // q: big, then small
constexpr int PF = (BM / 16) * (BK / 8) * FRAG;              // p: big, then small

using act::cp_async16;
using act::cp_commit;
using act::cp_wait;
using act::mma_tf32;
using act::split_fast;

constexpr size_t smem_bytes(int n_tiles) {
  return sizeof(float) * ((size_t)2 * QF + NS * BKH * QS + NS * BK * VS + 2 * 2 * PF + NS * BKH) +
         (size_t)n_tiles;  // + one byte a key tile
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void ld4u(uint32_t (&r)[4], const float* p) {
  const float4 x = ld4(p);
  r[0] = __float_as_uint(x.x);
  r[1] = __float_as_uint(x.y);
  r[2] = __float_as_uint(x.z);
  r[3] = __float_as_uint(x.w);
}

// mma fragments: g = lane / 4, tg = lane % 4 (thread in group)

// Scores of one key tile for the m16 tile of q whose fragments start at
// q_frag (big; small QF further; k-step stride FRAG) against one n8 tile of
// keys (from k_row, their 0/1 mask at mk); p = relu(s * scale * mask)^2 is
// parked split as the A fragments of p v, in this block's p buffer (p_frag:
// big; small PF further) and at the same place in its cluster partner's
// (p_far). Thread tg holds keys 2tg, 2tg + 1 of rows g (c0, c1) and g + 8
// (c2, c3), which are a0, a2, a1, a3 of the same lane's fragment for that
// n8 tile's k-step. The two halves of the MAX_DQK dims (those past Dqk are
// zeros) run side by side, and big x big and the two small cross terms of
// each half gather in their own accumulators: 6 independent chains of 8
// products, none of them long.
__device__ __forceinline__ void tile_scores(const float* q_frag, const float* k_row,
                                            const float* mk, float* p_frag, uint32_t p_far,
                                            float scale) {
  constexpr int HALF = MAX_DQK / 2;
  float bb[2][4], sb[2][4], bs[2][4];  // [half][c]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 4; ++i) bb[h][i] = sb[h][i] = bs[h][i] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < HALF / 8; ++kk) {
    uint32_t qb[2][4], qs[2][4], kb[2][2], ks[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = HALF * h + 8 * kk;
      ld4u(qb[h], q_frag + (d / 8) * FRAG);
      ld4u(qs[h], q_frag + QF + (d / 8) * FRAG);
      const float2 y = ld2(k_row + d);  // key g; dims d + 2tg, + 1
      split_fast(y.x, kb[h][0], ks[h][0]);
      split_fast(y.y, kb[h][1], ks[h][1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) mma_tf32(sb[h], qs[h], kb[h][0], kb[h][1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) mma_tf32(bs[h], qb[h], ks[h][0], ks[h][1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) mma_tf32(bb[h], qb[h], kb[h][0], kb[h][1]);
  }
  const float2 mm = ld2(mk);
  uint32_t big[4], small[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = (bb[0][i] + bb[1][i]) + ((sb[0][i] + bs[0][i]) + (sb[1][i] + bs[1][i]));
    const float x = fmaxf(s * scale * (i % 2 ? mm.y : mm.x), 0.f);
    split_fast(x * x, big[i], small[i]);
  }
  // C (c0, c1, c2, c3) -> A (a0, a1, a2, a3) = (c0, c2, c1, c3)
  const float4 pb = make_float4(__uint_as_float(big[0]), __uint_as_float(big[2]),
                                __uint_as_float(big[1]), __uint_as_float(big[3]));
  const float4 ps = make_float4(__uint_as_float(small[0]), __uint_as_float(small[2]),
                                __uint_as_float(small[1]), __uint_as_float(small[3]));
  *reinterpret_cast<float4*>(p_frag) = pb;
  *reinterpret_cast<float4*>(p_frag + PF) = ps;
  act::st_cluster(p_far, pb);
  act::st_cluster(p_far + 4 * PF, ps);
}

// acc += p v over one key tile for 2 m16 tiles of rows (p_frag: this
// lane's quad of the first one's k-step 0, big; small PF further) x WC
// columns (v_row: key 2tg, column 2g of the first pair). The p fragments of
// the tile's 4 k-steps are held; the pairs of n8 tiles go in groups of GP,
// whose 4 GP products over the tile's keys are formed from zero side by
// side (independent chains of 12 mma) and added to acc in IEEE float32, so
// that the tensor cores' truncating sum never runs longer than a tile.
__device__ __forceinline__ void tile_pv(float (&acc)[2][2 * NP][4], const float* p_frag,
                                        const float* v_row) {
  uint32_t pb[2][KSTEPS][4], ps[2][KSTEPS][4];  // [m16 tile][k-step][a]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const float* pr = p_frag + (mi * KSTEPS + kk) * FRAG;
      ld4u(pb[mi][kk], pr);
      ld4u(ps[mi][kk], pr + PF);
    }
  }
#pragma unroll
  for (int p0 = 0; p0 < NP; p0 += GP) {
    float tmp[GP][2][2][4];  // [pair][m16 tile][n8 tile of the pair][c]
#pragma unroll
    for (int pp = 0; pp < GP; ++pp) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) tmp[pp][mi][n][i] = 0.f;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      // keys 8kk + 2tg (b0) and + 1 (b1); columns 16p + 2g (n8 tile 2p)
      // and 16p + 2g + 1 (n8 tile 2p + 1)
      uint32_t vb[GP][2][2], vs[GP][2][2];
#pragma unroll
      for (int pp = 0; pp < GP; ++pp) {
        const float* vr = v_row + 8 * kk * VS + 16 * (p0 + pp);
        const float2 y0 = ld2(vr), y1 = ld2(vr + VS);
        split_fast(y0.x, vb[pp][0][0], vs[pp][0][0]);
        split_fast(y1.x, vb[pp][0][1], vs[pp][0][1]);
        split_fast(y0.y, vb[pp][1][0], vs[pp][1][0]);
        split_fast(y1.y, vb[pp][1][1], vs[pp][1][1]);
      }
#pragma unroll
      for (int pp = 0; pp < GP; ++pp) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_tf32(tmp[pp][mi][n], ps[mi][kk], vb[pp][n][0], vb[pp][n][1]);
          }
        }
      }
#pragma unroll
      for (int pp = 0; pp < GP; ++pp) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_tf32(tmp[pp][mi][n], pb[mi][kk], vs[pp][n][0], vs[pp][n][1]);
          }
        }
      }
#pragma unroll
      for (int pp = 0; pp < GP; ++pp) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_tf32(tmp[pp][mi][n], pb[mi][kk], vb[pp][n][0], vb[pp][n][1]);
          }
        }
      }
    }
#pragma unroll
    for (int pp = 0; pp < GP; ++pp) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mi][2 * (p0 + pp) + n][i] += tmp[pp][mi][n][i];
        }
      }
    }
  }
}

// A cluster is the CL = 2 blocks of one row block and item (blockIdx.y
// 2c, 2c + 1: column chunks; a chunk past De computes scores only)
__global__ void __cluster_dims__(1, CL, 1) __launch_bounds__(NT, 1)
gau_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
               float* __restrict__ out, int t, int dqk, int de, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [big, small][BM / 16][MAX_DQK / 8][32][4]
  float* k_s = q_s + 2 * QF;            // [NS][BKH][QS]: this block's half of the keys
  float* v_s = k_s + NS * BKH * QS;     // [NS][BK][VS]
  float* p_s = v_s + NS * BK * VS;      // [2][big, small][BM / 16][BK / 8][32][4]
  float* m_s = p_s + 2 * 2 * PF;        // [NS][BKH]: 1 valid key, 0 masked or past T
  uint8_t* live_s = reinterpret_cast<uint8_t*>(m_s + NS * BKH);  // [n_tiles]: holds a valid key

  const int b = blockIdx.z, c0 = blockIdx.y * DC, m0 = blockIdx.x * BM;
  const uint32_t rank = act::cluster_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const float* qh = q + (size_t)b * t * dqk;
  const float* kh = k + (size_t)b * t * dqk;
  const float* vh = v + (size_t)b * t * de + c0;
  const uint8_t* mrow = kv_mask ? kv_mask + (size_t)b * t : nullptr;
  const int dc = min(DC, de - c0);  // <= 0: scores for the partner only
  const int dq4 = dqk / 4;
  const int n_tiles = (t + BK - 1) / BK;
  const int kh0 = BKH * (int)rank;  // this block's keys of a tile: kh0 .. + BKH - 1

  // which key tiles hold a valid key: one thread per tile reads its mask
  // bytes, so the tile loop never waits on a scan. Both blocks of a cluster
  // read the same bytes and walk the same tiles
  if (mrow) {
    for (int tile = tid; tile < n_tiles; tile += NT) {
      const int j0 = tile * BK, n = min(BK, t - j0);
      int hit = 0;
#pragma unroll 8
      for (int j = 0; j < n; ++j) hit |= mrow[j0 + j];
      live_s[tile] = hit != 0;
    }
  }
  // dims dqk .. MAX_DQK of k are never copied: zeros, so that every tile
  // runs all MAX_DQK / 8 k-steps
  for (int i = tid; i < NS * BKH * (MAX_DQK - dqk) / 4; i += NT) {
    const int r = i / ((MAX_DQK - dqk) / 4), c = dqk + 4 * (i % ((MAX_DQK - dqk) / 4));
    *reinterpret_cast<float4*>(k_s + r * QS + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the block's query rows split once, in fragment order (zero past T and
  // past Dqk): fragment (mt, ks), lane (g', t'), element e holds row
  // 16 mt + g' + 8 (e % 2), dim 8 ks + 2 t' + e / 2
  for (int i = tid; i < BM * (MAX_DQK / 2); i += NT) {
    const int r = i / (MAX_DQK / 2), d = 2 * (i % (MAX_DQK / 2));
    float2 x = make_float2(0.f, 0.f);
    if (m0 + r < t && d < dqk) x = ld2(qh + (size_t)(m0 + r) * dqk + d);
    float* f = q_s + ((r / 16) * (MAX_DQK / 8) + d / 8) * FRAG + 4 * (4 * (r % 8) + (d % 8) / 2) +
               (r % 16) / 8;
    uint32_t b0, s0, b1, s1;
    split_fast(x.x, b0, s0);
    split_fast(x.y, b1, s1);
    f[0] = __uint_as_float(b0);  // e = 0 or 1: dim 2t'
    f[2] = __uint_as_float(b1);  // e = 2 or 3: dim 2t' + 1
    f[QF] = __uint_as_float(s0);
    f[QF + 2] = __uint_as_float(s1);
  }
  __syncthreads();  // publishes live_s, q and the zeroed dims

  // the first live tile at or after `tile` (the same for every thread)
  auto next_tile = [&](int tile) -> int {
    if (mrow) {
      while (tile < n_tiles && !live_s[tile]) ++tile;
    }
    return tile;
  };
  // queue this block's K rows and key mask (stage_k) or the V rows
  // (stage_v) of `tile` (n_tiles: nothing) into slot st; rows past T
  // zero-filled
  auto stage_k = [&](int tile, int st) {
    if (tile >= n_tiles) return;
    constexpr int TPR = NT / BKH;  // threads a row
    const int k0 = tile * BK + kh0, j = tid / TPR;
    const bool in = k0 + j < t;
    const float* src = kh + (size_t)(in ? k0 + j : 0) * dqk;
    for (int c = tid % TPR; c < dq4; c += TPR) {
      cp_async16(k_s + (st * BKH + j) * QS + 4 * c, src + 4 * c, in);
    }
    if (tid < BKH) {
      const int key = k0 + tid;
      m_s[st * BKH + tid] = (key < t && (!mrow || mrow[key])) ? 1.f : 0.f;
    }
  };
  auto stage_v = [&](int tile, int st) {
    if (tile >= n_tiles || dc <= 0) return;
    constexpr int TPR = NT / BK;
    const int k0 = tile * BK, j = tid / TPR;
    const bool in = k0 + j < t;
    const float* src = vh + (size_t)(in ? k0 + j : 0) * de;
#pragma unroll
    for (int i = 0; i < DC / 4 / TPR; ++i) {
      const int c = tid % TPR + TPR * i;
      const bool cin = in && 4 * c < dc;
      cp_async16(v_s + (st * BK + j) * VS + 4 * c, src + (cin ? 4 * c : 0), cin);
    }
  };

  // scores: m16 tile warp % 4 against keys kh0 + 8 (warp / 4) .. + 7 of a
  // tile, the k-step kh0 / 8 + warp / 4 of p v
  const float* q_frag = q_s + (warp % 4) * (MAX_DQK / 8) * FRAG + 4 * lane;
  const int k_off = (8 * (warp / 4) + g) * QS + 2 * tg, m_off = 8 * (warp / 4) + 2 * tg;
  const int ps_off = ((warp % 4) * KSTEPS + kh0 / 8 + warp / 4) * FRAG + 4 * lane;
  const uint32_t p_far = act::cluster_map(p_s + ps_off, rank ^ 1);  // the partner's p
  // p v: m16 tiles 2 (warp % 2), + 1 (rows prow .. + 31), columns pcol .. + 95
  const int prow = 32 * (warp % 2), pcol = WC * (warp / 2);
  const int pv_off = (prow / 16) * KSTEPS * FRAG + 4 * lane;
  const int v_off = 2 * tg * VS + pcol + 2 * g;

  float acc[2][2 * NP][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][n][i] = 0.f;
    }
  }

  // Software pipeline over the live tiles L0, L1, ...: iteration i forms
  // p v of L(i), then the scores of L(i + 1) for this block's half of its
  // keys, into both blocks' p buffer (i + 1) % 2. K, key mask and V of L(j)
  // sit in slot j % 2; the copies of iteration i (V of L(i + 1), K of
  // L(i + 2)) run under its products. One cluster barrier an iteration: the
  // partner's half of p has landed, and neither block still reads what the
  // other is about to overwrite. The prologue forms the scores of L(0).
  int cur = next_tile(0);
  int nxt = cur < n_tiles ? next_tile(cur + 1) : n_tiles;
  stage_k(cur, 0);
  stage_v(cur, 0);
  stage_k(nxt, 1);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  act::cluster_sync();  // both blocks run before either stores into the other
  if (cur < n_tiles) tile_scores(q_frag, k_s + k_off, m_s + m_off, p_s + ps_off, p_far, scale);

  for (int it = 0; cur < n_tiles; ++it) {
    const int st = it % 2;
    const int nxt2 = nxt < n_tiles ? next_tile(nxt + 1) : n_tiles;
    cp_wait<0>();
    __syncthreads();
    act::cluster_sync();  // V of L(i), K of L(i + 1) landed; p of L(i) parked by both
    stage_v(nxt, st ^ 1);
    stage_k(nxt2, st);
    cp_commit();
    if (dc > 0) tile_pv(acc, p_s + st * 2 * PF + pv_off, v_s + st * BK * VS + v_off);
    // past the last live tile this forms scores of a stale slot that no
    // p v reads
    tile_scores(q_frag, k_s + (st ^ 1) * BKH * QS + k_off, m_s + (st ^ 1) * BKH + m_off,
                p_s + (st ^ 1) * 2 * PF + ps_off, p_far + 4 * (st ^ 1) * 2 * PF, scale);
    cur = nxt;
    nxt = nxt2;
  }
  act::cluster_sync();  // the partner's last stores into this block have landed
  if (dc <= 0) return;

  // thread tg holds columns 16pp + 4tg .. + 3 of rows g and g + 8
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r0 = m0 + prow + 16 * mi + g, r1 = r0 + 8;
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) {
      const int col = pcol + 16 * pp + 4 * tg;
      if (col >= dc) continue;
      const float* a0 = acc[mi][2 * pp];
      const float* a1 = acc[mi][2 * pp + 1];
      if (r0 < t) {
        *reinterpret_cast<float4*>(out + ((size_t)b * t + r0) * de + c0 + col) =
            make_float4(a0[0], a1[0], a0[1], a1[1]);
      }
      if (r1 < t) {
        *reinterpret_cast<float4*>(out + ((size_t)b * t + r1) * de + c0 + col) =
            make_float4(a0[2], a1[2], a0[3], a1[3]);
      }
    }
  }
}

std::atomic<uint64_t> smem_cap_raised{0};  // the kernel's cap, raised once per device

// ---------------------------------------------------------------------------
// bfloat16 q, k, v: act_gau_attention_bf16, the JAX kernel at bf16
// (_gau_kernel, attention_kernel.py:320-343): s = (q . k) * scale in float32,
// s *= mask, p = relu(s)^2 in float32, p rounded to bf16 (p.astype(v.dtype)
// :337), out += p v in float32; the output is float32, every query row
// written. Replaces attention_kernel.py::gau_attention (:410) at bf16.
// Bound: 2 T n_valid (Dqk + De) flops over 989 TFLOP/s dense bf16: 0.348 ms
// at [1, 15999, 128 | 768] with 11999 keys valid; p v is 6/7 of it.
// Design: the wgmma pipeline of attention_wgmma.cuh (TMA ring of K and V
// tiles, the scores and p v on wgmma, p = bf16(relu(s scale m)^2) formed in
// registers as p v's A operand, the next tile's scores issued before this
// tile's p v). A block owns one chunk of at most 256 of the De columns
// (grid z): nc = ceil(De / 256) chunks of CW = ceil(De / nc) rounded up to
// 64 (De 768: 3 x 256; 384: 2 x 192; 192: 1 x 192), and forms its rows'
// scores itself. Why not once a row tile: a 64 x De float32 accumulator is
// De / 2 registers a thread of a warpgroup (384 at De 768), so one row
// tile's columns need three warpgroups at 256 (128 accumulators + 32 scores
// + 16 of p + addresses, ~200 registers a thread); three consumer and a
// producer warpgroup hold at most 160 a consumer thread even with
// setmaxnreg (65536 registers an SM), and p would have to reach the other
// two through shared memory every tile. Three chunks form the scores three
// times (1.29x the minimum work), but no warpgroup waits on another.
// L2 traffic: each K tile (16 KB) and V chunk tile (32 KB) feeds 64 rows a
// warpgroup; one warpgroup a block was bound by it (48 KB a tile, 0.86 ms).
// So a block is two consumer warpgroups of 64 rows on the same K / V ring
// (128 rows a tile), with a producer warpgroup whose registers go to them
// by setmaxnreg (232 a consumer thread: nine warps would cap every thread
// at 168, under the ~206 a 256-column warpgroup needs); one warpgroup and
// a producer warp where halving the blocks saves no round of the grid.
// Shared memory at CW 256: q 32 KB, 3 stages of K (16 KB) and V (32 KB), one
// block an SM. Masked keys add exactly 0 (relu(0)^2 = 0), so a key tile
// whose mask bytes are all 0 is skipped (a live-tile map in the prologue);
// a fully masked item computes no tile and writes zeros.
// Times (NVIDIA H100 80GB HBM3, 700.00 W; scripts/gau_attention_ab.py, graph
// replay): 0.60 ms at [1, 15999, 128 | 768] with 11999 keys valid (share
// 0.58; ~75% of the tensor peak on the 1.29x work), 0.37 at De 384, 0.027 at
// [3, 1237] ragged (0.023 with one warpgroup a block, which the plan cannot
// pick there: the masked item's blocks do no work); the mma.sync design
// this replaces took 2.90 / 1.48 / 0.087 (PERF.md).
namespace b16 {

using act::bf16;
namespace aw = act::attn;

// The plan of a call: consumer warpgroups a block, output columns a block
// (CW), the grid (row blocks, items, chunks). Two warpgroups (128 rows
// sharing each K / V tile) where halving the blocks saves a round of the
// card's 132 SMs, else one (measured, PERF.md: two win at [1,15999|768],
// [1,15999|192] and [1,4000|768], one at grids of a round or less)
struct Plan {
  int nwg, cols, gx, gy, gz;
};
inline Plan plan(int batch, int t, int de) {
  const int nc = (de + 255) / 256, cols = ((de + nc - 1) / nc + 63) / 64 * 64;
  const long long per_row = (long long)batch * nc;
  const long long rounds1 = ((t + 63) / 64 * per_row + 131) / 132;
  const long long rounds2 = ((t + 127) / 128 * per_row + 131) / 132;
  const int nwg = rounds2 < rounds1 ? 2 : 1;
  return Plan{nwg, cols, (t + 64 * nwg - 1) / (64 * nwg), batch, nc};
}

template <int ND, int DV, int NWG>
int launch_cfg(dim3 grid, const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
               const aw::Params& p, cudaStream_t stream, int* facts) {
  using C = aw::Cfg<ND, 4 * ND, DV, NWG>;
  if (facts) {
    facts[0] = C::THREADS;
    facts[1] = C::NS;
    facts[2] = (int)C::smem_bytes((p.tk + aw::BK - 1) / aw::BK);
    return 0;
  }
  return aw::launch<aw::RELU2, ND, 4 * ND, DV, NWG>(grid, mq, mk, mv, p, stream);
}

// the instance of a chunk width: q and K in one or two 64-wide boxes
// (Dqk <= 64 or above), one or two consumer warpgroups
template <int DV>
int launch_cols(bool wide_q, int nwg, dim3 grid, const CUtensorMap& mq, const CUtensorMap& mk,
                const CUtensorMap& mv, const aw::Params& p, cudaStream_t stream, int* facts) {
  if (nwg == 2) {
    return wide_q ? launch_cfg<2, DV, 2>(grid, mq, mk, mv, p, stream, facts)
                  : launch_cfg<1, DV, 2>(grid, mq, mk, mv, p, stream, facts);
  }
  return wide_q ? launch_cfg<2, DV, 1>(grid, mq, mk, mv, p, stream, facts)
                : launch_cfg<1, DV, 1>(grid, mq, mk, mv, p, stream, facts);
}

// The call (facts == null) or, into facts[3], the threads, stages and shared
// memory of the block it launches
inline int run(const bf16* q, const bf16* k, const bf16* v, const uint8_t* kv_mask, float* out,
               int batch, int t, int dqk, int de, float scale, cudaStream_t stream, int* facts) {
  const Plan pl = plan(batch, t, de);
  CUtensorMap mq, mk, mv;
  if (!facts) {
    cudaError_t e;
    if ((e = act::tmap_3d_bf16(&mq, q, dqk, t, batch, 64, 64)) != cudaSuccess ||
        (e = act::tmap_3d_bf16(&mk, k, dqk, t, batch, 64, 64)) != cudaSuccess ||
        (e = act::tmap_3d_bf16(&mv, v, de, t, batch, 64, 64)) != cudaSuccess)
      return (int)e;
  }
  const aw::Params p{kv_mask, out, nullptr, nullptr, 1, t, t, de, scale};
  const dim3 grid(pl.gx, pl.gy, pl.gz);
  const bool wide_q = dqk > 64;
  switch (pl.cols) {
    case 64: return launch_cols<64>(wide_q, pl.nwg, grid, mq, mk, mv, p, stream, facts);
    case 128: return launch_cols<128>(wide_q, pl.nwg, grid, mq, mk, mv, p, stream, facts);
    case 192: return launch_cols<192>(wide_q, pl.nwg, grid, mq, mk, mv, p, stream, facts);
    default: return launch_cols<256>(wide_q, pl.nwg, grid, mq, mk, mv, p, stream, facts);
  }
}

}  // namespace b16

}  // namespace

// q, k: [B, T, Dqk]; v, out: [B, T, De]; f32 contiguous, 16-byte aligned;
// kv_mask: [B, T] bytes (bool or uint8, tested against 0) or null. Dqk and
// De multiples of 4, Dqk <= 128.
extern "C" int act_gau_attention(const float* q, const float* k, const float* v,
                                 const uint8_t* kv_mask, float* out, int batch, int t,
                                 int dqk, int de, float scale, cudaStream_t stream) {
  if (dqk <= 0 || dqk > MAX_DQK || dqk % 4 || de <= 0 || de % 4) return (int)cudaErrorInvalidValue;
  if (t <= 0 || batch <= 0) return 0;
  const cudaError_t err =
      act::allow_dynamic_smem(reinterpret_cast<const void*>(gau_fwd_kernel), smem_cap_raised);
  if (err != cudaSuccess) return (int)err;
  // column chunks rounded up to whole clusters
  dim3 grid((t + BM - 1) / BM, CL * ((de + CL * DC - 1) / (CL * DC)), batch);
  gau_fwd_kernel<<<grid, NT, smem_bytes((t + BK - 1) / BK), stream>>>(q, k, v, kv_mask, out, t,
                                                                       dqk, de, scale);
  return (int)cudaGetLastError();
}

// bfloat16 q, k: [B, T, Dqk]; v: [B, T, De]; contiguous, 16-byte aligned;
// Dqk <= 128 and De multiples of 8; out [B, T, De] float32; kv_mask as
// act_gau_attention.
extern "C" int act_gau_attention_bf16(const act::bf16* q, const act::bf16* k,
                                      const act::bf16* v, const uint8_t* kv_mask, float* out,
                                      int batch, int t, int dqk, int de, float scale,
                                      cudaStream_t stream) {
  if (dqk <= 0 || dqk > MAX_DQK || dqk % 8 || de <= 0 || de % 8) return (int)cudaErrorInvalidValue;
  if (t <= 0 || batch <= 0) return 0;
  return b16::run(q, k, v, kv_mask, out, batch, t, dqk, de, scale, stream, nullptr);
}

// The plan of a bf16 call into out[8]: consumer warpgroups a block, output
// columns a block, grid x, y, z, threads a block, ring stages, dynamic
// shared memory bytes (ops/kernels/gau.bf16_plan computes the same on the
// host).
extern "C" int act_gau_attention_bf16_plan(int batch, int t, int dqk, int de, int* out) {
  if (dqk <= 0 || dqk > MAX_DQK || dqk % 8 || de <= 0 || de % 8) return (int)cudaErrorInvalidValue;
  const b16::Plan pl = b16::plan(batch, t, de);
  out[0] = pl.nwg;
  out[1] = pl.cols;
  out[2] = pl.gx;
  out[3] = pl.gy;
  out[4] = pl.gz;
  return b16::run(nullptr, nullptr, nullptr, nullptr, nullptr, batch, t, dqk, de, 0.f, nullptr,
                  out + 5);
}
