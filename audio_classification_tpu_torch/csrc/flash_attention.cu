// K3 flash_attention and K5 flash_attention_stats: masked non-causal
// multi-head attention as a streaming softmax, forward only. One templated
// kernel with two epilogues, as the TPU source has one body with two.
//
// Replaces audio_classification_tpu/ops/pallas/attention_kernel.py
// (flash_attention -> _flash_fwd_call(emit_stats=False) and
// flash_attention_stats -> _flash_fwd_call(emit_stats=True), body _kernel):
// s = q k^T * scale + key_bias (0 / -1e9 from kv_mask), running max m and
// sum l over key tiles. K3 (EMIT_STATS = false) writes out = acc / l. K5
// (EMIT_STATS = true) writes the unnormalised acc with the row's m and l:
// o = sum_k exp(s - m) v, m = max_k s, l = sum_k exp(s - m); the ring
// attention of parallel/ring_attention.py merges such triples of key blocks
// and divides once at the end. The queries (tq rows) and the keys (tk rows)
// have separate lengths: in the ring a shard's queries meet every other
// shard's keys. A key block that is masked whole gives m = -1e9 and l = its
// key count (every s rounds to -1e9 in float32), which the merge scales by
// exp(-1e9 - m_valid) = 0. bfloat16 q, k, v take entry points of their own
// (act_flash_attention_bf16, act_flash_attention_stats_bf16: namespace b16
// below, on the wgmma / TMA pipeline of attention_wgmma.cuh, with its design,
// bound and times).
//
// Bound on the H100: at D = 64 the two products (s = q k^T, acc += p v) are
// 4 T_q T_k D operations over O(T D) bytes, so the kernel is bound by
// operations. Float32 accuracy on the tensor cores costs three TF32 products
// per product (3xTF32: x = big + small, both exact in TF32; a b ~ a_big b_big
// + a_big b_small + a_small b_big, the dropped term below 2^-22 |a b|), so
// the bound is the work over 495 / 3 TFLOP/s; one TF32 product alone is
// 2-5e-4 off at these shapes, ten times K3's tolerance. Warp-level mma.sync
// reaches 313 of the 495 TF32 TFLOP/s on an H100 SXM (63%,
// scripts/mma_tf32_peak.py), which puts the ceiling of this design at
// 1.6x the bound.
// Head dim: D is a template parameter of the body, instantiated at 64
// (OSDNet, SenseVoice, the transducer and whisper-style encoders), 80
// (Paraformer: 320 / 4 heads) and 128; any multiple of 64 above 128 runs
// the wide body (flash_wide_kernel, below), which splits the output columns
// over the grid in slices of 128 and forms the scores over 64-wide slabs of
// D, so neither its registers nor its shared memory grow with D. Both C
// entry points dispatch on head_dim at run time and refuse any other D (the
// wrapper zero-pads D up to the next head dim they take, as the TPU kernel
// pads D to its lane width). At D = 64 and 80 q * scale lives in registers as
// big and small A fragments (233-240 registers a thread, no spills). At
// D = 128 the q fragments (128 registers) with the accumulators would spill
// (255 registers and 1152 bytes of spill stores and loads), so there q *
// scale is staged once into shared memory (16 rows a warp, stride D + 8)
// and split as it is loaded for each key tile (223 / 239 registers, no
// spills). At D = 80, q in shared memory measured 4-6% slower (PERF.md),
// so Dims<D>::Q_SMEM holds for D = 128 only.
// Design: mma.sync m16n8k8 TF32 with float32 accumulation. A block of 4
// warps owns 64 query rows, 16 a warp (2-warp blocks are 5-13% slower at
// every main-path shape, batch 1 included:
// scripts/flash_attention_ab.py --define ACT_FLASH_WARPS=2),
// and holds q * scale split into big and small A fragments (the scale 1/8
// of D = 64 is a power of two, so folding it changes no bit there).
// It walks the keys in tiles of 64 staged by 16-byte cp.async copies into a
// two-stage ring in shared memory, so the next tile's copy overlaps this
// tile's products; keys past tk are zero-filled. K and V fragments are split
// on their way out of shared memory by integer rounding (a raw float32 fed to
// a TF32 mma is truncated, not rounded). The tensor cores accumulate with
// truncation, so no truncating chain is left long: the small cross terms of
// s gather apart from its big x big chain, and each tile's p v is formed
// from zero and added to the running acc in IEEE float32 (with one long
// chain the error grew with T). The softmax runs on the
// accumulator fragment (FA2): each thread holds two rows' scores, the row
// max and sum meet across the quad by two shuffles. The score fragment's
// layout (thread t of a quad: keys 2t, 2t+1) is not the A layout of p v
// (keys t, t+4); instead of moving p across the quad, p v contracts over the
// keys in the order the scores already sit in, by reading V's rows 2t and
// 2t+1 where the A layout would read t and t+4. Row strides of 72 (K) and
// 68 (V) floats make every 8-byte fragment load free of bank conflicts.
// A key tile whose mask bytes are all 0 is skipped when its batch item has
// a valid key anywhere (exact: once a row has met a valid key a masked score
// adds exp(-1e9 - m) = 0, and a later valid key erases earlier masked ones
// through alpha = 0); an item with no valid key is computed over every tile,
// as the twin does. Keys past tk are excluded outright (score -inf), so such
// an item still gives l = tk.
// The SIMT design this replaces (four lanes a row, f32 FMA, no tensor cores,
// every tile computed) took 0.413 / 0.104 / 0.105 / 3.48 ms at [8,8,537],
// [1,8,537], [1,4,800] and [1,8,4271] with 3337 keys valid (H100 80GB HBM3,
// 700 W; PERF.md).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "attention_wgmma.cuh"  // the bf16 bodies (namespace b16)
#include "tf32_mma.cuh"

// warps a block, 16 query rows each. 4 in the library; the block-size
// probe (scripts/flash_attention_ab.py --define ACT_FLASH_WARPS=2) builds a
// copy with 2 to time beside it
#ifndef ACT_FLASH_WARPS
#define ACT_FLASH_WARPS 4
#endif

namespace {

constexpr int BK = 64;       // keys per shared-memory tile
constexpr int NS = 2;        // stages of the cp.async ring
constexpr int NW = ACT_FLASH_WARPS;
constexpr int NT = NW * 32;  // threads a block
constexpr int ROWS = 16 * NW;
constexpr float NEG_INIT = -1e30f;
constexpr float MASKED = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

using act::cp_async16;
using act::cp_commit;
using act::cp_wait;
using act::mma_tf32;
using act::split;

// per head dim D: row strides (floats) of a staged K tile, V tile and q
// block, and whether q * scale is staged in shared memory (at D = 128 only,
// the one instance whose q in registers spills: see the header)
template <int D>
struct Dims {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int KS = D + 8;
  static constexpr int VS = D + 4;
  static constexpr int QS = D + 8;
  static constexpr bool Q_SMEM = D >= 128;
  // dynamic shared memory of a launch over tk keys
  static size_t smem_bytes(int tk) {
    return sizeof(float) * (NS * BK * (KS + VS + 1) + (Q_SMEM ? ROWS * QS : 0)) +
           sizeof(int) * NS + (size_t)(tk + BK - 1) / BK;  // + one byte a key tile
  }
};

// Which key tiles hold a valid key, into live_s (one byte a tile): one
// thread per tile reads its mask bytes, so the block learns it in one round
// trip and the tile loop never waits on a scan. Returns whether masked tiles
// may be skipped, which they are only when the item has a valid key at all
// (the barrier also publishes live_s)
__device__ __forceinline__ bool mark_live_tiles(const uint8_t* mrow, int tk, int n_tiles,
                                                uint8_t* live_s, int tid) {
  int any = 0;
  if (mrow) {
    for (int tile = tid; tile < n_tiles; tile += NT) {
      const int j0 = tile * BK, n = min(BK, tk - j0);
      int hit = 0;
#pragma unroll 16
      for (int j = 0; j < n; ++j) hit |= mrow[j0 + j];
      live_s[tile] = hit != 0;
      any |= hit;
    }
  }
  return __syncthreads_or(any) != 0;
}

// the first tile at or after `tile` that is computed (the same for every
// thread, so control flow stays uniform across the block)
__device__ __forceinline__ int next_live(int tile, bool skip, int n_tiles,
                                         const uint8_t* live_s) {
  if (skip) {
    while (tile < n_tiles && !live_s[tile]) ++tile;
  }
  return tile;
}

// key j's score bias: 0, -1e9 where the mask holds 0, -inf past tk
__device__ __forceinline__ float key_bias(int j, int tk, const uint8_t* mrow) {
  return j >= tk ? -INFINITY : (mrow && !mrow[j] ? MASKED : 0.f);
}

// One computed key tile of a block's 16-row fragments, shared by both
// bodies: s holds the tile's scores of rows r0 (s[.][0..1]) and r1
// (s[.][2..3]) over its 64 keys; adds the key bias, updates the rows'
// running max m and sum l (this thread's part of l), and adds the tile's
// p v to acc over DN output columns read from the staged V tile (vt: the
// thread's first word in it, row stride VS). The tile's p v contracts over
// keys in the score fragment's own order and is gathered from zero, then
// added to the rescaled acc in IEEE float32: the tensor cores' truncating
// sum never runs longer than a tile
template <int DN, int VS>
__device__ __forceinline__ void tile_update(float (&s)[BK / 8][4], const float* bias,
                                            const float* vt, float (&acc)[DN / 8][4], float& m0,
                                            float& m1, float& l0, float& l1, int t) {
  // + key bias; the rows' tile max across the quad
  float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * nt + 2 * t);
    s[nt][0] += bb.x;
    s[nt][1] += bb.y;
    s[nt][2] += bb.x;
    s[nt][3] += bb.y;
    mt0 = fmaxf(mt0, fmaxf(s[nt][0], s[nt][1]));
    mt1 = fmaxf(mt1, fmaxf(s[nt][2], s[nt][3]));
  }
  mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, 1));
  mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, 2));
  mt1 = fmaxf(mt1, __shfl_xor_sync(FULL, mt1, 1));
  mt1 = fmaxf(mt1, __shfl_xor_sync(FULL, mt1, 2));
  const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
  const float alpha0 = __expf(m0 - mn0), alpha1 = __expf(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  l0 *= alpha0;
  l1 *= alpha1;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    s[nt][0] = __expf(s[nt][0] - mn0);
    s[nt][1] = __expf(s[nt][1] - mn0);
    s[nt][2] = __expf(s[nt][2] - mn1);
    s[nt][3] = __expf(s[nt][3] - mn1);
    l0 += s[nt][0] + s[nt][1];
    l1 += s[nt][2] + s[nt][3];
  }

  float pv[DN / 8][4];
#pragma unroll
  for (int n = 0; n < DN / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[n][i] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    uint32_t pb[4], ps[4];
    split(s[kk][0], pb[0], ps[0]);  // row r0, key 8kk + 2t
    split(s[kk][2], pb[1], ps[1]);  // row r1, key 8kk + 2t
    split(s[kk][1], pb[2], ps[2]);  // row r0, key 8kk + 2t + 1
    split(s[kk][3], pb[3], ps[3]);  // row r1, key 8kk + 2t + 1
    uint32_t vb[DN / 8][2], vs[DN / 8][2];
#pragma unroll
    for (int p = 0; p < DN / 16; ++p) {
      const float2 x0 = *reinterpret_cast<const float2*>(vt + 8 * kk * VS + 16 * p);
      const float2 x1 = *reinterpret_cast<const float2*>(vt + (8 * kk + 1) * VS + 16 * p);
      split(x0.x, vb[2 * p][0], vs[2 * p][0]);
      split(x1.x, vb[2 * p][1], vs[2 * p][1]);
      split(x0.y, vb[2 * p + 1][0], vs[2 * p + 1][0]);
      split(x1.y, vb[2 * p + 1][1], vs[2 * p + 1][1]);
    }
#pragma unroll
    for (int n = 0; n < DN / 8; ++n) mma_tf32(pv[n], ps, vb[n][0], vb[n][1]);
#pragma unroll
    for (int n = 0; n < DN / 8; ++n) mma_tf32(pv[n], pb, vs[n][0], vs[n][1]);
#pragma unroll
    for (int n = 0; n < DN / 8; ++n) mma_tf32(pv[n], pb, vb[n][0], vb[n][1]);
  }
#pragma unroll
  for (int n = 0; n < DN / 8; ++n) {
    acc[n][0] = fmaf(acc[n][0], alpha0, pv[n][0]);
    acc[n][1] = fmaf(acc[n][1], alpha0, pv[n][1]);
    acc[n][2] = fmaf(acc[n][2], alpha1, pv[n][2]);
    acc[n][3] = fmaf(acc[n][3], alpha1, pv[n][3]);
  }
}

// The epilogue of both bodies: l summed across the quad, then rows r0 and r1
// of out (row stride `stride` floats, from row `row_base`) written at
// columns c0 + [0, dv) from acc's first dv columns (K3 divided by l), and,
// for K5 where `stats`, the rows' m and l
template <bool EMIT_STATS, int DN>
__device__ __forceinline__ void store_rows(const float (&acc)[DN / 8][4], float m0, float m1,
                                           float l0, float l1, float* out, float* m_out,
                                           float* l_out, size_t row_base, int tq, int r0, int r1,
                                           int t, int stride, int c0, int dv, bool stats) {
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float inv0 = EMIT_STATS ? 1.f : 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = EMIT_STATS ? 1.f : 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int p = 0; p < DN / 16; ++p) {
    const int d = 16 * p + 4 * t;
    if (d >= dv) continue;
    if (r0 < tq) {
      *reinterpret_cast<float4*>(out + (row_base + r0) * stride + c0 + d) =
          make_float4(acc[2 * p][0] * inv0, acc[2 * p + 1][0] * inv0, acc[2 * p][1] * inv0,
                      acc[2 * p + 1][1] * inv0);
    }
    if (r1 < tq) {
      *reinterpret_cast<float4*>(out + (row_base + r1) * stride + c0 + d) =
          make_float4(acc[2 * p][2] * inv1, acc[2 * p + 1][2] * inv1, acc[2 * p][3] * inv1,
                      acc[2 * p + 1][3] * inv1);
    }
  }
  if (EMIT_STATS && stats && t == 0) {  // the four threads of a quad hold the same m and l
    if (r0 < tq) {
      m_out[row_base + r0] = m0;
      l_out[row_base + r0] = l0;
    }
    if (r1 < tq) {
      m_out[row_base + r1] = m1;
      l_out[row_base + r1] = l1;
    }
  }
}

// mma fragments (g = lane / 4, t = lane % 4). The contraction index of each
// product is permuted so that every operand a thread needs sits in two
// neighbouring floats:
//   s = q k^T, k-step kk: the mma's k = t and t + 4 are dims 8kk + 2t and
//     8kk + 2t + 1; A = q rows g, g + 8; B = k row (key) 8nt + g.
//   acc += p v, k-step kk: k = t and t + 4 are keys 8kk + 2t and 8kk + 2t + 1,
//     exactly the two score columns thread t holds in its C fragment; the
//     n-tiles 2p and 2p + 1 hold dims 16p + 2n and 16p + 2n + 1, so thread t
//     ends with dims 16p + 4t .. 16p + 4t + 3 of its rows.
template <int D, bool EMIT_STATS>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                 float* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int heads, int tq, int tk, float scale) {
  constexpr int KS = Dims<D>::KS, VS = Dims<D>::VS, QS = Dims<D>::QS;
  constexpr bool Q_SMEM = Dims<D>::Q_SMEM;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                    // [NS][BK][KS]
  float* v_s = k_s + NS * BK * KS;      // [NS][BK][VS]
  float* q_s = v_s + NS * BK * VS;      // [ROWS][QS] q * scale (Q_SMEM only)
  float* bias_s = q_s + (Q_SMEM ? ROWS * QS : 0);  // [NS][BK]: 0, -1e9 (masked) or -inf (past tk)
  int* tile_s = reinterpret_cast<int*>(bias_s + NS * BK);  // [NS]: first key, -1 if empty
  uint8_t* live_s = reinterpret_cast<uint8_t*>(tile_s + NS);  // [n_tiles]: holds a valid key

  const int bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * ROWS + 16 * warp + g, r1 = r0 + 8;
  const float* qh = q + (size_t)bh * tq * D;
  const float* kh = k + (size_t)bh * tk * D;
  const float* vh = v + (size_t)bh * tk * D;
  const uint8_t* mrow = kv_mask ? kv_mask + (size_t)(bh / heads) * tk : nullptr;
  const int n_tiles = (tk + BK - 1) / BK;

  const bool skip = mark_live_tiles(mrow, tk, n_tiles, live_s, tid);
  auto next_tile = [&](int tile) -> int { return next_live(tile, skip, n_tiles, live_s); };
  // stage `tile` (n_tiles: nothing) into ring slot st; one commit group
  auto stage = [&](int tile, int st) {
    if (tile < n_tiles) {
      const int k0 = tile * BK;
      for (int c = tid; c < BK * D / 4; c += NT) {
        const int j = c / (D / 4), d = 4 * (c % (D / 4));
        const bool in = k0 + j < tk;
        const size_t off = (size_t)(in ? k0 + j : 0) * D + d;
        cp_async16(k_s + (st * BK + j) * KS + d, kh + off, in);
        cp_async16(v_s + (st * BK + j) * VS + d, vh + off, in);
      }
      if (tid < BK) {
        const int j = k0 + tid;
        bias_s[st * BK + tid] = key_bias(j, tk, mrow);
      }
    }
    if (tid == 0) tile_s[st] = tile < n_tiles ? tile * BK : -1;
    cp_commit();
  };

  int fetch = next_tile(0);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    stage(fetch, s);
    fetch = fetch < n_tiles ? next_tile(fetch + 1) : n_tiles;
  }

  // q * scale as A fragments [k-step][a0..a3]: split once into registers,
  // or (Q_SMEM) staged raw into this warp's 16 rows of q_s and split from
  // there at each key tile (q_frag)
  uint32_t qb[Q_SMEM ? 1 : D / 8][4], qs[Q_SMEM ? 1 : D / 8][4];
  const float* q_w = q_s + 16 * warp * QS + g * QS + 2 * t;  // rows g, g + 8 at word 2t
  if constexpr (Q_SMEM) {
    const int row0 = blockIdx.x * ROWS + 16 * warp;
    for (int c = lane; c < 16 * D / 4; c += 32) {
      const int r = c / (D / 4), d = 4 * (c % (D / 4));
      float4 x = row0 + r < tq
                     ? *reinterpret_cast<const float4*>(qh + (size_t)(row0 + r) * D + d)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
      *reinterpret_cast<float4*>(q_s + (16 * warp + r) * QS + d) = x;
    }
    __syncwarp();  // a warp reads its own rows alone
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int d = 8 * kk + 2 * t;
      const float2 x0 = r0 < tq ? *reinterpret_cast<const float2*>(qh + (size_t)r0 * D + d)
                                : make_float2(0.f, 0.f);
      const float2 x1 = r1 < tq ? *reinterpret_cast<const float2*>(qh + (size_t)r1 * D + d)
                                : make_float2(0.f, 0.f);
      split(x0.x * scale, qb[kk][0], qs[kk][0]);
      split(x1.x * scale, qb[kk][1], qs[kk][1]);
      split(x0.y * scale, qb[kk][2], qs[kk][2]);
      split(x1.y * scale, qb[kk][3], qs[kk][3]);
    }
  }
  // k-step kk's big and small q fragments
  auto q_frag = [&](int kk, uint32_t (&big)[4], uint32_t (&small)[4]) {
    if constexpr (Q_SMEM) {
      const float2 x0 = *reinterpret_cast<const float2*>(q_w + 8 * kk);
      const float2 x1 = *reinterpret_cast<const float2*>(q_w + 8 * QS + 8 * kk);
      split(x0.x, big[0], small[0]);
      split(x1.x, big[1], small[1]);
      split(x0.y, big[2], small[2]);
      split(x1.y, big[3], small[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        big[i] = qb[kk][i];
        small[i] = qs[kk][i];
      }
    }
  };

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INIT, m1 = NEG_INIT, l0 = 0.f, l1 = 0.f;  // rows r0, r1 (l: this thread's part)

  for (int it = 0;; ++it) {
    cp_wait<NS - 2>();
    __syncthreads();  // tile `it` landed; the slot refilled below is consumed
    const int st = it % NS;
    if (tile_s[st] < 0) break;
    stage(fetch, (it + NS - 1) % NS);
    fetch = fetch < n_tiles ? next_tile(fetch + 1) : n_tiles;

    // s = (q * scale) k^T over the tile's 64 keys: [n-tile of 8 keys][c0..c3].
    // The tensor cores accumulate with truncation, so the two small cross
    // terms gather in s_lo, apart from the big x big chain, and join it once.
    // k-step outer, n-tile inner: eight independent chains in flight
    const float* kt = k_s + st * BK * KS + g * KS + 2 * t;
    float s[BK / 8][4], s_lo[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = s_lo[nt][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t qbk[4], qsk[4];
      q_frag(kk, qbk, qsk);
      uint32_t kb[BK / 8][2], ks[BK / 8][2];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const float2 b = *reinterpret_cast<const float2*>(kt + 8 * nt * KS + 8 * kk);
        split(b.x, kb[nt][0], ks[nt][0]);
        split(b.y, kb[nt][1], ks[nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) mma_tf32(s_lo[nt], qsk, kb[nt][0], kb[nt][1]);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) mma_tf32(s[nt], qbk, kb[nt][0], kb[nt][1]);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) mma_tf32(s_lo[nt], qbk, ks[nt][0], ks[nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] += s_lo[nt][i];
    }

    const float* vt = v_s + st * BK * VS + 2 * t * VS + 2 * g;
    tile_update<D, VS>(s, bias_s + st * BK, vt, acc, m0, m1, l0, l1, t);
  }

  store_rows<EMIT_STATS, D>(acc, m0, m1, l0, l1, out, m_out, l_out, (size_t)bh * tq, tq, r0, r1,
                            t, D, 0, D, true);
}

// The wide body, for any head dim above 128 (the wrapper zero-pads D to dp,
// a multiple of SLAB). Block (x, y, z) owns 64 query rows of head y and the
// output columns [128 z, 128 z + 128) of dp. It forms the full-D scores of
// each computed key tile from dp / SLAB units, each unit a SLAB-wide slab of
// the tile's k and of the block's q staged by cp.async through the same
// two-stage ring (q is read again for every key tile: its bytes match k's,
// and neither q nor k of any D need fit in shared memory at once). The
// slab's scores are gathered from zero and added to the tile's s in IEEE
// float32, so no truncating tensor-core chain runs past one slab. With the
// second unit of a tile its V column slice [64 keys][128] and its key bias
// come in, into one slot: the previous tile's p v ran in the unit before
// the first (dp / SLAB >= 3 above 128, so the slice lands a unit before its
// use). After the last slab the tile's softmax update and p v run on
// tile_update as in the body above. One V slot keeps a block at 108 KB of
// shared memory, so two blocks fit on an SM. The scores are formed once for each
// column slice, ceil(dp / 128) times a key tile, in the same order in every
// slice, so every slice holds the same m and l: slice 0 writes them (K5).
// A slice narrower than 128 (dp % 128 == 64) computes p v over 128 columns,
// the 64 past dp zero-filled, and stores its own.
constexpr int SLAB = 64;   // dims of q and k in a staged unit
constexpr int DV = 128;    // output columns a block owns

struct Wide {
  static constexpr int QS = SLAB + 8;  // row strides (floats) of the staged q and k slabs
  static constexpr int KS = SLAB + 8;
  static constexpr int VS = DV + 4;    // of the staged V column slice
  static size_t smem_bytes(int tk) {
    return sizeof(float) * (NS * (ROWS * QS + BK * KS) + BK * VS + BK) + sizeof(int) * NS +
           (size_t)(tk + BK - 1) / BK;  // + one byte a key tile
  }
};

template <bool EMIT_STATS>
__global__ void __launch_bounds__(NT)
flash_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                  float* __restrict__ out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int heads, int tq, int tk, int dp, float scale) {
  constexpr int QS = Wide::QS, KS = Wide::KS, VS = Wide::VS;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [NS][ROWS][QS]: a unit's q slab
  float* k_s = q_s + NS * ROWS * QS;    // [NS][BK][KS]: a unit's k slab
  float* v_s = k_s + NS * BK * KS;      // [BK][VS]: the current key tile's V column slice
  float* bias_s = v_s + BK * VS;        // [BK]: its key bias
  int* tile_s = reinterpret_cast<int*>(bias_s + BK);  // [NS] a unit's tile, -1: the end
  uint8_t* live_s = reinterpret_cast<uint8_t*>(tile_s + NS);  // [n_tiles]: holds a valid key

  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * DV, dv = min(DV, dp - c0);  // this block's output columns
  const int n_slabs = dp / SLAB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * ROWS;
  const int r0 = row0 + 16 * warp + g, r1 = r0 + 8;
  const float* qh = q + (size_t)bh * tq * dp;
  const float* kh = k + (size_t)bh * tk * dp;
  const float* vh = v + (size_t)bh * tk * dp;
  const uint8_t* mrow = kv_mask ? kv_mask + (size_t)(bh / heads) * tk : nullptr;
  const int n_tiles = (tk + BK - 1) / BK;

  const bool skip = mark_live_tiles(mrow, tk, n_tiles, live_s, tid);
  // the next unit to stage: slab f_slab of key tile f_tile
  int f_tile = next_live(0, skip, n_tiles, live_s), f_slab = 0;
  // stage the next unit into ring slot st and advance; one commit group
  auto stage = [&](int st) {
    if (f_tile < n_tiles) {
      const int k0 = f_tile * BK, d0 = f_slab * SLAB;
      for (int c = tid; c < BK * SLAB / 4; c += NT) {
        const int j = c / (SLAB / 4), d = 4 * (c % (SLAB / 4));
        const bool in = k0 + j < tk;
        cp_async16(k_s + (st * BK + j) * KS + d, kh + (size_t)(in ? k0 + j : 0) * dp + d0 + d,
                   in);
      }
      for (int c = tid; c < ROWS * SLAB / 4; c += NT) {
        const int r = c / (SLAB / 4), d = 4 * (c % (SLAB / 4));
        const bool in = row0 + r < tq;
        cp_async16(q_s + (st * ROWS + r) * QS + d,
                   qh + (size_t)(in ? row0 + r : 0) * dp + d0 + d, in);
      }
      if (f_slab == 1) {
        for (int c = tid; c < BK * DV / 4; c += NT) {
          const int j = c / (DV / 4), d = 4 * (c % (DV / 4));
          const bool in = k0 + j < tk && d < dv;
          cp_async16(v_s + j * VS + d, vh + (in ? (size_t)(k0 + j) * dp + c0 + d : 0), in);
        }
        if (tid < BK) bias_s[tid] = key_bias(k0 + tid, tk, mrow);
      }
    }
    if (tid == 0) tile_s[st] = f_tile < n_tiles ? f_tile * BK : -1;
    cp_commit();
    if (f_tile < n_tiles && ++f_slab == n_slabs) {
      f_slab = 0;
      f_tile = next_live(f_tile + 1, skip, n_tiles, live_s);
    }
  };
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) stage(st);

  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INIT, m1 = NEG_INIT, l0 = 0.f, l1 = 0.f;  // rows r0, r1 (l: this thread's part)
  float s[BK / 8][4], s_lo[BK / 8][4];  // the current key tile's scores

  for (int u = 0;; ++u) {
    cp_wait<NS - 2>();
    __syncthreads();  // unit `u` landed; the slot refilled below is consumed
    const int st = u % NS;
    if (tile_s[st] < 0) break;
    stage((u + NS - 1) % NS);
    const int slab = u % n_slabs;
    if (slab == 0) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = s_lo[nt][i] = 0.f;
      }
    }

    // this slab's part of (q * scale) k^T, q split as it is read; the small
    // cross terms gather in s_lo over the whole tile, as in the body above
    const float* kt = k_s + st * BK * KS + g * KS + 2 * t;
    const float* qw = q_s + (st * ROWS + 16 * warp + g) * QS + 2 * t;  // rows g, g + 8
    float sb[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sb[nt][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < SLAB / 8; ++kk) {
      uint32_t qbk[4], qsk[4];
      const float2 x0 = *reinterpret_cast<const float2*>(qw + 8 * kk);
      const float2 x1 = *reinterpret_cast<const float2*>(qw + 8 * QS + 8 * kk);
      split(x0.x * scale, qbk[0], qsk[0]);
      split(x1.x * scale, qbk[1], qsk[1]);
      split(x0.y * scale, qbk[2], qsk[2]);
      split(x1.y * scale, qbk[3], qsk[3]);
      uint32_t kb[BK / 8][2], ks[BK / 8][2];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const float2 b = *reinterpret_cast<const float2*>(kt + 8 * nt * KS + 8 * kk);
        split(b.x, kb[nt][0], ks[nt][0]);
        split(b.y, kb[nt][1], ks[nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) mma_tf32(s_lo[nt], qsk, kb[nt][0], kb[nt][1]);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) mma_tf32(sb[nt], qbk, kb[nt][0], kb[nt][1]);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) mma_tf32(s_lo[nt], qbk, ks[nt][0], ks[nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] += sb[nt][i];
    }
    if (slab + 1 < n_slabs) continue;

#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] += s_lo[nt][i];
    }
    tile_update<DV, VS>(s, bias_s, v_s + 2 * t * VS + 2 * g, acc, m0, m1, l0, l1, t);
  }

  store_rows<EMIT_STATS, DV>(acc, m0, m1, l0, l1, out, m_out, l_out, (size_t)bh * tq, tq, r0, r1,
                             t, dp, c0, dv, blockIdx.z == 0);
}

// the kernel's shared-memory cap, raised once per device (tf32_mma.cuh)
template <int D, bool EMIT_STATS>
std::atomic<uint64_t> smem_cap_raised{0};

template <int D, bool EMIT_STATS>
int launch(const float* q, const float* k, const float* v, const uint8_t* kv_mask, float* out,
           float* m_out, float* l_out, int batch, int heads, int tq, int tk, float scale,
           cudaStream_t stream) {
  if (tq <= 0 || batch <= 0) return 0;
  const cudaError_t err =
      act::allow_dynamic_smem(reinterpret_cast<const void*>(flash_fwd_kernel<D, EMIT_STATS>),
                              smem_cap_raised<D, EMIT_STATS>);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + ROWS - 1) / ROWS, batch * heads);
  flash_fwd_kernel<D, EMIT_STATS><<<grid, NT, Dims<D>::smem_bytes(tk), stream>>>(
      q, k, v, kv_mask, out, m_out, l_out, heads, tq, tk, scale);
  return (int)cudaGetLastError();
}

template <bool EMIT_STATS>
std::atomic<uint64_t> wide_cap_raised{0};

template <bool EMIT_STATS>
int launch_wide(const float* q, const float* k, const float* v, const uint8_t* kv_mask, float* out,
                float* m_out, float* l_out, int batch, int heads, int tq, int tk, int dp,
                float scale, cudaStream_t stream) {
  if (tq <= 0 || batch <= 0) return 0;
  const cudaError_t err = act::allow_dynamic_smem(
      reinterpret_cast<const void*>(flash_wide_kernel<EMIT_STATS>), wide_cap_raised<EMIT_STATS>);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + ROWS - 1) / ROWS, batch * heads, (dp + DV - 1) / DV);
  flash_wide_kernel<EMIT_STATS><<<grid, NT, Wide::smem_bytes(tk), stream>>>(
      q, k, v, kv_mask, out, m_out, l_out, heads, tq, tk, dp, scale);
  return (int)cudaGetLastError();
}

// the instance for head_dim. This switch owns the set of head dims the
// kernels take: the body's instances and, above 128, every multiple of SLAB
// for the wide body (ops/kernels/attention.py's HEAD_DIMS and WIDE_SLAB
// mirror it, and a card test holds them equal); any other D is refused,
// empty calls too
template <bool EMIT_STATS>
int dispatch(const float* q, const float* k, const float* v, const uint8_t* kv_mask, float* out,
             float* m_out, float* l_out, int batch, int heads, int tq, int tk, int head_dim,
             float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<64, EMIT_STATS>(q, k, v, kv_mask, out, m_out, l_out, batch, heads, tq, tk,
                                    scale, stream);
    case 80:
      return launch<80, EMIT_STATS>(q, k, v, kv_mask, out, m_out, l_out, batch, heads, tq, tk,
                                    scale, stream);
    case 128:
      return launch<128, EMIT_STATS>(q, k, v, kv_mask, out, m_out, l_out, batch, heads, tq, tk,
                                     scale, stream);
    default:
      if (head_dim > 128 && head_dim % SLAB == 0) {
        return launch_wide<EMIT_STATS>(q, k, v, kv_mask, out, m_out, l_out, batch, heads, tq, tk,
                                       head_dim, scale, stream);
      }
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 q, k, v: act_flash_attention_bf16 (K3) and
// act_flash_attention_stats_bf16 (K5), the JAX body _kernel at bf16
// (attention_kernel.py:64-113; flash_attention :268, flash_attention_stats
// :293): s = (q . k) accumulated in float32 (each bf16 product is exact in
// float32), then * scale (1 / sqrt of the true D) and + the key bias, in
// float32; m, l and alpha in float32, l summed from the unrounded p; p =
// exp(s - m) rounded to bfloat16 (p.astype(v.dtype) :99) before p v, which
// accumulates in float32; a float32 output (the out_shape :129-130). p is
// rounded against the running max of 64-key tiles, so the result depends on
// the tile width: 64 keys, the twin's block_k on the card
// (ops/kernels/attention.attention_reference_lowp), and keys are never
// split across blocks.
// Bound: 4 Tq Tk_valid D flops over 989 TFLOP/s dense bf16, the Tq Tk_valid
// exponentials at 16 per SM per clock, or the bytes: 0.0295 ms (operations)
// at [1,8,4271,64] with 3337 keys valid.
// Design: the wgmma pipeline of attention_wgmma.cuh (a producer warp feeding
// K and V tiles by TMA, both products on wgmma, p in registers as p v's A
// operand; see its header). Head dims 64, 80, 128, 192 and 256 are
// instances whose p v is one wgmma of N = D (D = 80: its 160-byte rows take
// two 64-wide boxes, the second zero-filled by TMA past column 80, and the
// scores run 5 k16 steps); a 64 x D float32 accumulator is 128 registers a
// thread at D = 256. Above 256 it no longer fits: the wide body (below)
// splits the output columns into slices of at most 256 over grid z and
// forms the scores once a slice, q and K streamed in 64-wide boxes. A block
// is one consumer warpgroup of 64 rows (plan(), mirrored by
// ops/kernels/attention.bf16_plan; two an SM at D = 64): two warpgroups on
// one K / V ring were slower at every shape (0.194 against 0.153 ms at
// [1,8,4271,64]), and registers sized for three blocks an SM timed the same.
// What bounds a tile is the softmax's issue slots: the IEEE-accurate expf
// the function keeps (as the twin's exp) is ~8 instructions an element.
// Times (NVIDIA H100 80GB HBM3, 700.00 W; scripts/flash_attention_ab.py
// --bf16, graph replay): K3 0.155 ms at [1,8,4271,64] (SDPA at bf16 0.22),
// 0.029 at [8,8,537,64] ragged (SDPA 0.075), 0.011-0.015 at the small
// shapes (SDPA 0.017-0.026); above SDPA only at [2,4,300,40] (1.2x) and
// [2,4,300,200] (1.02x), where the wrapper's zero-pad copies are 6 of the
// call's 7 device ops. K5 0.024 at [1,8,1068,64]. The mma.sync design this
// replaces took 0.2445 / 0.032 / 0.017-0.048 and K5 0.039 (PERF.md).
namespace b16 {

using act::bf16;
namespace aw = act::attn;

constexpr int WNS = 4;               // stages of the wide body's ring
constexpr int WSLOT = 4 * aw::BOX;   // a stage: two q boxes and two K boxes, or a V slice

// The plan of a call (D = the padded head dim): output columns a block (D,
// or a wide body's slice of at most 256, rounded up to 64) and the grid (a
// block a 64-row tile of an item and a slice)
struct Plan {
  int cols, gx, gy, gz;
};
inline Plan plan(int batch, int heads, int tq, int d) {
  const int n_sl = (d + 255) / 256, cols = d <= 256 ? d : ((d + n_sl - 1) / n_sl + 63) / 64 * 64;
  return Plan{cols, (tq + 63) / 64, batch * heads, d <= 256 ? 1 : n_sl};
}

// The wide body, for head dims above 256 (multiples of 64): one consumer
// warpgroup of 64 rows and one producer warp; block (x, y, z) owns output
// columns [z cols, z cols + cols) of item y. For each live key tile the
// producer streams the scores' units (two 64-wide boxes of q and of K a
// stage; at an odd D / 64 the last unit's second boxes lie past D and are
// zero-filled, so every unit is the same 8 k16 steps and the consumer's
// products take one path) and then the tile's V slice with its key bias; the
// consumer sums the scores over the units, then runs the softmax and p v as
// the narrow body does, without the overlap. Every slice forms the same scores in the same
// order, so slice 0 writes K5's m and l.
template <bool EMIT_STATS, int CW>
__global__ void __launch_bounds__(160, 1)
    wide_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const aw::Params p) {
  constexpr int MODE = EMIT_STATS ? aw::STATS : aw::SOFTMAX;
  constexpr int NV = CW / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = act::smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t ring = act::smem_u32(base);
  float* coef = reinterpret_cast<float*>(base + WNS * WSLOT);     // [WNS][BK]
  uint64_t* bars = reinterpret_cast<uint64_t*>(coef + WNS * aw::BK);
  uint8_t* live = reinterpret_cast<uint8_t*>(bars + 2 * WNS);
  const uint32_t full = act::smem_u32(bars), empty = full + 8 * WNS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int item = blockIdx.y, row0 = blockIdx.x * 64, c0 = blockIdx.z * CW;
  const int nd = p.out_cols / 64, n_units = (nd + 1) / 2;
  const uint8_t* mrow = p.mask ? p.mask + (size_t)(item / p.heads) * p.tk : nullptr;
  const int n_tiles = (p.tk + aw::BK - 1) / aw::BK;
  if (tid == 0) {
    for (int s = 0; s < WNS; ++s) {
      act::mbar_init(full + 8 * s, 32);
      act::mbar_init(empty + 8 * s, 4);
    }
    act::mbar_fence_init();
  }
  const bool skip = aw::mark_live<MODE>(mrow, p.tk, n_tiles, live);

  if (warp == 4) {  // the producer warp
    if (lane == 0) {
      act::tma_prefetch_map(&mq);
      act::tma_prefetch_map(&mk);
      act::tma_prefetch_map(&mv);
    }
    int s = 0;
    uint32_t ph = 0;
    auto advance = [&]() {
      if (++s == WNS) {
        s = 0;
        ph ^= 1;
      }
    };
    for (int tile = aw::next_live(0, skip, n_tiles, live); tile < n_tiles;
         tile = aw::next_live(tile + 1, skip, n_tiles, live)) {
      for (int u = 0; u < n_units; ++u) {
        act::mbar_wait(empty + 8 * s, ph ^ 1);
        if (lane == 0) {
          const uint32_t st = ring + s * WSLOT, bar = full + 8 * s;
          act::mbar_arrive_expect_tx(bar, WSLOT);
#pragma unroll
          for (int c = 0; c < 2; ++c) {  // past D (an odd D / 64): zero-filled
            act::tma_load_3d(st + c * aw::BOX, &mq, bar, 64 * (2 * u + c), row0, item);
            act::tma_load_3d(st + (2 + c) * aw::BOX, &mk, bar, 64 * (2 * u + c),
                             tile * aw::BK, item);
          }
        } else {
          act::mbar_arrive(full + 8 * s);
        }
        advance();
      }
      act::mbar_wait(empty + 8 * s, ph ^ 1);
      const int j = tile * aw::BK + 2 * lane;
      *reinterpret_cast<float2*>(coef + s * aw::BK + 2 * lane) =
          make_float2(aw::key_coef<MODE>(j, p.tk, mrow), aw::key_coef<MODE>(j + 1, p.tk, mrow));
      if (lane == 0) {
        const uint32_t st = ring + s * WSLOT, bar = full + 8 * s;
        act::mbar_arrive_expect_tx(bar, NV * aw::BOX);
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          act::tma_load_3d(st + c * aw::BOX, &mv, bar, c0 + 64 * c, tile * aw::BK, item);
        }
      } else {
        act::mbar_arrive(full + 8 * s);
      }
      advance();
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + 16 * warp + g, r1 = r0 + 8;
  float o[CW / 2];
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) o[i] = 0.f;
  float m0 = aw::NEG_INIT, m1 = aw::NEG_INIT, l0 = 0.f, l1 = 0.f;
  float s[32];
  uint32_t pa[16];
  int st = 0;
  uint32_t ph = 0;
  auto release = [&]() {  // this warp is done with stage st
    __syncwarp();
    if (lane == 0) act::mbar_arrive(empty + 8 * st);
    if (++st == WNS) {
      st = 0;
      ph ^= 1;
    }
  };
  for (int tile = aw::next_live(0, skip, n_tiles, live); tile < n_tiles;
       tile = aw::next_live(tile + 1, skip, n_tiles, live)) {
    for (int u = 0; u < n_units; ++u) {
      act::mbar_wait(full + 8 * st, ph);
      const uint32_t sa = ring + st * WSLOT;
      act::fence_operands(s);
      act::wgmma_fence();
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          act::wgmma_ss<64, 0>(s, act::desc_sw128(sa + c * aw::BOX + 32 * ks, 16, 1024),
                               act::desc_sw128(sa + (2 + c) * aw::BOX + 32 * ks, 16, 1024),
                               u > 0 || c > 0 || ks > 0);
        }
      }
      act::wgmma_commit();
      act::wgmma_wait<0>();
      act::fence_operands(s);
      release();
    }
    act::mbar_wait(full + 8 * st, ph);
    float al0, al1;
    aw::softmax_tile(s, coef + st * aw::BK, p.scale, t, m0, m1, l0, l1, al0, al1);
    aw::pack_p(s, pa);
    aw::rescale(o, al0, al1);
    aw::issue_pv<CW>(o, pa, ring + st * WSLOT);
    act::wgmma_wait<0>();
    act::fence_operands(o);
    act::fence_regs(pa);
    release();
  }
  aw::store_rows<MODE, CW / 2>(o, m0, m1, l0, l1, p, (size_t)item * p.tq, r0, r1, c0, t,
                               blockIdx.z == 0);
}

template <bool EMIT_STATS, int CW>
int launch_wide(dim3 grid, const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                const aw::Params& p, cudaStream_t stream) {
  static std::atomic<uint64_t> raised{0};
  const auto kernel = wide_kernel<EMIT_STATS, CW>;
  const cudaError_t e = act::allow_dynamic_smem(reinterpret_cast<const void*>(kernel), raised);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = 1024 + (size_t)WNS * WSLOT + sizeof(float) * WNS * aw::BK +
                      sizeof(uint64_t) * 2 * WNS + (size_t)(p.tk + aw::BK - 1) / aw::BK;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  kernel<<<grid, 160, smem, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

// threads, stages and dynamic shared memory of the block a plan launches
template <int ND, int KS, int DV, int NWG>
void block_facts(int n_tiles, int* out) {
  using C = aw::Cfg<ND, KS, DV, NWG>;
  out[0] = C::THREADS;
  out[1] = C::NS;
  out[2] = (int)C::smem_bytes(n_tiles);
}
inline int plan_facts(int d, int tk, int* out) {
  const int n_tiles = (tk + aw::BK - 1) / aw::BK;
  switch (d) {
    case 64: block_facts<1, 4, 64, 1>(n_tiles, out); return 0;
    case 80: block_facts<2, 5, 80, 1>(n_tiles, out); return 0;
    case 128: block_facts<2, 8, 128, 1>(n_tiles, out); return 0;
    case 192: block_facts<3, 12, 192, 1>(n_tiles, out); return 0;
    case 256: block_facts<4, 16, 256, 1>(n_tiles, out); return 0;
    default:
      out[0] = 160;
      out[1] = WNS;
      out[2] = (int)(1024 + (size_t)WNS * WSLOT + sizeof(float) * WNS * aw::BK +
                     sizeof(uint64_t) * 2 * WNS + (size_t)n_tiles);
      return 0;
  }
}

// the same set of head dims as the float32 dispatch above: 64, 80, 128 and
// every multiple of 64 above 128
template <bool EMIT_STATS>
int dispatch(const bf16* q, const bf16* k, const bf16* v, const uint8_t* kv_mask, float* out,
             float* m_out, float* l_out, int batch, int heads, int tq, int tk, int d, float scale,
             cudaStream_t stream) {
  constexpr int MODE = EMIT_STATS ? aw::STATS : aw::SOFTMAX;
  if (!(d == 64 || d == 80 || d == 128 || (d > 128 && d % 64 == 0)))
    return (int)cudaErrorInvalidValue;
  if (tq <= 0 || batch <= 0 || heads <= 0) return 0;
  const int items = batch * heads;
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = act::tmap_3d_bf16(&mq, q, d, tq, items, 64, 64)) != cudaSuccess ||
      (e = act::tmap_3d_bf16(&mk, k, d, tk, items, 64, 64)) != cudaSuccess ||
      (e = act::tmap_3d_bf16(&mv, v, d, tk, items, 64, 64)) != cudaSuccess)
    return (int)e;
  const aw::Params p{kv_mask, out, m_out, l_out, heads, tq, tk, d, scale};
  const Plan pl = plan(batch, heads, tq, d);
  const dim3 grid(pl.gx, pl.gy, pl.gz);
  switch (d) {
    case 64:
      return aw::launch<MODE, 1, 4, 64, 1>(grid, mq, mk, mv, p, stream);
    case 80:
      return aw::launch<MODE, 2, 5, 80, 1>(grid, mq, mk, mv, p, stream);
    case 128:
      return aw::launch<MODE, 2, 8, 128, 1>(grid, mq, mk, mv, p, stream);
    case 192:
      return aw::launch<MODE, 3, 12, 192, 1>(grid, mq, mk, mv, p, stream);
    case 256:
      return aw::launch<MODE, 4, 16, 256, 1>(grid, mq, mk, mv, p, stream);
    default:
      return pl.cols == 192 ? launch_wide<EMIT_STATS, 192>(grid, mq, mk, mv, p, stream)
                            : launch_wide<EMIT_STATS, 256>(grid, mq, mk, mv, p, stream);
  }
}

}  // namespace b16

}  // namespace

// K3. q, k, v, out: [B, H, T, D] f32 contiguous, D = head_dim in {64, 80,
// 128} or a multiple of 64 above 128; kv_mask: [B, T] uint8 or null.
extern "C" int act_flash_attention(const float* q, const float* k, const float* v,
                                   const uint8_t* kv_mask, float* out, int batch, int heads,
                                   int t, int head_dim, float scale, cudaStream_t stream) {
  return dispatch<false>(q, k, v, kv_mask, out, nullptr, nullptr, batch, heads, t, t, head_dim,
                         scale, stream);
}

// K5. q, out: [B, H, Tq, D]; k, v: [B, H, Tk, D]; m_out, l_out: [B, H, Tq];
// all f32 contiguous, D = head_dim as for K3; kv_mask: [B, Tk] uint8 or
// null. Tk >= 1.
extern "C" int act_flash_attention_stats(const float* q, const float* k, const float* v,
                                         const uint8_t* kv_mask, float* out, float* m_out,
                                         float* l_out, int batch, int heads, int tq, int tk,
                                         int head_dim, float scale, cudaStream_t stream) {
  if (tk <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, k, v, kv_mask, out, m_out, l_out, batch, heads, tq, tk, head_dim,
                        scale, stream);
}

// K3 at bfloat16. q, k, v: [B, H, T, D] bf16 contiguous, 16-byte aligned;
// out: [B, H, T, D] f32; D = head_dim as for K3; kv_mask as for K3.
extern "C" int act_flash_attention_bf16(const act::bf16* q, const act::bf16* k,
                                        const act::bf16* v, const uint8_t* kv_mask, float* out,
                                        int batch, int heads, int t, int head_dim, float scale,
                                        cudaStream_t stream) {
  return b16::dispatch<false>(q, k, v, kv_mask, out, nullptr, nullptr, batch, heads, t, t,
                              head_dim, scale, stream);
}

// K5 at bfloat16. q: [B, H, Tq, D], k, v: [B, H, Tk, D] bf16 contiguous,
// 16-byte aligned; out [B, H, Tq, D], m_out, l_out [B, H, Tq] f32; D and
// kv_mask as for K5. Tk >= 1.
extern "C" int act_flash_attention_stats_bf16(const act::bf16* q, const act::bf16* k,
                                              const act::bf16* v, const uint8_t* kv_mask,
                                              float* out, float* m_out, float* l_out, int batch,
                                              int heads, int tq, int tk, int head_dim,
                                              float scale, cudaStream_t stream) {
  if (tk <= 0) return (int)cudaErrorInvalidValue;
  return b16::dispatch<true>(q, k, v, kv_mask, out, m_out, l_out, batch, heads, tq, tk,
                             head_dim, scale, stream);
}

// The plan of a bf16 K3 / K5 call at head dim head_dim (as the entry points
// take it: 64, 80, 128 or a multiple of 64 above 128) into out[7]: output
// columns a block, grid x, y, z, threads a block, ring stages, dynamic
// shared memory bytes (ops/kernels/attention.bf16_plan computes the same on
// the host).
extern "C" int act_flash_attention_bf16_plan(int batch, int heads, int tq, int tk, int head_dim,
                                             int* out) {
  if (!(head_dim == 64 || head_dim == 80 || head_dim == 128 ||
        (head_dim > 128 && head_dim % 64 == 0)))
    return (int)cudaErrorInvalidValue;
  const b16::Plan pl = b16::plan(batch, heads, tq, head_dim);
  out[0] = pl.cols;
  out[1] = pl.gx;
  out[2] = pl.gy;
  out[3] = pl.gz;
  return b16::plan_facts(head_dim, tk, out + 4);
}
