// The bf16 attention pipeline on Hopper, shared by K3 / K5 at bf16
// (flash_attention.cu, namespace b16) and K4 at bf16 (gau_attention.cu,
// namespace b16), with the parts the float32 bodies (namespaces t32) take
// from it: the key coefficients, the live-tile map, the softmax, the
// epilogue and the split launch (tf32_split, at the end). s = q k^T on
// wgmma, an elementwise map of the scores into p in registers (the
// streaming softmax, or relu^2), p rounded to bf16 as the register A operand
// of p v on wgmma; K and V tiles of 64 keys arrive by TMA into a ring of
// stages guarded by mbarriers.
//
// A block is NWG consumer warpgroups of 64 query rows each and a producer
// warp (a producer warpgroup at NWG = 2, whose registers go to the
// consumers by setmaxnreg). The producer loads the block's q rows once
// ({64 d, 64 rows} boxes, 128-byte swizzle), then, for each live key tile in
// order, the tile's K ([key][d], ND boxes) and V columns ([key][column],
// DV / 64 boxes, from the block's first column) into the next stage, with
// the tile's 64 per-key coefficients (the softmax's key bias 0 / -1e9 /
// -inf past Tk, or K4's 0 / 1 mask) written beside them by its 32 lanes.
// The maps are 3-D [items, T, D], so the zero fill stops at T and never
// reads the next item's rows; a box past the last column is zero-filled too.
// Each consumer warpgroup walks the same tiles in FA3's order: the scores of
// tile j + 1 are issued (A = q, B = the K tile as it lies: K-major, no
// transpose), then p v of tile j (A = p_j from registers, B = the V tile as
// it lies: MN-major); while p v runs, the scores of tile j + 1 are mapped
// into p_{j+1} in float32, rounded to bf16 once p v is done; the stage of
// tile j is handed back then. The m64n64 score accumulator of a warp (rows
// g, g + 8 of its 16, keys 8 j + 2 t, + 1) is, pair by pair, the m16n8k16 A
// fragment of p v's k16 step s = j / 2, so p never leaves the registers.
// ptxas serializes every wgmma of a kernel (its -v report: "wgmma.mma_async
// instructions are serialized", C7513 / C7514) when a register that a
// running wgmma reads or writes is touched before the wait that retires it,
// or when a wait's commit group depends on the path: the loop below has one
// path and writes p's A fragments only after p v's wait. Serialized, the
// first versions ran 1.45x (K4) and 1.06-1.09x (K3) slower (PERF.md).
// No sum crosses a block, so two calls give identical bits.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"  // act::allow_dynamic_smem, act::split
#include "wgmma_tma.cuh"

namespace act {
namespace attn {

enum Mode { SOFTMAX = 0, STATS = 1, RELU2 = 2 };  // K3, K5, K4

constexpr int BK = 64;          // keys a tile (the softmax's key-block width)
constexpr int BOX = 64 * 128;   // bytes of a {64, 64} bf16 box, 128-byte swizzled
constexpr int SMEM_CAP = 224 * 1024;
constexpr float NEG_INIT = -1e30f;
constexpr float MASKED = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

// What a launch needs besides its tensor maps. Rows of q and of out are
// item-major: item y (blockIdx.y: b * heads + h for K3 / K5, b for K4) owns
// rows y * tq ..; its mask row is y / heads.
struct Params {
  const uint8_t* mask;  // [items / heads, tk] bytes or null
  float* out;           // [items * tq, out_cols] float32
  float* m_out;         // K5: [items * tq]
  float* l_out;
  int heads, tq, tk;
  int out_cols;         // columns of out: the head dim (K3 / K5) or De (K4)
  float scale;
};

// The block's shape: NWG consumer warpgroups, ND boxes of q and K (the
// scores' depth, KS k16 steps of it computed), DV columns of p v a block
// (DV / 64 boxes of V, rounded up), NS stages. One consumer warpgroup takes
// a producer warp; two take a producer warpgroup, whose registers go to
// them (setmaxnreg: 232 a consumer thread, where nine warps would cap every
// thread at 168).
template <int ND, int KS, int DV, int NWG>
struct Cfg {
  static_assert(KS <= 4 * ND && DV % 16 == 0 && DV <= 256, "attention tile");
  static_assert(NWG == 1 || NWG == 2, "attention tile: one or two consumer warpgroups");
  static constexpr int NV = (DV + 63) / 64;
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + (NWG == 2 ? 128 : 32);
  static constexpr int Q_BYTES = NWG * ND * BOX;
  static constexpr int SLOT = (ND + NV) * BOX;
  static constexpr int NS_FIT = (SMEM_CAP - Q_BYTES - 4096) / SLOT;
  static constexpr int NS = NS_FIT > 4 ? 4 : NS_FIT;  // stages of the ring
  static_assert(NS >= 2, "attention tile: two stages must fit");
  // dynamic shared memory of a launch over n_tiles key tiles: 1024 of
  // alignment slack, q, the ring, the coefficients, the barriers, the
  // live-tile map
  static size_t smem_bytes(int n_tiles) {
    return 1024 + (size_t)Q_BYTES + (size_t)NS * SLOT + sizeof(float) * NS * BK +
           sizeof(uint64_t) * (2 * NS + 1) + (size_t)n_tiles;
  }
};

// key j's coefficient: the softmax's bias (0, -1e9 where the mask holds 0,
// -inf past tk) or K4's multiplier (1, 0 where masked or past tk)
template <int MODE>
__device__ __forceinline__ float key_coef(int j, int tk, const uint8_t* mrow) {
  if constexpr (MODE == RELU2) {
    return j < tk && (mrow == nullptr || mrow[j]) ? 1.f : 0.f;
  } else {
    return j >= tk ? -INFINITY : (mrow && !mrow[j] ? MASKED : 0.f);
  }
}

// Which key tiles (of TILE keys) hold a valid key, into live (one byte a
// tile), by every thread of the block; returns whether dead tiles are
// skipped: always in K4 (a masked key adds exactly 0), and in K3 / K5 only
// when the item has a valid key at all (an item without one is computed
// over every tile, as the twin does). The barrier also publishes live.
template <int MODE, int TILE = BK>
__device__ __forceinline__ bool mark_live(const uint8_t* mrow, int tk, int n_tiles, uint8_t* live) {
  int any = 0;
  for (int tile = threadIdx.x; tile < n_tiles; tile += blockDim.x) {
    int hit = 1;
    if (mrow) {
      const int j0 = tile * TILE, n = min(TILE, tk - j0);
      hit = 0;
#pragma unroll 16
      for (int j = 0; j < n; ++j) hit |= mrow[j0 + j];
    }
    live[tile] = hit != 0;
    any |= hit;
  }
  any = __syncthreads_or(any);
  return MODE == RELU2 || any != 0;
}

__device__ __forceinline__ int next_live(int tile, bool skip, int n_tiles, const uint8_t* live) {
  if (skip) {
    while (tile < n_tiles && !live[tile]) ++tile;
  }
  return tile;
}

// s = q k^T of one key tile over KS k16 steps: A = this warpgroup's q rows
// (qa), B = the K tile (ka), both K-major {64, 64} boxes one after another
// along d; issued and committed, not waited for
template <int KS>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t qa, uint32_t ka) {
  fence_operands(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint32_t off = (ks >> 2) * BOX + (ks & 3) * 32;
    wgmma_ss<64, 0>(s, desc_sw128(qa + off, 16, 1024), desc_sw128(ka + off, 16, 1024), ks > 0);
  }
  wgmma_commit();
}

// o += p v over the tile's 64 keys: A = p (k16 step kk in pa[4 kk .. + 3]),
// B = the V tile at va ([key][column] boxes of 64 columns, MN-major); issued
// and committed, not waited for
template <int DV>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2], const uint32_t (&pa)[16],
                                         uint32_t va) {
  fence_operands(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t(&a)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&pa[4 * kk]);
    wgmma_rs<DV>(o, a, desc_sw128(va + 2048 * kk, BOX, 1024), 1);
  }
  wgmma_commit();
}

// The streaming softmax of one key tile of 2 R keys on this thread's scores
// (rows g: s[4 j], s[4 j + 1]; g + 8: s[4 j + 2], s[4 j + 3]; keys 8 j + 2 t,
// + 1), in place: s = s * scale + bias in float32, the rows' tile max across
// the quad, the running max m, alpha = exp(m_prev - m), p = exp(s - m) into
// s, l = alpha l + the sum of the unrounded p (this thread's part): the
// twin's rounding points (attention.attention_stats_reference_lowp). expf is
// IEEE-accurate, as the twin's exp: an approximation would move p across
// bf16 rounding boundaries more often.
template <int R>
__device__ __forceinline__ void softmax_tile(float (&s)[R], const float* bias, float scale,
                                             int t, float& m0, float& m1, float& l0, float& l1,
                                             float& al0, float& al1) {
  float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
    s[4 * j] = __fadd_rn(__fmul_rn(s[4 * j], scale), bb.x);
    s[4 * j + 1] = __fadd_rn(__fmul_rn(s[4 * j + 1], scale), bb.y);
    s[4 * j + 2] = __fadd_rn(__fmul_rn(s[4 * j + 2], scale), bb.x);
    s[4 * j + 3] = __fadd_rn(__fmul_rn(s[4 * j + 3], scale), bb.y);
    mt0 = fmaxf(mt0, fmaxf(s[4 * j], s[4 * j + 1]));
    mt1 = fmaxf(mt1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, 1));
  mt0 = fmaxf(mt0, __shfl_xor_sync(FULL, mt0, 2));
  mt1 = fmaxf(mt1, __shfl_xor_sync(FULL, mt1, 1));
  mt1 = fmaxf(mt1, __shfl_xor_sync(FULL, mt1, 2));
  const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
  al0 = expf(m0 - mn0);
  al1 = expf(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  l0 *= al0;
  l1 *= al1;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    s[4 * j] = expf(s[4 * j] - mn0);
    s[4 * j + 1] = expf(s[4 * j + 1] - mn0);
    s[4 * j + 2] = expf(s[4 * j + 2] - mn1);
    s[4 * j + 3] = expf(s[4 * j + 3] - mn1);
    l0 += s[4 * j] + s[4 * j + 1];
    l1 += s[4 * j + 2] + s[4 * j + 3];
  }
}

// K4's map of one key tile, in place: p = relu(s * scale * mask)^2 with the
// TPU body's IEEE single operations in its order (no contraction)
__device__ __forceinline__ void relu2_tile(float (&s)[32], const float* coef, float scale, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 mm = *reinterpret_cast<const float2*>(coef + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = fmaxf(__fmul_rn(__fmul_rn(s[4 * j + e], scale), e & 1 ? mm.y : mm.x), 0.f);
      s[4 * j + e] = __fmul_rn(x, x);
    }
  }
}

// p (floats in the score layout) rounded to bf16 as p v's A fragments: k16
// step kk from the pairs of j = 2 kk (a0: row g, a1: row g + 8) and
// j = 2 kk + 1 (a2, a3), as p.astype(v.dtype) rounds it
__device__ __forceinline__ void pack_p(const float (&p)[32], uint32_t (&pa)[16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[4 * kk] = pack_bf16(p[8 * kk], p[8 * kk + 1]);
    pa[4 * kk + 1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
    pa[4 * kk + 2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
    pa[4 * kk + 3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
  }
}

// the map of this kernel's mode (K4's relu^2 or the softmax), in place
template <int MODE>
__device__ __forceinline__ void map_tile(float (&s)[32], const float* coef, float scale, int t,
                                         float& m0, float& m1, float& l0, float& l1, float& al0,
                                         float& al1) {
  if constexpr (MODE == RELU2) {
    relu2_tile(s, coef, scale, t);
  } else {
    softmax_tile(s, coef, scale, t, m0, m1, l0, l1, al0, al1);
  }
}

// The rows' running o rescaled by alpha (rows g: o[4 j], o[4 j + 1]; g + 8)
template <int R>
__device__ __forceinline__ void rescale(float (&o)[R], float al0, float al1) {
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    o[i] = __fmul_rn(o[i], al0);
    o[i + 1] = __fmul_rn(o[i + 1], al0);
    o[i + 2] = __fmul_rn(o[i + 2], al1);
    o[i + 3] = __fmul_rn(o[i + 3], al1);
  }
}

// The epilogue: rows r0, r1 (< tq) of the item's out rows from row_base, at
// columns c0 + 8 j + 2 t (< out_cols); K3 divides by max(l, 1e-30) (l summed
// across the quad first), K5 writes o, and m and l where `stats`; K4 writes o
template <int MODE, int R>
__device__ __forceinline__ void store_rows(const float (&o)[R], float m0, float m1, float l0,
                                           float l1, const Params& p, size_t row_base, int r0,
                                           int r1, int c0, int t, bool stats) {
  float d0 = 1.f, d1 = 1.f;
  if constexpr (MODE != RELU2) {
    l0 += __shfl_xor_sync(FULL, l0, 1);
    l0 += __shfl_xor_sync(FULL, l0, 2);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    if constexpr (MODE == SOFTMAX) {
      d0 = fmaxf(l0, 1e-30f);
      d1 = fmaxf(l1, 1e-30f);
    }
  }
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    if (col >= p.out_cols) continue;
    if (r0 < p.tq) {
      *reinterpret_cast<float2*>(p.out + (row_base + r0) * p.out_cols + col) =
          MODE == SOFTMAX ? make_float2(__fdiv_rn(o[4 * j], d0), __fdiv_rn(o[4 * j + 1], d0))
                          : make_float2(o[4 * j], o[4 * j + 1]);
    }
    if (r1 < p.tq) {
      *reinterpret_cast<float2*>(p.out + (row_base + r1) * p.out_cols + col) =
          MODE == SOFTMAX ? make_float2(__fdiv_rn(o[4 * j + 2], d1), __fdiv_rn(o[4 * j + 3], d1))
                          : make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
  }
  if (MODE == STATS && stats && t == 0) {
    if (r0 < p.tq) {
      p.m_out[row_base + r0] = m0;
      p.l_out[row_base + r0] = l0;
    }
    if (r1 < p.tq) {
      p.m_out[row_base + r1] = m1;
      p.l_out[row_base + r1] = l1;
    }
  }
}

// The kernel. Grid: x = blocks of 64 NWG query rows, y = items, z = column
// chunks of DV (K4; 1 for K3 / K5). mq: q [items, tq, ND boxes]; mk: K
// [items, tk, ND boxes]; mv: V [items, tk, columns]. KS: k16 steps of the
// scores (the head dim / 16 rounded up; boxes past it are zero-filled).
template <int MODE, int ND, int KS, int DV, int NWG>
__global__ void __launch_bounds__(Cfg<ND, KS, DV, NWG>::THREADS, 1)
    attn_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const Params p) {
  using C = Cfg<ND, KS, DV, NWG>;
  constexpr int NS = C::NS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // the swizzle's 1024 B
  const uint32_t q_s = smem_u32(base), ring = q_s + C::Q_BYTES;
  float* coef = reinterpret_cast<float*>(base + C::Q_BYTES + NS * C::SLOT);  // [NS][BK]
  uint64_t* bars = reinterpret_cast<uint64_t*>(coef + NS * BK);  // full[NS], empty[NS], q
  uint8_t* live = reinterpret_cast<uint8_t*>(bars + 2 * NS + 1);
  const uint32_t full = smem_u32(bars), empty = full + 8 * NS, qbar = full + 16 * NS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int item = blockIdx.y, row0 = blockIdx.x * 64 * NWG, c0 = blockIdx.z * DV;
  const uint8_t* mrow = p.mask ? p.mask + (size_t)(item / p.heads) * p.tk : nullptr;
  const int n_tiles = (p.tk + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 32);         // the producer's 32 lanes (lane 0 with the bytes)
      mbar_init(empty + 8 * s, 4 * NWG);   // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  const bool skip = mark_live<MODE>(mrow, p.tk, n_tiles, live);  // + the barrier for the inits

  if (warp >= 4 * NWG) {  // the producer warp (the first of the producer warpgroup)
    if constexpr (NWG == 2) {
      setmaxnreg_dec<40>();
      if (warp != 4 * NWG) return;
    }
    if (lane == 0) {
      tma_prefetch_map(&mq);
      tma_prefetch_map(&mk);
      tma_prefetch_map(&mv);
      mbar_arrive_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int w = 0; w < NWG; ++w) {
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          tma_load_3d(q_s + (w * ND + c) * BOX, &mq, qbar, 64 * c, row0 + 64 * w, item);
        }
      }
    }
    int s = 0;
    uint32_t ph = 0;
    for (int tile = next_live(0, skip, n_tiles, live); tile < n_tiles;
         tile = next_live(tile + 1, skip, n_tiles, live)) {
      mbar_wait(empty + 8 * s, ph ^ 1);
      const int j = tile * BK + 2 * lane;
      *reinterpret_cast<float2*>(coef + s * BK + 2 * lane) =
          make_float2(key_coef<MODE>(j, p.tk, mrow), key_coef<MODE>(j + 1, p.tk, mrow));
      if (lane == 0) {
        const uint32_t st = ring + s * C::SLOT, bar = full + 8 * s;
        mbar_arrive_expect_tx(bar, C::SLOT);
#pragma unroll
        for (int c = 0; c < ND; ++c) tma_load_3d(st + c * BOX, &mk, bar, 64 * c, tile * BK, item);
#pragma unroll
        for (int c = 0; c < C::NV; ++c) {
          tma_load_3d(st + (ND + c) * BOX, &mv, bar, c0 + 64 * c, tile * BK, item);
        }
      } else {
        mbar_arrive(full + 8 * s);
      }
      if (++s == NS) {
        s = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows row0 + 64 wg .. + 63, warp w4 of it
  // rows 16 w4 + g and 16 w4 + g + 8 of those
  if constexpr (NWG == 2) setmaxnreg_inc<232>();
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + 64 * wg + 16 * (warp & 3) + g, r1 = r0 + 8;
  const uint32_t qa = q_s + wg * ND * BOX;
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INIT, m1 = NEG_INIT, l0 = 0.f, l1 = 0.f;
  mbar_wait(qbar, 0);
  const int tile = next_live(0, skip, n_tiles, live);
  if (tile < n_tiles) {
    float s[32];
    uint32_t pa[16];
    float al0 = 1.f, al1 = 1.f;
    int st = 0;
    uint32_t ph = 0;
    // the first tile's scores and p
    mbar_wait(full + 8 * st, ph);
    issue_scores<KS>(s, qa, ring + st * C::SLOT);
    wgmma_wait<0>();
    fence_operands(s);
    map_tile<MODE>(s, coef + st * BK, p.scale, t, m0, m1, l0, l1, al0, al1);
    pack_p(s, pa);
    // while a next tile exists, its scores go first, then this tile's p v,
    // and the next tile's p is formed in float32 while p v runs, rounded
    // into p v's A fragments once p v is done. The body has one path, so
    // ptxas sees which commit group each wait retires, and no register that
    // a running wgmma reads is written: either would serialize the wgmmas
    // (ptxas C7514 / C7513)
    for (int nxt = next_live(tile + 1, skip, n_tiles, live); nxt < n_tiles;
         nxt = next_live(nxt + 1, skip, n_tiles, live)) {
      int sn = st + 1;
      uint32_t phn = ph;
      if (sn == NS) {
        sn = 0;
        phn ^= 1;
      }
      mbar_wait(full + 8 * sn, phn);
      issue_scores<KS>(s, qa, ring + sn * C::SLOT);
      if constexpr (MODE != RELU2) rescale(o, al0, al1);
      issue_pv<DV>(o, pa, ring + st * C::SLOT + ND * BOX);
      wgmma_wait<1>();
      fence_operands(s);
      map_tile<MODE>(s, coef + sn * BK, p.scale, t, m0, m1, l0, l1, al0, al1);
      wgmma_wait<0>();
      fence_operands(o);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);  // this tile's stage is read
      pack_p(s, pa);
      st = sn;
      ph = phn;
    }
    // the last tile's p v
    if constexpr (MODE != RELU2) rescale(o, al0, al1);
    issue_pv<DV>(o, pa, ring + st * C::SLOT + ND * BOX);
    wgmma_wait<0>();
    fence_operands(o);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }
  store_rows<MODE, DV / 2>(o, m0, m1, l0, l1, p, (size_t)item * p.tq, r0, r1, c0, t, true);
}

// The split launch of the float32 attention kernels (K3 / K5 and K4, 3xTF32
// on TF32 wgmma): k [items][t][dk] -> out_k [2][items][t][dk], its big and
// then its small TF32 halves (both rounded, tf32_mma.cuh split), as it lies:
// K-major for q k^T; v [items][t][dv] -> out_v [2][items][dv][tp] (tp = t
// rounded up to 8) transposed and split, its keys permuted inside each group
// of 8 (position i holds key 2 i, position i + 4 key 2 i + 1; zero past t),
// so that a warp's score accumulator over 8 keys is p v's register A
// fragment (TF32 wgmma takes no transpose: p v needs v K-major over the
// keys); and, where q is not null, q [items][tq][dk] -> out_q as k. dk is a
// multiple of 4. Grid (ceil(tp / 32), ceil(dv / 32), items): each block
// transposes one 32 x 32 tile of item z's v through shared memory, then
// splits its grid-stride share of k's (and q's) float4s. Static: each
// source that includes this header has its own copy.
__device__ __forceinline__ void split_rows(const float* __restrict__ x, float* __restrict__ out,
                                           size_t n4, size_t i0, size_t stride) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (size_t i = i0; i < n4; i += stride) {
    const float4 a = x4[i];
    uint32_t b0, b1, b2, b3, s0, s1, s2, s3;
    split(a.x, b0, s0);
    split(a.y, b1, s1);
    split(a.z, b2, s2);
    split(a.w, b3, s3);
    o4[i] = make_float4(__uint_as_float(b0), __uint_as_float(b1), __uint_as_float(b2),
                        __uint_as_float(b3));
    o4[n4 + i] = make_float4(__uint_as_float(s0), __uint_as_float(s1), __uint_as_float(s2),
                             __uint_as_float(s3));
  }
}

static __global__ void __launch_bounds__(256)
    tf32_split_kernel(const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ q, float* __restrict__ out_k,
                      float* __restrict__ out_v, float* __restrict__ out_q, int items, int t,
                      int tp, int tq, int dk, int dv) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int b = blockIdx.z, j0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  for (int i = ty; i < 32; i += 8) {  // key j0 + i, column c0 + tx
    const int j = j0 + i, c = c0 + tx;
    tile[i][tx] = j < t && c < dv ? v[((size_t)b * t + j) * dv + c] : 0.f;
  }
  __syncthreads();
  const size_t half = (size_t)items * dv * tp;
  const int pos = tx & 7, key = (tx & ~7) + (pos < 4 ? 2 * pos : 2 * (pos - 4) + 1);
  for (int i = ty; i < 32; i += 8) {  // column c0 + i, position j0 + tx
    const int c = c0 + i;
    if (c >= dv || j0 + tx >= tp) continue;
    uint32_t big, small;
    split(tile[key][i], big, small);
    const size_t o = ((size_t)b * dv + c) * tp + j0 + tx;
    out_v[o] = __uint_as_float(big);
    out_v[half + o] = __uint_as_float(small);
  }
  const size_t stride = (size_t)gridDim.x * gridDim.y * gridDim.z * blockDim.x;
  const size_t i0 =
      (((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * blockDim.x +
      threadIdx.x;
  split_rows(k, out_k, (size_t)items * t * dk / 4, i0, stride);
  if (q) split_rows(q, out_q, (size_t)items * tq * dk / 4, i0, stride);
}

// Queue the split launch (q may be null); its error code
inline cudaError_t tf32_split(const float* k, const float* v, const float* q, float* out_k,
                              float* out_v, float* out_q, int items, int t, int tq, int dk,
                              int dv, cudaStream_t stream) {
  const int tp = (t + 7) / 8 * 8;
  const dim3 grid((tp + 31) / 32, (dv + 31) / 32, items);
  tf32_split_kernel<<<grid, 256, 0, stream>>>(k, v, q, out_k, out_v, out_q, items, t, tp, tq,
                                              dk, dv);
  return cudaGetLastError();
}

// Launch attn_kernel<MODE, ND, KS, DV, NWG> over grid (x, y, z) with its
// maps; the kernel's shared-memory cap is raised once per device
template <int MODE, int ND, int KS, int DV, int NWG>
int launch(dim3 grid, const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           const Params& p, cudaStream_t stream) {
  using C = Cfg<ND, KS, DV, NWG>;
  static std::atomic<uint64_t> raised{0};
  const auto kernel = attn_kernel<MODE, ND, KS, DV, NWG>;
  cudaError_t e = allow_dynamic_smem(reinterpret_cast<const void*>(kernel), raised);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = C::smem_bytes((p.tk + BK - 1) / BK);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  kernel<<<grid, C::THREADS, smem, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

}  // namespace attn
}  // namespace act
