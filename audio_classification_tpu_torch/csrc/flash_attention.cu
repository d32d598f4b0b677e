// K3 flash_attention and K5 flash_attention_stats: masked non-causal
// multi-head attention as a streaming softmax, forward only. One body with
// two epilogues at each dtype, as the TPU source has one body with two.
//
// Replaces audio_classification_tpu/ops/pallas/attention_kernel.py
// (flash_attention -> _flash_fwd_call(emit_stats=False) and
// flash_attention_stats -> _flash_fwd_call(emit_stats=True), body _kernel
// :64-113): s = (q k^T) * scale + key_bias (0 / -1e9 from kv_mask, -inf
// past tk), running max m and sum l over key tiles. K3 (mode SOFTMAX)
// writes out = acc / max(l, 1e-30). K5 (mode STATS) writes the unnormalised
// acc with the row's m and l: o = sum_k exp(s - m) v, m = max_k s, l =
// sum_k exp(s - m); the ring attention of parallel/ring_attention.py merges
// such triples of key blocks and divides once at the end. The queries (tq
// rows) and the keys (tk rows) have separate lengths: in the ring a shard's
// queries meet every other shard's keys. A key block that is masked whole
// gives m = -1e9 and l = its key count (every s rounds to -1e9 in float32),
// which the merge scales by exp(-1e9 - m_valid) = 0. bfloat16 q, k, v take
// entry points of their own (act_flash_attention_bf16,
// act_flash_attention_stats_bf16: namespace b16 below).
//
// float32 (namespace t32). Bound on the H100: the two products (s = q k^T,
// acc += p v) are 4 Tq Tk_valid D operations over O(T D) bytes, so the
// kernel is bound by operations. Float32 accuracy on the tensor cores costs
// three TF32 products per product (3xTF32: x = big + small, both exact in
// TF32; a b ~ a_big b_big + a_big b_small + a_small b_big, the dropped term
// below 2^-22 |a b|), so the bound is the work over 495 / 3 TFLOP/s: 0.177
// ms at [1,8,4271,64] with 3337 keys valid; one TF32 product alone is
// 2-5e-4 off at these shapes, ten times K3's tolerance.
// Design (Hopper: 3xTF32 on TF32 wgmma m64nNk8 fed by TMA), two launches a
// call:
//   S  the split launch (attention_wgmma.cuh tf32_split, shared with K4):
//      k into big and small TF32 halves, K-major as it lies ([2][B H][Tk]
//      [D]); v transposed and split ([2][B H][D][Tkp], Tkp = Tk rounded up
//      to 8), its keys permuted in groups of 8 so that the score
//      accumulator of a tile is p v's register A fragment (TF32 wgmma takes
//      no transpose). Once a call, in device memory: at T = 4271 each K
//      tile feeds 34-67 row blocks.
//   A  attn_kernel (head dims 64, 80, 128): a block is NWG consumer
//      warpgroups of 64 query rows and a producer (a warp, or at NWG = 2 a
//      warpgroup whose registers go to the consumers by setmaxnreg). The
//      producer loads the block's q rows once, raw, then for each live key
//      tile (BK keys: 64 at D = 64, 32 at 80 and 128, where a 64-key stage
//      would leave no second one) both halves of the tile's K, with its key
//      bias beside them, into the next stage of a K ring, and both halves
//      of its v^T into the next stage of a v^T ring (TMA, one mbarrier pair
//      a stage). K is handed back once the scores that read it are done,
//      v^T once p v is, so each load starts about a tile ahead of its use;
//      one ring of K and v^T together, at the two stages shared memory
//      leaves, waited on every tile's loads (0.583 -> 0.468 ms at
//      [1,8,4271,64]). Each consumer warpgroup splits its q rows once into
//      TF32 halves (both rounded) in shared memory: q holds no registers and
//      the scores read both operands by descriptor (q's big half in
//      registers spilled at NWG = 2 and gained nothing at NWG = 1). The
//      tiles go in FA3's order: tile j + 1's scores (q big x k big into one
//      accumulator, the cross terms q small x k big and q big x k small
//      into another, the two joined in float32) are issued before tile j's
//      p v, and while p v runs the scores of j + 1 go through the softmax
//      in float32 registers (the IEEE expf, as the twin's exp). p is split
//      in registers (big rounded, small left for the product to truncate)
//      as p v's A operand, three products a k8 step against v^T's halves;
//      each tile's p v is formed from zero and merged into the running acc
//      in IEEE float32 (acc = alpha acc + pv, one rounding): the tensor
//      cores' truncating sum never runs longer than a tile (one accumulator
//      over all tiles was 4.5e-6 off the float64 twin at [1,8,4271,64]
//      against 4.0e-7, and no faster beyond the A/B spread: PERF.md). The
//      loop has one path and touches no register of a running wgmma, so
//      ptxas serializes none (attention_wgmma.cuh's header, C7513 / C7514).
//      The plan (plan(), act_flash_attention_plan, mirrored by
//      ops/kernels/attention.tf32_plan) takes two warpgroups a block (128
//      rows sharing each K / v^T tile) where the card's rounds of blocks
//      times a block's cost are fewer: a block of two took 1.75x one of
//      one, so two win only where they save rounds on a short key loop
//      ([8,8,537], K5's 1068-key blocks), and one at D = 128 (q's halves of
//      128 rows would leave no second stage).
//   W  wide_kernel (any multiple of 64 above 128; the wrapper zero-pads D
//      to the next head dim taken): output columns in slices of 128 over
//      grid z, the scores formed once a slice over units of 64 dims (the
//      split launch splits q too; a unit's big chain from zero, added to the
//      tile's in float32; the cross terms over all units in one
//      accumulator), then the softmax and p v as above, without the
//      overlap. Every slice forms the same scores in the same order, so
//      slice 0 writes K5's m and l.
// A key tile whose mask bytes are all 0 is skipped when its batch item has
// a valid key anywhere (exact: once a row has met a valid key a masked score
// adds exp(-1e9 - m) = 0, and a later valid key erases earlier masked ones
// through alpha = 0); an item with no valid key is computed over every tile,
// as the twin does. Keys past tk are excluded outright (score -inf), so such
// an item still gives l = tk. No sum crosses a block: two calls give
// identical bits.
// Times (NVIDIA H100 80GB HBM3, 700.00 W; scripts/flash_attention_ab.py,
// graph replay, both launches; PERF.md): 0.080 / 0.022 / 0.028 / 0.430 ms
// at [8,8,537,64] ragged, [1,8,537,64], [1,4,800,64] and [1,8,4271,64] with
// 3337 keys valid (share 0.22 / 0.16 / 0.15 / 0.41), 0.382 at
// [1,4,4267,80] with 3333 valid, K5 0.055 on a full 1068-key block; the
// wide body 0.59-0.97 of SDPA. The long shapes run one-warpgroup blocks,
// and one warpgroup an SM caps a TF32 wgmma stream at 0.74 of the peak
// (scripts/wgmma_tf32_rate.py). The mma.sync design this replaces (m16n8k8
// 3xTF32, 4 warps of 16 rows, 64-key tiles by a cp.async ring) took 0.086 /
// 0.034 / 0.047 / 0.682, 0.537 and 0.090 in the same call.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "attention_wgmma.cuh"  // the pipeline's parts (namespace act::attn); wgmma_tma.cuh

namespace {

namespace aw = act::attn;

// The head dims the kernels take: 64, 80, 128 (the float32 body's and the
// bf16 body's instances) and every multiple of 64 above 128 (the wide
// bodies). This function owns the set (ops/kernels/attention.py's HEAD_DIMS
// and WIDE_SLAB mirror it, and a card test holds them equal); every entry
// point refuses any other D, empty calls too
inline bool takes_head_dim(int d) {
  return d == 64 || d == 80 || d == 128 || (d > 128 && d % 64 == 0);
}

// ---------------------------------------------------------------------------
// float32 q, k, v: act_flash_attention (K3), act_flash_attention_stats (K5)
namespace t32 {

using act::smem_u32;

constexpr int ROW = 128;             // bytes of a swizzled row: 32 floats
constexpr int QBOX = 64 * ROW;       // a {32 d, 64 rows} box of q
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a block may take
constexpr int SMEM_RESERVE = 3072;   // alignment slack, key bias, barriers, live map
constexpr int SMS = 132;             // the card's SMs, whose rounds the plan counts
constexpr int WCOLS = 128;           // output columns of a wide body's block
constexpr int WBK = 32;              // keys a tile of the wide body
constexpr int WNS = 4;               // stages of the wide body's ring

// keys a tile of the narrow body at head dim d
constexpr int keys_of(int d) { return d == 64 ? 64 : 32; }

__device__ __forceinline__ uint64_t desc(uint32_t addr) { return act::desc_sw128(addr, 16, 1024); }

// The narrow body's block at head dim D (64, 80, 128) with NWG consumer
// warpgroups: ND boxes of 32 dims for q and K (a third box at D = 80, zero
// past 80), NKB boxes of 32 keys for v^T; q's big and small halves, then a
// ring of NS stages of K (big, small) and one of NS stages of v^T (big,
// small): K is handed back once the scores that read it are done, v^T once
// p v is, so a tile's loads start about one tile ahead of its use even at
// two stages (one ring of two stages stalled on every tile's loads)
template <int D, int NWG>
struct Cfg {
  static constexpr int BK = keys_of(D);
  static constexpr int ND = (D + 31) / 32;
  static constexpr int NKB = BK / 32;
  static constexpr int THREADS = 128 * NWG + (NWG == 2 ? 128 : 32);
  static constexpr int Q_HALF = NWG * ND * QBOX;
  static constexpr int K_HALF = ND * BK * ROW;
  static constexpr int V_HALF = NKB * D * ROW;
  static constexpr int K_SLOT = 2 * K_HALF, V_SLOT = 2 * V_HALF;
  static constexpr int NS_FIT = (SMEM_MAX - SMEM_RESERVE - 2 * Q_HALF) / (K_SLOT + V_SLOT);
  static constexpr int NS = NS_FIT > 4 ? 4 : NS_FIT;
  static_assert(NS >= 2, "flash t32: two stages must fit");
  // dynamic shared memory of a launch over n_tiles key tiles: alignment
  // slack, q, the rings, the key bias, the barriers, the live-tile map
  static size_t smem_bytes(int n_tiles) {
    return 1024 + 2 * (size_t)Q_HALF + (size_t)NS * (K_SLOT + V_SLOT) +
           sizeof(float) * NS * BK + sizeof(uint64_t) * (4 * NS + 1) + (size_t)n_tiles;
  }
};

// The wide body's block: one consumer warpgroup, a producer warp; a stage
// holds a unit of the scores (two boxes of each q half and of each K half)
// or a tile's v^T slice (a {32 keys, WCOLS columns} box of each half)
struct Wide {
  static constexpr int Q_UNIT = 2 * QBOX;
  static constexpr int K_UNIT = 2 * WBK * ROW;
  static constexpr int V_HALF = WCOLS * ROW;
  static constexpr int SLOT = 2 * Q_UNIT + 2 * K_UNIT;
  static_assert(2 * V_HALF <= SLOT, "flash t32: a v^T slice fits a stage");
  static size_t smem_bytes(int n_tiles) {
    return 1024 + (size_t)WNS * SLOT + sizeof(float) * WNS * WBK + sizeof(uint64_t) * 2 * WNS +
           (size_t)n_tiles;
  }
};

// q's raw rows (ND boxes at big, as TMA landed them: zero past tq and D)
// split in place into their big TF32 half and, at small, the small half
// (both rounded, as the split launch splits k), by the 128 threads of a
// warpgroup (i0 = the thread's index in it). The swizzle moves whole
// 16-byte chunks, so both halves keep the raw layout
template <int ND>
__device__ __forceinline__ void split_q(unsigned char* big, unsigned char* small, int i0) {
  float4* b = reinterpret_cast<float4*>(big);
  float4* sm = reinterpret_cast<float4*>(small);
#pragma unroll 4
  for (int i = i0; i < ND * QBOX / 16; i += 128) {
    const float4 x = b[i];
    uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
    act::split(x.x, h0, l0);
    act::split(x.y, h1, l1);
    act::split(x.z, h2, l2);
    act::split(x.w, h3, l3);
    b[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(h2),
                       __uint_as_float(h3));
    sm[i] = make_float4(__uint_as_float(l0), __uint_as_float(l1), __uint_as_float(l2),
                        __uint_as_float(l3));
  }
}

// q k^T over KS k8 steps of one key tile of N keys, in 3xTF32: q big x k
// big into s from zero, the small cross terms (q small x k big, q big x k
// small) into s_lo, from zero unless lo_acc. The tensor cores truncate as
// they accumulate, so the cross terms gather apart from the big chain, whose
// sum is 2^10 times theirs, and join it once (join): one chain of all three
// products (3 KS truncating adds) failed K5's 1e-5 in l at scores of std 16
// (tests/test_torch_kernels_cuda.py test_flash_kernels_skip_masked_tiles).
// qb, qs: the warpgroup's q halves ({32 d, 64 rows} boxes of QBOX bytes);
// kb, ks: K's halves ({32 d, N keys} boxes). Issued and committed, not
// waited for
template <int N, int KS>
__device__ __forceinline__ void issue_scores(float (&s)[N / 2], float (&s_lo)[N / 2], uint32_t qb,
                                             uint32_t qs, uint32_t kb, uint32_t ks, int lo_acc) {
  act::fence_operands(s);
  act::fence_operands(s_lo);
  act::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t qo = (kk >> 2) * QBOX + (kk & 3) * 32, ko = (kk >> 2) * N * ROW + (kk & 3) * 32;
    act::wgmma_tf32_ss<N>(s_lo, desc(qs + qo), desc(kb + ko), kk > 0 || lo_acc);
    act::wgmma_tf32_ss<N>(s_lo, desc(qb + qo), desc(ks + ko), 1);
    act::wgmma_tf32_ss<N>(s, desc(qb + qo), desc(kb + ko), kk > 0);
  }
  act::wgmma_commit();
}

// s += s_lo in IEEE float32, once the scores' products are done
template <int R>
__device__ __forceinline__ void join(float (&s)[R], float (&s_lo)[R]) {
  act::fence_operands(s);
  act::fence_operands(s_lo);
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] += s_lo[i];
}

// p (the softmax's floats in the score layout, 2 R keys) split as p v's A
// fragments: k8 step j holds keys 8 j + 2 t (a0: row g, a1: row g + 8) and
// 8 j + 2 t + 1 (a2, a3), which v^T's permuted keys put at k t and t + 4
template <int R>
__device__ __forceinline__ void split_p(const float (&s)[R], uint32_t (&pb)[R / 4][4],
                                        uint32_t (&ps)[R / 4][4]) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    act::split_fast(s[4 * j], pb[j][0], ps[j][0]);
    act::split_fast(s[4 * j + 2], pb[j][1], ps[j][1]);
    act::split_fast(s[4 * j + 1], pb[j][2], ps[j][2]);
    act::split_fast(s[4 * j + 3], pb[j][3], ps[j][3]);
  }
}

template <int BK>
__device__ __forceinline__ void fence_p(uint32_t (&pb)[BK / 8][4], uint32_t (&ps)[BK / 8][4]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    act::fence_regs(pb[j]);
    act::fence_regs(ps[j]);
  }
}

// pv = p v over one key tile of BK keys and DV columns, from zero, in
// 3xTF32: per k8 step p small x v big, p big x v small, p big x v big. vb,
// vs: v^T's halves ({32 keys, DV columns} boxes). p's registers are fenced
// before wgmma.fence, so that no write of them moves past it. Issued and
// committed, not waited for
template <int DV, int BK>
__device__ __forceinline__ void issue_pv(float (&pv)[DV / 2], uint32_t (&pb)[BK / 8][4],
                                         uint32_t (&ps)[BK / 8][4], uint32_t vb, uint32_t vs) {
  fence_p<BK>(pb, ps);
  act::fence_operands(pv);
  act::wgmma_fence();
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const uint32_t off = (j >> 2) * DV * ROW + (j & 3) * 32;
    act::wgmma_tf32_rs<DV>(pv, ps[j], desc(vb + off), j > 0);
    act::wgmma_tf32_rs<DV>(pv, pb[j], desc(vs + off), 1);
    act::wgmma_tf32_rs<DV>(pv, pb[j], desc(vb + off), 1);
  }
  act::wgmma_commit();
}

// acc = alpha acc + pv with one rounding (rows g: [4 j], [4 j + 1]; g + 8)
template <int R>
__device__ __forceinline__ void merge(float (&o)[R], const float (&pv)[R], float al0, float al1) {
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    o[i] = fmaf(o[i], al0, pv[i]);
    o[i + 1] = fmaf(o[i + 1], al0, pv[i + 1]);
    o[i + 2] = fmaf(o[i + 2], al1, pv[i + 2]);
    o[i + 3] = fmaf(o[i + 3], al1, pv[i + 3]);
  }
}

// The narrow body. Grid (row blocks of 64 NWG rows, items = B H, 1). mq: q
// [items, tq, D] raw in {32, 64} boxes; mk: k's halves [2 items, tk, D] in
// {32, BK}; mv: v^T's halves [2 items, D, Tkp] in {32, D}
template <int MODE, int D, int NWG>
__global__ void __launch_bounds__(Cfg<D, NWG>::THREADS, 1)
    attn_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const aw::Params p) {
  using C = Cfg<D, NWG>;
  constexpr int NS = C::NS, BK = C::BK, ND = C::ND, R = BK / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // the swizzle's 1024 B
  const uint32_t qb_s = smem_u32(base), qs_s = qb_s + C::Q_HALF;
  const uint32_t k_ring = qs_s + C::Q_HALF, v_ring = k_ring + NS * C::K_SLOT;
  float* coef = reinterpret_cast<float*>(base + 2 * C::Q_HALF + NS * (C::K_SLOT + C::V_SLOT));
  // barriers, NS each: K full, K empty, v^T full, v^T empty; then q's
  uint64_t* bars = reinterpret_cast<uint64_t*>(coef + NS * BK);
  uint8_t* live = reinterpret_cast<uint8_t*>(bars + 4 * NS + 1);
  const uint32_t full_k = smem_u32(bars), empty_k = full_k + 8 * NS;
  const uint32_t full_v = empty_k + 8 * NS, empty_v = full_v + 8 * NS, qbar = empty_v + 8 * NS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int item = blockIdx.y, items = gridDim.y, row0 = blockIdx.x * 64 * NWG;
  const uint8_t* mrow = p.mask ? p.mask + (size_t)(item / p.heads) * p.tk : nullptr;
  const int n_tiles = (p.tk + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      act::mbar_init(full_k + 8 * s, 32);        // the producer's 32 lanes (lane 0 with the bytes)
      act::mbar_init(empty_k + 8 * s, 4 * NWG);  // lane 0 of each consumer warp
      act::mbar_init(full_v + 8 * s, 32);
      act::mbar_init(empty_v + 8 * s, 4 * NWG);
    }
    act::mbar_init(qbar, 1);
    act::mbar_fence_init();
  }
  const bool skip = aw::mark_live<MODE, BK>(mrow, p.tk, n_tiles, live);  // + the inits' barrier

  if (warp >= 4 * NWG) {  // the producer warp (the first of the producer warpgroup)
    if constexpr (NWG == 2) {
      act::setmaxnreg_dec<40>();
      if (warp != 4 * NWG) return;
    }
    if (lane == 0) {
      act::tma_prefetch_map(&mq);
      act::tma_prefetch_map(&mk);
      act::tma_prefetch_map(&mv);
      act::mbar_arrive_expect_tx(qbar, C::Q_HALF);
#pragma unroll
      for (int w = 0; w < NWG; ++w) {
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          act::tma_load_3d(qb_s + (w * ND + c) * QBOX, &mq, qbar, 32 * c, row0 + 64 * w, item);
        }
      }
    }
    int s = 0;
    uint32_t ph = 0;
    for (int tile = aw::next_live(0, skip, n_tiles, live); tile < n_tiles;
         tile = aw::next_live(tile + 1, skip, n_tiles, live)) {
      // the tile's K halves and key bias, then its v^T halves, each into
      // stage s of its own ring
      act::mbar_wait(empty_k + 8 * s, ph ^ 1);
      for (int e = lane; e < BK; e += 32) {
        coef[s * BK + e] = aw::key_coef<MODE>(tile * BK + e, p.tk, mrow);
      }
      if (lane == 0) {
        const uint32_t st = k_ring + s * C::K_SLOT, bar = full_k + 8 * s;
        act::mbar_arrive_expect_tx(bar, C::K_SLOT);
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          act::tma_load_3d(st + c * BK * ROW, &mk, bar, 32 * c, tile * BK, item);
          act::tma_load_3d(st + C::K_HALF + c * BK * ROW, &mk, bar, 32 * c, tile * BK,
                           items + item);
        }
      } else {
        act::mbar_arrive(full_k + 8 * s);
      }
      act::mbar_wait(empty_v + 8 * s, ph ^ 1);
      if (lane == 0) {
        const uint32_t st = v_ring + s * C::V_SLOT, bar = full_v + 8 * s;
        act::mbar_arrive_expect_tx(bar, C::V_SLOT);
#pragma unroll
        for (int kb = 0; kb < C::NKB; ++kb) {
          act::tma_load_3d(st + kb * D * ROW, &mv, bar, tile * BK + 32 * kb, 0, item);
          act::tma_load_3d(st + C::V_HALF + kb * D * ROW, &mv, bar, tile * BK + 32 * kb, 0,
                           items + item);
        }
      } else {
        act::mbar_arrive(full_v + 8 * s);
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
  if constexpr (NWG == 2) act::setmaxnreg_inc<232>();
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + 64 * wg + 16 * (warp & 3) + g, r1 = r0 + 8;
  act::mbar_wait(qbar, 0);
  split_q<ND>(base + wg * ND * QBOX, base + C::Q_HALF + wg * ND * QBOX, tid & 127);
  act::fence_proxy_async();       // the halves are read by wgmma (the async proxy)
  act::named_sync(1 + wg, 128);   // this warpgroup's rows, by its 128 threads
  const uint32_t qa = qb_s + wg * ND * QBOX, qsa = qs_s + wg * ND * QBOX;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = aw::NEG_INIT, m1 = aw::NEG_INIT, l0 = 0.f, l1 = 0.f;
  const int tile = aw::next_live(0, skip, n_tiles, live);
  if (tile < n_tiles) {
    float s[R], s_lo[R];
    uint32_t pb[R / 4][4], ps[R / 4][4];
    float al0 = 1.f, al1 = 1.f;
    // the K ring's stage and phase run one tile ahead of the v^T ring's
    int ks = 0, vs = 0;
    uint32_t kph = 0, vph = 0;
    auto k_at = [&]() { return k_ring + ks * C::K_SLOT; };
    auto v_at = [&]() { return v_ring + vs * C::V_SLOT; };
    auto release = [&](uint32_t empty, int& st, uint32_t& ph) {  // this warp is done with it
      __syncwarp();
      if (lane == 0) act::mbar_arrive(empty + 8 * st);
      if (++st == NS) {
        st = 0;
        ph ^= 1;
      }
    };
    // the first tile's scores and p
    act::mbar_wait(full_k + 8 * ks, kph);
    issue_scores<BK, D / 8>(s, s_lo, qa, qsa, k_at(), k_at() + C::K_HALF, 0);
    act::wgmma_wait<0>();
    join(s, s_lo);
    aw::softmax_tile(s, coef + ks * BK, p.scale, t, m0, m1, l0, l1, al0, al1);
    release(empty_k, ks, kph);
    split_p(s, pb, ps);
    // while a next tile exists, its scores go first, then this tile's p v
    // (from zero), and the next tile's softmax runs while p v does; p v is
    // merged into acc and the next p split once p v is done. One path, and
    // no register of a running wgmma is touched before its wait (ptxas
    // C7514 / C7513 would serialize every wgmma)
    for (int nxt = aw::next_live(tile + 1, skip, n_tiles, live); nxt < n_tiles;
         nxt = aw::next_live(nxt + 1, skip, n_tiles, live)) {
      act::mbar_wait(full_k + 8 * ks, kph);
      issue_scores<BK, D / 8>(s, s_lo, qa, qsa, k_at(), k_at() + C::K_HALF, 0);
      act::mbar_wait(full_v + 8 * vs, vph);
      float pv[D / 2];
      issue_pv<D, BK>(pv, pb, ps, v_at(), v_at() + C::V_HALF);
      const float a0 = al0, a1 = al1;
      act::wgmma_wait<1>();
      join(s, s_lo);
      aw::softmax_tile(s, coef + ks * BK, p.scale, t, m0, m1, l0, l1, al0, al1);
      release(empty_k, ks, kph);
      act::wgmma_wait<0>();
      act::fence_operands(pv);
      merge(o, pv, a0, a1);
      fence_p<BK>(pb, ps);
      release(empty_v, vs, vph);
      split_p(s, pb, ps);
    }
    // the last tile's p v
    act::mbar_wait(full_v + 8 * vs, vph);
    float pv[D / 2];
    issue_pv<D, BK>(pv, pb, ps, v_at(), v_at() + C::V_HALF);
    act::wgmma_wait<0>();
    act::fence_operands(pv);
    merge(o, pv, al0, al1);
    fence_p<BK>(pb, ps);
    release(empty_v, vs, vph);
  }
  aw::store_rows<MODE, D / 2>(o, m0, m1, l0, l1, p, (size_t)item * p.tq, r0, r1, 0, t, true);
}

// The wide body. Grid (row blocks of 64, items, column slices of WCOLS).
// mq: q's halves [2 items, tq, dp] in {32, 64}; mk: k's [2 items, tk, dp] in
// {32, WBK}; mv: v^T's [2 items, dp, Tkp] in {32, WCOLS} (columns past dp
// zero-filled)
template <int MODE>
__global__ void __launch_bounds__(160, 1)
    wide_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const aw::Params p) {
  constexpr int R = WBK / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t ring = smem_u32(base);
  float* coef = reinterpret_cast<float*>(base + WNS * Wide::SLOT);  // [WNS][WBK]
  uint64_t* bars = reinterpret_cast<uint64_t*>(coef + WNS * WBK);
  uint8_t* live = reinterpret_cast<uint8_t*>(bars + 2 * WNS);
  const uint32_t full = smem_u32(bars), empty = full + 8 * WNS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int item = blockIdx.y, items = gridDim.y, row0 = blockIdx.x * 64, c0 = blockIdx.z * WCOLS;
  const int n_units = p.out_cols / 64;
  const uint8_t* mrow = p.mask ? p.mask + (size_t)(item / p.heads) * p.tk : nullptr;
  const int n_tiles = (p.tk + WBK - 1) / WBK;
  if (tid == 0) {
    for (int s = 0; s < WNS; ++s) {
      act::mbar_init(full + 8 * s, 32);
      act::mbar_init(empty + 8 * s, 4);
    }
    act::mbar_fence_init();
  }
  const bool skip = aw::mark_live<MODE, WBK>(mrow, p.tk, n_tiles, live);

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
          const uint32_t st = ring + s * Wide::SLOT, bar = full + 8 * s;
          act::mbar_arrive_expect_tx(bar, Wide::SLOT);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int d0 = 64 * u + 32 * c;
            act::tma_load_3d(st + c * QBOX, &mq, bar, d0, row0, item);
            act::tma_load_3d(st + Wide::Q_UNIT + c * QBOX, &mq, bar, d0, row0, items + item);
            const uint32_t kst = st + 2 * Wide::Q_UNIT + c * WBK * ROW;
            act::tma_load_3d(kst, &mk, bar, d0, tile * WBK, item);
            act::tma_load_3d(kst + Wide::K_UNIT, &mk, bar, d0, tile * WBK, items + item);
          }
        } else {
          act::mbar_arrive(full + 8 * s);
        }
        advance();
      }
      act::mbar_wait(empty + 8 * s, ph ^ 1);
      coef[s * WBK + lane] = aw::key_coef<MODE>(tile * WBK + lane, p.tk, mrow);
      if (lane == 0) {
        const uint32_t st = ring + s * Wide::SLOT, bar = full + 8 * s;
        act::mbar_arrive_expect_tx(bar, 2 * Wide::V_HALF);
        act::tma_load_3d(st, &mv, bar, tile * WBK, c0, item);
        act::tma_load_3d(st + Wide::V_HALF, &mv, bar, tile * WBK, c0, items + item);
      } else {
        act::mbar_arrive(full + 8 * s);
      }
      advance();
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int r0 = row0 + 16 * warp + g, r1 = r0 + 8;
  float o[WCOLS / 2];
#pragma unroll
  for (int i = 0; i < WCOLS / 2; ++i) o[i] = 0.f;
  float m0 = aw::NEG_INIT, m1 = aw::NEG_INIT, l0 = 0.f, l1 = 0.f;
  float s[R], su[R], s_lo[R];
  uint32_t pb[R / 4][4], ps[R / 4][4];
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
      const uint32_t sa = ring + st * Wide::SLOT, ka = sa + 2 * Wide::Q_UNIT;
      issue_scores<WBK, 8>(su, s_lo, sa, sa + Wide::Q_UNIT, ka, ka + Wide::K_UNIT, u > 0);
      act::wgmma_wait<0>();
      act::fence_operands(su);
#pragma unroll
      for (int i = 0; i < R; ++i) s[i] = u == 0 ? su[i] : s[i] + su[i];
      release();
    }
    join(s, s_lo);
    act::mbar_wait(full + 8 * st, ph);
    float al0, al1;
    aw::softmax_tile(s, coef + st * WBK, p.scale, t, m0, m1, l0, l1, al0, al1);
    split_p(s, pb, ps);
    const uint32_t va = ring + st * Wide::SLOT;
    float pv[WCOLS / 2];
    issue_pv<WCOLS, WBK>(pv, pb, ps, va, va + Wide::V_HALF);
    act::wgmma_wait<0>();
    act::fence_operands(pv);
    merge(o, pv, al0, al1);
    fence_p<WBK>(pb, ps);
    release();
  }
  aw::store_rows<MODE, WCOLS / 2>(o, m0, m1, l0, l1, p, (size_t)item * p.tq, r0, r1, c0, t,
                                  blockIdx.z == 0);
}

// The plan of a call at head dim d (as the entry points take it): consumer
// warpgroups a block, output columns a block, the grid, keys a tile. Two
// warpgroups (128 rows sharing each K / v^T tile) where the rounds of the
// card's SMs times a block's cost say so, else one; one at D = 128 and in
// the wide body. A block of two warpgroups takes 1.75x one of one, so two
// win only where they save rounds and the key loop is short
struct Plan {
  int nwg, cols, gx, gy, gz, bk;
};
inline Plan plan(int batch, int heads, int tq, int tk, int d) {
  const int items = batch * heads;
  if (d > 128) return Plan{1, WCOLS, (tq + 63) / 64, items, (d + WCOLS - 1) / WCOLS, WBK};
  int nwg = 1;
  if (d != 128) {
    // a block's cost in quarter key tiles: a prologue of 2 tiles, then each
    // tile at 4 (one warpgroup) or 7 (two: 1.75x, measured, PERF.md)
    const long long tiles = (tk + keys_of(d) - 1) / keys_of(d);
    const long long r1 = ((long long)((tq + 63) / 64) * items + SMS - 1) / SMS;
    const long long r2 = ((long long)((tq + 127) / 128) * items + SMS - 1) / SMS;
    if (r2 * (8 + 7 * tiles) < r1 * (8 + 4 * tiles)) nwg = 2;
  }
  return Plan{nwg, d, (tq + 64 * nwg - 1) / (64 * nwg), items, 1, keys_of(d)};
}

// Launch a body over grid with its maps (the kernel's shared-memory cap
// raised once per device), or (facts != null) write the threads, stages and
// dynamic shared memory of its block into facts[3]
template <int MODE, int D, int NWG>
int launch(dim3 grid, const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           const aw::Params& p, cudaStream_t stream, int* facts) {
  using C = Cfg<D, NWG>;
  const size_t smem = C::smem_bytes((p.tk + C::BK - 1) / C::BK);
  if (facts) {
    facts[0] = C::THREADS;
    facts[1] = C::NS;
    facts[2] = (int)smem;
    return 0;
  }
  static std::atomic<uint64_t> raised{0};
  const auto kernel = attn_kernel<MODE, D, NWG>;
  const cudaError_t e = act::allow_dynamic_smem(reinterpret_cast<const void*>(kernel), raised);
  if (e != cudaSuccess) return (int)e;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<grid, C::THREADS, smem, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_wide(dim3 grid, const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                const aw::Params& p, cudaStream_t stream, int* facts) {
  const size_t smem = Wide::smem_bytes((p.tk + WBK - 1) / WBK);
  if (facts) {
    facts[0] = 160;
    facts[1] = WNS;
    facts[2] = (int)smem;
    return 0;
  }
  static std::atomic<uint64_t> raised{0};
  const auto kernel = wide_kernel<MODE>;
  const cudaError_t e = act::allow_dynamic_smem(reinterpret_cast<const void*>(kernel), raised);
  if (e != cudaSuccess) return (int)e;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<grid, 160, smem, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

// The call at a head dim the kernels take (tq, batch, heads >= 1): the split
// launch, then the body; or (facts != null) the block's facts, no launch
template <int MODE>
int run(const float* q, const float* k, const float* v, const uint8_t* kv_mask, float* out,
        float* m_out, float* l_out, float* ksp, float* vsp, float* qsp, int batch, int heads,
        int tq, int tk, int d, float scale, cudaStream_t stream, int* facts) {
  const Plan pl = plan(batch, heads, tq, tk, d);
  const int items = batch * heads;
  const bool wide = d > 128;
  CUtensorMap mq, mk, mv;
  if (!facts) {
    cudaError_t e = aw::tf32_split(k, v, wide ? q : nullptr, ksp, vsp, qsp, items, tk, tq, d, d,
                                   stream);
    if (e != cudaSuccess) return (int)e;
    const int tkp = (tk + 7) / 8 * 8;
    if ((e = act::tmap_3d_f32(&mq, wide ? qsp : q, d, tq, wide ? 2 * items : items, 64)) !=
            cudaSuccess ||
        (e = act::tmap_3d_f32(&mk, ksp, d, tk, 2 * items, pl.bk)) != cudaSuccess ||
        (e = act::tmap_3d_f32(&mv, vsp, tkp, d, 2 * items, wide ? WCOLS : d)) != cudaSuccess)
      return (int)e;
  }
  const aw::Params p{kv_mask, out, m_out, l_out, heads, tq, tk, d, scale};
  const dim3 grid(pl.gx, pl.gy, pl.gz);
  switch (d) {
    case 64:
      return pl.nwg == 2 ? launch<MODE, 64, 2>(grid, mq, mk, mv, p, stream, facts)
                         : launch<MODE, 64, 1>(grid, mq, mk, mv, p, stream, facts);
    case 80:
      return pl.nwg == 2 ? launch<MODE, 80, 2>(grid, mq, mk, mv, p, stream, facts)
                         : launch<MODE, 80, 1>(grid, mq, mk, mv, p, stream, facts);
    case 128:
      return launch<MODE, 128, 1>(grid, mq, mk, mv, p, stream, facts);
    default:
      return launch_wide<MODE>(grid, mq, mk, mv, p, stream, facts);
  }
}

}  // namespace t32

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

// the head dims of takes_head_dim, as the float32 bodies
template <bool EMIT_STATS>
int dispatch(const bf16* q, const bf16* k, const bf16* v, const uint8_t* kv_mask, float* out,
             float* m_out, float* l_out, int batch, int heads, int tq, int tk, int d, float scale,
             cudaStream_t stream) {
  constexpr int MODE = EMIT_STATS ? aw::STATS : aw::SOFTMAX;
  if (!takes_head_dim(d)) return (int)cudaErrorInvalidValue;
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

// K3. q, k, v, out: [B, H, T, D] f32 contiguous, 16-byte aligned, D =
// head_dim (takes_head_dim); kv_mask: [B, T] uint8 or null. Scratch for the
// split launch (act_flash_attention_plan's sizes): ksp 2 B H T D floats, vsp
// 2 B H D Tp (Tp = T rounded up to 8), qsp 2 B H T D above D = 128 (the
// wide body; else unread, may be null).
extern "C" int act_flash_attention(const float* q, const float* k, const float* v,
                                   const uint8_t* kv_mask, float* out, float* ksp, float* vsp,
                                   float* qsp, int batch, int heads, int t, int head_dim,
                                   float scale, cudaStream_t stream) {
  if (!takes_head_dim(head_dim)) return (int)cudaErrorInvalidValue;
  if (t <= 0 || batch <= 0 || heads <= 0) return 0;
  return t32::run<aw::SOFTMAX>(q, k, v, kv_mask, out, nullptr, nullptr, ksp, vsp, qsp, batch,
                               heads, t, t, head_dim, scale, stream, nullptr);
}

// K5. q, out: [B, H, Tq, D]; k, v: [B, H, Tk, D]; m_out, l_out: [B, H, Tq];
// all f32 contiguous, 16-byte aligned, D = head_dim as for K3; kv_mask:
// [B, Tk] uint8 or null. Tk >= 1. Scratch as for K3 (ksp and vsp over Tk
// keys, qsp over Tq rows).
extern "C" int act_flash_attention_stats(const float* q, const float* k, const float* v,
                                         const uint8_t* kv_mask, float* out, float* m_out,
                                         float* l_out, float* ksp, float* vsp, float* qsp,
                                         int batch, int heads, int tq, int tk, int head_dim,
                                         float scale, cudaStream_t stream) {
  if (tk <= 0 || !takes_head_dim(head_dim)) return (int)cudaErrorInvalidValue;
  if (tq <= 0 || batch <= 0 || heads <= 0) return 0;
  return t32::run<aw::STATS>(q, k, v, kv_mask, out, m_out, l_out, ksp, vsp, qsp, batch, heads,
                             tq, tk, head_dim, scale, stream, nullptr);
}

// The plan of a float32 K3 / K5 call at head dim head_dim (as the entry
// points take it) into out[9]: consumer warpgroups a block, output columns
// a block, grid x, y, z, threads a block, ring stages, dynamic shared
// memory bytes, keys a tile (ops/kernels/attention.tf32_plan computes the
// same on the host).
extern "C" int act_flash_attention_plan(int batch, int heads, int tq, int tk, int head_dim,
                                        int* out) {
  if (!takes_head_dim(head_dim)) return (int)cudaErrorInvalidValue;
  const t32::Plan pl = t32::plan(batch, heads, tq, tk, head_dim);
  const int geo[5] = {pl.nwg, pl.cols, pl.gx, pl.gy, pl.gz};
  for (int i = 0; i < 5; ++i) out[i] = geo[i];
  out[8] = pl.bk;
  return t32::run<aw::SOFTMAX>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, nullptr, batch, heads, tq, tk, head_dim, 0.f,
                               nullptr, out + 5);
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
  if (!takes_head_dim(head_dim)) return (int)cudaErrorInvalidValue;
  const b16::Plan pl = b16::plan(batch, heads, tq, head_dim);
  out[0] = pl.cols;
  out[1] = pl.gx;
  out[2] = pl.gy;
  out[3] = pl.gz;
  return b16::plan_facts(head_dim, tk, out + 4);
}
