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
// exp(-1e9 - m_valid) = 0.
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
// Head dim: D is a template parameter of the one body, instantiated at 64
// (OSDNet, SenseVoice, the transducer and whisper-style encoders), 80
// (Paraformer: 320 / 4 heads) and 128; both C entry points dispatch on
// head_dim at run time and refuse any other D (the wrapper zero-pads D up
// to the next instance). At D = 64 and 80 q * scale lives in registers as
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

  // which key tiles hold a valid key: one thread per tile reads its mask
  // bytes, so the block learns it in one round trip and the tile loop never
  // waits on a scan. Masked tiles are skipped only when the item has a valid
  // key at all
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
  const bool skip = __syncthreads_or(any) != 0;  // also publishes live_s

  // the first tile at or after `tile` that is computed (the same for every
  // thread, so control flow stays uniform across the block)
  auto next_tile = [&](int tile) -> int {
    if (skip) {
      while (tile < n_tiles && !live_s[tile]) ++tile;
    }
    return tile;
  };
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
        bias_s[st * BK + tid] = j >= tk ? -INFINITY : (mrow && !mrow[j] ? MASKED : 0.f);
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

    // + key bias; the rows' tile max across the quad
    const float* bias = bias_s + st * BK;
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

    // the tile's p v, contracting over keys in the score fragment's own
    // order, gathered from zero and added to the rescaled acc in IEEE
    // float32: the tensor cores' truncating sum never runs longer than a tile
    const float* vt = v_s + st * BK * VS + 2 * t * VS + 2 * g;
    float pv[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
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
      uint32_t vb[D / 8][2], vs[D / 8][2];
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        const float2 x0 = *reinterpret_cast<const float2*>(vt + 8 * kk * VS + 16 * p);
        const float2 x1 = *reinterpret_cast<const float2*>(vt + (8 * kk + 1) * VS + 16 * p);
        split(x0.x, vb[2 * p][0], vs[2 * p][0]);
        split(x1.x, vb[2 * p][1], vs[2 * p][1]);
        split(x0.y, vb[2 * p + 1][0], vs[2 * p + 1][0]);
        split(x1.y, vb[2 * p + 1][1], vs[2 * p + 1][1]);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) mma_tf32(pv[n], ps, vb[n][0], vb[n][1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) mma_tf32(pv[n], pb, vs[n][0], vs[n][1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) mma_tf32(pv[n], pb, vb[n][0], vb[n][1]);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] = fmaf(acc[n][0], alpha0, pv[n][0]);
      acc[n][1] = fmaf(acc[n][1], alpha0, pv[n][1]);
      acc[n][2] = fmaf(acc[n][2], alpha1, pv[n][2]);
      acc[n][3] = fmaf(acc[n][3], alpha1, pv[n][3]);
    }
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float inv0 = EMIT_STATS ? 1.f : 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = EMIT_STATS ? 1.f : 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int p = 0; p < D / 16; ++p) {
    const int d = 16 * p + 4 * t;
    if (r0 < tq) {
      *reinterpret_cast<float4*>(out + ((size_t)bh * tq + r0) * D + d) =
          make_float4(acc[2 * p][0] * inv0, acc[2 * p + 1][0] * inv0, acc[2 * p][1] * inv0,
                      acc[2 * p + 1][1] * inv0);
    }
    if (r1 < tq) {
      *reinterpret_cast<float4*>(out + ((size_t)bh * tq + r1) * D + d) =
          make_float4(acc[2 * p][2] * inv1, acc[2 * p + 1][2] * inv1, acc[2 * p][3] * inv1,
                      acc[2 * p + 1][3] * inv1);
    }
  }
  if (EMIT_STATS && t == 0) {  // the four threads of a quad hold the same m and l
    if (r0 < tq) {
      m_out[(size_t)bh * tq + r0] = m0;
      l_out[(size_t)bh * tq + r0] = l0;
    }
    if (r1 < tq) {
      m_out[(size_t)bh * tq + r1] = m1;
      l_out[(size_t)bh * tq + r1] = l1;
    }
  }
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

// the instance for head_dim. This switch owns the set of head dims the body
// is instantiated at (ops/kernels/attention.py's HEAD_DIMS mirrors it, and a
// card test holds the two equal); any other D is refused, empty calls too
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
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K3. q, k, v, out: [B, H, T, D] f32 contiguous, D = head_dim in {64, 80,
// 128}; kv_mask: [B, T] uint8 or null.
extern "C" int act_flash_attention(const float* q, const float* k, const float* v,
                                   const uint8_t* kv_mask, float* out, int batch, int heads,
                                   int t, int head_dim, float scale, cudaStream_t stream) {
  return dispatch<false>(q, k, v, kv_mask, out, nullptr, nullptr, batch, heads, t, t, head_dim,
                         scale, stream);
}

// K5. q, out: [B, H, Tq, D]; k, v: [B, H, Tk, D]; m_out, l_out: [B, H, Tq];
// all f32 contiguous, D = head_dim in {64, 80, 128}; kv_mask: [B, Tk] uint8
// or null. Tk >= 1.
extern "C" int act_flash_attention_stats(const float* q, const float* k, const float* v,
                                         const uint8_t* kv_mask, float* out, float* m_out,
                                         float* l_out, int batch, int heads, int tq, int tk,
                                         int head_dim, float scale, cudaStream_t stream) {
  if (tk <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, k, v, kv_mask, out, m_out, l_out, batch, heads, tq, tk, head_dim,
                        scale, stream);
}
