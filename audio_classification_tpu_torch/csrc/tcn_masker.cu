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
// bound is that over 495 / 3 TFLOP/s: 1.15 ms (the SIMT f32 figure 2.84).
// The [f_len, H] intermediates add 4 passes a block (A writes h1; B reads
// h1 and writes h2; C reads h2): 3.9 GB, ~1.2 ms at 3.35 TB/s, partly under
// the products and in the 50 MB L2.
//
// Design (Hopper): a split launch, then three launches a TCN block on one
// stream.
//   S  split_kernel: every block's W_in and [W_res | W_skip] (int8
//      dequantised first) transposed to K-major ([N][K]: TF32 wgmma takes
//      no transpose) and split into big and small TF32 halves, both rounded
//      to nearest, once a call (the stack's 19 MB read, 38 MB written).
//   A  gemm_kernel<IN>: h1 = PReLU(x W_in + b_in), gLN-1 partial statistics
//   B  dwconv_kernel: gLN-1 apply + mask, staged once a source row in
//      shared memory (K2 bf16's form), 3-tap dilated depthwise conv, PReLU
//      -> h2, gLN-2 partial statistics (IEEE f32 SIMT, persistent over the
//      valid chunks of 128 rows x 64 channels)
//   C  gemm_kernel<OUT>: gLN-2 apply on the A fragments, [W_res | W_skip],
//      x += res + b_res in place, skips += skip + b_skip
// The GEMMs are K2 bf16's persistent kernels in float32: each CTA walks only
// valid (item, row tile, column tile) triples, in the static order of
// tcn.bf16_schedule, with a stride of the grid; the tile shape (one or two
// consumer warpgroups of 64 rows by 64 or 128 columns) and the grid are
// picked on the host (tcn.tf32_plan). One producer warp keeps a ring of
// NS = 4 stages full by TMA (128-byte swizzle, an mbarrier pair a stage); a
// stage is a 32-deep k-chunk of the A rows (raw float32, rows past F
// zero-filled) and of the weights' big and small halves. Each warp reads
// its A fragment of a k8 step from the stage by ldmatrix, applies gLN-2 in
// C (the IEEE operations of the mma.sync design: (x - mean) fma (gamma
// rstd) + beta; rows past f_len -> 0), splits it in registers (big rounded,
// small left for the product to truncate) and issues the step's three
// wgmma.mma_async m64nNk8 TF32 products (A small x B big, A big x B small,
// A big x B big); a k-chunk's twelve products run while the next chunk's
// fragments are formed (two chunks' fragments in registers; at 2 x 128 a
// producer warpgroup gives its registers to the consumers by setmaxnreg).
// Accumulation: every product of a tile adds into the wgmma accumulator:
// 5.8e-6 of max|skips| off the float64 twin at the flagship shape. k-chunks
// formed from zero and added in IEEE float32 were 6.4e-7 off but 0.2 ms
// slower (PERF.md). The epilogues write float2 pairs straight from the
// accumulators.
// Statistics, deterministic and two-pass grade: every GEMM A tile and every
// depthwise chunk reduces its own values (count, mean, M2 about the tile's
// mean, two passes over the values it holds in registers) and writes that
// partial; the launch's last CTA (a ticket a launch) merges the partials in
// a fixed order with Chan's formula in double and writes (mean, rstd). No
// float32 E[x^2] - mean^2, no atomics on the sums: two calls give identical
// bits.
// K2-s8: w_in, w_dw and [w_res | w_skip] arrive as int8 with one float32
// scale per block and out channel (vecs rows 8, 9; cvecs rows 2, 3). The
// split launch forms (float)q * scale with one rounding (__fmul_rn) before
// the split, the depthwise pass at its taps: everything after is the float
// path, so on a dequantised float copy of the stack the float entry point
// gives bit-identical output.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; scripts/tcn_masker_ab.py,
// PERF.md): 4.64 ms at the flagship shape (GEMM A 1.24, GEMM C 2.25, the
// depthwise pass 1.06 ms a call; share 0.25 of the bound) and, as K2-s8,
// 3.44 ms at the serving shape [8, 1999, 128] ragged. The GEMM launches
// run at 31-34% of the TF32 peak; splitting the weights in shared memory
// instead (a third less L2 traffic) and 64-column tiles were slower. The
// mma.sync design this replaces (m16n8k8 3xTF32, 128 x 128 blocks of 8
// warps, cp.async k-tiles restaged in fragment order, one block an SM)
// took 7.21 and 5.08 ms in the same call.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr float EPS = 1e-8f;  // GlobalLayerNorm eps
constexpr int NT = 256;       // threads a block, all three kernels
constexpr int MAX_K = 1024;   // H <= 1024: the gLN-2 coefficients
constexpr int IN = 0, OUT = 1;

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

struct Stats {
  float* part;        // [B, n_part, 3] partials (count, mean, m2)
  unsigned* tickets;  // [B + 1]: a launch's at B, 0 between launches
  float* out;         // [B, 4]: (mean, rstd) written at out + 4 b
  int n_part;
};

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

// ---------------------------------------------------------------------------
// float32 activations: act_tcn_masker / act_tcn_masker_s8 (design in the
// header). The tile walk, the gLN partials and their merge are K2 bf16's
// (b16::count_tiles, tile_at, consumer_sum, put_partial, merge_stats).
namespace t32 {

using b16::count_tiles;
using b16::NS;
using b16::ROW;
using b16::Scratch;
using b16::tile_at;
using b16::TILES;

constexpr int KC = 32;  // k-chunk of a stage: one 128-byte swizzled row of float32

// A GEMM's tile: NWG consumer warpgroups of 64 rows by BN columns, and a
// producer warp; a stage holds a 32-deep k-chunk of the A rows (raw
// float32) and of the weights' big and small TF32 halves (K-major). A
// consumer thread holds BN / 2 accumulators and two k-chunks' A fragments
// (64 registers); at 2 x 128 that passes the 168 registers a thread of
// nine warps, so the producer is a warpgroup whose registers go to the
// consumers (setmaxnreg: 232 a consumer thread)
template <int NWG, int BN>
struct Cfg {
  static constexpr int BM = 64 * NWG;
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr bool PRODUCER_WG = NWG == 2 && BN == 128;
  static constexpr int THREADS = CONSUMERS + (PRODUCER_WG ? 128 : 32);
  static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;
  static constexpr int A_BYTES = BM * ROW;
  static constexpr int B_BYTES = BN * ROW;  // one half
  static constexpr int STAGE = A_BYTES + 2 * B_BYTES;
  static constexpr size_t SMEM = 1024 + (size_t)NS * STAGE + sizeof(Scratch);
};

struct GemmArgs {
  const int* f_len;    // [B]
  const float* vecs;   // this block's [8+, H]
  const float* cvecs;  // this block's [2+, C]
  Stats st;            // IN: gLN-1 partials, out = stats + 0; OUT reads stats + 2
  const float* x_in;   // OUT: [B, F, C]
  float* x_out;        // OUT: [B, F, C] (may be x_in: each element is read and then
                       // written by one thread)
  float* skips;        // OUT: [B, F, C]
  float* h1;           // IN: [B, F, H]
  int batch, f, k, n, c, blk, nb;
};

// A (MODE IN): h1 = PReLU(x W_in + b_in) + gLN-1 partials. C (MODE OUT):
// gLN-2(h2) [W_res | W_skip] into x and skips. ta: the A rows [B, F, K] in
// boxes {32, BM}; tw: the split weights [2 NB, N, K] (big halves, then
// small) in boxes {32, BN}.
template <int MODE, int NWG, int BN>
__global__ void __launch_bounds__(Cfg<NWG, BN>::THREADS, Cfg<NWG, BN>::MIN_BLOCKS)
    gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                const GemmArgs p) {
  using T = Cfg<NWG, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = act::smem_u32(smem_raw);
  unsigned char* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // the swizzle's 1024 B
  const uint32_t ring_s = act::smem_u32(ring);
  Scratch& sc = *reinterpret_cast<Scratch*>(ring + NS * T::STAGE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // k-chunks in pairs, so that the main loop has one path (a wait whose
  // commit group depends on the path serializes every wgmma): an odd count
  // (C % 64 == 32 in GEMM A) takes one more chunk, past K, which TMA fills
  // with zeros
  const int n_ct = p.n / BN, n_kc = (p.k / KC + 1) & ~1;
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

  if (warp >= 4 * NWG) {  // the producer warp: one thread keeps the ring full
    if constexpr (T::PRODUCER_WG) {
      act::setmaxnreg_dec<40>();
      if (warp != 4 * NWG) return;
    }
    if (lane == 0) {
      act::tma_prefetch_map(&ta);
      act::tma_prefetch_map(&tw);
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const b16::Tile tl = tile_at(t, p.f_len, T::BM, n_ct);
        for (int kc = 0; kc < n_kc; ++kc) {
          const uint32_t full = act::smem_u32(&sc.full[s]), st = ring_s + s * T::STAGE;
          act::mbar_wait(act::smem_u32(&sc.empty[s]), ph ^ 1);
          act::mbar_arrive_expect_tx(full, T::STAGE);
          act::tma_load_3d(st, &ta, full, kc * KC, tl.rt * T::BM, tl.b);
          act::tma_load_3d(st + T::A_BYTES, &tw, full, kc * KC, tl.ct * BN, p.blk);
          act::tma_load_3d(st + T::A_BYTES + T::B_BYTES, &tw, full, kc * KC, tl.ct * BN,
                           p.nb + p.blk);
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
  if constexpr (T::PRODUCER_WG) act::setmaxnreg_inc<232>();
  const int wg = warp >> 2, g = lane >> 2, tg = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3);
  float acc[BN / 2];
  uint32_t fb[2][KC / 8][4], fs[2][KC / 8][4];  // two k-chunks' A fragments: big, small
  int s = 0, s_prev = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const b16::Tile tl = tile_at(t, p.f_len, T::BM, n_ct);
    const int m0 = tl.rt * T::BM, n0 = tl.ct * BN;
    float mean = 0.f, rstd = 0.f;
    if constexpr (MODE == OUT) {
      mean = p.st.out[4 * tl.b + 2];
      rstd = p.st.out[4 * tl.b + 3];
    }
    // k-chunk kc: this warp's A fragments, a k8 step at a time, into (ab,
    // as) (the registers of the chunk before last, whose products are
    // done): ldmatrix on the swizzled rows (a0 row g k t, a1 row g + 8, a2 k
    // t + 4, a3 both), the gLN-2 apply in C (rows past f_len -> 0), the
    // split into big and small; each step's three products (the small cross
    // terms, then big x big) are issued at once, and the chunk's twelve
    // commit as one group. Then the wait for the previous chunk's group (one
    // chunk in flight), whose stage goes back to the producer.
    auto chunk = [&](int kc, uint32_t(&ab)[KC / 8][4], uint32_t(&as)[KC / 8][4],
                     uint32_t(&pb)[KC / 8][4], uint32_t(&psm)[KC / 8][4]) {
      act::mbar_wait(act::smem_u32(&sc.full[s]), ph);
      const uint32_t st = ring_s + s * T::STAGE, bb = st + T::A_BYTES, bs = bb + T::B_BYTES;
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        const int row = r0 + (lane & 15), ch = 2 * ks + (lane >> 4);
        uint32_t a[4];
        act::ldsm_x4(a, st + row * ROW + ((ch ^ (row & 7)) << 4));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = __uint_as_float(a[e]);
          if constexpr (MODE == OUT) {
            const int k = kc * KC + 8 * ks + tg + 4 * (e >> 1);
            v = m0 + r0 + g + 8 * (e & 1) < tl.fl
                    ? fmaf(v - mean, sc.gsc[k] * rstd, sc.gsc[p.k + k])
                    : 0.f;
          }
          act::split_fast(v, ab[ks][e], as[ks][e]);
        }
        const uint32_t off = 32 * ks;
        act::wgmma_fence();
        act::wgmma_tf32_rs<BN>(acc, as[ks], act::desc_sw128(bb + off, 16, 1024), kc > 0 || ks > 0);
        act::wgmma_tf32_rs<BN>(acc, ab[ks], act::desc_sw128(bs + off, 16, 1024), 1);
        act::wgmma_tf32_rs<BN>(acc, ab[ks], act::desc_sw128(bb + off, 16, 1024), 1);
      }
      act::wgmma_commit();
      act::wgmma_wait<1>();
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {  // live until the products that read them are done
        act::fence_regs(pb[ks]);
        act::fence_regs(psm[ks]);
      }
      if (kc > 0) {
        __syncwarp();
        if (lane == 0) act::mbar_arrive(act::smem_u32(&sc.empty[s_prev]));  // the stage is read
      }
      s_prev = s;
      if (++s == NS) {
        s = 0;
        ph ^= 1;
      }
    };
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    act::fence_operands(acc);
    for (int kc = 0; kc < n_kc; kc += 2) {
      chunk(kc, fb[0], fs[0], fb[1], fs[1]);
      chunk(kc + 1, fb[1], fs[1], fb[0], fs[0]);
    }
    act::wgmma_wait<0>();
    act::fence_operands(acc);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        act::fence_regs(fb[h][ks]);
        act::fence_regs(fs[h][ks]);
      }
    __syncwarp();
    if (lane == 0) act::mbar_arrive(act::smem_u32(&sc.empty[s_prev]));  // the last stage is read

    // thread holds rows g (acc 4 j + 0, 1) and g + 8 (4 j + 2, 3) of its
    // warp's 16, columns 8 j + 2 tg, + 1
    if constexpr (MODE == IN) {
      const float a1 = p.vecs[p.n];  // vecs row 1: PReLU alpha (N = H)
      float* h1 = p.h1 + ((size_t)tl.b * p.f + m0) * p.n + n0;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * tg;
        const float2 bias = ld2(p.vecs + n0 + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + g + 8 * hh;
          float v0 = acc[4 * j + 2 * hh] + bias.x, v1 = acc[4 * j + 2 * hh + 1] + bias.y;
          v0 = v0 >= 0.f ? v0 : a1 * v0;
          v1 = v1 >= 0.f ? v1 : a1 * v1;
          acc[4 * j + 2 * hh] = v0;
          acc[4 * j + 2 * hh + 1] = v1;
          if (m0 + r < tl.fl) {
            *reinterpret_cast<float2*>(h1 + (size_t)r * p.n + col) = make_float2(v0, v1);
            sum += v0 + v1;
          }
        }
      }
      // two passes over the tile's valid values, held in acc
      const float cnt = (float)(min(T::BM, tl.fl - m0) * BN);
      const float mu = b16::consumer_sum<NWG>(sum, sc.red) / cnt;
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
      q = b16::consumer_sum<NWG>(q, sc.red);
      if (tid == 0) b16::put_partial(cnt, mu, q, p.st, tl.b, tl.rt * n_ct + tl.ct);
    } else {
      // columns [0, C) are W_res's (into x), [C, 2 C) W_skip's (into skips):
      // (prev + product) + bias, cvecs rows 0, 1
      const int c = p.c;
      const size_t base = ((size_t)tl.b * p.f + m0) * c;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * tg;
        const bool res = col < c;
        const int cc = res ? col : col - c;
        const float2 bias = ld2(p.cvecs + (res ? 0 : c) + cc);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = r0 + g + 8 * hh;
          if (m0 + r >= tl.fl) continue;
          const size_t o = base + (size_t)r * c + cc;
          const float2 prev = res ? ld2(p.x_in + o) : ld2(p.skips + o);
          *reinterpret_cast<float2*>((res ? p.x_out : p.skips) + o) =
              make_float2((prev.x + acc[4 * j + 2 * hh]) + bias.x,
                          (prev.y + acc[4 * j + 2 * hh + 1]) + bias.y);
        }
      }
    }
  }
  if constexpr (MODE == IN) b16::merge_stats<NWG>(p.st, p.f_len, p.batch, T::BM, n_ct, sc);
}

// B at float32, persistent (K2 bf16's staged form): each CTA walks chunks
// of DR rows by DW channels (b16::tile_at's order over the grid, rows below
// f_len only). A chunk first stages y = (h1 - mean) rstd fma g1 + be1 (0
// outside [0, f_len)) in shared memory, once a source row (the rows its
// taps read, b16::staged_src), then thread (row lane rl, channel group cg)
// forms channels 4 cg .. + 3 of rows rl + 16 v, v < 8: the taps in order t
// = 0, 1, 2 by fmaf from 0 (an out-of-range tap adds y = 0 exactly), + b_dw,
// PReLU; and the chunk's gLN-2 partial (two passes over the values it
// holds). The partials merge once a launch (b16::merge_stats). int8 taps
// are dequantised as dequant_stack does.
constexpr int DR = b16::DR, DW = b16::DW;
constexpr int SU = 4;  // staged 16-byte items a thread in flight
constexpr size_t DW_SMEM = 3 * DR * DW * sizeof(float) + sizeof(Scratch);

template <class W>
__global__ void __launch_bounds__(NT, 2)
    dwconv_kernel(const float* __restrict__ h1, const int* __restrict__ f_len,
                  const W* __restrict__ w_dw, const float* __restrict__ vecs,
                  const float* __restrict__ gln1, float* __restrict__ h2, Stats st, int batch,
                  int f, int hd, int dil) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  float* ys = reinterpret_cast<float*>(dw_smem);
  Scratch& sc = *reinterpret_cast<Scratch*>(dw_smem + 3 * DR * DW * sizeof(float));
  const int tid = threadIdx.x, cg = tid % (DW / 4), rl = tid / (DW / 4);
  const int n_cs = hd / DW, total = count_tiles(f_len, batch, DR, n_cs);
  const int n_src = dil <= DR ? DR + 2 * dil : 3 * DR;
  const float a2 = vecs[5 * hd];  // PReLU slope
  const float* sc_dw = vecs + 9 * hd;  // int8 scales of w_dw (unused for float)
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const b16::Tile tl = tile_at(t, f_len, DR, n_cs);
    const int r0 = tl.rt * DR, c0 = tl.ct * DW, fl = tl.fl;
    const float mean = gln1[4 * tl.b], rstd = gln1[4 * tl.b + 1];
    const float* hb = h1 + (size_t)tl.b * f * hd + c0;
    // stage the taps' rows: item q = (row s, 16-byte chunk), DW / 4 a row,
    // SU items a thread at a time, all loads before any use; a thread's
    // items share its chunk (NT % (DW / 4) == 0), so gLN-1's gamma and beta
    // for them are loaded once
    const int se = 4 * (tid % (DW / 4));
    const float4 g1 = ld4(vecs + 2 * hd + c0 + se), be1 = ld4(vecs + 3 * hd + c0 + se);
    for (int q0 = tid; q0 < n_src * (DW / 4); q0 += SU * NT) {
      float4 raw[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int q = q0 + u * NT, src = b16::staged_src(q / (DW / 4), r0, dil);
        raw[u] = q < n_src * (DW / 4) && src >= 0 && src < fl ? ld4(hb + (size_t)src * hd + se)
                                                               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int q = q0 + u * NT, s_ = q / (DW / 4), src = b16::staged_src(s_, r0, dil);
        if (q >= n_src * (DW / 4)) break;
        float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
        if (src >= 0 && src < fl) {  // gLN-1 then the mask: rows past f_len are 0
          y = make_float4(fmaf((raw[u].x - mean) * rstd, g1.x, be1.x),
                          fmaf((raw[u].y - mean) * rstd, g1.y, be1.y),
                          fmaf((raw[u].z - mean) * rstd, g1.z, be1.z),
                          fmaf((raw[u].w - mean) * rstd, g1.w, be1.w));
        }
        *reinterpret_cast<float4*>(ys + s_ * DW + se) = y;
      }
    }
    __syncthreads();
    const int ch = c0 + 4 * cg;
    float4 tap[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const W* wt = w_dw + k * hd + ch;
      tap[k] = make_float4(weight(wt[0], sizeof(W) == 1 ? sc_dw[ch] : 0.f),
                           weight(wt[1], sizeof(W) == 1 ? sc_dw[ch + 1] : 0.f),
                           weight(wt[2], sizeof(W) == 1 ? sc_dw[ch + 2] : 0.f),
                           weight(wt[3], sizeof(W) == 1 ? sc_dw[ch + 3] : 0.f));
    }
    const float4 bdw = ld4(vecs + 4 * hd + ch);
    float4 val[DR / 16];
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < DR / 16; ++v) {
      const int i = rl + 16 * v;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 y =
            *reinterpret_cast<const float4*>(ys + b16::staged_row(i, k, dil) * DW + 4 * cg);
        acc = make_float4(fmaf(y.x, tap[k].x, acc.x), fmaf(y.y, tap[k].y, acc.y),
                          fmaf(y.z, tap[k].z, acc.z), fmaf(y.w, tap[k].w, acc.w));
      }
      acc = make_float4(acc.x + bdw.x, acc.y + bdw.y, acc.z + bdw.z, acc.w + bdw.w);
      acc.x = acc.x >= 0.f ? acc.x : a2 * acc.x;
      acc.y = acc.y >= 0.f ? acc.y : a2 * acc.y;
      acc.z = acc.z >= 0.f ? acc.z : a2 * acc.z;
      acc.w = acc.w >= 0.f ? acc.w : a2 * acc.w;
      if (r0 + i < fl) {
        *reinterpret_cast<float4*>(h2 + ((size_t)tl.b * f + r0 + i) * hd + ch) = acc;
        sum += (acc.x + acc.y) + (acc.z + acc.w);
      }
      val[v] = acc;
    }
    // the chunk's partial, two passes over the values held in val; the
    // barriers also free ys for the next chunk
    const float cnt = (float)(min(DR, fl - r0) * DW);
    const float mu = b16::consumer_sum<2>(sum, sc.red) / cnt;
    float q = 0.f;
#pragma unroll
    for (int v = 0; v < DR / 16; ++v) {
      if (r0 + rl + 16 * v < fl) {
        const float dx = val[v].x - mu, dy = val[v].y - mu, dz = val[v].z - mu,
                    dw = val[v].w - mu;
        q = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, fmaf(dw, dw, q))));
      }
    }
    q = b16::consumer_sum<2>(q, sc.red);
    if (tid == 0) b16::put_partial(cnt, mu, q, st, tl.b, tl.rt * n_cs + tl.ct);
  }
  b16::merge_stats<2>(st, f_len, batch, DR, n_cs, sc);
}

// The weights of every TCN block, float or int8 (dequantised as
// dequant_stack does: (float)q * scale, one rounding), transposed to
// K-major and split into big and small TF32 halves (both rounded to
// nearest: big + small is the weight within 2^-22 of it), once a call, into
// out: W_in as [2][NB][H][C], then [W_res | W_skip] as [2][NB][2 C][H] (the
// big halves of every block, then the small halves). A block transposes one 32 x
// 32 tile of one block's matrix through shared memory (blockIdx.z: the
// block, then the matrix: W_in, W_res, W_skip).
template <class W>
__global__ void __launch_bounds__(256)
    split_kernel(const W* __restrict__ w_in, const W* __restrict__ w_res,
                 const W* __restrict__ w_skip, const float* __restrict__ vecs,
                 const float* __restrict__ cvecs, int vrows, int crows, float* __restrict__ out,
                 int c, int hd, int nb) {
  __shared__ float tile[32][33];
  const int blk = blockIdx.z % nb, mat = blockIdx.z / nb;
  // the source matrix [rows][cols] (cols: the out channels, whose scales
  // apply), and where its transpose [cols][rows] goes in each half
  const int rows = mat == 0 ? c : hd, cols = mat == 0 ? hd : c;
  const W* src = (mat == 0 ? w_in : mat == 1 ? w_res : w_skip) + (size_t)blk * rows * cols;
  const float* scale = mat == 0 ? vecs + ((size_t)blk * vrows + 8) * hd
                                : cvecs + ((size_t)blk * crows + mat + 1) * c;
  // out: W_in big [NB][H][C], W_in small, [W_res | W_skip] big [NB][2 C][H], small
  const size_t half = (size_t)nb * (mat == 0 ? 1 : 2) * c * hd;
  float* dst = mat == 0
                   ? out + (size_t)blk * hd * c
                   : out + (size_t)2 * nb * hd * c + ((size_t)blk * 2 * c + (mat - 1) * c) * hd;
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  if (c0 >= cols || r0 >= rows) return;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += 8) {
    tile[i][tx] = weight(src[(size_t)(r0 + i) * cols + c0 + tx],
                         sizeof(W) == 1 ? scale[c0 + tx] : 0.f);
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    uint32_t big, small;
    act::split(tile[tx][i], big, small);
    const size_t o = (size_t)(c0 + i) * rows + r0 + tx;
    dst[o] = __uint_as_float(big);
    dst[half + o] = __uint_as_float(small);
  }
}

template <int MODE, int NWG, int BN>
cudaError_t launch_cfg(int grid, const CUtensorMap& ta, const CUtensorMap& tw, const GemmArgs& p,
                       cudaStream_t stream) {
  static std::atomic<uint64_t> raised{0};  // the shared-memory cap, once per device
  const cudaError_t e =
      act::allow_dynamic_smem(reinterpret_cast<const void*>(gemm_kernel<MODE, NWG, BN>), raised);
  if (e != cudaSuccess) return e;
  gemm_kernel<MODE, NWG, BN><<<grid, Cfg<NWG, BN>::THREADS, Cfg<NWG, BN>::SMEM, stream>>>(ta, tw,
                                                                                          p);
  return cudaGetLastError();
}

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

// The launches of a call for weights of type W: the split copy of the
// stack into wsp (NB 2 (C H + 2 H C) floats), then per TCN block GEMM A in
// tile shape cfg_in on grid_in CTAs, the depthwise pass, GEMM C in cfg_out
// on grid_out (tcn.tf32_plan); vecs has vrows rows a block and cvecs crows
// (8 and 2, or 10 and 4 with the int8 scales).
template <class W>
int run_masker(const float* x, const int* f_len, const W* w_in, const W* w_dw,
               const float* vecs, const W* w_res, const W* w_skip, const float* cvecs,
               float* wsp, float* xs, float* h1, float* h2, float* stats, float* part,
               unsigned* tickets, float* skips, int batch, int f, int c, int hd, int n_blocks,
               int n_per_repeat, int n_part, int cfg_in, int grid_in, int cfg_out, int grid_out,
               int grid_dw, int vrows, int crows, cudaStream_t stream) {
  if (c <= 0 || hd <= 0 || c % 32 != 0 || hd % 64 != 0 || 1024 % hd != 0 || n_per_repeat <= 0 ||
      cfg_in < 0 || cfg_in > 2 || cfg_out < 0 || cfg_out > 2 || grid_in <= 0 || grid_out <= 0 ||
      grid_dw <= 0)
    return (int)cudaErrorInvalidValue;
  const int bm_in = 64 * TILES[cfg_in][0], bn_in = TILES[cfg_in][1];
  const int bm_out = 64 * TILES[cfg_out][0], bn_out = TILES[cfg_out][1];
  if (hd % bn_in != 0 || 2 * c % bn_out != 0 ||
      n_part < ((f + bm_in - 1) / bm_in) * (hd / bn_in) || n_part < (f + DR - 1) / DR * (hd / DW))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = cudaMemsetAsync(skips, 0, sizeof(float) * (size_t)batch * f * c, stream)) != cudaSuccess)
    return (int)e;
  if (batch <= 0 || f <= 0 || n_blocks <= 0) return 0;
  // the launch's ticket (tickets[batch]; the rest unused)
  if ((e = cudaMemsetAsync(tickets, 0, sizeof(unsigned) * (batch + 1), stream)) != cudaSuccess)
    return (int)e;
  const dim3 g_split((max(c, hd) + 31) / 32, (max(c, hd) + 31) / 32, 3 * n_blocks);
  split_kernel<W><<<g_split, 256, 0, stream>>>(w_in, w_res, w_skip, vecs, cvecs, vrows, crows, wsp,
                                               c, hd, n_blocks);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // the A rows in boxes of {32 k, BM rows}; the split stacks [2 NB, N, K]
  // in {32 k, BN n}
  const float* w_rs = wsp + (size_t)2 * n_blocks * hd * c;
  CUtensorMap m_x, m_xs, m_h2, m_in, m_rs;
  if ((e = act::tmap_3d_f32(&m_x, x, c, f, batch, bm_in)) != cudaSuccess ||
      (e = act::tmap_3d_f32(&m_xs, xs, c, f, batch, bm_in)) != cudaSuccess ||
      (e = act::tmap_3d_f32(&m_h2, h2, hd, f, batch, bm_out)) != cudaSuccess ||
      (e = act::tmap_3d_f32(&m_in, wsp, c, hd, 2 * n_blocks, bn_in)) != cudaSuccess ||
      (e = act::tmap_3d_f32(&m_rs, w_rs, hd, 2 * c, 2 * n_blocks, bn_out)) != cudaSuccess)
    return (int)e;
  static std::atomic<uint64_t> dw_raised{0};
  if ((e = act::allow_dynamic_smem(reinterpret_cast<const void*>(dwconv_kernel<W>), dw_raised)) !=
      cudaSuccess)
    return (int)e;
  const float* cur = x;
  for (int i = 0; i < n_blocks; ++i) {
    const float* vv = vecs + (size_t)i * vrows * hd;
    const float* cv = cvecs + (size_t)i * crows * c;
    float* sti = stats + (size_t)i * batch * 4;
    const GemmArgs pa{f_len, vv, cv, Stats{part, tickets, sti, n_part}, nullptr, nullptr, nullptr,
                      h1, batch, f, c, hd, c, i, n_blocks};
    if ((e = launch_gemm<IN>(cfg_in, grid_in, i == 0 ? m_x : m_xs, m_in, pa, stream)) !=
        cudaSuccess)
      return (int)e;
    dwconv_kernel<W><<<grid_dw, NT, DW_SMEM, stream>>>(
        h1, f_len, w_dw + (size_t)i * 3 * hd, vv, sti, h2, Stats{part, tickets, sti + 2, n_part},
        batch, f, hd, 1 << (i % n_per_repeat));
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const GemmArgs pc{f_len, vv, cv, Stats{part, tickets, sti, n_part}, cur, xs, skips, nullptr,
                      batch, f, hd, 2 * c, c, i, n_blocks};
    if ((e = launch_gemm<OUT>(cfg_out, grid_out, m_h2, m_rs, pc, stream)) != cudaSuccess)
      return (int)e;
    cur = xs;  // x is read only; the residual stream lives in xs from block 0 on
  }
  return 0;
}

}  // namespace t32

}  // namespace

// x: [B, F, C] input (read only); f_len: [B] int32 in [0, F]; per-block
// stacks w_in [NB, C, H], w_dw [NB, 3, H], vecs [NB, 8, H], w_res and
// w_skip [NB, H, C], cvecs [NB, 2, C]. Scratch: wsp NB 2 (C H + 2 H C)
// floats (the split copy of the stack), xs [B, F, C], h1, h2 [B, F, H],
// stats [NB, B, 4], part [B, n_part, 3] with n_part >= 2 ceil(F / 128) H /
// 64, tickets [B + 1] (uint32). cfg_in and cfg_out: the tile shapes of GEMM
// A and C (0, 1, 2: 2 x 128, 2 x 64, 1 x 64 warpgroups x columns; the
// columns divide H and 2 C), grid_in and grid_out their persistent grids,
// grid_dw the depthwise pass's (tcn.tf32_plan). Output: skips [B, F, C],
// rows past f_len exactly 0.
// C % 32 == 0, H % 64 == 0 and H divides 1024.
extern "C" int act_tcn_masker(const float* x, const int* f_len, const float* w_in,
                              const float* w_dw, const float* vecs, const float* w_res,
                              const float* w_skip, const float* cvecs, float* wsp, float* xs,
                              float* h1, float* h2, float* stats, float* part, unsigned* tickets,
                              float* skips, int batch, int f, int c, int hd, int n_blocks,
                              int n_per_repeat, int n_part, int cfg_in, int grid_in, int cfg_out,
                              int grid_out, int grid_dw, cudaStream_t stream) {
  return t32::run_masker<float>(x, f_len, w_in, w_dw, vecs, w_res, w_skip, cvecs, wsp, xs, h1, h2,
                                stats, part, tickets, skips, batch, f, c, hd, n_blocks,
                                n_per_repeat, n_part, cfg_in, grid_in, cfg_out, grid_out, grid_dw,
                                8, 2, stream);
}

// The int8 weight stream: w_in, w_dw, w_res, w_skip as int8 in the same
// layouts; vecs [NB, 10, H] with the scales of w_in and w_dw in rows 8, 9;
// cvecs [NB, 4, C] with the scales of W_res and W_skip in rows 2, 3.
// Everything else as act_tcn_masker.
extern "C" int act_tcn_masker_s8(const float* x, const int* f_len, const int8_t* w_in,
                                 const int8_t* w_dw, const float* vecs, const int8_t* w_res,
                                 const int8_t* w_skip, const float* cvecs, float* wsp, float* xs,
                                 float* h1, float* h2, float* stats, float* part,
                                 unsigned* tickets, float* skips, int batch, int f, int c, int hd,
                                 int n_blocks, int n_per_repeat, int n_part, int cfg_in,
                                 int grid_in, int cfg_out, int grid_out, int grid_dw,
                                 cudaStream_t stream) {
  return t32::run_masker<int8_t>(x, f_len, w_in, w_dw, vecs, w_res, w_skip, cvecs, wsp, xs, h1,
                                 h2, stats, part, tickets, skips, batch, f, c, hd, n_blocks,
                                 n_per_repeat, n_part, cfg_in, grid_in, cfg_out, grid_out, grid_dw,
                                 10, 4, stream);
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

