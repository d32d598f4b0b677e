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
// (scripts/mma_tf32_peak.py), a ceiling of 3.30 ms for an mma.sync design.
//
// Design (Hopper): 3xTF32 on warpgroup products (wgmma.mma_async m64nNk8
// TF32, float32 accumulators) fed by TMA, in two launches a call.
//   S  the split launch (attention_wgmma.cuh tf32_split, shared with K3 /
//      K5): k split into big and small TF32 halves ([2][B][T][Dqk]) and v
//      transposed to [2][B][De][Tp] (Tp = T rounded up to 8), split the same
//      way, its keys permuted inside each group of 8 (position i holds key
//      2 i, position i + 4 key 2 i + 1; zero past T). TF32 wgmma takes no
//      transpose, so p v needs v K-major over the keys; a B operand comes
//      from shared memory, so its halves are two tiles there.
//   K  gau_kernel: a block is two consumer warpgroups of 64 query rows (128
//      rows sharing each K / V tile) and one DV = 192-wide chunk of the De
//      output columns (grid z), with a producer warpgroup whose registers go
//      to the consumers (setmaxnreg: 232 a consumer thread). The producer
//      loads the block's q rows once (raw float32, {32 d, 128 rows} boxes),
//      then walks the live key tiles of 32 keys (a tile whose keys are all
//      masked adds exactly 0 and is skipped), loading k's and v's halves into
//      a ring of two stages with the keys' 0 / 1 mask beside them; a stage
//      whose tile index is -1 ends the walk. Per key tile, each consumer
//      warpgroup forms s = q k^T over Dqk in groups of 32 dims: q's A
//      fragments read by ldmatrix and split in registers (big rounded, small
//      left for the product to truncate), three products a k8 step (q small x
//      k big, q big x k small, q big x k big), one group's products in flight
//      while the next group's fragments are formed. p = relu(s * scale *
//      mask)^2 in float32 in the TPU body's order, split in registers: the
//      m64n32 accumulator of a warp (rows g, g + 8, keys 8 j + 2 t, + 1) is p
//      v's A fragment of k8 step j under the key permutation above, so p
//      never leaves the registers. p v runs in two slices of 96 columns, each
//      tile's products formed from zero in a second accumulator and added to
//      the running sum in IEEE float32 (one accumulator over every key was
//      8.4e-5 of max|out| off the float64 twin at 11999 keys and 2.5e-4 at
//      31999, over the 1e-4 limit; PERF.md).
// Shared memory: q 64 KB, two stages of k (2 x 16 KB) and v (2 x 24 KB):
// 225 KB, one block an SM. Scores are formed once per 192-column chunk:
// (4 x 128 + 768) / (128 + 768) = 1.43x the minimum products at De 768.
// No sum crosses a block, so two calls give identical bits; a fully masked
// item computes no tile and writes zeros.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; scripts/gau_attention_ab.py
// --f32, graph replay, PERF.md): 4.29-4.33 ms at [1, 15999, 128 | 768] with
// 11999 keys valid (share 0.48), 22.4 at [1, 31999], 0.130 at [3, 1237]
// ragged; registers 168 (232 a consumer thread by setmaxnreg), no spills.
// Each of the 4 column chunks forms the scores: sharing them across the
// chunks is the next lever. Splitting k and v in shared memory
// instead of in device memory was slower (5.19 ms). The mma.sync design
// this replaces (m16n8k8 3xTF32, 64 rows x 384 columns a block in clusters
// of 2 sharing the scores through distributed shared memory, 255
// registers, 16 bytes spilled) took 6.90, 36.2 and 0.193-0.196 ms in the
// same call.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "attention_wgmma.cuh"  // the bf16 body (namespace b16); wgmma_tma.cuh
#include "tf32_mma.cuh"

namespace {

constexpr int MAX_DQK = 128;

namespace t32 {

using act::smem_u32;

constexpr int BK = 32;                      // keys a tile
constexpr int NWG = 2;                      // consumer warpgroups: 64 query rows each
constexpr int BM = 64 * NWG;                // query rows a block
constexpr int DV = 192;                     // output columns a block
constexpr int SL = DV / 2;                  // columns of a p v slice
constexpr int ROW = 128;                    // bytes of a swizzled row: 32 floats
constexpr int NDG = MAX_DQK / 32;           // dim groups of q and k (32 dims each)
constexpr int Q_BYTES = NDG * BM * ROW;     // q: NDG boxes of {32 d, BM rows}
constexpr int K_HALF = NDG * BK * ROW;      // k big or small: NDG boxes of {32 d, BK keys}
constexpr int V_HALF = DV * ROW;            // v^T big or small: {32 keys, DV columns}
constexpr int SLOT = 2 * K_HALF + 2 * V_HALF;
constexpr int NS = 2;                       // stages of the ring
constexpr int THREADS = 128 * NWG + 128;    // + the producer warpgroup
constexpr size_t SMEM = 1024 + (size_t)Q_BYTES + NS * SLOT + sizeof(float) * NS * BK +
                        sizeof(int) * NS + sizeof(uint64_t) * (2 * NS + 1);
constexpr unsigned FULL = 0xffffffffu;

// The launch: grid (row blocks, items, column chunks) of THREADS threads
struct Plan {
  int gx, gy, gz;
};
inline Plan plan(int batch, int t, int de) {
  return Plan{(t + BM - 1) / BM, batch, (de + DV - 1) / DV};
}

// K: mq q [B, T, Dqk] in boxes {32, BM}; mk the split k [2 B, T, Dqk] in
// {32, BK}; mv the split v^T [2 B, De, Tp] in {32, DV}
__global__ void __launch_bounds__(THREADS, 1)
    gau_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, const uint8_t* __restrict__ kv_mask,
               float* __restrict__ out, int batch, int t, int dqk, int de, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // the swizzle's 1024 B
  const uint32_t q_s = smem_u32(base), ring = q_s + Q_BYTES;
  float* coef = reinterpret_cast<float*>(base + Q_BYTES + NS * SLOT);  // [NS][BK]
  int* tile_of = reinterpret_cast<int*>(coef + NS * BK);               // [NS]: -1 ends
  uint64_t* bars = reinterpret_cast<uint64_t*>(tile_of + NS);          // full[NS], empty[NS], q
  const uint32_t full = smem_u32(bars), empty = full + 8 * NS, qbar = full + 16 * NS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int item = blockIdx.y, row0 = blockIdx.x * BM, c0 = blockIdx.z * DV;
  // dim groups of 32 in pairs, so that the score loop has one path (a
  // wait whose commit group depends on the path serializes every wgmma):
  // q's and k's boxes past Dqk are zero-filled by TMA
  const int n_dg = ((dqk + 31) / 32 + 1) & ~1, n_tiles = (t + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      act::mbar_init(full + 8 * s, 32);        // the producer's 32 lanes (lane 0 with the bytes)
      act::mbar_init(empty + 8 * s, 4 * NWG);  // lane 0 of each consumer warp
    }
    act::mbar_init(qbar, 1);
    act::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // the producer warpgroup: its first warp loads
    act::setmaxnreg_dec<40>();
    if (warp != 4 * NWG) return;
    const uint8_t* mrow = kv_mask ? kv_mask + (size_t)item * t : nullptr;
    if (lane == 0) {
      act::tma_prefetch_map(&mq);
      act::tma_prefetch_map(&mk);
      act::tma_prefetch_map(&mv);
      act::mbar_arrive_expect_tx(qbar, n_dg * BM * ROW);
      for (int dg = 0; dg < n_dg; ++dg) {
        act::tma_load_3d(q_s + dg * BM * ROW, &mq, qbar, 32 * dg, row0, item);
      }
    }
    int s = 0;
    uint32_t ph = 0;
    for (int tile = 0;; ++tile) {
      // the next live tile: a key of it below T and unmasked (lane = key)
      bool valid = false;
      for (; tile < n_tiles; ++tile) {
        const int j = tile * BK + lane;
        valid = j < t && (mrow == nullptr || mrow[j] != 0);
        if (__any_sync(FULL, valid)) break;
      }
      act::mbar_wait(empty + 8 * s, ph ^ 1);
      const uint32_t bar = full + 8 * s;
      if (tile < n_tiles) {
        coef[s * BK + lane] = valid ? 1.f : 0.f;
        if (lane == 0) {
          tile_of[s] = tile;
          const uint32_t st = ring + s * SLOT;
          act::mbar_arrive_expect_tx(bar, 2 * n_dg * BK * ROW + 2 * V_HALF);
          for (int dg = 0; dg < n_dg; ++dg) {
            act::tma_load_3d(st + dg * BK * ROW, &mk, bar, 32 * dg, tile * BK, item);
            act::tma_load_3d(st + K_HALF + dg * BK * ROW, &mk, bar, 32 * dg, tile * BK,
                             batch + item);
          }
          act::tma_load_3d(st + 2 * K_HALF, &mv, bar, tile * BK, c0, item);
          act::tma_load_3d(st + 2 * K_HALF + V_HALF, &mv, bar, tile * BK, c0, batch + item);
        } else {
          act::mbar_arrive(bar);
        }
      } else {  // the end of the walk
        if (lane == 0) tile_of[s] = -1;
        __syncwarp();
        act::mbar_arrive(bar);
        break;
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
  act::setmaxnreg_inc<232>();
  const int wg = warp >> 2, g = lane >> 2, tq = lane & 3;
  const int qrow = 64 * wg + 16 * (warp & 3) + (lane & 15);  // this lane's ldmatrix row
  float o[2][SL / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < SL / 2; ++i) o[h][i] = 0.f;
  uint32_t qf[2][2][4][4];  // two dim groups' q fragments: [group][big, small][k8 step]
  act::mbar_wait(qbar, 0);
  int s = 0;
  uint32_t ph = 0;
  for (;;) {
    act::mbar_wait(full + 8 * s, ph);
    if (tile_of[s] < 0) break;
    const uint32_t st = ring + s * SLOT, vb = st + 2 * K_HALF, vs = vb + V_HALF;
    // s = q k^T over the dim groups: q's A fragments split in registers
    // into (qb, qsm) (the registers of the group before last, whose
    // products are done), three products a k8 step, one commit group a dim
    // group, one group in flight while the next one's fragments are formed
    float sc[BK / 2];
    act::fence_operands(sc);
    auto group = [&](int dg, uint32_t(&qb)[4][4], uint32_t(&qsm)[4][4], uint32_t(&pb)[4][4],
                     uint32_t(&psm)[4][4]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int ch = 2 * kk + (lane >> 4);
        uint32_t a[4];
        act::ldsm_x4(a, q_s + dg * BM * ROW + qrow * ROW + ((ch ^ (qrow & 7)) << 4));
#pragma unroll
        for (int e = 0; e < 4; ++e) act::split_fast(__uint_as_float(a[e]), qb[kk][e], qsm[kk][e]);
        const uint32_t kb = st + dg * BK * ROW + 32 * kk, ks = kb + K_HALF;
        act::wgmma_fence();
        act::wgmma_tf32_rs<BK>(sc, qsm[kk], act::desc_sw128(kb, 16, 1024), dg > 0 || kk > 0);
        act::wgmma_tf32_rs<BK>(sc, qb[kk], act::desc_sw128(ks, 16, 1024), 1);
        act::wgmma_tf32_rs<BK>(sc, qb[kk], act::desc_sw128(kb, 16, 1024), 1);
      }
      act::wgmma_commit();
      act::wgmma_wait<1>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // live until the products that read them are done
        act::fence_regs(pb[kk]);
        act::fence_regs(psm[kk]);
      }
    };
    for (int dg = 0; dg < n_dg; dg += 2) {
      group(dg, qf[0][0], qf[0][1], qf[1][0], qf[1][1]);
      group(dg + 1, qf[1][0], qf[1][1], qf[0][0], qf[0][1]);
    }
    act::wgmma_wait<0>();
    act::fence_operands(sc);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        act::fence_regs(qf[h][0][kk]);
        act::fence_regs(qf[h][1][kk]);
      }
    // p = relu(s * scale * mask)^2 (IEEE single operations in that order),
    // split as p v's A fragments: k8 step j holds keys 8 j + 2 tq (a0: row
    // g, a1: row g + 8) and 8 j + 2 tq + 1 (a2, a3), v's permuted order
    uint32_t pb[BK / 8][4], ps[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float2 mm = *reinterpret_cast<const float2*>(coef + s * BK + 8 * j + 2 * tq);
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x =
            fmaxf(__fmul_rn(__fmul_rn(sc[4 * j + e], scale), e & 1 ? mm.y : mm.x), 0.f);
        p[e] = __fmul_rn(x, x);
      }
      const float a[4] = {p[0], p[2], p[1], p[3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) act::split_fast(a[e], pb[j][e], ps[j][e]);
    }
    // p v, a slice of SL columns at a time
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float part[SL / 2];  // the tile's products, from zero
      act::fence_operands(part);
      act::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const uint32_t off = h * SL * ROW + 32 * j;
        act::wgmma_tf32_rs<SL>(part, ps[j], act::desc_sw128(vb + off, 16, 1024), j > 0);
        act::wgmma_tf32_rs<SL>(part, pb[j], act::desc_sw128(vs + off, 16, 1024), 1);
        act::wgmma_tf32_rs<SL>(part, pb[j], act::desc_sw128(vb + off, 16, 1024), 1);
      }
      act::wgmma_commit();
      act::wgmma_wait<0>();
      act::fence_operands(part);
#pragma unroll
      for (int i = 0; i < SL / 2; ++i) o[h][i] += part[i];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      act::fence_regs(pb[j]);
      act::fence_regs(ps[j]);
    }
    __syncwarp();
    if (lane == 0) act::mbar_arrive(empty + 8 * s);  // this tile's stage is read
    if (++s == NS) {
      s = 0;
      ph ^= 1;
    }
  }

  // rows r0 (o[h][4 j], [4 j + 1]) and r0 + 8 ([4 j + 2], [4 j + 3]), columns
  // c0 + SL h + 8 j + 2 tq, + 1
  const int r0 = row0 + 64 * wg + 16 * (warp & 3) + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < SL / 8; ++j) {
      const int col = c0 + SL * h + 8 * j + 2 * tq;
      if (col >= de) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        if (r < t) {
          *reinterpret_cast<float2*>(out + ((size_t)item * t + r) * de + col) =
              make_float2(o[h][4 * j + 2 * hh], o[h][4 * j + 2 * hh + 1]);
        }
      }
    }
  }
}

std::atomic<uint64_t> smem_cap_raised{0};  // gau_kernel's cap, raised once per device

// The call: the split launch, then the kernel
inline int run(const float* q, const float* k, const float* v, const uint8_t* kv_mask, float* out,
               float* ksp, float* vtp, int batch, int t, int dqk, int de, float scale,
               cudaStream_t stream) {
  const int tp = (t + 7) / 8 * 8;
  cudaError_t e = act::attn::tf32_split(k, v, nullptr, ksp, vtp, nullptr, batch, t, t, dqk, de,
                                        stream);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv;
  if ((e = act::tmap_3d_f32(&mq, q, dqk, t, batch, BM)) != cudaSuccess ||
      (e = act::tmap_3d_f32(&mk, ksp, dqk, t, 2 * batch, BK)) != cudaSuccess ||
      (e = act::tmap_3d_f32(&mv, vtp, tp, de, 2 * batch, DV)) != cudaSuccess)
    return (int)e;
  if ((e = act::allow_dynamic_smem(reinterpret_cast<const void*>(gau_kernel), smem_cap_raised)) !=
      cudaSuccess)
    return (int)e;
  const Plan pl = plan(batch, t, de);
  gau_kernel<<<dim3(pl.gx, pl.gy, pl.gz), THREADS, SMEM, stream>>>(mq, mk, mv, kv_mask, out, batch,
                                                                    t, dqk, de, scale);
  return (int)cudaGetLastError();
}

}  // namespace t32

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
// De multiples of 4, Dqk <= 128. Scratch: ksp 2 B T Dqk floats (k split),
// vtp 2 B De Tp floats (v transposed and split), Tp = T rounded up to 8.
extern "C" int act_gau_attention(const float* q, const float* k, const float* v,
                                 const uint8_t* kv_mask, float* out, float* ksp, float* vtp,
                                 int batch, int t, int dqk, int de, float scale,
                                 cudaStream_t stream) {
  if (dqk <= 0 || dqk > MAX_DQK || dqk % 4 || de <= 0 || de % 4) return (int)cudaErrorInvalidValue;
  if (t <= 0 || batch <= 0) return 0;
  return t32::run(q, k, v, kv_mask, out, ksp, vtp, batch, t, dqk, de, scale, stream);
}

// The plan of a float32 call into out[8]: consumer warpgroups a block,
// output columns a block, grid x, y, z, threads a block, ring stages,
// dynamic shared memory bytes (ops/kernels/gau.tf32_plan computes the same
// on the host).
extern "C" int act_gau_attention_plan(int batch, int t, int dqk, int de, int* out) {
  if (dqk <= 0 || dqk > MAX_DQK || dqk % 4 || de <= 0 || de % 4) return (int)cudaErrorInvalidValue;
  const t32::Plan pl = t32::plan(batch, t, de);
  const int facts[8] = {t32::NWG, t32::DV, pl.gx, pl.gy, pl.gz, t32::THREADS, t32::NS,
                        (int)t32::SMEM};
  for (int i = 0; i < 8; ++i) out[i] = facts[i];
  return 0;
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
