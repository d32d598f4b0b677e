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
// Bound on the H100: at the main path's T of 537-800 (4271 on the long-form
// path, 1068 a shard of its ring of 4) and D = 64 the [T, T] logits are the
// only large intermediate; keeping them out of device memory
// is the point, after which the kernel is bound by f32 FMA throughput (SIMT,
// no tensor cores in this version) and, at the pipeline's batch of 1, by how
// many threads the grid offers. Design: four neighbouring threads own one
// query row, each holding 16 of the 64 dims of q and of the accumulator as
// float4 chunks (lane, lane+4, lane+8, lane+12); their partial dot products
// meet through two warp shuffles, so every lane sees the same score. A lane
// reads K and V as 16-byte chunks (the four lanes of a row hit 64 contiguous
// bytes), one load per four FMAs. A block of 32 rows walks the keys in tiles
// of BK staged in shared memory. Keys past T are skipped, not padded, so no
// 128-lane padding is needed; fully masked query rows stay finite (they are
// discarded downstream, as on the TPU).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;              // head dimension
constexpr int LANES = 4;           // threads per query row
constexpr int DL = D / LANES;      // dims per thread, as DL / 4 float4 chunks
constexpr int ROWS = 32;           // query rows per block
constexpr int NT = ROWS * LANES;   // threads per block
constexpr int BK = 32;             // keys per shared-memory tile
constexpr float NEG_INIT = -1e30f;

template <bool EMIT_STATS>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                 float* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out, int heads, int tq, int tk, float scale) {
  __shared__ __align__(16) float k_s[BK][D];  // float4 stores
  __shared__ __align__(16) float v_s[BK][D];
  __shared__ float bias_s[BK];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int lane = threadIdx.x % LANES;
  const int row = blockIdx.x * ROWS + threadIdx.x / LANES;
  const size_t base = (size_t)bh * tq * D;     // of this head's q and out rows
  const size_t kv_base = (size_t)bh * tk * D;  // of its k and v rows
  const bool live = row < tq;

  // lane owns the float4 chunks lane + LANES * c of the row (c < DL / 4):
  // one key's chunks for the 4 lanes of a row are 64 contiguous bytes
  float4 qr[DL / 4], acc[DL / 4];
#pragma unroll
  for (int c = 0; c < DL / 4; ++c) {
    qr[c] = live ? *reinterpret_cast<const float4*>(q + base + (size_t)row * D +
                                                    4 * (lane + LANES * c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INIT, l = 0.f;

  for (int k0 = 0; k0 < tk; k0 += BK) {
    const int nk = min(BK, tk - k0);
    __syncthreads();  // previous tile consumed
    for (int i = threadIdx.x; i < BK * D / 4; i += NT) {
      int j = (i * 4) / D, d = (i * 4) % D;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (j < nk) {
        kv = *reinterpret_cast<const float4*>(k + kv_base + (size_t)(k0 + j) * D + d);
        vv = *reinterpret_cast<const float4*>(v + kv_base + (size_t)(k0 + j) * D + d);
      }
      *reinterpret_cast<float4*>(&k_s[j][d]) = kv;
      *reinterpret_cast<float4*>(&v_s[j][d]) = vv;
    }
    if (threadIdx.x < BK) {
      int j = threadIdx.x;
      bias_s[j] = (j < nk && kv_mask != nullptr && kv_mask[(size_t)b * tk + k0 + j] == 0) ? -1e9f
                                                                                        : 0.f;
    }
    __syncthreads();

    float s[BK];
    float m_tile = NEG_INIT;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DL / 4; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[j][4 * (lane + LANES * c)]);
        dot = fmaf(qr[c].x, kk.x, dot);
        dot = fmaf(qr[c].y, kk.y, dot);
        dot = fmaf(qr[c].z, kk.z, dot);
        dot = fmaf(qr[c].w, kk.w, dot);
      }
      // the row's four partial sums, added in the same order on every lane
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      s[j] = dot * scale + bias_s[j];
      if (j < nk) m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < DL / 4; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      if (j < nk) {
        const float p = expf(s[j] - m_new);
        l += p;
#pragma unroll
        for (int c = 0; c < DL / 4; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][4 * (lane + LANES * c)]);
          acc[c].x = fmaf(p, vv.x, acc[c].x);
          acc[c].y = fmaf(p, vv.y, acc[c].y);
          acc[c].z = fmaf(p, vv.z, acc[c].z);
          acc[c].w = fmaf(p, vv.w, acc[c].w);
        }
      }
    }
    m = m_new;
  }

  if (!live) return;
  if (EMIT_STATS) {
#pragma unroll
    for (int c = 0; c < DL / 4; ++c) {
      *reinterpret_cast<float4*>(out + base + (size_t)row * D + 4 * (lane + LANES * c)) = acc[c];
    }
    if (lane == 0) {  // all four lanes of a row hold the same m and l
      m_out[(size_t)bh * tq + row] = m;
      l_out[(size_t)bh * tq + row] = l;
    }
  } else {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < DL / 4; ++c) {
      *reinterpret_cast<float4*>(out + base + (size_t)row * D + 4 * (lane + LANES * c)) =
          make_float4(acc[c].x * inv, acc[c].y * inv, acc[c].z * inv, acc[c].w * inv);
    }
  }
}

}  // namespace

// K3. q, k, v, out: [B, H, T, 64] f32 contiguous; kv_mask: [B, T] uint8 or null.
extern "C" int act_flash_attention(const float* q, const float* k, const float* v,
                                   const uint8_t* kv_mask, float* out, int batch, int heads,
                                   int t, int head_dim, float scale, cudaStream_t stream) {
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  if (t <= 0 || batch <= 0) return 0;
  dim3 grid((t + ROWS - 1) / ROWS, batch * heads);
  flash_fwd_kernel<false><<<grid, NT, 0, stream>>>(q, k, v, kv_mask, out, nullptr, nullptr,
                                                   heads, t, t, scale);
  return (int)cudaGetLastError();
}

// K5. q, out: [B, H, Tq, 64]; k, v: [B, H, Tk, 64]; m_out, l_out: [B, H, Tq];
// all f32 contiguous; kv_mask: [B, Tk] uint8 or null. Tk >= 1.
extern "C" int act_flash_attention_stats(const float* q, const float* k, const float* v,
                                         const uint8_t* kv_mask, float* out, float* m_out,
                                         float* l_out, int batch, int heads, int tq, int tk,
                                         int head_dim, float scale, cudaStream_t stream) {
  if (head_dim != D || tk <= 0) return (int)cudaErrorInvalidValue;
  if (tq <= 0 || batch <= 0) return 0;
  dim3 grid((tq + ROWS - 1) / ROWS, batch * heads);
  flash_fwd_kernel<true><<<grid, NT, 0, stream>>>(q, k, v, kv_mask, out, m_out, l_out, heads,
                                                  tq, tk, scale);
  return (int)cudaGetLastError();
}
