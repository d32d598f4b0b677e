// K4 gau_attention: the gated-attention-unit scores of the MossFormer
// separator, out = relu(q k^T * scale * key_mask)^2 v, forward only.
//
// Replaces audio_classification_tpu/ops/pallas/attention_kernel.py
// (gau_attention -> _gau_fwd_call, body _gau_kernel): q, k [B, T, Dqk] and
// v [B, T, De] f32, a multiplicative 0/1 key mask, no softmax state. The
// [T, T] score matrix never reaches device memory.
//
// Bound on the H100: operations. The call does 2 B T^2 (Dqk + De) flops on
// (2 Dqk + 2 De) B T floats, thousands of flops per byte at the main path's
// T of 4k-64k frames, and it is IEEE f32 FMA (no tensor cores, so that the
// CPU parity tolerance carries to the card): the yardstick is the card's
// non-tensor f32 peak.
//
// Design. The sequential key axis of the TPU grid is a loop inside the
// block. A block owns BM = 64 query rows and one DC = 384-wide chunk of the
// De output columns (blockIdx.y walks the chunks), so each of its 256 threads
// keeps an 8 row x 12 column accumulator in registers (96 floats). The price
// of the split is that the q k^T tile is formed once per chunk: at De = 768
// that is 2 T^2 (2 Dqk + De) instead of 2 T^2 (Dqk + De), 1.14x the
// operations, in exchange for 64 query rows per pass over V (half the L2
// traffic of a 32-row block that kept all 768 columns). Key tiles of BN = 32
// are double-buffered in shared memory: while one tile is multiplied, the
// next tile's K and V arrive by asynchronous copies (cp.async), so one block
// of 8 warps per SM (175 KB of shared memory at Dqk = 128) keeps the FMA
// pipe fed. Per tile, warp w forms the scores of its own rows 8w..8w+7
// against the 32 keys (lane = key, Q rows read as broadcasts), applies scale,
// mask and relu^2, and parks them key-major in shared memory; after a
// warp-level sync the same warp multiplies them into V (lane = 3 float4
// column chunks, 96 FMAs per 5 16-byte loads). Row strides are padded by 4
// floats so the float4 accesses are free of bank conflicts. Ragged T is
// masked in the kernel (rows past T are never stored, keys past T weigh 0):
// no padding to 128 on the host. A masked key contributes exactly 0, so the
// key loop ends at the last unmasked key of the batch item.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 32;        // keys per shared-memory tile (= warp width)
constexpr int NT = 256;       // threads per block: 8 warps x 8 rows
constexpr int TM = BM / 8;    // rows per warp, and per thread in the second product
constexpr int DC = 384;       // output columns per block
constexpr int NC = DC / 128;  // float4 column chunks per thread
constexpr int PS = BM + 4;    // row stride of the score tile
constexpr int MAX_DQK = 128;

__host__ __device__ constexpr int smem_floats(int dqk) {
  return (BM + 2 * BN) * (dqk + 4) + BN * PS + 2 * BN * DC + 2 * BN;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16-byte asynchronous copy global -> shared; ``ok == false`` writes zeros
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(NT, 1)
gau_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
               float* __restrict__ out, int t, int dqk, int de, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int qs = dqk + 4;
  float* q_s = smem;                    // [BM][qs]
  float* k_s = q_s + BM * qs;           // [2][BN][qs]
  float* p_s = k_s + 2 * BN * qs;       // [BN][PS]
  float* v_s = p_s + BN * PS;           // [2][BN][DC]
  float* m_s = v_s + 2 * BN * DC;       // [2][BN]
  __shared__ int kend_s;

  const int b = blockIdx.z, c0 = blockIdx.y * DC, m0 = blockIdx.x * BM;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t qk_base = (size_t)b * t * dqk, v_base = (size_t)b * t * de;
  const int dc = min(DC, de - c0);
  const int dq4 = dqk / 4;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // keys after the last unmasked one add exactly 0: the key loop ends there
  if (tid == 0) kend_s = (kv_mask == nullptr) ? t : 0;
  __syncthreads();
  if (kv_mask != nullptr) {
    int ke = 0;
    for (int j = tid; j < t; j += NT)
      if (kv_mask[(size_t)b * t + j]) ke = j + 1;
    atomicMax(&kend_s, ke);
  }
  for (int i = tid; i < BM * dq4; i += NT) {
    const int r = i / dq4, d = (i % dq4) * 4;
    *reinterpret_cast<float4*>(q_s + r * qs + d) =
        (m0 + r < t) ? ld4(q + qk_base + (size_t)(m0 + r) * dqk + d) : zero4;
  }
  __syncthreads();
  const int kend = kend_s;
  const int ntiles = (kend + BN - 1) / BN;

  // queue the K and V tiles of key tile ``tile`` into buffer ``buf``
  // (asynchronous 16-byte copies; rows past T and columns past De zero-fill)
  auto issue = [&](int tile, int buf) {
    const int k0 = tile * BN;
    float* kb = k_s + buf * BN * qs;
    float* vb = v_s + buf * BN * DC;
    for (int i = tid; i < BN * dq4; i += NT) {
      const int j = i / dq4, d = (i % dq4) * 4;
      const bool ok = k0 + j < t;
      cp16(kb + j * qs + d, k + qk_base + (size_t)(ok ? k0 + j : 0) * dqk + d, ok);
    }
    for (int i = tid; i < BN * (DC / 4); i += NT) {
      const int j = i / (DC / 4), c = (i % (DC / 4)) * 4;
      const bool ok = (k0 + j < t) && (c < dc);
      cp16(vb + j * DC + c, v + v_base + (size_t)(ok ? k0 + j : 0) * de + c0 + (ok ? c : 0), ok);
    }
  };
  auto mask_of = [&](int tile) -> float {
    const int j = tile * BN + tid;
    const bool on = tid < BN && j < t && (kv_mask == nullptr || kv_mask[(size_t)b * t + j] != 0);
    return on ? 1.f : 0.f;
  };

  float4 acc[TM][NC];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = zero4;

  if (ntiles > 0) {
    issue(0, 0);
    if (tid < BN) m_s[tid] = mask_of(0);
  }
  cp_commit();

  for (int tile = 0; tile < ntiles; ++tile) {
    const int cb = tile & 1, nb = cb ^ 1;
    // the next tile's copies run while this tile is multiplied
    float mnext = 0.f;
    if (tile + 1 < ntiles) {
      issue(tile + 1, nb);
      mnext = mask_of(tile + 1);
    }
    cp_commit();
    cp_wait<1>();     // all but the newest group: this tile has landed
    __syncthreads();
    const float* kb = k_s + cb * BN * qs;
    const float* vb = v_s + cb * BN * DC;

    // first product: this warp's TM rows against the tile's keys, lane = key
    float s[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) s[i] = 0.f;
    const float* kr = kb + lane * qs;
    const float* qr = q_s + warp * TM * qs;
#pragma unroll 2
    for (int d = 0; d < dqk; d += 4) {
      const float4 kk = ld4(kr + d);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 qq = ld4(qr + i * qs + d);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }
    const float mk = m_s[cb * BN + lane];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float x = fmaxf(s[i] * scale * mk, 0.f);
      s[i] = x * x;
    }
    float* pw = p_s + lane * PS + warp * TM;
    *reinterpret_cast<float4*>(pw) = make_float4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<float4*>(pw + 4) = make_float4(s[4], s[5], s[6], s[7]);
    __syncwarp();  // the scores of rows 8w..8w+7 are written and read by warp w only

    // second product: acc[8 rows][12 columns] += p[rows][keys] v[keys][columns]

    const float* pr = p_s + warp * TM;
    const float* vr = vb + 4 * lane;
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float4 p0 = ld4(pr + j * PS), p1 = ld4(pr + j * PS + 4);
      const float p[TM] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = ld4(vr + j * DC + 128 * c);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][c].x = fmaf(p[i], vv.x, acc[i][c].x);
          acc[i][c].y = fmaf(p[i], vv.y, acc[i][c].y);
          acc[i][c].z = fmaf(p[i], vv.z, acc[i][c].z);
          acc[i][c].w = fmaf(p[i], vv.w, acc[i][c].w);
        }
      }
    }
    if (tid < BN) m_s[nb * BN + tid] = mnext;
    __syncthreads();  // buffer cb is free for the tile after next
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + warp * TM + i;
    if (row >= t) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * lane + 128 * c;
      if (col < dc)
        *reinterpret_cast<float4*>(out + v_base + (size_t)row * de + c0 + col) = acc[i][c];
    }
  }
}

}  // namespace

// q, k: [B, T, Dqk]; v, out: [B, T, De]; f32 contiguous, 16-byte aligned;
// kv_mask: [B, T] uint8 or null. Dqk and De multiples of 4, Dqk <= 128.
extern "C" int act_gau_attention(const float* q, const float* k, const float* v,
                                 const uint8_t* kv_mask, float* out, int batch, int t,
                                 int dqk, int de, float scale, cudaStream_t stream) {
  if (dqk <= 0 || dqk > MAX_DQK || dqk % 4 || de <= 0 || de % 4) return (int)cudaErrorInvalidValue;
  if (t <= 0 || batch <= 0) return 0;
  const int smem_bytes = smem_floats(dqk) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gau_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + BM - 1) / BM, (de + DC - 1) / DC, batch);
  gau_fwd_kernel<<<grid, NT, smem_bytes, stream>>>(q, k, v, kv_mask, out, t, dqk, de, scale);
  return (int)cudaGetLastError();
}
