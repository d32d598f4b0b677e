// One block's tile of a float32 SIMT matrix product with the caller's own
// loaders and epilogue: the DFT of K1 fbank_power_mel.cu, which needs IEEE
// float32 FMA (the log of small powers; PERF.md).
//
// 256 threads as 16 x 16; thread (ty, tx) accumulates the TM x TN outputs
// at rows m0 + ty + 16 i and columns n0 + tx + 16 j, so neighbouring threads
// write neighbouring columns and read shared memory without bank conflicts.
// Operands stream through shared memory BKK deep: A is stored transposed
// with an odd row stride, B row-major. The loaders are functors (row, k) ->
// value and (k, col) -> value, so each kernel fuses its own prologue
// (masking, normalisation, basis layout) into the load.
#pragma once

#include <cuda_runtime.h>

namespace act {

constexpr int GEMM_THREADS = 256;
constexpr int BKK = 32;  // contraction depth per shared-memory stage

// floats of shared memory gemm_tile<TM, TN> needs
template <int TM, int TN>
__host__ __device__ constexpr int gemm_smem_floats() {
  return BKK * (16 * TM + 1) + BKK * 16 * TN;
}

// acc[i][j] = sum over k < k_dim (a multiple of BKK) of
// aload(m0 + ty + 16 i, k) * bload(k, n0 + tx + 16 j). Ends with a barrier,
// so the caller may reuse ``smem`` at once.
template <int TM, int TN, class ALoad, class BLoad>
__device__ __forceinline__ void gemm_tile(float* smem, const ALoad& aload, const BLoad& bload,
                                          int k_dim, int m0, int n0, float (&acc)[TM][TN]) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  float* as = smem;                  // [BKK][BM + 1]
  float* bs = smem + BKK * (BM + 1);  // [BKK][BN]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < k_dim; k0 += BKK) {
    __syncthreads();
    for (int i = tid; i < BM * BKK; i += GEMM_THREADS) {
      int r = i / BKK, c = i % BKK;
      as[c * (BM + 1) + r] = aload(m0 + r, k0 + c);
    }
    for (int i = tid; i < BKK * BN; i += GEMM_THREADS) {
      int r = i / BN, c = i % BN;
      bs[r * BN + c] = bload(k0 + r, n0 + c);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BKK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[kk * (BM + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();
}

}  // namespace act
