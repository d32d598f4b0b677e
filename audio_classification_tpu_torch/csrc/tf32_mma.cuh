// Device helpers shared by the kernels that run float32 products on the
// tensor cores in 3xTF32 (the split: K3 / K5 flash_attention.cu on
// mma.sync, K2 tcn_masker.cu and K4 gau_attention.cu on wgmma): the TF32
// split, one mma.sync m16n8k8 TF32 product, 16-byte cp.async staging, and
// the once-per-device raise of a kernel's shared-memory cap (which K1
// fbank_power_mel.cu, on no tensor core, also uses).
//
// 3xTF32: x = big + small with big rounded to TF32; a b ~ a_big b_big +
// a_big b_small + a_small b_big, the dropped small x small term below
// 2^-22 |a b|. The split is explicit, because a raw float32 fed to a TF32
// mma is truncated, not rounded.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace act {

// float32 -> TF32 rounded to nearest, ties away from zero: bit for bit what
// cvt.rna.tf32.f32 gives (half of the 13 dropped bits added to the
// magnitude, then cleared), in two integer operations on the full-rate pipe
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both rounded to TF32: together 22 of float32's 24 bits
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}

// x = big + small with big rounded to TF32 and small = x - big exact in
// float32, left for the mma to truncate: |small| <= 2^-11 |x|, so the
// truncation costs less than 2^-21 |x| (rounding it, 2^-22), the order of
// the dropped small x small term, for one operation instead of three
__device__ __forceinline__ void split_fast(float x, uint32_t& big, uint32_t& small) {
  big = tf32_round(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a b, one m16n8k8 TF32 product with float32 accumulation. Not
// volatile: independent products may be interleaved by the compiler
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared; in == false zero-fills
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = in ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Raise a kernel's cap on dynamic shared memory to the card's opt-in
// maximum less the kernel's static shared memory, once per device
// (``raised`` holds one bit a device, one variable a kernel): the cap only
// permits, each launch's own size sets the occupancy. Not on every launch: a
// batch-1 call is host-bound
inline cudaError_t allow_dynamic_smem(const void* kernel, std::atomic<uint64_t>& raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (raised.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  int optin = 0;
  cudaFuncAttributes attr;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  }
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace act
