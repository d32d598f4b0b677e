// Device helpers shared by the kernels that run float32 products on the
// tensor cores in 3xTF32 (K2 tcn_masker.cu, K4 gau_attention.cu and K3 / K5
// flash_attention.cu, all on TF32 wgmma): the TF32 split, and the
// once-per-device raise of a kernel's shared-memory cap (which K1
// fbank_power_mel.cu, on no tensor core, also uses).
//
// 3xTF32: x = big + small with big rounded to TF32; a b ~ a_big b_big +
// a_big b_small + a_small b_big, the dropped small x small term below
// 2^-22 |a b|. The split is explicit, because a raw float32 fed to a TF32
// product is truncated, not rounded.
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
