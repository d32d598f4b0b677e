// Device helpers shared by the bfloat16 entry points of K3 / K5
// (flash_attention.cu) and K4 (gau_attention.cu): one mma.sync m16n8k16 bf16
// product with float32 accumulators, the transposing ldmatrix that turns a
// [k][n] shared-memory tile into B fragments; and the round-to-nearest-even
// casts every bf16 kernel (K2 bf16 in tcn_masker.cu too) uses at the JAX
// kernels' rounding points.
//
// Fragments (g = lane / 4, tg = lane % 4), 32 bits = two bf16, low half first:
//   A (row-major 16 x 16): a0 (g, 2tg..+1), a1 (g + 8, 2tg..+1),
//                          a2 (g, 2tg + 8..+9), a3 (g + 8, 2tg + 8..+9)
//   B (16 x 8, "col"):     b0 (k 2tg..+1, n g), b1 (k 2tg + 8..+9, n g)
//   C (16 x 8, float32):   c0, c1 (g, 2tg..+1), c2, c3 (g + 8, 2tg..+1)
// With both operands k-contiguous in shared memory an A or B register is one
// 32-bit load; a B tile stored k-major ([k][n], as the weights and V lie in
// device memory) goes through ldmatrix .trans instead.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace act {

using bf16 = __nv_bfloat16;

// float -> bfloat16, round to nearest even; and back (exact)
__device__ __forceinline__ bf16 rb(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ float fb(bf16 x) { return __bfloat162float(x); }
// x rounded to bfloat16, kept as a float
__device__ __forceinline__ float rbf(float x) { return fb(rb(x)); }

// two floats -> one 32-bit register of two bfloat16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the low and the high bfloat16 of a 32-bit register, as floats (exact)
__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a b, one m16n8k16 bf16 product with float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, transposed on the way: lane l names row l % 8 of
// matrix l / 8. From a [k][n] tile, with lane l at row k0 + (l & 15) and
// column n0 + 8 (l >> 4): r0, r1 are (b0, b1) of the n8 tile at n0 and r2,
// r3 those of the n8 tile at n0 + 8, for the k16 step at k0.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

// 16-byte asynchronous copy global -> shared of any element type; in ==
// false zero-fills
__device__ __forceinline__ void cp_async16b(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = in ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

}  // namespace act
