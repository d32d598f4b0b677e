// Hopper's own machinery for the port's kernels (first used by K2 bf16 in
// tcn_masker.cu, then by the bf16 attention pipeline, attention_wgmma.cuh,
// then by the float32 K2, K4, K3 and K5 in 3xTF32): warpgroup products
// (wgmma.mma_async m64nNk16 bf16 and m64nNk8 tf32 with float32
// accumulators, A from shared memory or from registers), their
// fence / commit / wait discipline, shared-memory matrix descriptors for
// the 128-byte swizzle, mbarriers, 3-D TMA tile loads, named barriers, and
// on the host the encoding of a TMA tensor map (cuTensorMapEncodeTiled,
// looked up with cudaGetDriverEntryPoint: the library links no libcuda).
//
// Layouts (bf16, 128-byte swizzle, a tile's base 1024-byte aligned; a
// 16-byte chunk c of 128-byte row r lies at chunk c ^ (r % 8)):
//   A, K-major: rows of 64 k (128 bytes) one after another, as a TMA box
//     {64 k, rows} lands. Descriptor: SBO 1024 (8 rows), LBO unused; the
//     k16 step s starts 32 s bytes into the row.
//   B, MN-major ([k][n] with n contiguous, as the weights lie): boxes {64 n,
//     64 k} one after another along n, each 64 rows of 128 bytes.
//     Descriptor: LBO = the byte stride between the 64-column boxes, SBO
//     1024 (8 k rows); the k16 step s starts 2048 s bytes in. imm-trans-b 1.
//   B, K-major ([n][k] with k contiguous, as K lies for q k^T): laid out and
//     described as A, n in the place of the rows. imm-trans-b 0.
// Accumulator of m64nNk16 (warp w of the warpgroup, g = lane / 4, t = lane
// % 4): d[4 j + 0, 1] at row 16 w + g, columns 8 j + 2 t, + 1; d[4 j + 2, 3]
// at row 16 w + g + 8. A from registers: warp w's 16 rows as the m16n8k16
// A fragment (bf16_mma.cuh).
// TF32 (m64nNk8, float32 tiles, 128-byte swizzle): TF32 wgmma takes no
// transpose, so A and B are both K-major: rows of 32 k (128 bytes), the k8
// step s starting 32 s bytes into the row (described as the bf16 K-major
// tiles: SBO 1024, LBO unused). The accumulator is laid out as above; A
// from registers is warp w's 16 rows as the m16n8k8 TF32 fragment: a0 (row
// g, k t), a1 (row g + 8, k t), a2 (row g, k t + 4), a3 (row g + 8, k t +
// 4), which ldsm_x4 reads from a swizzled tile as it reads the bf16 A
// fragment (four 8 x 16-byte matrices). The product reads only the top 19
// bits of each operand, so a float32 operand is split by its user into big
// and small halves (tf32_mma.cuh) for float32 accuracy.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace act {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase before the first, parity 1, as completed)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ------------------------------------------------------------------ TMA
// the box of `map` at coordinates (c0 innermost, c1, c2) into shared memory
// at dst; completion is reported to bar as transaction bytes
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// make this thread's generic-proxy writes to shared memory visible to the
// async proxy (a wgmma that reads them by descriptor, a TMA store)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -------------------------------------------------------- named barriers
// barrier `id` (1-15; 0 is __syncthreads) over `count` threads, a multiple of 32
__device__ __forceinline__ void named_sync(uint32_t id, uint32_t count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------- register reallocation
// hand registers back (dec) or take them (inc) for the rest of this
// warpgroup's life: all its warps execute it; a kernel launched with a
// producer warpgroup gives the consumers more than the launch's share
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ------------------------------------------------------------------ wgmma
// descriptor of a 128-byte-swizzled tile at shared address `addr` (byte
// offsets lbo, sbo; see the layouts above)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (uint64_t{1} << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of the accumulators across the
// asynchronous products (a no-op instruction-wise)
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for register A fragments: kept live (unmodified) until the
// wgmma_wait that covers the products reading them
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ACT_WG_OPS32(o)                                                                  \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),        \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]), "+f"(d[o + 8]), "+f"(d[o + 9]),    \
      "+f"(d[o + 10]), "+f"(d[o + 11]), "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), \
      "+f"(d[o + 15]), "+f"(d[o + 16]), "+f"(d[o + 17]), "+f"(d[o + 18]), "+f"(d[o + 19]), \
      "+f"(d[o + 20]), "+f"(d[o + 21]), "+f"(d[o + 22]), "+f"(d[o + 23]), "+f"(d[o + 24]), \
      "+f"(d[o + 25]), "+f"(d[o + 26]), "+f"(d[o + 27]), "+f"(d[o + 28]), "+f"(d[o + 29]), \
      "+f"(d[o + 30]), "+f"(d[o + 31])
#define ACT_WG_OPS8(o)                                                                   \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),        \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define ACT_WG_D40 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39}"
#define ACT_WG_D96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
  " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
  " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
#define ACT_WG_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define ACT_WG_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define ACT_WG_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
  " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
  " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
  " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
  " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d (+)= a b over one k16 step, N = 64 / 128 / 256 columns: A (K-major) and
// B from shared memory by descriptor, B MN-major (TB = 1, [k][n] as the
// weights and V lie) or K-major (TB = 0, [n][k] as K lies for q k^T).
// accumulate == 0 overwrites d.
template <int N, int TB = 1>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_ss: N is 64, 128 or 256");
  static_assert(TB == 0 || TB == 1, "wgmma_ss: TB is 0 or 1");
  if constexpr (N == 64) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACT_WG_D32
                 ", %32, %33, p, 1, 1, 0, %35;\n}\n"
                 : ACT_WG_OPS32(0)
                 : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACT_WG_D64
                 ", %64, %65, p, 1, 1, 0, %67;\n}\n"
                 : ACT_WG_OPS32(0), ACT_WG_OPS32(32)
                 : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ACT_WG_D128
                 ", %128, %129, p, 1, 1, 0, %131;\n}\n"
                 : ACT_WG_OPS32(0), ACT_WG_OPS32(32), ACT_WG_OPS32(64), ACT_WG_OPS32(96)
                 : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
  }
}

// the same with A from registers (a = this warp's m16n8k16 A fragment) and
// B MN-major, N = 64 / 80 / 128 / 192 / 256 columns (80 and 192: the bf16
// attention's p v at head dims 80 and 192; a B wider than one 64-column box
// continues in the next box, LBO bytes on)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  static_assert(N == 64 || N == 80 || N == 128 || N == 192 || N == 256,
                "wgmma_rs: N is 64, 80, 128, 192 or 256");
  if constexpr (N == 64) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACT_WG_D32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : ACT_WG_OPS32(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 80) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " ACT_WG_D40
                 ", {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
                 : ACT_WG_OPS32(0), ACT_WG_OPS8(32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 192) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " ACT_WG_D96
                 ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
                 : ACT_WG_OPS32(0), ACT_WG_OPS32(32), ACT_WG_OPS32(64)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 128) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACT_WG_D64
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
                 : ACT_WG_OPS32(0), ACT_WG_OPS32(32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ACT_WG_D128
                 ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
                 : ACT_WG_OPS32(0), ACT_WG_OPS32(32), ACT_WG_OPS32(64), ACT_WG_OPS32(96)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
}

#define ACT_WG_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

#define ACT_WG_D48 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"

// d (+)= a b over one TF32 k8 step, N = 32 / 64 / 80 / 96 / 128 columns: A
// from registers (this warp's m16n8k8 TF32 fragment), B K-major ([n][k], k
// contiguous) from shared memory by descriptor. accumulate == 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  static_assert(N == 32 || N == 64 || N == 80 || N == 96 || N == 128,
                "wgmma_tf32_rs: N is 32, 64, 80, 96 or 128");
  if constexpr (N == 80) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 " ACT_WG_D40
                 ", {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
                 : ACT_WG_OPS32(0), ACT_WG_OPS8(32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " ACT_WG_D16
                 ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : ACT_WG_OPS8(0), ACT_WG_OPS8(8)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 64) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " ACT_WG_D32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : ACT_WG_OPS32(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 96) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 " ACT_WG_D48
                 ", {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
                 : ACT_WG_OPS32(0), ACT_WG_OPS8(32), ACT_WG_OPS8(40)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " ACT_WG_D64
                 ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                 : ACT_WG_OPS32(0), ACT_WG_OPS32(32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
}

// the same with A from shared memory too (K-major, by descriptor), N = 32 or
// 64 columns: the float32 attention's scores, q's TF32 halves split once
// into shared memory (A) against K's (B)
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                              int accumulate) {
  static_assert(N == 32 || N == 64, "wgmma_tf32_ss: N is 32 or 64");
  if constexpr (N == 32) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " ACT_WG_D16
                 ", %16, %17, p, 1, 1;\n}\n"
                 : ACT_WG_OPS8(0), ACT_WG_OPS8(8)
                 : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " ACT_WG_D32
                 ", %32, %33, p, 1, 1;\n}\n"
                 : ACT_WG_OPS32(0)
                 : "l"(da), "l"(db), "r"(accumulate));
  }
}

#undef ACT_WG_D16
#undef ACT_WG_D48
#undef ACT_WG_OPS32
#undef ACT_WG_OPS8
#undef ACT_WG_D40
#undef ACT_WG_D96
#undef ACT_WG_D32
#undef ACT_WG_D64
#undef ACT_WG_D128

// four 8 x 8 bf16 matrices from shared memory, lane l naming row l % 8 of
// matrix l / 8: from a 16 x 16 tile (row l & 15, k chunk l >> 4) they are
// the m16n8k16 A fragment
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ------------------------------------------------------------- host side
// A 3-D tensor [d2][d1][d0] (d0 contiguous) of `type` (elements of `bytes`
// bytes) as a TMA map with boxes of {b0, b1, 1} elements, 128-byte swizzle
// (b0 = 128 / bytes), zero fill past the tensor's bounds.
// cuTensorMapEncodeTiled is looked up once, through the CUDA runtime.
inline cudaError_t tmap_3d(CUtensorMap* map, CUtensorMapDataType type, uint64_t bytes,
                           const void* base, uint64_t d0, uint64_t d1, uint64_t d2, uint32_t b0,
                           uint32_t b1) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = []() -> Encode {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) !=
        cudaSuccess)
#endif
      return nullptr;
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<Encode>(fn) : nullptr;
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * bytes, d0 * d1 * bytes};  // bytes, of dims 1 and 2
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
// bf16 tensors: boxes of {64, b1}
inline cudaError_t tmap_3d_bf16(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                                uint64_t d2, uint32_t b0, uint32_t b1) {
  return tmap_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, d0, d1, d2, b0, b1);
}
// float32 tensors: boxes of {32, b1}
inline cudaError_t tmap_3d_f32(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                               uint64_t d2, uint32_t b1) {
  return tmap_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, d0, d1, d2, 32, b1);
}

}  // namespace act
