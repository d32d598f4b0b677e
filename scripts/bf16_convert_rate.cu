// The card's rate of float32 -> bfloat16 rounding, three ways, beside its
// float32 FMA rate: F2FP (cvt.rn.bf16x2.f32, a pair a conversion), F2F
// (cvt.rn.bf16.f32, one value) and round-to-nearest-even in integer
// operations. The bf16 kernels of csrc/tcn_masker.cu round in pairs because
// of what this measures. Each loop body is one rounding (of a pair, for
// F2FP), a shift, a multiply and an xor, in 8 independent chains a thread;
// it prints loop bodies a clock an SM.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/bf16_convert_rate \
//       scripts/bf16_convert_rate.cu && build/bf16_convert_rate
#include <cuda_bf16.h>
#include <cstdint>
#include <cstdio>

constexpr int ITERS = 4096, CH = 8;

__global__ void f2fp_pairs(float* out, float seed) {
  float a[CH];
  for (int c = 0; c < CH; ++c) a[c] = seed + threadIdx.x * 1e-3f + c;
  uint32_t acc = 0;
  for (int i = 0; i < ITERS; ++i) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(a[c], a[(c + 1) % CH]);
      const uint32_t u = *reinterpret_cast<const uint32_t*>(&v);
      a[c] = __uint_as_float(u << 16) * 1.0001f;
      acc ^= u;
    }
  }
  if (acc == 12345u) out[0] = a[0];
}

__global__ void f2f_single(float* out, float seed) {
  float a[CH];
  for (int c = 0; c < CH; ++c) a[c] = seed + threadIdx.x * 1e-3f + c;
  uint32_t acc = 0;
  for (int i = 0; i < ITERS; ++i) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float r = __bfloat162float(__float2bfloat16_rn(a[c]));
      a[c] = r * 1.0001f;
      acc ^= __float_as_uint(r);
    }
  }
  if (acc == 12345u) out[0] = a[0];
}

__global__ void integer_rne(float* out, float seed) {
  float a[CH];
  for (int c = 0; c < CH; ++c) a[c] = seed + threadIdx.x * 1e-3f + c;
  uint32_t acc = 0;
  for (int i = 0; i < ITERS; ++i) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      uint32_t u = __float_as_uint(a[c]);
      u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
      a[c] = __uint_as_float(u) * 1.0001f;
      acc ^= u;
    }
  }
  if (acc == 12345u) out[0] = a[0];
}

__global__ void ffma_chain(float* out, float seed) {
  float a[CH];
  for (int c = 0; c < CH; ++c) a[c] = seed + threadIdx.x * 1e-3f + c;
  for (int i = 0; i < ITERS; ++i) {
#pragma unroll
    for (int c = 0; c < CH; ++c) a[c] = a[c] * 1.0001f + 0.5f;
  }
  float s = 0.f;
  for (int c = 0; c < CH; ++c) s += a[c];
  if (s == 12345.f) out[0] = s;
}

template <class K>
void run(const char* name, K kernel, float* out, int sms, int clock_khz) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  kernel<<<sms * 8, 256>>>(out, 1.0f);  // warm-up
  cudaDeviceSynchronize();
  cudaEventRecord(e0);
  kernel<<<sms * 8, 256>>>(out, 1.0f);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double bodies = (double)sms * 8 * 256 * ITERS * CH;
  printf("%-40s %8.3f ms  %6.2f loop bodies / clock / SM\n", name, ms,
         bodies / (ms * 1e-3) / (clock_khz * 1e3) / sms);
}

int main() {
  int sms = 0, clock_khz = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, 0);
  float* out = nullptr;
  if (cudaMalloc(&out, sizeof(float)) != cudaSuccess) {
    fprintf(stderr, "bf16_convert_rate: needs a CUDA device\n");
    return 2;
  }
  run("F2FP pair (cvt.rn.bf16x2.f32)", f2fp_pairs, out, sms, clock_khz);
  run("F2F single (cvt.rn.bf16.f32)", f2f_single, out, sms, clock_khz);
  run("integer round-to-nearest-even", integer_rne, out, sms, clock_khz);
  run("FFMA (reference)", ffma_chain, out, sms, clock_khz);
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
