#!/usr/bin/env python3
"""Throughput of Hopper's TF32 warpgroup product on the GPU: wgmma.mma_async
m64nNk8 with float32 accumulators, A from shared memory (SS) or from
registers (RS), B K-major from shared memory with the 128-byte swizzle (the
products of the port's float32 kernels; helpers csrc/wgmma_tma.cuh).

Each of 132 blocks (one an SM) runs one or two warpgroups; each warpgroup
issues batches of eight products into one accumulator, then commits and
waits, for many iterations. The rate is the card's ceiling for a kernel
whose warpgroups issue such batches back to back, to set beside the data
sheet's dense 495 TFLOP/s TF32 (H100 SXM) and beside a kernel's own rate.

    python3 scripts/wgmma_tf32_rate.py

Needs nvcc (CUDA_HOME or PATH) and a CUDA device; prints one JSON object per
case and, first, the card's nvidia-smi name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cstdio>
#include "wgmma_tma.cuh"

template <int N, bool RS>
__global__ void rate(float* out, int iters) {
  extern __shared__ __align__(1024) unsigned char sm[];
  unsigned char* base = sm + ((1024 - (act::smem_u32(sm) & 1023)) & 1023);
  for (int i = threadIdx.x; i < 3 * 8192; i += blockDim.x)
    reinterpret_cast<float*>(base)[i] = 1e-3f * (i & 7);
  act::fence_proxy_async();
  __syncthreads();
  const uint32_t a_s = act::smem_u32(base), b_s = a_s + 16384;
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  uint32_t a[4] = {0x3f800000u, 0x3f800000u, 0u, 0u};
  act::fence_regs(a);
  for (int it = 0; it < iters; ++it) {
    act::fence_operands(d);
    act::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk >> 2) * 8192 + 32 * (kk & 3);
      const uint64_t db = act::desc_sw128(b_s + off, 16, 1024);
      if constexpr (RS) {
        act::wgmma_tf32_rs<N>(d, a, db, 1);
      } else {
        act::wgmma_tf32_ss<N>(d, act::desc_sw128(a_s + off, 16, 1024), db, 1);
      }
    }
    act::wgmma_commit();
    act::wgmma_wait<0>();
  }
  act::fence_operands(d);
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int N, bool RS>
void run(int warpgroups, int sms) {
  const int iters = 4000, smem = 100000;
  float* out;
  cudaMalloc(&out, sizeof(float) * sms * 256);
  cudaFuncSetAttribute(rate<N, RS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  rate<N, RS><<<sms, 128 * warpgroups, smem>>>(out, 10);
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  cudaEventRecord(s);
  rate<N, RS><<<sms, 128 * warpgroups, smem>>>(out, iters);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms;
  cudaEventElapsedTime(&ms, s, e);
  const double flops = (double)sms * warpgroups * iters * 8 * 2.0 * 64 * N * 8;
  printf("{\"product\": \"wgmma m64n%dk8 tf32 %s\", \"warpgroups_per_sm\": %d, \"ms\": %.4f, "
         "\"tflops\": %.1f, \"share_of_495\": %.3f}\n", N, RS ? "RS" : "SS", warpgroups, ms,
         flops / (ms * 1e9), flops / (ms * 1e9) / 495.0);
  cudaFree(out);
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  for (int w : {1, 2}) {
    run<32, false>(w, sms);
    run<64, false>(w, sms);
    run<32, true>(w, sms);
    run<64, true>(w, sms);
    run<128, true>(w, sms);
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def main() -> int:
    from audio_classification_tpu_torch import _build

    out_dir = ROOT / "build" / "wgmma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, exe = out_dir / "wgmma_rate.cu", out_dir / "wgmma_rate"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(exe),
                    str(src)], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    run = subprocess.run([str(exe)], capture_output=True, text=True)
    for line in run.stdout.splitlines():
        print(json.dumps(json.loads(line)), flush=True)
    if run.returncode != 0:
        print(run.stderr, file=sys.stderr)
    return run.returncode


if __name__ == "__main__":
    sys.exit(main())
