#!/usr/bin/env python3
"""Throughput of warp-level mma.sync on the GPU: m16n8k8 TF32 (the product
the port's float32 kernels were built from before their wgmma designs) and
m16n8k16 FP16 beside it. scripts/wgmma_tf32_rate.py measures the warpgroup
product that replaced it.

Every warp of 4 x 132 blocks issues eight independent accumulator chains of
the one product for many iterations; the rate is the card's ceiling for a
kernel made of such products, to set beside the data sheet's dense rates
(495 TFLOP/s TF32, 989 FP16 on an H100 SXM, reached through wgmma).

    python3 scripts/mma_tf32_peak.py

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
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#define MMA(SHAPE, TYPE)                                                                      \
  template <int CH>                                                                           \
  __global__ void k_##TYPE(float* out, int iters) {                                           \
    float c[CH][4] = {};                                                                      \
    uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};         \
    uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;                                      \
    for (int i = 0; i < iters; ++i) {                                                         \
      _Pragma("unroll") for (int j = 0; j < CH; ++j) asm volatile(                            \
          "mma.sync.aligned." SHAPE ".row.col.f32." #TYPE "." #TYPE ".f32 "                   \
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"                          \
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])                        \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));                    \
    }                                                                                         \
    float s = 0.f;                                                                            \
    for (int j = 0; j < CH; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];                  \
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;                                           \
  }
MMA("m16n8k8", tf32)
MMA("m16n8k16", f16)

template <typename F>
void run(const char* name, F kern, int warps, double flops_per_mma, int sms) {
  const int chains = 8, iters = 4096, blocks = 4 * sms;
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * warps * 32);
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  kern<<<blocks, warps * 32>>>(out, 16);
  cudaEventRecord(s);
  kern<<<blocks, warps * 32>>>(out, iters);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms;
  cudaEventElapsedTime(&ms, s, e);
  const double mmas = (double)blocks * warps * iters * chains;
  printf("{\"product\": \"%s\", \"warps_per_block\": %d, \"blocks\": %d, \"ms\": %.4f, "
         "\"tflops\": %.1f}\n", name, warps, blocks, ms, mmas * flops_per_mma / (ms * 1e9));
  cudaFree(out);
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  for (int w : {1, 2, 4}) {
    run("mma.sync m16n8k8 tf32", k_tf32<8>, w, 2.0 * 16 * 8 * 8, sms);
    run("mma.sync m16n8k16 f16", k_f16<8>, w, 2.0 * 16 * 8 * 16, sms);
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def main() -> int:
    from audio_classification_tpu_torch import _build

    out_dir = ROOT / "build" / "mma_peak"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, exe = out_dir / "mma_peak.cu", out_dir / "mma_peak"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(exe), str(src)], check=True)
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
