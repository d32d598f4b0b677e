// K1 fbank_power_mel: windowed frames -> log-mel, with the power spectrum
// kept on chip.
//
// Replaces audio_classification_tpu/ops/pallas/fbank_kernel.py
// (fbank_power_mel_pallas, body _kernel): frames [N, n_fft] x cos/-sin DFT
// bases [n_fft, F] -> power re^2 + im^2 -> x mel [F, nb] -> log(max(., floor)).
//
// Bound on the H100: arithmetic. Each frame costs 2 * n_fft * F FMAs for the
// DFT (512 x 257 x 2 = 263k) against 2 KB read, far above the memory
// roofline. Parity with the f32 reference needs IEEE f32 (TF32 keeps ~3
// digits and breaks the log of small powers), so this is SIMT, not tensor
// cores. Design: the DFT is a tiled GEMM (csrc/sgemm_tile.cuh, 8 x 8 outputs
// per thread) of 128 frames against 64 bins, the cos and -sin columns of a
// bin landing in the same thread; its epilogue forms the [128, 64] power
// tile in shared memory only, multiplies it by those 64 mel rows and adds
// the partial [128, nb] mel energies into the output with float atomics.
// The grid spans frame tiles x bin chunks, so a single item's few thousand
// frames still fill the card; a second launch takes the log in place. The
// [N, F] power spectrum never reaches device memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sgemm_tile.cuh"

namespace {

constexpr int TM = 8, TN = 8;      // GEMM outputs per thread
constexpr int BM = 16 * TM;        // frames per block
constexpr int NBIN = 16 * TN / 2;  // DFT bins per block: columns [re | im]
constexpr int GT = act::GEMM_THREADS;
constexpr int SMEM = act::gemm_smem_floats<TM, TN>() > BM * (NBIN + 1)
                         ? act::gemm_smem_floats<TM, TN>()
                         : BM * (NBIN + 1);

struct LoadFrames {
  const float* frames;  // [N, n_fft]
  int n, n_fft;
  __device__ float operator()(int r, int k) const {
    return r < n ? frames[(size_t)r * n_fft + k] : 0.f;
  }
};

// B columns: c < NBIN is cos of bin b0 + c, c >= NBIN is -sin of bin b0 + c - NBIN
struct LoadBasis {
  const float* cos_b;
  const float* msin_b;
  int nf, b0;
  __device__ float operator()(int k, int c) const {
    const int bin = b0 + (c < NBIN ? c : c - NBIN);
    if (bin >= nf) return 0.f;
    return (c < NBIN ? cos_b : msin_b)[(size_t)k * nf + bin];
  }
};

// mel[N, nb] += power(frames tile, bin chunk) x mel_w rows of the chunk
__global__ void __launch_bounds__(GT)
power_mel_kernel(const float* __restrict__ frames, const float* __restrict__ cos_b,
                 const float* __restrict__ msin_b, const float* __restrict__ mel_w,
                 float* __restrict__ mel, int n, int n_fft, int nf, int nb) {
  __shared__ float smem[SMEM];
  const int m0 = blockIdx.x * BM, b0 = blockIdx.y * NBIN;
  float acc[TM][TN];
  act::gemm_tile(smem, LoadFrames{frames, n, n_fft}, LoadBasis{cos_b, msin_b, nf, b0}, n_fft,
                 m0, 0, acc);

  // the thread's columns tx + 16 j: j < TN/2 are re of bins tx + 16 j, the
  // rest im of the same bins; gemm_tile ended with a barrier, so smem is free
  float* pow_s = smem;  // [BM][NBIN + 1]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN / 2; ++j) {
      const float re = acc[i][j], im = acc[i][j + TN / 2];
      pow_s[(ty + 16 * i) * (NBIN + 1) + tx + 16 * j] = re * re + im * im;
    }
  __syncthreads();

  const int nq = min(NBIN, nf - b0);
  for (int o = threadIdx.x; o < BM * nb; o += GT) {
    const int r = o / nb, c = o - r * nb;
    if (m0 + r >= n) break;  // rows grow with o
    float s = 0.f;
    for (int q = 0; q < nq; ++q)
      s = fmaf(pow_s[r * (NBIN + 1) + q], mel_w[(size_t)(b0 + q) * nb + c], s);
    if (s != 0.f) atomicAdd(&mel[(size_t)(m0 + r) * nb + c], s);
  }
}

__global__ void log_floor_kernel(float* __restrict__ x, size_t count, float floor_) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x)
    x[i] = logf(fmaxf(x[i], floor_));
}

}  // namespace

// frames [n, n_fft], cos_b / msin_b [n_fft, nf], mel_w [nf, nb] -> out [n, nb]
extern "C" int act_fbank_power_mel(const float* frames, const float* cos_b, const float* msin_b,
                                   const float* mel_w, float* out, int n, int n_fft, int nf,
                                   int nb, float log_floor, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_fft % act::BKK != 0) return (int)cudaErrorInvalidValue;
  const size_t count = (size_t)n * nb;
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(float) * count, stream);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n + BM - 1) / BM, (nf + NBIN - 1) / NBIN);
  power_mel_kernel<<<grid, GT, 0, stream>>>(frames, cos_b, msin_b, mel_w, out, n, n_fft, nf, nb);
  const size_t blocks = (count + 255) / 256;
  log_floor_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(out, count,
                                                                               log_floor);
  return (int)cudaGetLastError();
}
