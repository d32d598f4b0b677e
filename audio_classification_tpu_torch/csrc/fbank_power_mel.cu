// K1 fbank_power_mel: windowed frames -> log-mel in ONE launch, through a
// real FFT of each frame, with the power spectrum kept on chip.
//
// Replaces audio_classification_tpu/ops/pallas/fbank_kernel.py
// (fbank_power_mel_pallas, body _kernel): frames [N, n_fft] -> power
// re^2 + im^2 of the F = n_fft / 2 + 1 DFT bins -> x mel [F, nb] ->
// log(max(., floor)). The TPU kernel forms the spectrum as two dense matrix
// products, since its matrix unit makes a matmul the cheap way to a
// spectrum; as a GEMM that is 2 * n_fft * F FMAs a frame (526k at n_fft 512)
// for a 2 KB frame.
//
// Bound on the H100: bytes. A real FFT of one frame costs ~16k float32
// operations at n_fft 512 (5 M log2 M for the complex FFT of M = n_fft / 2
// points, the split to the F bins, the power and each mel filter's own
// bins), against 2 KB of frame read and 4 * nb bytes of log-mel written: at
// [25584, 512] 60.6 MB, 0.018 ms at 3.35 TB/s, against 0.006 ms of
// operations at the 67 TFLOP/s float32 rate. All arithmetic is IEEE float32
// outside the tensor cores (TF32 breaks the log of small powers) and no
// fast-math intrinsic is used.
//
// Design: one warp per frame. Frames are taken in a grid-stride loop by a
// grid of as many blocks as the card holds at once, and each warp issues
// its next frame's loads before it transforms the current one.
//  1. A lane reads n_fft / 128 float4 of the frame: 16-byte loads, side by
//     side across the warp, over all n_fft columns (the 400 -> 512 zero pad
//     is not assumed). It packs z[m] = x[2m] + i x[2m+1] into the warp's
//     slice of shared memory.
//  2. An M-point complex FFT, Stockham (natural order in and out): radix-8
//     passes, or radix 4 / 2 where M / 32 or what is left of M is smaller.
//     Each lane holds M / 32 points in registers and does the radix-r DFTs
//     there (radix-2 DIT on registers); passes exchange through shared
//     memory with element i stored at i + i / 16, which cuts the strided
//     writes' bank conflicts from 8-way to at most 2-way.
//  3. The split to the F bins, X[k] = E + W^k O with E = (Z[k] + Z*[M-k]) / 2,
//     O = -i (Z[k] - Z*[M-k]) / 2 and Z[M] = Z[0], and the power |X[k]|^2,
//     written over the warp's slice.
//  4. Each mel filter sums only its own run of bins (the band table: first
//     bin and count per filter, weights [max count, nb]); then
//     logf(max(., floor)). The warp's lanes store a row of nb floats side by
//     side.
// Twiddles: W^e = exp(-2 pi i e / n_fft) for 0 <= e <= M, computed in
// float64 on the host and rounded to float32 (row 1 of ops/stft.py's
// _dft_basis_np); W^e = -W^(e - M) for e >= M. Each pass's twiddles are
// gathered once a block into the order its lanes read them. The radix-8
// DFT's one non-trivial constant, cos(pi / 4), is the table's value at
// e = M / 4 (checked by the tests).
// Each output element is written once, by the warp that owns its frame: no
// atomics, no memset, no second launch, and two calls with the same input
// give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tf32_mma.cuh"  // act::allow_dynamic_smem

namespace {

constexpr int WARPS = 8;  // frames in flight a block, one a warp
constexpr int THREADS = 32 * WARPS;
constexpr float RSQRT2 = 0.70710677f;  // float32(cos(pi / 4))

// radix of the Stockham pass that starts at sub-transform length ns
__host__ __device__ constexpr int radix_of(int m, int ns) {
  int r = 8;
  if (m / ns < r) r = m / ns;
  if (m / 32 < r) r = m / 32;
  return r;
}

// first entry of that pass's gathered twiddles: (r - 1) * ns entries for
// each earlier pass with ns > 1 (the first pass has none)
__host__ __device__ constexpr int pass_tw_offset(int m, int ns) {
  int off = 0;
  for (int s = 1; s < ns; s *= radix_of(m, s))
    if (s > 1) off += (radix_of(m, s) - 1) * s;
  return off;
}

__host__ __device__ constexpr int bitrev(int i, int r) {
  int o = 0;
  for (int b = 1; b < r; b *= 2) o = (o << 1) | ((i / b) & 1);
  return o;
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// v <- DFT_r(v), radix-2 decimation in time on registers; W_len^m = W_8^q
template <int R>
__device__ __forceinline__ void dft_regs(float2 (&v)[R]) {
  float2 t[R];
#pragma unroll
  for (int i = 0; i < R; ++i) t[i] = v[bitrev(i, R)];
#pragma unroll
  for (int len = 2; len <= R; len *= 2)
#pragma unroll
    for (int s = 0; s < R; s += len)
#pragma unroll
      for (int m = 0; m < len / 2; ++m) {
        const float2 a = t[s + m];
        float2 b = t[s + m + len / 2];
        const int q = m * 8 / len;
        if (q == 1) b = make_float2(RSQRT2 * (b.x + b.y), RSQRT2 * (b.y - b.x));
        if (q == 2) b = make_float2(b.y, -b.x);
        if (q == 3) b = make_float2(RSQRT2 * (b.y - b.x), -(RSQRT2 * (b.x + b.y)));
        t[s + m] = make_float2(a.x + b.x, a.y + b.y);
        t[s + m + len / 2] = make_float2(a.x - b.x, a.y - b.y);
      }
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = t[i];
}

// the pass twiddles W_{ns r}^{t k} = W^{t k 2M / (ns r)}, t = 1..r-1, k < ns,
// of every pass, gathered from the table once a block
template <int M, int NS>
__device__ void gather_pass_twiddles(float2* ptw, const float2* __restrict__ table) {
  if constexpr (NS < M) {
    constexpr int R = radix_of(M, NS);
    if constexpr (NS > 1) {
      float2* dst = ptw + pass_tw_offset(M, NS);
      for (int i = threadIdx.x; i < (R - 1) * NS; i += THREADS) {
        const int t = 1 + i / NS, k = i % NS, e = t * k * (2 * M / (NS * R));
        const float2 w = table[e < M ? e : e - M];
        dst[i] = e < M ? w : make_float2(-w.x, -w.y);
      }
    }
    gather_pass_twiddles<M, NS * R>(ptw, table);
  }
}

// the Stockham passes from sub-transform length NS on; zs is the warp's slice
template <int M, int NS>
__device__ __forceinline__ void fft_passes(float2* zs, const float2* ptw, int lane) {
  if constexpr (NS < M) {
    constexpr int R = radix_of(M, NS), NBF = M / 32 / R, STRIDE = M / R;
    const float2* tw = ptw + pass_tw_offset(M, NS);
    float2 v[NBF][R];
#pragma unroll
    for (int u = 0; u < NBF; ++u)
#pragma unroll
      for (int t = 0; t < R; ++t) v[u][t] = zs[pad(lane + 32 * u + t * STRIDE)];
    __syncwarp();
#pragma unroll
    for (int u = 0; u < NBF; ++u) {
      const int j = lane + 32 * u, k = j & (NS - 1);
      if constexpr (NS > 1) {
#pragma unroll
        for (int t = 1; t < R; ++t) v[u][t] = cmul(v[u][t], tw[(t - 1) * NS + k]);
      }
      dft_regs<R>(v[u]);
      const int base = (j - k) * R + k;
#pragma unroll
      for (int t = 0; t < R; ++t) zs[pad(base + t * NS)] = v[u][t];
    }
    __syncwarp();
    fft_passes<M, NS * R>(zs, ptw, lane);
  }
}

// |X[k]|^2 from a = Z[k], z = Z[M - k] and w = W^k
__device__ __forceinline__ float split_power(float2 a, float2 z, float2 w) {
  const float er = 0.5f * (a.x + z.x), ei = 0.5f * (a.y - z.y);
  const float dr = a.x - z.x, di = a.y + z.y;
  const float o_r = 0.5f * di, o_i = -0.5f * dr;
  const float xr = er + (o_r * w.x - o_i * w.y), xi = ei + (o_r * w.y + o_i * w.x);
  return xr * xr + xi * xi;
}

template <int NV4>
__device__ __forceinline__ void load_frame(float4 (&r)[NV4], const float* __restrict__ frames,
                                           int f, int lane) {
  const float4* row = reinterpret_cast<const float4*>(frames + (size_t)f * (NV4 * 128));
#pragma unroll
  for (int i = 0; i < NV4; ++i) r[i] = __ldcs(row + 32 * i + lane);
}

template <int NFFT>
struct Layout {
  static constexpr int M = NFFT / 2;
  static constexpr int NTW = pass_tw_offset(M, M);  // pass twiddles
  static constexpr int ZS = M + M / 16;             // a warp's padded slice (float2)
  // float2 entries before the band table: split twiddles, pass twiddles, slices
  static constexpr int F2 = M + 1 + NTW + WARPS * ZS;
  static size_t bytes(int nb, int bw) {
    return sizeof(float2) * F2 + sizeof(int2) * nb + sizeof(float) * (size_t)bw * nb;
  }
};

template <int NFFT>
__global__ void __launch_bounds__(THREADS)
fbank_fft_mel_kernel(const float* __restrict__ frames, const float2* __restrict__ table,
                     const int2* __restrict__ bands, const float* __restrict__ band_w,
                     float* __restrict__ out, int n, int nb, int bw, float log_floor) {
  using L = Layout<NFFT>;
  constexpr int M = L::M, PER_LANE = M / 32, NV4 = NFFT / 128;
  extern __shared__ float4 smem4[];
  float2* tw_s = reinterpret_cast<float2*>(smem4);  // [M + 1] the table, for the split
  float2* ptw = tw_s + (M + 1);                      // [NTW]
  float2* slices = ptw + L::NTW;                     // [WARPS][ZS]
  int2* band_s = reinterpret_cast<int2*>(tw_s + L::F2);  // [nb] first bin, count
  float* bw_s = reinterpret_cast<float*>(band_s + nb);   // [bw][nb]
  for (int i = threadIdx.x; i <= M; i += THREADS) tw_s[i] = table[i];
  gather_pass_twiddles<M, 1>(ptw, table);
  for (int i = threadIdx.x; i < nb; i += THREADS) band_s[i] = bands[i];
  for (int i = threadIdx.x; i < bw * nb; i += THREADS) bw_s[i] = band_w[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  float2* zs = slices + (threadIdx.x >> 5) * L::ZS;
  const int step = gridDim.x * WARPS;
  int f = blockIdx.x * WARPS + (threadIdx.x >> 5);
  float4 cur[NV4], nxt[NV4];
  if (f < n) load_frame<NV4>(cur, frames, f, lane);
  for (; f < n; f += step) {
    const bool more = f + step < n;
    if (more) load_frame<NV4>(nxt, frames, f + step, lane);
#pragma unroll
    for (int i = 0; i < NV4; ++i) {
      const int m = 2 * (32 * i + lane);
      zs[pad(m)] = make_float2(cur[i].x, cur[i].y);
      zs[pad(m + 1)] = make_float2(cur[i].z, cur[i].w);
    }
    __syncwarp();
    fft_passes<M, 1>(zs, ptw, lane);

    float p[PER_LANE];
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int k = lane + 32 * u;
      p[u] = split_power(zs[pad(k)], zs[pad((M - k) & (M - 1))], tw_s[k]);
    }
    const float p_m = split_power(zs[0], zs[0], tw_s[M]);  // bin M, Z[M] = Z[0]
    __syncwarp();
    float* pw = reinterpret_cast<float*>(zs);  // [M + 1] power, over the slice
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) pw[lane + 32 * u] = p[u];
    if (lane == 0) pw[M] = p_m;
    __syncwarp();

    float* row = out + (size_t)f * nb;
    for (int b = lane; b < nb; b += 32) {
      const int2 fc = band_s[b];
      float s = 0.f;
      for (int q = 0; q < fc.y; ++q) s = fmaf(pw[fc.x + q], bw_s[q * nb + b], s);
      row[b] = logf(fmaxf(s, log_floor));
    }
    __syncwarp();  // the slice is the next frame's
    if (!more) break;
#pragma unroll
    for (int i = 0; i < NV4; ++i) cur[i] = nxt[i];
  }
}

// a grid that the card holds at once: blocks per SM for this shared-memory
// size (cached per device as (bytes << 8) | blocks) times the SM count
template <int NFFT>
cudaError_t resident_blocks(size_t smem, int* blocks) {
  static std::atomic<uint64_t> raised{0};
  static std::atomic<uint64_t> cache[64];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const uint64_t hit = dev < 64 ? cache[dev].load(std::memory_order_relaxed) : 0;
  if (hit >> 8 == smem && (hit & 0xff) != 0) {
    per_sm = (int)(hit & 0xff);
  } else {
    if (smem > 48 * 1024 &&
        (e = act::allow_dynamic_smem(reinterpret_cast<const void*>(fbank_fft_mel_kernel<NFFT>),
                                     raised)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fbank_fft_mel_kernel<NFFT>,
                                                           THREADS, smem)) != cudaSuccess)
      return e;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;  // more shared memory than a block has
    if (dev < 64) cache[dev].store(((uint64_t)smem << 8) | (uint64_t)(per_sm & 0xff));
  }
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <int NFFT>
int launch(const float* frames, const float* table, const int* bands, const float* band_w,
           float* out, int n, int nb, int bw, float log_floor, cudaStream_t stream) {
  const size_t smem = Layout<NFFT>::bytes(nb, bw);
  int cap = 0;
  cudaError_t e = resident_blocks<NFFT>(smem, &cap);
  if (e != cudaSuccess) return (int)e;
  const int want = (n + WARPS - 1) / WARPS;
  fbank_fft_mel_kernel<NFFT><<<want < cap ? want : cap, THREADS, smem, stream>>>(
      frames, reinterpret_cast<const float2*>(table), reinterpret_cast<const int2*>(bands),
      band_w, out, n, nb, bw, log_floor);
  return (int)cudaGetLastError();
}

}  // namespace

// frames [n, n_fft] (16-byte aligned rows), table [n_fft / 2 + 1, 2] (W^e as
// cos, -sin), bands [nb, 2] (first bin, count), band_w [bw, nb] -> out [n, nb].
// n_fft is 256, 512 or 1024.
extern "C" int act_fbank_power_mel(const float* frames, const float* table, const int* bands,
                                   const float* band_w, float* out, int n, int n_fft, int nb,
                                   int bw, float log_floor, cudaStream_t stream) {
  if (n <= 0 || nb <= 0) return 0;
  if (bw <= 0) return (int)cudaErrorInvalidValue;
  switch (n_fft) {
    case 256: return launch<256>(frames, table, bands, band_w, out, n, nb, bw, log_floor, stream);
    case 512: return launch<512>(frames, table, bands, band_w, out, n, nb, bw, log_floor, stream);
    case 1024:
      return launch<1024>(frames, table, bands, band_w, out, n, nb, bw, log_floor, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
