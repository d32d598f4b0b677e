// Native WAV codec: fast host-side decode/encode for the audio ingest path
// (the port's own copy of the JAX package's native/wavcodec.cpp).
//
// The reference pipeline reads audio through libsndfile / torchaudio C++
// (reference: benchmark_pipeline.py:45,127; overlap3_core.py:25-31). This is
// the port's host-side native component: a minimal, dependency-free
// RIFF/WAVE codec exposed over a C ABI and bound from Python via ctypes
// (audio_classification_tpu_torch/audio_io/wav.py).
//
// Supported: PCM 8/16/24/32-bit and IEEE float32/float64, any channel count.
// Built at first use by audio_classification_tpu_torch/_build.py:
//   g++ -O3 -fPIC -std=c++17 -shared -o build/native/libwavcodec_<hash>.so wavcodec.cpp

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr uint16_t kFormatPCM = 1;
constexpr uint16_t kFormatFloat = 3;
constexpr uint16_t kFormatExtensible = 0xFFFE;

struct WavInfo {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long long data_offset = 0;
  long long data_size = 0;
};

bool read_exact(FILE* f, void* buf, size_t n) { return fread(buf, 1, n, f) == n; }

// Walk RIFF chunks; fill fmt + data locations.
bool parse_header(FILE* f, WavInfo* info) {
  // Real file size: the declared data-chunk size must be clamped to it, or a
  // corrupt/streaming header (csize = 0xFFFFFFFF) would make callers allocate
  // gigabytes for a tiny file.
  if (fseek(f, 0, SEEK_END) != 0) return false;
  long long file_size = ftell(f);
  if (file_size < 0 || fseek(f, 0, SEEK_SET) != 0) return false;

  char magic[4];
  uint32_t riff_size;
  if (!read_exact(f, magic, 4) || memcmp(magic, "RIFF", 4) != 0) return false;
  if (!read_exact(f, &riff_size, 4)) return false;
  if (!read_exact(f, magic, 4) || memcmp(magic, "WAVE", 4) != 0) return false;

  bool have_fmt = false, have_data = false;
  while (!have_fmt || !have_data) {
    char cid[4];
    uint32_t csize;
    if (!read_exact(f, cid, 4) || !read_exact(f, &csize, 4)) break;
    long body = ftell(f);
    if (memcmp(cid, "fmt ", 4) == 0) {
      uint16_t tag, ch, block, bits;
      uint32_t sr, brate;
      if (!read_exact(f, &tag, 2) || !read_exact(f, &ch, 2) ||
          !read_exact(f, &sr, 4) || !read_exact(f, &brate, 4) ||
          !read_exact(f, &block, 2) || !read_exact(f, &bits, 2))
        return false;
      if (tag == kFormatExtensible && csize >= 40) {
        uint16_t ext_size, valid_bits;
        uint32_t cmask;
        uint16_t sub;
        if (!read_exact(f, &ext_size, 2) || !read_exact(f, &valid_bits, 2) ||
            !read_exact(f, &cmask, 4) || !read_exact(f, &sub, 2))
          return false;
        tag = sub;
      }
      info->format = tag;
      info->channels = ch;
      info->sample_rate = sr;
      info->bits = bits;
      have_fmt = true;
    } else if (memcmp(cid, "data", 4) == 0) {
      info->data_offset = body;
      long long avail = file_size - body;
      if (avail < 0) avail = 0;
      info->data_size = (long long)csize < avail ? (long long)csize : avail;
      have_data = true;
    }
    if (fseek(f, body + (long)csize + (csize & 1), SEEK_SET) != 0) break;
  }
  return have_fmt && have_data;
}

long long frames_of(const WavInfo& i) {
  if (i.channels == 0 || i.bits == 0) return 0;
  return i.data_size / ((long long)i.channels * (i.bits / 8));
}

}  // namespace

extern "C" {

// Returns 0 on success. Fills sample_rate, channels, frames.
int wav_read_info(const char* path, int* sample_rate, int* channels,
                  long long* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = parse_header(f, &info);
  fclose(f);
  if (!ok) return -2;
  *sample_rate = (int)info.sample_rate;
  *channels = (int)info.channels;
  *frames = frames_of(info);
  return 0;
}

// Decode interleaved samples into `out` (capacity = frames*channels floats).
// Returns the number of samples decoded (which may be less than the header
// declares for truncated files), or a negative error code.
long long wav_read_f32(const char* path, float* out, long long capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -2;
  }
  long long n = frames_of(info) * info.channels;
  if (n > capacity) n = capacity;
  if (fseek(f, (long)info.data_offset, SEEK_SET) != 0) {
    fclose(f);
    return -3;
  }
  const int bytes_per = info.bits / 8;
  std::vector<uint8_t> raw((size_t)(n * bytes_per));
  size_t got = fread(raw.data(), 1, raw.size(), f);
  fclose(f);
  long long n_avail = (long long)(got / bytes_per);
  if (n_avail < n) n = n_avail;

  const uint8_t* p = raw.data();
  if (info.format == kFormatPCM && info.bits == 16) {
    const int16_t* s = (const int16_t*)p;
    for (long long i = 0; i < n; ++i) out[i] = s[i] * (1.0f / 32768.0f);
  } else if (info.format == kFormatPCM && info.bits == 32) {
    const int32_t* s = (const int32_t*)p;
    for (long long i = 0; i < n; ++i) out[i] = s[i] * (1.0f / 2147483648.0f);
  } else if (info.format == kFormatPCM && info.bits == 24) {
    for (long long i = 0; i < n; ++i) {
      const uint8_t* b = p + i * 3;
      int32_t v = (int32_t)b[0] | ((int32_t)b[1] << 8) | ((int32_t)b[2] << 16);
      if (v & 0x800000) v -= (1 << 24);
      out[i] = v * (1.0f / 8388608.0f);
    }
  } else if (info.format == kFormatPCM && info.bits == 8) {
    for (long long i = 0; i < n; ++i) out[i] = ((int)p[i] - 128) * (1.0f / 128.0f);
  } else if (info.format == kFormatFloat && info.bits == 32) {
    memcpy(out, p, (size_t)n * 4);
  } else if (info.format == kFormatFloat && info.bits == 64) {
    const double* s = (const double*)p;
    for (long long i = 0; i < n; ++i) out[i] = (float)s[i];
  } else {
    return -4;
  }
  return n;
}

// Write interleaved float samples (clipped) as 16-bit PCM. Returns 0 on success.
int wav_write_pcm16(const char* path, const float* samples, long long n,
                    int channels, int sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t payload = (uint32_t)(n * 2);
  uint32_t riff_size = 36 + payload;
  uint16_t tag = kFormatPCM, ch = (uint16_t)channels, bits = 16;
  uint32_t sr = (uint32_t)sample_rate;
  uint32_t brate = sr * ch * 2;
  uint16_t block = ch * 2;
  uint32_t fmt_size = 16;
  fwrite("RIFF", 1, 4, f);
  fwrite(&riff_size, 4, 1, f);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  fwrite(&fmt_size, 4, 1, f);
  fwrite(&tag, 2, 1, f);
  fwrite(&ch, 2, 1, f);
  fwrite(&sr, 4, 1, f);
  fwrite(&brate, 4, 1, f);
  fwrite(&block, 2, 1, f);
  fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&payload, 4, 1, f);
  std::vector<int16_t> pcm((size_t)n);
  for (long long i = 0; i < n; ++i) {
    float v = samples[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    // Round-half-to-even, matching the numpy fallback's np.rint so both
    // write paths produce byte-identical files.
    pcm[(size_t)i] = (int16_t)nearbyintf(v * 32767.0f);
  }
  size_t wrote = fwrite(pcm.data(), 2, (size_t)n, f);
  fclose(f);
  return wrote == (size_t)n ? 0 : -2;
}

}  // extern "C"
