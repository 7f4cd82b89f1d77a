// Native host-side audio runtime of the port's streaming path: the port's own
// copy of parler_tts_tpu/native/audio_runtime.cpp, with the same functions
// behind a plain C interface that `native/__init__.py` binds with ctypes (as
// the port binds its CUDA kernels), so the build needs no Python headers:
//
//   float_to_pcm16(src, n, dst)                 float32 -> int16 PCM (clamped)
//   write_wav(path, rate, src, n)               mono 16-bit WAV; samples or -1
//   build_delayed_labels(codes, K, T, bos, eos, out)   (T+K+1, K) int32 labels
//   ring_create / ring_push / ring_pop / ring_size / ring_destroy
//                                               a bounded, thread-safe byte ring
//
// The ring buffer decouples the generation thread from an audio consumer with
// bounded memory. ctypes releases the interpreter lock around each call, so a
// producer and a consumer copy bytes at the same time.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

inline int16_t to_pcm16(float x) {
  x = x < -1.0f ? -1.0f : (x > 1.0f ? 1.0f : x);
  return static_cast<int16_t>(x * 32767.0f);
}

void put_u32(FILE* f, uint32_t v) { fwrite(&v, 4, 1, f); }
void put_u16(FILE* f, uint16_t v) { fwrite(&v, 2, 1, f); }

struct Ring {
  std::vector<uint8_t> buf;
  size_t head = 0;  // bytes written so far
  size_t tail = 0;  // bytes read so far
  std::mutex mu;
  explicit Ring(size_t capacity) : buf(capacity) {}
};

}  // namespace

extern "C" {

void float_to_pcm16(const float* src, long long n, int16_t* dst) {
  for (long long i = 0; i < n; ++i) dst[i] = to_pcm16(src[i]);
}

long long write_wav(const char* path, int rate, const float* src, long long n) {
  std::vector<int16_t> pcm(static_cast<size_t>(n));
  float_to_pcm16(src, n, pcm.data());
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const uint32_t data_bytes = static_cast<uint32_t>(n * 2);
  fwrite("RIFF", 1, 4, f);
  put_u32(f, 36 + data_bytes);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  put_u32(f, 16);
  put_u16(f, 1);  // PCM
  put_u16(f, 1);  // mono
  put_u32(f, static_cast<uint32_t>(rate));
  put_u32(f, static_cast<uint32_t>(rate) * 2);
  put_u16(f, 2);
  put_u16(f, 16);
  fwrite("data", 1, 4, f);
  put_u32(f, data_bytes);
  const size_t written = fwrite(pcm.data(), 2, pcm.size(), f);
  if (fclose(f) != 0 || written != pcm.size()) return -1;
  return n;
}

// codes (K, T) row-major -> out (T+K+1, K): BOS where t <= k, codebook k's
// code t-1-k after it, EOS in the tail (the training labels' delay pattern)
void build_delayed_labels(const int32_t* codes, int k_codebooks, int t_len, int bos, int eos,
                          int32_t* out) {
  const int out_t = t_len + 1 + k_codebooks;
  for (int t = 0; t < out_t; ++t) {
    for (int k = 0; k < k_codebooks; ++k) {
      int32_t v;
      if (t <= k) {
        v = bos;
      } else {
        const int src_t = t - 1 - k;
        v = src_t < t_len ? codes[k * t_len + src_t] : eos;
      }
      out[t * k_codebooks + k] = v;
    }
  }
}

void* ring_create(long long capacity) {
  return capacity > 0 ? new Ring(static_cast<size_t>(capacity)) : nullptr;
}

void ring_destroy(void* ring) { delete static_cast<Ring*>(ring); }

// copies as many of the n bytes as fit; returns that count
long long ring_push(void* ring, const uint8_t* data, long long n) {
  Ring& r = *static_cast<Ring*>(ring);
  std::lock_guard<std::mutex> lock(r.mu);
  const size_t cap = r.buf.size();
  const size_t pushed = std::min(cap - (r.head - r.tail), static_cast<size_t>(n));
  for (size_t i = 0; i < pushed; ++i) r.buf[(r.head + i) % cap] = data[i];
  r.head += pushed;
  return static_cast<long long>(pushed);
}

// copies up to n buffered bytes into out; returns that count
long long ring_pop(void* ring, uint8_t* out, long long n) {
  Ring& r = *static_cast<Ring*>(ring);
  std::lock_guard<std::mutex> lock(r.mu);
  const size_t cap = r.buf.size();
  const size_t popped = std::min(r.head - r.tail, static_cast<size_t>(n));
  for (size_t i = 0; i < popped; ++i) out[i] = r.buf[(r.tail + i) % cap];
  r.tail += popped;
  return static_cast<long long>(popped);
}

long long ring_size(void* ring) {
  Ring& r = *static_cast<Ring*>(ring);
  std::lock_guard<std::mutex> lock(r.mu);
  return static_cast<long long>(r.head - r.tail);
}

}  // extern "C"
