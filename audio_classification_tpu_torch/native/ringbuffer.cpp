// Lock-free SPSC float ring buffer for the streaming capture path (the
// port's own copy of the JAX package's native/ringbuffer.cpp).
//
// The reference's streaming app pumps PortAudio int16 chunks through Python
// threads and spawns one analysis thread per chunk
// (reference: streaming_overlap_3src.py:102-146,
//  streaming_overlap3_core.py:142-144 -- a known design smell). The rebuild
// replaces that with a bounded native ring buffer: the capture thread
// (producer) pushes float frames, the host pump thread (consumer) pops
// fixed-size blocks which become padded device batches. Exposed via a C ABI
// for ctypes (audio_classification_tpu_torch/audio_io/stream_buffer.py);
// built at first use by audio_classification_tpu_torch/_build.py.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct RingBuffer {
  float* data;
  long long capacity;  // number of float slots
  std::atomic<long long> head;  // write position (producer)
  std::atomic<long long> tail;  // read position (consumer)
  std::atomic<long long> dropped;  // samples dropped on overflow
};

}  // namespace

extern "C" {

void* rb_create(long long capacity) {
  if (capacity <= 0) return nullptr;
  auto* rb = new (std::nothrow) RingBuffer;
  if (!rb) return nullptr;
  rb->data = new (std::nothrow) float[capacity];
  if (!rb->data) {
    delete rb;
    return nullptr;
  }
  rb->capacity = capacity;
  rb->head.store(0);
  rb->tail.store(0);
  rb->dropped.store(0);
  return rb;
}

void rb_destroy(void* h) {
  auto* rb = static_cast<RingBuffer*>(h);
  if (!rb) return;
  delete[] rb->data;
  delete rb;
}

long long rb_size(void* h) {
  auto* rb = static_cast<RingBuffer*>(h);
  return rb->head.load(std::memory_order_acquire) -
         rb->tail.load(std::memory_order_acquire);
}

long long rb_capacity(void* h) {
  return static_cast<RingBuffer*>(h)->capacity;
}

long long rb_dropped(void* h) {
  return static_cast<RingBuffer*>(h)->dropped.load(std::memory_order_relaxed);
}

// Producer: push n samples; drops the excess if the buffer would overflow
// (bounded backpressure — real-time capture must never block).
// Returns number of samples actually written.
long long rb_push(void* h, const float* src, long long n) {
  auto* rb = static_cast<RingBuffer*>(h);
  long long head = rb->head.load(std::memory_order_relaxed);
  long long tail = rb->tail.load(std::memory_order_acquire);
  long long free_slots = rb->capacity - (head - tail);
  long long to_write = n < free_slots ? n : free_slots;
  if (to_write < n)
    rb->dropped.fetch_add(n - to_write, std::memory_order_relaxed);
  for (long long i = 0; i < to_write; ++i)
    rb->data[(head + i) % rb->capacity] = src[i];
  rb->head.store(head + to_write, std::memory_order_release);
  return to_write;
}

// Consumer: pop up to n samples into dst. Returns count popped.
long long rb_pop(void* h, float* dst, long long n) {
  auto* rb = static_cast<RingBuffer*>(h);
  long long tail = rb->tail.load(std::memory_order_relaxed);
  long long head = rb->head.load(std::memory_order_acquire);
  long long avail = head - tail;
  long long to_read = n < avail ? n : avail;
  for (long long i = 0; i < to_read; ++i)
    dst[i] = rb->data[(tail + i) % rb->capacity];
  rb->tail.store(tail + to_read, std::memory_order_release);
  return to_read;
}

}  // extern "C"
