// Native host runtime: byte-level ingest/emit + prefetching block reader.
//
// Replacement for the reference's host I/O layer
// (src/iofunc.cpp:61-69 stdin block reader, src/fm_radio.cpp:286-302 audio
// emitter) and its ring-buffer/thread machinery (src/fm_radio.cpp:51,86-145).
// The DSP no longer needs the ring buffer — the receiver step consumes whole
// blocks — but overlap of stdin reads with device compute still wants a
// producer thread, implemented here once in C++ and exposed to Python via a
// plain C ABI (ctypes).
//
// Build: `make` in this directory -> librtsdr_runtime.so

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cerrno>
#include <mutex>
#include <poll.h>
#include <queue>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

// uint8 interleaved IQ -> normalized float32 I and Q planes: (b-128)/128
// (reference src/iofunc.cpp:67).
void rtsdr_deinterleave_normalize(const uint8_t* in, int64_t n_pairs,
                                  float* i_out, float* q_out) {
  constexpr float kScale = 1.0f / 128.0f;
  for (int64_t k = 0; k < n_pairs; ++k) {
    i_out[k] = (static_cast<float>(in[2 * k]) - 128.0f) * kScale;
    q_out[k] = (static_cast<float>(in[2 * k + 1]) - 128.0f) * kScale;
  }
}

void rtsdr_normalize_u8(const uint8_t* in, int64_t n, float* out) {
  constexpr float kScale = 1.0f / 128.0f;
  for (int64_t k = 0; k < n; ++k) {
    out[k] = (static_cast<float>(in[k]) - 128.0f) * kScale;
  }
}

// float L/R -> interleaved int16 with NaN guard and scaling (reference
// src/fm_radio.cpp:286-302: NaN->0, scale, cast).
void rtsdr_emit_int16_interleave(const float* left, const float* right,
                                 int64_t n, float scale, int16_t* out) {
  for (int64_t k = 0; k < n; ++k) {
    float l = left[k];
    float r = right[k];
    if (std::isnan(l)) l = 0.0f;
    if (std::isnan(r)) r = 0.0f;
    l *= scale;
    r *= scale;
    if (l > 32767.0f) l = 32767.0f;
    if (l < -32768.0f) l = -32768.0f;
    if (r > 32767.0f) r = 32767.0f;
    if (r < -32768.0f) r = -32768.0f;
    out[2 * k] = static_cast<int16_t>(l);
    out[2 * k + 1] = static_cast<int16_t>(r);
  }
}

// ---------------------------------------------------------------------------
// Prefetching block reader: a producer thread reads fixed-size blocks from a
// file descriptor into a bounded pool of slots (the functional successor of
// the reference's QUEUE_BLOCKS=5 ring + condvar backpressure,
// src/fm_radio.cpp:22,86-145, without the overwrite race its authors noted
// at src/fm_radio.cpp:25-28: a slot is never reused until released).
// ---------------------------------------------------------------------------

struct BlockReader {
  int fd;
  int64_t block_size;
  int n_slots;
  std::vector<std::vector<uint8_t>> slots;
  std::queue<int> free_slots;   // slots available to the producer
  std::queue<int> ready_slots;  // filled slots in FIFO order
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::atomic<bool> eof{false};
  std::atomic<bool> stop{false};
  std::thread producer;

  BlockReader(int fd_, int64_t bs, int ns)
      : fd(fd_), block_size(bs), n_slots(ns), slots(ns) {
    for (int s = 0; s < ns; ++s) {
      slots[s].resize(bs);
      free_slots.push(s);
    }
    producer = std::thread([this] { run(); });
  }

  void run() {
    while (!stop.load()) {
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [this] { return !free_slots.empty() || stop.load(); });
        if (stop.load()) return;
        slot = free_slots.front();
        free_slots.pop();
      }
      int64_t got = 0;
      uint8_t* buf = slots[slot].data();
      while (got < block_size) {
        // Poll with a timeout so stop is observed even when the pipe is
        // stalled with no data (a blocking read here would make destroy()
        // hang until the writer produces bytes or closes).
        if (stop.load()) {
          std::lock_guard<std::mutex> lk(mu);
          free_slots.push(slot);
          return;
        }
        struct pollfd pfd = {fd, POLLIN, 0};
        int pr = poll(&pfd, 1, 200 /* ms */);
        if (pr == 0) continue;  // timeout: re-check stop
        if (pr < 0) {
          if (errno == EINTR) continue;
          eof.store(true);  // unexpected poll failure: treat as stream end
          std::lock_guard<std::mutex> lk(mu);
          free_slots.push(slot);
          cv_ready.notify_all();
          return;
        }
        ssize_t r = read(fd, buf + got, block_size - got);
        if (r <= 0) {  // EOF or error: drain and stop
          eof.store(true);
          std::lock_guard<std::mutex> lk(mu);
          free_slots.push(slot);  // partial block dropped, like the reference
          cv_ready.notify_all();
          return;
        }
        got += r;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ready_slots.push(slot);
      }
      cv_ready.notify_one();
    }
  }

  // Returns slot index with a full block, or -1 on EOF-and-drained.
  int acquire() {
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.wait(lk, [this] { return !ready_slots.empty() || eof.load(); });
    if (ready_slots.empty()) return -1;
    int s = ready_slots.front();
    ready_slots.pop();
    return s;
  }

  // Whole blocks waiting to be acquired, without waiting: -1 once the
  // stream has ended and none is left.  A block still arriving counts 0.
  int ready() {
    std::lock_guard<std::mutex> lk(mu);
    if (ready_slots.empty() && eof.load()) return -1;
    return static_cast<int>(ready_slots.size());
  }

  void release(int slot) {
    {
      std::lock_guard<std::mutex> lk(mu);
      free_slots.push(slot);
    }
    cv_free.notify_one();
  }

  ~BlockReader() {
    stop.store(true);
    cv_free.notify_all();
    if (producer.joinable()) producer.join();
  }
};

void* rtsdr_reader_create(int fd, int64_t block_size, int n_slots) {
  return new BlockReader(fd, block_size, n_slots);
}

int rtsdr_reader_acquire(void* h) {
  return static_cast<BlockReader*>(h)->acquire();
}

int rtsdr_reader_ready(void* h) {
  return static_cast<BlockReader*>(h)->ready();
}

const uint8_t* rtsdr_reader_slot(void* h, int slot) {
  return static_cast<BlockReader*>(h)->slots[slot].data();
}

void rtsdr_reader_release(void* h, int slot) {
  static_cast<BlockReader*>(h)->release(slot);
}

void rtsdr_reader_destroy(void* h) { delete static_cast<BlockReader*>(h); }

}  // extern "C"
