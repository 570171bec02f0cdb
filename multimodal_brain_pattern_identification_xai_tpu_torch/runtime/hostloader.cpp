// Host-side data runtime of the port (a copy of the JAX package's
// runtime/hostloader.cpp; the port imports nothing of that package).
//
// All signal processing runs on the device; what remains on the host is
// data movement: gathering shuffled windows out of a large float32 store
// into contiguous batch buffers, repairing NaNs, and keeping a ring of
// batches ready ahead of the device.  Python threads cannot scale that (the
// GIL), so it lives here:
//
//   * gather_windows(): multithreaded strided gather + per-channel
//     NaN->mean repair (the mean of the finite values in double);
//   * gather_multimodal(): one combined EEG + spectrogram batch (strided
//     EEG copy, spectrogram crop / transpose / zero pad);
//   * BatchQueue: N worker threads fill a bounded ring of batch buffers
//     from an epoch permutation, published in order; the consumer pops
//     complete batches without holding the GIL.
//
// A plain C ABI for ctypes, built with g++ at first use
// (_build.load_host).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// gather_windows: out[i] = src[idx[i]] with NaN->channel-mean repair.
//   src:   (n_records, channels, length) float32
//   idx:   (batch,) int64 record indices
//   out:   (batch, channels, length) float32
// ---------------------------------------------------------------------------
void gather_windows(const float* src, const int64_t* idx, float* out,
                    int64_t batch, int64_t channels, int64_t length,
                    int n_threads) {
  const int64_t rec_stride = channels * length;
  auto work = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      const float* rec = src + idx[i] * rec_stride;
      float* dst = out + i * rec_stride;
      for (int64_t c = 0; c < channels; ++c) {
        const float* ch = rec + c * length;
        float* oc = dst + c * length;
        // first pass: mean of finite values
        double sum = 0.0;
        int64_t cnt = 0;
        bool any_nan = false;
        for (int64_t t = 0; t < length; ++t) {
          float v = ch[t];
          if (std::isnan(v)) {
            any_nan = true;
          } else {
            sum += v;
            ++cnt;
          }
        }
        if (!any_nan) {
          std::memcpy(oc, ch, sizeof(float) * length);
        } else {
          const float mean = cnt > 0 ? static_cast<float>(sum / cnt) : 0.0f;
          for (int64_t t = 0; t < length; ++t) {
            float v = ch[t];
            oc[t] = std::isnan(v) ? mean : v;
          }
        }
      }
    }
  };
  if (n_threads <= 1 || batch < 2) {
    work(0, batch);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t per = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t b = t * per, e = std::min(batch, b + per);
    if (b >= e) break;
    pool.emplace_back(work, b, e);
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// gather_multimodal: assemble one combined EEG+spectrogram batch.
//
// EEG side: eeg_out[i] = eeg_src[eeg_idx[i]] (windows are NaN-repaired at
// cache-build time, so this is a straight strided copy).
// Spectrogram side: per batch row, crop `width` time-rows out of the ragged
// spectrogram store starting at crop_start[i], transpose to (freq, time)
// and zero-pad the tail — the host half of the reference's
// HMS_Spectrogram_Dataset offset crop (XAI_Multimodality.py:713-726).
//
//   eeg_src:    (n_eeg, channels, length) float32, resident
//   spec_buf:   concatenated ragged (rows_i, n_freq) planes, time-major
//   spec_off:   (n_spec,) start row of each plane in spec_buf
//   spec_len:   (n_spec,) row count of each plane
//   spec_idx:   (batch,) plane index per batch row
//   crop_start: (batch,) first time-row of the crop (pre-clamped)
//   spec_out:   (batch, n_freq, width) float32
//
// Either output pointer may be null to skip that modality entirely (a
// single-branch training run must not pay the other branch's copy).
// ---------------------------------------------------------------------------
void gather_multimodal(const float* eeg_src, const int64_t* eeg_idx,
                       const float* spec_buf, const int64_t* spec_off,
                       const int64_t* spec_len, const int64_t* spec_idx,
                       const int64_t* crop_start,
                       float* eeg_out, float* spec_out,
                       int64_t batch, int64_t channels, int64_t length,
                       int64_t n_freq, int64_t width, int n_threads) {
  const int64_t eeg_stride = channels * length;
  const int64_t spec_stride = n_freq * width;
  auto work = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      if (eeg_out)
        std::memcpy(eeg_out + i * eeg_stride,
                    eeg_src + eeg_idx[i] * eeg_stride,
                    sizeof(float) * eeg_stride);
      if (!spec_out) continue;
      const int64_t s = spec_idx[i];
      const float* plane = spec_buf + spec_off[s] * n_freq;  // (rows, F)
      const int64_t rows = spec_len[s];
      // defensive clamp: a negative start must never read before the plane
      const int64_t start = crop_start[i] < 0 ? 0 : crop_start[i];
      const int64_t avail =
          rows > start ? std::min(width, rows - start) : 0;
      float* dst = spec_out + i * spec_stride;               // (F, W)
      if (avail < width)
        std::memset(dst, 0, sizeof(float) * spec_stride);
      // cache-blocked transpose: the naive t-outer/f-inner loop touches
      // n_freq distinct cache lines per time-row and revisits each one
      // `width` times — over a ~480 KB destination that is a hard L1/L2
      // miss per element.  64x64 tiles keep both the source tile
      // (64 rows x 256 B) and the destination tile resident.
      constexpr int64_t TB = 64;
      for (int64_t t0 = 0; t0 < avail; t0 += TB) {
        const int64_t t1 = std::min(avail, t0 + TB);
        for (int64_t f0 = 0; f0 < n_freq; f0 += TB) {
          const int64_t f1 = std::min(n_freq, f0 + TB);
          for (int64_t f = f0; f < f1; ++f) {
            float* drow = dst + f * width;
            const float* col = plane + (start + t0) * n_freq + f;
            for (int64_t t = t0; t < t1; ++t, col += n_freq)
              drow[t] = *col;
          }
        }
      }
    }
  };
  if (n_threads <= 1 || batch < 2) {
    work(0, batch);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t per = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t b = t * per, e = std::min(batch, b + per);
    if (b >= e) break;
    pool.emplace_back(work, b, e);
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// BatchQueue: background batch assembly with a bounded ring.
// ---------------------------------------------------------------------------
struct BatchQueue {
  const float* src = nullptr;       // (n_records, channels, length)
  const float* labels = nullptr;    // (n_records, n_classes)
  int64_t channels = 0, length = 0, n_classes = 0;
  int64_t batch = 0;
  std::vector<int64_t> order;       // epoch permutation
  std::atomic<int64_t> cursor{0};
  int64_t n_batches = 0;

  std::queue<std::pair<std::vector<float>, std::vector<float>>> ready;
  // batches are pushed in sequence order (workers gather concurrently but
  // wait their turn to publish): the consumer sees exactly the epoch
  // permutation's batch order regardless of worker count — deterministic
  // data streams are what make bitwise checkpoint-resume possible
  int64_t next_push = 0;
  // freelist of retired batch buffers: reusing them caps the resident
  // set at ~(capacity + workers) buffers and — more importantly on a
  // cgroup-limited host — avoids paying first-touch page faults and
  // value-initialization (memset) for every batch's vectors
  std::vector<std::pair<std::vector<float>, std::vector<float>>> spare;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t capacity = 4;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<int> active_workers{0};

  void worker_loop(int n_threads_gather) {
    for (;;) {
      int64_t b = cursor.fetch_add(1);
      if (b >= n_batches || stop.load()) break;
      std::vector<float> xbuf, ybuf;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (!spare.empty()) {
          xbuf = std::move(spare.back().first);
          ybuf = std::move(spare.back().second);
          spare.pop_back();
        }
      }
      xbuf.resize(batch * channels * length);
      ybuf.resize(batch * n_classes);
      const int64_t* idx = order.data() + b * batch;
      gather_windows(src, idx, xbuf.data(), batch, channels, length,
                     n_threads_gather);
      for (int64_t i = 0; i < batch; ++i)
        std::memcpy(ybuf.data() + i * n_classes,
                    labels + idx[i] * n_classes, sizeof(float) * n_classes);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return (b == next_push && ready.size() < capacity) || stop.load();
      });
      if (stop.load()) break;
      ready.emplace(std::move(xbuf), std::move(ybuf));
      ++next_push;
      cv_ready.notify_one();
      cv_space.notify_all();      // wake the worker holding batch b+1
    }
    if (active_workers.fetch_sub(1) == 1) cv_ready.notify_all();
  }
};

void* bq_create(const float* src, const float* labels, const int64_t* order,
                int64_t n_order, int64_t channels, int64_t length,
                int64_t n_classes, int64_t batch, int n_workers,
                int queue_capacity) {
  auto* q = new BatchQueue();
  q->src = src;
  q->labels = labels;
  q->channels = channels;
  q->length = length;
  q->n_classes = n_classes;
  q->batch = batch;
  q->order.assign(order, order + n_order);
  q->n_batches = n_order / batch;
  q->capacity = queue_capacity > 0 ? queue_capacity : 4;
  int nw = n_workers > 0 ? n_workers : 2;
  q->active_workers = nw;
  for (int i = 0; i < nw; ++i)
    q->workers.emplace_back(&BatchQueue::worker_loop, q, 1);
  return q;
}

// Pops one batch into caller buffers. Returns 1 on success, 0 when drained.
int bq_next(void* handle, float* x_out, float* y_out) {
  auto* q = static_cast<BatchQueue*>(handle);
  std::unique_lock<std::mutex> lk(q->mu);
  q->cv_ready.wait(lk, [&] {
    return !q->ready.empty() || q->active_workers.load() == 0;
  });
  if (q->ready.empty()) return 0;
  auto item = std::move(q->ready.front());
  q->ready.pop();
  // notify_all: with ordered publishing only the worker holding the
  // next_push batch may proceed — notify_one could wake a different one
  q->cv_space.notify_all();
  lk.unlock();
  std::memcpy(x_out, item.first.data(), item.first.size() * sizeof(float));
  std::memcpy(y_out, item.second.data(), item.second.size() * sizeof(float));
  {
    // retire the drained buffers into the freelist for the next gather
    std::unique_lock<std::mutex> lk2(q->mu);
    q->spare.emplace_back(std::move(item.first), std::move(item.second));
  }
  return 1;
}

int64_t bq_num_batches(void* handle) {
  return static_cast<BatchQueue*>(handle)->n_batches;
}

void bq_destroy(void* handle) {
  auto* q = static_cast<BatchQueue*>(handle);
  q->stop.store(true);
  q->cv_space.notify_all();
  q->cv_ready.notify_all();
  for (auto& th : q->workers) th.join();
  delete q;
}

}  // extern "C"
