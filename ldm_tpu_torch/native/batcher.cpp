// Native host-side data pipeline of the PyTorch port: fused gather+normalize,
// a threaded prefetch ring and the serving slot queue.  The port's own copy
// of ldm_tpu/native/batcher.cpp (the port imports nothing of the JAX
// package); the C interface is the same.
//
// The datasets are in-memory uint8 NHWC arrays (data/datasets.py), so the
// whole per-batch host cost is one gather + affine normalize — fused here
// into a single pass (numpy pays two passes plus a full-size temporary for
// `images[idx].astype(f32)`), and optionally run on a worker std::thread so
// the NEXT batch is assembled while the calling thread waits on the device.
//
// Exact-parity contract: out = (float(v) / div) * mul + add, the same
// float32 op order as data/transforms.py scale_to_minus_one_one
// (div=255, mul=2, add=-1) and scale_to_zero_one (div=255, mul=1, add=0),
// so the native path is BITWISE equal to the numpy path
// (tests/test_torch_port_native.py).
//
// Python binding is ctypes (ldm_tpu_torch/native/__init__.py) — plain C
// ABI, no pybind11 dependency; built by ldm_tpu_torch/native/build.py
// (g++ -O3 -shared).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// Fused gather + affine normalize: one pass, no temporaries.
//   images: n_items x item_elems uint8 (C-contiguous)
//   out:    n_idx x item_elems float32
void ldm_gather_affine_u8(const uint8_t* images, int64_t item_elems,
                          const int64_t* idx, int64_t n_idx,
                          float div, float mul, float add, float* out) {
  for (int64_t i = 0; i < n_idx; ++i) {
    const uint8_t* src = images + idx[i] * item_elems;
    float* dst = out + i * item_elems;
    for (int64_t j = 0; j < item_elems; ++j) {
      dst[j] = (static_cast<float>(src[j]) / div) * mul + add;
    }
  }
}

void ldm_gather_i32(const int32_t* labels, const int64_t* idx, int64_t n_idx,
                    int32_t* out) {
  for (int64_t i = 0; i < n_idx; ++i) out[i] = labels[idx[i]];
}

// ---------------------------------------------------------------- prefetcher
//
// One worker thread fills a ring of `capacity` batch slots from a per-epoch
// order array; the consumer copies slots out in order.  Single-producer,
// single-consumer, guarded by one mutex + two condition variables — the
// simplest correct shape (batches are ~ms-sized; lock overhead is noise).

namespace {

struct Slot {
  std::vector<float> img;
  std::vector<int32_t> lbl;
  bool full = false;
};

struct Prefetcher {
  const uint8_t* images;
  const int32_t* labels;
  int64_t item_elems;
  int64_t batch;
  float div, mul, add;

  std::vector<Slot> slots;
  std::vector<int64_t> order;  // owned copy of the epoch's index order
  int64_t n_batches = 0;       // in the current epoch
  int64_t produced = 0;        // batches filled by the worker
  int64_t consumed = 0;        // batches taken by the consumer

  std::mutex mu;
  std::condition_variable cv_worker;    // signals: new epoch / slot freed / stop
  std::condition_variable cv_consumer;  // signals: slot filled
  std::condition_variable cv_idle;      // signals: gather window closed
  bool stop = false;
  bool busy = false;      // worker is in its unlocked gather window
  int64_t epoch = 0;      // bumped by start_epoch; stale gathers are dropped
  std::thread worker;

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv_worker.wait(lk, [&] {
        return stop ||
               (produced < n_batches && !slots[produced % slots.size()].full);
      });
      if (stop) return;
      Slot& s = slots[produced % slots.size()];
      const int64_t* idx = order.data() + produced * batch;
      const int64_t my_epoch = epoch;
      busy = true;
      lk.unlock();  // the gather runs outside the lock
      ldm_gather_affine_u8(images, item_elems, idx, batch, div, mul, add,
                           s.img.data());
      ldm_gather_i32(labels, idx, batch, s.lbl.data());
      lk.lock();
      busy = false;
      cv_idle.notify_all();
      if (epoch != my_epoch) continue;  // epoch restarted mid-gather: drop it
      s.full = true;
      ++produced;
      cv_consumer.notify_one();
    }
  }
};

}  // namespace

void* ldm_prefetcher_create(const uint8_t* images, const int32_t* labels,
                            int64_t item_elems, int64_t batch,
                            float div, float mul, float add, int capacity) {
  auto* p = new Prefetcher();
  p->images = images;
  p->labels = labels;
  p->item_elems = item_elems;
  p->batch = batch;
  p->div = div;
  p->mul = mul;
  p->add = add;
  p->slots.resize(capacity > 0 ? capacity : 2);
  for (auto& s : p->slots) {
    s.img.resize(static_cast<size_t>(batch) * item_elems);
    s.lbl.resize(batch);
  }
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// Begin an epoch over `n_order` indices (must be a multiple of the batch
// size; the Python side handles any tail batch itself).  The order array is
// copied, so the caller may free it immediately.  Safe to call with the
// previous epoch partially consumed (an abandoned iterator): the reset waits
// for the worker's gather window to close, so order.assign never races the
// in-flight reads, and the epoch bump drops a just-finished stale batch.
void ldm_prefetcher_start_epoch(void* h, const int64_t* order,
                                int64_t n_order) {
  auto* p = static_cast<Prefetcher*>(h);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_idle.wait(lk, [&] { return !p->busy; });
  ++p->epoch;
  p->order.assign(order, order + n_order);
  p->n_batches = n_order / p->batch;
  p->produced = 0;
  p->consumed = 0;
  for (auto& s : p->slots) s.full = false;
  p->cv_worker.notify_one();
}

// Copy the next batch into caller buffers.  Returns 1, or 0 at epoch end.
int ldm_prefetcher_next(void* h, float* out_img, int32_t* out_lbl) {
  auto* p = static_cast<Prefetcher*>(h);
  std::unique_lock<std::mutex> lk(p->mu);
  if (p->consumed >= p->n_batches) return 0;
  Slot& s = p->slots[p->consumed % p->slots.size()];
  p->cv_consumer.wait(lk, [&] { return s.full; });
  std::memcpy(out_img, s.img.data(), s.img.size() * sizeof(float));
  std::memcpy(out_lbl, s.lbl.data(), s.lbl.size() * sizeof(int32_t));
  s.full = false;
  ++p->consumed;
  p->cv_worker.notify_one();
  return 1;
}

void ldm_prefetcher_destroy(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
    p->cv_worker.notify_one();
  }
  p->worker.join();
  delete p;
}

}  // extern "C"

// ------------------------------------------------------------- serving slotq
//
// The serving host path (serving/service.py) spends, in pure Python, B
// queue.get calls to collect a batch, a B-iteration assembly loop and a
// B-iteration fulfil scatter, all under the GIL.  This moves the whole
// slot-granular path into C++: submit enqueues a request's
// slots in one call, collect blocks (GIL released) and writes the batch's
// (seed, idx, class) assembly arrays directly, scatter memcpys finished
// rows into each request's result buffer and reports which requests
// completed.  Python touches requests, never slots.
//
// Locking: one mutex guards the deque + registry; collect waits on a condvar
// with the batcher's deadline semantics (block for the first slot, then fill
// until max_delay or full).  Single consumer (the batcher thread), many
// producers (client threads), one scatter caller (the fulfil thread).

namespace {

struct SlotQ {
  struct Slot {
    int64_t req_id;
    int32_t idx;  // image index within the request
    int32_t seed;
    int32_t cls;
  };
  struct Req {
    uint8_t* dst;        // request's result buffer (n * item_bytes)
    int64_t remaining;   // slots not yet scattered
  };
  int64_t item_bytes;
  int64_t queue_limit;
  std::deque<Slot> q;
  std::unordered_map<int64_t, Req> reqs;
  std::mutex mu;
  std::condition_variable cv;
};

}  // namespace

extern "C" {

void* ldm_slotq_create(int64_t item_bytes, int64_t queue_limit) {
  auto* s = new SlotQ();
  s->item_bytes = item_bytes;
  s->queue_limit = queue_limit > 0 ? queue_limit : (int64_t{1} << 62);
  return s;
}

// Enqueue one request's n slots atomically.  Returns 1, or 0 (rejected:
// the whole request would overflow queue_limit — all-or-nothing, unlike the
// Python queue's partial-enqueue-then-reject).  `dst` must stay alive until
// the request completes or is cancelled.
int ldm_slotq_submit(void* h, int64_t req_id, uint8_t* dst, int32_t seed,
                     const int32_t* class_ids, int64_t n) {
  auto* s = static_cast<SlotQ*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    if (static_cast<int64_t>(s->q.size()) + n > s->queue_limit) return 0;
    s->reqs[req_id] = SlotQ::Req{dst, n};
    for (int64_t i = 0; i < n; ++i) {
      s->q.push_back(SlotQ::Slot{req_id, static_cast<int32_t>(i), seed,
                                 class_ids[i]});
    }
  }
  s->cv.notify_one();
  return 1;
}

// Collect up to `batch` slots: block up to first_wait_s for the first slot,
// then keep taking until the batch is full or max_delay_s after the first
// slot ran out.  Writes the compiled sampler's assembly arrays (seeds /
// idxs / classes; slots [count, batch) left as written by the caller = pad)
// plus the (req_id, slot_i) pairs scatter needs.  Returns count (0: timed
// out empty).
int64_t ldm_slotq_collect(void* h, int64_t batch, double first_wait_s,
                          double max_delay_s, int32_t* seeds, int32_t* idxs,
                          int32_t* classes, int64_t* req_ids,
                          int32_t* slot_is) {
  auto* s = static_cast<SlotQ*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  if (s->q.empty()) {
    s->cv.wait_for(lk, std::chrono::duration<double>(first_wait_s),
                   [&] { return !s->q.empty(); });
    if (s->q.empty()) return 0;
  }
  int64_t count = 0;
  auto take = [&] {
    const SlotQ::Slot& sl = s->q.front();
    seeds[count] = sl.seed;
    idxs[count] = sl.idx;
    classes[count] = sl.cls;
    req_ids[count] = sl.req_id;
    slot_is[count] = sl.idx;
    s->q.pop_front();
    ++count;
  };
  const auto deadline =
      std::chrono::steady_clock::now() +
      std::chrono::duration_cast<std::chrono::steady_clock::duration>(
          std::chrono::duration<double>(max_delay_s));
  while (count < batch) {
    while (count < batch && !s->q.empty()) take();
    if (count >= batch) break;
    if (!s->cv.wait_until(lk, deadline, [&] { return !s->q.empty(); })) break;
  }
  return count;
}

// Scatter a finished batch: images row j (uint8, item_bytes each) is copied
// into request req_ids[j]'s buffer at slot_is[j].  Completed requests'
// ids are written to done_req_ids; returns how many completed.  Unknown
// req_ids (cancelled mid-flight) are skipped.
int64_t ldm_slotq_scatter(void* h, const uint8_t* images, int64_t count,
                          const int64_t* req_ids, const int32_t* slot_is,
                          int64_t* done_req_ids) {
  auto* s = static_cast<SlotQ*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  int64_t n_done = 0;
  for (int64_t j = 0; j < count; ++j) {
    auto it = s->reqs.find(req_ids[j]);
    if (it == s->reqs.end()) continue;
    std::memcpy(it->second.dst + slot_is[j] * s->item_bytes,
                images + j * s->item_bytes, s->item_bytes);
    if (--it->second.remaining == 0) {
      done_req_ids[n_done++] = it->first;
      s->reqs.erase(it);
    }
  }
  return n_done;
}

// Drop a request (rejection/failure): forget its registry entry and purge
// its queued slots so scatter never writes into a freed buffer.
void ldm_slotq_cancel(void* h, int64_t req_id) {
  auto* s = static_cast<SlotQ*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  s->reqs.erase(req_id);
  for (auto it = s->q.begin(); it != s->q.end();) {
    it = (it->req_id == req_id) ? s->q.erase(it) : std::next(it);
  }
}

// Failure path: drain every pending request id (queued slots + in-flight
// registry entries) so the service can fail their futures.  Writes up to
// cap unique ids; clears the queue and registry.
int64_t ldm_slotq_drain(void* h, int64_t* out_req_ids, int64_t cap) {
  auto* s = static_cast<SlotQ*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  int64_t n = 0;
  for (const auto& kv : s->reqs) {
    if (n < cap) out_req_ids[n++] = kv.first;
  }
  s->q.clear();
  s->reqs.clear();
  return n;
}

int64_t ldm_slotq_depth(void* h) {
  auto* s = static_cast<SlotQ*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  return static_cast<int64_t>(s->q.size());
}

void ldm_slotq_destroy(void* h) { delete static_cast<SlotQ*>(h); }

}  // extern "C"
