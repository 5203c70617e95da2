// Native data-loader core: MPMC ring buffer + batch row-gather.
//
// Fills the slot of the reference's C++ data-loader machinery
// (paddle/fluid/imperative data loader + paddle/fluid/framework/data_feed.cc):
// worker threads hand fixed-size batch slots to the consumer through a
// condvar-coordinated ring living outside the GIL, and hot row-gather copies
// run in C++ (callers invoke through ctypes, which releases the GIL, so
// blocking waits and memcpy overlap with Python-side decode and JAX
// dispatch).
//
// C ABI so ctypes loads it with no build-time Python dependency.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct Ring {
  size_t slot_bytes;
  int n_slots;
  std::vector<char*> slots;
  std::vector<size_t> used;     // committed payload size per slot
  std::deque<int> free_q;       // writable slots
  std::deque<int> ready_q;      // readable slots (FIFO order)
  std::mutex mu;
  std::condition_variable cv_free;
  std::condition_variable cv_ready;
  bool closed = false;
};

}  // namespace

extern "C" {

void* rb_create(size_t slot_bytes, int n_slots) {
  Ring* rb = new Ring();
  rb->slot_bytes = slot_bytes;
  rb->n_slots = n_slots;
  rb->slots.resize(n_slots);
  rb->used.assign(n_slots, 0);
  for (int i = 0; i < n_slots; ++i) {
    rb->slots[i] = static_cast<char*>(::malloc(slot_bytes));
    if (!rb->slots[i]) {  // roll back on OOM
      for (int j = 0; j < i; ++j) ::free(rb->slots[j]);
      delete rb;
      return nullptr;
    }
    rb->free_q.push_back(i);
  }
  return rb;
}

// Returns a writable slot index, or -1 on timeout/closed.
int rb_acquire_write(void* h, int timeout_ms) {
  Ring* rb = static_cast<Ring*>(h);
  std::unique_lock<std::mutex> lk(rb->mu);
  auto pred = [rb] { return rb->closed || !rb->free_q.empty(); };
  if (timeout_ms < 0) {
    rb->cv_free.wait(lk, pred);
  } else if (!rb->cv_free.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                   pred)) {
    return -1;
  }
  if (rb->closed || rb->free_q.empty()) return -1;
  int slot = rb->free_q.front();
  rb->free_q.pop_front();
  return slot;
}

void rb_commit_write(void* h, int slot, size_t nbytes) {
  Ring* rb = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(rb->mu);
  rb->used[slot] = nbytes;
  rb->ready_q.push_back(slot);
  rb->cv_ready.notify_one();
}

// Returns a readable slot index (FIFO), or -1 on timeout/closed+drained.
int rb_acquire_read(void* h, int timeout_ms) {
  Ring* rb = static_cast<Ring*>(h);
  std::unique_lock<std::mutex> lk(rb->mu);
  auto pred = [rb] { return rb->closed || !rb->ready_q.empty(); };
  if (timeout_ms < 0) {
    rb->cv_ready.wait(lk, pred);
  } else if (!rb->cv_ready.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                    pred)) {
    return -1;
  }
  if (rb->ready_q.empty()) return -1;  // closed and drained
  int slot = rb->ready_q.front();
  rb->ready_q.pop_front();
  return slot;
}

void rb_release_read(void* h, int slot) {
  Ring* rb = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(rb->mu);
  rb->used[slot] = 0;
  rb->free_q.push_back(slot);
  rb->cv_free.notify_one();
}

char* rb_slot_ptr(void* h, int slot) {
  return static_cast<Ring*>(h)->slots[slot];
}

size_t rb_slot_bytes(void* h, int slot) {
  Ring* rb = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(rb->mu);
  return rb->used[slot];
}

size_t rb_slot_capacity(void* h) { return static_cast<Ring*>(h)->slot_bytes; }

int rb_ready_count(void* h) {
  Ring* rb = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(rb->mu);
  return static_cast<int>(rb->ready_q.size());
}

void rb_close(void* h) {
  Ring* rb = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(rb->mu);
  rb->closed = true;
  rb->cv_free.notify_all();
  rb->cv_ready.notify_all();
}

void rb_destroy(void* h) {
  Ring* rb = static_cast<Ring*>(h);
  for (char* s : rb->slots) ::free(s);
  delete rb;
}

// Gather rows src[idx[i]] (each row_bytes wide) into contiguous dst.
// The hot copy loop of batch assembly, outside the GIL.
void rb_gather_rows(char* dst, const char* src, const int64_t* idx, int n,
                    size_t row_bytes) {
  for (int i = 0; i < n; ++i) {
    std::memcpy(dst + static_cast<size_t>(i) * row_bytes,
                src + static_cast<size_t>(idx[i]) * row_bytes, row_bytes);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Process-SHARED slot ring (shmrb_*): the fork-worker transport.
//
// The reference's multiprocess DataLoader moves batches through POSIX shared
// memory (python/paddle/io/dataloader/worker.py + core._array_to_share_memory
// fast path).  Equivalent here: the ring lives entirely inside ONE caller-
// provided MAP_SHARED|MAP_ANONYMOUS region created BEFORE fork, so parent and
// workers address the same physical pages.  No pthread mutexes (robustness
// across processes is messy); coordination is two lock-free Vyukov bounded
// MPMC index queues (free slots / ready slots) built on std::atomic, which is
// address-free on x86-64/aarch64 and therefore valid across processes, plus a
// bounded spin-then-usleep wait (data-loader waits are ms-scale; the callers
// enter via ctypes, so the GIL is released while waiting).
// ---------------------------------------------------------------------------

#include <time.h>

namespace {

struct ShmCell {
  std::atomic<uint64_t> seq;
  uint32_t val;
  uint32_t pad_;
};

struct ShmHeader {
  uint64_t magic;
  uint64_t slot_bytes;
  uint32_t n_slots;
  uint32_t cap;  // queue capacity: power of two >= n_slots
  std::atomic<uint32_t> closed;
  uint32_t pad_;
  std::atomic<uint64_t> free_head, free_tail;
  std::atomic<uint64_t> ready_head, ready_tail;
};

constexpr uint64_t kShmMagic = 0x70645f73686d7262ULL;  // "pd_shmrb"
constexpr size_t kHeaderBytes = 256;

inline uint32_t pow2_at_least(uint32_t n) {
  uint32_t c = 1;
  while (c < n) c <<= 1;
  return c;
}

inline ShmHeader* hdr(char* base) { return reinterpret_cast<ShmHeader*>(base); }
inline ShmCell* free_cells(char* base) {
  return reinterpret_cast<ShmCell*>(base + kHeaderBytes);
}
inline ShmCell* ready_cells(char* base) {
  return free_cells(base) + hdr(base)->cap;
}
inline std::atomic<uint64_t>* used_arr(char* base) {
  return reinterpret_cast<std::atomic<uint64_t>*>(
      reinterpret_cast<char*>(ready_cells(base) + hdr(base)->cap));
}
inline char* slot_base(char* base) {
  char* p = reinterpret_cast<char*>(used_arr(base) + hdr(base)->n_slots);
  auto a = reinterpret_cast<uintptr_t>(p);
  return reinterpret_cast<char*>((a + 63) & ~uintptr_t(63));
}

// Vyukov bounded MPMC enqueue/dequeue over a cell array.
bool q_enqueue(ShmCell* cells, uint32_t cap, std::atomic<uint64_t>* tail,
               uint32_t val) {
  uint64_t pos = tail->load(std::memory_order_relaxed);
  for (;;) {
    ShmCell* c = &cells[pos & (cap - 1)];
    uint64_t seq = c->seq.load(std::memory_order_acquire);
    intptr_t dif = static_cast<intptr_t>(seq) - static_cast<intptr_t>(pos);
    if (dif == 0) {
      if (tail->compare_exchange_weak(pos, pos + 1,
                                      std::memory_order_relaxed)) {
        c->val = val;
        c->seq.store(pos + 1, std::memory_order_release);
        return true;
      }
    } else if (dif < 0) {
      return false;  // full (cannot happen: cap >= n_slots)
    } else {
      pos = tail->load(std::memory_order_relaxed);
    }
  }
}

bool q_dequeue(ShmCell* cells, uint32_t cap, std::atomic<uint64_t>* head,
               uint32_t* out) {
  uint64_t pos = head->load(std::memory_order_relaxed);
  for (;;) {
    ShmCell* c = &cells[pos & (cap - 1)];
    uint64_t seq = c->seq.load(std::memory_order_acquire);
    intptr_t dif =
        static_cast<intptr_t>(seq) - static_cast<intptr_t>(pos + 1);
    if (dif == 0) {
      if (head->compare_exchange_weak(pos, pos + 1,
                                      std::memory_order_relaxed)) {
        *out = c->val;
        c->seq.store(pos + cap, std::memory_order_release);
        return true;
      }
    } else if (dif < 0) {
      return false;  // empty
    } else {
      pos = head->load(std::memory_order_relaxed);
    }
  }
}

// Spin-then-sleep dequeue with timeout; returns -1 on timeout/closed-empty.
int q_wait_dequeue(char* base, ShmCell* cells, std::atomic<uint64_t>* head,
                   int timeout_ms) {
  ShmHeader* h = hdr(base);
  uint32_t val;
  int spins = 0;
  int64_t waited_us = 0;
  for (;;) {
    if (q_dequeue(cells, h->cap, head, &val)) return static_cast<int>(val);
    if (h->closed.load(std::memory_order_acquire)) {
      // drain: one more try in case a commit raced the close
      if (q_dequeue(cells, h->cap, head, &val)) return static_cast<int>(val);
      return -1;
    }
    if (timeout_ms >= 0 && waited_us >= int64_t(timeout_ms) * 1000) return -1;
    if (++spins < 64) continue;  // brief spin for the hot handoff
    struct timespec ts = {0, 200 * 1000};  // 200us
    nanosleep(&ts, nullptr);
    waited_us += 200;
  }
}

}  // namespace

extern "C" {

size_t shmrb_required_bytes(size_t slot_bytes, uint32_t n_slots) {
  uint32_t cap = pow2_at_least(n_slots < 2 ? 2 : n_slots);
  return kHeaderBytes + size_t(cap) * 2 * sizeof(ShmCell) +
         size_t(n_slots) * sizeof(uint64_t) + 64 +
         size_t(n_slots) * slot_bytes;
}

int shmrb_init(char* base, size_t slot_bytes, uint32_t n_slots) {
  ShmHeader* h = hdr(base);
  h->magic = kShmMagic;
  h->slot_bytes = slot_bytes;
  h->n_slots = n_slots;
  h->cap = pow2_at_least(n_slots < 2 ? 2 : n_slots);
  h->closed.store(0, std::memory_order_relaxed);
  h->free_head.store(0, std::memory_order_relaxed);
  h->free_tail.store(0, std::memory_order_relaxed);
  h->ready_head.store(0, std::memory_order_relaxed);
  h->ready_tail.store(0, std::memory_order_relaxed);
  ShmCell* fc = free_cells(base);
  ShmCell* rc = ready_cells(base);
  for (uint32_t i = 0; i < h->cap; ++i) {
    fc[i].seq.store(i, std::memory_order_relaxed);
    rc[i].seq.store(i, std::memory_order_relaxed);
  }
  for (uint32_t i = 0; i < n_slots; ++i) {
    used_arr(base)[i].store(0, std::memory_order_relaxed);
    if (!q_enqueue(fc, h->cap, &h->free_tail, i)) return -1;
  }
  std::atomic_thread_fence(std::memory_order_seq_cst);
  return 0;
}

int shmrb_acquire_write(char* base, int timeout_ms) {
  return q_wait_dequeue(base, free_cells(base), &hdr(base)->free_head,
                        timeout_ms);
}

void shmrb_commit_write(char* base, int slot, size_t nbytes) {
  ShmHeader* h = hdr(base);
  used_arr(base)[slot].store(nbytes, std::memory_order_release);
  q_enqueue(ready_cells(base), h->cap, &h->ready_tail,
            static_cast<uint32_t>(slot));
}

int shmrb_acquire_read(char* base, int timeout_ms) {
  return q_wait_dequeue(base, ready_cells(base), &hdr(base)->ready_head,
                        timeout_ms);
}

void shmrb_release_read(char* base, int slot) {
  ShmHeader* h = hdr(base);
  used_arr(base)[slot].store(0, std::memory_order_release);
  q_enqueue(free_cells(base), h->cap, &h->free_tail,
            static_cast<uint32_t>(slot));
}

size_t shmrb_slot_used(char* base, int slot) {
  return used_arr(base)[slot].load(std::memory_order_acquire);
}

size_t shmrb_slot_capacity(char* base) { return hdr(base)->slot_bytes; }

char* shmrb_slot_ptr(char* base, int slot) {
  return slot_base(base) + size_t(slot) * hdr(base)->slot_bytes;
}

void shmrb_close(char* base) {
  hdr(base)->closed.store(1, std::memory_order_release);
}

int shmrb_is_closed(char* base) {
  return static_cast<int>(hdr(base)->closed.load(std::memory_order_acquire));
}

}  // extern "C"
