// Native shard reader: mmap'd fixed-record array shards with a
// threaded prefetch ring.
//
// The port's copy of news_image_caption_tpu/native/shard_reader.cc,
// built by news_image_caption_tpu_torch/data/native_loader.py with g++
// (not nvcc: it runs on the host).
//
// Capability parity target: the reference hides I/O latency with
// joblib worker *processes* per batch (dataloader.py:279-296)
// and torch DataLoader workers. Here record shards are mmap'd, a pool
// of C++ threads copies shuffled record batches into a ring of staging
// buffers ahead of the consumer, and Python hands the filled buffer
// straight to the device copy. No GIL, no pickling, no per-batch
// process spawns.
//
// File format ("NICS", version 1): 24-byte header
//   [magic u64 = 0x31453434950][n_records u64][record_bytes u64]
// followed by n_records * record_bytes raw bytes. The magic is an
// arbitrary tag shared with the Python writer
// (data/native_loader.py MAGIC) — NOT ASCII bytes.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Arbitrary tag; must equal data/native_loader.py's MAGIC.
constexpr uint64_t kMagic = 0x31453434950ull;

struct Shard {
  const uint8_t* data = nullptr;   // mmap base
  size_t size = 0;
  uint64_t n_records = 0;
  uint64_t record_bytes = 0;
  int fd = -1;
};

struct Slot {
  std::vector<uint8_t> buf;
  long n_filled = 0;
  uint64_t batch_idx = 0;
  bool ready = false;
};

struct Reader {
  std::vector<Shard> shards;
  uint64_t record_bytes = 0;
  uint64_t total_records = 0;

  // prefetch state
  long batch_size = 0;
  bool drop_last = true;
  // SoA mode: workers deinterleave each record's fields into
  // per-field contiguous regions of the slot buffer (field f of
  // record i lands at soa_offsets[f] + i * field_sizes[f]). The
  // consumer can then view each field as a contiguous array with no
  // further copies — the strided AoS->SoA transpose that otherwise
  // costs a second full pass over the batch in Python.
  std::vector<long> field_sizes;
  std::vector<size_t> soa_offsets;
  bool soa = false;
  std::vector<std::pair<uint32_t, uint64_t>> order;  // (shard, record)
  size_t next_claim = 0;     // guarded by mu
  size_t next_deliver = 0;   // guarded by mu
  size_t n_batches = 0;

  std::vector<Slot> slots;
  std::deque<size_t> free_slots;
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::vector<std::thread> threads;
  std::atomic<bool> stop{false};
  std::atomic<int> live_workers{0};

  const uint8_t* record_ptr(uint32_t s, uint64_t r) const {
    return shards[s].data + 24 + r * record_bytes;
  }
};

// Workers claim a batch index ONLY together with a staging slot
// (under the same mutex). Two invariants follow: at most n_slots
// batches are in flight, and every claimed index has a slot and will
// complete — so the consumer can demand batches in INDEX order
// (deterministic delivery regardless of thread scheduling; the
// original completion-order delivery made the batch stream depend on
// worker races, which broke resume determinism) without deadlock.
void worker_loop(Reader* rd) {
  while (true) {
    size_t bi, slot_idx;
    {
      std::unique_lock<std::mutex> lk(rd->mu);
      rd->cv_free.wait(lk, [&] {
        return rd->stop.load() || rd->next_claim >= rd->n_batches ||
               !rd->free_slots.empty();
      });
      if (rd->stop.load() || rd->next_claim >= rd->n_batches) break;
      bi = rd->next_claim++;
      slot_idx = rd->free_slots.front();
      rd->free_slots.pop_front();
    }
    Slot& slot = rd->slots[slot_idx];
    size_t start = bi * rd->batch_size;
    size_t end = start + rd->batch_size;
    if (end > rd->order.size()) end = rd->order.size();
    long n = static_cast<long>(end - start);
    if (rd->soa) {
      for (size_t i = start; i < end; ++i) {
        auto [s, r] = rd->order[i];
        const uint8_t* rec = rd->record_ptr(s, r);
        size_t rec_off = 0;
        for (size_t f = 0; f < rd->field_sizes.size(); ++f) {
          std::memcpy(slot.buf.data() + rd->soa_offsets[f] +
                          (i - start) * rd->field_sizes[f],
                      rec + rec_off, rd->field_sizes[f]);
          rec_off += rd->field_sizes[f];
        }
      }
    } else {
      for (size_t i = start; i < end; ++i) {
        auto [s, r] = rd->order[i];
        std::memcpy(slot.buf.data() + (i - start) * rd->record_bytes,
                    rd->record_ptr(s, r), rd->record_bytes);
      }
    }
    slot.n_filled = n;
    {
      std::lock_guard<std::mutex> lk(rd->mu);
      slot.batch_idx = bi;
      slot.ready = true;
    }
    rd->cv_ready.notify_all();
  }
  {
    // Decrement + notify under mu: both feed cv_ready wait
    // predicates, and a bare fetch_sub/notify can slip between a
    // waiter's predicate check and its block (lost wakeup — the
    // consumer would sleep forever at EOF).
    std::lock_guard<std::mutex> lk(rd->mu);
    rd->live_workers.fetch_sub(1);
  }
  rd->cv_ready.notify_all();
}

}  // namespace

extern "C" {

static void release_shards(Reader* rd) {
  for (auto& sh : rd->shards) {
    if (sh.data) munmap(const_cast<uint8_t*>(sh.data), sh.size);
    if (sh.fd >= 0) ::close(sh.fd);
  }
  rd->shards.clear();
}

void* shard_open(const char** paths, int n_paths) {
  auto* rd = new Reader();
  // On any failure, every shard opened so far (including the one in
  // flight) must release its mmap and fd before the Reader dies.
  auto fail = [&](Shard& sh) -> void* {
    rd->shards.push_back(sh);  // include the partial shard in cleanup
    release_shards(rd);
    delete rd;
    return nullptr;
  };
  for (int i = 0; i < n_paths; ++i) {
    Shard sh;
    sh.fd = ::open(paths[i], O_RDONLY);
    if (sh.fd < 0) return fail(sh);
    struct stat st;
    if (fstat(sh.fd, &st) != 0 ||
        st.st_size < 24) return fail(sh);
    sh.size = static_cast<size_t>(st.st_size);
    void* p = mmap(nullptr, sh.size, PROT_READ, MAP_PRIVATE, sh.fd, 0);
    if (p == MAP_FAILED) return fail(sh);
    sh.data = static_cast<const uint8_t*>(p);
    uint64_t magic, n, rb;
    std::memcpy(&magic, sh.data, 8);
    std::memcpy(&n, sh.data + 8, 8);
    std::memcpy(&rb, sh.data + 16, 8);
    if (magic != kMagic) return fail(sh);
    if (rd->record_bytes == 0) rd->record_bytes = rb;
    // Overflow-safe size check: n * rb can wrap uint64 for a corrupt
    // header (e.g. n = 2^61, rb = 8), which would accept the file and
    // read far past the mapping.
    if (rb != rd->record_bytes || rb == 0 || sh.size < 24 ||
        n > (sh.size - 24) / rb) return fail(sh);
    sh.n_records = n;
    sh.record_bytes = rb;
    rd->total_records += n;
    rd->shards.push_back(sh);
  }
  return rd;
}

long shard_num_records(void* h) {
  return static_cast<long>(static_cast<Reader*>(h)->total_records);
}

long shard_record_bytes(void* h) {
  return static_cast<long>(static_cast<Reader*>(h)->record_bytes);
}

void shard_stop(void* h);

// field_sizes/n_fields: per-record field byte sizes for SoA delivery
// (must sum to record_bytes); n_fields == 0 selects the original
// interleaved (AoS) delivery.
int shard_start_soa(void* h, long batch_size, int n_threads,
                    int n_slots, int shuffle, long seed, int drop_last,
                    const long* field_sizes, int n_fields) {
  auto* rd = static_cast<Reader*>(h);
  // Restarting over a still-running epoch (e.g. an abandoned Python
  // generator) must first quiesce the old workers — they hold
  // references to slots/order that are about to be reset.
  shard_stop(h);
  rd->soa = n_fields > 0;
  rd->field_sizes.clear();
  if (rd->soa)
    rd->field_sizes.assign(field_sizes, field_sizes + n_fields);
  rd->soa_offsets.clear();
  if (rd->soa) {
    uint64_t total = 0;
    size_t off = 0;
    for (int f = 0; f < n_fields; ++f) {
      rd->soa_offsets.push_back(off);
      off += static_cast<size_t>(field_sizes[f]) * batch_size;
      total += static_cast<uint64_t>(field_sizes[f]);
    }
    if (total != rd->record_bytes) return -1;
  }
  rd->batch_size = batch_size;
  rd->drop_last = drop_last != 0;
  rd->order.clear();
  for (uint32_t s = 0; s < rd->shards.size(); ++s)
    for (uint64_t r = 0; r < rd->shards[s].n_records; ++r)
      rd->order.emplace_back(s, r);
  if (shuffle) {
    std::mt19937_64 rng(static_cast<uint64_t>(seed));
    std::shuffle(rd->order.begin(), rd->order.end(), rng);
  }
  size_t n = rd->order.size();
  rd->n_batches = rd->drop_last ? n / batch_size
                                : (n + batch_size - 1) / batch_size;
  rd->next_claim = 0;
  rd->next_deliver = 0;
  rd->stop.store(false);
  rd->slots.assign(static_cast<size_t>(n_slots), Slot{});
  rd->free_slots.clear();
  for (int i = 0; i < n_slots; ++i) {
    rd->slots[i].buf.resize(batch_size * rd->record_bytes);
    rd->free_slots.push_back(i);
  }
  rd->live_workers.store(n_threads);
  for (int i = 0; i < n_threads; ++i)
    rd->threads.emplace_back(worker_loop, rd);
  return static_cast<int>(rd->n_batches);
}

int shard_start(void* h, long batch_size, int n_threads, int n_slots,
                int shuffle, long seed, int drop_last) {
  return shard_start_soa(h, batch_size, n_threads, n_slots, shuffle,
                         seed, drop_last, nullptr, 0);
}

// Returns number of records copied into `out` (0 = end of epoch).
// Batches are delivered in batch-index order (deterministic).
long shard_next(void* h, uint8_t* out, long out_bytes) {
  auto* rd = static_cast<Reader*>(h);
  size_t slot_idx;
  {
    std::unique_lock<std::mutex> lk(rd->mu);
    auto find_expected = [&]() -> long {
      for (size_t i = 0; i < rd->slots.size(); ++i)
        if (rd->slots[i].ready &&
            rd->slots[i].batch_idx == rd->next_deliver)
          return static_cast<long>(i);
      return -1;
    };
    long idx = -1;
    rd->cv_ready.wait(lk, [&] {
      idx = find_expected();
      return idx >= 0 || rd->live_workers.load() == 0;
    });
    if (idx < 0) {
      idx = find_expected();   // workers done; last batches may wait
      if (idx < 0) return 0;   // epoch exhausted
    }
    slot_idx = static_cast<size_t>(idx);
    rd->next_deliver++;
  }
  Slot& slot = rd->slots[slot_idx];
  long n = slot.n_filled;
  if (rd->soa) {
    // Field regions sit at batch_size-strided offsets, so a partial
    // batch still needs per-field copies at the full-stride offsets.
    for (size_t f = 0; f < rd->field_sizes.size(); ++f) {
      long bytes = n * rd->field_sizes[f];
      long off = static_cast<long>(rd->soa_offsets[f]);
      if (off + bytes > out_bytes) {
        bytes = out_bytes - off;
        if (bytes <= 0) break;
      }
      std::memcpy(out + off, slot.buf.data() + off, bytes);
    }
  } else {
    long bytes = n * static_cast<long>(rd->record_bytes);
    if (bytes > out_bytes) bytes = out_bytes;
    std::memcpy(out, slot.buf.data(), bytes);
  }
  {
    std::lock_guard<std::mutex> lk(rd->mu);
    slot.ready = false;
    rd->free_slots.push_back(slot_idx);
  }
  rd->cv_free.notify_one();
  return n;
}

void shard_stop(void* h) {
  if (h == nullptr) return;
  auto* rd = static_cast<Reader*>(h);
  {
    // Set stop under mu (it feeds both cv wait predicates) so the
    // notify cannot race a waiter between predicate and block.
    std::lock_guard<std::mutex> lk(rd->mu);
    rd->stop.store(true);
  }
  rd->cv_free.notify_all();
  rd->cv_ready.notify_all();
  for (auto& t : rd->threads)
    if (t.joinable()) t.join();
  rd->threads.clear();
}

void shard_close(void* h) {
  if (h == nullptr) return;
  auto* rd = static_cast<Reader*>(h);
  shard_stop(h);
  release_shards(rd);
  delete rd;
}

}  // extern "C"
