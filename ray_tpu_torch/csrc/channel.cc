// Mutable shared-memory channels for compiled graphs — the native
// counterpart of the reference's mutable plasma objects + semaphores
// (src/ray/core_worker/experimental_mutable_object_manager.{h,cc},
// python/ray/experimental/channel/shared_memory_channel.py): values in
// shm, one writer, N readers, blocking handoff via a process-shared
// mutex + condvar. Steady-state hop latency is a condvar wake, not an RPC.
//
// The slot store is an N-SLOT RING (num_slots >= 1): the writer appends
// value seq W into slot (W-1) % num_slots and blocks only when the slot
// it is about to overwrite still has unacked readers — i.e. when the ring
// is full across ALL reader cursors. Readers consume strictly in sequence
// (each reader sees every value exactly once); per-reader cursors live
// with the reader (local handles keep last_seq; remote readers carry it
// through the dag_chan_read RPC). num_slots = 1 degenerates to the
// original single-slot handoff. The ring is what lets CompiledDAG keep
// max_inflight iterations pipelined instead of serializing every stage
// on the slowest consumer.
//
// The PyTorch port's own copy of ray_tpu/_native/channel.cc (same C
// interface), built with g++ beside csrc/arena_store.cc into one library
// by ray_tpu_torch/core/native_store.py.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// v2: telemetry counters appended to the header shift the slot array, so
// a v1 segment must fail attach (not be misread) — hence a new magic.
constexpr uint64_t kChanMagic = 0x52545055'4348414full;  // "RTPUCHAO"

struct ChanHeader {
  uint64_t magic;
  uint64_t capacity;      // per-slot payload capacity
  uint64_t total_size;
  pthread_mutex_t mutex;
  pthread_cond_t cond;
  uint64_t seq;           // seq of the NEWEST value written (0 = none yet)
  uint32_t num_readers;
  uint32_t closed;
  uint32_t num_slots;
  uint32_t _pad;
  // -- telemetry (mutated under the mutex; snapshot reads are lock-free) --
  uint64_t writer_stall_ns;  // writers blocked: ring full across cursors
  uint64_t reader_stall_ns;  // readers blocked: next value not written yet
  uint64_t writes;           // completed writes
  uint64_t reads;            // completed reads (summed over all readers)
};

// per-slot metadata, laid out as an array right after the header
struct SlotMeta {
  uint64_t seq;           // value id held by this slot (0 = never written)
  uint64_t len;           // payload length of that value
  uint64_t acks;          // readers that consumed that value
};

struct ChanHandle {
  void* base;
  uint64_t total;
  int fd;
  char name[128];
};

inline ChanHeader* chdr(ChanHandle* h) {
  return reinterpret_cast<ChanHeader*>(h->base);
}
inline SlotMeta* slots(ChanHandle* h) {
  return reinterpret_cast<SlotMeta*>(
      reinterpret_cast<uint8_t*>(h->base) + sizeof(ChanHeader));
}
inline uint8_t* payload(ChanHandle* h, uint32_t slot) {
  ChanHeader* H = chdr(h);
  return reinterpret_cast<uint8_t*>(h->base) + sizeof(ChanHeader) +
         sizeof(SlotMeta) * H->num_slots + (uint64_t)slot * H->capacity;
}
inline uint32_t slot_of(ChanHeader* H, uint64_t seq) {
  return (uint32_t)((seq - 1) % H->num_slots);
}

int chan_lock(ChanHandle* h) {
  int rc = pthread_mutex_lock(&chdr(h)->mutex);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&chdr(h)->mutex);
    return 0;
  }
  return rc;
}

// wait on the condvar with optional timeout (ms; <0 = forever).
// returns 0 or ETIMEDOUT.
int chan_wait(ChanHandle* h, int64_t timeout_ms) {
  if (timeout_ms < 0) {
    return pthread_cond_wait(&chdr(h)->cond, &chdr(h)->mutex);
  }
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  ts.tv_sec += timeout_ms / 1000;
  ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts.tv_nsec >= 1000000000L) {
    ts.tv_sec += 1;
    ts.tv_nsec -= 1000000000L;
  }
  return pthread_cond_timedwait(&chdr(h)->cond, &chdr(h)->mutex, &ts);
}

inline uint64_t mono_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

}  // namespace

extern "C" {

void* rtpu_chan_create(const char* name, uint64_t capacity,
                       uint32_t num_readers, uint32_t num_slots) {
  if (num_slots == 0) num_slots = 1;
  uint64_t total = sizeof(ChanHeader) + sizeof(SlotMeta) * num_slots +
                   capacity * num_slots;
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0666);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  ChanHandle* h = new ChanHandle{base, total, fd, {0}};
  strncpy(h->name, name, sizeof(h->name) - 1);
  ChanHeader* H = chdr(h);
  memset(H, 0, sizeof(ChanHeader) + sizeof(SlotMeta) * num_slots);
  H->capacity = capacity;
  H->total_size = total;
  H->num_readers = num_readers ? num_readers : 1;
  H->num_slots = num_slots;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&H->mutex, &ma);
  pthread_mutexattr_destroy(&ma);

  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&H->cond, &ca);
  pthread_condattr_destroy(&ca);

  __sync_synchronize();
  H->magic = kChanMagic;
  return h;
}

void* rtpu_chan_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0666);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                    MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  ChanHandle* h = new ChanHandle{base, (uint64_t)st.st_size, fd, {0}};
  strncpy(h->name, name, sizeof(h->name) - 1);
  if (chdr(h)->magic != kChanMagic) {
    munmap(base, (size_t)st.st_size);
    close(fd);
    delete h;
    return nullptr;
  }
  return h;
}

// Mark the channel closed and wake every blocked reader/writer WITHOUT
// unmapping — safe to call while other threads of this process are
// blocked inside read/write on the same handle (close() would unmap the
// segment under them). Used to fence a channel whose peer process died:
// the creator can no longer set the flag, so any attached handle does.
void rtpu_chan_shutdown(void* hp) {
  ChanHandle* h = reinterpret_cast<ChanHandle*>(hp);
  if (!h) return;
  if (chan_lock(h) == 0) {
    chdr(h)->closed = 1;
    pthread_cond_broadcast(&chdr(h)->cond);
    pthread_mutex_unlock(&chdr(h)->mutex);
  }
}

void rtpu_chan_close(void* hp, int unlink_segment) {
  ChanHandle* h = reinterpret_cast<ChanHandle*>(hp);
  if (!h) return;
  if (chan_lock(h) == 0) {
    chdr(h)->closed = 1;
    pthread_cond_broadcast(&chdr(h)->cond);
    pthread_mutex_unlock(&chdr(h)->mutex);
  }
  munmap(h->base, h->total);
  close(h->fd);
  if (unlink_segment) shm_unlink(h->name);
  delete h;
}

// Appends value seq+1 into its ring slot. Blocks while that slot still
// holds a value not yet acked by every reader (ring full across reader
// cursors). 0 ok; -2 closed; -3 timeout; -4 payload too large.
int rtpu_chan_write(void* hp, const uint8_t* data, uint64_t len,
                    int64_t timeout_ms) {
  ChanHandle* h = reinterpret_cast<ChanHandle*>(hp);
  ChanHeader* H = chdr(h);
  if (len > H->capacity) return -4;
  if (chan_lock(h) != 0) return -1;
  SlotMeta* S = slots(h);
  uint32_t slot;
  uint64_t stall0 = 0;   // set on first block: attributes ring-full stalls
  for (;;) {
    if (H->closed) {
      pthread_mutex_unlock(&H->mutex);
      return -2;
    }
    slot = slot_of(H, H->seq + 1);
    if (S[slot].seq == 0 || S[slot].acks >= H->num_readers) break;
    if (stall0 == 0) stall0 = mono_ns();
    if (chan_wait(h, timeout_ms) == ETIMEDOUT) {
      H->writer_stall_ns += mono_ns() - stall0;
      pthread_mutex_unlock(&H->mutex);
      return -3;
    }
  }
  if (stall0 != 0) H->writer_stall_ns += mono_ns() - stall0;
  memcpy(payload(h, slot), data, len);
  S[slot].len = len;
  S[slot].acks = 0;
  S[slot].seq = ++H->seq;
  H->writes++;
  pthread_cond_broadcast(&H->cond);
  pthread_mutex_unlock(&H->mutex);
  return 0;
}

// Reads the next value after last_seq (strictly in sequence; a reader
// that attached after values were already overwritten fast-forwards to
// the oldest value still in the ring). Blocks until it is written.
// 0 ok; -2 closed (and nothing newer); -3 timeout; -4 out buffer too
// small. On success *seq_out/*len_out describe the value. After close,
// values still in the ring DRAIN before -2 is reported — in-flight ring
// entries are never silently dropped.
int rtpu_chan_read(void* hp, uint64_t last_seq, uint8_t* out,
                   uint64_t out_cap, uint64_t* seq_out, uint64_t* len_out,
                   int64_t timeout_ms) {
  ChanHandle* h = reinterpret_cast<ChanHandle*>(hp);
  ChanHeader* H = chdr(h);
  if (chan_lock(h) != 0) return -1;
  SlotMeta* S = slots(h);
  uint64_t wanted;
  uint64_t stall0 = 0;   // set on first block: attributes starved-reader time
  for (;;) {
    // oldest value still resident: seq - num_slots + 1 (ring wrapped)
    wanted = last_seq + 1;
    if (H->seq >= H->num_slots && wanted < H->seq - H->num_slots + 1)
      wanted = H->seq - H->num_slots + 1;
    if (wanted <= H->seq) break;   // written and still in the ring
    if (H->closed) {               // closed with nothing newer
      if (stall0 != 0) H->reader_stall_ns += mono_ns() - stall0;
      pthread_mutex_unlock(&H->mutex);
      return -2;
    }
    if (stall0 == 0) stall0 = mono_ns();
    if (chan_wait(h, timeout_ms) == ETIMEDOUT) {
      H->reader_stall_ns += mono_ns() - stall0;
      pthread_mutex_unlock(&H->mutex);
      return -3;
    }
  }
  if (stall0 != 0) H->reader_stall_ns += mono_ns() - stall0;
  uint32_t slot = slot_of(H, wanted);
  if (S[slot].len > out_cap) {
    pthread_mutex_unlock(&H->mutex);
    return -4;
  }
  memcpy(out, payload(h, slot), S[slot].len);
  *seq_out = wanted;
  *len_out = S[slot].len;
  S[slot].acks++;
  H->reads++;
  if (S[slot].acks >= H->num_readers) pthread_cond_broadcast(&H->cond);
  pthread_mutex_unlock(&H->mutex);
  return 0;
}

// ---------------------------------------------------------------- zero-copy
// Split write: reserve hands the writer a pointer INTO the next ring slot
// so it can serialize in place (no staging buffer + memcpy pair); commit
// publishes it. Safe under the single-writer contract: between reserve and
// commit the slot is invisible to readers — it is only reservable once
// every reader acked its previous value (acks >= num_readers), so every
// reader cursor is already past it, and seq is not bumped until commit.
// Abandoning a reservation (serialize failed) needs no cleanup: the next
// reserve returns the same slot.
int rtpu_chan_reserve(void* hp, uint64_t len, int64_t timeout_ms,
                      uint8_t** ptr_out) {
  ChanHandle* h = reinterpret_cast<ChanHandle*>(hp);
  ChanHeader* H = chdr(h);
  if (len > H->capacity) return -4;
  if (chan_lock(h) != 0) return -1;
  SlotMeta* S = slots(h);
  uint32_t slot;
  uint64_t stall0 = 0;
  for (;;) {
    if (H->closed) {
      pthread_mutex_unlock(&H->mutex);
      return -2;
    }
    slot = slot_of(H, H->seq + 1);
    if (S[slot].seq == 0 || S[slot].acks >= H->num_readers) break;
    if (stall0 == 0) stall0 = mono_ns();
    if (chan_wait(h, timeout_ms) == ETIMEDOUT) {
      H->writer_stall_ns += mono_ns() - stall0;
      pthread_mutex_unlock(&H->mutex);
      return -3;
    }
  }
  if (stall0 != 0) H->writer_stall_ns += mono_ns() - stall0;
  *ptr_out = payload(h, slot);
  pthread_mutex_unlock(&H->mutex);
  return 0;
}

int rtpu_chan_commit(void* hp, uint64_t len) {
  ChanHandle* h = reinterpret_cast<ChanHandle*>(hp);
  ChanHeader* H = chdr(h);
  if (len > H->capacity) return -4;
  if (chan_lock(h) != 0) return -1;
  if (H->closed) {
    pthread_mutex_unlock(&H->mutex);
    return -2;
  }
  // single writer: the reserved slot is still slot_of(seq + 1)
  SlotMeta* S = slots(h);
  uint32_t slot = slot_of(H, H->seq + 1);
  S[slot].len = len;
  S[slot].acks = 0;
  S[slot].seq = ++H->seq;
  H->writes++;
  pthread_cond_broadcast(&H->cond);
  pthread_mutex_unlock(&H->mutex);
  return 0;
}

// Split read: same wait/fast-forward/drain-after-close discipline as
// rtpu_chan_read, but hands back a pointer into the slot WITHOUT copying
// and WITHOUT acking — the slot stays pinned (the writer cannot reclaim
// it) until rtpu_chan_ack(seq). The caller must ack exactly once per
// viewed value or the ring wedges when it wraps around to that slot.
int rtpu_chan_read_view(void* hp, uint64_t last_seq, uint64_t* seq_out,
                        uint64_t* len_out, uint8_t** ptr_out,
                        int64_t timeout_ms) {
  ChanHandle* h = reinterpret_cast<ChanHandle*>(hp);
  ChanHeader* H = chdr(h);
  if (chan_lock(h) != 0) return -1;
  SlotMeta* S = slots(h);
  uint64_t wanted;
  uint64_t stall0 = 0;
  for (;;) {
    wanted = last_seq + 1;
    if (H->seq >= H->num_slots && wanted < H->seq - H->num_slots + 1)
      wanted = H->seq - H->num_slots + 1;
    if (wanted <= H->seq) break;
    if (H->closed) {
      if (stall0 != 0) H->reader_stall_ns += mono_ns() - stall0;
      pthread_mutex_unlock(&H->mutex);
      return -2;
    }
    if (stall0 == 0) stall0 = mono_ns();
    if (chan_wait(h, timeout_ms) == ETIMEDOUT) {
      H->reader_stall_ns += mono_ns() - stall0;
      pthread_mutex_unlock(&H->mutex);
      return -3;
    }
  }
  if (stall0 != 0) H->reader_stall_ns += mono_ns() - stall0;
  uint32_t slot = slot_of(H, wanted);
  *seq_out = wanted;
  *len_out = S[slot].len;
  *ptr_out = payload(h, slot);
  pthread_mutex_unlock(&H->mutex);
  return 0;
}

// Release a viewed value: counts the reader's ack and wakes a writer
// blocked on that slot. 0 ok; -5 if the slot no longer holds `seq`
// (double-ack after the ring already wrapped — a caller bug).
int rtpu_chan_ack(void* hp, uint64_t seq) {
  ChanHandle* h = reinterpret_cast<ChanHandle*>(hp);
  ChanHeader* H = chdr(h);
  if (chan_lock(h) != 0) return -1;
  SlotMeta* S = slots(h);
  uint32_t slot = slot_of(H, seq);
  if (S[slot].seq != seq) {
    pthread_mutex_unlock(&H->mutex);
    return -5;
  }
  S[slot].acks++;
  H->reads++;
  if (S[slot].acks >= H->num_readers) pthread_cond_broadcast(&H->cond);
  pthread_mutex_unlock(&H->mutex);
  return 0;
}

uint64_t rtpu_chan_capacity(void* hp) {
  return chdr(reinterpret_cast<ChanHandle*>(hp))->capacity;
}

// header introspection: attach-side handles restore the true reader
// count and ring depth from shm instead of guessing (a re-serialized
// attached handle must keep capacity checks honest)
uint32_t rtpu_chan_num_readers(void* hp) {
  return chdr(reinterpret_cast<ChanHandle*>(hp))->num_readers;
}

uint32_t rtpu_chan_num_slots(void* hp) {
  return chdr(reinterpret_cast<ChanHandle*>(hp))->num_slots;
}

// Telemetry snapshot WITHOUT taking the channel mutex: a monitoring
// thread must never contend with (or be blocked behind) a stalled hot
// path. All fields are 64-bit counters mutated under the mutex; reading
// them unlocked can observe a value mid-update across fields (e.g. seq
// bumped before writes), which is fine for monitoring — each field is
// individually torn-free on 64-bit loads. Occupancy is derived by
// scanning the slot array: a slot holds a live value when it was ever
// written and not every reader has acked it yet.
// out[8]: seq, occupancy, num_slots, writer_stall_ns, reader_stall_ns,
//         writes, reads, closed
void rtpu_chan_stats(void* hp, uint64_t* out) {
  ChanHandle* h = reinterpret_cast<ChanHandle*>(hp);
  ChanHeader* H = chdr(h);
  SlotMeta* S = slots(h);
  uint64_t occ = 0;
  for (uint32_t i = 0; i < H->num_slots; ++i) {
    if (S[i].seq != 0 && S[i].acks < H->num_readers) ++occ;
  }
  out[0] = H->seq;
  out[1] = occ;
  out[2] = H->num_slots;
  out[3] = H->writer_stall_ns;
  out[4] = H->reader_stall_ns;
  out[5] = H->writes;
  out[6] = H->reads;
  out[7] = H->closed;
}

}  // extern "C"
