// Node-local shared-memory object arena — the native core of the object
// store (capability-equivalent of the reference's plasma store:
// src/ray/object_manager/plasma/{store.h,plasma_allocator.*,eviction_policy.*},
// re-designed rather than ported: one mmap'd arena per node with an embedded
// boundary-tag allocator + open-addressing object table + LRU clock, fronted
// by ctypes instead of a socket protocol — every process on the node maps the
// same segment, so create/seal/get are pointer arithmetic, not IPC).
//
// Concurrency: one process-shared robust pthread mutex guards the header,
// table and allocator. Readers pin objects (refcount) so eviction never frees
// memory under a live zero-copy view.
//
// Layout of the shm segment:
//   [Header][Entry table][data region (boundary-tag heap)]
// All offsets are from the start of the segment.
//
// The PyTorch port's own copy of ray_tpu/_native/arena_store.cc (same C
// interface), built with g++ by ray_tpu_torch/core/native_store.py.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545055'41524e41ull;  // "RTPUARNA"
constexpr int kIdLen = 16;
constexpr uint32_t kStateFree = 0;
constexpr uint32_t kStateCreated = 1;
constexpr uint32_t kStateSealed = 2;
constexpr uint32_t kStateTombstone = 3;

struct Entry {
  uint8_t id[kIdLen];
  uint64_t offset;  // data offset of payload (arena-relative)
  uint64_t size;    // payload bytes
  uint32_t state;
  int32_t refcount;
  uint64_t lru;     // last-touch tick
};

// Free/used block header embedded in the data region (boundary tags).
struct Block {
  uint64_t size;       // total block bytes incl. header
  uint64_t prev_size;  // size of the physically preceding block (0 = first)
  uint32_t free;
  uint32_t _pad;
  // free blocks additionally store list links in the payload area:
  // uint64_t next_free, prev_free (arena-relative offsets; 0 = none)
};

struct Header {
  uint64_t magic;
  uint64_t total_size;    // whole segment bytes
  uint64_t table_off;
  uint64_t table_slots;
  uint64_t data_off;
  uint64_t data_size;
  uint64_t used;          // payload bytes currently allocated
  uint64_t lru_clock;
  uint64_t free_head;     // offset of first free block (0 = none)
  uint64_t num_objects;
  pthread_mutex_t mutex;
};

struct Handle {
  void* base;
  uint64_t total;
  int fd;
  bool owner;
  char name[128];
};

inline Header* hdr(Handle* h) { return reinterpret_cast<Header*>(h->base); }
inline uint8_t* at(Handle* h, uint64_t off) {
  return reinterpret_cast<uint8_t*>(h->base) + off;
}
inline Block* block_at(Handle* h, uint64_t off) {
  return reinterpret_cast<Block*>(at(h, off));
}
inline uint64_t* free_links(Handle* h, uint64_t off) {
  return reinterpret_cast<uint64_t*>(at(h, off + sizeof(Block)));
}
inline Entry* table(Handle* h) {
  return reinterpret_cast<Entry*>(at(h, hdr(h)->table_off));
}

constexpr uint64_t kAlign = 64;
inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }
constexpr uint64_t kMinBlock = sizeof(Block) + 2 * sizeof(uint64_t);

uint64_t hash_id(const uint8_t* id) {
  uint64_t h;
  memcpy(&h, id, 8);
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdull;
  h ^= h >> 33;
  return h;
}

int lock(Handle* h) {
  int rc = pthread_mutex_lock(&hdr(h)->mutex);
  if (rc == EOWNERDEAD) {
    // a process died holding the lock; state is still consistent enough for
    // our operations (all mutations are small and idempotent-ish)
    pthread_mutex_consistent(&hdr(h)->mutex);
    return 0;
  }
  return rc;
}
void unlock(Handle* h) { pthread_mutex_unlock(&hdr(h)->mutex); }

// ----------------------------------------------------------------- allocator

void freelist_remove(Handle* h, uint64_t off) {
  uint64_t* links = free_links(h, off);
  uint64_t next = links[0], prev = links[1];
  if (prev) free_links(h, prev)[0] = next;
  else hdr(h)->free_head = next;
  if (next) free_links(h, next)[1] = prev;
}

void freelist_push(Handle* h, uint64_t off) {
  uint64_t* links = free_links(h, off);
  links[0] = hdr(h)->free_head;
  links[1] = 0;
  if (hdr(h)->free_head) free_links(h, hdr(h)->free_head)[1] = off;
  hdr(h)->free_head = off;
}

// allocate a block with >= payload bytes of usable space; returns block
// offset or 0 on failure. Lock held.
uint64_t block_alloc(Handle* h, uint64_t payload) {
  uint64_t need = align_up(sizeof(Block) + payload);
  if (need < kMinBlock) need = kMinBlock;
  uint64_t off = hdr(h)->free_head;
  while (off) {
    Block* b = block_at(h, off);
    if (b->size >= need) {
      freelist_remove(h, off);
      if (b->size - need >= kMinBlock) {
        // split: tail becomes a new free block
        uint64_t tail_off = off + need;
        Block* tail = block_at(h, tail_off);
        tail->size = b->size - need;
        tail->prev_size = need;
        tail->free = 1;
        // fix prev_size of the block after the tail
        uint64_t after = off + b->size;
        if (after < hdr(h)->data_off + hdr(h)->data_size)
          block_at(h, after)->prev_size = tail->size;
        b->size = need;
        freelist_push(h, tail_off);
      }
      b->free = 0;
      return off;
    }
    off = free_links(h, off)[0];
  }
  return 0;
}

void block_free(Handle* h, uint64_t off) {
  Block* b = block_at(h, off);
  uint64_t data_end = hdr(h)->data_off + hdr(h)->data_size;
  // coalesce with next
  uint64_t next_off = off + b->size;
  if (next_off < data_end) {
    Block* nb = block_at(h, next_off);
    if (nb->free) {
      freelist_remove(h, next_off);
      b->size += nb->size;
    }
  }
  // coalesce with prev
  if (b->prev_size) {
    uint64_t prev_off = off - b->prev_size;
    Block* pb = block_at(h, prev_off);
    if (pb->free) {
      freelist_remove(h, prev_off);
      pb->size += b->size;
      off = prev_off;
      b = pb;
    }
  }
  b->free = 1;
  uint64_t after = off + b->size;
  if (after < data_end) block_at(h, after)->prev_size = b->size;
  freelist_push(h, off);
}

// ----------------------------------------------------------------- table

Entry* find_entry(Handle* h, const uint8_t* id) {
  Header* H = hdr(h);
  Entry* t = table(h);
  uint64_t slot = hash_id(id) % H->table_slots;
  for (uint64_t i = 0; i < H->table_slots; i++) {
    Entry* e = &t[(slot + i) % H->table_slots];
    if (e->state == kStateFree) return nullptr;
    if (e->state != kStateTombstone && memcmp(e->id, id, kIdLen) == 0) return e;
  }
  return nullptr;
}

Entry* insert_entry(Handle* h, const uint8_t* id) {
  Header* H = hdr(h);
  Entry* t = table(h);
  uint64_t slot = hash_id(id) % H->table_slots;
  for (uint64_t i = 0; i < H->table_slots; i++) {
    Entry* e = &t[(slot + i) % H->table_slots];
    if (e->state == kStateFree || e->state == kStateTombstone) {
      memcpy(e->id, id, kIdLen);
      return e;
    }
    if (memcmp(e->id, id, kIdLen) == 0) return nullptr;  // exists
  }
  return nullptr;  // table full
}

}  // namespace

extern "C" {

// returns handle pointer or 0. capacity = data region bytes.
void* rtpu_store_create(const char* name, uint64_t capacity) {
  uint64_t slots = capacity / (64 * 1024);
  if (slots < 4096) slots = 4096;
  uint64_t table_bytes = slots * sizeof(Entry);
  uint64_t data_off = align_up(sizeof(Header) + table_bytes);
  uint64_t total = data_off + align_up(capacity);

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
  Handle* h = new Handle{base, total, fd, true, {0}};
  strncpy(h->name, name, sizeof(h->name) - 1);

  Header* H = hdr(h);
  memset(H, 0, sizeof(Header));
  H->total_size = total;
  H->table_off = sizeof(Header);
  H->table_slots = slots;
  H->data_off = data_off;
  H->data_size = align_up(capacity);
  H->used = 0;
  H->lru_clock = 1;
  memset(at(h, H->table_off), 0, table_bytes);

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&H->mutex, &attr);
  pthread_mutexattr_destroy(&attr);

  // one big free block spanning the data region
  Block* b = block_at(h, H->data_off);
  b->size = H->data_size;
  b->prev_size = 0;
  b->free = 1;
  free_links(h, H->data_off)[0] = 0;
  free_links(h, H->data_off)[1] = 0;
  H->free_head = H->data_off;

  __sync_synchronize();
  H->magic = kMagic;
  return h;
}

void* rtpu_store_attach(const char* name) {
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
  Header* H = reinterpret_cast<Header*>(base);
  if (H->magic != kMagic || H->total_size != (uint64_t)st.st_size) {
    munmap(base, (size_t)st.st_size);
    close(fd);
    return nullptr;
  }
  Handle* h = new Handle{base, (uint64_t)st.st_size, fd, false, {0}};
  strncpy(h->name, name, sizeof(h->name) - 1);
  return h;
}

void rtpu_store_close(void* hp, int unlink_segment) {
  Handle* h = reinterpret_cast<Handle*>(hp);
  if (!h) return;
  munmap(h->base, h->total);
  close(h->fd);
  if (unlink_segment) shm_unlink(h->name);
  delete h;
}

// 0 ok (offset_out = payload offset from segment start), -1 no space,
// -2 already exists, -3 table full
int rtpu_store_alloc(void* hp, const uint8_t* id, uint64_t size,
                     uint64_t* offset_out) {
  Handle* h = reinterpret_cast<Handle*>(hp);
  if (lock(h) != 0) return -4;
  if (find_entry(h, id)) {
    unlock(h);
    return -2;
  }
  uint64_t boff = block_alloc(h, size);
  if (!boff) {
    unlock(h);
    return -1;
  }
  Entry* e = insert_entry(h, id);
  if (!e) {
    block_free(h, boff);
    unlock(h);
    return -3;
  }
  e->offset = boff + sizeof(Block);
  e->size = size;
  e->state = kStateCreated;
  e->refcount = 0;
  e->lru = hdr(h)->lru_clock++;
  hdr(h)->used += size;
  hdr(h)->num_objects++;
  *offset_out = e->offset;
  unlock(h);
  return 0;
}

int rtpu_store_seal(void* hp, const uint8_t* id) {
  Handle* h = reinterpret_cast<Handle*>(hp);
  if (lock(h) != 0) return -4;
  Entry* e = find_entry(h, id);
  if (!e) {
    unlock(h);
    return -1;
  }
  e->state = kStateSealed;
  unlock(h);
  return 0;
}

// 0 ok; -1 missing; -3 not sealed. pin!=0 increments refcount.
int rtpu_store_get(void* hp, const uint8_t* id, uint64_t* off_out,
                   uint64_t* size_out, int pin) {
  Handle* h = reinterpret_cast<Handle*>(hp);
  if (lock(h) != 0) return -4;
  Entry* e = find_entry(h, id);
  if (!e) {
    unlock(h);
    return -1;
  }
  if (e->state != kStateSealed) {
    unlock(h);
    return -3;
  }
  e->lru = hdr(h)->lru_clock++;
  if (pin) e->refcount++;
  *off_out = e->offset;
  *size_out = e->size;
  unlock(h);
  return 0;
}

int rtpu_store_release(void* hp, const uint8_t* id) {
  Handle* h = reinterpret_cast<Handle*>(hp);
  if (lock(h) != 0) return -4;
  Entry* e = find_entry(h, id);
  if (e && e->refcount > 0) e->refcount--;
  unlock(h);
  return e ? 0 : -1;
}

// force=1 deletes even when pinned (owner shutdown / dead-reader cleanup)
int rtpu_store_delete(void* hp, const uint8_t* id, int force) {
  Handle* h = reinterpret_cast<Handle*>(hp);
  if (lock(h) != 0) return -4;
  Entry* e = find_entry(h, id);
  if (!e) {
    unlock(h);
    return -1;
  }
  if (e->refcount > 0 && !force) {
    unlock(h);
    return -5;
  }
  block_free(h, e->offset - sizeof(Block));
  hdr(h)->used -= e->size;
  hdr(h)->num_objects--;
  e->state = kStateTombstone;
  unlock(h);
  return 0;
}

// Collect LRU sealed refcount-0 objects until their sizes sum to >= needed.
// out_ids must hold max_out * kIdLen bytes. Returns count (may free fewer
// bytes than needed if not enough candidates).
int rtpu_store_evict_candidates(void* hp, uint64_t needed, uint8_t* out_ids,
                                int max_out) {
  Handle* h = reinterpret_cast<Handle*>(hp);
  if (lock(h) != 0) return -4;
  Header* H = hdr(h);
  Entry* t = table(h);
  int n = 0;
  uint64_t freed = 0;
  while (freed < needed && n < max_out) {
    Entry* best = nullptr;
    for (uint64_t i = 0; i < H->table_slots; i++) {
      Entry* e = &t[i];
      if (e->state != kStateSealed || e->refcount != 0) continue;
      bool taken = false;
      for (int j = 0; j < n; j++) {
        if (memcmp(out_ids + j * kIdLen, e->id, kIdLen) == 0) {
          taken = true;
          break;
        }
      }
      if (taken) continue;
      if (!best || e->lru < best->lru) best = e;
    }
    if (!best) break;
    memcpy(out_ids + n * kIdLen, best->id, kIdLen);
    freed += best->size;
    n++;
  }
  unlock(h);
  return n;
}

void rtpu_store_stats(void* hp, uint64_t* used, uint64_t* capacity,
                      uint64_t* count) {
  Handle* h = reinterpret_cast<Handle*>(hp);
  Header* H = hdr(h);
  if (used) *used = H->used;
  if (capacity) *capacity = H->data_size;
  if (count) *count = H->num_objects;
}

uint64_t rtpu_store_data_offset(void* hp) {
  return hdr(reinterpret_cast<Handle*>(hp))->data_off;
}

}  // extern "C"
