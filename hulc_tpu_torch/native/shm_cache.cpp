// Shared-memory episode cache for the CALVIN data path.
//
// Native equivalent of the reference's ShmDataset machinery
// (calvin_agent.datasets.shm_dataset + shared_memory_utils, SURVEY.md §2.9):
// one process decodes the npz split into a POSIX shared-memory arena; any
// number of loader processes attach zero-copy and gather padded training
// windows with tight memcpy loops (the hot host-side path: a 64x32-frame
// uint8 batch at 200 / 84 px is 289 MB of scattered copies per optimizer step).
//
// Arena layout:
//   [Header][KeyDesc x n_keys][data key 0][data key 1]...
// Each key is a contiguous (n_frames, frame_elems) array. The header's
// `ready` flag is the cross-process readiness signal (the reference's
// SignalCallback role).
//
// A copy of the JAX package's hulc_tpu/native/shm_cache.cpp for the PyTorch
// port. Built with g++ into build/ at first use and bound with ctypes by
// hulc_tpu_torch/data/shm_store.py.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <vector>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x48554C435F53484DULL;  // "HULC_SHM"
constexpr int kMaxKeys = 16;
constexpr int kKeyNameLen = 32;

struct KeyDesc {
  char name[kKeyNameLen];
  uint64_t offset;       // bytes from arena start
  uint64_t frame_bytes;  // bytes per frame
  uint64_t elem_size;    // dtype itemsize
};

struct Header {
  uint64_t magic;
  uint64_t total_bytes;
  uint64_t n_frames;
  uint64_t n_keys;
  volatile uint64_t ready;  // 0 while writing, 1 when complete
  KeyDesc keys[kMaxKeys];
};

struct Arena {
  int fd;
  uint8_t* base;
  uint64_t size;
};

const KeyDesc* find_key(const Header* h, const char* name) {
  for (uint64_t i = 0; i < h->n_keys; ++i) {
    if (std::strncmp(h->keys[i].name, name, kKeyNameLen) == 0) return &h->keys[i];
  }
  return nullptr;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Writer
// ---------------------------------------------------------------------------

// Create the arena. key_names: n_keys strings of <32 chars; frame_bytes /
// elem_sizes arrays give per-key strides. Returns opaque handle or null.
void* hulc_shm_create(const char* shm_name, uint64_t n_frames, uint64_t n_keys,
                      const char** key_names, const uint64_t* frame_bytes,
                      const uint64_t* elem_sizes) {
  if (n_keys > kMaxKeys) return nullptr;
  uint64_t offset = sizeof(Header);
  Header hdr{};
  hdr.magic = kMagic;
  hdr.n_frames = n_frames;
  hdr.n_keys = n_keys;
  hdr.ready = 0;
  for (uint64_t i = 0; i < n_keys; ++i) {
    std::strncpy(hdr.keys[i].name, key_names[i], kKeyNameLen - 1);
    hdr.keys[i].offset = offset;
    hdr.keys[i].frame_bytes = frame_bytes[i];
    hdr.keys[i].elem_size = elem_sizes[i];
    offset += frame_bytes[i] * n_frames;
  }
  hdr.total_bytes = offset;

  // O_EXCL without a pre-unlink: when two processes cold-start, exactly one
  // creates (and populates); the loser attaches and waits on the ready flag.
  int fd = shm_open(shm_name, O_CREAT | O_RDWR | O_EXCL, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)offset) != 0) {
    close(fd);
    shm_unlink(shm_name);
    return nullptr;
  }
  void* base = mmap(nullptr, offset, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    shm_unlink(shm_name);
    return nullptr;
  }
  std::memcpy(base, &hdr, sizeof(Header));
  Arena* a = new Arena{fd, (uint8_t*)base, offset};
  return a;
}

// Attach an existing arena read-only(ish). Returns handle or null.
void* hulc_shm_attach(const char* shm_name) {
  int fd = shm_open(shm_name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Header* h = (Header*)base;
  if (h->magic != kMagic) {
    munmap(base, st.st_size);
    close(fd);
    return nullptr;
  }
  return new Arena{fd, (uint8_t*)base, (uint64_t)st.st_size};
}

void hulc_shm_close(void* handle, int unlink_shm, const char* shm_name) {
  Arena* a = (Arena*)handle;
  if (!a) return;
  munmap(a->base, a->size);
  close(a->fd);
  if (unlink_shm && shm_name) shm_unlink(shm_name);
  delete a;
}

// Write frames [frame_idx, frame_idx + count) of a key from src.
int hulc_shm_write(void* handle, const char* key, uint64_t frame_idx,
                   uint64_t count, const void* src) {
  Arena* a = (Arena*)handle;
  Header* h = (Header*)a->base;
  const KeyDesc* k = find_key(h, key);
  if (!k || frame_idx + count > h->n_frames) return -1;
  std::memcpy(a->base + k->offset + frame_idx * k->frame_bytes, src,
              count * k->frame_bytes);
  return 0;
}

void hulc_shm_set_ready(void* handle) {
  ((Header*)((Arena*)handle)->base)->ready = 1;
  msync(((Arena*)handle)->base, sizeof(Header), MS_SYNC);
}

int hulc_shm_is_ready(void* handle) {
  return (int)((Header*)((Arena*)handle)->base)->ready;
}

uint64_t hulc_shm_n_frames(void* handle) {
  return ((Header*)((Arena*)handle)->base)->n_frames;
}

// Raw pointer to a key's (n_frames, frame_bytes) array (zero-copy numpy view).
void* hulc_shm_key_ptr(void* handle, const char* key, uint64_t* frame_bytes_out) {
  Arena* a = (Arena*)handle;
  const KeyDesc* k = find_key((Header*)a->base, key);
  if (!k) return nullptr;
  if (frame_bytes_out) *frame_bytes_out = k->frame_bytes;
  return a->base + k->offset;
}

// ---------------------------------------------------------------------------
// Batched window gather (the hot loop)
// ---------------------------------------------------------------------------

// Gather B windows of a key into out (B, max_window, frame_bytes), padding
// short windows by repeating the final frame (calvin pad=True semantics for
// observations; relative-action zeroing is handled in Python).
namespace {

// Copy windows [b_lo, b_hi) of one key. Returns 0 or -2 on a bad window.
int gather_range(const Header* h, const KeyDesc* k, const uint8_t* data,
                 const int64_t* starts, const int64_t* lengths,
                 uint64_t max_window, uint8_t* out, uint64_t b_lo,
                 uint64_t b_hi) {
  const uint64_t fb = k->frame_bytes;
  for (uint64_t b = b_lo; b < b_hi; ++b) {
    const int64_t start = starts[b];
    const int64_t len = lengths[b];
    if (start < 0 || (uint64_t)(start + len) > h->n_frames || len <= 0) return -2;
    uint8_t* dst = out + b * max_window * fb;
    const uint64_t take = (uint64_t)len < max_window ? (uint64_t)len : max_window;
    std::memcpy(dst, data + (uint64_t)start * fb, take * fb);
    // pad by repeating the last copied frame
    const uint8_t* last = dst + (take - 1) * fb;
    for (uint64_t t = take; t < max_window; ++t) {
      std::memcpy(dst + t * fb, last, fb);
    }
  }
  return 0;
}

}  // namespace

int hulc_shm_gather_windows(void* handle, const char* key, const int64_t* starts,
                            const int64_t* lengths, uint64_t batch,
                            uint64_t max_window, uint8_t* out) {
  Arena* a = (Arena*)handle;
  Header* h = (Header*)a->base;
  const KeyDesc* k = find_key(h, key);
  if (!k) return -1;
  return gather_range(h, k, a->base + k->offset, starts, lengths, max_window,
                      out, 0, batch);
}

// Threaded gather: the batch dim is split across n_threads std::threads.
// ctypes callers release the GIL for the duration, so this is real host
// parallelism on a multi-core host.
int hulc_shm_gather_windows_mt(void* handle, const char* key,
                               const int64_t* starts, const int64_t* lengths,
                               uint64_t batch, uint64_t max_window,
                               uint8_t* out, uint64_t n_threads) {
  Arena* a = (Arena*)handle;
  Header* h = (Header*)a->base;
  const KeyDesc* k = find_key(h, key);
  if (!k) return -1;
  const uint8_t* data = a->base + k->offset;
  if (n_threads <= 1 || batch <= 1) {
    return gather_range(h, k, data, starts, lengths, max_window, out, 0, batch);
  }
  if (n_threads > batch) n_threads = batch;
  std::vector<int> rcs(n_threads, 0);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  const uint64_t per = (batch + n_threads - 1) / n_threads;
  for (uint64_t t = 0; t < n_threads; ++t) {
    const uint64_t lo = t * per;
    const uint64_t hi = lo + per < batch ? lo + per : batch;
    if (lo >= hi) break;
    threads.emplace_back([=, &rcs] {
      rcs[t] = gather_range(h, k, data, starts, lengths, max_window, out, lo, hi);
    });
  }
  for (auto& th : threads) th.join();
  for (int rc : rcs)
    if (rc != 0) return rc;
  return 0;
}

}  // extern "C"
