// Persistent, mmap-backed feature index store.
//
// TPU-native equivalent of the reference's PalDB-based feature index maps
// (index.PalDBIndexMap / PalDBIndexMapBuilder -- SURVEY.md 3.3; reference
// mount empty, paths unverified): a read-only key->index store built once by
// the feature-indexing driver and then opened by every training / scoring
// process with zero parse time (mmap) and no Python-heap cost per entry.
//
// File layout (little-endian, 8-byte aligned):
//   Header | Slot[num_slots] | keys blob
// Open-addressed hash table with linear probing; FNV-1a 64 hashing; hash
// value 0 marks an empty slot (occupied hashes are forced odd).
//
// C API (ctypes-friendly), exported below:
//   fis_build(blob, offsets, lens, indices, n, path) -> 0/-errno
//   fis_open(path) -> handle|NULL, fis_close(handle)
//   fis_size(handle), fis_lookup(handle, key, len) -> index|-1
//   fis_lookup_batch(handle, blob, offsets, lens, n, out_indices)
//   fis_entry(handle, slot, &key_off, &key_len, &index) -> 1 if occupied

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5048304649445831ULL;  // "PH0FIDX1"

struct Header {
  uint64_t magic;
  uint64_t num_entries;
  uint64_t num_slots;  // power of two
  uint64_t keys_offset;
  uint64_t keys_size;
};

struct Slot {
  uint64_t hash;      // 0 = empty
  uint64_t key_off;   // offset into keys blob
  uint32_t key_len;
  int32_t index;
};

struct Store {
  void* map;
  size_t map_size;
  const Header* header;
  const Slot* slots;
  const char* keys;
};

uint64_t fnv1a(const char* s, uint32_t len) {
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= 1099511628211ULL;
  }
  return h | 1ULL;  // never 0 so 0 can mark empty slots
}

uint64_t next_pow2(uint64_t x) {
  uint64_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Build the store file. Keys arrive as one concatenated blob with per-key
// (offset, len); duplicate keys are rejected (-EEXIST).
int fis_build(const char* blob, const uint64_t* offsets, const uint32_t* lens,
              const int32_t* indices, uint64_t n, const char* path) {
  // load factor <= 0.5 keeps linear-probe chains short
  uint64_t num_slots = next_pow2(n == 0 ? 1 : n * 2);
  uint64_t keys_size = 0;
  for (uint64_t i = 0; i < n; ++i) keys_size += lens[i];

  Header header;
  std::memset(&header, 0, sizeof(header));
  header.magic = kMagic;
  header.num_entries = n;
  header.num_slots = num_slots;
  header.keys_offset = sizeof(Header) + num_slots * sizeof(Slot);
  header.keys_size = keys_size;

  Slot* slots = static_cast<Slot*>(std::calloc(num_slots, sizeof(Slot)));
  if (!slots) return -ENOMEM;

  uint64_t mask = num_slots - 1;
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t h = fnv1a(blob + offsets[i], lens[i]);
    uint64_t s = h & mask;
    while (slots[s].hash != 0) {
      if (slots[s].hash == h && slots[s].key_len == lens[i] &&
          std::memcmp(blob + slots[s].key_off, blob + offsets[i], lens[i]) == 0) {
        std::free(slots);
        return -EEXIST;
      }
      s = (s + 1) & mask;
    }
    slots[s].hash = h;
    slots[s].key_off = offsets[i];
    slots[s].key_len = lens[i];
    slots[s].index = indices[i];
  }

  FILE* f = std::fopen(path, "wb");
  if (!f) {
    std::free(slots);
    return -errno;
  }
  int rc = 0;
  if (std::fwrite(&header, sizeof(header), 1, f) != 1) rc = -EIO;
  if (rc == 0 && num_slots &&
      std::fwrite(slots, sizeof(Slot), num_slots, f) != num_slots)
    rc = -EIO;
  if (rc == 0 && keys_size && std::fwrite(blob, 1, keys_size, f) != keys_size)
    rc = -EIO;
  // NOTE: assumes each key's bytes live at blob[offsets[i]..+lens[i]) within
  // one contiguous blob of exactly keys_size bytes (the Python builder
  // guarantees this); key_off indexes that same blob after mmap.
  if (std::fclose(f) != 0 && rc == 0) rc = -EIO;
  std::free(slots);
  return rc;
}

void* fis_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  ::close(fd);
  if (map == MAP_FAILED) return nullptr;

  const Header* header = static_cast<const Header*>(map);
  if (header->magic != kMagic ||
      header->keys_offset + header->keys_size !=
          static_cast<uint64_t>(st.st_size)) {
    munmap(map, st.st_size);
    return nullptr;
  }
  Store* store = new Store;
  store->map = map;
  store->map_size = st.st_size;
  store->header = header;
  store->slots = reinterpret_cast<const Slot*>(static_cast<const char*>(map) +
                                               sizeof(Header));
  store->keys = static_cast<const char*>(map) + header->keys_offset;
  return store;
}

void fis_close(void* handle) {
  Store* store = static_cast<Store*>(handle);
  if (!store) return;
  munmap(store->map, store->map_size);
  delete store;
}

uint64_t fis_size(void* handle) {
  return static_cast<Store*>(handle)->header->num_entries;
}

uint64_t fis_num_slots(void* handle) {
  return static_cast<Store*>(handle)->header->num_slots;
}

int32_t fis_lookup(void* handle, const char* key, uint32_t len) {
  const Store* store = static_cast<Store*>(handle);
  uint64_t mask = store->header->num_slots - 1;
  uint64_t h = fnv1a(key, len);
  uint64_t s = h & mask;
  while (store->slots[s].hash != 0) {
    const Slot& slot = store->slots[s];
    if (slot.hash == h && slot.key_len == len &&
        std::memcmp(store->keys + slot.key_off, key, len) == 0)
      return slot.index;
    s = (s + 1) & mask;
  }
  return -1;
}

void fis_lookup_batch(void* handle, const char* blob, const uint64_t* offsets,
                      const uint32_t* lens, uint64_t n, int32_t* out) {
  for (uint64_t i = 0; i < n; ++i)
    out[i] = fis_lookup(handle, blob + offsets[i], lens[i]);
}

// Iterate hash slots (0..num_slots): returns 1 and fills outputs if the slot
// is occupied. Iteration order is slot order, not insertion order.
int fis_entry(void* handle, uint64_t slot, uint64_t* key_off,
              uint32_t* key_len, int32_t* index) {
  const Store* store = static_cast<Store*>(handle);
  if (slot >= store->header->num_slots) return 0;
  const Slot& s = store->slots[slot];
  if (s.hash == 0) return 0;
  *key_off = s.key_off;
  *key_len = s.key_len;
  *index = s.index;
  return 1;
}

const char* fis_keys_blob(void* handle) {
  return static_cast<Store*>(handle)->keys;
}

}  // extern "C"
