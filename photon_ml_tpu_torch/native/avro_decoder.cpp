// Native Avro training-example decoder: the host-side ingestion hot path.
//
// SURVEY.md 7 flags the host<->device data pipeline as the likely real
// bottleneck at TB scale ("overlap Avro decode/index with device compute").
// The reference leans on the JVM + Spark for decode throughput; the
// equivalent here is this C++ decoder (a copy of the JAX package's
// photon_ml_tpu/native/avro_decoder.cpp): it walks Avro object-container
// blocks (null/deflate codecs), executes a compact field program compiled by
// Python from the writer schema, and materializes columnar buffers (labels /
// offsets / weights, ragged feature index+value arrays, selected metadata
// columns) with feature name/term resolution done in-process — against the
// mmap'd feature index store (feature_index_store.cpp) or by FNV-1a hashing
// — so per-feature work never touches the Python interpreter.
//
// Field program: one opcode per top-level record field, executed in order
// per record.
//   0x01 CAP_LABEL_D        double
//   0x02 CAP_LABEL_ND u8    union, followed by the null-branch index
//   0x03 CAP_OFFSET_D       (same pattern for offset / weight)
//   0x04 CAP_OFFSET_ND u8
//   0x05 CAP_WEIGHT_D
//   0x06 CAP_WEIGHT_ND u8
//   0x07 CAP_FEATURES       array<record{name:string, term:string, value:double}>
//   0x08 CAP_METADATA       map<string,string>; keys matched against the
//                           requested entity columns
//   0x09 CAP_UID u8 is_union, u8 n, then n branch kinds (0=null 1=string
//                           2=long); a union uid reads a branch index from
//                           the stream (Avro writes one even for 1-branch
//                           unions), a plain uid does not
//   0x10 SKIP_NULL  0x11 SKIP_BOOL  0x12 SKIP_VARINT  0x13 SKIP_FLOAT
//   0x14 SKIP_DOUBLE  0x15 SKIP_BYTES (string/bytes)
//   0x16 SKIP_UNION u8 n, then n sub-opcodes (branch dispatch)
//   0x17 SKIP_ARRAY, sub-opcode          0x18 SKIP_MAP, value sub-opcode
//   0x19 SKIP_RECORD u8 n, then n sub-opcodes
//
// Python (io/native_reader.py) validates the writer schema shape before
// choosing this path and falls back to the pure-Python reader otherwise.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

// Feature-index-store lookup, passed in as a function pointer by Python
// (ctypes address of fis_lookup from the separately-loaded
// feature_index_store library) so this library has no undefined externs
// and dlopens standalone.
using fis_lookup_fn = int32_t (*)(void*, const char*, uint32_t);

namespace {

constexpr uint8_t CAP_LABEL_D = 0x01, CAP_LABEL_ND = 0x02, CAP_OFFSET_D = 0x03,
                  CAP_OFFSET_ND = 0x04, CAP_WEIGHT_D = 0x05,
                  CAP_WEIGHT_ND = 0x06, CAP_FEATURES = 0x07,
                  CAP_METADATA = 0x08, CAP_UID = 0x09;
constexpr uint8_t SKIP_NULL = 0x10, SKIP_BOOL = 0x11, SKIP_VARINT = 0x12,
                  SKIP_FLOAT = 0x13, SKIP_DOUBLE = 0x14, SKIP_BYTES = 0x15,
                  SKIP_UNION = 0x16, SKIP_ARRAY = 0x17, SKIP_MAP = 0x18,
                  SKIP_RECORD = 0x19;

constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001B3ULL;

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool fail = false;

  bool need(size_t n) {
    if (static_cast<size_t>(end - p) < n) {
      fail = true;
      return false;
    }
    return true;
  }
  int64_t read_long() {  // zigzag varint
    uint64_t acc = 0;
    int shift = 0;
    while (true) {
      if (!need(1)) return 0;
      uint8_t b = *p++;
      acc |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
      if (shift > 63) {
        fail = true;
        return 0;
      }
    }
    return static_cast<int64_t>(acc >> 1) ^ -static_cast<int64_t>(acc & 1);
  }
  double read_double() {
    if (!need(8)) return 0.0;
    double v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }
  void skip(size_t n) {
    if (need(n)) p += n;
  }
};

struct EntityCol {
  std::string key;
  // per-row value bytes (concatenated) + offsets
  std::vector<uint8_t> blob;
  std::vector<uint64_t> offsets;  // size rows+1
  std::vector<uint8_t> present;   // per row: key present in metadataMap
};

struct Output {
  std::vector<double> labels, offsets, weights;
  std::vector<uint8_t> has_label;
  std::vector<int32_t> feat_counts;  // per row
  // per shard: one resolved index per feature occurrence (-1 = dropped);
  // the name/term/value walk happens once, resolution fans out per shard
  std::vector<std::vector<int32_t>> feat_indices;
  std::vector<double> feat_values;
  std::vector<EntityCol> entities;
  EntityCol uid;                      // per-row uid bytes (string/long text)
  std::vector<uint8_t> uid_kind;      // 0=null, 1=string, 2=long
  uint64_t rows = 0;
  std::string error;
};

uint64_t fnv1a(const uint8_t* s, size_t len, uint64_t h = kFnvOffset) {
  for (size_t i = 0; i < len; ++i) {
    h ^= s[i];
    h *= kFnvPrime;
  }
  return h;
}

// Skip one value described by the sub-opcode program at *prog (advances it).
void skip_value(Cursor& c, const uint8_t*& prog, const uint8_t* prog_end);

void skip_blocks(Cursor& c, const uint8_t* item_prog,
                 const uint8_t* prog_end, bool is_map) {
  while (!c.fail) {
    int64_t count = c.read_long();
    if (count == 0) break;
    if (count < 0) {  // block with byte size: skip wholesale
      int64_t size = c.read_long();
      if (size < 0) {
        c.fail = true;
        return;
      }
      c.skip(static_cast<size_t>(size));
      continue;
    }
    for (int64_t i = 0; i < count && !c.fail; ++i) {
      if (is_map) {
        int64_t klen = c.read_long();
        if (klen < 0) {
          c.fail = true;
          return;
        }
        c.skip(static_cast<size_t>(klen));
      }
      const uint8_t* p = item_prog;
      skip_value(c, p, prog_end);
    }
  }
}

void skip_value(Cursor& c, const uint8_t*& prog, const uint8_t* prog_end) {
  if (prog >= prog_end) {
    c.fail = true;
    return;
  }
  uint8_t op = *prog++;
  switch (op) {
    case SKIP_NULL:
      break;
    case SKIP_BOOL:
      c.skip(1);
      break;
    case SKIP_VARINT:
      c.read_long();
      break;
    case SKIP_FLOAT:
      c.skip(4);
      break;
    case SKIP_DOUBLE:
      c.skip(8);
      break;
    case SKIP_BYTES: {
      int64_t len = c.read_long();
      if (len < 0) {
        c.fail = true;
        return;
      }
      c.skip(static_cast<size_t>(len));
      break;
    }
    case SKIP_UNION: {
      if (prog >= prog_end) {
        c.fail = true;
        return;
      }
      uint8_t n = *prog++;
      // locate branch sub-programs (they are laid out back to back)
      int64_t branch = c.read_long();
      const uint8_t* p = prog;
      for (uint8_t i = 0; i < n; ++i) {
        if (i == branch) {
          const uint8_t* bp = p;
          skip_value(c, bp, prog_end);
        } else {
          // advance p past this branch without consuming input
          Cursor dummy{nullptr, nullptr};
          dummy.fail = true;  // never reads
          const uint8_t* bp = p;
          // structural walk: reuse skip_value's program advance by walking
          // with a cursor that can't read; we only need prog advancement
          skip_value(dummy, bp, prog_end);
          p = bp;
          continue;
        }
        // advance p past consumed branch program
        {
          Cursor dummy{nullptr, nullptr};
          dummy.fail = true;
          const uint8_t* bp = p;
          skip_value(dummy, bp, prog_end);
          p = bp;
        }
      }
      if (branch < 0 || branch >= n) c.fail = true;
      prog = p;
      break;
    }
    case SKIP_ARRAY: {
      const uint8_t* item = prog;
      // advance prog past the item program
      Cursor dummy{nullptr, nullptr};
      dummy.fail = true;
      const uint8_t* bp = prog;
      skip_value(dummy, bp, prog_end);
      skip_blocks(c, item, prog_end, /*is_map=*/false);
      prog = bp;
      break;
    }
    case SKIP_MAP: {
      const uint8_t* item = prog;
      Cursor dummy{nullptr, nullptr};
      dummy.fail = true;
      const uint8_t* bp = prog;
      skip_value(dummy, bp, prog_end);
      skip_blocks(c, item, prog_end, /*is_map=*/true);
      prog = bp;
      break;
    }
    case SKIP_RECORD: {
      if (prog >= prog_end) {
        c.fail = true;
        return;
      }
      uint8_t n = *prog++;
      for (uint8_t i = 0; i < n; ++i) skip_value(c, prog, prog_end);
      break;
    }
    default:
      c.fail = true;
  }
}

double read_nullable_double(Cursor& c, uint8_t null_branch, bool* present) {
  int64_t branch = c.read_long();
  if (branch == null_branch) {
    *present = false;
    return 0.0;
  }
  *present = true;
  return c.read_double();
}

struct FeatureResolver {
  void* fis;             // feature_index_store handle, may be null
  fis_lookup_fn lookup;  // its lookup entry point (ctypes-provided)
  int64_t hash_dim;      // >0: FNV hash % dim when no store
  char sep;              // name/term separator (\x01)

  int32_t resolve(const uint8_t* name, size_t nlen, const uint8_t* term,
                  size_t tlen) const {
    if (fis && lookup) {
      // key = name [sep term]
      char stack_buf[256];
      std::vector<char> heap_buf;
      size_t klen = nlen + (tlen ? 1 + tlen : 0);
      char* key = stack_buf;
      if (klen > sizeof(stack_buf)) {
        heap_buf.resize(klen);
        key = heap_buf.data();
      }
      std::memcpy(key, name, nlen);
      if (tlen) {
        key[nlen] = sep;
        std::memcpy(key + nlen + 1, term, tlen);
      }
      return lookup(fis, key, static_cast<uint32_t>(klen));
    }
    if (hash_dim > 0) {
      uint64_t h = fnv1a(name, nlen);
      if (tlen) {
        uint8_t s = static_cast<uint8_t>(sep);
        h = fnv1a(&s, 1, h);
        h = fnv1a(term, tlen, h);
      }
      return static_cast<int32_t>(h % static_cast<uint64_t>(hash_dim));
    }
    return -1;
  }
};

// Decode the features array: record{name, term, value} items, resolving
// each feature against every shard's resolver in one walk.
void decode_features(Cursor& c, const std::vector<FeatureResolver>& frs,
                     Output& out) {
  int32_t count = 0;
  while (!c.fail) {
    int64_t n = c.read_long();
    if (n == 0) break;
    if (n < 0) {
      c.read_long();  // byte size (unused; we still decode items)
      n = -n;
    }
    for (int64_t i = 0; i < n && !c.fail; ++i) {
      int64_t nlen = c.read_long();
      if (nlen < 0 || !c.need(static_cast<size_t>(nlen))) {
        c.fail = true;
        return;
      }
      const uint8_t* name = c.p;
      c.p += nlen;
      int64_t tlen = c.read_long();
      if (tlen < 0 || !c.need(static_cast<size_t>(tlen))) {
        c.fail = true;
        return;
      }
      const uint8_t* term = c.p;
      c.p += tlen;
      double value = c.read_double();
      for (size_t s = 0; s < frs.size(); ++s) {
        out.feat_indices[s].push_back(
            frs[s].resolve(name, static_cast<size_t>(nlen), term,
                           static_cast<size_t>(tlen)));
      }
      out.feat_values.push_back(value);
      ++count;
    }
  }
  out.feat_counts.push_back(count);
}

void decode_metadata(Cursor& c, Output& out, uint64_t row) {
  // mark all entity columns absent for this row, fill when seen
  while (!c.fail) {
    int64_t n = c.read_long();
    if (n == 0) break;
    if (n < 0) {
      c.read_long();
      n = -n;
    }
    for (int64_t i = 0; i < n && !c.fail; ++i) {
      int64_t klen = c.read_long();
      if (klen < 0 || !c.need(static_cast<size_t>(klen))) {
        c.fail = true;
        return;
      }
      const uint8_t* key = c.p;
      c.p += klen;
      int64_t vlen = c.read_long();
      if (vlen < 0 || !c.need(static_cast<size_t>(vlen))) {
        c.fail = true;
        return;
      }
      const uint8_t* val = c.p;
      c.p += vlen;
      for (auto& col : out.entities) {
        if (col.offsets.size() == row + 2) continue;  // already set
        if (col.key.size() == static_cast<size_t>(klen) &&
            std::memcmp(col.key.data(), key, klen) == 0) {
          col.blob.insert(col.blob.end(), val, val + vlen);
          col.offsets.push_back(col.blob.size());
          col.present.push_back(1);
        }
      }
    }
  }
}

bool decode_record(Cursor& c, const uint8_t* prog, const uint8_t* prog_end,
                   const std::vector<FeatureResolver>& frs, Output& out) {
  uint64_t row = out.rows;
  bool saw_features = false, saw_meta = false;
  double label = 0.0, offset = 0.0, weight = 1.0;
  bool has_label = false;
  const uint8_t* p = prog;
  while (p < prog_end && !c.fail) {
    uint8_t op = *p++;
    bool present;
    switch (op) {
      case CAP_LABEL_D:
        label = c.read_double();
        has_label = true;
        break;
      case CAP_LABEL_ND:
        label = read_nullable_double(c, *p++, &present);
        has_label = present;
        break;
      case CAP_OFFSET_D:
        offset = c.read_double();
        break;
      case CAP_OFFSET_ND:
        offset = read_nullable_double(c, *p++, &present);
        if (!present) offset = 0.0;
        break;
      case CAP_WEIGHT_D:
        weight = c.read_double();
        break;
      case CAP_WEIGHT_ND:
        weight = read_nullable_double(c, *p++, &present);
        if (!present) weight = 1.0;
        break;
      case CAP_FEATURES:
        decode_features(c, frs, out);
        saw_features = true;
        break;
      case CAP_METADATA:
        decode_metadata(c, out, row);
        saw_meta = true;
        break;
      case CAP_UID: {
        // program: u8 is_union, u8 n, then n branch kinds (0=null 1=string
        // 2=long); unions carry a branch index in the stream even when they
        // have a single branch
        uint8_t is_union = *p++;
        uint8_t n = *p++;
        int64_t branch = is_union ? c.read_long() : 0;
        if (branch < 0 || branch >= n) {
          c.fail = true;
          break;
        }
        uint8_t kind = p[branch];
        p += n;
        if (kind == 1) {  // string
          int64_t len = c.read_long();
          if (len < 0 || !c.need(static_cast<size_t>(len))) {
            c.fail = true;
            break;
          }
          out.uid.blob.insert(out.uid.blob.end(), c.p, c.p + len);
          c.p += len;
        } else if (kind == 2) {  // long -> decimal text
          char buf[24];
          int len = std::snprintf(buf, sizeof(buf), "%lld",
                                  static_cast<long long>(c.read_long()));
          out.uid.blob.insert(out.uid.blob.end(), buf, buf + len);
        }
        out.uid.offsets.push_back(out.uid.blob.size());
        out.uid_kind.push_back(kind);
        break;
      }
      default:
        --p;
        skip_value(c, p, prog_end);
    }
  }
  if (c.fail) return false;
  if (!saw_features) out.feat_counts.push_back(0);
  for (auto& col : out.entities) {
    if (col.offsets.size() == row + 1) {  // column absent for this row
      col.offsets.push_back(col.blob.size());
      col.present.push_back(0);
    }
  }
  (void)saw_meta;
  out.labels.push_back(label);
  out.has_label.push_back(has_label ? 1 : 0);
  out.offsets.push_back(offset);
  out.weights.push_back(weight);
  out.rows += 1;
  return true;
}

bool inflate_block(const uint8_t* src, size_t src_len,
                   std::vector<uint8_t>& dst) {
  // Avro deflate = raw DEFLATE (windowBits = -15)
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(src_len);
  dst.clear();
  dst.resize(src_len * 4 + 64);
  size_t written = 0;
  int rc;
  do {
    if (written == dst.size()) dst.resize(dst.size() * 2);
    zs.next_out = dst.data() + written;
    zs.avail_out = static_cast<uInt>(dst.size() - written);
    rc = inflate(&zs, Z_NO_FLUSH);
    written = dst.size() - zs.avail_out;
    if (rc == Z_BUF_ERROR && zs.avail_in == 0) break;
  } while (rc == Z_OK);
  inflateEnd(&zs);
  if (rc != Z_STREAM_END) return false;
  dst.resize(written);
  return true;
}

// Decode one raw block payload (inflating if needed) into `out`. The
// serial entry point and every worker thread of the parallel one both land
// here.
bool decode_one_block(Output& out, const uint8_t* data, size_t len,
                      bool codec_deflate, int64_t n_records,
                      const uint8_t* prog, uint32_t prog_len,
                      const std::vector<FeatureResolver>& frs) {
  std::vector<uint8_t> scratch;
  const uint8_t* payload = data;
  size_t payload_len = len;
  if (codec_deflate) {
    if (!inflate_block(data, payload_len, scratch)) {
      out.error = "deflate decode failed";
      return false;
    }
    payload = scratch.data();
    payload_len = scratch.size();
  }
  Cursor c{payload, payload + payload_len};
  for (int64_t i = 0; i < n_records; ++i) {
    if (!decode_record(c, prog, prog + prog_len, frs, out)) {
      out.error = "record decode failed at row " + std::to_string(out.rows);
      return false;
    }
  }
  return true;
}

// Append `src` onto `dst` preserving row order (per-row ragged offsets are
// rebased). `src` is left in a moved-from state.
void merge_output(Output& dst, Output& src) {
  auto app = [](auto& a, auto& b) {
    a.insert(a.end(), b.begin(), b.end());
    b.clear();
    b.shrink_to_fit();
  };
  app(dst.labels, src.labels);
  app(dst.has_label, src.has_label);
  app(dst.offsets, src.offsets);
  app(dst.weights, src.weights);
  app(dst.feat_counts, src.feat_counts);
  for (size_t s = 0; s < dst.feat_indices.size(); ++s)
    app(dst.feat_indices[s], src.feat_indices[s]);
  app(dst.feat_values, src.feat_values);
  auto app_col = [&](EntityCol& d, EntityCol& s) {
    uint64_t base = d.blob.size();
    app(d.blob, s.blob);
    for (size_t i = 1; i < s.offsets.size(); ++i)
      d.offsets.push_back(base + s.offsets[i]);
    app(d.present, s.present);
  };
  for (size_t e = 0; e < dst.entities.size(); ++e)
    app_col(dst.entities[e], src.entities[e]);
  app_col(dst.uid, src.uid);
  app(dst.uid_kind, src.uid_kind);
  dst.rows += src.rows;
}

// A worker-local Output mirroring the main handle's column structure.
Output make_like(const Output& main_out) {
  Output out;
  out.uid.offsets.push_back(0);
  out.feat_indices.resize(main_out.feat_indices.size());
  for (const auto& col : main_out.entities) {
    EntityCol c;
    c.key = col.key;
    c.offsets.push_back(0);
    out.entities.push_back(std::move(c));
  }
  return out;
}

}  // namespace

extern "C" {

// Decode one Avro container file. `block_payloads` are handed in by Python
// (which parses the container header/sync framing and the schema — framing
// is cheap; per-record decode is the hot part):
//   avd_create(entity_keys_blob, key_lens, n_keys) -> Output*
//   avd_decode_block(out, data, len, codec, n_records, prog, prog_len,
//                    fis_handle, hash_dim) -> 0 on success
//   getters + avd_free
void* avd_create(const char* keys_blob, const uint32_t* key_lens,
                 uint32_t n_keys, uint32_t n_shards) {
  Output* out = new Output();
  out->uid.offsets.push_back(0);
  out->feat_indices.resize(n_shards ? n_shards : 1);
  size_t at = 0;
  for (uint32_t i = 0; i < n_keys; ++i) {
    EntityCol col;
    col.key.assign(keys_blob + at, key_lens[i]);
    col.offsets.push_back(0);
    at += key_lens[i];
    out->entities.push_back(std::move(col));
  }
  return out;
}

// One resolver triple (fis handle, lookup fn, hash_dim) per feature shard;
// the record walk happens once, feature resolution fans out to all shards.
int avd_decode_block(void* handle, const uint8_t* data, uint64_t len,
                     int codec_deflate, int64_t n_records, const uint8_t* prog,
                     uint32_t prog_len, void* const* fis_handles,
                     void* const* fis_lookup_ptrs, const int64_t* hash_dims,
                     uint32_t n_shards) {
  Output* out = static_cast<Output*>(handle);
  if (n_shards != out->feat_indices.size()) {
    out->error = "shard count mismatch vs avd_create";
    return -3;
  }
  std::vector<FeatureResolver> frs;
  for (uint32_t s = 0; s < n_shards; ++s) {
    frs.push_back(FeatureResolver{
        fis_handles[s],
        reinterpret_cast<fis_lookup_fn>(fis_lookup_ptrs[s]),
        hash_dims[s], '\x01'});
  }
  return decode_one_block(*out, data, static_cast<size_t>(len),
                          codec_deflate != 0, n_records, prog, prog_len, frs)
             ? 0
             : -2;
}

// Parallel variant: container blocks are independent by construction (each
// carries its own record count and compressed payload), so N threads decode
// disjoint blocks into per-block staging Outputs which are then concatenated
// in block order — byte-identical results to the serial path, ~cores x the
// single-thread throughput (SURVEY.md §3.3: the reference amortizes decode
// across 256 Spark executors).
// Resolver state is shared read-only (the feature index store is an mmap'd
// hash table; FNV hashing is stateless), so no locks are needed.
int avd_decode_blocks_mt(void* handle, const uint8_t* const* datas,
                         const uint64_t* lens, const int64_t* counts,
                         uint64_t n_blocks, int codec_deflate,
                         const uint8_t* prog, uint32_t prog_len,
                         void* const* fis_handles,
                         void* const* fis_lookup_ptrs,
                         const int64_t* hash_dims, uint32_t n_shards,
                         uint32_t n_threads) {
  Output* out = static_cast<Output*>(handle);
  if (n_shards != out->feat_indices.size()) {
    out->error = "shard count mismatch vs avd_create";
    return -3;
  }
  std::vector<FeatureResolver> frs;
  for (uint32_t s = 0; s < n_shards; ++s) {
    frs.push_back(FeatureResolver{
        fis_handles[s],
        reinterpret_cast<fis_lookup_fn>(fis_lookup_ptrs[s]),
        hash_dims[s], '\x01'});
  }
  if (n_threads <= 1 || n_blocks <= 1) {
    for (uint64_t b = 0; b < n_blocks; ++b) {
      if (!decode_one_block(*out, datas[b], static_cast<size_t>(lens[b]),
                            codec_deflate != 0, counts[b], prog, prog_len,
                            frs))
        return -2;
    }
    return 0;
  }

  std::vector<Output> staging;
  staging.reserve(n_blocks);
  for (uint64_t b = 0; b < n_blocks; ++b) staging.push_back(make_like(*out));
  std::atomic<uint64_t> next{0};
  std::atomic<bool> failed{false};
  uint32_t workers = static_cast<uint32_t>(
      n_threads < n_blocks ? n_threads : n_blocks);
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (uint32_t t = 0; t < workers; ++t) {
    threads.emplace_back([&]() {
      while (!failed.load(std::memory_order_relaxed)) {
        uint64_t b = next.fetch_add(1, std::memory_order_relaxed);
        if (b >= n_blocks) break;
        if (!decode_one_block(staging[b], datas[b],
                              static_cast<size_t>(lens[b]),
                              codec_deflate != 0, counts[b], prog, prog_len,
                              frs))
          failed.store(true, std::memory_order_relaxed);
      }
    });
  }
  for (auto& th : threads) th.join();
  if (failed.load()) {
    for (uint64_t b = 0; b < n_blocks; ++b) {
      if (!staging[b].error.empty()) {
        out->error = "block " + std::to_string(b) + ": " + staging[b].error;
        break;
      }
    }
    return -2;
  }
  for (uint64_t b = 0; b < n_blocks; ++b) merge_output(*out, staging[b]);
  return 0;
}

uint64_t avd_rows(void* handle) { return static_cast<Output*>(handle)->rows; }
uint64_t avd_nnz(void* handle) {
  return static_cast<Output*>(handle)->feat_values.size();
}
const double* avd_labels(void* handle) {
  return static_cast<Output*>(handle)->labels.data();
}
const uint8_t* avd_has_label(void* handle) {
  return static_cast<Output*>(handle)->has_label.data();
}
const double* avd_offsets(void* handle) {
  return static_cast<Output*>(handle)->offsets.data();
}
const double* avd_weights(void* handle) {
  return static_cast<Output*>(handle)->weights.data();
}
const int32_t* avd_feat_counts(void* handle) {
  return static_cast<Output*>(handle)->feat_counts.data();
}
const int32_t* avd_feat_indices(void* handle, uint32_t shard) {
  Output* out = static_cast<Output*>(handle);
  if (shard >= out->feat_indices.size()) return nullptr;
  return out->feat_indices[shard].data();
}
const double* avd_feat_values(void* handle) {
  return static_cast<Output*>(handle)->feat_values.data();
}
const char* avd_error(void* handle) {
  return static_cast<Output*>(handle)->error.c_str();
}
int avd_uid(void* handle, const uint8_t** blob, const uint64_t** offsets,
            const uint8_t** kinds, uint64_t* n) {
  Output* out = static_cast<Output*>(handle);
  *blob = out->uid.blob.data();
  *offsets = out->uid.offsets.data();
  *kinds = out->uid_kind.data();
  *n = out->uid_kind.size();
  return 0;
}
int avd_entity_col(void* handle, uint32_t col, const uint8_t** blob,
                   const uint64_t** offsets, const uint8_t** present,
                   uint64_t* n) {
  Output* out = static_cast<Output*>(handle);
  if (col >= out->entities.size()) return -1;
  EntityCol& e = out->entities[col];
  *blob = e.blob.data();
  *offsets = e.offsets.data();
  *present = e.present.data();
  *n = e.offsets.size() - 1;
  return 0;
}
void avd_free(void* handle) { delete static_cast<Output*>(handle); }

}  // extern "C"
