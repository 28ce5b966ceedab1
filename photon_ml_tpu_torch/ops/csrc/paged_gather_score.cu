// Per-row random-effect scores against a device-resident paged entity table,
// for Hopper (sm_90a).
//
// Replaces photon_ml_tpu/ops/pallas_kernels.py::paged_gather_score
// (:142-164), which the JAX package writes as plain jnp (one flat
// table_gather over slot * D + index, a row sum and a select; XLA lowers
// it). It computes, for every row i of a batch,
//
//   out[i] = sum over j in [0, k) of table[slots[i], idx[i, j]] * val[i, j]
//
// in the table's type, and out[i] = 0 exactly, by selection, wherever
// slots[i] < 0 (the entity has no resident row: the fixed-effect-only
// fallback), whatever the table holds. The offset slot * D + idx is formed
// in 64 bits; the JAX reference forms it in int32, which wraps once
// S * D >= 2^31 (a 4,096-slot table of 2^16 columns is 2^28 elements, but
// 2^15 slots are not). Where the reference's offsets fit, the two compute
// the same function.
//
// What bounds it. Per row it reads one slot id, k index ids and k values
// and writes one score; per nonzero it gathers one table element at a
// random column of its row, and each such element is its own 32-byte
// sector of device memory. At the serving shapes (B = 32 to 4,096 rows,
// k = 40 or the session's padded 64, D = 2^16 + 1) the bytes are a
// fraction of a microsecond and the launch and two round trips to device
// memory are the time; only a batch of tens of thousands of rows (a whole
// validation set) moves enough bytes to be held to the bound.
//
// What the design does about it.
// - A group of G lanes scores one row, and a warp 32 / G rows (G = 8 for
//   k <= 64, 16 for k <= 128, 32 beyond: group_lanes below). Lane l owns
//   the contiguous chunk [l * c, min((l + 1) * c, k)) of the row's entries,
//   c = ceil(k / G) (chunk_len below): k = 40 is 5 entries a lane, the
//   served k = 64 is 8. A block of 256 threads scores 256 / G rows, so
//   B = 32,768 at k = 40 is 1,024 blocks: about one wave of the card's
//   132 SMs at 8 blocks each.
// - Every load that does not depend on another is issued first: the row's
//   slot, the lane's indices and values (16-byte loads where the lane's
//   run of 8 is 16-byte aligned, scalar loads otherwise) and, in the
//   pointer entry, the table's address. Only then the table gathers, all
//   of a lane's (up to 8 at a time) before its first add: two trips to
//   device memory, not three. A row whose slot is < 0 gathers nothing.
// - A fixed sum order that depends on k alone: each lane adds its chunk's
//   products in index order from 0; the G partial sums are then combined
//   by an xor butterfly over the group (offsets G/2, ..., 1), whose
//   pairing is the tree "first half plus second half" repeated, since
//   a + b and b + a round alike. The multiplies and adds are spelled
//   __fmul_rn / __fadd_rn (__dmul_rn / __dadd_rn) so that no contraction
//   into an fma changes a rounding. So the score is independent of the
//   timing, the slot, the page and the table's history, and the plain
//   twin ops/kernels.py::paged_gather_score_ordered_plain, which forms the
//   same chunks and the same tree, gives the kernel's bits. The library's
//   loader checks group_lanes and chunk_len against that twin.
// - No atomics, no shared memory, nothing allocated: the wrapper allocates
//   the B outputs.
//
// A second entry point, photon_paged_gather_score_at_*, reads the table's
// address from device memory when it runs instead of taking it as an
// argument. The scoring session captures each batch rung into a CUDA graph
// once; a graph bakes its kernels' arguments in, while the paged table gives
// its buffer a new address on every copy-on-write install. The session
// writes the address of the snapshot it scores into that slot, in stream
// order, before each replay, so a replay scores the snapshot of its own
// batch and no install forces a new capture. Every lane loads the address
// with its slot (one 8-byte transaction a warp); the arithmetic is the
// first entry's.
//
// Two timing-only entries stay beside them, launched by name by
// chip_smoke.py and never on a path: photon_paged_gather_score_prev_* (and
// _prev_at_*), the previous design (one warp per row, the products summed
// in index order through shuffles), and photon_paged_empty, a kernel that
// does nothing on the same grid, the floor no launch beats.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kStep = 8;       // entries a lane loads before it gathers
constexpr unsigned kFull = 0xffffffffu;

// The order's two rules, in one place: lanes per row and entries per lane.
__host__ __device__ constexpr int group_lanes(long long k) {
  return k <= 64 ? 8 : k <= 128 ? 16 : 32;
}
__host__ __device__ constexpr long long chunk_len(long long k) {
  return (k + group_lanes(k) - 1) / group_lanes(k);
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// kStep values from ``p`` into ``v``: 16-byte loads.
__device__ __forceinline__ void load_step(const int* p, int* v) {
#pragma unroll
  for (int q = 0; q < kStep; q += 4) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p + q));
    v[q] = x.x, v[q + 1] = x.y, v[q + 2] = x.z, v[q + 3] = x.w;
  }
}
__device__ __forceinline__ void load_step(const float* p, float* v) {
#pragma unroll
  for (int q = 0; q < kStep; q += 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p + q));
    v[q] = x.x, v[q + 1] = x.y, v[q + 2] = x.z, v[q + 3] = x.w;
  }
}
__device__ __forceinline__ void load_step(const double* p, double* v) {
#pragma unroll
  for (int q = 0; q < kStep; q += 2) {
    const double2 x = __ldg(reinterpret_cast<const double2*>(p + q));
    v[q] = x.x, v[q + 1] = x.y;
  }
}

// Group g of G lanes scores row blockIdx.x * (kThreads / G) + g. With AT
// the table's address is read from ``table_arg`` (8 bytes on the card).
template <typename T, int G, bool AT>
__global__ void __launch_bounds__(kThreads)
    paged_gather_score_kernel(const void* __restrict__ table_arg,
                              const int* __restrict__ slots,
                              const int* __restrict__ idx,
                              const T* __restrict__ val, T* __restrict__ out,
                              long long b, long long k, long long dim) {
  const int lane = threadIdx.x & (G - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  const bool live = row < b;  // a dead group still joins the shuffles
  // trip 1: the table's address, the slot, the lane's indices and values
  const T* table = AT ? *static_cast<const T* const*>(table_arg)
                      : static_cast<const T*>(table_arg);
  const int slot = live ? __ldg(slots + row) : -1;
  const long long c = chunk_len(k);
  const long long first = lane * c;
  const long long n = live ? max(0LL, min(c, k - first)) : 0;
  const int* irow = idx + row * k + first;
  const T* vrow = val + row * k + first;
  const T* trow = table + static_cast<long long>(slot) * dim;
  T acc = T(0);
  for (long long j0 = 0; j0 < n; j0 += kStep) {
    const long long m = min(static_cast<long long>(kStep), n - j0);
    int ix[kStep];
    T vx[kStep];
    if (m == kStep && aligned16(irow + j0) && aligned16(vrow + j0)) {
      load_step(irow + j0, ix);
      load_step(vrow + j0, vx);
    } else {
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        ix[u] = u < m ? __ldg(irow + j0 + u) : 0;
        vx[u] = u < m ? __ldg(vrow + j0 + u) : T(0);
      }
    }
    if (slot >= 0) {
      // trip 2: every gather of the step before the first add
      T tv[kStep];
#pragma unroll
      for (int u = 0; u < kStep; ++u) tv[u] = u < m ? __ldg(trow + ix[u]) : T(0);
#pragma unroll
      for (int u = 0; u < kStep; ++u)
        if (u < m) acc = add_rn(acc, mul_rn(tv[u], vx[u]));
    }
  }
#pragma unroll
  for (int off = G / 2; off >= 1; off >>= 1)
    acc = add_rn(acc, __shfl_xor_sync(kFull, acc, off, G));
  if (live && lane == 0) out[row] = slot < 0 ? T(0) : acc;
}

template <typename T, bool AT>
int launch(const void* table_arg, const void* slots, const void* idx,
           const void* val, void* out, long long b, long long k,
           long long dim, void* stream) {
  if (b == 0) return 0;
  const int g = group_lanes(k);
  const dim3 grid(static_cast<unsigned>((b * g + kThreads - 1) / kThreads));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* sl = static_cast<const int*>(slots);
  const auto* ix = static_cast<const int*>(idx);
  const auto* vl = static_cast<const T*>(val);
  auto* o = static_cast<T*>(out);
  if (g == 8)
    paged_gather_score_kernel<T, 8, AT>
        <<<grid, kThreads, 0, s>>>(table_arg, sl, ix, vl, o, b, k, dim);
  else if (g == 16)
    paged_gather_score_kernel<T, 16, AT>
        <<<grid, kThreads, 0, s>>>(table_arg, sl, ix, vl, o, b, k, dim);
  else
    paged_gather_score_kernel<T, 32, AT>
        <<<grid, kThreads, 0, s>>>(table_arg, sl, ix, vl, o, b, k, dim);
  return static_cast<int>(cudaGetLastError());
}

// -- the previous design (timing only) ----------------------------------
constexpr int kPrevWarps = 8;  // rows per block

template <typename T, bool AT>
__global__ void __launch_bounds__(kPrevWarps * 32)
    paged_gather_score_prev_kernel(const void* __restrict__ table_arg,
                                   const int* __restrict__ slots,
                                   const int* __restrict__ idx,
                                   const T* __restrict__ val,
                                   T* __restrict__ out, long long b, int k,
                                   long long dim) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kPrevWarps + (threadIdx.x >> 5);
  if (row >= b) return;  // the whole warp leaves together
  const int slot = __ldg(slots + row);
  if (slot < 0) {  // uniform across the warp
    if (lane == 0) out[row] = T(0);
    return;
  }
  const T* table = AT ? *static_cast<const T* const*>(table_arg)
                      : static_cast<const T*>(table_arg);
  const T* trow = table + static_cast<long long>(slot) * dim;
  const int* irow = idx + row * k;
  const T* vrow = val + row * k;
  T acc = T(0);
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    T p = T(0);
    if (j < k) p = mul_rn(__ldg(trow + __ldg(irow + j)), __ldg(vrow + j));
    const int n = min(32, k - j0);
    for (int t = 0; t < n; ++t) acc = add_rn(acc, __shfl_sync(kFull, p, t));
  }
  if (lane == 0) out[row] = acc;
}

template <typename T, bool AT>
int launch_prev(const void* table_arg, const void* slots, const void* idx,
                const void* val, void* out, long long b, long long k,
                long long dim, void* stream) {
  if (b == 0) return 0;
  const dim3 grid(static_cast<unsigned>((b + kPrevWarps - 1) / kPrevWarps));
  paged_gather_score_prev_kernel<T, AT>
      <<<grid, kPrevWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          table_arg, static_cast<const int*>(slots),
          static_cast<const int*>(idx), static_cast<const T*>(val),
          static_cast<T*>(out), b, static_cast<int>(k), dim);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kThreads)
    paged_empty_kernel(const void*, const int*, const int*, const float*,
                       float*, long long, long long, long long) {}

}  // namespace

// Plain C interface, loaded with ctypes. ``table`` is [S, dim] row-major,
// ``val`` [b, k] and ``out`` [b], all float32 (photon_paged_gather_score_f32)
// or float64 (_f64); ``slots`` [b] and ``idx`` [b, k] are int32, every
// nonnegative slot below S and every index in [0, dim); ``idx`` and ``val``
// need 4- (8-) byte alignment only. Launches on ``stream`` without
// synchronising (nothing for b = 0) and returns cudaGetLastError().
extern "C" int photon_paged_gather_score_f32(const void* table,
                                             const void* slots,
                                             const void* idx, const void* val,
                                             void* out, long long b,
                                             long long k, long long dim,
                                             void* stream) {
  return launch<float, false>(table, slots, idx, val, out, b, k, dim, stream);
}

extern "C" int photon_paged_gather_score_f64(const void* table,
                                             const void* slots,
                                             const void* idx, const void* val,
                                             void* out, long long b,
                                             long long k, long long dim,
                                             void* stream) {
  return launch<double, false>(table, slots, idx, val, out, b, k, dim,
                               stream);
}

// The same, with the table's address read when the kernel runs from the
// 8 bytes at ``table_at`` (device memory), which must then name a table of
// ``dim`` columns of the entry's type that lives until the kernel is done.
extern "C" int photon_paged_gather_score_at_f32(const void* table_at,
                                                const void* slots,
                                                const void* idx,
                                                const void* val, void* out,
                                                long long b, long long k,
                                                long long dim, void* stream) {
  return launch<float, true>(table_at, slots, idx, val, out, b, k, dim,
                             stream);
}

extern "C" int photon_paged_gather_score_at_f64(const void* table_at,
                                                const void* slots,
                                                const void* idx,
                                                const void* val, void* out,
                                                long long b, long long k,
                                                long long dim, void* stream) {
  return launch<double, true>(table_at, slots, idx, val, out, b, k, dim,
                              stream);
}

// The order's rules, for the loader to hold against the plain twin.
extern "C" int photon_paged_lanes(long long k) { return group_lanes(k); }
extern "C" long long photon_paged_chunk(long long k) { return chunk_len(k); }

// Timing only: the previous design, with the four entries' arguments.
extern "C" int photon_paged_gather_score_prev_f32(
    const void* table, const void* slots, const void* idx, const void* val,
    void* out, long long b, long long k, long long dim, void* stream) {
  return launch_prev<float, false>(table, slots, idx, val, out, b, k, dim,
                                   stream);
}

extern "C" int photon_paged_gather_score_prev_f64(
    const void* table, const void* slots, const void* idx, const void* val,
    void* out, long long b, long long k, long long dim, void* stream) {
  return launch_prev<double, false>(table, slots, idx, val, out, b, k, dim,
                                    stream);
}

extern "C" int photon_paged_gather_score_prev_at_f32(
    const void* table_at, const void* slots, const void* idx,
    const void* val, void* out, long long b, long long k, long long dim,
    void* stream) {
  return launch_prev<float, true>(table_at, slots, idx, val, out, b, k, dim,
                                  stream);
}

extern "C" int photon_paged_gather_score_prev_at_f64(
    const void* table_at, const void* slots, const void* idx,
    const void* val, void* out, long long b, long long k, long long dim,
    void* stream) {
  return launch_prev<double, true>(table_at, slots, idx, val, out, b, k, dim,
                                   stream);
}

// Timing only: a kernel with an empty body on the grid and block the new
// design launches for (b, k), and the same arguments.
extern "C" int photon_paged_empty(long long b, long long k, void* stream) {
  if (b == 0) return 0;
  const dim3 grid(static_cast<unsigned>(
      (b * group_lanes(k) + kThreads - 1) / kThreads));
  paged_empty_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nullptr, nullptr, nullptr, nullptr, nullptr, b, k, 0);
  return static_cast<int>(cudaGetLastError());
}
