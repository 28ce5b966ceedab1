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
// in the table's type, with the k products summed in index order from 0,
// and out[i] = 0 exactly, by selection, wherever slots[i] < 0 (the entity
// has no resident row: the fixed-effect-only fallback), whatever the table
// holds. The offset slot * D + idx is formed in 64 bits; the JAX reference
// forms it in int32, which wraps once S * D >= 2^31 (a 4,096-slot table of
// 2^16 columns is 2^28 elements, but 2^15 slots are not). Where the
// reference's offsets fit, the two compute the same function.
//
// What bounds it. Per row it reads one slot id, k index ids and k values
// and writes one score; per nonzero it gathers one table element at a
// random column of its row. At the serving shapes (B = 32 or 4,096 rows,
// k = 39, D = 2^16) the table is 1 GB but a batch touches B * k elements of
// it: about 1.3 MB of the table at B = 4,096, each element fetched as its
// own 32-byte sector. The bytes bound is a few microseconds; at B = 32 the
// launch (a few microseconds of host and device latency) dominates.
//
// What the design does about it.
// - One warp per row: lane j loads idx[i, j] and val[i, j] (consecutive
//   addresses across the warp, so each index and value row is read
//   coalesced, once) and issues its gather of the table before any lane
//   adds, so a row's k gathers are in flight together; B = 4,096 rows are
//   4,096 warps, enough to fill the card.
// - The sum then walks the products in index order: every lane adds the
//   product of lane t, broadcast by __shfl_sync, for t = 0, 1, ..., so the
//   sum is ((0 + p0) + p1) + ... whatever the warp's timing, and the plain
//   version (ops/kernels.py::paged_gather_score_plain) differs from it only
//   by its own summation order. The multiplies and adds are spelled
//   __fmul_rn / __fadd_rn (__dmul_rn / __dadd_rn) so that no contraction
//   into an fma changes a rounding.
// - The slot test is uniform across the warp, so a row without a resident
//   entity reads nothing of the table.
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
// batch and no install forces a new capture. The address is loaded only by
// rows with a resident entity; the arithmetic is the first entry's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

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

// One warp scores row ``row`` of the batch; ``table_at`` is where the
// table's address is read from (the first entry passes its own argument).
template <typename T>
__device__ __forceinline__ void score_row(const T* const* table_at,
                                          const int* __restrict__ slots,
                                          const int* __restrict__ idx,
                                          const T* __restrict__ val,
                                          T* __restrict__ out, long long b,
                                          int k, long long dim) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= b) return;  // the whole warp leaves together
  const int slot = __ldg(slots + row);
  if (slot < 0) {  // uniform across the warp
    if (lane == 0) out[row] = T(0);
    return;
  }
  const T* trow = *table_at + static_cast<long long>(slot) * dim;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_gather_score_kernel(const T* __restrict__ table,
                              const int* __restrict__ slots,
                              const int* __restrict__ idx,
                              const T* __restrict__ val, T* __restrict__ out,
                              long long b, int k, long long dim) {
  const T* base = table;
  score_row<T>(&base, slots, idx, val, out, b, k, dim);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_gather_score_at_kernel(const T* const* __restrict__ table_at,
                                 const int* __restrict__ slots,
                                 const int* __restrict__ idx,
                                 const T* __restrict__ val,
                                 T* __restrict__ out, long long b, int k,
                                 long long dim) {
  score_row<T>(table_at, slots, idx, val, out, b, k, dim);
}

template <typename T>
int launch(const void* table, const void* slots, const void* idx,
           const void* val, void* out, long long b, long long k,
           long long dim, void* stream) {
  if (b == 0) return 0;
  const dim3 grid(static_cast<unsigned>((b + kWarps - 1) / kWarps));
  paged_gather_score_kernel<T>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(table), static_cast<const int*>(slots),
          static_cast<const int*>(idx), static_cast<const T*>(val),
          static_cast<T*>(out), b, static_cast<int>(k), dim);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_at(const void* table_at, const void* slots, const void* idx,
              const void* val, void* out, long long b, long long k,
              long long dim, void* stream) {
  if (b == 0) return 0;
  const dim3 grid(static_cast<unsigned>((b + kWarps - 1) / kWarps));
  paged_gather_score_at_kernel<T>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T* const*>(table_at),
          static_cast<const int*>(slots), static_cast<const int*>(idx),
          static_cast<const T*>(val), static_cast<T*>(out), b,
          static_cast<int>(k), dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. ``table`` is [S, dim] row-major,
// ``val`` [b, k] and ``out`` [b], all float32 (photon_paged_gather_score_f32)
// or float64 (_f64); ``slots`` [b] and ``idx`` [b, k] are int32, every
// nonnegative slot below S and every index in [0, dim). Launches on
// ``stream`` without synchronising (nothing for b = 0) and returns
// cudaGetLastError().
extern "C" int photon_paged_gather_score_f32(const void* table,
                                             const void* slots,
                                             const void* idx, const void* val,
                                             void* out, long long b,
                                             long long k, long long dim,
                                             void* stream) {
  return launch<float>(table, slots, idx, val, out, b, k, dim, stream);
}

extern "C" int photon_paged_gather_score_f64(const void* table,
                                             const void* slots,
                                             const void* idx, const void* val,
                                             void* out, long long b,
                                             long long k, long long dim,
                                             void* stream) {
  return launch<double>(table, slots, idx, val, out, b, k, dim, stream);
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
  return launch_at<float>(table_at, slots, idx, val, out, b, k, dim, stream);
}

extern "C" int photon_paged_gather_score_at_f64(const void* table_at,
                                                const void* slots,
                                                const void* idx,
                                                const void* val, void* out,
                                                long long b, long long k,
                                                long long dim, void* stream) {
  return launch_at<double>(table_at, slots, idx, val, out, b, k, dim,
                           stream);
}
