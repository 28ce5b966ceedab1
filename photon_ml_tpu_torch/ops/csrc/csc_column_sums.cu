// X^T d from the column-sorted view in one pass, for Hopper (sm_90a).
//
// Replaces the three steps of the TPU route
// photon_ml_tpu/ops/pallas_kernels.py::csc_transpose_apply_pallas
// (:168-181): the gather d[rows] (:177), the Pallas kernel _mps_kernel
// (:34, a tile-local prefix of values * d_sorted) and
// types.blocked_boundary_combine (the column sums from those prefixes). It
// computes, for every column j,
//
//   out[j] = sum over p in [col_starts[j], col_starts[j+1]) of
//            values[p] * d[rows[p]]          (d[rows[p]] for implicit ones)
//
// with each product formed exactly in float64 (a float32 product is exact
// there), summed in float64 and rounded once to d's type; an empty column
// gives exactly 0. No difference of prefixes is taken, so a column's error
// is its own terms' float64 rounding plus that one rounding, whatever nnz.
//
// What bounds it. Per nonzero it reads a 4-byte row id (and a value) once,
// and gathers d[row] at random: on the main path (nnz = 2^21 * 39, d of
// 2^21 float32) the bytes are 337.6 MB, about 0.10 ms at 3.35 TB/s, but each
// gather moves a 32-byte L2 sector for 4 useful bytes, about 2.6 GB of L2
// traffic. d (8 MB) stays in the 50 MB L2, so the gathers' sectors, not
// device memory, set the pace.
//
// What the design does about it.
// - Nothing nnz-long is written: no d_sorted, no int64 copy of the row ids,
//   no prefix. The outputs are dim sums plus O(grid) float64 partials.
// - Work is cut by nonzeros: block b owns the range [b * kRange,
//   (b + 1) * kRange) of the sorted nonzeros, so every path's nnz fills the
//   132 SMs (a 655,360-nonzero chunk gives 320 blocks). Each thread loads
//   kPerThread consecutive row ids (and values) with 16-byte vector loads
//   marked streaming (evict first, so that d keeps its place in L2),
//   issues all its gathers of d before it uses any of them, and leaves the
//   exact float64 products in shared memory.
// - While the gathers are in flight, warps 0 and 1 find the block's first
//   and last column by a 32-way search of col_starts.
// - Each thread sums its own run in order, from 0, cutting it where a
//   column starts (the block marks those positions in shared memory first,
//   and writes 0 for the empty columns): sub-pieces of at most kPerThread
//   terms, whose sums it leaves in shared memory at their first position.
// - A column's piece in a range (the part of its nonzeros in the range) is
//   then one thread's in-order sum of its sub-pieces, one every kPerThread
//   positions, kPerThread times fewer dependent adds than its terms. A
//   column whose nonzeros all lie in the range is written there.
//   Otherwise its first piece is the range's tail, and every later range
//   it reaches holds one more piece at its head.
// - A second small launch, one thread per range whose tail runs on, adds
//   that column's tail and the heads of the ranges it covers, in range
//   order, however many ranges the column spans (real click logs have
//   power-law columns).
// - So every sum is taken in order at three levels, cut at the column
//   starts and at every multiple of kPerThread and of kRange: the plain
//   version (ops/kernels.py::csc_column_sums_plain) sums in exactly that
//   order and gives the same bits. No floating-point atomics anywhere, and
//   the multiplies and adds are spelled __dmul_rn / __dadd_rn so that no
//   contraction into an fma changes a rounding.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kRange = kThreads * kPerThread;  // nonzeros per block
constexpr unsigned kFull = 0xffffffffu;

// The first j in [0, n] with cs[j] >= key, for a non-decreasing cs with
// cs[n] >= key; each of the warp's 32 lanes probes one point per round.
__device__ int warp_lower_bound(const int* __restrict__ cs, int n, int key,
                                int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const bool ge = p >= hi || __ldg(cs + p) >= key;
    const unsigned m = __ballot_sync(kFull, ge);
    const int f = m ? __ffs(m) - 1 : 32;  // first probe at or past the key
    const int new_hi = f < 32 ? min(lo + f * step, hi) : hi;
    lo = f > 0 ? lo + (f - 1) * step + 1 : lo;
    hi = new_hi;
  }
  return lo;
}

template <typename T>
__device__ __forceinline__ void load_run(const T* p, T (&o)[kPerThread]);

template <>
__device__ __forceinline__ void load_run(const float* p,
                                         float (&o)[kPerThread]) {
#pragma unroll
  for (int i = 0; i < kPerThread; i += 4) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p + i));
    o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
  }
}

template <>
__device__ __forceinline__ void load_run(const double* p,
                                         double (&o)[kPerThread]) {
#pragma unroll
  for (int i = 0; i < kPerThread; i += 2) {
    const double2 v = __ldcs(reinterpret_cast<const double2*>(p + i));
    o[i] = v.x; o[i + 1] = v.y;
  }
}

__device__ __forceinline__ void load_rows(const int* p,
                                          int (&o)[kPerThread]) {
#pragma unroll
  for (int i = 0; i < kPerThread; i += 4) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p + i));
    o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
  }
}

// The in-order sum, from 0, of the sub-piece sums of the piece [a, z): one
// at a, then one at each multiple of kPerThread after it.
__device__ __forceinline__ double piece_sum(const double* sub, int a, int z) {
  double acc = __dadd_rn(0.0, sub[a]);
  for (int p = (a / kPerThread + 1) * kPerThread; p < z; p += kPerThread) {
    acc = __dadd_rn(acc, sub[p]);
  }
  return acc;
}

template <typename T, bool kHasValues>
__global__ void __launch_bounds__(kThreads)
column_sums_kernel(const T* __restrict__ values, const int* __restrict__ rows,
                   const int* __restrict__ cs, const T* __restrict__ d,
                   T* __restrict__ out, double* __restrict__ head,
                   double* __restrict__ tail, int* __restrict__ span_col,
                   int nnz, int dim) {
  __shared__ double sub[kRange];  // sub-piece sums, at their first position
  __shared__ unsigned char starts[kRange];  // 1 where a column starts
  __shared__ int bounds[2];
  __shared__ int span;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const bool last = b == static_cast<int>(gridDim.x) - 1;
  const int s = b * kRange;
  const int e = last ? nnz : s + kRange;
  const int n_local = e - s;  // 0 only when nnz == 0
  const int base = tid * kPerThread;

  // 1. this thread's row ids and values, then every gather of d
  int r[kPerThread];
  T v[kPerThread] = {};
  if (base + kPerThread <= n_local) {
    load_rows(rows + s + base, r);
    if constexpr (kHasValues) load_run(values + s + base, v);
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const bool in = base + i < n_local;
      r[i] = in ? __ldcs(rows + s + base + i) : 0;
      if constexpr (kHasValues) v[i] = in ? __ldcs(values + s + base + i) : T(0);
    }
  }
  T g[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    g[i] = base + i < n_local ? __ldg(d + r[i]) : T(0);
  }

  // 2. the block's columns: those starting in [s, e) (for the last block,
  // every column from the first one starting at or after s)
  if (warp == 0) {
    const int lo = b == 0 ? 0 : warp_lower_bound(cs, dim, s, lane);
    if (lane == 0) bounds[0] = lo;
  } else if (warp == 1) {
    const int hi = last ? dim : warp_lower_bound(cs, dim, e, lane);
    if (lane == 0) bounds[1] = hi;
  }
  if (tid == 0) span = -1;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) starts[base + i] = 0;
  __syncthreads();
  const int lo = bounds[0], hi = bounds[1];
  for (int j = lo + tid; j < hi; j += kThreads) {
    const int a = __ldg(cs + j), z = __ldg(cs + j + 1);
    if (z > a) {
      starts[a - s] = 1;
    } else {
      out[j] = T(0);
    }
  }
  __syncthreads();

  // 3. this thread's run, cut where a column starts
  if (base < n_local) {
    int first = base;
    double acc = 0.0;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (base + i < n_local) {
        if (i > 0 && starts[base + i]) {
          sub[first] = acc;
          first = base + i;
          acc = 0.0;
        }
        double x = static_cast<double>(g[i]);
        if constexpr (kHasValues) x = __dmul_rn(x, static_cast<double>(v[i]));
        acc = __dadd_rn(acc, x);
      }
    }
    sub[first] = acc;
  }
  __syncthreads();

  // 4. each column starting here: its piece, whole or the range's tail
  for (int j = lo + tid; j < hi; j += kThreads) {
    const int a = __ldg(cs + j), z = __ldg(cs + j + 1);
    if (z == a) continue;
    const double acc = piece_sum(sub, a - s, min(z, e) - s);
    if (z <= e) {
      out[j] = static_cast<T>(acc);
    } else {
      tail[b] = acc;  // only the range's last column can run on
      span = j;
    }
  }
  // 5. the head: the piece of a column carried in from earlier ranges
  if (tid == kThreads - 1) {
    const int first = lo < dim ? min(__ldg(cs + lo), e) : e;
    if (first > s) head[b] = piece_sum(sub, 0, first - s);
  }
  __syncthreads();
  if (tid == 0) span_col[b] = span;
}

// One thread per range: if the range's last column runs on, its sum is the
// range's tail plus the heads of the ranges up to the one it ends in, in
// order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
span_sums_kernel(const int* __restrict__ cs, const double* __restrict__ head,
                 const double* __restrict__ tail,
                 const int* __restrict__ span_col, T* __restrict__ out,
                 int n_ranges) {
  const int b0 = blockIdx.x * kThreads + threadIdx.x;
  if (b0 >= n_ranges) return;
  const int j = span_col[b0];
  if (j < 0) return;
  const int b1 = (__ldg(cs + j + 1) - 1) / kRange;  // the range it ends in
  double acc = tail[b0];
#pragma unroll 4
  for (int q = b0 + 1; q <= b1; ++q) acc = __dadd_rn(acc, head[q]);
  out[j] = static_cast<T>(acc);
}

template <typename T>
int launch(const void* values, const void* rows, const void* col_starts,
           const void* d, void* out, void* head, void* tail, void* span_col,
           long long nnz, long long dim, long long n_ranges, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_ranges));
  const int* rw = static_cast<const int*>(rows);
  const int* cs = static_cast<const int*>(col_starts);
  const T* dd = static_cast<const T*>(d);
  T* o = static_cast<T*>(out);
  double* hd = static_cast<double*>(head);
  double* tl = static_cast<double*>(tail);
  int* sp = static_cast<int*>(span_col);
  if (values != nullptr) {
    column_sums_kernel<T, true><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(values), rw, cs, dd, o, hd, tl, sp,
        static_cast<int>(nnz), static_cast<int>(dim));
  } else {
    column_sums_kernel<T, false><<<grid, kThreads, 0, st>>>(
        nullptr, rw, cs, dd, o, hd, tl, sp, static_cast<int>(nnz),
        static_cast<int>(dim));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 span_grid(
      static_cast<unsigned>((n_ranges + kThreads - 1) / kThreads));
  span_sums_kernel<T><<<span_grid, kThreads, 0, st>>>(
      cs, hd, tl, sp, o, static_cast<int>(n_ranges));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. ``values`` may be NULL (implicit
// ones); ``values``, ``d`` and ``out`` (dim elements) are float32
// (photon_csc_column_sums_f32) or float64 (_f64); ``rows`` (nnz) and
// ``col_starts`` (dim + 1, non-decreasing, from 0 to nnz) are int32;
// ``head`` and ``tail`` (float64) and ``span_col`` (int32) hold n_ranges =
// max(ceil(nnz / photon_csc_range()), 1) elements of scratch (the range and
// the run length photon_csc_sub() fix the summation order, which the plain
// version in ops/kernels.py repeats). ``rows`` and
// ``values`` are 16-byte aligned. Launches the two kernels on ``stream``
// without synchronising and returns the first cudaGetLastError() that is
// not cudaSuccess (the second kernel is not launched after a refused
// first).
extern "C" int photon_csc_range() { return kRange; }
extern "C" int photon_csc_sub() { return kPerThread; }

extern "C" int photon_csc_column_sums_f32(
    const void* values, const void* rows, const void* col_starts,
    const void* d, void* out, void* head, void* tail, void* span_col,
    long long nnz, long long dim, long long n_ranges, void* stream) {
  return launch<float>(values, rows, col_starts, d, out, head, tail,
                       span_col, nnz, dim, n_ranges, stream);
}

extern "C" int photon_csc_column_sums_f64(
    const void* values, const void* rows, const void* col_starts,
    const void* d, void* out, void* head, void* tail, void* span_col,
    long long nnz, long long dim, long long n_ranges, void* stream) {
  return launch<double>(values, rows, col_starts, d, out, head, tail,
                        span_col, nnz, dim, n_ranges, stream);
}
