// Fused multiply + TILE-LOCAL inclusive prefix sum for Hopper (sm_90a).
//
// Replaces the TPU kernel photon_ml_tpu/ops/pallas_kernels.py::_mps_kernel
// (launched by _mps_call, entered through multiply_prefix_sum). It computes
// the same function: x = values * d_sorted (x = d_sorted for implicit ones),
// then an inclusive prefix sum of x that restarts every kTile = 32768
// elements, with no carry between tiles, plus each tile's total. Inputs are
// read as if zero-padded to whole tiles, so beyond nnz every element of the
// last tile holds that tile's total. The restart per tile is the error
// contract of types.blocked_boundary_combine: a prefix never grows past one
// tile's sum, so the error does not grow with nnz.
//
// The prefix is accumulated and written in float64 whatever the input type
// (x itself is formed in the input type). types.blocked_boundary_combine
// differences two prefixes per column; a float32 prefix would carry an
// absolute rounding error of eps32 times the tile's running sum, far above
// eps32 times a short column's own sum, and OWL-QN's orthant steps amplify
// such gradient errors from iteration to iteration. Held in float64, the
// column sums round once, to the input type, after the difference.
//
// What bounds it: device-memory bandwidth. Per nonzero it does one add (and
// one multiply with values) against 12 bytes moved with implicit ones in
// float32 (read 4-byte d_sorted, write 8-byte local) or 16 bytes with
// values: at the main path's nnz = 2^21 * 39 that is about 981 MB (1.31 GB)
// per launch, about 0.29 ms (0.39 ms) at 3.35 TB/s, while the adds take
// microseconds.
//
// What the design does about it: every byte is read once and written once,
// with vector accesses in which neighbouring threads touch neighbouring
// addresses: each thread takes two elements per vector, read as 8 bytes
// (float32) or 16 bytes (float64) and written as one 16-byte float64 pair,
// so a warp reads 256 or 512 and writes 512 contiguous bytes per
// instruction. The TPU kernel scans each tile with two
// triangular matmuls on the MXU, and the TPU's grid runs tiles in order;
// here tiles are independent, so one block of 1024 threads owns one tile
// and blocks run in parallel on all SMs. A block walks its tile in passes;
// in each pass every thread loads kChunks vectors (all in flight before
// any arithmetic), scans them sequentially in registers, the lanes of
// a warp scan their totals with __shfl_up_sync, and warp 0 scans the
// per-(chunk, warp) totals held in shared memory. A running carry joins the
// passes. No atomics: the result is the same bit for bit on every run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32768;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int V = 2;  // elements per vector: one float64 pair per store

__device__ __forceinline__ void load_pair(const float* p, float (&o)[V]) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  o[0] = v.x; o[1] = v.y;
}

__device__ __forceinline__ void load_pair(const double* p, double (&o)[V]) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  o[0] = v.x; o[1] = v.y;
}

__device__ __forceinline__ void store_pair(double* p, const double (&o)[V]) {
  *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_exclusive_from_inclusive(T incl, int lane) {
  const T prev = __shfl_up_sync(kFull, incl, 1);
  return lane == 0 ? T(0) : prev;
}

// T: the input type; the prefix is accumulated and stored in double.
template <typename T, bool kHasValues>
__global__ void __launch_bounds__(kThreads)
mps_kernel(const T* __restrict__ values, const T* __restrict__ d,
           double* __restrict__ local, double* __restrict__ totals,
           int64_t nnz) {
  using A = double;
  constexpr int kChunks = 4;                    // vectors per thread per pass
  constexpr int kChunkLen = kThreads * V;       // elements per chunk
  constexpr int kPassLen = kChunkLen * kChunks;  // elements per pass
  constexpr int kPasses = kTile / kPassLen;
  constexpr int kSlots = kChunks * kWarps;      // warp totals per pass
  static_assert(kTile % kPassLen == 0, "tile must be whole passes");
  static_assert(kSlots % 32 == 0, "warp 0 scans kSlots / 32 slots a lane");

  // per pass: exclusive prefix of each (chunk, warp) total, then the pass
  // total; two buffers so one pass's writes never race the last pass's reads
  __shared__ A slots[2][kSlots + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile_base = static_cast<int64_t>(blockIdx.x) * kTile;

  A carry = A(0);
#pragma unroll 1
  for (int pass = 0; pass < kPasses; ++pass) {
    A* buf = slots[pass & 1];
    const int64_t pass_base = tile_base + static_cast<int64_t>(pass) * kPassLen
                              + static_cast<int64_t>(tid) * V;
    A x[kChunks][V];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t off = pass_base + static_cast<int64_t>(c) * kChunkLen;
      T in[V];
      if (off + V <= nnz) {
        load_pair(d + off, in);
        if constexpr (kHasValues) {
          T v[V];
          load_pair(values + off, v);
#pragma unroll
          for (int i = 0; i < V; ++i) in[i] *= v[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int64_t e = off + i;
          in[i] = e < nnz ? (kHasValues ? values[e] * d[e] : d[e]) : T(0);
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) x[c][i] = static_cast<A>(in[i]);
    }

    A lane_excl[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int i = 1; i < V; ++i) x[c][i] += x[c][i - 1];
      const A incl = warp_inclusive_scan(x[c][V - 1], lane);
      lane_excl[c] = warp_exclusive_from_inclusive(incl, lane);
      if (lane == 31) buf[c * kWarps + warp] = incl;
    }
    __syncthreads();

    if (warp == 0) {
      // slots in (chunk, warp) order = element order; each lane owns
      // kPer consecutive slots
      constexpr int kPer = kSlots / 32;
      A v[kPer];
      A sum = A(0);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        v[j] = buf[lane * kPer + j];
        sum += v[j];
      }
      A run = warp_exclusive_from_inclusive(warp_inclusive_scan(sum, lane),
                                            lane);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        buf[lane * kPer + j] = run;
        run += v[j];
      }
      if (lane == 31) buf[kSlots] = run;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const A base = carry + buf[c * kWarps + warp] + lane_excl[c];
#pragma unroll
      for (int i = 0; i < V; ++i) x[c][i] += base;
      store_pair(local + pass_base + static_cast<int64_t>(c) * kChunkLen,
                 x[c]);
    }
    // the tile's last element is the last thread's last value of the last
    // pass; its total is that element, bit for bit
    if (pass == kPasses - 1 && tid == kThreads - 1) {
      totals[blockIdx.x] = x[kChunks - 1][V - 1];
    }
    carry += buf[kSlots];
  }
}

template <typename T>
int launch(const void* values, const void* d, void* local, void* totals,
           long long nnz, long long n_tiles, void* stream) {
  const dim3 grid(static_cast<unsigned>(n_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (values != nullptr) {
    mps_kernel<T, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(values), static_cast<const T*>(d),
        static_cast<double*>(local), static_cast<double*>(totals), nnz);
  } else {
    mps_kernel<T, false><<<grid, kThreads, 0, s>>>(
        nullptr, static_cast<const T*>(d), static_cast<double*>(local),
        static_cast<double*>(totals), nnz);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. ``values`` may be NULL (implicit
// ones). ``values`` and ``d`` are float32 (photon_mps_f32) or float64
// (photon_mps_f64); ``local`` (n_tiles * tile elements) and ``totals``
// (n_tiles) are float64 for both. All pointers are 16-byte aligned. Launches on ``stream`` without
// synchronising and returns cudaGetLastError().
extern "C" int photon_mps_tile() { return kTile; }

extern "C" int photon_mps_f32(const void* values, const void* d, void* local,
                              void* totals, long long nnz, long long n_tiles,
                              void* stream) {
  return launch<float>(values, d, local, totals, nnz, n_tiles, stream);
}

extern "C" int photon_mps_f64(const void* values, const void* d, void* local,
                              void* totals, long long nnz, long long n_tiles,
                              void* stream) {
  return launch<double>(values, d, local, totals, nnz, n_tiles, stream);
}

// The CUDA runtime's name and description of a status the launches above
// returned (cudaGetErrorName / cudaGetErrorString), so the wrapper raises
// the same error torch's own CUDA checks raise.
extern "C" const char* photon_cuda_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

extern "C" const char* photon_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
