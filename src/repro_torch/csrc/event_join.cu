// event_join: the Table-1 join's per-trigger histogram, by hand for Hopper.
//
// Replaces the Pallas TPU kernel `event_join_counts`
// (src/repro/kernels/event_join/event_join.py, kernel `_join_kernel`).  The
// TPU kernel walks the events on a sequential grid and carries the counts in
// VMEM scratch from one step to the next.  Blocks on this card run in
// parallel and in no order, so this is a histogram instead:
//
//   1. `hist_shared`: each block strides over its share of the events and
//      counts them into a shared-memory histogram of T int32 bins, dropping
//      ids outside [0, T) (-1 is padding).  A warp's ids are mostly equal on
//      the worker's path (a batch is contiguous runs of one trigger row), so
//      `__match_any_sync` folds equal ids into one atomic per distinct id.
//      The block then adds its nonzero bins into a global `acc[T]`, which
//      the launch zeroes first on the same stream.
//      Past kSharedBins bins the histogram does not fit in shared memory and
//      `hist_global` adds into `acc` with global atomics directly.
//   2. `finish`: new_counts = counts + acc, fired = new_counts >= expected.
//
// Integer atomics make the result exact and the same on every run.
//
// Bound on this card: at the worker's batch sizes (<= 4096 events) the work
// is a few microseconds of launch latency for two launches; at large N it is
// memory bandwidth, 4 bytes an event at 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBins = 49152;  // 192 KB of int32 bins

__device__ __forceinline__ void count_warp(int* bins, int id, bool valid) {
  // one atomic per distinct id in the warp, added by its lowest lane
  const unsigned active = __activemask();
  const unsigned peers = __match_any_sync(active, valid ? id : -1);
  const int lane = threadIdx.x & 31;
  if (valid && lane == __ffs(peers) - 1) atomicAdd(&bins[id], __popc(peers));
}

__global__ void __launch_bounds__(kThreads)
hist_shared(const int* __restrict__ events, long long n, int T, int* __restrict__ acc) {
  extern __shared__ int bins[];
  for (int i = threadIdx.x; i < T; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int id = events[i];
    count_warp(bins, id, id >= 0 && id < T);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const int c = bins[i];
    if (c) atomicAdd(&acc[i], c);
  }
}

__global__ void __launch_bounds__(kThreads)
hist_global(const int* __restrict__ events, long long n, int T, int* __restrict__ acc) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int id = events[i];
    count_warp(acc, id, id >= 0 && id < T);
  }
}

__global__ void __launch_bounds__(kThreads)
finish(const int* __restrict__ counts, const int* __restrict__ expected,
       const int* __restrict__ acc, int T, int* __restrict__ new_counts,
       int* __restrict__ fired) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < T) {
    const int total = counts[i] + acc[i];
    new_counts[i] = total;
    fired[i] = total >= expected[i] ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// events [n] int32; counts, expected [T] int32; acc [T] int32 scratch;
// new_counts, fired [T] int32; T >= 1 and max_blocks >= 1 (the Python
// wrapper checks its arguments; this entry does not check them again).
// Zeroes acc and launches on `stream`, and returns cudaGetLastError()
// without synchronising.
int event_join_launch(const void* events, long long n, const void* counts,
                      const void* expected, int T, void* acc, void* new_counts,
                      void* fired, int max_blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)T * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    long long want = (n + kThreads - 1) / kThreads;
    const int blocks = (int)(want < max_blocks ? want : max_blocks);
    if (T <= kSharedBins) {
      const size_t smem = (size_t)T * sizeof(int);
      if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            hist_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
      }
      hist_shared<<<blocks, kThreads, smem, s>>>((const int*)events, n, T, (int*)acc);
    } else {
      hist_global<<<blocks, kThreads, 0, s>>>((const int*)events, n, T, (int*)acc);
    }
  }
  finish<<<(T + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const int*)counts, (const int*)expected, (const int*)acc, T,
      (int*)new_counts, (int*)fired);
  return (int)cudaGetLastError();
}

const char* event_join_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
