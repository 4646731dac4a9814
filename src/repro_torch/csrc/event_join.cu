// event_join: the Table-1 join's per-trigger histogram, by hand for Hopper.
//
// Replaces the Pallas TPU kernel `event_join_counts`
// (src/repro/kernels/event_join/event_join.py:51, kernel `_join_kernel`).
// The TPU kernel walks the events on a sequential grid, compares each block
// one-hot against the T trigger ids, carries the counts in VMEM scratch to
// the last step, and there writes new_counts = counts + acc and fired =
// new_counts >= expected.  Blocks on this card run in parallel and in no
// order, so the counts are a histogram, and each call is ONE launch:
//
// * One block (n <= kOneBlockEvents: every batch of the worker's main
//   path) counts the events into T shared-memory bins and, after one
//   __syncthreads, writes new_counts and fired itself.  No global scratch,
//   no global atomics, no memset, no second kernel.
// * More blocks (kBlockEvents events each, two a SM at most): each block
//   counts its share into its own bins and adds the nonzero ones into a
//   global acc[T]; after __threadfence() each takes a ticket, and the last
//   block to arrive reads acc through volatile loads, writes the outputs,
//   and leaves acc and the ticket at zero for the next launch.  (Clusters
//   that first add their blocks' bins into the leader's through
//   distributed shared memory were slower: scripts/event_join_variants.py,
//   PERF.md.)
// * Past kSharedBins bins the histogram does not fit in shared memory:
//   the blocks count into acc with global atomics and finish the same way.
//
// Ids outside [0, T) are dropped (-1 is padding).  A warp's ids are mostly
// equal on the worker's path (a batch is contiguous runs of one trigger
// row), so __match_any_sync folds equal ids into one atomic per distinct id.
// Integer atomics make the result exact and the same on every run.  The
// outputs are one [2, T] buffer (new_counts, then fired).  The scratch
// (ticket, then acc) belongs to the caller: zeroed once when allocated, and
// left zeroed by every launch that completes.  The join backend's call
// (event_join_roundtrip) launches on the pinned host buffers themselves,
// which are device-addressable under unified addressing: the kernel reads
// the inputs and writes the outputs across PCIe, so a triage call is one
// launch and one synchronisation with no copies (timed against one copy
// each way by scripts/event_join_variants.py).
//
// What bounds it on this card: at the main path's shape (n 4096, T 100)
// the function moves 4 (n + 4T) bytes, 18 KB, 5.4 ns at 3.35 TB/s, so what
// a call costs is the latency of its launch and of its dependent memory
// round trips.  The design spends one launch and, in it, two round trips:
// each thread issues its kUnroll event loads and its counts/expected loads
// before its first atomic, and its stores after the one barrier.  The
// backend's call adds no copy: its round trips cross PCIe instead of two
// DMA operations (one copy each way cost more, host to host, at that
// shape).  At large n the bound is memory bandwidth, 4 bytes an event,
// which the multi-block path reads with up to two blocks a SM in flight;
// for the backend's call, PCIe's.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;                    // event loads in flight per thread
constexpr long long kOneBlockEvents = 4096;   // one block up to this many events
constexpr long long kBlockEvents = 2048;      // events a block past it
constexpr int kSharedBins = 49152;            // 192 KB of int32 bins

// one atomic per distinct valid id in the warp, added by its lowest lane;
// all 32 lanes take part
__device__ __forceinline__ void count_warp(int* bins, int id, int T) {
  const bool valid = (unsigned)id < (unsigned)T;
  const unsigned peers = __match_any_sync(0xffffffffu, valid ? id : -1);
  if (valid && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&bins[id], __popc(peers));
}

// Counts events[first + k * stride], k >= 0, into bins.  Every lane of a
// warp runs the same iterations (the bound is the warp's first index), and
// loads past n read as padding.
__device__ __forceinline__ void count_events(const int* __restrict__ events, long long n,
                                             int T, int* bins, long long first,
                                             long long stride) {
  const int lane = threadIdx.x & 31;
  for (long long base = first - lane; base < n; base += kUnroll * stride) {
    int id[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = base + lane + u * stride;
      id[u] = j < n ? __ldg(events + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) count_warp(bins, id[u], T);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
join(const int* __restrict__ events, long long n, const int* __restrict__ counts,
     const int* __restrict__ expected, int T, int* __restrict__ out, int* scratch) {
  extern __shared__ int smem[];
  __shared__ bool last;
  const int tid = threadIdx.x;
  // this thread's first output's inputs, loaded before the events so that
  // their latency overlaps the histogram's (the one-block path's writes)
  int c0 = 0, x0 = 0;
  if (gridDim.x == 1 && tid < T) {
    c0 = counts[tid];
    x0 = expected[tid];
  }
  int* bins = kShared ? smem : scratch + 1;
  if (kShared) {
    for (int i = tid; i < T; i += kThreads) bins[i] = 0;
    __syncthreads();
  }
  count_events(events, n, T, bins, (long long)blockIdx.x * kThreads + tid,
               (long long)gridDim.x * kThreads);

  if (kShared && gridDim.x == 1) {
    __syncthreads();
    for (int i = tid; i < T; i += kThreads) {
      const int total = (i < kThreads ? c0 : counts[i]) + bins[i];
      out[i] = total;
      out[T + i] = total >= (i < kThreads ? x0 : expected[i]) ? 1 : 0;
    }
    return;
  }

  if (kShared) {
    __syncthreads();
    int* acc = scratch + 1;
    for (int i = tid; i < T; i += kThreads) {
      const int c = bins[i];
      if (c) atomicAdd(&acc[i], c);
    }
  }

  // the ticket: every thread's adds into acc are visible device-wide before
  // its block's ticket, and the last block to take one finishes
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  volatile int* acc = scratch + 1;
  for (int i = tid; i < T; i += kThreads) {
    const int total = counts[i] + acc[i];
    out[i] = total;
    out[T + i] = total >= expected[i] ? 1 : 0;
    acc[i] = 0;
  }
  if (tid == 0) scratch[0] = 0;
}

int plan_blocks(long long n, int max_blocks) {
  const long long want = n > kOneBlockEvents ? (n + kBlockEvents - 1) / kBlockEvents : 1;
  return (int)(want < max_blocks ? want : max_blocks);
}

bool needs_scratch(long long n, int T, int max_blocks) {
  return T > kSharedBins || plan_blocks(n, max_blocks) > 1;
}

cudaError_t launch(const int* events, long long n, const int* counts, const int* expected,
                   int T, int* out, int* scratch, int max_blocks, cudaStream_t s) {
  const int blocks = plan_blocks(n, max_blocks);
  if (T > kSharedBins) {
    join<false><<<blocks, kThreads, 0, s>>>(events, n, counts, expected, T, out, scratch);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)T * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        join<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  join<true><<<blocks, kThreads, smem, s>>>(events, n, counts, expected, T, out, scratch);
  return cudaGetLastError();
}

// makes `device` the calling thread's current device for its lifetime
struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    else prev = -1;
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

extern "C" {

// The int32 scratch a launch with these arguments needs: 0 (the one-block
// shared path), or 1 + T (the ticket, then acc), zeroed.
long long event_join_scratch_ints(long long n, int T, int max_blocks) {
  return needs_scratch(n, T, max_blocks) ? 1 + (long long)T : 0;
}

// events [n]; counts, expected [T]; out [2, T] (new_counts, then fired), all
// int32 on `device`; scratch as event_join_scratch_ints says (may be null
// where it says 0); T >= 1 and max_blocks >= 1 (the Python wrapper checks
// its arguments; this entry does not check them again).  Launches on
// `stream` and returns the launch's error code without synchronising.
int event_join_launch(const void* events, long long n, const void* counts,
                      const void* expected, int T, void* out, void* scratch, int max_blocks,
                      int device, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)launch((const int*)events, n, (const int*)counts, (const int*)expected, T,
                     (int*)out, (int*)scratch, max_blocks, (cudaStream_t)stream);
}

// One triage call, host to host, on `stream`: launches on host_in [n + 2T]
// (events, counts, expected) and host_out [2, T], both pinned host memory,
// which the kernel reads and writes directly, then synchronises the stream.
// scratch holds 1 + T zeroed ints on the card.  Returns the first error.
int event_join_roundtrip(const void* host_in, long long n, int T, void* host_out,
                         void* scratch, int max_blocks, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t s = (cudaStream_t)stream;
  const int* in = (const int*)host_in;
  const cudaError_t e = launch(in, n, in + n, in + n + T, T, (int*)host_out, (int*)scratch,
                               max_blocks, s);
  const cudaError_t sync = cudaStreamSynchronize(s);
  return (int)(e != cudaSuccess ? e : sync);
}

const char* event_join_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
