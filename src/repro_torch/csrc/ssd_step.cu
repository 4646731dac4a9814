// ssd_step: one step of the Mamba2 (SSD) recurrence, the decode step's state
// update, by hand for Hopper.
//
// Replaces no Pallas kernel: the JAX package's decode step is plain jnp
// (src/repro/models/ssm.py, `mamba2_decode`).  In the port it takes the place
// of the five tensor ops of `models/ssm.py::mamba2_decode` that decayed the
// state, added the outer product, and contracted it with C: together they
// read and wrote the fp32 state about four times a step, and copied it once
// into a permuted layout.  It computes, for each (b, h) and each (n, p) of the
// state, in place:
//
//   decay     = exp(dt[b,h] * a[h])
//   h'[n,p]   = h[n,p] * decay + B[b,g,n] * (dt[b,h] * x[b,h,p])
//   y[b,h,p]  = sum_n C[b,g,n] * h'[n,p] + d_skip[h] * x[b,h,p]
//
// with g = h / (H / G) the head's group of B and C (G = 1: one shared by all)
//
// The state update rounds each product and the sum apart (no FMA), as the
// plain version's tensor ops do, so the new state is theirs; y is summed in
// fp32 in a fixed order of its own and written in x's dtype.  `expf`, not
// `__expf`.
//
// Bound on this card: the state's bytes.  Each element is read once and
// written once, 2 * B*H*N*P*4 bytes (134.2 MB at B 64, H 64, N = P = 64:
// 0.0401 ms at 3.35 TB/s); x, dt, B, C and y add under 1%.  There are 3
// operations a state element, far below the ridge.
//
// Design.  One block owns one (b, h), or one slice of its P when there are
// too few pairs to fill the card (the wrapper picks `split` from B*H and the
// SM count).  A thread owns four adjacent columns of P, one 16-byte load of
// each state row it holds, and `tn` threads split the N rows; a thread loads
// its kRows rows before it computes, so kRows * 16 bytes of it are in flight,
// and writes each new row straight back.  Its partial y (four columns) goes to
// shared memory, and the threads of the block's first row sum the `tn`
// partials in row order: a fixed order, no atomics, so a replayed CUDA graph
// gives the op-by-op step bit for bit.  x, dt, B and C are read through their
// strides: x is the conv output's [B, Di] viewed as [B, H, P], in whatever
// layout the conv's einsum left it (on the card, P's stride is B).  Nothing
// is allocated and nothing synchronises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // at most, a block
constexpr int kRows = 4;       // state rows a thread holds in flight

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  float* state;         // contiguous [B, H, N, P] fp32, updated in place
  const void* x;        // [B, H, P] in T
  const float* dt;      // [B, H]
  const float* a;       // [H], contiguous
  const float* Bm;      // [B, G, N]
  const float* Cm;      // [B, G, N]
  const float* d_skip;  // [H], contiguous
  void* y;              // contiguous [B, H, P] in T
  int B, H, N, P;
  int split;            // blocks a (b, h): each a slice of P / split columns
  int tn;               // threads along N
  int hpg;              // heads a group: head h reads group h / hpg
  long long xsb, xsh, xsp;  // element strides of x's B, H and P dims
  long long dsb, dsh;       // of dt
  long long bsb, bsg, bsn;  // of Bm
  long long csb, csg, csn;  // of Cm
};

__device__ __forceinline__ float update(float h, float decay, float b, float dtx) {
  return __fadd_rn(__fmul_rn(h, decay), __fmul_rn(b, dtx));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_step_kernel(Args g) {
  __shared__ float4 part[kThreads];
  const int ps = g.P / g.split;  // the block's slice of P
  const int tp = ps / 4;         // threads along P
  const int bh = blockIdx.x / g.split;
  const int b = bh / g.H, h = bh - b * g.H;
  const int q = threadIdx.x % tp, r = threadIdx.x / tp;
  const int p = (blockIdx.x % g.split) * ps + 4 * q;

  const float dt = g.dt[b * g.dsb + h * g.dsh];
  const float decay = expf(__fmul_rn(dt, g.a[h]));
  const T* xr = static_cast<const T*>(g.x) + b * g.xsb + h * g.xsh + p * g.xsp;
  float x[4], dtx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = to_float<T>(xr[i * g.xsp]);
    dtx[i] = __fmul_rn(dt, x[i]);
  }
  const float* Bm = g.Bm + b * g.bsb + (h / g.hpg) * g.bsg;
  const float* Cm = g.Cm + b * g.csb + (h / g.hpg) * g.csg;
  const int row = g.P / 4;  // float4s a state row
  float4* st = reinterpret_cast<float4*>(g.state + (size_t)bh * g.N * g.P + p);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n0 = r; n0 < g.N; n0 += kRows * g.tn) {
    float4 s[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {  // every load before any store
      const int n = n0 + k * g.tn;
      s[k] = n < g.N ? st[(size_t)n * row] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int n = n0 + k * g.tn;
      if (n < g.N) {
        const float bn = Bm[n * g.bsn], cn = Cm[n * g.csn];
        s[k].x = update(s[k].x, decay, bn, dtx[0]);
        s[k].y = update(s[k].y, decay, bn, dtx[1]);
        s[k].z = update(s[k].z, decay, bn, dtx[2]);
        s[k].w = update(s[k].w, decay, bn, dtx[3]);
        st[(size_t)n * row] = s[k];
        acc.x = fmaf(cn, s[k].x, acc.x);
        acc.y = fmaf(cn, s[k].y, acc.y);
        acc.z = fmaf(cn, s[k].z, acc.z);
        acc.w = fmaf(cn, s[k].w, acc.w);
      }
    }
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (r != 0) return;
  for (int j = 1; j < g.tn; ++j) {  // the partials in row order
    const float4 v = part[j * tp + q];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  const float d = g.d_skip[h];
  T* yr = static_cast<T*>(g.y) + (size_t)bh * g.P + p;
  yr[0] = from_float<T>(__fadd_rn(acc.x, __fmul_rn(x[0], d)));
  yr[1] = from_float<T>(__fadd_rn(acc.y, __fmul_rn(x[1], d)));
  yr[2] = from_float<T>(__fadd_rn(acc.z, __fmul_rn(x[2], d)));
  yr[3] = from_float<T>(__fadd_rn(acc.w, __fmul_rn(x[3], d)));
}

}  // namespace

extern "C" {

// state contiguous [B,H,N,P] fp32, updated in place; x [B,H,P], dt [B,H],
// Bm and Cm [B,G,N] fp32 (head h reads group h / (H / G)), each with the
// given element strides; a and d_skip
// contiguous [H] fp32; y contiguous [B,H,P].  is_bf16 selects bf16 x and y, else
// fp32.  P must be a multiple of 4 * split, with P / split / 4 * tn threads a
// block, at most 256.  Launches on `stream` and returns cudaGetLastError()
// without synchronising.
int ssd_step_launch(void* state, const void* x, const void* dt, const void* a,
                    const void* Bm, const void* Cm, const void* d_skip, void* y, int B,
                    int H, int N, int P, int G, int split, int tn, long long xsb,
                    long long xsh, long long xsp, long long dsb, long long dsh,
                    long long bsb, long long bsg, long long bsn, long long csb,
                    long long csg, long long csn, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || P <= 0 || G <= 0 || H % G || split <= 0 || tn <= 0 ||
      P % (4 * split))
    return (int)cudaErrorInvalidValue;
  const int threads = P / split / 4 * tn;
  if (threads > kThreads) return (int)cudaErrorInvalidValue;
  Args g{static_cast<float*>(state), x, static_cast<const float*>(dt),
         static_cast<const float*>(a), static_cast<const float*>(Bm),
         static_cast<const float*>(Cm), static_cast<const float*>(d_skip), y,
         B, H, N, P, split, tn, H / G, xsb, xsh, xsp, dsb, dsh, bsb, bsg, bsn,
         csb, csg, csn};
  const dim3 grid((unsigned)((long long)B * H * split));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    ssd_step_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(g);
  else
    ssd_step_kernel<float><<<grid, threads, 0, s>>>(g);
  return (int)cudaGetLastError();
}

const char* ssd_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
