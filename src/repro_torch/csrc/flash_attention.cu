// flash_attention: causal / non-causal GQA attention forward, by hand for Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd`
// (src/repro/kernels/flash_attention/flash_attention.py, kernel
// `_flash_kernel`).  It computes the same function: online softmax with the
// m, l and acc state in fp32, scale 1/sqrt(D), columns masked with col < S
// and, when causal, row >= col; query head h reads kv head h / (Hq / Hkv);
// the output is in q's dtype.
//
// Design.  The TPU kernel walks (q block, kv block) on a grid whose kv axis
// is sequential and carries m/l/acc in VMEM scratch.  Here one block owns
// one query tile of kBQ rows of one (batch, q head) and loops over the kv
// tiles itself, up to the causal diagonal, so nothing carries between
// blocks.  Q, the current K and V tiles and the probability tile sit in
// shared memory as fp32 (over 48 KB at D = 128, hence the dynamic shared
// memory attribute); each thread keeps a 4-row slice of acc in registers.
// q, k and v are read in their [B, S, H, D] layout through their strides,
// so the fold to [B*H, S, D] that the TPU wrapper makes never happens.
//
// Bound on this card: at prefill shapes the work is 2*B*Hq*S^2*(D+Dv)/2
// causal FLOPs, compute-bound against 989 TFLOP/s of bf16 tensor cores.
// This first version multiplies with scalar fp32 FMAs on the CUDA cores
// (67 TFLOP/s peak) and sits far below the tensor-core bound; mma/wgmma,
// TMA and pipelining are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads; each owns 4 query rows
constexpr float kNegInf = -1e30f;

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
  const void* q;
  const void* k;
  const void* v;
  void* o;  // contiguous [B, S, Hq, Dv]
  int B, S, Hq, Hkv, D, Dv;
  long long qsb, qss, qsh;  // element strides of q's B, S and H dims
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  int causal;
  float scale;
};

__host__ __device__ inline size_t smem_floats(int D, int Dv) {
  return (size_t)kBQ * (D + 1)      // Q tile, rows padded against bank conflicts
         + (size_t)kBK * (D + 1)    // K tile
         + (size_t)kBK * Dv         // V tile
         + (size_t)kBQ * (kBK + 1)  // scores, then probabilities
         + 3 * kBQ;                 // m, l, alpha per query row
}

// DVT = output columns per thread (Dv <= 16 * DVT).
template <typename T, int DVT>
__global__ void __launch_bounds__(kThreads) flash_fwd(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, Dv = a.Dv, S = a.S;
  const int ldq = D + 1, ldp = kBK + 1;
  float* sQ = smem;
  float* sK = sQ + kBQ * ldq;
  float* sV = sK + kBK * ldq;
  float* sP = sV + kBK * Dv;
  float* sM = sP + kBQ * ldp;
  float* sL = sM + kBQ;
  float* sA = sL + kBQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const T* q = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + hk * a.ksh;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + hk * a.vsh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, row = q0 + r;
    sQ[r * ldq + c] = row < S ? to_float(q[row * a.qss + c]) : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  float acc[4][DVT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DVT; ++j) acc[i][j] = 0.f;

  // triangular schedule: tiles strictly above the diagonal are never visited
  const int kv_end = a.causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the last tile's K, V and P are no longer read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D, row = k0 + r;
      sK[r * ldq + c] = row < S ? to_float(k[row * a.kss + c]) : 0.f;
    }
    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int r = i / Dv, c = i % Dv, row = k0 + r;
      sV[r * Dv + c] = row < S ? to_float(v[row * a.vss + c]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4+i, columns tx + 16*j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty * 4 + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kb[j] = sK[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < S && (!a.causal || row >= col);
        sP[(ty * 4 + i) * ldp + tx + 16 * j] = ok ? s[i][j] * a.scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: each warp owns kBQ / 8 rows, one column per lane
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float x = sP[r * ldp + lane];
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(x - m_new);
      sP[r * ldp + lane] = p;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sA[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DVT; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < kBK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sP[(ty * 4 + i) * ldp + c];
#pragma unroll
      for (int j = 0; j < DVT; ++j) {
        const int col = tx + 16 * j;
        const float vv = col < Dv ? sV[c * Dv + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(sL[ty * 4 + i], 1e-30f);
    T* orow = o + (((long long)b * S + row) * a.Hq + h) * Dv;
#pragma unroll
    for (int j = 0; j < DVT; ++j) {
      const int col = tx + 16 * j;
      if (col < Dv) orow[col] = from_float<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int DVT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats(a.D, a.Dv) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd<T, DVT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.B * a.Hq);
  flash_fwd<T, DVT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const Args& a, cudaStream_t stream) {
  if (a.Dv <= 64) return launch<T, 4>(a, stream);
  if (a.Dv <= 128) return launch<T, 8>(a, stream);
  return launch<T, 16>(a, stream);
}

}  // namespace

extern "C" {

// q [B,S,Hq,D], k [B,S,Hkv,D], v [B,S,Hkv,Dv] with unit stride on the last
// dim and the given element strides on the others; o contiguous
// [B,S,Hq,Dv].  is_bf16 selects bf16 inputs and output, else fp32.
// Launches on `stream` and returns cudaGetLastError() without synchronising.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           int B, int S, int Hq, int Hkv, int D, int Dv,
                           long long qsb, long long qss, long long qsh,
                           long long ksb, long long kss, long long ksh,
                           long long vsb, long long vss, long long vsh,
                           int causal, float scale, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 ||
      Dv <= 0 || Dv > 256 || (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, B, S, Hq, Hkv, D, Dv, qsb, qss, qsh, ksb, kss, ksh,
         vsb, vss, vsh, causal, scale};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_dtype<__nv_bfloat16>(a, s) : launch_dtype<float>(a, s));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
