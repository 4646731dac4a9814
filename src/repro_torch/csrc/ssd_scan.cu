// ssd_scan: the Mamba2 SSD chunked scan, by hand for Hopper.
//
// Replaces the Pallas TPU kernel `ssd_scan`
// (src/repro/kernels/ssd/ssd.py, kernel `_ssd_kernel`).  It computes the same
// function: per (batch, head) and chunk of Q steps, L = cumsum(a * dt);
// y = (M . x) + exp(L_i) * (C . h_in) with the mixing tile
// M_ij = (C_i . B_j) * exp(L_i - L_j) * dt_j for i >= j and 0 above the
// diagonal; h_out = exp(L_last) * h_in + sum_j exp(L_last - L_j) * dt_j *
// B_j (x) x_j.  All arithmetic is fp32; y is written in x's dtype and the
// final state in fp32.  The mask selects before the exp, so exp(L_i - L_j)
// is never formed above the diagonal, where it overflows for long chunks.
//
// With a bf16 decay (the reference's `_ssd_chunked(decay_dtype=bf16)`,
// src/repro/models/ssm.py:80-90) the intra-chunk term is formed as it forms
// it: M_ij = bf16(C_i . B_j) * bf16(exp(bf16(bf16(L_i) - bf16(L_j)))) for
// i >= j, times bf16(x_j * dt_j), accumulated in fp32 (the product of two
// bf16 values is exact in fp32).  L is then a sequential sum of the fp32
// products a * dt in step order, as torch's cumsum forms it, so that its
// bf16 rounding is the plain version's.  The state weights, the pass across
// chunks and exp(L_i) stay fp32, as in the reference.
//
// Design.  The TPU kernel walks (head, chunk) on a grid whose chunk axis is
// sequential and carries the [N, P] state in VMEM scratch.  Here one block
// owns one (batch, head) and loops over the chunks itself, with the state in
// shared memory, so nothing carries between blocks.  Per chunk it stages x,
// B, C and dt in shared memory as fp32, forms the mixing tile, then y, then
// the new state, each with scalar fp32 FMAs: 256 threads, each owning a
// 4 x 4 micro-tile of a 64 x 64 pass over the output.  x and y are read and
// written in their [B, S, H, P] layout through strides, and B and C, shared
// by the heads, are read at batch index blockIdx / H, so the TPU wrapper's
// transposes and per-head copies of B and C never happen.  A ragged last
// chunk is handled by bounds: its missing steps load as dt = 0, x = B = C =
// 0, which leaves L, y and the state unchanged.  At Q = 128, N = P = 64 the
// tiles take 179 KB of dynamic shared memory (hence the attribute), which
// leaves one block per SM.
//
// Bound on this card, at the serving shape (B 4, S 1024, H 64, P = N = 64,
// Q 128): 2*(Q*(Q+1)/2*(N + P) + 2*Q*N*P) operations per (b, h, chunk) (C.B^T
// and the mixing tile times x over the causal pairs only, as this kernel
// forms them; C.h and the state update over all Q steps) over 2048 (b, h,
// chunk) triples, 8.6 GFLOP, against about 73 MB of input and output (x and
// y in bf16, dt and the state in fp32, B and C in bf16): 0.017 ms at the
// 494.7 TFLOP/s dense tf32 tensor-core rate, below the 0.022 ms the bytes
// take at 3.35 TB/s, so bytes bound it.  This first version multiplies on
// the CUDA cores (67 TFLOP/s peak, 0.13 ms at best) and with one block of 8
// warps per SM it is latency-bound well above that;
// tensor cores (mma/wgmma), TMA, and the split into parallel intra-chunk
// blocks plus a short inter-chunk pass are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kPass = 64;       // rows and columns of one pass: 4 x 4 per thread
constexpr int kMaxChunk = 128;
constexpr size_t kMaxSmem = 232448;

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
  const void* x;    // [B, S, H, P], unit stride on P
  const float* dt;  // [B, S, H]
  const void* Bm;   // [B, S, G, N], unit stride on N
  const void* Cm;   // [B, S, G, N], unit stride on N
  const float* a;   // [H]
  void* y;          // contiguous [B, S, H, P]
  float* state;     // contiguous [B, H, N, P]
  int B, S, H, P, N, Q;
  int hpg;                  // heads a group: head h reads group h / hpg
  long long xsb, xss, xsh;  // element strides of x's B, S and H dims
  long long dsb, dss, dsh;  // of dt
  long long bsb, bss, bsg;  // of Bm's B, S and G dims
  long long csb, css, csg;  // of Cm
};

// Shared memory in floats: must match ops.smem_bytes in the wrapper.
__host__ __device__ inline size_t smem_floats(int Q, int N, int P) {
  return (size_t)N * P              // state h [N][P]
         + (size_t)Q * P            // x tile [Q][P]
         + 2 * (size_t)Q * (N + 1)  // B and C tiles, rows padded against bank conflicts
         + (size_t)Q * Q            // mixing tile M [Q][Q]
         + 4 * (size_t)Q;           // dt, L, exp(L_last - L) * dt, exp(L)
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, bool kBf16Decay>
__global__ void __launch_bounds__(kThreads) ssd_fwd(Args g) {
  extern __shared__ float smem[];
  const int N = g.N, P = g.P, Q = g.Q, S = g.S, H = g.H;
  const int ldb = N + 1;
  float* sH = smem;
  float* sX = sH + N * P;
  float* sB = sX + Q * P;
  float* sC = sB + Q * ldb;
  float* sM = sC + Q * ldb;
  float* sDt = sM + Q * Q;
  float* sL = sDt + Q;
  float* sW = sL + Q;
  float* sE = sW + Q;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const T* x = static_cast<const T*>(g.x) + b * g.xsb + h * g.xsh;
  const float* dt = g.dt + b * g.dsb + h * g.dsh;
  const T* Bm = static_cast<const T*>(g.Bm) + b * g.bsb + (h / g.hpg) * g.bsg;
  const T* Cm = static_cast<const T*>(g.Cm) + b * g.csb + (h / g.hpg) * g.csg;
  T* y = static_cast<T*>(g.y) + ((long long)b * S * H + h) * P;  // step s at + s*H*P
  const long long ys = (long long)H * P;
  const float a = g.a[h];

  for (int i = tid; i < N * P; i += kThreads) sH[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int rows = min(Q, S - s0);
    __syncthreads();  // the last chunk's tiles are read and its state written
    for (int i = tid; i < Q * P; i += kThreads) {
      const int r = i / P, c = i % P;
      sX[i] = r < rows ? to_float(x[(s0 + r) * g.xss + c]) : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int r = i / N, c = i % N;
      const bool ok = r < rows;
      sB[r * ldb + c] = ok ? to_float(Bm[(s0 + r) * g.bss + c]) : 0.f;
      sC[r * ldb + c] = ok ? to_float(Cm[(s0 + r) * g.css + c]) : 0.f;
    }
    for (int r = tid; r < Q; r += kThreads) sDt[r] = r < rows ? dt[(s0 + r) * g.dss] : 0.f;
    __syncthreads();

    // L = inclusive cumsum of a * dt over the chunk, by warp 0 (a bf16
    // decay: by its lane 0, in step order, unfused)
    if (kBf16Decay && tid == 0) {
      float run = 0.f;
      for (int r = 0; r < Q; ++r) sL[r] = run = __fadd_rn(run, __fmul_rn(a, sDt[r]));
    }
    if (tid < 32) {
      float carry = 0.f;
      for (int base = 0; base < Q && !kBf16Decay; base += 32) {
        const int r = base + tid;
        float v = r < Q ? a * sDt[r] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (r < Q) sL[r] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
      __syncwarp();
      const float last = sL[Q - 1];
      for (int r = tid; r < Q; r += 32) {
        sW[r] = expf(last - sL[r]) * sDt[r];
        sE[r] = expf(sL[r]);
      }
    }
    __syncthreads();

    // mixing tile: rows i = i0 + ty + 16r, columns j = j0 + tx + 16c; reads
    // are clamped into the tile and the results past it discarded.  A pass
    // with j0 > i0 lies wholly above the diagonal and is only zeroed.
    for (int i0 = 0; i0 < Q; i0 += kPass) {
      for (int j0 = 0; j0 < Q; j0 += kPass) {
        float acc[4][4] = {};
        int ir[4], jc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ir[k] = min(i0 + ty + 16 * k, Q - 1);
          jc[k] = min(j0 + tx + 16 * k, Q - 1);
        }
        if (j0 <= i0) {
#pragma unroll 4
          for (int n = 0; n < N; ++n) {
            float cv[4], bv[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              cv[k] = sC[ir[k] * ldb + n];
              bv[k] = sB[jc[k] * ldb + n];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            if (i < Q && j < Q && kBf16Decay)
              sM[i * Q + j] = i >= j ? bf16_round(acc[r][c]) *
                                           bf16_round(expf(bf16_round(bf16_round(sL[i]) -
                                                                      bf16_round(sL[j]))))
                                     : 0.f;
            else if (i < Q && j < Q)
              sM[i * Q + j] = i >= j ? acc[r][c] * expf(sL[i] - sL[j]) * sDt[j] : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // y_i = sum_{j <= i} M_ij x_j + exp(L_i) * C_i . h_in (a bf16 decay:
    // M_ij bf16(x_j dt_j))
    for (int i0 = 0; i0 < Q; i0 += kPass) {
      const int jend = min(Q, i0 + kPass);  // M is zero past the diagonal
      for (int p0 = 0; p0 < P; p0 += kPass) {
        float acc[4][4] = {}, inter[4][4] = {};
        int ir[4], pc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ir[k] = min(i0 + ty + 16 * k, Q - 1);
          pc[k] = min(p0 + tx + 16 * k, P - 1);
        }
#pragma unroll 4
        for (int j = 0; j < jend; ++j) {
          float mv[4], xv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            mv[k] = sM[ir[k] * Q + j];
            xv[k] = kBf16Decay ? bf16_round(sX[j * P + pc[k]] * sDt[j]) : sX[j * P + pc[k]];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(mv[r], xv[c], acc[r][c]);
        }
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], hv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            cv[k] = sC[ir[k] * ldb + n];
            hv[k] = sH[n * P + pc[k]];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) inter[r][c] = fmaf(cv[r], hv[c], inter[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
          if (i >= rows) continue;
          const float e = sE[i];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = p0 + tx + 16 * c;
            if (p < P) y[(s0 + i) * ys + p] = from_float<T>(acc[r][c] + e * inter[r][c]);
          }
        }
      }
    }
    __syncthreads();  // every read of h_in is done

    // h_out[n][p] = exp(L_last) h_in[n][p] + sum_j B_jn * W_j * x_jp; each
    // element is owned by one thread, so the update is in place
    const float dec = expf(sL[Q - 1]);
    for (int n0 = 0; n0 < N; n0 += kPass) {
      for (int p0 = 0; p0 < P; p0 += kPass) {
        float acc[4][4] = {};
        int nr[4], pc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          nr[k] = min(n0 + ty + 16 * k, N - 1);
          pc[k] = min(p0 + tx + 16 * k, P - 1);
        }
#pragma unroll 4
        for (int j = 0; j < Q; ++j) {
          const float wj = sW[j];
          float bv[4], xv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            bv[k] = sB[j * ldb + nr[k]] * wj;
            xv[k] = sX[j * P + pc[k]];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(bv[r], xv[c], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = n0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = p0 + tx + 16 * c;
            if (n < N && p < P) sH[n * P + p] = dec * sH[n * P + p] + acc[r][c];
          }
        }
      }
    }
  }
  __syncthreads();
  float* st = g.state + ((long long)b * H + h) * N * P;
  for (int i = tid; i < N * P; i += kThreads) st[i] = sH[i];
}

template <typename T, bool kBf16Decay>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  const size_t smem = smem_floats(g.Q, g.N, g.P) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ssd_fwd<T, kBf16Decay>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  ssd_fwd<T, kBf16Decay><<<g.B * g.H, kThreads, smem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B,S,H,P], dt [B,S,H], Bm and Cm [B,S,G,N] with unit stride on their last
// dims and the given element strides on the others (head h reads group
// h / (H / G)); a [H]; y contiguous
// [B,S,H,P] in x's dtype, state contiguous [B,H,N,P] fp32; chunks of Q steps.
// is_bf16 selects bf16 x, Bm, Cm and y, else fp32; bf16_decay the bf16
// decay of the intra-chunk term, else fp32.  Launches on `stream` and
// returns cudaGetLastError() without synchronising.
int ssd_scan_launch(const void* x, const void* dt, const void* Bm, const void* Cm,
                    const void* a, void* y, void* state, int B, int S, int H, int P,
                    int N, int G, int Q, long long xsb, long long xss, long long xsh,
                    long long dsb, long long dss, long long dsh, long long bsb,
                    long long bss, long long bsg, long long csb, long long css,
                    long long csg, int is_bf16, int bf16_decay, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || G <= 0 || H % G || Q <= 0 ||
      Q > kMaxChunk || Q > S || smem_floats(Q, N, P) * sizeof(float) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Args g{x, static_cast<const float*>(dt), Bm, Cm, static_cast<const float*>(a), y,
         static_cast<float*>(state), B, S, H, P, N, Q, H / G, xsb, xss, xsh, dsb, dss, dsh,
         bsb, bss, bsg, csb, css, csg};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16_decay)
    return (int)(is_bf16 ? launch<__nv_bfloat16, true>(g, s) : launch<float, true>(g, s));
  return (int)(is_bf16 ? launch<__nv_bfloat16, false>(g, s) : launch<float, false>(g, s));
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
