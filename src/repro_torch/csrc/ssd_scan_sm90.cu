// ssd_scan_sm90: the Mamba2 SSD chunked scan on Hopper's tensor cores, for
// bf16 x, B and C with P = 64 and N = 64 (zamba2-1.2b) or N = 128
// (Nemotron-H), each a template instance.  B and C come in G groups,
// [B, S, G, N]: head h reads group h / (H / G); a block's heads all lie in one
// group (H / G a multiple of its 8 heads, or G = 1), so it loads one B and
// one C tile.  G = 1 is the [B, S, N] layout, shared by every head.
//
// Replaces the Pallas TPU kernel `ssd_scan` (src/repro/kernels/ssd/ssd.py:78,
// kernel `_ssd_kernel`) on the bf16 prefill path; csrc/ssd_scan.cu keeps fp32
// and every other N and P.  It computes the same function: per (batch, head)
// and chunk of Q steps, L = cumsum(a * dt);
// y = M . x + exp(L_i) * (C_i . h_in), M_ij = (C_i . B_j) * exp(L_i - L_j) *
// dt_j for i >= j and 0 above the diagonal; h_out = exp(L_last) * h_in +
// sum_j exp(L_last - L_j) * dt_j * B_j (x) x_j.  y is written in bf16, the
// final state in fp32.  The mask selects before the exp, so exp(L_i - L_j)
// is never used above the diagonal, where it overflows for long chunks.
//
// Bound on this card, at zamba2-1.2b's prefill shape (B 4, S 1024, H 64,
// P = N = 64, Q 128): about 73 MB of input and output (x and y in bf16, B and
// C in bf16, dt and the state in fp32) take 0.022 ms at 3.35 TB/s, longer
// than the 8.6 GFLOP of the function take on the tensor cores, so bytes
// bound it.  The TPU kernel walks the chunks of one (batch, head) in order
// and carries the [N, P] state in VMEM; on Hopper that leaves 256 blocks
// each walking 8 chunks serially.  Here the scan is split into three
// kernels, each parallel over (batch, chunk, head tile):
//  1. ssd_sm90_chunk_state: each chunk's own state contribution
//     s_c = (w o B)^T . x, w_j = exp(L_last - L_j) * dt_j, into an fp32
//     scratch [B, nc, H, N, P], and exp(L_last) into [B, nc, H];
//  2. ssd_sm90_state_pass: h_in[c] = exp(L_last[c-1]) * h_in[c-1] + s_{c-1},
//     elementwise over (b, h, n, p), written over s in the scratch, and the
//     final state;
//  3. ssd_sm90_chunk_scan: G = C . B^T once per (batch, chunk) for the heads
//     of the block (B and C are shared by the heads), kept in shared memory
//     for the 36 16 x 16 tiles on and below the diagonal only; then per head
//     y = exp(L_i) * (C . h_in) + M . x.
// Every product is mma.sync.m16n8k16 (bf16 in, fp32 accumulate), operands
// by ldmatrix (.trans where the contraction dim is not the contiguous one)
// from tiles whose 16-byte chunks are XOR-swizzled by row, so a warp's
// ldmatrix hits every bank once.  Tiles arrive by cp.async (16 bytes a
// thread, rows past the sequence zero-filled), the next head's x tile while
// this head computes.  C . B^T has bf16 operands and is exact up to fp32
// summation order.  The other three products each have one fp32 operand
// (M, w o B and h_in); each goes in as two bf16 terms, hi = bf16(v) and
// lo = bf16(v - hi), which together are v within 2^-16 of itself, so the
// products keep fp32 accuracy at twice the tensor-core work.  The plain
// version of this route, ssd_scan_torch(..., split=True), forms the same
// terms with the same grouping.  A ragged last chunk, or Q that is not a
// multiple of 16, is padded by bounds: rows past the chunk load as dt = 0,
// x = B = C = 0, which leaves L, y and the state unchanged.
// With a bf16 decay (the reference's `_ssd_chunked(decay_dtype=bf16)`,
// src/repro/models/ssm.py:80-90; template flag kBf16Decay of the third
// kernel) M . x is formed as the reference forms it: M_ij = bf16(G_ij) *
// bf16(exp(bf16(bf16(L_i) - bf16(L_j)))) for i >= j, times bf16(x_j dt_j),
// which the kernel writes over each head's x tile before its products; the
// product of two bf16 values has at most 16 significant bits, so M's two
// bf16 terms hold it exactly.  L is then summed by one lane in step order,
// unfused, as torch's cumsum sums it, so that its bf16 rounding is the
// plain version's.  The state weights, the pass across chunks and exp(L_i)
// stay fp32, as in the reference.
// This design moves about 235 MB (x twice, the scratch through memory four
// times), three times the function's 73 MB; a single pass that hands h from
// chunk to chunk in order is the way to the bound.
// At N = 128 the B and C tiles are rows of 256 bytes (16 chunks, the low
// three bits of a chunk's index swizzled), each warp of chunk_state takes two
// n-tiles, the products over N take 8 steps of 16 rather than 4, and a thread
// holds 8 float4s of h_in rather than 4.  chunk_scan's shared memory grows
// from 108 KB to 140 KB (C and B 32 KB each), so one block a SM; the state
// and the scratch are twice as large, so the scratch's passes through memory
// weigh twice as much against the function's bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kP = 64;          // P
constexpr int kMaxQ = 128;      // steps of a chunk, at most
constexpr int kHT = 8;          // heads per block
constexpr int kThreads = 256;   // 8 warps
constexpr int kTileBytes = kMaxQ * kP * 2;     // x: 128 rows of 64 bf16, 16 KB
constexpr int kGTiles = 36;     // 16 x 16 tiles on and below the diagonal of 128 x 128
static_assert(kHT <= kThreads / 32, "one warp forms each head's cumsum");

// The sizes that follow from N
template <int kN> struct Dims {
  static_assert(kN == 64 || kN == 128, "N is 64 or 128");
  static constexpr int kNP = kN * kP;               // elements of one [N, P] state
  static constexpr int kBCTileBytes = kMaxQ * kN * 2;  // B or C: 128 rows of N bf16
  static constexpr int kHTileBytes = kN * kP * 2;   // one bf16 term of h_in, [N][P]
  static constexpr int kNSlots = kN / 64;           // n-tiles a warp takes in chunk_state
  static constexpr int kHQ = kNP / 4 / kThreads;    // float4s of h_in a thread holds
  static constexpr int kMinBlocks = kN == 64 ? 2 : 1;
  static_assert(2 * kHTileBytes == kBCTileBytes, "h_in's two terms fill B's tile");
};

struct Args {
  const __nv_bfloat16* x;   // [B, S, H, P], unit stride on P
  const float* dt;          // [B, S, H]
  const __nv_bfloat16* Bm;  // [B, S, G, N], unit stride on N
  const __nv_bfloat16* Cm;  // [B, S, G, N], unit stride on N
  const float* a;           // [H]
  __nv_bfloat16* y;         // contiguous [B, S, H, P]
  float* state;             // contiguous [B, H, N, P]
  float* scratch;           // contiguous [B, nc, H, N, P]
  float* decay;             // contiguous [B, nc, H]
  int S, H, Q, Qt, nc;      // Qt: Q rounded up to 16
  int hpg;                  // heads a group
  long long xsb, xss, xsh;  // element strides of x's B, S and H dims
  long long dsb, dss, dsh;  // of dt
  long long bsb, bss, bsg;  // of Bm's B, S and G dims
  long long csb, css, csg;  // of Cm
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk k (columns 8k .. 8k + 7) of row r in a tile of
// kCols bf16 columns: the chunks of a row are permuted by r % 8 (the low three
// bits of k), so the 8 rows of an ldmatrix hit every bank once.
template <int kCols>
__device__ __forceinline__ uint32_t swz(int r, int k) {
  return (uint32_t)(r * (kCols * 2) + ((k ^ (r & 7)) << 4));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (v0, v1) as two bf16 pairs, hi = bf16(v) and lo = bf16(v - hi); v - hi is
// exact in fp32, so hi + lo is v within 2^-16 |v|.  v0 in the low halves.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - back.x, v1 - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Rows 0 .. Qt-1 of a [*, kCols] bf16 source into a swizzled tile, rows >=
// rows as zeros; one cp.async group is left open for the caller to commit.
template <int kCols>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          long long stride, int rows, int Qt) {
  constexpr int kChunks = kCols / 8;
  for (int i = threadIdx.x; i < Qt * kChunks; i += kThreads) {
    const int r = i / kChunks, k = i % kChunks;
    const bool ok = r < rows;
    cp_async16(dst + swz<kCols>(r, k), ok ? src + r * stride + k * 8 : src, ok);
  }
}

// The group's B (or C) rows of chunk s0 for the block whose first head is h0
__device__ __forceinline__ const __nv_bfloat16* group_rows(const __nv_bfloat16* m,
                                                           long long sb, long long ss,
                                                           long long sg, const Args& g,
                                                           int b, int s0, int h0) {
  return m + b * sb + s0 * ss + (h0 / g.hpg) * sg;
}

// dt of the block's heads: sdt[k * kMaxQ + r], 0 past the chunk and past H
__device__ __forceinline__ void load_dt(float* sdt, const Args& g, int b, int s0, int rows,
                                        int h0) {
  const float* dt = g.dt + b * g.dsb + s0 * g.dss;
  for (int i = threadIdx.x; i < kHT * g.Qt; i += kThreads) {
    const int k = i / g.Qt, r = i % g.Qt;
    const int h = h0 + k;
    sdt[k * kMaxQ + r] = (r < rows && h < g.H) ? dt[r * g.dss + h * g.dsh] : 0.f;
  }
}

// L[r] = sum_{r' <= r} a * dt[r'] over Qt steps, by one warp: four steps a
// lane in order, then a scan of the lanes' sums.
__device__ __forceinline__ void cumsum_warp(const float* sdt, float* sL, float a, int Qt,
                                            int lane) {
  float v[4], run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = lane * 4 + k;
    run += r < Qt ? a * sdt[r] : 0.f;
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = lane * 4 + k;
    if (r < Qt) sL[r] = excl + v[k];
  }
}

// ---- 1. each chunk's state contribution --------------------------------------
// Grid (nc, head tiles, B).  Warp w computes rows n of the n-tiles w % 4 + 4m
// (m < N / 64) and the 32 columns p of half w / 4 of s = (w o B)^T . x for
// each head of the block.
template <int kN>
__global__ void __launch_bounds__(kThreads, Dims<kN>::kMinBlocks)
    ssd_sm90_chunk_state(const Args g) {
  using D = Dims<kN>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sB = smem_u32(smem);
  const uint32_t sX = sB + D::kBCTileBytes;                      // two buffers
  float* sDt = reinterpret_cast<float*>(smem + D::kBCTileBytes + 2 * kTileBytes);
  float* sW = sDt + kHT * kMaxQ;                                 // [kHT][kMaxQ]

  const int c = blockIdx.x, h0 = blockIdx.y * kHT, b = blockIdx.z;
  const int nh = min(kHT, g.H - h0), Qt = g.Qt;
  const int s0 = c * g.Q, rows = min(g.Q, g.S - s0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3, mat = lane >> 3;
  const __nv_bfloat16* xs = g.x + b * g.xsb + s0 * g.xss;

  load_tile<kN>(sB, group_rows(g.Bm, g.bsb, g.bss, g.bsg, g, b, s0, h0), g.bss, rows, Qt);
  load_tile<kP>(sX, xs + h0 * g.xsh, g.xss, rows, Qt);
  cp_async_commit();
  load_dt(sDt, g, b, s0, rows, h0);
  __syncthreads();

  // w_j = exp(L_last - L_j) * dt_j per head, and exp(L_last)
  if (warp < nh) {
    float* sL = sW + warp * kMaxQ;
    const float* dtk = sDt + warp * kMaxQ;
    cumsum_warp(dtk, sL, g.a[h0 + warp], Qt, lane);
    __syncwarp();
    const float last = sL[Qt - 1];
    __syncwarp();
    for (int r = lane; r < Qt; r += 32) sL[r] = expf(last - sL[r]) * dtk[r];
    if (lane == 0) g.decay[((long long)b * g.nc + c) * g.H + h0 + warp] = expf(last);
  }

  const int ntile = warp & 3, phalf = warp >> 2;
  for (int k = 0; k < nh; ++k) {
    if (k + 1 < nh) {
      load_tile<kP>(sX + ((k + 1) & 1) * kTileBytes, xs + (h0 + k + 1) * g.xsh, g.xss, rows,
                    Qt);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // x of head k, and the w of every head
    const uint32_t sXk = sX + (k & 1) * kTileBytes;
    const float* w = sW + k * kMaxQ;
    float acc[D::kNSlots][4][4] = {};
    for (int kt = 0; kt < Qt / 16; ++kt) {
      // A = (w o B)^T: rows n, columns j; B is stored [j][n], hence .trans
      uint32_t ahi[D::kNSlots][4], alo[D::kNSlots][4];
      const int j0 = 16 * kt + 2 * t4;
#pragma unroll
      for (int m = 0; m < D::kNSlots; ++m) {
        uint32_t braw[4];
        ldsm_x4_t(braw, sB + swz<kN>(16 * kt + (lane & 7) + ((mat >> 1) << 3),
                                     2 * (ntile + 4 * m) + (mat & 1)));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + (q >> 1) * 8;
          const float2 bv = unpack(braw[q]);
          split2(bv.x * w[j], bv.y * w[j + 1], ahi[m][q], alo[m][q]);
        }
      }
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        uint32_t xb[4];
        ldsm_x4_t(xb, sXk + swz<kP>(16 * kt + (lane & 7) + ((mat & 1) << 3),
                                    4 * phalf + 2 * pp + (mat >> 1)));
#pragma unroll
        for (int m = 0; m < D::kNSlots; ++m) {
          mma(acc[m][2 * pp], ahi[m], xb[0], xb[1]);
          mma(acc[m][2 * pp], alo[m], xb[0], xb[1]);
          mma(acc[m][2 * pp + 1], ahi[m], xb[2], xb[3]);
          mma(acc[m][2 * pp + 1], alo[m], xb[2], xb[3]);
        }
      }
    }
    float* out = g.scratch + (((long long)b * g.nc + c) * g.H + h0 + k) * D::kNP;
#pragma unroll
    for (int m = 0; m < D::kNSlots; ++m) {
      const int n = 16 * (ntile + 4 * m) + gq;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int p = 32 * phalf + 8 * nt + 2 * t4;
        *reinterpret_cast<float2*>(out + n * kP + p) =
            make_float2(acc[m][nt][0], acc[m][nt][1]);
        *reinterpret_cast<float2*>(out + (n + 8) * kP + p) =
            make_float2(acc[m][nt][2], acc[m][nt][3]);
      }
    }
    __syncthreads();  // x buffer k & 1 is free for head k + 2
  }
}

// ---- 2. the pass across chunks ------------------------------------------------
// One thread per 4 elements of one (b, h) state.  The loads of up to 8 chunks
// are issued before their stores, so they are in flight together.
template <int kN>
__global__ void __launch_bounds__(kThreads) ssd_sm90_state_pass(const Args g, int n_threads) {
  constexpr int kNP = Dims<kN>::kNP;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_threads) return;
  const int e = (i % (kNP / 4)) * 4, bh = i / (kNP / 4);
  const int b = bh / g.H, h = bh % g.H;
  float* slot0 = g.scratch + ((long long)b * g.nc * g.H + h) * kNP + e;
  const float* dec0 = g.decay + (long long)b * g.nc * g.H + h;
  const long long step = (long long)g.H * kNP;  // from one chunk's slot to the next
  float4 hc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < g.nc; c0 += 8) {
    float4 s[8];
    float dec[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k < g.nc) {
        s[k] = *reinterpret_cast<const float4*>(slot0 + (c0 + k) * step);
        dec[k] = dec0[(long long)(c0 + k) * g.H];
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k < g.nc) {
        *reinterpret_cast<float4*>(slot0 + (c0 + k) * step) = hc;  // h_in of chunk c0 + k
        const float d = dec[k];
        hc = make_float4(d * hc.x + s[k].x, d * hc.y + s[k].y, d * hc.z + s[k].z,
                         d * hc.w + s[k].w);
      }
    }
  }
  *reinterpret_cast<float4*>(g.state + (long long)bh * kNP + e) = hc;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Row r of a swizzled [Qt, 64] bf16 tile times s[r], rounded to bf16, in place
__device__ __forceinline__ void scale_rows(uint32_t tile, const float* s, int Qt) {
  for (int i = threadIdx.x; i < Qt * 8; i += kThreads) {
    const int r = i >> 3;
    const uint32_t addr = tile + swz<kP>(r, i & 7);
    uint32_t v[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]) : "r"(addr) : "memory");
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = unpack(v[q]);
      const __nv_bfloat162 h = __floats2bfloat162_rn(f.x * s[r], f.y * s[r]);
      v[q] = *reinterpret_cast<const uint32_t*>(&h);
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(addr), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
  }
}

// ---- 3. y ---------------------------------------------------------------------
// Grid (nc, head tiles, B).  Warp w owns the 16 rows of row tile w and all 64
// columns p of y.
template <int kN, bool kBf16Decay>
__global__ void __launch_bounds__(kThreads, Dims<kN>::kMinBlocks)
    ssd_sm90_chunk_scan(const Args g) {
  using D = Dims<kN>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sC = smem_u32(smem);
  const uint32_t sB = sC + D::kBCTileBytes;     // after G: h_in's two terms
  const uint32_t sHhi = sB, sHlo = sB + D::kHTileBytes;
  const uint32_t sX = sB + D::kBCTileBytes;     // two buffers
  float* sG = reinterpret_cast<float*>(smem + 2 * D::kBCTileBytes + 2 * kTileBytes);
  float* sDt = sG + kGTiles * 256;                               // [kHT][kMaxQ]
  float* sL = sDt + kHT * kMaxQ;                                 // [kHT][kMaxQ]

  const int c = blockIdx.x, h0 = blockIdx.y * kHT, b = blockIdx.z;
  const int nh = min(kHT, g.H - h0), Qt = g.Qt, nt = Qt / 16;
  const int s0 = c * g.Q, rows = min(g.Q, g.S - s0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3, mat = lane >> 3;
  const __nv_bfloat16* xs = g.x + b * g.xsb + s0 * g.xss;
  const float* hin = g.scratch + ((long long)b * g.nc + c) * g.H * D::kNP;

  load_tile<kN>(sC, group_rows(g.Cm, g.csb, g.css, g.csg, g, b, s0, h0), g.css, rows, Qt);
  load_tile<kN>(sB, group_rows(g.Bm, g.bsb, g.bss, g.bsg, g, b, s0, h0), g.bss, rows, Qt);
  cp_async_commit();
  load_tile<kP>(sX, xs + h0 * g.xsh, g.xss, rows, Qt);
  cp_async_commit();
  // h_in of the first head into registers: this thread's 4 kHQ of its N P.
  // The first chunk starts from h = 0 and skips C . h_in.
  const bool carry = c > 0;
  float4 hreg[D::kHQ] = {};
  if (carry) {
#pragma unroll
    for (int q = 0; q < D::kHQ; ++q)
      hreg[q] = reinterpret_cast<const float4*>(hin + h0 * D::kNP)[threadIdx.x + kThreads * q];
  }
  load_dt(sDt, g, b, s0, rows, h0);
  cp_async_wait<1>();
  __syncthreads();

  // G = C . B^T on the tiles (ti, tj), tj <= ti; tile t = ti (ti + 1) / 2 + tj
  // is stored in the accumulator layout, sG[t][n8][lane][reg]
  for (int t = warp; t < nt * (nt + 1) / 2; t += 8) {
    int ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    const int tj = t - ti * (ti + 1) / 2;
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t ca[4], bb[4];
      ldsm_x4(ca, sC + swz<kN>(16 * ti + (lane & 7) + ((mat & 1) << 3), 2 * kk + (mat >> 1)));
      ldsm_x4(bb, sB + swz<kN>(16 * tj + (lane & 7) + ((mat >> 1) << 3), 2 * kk + (mat & 1)));
      mma(acc[0], ca, bb[0], bb[1]);
      mma(acc[1], ca, bb[2], bb[3]);
    }
#pragma unroll
    for (int n8 = 0; n8 < 2; ++n8)
      reinterpret_cast<float4*>(sG)[(t * 2 + n8) * 32 + lane] =
          make_float4(acc[n8][0], acc[n8][1], acc[n8][2], acc[n8][3]);
  }
  if (warp < nh && !kBf16Decay)
    cumsum_warp(sDt + warp * kMaxQ, sL + warp * kMaxQ, g.a[h0 + warp], Qt, lane);
  if (warp < nh && kBf16Decay && lane == 0) {
    const float a = g.a[h0 + warp], *sdt = sDt + warp * kMaxQ;
    float* L = sL + warp * kMaxQ, run = 0.f;
    for (int r = 0; r < Qt; ++r) L[r] = run = __fadd_rn(run, __fmul_rn(a, sdt[r]));
  }
  __syncthreads();  // G and L are ready; B's tile is free for h_in

  // Row tile ti has ti + 1 column tiles of M . x.  Warps w and w + 4 share
  // an SM sub-partition, so they take tiles a and 7 - a: 9 tiles a pair.
  const int ti = warp < 4 ? warp : 11 - warp;
  const int i0 = 16 * ti + gq, i1 = i0 + 8;
  for (int k = 0; k < nh; ++k) {
    // h_in of head k as two bf16 terms, [n][p] in swizzled tiles
#pragma unroll
    for (int q = 0; q < D::kHQ && carry; ++q) {
      const int f = threadIdx.x + kThreads * q;  // float4 index: n = f / 16, p = 4 (f % 16)
      const uint32_t off = swz<kP>(f >> 4, (f & 15) >> 1) + (f & 1) * 8;
      uint2 hi, lo;
      split2(hreg[q].x, hreg[q].y, hi.x, lo.x);
      split2(hreg[q].z, hreg[q].w, hi.y, lo.y);
      asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" :: "r"(sHhi + off), "r"(hi.x), "r"(hi.y)
                   : "memory");
      asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" :: "r"(sHlo + off), "r"(lo.x), "r"(lo.y)
                   : "memory");
    }
    if (k + 1 < nh) {
#pragma unroll
      for (int q = 0; q < D::kHQ && carry; ++q)
        hreg[q] = reinterpret_cast<const float4*>(hin + (h0 + k + 1) * D::kNP)[threadIdx.x + kThreads * q];
      load_tile<kP>(sX + ((k + 1) & 1) * kTileBytes, xs + (h0 + k + 1) * g.xsh, g.xss, rows,
                    Qt);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // h_in's terms and x of head k are in place
    const uint32_t sXk = sX + (k & 1) * kTileBytes;
    const float* L = sL + k * kMaxQ;
    const float* dtk = sDt + k * kMaxQ;
    if (kBf16Decay) {
      scale_rows(sXk, dtk, Qt);  // x_j dt_j in bf16
      __syncthreads();
    }

    if (ti < nt) {
      float acc[8][4] = {};
      // exp(L_i) * (C_i . h_in), h_in as hi + lo
#pragma unroll
      for (int kk = 0; kk < kN / 16 && carry; ++kk) {
        uint32_t ca[4];
        ldsm_x4(ca, sC + swz<kN>(16 * ti + (lane & 7) + ((mat & 1) << 3), 2 * kk + (mat >> 1)));
        const int hr = 16 * kk + (lane & 7) + ((mat & 1) << 3);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          uint32_t bh[4], bl[4];
          ldsm_x4_t(bh, sHhi + swz<kP>(hr, 2 * pp + (mat >> 1)));
          ldsm_x4_t(bl, sHlo + swz<kP>(hr, 2 * pp + (mat >> 1)));
          mma(acc[2 * pp], ca, bh[0], bh[1]);
          mma(acc[2 * pp], ca, bl[0], bl[1]);
          mma(acc[2 * pp + 1], ca, bh[2], bh[3]);
          mma(acc[2 * pp + 1], ca, bl[2], bl[3]);
        }
      }
      const float Li0 = L[i0], Li1 = L[i1];
      const float e0 = expf(Li0), e1 = expf(Li1);
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        acc[n8][0] *= e0;
        acc[n8][1] *= e0;
        acc[n8][2] *= e1;
        acc[n8][3] *= e1;
      }
      // + M . x over the column tiles tj <= ti
      for (int tj = 0; tj <= ti; ++tj) {
        const int t = ti * (ti + 1) / 2 + tj;
        const float4 g0 = reinterpret_cast<const float4*>(sG)[(t * 2) * 32 + lane];
        const float4 g1 = reinterpret_cast<const float4*>(sG)[(t * 2 + 1) * 32 + lane];
        const int j0 = 16 * tj + 2 * t4;
        // M at (row, column): select on i >= j before the exp.  __expf is
        // ex2.approx of (L_i - L_j) log2(e): within about 2^-21 + |L_i - L_j|
        // 2^-24 of exp, relative, far inside the tolerance.
        const float2 Lj = *reinterpret_cast<const float2*>(L + j0);
        const float2 Lj8 = *reinterpret_cast<const float2*>(L + j0 + 8);
        const float2 dj = *reinterpret_cast<const float2*>(dtk + j0);
        const float2 dj8 = *reinterpret_cast<const float2*>(dtk + j0 + 8);
        auto m = [](float gv, int i, float li, int j, float lj, float dtj) {
          if (kBf16Decay)
            return i >= j ? bf16_round(gv) *
                                bf16_round(expf(bf16_round(bf16_round(li) - bf16_round(lj))))
                          : 0.f;
          return i >= j ? gv * __expf(li - lj) * dtj : 0.f;
        };
        uint32_t ahi[4], alo[4];
        split2(m(g0.x, i0, Li0, j0, Lj.x, dj.x), m(g0.y, i0, Li0, j0 + 1, Lj.y, dj.y),
               ahi[0], alo[0]);
        split2(m(g0.z, i1, Li1, j0, Lj.x, dj.x), m(g0.w, i1, Li1, j0 + 1, Lj.y, dj.y),
               ahi[1], alo[1]);
        split2(m(g1.x, i0, Li0, j0 + 8, Lj8.x, dj8.x), m(g1.y, i0, Li0, j0 + 9, Lj8.y, dj8.y),
               ahi[2], alo[2]);
        split2(m(g1.z, i1, Li1, j0 + 8, Lj8.x, dj8.x), m(g1.w, i1, Li1, j0 + 9, Lj8.y, dj8.y),
               ahi[3], alo[3]);
        const int xr = 16 * tj + (lane & 7) + ((mat & 1) << 3);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          uint32_t xb[4];
          ldsm_x4_t(xb, sXk + swz<kP>(xr, 2 * pp + (mat >> 1)));
          mma(acc[2 * pp], ahi, xb[0], xb[1]);
          mma(acc[2 * pp], alo, xb[0], xb[1]);
          mma(acc[2 * pp + 1], ahi, xb[2], xb[3]);
          mma(acc[2 * pp + 1], alo, xb[2], xb[3]);
        }
      }
      // y rows < rows, as bf16 pairs
      __nv_bfloat16* yh = g.y + ((long long)b * g.S + s0) * g.H * kP + (long long)(h0 + k) * kP;
      const long long ys = (long long)g.H * kP;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const int p = 8 * n8 + 2 * t4;
        if (i0 < rows)
          *reinterpret_cast<__nv_bfloat162*>(yh + i0 * ys + p) =
              __floats2bfloat162_rn(acc[n8][0], acc[n8][1]);
        if (i1 < rows)
          *reinterpret_cast<__nv_bfloat162*>(yh + i1 * ys + p) =
              __floats2bfloat162_rn(acc[n8][2], acc[n8][3]);
      }
    }
    __syncthreads();  // h_in's terms and x buffer k & 1 are free
  }
}

template <int kN>
constexpr int kSmemState = Dims<kN>::kBCTileBytes + 2 * kTileBytes + 2 * kHT * kMaxQ * 4;
template <int kN>
constexpr int kSmemScan =
    2 * Dims<kN>::kBCTileBytes + 2 * kTileBytes + kGTiles * 256 * 4 + 2 * kHT * kMaxQ * 4;

template <int kN, bool kBf16Decay>
cudaError_t launch_scan(const Args& g, dim3 grid, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(ssd_sm90_chunk_scan<kN, kBf16Decay>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemScan<kN>);
  if (e != cudaSuccess) return e;
  ssd_sm90_chunk_scan<kN, kBf16Decay><<<grid, kThreads, kSmemScan<kN>, s>>>(g);
  return cudaGetLastError();
}

template <int kN>
cudaError_t launch(const Args& g, int B, int bf16_decay, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(ssd_sm90_chunk_state<kN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemState<kN>);
  if (e != cudaSuccess) return e;
  const dim3 grid(g.nc, (g.H + kHT - 1) / kHT, B);
  ssd_sm90_chunk_state<kN><<<grid, kThreads, kSmemState<kN>, s>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int n_threads = B * g.H * (Dims<kN>::kNP / 4);
  ssd_sm90_state_pass<kN><<<(n_threads + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      g, n_threads);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return bf16_decay ? launch_scan<kN, true>(g, grid, s) : launch_scan<kN, false>(g, grid, s);
}

}  // namespace

extern "C" {

// x [B,S,H,64], dt [B,S,H] fp32, Bm and Cm [B,S,G,N] bf16 with N 64 or 128,
// with unit stride on the last dim and the given element strides on the
// others (of x, Bm and Cm multiples of 8, their bases 16-byte aligned), a [H]
// fp32; head h reads group h / (H / G), and H / G must be a multiple of 8
// unless G is 1; y contiguous [B,S,H,64] bf16, state contiguous [B,H,N,64]
// fp32; scratch [B,nc,H,N,64] and decay [B,nc,H] fp32, nc = ceil(S / Q);
// chunks of Q <= 128 steps; bf16_decay selects the bf16 decay of the
// intra-chunk term, else fp32.  Launches three kernels on `stream` and
// returns cudaGetLastError() without synchronising.
int ssd_scan_sm90_launch(const void* x, const void* dt, const void* Bm, const void* Cm,
                         const void* a, void* y, void* state, void* scratch, void* decay,
                         int B, int S, int H, int N, int G, int Q, long long xsb,
                         long long xss, long long xsh, long long dsb, long long dss,
                         long long dsh, long long bsb, long long bss, long long bsg,
                         long long csb, long long css, long long csg, int bf16_decay,
                         void* stream) {
  auto bad_stride = [](long long stride, int size) { return size > 1 && stride % 8 != 0; };
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q > kMaxQ || Q > S || B > 65535 ||
      (N != 64 && N != 128) || G <= 0 || H % G || (G > 1 && (H / G) % kHT) ||
      (H + kHT - 1) / kHT > 65535 || ((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm) % 16 ||
      bad_stride(xsb, B) || bad_stride(xss, S) || bad_stride(xsh, H) ||
      bad_stride(bsb, B) || bad_stride(bss, S) || bad_stride(bsg, G) ||
      bad_stride(csb, B) || bad_stride(css, S) || bad_stride(csg, G))
    return (int)cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  const Args g{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
               static_cast<const __nv_bfloat16*>(Bm), static_cast<const __nv_bfloat16*>(Cm),
               static_cast<const float*>(a), static_cast<__nv_bfloat16*>(y),
               static_cast<float*>(state), static_cast<float*>(scratch),
               static_cast<float*>(decay), S, H, Q, (Q + 15) / 16 * 16, nc, H / G,
               xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg, csb, css, csg};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(N == 64 ? launch<64>(g, B, bf16_decay, s) : launch<128>(g, B, bf16_decay, s));
}

const char* ssd_scan_sm90_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
