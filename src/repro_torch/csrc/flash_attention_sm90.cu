// flash_attention_sm90: causal / non-causal GQA attention forward on Hopper's
// tensor cores, for bf16 q, k, v with (D, Dv) one of (64, 64), (128, 128) and
// (192, 128): D is the width of q and k, Dv that of v and o.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd`
// (src/repro/kernels/flash_attention/flash_attention.py:78, kernel
// `_flash_kernel`) on the bf16 prefill path; csrc/flash_attention.cu keeps
// fp32 and every other pair of head dims.  It computes the same function:
// online softmax with the m, l and acc state in fp32, scale 1/sqrt(D), columns
// masked with col < S and, when causal, row >= col; query head h reads kv
// head h / (Hq / Hkv); the output is bf16.  One difference: the P.V product
// runs on the bf16 tensor cores, where the TPU kernel keeps p = exp(s - m)
// in fp32.  A single bf16 rounding of p could not be mirrored: S differs
// from the plain version's in its last fp32 bits (another summation order),
// so p sometimes rounds to the neighbouring bf16, and in a row with few
// keys that moves o by more than one bf16 ulp.  So p goes in as two bf16
// terms, hi = bf16(p) and lo = bf16(p - hi): hi + lo is p within 2^-16 of
// itself wherever the rounding falls, and o within 2^-16 max|v| of the
// fp32-p result.  l sums the fp32 p.  The plain version of this route
// (flash_attention_torch with p_split=True, block_k=128) forms the same two
// terms over the same tiles.
//
// Bound on this card: the causal pairs need 2*B*Hq*(D+Dv)*S(S+1)/2 FLOPs,
// and at the serving prefill shapes these take longer at 989 TFLOP/s of
// dense bf16 tensor cores than the q, k, v and o bytes take at 3.35 TB/s
// (llama3.2-3b, B 4, S 1024, 24/8 heads, D 128: 0.0261 ms by operations;
// zamba2-1.2b, 32/32 heads, D 64: 0.0200 ms).  At deepseek-v2's expanded
// MLA prefill (B 4, S 1024, 128/128 heads, D 192 = nope 128 + rope 64, Dv
// 128) the 671 MB of q, k, v and o take 0.2003 ms and the 171.97 GFLOP
// 0.1739 ms, so bytes bound it there.  So the design feeds the tensor cores:
//  - Both products are wgmma m64nNk16 (bf16 in, fp32 accumulate).
//    S = Q.K^T reads Q and K from shared memory (K-major); O += P.V takes P
//    from registers (the S accumulator's layout is the A operand's, so p
//    never leaves the registers) and V from shared memory as an MN-major B.
//    The two terms of P make P.V two products, 1.5 times the tensor-core
//    work the function needs.
//  - A CTA owns 128 query rows of one (batch, q head): two warpgroups of
//    64 rows each.  No producer warp: the card allocates a CTA's registers
//    by whole warpgroups, so a ninth warp is charged as four and left 168
//    registers a thread, too few for the D 128 accumulators (ptxas then
//    serialises the wgmmas).  One elected thread issues the loads instead.
//  - That thread loads Q once and the K and V tiles of 128 rows by TMA
//    (cp.async.bulk.tensor, 128-byte swizzle) into a two-stage ring.  Each
//    stage has a full and an empty mbarrier; at the start of tile j the
//    thread refills the stage that tile j - 1 released with tile j + 1, so
//    the next tile is in flight while both warpgroups compute on this one.
//    A 64-column panel of 128 rows (16 KB) is one TMA box; Q and K take
//    D / 64 panels, V takes Dv / 64, and a stage's full barrier expects
//    (D + Dv) / 64 panels of bytes.  Every wgmma descriptor names the same
//    128-byte swizzle.  Shared memory: Q, then two stages of K and V, plus
//    1 KB to align: 80 KB at (64, 64), 160 KB at (128, 128), and at
//    (192, 128) 3 + 2 x (3 + 2) = 13 panels, 214 016 B of the card's
//    232 448 B opt-in, one CTA an SM (a third stage would need 288 KB).
//  - A wider D adds k-steps to S = Q.K^T only (12 of 16 at D 192, 8 at
//    D 128): Q stays in shared memory, so the registers a thread holds are
//    those of Dv: o is Dv / 2 fp32, s 64 fp32, p's two terms 32 + 32.
//  - The softmax stays in registers: each row's m and l reduce over the
//    four threads of its quad with shuffles, in the exp2 domain with
//    log2(e) folded into the scale (ex2.approx, 2^-22 relative); acc is
//    rescaled by alpha per tile.
//  - At (64, 64) two CTAs share an SM (80 KB each, 128 registers a thread):
//    one CTA's loads, softmax and epilogue overlap the other's products,
//    though ptxas serialises the wgmmas at that register count.
//  - Causal: tiles above the diagonal are never loaded; only the diagonal
//    tile and a ragged last tile are masked; query rows >= S are never
//    stored.  Query tiles with the most kv tiles start first, and
//    (batch, head) is on gridDim.x.
//  - GQA: the K and V tensor maps are read at head h / G; nothing is copied.
// Left for later: ping-pong of softmax and GEMM between the warpgroups,
// setmaxnreg, a persistent scheduler, fp8.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kBM = 128;             // query rows per CTA (two warpgroups of 64)
constexpr int kBN = 128;             // kv rows per tile
constexpr int kStages = 2;           // K/V ring depth
constexpr int kWarps = 8;            // two warpgroups
constexpr int kThreads = 32 * kWarps;
constexpr int kPanelCols = 64;       // bf16 columns in one 128-byte swizzle row
constexpr int kPanelBytes = kBN * kPanelCols * 2;    // 128 rows x 128 B = 16 KB
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  __nv_bfloat16* o;  // contiguous [B, S, Hq, Dv]
  int S, Hq, Hkv, causal;
  float scale_log2;  // log2(e) / sqrt(D)
};

template <int HD, int HV> constexpr int smem_bytes() {
  // Q, then kStages K tiles, then kStages V tiles; 1 KB of slack to align
  // the first panel to the 1024-byte swizzle period
  return ((HD / kPanelCols) * (1 + kStages) + (HV / kPanelCols) * kStages) * kPanelBytes + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ----
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// Wait until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// ---- TMA: one box of a 4-d tensor map, (col, head, row, batch) ----
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ----
// Shared-memory matrix descriptor, 128-byte swizzle.  Start address, leading
// and stride byte offsets in 16-byte units; base offset 0, so every swizzle
// atom (8 rows of 128 B) starts on a 1024-byte boundary.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin register arrays at this point of the instruction stream, so the
// compiler neither reads an accumulator before wgmma_wait_all nor writes
// one after wgmma_fence.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d[64 x 128] (+)= a[64 x 16] b[16 x 128]: a and b from shared memory, both
// K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += a[64 x 16] b[16 x 64]: a from registers (bf16 pairs in the
// accumulator's layout), b from shared memory, MN-major (imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d[64 x 128] += a[64 x 16] b[16 x 128]: a from registers (bf16 pairs in the
// accumulator's layout), b from shared memory, MN-major (imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}


// O += P V for one k-step of 16 kv rows: a holds the four A registers.
template <int HV>
__device__ __forceinline__ void wgmma_pv(float (&o)[HV / 2], const uint32_t* a, uint64_t dv) {
  if constexpr (HV == 128)
    wgmma_rs_m64n128(o, a[0], a[1], a[2], a[3], dv);
  else
    wgmma_rs_m64n64(o, a[0], a[1], a[2], a[3], dv);
}

// 2^x; 0 for x = -inf and for results below 2^-126
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);  // x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// HD is the depth of Q.K^T (the width of q and k), HV the width of v and o.
template <int HD, int HV>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 2 : 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tmap_q,
               const __grid_constant__ CUtensorMap tmap_k,
               const __grid_constant__ CUtensorMap tmap_v, const Params p) {
  constexpr int kPanelsK = HD / kPanelCols;            // of Q and of K
  constexpr int kPanelsV = HV / kPanelCols;
  constexpr int kPanelsMax = kPanelsK > kPanelsV ? kPanelsK : kPanelsV;
  constexpr int kTileK = kPanelsK * kPanelBytes;       // 128 rows of Q or K
  constexpr int kTileV = kPanelsV * kPanelBytes;       // 128 rows of V
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // q_full, full[], empty[]

  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + kTileK;                   // stage s at + s * kTileK
  const uint32_t sV = sK + kStages * kTileK;         // stage s at + s * kTileV
  const uint32_t q_full = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]);         // stage s at + 8 * s
  const uint32_t empty0 = smem_u32(&bars[1 + kStages]);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int qt = gridDim.y - 1 - blockIdx.y;  // the query tiles with most kv tiles first
  const int q0 = qt * kBM;
  // kBM == kBN, so the causal diagonal tile is kv tile qt
  const int n_kv = p.causal ? qt + 1 : (p.S + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every TMA load (rows past S arrive as zeros): Q and
  // the first kStages - 1 tiles now, then tile j + kStages - 1 at the start
  // of iteration j, into the stage that tile j - 1 has released
  auto load_kv = [&](int jt) {
    const int s = jt % kStages;
    if (jt >= kStages) mbar_wait(empty0 + 8 * s, (jt / kStages - 1) & 1);
    // the stage completes when all of its K and V bytes have landed
    mbar_expect_tx(full0 + 8 * s, kTileK + kTileV);
    for (int c = 0; c < kPanelsMax; ++c) {
      if (c < kPanelsK)
        tma_load(sK + s * kTileK + c * kPanelBytes, &tmap_k, full0 + 8 * s,
                 c * kPanelCols, hk, jt * kBN, b);
      if (c < kPanelsV)
        tma_load(sV + s * kTileV + c * kPanelBytes, &tmap_v, full0 + 8 * s,
                 c * kPanelCols, hk, jt * kBN, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, kTileK);
    for (int c = 0; c < kPanelsK; ++c)
      tma_load(sQ + c * kPanelBytes, &tmap_q, q_full, c * kPanelCols, h, q0, b);
    for (int jt = 0; jt < kStages - 1 && jt < n_kv; ++jt) load_kv(jt);
  }

  // Warpgroup wg owns query rows q0 + 64 wg .. + 63.  In the wgmma
  // accumulator layout this thread holds rows r_lo and r_lo + 8, and in each
  // 8-column block n the columns 8n + 2 t4 and 8n + 2 t4 + 1: accumulator
  // register 4n + 2 half + c is (row r_lo + 8 half, col 8n + 2 t4 + c).
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int r_lo = q0 + wg * 64 + (warp % 4) * 16 + g;
  const uint32_t sQ_wg = sQ + wg * 64 * 128;  // 64 rows of 128 B into each panel
  float o[HV / 2];
#pragma unroll
  for (int i = 0; i < HV / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_kv; ++j) {
    if (threadIdx.x == 0 && j + kStages - 1 < n_kv) load_kv(j + kStages - 1);
    __syncwarp();
    const int s = j % kStages;
    mbar_wait(full0 + 8 * s, (j / kStages) & 1);
    const uint32_t sKs = sK + s * kTileK, sVs = sV + s * kTileV;

    // S = Q K^T over HD / 16 k-steps; step kk is 32 bytes into panel kk / 4
    float sc[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
      wgmma_ss_m64n128(sc, sw128_desc(sQ_wg + off, 16, 1024), sw128_desc(sKs + off, 16, 1024),
                       kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // mask the diagonal tile and a ragged last tile only
    const int k0 = j * kBN;
    if ((p.causal && j == qt) || k0 + kBN > p.S) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int col = k0 + (i / 4) * 8 + t4 * 2 + (i % 2);
        const int row = r_lo + ((i / 2) % 2) * 8;
        if (col >= p.S || (p.causal && col > row)) sc[i] = -INFINITY;
      }
    }

    // online softmax in the exp2 domain; a row's max and sum span its quad
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = m_run[half];
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * half], sc[4 * n + 2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // every processed tile holds a column <= each row, so mx is finite; the
      // guard keeps -inf - -inf out all the same
      const float m_scaled = (mx == -INFINITY ? 0.f : mx) * p.scale_log2;
      alpha[half] = ex2(m_run[half] * p.scale_log2 - m_scaled);
      m_run[half] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * n + 2 * half + c;
          sc[i] = ex2(fmaf(sc[i], p.scale_log2, -m_scaled));
          sum += sc[i];
        }
      l_run[half] = l_run[half] * alpha[half] + sum;  // this thread's share; l sums fp32 p
    }
#pragma unroll
    for (int i = 0; i < HV / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    // P to bf16 in the A-operand layout, as two terms: hi = bf16(p) and
    // lo = bf16(p - hi), so that hi + lo is p within 2^-16 of itself (p - hi
    // is exact in fp32).  k-step kk takes accumulator registers 8 kk ..
    // 8 kk + 7 (columns 16 kk .. 16 kk + 15).
    uint32_t p_hi[kBN / 4], p_lo[kBN / 4];
#pragma unroll
    for (int i = 0; i < kBN / 4; ++i) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[2 * i], sc[2 * i + 1]);
      const float2 back = __bfloat1622float2(hi);
      p_hi[i] = *reinterpret_cast<const uint32_t*>(&hi);
      p_lo[i] = pack_bf16(sc[2 * i] - back.x, sc[2 * i + 1] - back.y);
    }

    // O += P_hi V + P_lo V over kBN / 16 k-steps of 16 kv rows (2 KB of V
    // each); an MN-major B whose 64-column panels lie kPanelBytes apart
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t dv = sw128_desc(sVs + kk * 16 * 128, kPanelBytes, 1024);
      wgmma_pv<HV>(o, p_hi + 4 * kk, dv);
      wgmma_pv<HV>(o, p_lo + 4 * kk, dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with stage s
  }

  // o / l, rows < S only, as bf16 pairs
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_run[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = r_lo + 8 * half;
    if (row >= p.S) continue;
    __nv_bfloat16* orow = p.o + (((long long)b * p.S + row) * p.Hq + h) * HV + 2 * t4;
#pragma unroll
    for (int n = 0; n < HV / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(o[4 * n + 2 * half] / l, o[4 * n + 2 * half + 1] / l);
  }
}

// ---- host ----
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes past the CUDA runtime's: the driver entry point is missing, or
// kErrEncode + the CUresult of a refused tensor map.
constexpr int kErrNoEntry = 1 << 20;
constexpr int kErrEncode = kErrNoEntry + 1;

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 4-d map of a bf16 [B, S, H, D] tensor, innermost first, with element
// strides sb, ss, sh; one box is 64 columns x 1 head x 128 rows x 1 batch,
// landing as 128 rows of 128 bytes in the 128-byte swizzle.
int make_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
             long long sb, long long ss, long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanelCols, 1, (cuuint32_t)kBN, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

template <int HD, int HV>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD, HV>();
  static_assert(smem + sizeof(uint64_t) * (1 + 2 * kStages) <= 232448,
                "dynamic and static shared memory past the card's 227 KB opt-in");
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_sm90<HD, HV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  flash_fwd_sm90<HD, HV><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,S,Hq,D], k [B,S,Hkv,D] and v [B,S,Hkv,Dv], bf16, with unit stride on
// the last dim and the given element strides of B, S and H, each a multiple
// of 8 (16 bytes), and 16-byte aligned bases; o contiguous [B,S,Hq,Dv];
// (D, Dv) one of (64, 64), (128, 128) and (192, 128), else
// cudaErrorInvalidValue.  Launches on `stream` and returns cudaGetLastError()
// without synchronising, or an error code of its own
// (flash_attention_sm90_error_string).
int flash_attention_sm90_launch(const void* q, const void* k, const void* v, void* o,
                                int B, int S, int Hq, int Hkv, int D, int Dv,
                                long long qsb, long long qss, long long qsh,
                                long long ksb, long long kss, long long ksh,
                                long long vsb, long long vss, long long vsh,
                                int causal, float scale, void* stream) {
  const int n_qt = (S + kBM - 1) / kBM;
  const bool pair = (D == 64 && Dv == 64) || (D == 128 && Dv == 128) || (D == 192 && Dv == 128);
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || !pair ||
      (long long)B * Hq > 0x7fffffffLL || n_qt > 65535)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEntry;
  CUtensorMap tq, tk, tv;
  int e = make_map(fn, &tq, q, B, S, Hq, D, qsb, qss, qsh);
  if (e == 0) e = make_map(fn, &tk, k, B, S, Hkv, D, ksb, kss, ksh);
  if (e == 0) e = make_map(fn, &tv, v, B, S, Hkv, Dv, vsb, vss, vsh);
  if (e != 0) return e;
  const Params p{static_cast<__nv_bfloat16*>(o), S, Hq, Hkv, causal, scale * kLog2e};
  const dim3 grid(B * Hq, n_qt);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 192) return (int)launch<192, 128>(tq, tk, tv, p, grid, s);
  if (D == 128) return (int)launch<128, 128>(tq, tk, tv, p, grid, s);
  return (int)launch<64, 64>(tq, tk, tv, p, grid, s);
}

const char* flash_attention_sm90_error_string(int err) {
  static thread_local char buf[96];
  if (err == kErrNoEntry) return "cuTensorMapEncodeTiled: no driver entry point";
  if (err >= kErrEncode) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
             err - kErrEncode);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
