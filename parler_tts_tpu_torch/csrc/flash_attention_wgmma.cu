// Training flash attention on Hopper's tensor cores (sm_90a): the bf16,
// head-dim-64 route of kernel K4, forward, dq and dk/dv.
//
// Replaces, for bf16 with Dh = 64, the Pallas TPU kernel `flash_attention`
// (parler_tts_tpu/ops/pallas/flash_attention.py): `_fwd_kernel` (:67),
// `_dq_kernel` (:144) and `_dkv_kernel` (:180). fp32, and bf16 with another
// head dim, stay on the SIMT kernels of csrc/flash_attention.cu. The
// semantics are those of that file and of `flash_attention_plain` in
// parler_tts_tpu_torch/ops/flash_attention.py: q (B, Tq, H, Dh) already
// scaled, k/v (B, Tk, H, Dh) (kv heads repeated to H outside), a (B, Tk)
// key-validity mask, query row i at absolute position q_offset + i; a masked
// score is -FLT_MAX, p is 0 wherever the mask or causality removes a key, l is
// clamped at 1e-30, so a query row with no valid key gets exactly 0 in o and in
// every gradient; scores in fp32 from bf16 operands; the online softmax walks
// 64-key tiles with m, l and acc in fp32; p is rounded to bf16 before p @ v and
// p^T @ do, ds before ds @ k and ds^T @ q; the forward writes o and the fp32
// logsumexp (B, H, Tq), the dq kernel dq and D = rowsum(do . o), which the
// dk/dv kernel then reads.
//
// What bounds it on this card: at mini-v1's training shape (B = 2, H = 16,
// T = 1040, Dh = 64, causal) the forward does 4.4 GFLOP on 17 MB (4.5 us of
// bf16 tensor-core time against 5.1 us of memory time), dq 6.6 GFLOP and
// dk/dv 8.9 GFLOP: operations and bytes are about even, so the kernels must
// run their products on the tensor cores and read each tile from device
// memory about once per block, with the loads of the next tile in flight
// behind the products of this one. Once they do, what is left is the
// per-element work between the products (masking, exp, rescaling, packing):
// 32 scores a thread a tile on the CUDA cores, which issue it about as slowly
// as the tensor cores do the four products. Two things keep it down: a warp
// whose 16 x 64 slice of the tile is wholly visible (every key valid and, if
// causal, before its first query) takes a path with no mask or causal test,
// and causal forward and dq blocks start with the last query tiles, which
// meet the most key tiles. exp is `expf`: the hardware's ex2.approx was
// faster but moved enough bf16 roundings of p and ds to leave the plain
// version's limits at T = 128.
//
// Design:
//   * every product is `wgmma.mma_async` m64n64k16 with bf16 operands and fp32
//     accumulators in registers, 4 per 64 x 64 x 64 product. S = Q K^T and
//     dP = dO V^T read both operands from shared memory (K-major); O += P V,
//     dQ += dS K, dV += P^T dO and dK += dS^T Q take P or dS from registers
//     (the S accumulator fragment is, packed to bf16 pairs, the A fragment of
//     the next product) and the B tile from shared memory with the transpose
//     bit set (MN-major), so no tile is ever transposed or rewritten;
//   * tiles are 64 rows x 64 bf16 = 128 bytes a row, brought in by TMA
//     (`cp.async.bulk.tensor.4d` over (Dh, H, T, B), box (64, 1, 64, 1)) into
//     128-byte-swizzled shared memory, the layout wgmma reads without bank
//     conflicts; TMA fills rows past T with zeros, and the mask, the causal
//     test and bounded stores govern every row at or past Tq or Tk. The tensor
//     maps are built on the host (cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint so the library needs no -lcuda) and passed as
//     __grid_constant__ parameters;
//   * one warpgroup (128 threads) per block and per 64-row tile: forward and
//     dq blocks own a query tile and walk the key tiles, the dk/dv block owns a
//     key tile and walks the query tiles (S^T = K Q^T, dP^T = V dO^T, lse and
//     D read per query column). The walked side is a two-stage ring: the tile
//     after next is loaded while this one's products run; completion is an
//     mbarrier per stage. Causal blocks stop at the last live key tile
//     (forward, dq) or start at the first live query tile (dk/dv);
//   * 40-48 KB of shared memory a block; registers (ptxas: about 128 for the
//     forward, 145 for dq, 207 for dk/dv, no spills) let two to four blocks
//     share an SM, so one block's products overlap another's per-element work.
// Left for later, on purpose: a producer warp with `setmaxnreg`, persistent
// blocks and clusters only move or share the loads, which two stages already
// keep ahead of the products; overlapping one tile's products with the
// previous tile's softmax inside a block (FlashAttention-3's ping-pong) needs
// a second score accumulator and is the next step. One backward pass with
// atomic dq would change the launch structure and make dq depend on the order
// of blocks. This version waits for each group of products before it uses
// their result.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                    // rows of every tile, and Dh
constexpr int kThreads = 128;                // one warpgroup
constexpr int kTileBytes = kTile * kTile * 2;  // 8 KB of bf16
constexpr float kNegInf = -FLT_MAX;

// ---------------------------------------------------------------- PTX wrappers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// rows [row0, row0 + 64) of head h of batch row b, all 64 columns
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int h,
                                         int row0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(0), "r"(h), "r"(row0), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled 64 x 64 bf16 tile:
// start address >> 4, leading byte offset (bits 16-29), stride byte offset
// (bits 32-45) = 1024 (eight 128-byte rows), layout 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// K-major operand (the reduction runs along a row): step kk of 16 columns
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
  return desc(smem_addr(tile) + kk * 32, 16);
}
// MN-major operand (the reduction runs down the rows): step kk of 16 rows
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk) {
  return desc(smem_addr(tile) + kk * 2048, 1024);
}

// the m64n64 fp32 accumulator of one warpgroup: thread (warp w, lane l) holds
// rows 16w + l/4 (+8) and columns 8j + 2(l%4) (+1): x[4j + 2i + c] is row
// 16w + l/4 + 8i, column 8j + 2(l%4) + c
struct Acc {
  float x[32];
};

__device__ __forceinline__ void acc_zero(Acc& a) {
#pragma unroll
  for (int i = 0; i < 32; ++i) a.x[i] = 0.f;
}

// keeps the compiler from moving reads or writes of `a` across a wgmma wait
__device__ __forceinline__ void acc_fence(Acc& a) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(a.x[i])::"memory");
}

// the bf16 A fragment of a 64 x 64 operand in registers: frag[kk] holds
// columns [16kk, 16kk + 16), the layout of the accumulator's x[8kk .. 8kk + 8)
struct Frag {
  uint32_t r[4][4];
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void frag_from(Frag& f, const Acc& a) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) f.r[kk][r] = pack_bf16(a.x[8 * kk + 2 * r], a.x[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ void frag_fence(Frag& f) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f.r[kk][r])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define ACC_OUT(a)                                                                              \
  "+f"(a.x[0]), "+f"(a.x[1]), "+f"(a.x[2]), "+f"(a.x[3]), "+f"(a.x[4]), "+f"(a.x[5]),          \
      "+f"(a.x[6]), "+f"(a.x[7]), "+f"(a.x[8]), "+f"(a.x[9]), "+f"(a.x[10]), "+f"(a.x[11]),     \
      "+f"(a.x[12]), "+f"(a.x[13]), "+f"(a.x[14]), "+f"(a.x[15]), "+f"(a.x[16]), "+f"(a.x[17]), \
      "+f"(a.x[18]), "+f"(a.x[19]), "+f"(a.x[20]), "+f"(a.x[21]), "+f"(a.x[22]), "+f"(a.x[23]), \
      "+f"(a.x[24]), "+f"(a.x[25]), "+f"(a.x[26]), "+f"(a.x[27]), "+f"(a.x[28]), "+f"(a.x[29]), \
      "+f"(a.x[30]), "+f"(a.x[31])
#define ACC_REGS                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B, A and B K-major in shared memory; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(Acc& d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC_OUT(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, A (16 columns of it) from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(Acc& d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (+)= A B^T over Dh = 64: A rows and B rows both 64 bf16 (K-major)
__device__ __forceinline__ void mma_abt(Acc& d, const void* a, const void* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(d, desc_k(a, kk), desc_k(b, kk), kk > 0);
}

// d += F B over 64 rows of B (MN-major), F from registers
__device__ __forceinline__ void mma_fb(Acc& d, const Frag& f, const void* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, f.r[kk], desc_mn(b, kk));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows row0 and row0 + 8 of `a` (x[4j + 2i + c], columns 8j + 2t + c),
// divided by den[i], into the bf16 tensor `out` of row stride `stride`; rows
// at or past n_rows are skipped
__device__ __forceinline__ void store_rows(const Acc& a, __nv_bfloat16* out, int row0, int n_rows,
                                           long stride, int t, const float (&den)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= n_rows) continue;
    __nv_bfloat16* dst = out + (long)row * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(a.x[4 * j + 2 * i] / den[i], a.x[4 * j + 2 * i + 1] / den[i]);
  }
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

constexpr int kSmemSlack = 1024;  // the dynamic buffer is aligned up to 1024 bytes by hand
constexpr int kFwdSmem = 5 * kTileBytes + kSmemSlack;  // Q, 2 x (K, V)
constexpr int kBwdSmem = 6 * kTileBytes + kSmemSlack;  // 2 fixed tiles, 2 x 2 ring tiles

__device__ __forceinline__ int live_k_tiles(int q0, int tk, int causal, int q_offset) {
  const int nk = (tk + kTile - 1) / kTile;
  if (!causal) return nk;
  return min(nk, (q_offset + q0 + kTile + kTile - 1) / kTile);
}

// validity of this thread's 16 key columns of tile k0 (bit 2j + c: column 8j + 2t + c)
__device__ __forceinline__ uint32_t key_bits(const uint8_t* mask_row, int k0, int tk, int t) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = k0 + 8 * j + 2 * t + c;
      if (key < tk && mask_row[key]) bits |= 1u << (2 * j + c);
    }
  return bits;
}

// true when every key of tile k0 is valid and, if causal, at or before the
// first of this warp's 16 query positions (first_qpos): the warp's whole
// 16 x 64 slice of the tile is visible and needs no masking (warp-uniform)
__device__ __forceinline__ bool tile_visible(uint32_t valid, int k0, int first_qpos, int causal) {
  return __all_sync(0xffffffffu, valid == 0xFFFFu) && (!causal || k0 + kTile - 1 <= first_qpos);
}

// whether key column 8j + 2t + c of tile k0 is visible from query position qpos
__device__ __forceinline__ bool visible(uint32_t valid, int j, int c, int k0, int qpos, int causal,
                                        int t) {
  return ((valid >> (2 * j + c)) & 1) && (!causal || k0 + 8 * j + 2 * t + c <= qpos);
}

// one key tile of the forward's online softmax for this thread's rows (query
// positions qpos0 and qpos0 + 8): scores s become p (unrounded), m, l and acc
// are rescaled. kMasked = false when the whole tile is visible.
template <bool kMasked>
__device__ __forceinline__ void online_softmax(Acc& s, Acc& acc, float (&m)[2], float (&l)[2],
                                               uint32_t valid, int k0, int qpos0, int causal,
                                               int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s.x[4 * j + 2 * i + c];
        if (kMasked && !visible(valid, j, c, k0, qpos0 + 8 * i, causal, t)) x = kNegInf;
        mx = fmaxf(mx, x);
      }
    const float m_new = fmaxf(m[i], quad_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s.x[4 * j + 2 * i + c];
        x = !kMasked || visible(valid, j, c, k0, qpos0 + 8 * i, causal, t) ? expf(x - m_new)
                                                                          : 0.f;
        sum += x;
      }
    const float alpha = expf(m[i] - m_new);
    l[i] = l[i] * alpha + quad_sum(sum);
    m[i] = m_new;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) acc.x[4 * j + 2 * i + c] *= alpha;
  }
}

// ds = p * (dp - D), p = e^(s - lse) where visible, for this thread's rows of
// the dq kernel (query positions qpos0, qpos0 + 8), written over s
template <bool kMasked>
__device__ __forceinline__ void dq_scores(Acc& s, const Acc& dp, const float (&lrow)[2],
                                          const float (&dsum)[2], uint32_t valid, int k0,
                                          int qpos0, int causal, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int x = 4 * j + 2 * i + c;
        const float pr = !kMasked || visible(valid, j, c, k0, qpos0 + 8 * i, causal, t)
                             ? expf(s.x[x] - lrow[i])
                             : 0.f;
        s.x[x] = pr * (dp.x[x] - dsum[i]);
      }
}

// the dk/dv kernel's transposed tiles for its keys key0 and key0 + 8 against
// query columns q0 + 8j + 2t + c: s^T becomes p^T, dp^T becomes ds^T
template <bool kMasked>
__device__ __forceinline__ void dkv_scores(Acc& s, Acc& dp, const float (&lq)[16],
                                           const float (&dd)[16], const bool (&key_ok)[2],
                                           int key0, int q0, int Tq, int causal, int q_offset,
                                           int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int x = 4 * j + 2 * i + c, q = q0 + 8 * j + 2 * t + c;
        const bool keep =
            !kMasked || (key_ok[i] && q < Tq && (!causal || key0 + 8 * i <= q + q_offset));
        const float pr = keep ? expf(s.x[x] - lq[2 * j + c]) : 0.f;
        s.x[x] = pr;
        dp.x[x] = pr * (dp.x[x] - dd[2 * j + c]);
      }
}

// ---------------------------------------------------------------- forward
__global__ void __launch_bounds__(kThreads)
k4_fwd_wgmma(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, const uint8_t* __restrict__ mask,
             __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int Tq, int Tk,
             int causal, int q_offset) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sKV = smem + kTileBytes;  // stage s: K at 2s, V at 2s + 1 tiles
  __shared__ uint64_t bar_q, bar_kv[2];

  // the last query tiles, which meet the most key tiles when causal, start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int nk = live_k_tiles(q0, Tk, causal, q_offset);
  if (tid == 0) {
    mbar_init(&bar_q);
    mbar_init(&bar_kv[0]);
    mbar_init(&bar_kv[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&bar_q, kTileBytes);
    tma_load(sQ, &map_q, &bar_q, h, q0, b);
    for (int s = 0; s < 2 && s < nk; ++s) {
      mbar_expect_tx(&bar_kv[s], 2 * kTileBytes);
      tma_load(sKV + 2 * s * kTileBytes, &map_k, &bar_kv[s], h, s * kTile, b);
      tma_load(sKV + (2 * s + 1) * kTileBytes, &map_v, &bar_kv[s], h, s * kTile, b);
    }
  }
  __syncthreads();

  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const uint8_t* mask_row = mask + (long)b * Tk;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  Acc acc, s;
  acc_zero(acc);
  acc_zero(s);
  Frag p;
  mbar_wait(&bar_q, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * kTile;
    const uint8_t* sK = sKV + 2 * st * kTileBytes;
    const uint8_t* sV = sK + kTileBytes;
    mbar_wait(&bar_kv[st], (kt >> 1) & 1);
    wgmma_fence();
    mma_abt(s, sQ, sK);
    wgmma_commit();
    const uint32_t valid = key_bits(mask_row, k0, Tk, t);
    wgmma_wait();
    acc_fence(s);

    if (tile_visible(valid, k0, row0 - g + q_offset, causal))
      online_softmax<false>(s, acc, m, l, valid, k0, row0 + q_offset, causal, t);
    else
      online_softmax<true>(s, acc, m, l, valid, k0, row0 + q_offset, causal, t);
    frag_from(p, s);  // p rounded to bf16 here, before p @ v
    wgmma_fence();
    mma_fb(acc, p, sV);
    wgmma_commit();
    wgmma_wait();
    acc_fence(acc);
    frag_fence(p);
    __syncthreads();  // every product that read stage st has completed
    if (tid == 0 && kt + 2 < nk) {
      mbar_expect_tx(&bar_kv[st], 2 * kTileBytes);
      tma_load(sKV + 2 * st * kTileBytes, &map_k, &bar_kv[st], h, k0 + 2 * kTile, b);
      tma_load(sKV + (2 * st + 1) * kTileBytes, &map_v, &bar_kv[st], h, k0 + 2 * kTile, b);
    }
  }

  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    den[i] = fmaxf(l[i], 1e-30f);
    const int row = row0 + 8 * i;
    if (t == 0 && row < Tq) lse[((long)b * H + h) * Tq + row] = m[i] + logf(den[i]);
  }
  store_rows(acc, o + ((long)b * Tq * H + h) * kTile, row0, Tq, (long)H * kTile, t, den);
}

// ---------------------------------------------------------------- dq and D
__global__ void __launch_bounds__(kThreads)
k4_dq_wgmma(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
            const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ o,
            const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
            __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int H, int Tq, int Tk,
            int causal, int q_offset) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sDO = smem + kTileBytes;
  uint8_t* sKV = smem + 2 * kTileBytes;
  __shared__ uint64_t bar_q, bar_kv[2];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int nk = live_k_tiles(q0, Tk, causal, q_offset);
  if (tid == 0) {
    mbar_init(&bar_q);
    mbar_init(&bar_kv[0]);
    mbar_init(&bar_kv[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&bar_q, 2 * kTileBytes);
    tma_load(sQ, &map_q, &bar_q, h, q0, b);
    tma_load(sDO, &map_do, &bar_q, h, q0, b);
    for (int s = 0; s < 2 && s < nk; ++s) {
      mbar_expect_tx(&bar_kv[s], 2 * kTileBytes);
      tma_load(sKV + 2 * s * kTileBytes, &map_k, &bar_kv[s], h, s * kTile, b);
      tma_load(sKV + (2 * s + 1) * kTileBytes, &map_v, &bar_kv[s], h, s * kTile, b);
    }
  }
  __syncthreads();

  // D = rowsum(do . o) in fp32 for this thread's rows (the 4 threads of a quad
  // share a row, 16 columns each), and the rows' logsumexp
  const int row0 = q0 + 16 * warp + g;
  const long stride = (long)H * kTile;
  const long qoff = ((long)b * Tq * H + h) * kTile;
  const long roff = ((long)b * H + h) * Tq;
  float dsum[2], lrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    float part = 0.f;
    if (row < Tq) {
      const __nv_bfloat16* orow = o + qoff + (long)row * stride + 16 * t;
      const __nv_bfloat16* drow = dout + qoff + (long)row * stride + 16 * t;
#pragma unroll
      for (int c = 0; c < 16; ++c)
        part = fmaf(__bfloat162float(drow[c]), __bfloat162float(orow[c]), part);
    }
    dsum[i] = quad_sum(part);
    lrow[i] = row < Tq ? lse[roff + row] : 0.f;
    if (t == 0 && row < Tq) delta[roff + row] = dsum[i];
  }

  const uint8_t* mask_row = mask + (long)b * Tk;
  Acc acc, s, dp;
  acc_zero(acc);
  acc_zero(s);
  acc_zero(dp);
  Frag ds;
  mbar_wait(&bar_q, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * kTile;
    const uint8_t* sK = sKV + 2 * st * kTileBytes;
    const uint8_t* sV = sK + kTileBytes;
    mbar_wait(&bar_kv[st], (kt >> 1) & 1);
    wgmma_fence();
    mma_abt(s, sQ, sK);
    mma_abt(dp, sDO, sV);
    wgmma_commit();
    const uint32_t valid = key_bits(mask_row, k0, Tk, t);
    wgmma_wait();
    acc_fence(s);
    acc_fence(dp);
    if (tile_visible(valid, k0, row0 - g + q_offset, causal))
      dq_scores<false>(s, dp, lrow, dsum, valid, k0, row0 + q_offset, causal, t);
    else
      dq_scores<true>(s, dp, lrow, dsum, valid, k0, row0 + q_offset, causal, t);
    frag_from(ds, s);  // ds rounded to bf16 here, before ds @ k
    wgmma_fence();
    mma_fb(acc, ds, sK);
    wgmma_commit();
    wgmma_wait();
    acc_fence(acc);
    frag_fence(ds);
    __syncthreads();
    if (tid == 0 && kt + 2 < nk) {
      mbar_expect_tx(&bar_kv[st], 2 * kTileBytes);
      tma_load(sKV + 2 * st * kTileBytes, &map_k, &bar_kv[st], h, k0 + 2 * kTile, b);
      tma_load(sKV + (2 * st + 1) * kTileBytes, &map_v, &bar_kv[st], h, k0 + 2 * kTile, b);
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows(acc, dq + qoff, row0, Tq, stride, t, one);
}

// ---------------------------------------------------------------- dk and dv
__global__ void __launch_bounds__(kThreads)
k4_dkv_wgmma(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
             const uint8_t* __restrict__ mask, const float* __restrict__ lse,
             const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, int H, int Tq, int Tk, int causal, int q_offset) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sK = smem;
  uint8_t* sV = smem + kTileBytes;
  uint8_t* sQD = smem + 2 * kTileBytes;  // stage s: Q at 2s, dO at 2s + 1 tiles
  __shared__ uint64_t bar_kv, bar_q[2];

  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int nq = (Tq + kTile - 1) / kTile;
  const int first = causal ? max(0, k0 - q_offset) / kTile : 0;
  const int n = nq - first;  // query tiles this key tile meets
  if (tid == 0 && n > 0) {
    mbar_init(&bar_kv);
    mbar_init(&bar_q[0]);
    mbar_init(&bar_q[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&bar_kv, 2 * kTileBytes);
    tma_load(sK, &map_k, &bar_kv, h, k0, b);
    tma_load(sV, &map_v, &bar_kv, h, k0, b);
    for (int s = 0; s < 2 && s < n; ++s) {
      mbar_expect_tx(&bar_q[s], 2 * kTileBytes);
      tma_load(sQD + 2 * s * kTileBytes, &map_q, &bar_q[s], h, (first + s) * kTile, b);
      tma_load(sQD + (2 * s + 1) * kTileBytes, &map_do, &bar_q[s], h, (first + s) * kTile, b);
    }
  }
  __syncthreads();

  const int key0 = k0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    key_ok[i] = key < Tk && mask[(long)b * Tk + key] != 0;
  }
  const bool all_keys_ok = __all_sync(0xffffffffu, key_ok[0] && key_ok[1]);
  const long roff = ((long)b * H + h) * Tq;
  Acc dka, dva, s, dp;
  acc_zero(dka);
  acc_zero(dva);
  acc_zero(s);
  acc_zero(dp);
  Frag pf, dsf;
  if (n > 0) mbar_wait(&bar_kv, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it & 1, q0 = (first + it) * kTile;
    const uint8_t* sQ = sQD + 2 * st * kTileBytes;
    const uint8_t* sDO = sQ + kTileBytes;
    mbar_wait(&bar_q[st], (it >> 1) & 1);
    wgmma_fence();
    mma_abt(s, sK, sQ);    // S^T: rows are keys, columns queries
    mma_abt(dp, sV, sDO);  // dP^T
    wgmma_commit();
    // the logsumexp and D of this thread's 16 query columns
    float lq[16], dq_[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = q0 + 8 * j + 2 * t + c;
        lq[2 * j + c] = q < Tq ? lse[roff + q] : 0.f;
        dq_[2 * j + c] = q < Tq ? delta[roff + q] : 0.f;
      }
    wgmma_wait();
    acc_fence(s);
    acc_fence(dp);
    // the warp's keys key0 - g .. key0 - g + 15 all valid, every query column
    // of the tile inside Tq and, if causal, at or after each of those keys
    const bool whole = all_keys_ok && q0 + kTile <= Tq &&
                       (!causal || key0 - g + 15 <= q0 + q_offset);
    if (whole)
      dkv_scores<false>(s, dp, lq, dq_, key_ok, key0, q0, Tq, causal, q_offset, t);
    else
      dkv_scores<true>(s, dp, lq, dq_, key_ok, key0, q0, Tq, causal, q_offset, t);
    frag_from(pf, s);    // p^T rounded to bf16, before p^T @ do
    frag_from(dsf, dp);  // ds^T rounded to bf16, before ds^T @ q
    wgmma_fence();
    mma_fb(dva, pf, sDO);
    mma_fb(dka, dsf, sQ);
    wgmma_commit();
    wgmma_wait();
    acc_fence(dva);
    acc_fence(dka);
    frag_fence(pf);
    frag_fence(dsf);
    __syncthreads();
    if (tid == 0 && it + 2 < n) {
      const int q2 = q0 + 2 * kTile;
      mbar_expect_tx(&bar_q[st], 2 * kTileBytes);
      tma_load(sQD + 2 * st * kTileBytes, &map_q, &bar_q[st], h, q2, b);
      tma_load(sQD + (2 * st + 1) * kTileBytes, &map_do, &bar_q[st], h, q2, b);
    }
  }
  const long koff = ((long)b * Tk * H + h) * kTile;
  const float one[2] = {1.f, 1.f};
  store_rows(dka, dk + koff, key0, Tk, (long)H * kTile, t, one);
  store_rows(dva, dv + koff, key0, Tk, (long)H * kTile, t, one);
}

// ---------------------------------------------------------------- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// the (B, T, H, 64) bf16 tensor at `ptr` as a 4-D map over (Dh, H, T, B) with a
// (64, 1, 64, 1) box into 128-byte-swizzled shared memory; rows past T read 0
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int T, int H) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)kTile * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)kTile, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, row * H, row * H * T};
  const cuuint32_t box[4] = {kTile, 1, kTile, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Checks the arguments and makes the current device's primary context current
// on this thread: cuTensorMapEncodeTiled is a driver call and needs one, and a
// thread that has made no runtime call yet (autograd runs the backward on its
// own) has none.
cudaError_t prepare(int dtype, int dh, int B, int H, int Tq, int Tk, int q_offset) {
  if (dtype != 1 || dh != kTile || B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || q_offset < 0)
    return cudaErrorInvalidValue;
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  return err != cudaSuccess ? err : cudaSetDevice(device);
}

}  // namespace

#define RETURN_IF(err)                 \
  do {                                 \
    const cudaError_t e_ = (err);      \
    if (e_ != cudaSuccess) return e_;  \
  } while (0)

// The same C interface as csrc/flash_attention.cu, for dtype 1 (bfloat16) and
// dh 64 only; anything else returns cudaErrorInvalidValue. Each returns the
// cudaError of its launch (or of building its tensor maps).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* o, void* lse, int dtype, int B,
                                   int H, int Tq, int Tk, int dh, int causal, int q_offset,
                                   void* stream) {
  RETURN_IF(prepare(dtype, dh, B, H, Tq, Tk, q_offset));
  CUtensorMap mq, mk, mv;
  RETURN_IF(make_map(&mq, q, B, Tq, H));
  RETURN_IF(make_map(&mk, k, B, Tk, H));
  RETURN_IF(make_map(&mv, v, B, Tk, H));
  RETURN_IF(cudaFuncSetAttribute(k4_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kFwdSmem));
  k4_fwd_wgmma<<<dim3((Tq + kTile - 1) / kTile, H, B), kThreads, kFwdSmem, (cudaStream_t)stream>>>(
      mq, mk, mv, (const uint8_t*)mask, (__nv_bfloat16*)o, (float*)lse, H, Tq, Tk, causal,
      q_offset);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v, const void* mask,
                                  const void* o, const void* lse, const void* dout, void* dq,
                                  void* delta, int dtype, int B, int H, int Tq, int Tk, int dh,
                                  int causal, int q_offset, void* stream) {
  RETURN_IF(prepare(dtype, dh, B, H, Tq, Tk, q_offset));
  CUtensorMap mq, mk, mv, mdo;
  RETURN_IF(make_map(&mq, q, B, Tq, H));
  RETURN_IF(make_map(&mk, k, B, Tk, H));
  RETURN_IF(make_map(&mv, v, B, Tk, H));
  RETURN_IF(make_map(&mdo, dout, B, Tq, H));
  RETURN_IF(cudaFuncSetAttribute(k4_dq_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kBwdSmem));
  k4_dq_wgmma<<<dim3((Tq + kTile - 1) / kTile, H, B), kThreads, kBwdSmem, (cudaStream_t)stream>>>(
      mq, mk, mv, mdo, (const uint8_t*)mask, (const __nv_bfloat16*)o, (const float*)lse,
      (const __nv_bfloat16*)dout, (__nv_bfloat16*)dq, (float*)delta, H, Tq, Tk, causal, q_offset);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v,
                                   const void* mask, const void* lse, const void* dout,
                                   const void* delta, void* dk, void* dv, int dtype, int B,
                                   int H, int Tq, int Tk, int dh, int causal, int q_offset,
                                   void* stream) {
  RETURN_IF(prepare(dtype, dh, B, H, Tq, Tk, q_offset));
  CUtensorMap mq, mk, mv, mdo;
  RETURN_IF(make_map(&mq, q, B, Tq, H));
  RETURN_IF(make_map(&mk, k, B, Tk, H));
  RETURN_IF(make_map(&mv, v, B, Tk, H));
  RETURN_IF(make_map(&mdo, dout, B, Tq, H));
  RETURN_IF(cudaFuncSetAttribute(k4_dkv_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kBwdSmem));
  k4_dkv_wgmma<<<dim3((Tk + kTile - 1) / kTile, H, B), kThreads, kBwdSmem, (cudaStream_t)stream>>>(
      mq, mk, mv, mdo, (const uint8_t*)mask, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, Tq, Tk, causal, q_offset);
  return (int)cudaGetLastError();
}
