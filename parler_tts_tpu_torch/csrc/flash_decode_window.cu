// Flash-decode attention at the speculative window, on the tensor cores, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_decode_attention` (`_decode_kernel`,
// parler_tts_tpu/ops/pallas/flash_decode.py) for a W-column query whose kv
// heads each carry more than 8 query rows (G * W > 8, G = H / H_kv, W > 1),
// over a bf16 cache; every other shape stays on csrc/flash_decode.cu. It
// computes what that kernel computes: for batch row b, window column w and
// query head h, softmax(q . K^T) . V over the cache slots [starts[b],
// limit_b + w), reading one layer of the stacked cache (L, B, S, H_kv * Dh)
// in place (the layer a pointer offset, rows and slots strides).
//
// What bounds it on this card: bytes. The window reads each kv head's valid
// prefix of K and V once for all its G * W query rows (2 * B * len * H_kv *
// Dh bf16 elements) and does 4 * G * W * Dh operations per slot, about 24
// operations a byte at W = 24, G = 1: far below the ~295 where the tensor
// cores become the limit. The Pallas kernel's structural win is that the W
// columns ride one cache stream as W * H columns of two matrix-unit dots;
// csrc/flash_decode.cu instead gives each 8-row tile of a kv head its own
// pass over the cache, and does the products in SIMT lanes with a long
// serial chain of shuffles. This kernel keeps the one stream:
//   * a block takes one (batch row, kv head, share of the slots) and holds
//     all R = G * W <= 64 query rows of that kv head, padded to MT 16-row
//     tiles (MT = 1, 2 or 4), so each share of K and V is read once,
//     whatever W is;
//   * K and V come in 64-slot tiles by cp.async 16-byte copies into a
//     three-stage ring in shared memory (rows padded by 16 bytes, so the
//     ldmatrix reads of 8 slot rows hit 8 different bank groups); slots past
//     the share are zero-filled, not read;
//   * both products run on the tensor cores, mma.sync m16n8k16 with bf16
//     operands and fp32 sums: S = Q . K^T with Q's A-fragments held in
//     registers for the whole loop and K's B-fragments by ldmatrix; O += P .
//     V with P's A-fragments built in registers from S's accumulators
//     (rounded to bf16) and V's B-fragments by ldmatrix.trans;
//   * each 64-slot tile is four 16-slot chunks; with MT row tiles the 4
//     warps take 4 x MT (row tile, chunk) pairs, warp w row tile w % MT and
//     MT of the chunks, each warp with its own running max, sum and
//     accumulator (one online-softmax step a tile; the per-row max needs one
//     4-lane shuffle, the rows of an mma fragment sitting in lane quads);
//   * at the end the warps of a row tile merge through shared memory in warp
//     order, and the blocks of a cluster through distributed shared memory
//     as csrc/flash_decode.cu does: rank j finishes a j-th slice of the R x
//     Dh outputs, every block pushes its (m, l) per row and its accumulator
//     for those outputs, four floats a store, into rank j's inbox with
//     st.async counted on an mbarrier, rank j merges them in rank order
//     (each rank's weight worked out once a row). No workspace, no atomics:
//     a repeated call gives the same bits.
// The cluster's shares cut [0, min(limit + W - 1, S)) by `share_of`, the rule
// of `split_bounds` in ops/flash_decode.py; the host picks the cluster size
// from shapes alone (`window_split_count`), so a captured launch stays valid
// as a device limit moves.
// Rounding: q is rounded to bf16; P is rounded to bf16 relative to the warp's
// running max before the P . V product (the plain version rounds relative to
// each share's max); the softmax state and the sums stay fp32 (__expf and a
// last __fdividef, each within a few fp32 ulp); the output is in q's dtype.
// A share with no valid slot keeps m = -FLT_MAX, l = 0 and acc = 0 and
// weighs exactly 0 in the merge; an empty range returns exactly 0.
// The plain PyTorch version with the same semantics is
// `flash_decode_attention_plain` in parler_tts_tpu_torch/ops/flash_decode.py;
// `splits=window_split_count(...)` repeats this kernel's shares and merge.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr int kMaxRows = 64;    // G * W query rows a kv head, at most
constexpr int kTile = 64;       // cache slots a ring stage holds
constexpr int kStages = 3;
constexpr int kChunk = 16;      // slots of one P . V product (its K depth)

typedef __nv_bfloat16 bf16;

// row stride of a ring tile, in bf16 elements: Dh plus 16 bytes, so that the
// 16-byte pieces ldmatrix reads from 8 consecutive slots fall in 8 bank groups
template <int DH>
__host__ __device__ constexpr int row_elems() { return DH + 8; }

template <int DH>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)kStages * 2 * kTile * row_elems<DH>() * 2;
}

template <int DH>
size_t smem_bytes() {
  // the ring; then every rank's (m, l) per row and this rank's slice of the
  // accumulators (at most R * Dh / n_split + 4 floats a rank)
  return ring_bytes<DH>() +
         sizeof(float) * (2 * kMaxSplits * kMaxRows + (size_t)kMaxRows * DH + 4 * kMaxSplits);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !in
__device__ __forceinline__ void copy16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b, one m16n8k16 product: bf16 operands, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The cluster barrier in two halves: arrive early, wait when needed.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Distributed shared memory pushes, counted by the receiver's mbarrier (as in
// csrc/flash_decode.cu): a block expects a number of bytes, each peer's
// st.async completes that many bytes of the count as it lands.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void push2(uint32_t peer_dst, float x, float y, uint32_t peer_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n"
      ::"r"(peer_dst), "r"(__float_as_uint(x)), "r"(__float_as_uint(y)), "r"(peer_bar)
      : "memory");
}
__device__ __forceinline__ void push4(uint32_t peer_dst, float4 v, uint32_t peer_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(peer_dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(peer_bar)
      : "memory");
}
__device__ __forceinline__ void inbox_init(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void inbox_wait(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar) : "memory");
  }
}

// Share `rank` of `n_split` of the slots [begin, end): ceil(len / n_split)
// slots each, the last ones fewer or none. Mirrors `split_bounds`.
__device__ __forceinline__ void share_of(int begin, int end, int rank, int n_split, int& lo,
                                         int& hi) {
  const int len = max(end - begin, 0);
  const int chunk = (len + n_split - 1) / n_split;
  lo = begin + min(rank * chunk, len);
  hi = begin + min((rank + 1) * chunk, len);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_decode_window_kernel(
    const void* __restrict__ q,        // (B, W, H, Dh), float or bf16, contiguous
    int q_bf16,                        // 1: q and out are bf16, 0: float
    const bf16* __restrict__ k,        // this layer's (B, S, H_kv * Dh) block
    const bf16* __restrict__ v,
    const int* __restrict__ starts,    // (B,)
    const int* __restrict__ limits,    // (B,), or null: use limit_scalar
    int limit_scalar,
    void* __restrict__ out,            // (B, W, H, Dh), q's dtype
    int W, int H, int H_kv, int S, long long stride_b, long long stride_s, int mt) {
  constexpr int KC = DH / 16;          // 16-deep chunks of Dh: Q . K^T products
  constexpr int NT = DH / 8;           // 8-wide tiles of Dh: P . V products
  constexpr int ROW = row_elems<DH>();
  constexpr int PIECES = DH / 8;       // 16-byte pieces of a slot's row
  constexpr int kMaxChunks = kTile / kChunk;  // a warp's chunks of a tile, at most
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int G = H / H_kv;
  const int R = G * W;                 // query rows of this kv head, r = w * G + g
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int quad = lane >> 2, tq = lane & 3;  // an mma fragment's row and column pair
  const int n_out = R * DH;
  // rank j finishes the outputs [j * per, (j + 1) * per), per a multiple of
  // 4 so that the merge moves float4s that never straddle two ranks
  const int per = (n_out + 4 * n_split - 1) / (4 * n_split) * 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // kStages x {K, V} x kTile x ROW
  // what peers push: every rank's (m, l) per row, this rank's slice of every
  // rank's accumulators
  float2* in_ml = reinterpret_cast<float2*>(smem_raw + ring_bytes<DH>());  // n_split x kMaxRows
  float* in_acc = reinterpret_cast<float*>(in_ml + kMaxSplits * kMaxRows);  // n_split x per
  // after the loop the ring holds the block's own merge (local only: peers
  // push into in_*, never into the ring)
  float* w_m = reinterpret_cast<float*>(smem_raw);  // kWarps x 16: each warp's state
  float* w_l = w_m + kWarps * 16;
  float* w_wgt = w_l + kWarps * 16;                 // kWarps x 16: its weight in the block
  float* fin_w = w_wgt + kWarps * 16;               // kMaxSplits x kMaxRows: each rank's
  float* fin_l = fin_w + kMaxSplits * kMaxRows;     // kMaxRows: the merged sums
  float* w_acc = fin_l + kMaxRows;                  // kWarps x 16 x DH
  __shared__ alignas(8) unsigned long long inbox;   // counts the peers' bytes in

  // the shares cut [0, end), not [start, end): with a limit passed by value
  // the first loads go out before the row's start has arrived; slots below
  // start are masked in the softmax
  const int start = starts[b];
  const int limit = limits != nullptr ? limits[b] : limit_scalar;
  const int end = min(limit + W - 1, S);
  int lo, hi;
  share_of(0, end, rank, n_split, lo, hi);
  const int n_tiles = (hi - lo + kTile - 1) / kTile;

  const long long head = (long long)b * stride_b + (long long)kvh * DH;
  const bf16* kb = k + head;
  const bf16* vb = v + head;
  const uint32_t ring_base = smem_addr(ring);
  // tile i of the share into stage i % kStages: K then V, one commit group
  // each, so that Q . K^T and the softmax run while V is still in flight
  auto load_tile = [&](int i) {
    const int t0 = lo + i * kTile;
    const uint32_t kdst = ring_base + (uint32_t)((i % kStages) * 2 * kTile * ROW * 2);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const bf16* src = part == 0 ? kb : vb;
      const uint32_t dst = kdst + (uint32_t)(part * kTile * ROW * 2);
      for (int c = tid; c < kTile * PIECES; c += kThreads) {
        const int slot = c / PIECES, piece = c - slot * PIECES;
        const int t = t0 + slot;
        const bool in = t < hi;
        copy16(dst + (uint32_t)((slot * ROW + piece * 8) * 2),
               src + (in ? (long long)t * stride_s + piece * 8 : 0), in);
      }
      copy_commit();
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) {
      load_tile(i);
    } else {  // empty groups keep the count of groups per tile at two
      copy_commit();
      copy_commit();
    }
  }
  // with the first tiles in flight: the inbox, then the first half of "every
  // block of the cluster has started" (its inbox ready), so that a peer may
  // push into it; its wait comes after the loop
  if (tid == 0) {
    const int mine = max(min(per, n_out - rank * per), 0);
    inbox_init(smem_addr(&inbox), (n_split - 1) * 4 * (2 * R + mine));
  }
  cluster_arrive_relaxed();

  // this warp's row tile and its two rows of each fragment: rows
  // mrow + quad and mrow + quad + 8 of the kv head
  const int mrow = (warp % mt) * 16;
  int row_end[2];
  uint32_t qa[KC][4];  // Q's A-fragments, rounded to bf16, for the whole loop
  {
    const bool qb = q_bf16 != 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mrow + quad + 8 * half;
      const bool on = r < R;
      const int w = on ? r / G : 0;
      const int h = kvh * G + (on ? r - w * G : 0);
      row_end[half] = on ? limit + w : INT_MIN;
      const long long base = (((long long)b * W + w) * H + h) * DH;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {  // columns 2 tq (+1) and 2 tq + 8 (+1)
          const long long at = base + kc * 16 + hk * 8 + 2 * tq;
          float x0 = 0.f, x1 = 0.f;
          if (on) {
            if (qb) {
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(q) + at));
              x0 = f.x, x1 = f.y;
            } else {
              const float2 f = *reinterpret_cast<const float2*>(static_cast<const float*>(q) + at);
              x0 = f.x, x1 = f.y;
            }
          }
          qa[kc][half + 2 * hk] = pack_bf16(x0, x1);  // a0/a1: columns 2 tq, a2/a3: + 8
        }
      }
    }
  }

  // per row (two a thread): the warp's running max m (the same in the four
  // lanes of a quad), and this lane's share of the running sum l; the
  // accumulator o[nt] holds columns nt * 8 + 2 tq (+1) of both rows
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  // this warp's chunks of each tile: warp / mt + j * (kWarps / mt), j < mt
  const int chunk0 = warp / mt, chunk_step = kWarps / mt;
  // ldmatrix addresses: lane l gives row l % 8 of matrix l / 8
  const int lrow = lane & 7, lmat = lane >> 3;
  const uint32_t k_lane = (uint32_t)((((lmat >> 1) * 8 + lrow) * ROW + (lmat & 1) * 8) * 2);
  const uint32_t v_lane = (uint32_t)((((lmat & 1) * 8 + lrow) * ROW + (lmat >> 1) * 8) * 2);

  for (int i = 0; i < n_tiles; ++i) {
    if (i + kStages - 1 < n_tiles) {
      load_tile(i + kStages - 1);
    } else {
      copy_commit();
      copy_commit();
    }
    // tile i's K is in once no more than its V and the two later tiles'
    // groups are pending: this thread's copies, then every thread's
    copy_wait<2 * kStages - 1>();
    __syncthreads();
    const int t0 = lo + i * kTile;
    const uint32_t ks = ring_base + (uint32_t)((i % kStages) * 2 * kTile * ROW * 2);
    const uint32_t vs = ks + (uint32_t)(kTile * ROW * 2);
    // S = Q . K^T over the warp's chunks of 16 slots, two 8-slot tiles each;
    // a chunk wholly past the share is skipped (the same in every lane)
    float s[kMaxChunks][2][4];
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = chunk0 + j * chunk_step;
#pragma unroll
      for (int e = 0; e < 8; ++e) s[j][e >> 2][e & 3] = 0.f;
      if (j >= mt || t0 + c * kChunk >= hi) continue;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t kf[4];  // slots 0-7 (depth 0-7, 8-15), slots 8-15 (the same)
        ldmatrix_x4(kf, ks + (uint32_t)(c * kChunk * ROW * 2) + k_lane + kc * 32);
        mma(s[j][0], qa[kc], kf[0], kf[1]);
        mma(s[j][1], qa[kc], kf[2], kf[3]);
      }
    }
    // online softmax per row, one step a tile: slot t is seen by the row iff
    // start <= t < min(hi, limit + w)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int bound = min(hi, row_end[half]);
      float mx = m[half];
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + (chunk0 + j * chunk_step) * kChunk + (e >> 1) * 8 + 2 * tq +
                        (e & 1);
          if (j < mt && t >= start && t < bound) mx = fmaxf(mx, s[j][e >> 1][2 * half + (e & 1)]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = __expf(m[half] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + (chunk0 + j * chunk_step) * kChunk + (e >> 1) * 8 + 2 * tq +
                        (e & 1);
          float& se = s[j][e >> 1][2 * half + (e & 1)];
          se = j < mt && t >= start && t < bound ? __expf(se - mx) : 0.f;  // now P
          sum += se;
        }
      l[half] = l[half] * alpha + sum;
      m[half] = mx;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][2 * half] *= alpha;
        o[nt][2 * half + 1] *= alpha;
      }
    }
    copy_wait<2 * kStages - 2>();  // tile i's V
    __syncthreads();
    // O += P . V, chunk by chunk: P's A-fragment (rows quad, quad + 8; slots
    // 2 tq (+1) and 2 tq + 8 (+1)) from S's accumulators, V's B-fragments by
    // ldmatrix.trans, two 8-wide tiles of Dh a load
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = chunk0 + j * chunk_step;
      if (j >= mt || t0 + c * kChunk >= hi) continue;
      const uint32_t pa[4] = {pack_bf16(s[j][0][0], s[j][0][1]), pack_bf16(s[j][0][2], s[j][0][3]),
                              pack_bf16(s[j][1][0], s[j][1][1]), pack_bf16(s[j][1][2], s[j][1][3])};
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t vf[4];  // Dh 0-7 (slots 0-7, 8-15), Dh 8-15 (the same)
        ldmatrix_x4_trans(vf, vs + (uint32_t)(c * kChunk * ROW * 2) + v_lane + dp * 32);
        mma(o[2 * dp], pa, vf[0], vf[1]);
        mma(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // the stage is free for the load of tile i + kStages
  }
  copy_wait<0>();
  __syncthreads();

  // the warp's state into the ring (now free): the quad's sums first
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const int rl = quad + 8 * half;
    if (tq == 0) {
      w_m[warp * 16 + rl] = m[half];
      w_l[warp * 16 + rl] = l[half];
    }
    float* row = w_acc + (warp * 16 + rl) * DH + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<float2*>(row + nt * 8) = make_float2(o[nt][2 * half], o[nt][2 * half + 1]);
  }
  __syncthreads();
  // per row: the block's max and sum over the warps of its row tile (wt,
  // wt + mt, ...) in warp order, and each warp's weight
  float mb = -FLT_MAX, lb = 0.f;
  if (tid < R) {
    const int rl = tid & 15, wt = tid >> 4;
    for (int wp = wt; wp < kWarps; wp += mt) mb = fmaxf(mb, w_m[wp * 16 + rl]);
    for (int wp = wt; wp < kWarps; wp += mt) {
      const float wgt = __expf(w_m[wp * 16 + rl] - mb);
      w_wgt[wp * 16 + rl] = wgt;
      lb = fmaf(w_l[wp * 16 + rl], wgt, lb);
    }
  }
  __syncthreads();
  cluster_wait();  // every peer has started: its inbox takes our state

  // the block's state, pushed into the inbox of the rank that finishes each
  // output (st.async into a peer's shared memory; plain stores to our own)
  const uint32_t bar = smem_addr(&inbox);
  if (tid < R) {
    for (int j = 0; j < n_split; ++j) {
      if (j == rank)
        in_ml[rank * kMaxRows + tid] = make_float2(mb, lb);
      else
        push2(peer_addr(smem_addr(in_ml + rank * kMaxRows + tid), j), mb, lb,
              peer_addr(bar, j));
    }
  }
  for (int i = 4 * tid; i < n_out; i += 4 * kThreads) {
    const int r = i / DH, d = i - (i / DH) * DH;
    const int rl = r & 15, wt = r >> 4;
    float4 ab = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int wp = wt; wp < kWarps; wp += mt) {
      const float wgt = w_wgt[wp * 16 + rl];
      const float4 a = *reinterpret_cast<const float4*>(w_acc + (wp * 16 + rl) * DH + d);
      ab.x = fmaf(a.x, wgt, ab.x), ab.y = fmaf(a.y, wgt, ab.y);
      ab.z = fmaf(a.z, wgt, ab.z), ab.w = fmaf(a.w, wgt, ab.w);
    }
    const int owner = i / per;
    float* dst = in_acc + rank * per + (i - owner * per);
    if (owner == rank)
      *reinterpret_cast<float4*>(dst) = ab;
    else
      push4(peer_addr(smem_addr(dst), owner), ab, peer_addr(bar, owner));
  }
  __syncthreads();   // our own share of the inbox is in
  inbox_wait(bar);   // and every peer's; nothing touches our memory after this

  // this rank's outputs, from every rank's state in rank order: first per
  // row, each rank's weight and the merged sum
  const int o_lo = min(n_out, rank * per), o_hi = min(n_out, (rank + 1) * per);
  const int r_lo = o_lo / DH, r_hi = (o_hi + DH - 1) / DH;
  if (tid < r_hi - r_lo) {
    const int r = r_lo + tid;
    float mm = -FLT_MAX;
    for (int j = 0; j < n_split; ++j) mm = fmaxf(mm, in_ml[j * kMaxRows + r].x);
    float ll = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const float2 ml = in_ml[j * kMaxRows + r];
      const float wgt = __expf(ml.x - mm);
      fin_w[j * kMaxRows + r] = wgt;
      ll = fmaf(ml.y, wgt, ll);
    }
    fin_l[r] = fmaxf(ll, 1e-30f);
  }
  __syncthreads();
  for (int i = o_lo + 4 * tid; i < o_hi; i += 4 * kThreads) {
    const int r = i / DH, d = i - (i / DH) * DH;
    float4 aa = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < n_split; ++j) {
      const float wgt = fin_w[j * kMaxRows + r];
      const float4 a = *reinterpret_cast<const float4*>(in_acc + j * per + (i - o_lo));
      aa.x = fmaf(a.x, wgt, aa.x), aa.y = fmaf(a.y, wgt, aa.y);
      aa.z = fmaf(a.z, wgt, aa.z), aa.w = fmaf(a.w, wgt, aa.w);
    }
    const float ll = fin_l[r];
    const float4 y = make_float4(__fdividef(aa.x, ll), __fdividef(aa.y, ll),
                                 __fdividef(aa.z, ll), __fdividef(aa.w, ll));
    const int w = r / G, h = kvh * G + (r - w * G);
    const long long at = (((long long)b * W + w) * H + h) * DH + d;
    if (q_bf16) {
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + at);
      dst[0] = __floats2bfloat162_rn(y.x, y.y);
      dst[1] = __floats2bfloat162_rn(y.z, y.w);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + at) = y;
    }
  }
}

template <int DH>
int launch(const void* q, int q_bf16, const void* k, const void* v, const int* starts,
           const int* limits, int limit_scalar, void* out, int B, int W, int H, int H_kv, int S,
           long long layer_offset, long long stride_b, long long stride_s, int n_split,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();  // 75 KB at Dh 64, 141 KB at Dh 128
  // the shared-memory ceiling, raised once per Dh and device at the first
  // launch, so that a launch captured into a CUDA graph makes no such call
  static unsigned long long sized = 0;  // a bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  if (!(sized >> device & 1ull)) {
    err = cudaFuncSetAttribute(flash_decode_window_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    sized |= 1ull << device;
  }
  const int rows = (H / H_kv) * W;
  const int mt = rows <= 16 ? 1 : rows <= 32 ? 2 : 4;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, H_kv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bf16* kl = static_cast<const bf16*>(k) + layer_offset;
  const bf16* vl = static_cast<const bf16*>(v) + layer_offset;
  err = cudaLaunchKernelEx(&cfg, flash_decode_window_kernel<DH>, q, q_bf16, kl, vl, starts,
                           limits, limit_scalar, out, W, H, H_kv, S, stride_b, stride_s, mt);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q_dtype: 0 = float32, 1 = bfloat16 (out is the same); K/V are bf16. `limits`
// may be null, then every row uses `limit_scalar`. Strides are in elements;
// the layer's block starts at layer * stride_l. Takes W > 1, 8 < G * W <= 64
// and Dh a multiple of 16 up to 128. `n_split` (1, 2, 4 or 8) is the cluster
// size: the shares each row's slots are cut into. Returns a cudaError_t (0 =
// launched).
int flash_decode_window_launch(const void* q, const void* k, const void* v, const void* starts,
                               const void* limits, int limit_scalar, void* out, int q_dtype,
                               int B, int W, int H, int H_kv, int Dh, int S, int layer,
                               int stride_l, int stride_b, int stride_s, int n_split,
                               void* stream) {
  if (B <= 0 || W <= 1 || H_kv <= 0 || H % H_kv != 0 || (q_dtype != 0 && q_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int rows = (H / H_kv) * W;
  if (rows <= 8 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  if (n_split < 1 || n_split > kMaxSplits || (n_split & (n_split - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (stride_s % 8 != 0 || stride_b % 8 != 0 || stride_l % 8 != 0 ||
      (reinterpret_cast<unsigned long long>(k) % 16) != 0 ||
      (reinterpret_cast<unsigned long long>(v) % 16) != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long layer_offset = (long long)layer * stride_l;
  const int* st = static_cast<const int*>(starts);
  const int* li = static_cast<const int*>(limits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WINDOW_CASE(DH)                                                                      \
  case DH:                                                                                   \
    return launch<DH>(q, q_dtype, k, v, st, li, limit_scalar, out, B, W, H, H_kv, S,          \
                      layer_offset, stride_b, stride_s, n_split, s);
  switch (Dh) {
    WINDOW_CASE(16)
    WINDOW_CASE(32)
    WINDOW_CASE(48)
    WINDOW_CASE(64)
    WINDOW_CASE(80)
    WINDOW_CASE(96)
    WINDOW_CASE(112)
    WINDOW_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WINDOW_CASE
}

}  // extern "C"
