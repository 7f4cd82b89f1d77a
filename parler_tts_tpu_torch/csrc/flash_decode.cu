// Flash-decode attention over the static KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_decode_attention` (`_decode_kernel`,
// parler_tts_tpu/ops/pallas/flash_decode.py). It computes, for every batch
// row b and query head h, softmax(q . K^T) . V over the cache slots
// [starts[b], limit_b + w) of window column w, reading one layer of the
// stacked cache (L, B, S, H_kv * Dh) in place: the layer is a pointer offset,
// rows and slots are strides, so no per-layer copy is made.
//
// What bounds it on this card: bytes. Each decode step reads the valid
// prefix of K and V once (2 * B * len * H_kv * Dh elements) and does about
// 4 * H * Dh operations per slot read, far below the ~295 operations per
// byte where Hopper's tensor cores become the limit. At decode sizes (B = 2,
// 16 kv heads) one block per (kv head, row) leaves most of the 132 SMs idle
// and each block walks its prefix alone, so the design splits the slots.
//
// Design (split-KV in one launch, merged on chip):
//   * grid (n_split, H_kv * row tiles, B) in clusters of n_split blocks along
//     x (n_split a power of two up to 8, the portable cluster size, chosen on
//     the host from B, H_kv and S only, never from the limit); block `rank`
//     of a cluster takes share `rank` of the row's slots [0, end), cut by
//     `share_of` (the rule of `split_bounds` in ops/flash_decode.py; from
//     slot 0, not from the row's start, so that with a limit passed by value
//     the first loads need no value read on the device), and up
//     to 8 of the G * W query rows of its kv head (a row tile), so GQA/MQA
//     rows share one pass over the cache;
//   * inside a block, a group of Dh * itemsize / 16 lanes (rounded up to a
//     power of two) owns one cache slot at a time: each lane loads 16 bytes
//     of K and of V straight into registers, the group sums its partial dot
//     products with shuffles; passes of 4 slots per group (64 slots per
//     pass of 128 threads at bf16 Dh 64) are double-buffered in registers,
//     the next pass's K and V issued before this pass's arithmetic;
//   * each warp keeps one running max per query row (a shuffle max over its
//     groups after each pass), and each lane its share of the running sum
//     and accumulator in fp32; at the end the warp's groups merge by
//     shuffle sums and the 4 warps through shared memory, in warp order;
//   * the blocks of a cluster then merge through distributed shared memory:
//     rank j finishes a j-th slice of the tile's R x Dh outputs. Each block
//     pushes its (m, l) and its accumulator for those outputs into rank j's
//     inbox with st.async, which counts the bytes on the inbox's mbarrier as
//     they land; rank j waits on that count, not on a cluster barrier, and
//     merges its slice from its own shared memory in rank order (weights
//     e^(m_i - M), then division by max(l, 1e-30)). One cluster barrier,
//     split, comes before the pushes: it tells a block that its peers have
//     started and set up their inboxes; its arrive is issued with the first
//     loads in flight and its wait after the main loop. No block reads a
//     peer, so none has to outlive its peers. No workspace, no atomics: a
//     repeated call gives the same bits.
// Rounding: q is rounded to the cache dtype; P is rounded to the cache dtype
// relative to the warp's running max before the P . V product, as the
// Pallas kernel feeds its matrix unit (it rounds relative to its tile's
// running max, the plain version relative to each share's max); only fp32
// values are rescaled after that. The softmax state and the accumulators stay
// fp32 (exp is the hardware's approximation __expf and the last division
// __fdividef, each within a few fp32 ulp); the output is in q's dtype. A
// share with no valid slot keeps m = -FLT_MAX, l = 0 and acc = 0, and weighs
// exactly 0 in the merge; an empty range returns exactly 0.
// The plain PyTorch version with the same semantics is
// `flash_decode_attention_plain` in parler_tts_tpu_torch/ops/flash_decode.py
// (`splits=n` repeats this kernel's shares and merge).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr int kMaxRowBytes = 512;  // Dh * itemsize: 32 lanes of 16 bytes

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the precision of T
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(&raw);
  out[0] = f.x, out[1] = f.y, out[2] = f.z, out[3] = f.w;
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x, out[2 * i + 1] = f.y;
  }
}

// The cluster barrier in two halves: arrive early, wait when needed.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Distributed shared memory pushes, counted by the receiver's mbarrier: a
// block expects a number of bytes, each peer's st.async completes that many
// bytes of the count as it lands, and try_wait returns once all are in.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void push(uint32_t peer_dst, float v, uint32_t peer_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(peer_dst), "r"(__float_as_uint(v)), "r"(peer_bar) : "memory");
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

// Query rows one block holds (mirrors `row_tile` in ops/flash_decode.py).
int row_tile(int rows) { return rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : 8; }

// Lanes per slot group: Dh's 16-byte vectors rounded up to a power of two.
int group_lanes(int dh, int elem) {
  const int nvec = dh * elem / 16;
  int gs = 1;
  while (gs < nvec) gs <<= 1;
  return gs;
}

size_t smem_bytes(int rt, int dh) {
  // the warps' (m, l, acc) per row; every rank's (m, l) and slice of acc
  return sizeof(float) * ((size_t)kWarps * rt * (dh + 2) + 2 * kMaxSplits * rt +
                          (size_t)rt * dh + kMaxSplits);
}

template <typename QT, typename KVT, int RT>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const QT* __restrict__ q,           // (B, W, H, Dh), contiguous
    const KVT* __restrict__ k,          // this layer's (B, S, H_kv * Dh) block
    const KVT* __restrict__ v,
    const int* __restrict__ starts,     // (B,)
    const int* __restrict__ limits,     // (B,), or null: use limit_scalar
    int limit_scalar,
    QT* __restrict__ out,               // (B, W, H, Dh)
    int W, int H, int H_kv, int Dh, int S,
    long long stride_b, long long stride_s, int gs_log2) {
  constexpr int kVec = 16 / sizeof(KVT);                 // elements per 16-byte load
  constexpr int kU = RT <= 2 ? 4 : (RT == 4 ? 2 : 1);    // slots per group and pass
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int G = H / H_kv;
  const int R = G * W;  // query rows of this kv head, r = w * G + g
  const int n_out = RT * Dh;                        // outputs of the tile
  const int per = (n_out + n_split - 1) / n_split;  // rank j finishes [j * per, ...)
  extern __shared__ float smem[];
  float* w_m = smem;                      // kWarps x RT
  float* w_l = w_m + kWarps * RT;         // kWarps x RT
  float* w_acc = w_l + kWarps * RT;       // kWarps x RT x Dh
  float* in_m = w_acc + kWarps * n_out;   // n_split x RT: every rank's state, pushed here
  float* in_l = in_m + kMaxSplits * RT;   // n_split x RT
  float* in_acc = in_l + kMaxSplits * RT; // n_split x per: this rank's slice of them
  __shared__ alignas(8) unsigned long long inbox;  // counts the peers' bytes in
  const int n_rt = (R + RT - 1) / RT;
  const int kvh = blockIdx.y / n_rt;
  const int rt = blockIdx.y - kvh * n_rt;
  const int b = blockIdx.z;
  const int nvec = Dh / kVec;
  const int gs = 1 << gs_log2;
  const int ng = kThreads >> gs_log2;
  const int tid = threadIdx.x;
  const int grp = tid >> gs_log2;
  const int c = tid & (gs - 1);  // this lane's 16-byte vector of a head row
  const bool lane_on = c < nvec;

  // the shares cut [0, end), not [start, end): with a limit passed by value
  // the first loads go out before the row's start has arrived; the slots
  // below start are masked in the softmax
  const int start = starts[b];
  const int limit = limits != nullptr ? limits[b] : limit_scalar;
  const int end = min(limit + W - 1, S);  // the last column sees limit + W - 1 slots
  int lo, hi;
  share_of(0, end, rank, n_split, lo, hi);

  // this lane's slice of each query row of the tile, rounded to the cache dtype
  float qf[RT][kVec];
  int row_end[RT];  // slot bound of the row's window column (limit + w)
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int rr = rt * RT + r;
    const bool on = rr < R;
    const int w = on ? rr / G : 0;
    const int h = kvh * G + (on ? rr - w * G : 0);
    row_end[r] = on ? limit + w : INT_MIN;
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      qf[r][e] = on && lane_on
                     ? round_to<KVT>(to_float(q[(((long long)b * W + w) * H + h) * Dh +
                                                c * kVec + e]))
                     : 0.f;
  }

  // per row: the warp's running max m (the same in every lane), and this
  // lane's share of the running sum l and of the accumulator, for the slots
  // of its group; all are rescaled by the same factor, so the warp's groups
  // merge by plain sums at the end
  float m[RT], l[RT], acc[RT][kVec];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = -FLT_MAX;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
  }

  const long long head = (long long)b * stride_b + (long long)kvh * Dh + c * kVec;
  const KVT* kb = k + head;
  const KVT* vb = v + head;
  // passes of kU slots per group, double-buffered in registers: every load
  // of a pass is issued before the previous pass's arithmetic; K and V are
  // read once, so they stream past the caches (evict first)
  auto load_pass = [&](int t0, uint4 (&kr)[kU], uint4 (&vr)[kU]) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + u * ng + grp;
      if (t < hi && lane_on) {
        kr[u] = __ldcs(reinterpret_cast<const uint4*>(kb + (long long)t * stride_s));
        vr[u] = __ldcs(reinterpret_cast<const uint4*>(vb + (long long)t * stride_s));
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
  };
  auto compute_pass = [&](int t0, const uint4 (&kr)[kU], const uint4 (&vr)[kU]) {
    // scores: partial dot products summed over the group's lanes (an xor
    // butterfly, so every lane of the group holds the same sum)
    // u-passes wholly past the share are skipped (the test is the same for
    // every thread of the block)
    float s[kU][RT];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (t0 + u * ng >= hi) break;
      float kf[kVec];
      unpack(kr[u], kf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qf[r][e], kf[e], dot);
        for (int o = 1; o < gs; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[u][r] = dot;
      }
    }
    // online softmax per row; slot t is seen by the row iff
    // start <= t < limit + w (and t < hi, in the share)
    float p[RT][kU];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 + u * ng + grp;
        if (t0 + u * ng >= hi) break;
        if (t >= start && t < hi && t < row_end[r]) mx = fmaxf(mx, s[u][r]);
      }
      for (int o = gs; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float alpha = __expf(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 + u * ng + grp;
        if (t0 + u * ng >= hi) break;
        const float pu = t >= start && t < hi && t < row_end[r] ? __expf(s[u][r] - mx) : 0.f;
        sum += pu;
        p[r][u] = round_to<KVT>(pu);
      }
      l[r] = l[r] * alpha + sum;
      m[r] = mx;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (t0 + u * ng >= hi) break;
      float vf[kVec];
      unpack(vr[u], vf);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(p[r][u], vf[e], acc[r][e]);
    }
  };
  const int step = ng * kU;
  uint4 kbuf0[kU], vbuf0[kU], kbuf1[kU], vbuf1[kU];
  load_pass(lo, kbuf0, vbuf0);
  // with the first pass in flight: the inbox, then the first half of "every
  // block of the cluster has started" (its inbox ready), so that a peer may
  // push into it; its wait comes after the loop
  if (tid == 0) {
    const int mine = max(min(per, n_out - rank * per), 0);
    inbox_init(smem_addr(&inbox), (n_split - 1) * 4 * (2 * RT + mine));
  }
  cluster_arrive_relaxed();
  // where this thread's first output goes, worked out while loads are in flight
  const int i0 = rank * per + tid;
  const int r0 = i0 / Dh, rr0 = rt * RT + r0;
  const int w0 = rr0 / G;
  const long long out0 = (((long long)b * W + w0) * H + kvh * G + (rr0 - w0 * G)) * Dh +
                         (i0 - r0 * Dh);

  for (int t0 = lo; t0 < hi; t0 += 2 * step) {
    if (t0 + step < hi) load_pass(t0 + step, kbuf1, vbuf1);
    compute_pass(t0, kbuf0, vbuf0);
    if (t0 + step >= hi) break;
    if (t0 + 2 * step < hi) load_pass(t0 + 2 * step, kbuf0, vbuf0);
    compute_pass(t0 + step, kbuf1, vbuf1);
  }

  // the warp's groups summed (xor over the group bits of the lane), then
  // the warps' states merged through shared memory in warp order
  const int warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    for (int o = gs; o < 32; o <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
    if ((tid & 31) < gs) {  // the warp's first group holds the sums
      if (lane_on) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) w_acc[(warp * RT + r) * Dh + c * kVec + e] = acc[r][e];
      }
      if (c == 0) {
        w_m[warp * RT + r] = m[r];
        w_l[warp * RT + r] = l[r];
      }
    }
  }
  __syncthreads();
  cluster_wait();  // every peer has started: its inbox takes our state

  // the block's state, pushed into the inbox of the rank that finishes each
  // output (st.async into a peer's shared memory; plain stores to our own)
  const uint32_t bar = smem_addr(&inbox);
  for (int i = tid; i < n_out; i += kThreads) {
    const int r = i / Dh;
    float mb = -FLT_MAX;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) mb = fmaxf(mb, w_m[wp * RT + r]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) {
      const float wgt = __expf(w_m[wp * RT + r] - mb);
      lb = fmaf(w_l[wp * RT + r], wgt, lb);
      ab = fmaf(w_acc[(wp * RT + r) * Dh + (i - r * Dh)], wgt, ab);
    }
    const int owner = i / per;
    float* dst = in_acc + rank * per + (i - owner * per);
    if (owner == rank)
      *dst = ab;
    else
      push(peer_addr(smem_addr(dst), owner), ab, peer_addr(bar, owner));
    if (i - r * Dh == 0) {
#pragma unroll
      for (int j = 0; j < kMaxSplits; ++j) {
        if (j == rank) {
          in_m[rank * RT + r] = mb;
          in_l[rank * RT + r] = lb;
        } else if (j < n_split) {
          push(peer_addr(smem_addr(in_m + rank * RT + r), j), mb, peer_addr(bar, j));
          push(peer_addr(smem_addr(in_l + rank * RT + r), j), lb, peer_addr(bar, j));
        }
      }
    }
  }
  __syncthreads();   // our own share of the inbox is in
  inbox_wait(bar);   // and every peer's; nothing touches our memory after this

  // this rank's outputs, from every rank's state in rank order
  const int o_end = min(n_out, (rank + 1) * per);
  for (int i = rank * per + tid; i < o_end; i += kThreads) {
    const int r = i / Dh, d = i - (i / Dh) * Dh;
    const int rr = rt * RT + r;
    if (rr >= R) continue;
    float mj[kMaxSplits], mm = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      mj[j] = j < n_split ? in_m[j * RT + r] : -FLT_MAX;
      mm = fmaxf(mm, mj[j]);
    }
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      if (j < n_split) {
        const float wgt = __expf(mj[j] - mm);
        ll = fmaf(in_l[j * RT + r], wgt, ll);
        aa = fmaf(in_acc[j * per + (i - rank * per)], wgt, aa);
      }
    }
    const int w = rr / G, h = kvh * G + (rr - w * G);
    out[i == i0 ? out0 : (((long long)b * W + w) * H + h) * Dh + d] =
        from_float<QT>(__fdividef(aa, fmaxf(ll, 1e-30f)));
  }
}

template <typename QT, typename KVT, int RT>
int launch(const void* q, const void* k, const void* v, const int* starts, const int* limits,
           int limit_scalar, void* out, int B, int W, int H, int H_kv, int Dh, int S,
           long long layer_offset, long long stride_b, long long stride_s, int n_split,
           cudaStream_t stream) {
  const int gs = group_lanes(Dh, (int)sizeof(KVT));
  int gs_log2 = 0;
  while ((1 << gs_log2) < gs) ++gs_log2;
  const size_t smem = smem_bytes(RT, Dh);  // at most 41 KB (RT 8, Dh 256)
  const int n_rt = ((H / H_kv) * W + RT - 1) / RT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, H_kv * n_rt, B);
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
  const KVT* kl = static_cast<const KVT*>(k) + layer_offset;
  const KVT* vl = static_cast<const KVT*>(v) + layer_offset;
  cudaError_t err = cudaLaunchKernelEx(&cfg, flash_decode_kernel<QT, KVT, RT>,
                                       static_cast<const QT*>(q), kl, vl, starts, limits,
                                       limit_scalar, static_cast<QT*>(out), W, H, H_kv, Dh, S,
                                       stride_b, stride_s, gs_log2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename QT, typename KVT>
int dispatch_rows(const void* q, const void* k, const void* v, const int* starts,
                  const int* limits, int limit_scalar, void* out, int B, int W, int H, int H_kv,
                  int Dh, int S, long long layer_offset, long long stride_b, long long stride_s,
                  int n_split, cudaStream_t stream) {
  switch (row_tile((H / H_kv) * W)) {
    case 1:
      return launch<QT, KVT, 1>(q, k, v, starts, limits, limit_scalar, out, B, W, H, H_kv, Dh,
                                S, layer_offset, stride_b, stride_s, n_split, stream);
    case 2:
      return launch<QT, KVT, 2>(q, k, v, starts, limits, limit_scalar, out, B, W, H, H_kv, Dh,
                                S, layer_offset, stride_b, stride_s, n_split, stream);
    case 4:
      return launch<QT, KVT, 4>(q, k, v, starts, limits, limit_scalar, out, B, W, H, H_kv, Dh,
                                S, layer_offset, stride_b, stride_s, n_split, stream);
    default:
      return launch<QT, KVT, 8>(q, k, v, starts, limits, limit_scalar, out, B, W, H, H_kv, Dh,
                                S, layer_offset, stride_b, stride_s, n_split, stream);
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. `limits` may be null, then every
// row uses `limit_scalar`. Strides are in elements; the layer's block starts
// at layer * stride_l. `n_split` (1, 2, 4 or 8) is the cluster size: the
// shares each row's slots are cut into. Returns a cudaError_t (0 = launched).
int flash_decode_attention_launch(const void* q, const void* k, const void* v,
                                  const void* starts, const void* limits, int limit_scalar,
                                  void* out, int q_dtype, int kv_dtype, int B, int W, int H,
                                  int H_kv, int Dh, int S, int layer, int stride_l,
                                  int stride_b, int stride_s, int n_split, void* stream) {
  if (B <= 0 || W <= 0 || H_kv <= 0 || Dh <= 0 || H % H_kv != 0) return (int)cudaErrorInvalidValue;
  if (n_split < 1 || n_split > kMaxSplits || (n_split & (n_split - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  // K/V rows are read in 16-byte vectors, one per lane of a group of at most 32
  const int elem = kv_dtype == 0 ? 4 : 2;
  if (Dh * elem > kMaxRowBytes) return (int)cudaErrorInvalidValue;
  if ((Dh * elem) % 16 != 0 || (stride_s * elem) % 16 != 0 || (stride_b * elem) % 16 != 0 ||
      (reinterpret_cast<unsigned long long>(k) % 16) != 0 ||
      (reinterpret_cast<unsigned long long>(v) % 16) != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long layer_offset = (long long)layer * stride_l;
  const int* st = static_cast<const int*>(starts);
  const int* li = static_cast<const int*>(limits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch_rows<float, float>(q, k, v, st, li, limit_scalar, out, B, W, H, H_kv, Dh, S,
                                       layer_offset, stride_b, stride_s, n_split, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return dispatch_rows<float, __nv_bfloat16>(q, k, v, st, li, limit_scalar, out, B, W, H,
                                               H_kv, Dh, S, layer_offset, stride_b, stride_s,
                                               n_split, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return dispatch_rows<__nv_bfloat16, float>(q, k, v, st, li, limit_scalar, out, B, W, H,
                                               H_kv, Dh, S, layer_offset, stride_b, stride_s,
                                               n_split, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_rows<__nv_bfloat16, __nv_bfloat16>(q, k, v, st, li, limit_scalar, out, B, W,
                                                       H, H_kv, Dh, S, layer_offset, stride_b,
                                                       stride_s, n_split, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
