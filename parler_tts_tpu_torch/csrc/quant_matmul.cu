// Weight-only int8 matrix product for Hopper (sm_90a): y = (bf16(x) @ w_q) * scale.
//
// Replaces the Pallas TPU kernel `quant_matmul` (`_qmm_kernel`,
// parler_tts_tpu/ops/pallas/quant_matmul.py). x (M, K) is rounded to bf16,
// the int8 weights (K, N) convert exactly to bf16, products accumulate in
// fp32, the fp32 per-output-channel scale (N,) is applied after summation and
// the output (M, N) is in x's dtype (fp32 or bf16).
//
// What bounds it on this card: bytes. M is a handful of decode rows (2 at
// B=2, up to a few tens in prefill), so each weight byte feeds at most 2M
// operations, far below the ~295 operations per byte where the tensor cores
// become the limit. The least time is the K * N weight bytes at 3.35 TB/s.
// At M = 2 that is 0.3 us for a 1024 x 1024 layer: the launch and one trip
// to device memory set the time, so every weight byte has to be in flight
// at once, and a split-K reduction must not cost a second trip.
//
// Design (split-K inside one cluster launch):
//   * grid (slices, strips, row tiles): a block owns a 64-column strip of N,
//     a tile of up to R = 8 rows of x and one slice of K; the slices of a
//     strip are the blocks of one thread-block cluster (at most 8), chosen
//     on the host by `k2_grid` (ops/quant_matmul.py) so that the grid holds
//     about one block per SM (a second wave costs more than it brings): at
//     M = 2, 1024 x 1024 is 16 strips x 8 slices of 128 rows (8 KB of
//     weights a block), fc1 (1024 x 4096) 64 strips x 2 slices of 512 rows;
//   * 256 threads = 4 along N x 64 along K: each thread reads 16 int8
//     weights of one row as one 16-byte load (4 neighbouring threads read 64
//     contiguous bytes, evict-first: they are read once), up to 8 rows in
//     flight before any arithmetic at M <= 2 (a whole 512-row slice), and
//     keeps R x 16 fp32 sums; eight warps keep the SM busy between loads;
//   * x's slice sits in shared memory as bf16, staged with 16-byte loads
//     while the first weight rows are in flight, so every product bf16 x
//     int8 is exact in fp32, as the TPU's matrix unit forms it;
//   * each warp sums its 8 K-groups with shuffles (a transposing butterfly:
//     14 shuffles a row leave each lane 2 columns' sums), the 8 warps sum
//     through shared memory in warp order into the block's partial strip;
//   * split-K: rank j of a cluster finishes the j-th 64 / slices columns of
//     the strip. Each block pushes its partial sums of those columns into
//     rank j's inbox with st.async, which counts the bytes on the inbox's
//     mbarrier as they land; rank j waits on that count, not on a cluster
//     barrier, sums its columns over the ranks in rank order, scales and
//     stores. One cluster barrier, split, comes before the pushes: it tells
//     a block that its peers have started and set up their inboxes; its
//     arrive is issued with the first weights in flight and its wait after
//     the main loop. No block reads a peer, so none has to outlive its
//     peers. No workspace, no counters, no atomics: a repeated call gives
//     the same bits, and the output is the launch's only allocation.
// The plain PyTorch version with the same semantics is `quant_matmul_plain` in
// parler_tts_tpu_torch/ops/quant_matmul.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;                       // one 16-byte int8 load
constexpr int kStrip = 64;                      // columns per block (STRIP)
constexpr int kNThreads = kStrip / kCols;       // 4 threads along N
constexpr int kKGroups = kThreads / kNThreads;  // 64 threads along K
constexpr int kMaxSlices = 8;                   // the portable cluster size
constexpr int kXBatch = 4;                      // 16-byte loads of x in flight per thread
constexpr int kMaxSmem = 232448;                // bytes a block may use on Hopper

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void unpack16(const uint4& raw, float (&out)[4]) {  // 4 fp32
  const float4 f = *reinterpret_cast<const float4*>(&raw);
  out[0] = f.x, out[1] = f.y, out[2] = f.z, out[3] = f.w;
}

__device__ __forceinline__ void unpack16(const uint4& raw, float (&out)[8]) {  // 8 bf16
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x, out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack_int8(const uint4& raw, float (&w)[kCols]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < kCols; ++i) w[i] = (float)b[i];
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

int row_tile(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8; }

size_t smem_bytes(int rows, int slice) {
  // x's slice (bf16), the warps' sums, every rank's partials of a slice of columns
  return (size_t)rows * slice * 2 + sizeof(float) * (size_t)(kWarps + 1) * rows * kStrip;
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads) quant_matmul_kernel(
    const T* __restrict__ x,          // (M, K)
    const int8_t* __restrict__ w,     // (K, N)
    const float* __restrict__ scale,  // (N,)
    T* __restrict__ out,              // (M, N)
    int M, int K, int N, int slice) {
  constexpr int kU = R <= 2 ? 8 : (R == 4 ? 4 : 2);  // weight rows in flight per thread
  cg::cluster_group cluster = cg::this_cluster();
  const int n_slices = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cols = kStrip / n_slices;  // rank j finishes the strip's j-th `cols` columns
  __shared__ alignas(8) unsigned long long inbox;  // counts the peers' bytes in
  const int strip = blockIdx.y, mtile = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tn = tid % kNThreads, kg = tid / kNThreads;
  const int n0 = strip * kStrip + tn * kCols;
  const int m0 = mtile * R;
  const int k0 = rank * slice;
  const int ks = max(min(K, k0 + slice) - k0, 0);  // a last slice may be short or empty

  extern __shared__ float4 smem4[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);  // R x slice
  float* red = reinterpret_cast<float*>(xs + R * slice);        // kWarps x R x kStrip
  float* inbox_data = red + kWarps * R * kStrip;  // slices x R x cols: every rank's
                                                  // partials of our columns, pushed here

  // kU weight rows per thread, all loads issued before any arithmetic; the
  // first batch is in flight while x's slice is staged
  const bool active = n0 < N;  // N is a multiple of 16, so a thread is all in or all out
  uint4 raw[kU];
  auto load_rows = [&](int kb) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kk = kb + u * kKGroups;
      if (active && kk < ks)
        raw[u] = __ldcs(reinterpret_cast<const uint4*>(w + (long long)(k0 + kk) * N + n0));
    }
  };
  load_rows(kg);
  // with the first rows in flight: the inbox, then the first half of "every
  // block of the cluster has started" (its inbox ready), so that a peer may
  // push into it; its wait comes after the loop
  if (tid == 0) inbox_init(smem_addr(&inbox), (n_slices - 1) * 4 * R * cols);
  cluster_arrive_relaxed();
  // the scale of the first column this thread finishes, read early
  const int sc_col = strip * kStrip + rank * cols + tid % cols;
  const float sc = tid < R * cols && sc_col < N ? __ldg(scale + sc_col) : 0.f;

  // x's slice, rounded to bf16: every product bf16 x int8 is exact in fp32.
  // 16-byte loads, a batch of them in flight per thread before any store
  // (x's rows hold K elements, K and the slice multiples of 16, so a
  // 16-byte chunk never straddles two rows when x is 16-byte aligned)
  constexpr int kVec = 16 / sizeof(T);
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int chunks_per_row = ks / kVec, chunks = R * chunks_per_row;
    for (int base = 0; base < chunks; base += kThreads * kXBatch) {
      uint4 xr[kXBatch];
#pragma unroll
      for (int u = 0; u < kXBatch; ++u) {
        const int i = base + u * kThreads + tid, r = i / chunks_per_row;
        if (i < chunks && m0 + r < M)
          xr[u] = __ldg(reinterpret_cast<const uint4*>(
              x + (long long)(m0 + r) * K + k0 + (i - r * chunks_per_row) * kVec));
        else
          xr[u] = make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kXBatch; ++u) {
        const int i = base + u * kThreads + tid, r = i / chunks_per_row;
        if (i < chunks) {
          float e[kVec];
          unpack16(xr[u], e);
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            xs[r * slice + (i - r * chunks_per_row) * kVec + j] = __float2bfloat16(e[j]);
        }
      }
    }
  } else {
    for (int i = tid; i < R * ks; i += kThreads) {
      const int r = i / ks, kk = i - r * ks;
      const float v = m0 + r < M ? to_float(x[(long long)(m0 + r) * K + k0 + kk]) : 0.f;
      xs[r * slice + kk] = __float2bfloat16(v);
    }
  }
  __syncthreads();

  float acc[R][kCols];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  for (int kb = kg; kb < ks; kb += kKGroups * kU) {
    if (kb != kg) load_rows(kb);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kk = kb + u * kKGroups;
      if (active && kk < ks) {
        float wf[kCols];
        unpack_int8(raw[u], wf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xv = __bfloat162float(xs[r * slice + kk]);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
        }
      }
    }
  }

  // the warp's 8 K-groups (lane bits 2-4) summed by a transposing butterfly:
  // each step halves the columns a lane holds, so a lane ends with 2 columns
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  const int col0 = tn * kCols + (b4 ? 8 : 0) + (b3 ? 4 : 0) + (b2 ? 2 : 0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float v8[8], v4[4], v2[2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float send = b4 ? acc[r][i] : acc[r][i + 8];
      v8[i] = (b4 ? acc[r][i + 8] : acc[r][i]) + __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = b3 ? v8[i] : v8[i + 4];
      v4[i] = (b3 ? v8[i + 4] : v8[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = b2 ? v4[i] : v4[i + 2];
      v2[i] = (b2 ? v4[i + 2] : v4[i]) + __shfl_xor_sync(0xffffffffu, send, 4);
    }
    red[(warp * R + r) * kStrip + col0] = v2[0];
    red[(warp * R + r) * kStrip + col0 + 1] = v2[1];
  }
  __syncthreads();
  cluster_wait();  // every peer has started: its inbox takes our partials

  // the block's partial strip (the warps summed in warp order), pushed into
  // the inbox of the rank that finishes each column (st.async into a peer's
  // shared memory; plain stores to our own)
  const uint32_t bar = smem_addr(&inbox);
  for (int i = tid; i < R * kStrip; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) s += red[wp * R * kStrip + i];
    const int r = i / kStrip, cl = i - r * kStrip, owner = cl / cols;
    float* dst = inbox_data + (rank * R + r) * cols + (cl - owner * cols);
    if (owner == rank)
      *dst = s;
    else
      push(peer_addr(smem_addr(dst), owner), s, peer_addr(bar, owner));
  }
  __syncthreads();   // our own share of the inbox is in
  inbox_wait(bar);   // and every peer's; nothing touches our memory after this

  // this rank's columns: the ranks' partials summed in rank order, scaled
  for (int i = tid; i < R * cols; i += kThreads) {
    const int r = i / cols, c = i - r * cols;
    const int col = strip * kStrip + rank * cols + c;
    if (m0 + r >= M || col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSlices; ++j)
      if (j < n_slices) s += inbox_data[(j * R + r) * cols + c];
    store(out + (long long)(m0 + r) * N + col, s * (i == tid ? sc : __ldg(scale + col)));
  }
}

template <typename T, int R>
int launch(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
           int slices, int slice, cudaStream_t stream) {
  const size_t smem = smem_bytes(R, slice);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(quant_matmul_kernel<T, R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, (N + kStrip - 1) / kStrip, (M + R - 1) / R);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, quant_matmul_kernel<T, R>, static_cast<const T*>(x),
                                       static_cast<const int8_t*>(w),
                                       static_cast<const float*>(scale), static_cast<T*>(out), M,
                                       K, N, slice);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rows(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
                  int slices, int slice, cudaStream_t stream) {
  switch (row_tile(M)) {
    case 1: return launch<T, 1>(x, w, scale, out, M, K, N, slices, slice, stream);
    case 2: return launch<T, 2>(x, w, scale, out, M, K, N, slices, slice, stream);
    case 4: return launch<T, 4>(x, w, scale, out, M, K, N, slices, slice, stream);
    default: return launch<T, 8>(x, w, scale, out, M, K, N, slices, slice, stream);
  }
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16 (out has x's dtype). K is cut into
// `slices` slices of `slice` rows (slices a power of two up to 8, the
// cluster size; slice a multiple of 16 with slice * slices >= K). Returns a
// cudaError_t (0 = launched).
int quant_matmul_launch(const void* x, const void* w, const void* scale, void* out, int x_dtype,
                        int M, int K, int N, int slices, int slice, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0) return (int)cudaErrorInvalidValue;
  if (slices < 1 || slices > kMaxSlices || (slices & (slices - 1)) != 0 || slice <= 0 ||
      slice % 16 != 0 || (long long)slice * slices < K)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return dispatch_rows<float>(x, w, scale, out, M, K, N, slices, slice, s);
  if (x_dtype == 1)
    return dispatch_rows<__nv_bfloat16>(x, w, scale, out, M, K, N, slices, slice, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
