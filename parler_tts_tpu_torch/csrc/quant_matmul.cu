// Weight-only int8 matrix product for Hopper (sm_90a): y = (bf16(x) @ w_q) * scale.
//
// Replaces the Pallas TPU kernel `quant_matmul` (`_qmm_kernel`,
// parler_tts_tpu/ops/pallas/quant_matmul.py). x (M, K) is rounded to bf16,
// the int8 weights (K, N) convert exactly to bf16, products accumulate in
// fp32, the fp32 per-output-channel scale (N,) is applied in the epilogue and
// the output (M, N) is in x's dtype (fp32 or bf16).
//
// What bounds it on this card: bytes. M is a handful of decode rows (2 at
// B=2, up to a few tens in prefill), so each weight byte feeds at most 2M
// operations, far below the ~295 operations per byte where the tensor cores
// become the limit. The least time is the K * N weight bytes at 3.35 TB/s.
//
// Design (simple first; wgmma/TMA is later work):
//   * a block owns a 128-column strip of N, a tile of up to R = 8 rows of x
//     and a slice of K (split-K across blocks, so that M = 2, N = 1024 still
//     puts some 256 blocks on 132 SMs);
//   * 256 threads = 8 along N x 32 along K: each thread reads 16 int8 weights
//     of one row of w as one 16-byte load (8 neighbouring threads read 128
//     contiguous bytes), four rows in flight, and keeps R x 16 fp32 sums;
//   * x's slice sits in shared memory as fp32 values already rounded to bf16,
//     so every product bf16 x int8 is exact in fp32, as the TPU's matrix unit
//     forms it;
//   * the 32 K-groups of a block reduce through shared memory; split-K slices
//     write fp32 partials to a workspace, and the last block of a strip to
//     arrive (an atomic counter, reset by that block) sums them in split order
//     (deterministic), scales and stores.
// The plain PyTorch version with the same semantics is `quant_matmul_plain` in
// parler_tts_tpu_torch/ops/quant_matmul.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 16;                 // one 16-byte int8 load
constexpr int kNThreads = 8;                       // threads along N
constexpr int kKGroups = kThreads / kNThreads;     // 32 threads along K
constexpr int kStrip = kNThreads * kColsPerThread; // 128 columns per block
constexpr int kUnroll = 4;                         // weight rows in flight
constexpr int kMaxSlice = 512;                     // K per block, at most

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void unpack_int8(const uint4& raw, float (&w)[kColsPerThread]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < kColsPerThread; ++i) w[i] = (float)b[i];
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads) quant_matmul_kernel(
    const T* __restrict__ x,          // (M, K)
    const int8_t* __restrict__ w,     // (K, N)
    const float* __restrict__ scale,  // (N,)
    T* __restrict__ out,              // (M, N)
    float* __restrict__ work,         // (splits, M, N) when splits > 1
    int* __restrict__ counters,       // one per (strip, row tile), zero between launches
    int M, int K, int N, int splits, int slice) {
  const int strip = blockIdx.x, split = blockIdx.y, mtile = blockIdx.z;
  const int tid = threadIdx.x;
  const int tn = tid % kNThreads, kg = tid / kNThreads;
  const int n0 = strip * kStrip + tn * kColsPerThread;
  const int m0 = mtile * R;
  const int k0 = split * slice;
  const int k1 = min(K, k0 + slice);
  const int ks = k1 - k0;

  extern __shared__ float smem[];
  float* xs = smem;                  // R x slice, bf16-rounded x
  float* red = xs + R * slice;       // kKGroups x kStrip partial sums
  __shared__ int is_last;

  for (int i = tid; i < R * ks; i += kThreads) {
    const int r = i / ks, k = i - r * ks;
    float v = 0.f;
    if (m0 + r < M) v = __bfloat162float(__float2bfloat16(to_float(x[(long long)(m0 + r) * K + k0 + k])));
    xs[r * slice + k] = v;
  }
  __syncthreads();

  float acc[R][kColsPerThread];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.f;

  const bool active = n0 < N;  // N is a multiple of 16, so a thread is all in or all out
  if (active) {
    for (int kb = kg; kb < ks; kb += kKGroups * kUnroll) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = kb + u * kKGroups;
        if (k < ks) raw[u] = __ldg(reinterpret_cast<const uint4*>(w + (long long)(k0 + k) * N + n0));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = kb + u * kKGroups;
        if (k < ks) {
          float wf[kColsPerThread];
          unpack_int8(raw[u], wf);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float xv = xs[r * slice + k];
#pragma unroll
            for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
          }
        }
      }
    }
  }

  // reduce the 32 K-groups, one row at a time; thread j < 128 then owns
  // column strip * 128 + j of that row
  const int col = strip * kStrip + tid;
  float sums[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) red[kg * kStrip + tn * kColsPerThread + c] = acc[r][c];
    __syncthreads();
    float s = 0.f;
    if (tid < kStrip) {
      for (int g = 0; g < kKGroups; ++g) s += red[g * kStrip + tid];
    }
    sums[r] = s;
    __syncthreads();
  }

  if (splits == 1) {
    if (tid < kStrip && col < N) {
      const float sc = scale[col];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (m0 + r < M) store(out + (long long)(m0 + r) * N + col, sums[r] * sc);
    }
    return;
  }

  if (tid < kStrip && col < N) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (m0 + r < M) work[((long long)split * M + m0 + r) * N + col] = sums[r];
  }
  __threadfence();  // the partials are visible device-wide before the count
  __syncthreads();
  int* counter = counters + mtile * gridDim.x + strip;
  if (tid == 0) is_last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  if (tid == 0) *counter = 0;  // ready for the next launch
  if (tid < kStrip && col < N) {
    const float sc = scale[col];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (m0 + r >= M) continue;
      float s = 0.f;
      for (int p = 0; p < splits; ++p) s += __ldcg(work + ((long long)p * M + m0 + r) * N + col);
      store(out + (long long)(m0 + r) * N + col, s * sc);
    }
  }
}

size_t smem_bytes(int rows, int slice) {
  return sizeof(float) * ((size_t)rows * slice + (size_t)kKGroups * kStrip);
}

template <typename T, int R>
int launch(const void* x, const void* w, const void* scale, void* out, void* work,
           void* counters, int M, int K, int N, int splits, int slice, cudaStream_t stream) {
  const size_t smem = smem_bytes(R, slice);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(quant_matmul_kernel<T, R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((N + kStrip - 1) / kStrip, splits, (M + R - 1) / R);
  quant_matmul_kernel<T, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<T*>(out), static_cast<float*>(work), static_cast<int*>(counters), M, K, N,
      splits, slice);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rows(const void* x, const void* w, const void* scale, void* out, void* work,
                  void* counters, int M, int K, int N, int splits, int slice,
                  cudaStream_t stream) {
  if (M <= 1) return launch<T, 1>(x, w, scale, out, work, counters, M, K, N, splits, slice, stream);
  if (M <= 2) return launch<T, 2>(x, w, scale, out, work, counters, M, K, N, splits, slice, stream);
  if (M <= 4) return launch<T, 4>(x, w, scale, out, work, counters, M, K, N, splits, slice, stream);
  return launch<T, 8>(x, w, scale, out, work, counters, M, K, N, splits, slice, stream);
}

}  // namespace

extern "C" {

// Rows of x one block takes: the row tile R of a launch with M rows.
int quant_matmul_row_tile(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8; }

int quant_matmul_strip() { return kStrip; }

int quant_matmul_max_slice() { return kMaxSlice; }

// x_dtype: 0 = float32, 1 = bfloat16 (out has x's dtype). K is cut into
// `splits` slices of `slice` rows (slice <= 512, slice * splits >= K);
// `work` holds splits * M * N floats when splits > 1, and `counters` one
// zeroed int per (strip, row tile). Returns a cudaError_t (0 = launched).
int quant_matmul_launch(const void* x, const void* w, const void* scale, void* out, void* work,
                        void* counters, int x_dtype, int M, int K, int N, int splits,
                        int slice, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 != 0 || N % 16 != 0) return (int)cudaErrorInvalidValue;
  if (splits <= 0 || slice <= 0 || slice > kMaxSlice || (long long)slice * splits < K ||
      (long long)slice * (splits - 1) >= K)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (work == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return dispatch_rows<float>(x, w, scale, out, work, counters, M, K, N, splits, slice, s);
  if (x_dtype == 1)
    return dispatch_rows<__nv_bfloat16>(x, w, scale, out, work, counters, M, K, N, splits, slice,
                                        s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
