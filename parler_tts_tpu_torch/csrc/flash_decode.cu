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
// byte where Hopper's tensor cores become the limit.
//
// Design (simple and exact first; a split-KV design with TMA and wgmma is
// later work):
//   * one block per (kv head, batch row); it owns the G * W query rows of
//     that kv head (G = H / H_kv query heads per kv head, W window columns),
//     so GQA/MQA rows share one pass over the cache;
//   * a loop over tiles of kTile slots up to min(limit_b + W - 1, S): stage K
//     and V in shared memory as fp32 (16-byte loads, several in flight per
//     thread), score, online softmax in fp32, P . V;
//   * q is rounded to the cache dtype and P is cast to the cache dtype before
//     the P . V product, as the Pallas kernel feeds its matrix unit; the
//     softmax state and the accumulator stay fp32; the output is in q's dtype;
//   * an empty range returns 0 (the running denominator is clamped, as the
//     Pallas kernel's is).
// The plain PyTorch version with the same semantics is
// `flash_decode_attention_plain` in parler_tts_tpu_torch/ops/flash_decode.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;  // cache slots per tile
constexpr int kUnroll = 4;  // 16-byte loads of K (and of V) in flight per thread
constexpr int kMaxSmem = 232448;  // bytes a block may use on Hopper

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int rows, int dh) {
  // q, acc: rows x Dh; K tile (padded rows), V tile; P: rows x kTile; m, l, alpha
  return sizeof(float) *
         (2 * (size_t)rows * dh + (size_t)kTile * (dh + 1) + (size_t)kTile * dh +
          (size_t)rows * kTile + 3 * (size_t)rows);
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const QT* __restrict__ q,           // (B, W, H, Dh), contiguous
    const KVT* __restrict__ k,          // this layer's (B, S, H_kv * Dh) block
    const KVT* __restrict__ v,
    const int* __restrict__ starts,     // (B,)
    const int* __restrict__ limits,     // (B,), or null: use limit_scalar
    int limit_scalar,
    QT* __restrict__ out,               // (B, W, H, Dh)
    int W, int H, int H_kv, int Dh, int S,
    long long stride_b, long long stride_s) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / H_kv;
  const int R = G * W;  // query rows of this block, r = w * G + g
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  extern __shared__ float smem[];
  const int kstride = Dh + 1;  // padded: thread j reads K row j conflict-free
  float* q_s = smem;                   // R * Dh
  float* acc_s = q_s + R * Dh;         // R * Dh
  float* k_s = acc_s + R * Dh;         // kTile * (Dh + 1)
  float* v_s = k_s + kTile * kstride;  // kTile * Dh
  float* p_s = v_s + kTile * Dh;       // R * kTile
  float* m_s = p_s + R * kTile;        // R
  float* l_s = m_s + R;                // R
  float* a_s = l_s + R;                // R: this tile's rescale factor

  const int start = starts[b];
  const int limit = limits != nullptr ? limits[b] : limit_scalar;
  const int begin = start > 0 ? start : 0;
  const int end = min(limit + W - 1, S);  // the last column sees limit + W - 1 slots

  for (int i = tid; i < R * Dh; i += kThreads) {
    const int r = i / Dh, d = i - (i / Dh) * Dh;
    const int w = r / G, h = kvh * G + (r - w * G);
    q_s[i] = round_to<KVT>(to_float(q[(((long long)b * W + w) * H + h) * Dh + d]));
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = -FLT_MAX;
    l_s[r] = 0.f;
  }

  constexpr int kElemsPerVec = 16 / sizeof(KVT);
  const int vec_per_row = Dh / kElemsPerVec;  // the launcher checks Dh divides
  const KVT* kb = k + (long long)b * stride_b + (long long)kvh * Dh;
  const KVT* vb = v + (long long)b * stride_b + (long long)kvh * Dh;

  for (int t0 = begin; t0 < end; t0 += kTile) {
    const int n = min(kTile, end - t0);
    __syncthreads();  // the previous tile's readers are done
    // 16-byte loads, kUnroll of K and of V in flight per thread before any
    // is stored: the tile's load latency is paid about once, not per element
    const int nvec = n * vec_per_row;
    for (int base = 0; base < nvec; base += kThreads * kUnroll) {
      uint4 kraw[kUnroll], vraw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = base + u * kThreads + tid;
        if (idx < nvec) {
          const int j = idx / vec_per_row, c = idx - (idx / vec_per_row) * vec_per_row;
          const long long off = (long long)(t0 + j) * stride_s + c * kElemsPerVec;
          kraw[u] = *reinterpret_cast<const uint4*>(kb + off);
          vraw[u] = *reinterpret_cast<const uint4*>(vb + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = base + u * kThreads + tid;
        if (idx < nvec) {
          const int j = idx / vec_per_row, c = idx - (idx / vec_per_row) * vec_per_row;
          float kf[kElemsPerVec], vf[kElemsPerVec];
          unpack(kraw[u], kf);
          unpack(vraw[u], vf);
#pragma unroll
          for (int e = 0; e < kElemsPerVec; ++e) {
            k_s[j * kstride + c * kElemsPerVec + e] = kf[e];
            v_s[j * Dh + c * kElemsPerVec + e] = vf[e];
          }
        }
      }
    }
    __syncthreads();

    // scores; slot t0 + j is visible to column w iff it lies below limit + w
    // (t0 >= begin already keeps it at or above start)
    for (int i = tid; i < R * kTile; i += kThreads) {
      const int r = i / kTile, j = i - (i / kTile) * kTile;
      const int w = r / G;
      float s = -INFINITY;
      if (j < n && t0 + j < limit + w) {
        const float* qr = q_s + r * Dh;
        const float* kr = k_s + j * kstride;
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < Dh; ++d) acc = fmaf(qr[d], kr[d], acc);
        s = acc;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int r = warp; r < R; r += kWarps) {
      float* pr = p_s + r * kTile;
      float mx = -FLT_MAX;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float s = pr[j];
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        sum += p;
        pr[j] = round_to<KVT>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < R * Dh; i += kThreads) {
      const int r = i / Dh, d = i - (i / Dh) * Dh;
      const float* pr = p_s + r * kTile;
      float a = 0.f;
#pragma unroll 8
      for (int j = 0; j < n; ++j) a = fmaf(pr[j], v_s[j * Dh + d], a);
      acc_s[i] = acc_s[i] * a_s[r] + a;
    }
  }
  __syncthreads();

  for (int i = tid; i < R * Dh; i += kThreads) {
    const int r = i / Dh, d = i - (i / Dh) * Dh;
    const int w = r / G, h = kvh * G + (r - w * G);
    const float denom = fmaxf(l_s[r], 1e-30f);
    out[(((long long)b * W + w) * H + h) * Dh + d] = from_float<QT>(acc_s[i] / denom);
  }
}

template <typename QT, typename KVT>
int launch(const void* q, const void* k, const void* v, const int* starts, const int* limits,
           int limit_scalar, void* out, int B, int W, int H, int H_kv, int Dh, int S,
           long long layer_offset, long long stride_b, long long stride_s,
           cudaStream_t stream) {
  const size_t smem = smem_bytes((H / H_kv) * W, Dh);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<QT, KVT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const KVT* kl = static_cast<const KVT*>(k) + layer_offset;
  const KVT* vl = static_cast<const KVT*>(v) + layer_offset;
  dim3 grid(H_kv, B);
  flash_decode_kernel<QT, KVT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), kl, vl, starts, limits, limit_scalar, static_cast<QT*>(out),
      W, H, H_kv, Dh, S, stride_b, stride_s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs for `rows` = (H / H_kv) * W query rows.
long long flash_decode_smem_bytes(int rows, int dh) { return (long long)smem_bytes(rows, dh); }

long long flash_decode_max_smem_bytes() { return kMaxSmem; }

// dtype codes: 0 = float32, 1 = bfloat16. `limits` may be null, then every
// row uses `limit_scalar`. Strides are in elements; the layer's block starts
// at layer * stride_l. Returns a cudaError_t (0 = launched).
int flash_decode_attention_launch(const void* q, const void* k, const void* v,
                                  const void* starts, const void* limits, int limit_scalar,
                                  void* out, int q_dtype, int kv_dtype, int B, int W, int H,
                                  int H_kv, int Dh, int S, int layer, int stride_l,
                                  int stride_b, int stride_s, void* stream) {
  if (B <= 0 || W <= 0 || H_kv <= 0 || Dh <= 0 || H % H_kv != 0) return (int)cudaErrorInvalidValue;
  if (smem_bytes((H / H_kv) * W, Dh) > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  // K/V rows are read in 16-byte vectors
  const int elem = kv_dtype == 0 ? 4 : 2;
  if ((Dh * elem) % 16 != 0 || (stride_s * elem) % 16 != 0 || (stride_b * elem) % 16 != 0 ||
      (reinterpret_cast<unsigned long long>(k) % 16) != 0 ||
      (reinterpret_cast<unsigned long long>(v) % 16) != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long layer_offset = (long long)layer * stride_l;
  const int* st = static_cast<const int*>(starts);
  const int* li = static_cast<const int*>(limits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, st, li, limit_scalar, out, B, W, H, H_kv, Dh, S,
                                layer_offset, stride_b, stride_s, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, st, li, limit_scalar, out, B, W, H, H_kv, Dh,
                                        S, layer_offset, stride_b, stride_s, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k, v, st, li, limit_scalar, out, B, W, H, H_kv, Dh,
                                        S, layer_offset, stride_b, stride_s, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, st, li, limit_scalar, out, B, W, H,
                                                H_kv, Dh, S, layer_offset, stride_b, stride_s,
                                                s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
