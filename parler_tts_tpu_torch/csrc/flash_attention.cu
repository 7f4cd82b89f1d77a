// Training flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (parler_tts_tpu/ops/pallas/flash_attention.py): `_fwd_kernel`, `_dq_kernel`
// and `_dkv_kernel`. For every batch row b and head h it computes causal,
// key-masked attention of q (B, Tq, H, Dh), already scaled, over k and v
// (B, Tk, H, Dh) (kv heads are repeated to H outside, so that the repeat's
// own backward sums dk and dv over each group), with a (B, Tk) key-validity
// mask and query row i at absolute position q_offset + i; and the gradients
// dq, dk, dv of it. The tensors are read in place in their (B, T, H, Dh)
// layout: a head is a pointer offset, a row a stride of H * Dh.
//
// What bounds it on this card: at mini-v1's training shape (B = 2, H = 16,
// T = 1040, Dh = 64, causal) the two bounds are about even: the forward does
// 4.4 GFLOP on 17 MB, 256 operations per byte against the ~295 where
// Hopper's tensor cores become the limit, and dk/dv does twice the forward's
// products on 26 MB. This first version computes on the CUDA cores in fp32
// and is far above either bound; wgmma and TMA are later work.
//
// Design (simple and exact first):
//   * forward and dq: one block of 256 threads per (q tile of 64 rows, h, b);
//     dk/dv: one block per (k tile of 64 rows, h, b). Each block stages its
//     own tile and loops over the other side's tiles through shared memory,
//     as fp32 (exact for bf16 inputs); causal blocks stop at the last tile
//     that holds a visible key (dq, forward) or start at the first tile that
//     holds a query that sees the block's keys (dk/dv);
//   * each thread owns 4 rows and every 16th column of a 64 x 64 score tile;
//     the 16 threads of a half-warp share rows, so row maxima and sums are
//     half-warp shuffles and the probability tile a half-warp writes is read
//     back only by itself;
//   * the forward runs an online softmax with m, l and acc in fp32 and writes
//     o and an fp32 logsumexp (B, H, Tq); the dq kernel also writes
//     D = rowsum(do . o) (B, H, Tq), which the dk/dv kernel then reads;
//   * rounding as the Pallas kernel's: scores in fp32 from input-dtype
//     operands; p rounded to the input dtype before p @ v and p^T @ do; ds
//     rounded before ds @ k and ds^T @ q; sums in fp32; outputs in the input
//     dtype;
//   * a masked score is -FLT_MAX (finfo(float32).min, not -inf), p is 0
//     wherever the mask says so, and l is clamped at 1e-30: a query row with
//     no valid key gets exactly 0 in o and in every gradient.
// The plain PyTorch version with the same semantics and rounding is
// `flash_attention_plain` in parler_tts_tpu_torch/ops/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;         // query rows and key rows per tile
constexpr int kLdP = kTile + 1;   // row stride of the 64 x 64 probability tiles
constexpr float kNegInf = -FLT_MAX;

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

// max / sum over the 16 lanes of a half-warp (lanes that share rows)
__device__ __forceinline__ float half_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + 64) of one head, row stride `stride`, into dst[64][DH + 1]
// as fp32; rows at or past `n_rows` read as 0
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int n_rows,
                                          long stride) {
  for (int idx = threadIdx.x; idx < kTile * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH;
    dst[r * (DH + 1) + d] = row0 + r < n_rows ? to_float(src[(long)(row0 + r) * stride + d]) : 0.f;
  }
}

template <int DH>
constexpr int fwd_smem() { return (3 * kTile * (DH + 1) + kTile * kLdP) * 4; }
template <int DH>
constexpr int dq_smem() { return (4 * kTile * (DH + 1) + kTile * kLdP) * 4; }
template <int DH>
constexpr int dkv_smem() { return (4 * kTile * (DH + 1) + 2 * kTile * kLdP + 2 * kTile) * 4; }

// number of key tiles a causal query tile starting at q0 needs (all when not causal)
__device__ __forceinline__ int live_k_tiles(int q0, int tk, int causal, int q_offset) {
  const int nk = (tk + kTile - 1) / kTile;
  if (!causal) return nk;
  return min(nk, (q_offset + q0 + kTile + kTile - 1) / kTile);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const uint8_t* __restrict__ mask, T* __restrict__ o, float* __restrict__ lse,
           int H, int Tq, int Tk, int causal, int q_offset) {
  constexpr int LD = DH + 1, NJ = DH / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sP = sV + kTile * LD;
  __shared__ int sOk[kTile];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const long stride = (long)H * DH;
  const T* qb = q + ((long)b * Tq * H + h) * DH;
  const T* kb = k + ((long)b * Tk * H + h) * DH;
  const T* vb = v + ((long)b * Tk * H + h) * DH;

  load_tile<T, DH>(sQ, qb, q0, Tq, stride);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf, l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int nk = live_k_tiles(q0, Tk, causal, q_offset);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K, V and validity are read
    load_tile<T, DH>(sK, kb, k0, Tk, stride);
    load_tile<T, DH>(sV, vb, k0, Tk, stride);
    if (tid < kTile) sOk[tid] = k0 + tid < Tk && mask[(long)b * Tk + k0 + tid] != 0;
    __syncthreads();

    float s[4][4] = {};
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(r * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(c + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r * 4 + i + q_offset;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c + 16 * j;
        ok[j] = sOk[col] && (!causal || k0 + col <= qpos);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        sP[(r * 4 + i) * kLdP + c + 16 * j] = round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // this half-warp's probability rows are written
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(r * 4 + i) * kLdP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[kk * LD + c + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    if (row >= Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((long)(b * Tq + row) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[c + 16 * j] = from_float<T>(acc[i][j] / den);
    if (c == 0) lse[((long)b * H + h) * Tq + row] = m[i] + logf(den);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const uint8_t* __restrict__ mask, const T* __restrict__ o,
          const float* __restrict__ lse, const T* __restrict__ dout, T* __restrict__ dq,
          float* __restrict__ delta, int H, int Tq, int Tk, int causal, int q_offset) {
  constexpr int LD = DH + 1, NJ = DH / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTile * LD;
  float* sK = sDO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sDS = sV + kTile * LD;
  __shared__ int sOk[kTile];
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const long stride = (long)H * DH;
  const long qoff = ((long)b * Tq * H + h) * DH;
  const T* kb = k + ((long)b * Tk * H + h) * DH;
  const T* vb = v + ((long)b * Tk * H + h) * DH;

  load_tile<T, DH>(sQ, q + qoff, q0, Tq, stride);
  load_tile<T, DH>(sDO, dout + qoff, q0, Tq, stride);
  __syncthreads();
  // D = rowsum(do . o) in fp32, and this row's logsumexp
  float dsum[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    float part = 0.f;
    if (row < Tq) {
      const T* orow = o + qoff + (long)row * stride;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        part = fmaf(sDO[(r * 4 + i) * LD + c + 16 * j], to_float(orow[c + 16 * j]), part);
    }
    dsum[i] = half_sum(part);
    lrow[i] = row < Tq ? lse[((long)b * H + h) * Tq + row] : 0.f;
    if (c == 0 && row < Tq) delta[((long)b * H + h) * Tq + row] = dsum[i];
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = live_k_tiles(q0, Tk, causal, q_offset);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, DH>(sK, kb, k0, Tk, stride);
    load_tile<T, DH>(sV, vb, k0, Tk, stride);
    if (tid < kTile) sOk[tid] = k0 + tid < Tk && mask[(long)b * Tk + k0 + tid] != 0;
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    for (int d = 0; d < DH; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(r * 4 + i) * LD + d];
        dov[i] = sDO[(r * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(c + 16 * j) * LD + d];
        vv[j] = sV[(c + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r * 4 + i + q_offset;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c + 16 * j;
        const bool ok = sOk[col] && (!causal || k0 + col <= qpos);
        const float p = ok ? expf(s[i][j] - lrow[i]) : 0.f;
        sDS[(r * 4 + i) * kLdP + col] = round_to<T>(p * (dp[i][j] - dsum[i]));
      }
    }
    __syncwarp();
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sDS[(r * 4 + i) * kLdP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = sK[kk * LD + c + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    if (row >= Tq) continue;
    T* out = dq + qoff + (long)row * stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[c + 16 * j] = from_float<T>(acc[i][j]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const uint8_t* __restrict__ mask, const float* __restrict__ lse,
           const T* __restrict__ dout, const float* __restrict__ delta, T* __restrict__ dk,
           T* __restrict__ dv, int H, int Tq, int Tk, int causal, int q_offset) {
  constexpr int LD = DH + 1, NJ = DH / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sDO = sQ + kTile * LD;
  float* sP = sDO + kTile * LD;
  float* sDS = sP + kTile * kLdP;
  float* sL = sDS + kTile * kLdP;
  float* sD = sL + kTile;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const long stride = (long)H * DH;
  const long koff = ((long)b * Tk * H + h) * DH;
  const long qoff = ((long)b * Tq * H + h) * DH;
  const long roff = ((long)b * H + h) * Tq;

  load_tile<T, DH>(sK, k + koff, k0, Tk, stride);
  load_tile<T, DH>(sV, v + koff, k0, Tk, stride);
  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + r * 4 + i;
    key_ok[i] = key < Tk && mask[(long)b * Tk + key] != 0;
  }
  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  const int nq = (Tq + kTile - 1) / kTile;
  const int first = causal ? max(0, k0 - q_offset) / kTile : 0;
  for (int qt = first; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, DH>(sQ, q + qoff, q0, Tq, stride);
    load_tile<T, DH>(sDO, dout + qoff, q0, Tq, stride);
    if (tid < kTile) {
      const bool in = q0 + tid < Tq;
      sL[tid] = in ? lse[roff + q0 + tid] : 0.f;
      sD[tid] = in ? delta[roff + q0 + tid] : 0.f;
    }
    __syncthreads();

    // transposed tiles: rows are this block's keys, columns the tile's queries
    float s[4][4] = {}, dp[4][4] = {};
    for (int d = 0; d < DH; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(r * 4 + i) * LD + d];
        vv[i] = sV[(r * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = sQ[(c + 16 * j) * LD + d];
        dov[j] = sDO[(c + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + r * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c + 16 * j;
        const bool ok = key_ok[i] && q0 + col < Tq && (!causal || key <= q0 + col + q_offset);
        const float p = ok ? expf(s[i][j] - sL[col]) : 0.f;
        sP[(r * 4 + i) * kLdP + col] = round_to<T>(p);
        sDS[(r * 4 + i) * kLdP + col] = round_to<T>(p * (dp[i][j] - sD[col]));
      }
    }
    __syncwarp();
    for (int qq = 0; qq < kTile; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[(r * 4 + i) * kLdP + qq];
        dsv[i] = sDS[(r * 4 + i) * kLdP + qq];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float dov = sDO[qq * LD + c + 16 * j];
        const float qv = sQ[qq * LD + c + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dva[i][j] = fmaf(pv[i], dov, dva[i][j]);
          dka[i][j] = fmaf(dsv[i], qv, dka[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + r * 4 + i;
    if (key >= Tk) continue;
    T* dkr = dk + koff + (long)key * stride;
    T* dvr = dv + koff + (long)key * stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkr[c + 16 * j] = from_float<T>(dka[i][j]);
      dvr[c + 16 * j] = from_float<T>(dva[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *mask, *o, *lse, *dout, *delta;
  void *out0, *out1, *out2;
  int B, H, Tq, Tk, causal, q_offset;
  cudaStream_t stream;
};

template <typename T, int DH>
cudaError_t launch(int which, const Args& a) {
  const dim3 block(kThreads);
  if (which == 0) {
    const int smem = fwd_smem<DH>();
    cudaFuncSetAttribute(fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fwd_kernel<T, DH><<<dim3((a.Tq + kTile - 1) / kTile, a.H, a.B), block, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const uint8_t*)a.mask, (T*)a.out0,
        (float*)a.out1, a.H, a.Tq, a.Tk, a.causal, a.q_offset);
  } else if (which == 1) {
    const int smem = dq_smem<DH>();
    cudaFuncSetAttribute(dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    dq_kernel<T, DH><<<dim3((a.Tq + kTile - 1) / kTile, a.H, a.B), block, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const uint8_t*)a.mask, (const T*)a.o,
        (const float*)a.lse, (const T*)a.dout, (T*)a.out0, (float*)a.out1, a.H, a.Tq, a.Tk,
        a.causal, a.q_offset);
  } else {
    const int smem = dkv_smem<DH>();
    cudaFuncSetAttribute(dkv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    dkv_kernel<T, DH><<<dim3((a.Tk + kTile - 1) / kTile, a.H, a.B), block, smem, a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const uint8_t*)a.mask,
        (const float*)a.lse, (const T*)a.dout, (const float*)a.delta, (T*)a.out0, (T*)a.out1,
        a.H, a.Tq, a.Tk, a.causal, a.q_offset);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int which, int dh, const Args& a) {
  switch (dh) {
    case 16: return launch<T, 16>(which, a);
    case 32: return launch<T, 32>(which, a);
    case 64: return launch<T, 64>(which, a);
    case 128: return launch<T, 128>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(int which, int dtype, int dh, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_dh<float>(which, dh, a);
  if (dtype == 1) return (int)dispatch_dh<__nv_bfloat16>(which, dh, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Head dims 16, 32, 64 and 128; dtype 0 = float32, 1 = bfloat16 (q, k, v, o,
// do and the gradients share it); mask is (B, Tk) uint8, lse and delta are
// (B, H, Tq) fp32. Each returns the cudaError of its launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* o, void* lse, int dtype, int B,
                                   int H, int Tq, int Tk, int dh, int causal, int q_offset,
                                   void* stream) {
  Args a{q, k, v, mask, nullptr, nullptr, nullptr, nullptr, o, lse, nullptr,
         B, H, Tq, Tk, causal, q_offset, (cudaStream_t)stream};
  return dispatch(0, dtype, dh, a);
}

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v, const void* mask,
                                  const void* o, const void* lse, const void* dout, void* dq,
                                  void* delta, int dtype, int B, int H, int Tq, int Tk, int dh,
                                  int causal, int q_offset, void* stream) {
  Args a{q, k, v, mask, o, lse, dout, nullptr, dq, delta, nullptr,
         B, H, Tq, Tk, causal, q_offset, (cudaStream_t)stream};
  return dispatch(1, dtype, dh, a);
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v,
                                   const void* mask, const void* lse, const void* dout,
                                   const void* delta, void* dk, void* dv, int dtype, int B,
                                   int H, int Tq, int Tk, int dh, int causal, int q_offset,
                                   void* stream) {
  Args a{q, k, v, mask, nullptr, lse, dout, delta, dk, dv, nullptr,
         B, H, Tq, Tk, causal, q_offset, (cudaStream_t)stream};
  return dispatch(2, dtype, dh, a);
}
