// Fused B=1 decode step for Hopper (sm_90a): all L decoder layers of one
// token in ONE launch.
//
// Replaces the Pallas TPU kernel `fused_decode_layers` (`_make_kernel`,
// parler_tts_tpu/ops/pallas/fused_decode_step.py). Per layer: LN1, int8
// q|k|v, self-attention over the cache rows [start, n_rows) plus the current
// token, out-proj + residual, LN2, cross q, cross-attention over the
// precomputed cross k/v, cross out + residual, LN3, fc1, activation, fc2 +
// residual. Returns the bf16 hidden state before the final LN, and the new
// k/v rows (L, 1, D) in bf16. The kernel does not write the cache; the caller
// writes the new rows at n_rows.
//
// What bounds it on this card: bytes. A step reads every int8 weight once
// (24 x 14.68 MB at mini-v1), the bf16 self k/v rows [start, n_rows) and the
// cross k/v: about 0.13 ms at 3.35 TB/s for 868 rows. Its operations (two per
// weight byte) are far below the tensor cores' line.
//
// Design (simple and right first):
//   * a persistent cooperative grid of (blocks per SM, at most 2) x SMs
//     blocks of 256 threads, launched by cudaLaunchCooperativeKernel;
//     grid.sync() separates the 8 dependent phases of a layer:
//       A [LN1 -> q|k|v]  B [self-attention]  C [out-proj + residual]
//       D [LN2 -> cross q]  E [cross-attention]  F [cross out + residual]
//       G [LN3 -> fc1 -> act]  H [fc2 + residual]
//     No block returns early: every block reaches every barrier;
//   * the fp32 residual (D floats) lives in global scratch; each block
//     recomputes a layer norm from it into shared memory instead of paying
//     a barrier for it;
//   * weights are stored output-major, (N, K) int8 per matrix: one warp
//     computes one output column, its 32 lanes reading K contiguous bytes in
//     16-byte loads (coalesced), converting int8 to fp32 by byte permutes,
//     with the bf16 input vector in shared memory; a warp shuffle sums;
//   * self-attention: one warp per (head, 32-row chunk of the cache), a lane
//     per row for the scores and a lane per 2 head dims for P.V; each chunk
//     writes (max, sum, acc) to scratch, and the last warp of a head to
//     arrive (atomic counter, reset by that warp) merges the chunks and the
//     current token, so the merge needs no barrier of its own;
//   * all inter-block data is read with ld.global.cg (L2), never from a
//     possibly stale L1 line.
//
// Rounding. The contract points of the Pallas kernel are kept: the residual
// is fp32 across layers; LN in fp32 (eps 1e-5), rounded to bf16 before each
// projection; projections bf16 x int8 with fp32 accumulation and the fp32
// scale; q = bf16(q * Dh^-0.5), k and v bf16; P rounded to bf16 before P.V;
// the current token joins last with an fp32 denominator; fc2's input rounded
// to bf16; tanh gelu. Of the TPU layout's artifacts, these are KEPT: each
// k*q product rounded to bf16 before the fp32 sum; the bf16 rescale factor
// on the accumulator with an fp32 one on the denominator; the bf16 cross
// denominator. The online softmax runs over 32-row chunks merged at the end
// instead of the Pallas kernel's sequential blocks, so the rounding that
// depends on tiling differs from it (`fused_decode_layers_plain` repeats the
// Pallas tiling at a given block_s; the tests bound the difference).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDh = 64;            // head dim: a lane owns 2 dims in P.V
constexpr int kChunk = 32;         // cache rows per self-attention work item
constexpr int kMaxBlocksPerSM = 2;
constexpr float kNegInf = -FLT_MAX;  // the Pallas kernel's finfo(float32).min

struct Params {
  const __nv_bfloat16* x_emb;                   // (D)
  const float *ln1s, *ln1b, *ln2s, *ln2b, *ln3s, *ln3b;  // (L, D)
  const int8_t* w_attn;   // (L, 6D, D): output rows [q | k | v | o | cq | co]
  const float* s_attn;    // (L, 6D)
  const int8_t* w_fc1;    // (L, F, D)
  const float* s_fc1;     // (L, F)
  const int8_t* w_fc2;    // (L, D, F)
  const float* s_fc2;     // (L, D)
  const __nv_bfloat16* cache_k;  // (L, S, D)
  const __nv_bfloat16* cache_v;
  const __nv_bfloat16* cross_k;  // (L, S_enc, D)
  const __nv_bfloat16* cross_v;
  const float* enc_bias;         // (S_enc) additive
  __nv_bfloat16* hidden;         // (D)
  __nv_bfloat16* new_k;          // (L, D)
  __nv_bfloat16* new_v;
  float* scratch;
  int* counters;                 // (H), zero between launches
  int L, D, H, F, S, S_enc, start, n_rows, act;
};

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// four int8 -> fp32: bytes placed under the exponent of 2^23, then the bias off
__device__ __forceinline__ void i8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

__device__ __forceinline__ void bf16x8(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x, f[2 * i + 1] = t.y;
  }
}

// one output column: sum_k vec[k] * w[k] over K int8 weights (K % 16 == 0)
__device__ __forceinline__ float warp_dot(const int8_t* __restrict__ w,
                                          const __nv_bfloat16* vec, int K, int lane) {
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  const uint4* v4 = reinterpret_cast<const uint4*>(vec);
  float acc = 0.f;
#pragma unroll 4
  for (int j = lane; j < K / 16; j += 32) {
    const uint4 raw = __ldg(w4 + j);
    float wf[16], xf[16];
    i8x4(raw.x, wf), i8x4(raw.y, wf + 4), i8x4(raw.z, wf + 8), i8x4(raw.w, wf + 12);
    bf16x8(v4[2 * j], xf), bf16x8(v4[2 * j + 1], xf + 8);
#pragma unroll
    for (int e = 0; e < 16; ++e) acc = fmaf(xf[e], wf[e], acc);
  }
  return warp_sum(acc);
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

// out = bf16(LN(x) * scale + bias); x is the fp32 residual in global scratch
__device__ void layer_norm(const float* x, const float* scale, const float* bias,
                           __nv_bfloat16* out, int D, float* red) {
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) s += __ldcg(x + i);
  const float mu = block_sum(s, red) / D;
  float v = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float d = __ldcg(x + i) - mu;
    v += d * d;
  }
  const float inv = rsqrtf(block_sum(v, red) / D + 1e-5f);
  for (int i = threadIdx.x; i < D; i += kThreads)
    out[i] = __float2bfloat16((__ldcg(x + i) - mu) * inv * scale[i] + bias[i]);
  __syncthreads();
}

// a bf16-valued fp32 vector in global scratch -> bf16 in shared memory
__device__ void load_vec(const float* src, __nv_bfloat16* dst, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = __float2bfloat16(__ldcg(src + i));
  __syncthreads();
}

__device__ __forceinline__ float activation(float x, int act) {
  if (act == 0) {  // tanh gelu
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
  }
  if (act == 1) return fmaxf(x, 0.f);
  return x / (1.f + expf(-x));  // silu
}

// self-attention work item: head h, cache rows [r0, r0 + 32) within [start, n_rows)
__device__ void self_attn_chunk(const Params& p, int layer, int h, int c, int nch,
                                const float* qs, float* part, const float* kn,
                                const float* vn, float* attn, int lane) {
  const int D = p.D;
  const int row = p.start + c * kChunk + lane;
  const bool valid = row < p.n_rows;
  const float* qh = qs + h * kDh;
  float s = kNegInf;
  if (valid) {
    const uint4* kr = reinterpret_cast<const uint4*>(
        p.cache_k + ((long long)layer * p.S + row) * D + h * kDh);
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < kDh / 8; ++u) {
      float kf[8];
      bf16x8(__ldg(kr + u), kf);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += bf16r(kf[e] * qh[u * 8 + e]);
    }
    s = acc;
  }
  const float m = warp_max(s);
  const float pr = valid ? expf(s - m) : 0.f;
  const float l = warp_sum(pr);
  const float pb = bf16r(pr);
  float a0 = 0.f, a1 = 0.f;
  const int n = min(kChunk, p.n_rows - (p.start + c * kChunk));
  const __nv_bfloat16* vbase =
      p.cache_v + ((long long)layer * p.S + p.start + c * kChunk) * D + h * kDh + 2 * lane;
  for (int r = 0; r < n; ++r) {
    const float pj = __shfl_sync(0xffffffffu, pb, r);
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vbase + (long long)r * D));
    a0 = fmaf(pj, v.x, a0);
    a1 = fmaf(pj, v.y, a1);
  }
  float* mine = part + ((long long)h * nch + c) * (kDh + 2);
  if (lane == 0) mine[0] = m, mine[1] = l;
  mine[2 + 2 * lane] = a0;
  mine[3 + 2 * lane] = a1;
  __threadfence();
  __syncwarp();
  int prev = 0;
  if (lane == 0) prev = atomicAdd(p.counters + h, 1);
  prev = __shfl_sync(0xffffffffu, prev, 0);
  if (prev != nch - 1) return;
  __threadfence();

  // the last chunk of head h merges all chunks and the current token
  const int d0 = h * kDh + 2 * lane;
  float cur = bf16r(__ldcg(kn + d0) * qh[2 * lane]) + bf16r(__ldcg(kn + d0 + 1) * qh[2 * lane + 1]);
  cur = warp_sum(cur);
  float big = cur;
  for (int i = 0; i < nch; ++i) big = fmaxf(big, __ldcg(part + ((long long)h * nch + i) * (kDh + 2)));
  float acc0 = 0.f, acc1 = 0.f, den = 0.f;
  for (int i = 0; i < nch; ++i) {
    const float* pi = part + ((long long)h * nch + i) * (kDh + 2);
    const float alpha = expf(__ldcg(pi) - big);
    const float ab = bf16r(alpha);
    acc0 = fmaf(__ldcg(pi + 2 + 2 * lane), ab, acc0);
    acc1 = fmaf(__ldcg(pi + 3 + 2 * lane), ab, acc1);
    den = fmaf(__ldcg(pi + 1), alpha, den);
  }
  const float pc = expf(cur - big);
  const float pcb = bf16r(pc);
  acc0 = fmaf(pcb, __ldcg(vn + d0), acc0);
  acc1 = fmaf(pcb, __ldcg(vn + d0 + 1), acc1);
  den = fmaxf(den + pc, 1e-30f);
  attn[d0] = bf16r(acc0 / den);
  attn[d0 + 1] = bf16r(acc1 / den);
  if (lane == 0) p.counters[h] = 0;
}

// cross-attention of head h over the S_enc encoder rows (online over groups of 32)
__device__ void cross_attn_head(const Params& p, int layer, int h, const float* qcs,
                                float* attnc, int lane) {
  const int D = p.D;
  const float* qh = qcs + h * kDh;
  float m = kNegInf, l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int p0 = 0; p0 < p.S_enc; p0 += 32) {
    const int pos = p0 + lane;
    const bool valid = pos < p.S_enc;
    float s = -INFINITY;
    if (valid) {
      const uint4* kr = reinterpret_cast<const uint4*>(
          p.cross_k + ((long long)layer * p.S_enc + pos) * D + h * kDh);
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < kDh / 8; ++u) {
        float kf[8];
        bf16x8(__ldg(kr + u), kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += bf16r(kf[e] * qh[u * 8 + e]);
      }
      s = acc + p.enc_bias[pos];
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float pr = valid ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(pr);
    a0 *= alpha;
    a1 *= alpha;
    const float pb = bf16r(pr);
    const int n = min(32, p.S_enc - p0);
    const __nv_bfloat16* vbase =
        p.cross_v + ((long long)layer * p.S_enc + p0) * D + h * kDh + 2 * lane;
    for (int r = 0; r < n; ++r) {
      const float pj = __shfl_sync(0xffffffffu, pb, r);
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vbase + (long long)r * D));
      a0 = fmaf(pj, v.x, a0);
      a1 = fmaf(pj, v.y, a1);
    }
    m = m_new;
  }
  const float den = bf16r(fmaxf(l, 1e-30f));
  attnc[h * kDh + 2 * lane] = bf16r(a0 / den);
  attnc[h * kDh + 2 * lane + 1] = bf16r(a1 / den);
}

__global__ void __launch_bounds__(kThreads) fused_decode_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  const int D = p.D, F = p.F, H = p.H;
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * kWarps;
  const float inv_sqrt_dh = rsqrtf((float)kDh);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* vec = reinterpret_cast<__nv_bfloat16*>(smem_raw);           // max(D, F)
  float* fsm = reinterpret_cast<float*>(smem_raw + sizeof(__nv_bfloat16) * (D > F ? D : F));
  float* red = fsm + D;                                                        // kWarps

  float* x = p.scratch;      // fp32 residual
  float* q = x + D;          // bf16-valued
  float* kn = q + D;
  float* vn = kn + D;
  float* attn = vn + D;
  float* qc = attn + D;
  float* attnc = qc + D;
  float* mid = attnc + D;    // F
  float* part = mid + F;     // H * nch * (Dh + 2)

  const int rows = p.n_rows - p.start;
  const int nch = rows > 0 ? (rows + kChunk - 1) / kChunk : 1;

  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < D; i += kThreads) x[i] = __bfloat162float(p.x_emb[i]);
  grid.sync();

  for (int layer = 0; layer < p.L; ++layer) {
    const int8_t* wa = p.w_attn + (long long)layer * 6 * D * D;
    const float* sa = p.s_attn + (long long)layer * 6 * D;

    // A: LN1 -> q | k | v
    layer_norm(x, p.ln1s + layer * D, p.ln1b + layer * D, vec, D, red);
    for (int col = gwarp; col < 3 * D; col += nwarps) {
      const float y = warp_dot(wa + (long long)col * D, vec, D, lane) * sa[col];
      if (lane == 0) {
        if (col < D) {
          q[col] = bf16r(y * inv_sqrt_dh);
        } else if (col < 2 * D) {
          kn[col - D] = bf16r(y);
          p.new_k[layer * D + col - D] = __float2bfloat16(y);
        } else {
          vn[col - 2 * D] = bf16r(y);
          p.new_v[layer * D + col - 2 * D] = __float2bfloat16(y);
        }
      }
    }
    grid.sync();

    // B: self-attention chunks; the last chunk of each head merges
    for (int i = threadIdx.x; i < D; i += kThreads) fsm[i] = __ldcg(q + i);
    __syncthreads();
    for (int item = gwarp; item < H * nch; item += nwarps)
      self_attn_chunk(p, layer, item / nch, item % nch, nch, fsm, part, kn, vn, attn, lane);
    grid.sync();

    // C: out-proj + residual
    load_vec(attn, vec, D);
    for (int col = gwarp; col < D; col += nwarps) {
      const float y = warp_dot(wa + (long long)(3 * D + col) * D, vec, D, lane) * sa[3 * D + col];
      if (lane == 0) x[col] = __ldcg(x + col) + y;
    }
    grid.sync();

    // D: LN2 -> cross q
    layer_norm(x, p.ln2s + layer * D, p.ln2b + layer * D, vec, D, red);
    for (int col = gwarp; col < D; col += nwarps) {
      const float y = warp_dot(wa + (long long)(4 * D + col) * D, vec, D, lane) * sa[4 * D + col];
      if (lane == 0) qc[col] = bf16r(y * inv_sqrt_dh);
    }
    grid.sync();

    // E: cross-attention, one warp per head
    for (int i = threadIdx.x; i < D; i += kThreads) fsm[i] = __ldcg(qc + i);
    __syncthreads();
    for (int h = gwarp; h < H; h += nwarps) cross_attn_head(p, layer, h, fsm, attnc, lane);
    grid.sync();

    // F: cross out + residual
    load_vec(attnc, vec, D);
    for (int col = gwarp; col < D; col += nwarps) {
      const float y = warp_dot(wa + (long long)(5 * D + col) * D, vec, D, lane) * sa[5 * D + col];
      if (lane == 0) x[col] = __ldcg(x + col) + y;
    }
    grid.sync();

    // G: LN3 -> fc1 -> activation
    layer_norm(x, p.ln3s + layer * D, p.ln3b + layer * D, vec, D, red);
    const int8_t* w1 = p.w_fc1 + (long long)layer * F * D;
    for (int col = gwarp; col < F; col += nwarps) {
      const float y = warp_dot(w1 + (long long)col * D, vec, D, lane) * p.s_fc1[(long long)layer * F + col];
      if (lane == 0) mid[col] = activation(y, p.act);
    }
    grid.sync();

    // H: fc2 (input rounded to bf16) + residual
    load_vec(mid, vec, F);
    const int8_t* w2 = p.w_fc2 + (long long)layer * D * F;
    for (int col = gwarp; col < D; col += nwarps) {
      const float y = warp_dot(w2 + (long long)col * F, vec, F, lane) * p.s_fc2[(long long)layer * D + col];
      if (lane == 0) x[col] = __ldcg(x + col) + y;
    }
    grid.sync();
  }

  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < D; i += kThreads) p.hidden[i] = __float2bfloat16(__ldcg(x + i));
}

size_t smem_bytes(int D, int F) {
  return sizeof(__nv_bfloat16) * (size_t)(D > F ? D : F) + sizeof(float) * ((size_t)D + kWarps);
}

int grid_blocks(int D, int F, int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t smem = smem_bytes(D, F);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_decode_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms * (per_sm < kMaxBlocksPerSM ? per_sm : kMaxBlocksPerSM);
  return 0;
}

}  // namespace

extern "C" {

// fp32 scratch the wrapper allocates: residual, q, k, v, attn, cross q and
// attn, the MLP's middle, and the self-attention chunk partials
long long fused_decode_scratch_floats(int D, int F, int H, int S) {
  const long long nch = (S + kChunk - 1) / kChunk + 1;
  return 7LL * D + F + (long long)H * nch * (kDh + 2);
}

int fused_decode_head_dim() { return kDh; }

// Blocks of the cooperative grid on the current device (0 and `*blocks` set)
// or a cudaError_t.
int fused_decode_grid_blocks(int D, int F, int* blocks) { return grid_blocks(D, F, blocks); }

// act: 0 = tanh gelu, 1 = relu, 2 = silu. Returns a cudaError_t (0 = launched).
int fused_decode_launch(const void* x_emb, const void* ln1s, const void* ln1b, const void* ln2s,
                        const void* ln2b, const void* ln3s, const void* ln3b, const void* w_attn,
                        const void* s_attn, const void* w_fc1, const void* s_fc1,
                        const void* w_fc2, const void* s_fc2, const void* cache_k,
                        const void* cache_v, const void* cross_k, const void* cross_v,
                        const void* enc_bias, void* hidden, void* new_k, void* new_v,
                        void* scratch, void* counters, int L, int D, int H, int F, int S,
                        int S_enc, int start, int n_rows, int act, void* stream) {
  if (L <= 0 || H <= 0 || D != H * kDh || F <= 0 || F % 16 != 0 || S_enc <= 0 || start < 0 ||
      n_rows < 0 || n_rows > S || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const void* vecs[] = {w_attn, w_fc1, w_fc2, cache_k, cache_v, cross_k, cross_v};
  for (const void* ptr : vecs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  int blocks = 0;
  int err = grid_blocks(D, F, &blocks);
  if (err != 0) return err;
  Params p;
  p.x_emb = static_cast<const __nv_bfloat16*>(x_emb);
  p.ln1s = static_cast<const float*>(ln1s), p.ln1b = static_cast<const float*>(ln1b);
  p.ln2s = static_cast<const float*>(ln2s), p.ln2b = static_cast<const float*>(ln2b);
  p.ln3s = static_cast<const float*>(ln3s), p.ln3b = static_cast<const float*>(ln3b);
  p.w_attn = static_cast<const int8_t*>(w_attn), p.s_attn = static_cast<const float*>(s_attn);
  p.w_fc1 = static_cast<const int8_t*>(w_fc1), p.s_fc1 = static_cast<const float*>(s_fc1);
  p.w_fc2 = static_cast<const int8_t*>(w_fc2), p.s_fc2 = static_cast<const float*>(s_fc2);
  p.cache_k = static_cast<const __nv_bfloat16*>(cache_k);
  p.cache_v = static_cast<const __nv_bfloat16*>(cache_v);
  p.cross_k = static_cast<const __nv_bfloat16*>(cross_k);
  p.cross_v = static_cast<const __nv_bfloat16*>(cross_v);
  p.enc_bias = static_cast<const float*>(enc_bias);
  p.hidden = static_cast<__nv_bfloat16*>(hidden);
  p.new_k = static_cast<__nv_bfloat16*>(new_k), p.new_v = static_cast<__nv_bfloat16*>(new_v);
  p.scratch = static_cast<float*>(scratch);
  p.counters = static_cast<int*>(counters);
  p.L = L, p.D = D, p.H = H, p.F = F, p.S = S, p.S_enc = S_enc;
  p.start = start, p.n_rows = n_rows, p.act = act;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)fused_decode_kernel, dim3(blocks),
                                              dim3(kThreads), args, smem_bytes(D, F),
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
