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
// weight byte) are far below the tensor cores' line. None of the weights
// depends on the token, so the weight stream can run ahead of the chain of
// dependent phases, and a step costs about the larger of the two. Measured
// (chip_smoke.py phase f and the stripped variants below), the chain is the
// larger by far, and most of it is each block's own serial work between its
// waits: GEMV rows one warp at a time, single-warp attention arithmetic, and
// the L2 round trips of its own reads.
//
// Design:
//   * one persistent block per SM (cudaLaunchCooperativeKernel, which refuses
//     a grid that cannot be resident at once, so the spin-waits below cannot
//     wait on a block that never starts), warp-specialised: kConsumerWarps
//     consumer warps and one producer warp;
//   * fixed ownership: block b owns one contiguous range of output rows of
//     every phase's weight matrix (`part_lo`), so its share of a phase of a
//     layer is one contiguous run of int8 bytes (the weights are
//     output-major), about 111 KB per layer at mini-v1;
//   * lane 0 of the producer warp streams those runs, in the order the
//     consumers use them, into a ring of kStageBytes stages in shared memory
//     with 1-D bulk copies (`cp.async.bulk`, completion counted on each
//     stage's full mbarrier; the consumers free a stage on its empty
//     mbarrier). It never waits on the token, only on ring space, so it runs
//     about a layer ahead and the consumers never wait for weight bytes;
//   * no grid barrier: each dependency is waited for where it is, by one of
//     two means. Per-head data (a head's 192 q|k|v columns, before that
//     head's self-attention chunks; its 64 cross q columns, before its
//     cross-attention) goes behind dependency counters: after its stores a
//     writer publishes with release semantics (a barrier of the writing
//     threads, then `red.release.gpu` from one thread), a reader spins on an
//     acquire load until the counter reaches a target derived from the layer
//     index, then reads the data through L2 (`ld.global.cg`), never from a
//     possibly stale L1 line. The block-wide vectors every block reads in
//     full (the residual after each of its three updates, before LN2, LN3
//     and the next layer's LN1; the merged self and cross heads, before
//     out-proj and cross out; the MLP middle, before fc2) travel as tagged
//     words: 32 bits of data and the tag of the step that wrote them in one
//     64-bit store, which a reader polls until every word it needs carries
//     the step's tag. That is one L2 round trip where a counter costs a
//     fence, an atomic, a poll and a read. Tags count in a launch epoch, so a
//     word left by an earlier launch never matches;
//   * a block owns the same residual columns in out-proj, cross out and fc2
//     and keeps them in shared memory, so its residual updates need no wait
//     and no read, and it writes its columns of the hidden state after the
//     last fc2. The last block to finish sets the counters back to 0 and
//     advances the epoch, so a repeated launch needs no host reset and gives
//     the same bits. A wait that stays unmet for kWatchdogNs traps (a launch
//     error) instead of holding the card;
//   * GEMVs: one warp per output row, its 32 lanes reading the row's int8
//     bytes from the ring in 16-byte words and the bf16 input vector from
//     shared memory, converting int8 to fp32 by byte permutes, with four
//     partial sums per lane; scales and layer-norm parameters are loaded
//     before the wait that precedes their use;
//   * self-attention: one warp per (head, kChunk-row chunk of the cache), a
//     lane per row for the scores and a lane per 2 head dims for P.V; a
//     chunk's k and v rows are loaded into registers before the wait for its
//     head's q, and the last chunk of a head to arrive merges all chunks and
//     the current token; cross-attention: one warp per head, its first 32
//     encoder rows loaded before the wait for its cross q.
//
// Rounding. The contract points of the Pallas kernel are kept: the residual
// is fp32 across layers; LN in fp32 (eps 1e-5), rounded to bf16 before each
// projection; projections bf16 x int8 with fp32 accumulation and the fp32
// scale; q = bf16(q * Dh^-0.5), k and v bf16; P rounded to bf16 before P.V;
// the current token joins last with an fp32 denominator; fc2's input rounded
// to bf16; tanh gelu. Of the TPU layout's artifacts, these are KEPT: each
// k*q product rounded to bf16 before the fp32 sum; the bf16 rescale factor
// on the accumulator with an fp32 one on the denominator; the bf16 cross
// denominator. The online softmax runs over kChunk-row chunks from `start`,
// merged at the end, and the encoder rows online over groups of 32, instead
// of the Pallas kernel's sequential blocks (`fused_decode_layers_plain(...,
// tiling="cuda", block_s=kChunk)` repeats this tiling).
//
// Two stripped variants of the same template time the two halves of the
// step: kStreamOnly (the ring and the consumers' work, no dependency waits)
// and kChainOnly (the dependency waits and the consumers' work, no weight
// bytes: the producer copies nothing and the GEMVs read whatever the ring
// holds). Both give meaningless numbers and serve timing only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kDh = 64;                    // head dim: a lane owns 2 dims in P.V
constexpr int kChunk = 32;                 // cache rows per self-attention work item
constexpr int kStageBytes = 16384;         // one ring stage; a weight row must fit
constexpr int kMaxStages = 12;
constexpr int kLnPer = 8;                  // LN entries per consumer thread: D <= 2048
constexpr float kNegInf = -FLT_MAX;        // the Pallas kernel's finfo(float32).min
constexpr unsigned long long kWatchdogNs = 2000000000ull;

enum Mode { kFull = 0, kStreamOnly = 1, kChainOnly = 2 };

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
  const int* start_ptr;          // () int32 on the device, or null: `start`
  const int* n_rows_ptr;         // () int32 on the device, or null: `n_rows`
  __nv_bfloat16* hidden;         // (D)
  __nv_bfloat16* new_k;          // (L, D)
  __nv_bfloat16* new_v;
  float* scratch;                // `Scratch`
  int* counters;                 // (3H + 2), zeroed once (`Counters`)
  int L, D, H, F, S, S_enc, start, n_rows, act, stages, n_scl;
};

// the global scratch of a launch, zeroed once: q, the new k and v, cross q
// (bf16-valued fp32, behind per-head counters); the tagged words of the
// block-wide vectors (`st_word`): the residual (an fp32 a word), the merged
// self and cross heads and the MLP middle (two bf16 a word); the
// self-attention chunk partials (max, sum, 64 accumulators)
struct Scratch {
  float *q, *kn, *vn, *qc;
  unsigned long long *xw, *aw, *cw, *mw;
  float* part;
};

__host__ __device__ __forceinline__ long long scratch_floats(int D, int F, int H, int S) {
  const long long nch = (S + kChunk - 1) / kChunk + 1;
  return 4LL * D + 2LL * (2 * D + F / 2) + (long long)H * nch * (kDh + 2);
}

__device__ __forceinline__ Scratch scratch_of(float* s, int D, int F) {
  Scratch r;
  r.q = s, r.kn = s + D, r.vn = s + 2 * D, r.qc = s + 3 * D;
  r.xw = reinterpret_cast<unsigned long long*>(s + 4 * D);
  r.aw = r.xw + D;
  r.cw = r.aw + D / 2;
  r.mw = r.cw + D / 2;
  r.part = reinterpret_cast<float*>(r.mw + F / 2);
  return r;
}

// per-head dependency counters (they only grow within a launch; the last
// block resets them), the finished blocks, and the launch epoch that tags the
// block-wide vectors' words (the last block advances it)
struct Counters {
  int *qkv, *arr, *cq, *done, *epoch;
};

__device__ __forceinline__ Counters counters_of(int* c, int H) {
  return {c, c + H, c + 2 * H, c + 3 * H, c + 3 * H + 1};
}

// the tag of a block-wide vector written in `step` (>= 1) of the launch of `epoch`
__device__ __forceinline__ uint32_t tag_of(uint32_t epoch, int step) {
  return epoch * 4096u + (uint32_t)step;
}

// ---------------------------------------------------------------- PTX wrappers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer() - t0 > kWatchdogNs) __trap();
}

// global -> shared, `bytes` (a multiple of 16) counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// add `v` to a counter, ordered after every store this thread has seen
__device__ __forceinline__ void red_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// the same, returning the old value, with acquire semantics on it too
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// a word of a block-wide vector: 32 bits of data and the tag of the step that
// wrote it, stored and loaded as one 64-bit access, so a reader that sees the
// tag sees the data (no fence, no counter, no second read)
__device__ __forceinline__ void st_word(unsigned long long* p, uint32_t data, uint32_t tag) {
  const unsigned long long w = ((unsigned long long)tag << 32) | data;
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long ld_word(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
  return w;
}

// words idx[0..N) (negative: none) of a block-wide vector, all in flight at
// once, reloaded until each carries `tag`; their data into out
template <int kMode, int N>
__device__ __forceinline__ void ld_words(const unsigned long long* words, const int* idx,
                                         uint32_t tag, uint32_t* out) {
  unsigned long long w[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    w[k] = idx[k] >= 0 ? ld_word(words + idx[k]) : (unsigned long long)tag << 32;
  if (kMode != kStreamOnly) {
    unsigned long long t0 = 0;
    for (unsigned spin = 0;; ++spin) {
      bool ready = true;
#pragma unroll
      for (int k = 0; k < N; ++k)
        if ((uint32_t)(w[k] >> 32) != tag) {
          ready = false;
          w[k] = ld_word(words + idx[k]);
        }
      if (ready) break;
      if (spin == 0) t0 = globaltimer();
      else if ((spin & 255) == 0 && globaltimer() - t0 > kWatchdogNs) __trap();
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = (uint32_t)w[k];
}

template <int kMode>
__device__ __forceinline__ void wait_for(const int* counter, int target) {
  if (kMode == kStreamOnly || ld_acquire(counter) >= target) return;
  const unsigned long long t0 = globaltimer();
  for (unsigned spin = 1; ld_acquire(counter) < target; ++spin)
    if ((spin & 255) == 0 && globaltimer() - t0 > kWatchdogNs) __trap();
}

// the consumer warps only: the producer warp never takes part
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ---------------------------------------------------------------- arithmetic
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

// one row of K int8 weights (K % 16 == 0) times the bf16 vector, both in
// shared memory: four partial sums per lane, so the chain of dependent FMAs
// is a quarter as long
__device__ __forceinline__ void lane_dot(const int8_t* w, const __nv_bfloat16* vec, int K,
                                         int lane, float* acc) {
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  const uint4* v4 = reinterpret_cast<const uint4*>(vec);
#pragma unroll 2
  for (int j = lane; j < K / 16; j += 32) {
    float xf[16], wf[16];
    const uint4 raw = w4[j];
    i8x4(raw.x, wf), i8x4(raw.y, wf + 4), i8x4(raw.z, wf + 8), i8x4(raw.w, wf + 12);
    bf16x8(v4[2 * j], xf), bf16x8(v4[2 * j + 1], xf + 8);
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e & 3] = fmaf(xf[e], wf[e], acc[e & 3]);
  }
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  consumer_sync();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kConsumerWarps; ++w) t += red[w];
  consumer_sync();
  return t;
}

__device__ __forceinline__ float activation(float x, int act) {
  if (act == 0) {  // tanh gelu
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
  }
  if (act == 1) return fmaxf(x, 0.f);
  return x / (1.f + expf(-x));  // silu
}

// ---------------------------------------------------------------- ownership
// block b of G owns rows [part_lo(N, G, b), part_lo(N, G, b + 1)) of an N-row phase
__device__ __forceinline__ int part_lo(int n, int g, int b) {
  return (int)((long long)n * b / g);
}

// one phase's weights of one block: `rows` output rows of K int8 bytes, contiguous
struct Segment {
  const int8_t* w;
  int rows, K;
};

// phases in stream order: 0 q|k|v, 1 out, 2 cross q, 3 cross out, 4 fc1, 5 fc2
__device__ __forceinline__ Segment segment(const Params& p, int layer, int phase, int b) {
  const int D = p.D, F = p.F, G = gridDim.x;
  const long long la = (long long)layer * 6 * D;
  if (phase == 0) {
    const int lo = part_lo(3 * D, G, b);
    return {p.w_attn + (la + lo) * D, part_lo(3 * D, G, b + 1) - lo, D};
  }
  const int lo = part_lo(D, G, b), n = part_lo(D, G, b + 1) - lo;
  if (phase <= 3) return {p.w_attn + (la + (2 + phase) * D + lo) * D, n, D};
  if (phase == 5) return {p.w_fc2 + ((long long)layer * D + lo) * F, n, F};
  const int g0 = 2 * part_lo(F / 2, G, b);  // pairs of rows: two bf16 a word of the middle
  return {p.w_fc1 + ((long long)layer * F + g0) * D, 2 * part_lo(F / 2, G, b + 1) - g0, D};
}

struct Ring {
  unsigned char* buf;
  uint64_t* full;
  uint64_t* empty;
  int stages;
  uint32_t it;  // chunks taken so far, the same sequence on both sides
};

// consumers: the rows of `seg` through the ring, row r to warp r % kConsumerWarps;
// epi(r, dot) on lane 0. Every consumer warp takes and
// frees every chunk.
template <int kMode, class Epi>
__device__ __forceinline__ void gemv(Ring& ring, const Segment& seg, const __nv_bfloat16* vec,
                                     int warp, int lane, Epi epi) {
  const int per = kStageBytes / seg.K;
  for (int r0 = 0; r0 < seg.rows; r0 += per) {
    const int r1 = min(seg.rows, r0 + per);
    const int st = ring.it % ring.stages;
    const uint32_t parity = (ring.it / ring.stages) & 1;
    ++ring.it;
    if (kMode != kChainOnly) mbar_wait(&ring.full[st], parity);
    const int8_t* w = reinterpret_cast<const int8_t*>(ring.buf + (size_t)st * kStageBytes);
    for (int r = r0 + (warp - r0 % kConsumerWarps + kConsumerWarps) % kConsumerWarps; r < r1;
         r += kConsumerWarps) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      lane_dot(w + (size_t)(r - r0) * seg.K, vec, seg.K, lane, a);
      const float y = warp_sum((a[0] + a[1]) + (a[2] + a[3]));
      if (lane == 0) epi(r, y);
    }
    __syncwarp();
    if (kMode != kChainOnly && lane == 0) mbar_arrive(&ring.empty[st]);
  }
}

// ---------------------------------------------------------------- producer
// lane 0 of the producer warp: this block's weight segments, layer by layer,
// phase by phase, in kStageBytes chunks through the ring
template <int kMode>
__device__ void producer(const Params& p, Ring& ring) {
  for (int layer = 0; layer < p.L; ++layer) {
    for (int phase = 0; kMode != kChainOnly && phase < 6; ++phase) {
      const Segment seg = segment(p, layer, phase, blockIdx.x);
      const int per = kStageBytes / seg.K;
      for (int r0 = 0; r0 < seg.rows; r0 += per) {
        const int st = ring.it % ring.stages;
        if (ring.it >= (uint32_t)ring.stages)
          mbar_wait(&ring.empty[st], ((ring.it / ring.stages) - 1) & 1);
        ++ring.it;
        const uint32_t bytes = (uint32_t)(min(per, seg.rows - r0) * seg.K);
        mbar_expect_tx(&ring.full[st], bytes);
        bulk_copy(ring.buf + (size_t)st * kStageBytes, seg.w + (size_t)r0 * seg.K, bytes,
                  &ring.full[st]);
      }
    }
  }
}

// ---------------------------------------------------------------- consumers
// out = bf16(LN(x) * scale + bias) into shared memory, after the phase
// before it ended in consumer_sync; x is the fp32 residual from its words
// with tag `tag` (xw) or, before layer 0, the bf16 input (xb); sc and bi are
// this thread's entries of the scale and bias (`ln_params`)
template <int kMode>
__device__ void layer_norm(const unsigned long long* xw, uint32_t tag, const __nv_bfloat16* xb,
                           const float* sc, const float* bi, __nv_bfloat16* out, int D,
                           float* red) {
  float xv[kLnPer], s = 0.f;
  if (xw) {
    int idx[kLnPer];
    uint32_t bits[kLnPer];
#pragma unroll
    for (int k = 0; k < kLnPer; ++k)
      idx[k] = threadIdx.x + k * kConsumers < D ? threadIdx.x + k * kConsumers : -1;
    ld_words<kMode, kLnPer>(xw, idx, tag, bits);
#pragma unroll
    for (int k = 0; k < kLnPer; ++k) xv[k] = idx[k] >= 0 ? __uint_as_float(bits[k]) : 0.f;
  } else {
#pragma unroll
    for (int k = 0; k < kLnPer; ++k) {
      const int i = threadIdx.x + k * kConsumers;
      xv[k] = i < D ? __bfloat162float(xb[i]) : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kLnPer; ++k) s += xv[k];
  const float mu = block_sum(s, red) / D;
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < kLnPer; ++k)
    if (threadIdx.x + k * kConsumers < D) v += (xv[k] - mu) * (xv[k] - mu);
  const float inv = rsqrtf(block_sum(v, red) / D + 1e-5f);
#pragma unroll
  for (int k = 0; k < kLnPer; ++k) {
    const int i = threadIdx.x + k * kConsumers;
    if (i < D) out[i] = __float2bfloat16((xv[k] - mu) * inv * sc[k] + bi[k]);
  }
  consumer_sync();
}

// this layer's LN scale and bias entries of this thread, loaded before the wait
__device__ __forceinline__ void ln_params(const float* scale, const float* bias, int D,
                                          float* sc, float* bi) {
#pragma unroll
  for (int k = 0; k < kLnPer; ++k) {
    const int i = threadIdx.x + k * kConsumers;
    sc[k] = i < D ? __ldg(scale + i) : 0.f;
    bi[k] = i < D ? __ldg(bias + i) : 0.f;
  }
}

// a bf16 vector of n (n % 2 == 0) from its words with tag `tag` (two bf16 a
// word) into shared memory, kVecWords words per thread in flight at once
constexpr int kVecWords = 8;
template <int kMode>
__device__ void read_vec(const unsigned long long* words, uint32_t tag, __nv_bfloat16* dst,
                         int n) {
  for (int i0 = threadIdx.x; i0 < n / 2; i0 += kConsumers * kVecWords) {
    int idx[kVecWords];
    uint32_t bits[kVecWords];
#pragma unroll
    for (int u = 0; u < kVecWords; ++u)
      idx[u] = i0 + u * kConsumers < n / 2 ? i0 + u * kConsumers : -1;
    ld_words<kMode, kVecWords>(words, idx, tag, bits);
#pragma unroll
    for (int u = 0; u < kVecWords; ++u)
      if (idx[u] >= 0) reinterpret_cast<uint32_t*>(dst)[idx[u]] = bits[u];
  }
  consumer_sync();
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a warp's 32 rows of one head: k (a row per lane) and v (2 dims per lane)
struct Rows {
  uint4 k[kDh / 8];
  __nv_bfloat162 v[32];
};

// rows [r0, r0 + n) of head h from a (rows, D) bf16 k/v pair, zero past n
__device__ __forceinline__ void load_rows(Rows& t, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, long long r0, int n, int h,
                                          int D, int lane) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const uint4* kr = reinterpret_cast<const uint4*>(k + (r0 + lane) * D + h * kDh);
#pragma unroll
  for (int u = 0; u < kDh / 8; ++u) t.k[u] = lane < n ? __ldg(kr + u) : zero;
  const __nv_bfloat16* vb = v + r0 * D + h * kDh + 2 * lane;
#pragma unroll
  for (int j = 0; j < 32; ++j)
    t.v[j] = j < n ? *reinterpret_cast<const __nv_bfloat162*>(vb + (long long)j * D)
                   : __floats2bfloat162_rn(0.f, 0.f);
}

// sum over the head dims of bf16(k * q), q in shared memory
__device__ __forceinline__ float row_score(const Rows& t, const float* qh) {
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < kDh / 8; ++u) {
    float kf[8];
    bf16x8(t.k[u], kf);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += bf16r(kf[e] * qh[u * 8 + e]);
  }
  return acc;
}

// P . V over the warp's rows: lane j's weight pb times row j, 2 dims per lane
__device__ __forceinline__ void p_dot_v(const Rows& t, float pb, float& a0, float& a1) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float pj = __shfl_sync(0xffffffffu, pb, j);
    const float2 v = __bfloat1622float2(t.v[j]);
    a0 = fmaf(pj, v.x, a0);
    a1 = fmaf(pj, v.y, a1);
  }
}

// head h of a bf16-valued fp32 vector in global scratch -> the warp's shared slot
__device__ __forceinline__ void head_to_shared(const float* src, int h, float* qh, int lane) {
  const float2 v = __ldcg(reinterpret_cast<const float2*>(src + h * kDh) + lane);
  qh[2 * lane] = v.x, qh[2 * lane + 1] = v.y;
  __syncwarp();
}

// self-attention work item: head h, cache rows [r0, r0 + kChunk) within [start, n_rows)
template <int kMode>
__device__ void self_attn_chunk(const Params& p, const Scratch& sc, const Counters& c,
                                int layer, int h, int ch, int nch, int start, int n_rows,
                                uint32_t tag, float* qh, int lane) {
  const int D = p.D;
  const int r0 = start + ch * kChunk;
  const int n = min(kChunk, n_rows - r0);
  const bool valid = lane < n;
  Rows t;  // the token-independent reads go first
  load_rows(t, p.cache_k, p.cache_v, (long long)layer * p.S + r0, n, h, D, lane);

  if (lane == 0) wait_for<kMode>(c.qkv + h, 3 * kDh * (layer + 1));
  __syncwarp();
  head_to_shared(sc.q, h, qh, lane);
  const float s = valid ? row_score(t, qh) : kNegInf;
  const float m = warp_max(s);
  const float pr = valid ? expf(s - m) : 0.f;
  const float l = warp_sum(pr);
  float a0 = 0.f, a1 = 0.f;
  p_dot_v(t, bf16r(pr), a0, a1);
  float* mine = sc.part + ((long long)h * nch + ch) * (kDh + 2);
  if (lane == 0) mine[0] = m, mine[1] = l;
  reinterpret_cast<float2*>(mine + 2)[lane] = make_float2(a0, a1);
  __syncwarp();  // the lanes' stores before lane 0's release
  int prev = 0;
  if (lane == 0) prev = atom_add_acq_rel(c.arr + h, 1);
  prev = __shfl_sync(0xffffffffu, prev, 0);
  if (prev != nch * (layer + 1) - 1) return;
  __syncwarp();  // lane 0's acquire before the lanes' reads

  // the last chunk of head h merges all chunks (in chunk order) and the current token
  const int d0 = h * kDh + 2 * lane;
  const float2 kc = __ldcg(reinterpret_cast<const float2*>(sc.kn + d0));
  const float2 vc = __ldcg(reinterpret_cast<const float2*>(sc.vn + d0));
  const float cur = warp_sum(bf16r(kc.x * qh[2 * lane]) + bf16r(kc.y * qh[2 * lane + 1]));
  const float* ph = sc.part + (long long)h * nch * (kDh + 2);
  float big = cur, m0 = kNegInf, l0 = 0.f;  // m0, l0: chunk `lane`'s max and sum
  for (int i0 = 0; i0 < nch; i0 += 32) {
    const int i = i0 + lane;
    const float2 ml = i < nch ? __ldcg(reinterpret_cast<const float2*>(ph + (long long)i * (kDh + 2)))
                              : make_float2(kNegInf, 0.f);
    if (i0 == 0) m0 = ml.x, l0 = ml.y;
    big = fmaxf(big, warp_max(ml.x));
  }
  float acc0 = 0.f, acc1 = 0.f, den = 0.f;
  for (int i0 = 0; i0 < nch; i0 += 32) {
    const int i = i0 + lane;
    float alpha = 0.f, li = 0.f;
    if (i < nch) {
      const float2 ml = i0 == 0 ? make_float2(m0, l0)
                                : __ldcg(reinterpret_cast<const float2*>(ph + (long long)i * (kDh + 2)));
      alpha = expf(ml.x - big);
      li = ml.y;
    }
    const float ab = bf16r(alpha);
    const int cnt = min(32, nch - i0);
#pragma unroll 8
    for (int j = 0; j < cnt; ++j) {
      const float2 a = __ldcg(reinterpret_cast<const float2*>(
                                  ph + (long long)(i0 + j) * (kDh + 2) + 2) + lane);
      const float aj = __shfl_sync(0xffffffffu, ab, j);
      acc0 = fmaf(a.x, aj, acc0);
      acc1 = fmaf(a.y, aj, acc1);
      den = fmaf(__shfl_sync(0xffffffffu, li, j), __shfl_sync(0xffffffffu, alpha, j), den);
    }
  }
  const float pc = expf(cur - big);
  const float pcb = bf16r(pc);
  acc0 = fmaf(pcb, vc.x, acc0);
  acc1 = fmaf(pcb, vc.y, acc1);
  den = fmaxf(den + pc, 1e-30f);
  st_word(sc.aw + d0 / 2, bf16x2_bits(acc0 / den, acc1 / den), tag);
}

// cross-attention of head h over the S_enc encoder rows (online over groups of 32)
template <int kMode>
__device__ void cross_attn_head(const Params& p, const Scratch& sc, const Counters& c,
                                int layer, int h, uint32_t tag, float* qh, int lane) {
  const int D = p.D;
  const long long base = (long long)layer * p.S_enc;
  Rows t;  // the first group goes before the wait
  load_rows(t, p.cross_k, p.cross_v, base, min(32, p.S_enc), h, D, lane);
  float bias = lane < p.S_enc ? p.enc_bias[lane] : 0.f;

  if (lane == 0) wait_for<kMode>(c.cq + h, kDh * (layer + 1));
  __syncwarp();
  head_to_shared(sc.qc, h, qh, lane);
  float m = kNegInf, l = 0.f, a0 = 0.f, a1 = 0.f;
  for (int p0 = 0; p0 < p.S_enc; p0 += 32) {
    if (p0 > 0) {
      load_rows(t, p.cross_k, p.cross_v, base + p0, min(32, p.S_enc - p0), h, D, lane);
      bias = p0 + lane < p.S_enc ? p.enc_bias[p0 + lane] : 0.f;
    }
    const bool valid = p0 + lane < p.S_enc;
    const float s = valid ? row_score(t, qh) + bias : -INFINITY;
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float pr = valid ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(pr);
    a0 *= alpha;
    a1 *= alpha;
    p_dot_v(t, bf16r(pr), a0, a1);
    m = m_new;
  }
  const float den = bf16r(fmaxf(l, 1e-30f));
  st_word(sc.cw + h * kDh / 2 + lane, bf16x2_bits(a0 / den, a1 / den), tag);
  __syncwarp();  // `qh` is free
}

// warp 0, a lane per head: after the block's stores, add the columns of
// [lo, hi) that fall in head h of each of `parts` consecutive D-column parts
// to counter[h]
__device__ __forceinline__ void publish_heads(int* counter, int lo, int hi, int parts, int D,
                                              int H, int lane) {
  for (int h = lane; h < H; h += 32) {
    int n = 0;
    for (int part = 0; part < parts; ++part) {
      const int a = part * D + h * kDh;
      n += max(0, min(hi, a + kDh) - max(lo, a));
    }
    if (n) red_release(counter + h, n);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1) fused_decode_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, F = p.F, H = p.H, G = gridDim.x, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float inv_sqrt_dh = rsqrtf((float)kDh);

  Ring ring;
  ring.buf = smem;
  ring.full = reinterpret_cast<uint64_t*>(smem + (size_t)p.stages * kStageBytes);
  ring.empty = ring.full + kMaxStages;
  ring.stages = p.stages;
  ring.it = 0;
  __nv_bfloat16* vec = reinterpret_cast<__nv_bfloat16*>(ring.empty + kMaxStages);  // max(D, F)
  float* scl = reinterpret_cast<float*>(vec + (D > F ? D : F));                    // n_scl
  float* qsm = scl + ((p.n_scl + 3) & ~3);                 // kConsumerWarps x kDh
  float* red = qsm + kConsumerWarps * kDh;                 // kConsumerWarps + 1

  const int start = p.start_ptr ? max(*p.start_ptr, 0) : p.start;
  const int n_rows = p.n_rows_ptr ? min(max(*p.n_rows_ptr, 0), p.S) : p.n_rows;
  const int rows = n_rows - start;
  const int nch = rows > 0 ? (rows + kChunk - 1) / kChunk : 1;

  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) mbar_init(&ring.full[s], 1);
    for (int s = 0; s < kMaxStages; ++s) mbar_init(&ring.empty[s], kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kConsumerWarps) {
    if (lane == 0) producer<kMode>(p, ring);
    return;
  }

  const Scratch sc = scratch_of(p.scratch, D, F);
  const Counters c = counters_of(p.counters, H);
  float* qh = qsm + warp * kDh;

  // this block's rows: [a0, a0 + nA) of q|k|v, [c0, c0 + nC) of every D-row
  // phase (the same residual columns in out, cross out and fc2), [g0, g0 + nG) of fc1
  const int a0 = part_lo(3 * D, G, b), nA = part_lo(3 * D, G, b + 1) - a0;
  const int c0 = part_lo(D, G, b), nC = part_lo(D, G, b + 1) - c0;
  const int g0 = 2 * part_lo(F / 2, G, b), nG = 2 * part_lo(F / 2, G, b + 1) - g0;
  const float* sA = scl;  // this layer's scales of those rows
  const float* sO = sA + nA;
  const float* sCQ = sO + nC;
  const float* sCO = sCQ + nC;
  const float* sG = sCO + nC;
  const float* sH = sG + nG;
  float* xo = scl + (p.n_scl - (D + G - 1) / G);  // this block's residual columns

  for (int i = tid; i < nC; i += kConsumers) xo[i] = __bfloat162float(p.x_emb[c0 + i]);
  float lsc[kLnPer], lbi[kLnPer];
  const uint32_t epoch = (uint32_t)__ldcg(c.epoch);
  // the residual after each of a layer's three updates, steps 3l + 1 .. 3l + 3
  const auto x_tag = [&](int layer, int k) { return tag_of(epoch, 3 * layer + k + 1); };

  for (int layer = 0; layer < p.L; ++layer) {
    const float* sa = p.s_attn + (long long)layer * 6 * D;
    for (int j = tid; j < nA + 4 * nC + nG; j += kConsumers) {
      float v;
      if (j < nA) v = __ldg(sa + a0 + j);
      else if (j < nA + 3 * nC) v = __ldg(sa + (3 + (j - nA) / nC) * D + c0 + (j - nA) % nC);
      else if (j < nA + 3 * nC + nG) v = __ldg(p.s_fc1 + (long long)layer * F + g0 + j - nA - 3 * nC);
      else v = __ldg(p.s_fc2 + (long long)layer * D + c0 + j - nA - 3 * nC - nG);
      scl[j] = v;
    }

    // LN1 -> q | k | v
    ln_params(p.ln1s + layer * D, p.ln1b + layer * D, D, lsc, lbi);
    layer_norm<kMode>(layer > 0 ? sc.xw : nullptr, x_tag(layer - 1, 2), p.x_emb, lsc, lbi, vec,
                      D, red);
    gemv<kMode>(ring, segment(p, layer, 0, b), vec, warp, lane, [&](int r, float y) {
      const int col = a0 + r;
      y *= sA[r];
      if (col < D) {
        sc.q[col] = bf16r(y * inv_sqrt_dh);
      } else if (col < 2 * D) {
        sc.kn[col - D] = bf16r(y);
        p.new_k[layer * D + col - D] = __float2bfloat16(y);
      } else {
        sc.vn[col - 2 * D] = bf16r(y);
        p.new_v[layer * D + col - 2 * D] = __float2bfloat16(y);
      }
    });
    consumer_sync();
    if (warp == 0) publish_heads(c.qkv, a0, a0 + nA, 3, D, H, lane);

    // self-attention items w * G + b of warp w; the last chunk of each head merges
    for (int item = warp * G + b; item < H * nch; item += kConsumerWarps * G)
      self_attn_chunk<kMode>(p, sc, c, layer, item % H, item / H, nch, start, n_rows,
                             tag_of(epoch, layer + 1), qh, lane);

    // out-proj + residual
    read_vec<kMode>(sc.aw, tag_of(epoch, layer + 1), vec, D);
    gemv<kMode>(ring, segment(p, layer, 1, b), vec, warp, lane, [&](int r, float y) {
      xo[r] += y * sO[r];
      st_word(sc.xw + c0 + r, __float_as_uint(xo[r]), x_tag(layer, 0));
    });
    consumer_sync();

    // LN2 -> cross q
    ln_params(p.ln2s + layer * D, p.ln2b + layer * D, D, lsc, lbi);
    layer_norm<kMode>(sc.xw, x_tag(layer, 0), nullptr, lsc, lbi, vec, D, red);
    gemv<kMode>(ring, segment(p, layer, 2, b), vec, warp, lane, [&](int r, float y) {
      sc.qc[c0 + r] = bf16r(y * sCQ[r] * inv_sqrt_dh);
    });
    consumer_sync();
    if (warp == 0) publish_heads(c.cq, c0, c0 + nC, 1, D, H, lane);

    // cross-attention: head h on warp kConsumerWarps - 1 of block h (the
    // self-attention items fill the low warps first)
    for (int h = (kConsumerWarps - 1 - warp) * G + b; h < H; h += kConsumerWarps * G)
      cross_attn_head<kMode>(p, sc, c, layer, h, tag_of(epoch, layer + 1), qh, lane);

    // cross out + residual
    read_vec<kMode>(sc.cw, tag_of(epoch, layer + 1), vec, D);
    gemv<kMode>(ring, segment(p, layer, 3, b), vec, warp, lane, [&](int r, float y) {
      xo[r] += y * sCO[r];
      st_word(sc.xw + c0 + r, __float_as_uint(xo[r]), x_tag(layer, 1));
    });
    consumer_sync();

    // LN3 -> fc1 -> activation (rounded to bf16, fc2's input), staged in qsm
    // and written in pairs of rows, two bf16 a word
    ln_params(p.ln3s + layer * D, p.ln3b + layer * D, D, lsc, lbi);
    layer_norm<kMode>(sc.xw, x_tag(layer, 1), nullptr, lsc, lbi, vec, D, red);
    gemv<kMode>(ring, segment(p, layer, 4, b), vec, warp, lane, [&](int r, float y) {
      qsm[r] = activation(y * sG[r], p.act);
    });
    consumer_sync();
    for (int i = tid; i < nG / 2; i += kConsumers)
      st_word(sc.mw + g0 / 2 + i, bf16x2_bits(qsm[2 * i], qsm[2 * i + 1]),
              tag_of(epoch, layer + 1));

    // fc2 + residual; after the last layer, this block's columns of the hidden state
    read_vec<kMode>(sc.mw, tag_of(epoch, layer + 1), vec, F);
    const bool last = layer == p.L - 1;
    gemv<kMode>(ring, segment(p, layer, 5, b), vec, warp, lane, [&](int r, float y) {
      xo[r] += y * sH[r];
      st_word(sc.xw + c0 + r, __float_as_uint(xo[r]), x_tag(layer, 2));
      if (last) p.hidden[c0 + r] = __float2bfloat16(xo[r]);
    });
    consumer_sync();
  }

  // the last block to finish sets the counters back to 0 and advances the epoch
  if (tid == 0) {
    __threadfence();
    red[kConsumerWarps] = atomicAdd(c.done, 1) == G - 1 ? 1.f : 0.f;
  }
  consumer_sync();
  if (red[kConsumerWarps] == 0.f) return;
  __threadfence();
  for (int i = tid; i < 3 * H + 1; i += kConsumers) p.counters[i] = 0;
  if (tid == 0) *c.epoch = (int)(epoch + 1);
}

// ---------------------------------------------------------------- host side
// dynamic shared memory past the ring: mbarriers, vec, scales, q slots, reductions
size_t fixed_smem(int D, int F, int n_scl) {
  return 2 * kMaxStages * sizeof(uint64_t) + 2 * (size_t)(D > F ? D : F) +
         4 * (size_t)((n_scl + 3) & ~3) + 4 * (size_t)(kConsumerWarps * kDh + kConsumerWarps + 1);
}

struct Plan {
  int device = -1, D = 0, F = 0;
  int blocks = 0, stages = 0, n_scl = 0;
  size_t smem = 0;
};

template <int kMode>
cudaError_t allow_smem(size_t smem) {
  return cudaFuncSetAttribute(fused_decode_kernel<kMode>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// one block per SM, the ring as deep as the shared memory allows (at most
// kMaxStages); kept for the last device and shape asked for
int plan_for(int D, int F, Plan* out) {
  static Plan cached;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (cached.device == dev && cached.D == D && cached.F == F) {
    *out = cached;
    return 0;
  }
  int sms = 0, coop = 0, optin = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  Plan plan;
  plan.device = dev, plan.D = D, plan.F = F, plan.blocks = sms;
  // scales of a block's rows of each phase, then its residual columns
  plan.n_scl = (3 * D + sms - 1) / sms + 5 * ((D + sms - 1) / sms) + 2 * ((F / 2 + sms - 1) / sms);
  if (2 * ((F / 2 + sms - 1) / sms) > kConsumerWarps * kDh) return (int)cudaErrorInvalidValue;
  const size_t fixed = fixed_smem(D, F, plan.n_scl);
  if ((size_t)optin < fixed + 2 * (size_t)kStageBytes) return (int)cudaErrorInvalidValue;
  plan.stages = (int)((optin - fixed) / kStageBytes);
  if (plan.stages > kMaxStages) plan.stages = kMaxStages;
  plan.smem = fixed + (size_t)plan.stages * kStageBytes;
  err = allow_smem<kFull>(plan.smem);
  if (err == cudaSuccess) err = allow_smem<kStreamOnly>(plan.smem);
  if (err == cudaSuccess) err = allow_smem<kChainOnly>(plan.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_decode_kernel<kFull>,
                                                        kThreads, plan.smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  cached = plan;
  *out = plan;
  return 0;
}

}  // namespace

extern "C" {

// fp32 words of global scratch the wrapper allocates (`Scratch`)
long long fused_decode_scratch_floats(int D, int F, int H, int S) {
  return scratch_floats(D, F, H, S);
}

// int32 dependency counters the wrapper allocates, zeroed once
int fused_decode_counter_ints(int H) { return 3 * H + 2; }

int fused_decode_head_dim() { return kDh; }

int fused_decode_chunk() { return kChunk; }

// The launch plan on the current device (0, with `*blocks` blocks of
// `*threads` threads and a ring of `*stages` stages of `*stage_bytes`) or a
// cudaError_t.
int fused_decode_plan(int D, int F, int* blocks, int* threads, int* stages, int* stage_bytes) {
  Plan plan;
  const int err = plan_for(D, F, &plan);
  if (err != 0) return err;
  *blocks = plan.blocks, *threads = kThreads, *stages = plan.stages, *stage_bytes = kStageBytes;
  return 0;
}

// act: 0 = tanh gelu, 1 = relu, 2 = silu. start_ptr / n_rows_ptr: () int32 on
// the device, or null for the `start` / `n_rows` values (device values are
// clamped: start to >= 0, n_rows to [0, S]). mode: 0 the kernel, 1 stream
// only, 2 chain only (timing variants). Returns a cudaError_t (0 = launched).
int fused_decode_launch(const void* x_emb, const void* ln1s, const void* ln1b, const void* ln2s,
                        const void* ln2b, const void* ln3s, const void* ln3b, const void* w_attn,
                        const void* s_attn, const void* w_fc1, const void* s_fc1,
                        const void* w_fc2, const void* s_fc2, const void* cache_k,
                        const void* cache_v, const void* cross_k, const void* cross_v,
                        const void* enc_bias, void* hidden, void* new_k, void* new_v,
                        void* scratch, void* counters, const void* start_ptr,
                        const void* n_rows_ptr, int L, int D, int H, int F, int S, int S_enc,
                        int start, int n_rows, int act, int mode, void* stream) {
  if (L <= 0 || L > 1000 || H <= 0 || D != H * kDh || D > kLnPer * kConsumers || F <= 0 || F % 16 != 0 ||
      F > kStageBytes || S_enc <= 0 || act < 0 || act > 2 || mode < 0 || mode > 2 ||
      (!start_ptr && start < 0) || (!n_rows_ptr && (n_rows < 0 || n_rows > S)))
    return (int)cudaErrorInvalidValue;
  const void* vecs[] = {w_attn, w_fc1, w_fc2, cache_k, cache_v, cross_k, cross_v, scratch};
  for (const void* ptr : vecs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  Plan plan;
  const int err = plan_for(D, F, &plan);
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
  p.start_ptr = static_cast<const int*>(start_ptr);
  p.n_rows_ptr = static_cast<const int*>(n_rows_ptr);
  p.hidden = static_cast<__nv_bfloat16*>(hidden);
  p.new_k = static_cast<__nv_bfloat16*>(new_k), p.new_v = static_cast<__nv_bfloat16*>(new_v);
  p.scratch = static_cast<float*>(scratch);
  p.counters = static_cast<int*>(counters);
  p.L = L, p.D = D, p.H = H, p.F = F, p.S = S, p.S_enc = S_enc;
  p.start = start, p.n_rows = n_rows, p.act = act;
  p.stages = plan.stages, p.n_scl = plan.n_scl;
  void* args[] = {&p};
  const void* fn = mode == kFull         ? (const void*)fused_decode_kernel<kFull>
                   : mode == kStreamOnly ? (const void*)fused_decode_kernel<kStreamOnly>
                                         : (const void*)fused_decode_kernel<kChainOnly>;
  cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(plan.blocks), dim3(kThreads), args,
                                              plan.smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
