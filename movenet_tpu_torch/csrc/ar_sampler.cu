// Autoregressive WaveNet sampler: the whole generation loop in one launch.
//
// Replaces two TPU kernels of movenet_tpu/ops/pallas/ar_sampler.py with
// one kernel, ar_sampler_kernel<FAST, NCH, HAS_CTX, RAGGED> (RAGGED: a
// width that is not a multiple of 4, see run_phase):
//   NCH = 1     _make_kernel (pallas_call at ar_sampler.py:1088, from
//               pallas_generate): B streams, one block each, with or
//               without video context;
//   NCH = 2, 3  _make_spec_kernel (pallas_call at ar_sampler.py:1054):
//               the speculative form, B=1 without video.
// Both TPU kernels come in two forms:
//   FAST=false  the exact chain: per layer fg = [h|past] @ W_fg + b_fg,
//               gated = tanh(f) * sigmoid(g), out = gated @ W_out + b_out;
//   FAST=true   the reassociated chain of stack_fast_weights: one
//               product of gated with W_res W_cur(l+1) per layer, the
//               next layer's [h|past] product beside it, and the
//               packed-tanh gate v0*v1 + v0 (the 0.5 and 2x factors live
//               in the weights).
// and the standard one with or without video context (HAS_CTX): W_fg is
// (L, 3R, 2R) = [W_cur; W_past; W_ctx] and step t reads its stream's
// context row ctx_t (R floats).  ctx_t is the same for every layer, so
// the step starts with one phase (P) that folds it into a per-step fg
// bias, cb[l] = b_fg[l, b] + ctx_t @ W_ctx[l] (fast layer 0: the ctx rows
// of w_p0c), for all L layers at once; the chain then runs the
// audio-only form with cb in place of b_fg.  The ctx products are off
// the dependency chain, as the TPU kernel's `pre` term is.
// Everything is float32.  The TPU's lane packing of the output codes, its
// double-buffered 512-step DMA of ctx slabs with their 128-lane padding,
// and its single-pass-MXU precision in fast mode are not carried over.
//
// Every sum is a sequential fmaf chain in row order, reductions over the
// C classes are fixed-shape 8-warp block reductions, and no atomics are
// used, so a launch is deterministic.  Argmax breaks ties toward the
// lower index, as jnp.argmax does.  Sampling at temperature > 0 adds
// counter-based Gumbel noise, a pure function of (seed, t, b, c) with
// counter (t*B + b)*C + c over the whole batch B
// (ar_sampler.py:_positional_gumbel); logf, never __logf.
//
// Design.  One block per stream (grid = B): 8 consumer warps that run the
// chain and one producer warp that feeds them the weights.  A step reads
// the same weights in the same order whatever the codes: 3.3 MB exact,
// 4.2 MB fast at the flagship width (C=256, R=S=64, L=30), 0.98 MB more
// with video, far more than one SM can hold.  So the wrapper packs them
// once per request into one buffer in the order the phases consume them
// (pack_stream in ops/cuda/ar_sampler.py): in a phase of n dots, consumer
// thread tid runs dots tid, tid + 256, ... in turn, and the phase is cut
// into slabs of ks rows of every thread's current dot, four rows of a
// thread in 16 bytes beside its neighbours'; a dot's rows are padded to
// a multiple of 4 (the consumer stops at the dot's own length, so padding
// never enters an fmaf; the chain buffers are padded alike, so every
// operand starts 16-byte aligned).  The producer walks that stream with 1-D bulk
// copies (TMA) into a ring of two 64 KB shared-memory stages, each with a
// `full` and an `empty` mbarrier, across phases, layers, the head and
// into the next step; the consumers' phase barriers are a named barrier
// over their 256 threads alone.  All B producers read the same buffer,
// which L2 serves to every block.  The biases of the block's stream, the
// chain buffers, the reductions, the dilations and, with video, cb and
// the ctx row live in shared memory; each layer's ring taps (the
// dilation rings live in global memory: sum(d) * R * 4 bytes a stream,
// 785 KB at the flagship width) are read one phase ahead, and ctx row
// t+1 during step t, so no phase waits on global memory but its first
// slab.
//
// Bound.  Not the arithmetic: a step is a chain of barrier-separated
// phases (2 per layer exact, 1-2 fast, over 30 layers, plus the head,
// the sampling reductions and, with video, P), each a dependent fmaf
// chain over its dots' rows (64 to 256) and an epilogue.  The stream
// bounds a step from below at its bytes over one SM's bulk-copy rate
// (about 184 GB/s: 17.8 us exact, 22.8 fast, 5.3 more with video at the
// flagship width); the phase chain sets the rest.  B streams cost about
// what one does, on B SMs, while L2 keeps up with B copies of the stream.
//
// Speculative form (NCH > 1).  Each iteration runs the real chain at step
// t and NCH-1 speculative chains at t+1 (and t+2), under guesses from
// n-gram tables (t2 (C) in shared memory; the (C, C) pair table t3 in a
// per-launch global copy, read and written by thread 0 only).  Chain k
// feeds on the codes (x_t, x_{t-1}) shifted by k guesses and its layer-l
// ring tap at time t+k-d is chain k-d's layer input when d <= k and the
// untouched ring slot of t+k otherwise.  Its ring writes wait in shared
// memory (L*R floats per chain) and commit, in time order, only when the
// real code equals the guess: then, and only then, they are what the
// standard form would have written.  So the codes equal the standard
// form's for any guess sequence, since every chain runs the standard
// form's float32 operations in its order: one accumulator per chain over
// one read of each weight (an iteration streams the weights once for all
// chains), the same epilogues and reductions, and the Gumbel noise of
// position t+k.  In fast mode the next layer's [h|tap] product of a
// speculative chain whose tap is another chain's fresh h (d(l+1) < NCH)
// is redone in one more phase (M2) after phase M; that happens at the
// first layers of each stack, and those W_fg rows are in the stream
// twice.  A hit saves one or two iterations' worth.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ar_layout.cuh"

namespace {

using namespace ar_layout;

struct Params {
  const float* front_cur;   // (C, R)
  const float* front_past;  // (C, R)
  const float* b_fg;        // (L, B, 2R)    fast: + b_corr, columns scaled
  const float* b_out;       // (L, R+S)
  const float* h1_b;        // (C)
  const float* h2_b;        // (C)
  const float* fc0;         // (C, 2R)       fast only
  const float* fp0;         // (C, 2R)       fast only
  const int* dil;           // (L)
  const int* off;           // (L) ring offset of each layer, in rows
  float* ring;              // (B, sum_d, R) updated in place
  const int* init_codes;    // (2, B): prompt[:, -1], first sampled code
  int* out;                 // (B, n_samples - rf)
  int batch, c_in, r, s, n_layers, sum_d, rf, n_samples;
  uint32_t seed;
  int parity;
  float temperature;
  const float* ctx;         // (B, n_samples, R) video context; null: none
};

// The weight stream, its ring, and the speculative form's tables.
struct RingParams {
  const float* stream;  // one step's weights in consumption order
  int stage_bytes;      // bytes of a ring stage: the largest slab
  int n_stages;         // stages of the ring
  PhaseShape shape[kKinds];
  int* t2;        // (C)    successor table, -1 unseen; read once, kept in smem
  int* t3;        // (C, C) pair table, -1 unseen; null for order 2
  int* hits;      // (1)    committed guesses
  int order;      // 2 or 3
  int adaptive;   // learn the tables from the committed codes
};

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.f ? x : __fmul_rn(0.01f, x);
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float positional_gumbel(uint32_t seed, uint32_t t,
                                                   uint32_t batch, uint32_t b,
                                                   uint32_t c_in, uint32_t c) {
  uint32_t x = (t * batch + b) * c_in + c;
  x ^= seed * 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0xD35A2D97u;
  x ^= x >> 15;
  // top 24 bits -> [0, 1), exact in float32
  const float u = __fmul_rn(__int2float_rn(static_cast<int>(x >> 8)),
                            1.0f / 16777216.0f);
  return -logf(__fadd_rn(-logf(__fadd_rn(u, 1e-20f)), 1e-20f));
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// ------------------------------------------- bulk copies and mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// the producer's arrival, announcing the bytes its copy will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// whether the phase of `bar` with this parity has completed
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred done;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, done;\n\t}"
      : "=r"(ok) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// one 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// ------------------------------------------------------ the ring kernel

__device__ __forceinline__ bool code_ok(int c, int C) { return c >= 0 && c < C; }

// the guess for x_{t+1} and, at depth 2, for x_{t+2}; an index outside
// [0, C) reads 0, as the TPU kernel's one-hot products do
__device__ int spec_guess1(int prev, int cur, const int* t2s, const int* t3,
                           int C, int order) {
  int g = code_ok(cur, C) ? t2s[cur] : 0;
  if (order == 3) {
    const int g3 = code_ok(prev, C) && code_ok(cur, C) ? t3[prev * C + cur] : 0;
    if (g3 >= 0) g = g3;
  }
  return g;
}

__device__ int spec_guess2(int cur, int g1, const int* t2s, const int* t3,
                           int C, int order) {
  if (!code_ok(g1, C)) return 0;
  int g = t2s[g1];
  if (order == 3) {
    const int g3 = code_ok(cur, C) ? t3[cur * C + g1] : 0;
    if (g3 >= 0) g = g3;
  }
  return g;
}

// The consumers' phase barrier: named barrier 1 over the 256 consumer
// threads, so the producer warp never waits at a phase boundary.
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// max, sum and first-index argmax over the consumer warps: warp shuffles,
// then warp 0..7's results in order, the same sums in every form
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  if (lane == 0) red[warp] = v;
  csync();
  float m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  csync();
  return m;
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  if (lane == 0) red[warp] = v;
  csync();
  float s = red[0];
  for (int w = 1; w < kWarps; ++w) s += red[w];
  csync();
  return s;
}

__device__ int block_argmax(float v, int i, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(~0u, v, o);
    const int oi = __shfl_xor_sync(~0u, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
  csync();
  float bv = red_v[0];
  int bi = red_i[0];
  for (int w = 1; w < kWarps; ++w)
    if (better(red_v[w], red_i[w], bv, bi)) { bv = red_v[w]; bi = red_i[w]; }
  csync();
  return bi;
}

// The producer: one lane walks the stream slab by slab, step after step,
// keeping every free stage filled: it waits for the stage to be released
// (sleeping between polls, as it shares a scheduler with two consumer
// warps), posts the slab's bytes on its `full` barrier and issues one
// bulk copy.  The block's consumers decide when the sampling ends; they
// set *done, which the producer reads while it waits, and it then waits
// for every copy it issued to land before it exits.
__device__ void ring_producer(const RingParams& q, const int* seq, int n_seq,
                              unsigned char* ring, uint64_t* full,
                              uint64_t* empty, volatile int* done) {
  const char* src = reinterpret_cast<const char*>(q.stream);
  size_t off = 0;
  int ph = 0;
  PhaseShape sh = q.shape[seq[0]];
  int left = sh.kv / sh.ks;
  uint32_t bytes = 4u * sh.ks * sh.ncols;
  int stage = 0;
  uint32_t parity = 0;
  bool wrapped = false;
  for (;;) {
    bool end = false;
    while (!mbar_try_wait(empty + stage, parity ^ 1)) {
      if (*done) { end = true; break; }
      // the ring is full: leave the issue slots to the consumer warps
      __nanosleep(200);
    }
    if (end) break;
    mbar_expect_tx(full + stage, bytes);
    bulk_copy(ring + static_cast<size_t>(stage) * q.stage_bytes, src + off,
              bytes, full + stage);
    off += bytes;
    if (--left == 0) {
      if (++ph == n_seq) { ph = 0; off = 0; }
      sh = q.shape[seq[ph]];
      left = sh.kv / sh.ks;
      bytes = 4u * sh.ks * sh.ncols;
    }
    if (++stage == q.n_stages) { stage = 0; parity ^= 1; wrapped = true; }
  }
  // stages before `stage` hold this lap's copies, the rest the last lap's
  for (int s = 0; s < q.n_stages; ++s) {
    if (s < stage) mbar_wait(full + s, parity);
    else if (wrapped) mbar_wait(full + s, parity ^ 1);
  }
}

// A consumer's place in the ring.
struct Pipe {
  const float4* ring;
  uint64_t* full;
  uint64_t* empty;
  int stage_f4, n_stages, stage;
  uint32_t parity;
};

__device__ __forceinline__ const float4* pipe_wait(Pipe& pp) {
  mbar_wait(pp.full + pp.stage, pp.parity);
  return pp.ring + static_cast<size_t>(pp.stage) * pp.stage_f4;
}

// every lane is done with the slab; one arrival per warp
__device__ __forceinline__ void pipe_release(Pipe& pp) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(pp.empty + pp.stage);
  if (++pp.stage == pp.n_stages) { pp.stage = 0; pp.parity ^= 1; }
}

__device__ __forceinline__ float4 leaky4(float4 v) {
  return make_float4(leaky(v.x), leaky(v.y), leaky(v.z), leaky(v.w));
}

// acc[k] += x[k][4q .. 4q+3] . w (one quad of rows), in row order
template <int NCH, bool LEAKY>
__device__ __forceinline__ void quad_fma(const float* const* x, int q,
                                         float4 w, float* acc) {
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    float4 v = *reinterpret_cast<const float4*>(x[k] + 4 * q);
    if (LEAKY) v = leaky4(v);
    acc[k] = fmaf(v.x, w.x, acc[k]);
    acc[k] = fmaf(v.y, w.y, acc[k]);
    acc[k] = fmaf(v.z, w.z, acc[k]);
    acc[k] = fmaf(v.w, w.w, acc[k]);
  }
}

// the first m (1 to 3) rows of a quad, the last of a segment whose rows
// are not a multiple of 4; the padding rows never enter an fmaf
template <int NCH, bool LEAKY>
__device__ __forceinline__ void quad_fma_part(const float* const* x, int q,
                                              int m, float4 w, float* acc) {
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const float* v = x[k] + 4 * q;
    acc[k] = fmaf(LEAKY ? leaky(v[0]) : v[0], w.x, acc[k]);
    if (m > 1) acc[k] = fmaf(LEAKY ? leaky(v[1]) : v[1], w.y, acc[k]);
    if (m > 2) acc[k] = fmaf(LEAKY ? leaky(v[2]) : v[2], w.z, acc[k]);
  }
}

// One phase of the stream.  Consumer thread tid runs dots tid, tid + 256,
// ... < sh.n in turn; for each slab it takes sh.ks rows of its current
// dot from its own column (four rows in 16 bytes, beside its
// neighbours'), one fmaf chain per chain k in row order.  A dot is one or
// two segments of `seg` rows, each padded to segp = round4(seg) rows in
// the stream; the fmaf's stop at the segment's own rows.  Only a RAGGED
// form (a width not a multiple of 4) has a segment that ends inside a
// slab; the others take every slab whole (working out each slab's own
// rows cost 2-5% of a step at the flagship width).  Every warp waits on
// and releases every slab of the phase, whether it reads it or not.
//   xs(i, row, x)   each chain's operand from virtual row `row` on (a
//                   second segment's operand starts at segp)
//   done(i, acc)    the dot's epilogue
template <int NCH, int KIND, bool LEAKY, bool RAGGED, class Xs, class Done>
__device__ __forceinline__ void run_phase(Pipe& pp, const PhaseShape& sh,
                                          int R, int S, int C, Xs xs,
                                          Done done) {
  const int tid = threadIdx.x;
  const int seg = seg_rows(KIND, R, S, C), segp = round4(seg);
  int i = tid, row = 0;
  int len = i < sh.n ? dot_segs(KIND, i, R) * segp : 0;
  float acc[NCH];
#pragma unroll
  for (int k = 0; k < NCH; ++k) acc[k] = 0.f;
  for (int v = 0; v < sh.kv; v += sh.ks) {
    const float4* slab = pipe_wait(pp) + tid;
    if (i < sh.n) {
      const float* x[NCH];
      xs(i, row, x);
      // the rows of this slab that its segment owns
      int nv = sh.ks;
      if (RAGGED) {
        const int o = row >= segp ? row - segp : row;
        nv = seg - o < sh.ks ? seg - o : sh.ks;
      }
      const int nq = nv >> 2;
      int q = 0;
      for (; q + 4 <= nq; q += 4) {
        float4 w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) w[u] = slab[(q + u) * sh.ncols];
#pragma unroll
        for (int u = 0; u < 4; ++u) quad_fma<NCH, LEAKY>(x, q + u, w[u], acc);
      }
      for (; q < nq; ++q) quad_fma<NCH, LEAKY>(x, q, slab[q * sh.ncols], acc);
      if (RAGGED && (nv & 3))
        quad_fma_part<NCH, LEAKY>(x, nq, nv & 3, slab[nq * sh.ncols], acc);
      row += sh.ks;
      if (row == len) {
        done(i, acc);
        i += kConsumers;
        row = 0;
#pragma unroll
        for (int k = 0; k < NCH; ++k) acc[k] = 0.f;
        if (i < sh.n) len = dot_segs(KIND, i, R) * segp;
      }
    }
    pipe_release(pp);
  }
}

template <bool FAST, int NCH, bool HAS_CTX, bool RAGGED>
__global__ void __launch_bounds__(kRingThreads, 1)
ar_sampler_kernel(Params p, RingParams q) {
  static_assert(NCH == 1 || !HAS_CTX, "the speculative form has no video");
  extern __shared__ __align__(16) unsigned char ring_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, b = blockIdx.x;
  const int C = p.c_in, R = p.r, R2 = 2 * p.r, S = p.s, RS = p.r + p.s;
  const int L = p.n_layers, LR = p.n_layers * p.r, R4 = round4(p.r);
  const ChainOffsets co = chain_offsets(C, R, S);
  // [ring | full, empty barriers | chain k's buffers at k * co.size |
  //  (video) ctx row, cb | spec | biases | ...]
  unsigned char* ring = ring_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + static_cast<size_t>(q.n_stages) * q.stage_bytes);
  uint64_t* empty = full + q.n_stages;
  float* fl = reinterpret_cast<float*>(empty + q.n_stages);
  constexpr int oX = 0;
  const int oHN = co.hn, oP0 = co.p0, oP1 = co.p1, oG = co.g, oSk = co.sk,
            oAct = co.act, oSc = co.sc;
#define CH(k, o) (fl + (k) * co.size + (o))
  float* xc = fl + NCH * co.size;            // (video) ctx_t: R
  float* cb = xc + (HAS_CTX ? R4 : 0);       // (video) the step's fg bias (L, 2R)
  float* spec = cb + (HAS_CTX ? L * R2 : 0); // chain k>=1 at (k-1) * LR
  float* bfg = spec + (NCH - 1) * LR;        // b_fg[:, b] (L, 2R)
  float* bout = bfg + L * R2;                // b_out (L, R+S)
  float* b1 = bout + L * RS;                 // h1_b (C)
  float* b2 = b1 + C;                        // h2_b (C)
  float* red_v = b2 + C;
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);
  int* t2s = red_i + kWarps;                 // C
  int* misc = t2s + C;                       // g1, g2, done, phases
  int* dil_s = misc + 4;                     // L
  int* off_s = dil_s + L;                    // L
  int* seq = off_s + L;                      // the phase kinds in stream order
  // the chain's fg bias: b_fg[:, b], or with video the step's cb
  const float* fgb = HAS_CTX ? cb : bfg;

  for (int c = tid; c < C; c += kRingThreads) {
    if (NCH > 1) t2s[c] = q.t2[c];
    b1[c] = p.h1_b[c];
    b2[c] = p.h2_b[c];
  }
  for (int i = tid; i < L * R2; i += kRingThreads) {
    const int l = i / R2;
    bfg[i] = p.b_fg[(static_cast<size_t>(l) * p.batch + b) * R2 + (i - l * R2)];
  }
  for (int i = tid; i < L * RS; i += kRingThreads) bout[i] = p.b_out[i];
  for (int l = tid; l < L; l += kRingThreads) {
    dil_s[l] = p.dil[l];
    off_s[l] = p.off[l];
  }
  const int n = p.n_samples;
  const float* ctx_b =
      HAS_CTX ? p.ctx + static_cast<size_t>(b) * n * R : nullptr;
  if (HAS_CTX)
    for (int j = tid; j < R; j += kRingThreads)
      xc[j] = ctx_b[static_cast<size_t>(p.rf) * R + j];
  if (tid == 0) {
    for (int s = 0; s < q.n_stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWarps);
    }
    fence_mbar_init();
    misc[2] = 0;
  }
  float* ringg = p.ring + static_cast<size_t>(b) * p.sum_d * R;
  int* out = p.out + static_cast<size_t>(b) * (n - p.rf);
  int prev = p.init_codes[b];
  int cur = p.init_codes[p.batch + b];
  __syncthreads();
  if (tid == 0) {
    // one step's phases (stream_phases in the wrapper)
    int ns = 0;
    if (HAS_CTX) seq[ns++] = kP;
    if (!FAST) {
      for (int l = 0; l < L; ++l) { seq[ns++] = kA; seq[ns++] = kC; }
    } else {
      seq[ns++] = kF0;
      for (int l = 0; l < L; ++l) {
        if (l + 1 < L) {
          seq[ns++] = kM;
          if (dil_s[l + 1] < NCH) seq[ns++] = kM2;
        } else {
          seq[ns++] = kML;
        }
      }
    }
    seq[ns++] = kH1;
    seq[ns++] = kH2;
    misc[3] = ns;
    if (NCH > 1) {
      const int g1 = spec_guess1(prev, cur, t2s, q.t3, C, q.order);
      misc[0] = g1;
      misc[1] = NCH == 3 ? spec_guess2(cur, g1, t2s, q.t3, C, q.order) : 0;
    }
  }
  __syncthreads();
  if (warp == kWarps) {
    if (tid == kConsumers)
      ring_producer(q, seq, misc[3], ring, full, empty, misc + 2);
    return;
  }

  Pipe pp{reinterpret_cast<const float4*>(ring), full, empty,
          q.stage_bytes / 16, q.n_stages, 0, 0u};
  int t = p.rf;
  int hits = 0;
  while (t < n) {
    const int g1 = NCH > 1 ? misc[0] : 0, g2 = NCH > 1 ? misc[1] : 0;
    // chain k embeds (cc[k], pc[k]): (x_t, x_{t-1}), (g1, x_t), (g2, g1)
    const int cc[3] = {cur, g1, g2};
    const int pc[3] = {prev, cur, g1};
    // (video) ctx row t+1, stored after phase P has read row t
    const float ctxn = HAS_CTX && tid < R && t + 1 < n
        ? __ldg(ctx_b + static_cast<size_t>(t + 1) * R + tid) : 0.f;

    // ---- front: each chain's h; layer 0's taps; fast: the embedding
    // products of layer 0 (part0 = fc0[c], part1 holds fp0[p] until F0)
    const int d0 = dil_s[0], o0 = off_s[0];
    for (int j = tid; j < R; j += kConsumers) {
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        CH(k, oX)[j] =
            (code_ok(cc[k], C) ? __ldg(p.front_cur + cc[k] * R + j) : 0.f)
            + (code_ok(pc[k], C) ? __ldg(p.front_past + pc[k] * R + j) : 0.f);
        CH(k, oX)[R4 + j] = d0 <= k ? CH(k - d0, oX)[j]
                                    : ringg[(o0 + (t + k) % d0) * R + j];
      }
    }
    for (int j = tid; j < S; j += kConsumers) {
#pragma unroll
      for (int k = 0; k < NCH; ++k) CH(k, oSk)[j] = 0.f;
    }
    if (FAST) {
      for (int j = tid; j < R2; j += kConsumers) {
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          CH(k, oP0)[j] =
              code_ok(cc[k], C) ? __ldg(p.fc0 + cc[k] * R2 + j) : 0.f;
          CH(k, oP1)[j] =
              code_ok(pc[k], C) ? __ldg(p.fp0 + pc[k] * R2 + j) : 0.f;
        }
      }
    }
    csync();

    if (HAS_CTX) {
      // phase P: cb[l] = ctx_t @ W_ctx[l] + b_fg[l, b] for every layer;
      // fast layer 0 takes W_ctx_0 from the ctx rows of w_p0c
      run_phase<1, kP, false, RAGGED>(
          pp, q.shape[kP], R, S, C,
          [&](int, int row, const float** x) { x[0] = xc + row; },
          [&](int i, const float* acc) { cb[i] = __fadd_rn(acc[0], bfg[i]); });
      csync();
      // the next step's ctx row; read again only after many barriers
      if (t + 1 < n)
        for (int j = tid; j < R; j += kConsumers)
          xc[j] = j == tid ? ctxn
                           : __ldg(ctx_b + static_cast<size_t>(t + 1) * R + j);
    }

    if (!FAST) {
      for (int l = 0; l < L; ++l) {
        const int slot = off_s[l] + t % dil_s[l];
        const bool more = l + 1 < L;
        const int dn = more ? dil_s[l + 1] : 1;
        const int on = more ? off_s[l + 1] : 0;
        // the next layer's ring taps that phase C stores, read now so that
        // their L2 latency hides behind phases A and B
        const int jt = tid - RS;
        float tapn[NCH];
#pragma unroll
        for (int k = 0; k < NCH; ++k)
          tapn[k] = more && jt >= 0 && jt < R && dn > k
              ? ringg[(on + (t + k) % dn) * R + jt] : 0.f;
        // phase A: fg partial sums over the h rows and the tap rows
        run_phase<NCH, kA, false, RAGGED>(
            pp, q.shape[kA], R, S, C,
            [&](int i, int row, const float** x) {
              const int half = i / R2;
#pragma unroll
              for (int k = 0; k < NCH; ++k) x[k] = CH(k, oX) + half * R4 + row;
            },
            [&](int i, const float* acc) {
              const int half = i / R2, j = i - half * R2;
#pragma unroll
              for (int k = 0; k < NCH; ++k) CH(k, half ? oP1 : oP0)[j] = acc[k];
            });
        csync();
        // phase B: gate
        const float* bl = fgb + l * R2;
        for (int i = tid; i < R; i += kConsumers) {
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            const float f = __fadd_rn(__fadd_rn(CH(k, oP0)[i], CH(k, oP1)[i]),
                                      bl[i]);
            const float g = __fadd_rn(
                __fadd_rn(CH(k, oP0)[R + i], CH(k, oP1)[R + i]), bl[R + i]);
            CH(k, oG)[i] = __fmul_rn(tanhf(f), sigmoidf_(g));
          }
        }
        csync();
        // phase C: the next layer's ring taps; res/skip outputs; the real
        // ring write and the deferred spec ones
        const float* bo = bout + l * RS;
        for (int i = tid; i < RS + R; i += kConsumers) {
          if (i >= RS && more) {
            const int j = i - RS;
#pragma unroll
            for (int k = 0; k < NCH; ++k)
              if (dn > k)
                CH(k, oX)[R4 + j] = i == tid ? tapn[k]
                                             : ringg[(on + (t + k) % dn) * R + j];
          }
        }
        run_phase<NCH, kC, false, RAGGED>(
            pp, q.shape[kC], R, S, C,
            [&](int, int row, const float** x) {
#pragma unroll
              for (int k = 0; k < NCH; ++k) x[k] = CH(k, oG) + row;
            },
            [&](int i, const float* acc) {
#pragma unroll
              for (int k = 0; k < NCH; ++k) {
                const float o = __fadd_rn(acc[k], bo[i]);
                if (i < R) {
                  if (k == 0) ringg[slot * R + i] = CH(0, oX)[i];
                  else spec[(k - 1) * LR + l * R + i] = CH(k, oX)[i];
                  CH(k, oX)[i] = __fadd_rn(o, CH(k, oX)[i]);
                } else {
                  CH(k, oSk)[i - R] = __fadd_rn(CH(k, oSk)[i - R], o);
                }
              }
              if (i < R && more) {
#pragma unroll
                for (int k = 1; k < NCH; ++k)
                  if (dn <= k) CH(k, oX)[R4 + i] = CH(k - dn, oX)[i];
              }
            });
        csync();
      }
    } else {
      // the ring taps of layer l + 1 that phase G(l) stores, read one long
      // phase ahead (F0 or M(l - 1)) so that their L2 latency hides there
      float tapn[NCH];
      auto fetch_taps = [&](int l1) {
        const bool ok = l1 < L && tid < R;
        const int d = ok ? dil_s[l1] : 1, o = ok ? off_s[l1] : 0;
#pragma unroll
        for (int k = 0; k < NCH; ++k)
          tapn[k] = ok && k < d ? ringg[(o + (t + k) % d) * R + tid] : 0.f;
      };
      fetch_taps(1);
      // layer 0's fg: fc0[c] + ((fp0[p] + tap0 @ w_p0c) + b_fg[0]); with
      // video the bias is cb[0], which holds the ctx rows' product
      run_phase<NCH, kF0, false, RAGGED>(
          pp, q.shape[kF0], R, S, C,
          [&](int, int row, const float** x) {
#pragma unroll
            for (int k = 0; k < NCH; ++k) x[k] = CH(k, oX) + R4 + row;
          },
          [&](int j, const float* acc) {
#pragma unroll
            for (int k = 0; k < NCH; ++k)
              CH(k, oP1)[j] = __fadd_rn(__fadd_rn(CH(k, oP1)[j], acc[k]),
                                        fgb[j]);
          });
      csync();
      for (int l = 0; l < L; ++l) {
        const int slot = off_s[l] + t % dil_s[l];
        const bool more = l + 1 < L;
        const int dn = more ? dil_s[l + 1] : 1;
        const int on = more ? off_s[l + 1] : 0;
        // chains 0..ready-1 read their next tap from the ring; chain k >=
        // ready reads chain (k - dn)'s h_next, known only after phase M
        const int ready = more ? (dn < NCH ? dn : NCH) : NCH;
        // phase G: packed-tanh gates; move in h; store the ring taps
        for (int i = tid; i < R; i += kConsumers) {
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            const float v0 = tanhf(__fadd_rn(CH(k, oP0)[i], CH(k, oP1)[i]));
            const float v1 =
                tanhf(__fadd_rn(CH(k, oP0)[R + i], CH(k, oP1)[R + i]));
            CH(k, oG)[i] = __fadd_rn(__fmul_rn(v0, v1), v0);
            if (l > 0) CH(k, oX)[i] = CH(k, oHN)[i];
            if (more && k < ready)
              CH(k, oX)[R4 + i] = i == tid ? tapn[k]
                                           : ringg[(on + (t + k) % dn) * R + i];
          }
        }
        csync();
        fetch_taps(l + 2);
        // phase M: gated @ w_prod, the next [h|tap] product (every chain
        // is computed; the late ones' are dropped and redone in M2), and
        // the res/skip outputs, side by side
        const float* bn = fgb + (l + 1) * R2;
        const float* bo = bout + l * RS;
        auto outs = [&](int j, const float* acc) {
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            const float o = __fadd_rn(acc[k], bo[j]);
            if (j < R) {
              if (k == 0) ringg[slot * R + j] = CH(0, oX)[j];
              else spec[(k - 1) * LR + l * R + j] = CH(k, oX)[j];
              CH(k, oHN)[j] = __fadd_rn(o, CH(k, oX)[j]);
            } else {
              CH(k, oSk)[j - R] = __fadd_rn(CH(k, oSk)[j - R], o);
            }
          }
        };
        if (more) {
          run_phase<NCH, kM, false, RAGGED>(
              pp, q.shape[kM], R, S, C,
              [&](int i, int row, const float** x) {
                const int o = i >= R2 && i < 2 * R2 ? oX : oG;
#pragma unroll
                for (int k = 0; k < NCH; ++k) x[k] = CH(k, o) + row;
              },
              [&](int i, const float* acc) {
                if (i < R2) {
#pragma unroll
                  for (int k = 0; k < NCH; ++k) CH(k, oP0)[i] = acc[k];
                } else if (i < 2 * R2) {
#pragma unroll
                  for (int k = 0; k < NCH; ++k)
                    if (k < ready)
                      CH(k, oP1)[i - R2] = __fadd_rn(acc[k], bn[i - R2]);
                } else {
                  outs(i - 2 * R2, acc);
                }
              });
        } else {
          run_phase<NCH, kML, false, RAGGED>(
              pp, q.shape[kML], R, S, C,
              [&](int, int row, const float** x) {
#pragma unroll
                for (int k = 0; k < NCH; ++k) x[k] = CH(k, oG) + row;
              },
              outs);
        }
        csync();
        // phase M2: the late chains' next product over [h | h_next of
        // chain k - dn], the same fmaf chain as over a copied tap (slot c
        // >= late repeats the last chain and is dropped)
        if (NCH > 1 && more && ready < NCH) {
          const int late = NCH - ready;
          run_phase<NCH, kM2, false, RAGGED>(
              pp, q.shape[kM2], R, S, C,
              [&](int, int row, const float** x) {
#pragma unroll
                for (int c = 0; c < NCH; ++c) {
                  const int k = ready + c < NCH ? ready + c : NCH - 1;
                  x[c] = row < R4 ? CH(k, oX) + row
                                  : CH(k - dn, oHN) + (row - R4);
                }
              },
              [&](int j, const float* acc) {
#pragma unroll
                for (int c = 0; c < NCH; ++c)
                  if (c < late) CH(ready + c, oP1)[j] = __fadd_rn(acc[c], bn[j]);
              });
          csync();
        }
      }
    }

    // ---- heads: y = leaky(skip) @ W1 + b1; logits = leaky(y) @ W2 + b2
    run_phase<NCH, kH1, true, RAGGED>(
        pp, q.shape[kH1], R, S, C,
        [&](int, int row, const float** x) {
#pragma unroll
          for (int k = 0; k < NCH; ++k) x[k] = CH(k, oSk) + row;
        },
        [&](int c, const float* acc) {
#pragma unroll
          for (int k = 0; k < NCH; ++k)
            CH(k, oAct)[c] = leaky(__fadd_rn(acc[k], b1[c]));
        });
    csync();
    float local_max[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) local_max[k] = -CUDART_INF_F;
    run_phase<NCH, kH2, false, RAGGED>(
        pp, q.shape[kH2], R, S, C,
        [&](int, int row, const float** x) {
#pragma unroll
          for (int k = 0; k < NCH; ++k) x[k] = CH(k, oAct) + row;
        },
        [&](int c, const float* acc) {
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            const float logit = __fadd_rn(acc[k], b2[c]);
            CH(k, oSc)[c] = logit;
            local_max[k] = fmaxf(local_max[k], logit);
          }
        });

    // ---- sampling of chain k at position t+k: greedy, or Gumbel-max on
    // logits/T or softmax/T
    int nxt[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      float* scores = CH(k, oSc);
      float best_v = -CUDART_INF_F;
      int best_i = C;
      if (p.temperature == 0.f) {
        for (int c = tid; c < C; c += kConsumers)
          if (better(scores[c], c, best_v, best_i)) { best_v = scores[c]; best_i = c; }
      } else {
        float denom = 1.f;
        float m = 0.f;
        if (p.parity) {
          m = block_max(local_max[k], red_v);
          float local_sum = 0.f;
          for (int c = tid; c < C; c += kConsumers) {
            const float e = expf(__fsub_rn(scores[c], m));
            scores[c] = e;
            local_sum = __fadd_rn(local_sum, e);
          }
          denom = block_sum(local_sum, red_v);
        }
        for (int c = tid; c < C; c += kConsumers) {
          const float base = p.parity
              ? __fdiv_rn(__fdiv_rn(scores[c], denom), p.temperature)
              : __fdiv_rn(scores[c], p.temperature);
          const float v = __fadd_rn(
              base, positional_gumbel(p.seed, static_cast<uint32_t>(t + k),
                                      static_cast<uint32_t>(p.batch),
                                      static_cast<uint32_t>(b),
                                      static_cast<uint32_t>(C),
                                      static_cast<uint32_t>(c)));
          if (better(v, c, best_v, best_i)) { best_v = v; best_i = c; }
        }
      }
      nxt[k] = block_argmax(best_v, best_i, red_v, red_i);
    }

    // ---- commit: a guess holds only if the real code equals it
    const bool hit = NCH > 1 && nxt[0] == g1 && t + 1 < n;
    const bool hit2 = NCH == 3 && hit && nxt[NCH - 2] == g2 && t + 2 < n;
    if (hit) {
      for (int i = tid; i < LR; i += kConsumers) {
        const int l = i / R, j = i - l * R;
        const int d = dil_s[l], o = off_s[l];
        ringg[(o + (t + 1) % d) * R + j] = spec[i];
        // s2 after s1: at d <= 2 the slots coincide, the later time wins
        if (hit2) ringg[(o + (t + 2) % d) * R + j] = spec[LR + i];
      }
    }
    if (tid == 0) {
      if (NCH > 1 && q.adaptive) {
        // later writes win: x_t -> x_{t+1}, then the committed ones
        if (code_ok(cur, C)) t2s[cur] = nxt[0];
        if (hit && code_ok(g1, C)) t2s[g1] = nxt[NCH > 1 ? 1 : 0];
        if (hit2 && code_ok(g2, C)) t2s[g2] = nxt[NCH - 1];
        if (q.order == 3) {
          // the TPU kernel keys the row on prev's one-hot: row 0 when
          // prev lies outside [0, C)
          if (code_ok(cur, C)) q.t3[(code_ok(prev, C) ? prev : 0) * C + cur] = nxt[0];
          if (hit && code_ok(cur, C) && code_ok(g1, C))
            q.t3[cur * C + g1] = nxt[NCH > 1 ? 1 : 0];
          if (hit2 && code_ok(g1, C) && code_ok(g2, C))
            q.t3[g1 * C + g2] = nxt[NCH - 1];
        }
      }
      out[t - p.rf] = cur;
      if (hit) out[t + 1 - p.rf] = g1;
      if (hit2) out[t + 2 - p.rf] = g2;
    }
    hits += static_cast<int>(hit) + static_cast<int>(hit2);
    if (hit2) {
      t += 3; prev = g2; cur = nxt[NCH - 1];
    } else if (hit) {
      t += 2; prev = g1; cur = nxt[NCH > 1 ? 1 : 0];
    } else {
      t += 1; prev = cur; cur = nxt[0];
    }
    if (NCH > 1) {
      if (tid == 0) {
        const int ng1 = spec_guess1(prev, cur, t2s, q.t3, C, q.order);
        misc[0] = ng1;
        misc[1] = NCH == 3 ? spec_guess2(cur, ng1, t2s, q.t3, C, q.order) : 0;
      }
      csync();
    }
  }
  if (tid == 0) {
    if (NCH > 1) *q.hits = hits;
    *reinterpret_cast<volatile int*>(misc + 2) = 1;   // the producer ends
  }
#undef CH
}

// The shapes of the form's phases from their slab rows `ks` (by kind),
// the stage size and the stage count; cudaErrorInvalidValue when a slab
// row count does not divide its phase's padded segments, a slab does not
// fit a stage, or the ring and the rest pass the shared memory a block
// can have.
template <bool FAST, int NCH, bool HAS_CTX, bool RAGGED>
int launch_ring(const Params& p, RingParams q, const int* ks,
                cudaStream_t st) {
  const int kinds_exact[] = {kA, kC, kH1, kH2, kP};
  const int kinds_fast[] = {kF0, kM, kML, kM2, kH1, kH2, kP};
  const int* kinds = FAST ? kinds_fast : kinds_exact;
  const int n_kinds = (FAST ? 7 : 5) - (HAS_CTX ? 0 : 1);
  for (int i = 0; i < n_kinds; ++i) {
    const int kind = kinds[i];
    if (!phase_shape(kind, ks[kind], p.r, p.s, p.c_in, p.n_layers,
                     &q.shape[kind])
        || 4 * ks[kind] * q.shape[kind].ncols > q.stage_bytes)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      ring_fixed_bytes(NCH, HAS_CTX, p.c_in, p.r, p.s, p.n_layers)
      + static_cast<size_t>(q.n_stages) * (q.stage_bytes + 2 * sizeof(uint64_t));
  if (q.stage_bytes % 16 != 0 || q.n_stages < 2 || q.n_stages > kMaxStages
      || smem > static_cast<size_t>(kSmemLimit)
      || reinterpret_cast<uintptr_t>(q.stream) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      ar_sampler_kernel<FAST, NCH, HAS_CTX, RAGGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ar_sampler_kernel<FAST, NCH, HAS_CTX, RAGGED>
      <<<p.batch, kRingThreads, smem, st>>>(p, q);
  return static_cast<int>(cudaGetLastError());
}

// RAGGED where a dot's segments (R, S or C rows) are not a multiple of 4
template <bool FAST, int NCH, bool HAS_CTX>
int launch_form(const Params& p, const RingParams& q, const int* ks,
                cudaStream_t st) {
  return (p.r | p.s | p.c_in) & 3
      ? launch_ring<FAST, NCH, HAS_CTX, true>(p, q, ks, st)
      : launch_ring<FAST, NCH, HAS_CTX, false>(p, q, ks, st);
}

// ------------------------------------------------------ stream probe

// How fast one block, alone on the card, moves a stream of n_slabs slabs
// of slab_bytes (L2-resident after the first pass) into its SM, passes
// times over: mode 0, bulk copies by one producer lane into a ring of
// n_stages shared-memory stages that the 8 consumer warps only release;
// mode 2, the same with the consumers reading every float of each slab
// (16 bytes a thread at a time); mode 1, the 256 consumer threads
// reading the stream themselves, 16 __ldg's a thread in flight.  The
// design of the kernel's weight stream rests on mode 0 beating mode 1.
__global__ void __launch_bounds__(kRingThreads, 1)
stream_probe_kernel(const float* src, int slab_bytes, int n_slabs,
                    int passes, int mode, int n_stages, float* out) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float acc = 0.f;
  if (mode == 1) {
    if (tid < kConsumers) {
      const size_t n = static_cast<size_t>(n_slabs) * slab_bytes / 4;
      for (int ps = 0; ps < passes; ++ps) {
        for (size_t base = 0; base + 16 * kConsumers <= n;
             base += 16 * kConsumers) {
          float wv[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) wv[u] = __ldg(src + base + u * kConsumers + tid);
#pragma unroll
          for (int u = 0; u < 16; ++u) acc = fmaf(1.f, wv[u], acc);
        }
      }
      out[tid] = acc;
    }
    return;
  }
  const int slab_floats = slab_bytes / 4;
  float* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + n_stages * slab_floats);
  uint64_t* empty = full + n_stages;
  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();
  const int total = passes * n_slabs;
  if (warp == kWarps) {
    // the consumers take every slab, so none is in flight when they end
    if (lane == 0) {
      for (int i = 0; i < total; ++i) {
        const int st = i % n_stages;
        const uint32_t parity = (i / n_stages) & 1;
        mbar_wait(empty + st, parity ^ 1);
        mbar_expect_tx(full + st, slab_bytes);
        bulk_copy(ring + st * slab_floats,
                  reinterpret_cast<const char*>(src)
                      + static_cast<size_t>(i % n_slabs) * slab_bytes,
                  slab_bytes, full + st);
      }
    }
    return;
  }
  for (int i = 0; i < total; ++i) {
    const int st = i % n_stages;
    mbar_wait(full + st, (i / n_stages) & 1);
    if (mode == 2) {
      const float4* s4 = reinterpret_cast<const float4*>(ring + st * slab_floats);
      for (int j = tid; j < slab_floats / 4; j += kConsumers) {
        const float4 v = s4[j];
        acc = fmaf(1.f, v.x, fmaf(1.f, v.y, fmaf(1.f, v.z, fmaf(1.f, v.w, acc))));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
  out[tid] = acc;
}

}  // namespace

extern "C" {

// Launches the sampler (grid = batch, one block a stream) on `stream`.
// depth 0 is the standard form (any batch; `ctx` the (batch, n_samples,
// r) video context, or null without video); depth 1 or 2 the
// speculative form (batch 1, no video) with guess tables t2 and t3
// (per-launch copies that it updates in place; t3 null at order 2) and
// the hit counter `hits`.  `wstream` is the packed weight stream of one
// step (pack_stream in the wrapper), `ks` (host, by PhaseKind) the slab
// rows of each phase, and the ring has n_stages stages of stage_bytes.
// Returns the cudaError_t of the launch.
int movenet_ar_sampler_launch(
    int fast, int depth, int order, int adaptive, const float* front_cur,
    const float* front_past, const float* b_fg, const float* b_out,
    const float* h1_b, const float* h2_b, const float* fc0, const float* fp0,
    const int* dil, const int* off, float* ring, const int* init_codes,
    int* t2, int* t3, int* out, int* hits, const float* ctx,
    const float* wstream, const int* ks, int stage_bytes, int n_stages,
    int batch, int c_in, int r, int s, int n_layers, int sum_d, int rf,
    int n_samples, int seed, int parity, float temperature, void* stream) {
  const bool has_ctx = ctx != nullptr;
  if (depth < 0 || depth > 2 || wstream == nullptr
      || (depth > 0
          && (batch != 1 || has_ctx || (order != 2 && order != 3)
              || t2 == nullptr || hits == nullptr
              || (order == 3 && t3 == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{front_cur, front_past, b_fg, b_out, h1_b, h2_b, fc0, fp0, dil,
           off, ring, init_codes, out, batch, c_in, r, s, n_layers, sum_d,
           rf, n_samples, static_cast<uint32_t>(seed), parity, temperature,
           ctx};
  RingParams q{wstream, stage_bytes, n_stages, {}, t2, t3, hits, order,
               adaptive};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (depth * 4 + (fast ? 2 : 0) + (has_ctx ? 1 : 0)) {
    case 0: return launch_form<false, 1, false>(p, q, ks, st);
    case 1: return launch_form<false, 1, true>(p, q, ks, st);
    case 2: return launch_form<true, 1, false>(p, q, ks, st);
    case 3: return launch_form<true, 1, true>(p, q, ks, st);
    case 4: return launch_form<false, 2, false>(p, q, ks, st);
    case 6: return launch_form<true, 2, false>(p, q, ks, st);
    case 8: return launch_form<false, 3, false>(p, q, ks, st);
    default: return launch_form<true, 3, false>(p, q, ks, st);
  }
}

// Shared memory of the sampler beside its ring, in bytes (smem_layout's
// "fixed" in the wrapper).
long long movenet_ar_ring_fixed_bytes(int depth, int video, int c_in, int r,
                                      int s, int n_layers) {
  return static_cast<long long>(
      ring_fixed_bytes(depth + 1, video != 0, c_in, r, s, n_layers));
}

// Launches the stream probe (one block) on `stream`; `out` takes 288
// floats.  Returns the cudaError_t of the launch.
int movenet_ar_stream_probe(const float* src, int slab_bytes, int n_slabs,
                            int passes, int mode, int n_stages, float* out,
                            void* stream) {
  if (slab_bytes <= 0 || slab_bytes % 16 != 0 || n_slabs <= 0
      || passes <= 0 || n_stages <= 0 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mode == 1 ? 0
      : static_cast<size_t>(n_stages) * (slab_bytes + 2 * sizeof(uint64_t));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  stream_probe_kernel<<<1, kRingThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      src, slab_bytes, n_slabs, passes, mode, n_stages, out);
  return static_cast<int>(cudaGetLastError());
}

const char* movenet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
