// Autoregressive WaveNet sampler: the whole generation loop in one launch.
//
// Replaces the TPU kernel movenet_tpu/ops/pallas/ar_sampler.py:_make_kernel
// (launched by pallas_call at ar_sampler.py:1088 from pallas_generate), in
// both its forms:
//   FAST=false  the exact chain: per layer fg = [h|past] @ W_fg + b_fg,
//               gated = tanh(f) * sigmoid(g), out = gated @ W_out + b_out;
//   FAST=true   the reassociated chain of stack_fast_weights: one product
//               of gated with W_res W_cur(l+1) per layer, the next layer's
//               [h|past] product beside it, and the packed-tanh gate
//               v0*v1 + v0 (the 0.5 and 2x factors live in the weights).
// and with or without video context (has_ctx):
//   HAS_CTX     W_fg is (L, 3R, 2R) = [W_cur; W_past; W_ctx] and step t
//               reads its stream's context row ctx_t (R floats).  ctx_t is
//               the same for every layer, so the step starts with one
//               phase that folds it into a per-step fg bias,
//               cb[l] = b_fg[l, b] + ctx_t @ W_ctx[l] (fast layer 0: the
//               ctx rows of w_p0c), for all L layers at once; the chain
//               then runs the audio-only form with cb in place of b_fg.
//               The ctx products are off the dependency chain, as the
//               TPU kernel's `pre` term is.
// Both are float32 throughout.  The TPU's lane packing of the output codes,
// its double-buffered 512-step DMA of ctx slabs with their 128-lane
// padding, and its single-pass-MXU precision in fast mode are not carried
// over.
//
// Design.  One block per stream (grid = B) and 256 threads; the TPU's
// sequential grid becomes the step loop inside the block.  Weights are
// read from global memory through the read-only path (__ldg): 3.7 MB for
// the exact chain at C=256, R=S=64, L=30, about 1.2 MB more in fast mode,
// so they stay in the 50 MB L2 for every block.  Each stream's dilation
// rings live in global memory (sum(d) * R * 4 bytes: 785 KB at the
// flagship width, far above shared memory); the current h, the ring tap,
// fg, gated, the skip sum, the head activations and the scores live in
// shared memory.  Every sum is a sequential fmaf chain in a fixed order,
// reductions over the C classes are fixed-shape block reductions, and no
// atomics are used, so a launch is deterministic.  Argmax breaks ties
// toward the lower index, as jnp.argmax does.
//
// Sampling at temperature > 0 adds counter-based Gumbel noise, a pure
// function of (seed, t, b, c) with counter (t*B + b)*C + c over the whole
// batch B (ar_sampler.py:_positional_gumbel); logf, never __logf.
//
// Bound.  Every step re-reads all weights from L2 in every block (3.3 MB
// exact), with only 8 warps per SM to keep loads in flight, and a step is
// a chain of barrier-separated phases: 3 per layer exact, 2 per layer
// fast, over 30 layers, plus the head and the reductions.  So the kernel
// is bound by the latency of its L2 reads and by barrier latency, not by
// arithmetic; B streams cost about what one does, on B SMs.  The dot
// products issue 16 loads at a time per thread, and the kernel is built
// for one block per SM (__launch_bounds__(256, 1)) so that ptxas may
// spend registers on them.
// With video the cb phase reads W_ctx too (L*R*2R*4 bytes, 0.98 MB at the
// flagship width) in L*2R independent dot products, 15 per thread, and
// the ctx row (R floats) comes from global memory once per step.
// Staging weights in shared memory, streaming ctx ahead with cp.async or
// TMA, splitting a stream over a
// thread-block cluster, and sharing one block among the B streams are
// later work.
//
// Speculative form.  ar_sampler_spec_kernel<FAST, NCH> replaces the TPU
// kernel ar_sampler.py:_make_spec_kernel (pallas_call at ar_sampler.py:
// 1054): B=1 without video, in both forms.  Each iteration runs the real
// chain at step t and NCH-1 speculative chains at t+1 (and t+2), under
// guesses from n-gram tables (t2 (C) in shared memory; the (C, C) pair
// table t3 in a per-launch global copy, read and written by thread 0
// only).  Chain k feeds on the codes (x_t, x_{t-1}) shifted by k guesses
// and its layer-l ring tap at time t+k-d is chain k-d's layer input when
// d <= k and the untouched ring slot of t+k otherwise.  Its ring writes
// wait in shared memory (L*R floats per chain) and commit, in time
// order, only when the real code equals the guess: then, and only
// then, they are what the standard kernel would have written.  So the
// codes equal the standard kernel's for any guess sequence provided
// every chain runs the standard kernel's float32 operations in its
// order: the same fmaf chains (dots<N> gives each chain its own
// accumulator over one shared weight load, so an iteration reads the
// weights once for all chains), the same __fadd_rn/__fmul_rn steps, the
// same block reductions, and the Gumbel noise of position t+k.  In fast
// mode the next layer's [h|tap] product of a speculative chain whose tap
// is another chain's fresh h (d(l+1) <= k) waits for one more phase
// after phase M; that happens at the first two layers of each stack.
// Bound: as the standard kernel, by L2 reads of the weights per step, of
// which a hit saves one or two steps' worth; the extra chains add FMAs
// per load and one barrier phase at those layers.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Params {
  const float* front_cur;   // (C, R)
  const float* front_past;  // (C, R)
  const float* w_fg;        // (L, 2R, 2R), with ctx (L, 3R, 2R); fast:
                            //   gate columns halved
  const float* b_fg;        // (L, B, 2R)    fast: + b_corr, columns scaled
  const float* w_out;       // (L, R, R+S)   fast: halved
  const float* b_out;       // (L, R+S)
  const float* h1_w;        // (S, C)
  const float* h1_b;        // (C)
  const float* h2_w;        // (C, C)
  const float* h2_b;        // (C)
  const float* fc0;         // (C, 2R)       fast only
  const float* fp0;         // (C, 2R)       fast only
  const float* w_p0c;       // (R, 2R) fast only; with ctx (2R, 2R) =
                            //   [W_past_0; W_ctx_0]
  const float* w_prod;      // (L, R, 2R)    fast only
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

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.f ? x : __fmul_rn(0.01f, x);
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// dot(x[0:k], w[0:k, col]) for a row-major w with `stride` columns.  The
// weight loads are L2 hits whose latency bounds the loop, so they are
// issued 16 at a time into registers ahead of their fmaf's (a loop that
// is only unrolled let nvcc interleave each fmaf with the next loads,
// leaving few in flight); the sum stays one fmaf chain in index order.
__device__ __forceinline__ float dot_col(const float* x, const float* w,
                                         int k, int stride) {
  float acc = 0.f;
  int i = 0;
  for (; i + 16 <= k; i += 16) {
    float wv[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) wv[u] = __ldg(w + (i + u) * stride);
#pragma unroll
    for (int u = 0; u < 16; ++u) acc = fmaf(x[i + u], wv[u], acc);
  }
  for (; i < k; ++i) acc = fmaf(x[i], __ldg(w + i * stride), acc);
  return acc;
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

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// first index of the maximum over the block's (value, index) pairs
__device__ int block_argmax(float v, int i, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(~0u, v, o);
    const int oi = __shfl_xor_sync(~0u, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
  __syncthreads();
  float bv = red_v[0];
  int bi = red_i[0];
  for (int w = 1; w < kWarps; ++w)
    if (better(red_v[w], red_i[w], bv, bi)) { bv = red_v[w]; bi = red_i[w]; }
  __syncthreads();
  return bi;
}

template <bool FAST, bool HAS_CTX>
__global__ void __launch_bounds__(kThreads, 1) ar_sampler_kernel(Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int C = p.c_in, R = p.r, R2 = 2 * p.r, S = p.s, RS = p.r + p.s;
  const int L = p.n_layers;

  float* x = smem;             // 2R: [h | ring tap of the current layer]
  float* h_next = x + R2;      // R   (fast) h of the next layer
  float* part0 = h_next + R;   // 2R  exact: fg over h;    fast: gated @ w_prod
  float* part1 = part0 + R2;   // 2R  exact: fg over tap;  fast: next [h|tap] @ w_fg + b
  float* gated = part1 + R2;   // R
  float* skip = gated + R;     // S
  float* act = skip + S;       // C   leaky(head1 output)
  float* scores = act + C;     // C
  float* red_v = scores + C;   // kWarps
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);  // kWarps
  float* xc = reinterpret_cast<float*>(red_i + kWarps);  // R    (ctx) ctx_t
  float* cb = xc + R;          // L*2R (ctx) the step's fg bias per layer

  float* ring = p.ring + static_cast<size_t>(b) * p.sum_d * R;
  const float* b_fg_b = p.b_fg + static_cast<size_t>(b) * R2;  // + l*B*2R
  const size_t b_fg_layer = static_cast<size_t>(p.batch) * R2;
  const float* ctx_b =
      HAS_CTX ? p.ctx + static_cast<size_t>(b) * p.n_samples * R : nullptr;
  // layer l's fg taps: (2R, 2R), with ctx (3R, 2R)
#define W_FG(l) \
  (p.w_fg + static_cast<size_t>(l) * (HAS_CTX ? 3 * R : R2) * R2)
  // the fg bias rows of layer l for the current step, and element i of
  // them: b_fg[l, b] through the read-only path, or with video the
  // step's cb[l] in shared memory
#define FG_ROW(l) (HAS_CTX ? cb + (l) * R2 : b_fg_b + (l) * b_fg_layer)
#define FG_B(row, i) (HAS_CTX ? (row)[i] : __ldg((row) + (i)))
  const int n_out = p.n_samples - p.rf;
  int prev = p.init_codes[b];
  int cur = p.init_codes[p.batch + b];

  for (int t = p.rf; t < p.n_samples; ++t) {
    // ---- front: h = E_cur[cur] + E_past[prev]; tap of layer 0
    // a code outside [0, C) (only from NaN scores) embeds as zeros, as
    // the one-hot product of the TPU kernel does
    const bool cur_ok = cur >= 0 && cur < C, prev_ok = prev >= 0 && prev < C;
    const int slot0 = __ldg(p.off) + t % __ldg(p.dil);
    for (int j = tid; j < R; j += kThreads) {
      x[j] = (cur_ok ? __ldg(p.front_cur + cur * R + j) : 0.f)
           + (prev_ok ? __ldg(p.front_past + prev * R + j) : 0.f);
      x[R + j] = ring[slot0 * R + j];
    }
    for (int j = tid; j < S; j += kThreads) skip[j] = 0.f;
    if constexpr (HAS_CTX) {
      for (int j = tid; j < R; j += kThreads)
        xc[j] = __ldg(ctx_b + static_cast<size_t>(t) * R + j);
    }
    __syncthreads();

    if constexpr (HAS_CTX) {
      // phase P: cb[l] = ctx_t @ W_ctx[l] + b_fg[l, b] for every layer;
      // fast layer 0 takes W_ctx_0 from the ctx rows of w_p0c
      for (int i = tid; i < L * R2; i += kThreads) {
        const int l = i / R2, j = i - l * R2;
        const float* wc = FAST && l == 0 ? p.w_p0c + R * R2
                                         : W_FG(l) + R2 * R2;
        cb[i] = __fadd_rn(dot_col(xc, wc + j, R, R2),
                          __ldg(b_fg_b + l * b_fg_layer + j));
      }
      __syncthreads();
    }

    if (!FAST) {
      for (int l = 0; l < L; ++l) {
        const int slot = __ldg(p.off + l) + t % __ldg(p.dil + l);
        // phase A: fg partial sums over the h rows and the tap rows
        const float* w = W_FG(l);
        for (int i = tid; i < 2 * R2; i += kThreads) {
          const int half = i / R2, j = i - half * R2;
          const float acc = dot_col(x + half * R, w + half * R * R2 + j, R, R2);
          (half ? part1 : part0)[j] = acc;
        }
        __syncthreads();
        // phase B: gate
        const float* bl = FG_ROW(l);
        for (int i = tid; i < R; i += kThreads) {
          const float f = __fadd_rn(__fadd_rn(part0[i], part1[i]),
                                    FG_B(bl, i));
          const float g = __fadd_rn(__fadd_rn(part0[R + i], part1[R + i]),
                                    FG_B(bl, R + i));
          gated[i] = __fmul_rn(tanhf(f), sigmoidf_(g));
        }
        __syncthreads();
        // phase C: res/skip outputs; ring write of the old h; next tap
        const float* wo = p.w_out + static_cast<size_t>(l) * R * RS;
        const float* bo = p.b_out + l * RS;
        const int next_slot = l + 1 < L
            ? __ldg(p.off + l + 1) + t % __ldg(p.dil + l + 1) : 0;
        for (int i = tid; i < RS + R; i += kThreads) {
          if (i < RS) {
            const float o = __fadd_rn(dot_col(gated, wo + i, R, RS), __ldg(bo + i));
            if (i < R) {
              ring[slot * R + i] = x[i];
              x[i] = __fadd_rn(o, x[i]);
            } else {
              skip[i - R] = __fadd_rn(skip[i - R], o);
            }
          } else if (l + 1 < L) {
            const int j = i - RS;
            x[R + j] = ring[next_slot * R + j];
          }
        }
        __syncthreads();
      }
    } else {
      // layer 0's fg: fc0[cur] + ((fp0[prev] + tap0 @ w_p0c) + b_fg[0]);
      // with video the bias is cb[0], which holds the ctx rows' product
      const float* b0 = FG_ROW(0);
      for (int j = tid; j < R2; j += kThreads) {
        part0[j] = cur_ok ? __ldg(p.fc0 + cur * R2 + j) : 0.f;
        const float pre = __fadd_rn(prev_ok ? __ldg(p.fp0 + prev * R2 + j) : 0.f,
                                    dot_col(x + R, p.w_p0c + j, R, R2));
        part1[j] = __fadd_rn(pre, FG_B(b0, j));
      }
      __syncthreads();
      for (int l = 0; l < L; ++l) {
        const int slot = __ldg(p.off + l) + t % __ldg(p.dil + l);
        const bool more = l + 1 < L;
        // phase G: packed-tanh gate on fg = part0 + part1; move in the
        // previous layer's h; fetch the next layer's tap
        const int next_slot = more
            ? __ldg(p.off + l + 1) + t % __ldg(p.dil + l + 1) : 0;
        for (int i = tid; i < R; i += kThreads) {
          const float v0 = tanhf(__fadd_rn(part0[i], part1[i]));
          const float v1 = tanhf(__fadd_rn(part0[R + i], part1[R + i]));
          gated[i] = __fadd_rn(__fmul_rn(v0, v1), v0);
          if (l > 0) x[i] = h_next[i];
          if (more) x[R + i] = ring[next_slot * R + i];
        }
        __syncthreads();
        // phase M: the dependent product gated @ w_prod, the next layer's
        // [h|tap] product, and the res/skip outputs, side by side
        const float* wp = p.w_prod + static_cast<size_t>(l) * R * R2;
        const float* wn = W_FG(l + 1);
        const float* bn = FG_ROW(l + 1);
        const float* wo = p.w_out + static_cast<size_t>(l) * R * RS;
        const float* bo = p.b_out + l * RS;
        for (int i = tid; i < 2 * R2 + RS; i += kThreads) {
          if (i < R2) {
            if (more) part0[i] = dot_col(gated, wp + i, R, R2);
          } else if (i < 2 * R2) {
            const int j = i - R2;
            if (more)
              part1[j] = __fadd_rn(dot_col(x, wn + j, R2, R2),
                                   FG_B(bn, j));
          } else {
            const int j = i - 2 * R2;
            const float o = __fadd_rn(dot_col(gated, wo + j, R, RS), __ldg(bo + j));
            if (j < R) {
              ring[slot * R + j] = x[j];
              h_next[j] = __fadd_rn(o, x[j]);
            } else {
              skip[j - R] = __fadd_rn(skip[j - R], o);
            }
          }
        }
        __syncthreads();
      }
    }

    // ---- head: y = leaky(skip) @ W1 + b1; logits = leaky(y) @ W2 + b2
    for (int c = tid; c < C; c += kThreads) {
      float acc = 0.f;
#pragma unroll 16
      for (int k = 0; k < S; ++k)
        acc = fmaf(leaky(skip[k]), __ldg(p.h1_w + k * C + c), acc);
      act[c] = leaky(__fadd_rn(acc, __ldg(p.h1_b + c)));
    }
    __syncthreads();
    float local_max = -CUDART_INF_F;
    for (int c = tid; c < C; c += kThreads) {
      const float logit = __fadd_rn(dot_col(act, p.h2_w + c, C, C), __ldg(p.h2_b + c));
      scores[c] = logit;
      local_max = fmaxf(local_max, logit);
    }

    // ---- sampling: greedy, or Gumbel-max on logits/T or softmax/T
    float best_v = -CUDART_INF_F;
    int best_i = C;
    if (p.temperature == 0.f) {
      for (int c = tid; c < C; c += kThreads)
        if (better(scores[c], c, best_v, best_i)) { best_v = scores[c]; best_i = c; }
    } else {
      float denom = 1.f;
      float m = 0.f;
      if (p.parity) {
        m = block_max(local_max, red_v);
        float local_sum = 0.f;
        for (int c = tid; c < C; c += kThreads) {
          const float e = expf(__fsub_rn(scores[c], m));
          scores[c] = e;
          local_sum = __fadd_rn(local_sum, e);
        }
        denom = block_sum(local_sum, red_v);
      }
      for (int c = tid; c < C; c += kThreads) {
        const float base = p.parity
            ? __fdiv_rn(__fdiv_rn(scores[c], denom), p.temperature)
            : __fdiv_rn(scores[c], p.temperature);
        const float v = __fadd_rn(
            base, positional_gumbel(p.seed, static_cast<uint32_t>(t),
                                    static_cast<uint32_t>(p.batch),
                                    static_cast<uint32_t>(b),
                                    static_cast<uint32_t>(C),
                                    static_cast<uint32_t>(c)));
        if (better(v, c, best_v, best_i)) { best_v = v; best_i = c; }
      }
    }
    const int nxt = block_argmax(best_v, best_i, red_v, red_i);
    if (tid == 0) p.out[static_cast<size_t>(b) * n_out + (t - p.rf)] = cur;
    prev = cur;
    cur = nxt;
  }
#undef W_FG
#undef FG_ROW
#undef FG_B
}

size_t shared_bytes(int c_in, int r, int s, int n_layers, bool has_ctx) {
  const size_t ctx_floats =
      has_ctx ? static_cast<size_t>(r) + static_cast<size_t>(n_layers) * 2 * r
              : 0;
  return sizeof(float) * (2 * r + r + 2 * r + 2 * r + r + s + 2 * c_in + kWarps
                          + ctx_floats)
         + sizeof(int) * kWarps;
}

template <bool FAST, bool HAS_CTX>
int launch_standard(const Params& p, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ar_sampler_kernel<FAST, HAS_CTX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ar_sampler_kernel<FAST, HAS_CTX><<<p.batch, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- speculative form

struct SpecParams {
  int* t2;        // (C)    successor table, -1 unseen; read once, kept in smem
  int* t3;        // (C, C) pair table, -1 unseen; null for order 2
  int* hits;      // (1)    committed guesses
  int order;      // 2 or 3
  int adaptive;   // learn the tables from the committed codes
};

// acc[c] = xa[c][0:k1] . w[0:k1, col] continued over xb[c][0:k2] . w[k1:k1+k2,
// col], one fmaf chain per c in the order dot_col sums: so chain c gets
// the bits dot_col gives it over the concatenated [xa | xb], and every
// weight is loaded once for all N chains.
template <int N>
__device__ __forceinline__ void dots(const float* const* xa,
                                     const float* const* xb, const float* w,
                                     int k1, int k2, int stride, float* acc) {
  float a[N];
#pragma unroll
  for (int c = 0; c < N; ++c) a[c] = 0.f;
#pragma unroll 16
  for (int i = 0; i < k1; ++i) {
    const float wv = __ldg(w + i * stride);
#pragma unroll
    for (int c = 0; c < N; ++c) a[c] = fmaf(xa[c][i], wv, a[c]);
  }
  w += static_cast<size_t>(k1) * stride;
#pragma unroll 16
  for (int i = 0; i < k2; ++i) {
    const float wv = __ldg(w + i * stride);
#pragma unroll
    for (int c = 0; c < N; ++c) a[c] = fmaf(xb[c][i], wv, a[c]);
  }
#pragma unroll
  for (int c = 0; c < N; ++c) acc[c] = a[c];
}

// dots<n> for a run-time n in [1, NMAX]
template <int NMAX>
__device__ __forceinline__ void dots_n(int n, const float* const* xa,
                                       const float* const* xb, const float* w,
                                       int k1, int k2, int stride, float* acc) {
  if (n == 1) {
    dots<1>(xa, xb, w, k1, k2, stride, acc);
  } else if (n == 2) {
    dots<2>(xa, xb, w, k1, k2, stride, acc);
  } else if constexpr (NMAX >= 3) {
    dots<3>(xa, xb, w, k1, k2, stride, acc);
  }
}

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

// floats of one chain's buffers: x [h|tap] 2R, h_next R, part0 2R, part1
// 2R, gated R, skip S, act C, scores C
__host__ __device__ __forceinline__ int chain_floats(int c_in, int r, int s) {
  return 2 * r + r + 2 * r + 2 * r + r + s + 2 * c_in;
}

size_t spec_shared_bytes(int nch, int c_in, int r, int s, int n_layers) {
  return sizeof(float) * (static_cast<size_t>(nch) * chain_floats(c_in, r, s)
                          + static_cast<size_t>(nch - 1) * n_layers * r + kWarps)
         + sizeof(int) * (kWarps + c_in + 2);
}

template <bool FAST, int NCH>
__global__ void __launch_bounds__(kThreads)
ar_sampler_spec_kernel(Params p, SpecParams q) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int C = p.c_in, R = p.r, R2 = 2 * p.r, S = p.s, RS = p.r + p.s;
  const int L = p.n_layers, LR = p.n_layers * p.r;
  const int cs = chain_floats(C, R, S);
  // chain k's buffers start at smem + k * cs
  constexpr int oX = 0;
  const int oHN = R2, oP0 = oHN + R, oP1 = oP0 + R2, oG = oP1 + R2,
            oSk = oG + R, oAct = oSk + S, oSc = oAct + C;
#define CH(k, o) (smem + (k) * cs + (o))
  float* spec = smem + NCH * cs;             // chain k>=1 at (k-1) * LR
  float* red_v = spec + (NCH - 1) * LR;
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);
  int* t2s = red_i + kWarps;                 // C
  int* guess = t2s + C;                      // g1, g2

  float* ring = p.ring;
  const int n = p.n_samples;
  int prev = p.init_codes[0];
  int cur = p.init_codes[1];
  for (int c = tid; c < C; c += kThreads) t2s[c] = q.t2[c];
  __syncthreads();
  if (tid == 0) {
    const int g1 = spec_guess1(prev, cur, t2s, q.t3, C, q.order);
    guess[0] = g1;
    guess[1] = NCH == 3 ? spec_guess2(cur, g1, t2s, q.t3, C, q.order) : 0;
  }
  __syncthreads();

  int t = p.rf;
  int hits = 0;
  while (t < n) {
    const int g1 = guess[0], g2 = guess[1];
    // chain k embeds (cc[k], pc[k]): (x_t, x_{t-1}), (g1, x_t), (g2, g1)
    const int cc[3] = {cur, g1, g2};
    const int pc[3] = {prev, cur, g1};

    // ---- front: each chain's h; layer 0's taps
    const int d0 = __ldg(p.dil), o0 = __ldg(p.off);
    for (int j = tid; j < R; j += kThreads) {
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        CH(k, oX)[j] =
            (code_ok(cc[k], C) ? __ldg(p.front_cur + cc[k] * R + j) : 0.f)
            + (code_ok(pc[k], C) ? __ldg(p.front_past + pc[k] * R + j) : 0.f);
        CH(k, oX)[R + j] = d0 <= k ? CH(k - d0, oX)[j]
                                   : ring[(o0 + (t + k) % d0) * R + j];
      }
    }
    for (int j = tid; j < S; j += kThreads) {
#pragma unroll
      for (int k = 0; k < NCH; ++k) CH(k, oSk)[j] = 0.f;
    }
    __syncthreads();

    const float* xs[NCH];
    const float* xb[NCH];
    float acc[NCH];
    if (!FAST) {
      for (int l = 0; l < L; ++l) {
        const int slot = __ldg(p.off + l) + t % __ldg(p.dil + l);
        // phase A: fg partial sums over the h rows and the tap rows
        const float* w = p.w_fg + static_cast<size_t>(l) * R2 * R2;
        for (int i = tid; i < 2 * R2; i += kThreads) {
          const int half = i / R2, j = i - half * R2;
#pragma unroll
          for (int k = 0; k < NCH; ++k) xs[k] = CH(k, oX) + half * R;
          dots<NCH>(xs, xs, w + half * R * R2 + j, R, 0, R2, acc);
#pragma unroll
          for (int k = 0; k < NCH; ++k) CH(k, half ? oP1 : oP0)[j] = acc[k];
        }
        __syncthreads();
        // phase B: gate
        const float* bl = p.b_fg + l * R2;
        for (int i = tid; i < R; i += kThreads) {
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            const float f = __fadd_rn(__fadd_rn(CH(k, oP0)[i], CH(k, oP1)[i]),
                                      __ldg(bl + i));
            const float g = __fadd_rn(
                __fadd_rn(CH(k, oP0)[R + i], CH(k, oP1)[R + i]),
                __ldg(bl + R + i));
            CH(k, oG)[i] = __fmul_rn(tanhf(f), sigmoidf_(g));
          }
        }
        __syncthreads();
        // phase C: res/skip outputs; the real ring write and the deferred
        // spec ones; the next layer's taps
        const float* wo = p.w_out + static_cast<size_t>(l) * R * RS;
        const float* bo = p.b_out + l * RS;
        const bool more = l + 1 < L;
        const int dn = more ? __ldg(p.dil + l + 1) : 1;
        const int on = more ? __ldg(p.off + l + 1) : 0;
        for (int i = tid; i < RS + R; i += kThreads) {
          if (i < RS) {
#pragma unroll
            for (int k = 0; k < NCH; ++k) xs[k] = CH(k, oG);
            dots<NCH>(xs, xs, wo + i, R, 0, RS, acc);
#pragma unroll
            for (int k = 0; k < NCH; ++k) {
              const float o = __fadd_rn(acc[k], __ldg(bo + i));
              if (i < R) {
                if (k == 0) ring[slot * R + i] = CH(0, oX)[i];
                else spec[(k - 1) * LR + l * R + i] = CH(k, oX)[i];
                CH(k, oX)[i] = __fadd_rn(o, CH(k, oX)[i]);
              } else {
                CH(k, oSk)[i - R] = __fadd_rn(CH(k, oSk)[i - R], o);
              }
            }
            if (i < R && more) {
#pragma unroll
              for (int k = 1; k < NCH; ++k)
                if (dn <= k) CH(k, oX)[R + i] = CH(k - dn, oX)[i];
            }
          } else if (more) {
            const int j = i - RS;
#pragma unroll
            for (int k = 0; k < NCH; ++k)
              if (dn > k) CH(k, oX)[R + j] = ring[(on + (t + k) % dn) * R + j];
          }
        }
        __syncthreads();
      }
    } else {
      // layer 0's fg: fc0[c] + ((fp0[p] + tap0 @ w_p0c) + b_fg[0])
      for (int j = tid; j < R2; j += kThreads) {
#pragma unroll
        for (int k = 0; k < NCH; ++k) xs[k] = CH(k, oX) + R;
        dots<NCH>(xs, xs, p.w_p0c + j, R, 0, R2, acc);
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          CH(k, oP0)[j] =
              code_ok(cc[k], C) ? __ldg(p.fc0 + cc[k] * R2 + j) : 0.f;
          const float pre = __fadd_rn(
              code_ok(pc[k], C) ? __ldg(p.fp0 + pc[k] * R2 + j) : 0.f, acc[k]);
          CH(k, oP1)[j] = __fadd_rn(pre, __ldg(p.b_fg + j));
        }
      }
      __syncthreads();
      for (int l = 0; l < L; ++l) {
        const int slot = __ldg(p.off + l) + t % __ldg(p.dil + l);
        const bool more = l + 1 < L;
        const int dn = more ? __ldg(p.dil + l + 1) : 1;
        const int on = more ? __ldg(p.off + l + 1) : 0;
        // chains 0..ready-1 read their next tap from the ring; chain k >=
        // ready reads chain (k - dn)'s h_next, known only after phase M
        const int ready = more ? (dn < NCH ? dn : NCH) : NCH;
        // phase G: packed-tanh gates; move in h; fetch the ring taps
        for (int i = tid; i < R; i += kThreads) {
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            const float v0 = tanhf(__fadd_rn(CH(k, oP0)[i], CH(k, oP1)[i]));
            const float v1 =
                tanhf(__fadd_rn(CH(k, oP0)[R + i], CH(k, oP1)[R + i]));
            CH(k, oG)[i] = __fadd_rn(__fmul_rn(v0, v1), v0);
            if (l > 0) CH(k, oX)[i] = CH(k, oHN)[i];
            if (more && k < ready)
              CH(k, oX)[R + i] = ring[(on + (t + k) % dn) * R + i];
          }
        }
        __syncthreads();
        // phase M: gated @ w_prod, the ready chains' next [h|tap] product,
        // and the res/skip outputs, side by side
        const float* wp = p.w_prod + static_cast<size_t>(l) * R * R2;
        const float* wn = p.w_fg + static_cast<size_t>(l + 1) * R2 * R2;
        const float* bn = p.b_fg + (l + 1) * R2;
        const float* wo = p.w_out + static_cast<size_t>(l) * R * RS;
        const float* bo = p.b_out + l * RS;
        for (int i = tid; i < 2 * R2 + RS; i += kThreads) {
          if (i < R2) {
            if (more) {
#pragma unroll
              for (int k = 0; k < NCH; ++k) xs[k] = CH(k, oG);
              dots<NCH>(xs, xs, wp + i, R, 0, R2, acc);
#pragma unroll
              for (int k = 0; k < NCH; ++k) CH(k, oP0)[i] = acc[k];
            }
          } else if (i < 2 * R2) {
            const int j = i - R2;
            if (more) {
#pragma unroll
              for (int k = 0; k < NCH; ++k) xs[k] = CH(k, oX);
              dots_n<NCH>(ready, xs, xs, wn + j, R2, 0, R2, acc);
#pragma unroll
              for (int k = 0; k < NCH; ++k)
                if (k < ready) CH(k, oP1)[j] = __fadd_rn(acc[k], __ldg(bn + j));
            }
          } else {
            const int j = i - 2 * R2;
#pragma unroll
            for (int k = 0; k < NCH; ++k) xs[k] = CH(k, oG);
            dots<NCH>(xs, xs, wo + j, R, 0, RS, acc);
#pragma unroll
            for (int k = 0; k < NCH; ++k) {
              const float o = __fadd_rn(acc[k], __ldg(bo + j));
              if (j < R) {
                if (k == 0) ring[slot * R + j] = CH(0, oX)[j];
                else spec[(k - 1) * LR + l * R + j] = CH(k, oX)[j];
                CH(k, oHN)[j] = __fadd_rn(o, CH(k, oX)[j]);
              } else {
                CH(k, oSk)[j - R] = __fadd_rn(CH(k, oSk)[j - R], o);
              }
            }
          }
        }
        __syncthreads();
        // phase M2: the late chains' next product over [h | h_next of
        // chain k - dn], the same fmaf chain as over a copied tap
        if (more && ready < NCH) {
          const int late = NCH - ready;
          for (int j = tid; j < R2; j += kThreads) {
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
              const int k = ready + c < NCH ? ready + c : NCH - 1;
              xs[c] = CH(k, oX);
              xb[c] = CH(k - dn, oHN);
            }
            dots_n<NCH>(late, xs, xb, wn + j, R, R, R2, acc);
#pragma unroll
            for (int c = 0; c < NCH; ++c)
              if (c < late)
                CH(ready + c, oP1)[j] = __fadd_rn(acc[c], __ldg(bn + j));
          }
          __syncthreads();
        }
      }
    }

    // ---- heads: y = leaky(skip) @ W1 + b1; logits = leaky(y) @ W2 + b2
    for (int c = tid; c < C; c += kThreads) {
      float a[NCH];
#pragma unroll
      for (int k = 0; k < NCH; ++k) a[k] = 0.f;
#pragma unroll 16
      for (int kk = 0; kk < S; ++kk) {
        const float wv = __ldg(p.h1_w + kk * C + c);
#pragma unroll
        for (int k = 0; k < NCH; ++k) a[k] = fmaf(leaky(CH(k, oSk)[kk]), wv, a[k]);
      }
#pragma unroll
      for (int k = 0; k < NCH; ++k)
        CH(k, oAct)[c] = leaky(__fadd_rn(a[k], __ldg(p.h1_b + c)));
    }
    __syncthreads();
    float local_max[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      local_max[k] = -CUDART_INF_F;
      xs[k] = CH(k, oAct);
    }
    for (int c = tid; c < C; c += kThreads) {
      dots<NCH>(xs, xs, p.h2_w + c, C, 0, C, acc);
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const float logit = __fadd_rn(acc[k], __ldg(p.h2_b + c));
        CH(k, oSc)[c] = logit;
        local_max[k] = fmaxf(local_max[k], logit);
      }
    }

    // ---- sampling of chain k at position t+k, as the standard kernel
    int nxt[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      float* scores = CH(k, oSc);
      float best_v = -CUDART_INF_F;
      int best_i = C;
      if (p.temperature == 0.f) {
        for (int c = tid; c < C; c += kThreads)
          if (better(scores[c], c, best_v, best_i)) { best_v = scores[c]; best_i = c; }
      } else {
        float denom = 1.f;
        float m = 0.f;
        if (p.parity) {
          m = block_max(local_max[k], red_v);
          float local_sum = 0.f;
          for (int c = tid; c < C; c += kThreads) {
            const float e = expf(__fsub_rn(scores[c], m));
            scores[c] = e;
            local_sum = __fadd_rn(local_sum, e);
          }
          denom = block_sum(local_sum, red_v);
        }
        for (int c = tid; c < C; c += kThreads) {
          const float base = p.parity
              ? __fdiv_rn(__fdiv_rn(scores[c], denom), p.temperature)
              : __fdiv_rn(scores[c], p.temperature);
          const float v = __fadd_rn(
              base, positional_gumbel(p.seed, static_cast<uint32_t>(t + k), 1u,
                                      0u, static_cast<uint32_t>(C),
                                      static_cast<uint32_t>(c)));
          if (better(v, c, best_v, best_i)) { best_v = v; best_i = c; }
        }
      }
      nxt[k] = block_argmax(best_v, best_i, red_v, red_i);
    }

    // ---- commit: a guess holds only if the real code equals it
    const bool hit = nxt[0] == g1 && t + 1 < n;
    const bool hit2 = NCH == 3 && hit && nxt[NCH - 2] == g2 && t + 2 < n;
    if (hit) {
      for (int i = tid; i < LR; i += kThreads) {
        const int l = i / R, j = i - l * R;
        const int d = __ldg(p.dil + l), o = __ldg(p.off + l);
        ring[(o + (t + 1) % d) * R + j] = spec[i];
        // s2 after s1: at d <= 2 the slots coincide, the later time wins
        if (hit2) ring[(o + (t + 2) % d) * R + j] = spec[LR + i];
      }
    }
    if (tid == 0) {
      if (q.adaptive) {
        // later writes win: x_t -> x_{t+1}, then the committed ones
        if (code_ok(cur, C)) t2s[cur] = nxt[0];
        if (hit && code_ok(g1, C)) t2s[g1] = nxt[1];
        if (hit2 && code_ok(g2, C)) t2s[g2] = nxt[NCH - 1];
        if (q.order == 3) {
          // the TPU kernel keys the row on prev's one-hot: row 0 when
          // prev lies outside [0, C)
          if (code_ok(cur, C)) q.t3[(code_ok(prev, C) ? prev : 0) * C + cur] = nxt[0];
          if (hit && code_ok(cur, C) && code_ok(g1, C)) q.t3[cur * C + g1] = nxt[1];
          if (hit2 && code_ok(g1, C) && code_ok(g2, C))
            q.t3[g1 * C + g2] = nxt[NCH - 1];
        }
      }
      p.out[t - p.rf] = cur;
      if (hit) p.out[t + 1 - p.rf] = g1;
      if (hit2) p.out[t + 2 - p.rf] = g2;
    }
    hits += static_cast<int>(hit) + static_cast<int>(hit2);
    if (hit2) {
      t += 3; prev = g2; cur = nxt[NCH - 1];
    } else if (hit) {
      t += 2; prev = g1; cur = nxt[1];
    } else {
      t += 1; prev = cur; cur = nxt[0];
    }
    if (tid == 0) {
      const int ng1 = spec_guess1(prev, cur, t2s, q.t3, C, q.order);
      guess[0] = ng1;
      guess[1] = NCH == 3 ? spec_guess2(cur, ng1, t2s, q.t3, C, q.order) : 0;
    }
    __syncthreads();
  }
  if (tid == 0) *q.hits = hits;
#undef CH
}

template <bool FAST, int NCH>
int launch_spec(const Params& p, const SpecParams& q, size_t smem,
                cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ar_sampler_spec_kernel<FAST, NCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ar_sampler_spec_kernel<FAST, NCH><<<1, kThreads, smem, st>>>(p, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the sampler on `stream`; returns the cudaError_t of the launch.
// `ctx` is the (batch, n_samples, r) video context, or null without video.
int movenet_ar_sampler_launch(
    int fast, const float* front_cur, const float* front_past,
    const float* w_fg, const float* b_fg, const float* w_out,
    const float* b_out, const float* h1_w, const float* h1_b,
    const float* h2_w, const float* h2_b, const float* fc0, const float* fp0,
    const float* w_p0c, const float* w_prod, const int* dil, const int* off,
    float* ring, const int* init_codes, int* out, const float* ctx, int batch,
    int c_in, int r, int s, int n_layers, int sum_d, int rf, int n_samples,
    int seed, int parity, float temperature, void* stream) {
  const bool has_ctx = ctx != nullptr;
  Params p{front_cur, front_past, w_fg, b_fg, w_out, b_out, h1_w, h1_b,
           h2_w, h2_b, fc0, fp0, w_p0c, w_prod, dil, off, ring, init_codes,
           out, batch, c_in, r, s, n_layers, sum_d, rf, n_samples,
           static_cast<uint32_t>(seed), parity, temperature, ctx};
  const size_t smem = shared_bytes(c_in, r, s, n_layers, has_ctx);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (has_ctx)
    return fast ? launch_standard<true, true>(p, smem, st)
                : launch_standard<false, true>(p, smem, st);
  return fast ? launch_standard<true, false>(p, smem, st)
              : launch_standard<false, false>(p, smem, st);
}

// Launches the speculative sampler (B=1, one block) on `stream`; t2 and t3
// are per-launch copies that it updates in place.  Returns the
// cudaError_t of the launch.
int movenet_ar_sampler_spec_launch(
    int fast, int order, int depth, int adaptive, const float* front_cur,
    const float* front_past, const float* w_fg, const float* b_fg,
    const float* w_out, const float* b_out, const float* h1_w,
    const float* h1_b, const float* h2_w, const float* h2_b, const float* fc0,
    const float* fp0, const float* w_p0c, const float* w_prod, const int* dil,
    const int* off, float* ring, const int* init_codes, int* t2, int* t3,
    int* out, int* hits, int c_in, int r, int s, int n_layers, int sum_d,
    int rf, int n_samples, int seed, int parity, float temperature,
    void* stream) {
  if ((order != 2 && order != 3) || (depth != 1 && depth != 2)
      || (order == 3 && t3 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{front_cur, front_past, w_fg, b_fg, w_out, b_out, h1_w, h1_b,
           h2_w, h2_b, fc0, fp0, w_p0c, w_prod, dil, off, ring, init_codes,
           out, 1, c_in, r, s, n_layers, sum_d, rf, n_samples,
           static_cast<uint32_t>(seed), parity, temperature, nullptr};
  SpecParams q{t2, t3, hits, order, adaptive};
  const int nch = depth + 1;
  const size_t smem = spec_shared_bytes(nch, c_in, r, s, n_layers);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast)
    return nch == 2 ? launch_spec<true, 2>(p, q, smem, st)
                    : launch_spec<true, 3>(p, q, smem, st);
  return nch == 2 ? launch_spec<false, 2>(p, q, smem, st)
                  : launch_spec<false, 3>(p, q, smem, st);
}

const char* movenet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
