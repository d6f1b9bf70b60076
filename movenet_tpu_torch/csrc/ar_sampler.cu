// Autoregressive WaveNet sampler: the whole generation loop in one launch.
//
// Replaces the TPU kernel movenet_tpu/ops/pallas/ar_sampler.py:_make_kernel
// (launched by pallas_call at ar_sampler.py:1088 from pallas_generate), for
// the audio-only case (has_ctx=False), in both its forms:
//   FAST=false  the exact chain: per layer fg = [h|past] @ W_fg + b_fg,
//               gated = tanh(f) * sigmoid(g), out = gated @ W_out + b_out;
//   FAST=true   the reassociated chain of stack_fast_weights: one product
//               of gated with W_res W_cur(l+1) per layer, the next layer's
//               [h|past] product beside it, and the packed-tanh gate
//               v0*v1 + v0 (the 0.5 and 2x factors live in the weights).
// Both are float32 throughout.  The TPU's lane packing of the output codes
// and its single-pass-MXU precision in fast mode are not carried over.
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
// products are unrolled so that each thread has 16 loads in flight.
// Staging weights in shared memory, splitting a stream over a
// thread-block cluster, and sharing one block among the B streams are
// later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Params {
  const float* front_cur;   // (C, R)
  const float* front_past;  // (C, R)
  const float* w_fg;        // (L, 2R, 2R)   fast: gate columns halved
  const float* b_fg;        // (L, B, 2R)    fast: + b_corr, columns scaled
  const float* w_out;       // (L, R, R+S)   fast: halved
  const float* b_out;       // (L, R+S)
  const float* h1_w;        // (S, C)
  const float* h1_b;        // (C)
  const float* h2_w;        // (C, C)
  const float* h2_b;        // (C)
  const float* fc0;         // (C, 2R)       fast only
  const float* fp0;         // (C, 2R)       fast only
  const float* w_p0c;       // (R, 2R)       fast only
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
};

__device__ __forceinline__ float leaky(float x) {
  return x >= 0.f ? x : __fmul_rn(0.01f, x);
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// dot(x[0:k], w[0:k, col]) for a row-major w with `stride` columns.  The
// weight loads are L2 hits whose latency bounds the loop, so it is
// unrolled to keep 16 of them in flight; the sum stays one fmaf chain.
__device__ __forceinline__ float dot_col(const float* x, const float* w,
                                         int k, int stride) {
  float acc = 0.f;
#pragma unroll 16
  for (int i = 0; i < k; ++i) acc = fmaf(x[i], __ldg(w + i * stride), acc);
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

template <bool FAST>
__global__ void __launch_bounds__(kThreads) ar_sampler_kernel(Params p) {
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

  float* ring = p.ring + static_cast<size_t>(b) * p.sum_d * R;
  const float* b_fg_b = p.b_fg + static_cast<size_t>(b) * R2;  // + l*B*2R
  const size_t b_fg_layer = static_cast<size_t>(p.batch) * R2;
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
    __syncthreads();

    if (!FAST) {
      for (int l = 0; l < L; ++l) {
        const int slot = __ldg(p.off + l) + t % __ldg(p.dil + l);
        // phase A: fg partial sums over the h rows and the tap rows
        const float* w = p.w_fg + static_cast<size_t>(l) * R2 * R2;
        for (int i = tid; i < 2 * R2; i += kThreads) {
          const int half = i / R2, j = i - half * R2;
          const float acc = dot_col(x + half * R, w + half * R * R2 + j, R, R2);
          (half ? part1 : part0)[j] = acc;
        }
        __syncthreads();
        // phase B: gate
        const float* bl = b_fg_b + l * b_fg_layer;
        for (int i = tid; i < R; i += kThreads) {
          const float f = __fadd_rn(__fadd_rn(part0[i], part1[i]), __ldg(bl + i));
          const float g = __fadd_rn(__fadd_rn(part0[R + i], part1[R + i]),
                                    __ldg(bl + R + i));
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
      // layer 0's fg: fc0[cur] + ((fp0[prev] + tap0 @ w_p0c) + b_fg[0])
      for (int j = tid; j < R2; j += kThreads) {
        part0[j] = cur_ok ? __ldg(p.fc0 + cur * R2 + j) : 0.f;
        const float pre = __fadd_rn(prev_ok ? __ldg(p.fp0 + prev * R2 + j) : 0.f,
                                    dot_col(x + R, p.w_p0c + j, R, R2));
        part1[j] = __fadd_rn(pre, __ldg(b_fg_b + j));
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
        const float* wn = p.w_fg + static_cast<size_t>(l + 1) * R2 * R2;
        const float* bn = b_fg_b + (l + 1) * b_fg_layer;
        const float* wo = p.w_out + static_cast<size_t>(l) * R * RS;
        const float* bo = p.b_out + l * RS;
        for (int i = tid; i < 2 * R2 + RS; i += kThreads) {
          if (i < R2) {
            if (more) part0[i] = dot_col(gated, wp + i, R, R2);
          } else if (i < 2 * R2) {
            const int j = i - R2;
            if (more)
              part1[j] = __fadd_rn(dot_col(x, wn + j, R2, R2), __ldg(bn + j));
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
}

size_t shared_bytes(int c_in, int r, int s) {
  return sizeof(float) * (2 * r + r + 2 * r + 2 * r + r + s + 2 * c_in + kWarps)
         + sizeof(int) * kWarps;
}

}  // namespace

extern "C" {

// Launches the sampler on `stream`; returns the cudaError_t of the launch.
int movenet_ar_sampler_launch(
    int fast, const float* front_cur, const float* front_past,
    const float* w_fg, const float* b_fg, const float* w_out,
    const float* b_out, const float* h1_w, const float* h1_b,
    const float* h2_w, const float* h2_b, const float* fc0, const float* fp0,
    const float* w_p0c, const float* w_prod, const int* dil, const int* off,
    float* ring, const int* init_codes, int* out, int batch, int c_in, int r,
    int s, int n_layers, int sum_d, int rf, int n_samples, int seed,
    int parity, float temperature, void* stream) {
  Params p{front_cur, front_past, w_fg, b_fg, w_out, b_out, h1_w, h1_b,
           h2_w, h2_b, fc0, fp0, w_p0c, w_prod, dil, off, ring, init_codes,
           out, batch, c_in, r, s, n_layers, sum_d, rf, n_samples,
           static_cast<uint32_t>(seed), parity, temperature};
  const size_t smem = shared_bytes(c_in, r, s);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          ar_sampler_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    ar_sampler_kernel<true><<<batch, kThreads, smem, st>>>(p);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          ar_sampler_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    ar_sampler_kernel<false><<<batch, kThreads, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* movenet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
