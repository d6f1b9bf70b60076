// Output head + cross-entropy of the training step, forward and backward.
//
// Replaces the TPU kernels movenet_tpu/ops/pallas/head_loss.py:
//   _fwd_kernel (head_loss.py:281, pallas_call at :541): y = leaky(skip) W1
//     + b1, z = leaky(y) W2 + b2, per-row NLL (parity: log sum exp(p) -
//     p[y] on p = softmax(z); clean: lse(z) - z[y]) and first-argmax
//     matches over the valid rows [RF-1, T-1), summed; p saved in f32;
//   _bwd_kernel (head_loss.py:336, pallas_call at :578): dz from the saved
//     p, the two products backwards, the head weight and bias gradients
//     and dskip (bf16);
//   _fwd_kernel_packed (head_loss.py:169, pallas_call at :436) and
//     _bwd_kernel_packed (:218, pallas_call at :473), the PACKED_HEAD
//     route (S = C = 64): the same function with float32 product operands
//     (the TPU's _dot, not _mdot), no softmax save, and a backward that
//     rebuilds y, z and the softmax per tile from skip.  The TPU's two
//     positions per 128 lanes is a layout of that chip; here PACKED is the
//     template flag of the same kernels (head_fwd_kernel<true, SMEM>,
//     head_bwd_kernel<true, SMEM>).
// Unpacked products take bf16 operands (the skip's dtype) and sum in
// float32 with fmaf; the softmax and the probability algebra are float32.
// The tile products and the per-row softmax and CE live in head_core.cuh,
// which the merged trunk + head kernels of stack_kernel.cu share.
//
// Design.  The TPU grid runs (batch, time tile) in order and keeps the
// loss, the match count and the weight gradients in scratch across grid
// steps.  Here each block walks a contiguous range of rows in tiles: the
// products run over shared-memory tiles (4x4 register tiles per thread),
// one thread per row does the softmax and the NLL, and the loss, match
// and weight-gradient sums stay in the block until its range ends.  Each
// block then writes its partial sums, which a second launch adds in a
// fixed order: deterministic, no atomics.
//
// Shared-memory plan (HeadPlan, one rule for 4 <= S <= 64, 4 <= C <= 256,
// multiples of 4).  The row tiles come first: 64 rows, or 32 where 64 do
// not fit (C = 256).  Then, while they fit in 227 KB: the weight-gradient
// sums (dW1, dW2), then the weights (W1, W1^T, W2^T; W2 in the forward and
// the packed backward), each staged as the products take it (rounded to
// bf16 unless PACKED).  What does not fit stays in global memory: a weight
// is prepared there by a first launch and read from L2 by the products
// (64 KB at C = 128, 256 KB at C = 256, resident in the 50 MB L2), a
// weight-gradient sum is kept in the block's own partial-sum row (only its
// owner thread reads and writes an element).  Where everything fits at 64
// rows the kernels take their SMEM form, whose operands are known to lie
// in shared memory.  The unpacked backward at S, C <= 64 keeps its own
// kernel (head_bwd_small_kernel), with separate tiles of the rounded dz
// and dy; the general one sums dz and dy over rows in float32 for db2 and
// db1 by the thread of their column, then rounds them in place.
//
// Bound (breakdancing shape: B*T = 320000 rows, S = C = 64): the forward
// reads skip (41 MB) and writes p (82 MB), 37 us at 3.35 TB/s; the
// backward reads skip and p and writes dskip (164 MB), 49 us.  Its
// 5e9-1.3e10 flop take 5-13 ms at the tensor-core rate, far less than the
// bytes; this version runs them on the f32 units and one thread per row
// for the softmax, so it is bound by instruction rate, not by the bytes.
// The packed form moves no p, so operations bound it (about 5.2e9 float32
// forward and 1.6e10 backward, 0.08 and 0.23 ms at 67 TF/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "head_core.cuh"


namespace {

using head_core::dleaky;
using head_core::leaky;
using head_core::operand;
using head_core::rnd;
using head_core::row_dz;
using head_core::row_nll;
using head_core::row_softmax;
using head_core::tile_product;
using head_core::tile_wgrad;

constexpr int kThreads = head_core::kHeadThreads;
constexpr int kMaxRows = head_core::kHeadRows;   // rows per tile, at most
constexpr int kMaxC = kThreads;                  // one thread per column
// shared memory one block may use on sm_90
constexpr size_t kSmemLimit = 232448;
typedef unsigned short bf16_t;

__device__ __forceinline__ float bf2f(bf16_t u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ bf16_t f2bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

// Where each piece lives: rows per tile, and 1 for an item in shared
// memory (0: global memory).
struct HeadPlan {
  int rows;
  int gw1, gw2, w1, w1t, w2, w2t;
  size_t bytes;
};

struct HeadArgs {
  const bf16_t* skip;   // (M, S)
  const int* pack;      // (T, pack_cols); targets at column tgt_off + b
  int pack_cols, tgt_off;
  const float* w1_in;   // (S, C) the weights as given
  const float* w2_in;   // (C, C)
  const float* w1;      // (S, C) as the products take them (scratch,
  const float* w1t;     // (C, S)  written only where the plan keeps a
  const float* w2;      // (C, C)  weight in global memory)
  const float* w2t;     // (C, C)
  const float* b1;      // (C)
  const float* b2;      // (C)
  const float* p_in;    // (M, C) saved softmax (unpacked backward)
  float* p_out;         // (M, C) softmax to save, or null (forward)
  const float* dloss;   // (1) gradient of the loss sum (backward)
  bf16_t* dskip;        // (M, S) (backward)
  float* part;          // per-block partial sums
  long m_total, rows_per_block;
  int t_len, s, c, rf, parity;
  HeadPlan plan;
};

__device__ __forceinline__ int target_of(const HeadArgs& a, long m) {
  const int b = static_cast<int>(m / a.t_len);
  const int t = static_cast<int>(m % a.t_len);
  return a.pack[static_cast<long>(t) * a.pack_cols + a.tgt_off + b];
}

__device__ __forceinline__ bool valid_row(const HeadArgs& a, long m) {
  const int t = static_cast<int>(m % a.t_len);
  return t >= a.rf - 1 && t < a.t_len - 1;
}

// A (K, N) weight as the products take it (rounded to bf16 unless PACKED,
// transposed with TRANS) staged in shared memory at *next (advanced), or
// its prepared copy in global memory when the plan keeps it there.
template <bool ROUND, bool TRANS>
__device__ __forceinline__ const float* stage(const float* w, int K, int N,
                                              int in_smem,
                                              const float* prepared,
                                              float*& next) {
  if (!in_smem) return prepared;
  float* dst = next;
  for (int i = threadIdx.x; i < K * N; i += kThreads) {
    const float v = operand<ROUND>(w[i]);
    if (TRANS)
      dst[(i % N) * K + i / N] = v;
    else
      dst[i] = v;
  }
  next += K * N;
  return dst;
}

// The weights as the products read them: w1 (S*C) | w1t (C*S) | w2 (C*C) |
// w2t (C*C), rounded to bf16 unless PACKED.
template <bool PACKED>
__global__ void __launch_bounds__(kThreads)
    head_prep_kernel(const float* w1, const float* w2, int s, int c,
                     float* out) {
  constexpr bool ROUND = !PACKED;
  float* o1 = out;
  float* o1t = o1 + s * c;
  float* o2 = o1t + s * c;
  float* o2t = o2 + c * c;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < s * c; i += stride) {
    const int k = i / c, j = i % c;
    const float v = operand<ROUND>(w1[i]);
    o1[i] = v;
    o1t[j * s + k] = v;
  }
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < c * c; i += stride) {
    const int k = i / c, j = i % c;
    const float v = operand<ROUND>(w2[i]);
    o2[i] = v;
    o2t[j * c + k] = v;
  }
}

// SMEM: the plan holds everything in shared memory at 64 rows (S, C <=
// 64, and the forward at C = 128), so every product operand is known to
// lie in shared memory; otherwise pointers may lead to global memory.
template <bool PACKED, bool SMEM>
__global__ void __launch_bounds__(kThreads) head_fwd_kernel(HeadArgs a) {
  constexpr bool ROUND = !PACKED;
  const int S = a.s, C = a.c, lds = S + 4, ldc = C + 4;
  const int RT = SMEM ? kMaxRows : a.plan.rows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* act = reinterpret_cast<float*>(smem);   // (RT, lds)
  float* ly = act + RT * lds;                     // (RT, ldc)
  float* z = ly + RT * ldc;                       // (RT, ldc)
  float* b1 = z + RT * ldc;
  float* b2 = b1 + C;
  float* next = b2 + C;
  const int tid = threadIdx.x;
  const float* w1 =
      stage<ROUND, false>(a.w1_in, S, C, SMEM || a.plan.w1, a.w1, next);
  const float* w2 =
      stage<ROUND, false>(a.w2_in, C, C, SMEM || a.plan.w2, a.w2, next);
  for (int i = tid; i < C; i += kThreads) {
    b1[i] = a.b1[i];
    b2[i] = a.b2[i];
  }
  const bool save_p = !PACKED && a.p_out != nullptr;
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi_raw = lo + a.rows_per_block;
  const long hi = hi_raw < a.m_total ? hi_raw : a.m_total;
  float loss = 0.f, match = 0.f;   // per row-thread, over the block
  for (long m0 = lo; m0 < hi; m0 += RT) {
    __syncthreads();
    for (int i = tid; i < RT * S; i += kThreads) {
      const int r = i / S, k = i % S;
      const long m = m0 + r;
      act[r * lds + k] =
          m < hi ? operand<ROUND>(leaky(bf2f(a.skip[m * S + k]))) : 0.f;
    }
    __syncthreads();
    tile_product<false>(act, lds, w1, S, C, [&](int r, int c, float v) {
      ly[r * ldc + c] = operand<ROUND>(leaky(v + b1[c]));
    }, RT);
    __syncthreads();
    tile_product<false>(ly, ldc, w2, C, C, [&](int r, int c, float v) {
      z[r * ldc + c] = v + b2[c];
    }, RT);
    __syncthreads();
    if (tid < RT && m0 + tid < hi) {
      const long m = m0 + tid;
      bool hit;
      // p replaces z in shared memory for a coalesced store
      const float nll = row_nll(z + tid * ldc, C, target_of(a, m), a.parity,
                                save_p, &hit);
      if (valid_row(a, m)) {
        loss += nll;
        match += hit ? 1.f : 0.f;
      }
    }
    if (save_p) {
      __syncthreads();
      for (int i = tid; i < RT * C; i += kThreads) {
        const int r = i / C, c = i % C;
        if (m0 + r < hi) a.p_out[(m0 + r) * C + c] = z[r * ldc + c];
      }
    }
  }
  // block sums, in row-thread order
  __syncthreads();
  if (tid < RT) {
    act[tid] = loss;
    act[RT + tid] = match;
  }
  __syncthreads();
  if (tid == 0) {
    float sl = 0.f, sm = 0.f;
    for (int r = 0; r < RT; ++r) {
      sl += act[r];
      sm += act[RT + r];
    }
    a.part[2 * blockIdx.x] = sl;
    a.part[2 * blockIdx.x + 1] = sm;
  }
}

// The unpacked backward where S, C <= 64: the weights, every tile
// (rounded dz and dy in tiles of their own) and the weight-gradient sums
// in shared memory at 64 rows.  At these widths it runs faster on the
// H100 than the general kernel below in its all-shared-memory form.
__global__ void __launch_bounds__(kThreads)
    head_bwd_small_kernel(HeadArgs a) {
  constexpr int kRows = kMaxRows;
  const int S = a.s, C = a.c, lds = S + 4, ldc = C + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w1 = reinterpret_cast<float*>(smem);   // (S, C) rounded
  float* w1t = w1 + S * C;                        // (C, S) rounded W1^T
  float* w2t = w1t + C * S;                       // (C, C) rounded W2^T
  float* b1 = w2t + C * C;
  float* lsk = b1 + C;                            // (kRows, lds)
  float* ys = lsk + kRows * lds;                  // (kRows, ldc) y
  float* ly = ys + kRows * ldc;                   // (kRows, ldc) rnd(leaky y)
  float* dz = ly + kRows * ldc;                   // (kRows, ldc)
  float* dzr = dz + kRows * ldc;                  // (kRows, ldc) rnd(dz)
  float* dy = dzr + kRows * ldc;                  // (kRows, ldc)
  float* dyr = dy + kRows * ldc;                  // (kRows, ldc) rnd(dy)
  float* gw1 = dyr + kRows * ldc;                 // (S, C)
  float* gw2 = gw1 + S * C;                       // (C, C)
  const int tid = threadIdx.x;
  for (int i = tid; i < S * C; i += kThreads) {
    const int k = i / C, c = i % C;
    w1[i] = rnd(a.w1_in[i]);
    w1t[c * S + k] = w1[i];
    gw1[i] = 0.f;
  }
  for (int i = tid; i < C * C; i += kThreads) {
    const int k = i / C, c = i % C;
    w2t[c * C + k] = rnd(a.w2_in[i]);
    gw2[i] = 0.f;
  }
  for (int i = tid; i < C; i += kThreads) b1[i] = a.b1[i];
  const float dloss = a.dloss[0];
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi_raw = lo + a.rows_per_block;
  const long hi = hi_raw < a.m_total ? hi_raw : a.m_total;
  float gb = 0.f;   // db2 (threads [0, C)) or db1 (threads [C, 2C))
  for (long m0 = lo; m0 < hi; m0 += kRows) {
    const int rows = static_cast<int>(hi - m0 < kRows ? hi - m0 : kRows);
    __syncthreads();
    for (int i = tid; i < kRows * S; i += kThreads) {
      const int r = i / S, k = i % S;
      const long m = m0 + r;
      lsk[r * lds + k] = r < rows ? rnd(leaky(bf2f(a.skip[m * S + k]))) : 0.f;
    }
    __syncthreads();
    tile_product<false>(lsk, lds, w1, S, C, [&](int r, int c, float v) {
      const float y = v + b1[c];
      ys[r * ldc + c] = y;
      ly[r * ldc + c] = rnd(leaky(y));
    });
    // dz from the saved softmax, one thread per row
    if (tid < kRows) {
      float* dr = dz + tid * ldc;
      float* drr = dzr + tid * ldc;
      if (tid < rows) {
        const long m = m0 + tid;
        const float* p = a.p_in + m * C;
        const int tgt = target_of(a, m);
        row_dz(p, C, tgt, valid_row(a, m) ? dloss : 0.f, a.parity, dr);
        for (int c = 0; c < C; ++c) drr[c] = rnd(dr[c]);
      } else {
        for (int c = 0; c < C; ++c) dr[c] = drr[c] = 0.f;
      }
    }
    __syncthreads();
    if (tid < C)
      for (int r = 0; r < rows; ++r) gb += dz[r * ldc + tid];
    tile_wgrad(ly, ldc, dzr, ldc, C, C, rows, gw2);
    tile_product<false>(dzr, ldc, w2t, C, C, [&](int r, int c, float v) {
      const float d = v * dleaky(ys[r * ldc + c]);
      dy[r * ldc + c] = d;
      dyr[r * ldc + c] = rnd(d);
    });
    __syncthreads();
    if (tid >= C && tid < 2 * C)
      for (int r = 0; r < rows; ++r) gb += dy[r * ldc + tid - C];
    tile_wgrad(lsk, lds, dyr, ldc, S, C, rows, gw1);
    tile_product<false>(dyr, ldc, w1t, C, S, [&](int r, int k, float v) {
      // leaky(skip) and skip have the same sign
      if (r < rows)
        a.dskip[(m0 + r) * S + k] = f2bf(v * dleaky(lsk[r * lds + k]));
    });
  }
  __syncthreads();
  // partial: dw1 (S*C) | db1 (C) | dw2 (C*C) | db2 (C)
  float* out = a.part + static_cast<long>(blockIdx.x) * (S * C + C * C + 2 * C);
  for (int i = tid; i < S * C; i += kThreads) out[i] = gw1[i];
  for (int i = tid; i < C * C; i += kThreads) out[S * C + C + i] = gw2[i];
  if (tid < C) out[S * C + C + C * C + tid] = gb;
  if (tid >= C && tid < 2 * C) out[S * C + tid - C] = gb;
}

template <bool PACKED, bool SMEM>
__global__ void __launch_bounds__(kThreads) head_bwd_kernel(HeadArgs a) {
  constexpr bool ROUND = !PACKED;
  const int S = a.s, C = a.c, lds = S + 4, ldc = C + 4;
  const int RT = SMEM ? kMaxRows : a.plan.rows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* next = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const float* w1 =
      stage<ROUND, false>(a.w1_in, S, C, SMEM || a.plan.w1, a.w1, next);
  const float* w1t =
      stage<ROUND, true>(a.w1_in, S, C, SMEM || a.plan.w1t, a.w1t, next);
  const float* w2t =
      stage<ROUND, true>(a.w2_in, C, C, SMEM || a.plan.w2t, a.w2t, next);
  const float* w2 = PACKED ? stage<ROUND, false>(a.w2_in, C, C,
                                                 SMEM || a.plan.w2, a.w2,
                                                 next)
                           : nullptr;
  float* b1 = next;
  float* b2 = b1 + C;                             // (packed only)
  float* lsk = b2 + (PACKED ? C : 0);             // (RT, lds) leaky(skip)
  float* ys = lsk + RT * lds;                     // (RT, ldc) y
  float* ly = ys + RT * ldc;                      // (RT, ldc) leaky(y)
  float* dz = ly + RT * ldc;                      // (RT, ldc) (z, p,) dz
  float* dy = dz + RT * ldc;                      // (RT, ldc)
  next = dy + RT * ldc;
  // partial: dw1 (S*C) | db1 (C) | dw2 (C*C) | db2 (C)
  float* out = a.part + static_cast<long>(blockIdx.x) * (S * C + C * C + 2 * C);
  float* gw1 = out;
  float* gw2 = out + S * C + C;
  if (SMEM || a.plan.gw1) {
    gw1 = next;
    next += S * C;
  }
  if (SMEM || a.plan.gw2) {
    gw2 = next;
    next += C * C;
  }
  for (int i = tid; i < S * C; i += kThreads) gw1[i] = 0.f;
  for (int i = tid; i < C * C; i += kThreads) gw2[i] = 0.f;
  for (int i = tid; i < C; i += kThreads) {
    b1[i] = a.b1[i];
    if (PACKED) b2[i] = a.b2[i];
  }
  const float dloss = a.dloss[0];
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi_raw = lo + a.rows_per_block;
  const long hi = hi_raw < a.m_total ? hi_raw : a.m_total;
  float gb1 = 0.f, gb2 = 0.f;   // db1, db2 of one column each
  for (long m0 = lo; m0 < hi; m0 += RT) {
    const int rows = static_cast<int>(hi - m0 < RT ? hi - m0 : RT);
    __syncthreads();
    for (int i = tid; i < RT * S; i += kThreads) {
      const int r = i / S, k = i % S;
      const long m = m0 + r;
      lsk[r * lds + k] =
          r < rows ? operand<ROUND>(leaky(bf2f(a.skip[m * S + k]))) : 0.f;
    }
    __syncthreads();
    tile_product<false>(lsk, lds, w1, S, C, [&](int r, int c, float v) {
      const float y = v + b1[c];
      ys[r * ldc + c] = y;
      ly[r * ldc + c] = operand<ROUND>(leaky(y));
    }, RT);
    if (PACKED) {
      // z rebuilt, then its softmax in place, then dz in place
      __syncthreads();
      tile_product<false>(ly, ldc, w2, C, C, [&](int r, int c, float v) {
        dz[r * ldc + c] = v + b2[c];
      }, RT);
      __syncthreads();
    }
    // dz, one thread per row (unpacked: from the saved softmax)
    if (tid < RT) {
      float* dr = dz + tid * ldc;
      if (tid < rows) {
        const long m = m0 + tid;
        const float scale = valid_row(a, m) ? dloss : 0.f;
        if (PACKED) {
          row_softmax(dr, C);
          row_dz(dr, C, target_of(a, m), scale, a.parity, dr);
        } else {
          row_dz(a.p_in + m * C, C, target_of(a, m), scale, a.parity, dr);
        }
      } else {
        for (int c = 0; c < C; ++c) dr[c] = 0.f;
      }
    }
    __syncthreads();
    // db2 from dz in float32 (one thread per column), then dz rounded in
    // place as a product operand
    if (tid < C)
      for (int r = 0; r < rows; ++r) {
        const float v = dz[r * ldc + tid];
        gb2 += v;
        if (ROUND) dz[r * ldc + tid] = operand<ROUND>(v);
      }
    if (ROUND) __syncthreads();
    tile_wgrad(ly, ldc, dz, ldc, C, C, rows, gw2);
    tile_product<false>(dz, ldc, w2t, C, C, [&](int r, int c, float v) {
      dy[r * ldc + c] = v * dleaky(ys[r * ldc + c]);
    }, RT);
    __syncthreads();
    // db1 the same way, on the threads after db2's where there are enough
    const int c1 = 2 * C <= kThreads ? tid - C : tid;
    if (c1 >= 0 && c1 < C)
      for (int r = 0; r < rows; ++r) {
        const float v = dy[r * ldc + c1];
        gb1 += v;
        if (ROUND) dy[r * ldc + c1] = operand<ROUND>(v);
      }
    if (ROUND) __syncthreads();
    tile_wgrad(lsk, lds, dy, ldc, S, C, rows, gw1);
    tile_product<false>(dy, ldc, w1t, C, S, [&](int r, int k, float v) {
      // leaky(skip) and skip have the same sign
      if (r < rows)
        a.dskip[(m0 + r) * S + k] = f2bf(v * dleaky(lsk[r * lds + k]));
    }, RT);
  }
  __syncthreads();
  if (SMEM || a.plan.gw1)
    for (int i = tid; i < S * C; i += kThreads) out[i] = gw1[i];
  if (SMEM || a.plan.gw2)
    for (int i = tid; i < C * C; i += kThreads) out[S * C + C + i] = gw2[i];
  if (tid < C) out[S * C + C + C * C + tid] = gb2;
  const int c1 = 2 * C <= kThreads ? tid - C : tid;
  if (c1 >= 0 && c1 < C) out[S * C + c1] = gb1;
}

__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* part, float* out, long n_el, int n_parts) {
  for (long e = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x;
       e < n_el; e += static_cast<long>(gridDim.x) * kThreads) {
    float s = 0.f;
    for (int c = 0; c < n_parts; ++c) s += part[c * n_el + e];
    out[e] = s;
  }
}

// Adds an optional item of n floats to the plan if it still fits.
int fit(HeadPlan* p, long n) {
  const size_t b = static_cast<size_t>(n) * 4;
  if (p->bytes + b > kSmemLimit) return 0;
  p->bytes += b;
  return 1;
}

// The shared-memory plan of one kernel (see the file comment); rows 0 if
// no tile fits.
HeadPlan make_plan(int s, int c, bool bwd, bool packed) {
  HeadPlan p = {};
  const long tiles = bwd ? 4 : 2;
  for (int rows = kMaxRows; rows >= 16; rows /= 2) {
    const size_t base =
        static_cast<size_t>(rows * (s + 4) + tiles * rows * (c + 4) + 2 * c) *
        4;
    if (base <= kSmemLimit) {
      p.rows = rows;
      p.bytes = base;
      break;
    }
  }
  if (!p.rows) return p;
  if (bwd) {
    p.gw1 = fit(&p, static_cast<long>(s) * c);
    p.gw2 = fit(&p, static_cast<long>(c) * c);
    p.w1 = fit(&p, static_cast<long>(s) * c);
    p.w1t = fit(&p, static_cast<long>(s) * c);
    p.w2t = fit(&p, static_cast<long>(c) * c);
    if (packed) p.w2 = fit(&p, static_cast<long>(c) * c);
  } else {
    p.w1 = fit(&p, static_cast<long>(s) * c);
    p.w2 = fit(&p, static_cast<long>(c) * c);
  }
  return p;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// The prepared weights in wbuf (2*S*C + 2*C*C floats) and the arguments
// both kernels share.
int prepare(HeadArgs* a, const bf16_t* skip, const int* pack, int pack_cols,
            int tgt_off, const float* w1, const float* b1, const float* w2,
            const float* b2, float* wbuf, long m_total, int blocks, int t_len,
            int s, int c, int rf, int parity, int packed, bool bwd,
            float* part, cudaStream_t st) {
  *a = HeadArgs{};
  const HeadPlan p = make_plan(s, c, bwd, packed != 0);
  a->plan = p;
  if (!p.rows) return static_cast<int>(cudaErrorInvalidValue);
  // the prepared copies, only where a weight stays in global memory
  const bool global_w = bwd ? !p.w1 || !p.w1t || !p.w2t || (packed && !p.w2)
                            : !p.w1 || !p.w2;
  if (global_w) {
    const int grid = (c * c + kThreads - 1) / kThreads;
    if (packed)
      head_prep_kernel<true><<<grid, kThreads, 0, st>>>(w1, w2, s, c, wbuf);
    else
      head_prep_kernel<false><<<grid, kThreads, 0, st>>>(w1, w2, s, c, wbuf);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  a->skip = skip;
  a->w1_in = w1;
  a->w2_in = w2;
  a->pack = pack;
  a->pack_cols = pack_cols;
  a->tgt_off = tgt_off;
  a->w1 = wbuf;
  a->w1t = wbuf + s * c;
  a->w2 = wbuf + 2 * s * c;
  a->w2t = wbuf + 2 * s * c + c * c;
  a->b1 = b1;
  a->b2 = b2;
  a->m_total = m_total;
  const long per = (m_total + blocks - 1) / blocks;
  const int rt = a->plan.rows;
  a->rows_per_block = ((per + rt - 1) / rt) * rt;
  a->t_len = t_len;
  a->s = s;
  a->c = c;
  a->rf = rf;
  a->parity = parity;
  a->part = part;
  return 0;
}

// Whether the plan keeps everything in shared memory at 64 rows (the
// kernels' SMEM form).
bool all_smem(const HeadPlan& p, bool bwd, bool packed) {
  if (p.rows != kMaxRows || !p.w1) return false;
  if (!bwd) return p.w2;
  return p.gw1 && p.gw2 && p.w1t && p.w2t && (!packed || p.w2);
}

// Shared memory of head_bwd_small_kernel, or 0 where S or C exceed 64 or
// it does not fit.
size_t small_bwd_smem(int s, int c) {
  const size_t n = static_cast<size_t>(2 * s * c + c * c + c +
                                       kMaxRows * (s + 4) +
                                       6 * kMaxRows * (c + 4) + s * c +
                                       c * c) * 4;
  return s <= kMaxRows && c <= kMaxRows && n <= kSmemLimit ? n : 0;
}

template <typename K>
int launch(K kernel, const HeadArgs& a, int blocks, cudaStream_t st) {
  int err = set_smem(reinterpret_cast<const void*>(kernel), a.plan.bytes);
  if (err) return err;
  kernel<<<blocks, kThreads, a.plan.bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// 1 if the kernels take skip width s and c classes
int movenet_head_supports(int s, int c) {
  return s >= 4 && c >= 4 && s % 4 == 0 && c % 4 == 0 && s <= 64 &&
         c <= kMaxC && make_plan(s, c, true, true).rows > 0 &&
         make_plan(s, c, false, false).rows > 0;
}

// Floats of the prepared-weight scratch (wbuf) both entries take.
long movenet_head_wbuf(int s, int c) {
  return 2L * s * c + 2L * c * c;
}

// Forward: out[0] = loss sum, out[1] = match count; p_out may be null (and
// is, with packed).  part holds `blocks` x 2 floats.
int movenet_head_fwd(const bf16_t* skip, const int* pack, int pack_cols,
                     int tgt_off, const float* w1, const float* b1,
                     const float* w2, const float* b2, float* p_out,
                     float* wbuf, float* part, float* out, int batch,
                     int t_len, int s, int c, int rf, int parity, int packed,
                     int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  HeadArgs a;
  int err = prepare(&a, skip, pack, pack_cols, tgt_off, w1, b1, w2, b2, wbuf,
                    static_cast<long>(batch) * t_len, blocks, t_len, s, c,
                    rf, parity, packed, false, part, st);
  if (err) return err;
  a.p_out = packed ? nullptr : p_out;
  const bool sm = all_smem(a.plan, false, packed != 0);
  if (packed)
    err = sm ? launch(head_fwd_kernel<true, true>, a, blocks, st)
             : launch(head_fwd_kernel<true, false>, a, blocks, st);
  else
    err = sm ? launch(head_fwd_kernel<false, true>, a, blocks, st)
             : launch(head_fwd_kernel<false, false>, a, blocks, st);
  if (err) return err;
  reduce_kernel<<<1, kThreads, 0, st>>>(part, out, 2, blocks);
  return static_cast<int>(cudaGetLastError());
}

// Backward: grads = dw1 (S*C) | db1 (C) | dw2 (C*C) | db2 (C); part holds
// `blocks` x that many floats.  p_in is the forward's softmax (unpacked)
// or null (packed: rebuilt from skip).
int movenet_head_bwd(const bf16_t* skip, const int* pack, int pack_cols,
                     int tgt_off, const float* p_in, const float* w1,
                     const float* b1, const float* w2, const float* b2,
                     const float* dloss, bf16_t* dskip, float* wbuf,
                     float* part, float* grads, int batch, int t_len, int s,
                     int c, int rf, int parity, int packed, int blocks,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  HeadArgs a;
  int err = prepare(&a, skip, pack, pack_cols, tgt_off, w1, b1, w2, b2, wbuf,
                    static_cast<long>(batch) * t_len, blocks, t_len, s, c,
                    rf, parity, packed, true, part, st);
  if (err) return err;
  a.p_in = p_in;
  a.dloss = dloss;
  a.dskip = dskip;
  if (!packed && !p_in) return static_cast<int>(cudaErrorInvalidValue);
  const size_t small = packed ? 0 : small_bwd_smem(s, c);
  if (small) {
    a.plan.bytes = small;
    err = launch(head_bwd_small_kernel, a, blocks, st);
  } else if (packed) {
    err = all_smem(a.plan, true, true)
              ? launch(head_bwd_kernel<true, true>, a, blocks, st)
              : launch(head_bwd_kernel<true, false>, a, blocks, st);
  } else {
    err = launch(head_bwd_kernel<false, false>, a, blocks, st);
  }
  if (err) return err;
  const long n_el = static_cast<long>(s) * c + c * c + 2 * c;
  reduce_kernel<<<static_cast<int>((n_el + kThreads - 1) / kThreads), kThreads,
                  0, st>>>(part, grads, n_el, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
