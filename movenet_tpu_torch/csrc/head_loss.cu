// Output head + cross-entropy of the training step, forward and backward.
//
// Replaces the TPU kernels movenet_tpu/ops/pallas/head_loss.py:
//   _fwd_kernel (head_loss.py:281, pallas_call at :541): y = leaky(skip) W1
//     + b1, z = leaky(y) W2 + b2, per-row NLL (parity: log sum exp(p) -
//     p[y] on p = softmax(z); clean: lse(z) - z[y]) and first-argmax
//     matches over the valid rows [RF-1, T-1), summed; p saved in f32;
//   _bwd_kernel (head_loss.py:336, pallas_call at :578): dz from the saved
//     p, the two products backwards, the head weight and bias gradients
//     and dskip (bf16).
// Products take bf16 operands (the skip's dtype) and sum in float32 with
// fmaf; the softmax and the probability algebra are float32.  The tile
// products and the per-row softmax and CE live in head_core.cuh, which
// the merged trunk + head kernels of stack_kernel.cu share.
//
// Design.  The TPU grid runs (batch, time tile) in order and keeps the
// loss, the match count and the weight gradients in scratch across grid
// steps.  Here each block walks a contiguous range of rows in tiles of 64:
// the products run over shared-memory tiles (4x4 register tiles per
// thread), one thread per row does the softmax and the NLL, and the loss,
// match and weight-gradient sums stay in the block until its range ends.
// Each block then writes its partial sums, which a second launch adds in
// a fixed order: deterministic, no atomics.
//
// Bound (breakdancing shape: B*T = 320000 rows, S = C = 64): the forward
// reads skip (41 MB) and writes p (82 MB), 37 us at 3.35 TB/s; the
// backward reads skip and p and writes dskip (164 MB), 49 us.  Its
// 5e9-1.3e10 flop take 5-13 ms at the tensor-core rate, far less than the
// bytes; this version runs them on the f32 units and one thread per row
// for the softmax, so it is bound by instruction rate, not by the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "head_core.cuh"

namespace {

using head_core::dleaky;
using head_core::leaky;
using head_core::rnd;
using head_core::row_dz;
using head_core::row_nll;
using head_core::tile_product;
using head_core::tile_wgrad;

constexpr int kThreads = head_core::kHeadThreads;
constexpr int kRows = head_core::kHeadRows;   // rows per tile
typedef unsigned short bf16_t;

__device__ __forceinline__ float bf2f(bf16_t u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ bf16_t f2bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

struct HeadArgs {
  const bf16_t* skip;   // (M, S)
  const int* pack;      // (T, pack_cols); targets at column tgt_off + b
  int pack_cols, tgt_off;
  const float* w1;      // (S, C)
  const float* b1;      // (C)
  const float* w2;      // (C, C)
  const float* b2;      // (C)
  const float* p_in;    // (M, C) saved softmax (backward)
  float* p_out;         // (M, C) softmax to save, or null (forward)
  const float* dloss;   // (1) gradient of the loss sum (backward)
  bf16_t* dskip;        // (M, S) (backward)
  float* part;          // per-block partial sums
  long m_total, rows_per_block;
  int t_len, s, c, rf, parity;
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

__global__ void __launch_bounds__(kThreads) head_fwd_kernel(HeadArgs a) {
  const int S = a.s, C = a.c, lds = S + 4, ldc = C + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w1 = reinterpret_cast<float*>(smem);   // (S, C) rounded
  float* w2 = w1 + S * C;                         // (C, C) rounded
  float* b1 = w2 + C * C;
  float* b2 = b1 + C;
  float* act = b2 + C;                            // (kRows, lds)
  float* ly = act + kRows * lds;                  // (kRows, ldc)
  float* z = ly + kRows * ldc;                    // (kRows, ldc)
  const int tid = threadIdx.x;
  for (int i = tid; i < S * C; i += kThreads) w1[i] = rnd(a.w1[i]);
  for (int i = tid; i < C * C; i += kThreads) w2[i] = rnd(a.w2[i]);
  for (int i = tid; i < C; i += kThreads) {
    b1[i] = a.b1[i];
    b2[i] = a.b2[i];
  }
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi_raw = lo + a.rows_per_block;
  const long hi = hi_raw < a.m_total ? hi_raw : a.m_total;
  float loss = 0.f, match = 0.f;   // per row-thread, over the block
  for (long m0 = lo; m0 < hi; m0 += kRows) {
    __syncthreads();
    for (int i = tid; i < kRows * S; i += kThreads) {
      const int r = i / S, k = i % S;
      const long m = m0 + r;
      act[r * lds + k] = m < hi ? rnd(leaky(bf2f(a.skip[m * S + k]))) : 0.f;
    }
    __syncthreads();
    tile_product<false>(act, lds, w1, S, C, [&](int r, int c, float v) {
      ly[r * ldc + c] = rnd(leaky(v + b1[c]));
    });
    __syncthreads();
    tile_product<false>(ly, ldc, w2, C, C, [&](int r, int c, float v) {
      z[r * ldc + c] = v + b2[c];
    });
    __syncthreads();
    if (tid < kRows && m0 + tid < hi) {
      const long m = m0 + tid;
      bool hit;
      // p replaces z in shared memory for a coalesced store
      const float nll = row_nll(z + tid * ldc, C, target_of(a, m), a.parity,
                                a.p_out != nullptr, &hit);
      if (valid_row(a, m)) {
        loss += nll;
        match += hit ? 1.f : 0.f;
      }
    }
    if (a.p_out) {
      __syncthreads();
      for (int i = tid; i < kRows * C; i += kThreads) {
        const int r = i / C, c = i % C;
        if (m0 + r < hi) a.p_out[(m0 + r) * C + c] = z[r * ldc + c];
      }
    }
  }
  // block sums, in row-thread order
  __syncthreads();
  if (tid < kRows) {
    act[tid] = loss;
    act[kRows + tid] = match;
  }
  __syncthreads();
  if (tid == 0) {
    float sl = 0.f, sm = 0.f;
    for (int r = 0; r < kRows; ++r) {
      sl += act[r];
      sm += act[kRows + r];
    }
    a.part[2 * blockIdx.x] = sl;
    a.part[2 * blockIdx.x + 1] = sm;
  }
}

__global__ void __launch_bounds__(kThreads) head_bwd_kernel(HeadArgs a) {
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
    w1[i] = rnd(a.w1[i]);
    w1t[c * S + k] = w1[i];
    gw1[i] = 0.f;
  }
  for (int i = tid; i < C * C; i += kThreads) {
    const int k = i / C, c = i % C;
    w2t[c * C + k] = rnd(a.w2[i]);
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

__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* part, float* out, long n_el, int n_parts) {
  for (long e = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x;
       e < n_el; e += static_cast<long>(gridDim.x) * kThreads) {
    float s = 0.f;
    for (int c = 0; c < n_parts; ++c) s += part[c * n_el + e];
    out[e] = s;
  }
}

size_t fwd_smem(int s, int c) {
  return static_cast<size_t>(s * c + c * c + 2 * c + kRows * (s + 4) +
                             2 * kRows * (c + 4)) * 4;
}

size_t bwd_smem(int s, int c) {
  return static_cast<size_t>(2 * s * c + c * c + c + kRows * (s + 4) +
                             6 * kRows * (c + 4) + s * c + c * c) * 4;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

HeadArgs make_args(const bf16_t* skip, const int* pack, int pack_cols,
                   int tgt_off, const float* w1, const float* b1,
                   const float* w2, const float* b2, long m_total,
                   int blocks, int t_len, int s, int c, int rf, int parity,
                   float* part) {
  HeadArgs a = {};
  a.skip = skip;
  a.pack = pack;
  a.pack_cols = pack_cols;
  a.tgt_off = tgt_off;
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.b2 = b2;
  a.m_total = m_total;
  const long per = (m_total + blocks - 1) / blocks;
  a.rows_per_block = ((per + kRows - 1) / kRows) * kRows;
  a.t_len = t_len;
  a.s = s;
  a.c = c;
  a.rf = rf;
  a.parity = parity;
  a.part = part;
  return a;
}

}  // namespace

extern "C" {

// 1 if the kernels take skip width s and c classes
int movenet_head_supports(int s, int c) {
  return s >= 4 && c >= 4 && s % 4 == 0 && c % 4 == 0 && s <= 64 &&
         c <= 64 && bwd_smem(s, c) <= 227 * 1024;
}

// Forward: out[0] = loss sum, out[1] = match count; p_out may be null.
// part holds `blocks` x 2 floats.
int movenet_head_fwd(const bf16_t* skip, const int* pack, int pack_cols,
                     int tgt_off, const float* w1, const float* b1,
                     const float* w2, const float* b2, float* p_out,
                     float* part, float* out, int batch, int t_len, int s,
                     int c, int rf, int parity, int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  HeadArgs a = make_args(skip, pack, pack_cols, tgt_off, w1, b1, w2, b2,
                         static_cast<long>(batch) * t_len, blocks, t_len, s,
                         c, rf, parity, part);
  a.p_out = p_out;
  const size_t smem = fwd_smem(s, c);
  int err = set_smem(reinterpret_cast<const void*>(head_fwd_kernel), smem);
  if (err) return err;
  head_fwd_kernel<<<blocks, kThreads, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_kernel<<<1, kThreads, 0, st>>>(part, out, 2, blocks);
  return static_cast<int>(cudaGetLastError());
}

// Backward: grads = dw1 (S*C) | db1 (C) | dw2 (C*C) | db2 (C); part holds
// `blocks` x that many floats.
int movenet_head_bwd(const bf16_t* skip, const int* pack, int pack_cols,
                     int tgt_off, const float* p_in, const float* w1,
                     const float* b1, const float* w2, const float* dloss,
                     bf16_t* dskip, float* part, float* grads, int batch,
                     int t_len, int s, int c, int rf, int parity, int blocks,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  HeadArgs a = make_args(skip, pack, pack_cols, tgt_off, w1, b1, w2, nullptr,
                         static_cast<long>(batch) * t_len, blocks, t_len, s,
                         c, rf, parity, part);
  a.p_in = p_in;
  a.dloss = dloss;
  a.dskip = dskip;
  const size_t smem = bwd_smem(s, c);
  int err = set_smem(reinterpret_cast<const void*>(head_bwd_kernel), smem);
  if (err) return err;
  head_bwd_kernel<<<blocks, kThreads, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long n_el = static_cast<long>(s) * c + c * c + 2 * c;
  reduce_kernel<<<static_cast<int>((n_el + kThreads - 1) / kThreads), kThreads,
                  0, st>>>(part, grads, n_el, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
