// Output head + cross-entropy building blocks of stack_kernel.cu's merged
// trunk + head kernels (head_loss.cu takes only leaky and kHeadThreads
// from here: its kernels run on the tensor cores).  A block of
// kHeadThreads threads works on tiles of kHeadRows rows (or fewer, as the
// caller's shared-memory plan gives) held in shared memory; each product
// is a sequence of fmaf in float32 over a 4x4 register tile per thread.
#pragma once

#include <cuda_bf16.h>

namespace head_core {

constexpr int kHeadRows = 64;
constexpr int kHeadThreads = 256;

__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float leaky(float x) {
  return x > 0.f ? x : 0.01f * x;
}
__device__ __forceinline__ float dleaky(float x) {
  return x > 0.f ? 1.f : 0.01f;
}
// out[r, n] = sum_k A[r, k] B[k, n] over a tile of `rows` rows (a multiple
// of 4): A row-major with stride lda, B row-major (K, N), in shared or
// global memory.  ROUND rounds both operands to bf16 as they load (a
// product on compute-dtype operands, the TPU's _mdot).  Returns through
// fn(row, col, value).
template <bool ROUND, typename Fn>
__device__ __forceinline__ void tile_product(const float* A, int lda,
                                             const float* B, int K, int N,
                                             Fn fn, int rows = kHeadRows) {
  const int nc = N / 4;
  for (int tile = threadIdx.x; tile < (rows / 4) * nc;
       tile += kHeadThreads) {
    const int r0 = (tile / nc) * 4, c0 = (tile % nc) * 4;
    float acc[4][4] = {};
    for (int k = 0; k < K; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(B + k * N + c0);
      float bj[4] = {bv.x, bv.y, bv.z, bv.w};
      if (ROUND) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bj[j] = rnd(bj[j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = ROUND ? rnd(A[(r0 + i) * lda + k])
                               : A[(r0 + i) * lda + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bj[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) fn(r0 + i, c0 + j, acc[i][j]);
  }
}

// acc[k, n] += sum_r A[r, k] B[r, n] over the tile's rows (A, B row-major
// with strides lda, ldb); acc (K, N) in shared or global memory, each 4x4
// block owned by one thread (the same one on every call, so a block's
// partial sums in global memory need no barrier).
__device__ __forceinline__ void tile_wgrad(const float* A, int lda,
                                           const float* B, int ldb, int K,
                                           int N, int rows, float* acc) {
  const int nc = N / 4;
  for (int tile = threadIdx.x; tile < (K / 4) * nc; tile += kHeadThreads) {
    const int k0 = (tile / nc) * 4, c0 = (tile % nc) * 4;
    float s[4][4] = {};
    for (int r = 0; r < rows; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(A + r * lda + k0);
      const float4 bv = *reinterpret_cast<const float4*>(B + r * ldb + c0);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(ai[i], bj[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[(k0 + i) * N + c0 + j] += s[i][j];
  }
}

// The cross-entropy of one row of logits zr (C values): returns the NLL
// (parity: log sum exp(p) - p[tgt] on p = softmax(z), no max subtraction
// since p lies in [0, 1]; clean: lse(z) - z[tgt]); *hit is whether tgt is
// the first maximal column (jnp.argmax).  With write_p the softmax p
// replaces z in zr.
__device__ __forceinline__ float row_nll(float* zr, int C, int tgt,
                                         bool parity, bool write_p,
                                         bool* hit) {
  float zmax = zr[0];
  int first = 0;
  for (int c = 1; c < C; ++c)
    if (zr[c] > zmax) {
      zmax = zr[c];
      first = c;
    }
  float esum = 0.f;
  for (int c = 0; c < C; ++c) esum += expf(zr[c] - zmax);
  float nll;
  if (parity) {
    float sep = 0.f, picked = 0.f;
    for (int c = 0; c < C; ++c) {
      const float p = expf(zr[c] - zmax) / esum;
      sep += expf(p);
      if (c == tgt) picked = p;
    }
    nll = logf(sep) - picked;
  } else {
    const float picked = (tgt >= 0 && tgt < C) ? zr[tgt] : 0.f;
    nll = logf(esum) + zmax - picked;
  }
  if (write_p)
    for (int c = 0; c < C; ++c) zr[c] = expf(zr[c] - zmax) / esum;
  *hit = first == tgt;
  return nll;
}

// The softmax of one row in place: p = exp(z - max z) / sum, the values
// row_nll's write_p stores.
__device__ __forceinline__ void row_softmax(float* zr, int C) {
  float zmax = zr[0];
  for (int c = 1; c < C; ++c) zmax = zr[c] > zmax ? zr[c] : zmax;
  float esum = 0.f;
  for (int c = 0; c < C; ++c) esum += expf(zr[c] - zmax);
  for (int c = 0; c < C; ++c) zr[c] = expf(zr[c] - zmax) / esum;
}

// dL/dz of one row from its softmax p, times scale (p and dz may be the
// same row): parity p g - p (p.g)
// with g = softmax(p) - onehot(tgt); clean p - onehot(tgt).
__device__ __forceinline__ void row_dz(const float* p, int C, int tgt,
                                       float scale, bool parity, float* dz) {
  if (parity) {
    float es = 0.f;
    for (int c = 0; c < C; ++c) es += expf(p[c]);
    float pg = 0.f;
    for (int c = 0; c < C; ++c) {
      const float g = expf(p[c]) / es - (c == tgt ? 1.f : 0.f);
      pg += p[c] * g;
    }
    for (int c = 0; c < C; ++c) {
      const float g = expf(p[c]) / es - (c == tgt ? 1.f : 0.f);
      dz[c] = (p[c] * g - p[c] * pg) * scale;
    }
  } else {
    for (int c = 0; c < C; ++c)
      dz[c] = (p[c] - (c == tgt ? 1.f : 0.f)) * scale;
  }
}

}  // namespace head_core
