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
//     positions per 128 lanes is a layout of that chip; here they are
//     head_fwd_packed_kernel and head_bwd_packed_kernel, fmaf over
//     shared-memory tiles (head_core.cuh, shared with the merged trunk +
//     head kernels of stack_kernel.cu).
//
// The unpacked kernels (head_fwd_kernel<NT>, head_bwd_kernel<NT, KS>,
// head_wgrad_kernel; 4 <= S <= 64, 4 <= C <= 256, multiples of 4).  Every
// product takes bf16 operands, as the TPU's _mdot does: leaky(skip),
// leaky(y), dz, dy, W1 and W2 rounded to bf16.  Products of bf16 values
// are exact in float32, so they run on the tensor cores as mma.sync
// m16n8k16 with float32 sums: only the order of the sums differs from the
// plain version.  A sum that is rounded to bf16 again (the backward's y
// and dy, dskip) or summed over many rows (the weight gradients) takes
// each 16-wide k step from zero and adds it in float32 (mma_bf16_add),
// which truncates less than the tensor core's own accumulation; z, which
// only the softmax reads, accumulates in the tensor core (mma_bf16).  One
// product is the exception: the forward's y = leaky(skip) W1 (S*C of the
// S*C + C*C products a row) is the plain version's own chain of fmaf
// (y_seq), since the p it saves is held to 2e-4 of the plain version's
// and a y an ulp away flips the bf16 operand leaky(y) (on the H100 the
// tensor-core order flipped 107 of 1.28 M and moved p by up to 1.5e-3).
// y, z, the softmax and the probability algebra are float32; db2 and db1
// are summed from the unrounded dz and dy.
//
// Design.  A block of 8 warps stages W1 and W2 once as bf16 in shared
// memory (zero-padded to SP, CP: multiples of 16; the padding is exact
// and kept out of the row max, the exp sum and the argmax), each as the
// B fragments of its product read it: two k values per 32-bit word.  Each
// warp then walks 16-row slabs of the block's row range.  Forward: y is
// formed 16 columns at a time from the warp's slab of leaky(skip) in
// shared memory, in the C fragment layout; leaky and rounded, it is the A
// fragment of the next k step of z = leaky(y) W2, so leaky(y) never
// leaves registers; z (NT n tiles of 8 columns, NT*4 registers a
// lane) stays in registers.  Each row of z lies in one quad of lanes, so
// its max, first argmax, exp sum and NLL are quad shuffles; p is stored
// from the fragments, each row's 8 columns a whole 32-byte sector.
// Backward: p is read coalesced the same way into the fragment layout,
// dz formed with quad sums; dy = dz_r W2^T runs in chunks of 64 columns
// whose rounded dy_r feeds dskip = dy_r W1^T at once; dleaky(y) is kept as
// one bit per element from the recomputed y.  The column sums (db2, db1)
// over the slab's 16 rows are shuffle trees over the lanes of a column,
// added into per-warp rows of shared memory.  Each row's elementwise work
// multiplies by one reciprocal of its sum: an IEEE division per element
// would put a branch in the unrolled code.  dW2 = ly^T dz_r and dW1 =
// lskip^T dy_r sum over all rows and do not fit a block at C = 256 (256
// KB of float32), so the backward stores ly, dz_r and dy_r (bf16, (M, CP);
// stmatrix, then 16-byte stores) and head_wgrad_kernel runs them as a
// split-K GEMM: one block per 64x64 output tile and row range,
// ldmatrix.trans fragments from shared memory.  Every block writes its
// partial sums, which reduce_kernel adds in a fixed order: deterministic,
// no atomics.
//
// Bound (the larger of bytes over 3.35 TB/s and bf16 operations over 989
// TF/s).  Forward: skip read, p written (4C bytes a row): 0.038 ms at the
// breakdancing shape (B*T = 320000, S = C = 64), 0.077 at (8, 128, B = 3).
// Backward: skip and p read, dskip written: 0.050 and 0.080 ms.  Beside
// these the backward moves ly, dz_r and dy_r (6 CP bytes a row written,
// read again by the weight-gradient GEMM: 1.5x the p bytes at C = 128)
// and the forward and backward stage the weights once per block.  The
// packed form moves no p, so float32 operations bound it (about 5.2e9
// forward and 1.6e10 backward, 0.08 and 0.23 ms at 67 TF/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "head_core.cuh"
#include "mma_bf16.cuh"


namespace {

using head_core::dleaky;
using head_core::leaky;
using head_core::row_dz;
using head_core::row_nll;
using head_core::row_softmax;
using head_core::tile_product;
using head_core::tile_wgrad;

constexpr int kThreads = head_core::kHeadThreads;   // 256: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = head_core::kHeadRows;      // packed row tile
// shared memory one block may use on sm_90
constexpr size_t kSmemLimit = 232448;
// the weight-gradient GEMM: 4 warps, 64x64 output tiles, 32-row stages
constexpr int kWgThreads = 128;
constexpr int kWgTile = 64;
constexpr int kWgRows = 32;
constexpr int kWgLd = kWgTile + 8;
typedef unsigned short bf16_t;

__device__ __forceinline__ float bf2f(bf16_t u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ bf16_t f2bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}
// lo, hi rounded to bf16 in one word (lo in the low half)
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return static_cast<unsigned>(f2bf(lo)) |
         (static_cast<unsigned>(f2bf(hi)) << 16);
}
__device__ __forceinline__ unsigned ld32(const bf16_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}
__device__ __forceinline__ void st32(bf16_t* p, unsigned v) {
  *reinterpret_cast<unsigned*>(p) = v;
}
// leaky of two bf16 values, rounded to bf16
__device__ __forceinline__ unsigned leaky2(unsigned u) {
  return pack2(leaky(bf2f(static_cast<bf16_t>(u & 0xffffu))),
               leaky(bf2f(static_cast<bf16_t>(u >> 16))));
}
// dleaky of a bf16 value given by its bits: 1 above zero
__device__ __forceinline__ float dleaky_bits(unsigned u) {
  return (u & 0xffffu) != 0 && !(u & 0x8000u) ? 1.f : 0.01f;
}
__device__ __forceinline__ long min_l(long x, long y) { return x < y ? x : y; }

struct HeadArgs {
  const bf16_t* skip;   // (M, S)
  const int* pack;      // (T, pack_cols); targets at column tgt_off + b
  int pack_cols, tgt_off;
  const float* w1;      // (S, C)
  const float* w2;      // (C, C)
  const float* b1;      // (C)
  const float* b2;      // (C)
  const float* p_in;    // (M, C) saved softmax (unpacked backward)
  float* p_out;         // (M, C) softmax to save, or null (forward)
  const float* dloss;   // (1) gradient of the loss sum (backward)
  bf16_t* dskip;        // (M, S) (backward)
  bf16_t* ly;           // (M, CP) rnd(leaky(y)) (unpacked backward)
  bf16_t* dzr;          // (M, CP) rnd(dz)
  bf16_t* dyr;          // (M, CP) rnd(dy)
  float* part;          // per-block partial sums
  long m_total, rows_per_block, n_el;
  int t_len, s, c, sp, cp, rf, parity;
};

// Row indices fit 32 bits (B*T < 2^31): 32-bit division.
__device__ __forceinline__ int target_of(const HeadArgs& a, long m) {
  const unsigned mu = static_cast<unsigned>(m), tl = a.t_len;
  const int b = static_cast<int>(mu / tl), t = static_cast<int>(mu % tl);
  return a.pack[static_cast<long>(t) * a.pack_cols + a.tgt_off + b];
}

__device__ __forceinline__ bool valid_row(const HeadArgs& a, long m) {
  const int t = static_cast<int>(static_cast<unsigned>(m) %
                                 static_cast<unsigned>(a.t_len));
  return t >= a.rf - 1 && t < a.t_len - 1;
}

// ------------------------------------------------ unpacked (tensor cores)

// dst[n][k] = w[k][n] rounded to bf16 (w (K, N) float32), rows n < NP of
// ld elements, zero past K and N: the B fragments of x W where the k of
// a lane's pair runs along a row.  Lanes run along n (coalesced reads).
__device__ __forceinline__ void stage_wt(const float* w, int K, int N,
                                         int KP, int NP, bf16_t* dst,
                                         int ld) {
  for (int i = threadIdx.x; i < NP * (KP / 2); i += blockDim.x) {
    const int n = i % NP, k = 2 * (i / NP);
    const float v0 = n < N && k < K ? w[k * N + n] : 0.f;
    const float v1 = n < N && k + 1 < K ? w[(k + 1) * N + n] : 0.f;
    st32(dst + n * ld + k, pack2(v0, v1));
  }
}

// dst[r][k] = w[r][k] rounded to bf16 (w (R, K) float32), rows r < RP of
// ld elements, zero past R and K: the B fragments of x W^T.
__device__ __forceinline__ void stage_w(const float* w, int R, int K, int RP,
                                        int KP, bf16_t* dst, int ld) {
  for (int i = threadIdx.x; i < RP * (KP / 2); i += blockDim.x) {
    const int r = i / (KP / 2), k = 2 * (i % (KP / 2));
    const float v0 = r < R && k < K ? w[r * K + k] : 0.f;
    const float v1 = r < R && k + 1 < K ? w[r * K + k + 1] : 0.f;
    st32(dst + r * ld + k, pack2(v0, v1));
  }
}

// The A fragments of rnd(leaky(skip)) for rows r0 = m0 + g, r1 = r0 + 8:
// k step ks covers columns [16 ks, 16 ks + 16); zero past S and hi.
template <int KS>
__device__ __forceinline__ void lskip_frags(const bf16_t* skip, int S,
                                            long r0, long hi,
                                            unsigned (&as)[KS][4]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long r = r0 + (i & 1) * 8;
      const int col = 16 * ks + 2 * q + (i >> 1) * 8;
      as[ks][i] = r < hi && col < S ? leaky2(ld32(skip + r * S + col)) : 0u;
    }
}

// y (without b1) of the slab's columns [16 kk, 16 kk + 16), two n tiles,
// from W1^T staged as (CP, ld1).
template <int KS>
__device__ __forceinline__ void y_tile(const bf16_t* w1t, int ld1, int kk,
                                       int ks1, const unsigned (&as)[KS][4],
                                       float (&y)[2][4]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[h][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    if (ks < ks1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bf16_t* bp = w1t + (16 * kk + 8 * h + g) * ld1 + 16 * ks + 2 * q;
        const unsigned b[2] = {ld32(bp), ld32(bp + 8)};
        mma_bf16_add(y[h], as[ks], b);
      }
}

// y (without b1) as y_tile lays it out, from the slab's rows lsk (16, ld)
// and W1^T staged as (CP, ld), summed as the plain version's float32
// product sums it (cuBLAS on the card): k in order, one fmaf per term
// from zero.  leaky(y) is then rounded to the plain version's bf16 value
// (a sum in another order moves y by an ulp, and near a rounding midpoint
// that flips the bf16 operand and moves every z of its row).
__device__ __forceinline__ void y_seq(const bf16_t* lsk, const bf16_t* w1t,
                                      int ld, int S, int kk,
                                      float (&y)[2][4]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const bf16_t* l0 = lsk + g * ld;
  const bf16_t* w = w1t + (16 * kk + 2 * q) * ld;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[h][e] = 0.f;
#pragma unroll 4
  for (int k = 0; k < S; k += 2) {
    const unsigned u0 = ld32(l0 + k), u1 = ld32(l0 + 8 * ld + k);
    const float a[2][2] = {{bf2f(u0 & 0xffffu), bf2f(u0 >> 16)},
                           {bf2f(u1 & 0xffffu), bf2f(u1 >> 16)}};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const unsigned wv = ld32(w + (8 * h + c) * ld + k);
        const float w0 = bf2f(wv & 0xffffu), w1 = bf2f(wv >> 16);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& acc = y[h][2 * r + c];
          acc = fmaf(a[r][1], w1, fmaf(a[r][0], w0, acc));
        }
      }
  }
}

// The A fragment of a 16-column k step from the C fragments of its two n
// tiles, rounded to bf16.
__device__ __forceinline__ void a_frag(const float (&lo)[4],
                                       const float (&hi)[4], unsigned* af) {
  af[0] = pack2(lo[0], lo[1]);
  af[1] = pack2(lo[2], lo[3]);
  af[2] = pack2(hi[0], hi[1]);
  af[3] = pack2(hi[2], hi[3]);
}

// Stores the A fragment of k step kk of the slab's rows [m0, m0 + 16)
// into x (M, CP): through the warp's buffer buf (16 rows of kBufLd bf16)
// by stmatrix, then one 16-byte store a lane, so that each store writes
// whole 32-byte sectors.
constexpr int kBufLd = 24;
__device__ __forceinline__ void store_a(bf16_t* x, int CP, long m0, long hi,
                                        int kk, const unsigned* af,
                                        bf16_t* buf) {
  const int lane = threadIdx.x & 31, row = lane >> 1, half = lane & 1;
  // matrix i = lane / 8: rows 8 (i & 1) + lane % 8, columns 8 (i >> 1)
  stmatrix_x4(buf + (((lane >> 3) & 1) * 8 + (lane & 7)) * kBufLd +
                  (lane >> 4) * 8, af);
  __syncwarp();
  const uint4 v = *reinterpret_cast<const uint4*>(buf + row * kBufLd +
                                                  half * 8);
  if (m0 + row < hi)
    *reinterpret_cast<uint4*>(x + (m0 + row) * CP + 16 * kk + half * 8) = v;
  __syncwarp();
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Adds the column sums over the slab's 16 rows of N n tiles (the first n
// of them) into cs (one float per column from the tiles' first column):
// rows g and g + 8 in the lane, then a shuffle tree over g.
template <int N>
__device__ __forceinline__ void colsum_add(const float (&d)[N][4], int n,
                                           float* cs) {
  const int lane = threadIdx.x & 31, q = lane & 3;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) {
      float v0 = d[j][0] + d[j][2], v1 = d[j][1] + d[j][3];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v0 += __shfl_xor_sync(0xffffffffu, v0, off);
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
      }
      if (lane < 4) {
        cs[8 * j + 2 * q] += v0;
        cs[8 * j + 2 * q + 1] += v1;
      }
    }
}

// Forward.  NT: n tiles of z held (CP <= 8 NT).
template <int NT>
__global__ void __launch_bounds__(kThreads, NT > 16 ? 1 : 2)
    head_fwd_kernel(HeadArgs a) {
  const int S = a.s, C = a.c, SP = a.sp, CP = a.cp;
  const int ld1 = SP + 8, ld2 = CP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16_t* w1t = reinterpret_cast<bf16_t*>(smem);        // (CP, ld1) W1^T
  bf16_t* w2t = w1t + CP * ld1;                          // (CP, ld2) W2^T
  float* b1 = reinterpret_cast<float*>(w2t + CP * ld2);  // (CP)
  float* b2 = b1 + CP;                                   // (CP)
  float* red = b2 + CP;                                  // (2, kThreads)
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, q = tid & 3;
  // the warp's slab of rnd(leaky(skip)), (16, ld1)
  bf16_t* lsk = reinterpret_cast<bf16_t*>(red + 2 * kThreads) +
                (tid >> 5) * 16 * ld1;
  stage_wt(a.w1, S, C, SP, CP, w1t, ld1);
  stage_wt(a.w2, C, C, CP, CP, w2t, ld2);
  for (int i = tid; i < CP; i += kThreads) {
    b1[i] = i < C ? a.b1[i] : 0.f;
    b2[i] = i < C ? a.b2[i] : 0.f;
  }
  __syncthreads();
  const int nt = CP / 8;
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi = min_l(lo + a.rows_per_block, a.m_total);
  float loss = 0.f, match = 0.f;   // lanes q = 0, over the block's slabs
  for (long m0 = lo + 16 * (tid >> 5); m0 < hi; m0 += 16 * kWarps) {
    const long r0 = m0 + g;
    __syncwarp();
    for (int i = lane; i < 8 * S; i += 32) {
      const int r = i / (S / 2), k = 2 * (i % (S / 2));
      st32(lsk + r * ld1 + k,
           m0 + r < hi ? leaky2(ld32(a.skip + (m0 + r) * S + k)) : 0u);
    }
    __syncwarp();
    float z[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[j][e] = 0.f;
    for (int kk = 0; kk < CP / 16; ++kk) {
      float y[2][4];
      y_seq(lsk, w1t, ld1, S, kk, y);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[h][e] = leaky(y[h][e] + b1[16 * kk + 8 * h + 2 * q + (e & 1)]);
      unsigned af[4];
      a_frag(y[0], y[1], af);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nt) {
          const bf16_t* bp = w2t + (8 * j + g) * ld2 + 16 * kk + 2 * q;
          const unsigned b[2] = {ld32(bp), ld32(bp + 8)};
          mma_bf16(z[j], af, b);
        }
    }
    // per row (h: rows r0, r0 + 8): max, first argmax, z at the target
    int tg[2], am[2] = {C, C};
    float mx[2] = {-INFINITY, -INFINITY}, zt[2] = {0.f, 0.f};
    tg[0] = r0 < hi ? target_of(a, r0) : -1;
    tg[1] = r0 + 8 < hi ? target_of(a, r0 + 8) : -1;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * q + (e & 1), h = e >> 1;
        if (j < nt && col < C) {
          const float v = z[j][e] + b2[col];
          z[j][e] = v;
          if (v > mx[h]) {
            mx[h] = v;
            am[h] = col;
          }
          if (col == tg[h]) zt[h] = v;
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, mx[h], off);
        const int oa = __shfl_xor_sync(0xffffffffu, am[h], off);
        if (om > mx[h] || (om == mx[h] && oa < am[h])) {
          mx[h] = om;
          am[h] = oa;
        }
      }
      zt[h] = quad_sum(zt[h]);
    }
    float es[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * q + (e & 1), h = e >> 1;
        const float v = j < nt && col < C ? expf(z[j][e] - mx[h]) : 0.f;
        z[j][e] = v;
        es[h] += v;
      }
    es[0] = quad_sum(es[0]);
    es[1] = quad_sum(es[1]);
    // p (times the row's reciprocal: no division, and so no branch, per
    // element), and for parity sum exp(p) and p at the target
    const float inv[2] = {1.f / es[0], 1.f / es[1]};
    float sep[2] = {0.f, 0.f}, pt[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * q + (e & 1), h = e >> 1;
        if (j < nt && col < C) {
          const float p = z[j][e] * inv[h];
          z[j][e] = p;
          if (a.parity) {
            sep[h] += expf(p);
            if (col == tg[h]) pt[h] = p;
          }
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long r = r0 + 8 * h;
      const float nll = a.parity
                            ? logf(quad_sum(sep[h])) - quad_sum(pt[h])
                            : logf(es[h]) + mx[h] - zt[h];
      if (q == 0 && r < hi && valid_row(a, r)) {
        loss += nll;
        match += am[h] == tg[h] ? 1.f : 0.f;
      }
    }
    if (a.p_out) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = 8 * j + 2 * q;
        if (j < nt && col < C) {
          if (r0 < hi)
            *reinterpret_cast<float2*>(a.p_out + r0 * C + col) =
                make_float2(z[j][0], z[j][1]);
          if (r0 + 8 < hi)
            *reinterpret_cast<float2*>(a.p_out + (r0 + 8) * C + col) =
                make_float2(z[j][2], z[j][3]);
        }
      }
    }
  }
  // block sums, in thread order
  red[tid] = loss;
  red[kThreads + tid] = match;
  __syncthreads();
  if (tid == 0) {
    float sl = 0.f, sm = 0.f;
    for (int i = 0; i < kThreads; ++i) {
      sl += red[i];
      sm += red[kThreads + i];
    }
    a.part[2 * blockIdx.x] = sl;
    a.part[2 * blockIdx.x + 1] = sm;
  }
}

// Backward: dz, dy, dskip and the bias gradients; ly, dz_r and dy_r
// stored for head_wgrad_kernel.
template <int NT, int KS>
__global__ void __launch_bounds__(kThreads, NT > 16 ? 1 : 2)
    head_bwd_kernel(HeadArgs a) {
  const int S = a.s, C = a.c, SP = a.sp, CP = a.cp;
  const int ld1 = SP + 8, ldc = CP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16_t* w1t = reinterpret_cast<bf16_t*>(smem);        // (CP, ld1) W1^T
  bf16_t* w1 = w1t + CP * ld1;                           // (SP, ldc) W1
  bf16_t* w2 = w1 + SP * ldc;                            // (CP, ldc) W2
  float* b1 = reinterpret_cast<float*>(w2 + CP * ldc);   // (CP)
  float* cs = b1 + CP;   // (kWarps, 2, CP): each warp's db2, db1 sums
  const int tid = threadIdx.x, g = (tid & 31) >> 2, q = tid & 3;
  // the warp's store buffer (16, kBufLd)
  bf16_t* buf = reinterpret_cast<bf16_t*>(cs + kWarps * 2 * CP) +
                (tid >> 5) * 16 * kBufLd;
  stage_wt(a.w1, S, C, SP, CP, w1t, ld1);
  stage_w(a.w1, S, C, SP, CP, w1, ldc);
  stage_w(a.w2, C, C, CP, CP, w2, ldc);
  for (int i = tid; i < CP; i += kThreads) b1[i] = i < C ? a.b1[i] : 0.f;
  for (int i = tid; i < kWarps * 2 * CP; i += kThreads) cs[i] = 0.f;
  __syncthreads();
  float* cs2 = cs + (tid >> 5) * 2 * CP;
  float* cs1 = cs2 + CP;
  const int nt = CP / 8, ks1 = SP / 16;
  const float dloss = a.dloss[0];
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi = min_l(lo + a.rows_per_block, a.m_total);
  for (long m0 = lo + 16 * (tid >> 5); m0 < hi; m0 += 16 * kWarps) {
    const long r0 = m0 + g;
    unsigned as[KS][4];
    lskip_frags<KS>(a.skip, S, r0, hi, as);
    // y rebuilt: ly stored, and y > 0 kept as bit 4 (j % 8) + e of word
    // j / 8 (n tile j, element e)
    unsigned ypos[NT / 8];
#pragma unroll
    for (int i = 0; i < NT / 8; ++i) ypos[i] = 0u;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      if (kk < CP / 16) {
        float y[2][4];
        y_tile<KS>(w1t, ld1, kk, ks1, as, y);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = y[h][e] + b1[16 * kk + 8 * h + 2 * q + (e & 1)];
            const int j = 2 * kk + h;
            ypos[j / 8] |= (v > 0.f ? 1u : 0u) << (4 * (j % 8) + e);
            y[h][e] = leaky(v);
          }
        unsigned af[4];
        a_frag(y[0], y[1], af);
        store_a(a.ly, CP, m0, hi, kk, af, buf);
      }
    // dz from the saved p, read in the C fragment layout
    int tg[2];
    float sc[2];
    tg[0] = r0 < hi ? target_of(a, r0) : -1;
    tg[1] = r0 + 8 < hi ? target_of(a, r0 + 8) : -1;
    sc[0] = r0 < hi && valid_row(a, r0) ? dloss : 0.f;
    sc[1] = r0 + 8 < hi && valid_row(a, r0 + 8) ? dloss : 0.f;
    float d[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * q;
      float2 v0 = make_float2(0.f, 0.f), v1 = v0;
      if (j < nt && col < C) {
        if (r0 < hi)
          v0 = *reinterpret_cast<const float2*>(a.p_in + r0 * C + col);
        if (r0 + 8 < hi)
          v1 = *reinterpret_cast<const float2*>(a.p_in + (r0 + 8) * C + col);
      }
      d[j][0] = v0.x;
      d[j][1] = v0.y;
      d[j][2] = v1.x;
      d[j][3] = v1.y;
    }
    if (a.parity) {
      // g = softmax(p) - onehot, dz = p g - p (p.g)
      float es[2] = {0.f, 0.f}, pg[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j < nt && 8 * j + 2 * q + (e & 1) < C)
            es[e >> 1] += expf(d[j][e]);
      const float inv[2] = {1.f / quad_sum(es[0]), 1.f / quad_sum(es[1])};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * q + (e & 1), h = e >> 1;
          if (j < nt && col < C) {
            const float gv =
                expf(d[j][e]) * inv[h] - (col == tg[h] ? 1.f : 0.f);
            pg[h] += d[j][e] * gv;
          }
        }
      pg[0] = quad_sum(pg[0]);
      pg[1] = quad_sum(pg[1]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * q + (e & 1), h = e >> 1;
          float v = 0.f;
          if (j < nt && col < C) {
            const float p = d[j][e];
            const float gv = expf(p) * inv[h] - (col == tg[h] ? 1.f : 0.f);
            v = (p * gv - p * pg[h]) * sc[h];
          }
          d[j][e] = v;
        }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * q + (e & 1), h = e >> 1;
          d[j][e] = j < nt && col < C
                        ? (d[j][e] - (col == tg[h] ? 1.f : 0.f)) * sc[h]
                        : 0.f;
        }
    }
    colsum_add<NT>(d, nt, cs2);
    // dz rounded: the A fragments of dy = dz_r W2^T
    unsigned dza[NT / 2][4];
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      a_frag(d[2 * kk], d[2 * kk + 1], dza[kk]);
      if (kk < CP / 16) store_a(a.dzr, CP, m0, hi, kk, dza[kk], buf);
    }
    // dy in chunks of 8 n tiles (64 columns = 4 k steps of dskip)
    float ds[2 * KS][4];
#pragma unroll
    for (int i = 0; i < 2 * KS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[i][e] = 0.f;
#pragma unroll 1
    for (int ch = 0; 8 * ch < nt; ++ch) {
      float dy[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dy[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
        if (kk < CP / 16)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (8 * ch + j < nt) {
              const bf16_t* bp =
                  w2 + (64 * ch + 8 * j + g) * ldc + 16 * kk + 2 * q;
              const unsigned b[2] = {ld32(bp), ld32(bp + 8)};
              mma_bf16_add(dy[j], dza[kk], b);
            }
      const unsigned bits = ypos[0];
#pragma unroll
      for (int i = 0; i + 1 < NT / 8; ++i) ypos[i] = ypos[i + 1];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dy[j][e] *= (bits >> (4 * j + e)) & 1u ? 1.f : 0.01f;
      colsum_add<8>(dy, nt - 8 * ch, cs1 + 64 * ch);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int kk = 4 * ch + k4;
        if (kk < CP / 16) {
          unsigned af[4];
          a_frag(dy[2 * k4], dy[2 * k4 + 1], af);
          store_a(a.dyr, CP, m0, hi, kk, af, buf);
#pragma unroll
          for (int i = 0; i < 2 * KS; ++i)
            if (i < SP / 8) {
              const bf16_t* bp = w1 + (8 * i + g) * ldc + 16 * kk + 2 * q;
              const unsigned b[2] = {ld32(bp), ld32(bp + 8)};
              mma_bf16_add(ds[i], af, b);
            }
        }
      }
    }
    // dskip = dy_r W1^T * dleaky(skip); leaky(skip) and skip have the
    // same sign, and the A fragments hold leaky(skip)
#pragma unroll
    for (int i = 0; i < 2 * KS; ++i) {
      const int col = 8 * i + 2 * q;
      if (i < SP / 8 && col < S) {
        const unsigned s0 = as[i >> 1][(i & 1) * 2];
        const unsigned s1 = as[i >> 1][(i & 1) * 2 + 1];
        if (r0 < hi)
          st32(a.dskip + r0 * S + col,
               pack2(ds[i][0] * dleaky_bits(s0),
                     ds[i][1] * dleaky_bits(s0 >> 16)));
        if (r0 + 8 < hi)
          st32(a.dskip + (r0 + 8) * S + col,
               pack2(ds[i][2] * dleaky_bits(s1),
                     ds[i][3] * dleaky_bits(s1 >> 16)));
      }
    }
  }
  __syncthreads();
  // partial: dw1 (S*C) | db1 (C) | dw2 (C*C) | db2 (C); the weight
  // gradients come from head_wgrad_kernel
  float* out = a.part + blockIdx.x * a.n_el;
  for (int c = tid; c < C; c += kThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      s2 += cs[w * 2 * CP + c];
      s1 += cs[w * 2 * CP + CP + c];
    }
    out[S * C + c] = s1;
    out[S * C + C + C * C + c] = s2;
  }
}

// dW2 = ly^T dz_r (blocks x < tiles_n^2) and dW1 = rnd(leaky(skip))^T dy_r
// (the next tiles_n blocks) over the rows of split blockIdx.y (the
// backward's block ranges): a 64x64 output tile per block, each warp
// 32x32, 32-row stages through shared memory with the next stage's loads
// in flight, fragments by ldmatrix.trans.
__global__ void __launch_bounds__(kWgThreads)
    head_wgrad_kernel(HeadArgs a, int tiles_n) {
  __shared__ __align__(16) bf16_t sa[kWgRows * kWgLd];
  __shared__ __align__(16) bf16_t sb[kWgRows * kWgLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3, wm = warp >> 1, wn = warp & 1;
  const int tiles2 = tiles_n * tiles_n;
  const bool is_w1 = static_cast<int>(blockIdx.x) >= tiles2;
  const int t = is_w1 ? blockIdx.x - tiles2 : blockIdx.x;
  const int m0 = is_w1 ? 0 : (t / tiles_n) * kWgTile;
  const int n0 = (t % tiles_n) * kWgTile;
  const int S = a.s, C = a.c, CP = a.cp;
  const int kc = is_w1 ? S : C, kcp = is_w1 ? a.sp : CP;
  const bf16_t* bsrc = is_w1 ? a.dyr : a.dzr;
  const long lo = blockIdx.y * a.rows_per_block;
  const long hi = min_l(lo + a.rows_per_block, a.m_total);
  unsigned ra[8], rb[8];
  // a stage of rows [r, r + 32) into registers: A from ly (16 bytes) or
  // from skip (8 bytes, leaky and rounded), B from dz_r or dy_r
  auto load = [&](long r) {
    if (is_w1) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = tid + kWgThreads * u, row = i >> 4, c4 = (i & 15) * 4;
        uint2 v = make_uint2(0u, 0u);
        if (r + row < hi && c4 < S)
          v = *reinterpret_cast<const uint2*>(a.skip + (r + row) * S + c4);
        ra[2 * u] = leaky2(v.x);
        ra[2 * u + 1] = leaky2(v.y);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = tid + kWgThreads * u, row = i >> 3, c8 = (i & 7) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r + row < hi && m0 + c8 < CP)
          v = *reinterpret_cast<const uint4*>(a.ly + (r + row) * CP + m0 + c8);
        ra[4 * u] = v.x;
        ra[4 * u + 1] = v.y;
        ra[4 * u + 2] = v.z;
        ra[4 * u + 3] = v.w;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + kWgThreads * u, row = i >> 3, c8 = (i & 7) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r + row < hi && n0 + c8 < CP)
        v = *reinterpret_cast<const uint4*>(bsrc + (r + row) * CP + n0 + c8);
      rb[4 * u] = v.x;
      rb[4 * u + 1] = v.y;
      rb[4 * u + 2] = v.z;
      rb[4 * u + 3] = v.w;
    }
  };
  auto store = [&]() {
    if (is_w1) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = tid + kWgThreads * u, row = i >> 4, c4 = (i & 15) * 4;
        *reinterpret_cast<uint2*>(sa + row * kWgLd + c4) =
            make_uint2(ra[2 * u], ra[2 * u + 1]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = tid + kWgThreads * u, row = i >> 3, c8 = (i & 7) * 8;
        *reinterpret_cast<uint4*>(sa + row * kWgLd + c8) =
            make_uint4(ra[4 * u], ra[4 * u + 1], ra[4 * u + 2], ra[4 * u + 3]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + kWgThreads * u, row = i >> 3, c8 = (i & 7) * 8;
      *reinterpret_cast<uint4*>(sb + row * kWgLd + c8) =
          make_uint4(rb[4 * u], rb[4 * u + 1], rb[4 * u + 2], rb[4 * u + 3]);
    }
  };
  // ldmatrix rows of lane: A's four matrices (rows k 0-7 | 8-15, columns
  // channel 0-7 | 8-15) in the order of an A fragment's registers, B's in
  // the order of two n tiles' B fragments
  const int arow = (lane >> 4) * 8 + (lane & 7), acol = ((lane >> 3) & 1) * 8;
  const int brow = ((lane >> 3) & 1) * 8 + (lane & 7), bcol = (lane >> 4) * 8;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  if (lo < hi) load(lo);
  for (long r = lo; r < hi; r += kWgRows) {
    __syncthreads();
    store();
    __syncthreads();
    if (r + kWgRows < hi) load(r + kWgRows);
#pragma unroll
    for (int ks = 0; ks < kWgRows / 16; ++ks) {
      unsigned af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (m0 + wm * 32 + mt * 16 < kcp)
          ldmatrix_x4_trans(af[mt], sa + (16 * ks + arow) * kWgLd + wm * 32 +
                                        mt * 16 + acol);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int nb = wn * 32 + np * 16;
        if (n0 + nb < CP) {
          unsigned bq[4];
          ldmatrix_x4_trans(bq, sb + (16 * ks + brow) * kWgLd + nb + bcol);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (m0 + wm * 32 + mt * 16 < kcp) {
              mma_bf16_add(acc[mt][2 * np], af[mt], bq);
              mma_bf16_add(acc[mt][2 * np + 1], af[mt], bq + 2);
            }
        }
      }
    }
  }
  // partial: dw1 (S*C) | db1 (C) | dw2 (C*C) | db2 (C)
  float* out = a.part + blockIdx.y * a.n_el + (is_w1 ? 0 : S * C + C);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + mt * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn * 32 + j * 8 + 2 * q + (e & 1);
        if (m < kc && n < C) out[m * C + n] = acc[mt][j][e];
      }
}

// --------------------------------------------------- packed (float32 fmaf)

// A (K, N) weight staged in shared memory at *next (advanced), transposed
// with TRANS.
template <bool TRANS>
__device__ __forceinline__ const float* stage(const float* w, int K, int N,
                                              float*& next) {
  float* dst = next;
  for (int i = threadIdx.x; i < K * N; i += kThreads) {
    const float v = w[i];
    if (TRANS)
      dst[(i % N) * K + i / N] = v;
    else
      dst[i] = v;
  }
  next += K * N;
  return dst;
}

__global__ void __launch_bounds__(kThreads) head_fwd_packed_kernel(HeadArgs a) {
  constexpr int RT = kMaxRows;
  const int S = a.s, C = a.c, lds = S + 4, ldc = C + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* act = reinterpret_cast<float*>(smem);   // (RT, lds)
  float* ly = act + RT * lds;                     // (RT, ldc)
  float* z = ly + RT * ldc;                       // (RT, ldc)
  float* b1 = z + RT * ldc;
  float* b2 = b1 + C;
  float* next = b2 + C;
  const int tid = threadIdx.x;
  const float* w1 = stage<false>(a.w1, S, C, next);
  const float* w2 = stage<false>(a.w2, C, C, next);
  for (int i = tid; i < C; i += kThreads) {
    b1[i] = a.b1[i];
    b2[i] = a.b2[i];
  }
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi = min_l(lo + a.rows_per_block, a.m_total);
  float loss = 0.f, match = 0.f;   // per row-thread, over the block
  for (long m0 = lo; m0 < hi; m0 += RT) {
    __syncthreads();
    for (int i = tid; i < RT * S; i += kThreads) {
      const int r = i / S, k = i % S;
      const long m = m0 + r;
      act[r * lds + k] = m < hi ? leaky(bf2f(a.skip[m * S + k])) : 0.f;
    }
    __syncthreads();
    tile_product<false>(act, lds, w1, S, C, [&](int r, int c, float v) {
      ly[r * ldc + c] = leaky(v + b1[c]);
    }, RT);
    __syncthreads();
    tile_product<false>(ly, ldc, w2, C, C, [&](int r, int c, float v) {
      z[r * ldc + c] = v + b2[c];
    }, RT);
    __syncthreads();
    if (tid < RT && m0 + tid < hi) {
      const long m = m0 + tid;
      bool hit;
      const float nll = row_nll(z + tid * ldc, C, target_of(a, m), a.parity,
                                false, &hit);
      if (valid_row(a, m)) {
        loss += nll;
        match += hit ? 1.f : 0.f;
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

__global__ void __launch_bounds__(kThreads) head_bwd_packed_kernel(HeadArgs a) {
  constexpr int RT = kMaxRows;
  const int S = a.s, C = a.c, lds = S + 4, ldc = C + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* next = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const float* w1 = stage<false>(a.w1, S, C, next);
  const float* w1t = stage<true>(a.w1, S, C, next);
  const float* w2t = stage<true>(a.w2, C, C, next);
  const float* w2 = stage<false>(a.w2, C, C, next);
  float* b1 = next;
  float* b2 = b1 + C;
  float* lsk = b2 + C;                            // (RT, lds) leaky(skip)
  float* ys = lsk + RT * lds;                     // (RT, ldc) y
  float* ly = ys + RT * ldc;                      // (RT, ldc) leaky(y)
  float* dz = ly + RT * ldc;                      // (RT, ldc) z, p, dz
  float* dy = dz + RT * ldc;                      // (RT, ldc)
  float* gw1 = dy + RT * ldc;                     // (S, C)
  float* gw2 = gw1 + S * C;                       // (C, C)
  for (int i = tid; i < S * C; i += kThreads) gw1[i] = 0.f;
  for (int i = tid; i < C * C; i += kThreads) gw2[i] = 0.f;
  for (int i = tid; i < C; i += kThreads) {
    b1[i] = a.b1[i];
    b2[i] = a.b2[i];
  }
  const float dloss = a.dloss[0];
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi = min_l(lo + a.rows_per_block, a.m_total);
  float gb1 = 0.f, gb2 = 0.f;   // db1, db2 of one column each
  for (long m0 = lo; m0 < hi; m0 += RT) {
    const int rows = static_cast<int>(hi - m0 < RT ? hi - m0 : RT);
    __syncthreads();
    for (int i = tid; i < RT * S; i += kThreads) {
      const int r = i / S, k = i % S;
      const long m = m0 + r;
      lsk[r * lds + k] = r < rows ? leaky(bf2f(a.skip[m * S + k])) : 0.f;
    }
    __syncthreads();
    tile_product<false>(lsk, lds, w1, S, C, [&](int r, int c, float v) {
      const float y = v + b1[c];
      ys[r * ldc + c] = y;
      ly[r * ldc + c] = leaky(y);
    }, RT);
    // z rebuilt, then its softmax in place, then dz in place
    __syncthreads();
    tile_product<false>(ly, ldc, w2, C, C, [&](int r, int c, float v) {
      dz[r * ldc + c] = v + b2[c];
    }, RT);
    __syncthreads();
    // dz, one thread per row
    if (tid < RT) {
      float* dr = dz + tid * ldc;
      if (tid < rows) {
        const long m = m0 + tid;
        row_softmax(dr, C);
        row_dz(dr, C, target_of(a, m), valid_row(a, m) ? dloss : 0.f,
               a.parity, dr);
      } else {
        for (int c = 0; c < C; ++c) dr[c] = 0.f;
      }
    }
    __syncthreads();
    // db2 (one thread per column)
    if (tid < C)
      for (int r = 0; r < rows; ++r) gb2 += dz[r * ldc + tid];
    tile_wgrad(ly, ldc, dz, ldc, C, C, rows, gw2);
    tile_product<false>(dz, ldc, w2t, C, C, [&](int r, int c, float v) {
      dy[r * ldc + c] = v * dleaky(ys[r * ldc + c]);
    }, RT);
    __syncthreads();
    // db1 the same way, on the threads after db2's where there are enough
    const int c1 = 2 * C <= kThreads ? tid - C : tid;
    if (c1 >= 0 && c1 < C)
      for (int r = 0; r < rows; ++r) gb1 += dy[r * ldc + c1];
    tile_wgrad(lsk, lds, dy, ldc, S, C, rows, gw1);
    tile_product<false>(dy, ldc, w1t, C, S, [&](int r, int k, float v) {
      // leaky(skip) and skip have the same sign
      if (r < rows)
        a.dskip[(m0 + r) * S + k] = f2bf(v * dleaky(lsk[r * lds + k]));
    }, RT);
  }
  __syncthreads();
  // partial: dw1 (S*C) | db1 (C) | dw2 (C*C) | db2 (C)
  float* out = a.part + static_cast<long>(blockIdx.x) * (S * C + C * C + 2 * C);
  for (int i = tid; i < S * C; i += kThreads) out[i] = gw1[i];
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

// ------------------------------------------------------------------ host

int pad16(int x) { return (x + 15) / 16 * 16; }

// Shared memory of the unpacked kernels (see their layouts).
size_t fwd_smem(int s, int c) {
  const size_t sp = pad16(s), cp = pad16(c);
  return 2 * (cp * (sp + 8) + cp * (cp + 8) + kWarps * 16 * (sp + 8)) +
         4 * (2 * cp + 2 * kThreads);
}
size_t bwd_smem(int s, int c) {
  const size_t sp = pad16(s), cp = pad16(c);
  return 2 * (cp * (sp + 8) + sp * (cp + 8) + cp * (cp + 8)) +
         4 * (cp + kWarps * 2 * cp) + 2 * kWarps * 16 * kBufLd;
}
// Shared memory of the packed kernels (S = C = 64, 64-row tiles): the
// tiles, biases, weights and (backward) weight-gradient sums.
size_t packed_smem(int s, int c, bool bwd) {
  const size_t sc = static_cast<size_t>(s) * c, cc = static_cast<size_t>(c) * c;
  const size_t tiles = kMaxRows * (s + 4) + (bwd ? 4 : 2) * kMaxRows * (c + 4);
  return (tiles + 2 * c + (bwd ? 3 * (sc + cc) : sc + cc)) * 4;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename K>
int launch(K kernel, const HeadArgs& a, size_t bytes, int blocks,
           cudaStream_t st) {
  int err = set_smem(reinterpret_cast<const void*>(kernel), bytes);
  if (err) return err;
  kernel<<<blocks, kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The unpacked kernel instance for (SP, CP): NT = 8, 16 or 32 n tiles,
// KS = 1 or 4 k steps of skip.
template <typename F>
int dispatch(int sp, int cp, const F& f) {
  if (sp <= 16) {
    if (cp <= 64) return f.template run<8, 1>();
    if (cp <= 128) return f.template run<16, 1>();
    return f.template run<32, 1>();
  }
  if (cp <= 64) return f.template run<8, 4>();
  if (cp <= 128) return f.template run<16, 4>();
  return f.template run<32, 4>();
}

struct FwdLaunch {
  const HeadArgs& a;
  int blocks;
  cudaStream_t st;
  template <int NT, int KS>   // the forward holds no skip fragments
  int run() const {
    return launch(head_fwd_kernel<NT>, a, fwd_smem(a.s, a.c), blocks, st);
  }
};

struct BwdLaunch {
  const HeadArgs& a;
  int blocks;
  cudaStream_t st;
  template <int NT, int KS>
  int run() const {
    return launch(head_bwd_kernel<NT, KS>, a, bwd_smem(a.s, a.c), blocks, st);
  }
};

// The arguments every kernel takes; rows_per_block a multiple of `rt`.
HeadArgs make_args(const bf16_t* skip, const int* pack, int pack_cols,
                   int tgt_off, const float* w1, const float* b1,
                   const float* w2, const float* b2, long m_total, int blocks,
                   int rt, int t_len, int s, int c, int rf, int parity,
                   float* part) {
  HeadArgs a = {};
  a.skip = skip;
  a.pack = pack;
  a.pack_cols = pack_cols;
  a.tgt_off = tgt_off;
  a.w1 = w1;
  a.w2 = w2;
  a.b1 = b1;
  a.b2 = b2;
  a.m_total = m_total;
  const long per = (m_total + blocks - 1) / blocks;
  a.rows_per_block = ((per + rt - 1) / rt) * rt;
  a.n_el = static_cast<long>(s) * c + static_cast<long>(c) * c + 2 * c;
  a.t_len = t_len;
  a.s = s;
  a.c = c;
  a.sp = pad16(s);
  a.cp = pad16(c);
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
         c <= 256 && fwd_smem(s, c) <= kSmemLimit &&
         bwd_smem(s, c) <= kSmemLimit;
}

// bf16 elements of the backward's scratch (ly, dz_r, dy_r) over m rows
long movenet_head_inter(int s, int c, long m) {
  (void)s;
  return 3L * m * pad16(c);
}

// Forward: out[0] = loss sum, out[1] = match count; p_out may be null (and
// is ignored with packed, which takes S = C = 64).  part holds `blocks` x
// 2 floats.
int movenet_head_fwd(const bf16_t* skip, const int* pack, int pack_cols,
                     int tgt_off, const float* w1, const float* b1,
                     const float* w2, const float* b2, float* p_out,
                     float* part, float* out, int batch, int t_len, int s,
                     int c, int rf, int parity, int packed, int blocks,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!movenet_head_supports(s, c) || (packed && (s != 64 || c != 64)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long m = static_cast<long>(batch) * t_len;
  HeadArgs a = make_args(skip, pack, pack_cols, tgt_off, w1, b1, w2, b2, m,
                         blocks, packed ? kMaxRows : 16, t_len, s, c, rf,
                         parity, part);
  int err;
  if (packed) {
    err = launch(head_fwd_packed_kernel, a, packed_smem(s, c, false), blocks,
                 st);
  } else {
    a.p_out = p_out;
    err = dispatch(a.sp, a.cp, FwdLaunch{a, blocks, st});
  }
  if (err) return err;
  reduce_kernel<<<1, kThreads, 0, st>>>(part, out, 2, blocks);
  return static_cast<int>(cudaGetLastError());
}

// Backward: grads = dw1 (S*C) | db1 (C) | dw2 (C*C) | db2 (C); part holds
// `blocks` x that many floats.  p_in is the forward's softmax (unpacked)
// or null (packed: rebuilt from skip); inter holds movenet_head_inter
// bf16 elements (unpacked).
int movenet_head_bwd(const bf16_t* skip, const int* pack, int pack_cols,
                     int tgt_off, const float* p_in, const float* w1,
                     const float* b1, const float* w2, const float* b2,
                     const float* dloss, bf16_t* dskip, bf16_t* inter,
                     float* part, float* grads, int batch, int t_len, int s,
                     int c, int rf, int parity, int packed, int blocks,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!movenet_head_supports(s, c) || (packed && (s != 64 || c != 64)) ||
      (!packed && (!p_in || !inter)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long m = static_cast<long>(batch) * t_len;
  HeadArgs a = make_args(skip, pack, pack_cols, tgt_off, w1, b1, w2, b2, m,
                         blocks, packed ? kMaxRows : 16, t_len, s, c, rf,
                         parity, part);
  a.dloss = dloss;
  a.dskip = dskip;
  int err;
  if (packed) {
    err = launch(head_bwd_packed_kernel, a, packed_smem(s, c, true), blocks,
                 st);
  } else {
    a.p_in = p_in;
    a.ly = inter;
    a.dzr = inter + m * a.cp;
    a.dyr = inter + 2 * m * a.cp;
    err = dispatch(a.sp, a.cp, BwdLaunch{a, blocks, st});
    if (err) return err;
    const int tiles_n = (a.cp + kWgTile - 1) / kWgTile;
    head_wgrad_kernel<<<dim3(tiles_n * tiles_n + tiles_n, blocks),
                        kWgThreads, 0, st>>>(a, tiles_n);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err) return err;
  reduce_kernel<<<static_cast<int>((a.n_el + kThreads - 1) / kThreads),
                  kThreads, 0, st>>>(part, grads, a.n_el, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
