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
//     head_fwd_packed_kernel and head_bwd_packed_kernel on split-TF32
//     tensor cores (see "Packed design" below).
//
// The unpacked kernels (head_fwd_kernel<NT, LG>, head_bwd_kernel<NT, KS>,
// head_wgrad_kernel; 4 <= S <= 128, 4 <= C <= 256, multiples of 4).  Every
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
// no atomics.  The wide head (S > 64, the R = 128 trunk's skip width)
// keeps this design with two changes that keep it within a block's shared
// memory: the backward stages no W1^T and rebuilds y as the forward forms
// it (y_seq, W1 read down its columns, the rows of skip from global
// memory), and above C = 128 the forward's y_seq reads its rows from
// global memory instead of per-warp slabs (LG).  dW1's GEMM takes SP / 64
// row tiles.
//
// Packed design (S = C = 64).  Every product takes float32 operands and
// runs as split-TF32 mma.sync m16n8k8 (mma_tf32.cuh), three passes each
// (kPass*, the table PACKED_SPLIT_PASSES of ops/head_loss.py).  A block of
// 8 warps stages W1 and W2 once as float32 (rows of 8 mod 32 floats, rows
// 4-7 of every 8 swapped in pairs) and reads each copy both as W and, k
// paired, as W^T, with no bank conflict either way.  Fragments pair k
// (slot q holds k0 + 2q, slot q + 4 holds k0 + 2q + 1), so the C
// fragment of one product is the A fragment of the next in registers.
// Forward: each warp walks 16-row slabs, its next slab of skip arriving
// by cp.async; y, leaky(y) and z stay in registers, and each row of z
// lies in a quad of lanes, whose shuffles give its max, first argmax,
// exp sums and NLL.  A row whose two largest logits lie within 2^-14 (1 +
// |max|) of each other takes its argmax again from y and z formed as the
// plain version forms them (a chain of fmaf over k in order, then the
// bias: cuBLAS's float32 order), the warp on one row at a time, so that
// the match count is the plain version's; the loss keeps the tensor-core
// z.  Backward: tiles of 128 rows, a slab a warp.  Per slab y and z are
// rebuilt, dz formed in quads, dy = dz W2^T * dleaky(y) and dskip = dy
// W1^T * dleaky(skip) in registers (dskip rounded to bf16 and stored 16
// bytes a lane through the warp's rows of shared memory); leaky(y), dz
// and dy go to the tile in shared memory.  After a barrier each warp adds
// its 16 x 32 slice of dW2 = leaky(y)^T dz and dW1 = leaky(skip)^T dy
// into registers, which hold the sums over all of the block's rows; db2
// and db1 are column sums of the unrounded dz and dy in each lane's
// registers, shuffle trees at the end.  One partial a block, added by
// reduce_kernel in a fixed order.
//
// Bound (the larger of bytes over 3.35 TB/s and operations over the peak
// of their units: bf16 989 TF/s; float32 products on the tensor cores at
// the TF32 495 TF/s, counted once).  Forward: skip read, p written (4C
// bytes a row): 0.038 ms at the breakdancing shape (B*T = 320000, S = C =
// 64), 0.077 at (8, 128, B = 3).  Backward: skip and p read, dskip
// written: 0.050 and 0.080 ms.  Beside these the backward moves ly, dz_r
// and dy_r (6 CP bytes a row written, read again by the weight-gradient
// GEMM: 1.5x the p bytes at C = 128) and the forward and backward stage
// the weights once per block.  The packed form moves no p: its forward
// is bound by bytes (skip and targets, 42.3 MB: 0.0126 ms at the
// breakdancing shape), its backward by operations (y and z rebuilt, dy,
// dskip, dW2, dW1: 1.57e10, 0.0318 ms); the split passes (three a
// product) are the design's cost.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "head_core.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"


namespace {

using head_core::leaky;

constexpr int kThreads = head_core::kHeadThreads;   // 256: 8 warps
constexpr int kWarps = kThreads / 32;
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
  // the float32 kernels' (in place of skip, dskip, ly, dzr and dyr)
  const float* skip_f;  // (M, S)
  float* dskip_f;       // (M, S)
  float* ly_f;          // (M, CP') leaky(y), CP' = C rounded up to 8
  float* dz_f;          // (M, CP') dz
  float* dy_f;          // (M, CP') dy
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

// y (without b1) as y_tile lays it out, from the slab's rows of
// rnd(leaky(skip)) and W1, summed as the plain version's float32 product
// sums it (cuBLAS on the card): k in order, one fmaf per term from zero.
// leaky(y) is then rounded to the plain version's bf16 value (a sum in
// another order moves y by an ulp, and near a rounding midpoint that flips
// the bf16 operand and moves every z of its row).  rows(k, u0, u1) gives
// the pairs at k of the lane's rows g and g + 8 of the slab: from the
// warp's slab lsk in shared memory, or (the wide head) from skip in global
// memory; cols(j, k, w0, w1) W1[k][c] and W1[k + 1][c] of the lane's column
// c = 16 kk + 2q + j, j = 8h + c': from W1^T, or (the wide head's
// backward) from W1.
template <typename Rows, typename Cols>
__device__ __forceinline__ void y_seq(Rows rows, Cols cols, int S,
                                      float (&y)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[h][e] = 0.f;
#pragma unroll 4
  for (int k = 0; k < S; k += 2) {
    unsigned u0, u1;
    rows(k, u0, u1);
    const float a[2][2] = {{bf2f(u0 & 0xffffu), bf2f(u0 >> 16)},
                           {bf2f(u1 & 0xffffu), bf2f(u1 >> 16)}};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float w0, w1;
        cols(8 * h + c, k, w0, w1);
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

// Forward.  NT: n tiles of z held (CP <= 8 NT).  LG (the wide head, S >
// 64 with C > 128, whose per-warp slabs do not fit beside W1^T and W2^T):
// y_seq reads rnd(leaky(skip)) from global memory instead of the slab.
template <int NT, bool LG>
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
    if constexpr (!LG) {
      __syncwarp();
      for (int i = lane; i < 8 * S; i += 32) {
        const int r = i / (S / 2), k = 2 * (i % (S / 2));
        st32(lsk + r * ld1 + k,
             m0 + r < hi ? leaky2(ld32(a.skip + (m0 + r) * S + k)) : 0u);
      }
      __syncwarp();
    }
    // the lane's rows g and g + 8 of the slab
    const bf16_t* l0 = lsk + g * ld1;
    const bool ok0 = r0 < hi, ok1 = r0 + 8 < hi;
    const bf16_t* s0 = a.skip + (ok0 ? r0 : 0) * S;
    const bf16_t* s1 = a.skip + (ok1 ? r0 + 8 : 0) * S;
    auto rows = [&](int k, unsigned& u0, unsigned& u1) {
      if constexpr (LG) {
        u0 = ok0 ? leaky2(ld32(s0 + k)) : 0u;
        u1 = ok1 ? leaky2(ld32(s1 + k)) : 0u;
      } else {
        u0 = ld32(l0 + k);
        u1 = ld32(l0 + 8 * ld1 + k);
      }
    };
    float z[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[j][e] = 0.f;
    for (int kk = 0; kk < CP / 16; ++kk) {
      float y[2][4];
      const bf16_t* w = w1t + (16 * kk + 2 * q) * ld1;
      auto w1t_cols = [&](int j, int k, float& w0, float& w1) {
        const unsigned wv = ld32(w + j * ld1 + k);
        w0 = bf2f(wv & 0xffffu);
        w1 = bf2f(wv >> 16);
      };
      y_seq(rows, w1t_cols, S, y);
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
// stored for head_wgrad_kernel.  KS > 4 (the wide head, S > 64): no W1^T,
// and y is rebuilt as the forward forms it (y_seq from W1 and the rows of
// skip in global memory), not on the tensor cores: with 128 terms a sum in
// another order put y on the other side of zero often enough to move a
// whole row of dskip through dleaky(y) (on the H100, one row of 2,000 at
// S = C = 128).
template <int NT, int KS>
__global__ void __launch_bounds__(kThreads, NT > 16 || KS > 4 ? 1 : 2)
    head_bwd_kernel(HeadArgs a) {
  constexpr bool kW1t = KS <= 4;
  const int S = a.s, C = a.c, SP = a.sp, CP = a.cp;
  const int ld1 = SP + 8, ldc = CP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16_t* w1t = reinterpret_cast<bf16_t*>(smem);        // (CP, ld1) W1^T
  bf16_t* w1 = w1t + (kW1t ? CP * ld1 : 0);              // (SP, ldc) W1
  bf16_t* w2 = w1 + SP * ldc;                            // (CP, ldc) W2
  float* b1 = reinterpret_cast<float*>(w2 + CP * ldc);   // (CP)
  float* cs = b1 + CP;   // (kWarps, 2, CP): each warp's db2, db1 sums
  const int tid = threadIdx.x, g = (tid & 31) >> 2, q = tid & 3;
  // the warp's store buffer (16, kBufLd)
  bf16_t* buf = reinterpret_cast<bf16_t*>(cs + kWarps * 2 * CP) +
                (tid >> 5) * 16 * kBufLd;
  if constexpr (kW1t) stage_wt(a.w1, S, C, SP, CP, w1t, ld1);
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
        if constexpr (kW1t) {
          y_tile<KS>(w1t, ld1, kk, ks1, as, y);
        } else {
          const bool ok0 = r0 < hi, ok1 = r0 + 8 < hi;
          const bf16_t* s0 = a.skip + (ok0 ? r0 : 0) * S;
          const bf16_t* s1 = a.skip + (ok1 ? r0 + 8 : 0) * S;
          y_seq([&](int k, unsigned& u0, unsigned& u1) {
                  u0 = ok0 ? leaky2(ld32(s0 + k)) : 0u;
                  u1 = ok1 ? leaky2(ld32(s1 + k)) : 0u;
                },
                [&](int j, int k, float& x0, float& x1) {
                  const bf16_t* wc = w1 + k * ldc + 16 * kk + 2 * q + j;
                  x0 = bf2f(wc[0]);
                  x1 = bf2f(wc[ldc]);
                },
                S, y);
        }
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
// (the next tiles_s x tiles_n blocks, tiles_s = SP / 64 rounded up) over
// the rows of split blockIdx.y (the backward's block ranges): a 64x64
// output tile per block, each warp 32x32, 32-row stages through shared
// memory with the next stage's loads in flight, fragments by
// ldmatrix.trans.
__global__ void __launch_bounds__(kWgThreads)
    head_wgrad_kernel(HeadArgs a, int tiles_n) {
  __shared__ __align__(16) bf16_t sa[kWgRows * kWgLd];
  __shared__ __align__(16) bf16_t sb[kWgRows * kWgLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3, wm = warp >> 1, wn = warp & 1;
  const int tiles2 = tiles_n * tiles_n;
  const bool is_w1 = static_cast<int>(blockIdx.x) >= tiles2;
  const int t = is_w1 ? blockIdx.x - tiles2 : blockIdx.x;
  const int m0 = (t / tiles_n) * kWgTile;
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
        if (r + row < hi && m0 + c4 < S)
          v = *reinterpret_cast<const uint2*>(a.skip + (r + row) * S + m0 +
                                              c4);
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

// ------------------------------------- packed (split-TF32 tensor cores)
//
// S = C = 64.  Every product takes float32 operands (the TPU's _dot) and
// runs as split-TF32 mma.sync m16n8k8 (mma_tf32.cuh) at the passes of
// PACKED_SPLIT_PASSES in ops/head_loss.py, which this table mirrors:
// (split A, split B) of each product.  No operand is exact in TF32 (W1
// and W2 are float32, and leaky(skip) is 0.01 x where the bf16 skip is
// negative), so every product takes three passes.
struct Passes {
  bool a, b;
};
constexpr Passes kPassY = {true, true};       // y = leaky(skip) W1
constexpr Passes kPassZ = {true, true};       // z = leaky(y) W2
constexpr Passes kPassDy = {true, true};      // dy = dz W2^T
constexpr Passes kPassDskip = {true, true};   // dskip = dy W1^T
constexpr Passes kPassDw2 = {true, true};     // dW2 = leaky(y)^T dz
constexpr Passes kPassDw1 = {true, true};     // dW1 = leaky(skip)^T dy

constexpr int kP = 64;                   // S = C
constexpr int kPLd = kP + 8;             // float32 rows (8 mod 32 floats)
constexpr int kPLdh = kP + 8;            // bf16 skip rows (elements)
constexpr int kBwdRows = 16 * kWarps;    // the backward's tile: a slab a warp
// Where the function jumps, the plain version's float32 order decides:
// a row whose two largest logits lie within this share of (1 + |max|)
// takes its argmax (the forward) from z formed again as the plain
// version forms it, and an element of y within this share of (1 + the
// row's largest |y|) of zero its value, whose sign dleaky reads (the
// backward).  The split sums lie about 1e-2 of this margin from the plain
// version's y and z (tests/test_torch_head_loss.py::
// test_tie_margin_covers_the_split_error), so everywhere else the
// argmax and the sign are the plain version's.
constexpr float kTieMargin = 1.f / 16384.f;

// d += a b at the passes SA, SB call for, the small terms first
template <bool SA, bool SB>
__device__ __forceinline__ void mma_passes(float* d, const Frag<4>& a,
                                           const Frag<2>& b) {
  if (SA) mma_tf32(d, a.small, b.big);
  if (SB) mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// cp.async: 16 bytes from global to shared memory, zero-filled where
// !valid (src is then any valid address and is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// waits until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ROWS rows of skip from row m0 into buf (row stride kPLdh) by cp.async,
// THREADS threads from thread index `me`, zero at or past hi
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage_skip(bf16_t* buf, const bf16_t* skip,
                                           long m0, long hi, int me) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / THREADS; ++i) {
    const int c = me + THREADS * i, row = c >> 3, c8 = 8 * (c & 7);
    const bool ok = m0 + row < hi;
    cp_async16(buf + row * kPLdh + c8,
               ok ? skip + (m0 + row) * kP + c8 : skip, ok);
  }
}

// Weight row k lies at row wrow(k): rows 4-7 of every 8 swap in pairs, so
// that the loads of both B fragment forms below (x W: rows k0 + 2q and
// k0 + 2q + 1 at column n0 + g; x W^T: columns k0 + 2q, + 1 of row n0 + g)
// fall in 32 distinct banks with rows of 8 mod 32 floats.
__device__ __forceinline__ int wrow(int k) { return k ^ ((k >> 2) & 1); }

// w (64, 64) float32 into shared memory at rows wrow(k) of kPLd floats
__device__ __forceinline__ void stage_w64(const float* w, float* dst) {
  for (int i = threadIdx.x; i < kP * kP / 4; i += kThreads) {
    const int k = i / (kP / 4), c4 = 4 * (i % (kP / 4));
    *reinterpret_cast<float4*>(dst + wrow(k) * kPLd + c4) =
        __ldg(reinterpret_cast<const float4*>(w + k * kP + c4));
  }
}

// Fragments with k paired: slot q holds k0 + 2q and slot q + 4 holds
// k0 + 2q + 1 (A and B alike, so the sum over k is the same), so that the
// C fragment of one n tile (columns 2q, 2q + 1 of rows g, g + 8) is the A
// fragment of the next product's k step as it stands.
// B of x W (element (k, n) = W[k][n]) at the k step k0 and n tile n0:
template <bool SPLIT>
__device__ __forceinline__ void load_b_w(const float* ws, int k0, int n0,
                                         Frag<2>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float v[2] = {ws[wrow(k0 + 2 * q) * kPLd + n0 + g],
                      ws[wrow(k0 + 2 * q + 1) * kPLd + n0 + g]};
  frag_set<SPLIT>(f, v);
}
// B of x W^T (element (k, n) = W[n][k]):
template <bool SPLIT>
__device__ __forceinline__ void load_b_wt(const float* ws, int k0, int n0,
                                          Frag<2>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float2 u =
      *reinterpret_cast<const float2*>(ws + wrow(n0 + g) * kPLd + k0 + 2 * q);
  const float v[2] = {u.x, u.y};
  frag_set<SPLIT>(f, v);
}
// A from the C fragment c of an n tile:
template <bool SPLIT>
__device__ __forceinline__ void a_from_c(const float (&c)[4], Frag<4>& f) {
  const float v[4] = {c[0], c[2], c[1], c[3]};
  frag_set<SPLIT>(f, v);
}
// A from a warp's 16 float32 rows at p (row stride kPLd):
template <bool SPLIT>
__device__ __forceinline__ void a_from_rows(const float* p, int k0,
                                            Frag<4>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float2 u =
      *reinterpret_cast<const float2*>(p + g * kPLd + k0 + 2 * q);
  const float2 v =
      *reinterpret_cast<const float2*>(p + (g + 8) * kPLd + k0 + 2 * q);
  const float x[4] = {u.x, v.x, u.y, v.y};
  frag_set<SPLIT>(f, x);
}
// A of leaky(skip) from a warp's 16 rows of bf16 skip at p:
template <bool SPLIT>
__device__ __forceinline__ void a_from_skip(const bf16_t* p, int k0,
                                            Frag<4>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const unsigned u0 = ld32(p + g * kPLdh + k0 + 2 * q);
  const unsigned u1 = ld32(p + (g + 8) * kPLdh + k0 + 2 * q);
  const float v[4] = {leaky(bf2f(static_cast<bf16_t>(u0 & 0xffffu))),
                      leaky(bf2f(static_cast<bf16_t>(u1 & 0xffffu))),
                      leaky(bf2f(static_cast<bf16_t>(u0 >> 16))),
                      leaky(bf2f(static_cast<bf16_t>(u1 >> 16)))};
  frag_set<SPLIT>(f, v);
}

// The A fragment of leaky(skip) with k along rows (the weight gradients,
// k = the tile's rows; slots q and q + 4 as the PTX ISA lays them out):
// element (i, k) = leaky(skip[k][i]) at p[k * kPLdh + i], bf16.
template <bool SPLIT>
__device__ __forceinline__ void a_skip_rows(const bf16_t* p, Frag<4>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float v[4] = {leaky(bf2f(p[q * kPLdh + g])),
                      leaky(bf2f(p[q * kPLdh + g + 8])),
                      leaky(bf2f(p[(q + 4) * kPLdh + g])),
                      leaky(bf2f(p[(q + 4) * kPLdh + g + 8]))};
  frag_set<SPLIT>(f, v);
}

// y = leaky(skip) W1 + b1 over a warp's 16 rows of skip at p (C fragments
// of the 8 n tiles)
__device__ __forceinline__ void packed_y(const bf16_t* p, const float* w1s,
                                         const float* b1s, float (&y)[8][4]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < kP; k0 += 8) {
    Frag<4> fa;
    a_from_skip<kPassY.a>(p, k0, fa);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      Frag<2> fb;
      load_b_w<kPassY.b>(w1s, k0, 8 * j, fb);
      mma_passes<kPassY.a, kPassY.b>(y[j], fa, fb);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] += b1s[8 * j + 2 * q + (e & 1)];
}

// out = x W over a warp's 16 rows, x as C fragments
template <bool SA, bool SB>
__device__ __forceinline__ void packed_product(const float (&x)[8][4],
                                               const float* ws,
                                               float (&out)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    Frag<4> fa;
    a_from_c<SA>(x[kk], fa);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      Frag<2> fb;
      load_b_w<SB>(ws, 8 * kk, 8 * j, fb);
      mma_passes<SA, SB>(out[j], fa, fb);
    }
  }
}

// out = x W (WT: x W^T) over a warp's 16 rows of x in shared memory at
// p (row stride kPLd)
template <bool WT, bool SA, bool SB>
__device__ __forceinline__ void rows_product(const float* p, const float* ws,
                                             float (&out)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[j][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < kP; k0 += 8) {
    Frag<4> fa;
    a_from_rows<SA>(p, k0, fa);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      Frag<2> fb;
      if (WT)
        load_b_wt<SB>(ws, k0, 8 * j, fb);
      else
        load_b_w<SB>(ws, k0, 8 * j, fb);
      mma_passes<SA, SB>(out[j], fa, fb);
    }
  }
}

// y at column c of the row whose skip is skr, formed as the plain version
// forms it: a float32 product on the card is, per element, a chain of
// fmaf over k in order from zero; then the bias is added.
__device__ float exact_y(const bf16_t* skr, const float* w1s,
                         const float* b1s, int c) {
  float acc = 0.f;
  for (int s = 0; s < kP; ++s)
    acc = fmaf(leaky(bf2f(skr[s])), w1s[wrow(s) * kPLd + c], acc);
  return acc + b1s[c];
}

// The first argmax of one row's logits formed as the plain version forms
// them: y, then z, two columns a lane.  skr is the row's skip, scratch 64
// floats of the warp.  Warp-collective; every lane returns the column.
__device__ int exact_argmax(const bf16_t* skr, const float* w1s,
                            const float* w2s, const float* b1s,
                            const float* b2s, float* scratch) {
  const int lane = threadIdx.x & 31, c0 = 2 * lane;
  *reinterpret_cast<float2*>(scratch + c0) =
      make_float2(leaky(exact_y(skr, w1s, b1s, c0)),
                  leaky(exact_y(skr, w1s, b1s, c0 + 1)));
  __syncwarp();
  float z0 = 0.f, z1 = 0.f;
  for (int k = 0; k < kP; ++k) {
    const float v = scratch[k];
    const float2 w =
        *reinterpret_cast<const float2*>(w2s + wrow(k) * kPLd + c0);
    z0 = fmaf(v, w.x, z0);
    z1 = fmaf(v, w.y, z1);
  }
  __syncwarp();
  z0 += b2s[c0];
  z1 += b2s[c0 + 1];
  float v = z0;
  int col = c0;
  if (z1 > z0) {
    v = z1;
    col = c0 + 1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oc = __shfl_xor_sync(0xffffffffu, col, off);
    if (ov > v || (ov == v && oc < col)) {
      v = ov;
      col = oc;
    }
  }
  return col;
}

// Forward: each warp walks 16-row slabs of the block's rows, its next
// slab of skip arriving by cp.async while it computes this one.
__global__ void __launch_bounds__(kThreads, 2)
    head_fwd_packed_kernel(HeadArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w1s = reinterpret_cast<float*>(smem);   // (kP, kPLd) W1, wrow
  float* w2s = w1s + kP * kPLd;                   // (kP, kPLd) W2, wrow
  float* b1s = w2s + kP * kPLd;
  float* b2s = b1s + kP;
  float* red = b2s + kP;                          // (2, kThreads)
  float* scr = red + 2 * kThreads;                // (kWarps, kP)
  bf16_t* tiles = reinterpret_cast<bf16_t*>(scr + kWarps * kP);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  bf16_t* buf0 = tiles + warp * 2 * 16 * kPLdh;   // two (16, kPLdh) slabs
  bf16_t* buf1 = buf0 + 16 * kPLdh;
  float* wscr = scr + warp * kP;
  stage_w64(a.w1, w1s);
  stage_w64(a.w2, w2s);
  for (int i = tid; i < kP; i += kThreads) {
    b1s[i] = a.b1[i];
    b2s[i] = a.b2[i];
  }
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi = min_l(lo + a.rows_per_block, a.m_total);
  long m0 = lo + 16 * warp;
  if (m0 < hi) stage_skip<16, 32>(buf0, a.skip, m0, hi, lane);
  cp_async_commit();
  __syncthreads();
  float loss = 0.f, match = 0.f;   // lanes q = 0, over the warp's slabs
  for (int it = 0; m0 < hi; m0 += 16 * kWarps, ++it) {
    const bf16_t* cur = it & 1 ? buf1 : buf0;
    if (m0 + 16 * kWarps < hi)
      stage_skip<16, 32>(it & 1 ? buf0 : buf1, a.skip, m0 + 16 * kWarps, hi,
                         lane);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    float y[8][4], z[8][4];
    packed_y(cur, w1s, b1s, y);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] = leaky(y[j][e]);
    packed_product<kPassZ.a, kPassZ.b>(y, w2s, z);
    // per row (h: rows r0, r0 + 8): the two largest logits, the first
    // argmax, z at the target
    const long r0 = m0 + g;
    int tg[2], am[2] = {kP, kP};
    float mx[2] = {-INFINITY, -INFINITY}, m2[2] = {-INFINITY, -INFINITY};
    float zt[2] = {0.f, 0.f};
    tg[0] = r0 < hi ? target_of(a, r0) : -1;
    tg[1] = r0 + 8 < hi ? target_of(a, r0 + 8) : -1;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * q + (e & 1), h = e >> 1;
        const float v = z[j][e] + b2s[col];
        z[j][e] = v;
        if (v > mx[h]) {
          m2[h] = mx[h];
          mx[h] = v;
          am[h] = col;
        } else if (v > m2[h]) {
          m2[h] = v;
        }
        if (col == tg[h]) zt[h] = v;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, mx[h], off);
        const float o2 = __shfl_xor_sync(0xffffffffu, m2[h], off);
        const int oa = __shfl_xor_sync(0xffffffffu, am[h], off);
        const float second = fmaxf(fmaxf(m2[h], o2), fminf(mx[h], om));
        if (om > mx[h] || (om == mx[h] && oa < am[h])) {
          mx[h] = om;
          am[h] = oa;
        }
        m2[h] = second;
      }
      zt[h] = quad_sum(zt[h]);
    }
    float es[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = expf(z[j][e] - mx[e >> 1]);
        z[j][e] = v;
        es[e >> 1] += v;
      }
    es[0] = quad_sum(es[0]);
    es[1] = quad_sum(es[1]);
    // parity: sum exp(p) and p at the target, p = e times the row's
    // reciprocal (no division, and so no branch, per element)
    const float inv[2] = {1.f / es[0], 1.f / es[1]};
    float sep[2] = {0.f, 0.f}, pt[2] = {0.f, 0.f};
    if (a.parity) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * q + (e & 1), h = e >> 1;
          const float p = z[j][e] * inv[h];
          sep[h] += expf(p);
          if (col == tg[h]) pt[h] = p;
        }
    }
    bool take[2], tie[2];
    float nll[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long r = r0 + 8 * h;
      nll[h] = a.parity ? logf(quad_sum(sep[h])) - quad_sum(pt[h])
                        : logf(es[h]) + mx[h] - zt[h];
      take[h] = q == 0 && r < hi && valid_row(a, r);
      tie[h] = take[h] && mx[h] - m2[h] <= kTieMargin * (1.f + fabsf(mx[h]));
    }
    // near-tied rows: the argmax of the plain version's logits, the warp
    // on one row at a time
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned ties = __ballot_sync(0xffffffffu, tie[h]);
      while (ties) {
        const int src = __ffs(ties) - 1, row = (src >> 2) + 8 * h;
        ties &= ties - 1;
        const int col =
            exact_argmax(cur + row * kPLdh, w1s, w2s, b1s, b2s, wscr);
        if (g == (src >> 2)) am[h] = col;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (take[h]) {
        loss += nll[h];
        match += am[h] == tg[h] ? 1.f : 0.f;
      }
    __syncwarp();   // cur is staged again two slabs on
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

// Backward: tiles of kBwdRows rows, a 16-row slab a warp; the next tile
// of skip arrives by cp.async while this one computes.  Per slab: y and z
// rebuilt, dz from the softmax in quads, dy = dz W2^T * dleaky(y), dskip
// = dy W1^T * dleaky(skip), all in registers; leaky(y), dz and dy go to
// the tile's rows in shared memory.  Then every warp adds its 16 x 32
// slice of dW2 = leaky(y)^T dz and of dW1 = leaky(skip)^T dy over the
// tile's rows into registers; the bias gradients are per-lane column sums
// of the unrounded dz and dy.  One partial a block.
__global__ void __launch_bounds__(kThreads, 1)
    head_bwd_packed_kernel(HeadArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w1s = reinterpret_cast<float*>(smem);   // (kP, kPLd) W1, wrow
  float* w2s = w1s + kP * kPLd;                   // (kP, kPLd) W2, wrow
  float* b1s = w2s + kP * kPLd;
  float* b2s = b1s + kP;
  float* lyt = b2s + kP;                          // (kBwdRows, kPLd) ly
  float* dzt = lyt + kBwdRows * kPLd;             // dz
  float* dyt = dzt + kBwdRows * kPLd;             // dy
  bf16_t* sk0 = reinterpret_cast<bf16_t*>(dyt + kBwdRows * kPLd);
  bf16_t* sk1 = sk0 + kBwdRows * kPLdh;           // two skip tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  bf16_t* stg = sk1 + kBwdRows * kPLdh + warp * 16 * kPLdh;   // dskip rows
  const int mw = warp & 3, nw = warp >> 2;   // the warp's dW slices
  stage_w64(a.w1, w1s);
  stage_w64(a.w2, w2s);
  for (int i = tid; i < kP; i += kThreads) {
    b1s[i] = a.b1[i];
    b2s[i] = a.b2[i];
  }
  const float dloss = a.dloss[0];
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi = min_l(lo + a.rows_per_block, a.m_total);
  float gw1[4][4], gw2[4][4], cs1[8][2], cs2[8][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gw1[j][e] = gw2[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    cs1[j][0] = cs1[j][1] = cs2[j][0] = cs2[j][1] = 0.f;
  if (lo < hi) stage_skip<kBwdRows, kThreads>(sk0, a.skip, lo, hi, tid);
  cp_async_commit();
  int it = 0;
  for (long t0 = lo; t0 < hi; t0 += kBwdRows, ++it) {
    const bf16_t* cur = it & 1 ? sk1 : sk0;
    cp_async_wait<0>();
    __syncthreads();   // this tile (and the weights) in; the last tile's
                       // weight gradients done
    if (t0 + kBwdRows < hi)
      stage_skip<kBwdRows, kThreads>(it & 1 ? sk0 : sk1, a.skip,
                                     t0 + kBwdRows, hi, tid);
    cp_async_commit();
    const int s0 = 16 * warp;
    const long m0 = t0 + s0, r0 = m0 + g;
    if (m0 < hi) {
      const bf16_t* sk = cur + s0 * kPLdh;
      float y[8][4], d[8][4];
      packed_y(sk, w1s, b1s, y);
      // y near zero formed again in the plain version's order (kTieMargin)
      float ymax[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ymax[e >> 1] = fmaxf(ymax[e >> 1], fabsf(y[j][e]));
      unsigned near = 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ymax[h] = fmaxf(ymax[h], __shfl_xor_sync(0xffffffffu, ymax[h], 1));
        ymax[h] = fmaxf(ymax[h], __shfl_xor_sync(0xffffffffu, ymax[h], 2));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool n = fabsf(y[j][e]) <= kTieMargin * (1.f + ymax[e >> 1]);
          near |= (n ? 1u : 0u) << (4 * j + e);
        }
      while (near) {
        const int i = __ffs(near) - 1;
        near &= near - 1;
        const float v = exact_y(sk + (g + 8 * ((i & 3) >> 1)) * kPLdh, w1s,
                                b1s, 8 * (i >> 2) + 2 * q + (i & 1));
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * j + e == i) y[j][e] = v;
      }
      // y > 0 as bit 4 j + e (n tile j, element e); leaky(y) to lyt
      unsigned ypos = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ypos |= (y[j][e] > 0.f ? 1u : 0u) << (4 * j + e);
          y[j][e] = leaky(y[j][e]);
        }
        float* p = lyt + (s0 + g) * kPLd + 8 * j + 2 * q;
        *reinterpret_cast<float2*>(p) = make_float2(y[j][0], y[j][1]);
        *reinterpret_cast<float2*>(p + 8 * kPLd) =
            make_float2(y[j][2], y[j][3]);
      }
      __syncwarp();
      // each product's A from the warp's rows of the tiles: fewer
      // registers than from the last product's fragments
      rows_product<false, kPassZ.a, kPassZ.b>(lyt + s0 * kPLd, w2s, d);
      // dz from the softmax of z, per row in a quad
      int tg[2];
      float sc[2], mx[2] = {-INFINITY, -INFINITY};
      tg[0] = r0 < hi ? target_of(a, r0) : -1;
      tg[1] = r0 + 8 < hi ? target_of(a, r0 + 8) : -1;
      sc[0] = r0 < hi && valid_row(a, r0) ? dloss : 0.f;
      sc[1] = r0 + 8 < hi && valid_row(a, r0 + 8) ? dloss : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = d[j][e] + b2s[8 * j + 2 * q + (e & 1)];
          d[j][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
      float es[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = expf(d[j][e] - mx[e >> 1]);
          d[j][e] = v;
          es[e >> 1] += v;
        }
      const float inv[2] = {1.f / quad_sum(es[0]), 1.f / quad_sum(es[1])};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][e] *= inv[e >> 1];   // p
      if (a.parity) {
        // g = softmax(p) - onehot, dz = p g - p (p.g); exp(p) in y
        float ep[2] = {0.f, 0.f}, pg[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            y[j][e] = expf(d[j][e]);
            ep[e >> 1] += y[j][e];
          }
        const float inv2[2] = {1.f / quad_sum(ep[0]),
                               1.f / quad_sum(ep[1])};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * q + (e & 1), h = e >> 1;
            y[j][e] = y[j][e] * inv2[h] - (col == tg[h] ? 1.f : 0.f);
            pg[h] += d[j][e] * y[j][e];
          }
        pg[0] = quad_sum(pg[0]);
        pg[1] = quad_sum(pg[1]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            d[j][e] = (d[j][e] * y[j][e] - d[j][e] * pg[h]) * sc[h];
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * q + (e & 1), h = e >> 1;
            d[j][e] = (d[j][e] - (col == tg[h] ? 1.f : 0.f)) * sc[h];
          }
      }
      // dz: column sums, dzt
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cs2[j][0] += d[j][0] + d[j][2];
        cs2[j][1] += d[j][1] + d[j][3];
        float* p = dzt + (s0 + g) * kPLd + 8 * j + 2 * q;
        *reinterpret_cast<float2*>(p) = make_float2(d[j][0], d[j][1]);
        *reinterpret_cast<float2*>(p + 8 * kPLd) =
            make_float2(d[j][2], d[j][3]);
      }
      // dy = dz W2^T * dleaky(y) into y: column sums, dyt
      __syncwarp();
      rows_product<true, kPassDy.a, kPassDy.b>(dzt + s0 * kPLd, w2s, y);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[j][e] *= (ypos >> (4 * j + e)) & 1u ? 1.f : 0.01f;
        cs1[j][0] += y[j][0] + y[j][2];
        cs1[j][1] += y[j][1] + y[j][3];
        float* p = dyt + (s0 + g) * kPLd + 8 * j + 2 * q;
        *reinterpret_cast<float2*>(p) = make_float2(y[j][0], y[j][1]);
        *reinterpret_cast<float2*>(p + 8 * kPLd) =
            make_float2(y[j][2], y[j][3]);
      }
      // dskip = dy W1^T * dleaky(skip) into d (leaky(skip) and skip have
      // the same sign), rounded to bf16 through the warp's rows of stg,
      // then 16 bytes a lane
      __syncwarp();
      rows_product<true, kPassDskip.a, kPassDskip.b>(dyt + s0 * kPLd, w1s,
                                                     d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * q;
        const unsigned s0v = ld32(sk + g * kPLdh + col);
        const unsigned s1v = ld32(sk + (g + 8) * kPLdh + col);
        st32(stg + g * kPLdh + col, pack2(d[j][0] * dleaky_bits(s0v),
                                          d[j][1] * dleaky_bits(s0v >> 16)));
        st32(stg + (g + 8) * kPLdh + col,
             pack2(d[j][2] * dleaky_bits(s1v),
                   d[j][3] * dleaky_bits(s1v >> 16)));
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 32 * i, row = c >> 3, c8 = 8 * (c & 7);
        if (m0 + row < hi)
          *reinterpret_cast<uint4*>(a.dskip + (m0 + row) * kP + c8) =
              *reinterpret_cast<const uint4*>(stg + row * kPLdh + c8);
      }
      __syncwarp();
    } else {
      // past the rows: dz and dy zero (leaky(skip) is zero there too)
      for (int i = lane; i < 16 * kP / 4; i += 32) {
        const int row = s0 + i / (kP / 4), c4 = 4 * (i % (kP / 4));
        *reinterpret_cast<float4*>(dzt + row * kPLd + c4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dyt + row * kPLd + c4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncthreads();
    // the warp's slices: dW2 rows 16 mw (leaky(y) columns), dW1 rows 16 mw
    // (skip columns), columns 32 nw, over the tile's rows in k steps of 8
#pragma unroll 2
    for (int k0 = 0; k0 < kBwdRows; k0 += 8) {
      Frag<4> fa;
      load_a_kmajor<kPassDw2.a>(lyt + k0 * kPLd + 16 * mw, kPLd, fa);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Frag<2> fb;
        load_b_kmajor(dzt + k0 * kPLd + 32 * nw + 8 * j, kPLd, fb);
        mma_passes<kPassDw2.a, kPassDw2.b>(gw2[j], fa, fb);
      }
      a_skip_rows<kPassDw1.a>(cur + k0 * kPLdh + 16 * mw, fa);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Frag<2> fb;
        load_b_kmajor(dyt + k0 * kPLd + 32 * nw + 8 * j, kPLd, fb);
        mma_passes<kPassDw1.a, kPassDw1.b>(gw1[j], fa, fb);
      }
    }
  }
  // the bias sums: a shuffle tree over g, then the warps' rows (in lyt)
  // added in warp order
  __syncthreads();
  float* cs = lyt;   // (kWarps, 2, kP): db2, db1
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v2 = cs2[j][e], v1 = cs1[j][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v2 += __shfl_xor_sync(0xffffffffu, v2, off);
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
      }
      if (g == 0) {
        cs[warp * 2 * kP + 8 * j + 2 * q + e] = v2;
        cs[warp * 2 * kP + kP + 8 * j + 2 * q + e] = v1;
      }
    }
  __syncthreads();
  // partial: dw1 (S*C) | db1 (C) | dw2 (C*C) | db2 (C)
  float* out = a.part + blockIdx.x * a.n_el;
  if (tid < 2 * kP) {
    const int c = tid % kP, which = tid / kP;   // 0: db2, 1: db1
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += cs[w * 2 * kP + which * kP + c];
    out[which ? kP * kP + c : 2 * kP * kP + kP + c] = s;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * mw + g + 8 * (e >> 1);
      const int n = 32 * nw + 8 * j + 2 * q + (e & 1);
      out[i * kP + n] = gw1[j][e];
      out[kP * kP + kP + i * kP + n] = gw2[j][e];
    }
}

// --------------------------- float32 (split-TF32 tensor cores, unpacked)
//
// The unpacked kernels with the float32 compute dtype (head_loss.py:281
// _fwd_kernel and :336 _bwd_kernel, whose roundings to in_dtype do nothing
// in float32): skip, p and dskip float32, and every product with float32
// operands as split-TF32 mma.sync m16n8k8 in three passes (no operand is
// exact in TF32).  4 <= S <= 128 and 4 <= C <= 128, multiples of 4, here;
// above C = 128 the wide kernels below, whose W2 streams through a ring.
// Above S = 64 dskip's n tiles run in two halves of 8 over the same dy
// fragments (the same sums, in the same order).
// The design is the bf16 unpacked kernels' with float32 tiles and the
// packed kernels' fragments: a block of 8 warps stages W1 and W2 once as
// float32 (SP and CP: S and C rounded up to 8, zero-padded; rows of 8 mod
// 32 floats at rows wrow(k)), each warp walks 16-row slabs with its
// leaky(skip) rows in shared memory, and k is paired in the fragments, so
// that y's C fragments are z's A fragments in registers.
//   Forward (head_fwd_f32_kernel): z in registers, each row's max, first
// argmax, exp sums and NLL in its quad of lanes, p stored; a row whose two
// largest logits lie within kTieMargin takes its argmax from y and z
// formed as the plain version forms them (an fmaf chain over k in order
// from zero, then the bias: cuBLAS's float32 order), as the packed
// forward does.
//   Backward (head_bwd_f32_kernel): y rebuilt, and each element of y
// within kTieMargin of zero formed again as the plain version forms it
// (dleaky reads its sign: a flip moves that dy by 100x); dz from the saved
// p, dy = dz W2^T * dleaky(y), dskip = dy W1^T * dleaky(skip), stored in
// float32; leaky(y), dz and dy go to float32 scratch (M, CP), and
// head_wgrad_f32_kernel forms dW2 = leaky(y)^T dz and dW1 = leaky(skip)^T
// dy from it as a split-K GEMM; the bias gradients are column sums of dz
// and dy per warp.  Per-block partials, reduce_kernel: no atomics.
// Bound at experiment 03's head (B = 3, T = 160000, S = 8, C = 128):
// forward skip read and p written, 0.26 GB (0.080 ms at 3.35 TB/s);
// backward skip and p read, dskip written, 0.28 GB (0.084 ms), against 2
// M (3 S C + 2 C C) = 3.4e10 operations at the TF32 peak counted once
// (0.070 ms): both bound by bytes.  As launched the backward also moves
// the scratch (3 x 4 CP bytes a row, written and read again), and the
// three split passes of k = 8 take six times the mma.sync issue of the
// bf16 form's k = 16 steps: the row pass sets its time (PERF.md).

// The float32 kernels' shared memory (ops/cuda/head_loss.f32_smem mirrors
// it): W1 (SP, ldc) and W2 (CP, ldc) at rows wrow(k), then the forward's
// b1, b2 (CP each), block sums (2, kThreads) and per warp its leaky(skip)
// rows (16, lds) and a row of CP floats; the backward's b1, the warps'
// column sums (kWarps, 2, CP) and per warp its leaky(skip) rows.
struct F32Head {
  int sp, cp, ldc, lds;
  __host__ __device__ F32Head(int s, int c)
      : sp((s + 7) / 8 * 8), cp((c + 7) / 8 * 8),
        ldc((cp + 31) / 32 * 32 + 8), lds((sp + 31) / 32 * 32 + 8) {}
  __host__ __device__ size_t weights() const {
    return static_cast<size_t>(sp + cp) * ldc;
  }
  __host__ __device__ size_t fwd_bytes() const {
    return 4 * (weights() + 2 * cp + 2 * kThreads +
                static_cast<size_t>(kWarps) * (16 * lds + cp));
  }
  __host__ __device__ size_t bwd_bytes() const {
    return 4 * (weights() + cp + static_cast<size_t>(kWarps) * 2 * cp +
                static_cast<size_t>(kWarps) * 16 * lds);
  }
};

// w (K, N) float32 into dst at rows wrow(k) of ld floats, zero past K and
// N up to KP rows and NP columns (KP a multiple of 8)
__device__ __forceinline__ void stage_w_f32(const float* w, int K, int N,
                                            int KP, int NP, float* dst,
                                            int ld) {
  for (int i = threadIdx.x; i < KP * NP; i += kThreads) {
    const int k = i / NP, n = i % NP;
    dst[wrow(k) * ld + n] = k < K && n < N ? w[k * N + n] : 0.f;
  }
}
// B of x W (k paired, as load_b_w) from rows of ld floats
__device__ __forceinline__ void f32_b_w(const float* ws, int ld, int k0,
                                        int n0, Frag<2>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float v[2] = {ws[wrow(k0 + 2 * q) * ld + n0 + g],
                      ws[wrow(k0 + 2 * q + 1) * ld + n0 + g]};
  frag_set<true>(f, v);
}
// B of x W^T (k paired, as load_b_wt)
__device__ __forceinline__ void f32_b_wt(const float* ws, int ld, int k0,
                                         int n0, Frag<2>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float2 u =
      *reinterpret_cast<const float2*>(ws + wrow(n0 + g) * ld + k0 + 2 * q);
  const float v[2] = {u.x, u.y};
  frag_set<true>(f, v);
}
// A from a warp's 16 float32 rows at p (row stride ld; k paired)
__device__ __forceinline__ void f32_a_rows(const float* p, int ld, int k0,
                                           Frag<4>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float2 u = *reinterpret_cast<const float2*>(p + g * ld + k0 + 2 * q);
  const float2 v =
      *reinterpret_cast<const float2*>(p + (g + 8) * ld + k0 + 2 * q);
  const float x[4] = {u.x, v.x, u.y, v.y};
  frag_set<true>(f, x);
}

// The same A of leaky(skip) read from a warp's 16 rows of skip in global
// memory from row m0 (the wide kernels above S = 64, which stage no rows):
// zero at or past hi and past S (a multiple of 4: a pair lies wholly in or
// past it)
__device__ __forceinline__ void f32_a_skip(const float* skip, int S, long m0,
                                           long hi, int k0, Frag<4>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int k = k0 + 2 * q;
  float2 u = make_float2(0.f, 0.f), v = u;
  if (k < S) {
    if (m0 + g < hi)
      u = *reinterpret_cast<const float2*>(skip + (m0 + g) * S + k);
    if (m0 + g + 8 < hi)
      v = *reinterpret_cast<const float2*>(skip + (m0 + g + 8) * S + k);
  }
  const float x[4] = {leaky(u.x), leaky(v.x), leaky(u.y), leaky(v.y)};
  frag_set<true>(f, x);
}

// The warp's 16 rows of leaky(skip) from row m0 into lsk (row stride lds),
// zero at or past hi and past S up to SP
__device__ __forceinline__ void stage_lskip_f32(const float* skip, int S,
                                                int SP, long m0, long hi,
                                                float* lsk, int lds) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int i = lane; i < 16 * SP; i += 32) {
    const int r = i / SP, k = i % SP;
    lsk[r * lds + k] =
        m0 + r < hi && k < S ? leaky(skip[(m0 + r) * S + k]) : 0.f;
  }
  __syncwarp();
}

// y[c] (without b1) of the row whose leaky(skip) is lrow (or, with lg, of
// the row of skip at lrow), as the plain version forms it: an fmaf chain
// over k in order from zero
__device__ float exact_y_f32(const float* lrow, const float* w1s, int ld,
                             int S, int c, bool lg = false) {
  float acc = 0.f;
  for (int k = 0; k < S; ++k)
    acc = fmaf(lg ? leaky(lrow[k]) : lrow[k], w1s[wrow(k) * ld + c], acc);
  return acc;
}

// The first argmax of one row's logits formed as the plain version forms
// them: y (exact_y_f32 + b1), leaky, then z the same way; lrow is the row's
// leaky(skip), scr CP floats of the warp.  W2's element (k, c) lies at
// w2[wrow(k) * ld2 + c] (staged in shared memory) or, with !w2_wrow, at
// w2[k * ld2 + c] (the wide kernels read it from global memory).
// Warp-collective; every lane returns the column.
__device__ int exact_argmax_f32(const float* lrow, const float* w1s,
                                const float* w2, const float* b1,
                                const float* b2, float* scr, int S, int C,
                                int ld, int ld2, bool w2_wrow, bool lg) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < C; c += 32)
    scr[c] = leaky(exact_y_f32(lrow, w1s, ld, S, c, lg) + b1[c]);
  __syncwarp();
  float v = -INFINITY;
  int col = C;
  for (int c = lane; c < C; c += 32) {
    float acc = 0.f;
    for (int k = 0; k < C; ++k)
      acc = fmaf(scr[k], w2[(w2_wrow ? wrow(k) : k) * ld2 + c], acc);
    acc += b2[c];
    if (acc > v) {   // c rises: the first of equal maxima stays
      v = acc;
      col = c;
    }
  }
  __syncwarp();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oc = __shfl_xor_sync(0xffffffffu, col, off);
    if (ov > v || (ov == v && oc < col)) {
      v = ov;
      col = oc;
    }
  }
  return col;
}

// The forward's rows from z (without b2; NT n tiles, the first nt of
// them) of a warp's slab [r0 - g, + 16): the two largest logits and the
// first argmax of each row, the NLL, p; near-tied rows take the argmax of
// exact_argmax_f32; loss and match gain the valid rows (lanes q = 0) and p
// is stored (a.p_out).  lsk holds the slab's leaky(skip) rows or, with lg,
// points at its rows of skip (lds = S).
template <int NT>
__device__ __forceinline__ void fwd_rows_f32(
    const HeadArgs& a, float (&z)[NT][4], int nt, long r0, long hi,
    const float* lsk, int lds, const float* w1s, int ldc, const float* w2,
    int ld2, bool w2_wrow, const float* b1, const float* b2, float* scr,
    float& loss, float& match, bool lg = false) {
  const int C = a.c, S = a.s;
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  // per row (h: rows r0, r0 + 8): the two largest logits, the first
  // argmax, z at the target
  int tg[2], am[2] = {C, C};
  float mx[2] = {-INFINITY, -INFINITY}, m2[2] = {-INFINITY, -INFINITY};
  float zt[2] = {0.f, 0.f};
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
          m2[h] = mx[h];
          mx[h] = v;
          am[h] = col;
        } else if (v > m2[h]) {
          m2[h] = v;
        }
        if (col == tg[h]) zt[h] = v;
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[h], off);
      const float o2 = __shfl_xor_sync(0xffffffffu, m2[h], off);
      const int oa = __shfl_xor_sync(0xffffffffu, am[h], off);
      const float second = fmaxf(fmaxf(m2[h], o2), fminf(mx[h], om));
      if (om > mx[h] || (om == mx[h] && oa < am[h])) {
        mx[h] = om;
        am[h] = oa;
      }
      m2[h] = second;
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
  bool take[2], tie[2];
  float nll[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long r = r0 + 8 * h;
    nll[h] = a.parity ? logf(quad_sum(sep[h])) - quad_sum(pt[h])
                      : logf(es[h]) + mx[h] - zt[h];
    take[h] = q == 0 && r < hi && valid_row(a, r);
    tie[h] = take[h] && mx[h] - m2[h] <= kTieMargin * (1.f + fabsf(mx[h]));
  }
  // near-tied rows: the argmax of the plain version's logits, the warp
  // on one row at a time
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned ties = __ballot_sync(0xffffffffu, tie[h]);
    while (ties) {
      const int src = __ffs(ties) - 1, row = (src >> 2) + 8 * h;
      ties &= ties - 1;
      const int col = exact_argmax_f32(lsk + row * lds, w1s, w2, b1, b2, scr,
                                       S, C, ldc, ld2, w2_wrow, lg);
      if (g == (src >> 2)) am[h] = col;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (take[h]) {
      loss += nll[h];
      match += am[h] == tg[h] ? 1.f : 0.f;
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

// The block's loss and match sums, in thread order, into its partial
// (red: 2 kThreads floats of shared memory)
__device__ __forceinline__ void block_sums_f32(const HeadArgs& a, float* red,
                                               float loss, float match) {
  const int tid = threadIdx.x;
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

// Forward.  NT: n tiles of z held (CP <= 8 NT).
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    head_fwd_f32_kernel(HeadArgs a) {
  const int S = a.s, C = a.c;
  const F32Head L(S, C);
  const int SP = L.sp, CP = L.cp, ldc = L.ldc, lds = L.lds;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w1s = reinterpret_cast<float*>(smem);   // (SP, ldc) W1, wrow
  float* w2s = w1s + SP * ldc;                    // (CP, ldc) W2, wrow
  float* b1 = w2s + CP * ldc;                     // (CP)
  float* b2 = b1 + CP;                            // (CP)
  float* red = b2 + CP;                           // (2, kThreads)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  float* lsk = red + 2 * kThreads + warp * (16 * lds + CP);   // (16, lds)
  float* scr = lsk + 16 * lds;                                 // (CP)
  stage_w_f32(a.w1, S, C, SP, CP, w1s, ldc);
  stage_w_f32(a.w2, C, C, CP, CP, w2s, ldc);
  for (int i = tid; i < CP; i += kThreads) {
    b1[i] = i < C ? a.b1[i] : 0.f;
    b2[i] = i < C ? a.b2[i] : 0.f;
  }
  __syncthreads();
  const int nt = CP / 8;
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi = min_l(lo + a.rows_per_block, a.m_total);
  float loss = 0.f, match = 0.f;   // lanes q = 0, over the block's slabs
  for (long m0 = lo + 16 * warp; m0 < hi; m0 += 16 * kWarps) {
    const long r0 = m0 + g;
    stage_lskip_f32(a.skip_f, S, SP, m0, hi, lsk, lds);
    // y's n tile j, leaky, is z's k step j
    float z[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[j][e] = 0.f;
    for (int j = 0; j < nt; ++j) {
      float y[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < SP; k0 += 8) {
        Frag<4> fa;
        f32_a_rows(lsk, lds, k0, fa);
        Frag<2> fb;
        f32_b_w(w1s, ldc, k0, 8 * j, fb);
        mma_split_add<true>(y, fa, fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = leaky(y[e] + b1[8 * j + 2 * q + (e & 1)]);
      Frag<4> fa;
      a_from_c<true>(y, fa);
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
        if (jn < nt) {
          Frag<2> fb;
          f32_b_w(w2s, ldc, 8 * j, 8 * jn, fb);
          mma_split_add<true>(z[jn], fa, fb);
        }
    }
    fwd_rows_f32<NT>(a, z, nt, r0, hi, lsk, lds, w1s, ldc, w2s, ldc, true,
                     b1, b2, scr, loss, match);
  }
  block_sums_f32(a, red, loss, match);
}

// C fragments of rows [m0, m0 + 16) of N n tiles (the first n of them) to
// x (M, ld) in float32, rows below hi
template <int N>
__device__ __forceinline__ void store_rows_f32(float* x, int ld, long m0,
                                               long hi, int n,
                                               const float (&d)[N][4]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) {
      const int col = 8 * j + 2 * q;
      if (m0 + g < hi)
        *reinterpret_cast<float2*>(x + (m0 + g) * ld + col) =
            make_float2(d[j][0], d[j][1]);
      if (m0 + g + 8 < hi)
        *reinterpret_cast<float2*>(x + (m0 + g + 8) * ld + col) =
            make_float2(d[j][2], d[j][3]);
    }
}

// The backward's y of a warp's slab (NT n tiles, the first nt of them):
// rebuilt on the tensor cores from its leaky(skip) rows lsk, each element
// within kTieMargin of zero formed again in the plain version's order
// (dleaky reads its sign: a flip moves that dy by 100x); y > 0 as bit 4 j
// + e (n tile j, element e) of yp, leaky(y) stored to a.ly_f, and y left
// as leaky(y).  GS: the rows of skip read from global memory (lsk = skip
// + m0 S, lds = S; see f32_a_skip).
template <int NT, bool GS = false>
__device__ __forceinline__ void rebuild_y_f32(const HeadArgs& a,
                                              float (&y)[NT][4],
                                              unsigned (&yp)[(NT + 7) / 8],
                                              int nt, long m0, long hi,
                                              const float* lsk, int lds,
                                              const float* w1s, int ldc,
                                              const float* b1) {
  const int S = a.s, C = a.c;
  const F32Head L(S, C);
  const int SP = L.sp, CP = L.cp;
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
    if (j < nt) {
      for (int k0 = 0; k0 < SP; k0 += 8) {
        Frag<4> fa;
        if (GS)
          f32_a_skip(a.skip_f, S, m0, hi, k0, fa);
        else
          f32_a_rows(lsk, lds, k0, fa);
        Frag<2> fb;
        f32_b_w(w1s, ldc, k0, 8 * j, fb);
        mma_split_add<true>(y[j], fa, fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] += b1[8 * j + 2 * q + (e & 1)];
    }
  }
  float ymax[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ymax[e >> 1] = fmaxf(ymax[e >> 1], fabsf(y[j][e]));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ymax[h] = fmaxf(ymax[h], __shfl_xor_sync(0xffffffffu, ymax[h], 1));
    ymax[h] = fmaxf(ymax[h], __shfl_xor_sync(0xffffffffu, ymax[h], 2));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * q + (e & 1);
      if (j < nt && c < C && (!GS || m0 + g + 8 * (e >> 1) < hi) &&
          fabsf(y[j][e]) <= kTieMargin * (1.f + ymax[e >> 1]))
        y[j][e] = exact_y_f32(lsk + (g + 8 * (e >> 1)) * lds, w1s, ldc, S,
                              c, GS) + b1[c];
    }
#pragma unroll
  for (int i = 0; i < (NT + 7) / 8; ++i) yp[i] = 0u;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      yp[j / 8] |= (y[j][e] > 0.f ? 1u : 0u) << (4 * (j % 8) + e);
      y[j][e] = leaky(y[j][e]);
    }
  store_rows_f32<NT>(a.ly_f, CP, m0, hi, nt, y);
}

// dleaky(y) of n tile j, element e, from the bits of rebuild_y_f32
template <int NW>
__device__ __forceinline__ float dleaky_bit(const unsigned (&yp)[NW], int j,
                                            int e) {
  return (yp[j / 8] >> (4 * (j % 8) + e)) & 1u ? 1.f : 0.01f;
}

// dz of a warp's slab from the saved p (read in the C fragment layout;
// NT n tiles, the first nt of them), times dloss on the valid rows
template <int NT>
__device__ __forceinline__ void dz_from_p_f32(const HeadArgs& a,
                                              float (&d)[NT][4], int nt,
                                              long r0, long hi, float dloss) {
  const int C = a.c, q = threadIdx.x & 3;
  int tg[2];
  float sc[2];
  tg[0] = r0 < hi ? target_of(a, r0) : -1;
  tg[1] = r0 + 8 < hi ? target_of(a, r0 + 8) : -1;
  sc[0] = r0 < hi && valid_row(a, r0) ? dloss : 0.f;
  sc[1] = r0 + 8 < hi && valid_row(a, r0 + 8) ? dloss : 0.f;
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
}

// dskip = ds * dleaky(skip) of a warp's slab (ds: n tiles i0 .. i0 + 7 of
// dy W1^T, of ns), stored in float32 (leaky(skip) and skip have the same
// sign: lsk may be the slab's rows of skip)
__device__ __forceinline__ void store_dskip_f32(const HeadArgs& a,
                                                const float (&ds)[8][4],
                                                int ns, int i0, long r0,
                                                long hi, const float* lsk,
                                                int lds) {
  const int S = a.s;
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * (i0 + i) + 2 * q;
    if (i0 + i < ns && col < S) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long r = r0 + 8 * h;
        if (r >= hi) continue;
        const float* lr = lsk + (g + 8 * h) * lds + col;
        *reinterpret_cast<float2*>(a.dskip_f + r * S + col) = make_float2(
            ds[i][2 * h] * (lr[0] > 0.f ? 1.f : 0.01f),
            ds[i][2 * h + 1] * (lr[1] > 0.f ? 1.f : 0.01f));
      }
    }
  }
}

// The bias gradients of the block's partial from the warps' column sums cs
// (kWarps, 2, CP: db2 then db1), added in warp order
__device__ __forceinline__ void bias_partial_f32(const HeadArgs& a,
                                                 const float* cs, int CP) {
  const int S = a.s, C = a.c;
  float* out = a.part + blockIdx.x * a.n_el;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      s2 += cs[w * 2 * CP + c];
      s1 += cs[w * 2 * CP + CP + c];
    }
    out[S * C + c] = s1;
    out[S * C + C + C * C + c] = s2;
  }
}

// Backward: dz, dy, dskip and the bias gradients; leaky(y), dz and dy
// stored for head_wgrad_f32_kernel.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    head_bwd_f32_kernel(HeadArgs a) {
  const int S = a.s, C = a.c;
  const F32Head L(S, C);
  const int SP = L.sp, CP = L.cp, ldc = L.ldc, lds = L.lds;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w1s = reinterpret_cast<float*>(smem);   // (SP, ldc) W1, wrow
  float* w2s = w1s + SP * ldc;                    // (CP, ldc) W2, wrow
  float* b1 = w2s + CP * ldc;                     // (CP)
  float* cs = b1 + CP;   // (kWarps, 2, CP): each warp's db2, db1 sums
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  float* lsk = cs + kWarps * 2 * CP + warp * 16 * lds;   // (16, lds)
  stage_w_f32(a.w1, S, C, SP, CP, w1s, ldc);
  stage_w_f32(a.w2, C, C, CP, CP, w2s, ldc);
  for (int i = tid; i < CP; i += kThreads) b1[i] = i < C ? a.b1[i] : 0.f;
  for (int i = tid; i < kWarps * 2 * CP; i += kThreads) cs[i] = 0.f;
  __syncthreads();
  float* cs2 = cs + warp * 2 * CP;
  float* cs1 = cs2 + CP;
  const int nt = CP / 8, ns = SP / 8;
  const float dloss = a.dloss[0];
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi = min_l(lo + a.rows_per_block, a.m_total);
  for (long m0 = lo + 16 * warp; m0 < hi; m0 += 16 * kWarps) {
    const long r0 = m0 + g;
    stage_lskip_f32(a.skip_f, S, SP, m0, hi, lsk, lds);
    float y[NT][4];
    unsigned yp[(NT + 7) / 8];
    rebuild_y_f32<NT>(a, y, yp, nt, m0, hi, lsk, lds, w1s, ldc, b1);
    float d[NT][4];
    dz_from_p_f32<NT>(a, d, nt, r0, hi, dloss);
    colsum_add<NT>(d, nt, cs2);
    store_rows_f32<NT>(a.dz_f, CP, m0, hi, nt, d);
    // dy = dz W2^T * dleaky(y), into y
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) break;
      Frag<4> fa;
      a_from_c<true>(d[j], fa);
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        if (jn >= nt) break;
        Frag<2> fb;
        f32_b_wt(w2s, ldc, 8 * j, 8 * jn, fb);
        mma_split_add<true>(y[jn], fa, fb);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] *= dleaky_bit(yp, j, e);
    colsum_add<NT>(y, nt, cs1);
    store_rows_f32<NT>(a.dy_f, CP, m0, hi, nt, y);
    // dskip = dy W1^T * dleaky(skip), 8 n tiles at a time
    for (int i0 = 0; i0 < ns; i0 += 8) {
      float ds[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= nt) break;
        Frag<4> fa;
        a_from_c<true>(y[j], fa);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i0 + i >= ns) break;
          Frag<2> fb;
          f32_b_wt(w1s, ldc, 8 * j, 8 * (i0 + i), fb);
          mma_split_add<true>(ds[i], fa, fb);
        }
      }
      store_dskip_f32(a, ds, ns, i0, r0, hi, lsk, lds);
    }
  }
  __syncthreads();
  // partial: dw1 (S*C) | db1 (C) | dw2 (C*C) | db2 (C); the weight
  // gradients come from head_wgrad_f32_kernel
  bias_partial_f32(a, cs, CP);
}

// ---------------------- float32 at 128 < C <= 256 (W2 through a ring)
//
// The wide float32 kernels (head_fwd_f32_wide_kernel,
// head_bwd_f32_wide_kernel; 4 <= S <= 128, 128 < C <= 256, multiples of 4):
// W2 in float32 at C = 256 takes 270 KB with its row padding, more than a
// block's shared memory, so only W1 is staged once; W2 streams through a
// ring of two stages of kRing rows (cp.async, at rows wrow(k) as above)
// that all 8 warps walk in step, a barrier a stage.  The block takes 128
// rows at a time (a 16-row slab a warp; a warp past the block's rows
// takes zero rows and still keeps step).  Forward: stage s holds W2's rows
// [kRing s, + kRing), the k steps of z = leaky(y) W2 whose leaky(y)
// columns are formed from W1 just then, so z (NT = 32 n tiles, 128
// registers a lane) is summed in the order of the C <= 128 kernel; the
// rows' softmax, NLL and argmax are fwd_rows_f32, the plain-order argmax
// of a near-tied row reading W2 from global memory.  Backward: y rebuilt
// and dz formed as the C <= 128 kernel forms them (dz held in 128
// registers); stage s holds the rows of W2 that give dy's columns [kRing
// s, + kRing): dy = dz W2^T there, times dleaky(y), stored, its column
// sums added, and dskip += dy W1^T at once (dskip's 8 n tiles in
// registers).  The weight gradients are head_wgrad_f32_kernel's, as for C
// <= 128.  Above S = 64 (GS: the R = 128 trunk's skip width) W1 staged
// whole is 135,168 bytes at C = 256, so the warps stage no rows of
// leaky(skip): its fragments are read from global memory (f32_a_skip), as
// the bf16 forward's y_seq reads them above C = 128, and the plain-order
// re-sums read the row of skip there; the backward's dskip then runs in
// two halves of 8 n tiles after the ring, from the dy rows it stored (dy
// W1^T in the k order of the in-ring sums, so the same bits).
constexpr int kRing = 32;

// The float32 wide kernels' shared memory (ops/cuda/head_loss.f32_smem
// mirrors it): W1 (SP, ldc) at rows wrow(k), the ring (2, kRing, ldc),
// then the forward's b1, b2 (CP each), block sums (2, kThreads) and per warp
// its leaky(skip) rows (16, lds; none above S = 64) and a row of CP floats;
// the backward's b1, the warps' column sums (kWarps, 2, CP) and per warp
// its leaky(skip) rows (none above S = 64).
struct F32Wide {
  F32Head h;
  __host__ __device__ F32Wide(int s, int c) : h(s, c) {}
  // the rows of skip come from global memory (GS)
  __host__ __device__ bool gs() const { return h.sp > 64; }
  __host__ __device__ size_t ring() const {
    return static_cast<size_t>(2) * kRing * h.ldc;
  }
  __host__ __device__ size_t rows() const {
    return gs() ? 0 : static_cast<size_t>(16) * h.lds;
  }
  __host__ __device__ size_t fwd_bytes() const {
    return 4 * (static_cast<size_t>(h.sp) * h.ldc + ring() + 2 * h.cp +
                2 * kThreads + static_cast<size_t>(kWarps) * (rows() + h.cp));
  }
  __host__ __device__ size_t bwd_bytes() const {
    return 4 * (static_cast<size_t>(h.sp) * h.ldc + ring() + h.cp +
                static_cast<size_t>(kWarps) * 2 * h.cp +
                static_cast<size_t>(kWarps) * rows());
  }
};

// W2's rows [kRing slab, + kRing) into the ring stage dst by cp.async (one
// commit group), zero past C; the block's threads
__device__ __forceinline__ void ring_fetch(const float* w2, int C, int CP,
                                           int ldc, int slab, float* dst) {
  const int per = CP / 4;
  for (int i = threadIdx.x; i < kRing * per; i += kThreads) {
    const int kl = i / per, c4 = 4 * (i % per), k = kRing * slab + kl;
    const bool ok = k < C && c4 < C;
    cp_async16(dst + wrow(kl) * ldc + c4, ok ? w2 + k * C + c4 : w2, ok);
  }
  cp_async_commit();
}

template <int NT, bool GS>
__global__ void __launch_bounds__(kThreads, 1)
    head_fwd_f32_wide_kernel(HeadArgs a) {
  const int S = a.s, C = a.c;
  const F32Head L(S, C);
  const int SP = L.sp, CP = L.cp, ldc = L.ldc, lds = L.lds;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w1s = reinterpret_cast<float*>(smem);   // (SP, ldc) W1, wrow
  float* ring = w1s + SP * ldc;                   // (2, kRing, ldc) W2 rows
  float* b1 = ring + 2 * kRing * ldc;             // (CP)
  float* b2 = b1 + CP;                            // (CP)
  float* red = b2 + CP;                           // (2, kThreads)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nrow = GS ? 0 : 16 * lds;
  float* lsk = red + 2 * kThreads + warp * (nrow + CP);   // (16, lds)
  float* scr = lsk + nrow;                                 // (CP)
  const int nt = CP / 8, nslab = (CP + kRing - 1) / kRing;
  ring_fetch(a.w2, C, CP, ldc, 0, ring);
  stage_w_f32(a.w1, S, C, SP, CP, w1s, ldc);
  for (int i = tid; i < CP; i += kThreads) {
    b1[i] = i < C ? a.b1[i] : 0.f;
    b2[i] = i < C ? a.b2[i] : 0.f;
  }
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi = min_l(lo + a.rows_per_block, a.m_total);
  float loss = 0.f, match = 0.f;   // lanes q = 0, over the block's slabs
  int it = 0;                      // ring stages taken: stage it & 1
  for (long mb = lo; mb < hi; mb += 16 * kWarps) {
    const long m0 = mb + 16 * warp, r0 = m0 + g;
    if (!GS) stage_lskip_f32(a.skip_f, S, SP, m0, hi, lsk, lds);
    float z[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[j][e] = 0.f;
    for (int sl = 0; sl < nslab; ++sl, ++it) {
      // the stage has landed, and every warp is done with the other one
      cp_async_wait<0>();
      __syncthreads();
      ring_fetch(a.w2, C, CP, ldc, sl + 1 < nslab ? sl + 1 : 0,
                 ring + ((it + 1) & 1) * kRing * ldc);
      const float* w2s = ring + (it & 1) * kRing * ldc;
      for (int jl = 0; jl < kRing / 8; ++jl) {
        const int j = sl * (kRing / 8) + jl;   // y's n tile, z's k step
        if (j >= nt) break;
        float y[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 0; k0 < SP; k0 += 8) {
          Frag<4> fa;
          if (GS)
            f32_a_skip(a.skip_f, S, m0, hi, k0, fa);
          else
            f32_a_rows(lsk, lds, k0, fa);
          Frag<2> fb;
          f32_b_w(w1s, ldc, k0, 8 * j, fb);
          mma_split_add<true>(y, fa, fb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          y[e] = leaky(y[e] + b1[8 * j + 2 * q + (e & 1)]);
        Frag<4> fa;
        a_from_c<true>(y, fa);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
          if (jn < nt) {
            Frag<2> fb;
            f32_b_w(w2s, ldc, 8 * jl, 8 * jn, fb);
            mma_split_add<true>(z[jn], fa, fb);
          }
      }
    }
    if (GS)
      fwd_rows_f32<NT>(a, z, nt, r0, hi, a.skip_f + m0 * S, S, w1s, ldc,
                       a.w2, C, false, b1, b2, scr, loss, match, true);
    else
      fwd_rows_f32<NT>(a, z, nt, r0, hi, lsk, lds, w1s, ldc, a.w2, C, false,
                       b1, b2, scr, loss, match);
  }
  // the last stage fetched lands before the block's shared memory goes
  cp_async_wait<0>();
  __syncthreads();
  block_sums_f32(a, red, loss, match);
}

template <int NT, bool GS>
__global__ void __launch_bounds__(kThreads, 1)
    head_bwd_f32_wide_kernel(HeadArgs a) {
  const int S = a.s, C = a.c;
  const F32Head L(S, C);
  const int SP = L.sp, CP = L.cp, ldc = L.ldc, lds = L.lds;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w1s = reinterpret_cast<float*>(smem);   // (SP, ldc) W1, wrow
  float* ring = w1s + SP * ldc;                   // (2, kRing, ldc) W2 rows
  float* b1 = ring + 2 * kRing * ldc;             // (CP)
  float* cs = b1 + CP;   // (kWarps, 2, CP): each warp's db2, db1 sums
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, q = tid & 3;
  float* lsk = cs + kWarps * 2 * CP + warp * 16 * lds;   // (16, lds): !GS
  const int nt = CP / 8, ns = SP / 8, nslab = (CP + kRing - 1) / kRing;
  ring_fetch(a.w2, C, CP, ldc, 0, ring);
  stage_w_f32(a.w1, S, C, SP, CP, w1s, ldc);
  for (int i = tid; i < CP; i += kThreads) b1[i] = i < C ? a.b1[i] : 0.f;
  for (int i = tid; i < kWarps * 2 * CP; i += kThreads) cs[i] = 0.f;
  __syncthreads();
  float* cs2 = cs + warp * 2 * CP;
  float* cs1 = cs2 + CP;
  const float dloss = a.dloss[0];
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi = min_l(lo + a.rows_per_block, a.m_total);
  int it = 0;                      // ring stages taken: stage it & 1
  for (long mb = lo; mb < hi; mb += 16 * kWarps) {
    const long m0 = mb + 16 * warp, r0 = m0 + g;
    // the slab's leaky(skip) rows, or (GS) its rows of skip in place
    const float* lrows = GS ? a.skip_f + m0 * S : lsk;
    const int ldr = GS ? S : lds;
    if (!GS) stage_lskip_f32(a.skip_f, S, SP, m0, hi, lsk, lds);
    unsigned yp[(NT + 7) / 8];
    float d[NT][4];
    {
      float y[NT][4];
      rebuild_y_f32<NT, GS>(a, y, yp, nt, m0, hi, lrows, ldr, w1s, ldc, b1);
    }
    dz_from_p_f32<NT>(a, d, nt, r0, hi, dloss);
    colsum_add<NT>(d, nt, cs2);
    store_rows_f32<NT>(a.dz_f, CP, m0, hi, nt, d);
    float ds[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[i][e] = 0.f;
    for (int sl = 0; sl < nslab; ++sl, ++it) {
      cp_async_wait<0>();
      __syncthreads();
      ring_fetch(a.w2, C, CP, ldc, sl + 1 < nslab ? sl + 1 : 0,
                 ring + ((it + 1) & 1) * kRing * ldc);
      const float* w2s = ring + (it & 1) * kRing * ldc;
      for (int jl = 0; jl < kRing / 8; ++jl) {
        const int jn = sl * (kRing / 8) + jl;   // dy's n tile
        if (jn >= nt) break;
        // dy = dz W2^T * dleaky(y) over this n tile
        float dy[1][4] = {{0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j >= nt) break;
          Frag<4> fa;
          a_from_c<true>(d[j], fa);
          Frag<2> fb;
          f32_b_wt(w2s, ldc, 8 * j, 8 * jl, fb);
          mma_split_add<true>(dy[0], fa, fb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) dy[0][e] *= dleaky_bit(yp, jn, e);
        colsum_add<1>(dy, 1, cs1 + 8 * jn);
        store_rows_f32<1>(a.dy_f + 8 * jn, CP, m0, hi, 1, dy);
        if (GS) continue;
        // dskip += dy W1^T over this n tile's k step
        Frag<4> fa;
        a_from_c<true>(dy[0], fa);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i >= ns) break;
          Frag<2> fb;
          f32_b_wt(w1s, ldc, 8 * jn, 8 * i, fb);
          mma_split_add<true>(ds[i], fa, fb);
        }
      }
    }
    if (!GS) {
      store_dskip_f32(a, ds, ns, 0, r0, hi, lsk, lds);
      continue;
    }
    // GS: dskip = dy W1^T, 8 n tiles at a time, k (dy's n tiles) in order
    // from the dy rows the warp stored
    __syncwarp();
    for (int i0 = 0; i0 < ns; i0 += 8) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[i][e] = 0.f;
      for (int jn = 0; jn < nt; ++jn) {
        const int col = 8 * jn + 2 * q;
        float c4[4] = {0.f, 0.f, 0.f, 0.f};
        if (r0 < hi) {
          const float2 u =
              *reinterpret_cast<const float2*>(a.dy_f + r0 * CP + col);
          c4[0] = u.x;
          c4[1] = u.y;
        }
        if (r0 + 8 < hi) {
          const float2 u =
              *reinterpret_cast<const float2*>(a.dy_f + (r0 + 8) * CP + col);
          c4[2] = u.x;
          c4[3] = u.y;
        }
        Frag<4> fa;
        a_from_c<true>(c4, fa);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i0 + i >= ns) break;
          Frag<2> fb;
          f32_b_wt(w1s, ldc, 8 * jn, 8 * (i0 + i), fb);
          mma_split_add<true>(ds[i], fa, fb);
        }
      }
      store_dskip_f32(a, ds, ns, i0, r0, hi, lrows, ldr);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // partial: dw1 (S*C) | db1 (C) | dw2 (C*C) | db2 (C); the weight
  // gradients come from head_wgrad_f32_kernel
  bias_partial_f32(a, cs, CP);
}

// dW2 = leaky(y)^T dz (blocks x < tiles_n^2) and dW1 = leaky(skip)^T dy
// (the next tiles_n blocks) over the rows of split blockIdx.y (the
// backward's block ranges), split-TF32 on the tensor cores: a 64x64
// output tile a block, each warp 32x32, 32-row stages of float32 through
// shared memory (rows of 8 mod 32 floats) with the next stage's loads in
// flight.
constexpr int kWgLdf = kWgTile + 8;
__global__ void __launch_bounds__(kWgThreads)
    head_wgrad_f32_kernel(HeadArgs a, int tiles_n) {
  __shared__ __align__(16) float sa[kWgRows * kWgLdf];
  __shared__ __align__(16) float sb[kWgRows * kWgLdf];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3, wm = warp >> 1, wn = warp & 1;
  const int tiles2 = tiles_n * tiles_n;
  const bool is_w1 = static_cast<int>(blockIdx.x) >= tiles2;
  const int t = is_w1 ? blockIdx.x - tiles2 : blockIdx.x;
  const int m0 = (t / tiles_n) * kWgTile;   // dW1: SP / 64 row tiles
  const int n0 = (t % tiles_n) * kWgTile;
  const int S = a.s, C = a.c;
  const F32Head L(S, C);
  const int CP = L.cp, kc = is_w1 ? S : C, kcp = is_w1 ? L.sp : CP;
  const float* bsrc = is_w1 ? a.dy_f : a.dz_f;
  const long lo = blockIdx.y * a.rows_per_block;
  const long hi = min_l(lo + a.rows_per_block, a.m_total);
  float4 ra[4], rb[4];
  // a stage of rows [r, r + 32) into registers: A from leaky(y) or
  // leaky(skip), B from dz or dy, 4 floats an item
  auto load = [&](long r) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + kWgThreads * u, row = i >> 4, c4 = (i & 15) * 4;
      const bool in = r + row < hi;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (is_w1) {
        if (in && m0 + c4 < S) {
          v = *reinterpret_cast<const float4*>(a.skip_f + (r + row) * S + m0 +
                                               c4);
          v = make_float4(leaky(v.x), leaky(v.y), leaky(v.z), leaky(v.w));
        }
      } else if (in && m0 + c4 < CP) {
        v = *reinterpret_cast<const float4*>(a.ly_f + (r + row) * CP + m0 +
                                             c4);
      }
      ra[u] = v;
      rb[u] = in && n0 + c4 < CP
                  ? *reinterpret_cast<const float4*>(bsrc + (r + row) * CP +
                                                     n0 + c4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
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
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + kWgThreads * u, row = i >> 4, c4 = (i & 15) * 4;
      *reinterpret_cast<float4*>(sa + row * kWgLdf + c4) = ra[u];
      *reinterpret_cast<float4*>(sb + row * kWgLdf + c4) = rb[u];
    }
    __syncthreads();
    if (r + kWgRows < hi) load(r + kWgRows);
#pragma unroll
    for (int k0 = 0; k0 < kWgRows; k0 += 8) {
      Frag<4> fa[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (m0 + wm * 32 + mt * 16 < kcp)
          load_a_kmajor<true>(sa + k0 * kWgLdf + wm * 32 + mt * 16, kWgLdf,
                              fa[mt]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nb = wn * 32 + 8 * j;
        if (n0 + nb < CP) {
          Frag<2> fb;
          load_b_kmajor(sb + k0 * kWgLdf + nb, kWgLdf, fb);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (m0 + wm * 32 + mt * 16 < kcp)
              mma_split_add<true>(acc[mt][j], fa[mt], fb);
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

// The wide head's forms: the backward from S > 64 (no W1^T), the forward
// from S > 64 with C > 128 (no per-warp slabs of leaky(skip)).
bool wide_bwd(int s) { return pad16(s) > 64; }
bool wide_fwd(int s, int c) { return pad16(s) > 64 && pad16(c) > 128; }

// Shared memory of the unpacked kernels (see their layouts).
size_t fwd_smem(int s, int c) {
  const size_t sp = pad16(s), cp = pad16(c);
  return 2 * (cp * (sp + 8) + cp * (cp + 8) +
              (wide_fwd(s, c) ? 0 : kWarps * 16 * (sp + 8))) +
         4 * (2 * cp + 2 * kThreads);
}
size_t bwd_smem(int s, int c) {
  const size_t sp = pad16(s), cp = pad16(c);
  return 2 * ((wide_bwd(s) ? 0 : cp * (sp + 8)) + sp * (cp + 8) +
              cp * (cp + 8)) +
         4 * (cp + kWarps * 2 * cp) + 2 * kWarps * 16 * kBufLd;
}
// Shared memory of the packed kernels (S = C = 64; see their layouts):
// the weights and biases, then the forward's block sums, per-warp scratch
// and two skip slabs a warp, or the backward's ly, dz and dy tiles, two
// skip tiles and per-warp dskip rows.
size_t packed_smem(bool bwd) {
  const size_t common = (2 * kP * kPLd + 2 * kP) * 4;
  if (bwd)
    return common + 3 * kBwdRows * kPLd * 4 +
           (2 * kBwdRows + 16 * kWarps) * kPLdh * 2;
  return common + (2 * kThreads + kWarps * kP) * 4 +
         kWarps * 2 * 16 * kPLdh * 2;
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
// KS = 1, 4 or 8 k steps of skip.
template <typename F>
int dispatch(int sp, int cp, const F& f) {
  if (sp <= 16) {
    if (cp <= 64) return f.template run<8, 1>();
    if (cp <= 128) return f.template run<16, 1>();
    return f.template run<32, 1>();
  }
  if (sp <= 64) {
    if (cp <= 64) return f.template run<8, 4>();
    if (cp <= 128) return f.template run<16, 4>();
    return f.template run<32, 4>();
  }
  if (cp <= 64) return f.template run<8, 8>();
  if (cp <= 128) return f.template run<16, 8>();
  return f.template run<32, 8>();
}

struct FwdLaunch {
  const HeadArgs& a;
  int blocks;
  cudaStream_t st;
  template <int NT, int KS>   // the forward holds no skip fragments
  int run() const {
    return launch(head_fwd_kernel<NT, (KS > 4 && NT > 16)>, a,
                  fwd_smem(a.s, a.c), blocks, st);
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

// The float32 kernel instance for CP: NT = 4, 8 or 16 n tiles, or the
// wide kernels' 32 above 128.
template <typename F>
int dispatch_f32(int cp, const F& f) {
  if (cp <= 32) return f.template run<4>();
  if (cp <= 64) return f.template run<8>();
  if (cp <= 128) return f.template run<16>();
  return f.template run<32>();
}

struct FwdF32Launch {
  const HeadArgs& a;
  int blocks;
  cudaStream_t st;
  template <int NT>
  int run() const {
    if constexpr (NT > 16)
      return F32Wide(a.s, a.c).gs()
                 ? launch(head_fwd_f32_wide_kernel<NT, true>, a,
                          F32Wide(a.s, a.c).fwd_bytes(), blocks, st)
                 : launch(head_fwd_f32_wide_kernel<NT, false>, a,
                          F32Wide(a.s, a.c).fwd_bytes(), blocks, st);
    else
      return launch(head_fwd_f32_kernel<NT>, a,
                    F32Head(a.s, a.c).fwd_bytes(), blocks, st);
  }
};

struct BwdF32Launch {
  const HeadArgs& a;
  int blocks;
  cudaStream_t st;
  template <int NT>
  int run() const {
    if constexpr (NT > 16)
      return F32Wide(a.s, a.c).gs()
                 ? launch(head_bwd_f32_wide_kernel<NT, true>, a,
                          F32Wide(a.s, a.c).bwd_bytes(), blocks, st)
                 : launch(head_bwd_f32_wide_kernel<NT, false>, a,
                          F32Wide(a.s, a.c).bwd_bytes(), blocks, st);
    else
      return launch(head_bwd_f32_kernel<NT>, a,
                    F32Head(a.s, a.c).bwd_bytes(), blocks, st);
  }
};

// Dynamic shared memory of the float32 forward (bwd = 0) or backward (bwd =
// 1) at (s, c): the C <= 128 kernels' or the wide kernels'
size_t f32_bytes(int s, int c, bool bwd) {
  if (c > 128) {
    const F32Wide W(s, c);
    return bwd ? W.bwd_bytes() : W.fwd_bytes();
  }
  const F32Head L(s, c);
  return bwd ? L.bwd_bytes() : L.fwd_bytes();
}

bool f32_supports(int s, int c) {
  return s >= 4 && c >= 4 && s % 4 == 0 && c % 4 == 0 && s <= 128 &&
         c <= 256 && f32_bytes(s, c, false) <= kSmemLimit &&
         f32_bytes(s, c, true) <= kSmemLimit;
}

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

// 1 if the kernels take skip width s and c classes (4 <= S <= 128, 4 <= C
// <= 256, multiples of 4)
int movenet_head_supports(int s, int c) {
  return s >= 4 && c >= 4 && s % 4 == 0 && c % 4 == 0 && s <= 128 &&
         c <= 256 && fwd_smem(s, c) <= kSmemLimit &&
         bwd_smem(s, c) <= kSmemLimit;
}

// Dynamic shared memory a block of the packed forward (bwd = 0) or
// backward (bwd = 1) takes
long movenet_head_packed_smem(int bwd) {
  return static_cast<long>(packed_smem(bwd != 0));
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
                         blocks, 16, t_len, s, c, rf, parity, part);
  int err;
  if (packed) {
    err = launch(head_fwd_packed_kernel, a, packed_smem(false), blocks, st);
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
                         blocks, packed ? kBwdRows : 16, t_len, s, c, rf,
                         parity, part);
  a.dloss = dloss;
  a.dskip = dskip;
  int err;
  if (packed) {
    err = launch(head_bwd_packed_kernel, a, packed_smem(true), blocks, st);
  } else {
    a.p_in = p_in;
    a.ly = inter;
    a.dzr = inter + m * a.cp;
    a.dyr = inter + 2 * m * a.cp;
    err = dispatch(a.sp, a.cp, BwdLaunch{a, blocks, st});
    if (err) return err;
    const int tiles_n = (a.cp + kWgTile - 1) / kWgTile;
    const int tiles_s = (a.sp + kWgTile - 1) / kWgTile;
    head_wgrad_kernel<<<dim3(tiles_n * tiles_n + tiles_s * tiles_n, blocks),
                        kWgThreads, 0, st>>>(a, tiles_n);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err) return err;
  reduce_kernel<<<static_cast<int>((a.n_el + kThreads - 1) / kThreads),
                  kThreads, 0, st>>>(part, grads, a.n_el, blocks);
  return static_cast<int>(cudaGetLastError());
}

// 1 if the float32 kernels take skip width s and c classes (4 <= S <= 128,
// 4 <= C <= 256, multiples of 4)
int movenet_head_f32_supports(int s, int c) { return f32_supports(s, c); }

// Dynamic shared memory a block of the float32 forward (bwd = 0) or
// backward (bwd = 1) takes at (s, c)
long movenet_head_f32_smem(int s, int c, int bwd) {
  return static_cast<long>(f32_bytes(s, c, bwd != 0));
}

// float32 elements of the float32 backward's scratch (leaky(y), dz, dy)
// over m rows
long movenet_head_f32_inter(int s, int c, long m) {
  return 3L * m * F32Head(s, c).cp;
}

// The float32 forward: out[0] = loss sum, out[1] = match count; p_out may
// be null.  part holds `blocks` x 2 floats.
int movenet_head_fwd_f32(const float* skip, const int* pack, int pack_cols,
                         int tgt_off, const float* w1, const float* b1,
                         const float* w2, const float* b2, float* p_out,
                         float* part, float* out, int batch, int t_len, int s,
                         int c, int rf, int parity, int blocks,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!f32_supports(s, c)) return static_cast<int>(cudaErrorInvalidValue);
  const long m = static_cast<long>(batch) * t_len;
  HeadArgs a = make_args(nullptr, pack, pack_cols, tgt_off, w1, b1, w2, b2,
                         m, blocks, 16, t_len, s, c, rf, parity, part);
  a.skip_f = skip;
  a.p_out = p_out;
  int err = dispatch_f32(F32Head(s, c).cp, FwdF32Launch{a, blocks, st});
  if (err) return err;
  reduce_kernel<<<1, kThreads, 0, st>>>(part, out, 2, blocks);
  return static_cast<int>(cudaGetLastError());
}

// The float32 backward: dskip (float32), grads = dw1 (S*C) | db1 (C) | dw2
// (C*C) | db2 (C); part holds `blocks` x that many floats, inter
// movenet_head_f32_inter floats.
int movenet_head_bwd_f32(const float* skip, const int* pack, int pack_cols,
                         int tgt_off, const float* p_in, const float* w1,
                         const float* b1, const float* w2, const float* b2,
                         const float* dloss, float* dskip, float* inter,
                         float* part, float* grads, int batch, int t_len,
                         int s, int c, int rf, int parity, int blocks,
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!f32_supports(s, c) || !p_in || !inter)
    return static_cast<int>(cudaErrorInvalidValue);
  const long m = static_cast<long>(batch) * t_len;
  HeadArgs a = make_args(nullptr, pack, pack_cols, tgt_off, w1, b1, w2, b2,
                         m, blocks, 16, t_len, s, c, rf, parity, part);
  const int cp = F32Head(s, c).cp;
  a.skip_f = skip;
  a.dskip_f = dskip;
  a.dloss = dloss;
  a.p_in = p_in;
  a.ly_f = inter;
  a.dz_f = inter + m * cp;
  a.dy_f = inter + 2 * m * cp;
  int err = dispatch_f32(cp, BwdF32Launch{a, blocks, st});
  if (err) return err;
  const int tiles_n = (cp + kWgTile - 1) / kWgTile;
  const int tiles_s = (F32Head(s, c).sp + kWgTile - 1) / kWgTile;
  head_wgrad_f32_kernel<<<dim3(tiles_n * tiles_n + tiles_s * tiles_n,
                               blocks),
                          kWgThreads, 0, st>>>(a, tiles_n);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_kernel<<<static_cast<int>((a.n_el + kThreads - 1) / kThreads),
                  kThreads, 0, st>>>(part, grads, a.n_el, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
