// One gated residual block of the training step, forward and backward.
//
// Replaces the TPU kernels movenet_tpu/ops/pallas/gated_block.py:
//   _fwd_kernel (gated_block.py:91, pallas_call at :146): fg = [h | h(t-d)
//     | ctx] W_fg + b_fg[b], gated = tanh(f) sigmoid(g), out = gated W_out
//     + b_out, res = out[:, :R] + h and skip = out[:, R:], both rounded to
//     bf16; every product on float32 operands (_dot, not _mdot);
//   _bwd_kernel (gated_block.py:168, pallas_call at :297): its VJP, with fg
//     recomputed from h.
// Only the bf16 storage dtype is built here.
//
// Products.  Every product takes float32 operands, as on the TPU, and runs
// on the tensor cores as split-TF32 mma.sync m16n8k8 (mma_tf32.cuh): a
// float32 operand is split into big + small TF32 parts as its fragments
// load; bf16 values ([h | h(t-d) | ctx], dres, dskip) are exact in TF32
// and take no split.  Passes: fg = hp W_fg 2, out = gated W_out 3 (gated
// is the unrounded float32 tanh * sigmoid), dgated = dout W_out^T 2,
// dfg_w = dfg W_fg^T 3, dW_fg = hp^T dfg 2, dW_out = gated^T dout 2.  No
// product keeps fmaf.  The sums run in another order than the plain
// version's (k in 8-wide steps, the passes small terms first), within
// float32 accuracy of it.
//
// Design.  The TPU walks one batch row's time tiles in order and carries
// the last d rows of h (forward) and the anti-causal dfg_past rows
// (backward) from tile to tile in a VMEM ring.  Blocks here run in no
// order, so nothing is carried between them; tiles are 64 rows of one
// batch row, the tap h(t-d) read back from h (zero for t < d).
//   forward   persistent blocks, one an SM, stage W_fg and
//             W_out in shared memory once as float32 and walk the tiles;
//             each tile's [h | h(t-d) | ctx] (bf16) arrives by cp.async
//             into one of two buffers while the other computes.  A warp
//             takes 16 MT rows and a share of the columns: fg for its
//             filter and gate columns, gated = tf * sg into shared memory,
//             then out for its share of R + S.  res and skip are rounded
//             into the tile's own rows of the buffer and stored 16 bytes a
//             thread.
//   backward  the layer launch: the same blocks and weights.  Per tile, fg
//             recomputed (tf and sg in registers), gated stored (float32),
//             dgated from dout = [dres | dskip] (bf16) against W_out^T, dfg
//             stored (float32) and kept in shared memory; then dfg_w = dfg
//             W_fg^T while the next tile's operands arrive: dh's own part
//             (dres + dfg_w_h) and the past part dfg_w_p in float32, dctx
//             in bf16.  W^T fragments read the same shared copies, k paired
//             (a lane's two k values adjacent).  A carry launch forms dh[t]
//             = own[t] + past[t + d] across blocks.  The weight-gradient
//             launch (twice: W_fg, W_out) walks each (batch, chunk) range of
//             rows 64 at a time, its tile of the sum in registers, and
//             writes one partial per block with the bias sums (db_fg per
//             batch row); a fixed-order reduction adds the partials:
//             deterministic, no atomics.
//
// Bound (R = S = 64, B = 2, T = 160000, flat ctx; M = 320000 rows): the
// forward's products are 2 M (3R 2R + R (R+S)) = 2.1e10 operations, 0.042
// ms at the 495 TF/s of TF32 counted once, under its 164 MB of
// compulsory traffic (h, ctx, res, skip: 0.049 ms): bound by bytes.  The
// backward's (fg again, dgated, dfg_w, both weight gradients) are 5.8e10,
// 0.117 ms, over its 246 MB (0.073 ms): bound by operations.  The split
// passes (2-3 a product) are the design's cost; beside the compulsory
// traffic the backward moves dfg, gated, own and past through global
// memory in float32 (about 1.2 GB a call at that shape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;   // the weight-gradient and helper grids
constexpr int kRows = 64;       // rows a tile, all of one batch row
typedef unsigned short bf16_t;

__device__ __forceinline__ bf16_t f2bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return static_cast<unsigned>(f2bf(lo)) |
         (static_cast<unsigned>(f2bf(hi)) << 16);
}
__device__ __forceinline__ float sigmoidf(float g) {
  return 1.f / (1.f + expf(-g));
}
__device__ __forceinline__ unsigned ld32(const bf16_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}
// a bf16 value as the float32 (exact in TF32) the tensor core reads
__device__ __forceinline__ unsigned bf_bits(bf16_t v) {
  return static_cast<unsigned>(v) << 16;
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

// The layer launches' shapes: kWarps warps a block, one block an SM.  A
// warp takes MT 16-row m tiles of the 64-row tile (MW warps down the
// rows) and 1 / NW of each product's
// columns: FT filter and FT gate n tiles of fg (and as many of dgated),
// out's n tiles wn, wn + NW, ...  Row strides keep each warp's fragment
// loads in distinct banks: k-major float32 rows 8 mod 32 floats (lanes
// (q, g) at 8q + g; the paired W^T loads, 8 bytes at 8g + 2q, one half
// warp at a time), gated rows 4 mod 32 (4g + q), bf16 rows 8 mod 16
// elements times an odd number (words 4g * odd + q).
template <int R, int S>
struct Shape {
  static constexpr int kNo = R + S;
  static constexpr int kWarps = 8, kThreads = 32 * kWarps;
  static constexpr int kMt = kWarps == 16 || R < 32 ? 1 : 2;
  static constexpr int kMw = 4 / kMt;
  static constexpr int kNw = kWarps / kMw;
  static constexpr int kFt = R / 8 / kNw;
  static constexpr int kOt = (kNo / 8 + kNw - 1) / kNw;
  static constexpr int kPt = 3 * R / 8 / kNw;   // dfg_w n tiles, at most
  static constexpr int kLdf = 2 * R + 8;        // W_fg rows, dfg rows
  static constexpr int kLdo = (kNo + 31) / 32 * 32 + 8;   // W_out rows
  static constexpr int kLdg = R + 4;            // gated rows
  static constexpr int kLdd = (kNo + 15) / 16 * 16 + 8;   // dout rows (bf16)
  static_assert(R % 16 == 0 && S % 8 == 0 && kFt >= 1 &&
                    kMw * kNw == kWarps,
                "the warps over 16-row, 8-column tiles");
  __host__ __device__ static int ldh(int win) { return win + 8; }
  static size_t weights(int win) {
    return static_cast<size_t>(win * kLdf + R * kLdo) * 4;
  }
  static size_t fwd_smem(int win) {
    return weights(win) + static_cast<size_t>(2 * kRows * ldh(win)) * 2 +
           static_cast<size_t>(kRows * kLdg) * 4;
  }
  static size_t bwd_smem(int win) {
    return weights(win) +
           static_cast<size_t>(kRows * (ldh(win) + kLdd)) * 2 +
           static_cast<size_t>(kRows * kLdf) * 4;
  }
};

struct Tile {
  int b, t0, rows;
  long m0;   // row b * T + t0
};
__device__ __forceinline__ Tile tile_at(long i, int n_tb, int t_len) {
  Tile t;
  t.b = static_cast<int>(i / n_tb);
  t.t0 = static_cast<int>(i % n_tb) * kRows;
  t.rows = min(kRows, t_len - t.t0);
  t.m0 = static_cast<long>(t.b) * t_len + t.t0;
  return t;
}

// W_fg (win, 2R) and W_out (R, R+S) into shared memory as they lie in
// global memory, rows padded to LDF and LDO floats
template <int R, int S>
__device__ void stage_weights(float* wf, float* wo, const float* w_fg,
                              const float* w_out, int win) {
  using Sh = Shape<R, S>;
  constexpr int NO = Sh::kNo;
  for (int i = threadIdx.x; i < win * (R / 2); i += Sh::kThreads) {
    const int k = i / (R / 2), c4 = 4 * (i % (R / 2));
    *reinterpret_cast<float4*>(wf + k * Sh::kLdf + c4) =
        __ldg(reinterpret_cast<const float4*>(w_fg + k * 2 * R + c4));
  }
  for (int i = threadIdx.x; i < R * (NO / 4); i += Sh::kThreads) {
    const int k = i / (NO / 4), c4 = 4 * (i % (NO / 4));
    *reinterpret_cast<float4*>(wo + k * Sh::kLdo + c4) =
        __ldg(reinterpret_cast<const float4*>(w_out + k * NO + c4));
  }
}

// [h | h(t-d) | ctx] of kRows rows from row m0 = b T + t0 into hp (bf16,
// row stride ldh) by cp.async, per_row 16-byte items a row: zero at or
// past `rows`, and for the tap before t = d.  THREADS threads take part.
template <int R, int THREADS = kThreads>
__device__ __forceinline__ void stage_hp(bf16_t* hp, int ldh, const bf16_t* h,
                                         const bf16_t* ctx, long m0, int t0,
                                         int rows, int d, int per_row) {
  for (int i = threadIdx.x; i < kRows * per_row; i += THREADS) {
    const int row = i / per_row, c8 = 8 * (i % per_row);
    const int part = c8 / R, j0 = c8 % R;
    const long m = m0 + row;
    bool ok = row < rows;
    const bf16_t* src = h + m * R + j0;
    if (part == 1) {
      ok = ok && t0 + row >= d;
      src -= static_cast<long>(d) * R;
    } else if (part == 2) {
      src = ctx + m * R + j0;
    }
    cp_async16(hp + row * ldh + c8, ok ? src : h, ok);
  }
}

// [dres | dskip] of kRows rows from row m0 into dd (bf16, row stride LD),
// zero at or past `rows`
template <int R, int S, int LD, int THREADS = kThreads>
__device__ __forceinline__ void stage_dout(bf16_t* dd, const bf16_t* dres,
                                           const bf16_t* dskip, long m0,
                                           int rows) {
  constexpr int PER = (R + S) / 8;
  for (int i = threadIdx.x; i < kRows * PER; i += THREADS) {
    const int row = i / PER, c8 = 8 * (i % PER);
    const long m = m0 + row;
    const bf16_t* src = c8 < R ? dres + m * R + c8 : dskip + m * S + c8 - R;
    cp_async16(dd + row * LD + c8, row < rows ? src : dres, row < rows);
  }
}

// kRows float32 rows (N wide) from row m0 of src into buf (row stride LD),
// zero at or past `rows`
template <int N, int LD>
__device__ __forceinline__ void stage_f32(float* buf, const float* src,
                                          long m0, int rows) {
  for (int i = threadIdx.x; i < kRows * (N / 4); i += kThreads) {
    const int row = i / (N / 4), c4 = 4 * (i % (N / 4));
    cp_async16(buf + row * LD + c4,
               row < rows ? src + (m0 + row) * N + c4 : src, row < rows);
  }
}

// ------------------------------------------------------- fragments
// The A fragment (16 x 8) of bf16 values at p, element (row i, k) at
// p[i * ld + k]: exact in TF32, no split.
__device__ __forceinline__ void load_a_bf16(const bf16_t* p, int ld,
                                            Frag<4>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  f.big[0] = bf_bits(p[g * ld + q]);
  f.big[1] = bf_bits(p[(g + 8) * ld + q]);
  f.big[2] = bf_bits(p[g * ld + q + 4]);
  f.big[3] = bf_bits(p[(g + 8) * ld + q + 4]);
}
// the same, k-major: element (row i, k) at p[k * ld + i]
__device__ __forceinline__ void load_a_kmajor_bf16(const bf16_t* p, int ld,
                                                   Frag<4>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  f.big[0] = bf_bits(p[q * ld + g]);
  f.big[1] = bf_bits(p[q * ld + g + 8]);
  f.big[2] = bf_bits(p[(q + 4) * ld + g]);
  f.big[3] = bf_bits(p[(q + 4) * ld + g + 8]);
}
// The B fragment (8 x 8) of bf16 values, element (k, column j) at
// p[k * ld + j]: exact, no split.
__device__ __forceinline__ void load_b_kmajor_bf16(const bf16_t* p, int ld,
                                                   Frag<2>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  f.big[0] = bf_bits(p[q * ld + g]);
  f.big[1] = bf_bits(p[(q + 4) * ld + g]);
}

// Paired k: the fragments of an 8-wide k step with slot q holding k = 2q
// and slot q + 4 holding k = 2q + 1 (A and B alike, so the sum over k is
// the same), so that a lane's two k values are adjacent in memory.
// A from bf16 rows at p (element (i, k) at p[i * ld + k]; exact):
__device__ __forceinline__ void load_a_pairs_bf16(const bf16_t* p, int ld,
                                                  Frag<4>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const unsigned lo = ld32(p + g * ld + 2 * q);
  const unsigned hi = ld32(p + (g + 8) * ld + 2 * q);
  f.big[0] = lo << 16;
  f.big[1] = hi << 16;
  f.big[2] = lo & 0xffff0000u;
  f.big[3] = hi & 0xffff0000u;
}
// A from float32 rows at p, split
__device__ __forceinline__ void load_a_pairs(const float* p, int ld,
                                             Frag<4>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float2 u = *reinterpret_cast<const float2*>(p + g * ld + 2 * q);
  const float2 v = *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * q);
  const float x[4] = {u.x, v.x, u.y, v.y};
  frag_set<true>(f, x);
}
// B of a transposed weight, element (k, column j) at p[j * ld + k]: lane
// (g, q) holds (2q, g) and (2q + 1, g), split
__device__ __forceinline__ void load_b_pairs(const float* p, int ld,
                                             Frag<2>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float2 u = *reinterpret_cast<const float2*>(p + g * ld + 2 * q);
  const float x[2] = {u.x, u.y};
  frag_set<true>(f, x);
}

// d += a b where a is split and b exact in TF32: two passes, the small
// term first
__device__ __forceinline__ void mma_split_a(float* d, const Frag<4>& a,
                                            const Frag<2>& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.big);
}

// fg = [h | h(t-d) | ctx] W_fg for MT m tiles from row r0 of hp (bf16, row
// stride ldh) and the warp's FT filter n tiles at columns c0 + 8j and FT
// gate n tiles at R + c0 + 8j: acc[mt][j] (filter) and acc[mt][FT + j]
// (gate).  hp exact, W_fg split: two passes; k over W_in in order.
template <int R, int MT, int FT, int LDF>
__device__ __forceinline__ void fg_tile(float (&acc)[MT][2 * FT][4],
                                        const bf16_t* hp, int ldh, int win,
                                        const float* wf, int r0, int c0) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * FT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < win; k0 += 8) {
    Frag<4> fa[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      load_a_bf16(hp + (r0 + 16 * mt) * ldh + k0, ldh, fa[mt]);
#pragma unroll
    for (int j = 0; j < 2 * FT; ++j) {
      const int n = j < FT ? c0 + 8 * j : R + c0 + 8 * (j - FT);
      Frag<2> fb;
      load_b_kmajor(wf + k0 * LDF + n, LDF, fb);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_split<false>(acc[mt][j], fa[mt], fb);
    }
  }
}

// ------------------------------------------------------------ forward
struct GatedArgs {
  const bf16_t* h;       // (B, T, R)
  const bf16_t* ctx;     // (B, T, R) or null
  const float* b_fg;     // (B, 2R)
  const float* w_fg;     // (W_in, 2R)
  const float* w_out;    // (R, R+S)
  const float* b_out;    // (R+S)
  bf16_t* res;           // (B, T, R)
  bf16_t* skip;          // (B, T, S)
  int batch, t_len, d;
};

template <int R, int S>
__global__ void __launch_bounds__(Shape<R, S>::kThreads, 1)
    gated_fwd_kernel(GatedArgs a) {
  using Sh = Shape<R, S>;
  constexpr int NO = Sh::kNo, LDF = Sh::kLdf, LDO = Sh::kLdo;
  constexpr int LDG = Sh::kLdg, MT = Sh::kMt, MW = Sh::kMw, NW = Sh::kNw;
  constexpr int FT = Sh::kFt, OT = Sh::kOt, NTH = Sh::kThreads;
  const int win = a.ctx ? 3 * R : 2 * R, ldh = Sh::ldh(win);
  extern __shared__ __align__(16) unsigned char smem[];
  float* wf = reinterpret_cast<float*>(smem);    // (win, LDF) W_fg
  float* wo = wf + win * LDF;                      // (R, LDO) W_out
  bf16_t* hb0 = reinterpret_cast<bf16_t*>(wo + R * LDO);   // two tiles of
  bf16_t* hb1 = hb0 + kRows * ldh;                 // (kRows, ldh) operands
  float* gs = reinterpret_cast<float*>(hb1 + kRows * ldh);   // (kRows, LDG)
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int q = threadIdx.x & 3, wm = warp % MW, wn = warp / MW;
  const int r0 = wm * 16 * MT, c0 = wn * FT * 8;
  const int n_tb = (a.t_len + kRows - 1) / kRows;
  const long n_tiles = static_cast<long>(a.batch) * n_tb;

  stage_weights<R, S>(wf, wo, a.w_fg, a.w_out, win);
  long i = blockIdx.x;
  if (i < n_tiles) {
    const Tile t = tile_at(i, n_tb, a.t_len);
    stage_hp<R, NTH>(hb0, ldh, a.h, a.ctx, t.m0, t.t0, t.rows, a.d,
                     win / 8);
  }
  cp_async_commit();
  for (int buf = 0; i < n_tiles; i += gridDim.x, buf ^= 1) {
    const Tile t = tile_at(i, n_tb, a.t_len);
    bf16_t* x = buf ? hb1 : hb0;
    if (i + gridDim.x < n_tiles) {
      const Tile u = tile_at(i + gridDim.x, n_tb, a.t_len);
      stage_hp<R, NTH>(buf ? hb0 : hb1, ldh, a.h, a.ctx, u.m0, u.t0, u.rows,
                       a.d, win / 8);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this tile's operands
    __syncthreads();

    // fg, then gated = tanh(f) sigmoid(g) into gs
    {
      const float* bfg = a.b_fg + static_cast<long>(t.b) * 2 * R;
      float acc[MT][2 * FT][4];
      fg_tile<R, MT, FT, LDF>(acc, x, ldh, win, wf, r0, c0);
#pragma unroll
      for (int j = 0; j < FT; ++j) {
        const int c = c0 + 8 * j + 2 * q;
        const float bf[2] = {__ldg(bfg + c), __ldg(bfg + c + 1)};
        const float bg[2] = {__ldg(bfg + R + c), __ldg(bfg + R + c + 1)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = r0 + 16 * mt + g + 8 * e;
            float v[2];
#pragma unroll
            for (int k = 0; k < 2; ++k)
              v[k] = tanhf(acc[mt][j][2 * e + k] + bf[k]) *
                     sigmoidf(acc[mt][FT + j][2 * e + k] + bg[k]);
            *reinterpret_cast<float2*>(gs + row * LDG + c) =
                make_float2(v[0], v[1]);
          }
      }
    }
    __syncthreads();

    // out = gated W_out (three passes); res = out + b_out + h and skip =
    // out + b_out, rounded to bf16, into the tile's rows of x (each value
    // where its lane read h; the taps are not read again)
    {
      float acc[MT][OT][4] = {};
#pragma unroll 2
      for (int k0 = 0; k0 < R; k0 += 8) {
        Frag<4> fa[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          load_a_rows<true>(gs + (r0 + 16 * mt) * LDG + k0, LDG, fa[mt]);
#pragma unroll
        for (int jj = 0; jj < OT; ++jj) {
          const int n = 8 * (wn + NW * jj);
          if (n < NO) {
            Frag<2> fb;
            load_b_kmajor(wo + k0 * LDO + n, LDO, fb);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_split<true>(acc[mt][jj], fa[mt], fb);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < OT; ++jj) {
        const int c = 8 * (wn + NW * jj) + 2 * q;
        if (c >= NO) continue;
        const float bo[2] = {__ldg(a.b_out + c), __ldg(a.b_out + c + 1)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bf16_t* p = x + (r0 + 16 * mt + g + 8 * e) * ldh + c;
            float v0 = acc[mt][jj][2 * e] + bo[0];
            float v1 = acc[mt][jj][2 * e + 1] + bo[1];
            if (c < R) {
              const unsigned hv = ld32(p);
              v0 += __uint_as_float(hv << 16);
              v1 += __uint_as_float(hv & 0xffff0000u);
            }
            *reinterpret_cast<unsigned*>(p) = pack2(v0, v1);
          }
      }
    }
    __syncthreads();
    for (int u = threadIdx.x; u < t.rows * (NO / 8); u += NTH) {
      const int row = u / (NO / 8), c8 = 8 * (u % (NO / 8));
      const uint4 v = *reinterpret_cast<const uint4*>(x + row * ldh + c8);
      const long m = t.m0 + row;
      if (c8 < R)
        *reinterpret_cast<uint4*>(a.res + m * R + c8) = v;
      else
        *reinterpret_cast<uint4*>(a.skip + m * S + c8 - R) = v;
    }
    __syncthreads();   // x is staged again two tiles on
  }
}

// ----------------------------------------------------------- backward
struct GatedBwdArgs {
  const bf16_t* h;       // (B, T, R)
  const bf16_t* ctx;     // (B, T, R) or null
  const float* b_fg;     // (B, 2R)
  const float* w_fg;     // (W_in, 2R)
  const float* w_out;    // (R, R+S)
  const bf16_t* dres;    // (B, T, R)
  const bf16_t* dskip;   // (B, T, S)
  float* own;            // (B, T, R) dres + dfg_w_h
  float* past;           // (B, T, R) dfg_w_p
  bf16_t* dctx;          // (B, T, R) or null
  float* dfg;            // (B, T, 2R)
  float* gated;          // (B, T, R)
  int batch, t_len, d;
};

template <int R, int S>
__global__ void __launch_bounds__(Shape<R, S>::kThreads, 1)
    gated_bwd_kernel(GatedBwdArgs a) {
  using Sh = Shape<R, S>;
  constexpr int NO = Sh::kNo, LDF = Sh::kLdf, LDO = Sh::kLdo;
  constexpr int LDD = Sh::kLdd, MT = Sh::kMt, MW = Sh::kMw, NW = Sh::kNw;
  constexpr int FT = Sh::kFt, PT = Sh::kPt, NTH = Sh::kThreads;
  const int win = a.ctx ? 3 * R : 2 * R, ldh = Sh::ldh(win);
  const int np = win / 8 / NW;   // dfg_w n tiles of a warp
  extern __shared__ __align__(16) unsigned char smem[];
  float* wf = reinterpret_cast<float*>(smem);    // (win, LDF) W_fg
  float* wo = wf + win * LDF;                      // (R, LDO) W_out
  bf16_t* x = reinterpret_cast<bf16_t*>(wo + R * LDO);   // (kRows, ldh)
  bf16_t* dd = x + kRows * ldh;                    // (kRows, LDD) dout
  float* ff = reinterpret_cast<float*>(dd + kRows * LDD);   // (kRows, LDF)
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int q = threadIdx.x & 3, wm = warp % MW, wn = warp / MW;
  const int r0 = wm * 16 * MT, c0 = wn * FT * 8, p0 = wn * np * 8;
  const int n_tb = (a.t_len + kRows - 1) / kRows;
  const long n_tiles = static_cast<long>(a.batch) * n_tb;

  stage_weights<R, S>(wf, wo, a.w_fg, a.w_out, win);
  long i = blockIdx.x;
  if (i < n_tiles) {
    const Tile t = tile_at(i, n_tb, a.t_len);
    stage_hp<R, NTH>(x, ldh, a.h, a.ctx, t.m0, t.t0, t.rows, a.d,
                     win / 8);
    stage_dout<R, S, LDD, NTH>(dd, a.dres, a.dskip, t.m0, t.rows);
  }
  cp_async_commit();
  for (; i < n_tiles; i += gridDim.x) {
    const Tile t = tile_at(i, n_tb, a.t_len);
    cp_async_wait<0>();
    __syncthreads();

    // fg recomputed: tf and sg in place of its sums; gated out; dgated =
    // dout W_out^T (dout exact: two passes); dfg into ff and out
    {
      const float* bfg = a.b_fg + static_cast<long>(t.b) * 2 * R;
      float acc[MT][2 * FT][4];
      fg_tile<R, MT, FT, LDF>(acc, x, ldh, win, wf, r0, c0);
#pragma unroll
      for (int j = 0; j < FT; ++j) {
        const int c = c0 + 8 * j + 2 * q;
        const float bf[2] = {__ldg(bfg + c), __ldg(bfg + c + 1)};
        const float bg[2] = {__ldg(bfg + R + c), __ldg(bfg + R + c + 1)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][j][e] = tanhf(acc[mt][j][e] + bf[e & 1]);
            acc[mt][FT + j][e] = sigmoidf(acc[mt][FT + j][e] + bg[e & 1]);
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = r0 + 16 * mt + g + 8 * e;
            if (row < t.rows)
              *reinterpret_cast<float2*>(a.gated + (t.m0 + row) * R + c) =
                  make_float2(acc[mt][j][2 * e] * acc[mt][FT + j][2 * e],
                              acc[mt][j][2 * e + 1] *
                                  acc[mt][FT + j][2 * e + 1]);
          }
      }
      float dg[MT][FT][4] = {};
#pragma unroll 2
      for (int k0 = 0; k0 < NO; k0 += 8) {
        Frag<4> fa[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          load_a_pairs_bf16(dd + (r0 + 16 * mt) * LDD + k0, LDD, fa[mt]);
#pragma unroll
        for (int j = 0; j < FT; ++j) {
          Frag<2> fb;
          load_b_pairs(wo + (c0 + 8 * j) * LDO + k0, LDO, fb);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_split<false>(dg[mt][j], fa[mt], fb);
        }
      }
#pragma unroll
      for (int j = 0; j < FT; ++j) {
        const int c = c0 + 8 * j + 2 * q;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = r0 + 16 * mt + g + 8 * e;
            float df[2], dq[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const float tf = acc[mt][j][2 * e + k];
              const float sg = acc[mt][FT + j][2 * e + k];
              const float d = dg[mt][j][2 * e + k];
              df[k] = d * sg * (1.f - tf * tf);
              dq[k] = d * tf * sg * (1.f - sg);
            }
            const float2 vf = make_float2(df[0], df[1]);
            const float2 vq = make_float2(dq[0], dq[1]);
            *reinterpret_cast<float2*>(ff + row * LDF + c) = vf;
            *reinterpret_cast<float2*>(ff + row * LDF + R + c) = vq;
            if (row < t.rows) {
              float* p = a.dfg + (t.m0 + row) * 2 * R + c;
              *reinterpret_cast<float2*>(p) = vf;
              *reinterpret_cast<float2*>(p + R) = vq;
            }
          }
      }
    }
    __syncthreads();
    // the next tile's operands, in flight while dfg_w is formed
    if (i + gridDim.x < n_tiles) {
      const Tile u = tile_at(i + gridDim.x, n_tb, a.t_len);
      stage_hp<R, NTH>(x, ldh, a.h, a.ctx, u.m0, u.t0, u.rows, a.d,
                       win / 8);
      stage_dout<R, S, LDD, NTH>(dd, a.dres, a.dskip, u.m0, u.rows);
    }
    cp_async_commit();

    // dfg_w = dfg W_fg^T (three passes) over the warp's np n tiles of
    // W_in: dh's own part (dres added), the past part, dctx
    {
      float acc[MT][PT][4] = {};
#pragma unroll 2
      for (int k0 = 0; k0 < 2 * R; k0 += 8) {
        Frag<4> fa[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          load_a_pairs(ff + (r0 + 16 * mt) * LDF + k0, LDF, fa[mt]);
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          if (j < np) {
            Frag<2> fb;
            load_b_pairs(wf + (p0 + 8 * j) * LDF + k0, LDF, fb);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_split<true>(acc[mt][j], fa[mt], fb);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        if (j >= np) continue;
        const int cw = p0 + 8 * j + 2 * q, part = cw / R, c = cw % R;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = r0 + 16 * mt + g + 8 * e;
            if (row >= t.rows) continue;
            const long m = t.m0 + row;
            const float x0 = acc[mt][j][2 * e], x1 = acc[mt][j][2 * e + 1];
            if (part == 0) {
              const unsigned dv = ld32(a.dres + m * R + c);
              *reinterpret_cast<float2*>(a.own + m * R + c) =
                  make_float2(__uint_as_float(dv << 16) + x0,
                              __uint_as_float(dv & 0xffff0000u) + x1);
            } else if (part == 1) {
              *reinterpret_cast<float2*>(a.past + m * R + c) =
                  make_float2(x0, x1);
            } else {
              *reinterpret_cast<unsigned*>(a.dctx + m * R + c) =
                  pack2(x0, x1);
            }
          }
      }
    }
  }
}

// dh[t] = own[t] + past[t + d] (zero past T), rounded to bf16
__global__ void __launch_bounds__(kThreads)
    gated_carry_kernel(const float* own, const float* past, int d, int t_len,
                       int r, long total, bf16_t* dh) {
  for (long i = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x;
       i < total; i += static_cast<long>(gridDim.x) * kThreads) {
    const long m = i / r;
    float v = own[i];
    if (static_cast<int>(m % t_len) + static_cast<long>(d) < t_len)
      v += past[i + static_cast<long>(d) * r];
    dh[i] = f2bf(v);
  }
}

// ---------------------------------------------- weight gradients
// C = sum over rows of A^T B and colsum(B), per (batch, chunk) range of
// rows; blockIdx.x = batch * chunks + chunk.
//   MODE 0: A = [h | h(t-d) | ctx] (KA = W_in, bf16: exact), B = dfg (2R,
//           float32: split): dW_fg in two passes, db_fg (per batch row)
//   MODE 1: A = gated (KA = R, float32: split), B = [dres | dskip] (R + S,
//           bf16: exact): dW_out in two passes, db_out
// Rows are staged 64 at a time by cp.async into one of two buffers while
// the other computes.
struct WgradArgs {
  const bf16_t* h;
  const bf16_t* ctx;
  const float* dfg;
  const float* gated;
  const bf16_t* dres;
  const bf16_t* dskip;
  float* part;     // (batch * chunks, n_el): [dw_fg | dw_out | db_out]
  float* part_b;   // (batch * chunks, 2R): db_fg
  long n_el;
  int t_len, d, chunks;
};

// The 8 warps over the (KA/16) x (NB/8) output tiles: wm x wn tile
// groups, the rest split each chunk's k steps (8 rows) into groups whose
// sums are added in group order at the end.  The most warps on tiles,
// then the fewest fragment loads (A: ca, B: cb each) per k step.
struct WgSplit {
  int wm, wn;
};
constexpr WgSplit wg_split(int km, int kn, int ca, int cb) {
  WgSplit best = {1, 1};
  int best_w = 0, best_cost = 1 << 30;
  for (int wm = 1; wm <= 8; wm *= 2)
    for (int wn = 1; wm * wn <= 8; wn *= 2) {
      if (km % wm || kn % wn) continue;
      const int w = wm * wn, cost = km / wm * ca + kn / wn * cb;
      if (w > best_w || (w == best_w && cost < best_cost)) {
        best = {wm, wn};
        best_w = w;
        best_cost = cost;
      }
    }
  return best;
}

template <int MODE, int R, int S, int KA>
struct WgShape {
  static constexpr int kNb = MODE == 0 ? 2 * R : R + S;
  // k-major row strides: float32 8 mod 32 floats times an odd number,
  // bf16 8 mod 16 elements times an odd number
  static constexpr int kLda = KA + 8;
  static constexpr int kLdb = MODE == 0 ? kNb + 8 : (kNb + 15) / 16 * 16 + 8;
  static constexpr size_t kA =
      static_cast<size_t>(kRows) * kLda * (MODE == 0 ? 2 : 4);
  static constexpr size_t kB =
      static_cast<size_t>(kRows) * kLdb * (MODE == 0 ? 4 : 2);
  static constexpr WgSplit kW =
      wg_split(KA / 16, kNb / 8, MODE == 0 ? 4 : 12, MODE == 0 ? 6 : 2);
  static constexpr int kWk = 8 / (kW.wm * kW.wn);   // k groups
  static constexpr int kMt = KA / 16 / kW.wm, kNt = kNb / 8 / kW.wn;
  static_assert(KA % 16 == 0 && kNb % 8 == 0, "16 x 8 tiles");
  static size_t smem() {
    const size_t stages = 2 * (kA + kB);
    const size_t red =
        static_cast<size_t>(kWk - 1) * (8 / kWk) * kMt * kNt * 4 * 32 * 4;
    return stages > red ? stages : red;
  }
};

template <int MODE, int R, int S, int KA>
__device__ __forceinline__ void wg_stage(unsigned char* s,
                                         const WgradArgs& a, long base,
                                         int t0, int rows) {
  using Sh = WgShape<MODE, R, S, KA>;
  if (MODE == 0) {
    stage_hp<R>(reinterpret_cast<bf16_t*>(s), Sh::kLda, a.h, a.ctx,
                base + t0, t0, rows, a.d, KA / 8);
    stage_f32<2 * R, Sh::kLdb>(reinterpret_cast<float*>(s + Sh::kA), a.dfg,
                               base + t0, rows);
  } else {
    stage_f32<R, Sh::kLda>(reinterpret_cast<float*>(s), a.gated, base + t0,
                           rows);
    stage_dout<R, S, Sh::kLdb>(reinterpret_cast<bf16_t*>(s + Sh::kA),
                               a.dres, a.dskip, base + t0, rows);
  }
}

template <int MODE, int R, int S, int KA>
__global__ void __launch_bounds__(kThreads, MODE == 0 ? 1 : 2)
    gated_wgrad_kernel(WgradArgs a) {
  using Sh = WgShape<MODE, R, S, KA>;
  constexpr int NB = Sh::kNb, LDA = Sh::kLda, LDB = Sh::kLdb;
  constexpr int MT = Sh::kMt, NT = Sh::kNt, WK = Sh::kWk, WN = Sh::kW.wn;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* st0 = smem;
  unsigned char* st1 = smem + Sh::kA + Sh::kB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kg = warp % WK, wt = warp / WK;      // k group, tile group
  const int i0 = (wt / WN) * MT * 16, j0 = (wt % WN) * NT * 8;
  const int blk = blockIdx.x, b = blk / a.chunks, ch = blk % a.chunks;
  const int per = (a.t_len + a.chunks - 1) / a.chunks;
  const int t_lo = min(a.t_len, ch * per);
  const int t_hi = min(a.t_len, t_lo + per);
  const long base = static_cast<long>(b) * a.t_len;
  float acc[MT][NT][4] = {};
  float bsum = 0.f;
  if (t_lo < t_hi)
    wg_stage<MODE, R, S, KA>(st0, a, base, t_lo, min(kRows, t_hi - t_lo));
  cp_async_commit();
  for (int t0 = t_lo, buf = 0; t0 < t_hi; t0 += kRows, buf ^= 1) {
    const int rows = min(kRows, t_hi - t0);
    if (t0 + kRows < t_hi)
      wg_stage<MODE, R, S, KA>(buf ? st0 : st1, a, base, t0 + kRows,
                               min(kRows, t_hi - t0 - kRows));
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* s = buf ? st1 : st0;
    const float* af = reinterpret_cast<const float*>(s);
    const bf16_t* ab = reinterpret_cast<const bf16_t*>(s);
    const float* bf = reinterpret_cast<const float*>(s + Sh::kA);
    const bf16_t* bb = reinterpret_cast<const bf16_t*>(s + Sh::kA);
    if (tid < NB) {
      for (int rr = 0; rr < rows; ++rr)
        bsum += MODE == 0 ? bf[rr * LDB + tid]
                          : __uint_as_float(bf_bits(bb[rr * LDB + tid]));
    }
    // rows past `rows` are zero; k steps of 8 rows, this warp's group's
    for (int k0 = 8 * kg; k0 < rows; k0 += 8 * WK) {
      Frag<2> fb[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (MODE == 0)
          load_b_kmajor(bf + k0 * LDB + j0 + 8 * j, LDB, fb[j]);
        else
          load_b_kmajor_bf16(bb + k0 * LDB + j0 + 8 * j, LDB, fb[j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        Frag<4> fa;
        if (MODE == 0)
          load_a_kmajor_bf16(ab + k0 * LDA + i0 + 16 * i, LDA, fa);
        else
          load_a_kmajor<true>(af + k0 * LDA + i0 + 16 * i, LDA, fa);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (MODE == 0)
            mma_split<false>(acc[i][j], fa, fb[j]);
          else
            mma_split_a(acc[i][j], fa, fb[j]);
        }
      }
    }
    __syncthreads();   // the buffer is staged again next
  }
  if (WK > 1) {
    // the k groups' sums, added in group order (the buffers are free)
    constexpr int PER = MT * NT * 4 * 32;
    float* red = reinterpret_cast<float*>(smem);
    __syncthreads();
    if (kg > 0) {
      float* dst = red + ((kg - 1) * (8 / WK) + wt) * PER;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dst[((i * NT + j) * 4 + e) * 32 + lane] = acc[i][j][e];
    }
    __syncthreads();
    if (kg == 0)
      for (int k = 1; k < WK; ++k) {
        const float* src = red + ((k - 1) * (8 / WK) + wt) * PER;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] += src[((i * NT + j) * 4 + e) * 32 + lane];
      }
  }
  // the block's partial: dW_fg (KA, 2R) at 0, dW_out (R, R+S) and db_out
  // after it; db_fg in part_b
  float* out =
      a.part + blk * a.n_el + (MODE == 0 ? 0 : a.n_el - (KA + 1) * NB);
  if (kg == 0) {
    const int gr = lane >> 2, q = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = j0 + 8 * j + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(out + (i0 + 16 * i + gr + 8 * h) * NB +
                                     c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  }
  if (tid < NB) {
    if (MODE == 0)
      a.part_b[static_cast<long>(blk) * NB + tid] = bsum;
    else
      out[KA * NB + tid] = bsum;
  }
}

// out[grp, e] = sum over c < per_group of part[grp * per_group + c, e]
// in a fixed order: four interleaved running sums (c mod 4), so that four
// loads are in flight, then added in order
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* part, float* out, long n_el, int n_groups,
                  int per_group) {
  const long total = n_el * n_groups;
  for (long i = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x;
       i < total; i += static_cast<long>(gridDim.x) * kThreads) {
    const long grp = i / n_el, e = i % n_el;
    const float* p = part + grp * per_group * n_el + e;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    int c = 0;
    for (; c + 4 <= per_group; c += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] += p[(c + u) * n_el];
    }
    for (; c < per_group; ++c) s[c % 4] += p[c * n_el];
    out[i] = (s[0] + s[1]) + (s[2] + s[3]);
  }
}

// ------------------------------------------------------------- host
int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n < 1)
    return 132;
  return n;
}

int grid_for(long n) {
  long g = (n + kThreads - 1) / kThreads;
  return static_cast<int>(g < 8192 ? (g < 1 ? 1 : g) : 8192);
}

// Persistent blocks for n_tiles tiles: as many as fit on the card, at
// most one a tile.
int persistent_grid(const void* fn, int threads, size_t smem,
                    long n_tiles) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const long n = static_cast<long>(sm_count()) * per_sm;
  return static_cast<int>(n_tiles < n ? n_tiles : n);
}

// The weight-gradient launches' (batch, chunk) blocks: about two a SM.
int chunks_of(int batch) {
  const int c = 2 * sm_count() / batch;
  return c < 1 ? 1 : c;
}

// [dw_fg (W_in, 2R) | dw_out (R, R+S) | db_out (R+S)]
long n_el_of(int r, int s, int win) {
  return static_cast<long>(win) * 2 * r + static_cast<long>(r) * (r + s) +
         (r + s);
}

// The backward's float32 scratch: own, past (M, R), dfg (M, 2R), gated
// (M, R), the blocks' partials and their db_fg partials.
struct Scratch {
  float *own, *past, *dfg, *gated, *part, *part_b;
  long total;
};
Scratch scratch_of(float* base, int batch, int t_len, int r, int s,
                   int win) {
  const long m = static_cast<long>(batch) * t_len;
  const long blocks = static_cast<long>(batch) * chunks_of(batch);
  const long part = 5 * m * r, part_b = part + blocks * n_el_of(r, s, win);
  Scratch sc;
  sc.own = base;
  sc.past = base + m * r;
  sc.dfg = base + 2 * m * r;
  sc.gated = base + 4 * m * r;
  sc.part = base + part;
  sc.part_b = base + part_b;
  sc.total = part_b + blocks * 2 * r;
  return sc;
}

template <int R, int S>
int fwd_impl(const GatedArgs& a, cudaStream_t st) {
  const int win = a.ctx ? 3 * R : 2 * R;
  const size_t smem = Shape<R, S>::fwd_smem(win);
  const void* fn = reinterpret_cast<const void*>(gated_fwd_kernel<R, S>);
  int err = set_smem(fn, smem);
  if (err) return err;
  const long n_tiles =
      static_cast<long>(a.batch) * ((a.t_len + kRows - 1) / kRows);
  if (n_tiles < 1) return 0;
  constexpr int nth = Shape<R, S>::kThreads;
  gated_fwd_kernel<R, S>
      <<<persistent_grid(fn, nth, smem, n_tiles), nth, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, int R, int S, int KA>
int wgrad_launch(const WgradArgs& w, int blocks, cudaStream_t st) {
  using Sh = WgShape<MODE, R, S, KA>;
  const size_t smem = Sh::smem();
  int err = set_smem(
      reinterpret_cast<const void*>(gated_wgrad_kernel<MODE, R, S, KA>),
      smem);
  if (err) return err;
  gated_wgrad_kernel<MODE, R, S, KA><<<blocks, kThreads, smem, st>>>(w);
  return static_cast<int>(cudaGetLastError());
}

template <int R, int S>
int bwd_impl(const GatedBwdArgs& a, const Scratch& sc, bf16_t* dh,
             float* grads, cudaStream_t st) {
  const int win = a.ctx ? 3 * R : 2 * R;
  const size_t smem = Shape<R, S>::bwd_smem(win);
  const void* fn = reinterpret_cast<const void*>(gated_bwd_kernel<R, S>);
  int err = set_smem(fn, smem);
  if (err) return err;
  const long n_tiles =
      static_cast<long>(a.batch) * ((a.t_len + kRows - 1) / kRows);
  if (n_tiles > 0) {
    constexpr int nth = Shape<R, S>::kThreads;
    gated_bwd_kernel<R, S>
        <<<persistent_grid(fn, nth, smem, n_tiles), nth, smem, st>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  const int chunks = chunks_of(a.batch), blocks = a.batch * chunks;
  WgradArgs w = {};
  w.h = a.h;
  w.ctx = a.ctx;
  w.dfg = a.dfg;
  w.gated = a.gated;
  w.dres = a.dres;
  w.dskip = a.dskip;
  w.part = sc.part;
  w.part_b = sc.part_b;
  w.n_el = n_el_of(R, S, win);
  w.t_len = a.t_len;
  w.d = a.d;
  w.chunks = chunks;
  err = a.ctx ? wgrad_launch<0, R, S, 3 * R>(w, blocks, st)
              : wgrad_launch<0, R, S, 2 * R>(w, blocks, st);
  if (err) return err;
  err = wgrad_launch<1, R, S, R>(w, blocks, st);
  if (err) return err;
  const long total = static_cast<long>(a.batch) * a.t_len * R;
  if (total > 0) {
    gated_carry_kernel<<<grid_for(total), kThreads, 0, st>>>(
        a.own, a.past, a.d, a.t_len, R, total, dh);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  reduce_kernel<<<grid_for(w.n_el), kThreads, 0, st>>>(sc.part, grads,
                                                       w.n_el, 1, blocks);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_kernel<<<grid_for(static_cast<long>(a.batch) * 2 * R), kThreads, 0,
                  st>>>(sc.part_b, grads + w.n_el, 2 * R, a.batch, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MOVENET_GATED_WIDTHS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(64, 8) X(32, 8) X(16, 8)

extern "C" {

// 1 if the kernels are built for residual width r and skip width s
int movenet_gated_supports(int r, int s) {
#define X(R_, S_) \
  if (r == R_ && s == S_) return 1;
  MOVENET_GATED_WIDTHS(X)
#undef X
  return 0;
}

// Float32 elements of the reduced gradients [dw_fg (W_in, 2R) | dw_out
// (R, R+S) | db_out (R+S) | db_fg (B, 2R)].
long movenet_gated_bwd_part(int r, int s, int win, int batch) {
  return n_el_of(r, s, win) + static_cast<long>(batch) * 2 * r;
}

// Float32 elements of the backward's scratch at these shapes.
long movenet_gated_bwd_scratch(int batch, int t_len, int r, int s, int win) {
  float* none = nullptr;
  return scratch_of(none, batch, t_len, r, s, win).total;
}

// Forward: res and skip (bf16); returns the first cudaError_t.
int movenet_gated_fwd(const bf16_t* h, const bf16_t* ctx, const float* b_fg,
                      const float* w_fg, const float* w_out,
                      const float* b_out, bf16_t* res, bf16_t* skip,
                      int batch, int t_len, int r, int s, int d,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  GatedArgs a = {h, ctx, b_fg, w_fg, w_out, b_out, res, skip,
                 batch, t_len, d};
#define X(R_, S_) \
  if (r == R_ && s == S_) return fwd_impl<R_, S_>(a, st);
  MOVENET_GATED_WIDTHS(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward: dh, dctx (bf16; dctx null without ctx) and grads (float32,
// movenet_gated_bwd_part elements); scratch holds
// movenet_gated_bwd_scratch floats.  Returns the first cudaError_t.
int movenet_gated_bwd(const bf16_t* h, const bf16_t* ctx, const float* b_fg,
                      const float* w_fg, const float* w_out,
                      const bf16_t* dres, const bf16_t* dskip,
                      float* scratch, bf16_t* dh, bf16_t* dctx,
                      float* grads, int batch, int t_len, int r, int s, int d,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch sc =
      scratch_of(scratch, batch, t_len, r, s, ctx ? 3 * r : 2 * r);
  GatedBwdArgs a = {};
  a.h = h;
  a.ctx = ctx;
  a.b_fg = b_fg;
  a.w_fg = w_fg;
  a.w_out = w_out;
  a.dres = dres;
  a.dskip = dskip;
  a.own = sc.own;
  a.past = sc.past;
  a.dctx = dctx;
  a.dfg = sc.dfg;
  a.gated = sc.gated;
  a.batch = batch;
  a.t_len = t_len;
  a.d = d;
#define X(R_, S_) \
  if (r == R_ && s == S_) return bwd_impl<R_, S_>(a, sc, dh, grads, st);
  MOVENET_GATED_WIDTHS(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
