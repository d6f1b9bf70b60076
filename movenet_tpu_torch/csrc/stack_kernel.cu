// Whole-stack WaveNet trunk of the training step, forward and backward.
//
// Replaces the TPU kernels movenet_tpu/ops/pallas/stack_kernel.py:
//   _fwd_kernel (stack_kernel.py:280, pallas_call at :424), "save" strategy
//     with the front embedding folded in: every gated block of the stack,
//     writing skip_sum (B,T,S), hsave (L,B,T,R) and tfsg (L,B,T,2R);
//   _bwd_kernel_padded (stack_kernel.py:1486, pallas_call at :1443): the
//     backward from hsave/tfsg, with the embedding-table gradient and the
//     stride-10 video-projection backward folded in.
// Only the bf16 compute dtype is built here (the operands of the forward
// products are bf16, the backward's are f32, as on the TPU).
//
// Design.  The TPU runs a (batch, time tile) grid in order and carries the
// dilation rings and the weight-gradient sums from one grid step to the
// next.  Here every launch is parallel over time instead:
//   forward   one launch for the embedding, then one per layer (layer-
//             major).  Blocks are persistent (two per SM) and walk tiles
//             of 4096/R consecutive rows; the tap h(t-d) is read back from
//             hsave[l], which the previous launch wrote, so no ring and no
//             halo is needed for any d.  h stays float32 in global memory
//             between launches; the skip sum accumulates there in float32
//             and the last layer stores it in bf16.  Per tile: [h | h(t-d)
//             | ctx] (transposed) and W_fg, staged once per block, in bf16
//             in shared memory; fg by fmaf over 4x8 register tiles; the
//             gate in registers; gated (rounded) and W_out in shared
//             memory; the output product, the residual and skip updates.
//   backward  one launch per layer, top down (one persistent block per SM,
//             64-row tiles, W_out^T and W_fg^T staged once in float32),
//             each followed by two weight-gradient launches and their
//             fixed-order reductions.  The anti-causal carry dfg_p(t+d)
//             crosses blocks, so the layer launch stores dh + dfg_w_h and
//             dfg_w_p apart; the next launch adds them up row by row (two
//             buffers for dfg_w_p).  dfg (f32) is stored for the weight-
//             gradient launches, which keep their 4x8 tiles of the sum in
//             registers over a (batch, chunk) range of rows and write
//             per-block partial sums, added by a second pass in fixed
//             order: deterministic, no atomics.  The bias gradients are
//             the column sums of the same operands.  The table gradient
//             adds dh rows by code with shared-memory atomics per block
//             (order not fixed), then a fixed-order reduction; the
//             projection backward is one more weight-gradient launch (dwup,
//             dbup) and one product for dxc.
// The TPU's per-tile ring snapshots (tails) are not produced: hsave holds
// those rows.  Every product is a sequence of fmaf in float32 over operands
// held in shared memory; nothing uses tensor cores yet (later work).
//
// Bound (breakdancing shape: B=2, T=160000, L=9, R=S=64, ctx): forward
// about 1.9e11 flop in bf16 operands and 1.19 GB of compulsory traffic
// (hsave, tfsg, skip, ctx), so the tensor-core bound is 0.36 ms, memory;
// backward about 3.9e11 flop on f32 operands, 5.7 ms at the 67 TF/s of the
// f32 units.  This version runs on those f32 units for both directions and
// adds float32 intermediates in global memory (h, the skip sum, dh, dfg),
// so it is bound by the fmaf rate and by latency, far from the forward's
// bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
typedef unsigned short bf16_t;

__device__ __forceinline__ float bf2f(bf16_t u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ bf16_t f2bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

// 8 bf16 from a 16-byte aligned address
__device__ __forceinline__ void load8(const bf16_t* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 4 bf16 from an 8-byte aligned address
__device__ __forceinline__ void load4(const bf16_t* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return static_cast<unsigned>(f2bf(lo)) |
         (static_cast<unsigned>(f2bf(hi)) << 16);
}

// 4 floats rounded to bf16 at an 8-byte aligned address
__device__ __forceinline__ void store4_bf(bf16_t* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]),
                                            pack2(v[2], v[3]));
}

// 8 floats rounded to bf16 at a 16-byte aligned address
__device__ __forceinline__ void store8_bf(bf16_t* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
      pack2(v[6], v[7]));
}

// ------------------------------------------------------------ forward
__global__ void __launch_bounds__(kThreads)
    stack_embed_kernel(const int* pack, int pack_cols, const bf16_t* table2,
                       int vocab, int batch, int t_len, int r, float* h,
                       bf16_t* hsave0) {
  const long total = static_cast<long>(batch) * t_len * r;
  for (long i = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x;
       i < total; i += static_cast<long>(gridDim.x) * kThreads) {
    const long m = i / r;
    const int j = static_cast<int>(i % r);
    const int b = static_cast<int>(m / t_len), t = static_cast<int>(m % t_len);
    const int cur = pack[static_cast<long>(t) * pack_cols + b];
    const int prev = pack[static_cast<long>(t) * pack_cols + batch + b];
    float v = 0.f;
    if (cur >= 0 && cur < vocab) v += bf2f(table2[cur * r + j]);
    if (prev >= 0 && prev < vocab) v += bf2f(table2[(vocab + prev) * r + j]);
    const bf16_t vb = f2bf(v);        // the embedded h is rounded
    h[i] = bf2f(vb);
    hsave0[i] = vb;
  }
}

struct FwdLayerArgs {
  float* h;              // (M, R) residual stream, float32, in place
  const bf16_t* hs;      // (M, R) hsave[l]
  bf16_t* hs_next;       // (M, R) hsave[l+1], or null at the last layer
  const bf16_t* ctx;     // (M, R) or null
  const float* b_fg;     // (B, 2R) this layer's fg bias rows
  const float* w_fg;     // (W_in, 2R)
  const float* w_out;    // (R, R+S)
  const float* b_out;    // (R+S)
  bf16_t* tfsg;          // (M, 2R) this layer's taps
  float* skacc;          // (M, S) float32 skip accumulator
  bf16_t* skip;          // (M, S) skip_sum, stored by the last layer
  long m_total;
  int t_len, d, first, last;
};

template <int R, int S>
struct FwdShape {
  static constexpr int kMr = 4;                   // rows per thread
  static constexpr int kRows = kMr * (1024 / R);  // rows per block
  static constexpr int kLd = kRows + 8;           // row stride of the
                                                  // transposed operands
  static constexpr int kNo = R + S;
  static size_t smem() {
    return (3 * R * kLd + 3 * R * 2 * R + R * kLd + R * kNo) * 2 +
           kNo * 4;
  }
};

template <int R, int S>
__global__ void __launch_bounds__(kThreads)
    stack_fwd_layer_kernel(FwdLayerArgs a) {
  constexpr int ROWS = FwdShape<R, S>::kRows, LD = FwdShape<R, S>::kLd;
  constexpr int NO = FwdShape<R, S>::kNo, MR = FwdShape<R, S>::kMr;
  const int kin = a.ctx ? 3 * R : 2 * R;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16_t* at = reinterpret_cast<bf16_t*>(smem);   // (3R, LD) operands^T
  bf16_t* wf = at + 3 * R * LD;                     // (3R, 2R)
  bf16_t* gt = wf + 3 * R * 2 * R;                  // (R, LD) gated^T
  bf16_t* wo = gt + R * LD;                         // (R, NO)
  float* bo = reinterpret_cast<float*>(wo + R * NO);
  const int tid = threadIdx.x;

  // weights rounded to bf16, as the TPU kernel's _mdot rounds operands;
  // staged once, then the block walks its tiles (grid = the SM count)
  for (int i = tid; i < kin * 2 * R; i += kThreads) wf[i] = f2bf(a.w_fg[i]);
  for (int i = tid; i < R * NO; i += kThreads) wo[i] = f2bf(a.w_out[i]);
  for (int i = tid; i < NO; i += kThreads) bo[i] = a.b_out[i];
  const long n_tiles = (a.m_total + ROWS - 1) / ROWS;
  for (long tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x) {
  const long m0 = tile_i * ROWS;
  __syncthreads();
  // 8 channels of one row per thread, rows fastest across threads so
  // that the transposed stores fall in consecutive shared addresses
  for (int i = tid; i < ROWS * (R / 8); i += kThreads) {
    const int row = i % ROWS, j0 = (i / ROWS) * 8;
    const long m = m0 + row;
    uint4 hv = make_uint4(0, 0, 0, 0), tv = hv, cv = hv;
    if (m < a.m_total) {
      hv = *reinterpret_cast<const uint4*>(a.hs + m * R + j0);
      if (static_cast<int>(m % a.t_len) >= a.d)
        tv = *reinterpret_cast<const uint4*>(a.hs + (m - a.d) * R + j0);
      if (a.ctx) cv = *reinterpret_cast<const uint4*>(a.ctx + m * R + j0);
    }
    const bf16_t* hb = reinterpret_cast<const bf16_t*>(&hv);
    const bf16_t* tb = reinterpret_cast<const bf16_t*>(&tv);
    const bf16_t* cb = reinterpret_cast<const bf16_t*>(&cv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      at[(j0 + e) * LD + row] = hb[e];
      at[(R + j0 + e) * LD + row] = tb[e];
      if (a.ctx) at[(2 * R + j0 + e) * LD + row] = cb[e];
    }
  }
  __syncthreads();

  // fg = [h | h(t-d) | ctx] W_fg + b_fg: each thread MR rows x (4 filter
  // + 4 gate) columns, so the gate is formed in registers
  {
    constexpr int CG = R / 4;
    const int cg = tid % CG, r0 = (tid / CG) * MR, c0 = cg * 4;
    float acc[MR][8];
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < kin; ++k) {
      float av[MR], bv[8];
      load4(at + k * LD + r0, av);
      load4(wf + k * 2 * R + c0, bv);
      load4(wf + k * 2 * R + R + c0, bv + 4);
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int row = r0 + i;
      const long m = m0 + row;
      const bool ok = m < a.m_total;
      const int b = ok ? static_cast<int>(m / a.t_len) : 0;
      const float* bf = a.b_fg + b * 2 * R;
      float vf[4], vg[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float f = acc[i][j] + bf[c0 + j];
        const float g = acc[i][4 + j] + bf[R + c0 + j];
        vf[j] = bf2f(f2bf(tanhf(f)));
        vg[j] = bf2f(f2bf(1.f / (1.f + expf(-g))));
        // gated from the rounded taps, rounded again as a product operand
        gt[(c0 + j) * LD + row] = f2bf(vf[j] * vg[j]);
      }
      if (ok) {
        store4_bf(a.tfsg + m * 2 * R + c0, vf);
        store4_bf(a.tfsg + m * 2 * R + R + c0, vg);
      }
    }
  }
  __syncthreads();

  // out = gated W_out + b_out; residual and skip updates
  constexpr int OC = NO / 8, TILES = (ROWS / MR) * OC;
  for (int tile = tid; tile < TILES; tile += kThreads) {
    const int r0 = (tile / OC) * MR, c0 = (tile % OC) * 8;
    float acc[MR][8];
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < R; ++k) {
      float av[MR], bv[8];
      load4(gt + k * LD + r0, av);
      load8(wo + k * NO + c0, bv);
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // 8 columns lie wholly in the residual or the skip part (R % 8 == 0)
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const long m = m0 + r0 + i;
      if (m >= a.m_total) continue;
      float v[8];
      float* dst = c0 < R ? a.h + m * R + c0 : a.skacc + m * S + c0 - R;
      const bool add = c0 < R || !a.first;
      float4 o0 = make_float4(0.f, 0.f, 0.f, 0.f), o1 = o0;
      if (add) {
        o0 = *reinterpret_cast<const float4*>(dst);
        o1 = *reinterpret_cast<const float4*>(dst + 4);
      }
      const float old[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = (acc[i][j] + bo[c0 + j]) + old[j];
      if (c0 < R) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(v[4], v[5], v[6], v[7]);
        if (a.hs_next) store8_bf(a.hs_next + m * R + c0, v);
      } else if (a.last) {
        store8_bf(a.skip + m * S + c0 - R, v);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
  }  // tiles
}

// ----------------------------------------------------------- backward
struct BwdLayerArgs {
  float* dhp;            // (M, R) in: layer l+1's dh + dfg_w_h; out: layer l's
  const float* p_in;     // (M, R) layer l+1's dfg_w past part (not at top)
  float* p_out;          // (M, R) this layer's
  float* dh;             // (M, R) out: gradient of this layer's output h
  float* dfg;            // (M, 2R) out
  float* dctx;           // (M, R) float32 accumulator, or null
  bf16_t* dctx_bf;       // (M, R) flat dctx, stored by layer 0, or null
  const bf16_t* dskip;   // (M, S)
  const bf16_t* tfsg;    // (M, 2R)
  const float* w_out;    // (R, R+S)
  const float* w_fg;     // (W_in, 2R)
  long m_total;
  int t_len, d_in, top, win;
};

constexpr int kBwdRows = 64;
constexpr int kBwdLd = kBwdRows + 4;

template <int R, int S>
size_t bwd_smem(int win) {
  return ((R + S) * kBwdLd + (R + S) * R + 2 * R * kBwdLd + 2 * R * win) * 4;
}

template <int R, int S>
__global__ void __launch_bounds__(kThreads)
    stack_bwd_layer_kernel(BwdLayerArgs a) {
  constexpr int NO = R + S, LD = kBwdLd, ROWS = kBwdRows;
  const int win = a.win;
  extern __shared__ __align__(16) unsigned char smem[];
  float* dt = reinterpret_cast<float*>(smem);   // (NO, LD) [dh | dskip]^T
  float* wot = dt + NO * LD;                      // (NO, R) W_out^T
  float* ft = wot + NO * R;                       // (2R, LD) dfg^T
  float* wft = ft + 2 * R * LD;                   // (2R, W_in) W_fg^T
  const int tid = threadIdx.x;

  // transposed weights, staged once (stores in order, loads strided);
  // then the block walks its tiles (grid = the SM count)
  for (int i = tid; i < R * NO; i += kThreads) {
    const int k = i / R, j = i % R;
    wot[i] = a.w_out[j * NO + k];
  }
  for (int i = tid; i < win * 2 * R; i += kThreads) {
    const int k = i / win, j = i % win;
    wft[i] = a.w_fg[j * 2 * R + k];
  }
  const long n_tiles = (a.m_total + ROWS - 1) / ROWS;
  for (long tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x) {
  const long m0 = tile_i * ROWS;
  __syncthreads();
  // dh of this layer's output: the layer above's dh + dfg_w_h, plus its
  // anti-causal carry dfg_w_p(t + d)
  // 4 channels of one row per thread, rows fastest across threads
  for (int i = tid; i < ROWS * (R / 4); i += kThreads) {
    const int row = i % ROWS, j0 = (i / ROWS) * 4;
    const long m = m0 + row;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < a.m_total) {
      if (!a.top) {
        v = *reinterpret_cast<const float4*>(a.dhp + m * R + j0);
        if (static_cast<int>(m % a.t_len) + a.d_in < a.t_len) {
          const float4 c = *reinterpret_cast<const float4*>(
              a.p_in + (m + a.d_in) * R + j0);
          v = make_float4(v.x + c.x, v.y + c.y, v.z + c.z, v.w + c.w);
        }
      }
      *reinterpret_cast<float4*>(a.dh + m * R + j0) = v;
    }
    dt[j0 * LD + row] = v.x;
    dt[(j0 + 1) * LD + row] = v.y;
    dt[(j0 + 2) * LD + row] = v.z;
    dt[(j0 + 3) * LD + row] = v.w;
  }
  for (int i = tid; i < ROWS * (S / 4); i += kThreads) {
    const int row = i % ROWS, j0 = (i / ROWS) * 4;
    const long m = m0 + row;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (m < a.m_total) load4(a.dskip + m * S + j0, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) dt[(R + j0 + e) * LD + row] = v[e];
  }
  __syncthreads();

  // dgated = [dh | dskip] W_out^T, then dfg from the saved taps
  for (int tile = tid; tile < (ROWS / 4) * (R / 4); tile += kThreads) {
    const int r0 = (tile / (R / 4)) * 4, c0 = (tile % (R / 4)) * 4;
    float acc[4][4] = {};
    for (int k = 0; k < NO; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(dt + k * LD + r0);
      const float4 bv = *reinterpret_cast<const float4*>(wot + k * R + c0);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + i;
      const long m = m0 + row;
      const bool ok = m < a.m_total;
      float tf[4] = {0.f, 0.f, 0.f, 0.f}, sg[4] = {0.f, 0.f, 0.f, 0.f};
      if (ok) {
        load4(a.tfsg + m * 2 * R + c0, tf);
        load4(a.tfsg + m * 2 * R + R + c0, sg);
      }
      float df[4], dq[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dg = acc[i][j];
        df[j] = dg * (sg[j] * (1.f - tf[j] * tf[j]));
        dq[j] = dg * (tf[j] * (sg[j] - sg[j] * sg[j]));
        ft[(c0 + j) * LD + row] = df[j];
        ft[(R + c0 + j) * LD + row] = dq[j];
      }
      if (ok) {
        *reinterpret_cast<float4*>(a.dfg + m * 2 * R + c0) =
            make_float4(df[0], df[1], df[2], df[3]);
        *reinterpret_cast<float4*>(a.dfg + m * 2 * R + R + c0) =
            make_float4(dq[0], dq[1], dq[2], dq[3]);
      }
    }
  }
  __syncthreads();

  // dfg_w = dfg W_fg^T: [dh part | past part | ctx part]
  const int wc = win / 4;
  for (int tile = tid; tile < (ROWS / 4) * wc; tile += kThreads) {
    const int r0 = (tile / wc) * 4, c0 = (tile % wc) * 4;
    float acc[4][4] = {};
    for (int k = 0; k < 2 * R; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(ft + k * LD + r0);
      const float4 bv = *reinterpret_cast<const float4*>(wft + k * win + c0);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
    // 4 columns lie wholly in one part (R % 4 == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + i;
      const long m = m0 + row;
      if (m >= a.m_total) continue;
      float x[4];
      if (c0 < R) {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = dt[(c0 + j) * LD + row] + acc[i][j];
        *reinterpret_cast<float4*>(a.dhp + m * R + c0) =
            make_float4(x[0], x[1], x[2], x[3]);
      } else if (c0 < 2 * R) {
        *reinterpret_cast<float4*>(a.p_out + m * R + c0 - R) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
        float* dc = a.dctx + m * R + c0 - 2 * R;
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!a.top) o = *reinterpret_cast<const float4*>(dc);
        const float old[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = a.top ? acc[i][j] : old[j] + acc[i][j];
        if (a.dctx_bf)
          store4_bf(a.dctx_bf + m * R + c0 - 2 * R, x);
        else
          *reinterpret_cast<float4*>(dc) = make_float4(x[0], x[1], x[2], x[3]);
      }
    }
  }
  }  // tiles
}

// Weight gradients over time, C = sum_rows A^T B and colsum(B), in
// per-(batch, chunk) partial sums; blockIdx.x = batch * chunks + chunk,
// blockIdx.y = a slab of 128 columns of B.
//   MODE 0: A = [hsave | hsave(t-d) | ctx] (W_in), B = dfg (2R)
//   MODE 1: A = tf * sg (R), B = [dh | dskip] (R+S)
//   MODE 2: A = xc rows (R), B = dctx as (T/10, 10R) rows
// Loads move 8 bf16 or 4 floats at a time; shapes are template constants.
struct WgradArgs {
  const bf16_t* hs;
  const bf16_t* ctx;
  const float* dfg;
  const bf16_t* tfsg;
  const float* dh;
  const bf16_t* dskip;
  const bf16_t* xc;
  const float* dctx;
  int n, rows_per_batch, chunks, d;
  float* part;     // (batch * chunks, KA, n)
  float* part_b;   // (batch * chunks, n)
};

constexpr int kWgRows = 64;
constexpr int kWgSlab = 128;


__device__ __forceinline__ void store8(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// One row of A, 8 columns (group q) at a time.
template <int MODE, int R, int KA>
__device__ __forceinline__ void wg_a8(const WgradArgs& a, long row, int t,
                                      int q, float* v) {
  constexpr int G = R / 8;
  if (MODE == 0) {
    if (q < G) {
      load8(a.hs + row * R + 8 * q, v);
    } else if (q < 2 * G) {
      if (t >= a.d) {
        load8(a.hs + (row - a.d) * R + 8 * (q - G), v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
    } else {
      load8(a.ctx + row * R + 8 * (q - 2 * G), v);
    }
  } else if (MODE == 1) {
    float sg[8];
    load8(a.tfsg + row * 2 * R + 8 * q, v);
    load8(a.tfsg + row * 2 * R + R + 8 * q, sg);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = v[j] * sg[j];
  } else {
    load8(a.xc + row * R + 8 * q, v);
  }
}

// One row of B, 4 columns (c, c+1, c+2, c+3) at a time.
template <int MODE, int R, int S>
__device__ __forceinline__ float4 wg_b4(const WgradArgs& a, long row, int c) {
  if (MODE == 0)
    return *reinterpret_cast<const float4*>(a.dfg + row * 2 * R + c);
  if (MODE == 1) {
    if (c < R) return *reinterpret_cast<const float4*>(a.dh + row * R + c);
    float v[4];
    load4(a.dskip + row * S + c - R, v);
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  return *reinterpret_cast<const float4*>(a.dctx + row * 10 * R + c);
}

template <int MODE, int R, int S>
struct WgShape {
  static constexpr int kN = MODE == 0 ? 2 * R : MODE == 1 ? R + S : 10 * R;
  static constexpr int kNb = kN < kWgSlab ? kN : kWgSlab;   // slab width
};

// Each thread keeps its 4x8 tiles of the (KA, slab) sum in registers over
// the block's rows; about 80 KB of shared memory at R = 64, two blocks
// per SM.
template <int MODE, int R, int S, int KA>
__global__ void __launch_bounds__(kThreads) stack_wgrad_kernel(WgradArgs a) {
  constexpr int N = WgShape<MODE, R, S>::kN, NB = WgShape<MODE, R, S>::kNb;
  constexpr int GA = KA / 8, GB = NB / 4, NC = NB / 8;
  constexpr int TILES = (KA / 4) * NC;
  constexpr int TPT = (TILES + kThreads - 1) / kThreads;
  const int col0 = blockIdx.y * NB;
  extern __shared__ __align__(16) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);   // (kWgRows, KA)
  float* bs = as + kWgRows * KA;                  // (kWgRows, NB)
  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int b = g / a.chunks, ch = g % a.chunks;
  const int per = (a.rows_per_batch + a.chunks - 1) / a.chunks;
  const int t_lo = ch * per;
  const int t_hi = min(a.rows_per_batch, t_lo + per);
  const long base = static_cast<long>(b) * a.rows_per_batch;
  float acc[TPT][4][8] = {};
  float bsum = 0.f;
  for (int t0 = t_lo; t0 < t_hi; t0 += kWgRows) {
    const int rows = min(kWgRows, t_hi - t0);
    __syncthreads();
    for (int i = tid; i < kWgRows * GA; i += kThreads) {
      const int rr = i / GA, q = i % GA;
      float v[8];
      if (rr < rows) {
        wg_a8<MODE, R, KA>(a, base + t0 + rr, t0 + rr, q, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
      store8(as + rr * KA + 8 * q, v);
    }
    for (int i = tid; i < kWgRows * GB; i += kThreads) {
      const int rr = i / GB, c = col0 + 4 * (i % GB);
      *reinterpret_cast<float4*>(bs + i * 4) =
          rr < rows && c < N ? wg_b4<MODE, R, S>(a, base + t0 + rr, c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    if (tid < NB)
      for (int rr = 0; rr < rows; ++rr) bsum += bs[rr * NB + tid];
#pragma unroll
    for (int u = 0; u < TPT; ++u) {
      const int tile = tid + u * kThreads;
      if (tile >= TILES) break;
      const int k0 = (tile / NC) * 4, c0 = (tile % NC) * 8;
      for (int rr = 0; rr < rows; ++rr) {
        const float4 av = *reinterpret_cast<const float4*>(as + rr * KA + k0);
        const float4 b0 = *reinterpret_cast<const float4*>(bs + rr * NB + c0);
        const float4 b1 =
            *reinterpret_cast<const float4*>(bs + rr * NB + c0 + 4);
        const float ai[4] = {av.x, av.y, av.z, av.w};
        const float bj[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[u][i][j] = fmaf(ai[i], bj[j], acc[u][i][j]);
      }
    }
  }
  float* out = a.part + static_cast<long>(g) * KA * N;
#pragma unroll
  for (int u = 0; u < TPT; ++u) {
    const int tile = tid + u * kThreads;
    if (tile >= TILES) break;
    const int k0 = (tile / NC) * 4, c0 = (tile % NC) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (col0 + c0 + j < N) out[(k0 + i) * N + col0 + c0 + j] = acc[u][i][j];
  }
  if (tid < NB && col0 + tid < N)
    a.part_b[static_cast<long>(g) * N + col0 + tid] = bsum;
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

// Table gradient: dh of layer 0 (its partial + the carry) added by code
// into a per-block (2V, R) table in shared memory.
__global__ void __launch_bounds__(kThreads)
    stack_embed_grad_kernel(const float* dhp, const float* p, int d0,
                            const int* pack, int pack_cols, int batch,
                            int t_len, int vocab, int r, long rows_per_block,
                            float* part) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const int n_tab = 2 * vocab * r;
  for (int i = tid; i < n_tab; i += kThreads) tab[i] = 0.f;
  __syncthreads();
  const long m_total = static_cast<long>(batch) * t_len;
  const long lo = blockIdx.x * rows_per_block;
  const long hi = lo + rows_per_block < m_total ? lo + rows_per_block
                                                : m_total;
  for (long i = lo * r + tid; i < hi * r; i += kThreads) {
    const long m = i / r;
    const int j = static_cast<int>(i % r);
    const int b = static_cast<int>(m / t_len), t = static_cast<int>(m % t_len);
    float v = dhp[i];
    if (t + d0 < t_len) v = v + p[(m + d0) * r + j];
    const int cur = pack[static_cast<long>(t) * pack_cols + b];
    const int prev = pack[static_cast<long>(t) * pack_cols + batch + b];
    if (cur >= 0 && cur < vocab) atomicAdd(&tab[cur * r + j], v);
    if (prev >= 0 && prev < vocab) atomicAdd(&tab[(vocab + prev) * r + j], v);
  }
  __syncthreads();
  for (int i = tid; i < n_tab; i += kThreads)
    part[static_cast<long>(blockIdx.x) * n_tab + i] = tab[i];
}

// dxc = dz wup^T over rows of dz = dctx as (B*T/10, 10R): the coarse
// input gradient of the stride-10 projection, stored in bf16.
template <int R>
__global__ void __launch_bounds__(kThreads)
    stack_proj_dx_kernel(const float* dz, const float* wup, bf16_t* dxc,
                         long q_total) {
  constexpr int ROWS = 64, LD = ROWS + 4, KC = 64, K = 10 * R;
  extern __shared__ __align__(16) unsigned char smem[];
  float* zt = reinterpret_cast<float*>(smem);   // (KC, LD)
  float* wt = zt + KC * LD;                       // (KC, R)
  const int tid = threadIdx.x;
  const long q0 = static_cast<long>(blockIdx.x) * ROWS;
  const bool active = tid < (ROWS / 4) * (R / 4);
  const int r0 = (tid / (R / 4)) * 4, c0 = (tid % (R / 4)) * 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < ROWS * KC; i += kThreads) {
      const int row = i / KC, k = i % KC;
      const long q = q0 + row;
      zt[k * LD + row] =
          q < q_total && k0 + k < K ? dz[q * K + k0 + k] : 0.f;
    }
    for (int i = tid; i < R * KC; i += kThreads) {
      const int e = i / KC, k = i % KC;
      wt[k * R + e] =
          k0 + k < K ? wup[static_cast<long>(e) * K + k0 + k] : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int k = 0; k < KC; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(zt + k * LD + r0);
        const float4 bv = *reinterpret_cast<const float4*>(wt + k * R + c0);
        const float ai[4] = {av.x, av.y, av.z, av.w};
        const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long q = q0 + r0 + i;
    if (q >= q_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) dxc[q * R + c0 + j] = f2bf(acc[i][j]);
  }
}

// ------------------------------------------------------------- host side
int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// one persistent block per SM for the layer kernels (their shared memory
// allows one)
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

template <int R, int S>
int fwd_impl(const int* pack, int pack_cols, const bf16_t* table2, int vocab,
             const bf16_t* ctx, const float* b_fg, const float* w_fg,
             const float* w_out, const float* b_out, const int* dil, float* h,
             float* skacc, bf16_t* hsave, bf16_t* tfsg, bf16_t* skip,
             int batch, int t_len, int n_layers, cudaStream_t st) {
  const long m_total = static_cast<long>(batch) * t_len;
  const int win = ctx ? 3 * R : 2 * R;
  stack_embed_kernel<<<grid_for(m_total * R), kThreads, 0, st>>>(
      pack, pack_cols, table2, vocab, batch, t_len, R, h, hsave);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = FwdShape<R, S>::smem();
  int err = set_smem(reinterpret_cast<const void*>(
                         stack_fwd_layer_kernel<R, S>), smem);
  if (err) return err;
  const int rows = FwdShape<R, S>::kRows;
  // two blocks fit an SM (about 100 KB of shared memory each at R = 64)
  const long tiles = (m_total + rows - 1) / rows;
  const int grid =
      static_cast<int>(tiles < 2 * sm_count() ? tiles : 2 * sm_count());
  for (int l = 0; l < n_layers; ++l) {
    FwdLayerArgs a;
    a.h = h;
    a.hs = hsave + l * m_total * R;
    a.hs_next = l + 1 < n_layers ? hsave + (l + 1) * m_total * R : nullptr;
    a.ctx = ctx;
    a.b_fg = b_fg + static_cast<long>(l) * batch * 2 * R;
    a.w_fg = w_fg + static_cast<long>(l) * win * 2 * R;
    a.w_out = w_out + static_cast<long>(l) * R * (R + S);
    a.b_out = b_out + static_cast<long>(l) * (R + S);
    a.tfsg = tfsg + l * m_total * 2 * R;
    a.skacc = skacc;
    a.skip = skip;
    a.m_total = m_total;
    a.t_len = t_len;
    a.d = dil[l];
    a.first = l == 0;
    a.last = l == n_layers - 1;
    stack_fwd_layer_kernel<R, S><<<grid, kThreads, smem, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <int MODE, int R, int S, int KA>
int wgrad_launch(WgradArgs a, int batch, float* out_w, float* out_b,
                 int bias_groups, cudaStream_t st) {
  constexpr int NB = WgShape<MODE, R, S>::kNb;
  const int slabs = (a.n + NB - 1) / NB;
  const size_t smem = static_cast<size_t>(kWgRows * (KA + NB)) * 4;
  int err = set_smem(reinterpret_cast<const void*>(
                         stack_wgrad_kernel<MODE, R, S, KA>), smem);
  if (err) return err;
  stack_wgrad_kernel<MODE, R, S, KA>
      <<<dim3(batch * a.chunks, slabs), kThreads, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long nw = static_cast<long>(KA) * a.n;
  reduce_kernel<<<grid_for(nw), kThreads, 0, st>>>(a.part, out_w, nw, 1,
                                                   batch * a.chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_kernel<<<grid_for(a.n * bias_groups), kThreads, 0, st>>>(
      a.part_b, out_b, a.n, bias_groups, batch * a.chunks / bias_groups);
  return static_cast<int>(cudaGetLastError());
}

template <int R, int S>
int bwd_impl(const bf16_t* hsave, const bf16_t* tfsg, const bf16_t* ctx,
             const float* w_fg, const float* w_out, const bf16_t* dskip,
             const int* pack, int pack_cols, int vocab, const int* dil,
             const bf16_t* xc, const float* wup, float* scratch, int chunks,
             float* dtab, bf16_t* dctx_out, float* db_fg, float* dw_fg,
             float* dw_out, float* db_out, float* dwup, float* dbup,
             int batch, int t_len, int n_layers, int embed_blocks,
             cudaStream_t st) {
  const long m_total = static_cast<long>(batch) * t_len;
  const int win = ctx ? 3 * R : 2 * R;
  const bool proj = xc != nullptr;
  // float32 scratch: dhp, p[2], dh, dfg, dctx, partials
  float* dhp = scratch;
  float* pbuf[2] = {dhp + m_total * R, dhp + 2 * m_total * R};
  float* dh = dhp + 3 * m_total * R;
  float* dfg = dhp + 4 * m_total * R;
  float* dctx = dhp + 6 * m_total * R;
  float* part = dhp + 7 * m_total * R;
  const size_t smem = bwd_smem<R, S>(win);
  int err = set_smem(reinterpret_cast<const void*>(
                         stack_bwd_layer_kernel<R, S>), smem);
  if (err) return err;
  const long tiles = (m_total + kBwdRows - 1) / kBwdRows;
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  cudaError_t e;
  for (int l = n_layers - 1; l >= 0; --l) {
    BwdLayerArgs a;
    a.dhp = dhp;
    a.p_in = pbuf[(l + 1) & 1];
    a.p_out = pbuf[l & 1];
    a.dh = dh;
    a.dfg = dfg;
    a.dctx = ctx ? dctx : nullptr;
    a.dctx_bf = (ctx && !proj && l == 0) ? dctx_out : nullptr;
    a.dskip = dskip;
    a.tfsg = tfsg + l * m_total * 2 * R;
    a.w_out = w_out + static_cast<long>(l) * R * (R + S);
    a.w_fg = w_fg + static_cast<long>(l) * win * 2 * R;
    a.m_total = m_total;
    a.t_len = t_len;
    a.d_in = l + 1 < n_layers ? dil[l + 1] : 0;
    a.top = l == n_layers - 1;
    a.win = win;
    stack_bwd_layer_kernel<R, S><<<grid, kThreads, smem, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);

    WgradArgs w = {};
    w.hs = hsave + l * m_total * R;
    w.ctx = ctx;
    w.dfg = dfg;
    w.tfsg = tfsg + l * m_total * 2 * R;
    w.dh = dh;
    w.dskip = dskip;
    w.rows_per_batch = t_len;
    w.chunks = chunks;
    w.d = dil[l];
    w.part = part;
    w.part_b = part + static_cast<long>(batch) * chunks * win * 2 * R;
    w.n = 2 * R;
    float* dwf = dw_fg + static_cast<long>(l) * win * 2 * R;
    float* dbf = db_fg + static_cast<long>(l) * batch * 2 * R;
    err = ctx ? wgrad_launch<0, R, S, 3 * R>(w, batch, dwf, dbf, batch, st)
              : wgrad_launch<0, R, S, 2 * R>(w, batch, dwf, dbf, batch, st);
    if (err) return err;
    w.n = R + S;
    w.part_b = part + static_cast<long>(batch) * chunks * R * (R + S);
    err = wgrad_launch<1, R, S, R>(
        w, batch, dw_out + static_cast<long>(l) * R * (R + S),
        db_out + static_cast<long>(l) * (R + S), 1, st);
    if (err) return err;
  }
  // table gradient
  const long per = (m_total + embed_blocks - 1) / embed_blocks;
  const size_t tsmem = static_cast<size_t>(2 * vocab * R) * 4;
  err = set_smem(reinterpret_cast<const void*>(stack_embed_grad_kernel),
                 tsmem);
  if (err) return err;
  stack_embed_grad_kernel<<<embed_blocks, kThreads, tsmem, st>>>(
      dhp, pbuf[0], dil[0], pack, pack_cols, batch, t_len, vocab, R, per,
      part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long nt = 2L * vocab * R;
  reduce_kernel<<<grid_for(nt), kThreads, 0, st>>>(part, dtab, nt, 1,
                                                   embed_blocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (proj) {
    WgradArgs w = {};
    w.xc = xc;
    w.dctx = dctx;
    w.n = 10 * R;
    w.rows_per_batch = t_len / 10;
    w.chunks = chunks;
    w.part = part;
    w.part_b = part + static_cast<long>(batch) * chunks * R * 10 * R;
    err = wgrad_launch<2, R, S, R>(w, batch, dwup, dbup, 1, st);
    if (err) return err;
    const long q_total = m_total / 10;
    const size_t psmem = (64 * 68 + 64 * R) * 4;
    err = set_smem(reinterpret_cast<const void*>(stack_proj_dx_kernel<R>),
                   psmem);
    if (err) return err;
    stack_proj_dx_kernel<R><<<static_cast<int>((q_total + 63) / 64), kThreads,
                              psmem, st>>>(dctx, wup, dctx_out, q_total);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

#define MOVENET_STACK_WIDTHS(X) X(16, 16) X(32, 32) X(64, 64) X(64, 8)

extern "C" {

// 1 if the kernels are built for residual width r and skip width s
int movenet_stack_supports(int r, int s) {
#define X(R_, S_) \
  if (r == R_ && s == S_) return 1;
  MOVENET_STACK_WIDTHS(X)
#undef X
  return 0;
}

// Float32 scratch elements the backward needs (see bwd_impl).
long movenet_stack_bwd_scratch(int batch, int t_len, int r, int s, int win,
                               int chunks, int vocab, int embed_blocks) {
  const long m_total = static_cast<long>(batch) * t_len;
  long part = static_cast<long>(batch) * chunks * (win + 1) * 2 * r;
  const long p_out = static_cast<long>(batch) * chunks * (r + 1) * (r + s);
  const long p_proj = static_cast<long>(batch) * chunks * (r + 1) * 10 * r;
  const long p_tab = static_cast<long>(embed_blocks) * 2 * vocab * r;
  if (p_out > part) part = p_out;
  if (p_proj > part) part = p_proj;
  if (p_tab > part) part = p_tab;
  return 7 * m_total * r + part;
}

// Forward of the whole stack; returns the first cudaError_t.  dil is a
// host array.
int movenet_stack_fwd(const int* pack, int pack_cols, const bf16_t* table2,
                      int vocab, const bf16_t* ctx, const float* b_fg,
                      const float* w_fg, const float* w_out,
                      const float* b_out, const int* dil, float* h,
                      float* skacc, bf16_t* hsave, bf16_t* tfsg,
                      bf16_t* skip, int batch, int t_len, int n_layers, int r,
                      int s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define X(R_, S_)                                                          \
  if (r == R_ && s == S_)                                                  \
    return fwd_impl<R_, S_>(pack, pack_cols, table2, vocab, ctx, b_fg,     \
                            w_fg, w_out, b_out, dil, h, skacc, hsave, tfsg, \
                            skip, batch, t_len, n_layers, st);
  MOVENET_STACK_WIDTHS(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward of the whole stack; returns the first cudaError_t.  dil is a
// host array.  xc/wup are null unless the projection backward is folded in.
int movenet_stack_bwd(const bf16_t* hsave, const bf16_t* tfsg,
                      const bf16_t* ctx, const float* w_fg,
                      const float* w_out, const bf16_t* dskip,
                      const int* pack, int pack_cols, int vocab,
                      const int* dil, const bf16_t* xc, const float* wup,
                      float* scratch, int chunks, float* dtab,
                      bf16_t* dctx_out, float* db_fg, float* dw_fg,
                      float* dw_out, float* db_out, float* dwup, float* dbup,
                      int batch, int t_len, int n_layers, int r, int s,
                      int embed_blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define X(R_, S_)                                                            \
  if (r == R_ && s == S_)                                                    \
    return bwd_impl<R_, S_>(hsave, tfsg, ctx, w_fg, w_out, dskip, pack,       \
                            pack_cols, vocab, dil, xc, wup, scratch, chunks, \
                            dtab, dctx_out, db_fg, dw_fg, dw_out, db_out,    \
                            dwup, dbup, batch, t_len, n_layers,              \
                            embed_blocks, st);
  MOVENET_STACK_WIDTHS(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
