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
// Design.  The TPU walks one batch row's time tiles in order and carries
// the last d rows of h (forward) and the anti-causal dfg_past rows
// (backward) from tile to tile in a VMEM ring.  Blocks here run in no
// order, so nothing is carried between them:
//   forward   one block per tile of 64 rows of one batch row; the tap
//             h(t-d) is read from h in global memory (zero for t < d).
//             [h | h(t-d) | ctx] and gated sit in shared memory in float32;
//             the weights are read as float4 rows through the L2.  Each
//             thread sums a 4x8 register tile with fmaf.
//   backward  persistent blocks (one per SM) walk the same tiles: fg
//             recomputed, dout = [dres | dskip], dgated = dout W_out^T,
//             dfg, dfg_w = dfg W_fg^T.  dh's own part (dres + dfg_w_h) and
//             the past part dfg_w_p are stored apart in float32, and a
//             second launch forms dh[t] = own[t] + past[t + d] across
//             blocks (the carry of the save backward, stack_kernel.cu).
//             dctx is stored from dfg_w_c.  Each block adds its tiles'
//             weight and bias gradients to its own partial sums in global
//             memory, tile after tile in a fixed order; a fixed-order
//             reduction adds the blocks' partials: deterministic, no
//             atomics.
//
// Bound (R = S = 64, B = 2, T = 160000, flat ctx): the forward's products
// are 2 M (3R 2R + R (R+S)) = 2.1e10 float32 operations, 0.31 ms at the
// 67 TF/s of the f32 units, above its 0.16 GB of traffic (0.05 ms); the
// backward's (the fg recompute, dgated, dfg_w and both weight gradients)
// 5.8e10, 0.86 ms.  These kernels run fmaf over shared-memory operands with
// weights from the L2, so instruction rate and latency bound them, far
// above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // rows per tile, all of one batch row
typedef unsigned short bf16_t;

__device__ __forceinline__ bf16_t f2bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}
__device__ __forceinline__ float sigmoidf(float g) {
  return 1.f / (1.f + expf(-g));
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

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// [h | h(t-d) | ctx] rows t0 .. t0 + kRows of batch row b, widened to
// float32, into hp (kRows, ldh); rows at or past T are zero.
template <int R>
__device__ void stage_hp(const bf16_t* h, const bf16_t* ctx, int b, int t0,
                         int t_len, int d, float* hp, int ldh) {
  const int groups = (ctx ? 3 : 2) * (R / 8);
  for (int i = threadIdx.x; i < kRows * groups; i += kThreads) {
    const int row = i / groups, q = i % groups;
    const int part = q / (R / 8), j0 = (q % (R / 8)) * 8;
    const int t = t0 + row;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const long m = static_cast<long>(b) * t_len + t;
    if (t < t_len) {
      if (part == 0)
        load8(h + m * R + j0, v);
      else if (part == 1 && t >= d)
        load8(h + (m - d) * R + j0, v);
      else if (part == 2)
        load8(ctx + m * R + j0, v);
    }
    float* dst = hp + row * ldh + part * R + j0;
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = v[e];
  }
}

// acc[i][0..3] (filter) and acc[i][4..7] (gate) of fg rows r0 .. r0+3,
// columns c0 .. c0+3: sum over k of hp[r, k] W_fg[k, (R +) c0 + j]
template <int R>
__device__ __forceinline__ void fg_tile(const float* hp, int ldh, int win,
                                        const float* w_fg, int r0, int c0,
                                        float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < win; ++k) {
    const float4 wf = ldg4(w_fg + k * 2 * R + c0);
    const float4 wg = ldg4(w_fg + k * 2 * R + R + c0);
    const float w[8] = {wf.x, wf.y, wf.z, wf.w, wg.x, wg.y, wg.z, wg.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = hp[(r0 + i) * ldh + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, w[j], acc[i][j]);
    }
  }
}

struct GatedArgs {
  const bf16_t* h;       // (B, T, R)
  const bf16_t* ctx;     // (B, T, R) or null
  const float* b_fg;     // (B, 2R)
  const float* w_fg;     // (W_in, 2R)
  const float* w_out;    // (R, R+S)
  const float* b_out;    // (R+S)
  bf16_t* res;           // (B, T, R)
  bf16_t* skip;          // (B, T, S)
  int t_len, d;
};

template <int R, int S>
size_t fwd_smem(bool ctx) {
  return static_cast<size_t>(kRows) * ((ctx ? 3 : 2) * R + 4 + R + 4) * 4;
}

template <int R, int S>
__global__ void __launch_bounds__(kThreads) gated_fwd_kernel(GatedArgs a) {
  constexpr int NO = R + S, LDG = R + 4;
  const int win = (a.ctx ? 3 : 2) * R, ldh = win + 4;
  const int n_tb = (a.t_len + kRows - 1) / kRows;
  const int b = blockIdx.x / n_tb, t0 = (blockIdx.x % n_tb) * kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* hp = reinterpret_cast<float*>(smem);   // (kRows, ldh)
  float* gs = hp + kRows * ldh;                   // (kRows, LDG) gated
  const int tid = threadIdx.x;
  const float* bfg = a.b_fg + static_cast<long>(b) * 2 * R;

  stage_hp<R>(a.h, a.ctx, b, t0, a.t_len, a.d, hp, ldh);
  __syncthreads();
  for (int tile = tid; tile < (kRows / 4) * (R / 4); tile += kThreads) {
    const int r0 = (tile / (R / 4)) * 4, c0 = (tile % (R / 4)) * 4;
    float acc[4][8];
    fg_tile<R>(hp, ldh, win, a.w_fg, r0, c0, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        gs[(r0 + i) * LDG + c0 + j] =
            tanhf(acc[i][j] + bfg[c0 + j]) *
            sigmoidf(acc[i][4 + j] + bfg[R + c0 + j]);
  }
  __syncthreads();
  // out = gated W_out + b_out: 8 columns lie wholly in res or skip
  for (int tile = tid; tile < (kRows / 4) * (NO / 8); tile += kThreads) {
    const int r0 = (tile / (NO / 8)) * 4, c0 = (tile % (NO / 8)) * 8;
    float acc[4][8] = {};
    for (int k = 0; k < R; ++k) {
      const float4 w0 = ldg4(a.w_out + k * NO + c0);
      const float4 w1 = ldg4(a.w_out + k * NO + c0 + 4);
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = gs[(r0 + i) * LDG + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, w[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + r0 + i;
      if (t >= a.t_len) continue;
      const long m = static_cast<long>(b) * a.t_len + t;
      unsigned o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = acc[i][j] + a.b_out[c0 + j];
        o[j] = f2bf(c0 < R ? v + hp[(r0 + i) * ldh + c0 + j] : v);
      }
      bf16_t* dst = c0 < R ? a.res + m * R + c0 : a.skip + m * S + c0 - R;
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(o[0] | (o[1] << 16), o[2] | (o[3] << 16),
                     o[4] | (o[5] << 16), o[6] | (o[7] << 16));
    }
  }
}

struct GatedBwdArgs {
  const bf16_t* h;       // (B, T, R)
  const bf16_t* ctx;     // (B, T, R) or null
  const float* b_fg;     // (B, 2R)
  const float* w_fg;     // (W_in, 2R)
  const float* w_fg_t;   // (2R, W_in)
  const float* w_out_t;  // (R+S, R)
  const bf16_t* dres;    // (B, T, R)
  const bf16_t* dskip;   // (B, T, S)
  float* own;            // (B, T, R) dres + dfg_w_h
  float* past;           // (B, T, R) dfg_w_p
  bf16_t* dctx;          // (B, T, R) or null
  float* part;           // (gridDim.x, n_part): [dw_fg | dw_out | db_out |
                         // db_fg (B, 2R)]
  long n_part;
  int batch, t_len, d;
};

template <int R, int S>
size_t bwd_smem(bool ctx) {
  return static_cast<size_t>(kRows) *
         ((ctx ? 3 : 2) * R + 4 + (R + S + 4) + (2 * R + 4) + (R + 4)) * 4;
}

template <int R, int S>
__global__ void __launch_bounds__(kThreads)
    gated_bwd_kernel(GatedBwdArgs a) {
  constexpr int NO = R + S, LDO = NO + 4, LDF = 2 * R + 4, LDG = R + 4;
  const bool has_ctx = a.ctx != nullptr;
  const int win = (has_ctx ? 3 : 2) * R, ldh = win + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* hp = reinterpret_cast<float*>(smem);   // (kRows, ldh)
  float* dout = hp + kRows * ldh;                 // (kRows, LDO)
  float* dfg = dout + kRows * LDO;                // (kRows, LDF)
  float* gs = dfg + kRows * LDF;                  // (kRows, LDG) gated
  const int tid = threadIdx.x;
  float* p_dwfg = a.part + blockIdx.x * a.n_part;
  float* p_dwout = p_dwfg + win * 2 * R;
  float* p_dbout = p_dwout + R * NO;
  float* p_dbfg = p_dbout + NO;
  const int n_tb = (a.t_len + kRows - 1) / kRows;

  for (int tile_i = blockIdx.x; tile_i < a.batch * n_tb;
       tile_i += gridDim.x) {
    const int b = tile_i / n_tb, t0 = (tile_i % n_tb) * kRows;
    const int rows = min(kRows, a.t_len - t0);
    const long m0 = static_cast<long>(b) * a.t_len + t0;
    const float* bfg = a.b_fg + static_cast<long>(b) * 2 * R;
    __syncthreads();
    stage_hp<R>(a.h, a.ctx, b, t0, a.t_len, a.d, hp, ldh);
    for (int i = tid; i < kRows * (NO / 8); i += kThreads) {
      const int row = i / (NO / 8), c0 = (i % (NO / 8)) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (row < rows) {
        if (c0 < R)
          load8(a.dres + (m0 + row) * R + c0, v);
        else
          load8(a.dskip + (m0 + row) * S + c0 - R, v);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) dout[row * LDO + c0 + e] = v[e];
    }
    __syncthreads();

    // fg recomputed, dgated = dout W_out^T, dfg, gated
    for (int tile = tid; tile < (kRows / 4) * (R / 4); tile += kThreads) {
      const int r0 = (tile / (R / 4)) * 4, c0 = (tile % (R / 4)) * 4;
      float acc[4][8];
      fg_tile<R>(hp, ldh, win, a.w_fg, r0, c0, acc);
      float dg[4][4] = {};
      for (int k = 0; k < NO; ++k) {
        const float4 wv = ldg4(a.w_out_t + k * R + c0);
        const float w[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = dout[(r0 + i) * LDO + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) dg[i][j] = fmaf(av, w[j], dg[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float tf = tanhf(acc[i][j] + bfg[c0 + j]);
          const float sg = sigmoidf(acc[i][4 + j] + bfg[R + c0 + j]);
          const int r = r0 + i, c = c0 + j;
          dfg[r * LDF + c] = dg[i][j] * sg * (1.f - tf * tf);
          dfg[r * LDF + R + c] = dg[i][j] * tf * sg * (1.f - sg);
          gs[r * LDG + c] = tf * sg;
        }
    }
    __syncthreads();

    // dfg_w = dfg W_fg^T: dh's own part, the past part, dctx
    const int wc = win / 4;
    for (int tile = tid; tile < (kRows / 4) * wc; tile += kThreads) {
      const int r0 = (tile / wc) * 4, c0 = (tile % wc) * 4;
      float acc[4][4] = {};
      for (int k = 0; k < 2 * R; ++k) {
        const float4 wv = ldg4(a.w_fg_t + k * win + c0);
        const float w[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = dfg[(r0 + i) * LDF + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, w[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + i;
        if (r >= rows) continue;
        const long m = m0 + r;
        if (c0 < R) {
          float4 o;
          o.x = dout[r * LDO + c0] + acc[i][0];
          o.y = dout[r * LDO + c0 + 1] + acc[i][1];
          o.z = dout[r * LDO + c0 + 2] + acc[i][2];
          o.w = dout[r * LDO + c0 + 3] + acc[i][3];
          *reinterpret_cast<float4*>(a.own + m * R + c0) = o;
        } else if (c0 < 2 * R) {
          *reinterpret_cast<float4*>(a.past + m * R + c0 - R) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            a.dctx[m * R + c0 - 2 * R + j] = f2bf(acc[i][j]);
        }
      }
    }

    // the tile's weight and bias gradients into the block's partials
    // (rows past T hold zero dout and dfg, so they add nothing)
    constexpr int NC = 2 * R / 8;
    for (int tile = tid; tile < (win / 4) * NC; tile += kThreads) {
      const int k0 = (tile / NC) * 4, c0 = (tile % NC) * 8;
      float acc[4][8] = {};
      for (int r = 0; r < rows; ++r) {
        const float4 av4 = *reinterpret_cast<const float4*>(hp + r * ldh + k0);
        const float4 b0 = *reinterpret_cast<const float4*>(dfg + r * LDF + c0);
        const float4 b1 =
            *reinterpret_cast<const float4*>(dfg + r * LDF + c0 + 4);
        const float av[4] = {av4.x, av4.y, av4.z, av4.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) p_dwfg[(k0 + i) * 2 * R + c0 + j] += acc[i][j];
    }
    constexpr int OC = NO / 8;
    for (int tile = tid; tile < (R / 4) * OC; tile += kThreads) {
      const int k0 = (tile / OC) * 4, c0 = (tile % OC) * 8;
      float acc[4][8] = {};
      for (int r = 0; r < rows; ++r) {
        const float4 av4 = *reinterpret_cast<const float4*>(gs + r * LDG + k0);
        const float4 b0 = *reinterpret_cast<const float4*>(dout + r * LDO + c0);
        const float4 b1 =
            *reinterpret_cast<const float4*>(dout + r * LDO + c0 + 4);
        const float av[4] = {av4.x, av4.y, av4.z, av4.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) p_dwout[(k0 + i) * NO + c0 + j] += acc[i][j];
    }
    if (tid < 2 * R) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += dfg[r * LDF + tid];
      p_dbfg[b * 2 * R + tid] += s;
    } else if (tid - 2 * R < NO) {
      const int c = tid - 2 * R;
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += dout[r * LDO + c];
      p_dbout[c] += s;
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

// out[e] = sum over the blocks c of part[c, e], in block order
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* part, float* out, long n_el, int n_parts) {
  for (long e = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x;
       e < n_el; e += static_cast<long>(gridDim.x) * kThreads) {
    float s = 0.f;
    for (int c = 0; c < n_parts; ++c) s += part[c * n_el + e];
    out[e] = s;
  }
}

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

long n_part_of(int r, int s, int win, int batch) {
  return static_cast<long>(win) * 2 * r + r * (r + s) + (r + s) +
         static_cast<long>(batch) * 2 * r;
}

template <int R, int S>
int fwd_impl(const GatedArgs& a, int batch, cudaStream_t st) {
  const size_t smem = fwd_smem<R, S>(a.ctx != nullptr);
  int err = set_smem(reinterpret_cast<const void*>(gated_fwd_kernel<R, S>),
                     smem);
  if (err) return err;
  const int n_tb = (a.t_len + kRows - 1) / kRows;
  gated_fwd_kernel<R, S><<<batch * n_tb, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int R, int S>
int bwd_impl(const GatedBwdArgs& a, int blocks, bf16_t* dh, float* grads,
             cudaStream_t st) {
  const size_t smem = bwd_smem<R, S>(a.ctx != nullptr);
  int err = set_smem(reinterpret_cast<const void*>(gated_bwd_kernel<R, S>),
                     smem);
  if (err) return err;
  cudaError_t e = cudaMemsetAsync(
      a.part, 0, static_cast<size_t>(blocks) * a.n_part * sizeof(float), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  gated_bwd_kernel<R, S><<<blocks, kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long total = static_cast<long>(a.batch) * a.t_len * R;
  gated_carry_kernel<<<grid_for(total), kThreads, 0, st>>>(
      a.own, a.past, a.d, a.t_len, R, total, dh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_kernel<<<grid_for(a.n_part), kThreads, 0, st>>>(a.part, grads,
                                                         a.n_part, blocks);
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

// Persistent blocks of the backward: one per SM.
int movenet_gated_blocks() { return sm_count(); }

// Float32 elements of one block's partial gradients, and of the reduced
// [dw_fg (W_in, 2R) | dw_out (R, R+S) | db_out (R+S) | db_fg (B, 2R)].
long movenet_gated_bwd_part(int r, int s, int win, int batch) {
  return n_part_of(r, s, win, batch);
}

// Forward: res and skip (bf16); returns the first cudaError_t.
int movenet_gated_fwd(const bf16_t* h, const bf16_t* ctx, const float* b_fg,
                      const float* w_fg, const float* w_out,
                      const float* b_out, bf16_t* res, bf16_t* skip,
                      int batch, int t_len, int r, int s, int d,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  GatedArgs a = {h, ctx, b_fg, w_fg, w_out, b_out, res, skip, t_len, d};
#define X(R_, S_) \
  if (r == R_ && s == S_) return fwd_impl<R_, S_>(a, batch, st);
  MOVENET_GATED_WIDTHS(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward: dh, dctx (bf16; dctx null without ctx) and grads (float32,
// movenet_gated_bwd_part elements); own and past are (B, T, R) float32
// scratch, part `blocks` x movenet_gated_bwd_part floats.  Returns the
// first cudaError_t.
int movenet_gated_bwd(const bf16_t* h, const bf16_t* ctx, const float* b_fg,
                      const float* w_fg, const float* w_fg_t,
                      const float* w_out_t, const bf16_t* dres,
                      const bf16_t* dskip, float* own, float* past,
                      float* part, int blocks, bf16_t* dh, bf16_t* dctx,
                      float* grads, int batch, int t_len, int r, int s, int d,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  GatedBwdArgs a = {};
  a.h = h;
  a.ctx = ctx;
  a.b_fg = b_fg;
  a.w_fg = w_fg;
  a.w_fg_t = w_fg_t;
  a.w_out_t = w_out_t;
  a.dres = dres;
  a.dskip = dskip;
  a.own = own;
  a.past = past;
  a.dctx = dctx;
  a.part = part;
  a.n_part = n_part_of(r, s, ctx ? 3 * r : 2 * r, batch);
  a.batch = batch;
  a.t_len = t_len;
  a.d = d;
#define X(R_, S_) \
  if (r == R_ && s == S_) return bwd_impl<R_, S_>(a, blocks, dh, grads, st);
  MOVENET_GATED_WIDTHS(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
