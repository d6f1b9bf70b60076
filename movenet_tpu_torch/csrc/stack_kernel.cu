// Whole-stack WaveNet trunk of the training step, forward and backward.
//
// Replaces the TPU kernels movenet_tpu/ops/pallas/stack_kernel.py:
//   _fwd_kernel (stack_kernel.py:280, pallas_call at :424), "save" strategy
//     with the front embedding folded in: every gated block of the stack,
//     writing skip_sum (B,T,S), hsave (L,B,T,R) and tfsg (L,B,T,2R);
//   _bwd_kernel_padded (stack_kernel.py:1486, pallas_call at :1443): the
//     backward from hsave/tfsg, with the embedding-table gradient and the
//     stride-10 video-projection backward folded in;
//   _fwd_kernel_tails (stack_kernel.py:929) and _bwd_kernel_tails (:1031),
//     the "recompute" strategy: layer-major launches with layer
//     checkpoints, see "the layer kernel" below;
//   _fwd_kernel_head (stack_kernel.py:464, pallas_call at :576) and
//     _bwd_kernel_head (:624, pallas_call at :822), the trunk merged with
//     the output head and the CE loss;
//   _fwd_kernel and _bwd_kernel_padded with save_h=False, the "replay"
//     strategy: the save kernels without hsave, the layer inputs rebuilt
//     in the backward, see "the replay strategy" below.
// The save kernels also run in their non-embed form (x in, dx out; the
// JAX package's fused_stack with strategy "save"), which the merged and
// replay kernels build on.  Every form takes the bf16 compute dtype (the
// operands of the forward products are bf16, the backward's are f32, as
// on the TPU); the save forms (embed and non-embed), the recompute and
// the replay forms also take float32 (the float32 compute dtype:
// stack_layer_f32_kernel and the backward's float32 forms, see "the
// float32 save forward" below).  The bf16 save, recompute and replay forms
// also run at R = 128 (MOVENET_WIDE_WIDTHS), their weights streamed through
// shared memory: see "the wide save forms" and "the wide recompute forms";
// the float32 recompute forms there, and every backward's layer launch and
// the bf16 forms' W_fg gradient, run on wgmma: "the wide float32 recompute
// kernels".
//
// Design.  The TPU runs a (batch, time tile) grid in order and carries the
// dilation rings and the weight-gradient sums from one grid step to the
// next.  Here every launch is parallel over time instead:
//   forward   one launch for the embedding (or x), then one per layer
//             (layer-major) of the layer kernel, stack_layer_kernel<R, S,
//             FORM>: one launch template over two bodies, see "the layer
//             kernel" below.  The recompute strategy's body runs 16 warps a
//             block on 256-row tiles and keeps h in bf16 between layers;
//             the save forms' body (the save strategy's layers, and the
//             merged form's, whose last layer runs the head) runs 8 warps a
//             block on 128-row tiles and keeps h and the skip sum in
//             float32 in global memory between launches.  The two share
//             the fg product on the tensor cores (fg_mma) and W_fg^T's
//             layout; both walk tiles with persistent blocks.  The tap
//             h(t-d) is read back from the layer's input, which the previous
//             launch wrote, so no ring and no halo is needed for any d.
//             Per tile: [h | h(t-d) | ctx] staged in bf16 in shared memory
//             beside W_fg^T and W_out^T (staged once per block); each warp
//             takes 16 rows through fg, the gate, out, the residual and
//             the skip sum.
//   backward  one launch per layer, top down (one persistent block per SM,
//             64-row tiles, W_out and W_fg staged once in float32 as they
//             lie in global memory), each followed by two weight-gradient
//             launches and their fixed-order reductions.  The anti-causal
//             carry dfg_p(t+d) crosses blocks, so the layer launch stores
//             dh + dfg_w_h and dfg_w_p apart; the next launch adds them up
//             row by row (two buffers for dfg_w_p).  dfg (f32) is stored
//             for the weight-gradient launches, which keep their tiles of
//             the sum in registers over a (batch, chunk) range of rows and
//             write per-block partial sums, added by a second pass in fixed
//             order: deterministic, no atomics.  The bias gradients are the
//             column sums of the same operands.  The table gradient adds dh
//             rows by code into a per-block table, each column's rows in
//             order, then a fixed-order reduction; the projection backward
//             is one more weight-gradient launch (dwup, dbup) and one
//             product for dxc.
// The merged form is the non-embed save form with two changes.  Its
// forward forms gated from the unrounded taps, and the last layer's launch
// runs the head on each warp's rows once their skip sums are final
// (rounded to bf16, stored, then leaky, W1, leaky, W2 on bf16 operands, the
// NLL and the argmax match per valid row); the logits never reach global
// memory, and the blocks' loss and match sums are added in a fixed order.
// Its backward starts with a head launch (the layer launch's shared memory
// has no room for the head): y and z rebuilt from the saved skip, dz, the
// head's weight gradients as per-block partials, and dskip in float32,
// which the layer launches and the W_out gradient read unrounded.
// The TPU's per-tile ring snapshots (tails) are not produced: hsave holds
// those rows (the recompute strategy keeps layer checkpoints instead).
//
// Products.  The forward's run as bf16 mma.sync m16n8k16 on the tensor
// cores with float32 sums, each 16-wide k step summed from zero and added
// in float32 (mma_bf16_add): fg, out and the merged head's y and z.  The
// operands are exact bf16 values, as the TPU kernel's _mdot rounds them,
// so only the order of the float32 sums differs from the plain version.
// The save forms keep the plain version's bits, and with them two fmaf
// products: the residual's out = gated W_out[:, :R], and fg again for
// the elements near a bf16 rounding tie (see the layer kernel).
// The save backward's take float32 operands, as the TPU kernel's
// (stack_kernel.py:199 _BWD_OPERAND_DT, a multi-pass MXU product there);
// here they run on the tensor cores as split-TF32 mma.sync (m16n8k8,
// float32 sums; see "backward" below; at R = 128 the layer launch and
// W_fg's gradient as split-TF32 wgmma, "the wide layer backwards on
// wgmma"): the layer launch's dgated = [dh | dskip] W_out^T and dfg_w =
// dfg W_fg^T in three passes, the weight
// gradients dW_out = gated^T [dh | dskip] in three and dW_fg = [hsave |
// hsave(t-d) | ctx]^T dfg and dW_up = xc^T dctx in two.  Every warp walks
// its rows and k in a fixed order: two calls give the same bits.  The
// recompute strategy's gradients are the save backward's split-TF32 ones;
// the merged backward's head launch and dxc keep fmaf.
//
// Bound (breakdancing shape: B=2, T=160000, L=9, R=S=64, ctx): forward
// about 1.9e11 flop in bf16 operands and 1.19 GB of compulsory traffic
// (hsave, tfsg, skip, ctx), so the tensor-core bound is 0.36 ms, memory;
// backward about 3.9e11 flop counted once, 0.78 ms at the 495 TF/s of
// TF32 (the split passes, about 2.6 per product, are the design's
// cost), against 0.33 ms of compulsory traffic: bound by operations.
// Beside the compulsory traffic the backward moves float32 intermediates
// through global memory (dh, the carry, dfg, dctx: about 1.35 GB a layer
// at that shape), a floor of about 3.6 ms over 9 layers until the weight
// gradients are fused into the layer launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "head_core.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kThreads = 256;
typedef unsigned short bf16_t;

__device__ __forceinline__ float bf2f(bf16_t u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ bf16_t f2bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
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

// ------------------------------------------------------------ forward
__global__ void __launch_bounds__(kThreads)
    stack_embed_kernel(const int* pack, int pack_cols, const bf16_t* table2,
                       int vocab, int batch, int t_len, int r,
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
    hsave0[i] = f2bf(v);              // the embedded h is rounded
  }
}

// The non-embed forms start from x (B, T, R) instead of the embedding:
// hsave[0] = x.
__global__ void __launch_bounds__(kThreads)
    stack_x_kernel(const bf16_t* x, long total, bf16_t* hsave0) {
  for (long i = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x;
       i < total; i += static_cast<long>(gridDim.x) * kThreads)
    hsave0[i] = x[i];
}

// ----------------------------------------------------------- backward
// The backward's products take float32 operands (stack_kernel.py:199
// _BWD_OPERAND_DT): split-TF32 mma.sync, mma_tf32.cuh.
__device__ __forceinline__ unsigned ld32(const bf16_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// 16 bytes (8 bf16) of one row of the recompute product's operand [h |
// h(t-d) | ctx], from column c8 of its W_in: zero past the rows, and for
// the tap before t = d.  Row indices fit 32 bits (B*T < 2^31).
template <int R>
__device__ __forceinline__ uint4 hp_item(const bf16_t* h, const bf16_t* ctx,
                                         long m, long m_total, int t_len,
                                         int d, int c8) {
  const uint4 z = make_uint4(0, 0, 0, 0);
  if (m >= m_total) return z;
  const int part = c8 / R, j0 = c8 % R;
  if (part == 0) return *reinterpret_cast<const uint4*>(h + m * R + j0);
  if (part == 1)
    return static_cast<int>(static_cast<unsigned>(m) %
                            static_cast<unsigned>(t_len)) >= d
               ? *reinterpret_cast<const uint4*>(h + (m - d) * R + j0)
               : z;
  return *reinterpret_cast<const uint4*>(ctx + m * R + j0);
}

// fg = [h | h(t-d) | ctx] W_fg of the layer kernel, bf16 operands and
// float32 sums, for one warp's 16 rows of an operand tile hp (bf16, row
// stride LDH) and NT n tiles: k over W_in in order, each n tile's sum from
// zero.  bfrag(kk, j, b) gives the B fragment of k step kk and n tile j
// (W_fg rounded to bf16).  Every form of the layer forward, the recompute
// strategy's rebuild in the backward and the layer backward's recompute
// all sum through here, so the same operand values give the same bits.
template <int NT, int LDH, typename BF>
__device__ __forceinline__ void fg_mma(float (&acc)[NT][4], const bf16_t* hp,
                                       int r0, int win, BF bfrag) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int kk = 0; kk < win / 16; ++kk) {
    const bf16_t* p = hp + (r0 + g) * LDH + 16 * kk + 2 * q;
    const unsigned af[4] = {ld32(p), ld32(p + 8 * LDH), ld32(p + 8),
                            ld32(p + 8 * LDH + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned b[2];
      bfrag(kk, j, b);
      mma_bf16_add(acc[j], af, b);
    }
  }
}

__device__ __forceinline__ float sigmoidf(float g) {
  return 1.f / (1.f + expf(-g));
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
// 8 bytes (zero where not valid), through L1
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0)
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

// The operand rows [h | h(t-d) | ctx] of the tile at row m0 into hp (row
// stride LDH) by cp.async: zero past the rows and for the tap before t = d,
// as hp_item.  Row indices fit 32 bits (B*T < 2^31).
template <int R, int LDH, int ROWS, int THREADS>
__device__ __forceinline__ void stage_operands(bf16_t* hp, const bf16_t* h,
                                               const bf16_t* ctx, long m0,
                                               long m_total, int t_len,
                                               int d, int per_row) {
  for (int i = threadIdx.x; i < ROWS * per_row; i += THREADS) {
    const int row = i / per_row, c8 = 8 * (i % per_row);
    const int part = c8 / R, j0 = c8 % R;
    const long m = m0 + row;
    bool ok = m < m_total;
    const bf16_t* src = h + m * R + j0;
    if (part == 1) {
      ok = ok && static_cast<int>(static_cast<unsigned>(m) %
                                  static_cast<unsigned>(t_len)) >= d;
      src -= static_cast<long>(d) * R;
    } else if (part == 2) {
      src = ctx + m * R + j0;
    }
    cp_async16(hp + row * LDH + c8, ok ? src : h, ok);
  }
}

struct BwdLayerArgs {
  float* dhp;            // (M, R) in: layer l+1's dh + dfg_w_h; out: layer l's
  const float* p_in;     // (M, R) layer l+1's dfg_w past part (not at top)
  float* p_out;          // (M, R) this layer's
  float* dh;             // (M, R) out: gradient of this layer's output h
  float* dfg;            // (M, 2R) out
  float* dctx;           // (M, R) float32 accumulator, or null
  bf16_t* dctx_bf;       // (M, R) flat dctx, stored by layer 0, or null
  const bf16_t* dskip;   // (M, S), or null when dskip_f is given
  const float* dskip_f;  // (M, S) float32 dskip (the merged head's)
  const bf16_t* tfsg;    // (M, 2R)
  const float* tfsg_f;   // (M, 2R) the float32 form's taps
  const float* w_out;    // (R, R+S)
  const float* w_fg;     // (W_in, 2R)
  long m_total;
  int t_len, d_in, top, win;
  // the recompute form (no tfsg): the taps recomputed from this layer's
  // input, its fg bias rows and the layer's dilation; gated = tf * sg out
  // (the float32 form stores gated too)
  const bf16_t* hs;      // (M, R) h_l
  const bf16_t* cx;      // (M, R) ctx, or null
  const float* b_fg;     // (B, 2R)
  float* gated;          // (M, R) float32
  int d;
  // the recompute form in float32: h_l and ctx in float32
  const float* hs_f;     // (M, R)
  const float* cx_f;     // (M, R), or null
  // the wide recompute form: this layer's W_fg^T (2R, W_in) in bf16 (the
  // forward's weight scratch)
  const bf16_t* wt;
};

// The widest R of the layouts below and of the forward's; wider trunks
// (R = 128) run the wide forms, whose weights stream through shared memory
// (see "the wide save forms"; the wide layer backwards and W_fg's gradient
// there run on wgmma, "the wide layer backwards on wgmma").
constexpr int kNarrowR = 64;

// Each SM runs two tile pipelines of 8 warps, so that one pipeline's
// loads and stores overlap the other's products: at R = 64 two halves of
// one 512-thread block (the weights staged once in shared memory for
// both), each walking 32-row tiles with a barrier of its own; at R <= 32
// two 256-thread blocks of 64-row tiles.  The wide widths (R > kNarrowR)
// run stack_bwd_wg_kernel (WgF32Bwd's block) in every form.
template <int R, int S>
struct BwdShape {
  static constexpr int kHalves = R == 64 ? 2 : 1;   // pipelines per block
  static constexpr int kThreads = 256 * kHalves;
  static constexpr int kRows = 64 / kHalves;        // rows per tile
  static constexpr int kMt = kRows / 16;            // row tiles of 16
  static constexpr int kTpw = R / 8 / (8 / kMt);    // n tiles of 8 per warp
  // row-major, row strides of 4 mod 8 floats (8 mod 16 bf16), so that
  // the fragment loads of a warp fall in 32 distinct banks
  static constexpr int kNo = R + S;
  static constexpr int kLdd = kNo + 4;     // [dh | dskip] rows, W_out rows
  static constexpr int kLdf = 2 * R + 4;   // dfg rows, W_fg rows
  static constexpr int kLdt = 2 * R + 8;   // tfsg rows (bf16)
  // one pipeline's tiles, in bytes
  static constexpr size_t kTile =
      static_cast<size_t>(kRows * kLdd + kRows * kLdf) * 4 +
      static_cast<size_t>(kRows * kLdt) * 2;
  static size_t smem(int win);
  // the recompute form: the [h | h(t-d) | ctx] rows (bf16, stride 8 mod 16
  // as kLdt) in place of the taps
  static constexpr int kLdh = 3 * R + 8;
  static constexpr size_t kTileRc =
      static_cast<size_t>(kRows * kLdd + kRows * kLdf) * 4 +
      static_cast<size_t>(kRows * kLdh) * 2;
  static size_t smem_rc(int win);
  // the float32 form: the taps (float32) are staged in the dfg rows, which
  // their dfg then overwrites place by place
  static constexpr size_t kTileF32 =
      static_cast<size_t>(kRows * kLdd + kRows * kLdf) * 4;
  static size_t smem_f32(int win) {
    return static_cast<size_t>(R * kLdd + win * kLdf) * 4 +
           kHalves * kTileF32;
  }
  // the recompute form in float32: the [h | h(t-d) | ctx] rows (float32,
  // stride 4 mod 32 floats) lie over the tile's [dh | dskip] and dfg rows,
  // which take their values only once fg is formed; the same bytes as the
  // float32 form
  static constexpr int kLdhf = 3 * R + 4;
  static_assert(kLdhf <= kLdd + kLdf, "the operand rows fit the tile");
  static size_t smem_rcf32(int win);
};

template <int R, int S>
struct WgF32Bwd;

template <int R, int S>
size_t BwdShape<R, S>::smem(int win) {
  if constexpr (R > kNarrowR)
    return WgF32Bwd<R, S>::kEnd;
  else
    return static_cast<size_t>(R * kLdd + win * kLdf) * 4 + kHalves * kTile;
}

template <int R, int S>
size_t BwdShape<R, S>::smem_rcf32(int win) {
  if constexpr (R > kNarrowR)
    return WgF32Bwd<R, S>::kEnd;
  else
    return smem_f32(win);
}

template <int R, int S>
size_t BwdShape<R, S>::smem_rc(int win) {
  if constexpr (R > kNarrowR)
    return WgF32Bwd<R, S>::kEnd;
  else
    return static_cast<size_t>(R * kLdd + win * kLdf) * 4 +
           kHalves * kTileRc;
}

// the layer backward's forms: the save strategy's (bf16 taps), the
// recompute strategy's, the float32 save form (float32 taps) and the
// recompute strategy's in float32
constexpr int kBwdSave = 0, kBwdRc = 1, kBwdF32 = 2, kBwdRcF32 = 3;

// A barrier over one pipeline's 256 threads.
template <int HALVES>
__device__ __forceinline__ void pipe_sync(int h) {
  if (HALVES == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, 256;" ::"r"(h + 1) : "memory");
}

// One tile's global inputs of one thread, held in registers from the
// tile before it: dh (the layer above's dh + dfg_w_h with the carry
// added), dskip and the taps, each 16 bytes of one row.
template <int R, int S, int FORM>
struct BwdTileRegs {
  static constexpr bool kTg = FORM == kBwdSave, kF32 = FORM == kBwdF32;
  static constexpr int kRows = BwdShape<R, S>::kRows;
  static constexpr int kNh = kRows * (R / 4) / 256;   // exact
  static constexpr int kNs = (kRows * (S / 4) + 255) / 256;
  static constexpr int kNp = (kRows * (3 * R / 8) + 255) / 256;
  float4 dh[kNh];
  float4 sk[kNs];
  uint4 tg[kTg ? kNh : 1];   // 8 taps per item: 2R per row, as many as dh
  uint4 hp[FORM == kBwdRc ? kNp : 1];   // the recompute form: [h | h(t-d)
                                        // | ctx] items
  float4 tf[kF32 ? kNh : 1], sg[kF32 ? kNh : 1];   // the float32 taps
};

// ht: the thread's index in its pipeline
template <int R, int S, int FORM>
__device__ __forceinline__ void bwd_fetch(const BwdLayerArgs& a, long m0,
                                          int ht,
                                          BwdTileRegs<R, S, FORM>& f) {
  using Regs = BwdTileRegs<R, S, FORM>;
  constexpr bool RC = FORM == kBwdRc, F32 = FORM == kBwdF32;
#pragma unroll
  for (int u = 0; u < Regs::kNh; ++u) {
    const int i = ht + u * 256;
    const int row = i / (R / 4), j0 = 4 * (i % (R / 4));
    const long m = m0 + row;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 tf = v, sg = v;
    uint4 tg = make_uint4(0, 0, 0, 0);
    if (m < a.m_total) {
      if (!a.top) {
        v = *reinterpret_cast<const float4*>(a.dhp + m * R + j0);
        if (static_cast<int>(m % a.t_len) + a.d_in < a.t_len) {
          const float4 c = *reinterpret_cast<const float4*>(
              a.p_in + (m + a.d_in) * R + j0);
          v = make_float4(v.x + c.x, v.y + c.y, v.z + c.z, v.w + c.w);
        }
      }
      if (Regs::kTg)
        tg = *reinterpret_cast<const uint4*>(a.tfsg + m * 2 * R + 2 * j0);
      if (F32) {
        tf = *reinterpret_cast<const float4*>(a.tfsg_f + m * 2 * R + j0);
        sg = *reinterpret_cast<const float4*>(a.tfsg_f + m * 2 * R + R + j0);
      }
    }
    f.dh[u] = v;
    if (Regs::kTg) f.tg[u] = tg;
    if (F32) {
      f.tf[u] = tf;
      f.sg[u] = sg;
    }
  }
  if (RC) {
    const int per_row = a.win / 8;
#pragma unroll
    for (int u = 0; u < Regs::kNp; ++u) {
      const int i = ht + u * 256;
      if (i < Regs::kRows * per_row)
        f.hp[u] = hp_item<R>(a.hs, a.cx, m0 + i / per_row, a.m_total,
                             a.t_len, a.d, 8 * (i % per_row));
    }
  }
#pragma unroll
  for (int u = 0; u < Regs::kNs; ++u) {
    const int i = ht + u * 256;
    const int row = i / (S / 4), j0 = 4 * (i % (S / 4));
    const long m = m0 + row;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (i < Regs::kRows * (S / 4) && m < a.m_total) {
      if (a.dskip_f) {
        const float4 q =
            *reinterpret_cast<const float4*>(a.dskip_f + m * S + j0);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      } else {
        load4(a.dskip + m * S + j0, v);
      }
    }
    f.sk[u] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Persistent blocks walk the tiles (pipeline h of block b takes tiles
// b * halves + h, then every gridDim.x * halves-th); the next tile's
// inputs are loaded into registers while this one computes.  A
// pipeline's 8 warps: warp w takes rows 16 (w % kMt) .. +16 and a
// contiguous 1 / (8 / kMt) of each product's columns (kTpw n tiles of
// dgated, W_in / 8 / (8 / kMt) of dfg_w), k in order: fixed sums.
// FORM kBwdRc: the recompute form (stack_bwd_tails).  Its tile holds [h |
// h(t-d) | ctx] in place of the taps; each warp recomputes fg for its
// dgated columns (filter and gate, bf16 mma through fg_mma from W_fg in
// shared memory rounded as it loads), keeps tf and sg in float32 registers
// at the places of its dgated sums, and stores gated = tf * sg (float32)
// for the W_out gradient.  FORM kBwdF32: the float32 save form
// (stack_bwd_f32).  Its float32 taps are staged in the tile's dfg rows,
// where each thread reads tf and sg of its dgated places, stores gated =
// tf * sg (float32) for the W_out gradient and overwrites them with dfg.
// FORM kBwdRcF32: the recompute form in float32 (stack_bwd_tails_f32).
// Each tile's [h | h(t-d) | ctx] rows (float32) land by cp.async in the
// bytes of its [dh | dskip] and dfg rows; each warp forms fg for its dgated
// columns as split-TF32 mma.sync from W_fg in shared memory (its float32
// values), keeps tf and sg in registers as kBwdRc does, and after a barrier
// the tile's dh and dskip take those bytes.  At R > kNarrowR every form
// runs stack_bwd_wg_kernel ("the wide layer backwards on wgmma").
template <int R, int S, int FORM>
__global__ void __launch_bounds__(BwdShape<R, S>::kThreads,
                                  BwdShape<R, S>::kHalves == 2 ? 1 : 2)
    stack_bwd_layer_kernel(BwdLayerArgs a) {
  static_assert(R <= kNarrowR, "the wide widths run stack_bwd_wg_kernel");
  using Sh = BwdShape<R, S>;
  using Regs = BwdTileRegs<R, S, FORM>;
  constexpr bool RC = FORM == kBwdRc, F32 = FORM == kBwdF32;
  constexpr bool RCF = FORM == kBwdRcF32;
  // the float32 forms add each k step in float32 (mma_split_add)
  constexpr bool ADD = F32 || RCF;
  constexpr int NO = Sh::kNo, LDD = Sh::kLdd, LDF = Sh::kLdf;
  constexpr int LDT = Sh::kLdt, ROWS = Sh::kRows, TPW = Sh::kTpw;
  constexpr int H = Sh::kHalves, MT = Sh::kMt;
  constexpr int NP = 3 * R / 8 / (8 / MT);   // product 2's n tiles, at most
  static_assert(R % 16 == 0 && S % 8 == 0 && TPW >= 1,
                "8 warps per pipeline over 16-row, 8-column tiles");
  const int win = a.win;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wo = reinterpret_cast<float*>(smem);   // (R, LDD) W_out
  float* wf = wo + R * LDD;                       // (win, LDF) W_fg
  const int tid = threadIdx.x, h = tid / 256, ht = tid % 256;
  unsigned char* mine = reinterpret_cast<unsigned char*>(wf + win * LDF) +
                        h * (RC ? Sh::kTileRc
                                : F32 || RCF ? Sh::kTileF32 : Sh::kTile);
  float* dd = reinterpret_cast<float*>(mine);   // (ROWS, LDD) [dh | dskip]
  float* ff = dd + ROWS * LDD;                    // (ROWS, LDF) dfg
  bf16_t* ts = reinterpret_cast<bf16_t*>(ff + ROWS * LDF);   // (ROWS, LDT)
  bf16_t* hq = ts;                 // RC: (ROWS, kLdh) [h | h(t-d) | ctx]
  float* hf = dd;                  // RCF: (ROWS, kLdhf) [h | h(t-d) | ctx]
  const int warp = ht >> 5, g = (ht & 31) >> 2, q = ht & 3;
  const int r0 = (warp % MT) * 16;                // the warp's rows
  const int n0 = (warp / MT) * TPW * 8;           // and dgated columns
  const bool ctx_sum = a.dctx != nullptr && !a.top;

  // the weights as they lie in global memory (one row per output
  // column, k along the row), staged once for both pipelines
  for (int i = tid; i < R * NO; i += Sh::kThreads)
    wo[(i / NO) * LDD + i % NO] = a.w_out[i];
  for (int i = tid; i < win * 2 * R; i += Sh::kThreads)
    wf[(i / (2 * R)) * LDF + i % (2 * R)] = a.w_fg[i];
  __syncthreads();
  const long n_tiles = (a.m_total + ROWS - 1) / ROWS;
  const long step = static_cast<long>(gridDim.x) * H;
  const long first = static_cast<long>(blockIdx.x) * H + h;
  Regs nx;
  if (first < n_tiles) bwd_fetch<R, S, FORM>(a, first * ROWS, ht, nx);
  for (long tile_i = first; tile_i < n_tiles; tile_i += step) {
  const long m0 = tile_i * ROWS;
  pipe_sync<H>(h);
  // RCF: tf and sg of the warp's dgated places, from fg formed again in
  // float32 from the tile's operand rows
  float tfr[RCF ? TPW : 1][4], sgr[RCF ? TPW : 1][4];
  if constexpr (RCF) {
    constexpr int LDHF = Sh::kLdhf;
    const int per_row = win / 4;
    for (int i = ht; i < ROWS * per_row; i += 256) {
      const int row = i / per_row, c4 = 4 * (i % per_row);
      const int part = c4 / R, j0 = c4 % R;
      const long m = m0 + row;
      bool ok = m < a.m_total;
      const float* src = a.hs_f + m * R + j0;
      if (part == 1) {
        ok = ok && static_cast<int>(m % a.t_len) >= a.d;
        src -= static_cast<long>(a.d) * R;
      } else if (part == 2) {
        src = a.cx_f + m * R + j0;
      }
      cp_async16(hf + row * LDHF + c4, ok ? src : a.hs_f, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    pipe_sync<H>(h);
    float fa[2 * TPW][4];
#pragma unroll
    for (int j = 0; j < 2 * TPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) fa[j][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < win; k0 += 8) {
      Frag<4> ha;
      load_a_rows<true>(hf + r0 * LDHF + k0, LDHF, ha);
#pragma unroll
      for (int j = 0; j < 2 * TPW; ++j) {
        const int n = j < TPW ? n0 + 8 * j : R + n0 + 8 * (j - TPW);
        Frag<2> fb;
        load_b_kmajor(wf + k0 * LDF + n, LDF, fb);
        mma_split_add<true>(fa[j], ha, fb);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long m = m0 + r0 + g + 8 * (e >> 1);
      const float* bf = a.b_fg + (m < a.m_total ? m / a.t_len : 0) * 2 * R;
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        const int c = n0 + 8 * j + 2 * q + (e & 1);
        tfr[j][e] = tanhf(fa[j][e] + __ldg(bf + c));
        sgr[j][e] = sigmoidf(fa[TPW + j][e] + __ldg(bf + R + c));
      }
    }
    // every warp is done with the operand rows before dh and dskip land
    pipe_sync<H>(h);
  }
  // dh of this layer's output (the layer above's dh + dfg_w_h, plus its
  // anti-causal carry dfg_w_p(t + d)), dskip and the taps into shared
  // memory; dh to global memory for the W_out gradient
#pragma unroll
  for (int u = 0; u < Regs::kNh; ++u) {
    const int i = ht + u * 256;
    const int row = i / (R / 4), j0 = 4 * (i % (R / 4));
    const long m = m0 + row;
    if (m < a.m_total)
      *reinterpret_cast<float4*>(a.dh + m * R + j0) = nx.dh[u];
    *reinterpret_cast<float4*>(dd + row * LDD + j0) = nx.dh[u];
    if (Regs::kTg)
      *reinterpret_cast<uint4*>(ts + row * LDT + 2 * j0) = nx.tg[u];
    if (F32) {
      *reinterpret_cast<float4*>(ff + row * LDF + j0) = nx.tf[u];
      *reinterpret_cast<float4*>(ff + row * LDF + R + j0) = nx.sg[u];
    }
  }
  if (RC) {
    const int per_row = win / 8;
#pragma unroll
    for (int u = 0; u < Regs::kNp; ++u) {
      const int i = ht + u * 256;
      if (i < ROWS * per_row)
        *reinterpret_cast<uint4*>(hq + (i / per_row) * Sh::kLdh +
                                  8 * (i % per_row)) = nx.hp[u];
    }
  }
#pragma unroll
  for (int u = 0; u < Regs::kNs; ++u) {
    const int i = ht + u * 256;
    if (i < ROWS * (S / 4))
      *reinterpret_cast<float4*>(dd + (i / (S / 4)) * LDD + R +
                                 4 * (i % (S / 4))) = nx.sk[u];
  }
  pipe_sync<H>(h);
  // in flight while this tile computes: the next tile's inputs
  if (tile_i + step < n_tiles)
    bwd_fetch<R, S, FORM>(a, m0 + step * ROWS, ht, nx);

  // RC: tf and sg of the warp's dgated places, from fg recomputed
  float tfv[RC ? TPW : 1][4], sgv[RC ? TPW : 1][4];
  if (RC) {
    float fa[RC ? 2 * TPW : 1][4];
    fg_mma<RC ? 2 * TPW : 1, Sh::kLdh>(
        fa, hq, r0, win, [&](int kk, int j, unsigned* b) {
          const int n = (j < TPW ? n0 + 8 * j : R + n0 + 8 * (j - TPW)) + g;
          const float* p = wf + (16 * kk + 2 * q) * LDF + n;
          b[0] = pack2(p[0], p[LDF]);
          b[1] = pack2(p[8 * LDF], p[9 * LDF]);
        });
    const float* bfr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long m = m0 + r0 + g + 8 * hh;
      bfr[hh] = a.b_fg + (m < a.m_total ? m / a.t_len : 0) * 2 * R;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* bf = bfr[e >> 1];
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        const int c = n0 + 8 * j + 2 * q + (e & 1);
        tfv[j][e] = tanhf(fa[j][e] + __ldg(bf + c));
        sgv[j][e] = sigmoidf(fa[TPW + j][e] + __ldg(bf + R + c));
      }
    }
  }

  // dgated = [dh | dskip] W_out^T (3 passes), then dfg from the taps
  {
    float acc[TPW][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < NO; k0 += 8) {
      Frag<4> fa;
      load_a_rows<true>(dd + r0 * LDD + k0, LDD, fa);
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        Frag<2> fb;
        load_b_cols(wo + (n0 + 8 * j) * LDD + k0, LDD, fb);
        if constexpr (ADD)
          mma_split_add<true>(acc[j], fa, fb);
        else
          mma_split<true>(acc[j], fa, fb);
      }
    }
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int c = n0 + 8 * j + 2 * q;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + g + 8 * e;
        float tf[2], sg[2];
        if (RC || RCF) {
          if (RC) {
            tf[0] = tfv[RC ? j : 0][2 * e];
            tf[1] = tfv[RC ? j : 0][2 * e + 1];
            sg[0] = sgv[RC ? j : 0][2 * e];
            sg[1] = sgv[RC ? j : 0][2 * e + 1];
          } else {
            tf[0] = tfr[RCF ? j : 0][2 * e];
            tf[1] = tfr[RCF ? j : 0][2 * e + 1];
            sg[0] = sgr[RCF ? j : 0][2 * e];
            sg[1] = sgr[RCF ? j : 0][2 * e + 1];
          }
          const long m = m0 + row;
          if (m < a.m_total)
            *reinterpret_cast<float2*>(a.gated + m * R + c) =
                make_float2(tf[0] * sg[0], tf[1] * sg[1]);
        } else if (F32) {
          const float2 tw =
              *reinterpret_cast<const float2*>(ff + row * LDF + c);
          const float2 sw =
              *reinterpret_cast<const float2*>(ff + row * LDF + R + c);
          tf[0] = tw.x;
          tf[1] = tw.y;
          sg[0] = sw.x;
          sg[1] = sw.y;
          const long m = m0 + row;
          if (m < a.m_total)
            *reinterpret_cast<float2*>(a.gated + m * R + c) =
                make_float2(tf[0] * sg[0], tf[1] * sg[1]);
        } else {
          const unsigned tw =
              *reinterpret_cast<const unsigned*>(ts + row * LDT + c);
          const unsigned sw =
              *reinterpret_cast<const unsigned*>(ts + row * LDT + R + c);
          tf[0] = __uint_as_float(tw << 16);
          tf[1] = __uint_as_float(tw & 0xffff0000u);
          sg[0] = __uint_as_float(sw << 16);
          sg[1] = __uint_as_float(sw & 0xffff0000u);
        }
        float df[2], dq[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float dg = acc[j][2 * e + k];
          df[k] = dg * (sg[k] * (1.f - tf[k] * tf[k]));
          dq[k] = dg * (tf[k] * (sg[k] - sg[k] * sg[k]));
        }
        *reinterpret_cast<float2*>(ff + row * LDF + c) =
            make_float2(df[0], df[1]);
        *reinterpret_cast<float2*>(ff + row * LDF + R + c) =
            make_float2(dq[0], dq[1]);
      }
    }
  }
  pipe_sync<H>(h);
  for (int i = ht; i < ROWS * (R / 2); i += 256) {
    const int row = i / (R / 2), j0 = 4 * (i % (R / 2));
    const long m = m0 + row;
    if (m < a.m_total)
      *reinterpret_cast<float4*>(a.dfg + m * 2 * R + j0) =
          *reinterpret_cast<const float4*>(ff + row * LDF + j0);
  }

  // dfg_w = dfg W_fg^T (3 passes) over all W_in columns at once: the
  // warp's NP n tiles lie in the dh part, the past part (the carry) or
  // the ctx part; its old dctx sums are loaded first
  {
    const int np = win / 8 / (8 / MT);             // n tiles of this warp
    const int c0 = (warp / MT) * np * 8;
    float2 dco[NP][2];
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + 2 * q - 2 * R;
        const long m = m0 + r0 + g + 8 * e;
        dco[j][e] = j < np && c >= 0 && ctx_sum && m < a.m_total
                        ? *reinterpret_cast<const float2*>(a.dctx + m * R + c)
                        : make_float2(0.f, 0.f);
      }
    float acc[NP][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < 2 * R; k0 += 8) {
      Frag<4> fa;
      load_a_rows<true>(ff + r0 * LDF + k0, LDF, fa);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (j >= np) break;
        Frag<2> fb;
        load_b_cols(wf + (c0 + 8 * j) * LDF + k0, LDF, fb);
        if constexpr (ADD)
          mma_split_add<true>(acc[j], fa, fb);
        else
          mma_split<true>(acc[j], fa, fb);
      }
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j >= np) break;
      const int cw = c0 + 8 * j + 2 * q, p = cw / R, c = cw % R;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + g + 8 * e;
        const long m = m0 + row;
        if (m >= a.m_total) continue;
        const float x0 = acc[j][2 * e], x1 = acc[j][2 * e + 1];
        if (p == 0) {
          const float2 d = *reinterpret_cast<const float2*>(dd + row * LDD + c);
          *reinterpret_cast<float2*>(a.dhp + m * R + c) =
              make_float2(d.x + x0, d.y + x1);
        } else if (p == 1) {
          *reinterpret_cast<float2*>(a.p_out + m * R + c) =
              make_float2(x0, x1);
        } else {
          const float y0 = ctx_sum ? dco[j][e].x + x0 : x0;
          const float y1 = ctx_sum ? dco[j][e].y + x1 : x1;
          if (a.dctx_bf)
            *reinterpret_cast<unsigned*>(a.dctx_bf + m * R + c) =
                pack2(y0, y1);
          else
            *reinterpret_cast<float2*>(a.dctx + m * R + c) =
                make_float2(y0, y1);
        }
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
//   MODE 3: A = gated (R, float32: the recompute form's tf * sg, and the
//           float32 form's), B as 1
//   MODE 4: A = [hsave | hsave(t-d) | ctx] in float32 (the float32 form), B
//           as 0
//   MODE 5: A = xc rows in float32 (the float32 form), B as 2
//   MODE 6: A = gated in float32 (the float32 save form), B as 1
//   MODE 7: A = [h | h(t-d) | ctx] of the bf16 replay backward: h the
//           rebuild's float32 h (or, at layer 0, x in bf16), h(t-d) the
//           same but rounded to bf16 on the rows with t mod tile < d
//           (those the TPU kernel reads from its ring snapshot in the
//           compute dtype), ctx bf16; B as 0
// The float32 modes (4-7) sum each 8-row k step from zero and add it in
// float32 (mma_split_add): a sum over a block's thousands of rows in the
// tensor core's own accumulation drifts by 1e-4 of the result.  Loads move
// 8 bf16 or 4 floats at a time; shapes are template constants.  At the wide
// widths (R > kNarrowR) MODES 0 and 7 run stack_wgrad_wg_kernel on wgmma
// ("W_fg's gradient on wgmma"); these launches take the others.
struct WgradArgs {
  const bf16_t* hs;
  const bf16_t* ctx;
  const float* dfg;
  const bf16_t* tfsg;
  const float* dh;
  const bf16_t* dskip;
  const float* dskip_f;  // float32 dskip in place of dskip, or null
  const bf16_t* xc;
  const float* dctx;
  int n, rows_per_batch, chunks, d;
  float* part;     // (batch * chunks, KA, n)
  float* part_b;   // (batch * chunks, n)
  const float* gated;   // MODE 3: (M, R)
  const float* hs_f;    // MODE 4: (M, R) float32 hsave
  const float* ctx_f;   // MODE 4: (M, R) float32 ctx, or null
  const float* xc_f;    // MODE 5: (M / 10, R) float32 xc
  int tile;             // MODE 7: the TPU kernel's time tile
};

constexpr int kWgRows = 64;
constexpr int kWgSlab = 128;


__device__ __forceinline__ void store8(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// One row of A, 8 columns (group q), as raw bf16: hsave, hsave(t-d) or
// ctx (MODE 0), tf with sg in *sg (MODE 1: A = tf * sg), xc (MODE 2).
template <int MODE, int R>
__device__ __forceinline__ uint4 wg_a_raw(const WgradArgs& a, long row,
                                          int t, int q, uint4* sg) {
  constexpr int G = R / 8;
  const uint4 z = make_uint4(0, 0, 0, 0);
  if (MODE == 0) {
    if (q < G) return *reinterpret_cast<const uint4*>(a.hs + row * R + 8 * q);
    if (q < 2 * G)
      return t >= a.d ? *reinterpret_cast<const uint4*>(
                            a.hs + (row - a.d) * R + 8 * (q - G))
                      : z;
    return *reinterpret_cast<const uint4*>(a.ctx + row * R + 8 * (q - 2 * G));
  }
  if (MODE == 1) {
    *sg = *reinterpret_cast<const uint4*>(a.tfsg + row * 2 * R + R + 8 * q);
    return *reinterpret_cast<const uint4*>(a.tfsg + row * 2 * R + 8 * q);
  }
  return *reinterpret_cast<const uint4*>(a.xc + row * R + 8 * q);
}

// Where the 8 float32 values of one row of A, group q, lie (MODE >= 3), or
// null: zero (the tap before t = d).
template <int MODE, int R>
__device__ __forceinline__ const float* wg_a_f32(const WgradArgs& a,
                                                 long row, int t, int q) {
  constexpr int G = R / 8;
  if (MODE == 3 || MODE == 6) return a.gated + row * R + 8 * q;
  if (MODE == 5) return a.xc_f + row * R + 8 * q;
  if (q < G) return a.hs_f + row * R + 8 * q;
  if (q < 2 * G)
    return t >= a.d ? a.hs_f + (row - a.d) * R + 8 * (q - G) : nullptr;
  return a.ctx_f + row * R + 8 * (q - 2 * G);
}

__device__ __forceinline__ void unpack8(const uint4 v, float* o) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// MODE 7: the 8 values of one row of A, group q (see above); t is the
// row's time.
template <int R>
__device__ __forceinline__ void wg_a_replay(const WgradArgs& a, long row,
                                            int t, int q, float* v) {
  constexpr int G = R / 8;
  if (q >= 2 * G) {
    unpack8(*reinterpret_cast<const uint4*>(a.ctx + row * R + 8 * (q - 2 * G)),
            v);
    return;
  }
  const bool sh = q >= G;
  const int j0 = 8 * (sh ? q - G : q);
  if (sh && t < a.d) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
    return;
  }
  const long src = (sh ? row - a.d : row) * R + j0;
  if (a.hs_f) {
    const float4 u = *reinterpret_cast<const float4*>(a.hs_f + src);
    const float4 w = *reinterpret_cast<const float4*>(a.hs_f + src + 4);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    v[4] = w.x, v[5] = w.y, v[6] = w.z, v[7] = w.w;
  } else {
    unpack8(*reinterpret_cast<const uint4*>(a.hs + src), v);
  }
  if (sh && t % a.tile < a.d) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = bf2f(f2bf(v[j]));
  }
}

// One row of B, 4 columns (c, c+1, c+2, c+3) at a time.
template <int MODE, int R, int S>
__device__ __forceinline__ float4 wg_b4(const WgradArgs& a, long row, int c) {
  if (MODE == 0 || MODE == 4 || MODE == 7)
    return *reinterpret_cast<const float4*>(a.dfg + row * 2 * R + c);
  if (MODE == 1 || MODE == 3 || MODE == 6) {
    if (c < R) return *reinterpret_cast<const float4*>(a.dh + row * R + c);
    if (a.dskip_f)
      return *reinterpret_cast<const float4*>(a.dskip_f + row * S + c - R);
    float v[4];
    load4(a.dskip + row * S + c - R, v);
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  return *reinterpret_cast<const float4*>(a.dctx + row * 10 * R + c);
}

// The 8 warps over the (KA/16) x (NB/8) output tiles: wm x wn tile
// groups, the rest split k (time rows) into groups whose sums are added
// in order at the end.  The most warps on tiles, then the fewest
// fragment loads (A: ca, B: cb each) per k step.
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
  static constexpr int kN = MODE == 0 || MODE == 4 || MODE == 7 ? 2 * R
                            : MODE == 2 || MODE == 5 ? 10 * R
                                                     : R + S;
  // slab width: 64 at the wide widths, whose W_fg sums (KA = 3R) would
  // not fit a thread's registers over 128 columns
  static constexpr int kSlabN = R > kNarrowR ? kWgSlab / 2 : kWgSlab;
  static constexpr int kNb = kN < kSlabN ? kN : kSlabN;
  // row strides of 8 mod 16 floats: conflict-free k-major fragments
  static constexpr int kLda = (KA + 15) / 16 * 16 + 8;
  static constexpr int kLdb = (kNb + 15) / 16 * 16 + 8;
  // rows staged a chunk: 32 for W_fg's float32 sums at the wide widths
  // (MODE 4), whose two words an item of A would not fit a thread's
  // registers beside the sums over 64 rows
  static constexpr int kRows =
      R > kNarrowR && MODE == 4 ? kWgRows / 2 : kWgRows;
  // gated, or float32 activations; else bf16 values
  static constexpr bool kSplitA = MODE == 1 || MODE >= 3;
  static constexpr WgSplit kW =
      wg_split(KA / 16, kNb / 8, kSplitA ? 12 : 4, 6);
  static constexpr int kWk = 8 / (kW.wm * kW.wn);     // k groups
  static constexpr int kMt = KA / 16 / kW.wm, kNt = kNb / 8 / kW.wn;
  // 16-byte items of one 64-row chunk per thread: A (8 bf16), B (4 f32)
  static constexpr int kGa = KA / 8, kGb = kNb / 4;
  static constexpr int kIa = (kRows * kGa + kThreads - 1) / kThreads;
  static constexpr int kIb = (kRows * kGb + kThreads - 1) / kThreads;
  static size_t smem() {
    const size_t tiles = static_cast<size_t>(kRows) * (kLda + kLdb);
    const size_t red = static_cast<size_t>(kWk - 1) * KA * kNb;
    return (tiles > red ? tiles : red) * 4;
  }
};

// One 64-row chunk's A and B items of one thread, in registers.
// MODE >= 3: a and sg hold an item's 8 float32 values, 4 each.
template <int MODE, int R, int S, int KA>
struct WgChunkRegs {
  using Sh = WgShape<MODE, R, S, KA>;
  uint4 a[Sh::kIa];
  uint4 sg[MODE == 1 || MODE >= 3 ? Sh::kIa : 1];
  float4 b[Sh::kIb];
};

template <int MODE, int R, int S, int KA>
__device__ __forceinline__ void wg_fetch(const WgradArgs& a, long base,
                                         int t0, int rows, int col0,
                                         WgChunkRegs<MODE, R, S, KA>& f) {
  using Sh = WgShape<MODE, R, S, KA>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < Sh::kIa; ++u) {
    const int i = tid + u * kThreads, rr = i / Sh::kGa, c = i % Sh::kGa;
    f.a[u] = make_uint4(0, 0, 0, 0);
    if (MODE == 1 || MODE >= 3) f.sg[u] = f.a[u];
    if (MODE == 7) {
      if (i < Sh::kRows * Sh::kGa && rr < rows) {
        float v[8];
        wg_a_replay<R>(a, base + t0 + rr, t0 + rr, c, v);
        f.a[u] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                            __float_as_uint(v[2]), __float_as_uint(v[3]));
        f.sg[u] = make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]),
                             __float_as_uint(v[6]), __float_as_uint(v[7]));
      }
    } else if (MODE >= 3) {
      if (i < Sh::kRows * Sh::kGa && rr < rows) {
        const float* p = wg_a_f32<MODE, R>(a, base + t0 + rr, t0 + rr, c);
        if (p) {
          f.a[u] = *reinterpret_cast<const uint4*>(p);
          f.sg[u] = *reinterpret_cast<const uint4*>(p + 4);
        }
      }
    } else if (i < Sh::kRows * Sh::kGa && rr < rows) {
      f.a[u] = wg_a_raw<MODE, R>(a, base + t0 + rr, t0 + rr, c,
                                 &f.sg[MODE == 1 ? u : 0]);
    }
  }
#pragma unroll
  for (int u = 0; u < Sh::kIb; ++u) {
    const int i = tid + u * kThreads, rr = i / Sh::kGb;
    const int c = col0 + 4 * (i % Sh::kGb);
    f.b[u] = i < Sh::kRows * Sh::kGb && rr < rows && c < Sh::kN
                 ? wg_b4<MODE, R, S>(a, base + t0 + rr, c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Each warp keeps its kMt x kNt mma tiles of the (KA, slab) sum in
// registers over the block's rows, 64 rows staged at a time; the next
// chunk's rows are loaded into registers while this one computes.  The
// W_out and W_up sums fit two blocks per SM (128 registers), so that
// one block's loads overlap the other's products; W_fg's take more.
template <int MODE, int R, int S, int KA>
__global__ void __launch_bounds__(kThreads,
                                  MODE == 0 || MODE == 4 || MODE == 7 ? 1
                                                                      : 2)
    stack_wgrad_kernel(WgradArgs a) {
  using Sh = WgShape<MODE, R, S, KA>;
  constexpr int N = Sh::kN, NB = Sh::kNb, LDA = Sh::kLda, LDB = Sh::kLdb;
  constexpr int GA = Sh::kGa, GB = Sh::kGb;
  constexpr int MT = Sh::kMt, NT = Sh::kNt, WK = Sh::kWk, WN = Sh::kW.wn;
  constexpr int ROWS = Sh::kRows;
  static_assert(kThreads == 256 && KA % 16 == 0 && NB % 8 == 0,
                "8 warps over 16 x 8 tiles");
  const int col0 = blockIdx.y * NB;
  extern __shared__ __align__(16) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);   // (ROWS, LDA)
  float* bs = as + ROWS * LDA;                    // (ROWS, LDB)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kg = warp % WK, wt = warp / WK;      // k group, tile group
  const int i0 = (wt / WN) * MT * 16, j0 = (wt % WN) * NT * 8;
  const int g = blockIdx.x;
  const int b = g / a.chunks, ch = g % a.chunks;
  const int per = (a.rows_per_batch + a.chunks - 1) / a.chunks;
  const int t_lo = ch * per;
  const int t_hi = min(a.rows_per_batch, t_lo + per);
  const long base = static_cast<long>(b) * a.rows_per_batch;
  float acc[MT][NT][4] = {};
  float bsum = 0.f;
  WgChunkRegs<MODE, R, S, KA> nx;
  if (t_lo < t_hi)
    wg_fetch<MODE, R, S, KA>(a, base, t_lo, min(ROWS, t_hi - t_lo), col0,
                             nx);
  for (int t0 = t_lo; t0 < t_hi; t0 += ROWS) {
    const int rows = min(ROWS, t_hi - t0);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < Sh::kIa; ++u) {
      const int i = tid + u * kThreads;
      if (i >= ROWS * GA) break;
      float v[8];
      if (MODE >= 3) {
        const unsigned w[8] = {nx.a[u].x,  nx.a[u].y,  nx.a[u].z,
                               nx.a[u].w,  nx.sg[u].x, nx.sg[u].y,
                               nx.sg[u].z, nx.sg[u].w};
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __uint_as_float(w[j]);
      } else {
        unpack8(nx.a[u], v);
        if (MODE == 1) {
          float sg[8];
          unpack8(nx.sg[u], sg);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = v[j] * sg[j];
        }
      }
      store8(as + (i / GA) * LDA + 8 * (i % GA), v);
    }
#pragma unroll
    for (int u = 0; u < Sh::kIb; ++u) {
      const int i = tid + u * kThreads;
      if (i >= ROWS * GB) break;
      *reinterpret_cast<float4*>(bs + (i / GB) * LDB + 4 * (i % GB)) =
          nx.b[u];
    }
    __syncthreads();
    if (t0 + ROWS < t_hi)
      wg_fetch<MODE, R, S, KA>(a, base, t0 + ROWS,
                               min(ROWS, t_hi - t0 - ROWS), col0, nx);
    if (tid < NB) {
#pragma unroll 8
      for (int rr = 0; rr < rows; ++rr) bsum += bs[rr * LDB + tid];
    }
    // rows past `rows` are zero; k steps of 8 rows, this warp's group's
    for (int k0 = 8 * kg; k0 < rows; k0 += 8 * WK) {
      Frag<2> fb[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        load_b_kmajor(bs + k0 * LDB + j0 + 8 * j, LDB, fb[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        Frag<4> fa;
        load_a_kmajor<Sh::kSplitA>(as + k0 * LDA + i0 + 16 * i, LDA, fa);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (MODE >= 4)
            mma_split_add<Sh::kSplitA>(acc[i][j], fa, fb[j]);
          else
            mma_split<Sh::kSplitA>(acc[i][j], fa, fb[j]);
        }
      }
    }
  }
  if (WK > 1) {
    // the k groups' sums, added in group order (the tiles are free now)
    constexpr int PER = MT * NT * 4 * 32;
    float* red = as;
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
  if (kg == 0) {
    float* out = a.part + static_cast<long>(g) * KA * N;
    const int gr = lane >> 2, q = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = col0 + j0 + 8 * j + 2 * q;
        if (c >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(out + (i0 + 16 * i + gr + 8 * h) * N +
                                     c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
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
// into per-block (2V, rc) tables in shared memory, rc of the R columns a
// block (blockIdx.y: the column slab; rc = R wherever a (2V, R) table fits
// a block, as at every width but R = 128 with 2V = 512).  The block's rows
// are cut into `groups` contiguous chunks, each with a table of its own;
// one thread per (chunk, column) adds its rows in order (loads grouped
// ahead of the adds), and the chunks' tables are added in chunk order: the
// sums are deterministic, so a resumed run trains bit for bit as an
// uninterrupted one.
__global__ void __launch_bounds__(kThreads)
    stack_embed_grad_kernel(const float* dhp, const float* p, int d0,
                            const int* pack, int pack_cols, int batch,
                            int t_len, int vocab, int r, int rc,
                            long rows_per_block, int groups, float* part) {
  constexpr int U = 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* tabs = reinterpret_cast<float*>(smem);   // (groups, 2V, rc)
  const int tid = threadIdx.x, c0 = blockIdx.y * rc;
  const int n_tab = 2 * vocab * rc;
  for (int i = tid; i < groups * n_tab; i += kThreads) tabs[i] = 0.f;
  __syncthreads();
  const long m_total = static_cast<long>(batch) * t_len;
  const long lo = blockIdx.x * rows_per_block;
  const long hi = lo + rows_per_block < m_total ? lo + rows_per_block
                                                : m_total;
  const long chunk = (hi - lo + groups - 1) / groups;
  const int g = tid / rc, j = tid % rc;
  if (g < groups && hi > lo) {
    float* tab = tabs + static_cast<long>(g) * n_tab;
    const long c_lo = lo + g * chunk;
    const long c_hi = c_lo + chunk < hi ? c_lo + chunk : hi;
    for (long m0 = c_lo; m0 < c_hi; m0 += U) {
      float v[U];
      int cur[U], prev[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long m = m0 + u;
        cur[u] = prev[u] = -1;
        v[u] = 0.f;
        if (m < c_hi) {
          const int b = static_cast<int>(m / t_len);
          const int t = static_cast<int>(m % t_len);
          v[u] = dhp[m * r + c0 + j];
          if (t + d0 < t_len) v[u] = v[u] + p[(m + d0) * r + c0 + j];
          cur[u] = pack[static_cast<long>(t) * pack_cols + b];
          prev[u] = pack[static_cast<long>(t) * pack_cols + batch + b];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (cur[u] >= 0 && cur[u] < vocab) tab[cur[u] * rc + j] += v[u];
        if (prev[u] >= 0 && prev[u] < vocab)
          tab[(vocab + prev[u]) * rc + j] += v[u];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n_tab; i += kThreads) {
    float sum = tabs[i];
    for (int c = 1; c < groups; ++c)
      sum += tabs[static_cast<long>(c) * n_tab + i];
    part[static_cast<long>(blockIdx.x) * 2 * vocab * r + (i / rc) * r + c0 +
         i % rc] = sum;
  }
}

__device__ __forceinline__ void store_act(bf16_t* p, float v) {
  *p = f2bf(v);
}
__device__ __forceinline__ void store_act(float* p, float v) { *p = v; }

// dxc = dz wup^T over rows of dz = dctx as (B*T/10, 10R): the coarse
// input gradient of the stride-10 projection, stored in the compute
// dtype (bf16, or float32 in the float32 form).
template <int R>
struct ProjDx {
  // rows a block: 4 x 4 outputs a thread over the block's 256 threads
  static constexpr int kRows = 16 * kThreads / R < 64 ? 16 * kThreads / R : 64;
  static constexpr int kKc = 64;
  static size_t smem() {
    return static_cast<size_t>(kKc * (kRows + 4) + kKc * R) * 4;
  }
};

template <int R, typename ActT>
__global__ void __launch_bounds__(kThreads)
    stack_proj_dx_kernel(const float* dz, const float* wup, ActT* dxc,
                         long q_total) {
  constexpr int ROWS = ProjDx<R>::kRows, LD = ROWS + 4, KC = ProjDx<R>::kKc;
  constexpr int K = 10 * R;
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
    for (int j = 0; j < 4; ++j) store_act(dxc + q * R + c0 + j, acc[i][j]);
  }
}

// dx of the non-embed forms: layer 0's dh + dfg_w_h, plus its carry
// dfg_w_p(t + d0), in the compute dtype (rounded to bf16, or float32).
template <typename ActT>
__global__ void __launch_bounds__(kThreads)
    stack_dx_kernel(const float* dhp, const float* p, int d0, int t_len,
                    int r, long total, ActT* dx) {
  for (long i = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x;
       i < total; i += static_cast<long>(gridDim.x) * kThreads) {
    const long m = i / r;
    float v = dhp[i];
    if (static_cast<int>(m % t_len) + d0 < t_len) v += p[i + d0 * r];
    store_act(dx + i, v);
  }
}

// The merged backward's head (stack_kernel.py:667-697), ahead of the layer
// launches: per 64-row tile, y and z rebuilt from the saved skip with bf16
// operands, the softmax p, dz, then with float32 operands dW2 += leaky(y)^T
// dz, dy = dz W2^T * leaky'(y), dW1 += leaky(skip)^T dy and the float32
// dskip = dy W1^T * leaky'(skip), stored unrounded for the layer launches.
// Each block walks a contiguous range of rows and writes its partial
// weight and bias gradients; a fixed-order reduction adds them up.
struct HeadBwdArgs {
  const bf16_t* skip;    // (M, S)
  const int* tgt;        // (T, B)
  const float* w1;       // (S, C)
  const float* b1;       // (C)
  const float* w2;       // (C, C)
  const float* b2;       // (C)
  const float* dloss;    // (1) gradient of the loss sum
  float* dskip;          // (M, S) float32
  float* part;           // (gridDim.x, S*C + C + C*C + C)
  long m_total, rows_per_block;
  int batch, t_len, s, c, rf, parity;
};

size_t head_bwd_smem(int s, int c) {
  const int hr = head_core::kHeadRows;
  return static_cast<size_t>(3 * s * c + 3 * c * c + 2 * c + hr * (s + 4) +
                             5 * hr * (c + 4)) * 4;
}

__global__ void __launch_bounds__(kThreads)
    stack_head_bwd_kernel(HeadBwdArgs a) {
  using head_core::dleaky;
  using head_core::leaky;
  constexpr int HR = head_core::kHeadRows;
  const int S = a.s, C = a.c, lds = S + 4, ldc = C + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w1 = reinterpret_cast<float*>(smem);   // (S, C)
  float* w2 = w1 + S * C;                         // (C, C)
  float* w1t = w2 + C * C;                        // (C, S) W1^T
  float* w2t = w1t + C * S;                       // (C, C) W2^T
  float* b1 = w2t + C * C;
  float* b2 = b1 + C;
  float* lsk = b2 + C;                            // (HR, lds) leaky(skip)
  float* ys = lsk + HR * lds;                     // (HR, ldc) y
  float* ly = ys + HR * ldc;                      // (HR, ldc) leaky(y)
  float* zp = ly + HR * ldc;                      // (HR, ldc) z, then p
  float* dz = zp + HR * ldc;                      // (HR, ldc)
  float* dy = dz + HR * ldc;                      // (HR, ldc)
  float* gw1 = dy + HR * ldc;                     // (S, C)
  float* gw2 = gw1 + S * C;                       // (C, C)
  const int tid = threadIdx.x;
  for (int i = tid; i < S * C; i += kThreads) {
    const int k = i / C, c = i % C;
    w1[i] = a.w1[i];
    w1t[c * S + k] = a.w1[i];
    gw1[i] = 0.f;
  }
  for (int i = tid; i < C * C; i += kThreads) {
    const int k = i / C, c = i % C;
    w2[i] = a.w2[i];
    w2t[c * C + k] = a.w2[i];
    gw2[i] = 0.f;
  }
  for (int i = tid; i < C; i += kThreads) {
    b1[i] = a.b1[i];
    b2[i] = a.b2[i];
  }
  const float dloss = a.dloss[0];
  const long lo = blockIdx.x * a.rows_per_block;
  const long hi_raw = lo + a.rows_per_block;
  const long hi = hi_raw < a.m_total ? hi_raw : a.m_total;
  float gb = 0.f;   // db2 (threads [0, C)) or db1 (threads [C, 2C))
  for (long m0 = lo; m0 < hi; m0 += HR) {
    const int rows = static_cast<int>(hi - m0 < HR ? hi - m0 : HR);
    __syncthreads();
    for (int i = tid; i < HR * S; i += kThreads) {
      const int r = i / S, k = i % S;
      lsk[r * lds + k] = r < rows ? leaky(bf2f(a.skip[(m0 + r) * S + k])) : 0.f;
    }
    __syncthreads();
    // the forward's products, bf16 operands (rounded as they load)
    head_core::tile_product<true>(lsk, lds, w1, S, C,
                                  [&](int r, int c, float v) {
                                    const float y = v + b1[c];
                                    ys[r * ldc + c] = y;
                                    ly[r * ldc + c] = leaky(y);
                                  });
    __syncthreads();
    head_core::tile_product<true>(ly, ldc, w2, C, C,
                                  [&](int r, int c, float v) {
                                    zp[r * ldc + c] = v + b2[c];
                                  });
    __syncthreads();
    // the softmax replaces z (row_nll's write_p), then dz, a row per thread
    if (tid < HR) {
      float* dr = dz + tid * ldc;
      if (tid < rows) {
        const long m = m0 + tid;
        const int b = static_cast<int>(m / a.t_len);
        const int t = static_cast<int>(m % a.t_len);
        const int tgt = a.tgt[static_cast<long>(t) * a.batch + b];
        bool hit;
        head_core::row_nll(zp + tid * ldc, C, tgt, a.parity, true, &hit);
        const bool valid = t >= a.rf - 1 && t < a.t_len - 1;
        head_core::row_dz(zp + tid * ldc, C, tgt, valid ? dloss : 0.f,
                          a.parity, dr);
      } else {
        for (int c = 0; c < C; ++c) dr[c] = 0.f;
      }
    }
    __syncthreads();
    // the gradient products, float32 operands
    if (tid < C)
      for (int r = 0; r < rows; ++r) gb += dz[r * ldc + tid];
    head_core::tile_wgrad(ly, ldc, dz, ldc, C, C, rows, gw2);
    head_core::tile_product<false>(dz, ldc, w2t, C, C,
                                   [&](int r, int c, float v) {
                                     dy[r * ldc + c] = v * dleaky(ys[r * ldc + c]);
                                   });
    __syncthreads();
    if (tid >= C && tid < 2 * C)
      for (int r = 0; r < rows; ++r) gb += dy[r * ldc + tid - C];
    head_core::tile_wgrad(lsk, lds, dy, ldc, S, C, rows, gw1);
    head_core::tile_product<false>(
        dy, ldc, w1t, C, S, [&](int r, int k, float v) {
          // leaky(skip) and skip have the same sign
          if (r < rows)
            a.dskip[(m0 + r) * S + k] = v * dleaky(lsk[r * lds + k]);
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

// ------------------------------------------------------------- host side
// shared memory one block may use on sm_90
constexpr size_t kSmemLimit = 232448;

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

template <int MODE, int R, int S, int KA>
int wgrad_wg_launch(WgradArgs a, int batch, float* out_w, float* out_b,
                    int bias_groups, cudaStream_t st);

template <int MODE, int R, int S, int KA>
int wgrad_launch(WgradArgs a, int batch, float* out_w, float* out_b,
                 int bias_groups, cudaStream_t st) {
  // W_fg's gradient of the bf16 forms at the wide widths: on wgmma
  if constexpr (R > kNarrowR && (MODE == 0 || MODE == 7)) {
    return wgrad_wg_launch<MODE, R, S, KA>(a, batch, out_w, out_b,
                                           bias_groups, st);
  } else {
    using Sh = WgShape<MODE, R, S, KA>;
    const int slabs = (a.n + Sh::kNb - 1) / Sh::kNb;
    const size_t smem = Sh::smem();
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
}

// The backward's input gradient: the table gradient (pack, vocab, dtab)
// or, in the non-embed forms, dx; and dskip in bf16 or float32.
struct BwdEnds {
  const bf16_t* dskip;
  const float* dskip_f;
  const int* pack;
  int pack_cols, vocab, embed_blocks;
  float* dtab;
  void* dx;              // non-null: dx (the compute dtype) in place of dtab
};

// The activations' type: bf16, or float in the float32 form.
template <bool F32>
using Act = typename std::conditional<F32, float, bf16_t>::type;

// ------------------------------------------------ the replay strategy
// The replay strategy (the JAX package's fused_stack with strategy
// "replay": _fwd_kernel and _bwd_kernel_padded with save_h=False,
// stack_kernel.py:280 and :1486, pallas_calls at :424 and :1443) is the
// save strategy without hsave.  Its forward runs the save forward's layer
// launches with each layer's input in a two-slot ring instead of hsave
// (layer l reads slot l % 2, x for the first, and writes slot (l + 1) % 2)
// and keeps the float32 residual stream h at the input of every k-th
// layer (k = tails_every(L), about sqrt(L)) as a checkpoint: ceil(L/k) - 1
// of (M, R) float32.  In float32 the layer inputs are h itself, so the
// forward is the float32 recompute forward's launches with the taps
// stored.  The backward walks the groups of k layers from the top; each
// group's layer inputs are rebuilt from its checkpoint (x for the first)
// into a group buffer, one rebuild launch a layer, and then the save
// backward's launches run the group's layers top down, reading the layer
// inputs there.  A rebuild is
//   h_{l+1} = (gated_l W_out[:, :R] + b_out[:R]) + h_l   in float32,
// gated from the saved taps, in the save forward's own order: in bf16 the
// residual's fmaf chain (k in order, one fmaf per term from zero) on
// bf16(tf * sg) and bf16 W_out, in float32 the float32 layer kernel's
// split-TF32 k steps on tf * sg.  So the rebuilt layer inputs equal the
// save forward's residual stream bit for bit: in float32 hsave, and the
// replay backward's outputs the save backward's.  In bf16 the group
// buffers hold the rebuild's float32 h, not hsave's bf16(h): the layer
// launches read only the taps, and W_fg's gradient takes [h | h(t-d) |
// ctx] as the TPU kernel does (stack_kernel.py:1609-1622, float32 operands
// from its replayed h), the rows t with t mod tile < d of h(t-d) rounded to
// bf16 as its ring snapshot holds them (the weight-gradient MODE 7).  So in
// bf16 every output but dW_fg is the save backward's bit for bit, and dW_fg
// the TPU replay's.
//
// Bound of a rebuild at the flagship (B=2, T=160000, L=30, R=S=64, k=6):
// the taps (82 MB in bf16) and the float32 h in and out (164 MB), 0.25 GB
// or 0.07 ms at 3.35 TB/s, against R^2 = 4096 fmaf a row (1.3e9, 0.04 ms
// at the float32 peak): bound by bytes.  The backward launches 25 of
// them.
//
// At R = 128 (the bf16 form only) the forward's layer launches are the wide
// save form's (the wrapper's weight scratch written once a call), the
// rebuild is the same kernel on 64-row tiles (its 51,456 bytes of shared
// memory dynamic), whose fmaf chain is the wide save form's residual chain
// (k in order from zero over both k-half slabs, one accumulator), and the
// backward's grids are the wide save backward's.  A rebuild there moves
// 0.57 GB (0.17 ms) against 16,384 fmaf a row (0.16 ms).

// The replay backward's source of the layer inputs, in place of hsave: x,
// the forward's float32 checkpoints, b_out (the rebuild's bias) and the
// group buffers, every - 1 float32 slots (slot i holds h_{lo+1+i}); in
// bf16 the TPU kernel's time tile for W_fg's gradient (MODE 7).
template <bool F32>
struct ReplaySrc {
  const Act<F32>* x;
  const float* ckpt;
  const float* b_out;
  int every;
  float* group;
  int tile;
};

// The bf16 rebuild's tile: rows in groups of 4 by 8 columns a thread.  Its
// dynamic shared memory: the tile's gated rows gt (kRows, kLdg), then W_out's
// residual columns k-major wk (R, kLdk), bf16 (51,456 bytes at R = 128).
template <int R>
struct RebuildShape {
  static constexpr int kCw = 8;                        // columns a thread
  static constexpr int kTpr = R / kCw;                 // threads a row group
  static constexpr int kRows = 4 * kThreads / kTpr;    // rows a tile
  static constexpr int kLdg = R + 2;    // gated rows (bf16)
  static constexpr int kLdk = R + 8;    // W_out's residual columns, k-major
  static constexpr size_t kWk = static_cast<size_t>(kRows) * kLdg * 2;
  static constexpr size_t kEnd = kWk + static_cast<size_t>(R) * kLdk * 2;
  static_assert(kWk % 16 == 0, "wk's 16-byte rows");
};

// One rebuild in bf16: each tile's gated rows, bf16(tf * sg) from the
// rounded taps, and W_out's residual columns rounded to bf16 in shared
// memory, then per element the fmaf chain over k in order from zero, +
// b_out, + h, as stack_layer_kernel's save forms form the residual (the
// wide save form too, whose chain runs over two k-half slabs from one
// accumulator: the same chain).  h_in is the float32 h_l, or null: then
// x_in (bf16) is h_0.  h_out takes the float32 h_{l+1}.  Persistent blocks
// walk the tiles.
template <int R>
__global__ void __launch_bounds__(kThreads)
    stack_rebuild_kernel(const bf16_t* tfsg, const float* w_out, int ldw,
                         const float* b_out, const float* h_in,
                         const bf16_t* x_in, float* h_out, long m_total) {
  using Sh = RebuildShape<R>;
  constexpr int CW = Sh::kCw, TPR = Sh::kTpr, ROWS = Sh::kRows;
  constexpr int LDG = Sh::kLdg, LDK = Sh::kLdk;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16_t* gt = reinterpret_cast<bf16_t*>(smem);            // (ROWS, LDG)
  bf16_t* wk = reinterpret_cast<bf16_t*>(smem + Sh::kWk);  // (R, LDK)
  const int tid = threadIdx.x;
  for (int i = tid; i < R * R; i += kThreads)
    wk[(i / R) * LDK + i % R] = f2bf(w_out[(i / R) * ldw + i % R]);
  const int rg = tid / TPR, c0 = CW * (tid % TPR);
  const long n_tiles = (m_total + ROWS - 1) / ROWS;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long m0 = tile * ROWS;
    __syncthreads();   // every thread is done with the last tile's rows
    for (int i = tid; i < ROWS * (R / 2); i += kThreads) {
      const int row = i / (R / 2), k = 2 * (i % (R / 2));
      const long m = m0 + row;
      unsigned v = 0u;
      if (m < m_total) {
        const unsigned tf = ld32(tfsg + m * 2 * R + k);
        const unsigned sg = ld32(tfsg + m * 2 * R + R + k);
        v = pack2(__uint_as_float(tf << 16) * __uint_as_float(sg << 16),
                  __uint_as_float(tf & 0xffff0000u) *
                      __uint_as_float(sg & 0xffff0000u));
      }
      *reinterpret_cast<unsigned*>(gt + row * LDG + k) = v;
    }
    __syncthreads();
    float acc[4][CW];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < CW; ++jj) acc[i][jj] = 0.f;
    const bf16_t* gp = gt + 4 * rg * LDG;
#pragma unroll 2
    for (int k = 0; k < R; k += 2) {
      unsigned au[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) au[i] = ld32(gp + i * LDG + k);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint4 u =
            *reinterpret_cast<const uint4*>(wk + (k + kk) * LDK + c0);
        const unsigned wu[4] = {u.x, u.y, u.z, u.w};
        float wv[CW];
#pragma unroll
        for (int jj = 0; jj < CW; jj += 2) {
          wv[jj] = __uint_as_float(wu[jj / 2] << 16);
          wv[jj + 1] = __uint_as_float(wu[jj / 2] & 0xffff0000u);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = kk ? __uint_as_float(au[i] & 0xffff0000u)
                             : __uint_as_float(au[i] << 16);
#pragma unroll
          for (int jj = 0; jj < CW; ++jj)
            acc[i][jj] = fmaf(a, wv[jj], acc[i][jj]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long m = m0 + 4 * rg + i;
      if (m >= m_total) continue;
      float v[CW];
#pragma unroll
      for (int jj = 0; jj < CW; ++jj) {
        const int c = c0 + jj;
        const float o = h_in ? h_in[m * R + c] : bf2f(x_in[m * R + c]);
        v[jj] = (acc[i][jj] + __ldg(b_out + c)) + o;
      }
#pragma unroll
      for (int jj = 0; jj < CW; jj += 4)
        *reinterpret_cast<float4*>(h_out + m * R + c0 + jj) =
            make_float4(v[jj], v[jj + 1], v[jj + 2], v[jj + 3]);
    }
  }
}

// One rebuild in float32: h_out = (gated W_out[:, :R] + b_out[:R]) + h_in
// with gated = tf * sg from the float32 taps, formed as
// stack_layer_f32_kernel forms its residual: split-TF32 mma.sync, each
// 8-wide k step's three passes summed from zero and added in float32, k in
// order, then + b_out, + h.  64-row tiles, 8 warps: warp w takes rows 16
// (w % 4) .. + 16 and half w / 4 of the R / 8 residual column tiles.
template <int R>
__global__ void __launch_bounds__(kThreads)
    stack_rebuild_f32_kernel(const float* tfsg, const float* w_out, int ldw,
                             const float* b_out, const float* h_in,
                             float* h_out, long m_total) {
  constexpr int ROWS = 64, LDG = R + 4, LDO = R + 4, NH = R / 16;
  __shared__ __align__(16) float gs[ROWS * LDG];
  __shared__ __align__(16) float wo[R * LDO];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, q = tid & 3;
  const int r0 = 16 * (warp & 3), half = warp >> 2;
  // W_out^T's residual rows, one per output column (k along the row)
  for (int i = tid; i < R * R; i += kThreads)
    wo[(i % R) * LDO + i / R] = w_out[(i / R) * ldw + i % R];
  const long n_tiles = (m_total + ROWS - 1) / ROWS;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long m0 = tile * ROWS;
    __syncthreads();   // every warp is done with the last tile's gated rows
    for (int i = tid; i < ROWS * (R / 4); i += kThreads) {
      const int row = i / (R / 4), c4 = 4 * (i % (R / 4));
      const long m = m0 + row;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < m_total) {
        const float4 tf =
            *reinterpret_cast<const float4*>(tfsg + m * 2 * R + c4);
        const float4 sg =
            *reinterpret_cast<const float4*>(tfsg + m * 2 * R + R + c4);
        v = make_float4(tf.x * sg.x, tf.y * sg.y, tf.z * sg.z, tf.w * sg.w);
      }
      *reinterpret_cast<float4*>(gs + row * LDG + c4) = v;
    }
    __syncthreads();
    float acc[NH][4];
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < R; k0 += 8) {
      Frag<4> fa;
      load_a_rows<true>(gs + r0 * LDG + k0, LDG, fa);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        Frag<2> fb;
        load_b_cols(wo + 8 * (half * NH + j) * LDO + k0, LDO, fb);
        mma_split_add<true>(acc[j], fa, fb);
      }
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int c = 8 * (half * NH + j) + 2 * q;
      const float b0 = __ldg(b_out + c), b1 = __ldg(b_out + c + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long m = m0 + r0 + g + 8 * h;
        if (m >= m_total) continue;
        const float2 o = *reinterpret_cast<const float2*>(h_in + m * R + c);
        const float v0 = acc[j][2 * h] + b0, v1 = acc[j][2 * h + 1] + b1;
        *reinterpret_cast<float2*>(h_out + m * R + c) =
            make_float2(v0 + o.x, v1 + o.y);
      }
    }
  }
}

// x (bf16) widened into dst (float32): layer 0's input in the rebuilt
// layer inputs of replay_inputs_impl
__global__ void __launch_bounds__(kThreads)
    stack_widen_kernel(const bf16_t* src, float* dst, long total) {
  for (long i = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x;
       i < total; i += static_cast<long>(gridDim.x) * kThreads)
    dst[i] = bf2f(src[i]);
}

// As many persistent blocks of fn as fit on the card, at most one a tile.
int fill_grid(const void* fn, int threads, size_t smem, long tiles,
              int* grid) {
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long fit = static_cast<long>(per_sm < 1 ? 1 : per_sm) * sm_count();
  *grid = static_cast<int>(tiles < fit ? tiles : fit);
  return 0;
}

// Rebuild the layer inputs of the group [lo, hi) into rp.group (see
// ReplaySrc): one rebuild launch for each of layers lo .. hi - 2.
template <int R, int S, bool F32>
int replay_group(const ReplaySrc<F32>& rp, const Act<F32>* tfsg,
                 const float* w_out, int lo, int hi, long m_total,
                 cudaStream_t st) {
  const long mr = m_total * R;
  const float* h_lo = lo == 0 ? nullptr : rp.ckpt + (lo / rp.every - 1) * mr;
  const void* fn;
  long rows;
  size_t smem = 0;
  if constexpr (F32) {
    fn = reinterpret_cast<const void*>(stack_rebuild_f32_kernel<R>);
    rows = 64;
  } else {
    fn = reinterpret_cast<const void*>(stack_rebuild_kernel<R>);
    rows = RebuildShape<R>::kRows;
    smem = RebuildShape<R>::kEnd;
  }
  int err = set_smem(fn, smem);
  if (err) return err;
  int grid = 0;
  err = fill_grid(fn, kThreads, smem, (m_total + rows - 1) / rows, &grid);
  if (err) return err;
  for (int l = lo; l + 1 < hi; ++l) {
    const float* in = l == lo ? h_lo : rp.group + (l - lo - 1) * mr;
    float* out = rp.group + (l - lo) * mr;
    const long wo = static_cast<long>(l) * R * (R + S);
    const long bo = static_cast<long>(l) * (R + S);
    if constexpr (F32)
      stack_rebuild_f32_kernel<R><<<grid, kThreads, 0, st>>>(
          tfsg + l * m_total * 2 * R, w_out + wo, R + S, rp.b_out + bo,
          in ? in : rp.x, out, m_total);
    else
      stack_rebuild_kernel<R><<<grid, kThreads, smem, st>>>(
          tfsg + l * m_total * 2 * R, w_out + wo, R + S, rp.b_out + bo, in,
          rp.x, out, m_total);
  }
  return static_cast<int>(cudaGetLastError());
}

// The float32 input of layer l of the group from lo, once replay_group has
// run; in bf16 null for layer 0, whose input is x.
template <bool F32>
const float* replay_input(const ReplaySrc<F32>& rp, int l, int lo, long mr) {
  if (l == 0) {
    if constexpr (F32)
      return rp.x;
    else
      return nullptr;
  }
  return l == lo ? rp.ckpt + (lo / rp.every - 1) * mr
                 : rp.group + (l - lo - 1) * mr;
}

// Every layer input as the replay backward rebuilds it, group by group,
// into hf (L, M, R) in float32: the rebuild held to the save forward's
// hsave (in bf16 rounded).  The groups' slots are hf's own rows; h_lo is
// copied in where the backward reads it from x or a checkpoint.
template <int R, int S, bool F32>
int replay_inputs_impl(const ReplaySrc<F32>& src, const Act<F32>* tfsg,
                       const float* w_out, float* hf, int n_layers,
                       long m_total, cudaStream_t st) {
  const long mr = m_total * R;
  for (int lo = 0; lo < n_layers; lo += src.every) {
    const int hi = lo + src.every < n_layers ? lo + src.every : n_layers;
    ReplaySrc<F32> rp = src;
    rp.group = hf + (lo + 1) * mr;
    int err = replay_group<R, S, F32>(rp, tfsg, w_out, lo, hi, m_total, st);
    if (err) return err;
    const float* h_lo = replay_input<F32>(rp, lo, lo, mr);
    cudaError_t e = cudaSuccess;
    if (h_lo)
      e = cudaMemcpyAsync(hf + lo * mr, h_lo, mr * sizeof(float),
                          cudaMemcpyDeviceToDevice, st);
    else
      stack_widen_kernel<<<grid_for(mr), kThreads, 0, st>>>(
          reinterpret_cast<const bf16_t*>(rp.x), hf, mr);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <int R, int S, int FORM>
struct BwdLaunch;
template <int R, int S>
void wg_bwd_weights(const float* w_fg, const float* w_out, int win,
                    int n_layers, float* img, cudaStream_t st);
template <int R, int S>
struct WgF32Images;

// F32: the float32 form (hsave, tfsg, ctx, xc, dx and dctx_out float32,
// dskip float32 in ends.dskip_f).  rp non-null: the replay backward, the
// layer inputs rebuilt group by group in place of hsave (null).  At the
// wide widths (bf16) img takes every layer's weight images
// (movenet_stack_wt_bwd_elems floats), written here once a call.
template <int R, int S, bool F32>
int bwd_impl(const BwdEnds& ends, const Act<F32>* hsave,
             const Act<F32>* tfsg, const Act<F32>* ctx, const float* w_fg,
             const float* w_out, const int* dil, const Act<F32>* xc,
             const float* wup, float* scratch, int chunks,
             Act<F32>* dctx_out, float* db_fg, float* dw_fg, float* dw_out,
             float* db_out, float* dwup, float* dbup, int batch, int t_len,
             int n_layers, const ReplaySrc<F32>* rp, float* img,
             cudaStream_t st) {
  const long m_total = static_cast<long>(batch) * t_len;
  const int win = ctx ? 3 * R : 2 * R;
  const bool proj = xc != nullptr;
  constexpr bool kWide = R > kNarrowR;
  // float32 scratch: dhp, p[2], dh, dfg, dctx, (the float32 form: gated,)
  // partials
  float* dhp = scratch;
  float* pbuf[2] = {dhp + m_total * R, dhp + 2 * m_total * R};
  float* dh = dhp + 3 * m_total * R;
  float* dfg = dhp + 4 * m_total * R;
  float* dctx = dhp + 6 * m_total * R;
  float* gated = dhp + 7 * m_total * R;
  float* part = dhp + (F32 ? 8 : 7) * m_total * R;
  constexpr int FORM = F32 ? kBwdF32 : kBwdSave;
  // the weight gradients' modes: W_fg, W_out, W_up
  constexpr int MFG = F32 ? 4 : 0, MOUT = F32 ? 6 : 1, MUP = F32 ? 5 : 2;
  BwdLaunch<R, S, FORM> layer;
  int err = layer.setup(m_total, win);
  if (err) return err;
  cudaError_t e;
  long img_layer = 0;
  if constexpr (kWide) {
    if (!img) return static_cast<int>(cudaErrorInvalidValue);
    wg_bwd_weights<R, S>(w_fg, w_out, win, n_layers, img, st);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    img_layer = WgF32Images<R, S>::bwd_floats(win);
  }
  for (int l = n_layers - 1; l >= 0; --l) {
    const Act<F32>* hs = rp ? nullptr : hsave + l * m_total * R;
    // the replay backward's float32 layer input (bf16: null at layer 0)
    const float* hr = nullptr;
    if (rp) {
      // the group's layer inputs, rebuilt as the walk enters it
      const int lo = l / rp->every * rp->every;
      const int hi = lo + rp->every < n_layers ? lo + rp->every : n_layers;
      if (l == hi - 1) {
        err = replay_group<R, S, F32>(*rp, tfsg, w_out, lo, hi, m_total, st);
        if (err) return err;
      }
      hr = replay_input<F32>(*rp, l, lo, m_total * R);
      if constexpr (F32) hs = hr;
    }
    BwdLayerArgs a = {};
    a.dhp = dhp;
    a.p_in = pbuf[(l + 1) & 1];
    a.p_out = pbuf[l & 1];
    a.dh = dh;
    a.dfg = dfg;
    if constexpr (F32) {
      // the flat dctx sums in its output, the projection's in dctx
      a.dctx = ctx ? (proj ? dctx : dctx_out) : nullptr;
      a.dctx_bf = nullptr;
      a.tfsg_f = tfsg + l * m_total * 2 * R;
      a.gated = gated;
    } else {
      a.dctx = ctx ? dctx : nullptr;
      a.dctx_bf = (ctx && !proj && l == 0) ? dctx_out : nullptr;
      a.tfsg = tfsg + l * m_total * 2 * R;
    }
    a.dskip = ends.dskip;
    a.dskip_f = ends.dskip_f;
    a.w_out = w_out + static_cast<long>(l) * R * (R + S);
    a.w_fg = w_fg + static_cast<long>(l) * win * 2 * R;
    a.m_total = m_total;
    a.t_len = t_len;
    a.d_in = l + 1 < n_layers ? dil[l + 1] : 0;
    a.top = l == n_layers - 1;
    a.win = win;
    err = layer.launch(a, kWide ? img + l * img_layer : nullptr, st);
    if (err) return err;

    WgradArgs w = {};
    if constexpr (F32) {
      w.hs_f = hs;
      w.ctx_f = ctx;
      w.gated = gated;
    } else {
      w.hs = rp ? rp->x : hs;
      w.hs_f = hr;
      w.tile = rp ? rp->tile : 0;
      w.ctx = ctx;
      w.tfsg = tfsg + l * m_total * 2 * R;
    }
    w.dfg = dfg;
    w.dh = dh;
    w.dskip = ends.dskip;
    w.dskip_f = ends.dskip_f;
    w.rows_per_batch = t_len;
    w.chunks = chunks;
    w.d = dil[l];
    w.part = part;
    w.part_b = part + static_cast<long>(batch) * chunks * win * 2 * R;
    w.n = 2 * R;
    float* dwf = dw_fg + static_cast<long>(l) * win * 2 * R;
    float* dbf = db_fg + static_cast<long>(l) * batch * 2 * R;
    // W_fg's gradient; the bf16 replay backward's from its float32 h
    constexpr int MRP = F32 ? MFG : 7;
    if (rp)
      err = ctx ? wgrad_launch<MRP, R, S, 3 * R>(w, batch, dwf, dbf, batch,
                                                 st)
                : wgrad_launch<MRP, R, S, 2 * R>(w, batch, dwf, dbf, batch,
                                                 st);
    else
      err = ctx
                ? wgrad_launch<MFG, R, S, 3 * R>(w, batch, dwf, dbf, batch, st)
                : wgrad_launch<MFG, R, S, 2 * R>(w, batch, dwf, dbf, batch, st);
    if (err) return err;
    w.n = R + S;
    w.part_b = part + static_cast<long>(batch) * chunks * R * (R + S);
    err = wgrad_launch<MOUT, R, S, R>(
        w, batch, dw_out + static_cast<long>(l) * R * (R + S),
        db_out + static_cast<long>(l) * (R + S), 1, st);
    if (err) return err;
  }
  if (ends.dx) {
    stack_dx_kernel<Act<F32>><<<grid_for(m_total * R), kThreads, 0, st>>>(
        dhp, pbuf[0], dil[0], t_len, R, m_total * R,
        static_cast<Act<F32>*>(ends.dx));
  } else {
    // table gradient
    const int blocks = ends.embed_blocks, vocab = ends.vocab;
    const long per = (m_total + blocks - 1) / blocks;
    // columns per block: all R where a (2V, R) table fits a block, else
    // the widest power-of-two slab that does
    int rc = R;
    while (rc > 1 && static_cast<size_t>(2 * vocab * rc) * 4 > kSmemLimit)
      rc /= 2;
    // chunks per block: a thread per (chunk, column), their tables within
    // 112 KB (two blocks per SM)
    const size_t tab_bytes = static_cast<size_t>(2 * vocab * rc) * 4;
    int groups = static_cast<int>((112 * 1024) / tab_bytes);
    groups = groups < kThreads / rc ? groups : kThreads / rc;
    groups = groups < 1 ? 1 : groups;
    const size_t tsmem = tab_bytes * groups;
    err = set_smem(reinterpret_cast<const void*>(stack_embed_grad_kernel),
                   tsmem);
    if (err) return err;
    stack_embed_grad_kernel<<<dim3(blocks, R / rc), kThreads, tsmem, st>>>(
        dhp, pbuf[0], dil[0], ends.pack, ends.pack_cols, batch, t_len, vocab,
        R, rc, per, groups, part);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const long nt = 2L * vocab * R;
    reduce_kernel<<<grid_for(nt), kThreads, 0, st>>>(part, ends.dtab, nt, 1,
                                                     blocks);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (proj) {
    WgradArgs w = {};
    if constexpr (F32)
      w.xc_f = xc;
    else
      w.xc = xc;
    w.dctx = dctx;
    w.n = 10 * R;
    w.rows_per_batch = t_len / 10;
    w.chunks = chunks;
    w.part = part;
    w.part_b = part + static_cast<long>(batch) * chunks * R * 10 * R;
    err = wgrad_launch<MUP, R, S, R>(w, batch, dwup, dbup, 1, st);
    if (err) return err;
    const long q_total = m_total / 10;
    const size_t psmem = ProjDx<R>::smem();
    constexpr int prows = ProjDx<R>::kRows;
    const void* pdx =
        reinterpret_cast<const void*>(stack_proj_dx_kernel<R, Act<F32>>);
    err = set_smem(pdx, psmem);
    if (err) return err;
    stack_proj_dx_kernel<R, Act<F32>>
        <<<static_cast<int>((q_total + prows - 1) / prows), kThreads, psmem,
           st>>>(dctx, wup, dctx_out, q_total);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// ----------------------------------------------------- the layer kernel
// One launch template, stack_layer_kernel<R, S, FORM>, runs one layer of
// every trunk forward, in two bodies: FORM kRecompute, and the save forms
// kSave and kSaveHead.  The bodies share fg_mma and the layout of W_fg^T
// in shared memory; each has its own block shape, arguments, tile walk
// and epilogue.  The forms are the recompute strategy's (_fwd_kernel_tails,
// stack_kernel.py:929, pallas_call at :1003), the save strategy's
// (_fwd_kernel, :280, pallas_call at :424) and the merged form's
// (_fwd_kernel_head, :464, pallas_call at :576), whose last layer also runs
// the head and the CE.  The TPU walks one batch row's time tiles in order
// and carries each layer's dilation ring from tile to tile.  Blocks here run
// in no order, so every launch is one layer over all B*T rows and reads the
// tap h(t-d) of the layer's input from global memory: no halo, and no
// shared memory that grows with sum(d).
//   kRecompute  h in and out in bf16 (a ping-pong pair of (M, R) buffers):
//               rounded after every layer, as on the TPU; the skip sum in
//               float32.  The wrapper keeps the input of every k-th layer
//               (k about sqrt(L)) as a checkpoint: ceil(L/k) - 1 of (M, R).
//   kSave       the input is hsave[l] (bf16); the residual stream h stays
//               float32 in global memory between launches (the first layer
//               takes it from its bf16 input) and hsave[l+1] = bf16(h); the
//               taps tfsg (rounded tf | sg) are stored; gated from the
//               rounded taps, or from the unrounded ones in the merged form
//               (raw_gate, stack_kernel.py:513).
//   kSaveHead   the merged form's last layer: kSave, then the head on the
//               finished skip sums (below).
//   backward    (recompute) the groups of k layers from the top: each
//               group's layer inputs rebuilt from its checkpoint (x for the
//               first) by the kRecompute form, so bit for bit as the forward
//               computed them; then per layer, top down, the save backward's
//               layer launch in its recompute form (stack_bwd_layer_kernel<R,
//               S, kBwdRc>: fg recomputed on the tensor cores from h_l, tf and
//               sg in float32, gated = tf * sg stored in float32) and its
//               weight gradient launches (W_fg as the save's, W_out from the
//               float32 gated: MODE 3) with their fixed-order reductions.
//               The anti-causal carry crosses launches through global memory
//               as in the save backward.  Deterministic, no atomics.  In
//               float32 the same walk runs stack_layer_f32_kernel for the
//               rebuilds and the layer backward's kBwdRcF32 form (fg formed
//               again split-TF32), W_fg's and W_out's gradients from float32
//               activations and gated (MODE 4 and 6); at R = 128 kernels A
//               and B ("the wide float32 recompute kernels") in their place.
// Products.  fg = [h | h(t-d) | ctx] W_fg and out = gated W_out run as bf16
// mma.sync m16n8k16 with float32 sums: the operands are exact bf16 values
// (the weights rounded as the TPU's _mdot rounds them), and each 16-wide k
// step's sum is added in float32 (mma_bf16_add), so only the summation
// order differs from the plain version (ops/stack_kernel.mma_order_matmul
// models it).  The fg sums feed the gate in registers, and the gate's
// fragments, rounded, are the out product's A fragments (no shared-memory
// round trip).  The save forms keep the plain version's bits in hsave and
// tfsg (see the kernel): their fg elements near a bf16 rounding tie are
// summed again in the plain version's order, and their residual's out is
// that order (an fmaf chain) from the start; the skip part stays on the
// tensor cores.  The merged head takes the warp's finished skip sums the
// same way: rnd(leaky(rnd(skip))) are the A fragments of y = . W1, and
// rnd(leaky(y + b1)) those of z = . W2 (W1^T, W2^T in bf16 in shared
// memory, zero-padded to multiples of 16); each row of z lies in one quad
// of lanes, so its max, first argmax, exp sum and NLL are quad shuffles
// (head_core::row_nll's semantics); the logits never reach global memory.
// The backward's gradient products are the save backward's split-TF32
// ones.
//
// Bound.  Recompute forward (experiment 02 through the CLI: B=2, T=160000,
// L=9, R=64, S=8, flat ctx): about 1.7e11 operations on bf16 operands
// (0.17 ms at 989 TF/s) and x, ctx, skip and the checkpoints to move (0.15
// GB, 0.05 ms): bound by operations.  As launched it moves about 0.18 GB a
// layer (h, h(t-d), ctx, h_next, the skip sum), a floor of about 0.5 ms,
// and its mma.sync issue, not the tensor cores' rate, sets its time
// (PERF.md).  Save forward (breakdancing: B=2, T=160000, L=9, R=S=64, ctx):
// about 1.9e11 operations (0.19 ms) against 1.19 GB of compulsory traffic
// (hsave, tfsg, skip, ctx): 0.36 ms, bound by bytes; as launched each layer
// also moves the float32 h and skip sum (about 0.33 GB), about 0.53 GB a
// layer in all, and the residual's chain (4096 fmaf a row at R = 64) and
// the re-sums add float32 work and latency (PERF.md).  The recompute
// backward
// recomputes the rebuilt layers and every fg in bf16 and runs the
// gradient products in float32 on the tensor cores (about 4.5e11
// operations counted once at the TF32 peak, 0.94 ms in all: bound by
// operations); as launched it moves the save backward's float32
// intermediates and gated (about 1.3 GB a layer).

// the layer kernel's forms (kTaps: the wide recompute form's taps launch
// for the wide bf16 recompute backward, built at the wide widths alone)
constexpr int kRecompute = 0, kSave = 1, kSaveHead = 2, kTaps = 4;
// the recompute form's block: 16 warps of 16 rows each per tile (one
// block per SM: the tile and the weights fill its shared memory)
constexpr int kTlWarps = 16;
constexpr int kTlThreads = 32 * kTlWarps;
constexpr int kTlRows = 16 * kTlWarps;

template <int R, int S>
struct TlShape {
  static constexpr int kNo = R + S;
  // row strides of 8 mod 16 bf16: conflict-free fragment loads
  static constexpr int kLdh = 3 * R + 8;   // [h | h(t-d) | ctx] rows
  static constexpr int kLdw = 3 * R + 8;   // W_fg^T rows (one per column)
  static constexpr int kLdo = R + 8;       // W_out^T rows
  // 16-byte operand items of one tile per thread
  static constexpr int kNp = (kTlRows * (3 * R / 8) + kTlThreads - 1) /
                             kTlThreads;
  static size_t smem() {
    return static_cast<size_t>(kTlRows * kLdh + 2 * R * kLdw +
                               kNo * kLdo) * 2;
  }
};

// The save forms' block: 8 warps of 16 rows, and kMinBlocks blocks an SM
// (ptxas keeps a thread's registers to what that many need): two where R
// + S <= 48, so 128 registers, where a tile's serial steps (the queue, the
// chain, the barriers) are short of work and another block's warps fill
// them; else one, so the sums stay in up to 255 registers (R = 64; and
// (32, 32), which spills in 128).  Their shared memory, byte offsets in
// this order: the operand tile hp (kRows, kLdh) bf16; W_fg^T wf (2R,
// kLdw) bf16; W_out^T's skip rows wos (S, kLdo) bf16; the tile's float32
// skip sums sb (kRows, kLdsf); each warp's queue of fg elements to sum
// again in the plain version's order (keys, then values, kQcap each, then
// the fg bias row offset of each of its 16 rows); the L2 norms of W_fg's
// columns wn (2R) f32; then what only a layer with a residual uses:
// W_out's residual columns k-major wk (R, kLdk) bf16, each warp's gated
// rows k-major gt (R, 16) bf16, and the tile's float32 h rows hb (kRows,
// kLdhf).  The merged form's last layer has no residual and keeps the
// head's weights there.
template <int R, int S>
struct SaveShape {
  static constexpr int kWarps = 8, kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = R + S <= 48 ? 2 : 1;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kLdh = 3 * R + 8, kLdw = 3 * R + 8, kLdo = R + 8;
  static constexpr int kLdk = R + 8;
  // float32 rows: conflict-free float2 / float4 reads
  static constexpr int kLdhf = R + 8, kLdsf = S + 8;
  static constexpr int kQcap = 128;
  static constexpr size_t kWf = static_cast<size_t>(kRows) * kLdh * 2;
  static constexpr size_t kWos = kWf + static_cast<size_t>(2 * R) * kLdw * 2;
  static constexpr size_t kSb = kWos + static_cast<size_t>(S) * kLdo * 2;
  static constexpr size_t kQk = kSb + static_cast<size_t>(kRows) * kLdsf * 4;
  static constexpr size_t kQv = kQk + static_cast<size_t>(kWarps) * kQcap * 4;
  static constexpr size_t kQb =
      kQv + static_cast<size_t>(kWarps) * kQcap * 4;
  static constexpr size_t kWn = kQb + static_cast<size_t>(kWarps) * 16 * 4;
  static constexpr size_t kWk = kWn + static_cast<size_t>(2 * R) * 4;
  static constexpr size_t kGt = kWk + static_cast<size_t>(R) * kLdk * 2;
  static constexpr size_t kHb = kGt + static_cast<size_t>(kWarps) * R * 16 * 2;
  static constexpr size_t kEnd = kHb + static_cast<size_t>(kRows) * kLdhf * 4;
  static size_t smem() { return kEnd; }
};

// The wide save forward's block: 8 warps of 16 rows on 128-row tiles, one
// block an SM.  Its shared memory, byte offsets in this order: the operand
// tile hp (kRows, kLdh) bf16; a ring of two weight slabs, each the largest
// of a fg pass's W_fg^T rows (2 kNc, kLdw), a residual slab's W_out rows k
// (kKh, kLdk) and a skip slab's W_out^T rows (kSw, kLdo), bf16; each
// warp's gated rows k-major gt (R, 16) bf16; the queues as SaveShape's;
// the L2 norms of W_fg's columns wn (2R) f32.  The steps of a tile: kFp fg
// passes, kRk residual slabs, kSk skip slabs.
constexpr size_t max_size(size_t x, size_t y) { return x > y ? x : y; }

template <int R, int S>
struct WideShape {
  static constexpr int kThreads = 256, kWarps = kThreads / 32;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kNc = 16;                   // filter columns a pass
  static constexpr int kFp = R / kNc;
  static constexpr int kKh = 64, kRk = R / kKh;    // residual slabs (k)
  static constexpr int kSw = 64;                   // skip columns a slab
  static constexpr int kSk = (S + kSw - 1) / kSw;
  static constexpr int kSteps = kFp + kRk + kSk;
  static constexpr int kLdh = 3 * R + 8, kLdw = 3 * R + 8;
  static constexpr int kLdk = R + 8, kLdo = R + 8;
  static constexpr int kQcap = 128;
  static_assert(R % kKh == 0 && (S < kSw ? S % 8 == 0 : S % kSw == 0),
                "whole residual and skip slabs");
  static constexpr size_t kSlab =
      max_size(max_size(static_cast<size_t>(2 * kNc) * kLdw,
                        static_cast<size_t>(kKh) * kLdk),
               static_cast<size_t>(kSw) * kLdo) * 2;
  static constexpr size_t kRing = static_cast<size_t>(kRows) * kLdh * 2;
  static constexpr size_t kGt = kRing + 2 * kSlab;
  static constexpr size_t kQk = kGt + static_cast<size_t>(kWarps) * R * 16 * 2;
  static constexpr size_t kQv = kQk + static_cast<size_t>(kWarps) * kQcap * 4;
  static constexpr size_t kQb = kQv + static_cast<size_t>(kWarps) * kQcap * 4;
  static constexpr size_t kWn = kQb + static_cast<size_t>(kWarps) * 16 * 4;
  static constexpr size_t kEnd = kWn + static_cast<size_t>(2 * R) * 4;
  // bf16 elements of one layer's weights as the wide forward reads them
  // (stack_wt_kernel): W_fg^T (2R, W_in), W_out's residual columns k-major
  // (R, R), W_out^T's skip rows (S, R)
  static long wt_elems(int win) {
    return 2L * R * win + static_cast<long>(R) * R + static_cast<long>(S) * R;
  }
};

// Dynamic shared memory of the save forms' layer launch at (R, S).
template <int R, int S>
size_t save_smem() {
  if constexpr (R > kNarrowR)
    return WideShape<R, S>::kEnd;
  else
    return SaveShape<R, S>::smem();
}

// The merged head's weights after the layer's shared memory: W1^T (CP, SP
// + 8) and W2^T (CP, CP + 8) in bf16, then b1 and b2 (CP floats each), zero
// past S and C; SP and CP are S and C rounded up to 16.
struct HeadSmem {
  int sp, cp, ld1, ld2;
  __host__ __device__ explicit HeadSmem(int s, int c)
      : sp((s + 15) / 16 * 16), cp((c + 15) / 16 * 16), ld1(sp + 8),
        ld2(cp + 8) {}
  __host__ __device__ size_t bytes() const {
    return static_cast<size_t>(cp * ld1 + cp * ld2) * 2 + 2 * cp * 4;
  }
};

// The merged head (stack_kernel.py:519-539) on the last layer's skip sums:
// rounded to bf16, through leaky, W1, leaky, W2 (bf16 operands), then the
// NLL and the first-argmax match of each valid row [RF-1, T-1), summed
// per block.
struct HeadEpilogue {
  const int* tgt;        // (T, B) targets, or null: no head
  const float* w1;       // (S, C)
  const float* b1;       // (C)
  const float* w2;       // (C, C)
  const float* b2;       // (C)
  float* part;           // (gridDim.x, 2): the block's loss and match sums
  int batch, c, rf, parity;
};

// The recompute form's arguments (kernel parameters of that form alone)
struct TailsLayerArgs {
  const bf16_t* h;       // (M, R) this layer's input (the save forms:
                         // hsave[l])
  bf16_t* h_next;        // (M, R) its output (hsave[l+1]), or null
  const bf16_t* ctx;     // (M, R) or null
  const float* b_fg;     // (B, 2R) this layer's rows
  const float* w_fg;     // (W_in, 2R)
  const float* w_out;    // (R, R+S)
  const float* b_out;    // (R+S)
  float* skacc;          // (M, S) float32 skip sum, or null (a rebuild)
  bf16_t* skip;          // (M, S) skip_sum, stored by the last layer
  long m_total;
  int t_len, d, first, last;
};

// the save forms'
struct LayerArgs : TailsLayerArgs {
  float* hf;             // (M, R) float32 residual stream, in place
  bf16_t* tfsg;          // (M, 2R) this layer's taps
  int keep_h;            // store hf (a later layer reads it)
  int raw_gate;          // gated from the unrounded taps (the merged form)
  HeadEpilogue hd;       // kSaveHead
  const bf16_t* wt;      // the wide forms: this layer's bf16 weights
                         // (WideShape::wt_elems), or null
  float* taps;           // the wide recompute form's taps launch: tf, sg
                         // (M, 2R) float32 out, no h_next and no skip sum
};

// The kernel parameters of the layer kernel's form FORM at width R: the
// narrow recompute form's own small struct (a larger one moved ptxas'
// registers), LayerArgs elsewhere (the wide forms read their weight
// scratch, LayerArgs::wt).
template <int R, int FORM>
struct FormArgs {
  using type = LayerArgs;
};
template <int R>
struct FormArgs<R, kRecompute> {
  using type =
      typename std::conditional<(R > kNarrowR), LayerArgs,
                                TailsLayerArgs>::type;
};

__device__ __forceinline__ void st32(bf16_t* p, unsigned v) {
  *reinterpret_cast<unsigned*>(p) = v;
}
__device__ __forceinline__ float rnd_bf(float x) { return bf2f(f2bf(x)); }
// the sum over a quad of lanes (one row of a C fragment), the same bits in
// each of them
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// out = gated W_out for NT n tiles from tile j0 (W_out^T in wo, row stride
// LDO), each tile's sum in float32 over the k steps in order.
template <int NT, int R, int LDO>
__device__ __forceinline__ void out_mma(float (&oc)[NT][4],
                                        const unsigned (&ga)[R / 16][4],
                                        const bf16_t* wo, int j0) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16_t* p = wo + (8 * (j0 + j) + g) * LDO + 16 * kk + 2 * q;
      const unsigned b[2] = {ld32(p), ld32(p + 8)};
      mma_bf16_add(oc[j], ga[kk], b);
    }
}

// The merged head over one warp's 16 rows [mr, mr + 16) from the A
// fragments as of rnd(leaky(skip)) (SK k steps): y = . W1 + b1 sixteen
// columns at a time, rnd(leaky(y)) as the A fragment of the next k step of
// z = . W2 + b2 (z in registers, C <= 64), then each row's NLL and
// first-argmax match in its quad of lanes, added to loss and match (lane
// q = 0) over the valid rows.
template <int SK>
__device__ __forceinline__ void head_slab(const HeadEpilogue& hd,
                                          const HeadSmem& hs,
                                          const bf16_t* w1t,
                                          const bf16_t* w2t, const float* b1,
                                          const float* b2,
                                          const unsigned (&as)[SK][4],
                                          long mr, long m_total, int t_len,
                                          float& loss, float& match) {
  constexpr int NT = 8;   // z's n tiles at C <= 64
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int C = hd.c, nt = hs.cp / 8;
  float z[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[j][e] = 0.f;
  for (int kk = 0; kk < hs.cp / 16; ++kk) {
    float y[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[h][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < SK; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bf16_t* bp =
            w1t + (16 * kk + 8 * h + g) * hs.ld1 + 16 * ks + 2 * q;
        const unsigned b[2] = {ld32(bp), ld32(bp + 8)};
        mma_bf16_add(y[h], as[ks], b);
      }
    float ly[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ly[h][e] = head_core::leaky(y[h][e] +
                                    b1[16 * kk + 8 * h + 2 * q + (e & 1)]);
    const unsigned af[4] = {pack2(ly[0][0], ly[0][1]),
                            pack2(ly[0][2], ly[0][3]),
                            pack2(ly[1][0], ly[1][1]),
                            pack2(ly[1][2], ly[1][3])};
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nt) {
        const bf16_t* bp = w2t + (8 * j + g) * hs.ld2 + 16 * kk + 2 * q;
        const unsigned b[2] = {ld32(bp), ld32(bp + 8)};
        mma_bf16_add(z[j], af, b);
      }
  }
  // per row (h: rows mr + g, mr + g + 8): max, first argmax, z at the
  // target, over the lane's columns in order, then across the quad
  int tg[2], am[2] = {C, C};
  float mx[2] = {-INFINITY, -INFINITY}, zt[2] = {0.f, 0.f};
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long m = mr + g + 8 * h;
    const int b = m < m_total ? static_cast<int>(m / t_len) : 0;
    const int t = m < m_total ? static_cast<int>(m % t_len) : 0;
    valid[h] = m < m_total && t >= hd.rf - 1 && t < t_len - 1;
    tg[h] = m < m_total ? hd.tgt[static_cast<long>(t) * hd.batch + b] : -1;
  }
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
  float sep[2] = {0.f, 0.f}, pt[2] = {0.f, 0.f};
  if (hd.parity) {
    // p = e / sum, then sum exp(p) and p at the target
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * q + (e & 1), h = e >> 1;
        if (j < nt && col < C) {
          const float p = z[j][e] / es[h];
          sep[h] += expf(p);
          if (col == tg[h]) pt[h] = p;
        }
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float nll = hd.parity ? logf(quad_sum(sep[h])) - quad_sum(pt[h])
                                : logf(es[h]) + mx[h] - zt[h];
    if (q == 0 && valid[h]) {
      loss += nll;
      match += am[h] == tg[h] ? 1.f : 0.f;
    }
  }
}

// This warp's 16 rows from row m of a float32 (M, N) array into buf (row
// stride LD) by cp.async, zero past the rows.
template <int N, int LD>
__device__ __forceinline__ void stage_rows_f32(float* buf, const float* src,
                                               long m, long m_total) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * (N / 4); i += 32) {
    const int row = i / (N / 4), c4 = 4 * (i % (N / 4));
    const bool ok = m + row < m_total;
    cp_async16(buf + row * LD + c4, ok ? src + (m + row) * N + c4 : src, ok);
  }
}

// the save forms' tie margin: 8 float32 rounding units (of |a|_2 |w|_2)
constexpr float kTie = 8.f / 16777216.f;

// Whether float32 v lies within tau of the bf16 rounding tie (the midpoint
// between two bf16 values) inside its bf16 interval, or tau is too large
// to tell: then a value tau away may round to another bf16 value.
__device__ __forceinline__ bool near_bf16_tie(float v, float tau) {
  const unsigned u = __float_as_uint(v) & 0xffff0000u;
  const float lo = __uint_as_float(u), mid = __uint_as_float(u | 0x8000u);
  return fabsf(v - mid) < tau || tau > 0.25f * fabsf(mid - lo);
}

// One element of fg = [h | h(t-d) | ctx] W_fg as the plain version's
// float32 product sums it (cuBLAS on the card): k over W_in in order, one
// fmaf per term from zero, over the bf16 operand row and W_fg^T row.
template <int LDH, int LDW>
__device__ __forceinline__ float fg_chain(const bf16_t* hp, const bf16_t* wf,
                                          int row, int col, int win) {
  const bf16_t* a = hp + row * LDH;
  const bf16_t* w = wf + col * LDW;
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < win; k += 2) {
    const unsigned av = ld32(a + k), wv = ld32(w + k);
    acc = fmaf(__uint_as_float(av << 16), __uint_as_float(wv << 16), acc);
    acc = fmaf(__uint_as_float(av & 0xffff0000u),
               __uint_as_float(wv & 0xffff0000u), acc);
  }
  return acc;
}

// The save forms' gate of one fg pass p (NP filter n tiles from p NP and
// their gate tiles; fg sums in the fg_mma layout): tf and sg, the elements
// near a bf16 rounding tie summed again as the plain version sums them
// through the warp's queue (qk, qv; qb the fg bias row offsets of the
// warp's 16 rows), tfsg stored, gated into the A fragments ga of the skip
// product and, where a layer follows, the warp's k-major gt.  wf holds the
// pass's W_fg^T rows: the row of fg column c (w R + c', w = 0 filter, 1
// gate) is srow(c).  rk: the tie margin times the lane's two operand rows'
// L2 norms; wn: W_fg's column norms.
template <int R, int NP, int LDH, int LDW, int QCAP, typename Srow>
__device__ __forceinline__ void save_gate(
    const LayerArgs& a, const float (&fg)[2 * NP][4], int p,
    const float* const (&bfr)[2], const float (&rk)[2], const float* wn,
    const bf16_t* hp, const bf16_t* wf, Srow srow, unsigned* qk, float* qv,
    const int* qb, int r0, long mr, int win, bf16_t* gt,
    unsigned (&ga)[R / 16][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = threadIdx.x & 3;
  const long m_total = a.m_total;
  // the gate, and the elements whose fg is summed again: bit 8 jj + 2e
  // + (0: f, 1: g) of flags
  float tv[NP][4], sv[NP][4];
  unsigned flags = 0;
#pragma unroll
  for (int jj = 0; jj < NP; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = p * NP + jj, c = 8 * j + 2 * q + (e & 1);
      const float* bf = bfr[e >> 1];
      const float t = tanhf(fg[jj][e] + __ldg(bf + c));
      const float s = sigmoidf(fg[NP + jj][e] + __ldg(bf + R + c));
      tv[jj][e] = t;
      sv[jj][e] = s;
      const float tt = (1.f - t * t) * rk[e >> 1] * wn[c] +
                       4.f * kTie * fabsf(t);
      const float ts = s * (1.f - s) * rk[e >> 1] * wn[R + c] +
                       4.f * kTie * s;
      bool ff = near_bf16_tie(t, tt), fs = near_bf16_tie(s, ts);
      if (a.raw_gate) {
        const float tp =
            fabsf(s) * tt + fabsf(t) * ts + 4.f * kTie * fabsf(t * s);
        const bool fp = near_bf16_tie(t * s, tp);
        ff = ff || fp;
        fs = fs || fp;
      }
      flags |= (ff ? 1u : 0u) << (8 * jj + 2 * e) |
               (fs ? 1u : 0u) << (8 * jj + 2 * e + 1);
    }
  // The flagged elements go through the warp's queue, in rounds of
  // QCAP, in the order of lanes, then bits: the warp's lanes sum them
  // as the plain version does and apply the gate, and each owner takes
  // its values back.
  const int n_own = __popc(flags);
  int first = n_own;   // the lane's first queue index (a lane scan)
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, first, off);
    if (lane >= off) first += v;
  }
  const int n_q = __shfl_sync(0xffffffffu, first, 31);
  first -= n_own;
  for (int rb = 0; rb < n_q; rb += QCAP) {
    // push: the lane's flagged elements, one pass over its set bits
    int slot = first - rb;
    for (unsigned f = flags; f; f &= f - 1u, ++slot) {
      const int bit = __ffs(f) - 1;
      if (slot >= 0 && slot < QCAP) {
        const int e = bit % 8 / 2, w = bit & 1;
        const int c = 8 * (p * NP + bit / 8) + 2 * q + (e & 1);
        qk[slot] = static_cast<unsigned>((r0 + g + 8 * (e >> 1)) << 8 |
                                         (w * R + c));
      }
    }
    __syncwarp();
    for (int i = lane; i < min(n_q - rb, QCAP); i += 32) {
      const int row = static_cast<int>(qk[i] >> 8);
      const int col = static_cast<int>(qk[i] & 0xffu);
      const float v = fg_chain<LDH, LDW>(hp, wf, row, srow(col), win) +
                      __ldg(a.b_fg + qb[row - r0] + col);
      qv[i] = col < R ? tanhf(v) : sigmoidf(v);
    }
    __syncwarp();
    // pickup, without branches: every bit reads a slot, the flagged
    // ones in this round take it
#pragma unroll
    for (int bit = 0; bit < 8 * NP; ++bit) {
      const int at = first + __popc(flags & ((1u << bit) - 1u)) - rb;
      const bool take = (flags >> bit & 1u) && at >= 0 && at < QCAP;
      const float v = qv[min(max(at, 0), QCAP - 1)];
      const int jj = bit / 8, e = bit % 8 / 2;
      if (bit & 1)
        sv[jj][e] = take ? v : sv[jj][e];
      else
        tv[jj][e] = take ? v : tv[jj][e];
    }
    __syncwarp();
  }
#pragma unroll
  for (int jj = 0; jj < NP; ++jj) {
    const int j = p * NP + jj;
    float vf[4], vg[4], gv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float t = tv[jj][e], s = sv[jj][e];
      vf[e] = rnd_bf(t);
      vg[e] = rnd_bf(s);
      gv[e] = a.raw_gate ? t * s : vf[e] * vg[e];
      if (a.h_next)
        gt[(8 * j + 2 * q + (e & 1)) * 16 + g + 8 * (e >> 1)] =
            f2bf(gv[e]);
    }
    ga[j / 2][2 * (j & 1)] = pack2(gv[0], gv[1]);
    ga[j / 2][2 * (j & 1) + 1] = pack2(gv[2], gv[3]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long m = mr + g + 8 * h;
      if (m < m_total) {
        bf16_t* tp = a.tfsg + m * 2 * R + 8 * j + 2 * q;
        st32(tp, pack2(vf[2 * h], vf[2 * h + 1]));
        st32(tp + R, pack2(vg[2 * h], vg[2 * h + 1]));
      }
    }
  }
}

// ------------------------------------------------- the wide save forms
// At R = 128 the save forms' layouts no longer fit a block's 232,448 bytes
// of shared memory: W_fg^T alone is 2R rows of 3R+8 bf16 (200,704 bytes),
// beside a 128-row operand tile of 100,352; and the save backward's
// float32 W_out and W_fg take 532,480 bytes at R = S = 128 with video.  So
// the wide forms (stack_layer_kernel<R, S, kSave> and
// stack_bwd_layer_kernel<R, S, kBwdSave> at R > kNarrowR) keep only the
// activations of a tile in shared memory and stream the weights through a
// ring of two slabs by cp.async, the next slab in flight while a warp
// computes on the current one.  Each tile reads every weight once from
// the L2 cache (the layer's weights, 0.26 MB in bf16 forward and 0.52 MB
// in float32 backward, stay resident there).
//   forward   the fg product runs in R/16 passes, each over its slab of 16
//             filter columns of W_fg^T and their 16 gate columns, as the
//             narrow form's FP passes do over W_fg^T in shared memory:
//             fg and the gate in registers, the tie queue re-sums in the
//             plain version's order from the operand tile and the slab
//             (whose rows are the pass's columns), tfsg stored, gated
//             into the A fragments of the skip product and into the
//             warp's gt; then the residual's fmaf chain over k in order
//             from two slabs of W_out's residual columns (k halves), the
//             float32 h and hsave[l+1] from registers and global memory;
//             then the skip part on the tensor cores, a slab of 64 W_out^T
//             skip rows at a time.  A fg pass's slab needs W_fg^T's rows,
//             which the wrapper's scratch holds in bf16 (stack_wt_kernel,
//             once a call for every layer): a slab is whole 16-byte
//             copies.  The float32 h and the skip sum are read from global
//             memory where the narrow form stages them.
//   backward  64-row tiles of [dh | dskip] and of the taps (widened to
//             float32 in the dfg rows, which their dfg then overwrites in
//             place) stay in shared memory; dgated = [dh | dskip] W_out^T
//             runs over slabs of 32 rows of W_out, dfg_w = dfg W_fg^T over
//             slabs of 32 rows of W_fg (as they lie in global memory,
//             float32), both split-TF32 as the narrow form's.
// Bound at the R = 128 probe (B = 2, T = 160000, L = 9, R = S = 128, video):
// the forward's 262,144 operations a row and layer on bf16 operands, 0.76
// TFLOP, 0.76 ms at 989 TF/s; the backward's layer products and weight
// gradients about 1.51 TFLOP, 3.05 ms at the TF32 495 TF/s: both bound by
// operations.  As launched the weight slabs add about 0.26 MB (forward) and
// 0.52 MB (backward) of L2 reads a tile, and the save forms' float32
// intermediates move as at the narrow widths.

// Every layer's bf16 weights for the wide forms (WideShape::wt_elems a
// layer): W_fg^T, then W_out's residual columns k-major (res_t 0: the save
// forms' chain) or W_out^T's residual rows (res_t 1: the recompute forms'
// tensor-core product), then W_out^T's skip rows, rounded as the TPU
// kernel's _mdot rounds them.  With res_t 1 the layer's W_out^T (R + S, R)
// is whole after W_fg^T.
__global__ void __launch_bounds__(kThreads)
    stack_wt_kernel(const float* w_fg, const float* w_out, int n_layers,
                    int win, int r, int s, int res_t, bf16_t* wt) {
  const int no = r + s;
  const long n_fg = 2L * r * win, n_res = static_cast<long>(r) * r;
  const long per = n_fg + n_res + static_cast<long>(s) * r;
  const long total = per * n_layers;
  for (long i = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x;
       i < total; i += static_cast<long>(gridDim.x) * kThreads) {
    const long l = i / per;
    long e = i % per;
    const float* wf = w_fg + l * win * 2 * r;
    const float* wo = w_out + l * r * no;
    float v;
    if (e < n_fg) {
      v = wf[(e % win) * 2 * r + e / win];           // W_fg^T (2R, W_in)
    } else if ((e -= n_fg) < n_res) {
      v = res_t ? wo[(e % r) * no + e / r]           // W_out[:, :R]^T (c, k)
                : wo[(e / r) * no + e % r];          // W_out[:, :R] (k, c)
    } else {
      e -= n_res;
      v = wo[(e % r) * no + r + e / r];              // W_out[:, R:]^T
    }
    store_act(wt + i, v);
  }
}

// One layer of the wide save forward (see above); the narrow save form's
// arithmetic and order throughout: the same fg_mma passes, tie margin and
// queue, residual chain and skip product, so the plain version's bits hold
// as far as the plain version's float32 products are the chains the re-sums
// and the residual follow.
template <int R, int S>
__device__ __forceinline__ void save_wide_layer(const LayerArgs& a) {
  using Sh = WideShape<R, S>;
  constexpr int ROWS = Sh::kRows, THREADS = Sh::kThreads, QCAP = Sh::kQcap;
  constexpr int LDH = Sh::kLdh, LDW = Sh::kLdw, LDK = Sh::kLdk;
  constexpr int LDO = Sh::kLdo, NC = Sh::kNc, NP = NC / 8, FP = Sh::kFp;
  constexpr int KH = Sh::kKh, SW = Sh::kSw, CW = R / 8;
  constexpr int SLAB = static_cast<int>(Sh::kSlab / 2);   // bf16 elements
  static_assert(CW == 16, "the residual chain's 16 columns a lane");
  const int win = a.ctx ? 3 * R : 2 * R, per_row = win / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = tid & 3, r0 = 16 * warp;
  const long m_total = a.m_total;
  bf16_t* hp = reinterpret_cast<bf16_t*>(smem);
  bf16_t* ring = reinterpret_cast<bf16_t*>(smem + Sh::kRing);
  bf16_t* gt = reinterpret_cast<bf16_t*>(smem + Sh::kGt) + warp * R * 16;
  unsigned* qk = reinterpret_cast<unsigned*>(smem + Sh::kQk) + warp * QCAP;
  float* qv = reinterpret_cast<float*>(smem + Sh::kQv) + warp * QCAP;
  int* qb = reinterpret_cast<int*>(smem + Sh::kQb) + warp * 16;
  float* wn = reinterpret_cast<float*>(smem + Sh::kWn);
  const bf16_t* wft = a.wt;                          // (2R, W_in)
  const bf16_t* wkr = wft + 2L * R * win;            // (R, R) k-major
  const bf16_t* wos = wkr + R * R;                   // (S, R)

  // slab j of a tile into dst: pass j's W_fg^T rows (its NC filter
  // columns, then their gate columns), a residual slab's W_out rows k, or
  // a skip slab's W_out^T rows
  auto load_slab = [&](int j, bf16_t* dst) {
    if (j < FP) {
      for (int i = tid; i < 2 * NC * per_row; i += THREADS) {
        const int row = i / per_row, c8 = 8 * (i % per_row);
        const int col = row < NC ? NC * j + row : R + NC * j + row - NC;
        cp_async16(dst + row * LDW + c8,
                   wft + static_cast<long>(col) * win + c8, true);
      }
    } else if (j < FP + Sh::kRk) {
      const int k0 = KH * (j - FP);
      for (int i = tid; i < KH * (R / 8); i += THREADS) {
        const int row = i / (R / 8), c8 = 8 * (i % (R / 8));
        cp_async16(dst + row * LDK + c8, wkr + (k0 + row) * R + c8, true);
      }
    } else {
      const int c0 = SW * (j - FP - Sh::kRk);
      const int rows = S - c0 < SW ? S - c0 : SW;
      for (int i = tid; i < rows * (R / 8); i += THREADS) {
        const int row = i / (R / 8), c8 = 8 * (i % (R / 8));
        cp_async16(dst + row * LDO + c8, wos + (c0 + row) * R + c8, true);
      }
    }
  };

  // the L2 norms of W_fg's bf16 columns, for the ties' bounds (visible
  // after the first step's barrier)
  for (int c = tid; c < 2 * R; c += THREADS) {
    float ss = 0.f;
    for (int k = 0; k < win; ++k) {
      const float w = rnd_bf(a.w_fg[static_cast<long>(k) * 2 * R + c]);
      ss = fmaf(w, w, ss);
    }
    wn[c] = sqrtf(ss);
  }
  const bool read_s = !a.first;
  const long n_tiles = (m_total + ROWS - 1) / ROWS;
  int ring_i = 0;   // ring slot of the current slab
  if (blockIdx.x < n_tiles) {
    stage_operands<R, LDH, ROWS, THREADS>(hp, a.h, a.ctx,
                                          static_cast<long>(blockIdx.x) * ROWS,
                                          m_total, a.t_len, a.d, per_row);
    load_slab(0, ring);
  }
  cp_async_commit();
  for (long tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x) {
    const long m0 = tile_i * ROWS, mr = m0 + r0, next = tile_i + gridDim.x;
    int j = 0;
    // step j of the tile: slab j resident for every warp; in flight the
    // next slab (after the last, the next tile's first) and, once the fg
    // passes are done with hp, the next tile's operand rows
    auto step = [&]() -> const bf16_t* {
      cp_async_wait<0>();
      __syncthreads();
      bf16_t* nb = ring + ((ring_i + 1) & 1) * SLAB;
      if (j + 1 < Sh::kSteps)
        load_slab(j + 1, nb);
      else if (next < n_tiles)
        load_slab(0, nb);
      if (j == FP && next < n_tiles)
        stage_operands<R, LDH, ROWS, THREADS>(hp, a.h, a.ctx, next * ROWS,
                                              m_total, a.t_len, a.d,
                                              per_row);
      cp_async_commit();
      const bf16_t* cur = ring + (ring_i & 1) * SLAB;
      ++ring_i;
      ++j;
      return cur;
    };
    const bf16_t* wf = step();   // the tile's operands and first slab

    // the L2 norms of the lane's two operand rows, for the ties' bounds
    float rn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bf16_t* p = hp + (r0 + g + 8 * h) * LDH;
      float ss = 0.f;
      for (int k = 2 * q; k < win; k += 8) {
        const unsigned u = ld32(p + k);
        const float x0 = __uint_as_float(u << 16);
        const float x1 = __uint_as_float(u & 0xffff0000u);
        ss = fmaf(x1, x1, fmaf(x0, x0, ss));
      }
      rn[h] = sqrtf(quad_sum(ss));
    }
    const float* bfr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long m = mr + g + 8 * h;
      const int off = static_cast<int>(m < m_total ? m / a.t_len : 0) * 2 * R;
      bfr[h] = a.b_fg + off;
      if (q == 0) qb[g + 8 * h] = off;
    }
    const float rk[2] = {kTie * rn[0], kTie * rn[1]};
    unsigned ga[R / 16][4];
#pragma unroll
    for (int p = 0; p < FP; ++p) {
      if (p > 0) wf = step();
      float fg[2 * NP][4];
      fg_mma<2 * NP, LDH>(fg, hp, r0, win, [&](int kk, int jj, unsigned* b) {
        const bf16_t* bp = wf + (8 * jj + g) * LDW + 16 * kk + 2 * q;
        b[0] = ld32(bp);
        b[1] = ld32(bp + 8);
      });
      save_gate<R, NP, LDH, LDW, QCAP>(
          a, fg, p, bfr, rk, wn, hp, wf,
          [p](int c) { return c < R ? c - NC * p : NC + c - R - NC * p; },
          qk, qv, qb, r0, mr, win, gt, ga);
    }

    // the residual's out + b_out as the plain version sums it (k in order,
    // one fmaf per term) over the lane's 4 rows by CW columns, k from two
    // slabs of W_out's rows: h = (out + b_out) + h in float32, hsave[l+1]
    // = bf16(h); the first layer's h is its bf16 input
    const int rg = lane >> 3, cg = lane & 7;
    float acc[4][CW];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < CW; ++jj) acc[i][jj] = 0.f;
    for (int kh = 0; kh < Sh::kRk; ++kh) {
      const bf16_t* wk = step();
      if (!a.h_next) continue;
      const bf16_t* gp = gt + 4 * rg + KH * kh * 16;
      const bf16_t* wp = wk + CW * cg;
#pragma unroll 2
      for (int k = 0; k < KH; ++k) {
        const uint2 au = *reinterpret_cast<const uint2*>(gp + k * 16);
        const float av[4] = {__uint_as_float(au.x << 16),
                             __uint_as_float(au.x & 0xffff0000u),
                             __uint_as_float(au.y << 16),
                             __uint_as_float(au.y & 0xffff0000u)};
        const uint4 u0 = *reinterpret_cast<const uint4*>(wp + k * LDK);
        const uint4 u1 = *reinterpret_cast<const uint4*>(wp + k * LDK + 8);
        const unsigned wu[8] = {u0.x, u0.y, u0.z, u0.w,
                                u1.x, u1.y, u1.z, u1.w};
        float wv[CW];
#pragma unroll
        for (int jj = 0; jj < CW; jj += 2) {
          wv[jj] = __uint_as_float(wu[jj / 2] << 16);
          wv[jj + 1] = __uint_as_float(wu[jj / 2] & 0xffff0000u);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < CW; ++jj)
            acc[i][jj] = fmaf(av[i], wv[jj], acc[i][jj]);
      }
    }
    if (a.h_next) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long m = m0 + r0 + 4 * rg + i;
        if (m >= m_total) continue;
#pragma unroll
        for (int jj = 0; jj < CW; jj += 4) {
          const int c = CW * cg + jj;
          float o[4];
          if (a.first) {
            load4(a.h + m * R + c, o);
          } else {
            const float4 v = *reinterpret_cast<const float4*>(a.hf + m * R + c);
            o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
          }
          float v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[u] = (acc[i][jj + u] + __ldg(a.b_out + c + u)) + o[u];
          if (a.keep_h)
            *reinterpret_cast<float4*>(a.hf + m * R + c) =
                make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<uint2*>(a.h_next + m * R + c) =
              make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
        }
      }
    }

    // the skip part on the tensor cores, a slab of W_out^T's skip rows at
    // a time: the sum over layers in float32, stored in bf16 by the last
    // layer
    constexpr int NTS = (S < SW ? S : SW) / 8;
    for (int sj = 0; sj < Sh::kSk; ++sj) {
      const bf16_t* wo = step();
      float oc[NTS][4];
      out_mma<NTS, R, LDO>(oc, ga, wo, 0);
#pragma unroll
      for (int jj = 0; jj < NTS; ++jj) {
        const int c = SW * sj + 8 * jj + 2 * q;
        const float b0 = __ldg(a.b_out + R + c);
        const float b1 = __ldg(a.b_out + R + c + 1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long m = m0 + r0 + g + 8 * e;
          if (m >= m_total) continue;
          float2 s = make_float2(oc[jj][2 * e] + b0, oc[jj][2 * e + 1] + b1);
          if (read_s) {
            const float2 o =
                *reinterpret_cast<const float2*>(a.skacc + m * S + c);
            s = make_float2(o.x + s.x, o.y + s.y);
          }
          if (a.last)
            st32(a.skip + m * S + c, pack2(s.x, s.y));
          else
            *reinterpret_cast<float2*>(a.skacc + m * S + c) = s;
        }
      }
    }
  }  // tiles
  cp_async_wait<0>();
}

// ----------------------------------------- the wide recompute forms
// At R = 128 the recompute form's layout (TlShape: a 256-row operand tile
// beside W_fg^T and W_out^T, staged once) takes about twice a block's
// 232,448 bytes of shared memory.  Its wide form (stack_layer_kernel<R, S,
// kRecompute> at R > kNarrowR) walks the tiles as the wide save forward
// does: 8 warps on 128-row tiles, the tile's operand rows [h | h(t-d) |
// ctx] (bf16) in shared memory, the weights streamed through a ring of two
// slabs by cp.async from the wrapper's bf16 scratch (stack_wt_kernel in
// its recompute layout: W_fg^T, then W_out^T).  Per tile: kFp fg passes,
// each over a slab of kNc filter columns of W_fg^T and their kNc gate
// columns (fg_mma, the gate in registers, gated rounded into the A
// fragments of the out product), then out = gated W_out on the tensor
// cores over slabs of kSw W_out^T rows, the residual h + out rounded into
// h_next and the skip sum in float32.  h stays bf16 between layers, as in
// the narrow form, whose arithmetic and order this is: every fg and out n
// tile summed from zero over its k steps in order (mma_bf16_add), no tie
// re-sums.  So the backward's rebuilds, which launch this kernel, give the
// forward's layer inputs bit for bit.  The residual's h is read from
// global memory (L2), as the operand tile takes the next tile's rows
// while the out slabs run.  The wide recompute backward launches it once
// more a layer with the taps alone (TAPS, the layer kernel's form kTaps:
// no h_next, no skip sum, the fg passes and no out slabs), tf and sg in
// float32 into a.taps for its layer launch, so that they are the forward's
// bits.
// Bound at the flagship's depth at R = S = 128 (B = 2, T = 160000, L =
// 30, video): 262,144 operations a row and layer on bf16 operands, 2.5
// TFLOP, 2.5 ms at 989 TF/s, against about 0.3 GB of compulsory traffic
// (x, ctx, skip, the checkpoints): bound by operations.
template <int R, int S>
struct WideTlShape {
  static constexpr int kThreads = 256, kWarps = kThreads / 32;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kNc = 16, kFp = R / kNc;          // fg passes
  static constexpr int kSw = 64;                         // out columns a slab
  static constexpr int kOs = (R + S + kSw - 1) / kSw;    // out slabs
  static constexpr int kSteps = kFp + kOs;
  static constexpr int kLdh = 3 * R + 8, kLdw = 3 * R + 8, kLdo = R + 8;
  static_assert(R % kSw == 0 && S % 8 == 0,
                "out slabs wholly in the residual or the skip part");
  static constexpr size_t kSlab =
      max_size(static_cast<size_t>(2 * kNc) * kLdw,
               static_cast<size_t>(kSw) * kLdo) * 2;
  static constexpr size_t kRing = static_cast<size_t>(kRows) * kLdh * 2;
  static constexpr size_t kEnd = kRing + 2 * kSlab;
};

// Dynamic shared memory of the recompute form's layer launch at (R, S).
template <int R, int S>
size_t tails_smem() {
  if constexpr (R > kNarrowR)
    return WideTlShape<R, S>::kEnd;
  else
    return TlShape<R, S>::smem();
}

// One layer of the wide recompute forward (see above).
template <int R, int S, bool TAPS>
__device__ __forceinline__ void tails_wide_layer(const LayerArgs& a) {
  using Sh = WideTlShape<R, S>;
  constexpr int ROWS = Sh::kRows, THREADS = Sh::kThreads, NO = R + S;
  constexpr int LDH = Sh::kLdh, LDW = Sh::kLdw, LDO = Sh::kLdo;
  constexpr int NC = Sh::kNc, NP = NC / 8, FP = Sh::kFp, SW = Sh::kSw;
  constexpr int NTO = SW / 8;                               // out n tiles
  constexpr int SLAB = static_cast<int>(Sh::kSlab / 2);   // bf16 elements
  const int win = a.ctx ? 3 * R : 2 * R, per_row = win / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = tid & 3, r0 = 16 * warp;
  const long m_total = a.m_total;
  bf16_t* hp = reinterpret_cast<bf16_t*>(smem);
  bf16_t* ring = reinterpret_cast<bf16_t*>(smem + Sh::kRing);
  const bf16_t* wft = a.wt;                          // (2R, W_in)
  const bf16_t* wot = wft + 2L * R * win;            // (R + S, R)
  // a taps launch runs the fg passes alone
  constexpr int steps = TAPS ? FP : Sh::kSteps;

  // slab j of a tile into dst: pass j's W_fg^T rows (its NC filter
  // columns, then their gate columns), or an out slab's W_out^T rows
  auto load_slab = [&](int j, bf16_t* dst) {
    if (j < FP) {
      for (int i = tid; i < 2 * NC * per_row; i += THREADS) {
        const int row = i / per_row, c8 = 8 * (i % per_row);
        const int col = row < NC ? NC * j + row : R + NC * j + row - NC;
        cp_async16(dst + row * LDW + c8,
                   wft + static_cast<long>(col) * win + c8, true);
      }
    } else {
      const int c0 = SW * (j - FP), rows = NO - c0 < SW ? NO - c0 : SW;
      for (int i = tid; i < rows * (R / 8); i += THREADS) {
        const int row = i / (R / 8), c8 = 8 * (i % (R / 8));
        cp_async16(dst + row * LDO + c8,
                   wot + static_cast<long>(c0 + row) * R + c8, true);
      }
    }
  };
  const long n_tiles = (m_total + ROWS - 1) / ROWS;
  int ring_i = 0;   // ring slot of the current slab
  if (blockIdx.x < n_tiles) {
    stage_operands<R, LDH, ROWS, THREADS>(hp, a.h, a.ctx,
                                          static_cast<long>(blockIdx.x) * ROWS,
                                          m_total, a.t_len, a.d, per_row);
    load_slab(0, ring);
  }
  cp_async_commit();
  for (long tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x) {
    const long m0 = tile_i * ROWS, next = tile_i + gridDim.x;
    int j = 0;
    // step j of the tile: slab j resident for every warp; in flight the
    // next slab (after the last, the next tile's first) and, once the fg
    // passes are done with hp, the next tile's operand rows
    auto step = [&]() -> const bf16_t* {
      cp_async_wait<0>();
      __syncthreads();
      bf16_t* nb = ring + ((ring_i + 1) & 1) * SLAB;
      if (j + 1 < steps)
        load_slab(j + 1, nb);
      else if (next < n_tiles)
        load_slab(0, nb);
      if (j == FP && next < n_tiles)
        stage_operands<R, LDH, ROWS, THREADS>(hp, a.h, a.ctx, next * ROWS,
                                              m_total, a.t_len, a.d,
                                              per_row);
      cp_async_commit();
      const bf16_t* cur = ring + (ring_i & 1) * SLAB;
      ++ring_i;
      ++j;
      return cur;
    };
    // the fg bias rows of the lane's two rows' batch rows
    const float* bfr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long m = m0 + r0 + g + 8 * h;
      bfr[h] = a.b_fg + (m < m_total ? m / a.t_len : 0) * 2 * R;
    }
    // fg and the gate, pass p over filter n tiles p NP .. + NP and their
    // gate tiles; gated rounded to bf16 in the A fragment layout of the
    // out product (its k step kk = filter n tiles 2kk, 2kk + 1)
    unsigned ga[R / 16][4];
#pragma unroll
    for (int p = 0; p < FP; ++p) {
      const bf16_t* wf = step();
      float fg[2 * NP][4];
      fg_mma<2 * NP, LDH>(fg, hp, r0, win, [&](int kk, int jj, unsigned* b) {
        const bf16_t* bp = wf + (8 * jj + g) * LDW + 16 * kk + 2 * q;
        b[0] = ld32(bp);
        b[1] = ld32(bp + 8);
      });
#pragma unroll
      for (int jj = 0; jj < NP; ++jj) {
        const int jt = p * NP + jj;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* bf = bfr[e >> 1];
          const int c = 8 * jt + 2 * q + (e & 1);
          const float tf = tanhf(fg[jj][e] + __ldg(bf + c));
          const float sg = sigmoidf(fg[NP + jj][e] + __ldg(bf + R + c));
          v[e] = tf * sg;
          const long m = m0 + r0 + g + 8 * (e >> 1);
          if (TAPS && m < m_total) {
            a.taps[m * 2 * R + c] = tf;
            a.taps[m * 2 * R + R + c] = sg;
          }
        }
        ga[jt / 2][2 * (jt & 1)] = pack2(v[0], v[1]);
        ga[jt / 2][2 * (jt & 1) + 1] = pack2(v[2], v[3]);
      }
    }
    if constexpr (TAPS) {
      // every warp is done with the operand rows: the next tile's land
      __syncthreads();
      if (next < n_tiles)
        stage_operands<R, LDH, ROWS, THREADS>(hp, a.h, a.ctx, next * ROWS,
                                              m_total, a.t_len, a.d,
                                              per_row);
      cp_async_commit();
      continue;
    }
    // out + b_out, a slab of W_out^T rows at a time: the residual (an
    // 8-column n tile lies wholly in it or in the skip part), then the skip
    // sum in layer order
    for (int os = 0; os < Sh::kOs; ++os) {
      const bf16_t* wo = step();
      const int c0 = SW * os;
      const int nt = (NO - c0 < SW ? NO - c0 : SW) / 8;
      float oc[NTO][4];
#pragma unroll
      for (int jo = 0; jo < NTO; ++jo)
#pragma unroll
        for (int e = 0; e < 4; ++e) oc[jo][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk)
#pragma unroll
        for (int jo = 0; jo < NTO; ++jo) {
          if (jo < nt) {
            const bf16_t* p = wo + (8 * jo + g) * LDO + 16 * kk + 2 * q;
            const unsigned b[2] = {ld32(p), ld32(p + 8)};
            mma_bf16_add(oc[jo], ga[kk], b);
          }
        }
#pragma unroll
      for (int jo = 0; jo < NTO; ++jo) {
        if (jo >= nt) continue;
        const int c = c0 + 8 * jo + 2 * q;
        const float b0 = __ldg(a.b_out + c), b1 = __ldg(a.b_out + c + 1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long m = m0 + r0 + g + 8 * e;
          if (m >= m_total) continue;
          const float v0 = oc[jo][2 * e] + b0, v1 = oc[jo][2 * e + 1] + b1;
          if (c < R) {
            if (a.h_next) {
              const unsigned hw = ld32(a.h + m * R + c);
              *reinterpret_cast<unsigned*>(a.h_next + m * R + c) =
                  pack2(v0 + __uint_as_float(hw << 16),
                        v1 + __uint_as_float(hw & 0xffff0000u));
            }
          } else if (a.skacc) {
            float* sp = a.skacc + m * S + c - R;
            float2 sv = make_float2(v0, v1);
            if (!a.first) {
              const float2 o = *reinterpret_cast<const float2*>(sp);
              sv = make_float2(o.x + v0, o.y + v1);
            }
            if (a.last)
              *reinterpret_cast<unsigned*>(a.skip + m * S + c - R) =
                  pack2(sv.x, sv.y);
            else
              *reinterpret_cast<float2*>(sp) = sv;
          }
        }
      }
    }
  }  // tiles
  cp_async_wait<0>();
}

// One layer of the trunk forward, in the form FORM (see above).  Persistent
// blocks walk tiles of 16 rows a warp, W_fg^T and W_out staged once.  Warp
// w takes rows 16w .. 16w + 15 of the tile: fg over all 2R columns on the
// tensor cores (fg_mma), the gate in registers, gated rounded to bf16,
// out over R+S columns, then the residual and the skip sum.
//   The recompute form (16 warps) stages each tile's operands with all
// their loads in flight at once and runs out on the tensor cores from the
// gate's fragments.
//   The save forms (8 warps) give the bits of the plain version wherever
// a bf16 rounding of theirs feeds a later layer: a sum in another order
// moves a value by a float32 ulp or so, and where that flips a rounding
// the flip spreads through the layers above (at the breakdancing shape
// about 4% of tfsg's bf16 values differed after 9 layers, some by 7
// steps).  So (1) each tf, sg (and, in the merged form, tf * sg) whose
// tensor-core fg lies within a margin of its rounding tie has that fg
// summed again as the plain version sums it (fg_chain), the warp's lanes
// sharing the flagged elements through a queue; and (2) the residual's
// out = gated W_out[:, :R] is that fmaf chain from the start (4 rows by
// R/8 columns a lane, from gated and W_out k-major in shared memory), so
// the float32 residual stream and hsave equal the plain version's.  These
// are the save forms' only fmaf products; the skip part of out stays on
// the tensor cores (the skip sum feeds no layer).  The margin, 8 float32
// rounding units (2^-24) of |a|_2 |w|_2 (the operand row's and W_fg
// column's L2 norms), is empirical, not a bound: two orders of K terms
// may differ by up to about K units of sum |a_i w_i|.  On seeded inputs
// at the three training widths the largest gap seen was 2.8 units of
// |a|_2 |w|_2, and 1-2% of the tf and 0.1-0.2% of the sg elements are
// flagged (utils/fwd_order.py).  It also rests on the plain version's
// float32 product being that chain, as cuBLAS's is on the H100 at these
// shapes; a flip that escapes it spreads as above.  The tile is
// pipelined by cp.async: the warp's float32 rows of h and of the skip sum
// land in shared memory while it runs fg and the gate, and the next tile's
// operands while it runs out and the stores.
template <int R, int S, int FORM>
__global__ void __launch_bounds__(
    FORM == kRecompute && R <= kNarrowR ? kTlThreads
                                        : SaveShape<R, S>::kThreads,
    FORM == kRecompute || FORM == kTaps ? 1 : SaveShape<R, S>::kMinBlocks)
    stack_layer_kernel(typename FormArgs<R, FORM>::type a) {
  static_assert(R % 16 == 0 && S % 8 == 0, "16-wide k steps, 8-wide tiles");
  const int win = a.ctx ? 3 * R : 2 * R, per_row = win / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = tid & 3, r0 = 16 * warp;
  const long m_total = a.m_total;
  static_assert(FORM != kTaps || R > kNarrowR, "taps launches are wide");
  if constexpr ((FORM == kRecompute || FORM == kTaps) && R > kNarrowR) {
  tails_wide_layer<R, S, FORM == kTaps>(a);
  } else if constexpr (FORM == kRecompute) {
  using Sh = TlShape<R, S>;
  constexpr int NO = Sh::kNo, LDH = Sh::kLdh, LDW = Sh::kLdw;
  constexpr int LDO = Sh::kLdo, NF = 2 * R / 8, NOT = NO / 8;
  bf16_t* hp = reinterpret_cast<bf16_t*>(smem);   // (kTlRows, LDH)
  bf16_t* wf = hp + kTlRows * LDH;                  // (2R, LDW) W_fg^T
  bf16_t* wo = wf + 2 * R * LDW;                    // (NO, LDO) W_out^T

  // the weights rounded to bf16, as the TPU kernel's _mdot rounds
  // operands, one row per output column; staged once per block
  for (int i = tid; i < win * 2 * R; i += kTlThreads)
    wf[(i % (2 * R)) * LDW + i / (2 * R)] = f2bf(a.w_fg[i]);
  for (int i = tid; i < R * NO; i += kTlThreads)
    wo[(i % NO) * LDO + i / NO] = f2bf(a.w_out[i]);
  const long n_tiles = (m_total + kTlRows - 1) / kTlRows;
  for (long tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x) {
    const long m0 = tile_i * kTlRows;
    __syncthreads();
    uint4 nx[Sh::kNp];
#pragma unroll
    for (int u = 0; u < Sh::kNp; ++u) {
      const int i = tid + u * kTlThreads;
      if (i < kTlRows * per_row)
        nx[u] = hp_item<R>(a.h, a.ctx, m0 + i / per_row, a.m_total,
                           a.t_len, a.d, 8 * (i % per_row));
    }
#pragma unroll
    for (int u = 0; u < Sh::kNp; ++u) {
      const int i = tid + u * kTlThreads;
      if (i < kTlRows * per_row)
        *reinterpret_cast<uint4*>(hp + (i / per_row) * LDH +
                                  8 * (i % per_row)) = nx[u];
    }
    __syncthreads();

    // fg, then the gate: tile j (filter) and j + R/8 (gate) lie in the
    // same registers of a lane; gated rounded to bf16 in the A fragment
    // layout of the out product (its k step kk = n tiles 2kk, 2kk + 1)
    unsigned ga[R / 16][4];
    {
      float fg[NF][4];
      fg_mma<NF, LDH>(fg, hp, r0, win, [&](int kk, int j, unsigned* b) {
        const bf16_t* p = wf + (8 * j + g) * LDW + 16 * kk + 2 * q;
        b[0] = ld32(p);
        b[1] = ld32(p + 8);
      });
      // the fg bias rows of the lane's two rows' batch rows
      const float* bfr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long m = m0 + r0 + g + 8 * h;
        bfr[h] = a.b_fg + (m < a.m_total ? m / a.t_len : 0) * 2 * R;
      }
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* bf = bfr[e >> 1];
          const int c = 8 * j + 2 * q + (e & 1);
          v[e] = tanhf(fg[j][e] + __ldg(bf + c)) *
                 sigmoidf(fg[j + R / 8][e] + __ldg(bf + R + c));
        }
        ga[j / 2][2 * (j & 1)] = pack2(v[0], v[1]);
        ga[j / 2][2 * (j & 1) + 1] = pack2(v[2], v[3]);
      }
    }
    float oc[NOT][4];
#pragma unroll
    for (int j = 0; j < NOT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk)
#pragma unroll
      for (int j = 0; j < NOT; ++j) {
        const bf16_t* p = wo + (8 * j + g) * LDO + 16 * kk + 2 * q;
        const unsigned b[2] = {ld32(p), ld32(p + 8)};
        mma_bf16_add(oc[j], ga[kk], b);
      }
    // out + b_out: the residual (8 columns lie wholly in it or in the
    // skip part), then the skip sum in layer order
#pragma unroll
    for (int j = 0; j < NOT; ++j) {
      const int c = 8 * j + 2 * q;
      const float b0 = __ldg(a.b_out + c), b1 = __ldg(a.b_out + c + 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + g + 8 * e;
        const long m = m0 + row;
        if (m >= a.m_total) continue;
        const float v0 = oc[j][2 * e] + b0, v1 = oc[j][2 * e + 1] + b1;
        if (c < R) {
          if (a.h_next) {
            const unsigned hw = ld32(hp + row * LDH + c);
            *reinterpret_cast<unsigned*>(a.h_next + m * R + c) =
                pack2(v0 + __uint_as_float(hw << 16),
                      v1 + __uint_as_float(hw & 0xffff0000u));
          }
        } else if (a.skacc) {
          float* sp = a.skacc + m * S + c - R;
          float2 s = make_float2(v0, v1);
          if (!a.first) {
            const float2 o = *reinterpret_cast<const float2*>(sp);
            s = make_float2(o.x + v0, o.y + v1);
          }
          if (a.last)
            *reinterpret_cast<unsigned*>(a.skip + m * S + c - R) =
                pack2(s.x, s.y);
          else
            *reinterpret_cast<float2*>(sp) = s;
        }
      }
    }
  }  // tiles
  } else if constexpr (R > kNarrowR) {
  static_assert(FORM == kSave, "the wide forms have no merged head");
  save_wide_layer<R, S>(a);
  } else {
  using Sh = SaveShape<R, S>;
  constexpr int ROWS = Sh::kRows, THREADS = Sh::kThreads, QCAP = Sh::kQcap;
  constexpr int LDH = Sh::kLdh, LDW = Sh::kLdw, LDO = Sh::kLdo;
  constexpr int LDK = Sh::kLdk, LDHF = Sh::kLdhf, LDSF = Sh::kLdsf;
  constexpr int NO = R + S, CW = R / 8;   // CW: residual columns a lane
  bf16_t* hp = reinterpret_cast<bf16_t*>(smem);
  bf16_t* wf = reinterpret_cast<bf16_t*>(smem + Sh::kWf);
  bf16_t* wos = reinterpret_cast<bf16_t*>(smem + Sh::kWos);
  float* sb = reinterpret_cast<float*>(smem + Sh::kSb);
  unsigned* qk = reinterpret_cast<unsigned*>(smem + Sh::kQk) + warp * QCAP;
  float* qv = reinterpret_cast<float*>(smem + Sh::kQv) + warp * QCAP;
  int* qb = reinterpret_cast<int*>(smem + Sh::kQb) + warp * 16;
  float* wn = reinterpret_cast<float*>(smem + Sh::kWn);
  bf16_t* wk = reinterpret_cast<bf16_t*>(smem + Sh::kWk);
  bf16_t* gt = reinterpret_cast<bf16_t*>(smem + Sh::kGt) + warp * R * 16;
  float* hb = reinterpret_cast<float*>(smem + Sh::kHb);
  // the merged form's last layer: the head's weights in the residual's
  // place, zero-padded
  const HeadSmem hs(S, FORM == kSaveHead ? a.hd.c : 0);
  bf16_t* w1t = wk;                                   // (CP, ld1) W1^T
  bf16_t* w2t = w1t + hs.cp * hs.ld1;                 // (CP, ld2) W2^T
  float* hb1 = reinterpret_cast<float*>(w2t + hs.cp * hs.ld2);
  float* hb2 = hb1 + hs.cp;

  // the weights rounded to bf16, as the TPU kernel's _mdot rounds
  // operands; staged once per block
  for (int i = tid; i < win * 2 * R; i += THREADS)
    wf[(i % (2 * R)) * LDW + i / (2 * R)] = f2bf(a.w_fg[i]);
  for (int i = tid; i < R * S; i += THREADS)
    wos[(i % S) * LDO + i / S] = f2bf(a.w_out[(i / S) * NO + R + i % S]);
  if constexpr (FORM == kSaveHead) {
    const int C = a.hd.c;
    for (int i = tid; i < hs.cp * hs.sp; i += THREADS) {
      const int c = i / hs.sp, k = i % hs.sp;
      w1t[c * hs.ld1 + k] = f2bf(c < C && k < S ? a.hd.w1[k * C + c] : 0.f);
    }
    for (int i = tid; i < hs.cp * hs.cp; i += THREADS) {
      const int c = i / hs.cp, k = i % hs.cp;
      w2t[c * hs.ld2 + k] = f2bf(c < C && k < C ? a.hd.w2[k * C + c] : 0.f);
    }
    for (int i = tid; i < hs.cp; i += THREADS) {
      hb1[i] = i < C ? a.hd.b1[i] : 0.f;
      hb2[i] = i < C ? a.hd.b2[i] : 0.f;
    }
  } else {
    for (int i = tid; i < R * R; i += THREADS)
      wk[(i / R) * LDK + i % R] = f2bf(a.w_out[(i / R) * NO + i % R]);
  }
  __syncthreads();
  for (int c = tid; c < 2 * R; c += THREADS) {
    float ss = 0.f;
    for (int k = 0; k < win; ++k) {
      const float w = bf2f(wf[c * LDW + k]);
      ss = fmaf(w, w, ss);
    }
    wn[c] = sqrtf(ss);
  }
  float loss = 0.f, match = 0.f;   // the merged head's, lanes q = 0
  // the float32 h is read from the second layer on, and written for the
  // layers after the next; the skip sum read from the second layer on
  const bool read_h = !a.first && a.h_next, read_s = !a.first;
  const long n_tiles = (m_total + ROWS - 1) / ROWS;
  if (blockIdx.x < n_tiles)
    stage_operands<R, LDH, ROWS, THREADS>(hp, a.h, a.ctx,
                                          static_cast<long>(blockIdx.x) * ROWS,
                                          m_total, a.t_len, a.d, per_row);
  cp_async_commit();
  for (long tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x) {
    const long m0 = tile_i * ROWS, mr = m0 + r0;
    // the warp's rows of h and of the skip sum, in flight during fg (once
    // every lane has read the last tile's)
    __syncwarp();
    if (read_h) stage_rows_f32<R, LDHF>(hb + r0 * LDHF, a.hf, mr, m_total);
    if (read_s)
      stage_rows_f32<S, LDSF>(sb + r0 * LDSF, a.skacc, mr, m_total);
    cp_async_commit();
    cp_async_wait<1>();   // this tile's operands
    __syncthreads();

    // the L2 norms of the lane's two operand rows, for the ties' bounds
    float rn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bf16_t* p = hp + (r0 + g + 8 * h) * LDH;
      float ss = 0.f;
      for (int k = 2 * q; k < win; k += 8) {
        const unsigned u = ld32(p + k);
        const float x0 = __uint_as_float(u << 16);
        const float x1 = __uint_as_float(u & 0xffff0000u);
        ss = fmaf(x1, x1, fmaf(x0, x0, ss));
      }
      rn[h] = sqrtf(quad_sum(ss));
    }
    // the fg bias rows of the lane's two rows' batch rows (their offsets
    // also in qb, for the queue)
    const float* bfr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long m = mr + g + 8 * h;
      const int off = static_cast<int>(m < m_total ? m / a.t_len : 0) * 2 * R;
      bfr[h] = a.b_fg + off;
      if (q == 0) qb[g + 8 * h] = off;
    }
    // fg and the gate in FP passes (two from R = 32, so that the sums
    // stay in registers: up to 255 at R = 64, 128 at R = 32), each over NP
    // filter tiles and their gate tiles; tf and sg rounded into tfsg,
    // gated into the A fragments of the skip product and, for the
    // residual's chain, into gt
    constexpr int FP = R >= 32 ? 2 : 1, NP = R / 8 / FP;
    const float rk[2] = {kTie * rn[0], kTie * rn[1]};
    unsigned ga[R / 16][4];
#pragma unroll
    for (int p = 0; p < FP; ++p) {
      float fg[2 * NP][4];
      fg_mma<2 * NP, LDH>(fg, hp, r0, win, [&](int kk, int j, unsigned* b) {
        const int col = j < NP ? p * NP + j : R / 8 + p * NP + j - NP;
        const bf16_t* bp = wf + (8 * col + g) * LDW + 16 * kk + 2 * q;
        b[0] = ld32(bp);
        b[1] = ld32(bp + 8);
      });
      save_gate<R, NP, LDH, LDW, QCAP>(a, fg, p, bfr, rk, wn, hp, wf,
                                       [](int c) { return c; }, qk, qv, qb,
                                       r0, mr, win, gt, ga);
    }
    // the residual's chain tile of the lane: rows 4 rg .. 4 rg + 3 of the
    // warp's, columns CW cg .. CW cg + CW - 1; the first layer's h is its
    // bf16 input, taken from hp before hp takes the next tile's operands
    const int rg = lane >> 3, cg = lane & 7;
    float h0[4][CW];
    if (a.first && a.h_next) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < CW; ++jj)
          h0[i][jj] = bf2f(hp[(r0 + 4 * rg + i) * LDH + CW * cg + jj]);
    }
    __syncthreads();      // every warp is done with hp
    if (tile_i + gridDim.x < n_tiles)
      stage_operands<R, LDH, ROWS, THREADS>(
          hp, a.h, a.ctx, (tile_i + gridDim.x) * ROWS, m_total, a.t_len, a.d,
          per_row);
    cp_async_commit();
    cp_async_wait<1>();   // the warp's rows of h and of the skip sum
    __syncwarp();

    // out + b_out over the residual's R columns, as the plain version
    // sums it (k in order, one fmaf per term): h = (out + b_out) + h in
    // float32, hsave[l+1] = bf16(h)
    if (a.h_next) {
      float acc[4][CW];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < CW; ++jj) acc[i][jj] = 0.f;
      const bf16_t* gp = gt + 4 * rg;
      const bf16_t* wp = wk + CW * cg;
#pragma unroll 4
      for (int k = 0; k < R; ++k) {
        const uint2 au = *reinterpret_cast<const uint2*>(gp + k * 16);
        const float av[4] = {__uint_as_float(au.x << 16),
                             __uint_as_float(au.x & 0xffff0000u),
                             __uint_as_float(au.y << 16),
                             __uint_as_float(au.y & 0xffff0000u)};
        // CW bf16 of W_out's row k in one load (CW * 2 bytes, aligned)
        unsigned wu[CW / 2];
        if constexpr (CW == 8) {
          const uint4 u = *reinterpret_cast<const uint4*>(wp + k * LDK);
          wu[0] = u.x, wu[1] = u.y, wu[2] = u.z, wu[3] = u.w;
        } else if constexpr (CW == 4) {
          const uint2 u = *reinterpret_cast<const uint2*>(wp + k * LDK);
          wu[0] = u.x, wu[1] = u.y;
        } else {
          wu[0] = ld32(wp + k * LDK);
        }
        float wv[CW];
#pragma unroll
        for (int jj = 0; jj < CW; jj += 2) {
          wv[jj] = __uint_as_float(wu[jj / 2] << 16);
          wv[jj + 1] = __uint_as_float(wu[jj / 2] & 0xffff0000u);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < CW; ++jj)
            acc[i][jj] = fmaf(av[i], wv[jj], acc[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 4 * rg + i;
        const long m = m0 + row;
        if (m >= m_total) continue;
        float v[CW];
#pragma unroll
        for (int jj = 0; jj < CW; ++jj) {
          const int c = CW * cg + jj;
          const float o = a.first ? h0[i][jj] : hb[row * LDHF + c];
          v[jj] = (acc[i][jj] + __ldg(a.b_out + c)) + o;
        }
#pragma unroll
        for (int jj = 0; jj < CW; jj += 2) {
          const int c = CW * cg + jj;
          if (a.keep_h)
            *reinterpret_cast<float2*>(a.hf + m * R + c) =
                make_float2(v[jj], v[jj + 1]);
          st32(a.h_next + m * R + c, pack2(v[jj], v[jj + 1]));
        }
      }
    }
    // the skip part on the tensor cores: the sum over layers in float32,
    // stored in bf16 by the last layer; the merged head's rows keep the
    // finished sums
    {
      float oc[S / 8][4];
      out_mma<S / 8, R, LDO>(oc, ga, wos, 0);
#pragma unroll
      for (int j = 0; j < S / 8; ++j) {
        const int c = 8 * j + 2 * q;
        const float b0 = __ldg(a.b_out + R + c);
        const float b1 = __ldg(a.b_out + R + c + 1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r0 + g + 8 * e;
          const long m = m0 + row;
          float2 s = make_float2(0.f, 0.f);
          if (m < m_total) {
            s = make_float2(oc[j][2 * e] + b0, oc[j][2 * e + 1] + b1);
            if (read_s) {
              const float2 o =
                  *reinterpret_cast<const float2*>(sb + row * LDSF + c);
              s = make_float2(o.x + s.x, o.y + s.y);
            }
            if (a.last)
              st32(a.skip + m * S + c, pack2(s.x, s.y));
            else
              *reinterpret_cast<float2*>(a.skacc + m * S + c) = s;
          }
          oc[j][2 * e] = s.x;
          oc[j][2 * e + 1] = s.y;
        }
      }
      if constexpr (FORM == kSaveHead) {
        // rnd(leaky(rnd(skip))) as the A fragments of y (k step ks = the
        // skip's n tiles 2ks, 2ks + 1; zero past S)
        constexpr int SK = (S + 15) / 16;
        unsigned as[SK][4];
#pragma unroll
        for (int ks = 0; ks < SK; ++ks)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 2 * ks + (i >> 1), e = 2 * (i & 1);
            as[ks][i] = j < S / 8
                            ? pack2(head_core::leaky(rnd_bf(oc[j][e])),
                                    head_core::leaky(rnd_bf(oc[j][e + 1])))
                            : 0u;
          }
        head_slab<SK>(a.hd, hs, w1t, w2t, hb1, hb2, as, mr, m_total,
                      a.t_len, loss, match);
      }
    }
  }  // tiles
  cp_async_wait<0>();
  if constexpr (FORM == kSaveHead) {
    // the block's sums, in thread order (hp is free after the tiles)
    __syncthreads();
    float* red = reinterpret_cast<float*>(hp);
    red[tid] = loss;
    red[THREADS + tid] = match;
    __syncthreads();
    if (tid == 0) {
      float sl = 0.f, sm = 0.f;
      for (int i = 0; i < THREADS; ++i) {
        sl += red[i];
        sm += red[THREADS + i];
      }
      a.hd.part[2 * blockIdx.x] = sl;
      a.hd.part[2 * blockIdx.x + 1] = sm;
    }
  }
  }
}

// ------------------------------------------ the float32 save forward
// The save strategy's forward with the float32 compute dtype
// (stack_kernel.py:280 _fwd_kernel, whose roundings to out_dtype do
// nothing in float32): hsave, tfsg and skip in float32, h float32 from
// layer to layer as it is stored (hsave[l+1] is layer l's output).  One
// launch for the embedding (stack_embed_f32_kernel), then one launch of
// stack_layer_f32_kernel<R, S> per layer.  Both products, fg = [h | h(t-d)
// | ctx] W_fg and out = gated W_out, run as split-TF32 mma.sync
// (mma_tf32.cuh) in three passes, each k step added in float32
// (mma_split_add): no operand is exact in TF32.  Nothing is rounded to
// bf16, so the bf16 save forms' bit-keeping (the tie queue, the residual's
// fmaf chain) has nothing to keep and is not here; the forward is held to
// its plain version at a tolerance.
//
// The recompute strategy's float32 forms launch the same layer kernel
// with no taps (tfsg null) for the forward and its checkpoints, and with
// no skip sum either (skacc null) for the backward's rebuilds; their
// layer backward is stack_bwd_layer_kernel's kBwdRcF32 form.  At R = 128
// both are the wgmma kernels A and B below.
//
// Bound at the breakdancing cell (B=2, T=160000, L=9, R=S=64, video):
// 1.9e11 operations at the TF32 peak counted once (0.38 ms) against 2.4
// GB of compulsory float32 traffic (hsave, tfsg, skip, ctx: 0.71 ms),
// bound by bytes.  As launched each layer also reads h, its tap and ctx
// and moves the skip sum (about 0.65 GB a layer), and the three split
// passes of k = 8 take six times the mma.sync issue of the bf16 form's k =
// 16 steps (PERF.md).
//
// Block: 8 warps on 64-row tiles, persistent; W_fg^T (2R, 3R+4) and
// W_out^T (R+S, R+4) staged once in float32 as each product's B fragments
// read them.  Per tile the operand rows [h | h(t-d) | ctx] (64, 3R+4)
// arrive by cp.async (zero past the rows and for the tap before t = d).
// Warp w takes rows 16 (w % 4) .. + 16 and half w / 4 of the filter
// columns with their gate columns: fg, the gate, tfsg stored, gated = tf
// sg into the tile's gated rows (64, R+4); after a barrier the same warp
// takes half of the R+S out columns over all of gated: the residual h +
// out into hsave[l+1] and the skip sum (float32 between launches, stored
// by the last layer).  Row strides of 4 times an odd number of floats put
// the fragment loads of a warp in 32 distinct banks.  At R = S = 64 the
// block takes 202,752 bytes of shared memory: one block an SM.

__global__ void __launch_bounds__(kThreads)
    stack_embed_f32_kernel(const int* pack, int pack_cols,
                           const float* table2, int vocab, int batch,
                           int t_len, int r, float* hsave0) {
  const long total = static_cast<long>(batch) * t_len * r;
  for (long i = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x;
       i < total; i += static_cast<long>(gridDim.x) * kThreads) {
    const long m = i / r;
    const int j = static_cast<int>(i % r);
    const int b = static_cast<int>(m / t_len), t = static_cast<int>(m % t_len);
    const int cur = pack[static_cast<long>(t) * pack_cols + b];
    const int prev = pack[static_cast<long>(t) * pack_cols + batch + b];
    float v = 0.f;
    if (cur >= 0 && cur < vocab) v += table2[cur * r + j];
    if (prev >= 0 && prev < vocab) v += table2[(vocab + prev) * r + j];
    hsave0[i] = v;
  }
}

// The float32 layer kernel's shared memory, byte offsets in this order:
// the operand tile hp (kRows, kLdh), W_fg^T wf (2R, kLdw), W_out^T wo (R+S,
// kLdo) and the tile's gated rows gs (kRows, kLdg), all float32
// (ops/cuda/stack_kernel.f32_smem mirrors it).
template <int R, int S>
struct F32Shape {
  static constexpr int kRows = 64, kThreads = 256;
  static constexpr int kLdh = 3 * R + 4, kLdw = 3 * R + 4;
  static constexpr int kLdo = R + 4, kLdg = R + 4;
  static constexpr size_t kWf = static_cast<size_t>(kRows) * kLdh * 4;
  static constexpr size_t kWo = kWf + static_cast<size_t>(2 * R) * kLdw * 4;
  static constexpr size_t kGs = kWo + static_cast<size_t>(R + S) * kLdo * 4;
  static constexpr size_t kEnd = kGs + static_cast<size_t>(kRows) * kLdg * 4;
};

struct F32LayerArgs {
  const float* h;        // (M, R) the layer's input, hsave[l]
  float* h_next;         // (M, R) its output, hsave[l+1], or null (the last)
  const float* ctx;      // (M, R) or null
  const float* b_fg;     // (B, 2R) this layer's rows
  const float* w_fg;     // (W_in, 2R)
  const float* w_out;    // (R, R+S)
  const float* b_out;    // (R+S)
  float* tfsg;           // (M, 2R) this layer's taps, or null (recompute)
  float* skacc;          // (M, S) the skip sum between launches, or null
                         // (a rebuild in the recompute backward)
  float* skip;           // (M, S) skip_sum, stored by the last layer
  long m_total;
  int t_len, d, first, last;
  const float* wt;       // the wide form (kernel A): this layer's weight
                         // images (stack_wt_split_kernel)
};

// ------------------------------ the wide float32 recompute kernels
// At R = 128 (MOVENET_WIDE_WIDTHS) the float32 recompute forms run two
// kernels of their own on Hopper's warpgroup tensor-core instruction:
//   kernel A, stack_layer_wg_f32_kernel<R, S>: one layer of the float32
//     recompute forward (stack_kernel.py:929 _fwd_kernel_tails in float32),
//     also launched by the backward for each rebuilt layer input and, with
//     the taps alone, before each layer backward;
//   kernel B, stack_bwd_wg_kernel<R, S, CTX, kBwdRcF32>: the layer launch
//     of the float32 recompute backward (stack_kernel.py:1031
//     _bwd_kernel_tails in float32): dgated, dfg from the taps, dfg_w.
// Every product is split-TF32 (mma_tf32.cuh's split, three passes) on
// wgmma m64nNk8 from shared memory (wgmma_tf32.cuh).  Kernel B's other
// forms are the wide bf16 backwards' layer launches, and W_fg's gradient of
// the bf16 forms there runs on the same building block (stack_wgrad_wg_kernel):
// "the wide layer backwards on wgmma" and "W_fg's gradient on wgmma" below.
//
// Bound.  fg = [h | h(t-d) | ctx] W_fg (k = W_in = 3R, n = 2R) and out =
// gated W_out (k = R, n = R + S) are 262,144 multiply-adds a row at R = S =
// 128 with ctx, as are the backward's dgated (k = R + S, n = R) and dfg_w (k
// = 2R, n = W_in): at the flagship's depth (B = 2, T = 160,000, 30 layers)
// 2.5 TFLOP a pass, 5.1 ms at TF32's 495 TF/s counted once, 0.17 ms a layer;
// the compulsory traffic (the layer's input, ctx, the output or gradients,
// float32) is about 0.1 ms a layer: bound by operations.  The three passes
// make it 0.51 ms a layer at the tensor cores' peak.
//
// Design, against what held the mma.sync forms at about 4 ms a layer:
//  - every operand is split once: the weights once a call into TF32 big
//    and small images in global memory (stack_wt_split_kernel), the
//    activation tiles as they land in shared memory (a producer warpgroup
//    loads them, splits them and stores both parts), so no k loop splits;
//  - wgmma m64nNk8 .tf32 from shared memory (both operands K-major in 8 x 4
//    core matrices, no swizzle), n = 128 or 192 a product: each operand
//    byte read into the tensor core feeds 64 rows by up to 192 columns;
//  - 128-row tiles: two consumer warpgroups of 64 rows share each weight
//    stage, half the L2 weight traffic a row of the 64-row forms;
//  - the operands stream through a ring of stages with full and empty
//    mbarriers: the producer's bulk copies (cp.async.bulk, the weight
//    images laid out as the stages want them) and split stores run ahead
//    of the consumers; no block-wide barrier a step;
//  - one block of 384 threads an SM: two consumer warpgroups (warps 0-7)
//    at kConsumerRegs registers a thread, so that a chunk's sum beside the
//    running sums stays in registers, and a producer warpgroup (warps
//    8-11) at kProducerRegs, moved by setmaxnreg from the 168 a thread
//    that a 384-thread block is given.  A block of 8 consumer warps and one
//    producer warp is given 168 as well (registers are allocated for
//    12 warps), and spilled its running sums: 1-2 KB a thread, to L2,
//    since the tiles leave L1 no room.
// Accumulation: the tensor core sums each stage's 16 k (two k steps of
// three passes) from zero; the chunk is added to a float32 running sum
// (wg_chunk_add), as mma_split_add adds each k step of 8 in the mma.sync
// forms: the tensor core's own sum truncates, and over a long k it drifts
// (ops/stack_kernel.WIDE_F32_CHUNK, measured against float64 in
// tests/test_torch_wgmma_cuda.py).  A chunk's sum and its running sum take
// two accumulators, and a consumer thread holds at most about 168
// registers (ptxas allocates the 384-thread block's 168 whatever
// setmaxnreg asks; running sums of 128 floats and a chunk of 64 spilled to
// L2, since the tiles leave L1 no room): every product is n = 64 (a chunk
// of 32 floats), and kernel A forms fg in two passes over k, each of R/2
// channels (the operand rows split again each pass), and out in two, its
// residual columns then its skip columns.
//
// The weight images (stack_wt_split_kernel, wgmma_tf32.cuh's layout, 16 k
// a chunk, each chunk's big part then its small part), in the order the
// kernels stream them: per layer for kernel A W_fg^T in two passes of R
// rows (R/2 filter columns, then their R/2 gate columns: filter column c
// and gate column c fall at the same places of one thread's sums, so that
// tanh * sigmoid stays in its registers), then W_out^T's residual rows (R
// x R) and its skip rows (S x R); with the backward's, after every layer's
// forward images, for kernel B W_out (R rows x R + S, zero to a multiple
// of 16) and W_fg in W_in / R passes of R rows (x 2R).
// registers a thread of the producer and consumer warpgroups: 128 x 56 +
// 256 x 224 = 384 x 168, the 384-thread block's own
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

template <int R, int S>
struct WgF32Images {
  static constexpr int kKc = 16, kNo = R + S;
  static constexpr int kK1 = (kNo + kKc - 1) / kKc * kKc;
  __host__ __device__ static long fwd_floats(int win) {
    return 2L * (2L * R * win + static_cast<long>(kNo) * R);
  }
  __host__ __device__ static long bwd_floats(int win) {
    return 2L * (static_cast<long>(R) * kK1 + 2L * R * win);
  }
  // rows and k of image i of a layer: 0, 1 W_fg^T's passes, 2 W_out^T's
  // residual rows, 3 its skip rows; 4 W_out, 5.. W_fg's passes
  __host__ __device__ static int rows(int i) { return i == 3 ? S : R; }
  __host__ __device__ static int kdim(int i, int win) {
    return i <= 1 ? win : i <= 3 ? R : i == 4 ? kK1 : 2 * R;
  }
};

// fwd 0: the backward's images alone (the wide bf16 backwards'), each
// layer's where the float32 forms' scratch holds them after the forward's.
template <int R, int S>
__global__ void __launch_bounds__(kThreads)
    stack_wt_split_kernel(const float* w_fg, const float* w_out, int n_layers,
                          int win, int fwd, int bwd, float* wt) {
  using Im = WgF32Images<R, S>;
  constexpr int KC = Im::kKc, NO = Im::kNo;
  const long fpl = fwd ? Im::fwd_floats(win) / 2 : 0;   // (big, small) pairs
  const long bpl = bwd ? Im::bwd_floats(win) / 2 : 0;
  const long total = (fpl + bpl) * n_layers;
  for (long i = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x;
       i < total; i += static_cast<long>(gridDim.x) * kThreads) {
    int l, img;
    long e;
    float* dst;
    if (i < fpl * n_layers) {
      l = static_cast<int>(i / fpl);
      e = i % fpl;
      dst = wt + l * 2 * fpl;
      img = 0;
    } else {
      const long j = i - fpl * n_layers;
      l = static_cast<int>(j / bpl);
      e = j % bpl;
      dst = wt + n_layers * 2 * fpl + l * 2 * bpl;
      img = 4;
    }
    // the image of pair e, and e within it
    for (;; ++img) {
      const long n = static_cast<long>(Im::rows(img)) * Im::kdim(img, win);
      if (e < n) break;
      e -= n;
      dst += 2 * n;
    }
    const int rows = Im::rows(img);
    const int chunk = static_cast<int>(e / (rows * KC));
    const int rem = static_cast<int>(e % (rows * KC));
    const int row = rem / KC, kk = rem % KC, k = KC * chunk + kk;
    const float* wf = w_fg + static_cast<long>(l) * win * 2 * R;
    const float* wo = w_out + static_cast<long>(l) * R * NO;
    float v;
    if (img <= 1) {
      const int ch = R / 2 * img + (row < R / 2 ? row : R + row - R / 2);
      v = wf[static_cast<long>(k) * 2 * R + ch];
    } else if (img <= 3) {
      v = wo[static_cast<long>(k) * NO + (img == 3 ? R : 0) + row];
    } else if (img == 4) {
      v = k < NO ? wo[static_cast<long>(row) * NO + k] : 0.f;
    } else {
      v = wf[(static_cast<long>(img - 5) * R + row) * 2 * R + k];
    }
    dst += static_cast<long>(chunk) * 2 * rows * KC;
    const int o = img_off(row, kk, KC);
    const float big = __uint_as_float(tf32_rna(v));
    dst[o] = big;
    dst[rows * KC + o] = __uint_as_float(tf32_rna(v - big));
  }
}

// Kernel A's block: two consumer warpgroups (warps 0-7) and a producer
// warpgroup (warps 8-11) on 128-row tiles.  Shared memory: the tile's gated
// rows as the out product's A image (big, then small: 128 x R floats each),
// then a ring of three stages, each the A image of 16 k of the tile's
// operand rows [h | h(t-d) | ctx] (big, small: 128 x 16 floats each) and a
// B image of 16 k of R weight rows (a W_fg^T pass, W_out^T's residual or
// skip rows), then the stages' barriers: 131,072 + 98,304 + 48 = 229,424
// bytes at R = 128.  Registers a consumer thread: a pass's running sums (64
// floats) and a chunk's (32).
template <int R, int S>
struct WgF32Fwd {
  static constexpr int kRows = 128, kThreads = 384, kKc = 16, kStages = 3;
  static constexpr size_t kA = static_cast<size_t>(kRows) * kKc * 4;
  static constexpr size_t kW = static_cast<size_t>(R) * kKc * 4;
  static constexpr size_t kStage = 2 * kA + 2 * kW;
  static constexpr size_t kG = static_cast<size_t>(kRows) * R * 4;
  static constexpr size_t kRing = 2 * kG;
  static constexpr size_t kBar = kRing + kStages * kStage;
  static constexpr size_t kEnd = kBar + 2 * kStages * 8;
  static_assert(R == 128 && (S == 8 || S == R),
                "n = 128 products; the skip part one of n = S");
};

// One layer of kernel A (see above).  Per tile: fg in two passes, each over
// the W_in / 16 stages of the operand rows (split again each pass) and 16 k
// of one of W_fg^T's passes; each consumer warpgroup forms its 64 rows by
// two products of n = 64 (R/2 filter columns, their gate columns) a stage,
// each chunk added to its running sum, then the gate of those R/2
// channels: the taps stored where asked, gated split into the gated image.
// Unless this is a taps launch (no h_next, no skip sum): out in two passes
// over the R / 16 stages of W_out^T's residual rows, then of its skip rows:
// the residual h + out into h_next, the skip sum.  Zero rows past m_total
// and for the tap before t = d.
template <int R, int S>
__global__ void __launch_bounds__(384, 1)
    stack_layer_wg_f32_kernel(F32LayerArgs a) {
  using Sh = WgF32Fwd<R, S>;
  constexpr int KC = Sh::kKc, ST = Sh::kStages, ROWS = Sh::kRows;
  constexpr uint32_t SBO = KC * 32, GSBO = R * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* gbig = reinterpret_cast<float*>(smem);
  float* gsmall = gbig + ROWS * R;
  unsigned char* ring = smem + Sh::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sh::kBar);
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 129);   // the producer's threads and its copy
      mbar_init(empty + s, 8);    // the consumers' warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int win = a.ctx ? 3 * R : 2 * R;
  const int n_fg = win / KC, n_out = R / KC;
  const bool outs = a.h_next != nullptr || a.skacc != nullptr;
  const long m_total = a.m_total, n_tiles = (m_total + ROWS - 1) / ROWS;
  RingPos pos;
  if (tid >= 256) {
    // the producer warpgroup: operand rows split into the stage's A image,
    // the weight images by bulk copy
    setmaxnreg_dec<kProducerRegs>();
    const int pl = tid - 256;
    // a stage's B image: `rows` rows of 16 k from src
    auto weights = [&](const float* src, int rows) {
      mbar_wait(empty + pos.stage, pos.phase ^ 1);
      if (pl == 0) {
        mbar_arrive_tx(full + pos.stage, rows * KC * 8);
        bulk_g2s(ring + pos.stage * Sh::kStage + 2 * Sh::kA, src,
                 rows * KC * 8, full + pos.stage);
      }
    };
    for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long m0 = tile * ROWS;
      for (int p = 0; p < 2; ++p)
        for (int c = 0; c < n_fg; ++c) {
          const int k0 = KC * c, part = k0 / R, j0 = k0 % R;
          float4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            // item i: row group i / 32, k group (i / 8) % 4, row i % 8 (its
            // 16 bytes are slot i of the image)
            const int i = pl + 128 * u;
            const int row = 8 * (i >> 5) + (i & 7), kc = (i >> 3) & 3;
            const long m = m0 + row;
            bool ok = m < m_total;
            const float* src = a.h + m * R + j0 + 4 * kc;
            if (part == 1) {
              ok = ok && static_cast<int>(static_cast<unsigned>(m) %
                                          static_cast<unsigned>(a.t_len)) >=
                             a.d;
              src -= static_cast<long>(a.d) * R;
            } else if (part == 2) {
              src = a.ctx + m * R + j0 + 4 * kc;
            }
            v[u] = ok ? __ldg(reinterpret_cast<const float4*>(src))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          weights(a.wt + 2L * R * win * p + 2L * c * R * KC, R);
          unsigned char* st = ring + pos.stage * Sh::kStage;
          float4* ab = reinterpret_cast<float4*>(st);
          float4* as = reinterpret_cast<float4*>(st + Sh::kA);
#pragma unroll
          for (int u = 0; u < 4; ++u) split4(v[u], ab[pl + 128 * u],
                                             as[pl + 128 * u]);
          fence_async_smem();
          mbar_arrive(full + pos.stage);
          pos.next(ST);
        }
      if (!outs) continue;
      for (int p = 0; p < 2; ++p) {
        const int rows = p ? S : R;
        const float* src = a.wt + 4L * R * win + 2L * R * R * p;
        for (int c = 0; c < n_out; ++c) {
          weights(src + 2L * c * rows * KC, rows);
          mbar_arrive(full + pos.stage);
          pos.next(ST);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int w = tid >> 7, lt = tid & 127;
    const int lane = lt & 31, g = lane >> 2, q = lane & 3;
    const int rt = 64 * w + 16 * (lt >> 5) + g;   // the lane's first tile row
    float t[64];
    // a stage's product of n = N (its B image's rows) into run, the A image
    // the stage's or, with gated, the gated image's 16 k at chunk c
    auto step = [&](float* run, bool first, int c, bool gated, auto n_const) {
      constexpr int N = decltype(n_const)::value;
      mbar_wait(full + pos.stage, pos.phase);
      const uint32_t sa = smem_u32(ring + pos.stage * Sh::kStage);
      const uint32_t ga = smem_u32(gbig) + w * 8 * GSBO + c * 512;
      const uint64_t ab = gated ? wg_desc(ga, GSBO)
                                : wg_desc(sa + w * 8 * SBO, SBO);
      const uint64_t as = gated ? wg_desc(ga + Sh::kG, GSBO)
                                : wg_desc(sa + Sh::kA + w * 8 * SBO, SBO);
      const uint32_t wb = sa + 2 * Sh::kA;
      wg_split_chunk<N, 2>(t, ab, as, wg_desc(wb, SBO),
                           wg_desc(wb + N * KC * 4, SBO), true);
      wg_chunk_add<N>(run, t, first);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + pos.stage);
      pos.next(ST);
    };
    using N128 = std::integral_constant<int, 128>;
    for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long m0 = tile * ROWS;
      const long mrow[2] = {m0 + rt, m0 + rt + 8};
      const float* bfr[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bfr[e] = a.b_fg + (mrow[e] < m_total ? mrow[e] / a.t_len : 0) * 2 * R;
      for (int p = 0; p < 2; ++p) {
        // fg of R/2 channels: filter columns (n tiles 0-7), then their gate
        // columns (8-15)
        float run[64];
        for (int c = 0; c < n_fg; ++c) step(run, c == 0, c, false, N128());
        // the gate: the taps where asked; gated into the out product's image
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int c = R / 2 * p + 8 * jb + 2 * q;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float tf[2], sg[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              tf[k] = tanhf(run[4 * jb + 2 * e + k] + __ldg(bfr[e] + c + k));
              sg[k] = sigmoidf(run[4 * (jb + 8) + 2 * e + k] +
                               __ldg(bfr[e] + R + c + k));
            }
            const long m = mrow[e];
            if (a.tfsg && m < m_total) {
              float* tp = a.tfsg + m * 2 * R + c;
              *reinterpret_cast<float2*>(tp) = make_float2(tf[0], tf[1]);
              *reinterpret_cast<float2*>(tp + R) = make_float2(sg[0], sg[1]);
            }
            if (outs) {
              const float gv[2] = {tf[0] * sg[0], tf[1] * sg[1]};
              float b[2], s[2];
#pragma unroll
              for (int k = 0; k < 2; ++k) {
                b[k] = __uint_as_float(tf32_rna(gv[k]));
                s[k] = __uint_as_float(tf32_rna(gv[k] - b[k]));
              }
              const int o = img_off(rt + 8 * e, c, R);
              *reinterpret_cast<float2*>(gbig + o) = make_float2(b[0], b[1]);
              *reinterpret_cast<float2*>(gsmall + o) = make_float2(s[0], s[1]);
            }
          }
        }
      }
      if (!outs) continue;
      // the warpgroup's gated rows, seen by its products
      fence_async_smem();
      named_sync(1 + w, 128);
      {
        // out's residual columns + b_out + h into h_next
        float ro[64];
        for (int c = 0; c < n_out; ++c) step(ro, c == 0, c, true, N128());
        if (a.h_next) {
#pragma unroll
          for (int jb = 0; jb < R / 8; ++jb) {
            const int c = 8 * jb + 2 * q;
            const float b0 = __ldg(a.b_out + c), b1 = __ldg(a.b_out + c + 1);
            const float* vr = ro + 4 * jb;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const long m = mrow[e];
              if (m >= m_total) continue;
              const float v0 = vr[2 * e] + b0, v1 = vr[2 * e + 1] + b1;
              const float2 o =
                  __ldg(reinterpret_cast<const float2*>(a.h + m * R + c));
              *reinterpret_cast<float2*>(a.h_next + m * R + c) =
                  make_float2(v0 + o.x, v1 + o.y);
            }
          }
        }
      }
      {
        // out's skip columns + b_out into the skip sum
        float rs[S / 2];
        for (int c = 0; c < n_out; ++c)
          step(rs, c == 0, c, true, std::integral_constant<int, S>());
        if (a.skacc) {
#pragma unroll
          for (int jb = 0; jb < S / 8; ++jb) {
            const int c = 8 * jb + 2 * q;
            const float b0 = __ldg(a.b_out + R + c);
            const float b1 = __ldg(a.b_out + R + c + 1);
            const float* sr = rs + 4 * jb;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const long m = mrow[e];
              if (m >= m_total) continue;
              const float v0 = sr[2 * e] + b0, v1 = sr[2 * e + 1] + b1;
              float2 sv = make_float2(v0, v1);
              float* sp = a.skacc + m * S + c;
              if (!a.first) {
                const float2 o = *reinterpret_cast<const float2*>(sp);
                sv = make_float2(o.x + v0, o.y + v1);
              }
              *reinterpret_cast<float2*>(a.last ? a.skip + m * S + c : sp) =
                  sv;
            }
          }
        }
      }
    }  // tiles
  }
}

// Kernel B's block: as kernel A's, on 128-row tiles.  Shared memory: a ring
// of seven stages, each the A image of 16 k of the tile's rows (big, small:
// 128 x 16 floats each; [dh | dskip] for dgated, dfg for dfg_w) and a B
// image of 16 k of R weight rows (W_out's, or a pass of W_fg's), then the
// barriers: 229,488 bytes at R = 128.  Registers a consumer thread: a
// running sum and a chunk of 64 floats (products of n = 128).
template <int R, int S>
struct WgF32Bwd {
  static constexpr int kRows = 128, kThreads = 384, kKc = 16, kStages = 7;
  static constexpr int kNo = R + S;
  static constexpr int kK1 = (kNo + kKc - 1) / kKc * kKc;
  static constexpr size_t kA = static_cast<size_t>(kRows) * kKc * 4;
  static constexpr size_t kW = static_cast<size_t>(R) * kKc * 4;
  static constexpr size_t kStage = 2 * kA + 2 * kW;
  static constexpr size_t kBar = kStages * kStage;
  static constexpr size_t kEnd = kBar + 2 * kStages * 8;
  static_assert(R == 128 && S % 4 == 0, "n = 128 products");
};

// One layer of kernel B (see above; the layer launch of the float32
// recompute backward at R = 128, on the taps of the layer's taps launch of
// kernel A).  Per tile: (1) dgated = [dh | dskip] W_out^T over (R + S) / 16
// stages: the producer forms dh = the layer above's dh + dfg_w_h plus its
// carry dfg_w_p(t + d), stores it for the W_out gradient and splits it with
// dskip; each consumer warpgroup's 64 rows by the R columns.  Then from the
// taps at the same places gated = tf * sg (stored for the W_out gradient)
// and dfg (stored for the W_fg gradient).  (2) Once every consumer has
// stored its dfg (a named barrier with the producer), dfg_w = dfg W_fg^T in
// W_in / R passes, each over 2R / 16 stages of dfg rows (split again by the
// producer each pass) and one of W_fg's passes of R rows: the dh part into
// dhp, the past part into p_out, the ctx part into dctx.  The order of the
// 64-row mma.sync forms' outputs and sums.
//
// The wide layer backwards on wgmma.  The same kernel is the layer launch of
// the wide bf16 backwards (FORM; _bwd_kernel_padded and _bwd_kernel_tails at
// R = 128 in bf16, whose backward products take float32 operands as the
// float32 forms' do, stack_kernel.py:199 _BWD_OPERAND_DT), on the same
// weight images (written once a call by wg_bwd_weights):
//   kBwdSave, the save and replay strategies': the taps are the forward's
//     bf16 tfsg, widened at the dgated places; gated is not stored (W_out's
//     gradient, MODE 1, takes tf * sg from tfsg);
//   kBwdRc, the recompute strategy's: the taps are float32, written into
//     this launch's dfg rows by a taps launch of the wide recompute forward
//     (fg formed again through the forward's passes, so the forward's bits),
//     each read at its place before dfg overwrites it; gated (float32) for
//     W_out's gradient, MODE 3;
//   kBwdRcF32, kernel B.
// The bf16 forms take dskip in bf16 (or the merged head's float32 dskip_f)
// and store the flat dctx of layer 0 in bf16 (dctx_bf), as the narrow forms
// do.  Kernel B's code and bits are those of its float32 form alone.
template <int R, int S, bool CTX, int FORM>
__global__ void __launch_bounds__(384, 1)
    stack_bwd_wg_kernel(BwdLayerArgs a, const float* img) {
  static_assert(FORM == kBwdSave || FORM == kBwdRc || FORM == kBwdRcF32,
                "the bf16 save and recompute forms and kernel B");
  constexpr bool F32 = FORM == kBwdRcF32;
  using Sh = WgF32Bwd<R, S>;
  constexpr int KC = Sh::kKc, NO = Sh::kNo, K1 = Sh::kK1, ST = Sh::kStages;
  constexpr int ROWS = Sh::kRows, NP = CTX ? 3 : 2;   // dfg_w's passes
  constexpr int N1 = K1 / KC, NF = 2 * R / KC;
  constexpr uint32_t SBO = KC * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sh::kBar);
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 129);
      mbar_init(empty + s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const long m_total = a.m_total, n_tiles = (m_total + ROWS - 1) / ROWS;
  const float* wo_img = img;
  const float* wf_img = img + 2L * R * K1;
  RingPos pos;
  if (tid >= 256) {
    // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    const int pl = tid - 256;
    // the stage's A image from v (slot pl + 128 u), the B image by copy
    auto fill = [&](const float4 (&v)[4], const float* b_src,
                    uint32_t b_bytes) {
      mbar_wait(empty + pos.stage, pos.phase ^ 1);
      unsigned char* st = smem + pos.stage * Sh::kStage;
      if (pl == 0) {
        mbar_arrive_tx(full + pos.stage, b_bytes);
        bulk_g2s(st + 2 * Sh::kA, b_src, b_bytes, full + pos.stage);
      }
      float4* ab = reinterpret_cast<float4*>(st);
      float4* as = reinterpret_cast<float4*>(st + Sh::kA);
#pragma unroll
      for (int u = 0; u < 4; ++u) split4(v[u], ab[pl + 128 * u],
                                         as[pl + 128 * u]);
      fence_async_smem();
      mbar_arrive(full + pos.stage);
      pos.next(ST);
    };
    for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long m0 = tile * ROWS;
      for (int c = 0; c < N1; ++c) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = pl + 128 * u;
          const int row = 8 * (i >> 5) + (i & 7);
          const int k = KC * c + 4 * ((i >> 3) & 3);
          const long m = m0 + row;
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (m < m_total) {
            if (k < R) {
              if (!a.top) {
                x = *reinterpret_cast<const float4*>(a.dhp + m * R + k);
                if (static_cast<int>(static_cast<unsigned>(m) %
                                     static_cast<unsigned>(a.t_len)) +
                        a.d_in < a.t_len) {
                  const float4 p = __ldg(reinterpret_cast<const float4*>(
                      a.p_in + (m + a.d_in) * R + k));
                  x = make_float4(x.x + p.x, x.y + p.y, x.z + p.z, x.w + p.w);
                }
              }
              *reinterpret_cast<float4*>(a.dh + m * R + k) = x;
            } else if (k < NO) {
              if (F32 || a.dskip_f) {
                x = __ldg(reinterpret_cast<const float4*>(a.dskip_f + m * S +
                                                          k - R));
              } else {
                float w[4];
                load4(a.dskip + m * S + k - R, w);
                x = make_float4(w[0], w[1], w[2], w[3]);
              }
            }
          }
          v[u] = x;
        }
        fill(v, wo_img + static_cast<long>(c) * 2 * R * KC, R * KC * 8);
      }
      // every consumer has stored the tile's dfg
      named_sync(3, 384);
      for (int p = 0; p < NP; ++p)
        for (int c = 0; c < NF; ++c) {
          float4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = pl + 128 * u;
            const long m = m0 + 8 * (i >> 5) + (i & 7);
            v[u] = m < m_total ? *reinterpret_cast<const float4*>(
                                     a.dfg + m * 2 * R + KC * c +
                                     4 * ((i >> 3) & 3))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          fill(v, wf_img + static_cast<long>(p * NF + c) * 2 * R * KC,
               R * KC * 8);
        }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int w = tid >> 7, lt = tid & 127;
    const int lane = lt & 31, g = lane >> 2, q = lane & 3;
    const int rt = 64 * w + 16 * (lt >> 5) + g;
    const bool ctx_sum = a.dctx != nullptr && !a.top;
    float t[R / 2];
    // a stage's product of n = R (its B image's rows) into run
    auto step = [&](float* run, bool first) {
      mbar_wait(full + pos.stage, pos.phase);
      const uint32_t sa = smem_u32(smem + pos.stage * Sh::kStage);
      const uint32_t wb = sa + 2 * Sh::kA;
      wg_split_chunk<R, 2>(t, wg_desc(sa + w * 8 * SBO, SBO),
                           wg_desc(sa + Sh::kA + w * 8 * SBO, SBO),
                           wg_desc(wb, SBO), wg_desc(wb + R * KC * 4, SBO),
                           true);
      wg_chunk_add<R>(run, t, first);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + pos.stage);
      pos.next(ST);
    };
    for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long m0 = tile * ROWS;
      const long mrow[2] = {m0 + rt, m0 + rt + 8};
      {
        // dgated, then gated and dfg from the taps at the same places
        float run[R / 2];
        for (int c = 0; c < N1; ++c) step(run, c == 0);
#pragma unroll
        for (int jb = 0; jb < R / 8; ++jb) {
          const int c = 8 * jb + 2 * q;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long m = mrow[e];
            if (m >= m_total) continue;
            float tf[2], sg[2];
            if constexpr (FORM == kBwdSave) {
              const unsigned tw = __ldg(reinterpret_cast<const unsigned*>(
                  a.tfsg + m * 2 * R + c));
              const unsigned sw = __ldg(reinterpret_cast<const unsigned*>(
                  a.tfsg + m * 2 * R + R + c));
              tf[0] = __uint_as_float(tw << 16);
              tf[1] = __uint_as_float(tw & 0xffff0000u);
              sg[0] = __uint_as_float(sw << 16);
              sg[1] = __uint_as_float(sw & 0xffff0000u);
            } else {
              // kBwdRc: the taps in this launch's dfg rows, read before
              // dfg takes their places (plain loads: they are written here)
              const float2 tw =
                  F32 ? __ldg(reinterpret_cast<const float2*>(
                            a.tfsg_f + m * 2 * R + c))
                      : *reinterpret_cast<const float2*>(a.tfsg_f +
                                                         m * 2 * R + c);
              const float2 sw =
                  F32 ? __ldg(reinterpret_cast<const float2*>(
                            a.tfsg_f + m * 2 * R + R + c))
                      : *reinterpret_cast<const float2*>(a.tfsg_f +
                                                         m * 2 * R + R + c);
              tf[0] = tw.x;
              tf[1] = tw.y;
              sg[0] = sw.x;
              sg[1] = sw.y;
              *reinterpret_cast<float2*>(a.gated + m * R + c) =
                  make_float2(tf[0] * sg[0], tf[1] * sg[1]);
            }
            float df[2], dq[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const float dg = run[4 * jb + 2 * e + k];
              df[k] = dg * (sg[k] * (1.f - tf[k] * tf[k]));
              dq[k] = dg * (tf[k] * (sg[k] - sg[k] * sg[k]));
            }
            *reinterpret_cast<float2*>(a.dfg + m * 2 * R + c) =
                make_float2(df[0], df[1]);
            *reinterpret_cast<float2*>(a.dfg + m * 2 * R + R + c) =
                make_float2(dq[0], dq[1]);
          }
        }
      }
      __threadfence_block();
      named_arrive(3, 384);
      // dfg_w, a pass a part: dh, past, ctx
      for (int part = 0; part < NP; ++part) {
        float run[R / 2];
        for (int c = 0; c < NF; ++c) step(run, c == 0);
#pragma unroll
        for (int jb = 0; jb < R / 8; ++jb) {
          const int c = 8 * jb + 2 * q;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long m = mrow[e];
            if (m >= m_total) continue;
            const float x0 = run[4 * jb + 2 * e], x1 = run[4 * jb + 2 * e + 1];
            if (part == 0) {
              const float2 d = *reinterpret_cast<const float2*>(a.dh + m * R + c);
              *reinterpret_cast<float2*>(a.dhp + m * R + c) =
                  make_float2(d.x + x0, d.y + x1);
            } else if (part == 1) {
              *reinterpret_cast<float2*>(a.p_out + m * R + c) =
                  make_float2(x0, x1);
            } else {
              float2 y = make_float2(x0, x1);
              if (ctx_sum) {
                const float2 o =
                    *reinterpret_cast<const float2*>(a.dctx + m * R + c);
                y = make_float2(o.x + x0, o.y + x1);
              }
              if (!F32 && a.dctx_bf)
                *reinterpret_cast<unsigned*>(a.dctx_bf + m * R + c) =
                    pack2(y.x, y.y);
              else
                *reinterpret_cast<float2*>(a.dctx + m * R + c) = y;
            }
          }
        }
      }
    }  // tiles
  }
}

// W_fg's gradient on wgmma.  At the wide widths the bf16 backwards' W_fg
// gradient (MODE 0: A = [hsave | hsave(t-d) | ctx], bf16; MODE 7: the bf16
// replay backward's A from the rebuilt float32 h, see WgradArgs) runs
// stack_wgrad_wg_kernel<MODE, R, S, KA>: dW_fg = sum_rows A^T dfg in
// per-(batch, chunk) partial sums and the bias gradient's column sums of
// dfg, reduced by reduce_kernel in fixed order as stack_wgrad_kernel's.
// Here k is the row axis, and wgmma takes TF32 operands K-major: the
// producer warpgroup writes A^T and dfg^T into each stage, rows contiguous
// (16 rows a stage), in wgmma_tf32.cuh's images, splitting dfg and MODE 7's
// float32 A as they land; MODE 0's A is bf16, exact in TF32: its big part
// alone, two passes a k step (BWD_SPLIT_PASSES["dw_fg"]).  A block: 128
// columns of A (the consumer warpgroups' 64 each) by 128 of dfg over one
// (batch, chunk) range of rows, the ranges' blocks adjacent in launch order
// (blockIdx.x the slab pair), so that the blocks of one range read its
// rows from L2 together.  Each stage's 16 rows are summed by the tensor
// core from zero and added in float32 (wg_chunk_add at WIDE_F32_CHUNK): a
// range's thousand-odd rows summed in the tensor core's own accumulation
// drift.  The bias partials: the blocks of A's first slab, the producer's
// threads each over its rows (4 a stage), then their four row groups in
// order.  The producer's rows land by cp.async in a ring of kRaw stages of
// raw rows (A as it lies in global memory, bf16 or MODE 7's float32 h, and
// dfg), kRaw - 1 stages ahead: each producer thread copies the 4 rows by 4
// columns of each that it reads back, so it waits on its own copies alone
// (cp.async.wait_group) and a stage's loads overlap the stages before it.
// No setmaxnreg: the consumers hold a running sum and a chunk (n = 128).
// Bound at the flagship's depth at R = S = 128: 98,304 multiply-adds a row
// and layer, 3.8 ms a call counted once at TF32's 495 TF/s (MODE 0 runs two
// passes, MODE 7 three).
template <int MODE, int R>
struct WgWgrad {
  static constexpr int kRows = 128, kN = 128, kKc = 16, kThreads = 384;
  static constexpr bool kSplitA = MODE == 7;
  static constexpr size_t kA = static_cast<size_t>(kRows) * kKc * 4;
  static constexpr size_t kB = static_cast<size_t>(kN) * kKc * 4;
  static constexpr size_t kStage = (kSplitA ? 2 : 1) * kA + 2 * kB;
  static constexpr int kStages = kSplitA ? 4 : 6;
  // the raw rows' ring: kKc rows of A's slab (4 bytes an element in MODE
  // 7, 2 in MODE 0) and of dfg's, each row's 128 columns in order
  static constexpr int kRaw = 6;
  static constexpr size_t kRawA = static_cast<size_t>(kKc) * kRows *
                                  (kSplitA ? 4 : 2);
  static constexpr size_t kRawStage = kRawA + static_cast<size_t>(kKc) * kN * 4;
  static constexpr size_t kRawOff = kStages * kStage;
  static constexpr size_t kBar = kRawOff + kRaw * kRawStage;
  static constexpr size_t kSums = kBar + 2 * kStages * 8;
  static constexpr size_t kEnd = kSums + 4 * kN * 4;
  static_assert(R == kRows && (MODE == 0 || MODE == 7),
                "a slab of A is one part of [h | h(t-d) | ctx]");
};

// The copies of one row of a stage into the raw ring (its A slot ra, 4
// elements of ea bytes, and its dfg slot rb, 4 floats): the columns j0 ..
// j0 + 3 of A's part p (0 h, 1 h(t-d), 2 ctx; zero past t_hi and for the
// tap before t = d) and of dfg's columns n0 + j0 ..; t the row's time.
template <int MODE, int R>
__device__ __forceinline__ void wg_row_copy(const WgradArgs& a, void* ra,
                                            void* rb, long row, int t,
                                            int t_hi, int p, int j0, int n0,
                                            int ea) {
  const bool ok = t < t_hi, tap = ok && (p != 1 || t >= a.d);
  const long src = (p == 1 ? row - a.d : row) * R + j0;
  if (MODE == 7 && ea == 4)
    cp_async16(ra, tap ? a.hs_f + src : a.hs_f, tap);
  else if (p == 2)
    cp_async8(ra, tap ? a.ctx + src : a.ctx, tap);
  else
    cp_async8(ra, tap ? a.hs + src : a.hs, tap);
  cp_async16(rb, ok ? a.dfg + row * 2 * R + n0 + j0 : a.dfg, ok);
}

// Four values of A back from a raw slot (ea bytes an element); MODE 7
// rounds h(t-d) to bf16 on the rows t mod tile < d (part 1).
template <int MODE>
__device__ __forceinline__ float4 wg_a_back(const WgradArgs& a,
                                            const unsigned char* ra, int ea,
                                            int t, int p) {
  float v[4];
  if (MODE == 7 && ea == 4) {
    const float4 u = *reinterpret_cast<const float4*>(ra);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    load4(reinterpret_cast<const bf16_t*>(ra), v);
  }
  if (MODE == 7 && p == 1 && t % a.tile < a.d) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = bf2f(f2bf(v[j]));
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float f4_at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int MODE, int R, int S, int KA>
__global__ void __launch_bounds__(384, 1)
    stack_wgrad_wg_kernel(WgradArgs a) {
  using Sh = WgWgrad<MODE, R>;
  constexpr int KC = Sh::kKc, ST = Sh::kStages, NS = 2 * R / Sh::kN;
  constexpr bool SA = Sh::kSplitA;
  constexpr uint32_t SBO = KC * 32;
  constexpr size_t AB = (SA ? 2 : 1) * Sh::kA;   // the B images' offset
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Sh::kBar);
  uint64_t* empty = full + ST;
  float* sums = reinterpret_cast<float*>(smem + Sh::kSums);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 128);
      mbar_init(empty + s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int mi = blockIdx.x / NS, ni = blockIdx.x % NS;   // A's, dfg's slab
  const int n0 = Sh::kN * ni;
  const int g = blockIdx.y;
  const int b = g / a.chunks, ch = g % a.chunks;
  const int per = (a.rows_per_batch + a.chunks - 1) / a.chunks;
  const int t_lo = ch * per;
  const int t_hi = min(a.rows_per_batch, t_lo + per);
  const int n_st = t_hi > t_lo ? (t_hi - t_lo + KC - 1) / KC : 0;
  const long base = static_cast<long>(b) * a.rows_per_batch;
  RingPos pos;
  if (tid >= 256) {
    // the producer: thread (pw, cg) takes rows 4 pw .. + 4 of each stage
    // and columns 4 cg .. + 4 of each slab; it stores the image rows of
    // its columns in turn from cg / 2 on, so that the eight lanes of a
    // store's phase fall in distinct banks
    const int pl = tid - 256, pw = pl >> 5, cg = pl & 31, rot = cg >> 1;
    const bool bias = mi == 0;
    float bsum[4] = {0.f, 0.f, 0.f, 0.f};
    // A's bytes an element: MODE 7's float32 h (not the bf16 x of the
    // first layer, nor ctx), else bf16
    const int ea = MODE == 7 && a.hs_f && mi < 2 ? 4 : 2;
    constexpr int PD = Sh::kRaw;
    // this thread's slots of raw stage i, row u: A's, dfg's
    auto raw_a = [&](int i, int u) {
      return smem + Sh::kRawOff + i * Sh::kRawStage +
             ((4 * pw + u) * Sh::kRows + 4 * cg) * ea;
    };
    auto raw_b = [&](int i, int u) {
      return smem + Sh::kRawOff + i * Sh::kRawStage + Sh::kRawA +
             ((4 * pw + u) * Sh::kN + 4 * cg) * 4;
    };
    // stage st's rows into raw stage st mod PD: one cp.async group a
    // stage (an empty one past the last, so that the count stays even)
    auto issue = [&](int st) {
      if (st < n_st) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t_lo + KC * st + 4 * pw + u;
          wg_row_copy<MODE, R>(a, raw_a(st % PD, u), raw_b(st % PD, u),
                               base + t, t, t_hi, mi, 4 * cg, n0, ea);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int st = 0; st < PD - 1; ++st) issue(st);
    for (int st = 0; st < n_st; ++st) {
      // stage st + PD - 1 into the raw stage that stage st - 1 held
      issue(st + PD - 1);
      cp_async_wait<PD - 1>();
      float4 ca[4], cb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t_lo + KC * st + 4 * pw + u;
        ca[u] = wg_a_back<MODE>(a, raw_a(st % PD, u), ea, t, mi);
        cb[u] = *reinterpret_cast<const float4*>(raw_b(st % PD, u));
      }
      mbar_wait(empty + pos.stage, pos.phase ^ 1);
      float* sa = reinterpret_cast<float*>(smem + pos.stage * Sh::kStage);
      float* sb = reinterpret_cast<float*>(smem + pos.stage * Sh::kStage + AB);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cc = (c + rot) & 3;
        const int o = img_off(4 * cg + cc, 4 * pw, KC);
        const float4 va = make_float4(f4_at(ca[0], cc), f4_at(ca[1], cc),
                                      f4_at(ca[2], cc), f4_at(ca[3], cc));
        const float4 vb = make_float4(f4_at(cb[0], cc), f4_at(cb[1], cc),
                                      f4_at(cb[2], cc), f4_at(cb[3], cc));
        float4 big, small;
        if constexpr (SA) {
          split4(va, big, small);
          *reinterpret_cast<float4*>(sa + o) = big;
          *reinterpret_cast<float4*>(sa + Sh::kA / 4 + o) = small;
        } else {
          *reinterpret_cast<float4*>(sa + o) = va;   // bf16: exact in TF32
        }
        split4(vb, big, small);
        *reinterpret_cast<float4*>(sb + o) = big;
        *reinterpret_cast<float4*>(sb + Sh::kB / 4 + o) = small;
      }
      fence_async_smem();
      mbar_arrive(full + pos.stage);
      pos.next(ST);
      if (bias) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          bsum[0] += cb[u].x;
          bsum[1] += cb[u].y;
          bsum[2] += cb[u].z;
          bsum[3] += cb[u].w;
        }
      }
    }
    if (bias) {
      *reinterpret_cast<float4*>(sums + pw * Sh::kN + 4 * cg) =
          make_float4(bsum[0], bsum[1], bsum[2], bsum[3]);
      named_sync(1, 128);
      const float v = sums[pl] + sums[Sh::kN + pl] + sums[2 * Sh::kN + pl] +
                      sums[3 * Sh::kN + pl];
      a.part_b[static_cast<long>(g) * a.n + n0 + pl] = v;
    }
  } else {
    const int w = tid >> 7, lt = tid & 127;
    const int lane = lt & 31, gq = lane >> 2, q = lane & 3;
    float run[Sh::kN / 2], t[Sh::kN / 2];
#pragma unroll
    for (int i = 0; i < Sh::kN / 2; ++i) run[i] = 0.f;
    for (int st = 0; st < n_st; ++st) {
      mbar_wait(full + pos.stage, pos.phase);
      const uint32_t sa = smem_u32(smem + pos.stage * Sh::kStage);
      const uint32_t sb = sa + AB;
      const uint64_t ab = wg_desc(sa + w * 8 * SBO, SBO);
      if constexpr (SA)
        wg_split_chunk<Sh::kN, 2>(t, ab, wg_desc(sa + Sh::kA + w * 8 * SBO, SBO),
                                  wg_desc(sb, SBO), wg_desc(sb + Sh::kB, SBO),
                                  true);
      else
        wg_split_chunk_exact_a<Sh::kN, 2>(t, ab, wg_desc(sb, SBO),
                                          wg_desc(sb + Sh::kB, SBO), true);
      wg_chunk_add<Sh::kN>(run, t, false);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + pos.stage);
      pos.next(ST);
    }
    // this block's (128 x 128) of the (KA, 2R) partial sum of group g
    float* out = a.part + static_cast<long>(g) * KA * a.n;
    const int r0 = Sh::kRows * mi + 64 * w + 16 * (lt >> 5) + gq;
#pragma unroll
    for (int j = 0; j < Sh::kN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * q;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(out + static_cast<long>(r0 + 8 * e) * a.n +
                                   c) =
            make_float2(run[4 * j + 2 * e], run[4 * j + 2 * e + 1]);
    }
  }
}

template <int MODE, int R, int S, int KA>
int wgrad_wg_launch(WgradArgs a, int batch, float* out_w, float* out_b,
                    int bias_groups, cudaStream_t st) {
  using Sh = WgWgrad<MODE, R>;
  const void* fn =
      reinterpret_cast<const void*>(stack_wgrad_wg_kernel<MODE, R, S, KA>);
  int err = set_smem(fn, Sh::kEnd);
  if (err) return err;
  stack_wgrad_wg_kernel<MODE, R, S, KA>
      <<<dim3(KA / Sh::kRows * (2 * R / Sh::kN), batch * a.chunks),
         Sh::kThreads, Sh::kEnd, st>>>(a);
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

// Dynamic shared memory of stack_layer_f32_kernel at (R, S), or of kernel A
// at the wide widths.
template <int R, int S>
size_t f32_layer_smem() {
  if constexpr (R > kNarrowR)
    return WgF32Fwd<R, S>::kEnd;
  else
    return F32Shape<R, S>::kEnd;
}

template <int R, int S>
__global__ void __launch_bounds__(256, 1)
    stack_layer_f32_kernel(F32LayerArgs a) {
  static_assert(R <= kNarrowR, "the wide widths run kernel A");
  using Sh = F32Shape<R, S>;
  constexpr int ROWS = Sh::kRows, THREADS = Sh::kThreads;
  constexpr int LDH = Sh::kLdh, LDW = Sh::kLdw, LDO = Sh::kLdo;
  constexpr int LDG = Sh::kLdg;
  constexpr int NH = R / 16;                 // filter n tiles a warp
  constexpr int NOT = (R + S) / 8;           // out n tiles
  constexpr int NOH = (NOT + 1) / 2;         // a half's, at most
  static_assert(R % 16 == 0 && S % 8 == 0, "8-wide tiles, two halves");
  const int win = a.ctx ? 3 * R : 2 * R, per_row = win / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* hp = reinterpret_cast<float*>(smem);
  float* wf = reinterpret_cast<float*>(smem + Sh::kWf);
  float* wo = reinterpret_cast<float*>(smem + Sh::kWo);
  float* gs = reinterpret_cast<float*>(smem + Sh::kGs);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, q = tid & 3;
  const int r0 = 16 * (warp & 3), half = warp >> 2;
  const long m_total = a.m_total;
  // the weights, one row per output column (k along the row)
  for (int i = tid; i < win * 2 * R; i += THREADS)
    wf[(i % (2 * R)) * LDW + i / (2 * R)] = a.w_fg[i];
  for (int i = tid; i < R * (R + S); i += THREADS)
    wo[(i % (R + S)) * LDO + i / (R + S)] = a.w_out[i];
  const long n_tiles = (m_total + ROWS - 1) / ROWS;
  for (long tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x) {
    const long m0 = tile_i * ROWS;
    __syncthreads();   // every warp is done with the last tile's hp and gs
    for (int i = tid; i < ROWS * per_row; i += THREADS) {
      const int row = i / per_row, c4 = 4 * (i % per_row);
      const int part = c4 / R, j0 = c4 % R;
      const long m = m0 + row;
      bool ok = m < m_total;
      const float* src = a.h + m * R + j0;
      if (part == 1) {
        ok = ok && static_cast<int>(m % a.t_len) >= a.d;
        src -= static_cast<long>(a.d) * R;
      } else if (part == 2) {
        src = a.ctx + m * R + j0;
      }
      cp_async16(hp + row * LDH + c4, ok ? src : a.h, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // fg over the warp's NH filter and NH gate tiles, then the gate
    {
      float acc[2 * NH][4];
#pragma unroll
      for (int j = 0; j < 2 * NH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < win; k0 += 8) {
        Frag<4> fa;
        load_a_rows<true>(hp + r0 * LDH + k0, LDH, fa);
#pragma unroll
        for (int j = 0; j < 2 * NH; ++j) {
          const int col = (j < NH ? 0 : R) + 8 * (half * NH + j % NH);
          Frag<2> fb;
          load_b_cols(wf + col * LDW + k0, LDW, fb);
          mma_split_add<true>(acc[j], fa, fb);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + g + 8 * h;
        const long m = m0 + row;
        const float* bf = a.b_fg + (m < m_total ? m / a.t_len : 0) * 2 * R;
#pragma unroll
        for (int jj = 0; jj < NH; ++jj) {
          const int c = 8 * (half * NH + jj) + 2 * q;
          float tf[2], sg[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            tf[k] = tanhf(acc[jj][2 * h + k] + __ldg(bf + c + k));
            sg[k] = sigmoidf(acc[NH + jj][2 * h + k] + __ldg(bf + R + c + k));
          }
          *reinterpret_cast<float2*>(gs + row * LDG + c) =
              make_float2(tf[0] * sg[0], tf[1] * sg[1]);
          if (a.tfsg && m < m_total) {
            float* tp = a.tfsg + m * 2 * R + c;
            *reinterpret_cast<float2*>(tp) = make_float2(tf[0], tf[1]);
            *reinterpret_cast<float2*>(tp + R) = make_float2(sg[0], sg[1]);
          }
        }
      }
    }
    __syncthreads();

    // out + b_out over the warp's half of the R+S columns: the residual
    // (8 columns lie wholly in it or in the skip part), then the skip sum
    {
      const int j0 = half * NOH;
      const int nj = NOT - j0 < NOH ? NOT - j0 : NOH;
      float acc[NOH][4];
#pragma unroll
      for (int j = 0; j < NOH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < R; k0 += 8) {
        Frag<4> fa;
        load_a_rows<true>(gs + r0 * LDG + k0, LDG, fa);
#pragma unroll
        for (int j = 0; j < NOH; ++j) {
          if (j >= nj) break;
          Frag<2> fb;
          load_b_cols(wo + 8 * (j0 + j) * LDO + k0, LDO, fb);
          mma_split_add<true>(acc[j], fa, fb);
        }
      }
#pragma unroll
      for (int j = 0; j < NOH; ++j) {
        if (j >= nj) break;
        const int c = 8 * (j0 + j) + 2 * q;
        const float b0 = __ldg(a.b_out + c), b1 = __ldg(a.b_out + c + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + g + 8 * h;
          const long m = m0 + row;
          if (m >= m_total) continue;
          const float v0 = acc[j][2 * h] + b0, v1 = acc[j][2 * h + 1] + b1;
          if (c < R) {
            if (a.h_next) {
              const float2 o =
                  *reinterpret_cast<const float2*>(hp + row * LDH + c);
              *reinterpret_cast<float2*>(a.h_next + m * R + c) =
                  make_float2(v0 + o.x, v1 + o.y);
            }
          } else if (a.skacc) {
            float2 sv = make_float2(v0, v1);
            float* sp = a.skacc + m * S + c - R;
            if (!a.first) {
              const float2 o = *reinterpret_cast<const float2*>(sp);
              sv = make_float2(o.x + v0, o.y + v1);
            }
            *reinterpret_cast<float2*>(a.last ? a.skip + m * S + c - R
                                              : sp) = sv;
          }
        }
      }
    }
  }  // tiles
}

// Launches of the layer kernel in one form: its shared memory set once,
// the grid (as many persistent blocks as fit, at most one per tile and at
// most max_grid) for every layer.
template <int R, int S, int FORM>
struct LayerLaunch {
  // the narrow recompute form's block; the save forms' and the wide
  // recompute form's (WideTlShape: the same 8 warps on 128-row tiles)
  static constexpr bool kTl = FORM == kRecompute && R <= kNarrowR;
  static constexpr int kThreads = kTl ? kTlThreads : SaveShape<R, S>::kThreads;
  static constexpr int kRows = kTl ? kTlRows : SaveShape<R, S>::kRows;
  size_t smem = 0;
  int grid = 0;
  int setup(long m_total, long max_grid = 0) {
    smem = FORM == kRecompute || FORM == kTaps ? tails_smem<R, S>()
                                               : save_smem<R, S>();
    const void* fn = reinterpret_cast<const void*>(
        stack_layer_kernel<R, S, FORM>);
    int err = set_smem(fn, smem);
    if (err) return err;
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long tiles = (m_total + kRows - 1) / kRows;
    long fit = static_cast<long>(per_sm < 1 ? 1 : per_sm) * sm_count();
    if (max_grid > 0 && fit > max_grid) fit = max_grid;
    grid = static_cast<int>(tiles < fit ? tiles : fit);
    return 0;
  }
  int launch(const typename FormArgs<R, FORM>::type& a,
             cudaStream_t st) const {
    stack_layer_kernel<R, S, FORM><<<grid, kThreads, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

// The layer arguments of layer l (skip sum off).
template <int R, int S>
LayerArgs layer_args(const bf16_t* h, bf16_t* h_next, const bf16_t* ctx,
                     const float* b_fg, const float* w_fg,
                     const float* w_out, const float* b_out, const int* dil,
                     int l, int batch, int t_len) {
  const int win = ctx ? 3 * R : 2 * R;
  LayerArgs a = {};
  a.h = h;
  a.h_next = h_next;
  a.ctx = ctx;
  a.b_fg = b_fg + static_cast<long>(l) * batch * 2 * R;
  a.w_fg = w_fg + static_cast<long>(l) * win * 2 * R;
  a.w_out = w_out + static_cast<long>(l) * R * (R + S);
  a.b_out = b_out + static_cast<long>(l) * (R + S);
  a.m_total = static_cast<long>(batch) * t_len;
  a.t_len = t_len;
  a.d = dil[l];
  return a;
}

// The forward's source: the embedding (pack, table2) or, in the non-embed
// forms, x; raw_gate and the head epilogue are the merged form's.
struct FwdSource {
  const int* pack;
  int pack_cols;
  const bf16_t* table2;
  int vocab;
  const bf16_t* x;       // non-null: start from x
  int raw_gate;
  HeadEpilogue hd;       // hd.tgt non-null: the head on the last layer
  float* out;            // (2) the head's loss sum and match count
  bf16_t* wt;            // the wide forms' weight scratch
                         // (movenet_stack_wt_elems), or null
};

// Every layer's bf16 weights of the wide forms into wt (stack_wt_kernel;
// res_t as there): the elements of one layer.
template <int R, int S>
long wide_weights(const float* w_fg, const float* w_out, int win,
                  int n_layers, int res_t, bf16_t* wt, cudaStream_t st) {
  const long per = WideShape<R, S>::wt_elems(win);
  stack_wt_kernel<<<grid_for(per * n_layers), kThreads, 0, st>>>(
      w_fg, w_out, n_layers, win, R, S, res_t, wt);
  return per;
}

// The save forward: hsave[0] from the embedding or x, then one launch of
// the layer kernel per layer (kSave; the merged form's last layer
// kSaveHead, at most one block per SM, and a fixed-order reduction of the
// blocks' loss and match sums).
template <int R, int S>
int fwd_impl(const FwdSource& src, const bf16_t* ctx, const float* b_fg,
             const float* w_fg, const float* w_out, const float* b_out,
             const int* dil, float* h, float* skacc, bf16_t* hsave,
             bf16_t* tfsg, bf16_t* skip, int batch, int t_len, int n_layers,
             cudaStream_t st) {
  const long m_total = static_cast<long>(batch) * t_len;
  const long mr = m_total * R;
  if (src.x)
    stack_x_kernel<<<grid_for(mr), kThreads, 0, st>>>(src.x, mr, hsave);
  else
    stack_embed_kernel<<<grid_for(mr), kThreads, 0, st>>>(
        src.pack, src.pack_cols, src.table2, src.vocab, batch, t_len, R,
        hsave);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool head = src.hd.tgt != nullptr;
  constexpr bool kWide = R > kNarrowR;
  LayerLaunch<R, S, kSave> body;
  int err = body.setup(m_total);
  if (err) return err;
  // the merged form's last layer (narrow widths only)
  LayerLaunch<R, S, kWide ? kSave : kSaveHead> top;
  long wt_layer = 0;
  if constexpr (kWide) {
    // every layer's bf16 weights in the wrapper's scratch
    if (head || !src.wt) return static_cast<int>(cudaErrorInvalidValue);
    wt_layer = wide_weights<R, S>(w_fg, w_out, ctx ? 3 * R : 2 * R,
                                  n_layers, 0, src.wt, st);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  } else if (head) {
    if (HeadSmem(S, src.hd.c).bytes() > SaveShape<R, S>::kEnd -
                                            SaveShape<R, S>::kWk)
      return static_cast<int>(cudaErrorInvalidValue);
    // part holds one row per SM
    err = top.setup(m_total, sm_count());
    if (err) return err;
  }
  for (int l = 0; l < n_layers; ++l) {
    LayerArgs a = layer_args<R, S>(
        hsave + l * mr, l + 1 < n_layers ? hsave + (l + 1) * mr : nullptr,
        ctx, b_fg, w_fg, w_out, b_out, dil, l, batch, t_len);
    a.skacc = skacc;
    a.skip = skip;
    a.first = l == 0;
    a.last = l == n_layers - 1;
    a.hf = h;
    a.tfsg = tfsg + l * m_total * 2 * R;
    a.keep_h = l + 2 < n_layers;
    a.raw_gate = src.raw_gate;
    a.wt = kWide ? src.wt + l * wt_layer : nullptr;
    if (a.last && head) {
      a.hd = src.hd;
      err = top.launch(a, st);
    } else {
      err = body.launch(a, st);
    }
    if (err) return err;
  }
  if (head) {
    reduce_kernel<<<1, kThreads, 0, st>>>(src.hd.part, src.out, 2, 1,
                                          top.grid);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// Launches of stack_layer_f32_kernel: its shared memory set once, the grid
// (as many persistent blocks as fit, at most one per tile) for every layer.
// (both forms: 8 warps on 64-row tiles)
template <int R, int S>
struct F32LayerLaunch {
  static constexpr bool kWide = R > kNarrowR;
  static constexpr int kThreads = kWide ? 384 : 256, kRows = kWide ? 128 : 64;
  size_t smem = f32_layer_smem<R, S>();
  int grid = 0;
  static const void* fn() {
    if constexpr (kWide)
      return reinterpret_cast<const void*>(stack_layer_wg_f32_kernel<R, S>);
    else
      return reinterpret_cast<const void*>(stack_layer_f32_kernel<R, S>);
  }
  int setup(long m_total) {
    const void* fn = F32LayerLaunch::fn();
    int err = set_smem(fn, smem);
    if (err) return err;
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long tiles = (m_total + kRows - 1) / kRows;
    const long fit = static_cast<long>(per_sm < 1 ? 1 : per_sm) * sm_count();
    grid = static_cast<int>(tiles < fit ? tiles : fit);
    return 0;
  }
  int launch(const F32LayerArgs& a, cudaStream_t st) const {
    if constexpr (kWide)
      stack_layer_wg_f32_kernel<R, S><<<grid, kThreads, smem, st>>>(a);
    else
      stack_layer_f32_kernel<R, S><<<grid, kThreads, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

// Every layer's weight images of the wide float32 kernels into wt
// (stack_wt_split_kernel): kernel A's, and with bwd kernel B's after them.
// Returns the floats of one layer's forward images.
template <int R, int S>
long wg_f32_weights(const float* w_fg, const float* w_out, int win,
                    int n_layers, bool bwd, float* wt, cudaStream_t st) {
  using Im = WgF32Images<R, S>;
  const long pairs =
      (Im::fwd_floats(win) + (bwd ? Im::bwd_floats(win) : 0)) / 2 * n_layers;
  stack_wt_split_kernel<R, S><<<grid_for(pairs), kThreads, 0, st>>>(
      w_fg, w_out, n_layers, win, 1, bwd ? 1 : 0, wt);
  return Im::fwd_floats(win);
}

// Every layer's backward weight images alone into img (the wide bf16
// backwards; stack_wt_split_kernel with fwd 0): kernel B's layout, layer l's
// at img + l * WgF32Images::bwd_floats(win).
template <int R, int S>
void wg_bwd_weights(const float* w_fg, const float* w_out, int win,
                    int n_layers, float* img, cudaStream_t st) {
  const long pairs = WgF32Images<R, S>::bwd_floats(win) / 2 * n_layers;
  stack_wt_split_kernel<R, S><<<grid_for(pairs), kThreads, 0, st>>>(
      w_fg, w_out, n_layers, win, 0, 1, img);
}

// The float32 layer arguments of layer l (no taps, skip sum off).
template <int R, int S>
F32LayerArgs f32_layer_args(const float* h, float* h_next, const float* ctx,
                            const float* b_fg, const float* w_fg,
                            const float* w_out, const float* b_out,
                            const int* dil, int l, int batch, int t_len) {
  const int win = ctx ? 3 * R : 2 * R;
  F32LayerArgs a = {};
  a.h = h;
  a.h_next = h_next;
  a.ctx = ctx;
  a.b_fg = b_fg + static_cast<long>(l) * batch * 2 * R;
  a.w_fg = w_fg + static_cast<long>(l) * win * 2 * R;
  a.w_out = w_out + static_cast<long>(l) * R * (R + S);
  a.b_out = b_out + static_cast<long>(l) * (R + S);
  a.m_total = static_cast<long>(batch) * t_len;
  a.t_len = t_len;
  a.d = dil[l];
  return a;
}

// The float32 save forward: hsave[0] from the embedding or, in the
// non-embed form (x non-null), a copy of x, then one launch of
// stack_layer_f32_kernel per layer.
template <int R, int S>
int fwd_f32_impl(const int* pack, int pack_cols, const float* table2,
                 int vocab, const float* x, const float* ctx,
                 const float* b_fg, const float* w_fg, const float* w_out,
                 const float* b_out, const int* dil, float* skacc,
                 float* hsave, float* tfsg, float* skip, int batch,
                 int t_len, int n_layers, cudaStream_t st) {
  const long m_total = static_cast<long>(batch) * t_len;
  const long mr = m_total * R;
  cudaError_t e;
  if (x) {
    e = cudaMemcpyAsync(hsave, x, mr * sizeof(float),
                        cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    stack_embed_f32_kernel<<<grid_for(mr), kThreads, 0, st>>>(
        pack, pack_cols, table2, vocab, batch, t_len, R, hsave);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  F32LayerLaunch<R, S> fl;
  int err = fl.setup(m_total);
  if (err) return err;
  for (int l = 0; l < n_layers; ++l) {
    F32LayerArgs a = f32_layer_args<R, S>(
        hsave + l * mr, l + 1 < n_layers ? hsave + (l + 1) * mr : nullptr,
        ctx, b_fg, w_fg, w_out, b_out, dil, l, batch, t_len);
    a.tfsg = tfsg + l * m_total * 2 * R;
    a.skacc = skacc;
    a.skip = skip;
    a.first = l == 0;
    a.last = l == n_layers - 1;
    err = fl.launch(a, st);
    if (err) return err;
  }
  return 0;
}

// The recompute forward (F32: its float32 form, stack_layer_f32_kernel with
// no taps): one launch of the layer kernel per layer, the input of every
// every-th layer kept as a checkpoint.  With tfsg (float32 only) the
// layers store their taps: the float32 replay forward, whose checkpoints
// are the float32 residual stream.  The wide form (R > kNarrowR) first
// writes every layer's weights into wt (the recompute layout, in the
// compute dtype).
template <int R, int S, bool F32>
int fwd_tails_impl(const Act<F32>* x, const Act<F32>* ctx, const float* b_fg,
                   const float* w_fg, const float* w_out, const float* b_out,
                   const int* dil, int every, Act<F32>* skip, Act<F32>* ckpt,
                   Act<F32>* work, float* skacc, float* tfsg, Act<F32>* wt,
                   int batch, int t_len, int n_layers, cudaStream_t st) {
  const long mr = static_cast<long>(batch) * t_len * R;
  constexpr bool kWide = R > kNarrowR;
  std::conditional_t<F32, F32LayerLaunch<R, S>,
                     LayerLaunch<R, S, kRecompute>> tl;
  int err = tl.setup(static_cast<long>(batch) * t_len);
  if (err) return err;
  long wt_layer = 0;
  if constexpr (kWide) {
    if (!wt) return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (F32)
      wt_layer = wg_f32_weights<R, S>(w_fg, w_out, ctx ? 3 * R : 2 * R,
                                      n_layers, false, wt, st);
    else
      wt_layer = wide_weights<R, S>(w_fg, w_out, ctx ? 3 * R : 2 * R,
                                    n_layers, 1, wt, st);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the input of layer l: x, a checkpoint (l a multiple of every) or one
  // of the two work buffers
  auto input = [&](int l) -> Act<F32>* {
    if (l % every == 0) return ckpt + (l / every - 1) * mr;
    return work + (l & 1) * mr;
  };
  for (int l = 0; l < n_layers; ++l) {
    const Act<F32>* h = l == 0 ? x : input(l);
    Act<F32>* h_next = l + 1 < n_layers ? input(l + 1) : nullptr;
    auto a = [&] {
      if constexpr (F32)
        return f32_layer_args<R, S>(h, h_next, ctx, b_fg, w_fg, w_out, b_out,
                                    dil, l, batch, t_len);
      else
        return layer_args<R, S>(h, h_next, ctx, b_fg, w_fg, w_out, b_out,
                                dil, l, batch, t_len);
    }();
    a.skacc = skacc;
    a.skip = skip;
    a.first = l == 0;
    a.last = l == n_layers - 1;
    if constexpr (F32) {
      if (tfsg) a.tfsg = tfsg + static_cast<long>(l) * batch * t_len * 2 * R;
    }
    if constexpr (kWide) a.wt = wt + l * wt_layer;
    err = tl.launch(a, st);
    if (err) return err;
  }
  return 0;
}

// The bf16 replay forward: the save forward's layer launches (kSave) with
// each layer's input in the two-slot ring (x for the first layer, then
// slot l % 2, written by the layer before) in place of hsave, and the
// float32 h at the input of every every-th layer copied into ckpt.  The
// wide form (R > kNarrowR) first writes the wide save forms' bf16 weights
// into wt, as the save forward does.
template <int R, int S>
int fwd_replay_impl(const bf16_t* x, const bf16_t* ctx, const float* b_fg,
                    const float* w_fg, const float* w_out, const float* b_out,
                    const int* dil, int every, float* h, float* skacc,
                    bf16_t* ring, bf16_t* tfsg, bf16_t* skip, float* ckpt,
                    bf16_t* wt, int batch, int t_len, int n_layers,
                    cudaStream_t st) {
  const long m_total = static_cast<long>(batch) * t_len;
  const long mr = m_total * R;
  constexpr bool kWide = R > kNarrowR;
  LayerLaunch<R, S, kSave> body;
  int err = body.setup(m_total);
  if (err) return err;
  long wt_layer = 0;
  if constexpr (kWide) {
    if (!wt) return static_cast<int>(cudaErrorInvalidValue);
    wt_layer = wide_weights<R, S>(w_fg, w_out, ctx ? 3 * R : 2 * R, n_layers,
                                  0, wt, st);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  for (int l = 0; l < n_layers; ++l) {
    const bool keep = l + 1 < n_layers && (l + 1) % every == 0;
    LayerArgs a = layer_args<R, S>(
        l == 0 ? x : ring + (l & 1) * mr,
        l + 1 < n_layers ? ring + ((l + 1) & 1) * mr : nullptr, ctx, b_fg,
        w_fg, w_out, b_out, dil, l, batch, t_len);
    a.skacc = skacc;
    a.skip = skip;
    a.first = l == 0;
    a.last = l == n_layers - 1;
    a.hf = h;
    a.tfsg = tfsg + l * m_total * 2 * R;
    // the float32 h: read by the layer after next, or kept
    a.keep_h = l + 2 < n_layers || keep;
    a.wt = kWide ? wt + l * wt_layer : nullptr;
    err = body.launch(a, st);
    if (err) return err;
    if (keep) {
      const cudaError_t e = cudaMemcpyAsync(
          ckpt + ((l + 1) / every - 1) * mr, h, mr * sizeof(float),
          cudaMemcpyDeviceToDevice, st);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  return 0;
}

// The layer launches of a backward in form FORM: stack_bwd_layer_kernel or,
// at the wide widths, stack_bwd_wg_kernel (on the layer's weight images; the
// float32 recompute form there is kernel B).  Its shared memory set once,
// the grid (as many persistent blocks as fit, at most one per tile, or pair
// of tiles of a two-pipeline block) for every layer.
template <int R, int S, int FORM>
struct BwdLaunch {
  static constexpr bool kWg = R > kNarrowR;
  using Sh = BwdShape<R, S>;
  static constexpr int kThreads = kWg ? 384 : Sh::kThreads;
  size_t smem = 0;
  int grid = 0;
  static const void* fn(bool ctx) {
    if constexpr (kWg)
      return ctx ? reinterpret_cast<const void*>(
                       stack_bwd_wg_kernel<R, S, true, FORM>)
                 : reinterpret_cast<const void*>(
                       stack_bwd_wg_kernel<R, S, false, FORM>);
    else
      return reinterpret_cast<const void*>(
          stack_bwd_layer_kernel<R, S, FORM>);
  }
  int setup(long m_total, int win) {
    smem = FORM == kBwdSave  ? Sh::smem(win)
           : FORM == kBwdRc  ? Sh::smem_rc(win)
           : FORM == kBwdF32 ? Sh::smem_f32(win)
                             : Sh::smem_rcf32(win);
    const void* f = fn(win == 3 * R);
    int err = set_smem(f, smem);
    if (err) return err;
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, f, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    long units;
    if constexpr (kWg)
      units = (m_total + WgF32Bwd<R, S>::kRows - 1) / WgF32Bwd<R, S>::kRows;
    else
      units = ((m_total + Sh::kRows - 1) / Sh::kRows + Sh::kHalves - 1) /
              Sh::kHalves;
    const long fit = static_cast<long>(per_sm < 1 ? 1 : per_sm) * sm_count();
    grid = static_cast<int>(units < fit ? units : fit);
    return 0;
  }
  int launch(const BwdLayerArgs& a, const float* img, cudaStream_t st) const {
    if constexpr (kWg) {
      if (a.win == 3 * R)
        stack_bwd_wg_kernel<R, S, true, FORM><<<grid, kThreads, smem, st>>>(
            a, img);
      else
        stack_bwd_wg_kernel<R, S, false, FORM><<<grid, kThreads, smem, st>>>(
            a, img);
    } else {
      stack_bwd_layer_kernel<R, S, FORM><<<grid, kThreads, smem, st>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  }
};

// The recompute backward (F32: its float32 form: the rebuilds by
// stack_layer_f32_kernel, the layer launches in form kBwdRcF32, the weight
// gradients from float32 activations and gated, MODE 4 and 6; dskip, dx and
// dctx float32).  The wide float32 form (R > kNarrowR) runs kernel A for the
// rebuilds and, before each layer launch, a taps launch of it on the layer's
// input (the forward's fg and gate, the float32 taps into scratch), which
// kernel B, the layer launch, reads.  The wide bf16 form likewise: the wide
// recompute forward for the rebuilds and each layer's taps launch (the
// float32 taps in the dfg rows, which its layer launch overwrites place by
// place), then stack_bwd_wg_kernel's kBwdRc form on the weight images in img
// (movenet_stack_wt_bwd_elems floats), written here once a call.
template <int R, int S, bool F32>
int bwd_tails_impl(const Act<F32>* x, const Act<F32>* ckpt,
                   const Act<F32>* ctx, const float* b_fg, const float* w_fg,
                   const float* w_out, const float* b_out,
                   const Act<F32>* dskip, const int* dil, int every,
                   Act<F32>* group, float* scratch, int chunks, Act<F32>* dx,
                   Act<F32>* dctx_out, float* db_fg, float* dw_fg,
                   float* dw_out, float* db_out, Act<F32>* wt, float* img,
                   int batch, int t_len, int n_layers, cudaStream_t st) {
  const long m_total = static_cast<long>(batch) * t_len;
  const long mr = m_total * R;
  const int win = ctx ? 3 * R : 2 * R;
  constexpr bool kWide = R > kNarrowR;
  // float32 scratch: the save backward's dhp, p[2], dh, dfg, dctx, then
  // gated, (the wide float32 form: the taps,) then the partials (the
  // float32 form sums dctx in its output); the wide bf16 form's taps lie in
  // the dfg rows
  constexpr bool kTapsF32 = F32 && kWide;
  float* dhp = scratch;
  float* pbuf[2] = {dhp + mr, dhp + 2 * mr};
  float* dh = dhp + 3 * mr;
  float* dfg = dhp + 4 * mr;
  float* dctx = dhp + 6 * mr;
  float* gated = dhp + 7 * mr;
  float* taps = kTapsF32 ? dhp + 8 * mr : dfg;
  float* part = dhp + (kTapsF32 ? 10 : 8) * mr;
  std::conditional_t<F32, F32LayerLaunch<R, S>,
                     LayerLaunch<R, S, kRecompute>> tl;
  int err = tl.setup(m_total);
  if (err) return err;
  // the wide bf16 form's taps launches (set up there alone)
  LayerLaunch<R, S, kTaps> taps_l;
  if constexpr (kWide && !F32) {
    err = taps_l.setup(m_total);
    if (err) return err;
  }
  // the wide form: every layer's weights for the rebuilds and for fg
  // formed again (bf16, W_fg^T leads each layer's), or in float32 the weight
  // images of kernels A and B
  long wt_layer = 0;
  const float* bwd_img = nullptr;
  if constexpr (kWide) {
    if (!wt) return static_cast<int>(cudaErrorInvalidValue);
    if constexpr (F32) {
      wt_layer = wg_f32_weights<R, S>(w_fg, w_out, win, n_layers, true, wt,
                                      st);
      bwd_img = wt + n_layers * wt_layer;
    } else {
      if (!img) return static_cast<int>(cudaErrorInvalidValue);
      wt_layer = wide_weights<R, S>(w_fg, w_out, win, n_layers, 1, wt, st);
      wg_bwd_weights<R, S>(w_fg, w_out, win, n_layers, img, st);
      bwd_img = img;
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the weight gradients' modes: W_fg, W_out
  constexpr int MFG = F32 ? 4 : 0, MOUT = F32 ? 6 : 3;
  BwdLaunch<R, S, F32 ? kBwdRcF32 : kBwdRc> layer;
  err = layer.setup(m_total, win);
  if (err) return err;
  for (int lo = (n_layers - 1) / every * every; lo >= 0; lo -= every) {
    const int hi = lo + every < n_layers ? lo + every : n_layers;
    // the group's inputs: h_lo from x or its checkpoint, h_{lo+1} ..
    // rebuilt into the group buffers (slot i holds h_{lo+1+i}) by the
    // forward's layer kernel, skip sum off
    const Act<F32>* h_lo = lo == 0 ? x : ckpt + (lo / every - 1) * mr;
    auto input = [&](int l) -> const Act<F32>* {
      return l == lo ? h_lo : group + (l - lo - 1) * mr;
    };
    for (int l = lo; l + 1 < hi; ++l) {
      if constexpr (F32) {
        F32LayerArgs fa = f32_layer_args<R, S>(
            input(l), group + (l - lo) * mr, ctx, b_fg, w_fg, w_out, b_out,
            dil, l, batch, t_len);
        if constexpr (kWide) fa.wt = wt + l * wt_layer;
        err = tl.launch(fa, st);
      } else {
        LayerArgs la = layer_args<R, S>(input(l), group + (l - lo) * mr, ctx,
                                        b_fg, w_fg, w_out, b_out, dil, l,
                                        batch, t_len);
        la.wt = kWide ? wt + l * wt_layer : nullptr;
        err = tl.launch(la, st);
      }
      if (err) return err;
    }
    for (int l = hi - 1; l >= lo; --l) {
      const Act<F32>* hs = input(l);
      if constexpr (kWide) {
        // the layer's taps, as its forward formed them
        if constexpr (F32) {
          F32LayerArgs fa = f32_layer_args<R, S>(hs, nullptr, ctx, b_fg, w_fg,
                                                 w_out, b_out, dil, l, batch,
                                                 t_len);
          fa.tfsg = taps;
          fa.wt = wt + l * wt_layer;
          err = tl.launch(fa, st);
        } else {
          LayerArgs la = layer_args<R, S>(hs, nullptr, ctx, b_fg, w_fg, w_out,
                                          b_out, dil, l, batch, t_len);
          la.wt = wt + l * wt_layer;
          la.taps = taps;
          err = taps_l.launch(la, st);
        }
        if (err) return err;
      }
      BwdLayerArgs a = {};
      a.dhp = dhp;
      a.p_in = pbuf[(l + 1) & 1];
      a.p_out = pbuf[l & 1];
      a.dh = dh;
      a.dfg = dfg;
      if constexpr (F32) {
        a.dctx = dctx_out;
        a.dskip_f = dskip;
        a.hs_f = hs;
        a.cx_f = ctx;
        a.tfsg_f = taps;
      } else {
        a.dctx = ctx ? dctx : nullptr;
        a.dctx_bf = (ctx && l == 0) ? dctx_out : nullptr;
        a.dskip = dskip;
        a.hs = hs;
        a.cx = ctx;
        a.tfsg_f = taps;
      }
      a.w_out = w_out + static_cast<long>(l) * R * (R + S);
      a.w_fg = w_fg + static_cast<long>(l) * win * 2 * R;
      a.m_total = m_total;
      a.t_len = t_len;
      a.d_in = l + 1 < n_layers ? dil[l + 1] : 0;
      a.top = l == n_layers - 1;
      a.win = win;
      a.b_fg = b_fg + static_cast<long>(l) * batch * 2 * R;
      a.gated = gated;
      a.d = dil[l];
      err = layer.launch(
          a, kWide ? bwd_img + l * WgF32Images<R, S>::bwd_floats(win) : nullptr,
          st);
      if (err) return err;

      WgradArgs w = {};
      if constexpr (F32) {
        w.hs_f = hs;
        w.ctx_f = ctx;
        w.dskip_f = dskip;
      } else {
        w.hs = hs;
        w.ctx = ctx;
        w.dskip = dskip;
      }
      w.dfg = dfg;
      w.dh = dh;
      w.gated = gated;
      w.rows_per_batch = t_len;
      w.chunks = chunks;
      w.d = dil[l];
      w.part = part;
      w.part_b = part + static_cast<long>(batch) * chunks * win * 2 * R;
      w.n = 2 * R;
      float* dwf = dw_fg + static_cast<long>(l) * win * 2 * R;
      float* dbf = db_fg + static_cast<long>(l) * batch * 2 * R;
      err = ctx ? wgrad_launch<MFG, R, S, 3 * R>(w, batch, dwf, dbf, batch,
                                                 st)
                : wgrad_launch<MFG, R, S, 2 * R>(w, batch, dwf, dbf, batch,
                                                 st);
      if (err) return err;
      w.n = R + S;
      w.part_b = part + static_cast<long>(batch) * chunks * R * (R + S);
      err = wgrad_launch<MOUT, R, S, R>(
          w, batch, dw_out + static_cast<long>(l) * R * (R + S),
          db_out + static_cast<long>(l) * (R + S), 1, st);
      if (err) return err;
    }
  }
  stack_dx_kernel<Act<F32>><<<grid_for(mr), kThreads, 0, st>>>(
      dhp, pbuf[0], dil[0], t_len, R, mr, dx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The (R, S) pairs each kernel family is built for.  Every family takes
// the narrow widths; the bf16 save forms (embed and non-embed) also the
// wide ones (R = 128, "the wide save forms").
#define MOVENET_STACK_WIDTHS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(64, 8) X(32, 8) X(16, 8)
#define MOVENET_WIDE_WIDTHS(X) X(128, 128) X(128, 8)
#define MOVENET_SAVE_WIDTHS(X) MOVENET_STACK_WIDTHS(X) MOVENET_WIDE_WIDTHS(X)

namespace {

int fwd_dispatch(const FwdSource& src, const bf16_t* ctx, const float* b_fg,
                 const float* w_fg, const float* w_out, const float* b_out,
                 const int* dil, float* h, float* skacc, bf16_t* hsave,
                 bf16_t* tfsg, bf16_t* skip, int batch, int t_len,
                 int n_layers, int r, int s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define X(R_, S_)                                                           \
  if (r == R_ && s == S_)                                                   \
    return fwd_impl<R_, S_>(src, ctx, b_fg, w_fg, w_out, b_out, dil, h,     \
                            skacc, hsave, tfsg, skip, batch, t_len,         \
                            n_layers, st);
  MOVENET_SAVE_WIDTHS(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

int replay_fwd_dispatch(const bf16_t* x, const bf16_t* ctx,
                        const float* b_fg, const float* w_fg,
                        const float* w_out, const float* b_out,
                        const int* dil, int every, float* h, float* skacc,
                        bf16_t* ring, bf16_t* tfsg, bf16_t* skip, float* ckpt,
                        bf16_t* wt, int batch, int t_len, int n_layers, int r,
                        int s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (every < 1 || n_layers < 1) return static_cast<int>(cudaErrorInvalidValue);
#define X(R_, S_)                                                           \
  if (r == R_ && s == S_)                                                   \
    return fwd_replay_impl<R_, S_>(x, ctx, b_fg, w_fg, w_out, b_out, dil,   \
                                   every, h, skacc, ring, tfsg, skip, ckpt, \
                                   wt, batch, t_len, n_layers, st);
  MOVENET_SAVE_WIDTHS(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool F32>
int replay_inputs_dispatch(const ReplaySrc<F32>& rp, const Act<F32>* tfsg,
                           const float* w_out, float* hsave, int batch,
                           int t_len, int n_layers, int r, int s,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rp.every < 1 || n_layers < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long m_total = static_cast<long>(batch) * t_len;
#define X(R_, S_)                                                           \
  if (r == R_ && s == S_)                                                   \
    return replay_inputs_impl<R_, S_, F32>(rp, tfsg, w_out, hsave,          \
                                           n_layers, m_total, st);
  if constexpr (F32) {
    MOVENET_STACK_WIDTHS(X)
  } else {
    MOVENET_SAVE_WIDTHS(X)
  }
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool F32>
int bwd_dispatch(const BwdEnds& ends, const Act<F32>* hsave,
                 const Act<F32>* tfsg, const Act<F32>* ctx, const float* w_fg,
                 const float* w_out, const int* dil, const Act<F32>* xc,
                 const float* wup, float* scratch, int chunks,
                 Act<F32>* dctx_out, float* db_fg, float* dw_fg,
                 float* dw_out, float* db_out, float* dwup, float* dbup,
                 int batch, int t_len, int n_layers, int r, int s,
                 void* stream, const ReplaySrc<F32>* rp = nullptr,
                 float* img = nullptr) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rp && (rp->every < 1 || n_layers < 1))
    return static_cast<int>(cudaErrorInvalidValue);
#define X(R_, S_)                                                           \
  if (r == R_ && s == S_)                                                   \
    return bwd_impl<R_, S_, F32>(ends, hsave, tfsg, ctx, w_fg, w_out, dil,  \
                                 xc, wup, scratch, chunks, dctx_out, db_fg, \
                                 dw_fg, dw_out, db_out, dwup, dbup, batch,  \
                                 t_len, n_layers, rp, img, st);
  if constexpr (F32) {
    MOVENET_STACK_WIDTHS(X)
  } else {
    MOVENET_SAVE_WIDTHS(X)
  }
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool F32>
int tails_fwd_dispatch(const Act<F32>* x, const Act<F32>* ctx,
                       const float* b_fg, const float* w_fg,
                       const float* w_out, const float* b_out, const int* dil,
                       int every, Act<F32>* skip, Act<F32>* ckpt,
                       Act<F32>* work, float* skacc, Act<F32>* wt, int batch,
                       int t_len, int n_layers, int r, int s, void* stream,
                       float* tfsg = nullptr) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (every < 1 || n_layers < 1) return static_cast<int>(cudaErrorInvalidValue);
#define X(R_, S_)                                                          \
  if (r == R_ && s == S_)                                                  \
    return fwd_tails_impl<R_, S_, F32>(x, ctx, b_fg, w_fg, w_out, b_out,   \
                                       dil, every, skip, ckpt, work, skacc,\
                                       tfsg, wt, batch, t_len, n_layers,   \
                                       st);
  MOVENET_SAVE_WIDTHS(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool F32>
int tails_bwd_dispatch(const Act<F32>* x, const Act<F32>* ckpt,
                       const Act<F32>* ctx, const float* b_fg,
                       const float* w_fg, const float* w_out,
                       const float* b_out, const Act<F32>* dskip,
                       const int* dil, int every, Act<F32>* group,
                       float* scratch, int chunks, Act<F32>* dx,
                       Act<F32>* dctx, float* db_fg, float* dw_fg,
                       float* dw_out, float* db_out, Act<F32>* wt, float* img,
                       int batch, int t_len, int n_layers, int r, int s,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (every < 1 || n_layers < 1) return static_cast<int>(cudaErrorInvalidValue);
#define X(R_, S_)                                                           \
  if (r == R_ && s == S_)                                                   \
    return bwd_tails_impl<R_, S_, F32>(x, ckpt, ctx, b_fg, w_fg, w_out,     \
                                       b_out, dskip, dil, every, group,     \
                                       scratch, chunks, dx, dctx, db_fg,    \
                                       dw_fg, dw_out, db_out, wt, img,      \
                                       batch, t_len, n_layers, st);
  MOVENET_SAVE_WIDTHS(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// 1 if the kernels of `family` are built for residual width r and skip
// width s.  Families, as ops/cuda/stack_kernel.FAMILY_WIDTHS numbers them:
// 0 the bf16 save forms (embed and non-embed), 1 the float32 save forms, 2
// the bf16 recompute forms, 3 the bf16 replay forms, 4 the merged forms, 5
// the float32 recompute forms, 6 the float32 replay forms.  The bf16 save,
// recompute and replay forms and the float32 recompute forms take the wide
// widths too.
int movenet_stack_supports(int family, int r, int s) {
  if (family < 0 || family > 6) return 0;
#define X(R_, S_) \
  if (r == R_ && s == S_) return 1;
  if (family == 0 || family == 2 || family == 3 || family == 5) {
    MOVENET_SAVE_WIDTHS(X)
  } else {
    MOVENET_STACK_WIDTHS(X)
  }
#undef X
  return 0;
}

// bf16 elements of the wide forms' weight scratch (every layer's W_fg^T,
// W_out's residual columns and W_out^T's skip rows: the save and replay
// forwards' and the recompute forward's and backward's); 0 at the narrow
// widths, which take none.
long movenet_stack_wt_elems(int r, int s, int win, int n_layers) {
#define X(R_, S_) \
  if (r == R_ && s == S_) return WideShape<R_, S_>::wt_elems(win) * n_layers;
  MOVENET_WIDE_WIDTHS(X)
#undef X
  return 0;
}

// Floats of the wide float32 recompute kernels' weight images
// (stack_wt_split_kernel): kernel A's of every layer, with bwd also kernel
// B's.  0 at the narrow widths.
long movenet_stack_wt_f32_elems(int r, int s, int win, int n_layers,
                                int bwd) {
#define X(R_, S_)                                                       \
  if (r == R_ && s == S_)                                               \
    return (WgF32Images<R_, S_>::fwd_floats(win) +                      \
            (bwd ? WgF32Images<R_, S_>::bwd_floats(win) : 0)) * n_layers;
  MOVENET_WIDE_WIDTHS(X)
#undef X
  return 0;
}

// Floats of the wide bf16 backwards' weight images (kernel B's layout,
// every layer's: the save, replay and recompute backwards' img); 0 at the
// narrow widths.
long movenet_stack_wt_bwd_elems(int r, int s, int win, int n_layers) {
#define X(R_, S_) \
  if (r == R_ && s == S_) return WgF32Images<R_, S_>::bwd_floats(win) * n_layers;
  MOVENET_WIDE_WIDTHS(X)
#undef X
  return 0;
}

// Float32 scratch elements the backward needs (see bwd_impl; f32: the
// float32 form, which also keeps gated).
long movenet_stack_bwd_scratch(int batch, int t_len, int r, int s, int win,
                               int chunks, int vocab, int embed_blocks,
                               int f32) {
  const long m_total = static_cast<long>(batch) * t_len;
  long part = static_cast<long>(batch) * chunks * (win + 1) * 2 * r;
  const long p_out = static_cast<long>(batch) * chunks * (r + 1) * (r + s);
  const long p_proj = static_cast<long>(batch) * chunks * (r + 1) * 10 * r;
  const long p_tab = static_cast<long>(embed_blocks) * 2 * vocab * r;
  if (p_out > part) part = p_out;
  if (p_proj > part) part = p_proj;
  if (p_tab > part) part = p_tab;
  return (f32 ? 8 : 7) * m_total * r + part;
}

// Dynamic shared memory of the backward's launches, in bytes: the layer
// launch (kind -1; -2 its recompute form, -3 its float32 form, -4 the
// recompute form in float32), the replay backward's bf16 rebuild (kind -5)
// or the
// weight-gradient launch of mode kind (0: W_fg with W_in = win, 1: W_out,
// 2: the projection's W_up, 3: W_out from the float32 gated, 4: W_fg, 5:
// W_up and 6: W_out in the float32 form, 7: W_fg in the bf16 replay
// backward); -1 where (r, s) is not built.
long movenet_stack_bwd_smem(int r, int s, int win, int kind) {
#define X(R_, S_)                                                      \
  if (r == R_ && s == S_) {                                            \
    if (kind == -1) return static_cast<long>(BwdShape<R_, S_>::smem(win)); \
    if (kind == -2)                                                    \
      return static_cast<long>(BwdShape<R_, S_>::smem_rc(win));        \
    if (kind == -3)                                                    \
      return static_cast<long>(BwdShape<R_, S_>::smem_f32(win));       \
    if (kind == -4)                                                    \
      return static_cast<long>(BwdShape<R_, S_>::smem_rcf32(win));     \
    if (kind == -5) return static_cast<long>(RebuildShape<R_>::kEnd);  \
    if (kind == 3) return static_cast<long>(WgShape<3, R_, S_, R_>::smem()); \
    if (kind == 0)                                                     \
      return static_cast<long>(win == 3 * R_                           \
                                   ? WgShape<0, R_, S_, 3 * R_>::smem() \
                                   : WgShape<0, R_, S_, 2 * R_>::smem()); \
    if (kind == 4)                                                     \
      return static_cast<long>(win == 3 * R_                           \
                                   ? WgShape<4, R_, S_, 3 * R_>::smem() \
                                   : WgShape<4, R_, S_, 2 * R_>::smem()); \
    if (kind == 7)                                                     \
      return static_cast<long>(win == 3 * R_                           \
                                   ? WgShape<7, R_, S_, 3 * R_>::smem() \
                                   : WgShape<7, R_, S_, 2 * R_>::smem()); \
    if (kind == 1) return static_cast<long>(WgShape<1, R_, S_, R_>::smem()); \
    if (kind == 5) return static_cast<long>(WgShape<5, R_, S_, R_>::smem()); \
    if (kind == 6) return static_cast<long>(WgShape<6, R_, S_, R_>::smem()); \
    return static_cast<long>(WgShape<2, R_, S_, R_>::smem());          \
  }
  MOVENET_STACK_WIDTHS(X)
#undef X
  // the wide widths: the bf16 save, recompute and replay backwards' and
  // the float32 recompute backward's launches (every layer launch
  // stack_bwd_wg_kernel; W_fg's gradient of the bf16 forms, modes 0 and 7,
  // stack_wgrad_wg_kernel)
#define X(R_, S_)                                                      \
  if (r == R_ && s == S_) {                                            \
    if (kind == -1) return static_cast<long>(BwdShape<R_, S_>::smem(win)); \
    if (kind == -2)                                                    \
      return static_cast<long>(BwdShape<R_, S_>::smem_rc(win));        \
    if (kind == -4)                                                    \
      return static_cast<long>(BwdShape<R_, S_>::smem_rcf32(win));     \
    if (kind == -5) return static_cast<long>(RebuildShape<R_>::kEnd);  \
    if (kind == 4)                                                     \
      return static_cast<long>(win == 3 * R_                           \
                                   ? WgShape<4, R_, S_, 3 * R_>::smem() \
                                   : WgShape<4, R_, S_, 2 * R_>::smem()); \
    if (kind == 6) return static_cast<long>(WgShape<6, R_, S_, R_>::smem()); \
    if (kind == 7) return static_cast<long>(WgWgrad<7, R_>::kEnd);     \
    if (kind == 3) return static_cast<long>(WgShape<3, R_, S_, R_>::smem()); \
    if (kind == 0) return static_cast<long>(WgWgrad<0, R_>::kEnd);     \
    if (kind == 1) return static_cast<long>(WgShape<1, R_, S_, R_>::smem()); \
    if (kind == 2) return static_cast<long>(WgShape<2, R_, S_, R_>::smem()); \
    return -1;                                                         \
  }
  MOVENET_WIDE_WIDTHS(X)
#undef X
  return -1;
}

// Forward of the whole stack; returns the first cudaError_t.  dil is a
// host array; wt holds movenet_stack_wt_elems bf16 elements (null at the
// narrow widths).
int movenet_stack_fwd(const int* pack, int pack_cols, const bf16_t* table2,
                      int vocab, const bf16_t* ctx, const float* b_fg,
                      const float* w_fg, const float* w_out,
                      const float* b_out, const int* dil, float* h,
                      float* skacc, bf16_t* hsave, bf16_t* tfsg,
                      bf16_t* skip, bf16_t* wt, int batch, int t_len,
                      int n_layers, int r, int s, void* stream) {
  FwdSource src = {};
  src.pack = pack;
  src.pack_cols = pack_cols;
  src.table2 = table2;
  src.vocab = vocab;
  src.wt = wt;
  return fwd_dispatch(src, ctx, b_fg, w_fg, w_out, b_out, dil, h, skacc,
                      hsave, tfsg, skip, batch, t_len, n_layers, r, s,
                      stream);
}

// The non-embed save forward (h from x): as movenet_stack_fwd.
int movenet_stack_fwd_x(const bf16_t* x, const bf16_t* ctx,
                        const float* b_fg, const float* w_fg,
                        const float* w_out, const float* b_out,
                        const int* dil, float* h, float* skacc,
                        bf16_t* hsave, bf16_t* tfsg, bf16_t* skip,
                        bf16_t* wt, int batch, int t_len, int n_layers, int r,
                        int s, void* stream) {
  FwdSource src = {};
  src.x = x;
  src.wt = wt;
  return fwd_dispatch(src, ctx, b_fg, w_fg, w_out, b_out, dil, h, skacc,
                      hsave, tfsg, skip, batch, t_len, n_layers, r, s,
                      stream);
}

// The merged forward: the non-embed save forward with gated from the
// unrounded taps and the head + CE in the last layer's launch; out[0] the
// loss sum, out[1] the match count; part holds movenet_stack_blocks() x 2
// floats.  tgt is (T, B).
int movenet_stack_head_fwd(const bf16_t* x, const bf16_t* ctx,
                           const float* b_fg, const float* w_fg,
                           const float* w_out, const float* b_out,
                           const int* dil, const int* tgt, const float* w1,
                           const float* b1, const float* w2, const float* b2,
                           float* h, float* skacc, bf16_t* hsave,
                           bf16_t* tfsg, bf16_t* skip, float* part,
                           float* out, int batch, int t_len, int n_layers,
                           int r, int s, int c, int rf, int parity,
                           void* stream) {
  FwdSource src = {};
  src.x = x;
  src.raw_gate = 1;
  src.hd.tgt = tgt;
  src.hd.w1 = w1;
  src.hd.b1 = b1;
  src.hd.w2 = w2;
  src.hd.b2 = b2;
  src.hd.part = part;
  src.hd.batch = batch;
  src.hd.c = c;
  src.hd.rf = rf;
  src.hd.parity = parity;
  src.out = out;
  return fwd_dispatch(src, ctx, b_fg, w_fg, w_out, b_out, dil, h, skacc,
                      hsave, tfsg, skip, batch, t_len, n_layers, r, s,
                      stream);
}

// Backward of the whole stack; returns the first cudaError_t.  dil is a
// host array.  xc/wup are null unless the projection backward is folded in.
// img holds movenet_stack_wt_bwd_elems floats (null at the narrow widths).
// dskip is bf16, or dskip_f float32 (the merged head's), the other null.
// With dx null the table gradient goes to dtab (pack, vocab, embed_blocks
// as the forward's); with dx (the non-embed form) dx is stored instead,
// and pack, dtab are null, vocab and embed_blocks 0.
int movenet_stack_bwd(const bf16_t* hsave, const bf16_t* tfsg,
                      const bf16_t* ctx, const float* w_fg,
                      const float* w_out, const bf16_t* dskip,
                      const float* dskip_f, const int* pack, int pack_cols,
                      int vocab, const int* dil, const bf16_t* xc,
                      const float* wup, float* scratch, int chunks,
                      float* dtab, bf16_t* dx, bf16_t* dctx_out,
                      float* db_fg, float* dw_fg, float* dw_out,
                      float* db_out, float* dwup, float* dbup, float* img,
                      int batch, int t_len, int n_layers, int r, int s,
                      int embed_blocks, void* stream) {
  BwdEnds ends = {};
  ends.dskip = dskip;
  ends.dskip_f = dskip_f;
  ends.pack = pack;
  ends.pack_cols = pack_cols;
  ends.vocab = vocab;
  ends.embed_blocks = embed_blocks;
  ends.dtab = dtab;
  ends.dx = dx;
  return bwd_dispatch<false>(ends, hsave, tfsg, ctx, w_fg, w_out, dil, xc,
                             wup, scratch, chunks, dctx_out, db_fg, dw_fg,
                             dw_out, db_out, dwup, dbup, batch, t_len,
                             n_layers, r, s, stream, nullptr, img);
}

// The float32 save forward (the embed form): as movenet_stack_fwd with
// every activation in float32 and no h buffer (hsave holds h).
int movenet_stack_fwd_f32(const int* pack, int pack_cols,
                          const float* table2, int vocab, const float* ctx,
                          const float* b_fg, const float* w_fg,
                          const float* w_out, const float* b_out,
                          const int* dil, float* skacc, float* hsave,
                          float* tfsg, float* skip, int batch, int t_len,
                          int n_layers, int r, int s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define X(R_, S_)                                                         \
  if (r == R_ && s == S_)                                                 \
    return fwd_f32_impl<R_, S_>(pack, pack_cols, table2, vocab, nullptr,   \
                                ctx, b_fg, w_fg, w_out, b_out, dil, skacc, \
                                hsave, tfsg, skip, batch, t_len, n_layers, \
                                st);
  MOVENET_STACK_WIDTHS(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

// The float32 non-embed save forward (h from x, float32): as
// movenet_stack_fwd_f32 with x in place of the embedding.
int movenet_stack_fwd_x_f32(const float* x, const float* ctx,
                            const float* b_fg, const float* w_fg,
                            const float* w_out, const float* b_out,
                            const int* dil, float* skacc, float* hsave,
                            float* tfsg, float* skip, int batch, int t_len,
                            int n_layers, int r, int s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define X(R_, S_)                                                         \
  if (r == R_ && s == S_)                                                 \
    return fwd_f32_impl<R_, S_>(nullptr, 0, nullptr, 0, x, ctx, b_fg,     \
                                w_fg, w_out, b_out, dil, skacc, hsave,    \
                                tfsg, skip, batch, t_len, n_layers, st);
  MOVENET_STACK_WIDTHS(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

// The float32 save backward: as movenet_stack_bwd with hsave, tfsg, ctx,
// xc, dskip, dx and dctx_out in float32; scratch holds
// movenet_stack_bwd_scratch(..., f32 = 1) floats.
int movenet_stack_bwd_f32(const float* hsave, const float* tfsg,
                          const float* ctx, const float* w_fg,
                          const float* w_out, const float* dskip,
                          const int* pack, int pack_cols, int vocab,
                          const int* dil, const float* xc, const float* wup,
                          float* scratch, int chunks, float* dtab, float* dx,
                          float* dctx_out, float* db_fg, float* dw_fg,
                          float* dw_out, float* db_out, float* dwup,
                          float* dbup, int batch, int t_len, int n_layers,
                          int r, int s, int embed_blocks, void* stream) {
  BwdEnds ends = {};
  ends.dskip_f = dskip;
  ends.pack = pack;
  ends.pack_cols = pack_cols;
  ends.vocab = vocab;
  ends.embed_blocks = embed_blocks;
  ends.dtab = dtab;
  ends.dx = dx;
  return bwd_dispatch<true>(ends, hsave, tfsg, ctx, w_fg, w_out, dil, xc, wup,
                            scratch, chunks, dctx_out, db_fg, dw_fg, dw_out,
                            db_out, dwup, dbup, batch, t_len, n_layers, r, s,
                            stream);
}

// Dynamic shared memory of the layer kernel's launches in form `form`, in
// bytes (the merged form's last layer, form 2, keeps its head's weights in
// the residual's place; form 3: the float32 layer kernel,
// stack_layer_f32_kernel; form 4, kTaps, at the wide widths); -1 where (r,
// s) is not built.
long movenet_stack_layer_smem(int r, int s, int form) {
#define X(R_, S_)                                                        \
  if (r == R_ && s == S_)                                                \
    return static_cast<long>(form == kRecompute                          \
                                 ? TlShape<R_, S_>::smem()               \
                             : form == 3 ? F32Shape<R_, S_>::kEnd        \
                                         : SaveShape<R_, S_>::smem());
  MOVENET_STACK_WIDTHS(X)
#undef X
  // the wide widths: the recompute (0), save (1), float32 (3) and taps (4)
  // forms
#define X(R_, S_)                                                        \
  if (r == R_ && s == S_)                                                \
    return form == kSave        ? static_cast<long>(save_smem<R_, S_>())  \
           : form == kRecompute || form == kTaps                          \
               ? static_cast<long>(tails_smem<R_, S_>())                    \
           : form == 3 ? static_cast<long>(f32_layer_smem<R_, S_>())      \
                                : -1;
  MOVENET_WIDE_WIDTHS(X)
#undef X
  return -1;
}

// Blocks of the merged head's launches: one per SM.
int movenet_stack_blocks() { return sm_count(); }

// 1 if the merged kernels take (R, S) and C classes.
int movenet_stack_head_supports(int r, int s, int c) {
  if (!movenet_stack_supports(4, r, s) || c < 4 || c > 64 || c % 4) return 0;
  if (head_bwd_smem(s, c) > kSmemLimit) return 0;
#define X(R_, S_)                                                        \
  if (r == R_ && s == S_)                                                \
    return SaveShape<R_, S_>::smem() <= kSmemLimit &&                    \
           HeadSmem(S_, c).bytes() <=                                    \
               SaveShape<R_, S_>::kEnd - SaveShape<R_, S_>::kWk;
  MOVENET_STACK_WIDTHS(X)
#undef X
  return 0;
}

// The merged backward's head: dskip (float32, (B, T, S)) for
// movenet_stack_bwd, and grads = dw1 (S*C) | db1 (C) | dw2 (C*C) | db2
// (C); part holds `blocks` x that many floats.  tgt is (T, B).
int movenet_stack_head_bwd(const bf16_t* skip, const int* tgt,
                           const float* w1, const float* b1, const float* w2,
                           const float* b2, const float* dloss, float* dskip,
                           float* part, float* grads, int batch, int t_len,
                           int s, int c, int rf, int parity, int blocks,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  HeadBwdArgs a = {};
  a.skip = skip;
  a.tgt = tgt;
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.b2 = b2;
  a.dloss = dloss;
  a.dskip = dskip;
  a.part = part;
  a.m_total = static_cast<long>(batch) * t_len;
  const long per = (a.m_total + blocks - 1) / blocks;
  const int hr = head_core::kHeadRows;
  a.rows_per_block = (per + hr - 1) / hr * hr;
  a.batch = batch;
  a.t_len = t_len;
  a.s = s;
  a.c = c;
  a.rf = rf;
  a.parity = parity;
  const size_t smem = head_bwd_smem(s, c);
  int err = set_smem(reinterpret_cast<const void*>(stack_head_bwd_kernel),
                     smem);
  if (err) return err;
  stack_head_bwd_kernel<<<blocks, kThreads, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long n_el = static_cast<long>(s) * c + c * c + 2 * c;
  reduce_kernel<<<grid_for(n_el), kThreads, 0, st>>>(part, grads, n_el, 1,
                                                     blocks);
  return static_cast<int>(cudaGetLastError());
}

// Float32 scratch elements of the recompute backward, bf16 or float32 (f32
// 1; see bwd_tails_impl): eight (M, R) arrays (ten in the wide float32
// form, whose taps take two) and the weight-gradient partials.
long movenet_tails_bwd_scratch(int batch, int t_len, int r, int s, int win,
                               int chunks, int f32) {
  const long p_fg = static_cast<long>(batch) * chunks * (win + 1) * 2 * r;
  const long p_out = static_cast<long>(batch) * chunks * (r + 1) * (r + s);
  const long arrays = f32 && r > kNarrowR ? 10 : 8;
  return arrays * batch * t_len * r + (p_fg > p_out ? p_fg : p_out);
}

// Recompute forward: skip_sum (B,T,S) and the checkpoints ckpt (ceil(L /
// every) - 1, B, T, R), ckpt[i] the input of layer (i + 1) * every; work
// holds two (B, T, R) bf16 buffers and skacc (B*T, S) floats, wt
// movenet_stack_wt_elems bf16 elements (null at the narrow widths).
// Returns the first cudaError_t.  dil is a host array.
int movenet_stack_fwd_tails(const bf16_t* x, const bf16_t* ctx,
                            const float* b_fg, const float* w_fg,
                            const float* w_out, const float* b_out,
                            const int* dil, int every, bf16_t* skip,
                            bf16_t* ckpt, bf16_t* work, float* skacc,
                            bf16_t* wt, int batch, int t_len, int n_layers,
                            int r, int s, void* stream) {
  return tails_fwd_dispatch<false>(x, ctx, b_fg, w_fg, w_out, b_out, dil,
                                   every, skip, ckpt, work, skacc, wt, batch,
                                   t_len, n_layers, r, s, stream);
}

// The recompute forward in float32 (stack_layer_f32_kernel, no taps): as
// movenet_stack_fwd_tails with x, ctx, skip, ckpt and work in float32, and
// wt the wide form's float32 weights (movenet_stack_wt_elems floats; null
// at the narrow widths).
int movenet_stack_fwd_tails_f32(const float* x, const float* ctx,
                                const float* b_fg, const float* w_fg,
                                const float* w_out, const float* b_out,
                                const int* dil, int every, float* skip,
                                float* ckpt, float* work, float* skacc,
                                float* wt, int batch, int t_len, int n_layers,
                                int r, int s, void* stream) {
  return tails_fwd_dispatch<true>(x, ctx, b_fg, w_fg, w_out, b_out, dil,
                                  every, skip, ckpt, work, skacc, wt, batch,
                                  t_len, n_layers, r, s, stream);
}

// Recompute backward: dx, dctx (bf16, null without ctx), db_fg (L*B, 2R),
// dw_fg (L, W_in, 2R), dw_out (L, R, R+S), db_out (L, R+S) in float32,
// from x and the forward's checkpoints; group holds every - 1 (B, T, R)
// bf16 buffers, scratch movenet_tails_bwd_scratch floats, wt
// movenet_stack_wt_elems bf16 elements and img movenet_stack_wt_bwd_elems
// floats (both null at the narrow widths).
// Returns the first cudaError_t.  dil is a host array.
int movenet_stack_bwd_tails(const bf16_t* x, const bf16_t* ckpt,
                            const bf16_t* ctx, const float* b_fg,
                            const float* w_fg, const float* w_out,
                            const float* b_out, const bf16_t* dskip,
                            const int* dil, int every, bf16_t* group,
                            float* scratch, int chunks, bf16_t* dx,
                            bf16_t* dctx, float* db_fg, float* dw_fg,
                            float* dw_out, float* db_out, bf16_t* wt,
                            float* img, int batch, int t_len, int n_layers,
                            int r, int s, void* stream) {
  return tails_bwd_dispatch<false>(x, ckpt, ctx, b_fg, w_fg, w_out, b_out,
                                   dskip, dil, every, group, scratch, chunks,
                                   dx, dctx, db_fg, dw_fg, dw_out, db_out, wt,
                                   img, batch, t_len, n_layers, r, s, stream);
}

// The recompute backward in float32: as movenet_stack_bwd_tails with x,
// ckpt, ctx, dskip, group, dx and dctx in float32, scratch
// movenet_tails_bwd_scratch(..., f32 = 1) floats and wt as in
// movenet_stack_fwd_tails_f32.
int movenet_stack_bwd_tails_f32(const float* x, const float* ckpt,
                                const float* ctx, const float* b_fg,
                                const float* w_fg, const float* w_out,
                                const float* b_out, const float* dskip,
                                const int* dil, int every, float* group,
                                float* scratch, int chunks, float* dx,
                                float* dctx, float* db_fg, float* dw_fg,
                                float* dw_out, float* db_out, float* wt,
                                int batch, int t_len, int n_layers, int r,
                                int s, void* stream) {
  return tails_bwd_dispatch<true>(x, ckpt, ctx, b_fg, w_fg, w_out, b_out,
                                  dskip, dil, every, group, scratch, chunks,
                                  dx, dctx, db_fg, dw_fg, dw_out, db_out, wt,
                                  nullptr, batch, t_len, n_layers, r, s,
                                  stream);
}

// The replay forward (bf16): skip_sum (B, T, S), the taps tfsg (L, B, T,
// 2R) and the checkpoints ckpt (ceil(L / every) - 1, B, T, R) float32,
// ckpt[i] the float32 h at the input of layer (i + 1) * every; ring holds
// two (B, T, R) bf16 layer inputs, h (B*T, R) and skacc (B*T, S) floats, wt
// movenet_stack_wt_elems bf16 elements (null at the narrow widths).
// Returns the first cudaError_t.  dil is a host array.
int movenet_stack_fwd_replay(const bf16_t* x, const bf16_t* ctx,
                             const float* b_fg, const float* w_fg,
                             const float* w_out, const float* b_out,
                             const int* dil, int every, float* h,
                             float* skacc, bf16_t* ring, bf16_t* tfsg,
                             bf16_t* skip, float* ckpt, bf16_t* wt, int batch,
                             int t_len, int n_layers, int r, int s,
                             void* stream) {
  return replay_fwd_dispatch(x, ctx, b_fg, w_fg, w_out, b_out, dil, every, h,
                             skacc, ring, tfsg, skip, ckpt, wt, batch, t_len,
                             n_layers, r, s, stream);
}

// The replay forward in float32: as movenet_stack_fwd_replay with x, ctx,
// ring, tfsg and skip in float32 and no h (the ring holds it).
int movenet_stack_fwd_replay_f32(const float* x, const float* ctx,
                                 const float* b_fg, const float* w_fg,
                                 const float* w_out, const float* b_out,
                                 const int* dil, int every, float* skacc,
                                 float* ring, float* tfsg, float* skip,
                                 float* ckpt, int batch, int t_len,
                                 int n_layers, int r, int s, void* stream) {
  return tails_fwd_dispatch<true>(x, ctx, b_fg, w_fg, w_out, b_out, dil,
                                  every, skip, ckpt, ring, skacc, nullptr,
                                  batch, t_len, n_layers, r, s, stream, tfsg);
}

// The replay backward: as movenet_stack_bwd's non-embed form (dx out,
// dskip bf16; xc, wup non-null fold the projection's backward in) with
// the layer inputs rebuilt from x and the forward's checkpoints and taps
// in place of hsave; group holds every - 1 (B, T, R) float32 buffers (at
// least one), tile is the TPU kernel's time tile (W_fg's gradient, MODE
// 7), scratch holds movenet_stack_bwd_scratch(..., 0, 0, 0) floats, img
// movenet_stack_wt_bwd_elems floats (null at the narrow widths).
int movenet_stack_bwd_replay(const bf16_t* x, const float* ckpt,
                             const bf16_t* tfsg, const bf16_t* ctx,
                             const float* w_fg, const float* w_out,
                             const float* b_out, const bf16_t* dskip,
                             const int* dil, int every, float* group,
                             int tile, const bf16_t* xc, const float* wup,
                             float* scratch, int chunks, bf16_t* dx,
                             bf16_t* dctx_out, float* db_fg, float* dw_fg,
                             float* dw_out, float* db_out, float* dwup,
                             float* dbup, float* img, int batch, int t_len,
                             int n_layers, int r, int s, void* stream) {
  BwdEnds ends = {};
  ends.dskip = dskip;
  ends.dx = dx;
  if (tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  const ReplaySrc<false> rp = {x, ckpt, b_out, every, group, tile};
  return bwd_dispatch<false>(ends, nullptr, tfsg, ctx, w_fg, w_out, dil, xc,
                             wup, scratch, chunks, dctx_out, db_fg, dw_fg,
                             dw_out, db_out, dwup, dbup, batch, t_len,
                             n_layers, r, s, stream, &rp, img);
}

// The replay backward in float32: as movenet_stack_bwd_replay with x,
// tfsg, ctx, dskip, xc, dx and dctx_out in float32 (tile unused: no value
// is rounded); scratch holds movenet_stack_bwd_scratch(..., f32 = 1)
// floats.
int movenet_stack_bwd_replay_f32(const float* x, const float* ckpt,
                                 const float* tfsg, const float* ctx,
                                 const float* w_fg, const float* w_out,
                                 const float* b_out, const float* dskip,
                                 const int* dil, int every, float* group,
                                 int tile, const float* xc,
                                 const float* wup, float* scratch, int chunks,
                                 float* dx, float* dctx_out, float* db_fg,
                                 float* dw_fg, float* dw_out, float* db_out,
                                 float* dwup, float* dbup, int batch,
                                 int t_len, int n_layers, int r, int s,
                                 void* stream) {
  BwdEnds ends = {};
  ends.dskip_f = dskip;
  ends.dx = dx;
  const ReplaySrc<true> rp = {x, ckpt, b_out, every, group, tile};
  return bwd_dispatch<true>(ends, nullptr, tfsg, ctx, w_fg, w_out, dil, xc,
                            wup, scratch, chunks, dctx_out, db_fg, dw_fg,
                            dw_out, db_out, dwup, dbup, batch, t_len,
                            n_layers, r, s, stream, &rp);
}

// Every layer input (L, B, T, R) as the replay backward rebuilds it from x,
// the forward's checkpoints and taps, into hf (float32: in bf16 the
// rebuild's float32 h, layer 0 x widened): a check of the rebuild, not a
// step of the training path.
int movenet_stack_replay_inputs(const bf16_t* x, const float* ckpt,
                                const bf16_t* tfsg, const float* w_out,
                                const float* b_out, int every, float* hf,
                                int batch, int t_len, int n_layers, int r,
                                int s, void* stream) {
  const ReplaySrc<false> rp = {x, ckpt, b_out, every, nullptr, 0};
  return replay_inputs_dispatch<false>(rp, tfsg, w_out, hf, batch, t_len,
                                       n_layers, r, s, stream);
}

// The same in float32 (x and tfsg float32).
int movenet_stack_replay_inputs_f32(const float* x, const float* ckpt,
                                    const float* tfsg, const float* w_out,
                                    const float* b_out, int every,
                                    float* hsave, int batch, int t_len,
                                    int n_layers, int r, int s,
                                    void* stream) {
  const ReplaySrc<true> rp = {x, ckpt, b_out, every, nullptr, 0};
  return replay_inputs_dispatch<true>(rp, tfsg, w_out, hsave, batch, t_len,
                                      n_layers, r, s, stream);
}

}  // extern "C"
