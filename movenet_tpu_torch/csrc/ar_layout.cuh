// The AR sampler kernel's weight stream and shared memory, shared by the
// kernel (ar_sampler.cu) and its host code, and plain C++ so that a g++
// build can hold them against their Python twins in
// ops/cuda/ar_sampler.py (phase_shape, smem_layout) on a machine without
// nvcc.
#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#define AR_HD __host__ __device__ __forceinline__
#else
#define AR_HD inline
#endif

namespace ar_layout {

constexpr int kConsumers = 256;                  // 8 consumer warps
constexpr int kWarps = kConsumers / 32;
constexpr int kRingThreads = kConsumers + 32;    // + one producer warp
constexpr int kMaxStages = 32;
constexpr int kSmemLimit = 232448;               // bytes a block can have

// Kinds of the phases that read the weight stream (phase_dots in the
// wrapper): A, C exact; F0, M, ML (the last layer's M), M2 fast; H1, H2
// the head; P the video context's fg bias of every layer.
enum PhaseKind { kA, kC, kH1, kH2, kF0, kM, kML, kM2, kP, kKinds };

// One phase of the stream: n dots, slabs of ks rows, kv virtual rows (the
// longest thread's), ncols = min(n, 256) columns; a slab is 4 ks ncols
// bytes and the phase kv / ks slabs.
struct PhaseShape {
  int n, ks, kv, ncols;
};

AR_HD int round4(int x) { return (x + 3) & ~3; }

// dots of a phase of kind `kind`
AR_HD int phase_dots(int kind, int R, int S, int C, int L) {
  switch (kind) {
    case kA: return 4 * R;
    case kH1: case kH2: return C;
    case kF0: case kM2: return 2 * R;
    case kM: return 4 * R + R + S;
    case kP: return L * 2 * R;
    default: return R + S;   // kC, kML
  }
}

// Rows of one segment of every dot of a phase.  A dot is one or two
// segments (dot_segs), each over one operand vector; in the stream each
// segment is padded to a multiple of 4 rows (round4), so that every
// operand starts 16-byte aligned, and the consumer skips the padding.
AR_HD int seg_rows(int kind, int R, int S, int C) {
  return kind == kH1 ? S : kind == kH2 ? C : R;
}

// segments of dot i: M's next [h | tap] product and M2's [h | h_next]
// read two vectors of R rows, every other dot one
AR_HD int dot_segs(int kind, int i, int R) {
  return kind == kM2 || (kind == kM && i >= 2 * R && i < 4 * R) ? 2 : 1;
}

// n, kv and ncols of a phase whose slabs have ks rows; false when ks is
// not a multiple of 4 dividing the phase's padded segment, so that no
// slab spans two segments
inline bool phase_shape(int kind, int ks, int R, int S, int C, int L,
                        PhaseShape* out) {
  const int n = phase_dots(kind, R, S, C, L);
  const int segp = round4(seg_rows(kind, R, S, C));
  if (ks <= 0 || ks % 4 != 0 || segp % ks != 0) return false;
  const int ncols = n < kConsumers ? n : kConsumers;
  int kv = 0;
  for (int c = 0; c < ncols; ++c) {
    int rows = 0;
    for (int i = c; i < n; i += kConsumers) rows += dot_segs(kind, i, R) * segp;
    kv = rows > kv ? rows : kv;
  }
  *out = PhaseShape{n, ks, kv, ncols};
  return true;
}

// Offsets (floats) of one chain's buffers, each a multiple of 4 so that
// every dot operand starts 16-byte aligned: x = [h | tap] (the tap at
// round4(R)), h_next, part0, part1, gated, skip, act, scores; `size` the
// chain's floats.
struct ChainOffsets {
  int x, hn, p0, p1, g, sk, act, sc, size;
};

AR_HD ChainOffsets chain_offsets(int C, int R, int S) {
  const int r4 = round4(R), r24 = round4(2 * R);
  ChainOffsets o;
  o.x = 0;
  o.hn = 2 * r4;
  o.p0 = o.hn + r4;
  o.p1 = o.p0 + r24;
  o.g = o.p1 + r24;
  o.sk = o.g + r4;
  o.act = o.sk + round4(S);
  o.sc = o.act + round4(C);
  o.size = o.sc + round4(C);
  return o;
}

// Bytes of shared memory beside the ring and its barriers, in the
// kernel's order: nch chains' buffers; with video the ctx row (round4(R))
// and the step's fg bias of every layer (L, 2R); the deferred writes of
// the speculative chains ((nch - 1) L R); the biases b_fg (L, 2R), b_out
// (L, R+S), h1_b, h2_b (C each); the reductions; t2 (C); the guesses and
// the end flag (4); the dilations and offsets (2L); the phase sequence
// (3L + 4).
inline size_t ring_fixed_bytes(int nch, bool has_ctx, int C, int R, int S,
                               int L) {
  const size_t floats =
      static_cast<size_t>(nch) * chain_offsets(C, R, S).size
      + (has_ctx ? static_cast<size_t>(round4(R)) + static_cast<size_t>(L) * 2 * R
                 : 0)
      + static_cast<size_t>(nch - 1) * L * R
      + static_cast<size_t>(L) * (2 * R + R + S) + 2 * static_cast<size_t>(C)
      + kWarps;
  const size_t ints = kWarps + static_cast<size_t>(C) + 4 + 2 * L + 3 * L + 4;
  return 4 * floats + 4 * ints;
}

}  // namespace ar_layout
