// Float32-accurate products on the TF32 tensor cores (mma.sync m16n8k8),
// shared by stack_kernel.cu (the save backward's products, and the
// recompute backward's gradients) and gated_block.cu (every product of
// the gated-block kernels).  A warp's lane is (g, q) = (lane / 4,
// lane % 4).
#pragma once

// Products on float32 operands run on the tensor cores as mma.sync
// m16n8k8 TF32 with float32 sums, float32-accurate by a split of the
// operands in registers as fragments are loaded: x = big + small, big =
// tf32(x) and small = tf32(x - big), each rounded to nearest with ties
// away from zero as cvt.rna rounds; a product is small*big + big*small +
// big*big (the small*small term, about 2^-22 of it, is left out).  An
// operand exact in TF32 takes no split: bf16 values (8 significant bits
// of TF32's 11) and a product of two of them (the save backward's gated =
// tf*sg, at most 16 bits: big and small are both exact).  Three passes
// where both operands are float32, two where one is exact.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b for one 16x8 tile, k = 8 (fragments as the PTX ISA lays out
// mma.m16n8k8 with .tf32 operands)
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int N>
struct Frag {
  unsigned big[N], small[N];
};

template <bool SPLIT, int N>
__device__ __forceinline__ void frag_set(Frag<N>& f, const float* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (SPLIT) {
      f.big[i] = tf32_rna(v[i]);
      f.small[i] = tf32_rna(v[i] - __uint_as_float(f.big[i]));
    } else {
      f.big[i] = __float_as_uint(v[i]);   // exact in TF32
    }
  }
}

// The A fragment (16 x 8) at p: element (row i, k) at p[i * ld + k]
// (row-major) or at p[k * ld + i] (k-major).  Lane (g, q) = (lane / 4,
// lane % 4) holds (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4).
template <bool SPLIT>
__device__ __forceinline__ void load_a_rows(const float* p, int ld,
                                            Frag<4>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float v[4] = {p[g * ld + q], p[(g + 8) * ld + q], p[g * ld + q + 4],
                      p[(g + 8) * ld + q + 4]};
  frag_set<SPLIT>(f, v);
}
template <bool SPLIT>
__device__ __forceinline__ void load_a_kmajor(const float* p, int ld,
                                              Frag<4>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float v[4] = {p[q * ld + g], p[q * ld + g + 8], p[(q + 4) * ld + g],
                      p[(q + 4) * ld + g + 8]};
  frag_set<SPLIT>(f, v);
}
// The B fragment (8 x 8) at p: element (k, column j) at p[j * ld + k]
// (a weight row per column) or at p[k * ld + j] (k-major).  Lane (g, q)
// holds (q, g) and (q + 4, g).
__device__ __forceinline__ void load_b_cols(const float* p, int ld,
                                            Frag<2>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float v[2] = {p[g * ld + q], p[g * ld + q + 4]};
  frag_set<true>(f, v);
}
__device__ __forceinline__ void load_b_kmajor(const float* p, int ld,
                                              Frag<2>& f) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float v[2] = {p[q * ld + g], p[(q + 4) * ld + g]};
  frag_set<true>(f, v);
}

// d += a b in float32 accuracy: the passes that the splits need, the
// small terms first
template <bool SPLIT_A>
__device__ __forceinline__ void mma_split(float* d, const Frag<4>& a,
                                          const Frag<2>& b) {
  if (SPLIT_A) mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// d += a b as mma_split forms it, the passes summed from zero by the
// tensor core and added to d in float32 (round to nearest): the tensor
// core's own accumulation truncates, and over a long k loop (a sum over
// many rows) that drifts from float32 sums, as mma_bf16_add avoids for
// bf16 products.  The float32 forms of the training kernels sum so.
template <bool SPLIT_A>
__device__ __forceinline__ void mma_split_add(float* d, const Frag<4>& a,
                                              const Frag<2>& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_split<SPLIT_A>(t, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}
