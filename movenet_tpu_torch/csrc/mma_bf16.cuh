// bf16 tensor-core tiles (mma.sync m16n8k16, float32 sums), shared by
// stack_kernel.cu (the recompute trunk kernels) and head_loss.cu (the
// unpacked head/CE kernels).  A warp's lane is (g, q) = (lane / 4,
// lane % 4).
#pragma once

// d += a b for one 16x8 tile, k = 16, bf16 operands (fragments as the
// PTX ISA lays out mma.m16n8k16 with .bf16 operands: A lane (g, q) holds
// the pairs (g, 2q), (g + 8, 2q), (g, 2q + 8), (g + 8, 2q + 8); B the
// pairs (k = 2q, g), (2q + 8, g); the lower column or k in the low half;
// C holds (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1))
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b over one 16-wide k step, its 16 products summed by the tensor
// core from zero and added to d in float32 (round to nearest): the tensor
// core's own accumulation truncates, and over a long k loop that drifts
// from the float32 sums of the plain version.
__device__ __forceinline__ void mma_bf16_add(float* d, const unsigned* a,
                                             const unsigned* b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(t, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// Four 8x8 bf16 matrices from shared memory, each transposed: lane l
// gives the address of row l % 8 of matrix l / 8 (16 bytes, aligned), and
// receives in r[i] the elements (row 2q, column g) and (2q + 1, g) of
// matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Four 8x8 bf16 matrices to shared memory: lane l gives the address of row
// l % 8 of matrix l / 8 (16 bytes, aligned), and r[i] holds the elements
// (row g, columns 2q, 2q + 1) of matrix i, as an A fragment's registers
// hold its four 8x8 quarters.
__device__ __forceinline__ void stmatrix_x4(void* row, const unsigned* r) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};"
      :
      : "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}
