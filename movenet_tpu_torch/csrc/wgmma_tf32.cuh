// Float32-accurate products on Hopper's warpgroup tensor-core instruction
// (wgmma.mma_async m64nNk8 .tf32), shared by stack_kernel.cu (the wide
// float32 recompute kernels, the wide bf16 layer backwards and W_fg's
// gradient at the wide widths) and wgmma_tf32.cu (the building block's
// probe).
//
// The split is mma_tf32.cuh's: x = big + small, big = tf32(x), small =
// tf32(x - big), each rounded as cvt.rna rounds; a product is small*big +
// big*small + big*big (small*small, about 2^-22 of it, left out).  Here the
// parts are made once, as an operand lands in shared memory (the weights
// once a call, by a kernel of their own, in global memory), never as a
// fragment is loaded: wgmma reads both parts from shared memory.
//
// Operand images.  wgmma takes TF32 operands K-major from shared memory:
// A (64 rows x 8 k) and B (N rows x 8 k), in 8 x 4 core matrices (8 rows of
// 16 bytes, 128 contiguous bytes).  An image of ROWS rows and KC k lays the
// core matrices out with no swizzle: the KC / 4 core matrices of a row
// group of 8 follow each other (128 bytes apart, the descriptor's leading
// byte offset), the row groups KC * 32 bytes apart (its stride byte
// offset).  img_off gives the float offset of element (r, k).  A k step of
// 8 is two core matrices: the descriptor of step s starts 256 s bytes on.
#pragma once

#include <stdint.h>

#include "mma_tf32.cuh"

__host__ __device__ constexpr int img_off(int r, int k, int kc) {
  return (r >> 3) * (kc * 8) + (k >> 2) * 32 + (r & 7) * 4 + (k & 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The matrix descriptor of an image at shared address addr whose row
// groups lie sbo bytes apart (no swizzle, leading byte offset 128).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}
// a descriptor moved on by bytes (a multiple of 16)
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator
// register across the asynchronous products
template <int N>
__device__ __forceinline__ void wg_hold(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (N / 2 floats a thread) = a b, or += with sd != 0: one m64nNk8 product
// of TF32 operands read from shared memory.  Lane (g, q) = (lane / 4, lane
// % 4) of warp w of the warpgroup holds, for each 8-column block j, d[4j +
// 2e + c] = (row 16 w + g + 8 e, column 8 j + 2 q + c).
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t a, uint64_t b,
                                           int sd);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float* d, uint64_t a,
                                                 uint64_t b, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(sd));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, uint64_t a,
                                                 uint64_t b, int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(sd));
}


// One chunk of a split product: KS k steps of 8 from the images'
// descriptors (A big and small, B big and small, each at its first k step),
// the three passes of each step (small*big, big*small, big*big) summed by
// the tensor core into t, from zero where zero (else onto t).  Issued and
// committed; the caller waits.
template <int N, int KS>
__device__ __forceinline__ void wg_split_chunk(float* t, uint64_t ab,
                                               uint64_t as, uint64_t bb,
                                               uint64_t bs, bool zero) {
  wg_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const uint32_t o = 256 * s;
    wgmma_tf32<N>(t, desc_add(as, o), desc_add(bb, o), zero && s == 0 ? 0 : 1);
    wgmma_tf32<N>(t, desc_add(ab, o), desc_add(bs, o), 1);
    wgmma_tf32<N>(t, desc_add(ab, o), desc_add(bb, o), 1);
  }
  wg_commit();
}

// The same where A is exact in TF32 (bf16 values): its big part alone, two
// passes a k step (big*small, big*big).
template <int N, int KS>
__device__ __forceinline__ void wg_split_chunk_exact_a(float* t, uint64_t ab,
                                                       uint64_t bb,
                                                       uint64_t bs,
                                                       bool zero) {
  wg_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const uint32_t o = 256 * s;
    wgmma_tf32<N>(t, desc_add(ab, o), desc_add(bs, o), zero && s == 0 ? 0 : 1);
    wgmma_tf32<N>(t, desc_add(ab, o), desc_add(bb, o), 1);
  }
  wg_commit();
}

// run (+)= t once the chunk's products are done: the chunk's sum added in
// float32
template <int N>
__device__ __forceinline__ void wg_chunk_add(float* run, float* t,
                                             bool first) {
  wg_wait<0>();
  wg_hold<N / 2>(t);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) run[i] = first ? t[i] : run[i] + t[i];
}

// big and small of four floats
__device__ __forceinline__ void split4(float4 v, float4& big, float4& small) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  float b[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b[i] = __uint_as_float(tf32_rna(x[i]));
    s[i] = __uint_as_float(tf32_rna(x[i] - b[i]));
  }
  big = make_float4(b[0], b[1], b[2], b[3]);
  small = make_float4(s[0], s[1], s[2], s[3]);
}

// ------------------------------------------------ barriers and bulk copies
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// an arrival that also expects bytes of bulk copies in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile(
      "mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
          smem_u32(b))
      : "memory");
}
// waits for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16) from global to shared memory, reported to b
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}
// this thread's shared-memory writes, seen by the tensor core's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// registers a thread of this warpgroup from here on (a multiple of 8; the
// block's warpgroups give up what others take)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A ring of shared-memory stages, each with a full barrier (its producer's
// arrivals and bulk bytes) and an empty one (its consumers' arrivals).
// Producer and consumers walk the same sequence of stages.
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};
