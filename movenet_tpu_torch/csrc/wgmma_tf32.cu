// The split-TF32 wgmma building block of the wide float32 recompute kernels
// (csrc/stack_kernel.cu, "the wide float32 recompute kernels"), alone, so
// that its accuracy can be measured against float64 on the card
// (tests/test_torch_wgmma_cuda.py).  It replaces no TPU kernel: it is the
// product those kernels are built from, with the accumulation chunk as an
// argument.
//
// out (64, N) = a (64, K) b^T, b (N, K), float32 row-major: 16 k at a time
// both operands are split into big and small TF32 parts as they land in
// shared memory (wgmma_tf32.cuh's images), then each k step of 8 runs its
// three passes as m64nNk8 wgmma; every `chunk` k (a multiple of 8) the
// tensor core's sum, from zero, is added to a float32 running sum.  One
// warpgroup, one block.  swap exchanges the descriptor's two byte offsets
// (a check of their order: the products are wrong with them swapped).
#include <cuda_runtime.h>

#include "wgmma_tf32.cuh"

namespace {

constexpr int kKc = 16;

__device__ __forceinline__ uint64_t probe_desc(const void* p, int swap) {
  const uint32_t addr = smem_u32(p), sbo = kKc * 32;
  const uint32_t lbo = swap ? sbo : 128, s = swap ? 128 : sbo;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((s & 0x3FFFF) >> 4) << 32);
}

// rows x 16 k of src (row stride k) from column k0, split into the images
// big and small
__device__ __forceinline__ void stage(const float* src, int rows, int k,
                                      int k0, float* big, float* small) {
  for (int i = threadIdx.x; i < rows * 4; i += 128) {
    const int r = i / 4, kc = i % 4;
    const float4 v =
        *reinterpret_cast<const float4*>(src + static_cast<long>(r) * k +
                                         k0 + 4 * kc);
    float4 b, s;
    split4(v, b, s);
    *reinterpret_cast<float4*>(big + img_off(r, 4 * kc, kKc)) = b;
    *reinterpret_cast<float4*>(small + img_off(r, 4 * kc, kKc)) = s;
  }
}

template <int N>
__global__ void __launch_bounds__(128, 1)
    wgmma_probe_kernel(const float* a, const float* b, float* out, int k,
                       int chunk, int swap) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ab = reinterpret_cast<float*>(smem);
  float* as = ab + 64 * kKc;
  float* bb = as + 64 * kKc;
  float* bs = bb + N * kKc;
  const uint64_t dab = probe_desc(ab, swap), das = probe_desc(as, swap);
  const uint64_t dbb = probe_desc(bb, swap), dbs = probe_desc(bs, swap);
  float run[N / 2], t[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) run[i] = t[i] = 0.f;
  int acc_k = 0;
  bool first = true;
  for (int k0 = 0; k0 < k; k0 += kKc) {
    __syncthreads();
    stage(a, 64, k, k0, ab, as);
    stage(b, N, k, k0, bb, bs);
    fence_async_smem();
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kKc / 8; ++s) {
      const uint32_t o = 256 * s;
      wg_split_chunk<N, 1>(t, desc_add(dab, o), desc_add(das, o),
                           desc_add(dbb, o), desc_add(dbs, o), acc_k == 0);
      acc_k += 8;
      if (acc_k == chunk || k0 + 8 * (s + 1) == k) {
        wg_chunk_add<N>(run, t, first);
        first = false;
        acc_k = 0;
      }
    }
    wg_wait<0>();
    wg_hold<N / 2>(t);
  }
  const int lt = threadIdx.x, w = lt >> 5, g = (lt & 31) >> 2, q = lt & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float2*>(out + (16 * w + g + 8 * e) * N + 8 * j +
                                 2 * q) =
          make_float2(run[4 * j + 2 * e], run[4 * j + 2 * e + 1]);
}

template <int N>
int probe(const float* a, const float* b, float* out, int k, int chunk,
          int swap, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(2 * 64 * kKc + 2 * N * kKc) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_probe_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  wgmma_probe_kernel<N><<<1, 128, smem, st>>>(a, b, out, k, chunk, swap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out = a b^T (see above) for n in {8, 128}, k a multiple of 16, chunk
// a multiple of 8.  Returns the first cudaError_t.
int movenet_wgmma_probe(const float* a, const float* b, float* out, int k,
                        int n, int chunk, int swap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 0 || k % kKc != 0 || chunk <= 0 || chunk % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 8) return probe<8>(a, b, out, k, chunk, swap, st);
  if (n == 128) return probe<128>(a, b, out, k, chunk, swap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
