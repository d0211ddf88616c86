// chol_inv_mid: batched Cholesky L and triangular inverse L^{-1} of SPD
// float32 matrices [batch, n, n] with 24 < n <= 128, row-major in and out.
//
// Replaces the Pallas TPU kernel `_mid_kernel` (hlax/ops/linalg_small.py:
// 472-565, launched by `_chol_inv_mid_batched`).  On the training path it
// factorizes K0zz stacked with H, [64, 120, 120] float32, and the SPD
// inverse of the natural-gradient update, [32, 120, 120]: two launches a
// train step.  As in hlax, the Newton refinement of L^{-1}
// (`_refine_tri_inverse`) runs after the kernel, as two matmuls in the
// Python wrapper, and the output buffers are separate from the input.
//
// What bounds it on an H100: at [64, 120, 120] it reads 3.69 MB and writes
// 7.37 MB (3.3 us at 3.35 TB/s) against ~2n^3/3 = 1.15 MFLOP a matrix
// (1.1 us at 67 TFLOP/s float32), so the bound is memory; in practice it is
// bound by latency: n dependent column steps, each three block barriers.
// The design gives each matrix one block of 256 threads with A and L^{-1}
// resident in dynamic shared memory (2 x 57.6 KB at n = 120, 131 KB at
// n = 128, above the 48 KB default: the launch raises the limit first).  The
// grid covers the batch directly, so the TPU kernel's 128-lane batch
// packing, its identity padding to mp = ceil8(n) and its panel blocking are
// gone.  With one block a matrix only 64 (or 32) of the 132 SMs work: a
// known gap left for a later redesign, along with tensor cores.
#include "chol_inv_common.cuh"

#define MID_THREADS 256

__global__ void chol_inv_mid_kernel(const float* __restrict__ a,
                                    float* __restrict__ l,
                                    float* __restrict__ il, int n) {
  extern __shared__ float smem[];
  float* A = smem;
  float* iL = smem + n * n;
  const size_t off = (size_t)blockIdx.x * n * n;
  for (int e = threadIdx.x; e < n * n; e += MID_THREADS) {
    A[e] = a[off + e];
    iL[e] = (e / n == e % n) ? 1.f : 0.f;
  }
  __syncthreads();
  chol_inv_smem(A, iL, n, threadIdx.x, MID_THREADS, BlockSync{});
  for (int e = threadIdx.x; e < n * n; e += MID_THREADS) {
    l[off + e] = A[e];
    il[off + e] = iL[e];
  }
}

// Plain C entry for ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int chol_inv_mid_launch(const float* a, float* l, float* il,
                                   int batch, int n, void* stream) {
  const int smem = 2 * n * n * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chol_inv_mid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chol_inv_mid_kernel<<<batch, MID_THREADS, smem, (cudaStream_t)stream>>>(
      a, l, il, n);
  return (int)cudaGetLastError();
}
