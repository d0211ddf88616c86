// chol_inv_small: batched Cholesky L and triangular inverse L^{-1} of small
// SPD float32 matrices [batch, n, n], n <= 48, row-major in and out.
//
// Replaces the Pallas TPU kernel `_kernel` (hlax/ops/linalg_small.py:112-164,
// launched by `_chol_inv_tpu`, reached through `chol_inv_small`).  On the
// training path it factorizes the per-subject B blocks, [32, 20, 20, 20]
// float32: 640 matrices of 20 x 20 once per train step.
//
// What bounds it on an H100: the data are tiny (1.02 MB in, 2.05 MB out,
// about 1 us at 3.35 TB/s) and the work is ~2n^3/3 flops a matrix, so the
// kernel is bound by latency: n dependent column steps, each a few shared-
// memory passes.  The design keeps every step inside one warp: one warp per
// matrix, A and L^{-1} in shared memory (2 x 1.6 KB at n = 20), the lanes
// splitting each step's elements, and __syncwarp as the only barrier.  The
// grid covers the batch directly (four warps a block, 160 blocks at the main
// path's shape), so the TPU kernel's batch-on-lanes packing and its identity
// padding of the batch are gone.  A simple first version: no tensor cores,
// no asynchronous copies.
#include "chol_inv_common.cuh"

#define SMALL_WARPS_PER_BLOCK 4

__global__ void chol_inv_small_kernel(const float* __restrict__ a,
                                      float* __restrict__ l,
                                      float* __restrict__ il, int batch,
                                      int n) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * SMALL_WARPS_PER_BLOCK + warp;
  if (b >= batch) return;  // whole warps leave; no block barrier follows
  float* A = smem + warp * 2 * n * n;
  float* iL = A + n * n;
  const size_t off = (size_t)b * n * n;
  for (int e = lane; e < n * n; e += 32) {
    A[e] = a[off + e];
    iL[e] = (e / n == e % n) ? 1.f : 0.f;
  }
  __syncwarp();
  chol_inv_smem(A, iL, n, lane);
  for (int e = lane; e < n * n; e += 32) {
    l[off + e] = A[e];
    il[off + e] = iL[e];
  }
}

// Plain C entry for ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int chol_inv_small_launch(const float* a, float* l, float* il,
                                     int batch, int n, void* stream) {
  const int smem = SMALL_WARPS_PER_BLOCK * 2 * n * n * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chol_inv_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (batch + SMALL_WARPS_PER_BLOCK - 1) / SMALL_WARPS_PER_BLOCK;
  chol_inv_small_kernel<<<grid, SMALL_WARPS_PER_BLOCK * 32, smem,
                          (cudaStream_t)stream>>>(a, l, il, batch, n);
  return (int)cudaGetLastError();
}
