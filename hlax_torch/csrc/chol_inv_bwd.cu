// chol_inv_bwd: batched pullback of (L, L^{-1}) = chol_inv(A) for small
// float32 matrices [batch, n, n], n <= 48, row-major in and out.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` (hlax/ops/linalg_small.py:
// 328-364, launched by `_chol_bwd_tpu` through `_pallas_bwd_batched`).  From
// the saved factors L, L^{-1} and the cotangents Lb, iLb of both outputs it
// computes
//   Lb2  = Lb + tril(-L^{-T} iLb L^{-T})     (fold d(L^{-1}) into dL)
//   P    = Phi(L^T Lb2)
//   X    = L^{-T} P L^{-1}
//   Abar = Phi(X + X^T)
// where Phi keeps the lower triangle and halves the diagonal.  Abar follows
// `_bwd_reference`'s lower convention: exact zeros above the diagonal.  hlax
// launches its kernel only for T <= 18 (the TPU's scoped VMEM); this one
// takes every n the small forward kernel takes.  On the training path it is
// the backward of the per-subject B blocks, [32, 20, 20, 20] float32: one
// launch a train step.
//
// What bounds it on an H100: 4 inputs and 1 output of 640 x 1.6 KB (5.1 MB,
// about 1.5 us at 3.35 TB/s) against five n x n products, ~10 n^3 flops a
// matrix (51 MFLOP for the batch at n = 20, 0.76 us at 67 TFLOP/s float32):
// the bound is memory, and in practice latency, as for the forward kernel.  The design follows the
// forward kernel: one warp a matrix, with L, L^{-1}, Lb, iLb and one scratch
// tile in shared memory (5 x 1.6 KB at n = 20); each product is a lane-
// strided loop over output elements whose inner sum runs only where the
// triangular factors are nonzero; __syncwarp separates the products.  The
// TPU kernel's batch-on-lanes layout and its unrolled rank-1 sums are gone.
// A simple first version: no tensor cores, no asynchronous copies.
#include "chol_inv_common.cuh"

#define BWD_WARPS_PER_BLOCK 4
#define BWD_TILES 5

__global__ void chol_inv_bwd_kernel(const float* __restrict__ l,
                                    const float* __restrict__ il,
                                    const float* __restrict__ lb,
                                    const float* __restrict__ ilb,
                                    float* __restrict__ abar, int batch,
                                    int n) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * BWD_WARPS_PER_BLOCK + warp;
  if (b >= batch) return;  // whole warps leave; no block barrier follows
  const int nn = n * n;
  float* L = smem + warp * BWD_TILES * nn;
  float* iL = L + nn;
  float* Lb = iL + nn;   // Lb, then Lb2 (step 2), then X (step 5)
  float* iLb = Lb + nn;  // iLb, then P (step 3)
  float* S = iLb + nn;   // iL^T iLb (step 1), then iL^T P (step 4)
  const size_t off = (size_t)b * nn;
  for (int e = lane; e < nn; e += 32) {
    L[e] = l[off + e];
    iL[e] = il[off + e];
    Lb[e] = lb[off + e];
    iLb[e] = ilb[off + e];
  }
  __syncwarp();

  // 1. S = L^{-T} iLb: S[i][j] = sum_{k >= i} iL[k][i] iLb[k][j]
  for (int e = lane; e < nn; e += 32) {
    const int i = e / n, j = e % n;
    float s = 0.f;
    for (int k = i; k < n; ++k) s += iL[k * n + i] * iLb[k * n + j];
    S[e] = s;
  }
  __syncwarp();

  // 2. Lb2 = Lb - tril(S L^{-T}): (S L^{-T})[i][j] = sum_{k <= j} S[i][k]
  //    iL[j][k]; the upper triangle of Lb passes through
  for (int e = lane; e < nn; e += 32) {
    const int i = e / n, j = e % n;
    if (j > i) continue;
    float s = 0.f;
    for (int k = 0; k <= j; ++k) s += S[i * n + k] * iL[j * n + k];
    Lb[e] -= s;
  }
  __syncwarp();

  // 3. P = Phi(L^T Lb2) into iLb: (L^T Lb2)[i][j] = sum_{k >= i} L[k][i]
  //    Lb2[k][j], lower triangle only
  for (int e = lane; e < nn; e += 32) {
    const int i = e / n, j = e % n;
    float s = 0.f;
    if (j <= i) {
      for (int k = i; k < n; ++k) s += L[k * n + i] * Lb[k * n + j];
      if (i == j) s *= 0.5f;
    }
    iLb[e] = s;
  }
  __syncwarp();

  // 4. S = L^{-T} P: S[i][j] = sum_{k >= max(i, j)} iL[k][i] P[k][j]
  for (int e = lane; e < nn; e += 32) {
    const int i = e / n, j = e % n;
    float s = 0.f;
    for (int k = i > j ? i : j; k < n; ++k) s += iL[k * n + i] * iLb[k * n + j];
    S[e] = s;
  }
  __syncwarp();

  // 5. X = S L^{-1} into Lb: X[i][j] = sum_{k >= j} S[i][k] iL[k][j]
  for (int e = lane; e < nn; e += 32) {
    const int i = e / n, j = e % n;
    float s = 0.f;
    for (int k = j; k < n; ++k) s += S[i * n + k] * iL[k * n + j];
    Lb[e] = s;
  }
  __syncwarp();

  // 6. Abar = Phi(X + X^T): both halves below, X[i][i] on the diagonal
  //    (0.5 * (x + x) is exact), zeros above
  for (int e = lane; e < nn; e += 32) {
    const int i = e / n, j = e % n;
    float v = 0.f;
    if (i > j) v = Lb[e] + Lb[j * n + i];
    else if (i == j) v = Lb[e];
    abar[off + e] = v;
  }
}

// Plain C entry for ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int chol_inv_bwd_launch(const float* l, const float* il,
                                   const float* lb, const float* ilb,
                                   float* abar, int batch, int n,
                                   void* stream) {
  const int smem =
      BWD_WARPS_PER_BLOCK * BWD_TILES * n * n * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chol_inv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (batch + BWD_WARPS_PER_BLOCK - 1) / BWD_WARPS_PER_BLOCK;
  chol_inv_bwd_kernel<<<grid, BWD_WARPS_PER_BLOCK * 32, smem,
                        (cudaStream_t)stream>>>(l, il, lb, ilb, abar, batch,
                                                n);
  return (int)cudaGetLastError();
}
