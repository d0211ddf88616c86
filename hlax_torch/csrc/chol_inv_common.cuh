// Guarded right-looking Cholesky plus triangular inverse of ONE matrix that a
// warp holds in shared memory (the small kernel).
//
// On entry A holds the SPD input (only its lower triangle is read) and iL
// the identity.  On exit A holds L (exact zeros above the diagonal) and iL
// holds L^{-1}.  Column step j:
//   1. pivot d = A[j][j]; the degenerate-pivot guard of hlax
//      (hlax/ops/linalg_small.py:43-63): a pivot below floor =
//      1e-6 * max(diag A, 0) is replaced by floor and column j of L is
//      pinned to sqrt(floor) * e_j;
//   2. column j of L = A[:, j] / sqrt(d) (below the diagonal), written in
//      place of the consumed column, and row j of iL scaled by 1/sqrt(d);
//   3. the trailing lower triangle takes the rank-1 update A -= l l^T, and
//      the rows of iL below j take iL[i] -= L[i][j] * iL[j] (the
//      elementary-factor inverse update of the TPU kernels, with row j
//      already scaled).
// Each phase is split over the warp's lanes by flat element index, so
// neighbouring lanes touch neighbouring addresses; __syncwarp separates them.
#pragma once

#include <cuda_runtime.h>

#define HLAX_PIVOT_FLOOR_REL 1e-6f

// Message of a CUDA error code, for the Python wrapper's exception.  Each
// kernel library is built from one .cu file and carries its own copy.
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

__device__ inline void chol_inv_smem(float* A, float* iL, int n, int lane) {
  float dmax = 0.f;
  for (int i = 0; i < n; ++i) dmax = fmaxf(dmax, A[i * n + i]);
  const float floor = HLAX_PIVOT_FLOOR_REL * dmax;

  for (int j = 0; j < n; ++j) {
    const float d = A[j * n + j];
    const bool good = d >= floor;
    const float dc = good ? d : floor;
    const float inv = 1.0f / sqrtf(dc);
    __syncwarp();  // every lane has read the pivot before column j is rewritten

    for (int i = lane; i < n; i += 32) {
      float v;
      if (i < j) v = 0.f;
      else if (i == j) v = dc * inv;
      else v = good ? A[i * n + j] * inv : 0.f;
      A[i * n + j] = v;
    }
    for (int c = lane; c <= j; c += 32) iL[j * n + c] *= inv;
    __syncwarp();

    const int r = n - j - 1;
    for (int e = lane; e < r * r; e += 32) {
      const int i = j + 1 + e / r, k = j + 1 + e % r;
      if (k <= i) A[i * n + k] -= A[i * n + j] * A[k * n + j];
    }
    const int w = j + 1;
    for (int e = lane; e < r * w; e += 32) {
      const int i = j + 1 + e / w, c = e % w;
      iL[i * n + c] -= A[i * n + j] * iL[j * n + c];
    }
    __syncwarp();
  }
}
