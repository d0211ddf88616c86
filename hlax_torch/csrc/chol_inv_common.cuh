// What the Cholesky kernels share: the pivot guard's constant, the error
// message entry, and the one-warp guarded Cholesky plus triangular inverse
// of one matrix whose rows sit in the lanes' registers.
//
// chol_inv_warp_rows<NP> is the body of the small kernel (NP = 20, 32,
// csrc/chol_inv_small.cu) and of the mid kernel's n <= 32 path (NP = 32,
// csrc/chol_inv_mid.cu).  Lane i holds row i of A (then L) and of L^{-1},
// identity-padded from n to the compile-time NP; every loop is unrolled and
// column j is broadcast with __shfl_sync, so no value goes through shared
// memory and no barrier is taken.  Column step j:
//   1. pivot d = A[j][j]; the degenerate-pivot guard of hlax
//      (hlax/ops/linalg_small.py:43-63): a pivot below floor =
//      1e-6 * max(diag A, 0), taken over the first n diagonal entries, is
//      replaced by floor and column j of L is pinned to sqrt(floor) * e_j;
//   2. column j of L = A[:, j] / sqrt(d) below the diagonal;
//   3. the trailing rows take the rank-1 update A -= l l^T, row j of L^{-1}
//      scales by 1/sqrt(d) and the rows below take L^{-1}[i] -= L[i][j] *
//      L^{-1}[j] (the elementary-factor inverse update of the TPU kernels).
// These are the plain version's float32 operations in its order, with its
// roundings spelled out (__fmul_rn and __fsub_rn are never fused, the pivot
// is an IEEE sqrt and division), so the result equals
// `_chol_inv_plain` (hlax_torch/ops/linalg_small.py) bit for bit in a
// library built with or without FMA contraction.  The identity padding is
// bit-neutral: a padded row's column entries are zero, so its updates
// subtract exact zeros from the real rows, and a padded pivot that falls
// below the floor only pins its own column.
#pragma once

#include <cuda_runtime.h>

#define HLAX_PIVOT_FLOOR_REL 1e-6f
#define FULL_MASK 0xffffffffu

// Message of a CUDA error code, for the Python wrapper's exception.  Each
// kernel library is built from one .cu file and carries its own copy.
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Reads row `lane` of the NP x NP tile S (row stride ld: the n x n matrix,
// of which only the lower triangle is used, identity-padded to NP) into r,
// sets x to the identity row, and factors: on return r holds row `lane` of
// L and x that of L^{-1}, both with garbage above the diagonal
// (store_lower_row masks it).  A lane >= NP reads nothing.
template <int NP>
__device__ __forceinline__ void chol_inv_warp_rows(const float* S, int ld,
                                                   int n, int lane,
                                                   float (&r)[NP],
                                                   float (&x)[NP]) {
  const bool row = NP == 32 || lane < NP;
#pragma unroll
  for (int c = 0; c < NP; ++c) {
    r[c] = row ? S[lane * ld + c] : 0.f;
    x[c] = c == lane ? 1.f : 0.f;
  }
  float dmax = lane < n ? S[lane * ld + lane] : 0.f;
#pragma unroll
  for (int o = 16; o; o >>= 1)
    dmax = fmaxf(dmax, __shfl_xor_sync(FULL_MASK, dmax, o));
  const float floor = HLAX_PIVOT_FLOOR_REL * fmaxf(dmax, 0.f);

#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const float d = __shfl_sync(FULL_MASK, r[j], j);
    const bool good = d >= floor;
    const float dc = good ? d : floor;
    const float inv = __fdiv_rn(1.f, __fsqrt_rn(dc));
    const float lij = lane > j ? (good ? __fmul_rn(r[j], inv) : 0.f)
                               : (lane == j ? __fmul_rn(dc, inv) : 0.f);
    r[j] = lij;
#pragma unroll
    for (int k = j + 1; k < NP; ++k)
      r[k] = __fsub_rn(r[k], __fmul_rn(lij, __shfl_sync(FULL_MASK, lij, k)));
    // L^{-1}: row j scales by 1/sqrt(d), the rows below subtract L[i][j]
    // times it
    const float s = lane == j ? inv : 1.f;
    const float below = lane > j ? lij : 0.f;
#pragma unroll
    for (int c = 0; c <= j; ++c) {
      x[c] = __fmul_rn(x[c], s);
      x[c] = __fsub_rn(x[c],
                       __fmul_rn(below, __shfl_sync(FULL_MASK, x[c], j)));
    }
  }
}

// Row `lane` of a lower-triangular result into S (row stride ld), exact
// zeros above the diagonal; lanes >= NP store nothing.
template <int NP>
__device__ __forceinline__ void store_lower_row(float* S, int ld, int lane,
                                                const float (&v)[NP]) {
  if (lane >= NP) return;
#pragma unroll
  for (int c = 0; c < NP; ++c) S[lane * ld + c] = c <= lane ? v[c] : 0.f;
}
