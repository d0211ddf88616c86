// What the Cholesky kernels share: the pivot guard's constant, the
// IEEE-rounded scalar operations in float and double, the cp.async copies
// of the backward kernels, the error message entry, and the one-warp
// guarded Cholesky plus triangular inverse of one matrix whose rows sit in
// the lanes' registers.
//
// chol_inv_warp_rows<Real, NP> is the body of the small kernel (NP = 20, 32,
// csrc/chol_inv_small.cu) and of the mid kernel's n <= 32 path (NP = 32,
// csrc/chol_inv_mid.cu), in float and in double.  Lane i holds row i of A
// (then L) and of L^{-1}, identity-padded from n to the compile-time NP;
// every loop is unrolled and column j is broadcast with __shfl_sync (a
// double as two 32-bit halves), so no value goes through shared memory and
// no barrier is taken.  Column step j:
//   1. pivot d = A[j][j]; the degenerate-pivot guard of hlax
//      (hlax/ops/linalg_small.py:43-63): a pivot below floor =
//      pivot_floor_rel * max(diag A, 0), taken over the first n diagonal
//      entries, is replaced by floor and column j of L is pinned to
//      sqrt(floor) * e_j;
//   2. column j of L = A[:, j] / sqrt(d) below the diagonal;
//   3. the trailing rows take the rank-1 update A -= l l^T, row j of L^{-1}
//      scales by 1/sqrt(d) and the rows below take L^{-1}[i] -= L[i][j] *
//      L^{-1}[j] (the elementary-factor inverse update of the TPU kernels).
// These are the plain version's operations in its order, with its roundings
// spelled out (mul_rn and sub_rn are never fused, the pivot is an IEEE sqrt
// and division), so the result equals `_chol_inv_plain`
// (hlax_torch/ops/linalg_small.py) bit for bit, in either dtype, in a
// library built with or without FMA contraction.  The identity padding is
// bit-neutral: a padded row's column entries are zero, so its updates
// subtract exact zeros from the real rows, and a padded pivot that falls
// below the floor only pins its own column.
#pragma once

#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu

// The guard's floor relative to max(diag A), PIVOT_FLOOR_REL of
// hlax_torch/ops/linalg_small.py (the plain version multiplies by the float32
// or float64 nearest to it): hlax's 1e-6 in float32; in float64, which hlax
// factorizes unguarded, 2e-15, about the multiple of machine epsilon that
// 1e-6 is of float32's, below every pivot of an SPD matrix with a jitter of
// 1e-6.
__device__ __forceinline__ float pivot_floor_rel(float) { return 1e-6f; }
__device__ __forceinline__ double pivot_floor_rel(double) { return 2e-15; }

// Lets `kernel` take `smem` bytes of dynamic shared memory.  `allowed` is
// the limit this instantiation has (48 KB, the default, until raised):
// cudaFuncSetAttribute runs only when a launch needs more than that, so a
// launch that a CUDA graph captures after the same launch ran once makes no
// attribute call.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int smem, int& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// round-to-nearest operations that FMA contraction leaves alone
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) {
  return fmax(a, b);
}

// The kernel's dynamic shared memory, typed (one array a type: two extern
// arrays of one name and two types do not link).
template <typename Real>
__device__ __forceinline__ Real* dynamic_smem();
template <>
__device__ __forceinline__ float* dynamic_smem<float>() {
  extern __shared__ __align__(16) float smem_f[];
  return smem_f;
}
template <>
__device__ __forceinline__ double* dynamic_smem<double>() {
  extern __shared__ __align__(16) double smem_d[];
  return smem_d;
}

// 16 bytes of values at p (16-byte aligned, in shared or device memory): a
// float4, or a double2.  Typed: the same copies through a union of uint4
// and values measured slower in the backward kernel (PERF.md).
__device__ __forceinline__ void ld16(const float* p, float* u) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  u[0] = v.x, u[1] = v.y, u[2] = v.z, u[3] = v.w;
}
__device__ __forceinline__ void ld16(const double* p, double* u) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  u[0] = v.x, u[1] = v.y;
}
__device__ __forceinline__ void st16(float* p, const float* u) {
  *reinterpret_cast<float4*>(p) = make_float4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ void st16(double* p, const double* u) {
  *reinterpret_cast<double2*>(p) = make_double2(u[0], u[1]);
}

// 4 values at p (16-byte aligned): one 16-byte copy of floats, two of
// doubles
template <typename Real>
__device__ __forceinline__ void ld4(const Real* p, Real (&u)[4]) {
#pragma unroll
  for (int h = 0; h < 4; h += 16 / sizeof(Real)) ld16(p + h, u + h);
}
template <typename Real>
__device__ __forceinline__ void st4(Real* p, const Real (&u)[4]) {
#pragma unroll
  for (int h = 0; h < 4; h += 16 / sizeof(Real)) st16(p + h, u + h);
}

// One cp.async of 16 bytes, and one of a single value (4 or 8 bytes),
// and the wait for every copy in flight (the backward kernels' staging)
__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(g));
}
__device__ __forceinline__ void cp_async1(float* s, const float* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(g));
}
__device__ __forceinline__ void cp_async1(double* s, const double* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(a), "l"(g));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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
template <typename Real, int NP>
__device__ __forceinline__ void chol_inv_warp_rows(const Real* S, int ld,
                                                   int n, int lane,
                                                   Real (&r)[NP],
                                                   Real (&x)[NP]) {
  const bool row = NP == 32 || lane < NP;
#pragma unroll
  for (int c = 0; c < NP; ++c) {
    r[c] = row ? S[lane * ld + c] : Real(0);
    x[c] = c == lane ? Real(1) : Real(0);
  }
  Real dmax = lane < n ? S[lane * ld + lane] : Real(0);
#pragma unroll
  for (int o = 16; o; o >>= 1)
    dmax = vmax(dmax, __shfl_xor_sync(FULL_MASK, dmax, o));
  const Real floor = mul_rn(pivot_floor_rel(Real(0)), vmax(dmax, Real(0)));

#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const Real d = __shfl_sync(FULL_MASK, r[j], j);
    const bool good = d >= floor;
    const Real dc = good ? d : floor;
    const Real inv = div_rn(Real(1), sqrt_rn(dc));
    const Real lij = lane > j ? (good ? mul_rn(r[j], inv) : Real(0))
                              : (lane == j ? mul_rn(dc, inv) : Real(0));
    r[j] = lij;
#pragma unroll
    for (int k = j + 1; k < NP; ++k)
      r[k] = sub_rn(r[k], mul_rn(lij, __shfl_sync(FULL_MASK, lij, k)));
    // L^{-1}: row j scales by 1/sqrt(d), the rows below subtract L[i][j]
    // times it
    const Real s = lane == j ? inv : Real(1);
    const Real below = lane > j ? lij : Real(0);
#pragma unroll
    for (int c = 0; c <= j; ++c) {
      x[c] = mul_rn(x[c], s);
      x[c] = sub_rn(x[c], mul_rn(below, __shfl_sync(FULL_MASK, x[c], j)));
    }
  }
}

// Row `lane` of a lower-triangular result into S (row stride ld), exact
// zeros above the diagonal; lanes >= NP store nothing.
template <typename Real, int NP>
__device__ __forceinline__ void store_lower_row(Real* S, int ld, int lane,
                                                const Real (&v)[NP]) {
  if (lane >= NP) return;
#pragma unroll
  for (int c = 0; c < NP; ++c) S[lane * ld + c] = c <= lane ? v[c] : Real(0);
}
