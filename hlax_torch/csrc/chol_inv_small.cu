// chol_inv_small: batched Cholesky L and triangular inverse L^{-1} of small
// SPD float32 or float64 matrices [batch, n, n], n <= 48, row-major in and
// out.
//
// Replaces the Pallas TPU kernel `_kernel` (hlax/ops/linalg_small.py:112-164,
// launched by `_chol_inv_tpu`, reached through `chol_inv_small`).  On the
// training path it factorizes the per-subject B blocks, [32, 20, 20, 20]:
// 640 matrices of 20 x 20 once per train step, in the GP's dtype (float32,
// or float64 with --gp_dtype=float64; hlax sends float64 to XLA's library
// Cholesky, the port keeps its kernel and the guard).  Only the lower
// triangle of A is read; L and L^{-1} get exact zeros above the diagonal;
// the degenerate-pivot guard is hlax's (chol_inv_common.cuh).
//
// What bounds it on an H100: the data are tiny (1.02 MB in, 2.05 MB out in
// float32, 0.92 us at 3.35 TB/s; twice that in float64) against ~2n^3/3
// flops a matrix (0.08 us at 67 TFLOP/s float32, 0.16 us at 34 TFLOP/s
// float64), so the bound is memory; in practice the time is the latency of
// n dependent pivots a matrix.  The launch plan is worked out in Python,
// `small_launch_plan` in hlax_torch/ops/linalg_small.py, and checked here.
// Two paths:
//
// * n <= 32: one warp a matrix with row i of A and of L^{-1} in lane i's
//   registers, identity-padded to a compile-time size NP in {20, 32} (the
//   canonical n = 20 pays for exactly 20 column steps); every loop
//   is unrolled, column j goes to the lanes by __shfl_sync, and no value
//   passes through shared memory between column steps (chol_inv_warp_rows,
//   shared with the mid kernel's n <= 32 path).  Shared memory only stages
//   the load and the store: each is a flat copy of the matrix, 16 bytes at
//   a time (4 floats, 2 doubles) where n^2 is a multiple of that and the
//   pointers are 16-byte aligned (scalar otherwise), scattered into a tile
//   of odd row stride NP + 1 so a lane's row read is conflict-free.  The
//   warps a block are chosen so the batch spreads evenly over the SMs (one
//   a block at the main path's 640).
// * 32 < n <= 48 (no canonical shape): one warp a matrix with A and L^{-1}
//   in shared memory, the lanes splitting each column step's elements
//   (chol_inv_smem below): registers for two 48-value rows a lane would
//   spill.
// Both paths do the plain version's operations in its order, so they agree
// with `_chol_inv_plain` bit for bit in both dtypes (the library is built
// with --fmad=false for chol_inv_smem; the warp path spells its roundings
// out).  No tensor cores: the work is a serial chain of n dependent pivots,
// and bit-equality rules out any other summation.  No TMA or cp.async: each
// warp loads one 1.6 KB (3.2 KB) matrix once, and all 640 are resident in
// one wave.
#include <cstdint>

#include "chol_inv_common.cuh"

// ---- n <= 32: rows in registers ------------------------------------------

// e -> (row, column) of an n-wide matrix without an integer division: rn is
// 1/n in float, and (e + 0.5) rn lies at least 0.5/n from an integer, far
// beyond its rounding error for e < 48 * 48.
__device__ __forceinline__ void row_col(int e, int n, float rn, int& i,
                                        int& c) {
  i = (int)((e + 0.5f) * rn);
  c = e - i * n;
}

template <typename Real, int NP>
__global__ void __launch_bounds__(128)
chol_inv_small_warp_kernel(const Real* __restrict__ a, Real* __restrict__ l,
                           Real* __restrict__ il, int batch, int n,
                           int vec) {
  constexpr int V = 16 / sizeof(Real);         // values a 16-byte copy
  constexpr int LD = NP + 1;                   // odd: row reads conflict-free
  constexpr int QV = (NP * NP + 32 * V - 1) / (32 * V);  // 16-byte copies a
                                                         // lane, at most
  constexpr int Q1 = (NP * NP + 31) / 32;      // scalar copies a lane, at most
  Real* smem = dynamic_smem<Real>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;  // whole warps leave; no block barrier follows
  Real* S = smem + warp * 2 * NP * LD;  // A in, then L out
  Real* X = S + NP * LD;                // L^{-1} out
  const int nn = n * n;
  const size_t off = (size_t)b * nn;
  const float rn = 1.f / n;

  // A in: every load in flight, then scattered into the staging tile
  if (vec) {
    Real v[QV][V];
#pragma unroll
    for (int t = 0; t < QV; ++t)
      if (lane + 32 * t < nn / V) ld16(a + off + V * (lane + 32 * t), v[t]);
#pragma unroll
    for (int t = 0; t < QV; ++t) {
      if (lane + 32 * t >= nn / V) break;
      int i, c;
      row_col(V * (lane + 32 * t), n, rn, i, c);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        S[i * LD + c] = v[t][k];
        if (++c == n) c = 0, ++i;
      }
    }
  } else {
    Real v[Q1];
#pragma unroll
    for (int t = 0; t < Q1; ++t)
      if (lane + 32 * t < nn) v[t] = a[off + lane + 32 * t];
#pragma unroll
    for (int t = 0; t < Q1; ++t) {
      if (lane + 32 * t >= nn) break;
      int i, c;
      row_col(lane + 32 * t, n, rn, i, c);
      S[i * LD + c] = v[t];
    }
  }
  if (n < NP && lane < NP)  // identity padding, column `lane`
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (i >= n || lane >= n) S[i * LD + lane] = i == lane ? Real(1) : Real(0);
  __syncwarp();

  Real r[NP], x[NP];  // row `lane` of A (then L) and of L^{-1}
  chol_inv_warp_rows<Real, NP>(S, LD, n, lane, r, x);
  // each lane overwrites only the row it read
  store_lower_row<Real, NP>(S, LD, lane, r);
  store_lower_row<Real, NP>(X, LD, lane, x);
  __syncwarp();

  // L and L^{-1} out: the flat copies gathered from the staging tiles
  if (vec) {
#pragma unroll
    for (int t = 0; t < QV; ++t) {
      const int q = lane + 32 * t;
      if (q >= nn / V) break;
      int i, c;
      row_col(V * q, n, rn, i, c);
      Real ul[V], ux[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        ul[k] = S[i * LD + c];
        ux[k] = X[i * LD + c];
        if (++c == n) c = 0, ++i;
      }
      st16(l + off + V * q, ul);
      st16(il + off + V * q, ux);
    }
  } else {
#pragma unroll
    for (int t = 0; t < Q1; ++t) {
      const int e = lane + 32 * t;
      if (e >= nn) break;
      int i, c;
      row_col(e, n, rn, i, c);
      l[off + e] = S[i * LD + c];
      il[off + e] = X[i * LD + c];
    }
  }
}

// ---- 32 < n <= 48: one warp a matrix in shared memory ----------------------

// Guarded right-looking Cholesky plus triangular inverse of the matrix a
// warp holds in shared memory.  On entry A holds the input (only its lower
// triangle is read) and iL the identity; on exit A holds L (exact zeros
// above the diagonal) and iL holds L^{-1}.  The column steps of
// chol_inv_warp_rows, each phase split over the lanes by flat element index
// and separated by __syncwarp.
template <typename Real>
__device__ void chol_inv_smem(Real* A, Real* iL, int n, int lane) {
  Real dmax = 0;
  for (int i = 0; i < n; ++i) dmax = vmax(dmax, A[i * n + i]);
  const Real floor = pivot_floor_rel(Real(0)) * dmax;

  for (int j = 0; j < n; ++j) {
    const Real d = A[j * n + j];
    const bool good = d >= floor;
    const Real dc = good ? d : floor;
    const Real inv = Real(1) / sqrt(dc);
    __syncwarp();  // every lane has read the pivot before column j is rewritten

    for (int i = lane; i < n; i += 32) {
      Real v;
      if (i < j) v = 0;
      else if (i == j) v = dc * inv;
      else v = good ? A[i * n + j] * inv : Real(0);
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

template <typename Real>
__global__ void chol_inv_small_smem_kernel(const Real* __restrict__ a,
                                           Real* __restrict__ l,
                                           Real* __restrict__ il, int batch,
                                           int n) {
  Real* smem = dynamic_smem<Real>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;  // whole warps leave; no block barrier follows
  Real* A = smem + warp * 2 * n * n;
  Real* iL = A + n * n;
  const size_t off = (size_t)b * n * n;
  for (int e = lane; e < n * n; e += 32) {
    A[e] = a[off + e];
    iL[e] = (e / n == e % n) ? Real(1) : Real(0);
  }
  __syncwarp();
  chol_inv_smem<Real>(A, iL, n, lane);
  for (int e = lane; e < n * n; e += 32) {
    l[off + e] = A[e];
    il[off + e] = iL[e];
  }
}

// ---- launch ----------------------------------------------------------------

template <typename Real, int NP>
static cudaError_t launch_warp(const Real* a, Real* l, Real* il, int batch,
                               int n, int vec, int grid, int threads,
                               int smem, cudaStream_t s) {
  if ((threads / 32) * 2 * NP * (NP + 1) * (int)sizeof(Real) > smem)
    return cudaErrorInvalidValue;
  static int allowed = 48 * 1024;
  const cudaError_t err =
      allow_smem(chol_inv_small_warp_kernel<Real, NP>, smem, allowed);
  if (err != cudaSuccess) return err;
  chol_inv_small_warp_kernel<Real, NP><<<grid, threads, smem, s>>>(
      a, l, il, batch, n, vec);
  return cudaGetLastError();
}

template <typename Real>
static cudaError_t launch(const Real* a, Real* l, Real* il, int batch, int n,
                          int path, int np, int grid, int threads, int smem,
                          cudaStream_t s) {
  const int warps = threads / 32;
  if (path == 0) {
    // 16-byte copies need each matrix to start 16 bytes apart
    const int vec = (n * n) % (16 / (int)sizeof(Real)) == 0 &&
                    (((uintptr_t)a | (uintptr_t)l | (uintptr_t)il) & 15) == 0;
    switch (np) {
      case 20: return launch_warp<Real, 20>(a, l, il, batch, n, vec, grid,
                                            threads, smem, s);
      case 32: return launch_warp<Real, 32>(a, l, il, batch, n, vec, grid,
                                            threads, smem, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (path != 1 || np != n || n > 48 ||
      smem < warps * 2 * n * n * (int)sizeof(Real))
    return cudaErrorInvalidValue;
  static int allowed = 48 * 1024;
  const cudaError_t err =
      allow_smem(chol_inv_small_smem_kernel<Real>, smem, allowed);
  if (err != cudaSuccess) return err;
  chol_inv_small_smem_kernel<Real><<<grid, threads, smem, s>>>(a, l, il,
                                                               batch, n);
  return cudaGetLastError();
}

// Plain C entry for ctypes: launches the plan that `small_launch_plan` made
// (path 0: registers, padded to np; path 1: shared memory, np = n) on
// matrices of `itemsize`-byte values (4: float32, 8: float64).  Returns
// cudaErrorInvalidValue for a plan the kernels do not take, else
// cudaGetLastError() after the launch.
extern "C" int chol_inv_small_launch(const void* a, void* l, void* il,
                                     int batch, int n, int itemsize,
                                     int path, int np, int grid, int threads,
                                     int smem, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int warps = threads / 32;
  if (n < 1 || n > np || threads % 32 || warps < 1 || warps > 4 ||
      (long long)grid * warps < batch)
    return (int)cudaErrorInvalidValue;
  if (itemsize == 4)
    return (int)launch<float>((const float*)a, (float*)l, (float*)il, batch,
                              n, path, np, grid, threads, smem, s);
  if (itemsize == 8)
    return (int)launch<double>((const double*)a, (double*)l, (double*)il,
                               batch, n, path, np, grid, threads, smem, s);
  return (int)cudaErrorInvalidValue;
}
