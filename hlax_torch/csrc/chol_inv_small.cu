// chol_inv_small: batched Cholesky L and triangular inverse L^{-1} of small
// SPD float32 matrices [batch, n, n], n <= 48, row-major in and out.
//
// Replaces the Pallas TPU kernel `_kernel` (hlax/ops/linalg_small.py:112-164,
// launched by `_chol_inv_tpu`, reached through `chol_inv_small`).  On the
// training path it factorizes the per-subject B blocks, [32, 20, 20, 20]
// float32: 640 matrices of 20 x 20 once per train step.  Only the lower
// triangle of A is read; L and L^{-1} get exact zeros above the diagonal;
// the degenerate-pivot guard is hlax's (chol_inv_common.cuh).
//
// What bounds it on an H100: the data are tiny (1.02 MB in, 2.05 MB out,
// 0.92 us at 3.35 TB/s) against ~2n^3/3 flops a matrix (0.08 us at 67
// TFLOP/s float32), so the bound is memory; in practice the time is the
// latency of n dependent pivots a matrix.  The launch plan is worked out in
// Python, `small_launch_plan` in hlax_torch/ops/linalg_small.py, and checked
// here.  Two paths:
//
// * n <= 32: one warp a matrix with row i of A and of L^{-1} in lane i's
//   registers, identity-padded to a compile-time size NP in {20, 32} (the
//   canonical n = 20 pays for exactly 20 column steps); every loop
//   is unrolled, column j goes to the lanes by __shfl_sync, and no value
//   passes through shared memory between column steps (chol_inv_warp_rows,
//   shared with the mid kernel's n <= 32 path).  Shared memory only stages
//   the load and the store: each is a flat copy of the matrix, float4 where
//   n^2 is a multiple of 4 and the pointers are 16-byte aligned (scalar
//   otherwise), scattered into a tile of odd row stride NP + 1 so a lane's
//   row read is conflict-free.  The warps a block are chosen so the batch
//   spreads evenly over the SMs (one a block at the main path's 640).
// * 32 < n <= 48 (no canonical shape): one warp a matrix with A and L^{-1}
//   in shared memory, the lanes splitting each column step's elements
//   (chol_inv_smem below): registers for two 48-float rows a lane would
//   spill.
// Both paths do the plain version's float32 operations in its order, so
// they agree with `_chol_inv_plain` bit for bit (the library is built with
// --fmad=false for chol_inv_smem; the warp path spells its roundings out).
// No tensor cores: the work is a serial chain of n dependent pivots, and
// bit-equality rules out any other summation.  No TMA or cp.async: each warp
// loads one 1.6 KB matrix once, and all 640 are resident in one wave.
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

template <int NP>
__global__ void __launch_bounds__(128)
chol_inv_small_warp_kernel(const float* __restrict__ a, float* __restrict__ l,
                           float* __restrict__ il, int batch, int n,
                           int vec) {
  constexpr int LD = NP + 1;                  // odd: row reads conflict-free
  constexpr int Q4 = (NP * NP + 127) / 128;   // float4 copies a lane, at most
  constexpr int Q1 = (NP * NP + 31) / 32;     // scalar copies a lane, at most
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;  // whole warps leave; no block barrier follows
  float* S = smem + warp * 2 * NP * LD;  // A in, then L out
  float* X = S + NP * LD;                // L^{-1} out
  const int nn = n * n;
  const size_t off = (size_t)b * nn;
  const float rn = 1.f / n;

  // A in: every load in flight, then scattered into the staging tile
  if (vec) {
    const float4* src = reinterpret_cast<const float4*>(a + off);
    float4 v[Q4];
#pragma unroll
    for (int t = 0; t < Q4; ++t)
      if (lane + 32 * t < nn / 4) v[t] = src[lane + 32 * t];
#pragma unroll
    for (int t = 0; t < Q4; ++t) {
      if (lane + 32 * t >= nn / 4) break;
      int i, c;
      row_col(4 * (lane + 32 * t), n, rn, i, c);
      const float u[4] = {v[t].x, v[t].y, v[t].z, v[t].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        S[i * LD + c] = u[k];
        if (++c == n) c = 0, ++i;
      }
    }
  } else {
    float v[Q1];
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
      if (i >= n || lane >= n) S[i * LD + lane] = i == lane ? 1.f : 0.f;
  __syncwarp();

  float r[NP], x[NP];  // row `lane` of A (then L) and of L^{-1}
  chol_inv_warp_rows<NP>(S, LD, n, lane, r, x);
  // each lane overwrites only the row it read
  store_lower_row<NP>(S, LD, lane, r);
  store_lower_row<NP>(X, LD, lane, x);
  __syncwarp();

  // L and L^{-1} out: the flat copies gathered from the staging tiles
  if (vec) {
    float4* dl = reinterpret_cast<float4*>(l + off);
    float4* dx = reinterpret_cast<float4*>(il + off);
#pragma unroll
    for (int t = 0; t < Q4; ++t) {
      const int q = lane + 32 * t;
      if (q >= nn / 4) break;
      int i, c;
      row_col(4 * q, n, rn, i, c);
      float ul[4], ux[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ul[k] = S[i * LD + c];
        ux[k] = X[i * LD + c];
        if (++c == n) c = 0, ++i;
      }
      dl[q] = make_float4(ul[0], ul[1], ul[2], ul[3]);
      dx[q] = make_float4(ux[0], ux[1], ux[2], ux[3]);
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
__device__ void chol_inv_smem(float* A, float* iL, int n, int lane) {
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

__global__ void chol_inv_small_smem_kernel(const float* __restrict__ a,
                                           float* __restrict__ l,
                                           float* __restrict__ il, int batch,
                                           int n) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
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

// ---- launch ----------------------------------------------------------------

template <int NP>
static cudaError_t launch_warp(const float* a, float* l, float* il, int batch,
                               int n, int vec, int grid, int threads,
                               int smem, cudaStream_t s) {
  if ((threads / 32) * 2 * NP * (NP + 1) * (int)sizeof(float) > smem)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above the default limit only
    const cudaError_t err = cudaFuncSetAttribute(
        chol_inv_small_warp_kernel<NP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  chol_inv_small_warp_kernel<NP><<<grid, threads, smem, s>>>(a, l, il, batch,
                                                             n, vec);
  return cudaGetLastError();
}

// Plain C entry for ctypes: launches the plan that `small_launch_plan` made
// (path 0: registers, padded to np; path 1: shared memory, np = n).  Returns
// cudaErrorInvalidValue for a plan the kernels do not take, else
// cudaGetLastError() after the launch.
extern "C" int chol_inv_small_launch(const float* a, float* l, float* il,
                                     int batch, int n, int path, int np,
                                     int grid, int threads, int smem,
                                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int warps = threads / 32;
  if (n < 1 || n > np || threads % 32 || warps < 1 || warps > 4 ||
      (long long)grid * warps < batch)
    return (int)cudaErrorInvalidValue;
  if (path == 0) {
    // float4 copies need each matrix to start 16 bytes apart
    const int vec = (n * n) % 4 == 0 &&
                    (((uintptr_t)a | (uintptr_t)l | (uintptr_t)il) & 15) == 0;
    switch (np) {
      case 20: return (int)launch_warp<20>(a, l, il, batch, n, vec, grid,
                                           threads, smem, s);
      case 32: return (int)launch_warp<32>(a, l, il, batch, n, vec, grid,
                                           threads, smem, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (path != 1 || np != n || n > 48 ||
      smem < warps * 2 * n * n * (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_inv_small_smem_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  chol_inv_small_smem_kernel<<<grid, threads, smem, s>>>(a, l, il, batch, n);
  return (int)cudaGetLastError();
}
