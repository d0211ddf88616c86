// chol_inv_mid: batched Cholesky L and triangular inverse L^{-1} of SPD
// float32 matrices [batch, n, n] with 24 < n <= 128, row-major in and out.
//
// Replaces the Pallas TPU kernel `_mid_kernel` (hlax/ops/linalg_small.py:
// 472-565, launched by `_chol_inv_mid_batched`).  On the training path it
// factorizes K0zz stacked with H, [64, 120, 120] float32, and the SPD
// inverse of the natural-gradient update, [32, 120, 120]: two launches a
// train step.  Validation, the test battery and GP imputation send it the
// bucketed B blocks, [32, 256, 32, 32].  As in hlax, the Newton refinement of
// L^{-1} (`_refine_tri_inverse`) runs after the kernel, as two matmuls in the
// Python wrapper.  Only the lower triangle of A is read; L and L^{-1} get
// exact zeros above the diagonal.  The degenerate-pivot guard is hlax's: the
// floor is 1e-6 * max(diag A, 0) over the input's diagonal, and a pivot below
// it is floored with its column pinned to sqrt(floor) * e_j.
//
// What bounds it on an H100: at [64, 120, 120] it reads 3.7 MB and writes
// 7.4 MB (3.3 us at 3.35 TB/s) against ~2n^3/3 = 1.15 MFLOP a matrix (1.1 us
// at 67 TFLOP/s float32), so the bound is memory.  In practice the time is
// latency and instruction count: n dependent pivots a matrix.  The launch
// plan (path, grid, threads, panel width, shared memory) is worked out in
// Python, `mid_launch_plan` in hlax_torch/ops/linalg_small.py, and checked
// here.  Two paths:
//
// * n <= 32 (the eval buckets): one warp a matrix, four a block, the body
//   shared with the small kernel (chol_inv_warp_rows<32>,
//   chol_inv_common.cuh): lane i holds row i of A and of L^{-1} in
//   registers (identity-padded to 32), column j is broadcast with
//   __shfl_sync; shared memory only stages the coalesced loads and stores,
//   and no block barrier is taken.  It agrees with the plain version bit
//   for bit: on an ill-conditioned K0zz the GP bound's loss moves visibly
//   with one rounding's change in the factorization, and the card's toy
//   train steps (M = 30) are held to the CPU's (chip_smoke.py).
// * 32 < n <= 128: one block of 512 threads a matrix, A and L^{-1} resident
//   in dynamic shared memory (identity-padded to np = ceil8(n); 2 x 57.6 KB
//   at n = 120, 131 KB at n = 128), with the panel's L21 transposed beside
//   them.  Right-looking in panels of NB = 8 columns, two block barriers a
//   panel (31 a matrix at n = 120, against the unblocked loop's 360):
//     (a) every thread that needs the 8 x 8 diagonal block factors it in its
//         own registers, pivot by pivot under the guard (hlax's refined
//         rsqrt), with no shuffle and no barrier; then one thread a row
//         solves L21 = A21 L11^{-T} by forward substitution, a floored
//         pivot's column left zero before a later column reads it, and one
//         thread a column applies L11^{-1} to the panel rows of L^{-1};
//     (b) the rank-8 Schur update A22 -= L21 L21^T on the lower triangle and
//         the block update of L^{-1} below the panel, L^{-1}[i, :t2] -=
//         L21[i] L^{-1}[panel, :t2].  Each thread owns fixed 4 x 4 subtiles
//         of A and of L^{-1}, worked out once before the panel loop (no
//         division per element), and does an 8-deep FMA loop on each from
//         float4 shared-memory reads that are broadcasts or conflict-free:
//         each element is loaded and stored once a panel, not once a column.
//   One block a matrix keeps 64 (or 32) of the 132 SMs busy; with the
//   blocking the kernel is well below the library call, so a thread-block
//   cluster a matrix was not built (PERF.md).
// No tensor cores: the canonical K0zz and H have condition >= 1e6, and TF32
// keeps ~3 digits; the flops are tiny, so FP32 FMA on the CUDA cores does,
// and wgmma and TMA buy nothing at these sizes.  Built with FMA contraction
// (hlax_torch/ops/cuda_build.py): the blocked path sums in another order
// than the plain version, with fused multiply-adds and hlax's refined
// rsqrt pivots, and both paths are held to a float64 reference
// (chip_smoke.py, tests/test_torch_cuda.py).
#include "chol_inv_common.cuh"

// ---- n <= 32: one warp a matrix ------------------------------------------

#define WARP_LD 33  // staging row stride: a lane's row read is conflict-free

__global__ void __launch_bounds__(128)
chol_inv_mid_warp_kernel(const float* __restrict__ a, float* __restrict__ l,
                         float* __restrict__ il, int batch, int n) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;  // whole warps leave; no block barrier follows
  float* S = smem + warp * 32 * WARP_LD;
  const size_t off = (size_t)b * n * n;

#pragma unroll
  for (int i = 0; i < 32; ++i)
    S[i * WARP_LD + lane] = (i < n && lane < n) ? a[off + i * n + lane]
                                                : (i == lane ? 1.f : 0.f);
  __syncwarp();
  float r[32], x[32];  // row `lane` of A (then L) and of L^{-1}
  chol_inv_warp_rows<32>(S, WARP_LD, n, lane, r, x);

  // rows out through the staging tile, coalesced; exact zeros above the
  // diagonal
  store_lower_row<32>(S, WARP_LD, lane, r);
  __syncwarp();
  for (int i = 0; i < n; ++i)
    if (lane < n) l[off + i * n + lane] = S[i * WARP_LD + lane];
  __syncwarp();
  store_lower_row<32>(S, WARP_LD, lane, x);
  __syncwarp();
  for (int i = 0; i < n; ++i)
    if (lane < n) il[off + i * n + lane] = S[i * WARP_LD + lane];
}

// ---- 32 < n <= 128: one block a matrix, panels of NB columns ---------------

#define NB 8               // panel width
#define BLOCK_THREADS 512  // a matrix
#define BLOCK_WARPS (BLOCK_THREADS / 32)
#define BLOCK_ROWS (128 / BLOCK_WARPS)  // rows a warp loads and stores
#define MAX_TASKS 2        // 4 x 4 subtiles a thread: 1008 at np = 128

// 1/sqrt(x): rsqrt and one Newton step, as hlax's `_rsqrt1`
__device__ __forceinline__ float pivot_rsqrt(float x) {
  const float y = rsqrtf(x);
  return y * (1.5f - 0.5f * x * y * y);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float at(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Subtiles of the trailing update: kind 0 is a 4 x 4 subtile of A's lower
// triangle, kind 1 one of L^{-1} strictly below the diagonal NB x NB
// tiles.
__host__ __device__ inline int blocked_tasks(int np) {
  const int ns = np / 4, nt = np / NB;
  return ns * (ns + 1) / 2 + 2 * nt * (nt - 1);
}

// The guarded Cholesky of the panel's NB x NB diagonal block at (t, t), in
// one thread's registers: L11's lower triangle in r, 1/sqrt(pivot) in inv,
// whether the pivot stood above the floor in good.  Each thread that needs
// L11 computes it: no shuffles, no barrier.
__device__ __forceinline__ void factor_diag(const float* A, int np, int t,
                                            float floor, float (&r)[NB][NB],
                                            float (&inv)[NB],
                                            bool (&good)[NB]) {
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const float* row = A + (t + q) * np + t;
    const float4 u0 = ld4(row), u1 = ld4(row + 4);
    r[q][0] = u0.x, r[q][1] = u0.y, r[q][2] = u0.z, r[q][3] = u0.w;
    r[q][4] = u1.x, r[q][5] = u1.y, r[q][6] = u1.z, r[q][7] = u1.w;
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float d = r[j][j];
    good[j] = d >= floor;
    const float dc = good[j] ? d : floor;
    inv[j] = pivot_rsqrt(dc);
    r[j][j] = dc * inv[j];
#pragma unroll
    for (int i = j + 1; i < NB; ++i)
      r[i][j] = good[j] ? r[i][j] * inv[j] : 0.f;
#pragma unroll
    for (int k = j + 1; k < NB; ++k)
#pragma unroll
      for (int i = k; i < NB; ++i) r[i][k] -= r[i][j] * r[k][j];
  }
}

// L11^{-1} (lower) from factor_diag's result, by forward substitution.
__device__ __forceinline__ void invert_diag(const float (&r)[NB][NB],
                                            const float (&inv)[NB],
                                            float (&x)[NB][NB]) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    x[c][c] = inv[c];
#pragma unroll
    for (int q = c + 1; q < NB; ++q) {
      float v = 0.f;
#pragma unroll
      for (int p = c; p < q; ++p) v += r[q][p] * x[p][c];
      x[q][c] = -v * inv[q];
    }
  }
}

// Row q of an NB x NB lower-triangular register tile into dst, exact zeros
// above the diagonal.
__device__ __forceinline__ void store_lower(float* dst, int np,
                                            const float (&r)[NB][NB]) {
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    float v[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) v[c] = c <= q ? r[q][c] : 0.f;
    st4(dst + q * np, make_float4(v[0], v[1], v[2], v[3]));
    st4(dst + q * np + 4, make_float4(v[4], v[5], v[6], v[7]));
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
chol_inv_mid_blocked_kernel(const float* __restrict__ a, float* __restrict__ l,
                            float* __restrict__ il, int batch, int n, int np) {
  extern __shared__ __align__(16) float smem[];
  if (blockIdx.x >= batch) return;  // the whole block leaves
  float* A = smem;                  // np x np: A, then L
  float* X = A + np * np;           // np x np: L^{-1}
  float* T = X + np * np;           // NB x np: the panel's L21, transposed
  float* D = T + NB * np;           // NB x NB: L11, until it replaces the
                                    // diagonal block that (a) reads
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int writer = BLOCK_THREADS - 1;  // stores L11 and L11^{-1}
  const size_t off = (size_t)blockIdx.x * n * n;

  // A in, identity-padded, and L^{-1} zeroed: warp w takes rows w + 16k,
  // its lanes columns lane + 32m; every load is in flight before the first
  // store
  {
    float v[BLOCK_ROWS][4];
#pragma unroll
    for (int k = 0; k < BLOCK_ROWS; ++k)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = warp + BLOCK_WARPS * k, c = lane + 32 * m;
        v[k][m] = (i < n && c < n) ? a[off + i * n + c]
                                   : (i == c ? 1.f : 0.f);
      }
#pragma unroll
    for (int k = 0; k < BLOCK_ROWS; ++k)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = warp + BLOCK_WARPS * k, c = lane + 32 * m;
        if (i < np && c < np) A[i * np + c] = v[k][m], X[i * np + c] = 0.f;
      }
  }
  // the pivot floor over the input's diagonal, in every warp
  float dmax = 0.f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = lane + 32 * m;
    if (i < n) dmax = fmaxf(dmax, a[off + i * n + i]);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    dmax = fmaxf(dmax, __shfl_xor_sync(FULL_MASK, dmax, o));
  const float floor = HLAX_PIVOT_FLOOR_REL * dmax;
  // my subtiles, once: kind (-1 none), top-left row and column.  Both
  // kinds run row by row, so neighbouring threads share a row and take
  // neighbouring columns: their reads are broadcasts or hit distinct banks.
  int kind[MAX_TASKS], r0[MAX_TASKS], c0[MAX_TASKS];
  {
    const int ns = np / 4, nA = ns * (ns + 1) / 2;
#pragma unroll
    for (int m = 0; m < MAX_TASKS; ++m) {
      int s = tid + m * BLOCK_THREADS;
      kind[m] = -1;
      r0[m] = c0[m] = 0;
      if (s < nA) {
        int R = 0;  // subtile row R of A holds R + 1 subtiles
        while (s > R) {
          s -= R + 1;
          ++R;
        }
        kind[m] = 0, r0[m] = 4 * R, c0[m] = 4 * s;
      } else if ((s -= nA) < blocked_tasks(np) - nA) {
        int R = 2;  // subtile row R of L^{-1} holds 2 * (R / 2) subtiles
        while (s >= 2 * (R / 2)) {
          s -= 2 * (R / 2);
          ++R;
        }
        kind[m] = 1, r0[m] = 4 * R, c0[m] = 4 * s;
      }
    }
  }
  __syncthreads();

  float r[NB][NB], inv[NB];  // L11, 1/sqrt(pivots) of the current panel
  bool good[NB];
  for (int t = 0; t < np; t += NB) {
    const int t2 = t + NB;
    // (a) L21 by forward substitution against L11, one thread a row (warps
    // 0-3), into A and transposed into T, a floored pivot's column left
    // zero; the panel rows of L^{-1} times L11^{-1}, one thread a column
    // (warps 4-7); the writer stores L11 into D and L11^{-1} into place.
    // Each of them first factors the diagonal block itself.
    const bool row_thread = tid < np - t2;
    const bool col_thread = tid >= 128 && tid - 128 < t;
    if (row_thread || col_thread || tid == writer)
      factor_diag(A, np, t, floor, r, inv, good);
    if (row_thread) {
      float* row = A + (t2 + tid) * np + t;
      const float4 u0 = ld4(row), u1 = ld4(row + 4);
      float x[NB] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        float v = x[q];
#pragma unroll
        for (int p = 0; p < q; ++p) v -= x[p] * r[q][p];
        x[q] = good[q] ? v * inv[q] : 0.f;
      }
      st4(row, make_float4(x[0], x[1], x[2], x[3]));
      st4(row + 4, make_float4(x[4], x[5], x[6], x[7]));
#pragma unroll
      for (int q = 0; q < NB; ++q) T[q * np + t2 + tid] = x[q];
    } else if (col_thread || tid == writer) {
      float x[NB][NB];
      invert_diag(r, inv, x);
      if (tid == writer) {
        store_lower(D, NB, r);
        store_lower(X + t * np + t, np, x);
      } else {
        const int c = tid - 128;
        float y[NB];
#pragma unroll
        for (int q = 0; q < NB; ++q) y[q] = X[(t + q) * np + c];
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          float v = 0.f;
#pragma unroll
          for (int p = 0; p <= q; ++p) v += x[q][p] * y[p];
          X[(t + q) * np + c] = v;
        }
      }
    }
    __syncthreads();
    // every thread has read the diagonal block: L11 replaces it
    if (tid < 2 * NB) {
      const int q = tid >> 1, h = 4 * (tid & 1);
      st4(A + (t + q) * np + t + h, ld4(D + q * NB + h));
    }
    if (t2 == np) break;

    // (b) the rank-NB updates below the panel, on my subtiles
#pragma unroll
    for (int m = 0; m < MAX_TASKS; ++m) {
      const bool on_a = kind[m] == 0 && c0[m] >= t2;
      const bool on_x = kind[m] == 1 && r0[m] >= t2 && c0[m] < t2;
      if (!on_a && !on_x) continue;
      float* dst = (on_a ? A : X) + r0[m] * np + c0[m];
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = ld4(dst + i * np);
        acc[i][0] = v.x, acc[i][1] = v.y, acc[i][2] = v.z, acc[i][3] = v.w;
      }
      // acc[i][k] -= sum_q L21[r0 + i][q] * (L21[c0 + k][q] on A, or
      // L^{-1}[t + q][c0 + k] on L^{-1}): float4 reads along i and along k
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const float4 li = ld4(T + q * np + r0[m]);
        const float4 rk = on_a ? ld4(T + q * np + c0[m])
                               : ld4(X + (t + q) * np + c0[m]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] -= at(li, i) * at(rk, k);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st4(dst + i * np, make_float4(acc[i][0], acc[i][1], acc[i][2],
                                      acc[i][3]));
    }
    __syncthreads();
  }
  __syncthreads();  // the last L11

  // L and L^{-1} out, exact zeros above the diagonal
#pragma unroll
  for (int k = 0; k < BLOCK_ROWS; ++k)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = warp + BLOCK_WARPS * k, c = lane + 32 * m;
      if (i < n && c < n) {
        l[off + i * n + c] = c <= i ? A[i * np + c] : 0.f;
        il[off + i * n + c] = c <= i ? X[i * np + c] : 0.f;
      }
    }
}

// Plain C entry for ctypes: launches the plan that `mid_launch_plan` made
// (path 0: one warp a matrix; path 1: blocked, one block a matrix).  Returns
// cudaErrorInvalidValue for a plan the kernels do not take, else
// cudaGetLastError() after the launch.
extern "C" int chol_inv_mid_launch(const float* a, float* l, float* il,
                                   int batch, int n, int path, int grid,
                                   int threads, int panel, int smem,
                                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (path == 0) {
    const int warps = threads / 32;
    if (n > 32 || threads % 32 || threads > 128 || panel != 0 ||
        (long long)grid * warps < batch ||
        smem < warps * 32 * WARP_LD * (int)sizeof(float))
      return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(chol_inv_mid_warp_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    chol_inv_mid_warp_kernel<<<grid, threads, smem, s>>>(a, l, il, batch, n);
  } else if (path == 1) {
    const int np = (n + NB - 1) / NB * NB;
    if (n <= 32 || np > 128 || threads != BLOCK_THREADS || panel != NB ||
        grid < batch || BLOCK_THREADS * MAX_TASKS < blocked_tasks(np) ||
        smem < (2 * np * np + NB * np + NB * NB) * (int)sizeof(float))
      return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(chol_inv_mid_blocked_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    chol_inv_mid_blocked_kernel<<<grid, threads, smem, s>>>(a, l, il, batch,
                                                            n, np);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
