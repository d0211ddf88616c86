// chol_inv_mid: batched Cholesky L and triangular inverse L^{-1} of SPD
// float32 or float64 matrices [batch, n, n] with 24 < n <= 128, row-major in
// and out.
//
// Replaces the Pallas TPU kernel `_mid_kernel` (hlax/ops/linalg_small.py:
// 472-565, launched by `_chol_inv_mid_batched`).  On the training path it
// factorizes K0zz stacked with H, [64, 120, 120], and the SPD inverse of the
// natural-gradient update, [32, 120, 120]: two launches a train step, in
// float32 or float64 (--gp_dtype=float64, or the float64 natural-gradient
// chain of --nat_grad_f64, which adds a third launch; hlax sends float64 to
// XLA's library Cholesky, the port keeps its kernel and the guard).
// Validation, the test battery and GP imputation send it the bucketed B
// blocks, [32, 256, 32, 32]; sequences longer than 128 send it the diagonal
// blocks of `chol_inv_blocked`'s composition (hlax_torch/ops/linalg_small.py:
// [32, 4, 100, 100] at T = 200, [32, 2, 125, 125] at T = 500, 128 x 128 for
// the eval buckets n = 256 and 512).  As in hlax, the Newton refinement of
// L^{-1} (`_refine_tri_inverse`) runs after the kernel, as two matmuls in the
// Python wrapper.  Only the lower triangle of A is read; L and L^{-1} get
// exact zeros above the diagonal.  The degenerate-pivot guard is hlax's: the
// floor is pivot_floor_rel * max(diag A, 0) over the input's diagonal
// (csrc/chol_inv_common.cuh: 1e-6 in float32, 2e-15 in float64), and a pivot
// below it is floored with its column pinned to sqrt(floor) * e_j.
//
// What bounds it on an H100: at [64, 120, 120] float32 it reads 3.7 MB and
// writes 7.4 MB (3.3 us at 3.35 TB/s) against ~2n^3/3 = 1.15 MFLOP a matrix
// (1.1 us at 67 TFLOP/s float32), so the bound is memory; in float64 twice
// the bytes (6.6 us) against 2.2 us at 34 TFLOP/s, memory again.  In
// practice the time is latency and instruction count: n dependent pivots a
// matrix.  The launch plan (path, grid, threads, panel width, shared
// memory) is worked out in Python, `mid_launch_plan` in
// hlax_torch/ops/linalg_small.py, and checked here.  Three paths:
//
// * n <= 32 (the eval buckets): one warp a matrix, four a block, the body
//   shared with the small kernel (chol_inv_warp_rows<Real, 32>,
//   chol_inv_common.cuh): lane i holds row i of A and of L^{-1} in
//   registers (identity-padded to 32), column j is broadcast with
//   __shfl_sync; shared memory only stages the coalesced loads and stores,
//   and no block barrier is taken.  It agrees with the plain version bit
//   for bit in both dtypes: on an ill-conditioned K0zz the GP bound's loss
//   moves visibly with one rounding's change in the factorization, and the
//   card's toy train steps (M = 30) are held to the CPU's (chip_smoke.py).
// * 32 < n <= 128, float32: one block of 512 threads a matrix, A and
//   L^{-1} resident in dynamic shared memory (np x np each, identity-padded
//   to np = ceil8(n): 2 x 57.6 KB at n = 120, 131 KB at n = 128), with the
//   panel's L21 transposed beside them.  Right-looking in panels of NB = 8
//   columns, two block barriers a panel (31 a matrix at n = 120, against
//   the unblocked loop's 360):
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
//         16-byte reads that are broadcasts or conflict-free: each element
//         is loaded and stored once a panel, not once a column.
//   One block a matrix keeps 64 (or 32) of the 132 SMs busy; with the
//   blocking the kernel is well below the library call, so a thread-block
//   cluster a matrix was not built (PERF.md).
// * 32 < n <= 128, float64: the same panels and steps (a) and (b) in a
//   kernel of its own, laid out for 8-byte values.  A and L^{-1} no longer
//   fit as two np x np arrays (230 KB at n = 120), so L^{-1} keeps only its
//   lower triangle, row by row, each row as long as the 8-column tiles it
//   reaches (8, 16, ... values; 61 KB at n = 120): both stay in shared
//   memory, 185 KB at n = 120 and 209 KB at n = 128.  256 threads a block,
//   so each may hold 255 registers: the 8 x 8 diagonal factor, its inverse
//   and the update's accumulators stay in registers without a spill.  In
//   step (b) a 16-byte copy carries 2 values, not 4, and shared-memory
//   traffic bounds it; each task is an 8 x 4 subtile (one 16-byte read of
//   the transposed panel serves 8 rows, not 4), and the tasks active in a
//   panel are dealt out afresh to consecutive threads, one task a thread up
//   to n = 120.  The pivots take the library's double rsqrt without a
//   further Newton step.  On the H100 a column swizzle against bank
//   conflicts and a row stride of np + 2 each measured about 1 % slower,
//   and neither was kept (PERF.md).
// No tensor cores: the canonical K0zz and H have condition >= 1e6, and TF32
// keeps ~3 digits; the flops are tiny, so FMA on the CUDA cores does, and
// wgmma and TMA buy nothing at these sizes.  Built with FMA contraction
// (hlax_torch/ops/cuda_build.py): the blocked paths sum in another order
// than the plain version, with fused multiply-adds and rsqrt pivots; on
// float32 inputs they are held to a float64 reference, on float64 inputs
// to the plain version's own error bar (chip_smoke.py,
// tests/test_torch_cuda.py).
#include "chol_inv_common.cuh"

// ---- n <= 32: one warp a matrix ------------------------------------------

#define WARP_LD 33  // staging row stride: a lane's row read is conflict-free

template <typename Real>
__global__ void __launch_bounds__(128)
chol_inv_mid_warp_kernel(const Real* __restrict__ a, Real* __restrict__ l,
                         Real* __restrict__ il, int batch, int n) {
  Real* smem = dynamic_smem<Real>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;  // whole warps leave; no block barrier follows
  Real* S = smem + warp * 32 * WARP_LD;
  const size_t off = (size_t)b * n * n;

#pragma unroll
  for (int i = 0; i < 32; ++i)
    S[i * WARP_LD + lane] = (i < n && lane < n)
                                ? a[off + i * n + lane]
                                : (i == lane ? Real(1) : Real(0));
  __syncwarp();
  Real r[32], x[32];  // row `lane` of A (then L) and of L^{-1}
  chol_inv_warp_rows<Real, 32>(S, WARP_LD, n, lane, r, x);

  // rows out through the staging tile, coalesced; exact zeros above the
  // diagonal
  store_lower_row<Real, 32>(S, WARP_LD, lane, r);
  __syncwarp();
  for (int i = 0; i < n; ++i)
    if (lane < n) l[off + i * n + lane] = S[i * WARP_LD + lane];
  __syncwarp();
  store_lower_row<Real, 32>(S, WARP_LD, lane, x);
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

// 1/sqrt(x): in float32 rsqrt and one Newton step, as hlax's `_rsqrt1`; in
// float64 the library's rsqrt (within 1 ulp), whose own Newton steps a
// further one would only lengthen the pivot chain
__device__ __forceinline__ float pivot_rsqrt(float x) {
  const float y = rsqrtf(x);
  return y * (1.5f - 0.5f * x * y * y);
}
__device__ __forceinline__ double pivot_rsqrt(double x) { return rsqrt(x); }

// Subtiles of the trailing update: kind 0 is a 4 x 4 subtile of A's lower
// triangle, kind 1 one of L^{-1} strictly below the diagonal NB x NB
// tiles.
__host__ __device__ inline int blocked_tasks(int np) {
  const int ns = np / 4, nt = np / NB;
  return ns * (ns + 1) / 2 + 2 * nt * (nt - 1);
}

// The guarded Cholesky of an NB x NB diagonal block held in one thread's
// registers (its lower triangle in r): L11's lower triangle into r,
// 1/sqrt(pivot) into inv, whether the pivot stood above the floor into good.
template <typename Real>
__device__ __forceinline__ void factor_regs(Real floor, Real (&r)[NB][NB],
                                            Real (&inv)[NB],
                                            bool (&good)[NB]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const Real d = r[j][j];
    good[j] = d >= floor;
    const Real dc = good[j] ? d : floor;
    inv[j] = pivot_rsqrt(dc);
    r[j][j] = dc * inv[j];
#pragma unroll
    for (int i = j + 1; i < NB; ++i)
      r[i][j] = good[j] ? r[i][j] * inv[j] : Real(0);
#pragma unroll
    for (int k = j + 1; k < NB; ++k)
#pragma unroll
      for (int i = k; i < NB; ++i) r[i][k] -= r[i][j] * r[k][j];
  }
}

// The panel's NB x NB diagonal block at (t, t) of A (row stride np),
// factored by factor_regs.  Each thread that needs L11 computes it: no
// shuffles, no barrier.
template <typename Real>
__device__ __forceinline__ void factor_diag(const Real* A, int np, int t,
                                            Real floor, Real (&r)[NB][NB],
                                            Real (&inv)[NB],
                                            bool (&good)[NB]) {
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const Real* row = A + (t + q) * np + t;
    Real u0[4], u1[4];
    ld4(row, u0);
    ld4(row + 4, u1);
#pragma unroll
    for (int c = 0; c < 4; ++c) r[q][c] = u0[c], r[q][4 + c] = u1[c];
  }
  factor_regs<Real>(floor, r, inv, good);
}

// L11^{-1} (lower) from factor_diag's result, by forward substitution.
template <typename Real>
__device__ __forceinline__ void invert_diag(const Real (&r)[NB][NB],
                                            const Real (&inv)[NB],
                                            Real (&x)[NB][NB]) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    x[c][c] = inv[c];
#pragma unroll
    for (int q = c + 1; q < NB; ++q) {
      Real v = 0;
#pragma unroll
      for (int p = c; p < q; ++p) v += r[q][p] * x[p][c];
      x[q][c] = -v * inv[q];
    }
  }
}

// Row q of an NB x NB lower-triangular register tile into dst, exact zeros
// above the diagonal.
template <typename Real>
__device__ __forceinline__ void store_lower(Real* dst, int np,
                                            const Real (&r)[NB][NB]) {
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    Real v0[4], v1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v0[c] = c <= q ? r[q][c] : Real(0);
      v1[c] = 4 + c <= q ? r[q][4 + c] : Real(0);
    }
    st4(dst + q * np, v0);
    st4(dst + q * np + 4, v1);
  }
}

// float32 only: float64 has its own kernel below.
template <typename Real>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
chol_inv_mid_blocked_kernel(const Real* __restrict__ a, Real* __restrict__ l,
                            Real* __restrict__ il, int batch, int n,
                            int np) {
  if (blockIdx.x >= batch) return;  // the whole block leaves
  Real* A = dynamic_smem<Real>();   // np x np: A, then L
  Real* X = A + np * np;            // np x np: L^{-1}
  Real* Pt = X + np * np;           // NB x np: the panel's L21, transposed
  Real* D = Pt + NB * np;           // NB x NB: L11, until it replaces the
                                    // diagonal block that (a) reads
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int writer = BLOCK_THREADS - 1;  // stores L11 and L11^{-1}
  const size_t off = (size_t)blockIdx.x * n * n;

  // A in, identity-padded, and L^{-1} zeroed: warp w takes rows w + 16k,
  // its lanes columns lane + 32m; every load is in flight before the first
  // store
  {
    Real v[BLOCK_ROWS][4];
#pragma unroll
    for (int k = 0; k < BLOCK_ROWS; ++k)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = warp + BLOCK_WARPS * k, c = lane + 32 * m;
        v[k][m] = (i < n && c < n) ? a[off + i * n + c]
                                   : (i == c ? Real(1) : Real(0));
      }
#pragma unroll
    for (int k = 0; k < BLOCK_ROWS; ++k)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = warp + BLOCK_WARPS * k, c = lane + 32 * m;
        if (i < np && c < np) A[i * np + c] = v[k][m], X[i * np + c] = 0;
      }
  }
  // the pivot floor over the input's diagonal, in every warp
  Real dmax = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = lane + 32 * m;
    if (i < n) dmax = vmax(dmax, a[off + i * n + i]);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    dmax = vmax(dmax, __shfl_xor_sync(FULL_MASK, dmax, o));
  const Real floor = pivot_floor_rel(Real(0)) * dmax;
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

  Real r[NB][NB], inv[NB];  // L11, 1/sqrt(pivots) of the current panel
  bool good[NB];
  for (int t = 0; t < np; t += NB) {
    const int t2 = t + NB;
    // (a) L21 by forward substitution against L11, one thread a row (warps
    // 0-3), into A and transposed into Pt, a floored pivot's column left
    // zero; the panel rows of L^{-1} times L11^{-1}, one thread a column
    // (warps 4-7); the writer stores L11 into D and L11^{-1} into place.
    // Each of them first factors the diagonal block itself.
    const bool row_thread = tid < np - t2;
    const bool col_thread = tid >= 128 && tid - 128 < t;
    if (row_thread || col_thread || tid == writer)
      factor_diag<Real>(A, np, t, floor, r, inv, good);
    if (row_thread) {
      Real* row = A + (t2 + tid) * np + t;
      Real x[NB];
      {
        Real u0[4], u1[4];
        ld4(row, u0);
        ld4(row + 4, u1);
#pragma unroll
        for (int c = 0; c < 4; ++c) x[c] = u0[c], x[4 + c] = u1[c];
      }
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        Real v = x[q];
#pragma unroll
        for (int p = 0; p < q; ++p) v -= x[p] * r[q][p];
        x[q] = good[q] ? v * inv[q] : Real(0);
      }
      const Real x0[4] = {x[0], x[1], x[2], x[3]};
      const Real x1[4] = {x[4], x[5], x[6], x[7]};
      st4(row, x0);
      st4(row + 4, x1);
#pragma unroll
      for (int q = 0; q < NB; ++q) Pt[q * np + t2 + tid] = x[q];
    } else if (col_thread || tid == writer) {
      Real x[NB][NB];
      invert_diag<Real>(r, inv, x);
      if (tid == writer) {
        store_lower<Real>(D, NB, r);
        store_lower<Real>(X + t * np + t, np, x);
      } else {
        const int c = tid - 128;
        Real y[NB];
#pragma unroll
        for (int q = 0; q < NB; ++q) y[q] = X[(t + q) * np + c];
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          Real v = 0;
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
      Real u[4];
      ld4(D + q * NB + h, u);
      st4(A + (t + q) * np + t + h, u);
    }
    if (t2 == np) break;

    // (b) the rank-NB updates below the panel, on my subtiles
#pragma unroll
    for (int m = 0; m < MAX_TASKS; ++m) {
      const bool on_a = kind[m] == 0 && c0[m] >= t2;
      const bool on_x = kind[m] == 1 && r0[m] >= t2 && c0[m] < t2;
      if (!on_a && !on_x) continue;
      Real* dst = (on_a ? A : X) + r0[m] * np + c0[m];
      Real acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ld4(dst + i * np, acc[i]);
      // acc[i][k] -= sum_q L21[r0 + i][q] * (L21[c0 + k][q] on A, or
      // L^{-1}[t + q][c0 + k] on L^{-1}): 16-byte reads along i and along k
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        Real li[4], rk[4];
        ld4(Pt + q * np + r0[m], li);
        ld4(on_a ? Pt + q * np + c0[m] : X + (t + q) * np + c0[m], rk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] -= li[i] * rk[k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) st4(dst + i * np, acc[i]);
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
        l[off + i * n + c] = c <= i ? A[i * np + c] : Real(0);
        il[off + i * n + c] = c <= i ? X[i * np + c] : Real(0);
      }
    }
}

// ---- 32 < n <= 128, float64: L^{-1} packed beside A ------------------------

#define F64_THREADS 256     // a matrix: up to 255 registers a thread
#define F64_ROW_THREADS 128  // (a): threads below it take the panel's rows,
                             // the rest the columns of L^{-1}

// Offset of row r of the packed L^{-1}: the rows of 8-row tile R are
// 8 (R + 1) values long, through their diagonal tile.
__host__ __device__ __forceinline__ int xrow(int r) {
  const int R = r >> 3;
  return NB * (R + 1) * (4 * R + (r & 7));
}

// Values of shared memory at np: A, the packed L^{-1}, the transposed panel
// and L11.
__host__ __device__ inline int f64_smem_values(int np) {
  return np * np + xrow(np) + NB * np + NB * NB;
}

__global__ void __launch_bounds__(F64_THREADS, 1)
chol_inv_mid_blocked64_kernel(const double* __restrict__ a,
                              double* __restrict__ l,
                              double* __restrict__ il, int batch, int n,
                              int np) {
  if (blockIdx.x >= batch) return;  // the whole block leaves
  const int nt = np / NB;
  double* A = dynamic_smem<double>();  // np x np: A, then L
  double* X = A + np * np;             // packed rows of L^{-1}
  double* Pt = X + xrow(np);           // NB x np: the panel's L21,
                                       // transposed
  double* D = Pt + NB * np;            // NB x NB: L11
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int writer = F64_THREADS - 1;  // stores L11 and L11^{-1}
  const size_t off = (size_t)blockIdx.x * n * n;

  // A in, identity-padded: warp w takes rows w + 8k, its lanes columns
  // lane + 32m, in two rounds of eight rows (one round of sixteen spills)
#pragma unroll
  for (int k0 = 0; k0 < 128 / 8; k0 += 8) {
    double v[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = warp + 8 * (k0 + k), c = lane + 32 * m;
        v[k][m] = (i < n && c < n) ? a[off + i * n + c]
                                   : (i == c ? 1.0 : 0.0);
      }
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = warp + 8 * (k0 + k), c = lane + 32 * m;
        if (i < np && c < np) A[i * np + c] = v[k][m];
      }
  }
  for (int e = tid; e < xrow(np); e += F64_THREADS) X[e] = 0;
  __syncthreads();
  // the pivot floor over A's diagonal, in every warp, from shared memory
  double dmax = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = lane + 32 * m;
    if (i < n) dmax = fmax(dmax, A[i * np + i]);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    dmax = fmax(dmax, __shfl_xor_sync(FULL_MASK, dmax, o));
  const double floor = pivot_floor_rel(0.0) * dmax;

  double r[NB][NB], inv[NB];  // L11, 1/sqrt(pivots) of the current panel
  bool good[NB];
  for (int t = 0; t < np; t += NB) {
    const int t2 = t + NB, T = t / NB;
    double* Xp = X + xrow(t);    // the panel's rows of L^{-1},
    const int xs = NB * (T + 1);  // xs values apart
    // (a) as in the float32 kernel: L21 one thread a row, the panel rows of
    // L^{-1} times L11^{-1} one thread a column, L11 and L11^{-1} by the
    // writer; each first factors the diagonal block itself
    const bool row_thread = tid < np - t2;
    const bool col_thread =
        tid >= F64_ROW_THREADS && tid - F64_ROW_THREADS < t;
    if (row_thread || col_thread || tid == writer) {
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        double u0[4], u1[4];
        ld4(A + (t + q) * np + t, u0);
        ld4(A + (t + q) * np + t + 4, u1);
#pragma unroll
        for (int c = 0; c < 4; ++c) r[q][c] = u0[c], r[q][4 + c] = u1[c];
      }
      factor_regs<double>(floor, r, inv, good);
    }
    if (row_thread) {
      double* row = A + (t2 + tid) * np;
      double x[NB];
      {
        double u0[4], u1[4];
        ld4(row + t, u0);
        ld4(row + t + 4, u1);
#pragma unroll
        for (int c = 0; c < 4; ++c) x[c] = u0[c], x[4 + c] = u1[c];
      }
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        double v = x[q];
#pragma unroll
        for (int p = 0; p < q; ++p) v -= x[p] * r[q][p];
        x[q] = good[q] ? v * inv[q] : 0.0;
      }
      const double x0[4] = {x[0], x[1], x[2], x[3]};
      const double x1[4] = {x[4], x[5], x[6], x[7]};
      st4(row + t, x0);
      st4(row + t + 4, x1);
#pragma unroll
      for (int q = 0; q < NB; ++q) Pt[q * np + t2 + tid] = x[q];
    } else if (col_thread || tid == writer) {
      double x[NB][NB];
      invert_diag<double>(r, inv, x);
      if (tid == writer) {
        store_lower<double>(D, NB, r);
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          double v0[4], v1[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            v0[c] = c <= q ? x[q][c] : 0.0;
            v1[c] = 4 + c <= q ? x[q][4 + c] : 0.0;
          }
          st4(Xp + q * xs + t, v0);
          st4(Xp + q * xs + t + 4, v1);
        }
      } else {
        const int c = tid - F64_ROW_THREADS;
        double y[NB];
#pragma unroll
        for (int q = 0; q < NB; ++q) y[q] = Xp[q * xs + c];
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          double v = 0;
#pragma unroll
          for (int p = 0; p <= q; ++p) v += x[q][p] * y[p];
          Xp[q * xs + c] = v;
        }
      }
    }
    __syncthreads();
    // every thread has read the diagonal block: L11 replaces it
    if (tid < 2 * NB) {
      const int q = tid >> 1, h = 4 * (tid & 1);
      double u[4];
      ld4(D + q * NB + h, u);
      st4(A + (t + q) * np + t + h, u);
    }
    if (t2 == np) break;

    // (b) the rank-NB updates below the panel in NB x 4 tasks, dealt out to
    // consecutive threads: first A's trailing lower triangle (tile row R of
    // it holds 2 (R + 1) tasks), then L^{-1}'s rows below the panel left of
    // t2 (2 (T + 1) tasks a tile row)
    const int mt = nt - T - 1;  // tile rows below the panel
    const int nA = mt * (mt + 1), w = 2 * (T + 1);
    for (int k = tid; k < nA + mt * w; k += F64_THREADS) {
      int r0, c0, ds, rs;
      double* dst;
      const double* rb;  // the right factor's rows, rs values apart
      if (k < nA) {
        int R = (int)((sqrtf(4.0f * k + 1.0f) - 1.0f) * 0.5f);
        R += (R + 1) * (R + 2) <= k;
        R -= R * (R + 1) > k;
        r0 = t2 + NB * R, c0 = t2 + 4 * (k - R * (R + 1));
        dst = A + r0 * np, ds = np, rb = Pt, rs = np;
      } else {
        const int kx = k - nA, R = kx / w;
        r0 = t2 + NB * R, c0 = 4 * (kx - R * w);
        dst = X + xrow(r0), ds = NB * (T + 2 + R), rb = Xp, rs = xs;
      }
      double acc[NB][4];
#pragma unroll
      for (int i = 0; i < NB; ++i) ld4(dst + i * ds + c0, acc[i]);
      // acc[i][c] -= sum_q L21[r0 + i][q] * (L21[c0 + c][q] on A, or
      // L^{-1}[t + q][c0 + c] on L^{-1})
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        double l0[4], l1[4], rk[4];
        ld4(Pt + q * np + r0, l0);
        ld4(Pt + q * np + r0 + 4, l1);
        ld4(rb + q * rs + c0, rk);
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c] -= l0[i] * rk[c];
            acc[4 + i][c] -= l1[i] * rk[c];
          }
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) st4(dst + i * ds + c0, acc[i]);
    }
    __syncthreads();
  }
  __syncthreads();  // the last L11

  // L and L^{-1} out, exact zeros above the diagonal
#pragma unroll
  for (int k = 0; k < 128 / 8; ++k)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = warp + 8 * k, c = lane + 32 * m;
      if (i < n && c < n) {
        const bool lower = c <= i;
        l[off + i * n + c] = lower ? A[i * np + c] : 0.0;
        il[off + i * n + c] = lower ? X[xrow(i) + c] : 0.0;
      }
    }
}

template <typename Real>
static cudaError_t launch(const void* a_, void* l_, void* il_, int batch,
                          int n, int path, int grid, int threads, int panel,
                          int smem, cudaStream_t s) {
  const Real* a = (const Real*)a_;
  Real *l = (Real*)l_, *il = (Real*)il_;
  const int sz = (int)sizeof(Real);
  cudaError_t err;
  if (path == 0) {
    const int warps = threads / 32;
    if (n > 32 || threads % 32 || threads > 128 || panel != 0 ||
        (long long)grid * warps < batch || smem < warps * 32 * WARP_LD * sz)
      return cudaErrorInvalidValue;
    static int allowed = 48 * 1024;
    err = allow_smem(chol_inv_mid_warp_kernel<Real>, smem, allowed);
    if (err != cudaSuccess) return err;
    chol_inv_mid_warp_kernel<Real><<<grid, threads, smem, s>>>(a, l, il,
                                                               batch, n);
  } else if (path == 1) {
    const int np = (n + NB - 1) / NB * NB;
    if (n <= 32 || np > 128 || panel != NB || grid < batch)
      return cudaErrorInvalidValue;
    static int allowed = 48 * 1024;
    if constexpr (sizeof(Real) == 4) {
      // A, L^{-1}, the transposed panel and L11
      if (threads != BLOCK_THREADS ||
          BLOCK_THREADS * MAX_TASKS < blocked_tasks(np) ||
          smem < (2 * np * np + NB * np + NB * NB) * sz)
        return cudaErrorInvalidValue;
      err = allow_smem(chol_inv_mid_blocked_kernel<Real>, smem, allowed);
      if (err != cudaSuccess) return err;
      chol_inv_mid_blocked_kernel<Real><<<grid, threads, smem, s>>>(
          a, l, il, batch, n, np);
    } else {
      if (threads != F64_THREADS || smem < f64_smem_values(np) * sz)
        return cudaErrorInvalidValue;
      err = allow_smem(chol_inv_mid_blocked64_kernel, smem, allowed);
      if (err != cudaSuccess) return err;
      chol_inv_mid_blocked64_kernel<<<grid, threads, smem, s>>>(
          a, l, il, batch, n, np);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Plain C entry for ctypes: launches the plan that `mid_launch_plan` made
// (path 0: one warp a matrix; path 1: blocked, one block a matrix) on
// matrices of `itemsize`-byte values (4: float32, 8: float64).  Returns
// cudaErrorInvalidValue for a plan the kernels do not take, else
// cudaGetLastError() after the launch.
extern "C" int chol_inv_mid_launch(const void* a, void* l, void* il,
                                   int batch, int n, int itemsize, int path,
                                   int grid, int threads, int panel, int smem,
                                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (itemsize == 4)
    return (int)launch<float>(a, l, il, batch, n, path, grid, threads, panel,
                              smem, s);
  if (itemsize == 8)
    return (int)launch<double>(a, l, il, batch, n, path, grid, threads,
                               panel, smem, s);
  return (int)cudaErrorInvalidValue;
}
