// chol_inv_mid_bwd: batched pullback of (L, L^{-1}) = chol_inv(A) for
// float32 or float64 matrices [batch, n, n] with n <= 128 (the wrapper sends
// 24 < n <= 128, the mid kernel's range), row-major in and out.
//
// Stands for XLA's fusion of hlax's `_mid_bwd` (hlax/ops/linalg_small.py:
// 662-667), the custom VJP of `_chol_inv_mid`, which is the matmul pullback
// `_bwd_reference` (:431-443) outside any Pallas kernel.  From the saved
// factors L, L^{-1} (lower-triangular, exact zeros above the diagonal, as
// the mid kernel and its Newton step leave them) and the cotangents Lb, iLb
// of both outputs it computes
//   S    = L^{-T} iLb                      (1)
//   Lb2  = Lb - tril(S L^{-T})             (2)  fold d(L^{-1}) into dL
//   P    = Phi(L^T Lb2)                    (3)
//   Y    = P L^{-1}                        (4)
//   X    = L^{-T} Y                        (5)
//   Abar = Phi(X + X^T)
// where Phi keeps the lower triangle and halves the diagonal; Abar has
// `_bwd_reference`'s lower convention, exact zeros above the diagonal.  On
// the training path it is the backward of K0zz stacked with H, [64, 120,
// 120] in the GP's dtype: one call a train step; the long sequences' diagonal
// blocks take one each ([32, 4, 100, 100] at T = 200, [32, 2, 125, 125] at
// T = 500).
//
// What bounds it on an H100: 4 inputs and 1 output of 64 x 57.6 KB (18.4 MB,
// 5.5 us at 3.35 TB/s in float32, 11.0 us in float64) against the terms
// that the triangular factors leave in the five products, about 2 n^3 flops
// a matrix (3.4 us at 67 TFLOP/s, float32 outside the tensor cores or
// float64 on them): the bound is bytes.  A block's 227 KB of shared
// memory holds neither the four inputs of one float32 matrix (230 KB) nor
// the chain's intermediates, so the chain is cut into three launches, each
// on 32-row panels or 32 x 32 tiles, with Lb2 and Y through a workspace of
// two [batch, n, n] (3.7 MB each at the canonical float32 shape, well inside
// the 50 MB L2); the plan is `mid_bwd_launch_plan` in
// hlax_torch/ops/linalg_small.py, checked here:
//   (a) fold: a block a (matrix, 32-row panel): (1) for the panel's rows
//       of S, in its columns left of the panel's end (what (2) reads: S's
//       lower triangle, and above it only within the panel), then (2) for
//       the panel's rows, written to the workspace as Lb2 with zeros above
//       the diagonal;
//   (b) project: a block a (matrix, panel): P^T's columns of the panel (3)
//       with Phi in its epilogue, then (4) for the panel's rows, written to
//       the workspace as Y (lower-triangular);
//   (c) symmetrize: a block a (matrix, lower pair of 32 x 32 tiles (I, J)):
//       X's tiles (I, J) and (J, I) (5), then Abar's tile (I, J) and zeros in
//       its mirror.
// Each product is an outer-product loop over k into 4 x 4 register subtiles
// of fused multiply-adds, both operands staged k-major in shared memory (a
// transposed left factor is read as it lies in memory: L^{-1} for (1), L for
// (3)), so a warp's reads are one 64-byte row broadcast to its 8 column
// groups and one 128-byte row shared by its 4 row groups.  Only (2) needs
// L^{-T} as a right factor: it is staged transposed.  Structural zeros are
// skipped a warp at a time (every k-range warp-uniform, its ends cut to
// where the triangular factors are nonzero; a warp whose subtiles all lie
// above the diagonal does no product); what a range still covers adds exact
// zeros.  So it sums in another order than cuBLAS's products in the plain
// version: on float32 inputs it is held to a float64 reference, on float64
// inputs within 1e-10 of the largest entry of the plain version
// (chip_smoke.py, tests/test_torch_cuda.py).  No tensor cores: TF32 keeps
// ~3 digits, and the GP runs in full float32.  Built with FMA contraction
// (hlax_torch/ops/cuda_build.py).
//
// In float64 this design is slower in the train step than the plain chain
// it replaced (the backward of the GP bound 0.3576 -> 0.3753 ms a step on
// an H100 80GB HBM3 at 700 W, chip_smoke.py's [parent] eager profiles):
// its products run on the FP64 CUDA cores, where cuBLAS's run on
// the FP64 tensor cores.  The redesign is FP64 DMMA (mma m16n8k8 in
// double, as csrc/natgrad.cu's finish kernel uses).
#include <cstdint>

#include "chol_inv_common.cuh"

#define MB_ROWS 32      // panel rows and tile width
#define MB_AB_THREADS 256
#define MB_C_THREADS 128
#define MB_XS_LD (MB_ROWS + 1)  // stride of the mirrored tile (odd: banks)

__host__ __device__ __forceinline__ int round4(int x) {
  return (x + 3) & ~3;
}

// Shared-memory values (not bytes) a block takes.  (a) and (b) per panel
// p: the panel's 32 columns of S^T or P^T, beside the larger of the
// staged k-major strips of the first product and the right factor of the
// second (L^{-T} staged with a stride of cwp + 4 in (a), L^{-1} in (b));
// (c) per tile pair: two strips of L^{-1} and two of Y from row I0 on (one
// each on the diagonal), and the mirrored tile.  Must match
// `mid_bwd_launch_plan`.
__host__ __device__ __forceinline__ int panel_values(int n, int p) {
  const int r0 = MB_ROWS * p, kn = n - r0;
  const int cw = r0 + MB_ROWS < n ? r0 + MB_ROWS : n, cwp = round4(cw);
  int region = kn * (cwp + MB_ROWS);
  if (cw * (cwp + 4) > region) region = cw * (cwp + 4);
  return cwp * MB_ROWS + region;
}
static int ab_values(int n) {
  int most = 0;
  for (int p = 0; p * MB_ROWS < n; ++p)
    if (panel_values(n, p) > most) most = panel_values(n, p);
  return most;
}
static int c_values(int n) {
  const int diag = 2 * n, off = n > MB_ROWS ? 4 * (n - MB_ROWS) : 0;
  return (diag > off ? diag : off) * MB_ROWS + MB_ROWS * MB_XS_LD;
}

// dst[r][c] (stride ld) = src[row0 + r][col0 + c] of an n x n row-major
// matrix for r < rows, c < width (a multiple of 4), zero where col0 + c >=
// n; by 16-byte cp.async when `vec` (n and col0 multiples of the values a
// copy, the pointers aligned), else a value a copy.  The caller waits.
template <typename Real>
__device__ __forceinline__ void load_strip(Real* dst, int ld, const Real* src,
                                           int n, int row0, int rows,
                                           int col0, int width, bool vec) {
  constexpr int V = 16 / sizeof(Real);
  if (vec) {
    const int qr = width / V;
    for (int q = threadIdx.x; q < rows * qr; q += blockDim.x) {
      const int r = q / qr, c = V * (q - r * qr);
      Real* d = dst + r * ld + c;
      if (col0 + c < n) {
        cp_async16(d, src + (size_t)(row0 + r) * n + col0 + c);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) d[v] = Real(0);
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * width; e += blockDim.x) {
      const int r = e / width, c = e - r * width;
      Real* d = dst + r * ld + c;
      if (col0 + c < n)
        cp_async1(d, src + (size_t)(row0 + r) * n + col0 + c);
      else
        *d = Real(0);
    }
  }
}

// dst[k][j] (stride ld) = src[j][k] for k < cw, j < cwp (zero for j >= cw):
// the leading cw x cw block of an n x n row-major matrix, transposed.  A
// warp takes 8 rows j by 4 columns k, so its reads are 8 runs of 4 values
// and its float32 writes meet at most 2-way bank conflicts (ld = 4 or 28
// mod 32, as cwp + 4 is for every n).
template <typename Real>
__device__ __forceinline__ void load_transposed(Real* dst, int ld,
                                                const Real* src, int n,
                                                int cw, int cwp) {
  const int nj = (cwp + 7) / 8, nk = (cw + 3) / 4;
  for (int e = threadIdx.x; e < nj * nk * 32; e += blockDim.x) {
    const int lane = e & 31, blk = e >> 5;
    const int j = 8 * (blk % nj) + (lane & 7), k = 4 * (blk / nj) + (lane >> 3);
    if (j < cwp && k < cw)
      dst[k * ld + j] = j < cw ? src[(size_t)j * n + k] : Real(0);
  }
}

// acc[r][c] = sum_{k in [lo, hi)} U[k][i0 + r] V[k][j0 + c]; U and V
// k-major with strides ldu and ldv (multiples of 4), i0 and j0 multiples
// of 4
template <typename Real>
__device__ __forceinline__ void outer(const Real* U, int ldu, int i0,
                                      const Real* V, int ldv, int j0, int lo,
                                      int hi, Real (&acc)[4][4]) {
#pragma unroll 4
  for (int k = lo; k < hi; ++k) {
    Real u[4], v[4];
    ld4(U + k * ldu + i0, u);
    ld4(V + k * ldv + j0, v);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += u[r] * v[c];
  }
}

template <typename Real>
__device__ __forceinline__ void zero(Real (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = Real(0);
}

// 4 values of row-major row `row` (n columns) at columns j0 .. j0 + 3, the
// ones at or past n left alone (load) or not written (store)
template <typename Real>
__device__ __forceinline__ void load_row4(const Real* m, int n, int row,
                                          int j0, bool vec, Real (&u)[4]) {
  const Real* p = m + (size_t)row * n + j0;
  if (vec && j0 + 4 <= n) {
    ld4(p, u);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j0 + c < n) u[c] = p[c];
  }
}
template <typename Real>
__device__ __forceinline__ void store_row4(Real* m, int n, int row, int j0,
                                           bool vec, const Real (&u)[4]) {
  Real* p = m + (size_t)row * n + j0;
  if (vec && j0 + 4 <= n) {
    st4(p, u);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j0 + c < n) p[c] = u[c];
  }
}

// The two mappings of 256 threads to 4 x 4 subtiles: "tall" outputs of up
// to 128 rows by the panel's 32 columns (a warp 16 rows by 32), "wide" ones
// of the panel's 32 rows by up to 128 columns (a warp 16 rows by 32, the
// warps 2 x 4); in both a warp is 4 row groups by 8 column groups.
struct Tall {
  int w, rg, cg;
  __device__ Tall(int t) : w(t >> 5), rg(4 * (t >> 5) + ((t & 31) >> 3)),
                           cg(t & 7) {}
};
struct Wide {
  int wr, wc, rg, cg;
  __device__ Wide(int t)
      : wr((t >> 5) & 1), wc(t >> 6), rg(4 * ((t >> 5) & 1) + ((t & 31) >> 3)),
        cg(8 * (t >> 6) + (t & 7)) {}
};

// (a) fold, a block a (matrix, panel):
//   S^T[kk][i] = sum_{m >= r0} iLb[m][kk] L^{-1}[m][r0 + i], kk < cw
//   Lb2[r0 + i][j] = Lb[r0 + i][j] - sum_{k <= j} S[i][k] L^{-1}[j][k],
//   j <= r0 + i (0 above), into the workspace's first matrix
template <typename Real>
__global__ void __launch_bounds__(MB_AB_THREADS)
chol_inv_mid_bwd_fold_kernel(const Real* __restrict__ il,
                             const Real* __restrict__ lb,
                             const Real* __restrict__ ilb,
                             Real* __restrict__ lb2, int n, int panels,
                             int vec) {
  const int b = blockIdx.x / panels, p = blockIdx.x - b * panels;
  const int r0 = MB_ROWS * p, kn = n - r0;
  const int cw = r0 + MB_ROWS < n ? r0 + MB_ROWS : n, cwp = round4(cw);
  const size_t off = (size_t)b * n * n;
  Real* const smem = dynamic_smem<Real>();
  Real* const st = smem;                       // S^T, cwp x 32
  Real* const ub = st + cwp * MB_ROWS;         // iLb rows r0.., kn x cwp
  Real* const vb = ub + kn * cwp;              // L^{-1} rows r0.., kn x 32
  load_strip(ub, cwp, ilb + off, n, r0, kn, 0, cwp, vec);
  load_strip(vb, MB_ROWS, il + off, n, r0, kn, r0, MB_ROWS, vec);
  cp_async_wait_all();
  __syncthreads();

  Real acc[4][4];
  {  // (1): rows kk of S^T below cw; L^{-1}[m][r0 + i] = 0 for m < r0 + i
    const Tall t(threadIdx.x);
    const int kk0 = 4 * t.rg, i0 = 4 * t.cg;
    if (16 * t.w < cw && kk0 < cwp) {
      zero(acc);
      outer(ub, cwp, kk0, vb, MB_ROWS, i0, 0, kn, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) st4(st + (kk0 + r) * MB_ROWS + i0, acc[r]);
    }
  }
  __syncthreads();
  Real* const ilt = ub;                        // L^{-T}, cw x (cwp + 4)
  const int ldt = cwp + 4;
  load_transposed(ilt, ldt, il + off, n, cw, cwp);
  __syncthreads();

  {  // (2): k <= min(i, j); rows i of the panel, columns j < n
    const Wide t(threadIdx.x);
    const int i0 = 4 * t.rg, j0 = 4 * t.cg;
    const int rmax = r0 + 16 * t.wr + 15;      // the warp's last row
    int hi = rmax + 1 < cw ? rmax + 1 : cw;
    if (32 * t.wc + 32 < hi) hi = 32 * t.wc + 32;
    zero(acc);
    if (32 * t.wc <= rmax && r0 + 16 * t.wr < n && j0 < cwp)
      outer(st, MB_ROWS, i0, ilt, ldt, j0, 0, hi, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = r0 + i0 + r;
      if (i >= n || j0 >= n) continue;
      Real v[4] = {Real(0), Real(0), Real(0), Real(0)};
      load_row4(lb + off, n, i, j0, vec, v);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = j0 + c <= i ? v[c] - acc[r][c] : Real(0);
      store_row4(lb2 + off, n, i, j0, vec, v);
    }
  }
}

// (b) project, a block a (matrix, panel):
//   P^T[j][i] = Phi(sum_{k >= r0} Lb2[k][j] L[k][r0 + i]), j < cw
//   Y[r0 + i][j] = sum_{j <= k <= r0 + i} P[i][k] L^{-1}[k][j], j <= r0 + i
//   (0 above), into the workspace's second matrix
template <typename Real>
__global__ void __launch_bounds__(MB_AB_THREADS)
chol_inv_mid_bwd_project_kernel(const Real* __restrict__ l,
                                const Real* __restrict__ il,
                                const Real* __restrict__ lb2,
                                Real* __restrict__ y, int n, int panels,
                                int vec) {
  const int b = blockIdx.x / panels, p = blockIdx.x - b * panels;
  const int r0 = MB_ROWS * p, kn = n - r0;
  const int cw = r0 + MB_ROWS < n ? r0 + MB_ROWS : n, cwp = round4(cw);
  const size_t off = (size_t)b * n * n;
  Real* const smem = dynamic_smem<Real>();
  Real* const pt = smem;                       // P^T, cwp x 32
  Real* const ub = pt + cwp * MB_ROWS;         // Lb2 rows r0.., kn x cwp
  Real* const vb = ub + kn * cwp;              // L rows r0.., kn x 32
  load_strip(ub, cwp, lb2 + off, n, r0, kn, 0, cwp, vec);
  load_strip(vb, MB_ROWS, l + off, n, r0, kn, r0, MB_ROWS, vec);
  cp_async_wait_all();
  __syncthreads();

  Real acc[4][4];
  {  // (3): L[k][r0 + i] = 0 for k < r0 + i; Phi in P^T's coordinates
    const Tall t(threadIdx.x);
    const int j0 = 4 * t.rg, i0 = 4 * t.cg;
    if (16 * t.w < cw && j0 < cwp) {
      zero(acc);
      outer(ub, cwp, j0, vb, MB_ROWS, i0, 0, kn, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = r0 + i0 + c, j = j0 + r;
          acc[r][c] = i > j ? acc[r][c]
                            : (i == j ? Real(0.5) * acc[r][c] : Real(0));
        }
        st4(pt + (j0 + r) * MB_ROWS + i0, acc[r]);
      }
    }
  }
  __syncthreads();
  Real* const ils = ub;                        // L^{-1} rows < cw, cw x cwp
  load_strip(ils, cwp, il + off, n, 0, cw, 0, cwp, vec);
  cp_async_wait_all();
  __syncthreads();

  {  // (4): j <= k <= i; rows i of the panel, columns j < n
    const Wide t(threadIdx.x);
    const int i0 = 4 * t.rg, j0 = 4 * t.cg;
    const int rmax = r0 + 16 * t.wr + 15;
    const int hi = rmax + 1 < cw ? rmax + 1 : cw;
    zero(acc);
    if (32 * t.wc <= rmax && r0 + 16 * t.wr < n && j0 < cwp)
      outer(pt, MB_ROWS, i0, ils, cwp, j0, 32 * t.wc, hi, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = r0 + i0 + r;
      if (i >= n || j0 >= n) continue;
      Real v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = j0 + c <= i ? acc[r][c] : Real(0);
      store_row4(y + off, n, i, j0, vec, v);
    }
  }
}

// (c) symmetrize, a block a (matrix, tile pair I >= J), tiles of 32:
//   X(I, J) = L^{-T} Y on tile (I, J) (warps 0, 1) and X(J, I) (warps 2, 3;
//   none on the diagonal), k >= I0 (Y[k][I0 + i] = 0 below, L^{-1}[k][I0 +
//   i] too); Abar(I, J) = X(I, J) + X(J, I)^T below the diagonal, X on it,
//   zeros above it and in the mirror tile (J, I)
template <typename Real>
__global__ void __launch_bounds__(MB_C_THREADS)
chol_inv_mid_bwd_sym_kernel(const Real* __restrict__ il,
                            const Real* __restrict__ y,
                            Real* __restrict__ abar, int n, int pairs,
                            int vec) {
  const int b = blockIdx.x / pairs, q = blockIdx.x - b * pairs;
  int I = 0;
  while ((I + 1) * (I + 2) / 2 <= q) ++I;
  const int J = q - I * (I + 1) / 2;
  const int I0 = MB_ROWS * I, J0 = MB_ROWS * J, kn = n - I0;
  const bool diag = I == J;
  const size_t off = (size_t)b * n * n;
  Real* const smem = dynamic_smem<Real>();
  Real* const u1 = smem;                        // L^{-1}[k][I0 ..]
  Real* const v1 = u1 + kn * MB_ROWS;           // Y[k][J0 ..]
  Real* const u2 = v1 + kn * MB_ROWS;           // L^{-1}[k][J0 ..]
  Real* const v2 = u2 + kn * MB_ROWS;           // Y[k][I0 ..]
  Real* const xs = diag ? u2 : v2 + kn * MB_ROWS;  // X(J, I) or X(I, I)
  load_strip(u1, MB_ROWS, il + off, n, I0, kn, I0, MB_ROWS, vec);
  load_strip(v1, MB_ROWS, y + off, n, I0, kn, J0, MB_ROWS, vec);
  if (!diag) {
    load_strip(u2, MB_ROWS, il + off, n, I0, kn, J0, MB_ROWS, vec);
    load_strip(v2, MB_ROWS, y + off, n, I0, kn, I0, MB_ROWS, vec);
  }
  cp_async_wait_all();
  __syncthreads();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = w & 1, a0 = 4 * (4 * half + (lane >> 3)),
            b0 = 4 * (lane & 7);
  const bool mirror = w >= 2;  // X(J, I): rows of tile J, columns of tile I
  Real acc[4][4];
  zero(acc);
  if (!mirror)   // k >= I0 + i: from the warp's first row
    outer(u1, MB_ROWS, a0, v1, MB_ROWS, b0, 16 * half, kn, acc);
  else if (!diag)
    outer(u2, MB_ROWS, a0, v2, MB_ROWS, b0, 0, kn, acc);
  if (mirror != diag) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) xs[(a0 + r) * MB_XS_LD + b0 + c] = acc[r][c];
  }
  if (mirror && !diag) {   // tile (J, I) of Abar lies above the diagonal
    const Real z[4] = {Real(0), Real(0), Real(0), Real(0)};
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (J0 + a0 + r < n && I0 + b0 < n)
        store_row4(abar + off, n, J0 + a0 + r, I0 + b0, vec, z);
  }
  __syncthreads();
  if (mirror) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = I0 + a0 + r;
    if (i >= n || J0 + b0 >= n) continue;
    Real v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = J0 + b0 + c;
      const Real other = xs[(b0 + c) * MB_XS_LD + a0 + r];  // X[j][i]
      v[c] = i > j ? acc[r][c] + other : (i == j ? acc[r][c] : Real(0));
    }
    store_row4(abar + off, n, i, J0 + b0, vec, v);
  }
}

template <typename Real>
static cudaError_t launch(const Real* l, const Real* il, const Real* lb,
                          const Real* ilb, Real* abar, Real* work, int batch,
                          int n, int panels, int grid_ab, int grid_c,
                          int smem_ab, int smem_c, cudaStream_t s) {
  const uintptr_t ptrs = (uintptr_t)l | (uintptr_t)il | (uintptr_t)lb |
                         (uintptr_t)ilb | (uintptr_t)abar | (uintptr_t)work;
  const int vec = n % (16 / (int)sizeof(Real)) == 0 && (ptrs & 15) == 0;
  Real* const lb2 = work;
  Real* const y = work + (size_t)batch * n * n;
  static int allowed_a = 48 * 1024, allowed_b = 48 * 1024,
             allowed_c = 48 * 1024;
  cudaError_t err = allow_smem(chol_inv_mid_bwd_fold_kernel<Real>, smem_ab,
                               allowed_a);
  if (err != cudaSuccess) return err;
  err = allow_smem(chol_inv_mid_bwd_project_kernel<Real>, smem_ab, allowed_b);
  if (err != cudaSuccess) return err;
  err = allow_smem(chol_inv_mid_bwd_sym_kernel<Real>, smem_c, allowed_c);
  if (err != cudaSuccess) return err;
  chol_inv_mid_bwd_fold_kernel<Real><<<grid_ab, MB_AB_THREADS, smem_ab, s>>>(
      il, lb, ilb, lb2, n, panels, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chol_inv_mid_bwd_project_kernel<Real>
      <<<grid_ab, MB_AB_THREADS, smem_ab, s>>>(l, il, lb2, y, n, panels, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chol_inv_mid_bwd_sym_kernel<Real><<<grid_c, MB_C_THREADS, smem_c, s>>>(
      il, y, abar, n, panels * (panels + 1) / 2, vec);
  return cudaGetLastError();
}

// Plain C entry for ctypes: launches (a), (b) and (c) on the plan that
// `mid_bwd_launch_plan` made, on matrices of `itemsize`-byte values (4:
// float32, 8: float64); `work` holds two [batch, n, n] of them.  Returns
// cudaErrorInvalidValue for a plan the kernels do not take, else the first
// launch's error.
extern "C" int chol_inv_mid_bwd_launch(const void* l, const void* il,
                                       const void* lb, const void* ilb,
                                       void* abar, void* work, int batch,
                                       int n, int itemsize, int panels,
                                       int grid_ab, int grid_c,
                                       int threads_ab, int threads_c,
                                       int smem_ab, int smem_c,
                                       void* stream) {
  const long long pairs = (long long)panels * (panels + 1) / 2;
  if (n < 1 || n > 4 * MB_ROWS || batch < 1 ||
      panels != (n + MB_ROWS - 1) / MB_ROWS ||
      (long long)grid_ab != (long long)batch * panels ||
      (long long)grid_c != (long long)batch * pairs ||
      threads_ab != MB_AB_THREADS || threads_c != MB_C_THREADS ||
      (itemsize != 4 && itemsize != 8) ||
      smem_ab < ab_values(n) * itemsize || smem_c < c_values(n) * itemsize)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (itemsize == 4)
    return (int)launch<float>(
        (const float*)l, (const float*)il, (const float*)lb,
        (const float*)ilb, (float*)abar, (float*)work, batch, n, panels,
        grid_ab, grid_c, smem_ab, smem_c, s);
  return (int)launch<double>(
      (const double*)l, (const double*)il, (const double*)lb,
      (const double*)ilb, (double*)abar, (double*)work, batch, n, panels,
      grid_ab, grid_c, smem_ab, smem_c, s);
}
