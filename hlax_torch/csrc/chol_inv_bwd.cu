// chol_inv_bwd: batched pullback of (L, L^{-1}) = chol_inv(A) for small
// float32 or float64 matrices [batch, n, n], n <= 48, row-major in and out.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` (hlax/ops/linalg_small.py:
// 328-364, launched by `_chol_bwd_tpu` through `_pallas_bwd_batched`).  From
// the saved factors L, L^{-1} and the cotangents Lb, iLb of both outputs it
// computes, in five products,
//   S    = L^{-T} iLb                      (1)
//   Lb2  = Lb - tril(S L^{-T})             (2)  fold d(L^{-1}) into dL
//   P    = Phi(L^T Lb2)                    (3)
//   Y    = P L^{-1}                        (4)
//   X    = L^{-T} Y                        (5)
//   Abar = Phi(X + X^T)
// where Phi keeps the lower triangle and halves the diagonal.  Abar follows
// `_bwd_reference`'s lower convention: exact zeros above the diagonal.  hlax
// launches its kernel only for T <= 18 (the TPU's scoped VMEM); this one
// takes every n the small forward kernel takes.  On the training path it is
// the backward of the per-subject B blocks, [32, 20, 20, 20] in the GP's
// dtype (float32, or float64 with --gp_dtype=float64): one launch a train
// step.
//
// What bounds it on an H100: 4 inputs and 1 output of 640 x 1.6 KB (5.1 MB,
// 1.53 us at 3.35 TB/s; twice that in float64) against five n x n products,
// ~10 n^3 flops a matrix (0.76 us at 67 TFLOP/s float32, 1.5 us at 34
// TFLOP/s float64, for the batch at n = 20): the bound is memory in both
// dtypes, and in practice the latency of five dependent products a
// matrix.
// The launch plan is `bwd_launch_plan` in hlax_torch/ops/linalg_small.py,
// checked here.  The design:
//   * One warp a matrix, the matrix zero-padded to a compile-time NP in
//     {20, 32, 48} (exactly 20 for the canonical T = 20).  All four inputs
//     go to shared memory by cp.async (16-byte copies where a row holds a
//     whole number of them, n a multiple of 4 floats or 2 doubles, and the
//     pointers are aligned; one value a copy otherwise), every copy in
//     flight before the one wait.
//   * Each lane owns fixed 4 x 4 subtiles of the NP x NP result, worked out
//     once a product from its index with no division by a runtime value:
//     at NP = 20, 25 subtiles, one a lane.  Each product is an
//     outer-product loop over k into 16 independent fused multiply-adds,
//     fed by one 4-value read of each operand at row k (a float4, or two
//     double2).  An operand read by
//     columns is stored transposed (L^{-T} once at the start; S and P by the
//     epilogue of the product that makes them), so every read is a row
//     read: lanes that share a row of subtiles read the same address, the
//     rest neighbouring ones.
//   * The zeros are skipped: the k-range of each subtile is cut, in chunks
//     of 4, to where the triangular factors are nonzero, and the products
//     whose result is lower-triangular (2, 3, 4) skip the subtiles above the
//     diagonal.  Phi and the symmetrisation are the epilogues of products 3
//     and 5; the final one is fused into the store of Abar.
//   * Six NP x NP buffers a matrix (9.6 KB at n = 20 in float32; 110.6 KB
//     at NP = 48 in float64, still one matrix a block), one __syncwarp
//     between products.  Two warps a matrix (2 x 4 subtiles a lane, a named
//     barrier between products) measured slower on the H100 (PERF.md):
//     they halve each lane's multiply-adds but not its chain of k-steps.
// No tensor cores: TF32 keeps ~3 digits and fails the float64 check, and
// the five products are ~1,250 fused multiply-adds a lane at n = 20, which
// the FP32 pipes do in well under a microsecond; 3xTF32 mma.sync is not
// needed at this size.  Built with FMA contraction
// (hlax_torch/ops/cuda_build.py): it sums in another order than the plain
// version (`_bwd_reference`, batched cuBLAS products): on float32 inputs it
// is held to a float64 reference, on float64 inputs to the plain version's
// own error bar (chip_smoke.py, tests/test_torch_cuda.py).
#include <cstdint>

#include "chol_inv_common.cuh"

#define BWD_BUFS 6  // NP x NP buffers a matrix

// acc[r][c] = sum_k U[k][i0 + r] V[k][j0 + c] over the k-chunks [lo, hi) of
// 4; U and V are NP x NP, row-major.
template <typename Real, int NP>
__device__ __forceinline__ void tile_product(const Real* U, const Real* V,
                                             int i0, int j0, int lo, int hi,
                                             Real (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;
#pragma unroll
  for (int kc = 0; kc < NP / 4; ++kc) {
    if (kc < lo || kc >= hi) continue;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 4 * kc + kk;
      Real u[4], v[4];
      ld4(U + k * NP + i0, u);
      ld4(V + k * NP + j0, v);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += u[r] * v[c];
    }
  }
}

// acc transposed into D at rows [j0, j0 + 4), columns [i0, i0 + 4)
template <typename Real, int NP>
__device__ __forceinline__ void store_transposed(Real* D, int i0, int j0,
                                                 const Real (&acc)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const Real u[4] = {acc[0][c], acc[1][c], acc[2][c], acc[3][c]};
    st4(D + (j0 + c) * NP + i0, u);
  }
}

template <typename Real, int NP>
__global__ void __launch_bounds__(128)
chol_inv_bwd_kernel(const Real* __restrict__ l, const Real* __restrict__ il,
                    const Real* __restrict__ lb,
                    const Real* __restrict__ ilb, Real* __restrict__ abar,
                    int batch, int n, int vec) {
  constexpr int NTC = NP / 4;     // subtiles along a row; also k-chunks
  constexpr int NTILES = NTC * NTC;
  constexpr int NN = NP * NP;
  constexpr int V = 16 / sizeof(Real);  // values a 16-byte copy
  Real* const smem = dynamic_smem<Real>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;  // whole warps leave; no block barrier follows
  Real* const B0 = smem + warp * BWD_BUFS * NN;   // L, then X
  Real* const B1 = B0 + NN;                       // L^{-1}
  Real* const B2 = B1 + NN;                       // L^{-T}
  Real* const B3 = B2 + NN;                       // Lb, then Lb2
  Real* const B4 = B3 + NN;                       // iLb, then P^T
  Real* const B5 = B4 + NN;                       // S^T, then Y
  const int nn = n * n;
  const size_t off = (size_t)b * nn;

  // the four inputs in, zero-padded to NP: every copy in flight, one wait
  if (vec) {  // n % V == 0: a 16-byte copy stays inside a row
    const int qr = n / V;
    const float rq = 1.f / qr;
    for (int q = lane; q < nn / V; q += 32) {
      const int i = (int)((q + 0.5f) * rq), c = V * (q - i * qr);
      const size_t g = off + V * (size_t)q;
      cp_async16(B0 + i * NP + c, l + g);
      cp_async16(B1 + i * NP + c, il + g);
      cp_async16(B3 + i * NP + c, lb + g);
      cp_async16(B4 + i * NP + c, ilb + g);
    }
  } else {
    const float rn = 1.f / n;
    for (int e = lane; e < nn; e += 32) {
      const int i = (int)((e + 0.5f) * rn), c = e - i * n;
      cp_async1(B0 + i * NP + c, l + off + e);
      cp_async1(B1 + i * NP + c, il + off + e);
      cp_async1(B3 + i * NP + c, lb + off + e);
      cp_async1(B4 + i * NP + c, ilb + off + e);
    }
  }
  if (n < NP)
    for (int e = lane; e < NN; e += 32) {
      const int i = e / NP, c = e % NP;
      if (i >= n || c >= n) B0[e] = B1[e] = B3[e] = B4[e] = 0;
    }
  cp_async_wait_all();
  __syncwarp();

  Real acc[4][4];
  // (1) S = L^{-T} iLb, k >= i, stored transposed; L^{-1} transposed beside
#pragma unroll 1
  for (int t = lane; t < NTILES; t += 32) {
    const int i0 = 4 * (t / NTC), j0 = 4 * (t % NTC);
    tile_product<Real, NP>(B1, B4, i0, j0, i0 / 4, NTC, acc);
    store_transposed<Real, NP>(B5, i0, j0, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) ld4(B1 + (i0 + r) * NP + j0, acc[r]);
    store_transposed<Real, NP>(B2, i0, j0, acc);
  }
  __syncwarp();

  // (2) Lb2 = Lb - tril(S L^{-T}): (S L^{-T})[i][j] = sum_{k <= j} S[i][k]
  //     L^{-1}[j][k]; lower subtiles, in place on this lane's own entries
#pragma unroll 1
  for (int t = lane; t < NTILES; t += 32) {
    const int i0 = 4 * (t / NTC), j0 = 4 * (t % NTC);
    if (i0 < j0) continue;
    tile_product<Real, NP>(B5, B2, i0, j0, 0, j0 / 4 + 1, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      Real v[4];
      ld4(B3 + (i0 + r) * NP + j0, v);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j0 + c <= i0 + r) v[c] -= acc[r][c];
      st4(B3 + (i0 + r) * NP + j0, v);
    }
  }
  __syncwarp();

  // (3) P = Phi(L^T Lb2), k >= i, stored transposed (zeros above the
  //     diagonal of P, below that of P^T)
#pragma unroll 1
  for (int t = lane; t < NTILES; t += 32) {
    const int i0 = 4 * (t / NTC), j0 = 4 * (t % NTC);
    if (i0 < j0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0;
    } else {
      tile_product<Real, NP>(B0, B3, i0, j0, i0 / 4, NTC, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = i0 + r, j = j0 + c;
          acc[r][c] = i > j ? acc[r][c]
                            : (i == j ? Real(0.5) * acc[r][c] : Real(0));
        }
    }
    store_transposed<Real, NP>(B4, i0, j0, acc);
  }
  __syncwarp();

  // (4) Y = P L^{-1}: j <= k <= i; lower subtiles (exact zeros above)
#pragma unroll 1
  for (int t = lane; t < NTILES; t += 32) {
    const int i0 = 4 * (t / NTC), j0 = 4 * (t % NTC);
    if (i0 < j0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0;
    } else {
      tile_product<Real, NP>(B4, B1, i0, j0, j0 / 4, i0 / 4 + 1, acc);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) st4(B5 + (i0 + r) * NP + j0, acc[r]);
  }
  __syncwarp();

  // (5) X = L^{-T} Y: k >= max(i, j)
#pragma unroll 1
  for (int t = lane; t < NTILES; t += 32) {
    const int i0 = 4 * (t / NTC), j0 = 4 * (t % NTC);
    tile_product<Real, NP>(B1, B5, i0, j0, (i0 > j0 ? i0 : j0) / 4, NTC,
                           acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) st4(B0 + (i0 + r) * NP + j0, acc[r]);
  }
  __syncwarp();

  // Abar = Phi(X + X^T) out: X[i][j] + X[j][i] below the diagonal, X[i][i]
  // on it (0.5 (x + x) is exact), zeros above
  if (vec) {
    const int qr = n / V;
    const float rq = 1.f / qr;
    for (int q = lane; q < nn / V; q += 32) {
      const int i = (int)((q + 0.5f) * rq), c = V * (q - i * qr);
      Real u[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int j = c + k;
        u[k] = i > j ? B0[i * NP + j] + B0[j * NP + i]
                     : (i == j ? B0[i * NP + i] : Real(0));
      }
      st16(abar + off + V * q, u);
    }
  } else {
    const float rn = 1.f / n;
    for (int e = lane; e < nn; e += 32) {
      const int i = (int)((e + 0.5f) * rn), j = e - i * n;
      abar[off + e] = i > j ? B0[i * NP + j] + B0[j * NP + i]
                            : (i == j ? B0[i * NP + i] : Real(0));
    }
  }
}

template <typename Real, int NP>
static cudaError_t launch_np(const Real* l, const Real* il, const Real* lb,
                             const Real* ilb, Real* abar, int batch, int n,
                             int vec, int grid, int threads, int smem,
                             cudaStream_t s) {
  if ((threads / 32) * BWD_BUFS * NP * NP * (int)sizeof(Real) > smem)
    return cudaErrorInvalidValue;
  static int allowed = 48 * 1024;
  const cudaError_t err =
      allow_smem(chol_inv_bwd_kernel<Real, NP>, smem, allowed);
  if (err != cudaSuccess) return err;
  chol_inv_bwd_kernel<Real, NP><<<grid, threads, smem, s>>>(
      l, il, lb, ilb, abar, batch, n, vec);
  return cudaGetLastError();
}

template <typename Real>
static cudaError_t launch(const void* l, const void* il, const void* lb,
                          const void* ilb, void* abar, int batch, int n,
                          int np, int grid, int threads, int smem,
                          cudaStream_t s) {
  const uintptr_t ptrs = (uintptr_t)l | (uintptr_t)il | (uintptr_t)lb |
                         (uintptr_t)ilb | (uintptr_t)abar;
  const int vec = n % (16 / (int)sizeof(Real)) == 0 && (ptrs & 15) == 0;
  const Real *L = (const Real*)l, *IL = (const Real*)il,
             *LB = (const Real*)lb, *ILB = (const Real*)ilb;
  Real* A = (Real*)abar;
  switch (np) {
    case 20: return launch_np<Real, 20>(L, IL, LB, ILB, A, batch, n, vec,
                                        grid, threads, smem, s);
    case 32: return launch_np<Real, 32>(L, IL, LB, ILB, A, batch, n, vec,
                                        grid, threads, smem, s);
    case 48: return launch_np<Real, 48>(L, IL, LB, ILB, A, batch, n, vec,
                                        grid, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

// Plain C entry for ctypes: launches the plan that `bwd_launch_plan` made
// (padded size np, one warp a matrix) on matrices of `itemsize`-byte values
// (4: float32, 8: float64).  Returns cudaErrorInvalidValue for a plan the
// kernel does not take, else cudaGetLastError() after the launch.
extern "C" int chol_inv_bwd_launch(const void* l, const void* il,
                                   const void* lb, const void* ilb,
                                   void* abar, int batch, int n,
                                   int itemsize, int np, int grid,
                                   int threads, int smem, void* stream) {
  if (n < 1 || n > np || threads % 32 || threads < 32 || threads > 128 ||
      (long long)grid * (threads / 32) < batch)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (itemsize == 4)
    return (int)launch<float>(l, il, lb, ilb, abar, batch, n, np, grid,
                              threads, smem, s);
  if (itemsize == 8)
    return (int)launch<double>(l, il, lb, ilb, abar, batch, n, np, grid,
                               threads, smem, s);
  return (int)cudaErrorInvalidValue;
}
