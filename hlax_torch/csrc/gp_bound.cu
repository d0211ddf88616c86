// gp_bound: hand-written kernels for XLA's fusion of hlax's KL bound
// (kld_upper_bound, hlax/gp/elbo.py:154-235): the terms A, Bt, C, D, E, F
// of the subjects' fit and the KL of the inducing points, their sums to
// scalars and the assembly of kld_total, forward and backward.  hlax jits
// the bound and XLA folds these chains into a few fusions around its dots;
// the port ran them op by op (hlax_torch/ops/gp_bound.py's plain version).
// No TPU kernel: the Pallas kernels of hlax are the Cholesky factors
// (csrc/chol_inv_*.cu), whose cotangents the backward here feeds.
//
// With, for each latent l and subject s (K0xz_s [T, M], iB_s = B_s^-1
// [T, T], mu, log_v, valid [S, T], iK = K0zz^-1, m [M], H [M, M]):
//   iKm = iK m,  fit = K0xz_s iKm,  r = fit - mu valid
//   A = sum r^T iB r,  Bt = sum diag(iB) exp(log_v) valid,
//   C = 2 sum log diag LB,  W_s = iB_s K0xz_s,  Kz = sum_s K0xz_s^T W_s,
//   D = sum iB o K0_st - sum Kz o iK,  E = sum (iK H iK) o Kz,
//   F = sum log_v valid,  kqu = (tr(iK H^T) + m^T iK m - L M
//                                + logdet K0zz - logdet H) / 2
//   kld_total = P_tot / P_batch (A + Bt + C + D + E - F) / 2 + kqu
//               - L N_tot / 2,
// the products iKm, Kz, (iK H) iK and their backward products are
// cuBLAS's (the wrapper's torch.bmm, as hlax leaves its dots to XLA); the
// rest is four kernels, each a template on float and double:
//
//   gp_bound_fwd_subjects (K1): a block a (latent, chunk of subjects); fit,
//     r, q = (iB + iB^T) r (A's cotangent direction, saved), W = iB K0xz,
//     and the block's partials of A, Bt, C/2, sum iB o K0_st, F and of
//     u = sum_s K0xz_s^T q_s (the cotangent direction of iKm).  With float
//     inputs it also writes K0xz and W in double: the sums of KziBK o
//     iK0zz and E_mat o KziBK cancel ~1e6-fold at the canonical state
//     (iK0zz's entries reach ~1e4), so float32 rounding of KziBK makes E
//     noise of +-100s; KziBK's product in double (the wrapper's) keeps it
//     to the rounding of E_mat.
//   gp_bound_fwd_latents (K2): a block a (latent, part of the rows of the
//     M x M matrices); sum Kz o iK, sum E o Kz, tr(iK H^T), m . iKm and the
//     log-diagonals of the factors; u from K1's partials; the grid's last
//     block adds every partial in a fixed order, in double, into the terms
//     (A, Bt, C, D, E, F, kqu), P_batch and, without a mesh, kld_total.
//   gp_bound_bwd_latents (K4): from the terms' and kld_total's cotangents,
//     G = dKz = -w_D iK + w_E E_mat with its transpose beside it (for the
//     one cuBLAS product K0xz [G | G^T]), d iK's sum (its products' parts
//     come from cuBLAS), d H, d m and the diagonal cotangents of the
//     factors of K0zz and H.
//   gp_bound_bwd_subjects (K3): d K0xz = w_A q iKm^T + iB (K0xz G^T)
//     + iB^T (K0xz G), d iB = w_A r r^T + w_Bt diag(v) + w_D K0_st
//     + (K0xz G) K0xz^T, then d iLB = iLB (d iB + d iB^T) (iB = iLB^T
//     iLB), d K0_st, d diag LB, d mu, d log_v.  K0xz [G | G^T] is cuBLAS's
//     product (in-kernel, a subject at a time, it timed 3-4x slower).
//
// What bounds them on an H100 at the canonical [L, S, T, M] = [32, 20, 20,
// 120], float32: bytes.  K1 reads K0xz (6.1 MB) and the [T, T] blocks
// (0.5 MB each) and writes W (6.1 MB): ~3.8 us at 3.35 TB/s against 0.13
// GFLOP (~2 us at 67 TFLOP/s).  K3 reads K0xz and K0xz [G | G^T] (18 MB)
// and writes d K0xz: ~8 us.  K2 and K4 read and write a few [L, M, M]
// matrices (1.8 MB each).  Their design: a block of NT threads; a subject
// of a training batch (T <= TP) is staged in shared memory and its [T, T]
// products run there as register tiles (tile_products); the long
// sequences' subjects (T = 200, 500: [T, T] by [T, M] products per
// subject) leave those products to cuBLAS and take the kernels'
// elementwise work and sums only; every sum to a scalar is a double, a
// thread's in a fixed order, a warp's
// by a butterfly, a block's in warp order, the blocks' partials in block
// order by the last block, so a CUDA graph replays the eager call's bits
// and no float atomic is used.  The latent kernels stage the transposed
// rows they need (H^T, iK^T, E^T) in shared memory by cp.async element
// copies.  The counter of K2's last block is zero between launches (that
// block zeroes it), so the wrapper's per-stream buffer needs no fill.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads a block, every kernel
constexpr int NW = NT / 32;      // warps a block
constexpr int NSUB = 5;          // a subject block's scalar partials
constexpr int NLAT = 6;          // a latent block's scalar partials
constexpr int NTERM = 7;         // A, Bt, C, D, E, F, kqu
constexpr int MAX_M = 2 * NT;    // the M a subject block's u columns take
// blocks an SM the subject kernels' launch bounds ask registers for: K1
// two (128 a thread), K3 three (80); on the H100 each timed fastest so
// against 2, 3 and 4 (fewer registers spill)
constexpr int FWD_SUBJECT_BLOCKS = 2, BWD_SUBJECT_BLOCKS = 3;
// the staged subject path: subjects of at most TP rows (a row a lane),
// its products' register tiles RR rows by RC columns a thread
constexpr int TP = 32, RR = 3, RC = 4;

template <typename T> __device__ inline T warp_sum(T v) {
  // a butterfly: every lane ends with the same bits
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's totals of the NV doubles v (every thread's own), summed by
// warp butterflies and then in warp order; red: NW * NV shared doubles,
// out: NV shared doubles, read after this returns.
template <int NV>
__device__ void block_sum(const double (&v)[NV], double* red, double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < NV; ++j) {
    const double s = warp_sum(v[j]);
    if (lane == 0) red[warp * NV + j] = s;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    double s = red[threadIdx.x];
    for (int w = 1; w < NW; ++w) s += red[w * NV + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

template <int N>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// The block's share of copying src[0, n) to dst by cp.async: 16-byte
// vectors where both are 16-byte aligned, single elements else and at the
// end (committed and waited by the caller)
template <typename T>
__device__ void stage(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  const int nv =
      (((uintptr_t)src | (uintptr_t)dst) & 15) == 0 ? n / V : 0;
  for (int k = threadIdx.x; k < nv; k += NT) cp_async16(dst + k * V, src + k * V);
  for (int e = nv * V + threadIdx.x; e < n; e += NT)
    cp_async_elem<sizeof(T)>(dst + e, src + e);
}

// consecutive 16-byte aligned regions of the dynamic shared memory, in
// the order the wrapper's plan counts them (subject_smem,
// hlax_torch/ops/gp_bound.py)
struct Carve {
  unsigned char* p;
  template <typename T> __device__ T* take(int n) {
    T* r = reinterpret_cast<T*>(p);
    p += (n * sizeof(T) + 15) / 16 * 16;
    return r;
  }
};

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// dst[i (M + 1) + n] = src[n M + m0 + i] for i < nr, n < M: rows m0.. of
// src^T, staged by cp.async (committed and waited by the caller); the
// global reads run along i, the shared rows padded against bank conflicts
template <typename T>
__device__ void stage_transposed(T* dst, const T* src, int M, int m0,
                                 int nr) {
  for (int e = threadIdx.x; e < nr * M; e += NT) {
    const int n = e / nr, i = e % nr;
    cp_async_elem<sizeof(T)>(dst + i * (M + 1) + n,
                             src + (size_t)n * M + m0 + i);
  }
}

// The scalar cotangents of the terms (A, Bt, C, D, E, F, kqu) from the
// Function's: gterms [NTERM] and gkld (kld_total's; null: zero), kld_total
// = P_tot / P_batch (A + Bt + C + D + E - F) / 2 + kqu - L N_tot / 2.
template <typename T>
__device__ void term_weights(const T* gterms, const T* gkld, const T* pbatch,
                             double ptot, double (&w)[NTERM]) {
  const double gk = gkld ? (double)*gkld : 0.0;
  const double half = ptot / (double)*pbatch * 0.5;
  for (int j = 0; j < NTERM; ++j) {
    const double coef = j < 5 ? half : j == 5 ? -half : 1.0;
    w[j] = (gterms ? (double)gterms[j] : 0.0) + gk * coef;
  }
}

// Whether this block is the last of nblk to arrive at counter (each block
// having written its partials first); the last zeroes the counter for the
// next launch.  The same in every thread of the block.
__device__ bool last_block(int* counter, int nblk) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == nblk - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    if (threadIdx.x == 0) *counter = 0;
  }
  return last;
}

// the sum of the n doubles src[j * step], j = j0, j0 + gap, ..., in a
// fixed order: four running sums over consecutive entries (their loads in
// flight together), then added pairwise
__device__ double sum_fixed(const double* src, int j0, int n, int gap,
                            size_t step) {
  double a[4] = {0.0, 0.0, 0.0, 0.0};
  int j = j0;
  for (; j + 3 * gap < n; j += 4 * gap) {
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] += __ldcg(src + (j + k * gap) * step);
  }
  for (; j < n; j += gap) a[0] += __ldcg(src + j * step);
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// the sum of n doubles src[j * stride] in a fixed order: each lane of the
// warp its entries (sum_fixed), then a butterfly (every lane the total)
__device__ double warp_sum_strided(const double* src, int n, int stride) {
  return warp_sum(sum_fixed(src, threadIdx.x & 31, n, 32, stride));
}

// The staged path's products: out(t, m) = sum_u A(t, u) B(u, m) [+ sum_u
// A2(t, u) B2(u, m) with ``two``] for t < nr, m < nc, the depth nr, all
// operands in shared memory.  A thread holds RR rows by RC columns
// (columns lane + 32 j of a block of 32 RC, so a warp's reads of a B row
// are consecutive and its reads of A the same address): RR + RC loads
// for RR RC multiply-adds.
template <typename T, class FA, class FB, class FA2, class FB2, class Put>
__device__ void tile_products(int nr, int nc, FA fa, FB fb, FA2 fa2,
                              FB2 fb2, Put put, bool two) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ngr = (nr + RR - 1) / RR, ncb = (nc + 32 * RC - 1) / (32 * RC);
  for (int task = warp; task < ngr * ncb; task += NW) {
    const int t0 = (task / ncb) * RR, m0 = (task % ncb) * 32 * RC + lane;
    T a[RR][RC];
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) a[i][j] = T(0);
    for (int u = 0; u < nr; ++u) {
      T x[RC], y[RC];
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const int m = m0 + 32 * j;
        x[j] = m < nc ? fb(u, m) : T(0);
        y[j] = two && m < nc ? fb2(u, m) : T(0);
      }
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        const int t = t0 + i < nr ? t0 + i : nr - 1;
        const T b = fa(t, u), b2 = two ? fa2(t, u) : T(0);
#pragma unroll
        for (int j = 0; j < RC; ++j)
          a[i][j] = two ? fma(b, x[j], fma(b2, y[j], a[i][j]))
                        : fma(b, x[j], a[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RR; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const int t = t0 + i, m = m0 + 32 * j;
        if (t < nr && m < nc) put(t, m, a[i][j]);
      }
  }
}

// ------------------------------------------------------------------ K1
//
// Two paths, the plan's choice (``staged``): for T <= TP (every training
// batch but the long sequences') a subject's K0xz, iB, K0_st and its rows'
// scalars are staged in shared memory by cp.async and every product reads
// them there: the fit a warp a row, q a thread a row, iB K0xz as register
// tiles; longer subjects are read from global memory and their iB K0xz is
// cuBLAS's (the wrapper's).

template <typename T>
__global__ void __launch_bounds__(NT, FWD_SUBJECT_BLOCKS) gp_bound_fwd_subjects_kernel(
    const T* __restrict__ K0xz, const T* __restrict__ iB,
    const T* __restrict__ K0st, const T* __restrict__ LB,
    const T* __restrict__ iKm, const T* __restrict__ mu,
    const T* __restrict__ lv, const T* __restrict__ valid,
    T* __restrict__ W, double* __restrict__ K64, double* __restrict__ W64,
    T* __restrict__ r, T* __restrict__ q, double* __restrict__ part, int S,
    int Tn, int M, int ldm, int chunk, int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double red[NW * NSUB], tot[NSUB];
  const int l = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const T* km = iKm + (size_t)l * M;
  Carve cv{smem_raw};
  T *kxs = nullptr, *bss = nullptr, *kss = nullptr, *rsh = nullptr,
    *qsh = nullptr, *kms = nullptr, *row = nullptr;
  if (staged) {
    kxs = cv.take<T>(Tn * M);
    bss = cv.take<T>(Tn * Tn);
    kss = cv.take<T>(Tn * Tn);
    rsh = cv.take<T>(Tn);
    qsh = cv.take<T>(Tn);
    kms = cv.take<T>(M);
    row = cv.take<T>(4 * Tn);    // a row's mu, valid, log_v, LB diagonal
    stage(kms, km, M);
  }
  // A, Bt, sum log diag LB, sum iB o K0_st, F
  double acc[NSUB] = {0.0, 0.0, 0.0, 0.0, 0.0};
  double uacc[MAX_M / NT] = {0.0, 0.0};
  const int s1 = min(S, ((int)blockIdx.x + 1) * chunk);
  for (int s = (int)blockIdx.x * chunk; s < s1; ++s) {
    const size_t ls = (size_t)l * S + s, st0 = (size_t)s * Tn;
    const T* kx = K0xz + ls * Tn * M;
    const T* bs = iB + ls * Tn * Tn;
    const T* ks = K0st + ls * Tn * Tn;
    T* rs = r + ls * Tn;
    T* qs = q + ls * Tn;
    if (staged) {
      stage(kxs, kx, Tn * M);
      stage(bss, bs, Tn * Tn);
      stage(kss, ks, Tn * Tn);
      stage(row + Tn, valid + st0, Tn);
      for (int t = tid; t < Tn; t += NT) {
        cp_async_elem<sizeof(T)>(row + t, mu + (st0 + t) * ldm + l);
        cp_async_elem<sizeof(T)>(row + 2 * Tn + t, lv + (st0 + t) * ldm + l);
        cp_async_elem<sizeof(T)>(row + 3 * Tn + t,
                                 LB + ls * Tn * Tn + (size_t)t * (Tn + 1));
      }
      cp_async_wait_all();
      __syncthreads();
      kx = kxs;
      bs = bss;
      ks = kss;
      km = kms;
    }
    // fit and r: a warp a row
    for (int t = warp; t < Tn; t += NW) {
      T f = T(0);
      for (int n = lane; n < M; n += 32) f = fma(kx[t * M + n], km[n], f);
      f = warp_sum(f);
      if (lane == 0) {
        const T rt = f - (staged ? row[t] * row[Tn + t]
                                 : mu[(st0 + t) * ldm + l] * valid[st0 + t]);
        rs[t] = rt;
        if (staged) rsh[t] = rt;
      }
    }
    __syncthreads();
    const T* rr = staged ? rsh : rs;
    // iB r, iB^T r, q, and the per-row terms: a thread a row
    for (int t = tid; t < Tn; t += NT) {
      T rw = T(0), cl = T(0);
      for (int u = 0; u < Tn; ++u) {
        const T ru = rr[u];
        rw = fma(bs[t * Tn + u], ru, rw);
        cl = fma(bs[u * Tn + t], ru, cl);
      }
      qs[t] = rw + cl;
      if (staged) qsh[t] = rw + cl;
      const T v = staged ? row[Tn + t] : valid[st0 + t];
      const T x = staged ? row[2 * Tn + t] : lv[(st0 + t) * ldm + l];
      const T d = staged ? row[3 * Tn + t]
                         : LB[ls * Tn * Tn + (size_t)t * (Tn + 1)];
      acc[0] += (double)rr[t] * (double)rw;
      acc[1] += (double)(bs[t * Tn + t] * (exp(x) * v));
      acc[2] += (double)log(d);
      acc[4] += (double)(x * v);
    }
    for (int e = tid; e < Tn * Tn; e += NT)
      acc[3] += (double)(bs[e] * ks[e]);
    __syncthreads();
    const T* qq = staged ? qsh : qs;
    // u's part: sum_t K0xz[t, n] q[t]
    for (int k = 0; k < MAX_M / NT; ++k) {
      const int n = tid + k * NT;
      if (n >= M) break;
      double u = 0.0;
      for (int t = 0; t < Tn; ++t) u += (double)(kx[t * M + n] * qq[t]);
      uacc[k] += u;
    }
    // staged: W = iB K0xz, summed in double; with W64 (float inputs) kept
    // in double beside K0xz's values, for KziBK's product in double (the
    // longer subjects' W is cuBLAS's, the wrapper's)
    if (staged) {
      T* ws = W + ls * Tn * M;
      double* w64 = W64 ? W64 + ls * Tn * M : nullptr;
      if (K64)
        for (int e = tid; e < Tn * M; e += NT) K64[ls * Tn * M + e] = kx[e];
      tile_products<double>(
          Tn, M, [&](int t, int u) { return (double)bs[t * Tn + u]; },
          [&](int u, int m) { return (double)kx[u * M + m]; },
          [&](int, int) { return 0.0; }, [&](int, int) { return 0.0; },
          [&](int t, int m, double a) {
            ws[t * M + m] = (T)a;
            if (w64) w64[t * M + m] = a;
          }, false);
      __syncthreads();   // before the next subject's copies
    }
  }
  block_sum(acc, red, tot);
  double* p = part + ((size_t)l * gridDim.x + blockIdx.x) * (NSUB + M);
  if (tid < NSUB) p[tid] = tot[tid];
  for (int k = 0; k < MAX_M / NT; ++k) {
    const int n = tid + k * NT;
    if (n < M) p[NSUB + n] = uacc[k];
  }
}

// ------------------------------------------------------------------ K2

template <typename T>
__global__ void __launch_bounds__(NT) gp_bound_fwd_latents_kernel(
    const T* __restrict__ iK, const double* __restrict__ Kz,
    const T* __restrict__ Em, const T* __restrict__ H,
    const T* __restrict__ m, const T* __restrict__ iKm,
    const T* __restrict__ LK, const T* __restrict__ LH,
    const T* __restrict__ valid, const double* __restrict__ part1,
    int nchunks, double* __restrict__ part2, double* __restrict__ u,
    T* __restrict__ terms, T* __restrict__ pbatch, T* __restrict__ kld,
    int* counter, int L, int S, int Tn, int M, int rows, double ptot,
    double ntot) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* HT = reinterpret_cast<T*>(smem_raw);          // rows x (M + 1)
  __shared__ double red[NW * NLAT], tot[NLAT];
  __shared__ double sums[NSUB + NLAT + 1];
  const int l = blockIdx.y, tid = threadIdx.x;
  if (tid == 0) sums[NSUB + NLAT] = 0.0;
  const int m0 = (int)blockIdx.x * rows, nr = min(rows, M - m0);
  const size_t mat = (size_t)l * M * M;
  stage_transposed(HT, H + mat, M, m0, nr);
  cp_async_wait_all();
  __syncthreads();
  // sum Kz o iK, sum E o Kz, tr(iK H^T), m . iKm, log diag LK, log diag LH
  double acc[NLAT] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
  for (int e = tid; e < nr * M; e += NT) {
    const int i = e / M, n = e % M;
    const size_t x = mat + (size_t)(m0 + i) * M + n;
    const T k = iK[x];
    const double z = Kz[x];
    acc[0] += z * k;
    acc[1] += Em[x] * z;
    acc[2] += (double)(k * HT[i * (M + 1) + n]);
  }
  for (int i = tid; i < nr; i += NT) {
    const int mm = m0 + i;
    acc[3] += (double)(m[(size_t)l * M + mm] * iKm[(size_t)l * M + mm]);
    acc[4] += (double)log(LK[mat + (size_t)mm * (M + 1)]);
    acc[5] += (double)log(LH[mat + (size_t)mm * (M + 1)]);
    // u: the subject blocks' parts in a fixed order
    u[(size_t)l * M + mm] = sum_fixed(
        part1 + (size_t)l * nchunks * (NSUB + M) + NSUB + mm, 0, nchunks, 1,
        NSUB + M);
  }
  block_sum(acc, red, tot);
  double* p = part2 + ((size_t)l * gridDim.x + blockIdx.x) * NLAT;
  if (tid < NLAT) p[tid] = tot[tid];
  if (!last_block(counter, gridDim.x * gridDim.y)) return;
  // the last block: every partial, a sum a warp, in block order
  const int lane = tid & 31, warp = tid >> 5;
  for (int j = warp; j < NSUB + NLAT; j += NW) {
    const double s =
        j < NSUB ? warp_sum_strided(part1 + j, L * nchunks, NSUB + M)
                 : warp_sum_strided(part2 + (j - NSUB),
                                    L * gridDim.x, NLAT);
    if (lane == 0) sums[j] = s;
  }
  // P_batch: the subjects with a valid row, a warp a subject at a time
  __shared__ double count[NW];
  double n = 0.0;
  for (int s = warp; s < S; s += NW) {
    bool any = false;
    for (int t = lane; t < Tn; t += 32) any |= valid[(size_t)s * Tn + t] > T(0);
    n += __any_sync(0xffffffffu, any) ? 1.0 : 0.0;
  }
  if (lane == 0) count[warp] = n;
  __syncthreads();
  if (tid == 0) {
    for (int w = 0; w < NW; ++w) sums[NSUB + NLAT] += count[w];
    const double* a = sums;
    const double* b = sums + NSUB;
    const double A = a[0], Bt = a[1], C = 2.0 * a[2], D = a[3] - b[0];
    const double E = b[1], F = a[4];
    const double kqu = 0.5 * (b[2] + b[3] - (double)L * M + 2.0 * b[4]
                              - 2.0 * b[5]);
    const double t[NTERM] = {A, Bt, C, D, E, F, kqu};
    for (int j = 0; j < NTERM; ++j) terms[j] = (T)t[j];
    const double P = sums[NSUB + NLAT];
    *pbatch = (T)P;
    if (kld)
      *kld = (T)(ptot / P * 0.5 * (A + Bt + C + D + E - F) + kqu
                 - (double)L * ntot / 2.0);
  }
}

// ------------------------------------------------------------------ K4

template <typename T>
__global__ void __launch_bounds__(NT) gp_bound_bwd_latents_kernel(
    const T* __restrict__ gterms, const T* __restrict__ gkld,
    const T* __restrict__ pbatch, double ptot, const T* __restrict__ iK,
    const T* __restrict__ Kz, const T* __restrict__ Em,
    const T* __restrict__ H, const T* __restrict__ m,
    const T* __restrict__ iKm, const double* __restrict__ u,
    const T* __restrict__ LK, const T* __restrict__ LH,
    const T* __restrict__ R1, const T* __restrict__ R2,
    const T* __restrict__ R3, T* __restrict__ G2, T* __restrict__ dIK,
    T* __restrict__ dH, T* __restrict__ dm, T* __restrict__ dLK,
    T* __restrict__ dLH, int M, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int l = blockIdx.y, tid = threadIdx.x;
  const int m0 = (int)blockIdx.x * rows, nr = min(rows, M - m0);
  const int ld = M + 1;
  T* HT = reinterpret_cast<T*>(smem_raw);           // rows x ld each
  T* KT = HT + rows * ld;
  T* ET = KT + rows * ld;
  double* v = reinterpret_cast<double*>(
      smem_raw + ((3 * rows * ld * sizeof(T) + 15) / 16) * 16);   // [M]
  const size_t mat = (size_t)l * M * M;
  stage_transposed(HT, H + mat, M, m0, nr);
  stage_transposed(KT, iK + mat, M, m0, nr);
  stage_transposed(ET, Em + mat, M, m0, nr);
  double w[NTERM];
  term_weights(gterms, gkld, pbatch, ptot, w);
  const double wa = w[0], wd = w[3], we = w[4], wk = w[6];
  // d iKm's share of d iK and d m: v = w_A u + w_kqu m / 2
  for (int n = tid; n < M; n += NT)
    v[n] = wa * u[(size_t)l * M + n] + 0.5 * wk * (double)m[(size_t)l * M + n];
  cp_async_wait_all();
  __syncthreads();
  for (int e = tid; e < nr * M; e += NT) {
    const int i = e / M, n = e % M, mm = m0 + i;
    const size_t x = mat + (size_t)mm * M + n;
    const double k = iK[x], kt = KT[i * ld + n];
    const size_t g = ((size_t)l * M + mm) * 2 * M + n;
    G2[g] = (T)(-wd * k + we * (double)Em[x]);
    G2[g + M] = (T)(-wd * kt + we * (double)ET[i * ld + n]);
    dIK[x] = (T)(-wd * (double)Kz[x] + 0.5 * wk * (double)HT[i * ld + n]
                 + v[mm] * (double)m[(size_t)l * M + n]
                 + we * ((double)R1[x] + (double)R2[x]));
    if (dH) dH[x] = (T)(0.5 * wk * kt + we * (double)R3[x]);
    if (dLK) {
      const bool d = mm == n;
      dLK[x] = d ? (T)(wk / (double)LK[x]) : T(0);
      dLH[x] = d ? (T)(-wk / (double)LH[x]) : T(0);
    }
  }
  if (dm)   // d m = iK^T v + w_kqu iKm / 2
    for (int i = tid; i < nr; i += NT) {
      double s = 0.0;
      for (int n = 0; n < M; ++n) s += (double)KT[i * ld + n] * v[n];
      const size_t y = (size_t)l * M + m0 + i;
      dm[y] = (T)(s + 0.5 * wk * (double)iKm[y]);
    }
}

// ------------------------------------------------------------------ K3
//
// The same two paths as K1's: staged (T <= TP), a subject's K0xz, K0xz
// [G | G^T] (cuBLAS's), iB, iLB, K0_st, r, q and its rows' scalars in
// shared memory; d K0xz a thread an entry,
// (K0xz G) K0xz^T a warp a row and a lane a column (each lane walking M
// from its own offset, so the lanes' reads of K0xz's rows fall in distinct
// banks), d iB + d iB^T and d iLB a thread an entry; or, for longer
// subjects, the elementwise work around cuBLAS's products (the wrapper's:
// iB (K0xz G^T) + iB^T (K0xz G) in d K0xz and (K0xz G) K0xz^T in the
// scratch ``sym`` before, iLB (d iB + d iB^T) after).

template <typename T>
__global__ void __launch_bounds__(NT, BWD_SUBJECT_BLOCKS) gp_bound_bwd_subjects_kernel(
    const T* __restrict__ gterms, const T* __restrict__ gkld,
    const T* __restrict__ pbatch, double ptot, const T* __restrict__ K0xz,
    const T* __restrict__ iB, const T* __restrict__ iLB,
    const T* __restrict__ K0st, const T* __restrict__ LB,
    const T* __restrict__ lv, const T* __restrict__ valid,
    const T* __restrict__ r, const T* __restrict__ q,
    const T* __restrict__ iKm, const T* __restrict__ Y2,
    T* __restrict__ sym, T* __restrict__ dK0xz, T* __restrict__ diLB,
    T* __restrict__ dK0st, T* __restrict__ dLB, T* __restrict__ dmu,
    T* __restrict__ dlv, int S, int Tn, int M, int ldm, int chunk,
    int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int l = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  double w[NTERM];
  term_weights(gterms, gkld, pbatch, ptot, w);
  const T wa = (T)w[0], wb = (T)w[1], wd = (T)w[3], wf = (T)w[5];
  const T wc2 = (T)(2.0 * w[2]);
  const T* km = iKm + (size_t)l * M;
  const int ld = staged ? Tn + 1 : Tn;      // sym's row stride
  Carve cv{smem_raw};
  T *kxs = nullptr, *y2s = nullptr, *bss = nullptr, *ils = nullptr,
    *kss = nullptr, *yks = nullptr, *sys = nullptr, *rsh = nullptr,
    *qsh = nullptr, *kms = nullptr, *row = nullptr;
  if (staged) {
    kxs = cv.take<T>(Tn * M);
    y2s = cv.take<T>(Tn * 2 * M);
    bss = cv.take<T>(Tn * Tn);
    ils = cv.take<T>(Tn * Tn);
    kss = cv.take<T>(Tn * Tn);
    yks = cv.take<T>(Tn * (Tn + 1));
    sys = cv.take<T>(Tn * (Tn + 1));
    rsh = cv.take<T>(Tn);
    qsh = cv.take<T>(Tn);
    kms = cv.take<T>(M);
    row = cv.take<T>(3 * Tn);    // a row's valid, log_v, LB diagonal
    stage(kms, km, M);
  }
  const int s1 = min(S, ((int)blockIdx.x + 1) * chunk);
  for (int s = (int)blockIdx.x * chunk; s < s1; ++s) {
    const size_t ls = (size_t)l * S + s, st0 = (size_t)s * Tn;
    const T* kx = K0xz + ls * Tn * M;
    const T* bs = iB + ls * Tn * Tn;
    const T* il = iLB + ls * Tn * Tn;
    const T* ks = K0st + ls * Tn * Tn;
    const T* rs = r + ls * Tn;
    const T* qs = q + ls * Tn;
    const T* y2 = Y2 + ls * Tn * 2 * M;   // row t: K0xz G, then K0xz G^T
    T* sy = sym + ls * Tn * Tn;
    if (staged) {
      stage(kxs, kx, Tn * M);
      stage(y2s, y2, Tn * 2 * M);
      stage(bss, bs, Tn * Tn);
      stage(ils, il, Tn * Tn);
      stage(kss, ks, Tn * Tn);
      stage(rsh, rs, Tn);
      stage(qsh, qs, Tn);
      stage(row, valid + st0, Tn);
      for (int t = tid; t < Tn; t += NT) {
        cp_async_elem<sizeof(T)>(row + Tn + t, lv + (st0 + t) * ldm + l);
        cp_async_elem<sizeof(T)>(row + 2 * Tn + t,
                                 LB + ls * Tn * Tn + (size_t)t * (Tn + 1));
      }
      cp_async_wait_all();
      __syncthreads();
      kx = kxs;
      bs = bss;
      il = ils;
      ks = kss;
      rs = rsh;
      qs = qsh;
      km = kms;
      y2 = y2s;
      sy = sys;
    }
    // d K0xz = w_A q iKm^T + iB (K0xz G^T) + iB^T (K0xz G)
    T* dk = dK0xz + ls * Tn * M;
    if (staged) {
      tile_products<T>(Tn, M, [&](int t, int u) { return bs[t * Tn + u]; },
                    [&](int u, int m) { return y2[u * 2 * M + M + m]; },
                    [&](int t, int u) { return bs[u * Tn + t]; },
                    [&](int u, int m) { return y2[u * 2 * M + m]; },
                    [&](int t, int m, T a) {
                      dk[t * M + m] = fma(wa * qs[t], km[m], a);
                    }, true);
      // (K0xz G) K0xz^T: RR rows a warp, column u a lane, each lane
      // walking M from its own offset
      for (int t0 = warp * RR; t0 < Tn; t0 += NW * RR) {
        if (lane < Tn) {
          T a[RR];
#pragma unroll
          for (int i = 0; i < RR; ++i) a[i] = T(0);
          for (int k = 0; k < M; ++k) {
            int m = k + lane;
            m -= m >= M ? M : 0;
            const T x = kx[lane * M + m];
#pragma unroll
            for (int i = 0; i < RR; ++i)
              if (t0 + i < Tn) a[i] = fma(y2[(t0 + i) * 2 * M + m], x, a[i]);
          }
#pragma unroll
          for (int i = 0; i < RR; ++i)
            if (t0 + i < Tn) yks[(t0 + i) * ld + lane] = a[i];
        }
      }
      __syncthreads();
      // d iB + d iB^T: w_A r r^T twice, w_D (K0_st + K0_st^T), (K0xz G)
      // K0xz^T and its transpose, w_Bt diag(v) twice
      for (int e = tid; e < Tn * Tn; e += NT) {
        const int t = e / Tn, x = e % Tn;
        T g = T(2) * wa * rs[t] * rs[x] + wd * (ks[e] + ks[x * Tn + t])
              + yks[t * ld + x] + yks[x * ld + t];
        if (x == t) g += T(2) * wb * (exp(row[Tn + t]) * row[t]);
        sy[t * ld + x] = g;
      }
    } else {
      // cuBLAS's iB (K0xz G^T) + iB^T (K0xz G) in dK0xz and (K0xz G)
      // K0xz^T in sym (the wrapper's): w_A q iKm^T added, d iB + d iB^T
      // in place, a pair (t <= u) a thread
      for (int e = tid; e < Tn * M; e += NT)
        dk[e] = fma(wa * qs[e / M], km[e % M], dk[e]);
      for (int e = tid; e < Tn * Tn; e += NT) {
        const int t = e / Tn, x = e % Tn;
        if (x < t) continue;
        T g = T(2) * wa * rs[t] * rs[x] + wd * (ks[e] + ks[x * Tn + t])
              + sy[t * ld + x] + sy[x * ld + t];
        if (x == t)
          g += T(2) * wb * (exp(lv[(st0 + t) * ldm + l]) * valid[st0 + t]);
        sy[t * ld + x] = g;
        sy[x * ld + t] = g;
      }
    }
    __syncthreads();
    // d iLB = iLB (d iB + d iB^T) (the longer subjects': cuBLAS's, after)
    if (staged) {
      T* dl = diLB + ls * Tn * Tn;
      for (int e = tid; e < Tn * Tn; e += NT) {
        const int k = e / Tn, t = e % Tn;
        T a = T(0);
        for (int u = 0; u < Tn; ++u) a = fma(il[k * Tn + u], sy[u * ld + t], a);
        dl[e] = a;
      }
    }
    T* d0 = dK0st + ls * Tn * Tn;
    T* db = dLB + ls * Tn * Tn;
    for (int e = tid; e < Tn * Tn; e += NT) {
      const int t = e / Tn;
      const bool diag = e == t * (Tn + 1);
      d0[e] = wd * bs[e];
      db[e] = diag ? wc2 / (staged ? row[2 * Tn + t] : LB[ls * Tn * Tn + e])
                   : T(0);
    }
    for (int t = tid; t < Tn; t += NT) {
      const T v = staged ? row[t] : valid[st0 + t];
      const T x = staged ? row[Tn + t] : lv[(st0 + t) * ldm + l];
      dmu[(st0 + t) * ldm + l] = -wa * qs[t] * v;
      dlv[(st0 + t) * ldm + l] = wf * v + wb * bs[t * Tn + t] * v * exp(x);
    }
    __syncthreads();
  }
}

// The dynamic shared bytes of K1 (k = 1) and K3 (k = 3) at (Tn, M): the
// staged path's regions (Carve's order), else the tiles' (subject_smem,
// hlax_torch/ops/gp_bound.py)
int subject_smem(int k, int staged, int Tn, int M, int z) {
  auto a16 = [](long n) { return (int)((n + 15) / 16 * 16); };
  if (!staged) return 0;
  if (k == 1)
    return a16((long)Tn * M * z) + 2 * a16(Tn * Tn * z) + 2 * a16(Tn * z)
           + a16(M * z) + a16(4 * Tn * z);
  return a16((long)Tn * M * z) + a16(2L * Tn * M * z) + 3 * a16(Tn * Tn * z)
         + 2 * a16(Tn * (Tn + 1) * z) + 2 * a16(Tn * z) + a16(M * z)
         + a16(3 * Tn * z);
}

int invalid() { return (int)cudaErrorInvalidValue; }

template <typename K> int set_smem(K kernel, int smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return 0;
}

}  // namespace

// ------------------------------------------------------------- C entries

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Each entry launches one kernel on `stream` and returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for a dtype or a size outside
// what is compiled).  Pointers are void*, the dtype by itemsize (4 float,
// 8 double); [L, S, T, M] the bound's shapes, mu and log_v [S, T, ldm]
// (this rank's latents first), a subject block `chunk` subjects, a latent
// block `rows` rows of the M x M matrices; the grids are the wrapper's plan
// (gp_bound_plan, hlax_torch/ops/gp_bound.py).

#define GP_DISPATCH(itemsize, ...)         \
  if (itemsize == 4) {                     \
    using T = float;                       \
    __VA_ARGS__;                           \
  } else if (itemsize == 8) {              \
    using T = double;                      \
    __VA_ARGS__;                           \
  } else {                                 \
    return invalid();                      \
  }

extern "C" int gp_bound_fwd_subjects(
    int itemsize, const void* K0xz, const void* iB, const void* K0st,
    const void* LB, const void* iKm, const void* mu, const void* lv,
    const void* valid, void* W, void* K64, void* W64, void* r, void* q,
    void* part, int L, int S, int Tn, int M, int ldm, int chunk, int staged,
    int smem, void* stream) {
  if (M > MAX_M || chunk < 1 || (staged && Tn > TP) ||
      smem != subject_smem(1, staged, Tn, M, itemsize))
    return invalid();
  const dim3 grid((S + chunk - 1) / chunk, L);
  cudaStream_t st = (cudaStream_t)stream;
  GP_DISPATCH(itemsize, {
    auto kernel = gp_bound_fwd_subjects_kernel<T>;
    const int err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid, NT, smem, st>>>(
        (const T*)K0xz, (const T*)iB, (const T*)K0st, (const T*)LB,
        (const T*)iKm, (const T*)mu, (const T*)lv, (const T*)valid, (T*)W,
        (double*)K64, (double*)W64, (T*)r, (T*)q, (double*)part, S, Tn, M,
        ldm, chunk, staged);
  })
  return (int)cudaGetLastError();
}

extern "C" int gp_bound_fwd_latents(
    int itemsize, const void* iK, const void* Kz64, const void* Em,
    const void* H, const void* m, const void* iKm, const void* LK,
    const void* LH, const void* valid, const void* part1, int nchunks,
    void* part2, void* u, void* terms, void* pbatch, void* kld, void* counter,
    int L, int S, int Tn, int M, int rows, double ptot, double ntot, int smem,
    void* stream) {
  if (rows < 1 || smem < rows * (M + 1) * itemsize) return invalid();
  const dim3 grid((M + rows - 1) / rows, L);
  cudaStream_t st = (cudaStream_t)stream;
  GP_DISPATCH(itemsize, {
    auto kernel = gp_bound_fwd_latents_kernel<T>;
    const int err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid, NT, smem, st>>>(
        (const T*)iK, (const double*)Kz64, (const T*)Em, (const T*)H,
        (const T*)m, (const T*)iKm, (const T*)LK, (const T*)LH,
        (const T*)valid, (const double*)part1, nchunks, (double*)part2,
        (double*)u,
        (T*)terms, (T*)pbatch, (T*)kld, (int*)counter, L, S, Tn, M, rows,
        ptot, ntot);
  })
  return (int)cudaGetLastError();
}

extern "C" int gp_bound_bwd_latents(
    int itemsize, const void* gterms, const void* gkld, const void* pbatch,
    double ptot, const void* iK, const void* Kz, const void* Em,
    const void* H, const void* m, const void* iKm, const void* u,
    const void* LK, const void* LH, const void* R1, const void* R2,
    const void* R3, void* G2, void* dIK, void* dH, void* dm, void* dLK,
    void* dLH, int L, int M, int rows, int smem, void* stream) {
  const int need = ((3 * rows * (M + 1) * itemsize + 15) / 16) * 16 + 8 * M;
  if (rows < 1 || smem < need || (dH && !R3) || (!dLK != !dLH))
    return invalid();
  const dim3 grid((M + rows - 1) / rows, L);
  cudaStream_t st = (cudaStream_t)stream;
  GP_DISPATCH(itemsize, {
    auto kernel = gp_bound_bwd_latents_kernel<T>;
    const int err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid, NT, smem, st>>>(
        (const T*)gterms, (const T*)gkld, (const T*)pbatch, ptot,
        (const T*)iK, (const T*)Kz, (const T*)Em, (const T*)H, (const T*)m,
        (const T*)iKm, (const double*)u, (const T*)LK, (const T*)LH,
        (const T*)R1, (const T*)R2, (const T*)R3, (T*)G2, (T*)dIK, (T*)dH,
        (T*)dm, (T*)dLK, (T*)dLH, M, rows);
  })
  return (int)cudaGetLastError();
}

extern "C" int gp_bound_bwd_subjects(
    int itemsize, const void* gterms, const void* gkld, const void* pbatch,
    double ptot, const void* K0xz, const void* iB, const void* iLB,
    const void* K0st, const void* LB, const void* lv, const void* valid,
    const void* r, const void* q, const void* iKm, const void* Y2, void* sym,
    void* dK0xz, void* diLB, void* dK0st, void* dLB, void* dmu, void* dlv,
    int L, int S, int Tn, int M, int ldm, int chunk, int staged, int smem,
    void* stream) {
  if (chunk < 1 || (staged && Tn > TP) ||
      smem != subject_smem(3, staged, Tn, M, itemsize))
    return invalid();
  const dim3 grid((S + chunk - 1) / chunk, L);
  cudaStream_t st = (cudaStream_t)stream;
  GP_DISPATCH(itemsize, {
    auto kernel = gp_bound_bwd_subjects_kernel<T>;
    const int err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid, NT, smem, st>>>(
        (const T*)gterms, (const T*)gkld, (const T*)pbatch, ptot,
        (const T*)K0xz, (const T*)iB, (const T*)iLB, (const T*)K0st,
        (const T*)LB, (const T*)lv, (const T*)valid, (const T*)r,
        (const T*)q, (const T*)iKm, (const T*)Y2, (T*)sym,
        (T*)dK0xz, (T*)diLB, (T*)dK0st, (T*)dLB, (T*)dmu, (T*)dlv, S, Tn, M,
        ldm, chunk, staged);
  })
  return (int)cudaGetLastError();
}
