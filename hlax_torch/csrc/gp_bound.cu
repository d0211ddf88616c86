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
//   gp_bound_fwd_subjects (K1): fit, r, q = (iB + iB^T) r (A's cotangent
//     direction, saved), W = iB K0xz, and each subject's (or row tile's)
//     partials of A, Bt, C/2, sum iB o K0_st, F and of u = sum_s K0xz_s^T
//     q_s (the cotangent direction of iKm).  With float
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
// (0.5 MB each) and writes W (6.1 MB), and with float inputs K0xz and W in
// double (24.6 MB): ~12 us at 3.35 TB/s against 0.13 GFLOP (~2 us at 67
// TFLOP/s).  K3 reads K0xz and K0xz [G | G^T] (18 MB) and writes d K0xz:
// ~8 us.  K2 and K4 read and write a few [L, M, M] matrices (1.8 MB each).
// Measured (tools/gp_bound_phases.py), a subject a block was latency- and
// wave-bound: K1 ran 640 blocks in three waves of two an SM, each waiting
// ~2.4 us for its copies before ~6 us of compute; K3 1.6 waves, its
// products ~14 us a block, the SMs' shared-memory pipes their limit.  So a
// staged subject kernel's grid is sized to the card (the blocks the SMs
// hold at once) and each block walks its subjects through a ring of
// NSTAGE stages: the next subject's copies (Hopper's bulk copies on an
// mbarrier, element copies for the strided rows) are in flight while this
// one computes, no wave tail, and K3's (K0xz G) K0xz^T keeps every lane of
// its warps busy.  The long sequences' subjects (T = 200, 500: [T, T] by
// [T, M] products per subject) leave those products to cuBLAS and take
// the kernels' elementwise work and sums only, a subject split into row
// tiles so the grid fills the card.  Every sum to a scalar is a double, a
// thread's in a fixed order, a warp's by a butterfly, a block's in warp
// order, the partials (a subject's or a tile's) in order by the last
// block, so a CUDA graph replays the eager call's bits and no float atomic
// is used.  The latent kernels stage the transposed
// rows they need (H^T, iK^T, E^T) in shared memory by cp.async element
// copies.  The counter of K2's last block is zero between launches (that
// block zeroes it), so the wrapper's per-stream buffer needs no fill.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// marks of the subject kernels' phases, read by tools/gp_bound_phases.py
// (which defines them); nothing otherwise
#ifndef GP_PHASE_BEGIN
#define GP_PHASE_BEGIN(k)
#define GP_PHASE(k)
#define GP_PHASE_END
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 256;          // threads a block, every kernel
constexpr int NW = NT / 32;      // warps a block
constexpr int NSUB = 5;          // a subject block's scalar partials
constexpr int NLAT = 6;          // a latent block's scalar partials
constexpr int NTERM = 7;         // A, Bt, C, D, E, F, kqu
constexpr int MAX_M = 2 * NT;    // the M a subject block's u columns take
// blocks an SM the staged subject kernels' launch bounds ask registers
// for: two (128 a thread); K3's ring and buffers of a canonical double
// subject (104 KB) leave room for two, and in float three blocks' 80
// registers spilled (PERF.md)
constexpr int FWD_SUBJECT_BLOCKS = 2, BWD_SUBJECT_BLOCKS = 2;
// the staged subject path: subjects of at most TP rows (a row a lane),
// its products' register tiles RR rows by RC columns a thread
constexpr int TP = 32, RR = 3, RC = 4;
// the staged subject kernels' ring of stages; the row tiles a longer
// subject takes at most (one thread-block cluster, the portable size); the
// blocks an SM the longer subjects' kernels' launch bounds ask for
constexpr int NSTAGE = 2, MAX_TILES = 8, TILE_BLOCKS = 3;

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

// ------------------------------------------------- the subject kernels' ring

__host__ __device__ inline int a16(long n) { return (int)((n + 15) / 16 * 16); }

// The bytes of one stage of K1's and K3's rings, in the order FwdStage and
// BwdStage carve them (fwd_stage, bwd_stage, hlax_torch/ops/gp_bound.py)
__host__ __device__ inline int fwd_stage(int Tn, int M, int z) {
  return a16((long)Tn * M * z) + 2 * a16((long)Tn * Tn * z) + a16((long)M * z)
         + 4 * a16((long)Tn * z);
}
__host__ __device__ inline int bwd_stage(int Tn, int M, int z) {
  return a16((long)Tn * M * z) + 3 * a16((long)Tn * Tn * z) + a16((long)M * z)
         + 5 * a16((long)Tn * z);
}

// K1's stage: a subject's K0xz, iB, K0_st, iKm's row and its rows' mu,
// valid, log_v and LB diagonal
template <typename T> struct FwdStage {
  T *kx, *bs, *ks, *km, *mu, *v, *lv, *lb;
  __device__ FwdStage(unsigned char* p, int Tn, int M) {
    Carve cv{p};
    kx = cv.take<T>(Tn * M);
    bs = cv.take<T>(Tn * Tn);
    ks = cv.take<T>(Tn * Tn);
    km = cv.take<T>(M);
    mu = cv.take<T>(Tn);
    v = cv.take<T>(Tn);
    lv = cv.take<T>(Tn);
    lb = cv.take<T>(Tn);
  }
};

// K3's stage: a subject's K0xz G, iB, iLB, K0_st, iKm's row, r, q and its
// rows' valid, log_v and LB diagonal (K0xz and K0xz G^T have a buffer
// each beside the ring)
template <typename T> struct BwdStage {
  T *y, *bs, *il, *ks, *km, *r, *q, *v, *lv, *lb;
  __device__ BwdStage(unsigned char* p, int Tn, int M) {
    Carve cv{p};
    y = cv.take<T>(Tn * M);
    bs = cv.take<T>(Tn * Tn);
    il = cv.take<T>(Tn * Tn);
    ks = cv.take<T>(Tn * Tn);
    km = cv.take<T>(M);
    r = cv.take<T>(Tn);
    q = cv.take<T>(Tn);
    v = cv.take<T>(Tn);
    lv = cv.take<T>(Tn);
    lb = cv.take<T>(Tn);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(1u) : "memory");
}

// the barrier's one arrival, expecting `bytes` of bulk copies
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Hopper's 1-D bulk copy, global to shared, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// `rows` rows of n elements of global memory, `stride` apart, to stage
// one after another in shared memory: bulk copies where both ends are
// 16-byte aligned and a row and the stride are multiples of 16 bytes
template <typename T> struct Rows {
  T* dst;
  const T* src;
  int rows, n, stride;
  __device__ bool bulk() const {
    return n > 0 && (((uintptr_t)dst | (uintptr_t)src
                      | (uintptr_t)(n * sizeof(T))
                      | (uintptr_t)(stride * sizeof(T))) & 15) == 0;
  }
};

// A fill of rows: the bulk ones issued by thread 0 on `bar` (its one
// arrival, expecting their bytes), the others as cp.async element copies
// of every one of NTH threads (committed by the caller)
template <int NTH, typename T, int N>
__device__ void fill_rows(const Rows<T> (&rs)[N], uint64_t* bar) {
  uint32_t tx = 0;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (rs[i].bulk()) tx += (uint32_t)(rs[i].rows * rs[i].n * sizeof(T));
  if (threadIdx.x == 0) {
    mbar_arrive_tx(bar, tx);
    for (int i = 0; i < N; ++i)
      if (rs[i].bulk())
        for (int j = 0; j < rs[i].rows; ++j)
          bulk_copy(rs[i].dst + (size_t)j * rs[i].n,
                    rs[i].src + (size_t)j * rs[i].stride,
                    (uint32_t)(rs[i].n * sizeof(T)), bar);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (rs[i].bulk()) continue;
    for (int e = threadIdx.x; e < rs[i].rows * rs[i].n; e += NTH)
      cp_async_elem<sizeof(T)>(rs[i].dst + e,
                               rs[i].src + (size_t)(e / rs[i].n) * rs[i].stride
                                   + e % rs[i].n);
  }
}

// Walks subjects through a ring of NSTAGE stages, block b starting with
// subject b and taking its next ones one at a time from ``queue`` (queue[0]
// the next past the grid's first, queue[1] the blocks done; both zero
// between launches: the last block out zeroes them), so the SMs share the
// subjects out as they go (at most n blocks).  fill(st, i) issues subject
// i's copies into stage st (bulk ones on bars[st], element ones in this
// thread's cp.async group), body(st, i, k, take)
// computes subject i, the block's k-th, once they have landed, and calls
// take() once, part way through (a barrier), which takes the block's next
// subject (returned; n or more if none) and issues its copies into the
// other stage, so they are in flight while the rest of subject i computes
// and its stores drain.  start(i) runs once before, with the block's first
// subject; bars holds ``nbars`` barriers, the stages' first.  A subject's
// results do not depend on the block that takes it.
template <class Start, class Fill, class Body>
__device__ void ring(int* queue, long n, uint64_t* bars, int nbars,
                     Start start, Fill fill, Body body) {
  __shared__ long subj[NSTAGE];
  if (threadIdx.x == 0) {
    for (int j = 0; j < nbars; ++j) mbar_init(bars + j);
    subj[0] = blockIdx.x;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (subj[0] < n) {
    start(subj[0]);
    fill(0, subj[0]);
  }
  cp_async_commit();
  // the subjects a block takes rise: once one is past n so is every later;
  // a grid of a block a subject takes none from the queue
  const bool queued = n > (long)gridDim.x;
  for (int k = 0;; ++k) {
    const int st = k % NSTAGE, nx = (k + 1) % NSTAGE;
    const long i = subj[st];
    if (i >= n) break;
    cp_async_wait<0>();
    mbar_wait(bars + st, (uint32_t)(k / NSTAGE) & 1u);
    __syncthreads();
    auto take = [&]() -> long {
      if (threadIdx.x == 0)
        subj[nx] = queued ? gridDim.x + atomicAdd(queue, 1) : n;
      __syncthreads();
      const long j = subj[nx];
      if (j < n) fill(nx, j);
      cp_async_commit();
      return j;
    };
    body(st, i, k, take);
    __syncthreads();       // every thread done with the stage
  }
  if (queued && threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(queue + 1, 1) == (int)gridDim.x - 1) {
      queue[0] = 0;
      queue[1] = 0;
    }
  }
}

// The staged path's products: out(t, m) = sum_u A(t, u) B(u, m) [+ sum_u
// A2(t, u) B2(u, m) with ``two``] for t < nr, m < nc, the depth nr, all
// operands in shared memory.  A thread holds RR rows by RC columns
// (columns lane + 32 j of a block of 32 RC, so a warp's reads of a B row
// are consecutive and its reads of A the same address): RR + RC loads
// for RR RC multiply-adds.  Each entry's sum runs over u in order.
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
// Two kernels, the plan's choice (``staged``).  Staged (T <= TP, every
// training batch but the long sequences'): the grid (sized to the card by
// subject_plan) walks the n = L S (latent, subject) pairs through each
// block's ring of NSTAGE stages of shared memory (``ring``): a subject's
// K0xz, iB, K0_st, iKm's row and valid as 1-D bulk copies, its strided
// mu, log_v and LB diagonal as cp.async element copies, the next subject's
// issued while this one computes.  The fit a warp a row, q a thread a row,
// iB K0xz as register tiles, each subject's partials a row of ``part``
// (so the terms' sums do not depend on the grid), every output in the
// order of a one-subject-a-block kernel.  Longer subjects
// (gp_bound_fwd_tiles_kernel): a block a (row tile of ``rows`` rows,
// subject), a subject's tiles one thread-block cluster; each block fits
// its rows' r, the cluster shares them through distributed shared memory,
// iB r of the block's rows a warp a row and iB^T r a thread a column and
// a segment of u (every global read coalesced); a tile's partials a row
// of ``part``; iB K0xz is cuBLAS's (the wrapper's).

template <typename T>
__global__ void __launch_bounds__(NT, FWD_SUBJECT_BLOCKS) gp_bound_fwd_subjects_kernel(
    const T* __restrict__ K0xz, const T* __restrict__ iB,
    const T* __restrict__ K0st, const T* __restrict__ LB,
    const T* __restrict__ iKm, const T* __restrict__ mu,
    const T* __restrict__ lv, const T* __restrict__ valid,
    T* __restrict__ W, double* __restrict__ K64, double* __restrict__ W64,
    T* __restrict__ r, T* __restrict__ q, double* __restrict__ part,
    int* __restrict__ queue, int L, int S, int Tn, int M, int ldm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double red[NW * NSUB], tot[NSUB];
  __shared__ uint64_t bars[NSTAGE];
  GP_PHASE_BEGIN(0)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t TM = (size_t)Tn * M, TT = (size_t)Tn * Tn;
  const int sb = fwd_stage(Tn, M, sizeof(T));
  Carve cv{smem_raw + NSTAGE * sb};
  T* rsh = cv.take<T>(Tn);
  T* qsh = cv.take<T>(Tn);
  const long n = (long)L * S;
  auto fill = [&](int st, long i) {
    const FwdStage<T> g(smem_raw + st * sb, Tn, M);
    const long l = i / S, s = i % S;
    const Rows<T> rs[5] = {{g.kx, K0xz + i * TM, 1, Tn * M, 0},
                           {g.bs, iB + i * TT, 1, Tn * Tn, 0},
                           {g.ks, K0st + i * TT, 1, Tn * Tn, 0},
                           {g.km, iKm + l * M, 1, M, 0},
                           {g.v, valid + s * Tn, 1, Tn, 0}};
    fill_rows<NT>(rs, bars + st);
    for (int t = tid; t < Tn; t += NT) {
      const size_t row = ((size_t)s * Tn + t) * ldm + l;
      cp_async_elem<sizeof(T)>(g.mu + t, mu + row);
      cp_async_elem<sizeof(T)>(g.lv + t, lv + row);
      cp_async_elem<sizeof(T)>(g.lb + t, LB + i * TT + (size_t)t * (Tn + 1));
    }
  };
  auto body = [&](int st, long i, int, auto take) {
    GP_PHASE(1)
    const FwdStage<T> g(smem_raw + st * sb, Tn, M);
    T* rs = r + i * Tn;
    T* qs = q + i * Tn;
    // fit and r: a warp a row
    for (int t = warp; t < Tn; t += NW) {
      T f = T(0);
      for (int k = lane; k < M; k += 32) f = fma(g.kx[t * M + k], g.km[k], f);
      f = warp_sum(f);
      if (lane == 0) {
        const T rt = f - g.mu[t] * g.v[t];
        rs[t] = rt;
        rsh[t] = rt;
      }
    }
    __syncthreads();
    // A, Bt, sum log diag LB, sum iB o K0_st, F of this subject
    double acc[NSUB] = {0.0, 0.0, 0.0, 0.0, 0.0};
    // iB r, iB^T r, q, and the per-row terms: a thread a row
    for (int t = tid; t < Tn; t += NT) {
      T rw = T(0), cl = T(0);
      for (int u = 0; u < Tn; ++u) {
        const T ru = rsh[u];
        rw = fma(g.bs[t * Tn + u], ru, rw);
        cl = fma(g.bs[u * Tn + t], ru, cl);
      }
      qs[t] = rw + cl;
      qsh[t] = rw + cl;
      const T v = g.v[t], x = g.lv[t];
      acc[0] += (double)rsh[t] * (double)rw;
      acc[1] += (double)(g.bs[t * Tn + t] * (exp(x) * v));
      acc[2] += (double)log(g.lb[t]);
      acc[4] += (double)(x * v);
    }
    for (int e = tid; e < Tn * Tn; e += NT)
      acc[3] += (double)(g.bs[e] * g.ks[e]);
    take();
    GP_PHASE(2)
    double* p = part + i * (NSUB + M);
    // u's part: sum_t K0xz[t, n] q[t]
    for (int k = 0; k < MAX_M / NT; ++k) {
      const int c = tid + k * NT;
      if (c >= M) break;
      double u = 0.0;
      for (int t = 0; t < Tn; ++t) u += (double)(g.kx[t * M + c] * qsh[t]);
      p[NSUB + c] = u;
    }
    // W = iB K0xz, summed in double; with W64 (float inputs) kept in
    // double beside K0xz's values, for KziBK's product in double
    T* ws = W + i * TM;
    double* w64 = W64 ? W64 + i * TM : nullptr;
    if (K64)
      for (int e = tid; e < Tn * M; e += NT) K64[i * TM + e] = g.kx[e];
    tile_products<double>(
        Tn, M, [&](int t, int u) { return (double)g.bs[t * Tn + u]; },
        [&](int u, int m) { return (double)g.kx[u * M + m]; },
        [&](int, int) { return 0.0; }, [&](int, int) { return 0.0; },
        [&](int t, int m, double a) {
          ws[t * M + m] = (T)a;
          if (w64) w64[t * M + m] = a;
        }, false);
    GP_PHASE(3)
    block_sum(acc, red, tot);
    if (tid < NSUB) p[tid] = tot[tid];
    GP_PHASE(5)
  };
  ring(queue, n, bars, NSTAGE, [](long) {}, fill, body);
  GP_PHASE_END
}

// K1's longer subjects: a block a (row tile I of `rows` rows, subject), a
// subject's tiles one cluster (gridDim.x of them)
template <typename T>
__global__ void __launch_bounds__(NT, TILE_BLOCKS) gp_bound_fwd_tiles_kernel(
    const T* __restrict__ K0xz, const T* __restrict__ iB,
    const T* __restrict__ K0st, const T* __restrict__ LB,
    const T* __restrict__ iKm, const T* __restrict__ mu,
    const T* __restrict__ lv, const T* __restrict__ valid,
    T* __restrict__ r, T* __restrict__ q, double* __restrict__ part, int S,
    int Tn, int M, int ldm, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double red[NW * NSUB], tot[NSUB];
  GP_PHASE_BEGIN(0)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t TM = (size_t)Tn * M, TT = (size_t)Tn * Tn;
  cg::cluster_group cluster = cg::this_cluster();
  const int I = blockIdx.x, t0 = I * rows, nr = min(rows, Tn - t0);
  const long i = blockIdx.y, l = i / S, s = i % S;
  const size_t st0 = (size_t)s * Tn;
  Carve cv{smem_raw};
  T* rf = cv.take<T>(Tn);              // the subject's r
  T* qsh = cv.take<T>(rows);           // iB r of the block's rows, then q
  T* clp = cv.take<T>(NT);             // iB^T r's parts, a thread's each
  const T* kx = K0xz + i * TM;
  const T* bs = iB + i * TT;
  const T* ks = K0st + i * TT;
  const T* km = iKm + l * M;
  // fit and r of the block's rows: NT / rows threads a row (neighbouring
  // lanes), each a strided part of its dot product, then their butterfly
  {
    const int P = NT / rows, a = tid / P, k0 = tid % P;
    T f = T(0);
    if (a < nr)
      for (int k = k0; k < M; k += P) f = fma(kx[(size_t)(t0 + a) * M + k], km[k], f);
    for (int o = P / 2; o; o >>= 1) f += __shfl_xor_sync(0xffffffffu, f, o);
    if (a < nr && k0 == 0) {
      const int t = t0 + a;
      const T rt = f - mu[(st0 + t) * ldm + l] * valid[st0 + t];
      r[i * Tn + t] = rt;
      rf[t] = rt;
    }
  }
  // every block's rows of r into every block of the subject's cluster
  cluster.sync();
  for (int t = tid; t < Tn; t += NT)
    if (t / rows != I) rf[t] = cluster.map_shared_rank(rf, t / rows)[t];
  cluster.sync();        // no block leaves while another reads its rows
  GP_PHASE(2)
  // iB r of the block's rows, a warp a row (coalesced), with sum iB o K0_st
  // of the row; iB^T r: a thread a column and one of NT / rows segments of
  // u (coalesced), the segments then added in order
  double d3 = 0.0;
  for (int a = warp; a < nr; a += NW) {
    const size_t row = (size_t)(t0 + a) * Tn;
    T f = T(0);
    for (int u = lane; u < Tn; u += 32) {
      const T b = bs[row + u];
      f = fma(b, rf[u], f);
      d3 += (double)(b * ks[row + u]);
    }
    f = warp_sum(f);
    if (lane == 0) qsh[a] = f;
  }
  {
    const int c = tid % rows, sg = tid / rows, nseg = NT / rows;
    T f = T(0);
    if (c < nr)
      for (int u = sg * Tn / nseg; u < (sg + 1) * Tn / nseg; ++u)
        f = fma(bs[(size_t)u * Tn + t0 + c], rf[u], f);
    clp[tid] = f;
  }
  __syncthreads();
  double acc[NSUB] = {0.0, 0.0, 0.0, d3, 0.0};
  if (tid < nr) {
    const int t = t0 + tid;
    T cl = clp[tid];
    for (int sg = 1; sg < NT / rows; ++sg) cl += clp[sg * rows + tid];
    const T rw = qsh[tid];
    q[i * Tn + t] = rw + cl;
    qsh[tid] = rw + cl;
    const T v = valid[st0 + t], x = lv[(st0 + t) * ldm + l];
    acc[0] += (double)rf[t] * (double)rw;
    acc[1] += (double)(bs[(size_t)t * Tn + t] * (exp(x) * v));
    acc[2] += (double)log(LB[i * TT + (size_t)t * (Tn + 1)]);
    acc[4] += (double)(x * v);
  }
  __syncthreads();
  double* p = part + ((size_t)i * gridDim.x + I) * (NSUB + M);
  for (int k = 0; k < MAX_M / NT; ++k) {
    const int c = tid + k * NT;
    if (c >= M) break;
    double u = 0.0;
    for (int a = 0; a < nr; ++a)
      u += (double)(kx[(size_t)(t0 + a) * M + c] * qsh[a]);
    p[NSUB + c] = u;
  }
  GP_PHASE(3)
  block_sum(acc, red, tot);
  if (tid < NSUB) p[tid] = tot[tid];
  GP_PHASE(5)
  GP_PHASE_END
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
    // u: the subjects' (or their row tiles') parts in a fixed order
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
// The same two kernels as K1's.  Staged (T <= TP): the same grid and ring,
// a stage a subject's K0xz G, iB, iLB, K0_st, iKm's row, r, q and valid by
// bulk copies, its log_v and LB diagonal by element copies; its K0xz G^T
// and K0xz (the two largest) in one buffer each beside the ring, each
// refilled with the next subject's as soon as this one's product is done
// with it, so that a double subject's ring and buffers (104 KB) leave
// room for two blocks an SM.  d K0xz as register tiles (tile_products),
// (K0xz G) K0xz^T a thread a column u and RR rows (each entry's sum
// walking M from u, so the lanes' reads of K0xz's rows fall in distinct
// banks), d iB + d iB^T and d iLB a thread an entry: every output in the
// order of a one-subject-a-block kernel.  Longer subjects
// (gp_bound_bwd_tiles_kernel), around cuBLAS's products (the wrapper's:
// iB (K0xz G^T) + iB^T (K0xz G) in d K0xz and P = (K0xz G) K0xz^T in
// diLB before, iLB (d iB + d iB^T) from ``sym`` after): a block a pair of
// 32 x 32 tiles of a subject's d iB + d iB^T, d K0_st and d LB, or a row
// tile's w_A q iKm^T, d mu and d log_v.

template <typename T>
__global__ void __launch_bounds__(NT, BWD_SUBJECT_BLOCKS) gp_bound_bwd_subjects_kernel(
    const T* __restrict__ gterms, const T* __restrict__ gkld,
    const T* __restrict__ pbatch, double ptot, const T* __restrict__ K0xz,
    const T* __restrict__ iB, const T* __restrict__ iLB,
    const T* __restrict__ K0st, const T* __restrict__ LB,
    const T* __restrict__ lv, const T* __restrict__ valid,
    const T* __restrict__ r, const T* __restrict__ q,
    const T* __restrict__ iKm, const T* __restrict__ Y2,
    T* __restrict__ dK0xz, T* __restrict__ diLB, T* __restrict__ dK0st,
    T* __restrict__ dLB, T* __restrict__ dmu, T* __restrict__ dlv,
    int* __restrict__ queue, int L, int S, int Tn, int M, int ldm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring's barriers, then K0xz G^T's and K0xz's
  __shared__ uint64_t bars[NSTAGE + 2];
  GP_PHASE_BEGIN(1)
  const int tid = threadIdx.x;
  double w[NTERM];
  term_weights(gterms, gkld, pbatch, ptot, w);
  const T wa = (T)w[0], wb = (T)w[1], wd = (T)w[3], wf = (T)w[5];
  const T wc2 = (T)(2.0 * w[2]);
  const size_t TM = (size_t)Tn * M, TT = (size_t)Tn * Tn;
  const int sb = bwd_stage(Tn, M, sizeof(T)), ld = Tn + 1;
  Carve cv{smem_raw + NSTAGE * sb};
  T* kx = cv.take<T>(Tn * M);          // the subject's K0xz
  T* yt = cv.take<T>(Tn * M);          // its K0xz G^T
  T* yks = cv.take<T>(Tn * ld);        // (K0xz G) K0xz^T
  T* sys = cv.take<T>(Tn * ld);        // d iB + d iB^T
  const long n = (long)L * S;
  auto fill = [&](int st, long i) {
    const BwdStage<T> g(smem_raw + st * sb, Tn, M);
    const long l = i / S, s = i % S;
    const Rows<T> rs[8] = {{g.y, Y2 + 2 * i * TM, Tn, M, 2 * M},
                           {g.bs, iB + i * TT, 1, Tn * Tn, 0},
                           {g.il, iLB + i * TT, 1, Tn * Tn, 0},
                           {g.ks, K0st + i * TT, 1, Tn * Tn, 0},
                           {g.km, iKm + l * M, 1, M, 0},
                           {g.r, r + i * Tn, 1, Tn, 0},
                           {g.q, q + i * Tn, 1, Tn, 0},
                           {g.v, valid + s * Tn, 1, Tn, 0}};
    fill_rows<NT>(rs, bars + st);
    for (int t = tid; t < Tn; t += NT) {
      cp_async_elem<sizeof(T)>(g.lv + t, lv + ((size_t)s * Tn + t) * ldm + l);
      cp_async_elem<sizeof(T)>(g.lb + t, LB + i * TT + (size_t)t * (Tn + 1));
    }
  };
  // K0xz G^T and K0xz, a subject at a time: each filled as soon as the
  // last subject's product is done with it (element copies in their own
  // cp.async group, which the ring waits for before the next subject)
  auto fill_yt = [&](long i) {
    const Rows<T> rs[1] = {{yt, Y2 + 2 * i * TM + M, Tn, M, 2 * M}};
    fill_rows<NT>(rs, bars + NSTAGE);
  };
  auto fill_kx = [&](long i) {
    const Rows<T> rs[1] = {{kx, K0xz + i * TM, 1, Tn * M, 0}};
    fill_rows<NT>(rs, bars + NSTAGE + 1);
  };
  auto body = [&](int st, long i, int kth, auto take) {
    GP_PHASE(1)
    const BwdStage<T> g(smem_raw + st * sb, Tn, M);
    const long l = i / S;
    const size_t st0 = (size_t)(i % S) * Tn;
    const uint32_t par = (uint32_t)kth & 1u;
    // d K0xz = w_A q iKm^T + iB (K0xz G^T) + iB^T (K0xz G)
    mbar_wait(bars + NSTAGE, par);
    T* dk = dK0xz + i * TM;
    tile_products<T>(
        Tn, M, [&](int t, int u) { return g.bs[t * Tn + u]; },
        [&](int u, int m) { return yt[u * M + m]; },
        [&](int t, int u) { return g.bs[u * Tn + t]; },
        [&](int u, int m) { return g.y[u * M + m]; },
        [&](int t, int m, T a) { dk[t * M + m] = fma(wa * g.q[t], g.km[m], a); },
        true);
    const long next = take();
    if (next < n) fill_yt(next);
    cp_async_commit();
    // (K0xz G) K0xz^T: a thread a column u and RR rows
    mbar_wait(bars + NSTAGE + 1, par);
    const int ngr = (Tn + RR - 1) / RR;
    for (int task = tid; task < Tn * ngr; task += NT) {
      const int u = task % Tn, t0 = task / Tn * RR;
      T a[RR];
#pragma unroll
      for (int j = 0; j < RR; ++j) a[j] = T(0);
      for (int k = 0; k < M; ++k) {
        int m = k + u;
        m -= m >= M ? M : 0;
        const T x = kx[u * M + m];
#pragma unroll
        for (int j = 0; j < RR; ++j)
          if (t0 + j < Tn) a[j] = fma(g.y[(t0 + j) * M + m], x, a[j]);
      }
#pragma unroll
      for (int j = 0; j < RR; ++j)
        if (t0 + j < Tn) yks[(t0 + j) * ld + u] = a[j];
    }
    __syncthreads();
    if (next < n) fill_kx(next);
    cp_async_commit();
    GP_PHASE(2)
    // d iB + d iB^T: w_A r r^T twice, w_D (K0_st + K0_st^T), (K0xz G)
    // K0xz^T and its transpose, w_Bt diag(v) twice
    for (int e = tid; e < Tn * Tn; e += NT) {
      const int t = e / Tn, x = e % Tn;
      T gg = T(2) * wa * g.r[t] * g.r[x] + wd * (g.ks[e] + g.ks[x * Tn + t])
             + yks[t * ld + x] + yks[x * ld + t];
      if (x == t) gg += T(2) * wb * (exp(g.lv[t]) * g.v[t]);
      sys[t * ld + x] = gg;
    }
    __syncthreads();
    // d iLB = iLB (d iB + d iB^T)
    T* dl = diLB + i * TT;
    for (int e = tid; e < Tn * Tn; e += NT) {
      const int k = e / Tn, t = e % Tn;
      T a = T(0);
      for (int u = 0; u < Tn; ++u) a = fma(g.il[k * Tn + u], sys[u * ld + t], a);
      dl[e] = a;
    }
    GP_PHASE(3)
    T* d0 = dK0st + i * TT;
    T* db = dLB + i * TT;
    for (int e = tid; e < Tn * Tn; e += NT) {
      const int t = e / Tn;
      d0[e] = wd * g.bs[e];
      db[e] = e == t * (Tn + 1) ? wc2 / g.lb[t] : T(0);
    }
    for (int t = tid; t < Tn; t += NT) {
      const T v = g.v[t], x = g.lv[t];
      dmu[(st0 + t) * ldm + l] = -wa * g.q[t] * v;
      dlv[(st0 + t) * ldm + l] = wf * v + wb * g.bs[t * Tn + t] * v * exp(x);
    }
    GP_PHASE(4)
  };
  ring(queue, n, bars, NSTAGE + 2, [&](long i) {
    fill_yt(i);
    fill_kx(i);
  }, fill, body);
  GP_PHASE_END
}

// K3's longer subjects: block p of a subject's first P = nt (nt + 1) / 2
// takes the pair of 32 x 32 tiles (I, J), I <= J, of d iB + d iB^T (into
// sym), d K0_st and d LB, P's and K0_st's tiles of both staged in shared
// memory by coalesced cp.async copies, a thread an entry of (I, J) and,
// through shared memory, of (J, I); block P + I takes row tile I's d K0xz
// (cuBLAS's products plus w_A q iKm^T), d mu and d log_v
template <typename T>
__global__ void __launch_bounds__(NT, TILE_BLOCKS) gp_bound_bwd_tiles_kernel(
    const T* __restrict__ gterms, const T* __restrict__ gkld,
    const T* __restrict__ pbatch, double ptot, const T* __restrict__ iB,
    const T* __restrict__ K0st, const T* __restrict__ LB,
    const T* __restrict__ lv, const T* __restrict__ valid,
    const T* __restrict__ r, const T* __restrict__ q,
    const T* __restrict__ iKm, const T* __restrict__ Pm,
    T* __restrict__ sym, T* __restrict__ dK0xz, T* __restrict__ dK0st,
    T* __restrict__ dLB, T* __restrict__ dmu, T* __restrict__ dlv, int S,
    int Tn, int M, int ldm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GP_PHASE_BEGIN(1)
  const int tid = threadIdx.x;
  double w[NTERM];
  term_weights(gterms, gkld, pbatch, ptot, w);
  const T wa = (T)w[0], wb = (T)w[1], wd = (T)w[3], wf = (T)w[5];
  const T wc2 = (T)(2.0 * w[2]);
  const size_t TM = (size_t)Tn * M, TT = (size_t)Tn * Tn;
  const int nt = (Tn + 31) / 32, np = nt * (nt + 1) / 2;
  const long i = blockIdx.y, l = i / S;
  const size_t st0 = (size_t)(i % S) * Tn;
  const T* qs = q + i * Tn;
  const T* rs = r + i * Tn;
  const T* bs = iB + i * TT;
  int p = blockIdx.x;
  if (p >= np) {
    // row tile p - np: w_A q iKm^T added to cuBLAS's d K0xz, d mu, d log_v
    const int t0 = 32 * (p - np), nr = min(32, Tn - t0);
    const T* km = iKm + l * M;
    T* dk = dK0xz + i * TM;
    for (int e = tid; e < nr * M; e += NT) {
      const size_t x = (size_t)t0 * M + e;
      dk[x] = fma(wa * qs[t0 + e / M], km[e % M], dk[x]);
    }
    for (int a = tid; a < nr; a += NT) {
      const int t = t0 + a;
      const T v = valid[st0 + t], x = lv[(st0 + t) * ldm + l];
      dmu[(st0 + t) * ldm + l] = -wa * qs[t] * v;
      dlv[(st0 + t) * ldm + l] = wf * v + wb * bs[(size_t)t * Tn + t] * v * exp(x);
    }
    GP_PHASE(4)
    GP_PHASE_END
    return;
  }
  int I = 0;
  while (p >= nt - I) {
    p -= nt - I;
    ++I;
  }
  const int J = I + p;
  const int t0 = 32 * I, x0 = 32 * J, nr = min(32, Tn - t0),
            nc = min(32, Tn - x0);
  Carve cv{smem_raw};
  T* pa = cv.take<T>(32 * 33);         // P[t0 + a, x0 + c] at a 33 + c
  T* pb = cv.take<T>(32 * 33);         // P[x0 + c, t0 + a] at c 33 + a
  T* ka = cv.take<T>(32 * 33);         // the same of K0_st
  T* kb = cv.take<T>(32 * 33);
  T* gt = cv.take<T>(32 * 33);         // the (I, J) tile's entries, for (J, I)
  const T* P = Pm + i * TT;
  const T* ks = K0st + i * TT;
  for (int e = tid; e < 32 * 32; e += NT) {
    const int h = e / 32, c = e % 32;
    if (h < nr && c < nc) {
      const size_t y = (size_t)(t0 + h) * Tn + x0 + c;
      cp_async_elem<sizeof(T)>(pa + h * 33 + c, P + y);
      cp_async_elem<sizeof(T)>(ka + h * 33 + c, ks + y);
    }
    if (h < nc && c < nr) {
      const size_t y = (size_t)(x0 + h) * Tn + t0 + c;
      cp_async_elem<sizeof(T)>(pb + h * 33 + c, P + y);
      cp_async_elem<sizeof(T)>(kb + h * 33 + c, ks + y);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  GP_PHASE(2)
  for (int e = tid; e < 32 * 32; e += NT) {
    const int a = e / 32, c = e % 32;
    if (a >= nr || c >= nc) continue;
    const int t = t0 + a, x = x0 + c;
    // summed in the order of the pair (ta <= xa): the same bits either side
    const bool up = t <= x;
    const int ta = up ? t : x, xa = up ? x : t;
    const T k1 = ka[a * 33 + c], k2 = kb[c * 33 + a];
    const T p1 = pa[a * 33 + c], p2 = pb[c * 33 + a];
    const T kA = up ? k1 : k2, kB = up ? k2 : k1;
    const T pA = up ? p1 : p2, pB = up ? p2 : p1;
    T gg = T(2) * wa * rs[ta] * rs[xa] + wd * (kA + kB) + pA + pB;
    if (x == t)
      gg += T(2) * wb * (exp(lv[(st0 + t) * ldm + l]) * valid[st0 + t]);
    const size_t y = i * TT + (size_t)t * Tn + x;
    sym[y] = gg;
    dK0st[y] = wd * bs[(size_t)t * Tn + x];
    dLB[y] = x == t ? wc2 / LB[y] : T(0);
    gt[c * 33 + a] = gg;
  }
  if (I != J) {
    __syncthreads();
    for (int e = tid; e < 32 * 32; e += NT) {
      const int c = e / 32, a = e % 32;
      if (a >= nr || c >= nc) continue;
      const size_t y = (size_t)(x0 + c) * Tn + t0 + a;
      sym[i * TT + y] = gt[c * 33 + a];
      dK0st[i * TT + y] = wd * bs[y];
      dLB[i * TT + y] = T(0);
    }
  }
  GP_PHASE(3)
  GP_PHASE_END
}

// The dynamic shared bytes of K1 (k = 1) and K3 (k = 3) at (Tn, M): staged,
// NSTAGE stages and the block's own (K1: r, q; K3: K0xz, K0xz G^T, (K0xz G)
// K0xz^T and d iB + d iB^T, rows padded); else the row-tile kernels' (K1:
// the subject's r, q of its `rows` rows and a part of iB^T r a thread; K3:
// five 32 x 32 tiles, padded) (subject_smem, hlax_torch/ops/gp_bound.py)
int subject_smem(int k, int staged, int Tn, int M, int z, int rows) {
  if (staged)
    return k == 1 ? NSTAGE * fwd_stage(Tn, M, z) + 2 * a16((long)Tn * z)
                  : NSTAGE * bwd_stage(Tn, M, z) + 2 * a16((long)Tn * M * z)
                        + 2 * a16((long)Tn * (Tn + 1) * z);
  return k == 1 ? a16((long)Tn * z) + a16((long)rows * z) + a16((long)NT * z)
                : 5 * a16(32L * 33 * z);
}

// Whether K1's and K3's launch takes the plan: staged, `blocks` blocks
// walking the L S subjects (rows = Tn <= TP); else K1 a (row tile of `rows`
// rows, subject) a block, at most MAX_TILES tiles a subject (its cluster),
// K3 a (pair of 32 x 32 tiles or row tile, subject) a block
bool subject_plan_ok(int L, int S, int Tn, int M, int blocks, int rows,
                     int staged) {
  const long n = (long)L * S;
  if (M < 1 || M > MAX_M || n < 1 || n >= (1L << 30)) return false;
  if (staged) return Tn <= TP && rows == Tn && blocks >= 1 && blocks <= n;
  return rows >= 32 && rows % 32 == 0 && rows <= NT
         && (Tn + rows - 1) / rows <= MAX_TILES && n <= 65535;
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
// (this rank's latents first); the subject kernels' grid `blocks` blocks
// (staged) or a subject's tiles of `rows` rows (subject_plan_ok), a latent
// block `rows` rows of the M x M matrices; the grids are the wrapper's
// plans (subject_plan, latent_plan, hlax_torch/ops/gp_bound.py).

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
    void* part, void* queue, int L, int S, int Tn, int M, int ldm,
    int blocks, int rows, int staged, int smem, void* stream) {
  if (!subject_plan_ok(L, S, Tn, M, blocks, rows, staged) ||
      smem != subject_smem(1, staged, Tn, M, itemsize, rows) ||
      (staged && !queue))
    return invalid();
  cudaStream_t st = (cudaStream_t)stream;
  GP_DISPATCH(itemsize, {
    const T* a0 = (const T*)K0xz;
    const T* a1 = (const T*)iB;
    const T* a2 = (const T*)K0st;
    const T* a3 = (const T*)LB;
    const T* a4 = (const T*)iKm;
    const T* a5 = (const T*)mu;
    const T* a6 = (const T*)lv;
    const T* a7 = (const T*)valid;
    T* o3 = (T*)r;
    T* o4 = (T*)q;
    double* o5 = (double*)part;
    if (staged) {
      auto kernel = gp_bound_fwd_subjects_kernel<T>;
      const int err = set_smem(kernel, smem);
      if (err) return err;
      kernel<<<blocks, NT, smem, st>>>(a0, a1, a2, a3, a4, a5, a6, a7, (T*)W,
                                       (double*)K64, (double*)W64, o3, o4,
                                       o5, (int*)queue, L, S, Tn, M, ldm);
    } else {
      // a subject's row tiles: one cluster
      auto kernel = gp_bound_fwd_tiles_kernel<T>;
      int err = set_smem(kernel, smem);
      if (err) return err;
      const int tiles = (Tn + rows - 1) / rows;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(tiles, L * S);
      cfg.blockDim = dim3(NT);
      cfg.dynamicSmemBytes = smem;
      cfg.stream = st;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = tiles;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = (int)cudaLaunchKernelEx(&cfg, kernel, a0, a1, a2, a3, a4, a5, a6,
                                    a7, o3, o4, o5, S, Tn, M, ldm, rows);
      if (err) {
        (void)cudaGetLastError();
        return err;
      }
    }
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

// sym: the longer subjects' d iB + d iB^T (written; null staged); diLB:
// staged written, else cuBLAS's (K0xz G) K0xz^T (read); queue: the staged
// kernels' subject queue, two ints of the stream's counters (zero between
// launches)
extern "C" int gp_bound_bwd_subjects(
    int itemsize, const void* gterms, const void* gkld, const void* pbatch,
    double ptot, const void* K0xz, const void* iB, const void* iLB,
    const void* K0st, const void* LB, const void* lv, const void* valid,
    const void* r, const void* q, const void* iKm, const void* Y2, void* sym,
    void* dK0xz, void* diLB, void* dK0st, void* dLB, void* dmu, void* dlv,
    void* queue, int L, int S, int Tn, int M, int ldm, int blocks, int rows,
    int staged, int smem, void* stream) {
  if (!subject_plan_ok(L, S, Tn, M, blocks, rows, staged) ||
      smem != subject_smem(3, staged, Tn, M, itemsize, rows) ||
      (staged ? !queue : !sym))
    return invalid();
  cudaStream_t st = (cudaStream_t)stream;
  GP_DISPATCH(itemsize, {
    const T* a0 = (const T*)gterms;
    const T* a1 = (const T*)gkld;
    const T* a2 = (const T*)pbatch;
    if (staged) {
      auto kernel = gp_bound_bwd_subjects_kernel<T>;
      const int err = set_smem(kernel, smem);
      if (err) return err;
      kernel<<<blocks, NT, smem, st>>>(
          a0, a1, a2, ptot, (const T*)K0xz, (const T*)iB, (const T*)iLB,
          (const T*)K0st, (const T*)LB, (const T*)lv, (const T*)valid,
          (const T*)r, (const T*)q, (const T*)iKm, (const T*)Y2, (T*)dK0xz,
          (T*)diLB, (T*)dK0st, (T*)dLB, (T*)dmu, (T*)dlv, (int*)queue, L, S,
          Tn, M, ldm);
    } else {
      auto kernel = gp_bound_bwd_tiles_kernel<T>;
      const int err = set_smem(kernel, smem);
      if (err) return err;
      const int nt = (Tn + 31) / 32;
      kernel<<<dim3(nt * (nt + 1) / 2 + nt, L * S), NT, smem, st>>>(
          a0, a1, a2, ptot, (const T*)iB, (const T*)K0st, (const T*)LB,
          (const T*)lv, (const T*)valid, (const T*)r, (const T*)q,
          (const T*)iKm, (const T*)diLB, (T*)sym, (T*)dK0xz, (T*)dK0st,
          (T*)dLB, (T*)dmu, (T*)dlv, S, Tn, M, ldm);
    }
  })
  return (int)cudaGetLastError();
}
