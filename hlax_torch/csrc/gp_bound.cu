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
//   gp_bound_fwd_latents (K2): a block a pair of tiles of a latent's M x
//     M matrices at a time (mirrored, or two diagonal ones); sum Kz o iK,
//     sum E o Kz, tr(iK H^T), m . iKm and the log-diagonals of the
//     factors; u and K1's five sums from its partials, P_batch; the
//     grid's last block adds the blocks' partials in a fixed order, in
//     double, into the terms (A, Bt, C, D, E, F, kqu), P_batch and,
//     without a mesh, kld_total.
//   gp_bound_bwd_latents (K4): the same walk of tile pairs, a pair's two
//     teams of four warps; from the terms' and kld_total's cotangents, G =
//     dKz = -w_D iK + w_E E_mat with its transpose beside it (for the one
//     cuBLAS product K0xz [G | G^T]), d iK's sum (its products' parts come
//     from cuBLAS), d H, d m (the tiles' column parts, added by the last
//     block) and the diagonal cotangents of the factors of K0zz and H.
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
// ~8 us.  K2 and K4 read and write a few [L, M, M] matrices (1.8 MB each
// in float): K2 8.0 MB (KziBK counted at the inputs' width; it reads it in
// double, 9.9 MB), ~2.4 us; K4 20.3 MB, ~6 us.
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
// is used.  Measured, the first latent kernels (a block a strip of a
// latent's rows, 288 blocks) spent their time waiting: K2 ~1.2 us on the
// transposed strip of H staged by 4-byte copies, ~4 us on its sums (u's
// 20 parts, four loads in flight, by 14 threads a block), ~4 us from its
// partials to its arrival at the counter, then a 4.6 us serial finish in
// the last block; K4 3.2 us on three strips staged by 4-byte copies and 5
// us on its entries, a round trip of loads for each of its seven loop
// turns.  So each now takes a pair of tiles a block (the tiles
// of a latent's matrices, see "the latent kernels' tiles" below): every
// input read once by 16-byte copies, all of a block's in flight before
// its first wait, the transposes in shared memory, the stores 16-byte
// vectors; K2's sums of u and of K1's partials spread over the grid's
// blocks with their loads in flight, its last block adding one round of
// the blocks' partials.  The counter of K2's (and, with m's gradient,
// K4's) last block is zero between launches (that block zeroes it), so
// the wrapper's per-stream buffer needs no fill.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

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
// the latent kernels' square tiles (LW x LW entries of a latent's [M, M]
// matrices, a staged one TILE_ELEMS entries), their blocks an SM (launch
// bounds: two, every block two tiles, the canonical 256 pairs one wave),
// and a latent block's scalar sums (K1's five, its own six, its count of
// P_batch's subjects)
constexpr int LW = 32, TILE_ELEMS = LW * (LW + 1);
constexpr int LATENT_BLOCKS = 2;
constexpr int NBLK = NSUB + NLAT + 1;
// K4's two teams of four warps, each with its copies and outputs
constexpr int TEAM = NT / 2;

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
  // warp_sum's butterfly of each value, the NV interleaved
  double s[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) s[j] = v[j];
#pragma unroll
  for (int o = 16; o; o >>= 1)
#pragma unroll
    for (int j = 0; j < NV; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < NV; ++j) red[warp * NV + j] = s[j];
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
// having written its partials first: the barrier, then thread 0's fence
// and arrival); the last zeroes the counter for the next launch.  The
// same in every thread of the block.
__device__ bool last_block(int* counter, int nblk) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == nblk - 1;
    if (last) {
      __threadfence();
      *counter = 0;
    }
  }
  __syncthreads();
  return last;
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

// --------------------------------------------------- the latent kernels' tiles
//
// K2 and K4 take each latent's [M, M] matrices in square tiles of LW x LW
// entries, a block a pair of tiles at a time: a mirrored pair (I, J) and
// (J, I), I < J, or two diagonal tiles (latent_pairs), so every block has
// two tiles of work, the transposed entries an output needs (H^T in tr1,
// iK0zz^T, E_mat^T and H^T in K4) lie in its pair and every input tile is
// read from global memory once, by 16-byte cp.async copies, all of a
// pair's in flight before the first wait (K2: the second tile's own
// inputs in a second group, landing while the first tile's sums run; K4:
// two teams of four warps, each with its share of the copies, landing
// while the other team stores).
// Each thread takes chunks of CE = 16 / sizeof(T) entries of a row
// (tile_chunk) and stores its outputs as 16-byte vectors.  The tiles
// whose transposes are read are staged as tiles (tile_at: rows 16-byte
// aligned, a warp's reads down a column in distinct banks); the others
// each thread stages into slots of its own (stage's ``own``: consecutive
// threads' 16 bytes side by side), which keeps registers free (two tiles'
// chunks held in registers spilled).  Where M is not a multiple of CE, or
// an array is not 16-byte aligned (M = 37, 7), each entry is copied and
// stored alone.  The grid is sized to the card (latent_plan): block b
// takes pairs b, b + grid, ... of the L pairs a latent.

template <typename T> __host__ __device__ constexpr int chunk_elems() {
  return 16 / (int)sizeof(T);
}
// the chunks of CE entries a thread takes of a tile
template <typename T> __host__ __device__ constexpr int tile_chunks() {
  return LW * LW / chunk_elems<T>() / NT;
}

// a staged tile's entry (s, c): row s at s LW + CE (s / CE), so the rows
// are 16-byte aligned and a warp's reads down a column (the mirrored
// tile's entries of its chunks, rows s = CE k + j) fall in distinct banks
template <typename T> __device__ __forceinline__ int tile_at(int s, int c) {
  return s * LW + chunk_elems<T>() * (s / chunk_elems<T>()) + c;
}

// chunk q of thread t: row r, columns c .. c + CE - 1 of the tile.  Float:
// a warp four rows of eight chunks; double: each half of a warp two rows
// of eight chunks (its 8-byte reads down a column then take 16 banks)
template <typename T>
__device__ __forceinline__ void tile_chunk(int t, int q, int& r, int& c) {
  if (sizeof(T) == 4) {
    r = t >> 3;
    c = 4 * (t & 7);
  } else {
    const int lane = t & 31;
    r = 4 * (t >> 5) + 2 * q + ((lane >> 3) & 1);
    c = 2 * ((lane & 7) + 8 * (lane >> 4));
  }
}

__device__ __forceinline__ void ld16(float* x, const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void ld16(double* x, const double* s) {
  const double2 v = *reinterpret_cast<const double2*>(s);
  x[0] = v.x;
  x[1] = v.y;
}
__device__ __forceinline__ void st16(float* d, const float* x) {
  *reinterpret_cast<float4*>(d) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void st16(double* d, const double* x) {
  *reinterpret_cast<double2*>(d) = make_double2(x[0], x[1]);
}

// x[k] = src[k], k < N: 16-byte loads where vec (then n >= N), else each
// entry, zero past n
template <int N, typename U>
__device__ __forceinline__ void load_run(U (&x)[N], const U* src, int n,
                                         bool vec) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < N; k += chunk_elems<U>()) ld16(x + k, src + k);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = k < n ? src[k] : U(0);
  }
}

// dst[k] = x[k], k < min(n, N): 16-byte stores where vec, else each entry
template <int N, typename U>
__device__ __forceinline__ void store_run(U* dst, const U (&x)[N], int n,
                                          bool vec) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < N; k += chunk_elems<U>()) st16(dst + k, x + k);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < n) dst[k] = x[k];
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src));
}

// A latent's pairs of tiles: its nt (nt - 1) / 2 mirrored pairs (I, J),
// (J, I), I < J, row by row, then its diagonal tiles two at a time, each
// its own mirror (nt (nt - 1) / 2 + (nt + 1) / 2 pairs, every one two
// tiles of work but a last lone diagonal one)
__host__ __device__ inline int latent_pairs(int nt) {
  return nt * (nt - 1) / 2 + (nt + 1) / 2;
}

// Tile x (0, 1) of pair p of a latent's: its first row and column, its
// rows and columns, whether it is there (a lone diagonal tile has no
// second) and which of the pair's tiles holds its transpose (``mir``)
struct PairTile {
  int R0, C0, nr, nc, mir;
  bool on;
  __device__ PairTile(int x, int p, int nt, int M) {
    const int noff = nt * (nt - 1) / 2;
    int a, b;
    if (p < noff) {
      int I = 0;
      while (p >= nt - 1 - I) {
        p -= nt - 1 - I;
        ++I;
      }
      const int J = I + 1 + p;
      a = x ? J : I;
      b = x ? I : J;
      mir = 1 - x;
      on = true;
    } else {
      a = b = 2 * (p - noff) + x;
      mir = x;
      on = a < nt;
    }
    R0 = a * LW;
    C0 = b * LW;
    nr = on ? min(LW, M - R0) : 0;
    nc = on ? min(LW, M - C0) : 0;
  }
  // whether this thread's chunk (r, c) is in the tile
  __device__ bool has(int r, int c) const { return on && r < nr && c < nc; }
};

// chunk q of thread th of a team of NTH threads (consecutive warps): the
// chunk q / (NT / NTH) of thread th + NTH (q mod NT / NTH) in tile_chunk's
// walk, so a team's warps read as a block's do; team_chunks of them
template <typename T, int NTH>
__device__ __forceinline__ void team_chunk(int th, int q, int& r, int& c) {
  tile_chunk<T>(th + NTH * (q % (NT / NTH)), q / (NT / NTH), r, c);
}
template <typename T, int NTH> __host__ __device__ constexpr int team_chunks() {
  return tile_chunks<T>() * (NT / NTH);
}

// Thread th's chunks (of a team of NTH) of tile tl of the [M, M] matrix
// src (entries U, T's chunks: CE of T's entries, P 16-byte pieces of U),
// by cp.async (committed by the caller): as a tile (tile_at, U = T) where
// ``own`` is false, else into its own slots, piece h of chunk q at (q P +
// h) NTH + th
template <typename T, int NTH = NT, typename U>
__device__ void stage(U* dst, const U* src, int M, const PairTile& tl,
                      bool own, bool vec, int th = threadIdx.x) {
  constexpr int CE = chunk_elems<T>(), PE = chunk_elems<U>(), P = CE / PE;
#pragma unroll
  for (int q = 0; q < team_chunks<T, NTH>(); ++q) {
    int r, c;
    team_chunk<T, NTH>(th, q, r, c);
    if (!tl.has(r, c)) continue;
    const U* g = src + (size_t)(tl.R0 + r) * M + tl.C0 + c;
#pragma unroll
    for (int h = 0; h < P; ++h) {
      U* s = own ? dst + ((q * P + h) * NTH + th) * PE
                 : dst + tile_at<T>(r, c) + h * PE;
      if (vec) {
        cp_async16(s, g + h * PE);
      } else {
        for (int k = 0; k < PE && c + h * PE + k < tl.nc; ++k)
          cp_async_elem<sizeof(U)>(s + k, g + h * PE + k);
      }
    }
  }
}

// thread th's chunk q from its own slots (stage's ``own``); entries a
// copy of each did not fill are not read
template <typename T, int NTH = NT, typename U>
__device__ __forceinline__ void own_chunk(U (&x)[chunk_elems<T>()],
                                          const U* src, int q,
                                          int th = threadIdx.x) {
  constexpr int PE = chunk_elems<U>(), P = chunk_elems<T>() / PE;
#pragma unroll
  for (int h = 0; h < P; ++h)
    ld16(x + h * PE, src + ((q * P + h) * NTH + th) * PE);
}

// a barrier of the NTH threads of team k (1, 2, ...; 0 is __syncthreads')
template <int NTH> __device__ __forceinline__ void team_sync(int k) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(k), "n"(NTH) : "memory");
}

// The sum of the n doubles src[j * step] in a fixed order, four running
// sums a_k over the entries j = k mod 4 of the whole groups of four, the
// rest into a_0, then (a_0 + a_1) + (a_2 + a_3): lane k of four
// consecutive lanes its a_k, all its loads in flight, the total in lane
// 0.  Every lane of the warp calls.
__device__ double sum_quad(const double* src, int n, size_t step) {
  const int k = threadIdx.x & 3, n4 = n & ~3;
  double a = 0.0;
  for (int j = k; j < n4; j += 32) {
    double x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = j + 4 * i < n4 ? __ldcg(src + (size_t)(j + 4 * i) * step) : 0.0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (j + 4 * i < n4) a += x[i];
  }
  if (k == 0)
    for (int j = n4; j < n; ++j) a += __ldcg(src + (size_t)j * step);
  const double a1 = __shfl_down_sync(0xffffffffu, a, 1);
  const double a2 = __shfl_down_sync(0xffffffffu, a, 2);
  const double a3 = __shfl_down_sync(0xffffffffu, a, 3);
  return (a + a1) + (a2 + a3);
}

// ------------------------------------------------------------------ K2
//
// A block a pair of tiles at a time (the grid walking the L pairs a
// latent): H's two tiles staged as tiles, iK0zz's, E_mat's and KziBK's
// into the threads' slots, their products summed into sum KziBK o
// iK0zz, sum E_mat o KziBK and tr(iK0zz H^T); pair p also takes rows p
// rpp .. of its latent (u from K1's parts in sum_quad's order, four lanes
// a row, m . iKm, the factors' log-diagonals) and its share of the
// latent's subject partials (K1's five sums); block b counts subjects b,
// b + grid, ... of P_batch.  Each block's twelve sums go to part2 (a
// column a scalar); the last block adds each scalar's column, a warp a
// column, and assembles the terms, P_batch and kld_total.

template <typename T>
__global__ void __launch_bounds__(NT, LATENT_BLOCKS)
    gp_bound_fwd_latents_kernel(
        const T* __restrict__ iK, const double* __restrict__ Kz,
        const T* __restrict__ Em, const T* __restrict__ H,
        const T* __restrict__ m, const T* __restrict__ iKm,
        const T* __restrict__ LK, const T* __restrict__ LH,
        const T* __restrict__ valid, const double* __restrict__ part1,
        int nchunks, double* __restrict__ part2, double* __restrict__ u,
        T* __restrict__ terms, T* __restrict__ pbatch, T* __restrict__ kld,
        int* counter, int L, int S, int Tn, int M, bool vec, double ptot,
        double ntot) {
  constexpr int CE = chunk_elems<T>(), Q = tile_chunks<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // H's two tiles; iK0zz's and E_mat's slots of each; KziBK's
  T* Hs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Hs + 2 * TILE_ELEMS;
  T* Es = Ks + 2 * LW * LW;
  double* Zs = reinterpret_cast<double*>(Es + 2 * LW * LW);
  GP_PHASE_BEGIN(2)
  const int tid = threadIdx.x;
  const int nt = (M + LW - 1) / LW, np = latent_pairs(nt);
  const int rpp = (M + np - 1) / np, cpp = (nchunks + np - 1) / np;
  const size_t MM = (size_t)M * M, ld1 = NSUB + M;
  // the subject blocks' five sums (A, Bt, C / 2, sum iB o K0_st, F), the
  // latents' six (sum Kz o iK, sum E o Kz, tr1, m . iKm, log diag LK, log
  // diag LH), then the subjects with a valid row
  double acc[NBLK] = {};
  for (long w = blockIdx.x; w < (long)L * np; w += gridDim.x) {
    const int l = (int)(w / np), p = (int)(w % np);
    const size_t mat = (size_t)l * MM;
    // two groups of copies: H's tiles and the first tile's slots, then the
    // second's, which land while the first tile's sums run
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const PairTile tl(x, p, nt, M);
      stage<T>(Hs + x * TILE_ELEMS, H + mat, M, tl, false, vec);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const PairTile tl(x, p, nt, M);
      stage<T>(Ks + x * LW * LW, iK + mat, M, tl, true, vec);
      stage<T>(Es + x * LW * LW, Em + mat, M, tl, true, vec);
      stage<T>(Zs + x * LW * LW, Kz + mat, M, tl, true, vec);
      cp_async_commit();
    }
    // K1's rows p cpp .. of latent l: their five sums
    const int c0 = p * cpp, ncr = min(cpp, nchunks - c0);
    for (int e = tid; e < NSUB * ncr; e += NT) {
      const double x = __ldcg(part1 + ((size_t)l * nchunks + c0 + e / NSUB)
                                          * ld1 + e % NSUB);
#pragma unroll
      for (int j = 0; j < NSUB; ++j)
        if (j == e % NSUB) acc[j] += x;
    }
    // rows p rpp .. of latent l, four lanes a row (whole warps)
    // (rpp <= LW: 4 rpp threads at most)
    if (tid < ((4 * rpp + 31) & ~31)) {
      const int i = tid / 4, mm = p * rpp + i;
      const bool row = i < rpp && mm < M;
      const size_t y = (size_t)l * M + mm;
      const bool lead = row && (tid & 3) == 0;
      // the row's own loads first, in flight with u's
      const T mv = lead ? m[y] : T(0), kv = lead ? iKm[y] : T(1);
      const T lk = lead ? LK[mat + (size_t)mm * (M + 1)] : T(1);
      const T lh = lead ? LH[mat + (size_t)mm * (M + 1)] : T(1);
      const double s = sum_quad(part1 + (size_t)l * nchunks * ld1 + NSUB
                                    + (row ? mm : 0),
                                row ? nchunks : 0, ld1);
      if (lead) {
        u[y] = s;
        acc[NSUB + 3] += (double)(mv * kv);
        acc[NSUB + 4] += (double)log(lk);
        acc[NSUB + 5] += (double)log(lh);
      }
    }
    // P_batch's subjects, in each block's first pair: subjects b, b + grid,
    // ... a warp each, their loads in flight with the copies
    if (w == blockIdx.x) {
      const int lane = tid & 31;
      for (long s = blockIdx.x + (long)(tid >> 5) * gridDim.x; s < S;
           s += (long)NW * gridDim.x) {
        bool any = false;
        for (int t = lane; t < Tn; t += 32) any |= valid[s * Tn + t] > T(0);
        if (__any_sync(0xffffffffu, any) && lane == 0) acc[NBLK - 1] += 1.0;
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (x == 0)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      if (x == 0) {
        GP_PHASE(1)
      }
      const PairTile tl(x, p, nt, M);
      // the tile's transpose of H: the pair's other (a diagonal one's own)
      const T* hm = Hs + tl.mir * TILE_ELEMS;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        int r, c;
        tile_chunk<T>(tid, q, r, c);
        if (!tl.has(r, c)) continue;
        T kv[CE], ev[CE];
        double zv[CE];
        own_chunk<T>(kv, Ks + x * LW * LW, q);
        own_chunk<T>(ev, Es + x * LW * LW, q);
        own_chunk<T>(zv, Zs + x * LW * LW, q);
#pragma unroll
        for (int k = 0; k < CE; ++k) {
          if (c + k >= tl.nc) break;
          acc[NSUB] += zv[k] * kv[k];
          acc[NSUB + 1] += ev[k] * zv[k];
          acc[NSUB + 2] += (double)(kv[k] * hm[tile_at<T>(c + k, r)]);
        }
      }
    }
    __syncthreads();       // the tiles read: free for the next pair
    GP_PHASE(2)
  }
  // the block's NBLK sums, a warp a sum: each thread's in shared memory
  // (the tiles' room), a lane's eight in order, then warp_sum's butterfly
  double* buf = reinterpret_cast<double*>(smem_raw);        // [NBLK][NT]
#pragma unroll
  for (int j = 0; j < NBLK; ++j) buf[j * NT + tid] = acc[j];
  __syncthreads();
  for (int j = tid >> 5; j < NBLK; j += NW) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < NT / 32; ++i) s += buf[j * NT + 32 * i + (tid & 31)];
    s = warp_sum(s);
    if ((tid & 31) == 0) part2[(size_t)j * gridDim.x + blockIdx.x] = s;
  }
  GP_PHASE(3)
  const bool last = last_block(counter, gridDim.x);
  GP_PHASE(5)
  if (!last) {
    GP_PHASE_END
    return;
  }
  // the last block: each scalar's grid of partials a warp (warp w scalars
  // w and w + NW), a lane's in order (all its loads in flight together),
  // then warp_sum's butterfly
  __shared__ double sums[NBLK];
  {
    const int G = gridDim.x, lane = tid & 31, warp = tid >> 5;
    double t2[2] = {0.0, 0.0};
    for (int b0 = 0; b0 < G; b0 += 256) {
      double x[2][8];
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int j = warp + NW * k, b = b0 + 32 * i + lane;
          x[k][i] = j < NBLK && b < G ? __ldcg(part2 + (size_t)j * G + b)
                                      : 0.0;
        }
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (warp + NW * k < NBLK && b0 + 32 * i + lane < G)
            t2[k] += x[k][i];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const double t = warp_sum(t2[k]);
      if (warp + NW * k < NBLK && lane == 0) sums[warp + NW * k] = t;
    }
  }
  __syncthreads();
  GP_PHASE(4)
  if (tid == 0) {
    const double* a = sums;
    const double* b = sums + NSUB;
    const double A = a[0], Bt = a[1], C = 2.0 * a[2], D = a[3] - b[0];
    const double E = b[1], F = a[4];
    const double kqu = 0.5 * (b[2] + b[3] - (double)L * M + 2.0 * b[4]
                              - 2.0 * b[5]);
    const double t[NTERM] = {A, Bt, C, D, E, F, kqu};
    for (int j = 0; j < NTERM; ++j) terms[j] = (T)t[j];
    const double P = sums[NBLK - 1];
    *pbatch = (T)P;
    if (kld)
      *kld = (T)(ptot / P * 0.5 * (A + Bt + C + D + E - F) + kqu
                 - (double)L * ntot / 2.0);
  }
  GP_PHASE(6)
  GP_PHASE_END
}

// ------------------------------------------------------------------ K4
//
// The same walk of tile pairs: iK0zz's, E_mat's and H's two tiles staged
// as tiles, KziBK's, R1's and R2's into the threads' slots, v = w_A u +
// w_kqu m / 2 of the pair's rows and m of its columns in shared memory;
// each entry of both tiles written with the expression of a row-a-block
// kernel (G2's second half from the mirrored tile's iK0zz and E_mat, d
// iK0zz's H^T, d H's iK0zz^T), by two teams of four warps that overlap
// their copies with each other's stores: team 0 copies iK0zz's and
// E_mat's tiles and writes G2 (and d H) and the factors' diagonal
// cotangents, team 1 copies the rest and writes d iK0zz.  With m's
// gradient each tile's column sums of iK0zz v go to dmpart (a latent's
// row tile each), and the last block adds a column's row tiles in order
// into d m.

template <typename T>
__global__ void __launch_bounds__(NT, LATENT_BLOCKS)
    gp_bound_bwd_latents_kernel(
        const T* __restrict__ gterms, const T* __restrict__ gkld,
        const T* __restrict__ pbatch, double ptot, const T* __restrict__ iK,
        const T* __restrict__ Kz, const T* __restrict__ Em,
        const T* __restrict__ H, const T* __restrict__ m,
        const T* __restrict__ iKm, const double* __restrict__ u,
        const T* __restrict__ LK, const T* __restrict__ LH,
        const T* __restrict__ R1, const T* __restrict__ R2,
        const T* __restrict__ R3, T* __restrict__ G2, T* __restrict__ dIK,
        T* __restrict__ dH, T* __restrict__ dm, T* __restrict__ dLK,
        T* __restrict__ dLH, double* __restrict__ dmpart, int* counter,
        int L, int M, bool vec) {
  constexpr int CE = chunk_elems<T>(), Q = tile_chunks<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // iK0zz's, E_mat's and H's tiles, the pair's first then second; then
  // KziBK's, R1's and R2's slots of each
  T* sh = reinterpret_cast<T*>(smem_raw);
  T* so = sh + 6 * TILE_ELEMS;
  __shared__ double vs[2 * LW];          // v of each tile's rows
  __shared__ T ms[2 * LW];               // m of each tile's columns
  // a diagonal tile's cotangents of the factors' diagonals
  __shared__ T dks[2 * LW], dls[2 * LW];
  GP_PHASE_BEGIN(3)
  const int tid = threadIdx.x;
  double w[NTERM];
  term_weights(gterms, gkld, pbatch, ptot, w);
  const double wa = w[0], wd = w[3], we = w[4], wk = w[6];
  const int nt = (M + LW - 1) / LW, np = latent_pairs(nt);
  const size_t MM = (size_t)M * M;
  for (long it = blockIdx.x; it < (long)L * np; it += gridDim.x) {
    const int l = (int)(it / np), p = (int)(it % np);
    const size_t mat = (size_t)l * MM;
    // two teams of four warps, each its own copies, barrier and outputs:
    // team 0 G2 (with d H) from iK0zz's and E_mat's tiles, and the
    // factors' diagonal cotangents; team 1 d iK0zz from H's tiles and
    // KziBK's, R1's and R2's slots; so each team's stores follow its own
    // copies, G2's while team 1's copies are still landing
    const int team = tid / TEAM, th = tid % TEAM, ti = th % LW;
    // the loads of v's rows (u, m) and the columns' m (team 1), the
    // diagonal tiles' factor diagonals (team 0) first: they land before
    // the copies' burst
    const PairTile tv(th / LW < 2 ? th / LW : 0, p, nt, M);
    const bool in = th < 2 * LW && tv.on;
    const bool rv = in && team == 1 && ti < tv.nr;
    const bool cv = in && team == 1 && ti < tv.nc;
    const bool dv = in && team == 0 && ti < tv.nr && dLK && tv.R0 == tv.C0;
    const size_t yr = (size_t)l * M + tv.R0 + ti;
    const double ur = rv ? u[yr] : 0.0;
    const T mr = rv ? m[yr] : T(0);
    const T mc = cv ? m[(size_t)l * M + tv.C0 + ti] : T(0);
    const size_t od = mat + (size_t)(tv.R0 + ti) * (M + 1);
    const T lk = dv ? LK[od] : T(1), lh = dv ? LH[od] : T(1);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const PairTile tl(x, p, nt, M);
      if (team == 0) {
        stage<T, TEAM>(sh + x * TILE_ELEMS, iK + mat, M, tl, false, vec, th);
        stage<T, TEAM>(sh + (2 + x) * TILE_ELEMS, Em + mat, M, tl, false,
                       vec, th);
      } else {
        stage<T, TEAM>(sh + (4 + x) * TILE_ELEMS, H + mat, M, tl, false,
                       vec, th);
        stage<T, TEAM>(so + x * LW * LW, Kz + mat, M, tl, true, vec, th);
        stage<T, TEAM>(so + (2 + x) * LW * LW, R1 + mat, M, tl, true, vec,
                       th);
        stage<T, TEAM>(so + (4 + x) * LW * LW, R2 + mat, M, tl, true, vec,
                       th);
      }
    }
    cp_async_commit();
    // d iKm's share of d iK and d m, v = w_A u + w_kqu m / 2, of each
    // tile's rows; m of its columns; the factors' diagonal cotangents
    if (rv) vs[th] = wa * ur + 0.5 * wk * (double)mr;
    if (cv) ms[th] = mc;
    if (dv) {
      dks[th] = (T)(wk / (double)lk);
      dls[th] = (T)(-wk / (double)lh);
    }
    cp_async_wait<0>();
    team_sync<TEAM>(1 + team);
    GP_PHASE(1)
    if (team == 0) {
      // G2's two halves of both tiles (and H's cotangent, R3 read here: H
      // needs a gradient only with Adam)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const PairTile tl(x, p, nt, M);
        const T* ko = sh + x * TILE_ELEMS;
        const T* eo = sh + (2 + x) * TILE_ELEMS;
        const T* km = sh + tl.mir * TILE_ELEMS;     // the mirrored tile's
        const T* em = sh + (2 + tl.mir) * TILE_ELEMS;
#pragma unroll
        for (int q = 0; q < team_chunks<T, TEAM>(); ++q) {
          int r, c;
          team_chunk<T, TEAM>(th, q, r, c);
          if (!tl.has(r, c)) continue;
          const int R = tl.R0 + r, n = tl.nc - c;
          const size_t o = mat + (size_t)R * M + tl.C0 + c;
          const size_t g = ((size_t)l * M + R) * 2 * M + tl.C0 + c;
          T k0[CE], e0[CE], ga[CE], gb[CE];
          ld16(k0, ko + tile_at<T>(r, c));
          ld16(e0, eo + tile_at<T>(r, c));
#pragma unroll
          for (int j = 0; j < CE; ++j) {
            // the mirrored entry (c + j, r)
            const int at = tile_at<T>(c + j < tl.nc ? c + j : c, r);
            const double k = k0[j], kt = km[at];
            ga[j] = (T)(-wd * k + we * (double)e0[j]);
            gb[j] = (T)(-wd * kt + we * (double)em[at]);
          }
          store_run(G2 + g, ga, n, vec);
          store_run(G2 + g + M, gb, n, vec);
          if (dH) {
            T r3[CE], dh[CE];
            load_run(r3, R3 + o, n, vec);
#pragma unroll
            for (int j = 0; j < CE; ++j) {
              const double kt = km[tile_at<T>(c + j < tl.nc ? c + j : c, r)];
              dh[j] = (T)(0.5 * wk * kt + we * (double)r3[j]);
            }
            store_run(dH + o, dh, n, vec);
          }
        }
      }
      GP_PHASE(2)
      // the factors' diagonal cotangents, zero off the diagonal
      if (dLK) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const PairTile tl(x, p, nt, M);
#pragma unroll
          for (int q = 0; q < team_chunks<T, TEAM>(); ++q) {
            int r, c;
            team_chunk<T, TEAM>(th, q, r, c);
            if (!tl.has(r, c)) continue;
            const int R = tl.R0 + r, n = tl.nc - c;
            const size_t o = mat + (size_t)R * M + tl.C0 + c;
            T dk[CE], dl[CE];
#pragma unroll
            for (int j = 0; j < CE; ++j) {
              const bool d = R == tl.C0 + c + j;
              dk[j] = d ? dks[x * LW + r] : T(0);
              dl[j] = d ? dls[x * LW + r] : T(0);
            }
            store_run(dLK + o, dk, n, vec);
            store_run(dLH + o, dl, n, vec);
          }
        }
      }
      GP_PHASE(5)
    } else {
      // d iK0zz of both tiles
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const PairTile tl(x, p, nt, M);
        const T* hm = sh + (4 + tl.mir) * TILE_ELEMS;
#pragma unroll
        for (int q = 0; q < team_chunks<T, TEAM>(); ++q) {
          int r, c;
          team_chunk<T, TEAM>(th, q, r, c);
          if (!tl.has(r, c)) continue;
          const int R = tl.R0 + r, n = tl.nc - c;
          const size_t o = mat + (size_t)R * M + tl.C0 + c;
          T kz[CE], r1[CE], r2[CE], di[CE];
          own_chunk<T, TEAM>(kz, so + x * LW * LW, q, th);
          own_chunk<T, TEAM>(r1, so + (2 + x) * LW * LW, q, th);
          own_chunk<T, TEAM>(r2, so + (4 + x) * LW * LW, q, th);
          const double vr = vs[x * LW + r];
#pragma unroll
          for (int j = 0; j < CE; ++j) {
            const int at = tile_at<T>(c + j < tl.nc ? c + j : c, r);
            di[j] = (T)(-wd * (double)kz[j] + 0.5 * wk * (double)hm[at]
                        + vr * (double)ms[x * LW + c + j]
                        + we * ((double)r1[j] + (double)r2[j]));
          }
          store_run(dIK + o, di, n, vec);
        }
      }
      GP_PHASE(6)
    }
    if (dm) __syncthreads();     // iK0zz's tiles (team 0's) and v (team 1's)
    // d m's parts: each tile's column sums of iK0zz v over its rows
    if (dm && tid < 2 * LW) {
      const int x = tid / LW, c = tid % LW;
      const PairTile tl(x, p, nt, M);
      if (tl.on && c < tl.nc) {
        const T* ko = sh + x * TILE_ELEMS;
        double s = 0.0;
        for (int r = 0; r < tl.nr; ++r)
          s += (double)ko[tile_at<T>(r, c)] * vs[x * LW + r];
        dmpart[((size_t)l * nt + tl.R0 / LW) * M + tl.C0 + c] = s;
      }
    }
    __syncthreads();       // the tiles, v and m read: free for the next pair
    GP_PHASE(3)
  }
  if (dm) {
    // d m = iK^T v + w_kqu iKm / 2: a column's row tiles in order
    const bool last = last_block(counter, gridDim.x);
    if (last)
      for (int y = tid; y < L * M; y += NT) {
        const int l = y / M, c = y % M;
        double s = 0.0;
        for (int R = 0; R < nt; ++R)
          s += __ldcg(dmpart + ((size_t)l * nt + R) * M + c);
        dm[y] = (T)(s + 0.5 * wk * (double)iKm[y]);
      }
    GP_PHASE(4)
  }
  GP_PHASE_END
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

// K2's (k = 2: H's two tiles, iK0zz's and E_mat's slots, KziBK's in
// double) and K4's (k = 4: iK0zz's, E_mat's and H's tiles, KziBK's, R1's
// and R2's slots) dynamic shared bytes (latent_smem,
// hlax_torch/ops/gp_bound.py)
int latent_smem(int k, int z) {
  const int tile = TILE_ELEMS * z, own = LW * LW * z;
  return k == 2 ? 2 * tile + 4 * own + 2 * LW * LW * 8 : 6 * tile + 6 * own;
}
// K2's tiles' room takes its block's NBLK sums a thread after its pairs
static_assert(2 * TILE_ELEMS * 4 + 6 * LW * LW * 4 >= NBLK * NT * 8 &&
                  NBLK <= 2 * NW,
              "K2's shared memory holds its block's sums, two a warp");

// Whether K2's and K4's launch takes the plan: `blocks` blocks walking the
// L latent_pairs(nt) pairs of tiles, at most one a pair
bool latent_plan_ok(int L, int M, int blocks) {
  const long pairs = (long)L * latent_pairs((M + LW - 1) / LW);
  return L >= 1 && M >= 1 && pairs < (1L << 31) && blocks >= 1 &&
         blocks <= pairs;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Whether the latent kernels take 16-byte chunks: M a multiple of a
// chunk's entries and every array aligned (a null one is)
bool vectors(int itemsize, int M, std::initializer_list<const void*> ps) {
  if (itemsize < 1 || M % (16 / itemsize)) return false;
  for (const void* p : ps)
    if (!aligned16(p)) return false;
  return true;
}

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
    int L, int S, int Tn, int M, int blocks, double ptot, double ntot,
    int smem, void* stream) {
  if (!latent_plan_ok(L, M, blocks) || smem != latent_smem(2, itemsize) ||
      nchunks < 1 || !counter)
    return invalid();
  const bool vec = vectors(itemsize, M, {iK, Kz64, Em, H});
  cudaStream_t st = (cudaStream_t)stream;
  GP_DISPATCH(itemsize, {
    auto kernel = gp_bound_fwd_latents_kernel<T>;
    const int err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<blocks, NT, smem, st>>>(
        (const T*)iK, (const double*)Kz64, (const T*)Em, (const T*)H,
        (const T*)m, (const T*)iKm, (const T*)LK, (const T*)LH,
        (const T*)valid, (const double*)part1, nchunks, (double*)part2,
        (double*)u, (T*)terms, (T*)pbatch, (T*)kld, (int*)counter, L, S, Tn,
        M, vec, ptot, ntot);
  })
  return (int)cudaGetLastError();
}

// dmpart: d m's parts, L x tiles x M doubles, and counter (zero between
// launches) where m needs a gradient (dm), else null
extern "C" int gp_bound_bwd_latents(
    int itemsize, const void* gterms, const void* gkld, const void* pbatch,
    double ptot, const void* iK, const void* Kz, const void* Em,
    const void* H, const void* m, const void* iKm, const void* u,
    const void* LK, const void* LH, const void* R1, const void* R2,
    const void* R3, void* G2, void* dIK, void* dH, void* dm, void* dLK,
    void* dLH, void* dmpart, void* counter, int L, int M, int blocks,
    int smem, void* stream) {
  if (!latent_plan_ok(L, M, blocks) || smem != latent_smem(4, itemsize) ||
      (dH && !R3) || (!dLK != !dLH) || (dm && (!dmpart || !counter)))
    return invalid();
  const bool vec = vectors(itemsize, M, {iK, Kz, Em, H, m, R1, R2, R3, G2,
                                         dIK, dH, dLK, dLH});
  cudaStream_t st = (cudaStream_t)stream;
  GP_DISPATCH(itemsize, {
    auto kernel = gp_bound_bwd_latents_kernel<T>;
    const int err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<blocks, NT, smem, st>>>(
        (const T*)gterms, (const T*)gkld, (const T*)pbatch, ptot,
        (const T*)iK, (const T*)Kz, (const T*)Em, (const T*)H, (const T*)m,
        (const T*)iKm, (const double*)u, (const T*)LK, (const T*)LH,
        (const T*)R1, (const T*)R2, (const T*)R3, (T*)G2, (T*)dIK, (T*)dH,
        (T*)dm, (T*)dLK, (T*)dLH, (double*)dmpart, (int*)counter, L, M, vec);
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
