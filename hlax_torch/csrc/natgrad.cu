// natgrad: hand-written kernels for XLA's fusions of hlax's natural-gradient
// chain: the closed-form quantities grad_m and grad_H of the KL bound
// (kld_upper_bound, hlax/gp/elbo.py:237-285) and the update of (m, H)
// (natural_gradient_update, hlax/gp/elbo.py:425-469).  hlax jits both and
// XLA folds the chains between their dots into a few fusions; the port ran
// them op by op (hlax_torch/ops/natgrad.py's plain versions, ~45 kernels a
// step).  No TPU kernel: the one Pallas kernel on this path is the mid
// Cholesky kernel (csrc/chol_inv_mid.cu), which the update calls unchanged
// between K7 and K8.
//
// With, for each latent l (iB_s = B_s^-1 [T, T] a subject's, mu, valid
// [S, T], K0xz_s [T, M], iLK the inverse factor of K0zz, iK = iLK^T iLK,
// iH = H^-1, m [M], lr the step):
//   K5  natgrad_fwd_subjects: ng_P1 = sum_s K0xz_s^T (iB_s (mu_s valid_s))
//       (hlax/gp/elbo.py:241-243);
//   cuBLAS (the wrapper's, as hlax leaves them to XLA's dots): A = K0xz
//       iLK^T, G = iLB A, C_w = sum_st G^T G (on a mesh summed over the
//       ranks, with ng_P1), X = iLK^T (I + C_w) iLK as iLK^T baddbmm(iLK,
//       C_w, iLK);
//   K6  natgrad_fwd_latents: B = (X + X^T) / 2, grad_H = (B - iH) / 2,
//       grad_m = B m - iK ng_P1 (hlax/gp/elbo.py:272-282);
//   K7  natgrad_update_pre: iH_new = iH + lr (grad_H + grad_H^T), with a
//       jitter + jitter mean(diag iH_new) I, and rhs = iH m - lr (grad_m -
//       2 grad_H m) (hlax/gp/elbo.py:459-463 and the bracket of :465-468);
//   the mid kernel: iLA, the inverse factor of iH_new (or the library's);
//   K8  natgrad_update_finish: H_new = iLA^T iLA and m_new = H_new rhs,
//       cast to the state's dtype (hlax/gp/elbo.py:454, :464-469).
// Each is a template on the arithmetic's type and the other type it reads
// or writes: K5 on its inputs' and ng_P1's (float and float, double and
// double, or float inputs and a double ng_P1: --nat_grad_f64), K6-K8 on the
// chain's and the state's (m, H) (float and float, double and double,
// double and float).
//
// What bounds them on an H100 at the canonical [L, S, T, M] = [32, 20, 20,
// 120], float32: a launch's fixed part (about 2 us from the event before
// a launch to the one after it, beyond its blocks' span), one round trip
// to L2 or device memory, and the bytes.  K5 reads K0xz (6.1 MB),
// iB (1.0 MB), mu and valid and writes ng_P1: ~2.1 us at 3.35 TB/s against
// 0.4 MFLOP a latent.  K6 reads X, iK and iH and writes grad_H (4 x 1.8
// MB), K7 reads iH and grad_H and writes iH_new (3 x 1.8 MB), K8 reads
// iLA's lower triangle and writes H_new (1.5 x 1.8 MB): 0.8-2.2 us each;
// K8's product, M^3 / 6 multiply-adds a latent (9 MFLOP in all), is ~0.3 us
// on the FP64 tensor cores.  So each is a launch of a few microseconds
// that replaces five to fifteen of the plain chain's, built to read its
// inputs once from device memory and to need no pass or block after it:
//   K5 splits a latent's S T rows over one thread-block cluster (the plan's
//     cl blocks, subjects_plan: 3 at the canonical batch), a block a
//     contiguous share of them.  At its start a block issues its rows' iB
//     (one run) and then its rows of K0xz (one run of whole rows, 64 KB in
//     float) as two bulk copies (Hopper's cp.async.bulk on mbarriers; the
//     copies land in the order they are issued) and reads mu and valid;
//     it makes iB mu of its rows (a thread a row, in double) while K0xz
//     flies, so iB mu is made once a latent; then its threads, a column
//     each in groups of rows, sum the rows' K0xz times iB mu from shared
//     memory.  Each column's sum goes into the inbox of the block owning
//     it (distributed shared memory), and after the cluster's one barrier
//     the owner adds the blocks' sums in block order.  Rows past what
//     shared memory holds go through a ring of two stages; subjects longer
//     than TP rows take iB mu from cuBLAS.
//   K6 and K7 take a (strip of R rows, latent) a block and a warp a
//     16-byte unit of its rows, V = 4 in float and 2 in double (strip_plan,
//     hlax_torch/ops/natgrad.py: the most rows, at most 16, that still
//     give half the SMs a block and fit shared memory: 16 at the canonical
//     shape and a mesh rank's).  At its start every thread issues its share of the block's
//     inputs as cp.async copies into shared memory, consecutive threads on
//     consecutive 16-byte units: the strip's rows of each [M, M] input
//     (one contiguous run each), the box of transposed entries X[0:M,
//     i0:i0 + R] (K6) or grad_H's (K7) as M row pieces of R entries, the
//     latent's vectors and, in K7 with jitter, the diagonals of iH and
//     grad_H (element copies where a run or piece is off 16 bytes); then
//     one block barrier.  A warp's lanes stride over the columns; a lane
//     reads its V rows' transposed entries as one 16-byte unit of the box
//     (an odd number of units a box row: no bank conflict) and m and ng_P1
//     once a column, writes the rows' entries and adds their products in
//     double, the rows unguarded but in a ragged last strip; a butterfly
//     gives each row's sum (grad_m, or iH m and grad_H m) in a fixed
//     order, with no block barrier after the loads.  K7's mean of diag
//     iH_new is summed by every warp alike from the staged diagonals, so
//     jitter adds no pass that waits for another; jitter 0 copies no
//     diagonal.
//   K8 sums each entry of H_new = iLA^T iLA once: only the tiles (I, J), I
//     >= J, of 32 rows, over k >= 32 I (iLA is lower triangular; its
//     entries above the diagonal and rows past M read as exact zeros),
//     each tile as two tasks of 16 columns, on the FP64 tensor cores
//     (mma.sync m16n8k8 f64: wgmma has no f64), float entries widened
//     exactly to double on their way into the fragments.  Each entry is
//     rounded to the chain's type once and written with its mirror from the
//     same register, so H_new is exactly symmetric.  A latent's blocks are
//     one cluster (finish_plan: 3 at the canonical shape), block c taking
//     the row tiles I = c, c + cl, ...; where the latent's rows fit shared
//     memory (M <= 128 in float and double, every path of the main
//     program) a block stages its rows k >= 32 c by one bulk copy and
//     splits its tasks' rows k over its spare warps (the row tiles with the
//     longest parts first; the parts added in order), else it walks k
//     through a ring of two stages of KC rows once a round of tasks.
//     m_new = H_new rhs comes from the same registers, from H_new rounded
//     to the chain's type: a task gives its rows H[I, J] rhs[J] and, below
//     the diagonal, its columns H[I, J]^T rhs[I] (a butterfly each); the
//     block adds them into its partial of each row in task order, pushes
//     the partial into the inbox of the row's owner, and after the
//     cluster's barrier the owner adds the blocks' partials in block order.
//   Measured on the H100 (tools/natgrad_phases.py, chip_smoke.py; PERF.md),
//   the forms before these spent their time elsewhere than their work: K5
//   as a (32 columns, latent) block of 1024 threads made iB mu for all of
//   its latent's rows (a thread a row at an 80-byte stride, four times a
//   latent) and then read K0xz, two serial round trips to device memory;
//   K8 as a strip of 8 rows a block re-read iLA's rows k >= i0 through two
//   cp.async buffers and summed both triangles by DFMA, at 22x its bound;
//   K6 and K7 as a thread a column of a strip of 8 rows loaded their
//   entries inline and ended with a block sum of R (K7: 2 R) doubles
//   through shared memory and two barriers (0.9 and 1.5 us of a block
//   that spans 4.4-5.4 us warm, float32), K7 with jitter after a serial
//   pass over the diagonal (1.4 us warm, 1.9 cold).  Their transposed
//   loads, R consecutive entries of a thread's row, were not what held
//   them back: L1 serves a row's R entries after its first load, and a
//   build reading the same bytes in order was slower (K6 6.9 against 6.2
//   us, the tool's coalesced build).  Now, float32 warm at the canonical
//   shape, K6 takes 0.0049-0.0051 ms and K7 0.0047-0.0048 (the earlier
//   forms' 0.0065 and 0.0068); a block issues its copies and waits for
//   them in 1.5 us, does its element work in 1.0-1.2 and its sums in
//   0.2-0.3.  Dropped on
//   the way: a warp a row (a box entry and two widenings of m and ng_P1 an
//   entry: slower than the earlier K6); a row's work behind its own guard (a
//   column's rows ran in series); the strip rows as one bulk copy each on
//   an mbarrier, K5's pattern (0.2-0.4 us slower: K6 5.60 against 5.35
//   us, K7 5.61 against 5.26 in the tool's instrumented builds); 32 rows
//   a strip (no faster than 16 at the canonical shape and a mesh rank's).
//   What the phases showed on the way, and what it changed: a bulk copy
//   for each 128-byte row piece of a 32-column slab of K0xz took most of
//   a block's time to issue (whole-row runs, one copy a block); clusters
//   of 4 blocks at one block an SM did not all fit the GPCs at once and
//   ran a second wave (the plan's cluster_blocks; tools/natgrad_phases.py
//   times 1 to 4 blocks a cluster); the m8n8k4 f64 shape runs at half of
//   the m16n8k8 one's rate (the tool's mma lines); reading the cluster's
//   partials back after a barrier cost a second barrier (the push); one
//   block a latent is slower (chip_smoke.py's layouts lines); staging
//   K8's entries in shared memory for 16-byte stores cost more than the
//   scattered stores it replaced (dropped).
// Every sum is in double, in a fixed order, with no atomics, so a CUDA
// graph replays the eager call's bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

// marks of the kernels' phases (K5, K6, K7, K8), read by
// tools/natgrad_phases.py (which defines them); nothing otherwise
#ifndef NG_PHASE_BEGIN
#define NG_PHASE_BEGIN(k)
#define NG_PHASE(k)
#define NG_PHASE_END
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 512;        // K5's threads a block
constexpr int TP = 32;         // K5 takes iB mu from cuBLAS past TP rows
constexpr int CLUSTER = 8;     // K5, K8: blocks a cluster at most (portable)
constexpr int RMAX = 16;       // K6, K7: a block's rows at most
constexpr int SWMAX = 8;       // K6, K7: warps a block at most
constexpr int MAX_M = 512;     // K6-K8: columns at most
constexpr int FT = 32;         // K8: a tile's rows
constexpr int FH = 16;         // K8: a task's columns (half a tile)
constexpr int FWMAX = 16;      // K8: warps a block at most

__host__ __device__ constexpr long al16(long b) { return (b + 15) / 16 * 16; }

// K5's dynamic shared bytes, in the order the kernel carves them: `stages`
// stages of `chunk` whole rows of K0xz, the chunk's iB rows, mu valid of
// the subjects they span (chunk + 2 T doubles) and its iB mu (where `iB`,
// the kernel making iB mu; else its iB mu only), and the inbox of column
// partials, the cluster's `cl` blocks' of every column (cl M doubles)
// (subjects_smem, hlax_torch/ops/natgrad.py)
__host__ __device__ constexpr long subjects_smem(int chunk, int stages,
                                                 int M, int Tn, bool iB,
                                                 int cl, int z) {
  return al16((long)stages * chunk * M * z)
         + (iB ? al16((long)chunk * Tn * z) + al16(((long)chunk + 2 * Tn) * 8)
               : 0)
         + al16((long)chunk * 8) + (long)cl * M * 8;
}

// K8's rows a stage: all of them, rounded up to a k-step of 8, where the
// chunk takes the whole latent (KC >= M), else KC
__host__ __device__ constexpr int finish_rows(int M, int KC) {
  return KC >= M ? (M + 7) / 8 * 8 : KC;
}

// K8's dynamic shared bytes: one stage of the whole latent's rows and a
// warp's partial of a split task (FT x FH doubles) for each of `warps`, or
// a ring of two stages of KC rows; then the inbox of m_new's partials, the
// cluster's `cl` blocks' of every row (finish_smem,
// hlax_torch/ops/natgrad.py)
__host__ __device__ constexpr long finish_smem(int M, int KC, int warps,
                                               int cl, int z) {
  return (KC >= M ? al16((long)finish_rows(M, KC) * M * z)
                        + (long)warps * FT * FH * 8
                  : 2L * finish_rows(M, KC) * M * z)
         + (long)cl * ((M + FT - 1) / FT * FT) * 8;
}

// K6 and K7's staged box, grad_H[0:M, i0:i0 + R] (X's in K6): a row of
// each of its M pieces, R entries rounded up to 16-byte units, an odd
// number of them, so a quarter warp's 16-byte reads of eight rows fall in
// distinct banks (box_stride, hlax_torch/ops/natgrad.py)
__host__ __device__ constexpr int box_stride(int R, int z) {
  return ((R * z + 15) / 16 | 1) * 16 / z;
}

// K6 and K7's dynamic shared bytes: `rows` arrays of a strip's R rows (K6
// X, iK and iH; K7 iH and grad_H), the box, `vecs` vectors of M in the
// chain's type (K6 ng_P1; K7 the diagonals of iH and grad_H) and m in the
// state's (strip_smem, hlax_torch/ops/natgrad.py)
__host__ __device__ constexpr long strip_smem(int R, int M, int z, int zs,
                                              int rows, int vecs) {
  return rows * al16((long)R * M * z) + al16((long)M * box_stride(R, z) * z)
         + al16((long)vecs * M * z) + al16((long)M * zs);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int N>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(1u) : "memory");
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

// the cluster's barrier, its halves apart: a thread's arrivals and waits
// alternate
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// an arrival that orders nothing: this block has started, so the others may
// write its shared memory once they have waited for it
__device__ __forceinline__ void cluster_arrive_started() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// K5: ng_P1[l, j] = sum_{s, t} K0xz[l, s, t, j] v[l, s, t], v = iB (mu
// valid) per subject, computed here (iBmu null) or cuBLAS's (iBmu
// [L, S, T]).  Grid (cl, L), a latent's cl blocks one cluster; block c
// takes the latent's rows [c q, (c + 1) q), q = ceil(S T / cl), in chunks
// of `chunk` rows (K0xz's rows and the chunk's iB rows each one contiguous
// run: a bulk copy each where `bulk`), sums their columns (NT / Mp groups
// of a thread a column, the groups' sums in order) and pushes each
// column's sum into the inbox of its owner (a range of the columns a
// block); after the cluster's barrier the owner adds the blocks' sums in
// block order.  mu [S, T, ldm] (this rank's latents first).
template <typename T, typename O>
__global__ void __launch_bounds__(NT) natgrad_fwd_subjects_kernel(
    const T* __restrict__ iB, const T* __restrict__ iBmu,
    const T* __restrict__ mu, const T* __restrict__ valid,
    const T* __restrict__ K0xz, O* __restrict__ ngP1, int S, int Tn, int M,
    int ldm, int chunk, bool bulk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];    // the ring's stages, iB's
  __shared__ double red[NT];
  NG_PHASE_BEGIN(0)
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = gridDim.x, c = blockIdx.x, l = blockIdx.y, tid = threadIdx.x;
  const long R = (long)S * Tn, q = (R + cl - 1) / cl;
  const long rbeg = min(R, c * q), rend = min(R, rbeg + q);
  const int nchunks = (int)((rend - rbeg + chunk - 1) / chunk);
  const int stages = chunk >= q ? 1 : 2;
  const bool own_iB = iBmu == nullptr;
  // a thread a column j of group g (NG groups of Mp threads)
  const int Mp = (M + 31) / 32 * 32, NG = NT / Mp, g = tid / Mp,
            j = tid % Mp;
  const bool on = g < NG && j < M;
  unsigned char* p = smem_raw;
  T* ks = reinterpret_cast<T*>(p);
  p += al16((long)stages * chunk * M * sizeof(T));
  T* ibs = reinterpret_cast<T*>(p);
  double* mvs = nullptr;
  if (own_iB) {
    p += al16((long)chunk * Tn * sizeof(T));
    mvs = reinterpret_cast<double*>(p);
    p += al16(((long)chunk + 2 * Tn) * 8);
  }
  double* v = reinterpret_cast<double*>(p);
  p += al16((long)chunk * 8);
  double* inbox = reinterpret_cast<double*>(p);
  const T* Kl = K0xz + (size_t)l * R * M;
  if (tid == 0) {
    for (int k = 0; k < 3; ++k) mbar_init(bars + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // `n` entries of a contiguous run into shared memory on `bar`: one bulk
  // copy by thread 0 where `whole`, else element copies by every thread
  auto run_copy = [&](T* dst, const T* src, long n, bool whole,
                      uint64_t* bar) {
    if (tid == 0) {
      mbar_arrive_tx(bar, whole ? (uint32_t)(n * sizeof(T)) : 0u);
      if (whole && n > 0) bulk_copy(dst, src, (uint32_t)(n * sizeof(T)), bar);
    }
    if (!whole)
      for (long e = tid; e < n; e += NT)
        cp_async_elem<sizeof(T)>(dst + e, src + e);
    cp_async_commit();
  };
  // chunk ch's rows of K0xz into stage ch % stages
  auto issue = [&](int ch) {
    if (ch >= nchunks) return;
    const long r0 = rbeg + (long)ch * chunk;
    const long nr = min((long)chunk, rend - r0);
    run_copy(ks + (size_t)(ch % stages) * chunk * M, Kl + r0 * M, nr * M,
             bulk, bars + ch % stages);
  };
  // a chunk's iB rows (before its K0xz rows: the copies land in the order
  // they are issued)
  auto issue_iB = [&](int ch) {
    const long r0 = rbeg + (long)ch * chunk;
    const long nr = min((long)chunk, rend - r0);
    const T* isrc = iB + ((size_t)l * R + r0) * Tn;
    run_copy(ibs, isrc, nr * Tn,
             ((uintptr_t)isrc & 15) == 0 && (nr * Tn * sizeof(T)) % 16 == 0,
             bars + 2);
  };
  if (own_iB && nchunks > 0) issue_iB(0);
  for (int ch = 0; ch < stages; ++ch) issue(ch);
  cluster_arrive_started();     // waited for before the push
  double acc[2] = {0.0, 0.0};
  for (int ch = 0; ch < nchunks; ++ch) {
    const long r0 = rbeg + (long)ch * chunk;
    const int nr = (int)min((long)chunk, rend - r0);
    // iB mu of the chunk's rows
    if (own_iB) {
      if (ch > 0) issue_iB(ch);
      // mu valid of the subjects the rows span
      const long sa = r0 / Tn;
      const int nmv = (int)(((r0 + nr - 1) / Tn - sa + 1) * Tn);
      for (int i = tid; i < nmv; i += NT) {
        const long r = sa * Tn + i;
        mvs[i] = (double)mu[r * ldm + l] * (double)valid[r];
      }
      mbar_wait(bars + 2, (uint32_t)ch & 1u);
      cp_async_wait_all();
      __syncthreads();
      for (int i = tid; i < nr; i += NT) {
        const long r = r0 + i;
        const T* row = ibs + (size_t)i * Tn;
        const double* mv = mvs + (r / Tn - sa) * Tn;
        double s = 0.0;
        for (int u = 0; u < Tn; ++u) s += (double)row[u] * mv[u];
        v[i] = s;
      }
    } else {
      for (int i = tid; i < nr; i += NT)
        v[i] = (double)iBmu[(size_t)l * R + r0 + i];
    }
    NG_PHASE(1)
    mbar_wait(bars + ch % stages, (uint32_t)(ch / stages) & 1u);
    cp_async_wait_all();
    __syncthreads();
    NG_PHASE(2)
    if (on) {
      // two sums, rows alternating (a shorter chain of dependent adds)
      const T* kc = ks + (size_t)(ch % stages) * chunk * M + j;
#pragma unroll 2
      for (int i = g; i < nr; i += 2 * NG) {
        acc[0] += (double)kc[(size_t)i * M] * v[i];
        if (i + NG < nr)
          acc[1] += (double)kc[(size_t)(i + NG) * M] * v[i + NG];
      }
    }
    __syncthreads();      // the stage and v free
    issue(ch + stages);
    NG_PHASE(3)
  }
  // the block's column sums (its groups' in group order), each into its
  // owner's inbox at this block's place
  if (g < NG) red[tid] = acc[0] + acc[1];
  __syncthreads();
  cluster_wait();         // every block of the cluster has started
  const int per = (M + cl - 1) / cl;
  for (int jj = tid; jj < M; jj += NT) {
    double s = red[jj];
    for (int k = 1; k < NG; ++k) s += red[k * Mp + jj];
    const int owner = jj / per;
    (owner == c ? inbox : cluster.map_shared_rank(inbox, owner))[
        c * M + jj] = s;
  }
  // the owner's columns: the cluster's sums in block order
  cluster_arrive();
  cluster_wait();
  for (int jj = c * per + tid; jj < min(M, (c + 1) * per); jj += NT) {
    double s = 0.0;
    for (int b = 0; b < cl; ++b) s += inbox[b * M + jj];
    ngP1[(size_t)l * M + jj] = (O)s;
  }
  NG_PHASE(4)
  NG_PHASE_END
}

// The sum of v over a warp's lanes, in every lane (a butterfly: each
// level's two adds are the same, so every lane holds the same bits)
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The box src[0:M, 0:nr] (rows M entries apart) into rows of `bw` entries:
// each row's piece as 16-byte copies where `aligned` (every piece's start
// on 16 bytes), the piece's last entries past whole units and every entry
// of an unaligned piece as element copies.  Consecutive threads take
// consecutive units of a piece, then the next row's (a thread's unit and
// first row found once), so a warp's copy requests each sector once.
template <typename T>
__device__ __forceinline__ void copy_box(T* box, int bw, const T* src, int M,
                                         int nr, bool aligned) {
  constexpr int V = 16 / sizeof(T);
  const int units = aligned ? nr / V : 0, tail = nr - units * V;
  if (units > 0) {
    const int per = blockDim.x / units;      // rows a pass
    if (threadIdx.x < per * units) {
      const int u = threadIdx.x % units;
      for (int j = threadIdx.x / units; j < M; j += per)
        cp_async16(box + (size_t)j * bw + u * V, src + (size_t)j * M + u * V);
    }
  }
  if (tail > 0) {
    const int per = blockDim.x / tail;
    if (threadIdx.x < per * tail) {
      const int e = units * V + threadIdx.x % tail;
      for (int j = threadIdx.x / tail; j < M; j += per)
        cp_async_elem<sizeof(T)>(box + (size_t)j * bw + e,
                                 src + (size_t)j * M + e);
    }
  }
}

// A warp's rows r0 .. r0 + V - 1 of the box's row j: one 16-byte read (a
// quarter warp's eight rows j in distinct banks)
template <typename T>
union BoxUnit {
  uint4 u;
  T t[16 / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ BoxUnit<T> box_unit(const T* box, int bw, int j,
                                               int r0) {
  BoxUnit<T> x;
  x.u = *reinterpret_cast<const uint4*>(box + (size_t)j * bw + r0);
  return x;
}

// K6 and K7's start: every thread issues its copies of the strip's rows of
// the N [M, M] inputs `src` (rows i0 .. i0 + nr, one contiguous run each)
// into the `dst` arrays, 16-byte units where `aligned` (the rows and
// pointers on 16 bytes), else entries, consecutive threads on consecutive
// units, and its copies of the box (copy_box).  The caller adds its
// vectors' copies, then strip_landed.
template <typename T, int N>
__device__ __forceinline__ void strip_issue(T* const (&dst)[N],
                                            const T* const (&src)[N],
                                            T* box, int bw, int M, int i0,
                                            int nr, bool aligned) {
  constexpr int V = 16 / sizeof(T);
  const long run = (long)nr * M;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const T* from = src[k] + (size_t)i0 * M;
    if (aligned)
      for (long e = (long)threadIdx.x * V; e < run; e += (long)blockDim.x * V)
        cp_async16(dst[k] + e, from + e);
    else
      for (long e = threadIdx.x; e < run; e += blockDim.x)
        cp_async_elem<sizeof(T)>(dst[k] + e, from + e);
  }
  // the box is the last input's (X in K6, grad_H in K7)
  copy_box(box, bw, src[N - 1] + i0, M, nr,
           aligned && (i0 * sizeof(T)) % 16 == 0);
}

// Every copy of the block landed and seen by every thread
__device__ __forceinline__ void strip_landed() {
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
}

// K6's element work of a warp's nq rows r0 .. (of a 16-byte unit's V):
// lane's columns j = lane, lane + 32, ...; grad_H written into `out` (the
// strip's rows), the rows' parts of grad_m added into s.  FULL: nq = V,
// the rows' work unguarded, so a column's V rows overlap.
template <bool FULL, typename T, typename S, int V>
__device__ __forceinline__ void latents_rows(
    const T* xs, const T* ks, const T* hs, const T* box, int bw,
    const T* nv, const S* ms, T* __restrict__ out, int M, int r0, int nq,
    int lane, double (&s)[V]) {
  for (int j = lane; j < M; j += 32) {
    const double mj = (double)(T)ms[j], nj = (double)nv[j];
    const BoxUnit<T> xt = box_unit(box, bw, j, r0);
#pragma unroll
    for (int q = 0; q < V; ++q)
      if (FULL || q < nq) {
        const int o = (r0 + q) * M + j;
        const T b = (T)0.5 * (xs[o] + xt.t[q]);
        out[o] = (T)0.5 * (b - hs[o]);
        s[q] += (double)b * mj - (double)ks[o] * nj;
      }
  }
}

// K7's element work of a warp's nq rows r0 .. as K6's: iH_new written into
// `out` (the strip's rows, the diagonal's shift added), the rows' parts of
// iH m and grad_H m added into sh and sg.
template <bool FULL, typename T, typename S, int V>
__device__ __forceinline__ void pre_rows(
    const T* hs, const T* gs, const T* box, int bw, const S* ms,
    T* __restrict__ out, int M, int r0, int nq, int i0, T lrT, T shift,
    int lane, double (&sh)[V], double (&sg)[V]) {
  for (int j = lane; j < M; j += 32) {
    const double mj = (double)(T)ms[j];
    const BoxUnit<T> gt = box_unit(box, bw, j, r0);
#pragma unroll
    for (int q = 0; q < V; ++q)
      if (FULL || q < nq) {
        const int o = (r0 + q) * M + j;
        const T h = hs[o], g = gs[o];
        T n = h + lrT * (g + gt.t[q]);
        if (i0 + r0 + q == j) n += shift;
        out[o] = n;
        sh[q] += (double)h * mj;
        sg[q] += (double)g * mj;
      }
  }
}

// K6: grid (ceil(M / R), L), a block a (strip of R rows from i0, latent)
// and a warp V rows (one 16-byte unit of the box: 4 in float, 2 in
// double).  The block stages its rows of iK, iH and X, the box X[0:M,
// i0:i0 + R], ng_P1 and m (strip_issue); then warp w's
// lanes take the columns j = lane, lane + 32, ... of rows i0 + V w ..:
// B[i, j] = (X[i, j] + X[j, i]) / 2 (so B is exactly symmetric), grad_H,
// and the lane's parts of grad_m[i] in double (m and ng_P1 read once a
// column), each row's added over the lanes by a butterfly.
template <typename T, typename S>
__global__ void __launch_bounds__(32 * SWMAX) natgrad_fwd_latents_kernel(
    const T* __restrict__ X, const T* __restrict__ iK,
    const T* __restrict__ iH, const T* __restrict__ ngP1,
    const S* __restrict__ m, T* __restrict__ gm, T* __restrict__ gH, int M,
    int R, bool aligned) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  NG_PHASE_BEGIN(2)
  const int l = blockIdx.y, i0 = blockIdx.x * R, nr = min(R, M - i0);
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * V;
  const int bw = box_stride(R, sizeof(T));
  const size_t base = (size_t)l * M * M;
  unsigned char* p = smem_raw;
  T* ks = reinterpret_cast<T*>(p);
  T* hs = reinterpret_cast<T*>(p += al16((long)R * M * sizeof(T)));
  T* xs = reinterpret_cast<T*>(p += al16((long)R * M * sizeof(T)));
  T* box = reinterpret_cast<T*>(p += al16((long)R * M * sizeof(T)));
  T* nv = reinterpret_cast<T*>(p += al16((long)M * bw * sizeof(T)));
  S* ms = reinterpret_cast<S*>(p + al16((long)M * sizeof(T)));
  T* const dst[3] = {ks, hs, xs};
  const T* const src[3] = {iK + base, iH + base, X + base};
  strip_issue(dst, src, box, bw, M, i0, nr, aligned);
  for (int e = threadIdx.x; e < M; e += blockDim.x) {
    cp_async_elem<sizeof(T)>(nv + e, ngP1 + (size_t)l * M + e);
    cp_async_elem<sizeof(S)>(ms + e, m + (size_t)l * M + e);
  }
  NG_PHASE(1)
  strip_landed();
  NG_PHASE(2)
  if (r0 < nr) {
    double s[V];
#pragma unroll
    for (int q = 0; q < V; ++q) s[q] = 0.0;
    T* out = gH + base + (size_t)i0 * M;
    if (r0 + V <= nr)
      latents_rows<true>(xs, ks, hs, box, bw, nv, ms, out, M, r0, V, lane, s);
    else
      latents_rows<false>(xs, ks, hs, box, bw, nv, ms, out, M, r0, nr - r0,
                          lane, s);
    NG_PHASE(3)
#pragma unroll
    for (int q = 0; q < V; ++q) s[q] = warp_sum(s[q]);
    NG_PHASE(4)
#pragma unroll
    for (int q = 0; q < V; ++q)
      if (lane == q && r0 + q < nr) gm[(size_t)l * M + i0 + r0 + q] = (T)s[q];
    NG_PHASE(5)
  }
  NG_PHASE_END
}

// K7: grid (ceil(M / R), L), a block a (strip, latent) and a warp V rows,
// as K6.  The block stages its rows of iH and grad_H, the box
// grad_H[0:M, i0:i0 + R], m and, with jitter, the latent's diagonals of iH
// and grad_H, all issued at its start; each warp
// sums the diagonal of iH_new itself (the same bits in every warp), so no
// pass waits for another; then warp w's lanes write its rows of iH_new
// and make their parts of (iH m)[i] and (grad_H m)[i] in double (m read
// once a column), each row's added over the lanes by a butterfly.
// Jitter 0: none.
template <typename T, typename S>
__global__ void __launch_bounds__(32 * SWMAX) natgrad_update_pre_kernel(
    const T* __restrict__ iH, const T* __restrict__ gH,
    const T* __restrict__ gm, const S* __restrict__ m, T* __restrict__ iHn,
    T* __restrict__ rhs, int M, int R, double lr, double jitter,
    bool aligned) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  NG_PHASE_BEGIN(3)
  const int l = blockIdx.y, i0 = blockIdx.x * R, nr = min(R, M - i0);
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * V;
  const int bw = box_stride(R, sizeof(T));
  const size_t base = (size_t)l * M * M;
  const T lrT = (T)lr;
  unsigned char* p = smem_raw;
  T* hs = reinterpret_cast<T*>(p);
  T* gs = reinterpret_cast<T*>(p += al16((long)R * M * sizeof(T)));
  T* box = reinterpret_cast<T*>(p += al16((long)R * M * sizeof(T)));
  T* dg = reinterpret_cast<T*>(p += al16((long)M * bw * sizeof(T)));
  S* ms = reinterpret_cast<S*>(p + al16(2L * M * sizeof(T)));
  T* const dst[2] = {hs, gs};
  const T* const src[2] = {iH + base, gH + base};
  strip_issue(dst, src, box, bw, M, i0, nr, aligned);
  for (int e = threadIdx.x; e < M; e += blockDim.x)
    cp_async_elem<sizeof(S)>(ms + e, m + (size_t)l * M + e);
  if (jitter != 0.0)
    for (int t = threadIdx.x; t < M; t += blockDim.x) {
      cp_async_elem<sizeof(T)>(dg + t, iH + base + (size_t)t * (M + 1));
      cp_async_elem<sizeof(T)>(dg + M + t, gH + base + (size_t)t * (M + 1));
    }
  // this lane's row's grad_m (lanes q < V, row i0 + r0 + q)
  const T gmi = lane < V && r0 + lane < nr
                    ? gm[(size_t)l * M + i0 + r0 + lane]
                    : (T)0;
  NG_PHASE(1)
  strip_landed();
  NG_PHASE(2)
  if (r0 < nr) {
    // jitter mean(diag iH_new), summed by every warp in the same order
    T shift = 0;
    if (jitter != 0.0) {
      double d = 0.0;
      for (int j = lane; j < M; j += 32)
        d += (double)(dg[j] + lrT * (dg[M + j] + dg[M + j]));
      shift = (T)jitter * (T)(warp_sum(d) / M);
    }
    NG_PHASE(3)
    double sh[V], sg[V];
#pragma unroll
    for (int q = 0; q < V; ++q) sh[q] = sg[q] = 0.0;
    T* out = iHn + base + (size_t)i0 * M;
    if (r0 + V <= nr)
      pre_rows<true>(hs, gs, box, bw, ms, out, M, r0, V, i0, lrT, shift,
                     lane, sh, sg);
    else
      pre_rows<false>(hs, gs, box, bw, ms, out, M, r0, nr - r0, i0, lrT,
                      shift, lane, sh, sg);
    NG_PHASE(4)
#pragma unroll
    for (int q = 0; q < V; ++q) {
      sh[q] = warp_sum(sh[q]);
      sg[q] = warp_sum(sg[q]);
    }
    NG_PHASE(5)
#pragma unroll
    for (int q = 0; q < V; ++q)
      if (lane == q && r0 + q < nr)
        rhs[(size_t)l * M + i0 + r0 + q] =
            (T)(sh[q] - lr * ((double)gmi - 2.0 * sg[q]));
    NG_PHASE(6)
  }
  NG_PHASE_END
}

// K8's tasks of block c (of cl) of a latent: the row tiles I = c, c + cl,
// ... of NI, each its tiles J = 0 .. I and halves h = 0, 1 of 16 columns,
// in that order, leaving out a last half whose columns all lie past M.
__device__ __forceinline__ int finish_ntasks(int I, int M) {
  return 2 * (I + 1) - (FT * I + FH >= M ? 1 : 0);
}

// The warp slot `slot` of block c: a task (I, J, h) and its part of P,
// the u-th row tile's tasks each over parts[u] consecutive slots.  False
// past the block's slots.
__device__ __forceinline__ bool finish_slot(int slot, int c, int cl, int NI,
                                            int M, const int* parts,
                                            int& I, int& J, int& h,
                                            int& part, int& P) {
  for (int i = c, u = 0; i < NI; i += cl, ++u) {
    const int n = finish_ntasks(i, M) * parts[u];
    if (slot < n) {
      const int t = slot / parts[u];
      I = i;
      J = t >> 1;
      h = t & 1;
      part = slot % parts[u];
      P = parts[u];
      return true;
    }
    slot -= n;
  }
  return false;
}

// D += A B on the FP64 tensor cores: a 16 x 8 tile, k = 8 (Hopper's
// shape; the m8n8k4 one runs at half the rate)
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4],
                                     const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// iLA[k, col] of a stage whose first row is k0, as a double; zero above
// the diagonal (k < col) and past M
template <typename T>
__device__ __forceinline__ double staged(const T* base, int k0, int ld,
                                         int M, int k, int col) {
  return k < M && k >= col ? (double)base[(size_t)(k - k0) * ld + col] : 0.0;
}

// A task's products over rows [kb, ke) of a stage whose first row is k0
// (k-steps of 8): its two 16-row blocks of rows from column ca, its two
// 8-column blocks from cb (the fragments' rows and columns: lane / 4 past
// them), the row blocks below mb0 left out.
template <typename T>
__device__ __forceinline__ void finish_mma(double (&acc)[2][2][4],
                                           const T* base, int k0, int kb,
                                           int ke, int ld, int M, int ca,
                                           int cb, int mb0, int qd) {
#pragma unroll 2
  for (int k = kb; k < ke; k += 8) {
    const int k1 = k + qd, k2 = k1 + 4;
    double a[2][4], b[2][2];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const int col = ca + 16 * mb;
      a[mb][0] = staged(base, k0, ld, M, k1, col);
      a[mb][1] = staged(base, k0, ld, M, k1, col + 8);
      a[mb][2] = staged(base, k0, ld, M, k2, col);
      a[mb][3] = staged(base, k0, ld, M, k2, col + 8);
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      b[nb][0] = staged(base, k0, ld, M, k1, cb + 8 * nb);
      b[nb][1] = staged(base, k0, ld, M, k2, cb + 8 * nb);
    }
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
      if (mb >= mb0)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) dmma(acc[mb][nb], a[mb], b[nb]);
  }
}

// K8: grid (cl, L), a latent's cl blocks one cluster; block c takes its
// tasks (finish_slot) a task a warp, in rounds, or, where the latent is
// resident and its tasks leave warps spare, each task of a row tile over
// P warps, its parts of the rows k (added in order by the first), the
// spare warps dealt to the row tiles with the longest parts first.  iLA's
// rows k >= 32 c go through shared memory whole (one contiguous run: a bulk
// copy where `bulk`, else element copies), in one stage where KC >= M, else
// a ring of two stages of KC rows walked once a round; a task masks what
// it reads above the diagonal and past M to zero.
template <typename T, typename S>
__global__ void __launch_bounds__(FT * FWMAX) natgrad_update_finish_kernel(
    const T* __restrict__ iLA, const T* __restrict__ rhs,
    S* __restrict__ m_out, S* __restrict__ H_out, int M, int KC, bool bulk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ double rh[MAX_M], mpart[MAX_M];
  __shared__ double rpart[FWMAX][FT], cpart[FWMAX][FH];
  __shared__ int rtask[FWMAX], parts[FWMAX];
  NG_PHASE_BEGIN(1)
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = gridDim.x, c = blockIdx.x, l = blockIdx.y;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31, qd = lane & 3, gr = lane >> 2;
  const int NI = (M + FT - 1) / FT, Mp = NI * FT, Mk = (M + 7) / 8 * 8;
  const bool resident = KC >= M;
  const int ns = resident ? 1 : 2, rows = finish_rows(M, KC);
  T* stage0 = reinterpret_cast<T*>(smem_raw);
  // the split tasks' parts, a warp's fragments (FT x FH doubles) each
  double* spart = reinterpret_cast<double*>(
      smem_raw + al16((long)rows * M * sizeof(T)));
  // m_new's partials of every row from each of the cluster's blocks
  double* inbox = reinterpret_cast<double*>(
      smem_raw + finish_smem(M, KC, nw, 0, sizeof(T)));
  const T* src = iLA + (size_t)l * M * M;
  const int nrt = (NI - 1 - c) / cl + 1;    // the block's row tiles
  if (threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j) mbar_init(bars + j);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // each row tile's parts: one, then (resident, the tasks in one round)
    // the spare warps to the tile whose parts are longest, a part for each
    // of its tasks at a time, while they last
    {
      int spare = nw;
      for (int u = 0; u < nrt; ++u) {
        parts[u] = 1;
        spare -= finish_ntasks(c + u * cl, M);
      }
      while (resident && spare > 0) {
        int best = -1;
        for (int u = 0; u < nrt; ++u) {
          const int I = c + u * cl;
          if (finish_ntasks(I, M) <= spare &&
              (best < 0 || (long)(Mk - FT * I) * parts[best] >
                               (long)(Mk - FT * (c + best * cl)) * parts[u]))
            best = u;
        }
        if (best < 0) break;
        spare -= finish_ntasks(c + best * cl, M);
        ++parts[best];
      }
    }
  }
  __syncthreads();
  int ntasks = 0, nslots = 0;
  for (int u = 0; u < nrt; ++u) {
    ntasks += finish_ntasks(c + u * cl, M);
    nslots += finish_ntasks(c + u * cl, M) * parts[u];
  }
  const int nrounds = (nslots + nw - 1) / nw;
  // the first row a round reads (a chunk boundary in the ring)
  auto round_k0 = [&](int r) {
    int I, J, h, part, P;
    finish_slot(r * nw, c, cl, NI, M, parts, I, J, h, part, P);
    return resident ? FT * c : FT * I / KC * KC;
  };
  // chunk g of the block's walk: its first row, -1 past the end
  auto chunk_at = [&](int g) {
    if (resident) return g == 0 ? FT * c : -1;
    for (int r = 0; r < nrounds; ++r) {
      const int k0 = round_k0(r), n = (M - k0 + KC - 1) / KC;
      if (g < n) return k0 + g * KC;
      g -= n;
    }
    return -1;
  };
  // chunk g's rows into stage g % ns: one bulk copy by thread 0, else
  // element copies by every thread
  auto issue = [&](int g) {
    const int k0 = chunk_at(g);
    if (k0 < 0) return;
    const int k1 = resident ? M : min(M, k0 + KC);
    T* dst = stage0 + (size_t)(g % ns) * rows * M;
    const T* from = src + (size_t)k0 * M;
    const long n = (long)(k1 - k0) * M;
    if (threadIdx.x == 0) {
      mbar_arrive_tx(bars + g % ns, bulk ? (uint32_t)(n * sizeof(T)) : 0u);
      if (bulk) bulk_copy(dst, from, (uint32_t)(n * sizeof(T)), bars + g % ns);
    }
    if (!bulk)
      for (long e = threadIdx.x; e < n; e += blockDim.x)
        cp_async_elem<sizeof(T)>(dst + e, from + e);
    cp_async_commit();
  };
  for (int g = 0; g < ns; ++g) issue(g);
  if (cl > 1) cluster_arrive_started();   // waited for before the push
  for (int t = threadIdx.x; t < Mp; t += blockDim.x) {
    rh[t] = t < M ? (double)rhs[(size_t)l * M + t] : 0.0;
    mpart[t] = 0.0;
  }
  int g = 0;    // chunks consumed
  for (int r = 0; r < nrounds; ++r) {
    int I = 0, J = 0, h = 0, part = 0, P = 1;
    const bool has =
        finish_slot(r * nw + warp, c, cl, NI, M, parts, I, J, h, part, P);
    double acc[2][2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.0;
    // the diagonal tile's second half: its rows 0..15 lie above it
    const int mb0 = I == J && h == 1 ? 1 : 0;
    const int ca = FT * I + gr, cb = FT * J + FH * h + gr;
    if (resident) {
      if (r == 0) {
        mbar_wait(bars, 0u);
        cp_async_wait_all();
        __syncthreads();
        NG_PHASE(1)
      }
      // the task's part of its rows k >= 32 I
      const int len = (Mk - FT * I + 8 * P - 1) / (8 * P) * 8;
      const int kb = FT * I + part * len, ke = min(Mk, kb + len);
      if (has && kb < ke)
        finish_mma(acc, stage0, FT * c, kb, ke, M, M, ca, cb, mb0, qd);
    } else {
      const int k0r = round_k0(r), n = (M - k0r + KC - 1) / KC;
      for (int u = 0; u < n; ++u, ++g) {
        const int k0 = k0r + u * KC, st = g % ns;
        mbar_wait(bars + st, (uint32_t)(g / ns) & 1u);
        cp_async_wait_all();
        __syncthreads();
        NG_PHASE(1)
        const int kb = max(k0, FT * I), ke = min(k0 + KC, Mk);
        if (has && kb < ke)
          finish_mma(acc, stage0 + (size_t)st * rows * M, k0, kb, ke, M, M,
                     ca, cb, mb0, qd);
        __syncthreads();      // the stage free
        issue(g + ns);
      }
    }
    NG_PHASE(2)
    // a split task's parts, added in order by its first warp
    const bool first = has && part == 0;
    if (nslots > ntasks) {
      double* mine = spart + (size_t)warp * FT * FH;
      if (has && part > 0)
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              mine[((a * 2 + b) * 4 + e) * 32 + lane] = acc[a][b][e];
      __syncthreads();
      if (first)
        for (int w = warp + 1; w < warp + P; ++w)
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[a][b][e] +=
                    spart[(size_t)w * FT * FH + ((a * 2 + b) * 4 + e) * 32 +
                          lane];
    }
    NG_PHASE(3)
    // the task's entries: rounded to the chain's type once, written with
    // their mirrors; its rows' and (below the diagonal) its columns' parts
    // of m_new
    double rp[2][2] = {{0.0, 0.0}, {0.0, 0.0}},
           cp[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
    if (first) {
      const size_t base = (size_t)l * M * M;
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = ca + 16 * mb + 8 * (e >> 1),
                      j = cb - gr + 8 * nb + 2 * qd + (e & 1);
            if (i < M && j < M && i >= j) {
              const T hv = (T)acc[mb][nb][e];
              H_out[base + (size_t)i * M + j] = (S)hv;
              rp[mb][e >> 1] += (double)hv * rh[j];
              if (i != j) {
                H_out[base + (size_t)j * M + i] = (S)hv;
                cp[nb][e & 1] += (double)hv * rh[i];
              }
            }
          }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1)
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            rp[mb][e] += __shfl_xor_sync(0xffffffffu, rp[mb][e], o);
#pragma unroll
      for (int o = 4; o <= 16; o <<= 1)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            cp[nb][e] += __shfl_xor_sync(0xffffffffu, cp[nb][e], o);
      if (qd == 0)
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            rpart[warp][16 * mb + 8 * e + gr] = rp[mb][e];
      if (gr == 0)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) cpart[warp][8 * nb + 2 * qd + e] = cp[nb][e];
    }
    if (lane == 0) rtask[warp] = first ? (I << 16) | (J << 1) | h : -1;
    NG_PHASE(4)
    __syncthreads();
    // each row's partial: the round's tasks' parts, in task order; after
    // the last round, into the inbox of the row's owner (row tile I's
    // block, I mod cl), at this block's place
    const bool last = r == nrounds - 1;
    if (last && cl > 1) cluster_wait();   // every block has started
    for (int i = threadIdx.x; i < Mp; i += blockDim.x) {
      const int ti = i / FT, ri = i % FT;
      double s = mpart[i];
      for (int w = 0; w < nw; ++w) {
        const int t = rtask[w];
        if (t < 0) continue;
        if ((t >> 16) == ti) s += rpart[w][ri];
        if (((t >> 1) & 0x7fff) == ti && (ri >> 4) == (t & 1))
          s += cpart[w][ri & 15];
      }
      if (!last) {
        mpart[i] = s;
      } else {
        const int owner = ti % cl;
        (owner == c ? inbox : cluster.map_shared_rank(inbox, owner))[
            c * Mp + i] = s;
      }
    }
    if (!last) __syncthreads();
    NG_PHASE(5)
  }
  // m_new of the block's rows: the cluster's partials in block order,
  // once every block has pushed its own (a thread reads its own row's
  // place without the barrier)
  if (cl > 1) {
    cluster_arrive();
    cluster_wait();
  }
  for (int i = threadIdx.x; i < Mp; i += blockDim.x)
    if ((i / FT) % cl == c && i < M) {
      double s = 0.0;
      for (int b = 0; b < cl; ++b) s += inbox[b * Mp + i];
      m_out[(size_t)l * M + i] = (S)(T)s;
    }
  NG_PHASE(6)
  NG_PHASE_END
}

int invalid() { return (int)cudaErrorInvalidValue; }

// K6 and K7's threads: a warp a 16-byte unit of a strip's R rows
int strip_threads(int R, int z) { return 32 * ((R * z + 15) / 16); }

// Whether K6 and K7's launch takes the plan: M <= MAX_M columns, R <= RMAX
// rows a block, L latents, `smem` the strips' shared bytes
bool strip_ok(int L, int M, int R, int smem, long want) {
  return L >= 1 && L <= 65535 && M >= 1 && M <= MAX_M && R >= 1 &&
         R <= RMAX && smem == want;
}

// above 48 KB of dynamic and static shared bytes a kernel needs the
// attribute (the static bytes here are at most 15 KB)
template <typename K> int set_smem(K kernel, int smem) {
  if (smem > 32 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return 0;
}

// `kernel` on a grid of clusters of `cl` blocks along x
template <typename... P, typename... A>
int launch_clusters(void (*kernel)(P...), dim3 grid, int threads, int cl,
                    int smem, cudaStream_t st, A... args) {
  int err = set_smem(kernel, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, (P)args...);
  if (err) {
    (void)cudaGetLastError();
    return err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------- C entries

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Each entry launches one kernel on `stream` and returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for a pair of dtypes, a size
// or a plan outside what is compiled).  Pointers are void*, the dtypes by
// itemsize (4 float, 8 double): K5's inputs' and ng_P1's, K6-K8's chain's
// and the state's (m, H); [L, M, M] the latents' matrices, [L, M] their
// vectors (m, ng_P1, grad_m, rhs); `rows` the strips' rows (strip_plan),
// K5's and K8's plans subjects_plan and finish_plan
// (hlax_torch/ops/natgrad.py).

// T the first dtype, U the second: both float, both double, or the one
// mixed pair an entry compiles (MA, MB, of itemsizes za0 and 12 - za0)
#define NG_DISPATCH(za, zb, za0, MA, MB, ...)  \
  if (za == 4 && zb == 4) {                    \
    using T = float;                           \
    using U = float;                           \
    __VA_ARGS__;                               \
  } else if (za == 8 && zb == 8) {             \
    using T = double;                          \
    using U = double;                          \
    __VA_ARGS__;                               \
  } else if (za == za0 && zb == 12 - za0) {    \
    using T = MA;                              \
    using U = MB;                              \
    __VA_ARGS__;                               \
  } else {                                     \
    return invalid();                          \
  }

// iB [L, S, T, T] (null where iBmu, [L, S, T], is cuBLAS's iB mu: T > TP);
// mu [S, T, ldm]; valid [S, T]; K0xz [L, S, T, M]; ngP1 [L, M]; a
// latent's rows over one cluster of `cluster` blocks, a block's in chunks
// of `chunk` rows, `smem` dynamic shared bytes; bulk copies where K0xz's
// rows and pointer are 16-byte aligned
extern "C" int natgrad_fwd_subjects(
    int itemsize, int out_itemsize, const void* iB, const void* iBmu,
    const void* mu, const void* valid, const void* K0xz, void* ngP1, int L,
    int S, int Tn, int M, int ldm, int cluster, int chunk, int smem,
    void* stream) {
  const long R = (long)S * Tn, q = (R + cluster - 1) / max(cluster, 1);
  if (L < 1 || L > 65535 || S < 1 || Tn < 1 || M < 1 || M > MAX_M ||
      ldm < L || !iB == !iBmu || (iB && Tn > TP) || cluster < 1 ||
      cluster > CLUSTER || chunk < 1 || chunk > q ||
      smem != subjects_smem(chunk, chunk >= q ? 1 : 2, M, Tn, iB != nullptr,
                            cluster, itemsize))
    return invalid();
  const bool bulk = ((long)M * itemsize) % 16 == 0 &&
                    ((uintptr_t)K0xz & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  NG_DISPATCH(itemsize, out_itemsize, 4, float, double, {
    err = launch_clusters(natgrad_fwd_subjects_kernel<T, U>,
                          dim3(cluster, L), NT, cluster, smem, st, iB, iBmu,
                          mu, valid, K0xz, ngP1, S, Tn, M, ldm, chunk, bulk);
  })
  return err;
}

// X = iLK^T (I + C_w) iLK, iK, iH [L, M, M], ngP1 [L, M] in the chain's
// type; m [L, M] in the state's; grad_m [L, M], grad_H [L, M, M] written;
// strips of `rows` rows, `smem` dynamic shared bytes; 16-byte copies where
// the rows and pointers are 16-byte aligned
extern "C" int natgrad_fwd_latents(
    int itemsize, int state_itemsize, const void* X, const void* iK,
    const void* iH, const void* ngP1, const void* m, void* gm, void* gH,
    int L, int M, int rows, int smem, void* stream) {
  if (!strip_ok(L, M, rows, smem,
                strip_smem(rows, M, itemsize, state_itemsize, 3, 1)))
    return invalid();
  const bool aligned =
      ((long)M * itemsize) % 16 == 0 &&
      (((uintptr_t)X | (uintptr_t)iK | (uintptr_t)iH) & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((M + rows - 1) / rows, L);
  NG_DISPATCH(itemsize, state_itemsize, 8, double, float, {
    const int err = set_smem(natgrad_fwd_latents_kernel<T, U>, smem);
    if (err) return err;
    natgrad_fwd_latents_kernel<T, U><<<grid, strip_threads(rows, itemsize),
                                       smem, st>>>(
        (const T*)X, (const T*)iK, (const T*)iH, (const T*)ngP1,
        (const U*)m, (T*)gm, (T*)gH, M, rows, aligned);
  })
  return (int)cudaGetLastError();
}

// iH, grad_H [L, M, M], grad_m [L, M] in the chain's type, m [L, M] in the
// state's; iH_new [L, M, M] and rhs [L, M] written; strips of `rows` rows,
// `smem` dynamic shared bytes, 16-byte copies as K6's; jitter 0: none
extern "C" int natgrad_update_pre(
    int itemsize, int state_itemsize, const void* iH, const void* gH,
    const void* gm, const void* m, void* iHn, void* rhs, int L, int M,
    int rows, int smem, double lr, double jitter, void* stream) {
  if (!strip_ok(L, M, rows, smem,
                strip_smem(rows, M, itemsize, state_itemsize, 2, 2)))
    return invalid();
  const bool aligned = ((long)M * itemsize) % 16 == 0 &&
                       (((uintptr_t)iH | (uintptr_t)gH) & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((M + rows - 1) / rows, L);
  NG_DISPATCH(itemsize, state_itemsize, 8, double, float, {
    const int err = set_smem(natgrad_update_pre_kernel<T, U>, smem);
    if (err) return err;
    natgrad_update_pre_kernel<T, U><<<grid, strip_threads(rows, itemsize),
                                      smem, st>>>(
        (const T*)iH, (const T*)gH, (const T*)gm, (const U*)m, (T*)iHn,
        (T*)rhs, M, rows, lr, jitter, aligned);
  })
  return (int)cudaGetLastError();
}

// iLA [L, M, M] (lower triangular) and rhs [L, M] in the chain's type;
// m_out [L, M] and H_out [L, M, M] in the state's, written (they may be the
// state's own m and H); a latent's `cluster` blocks one cluster of `warps`
// warps each, iLA's rows in one stage (chunk >= M) or a ring of two of
// `chunk` rows (a multiple of 8), `smem` dynamic shared bytes; bulk copies
// where iLA's rows and pointer are 16-byte aligned
extern "C" int natgrad_update_finish(
    int itemsize, int state_itemsize, const void* iLA, const void* rhs,
    void* m_out, void* H_out, int L, int M, int cluster, int warps,
    int chunk, int smem, void* stream) {
  if (L < 1 || L > 65535 || M < 1 || M > MAX_M || cluster < 1 ||
      cluster > CLUSTER || cluster > (M + FT - 1) / FT || warps < 1 ||
      warps > FWMAX || chunk < 1 || (chunk < M && chunk % 8) ||
      smem != finish_smem(M, chunk, warps, cluster, itemsize))
    return invalid();
  const bool bulk = ((long)M * itemsize) % 16 == 0 &&
                    ((uintptr_t)iLA & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  NG_DISPATCH(itemsize, state_itemsize, 8, double, float, {
    err = launch_clusters(natgrad_update_finish_kernel<T, U>,
                          dim3(cluster, L), 32 * warps, cluster, smem, st,
                          iLA, rhs, m_out, H_out, M, chunk, bulk);
  })
  return err;
}
