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
// 120], float32: bytes.  K5 reads K0xz (6.1 MB), iB (1.0 MB), mu and valid
// and writes ng_P1: ~2.1 us at 3.35 TB/s against 0.4 MFLOP a latent.  K6
// reads X, iK and iH and writes grad_H (4 x 1.8 MB), K7 reads iH and
// grad_H and writes iH_new (3 x 1.8 MB), K8 reads iLA and writes H_new (2
// x 1.8 MB): 1.1-2.2 us each; K8's product, M^3 / 3 multiply-adds a latent
// (18 MFLOP in all), is ~0.3 us at 67 TFLOP/s.  So each is a launch of a
// few microseconds that replaces five to fifteen of the plain chain's, and
// each is built to read its inputs once from device memory, coalesced, and
// to need no pass or block after it:
//   K5 takes a (32 columns, latent) a block, 128 blocks at the canonical
//     shape, one an SM: a block of NT = 1024 threads (32 warps, so the lone
//     block of an SM keeps enough loads in flight) stages iB mu of its
//     latent's rows in shared memory (a thread a row; subjects longer than
//     TP rows take it from cuBLAS), then each warp sums K0xz's rows times
//     it, its lanes a row's 32 columns (128-byte reads), and the warps'
//     partials are added in warp order.
//   K6, K7 and K8 take a (strip of R rows, latent) a block, a thread a
//     column of the [M, M] matrices (M <= MAX_M), so a row's reads and
//     writes are coalesced, and the transposed entries a thread needs,
//     X[j, i] and grad_H[j, i] for the strip's rows i, are R consecutive
//     entries of its own column j's row.  Every row sum over j (grad_m,
//     rhs, m_new) is the strip's own: a warp's butterfly, then the warps in
//     order, in double.  R comes from the card's SM count (strip_plan,
//     hlax_torch/ops/natgrad.py): the most rows, at most RMAX, that still
//     give every SM a block.
//   K8's H_new[i, j] = sum_k iLA[k, i] iLA[k, j] runs over k >= max(i, j)
//     (iLA is lower triangular), k ascending, in double.  A block stages
//     iLA's rows k >= i0 in shared memory, KC rows at a time in two
//     buffers, the next chunk's bulk copies (cp.async, 16 bytes a copy) in
//     flight while this one is summed; a chunk holds whole rows, so the
//     strip's columns iLA[k, i] come from it too, one broadcast read a k
//     (every lane of a warp walks the same k).  Both triangles are written,
//     each entry from its own sum: H_new[j, i] takes the same products in
//     the same order as H_new[i, j] (and exact zeros besides), so H_new is
//     exactly symmetric.  m_new's row i is the strip's sum of H_new[i, j]
//     rhs[j] over its columns, from H_new rounded to the chain's type as
//     the plain version's is.  K8 reads neither m nor H, so it may write
//     the state's (m, H) in place (K7 has read m before it).  Measured on
//     the H100, a first form reading iLA[k, j] from device memory a k at a
//     time was several times slower (each thread's walk a chain of round
//     trips); staged in shared memory, with float chunks widened, one k a
//     warp step and 16-row chunks, it is still about 1.6 times the plain
//     version's cuBLAS product: its time follows its products, not its
//     copies, and k-groups of threads, wider or narrower strips, other
//     chunk sizes and register tiles of 4 columns a lane did not lower it
//     (PERF.md).
// Every sum is in double, in a fixed order, with no atomics, so a CUDA
// graph replays the eager call's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;       // K5's threads a block
constexpr int NW = NT / 32;    // K5's warps a block
constexpr int CW = 32;         // K5's columns a block: a warp's lanes
constexpr int VROWS = 2048;    // K5's rows of iB mu a block stages at once
constexpr int TP = 32;         // K5 takes iB mu from cuBLAS past TP rows
constexpr int RMAX = 8;        // K6-K8: a block's rows at most
constexpr int MAX_M = 512;     // K6-K8: a thread a column

// The block's totals of the NV doubles v (every thread's own), by warp
// butterflies and then in warp order (nw warps); red: NV * 32 shared
// doubles, out: NV shared doubles, read after this returns.
template <int NV>
__device__ void block_sum(const double (&v)[NV], int nw, double* red,
                          double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double s[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) s[j] = v[j];
#pragma unroll
  for (int o = 16; o; o >>= 1)
#pragma unroll
    for (int j = 0; j < NV; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < NV; ++j) red[j * 32 + warp] = s[j];
  __syncthreads();
  if (threadIdx.x < NV) {
    double t = red[threadIdx.x * 32];
    for (int w = 1; w < nw; ++w) t += red[threadIdx.x * 32 + w];
    out[threadIdx.x] = t;
  }
  __syncthreads();
}

// K8's two buffers of KC rows of M entries of the input's type, 16-byte
// aligned
__host__ __device__ constexpr int finish_raw(int M, int KC, int z) {
  return (2 * KC * M * z + 15) / 16 * 16;
}

// K5: ng_P1[l, c] = sum_{s, t} K0xz[l, s, t, c] v[l, s, t], v = iB (mu
// valid) per subject, computed here (iBmu null) or cuBLAS's (iBmu
// [L, S, T]).  Grid (ceil(M / CW), L); mu [S, T, ldm] (this rank's latents
// first).
template <typename T, typename O>
__global__ void __launch_bounds__(NT) natgrad_fwd_subjects_kernel(
    const T* __restrict__ iB, const T* __restrict__ iBmu,
    const T* __restrict__ mu, const T* __restrict__ valid,
    const T* __restrict__ K0xz, O* __restrict__ ngP1, int S, int Tn, int M,
    int ldm) {
  __shared__ double v[VROWS];
  __shared__ double red[NW * CW];
  const int l = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * CW + lane;
  const long rows = (long)S * Tn;
  const T* Kl = K0xz + (long)l * rows * M;
  double acc = 0.0;
  for (long r0 = 0; r0 < rows; r0 += VROWS) {
    const int nr = (int)(rows - r0 < VROWS ? rows - r0 : VROWS);
    for (int i = threadIdx.x; i < nr; i += NT) {
      const long r = r0 + i;
      double s = 0.0;
      if (iBmu) {
        s = (double)iBmu[(long)l * rows + r];
      } else {
        const long sub = r / Tn;
        const T* row = iB + ((long)l * rows + r) * Tn;
        const T* ms = mu + sub * Tn * ldm + l;
        const T* vs = valid + sub * Tn;
#pragma unroll 4
        for (int u = 0; u < Tn; ++u)
          s += (double)row[u] * ((double)ms[(long)u * ldm] * (double)vs[u]);
      }
      v[i] = s;
    }
    __syncthreads();
    if (col < M) {
      const T* Kc = Kl + r0 * M + col;
#pragma unroll 8
      for (int i = warp; i < nr; i += NW) acc += (double)Kc[(long)i * M] * v[i];
    }
    __syncthreads();
  }
  red[warp * CW + lane] = acc;
  __syncthreads();
  if (warp == 0 && col < M) {
    double s = red[lane];
    for (int w = 1; w < NW; ++w) s += red[w * CW + lane];
    ngP1[(long)l * M + col] = (O)s;
  }
}

// K6: grid (ceil(M / R), L), a thread a column j of rows i0 .. i0 + R.
template <typename T, typename S>
__global__ void __launch_bounds__(MAX_M) natgrad_fwd_latents_kernel(
    const T* __restrict__ X, const T* __restrict__ iK,
    const T* __restrict__ iH, const T* __restrict__ ngP1,
    const S* __restrict__ m, T* __restrict__ gm, T* __restrict__ gH, int M,
    int R) {
  __shared__ double red[RMAX * 32];
  __shared__ double sums[RMAX];
  const int l = blockIdx.y, i0 = blockIdx.x * R, j = threadIdx.x;
  const long base = (long)l * M * M;
  const bool on = j < M;
  const double mj = on ? (double)(T)m[(long)l * M + j] : 0.0;
  const double nj = on ? (double)ngP1[(long)l * M + j] : 0.0;
  double p[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    p[r] = 0.0;
    const int i = i0 + r;
    if (r < R && i < M && on) {
      const long ij = base + (long)i * M + j;
      const T b = (T)0.5 * (X[ij] + X[base + (long)j * M + i]);
      gH[ij] = (T)0.5 * (b - iH[ij]);
      p[r] = (double)b * mj - (double)iK[ij] * nj;
    }
  }
  block_sum(p, blockDim.x >> 5, red, sums);
  if (j < R && i0 + j < M) gm[(long)l * M + i0 + j] = (T)sums[j];
}

// K7: grid (ceil(M / R), L), a thread a column j of rows i0 .. i0 + R;
// jitter 0: none.
template <typename T, typename S>
__global__ void __launch_bounds__(MAX_M) natgrad_update_pre_kernel(
    const T* __restrict__ iH, const T* __restrict__ gH,
    const T* __restrict__ gm, const S* __restrict__ m, T* __restrict__ iHn,
    T* __restrict__ rhs, int M, int R, double lr, double jitter) {
  __shared__ double red[2 * RMAX * 32];
  __shared__ double sums[2 * RMAX];
  const int l = blockIdx.y, i0 = blockIdx.x * R, j = threadIdx.x;
  const int nw = blockDim.x >> 5;
  const long base = (long)l * M * M;
  const bool on = j < M;
  const T lrT = (T)lr;
  T shift = 0;
  if (jitter != 0.0) {
    // jitter mean(diag iH_new): every block its latent's whole diagonal
    double d[1] = {0.0};
    if (on) {
      const long jj = base + (long)j * M + j;
      d[0] = (double)(iH[jj] + lrT * (gH[jj] + gH[jj]));
    }
    block_sum(d, nw, red, sums);
    shift = (T)jitter * (T)(sums[0] / M);
  }
  const double mj = on ? (double)(T)m[(long)l * M + j] : 0.0;
  double p[2 * RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    p[r] = p[RMAX + r] = 0.0;
    const int i = i0 + r;
    if (r < R && i < M && on) {
      const long ij = base + (long)i * M + j;
      const T h = iH[ij], g = gH[ij];
      T n = h + lrT * (g + gH[base + (long)j * M + i]);
      if (i == j) n += shift;
      iHn[ij] = n;
      p[r] = (double)h * mj;
      p[RMAX + r] = (double)g * mj;
    }
  }
  block_sum(p, nw, red, sums);
  if (j < R && i0 + j < M)
    rhs[(long)l * M + i0 + j] =
        (T)(sums[j] - lr * ((double)gm[(long)l * M + i0 + j] -
                            2.0 * sums[RMAX + j]));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K8: grid (ceil(M / R), L), a thread a column j of rows i0 .. i0 + R.
// iLA's rows k >= i0 pass through shared memory in chunks of KC rows, two
// buffers, the next chunk's copies in flight (cp.async; 16 bytes a copy
// where `vec`) while this one is summed; a float chunk is widened once to
// double (a product then costs no conversion).  A chunk holds whole rows,
// so the strip's own columns iLA[k, i] come from it too.
template <typename T, typename S>
__global__ void __launch_bounds__(MAX_M) natgrad_update_finish_kernel(
    const T* __restrict__ iLA, const T* __restrict__ rhs,
    S* __restrict__ m_out, S* __restrict__ H_out, int M, int R, int KC,
    bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  double* wide = reinterpret_cast<double*>(smem_raw +
                                           finish_raw(M, KC, sizeof(T)));
  __shared__ double red[RMAX * 32];
  __shared__ double sums[RMAX];
  const int l = blockIdx.y, i0 = blockIdx.x * R, j = threadIdx.x;
  const long base = (long)l * M * M;
  const bool on = j < M;
  const int rows = M - i0 < R ? M - i0 : R;
  const int nchunks = (M - i0 + KC - 1) / KC;
  // the strip's entries two a load where rows and strips start on even
  // columns
  const bool pairs = R > 1 && !(M & 1);
  // rows i0 + c KC .. of iLA, a contiguous range, into buffer c % 2
  auto stage = [&](int c) {
    const int k0 = i0 + c * KC, n = (M - k0 < KC ? M - k0 : KC) * M;
    const T* src = iLA + base + (long)k0 * M;
    T* dst = buf + (c & 1) * KC * M;
    if (vec) {
      constexpr int PER = 16 / sizeof(T);
      for (int e = threadIdx.x * PER; e < n; e += blockDim.x * PER)
        cp_async<16>(dst + e, src + e);
    } else {
      for (int e = threadIdx.x; e < n; e += blockDim.x)
        cp_async<sizeof(T)>(dst + e, src + e);
    }
    cp_async_commit();
  };
  double acc[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) acc[r] = 0.0;
  stage(0);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = i0 + c * KC, nk = M - k0 < KC ? M - k0 : KC;
    const double* ak;
    if constexpr (sizeof(T) == 8) {
      ak = reinterpret_cast<const double*>(buf + (c & 1) * KC * M);
    } else {
      const T* raw = buf + (c & 1) * KC * M;
      for (int e = threadIdx.x; e < nk * M; e += blockDim.x)
        wide[e] = (double)raw[e];
      __syncthreads();
      ak = wide;
    }
    // the chunk's rows from the warp's first column on, ascending, the same
    // k in every lane (the strip's entries one broadcast read); a lane adds
    // exact zeros for k < j
    const int jw = j & ~31;
    if (on)
#pragma unroll 2
      for (int k = jw > k0 ? jw : k0; k < k0 + nk; ++k) {
        const double* row = ak + (k - k0) * M;
        const double akj = k >= j ? row[j] : 0.0;
        // the strip's entries of row k (past the strip's last row: inside
        // the shared memory, and not used)
        double a[RMAX];
        if (pairs) {
#pragma unroll
          for (int r = 0; r < RMAX; r += 2) {
            const double2 v =
                *reinterpret_cast<const double2*>(row + i0 + r);
            a[r] = v.x;
            a[r + 1] = v.y;
          }
        } else {
#pragma unroll
          for (int r = 0; r < RMAX; ++r) a[r] = row[i0 + r];
        }
        if (rows == RMAX && k >= i0 + RMAX - 1) {
#pragma unroll
          for (int r = 0; r < RMAX; ++r) acc[r] += a[r] * akj;
        } else {
#pragma unroll
          for (int r = 0; r < RMAX; ++r)
            acc[r] += (r < rows && k >= i0 + r ? a[r] : 0.0) * akj;
        }
      }
    __syncthreads();
  }
  const double rj = on ? (double)rhs[(long)l * M + j] : 0.0;
  double p[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    p[r] = 0.0;
    if (r < rows && on) {
      const T h = (T)acc[r];
      H_out[base + (long)(i0 + r) * M + j] = (S)h;
      p[r] = (double)h * rj;
    }
  }
  block_sum(p, blockDim.x >> 5, red, sums);
  if (j < rows) m_out[(long)l * M + i0 + j] = (S)(T)sums[j];
}

int invalid() { return (int)cudaErrorInvalidValue; }

// Whether K6-K8's launch takes the plan: M <= MAX_M columns, R <= RMAX rows
// a block, L latents
bool strip_ok(int L, int M, int R) {
  return L >= 1 && L <= 65535 && M >= 1 && M <= MAX_M && R >= 1 &&
         R <= RMAX;
}

// a thread a column, in whole warps
int threads(int M) { return (M + 31) / 32 * 32; }

// K8's dynamic shared bytes: two chunks of KC rows of M entries, a float
// chunk widened to double and RMAX doubles of room past the last row (the
// strip's entries are read past it) (finish_smem,
// hlax_torch/ops/natgrad.py)
int finish_smem(int M, int KC, int z) {
  return finish_raw(M, KC, z) + (z == 4 ? KC * M * 8 : 0) + RMAX * 8;
}

// above 48 KB of dynamic and static shared bytes a kernel needs the
// attribute (the static bytes here are at most 4 KB)
template <typename K> int set_smem(K kernel, int smem) {
  if (smem > 44 * 1024)
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
// cudaGetLastError() (cudaErrorInvalidValue for a pair of dtypes or a size
// outside what is compiled).  Pointers are void*, the dtypes by itemsize (4
// float, 8 double): K5's inputs' and ng_P1's, K6-K8's chain's and the
// state's (m, H); [L, M, M] the latents' matrices, [L, M] their vectors
// (m, ng_P1, grad_m, rhs); `rows` the strips' rows (strip_plan,
// hlax_torch/ops/natgrad.py).

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
// mu [S, T, ldm]; valid [S, T]; K0xz [L, S, T, M]; ngP1 [L, M]
extern "C" int natgrad_fwd_subjects(
    int itemsize, int out_itemsize, const void* iB, const void* iBmu,
    const void* mu, const void* valid, const void* K0xz, void* ngP1, int L,
    int S, int Tn, int M, int ldm, void* stream) {
  if (L < 1 || L > 65535 || S < 1 || Tn < 1 || M < 1 || ldm < L ||
      !iB == !iBmu || (iB && Tn > TP))
    return invalid();
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((M + CW - 1) / CW, L);
  NG_DISPATCH(itemsize, out_itemsize, 4, float, double, {
    natgrad_fwd_subjects_kernel<T, U><<<grid, NT, 0, st>>>(
        (const T*)iB, (const T*)iBmu, (const T*)mu, (const T*)valid,
        (const T*)K0xz, (U*)ngP1, S, Tn, M, ldm);
  })
  return (int)cudaGetLastError();
}

// X = iLK^T (I + C_w) iLK, iK, iH [L, M, M], ngP1 [L, M] in the chain's
// type; m [L, M] in the state's; grad_m [L, M], grad_H [L, M, M] written
extern "C" int natgrad_fwd_latents(
    int itemsize, int state_itemsize, const void* X, const void* iK,
    const void* iH, const void* ngP1, const void* m, void* gm, void* gH,
    int L, int M, int rows, void* stream) {
  if (!strip_ok(L, M, rows)) return invalid();
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((M + rows - 1) / rows, L);
  NG_DISPATCH(itemsize, state_itemsize, 8, double, float, {
    natgrad_fwd_latents_kernel<T, U><<<grid, threads(M), 0, st>>>(
        (const T*)X, (const T*)iK, (const T*)iH, (const T*)ngP1,
        (const U*)m, (T*)gm, (T*)gH, M, rows);
  })
  return (int)cudaGetLastError();
}

// iH, grad_H [L, M, M], grad_m [L, M] in the chain's type, m [L, M] in the
// state's; iH_new [L, M, M] and rhs [L, M] written; jitter 0: none
extern "C" int natgrad_update_pre(
    int itemsize, int state_itemsize, const void* iH, const void* gH,
    const void* gm, const void* m, void* iHn, void* rhs, int L, int M,
    int rows, double lr, double jitter, void* stream) {
  if (!strip_ok(L, M, rows)) return invalid();
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((M + rows - 1) / rows, L);
  NG_DISPATCH(itemsize, state_itemsize, 8, double, float, {
    natgrad_update_pre_kernel<T, U><<<grid, threads(M), 0, st>>>(
        (const T*)iH, (const T*)gH, (const T*)gm, (const U*)m, (T*)iHn,
        (T*)rhs, M, rows, lr, jitter);
  })
  return (int)cudaGetLastError();
}

// iLA [L, M, M] (lower triangular) and rhs [L, M] in the chain's type;
// m_out [L, M] and H_out [L, M, M] in the state's, written (they may be the
// state's own m and H); iLA's rows pass through shared memory `chunk` rows
// at a time, by 16-byte copies where its rows and pointer are 16-byte
// aligned
extern "C" int natgrad_update_finish(
    int itemsize, int state_itemsize, const void* iLA, const void* rhs,
    void* m_out, void* H_out, int L, int M, int rows, int chunk, int smem,
    void* stream) {
  if (!strip_ok(L, M, rows) || chunk < 1 ||
      smem != finish_smem(M, chunk, itemsize))
    return invalid();
  const bool vec = ((long)M * itemsize) % 16 == 0 &&
                   ((uintptr_t)iLA & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((M + rows - 1) / rows, L);
  NG_DISPATCH(itemsize, state_itemsize, 8, double, float, {
    auto kernel = natgrad_update_finish_kernel<T, U>;
    const int err = set_smem(kernel, smem);
    if (err) return err;
    kernel<<<grid, threads(M), smem, st>>>((const T*)iLA, (const T*)rhs,
                                           (U*)m_out, (U*)H_out, M, rows,
                                           chunk, vec);
  })
  return (int)cudaGetLastError();
}
