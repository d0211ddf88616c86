"""Where the natural-gradient kernels (``csrc/natgrad.cu``) spend a
launch, block by block: K5 (``natgrad_fwd_subjects``) and K8
(``natgrad_update_finish``), K6 (``natgrad_fwd_latents``) and K7
(``natgrad_update_pre``), each alone and after the kernels that run before
it in the train step.

    python3 tools/natgrad_phases.py [--strips] [tree ...]

``tree``: checkouts whose ``hlax_torch/csrc/natgrad.cu`` and
``hlax_torch/ops/natgrad.py`` are measured (default: this one, and
``parent/`` where an earlier commit is unpacked there); ``--strips``: K6
and K7 only.  Builds each tree's ``natgrad.cu`` into
``build/dbg/natgrad/`` as a copy whose kernels read the card's
``%globaltimer`` (ns) at each block's start and end and its SM's
``clock64`` cycles at the ends of their phases, in thread 0 (the
``NG_PHASE`` marks of the source; a kernel without them, such as an
older tree's K6 and K7 of a thread a column, prints its event time
only), each phase summed over the chunks and
rounds a block takes and read in microseconds at the SM's top clock
(``nvidia-smi``'s ``clocks.max.sm``; under load the clock may be lower and
a phase longer than printed).  Loads the tree's wrapper as a module of
its own on that library and, on ``chip_smoke.bound_case``'s state (float32
and float64; [32,20,20,120] the canonical batch, [16,10,20,120] a 2 x 2
mesh rank's), launches K5 on the bound's own K0xz, iB (from its iLB), mu
and valid three ways, RUNS launches each:

- ``warm``: K5 again and again (its inputs in L2);
- ``cold``: 64 MB written before each launch (its inputs from HBM);
- ``in step``: the bound's forward before each launch, as the train step
  runs it (``chip_smoke._gp_bound_run``: K1, cuBLAS's products, K2), so
  the L2 holds what those kernels left;

K8 warm and cold on ``chip_smoke.natgrad_case``'s iLA and rhs of the same
shape; K6 on that case's inputs warm, cold and in the step (after
cuBLAS's ``baddbmm`` and ``bmm`` that make X, writing the X it reads, as
``natgrad.fwd_latents`` runs them); K7 warm, cold and in the step (after
the bound's forward and backward, which run between K6 and K7 in the
step), and with jitter warm and cold.  For each: the kernel's CUDA-event
time (in step: events around the kernel alone, the launches queued behind
a spin kernel), its blocks, the spread of their starts, the time from the
first start to the last end, and each phase's time a block (min / median
/ max).  K5's phases: 1 its rows' iB mu (the barriers made, its two bulk
copies issued, iB's first, mu and valid read, iB's rows landed, their
products), 2 the wait for its rows of K0xz, 3 the column sums, 4 the sums
pushed to their owners, the cluster's barrier and ng_P1 written.  K8's:
1 its rows of iLA landed (the barriers made, the parts dealt, the copy
issued), 2 the products, 3 a split task's parts added, 4 its entries
written and m_new's parts made from them, 5 the parts added into each
row's partial and pushed to the row's owner, 6 the cluster's barrier and
m_new written.  K6's: 1 the copies issued, 2
landed, 3 the element work and its writes, 4 the row sums, 5 grad_m
written; K7's: 1, 2 the same, 3 the diagonal's sum (jitter only), 4 the
element work and writes, 5 the row sums, 6 rhs written.  A mark adds its
cycles in registers; a block writes them once at its end.

Then, for this tree only: ``strips``, K6 and K7 for 4, 8 and 16 rows a
strip (the most the kernels take; float32 and float64, both shapes),
warm and cold in turns; ``clusters``, K5 and K8 on
their plans for a cluster of 1 to 4 blocks a latent (the plans' SM count
set to give each size; float32 and float64, canonical batch), each timed
warm and cold in turns (1, 2, 3, 4, 4, 3, 2, 1); and ``mma``, the FP64
tensor cores' rate by ``mma.sync`` shape on Hopper (m8n8k4, m16n8k4,
m16n8k8: 132 blocks of 128 and 512 threads, each warp 8 chains of 2000
products; the m16n8k8 fragments' layout checked against a product on the
card).

Needs a card and nvcc.
"""
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

PARENT = os.path.join(ROOT, "parent")
ARGS = sys.argv[1:]
STRIPS_ONLY = "--strips" in ARGS
TREES = ([os.path.abspath(t) for t in ARGS if t != "--strips"] or
         [ROOT] + ([PARENT] if os.path.isfile(os.path.join(
             PARENT, "hlax_torch", "csrc", "natgrad.cu")) else []))
DBG = os.path.join(ROOT, "build", "dbg", "natgrad")
# the slots a block (its start, six phases, its end), a kernel's blocks'
# slots, and the instrumented launches whose phases are averaged
SLOTS, BLOCKS, RUNS = 8, 1 << 12, 5
KERNELS = {"natgrad_fwd_subjects": 0, "natgrad_update_finish": 1,
           "natgrad_fwd_latents": 2, "natgrad_update_pre": 3}
# the SM clock the phases' cycle counts (clock64, thread 0 of a block) are
# read at: the card's, by nvidia-smi, at the tool's start
SM_MHZ = 1980.0

HDR = """
__device__ unsigned long long ng_phase[4 << 15];
__device__ __forceinline__ unsigned long long ng_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// a phase's cycles add up in registers (a mark reads no memory, so it
// stalls on nothing), written once at the block's end
#define NG_PHASE_BEGIN(k)                                                  \\
  unsigned long long* ng_ph = ng_phase + (k) * (8 << 12) +                 \\
      ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 8;                   \\
  long long ng_acc[7] = {0, 0, 0, 0, 0, 0, 0};                             \\
  const unsigned long long ng_t0 = threadIdx.x == 0 ? ng_gtime() : 0;      \\
  long long ng_t = clock64();
#define NG_PHASE(k)                                                        \\
  if (threadIdx.x == 0) {                                                  \\
    const long long ng_n = clock64();                                      \\
    ng_acc[k] += ng_n - ng_t;                                              \\
    ng_t = ng_n;                                                           \\
  }
#define NG_PHASE_END                                                       \\
  if (threadIdx.x == 0) {                                                  \\
    ng_ph[0] = ng_t0;                                                      \\
    _Pragma("unroll") for (int ng_k = 1; ng_k < 7; ++ng_k)                 \\
        ng_ph[ng_k] += ng_acc[ng_k];                                       \\
    ng_ph[7] = ng_gtime();                                                 \\
  }
"""
READERS = """
extern "C" int ng_phase_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, ng_phase, (size_t)n * 8);
}
extern "C" int ng_phase_zero() {
  void* p;
  const cudaError_t e = cudaGetSymbolAddress(&p, ng_phase);
  return (int)(e ? e : cudaMemset(p, 0, sizeof(ng_phase)));
}
"""
SHAPES = [(32, 20, 20, 120), (16, 10, 20, 120)]


def instrumented(tree: str, out: str) -> str:
    """The tree's natgrad.cu with the marks compiled in, in ``out``."""
    path = os.path.join(tree, "hlax_torch", "csrc", "natgrad.cu")
    src = open(path).read()
    src = src.replace("#include <stdint.h>\n", "#include <stdint.h>\n" + HDR,
                      1) + READERS
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "natgrad.cu")
    open(path, "w").write(src)
    return path


def phases(lib, entry, run, prelude, ms, tag):
    """``run``'s (one launch of ``entry``) blocks' phases over RUNS
    launches, each after ``prelude``; ``ms`` its event time."""
    run()
    torch.cuda.synchronize()
    assert lib.ng_phase_zero() == 0
    for _ in range(RUNS):
        if prelude is not None:
            prelude()
        run()
    torch.cuda.synchronize()
    buf = np.zeros(len(KERNELS) * SLOTS * BLOCKS, dtype=np.uint64)
    assert lib.ng_phase_read(ctypes.c_void_p(buf.ctypes.data),
                             len(KERNELS) * SLOTS * BLOCKS) == 0
    base = KERNELS[entry] * SLOTS * BLOCKS
    ph = buf[base:base + SLOTS * BLOCKS].reshape(-1, SLOTS).astype(np.int64)
    ph = ph[ph[:, 0] > 0]
    if not len(ph):
        print(f"[phases] {entry} {tag}: kernel {ms * 1e3:.2f} us (events); "
              f"no NG_PHASE marks in it on {cs.card_line()}", flush=True)
        return
    t0 = ph[:, 0].min()
    start_ns, end_ns = ph[:, 0] - t0, ph[:, 7] - t0
    d = ph[:, 1:7] / (SM_MHZ * 1e-3) / 1e3 / RUNS
    print(f"[phases] {entry} {tag}: kernel {ms * 1e3:.2f} us (events); "
          f"{len(ph)} blocks, starts within {start_ns.max() / 1e3:.2f} us; "
          f"first start to last end {end_ns.max() / 1e3:.2f} us (the last "
          "launch's); phases a block (min / median / max us): "
          + "; ".join(f"{k + 1}: {d[:, k].min():.2f} / "
                      f"{np.median(d[:, k]):.2f} / {d[:, k].max():.2f}"
                      for k in range(6) if d[:, k].max() > 0)
          + f" on {cs.card_line()}", flush=True)


def in_step_ms(run, prelude) -> float:
    """``run``'s event time after ``prelude``, the median of 20: events
    around the kernel alone, all queued behind a spin kernel that outlasts
    their enqueueing (three times the host's time for it after a first
    call, 2 to 200 ms), so no event waits on the host."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    prelude()               # first calls build and cache
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prelude()
    run()
    spin = min(0.2, max(2e-3, 3 * (time.perf_counter() - t0)))
    torch.cuda.synchronize()
    out = []
    for i in range(23):
        torch.cuda._sleep(int(spin * cs.SPIN_CYCLES_PER_S))
        prelude()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        if i >= 3:
            out.append(start.elapsed_time(end))
    return float(np.median(out))


def _flush():
    flush = torch.empty(cs.COLD_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    return flush, lambda: flush.fill_(1.0)


def measure(ng, lib, shape, dtype):
    """K5 warm, cold and in the step on the bound case's inputs; K8 warm
    and cold on natgrad_case's."""
    tag = f"{list(shape)} {str(dtype).removeprefix('torch.')}"
    case = cs.bound_case(*shape, dtype)
    (K0xz, iLB, *_), valid = case
    mu = case[0][9]
    iB = torch.einsum("lskt,lsku->lstu", iLB, iLB).contiguous()
    (entry, like, args), = cs._launches_of(ng, lambda: ng.fwd_subjects(
        iB, mu, valid, K0xz, K0xz.dtype))
    run = lambda: ng._launch(entry, like, *args)
    flush, cold = _flush()
    bound = lambda: cs._gp_bound_run(True, case, False, grads=False)
    for how, prelude, ms in (
            ("warm", None, cs.time_ms(run)[0]),
            ("cold", cold, cs.time_cold_ms(run)),
            ("in step", bound, in_step_ms(run, bound))):
        phases(lib, entry, run, prelude, ms, f"{tag} {how}")
    nc = cs.natgrad_case(*shape, dtype)
    (entry, like, args), = cs._launches_of(ng, lambda: ng.update_finish(
        *nc["finish"], nc["state"]))
    run = lambda: ng._launch(entry, like, *args)
    for how, prelude, ms in (("warm", None, cs.time_ms(run)[0]),
                             ("cold", cold, cs.time_cold_ms(run))):
        phases(lib, entry, run, prelude, ms, f"{tag} {how}")
    del flush, case, nc


def measure_strips(ng, lib, shape, dtype):
    """K6 warm, cold and in the step (after the products that write its
    X); K7 warm, cold and in the step (after the bound's forward and
    backward), and with jitter warm and cold; on natgrad_case's inputs."""
    L, _, _, M = shape
    tag = f"[{L}, {M}, {M}] {str(dtype).removeprefix('torch.')}"
    nc = cs.natgrad_case(*shape, dtype)
    flush, cold = _flush()
    (e6, l6, a6), = cs._launches_of(ng, lambda: ng.latents(*nc["latents"]))
    gen = torch.Generator("cuda").manual_seed(0)
    A, C = (0.1 * torch.randn((L, M, M), generator=gen, dtype=dtype,
                              device="cuda") for _ in range(2))
    X = torch.empty_like(a6[2])
    products = lambda: torch.bmm(A.mT, torch.baddbmm(A, C, A), out=X)
    products()
    args6 = a6[:2] + (X,) + a6[3:]
    run = lambda: ng._launch(e6, l6, *args6)
    for how, prelude, ms in (
            ("warm", None, cs.time_ms(run)[0]),
            ("cold", cold, cs.time_cold_ms(run)),
            ("in step", products, in_step_ms(run, products))):
        phases(lib, e6, run, prelude, ms, f"{tag} {how}")
    case = cs.bound_case(*shape, dtype)
    backward = lambda: cs._gp_bound_run(True, case, False)
    for jitter in (0.0, cs.NATGRAD_JITTER):
        (e7, l7, a7), = cs._launches_of(ng, lambda: ng.update_pre(
            *nc["pre"], cs.NATGRAD_LR, jitter))
        run = lambda: ng._launch(e7, l7, *a7)
        conds = [("warm", None, cs.time_ms(run)[0]),
                 ("cold", cold, cs.time_cold_ms(run))]
        if not jitter:
            conds.append(("in step", backward, in_step_ms(run, backward)))
        for how, prelude, ms in conds:
            phases(lib, e7, run, prelude, ms,
                   f"{tag} jitter {jitter:g} {how}")
    del flush, case, nc


# the rows a strip the sweep takes (at most the kernels' RMAX)
SWEEP_ROWS = (4, 8, 16)
# the strips' rows and shared bytes by argument of K6's and K7's C entries
PLAN_ARG = {"natgrad_fwd_latents": 11, "natgrad_update_pre": 10}


def strip_sweep(ng, dtype):
    """K6 and K7 for each strip of rows a block (SWEEP_ROWS, where the
    shared bytes fit), warm and cold in turns (the rows ascending, then
    descending)."""
    for shape in SHAPES:
        L, _, _, M = shape
        nc = cs.natgrad_case(*shape, dtype)
        calls = cs._launches_of(ng, lambda: (
            ng.latents(*nc["latents"]),
            ng.update_pre(*nc["pre"], cs.NATGRAD_LR, 0.0)))
        for entry, like, args in calls:
            runs, ms, i = {}, {}, PLAN_ARG[entry]
            for rows in SWEEP_ROWS:
                smem = ng.strip_smem(rows, M, args[0], args[1], entry)
                if smem > ng.SMEM_MAX:
                    continue
                a = args[:i] + (rows, smem) + args[i + 2:]
                runs[rows] = lambda a=a: ng._launch(entry, like, *a)
                ms[rows] = []
            order = sorted(runs) + sorted(runs, reverse=True)
            for rows in order:
                ms[rows].append((cs.time_ms(runs[rows])[0],
                                 cs.time_cold_ms(runs[rows])))
            plan = ng.strip_plan(L, M, args[0], args[1], entry,
                                 ng._sms(like))
            print(f"[strips] {entry} [{L}, {M}, {M}] "
                  f"{str(dtype).removeprefix('torch.')}, ms warm; L2-cold by "
                  "rows a block (turns ascending, descending): "
                  + "; ".join(f"{r} ({-(-M // r) * L} blocks of "
                              f"{ng.strip_threads(r, args[0])} threads): "
                              + ", ".join(f"{w:.5f}" for w, _ in ms[r])
                              + "; " + ", ".join(f"{c:.5f}" for _, c in ms[r])
                              for r in sorted(runs))
                  + f" (the plan's: {plan.rows}) on {cs.card_line()}",
                  flush=True)
        del nc
        torch.cuda.empty_cache()


MMA_SRC = r"""
#include <cuda_runtime.h>
#define MMA_LOOP(ACC, ASM, ...)                                          \
  for (int i = 0; i < n; ++i)                                            \
    _Pragma("unroll") for (int j = 0; j < 8; ++j) asm(ASM : __VA_ARGS__);
__global__ void m884(double* out, int n) {
  double d[8][2] = {}, a = threadIdx.x * 1e-3, b = 1.0001;
  MMA_LOOP(d, "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, "
           "{%2}, {%3}, {%0,%1};", "+d"(d[j][0]), "+d"(d[j][1]) : "d"(a),
           "d"(b))
  double s = 0;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void m1684(double* out, int n) {
  double d[8][4] = {}, a = threadIdx.x * 1e-3, b = 1.0001;
  MMA_LOOP(d, "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
           "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};", "+d"(d[j][0]),
           "+d"(d[j][1]), "+d"(d[j][2]), "+d"(d[j][3]) : "d"(a), "d"(a),
           "d"(b))
  double s = 0;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void m1688(double* out, int n) {
  double d[8][4] = {}, a = threadIdx.x * 1e-3, b = 1.0001;
  MMA_LOOP(d, "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
           "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};",
           "+d"(d[j][0]), "+d"(d[j][1]), "+d"(d[j][2]), "+d"(d[j][3])
           : "d"(a), "d"(a), "d"(a), "d"(a), "d"(b), "d"(b))
  double s = 0;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// A [16, 8] times B [8, 8] through natgrad.cu's m16n8k8 fragments
__global__ void check1688(const double* A, const double* B, double* C) {
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  double c[4] = {0, 0, 0, 0};
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(A[g * 8 + t]), "d"(A[(g + 8) * 8 + t]), "d"(A[g * 8 + t + 4]),
        "d"(A[(g + 8) * 8 + t + 4]), "d"(B[t * 8 + g]),
        "d"(B[(t + 4) * 8 + g]));
  C[g * 8 + 2 * t] = c[0];
  C[g * 8 + 2 * t + 1] = c[1];
  C[(g + 8) * 8 + 2 * t] = c[2];
  C[(g + 8) * 8 + 2 * t + 1] = c[3];
}
extern "C" int run(int which, double* out, int blocks, int threads, int n) {
  if (which == 0) m884<<<blocks, threads>>>(out, n);
  if (which == 1) m1684<<<blocks, threads>>>(out, n);
  if (which == 2) m1688<<<blocks, threads>>>(out, n);
  return (int)cudaGetLastError();
}
extern "C" int check(const double* A, const double* B, double* C) {
  check1688<<<1, 32>>>(A, B, C);
  return (int)cudaGetLastError();
}
"""
# (shape, multiply-adds an instruction) of MMA_SRC's kernels
MMA_SHAPES = [("m8n8k4", 256), ("m16n8k4", 512), ("m16n8k8", 1024)]


def mma_rates():
    """The FP64 tensor cores' TFLOP/s by mma.sync shape (MMA_SRC)."""
    from hlax_torch.ops import cuda_build

    out_dir = os.path.join(DBG, "mma")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = (os.path.join(out_dir, f) for f in ("mma.cu",
                                                        "libmma.so"))
    open(src, "w").write(MMA_SRC)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                    lib_path, src], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    out = torch.empty(132 * 512, dtype=torch.float64, device="cuda")
    n = 2000
    for which, (shape, fma) in enumerate(MMA_SHAPES):
        for threads in (128, 512):
            args = (which, ctypes.c_void_p(out.data_ptr()), 132, threads, n)
            assert lib.run(*args) == 0
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            lib.run(*args)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            flops = 2 * fma * 8 * n * 132 * threads // 32
            print(f"[mma] f64 {shape}: {flops / ms / 1e9:.1f} TFLOP/s (132 "
                  f"blocks of {threads} threads) on {cs.card_line()}",
                  flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    A = torch.randn(16, 8, dtype=torch.float64, device="cuda", generator=gen)
    B = torch.randn(8, 8, dtype=torch.float64, device="cuda", generator=gen)
    C = torch.zeros(16, 8, dtype=torch.float64, device="cuda")
    assert lib.check(*(ctypes.c_void_p(t.data_ptr()) for t in (A, B, C))) \
        == 0
    err = (C - A @ B).abs().max().item()
    print(f"[mma] m16n8k8 fragments: largest difference from A @ B {err:.3e}",
          flush=True)
    if err > 1e-12:
        sys.exit("FAIL: the m16n8k8 fragments' layout")


def cluster_sweep(ng, dtype):
    """K5 and K8 on their plans for 1 to 4 blocks a latent's cluster
    (``cluster_blocks`` at an SM count chosen for each), warm and cold in
    turns."""
    case = cs.natgrad_case(32, 20, 20, 120, dtype)
    (e5, l5, a5), (e8, l8, a8) = cs._launches_of(ng, lambda: (
        ng.fwd_subjects(*case["subjects"], case["chain"]),
        ng.update_finish(*case["finish"], case["state"])))
    runs = {}
    for cl in range(1, 5):
        sms = cl * (32 + ng.GPCS) - ng.GPCS
        sp = ng.subjects_plan(32, 20, 20, 120, a5[0], True, sms)
        fp = ng.finish_plan(32, 120, a8[0], sms)
        runs[("K5", cl)] = (lambda a=a5[:13] + (sp.cluster, sp.chunk,
                                                sp.smem):
                            ng._launch(e5, l5, *a))
        runs[("K8", cl)] = (lambda a=a8[:8] + (fp.cluster, fp.warps,
                                               fp.chunk, fp.smem):
                            ng._launch(e8, l8, *a))
    ms = {k: [] for k in runs}
    for cl in (1, 2, 3, 4, 4, 3, 2, 1):
        for kernel in ("K5", "K8"):
            run = runs[(kernel, cl)]
            ms[(kernel, cl)].append((cs.time_ms(run)[0], cs.time_cold_ms(run)))
    for kernel in ("K5", "K8"):
        print(f"[clusters] {kernel} [32, 20, 20, 120] "
              f"{str(dtype).removeprefix('torch.')}, ms warm; L2-cold by "
              "blocks a cluster (turns 1..4, 4..1): "
              + "; ".join(f"{cl}: " + ", ".join(f"{w:.5f}" for w, _ in
                                                ms[(kernel, cl)])
                          + "; " + ", ".join(f"{c:.5f}" for _, c in
                                             ms[(kernel, cl)])
                          for cl in range(1, 5))
              + f" on {cs.card_line()}", flush=True)


def main():
    global SM_MHZ
    if not torch.cuda.is_available():
        print("FAIL: no card", flush=True)
        sys.exit(2)
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    if out.returncode == 0 and out.stdout.strip():
        SM_MHZ = float(out.stdout.split()[0])
    print(f"[phases] phases' cycles read at the SM clock's {SM_MHZ:.0f} MHz",
          flush=True)
    for i, tree in enumerate(TREES):
        out = os.path.join(DBG, str(i))
        ng, lib, log = cs.tree_ops(tree, "natgrad", out,
                                   src=instrumented(tree, out))
        lib.ng_phase_zero.restype = ctypes.c_int
        cs._ptxas_report("phases", "natgrad (instrumented)", log,
                         only="natgrad_")
        print(f"[phases] tree {tree}", flush=True)
        for dtype in (torch.float32, torch.float64):
            for shape in SHAPES:
                if not STRIPS_ONLY:
                    measure(ng, lib, shape, dtype)
                measure_strips(ng, lib, shape, dtype)
                torch.cuda.empty_cache()
    from hlax_torch.ops import natgrad as ng

    if hasattr(ng, "strip_smem"):
        for dtype in (torch.float32, torch.float64):
            strip_sweep(ng, dtype)
    if STRIPS_ONLY:
        return
    for dtype in (torch.float32, torch.float64):
        cluster_sweep(ng, dtype)
    mma_rates()


if __name__ == "__main__":
    main()
