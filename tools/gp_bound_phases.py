"""Where the KL bound's four kernels spend a launch, block by block.

    python3 tools/gp_bound_phases.py [tree]

``tree``: a checkout whose ``hlax_torch/csrc/gp_bound.cu`` and
``hlax_torch/ops/gp_bound.py`` are measured (default: this one; e.g.
``parent/``, an earlier commit unpacked there).  Builds the tree's
``gp_bound.cu`` twice into ``build/dbg/``: as it is, and a copy whose
kernels (K1, K3 and their row-tile kernels, K2, K4, where the source
marks them) read the card's ``%globaltimer`` (ns) in thread 0 of each
block at the ends of their phases (the ``GP_PHASE`` marks of the source;
a source without any fails, a kernel without them gets its event time
only), each phase's time summed over the subjects or tiles a block
takes.  Loads the tree's wrapper as a module of its
own on each library and, on ``chip_smoke.bound_case``'s synthetic state
(float32 and float64; [32,20,20,120] the canonical batch, [16,10,20,120] a
2 x 2 mesh rank's, [32,4,200,120] and [32,2,500,120] the long sequences'):

- ``sweep``: K1's and K3's time against the subjects a launch takes (the
  first 1..32 latents; ``chip_smoke.gp_bound_sweep``), at the canonical
  shape and T = 200: a launch's fixed part and a subject's marginal cost;
- ``phases``: each kernel's CUDA-event time beside torch's copy of as
  many bytes as it moves (L2-warm both), its blocks, when they start
  (the spread of the first wave's starts, how many start later: a second
  wave), and each phase's time a block (min / median / max; the mean of
  RUNS launches in a row, the starts and ends the last's).  Staged: 1
  waiting for a subject's copies (and the barrier before them), 2 the
  products (K1: the fit and q; K3: d K0xz and (K0xz G) K0xz^T), 3 K1's u
  and iB K0xz, K3's d iB + d iB^T and d iLB, 4 K3's stores of the rest, 5
  K1's partials.  Long subjects: K1 2 the fit and the cluster's r, 3 iB r,
  iB^T r and u, 5 the partials; K3 2 a pair's tiles staged (or a row
  tile's d K0xz), 3 their entries, 4 a row tile's d mu and d log_v.  K2:
  1 its copies issued and waited for (with u's sums, which run before the
  wait), 2 the sums of its tiles, 3 P_batch, the block's sums and
  partials, 5 the counter, 4 the last block's sums of the partials, 6 its
  assembly of the terms.  K4 (thread 0's team of four warps, the
  other team's d iK0zz seen through the barrier after it): 1 its copies
  issued and waited for, 2 G2 written, 5 the factors' diagonal cotangents
  written, 3 the wait for the other team (and d m's parts with m's
  gradient; none here, the canonical step's natural gradients), 4 the
  last block's finish of d m.  (Latent kernels of a
  strip of rows a block, as in earlier trees: K2 1 its strip of H^T staged
  and waited for, 2 its sums and u's, 3 the block's sum, partials and
  counter, 4 the last block's finish; K4 1 its three strips staged and
  waited for, 2 its entries, 3 d m.)  Then
  the time from the first start to the last end, and what the event time
  holds beyond it (the launch's fixed part).

Needs a card and nvcc.
"""
import ctypes
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

TREE = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else ROOT
DBG = os.path.join(ROOT, "build", "dbg")
# the slots a block (its start, six phases, its end), a kernel's slots, and
# the instrumented runs whose phases are averaged (warm: no copy between)
SLOTS, PER_KERNEL, RUNS = 8, 1 << 17, 5
KERNELS = {"gp_bound_fwd_subjects": 0, "gp_bound_bwd_subjects": 1,
           "gp_bound_fwd_latents": 2, "gp_bound_bwd_latents": 3}

HDR = """
__device__ unsigned long long gp_phase[4 << 17];
__device__ __forceinline__ unsigned long long gp_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define GP_PHASE_BEGIN(k)                                                  \\
  unsigned long long* gp_ph = gp_phase + (k) * (1 << 17) +                 \\
      ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 8;                   \\
  unsigned long long gp_t = gp_gtime();                                    \\
  if (threadIdx.x == 0) gp_ph[0] = gp_t;
#define GP_PHASE(k)                                                        \\
  if (threadIdx.x == 0) {                                                  \\
    const unsigned long long gp_n = gp_gtime();                            \\
    gp_ph[k] += gp_n - gp_t;                                               \\
    gp_t = gp_n;                                                           \\
  }
#define GP_PHASE_END                                                       \\
  if (threadIdx.x == 0) gp_ph[7] = gp_gtime();
"""
READERS = """
extern "C" int gp_phase_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, gp_phase, (size_t)n * 8);
}
extern "C" int gp_phase_zero() {
  void* p;
  const cudaError_t e = cudaGetSymbolAddress(&p, gp_phase);
  return (int)(e ? e : cudaMemset(p, 0, sizeof(gp_phase)));
}
"""
# (L, S, T, M) of the phases, and those of the sweep
SHAPES = [(32, 20, 20, 120), (16, 10, 20, 120), (32, 4, 200, 120),
          (32, 2, 500, 120)]
SWEEP_SHAPES = [(32, 20, 20, 120), (32, 4, 200, 120)]


def instrumented() -> str:
    path = os.path.join(TREE, "hlax_torch", "csrc", "gp_bound.cu")
    src = open(path).read()
    if "GP_PHASE_BEGIN" not in src:
        sys.exit(f"FAIL: {path} has no GP_PHASE marks to instrument")
    src = src.replace("#include <stdint.h>\n", "#include <stdint.h>\n" + HDR,
                      1) + READERS
    path = os.path.join(DBG, "phases", "gp_bound.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "w").write(src)
    return path


def phases(gb, lib, case, tag):
    """Each kernel's launch of one canonical forward and backward, alone
    and instrumented: its blocks' phases (its event time only where the
    source has no marks in it)."""
    for entry, like, args in cs.bound_launches(gb, case):
        if entry not in KERNELS:
            continue
        run = lambda: gb._launch(entry, like, *args)
        ms = cs.time_ms(run)[0]
        # a yardstick: torch's copy of as many bytes (half read, half
        # written) as the function's own (``_gp_bound_bytes``)
        nbytes = cs._gp_bound_bytes(entry, args, own=True)
        src = torch.empty(nbytes // 8, dtype=torch.float32, device="cuda")
        dst = torch.empty_like(src)
        copy = cs.time_ms(lambda: dst.copy_(src))[0]
        del src, dst
        run()
        torch.cuda.synchronize()
        assert lib.gp_phase_zero() == 0
        for _ in range(RUNS):
            run()
        torch.cuda.synchronize()
        n = len(KERNELS) * PER_KERNEL
        buf = np.zeros(n, dtype=np.uint64)
        assert lib.gp_phase_read(ctypes.c_void_p(buf.ctypes.data), n) == 0
        base = KERNELS[entry] * PER_KERNEL
        ph = buf[base:base + PER_KERNEL].reshape(-1, SLOTS).astype(np.int64)
        blocks = np.nonzero(ph[:, 0] > 0)[0]
        ph = ph[blocks]
        if not len(ph):
            print(f"[phases] {entry} {tag}: kernel {ms * 1e3:.2f} us "
                  f"(events; a copy of its {nbytes / 1e6:.2f} MB "
                  f"{copy * 1e3:.2f} us); no GP_PHASE marks in it on "
                  f"{cs.card_line()}", flush=True)
            continue
        t0 = ph[:, 0].min()
        start, end = ph[:, 0] - t0, ph[:, 7] - t0
        first = np.sort(start)[:min(len(start), 132)]
        late = int((start > first.max() + 1000).sum())
        span = end.max()
        d = ph[:, 1:7] / 1e3 / RUNS
        print(f"[phases] {entry} {tag}: kernel {ms * 1e3:.2f} us (events; "
              f"a copy of its {nbytes / 1e6:.2f} MB {copy * 1e3:.2f} us); "
              f"{len(ph)} blocks, the first 132's starts within "
              f"{first.max() / 1e3:.2f} us, {late} starting later; first "
              f"start to last end {span / 1e3:.2f} us (the event time's "
              f"rest {ms * 1e3 - span / 1e3:.2f} us); block ends min / "
              f"median / max {end.min() / 1e3:.2f} / "
              f"{np.median(end) / 1e3:.2f} / {span / 1e3:.2f} us; phases "
              "a block (min / median / max us): "
              + "; ".join(f"{k + 1}: {d[:, k].min():.2f} / "
                          f"{np.median(d[:, k]):.2f} / {d[:, k].max():.2f}"
                          for k in range(6) if d[:, k].max() > 0)
              + f" on {cs.card_line()}", flush=True)
        slow = np.argsort(end)[::-1][:3]
        print(f"[phases] {entry} {tag}: the last blocks to end (block "
              "index: end us; phases us): "
              + "; ".join(f"{blocks[i]}: {end[i] / 1e3:.2f}; "
                          + " ".join(f"{d[i, k]:.2f}" for k in range(6))
                          for i in slow), flush=True)


def main():
    if not torch.cuda.is_available():
        print("FAIL: no card", flush=True)
        sys.exit(2)
    gb, _, _ = cs.tree_ops(TREE, "gp_bound", os.path.join(DBG, "plain"))
    gbp, lib, log = cs.tree_ops(TREE, "gp_bound",
                                os.path.join(DBG, "phases"),
                                src=instrumented())
    lib.gp_phase_zero.restype = ctypes.c_int
    cs._ptxas_report("phases", "gp_bound (instrumented)", log,
                     only="gp_bound_")
    print(f"[phases] tree {TREE}", flush=True)
    for dtype in (torch.float32, torch.float64):
        for shape in SHAPES:
            case = cs.bound_case(*shape, dtype)
            tag = f"{list(shape)} {str(dtype).removeprefix('torch.')}"
            if shape in SWEEP_SHAPES:
                cs.gp_bound_sweep(gb, case, "phases")
            phases(gbp, lib, case, tag)
            del case
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
