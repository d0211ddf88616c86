"""Where the real head's staged kernels spend a launch, block by block.

Builds a copy of ``hlax_torch/csrc/fusion.cu`` into ``build/dbg/`` whose
``heads_real_fwd_kernel`` and ``heads_real_bwd_kernel`` read the card's
``%globaltimer`` (ns) in thread (0, 0) of each block at each phase's end,
loads it in place of the wrapper's library, makes ``chip_smoke.py``'s
canonical case (400 rows of generated D4 data, the canonical conv model) in
float32 and float64, and launches each kernel with the wrapper's own
arguments.  Prints each kernel's CUDA-event time, the spread of its blocks'
starts, and each phase's duration over the blocks (min / median / max):
the forward's 1 prologue (the copies of the first rows issued, the column's
constants made), 2 rows; the backward's 1 prologue, 2 rows, 3 the warps'
sums pushed to rank 0, 4 rank 0's wait at the cluster barrier, 5 rank 0's
sums and stores; and the three blocks that end last.  Needs a card and
nvcc:

    python3 tools/real_heads_phases.py
"""
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from hlax_torch.ops import cuda_build, fusion  # noqa: E402

src = open(os.path.join(ROOT, "hlax_torch", "csrc", "fusion.cu")).read()
DBG = os.path.join(ROOT, "build", "dbg")


def put(old, new):
    global src
    assert src.count(old) == 1, old[:60]
    src = src.replace(old, new)


HDR = """
__device__ unsigned long long hlax_phase[16384];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""
put("constexpr double MIN_LOG_VY = -8.0;\n",
    "constexpr double MIN_LOG_VY = -8.0;\n" + HDR)
# backward
put("  cg::cluster_group cluster = cg::this_cluster();\n",
    "  cg::cluster_group cluster = cg::this_cluster();\n"
    "  const bool T0 = threadIdx.x == 0 && threadIdx.y == 0;\n"
    "  unsigned long long* ph = hlax_phase + (blockIdx.y * gridDim.x + "
    "blockIdx.x) * 6;\n  if (T0) ph[0] = gtime();\n")
put("    const T ivar = LV ? T(0) : cst[3][lane], dsoft = LV ? T(0) : "
    "cst[4][lane];\n",
    "    const T ivar = LV ? T(0) : cst[3][lane], dsoft = LV ? T(0) : "
    "cst[4][lane];\n    if (T0) ph[1] = gtime();\n")
put("  __syncthreads();          // every warp past its stages: the sums "
    "reuse them\n  double* const red = reinterpret_cast<double*>(smem);\n"
    "  double* const slots",
    "  if (T0) ph[2] = gtime();\n"
    "  __syncthreads();          // every warp past its stages: the sums "
    "reuse them\n  double* const red = reinterpret_cast<double*>(smem);\n"
    "  double* const slots")
put("  (void)cluster.barrier_arrive();\n  if (rank != 0) return;\n"
    "  cluster.barrier_wait();\n",
    "  if (T0) ph[3] = gtime();\n"
    "  (void)cluster.barrier_arrive();\n"
    "  if (rank != 0) { if (T0) ph[4] = ph[5] = ph[3]; return; }\n"
    "  cluster.barrier_wait();\n  if (T0) ph[4] = gtime();\n")
put("    else dbv2[c] = (T)s;\n  }\n}\n",
    "    else dbv2[c] = (T)s;\n  }\n  if (T0) ph[5] = gtime();\n}\n")
# forward
put("  __shared__ T cst[5][TILE];     // mu, sd, vd, the variance and its "
    "log\n",
    "  __shared__ T cst[5][TILE];     // mu, sd, vd, the variance and its "
    "log\n  const bool T0 = threadIdx.x == 0 && threadIdx.y == 0;\n"
    "  unsigned long long* ph = hlax_phase + 8192 + (blockIdx.y * gridDim.x"
    " + blockIdx.x) * 3;\n  if (T0) ph[0] = gtime();\n")
put("    const T var = LV ? T(0) : cst[3][lane], lvar = LV ? T(0) : "
    "cst[4][lane];\n",
    "    const T var = LV ? T(0) : cst[3][lane], lvar = LV ? T(0) : "
    "cst[4][lane];\n    if (T0) ph[1] = gtime();\n")
put("  if (fast) rows_loop(Const<1>());\n  else rows_loop(Const<0>());\n}\n\n"
    "// The real backward's shared memory",
    "  if (fast) rows_loop(Const<1>());\n  else rows_loop(Const<0>());\n"
    "  __syncthreads();\n  if (T0) ph[2] = gtime();\n}\n\n"
    "// The real backward's shared memory")
src += """
extern "C" int hlax_phase_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, hlax_phase, (size_t)n * 8);
}
"""
os.makedirs(DBG, exist_ok=True)
open(os.path.join(DBG, "fusion.cu"), "w").write(src)
res = subprocess.run([cuda_build._nvcc(), *cuda_build.nvcc_flags("fusion"),
                      "-o", os.path.join(DBG, "libfusion.so"),
                      os.path.join(DBG, "fusion.cu")],
                     capture_output=True, text=True)
if res.returncode:
    print(res.stdout[-3000:], res.stderr[-3000:])
    sys.exit(1)
lib = ctypes.CDLL(os.path.join(DBG, "libfusion.so"))
lib.cuda_error_string.argtypes = [ctypes.c_int]
lib.cuda_error_string.restype = ctypes.c_char_p
fusion.load_library = lambda name: lib


def phases():
    """The instrumented kernels' timestamps, ns."""
    buf = np.zeros(16384, dtype=np.uint64)
    code = lib.hlax_phase_read(ctypes.c_void_p(buf.ctypes.data), 16384)
    assert code == 0, code
    return buf


with tempfile.TemporaryDirectory() as tmp:
    data_dir = os.path.join(tmp, "data")
    cs.write_canonical_data(data_dir)
    ds, spec0, spec1 = cs.canonical_setup(data_dir)
    sms = fusion._sm_count(torch.cuda.current_device())
    for dtype in (torch.float32, torch.float64):
        c = cs._fusion_case(ds, spec0, spec1, dtype)
        calls, orig = {}, fusion._launch

        def record(entry, like, *args):
            calls.setdefault(entry, (like, args))
            orig(entry, like, *args)

        fusion._launch = record
        cs._op_heads(c, False)
        fusion._launch = orig
        tag = str(dtype).removeprefix("torch.")
        for entry, width, base in (("heads_real_fwd", 3, 8192),
                                   ("heads_real_bwd", 6, 0)):
            like, args = calls[entry]
            ms = cs.time_ms(lambda: orig(entry, like, *args))[0]
            for _ in range(5):
                orig(entry, like, *args)
            torch.cuda.synchronize()
            if entry == "heads_real_fwd":
                plan = fusion.heads_real_fwd_plan(400, 324, 5, False,
                                                  like.element_size(), sms)
            else:
                plan = fusion.heads_real_bwd_plan(400, 324, 5, False,
                                                  like.element_size(), sms)
            nb = plan.tiles * plan.chunks
            ph = phases()[base:base + nb * width].reshape(nb, width)
            ph = ph.astype(np.int64) - int(ph[:, 0].min())
            d = np.diff(ph, axis=1)
            if entry == "heads_real_bwd":     # rank 0 of each cluster
                d = np.concatenate([d[:, :3], np.where(
                    d[:, 3:] > 0, d[:, 3:], np.nan)], axis=1)
            print(f"[phases] {entry} {tag}: kernel {ms * 1e3:.2f} us "
                  f"(events); {nb} blocks; start spread "
                  f"{ph[:, 0].max() / 1e3:.2f} us; last end "
                  f"{ph[:, -1].max() / 1e3:.2f} us after the first start; "
                  "phase durations (min / median / max us): "
                  + "; ".join(f"{k + 1}: {np.nanmin(d[:, k]) / 1e3:.2f} / "
                              f"{np.nanmedian(d[:, k]) / 1e3:.2f} / "
                              f"{np.nanmax(d[:, k]) / 1e3:.2f}"
                              for k in range(width - 1)), flush=True)
            slow = np.argsort(ph[:, -1])[-3:]
            print(f"[phases] {entry} {tag} last blocks (x, y: phases us): "
                  + "; ".join(f"{b % plan.tiles}, {b // plan.tiles}: "
                              + ", ".join(f"{t / 1e3:.2f}" for t in d[b])
                              for b in slow), flush=True)
        del c
