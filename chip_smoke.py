"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels, holds
each against its plain PyTorch version, trains the canonical Heterogeneous
Health-MNIST D4 config at full width for 30 steps with validation and the
test battery, then imputes with the trained model.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build   nvcc builds hlax_torch/csrc/*.cu for sm_90a, in parallel.
  2. kernels each kernel against its plain version, with the launch plan
             each shape took: the small kernel bit for bit at eleven shapes
             (both compiled sizes, padded and odd n, n up to 48) on random
             SPD and float32-indefinite inputs; the mid kernel against
             float64 at five shapes on SPD, ill-conditioned (M = 120) and
             indefinite inputs, its n <= 32 path also bit for bit; the
             backward kernel at eight shapes on random, L_bar = 0 and
             L^-1_bar = 0 cotangents, against float64.  Device times (CUDA events, the launches queued
             ahead) of kernel, plain version, the library call where one
             exists (torch.linalg.cholesky + solve_triangular), the bound,
             the kernel's wall time a call on the host, and for the small
             and backward kernels the time of one matrix alone.
  3. reference  four toy-width train steps on the card against the same
             steps on the CPU (plain versions), same weights and noise; the
             toy M = 30 takes the mid kernel's n <= 32 path.
  4. slice   generated D4 splits (prediction = training, test, validation;
             P=200, T=20, 25% missing) -> hlax_torch.cli.main.run with the
             canonical config, 3 epochs of 10 steps on the card, then the
             final validation and the test battery; launch counters must
             show every Cholesky and every small backward went through the
             kernels, and each row of the kernel table's shape was launched.
  5. impute  hlax_torch.cli.impute over the test split with the trained
             model, encoder mode and GP mode: rows/s.
  6. eval    imputation-eval samples/s (bench.py's protocol: forward with
             the q(z) mean over the training set in 500-row chunks).
  7. profile steps/s of the canonical step, and device time by kernel.
The line before the card's line is the kernel table as JSON; the last
line is {"ok": true, "device": {...}}.  Imports nothing of JAX or of hlax.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "hlvae_config_file.txt")

# H100 SXM data sheet peaks (dense, no sparsity)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# H100 SXM boost clock: sizes the spin kernel that time_ms queues first
SPIN_CYCLES_PER_S = 1.98e9

# the small kernel's shapes (tests/test_torch_cuda.py): the training B
# blocks first (the kernel table's row), both compiled sizes of the register
# path and sizes padded to them, an odd n (scalar copies), the shared-memory
# path (n > 32), and batches that are not a multiple of the warps a block
SMALL_SHAPES = [((32, 20), 20), ((1001,), 20), ((64,), 4), ((64,), 8),
                ((64,), 16), ((1001,), 18), ((33,), 19), ((64,), 24),
                ((1001,), 32), ((64,), 40), ((1001,), 48)]
# the backward kernel's shapes: the training B blocks first (the table's
# row), then T = 16, where hlax launches its own, and the rest of its range;
# the first two are timed
BWD_SHAPES = [((32, 20), 20), ((32, 20), 16), ((3,), 48), ((65,), 8),
              ((1001,), 20), ((17,), 32), ((9,), 40), ((33,), 19)]
# the mid and backward kernels sum in another order than their plain
# versions, so both are held against float64 on the same float32 inputs:
# a kernel's error may be at most ERR_FACTOR times the plain version's plus
# ERR_ABS times the largest entry (a few float32 roundings of it)
ERR_FACTOR, ERR_ABS = 4.0, 1e-6
# the mid kernel's shapes: the training path's two, the eval buckets', the
# largest n it takes and one in the blocked path's low range; the first
# three are the main path's and get rows in the kernel table
MID_SHAPES = [((64,), 120), ((32,), 120), ((32, 256), 32), ((8,), 128),
              ((64,), 40)]
MID_MAIN = 3
# the train step launches the mid kernel twice (K0zz stacked with H, and the
# natural-gradient inverse), the small kernel and its backward once each
MID_PER_STEP = 2
EVAL_CHUNK = 500    # bench.py's imputation-eval chunk


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, reps: int = 50, warmup: int = 5):
    """(device ms, wall ms) a call.  Device: CUDA events around ``reps``
    calls queued behind a spin kernel that outlasts their enqueueing, so the
    host's cost per call is not in it.  Wall: the host clock around ``reps``
    calls and a synchronise, the cost a caller sees."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * reps * wall * 1e-3 * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, wall


def random_spd(batch, n, gen):
    x = torch.randn(batch + (n, n), generator=gen, device="cuda",
                    dtype=torch.float64)
    a = x @ x.mT / n + 0.5 * torch.eye(n, device="cuda", dtype=torch.float64)
    return a.float().contiguous()


def indefinite_spd(batch, n, gen):
    """Symmetric matrices whose logspace(0, -10) spectrum float32 rounding
    makes numerically indefinite: the pivot guard's regime."""
    q, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, device="cuda",
                                       dtype=torch.float64))
    ev = torch.logspace(0.0, -10.0, n, device="cuda", dtype=torch.float64)
    a = (q * ev) @ q.T
    return a.float().expand(batch + (n, n)).contiguous(), a


def ill_conditioned(batch, n, gen):
    """Symmetric matrices with a logspace(0, -6) spectrum: the canonical
    K0zz and H conditioning (>= 1e6), where the pivot guard does not fire."""
    q, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, device="cuda",
                                       dtype=torch.float64))
    ev = torch.logspace(0.0, -6.0, n, device="cuda", dtype=torch.float64)
    return ((q * ev) @ q.T).float().expand(batch + (n, n)).contiguous()


def phase_build() -> None:
    from hlax_torch.ops import cuda_build
    t0 = time.time()
    logs = cuda_build.build_all(["chol_inv_small", "chol_inv_mid",
                                 "chol_inv_bwd"])
    print(f"[build] nvcc sm_90a, 3 libraries in {time.time() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        kernel, spill = "?", ""
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                kernel = _kernel_name(m.group(1))
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                regs = re.search(r"Used (\d+) registers", line)
                print(f"[build] {name} {kernel}: "
                      f"{regs.group(1) if regs else line.strip()} "
                      f"registers; {spill}")


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel name with integer template
    arguments, e.g. _Z19chol_inv_bwd_kernelILi20EEv... ->
    chol_inv_bwd_kernel<20>."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    end = m.end() + int(m.group(1))
    name, rest = mangled[m.end():end], mangled[end:]
    if rest.startswith("I"):
        args = re.findall(r"Li(\d+)E", rest.split("EE")[0] + "E")
        name += f"<{','.join(args)}>"
    return name


def _bound_ms(batch: int, n: int):
    nbytes = 3 * batch * n * n * 4            # A read once, L and L^-1 written
    flops = batch * 2 * n ** 3 / 3            # potrf n^3/3 + trtri n^3/3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library(a):
    l = torch.linalg.cholesky(a)
    eye = torch.eye(a.shape[-1], device=a.device, dtype=a.dtype)
    return l, torch.linalg.solve_triangular(l, eye.expand_as(l), upper=False)


def phase_kernels():
    """Each kernel against its plain version; returns the table rows."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return [phase_small_kernel(gen), *phase_mid_kernel(gen),
            phase_bwd_kernel(gen)]


def _tag(name, batch, n):
    return f"{name} [{','.join(map(str, batch + (n, n)))}]"


def phase_small_kernel(gen):
    """The small kernel at SMALL_SHAPES, bit for bit against its plain
    version on SPD and float32-indefinite inputs, with exact zeros above the
    diagonal and residuals of a (nearby) factorization; timed at the
    training B blocks' shape.  Returns its table row."""
    from hlax_torch.ops import linalg_small as ls

    diff = 0.0   # the largest |kernel - plain version| over every check
    for batch, n in SMALL_SHAPES:
        tag = _tag("chol_inv_small_cuda", batch, n)
        plan = ls.small_launch_plan(n, int(np.prod(batch)), ls._sms(0))
        worst = []
        for kind in ("spd", "indefinite"):
            if kind == "spd":
                a = random_spd(batch, n, gen)
                a64 = a.double()
            else:
                a, a64 = indefinite_spd(batch, n, gen)
            l, il = ls.chol_inv_small_cuda(a)
            torch.cuda.synchronize()
            lp, ilp = ls._chol_inv_plain(a)
            if not (torch.isfinite(l).all() and torch.isfinite(il).all()):
                fail(f"{tag} {kind}: non-finite L or L^-1")
            dl = (l - lp).abs().max().item()
            dil = (il - ilp).abs().max().item()
            diff = max(diff, dl, dil)
            if not (torch.equal(l, lp) and torch.equal(il, ilp)):
                fail(f"{tag} {kind}: differs from the plain version by "
                     f"{dl:.3e} (L), {dil:.3e} (L^-1)")
            if torch.triu(l, 1).any() or torch.triu(il, 1).any():
                fail(f"{tag} {kind}: entries above the diagonal")
            l64, il64 = l.double(), il.double()
            eye = torch.eye(n, device="cuda", dtype=torch.float64)
            rec = ((l64 @ l64.mT - a64).norm(dim=(-2, -1))
                   / a64.norm(dim=(-2, -1))).max().item()
            inv = (il64 @ l64 - eye).abs().max().item()
            worst.append(f"{kind} |LL^T-A|/|A| {rec:.3e} |L^-1 L - I| "
                         f"{inv:.3e}")
            # residual bounds: float32 rounding for the SPD inputs; for the
            # indefinite one, the guard's modification (pivots below 1e-6
            # max diag A are floored), so |LL^T-A| stays ~1e-6
            if kind == "spd" and (rec > 1e-5 or inv > 1e-3):
                fail(f"{tag}: residuals too large: {worst[-1]}")
            if kind == "indefinite" and rec > 1e-4:
                fail(f"{tag} indefinite: |LL^T-A|/|A| = {rec:.3e}")
        print(f"[kernels] {tag}: {plan.path} path, np {plan.np}, "
              f"{plan.per_block} warps a block x {plan.grid} blocks; equal "
              f"to the plain version bit for bit; {'; '.join(worst)}",
              flush=True)
    batch, n = SMALL_SHAPES[0]
    tag = _tag("chol_inv_small_cuda", batch, n)
    a = random_spd(batch, n, gen)
    before = dict(ls.LAUNCHES)
    ms, wall = time_ms(lambda: ls.chol_inv_small_cuda(a))
    plain_ms, _ = time_ms(lambda: ls._chol_inv_plain(a), reps=10)
    lib_ms, _ = time_ms(lambda: _library(a))
    one = a[0, :1].contiguous()
    one_ms, _ = time_ms(lambda: ls.chol_inv_small_cuda(one))
    ls.LAUNCHES.update(before)
    bound, by = _bound_ms(a.numel() // (n * n), n)
    print(f"[kernels] {tag}: kernel {ms:.4f} ms ({wall:.4f} ms a call on the "
          f"host clock; one matrix alone {one_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {bound:.5f} ms "
          f"({by})", flush=True)
    return dict(name="chol_inv_small_cuda", shape=list(batch + (n, n)),
                route="cuda", source="hlax_torch/csrc/chol_inv_small.cu",
                replaces="hlax/ops/linalg_small.py:112", launches=0,
                max_abs_err=diff, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms)


def _f64_errors(a, l, il):
    """Max errors of L, raw L^-1 and refined L^-1 against float64
    torch.linalg on the same float32 input, and the largest entries."""
    from hlax_torch.ops import linalg_small as ls
    l64, il64 = _library(a.double())
    got = (l, il, ls._refine_tri_inverse(l, il))
    want = (l64, il64, il64)
    return ([(g.double() - w).abs().max().item() for g, w in zip(got, want)],
            [w.abs().max().item() for w in want])


def _inv_residual(l, il):
    """max |L^-1 L - I| in float64."""
    eye = torch.eye(l.shape[-1], device=l.device, dtype=torch.float64)
    return (il.double() @ l.double() - eye).abs().max().item()


def phase_mid_kernel(gen):
    """The mid kernel at MID_SHAPES against float64 (its blocked path sums
    in blocked order with fused multiply-adds): on SPD inputs, and the
    ill-conditioned one at M = 120, its L, raw L^-1 and refined L^-1 may
    each err at most ERR_FACTOR times the plain version's plus ERR_ABS
    times the largest entry, and its raw |L^-1 L - I| likewise; on the
    indefinite input it must be finite and factor a nearby matrix.  Exact
    zeros above the diagonal throughout; the warp path (n <= 32) equal to
    the plain version bit for bit.  Returns the table rows of the main
    path's shapes."""
    from hlax_torch.ops import linalg_small as ls

    rows = []
    for batch, n in MID_SHAPES:
        tag = _tag("chol_inv_mid_cuda", batch, n)
        kinds = ("spd", "ill", "indefinite") if n == 120 else \
            ("spd", "indefinite")
        worst = 0.0
        for kind in kinds:
            if kind == "spd":
                a = random_spd(batch, n, gen)
            elif kind == "ill":
                a = ill_conditioned(batch, n, gen)
            else:
                a, _ = indefinite_spd(batch, n, gen)
            l, il = ls.chol_inv_mid_cuda(a)
            torch.cuda.synchronize()
            if not (torch.isfinite(l).all() and torch.isfinite(il).all()):
                fail(f"{tag} {kind}: non-finite L or L^-1")
            if torch.triu(l, 1).any() or torch.triu(il, 1).any():
                fail(f"{tag} {kind}: entries above the diagonal")
            lp, ilp = ls._chol_inv_plain(a)
            if ls.mid_launch_plan(n, 1).path == "warp":
                # the warp path rounds as the plain version does
                if not (torch.equal(l, lp) and torch.equal(il, ilp)):
                    fail(f"{tag} {kind}: the warp path differs from the "
                         f"plain version by {(l - lp).abs().max().item():.3e}"
                         f" (L), {(il - ilp).abs().max().item():.3e} (L^-1)")
                print(f"[kernels] {tag} {kind}: equal to the plain version "
                      "bit for bit", flush=True)
            if kind == "indefinite":
                l64, a64 = l.double(), a.double()
                rec = ((l64 @ l64.mT - a64).norm(dim=(-2, -1))
                       / a64.norm(dim=(-2, -1))).max().item()
                print(f"[kernels] {tag} indefinite: |LL^T-A|/|A| {rec:.3e}",
                      flush=True)
                # the guard's modification: pivots below 1e-6 max diag A
                # are floored, so |LL^T-A| stays ~1e-6
                if rec > 1e-4:
                    fail(f"{tag} indefinite: |LL^T-A|/|A| = {rec:.3e}")
                continue
            errs, scales = _f64_errors(a, l, il)
            plain_errs, _ = _f64_errors(a, lp, ilp)
            res = [_inv_residual(l, il),
                   _inv_residual(l, ls._refine_tri_inverse(l, il))]
            res_p = [_inv_residual(lp, ilp),
                     _inv_residual(lp, ls._refine_tri_inverse(lp, ilp))]
            print(f"[kernels] {tag} {kind}: max|x-f64| kernel / plain: L "
                  f"{errs[0]:.3e} / {plain_errs[0]:.3e}, L^-1 {errs[1]:.3e} / "
                  f"{plain_errs[1]:.3e}, refined L^-1 {errs[2]:.3e} / "
                  f"{plain_errs[2]:.3e} (max|L| {scales[0]:.3e}, max|L^-1| "
                  f"{scales[1]:.3e}); |L^-1 L - I| kernel {res[0]:.3e} -> "
                  f"{res[1]:.3e} refined, plain {res_p[0]:.3e} -> "
                  f"{res_p[1]:.3e}", flush=True)
            for what, err, plain, scale in zip(
                    ("L", "L^-1", "refined L^-1"), errs, plain_errs, scales):
                if err > ERR_FACTOR * plain + ERR_ABS * scale:
                    fail(f"{tag} {kind}: {what} error {err:.3e} exceeds "
                         f"{ERR_FACTOR} x plain {plain:.3e} + {ERR_ABS} x "
                         f"{scale:.3e}")
            if res[0] > ERR_FACTOR * res_p[0] + ERR_ABS:
                fail(f"{tag} {kind}: |L^-1 L - I| {res[0]:.3e} exceeds "
                     f"{ERR_FACTOR} x plain {res_p[0]:.3e} + {ERR_ABS}")
            if kind == "spd":
                worst = max(worst, errs[0], errs[1])
        a = random_spd(batch, n, gen)
        before = dict(ls.LAUNCHES)
        ms, wall = time_ms(lambda: ls.chol_inv_mid_cuda(a))
        plain_ms, _ = time_ms(lambda: ls._chol_inv_plain(a), reps=10)
        lib_ms, _ = time_ms(lambda: _library(a))
        ls.LAUNCHES.update(before)
        b = a.numel() // (n * n)
        bound, by = _bound_ms(b, n)
        plan = ls.mid_launch_plan(n, b)
        print(f"[kernels] {tag}: {plan.path} path, kernel {ms:.4f} ms "
              f"({wall:.4f} ms a call on the host clock), plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{bound:.5f} ms ({by})", flush=True)
        if len(rows) < MID_MAIN:
            rows.append(dict(name="chol_inv_mid_cuda",
                             shape=list(batch + (n, n)), route="cuda",
                             source="hlax_torch/csrc/chol_inv_mid.cu",
                             replaces="hlax/ops/linalg_small.py:472",
                             launches=0, max_abs_err=worst, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             library_ms=lib_ms))
    return rows


def _bwd_bound_ms(batch: int, n: int):
    nbytes = 5 * batch * n * n * 4            # L, L^-1, both cotangents, A_bar
    flops = 10 * batch * n ** 3               # five n x n products
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_bwd_kernel(gen):
    """The backward kernel at BWD_SHAPES, on (L, L^-1) from the small kernel
    and three kinds of cotangents, against float64; timed at the first two
    shapes.  Returns its table row."""
    from hlax_torch.ops import linalg_small as ls

    worst, row = 0.0, None
    for s, (batch, n) in enumerate(BWD_SHAPES):
        tag = _tag("chol_inv_bwd_cuda", batch, n)
        b = int(np.prod(batch))
        plan = ls.bwd_launch_plan(n, b, ls._sms(0))
        l, il = ls.chol_inv_small_cuda(random_spd(batch, n, gen))
        for kind in ("random", "L^-1_bar = 0", "L_bar = 0"):
            lb = torch.randn(l.shape, generator=gen, device="cuda")
            ilb = torch.randn(l.shape, generator=gen, device="cuda")
            if kind == "L^-1_bar = 0":
                ilb.zero_()
            elif kind == "L_bar = 0":
                lb.zero_()
            got = ls.chol_inv_bwd_cuda(l, il, lb, ilb)
            torch.cuda.synchronize()
            plain = ls._chol_inv_bwd_plain(l, il, lb, ilb)
            want = ls._bwd_reference(l.double(), il.double(), lb.double(),
                                     ilb.double())
            if not torch.isfinite(got).all():
                fail(f"{tag} {kind}: non-finite A_bar")
            err = (got.double() - want).abs().max().item()
            err_plain = (plain.double() - want).abs().max().item()
            scale = want.abs().max().item()
            worst = max(worst, err)
            print(f"[kernels] {tag} {kind}: max|kernel-f64| {err:.3e}, "
                  f"max|plain-f64| {err_plain:.3e}, max|A_bar| {scale:.3e}",
                  flush=True)
            if err > ERR_FACTOR * err_plain + ERR_ABS * scale:
                fail(f"{tag} {kind}: kernel error {err:.3e} exceeds "
                     f"{ERR_FACTOR} x plain {err_plain:.3e} + {ERR_ABS} x "
                     f"{scale:.3e}")
            if torch.triu(got, 1).any():
                fail(f"{tag} {kind}: A_bar has entries above the diagonal")
        print(f"[kernels] {tag}: np {plan.np}, {plan.per_block} warps a "
              f"block x {plan.grid} blocks", flush=True)
        if s >= 2:
            continue
        lb = torch.randn(l.shape, generator=gen, device="cuda")
        ilb = torch.randn(l.shape, generator=gen, device="cuda")
        before = dict(ls.LAUNCHES)
        ms, wall = time_ms(lambda: ls.chol_inv_bwd_cuda(l, il, lb, ilb))
        plain_ms, _ = time_ms(lambda: ls._chol_inv_bwd_plain(l, il, lb, ilb))
        one = [t.reshape(-1, n, n)[:1].contiguous() for t in (l, il, lb, ilb)]
        one_ms, _ = time_ms(lambda: ls.chol_inv_bwd_cuda(*one))
        ls.LAUNCHES.update(before)
        bound, by = _bwd_bound_ms(b, n)
        print(f"[kernels] {tag}: kernel {ms:.4f} ms ({wall:.4f} ms a call on "
              f"the host clock; one matrix alone {one_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, library none, bound {bound:.5f} ms ({by})",
              flush=True)
        if s == 0:   # the table row: the training shape
            row = dict(name="chol_inv_bwd_cuda", shape=list(batch + (n, n)),
                       route="cuda", source="hlax_torch/csrc/chol_inv_bwd.cu",
                       replaces="hlax/ops/linalg_small.py:328", launches=0,
                       max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, library_ms=None)
    row["max_abs_err"] = worst
    return row


def write_canonical_data(dest: str) -> None:
    """Generated Health-MNIST D4 splits (200 subjects x 20 timepoints, 25%
    missing, seeds 100, 101, 102) under the canonical config's file names,
    by the port's generator CLI."""
    from hlax_torch.cli import generate as gen_cli
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        gen_cli.main(["--destination", dest, "--num_3", "100", "--num_6",
                      "100", "--missing", "25", "--datatype_config", "D4",
                      "--splits", "prediction,test,validation"])
    print(f"[slice] generated 3 splits of 4000 rows of D4 data in "
          f"{time.time() - t0:.1f} s", flush=True)


def phase_reference(tmp: str) -> None:
    """The same four train steps (toy widths: z=8, hidden 50, M=30 for the
    mid kernel, T=20 for the small one) from identical weights and noise on
    the card and with the plain versions on the CPU.  Both float32; the
    losses must agree to 1e-3 relative (the two devices sum in different
    orders, and the GP terms invert matrices of condition ~1e4)."""
    import copy

    from hlax_torch.config import ModelArgs
    from hlax_torch.data import dataset as ds
    from hlax_torch.data import generate as gen
    from hlax_torch.gp.kernels import build_kernel_specs
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.train import step as tstep

    d = os.path.join(tmp, "ref")
    gen.write_csvs(gen.generate(num_3=2, num_6=2, datatype_config="D4",
                                seed=7), d, "D4")
    data = ds.load_dataset(d, "data.csv", "labels.csv", "mask.csv",
                           "data_types_D4.csv")
    opt = ModelArgs().parse_options([f"--f={CONFIG}"])
    spec0, spec1 = build_kernel_specs(
        opt["cat_kernel"], opt["bin_kernel"], opt["sqexp_kernel"],
        opt["cat_int_kernel"], opt["bin_int_kernel"],
        opt["covariate_missing_val"], opt["id_covariate"])
    cfg = tstep.TrainConfig(latent_dim=8, M=30, P_tot=float(data.P),
                            N_tot=float(len(data)), id_covariate=2)
    model = HLVAE(HLVAEConfig(layout=data.layout, z_dim=8, h_dims=(50,)),
                  torch.Generator().manual_seed(0), "cpu")
    cpu = tstep.init_train_state(model, spec0, spec1,
                                 next(ds.subject_batches(data, 2)), cfg)
    to = lambda t: t.detach().to("cuda")
    gpu = tstep.TrainState(
        vae=copy.deepcopy(model).to("cuda"),
        k0=[{k: to(v) for k, v in p.items()} for p in cpu.k0],
        k1=[{k: to(v) for k, v in p.items()} for p in cpu.k1],
        raw_noise=to(cpu.raw_noise), zt=to(cpu.zt), m=to(cpu.m),
        H=to(cpu.H), optimizer=None, generator=torch.Generator("cuda"))
    gpu.optimizer = tstep.make_optimizer(gpu, cfg)
    noise = torch.Generator().manual_seed(1)
    worst = 0.0
    staged = {dev: ds.stage_dataset(data, torch.float32, dev)
              for dev in ("cpu", "cuda")}
    steps = {dev: tstep.make_train_step(st.vae, spec0, spec1, cfg)
             for dev, st in (("cpu", cpu), ("cuda", gpu))}
    from hlax_torch.ops import linalg_small as ls
    ls.reset_counters()
    for i, idx in enumerate([[0, 1], [2, 3], [3, 0], [1, 2]]):
        eps = torch.randn((2 * data.T_max, 8), generator=noise)
        losses = {}
        for dev, state in (("cpu", cpu), ("cuda", gpu)):
            batch = ds.gather_batch(staged[dev],
                                    torch.tensor(idx, device=dev))
            losses[dev] = steps[dev](state, batch, eps=eps.to(dev))[
                "loss"].item()
        rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        worst = max(worst, rel)
        print(f"[reference] step {i}: loss cuda {losses['cuda']:.6f} cpu "
              f"{losses['cpu']:.6f} rel {rel:.2e}", flush=True)
    if not worst <= 1e-3:
        fail(f"card and CPU disagree on the toy train steps: rel {worst:.2e}")
    print(f"[reference] launches on the card {dict(ls.LAUNCHES)}; plain "
          f"versions on CUDA tensors {dict(ls.PLAIN_CUDA_CALLS)}", flush=True)
    if ls.LAUNCHES["chol_inv_bwd_cuda"] < 4 or any(
            ls.PLAIN_CUDA_CALLS.values()):
        fail("the card's T=20 steps did not go through the backward kernel")
    if not any(name == "chol_inv_mid_cuda" and ls.mid_launch_plan(
            shape[-1], 1).path == "warp" for name, shape in
               ls.LAUNCHES_BY_SHAPE):
        fail("the card's M=30 steps did not take the mid kernel's warp path")


def phase_slice(tmp: str):
    from hlax_torch.cli import main as cli
    from hlax_torch.config import ModelArgs
    from hlax_torch.eval.validate import VALIDATION_ROWS
    from hlax_torch.ops import linalg_small as ls

    data_dir = os.path.join(tmp, "data")
    write_canonical_data(data_dir)
    save = os.path.join(tmp, "run")
    opt = ModelArgs().parse_options([f"--f={CONFIG}"])
    opt.update(data_source_path=data_dir, save_path=save, epochs=3,
               run_validation=True, run_tests=True, generate_images=False,
               device="cuda")
    ls.reset_counters()
    out = cli.run(opt)
    torch.cuda.synchronize()
    launches = dict(ls.LAUNCHES)
    by_shape = dict(ls.LAUNCHES_BY_SHAPE)
    plain = dict(ls.PLAIN_CUDA_CALLS)
    losses = out["loss_arrs"]["net"]
    steps = out["steps"]
    print(f"[slice] losses per epoch {losses}; launches {launches}; plain "
          f"versions on CUDA tensors {plain}", flush=True)
    if steps != 30:
        fail(f"expected 30 train steps, ran {steps}")
    if not all(map(np.isfinite, losses)):
        fail(f"non-finite loss {losses}")
    if launches["chol_inv_small_cuda"] < steps:
        fail(f"small Cholesky kernel launched fewer than {steps} times")
    if launches["chol_inv_bwd_cuda"] < steps:
        fail(f"backward kernel launched fewer than {steps} times")
    eval_mid = launches["chol_inv_mid_cuda"] - MID_PER_STEP * steps
    if eval_mid <= 0:
        fail("the mid Cholesky kernel was not launched in validation/tests")
    if any(plain.values()):
        fail("a plain Cholesky version ran on CUDA tensors on the main path")
    results = out["results_path"]
    with open(os.path.join(results, "validation_results.csv")) as f:
        rows = [line.rstrip("\n").split(",") for line in f]
    if [r[0] for r in rows] != list(VALIDATION_ROWS) or not all(
            np.isfinite(float(r[1])) for r in rows):
        fail(f"validation_results.csv is not 10 finite rows: {rows}")
    for path in (os.path.join(results, "result_error_final.csv"),
                 *(os.path.join(save, n) for n in (
                     "arguments.pkl", "plot_values.pkl", "diagnostics.pkl",
                     "final.pt"))):
        if not os.path.isfile(path):
            fail(f"{path} was not written")
    with open(os.path.join(results, "result_error_final.csv")) as f:
        print(f"[slice] validation rows {dict(rows)}; result_error_final "
              f"{f.read().split()}", flush=True)
    ep, ev = out["epoch_seconds"], out["eval_seconds"]
    print(f"[slice] mid launches: {MID_PER_STEP * steps} in training, "
          f"{eval_mid} in validation and tests; launches by shape "
          f"{ {f'{k}{list(sh)}': v for (k, sh), v in by_shape.items()} }",
          flush=True)
    print(f"[slice] epoch seconds {ep}; steps/s after warm-up "
          f"{10 / ep[-1]:.3f} on {card_line()}", flush=True)
    print(f"[slice] final validation {ev['validation']:.3f} s, tests "
          f"{ev['tests']:.3f} s on {card_line()}", flush=True)
    return by_shape, out, data_dir, save


def phase_impute(data_dir: str, save: str) -> None:
    """The imputation CLI over the test split, encoder and GP modes: fills
    exactly the cells the mask marks missing, leaves the observed ones."""
    from hlax_torch.cli import impute
    from hlax_torch.ops import linalg_small as ls

    raw = np.loadtxt(os.path.join(data_dir, "test_data_D4.csv"),
                     delimiter=",")
    mask = np.loadtxt(os.path.join(data_dir, "test_mask.csv"), delimiter=",")
    for mode, extra in (("encoder", []),
                        ("gp", ["--use_gp", "--label_csv",
                                os.path.join(data_dir, "test_label.csv")])):
        out_csv = os.path.join(save, f"imputed_{mode}.csv")
        ls.reset_counters()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            imp = impute.main([
                "--model_dir", save,
                "--data_csv", os.path.join(data_dir, "test_data_D4.csv"),
                "--mask_csv", os.path.join(data_dir, "test_mask.csv"),
                "--out_csv", out_csv, "--device", "cuda", *extra])
        seconds = time.perf_counter() - t0
        m = re.search(r"Imputed (\d+) missing cells", printed.getvalue())
        filled = int(m.group(1)) if m else -1
        if filled != int((mask == 0).sum()):
            fail(f"[impute] {mode}: filled {filled} cells, the mask has "
                 f"{int((mask == 0).sum())} missing")
        if imp.shape != raw.shape or not np.isfinite(imp).all():
            fail(f"[impute] {mode}: output not finite or of another shape")
        if not np.array_equal(imp[mask == 1], raw[mask == 1]):
            fail(f"[impute] {mode}: observed cells changed")
        if mode == "gp" and ls.LAUNCHES["chol_inv_mid_cuda"] == 0:
            fail("[impute] gp: the GP prediction launched no mid kernel")
        print(f"[impute] {mode}: {filled} cells filled over {len(raw)} rows, "
              f"{len(raw) / seconds:.1f} rows/s ({seconds:.3f} s, the whole "
              f"CLI call) on {card_line()}; launches {dict(ls.LAUNCHES)}",
              flush=True)


def phase_eval(out) -> None:
    """bench.py's imputation-eval protocol: forward with the q(z) mean over
    the training set in 500-row chunks (zero-padded), summed log_p_x, one
    sync a pass; one warm-up pass, then 10 timed."""
    from hlax_torch.eval.validate import device_het

    model, ds = out["model"], out["dataset"]
    data, mask, tmask = device_het(ds, torch.float32, "cuda")
    n = data.shape[0]
    pad = -n % EVAL_CHUNK
    chunks = [torch.nn.functional.pad(a, (0, 0, 0, pad)).split(EVAL_CHUNK)
              for a in (data, mask, tmask)]

    def one_pass():
        with torch.inference_mode():
            tot = torch.zeros((), device="cuda")
            for d, m, tm in zip(*chunks):
                tot = tot + model(d, m, tm, sample=False)["log_p_x"].sum()
            return tot.item()

    total = one_pass()
    if not np.isfinite(total):
        fail(f"[eval] non-finite summed log-likelihood {total}")
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        one_pass()
    dt = time.perf_counter() - t0
    print(f"[eval] imputation-eval {reps * n / dt:.1f} samples/s ({n} rows, "
          f"{-(-n // EVAL_CHUNK)} chunks of {EVAL_CHUNK}, {reps} passes, "
          f"sum log p(x) {total:.1f}) on {card_line()}", flush=True)


def phase_profile(out, n_steps: int = 10) -> None:
    """Steps/s of the canonical step over ``n_steps`` more steps, then a
    torch.profiler pass over 5 steps: device time by kernel, and the
    device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from hlax_torch.data.dataset import gather_batch

    state, staged, step = out["state"], out["staged"], out["train_step"]
    idx = torch.arange(20, device="cuda")
    step(state, gather_batch(staged, idx))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step(state, gather_batch(staged, idx))
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / n_steps
    print(f"[profile] {n_steps} steps: {per_step * 1e3:.3f} ms/step, "
          f"{1 / per_step:.3f} steps/s on {card_line()}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step(state, gather_batch(staged, idx))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        # device-side kernels only: user annotations (e.g. the optimizer's
        # step range) span kernels already counted
        if str(e.device_type).endswith("CUDA") and not getattr(
                e, "is_user_annotation", False):
            t = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + t
    busy = sum(by_name.values())
    if not busy:
        print("[profile] the profiler recorded no device time", flush=True)
        return
    print(f"[profile] 5 steps under the profiler: wall {wall_us / 5e3:.3f} "
          f"ms/step, device busy {busy / 5e3:.3f} ms/step, idle share "
          f"{1 - busy / wall_us:.3f}", flush=True)
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"[profile] {t / 5e3:8.4f} ms/step {t / busy:6.1%}  "
              f"{name[:90]}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this smoke run "
              "needs an NVIDIA GPU", flush=True)
        sys.exit(2)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    phase_build()
    rows = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        phase_reference(tmp)
        by_shape, out, data_dir, save = phase_slice(tmp)
        phase_impute(data_dir, save)
        phase_eval(out)
        phase_profile(out)
    for r in rows:
        r["launches"] = by_shape.get((r["name"], tuple(r["shape"])), 0)
        if not r["launches"]:
            fail(f"{r['name']} was not launched at {r['shape']} on the main "
                 "path")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
