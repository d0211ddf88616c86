"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels, holds
each against its plain PyTorch version in float32 and float64, trains the
canonical Heterogeneous Health-MNIST D4 config at full width for 30 steps
with validation, the test battery and the reconstruction images, then
imputes with the trained model; then the same config in float64 and with
the float64 natural-gradient chain, sequences of T = 200 and 500, the MLP
model, bfloat16 (--compute_dtype and --model_dtype) and the fused conv
stack; holds the train step's CUDA graphs against its eager steps; and
trains the canonical config for its full 300 epochs; then mesh training
(--data_parallel x --latent_parallel): a 2 x 2 mesh of gloo ranks on the
one card against the single process, and with more cards, NCCL meshes
through the CLI.  The single-card CLI runs ([slice], [f64], [mlp], [bf16],
[fused], [full]) train through ``make_train_epoch``'s CUDA graphs, the
CLI's path, and so do the NCCL meshes of [mesh4]; [mesh]'s gloo steps
run eagerly.

    python3 chip_smoke.py          # every phase, one card
    python3 chip_smoke.py mesh     # the build, [mesh] and [mesh4] only
    python3 chip_smoke.py fusion   # the build, [fusion], [graph], [parent]
    python3 chip_smoke.py precision   # the build, [precision] and its A/B
    python3 chip_smoke.py rate <tree> <data_dir> [ab | full [seed]]
                                   # [parent]'s and the A/B's own runs

The VAE's float32 precision comes from JAX_DEFAULT_MATMUL_PRECISION, as the
CLI's does (unset: "default", TF32 in the VAE, the GP in full float32).

Phases (each prints its own lines; any failure exits non-zero):
  1. build   nvcc builds hlax_torch/csrc/*.cu for sm_90a, in parallel, and
             prints each kernel's registers, stack frame and spill; a
             spill in the float64 blocked mid kernel or in the mid
             pullback's kernels (MID_BWD_INSTANCES), or a spill or a stack
             frame in any of the GP kernel matrix's instantiations
             (GP_INSTANCES), the staged kernels' (STAGED_INSTANCES: the
             cat and the real head's forward and backward, the
             representation's backward and the one-launch recon metric) or
             the natural-gradient kernels' (NATGRAD_INSTANCES), fails the
             run.
  2. kernels each kernel against its plain version, with the launch plan
             each shape took: the small kernel bit for bit at eleven shapes
             (both compiled sizes, padded and odd n, n up to 48) on random
             SPD and float32-indefinite inputs; the mid kernel against
             float64 at nine shapes (the long sequences' diagonal blocks
             among them) on SPD, ill-conditioned (M = 120) and indefinite
             inputs, its n <= 32 path also bit for bit; the backward kernel
             at eight shapes on random, L_bar = 0 and L^-1_bar = 0
             cotangents, against float64.  Then the float64 instantiations:
             the small kernel and the mid kernel's n <= 32 path bit for bit,
             the mid kernel's blocked path (its float64 kernel, with its
             plan: threads, shared memory) and the backward kernel within
             4x their plain versions' own error plus 1e-12.  The mid
             pullback (csrc/chol_inv_mid_bwd.cu: three launches a call) at
             MID_BWD_SHAPES in both dtypes on random and one-zero
             cotangents, float32 against float64 (4x the plain version's
             error), float64 within 1e-10 of the plain version's largest
             entry, one launch captured in a CUDA graph, each shape timed
             warm and L2-cold beside its bound and the plain chain.  With the
             kernel sources of an earlier commit unpacked under parent/
             (PARENT_CSRC), its mid kernel is built beside the current one
             and both are timed in turns (parent, change, change, parent),
             float32 results held equal bit for bit.  Device times (CUDA
             events, the launches queued ahead) of kernel, plain version,
             the library call where one exists (torch.linalg.cholesky +
             solve_triangular, in the kernel's dtype), the bound, the
             kernel's wall time a call on the host, and for the small and
             backward kernels the time of one matrix alone.
  3. reference  four toy-width train steps on the card against the same
             steps on the CPU (plain versions), same weights and noise, in
             float32 and in float64; the toy M = 30 takes the mid kernel's
             n <= 32 path, and the natural-gradient kernels launch on
             every card step.
  4. slice   generated D4 splits (prediction = training, test, validation;
             P=200, T=20, 25% missing) -> hlax_torch.cli.main.run with the
             canonical config file as it is (--generate_images=True), 3
             epochs of 10 steps on the card (through the CUDA graphs, as
             every CLI run here, with a torch.profiler trace of epoch 2 by
             --profile_dir) and a save interval at the third, then the
             final validation, the test battery and the reconstruction grid
             of the generation split; launch counters must show every
             Cholesky and every small backward went through the kernels,
             every fused kernel, the bound's and the natural-gradient
             chain's (K5-K8 at their canonical shapes) launched at least
             once a step with no plain version on the card, and each row
             of the kernel table's shape was launched.  Without
             matplotlib (the card's machine has none) the grid must be a
             finite [160, 1296] recon_complete.npz whose reconstruction is
             pixels in [0, 255], and training_curves.npz must hold every
             curve.
  5. impute  hlax_torch.cli.impute over the test split with the trained
             model, encoder mode and GP mode: rows/s; every CSV file read
             by the native parser (build/libfastcsv.so, g++ at first use),
             whose parse time beside the plain-Python one is printed.
  6. eval    imputation-eval samples/s (bench.py's protocol: forward with
             the q(z) mean over the training set in 500-row chunks) and a
             pass's device busy ms and kernels under the profiler.
  7. profile steps/s of the canonical step, eager, and device time by
             kernel (full names) and kernels and device ms a step by
             source region (hlax_torch/profiling.py's ranges: each kernel
             to the region whose host operation launched it, a backward
             kernel to the forward region it differentiates, a kernel
             launched outside any operation (the metric's ctypes launch)
             to the range that holds its launch call).
 7b. fusion  the fused step ops (hlax_torch/ops/fusion.py, csrc/fusion.cu:
             the heads and likelihoods, the encoder's representation, the
             recon metric, the GP kernel matrices K0xz, K0zz, K1_st, K0_st)
             at the canonical shapes in float32 and float64: results and
             gradients against their plain versions (float64 within 1e-10
             of the largest entry; float32 within 4x the plain version's
             own error against float64 plus 1e-6), each kernel timed alone
             by CUDA events beside the op's plain chain and its bound (the
             staged kernels and the mesh's finish also with the L2 cold,
             COLD_BYTES written between launches); first the staged
             kernels' machine code ([sass]: instructions, and their row
             loops' by opcode, by cuobjdump); each staged kernel swept
             over the first B rows of the batch and over the rows a chunk
             (a line through ms against bytes: the loop's rate and the
             launch's fixed cost; the real head's backward from one chunk,
             a cluster of one, to the portable cluster size, 8); the
             metric's mesh path (column sums, then
             the finish) at a [mesh] rank's 200 rows; the KL bound's four
             kernels (hlax_torch/ops/gp_bound.py, csrc/gp_bound.cu; with
             float32 inputs the terms' KziBK in double) on the
             canonical batch's subject blocks with a padded and an
             all-padding subject, with and without m's and H's gradients,
             d KziBK's product by cuBLAS and by the subject kernel (float64
             within 1e-10 of the largest entry or 4x the plain version's
             own movement under a one-ulp change of its inputs), each
             launch timed warm and L2-cold beside its bound and the plain
             chain, and the two products' times; the MLP's heads (with
             and without the logvar network) and metric, and the heads and
             the representation at a [mesh] rank's rows, held to their
             plain versions too; the natural-gradient kernels K5-K8
             (hlax_torch/ops/natgrad.py, csrc/natgrad.cu) on a synthetic
             state at the canonical batch in float32, float64 and float32
             data with the float64 chain (--nat_grad_f64) and at a mesh
             rank's in float32 (NATGRAD_CASES), each against its
             plain version at the same bars, with and without K7's
             jitter, K8's H_new exactly symmetric, each launch timed warm
             and L2-cold beside its bound and its plain version (the
             canonical shape's rows in the kernel table), K8 also beside
             torch.bmm(iLA.mT, iLA) (its library_ms) and in its two
             launch layouts (a cluster of blocks a latent, one block a
             latent) in turns; with parent/, its natgrad.cu built into
             build/parent/natgrad/ and its K5-K8 (K7 also with jitter),
             through its own wrapper, against the change's at the
             canonical batch in float32 and float64 in turns (the output
             entries that differ from the parent's counted); the bound's
             subject kernels swept over
             the subjects a launch takes (ms against 20..640 subjects at
             [32, 20, 20, 120] and 4..128 at [32, 4, 200, 120], float32
             and float64: the launch's fixed part and a subject's cost);
             with the parent tree under parent/, its gp_bound.cu built
             into build/parent/gp_bound/ and its subject kernels, through
             its own wrapper, against the change's at the card tests'
             bound shapes and T = 500 in both dtypes (every result compared
             bit for bit; each launch timed warm and L2-cold in turns
             parent, change, change, parent); its fusion.cu built into
             build/parent/ (its GP kernels' registers, stack frame and
             spill printed) and its GP ops, on its own wrapper, held to
             the same bars and timed against the current ones in turns
             (parent, change, change, parent; a backward with the G + G^T
             and counters' memset where the parent's wrapper launches them
             besides its kernels), and the GP kernels' device ms of one
             canonical step of both; the same turns, warm and L2-cold, for
             the staged kernels: the cat and the real head's forward (their
             results also compared with the parent's bit for bit) and
             backward, the representation's backward and the metric (a
             parent's
             column sums a group and its finish against one launch); with
             or without it, the canonical specs' compiled GP shapes against
             the table kernel (gp_compiled_shapes) the same way, in turns
             shapes, table, table, shapes; then --use_pallas_chol=False on
             the graph path: float64 graph steps against eager steps, a
             canonical float32 epoch, no Cholesky kernel launched.
  8. f64     the canonical config with --gp_dtype=float64
             --model_dtype=float64, and in float32 with --nat_grad_f64=True,
             20 steps each and the final validation with
             --eval_gp_f64=True: launches by kernel, shape and dtype, no
             plain version on the card; each run's graph path steps/s and
             its device time by kernel and idle share under the profiler.
  9. longT   sequences of T = 200 (40 subjects, 4 a batch) and T = 500 (20,
             2 a batch) on synthetic D4-shaped data, L = 32, M = 120, conv,
             float32: 5 steps after a warm-up one, then the DUBO and the
             predictor over the n = 256 and 512 buckets, all through the
             blocked composition on the mid kernel; the bound's subject
             kernels' launches a step, the kernels held to the plain
             version and timed on each T's first batch; at T = 200 graph
             steps against eager steps (float64, [graph]'s bound) and both
             steps/s.
 10. mlp     the canonical data with --conv_hivae=False (hidden [500],
             y_dim 5): 3 epochs through the fused heads and metric, no
             plain version on the card, the final validation, the test
             battery, imputation in encoder and GP mode; graph steps
             against eager steps (float64, [graph]'s bound) and both
             steps/s.
 11. graph   from two canonical states made from one seed, 10 eager steps
             and 10 steps through make_train_epoch's CUDA graphs on the same
             batches, in float64 and float32, with the noise injected
             (1 step a graph) and drawn from the generator (3 steps a graph
             and the remainder's), both with cuDNN's deterministic
             algorithms (beside them, the spread of two eager runs with its
             default ones): loss trajectory, m, H and the VAE's
             parameters within 1e-10 (float64) and 1e-5 (float32), equal
             launch counts, equal generator states; a checkpoint of the
             graph state restored into a third state takes the same next 10
             steps.  Then steps/s of the eager path and the graph path
             (--scan_unroll 1 and 10, and 10 pregathered) in alternating
             rounds, the float32 graph step with K8's plain version
             (cuBLAS's product) captured in K8's place in turns with K8's
             (a switch of this script, not of the program), and the graph
             path's device time and idle share under
             torch.profiler, by region as the eager steps' profile splits
             each kernel name; the eager profile prints each fused
             kernel's device ms and launches a step (FUSED_FOCUS) and every
             kernel of the GP's regions (gp_bound, its backward, the
             bound's natural-gradient quantities and the natural-gradient
             update) with its launches and device ms a step, grouped as
             GP matrices, Cholesky kernels, the bound's kernels, the
             natural-gradient kernels, cuBLAS's products and the rest
             (gp_attribution).
 11a. precision  hlax's split on the canonical float32 step: each
             convolution's and matmul's kernels by layer (operation and
             input shapes) and region in an eager step, marked TF32 where
             the name says so, then the graph replay's kernels by region
             with and without the mark; fails on a TF32 kernel in a GP
             region, or on none in a VAE region under a TF32 precision.
             With ``precision``: "highest" against "default" in processes
             in turns (highest, default, default, highest), graph steps/s,
             device busy ms, kernels, idle share and ms by region of the
             canonical step, --nat_grad_f64, the MLP and --fused_conv, the
             imputation eval; then [full] for seeds 0, 1, 2 in each arm,
             the final training and validation net losses against the
             quality gate (the TF32 mean within the larger of 1 % and the
             float32 arm's range of the float32 mean).
 11b. parent with an earlier commit's tree unpacked under parent/
             (git-ignored), both trees' canonical graph steps (float32,
             float64, --nat_grad_f64) in processes of their own, in turns
             parent, change, change, parent: steps/s, device ms and kernels
             a step, idle share, and the kernels and device ms a step of
             each GP region (GP_REGIONS), by kernel group in each
             configuration.
 12. full    the canonical config's 300 epochs through the CLI on the graph
             path (--epochs_per_dispatch=5 --scan_unroll=10), validation
             every 5 epochs, the test battery: the final net loss, the last
             point of the validation curve, the run's seconds.
 13. bf16 / fused (through the CLI)  the canonical config in float32 (2
             epochs), with --compute_dtype=bfloat16 (3 epochs, the final
             validation and the test battery), --model_dtype=bfloat16 (2
             epochs) and --fused_conv=True (3 epochs): finite losses, all
             three kernels launched on each path (the GP in float32), then
             every run's graph path steps/s in alternating rounds and its
             device time under the profiler.
 14. fused   (directly) the fused conv stack against cuDNN's at the
             canonical shapes (400 rows, 36x36, float32, full float32):
             outputs within 1e-4 and gradients within 1e-3 of their norm
             (under TF32 printed, not held), and the VAE forward + backward
             time of each in both precisions.
 15. mesh    the three kernels at the 2 x 2 mesh's local shapes ([16,10,20,20]
             small and backward, [16,120,120] mid; timed, in the kernel
             table); 4 gloo ranks (2 data x 2 latent) sharing the card, the
             canonical state from one seed, 10 eager steps against the
             single process's on the same global batches and noise (cuDNN's
             deterministic algorithms on both): in float64 losses within
             1e-4, GP state and VAE parameters within 1e-3; in float32 (ill-
             conditioned: see MESH_BOUND) the first loss within 5e-2; every
             rank launching all three kernels and the fused ops' forward
             kernels (the metric's through the mesh's sums) at its local
             shapes, no plain version; then
             dryrun_multichip(4) (4 CPU processes over gloo on one card).
 16. mesh4   with two cards or more, one rank a card over NCCL through the
             CLI on the graph path (the collectives captured in the CUDA
             graphs): 2 x 2 and 4 x 1 (2 x 1 and 1 x 2 on two or three
             cards), in float32 and float64, 3 epochs, the final validation
             and tests, each run bounded by MESH_CLI_LIMIT; each epoch's
             loss against the single process on one card over the same
             global batches (float64 at [mesh]'s bounds, with final.pt's
             state; float32 at its first-loss rule), every rank's launches
             at its local shapes and no plain version (the 4 x 1 rank's
             [32,5,20,20] small and
             backward kernels get rows in the kernel table), final.pt
             restored in one process and read by the imputation CLI, rank
             0's NCCL share of its device time under the profiler; then
             steps/s of the graph mesh, the eager mesh and one card (graph
             and eager) in 3 alternating rounds, at 20 and at 200 subjects
             a step.  With one card it prints that it did not run.
Phase 7b runs after [profile]; 13 and 14 after [mlp], before [graph]; 11a
and 11b after [graph]; 15 and 16 after [full].  A [time] line after each
phase gives its seconds.  A comparison with parent/ does not run for a
kernel source (and its wrapper) that parent/ holds byte for byte as this
tree does (``parent_same``): it would time one build against itself.
Every main path (slice, f64, longT, mlp, bf16, fused, full, and each rank
of mesh and mesh4) runs with the launch counters set to 0 just before it
and read just after, and each requires the natural-gradient kernels K5-K8
launched on every step at its shapes (``natgrad_need``).  The line
before the card's line is the kernel table as JSON, one row a kernel, shape
and dtype; the last line is {"ok": true, "device": {...}}.  Imports nothing of JAX or of hlax.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "hlvae_config_file.txt")
# the canonical D4 layout's expanded columns: 324 real variables and 972
# cat(5) ones (``hlax_torch.data.generate.quantized_regions("D4")``)
CANONICAL_N_EXP = 324 + 5 * 972

# H100 SXM data sheet peaks (dense, no sparsity; float32 outside the
# tensor cores, float64 on them: the GP runs no TF32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
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
              ((64,), 40), ((32, 4), 100), ((32, 2), 125), ((32, 64), 128),
              ((32, 32), 128)]
# the shapes that get rows in the kernel table: the canonical training and
# eval shapes, and the long sequences' diagonal blocks (T = 200 and T = 500
# in training; the 256 and 512 eval buckets of their 40 and 20 subjects)
LONG_T_MID_ROWS = {((32, 4), 100), ((32, 2), 125), ((32, 64), 128),
                   ((32, 32), 128)}
MID_ROWS = {((64,), 120), ((32,), 120), ((32, 256), 32)} | LONG_T_MID_ROWS
# float64: the small kernel's shapes (the B blocks first), the mid
# kernel's (the training shapes and the eval buckets first; then the
# blocked path's ends, n = 33 and 128, an odd n at either end of its
# largest shared-memory size, a single matrix and an odd batch), the
# backward's; every first shape of a list, and the mid kernel's first
# three, get rows in the kernel table
F64_SMALL_SHAPES = [((32, 20), 20), ((1001,), 20), ((33,), 19),
                    ((1001,), 32), ((64,), 40)]
F64_MID_SHAPES = [((64,), 120), ((32,), 120), ((32, 256), 32), ((8,), 128),
                  ((64,), 40), ((5,), 113), ((1,), 33), ((1,), 120),
                  ((3,), 127), ((65,), 120)]
F64_MID_MAIN = 3
F64_BWD_SHAPES = [((32, 20), 20), ((3,), 48), ((33,), 19), ((17,), 32)]
# the float64 blocked path and backward are held to their plain versions:
# at most F64_FACTOR times the plain version's own error plus F64_ABS
F64_FACTOR, F64_ABS = 4.0, 1e-12
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


# bytes written between the launches of an L2-cold time: more than the
# H100's 50 MB L2
COLD_BYTES = 64 << 20


def time_cold_ms(fn, reps: int = 20) -> float:
    """Device ms a call of ``fn`` with the L2 cold: COLD_BYTES written
    before each call, outside its pair of CUDA events; the calls and their
    writes queued behind a spin kernel that outlasts their enqueueing, so
    no event waits on the host."""
    flush = torch.empty(COLD_BYTES // 4, dtype=torch.float32, device="cuda")
    rounds = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for _ in range(3):
        flush.fill_(1.0)
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        flush.fill_(1.0)
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3
    torch.cuda._sleep(int(2 * reps * wall * SPIN_CYCLES_PER_S))
    for start, end in rounds:
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in rounds) / reps


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


# the fused step ops' kernels (hlax_torch.ops.fusion): each is launched at
# least once a canonical train step on one process (the metric's finish
# runs inside its one launch there; a mesh launches recon_metric_finish
# after its ranks' sums, [mesh])
FUSED_KERNELS = ("heads_cat_fwd_cuda", "heads_cat_bwd_cuda",
                 "heads_real_fwd_cuda", "heads_real_bwd_cuda",
                 "rep_image_fwd_cuda", "rep_image_bwd_cuda",
                 "recon_metric_cuda", "gp_kernel_fwd_cuda",
                 "gp_kernel_bwd_cuda")
# the KL bound's kernels (csrc/gp_bound.cu), each launched once a step
GP_BOUND_KERNELS = ("gp_bound_fwd_subjects", "gp_bound_fwd_latents",
                    "gp_bound_bwd_latents", "gp_bound_bwd_subjects")
# the natural-gradient chain's kernels (csrc/natgrad.cu), each launched once
# a step: K5 and K6 in the bound, K7 and K8 in the update
NATGRAD_KERNELS = ("natgrad_fwd_subjects", "natgrad_fwd_latents",
                   "natgrad_update_pre", "natgrad_update_finish")
# every kernel library, one nvcc each, all started together
LIBRARIES = ("chol_inv_small", "chol_inv_mid", "chol_inv_bwd",
             "chol_inv_mid_bwd", "fusion", "gp_bound", "natgrad")
# every instantiation of the GP kernel matrix's kernels (csrc/fusion.cu):
# by scalar, vector width (the flat kernels), rbf factors a component may
# have (the backwards) and compiled shape (0 any spec, 1 and 2 the
# canonical spec0 and spec1, at the vector width)
_GP_VEC = (("float", 4), ("double", 2))
GP_INSTANCES = tuple(
    [f"gp_fwd_kernel<{t},{v},{sh}>" for t, v in _GP_VEC for sh in (0, 1, 2)]
    + [f"gp_fwd_kernel<{t},1,0>" for t, _ in _GP_VEC]
    + [f"gp_bwd_flat_kernel<{t},{v},1,{sh}>" for t, v in _GP_VEC
       for sh in (1, 2)]
    + [f"gp_bwd_flat_kernel<{t},{v},{nr},0>" for t, v in _GP_VEC
       for v in (v, 1) for nr in (1, 4)]
    + [f"gp_bwd_cols_kernel<{t},1,{sh}>" for t, _ in _GP_VEC
       for sh in (0, 1, 2)]
    + [f"gp_bwd_cols_kernel<{t},4,0>" for t, _ in _GP_VEC])
# the staged kernels' instantiations (csrc/fusion.cu): the cat head's and
# the real head's forward and backward (the real head with and without the
# logvar network), the representation's backward and the one-launch metric
# at the compiled sizes
STAGED_INSTANCES = tuple(
    [f"heads_cat_{d}_kernel<{t},5,5>" for d in ("fwd", "bwd")
     for t in ("float", "double")]
    + [f"heads_real_{d}_kernel<{t},5,{lv}>" for d in ("fwd", "bwd")
       for t in ("float", "double") for lv in ("false", "true")]
    + [f"{k}<{t},5>" for k in ("rep_image_bwd_kernel", "recon_metric_kernel")
       for t in ("float", "double")])
# the KL bound's subject kernels (csrc/gp_bound.cu), float and double: K1
# and K3 staged and their row-tile kernels
SUBJECT_INSTANCES = tuple(f"gp_bound_{d}_{k}_kernel<{t}>"
                          for k in ("subjects", "tiles")
                          for d in ("fwd", "bwd") for t in ("float", "double"))
LATENT_INSTANCES = tuple(f"gp_bound_{d}_latents_kernel<{t}>"
                         for d in ("fwd", "bwd") for t in ("float", "double"))
# the natural-gradient kernels' instantiations: K5 on (inputs, ng_P1), K6-K8
# on (the chain, the state), each pair of one dtype or the mixed one
NATGRAD_INSTANCES = tuple(
    [f"natgrad_fwd_subjects_kernel<{a},{b}>" for a, b in (
        ("float", "float"), ("double", "double"), ("float", "double"))]
    + [f"{k}_kernel<{a},{b}>" for k in NATGRAD_KERNELS[1:] for a, b in (
        ("float", "float"), ("double", "double"), ("double", "float"))])
# the mid pullback's three kernels in float and double
MID_BWD_INSTANCES = tuple(f"chol_inv_mid_bwd_{k}_kernel<{t}>"
                          for k in ("fold", "project", "sym")
                          for t in ("float", "double"))
# the kernels that must not spill, by library, and whether a stack frame
# fails them too: the float64 blocked mid kernel, the mid pullback's
# kernels, every GP kernel, the staged kernels, the bound's subject and
# latent kernels, the natural-gradient kernels
NO_SPILL = ([("chol_inv_mid", "chol_inv_mid_blocked64_kernel", False)]
            + [("chol_inv_mid_bwd", k, False) for k in MID_BWD_INSTANCES]
            + [("fusion", k, True) for k in GP_INSTANCES + STAGED_INSTANCES]
            + [("gp_bound", k, True) for k in SUBJECT_INSTANCES
               + LATENT_INSTANCES]
            + [("natgrad", k, True) for k in NATGRAD_INSTANCES])


def _ptxas_report(tag: str, name: str, log: str, only: str = "") -> dict:
    """Prints each kernel's registers, stack frame and spill from a
    ``ptxas -v`` log (the kernels whose name starts with ``only``);
    returns {kernel: (stack frame bytes, spilled bytes, stores and
    loads)}."""
    kernel, spill, spilled = "?", "", {}
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            kernel = _kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
            stack = re.search(r"(\d+) bytes stack frame", line)
            spilled[kernel] = (int(stack.group(1)) if stack else 0,
                               sum(map(int, re.findall(
                                   r"(\d+) bytes spill", line))))
        elif "registers" in line and kernel.startswith(only):
            regs = re.search(r"Used (\d+) registers", line)
            print(f"[{tag}] {name} {kernel}: "
                  f"{regs.group(1) if regs else line.strip()} "
                  f"registers; {spill}")
    return spilled


def phase_build() -> None:
    from hlax_torch.ops import cuda_build
    t0 = time.time()
    logs = cuda_build.build_all(LIBRARIES)
    print(f"[build] nvcc sm_90a, {len(LIBRARIES)} libraries in "
          f"{time.time() - t0:.1f} s", flush=True)
    reports = {name: _ptxas_report("build", name, log)
               for name, log in logs.items()}
    for lib in sorted({lib for lib, *_ in NO_SPILL} - set(reports)):
        print(f"[build] lib{lib}.so was up to date: its kernels' spill was "
              "checked when it was built", flush=True)
    for lib, kernel, no_stack in NO_SPILL:
        if lib not in reports:
            continue
        if kernel not in reports[lib]:
            fail(f"[build] no ptxas report of {kernel}")
        stack, spill = reports[lib][kernel]
        if spill or (no_stack and stack):
            fail(f"[build] {kernel}: {stack} bytes stack frame, {spill} "
                 "bytes spill (stores and loads)")
    print(f"[build] no spill in {len(NO_SPILL)} kernels, no stack frame in "
          f"the {len(GP_INSTANCES)} GP kernels, the "
          f"{len(STAGED_INSTANCES)} staged kernels, the "
          f"{len(SUBJECT_INSTANCES + LATENT_INSTANCES)} bound's subject and "
          f"latent kernels and the {len(NATGRAD_INSTANCES)} natural-gradient "
          "kernels", flush=True)


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel name, in a namespace or not, with
    float, double, integer and bool template arguments, e.g.
    _Z19chol_inv_bwd_kernelIdLi20EEv... -> chol_inv_bwd_kernel<double,20>,
    _ZN12_GLOBAL__N_113gp_fwd_kernelIfLi4EEEv... -> gp_fwd_kernel<float,4>."""
    m = re.match(r"_Z(N?)", mangled)
    pos, name = (m.end(), None) if m else (0, None)
    while m:    # a nested name's parts: the last is the kernel's
        part = re.match(r"\d+", mangled[pos:])
        if not part:
            break
        end = pos + part.end() + int(part.group(0))
        name, pos = mangled[pos + part.end():end], end
        if not m.group(1):
            break
    if name is None:
        return mangled
    rest = mangled[pos:]
    if rest.startswith("I"):
        args = []
        for tok in re.finditer(r"Li(\d+)E|Lb([01])E|f|d|(E)", rest[1:]):
            if tok.group(3):   # the E that closes the argument list
                break
            args.append(tok.group(1) or {"0": "false", "1": "true"}.get(
                tok.group(2)) or {"f": "float", "d": "double"}[tok.group(0)])
        name += f"<{','.join(args)}>"
    return name


def _bound_ms(batch: int, n: int, dtype=torch.float32):
    size = torch.finfo(dtype).bits // 8
    nbytes = 3 * batch * n * n * size         # A read once, L and L^-1 written
    flops = batch * 2 * n ** 3 / 3            # potrf n^3/3 + trtri n^3/3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library(a):
    l = torch.linalg.cholesky(a)
    eye = torch.eye(a.shape[-1], device=a.device, dtype=a.dtype)
    return l, torch.linalg.solve_triangular(l, eye.expand_as(l), upper=False)


def phase_kernels():
    """Each kernel against its plain version, float32 then float64; returns
    the table rows."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [phase_small_kernel(gen), *phase_mid_kernel(gen),
            phase_bwd_kernel(gen), phase_small_kernel_f64(gen),
            *phase_mid_kernel_f64(gen), phase_bwd_kernel_f64(gen),
            *phase_mid_bwd_kernel(gen)]
    phase_mid_parent(gen)
    return rows


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
                dtype="float32", route="cuda",
                source="hlax_torch/csrc/chol_inv_small.cu",
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
        if (batch, n) in MID_ROWS:
            rows.append(dict(name="chol_inv_mid_cuda",
                             shape=list(batch + (n, n)), dtype="float32",
                             route="cuda",
                             source="hlax_torch/csrc/chol_inv_mid.cu",
                             replaces="hlax/ops/linalg_small.py:472",
                             launches=0, max_abs_err=worst, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             library_ms=lib_ms))
    return rows


def _bwd_flops(n: int) -> int:
    """Flops of ``_bwd_reference`` on one n x n matrix, counting only the
    products' terms that triangular L and L^-1 leave nonzero: S's lower
    triangle, the tril fold, P's lower triangle, Y = P L^-1 (lower) and all
    of X = L^-T Y, each multiply-add 2."""
    tri = n * (n + 1) * (n + 2) // 6          # each of the four triangles
    x = n * (n + 1) * (2 * n + 1) // 6        # X[i, j]: n - max(i, j) terms
    return 2 * (4 * tri + x)


def _bwd_bound_ms(batch: int, n: int, dtype=torch.float32):
    size = torch.finfo(dtype).bits // 8
    nbytes = 5 * batch * n * n * size         # L, L^-1, both cotangents, A_bar
    flops = batch * _bwd_flops(n)             # about 2 n^3 a matrix
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
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
                       dtype="float32", route="cuda",
                       source="hlax_torch/csrc/chol_inv_bwd.cu",
                       replaces="hlax/ops/linalg_small.py:328", launches=0,
                       max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, library_ms=None)
    row["max_abs_err"] = worst
    return row


def _residuals(a, l, il):
    """(max over the batch of |LL^T - A| / |A| in Frobenius norm,
    max |L^-1 L - I|), in the inputs' dtype."""
    eye = torch.eye(a.shape[-1], device=a.device, dtype=a.dtype)
    rec = ((l @ l.mT - a).norm(dim=(-2, -1)) / a.norm(dim=(-2, -1))).max()
    return rec.item(), (il @ l - eye).abs().max().item()


def _time_row(name, source, replaces, batch, n, dtype, fn, plain, library,
              err, bound):
    """Device times of the kernel call ``fn``, its plain version and the
    library call, and the table row; the launches the timing makes are not
    counted."""
    from hlax_torch.ops import linalg_small as ls
    before = dict(ls.LAUNCHES), dict(ls.LAUNCHES_BY_SHAPE)
    ms, wall = time_ms(fn)
    plain_ms, _ = time_ms(plain, reps=10)
    lib_ms = time_ms(library)[0] if library is not None else None
    ls.LAUNCHES.update(before[0])
    ls.LAUNCHES_BY_SHAPE.clear()
    ls.LAUNCHES_BY_SHAPE.update(before[1])
    t_bound, by = bound
    print(f"[kernels] {_tag(name, batch, n)} {dtype}: kernel {ms:.4f} ms "
          f"({wall:.4f} ms a call on the host clock), plain {plain_ms:.4f} "
          f"ms, library "
          f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
          f"{t_bound:.5f} ms ({by})", flush=True)
    return dict(name=name, shape=list(batch + (n, n)),
                dtype=str(dtype).removeprefix("torch."), route="cuda",
                source=source, replaces=replaces, launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t_bound,
                bound_by=by, library_ms=lib_ms)


# the spectrum of the float64 guard inputs, logspace(0, -F64_GUARD_DECADES):
# float64 rounding makes it indefinite, so trailing pivots fall below the
# float64 floor of 2e-15 max diag A
F64_GUARD_DECADES = 20.0


def guard_f64(batch, n, gen):
    q, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, device="cuda",
                                       dtype=torch.float64))
    ev = torch.logspace(0.0, -F64_GUARD_DECADES, n, device="cuda",
                        dtype=torch.float64)
    a = (q * ev) @ q.T
    return (0.5 * (a + a.T)).expand(batch + (n, n)).contiguous()


def phase_small_kernel_f64(gen):
    """The float64 small kernel at F64_SMALL_SHAPES, bit for bit against its
    plain version on SPD inputs and on guard inputs (``guard_f64``), whose
    trailing pivots fall below the float64 floor; timed at the training B
    blocks' shape.  Returns its table row."""
    from hlax_torch.ops import linalg_small as ls

    f64 = torch.float64
    for batch, n in F64_SMALL_SHAPES:
        tag = _tag("chol_inv_small_cuda", batch, n)
        plan = ls.small_launch_plan(n, int(np.prod(batch)), ls._sms(0), 8)
        for kind in ("spd", "guard"):
            a = (random_spd(batch, n, gen).double() if kind == "spd"
                 else guard_f64(batch, n, gen))
            l, il = ls.chol_inv_small_cuda(a)
            torch.cuda.synchronize()
            lp, ilp = ls._chol_inv_plain(a)
            if not (torch.isfinite(l).all() and torch.isfinite(il).all()):
                fail(f"{tag} float64 {kind}: non-finite L or L^-1")
            if not (torch.equal(l, lp) and torch.equal(il, ilp)):
                fail(f"{tag} float64 {kind}: differs from the plain version "
                     f"by {(l - lp).abs().max().item():.3e} (L), "
                     f"{(il - ilp).abs().max().item():.3e} (L^-1)")
            if torch.triu(l, 1).any() or torch.triu(il, 1).any():
                fail(f"{tag} float64 {kind}: entries above the diagonal")
        print(f"[kernels] {tag} float64: {plan.path} path, np {plan.np}, "
              f"{plan.per_block} warps a block x {plan.grid} blocks; equal "
              f"to the plain version bit for bit (SPD and guard inputs); "
              f"|LL^T-A|/|A|, |L^-1 L - I| {_residuals(a, l, il)}",
              flush=True)
    batch, n = F64_SMALL_SHAPES[0]
    a = random_spd(batch, n, gen).double()
    return _time_row("chol_inv_small_cuda",
                     "hlax_torch/csrc/chol_inv_small.cu",
                     "hlax/ops/linalg_small.py:112", batch, n, f64,
                     lambda: ls.chol_inv_small_cuda(a),
                     lambda: ls._chol_inv_plain(a), lambda: _library(a), 0.0,
                     _bound_ms(a.numel() // (n * n), n, f64))


def phase_mid_kernel_f64(gen):
    """The float64 mid kernel at F64_MID_SHAPES on SPD, ill-conditioned
    (logspace(0, -6)) and guard (``guard_f64``) inputs: the n <= 32 path
    bit for bit; the blocked path's residuals |LL^T - A| / |A| and
    |L^-1 L - I| at most F64_FACTOR times the plain version's plus F64_ABS
    (SPD and ill-conditioned), finite and factoring a nearby matrix on the
    guard input; exact zeros above the diagonal.  Returns the table rows of
    the first F64_MID_MAIN shapes."""
    from hlax_torch.ops import linalg_small as ls

    f64 = torch.float64
    rows = []
    for s, (batch, n) in enumerate(F64_MID_SHAPES):
        tag = _tag("chol_inv_mid_cuda", batch, n)
        plan = ls.mid_launch_plan(n, int(np.prod(batch)), 8)
        print(f"[kernels] {tag} float64 plan: {plan.path} path, "
              f"{plan.grid} blocks of {plan.threads} threads, "
              f"{plan.smem} bytes of shared memory a block, no cluster",
              flush=True)
        worst = 0.0
        for kind in ("spd", "ill", "guard"):
            if kind == "spd":
                a = random_spd(batch, n, gen).double()
            elif kind == "guard":
                a = guard_f64(batch, n, gen)
            else:
                q, _ = torch.linalg.qr(torch.randn(
                    (n, n), generator=gen, device="cuda", dtype=f64))
                ev = torch.logspace(0.0, -6.0, n, device="cuda", dtype=f64)
                a = (q * ev) @ q.T
                a = (0.5 * (a + a.T)).expand(batch + (n, n)).contiguous()
            l, il = ls.chol_inv_mid_cuda(a)
            torch.cuda.synchronize()
            if not (torch.isfinite(l).all() and torch.isfinite(il).all()):
                fail(f"{tag} float64 {kind}: non-finite L or L^-1")
            if torch.triu(l, 1).any() or torch.triu(il, 1).any():
                fail(f"{tag} float64 {kind}: entries above the diagonal")
            lp, ilp = ls._chol_inv_plain(a)
            got, want = _residuals(a, l, il), _residuals(a, lp, ilp)
            if plan.path == "warp":
                if not (torch.equal(l, lp) and torch.equal(il, ilp)):
                    fail(f"{tag} float64 {kind}: the warp path differs from "
                         f"the plain version by "
                         f"{(l - lp).abs().max().item():.3e}")
                note = "equal to the plain version bit for bit"
            elif kind == "guard":
                note = "guard input"
                if got[0] > 1e-4:
                    fail(f"{tag} float64 guard: |LL^T-A|/|A| = {got[0]:.3e}")
            else:
                note = f"plain {want[0]:.3e}, {want[1]:.3e}"
                for g, w in zip(got, want):
                    if g > F64_FACTOR * w + F64_ABS:
                        fail(f"{tag} float64 {kind}: residuals {got} exceed "
                             f"{F64_FACTOR} x the plain version's {want} + "
                             f"{F64_ABS}")
                worst = max(worst, (l - lp).abs().max().item(),
                            (il - ilp).abs().max().item()) \
                    if kind == "spd" else worst
            print(f"[kernels] {tag} float64 {kind}: {plan.path} path; "
                  f"|LL^T-A|/|A| {got[0]:.3e}, |L^-1 L - I| {got[1]:.3e}"
                  f" ({note})", flush=True)
        if s >= F64_MID_MAIN:
            continue
        a = random_spd(batch, n, gen).double()
        rows.append(_time_row(
            "chol_inv_mid_cuda", "hlax_torch/csrc/chol_inv_mid.cu",
            "hlax/ops/linalg_small.py:472", batch, n, f64,
            lambda: ls.chol_inv_mid_cuda(a), lambda: ls._chol_inv_plain(a),
            lambda: _library(a), worst,
            _bound_ms(a.numel() // (n * n), n, f64)))
    return rows


# The mid kernel of an earlier commit, for a parent-against-change timing
# in one call: before the run, unpack that commit's kernel sources under
# parent/ (listed in .gitignore),
#   mkdir -p parent && git archive <commit> hlax_torch/csrc | tar -xC parent
# and [kernels] builds its chol_inv_mid.cu into build/parent and times it
# against the current kernel at PARENT_ROWS, through the current C entry
# and launch plan (those since the float64 redesign).  Without parent/ the
# phase says so and moves on.
PARENT_CSRC = os.path.join(ROOT, "parent", "hlax_torch", "csrc")


def parent_same(*paths) -> bool:
    """Whether parent/ holds each of ``paths`` (under the repo's root) as
    this tree does, byte for byte: the parent's kernels are then this
    tree's, and a comparison would time one build against itself."""
    def read(root, p):
        with open(os.path.join(root, p), "rb") as f:
            return f.read()
    try:
        return all(read(os.path.join(ROOT, "parent"), p) == read(ROOT, p)
                   for p in paths)
    except OSError:
        return False
PARENT_ROWS = [((64,), 120, torch.float64), ((32,), 120, torch.float64),
               ((32, 256), 32, torch.float64), ((64,), 120, torch.float32),
               ((32,), 120, torch.float32), ((32, 256), 32, torch.float32)]


def phase_mid_parent(gen) -> None:
    """The parent's mid kernel against the current one at PARENT_ROWS, on
    one SPD input a row: float32 results equal bit for bit, float64 both
    within the residual bars of ``phase_mid_kernel_f64``; device times in
    turns, parent, change, change, parent.  The parent's kernel is called
    through the current C entry on the current launch plan
    (``mid_launch_plan``), the interface since the float64 redesign; a
    parent from before it needs its own."""
    import ctypes

    from hlax_torch.ops import cuda_build
    from hlax_torch.ops import linalg_small as ls

    src = os.path.join(PARENT_CSRC, "chol_inv_mid.cu")
    if not os.path.isfile(src):
        print(f"[kernels] parent against change: not measured (no {src})",
              flush=True)
        return
    if parent_same("hlax_torch/csrc/chol_inv_mid.cu"):
        print("[kernels] parent against change: not measured (the parent's "
              "chol_inv_mid.cu is this tree's)", flush=True)
        return
    out = os.path.join(cuda_build.BUILD_DIR, "parent", "libchol_inv_mid.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.time()
    res = subprocess.run([cuda_build._nvcc(),
                          *cuda_build.nvcc_flags("chol_inv_mid"), "-o", out,
                          src], capture_output=True, text=True)
    if res.returncode:
        fail(f"[kernels] the parent's chol_inv_mid.cu did not build:\n"
             f"{res.stdout}{res.stderr}")
    print(f"[kernels] parent's chol_inv_mid.cu built in "
          f"{time.time() - t0:.1f} s", flush=True)
    _ptxas_report("kernels", "parent's chol_inv_mid", res.stdout + res.stderr)
    fn = ctypes.CDLL(out).chol_inv_mid_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def parent(a):
        n = a.shape[-1]
        batch = a.numel() // (n * n)
        plan = ls.mid_launch_plan(n, batch, a.element_size())
        l, il = torch.empty_like(a), torch.empty_like(a)
        code = fn(a.data_ptr(), l.data_ptr(), il.data_ptr(), batch, n,
                  a.element_size(), {"warp": 0, "blocked": 1}[plan.path],
                  plan.grid, plan.threads, plan.panel, plan.smem,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            fail(f"[kernels] the parent's chol_inv_mid_launch: CUDA error "
                 f"{code}")
        return l, il

    before = ls._COUNTERS.snapshot()
    for batch, n, dtype in PARENT_ROWS:
        tag = f"{_tag('chol_inv_mid_cuda', batch, n)} " \
              f"{str(dtype).removeprefix('torch.')}"
        a = random_spd(batch, n, gen).to(dtype)
        got, want = ls.chol_inv_mid_cuda(a), parent(a)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            if not all(map(torch.equal, got, want)):
                fail(f"[kernels] {tag}: differs from the parent's kernel by "
                     f"{(got[0] - want[0]).abs().max().item():.3e} (L)")
            note = "equal to the parent's bit for bit"
        else:
            res_c, res_p = _residuals(a, *got), _residuals(a, *want)
            res_0 = _residuals(a, *ls._chol_inv_plain(a))
            for r in (res_c, res_p):
                if any(g > F64_FACTOR * w + F64_ABS
                       for g, w in zip(r, res_0)):
                    fail(f"[kernels] {tag}: residuals {r} exceed "
                         f"{F64_FACTOR} x the plain version's {res_0}")
            note = (f"|LL^T-A|/|A|, |L^-1 L - I| change {res_c[0]:.3e}, "
                    f"{res_c[1]:.3e}, parent {res_p[0]:.3e}, {res_p[1]:.3e}")
        ms = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent"):
            call = (lambda: parent(a)) if who == "parent" else \
                (lambda: ls.chol_inv_mid_cuda(a))
            ms[who].append(time_ms(call)[0])
        print(f"[kernels] parent against change {tag}: parent "
              f"{ms['parent'][0]:.5f}, change {ms['change'][0]:.5f}, change "
              f"{ms['change'][1]:.5f}, parent {ms['parent'][1]:.5f} ms "
              f"(parent / change {sum(ms['parent']) / sum(ms['change']):.2f}x)"
              f"; {note}; on {card_line()}", flush=True)
    ls._COUNTERS.take_since(before)


def phase_bwd_kernel_f64(gen):
    """The float64 backward kernel at F64_BWD_SHAPES, on (L, L^-1) from the
    float64 small kernel and three kinds of cotangents: its distance to the
    plain version on the card at most F64_FACTOR times the distance between
    the plain version on the card and on the CPU (two summation orders of
    the same products) plus F64_ABS of max|A_bar|.  Returns its table
    row."""
    from hlax_torch.ops import linalg_small as ls

    f64 = torch.float64
    worst = 0.0
    for batch, n in F64_BWD_SHAPES:
        tag = _tag("chol_inv_bwd_cuda", batch, n)
        l, il = ls.chol_inv_small_cuda(random_spd(batch, n, gen).double())
        for kind in ("random", "L^-1_bar = 0", "L_bar = 0"):
            lb = torch.randn(l.shape, generator=gen, device="cuda", dtype=f64)
            ilb = torch.randn(l.shape, generator=gen, device="cuda",
                              dtype=f64)
            if kind == "L^-1_bar = 0":
                ilb.zero_()
            elif kind == "L_bar = 0":
                lb.zero_()
            got = ls.chol_inv_bwd_cuda(l, il, lb, ilb)
            torch.cuda.synchronize()
            plain = ls._chol_inv_bwd_plain(l, il, lb, ilb)
            plain_cpu = ls._bwd_reference(l.cpu(), il.cpu(), lb.cpu(),
                                          ilb.cpu())
            err = (got - plain).abs().max().item()
            spread = (plain.cpu() - plain_cpu).abs().max().item()
            scale = plain.abs().max().item()
            worst = max(worst, err)
            print(f"[kernels] {tag} float64 {kind}: max|kernel-plain| "
                  f"{err:.3e}, max|plain on the card - plain on the CPU| "
                  f"{spread:.3e}, max|A_bar| {scale:.3e}", flush=True)
            if not torch.isfinite(got).all() or torch.triu(got, 1).any():
                fail(f"{tag} float64 {kind}: non-finite A_bar or entries "
                     "above the diagonal")
            if err > F64_FACTOR * spread + F64_ABS * scale:
                fail(f"{tag} float64 {kind}: {err:.3e} exceeds {F64_FACTOR}"
                     f" x {spread:.3e} + {F64_ABS} x {scale:.3e}")
    batch, n = F64_BWD_SHAPES[0]
    l, il = ls.chol_inv_small_cuda(random_spd(batch, n, gen).double())
    lb = torch.randn(l.shape, generator=gen, device="cuda", dtype=f64)
    ilb = torch.randn(l.shape, generator=gen, device="cuda", dtype=f64)
    return _time_row("chol_inv_bwd_cuda", "hlax_torch/csrc/chol_inv_bwd.cu",
                     "hlax/ops/linalg_small.py:328", batch, n, f64,
                     lambda: ls.chol_inv_bwd_cuda(l, il, lb, ilb),
                     lambda: ls._chol_inv_bwd_plain(l, il, lb, ilb), None,
                     worst, _bwd_bound_ms(int(np.prod(batch)), n, f64))


# the mid pullback's shapes: K0zz with H (the canonical step's), the
# natural-gradient inverse's batch (a 2 x 2 mesh rank's K0zz with H), the
# long sequences' diagonal blocks at T = 200 and 500, [reference]'s toy
# M = 30 (the mid kernel's warp path); the shapes a main path launches get
# rows in the kernel table, by dtype
MID_BWD_SHAPES = [((64,), 120), ((32,), 120), ((32, 4), 100), ((32, 2), 125),
                  ((16,), 30)]
MID_BWD_TABLE = {torch.float32: {((64,), 120), ((32, 4), 100),
                                 ((32, 2), 125)},
                 torch.float64: {((64,), 120)}}
# the mid pullback's float64 bar: within F64_MID_BWD of the plain version's
# largest entry
F64_MID_BWD = 1e-10


def phase_mid_bwd_kernel(gen):
    """The mid pullback's kernels (csrc/chol_inv_mid_bwd.cu) at
    MID_BWD_SHAPES in float32 and float64, on (L, L^-1) from the mid kernel
    and its Newton step, with random cotangents and with each one zero:
    float32 within ERR_FACTOR times the plain version's error against
    float64 plus ERR_ABS of the largest entry, float64 within F64_MID_BWD
    of the plain version's largest entry, exact zeros above the diagonal;
    one launch captured in a CUDA graph replays the eager call bit for bit.
    Each shape timed warm and L2-cold beside its bound and the plain
    chain's time.  Returns the kernel table's rows (MID_BWD_TABLE); the
    launches made here are not counted."""
    from hlax_torch.ops import linalg_small as ls

    before = ls._COUNTERS.snapshot()
    rows = []
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        for batch, n in MID_BWD_SHAPES:
            tag = f"{_tag('chol_inv_mid_bwd_cuda', batch, n)} {dname}"
            b = int(np.prod(batch))
            l, il = ls.chol_inv_mid_cuda(random_spd(batch, n, gen).to(dtype))
            il = ls._refine_tri_inverse(l, il)
            worst = 0.0
            for kind in ("random", "L^-1_bar = 0", "L_bar = 0"):
                lb = torch.randn(l.shape, generator=gen, device="cuda",
                                 dtype=dtype)
                ilb = torch.randn(l.shape, generator=gen, device="cuda",
                                  dtype=dtype)
                if kind == "L^-1_bar = 0":
                    ilb.zero_()
                elif kind == "L_bar = 0":
                    lb.zero_()
                got = ls.chol_inv_mid_bwd_cuda(l, il, lb, ilb)
                torch.cuda.synchronize()
                plain = ls._chol_inv_bwd_plain(
                    l, il, lb, ilb, "chol_inv_mid_bwd_plain")
                if not torch.isfinite(got).all() or torch.triu(got, 1).any():
                    fail(f"{tag} {kind}: non-finite A_bar or entries above "
                         "the diagonal")
                if dtype == torch.float64:
                    err = (got - plain).abs().max().item()
                    scale = plain.abs().max().item()
                    bar = F64_MID_BWD * scale
                    print(f"[kernels] {tag} {kind}: max|kernel-plain| "
                          f"{err:.3e}, bar {bar:.3e} ({F64_MID_BWD:g} of "
                          f"max|A_bar| {scale:.3e})", flush=True)
                else:
                    want = ls._bwd_reference(l.double(), il.double(),
                                             lb.double(), ilb.double())
                    err = (got.double() - want).abs().max().item()
                    err_plain = (plain.double() - want).abs().max().item()
                    scale = want.abs().max().item()
                    bar = ERR_FACTOR * err_plain + ERR_ABS * scale
                    print(f"[kernels] {tag} {kind}: max|kernel-f64| "
                          f"{err:.3e}, max|plain-f64| {err_plain:.3e}, bar "
                          f"{bar:.3e}, max|A_bar| {scale:.3e}", flush=True)
                if err > bar:
                    fail(f"{tag} {kind}: error {err:.3e} exceeds its bar "
                         f"{bar:.3e}")
                worst = max(worst, err)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = ls.chol_inv_mid_bwd_cuda(l, il, lb, ilb)
            lb.copy_(torch.randn(l.shape, generator=gen, device="cuda",
                                 dtype=dtype))
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(out, ls.chol_inv_mid_bwd_cuda(l, il, lb, ilb)):
                fail(f"{tag}: the captured launch's replay differs from the "
                     "eager call")
            del graph, out

            def kernel():
                ls.chol_inv_mid_bwd_cuda(l, il, lb, ilb)

            def plain_chain():
                ls._chol_inv_bwd_plain(
                    l, il, lb, ilb, "chol_inv_mid_bwd_plain")
            ms, wall = time_ms(kernel)
            cold = time_cold_ms(kernel)
            plain_ms = time_ms(plain_chain, reps=20)[0]
            bound, by = _bwd_bound_ms(b, n, dtype)
            plan = ls.mid_bwd_launch_plan(n, b, l.element_size())
            print(f"[kernels] {tag}: graph replay equals eager; kernel "
                  f"{ms:.5f} ms warm, {cold:.5f} ms L2-cold ({wall:.4f} ms a "
                  f"call on the host clock), plain {plain_ms:.5f} ms, "
                  f"library none, bound {bound:.5f} ms ({by}); plan "
                  f"{plan.grid_ab} + {plan.grid_ab} + {plan.grid_c} blocks, "
                  f"{plan.smem_ab} and {plan.smem_c} bytes of shared memory "
                  f"on {card_line()}", flush=True)
            if (batch, n) in MID_BWD_TABLE[dtype]:
                rows.append(dict(
                    name="chol_inv_mid_bwd_cuda", shape=list(batch + (n, n)),
                    dtype=dname, route="cuda",
                    source="hlax_torch/csrc/chol_inv_mid_bwd.cu",
                    replaces="hlax/ops/linalg_small.py:662", launches=0,
                    max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=None))
    ls._COUNTERS.take_since(before)
    return rows


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


# the card's toy steps against the CPU's, relative: float32 sums in other
# orders on the two devices, and the GP terms invert matrices of condition
# ~1e4; float64 rounds ~1e9 times finer
REFERENCE_BOUND = {torch.float32: 1e-3, torch.float64: 1e-8}


def phase_reference(tmp: str, dtype=torch.float32, seed: int = 0,
                    gate: bool = True) -> float:
    """The same four train steps (toy widths: z=8, hidden 50, M=30 for the
    mid kernel, T=20 for the small one) from identical weights and noise on
    the card and with the plain versions on the CPU, both in ``dtype`` (the
    model and the GP); the losses must agree to REFERENCE_BOUND (with
    ``gate``).  ``seed`` moves the data's, the weights' and the noise's
    seeds together (0: the gate's own toy state).  Returns the worst
    relative difference."""
    import copy

    from hlax_torch.config import ModelArgs
    from hlax_torch.data import dataset as ds
    from hlax_torch.data import generate as gen
    from hlax_torch.gp.kernels import build_kernel_specs
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.train import step as tstep

    d = os.path.join(tmp, f"ref{seed}")
    gen.write_csvs(gen.generate(num_3=2, num_6=2, datatype_config="D4",
                                seed=7 + seed), d, "D4")
    data = ds.load_dataset(d, "data.csv", "labels.csv", "mask.csv",
                           "data_types_D4.csv")
    opt = ModelArgs().parse_options([f"--f={CONFIG}"])
    spec0, spec1 = build_kernel_specs(
        opt["cat_kernel"], opt["bin_kernel"], opt["sqexp_kernel"],
        opt["cat_int_kernel"], opt["bin_int_kernel"],
        opt["covariate_missing_val"], opt["id_covariate"])
    cfg = tstep.TrainConfig(latent_dim=8, M=30, P_tot=float(data.P),
                            N_tot=float(len(data)), id_covariate=2,
                            gp_dtype=dtype)
    model = HLVAE(HLVAEConfig(layout=data.layout, z_dim=8, h_dims=(50,)),
                  torch.Generator().manual_seed(seed), "cpu").to(dtype)
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
    noise = torch.Generator().manual_seed(1 + seed)
    worst = 0.0
    staged = {dev: ds.stage_dataset(data, dtype, dev)
              for dev in ("cpu", "cuda")}
    steps = {dev: tstep.make_train_step(st.vae, spec0, spec1, cfg)
             for dev, st in (("cpu", cpu), ("cuda", gpu))}
    from hlax_torch.ops import linalg_small as ls
    ls.reset_counters()
    if gate:
        reset_all_counters()
    for i, idx in enumerate([[0, 1], [2, 3], [3, 0], [1, 2]]):
        eps = torch.randn((2 * data.T_max, 8), generator=noise, dtype=dtype)
        losses = {}
        for dev, state in (("cpu", cpu), ("cuda", gpu)):
            batch = ds.gather_batch(staged[dev],
                                    torch.tensor(idx, device=dev))
            losses[dev] = steps[dev](state, batch, eps=eps.to(dev))[
                "loss"].item()
        rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        worst = max(worst, rel)
        print(f"[reference] {dtype} step {i}: loss cuda "
              f"{losses['cuda']:.12g} cpu {losses['cpu']:.12g} rel "
              f"{rel:.2e}", flush=True)
    if not gate:
        return worst
    bound = REFERENCE_BOUND[dtype]
    print(f"[reference] {dtype}: worst rel {worst:.3e}, bound {bound:g}",
          flush=True)
    if not worst <= bound:
        fail(f"card and CPU disagree on the toy {dtype} train steps: rel "
             f"{worst:.2e}")
    print(f"[reference] launches on the card {dict(ls.LAUNCHES)}; plain "
          f"versions on CUDA tensors {dict(ls.PLAIN_CUDA_CALLS)}", flush=True)
    want = str(dtype).removeprefix("torch.")
    if ls.LAUNCHES["chol_inv_bwd_cuda"] < 4 or any(
            ls.PLAIN_CUDA_CALLS.values()) or any(
            dt != want for _, _, dt in ls.LAUNCHES_BY_SHAPE):
        fail(f"the card's T=20 {dtype} steps did not go through the "
             "backward kernel in that dtype")
    if not any(name == "chol_inv_mid_cuda" and ls.mid_launch_plan(
            shape[-1], 1).path == "warp" for name, shape, _ in
               ls.LAUNCHES_BY_SHAPE):
        fail("the card's M=30 steps did not take the mid kernel's warp path")
    if ls.LAUNCHES_BY_SHAPE.get(("chol_inv_mid_bwd_cuda", (16, 30, 30),
                                 want), 0) < 4:
        fail(f"the card's M=30 {dtype} steps did not go through the mid "
             "pullback's kernels")
    from hlax_torch.ops import natgrad
    if any(natgrad.LAUNCHES[f"{k}_cuda"] < 4 for k in NATGRAD_KERNELS) or \
            any(natgrad.PLAIN_CUDA_CALLS.values()):
        fail(f"the card's {dtype} steps did not go through the "
             f"natural-gradient kernels: {dict(natgrad.LAUNCHES)}, plain "
             f"{dict(natgrad.PLAIN_CUDA_CALLS)}")
    return worst


def phase_slice(tmp: str):
    from hlax_torch.cli import main as cli
    from hlax_torch.config import ModelArgs
    from hlax_torch.eval.validate import VALIDATION_ROWS

    data_dir = os.path.join(tmp, "data")
    write_canonical_data(data_dir)
    save = os.path.join(tmp, "run")
    opt = ModelArgs().parse_options([f"--f={CONFIG}"])
    prof_dir = os.path.join(tmp, "profile")
    # the config file as it is (images too), cut to 3 epochs with a save
    # interval at the third: the training curves, a validation and the
    # save-interval battery there, the reconstruction grid after training
    opt.update(data_source_path=data_dir, save_path=save, epochs=3,
               save_interval=3, device="cuda", profile_dir=prof_dir)
    if not (opt["generate_images"] and opt["run_validation"]
            and opt["run_tests"]):
        fail("[slice] the canonical config no longer asks for images, "
             "validation and tests")
    reset_all_counters()
    out = cli.run(opt)
    torch.cuda.synchronize()
    launches, by_shape, plain = read_all_counters()
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
    if by_shape.get(("chol_inv_mid_bwd_cuda", (64, 120, 120),
                     "float32"), 0) < steps:
        fail(f"the mid pullback launched fewer than {steps} times on K0zz "
             "with H")
    eval_mid = launches["chol_inv_mid_cuda"] - MID_PER_STEP * steps
    if eval_mid <= 0:
        fail("the mid Cholesky kernel was not launched in validation/tests")
    if any(plain.values()):
        fail("a plain Cholesky version or a fused op's plain version ran on "
             "CUDA tensors on the main path")
    for name in FUSED_KERNELS + tuple(f"{k}_cuda" for k in GP_BOUND_KERNELS
                                      + NATGRAD_KERNELS):
        if launches[name] < steps:
            fail(f"{name} launched {launches[name]} times in {steps} steps")
    _need("slice", by_shape, natgrad_need(32, 20, 20, 120, "float32",
                                          "float32", steps))
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
    trace = os.path.join(prof_dir, "epochs_2-2.pt.trace.json")
    if not os.path.isfile(trace):
        fail(f"--profile_dir wrote no trace of epoch 2: {trace}")
    with open(trace) as f:
        kernels = sum(e.get("cat") == "kernel"
                      for e in json.load(f).get("traceEvents", []))
    print(f"[slice] --profile_dir: {trace}, {os.path.getsize(trace)} bytes, "
          f"{kernels} device kernel events", flush=True)
    if not kernels:
        fail("the trace of epoch 2 holds no device kernel")
    ep, ev = out["epoch_seconds"], out["eval_seconds"]
    print(f"[slice] mid launches: {MID_PER_STEP * steps} in training, "
          f"{eval_mid} in validation and tests; launches by shape "
          f"{_by_shape_str(by_shape)}", flush=True)
    print(f"[slice] epoch seconds {ep}; steps/s after warm-up "
          f"{10 / ep[-1]:.3f} on {card_line()}", flush=True)
    print(f"[slice] final validation {ev['validation']:.3f} s, tests "
          f"{ev['tests']:.3f} s, images {ev['images']:.3f} s on "
          f"{card_line()}", flush=True)
    check_images(out, save)
    return by_shape, out, data_dir, save


def check_images(out, save: str) -> None:
    """The reconstruction grid of the generation split (its first 160
    rows: 8 subjects of 20 frames) and the training curves: where
    matplotlib is missing, recon_complete.npz with a finite [160, 1296]
    grid whose reconstruction is pixels in [0, 255], and
    training_curves.npz with every curve hlax plots; where it is
    installed, the PDF and the PNGs."""
    results = out["results_path"]
    npz = os.path.join(results, "recon_complete.npz")
    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
    if have_mpl:
        for path in (os.path.join(results, "recon_complete.pdf"),
                     os.path.join(save, "training_net_loss.png")):
            if not os.path.isfile(path):
                fail(f"[slice] {path} was not written")
        print("[slice] images: matplotlib is installed; the PDF and PNGs "
              "were written", flush=True)
        return
    if not os.path.isfile(npz):
        fail(f"[slice] {npz} was not written")
    with np.load(npz) as z:
        X, R = z["X"], z["recon_X"]
        sets, length = int(z["num_sets"]), int(z["seq_length"])
    if X.shape != (160, 1296) or R.shape != (160, 1296) or (sets, length) \
            != (8, 20):
        fail(f"[slice] recon_complete.npz holds {X.shape}, {R.shape}, "
             f"{sets} sets of {length}")
    # the reconstruction is pixels (sigmoid means x 255, 5-level codes x
    # 50); the truth is the generated data, whose rotated glyphs overshoot
    # [0, 255] (cubic splines)
    if not np.isfinite(X).all() or not np.isfinite(R).all() \
            or R.min() < 0 or R.max() > 255:
        fail(f"[slice] recon_complete.npz: truth x mask or reconstruction "
             f"not finite, or reconstruction pixels outside [0, 255] "
             f"({R.min()} .. {R.max()})")
    curves = os.path.join(save, "training_curves.npz")
    if not os.path.isfile(curves):
        fail(f"[slice] {curves} was not written")
    with np.load(curves) as z:
        lens = {k: len(z[k]) for k in z.files}
    want = {"net_loss": 3, "nll": 3, "kld": 3, "vae_error": 1,
            "gp_error": 1, "validation_loss": 1}
    if lens != want:
        fail(f"[slice] training_curves.npz holds {lens}, expected {want}")
    print(f"[slice] images (no matplotlib on this machine): "
          f"recon_complete.npz grid {X.shape}, truth x mask in "
          f"[{X.min():g}, {X.max():g}], recon in [{R.min():g}, {R.max():g}]"
          f"; training_curves.npz {lens}", flush=True)


def _by_shape_str(by_shape) -> str:
    return str({f"{k}{list(sh)} {dt}": v for (k, sh, dt), v in
                by_shape.items()})


def phase_impute(data_dir: str, save: str, tag: str = "impute") -> None:
    """The imputation CLI over the test split, encoder and GP modes: fills
    exactly the cells the mask marks missing, leaves the observed ones."""
    from hlax_torch.cli import impute
    from hlax_torch.native import io as nio
    from hlax_torch.ops import linalg_small as ls

    raw = np.loadtxt(os.path.join(data_dir, "test_data_D4.csv"),
                     delimiter=",")
    if not nio.native_available():
        fail(f"[{tag}] the native CSV parser did not build")
    path = os.path.join(data_dir, "test_data_D4.csv")
    t0 = time.perf_counter()
    parsed = nio.read_csv_matrix(path)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    nio.python_fallback(path)
    t_python = time.perf_counter() - t0
    if not np.array_equal(parsed, raw):
        fail(f"[{tag}] the native parser read another matrix than numpy's")
    print(f"[{tag}] {raw.shape[0]} x {raw.shape[1]} CSV: native parser "
          f"{t_native:.3f} s, plain-Python parser {t_python:.3f} s (host)",
          flush=True)
    mask = np.loadtxt(os.path.join(data_dir, "test_mask.csv"), delimiter=",")
    for mode, extra in (("encoder", []),
                        ("gp", ["--use_gp", "--label_csv",
                                os.path.join(data_dir, "test_label.csv")])):
        out_csv = os.path.join(save, f"imputed_{mode}.csv")
        ls.reset_counters()
        nio.reset_parses()
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
            fail(f"[{tag}] {mode}: filled {filled} cells, the mask has "
                 f"{int((mask == 0).sum())} missing")
        if imp.shape != raw.shape or not np.isfinite(imp).all():
            fail(f"[{tag}] {mode}: output not finite or of another shape")
        if not np.array_equal(imp[mask == 1], raw[mask == 1]):
            fail(f"[{tag}] {mode}: observed cells changed")
        if mode == "gp" and ls.LAUNCHES["chol_inv_mid_cuda"] == 0:
            fail(f"[{tag}] gp: the GP prediction launched no mid kernel")
        if nio.PARSES["native"] < 2 or nio.PARSES["fallback"]:
            fail(f"[{tag}] {mode}: CSV files read {nio.PARSES}; every one "
                 "should go through the native parser")
        print(f"[{tag}] impute {mode}: {filled} cells filled over {len(raw)} "
              f"rows, "
              f"{len(raw) / seconds:.1f} rows/s ({seconds:.3f} s, the whole "
              f"CLI call; 525-536 rows/s with the plain-Python parser "
              f"before it) on {card_line()}; launches {dict(ls.LAUNCHES)}; CSV "
              f"files read {nio.PARSES}", flush=True)


def eval_rate(model, ds, reps: int = 10):
    """bench.py's imputation-eval protocol: forward with the q(z) mean over
    the training set ``ds`` in 500-row chunks (zero-padded), summed
    log_p_x, one sync a pass; one warm-up pass, then ``reps`` timed, then
    one under the profiler.  Returns (samples/s, summed log p(x), device
    busy ms of a pass, kernels a pass)."""
    from torch.profiler import ProfilerActivity, profile

    from hlax_torch.eval.validate import device_het

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
    t0 = time.perf_counter()
    for _ in range(reps):
        one_pass()
    dt = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_pass()
    kernels = [e for e in prof.events() if str(e.device_type).endswith(
        "CUDA") and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return reps * n / dt, total, busy, len(kernels)


def phase_eval(out) -> None:
    """[eval] ``eval_rate`` of the trained canonical model."""
    n = len(out["dataset"])
    rate, total, busy, kernels = eval_rate(out["model"], out["dataset"])
    print(f"[eval] imputation-eval {rate:.1f} samples/s ({n} rows, "
          f"{-(-n // EVAL_CHUNK)} chunks of {EVAL_CHUNK}, 10 passes, "
          f"sum log p(x) {total:.1f}; a pass {busy:.3f} ms device busy in "
          f"{kernels} kernels) on {card_line()}", flush=True)


def phase_profile(out, n_steps: int = 10) -> None:
    """Steps/s of the canonical step, eager, over ``n_steps`` more steps,
    then a torch.profiler pass over 5 steps: device time by kernel, and the
    device's idle share of the wall time."""
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
    _profile_steps("profile", lambda: step(state, gather_batch(staged,
                                                                idx)), 5)


def _region_of(e, seq_region) -> str:
    """The train-step region (``hlax_torch.profiling.REGIONS``) of a profiled
    host event: its innermost enclosing range; in the backward pass, the
    forward region of the operation the autograd node differentiates
    (``seq_region``: autograd sequence number -> forward region), else
    "other"."""
    from hlax_torch.profiling import REGIONS

    a = e
    while a is not None:
        if a.name in REGIONS:
            return a.name
        if a.name.startswith("autograd::engine::evaluate_function"):
            r = seq_region.get(a.sequence_nr)
            return f"backward of {r}" if r else "backward"
        a = a.cpu_parent
    return "other"


# the CUDA API calls (cuda*, cu*) that launch a kernel or a copy outside a
# graph (cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync, cudaMemsetAsync,
# ...); a graph launch and every other call (synchronizations, events,
# queries) make no kernel of their own
LAUNCH_CALL = re.compile(r"cu(da)?(Launch|Memcpy|Memset)(?!.*Graph).*")


def region_table(prof) -> dict:
    """{kernel name: {region: [launches, device us]}} of a profile of eager
    steps, each device kernel (and copy) counted once, by its correlation
    id: the CUDA API call that launched it (``LAUNCH_CALL``) has
    that id and is a host event in the profile's tree under the operation,
    the autograd node or the range that made it, and the kernel goes to
    that call's region (``_region_of``).  This also finds a launch outside
    any operation, a ctypes launch such as the recon metric's.  A kernel
    whose call the profile lacks, or a graph replay's (its host operations
    ran at capture), is in no row.  {} for a tree without the regions (an
    earlier commit's, ``rate`` mode)."""
    try:
        from hlax_torch.profiling import REGIONS
    except ImportError:
        return {}

    events = prof.events()
    seq_region = {}
    for e in events:
        if e.sequence_nr is None or e.sequence_nr < 0:
            continue
        a = e.cpu_parent
        while a is not None and a.name not in REGIONS:
            a = a.cpu_parent
        if a is not None and a.name not in ("backward", "adam"):
            seq_region.setdefault(e.sequence_nr, a.name)
    calls = {e.id: e for e in events if str(e.device_type).endswith("CPU")
             and e.id > 0 and LAUNCH_CALL.fullmatch(e.name)}
    table = {}
    for e in events:
        call = calls.get(e.id)
        if call is None or not str(e.device_type).endswith("CUDA") or \
                getattr(e, "is_user_annotation", False):
            continue
        region = _region_of(call, seq_region)
        r = table.setdefault(e.name, {}).setdefault(region, [0, 0.0])
        r[0] += 1
        r[1] += e.time_range.elapsed_us()
    return table


def _print_regions(tag: str, by_name: dict, steps: int, table: dict,
                   how: str) -> dict:
    """Kernels and device ms a step by region for the kernels ``by_name``
    ({name: [launches, us]}), each kernel name's launches and time split
    over the regions as ``table`` (``region_table``) splits them."""
    regions, busy = {}, sum(t for _, t in by_name.values())
    for name, (n, t) in by_name.items():
        split = table.get(name)
        if not split:
            split = {"unattributed": [n, t]}
        tot_n = sum(v[0] for v in split.values())
        tot_t = sum(v[1] for v in split.values()) or 1.0
        for r, (rn, rt) in split.items():
            acc = regions.setdefault(r, [0.0, 0.0])
            acc[0] += n * rn / tot_n
            acc[1] += t * rt / tot_t
    print(f"[{tag}] by source region ({how}): kernels a step, device ms a "
          "step, share", flush=True)
    for r, (n, t) in sorted(regions.items(), key=lambda kv: -kv[1][1]):
        print(f"[{tag}]   {r:34s} {n / steps:7.1f} {t / steps / 1e3:8.4f} "
              f"{t / busy:6.1%}", flush=True)
    return {r: (n / steps, t / steps / 1e3) for r, (n, t) in regions.items()}


def _profile_steps(tag: str, run, steps: int, calls: int = 5,
                   focus: str = "", table: dict = None, top: int = 15):
    """``run`` ``calls`` times (``steps`` train steps in all) under
    torch.profiler: wall and device-busy ms a step, kernels a step, the
    device's idle share of the wall time, and the kernels that take the most
    device time (full names); then every kernel whose name ``focus`` (a
    regular expression) finds, if given, with its launches a step; then kernels and device ms a step by source region: from this
    profile's own host events when ``table`` is None (eager steps), else
    split by kernel name as ``table`` (an eager profile's ``region_table``)
    splits them (graph replays launch no host operations).  Returns
    (summary dict, this profile's region table)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        # device-side kernels only: user annotations (e.g. the optimizer's
        # step range) span kernels already counted
        if str(e.device_type).endswith("CUDA") and not getattr(
                e, "is_user_annotation", False):
            acc = by_name.setdefault(e.name, [0, 0.0])
            acc[0] += 1
            acc[1] += e.time_range.elapsed_us()
    busy = sum(t for _, t in by_name.values())
    if not busy:
        print(f"[{tag}] the profiler recorded no device time: device busy "
              "and idle share not measured", flush=True)
        return None, {}
    n_kernels = sum(n for n, _ in by_name.values())
    print(f"[{tag}] {steps} steps under the profiler: wall "
          f"{wall_us / steps / 1e3:.3f} ms/step, device busy "
          f"{busy / steps / 1e3:.3f} ms/step, {n_kernels / steps:.1f} "
          f"kernels/step, idle share {1 - busy / wall_us:.3f} on "
          f"{card_line()}", flush=True)
    for name, (n, t) in sorted(by_name.items(),
                               key=lambda kv: -kv[1][1])[:top]:
        print(f"[{tag}] {t / steps / 1e3:8.4f} ms/step {t / busy:6.1%} "
              f"{n / steps:5.1f}/step  {name}", flush=True)
    for name, (n, t) in sorted(by_name.items()):
        hit = re.search(focus, name) if focus else None
        if hit:
            print(f"[{tag}] {hit.group(0)}: {t / steps / 1e3:.5f} ms/step, "
                  f"{n / steps:.1f} launches/step, "
                  f"{t / busy:.2%} of the device time: {name}", flush=True)
    own = region_table(prof)
    regions = None
    # graph replays launch no host operations: a profile of them reads its
    # regions from an eager profile's table, or prints none
    own_us = sum(t for r in own.values() for _, t in r.values())
    replays = any(str(e.device_type).endswith("CPU") and "GraphLaunch" in
                  e.name for e in prof.events())
    if table or (not replays and own_us >= 0.5 * busy):
        regions = _print_regions(
            tag, by_name, steps, own if table is None else table,
            "this profile's host events" if table is None else
            "each kernel name split as in the eager steps' profile")
    return {"wall_ms": wall_us / steps / 1e3, "busy_ms": busy / steps / 1e3,
            "kernels": n_kernels / steps, "idle": 1 - busy / wall_us,
            "regions": regions, "by_name": by_name}, own


def reset_all_counters() -> None:
    """The launch counters of every kernel module set to 0."""
    from hlax_torch.ops import counters

    counters.reset_every()


def read_all_counters():
    """(launches, launches by shape, plain-version calls on CUDA tensors)
    of every kernel module, each one dict."""
    from hlax_torch.ops import counters

    return counters.read_every()


def _run_cli(opt: dict, log: str):
    """The training CLI on ``opt`` with its console output kept in ``log``
    (the option dump and the per-epoch lines); every launch counter set to
    0 just before and read just after.  Returns (out, launches, by_shape,
    plain-version calls)."""
    from hlax_torch.cli import main as cli

    reset_all_counters()
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        out = cli.run(opt)
    torch.cuda.synchronize()
    return (out, *read_all_counters())


def _check_run(tag: str, out, steps: int, plain, validation: bool = True,
               allowed=frozenset()):
    """A CLI run's common checks: the steps it took, finite losses, no
    plain version on the card but those ``allowed``, and 10 finite
    validation rows."""
    from hlax_torch.eval.validate import VALIDATION_ROWS

    losses = out["loss_arrs"]["net"]
    if out["steps"] != steps:
        fail(f"[{tag}] expected {steps} train steps, ran {out['steps']}")
    if not all(map(np.isfinite, losses)):
        fail(f"[{tag}] non-finite loss {losses}")
    ran = {k: v for k, v in plain.items() if v and k not in allowed}
    if ran:
        fail(f"[{tag}] a plain version ran on CUDA tensors: {ran}")
    if validation:
        with open(os.path.join(out["results_path"],
                               "validation_results.csv")) as f:
            rows = [line.rstrip("\n").split(",") for line in f]
        if [r[0] for r in rows] != list(VALIDATION_ROWS) or not all(
                np.isfinite(float(r[1])) for r in rows):
            fail(f"[{tag}] validation_results.csv is not 10 finite rows: "
                 f"{rows}")
        return dict((r[0], float(r[1])) for r in rows)
    return None


def _steps_per_s(out, subjects: int, n_steps: int = 5) -> float:
    """Steps/s of ``n_steps`` more steps of a run's train step on a fixed
    batch of its first subjects, after one warm-up step."""
    from hlax_torch.data.dataset import gather_batch

    state, staged, step = out["state"], out["staged"], out["train_step"]
    idx = torch.arange(subjects, device="cuda")
    step(state, gather_batch(staged, idx))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step(state, gather_batch(staged, idx))
    torch.cuda.synchronize()
    return n_steps / (time.perf_counter() - t0)


def natgrad_need(L: int, S: int, T: int, M: int, data: str, chain: str,
                 steps: int) -> dict:
    """``_need``'s keys of the natural-gradient kernels' launches in
    ``steps`` steps: K5 on the bound's [L, S, T, M] in the data's dtype, K6
    to K8 on [L, M, M] in the chain's (``--nat_grad_f64``: float64 on
    float32 data)."""
    return {("natgrad_fwd_subjects_cuda", (L, S, T, M), data): steps,
            **{(f"{k}_cuda", (L, M, M), chain): steps
               for k in NATGRAD_KERNELS[1:]}}


def _need(tag: str, by_shape, want) -> None:
    """Fail unless every (kernel, shape, dtype) of ``want`` was launched
    at least its count of times."""
    for key, least in want.items():
        if by_shape.get(key, 0) < least:
            fail(f"[{tag}] {key[0]} {list(key[1])} {key[2]} launched "
                 f"{by_shape.get(key, 0)} times, expected at least {least}")


def phase_f64(data_dir: str, tmp: str):
    """The canonical config in the reference's own dtype
    (--gp_dtype=float64 --model_dtype=float64) and in float32 with the
    float64 natural-gradient chain (--nat_grad_f64=True): two epochs of 10
    steps each through the graphs (the second's time is the graph path's
    steps/s) and the final validation with --eval_gp_f64=True; then the
    eager step's steps/s, the graph path's over 3 more epochs, and the
    graph path under the profiler: device ms a step by kernel (each
    Cholesky kernel's share) and the idle share.  Returns the launches by
    (kernel, shape, dtype) of both runs."""
    from hlax_torch.config import ModelArgs
    from hlax_torch.data.dataset import epoch_subject_batches

    b, m = (32, 20, 20, 20), (32, 120, 120)
    k2 = (64, 120, 120)
    variants = [
        ("float64", dict(gp_dtype="float64", model_dtype="float64"),
         {("chol_inv_small_cuda", b, "float64"): 10,
          ("chol_inv_bwd_cuda", b, "float64"): 10,
          ("chol_inv_mid_cuda", k2, "float64"): 10,
          ("chol_inv_mid_cuda", m, "float64"): 10,
          ("chol_inv_mid_cuda", (32, 256, 32, 32), "float64"): 1,
          ("chol_inv_mid_bwd_cuda", k2, "float64"): 10,
          **natgrad_need(32, 20, 20, 120, "float64", "float64", 20)}),
        ("nat_grad_f64", dict(nat_grad_f64=True),
         {("chol_inv_small_cuda", b, "float32"): 10,
          ("chol_inv_bwd_cuda", b, "float32"): 10,
          ("chol_inv_mid_cuda", k2, "float32"): 10,
          ("chol_inv_mid_cuda", k2, "float64"): 10,
          ("chol_inv_mid_cuda", m, "float64"): 10,
          ("chol_inv_mid_bwd_cuda", k2, "float32"): 10,
          **natgrad_need(32, 20, 20, 120, "float32", "float64", 20)}),
    ]
    counts = {}
    for name, over, want in variants:
        opt = ModelArgs().parse_options([f"--f={CONFIG}"])
        opt.update(data_source_path=data_dir,
                   save_path=os.path.join(tmp, f"run_{name}"), epochs=2,
                   run_validation=True, run_tests=False,
                   generate_images=False, device="cuda", eval_gp_f64=True,
                   **over)
        t0 = time.perf_counter()
        out, launches, by_shape, plain = _run_cli(
            opt, os.path.join(tmp, f"{name}.log"))
        seconds = time.perf_counter() - t0
        rows = _check_run(f"f64 {name}", out, 20, plain)
        _need(f"f64 {name}", by_shape, want)
        if name == "float64" and any(dt != "float64"
                                     for _, _, dt in by_shape):
            fail("[f64] float64: a float32 kernel ran in the float64 run")
        for key, v in by_shape.items():
            counts[key] = counts.get(key, 0) + v
        sps = _steps_per_s(out, 20)
        print(f"[f64] {name}: losses {out['loss_arrs']['net']}; final "
              f"validation (eval_gp_f64) {out['eval_seconds']['validation']:.3f}"
              f" s, GP_loss {rows['GP_loss']:.6g}, net_loss "
              f"{rows['net_loss']:.6g}; run {seconds:.1f} s; launches "
              f"{launches}; by shape {_by_shape_str(by_shape)}; plain "
              f"versions on CUDA tensors {plain}", flush=True)
        idx = np.stack(list(epoch_subject_batches(
            200, 20, np.random.default_rng(0))))

        def epoch():
            out["train_epoch"](out["state"], out["staged"], idx)
        graph = _time_epochs(epoch, 3)
        print(f"[f64] {name}: graph path {10 / out['epoch_seconds'][-1]:.3f}"
              f" steps/s (the second epoch), {graph:.3f} steps/s (3 more "
              f"epochs), eager {sps:.3f} steps/s (5 steps after a warm-up "
              f"one, 20 subjects a batch) on {card_line()}", flush=True)
        _profile_steps(f"f64 {name}", epoch, 3 * GRAPH_STEPS, calls=3,
                       focus="chol_inv")
        del out
        torch.cuda.empty_cache()
    return counts


# the long sequences of baselines/t_scaling.py: (T, subjects, a batch)
LONG_T = [(200, 40, 4), (500, 20, 2)]


def long_t_dataset(T: int, P: int, seed: int = 0):
    """Synthetic D4-shaped data stretched to T time points a subject (the
    generator of baselines/t_scaling.py:42-57): 324 real pixels in
    [0, 255) and 972 cat(5) pixels, 25 % missing, the canonical six
    covariates."""
    from hlax_torch.data.dataset import LongitudinalDataset
    from hlax_torch.data.reader import encode_raw

    rng = np.random.default_rng(seed)
    n = P * T
    types = ([{"type": "real", "dim": 1, "nclass": 1}] * 324
             + [{"type": "cat", "dim": 1, "nclass": 5}] * 972)
    raw = np.column_stack([rng.random((n, 324)) * 255,
                           rng.integers(0, 5, (n, 972)).astype(float)])
    het = encode_raw(raw, types,
                     miss_mask=(rng.random((n, 1296)) > 0.25).astype(float))
    labels = np.zeros((n, 6))
    labels[:, 0] = np.tile(np.arange(T), P)
    labels[:, 1] = np.repeat(rng.integers(-9, 11, P), T)
    labels[:, 2] = np.repeat(np.arange(P), T)
    labels[:, 3] = np.repeat(rng.integers(0, 2, P), T)
    labels[:, 4] = np.repeat(rng.integers(0, 2, P), T)
    return LongitudinalDataset(het=het, labels=labels, id_covariate=2,
                               conv=True)


def long_t_specs():
    """The GP specs of [longT]'s synthetic D4-shaped data."""
    from hlax_torch.gp.kernels import build_kernel_specs

    return build_kernel_specs(
        [2], [], [0], [{"cont_covariate": 0, "cat_covariate": 2},
                       {"cont_covariate": 0, "cat_covariate": 3},
                       {"cont_covariate": 1, "cat_covariate": 4}], [], [], 2)


def phase_long_t(tmp: str):
    """T = 200 and T = 500 at L = 32, M = 120, conv, float32: a warm-up
    step and 5 timed steps, whose B blocks [32, S, T, T] go through the
    blocked composition (2 x 100 and 4 x 125 on the mid kernel), then the
    DUBO and the predictor over the whole set (the n = 256 and 512 buckets,
    diagonal blocks of 128); then at T = 200 the graph steps against the
    eager steps and both steps/s (``_graph_beside_eager``).  At T = 200 and
    500 the bound's subject kernels, in row tiles there with cuBLAS's
    products around them, are counted a step, held against the plain
    version and timed on each state's first batch (``_gp_bound_fusion``).  Returns (the launches by (kernel,
    shape, dtype), the kernel table's rows of those two kernels)."""
    from hlax_torch.data.dataset import (epoch_subject_batches, gather_batch,
                                         stage_dataset, subject_batches)
    from hlax_torch.eval import validate as val
    from hlax_torch.gp.kernels import noise_value
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.ops import linalg_small as ls
    from hlax_torch.train import step as tstep

    spec0, spec1 = long_t_specs()
    counts, rows = {}, []
    for T, P, S in LONG_T:
        t0 = time.perf_counter()
        ds = long_t_dataset(T, P)
        made = time.perf_counter() - t0
        cfg = tstep.TrainConfig(latent_dim=32, M=120, P_tot=float(P),
                                N_tot=float(len(ds)), id_covariate=2,
                                natural_gradient=True, constrain_scales=True)
        model = HLVAE(HLVAEConfig(layout=ds.layout, z_dim=32, h_dims=(500,),
                                  y_dim=5, conv=True),
                      torch.Generator(device="cuda").manual_seed(0), "cuda")
        state = tstep.init_train_state(model, spec0, spec1,
                                       next(subject_batches(ds, S)), cfg)
        staged = stage_dataset(ds, torch.float32, "cuda")
        step = tstep.make_train_step(model, spec0, spec1, cfg)
        batches = [torch.as_tensor(b, device="cuda") for b in
                   epoch_subject_batches(P, S, np.random.default_rng(0))][:6]
        torch.cuda.reset_peak_memory_stats()
        reset_all_counters()
        losses = [step(state, gather_batch(staged, batches[0]))["loss"]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[1:]:
            losses.append(step(state, gather_batch(staged, b))["loss"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        losses = [x.item() for x in losses]
        t0 = time.perf_counter()
        mu, lv = val.encode_dataset(model, ds)
        noise = noise_value(state.raw_noise, cfg.constrain_scales)
        dubo = val.gp_loss_dubo(spec0, state.k0, spec1, state.k1, noise,
                                state.zt, ds, mu, lv)
        dubo_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        z = val.gp_predict_dataset(spec0, state.k0, spec1, state.k1, noise,
                                   state.zt, ds.labels, mu, ds.labels[:, 2],
                                   ds.labels, ds.labels[:, 2])
        pred_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        _, by_shape, plain = read_all_counters()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        sizes = ls._block_sizes(T)
        nb, sb = 1 << (T - 1).bit_length(), 1 << (P - 1).bit_length()
        tag = f"longT T={T}"
        if not all(map(np.isfinite, losses)) or not np.isfinite(dubo):
            fail(f"[{tag}] non-finite loss {losses} or DUBO {dubo}")
        if z.shape != (len(ds), 32) or not np.isfinite(z).all():
            fail(f"[{tag}] predictor gave {z.shape}, finite "
                 f"{np.isfinite(z).all()}")
        if any(plain.values()):
            fail(f"[{tag}] a plain version ran on the card: {plain}")
        _need(tag, by_shape, {
            ("chol_inv_mid_cuda", (32, S, sizes[0], sizes[0]), "float32"):
                6 * len(sizes),
            ("chol_inv_mid_bwd_cuda", (32, S, sizes[0], sizes[0]),
             "float32"): 6 * len(sizes),
            ("chol_inv_mid_cuda", (32, sb, 128, 128), "float32"):
                2 * nb // 128,
            **{(f"gp_bound_{k}_subjects_cuda", (32, S, T, 120), "float32"): 6
               for k in ("fwd", "bwd")},
            **natgrad_need(32, S, T, 120, "float32", "float32", 6)})
        for key, v in by_shape.items():
            counts[key] = counts.get(key, 0) + v
        print(f"[{tag}] the bound's subject kernels' launches a step: "
              + ", ".join(f"{k} " + str(by_shape.get(
                  (f"{k}_cuda", (32, S, T, 120), "float32"), 0) / len(losses))
                          for k in SUBJECT_ENTRIES)
              + f" ({len(losses)} steps)", flush=True)
        batch = gather_batch(staged, batches[0])
        with torch.no_grad():
            mu_b, lv_b = state.vae.encode(batch["data"], batch["mask"])
        rows += _gp_bound_fusion(
            dict(batch=batch, specs=(spec0, spec1), k0=state.k0, k1=state.k1,
                 noise=noise.detach(), zt=state.zt, eps=cfg.eps,
                 H=state.H.detach(), m=state.m.detach(), mu=mu_b,
                 log_var=lv_b),
            torch.float32, tag, SUBJECT_ENTRIES)
        print(f"[{tag}] {P} subjects, {S} a batch: data made in {made:.1f} "
              f"s; losses {losses}; {5 / train_s:.3f} steps/s, "
              f"{5 * S * T / train_s:.1f} rows/s (5 steps after a warm-up "
              f"one); B blocks [32, {S}, {T}, {T}] in diagonal blocks of "
              f"{sizes}; DUBO {dubo:.6g} over the n = {nb} bucket "
              f"(encoder + bound {dubo_s:.3f} s); predictor {pred_s:.3f} s; "
              f"peak device memory {peak:.2f} GiB; launches by shape "
              f"{_by_shape_str(by_shape)} on {card_line()}", flush=True)
        del model, state, staged, step
        torch.cuda.empty_cache()
    T, P, S = LONG_T[0]
    _graph_beside_eager(f"longT T={T}", long_t_dataset(T, P), spec0, spec1,
                        S, True, 5, tmp)
    return counts, rows


def _graph_beside_eager(tag, ds, spec0, spec1, subjects, conv, n_batches,
                        tmp) -> None:
    """The first ``n_batches`` batches of ``subjects`` (L = 32, M = 120,
    the conv or the MLP model) through ``make_train_epoch``'s graphs against
    the same steps run eagerly, in float64 with cuDNN's deterministic
    algorithms and the noise injected, at [graph]'s bound
    (``_graph_check``); then float32 steps/s of the eager path and the
    graph path in 2 alternating rounds."""
    from hlax_torch.data.dataset import epoch_subject_batches, stage_dataset
    from hlax_torch.train import step as tstep

    idx = np.stack(list(epoch_subject_batches(
        ds.P, subjects, np.random.default_rng(0))))[:n_batches]
    staged = stage_dataset(ds, torch.float64, "cuda")
    eps = torch.randn((len(idx), subjects * ds.T_max, 32),
                      dtype=torch.float64, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(1))
    with cudnn_deterministic():
        _graph_check(f"{tag} float64", ds, spec0, spec1, torch.float64,
                     staged, idx, eps, 1, tmp, subjects=subjects, conv=conv)
    del staged, eps
    torch.cuda.empty_cache()
    staged = stage_dataset(ds, torch.float32, "cuda")
    kw = dict(subjects=subjects, conv=conv)
    a, cfg = canonical_state(ds, spec0, spec1, torch.float32, **kw)
    b, _ = canonical_state(ds, spec0, spec1, torch.float32, **kw)
    step = tstep.make_train_step(a.vae, spec0, spec1, cfg)
    epoch = tstep.make_train_epoch(b.vae, spec0, spec1, cfg)
    runs = {"eager": lambda: tstep.train_epoch(step, a, staged, idx),
            "graph": lambda: epoch(b, staged, idx)}
    for run in runs.values():
        run()
    rates = {name: [] for name in runs}
    for _ in range(2):
        for name, run in runs.items():
            rates[name].append(_time_epochs(run, 1, steps=len(idx)))
    print(f"[{tag.split()[0]}] {tag}: steps/s eager "
          f"{', '.join(f'{x:.2f}' for x in rates['eager'])}, graph "
          f"{', '.join(f'{x:.2f}' for x in rates['graph'])} (2 alternating "
          f"rounds of {len(idx)} steps, float32, {subjects} subjects a "
          f"step) on {card_line()}", flush=True)
    del a, b, step, epoch, staged
    torch.cuda.empty_cache()


def phase_mlp(data_dir: str, tmp: str):
    """The MLP model (--conv_hivae=False, hidden [500], y_dim 5) on the
    canonical data: 3 epochs (the fewest after which the CLI writes the
    checkpoint the imputation CLI reads), the final validation, the test
    battery, then imputation in encoder and GP mode; then its graph steps
    against its eager steps and both steps/s (``_graph_beside_eager``).
    Returns the training run's launches by (kernel, shape, dtype)."""
    from hlax_torch.config import ModelArgs

    save = os.path.join(tmp, "run_mlp")
    opt = ModelArgs().parse_options([f"--f={CONFIG}"])
    opt.update(data_source_path=data_dir, save_path=save, epochs=3,
               run_validation=True, run_tests=True, generate_images=False,
               device="cuda", conv_hivae=False, hidden_layers="[500]",
               y_dim=5)
    out, launches, by_shape, plain = _run_cli(opt, os.path.join(tmp,
                                                                "mlp.log"))
    if out["model"].cfg.conv or out["model"].conv1 is not None:
        fail("[mlp] the run did not build the MLP model")
    rows = _check_run("mlp", out, 30, plain)
    with open(os.path.join(out["results_path"],
                           "result_error_final.csv")) as f:
        err = f.read().split()
    rows_mlp = (400, CANONICAL_N_EXP)
    _need("mlp", by_shape, {
        ("chol_inv_small_cuda", (32, 20, 20, 20), "float32"): 30,
        ("chol_inv_bwd_cuda", (32, 20, 20, 20), "float32"): 30,
        ("chol_inv_mid_cuda", (64, 120, 120), "float32"): 30,
        ("chol_inv_mid_bwd_cuda", (64, 120, 120), "float32"): 30,
        ("heads_cat_fwd_cuda", (400, 1296, 5), "float32"): 30,
        ("heads_real_bwd_cuda", (400, 1296, 5), "float32"): 30,
        ("recon_metric_cuda", rows_mlp, "float32"): 30,
        **natgrad_need(32, 20, 20, 120, "float32", "float32", 30)})
    ep, ev = out["epoch_seconds"], out["eval_seconds"]
    sps = _steps_per_s(out, 20)
    print(f"[mlp] losses per epoch {out['loss_arrs']['net']}; validation "
          f"rows {rows}; result_error_final {err}; launches {launches}; "
          f"plain versions on CUDA tensors {plain}", flush=True)
    print(f"[mlp] epoch seconds {ep}; {sps:.3f} steps/s (5 steps after a "
          f"warm-up one); final validation {ev['validation']:.3f} s, tests "
          f"{ev['tests']:.3f} s on {card_line()}", flush=True)
    del out
    phase_impute(data_dir, save, tag="mlp")
    ds, spec0, spec1 = canonical_setup(data_dir)
    _graph_beside_eager("mlp", ds, spec0, spec1, 20, False, GRAPH_STEPS,
                        tmp)
    return by_shape


# graph steps against eager steps: the largest relative difference allowed.
# Both run with cuDNN's deterministic algorithms: its default weight
# gradient (wgrad algorithm 0) sums with atomics, in another order from run
# to run, and the GP's conditioning (K0zz ~1e8 at the float64 jitter of
# 1e-6) carries a last-bit difference to ~1e-8 of m and H in 10 steps.
GRAPH_BOUND = {torch.float32: 1e-5, torch.float64: 1e-10}
GRAPH_STEPS = 10         # one canonical epoch
FULL_EPOCHS = 300        # the canonical config's


def canonical_setup(data_dir: str):
    """The canonical training split and kernel structure."""
    from hlax_torch.config import ModelArgs
    from hlax_torch.data.dataset import load_dataset
    from hlax_torch.gp.kernels import build_kernel_specs

    opt = ModelArgs().parse_options([f"--f={CONFIG}"])
    ds = load_dataset(data_dir, opt["csv_file_data"], opt["csv_file_label"],
                      opt["mask_file"], opt["csv_types_file"], None, None,
                      opt["id_covariate"], False, True, False)
    spec0, spec1 = build_kernel_specs(
        opt["cat_kernel"], opt["bin_kernel"], opt["sqexp_kernel"],
        opt["cat_int_kernel"], opt["bin_int_kernel"],
        opt["covariate_missing_val"], opt["id_covariate"])
    return ds, spec0, spec1


def canonical_state(ds, spec0, spec1, dtype, seed: int = 0,
                    subjects: int = 20, conv: bool = True,
                    fused_conv: bool = False, **cfg_kw):
    """The canonical model and train state (conv, hidden [500], L = 32,
    M = 120, natural gradients, constrained scales) in ``dtype`` (model and
    GP), made on the card from ``seed`` as the CLI makes it (the VAE's
    precision from JAX_DEFAULT_MATMUL_PRECISION), the inducing points from a
    first batch of ``subjects``; ``conv=False`` the MLP model,
    ``fused_conv`` the fused conv stack; ``cfg_kw`` sets more fields of the
    TrainConfig (``use_pallas_chol``, ``nat_grad_f64``)."""
    import dataclasses

    from hlax_torch.data.dataset import subject_batches
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.train import step as tstep

    cfg = tstep.TrainConfig(latent_dim=32, M=120, P_tot=float(ds.P),
                            N_tot=float(len(ds)), id_covariate=2,
                            natural_gradient=True, constrain_scales=True,
                            gp_dtype=dtype, **cfg_kw)
    model_kw = {"fused_conv": True} if fused_conv else {}
    # an earlier commit's tree ([parent]) has no precision policy
    if "precision" in {f.name for f in dataclasses.fields(HLVAEConfig)}:
        from hlax_torch import precision
        model_kw["precision"] = precision.from_env()
    model = HLVAE(HLVAEConfig(layout=ds.layout, z_dim=32, h_dims=(500,),
                              y_dim=5, conv=conv, **model_kw),
                  torch.Generator(device="cuda").manual_seed(seed),
                  "cuda").to(dtype)
    return tstep.init_train_state(model, spec0, spec1,
                                  next(subject_batches(ds, subjects)), cfg,
                                  seed=seed), cfg


def _rel(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = a.detach().double(), b.detach().double()
    return ((a - b).abs().max() / b.abs().max()).item()


def _state_diff(a, b, loss_a, loss_b):
    """The largest relative differences of two runs: the loss trajectory,
    m, H, and the VAE's parameters."""
    la, lb = np.asarray(loss_a, np.float64), np.asarray(loss_b, np.float64)
    return {"loss": float((np.abs(la - lb) / np.abs(lb)).max()),
            "m": _rel(a.m, b.m), "H": _rel(a.H, b.H),
            "vae": max(_rel(p, q) for p, q in zip(a.vae.parameters(),
                                                   b.vae.parameters()))}


def _eager_spread(ds, spec0, spec1, dtype, staged, idx, eps) -> dict:
    """Two runs of the same eager steps from one seed with cuDNN's default
    algorithms: their largest relative differences, the run-to-run spread
    that the graph check's deterministic algorithms take away."""
    from hlax_torch.data.dataset import gather_batch
    from hlax_torch.train import step as tstep

    runs = []
    for _ in range(2):
        st, cfg = canonical_state(ds, spec0, spec1, dtype)
        step = tstep.make_train_step(st.vae, spec0, spec1, cfg)
        losses = [step(st, gather_batch(staged, i), eps=eps[j])["loss"]
                  for j, i in enumerate(torch.as_tensor(idx, device="cuda"))]
        runs.append((st, [x.item() for x in losses]))
    return _state_diff(runs[1][0], runs[0][0], runs[1][1], runs[0][1])


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def _graph_check(tag, ds, spec0, spec1, dtype, staged, idx, eps, unroll,
                 tmp, **state_kw):
    """From two states made from one seed, GRAPH_STEPS eager steps and the
    same steps through ``make_train_epoch``'s graphs (``unroll`` steps a
    graph), with the noise ``eps`` injected or, where it is None, drawn
    from each state's generator; the results, the launch counts and (with
    the generator) the generators' states must agree.  With the generator,
    the graph state is then saved, restored into a third state, and both
    take another epoch through graphs: they must agree too.  ``state_kw``
    goes to ``canonical_state``.  Returns the eager state, the graph state
    and their TrainConfig."""
    from hlax_torch.data.dataset import gather_batch
    from hlax_torch.train import checkpoint as ckpt
    from hlax_torch.train import step as tstep

    bound = GRAPH_BOUND[dtype]
    a, cfg = canonical_state(ds, spec0, spec1, dtype, **state_kw)
    b, _ = canonical_state(ds, spec0, spec1, dtype, **state_kw)
    if _state_diff(a, b, [1.0], [1.0])["vae"] or not torch.equal(a.H, b.H):
        fail(f"[graph] {tag}: two states made from one seed differ")
    step = tstep.make_train_step(a.vae, spec0, spec1, cfg)
    epoch = tstep.make_train_epoch(b.vae, spec0, spec1, cfg, unroll=unroll)
    idx_t = torch.as_tensor(idx, device="cuda")
    reset_all_counters()
    eager = [step(a, gather_batch(staged, i),
                  eps=None if eps is None else eps[j])["loss"]
             for j, i in enumerate(idx_t)]
    eager = [x.item() for x in eager]
    counts_eager = read_all_counters()[1]
    reset_all_counters()
    graph = epoch(b, staged, idx, eps=eps)["loss"]
    torch.cuda.synchronize()
    counts_graph = read_all_counters()[1]
    d = _state_diff(b, a, graph, eager)
    noise = "generator" if eps is None else "injected"
    print(f"[graph] {tag}, {noise} noise, unroll {unroll}: "
          f"{len(idx)} eager steps vs {len(idx)} graph steps, max "
          f"relative difference: loss {d['loss']:.3e}, m {d['m']:.3e}, H "
          f"{d['H']:.3e}, VAE parameters {d['vae']:.3e} (bound {bound:g}); "
          f"losses {graph.tolist()}; steps {a.step} and {b.step}; launches "
          f"by shape {_by_shape_str(counts_graph)}", flush=True)
    if not max(d.values()) <= bound:
        fail(f"[graph] {tag} {noise}: graph steps differ from eager steps "
             f"by {d}")
    if a.step != b.step or counts_graph != counts_eager:
        fail(f"[graph] {tag} {noise}: steps {a.step} vs {b.step}, launches "
             f"{counts_eager} vs {counts_graph}")
    if eps is not None:
        return a, b, cfg
    if not torch.equal(a.generator.get_state(), b.generator.get_state()):
        fail(f"[graph] {tag}: the generators' states differ after the "
             "steps")
    path = os.path.join(tmp, f"graph_{tag}")
    ckpt.save(path, b)
    c, _ = canonical_state(ds, spec0, spec1, dtype, seed=1, **state_kw)
    if not ckpt.restore(path, c):
        fail(f"[graph] {tag}: no checkpoint at {path}")
    epoch_c = tstep.make_train_epoch(c.vae, spec0, spec1, cfg, unroll=unroll)
    loss_b = epoch(b, staged, idx)["loss"]
    loss_c = epoch_c(c, staged, idx)["loss"]
    d = _state_diff(c, b, loss_c, loss_b)
    print(f"[graph] {tag}: a restored checkpoint's next {len(idx)} graph "
          f"steps against the saved state's: {d}", flush=True)
    if not max(d.values()) <= bound or not torch.equal(
            b.generator.get_state(), c.generator.get_state()):
        fail(f"[graph] {tag}: the restored state's steps differ by {d}")
    del c, epoch_c
    return a, b, cfg


def _time_epochs(run, epochs: int, steps: int = GRAPH_STEPS) -> float:
    """Steps/s of ``epochs`` calls of ``run`` (one epoch of ``steps`` steps
    each), host clock to a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(epochs):
        run()
    torch.cuda.synchronize()
    return epochs * steps / (time.perf_counter() - t0)


def phase_pallas_chol_false(data_dir: str, tmp: str) -> None:
    """--use_pallas_chol=False on the graph path: the library's Cholesky
    (``gp.elbo.library_chol_inv``) captured in the CUDA graphs.  In float64
    the graph steps against the eager steps at [graph]'s bound, with the
    noise injected; then one canonical float32 epoch through the graphs
    with the noise from the generator: finite losses.  Neither may launch a
    Cholesky kernel; the epoch launches the natural-gradient kernels every
    step (the flag chooses the factorizations only)."""
    from hlax_torch.data.dataset import epoch_subject_batches, stage_dataset
    from hlax_torch.ops import linalg_small as ls
    from hlax_torch.ops import natgrad
    from hlax_torch.train import step as tstep

    ds, spec0, spec1 = canonical_setup(data_dir)
    idx = np.stack(list(epoch_subject_batches(ds.P, 20,
                                              np.random.default_rng(0))))
    staged = stage_dataset(ds, torch.float64, "cuda")
    eps = torch.randn((GRAPH_STEPS, 20 * ds.T_max, 32), dtype=torch.float64,
                      device="cuda",
                      generator=torch.Generator("cuda").manual_seed(1))
    ls.reset_counters()
    with cudnn_deterministic():
        _graph_check("float64 use_pallas_chol=False", ds, spec0, spec1,
                     torch.float64, staged, idx, eps, 1, tmp,
                     use_pallas_chol=False)
    st, cfg = canonical_state(ds, spec0, spec1, torch.float32,
                              use_pallas_chol=False)
    staged = stage_dataset(ds, torch.float32, "cuda")
    epoch = tstep.make_train_epoch(st.vae, spec0, spec1, cfg)
    natgrad.reset_counters()
    losses = epoch(st, staged, idx)["loss"]
    torch.cuda.synchronize()
    print(f"[fusion] use_pallas_chol=False: a canonical float32 epoch on "
          f"the graph path: losses {losses.tolist()}; Cholesky kernel "
          f"launches {dict(ls.LAUNCHES)}; natural-gradient kernel launches "
          f"{dict(natgrad.LAUNCHES)}", flush=True)
    _need("fusion use_pallas_chol=False", natgrad.LAUNCHES_BY_SHAPE,
          natgrad_need(32, 20, 20, 120, "float32", "float32", GRAPH_STEPS))
    if not np.isfinite(losses).all():
        fail(f"[fusion] use_pallas_chol=False: non-finite loss {losses}")
    if any(ls.LAUNCHES.values()) or any(ls.PLAIN_CUDA_CALLS.values()) or \
            any(natgrad.PLAIN_CUDA_CALLS.values()):
        fail(f"[fusion] use_pallas_chol=False launched a Cholesky kernel "
             f"or a plain version: {ls.LAUNCHES} {ls.PLAIN_CUDA_CALLS} "
             f"{natgrad.PLAIN_CUDA_CALLS}")


# [fusion]: a float64 kernel's results against its plain version's,
# relative to the largest entry (two summation orders in double); a float32
# kernel's error against the plain version in float64 on the same inputs
# at most 4x the float32 plain version's own, plus 1e-6 of the largest entry
FUSION_F64_REL = 1e-10
FUSION_F32_FACTOR, FUSION_F32_ABS = 4.0, 1e-6
# the hlax function each fused kernel stands for
FUSION_REPLACES = {
    "heads_cat": "hlax/ops/likelihoods.py:122 loglik_cat with "
                 "hlax/models/hlvae.py:327-375 _head, theta_estimation "
                 "(XLA fusion)",
    "heads_real": "hlax/ops/likelihoods.py:47 loglik_real with "
                  "hlax/models/hlvae.py:327-375 _head, theta_estimation "
                  "(XLA fusion)",
    "rep_image": "hlax/models/hlvae.py:251 encode with "
                 "hlax/ops/normalization.py:41 batch_normalization "
                 "(XLA fusion)",
    "recon_metric": "hlax/train/step.py:210 recon_metric (XLA fusion)",
    "gp_kernel": "hlax/gp/kernels.py:152 kernel_matrix (XLA fusion)",
}
# operations an element (a variable of a row, an entry of a kernel
# matrix) of each kernel, counted from its source: multiply-adds as two,
# exp, log and divisions as one.  The GP kernels' at the canonical spec0
# (3 rbf factors, 2 cat), in float: forward 10 an rbf factor (a - b, the
# quotient by ls from its reciprocal and two multiply-adds, the square,
# the half, exp, the product), 3 a cat (compare, select, product), 1 a
# component, 2 for the masks; the backward with x2's gradient (the column
# kernel) the same factors, G times its mask (2), 2 a component (G k and
# its sum) and 4 an rbf factor (G k d, two sums, d times it)
FUSION_OPS = {"heads_cat_fwd": 70, "heads_cat_bwd": 175,
              "heads_real_fwd": 30, "heads_real_bwd": 50,
              "rep_image_fwd": 8, "rep_image_bwd": 12, "recon_metric": 20,
              "recon_metric_finish": 10,
              "gp_kernel_fwd": 41, "gp_kernel_bwd": 56}


def _fusion_case(ds, spec0, spec1, dtype):
    """The canonical state in ``dtype``, its first batch of 20 subjects and
    the decoder features of the batch's encoder means; the same of an MLP
    model, with the batch's moments, and of an MLP model with the logvar
    network (D4's types laid out for it: the real group's theta and theta
    mask twice as wide)."""
    from hlax_torch.data.dataset import gather_batch, stage_dataset
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.ops.normalization import batch_normalization
    from hlax_torch.types import compile_layout

    from hlax_torch.gp import kernels as gp_kernels

    st, cfg = canonical_state(ds, spec0, spec1, dtype)
    staged = stage_dataset(ds, dtype, "cuda")
    batch = gather_batch(staged, torch.arange(20, device="cuda"))
    # the MLP model ([mlp]'s, hidden [500]) on the same batch, and the
    # batch normalization's moments its real head de-normalizes by
    mlp = HLVAE(HLVAEConfig(layout=ds.layout, z_dim=32, h_dims=(500,),
                            y_dim=5, conv=False),
                torch.Generator(device="cuda").manual_seed(1),
                "cuda").to(dtype)
    lay_lv = compile_layout(ds.layout.types_dict, logvar_network=True)
    mlp_lv = HLVAE(HLVAEConfig(layout=lay_lv, z_dim=32, h_dims=(500,),
                               y_dim=5, conv=False, logvar_network=True),
                   torch.Generator(device="cuda").manual_seed(2),
                   "cuda").to(dtype)
    # the theta mask of that layout: each theta column's raw column's mask
    raw_of = lay_lv.expand_raw_to_theta(
        np.arange(lay_lv.n_raw, dtype=np.float64)[None])[0]
    tmask_lv = batch["mask"][:, torch.as_tensor(raw_of, dtype=torch.int64,
                                                device="cuda")]
    with torch.no_grad():
        mu, log_var = st.vae.encode(batch["data"], batch["mask"])
        y = st.vae.decode_y(mu)
        y_mlp = mlp.decode_y(mlp.encode(batch["data"], batch["mask"])[0])
        y_lv = mlp_lv.decode_y(mlp_lv.encode(batch["data"],
                                             batch["mask"])[0])
    _, norm = batch_normalization(batch["data"], batch["mask"], ds.layout,
                                  False)
    noise = gp_kernels.noise_value(st.raw_noise, cfg.constrain_scales)
    return dict(vae=st.vae, k0=st.k0, k1=st.k1, zt=st.zt, batch=batch, y=y,
                specs=(spec0, spec1), mlp=mlp, y_mlp=y_mlp,
                norm_mlp=norm, mlp_lv=mlp_lv, y_lv=y_lv, tmask_lv=tmask_lv,
                m=st.m.detach(), H=st.H.detach(), noise=noise.detach(),
                eps=cfg.eps, mu=mu, log_var=log_var)


def _case_in_float64(c):
    import copy

    d = lambda t: None if t is None else t.detach().double()
    return dict(vae=copy.deepcopy(c["vae"]).double(),
                k0=[{k: d(v) for k, v in p.items()} for p in c["k0"]],
                k1=[{k: d(v) for k, v in p.items()} for p in c["k1"]],
                zt=d(c["zt"]), y=d(c["y"]),
                batch={k: d(v) for k, v in c["batch"].items()},
                specs=c["specs"], mlp=copy.deepcopy(c["mlp"]).double(),
                y_mlp=d(c["y_mlp"]),
                norm_mlp=type(c["norm_mlp"])(*map(d, c["norm_mlp"])),
                mlp_lv=copy.deepcopy(c["mlp_lv"]).double(),
                y_lv=d(c["y_lv"]), tmask_lv=d(c["tmask_lv"]),
                **{k: d(c[k]) for k in ("m", "H", "noise", "mu", "log_var")},
                eps=c["eps"])


def _cotangent(shape, dtype):
    return torch.randn(shape, generator=torch.Generator("cuda").manual_seed(
        9), device="cuda", dtype=torch.float64).to(dtype)


def _op_heads(c, plain, grads=True, mlp=False, fusion=None, rows=None):
    """``mlp``: the MLP model's heads, or "logvar" those of the MLP model
    with the logvar network; ``fusion``: the module whose op runs (the
    parent tree's in ``_staged_against_parent``), else
    hlax_torch.ops.fusion; ``rows``: the batch's first rows only (a mesh
    rank's batch)."""
    if fusion is None:
        from hlax_torch.ops import fusion
    from hlax_torch.ops.normalization import NormParams

    b = c["batch"]
    m, y0, tmask = {False: (c["vae"], c["y"], b["theta_mask"]),
                    True: (c["mlp"], c["y_mlp"], b["theta_mask"]),
                    "logvar": (c["mlp_lv"], c["y_lv"], c["tmask_lv"])}[mlp]
    cut = (lambda t: t[:rows]) if rows is not None else (lambda t: t)
    y = cut(y0).detach().clone().requires_grad_(grads)
    norm = c["norm_mlp"] if mlp else NormParams(None, None, None, None)
    fn = fusion.heads_loglik_plain if plain else fusion.heads_loglik
    with torch.set_grad_enabled(grads):
        lp, lpm, par, theta = fn(m, y, cut(tmask), cut(b["data"]),
                                 cut(b["mask"]), norm)
        outs = [lp, lpm, theta] + [t for p in par for t in (
            p if isinstance(p, tuple) else (p,))]
        if not grads:
            return outs, []
        # the train step's cotangent: the row sums of the nll (the logvar
        # network's model has no log_vy)
        return outs, list(torch.autograd.grad(
            -lp.sum(dim=1).sum(),
            [y] + list(m.obs.values())
            + [p for p in (m.log_vy_real,) if p is not None]))


def _op_rep(c, plain, grads=True, fusion=None, rows=None):
    """``fusion`` and ``rows`` as ``_op_heads``'s."""
    if fusion is None:
        from hlax_torch.ops import fusion

    m, b = c["vae"], c["batch"]
    cut = (lambda t: t[:rows]) if rows is not None else (lambda t: t)
    fn = fusion.rep_image_plain if plain else fusion.rep_image
    with torch.set_grad_enabled(grads):
        img = fn(m, cut(b["data"]), cut(b["mask"]))
        if not grads:
            return [img], []
        ps = list(m.rep_w.values()) + list(m.rep_b.values())
        return [img], list(torch.autograd.grad(
            (img * _cotangent(img.shape, img.dtype)).sum(), ps))


class _OneRankSums:
    """A mesh's sums (``MeshSums``) on a mesh of one rank: the recon
    metric's mesh path, its column sums taken out between its passes."""

    def subjects(self, x):
        return x.clone()

    def subjects_max(self, x):
        return x.clone()


def _op_recon(c, plain, grads=True, mlp=False, sums=None, rows=None,
              fusion=None):
    """The metric of the case's batch, or of its first ``rows`` rows (a
    mesh rank's batch); ``fusion`` as ``_op_heads``'s."""
    if fusion is None:
        from hlax_torch.ops import fusion
    from hlax_torch.ops.normalization import NormParams

    m, b = c["mlp" if mlp else "vae"], c["batch"]
    lay = m.cfg.layout
    key = "params_mlp" if mlp else "params"
    if key not in c:
        with torch.no_grad():
            c[key] = fusion.heads_loglik_plain(
                m, c["y_mlp" if mlp else "y"], b["theta_mask"], b["data"],
                b["mask"], c["norm_mlp"] if mlp else
                NormParams(None, None, None, None))[2]
    kinds_raw = lay.var_kinds_grouped()[np.asarray(lay.raw_inv)]
    last = list(dict.fromkeys(kinds_raw))[-1]
    rv = b["valid"].reshape(-1).to(b["mask"].dtype)
    params, data, mask = c[key], b["data"], b["mask"]
    if rows is not None:
        cut = lambda t: t[:rows]
        params = [tuple(map(cut, p)) if isinstance(p, tuple) else cut(p)
                  for p in params]
        rv, data, mask = rv[:rows], data[:rows], mask[:rows]
    fn = fusion.recon_metric_plain if plain else fusion.recon_metric
    return list(fn(lay, not mlp, params, data, mask, rv, last, sums)), []


def _op_gp(which):
    def run(c, plain, grads=True, fusion=None):
        """``fusion``: the module whose op runs (the parent tree's in
        ``_gp_against_parent``), else hlax_torch.ops.fusion."""
        if fusion is None:
            from hlax_torch.ops import fusion

        spec0, spec1 = c["specs"]
        b = c["batch"]
        valid = b["valid"]
        S, T = valid.shape
        x = b["labels"].reshape(S, T, -1)
        spec, ps = (spec1, c["k1"]) if which == "K1_st" else (spec0, c["k0"])
        ps = [{k: v.detach().clone().requires_grad_(grads)
               for k, v in p.items()} for p in ps]
        z = c["zt"].detach().clone().requires_grad_(grads)
        fn = fusion.gp_kernel_matrix_plain if plain else \
            fusion.gp_kernel_matrix
        with torch.set_grad_enabled(grads):
            if which == "K0xz":
                out = fn(spec, ps, x, z, x2_batched=True, row_mask=valid)
            elif which == "K0zz":
                out = fn(spec, ps, z, z, x1_batched=True, x2_batched=True)
            else:
                out = fn(spec, ps, x, x, row_mask=valid, col_mask=valid)
            if not grads:
                return [out], []
            leaves = [v for p in ps for v in p.values()]
            inputs = leaves + ([z] if which in ("K0xz", "K0zz") else [])
            return [out], list(torch.autograd.grad(
                (out * _cotangent(out.shape, out.dtype)).sum(), inputs))
    return run


# a rank's rows on [mesh]'s 2 x 2 mesh: 10 subjects of 20
MESH_RANK_ROWS = 200
FUSION_OPS_RUN = {"heads": _op_heads, "rep_image": _op_rep,
                  "recon_metric": _op_recon,
                  # the metric's mesh path (its column sums handed to the
                  # mesh between its launches) at a [mesh] rank's rows
                  "recon_metric mesh": functools.partial(
                      _op_recon, sums=_OneRankSums(), rows=MESH_RANK_ROWS),
                  **{f"gp {w}": _op_gp(w) for w in
                     ("K0xz", "K0zz", "K1_st", "K0_st")}}
# the same kernels on the other main paths' inputs, held to their plain
# versions but not timed again: the MLP's heads (the real head
# de-normalized by the batch's moments; with and without the logvar
# network) and metric, alone and on the mesh path, the conv model's
# metric's mesh path over the whole batch, and the heads and the
# representation at a [mesh] rank's rows
FUSION_OPS_HELD = {
    "heads mlp": functools.partial(_op_heads, mlp=True),
    # the real head's logvar-network kernels (LV = true) at the canonical
    # width
    "heads mlp logvar": functools.partial(_op_heads, mlp="logvar"),
    "heads mesh": functools.partial(_op_heads, rows=MESH_RANK_ROWS),
    "rep_image mesh": functools.partial(_op_rep, rows=MESH_RANK_ROWS),
    "recon_metric mlp": functools.partial(_op_recon, mlp=True),
    "recon_metric mesh 400": functools.partial(_op_recon,
                                               sums=_OneRankSums()),
    "recon_metric mlp mesh": functools.partial(_op_recon, mlp=True,
                                               sums=_OneRankSums())}
# the kernels [fusion] also times with the L2 cold (COLD_BYTES written
# between launches): the staged kernels and the mesh's finish
COLD_ENTRIES = ("heads_cat_fwd", "heads_cat_bwd", "heads_real_fwd",
                "heads_real_bwd", "rep_image_bwd", "recon_metric",
                "recon_metric_finish")


def _fusion_error(tag, got, plain, ref):
    """The largest error of the kernel's results ``got``: against the
    plain version's in float64 (``ref`` None), else against ``ref``; fails
    past the bars."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, plain)):
        r = b if ref is None else ref[i]
        scale = r.abs().max().item() or 1.0
        err = (a.double() - r.double()).abs().max().item()
        worst = max(worst, err)
        if ref is None:
            if not err <= FUSION_F64_REL * scale:
                fail(f"[fusion] {tag} result {i}: float64 kernel differs "
                     f"from its plain version by {err:.3e} (largest entry "
                     f"{scale:.3e})")
        else:
            own = (b.double() - r.double()).abs().max().item()
            if not err <= FUSION_F32_FACTOR * own + FUSION_F32_ABS * scale:
                fail(f"[fusion] {tag} result {i}: float32 kernel's error "
                     f"{err:.3e} against float64 exceeds 4x its plain "
                     f"version's {own:.3e} + 1e-6 x {scale:.3e}")
    return worst


def _fusion_shape(entry, like, args):
    """(elements, bytes) of one launch of a fused kernel, each input read
    once and each output written once: the heads, the representation and
    the metric by their group's columns (they take the full-width arrays;
    d, Y and C from the group's weights or its column arguments), the
    others by every array they are handed but their scratch (the GP
    kernel matrix an element an entry, the metric's finish a column)."""
    z = like.element_size()
    # the nll's cotangent of lp: one value a row, broadcast over the columns
    g_row = any(torch.is_tensor(a) and a.dim() == 2 and a.stride(1) == 0
                for a in args)
    B = like.shape[0]
    if entry.startswith("heads_"):
        d, Y, k = args[2].shape           # the group's head weights
        cat = entry.startswith("heads_cat")
        C = k + 1 if cat else 1
        # y, the weights, the data, the mask (the real head: its log_vy)
        n = B * d * Y + d * Y * k + d * k + B * d * C + B * d + (0 if cat
                                                                 else d)
        if entry.endswith("fwd"):   # lp, lpm, theta, log_pi or mean (, var)
            n += 2 * B * d + (2 * B * d * C if cat else 2 * B * d + d)
        else:   # the theta mask, the cotangent, dy and the weights' grads
            n += (B * d * C + (B if g_row else B * d) + B * d * Y + d * Y * k
                  + d * k + (0 if cat else d))
        return B * d, n * z
    if entry == "rep_image_fwd":      # data, mask, w, b, perm; the image
        d, C = args[8], args[13]
        return B * d, (B * d * max(C, 1) + 2 * B * d + d * C + d) * z + 8 * d
    if entry == "rep_image_bwd":      # data, mask, perm, the image's grad
        d, C = args[10], args[15]
        return B * d, (B * d * C + 2 * B * d + d * C + d) * z + 8 * d
    if entry == "recon_metric":       # every group: data, mask, log_pi or
        table = list(args[1])         # mean; the rows; the column sums
        n_cols = n = 0                # (double) where they are its output
        for k in range(args[3]):
            d, C = table[7 * k + 2], table[7 * k + 4]
            n_cols += d
            n += (2 * B * d * max(C, 1) + B * d) * z
        n += B * z + (40 * n_cols if args[10] is None else 2 * z)
        return B * n_cols, n
    n = sum(a.numel() * a.element_size() for a in args
            if torch.is_tensor(a) and not getattr(a, "_scratch", False))
    return (like.numel() if entry.startswith("gp") else args[-1]), n


def _time_fused(name, op, c, dtype, errs):
    """Device times of every kernel ``op`` launches (forward and backward,
    one call recorded, each launch timed alone, its counters put back;
    a kernel launched once a group summed over its launches), of the op's
    plain version (forward; forward and backward), and the table rows; the
    launches the timing makes are not counted."""
    from hlax_torch.ops import fusion

    calls, orig = [], fusion._launch

    def record(entry, like, *args):
        calls.append((entry, like, args))
        orig(entry, like, *args)

    before = fusion._COUNTERS.snapshot()
    fusion._launch = record
    try:
        op(c, False)
    finally:
        fusion._launch = orig
    fwd_ms = time_ms(lambda: op(c, True, grads=False), reps=10)[0]
    both_ms = time_ms(lambda: op(c, True), reps=10)[0]
    rows, by_entry = [], {}
    for entry, like, args in calls:
        by_entry.setdefault((entry, tuple(like.shape)), []).append(
            (like, args))
    for (entry, shape), launches in by_entry.items():
        ms = wall = elems = n = 0.0
        cold = 0.0 if entry in COLD_ENTRIES else None
        for like, args in launches:
            t, w = time_ms(lambda: orig(entry, like, *args))
            e, b = _fusion_shape(entry, like, args)
            ms, wall, elems, n = ms + t, wall + w, elems + e, n + b
            if cold is not None:
                cold += time_cold_ms(lambda: orig(entry, like, *args))
        nbytes = n
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = FUSION_OPS[entry] * elems / PEAK_FLOPS[dtype] * 1e3
        bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops else
                     (t_ops, "operations"))
        bwd = entry.endswith("bwd")
        plain = max(both_ms - fwd_ms, 0.0) if bwd else fwd_ms
        family = entry.rsplit("_", 1)[0] if entry[-3:] in ("fwd", "bwd") \
            else "recon_metric" if entry.startswith("recon") else entry
        rows.append(dict(
            name=f"{entry}_cuda", shape=list(shape),
            dtype=str(dtype).removeprefix("torch."), route="cuda",
            source="hlax_torch/csrc/fusion.cu",
            replaces=FUSION_REPLACES[family], launches=0,
            max_abs_err=errs[1 if bwd else 0], ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=None))
        cold_txt = (f", L2-cold {cold:.4f} ms ({COLD_BYTES >> 20} MB "
                    f"written between launches)" if cold is not None
                    else "")
        print(f"[fusion] {entry} {list(shape)} {rows[-1]['dtype']} "
              f"({name}, {len(launches)} launch(es)): kernel {ms:.4f} ms"
              f"{cold_txt} ({wall:.4f} ms a call on the host "
              f"clock), the op's plain chain "
              f"{'backward' if bwd else 'forward'} {plain:.4f} ms, bound "
              f"{bound:.5f} ms ({by}: {nbytes / 1e6:.2f} MB)", flush=True)
    fusion._COUNTERS.take_since(before)
    return rows


GP_BOUND_REPLACES = ("hlax/gp/elbo.py:154-235 kld_upper_bound's terms, "
                     "their sums and kld_total (XLA fusion)")
# which arguments (after the itemsize) of each bound kernel's C entry are
# factors it reads only the diagonal of (LB; LK0zz and LH)
GP_BOUND_DIAG_ARGS = {"gp_bound_fwd_subjects": (4,),
                      "gp_bound_fwd_latents": (7, 8),
                      "gp_bound_bwd_latents": (12, 13),
                      "gp_bound_bwd_subjects": (9,)}


def _gp_bound_ops(entry, L, S, T, M, staged=True) -> float:
    """Operations of one launch of a bound kernel, counted from its source
    (a multiply-add as two): K1 the fit, (iB + iB^T) r, u, the sums and,
    staged, iB K0xz; K2 three products and sums an entry of the [M, M]
    matrices; K4 about 16 an entry and d m's product; K3 w_A q iKm^T, the
    elementwise rest and, staged, iB (K0xz G^T), iB^T (K0xz G), (K0xz G)
    K0xz^T and iLB (d iB + d iB^T) (unstaged, those are cuBLAS's)."""
    if entry == "gp_bound_fwd_subjects":
        return L * S * (4 * T * M + 6 * T * T + 10 * T
                        + staged * 2 * T * T * M)
    if entry == "gp_bound_fwd_latents":
        return L * (6 * M * M + 6 * M)
    if entry == "gp_bound_bwd_latents":
        return L * 18 * M * M
    return L * S * (2 * T * M + 12 * T * T
                    + staged * (6 * T * T * M + 2 * T ** 3))


# the unstaged subject kernels' (subjects past TP rows) own traffic, by
# argument of the C entry: what they leave to cuBLAS (K1: W and the double
# copies; K3: K0xz, iLB and K0xz [G | G^T]) and what they read and write
# (K3: cuBLAS's products in d K0xz, which it finishes in place; it reads
# cuBLAS's (K0xz G) K0xz^T from d iLB's buffer and writes sym, each once)
GP_BOUND_UNSTAGED = {"gp_bound_fwd_subjects": ((9, 10, 11), ()),
                     "gp_bound_bwd_subjects": ((5, 7, 15), (17,))}
# which arguments of a bound kernel's C entry are double copies of float32
# inputs, made so the terms' sums cancel in double: K1 writes K0xz and
# iB K0xz in double (10, 11), which the function itself needs not at all
# (``own``, what a bound counts: K0xz and W count already; without it, as
# K1 writes them), and K2 reads KziBK (2) once at the inputs' width
GP_BOUND_COPY_ARGS = {"gp_bound_fwd_subjects": (10, 11),
                      "gp_bound_fwd_latents": (2,)}


def _gp_bound_bytes(entry, args, own: bool = False) -> int:
    """Bytes of one launch of a bound kernel: each tensor it is handed read
    or written once but its scratch, the factors of GP_BOUND_DIAG_ARGS by
    their diagonal, K2's double KziBK at the inputs' width (``args[0]``:
    their itemsize), K1's double copies as it writes them or, ``own``, not
    at all (the function's own traffic); unstaged (``args[-2]`` 0),
    GP_BOUND_UNSTAGED's."""
    skip, twice = ((), ())
    if entry in GP_BOUND_UNSTAGED and not args[-2]:
        skip, twice = GP_BOUND_UNSTAGED[entry]
    n = 0
    for i, a in enumerate(args):
        if not torch.is_tensor(a) or i in skip:
            continue
        b = a.numel() * a.element_size()
        if i in twice:
            n += 2 * b
            continue
        if getattr(a, "_scratch", False):
            continue
        if i in GP_BOUND_COPY_ARGS.get(entry, ()):
            if entry == "gp_bound_fwd_latents":
                b = a.numel() * args[0]
            elif own:
                b = 0
        n += b // a.shape[-1] if i in GP_BOUND_DIAG_ARGS[entry] else b
    return n


def _gp_bound_case(c):
    """The bound's inputs on the case's batch, as the train step makes
    them: ``subject_blocks`` of the case's GP (the kernels, no gradient),
    the factor of H, m, the encoder's means and log-variances; padded by
    ``pad_subjects``.  Returns (the 11 leaves of ``gp_bound._GpBound``,
    valid)."""
    from hlax_torch.gp import elbo

    b = c["batch"]
    valid = pad_subjects(b["valid"].clone())
    S, T = valid.shape
    spec0, spec1 = c["specs"]
    x = b["labels"].reshape(S, T, -1) * valid[..., None]
    with torch.no_grad():
        blk, (LH, _) = elbo.subject_blocks(
            spec0, c["k0"], spec1, c["k1"], c["noise"], c["zt"], x, valid,
            c["eps"], extra_spd=c["H"], use_pallas_chol=True)
    mu = c["mu"].reshape(S, T, -1) * valid[..., None]
    leaves = [blk.K0xz, blk.iLB, blk.LB, blk.K0_st, blk.iK0zz, blk.LK0zz,
              LH, c["H"], c["m"], mu, c["log_var"].reshape(S, T, -1)]
    return [t.detach().contiguous() for t in leaves], valid


# the seeds of the one-ulp perturbations whose largest movement of the
# plain version sets the float64 bars beside 1e-10 of the largest entry
SPREAD_SEEDS = (11, 12, 13)
GP_BOUND_OUTS = ("terms", "P_batch", "kld_total")
GP_BOUND_LEAVES = ("K0xz", "iLB", "LB", "K0_st", "iK0zz", "LK0zz", "LH", "H",
                   "m", "mu", "log_v")


def _one_ulp(case, seed: int):
    """The case's leaves each moved by one unit in the last place (a random
    sign an entry, from ``seed``): the plain version's float64 outputs move
    by their own rounding scale (the bound's terms and its B blocks'
    gradients cancel by up to 1e6-fold at the canonical float64 state,
    jitter 1e-6)."""
    leaves, valid = case
    g = torch.Generator(leaves[0].device).manual_seed(seed)
    ulp = lambda t: t * (1 + torch.finfo(t.dtype).eps * (2 * torch.randint(
        0, 2, t.shape, generator=g, device=t.device).to(t.dtype) - 1))
    return [ulp(t) for t in leaves], valid


def _gp_bound_error(tag, names, got, plain, ref, spreads):
    """The largest error of the bound kernels' results ``got`` (``names``),
    each printed beside its bar; fails past a bar.  float32 (``ref``, the
    plain version in float64): within 4x the float32 plain version's own
    error + 1e-6 of the largest entry, ``_fusion_error``'s bar.  float64:
    against the plain version, within 1e-10 of the largest entry or, where
    larger, 4x the plain version's own movement under a one-ulp change of
    its inputs, the largest over ``spreads`` (one a seed)."""
    worst = 0.0
    for i, name in enumerate(names):
        a, b = got[i].double(), plain[i].double()
        if ref is None:
            scale = b.abs().max().item() or 1.0
            err = (a - b).abs().max().item()
            own = max((s[i].double() - b).abs().max().item()
                      for s in spreads)
            rel = FUSION_F64_REL * scale
            bar = max(rel, FUSION_F32_FACTOR * own)
            how = (f"against the plain version; 1e-10 of the largest entry "
                   f"{rel:.3e} {'met' if err <= rel else 'NOT met'}; bar "
                   f"{bar:.3e}, the larger of that and 4x the plain "
                   f"version's movement {own:.3e} under a one-ulp change "
                   f"of its inputs (largest of seeds {SPREAD_SEEDS})")
        else:
            r = ref[i].double()
            scale = r.abs().max().item() or 1.0
            err = (a - r).abs().max().item()
            own = (b - r).abs().max().item()
            bar = FUSION_F32_FACTOR * own + FUSION_F32_ABS * scale
            how = (f"against float64; bar {bar:.3e} = 4x the float32 plain "
                   f"version's {own:.3e} + 1e-6 x {scale:.3e}")
        worst = max(worst, err)
        print(f"[{tag} {name}: error {err:.3e} ({err / scale:.2e} of the "
              f"largest entry) {how}", flush=True)
        if not err <= bar:
            fail(f"[{tag} {name}: kernel's error {err:.3e} past its bar "
                 f"{bar:.3e}")
    return worst


def pad_subjects(valid):
    """``valid`` [S, T] padded in place as the bound's checks pad it: one
    subject from row T // 2 (inside a row tile at T = 13, 200 and 500) and
    subject min(2, S - 1) all padding.  The partly padded subject is 1, or
    0 where S = 2, so that two subjects keep both edges."""
    S, T = valid.shape
    valid[1 if S > 2 else 0, T // 2:] = 0
    valid[min(2, S - 1)] = 0
    return valid


def bound_case(L, S, T, M, dtype, seed: int = 0):
    """A synthetic state of the bound's inputs on the card from ``seed``
    (what ``[fusion]``'s sweeps and parent turns, ``tools/gp_bound_phases.py``
    and ``tests/test_torch_cuda.py``'s bound tests run on): rbf kernel
    matrices of random covariates and inducing points, their factors, a
    random SPD H, m, mu and log_v; padded by ``pad_subjects``.  Returns
    (the 11 leaves of ``gp_bound._GpBound``, valid)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    f64 = dict(dtype=torch.float64, device="cuda")
    x = torch.randn((S, T, 1), generator=gen, **f64)
    z = 1.5 * torch.randn((L, M, 1), generator=gen, **f64)
    valid = pad_subjects(torch.ones((S, T), **f64))
    vo = valid[:, :, None] * valid[:, None, :]
    rbf = lambda a, b: torch.exp(-0.5 * (a - b.mT) ** 2)
    K0xz = rbf(x[None], z[:, None]) * valid[None, :, :, None]
    K0zz = rbf(z, z) + 1e-3 * torch.eye(M, **f64)
    LK = torch.linalg.cholesky(K0zz)
    iLK = torch.linalg.solve_triangular(LK, torch.eye(M, **f64), upper=False)
    B = (0.5 * rbf(x, x) * vo).expand(L, S, T, T) + torch.eye(T, **f64) * (
        0.3 * valid + (1 - valid))[None, :, :, None]
    LB = torch.linalg.cholesky(B)
    iLB = torch.linalg.solve_triangular(LB, torch.eye(T, **f64).expand_as(B),
                                        upper=False)
    K0st = (rbf(x, x) * vo).expand(L, S, T, T).contiguous()
    a = 0.1 * torch.randn((L, M, M), generator=gen, **f64)
    H = a @ a.mT + 0.5 * torch.eye(M, **f64)
    leaves = [K0xz, iLB, LB, K0st, iLK.mT @ iLK, LK,
              torch.linalg.cholesky(H), H,
              torch.randn((L, M, 1), generator=gen, **f64),
              torch.randn((S, T, L), generator=gen, **f64) * valid[..., None],
              0.3 * torch.randn((S, T, L), generator=gen, **f64)]
    return [t.to(dtype).contiguous() for t in leaves], valid.to(dtype)


# the natural-gradient chain's kernels: the XLA fusions of hlax they stand
# for, by C entry
NATGRAD_REPLACES = {
    "natgrad_fwd_subjects": "hlax/gp/elbo.py:241-243 ng_P1 = K0xz^T iB mu "
                            "(XLA fusion)",
    "natgrad_fwd_latents": "hlax/gp/elbo.py:272-282 B_mat, grad_m, grad_H "
                           "(XLA fusion)",
    "natgrad_update_pre": "hlax/gp/elbo.py:459-463,465-468 iH_new and the "
                          "update's right-hand side (XLA fusion)",
    "natgrad_update_finish": "hlax/gp/elbo.py:454,464-469 H_new = iLA^T iLA, "
                             "m_new, the casts (XLA fusion)"}
NATGRAD_LR, NATGRAD_JITTER = 0.01, 1e-3
NATGRAD_OUTS = ("ng_P1", "grad_m", "grad_H", "iH_new", "rhs", "m_new",
                "H_new")


def natgrad_case(L, S, T, M, dtype, chain=None, seed: int = 0) -> dict:
    """``bound_case``'s state with the natural-gradient chain's inputs on
    the card, each kernel's made in float64 from the one before it by the
    plain versions, then cast: K5's (iB, mu, valid, K0xz) in ``dtype``,
    K6's (X = iLK^T (iLK + C_w iLK), as ``natgrad.fwd_latents`` forms it,
    iK, iH, ng_P1) in the chain's dtype (``chain``, default ``dtype``) with the state's m in ``dtype``, K7's
    (iH, grad_H, grad_m, m), K8's (iLA, the inverse factor of K7's iH_new,
    and rhs); "state" the dtype of (m, H)."""
    from hlax_torch.ops import natgrad as ng

    d = torch.float64
    (K0xz, iLB, _, _, iK, LK, LH, _, m, mu, _), valid = bound_case(
        L, S, T, M, d, seed)
    eye = torch.eye(M, dtype=d, device="cuda")
    iB = torch.einsum("lskt,lsku->lstu", iLB, iLB)
    iLK = torch.linalg.solve_triangular(LK, eye.expand_as(LK), upper=False)
    iH = torch.cholesky_inverse(LH)
    G = torch.einsum("lstu,lsun->lstn", iLB,
                     torch.einsum("lstm,lnm->lstn", K0xz, iLK))
    X = torch.bmm(iLK.mT, torch.baddbmm(
        iLK, torch.einsum("lstm,lstn->lmn", G, G), iLK))
    ngP1 = ng.fwd_subjects_plain(iB, mu, valid, K0xz, d)
    gm, gH = ng.latents_plain(X, iK, iH, ngP1, m)
    iHn, rhs = ng.update_pre_plain(iH, gH, gm, m, NATGRAD_LR, 0.0)
    iLA = torch.linalg.solve_triangular(torch.linalg.cholesky(iHn),
                                        eye.expand_as(iHn), upper=False)
    c = chain or dtype
    sub = lambda *ts: tuple(t.to(dtype).contiguous() for t in ts)
    ch = lambda *ts: tuple(t.to(c).contiguous() for t in ts)
    return dict(subjects=sub(iB, mu, valid, K0xz), chain=c, state=dtype,
                latents=ch(X, iK, iH, ngP1) + sub(m),
                pre=ch(iH, gH, gm) + sub(m), finish=ch(iLA, rhs))


def natgrad_case64(case) -> dict:
    """The case's inputs in float64 (the float32 kernels' reference)."""
    d = lambda ts: tuple(t.double() for t in ts)
    return dict(subjects=d(case["subjects"]), chain=torch.float64,
                state=torch.float64, latents=d(case["latents"]),
                pre=d(case["pre"]), finish=d(case["finish"]))


def natgrad_run(case, kernel: bool, jitter: float = 0.0):
    """The four kernels' results on ``case`` (NATGRAD_OUTS), each on its
    own inputs: through the wrappers (``kernel``: one launch each) or their
    plain versions."""
    from hlax_torch.ops import natgrad as ng

    c = case
    if kernel:
        out = [ng.fwd_subjects(*c["subjects"], c["chain"])]
        out += ng.latents(*c["latents"])
        out += ng.update_pre(*c["pre"], NATGRAD_LR, jitter)
        return out + list(ng.update_finish(*c["finish"], c["state"]))
    out = [ng.fwd_subjects_plain(*c["subjects"], c["chain"])]
    out += ng.latents_plain(*c["latents"])
    out += ng.update_pre_plain(*c["pre"], NATGRAD_LR, jitter)
    return out + list(ng.update_finish_plain(*c["finish"], c["state"]))


# which outputs (NATGRAD_OUTS) each natural-gradient kernel writes
NATGRAD_OUT_OF = {"natgrad_fwd_subjects": slice(0, 1),
                  "natgrad_fwd_latents": slice(1, 3),
                  "natgrad_update_pre": slice(3, 5),
                  "natgrad_update_finish": slice(5, 7)}


def _natgrad_cost(entry, args):
    """(bytes, operations) of one launch of a natural-gradient kernel: each
    tensor it is handed read or written once (K8's iLA by its lower
    triangle, the one the function needs), and its multiply-adds as two
    (K5 K0xz^T times iB mu, and iB mu itself unless cuBLAS made it; K6 and
    K7 a few an entry of the [M, M] matrices and their row sums; K8 the
    lower triangle's products, M^3 / 6 multiply-adds a latent (H_new is
    symmetric), and m_new)."""
    n = 0
    for i, a in enumerate(args):
        if not torch.is_tensor(a):
            continue
        b = a.numel() * a.element_size()
        if entry == "natgrad_update_finish" and i == 2:
            M = a.shape[-1]
            b = b * (M + 1) // (2 * M)
        n += b
    if entry == "natgrad_fwd_subjects":
        L, S, T, M = args[8:12]
        return n, 2 * L * S * T * (M + (T if args[2] is not None else 0))
    # L and M by argument of the C entry (after the two itemsizes' pair)
    L, M = args[{"natgrad_fwd_latents": slice(9, 11),
                 "natgrad_update_pre": slice(8, 10),
                 "natgrad_update_finish": slice(6, 8)}[entry]]
    if entry == "natgrad_fwd_latents":
        return n, 9 * L * M * M
    if entry == "natgrad_update_pre":
        return n, 7 * L * M * M
    return n, L * (M ** 3 // 3 + 2 * M * M)


def _natgrad_fusion(shape, dtype, chain=None, rows: bool = True):
    """[fusion]'s natural-gradient kernels on ``natgrad_case``'s state at
    ``shape`` [L, S, T, M]: each kernel against its plain version
    (``_fusion_error``: float64 within 1e-10 of the largest entry; float32
    inputs within 4x the plain version's error against float64 + 1e-6),
    without and with K7's jitter, H_new exactly symmetric; then each launch
    timed alone, L2-warm and -cold, beside its bound and its plain
    version.  Returns the kernel table's rows (none where ``rows`` is
    false)."""
    from hlax_torch.ops import natgrad as ng

    case = natgrad_case(*shape, dtype, chain)
    c = str(case["chain"]).removeprefix("torch.")
    tag = (f"natgrad {str(dtype).removeprefix('torch.')}"
           + (f" (chain {c})" if case["chain"] != dtype else "")
           + f" {list(shape)}")
    ref_case = None if case["chain"] == dtype == torch.float64 else \
        natgrad_case64(case)
    errs = {}
    before = ng._COUNTERS.snapshot()
    for jitter in (0.0, NATGRAD_JITTER):
        got = natgrad_run(case, True, jitter)
        plain = natgrad_run(case, False, jitter)
        ref = None if ref_case is None else natgrad_run(ref_case, False,
                                                         jitter)
        if not torch.equal(got[-1], got[-1].mT):
            fail(f"[fusion] {tag}: K8's H_new is not exactly symmetric")
        for entry, part in NATGRAD_OUT_OF.items():
            e = _fusion_error(f"{tag} {entry} jitter {jitter:g}", got[part],
                              plain[part], None if ref is None else ref[part])
            errs[entry] = max(errs.get(entry, 0.0), e)
    print(f"[fusion] {tag}: largest error a kernel "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (against {'float64' if ref_case else 'the plain version'}); "
          "H_new exactly symmetric", flush=True)
    calls = _launches_of(ng, lambda: natgrad_run(case, True))
    orig = ng._launch
    plains = {
        "natgrad_fwd_subjects": lambda: ng.fwd_subjects_plain(
            *case["subjects"], case["chain"]),
        "natgrad_fwd_latents": lambda: ng.latents_plain(*case["latents"]),
        "natgrad_update_pre": lambda: ng.update_pre_plain(
            *case["pre"], NATGRAD_LR, 0.0),
        "natgrad_update_finish": lambda: ng.update_finish_plain(
            *case["finish"], case["state"])}
    # the one PyTorch call of K8's product (its yardstick; no call computes
    # the other three's functions)
    iLA = case["finish"][0]
    library = {"natgrad_update_finish": lambda: torch.bmm(iLA.mT, iLA)}
    out = []
    for entry, like, args in calls:
        ms, wall = time_ms(lambda: orig(entry, like, *args))
        cold = time_cold_ms(lambda: orig(entry, like, *args))
        plain_ms = time_ms(plains[entry], reps=20)[0]
        lib_ms = (time_ms(library[entry])[0] if entry in library else None)
        nbytes, ops = _natgrad_cost(entry, args)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FLOPS[like.dtype] * 1e3
        bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops else
                     (t_ops, "operations"))
        print(f"[fusion] {entry} {list(like.shape)} {tag}: kernel {ms:.4f} "
              f"ms, L2-cold {cold:.4f} ms ({wall:.4f} ms a call on the host "
              f"clock), its plain version {plain_ms:.4f} ms, bound "
              f"{bound:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, "
              f"{ops / 1e6:.2f} MFLOP), kernel / bound {ms / bound:.2f}"
              + ("" if lib_ms is None else
                 f", torch.bmm(iLA.mT, iLA) {lib_ms:.4f} ms")
              + f" on {card_line()}", flush=True)
        out.append(dict(
            name=f"{entry}_cuda", shape=list(like.shape),
            dtype=str(like.dtype).removeprefix("torch."), route="cuda",
            source="hlax_torch/csrc/natgrad.cu",
            replaces=NATGRAD_REPLACES[entry], launches=0,
            max_abs_err=errs[entry], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=lib_ms))
        if entry == "natgrad_update_finish" and shape == NATGRAD_CASES[0][0]:
            natgrad_finish_layouts(like, args, tag)
    ng._COUNTERS.take_since(before)
    return out if rows else []


# [fusion]'s natural-gradient cases, (shape [L, S, T, M], data dtype, the
# chain's): the canonical batch in float32 and float64 (its rows in the
# kernel table) and with --nat_grad_f64's float64 chain on float32 data,
# and a 2 x 2 mesh rank's in float32 (the card tests take every shape in
# each dtype pair, the ragged toy and subjects past TP rows)
NATGRAD_CASES = [((32, 20, 20, 120), torch.float32, None),
                 ((32, 20, 20, 120), torch.float64, None),
                 ((32, 20, 20, 120), torch.float32, torch.float64),
                 ((16, 10, 20, 120), torch.float32, None)]


def natgrad_finish_layouts(like, args, tag: str) -> None:
    """K8's two launch layouts on one recorded launch's inputs (``args``,
    its C entry's): a cluster of the latent's row tiles' blocks
    (``finish_plan(cluster=True)``) against one block a latent, each into
    outputs of its own, in turns (cluster, one block, one block, cluster)
    warm and L2-cold; the entries of m_new and H_new where they differ."""
    from hlax_torch.ops import natgrad as ng

    L, M = args[6:8]
    outs, runs = {}, {}
    for layout in (True, False):
        p = ng.finish_plan(L, M, args[0], ng._sms(like), layout)
        m, H = torch.empty_like(args[4]), torch.empty_like(args[5])
        a = args[:4] + (m, H, L, M, p.cluster, p.warps, p.chunk, p.smem)
        runs[layout] = (lambda a=a: ng._launch("natgrad_update_finish", like,
                                               *a))
        runs[layout]()
        outs[layout] = (m, H)
    torch.cuda.synchronize()
    diff = [int((x != y).sum()) for x, y in zip(outs[True], outs[False])]
    ms = {True: [], False: []}
    for layout in (True, False, False, True):
        ms[layout].append((time_ms(runs[layout])[0],
                           time_cold_ms(runs[layout])))
    name = {True: "cluster", False: "one block a latent"}
    print(f"[fusion] natgrad_update_finish layouts {tag}: "
          + "; ".join(f"{name[k]} warm " + ", ".join(f"{t[0]:.5f}"
                                                     for t in ms[k])
                      + " ms, L2-cold " + ", ".join(f"{t[1]:.5f}"
                                                    for t in ms[k]) + " ms"
                      for k in (True, False))
          + " (turns cluster, one block, one block, cluster; the plan's: "
          f"cluster); entries that differ m_new {diff[0]}, "
          f"H_new {diff[1]} on {card_line()}", flush=True)


# the redesigned natural-gradient kernels the parent comparison takes (K7
# also with jitter), and the outputs of each by argument of its C entry
NATGRAD_PARENT_OUTS = {"natgrad_fwd_subjects": {7: "ng_P1"},
                       "natgrad_fwd_latents": {7: "grad_m", 8: "grad_H"},
                       "natgrad_update_pre": {6: "iH_new", 7: "rhs"},
                       "natgrad_update_pre jitter": {6: "iH_new", 7: "rhs"},
                       "natgrad_update_finish": {4: "m_new", 5: "H_new"}}


def natgrad_against_parent() -> None:
    """The parent tree's K5-K8 (its csrc/natgrad.cu built into
    build/parent/natgrad/, through its own wrapper) against the change's
    at the canonical batch in float32 and float64 (``natgrad_case``'s
    state; K7 without and with jitter): the output entries that differ
    from the parent's (and the largest difference against the largest
    entry); each launch timed alone, L2-warm and -cold, in turns parent,
    change, change, parent.  Prints that it did not run without
    parent/."""
    from hlax_torch.ops import cuda_build
    from hlax_torch.ops import natgrad as ng

    if not os.path.isfile(os.path.join(PARENT_CSRC, "natgrad.cu")):
        print("[fusion] natgrad parent against change: not measured (no "
              f"{PARENT_CSRC}/natgrad.cu)", flush=True)
        return
    if parent_same("hlax_torch/csrc/natgrad.cu",
                   "hlax_torch/ops/natgrad.py"):
        print("[fusion] natgrad parent against change: not measured (the "
              "parent's natgrad.cu and ops/natgrad.py are this tree's)",
              flush=True)
        return
    pn, _, _ = tree_ops(PARENT_ROOT, "natgrad", os.path.join(
        cuda_build.BUILD_DIR, "parent", "natgrad"))
    for shape, dtype, chain in NATGRAD_CASES[:2]:
        case = natgrad_case(*shape, dtype, chain)
        tag = f"{list(shape)} {str(dtype).removeprefix('torch.')}"
        calls = {}
        for who, mod in (("parent", pn), ("change", ng)):
            got = _launches_of(mod, lambda: (
                mod.fwd_subjects(*case["subjects"], case["chain"]),
                mod.latents(*case["latents"]),
                mod.update_pre(*case["pre"], NATGRAD_LR, 0.0),
                mod.update_pre(*case["pre"], NATGRAD_LR, NATGRAD_JITTER),
                mod.update_finish(*case["finish"], case["state"])))
            names = [name.split()[0] for name in NATGRAD_PARENT_OUTS]
            if [call[0] for call in got] != names:
                fail(f"[fusion] natgrad parent against change {tag}: the "
                     f"{who}'s launches {[call[0] for call in got]}, not "
                     f"{names}")
            calls[who] = {name: call[1:] for name, call in zip(
                NATGRAD_PARENT_OUTS, got)}
        torch.cuda.synchronize()
        for name, outs in NATGRAD_PARENT_OUTS.items():
            entry = name.split()[0]
            diffs = []
            for i, out in outs.items():
                a = calls["parent"][name][1][i]
                b = calls["change"][name][1][i]
                n = int((a != b).sum())
                rel = ((a.double() - b.double()).abs().max()
                       / b.double().abs().max()).item()
                diffs.append(f"{out} {n} of {b.numel()} entries differ "
                             f"(largest {rel:.3e} of the largest entry)")
            ms = {"parent": [], "change": []}
            for who in ("parent", "change", "change", "parent"):
                mod = pn if who == "parent" else ng
                like, args = calls[who][name]
                run = lambda: mod._launch(entry, like, *args)
                ms[who].append((time_ms(run)[0], time_cold_ms(run)))
            turns = (("parent", 0), ("change", 0), ("change", 1),
                     ("parent", 1))
            print(f"[fusion] parent against change {name} {tag}: warm "
                  + ", ".join(f"{w} {ms[w][j][0]:.5f}" for w, j in turns)
                  + " ms; L2-cold "
                  + ", ".join(f"{w} {ms[w][j][1]:.5f}" for w, j in turns)
                  + " ms (turns parent, change, change, parent); "
                  + "; ".join(diffs) + f" on {card_line()}", flush=True)
        del case, calls
        torch.cuda.empty_cache()


def natgrad_fusion() -> list:
    """``_natgrad_fusion`` at each of NATGRAD_CASES; the rows of the
    canonical shape in one dtype."""
    rows = []
    for shape, dtype, chain in NATGRAD_CASES:
        rows += _natgrad_fusion(shape, dtype, chain,
                                shape == NATGRAD_CASES[0][0]
                                and chain is None)
        torch.cuda.empty_cache()
    return rows


def tree_ops(tree: str, name: str, out_dir: str, defines=(), src=None):
    """The kernel wrapper ``name`` of the tree at ``tree`` (its
    hlax_torch/ops/<name>.py) as a module of its own on the tree's
    csrc/<name>.cu (or ``src``), built with the current flags (and
    ``defines``, -D) into ``out_dir``: its launches counted in counters of
    its own, through this tree's ``fusion.launch`` with that library.
    Returns (the module, the library, ptxas's log)."""
    import ctypes
    import importlib.util
    from types import SimpleNamespace

    from hlax_torch.ops import cuda_build, fusion

    src = src or os.path.join(tree, "hlax_torch", "csrc", f"{name}.cu")
    py = os.path.join(tree, "hlax_torch", "ops", f"{name}.py")
    out = os.path.join(out_dir, f"lib{name}.so")
    os.makedirs(out_dir, exist_ok=True)
    res = subprocess.run([cuda_build._nvcc(),
                          *cuda_build.nvcc_flags(name),
                          *(f"-D{d}" for d in defines), "-o", out, src],
                         capture_output=True, text=True)
    if res.returncode:
        fail(f"{src} did not build:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(out)
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p

    def launch(library, counters, entry, like, *args):
        saved = fusion.load_library
        fusion.load_library = lambda name: lib
        try:
            fusion.launch(library, counters, entry, like, *args)
        finally:
            fusion.load_library = saved

    shim = SimpleNamespace(**{k: getattr(fusion, k) for k in dir(fusion)
                              if not k.startswith("__")})
    shim.launch = launch
    spec = importlib.util.spec_from_file_location(
        f"{name}_{abs(hash(out))}", py)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.fusion = shim
    return mod, lib, res.stdout + res.stderr


def _launches_of(mod, fn):
    """The launches (entry, like, args) ``fn`` makes through the wrapper
    module ``mod`` (done, not counted)."""
    calls, orig = [], mod._launch

    def record(entry, like, *args):
        calls.append((entry, like, args))
        orig(entry, like, *args)

    before = mod._COUNTERS.snapshot()
    mod._launch = record
    try:
        fn()
    finally:
        mod._launch = orig
    mod._COUNTERS.take_since(before)
    return calls


def bound_launches(gb, case, need_hm=False):
    """The launches (entry, like, args) of one forward and backward of the
    bound through the wrapper module ``gb`` (not counted)."""
    return _launches_of(gb, lambda: _gp_bound_run(True, case, need_hm, gb=gb))


# the latents a launch takes in the subject kernels' sweep: 20 to 640
# canonical subjects
SWEEP_LATENTS = (1, 2, 4, 8, 16, 32)
SUBJECT_ENTRIES = ("gp_bound_fwd_subjects", "gp_bound_bwd_subjects")
# the bound's four C entries in a step's order, and the latent kernels'
# outputs by argument of their C entries (after the itemsize)
BOUND_ENTRIES = ("gp_bound_fwd_subjects", "gp_bound_fwd_latents",
                 "gp_bound_bwd_latents", "gp_bound_bwd_subjects")
LATENT_OUTS = {"gp_bound_fwd_latents": {13: "u", 14: "terms",
                                        15: "P_batch", 16: "kld_total"},
               "gp_bound_bwd_latents": {17: "G2", 18: "d iK0zz", 19: "d H",
                                        20: "d m", 21: "d LK0zz",
                                        22: "d LH"}}


def gp_bound_sweep(gb, case, tag: str) -> dict:
    """The subject kernels' time against the subjects a launch takes: the
    case's first n latents (SWEEP_LATENTS), each launch of ``gb``'s wrapper
    (its own plan for those shapes) timed alone, L2-warm and -cold, and a
    line ms = fixed + subjects x rate through each (the launch's fixed part
    and a subject's marginal cost).  Prints one line a kernel; returns
    {entry: [(subjects, warm, cold)]}."""
    leaves, valid = case
    L, S = leaves[0].shape[:2]
    pts = {e: [] for e in SUBJECT_ENTRIES}
    before = gb._COUNTERS.snapshot()
    for n in (n for n in SWEEP_LATENTS if n <= L):
        sub = [t[:n].contiguous() if i < 9 else t[..., :n].contiguous()
               for i, t in enumerate(leaves)]
        for entry, like, args in bound_launches(gb, (sub, valid)):
            if entry in pts:
                run = lambda: gb._launch(entry, like, *args)
                pts[entry].append((n * S, time_ms(run)[0], time_cold_ms(run)))
    gb._COUNTERS.take_since(before)
    for entry, p in pts.items():
        x = np.array([q[0] for q in p], dtype=np.float64)
        fits = []
        for k in (1, 2):
            slope, icpt = np.polyfit(x, np.array([q[k] for q in p]), 1)
            fits.append(f"{icpt * 1e3:.2f} us + {slope * 1e3:.4f} us a "
                        "subject")
        print(f"[{tag}] sweep {entry} {list(leaves[0].shape)} "
              f"{str(leaves[0].dtype).removeprefix('torch.')}, ms warm / "
              "L2-cold against subjects a launch: "
              + "; ".join(f"{q[0]} {q[1]:.5f} / {q[2]:.5f}" for q in p)
              + f"; a line through them: warm {fits[0]}, cold {fits[1]} on "
              f"{card_line()}", flush=True)
    return pts


# the bound's shapes [L, S, T, M] the subject kernels' parent comparison
# takes (tests/test_torch_cuda.py's BOUND_SHAPES: the canonical batch, the
# card tests' ragged one, T = 200, a 2 x 2 mesh rank's, T = 500), and
# those of the sweep (the canonical batch and T = 200)
GP_BOUND_SHAPES = [(32, 20, 20, 120), (3, 7, 13, 37), (32, 4, 200, 120),
                   (16, 10, 20, 120), (32, 2, 500, 120)]
GP_SWEEP_SHAPES = [(32, 20, 20, 120), (32, 4, 200, 120)]


def gp_bound_sweeps() -> None:
    """[fusion]'s sweep of the subject kernels (``gp_bound_sweep``) at
    GP_SWEEP_SHAPES in float32 and float64 on ``bound_case``'s state."""
    from hlax_torch.ops import gp_bound as gb

    for dtype in (torch.float32, torch.float64):
        for shape in GP_SWEEP_SHAPES:
            gp_bound_sweep(gb, bound_case(*shape, dtype), "fusion")
            torch.cuda.empty_cache()


def gp_bound_against_parent() -> None:
    """The parent tree's bound kernels (its csrc/gp_bound.cu built into
    build/parent/gp_bound/, through its own wrapper) against the change's
    at GP_BOUND_SHAPES in float32 and float64, on ``bound_case``'s state:
    every result of the bound through each tree's kernels (terms,
    P_batch, kld_total, every gradient with H's and m's) compared bit for
    bit, and the latent kernels' own outputs (LATENT_OUTS) without and
    with H's and m's gradients; each of the four kernels' launch of one
    forward and backward (each tree's own plan) timed alone, L2-warm and
    -cold, in turns parent, change, change, parent; then each kernel's
    times at the canonical shape with the parent's in brackets.  Prints
    that it did not run without parent/."""
    from hlax_torch.ops import cuda_build
    from hlax_torch.ops import gp_bound as gb

    if not os.path.isfile(os.path.join(PARENT_CSRC, "gp_bound.cu")):
        print("[fusion] gp_bound parent against change: not measured (no "
              f"{PARENT_CSRC}/gp_bound.cu)", flush=True)
        return
    if parent_same("hlax_torch/csrc/gp_bound.cu",
                   "hlax_torch/ops/gp_bound.py"):
        print("[fusion] gp_bound parent against change: not measured (the "
              "parent's gp_bound.cu and ops/gp_bound.py are this tree's)",
              flush=True)
        return
    pg, _, _ = tree_ops(PARENT_ROOT, "gp_bound", os.path.join(
        cuda_build.BUILD_DIR, "parent", "gp_bound"))
    slower, canonical = [], []
    for dtype in (torch.float32, torch.float64):
        for shape in GP_BOUND_SHAPES:
            case = bound_case(*shape, dtype)
            tag = f"{list(shape)} {str(dtype).removeprefix('torch.')}"
            before = gb._COUNTERS.snapshot()
            results = {who: _gp_bound_run(True, case, True, gb=mod)
                       for who, mod in (("parent", pg), ("change", gb))}
            _bits_against_parent(f"gp_bound {tag} (terms, P_batch, "
                                 "kld_total, the 11 gradients)",
                                 results["parent"], results["change"])
            for need_hm in (True, False):
                calls = {who: {e: (like, args) for e, like, args in
                               bound_launches(mod, case, need_hm)}
                         for who, mod in (("parent", pg), ("change", gb))}
                for entry, outs in LATENT_OUTS.items():
                    got = [(name, calls["parent"][entry][1][i],
                            calls["change"][entry][1][i])
                           for i, name in outs.items()
                           if calls["change"][entry][1][i] is not None]
                    _bits_against_parent(
                        f"gp_bound {tag} {entry}"
                        f"{' with H and m' if need_hm else ''} "
                        f"({', '.join(g[0] for g in got)})",
                        [g[1] for g in got], [g[2] for g in got],
                        [g[0] for g in got])
            for entry in BOUND_ENTRIES:
                ms = {"parent": [], "change": []}
                for who in ("parent", "change", "change", "parent"):
                    mod = pg if who == "parent" else gb
                    like, args = calls[who][entry]
                    run = lambda: mod._launch(entry, like, *args)
                    ms[who].append((time_ms(run)[0], time_cold_ms(run)))
                worse = [k for k in (0, 1) if min(t[k] for t in ms["change"])
                         > max(t[k] for t in ms["parent"])]
                ratio = [sum(t[k] for t in ms["parent"])
                         / sum(t[k] for t in ms["change"]) for k in (0, 1)]
                slower += [f"{entry} {tag} {('warm', 'cold')[k]}"
                           for k in worse]
                if shape == GP_BOUND_SHAPES[0]:
                    canonical.append((entry, list(like.shape), tag, ms))
                print(f"[fusion] parent against change {entry} {tag}: warm "
                      + ", ".join(f"{who} {ms[who][j][0]:.5f}" for who, j in
                                  (("parent", 0), ("change", 0),
                                   ("change", 1), ("parent", 1)))
                      + " ms; L2-cold "
                      + ", ".join(f"{who} {ms[who][j][1]:.5f}" for who, j in
                                  (("parent", 0), ("change", 0),
                                   ("change", 1), ("parent", 1)))
                      + f" ms (turns parent, change, change, parent); "
                      f"parent / change warm {ratio[0]:.2f}x, cold "
                      f"{ratio[1]:.2f}x on {card_line()}", flush=True)
            gb._COUNTERS.take_since(before)
            del case, results, calls
            torch.cuda.empty_cache()
    mean = lambda ts, k: sum(t[k] for t in ts) / len(ts)
    for entry, shape, tag, ms in canonical:
        print(f"[fusion] {entry} {shape} {tag.split()[-1]}: kernel "
              f"{mean(ms['change'], 0):.4f} ms, L2-cold "
              f"{mean(ms['change'], 1):.4f} ms [parent "
              f"{mean(ms['parent'], 0):.4f}; {mean(ms['parent'], 1):.4f}] "
              f"(each tree's two turns' mean) on {card_line()}", flush=True)
    print("[fusion] gp_bound kernels against the parent's: "
          + ("slower than the parent's in both its turns at "
             + "; ".join(slower) if slower else
             "none slower than the parent's at any shape, dtype, warm or "
             "cold"), flush=True)


def _gp_bound_run(kernel, case, need_hm=True, grads=True, gb=None):
    """(terms, P_batch, kld_total[, the leaves' gradients of kld_total + w
    . terms]) through the bound's kernels (``kernel``; the wrapper module
    ``gb``, None: this tree's) or its plain version; H and m without
    gradients unless ``need_hm`` (the canonical step's natural gradients
    need none)."""
    from types import SimpleNamespace

    if gb is None:
        from hlax_torch.ops import gp_bound as gb

    base, valid = case
    xs = [t.detach().clone().requires_grad_(grads and (
        need_hm or i not in (7, 8))) for i, t in enumerate(base)]
    K0xz, iLB, LB, K0st, iK, LK, LH, H, m, mu, lv = xs
    totals = (200.0, 4000.0)
    with torch.set_grad_enabled(grads):
        iB = torch.einsum("lskt,lsku->lstu", iLB, iLB)
        if kernel:
            terms, pb, kld = gb._GpBound.apply(
                K0xz, iLB, LB, K0st, iK, LK, LH, H, m, mu, lv, iB.detach(),
                valid, totals)
        else:
            blk = SimpleNamespace(K0xz=K0xz, iB=iB, LB=LB, K0_st=K0st,
                                  iK0zz=iK, LK0zz=LK)
            terms, pb = gb.kld_terms_plain(blk, LH, H, m, mu, lv, valid)
            kld = gb.assemble(terms, pb, *totals, K0xz.shape[0])
        outs = [terms.detach(), pb, kld.detach()]
        if not grads:
            return outs
        w = torch.linspace(-1.0, 1.0, 7, dtype=terms.dtype,
                           device=terms.device)
        return outs + list(torch.autograd.grad(
            kld + (terms * w).sum(), [x for x in xs if x.requires_grad]))


def _gp_bound_check(tag, case):
    """The four kernels (through the op's autograd Function) against the
    plain version, forward and every gradient, without and with H's and
    m's, at ``_gp_bound_error``'s bars (float32 against the plain version
    in float64 on the same inputs).  Returns the largest errors (forward,
    gradients)."""
    from hlax_torch.ops import gp_bound as gb

    leaves, valid = case
    f32 = leaves[0].dtype == torch.float32
    case64 = ([t.double() for t in leaves], valid.double()) if f32 else None
    errs = (0.0, 0.0)
    for need_hm in (False, True):
        before = gb._COUNTERS.snapshot()
        got = _gp_bound_run(True, case, need_hm)
        gb._COUNTERS.take_since(before)
        plain = _gp_bound_run(False, case, need_hm)
        ref = None if case64 is None else _gp_bound_run(False, case64,
                                                        need_hm)
        spreads = [] if f32 else [_gp_bound_run(False, _one_ulp(case, s),
                                                need_hm)
                                  for s in SPREAD_SEEDS]
        how = f"{tag}{' with H and m' if need_hm else ''}"
        names = GP_BOUND_OUTS + tuple(
            f"d {n}" for i, n in enumerate(GP_BOUND_LEAVES)
            if need_hm or i not in (7, 8))
        e = tuple(_gp_bound_error(how, names[part], got[part], plain[part],
                                  None if ref is None else ref[part],
                                  [x[part] for x in spreads])
                  for part in (slice(0, 3), slice(3, None)))
        print(f"[{how}: P_batch {got[1].item():g}, largest error of the "
              f"terms and kld_total {e[0]:.3e}, of the gradients "
              f"{e[1]:.3e} (against "
              f"{'float64' if f32 else 'the plain version'})", flush=True)
        errs = tuple(max(a, b) for a, b in zip(errs, e))
    return errs


def _gp_bound_fusion(c, dtype, phase="fusion", entries=None):
    """[fusion]'s bound (or ``phase``'s, on its case ``c``):
    ``_gp_bound_check`` on the case's batch with a padded and an
    all-padding subject; then every launch of one canonical step's bound
    (natural gradients: no H or m gradient), each timed alone, L2-warm and
    -cold, beside its bound and the op's plain chain; d KziBK's cuBLAS
    product beside them.  Returns the kernel table's rows (of ``entries``,
    None: all four)."""
    from hlax_torch.ops import gp_bound as gb

    tag = f"{phase}] gp_bound {str(dtype).removeprefix('torch.')}"
    case = _gp_bound_case(c)
    errs = _gp_bound_check(tag, case)
    calls, orig = [], gb._launch

    def record(entry, like, *args):
        calls.append((entry, like, args))
        orig(entry, like, *args)

    before = gb._COUNTERS.snapshot()
    gb._launch = record
    try:
        _gp_bound_run(True, case, False)
    finally:
        gb._launch = orig
    fwd_ms = time_ms(lambda: _gp_bound_run(False, case, grads=False),
                     reps=10)[0]
    both_ms = time_ms(lambda: _gp_bound_run(False, case, False), reps=10)[0]
    kernel_both = time_ms(lambda: _gp_bound_run(True, case, False),
                          reps=10)[0]
    rows = []
    L, S, T, M = case[0][0].shape
    for entry, like, args in calls:
        if entries is not None and entry not in entries:
            continue
        ms, wall = time_ms(lambda: orig(entry, like, *args))
        cold = time_cold_ms(lambda: orig(entry, like, *args))
        nbytes = _gp_bound_bytes(entry, args, own=True)
        copies = _gp_bound_bytes(entry, args) - nbytes
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        ops = _gp_bound_ops(entry, L, S, T, M, bool(args[-2]))
        t_ops = ops / PEAK_FLOPS[dtype] * 1e3
        bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops else
                     (t_ops, "operations"))
        bwd = "_bwd_" in entry
        plain_ms = max(both_ms - fwd_ms, 0.0) if bwd else fwd_ms
        rows.append(dict(
            name=f"{entry}_cuda", shape=list(like.shape),
            dtype=str(dtype).removeprefix("torch."), route="cuda",
            source="hlax_torch/csrc/gp_bound.cu",
            replaces=GP_BOUND_REPLACES, launches=0,
            max_abs_err=errs[1 if bwd else 0], ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None))
        print(f"[{phase}] {entry} {list(like.shape)} {rows[-1]['dtype']}: "
              f"kernel {ms:.4f} ms, L2-cold {cold:.4f} ms ({wall:.4f} ms a "
              f"call on the host clock), the op's plain chain "
              f"{'backward' if bwd else 'forward'} {plain_ms:.4f} ms, bound "
              f"{bound:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} GFLOP), kernel / bound {ms / bound:.2f}"
              + (f"; not in the bound, its double copies of float32 "
                 f"inputs {copies / 1e6:.2f} MB "
                 f"({copies / PEAK_BYTES_PER_S * 1e3:.5f} ms at the memory "
                 f"rate)" if copies else ""), flush=True)
    # d KziBK's product for the subject kernel (one canonical backward's)
    G2 = calls[-2][2][17]
    K0xz, Y2 = calls[-1][2][5], calls[-1][2][15]
    with torch.no_grad():
        cublas = time_ms(lambda: torch.bmm(K0xz.view(L, S * T, M), G2,
                                           out=Y2))[0]
    print(f"[{tag} d KziBK's product K0xz [G | G^T] [{L}, {S * T}, "
          f"{2 * M}]: cuBLAS {cublas:.4f} ms; the bound forward + backward "
          f"through the kernels {kernel_both:.4f} ms, its plain chain "
          f"{both_ms:.4f} ms, on {card_line()}", flush=True)
    gb._COUNTERS.take_since(before)
    return rows


# the GP ops of one canonical train step, a forward and a backward each
GP_STEP = ("K0xz", "K0zz", "K1_st", "K0_st")


def _parent_fusion():
    """The parent tree's fused ops (parent/hlax_torch/ops/fusion.py) on its
    own kernels: its csrc/fusion.cu built into build/parent/libfusion.so
    with the current flags, its wrapper loaded as a module of its own that
    takes that library (its launches counted in counters of its own, not
    the change's).  None, saying so, without parent/."""
    import ctypes
    import importlib.util

    from hlax_torch.ops import cuda_build

    src = os.path.join(PARENT_CSRC, "fusion.cu")
    py = os.path.join(PARENT_ROOT, "hlax_torch", "ops", "fusion.py")
    if not (os.path.isfile(src) and os.path.isfile(py)):
        print(f"[fusion] parent against change: not measured (no {src})",
              flush=True)
        return None
    if parent_same("hlax_torch/csrc/fusion.cu", "hlax_torch/ops/fusion.py"):
        print("[fusion] parent against change: not measured (the parent's "
              "fusion.cu and ops/fusion.py are this tree's)", flush=True)
        return None
    out = os.path.join(cuda_build.BUILD_DIR, "parent", "libfusion.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.time()
    res = subprocess.run([cuda_build._nvcc(),
                          *cuda_build.nvcc_flags("fusion"), "-o", out, src],
                         capture_output=True, text=True)
    if res.returncode:
        fail(f"[fusion] the parent's fusion.cu did not build:\n"
             f"{res.stdout}{res.stderr}")
    print(f"[fusion] parent's fusion.cu built in {time.time() - t0:.1f} s; "
          "its GP kernels:", flush=True)
    _ptxas_report("fusion", "parent's fusion", res.stdout + res.stderr,
                  only="gp_")
    lib = ctypes.CDLL(out)
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    spec = importlib.util.spec_from_file_location("parent_fusion", py)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.load_library = lambda name: lib
    return mod


def _gp_launches(mod, which, c):
    """The launches (entry, like, args) one forward and backward of the GP
    op ``which`` makes through ``mod``'s wrapper, and the op's results."""
    calls, orig = [], mod._launch

    def record(entry, like, *args):
        calls.append((entry, like, args))
        orig(entry, like, *args)

    mod._launch = record
    try:
        res = _op_gp(which)(c, False, fusion=mod)
    finally:
        mod._launch = orig
    return calls, res


def _gp_against_parent(pf, c, c64, dtype) -> None:
    """The parent's GP kernels against the change's at the canonical
    shapes: the parent's results and gradients held to the change's bars;
    each op's launches timed alone (CUDA events), forward and backward, in
    turns parent, change, change, parent.  Where the parent's wrapper
    launches more than its kernels (one that keeps no counters of its own,
    ``_gp_counters``, forms K0zz's G + G^T in PyTorch and zeroes fresh
    counters for each backward launch), its backward counts them.  Prints each op's times
    and the GP kernels' device ms of one canonical step (GP_STEP) for
    both."""
    from hlax_torch.ops import fusion

    tag = str(dtype).removeprefix("torch.")
    legacy = not (hasattr(pf, "_gp_counters")
                  or hasattr(pf, "_stream_counters"))
    before = {m: m._COUNTERS.snapshot() for m in (pf, fusion)}
    extra = {"memset": lambda: torch.zeros(1024, dtype=torch.int32,
                                           device="cuda")}
    step = {"parent": [0.0, 0.0], "change": [0.0, 0.0]}
    for which in GP_STEP:
        plain = _op_gp(which)(c, True)
        ref = _op_gp(which)(c64, True) if c64 is not None else (None, None)
        runs = {}
        for who, mod in (("parent", pf), ("change", fusion)):
            runs[who], (got, g_got) = _gp_launches(mod, which, c)
            _fusion_error(f"gp {which} {tag} ({who})", got, plain[0],
                          ref[0])
            _fusion_error(f"gp {which} {tag} gradients ({who})", g_got,
                          plain[1], ref[1])
        if which == "K0zz":
            g = _cotangent(c["zt"].shape[:1] + (c["zt"].shape[1],) * 2,
                           dtype)
            extra["G + G^T"] = lambda: g + g.mT
        ms = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent"):
            mod = pf if who == "parent" else fusion
            t = {"fwd": 0.0, "bwd": 0.0}
            for entry, like, args in runs[who]:
                d = "bwd" if entry.endswith("bwd") else "fwd"
                t[d] += time_ms(lambda: mod._launch(entry, like, *args))[0]
                if legacy and who == "parent" and d == "bwd":
                    t[d] += time_ms(extra["memset"])[0]
            if legacy and who == "parent" and which == "K0zz":
                t["bwd"] += time_ms(extra["G + G^T"])[0]
            ms[who].append(t)
        for who in ms:
            for i, d in enumerate(("fwd", "bwd")):
                step[who][i] += sum(t[d] for t in ms[who]) / 2
        with_extra = (f" (the parent's with "
                      f"{'G + G^T and ' if which == 'K0zz' else ''}its "
                      f"counters' memset)" if legacy else "")
        print(f"[fusion] parent against change gp {which} {tag}: forward "
              f"parent {ms['parent'][0]['fwd']:.5f}, change "
              f"{ms['change'][0]['fwd']:.5f}, change "
              f"{ms['change'][1]['fwd']:.5f}, parent "
              f"{ms['parent'][1]['fwd']:.5f} ms; backward parent "
              f"{ms['parent'][0]['bwd']:.5f}, change "
              f"{ms['change'][0]['bwd']:.5f}, change "
              f"{ms['change'][1]['bwd']:.5f}, parent "
              f"{ms['parent'][1]['bwd']:.5f} ms{with_extra}; both within "
              f"the bars", flush=True)
    for m, b in before.items():
        m._COUNTERS.take_since(b)
    p, ch = sum(step["parent"]), sum(step["change"])
    print(f"[fusion] GP kernels of one canonical step, {tag}: parent "
          f"{p:.5f} ms (forward {step['parent'][0]:.5f}, backward "
          f"{step['parent'][1]:.5f}), change {ch:.5f} ms (forward "
          f"{step['change'][0]:.5f}, backward {step['change'][1]:.5f}): "
          f"parent / change {p / ch:.2f}x on {card_line()}", flush=True)


# the staged kernels' parent-against-change turns: each op and the entries
# of its launches that are timed (the metric: every launch, a parent's
# column sums a group and its finish against one)
STAGED_OPS = (("heads", ("heads_cat_fwd",)), ("heads", ("heads_cat_bwd",)),
              ("heads", ("heads_real_fwd",)), ("heads", ("heads_real_bwd",)),
              ("rep_image", ("rep_image_bwd",)),
              ("recon_metric", ("recon_metric", "recon_metric_finish")))


def _bits_against_parent(tag, parent, change, names=None) -> None:
    """Prints whether the change's forward results equal the parent's bit
    for bit, and where they do not (the bars hold either way); ``names``
    the results' (None: their indices)."""
    diff = []
    for i, (a, b) in enumerate(zip(parent, change)):
        if not torch.equal(a, b):
            n = (a != b).sum().item()
            err = (a.double() - b.double()).abs().max().item()
            name = names[i] if names else f"result {i}"
            diff.append(f"{name} {list(a.shape)}: {n} of {a.numel()} "
                        f"entries differ, by {err:.3e} at most")
    print(f"[fusion] {tag}: the change's results "
          + ("equal the parent's bit for bit" if not diff else
             "differ from the parent's: " + "; ".join(diff)), flush=True)


def _staged_against_parent(pf, c, c64, dtype) -> None:
    """The parent's staged kernels (the cat and the real head's forward and
    backward, the representation's backward, the recon metric) against the
    change's at the canonical shapes: the parent's results and gradients
    held to the change's bars, the heads' forward results (with the cat
    head's or the real head's launches timed) compared bit for bit;
    each op's timed launches together, with the L2 warm and cold (time_ms,
    time_cold_ms), in turns parent, change, change, parent.  A parent whose
    wrapper zeroes fresh counters for each launch (``_reduction_scratch``'s
    fills, before the stream's buffer) has their time printed beside its
    own."""
    from hlax_torch.ops import fusion

    tag = str(dtype).removeprefix("torch.")
    before = {m: m._COUNTERS.snapshot() for m in (pf, fusion)}
    fill = time_ms(lambda: torch.zeros(64, dtype=torch.int32,
                                       device="cuda"))[0]
    fills_apart = not hasattr(pf, "_stream_counters")
    for name, entries in STAGED_OPS:
        op = FUSION_OPS_RUN[name]
        plain = op(c, True)
        ref = op(c64, True) if c64 is not None else (None, None)
        runs, results = {}, {}
        for who, mod in (("parent", pf), ("change", fusion)):
            calls, orig = [], mod._launch

            def record(entry, like, *args, orig=orig, calls=calls):
                calls.append((entry, like, args))
                orig(entry, like, *args)

            mod._launch = record
            try:
                got, g_got = op(c, False, fusion=mod)
            finally:
                mod._launch = orig
            _fusion_error(f"{name} {tag} ({who})", got, plain[0], ref[0])
            if g_got:
                _fusion_error(f"{name} {tag} gradients ({who})", g_got,
                              plain[1], ref[1])
            runs[who] = [call for call in calls if call[0] in entries]
            results[who] = got
        if entries[0] in ("heads_cat_fwd", "heads_real_fwd"):
            _bits_against_parent(f"{entries[0]} {tag}", results["parent"],
                                 results["change"])
        ms = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent"):
            mod = pf if who == "parent" else fusion

            def seq(mod=mod, calls=runs[who]):
                for entry, like, args in calls:
                    mod._launch(entry, like, *args)

            ms[who].append((time_ms(seq)[0], time_cold_ms(seq)))
        n_fill = sum(e != "recon_metric_finish" for e, _, _ in
                     runs["parent"]) if fills_apart else 0
        print(f"[fusion] parent against change {name} {tag} "
              f"({'+'.join(e for e, _, _ in runs['parent'])} against "
              f"{'+'.join(e for e, _, _ in runs['change'])}): warm parent "
              f"{ms['parent'][0][0]:.5f}, change {ms['change'][0][0]:.5f}, "
              f"change {ms['change'][1][0]:.5f}, parent "
              f"{ms['parent'][1][0]:.5f} ms; L2-cold parent "
              f"{ms['parent'][0][1]:.5f}, change {ms['change'][0][1]:.5f}, "
              f"change {ms['change'][1][1]:.5f}, parent "
              f"{ms['parent'][1][1]:.5f} ms; the parent's wrapper adds "
              f"{n_fill} counter fill(s) of {fill:.5f} ms; both within the "
              f"bars on {card_line()}", flush=True)
    for m, b in before.items():
        m._COUNTERS.take_since(b)


# the staged kernels the sweeps time: each one's op and the index of its C
# entry's batch argument B
SWEEP_ENTRIES = {"heads_cat_fwd": ("heads", 10), "heads_cat_bwd": ("heads", 18),
                 "heads_real_fwd": ("heads", 16),
                 "heads_real_bwd": ("heads", 26),
                 "rep_image_bwd": ("rep_image", 9),
                 "recon_metric": ("recon_metric", 11)}
# the first rows of the canonical batch the batch sweep takes, and the
# chunks the chunk sweep cuts the canonical batch into (and the plan's)
SWEEP_ROWS = (50, 100, 200, 400)
SWEEP_CHUNKS = (1, 2, 4, 8, 16)


def _sweep_plan(entry, args, B, z, sms):
    """The wrapper's plan of ``entry``'s launch ``args`` over ``B`` rows."""
    from hlax_torch.ops import fusion

    if entry == "heads_cat_fwd":
        return fusion.heads_cat_fwd_plan(B, args[11], args[18], args[19], z,
                                         sms)
    if entry == "heads_cat_bwd":
        return fusion.heads_cat_bwd_plan(B, args[19], args[26], args[27], z,
                                         sms)
    if entry == "heads_real_fwd":
        return fusion.heads_real_fwd_plan(B, args[17], args[24],
                                          bool(args[25]), z, sms)
    if entry == "heads_real_bwd":
        return fusion.heads_real_bwd_plan(B, args[27], args[34],
                                          bool(args[35]), z, sms)
    if entry == "rep_image_bwd":
        return fusion.rep_image_bwd_plan(B, args[10], args[15], z, sms)
    table = list(args[1])
    return fusion.metric_plan(B, args[12], [table[7 * k + 2] for k in
                                           range(args[3])], z, sms, False)


def _staged_sweep(c, dtype) -> None:
    """What bounds the staged kernels' row loops, at the canonical shapes:
    each kernel's C entry over the first B rows of the canonical batch
    (SWEEP_ROWS; the rows a chunk of the wrapper's plan for B), timed warm
    and L2-cold, and a line ms = fixed + bytes / rate fitted through them
    (bytes as the kernel table counts them: the loop's marginal rate and
    the fixed cost of a launch: its fill, drain and finish); then the
    canonical batch cut into SWEEP_CHUNKS chunks (one wave at the plan's,
    more blocks than an SM takes at once past it).  The launches are not
    counted."""
    from hlax_torch.ops import fusion

    tag = str(dtype).removeprefix("torch.")
    sms = fusion._sm_count(torch.cuda.current_device())
    calls, orig = {}, fusion._launch

    def record(entry, like, *args):
        calls.setdefault(entry, (like, args))
        orig(entry, like, *args)

    before = fusion._COUNTERS.snapshot()
    fusion._launch = record
    try:
        for op in dict.fromkeys(o for o, _ in SWEEP_ENTRIES.values()):
            FUSION_OPS_RUN[op](c, False)
    finally:
        fusion._launch = orig
    big = torch.empty(1 << 22, dtype=torch.float64, device="cuda")
    for entry, (_, b_at) in SWEEP_ENTRIES.items():
        like, args = calls[entry]
        z = like.element_size()

        def with_rows(B, rows):
            out = [big if torch.is_tensor(a) and a.dtype == torch.float64
                   and getattr(a, "_scratch", False) else a for a in args]
            out[b_at], out[-1] = B, rows
            return out

        def run(a):
            return (time_ms(lambda: orig(entry, like, *a))[0],
                    time_cold_ms(lambda: orig(entry, like, *a)))

        pts, txt = [], []
        for B in SWEEP_ROWS:
            plan = _sweep_plan(entry, args, B, z, sms)
            warm, cold = run(with_rows(B, plan.rows))
            nbytes = _fusion_shape(entry, like[:B], args)[1]
            pts.append((nbytes, warm, cold))
            txt.append(f"B {B} ({plan.chunks} x {plan.rows} rows) {warm:.5f}"
                       f" / {cold:.5f}")
        x = np.array([p[0] for p in pts], dtype=np.float64)
        fits = []
        for k in (1, 2):
            slope, icpt = np.polyfit(x, np.array([p[k] for p in pts]), 1)
            fits.append(f"{1e-9 / slope:.3f} TB/s past a fixed "
                        f"{icpt * 1e3:.2f} us" if slope > 0 else
                        "no slope")
        B = SWEEP_ROWS[-1]
        chunks = []
        # the sweep's counts and the plan's own (the real head's forward
        # takes more chunks than MAX_CHUNKS, its backward's clusters at most
        # MAX_CLUSTER)
        most = fusion.MAX_CLUSTER if entry == "heads_real_bwd" else B
        for n in sorted({n for n in SWEEP_CHUNKS if n <= most}
                        | {_sweep_plan(entry, args, B, z, sms).chunks}):
            rows = -(-B // n)
            warm, cold = run(with_rows(B, rows))
            chunks.append(f"{-(-B // rows)} x {rows} rows {warm:.5f} / "
                          f"{cold:.5f}")
        print(f"[fusion] sweep {entry} {tag}, ms warm / L2-cold: "
              + "; ".join(txt) + f"; a line through them: warm {fits[0]}, "
              f"cold {fits[1]} (the table's bytes at B {B}: "
              f"{pts[-1][0] / 1e6:.2f} MB, {PEAK_BYTES_PER_S / 1e12} TB/s "
              f"the card's rate); B {B} in chunks: " + "; ".join(chunks)
              + f" on {card_line()}", flush=True)
    fusion._COUNTERS.take_since(before)


# [sass]'s kernels by library: the staged kernels' row loops (the inner
# loops that hold cp.async copies, LDGSTS) and the bound's subject
# kernels' longest inner loops (their products' and tiles' loops), at most
# this many a kernel
SASS_KERNELS = (("fusion", STAGED_INSTANCES, "LDGSTS", 2),
                ("gp_bound", SUBJECT_INSTANCES, None, 4))


def _sass_report() -> None:
    """[sass]: the staged kernels' and the bound's subject kernels' machine
    code (cuobjdump -sass of build/libfusion.so, build/libgp_bound.so):
    each one's instructions, and its loops (SASS_KERNELS: a backward branch
    with no such loop inside it, whose body holds the given opcode): their
    instructions by opcode.  The code goes to build/sass/<kernel>.sass.
    Not measured without cuobjdump."""
    import shutil

    from hlax_torch.ops import cuda_build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for lib_name, names, needs, top in SASS_KERNELS:
        lib = cuda_build.BUILD_DIR / f"lib{lib_name}.so"
        if not (os.path.isfile(tool) and lib.is_file()):
            print(f"[sass] not measured (no {tool} or {lib})", flush=True)
            continue
        res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                             text=True, timeout=600)
        if res.returncode:
            print(f"[sass] not measured: cuobjdump failed: "
                  f"{res.stderr[-500:]}", flush=True)
            continue
        out_dir = cuda_build.BUILD_DIR / "sass"
        out_dir.mkdir(parents=True, exist_ok=True)
        for part in res.stdout.split("Function : ")[1:]:
            lines = part.splitlines()
            name = _kernel_name(lines[0].strip())
            if name in names:
                _sass_loops(name, part, lines, out_dir, needs, top)


def _sass_loops(name, part, lines, out_dir, needs, top) -> None:
    """Prints one kernel's instructions and its ``top`` largest inner
    loops (holding opcode ``needs``, None: any) by opcode."""
    (out_dir / f"{name.replace('<', '_').replace('>', '').replace(',', '_')}"
     f".sass").write_text(part)
    # (address, opcode, text) of each instruction; a branch's target
    # as an address or a label (.L_x_N:, at the next instruction's)
    ins, labels = [], {}
    for line in lines[1:]:
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = len(ins)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            toks = m.group(2).split()
            toks = toks[1:] if toks and toks[0].startswith("@") else toks
            ins.append((int(m.group(1), 16),
                        toks[0].split(".")[0] if toks else "?",
                        m.group(2)))
    at = {a: i for i, (a, _, _) in enumerate(ins)}
    loops = []
    for i, (_, op, text) in enumerate(ins):
        if op != "BRA":
            continue
        m = re.search(r"`\((\.L_x_\d+)\)|BRA\S*\s+(0x[0-9a-f]+)", text)
        lo = None if not m else labels.get(m.group(1)) if m.group(1) \
            else at.get(int(m.group(2), 16))
        if lo is not None and lo <= i and (needs is None or any(
                o == needs for _, o, _ in ins[lo:i + 1])):
            loops.append((lo, i))
    inner = [(lo, hi) for lo, hi in loops if not any(
        (a, b) != (lo, hi) and lo <= a and b <= hi for a, b in loops)]
    txt = []
    for lo, hi in sorted(inner, key=lambda l: l[0] - l[1])[:top]:
        ops = {}
        for _, op, _ in ins[lo:hi + 1]:
            ops[op] = ops.get(op, 0) + 1
        mix = ", ".join(f"{o} {n}" for o, n in
                        sorted(ops.items(), key=lambda kv: -kv[1]))
        txt.append(f"a loop of {hi - lo + 1} instructions ({mix})")
    print(f"[sass] {name}: {len(ins)} instructions; "
          + ("; ".join(txt) or f"no loop of {needs}"), flush=True)


def _gp_shapes_against_table(c, c64, dtype) -> None:
    """The canonical specs' compiled shapes (GP_SPEC0, GP_SPEC1 in
    csrc/fusion.cu) against the table kernel that takes any spec
    (``gp_compiled_shapes(0)``) at the canonical shapes: both held to the
    bars; each op's launches timed alone (CUDA events), forward and
    backward, in turns shapes, table, table, shapes.  Prints each op's
    times and the GP kernels' device ms of one canonical step for both."""
    from hlax_torch.ops import fusion
    from hlax_torch.ops.cuda_build import load_library

    lib = load_library("fusion")
    tag = str(dtype).removeprefix("torch.")
    before = fusion._COUNTERS.snapshot()
    step = {"shapes": [0.0, 0.0], "table": [0.0, 0.0]}
    try:
        for which in GP_STEP:
            plain = _op_gp(which)(c, True)
            ref = _op_gp(which)(c64, True) if c64 is not None else (None,
                                                                    None)
            for who in ("table", "shapes"):
                lib.gp_compiled_shapes(int(who == "shapes"))
                runs, (got, g_got) = _gp_launches(fusion, which, c)
                _fusion_error(f"gp {which} {tag} ({who})", got, plain[0],
                              ref[0])
                _fusion_error(f"gp {which} {tag} gradients ({who})", g_got,
                              plain[1], ref[1])
            ms = {"shapes": [], "table": []}
            for who in ("shapes", "table", "table", "shapes"):
                lib.gp_compiled_shapes(int(who == "shapes"))
                t = {"fwd": 0.0, "bwd": 0.0}
                for entry, like, args in runs:
                    d = "bwd" if entry.endswith("bwd") else "fwd"
                    t[d] += time_ms(
                        lambda: fusion._launch(entry, like, *args))[0]
                ms[who].append(t)
            for who in ms:
                for i, d in enumerate(("fwd", "bwd")):
                    step[who][i] += sum(t[d] for t in ms[who]) / 2
            print(f"[fusion] compiled shapes against the table kernel gp "
                  f"{which} {tag}: "
                  + "; ".join(f"{w} shapes {ms['shapes'][0][d]:.5f}, table "
                              f"{ms['table'][0][d]:.5f}, table "
                              f"{ms['table'][1][d]:.5f}, shapes "
                              f"{ms['shapes'][1][d]:.5f} ms"
                              for w, d in (("forward", "fwd"),
                                           ("backward", "bwd")))
                  + "; both within the bars", flush=True)
    finally:
        lib.gp_compiled_shapes(1)
    fusion._COUNTERS.take_since(before)
    sh, tb = sum(step["shapes"]), sum(step["table"])
    print(f"[fusion] GP kernels of one canonical step, {tag}: compiled "
          f"shapes {sh:.5f} ms, the table kernel {tb:.5f} ms: table / "
          f"shapes {tb / sh:.2f}x on {card_line()}", flush=True)


def phase_fusion(data_dir: str, tmp: str):
    """[fusion]: the fused step ops' kernels (hlax_torch.ops.fusion) at the
    canonical shapes (400 rows of D4 data; the GP's [32, 20, 20, 120],
    [32, 120, 120] and [32, 20, 20, 20] kernel matrices) in float32 and
    float64, each op's results and gradients against its plain version
    (FUSION_F64_REL, FUSION_F32_FACTOR), every kernel timed alone by CUDA
    events beside the plain chain and its bound; then --use_pallas_chol=
    False on the graph path (``phase_pallas_chol_false``).  Returns the
    kernel table's rows."""
    from hlax_torch.ops import fusion

    ds, spec0, spec1 = canonical_setup(data_dir)
    rows = []
    _sass_report()
    parent = _parent_fusion()
    for dtype in (torch.float32, torch.float64):
        c = _fusion_case(ds, spec0, spec1, dtype)
        c64 = _case_in_float64(c) if dtype == torch.float32 else None
        for name, op in {**FUSION_OPS_RUN, **FUSION_OPS_HELD}.items():
            got, g_got = op(c, False)
            plain, g_plain = op(c, True)
            ref = g_ref = None
            if c64 is not None:
                ref, g_ref = op(c64, True)
            tag = f"{name} {str(dtype).removeprefix('torch.')}"
            errs = (_fusion_error(tag, got, plain, ref),
                    _fusion_error(f"{tag} gradients", g_got, g_plain, g_ref))
            print(f"[fusion] {tag}: largest error of the kernels' results "
                  f"{errs[0]:.3e}, of their gradients {errs[1]:.3e} "
                  f"(against {'float64' if ref is not None else 'the plain version'})",
                  flush=True)
            if name in FUSION_OPS_RUN:
                rows += _time_fused(name, op, c, dtype, errs)
        rows += _gp_bound_fusion(c, dtype)
        _staged_sweep(c, dtype)
        _gp_shapes_against_table(c, c64, dtype)
        if parent is not None:
            _gp_against_parent(parent, c, c64, dtype)
            _staged_against_parent(parent, c, c64, dtype)
        del c, c64
        torch.cuda.empty_cache()
    rows += natgrad_fusion()
    gp_bound_sweeps()
    gp_bound_against_parent()
    natgrad_against_parent()
    phase_pallas_chol_false(data_dir, tmp)
    return rows


# the configurations the parent comparison times on the graph path:
# (name, dtype of the model and GP, TrainConfig fields)
RATE_CONFIGS = [("float32", torch.float32, {}),
                ("float64", torch.float64, {}),
                ("nat_grad_f64", torch.float32, {"nat_grad_f64": True})]
# [precision]'s A/B of "highest" against "default": the canonical float32
# step, the float64 natural-gradient chain, the MLP and the fused conv stack
PRECISION_CONFIGS = [("float32", torch.float32, {}),
                     ("nat_grad_f64", torch.float32, {"nat_grad_f64": True}),
                     ("mlp", torch.float32, {"conv": False}),
                     ("fused_conv", torch.float32, {"fused_conv": True})]
PARENT_ROOT = os.path.join(ROOT, "parent")


def rate_run(tree: str, data_dir: str, what: str = "rate",
             seed: str = "0") -> None:
    """``python3 chip_smoke.py rate <tree> <data_dir> [ab | full [seed]]``:
    the train step of the tree at ``tree`` (this one, or an earlier
    commit's unpacked under parent/) on the canonical config for each of
    RATE_CONFIGS (PRECISION_CONFIGS with ``ab``), through
    ``make_train_epoch``'s graphs (unroll 1): steps/s of 2 rounds of 3
    epochs after 2 warm-up epochs, then device ms, kernels a step and the
    idle share under the profiler (with ``ab`` also device ms a step by
    source region, each kernel name split as an eager epoch's profile
    splits it), and without ``ab`` the same of [longT]'s T = 200 cell
    (``_rate_long_t``); one JSON line.  With ``full``: [full]'s 300 canonical
    epochs through that tree's CLI from ``seed``, the final training net
    loss and the last validation's.  With ``reference``: [reference]'s
    float32 worst relative difference at each of the comma-separated
    ``seed``s of its toy state, not gated.  The VAE's precision comes from
    JAX_DEFAULT_MATMUL_PRECISION, as the CLI's does."""
    sys.path.insert(0, os.path.abspath(tree))
    import hlax_torch
    from hlax_torch.data.dataset import epoch_subject_batches, stage_dataset
    from hlax_torch.train import step as tstep

    if not hlax_torch.__file__.startswith(os.path.abspath(tree)):
        fail(f"[rate] imported {hlax_torch.__file__}, not {tree}'s")
    if what == "full":
        from hlax_torch.cli import main as cli
        from hlax_torch.config import ModelArgs

        opt = ModelArgs().parse_options([f"--f={CONFIG}"])
        with tempfile.TemporaryDirectory() as tmp:
            opt.update(data_source_path=data_dir, save_path=tmp,
                       epochs=FULL_EPOCHS, run_validation=True,
                       run_tests=False, generate_images=False,
                       device="cuda", epochs_per_dispatch=5, scan_unroll=10,
                       seed=int(seed))
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                out = cli.run(opt)
            seconds = time.perf_counter() - t0
        print("FULL " + json.dumps({
            "final": float(out["loss_arrs"]["net"][-1]),
            "validation": float(out["last_validation"]["net_loss"]),
            "seconds": seconds}), flush=True)
        return
    if what == "reference":
        with tempfile.TemporaryDirectory() as tmp:
            worst = {s: phase_reference(tmp, torch.float32, int(s), False)
                     for s in seed.split(",")}
        print("REFERENCE " + json.dumps(worst), flush=True)
        return
    ds, spec0, spec1 = canonical_setup(data_dir)
    idx = np.stack(list(epoch_subject_batches(ds.P, 20,
                                              np.random.default_rng(0))))
    out = {}
    for name, dtype, kw in (PRECISION_CONFIGS if what == "ab"
                            else RATE_CONFIGS):
        st, cfg = canonical_state(ds, spec0, spec1, dtype, **kw)
        staged = stage_dataset(ds, dtype, "cuda")
        epoch = tstep.make_train_epoch(st.vae, spec0, spec1, cfg)

        def run():
            epoch(st, staged, idx)
        run()
        run()
        rates = [_time_epochs(run, 3) for _ in range(2)]
        # an eager epoch's profile splits the graph's kernels by region
        step = tstep.make_train_step(st.vae, spec0, spec1, cfg)
        with contextlib.redirect_stdout(io.StringIO()):
            eager, table = _profile_steps(
                "eager", lambda: tstep.train_epoch(step, st, staged, idx),
                GRAPH_STEPS, calls=1, top=0)
        prof, _ = _profile_steps(f"rate {name}", run, 3 * GRAPH_STEPS,
                                 calls=3, top=0, table=table)
        if not torch.isfinite(st.m).all():
            fail(f"[rate] {name}: m is not finite")
        out[name] = {"steps_per_s": rates, **{k: prof[k] for k in (
            "busy_ms", "kernels", "idle", "regions")}}
        if what == "rate":
            out[name]["gp"] = gp_rows(eager["by_name"], table, GRAPH_STEPS)
        if what == "ab" and name == "float32":
            out[name]["eval"] = eval_rate(st.vae, ds)
        del st, staged, epoch
        torch.cuda.empty_cache()
    if what == "rate":
        out["T200"] = _rate_long_t()
    print("RATE " + json.dumps(out), flush=True)


def _rate_long_t() -> dict:
    """[parent]'s T = 200 cell ([longT]'s first: 40 subjects, 4 a batch,
    the conv model, float32): steps/s of 2 rounds of 3 epochs on the graph
    path after 2 warm-up epochs, then device busy ms, kernels a step and
    the idle share under the profiler, and an eager epoch's GP regions by
    kernel (``gp_rows``)."""
    from hlax_torch.data.dataset import epoch_subject_batches, stage_dataset
    from hlax_torch.train import step as tstep

    T, P, S = LONG_T[0]
    ds = long_t_dataset(T, P)
    spec0, spec1 = long_t_specs()
    st, cfg = canonical_state(ds, spec0, spec1, torch.float32, subjects=S)
    staged = stage_dataset(ds, torch.float32, "cuda")
    idx = np.stack(list(epoch_subject_batches(P, S,
                                              np.random.default_rng(0))))
    epoch = tstep.make_train_epoch(st.vae, spec0, spec1, cfg)

    def run():
        epoch(st, staged, idx)
    run()
    run()
    rates = [_time_epochs(run, 3, steps=len(idx)) for _ in range(2)]
    prof, _ = _profile_steps(f"rate T={T}", run, 3 * len(idx), calls=3,
                             top=0)
    step = tstep.make_train_step(st.vae, spec0, spec1, cfg)
    with contextlib.redirect_stdout(io.StringIO()):
        eager, table = _profile_steps(
            "eager", lambda: tstep.train_epoch(step, st, staged, idx),
            len(idx), calls=1, top=0)
    if not torch.isfinite(st.m).all():
        fail(f"[rate] T={T}: m is not finite")
    out = {"steps_per_s": rates, **{k: prof[k] for k in (
        "busy_ms", "kernels", "idle")},
        "gp": gp_rows(eager["by_name"], table, len(idx))}
    del st, staged, epoch
    torch.cuda.empty_cache()
    return out


def phase_parent(data_dir: str) -> None:
    """The parent commit's tree (unpacked under parent/, git-ignored)
    against this one on the graph path, each in processes of its own
    (``rate_run``), in turns: parent, change, change, parent.  Prints each
    configuration's steps/s, device ms and kernels a step of both trees
    (RATE_CONFIGS and T = 200),
    then, in turns again, each tree's [full] final net loss (the spread of
    the float32 trajectory over 3000 steps); prints that it did not run
    without parent/."""
    if not os.path.isfile(os.path.join(PARENT_ROOT, "hlax_torch",
                                       "__init__.py")):
        print("[parent] no parent/ tree: the comparison did not run",
              flush=True)
        return
    t0 = time.perf_counter()
    runs = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        tree = PARENT_ROOT if who == "parent" else ROOT
        runs[who].append(_subprocess_json(["rate", tree, data_dir], "RATE ",
                                          {}, "parent"))
    t1 = time.perf_counter()
    fulls = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        tree = PARENT_ROOT if who == "parent" else ROOT
        fulls[who].append(_subprocess_json(["rate", tree, data_dir, "full"],
                                           "FULL ", {}, "parent"))
    print(f"[time] [parent] rate processes {t1 - t0:.1f} s, full-run "
          f"processes {time.perf_counter() - t1:.1f} s", flush=True)
    for who, r in fulls.items():
        print(f"[parent] {who}: {FULL_EPOCHS} canonical epochs through the "
              f"CLI, final net loss "
              f"{', '.join(f'{x['final']:.6g}' for x in r)}; last "
              f"validation net_loss "
              f"{', '.join(f'{x['validation']:.6g}' for x in r)}; "
              f"{', '.join(f'{x['seconds']:.1f}' for x in r)} s (turns "
              f"parent, change, change, parent) on {card_line()}",
              flush=True)
    for name, *_ in RATE_CONFIGS:
        for who in ("parent", "change"):
            gp_attribution(f"parent {who} {name}", runs[who][0][name]["gp"])
    for who in ("parent", "change"):
        gp_attribution(f"parent {who} T={LONG_T[0][0]}",
                       runs[who][0]["T200"].get("gp", {}))
    reference_seeds()
    for name, *_ in RATE_CONFIGS:
        for who in ("parent", "change"):
            r = [x[name] for x in runs[who]]
            for g in GP_REGIONS:
                gp = [(x["regions"] or {}).get(g, (0.0, 0.0)) for x in r]
                print(f"[parent] {name} {who}: {g} "
                      f"{', '.join(f'{n:.1f}' for n, _ in gp)} kernels a "
                      f"step, {', '.join(f'{t:.4f}' for _, t in gp)} device "
                      "ms a step", flush=True)
            _print_rate(name, who, r)
    for who in ("parent", "change"):
        r = [x["T200"] for x in runs[who] if "T200" in x]
        if r:
            _print_rate(f"T={LONG_T[0][0]}", who, r)


def _print_rate(name: str, who: str, r) -> None:
    """[parent]'s line of one configuration's rate runs of one tree."""
    print(f"[parent] {name} {who}: graph steps/s "
          f"{', '.join(f'{v:.2f}' for x in r for v in x['steps_per_s'])}"
          f"; device busy {', '.join(f'{x['busy_ms']:.3f}' for x in r)}"
          f" ms/step; kernels/step "
          f"{', '.join(f'{x['kernels']:.1f}' for x in r)}; idle share "
          f"{', '.join(f'{x['idle']:.3f}' for x in r)} (processes "
          f"in turns parent, change, change, parent: {who}'s two, 2 "
          f"rounds of 3 epochs each) on {card_line()}", flush=True)


# the toy states [reference]'s float32 gate is read at beside its own (0)
REFERENCE_SEEDS = "0,1,2,3,4,5"


def reference_seeds() -> None:
    """[reference]'s float32 worst relative difference, card against CPU,
    of the parent's tree and this one at each of REFERENCE_SEEDS' toy
    states (``rate_run`` reference, a process a tree): whether the gate's
    reading at its own state is the kernels' or the toy state's noise."""
    got = {who: _subprocess_json(
        ["rate", PARENT_ROOT if who == "parent" else ROOT, ROOT,
         "reference", REFERENCE_SEEDS], "REFERENCE ", {}, "parent")
        for who in ("parent", "change")}
    for who, worst in got.items():
        print(f"[parent] [reference] float32 {who}: worst rel by seed "
              f"{', '.join(f'{s}: {v:.3e}' for s, v in worst.items())} "
              f"(bound {REFERENCE_BOUND[torch.float32]:g} at seed 0) on "
              f"{card_line()}", flush=True)


def _plain_update_finish(iLA, rhs, dtype, out=None):
    """K8's plain version (cuBLAS's product and m_new's, the casts) in
    ``natgrad.update_finish``'s place: [graph]'s yardstick, never the
    program's."""
    from hlax_torch.ops import natgrad

    m_new, H_new = natgrad.update_finish_plain(iLA, rhs, dtype)
    if out is None:
        return m_new, H_new
    out[0].copy_(m_new)
    out[1].copy_(H_new)
    return out


def _k8_plain_turns(state, spec0, spec1, cfg, staged, idx, kernel_run):
    """The canonical float32 graph step (unroll 10) with K8 against the same
    step captured with its plain version in K8's place (``natgrad.
    update_finish`` swapped for ``_plain_update_finish`` while its graphs
    are captured), in turns kernel, plain, plain, kernel of 3 epochs."""
    from hlax_torch.ops import natgrad
    from hlax_torch.train import step as tstep

    saved = natgrad.update_finish
    natgrad.update_finish = _plain_update_finish
    try:
        fn = tstep.make_train_epoch(state.vae, spec0, spec1, cfg, unroll=10)
        fn(state, staged, idx)
        fn(state, staged, idx)
    finally:
        natgrad.update_finish = saved
    turns = {"K8": kernel_run, "plain": lambda: fn(state, staged, idx)}
    rates = {k: [] for k in turns}
    for k in ("K8", "plain", "plain", "K8"):
        rates[k].append(_time_epochs(turns[k], 3))
    print("[graph] graph unroll 10, float32, K8 against its plain version "
          "(cuBLAS's product) in its place: steps/s "
          + "; ".join(f"{k} " + ", ".join(f"{x:.2f}" for x in r)
                      for k, r in rates.items())
          + f" (turns K8, plain, plain, K8 of 3 epochs) on {card_line()}",
          flush=True)


def phase_graph(data_dir: str, tmp: str) -> None:
    """The CUDA graphs of ``make_train_epoch`` against the eager steps on
    the canonical config (``_graph_check``), in float64 and float32 with
    the noise injected and drawn from the generator, both sides with
    cuDNN's deterministic algorithms (beside them, two eager runs with its
    default ones, whose weight gradients sum with atomics); then, in float32,
    steps/s of the eager path and of the graph path (unroll 1 and 10, and
    10 with the epoch pregathered), in alternating rounds of 3 epochs each,
    the graph step with K8's plain version in its place in turns with K8's
    (``_k8_plain_turns``), and the graph path's device time and idle share
    under the profiler."""
    from hlax_torch.data.dataset import epoch_subject_batches, stage_dataset
    from hlax_torch.train import step as tstep

    ds, spec0, spec1 = canonical_setup(data_dir)
    idx = np.stack(list(epoch_subject_batches(ds.P, 20,
                                              np.random.default_rng(0))))
    if len(idx) != GRAPH_STEPS:
        fail(f"[graph] the canonical epoch has {len(idx)} batches")
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).removeprefix("torch.")
        staged = stage_dataset(ds, dtype, "cuda")
        eps = torch.randn((GRAPH_STEPS, 20 * ds.T_max, 32), dtype=dtype,
                          device="cuda",
                          generator=torch.Generator("cuda").manual_seed(1))
        spread = _eager_spread(ds, spec0, spec1, dtype, staged, idx, eps)
        print(f"[graph] {tag}: eager against eager, cuDNN's default "
              f"algorithms, {GRAPH_STEPS} steps: {spread}", flush=True)
        with cudnn_deterministic():
            _graph_check(tag, ds, spec0, spec1, dtype, staged, idx, eps, 1,
                         tmp)
            a, b, cfg = _graph_check(tag, ds, spec0, spec1, dtype, staged,
                                     idx, None, 3, tmp)
        if dtype == torch.float64:
            del a, b
            torch.cuda.empty_cache()
    step = tstep.make_train_step(a.vae, spec0, spec1, cfg)
    paths = {"eager": lambda: tstep.train_epoch(step, a, staged, idx)}
    for name, unroll, pre in (("graph unroll 1", 1, False),
                              ("graph unroll 10", 10, False),
                              ("graph unroll 10 pregather", 10, True)):
        fn = tstep.make_train_epoch(b.vae, spec0, spec1, cfg, unroll=unroll,
                                    pregather=pre)
        fn(b, staged, idx)      # warm-up steps and the first captures
        fn(b, staged, idx)
        paths[name] = (lambda fn: lambda: fn(b, staged, idx))(fn)
    rates = {name: [] for name in paths}
    for _ in range(3):
        for name, run in paths.items():
            rates[name].append(_time_epochs(run, 3))
    for name, r in rates.items():
        print(f"[graph] {name}: steps/s {', '.join(f'{x:.2f}' for x in r)} "
              f"(3 rounds of 3 epochs of {GRAPH_STEPS} steps, alternating) "
              f"on {card_line()}", flush=True)
    _k8_plain_turns(b, spec0, spec1, cfg, staged, idx,
                    paths["graph unroll 10"])
    eager, table = _profile_steps("graph eager", paths["eager"],
                                  3 * GRAPH_STEPS, calls=3, top=40,
                                  focus=FUSED_FOCUS)
    gp_attribution("graph", gp_rows(eager["by_name"], table,
                                    3 * GRAPH_STEPS))
    for name in ("graph unroll 1", "graph unroll 10"):
        summary, own = _profile_steps(name, paths[name], 3 * GRAPH_STEPS,
                                      calls=3, table=table, top=40)
        # region_table on real events: a replayed kernel is in no row, only
        # the epoch's few eager launches around the graphs are
        own_n = sum(n for r in own.values() for n, _ in r.values())
        total = summary["kernels"] * 3 * GRAPH_STEPS
        print(f"[graph] {name}: region_table holds {own_n} of the "
              f"profile's {total:.0f} kernels (the launches outside the "
              "graphs)", flush=True)
        if own_n > 0.1 * total:
            fail(f"[graph] {name}: region_table gave {own_n} of {total:.0f} "
                 f"kernels a region, replayed ones among them: {own}")


# the fused step ops' kernels by name (csrc/fusion.cu), each printed with
# its in-step device time by [graph]'s eager profile
FUSED_FOCUS = (r"heads_cat_fwd|heads_cat_bwd|heads_real_fwd|heads_real_bwd|"
               r"rep_image_fwd|rep_image_bwd|recon_metric_finish|"
               r"recon_metric|gp_fwd|gp_bwd_flat|gp_bwd_cols")
# a cuBLAS or cuDNN kernel that takes TF32 says so in its name: "tf32"
# (sm80/sm90 xmma kernels, e.g. ..._tf32f32_tf32f32_f32_...), CUTLASS's
# "tensorop_s" / "s1688" / "s16816" float32-on-tensor-core gemms, or the
# element type "tfloat32_t" in cuDNN's mangled CUTLASS convolutions
TF32_MARK = re.compile(r"tf32|tfloat32|tensorop_s|s1688|s16816", re.I)
# the train step's regions (``_region_of``) that run the VAE's convolutions
# and dense layers, and those that run the GP
VAE_REGIONS = ("encoder", "decoder", "backward of encoder",
               "backward of decoder")
GP_REGIONS = ("gp_bound", "backward of gp_bound",
              "natural_gradient_quantities", "natural_gradient")
# the launching operations of [precision]'s per-layer list
LAYER_OPS = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
             "aten::convolution_backward", "aten::addmm", "aten::mm",
             "aten::bmm")


# the GP's kernels by group ([graph]'s attribution): the GP kernel
# matrices (csrc/fusion.cu), the Cholesky kernels (csrc/chol_inv_*.cu), the
# bound's own kernels (csrc/gp_bound.cu), the natural-gradient chain's
# (csrc/natgrad.cu), cuBLAS's products; the rest elementwise, reduction or
# copy
GP_GROUPS = (("GP matrices", re.compile(r"gp_fwd|gp_bwd_flat|gp_bwd_cols")),
             ("Cholesky kernels", re.compile(r"chol_inv")),
             ("bound kernels", re.compile(r"gp_bound_")),
             ("natural-gradient kernels", re.compile(r"natgrad_")),
             ("cuBLAS GEMMs", re.compile(
                 r"gemm|gemv|cublas|cutlass|xmma|splitK|dot_kernel", re.I)),
             ("elementwise, reduction or copy", re.compile("")))


def gp_rows(by_name: dict, table: dict, steps: int) -> dict:
    """{region: [(kernel name, launches a step, device ms a step, launches
    a step of the name in the whole profile)]} of the GP's regions
    (GP_REGIONS: the bound, its backward, the bound's natural-gradient
    quantities inside it and the natural-gradient update) in ``steps``
    eager steps under the profiler: the launches and time ``table``
    (``region_table``, each device kernel counted once) gives the region;
    a tree without a region (an earlier commit's) has no row of it."""
    out = {}
    for region in GP_REGIONS:
        rows = [(name, split[region][0] / steps,
                 split[region][1] / steps / 1e3, by_name[name][0] / steps)
                for name, split in table.items()
                if region in split and name in by_name]
        if rows:
            out[region] = rows
    return out


def gp_attribution(tag: str, rows: dict) -> dict:
    """Prints ``gp_rows``' kernels, grouped by GP_GROUPS, each with its
    name's launches a step in the whole profile in brackets; returns
    {region: (kernels, ms) a step}."""
    totals = {}
    for region, kernels in rows.items():
        totals[region] = (sum(r[1] for r in kernels),
                          sum(r[2] for r in kernels))
        print(f"[{tag}] {region}: {totals[region][0]:.1f} kernels, "
              f"{totals[region][1]:.4f} ms a step (eager) on {card_line()}",
              flush=True)
        left = kernels
        for group, pat in GP_GROUPS:
            mine = [r for r in left if pat.search(r[0])]
            left = [r for r in left if not pat.search(r[0])]
            if not mine:
                continue
            print(f"[{tag}]   {group}: {sum(r[1] for r in mine):.1f} "
                  f"kernels, {sum(r[2] for r in mine):.4f} ms", flush=True)
            for name, n, ms, n_all in sorted(mine, key=lambda r: -r[2]):
                print(f"[{tag}]     {n:5.2f} {ms:8.5f} [of {n_all:.2f}]  "
                      f"{name}", flush=True)
    return totals


def _launching_op(e):
    a = e
    while a is not None and a.name not in LAYER_OPS:
        a = a.cpu_parent
    return a


def phase_precision(data_dir: str) -> None:
    """[precision] hlax's split on the canonical float32 step under the
    precision of JAX_DEFAULT_MATMUL_PRECISION (unset: "default", TF32 in
    the VAE): an eager step under the profiler with shapes, every
    convolution and matmul's kernels by layer (its operation and input
    shapes) and region, marked TF32 where the name says so; then the graph
    replay of 30 steps under the profiler, each region's kernels (names
    split as the eager profile splits them) with and without the TF32
    mark.  Fails if a GP region runs a TF32 kernel, or, under a TF32
    precision, if a VAE region runs none."""
    from torch.profiler import ProfilerActivity, profile

    from hlax_torch import precision
    from hlax_torch.data.dataset import epoch_subject_batches, stage_dataset
    from hlax_torch.profiling import REGIONS
    from hlax_torch.train import step as tstep

    name = precision.from_env()
    ds, spec0, spec1 = canonical_setup(data_dir)
    idx = np.stack(list(epoch_subject_batches(ds.P, 20,
                                              np.random.default_rng(0))))
    st, cfg = canonical_state(ds, spec0, spec1, torch.float32)
    staged = stage_dataset(ds, torch.float32, "cuda")
    step = tstep.make_train_step(st.vae, spec0, spec1, cfg)
    tstep.train_epoch(step, st, staged, idx[:2])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        tstep.train_epoch(step, st, staged, idx[:1])
        torch.cuda.synchronize()
    events = prof.events()
    seq_region = {}
    for e in events:
        if e.sequence_nr is None or e.sequence_nr < 0:
            continue
        a = e.cpu_parent
        while a is not None and a.name not in REGIONS:
            a = a.cpu_parent
        if a is not None and a.name not in ("backward", "adam"):
            seq_region.setdefault(e.sequence_nr, a.name)
    layers = {}
    for e in events:
        for k in getattr(e, "kernels", ()):
            op = _launching_op(e)
            if op is None:
                continue
            key = (_region_of(e, seq_region), op.name,
                   str([list(x) for x in op.input_shapes if x][:2]), k.name)
            acc = layers.setdefault(key, [0, 0.0])
            acc[0] += 1
            acc[1] += k.duration
    print(f"[precision] JAX_DEFAULT_MATMUL_PRECISION={name!r} (TF32 in the "
          f"VAE: {precision.uses_tf32(name)}); one eager canonical float32 "
          "step, each convolution and matmul's kernels by region, "
          "operation and input shapes: launches, device us, TF32 mark",
          flush=True)
    for (region, op, shapes, kname), (n, us) in sorted(layers.items()):
        mark = "TF32" if TF32_MARK.search(kname) else "fp32"
        print(f"[precision]   {region:22s} {op:34s} {shapes:32s} {n:3d} "
              f"{us:8.1f} {mark} {kname}", flush=True)
    table = region_table(prof)
    epoch = tstep.make_train_epoch(st.vae, spec0, spec1, cfg)
    epoch(st, staged, idx)
    epoch(st, staged, idx)
    summary, _ = _profile_steps(
        "precision graph", lambda: epoch(st, staged, idx), 3 * GRAPH_STEPS,
        calls=3, table=table, top=0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        epoch(st, staged, idx)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA") and not getattr(
                e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0) + 1
    regions = {}
    for kname, n in by_name.items():
        split = table.get(kname) or {"unattributed": [n, 0.0]}
        tot = sum(v[0] for v in split.values())
        for r, (rn, _) in split.items():
            regions.setdefault(r, {})[kname] = n * rn / tot / GRAPH_STEPS
    print("[precision] the graph replay's kernels a step by region, with and "
          "without the TF32 mark:", flush=True)
    bad, missing = [], []
    for r in sorted(regions):
        tf = {k: v for k, v in regions[r].items() if TF32_MARK.search(k)}
        other = {k: v for k, v in regions[r].items() if k not in tf}
        print(f"[precision]   {r}: TF32 {sum(tf.values()):.1f} "
              f"({', '.join(f'{v:.1f} {k[:110]}' for k, v in sorted(tf.items()))}); "
              f"others {sum(other.values()):.1f}", flush=True)
        if r in GP_REGIONS and tf:
            bad.append(r)
        if r in VAE_REGIONS and not tf:
            missing.append(r)
    if bad:
        fail(f"[precision] GP regions ran TF32 kernels: {bad}")
    if precision.uses_tf32(name) and missing:
        fail(f"[precision] VAE regions ran no TF32 kernel: {missing}")
    if not precision.uses_tf32(name) and any(
            TF32_MARK.search(k) for k in by_name):
        fail("[precision] a TF32 kernel ran under a full float32 precision")
    if not torch.isfinite(st.m).all():
        fail("[precision] m is not finite")
    del st, staged, epoch, step
    torch.cuda.empty_cache()


def _print_ab(tag: str, runs: dict, configs) -> None:
    """Each configuration's steps/s, busy ms, kernels, idle share and ms by
    region of each arm's runs (``rate_run`` JSON), and the region table
    side by side."""
    for name, *_ in configs:
        for arm, rs in runs.items():
            r = [x[name] for x in rs]
            print(f"[{tag}] {name} {arm}: graph steps/s "
                  f"{', '.join(f'{v:.2f}' for x in r for v in x['steps_per_s'])}"
                  f"; device busy {', '.join(f'{x['busy_ms']:.3f}' for x in r)}"
                  f" ms/step; kernels/step "
                  f"{', '.join(f'{x['kernels']:.1f}' for x in r)}; idle "
                  f"{', '.join(f'{x['idle']:.3f}' for x in r)} on "
                  f"{card_line()}", flush=True)
            if "eval" in r[0]:
                print(f"[{tag}] {name} {arm}: imputation-eval samples/s "
                      f"{', '.join(f'{x['eval'][0]:.1f}' for x in r)}; a "
                      f"pass {', '.join(f'{x['eval'][2]:.3f}' for x in r)} "
                      f"ms device busy in "
                      f"{', '.join(str(x['eval'][3]) for x in r)} kernels",
                      flush=True)
        names = sorted({g for rs in runs.values() for x in rs
                        for g in (x[name]["regions"] or {})},
                       key=lambda g: -max((x[name]["regions"] or {}).get(
                           g, (0, 0))[1] for rs in runs.values()
                           for x in rs))
        for g in names:
            cells = "; ".join(
                f"{arm} " + ", ".join(
                    f"{(x[name]['regions'] or {}).get(g, (0, 0))[1]:.3f}"
                    for x in rs) for arm, rs in runs.items())
            print(f"[{tag}]   {name} {g:34s} ms/step: {cells}", flush=True)


def _subprocess_json(args, prefix: str, env: dict, tag: str,
                     timeout: int = 600) -> dict:
    """``python3 chip_smoke.py <args>`` in a process of its own with ``env``
    added: the JSON of its output line that starts with ``prefix``."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__)] + args,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, **env})
    line = [x for x in proc.stdout.splitlines() if x.startswith(prefix)]
    if proc.returncode != 0 or not line:
        fail(f"[{tag}] {' '.join(args)} failed ({proc.returncode}): "
             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    return json.loads(line[0][len(prefix):])


def phase_precision_ab(data_dir: str) -> None:
    """``python3 chip_smoke.py precision``: "highest" against "default"
    (JAX_DEFAULT_MATMUL_PRECISION) in processes of their own, in turns
    highest, default, default, highest: each of PRECISION_CONFIGS' graph
    steps/s, device busy ms, kernels, idle share and ms by region
    (``rate_run`` ab); then [full]'s 300 canonical epochs through the CLI
    for seeds 0, 1, 2 in each arm (turns highest, default; default,
    highest; highest, default): the final training net loss and the last
    validation net loss, each arm's mean, min and max, and the quality
    gate: the TF32 arm's mean within the larger of 1 % of the float32
    arm's mean and its min-max range."""
    env = lambda arm: {"JAX_DEFAULT_MATMUL_PRECISION": arm}
    runs = {"highest": [], "default": []}
    for arm in ("highest", "default", "default", "highest"):
        runs[arm].append(_subprocess_json(["rate", ROOT, data_dir, "ab"],
                                          "RATE ", env(arm), "precision"))
    _print_ab("precision", runs, PRECISION_CONFIGS)
    fulls = {"highest": [], "default": []}
    for seed, arms in ((0, ("highest", "default")), (1, ("default",
                                                         "highest")),
                       (2, ("highest", "default"))):
        for arm in arms:
            fulls[arm].append(_subprocess_json(
                ["rate", ROOT, data_dir, "full", str(seed)], "FULL ",
                env(arm), "precision"))
    for key in ("final", "validation"):
        f32 = np.array([x[key] for x in fulls["highest"]])
        tf32 = np.array([x[key] for x in fulls["default"]])
        band = max(0.01 * abs(f32.mean()), f32.max() - f32.min())
        held = abs(tf32.mean() - f32.mean()) <= band
        print(f"[precision] [full] {FULL_EPOCHS} epochs, seeds 0, 1, 2, "
              f"{key} net loss: highest {', '.join(f'{v:.6g}' for v in f32)}"
              f" (mean {f32.mean():.6g}, range {f32.max() - f32.min():.6g});"
              f" default {', '.join(f'{v:.6g}' for v in tf32)} (mean "
              f"{tf32.mean():.6g}); |difference of means| "
              f"{abs(tf32.mean() - f32.mean()):.6g} against "
              f"{band:.6g}: gate {'holds' if held else 'FAILS'}; seconds "
              f"{', '.join(f'{x['seconds']:.1f}' for x in fulls['highest'])}"
              f" / {', '.join(f'{x['seconds']:.1f}' for x in fulls['default'])}"
              f" on {card_line()}", flush=True)


# the options of hlax's model on the canonical config through the CLI:
# (tag, name, flags, epochs, final validation and tests)
# the fused VAE ops the all-bfloat16 model runs in their plain versions
# (the kernels take float32 and float64); its GP stays in float32
BF16_PLAIN = frozenset({"heads_loglik_plain", "rep_image_plain",
                        "recon_metric_plain"})
OPTION_RUNS = [
    ("bf16", "float32", {}, 2, False),
    ("bf16", "compute_dtype=bfloat16", {"compute_dtype": "bfloat16"}, 3,
     True),
    ("bf16", "model_dtype=bfloat16", {"model_dtype": "bfloat16"}, 2, False),
    ("fused", "fused_conv", {"fused_conv": True}, 3, False),
]


def phase_options(data_dir: str, tmp: str) -> dict:
    """[bf16] and [fused] through the CLI on the graph path: the canonical
    config in float32, with --compute_dtype=bfloat16 (3 epochs, the final
    validation and the test battery), with --model_dtype=bfloat16 (2
    epochs) and with --fused_conv=True (3 epochs).  Each run: its steps,
    finite losses, the model built as asked, no plain version on the card,
    and all three kernels launched on its path (the GP stays in float32).
    Then steps/s of every run's own graphs in alternating rounds of 3
    epochs, and each one's device time under the profiler.  Returns the
    launches by (kernel, shape, dtype) of each run."""
    from hlax_torch.config import ModelArgs
    from hlax_torch.data.dataset import epoch_subject_batches

    b, k2, m = (32, 20, 20, 20), (64, 120, 120), (32, 120, 120)
    outs, counts = {}, {}
    for tag, name, over, epochs, ev in OPTION_RUNS:
        opt = ModelArgs().parse_options([f"--f={CONFIG}"])
        opt.update(data_source_path=data_dir,
                   save_path=os.path.join(tmp, f"run_{name}"), epochs=epochs,
                   run_validation=ev, run_tests=ev, generate_images=False,
                   device="cuda", **over)
        t0 = time.perf_counter()
        out, launches, by_shape, plain = _run_cli(
            opt, os.path.join(tmp, f"{name}.log"))
        seconds = time.perf_counter() - t0
        steps = 10 * epochs
        rows = _check_run(f"{tag} {name}", out, steps, plain, validation=ev,
                          allowed=BF16_PLAIN if "model_dtype" in over
                          else frozenset())
        want = {("chol_inv_small_cuda", b, "float32"): steps,
                ("chol_inv_bwd_cuda", b, "float32"): steps,
                ("chol_inv_mid_cuda", k2, "float32"): steps,
                ("chol_inv_mid_cuda", m, "float32"): steps,
                ("chol_inv_mid_bwd_cuda", k2, "float32"): steps}
        if ev:
            want[("chol_inv_mid_cuda", (32, 256, 32, 32), "float32")] = 1
        _need(f"{tag} {name}", by_shape, want)
        model = out["model"]
        dtypes = {p.dtype for p in model.parameters()}
        built = {"float32": dtypes == {torch.float32}
                 and model.cfg.compute_dtype is None
                 and not model.cfg.fused_conv,
                 "compute_dtype=bfloat16": dtypes == {torch.float32}
                 and model.cfg.compute_dtype == torch.bfloat16,
                 "model_dtype=bfloat16": dtypes == {torch.bfloat16},
                 "fused_conv": model.cfg.fused_conv}[name]
        if not built or out["state"].zt.dtype != torch.float32:
            fail(f"[{tag}] {name}: the model was not built as asked "
                 f"({dtypes}, {model.cfg.compute_dtype}, "
                 f"fused {model.cfg.fused_conv}, GP {out['state'].zt.dtype})")
        ev_s = out["eval_seconds"]
        print(f"[{tag}] {name}: losses per epoch {out['loss_arrs']['net']}; "
              f"run {seconds:.1f} s; launches {launches}; plain versions on "
              f"CUDA tensors {plain}" + (
                  f"; final validation {ev_s['validation']:.3f} s (rows "
                  f"{rows}), tests {ev_s['tests']:.3f} s" if ev else ""),
              flush=True)
        outs[name], counts[name] = out, by_shape
    idx = np.stack(list(epoch_subject_batches(200, 20,
                                              np.random.default_rng(0))))
    paths = {name: (lambda o: lambda: o["train_epoch"](
        o["state"], o["staged"], idx))(o) for name, o in outs.items()}
    rates = {name: [] for name in paths}
    for _ in range(3):
        for name, run in paths.items():
            rates[name].append(_time_epochs(run, 3))
    for tag, name, *_ in OPTION_RUNS:
        if not torch.isfinite(outs[name]["state"].m).all():
            fail(f"[{tag}] {name}: m is not finite after the timed epochs")
        print(f"[{tag}] {name}: graph path steps/s "
              f"{', '.join(f'{x:.2f}' for x in rates[name])} (3 rounds of 3 "
              f"epochs of {GRAPH_STEPS} steps, alternating with "
              f"{', '.join(n for n in paths if n != name)}) on {card_line()}",
              flush=True)
    for tag, name, *_ in OPTION_RUNS:
        _profile_steps(f"{tag} {name}", paths[name], 3 * GRAPH_STEPS,
                       calls=3)
    return counts


# the fused stack against cuDNN's at the canonical shapes, relative to each
# tensor's norm: float32 with TF32 off (precision "highest"), two summation
# orders of the same products.  A bias gradient sums 400 x 36 x 36 terms
# that cancel (2e-5 apart on the CPU), so gradients get hlax's own bar for
# its fused model against its unfused one (tests/test_convfuse.py, 1e-3)
FUSED_BOUND = {"outputs": 1e-4, "gradients": 1e-3}


def phase_fused_stack(data_dir: str) -> None:
    """[fused] directly, at the canonical shapes: 400 rows (20 subjects of
    20 frames, a batch), 36x36 images, the canonical widths, float32.  The
    fused stack (hlax's patch matmuls) and cuDNN's convolutions from one
    set of weights, both in full float32 (precision "highest"): mu,
    log_var, log_p_x and every parameter's gradient of the summed NLL
    within FUSED_BOUND; beside them the same under TF32 (precision
    "default"), printed.  Then each one's VAE forward + backward time in
    both precisions, in turns cuDNN, fused, fused, cuDNN: device time by
    CUDA events over 20 replays of a CUDA graph of it, as the train step
    runs it (an eager forward + backward is hundreds of launches, more than
    the launch queue holds ahead of ``time_ms``'s spin kernel, so its
    events would time the host)."""
    import dataclasses

    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig, nll_from_log_p

    ds, _, _ = canonical_setup(data_dir)
    rows = 400
    t = lambda a: torch.as_tensor(a[:rows], dtype=torch.float32,
                                  device="cuda")
    x, mask, tmask = t(ds.het.data), t(ds.het.mask), t(ds.het.theta_mask)
    eps = torch.randn((rows, 32), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(3))
    cfg = HLVAEConfig(layout=ds.layout, z_dim=32, h_dims=(500,), y_dim=5,
                      conv=True)
    models = {}
    for prec in ("highest", "default"):
        for fused in (False, True):
            models[fused, prec] = HLVAE(
                dataclasses.replace(cfg, fused_conv=fused, precision=prec),
                torch.Generator("cuda").manual_seed(0), "cuda")
            models[fused, prec].load_state_dict(
                models[False, "highest"].state_dict())

    def fwd_bwd(model):
        model.zero_grad(set_to_none=False)
        out = model(x, mask, tmask, eps=eps)
        nll_from_log_p(out["log_p_x"]).sum().backward()
        return out

    outs = {k: fwd_bwd(m) for k, m in models.items()}
    rel = lambda u, v: ((u - v).norm() / v.norm().clamp_min(1e-30)).item()
    for prec in ("highest", "default"):
        worst = {}
        for k in ("mu", "log_var", "log_p_x"):
            worst[k] = rel(outs[True, prec][k], outs[False, prec][k])
        grads = dict(models[False, prec].named_parameters())
        for k, p in models[True, prec].named_parameters():
            if grads[k].grad is not None:
                worst[f"grad {k}"] = rel(p.grad, grads[k].grad)
        top = sorted(worst.items(), key=lambda kv: -kv[1])[:6]
        print(f"[fused] fused against cuDNN at [{rows}, 36, 36] float32, "
              f"precision {prec}: mu {worst['mu']:.3g}, log_var "
              f"{worst['log_var']:.3g}, log_p_x {worst['log_p_x']:.3g}; "
              f"largest {top}" + (f" (bounds {FUSED_BOUND})" if prec ==
                                  "highest" else " (TF32: not held)"),
              flush=True)
        bad = {k: v for k, v in worst.items() if not v <= FUSED_BOUND[
            "gradients" if k.startswith("grad") else "outputs"]}
        if bad and prec == "highest":
            fail(f"[fused] the fused stack disagrees with cuDNN's: {bad}")
    # the autograd graphs of the eager calls above hold each parameter's
    # gradient accumulator, made on the default stream; drop them, so that
    # the warm-up on the capture's stream makes them there
    del outs
    graphs, side = {}, torch.cuda.Stream()
    for key, model in models.items():
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fwd_bwd(model)
        torch.cuda.current_stream().wait_stream(side)
        graphs[key] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[key], stream=side):
            fwd_bwd(model)
    for prec in ("highest", "default"):
        times = {False: [], True: []}
        for fused in (False, True, True, False):
            times[fused].append(time_ms(graphs[fused, prec].replay, reps=20,
                                        warmup=3)[0])
        print(f"[fused] VAE forward + backward of {rows} rows, precision "
              f"{prec}: cuDNN {', '.join(f'{v:.4f}' for v in times[False])} "
              f"ms, fused {', '.join(f'{v:.4f}' for v in times[True])} ms "
              f"(device, CUDA events over graph replays; turns cuDNN, fused, "
              f"fused, cuDNN) on {card_line()}", flush=True)


def phase_full(data_dir: str, tmp: str) -> None:
    """The canonical config's full run through the CLI on the graph path:
    FULL_EPOCHS epochs of 10 steps in bursts of up to 5 epochs
    (--epochs_per_dispatch=5), 10 steps a graph (--scan_unroll=10),
    validation every 5 epochs, the save-interval evaluations, the final
    validation and the test battery."""
    from hlax_torch.config import ModelArgs

    opt = ModelArgs().parse_options([f"--f={CONFIG}"])
    opt.update(data_source_path=data_dir,
               save_path=os.path.join(tmp, "run_full"), epochs=FULL_EPOCHS,
               run_validation=True, run_tests=True, generate_images=False,
               device="cuda", epochs_per_dispatch=5, scan_unroll=10)
    log = os.path.join(tmp, "full.log")
    t0 = time.perf_counter()
    out, launches, by_shape, plain = _run_cli(opt, log)
    seconds = time.perf_counter() - t0
    steps = 10 * FULL_EPOCHS
    rows = _check_run("full", out, steps, plain)
    _need("full", by_shape, {
        ("chol_inv_small_cuda", (32, 20, 20, 20), "float32"): steps,
        ("chol_inv_bwd_cuda", (32, 20, 20, 20), "float32"): steps,
        ("chol_inv_mid_cuda", (64, 120, 120), "float32"): steps,
        ("chol_inv_mid_bwd_cuda", (64, 120, 120), "float32"): steps})
    with open(log) as f:
        text = f.read()
    validations = text.count("Validation Duration")
    train_s = float(re.search(r"Duration of training: ([\d.]+)",
                              text).group(1))
    if validations != FULL_EPOCHS // 5:
        fail(f"[full] {validations} validations in {FULL_EPOCHS} epochs")
    net = out["loss_arrs"]["net"]
    print(f"[full] {FULL_EPOCHS} epochs ({steps} steps): net loss first "
          f"{net[0]:.6g}, final {net[-1]:.6g}; validation curve "
          f"({validations} points) last net_loss "
          f"{out['last_validation']['net_loss']:.6g}; final validation "
          f"GP_loss {rows['GP_loss']:.6g}, net_loss {rows['net_loss']:.6g}; "
          f"training {train_s:.1f} s ({steps / train_s:.2f} steps/s with "
          f"validation), run {seconds:.1f} s; launches {launches} on "
          f"{card_line()}", flush=True)


# the [mesh] phase: a 2 x 2 mesh of gloo processes sharing cuda:0 (NCCL
# refuses two ranks on one card) against the single process on the same
# card, MESH_STEPS eager steps over the same global batches and noise, both
# with cuDNN's deterministic algorithms.  The two sum in other orders (a
# rank's 10 subjects, the all-reduces).  In float64 the losses must agree
# within 1e-4 and the GP state and the VAE's parameters within 1e-3 after
# the steps (measured: 3e-9 and 3e-6).  In float32 the canonical bound's
# first step is ill-conditioned: the single process moves it by ~1e-3
# when it only reverses the order of its 20 subjects and is ~2e-3 off the
# float64 value of the same state (``_first_step_spread`` prints both), its
# kernel-parameter gradients far more; so float32 is held only coarsely,
# within 5e-2 on the first step's loss, where a dropped or doubled share of
# the loss (the NLL is a quarter of it) is out of range, and its later
# differences are reported
MESH_STEPS = 10
MESH_DTYPES = (torch.float64, torch.float32)
MESH_BOUND = {torch.float32: {"loss": 5e-2},
              torch.float64: {"loss": 1e-4, "state": 1e-3}}
# the local shapes of the 2 x 2 mesh (16 latents, 10 subjects a rank) that
# no single-card path launches, and get rows in the kernel table
MESH_ROWS = [("chol_inv_small_cuda", (16, 10), 20),
             ("chol_inv_bwd_cuda", (16, 10), 20),
             ("chol_inv_mid_cuda", (16,), 120)]
# what every rank of a mesh launches at least once a step, by (data ranks,
# latent ranks): the B blocks and their backward [L_loc, S_loc, 20, 20],
# K0zz stacked with H [2 L_loc, 120, 120], the natural-gradient inverse
# [L_loc, 120, 120]
def _mesh_launches(n_data: int, n_latent: int, dtype: str = "float32"):
    """What a rank of an n_data x n_latent mesh launches each step: the
    Cholesky kernels at its latents and subjects, and the fused kernels'
    forward at its rows (the recon metric's column sums in one launch, then
    its finish after the ranks' sums; a rank of latent rank > 0 takes no
    gradient of the VAE)."""
    L, S = 32 // n_latent, 20 // n_data
    rows = (S * 20, CANONICAL_N_EXP)
    return {("chol_inv_small_cuda", (L, S, 20, 20), dtype): 1,
            ("chol_inv_bwd_cuda", (L, S, 20, 20), dtype): 1,
            ("chol_inv_mid_cuda", (2 * L, 120, 120), dtype): 1,
            ("chol_inv_mid_cuda", (L, 120, 120), dtype): 1,
            ("chol_inv_mid_bwd_cuda", (2 * L, 120, 120), dtype): 1,
            ("heads_cat_fwd_cuda", (S * 20, 1296, 5), dtype): 1,
            ("heads_real_fwd_cuda", (S * 20, 1296, 5), dtype): 1,
            ("rep_image_fwd_cuda", rows, dtype): 2,
            ("recon_metric_cuda", rows, dtype): 1,
            ("recon_metric_finish_cuda", rows, dtype): 1,
            ("gp_kernel_fwd_cuda", (L, S, 20, 120), dtype): 1,
            **natgrad_need(L, S, 20, 120, dtype, dtype, 1)}


@contextlib.contextmanager
def _fd_stdout(path: str):
    """File descriptor 1 (this process's and its children's standard
    output) into ``path`` inside the block."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "a") as f:
        os.dup2(f.fileno(), 1)
        try:
            yield
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)


def _gp_and_vae(state) -> dict:
    """The state's GP tensors and VAE parameters by name, on the host."""
    ts = {"m": state.m, "H": state.H, "zt": state.zt}
    for i, p in enumerate(state.k0 + state.k1):
        ts.update({f"kernel{i}.{k}": v for k, v in p.items()})
    ts.update({f"vae.{k}": v for k, v in state.vae.named_parameters()})
    return {k: v.detach().cpu() for k, v in ts.items()}


def _mesh_rank(rank: int, world: int, init: str, data_dir: str,
               idx_mesh: np.ndarray, eps: torch.Tensor) -> dict:
    """A rank of [mesh]: gloo on cuda:0; in each of MESH_DTYPES, the
    canonical state made from the seed and sharded, MESH_STEPS eager mesh
    steps.  Returns by dtype its losses, its gradients of the first step,
    its launches and (rank 0) the whole state after the steps."""
    torch.cuda.set_device(0)
    torch.backends.cudnn.deterministic = True
    from hlax_torch.data.dataset import gather_batch, stage_dataset_mesh
    from hlax_torch.ops import linalg_small as ls
    from hlax_torch.parallel import distributed as pdist
    from hlax_torch.parallel import mesh as pmesh
    from hlax_torch.train import step as tstep

    pdist.initialize("gloo", init, world, rank)
    try:
        mesh = pmesh.make_mesh(2, 2)
        ds, spec0, spec1 = canonical_setup(data_dir)
        rows = idx_mesh.shape[-1] * ds.T_max
        idx = torch.as_tensor(idx_mesh[:, mesh.d], device="cuda")
        outs = {}
        for dtype in MESH_DTYPES:
            whole, cfg = canonical_state(ds, spec0, spec1, dtype)
            state = pmesh.shard_state(whole, mesh, cfg)
            del whole
            staged = stage_dataset_mesh(ds, dtype, "cuda", 2, mesh.d)
            step = tstep.make_train_step(state.vae, spec0, spec1, cfg,
                                         mesh=mesh)
            e = eps[:, mesh.d * rows:(mesh.d + 1) * rows].to("cuda", dtype)
            reset_all_counters()
            t0 = time.perf_counter()
            loss = []
            for j in range(MESH_STEPS):
                loss.append(step(state, gather_batch(staged, idx[j]),
                                 eps=e[j])["loss"])
                if j == 0:
                    grads = [None if p.grad is None
                             else p.grad.detach().cpu()
                             for p in tstep.trainable(state, cfg)]
            loss = [x.item() for x in loss]
            out = outs[dtype] = {
                "loss": np.asarray(loss), "grads": grads,
                "slice": mesh.latent_slice(cfg.latent_dim),
                "n_vae": len(list(state.vae.parameters())),
                "seconds": time.perf_counter() - t0,
                **dict(zip(("launches", "plain"), read_all_counters()[1:]))}
            whole = pmesh.gather_state(state, mesh, cfg)
            if rank == 0:
                out["state"] = _gp_and_vae(whole)
            del state, whole, staged
        return outs
    finally:
        pdist.destroy()


def _first_step_spread(ds, spec0, spec1, idx, eps) -> dict:
    """The float32 canonical state's first step on the global batch ``idx``
    with noise ``eps``, three ways from one seed: as it is, with the
    batch's subjects (and their noise) in reverse order, and in float64;
    returns the three losses and the largest relative difference of the
    first two's gradients from the float64 ones."""
    import dataclasses

    from hlax_torch.data.dataset import gather_batch, stage_dataset
    from hlax_torch.train import step as tstep

    rev = np.arange(len(idx))[::-1].copy()
    T = ds.T_max
    out, grads = {}, {}
    for tag, dtype, order in (("float32", torch.float32, None),
                              ("reversed", torch.float32, rev),
                              ("float64", torch.float64, None)):
        st, cfg = canonical_state(ds, spec0, spec1, torch.float32)
        if dtype == torch.float64:
            cfg = dataclasses.replace(cfg, gp_dtype=dtype)
            st.vae.double()
            st.k0, st.k1 = ([{k: v.detach().double() for k, v in p.items()}
                             for p in ks] for ks in (st.k0, st.k1))
            st.raw_noise, st.zt, st.m, st.H = (
                t.detach().double() for t in (st.raw_noise, st.zt, st.m,
                                               st.H))
            st.optimizer = tstep.make_optimizer(st, cfg)
        e = eps.reshape(len(idx), T, -1)
        i, e = (idx, e) if order is None else (idx[order], e[order])
        step = tstep.make_train_step(st.vae, spec0, spec1, cfg)
        out[tag] = step(st, gather_batch(stage_dataset(ds, dtype, "cuda"),
                                         torch.as_tensor(i, device="cuda")),
                        eps=e.reshape(len(idx) * T, -1).to("cuda", dtype)
                        )["loss"].item()
        grads[tag] = [p.grad.detach().double() for p in
                      tstep.trainable(st, cfg) if p.grad is not None]
    for tag in ("float32", "reversed"):
        out[f"{tag} gradients"] = max(
            ((g - w).abs().max() / w.abs().max()).item()
            for g, w in zip(grads[tag], grads["float64"]) if w.any())
    return out


def _mesh_against_single(ds, spec0, spec1, ranks, idx, eps, spawn_s,
                         dtype):
    """[mesh] in ``dtype``: the ranks' results (``_mesh_rank``) against
    the single process over the same global batches ``idx`` and noise
    ``eps``; held at MESH_BOUND[dtype]."""
    from hlax_torch.data.dataset import gather_batch, stage_dataset
    from hlax_torch.train import step as tstep

    tag = str(dtype).removeprefix("torch.")
    bound = MESH_BOUND[dtype]
    ranks = [r[dtype] for r in ranks]
    with cudnn_deterministic():
        st, cfg = canonical_state(ds, spec0, spec1, dtype)
        step = tstep.make_train_step(st.vae, spec0, spec1, cfg)
        staged = stage_dataset(ds, dtype, "cuda")
        eps = eps.to("cuda", dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = []
        for j, i in enumerate(idx):
            loss.append(step(st, gather_batch(staged, torch.as_tensor(
                i, device="cuda")), eps=eps[j])["loss"])
            if j == 0:
                grads = [None if p.grad is None else p.grad.detach().cpu()
                         for p in tstep.trainable(st, cfg)]
        loss = np.asarray([x.item() for x in loss])
        single_s = time.perf_counter() - t0
    d_loss = np.max([np.abs(r["loss"] - loss) / np.abs(loss) for r in ranks],
                    axis=0)
    d_grad = 0.0
    for r in ranks:
        if len(r["grads"]) != len(grads):
            fail(f"[mesh] {tag}: a rank has gradients of {len(r['grads'])} "
                 f"tensors, the single process of {len(grads)}")
        for i, (g, w) in enumerate(zip(r["grads"], grads)):
            if w is None or g is None:
                if (w is None) != (g is None or not g.any()):
                    fail(f"[mesh] {tag}: parameter {i} has a gradient on "
                         "one side only")
                continue
            w = w[r["slice"]] if i >= r["n_vae"] else w
            d = (g - w).abs().max().item()
            d_grad = max(d_grad, d / w.abs().max().item() if w.any() else d)
    want = _gp_and_vae(st)
    got = ranks[0]["state"]
    d_state = {k: _rel(got[k], want[k]) for k in want}
    worst = max(d_state, key=d_state.get)
    print(f"[mesh] {tag}: 2 x 2 gloo ranks on cuda:0 against the single "
          f"process, {MESH_STEPS} eager steps: relative loss difference by "
          f"step {[float(f'{x:.3e}') for x in d_loss]}; first step's "
          f"gradients {d_grad:.3e}; after {MESH_STEPS} steps m "
          f"{d_state['m']:.3e}, H {d_state['H']:.3e}, largest "
          f"{d_state[worst]:.3e} ({worst}); losses {loss.tolist()}",
          flush=True)
    print(f"[mesh] {tag}, {MESH_STEPS} steps: ranks "
          f"{[round(r['seconds'], 3) for r in ranks]} s (gloo through the "
          f"host, 4 ranks on one card), single process {single_s:.3f} s; "
          f"spawn and set-up {spawn_s:.1f} s on {card_line()}", flush=True)
    if "state" in bound:
        bad = d_loss.max() > bound["loss"] or d_state[worst] > bound["state"]
    else:
        with cudnn_deterministic():
            ref = _first_step_spread(ds, spec0, spec1, idx[0], eps[0].cpu())
        f64 = ref["float64"]
        print(f"[mesh] float32's own first step: reversing the batch's "
              f"subjects moves the loss by "
              f"{abs(ref['reversed'] - ref['float32']) / f64:.3e}; against "
              f"the same state in float64, the loss is off by "
              f"{abs(ref['float32'] - f64) / f64:.3e} (reversed "
              f"{abs(ref['reversed'] - f64) / f64:.3e}, the mesh "
              f"{abs(ranks[0]['loss'][0] - f64) / f64:.3e}) and the "
              f"gradients by {ref['float32 gradients']:.3e} (reversed "
              f"{ref['reversed gradients']:.3e}), largest relative",
              flush=True)
        bad = d_loss[0] > bound["loss"] or not all(
            np.isfinite(r["loss"]).all() for r in ranks)
    if bad:
        fail(f"[mesh] {tag}: the mesh's steps differ from the single "
             f"process's beyond {bound}")
    for r, out in enumerate(ranks):
        if any(out["plain"].values()):
            fail(f"[mesh] rank {r} ran a plain version: {out['plain']}")
        for (name, shape, _), per in _mesh_launches(2, 2).items():
            key = (name, shape, tag)
            if out["launches"].get(key, 0) < per * MESH_STEPS:
                fail(f"[mesh] rank {r} launched {key} "
                     f"{out['launches'].get(key, 0)} times")
        print(f"[mesh] {tag} rank {r} launches by shape "
              f"{_by_shape_str(out['launches'])}", flush=True)
    return ranks


def phase_mesh(data_dir: str):
    """[mesh] on one card: the 2 x 2 mesh of gloo ranks on cuda:0 against
    the single process, canonical states from one seed, the same global
    batches and injected noise, MESH_STEPS eager steps each, in each of
    MESH_DTYPES (MESH_BOUND); every rank launching all three kernels at its
    local shapes and no plain version.  Then dryrun_multichip(4).  Returns
    the launches by shape and dtype, summed over the ranks."""
    from hlax_torch.data.dataset import epoch_subject_batches_mesh
    from hlax_torch.parallel import distributed as pdist
    from hlax_torch.parallel.dryrun import dryrun_multichip

    ds, spec0, spec1 = canonical_setup(data_dir)
    idx_mesh = epoch_subject_batches_mesh(ds.P, 2, 20,
                                          np.random.default_rng(0))
    if len(idx_mesh) != MESH_STEPS:
        fail(f"[mesh] the canonical epoch has {len(idx_mesh)} batches")
    P_loc = -(-ds.P // 2)
    idx = np.where(idx_mesh >= 0, idx_mesh + (np.arange(2) * P_loc)[
        None, :, None], -1).reshape(MESH_STEPS, -1)
    eps = torch.randn((MESH_STEPS, 20 * ds.T_max, 32), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    ranks = pdist.spawn(_mesh_rank, 4, (data_dir, idx_mesh, eps),
                        timeout=300)
    spawn_s = time.perf_counter() - t0
    total = {}
    for dtype in MESH_DTYPES:
        for out in _mesh_against_single(ds, spec0, spec1, ranks, idx, eps,
                                        spawn_s, dtype):
            for key, v in out["launches"].items():
                total[key] = total.get(key, 0) + v
    dryrun_multichip(4)
    return total


def phase_mesh_kernels(gen, shapes=MESH_ROWS):
    """The kernels at a mesh's local shapes (``shapes``: MESH_ROWS, the
    [mesh] ranks'; MESH4_ROWS, a 4 x 1 rank's): the small kernel bit for
    bit against its plain version, the mid and backward kernels against
    float64 as in [kernels]; timed.  Returns their table rows."""
    from hlax_torch.ops import linalg_small as ls

    rows = []
    for name, batch, n in shapes:
        a = random_spd(batch, n, gen)
        if name == "chol_inv_bwd_cuda":
            l, il = ls.chol_inv_small_cuda(a)
            lb, ilb = (torch.randn(l.shape, generator=gen, device="cuda")
                       for _ in range(2))
            fn = lambda: ls.chol_inv_bwd_cuda(l, il, lb, ilb)
            plain = lambda: ls._chol_inv_bwd_plain(l, il, lb, ilb)
            want = ls._bwd_reference(l.double(), il.double(), lb.double(),
                                     ilb.double())
            err = (fn().double() - want).abs().max().item()
            err_plain = (plain().double() - want).abs().max().item()
            if err > ERR_FACTOR * err_plain + ERR_ABS * want.abs().max():
                fail(f"[mesh] {_tag(name, batch, n)}: error {err:.3e}, "
                     f"plain {err_plain:.3e}")
            bound, library = _bwd_bound_ms(a.numel() // (n * n), n), None
        else:
            fn = lambda: getattr(ls, name)(a)
            plain = lambda: ls._chol_inv_plain(a)
            (l, il), (lp, ilp) = fn(), plain()
            if name == "chol_inv_small_cuda":
                if not (torch.equal(l, lp) and torch.equal(il, ilp)):
                    fail(f"[mesh] {_tag(name, batch, n)}: differs from the "
                         "plain version")
                err = 0.0
            else:
                errs, _ = _f64_errors(a, l, il)
                plain_errs, scales = _f64_errors(a, lp, ilp)
                if any(e > ERR_FACTOR * p + ERR_ABS * s for e, p, s in
                       zip(errs, plain_errs, scales)):
                    fail(f"[mesh] {_tag(name, batch, n)}: errors {errs}, "
                         f"plain {plain_errs}")
                err = max(errs[:2])
            bound, library = _bound_ms(a.numel() // (n * n), n), \
                (lambda: _library(a))
        src = name.removesuffix("_cuda")
        rows.append(_time_row(
            name, f"hlax_torch/csrc/{src}.cu",
            "hlax/ops/linalg_small.py:" + {"chol_inv_small": "112",
                                           "chol_inv_mid": "472",
                                           "chol_inv_bwd": "328"}[src],
            batch, n, torch.float32, fn, plain, library, err, bound))
    return rows


def _nccl_share(trace: str, steps: int) -> str:
    """NCCL kernels' device ms a step and share of all kernels' in a
    torch.profiler Chrome trace of ``steps`` train steps."""
    with open(trace) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("cat") == "kernel"]
    total = sum(e.get("dur", 0) for e in events)
    nccl = sum(e.get("dur", 0) for e in events
               if "nccl" in e.get("name", "").lower())
    if not total:
        return "no device kernels in the trace: not measured"
    return (f"NCCL kernels {nccl / steps / 1e3:.4f} ms a step of "
            f"{total / steps / 1e3:.4f} ms of kernels ({nccl / total:.1%}), "
            f"{sum('nccl' in e.get('name', '').lower() for e in events)} "
            f"NCCL kernel events")


def _mesh_cli(data_dir: str, tmp: str, tag: str, n_data: int, n_latent: int,
              profile: bool, dtype: str) -> dict:
    """The training CLI on the canonical config with ``--data_parallel``
    and ``--latent_parallel``, model and GP in ``dtype``, MESH4_EPOCHS
    epochs with the final validation and tests, its console output in
    ``<tmp>/<tag>.log``, killed after MESH_CLI_LIMIT seconds.  Returns rank
    0's summary, every rank's under "ranks"."""
    from hlax_torch.cli import main as cli
    from hlax_torch.config import ModelArgs

    opt = ModelArgs().parse_options([f"--f={CONFIG}"])
    save = os.path.join(tmp, f"run_{tag}")
    opt.update(data_source_path=data_dir, save_path=save,
               epochs=MESH4_EPOCHS, run_validation=True, run_tests=True,
               generate_images=False, device="cuda", data_parallel=n_data,
               latent_parallel=n_latent, gp_dtype=dtype, model_dtype=dtype,
               profile_dir=os.path.join(save, "profile") if profile else "")

    def limit(signum, frame):
        raise TimeoutError(f"[{tag}] the mesh CLI run took more than "
                           f"{MESH_CLI_LIMIT} s")

    saved = signal.signal(signal.SIGALRM, limit)
    signal.alarm(MESH_CLI_LIMIT)       # spawn kills its ranks as it unwinds
    try:
        with _fd_stdout(os.path.join(tmp, f"{tag}.log")):
            out = cli.launch(opt)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, saved)
    return {**out, "save": save, "log": os.path.join(tmp, f"{tag}.log")}


# [mesh4]: NCCL meshes through the CLI, one rank a card, on the graph path,
# MESH4_EPOCHS epochs in each of MESH4_DTYPES.  Each epoch's loss is held
# against the single process on one card (make_train_epoch's graphs, the
# one-card CLI's path) taking the same global batches from the same
# initial state and generator: the CLI's rng (seed 0) draws the mesh's
# local batches, and their subjects, in the mesh's order, are the single
# process's batches (the one-card CLI draws other batches from that seed,
# so its losses are another trajectory).  Float64 at MESH_BOUND (each
# epoch's loss; the GP state and the VAE of final.pt); float32 at [mesh]'s
# first-loss rule, on the first epoch's loss, the later ones reported
MESH4_EPOCHS = 3
# seconds a mesh run of the CLI may take (it starts its ranks with no
# limit of its own)
MESH_CLI_LIMIT = 300
MESH4_DTYPES = (torch.float32, torch.float64)
# rounds of the steps/s comparison, 20 steps a path a round, at the
# canonical 20 subjects a step (every path) and at all 200 subjects a step
# (the graph paths), to see whether a larger step gains on several cards
MESH4_ROUNDS = 3
MESH4_PATHS = ("one card graph", "graph mesh", "eager mesh", "one card eager")
MESH4_SUBJECTS = (20, 200)
# the 4 x 1 rank's B blocks and their backward, a shape that no other path
# launches, in the kernel table when [mesh4] runs 4 x 1
MESH4_ROWS = [("chol_inv_small_cuda", (32, 5), 20),
              ("chol_inv_bwd_cuda", (32, 5), 20)]


def _global_batches(ds, n_data: int, rng) -> np.ndarray:
    """One epoch of the mesh's local batches drawn from ``rng`` as the
    CLI draws them, as global subject indices [nb, n_data * S_loc] in the
    mesh's order."""
    from hlax_torch.data.dataset import epoch_subject_batches_mesh

    idx = epoch_subject_batches_mesh(ds.P, n_data, 20, rng)
    P_loc = -(-ds.P // n_data)
    return np.where(idx >= 0, idx + (np.arange(n_data) * P_loc)[
        None, :, None], -1).reshape(len(idx), -1)


def _mesh_reference(ds, spec0, spec1, n_data: int, dtype):
    """The single process on cuda:0 through ``make_train_epoch``'s graphs
    over the batches of an ``n_data`` mesh's CLI run: each epoch's loss
    (the CLI's mean of its steps') and the state after them."""
    from hlax_torch.data.dataset import stage_dataset
    from hlax_torch.train import step as tstep

    rng = np.random.default_rng(0)
    st, cfg = canonical_state(ds, spec0, spec1, dtype)
    epoch = tstep.make_train_epoch(st.vae, spec0, spec1, cfg)
    staged = stage_dataset(ds, dtype, "cuda")
    losses = [float(epoch(st, staged, _global_batches(ds, n_data, rng))[
        "loss"].mean()) for _ in range(MESH4_EPOCHS)]
    return np.asarray(losses), st


def _mesh_rate_rank(rank: int, world: int, init: str, data_dir: str,
                    n_data: int, n_latent: int) -> dict:
    """A rank of [mesh4]'s steps/s rounds, float32, cuda:<rank> over NCCL:
    for each of MESH4_SUBJECTS a step, the canonical state from the seed,
    sharded, through ``make_train_epoch_mesh``'s graphs ("graph mesh") and
    (20 subjects) through eager mesh steps ("eager mesh"); rank 0 also
    times the single process on its card ("one card graph", and with 20
    subjects "one card eager") while the other ranks wait.  Every path is
    warmed up (a turn of 20 steps: the graphs are captured), then
    MESH4_ROUNDS rounds of 20 steps a path in MESH4_PATHS' order, each
    turn between two barriers.  Returns rank 0's steps/s by (path,
    subjects)."""
    torch.cuda.set_device(rank)
    import torch.distributed as dist
    from hlax_torch.data.dataset import (epoch_subject_batches,
                                         epoch_subject_batches_mesh,
                                         stage_dataset, stage_dataset_mesh)
    from hlax_torch.parallel import distributed as pdist
    from hlax_torch.parallel import mesh as pmesh
    from hlax_torch.train import step as tstep

    pdist.initialize("nccl", init, world, rank, device=f"cuda:{rank}")
    try:
        mesh = pmesh.make_mesh(n_data, n_latent)
        ds, spec0, spec1 = canonical_setup(data_dir)
        f32 = torch.float32
        staged = stage_dataset_mesh(ds, f32, "cuda", n_data, mesh.d)
        whole = stage_dataset(ds, f32, "cuda") if rank == 0 else None
        _, cfg = canonical_state(ds, spec0, spec1, f32)
        paths = {}          # (path, subjects) -> (run an epoch, its steps)
        for spb in MESH4_SUBJECTS:
            local = epoch_subject_batches_mesh(ds.P, n_data, spb,
                                               np.random.default_rng(0))
            g = pmesh.shard_state(canonical_state(ds, spec0, spec1, f32)[0],
                                  mesh, cfg)
            graph = tstep.make_train_epoch_mesh(g.vae, spec0, spec1, cfg,
                                                mesh)
            paths["graph mesh", spb] = (
                lambda graph=graph, g=g, local=local: graph(g, staged,
                                                            local),
                len(local))
            if spb == 20:
                e = pmesh.shard_state(canonical_state(
                    ds, spec0, spec1, f32)[0], mesh, cfg)
                step = tstep.make_train_step(e.vae, spec0, spec1, cfg,
                                             mesh=mesh)
                paths["eager mesh", spb] = (
                    lambda step=step, e=e, local=local: tstep.train_epoch(
                        step, e, staged, local[:, mesh.d]), len(local))
            if rank:
                continue
            idx = np.stack(list(epoch_subject_batches(
                ds.P, spb, np.random.default_rng(0))))
            one, _ = canonical_state(ds, spec0, spec1, f32)
            epoch = tstep.make_train_epoch(one.vae, spec0, spec1, cfg)
            paths["one card graph", spb] = (
                lambda epoch=epoch, one=one, idx=idx: epoch(one, whole, idx),
                len(idx))
            if spb == 20:
                one_e, _ = canonical_state(ds, spec0, spec1, f32)
                step1 = tstep.make_train_step(one_e.vae, spec0, spec1, cfg)
                paths["one card eager", spb] = (
                    lambda step1=step1, one_e=one_e, idx=idx:
                    tstep.train_epoch(step1, one_e, whole, idx), len(idx))
        rates = {}
        for turn in range(MESH4_ROUNDS + 1):     # the first: the warm-up
            for spb in MESH4_SUBJECTS:
                for name in MESH4_PATHS:
                    # every rank takes the same turns: the mesh's paths
                    # exist on every rank, one card's on rank 0 only
                    if spb != 20 and "eager" in name:
                        continue
                    dist.barrier()
                    if (name, spb) in paths:
                        run, nb = paths[name, spb]
                        r = _time_epochs(run, 20 // nb, nb)
                        if turn:
                            rates.setdefault((name, spb), []).append(r)
                    dist.barrier()
        return rates
    finally:
        pdist.destroy()


def phase_mesh4(data_dir: str, tmp: str) -> dict:
    """[mesh4], with two cards or more: one rank a card over NCCL, through
    the CLI on the graph path.  2 x 2 and 4 x 1 (2 x 1 and 1 x 2 with two
    or three cards), in each of MESH4_DTYPES: MESH4_EPOCHS epochs with the
    final validation and tests; each epoch's loss against the single
    process on the same batches (``_mesh_reference``), every rank's
    launches at its local shapes in the run's dtype; in float64 final.pt
    against the single process's state, in float32 final.pt restored into
    a single-process state and read by the imputation CLI, and rank 0's
    torch.profiler trace of epoch 2 for the NCCL kernels' share.  Then
    steps/s of the graph mesh, the eager mesh and one card in alternating
    rounds (``_mesh_rate_rank``).  Returns the float32 launches by shape of
    the 4 x 1 run, summed over its ranks (none without it)."""
    from hlax_torch.parallel import distributed as pdist
    from hlax_torch.train import checkpoint as ckpt

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[mesh4] did not run: {cards} card visible; NCCL takes one "
              "card a rank (run `python3 chip_smoke.py mesh` on four)",
              flush=True)
        return {}
    shapes = [(2, 2), (4, 1)] if cards >= 4 else [(2, 1), (1, 2)]
    ds, spec0, spec1 = canonical_setup(data_dir)
    total = {}
    for dtype in MESH4_DTYPES:
        dtag = str(dtype).removeprefix("torch.")
        bound = MESH_BOUND[dtype]
        for nd, nl in shapes:
            tag = f"mesh{nd}x{nl} {dtag}"
            t0 = time.perf_counter()
            out = _mesh_cli(data_dir, tmp, f"mesh{nd}x{nl}_{dtag}", nd, nl,
                            dtype == torch.float32, dtag)
            seconds = time.perf_counter() - t0
            steps = 10 * MESH4_EPOCHS
            rows = _check_run(tag, out, steps, {})
            with open(out["log"]) as f:
                if "its steps run as CUDA graphs" not in f.read():
                    fail(f"[{tag}] the CLI did not run the mesh steps as "
                         "CUDA graphs")
            for r, rank in enumerate(out["ranks"]):
                if rank["steps"] != steps or any(rank["plain_calls"].values()):
                    fail(f"[{tag}] rank {r}: {rank['steps']} steps, plain "
                         f"versions {rank['plain_calls']}")
                _need(f"{tag} rank {r}", rank["launches_by_shape"],
                      {k: steps * per for k, per in
                       _mesh_launches(nd, nl, dtag).items()})
                print(f"[{tag}] rank {r} launches by shape "
                      f"{_by_shape_str(rank['launches_by_shape'])}",
                      flush=True)
                if (nd, nl) == (4, 1) and dtype == torch.float32:
                    for k, v in rank["launches_by_shape"].items():
                        total[k] = total.get(k, 0) + v
            ref, ref_state = _mesh_reference(ds, spec0, spec1, nd, dtype)
            got = np.asarray(out["loss_arrs"]["net"])
            d_loss = np.abs(got - ref) / np.abs(ref)
            sd = ckpt.load(out["save"])
            if sd is None or sd["H"].shape != (32, 120, 120) \
                    or sd["step"] != steps:
                fail(f"[{tag}] final.pt is missing or not the whole state")
            st, _ = canonical_state(ds, spec0, spec1, dtype, seed=1)
            if not ckpt.restore(out["save"], st) or st.step != steps:
                fail(f"[{tag}] final.pt does not restore in one process")
            want, have = _gp_and_vae(ref_state), _gp_and_vae(st)
            d_state = {k: _rel(have[k], want[k]) for k in want}
            worst = max(d_state, key=d_state.get)
            del st, ref_state
            trace = os.path.join(out["save"], "profile",
                                 "epochs_2-2.pt.trace.json")
            nccl = (_nccl_share(trace, 10) if os.path.isfile(trace)
                    else "not profiled")
            print(f"[{tag}] {nd} x {nl} ranks over NCCL, CUDA graphs, "
                  f"{MESH4_EPOCHS} epochs: losses {got.tolist()}; the single "
                  f"process on the same batches {ref.tolist()}; relative "
                  f"difference by epoch {[float(f'{x:.3e}') for x in d_loss]}"
                  f"; final.pt against its state: m {d_state['m']:.3e}, H "
                  f"{d_state['H']:.3e}, largest {d_state[worst]:.3e} "
                  f"({worst}); final validation net_loss "
                  f"{rows['net_loss']:.6g}, GP_loss {rows['GP_loss']:.6g}; "
                  f"epoch seconds "
                  f"{[round(x, 4) for x in out['epoch_seconds']]}; run "
                  f"{seconds:.1f} s; rank 0 epoch 2 under the profiler: "
                  f"{nccl} on {card_line()} x {cards}", flush=True)
            if "state" in bound:
                bad = d_loss.max() > bound["loss"] \
                    or d_state[worst] > bound["state"]
            else:
                bad = d_loss[0] > bound["loss"] or not np.isfinite(got).all()
            if bad:
                fail(f"[{tag}] the mesh's epochs differ from the single "
                     f"process's beyond {bound}")
            if dtype == torch.float32:
                phase_impute(data_dir, out["save"], tag=f"mesh{nd}x{nl}")
    for nd, nl in shapes:
        t0 = time.perf_counter()
        rates = pdist.spawn(_mesh_rate_rank, nd * nl,
                            (data_dir, nd, nl), timeout=300)[0]
        spawn_s = time.perf_counter() - t0
        for (name, spb), r in rates.items():
            print(f"[mesh4] {nd} x {nl} ({nd * nl} cards) {name}, {spb} "
                  f"subjects a step: steps/s "
                  f"{', '.join(f'{x:.2f}' for x in r)} ({MESH4_ROUNDS} "
                  f"alternating rounds of 20 steps, rank 0's clock; the "
                  f"spawn {spawn_s:.1f} s) on {card_line()} x {cards}",
                  flush=True)
    return total


def _count_canonical_epochs(data_dir: str) -> dict:
    """{(kernel, shape, dtype): launches} of one canonical epoch on the
    graph path in float32 and one in float64, every counter set to 0 just
    before each and read just after."""
    from hlax_torch.data.dataset import epoch_subject_batches, stage_dataset
    from hlax_torch.train import step as tstep

    ds, spec0, spec1 = canonical_setup(data_dir)
    idx = np.stack(list(epoch_subject_batches(ds.P, 20,
                                              np.random.default_rng(0))))
    counts = {}
    for dtype in (torch.float32, torch.float64):
        st, cfg = canonical_state(ds, spec0, spec1, dtype)
        staged = stage_dataset(ds, dtype, "cuda")
        epoch = tstep.make_train_epoch(st.vae, spec0, spec1, cfg)
        reset_all_counters()
        epoch(st, staged, idx)
        torch.cuda.synchronize()
        counts.update(read_all_counters()[1])
        del st, staged, epoch
    return counts


# the mid kernel's blocks and the bound's subject kernels at T = 200 and
# 500 (M = 120)
LONG_SHAPES = ({batch + (n, n) for batch, n in LONG_T_MID_ROWS}
               | {(32, S, T, 120) for T, _, S in LONG_T})
MESH_SHAPES = ({batch + (n, n) for _, batch, n in MESH_ROWS}
               | {(MESH_RANK_ROWS, CANONICAL_N_EXP)})


def _row_path(r) -> str:
    """The main path whose launches a kernel table row reports."""
    shape = tuple(r["shape"])
    mesh4 = {batch + (n, n) for _, batch, n in MESH4_ROWS}
    return ("mesh" if shape in MESH_SHAPES else
            "mesh4" if shape in mesh4 else
            "f64" if r["dtype"] == "float64" else
            "longT" if shape in LONG_SHAPES else "slice")


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this smoke run "
              "needs an NVIDIA GPU", flush=True)
        sys.exit(2)
    if sys.argv[1:2] == ["rate"]:
        rate_run(*sys.argv[2:6])
        return
    if sys.argv[1:] == ["precision"]:
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            data_dir = os.path.join(tmp, "data")
            write_canonical_data(data_dir)
            phase_precision(data_dir)
            phase_precision_ab(data_dir)
        return
    mesh_only = sys.argv[1:] == ["mesh"]
    if sys.argv[1:] == ["fusion"]:
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            data_dir = os.path.join(tmp, "data")
            write_canonical_data(data_dir)
            rows = phase_fusion(data_dir, tmp)
            counts = _count_canonical_epochs(data_dir)
            for r in rows:
                r["launches"] = counts.get(
                    (r["name"], tuple(r["shape"]), r["dtype"]), 0)
                if _row_path(r) == "mesh":
                    print(f"[fusion] {r['name']} {r['dtype']} "
                          f"{r['shape']}: a [mesh] rank's row, its launches "
                          "not measured in this mode", flush=True)
                elif not r["launches"]:
                    fail(f"{r['name']} {r['dtype']} was not launched at "
                         f"{r['shape']} on the canonical graph epoch")
            print(json.dumps({"kernels": rows}))
            phase_graph(data_dir, tmp)
            phase_parent(data_dir)
        return
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; {torch.cuda.device_count()} card(s)",
          flush=True)
    t0 = time.perf_counter()

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[time] {name} {time.perf_counter() - t:.1f} s, "
              f"{time.perf_counter() - t0:.1f} s since the build began",
              flush=True)
        return out

    timed("build", phase_build)
    rows = [] if mesh_only else timed("kernels", phase_kernels)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows += phase_mesh_kernels(gen)
    if torch.cuda.device_count() >= 4:        # [mesh4] runs 4 x 1
        rows += phase_mesh_kernels(gen, MESH4_ROWS)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        if mesh_only:
            data_dir = os.path.join(tmp, "data")
            write_canonical_data(data_dir)
        else:
            timed("reference", phase_reference, tmp)
            timed("reference float64", phase_reference, tmp, torch.float64)
            counts["slice"], out, data_dir, save = timed("slice",
                                                         phase_slice, tmp)
            timed("impute", phase_impute, data_dir, save)
            timed("eval", phase_eval, out)
            timed("profile", phase_profile, out)
            del out
            torch.cuda.empty_cache()
            rows += timed("fusion", phase_fusion, data_dir, tmp)
            counts["f64"] = timed("f64", phase_f64, data_dir, tmp)
            counts["longT"], long_rows = timed("longT", phase_long_t, tmp)
            rows += long_rows
            counts["mlp"] = timed("mlp", phase_mlp, data_dir, tmp)
            counts["options"] = timed("options", phase_options, data_dir,
                                      tmp)
            timed("fused", phase_fused_stack, data_dir)
            timed("graph", phase_graph, data_dir, tmp)
            timed("precision", phase_precision, data_dir)
            timed("parent", phase_parent, data_dir)
            timed("full", phase_full, data_dir, tmp)
            torch.cuda.empty_cache()
        counts["mesh"] = timed("mesh", phase_mesh, data_dir)
        counts["mesh4"] = timed("mesh4", phase_mesh4, data_dir, tmp)
    # each row's launches come from the run of the path it belongs to: the
    # mesh ranks' local shapes from [mesh] (the metric's rows in both
    # dtypes) and the 4 x 1 rank's from [mesh4] (each summed over its
    # ranks), the float64 rows from [f64], the long sequences' blocks from
    # [longT], the rest from [slice]
    for r in rows:
        path = _row_path(r)
        r["launches"] = counts[path].get(
            (r["name"], tuple(r["shape"]), r["dtype"]), 0)
        if not r["launches"]:
            fail(f"{r['name']} {r['dtype']} was not launched at "
                 f"{r['shape']} on the {path} path")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
