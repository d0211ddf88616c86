"""Batched Cholesky + triangular inverse of SPD blocks, with CUDA kernels.

Port of ``hlax/ops/linalg_small.py``.  The GP bounds need ``(L, L^{-1})``
of many small SPD matrices per train step: the per-subject B blocks
[L, S, T, T] with T ~ 20, and the inducing-point matrices [*, M, M] with
M ~ 120.  Two hand-written CUDA kernels compute them:

  * ``chol_inv_small_cuda`` (``csrc/chol_inv_small.cu``, n <= 48): one warp
    per matrix; replaces the TPU kernel ``_kernel``.
  * ``chol_inv_mid_cuda`` (``csrc/chol_inv_mid.cu``, 24 < n <= 128):
    replaces the TPU kernel ``_mid_kernel``.  For n <= 32 one warp a matrix
    with the rows in registers; above, one block a matrix, blocked in panels
    of 8 columns (the plan is ``mid_launch_plan``).  As in hlax, one Newton
    step ``_refine_tri_inverse`` follows it.

  * ``chol_inv_bwd_cuda`` (``csrc/chol_inv_bwd.cu``, n <= 48): one warp
    per matrix; the backward of the small factorization, replaces the TPU
    kernel ``_bwd_kernel``.

The two forward kernels keep hlax's degenerate-pivot guard: a pivot below 1e-6 * max(diag A)
is floored and its column pinned to sqrt(floor) * e_j, so a matrix that
float32 rounding makes indefinite still factorizes to a finite nearby one.
Both read only the lower triangle of A.

``_chol_inv_plain`` is the plain PyTorch version of both forward kernels
(the guarded column loop as tensor ops), ``_chol_inv_bwd_plain`` that of the
backward kernel (``_bwd_reference``, the matmul-only Cholesky-plus-inverse
pullback).  The small kernel and the mid kernel's one-warp path do the
plain version's float32 operations in its order and agree with it bit for
bit; the mid kernel's blocked path sums in blocked order with fused
multiply-adds and is held to a float64 reference instead.  The autograd
Functions use the plain versions for a CPU tensor only; for a CUDA tensor
they launch the kernel or raise.  The mid
factorization's backward is ``_bwd_reference`` on every device, as hlax's
``_mid_bwd`` is plain matmuls outside any Pallas kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from hlax_torch.ops.cuda_build import check_launch, load_library

PIVOT_FLOOR_REL = 1e-6
MAX_SMALL_T = 48      # largest n the small (one-warp) kernel takes
MAX_DIAG_BLOCK = 24   # chol_inv_blocked: n <= 24 -> small, else mid (hlax's)
MAX_MID_M = 128
MAX_MID_WARP_N = 32   # the mid kernel's one-warp-a-matrix path
MID_WARPS_PER_BLOCK = 4
MID_BLOCK_THREADS = 512  # must match BLOCK_THREADS in csrc/chol_inv_mid.cu
MID_PANEL = 8         # must match NB there

# Kernel launches and plain-version calls on CUDA tensors since the last
# ``reset_counters``: a run reads them to show which path it took.
LAUNCHES = {"chol_inv_small_cuda": 0, "chol_inv_mid_cuda": 0,
            "chol_inv_bwd_cuda": 0}
# the same launches by input shape: {(kernel, shape): launches}
LAUNCHES_BY_SHAPE: Dict[Tuple[str, Tuple[int, ...]], int] = {}
PLAIN_CUDA_CALLS = {"chol_inv_plain": 0, "chol_inv_bwd_plain": 0}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_CUDA_CALLS):
        for k in d:
            d[k] = 0
    LAUNCHES_BY_SHAPE.clear()


def _count_launch(name: str, shape) -> None:
    LAUNCHES[name] += 1
    key = (name, tuple(shape))
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


class MidPlan(NamedTuple):
    """Launch of the mid kernel for ``batch`` matrices of n x n."""
    path: str      # "warp": one warp a matrix; "blocked": one block a matrix
    grid: int      # blocks
    threads: int   # threads a block
    panel: int     # panel width of the blocked path (0 on the warp path)
    smem: int      # dynamic shared memory a block, bytes
    per_block: int  # matrices a block


def mid_launch_plan(n: int, batch: int) -> MidPlan:
    """The plan ``chol_inv_mid_launch`` (``csrc/chol_inv_mid.cu``) takes:
    for n <= 32 four warps a block, each staging its identity-padded 32 x 32
    matrix in a 33-float-stride tile; above, 512 threads a matrix with A and
    L^{-1} identity-padded to a multiple of the panel width in shared
    memory, plus the panel's L21 transposed and its diagonal block."""
    if n <= MAX_MID_WARP_N:
        w = MID_WARPS_PER_BLOCK
        return MidPlan("warp", -(-batch // w), 32 * w, 0, w * 32 * 33 * 4, w)
    np_ = -(-n // MID_PANEL) * MID_PANEL
    return MidPlan("blocked", batch, MID_BLOCK_THREADS, MID_PANEL,
                   4 * (2 * np_ * np_ + MID_PANEL * (np_ + MID_PANEL)), 1)


def _chol_inv_plain(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of both kernels: guarded right-looking column
    loop over [..., n, n], the small kernel's arithmetic
    (``csrc/chol_inv_common.cuh``); the mid kernel computes the same
    function in blocked order.

    Note: hlax's mid kernel takes its pivot floor over the identity-padded
    matrix (M rounded up to a multiple of 8), so for such M with
    max(diag A) < 1 its floor is 1e-6 where this one is 1e-6 * max(diag A).
    The main path's M = 120 has no padding."""
    if a.is_cuda:
        PLAIN_CUDA_CALLS["chol_inv_plain"] += 1
    n = a.shape[-1]
    A = a.clone()
    idx = torch.arange(n, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    floor = PIVOT_FLOOR_REL * torch.diagonal(A, dim1=-2, dim2=-1).amax(
        dim=-1).clamp(min=0.0)
    L = torch.zeros_like(A)
    iL = torch.eye(n, dtype=a.dtype, device=a.device).expand_as(A).clone()
    for j in range(n):
        d = A[..., j, j]
        good = d >= floor
        dc = torch.where(good, d, floor)
        inv = 1.0 / torch.sqrt(dc)
        below = (idx > j) & good[..., None]
        col = torch.where(below, A[..., :, j] * inv[..., None], zero)
        col[..., j] = dc * inv
        L[..., :, j] = col
        A = A - col[..., :, None] * col[..., None, :]
        iL[..., j, :] *= inv[..., None]
        col[..., j] = 0.0
        iL = iL - col[..., :, None] * iL[..., j, None, :]
    return L, iL


def _check(a: torch.Tensor, lo: int, hi: int, what: str) -> None:
    if not a.is_cuda:
        raise ValueError(f"{what}: needs a CUDA tensor, got {a.device}")
    if a.dtype != torch.float32:
        raise ValueError(f"{what}: needs float32, got {a.dtype}")
    if a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"{what}: needs [..., n, n], got {tuple(a.shape)}")
    if not lo < a.shape[-1] <= hi:
        raise ValueError(f"{what}: needs {lo} < n <= {hi}, got "
                         f"n={a.shape[-1]}")
    if not a.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous tensor")


def _launch(name: str, entry: str, a: torch.Tensor, *plan: int):
    """(L, L^{-1}) from the C entry ``entry(a, l, il, batch, n, *plan,
    stream)`` of ``lib<name>.so``."""
    n = a.shape[-1]
    l, il = torch.empty_like(a), torch.empty_like(a)
    batch = a.numel() // (n * n)
    if batch == 0:
        return l, il
    lib = load_library(name)
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (2 + len(plan))
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = fn(a.data_ptr(), l.data_ptr(), il.data_ptr(), batch, n, *plan,
              stream)
    check_launch(lib, entry, code)
    _count_launch(f"{name}_cuda", a.shape)
    return l, il


def chol_inv_small_cuda(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L^{-1}) of contiguous float32 CUDA [..., n, n], n <= 48, by the
    one-warp-per-matrix kernel."""
    _check(a, 0, MAX_SMALL_T, "chol_inv_small_cuda")
    return _launch("chol_inv_small", "chol_inv_small_launch", a)


def chol_inv_mid_cuda(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L^{-1}) of contiguous float32 CUDA [..., n, n], 24 < n <= 128, by
    the mid kernel on the plan of ``mid_launch_plan`` (without the Newton
    refinement).  hlax sends 24 < n <= 48 to its mid kernel too
    (``chol_inv_blocked``)."""
    if a.is_cuda and a.shape[-1] > MAX_MID_M:
        raise NotImplementedError(
            "chol_inv_mid_cuda: n > 128 needs the blocked composition of "
            "hlax's chol_inv_blocked, not ported yet "
            "(ROADMAP queue 1 item 10)")
    _check(a, MAX_DIAG_BLOCK, MAX_MID_M, "chol_inv_mid_cuda")
    n = a.shape[-1]
    plan = mid_launch_plan(n, a.numel() // (n * n))
    return _launch("chol_inv_mid", "chol_inv_mid_launch", a,
                   {"warp": 0, "blocked": 1}[plan.path], plan.grid,
                   plan.threads, plan.panel, plan.smem)


def _refine_tri_inverse(l, il):
    """One Newton step iL (2I - L iL); keeps exact lower-triangularity."""
    return 2.0 * il - torch.matmul(il, torch.matmul(l, il))


def _phi(x):
    """Lower triangle with halved diagonal (Cholesky pullback projector)."""
    n = x.shape[-1]
    w = torch.tril(torch.ones(n, n, dtype=x.dtype, device=x.device), -1)
    w = w + 0.5 * torch.eye(n, dtype=x.dtype, device=x.device)
    return x * w


def _bwd_reference(l, il, l_bar, il_bar):
    """Cholesky-plus-inverse pullback from the saved (L, L^{-1})
    (``hlax/ops/linalg_small.py:431-443``), lower-triangular convention."""
    lt, ilt = l.mT, il.mT
    # fold d(L^{-1}) into dL:  d(iL) = -iL dL iL
    l_bar = l_bar + torch.tril(-torch.matmul(ilt, torch.matmul(il_bar, ilt)))
    p = _phi(torch.matmul(lt, l_bar))
    x = torch.matmul(ilt, torch.matmul(p, il))
    return _phi(x + x.mT)


def _chol_inv_bwd_plain(l, il, l_bar, il_bar):
    """Plain PyTorch version of the backward kernel: ``_bwd_reference``."""
    if l.is_cuda:
        PLAIN_CUDA_CALLS["chol_inv_bwd_plain"] += 1
    return _bwd_reference(l, il, l_bar, il_bar)


def chol_inv_bwd_cuda(l: torch.Tensor, il: torch.Tensor, l_bar: torch.Tensor,
                      il_bar: torch.Tensor) -> torch.Tensor:
    """A_bar of (L, L^{-1}) = chol_inv(A) from the saved factors and the
    cotangents of both outputs, float32 CUDA [..., n, n], n <= 48, by the
    one-warp-per-matrix kernel; ``_bwd_reference``'s lower convention.  The
    cotangents may be strided or expanded (autograd hands them over so);
    they are made contiguous first."""
    l_bar, il_bar = l_bar.contiguous(), il_bar.contiguous()
    for t in (l, il, l_bar, il_bar):
        _check(t, 0, MAX_SMALL_T, "chol_inv_bwd_cuda")
    if not l.shape == il.shape == l_bar.shape == il_bar.shape:
        raise ValueError("chol_inv_bwd_cuda: needs four equal shapes, got "
                         f"{[tuple(t.shape) for t in (l, il, l_bar, il_bar)]}")
    n = l.shape[-1]
    a_bar = torch.empty_like(l)
    batch = l.numel() // (n * n)
    if batch == 0:
        return a_bar
    lib = load_library("chol_inv_bwd")
    fn = lib.chol_inv_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(l.device).cuda_stream
    code = fn(l.data_ptr(), il.data_ptr(), l_bar.data_ptr(), il_bar.data_ptr(),
              a_bar.data_ptr(), batch, n, stream)
    check_launch(lib, "chol_inv_bwd_launch", code)
    _count_launch("chol_inv_bwd_cuda", l.shape)
    return a_bar


class _CholInvSmall(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        l, il = chol_inv_small_cuda(a) if a.is_cuda else _chol_inv_plain(a)
        ctx.save_for_backward(l, il)
        return l, il

    @staticmethod
    def backward(ctx, l_bar, il_bar):
        # an output the loss does not use arrives as zeros (autograd
        # materializes undefined gradients)
        l, il = ctx.saved_tensors
        if l.is_cuda:
            return chol_inv_bwd_cuda(l, il, l_bar, il_bar)
        return _chol_inv_bwd_plain(l, il, l_bar, il_bar)


class _CholInvMid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        l, il = chol_inv_mid_cuda(a) if a.is_cuda else _chol_inv_plain(a)
        il = _refine_tri_inverse(l, il)
        ctx.save_for_backward(l, il)
        return l, il

    @staticmethod
    def backward(ctx, l_bar, il_bar):
        # an output the loss does not use arrives as zeros (autograd
        # materializes undefined gradients)
        return _bwd_reference(*ctx.saved_tensors, l_bar, il_bar)


def chol_inv_small(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (L, L^{-1}) of SPD [..., n, n], n <= 48."""
    return _CholInvSmall.apply(a.contiguous())


def chol_inv_mid(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (L, refined L^{-1}) of SPD [..., n, n], 24 < n <= 128
    (any n on the CPU)."""
    return _CholInvMid.apply(a.contiguous())


def chol_inv_blocked(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatcher of hlax's ``chol_inv_blocked``: the small kernel for
    n <= 24, the mid kernel (plus refinement) above.  On CUDA, n > 128
    raises NotImplementedError (hlax's blocked composition, not ported
    yet); the plain version on the CPU takes any n."""
    if a.shape[-1] <= MAX_DIAG_BLOCK:
        return chol_inv_small(a)
    return chol_inv_mid(a)
