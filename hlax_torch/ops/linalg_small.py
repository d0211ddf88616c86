"""Batched Cholesky + triangular inverse of SPD blocks, with CUDA kernels.

Port of ``hlax/ops/linalg_small.py``.  The GP bounds need ``(L, L^{-1})``
of many small SPD matrices per train step: the per-subject B blocks
[L, S, T, T] with T ~ 20, and the inducing-point matrices [*, M, M] with
M ~ 120.  Hand-written CUDA kernels compute them and both
factorizations' backward, in float32 and float64, each on a launch plan
worked out here and checked by its C entry:

  * ``chol_inv_small_cuda`` (``csrc/chol_inv_small.cu``, n <= 48): replaces
    the TPU kernel ``_kernel``.  For n <= 32 one warp a matrix with the
    rows in registers, identity-padded to a compiled size (20 for the
    canonical T = 20), the warps a block chosen to spread the batch evenly
    over the SMs; above, one warp a matrix in shared memory
    (``small_launch_plan``).
  * ``chol_inv_mid_cuda`` (``csrc/chol_inv_mid.cu``, 24 < n <= 128):
    replaces the TPU kernel ``_mid_kernel``.  For n <= 32 the small
    kernel's one-warp body at size 32; above, one block a matrix, blocked in
    panels of 8 columns, A and L^{-1} both in shared memory: in float32 as
    two full arrays, in float64 in a kernel of its own with L^{-1} packed
    to its lower triangle (``mid_launch_plan``).  As in hlax, one Newton
    step ``_refine_tri_inverse`` follows it.
  * ``chol_inv_bwd_cuda`` (``csrc/chol_inv_bwd.cu``, n <= 48): the backward
    of the small factorization, replaces the TPU kernel ``_bwd_kernel``.
    One warp a matrix, zero-padded to a compiled size (20 for T = 20); each
    of its five products is a loop of fused multiply-adds on register
    subtiles of 4 x 4 a lane (``bwd_launch_plan``).
  * ``chol_inv_mid_bwd_cuda`` (``csrc/chol_inv_mid_bwd.cu``, 24 < n <= 128):
    the backward of the mid factorization, stands for XLA's fusion of
    hlax's ``_mid_bwd`` (the matmul pullback ``_bwd_reference``).  Three
    launches on 32-row panels and 32 x 32 tile pairs, Lb2 and Y through a
    workspace of two [batch, n, n] (``mid_bwd_launch_plan``).

``chol_inv_blocked`` is hlax's dispatcher: the small kernel for n <= 24,
the mid kernel up to 128, and above that hlax's blocked composition, with
the diagonal blocks through the mid kernel and the panels, Schur updates
and inverse assembly as ``torch.matmul`` (TF32 stays off).  hlax sends
float64 to XLA's library Cholesky and falls back to it when n has no
divisor in [8, 128]; the port keeps its kernels in both dtypes, and for
such n makes the trailing diagonal block shorter.

The two forward kernels keep hlax's degenerate-pivot guard: a pivot below
``pivot_floor_rel(dtype) * max(diag A)`` is floored and its column pinned
to sqrt(floor) * e_j, so a matrix that rounding makes indefinite still
factorizes to a finite nearby one.  The floor is hlax's 1e-6 in float32;
hlax factorizes float64 unguarded (XLA's Cholesky), and the port's float64
floor is 2e-15, about the multiple of machine epsilon that 1e-6 is of
float32's, so no pivot of an SPD matrix with a jitter of 1e-6 reaches it.
Both read only the lower triangle of A.

``_chol_inv_plain`` is the plain PyTorch version of both forward kernels
(the guarded column loop as tensor ops), ``_chol_inv_bwd_plain`` that of
both backward kernels (``_bwd_reference``, the matmul-only
Cholesky-plus-inverse pullback, counted under each kernel's key).  The
small kernel and the mid kernel's one-warp path do the plain version's
operations in its order and agree with it bit for bit, in either dtype; the
mid kernel's blocked path and the backward kernels sum in another order
with fused multiply-adds and are held to an error bar instead.  The
autograd Functions use the plain versions for a CPU tensor only; for a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from hlax_torch.ops.counters import Counters
from hlax_torch.ops.cuda_build import check_launch, load_library

# the guard's floor relative to max(diag A), by dtype; must match
# pivot_floor_rel in csrc/chol_inv_common.cuh
PIVOT_FLOOR_REL = {torch.float32: 1e-6, torch.float64: 2e-15}
MAX_SMALL_T = 48      # largest n the small (one-warp) kernel takes
MAX_DIAG_BLOCK = 24   # chol_inv_blocked: n <= 24 -> small, else mid (hlax's)
MAX_MID_M = 128
MAX_WARP_ROWS = 32    # one warp a matrix, a row a lane: the small kernel's
                      # register path and the mid kernel's n <= 32 path
MID_WARPS_PER_BLOCK = 4
MID_BLOCK_THREADS = 512  # must match BLOCK_THREADS in csrc/chol_inv_mid.cu
MID64_BLOCK_THREADS = 256  # float64: must match F64_THREADS there
MID_PANEL = 8         # must match NB there
# compiled sizes of the small kernel's register path (n <= 32) and of the
# backward kernel: the canonical T = 20 and the largest n of each range,
# every other n padded up; must match the instantiations in
# csrc/chol_inv_small.cu and csrc/chol_inv_bwd.cu
SMALL_SIZES = (20, 32)
BWD_SIZES = (20, 32, 48)
BWD_BUFS = 6          # NP x NP buffers a matrix, BWD_BUFS in chol_inv_bwd.cu
# the mid pullback's panel rows and tile width, and its launches' threads:
# must match MB_ROWS, MB_AB_THREADS and MB_C_THREADS in
# csrc/chol_inv_mid_bwd.cu
MID_BWD_ROWS = 32
MID_BWD_AB_THREADS = 256
MID_BWD_C_THREADS = 128
H100_SMS = 132
SMEM_PER_BLOCK = 232_448  # an H100 block's dynamic shared memory, bytes
DTYPES = (torch.float32, torch.float64)  # what the kernels take

# Kernel launches and plain-version calls on CUDA tensors since the last
# ``reset_counters``, and the launches by input shape and dtype
# {(kernel, shape, "float32" or "float64"): launches}: a run reads them to
# show which path it took (``hlax_torch.ops.counters``).
_COUNTERS = Counters(("chol_inv_small_cuda", "chol_inv_mid_cuda",
                      "chol_inv_bwd_cuda", "chol_inv_mid_bwd_cuda"),
                     ("chol_inv_plain", "chol_inv_bwd_plain",
                      "chol_inv_mid_bwd_plain"))
LAUNCHES = _COUNTERS.launches
LAUNCHES_BY_SHAPE = _COUNTERS.by_shape
PLAIN_CUDA_CALLS = _COUNTERS.plain
reset_counters = _COUNTERS.reset


class MidPlan(NamedTuple):
    """Launch of the mid kernel for ``batch`` matrices of n x n."""
    path: str      # "warp": one warp a matrix; "blocked": one block a matrix
    grid: int      # blocks
    threads: int   # threads a block
    panel: int     # panel width of the blocked path (0 on the warp path)
    smem: int      # dynamic shared memory a block, bytes
    per_block: int  # matrices a block


def mid_launch_plan(n: int, batch: int, itemsize: int = 4) -> MidPlan:
    """The plan ``chol_inv_mid_launch`` (``csrc/chol_inv_mid.cu``) takes for
    values of ``itemsize`` bytes: for n <= 32 four warps a block, each
    staging its identity-padded 32 x 32 matrix in a 33-value-stride tile;
    above, one block a matrix with A identity-padded to np, a multiple of
    the panel width, in shared memory beside L^{-1}, the panel's L21
    transposed and its diagonal block.  In float32, 512 threads and L^{-1}
    as a full np x np array; in float64, 256 threads and L^{-1} packed to
    the rows of its lower 8 x 8 tiles (``xrow`` there): 184,832 bytes at
    n = 120, 209,408 at n = 128."""
    if n <= MAX_WARP_ROWS:
        w = MID_WARPS_PER_BLOCK
        return MidPlan("warp", -(-batch // w), 32 * w, 0,
                       w * 32 * 33 * itemsize, w)
    np_ = -(-n // MID_PANEL) * MID_PANEL
    panel = MID_PANEL * (np_ + MID_PANEL)
    if itemsize == 4:
        return MidPlan("blocked", batch, MID_BLOCK_THREADS, MID_PANEL,
                       4 * (2 * np_ * np_ + panel), 1)
    nt = np_ // MID_PANEL
    x_packed = 4 * MID_PANEL * nt * (nt + 1)
    return MidPlan("blocked", batch, MID64_BLOCK_THREADS, MID_PANEL,
                   itemsize * (np_ * np_ + x_packed + panel), 1)


def _per_block(batch: int, sms: int, smem_per_matrix: int) -> int:
    """Matrices a block, one warp each (1, 2 or 4, within a block's shared
    memory), that spread ``batch`` most evenly over ``sms`` SMs: the fewest
    warps on the busiest SM, then the fewest blocks."""
    def busiest(m):
        return m * -(-(-(-batch // m)) // sms)
    fits = [m for m in (4, 2, 1) if m * smem_per_matrix <= SMEM_PER_BLOCK]
    return min(fits, key=lambda m: (busiest(m), -m))


class SmallPlan(NamedTuple):
    """Launch of the small kernel for ``batch`` matrices of n x n."""
    path: str      # "warp": rows in registers; "smem": in shared memory
    np: int        # compiled size the matrix is padded to (n on "smem")
    grid: int      # blocks
    threads: int   # threads a block, one warp a matrix
    smem: int      # dynamic shared memory a block, bytes
    per_block: int  # matrices a block


@functools.lru_cache(maxsize=256)
def small_launch_plan(n: int, batch: int, sms: int = H100_SMS,
                      itemsize: int = 4) -> SmallPlan:
    """The plan ``chol_inv_small_launch`` (``csrc/chol_inv_small.cu``)
    takes for values of ``itemsize`` bytes: for n <= 32 the smallest
    compiled size np >= n, each warp staging its matrix in and out through
    two np x (np + 1) tiles; above, A and L^{-1} in shared memory, n x n
    each.  The warps a block spread the batch over the ``sms`` SMs
    (``_per_block``)."""
    if n <= MAX_WARP_ROWS:
        np_ = next(s for s in SMALL_SIZES if s >= n)
        path, per_matrix = "warp", itemsize * 2 * np_ * (np_ + 1)
    else:
        np_, path, per_matrix = n, "smem", itemsize * 2 * n * n
    w = _per_block(batch, sms, per_matrix)
    return SmallPlan(path, np_, -(-batch // w), 32 * w, w * per_matrix, w)


class BwdPlan(NamedTuple):
    """Launch of the backward kernel for ``batch`` matrices of n x n."""
    np: int        # compiled size the matrix is zero-padded to
    grid: int      # blocks
    threads: int   # threads a block, one warp a matrix
    smem: int      # dynamic shared memory a block, bytes
    per_block: int  # matrices a block


@functools.lru_cache(maxsize=256)
def bwd_launch_plan(n: int, batch: int, sms: int = H100_SMS,
                    itemsize: int = 4) -> BwdPlan:
    """The plan ``chol_inv_bwd_launch`` (``csrc/chol_inv_bwd.cu``) takes for
    values of ``itemsize`` bytes: the smallest compiled size np >= n,
    BWD_BUFS np x np buffers a matrix, and the warps a block that spread the
    batch over the SMs."""
    np_ = next(s for s in BWD_SIZES if s >= n)
    per_matrix = itemsize * BWD_BUFS * np_ * np_
    m = _per_block(batch, sms, per_matrix)
    return BwdPlan(np_, -(-batch // m), 32 * m, m * per_matrix, m)


class MidBwdPlan(NamedTuple):
    """Launches of the mid pullback for ``batch`` matrices of n x n."""
    panels: int      # row panels of MID_BWD_ROWS a matrix
    grid_ab: int     # blocks of the fold and project launches, (matrix, panel)
    grid_c: int      # blocks of the symmetrize launch, (matrix, tile pair)
    threads_ab: int
    threads_c: int
    smem_ab: int     # dynamic shared memory a block, bytes
    smem_c: int


@functools.lru_cache(maxsize=256)
def mid_bwd_launch_plan(n: int, batch: int, itemsize: int = 4) -> MidBwdPlan:
    """The plan ``chol_inv_mid_bwd_launch`` (``csrc/chol_inv_mid_bwd.cu``)
    takes for values of ``itemsize`` bytes: its three launches a block a
    (matrix, 32-row panel), a (matrix, panel) and a (matrix, lower pair of
    32 x 32 tiles).  No SM count enters it: the grids are the batch's panels
    and tile pairs.  A panel p (rows r0 = 32 p on, cw = min(r0 + 32, n)
    columns of the leading block, cwp = cw rounded up to 4) takes its 32
    columns of S^T or P^T (cwp x 32) beside the larger of the k-major
    strips of its first product, (n - r0) x (cwp + 32), and the right
    factor of its second, cw x (cwp + 4); a tile pair (I, J) two strips of
    L^{-1} and two of Y of (n - 32 I) x 32 (one each where I = J) beside
    the mirrored tile, 32 x 33.  At n = 120: 74,880 bytes for the panels
    and 49,280 for the pairs in float32."""
    rows = MID_BWD_ROWS
    panels = -(-n // rows)
    ab = 0
    for p in range(panels):
        r0 = rows * p
        cw = min(r0 + rows, n)
        cwp = -(-cw // 4) * 4
        ab = max(ab, cwp * rows + max((n - r0) * (cwp + rows),
                                      cw * (cwp + 4)))
    c = max(2 * n, 4 * (n - rows)) * rows + rows * (rows + 1)
    pairs = panels * (panels + 1) // 2
    return MidBwdPlan(panels, batch * panels, batch * pairs,
                      MID_BWD_AB_THREADS, MID_BWD_C_THREADS, itemsize * ab,
                      itemsize * c)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pivot_floor_rel(dtype: torch.dtype) -> float:
    """The guard's pivot floor relative to max(diag A) in ``dtype``."""
    return PIVOT_FLOOR_REL.get(dtype, PIVOT_FLOOR_REL[torch.float32])


def _chol_inv_plain(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of both kernels: guarded right-looking column
    loop over [..., n, n], the small kernel's arithmetic
    (``csrc/chol_inv_common.cuh``); the mid kernel computes the same
    function in blocked order.

    Note: hlax's float32 mid kernel takes its pivot floor over the
    identity-padded matrix (M rounded up to a multiple of 8), so for such M
    with max(diag A) < 1 its floor is 1e-6 where this one is
    1e-6 * max(diag A).  The main path's M = 120 has no padding."""
    if a.is_cuda:
        PLAIN_CUDA_CALLS["chol_inv_plain"] += 1
    n = a.shape[-1]
    A = a.clone()
    idx = torch.arange(n, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    floor = pivot_floor_rel(a.dtype) * torch.diagonal(A, dim1=-2, dim2=-1).amax(
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
    if a.dtype not in DTYPES:
        raise ValueError(f"{what}: needs float32 or float64, got {a.dtype}")
    if a.dim() < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"{what}: needs [..., n, n], got {tuple(a.shape)}")
    if not lo < a.shape[-1] <= hi:
        raise ValueError(f"{what}: needs {lo} < n <= {hi}, got "
                         f"n={a.shape[-1]}")
    if not a.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous tensor")


def _launch(name: str, entry: str, a: torch.Tensor, plan):
    """(L, L^{-1}) from the C entry ``entry(a, l, il, batch, n, itemsize,
    *plan, stream)`` of ``lib<name>.so``: ``plan`` ints."""
    n = a.shape[-1]
    l, il = torch.empty_like(a), torch.empty_like(a)
    batch = a.numel() // (n * n)
    if batch == 0:
        return l, il
    lib = load_library(name)
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (3 + len(plan))
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = fn(a.data_ptr(), l.data_ptr(), il.data_ptr(), batch, n,
              a.element_size(), *plan, stream)
    check_launch(lib, entry, code)
    _COUNTERS.count(f"{name}_cuda", a)
    return l, il


def chol_inv_small_cuda(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L^{-1}) of contiguous float32 or float64 CUDA [..., n, n],
    n <= 48, by the one-warp-per-matrix kernel on the plan of
    ``small_launch_plan``."""
    _check(a, 0, MAX_SMALL_T, "chol_inv_small_cuda")
    n = a.shape[-1]
    plan = small_launch_plan(n, max(a.numel() // (n * n), 1),
                             _sms(a.device.index or 0), a.element_size())
    return _launch("chol_inv_small", "chol_inv_small_launch", a,
                   ({"warp": 0, "smem": 1}[plan.path], plan.np, plan.grid,
                    plan.threads, plan.smem))


def chol_inv_mid_cuda(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L^{-1}) of contiguous float32 or float64 CUDA [..., n, n],
    24 < n <= 128, by the mid kernel on the plan of ``mid_launch_plan``
    (without the Newton refinement).  hlax sends 24 < n <= 48 to its mid
    kernel too (``chol_inv_blocked``)."""
    _check(a, MAX_DIAG_BLOCK, MAX_MID_M, "chol_inv_mid_cuda")
    n = a.shape[-1]
    plan = mid_launch_plan(n, a.numel() // (n * n), a.element_size())
    return _launch("chol_inv_mid", "chol_inv_mid_launch", a,
                   ({"warp": 0, "blocked": 1}[plan.path], plan.grid,
                    plan.threads, plan.panel, plan.smem))


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


def _chol_inv_bwd_plain(l, il, l_bar, il_bar, key="chol_inv_bwd_plain"):
    """Plain PyTorch version of both backward kernels: ``_bwd_reference``,
    counted under ``key`` (``"chol_inv_mid_bwd_plain"`` for the mid
    pullback's) on CUDA tensors."""
    if l.is_cuda:
        PLAIN_CUDA_CALLS[key] += 1
    return _bwd_reference(l, il, l_bar, il_bar)


def _check_bwd(l, il, l_bar, il_bar, lo: int, hi: int, what: str):
    """The pullbacks' inputs checked (CUDA, float32 or float64, one dtype,
    four equal [..., n, n] shapes, lo < n <= hi, contiguous), with the
    cotangents made contiguous first: autograd hands them over strided or
    expanded.  Returns the cotangents."""
    l_bar, il_bar = l_bar.contiguous(), il_bar.contiguous()
    for t in (l, il, l_bar, il_bar):
        _check(t, lo, hi, what)
    if not l.shape == il.shape == l_bar.shape == il_bar.shape:
        raise ValueError(f"{what}: needs four equal shapes, got "
                         f"{[tuple(t.shape) for t in (l, il, l_bar, il_bar)]}")
    if len({t.dtype for t in (l, il, l_bar, il_bar)}) != 1:
        raise ValueError(f"{what}: needs one dtype, got "
                         f"{[t.dtype for t in (l, il, l_bar, il_bar)]}")
    return l_bar, il_bar


def chol_inv_bwd_cuda(l: torch.Tensor, il: torch.Tensor, l_bar: torch.Tensor,
                      il_bar: torch.Tensor) -> torch.Tensor:
    """A_bar of (L, L^{-1}) = chol_inv(A) from the saved factors and the
    cotangents of both outputs, float32 or float64 CUDA [..., n, n] of one
    dtype, n <= 48, by the
    kernel on the plan of ``bwd_launch_plan``; ``_bwd_reference``'s lower
    convention.  L and L^{-1} must be lower-triangular, as the forward
    kernel leaves them.  The cotangents may be strided or expanded
    (autograd hands them over so); they are made contiguous first."""
    l_bar, il_bar = _check_bwd(l, il, l_bar, il_bar, 0, MAX_SMALL_T,
                               "chol_inv_bwd_cuda")
    n = l.shape[-1]
    a_bar = torch.empty_like(l)
    batch = l.numel() // (n * n)
    if batch == 0:
        return a_bar
    plan = bwd_launch_plan(n, batch, _sms(l.device.index or 0),
                           l.element_size())
    lib = load_library("chol_inv_bwd")
    fn = lib.chol_inv_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(l.device).cuda_stream
    code = fn(l.data_ptr(), il.data_ptr(), l_bar.data_ptr(), il_bar.data_ptr(),
              a_bar.data_ptr(), batch, n, l.element_size(), plan.np,
              plan.grid, plan.threads, plan.smem, stream)
    check_launch(lib, "chol_inv_bwd_launch", code)
    _COUNTERS.count("chol_inv_bwd_cuda", l)
    return a_bar


def chol_inv_mid_bwd_cuda(l: torch.Tensor, il: torch.Tensor,
                          l_bar: torch.Tensor,
                          il_bar: torch.Tensor) -> torch.Tensor:
    """A_bar of (L, L^{-1}) = chol_inv_mid(A), the mid factorization's
    pullback, from the saved factors and the cotangents of both outputs,
    float32 or float64 CUDA [..., n, n] of one dtype, 24 < n <= 128 (the
    mid kernel's whole range: 24 < n <= 48 comes here too, not to
    ``chol_inv_bwd_cuda``), by the kernels of ``csrc/chol_inv_mid_bwd.cu``
    on the plan of ``mid_bwd_launch_plan``: three launches, one count;
    ``_bwd_reference``'s lower convention.  L and L^{-1} must be
    lower-triangular, as the mid kernel and its Newton step leave them.  The
    cotangents may be strided or expanded; they are made contiguous first.
    The workspace (Lb2 and Y) is allocated with ``torch.empty``, so a CUDA
    graph can capture the launch."""
    l_bar, il_bar = _check_bwd(l, il, l_bar, il_bar, MAX_DIAG_BLOCK,
                               MAX_MID_M, "chol_inv_mid_bwd_cuda")
    n = l.shape[-1]
    a_bar = torch.empty_like(l)
    batch = l.numel() // (n * n)
    if batch == 0:
        return a_bar
    work = torch.empty((2,) + tuple(l.shape), dtype=l.dtype, device=l.device)
    plan = mid_bwd_launch_plan(n, batch, l.element_size())
    lib = load_library("chol_inv_mid_bwd")
    fn = lib.chol_inv_mid_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(l.device).cuda_stream
    code = fn(l.data_ptr(), il.data_ptr(), l_bar.data_ptr(), il_bar.data_ptr(),
              a_bar.data_ptr(), work.data_ptr(), batch, n, l.element_size(),
              *plan, stream)
    check_launch(lib, "chol_inv_mid_bwd_launch", code)
    _COUNTERS.count("chol_inv_mid_bwd_cuda", l)
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
        l, il = ctx.saved_tensors
        if l.is_cuda:
            return chol_inv_mid_bwd_cuda(l, il, l_bar, il_bar)
        return _chol_inv_bwd_plain(l, il, l_bar, il_bar,
                                   "chol_inv_mid_bwd_plain")


def chol_inv_small(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (L, L^{-1}) of SPD [..., n, n], n <= 48."""
    return _CholInvSmall.apply(a.contiguous())


def chol_inv_mid(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (L, refined L^{-1}) of SPD [..., n, n], 24 < n <= 128
    (any n on the CPU)."""
    return _CholInvMid.apply(a.contiguous())


def _largest_block(m: int, cap: int) -> int:
    """Largest divisor of m that is <= cap and >= 8 (0 if none), as hlax's."""
    for cand in range(min(cap, m), 7, -1):
        if m % cand == 0:
            return cand
    return 0


def _block_sizes(n: int):
    """Diagonal block sizes of the composition for n > 128: hlax's
    ``_largest_block(n, 128)`` repeated; for n with no divisor in [8, 128]
    (where hlax falls back to XLA's Cholesky) the fewest blocks of at most
    128, equal but for a shorter trailing one, which the mid kernel pads
    with the identity to its panel width."""
    b = _largest_block(n, MAX_MID_M)
    if b:
        return [b] * (n // b)
    nb = -(-n // MAX_MID_M)
    b = -(-n // nb)
    return [b] * (nb - 1) + [n - b * (nb - 1)]


def _chol_inv_composed(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """hlax's right-looking block factorization of ``chol_inv_blocked``
    (``hlax/ops/linalg_small.py:729-762``): each diagonal block, at most
    128, goes through ``chol_inv_blocked`` (the kernels on the card, their
    plain versions on the CPU), the off-diagonal panels and Schur updates are matmuls, and
    the inverse is assembled by the block forward-substitution identity
        iL[i,k] = -iL[i,i] (sum_{k<=j<i} L[i,j] iL[j,k]).
    Differentiable: autograd runs through the matmuls and the diagonal
    blocks' custom backward.  ``a`` is split into block views once, so the
    backward forms one full-size gradient of ``a``, not one a block."""
    sizes = _block_sizes(a.shape[-1])
    nb = len(sizes)
    blk = [row.split(sizes, dim=-1) for row in a.split(sizes, dim=-2)]
    L = [[None] * nb for _ in range(nb)]
    iL = [[None] * nb for _ in range(nb)]
    for k in range(nb):
        s = blk[k][k]
        for j in range(k):
            s = s - torch.matmul(L[k][j], L[k][j].mT)
        L[k][k], iL[k][k] = chol_inv_blocked(s)
        for i in range(k + 1, nb):
            p = blk[i][k]
            for j in range(k):
                p = p - torch.matmul(L[i][j], L[k][j].mT)
            L[i][k] = torch.matmul(p, iL[k][k].mT)
    for k in range(nb):
        for i in range(k + 1, nb):
            acc = torch.matmul(L[i][k], iL[k][k])
            for j in range(k + 1, i):
                acc = acc + torch.matmul(L[i][j], iL[j][k])
            iL[i][k] = -torch.matmul(iL[i][i], acc)

    def rows(B):
        return torch.cat([torch.cat(
            [B[i][j] if j <= i else a.new_zeros(a.shape[:-2]
                                                + (sizes[i], sizes[j]))
             for j in range(nb)], dim=-1) for i in range(nb)], dim=-2)
    return rows(L), rows(iL)


def chol_inv_blocked(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatcher of hlax's ``chol_inv_blocked``: the small kernel for
    n <= 24, the mid kernel (plus refinement) up to 128, hlax's blocked
    composition above (``_chol_inv_composed``), on the card and on the
    CPU alike."""
    n = a.shape[-1]
    if n <= MAX_DIAG_BLOCK:
        return chol_inv_small(a)
    if n <= MAX_MID_M:
        return chol_inv_mid(a)
    return _chol_inv_composed(a)
