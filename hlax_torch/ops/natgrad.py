"""The natural-gradient chain as hand-written CUDA kernels
(``csrc/natgrad.cu``).

hlax jits ``kld_upper_bound`` and ``natural_gradient_update``
(``hlax/gp/elbo.py:237-285``, ``:425-469``) and XLA folds the chains
between their dots into a few fusions; the port ran them op by op, some
forty-five kernels a step.  Four kernels take them, and the large batched
products stay cuBLAS's (``torch.bmm``, ``torch.baddbmm``; the whitened
Gram's einsums), as hlax leaves them to XLA's dots:

  * ``fwd_subjects`` (K5, ``natgrad_fwd_subjects``): ng_P1 = sum_s
    K0xz_s^T iB_s (mu_s valid_s) (``hlax/gp/elbo.py:241-243``), a latent's
    rows split over one thread-block cluster (``subjects_plan``): each
    block's rows of K0xz in flight (a bulk copy) while it makes their iB
    mu, so iB mu is made once a latent; the blocks' column partials added
    in block order through distributed shared memory; subjects longer than
    TP rows take iB mu from cuBLAS, as the bound's row tiles take their
    products.
  * ``fwd_latents`` (K6, ``natgrad_fwd_latents``): from X = iLK^T (I + C_w)
    iLK (cuBLAS, ``baddbmm`` then ``bmm``), B = (X + X^T) / 2, grad_H =
    (B - iH) / 2 and grad_m = B m - iK ng_P1 (``:272-282``).
  * ``update_pre`` (K7, ``natgrad_update_pre``): iH_new = iH + lr (grad_H +
    grad_H^T) (+ jitter mean(diag iH_new) I) and rhs = iH m - lr (grad_m -
    2 grad_H m) (``:459-463`` and the bracket of ``:465-468``).
    K6 and K7 take a (strip of rows, latent) a block and a warp a 16-byte
    unit of its rows (``strip_plan``, sized from the card's SM count and
    shared memory): the block's strip rows, the box of its transposed
    entries (X's or grad_H's columns i0 .. i0 + rows of every row), the
    latent's vectors and, in K7 with jitter, the diagonals, all copied
    into shared memory at its start (16-byte copies where aligned, element
    copies elsewhere) before one block barrier; each row's sums in double
    over the warp's lanes by a butterfly, K7's diagonal mean by every warp
    alike.
  * ``update_finish`` (K8, ``natgrad_update_finish``): H_new = iLA^T iLA
    from the inverse factor of iH_new (the mid Cholesky kernel's, or the
    library's) and m_new = H_new rhs, in the state's dtype (``:454``,
    ``:464-469``), written into the caller's (m, H) where given: only the
    lower triangle's 32-row tiles, on the FP64 tensor cores, each written
    with its mirror; a latent's blocks one cluster (``finish_plan``).

Every sum is in double, in a fixed order.  The plain versions are the
port's op-by-op code, which the CPU runs and the parity tests hold to hlax;
on CUDA in float32 and float64 the kernels run (the chain in float64 on
float32 inputs and state too: ``--nat_grad_f64``), else the plain version,
counted in ``PLAIN_CUDA_CALLS``.  A failed build or launch raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hlax_torch.ops import fusion
from hlax_torch.ops.counters import Counters

# must match NT, TP, CLUSTER, RMAX, SWMAX, MAX_M, FT, FH and FWMAX in
# csrc/natgrad.cu: K5's threads a block, the subjects' rows past which
# cuBLAS takes iB mu; K5's and K8's blocks a cluster at most (the portable
# size); K6 and K7's rows and warps a block at most; K5-K8's columns at
# most; K8's tile rows, a task's columns (half a tile) and warps a block at
# most
THREADS, TP, CLUSTER, RMAX, STRIP_WARPS, MAX_M = 512, 32, 8, 16, 8, 512
TILE, HALF, FINISH_WARPS = 32, 16, 16
# the kernels' static shared bytes (K6 and K7 have none): K5's column
# groups' sums and three mbarriers; K8's rhs, row partials, a round's task
# parts, task ids and row tiles' parts, two mbarriers
SUBJECTS_STATIC = THREADS * 8 + 3 * 8
FINISH_STATIC = ((2 * MAX_M + FINISH_WARPS * (TILE + HALF)) * 8
                 + 2 * FINISH_WARPS * 4 + 2 * 8)
SMEM_MAX = 227 * 1024
# K8's rows a ring stage holds where a latent's rows do not fit one stage
FINISH_CHUNK = 32


# the H100's graphics processing clusters: a cluster's blocks share one
GPCS = 8


def cluster_blocks(L: int, sms: int, most: int = CLUSTER) -> int:
    """Blocks a latent's cluster for L latents at one block an SM, between
    1 and ``most``: the most whose L clusters fit the ``sms`` SMs at once
    even where each of the GPCS GPCs leaves a cluster's size less one SM
    idle (clusters of 4 for 32 latents at 132 SMs ran a second wave)."""
    return max(1, min(most, CLUSTER, (sms + GPCS) // (L + GPCS)))
# the (first, second) dtypes each kernel compiles beside the two equal
# pairs: K5 float inputs with a float64 ng_P1, K6-K8 a float64 chain on a
# float32 state
MIXED_SUBJECTS = (torch.float32, torch.float64)
MIXED_LATENTS = (torch.float64, torch.float32)

KERNELS = ("natgrad_fwd_subjects", "natgrad_fwd_latents",
           "natgrad_update_pre", "natgrad_update_finish")
_COUNTERS = Counters(tuple(f"{k}_cuda" for k in KERNELS),
                     tuple(f"{k}_plain" for k in KERNELS))
LAUNCHES = _COUNTERS.launches
LAUNCHES_BY_SHAPE = _COUNTERS.by_shape
PLAIN_CUDA_CALLS = _COUNTERS.plain
reset_counters = _COUNTERS.reset


def _al16(n: int) -> int:
    return -(-n // 16) * 16


# K6's and K7's staged arrays (csrc/natgrad.cu): the strip's rows of how
# many [M, M] inputs (K6 X, iK, iH; K7 iH, grad_H), and how many vectors of
# M in the chain's type (K6 ng_P1; K7 the diagonals of iH and grad_H)
STRIP_ARRAYS = {"natgrad_fwd_latents": (3, 1), "natgrad_update_pre": (2, 2)}


def box_stride(rows: int, itemsize: int) -> int:
    """Entries a row of K6's and K7's staged box (box_stride,
    csrc/natgrad.cu): ``rows`` entries rounded up to 16-byte units, an odd
    number of them, so a quarter warp's 16-byte reads of eight rows fall in
    distinct banks."""
    return (-(-rows * itemsize // 16) | 1) * 16 // itemsize


def strip_smem(rows: int, M: int, itemsize: int, state_itemsize: int,
               kernel: str) -> int:
    """K6's or K7's dynamic shared bytes (strip_smem, csrc/natgrad.cu):
    the strip's rows of each [M, M] input, the box of the transposed
    entries (M rows of ``box_stride``), the vectors and m in the state's
    dtype."""
    arrays, vecs = STRIP_ARRAYS[kernel]
    return (arrays * _al16(rows * M * itemsize)
            + _al16(M * box_stride(rows, itemsize) * itemsize)
            + _al16(vecs * M * itemsize) + _al16(M * state_itemsize))


def strip_threads(rows: int, itemsize: int) -> int:
    """K6's and K7's threads a block (strip_threads, csrc/natgrad.cu): a
    warp a 16-byte unit of the strip's rows (4 rows in float, 2 in
    double)."""
    return 32 * -(-rows * itemsize // 16)


class StripPlan(NamedTuple):
    """K6's or K7's grid: ``strips`` strips of ``rows`` rows of each
    latent's [M, M] matrices (the last one may be shorter), a block a
    (strip, latent) of ``threads`` threads (``strip_threads``), ``blocks``
    = strips L, ``smem`` dynamic shared bytes."""
    rows: int
    strips: int
    threads: int
    blocks: int
    smem: int


def strip_plan(L: int, M: int, itemsize: int, state_itemsize: int,
               kernel: str, sms: int) -> StripPlan:
    """The most rows a strip, at most RMAX and halving, whose L
    ceil(M / rows) blocks still give half of ``sms`` SMs one and whose
    shared bytes fit (fewer blocks where even one row a strip does not)."""
    if not 1 <= M <= MAX_M:
        raise ValueError(f"natgrad: M = {M} inducing points, the kernels "
                         f"take 1 to {MAX_M}")
    smem = lambda r: strip_smem(r, M, itemsize, state_itemsize, kernel)
    rows = RMAX
    while rows > 1 and (2 * L * -(-M // rows) < sms
                        or smem(rows) > SMEM_MAX):
        rows //= 2
    strips = -(-M // rows)
    return StripPlan(rows, strips, strip_threads(rows, itemsize),
                     L * strips, smem(rows))


class SubjectsPlan(NamedTuple):
    """K5's launch: a latent's S T rows split over ``cluster`` blocks (one
    thread-block cluster), a block's in chunks of ``chunk`` rows through
    ``stages`` shared stages (one where they all fit); ``smem`` dynamic
    shared bytes."""
    cluster: int
    chunk: int
    stages: int
    smem: int


def subjects_smem(chunk: int, stages: int, M: int, T: int, iB: bool,
                  cluster: int, itemsize: int) -> int:
    """K5's dynamic shared bytes (subjects_smem, csrc/natgrad.cu): the
    stages of a chunk's rows of K0xz, the chunk's iB rows and mu valid of
    the subjects they span (where ``iB``: the kernel makes iB mu), its iB
    mu, and the inbox of the cluster's blocks' column sums."""
    return (_al16(stages * chunk * M * itemsize)
            + (_al16(chunk * T * itemsize) + _al16((chunk + 2 * T) * 8)
               if iB else 0)
            + _al16(chunk * 8) + cluster * M * 8)


def subjects_plan(L: int, S: int, T: int, M: int, itemsize: int, iB: bool,
                  sms: int) -> SubjectsPlan:
    """A cluster of ``cluster_blocks`` blocks a latent, each a share of its
    rows; a block's rows in one stage where their shared bytes fit beside
    the static ones, else chunks halved until two stages fit."""
    if not 1 <= M <= MAX_M:
        raise ValueError(f"natgrad: M = {M} inducing points, the kernels "
                         f"take 1 to {MAX_M}")
    cl = cluster_blocks(L, sms)
    q, budget = -(-S * T // cl), SMEM_MAX - SUBJECTS_STATIC
    chunk, stages = q, 1
    while subjects_smem(chunk, stages, M, T, iB, cl, itemsize) > budget:
        chunk, stages = -(-chunk // 2), 2
    return SubjectsPlan(cl, chunk, stages,
                        subjects_smem(chunk, stages, M, T, iB, cl, itemsize))


def finish_rows(M: int, chunk: int) -> int:
    """K8's rows a stage: all of them (rounded up to a k-step of 8) where
    the chunk takes the whole latent, else ``chunk``."""
    return -(-M // 8) * 8 if chunk >= M else chunk


def finish_smem(M: int, chunk: int, warps: int, cluster: int,
                itemsize: int) -> int:
    """K8's dynamic shared bytes (finish_smem, csrc/natgrad.cu): one stage
    of the latent's whole rows and a split task's part for each warp, or a
    ring of two stages of ``chunk`` rows; then the inbox of m_new's
    partials, the cluster's blocks' of every row."""
    inbox = cluster * -(-M // TILE) * TILE * 8
    if chunk >= M:
        return (_al16(finish_rows(M, chunk) * M * itemsize)
                + warps * TILE * HALF * 8 + inbox)
    return 2 * finish_rows(M, chunk) * M * itemsize + inbox


def finish_tasks(c: int, cluster: int, M: int) -> list:
    """Block ``c``'s (of ``cluster``) tasks (I, J, h) in order
    (finish_task, csrc/natgrad.cu): its row tiles I = c, c + cluster, ...,
    each tile J <= I and half h of 16 columns, less a last half whose
    columns all lie past M."""
    n_i = -(-M // TILE)
    return [(I, J, h) for I in range(c, n_i, cluster) for J in range(I + 1)
            for h in (0, 1) if TILE * J + HALF * h < M]


def finish_parts(c: int, cluster: int, M: int, warps: int,
                 resident: bool) -> list:
    """The warps each of block ``c``'s row tiles' tasks are split over (the
    kernel's greedy deal): one each, then, where the latent is resident,
    the spare warps to the row tile whose parts of the rows k >= 32 I are
    longest, a part for each of its tasks at a time, while they last."""
    tiles = list(range(c, -(-M // TILE), cluster))
    n = [len([t for t in finish_tasks(c, cluster, M) if t[0] == I])
         for I in tiles]
    mk = -(-M // 8) * 8
    parts, spare = [1] * len(tiles), warps - sum(n)
    while resident and spare > 0:
        best = None
        for u, I in enumerate(tiles):
            if n[u] <= spare and (best is None or (mk - TILE * I) * parts[best]
                                  > (mk - TILE * tiles[best]) * parts[u]):
                best = u
        if best is None:
            break
        spare -= n[best]
        parts[best] += 1
    return parts


class FinishPlan(NamedTuple):
    """K8's launch: ``cluster`` blocks a latent (one cluster), each of
    ``warps`` warps taking its tasks in rounds of a task a warp (or a task
    over several warps, ``finish_parts``); iLA's rows in one stage
    (``chunk`` >= M) or a ring of ``stages`` stages of ``chunk`` rows;
    ``smem`` dynamic shared bytes."""
    cluster: int
    warps: int
    chunk: int
    stages: int
    smem: int


def finish_plan(L: int, M: int, itemsize: int, sms: int,
                cluster: bool = True) -> FinishPlan:
    """A cluster of ``cluster_blocks`` blocks a latent, at most one a row
    tile of 32 (one block a latent without ``cluster``), of FINISH_WARPS warps
    (a split task's parts fill them) where the whole latent's rows and the
    parts fit one stage beside the static shared bytes, else a ring of
    FINISH_CHUNK rows, halved until two stages fit, and as many warps as
    the busiest block's tasks (at most FINISH_WARPS)."""
    if not 1 <= M <= MAX_M:
        raise ValueError(f"natgrad: M = {M} inducing points, the kernels "
                         f"take 1 to {MAX_M}")
    cl = cluster_blocks(L, sms, -(-M // TILE)) if cluster else 1
    budget = SMEM_MAX - FINISH_STATIC
    warps, chunk = FINISH_WARPS, M
    if finish_smem(M, chunk, warps, cl, itemsize) > budget:
        warps = min(FINISH_WARPS,
                    max(len(finish_tasks(c, cl, M)) for c in range(cl)))
        chunk = FINISH_CHUNK
        while finish_smem(M, chunk, warps, cl, itemsize) > budget:
            chunk //= 2
    return FinishPlan(cl, warps, chunk, 1 if chunk >= M else 2,
                      finish_smem(M, chunk, warps, cl, itemsize))


def _launch(entry: str, like: torch.Tensor, *args) -> None:
    """``fusion.launch`` of a C entry of libnatgrad.so."""
    fusion.launch("natgrad", _COUNTERS, entry, like, *args)


def _on_card(t: torch.Tensor) -> bool:
    """Whether the kernel wrappers launch on ``t`` (else the kernels' plain
    versions run)."""
    return t.is_cuda


def _takes(kernel: str, t: torch.Tensor, *same, other=None,
           mixed=None) -> bool:
    """Whether ``kernel`` takes ``t`` with the tensors ``same`` (its dtype
    and device) and the dtype pair (t's, ``other``'s): on the card, equal
    kernel dtypes or the ``mixed`` pair.  A card's call that it does not
    take is counted in PLAIN_CUDA_CALLS."""
    if not _on_card(t):
        return False
    pair = (t.dtype, t.dtype if other is None else other)
    if (pair[0] in fusion.KERNEL_DTYPES
            and (pair[0] == pair[1] or pair == mixed)
            and all(o.dtype == t.dtype and o.device == t.device
                    for o in same)):
        return True
    PLAIN_CUDA_CALLS[f"{kernel}_plain"] += 1
    return False


def _sms(t: torch.Tensor) -> int:
    return fusion._sm_count(t.device.index) if t.is_cuda else fusion.GP_SMS


def _rows_of(mu: torch.Tensor) -> Optional[int]:
    """mu [S, T, L]'s row stride where its rows are laid out as K5 reads
    them (entries of a row contiguous, rows at one stride), else None."""
    S, T, L = mu.shape
    ld = mu.stride(1)
    if mu.stride(2) == 1 and ld >= L and (S == 1 or mu.stride(0) == T * ld):
        return ld
    return None


# ------------------------------------------------------------ the kernels
#
# Each wrapper allocates its kernel's outputs and launches it on a CUDA
# tensor; on a CPU tensor it runs the kernel's plain version (the port's
# op-by-op code), which the CPU tests hold to hlax and ``chip_smoke.py``
# holds the kernel to on the card.

def fwd_subjects_plain(iB, mu, valid, K0xz, dtype):
    """K5's plain version: ng_P1 [L, M, 1] in ``dtype``."""
    mu_m = mu * valid[:, :, None]                        # [S, T, L]
    iB_mu = torch.einsum("lstu,sul->lst", iB, mu_m)
    return torch.einsum("lstm,lst->lm", K0xz, iB_mu)[:, :, None].to(dtype)


def fwd_subjects(iB, mu, valid, K0xz, dtype: torch.dtype):
    """K5: ng_P1 = sum_st K0xz^T (iB (mu valid)) [L, M, 1] in ``dtype``
    (this rank's subjects' on a mesh).  iB [L, S, T, T], mu [S, T, L] (a
    view of the latents' columns as the mesh slices them), valid [S, T],
    K0xz [L, S, T, M]."""
    kernel = "natgrad_fwd_subjects"
    if not _takes(kernel, K0xz, iB, mu, valid, other=dtype,
                  mixed=MIXED_SUBJECTS):
        return fwd_subjects_plain(iB, mu, valid, K0xz, dtype)
    L, S, T, M = K0xz.shape
    fusion._check_shapes(kernel, iB=(iB, (L, S, T, T)), mu=(mu, (S, T, L)),
                         valid=(valid, (S, T)))
    ld = _rows_of(mu)
    if ld is None:
        mu, ld = mu.contiguous(), L
    K0xz, iB, valid = K0xz.contiguous(), iB.contiguous(), valid.contiguous()
    out = torch.empty((L, M, 1), dtype=dtype, device=K0xz.device)
    iBmu = None
    if T > TP:        # longer subjects: iB mu by cuBLAS
        iBmu = torch.matmul(iB, (mu * valid[:, :, None]).permute(
            2, 0, 1)[..., None])[..., 0]
    plan = subjects_plan(L, S, T, M, K0xz.element_size(), iBmu is None,
                         _sms(K0xz))
    _launch(kernel, K0xz, K0xz.element_size(), out.element_size(),
            None if iBmu is not None else iB, iBmu, mu, valid, K0xz, out, L,
            S, T, M, ld, plan.cluster, plan.chunk, plan.smem)
    return out


def latents_plain(X, iK, iH, ng_P1, m):
    """K6's plain version from X = iLK^T (I + C_w) iLK: (grad_m, grad_H)."""
    B_mat = 0.5 * (X + X.mT)
    grad_m = -torch.einsum("lmn,lno->lmo", iK, ng_P1) \
        + torch.einsum("lmn,lno->lmo", B_mat, m.to(X.dtype))
    return grad_m, 0.5 * (-iH + B_mat)


def fwd_latents(iLK, C_w, iK, iH, ng_P1, m):
    """K6 after cuBLAS's triple product: (grad_m [L, M, 1], grad_H
    [L, M, M]) in the chain's dtype (C_w's) from the whitened Gram sum C_w
    (summed over the ranks on a mesh), the inverse factor iLK of K0zz, iK,
    iH, ng_P1 and the state's m.  X = iLK^T (I + C_w) iLK is formed as
    iLK^T (iLK + C_w iLK), a ``baddbmm`` and a ``bmm``, on every device and
    dtype."""
    X = torch.bmm(iLK.mT, torch.baddbmm(iLK, C_w, iLK))
    if not _takes("natgrad_fwd_latents", C_w, iLK, iK, iH, ng_P1,
                  other=m.dtype, mixed=MIXED_LATENTS):
        return latents_plain(X, iK, iH, ng_P1, m)
    return latents(X, iK, iH, ng_P1, m)


def latents(X, iK, iH, ng_P1, m):
    """K6 alone on X (what ``fwd_latents`` launches after its products)."""
    L, M = X.shape[0], X.shape[1]
    fusion._check_shapes("natgrad_fwd_latents", iK=(iK, (L, M, M)),
                         iH=(iH, (L, M, M)), ng_P1=(ng_P1, (L, M, 1)),
                         m=(m, (L, M, 1)))
    kernel = "natgrad_fwd_latents"
    plan = strip_plan(L, M, X.element_size(), m.element_size(), kernel,
                      _sms(X))
    X, iK, iH, ng_P1, m = (t.contiguous() for t in (X, iK, iH, ng_P1, m))
    grad_m = torch.empty_like(ng_P1)
    grad_H = torch.empty_like(X)
    _launch(kernel, X, X.element_size(), m.element_size(), X, iK, iH, ng_P1,
            m, grad_m, grad_H, L, M, plan.rows, plan.smem)
    return grad_m, grad_H


def update_pre_plain(iH, grad_H, grad_m, m, lr: float, jitter: float):
    """K7's plain version: (iH_new, rhs)."""
    m_c = m.to(grad_H.dtype)
    iH_new = iH + lr * (grad_H + grad_H.mT)
    if jitter:
        mean_diag = torch.diagonal(iH_new, dim1=-2, dim2=-1).mean(
            -1)[:, None, None]
        iH_new = iH_new + jitter * mean_diag * torch.eye(
            iH.shape[-1], dtype=iH.dtype, device=iH.device)
    rhs = torch.einsum("lmn,lno->lmo", iH, m_c) \
        - lr * (grad_m - 2.0 * torch.einsum("lmn,lno->lmo", grad_H, m_c))
    return iH_new, rhs


def update_pre(iH, grad_H, grad_m, m, lr: float, jitter: float = 0.0):
    """K7: (iH_new = iH + lr (grad_H + grad_H^T), with ``jitter`` + jitter
    mean(diag iH_new) I, [L, M, M]; rhs = iH m - lr (grad_m - 2 grad_H m)
    [L, M, 1]) in the chain's dtype (grad_H's), from the state's m."""
    kernel = "natgrad_update_pre"
    if not _takes(kernel, grad_H, iH, grad_m, other=m.dtype,
                  mixed=MIXED_LATENTS):
        return update_pre_plain(iH, grad_H, grad_m, m, lr, jitter)
    L, M = grad_H.shape[0], grad_H.shape[1]
    fusion._check_shapes(kernel, iH=(iH, (L, M, M)),
                         grad_m=(grad_m, (L, M, 1)), m=(m, (L, M, 1)))
    plan = strip_plan(L, M, iH.element_size(), m.element_size(), kernel,
                      _sms(grad_H))
    iH, grad_H, grad_m, m = (t.contiguous() for t in (iH, grad_H, grad_m, m))
    iH_new = torch.empty_like(iH)
    rhs = torch.empty_like(grad_m)
    _launch(kernel, iH, iH.element_size(), m.element_size(), iH, grad_H,
            grad_m, m, iH_new, rhs, L, M, plan.rows, plan.smem, float(lr),
            float(jitter))
    return iH_new, rhs


def update_finish_plain(iLA, rhs, dtype: torch.dtype):
    """K8's plain version: (m_new, H_new) in ``dtype``."""
    H_new = torch.einsum("lkm,lkn->lmn", iLA, iLA)
    m_new = torch.einsum("lmn,lno->lmo", H_new, rhs)
    return m_new.to(dtype), H_new.to(dtype)


def update_finish(iLA, rhs, dtype: torch.dtype, out=None):
    """K8: (m_new = H_new rhs [L, M, 1], H_new = iLA^T iLA [L, M, M]) in
    ``dtype`` (the state's) from the inverse factor iLA of iH_new (lower
    triangular: the sum over k starts at max(i, j)) and rhs, in the chain's
    dtype.  The kernel sums each entry of the lower triangle once and
    writes it with its mirror, so H_new is exactly symmetric.  ``out`` =
    (m, H): written there and returned; on the card the kernel writes them
    in place (its only reads are iLA and rhs), so they must be contiguous
    in ``dtype``."""
    kernel = "natgrad_update_finish"
    if not _takes(kernel, iLA, rhs, other=dtype, mixed=MIXED_LATENTS):
        m_new, H_new = update_finish_plain(iLA, rhs, dtype)
        if out is None:
            return m_new, H_new
        out[0].copy_(m_new)
        out[1].copy_(H_new)
        return out
    L, M = iLA.shape[0], iLA.shape[1]
    fusion._check_shapes(kernel, rhs=(rhs, (L, M, 1)))
    plan = finish_plan(L, M, iLA.element_size(), _sms(iLA))
    iLA, rhs = iLA.contiguous(), rhs.contiguous()
    if out is None:
        out = (torch.empty((L, M, 1), dtype=dtype, device=iLA.device),
               torch.empty((L, M, M), dtype=dtype, device=iLA.device))
    elif not all(t.is_contiguous() and t.dtype == dtype
                 and t.device == iLA.device for t in out):
        raise ValueError(f"{kernel}: out = (m, H) must be contiguous "
                         f"{dtype} tensors on {iLA.device}")
    m_new, H_new = out
    fusion._check_shapes(kernel, m=(m_new, (L, M, 1)), H=(H_new, (L, M, M)))
    _launch(kernel, iLA, iLA.element_size(), H_new.element_size(), iLA, rhs,
            m_new, H_new, L, M, plan.cluster, plan.warps, plan.chunk,
            plan.smem)
    return m_new, H_new
