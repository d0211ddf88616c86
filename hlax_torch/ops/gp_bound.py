"""The KL bound's terms as hand-written CUDA kernels (``csrc/gp_bound.cu``).

hlax jits ``kld_upper_bound`` (``hlax/gp/elbo.py:154-235``) and XLA folds
its chains (masks, ``exp``, diagonals, ``log``, the per-subject [T, T]
work, the sums to scalars, the assembly of ``kld_total``) into a few
fusions around its dots; the port ran them op by op, some seventy kernels
forward and backward.  ``kld_terms`` takes them in four kernels and
leaves the large batched products to cuBLAS (``torch.bmm``, as hlax
leaves its dots to XLA): iK0zz m, KziBK = sum_st K0xz^T iB K0xz,
E_mat = (iK0zz H) iK0zz and their backward products.

  * ``gp_bound_fwd_subjects`` (K1): the fit, its residual r and (iB +
    iB^T) r, iB K0xz (for KziBK's product), and each subject's (or row
    tile's) partial sums of A, Bt, C, sum iB o K0_st and F.  A training
    batch's subjects (T <= TP) go through a ring of shared-memory stages,
    a grid sized to the card taking them from a queue; a longer subject
    is split into row tiles, one thread-block cluster.
  * ``gp_bound_fwd_latents`` (K2): a block a pair of mirrored tiles of a
    latent's [M, M] matrices at a time: sum KziBK o iK0zz, sum E_mat o
    KziBK, tr1, qf1, the log-determinants, u and K1's five sums; the last
    block adds the blocks' partials in a fixed order, in double, into the
    terms (A, Bt, C, D, E, F, the KL of the inducing points), P_batch and,
    without a mesh, ``kld_total``.
  * ``gp_bound_bwd_latents`` (K4) and ``gp_bound_bwd_subjects`` (K3): the
    backward from the scalar cotangents, into the cotangents of K0xz, the
    B blocks' factors (iLB, diag LB), K0_st, iK0zz, the factors of K0zz
    and H (their diagonals), H, m, mu and log_v, which feed the Cholesky
    kernels' and the GP kernel matrices' autograd Functions unchanged; K3
    on K1's ring, or a longer subject's pairs of 32 x 32 tiles; K4 on
    K2's pairs of tiles.

On a mesh the terms are summed over the ranks (``MeshSums``) before
``kld_total`` is formed (``assemble``), as ``recon_metric`` hands its
column sums to ``recon_metric_finish``.  The plain version is the port's
op-by-op code, which the CPU runs and the parity tests hold to hlax; on
CUDA in float32 and float64 the kernels run, in another dtype the plain
version, counted in ``PLAIN_CUDA_CALLS``.  A failed build or launch
raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from hlax_torch.ops import fusion
from hlax_torch.ops.counters import Counters
from hlax_torch.precision import highest

# must match NT, NSUB, NLAT, NTERM and MAX_M in csrc/gp_bound.cu: threads a
# block, a subject's (or row tile's) and a latent block's scalar partials,
# the terms, the inducing points the subject kernels' u columns take at
# most; TP, the rows of a subject the staged path takes at most; NSTAGE,
# the stages of the staged subject kernels' ring; MAX_TILES, the row tiles
# of a longer subject (one cluster)
THREADS, NSUB, NLAT, NTERM, MAX_M, TP = 256, 5, 6, 7, 512, 32
NSTAGE, MAX_TILES = 2, 8
# blocks an SM the staged subject kernels' launch bounds take
# (FWD_SUBJECT_BLOCKS, BWD_SUBJECT_BLOCKS): two each
SUBJECT_BLOCKS_PER_SM = 2
# must match LW and LATENT_BLOCKS: the latent kernels' square tiles
# (LATENT_TILE rows and columns) and their blocks an SM (launch bounds)
LATENT_TILE = 32
LATENT_BLOCKS_PER_SM = 2
SMEM_MAX = 227 * 1024
# an SM's shared memory and what each resident block takes of it beyond
# its dynamic bytes (1 KB the card reserves, the kernels' static arrays)
SMEM_SM, SMEM_BLOCK = 228 * 1024, 1536

_COUNTERS = Counters(("gp_bound_fwd_subjects_cuda",
                      "gp_bound_fwd_latents_cuda",
                      "gp_bound_bwd_latents_cuda",
                      "gp_bound_bwd_subjects_cuda"), ("gp_bound_plain",))
LAUNCHES = _COUNTERS.launches
LAUNCHES_BY_SHAPE = _COUNTERS.by_shape
PLAIN_CUDA_CALLS = _COUNTERS.plain
reset_counters = _COUNTERS.reset


class SubjectPlan(NamedTuple):
    """K1's and K3's grids.  ``staged`` (T <= TP): ``blocks_fwd`` and
    ``blocks_bwd`` blocks, block b starting with (latent, subject) pair b
    of n = L S and taking the next ones from the launch's queue through
    its ring, ``rows`` = T; else K1 a block a (row tile of ``rows`` rows,
    subject), ``tiles`` tiles a subject (a cluster), blocks_fwd =
    blocks_bwd = tiles L S (K3 a pair of 32 x 32 tiles or a row tile of
    32 a block).  ``parts``: K1's partial rows a latent (S tiles, in
    subject then tile order); K1's and K3's dynamic shared bytes."""
    staged: bool
    blocks_fwd: int
    blocks_bwd: int
    rows: int
    tiles: int
    parts: int
    smem_fwd: int
    smem_bwd: int


class LatentPlan(NamedTuple):
    """K2's and K4's grid: a latent's [M, M] matrices in ``tiles`` x
    ``tiles`` square tiles of LATENT_TILE, ``pairs`` pairs of tiles a
    latent (``latent_pairs``); ``blocks`` blocks, block b taking pairs b,
    b + blocks, ... of the L ``pairs``; their dynamic shared bytes (the
    tiles they stage)."""
    tiles: int
    pairs: int
    blocks: int
    smem_fwd: int
    smem_bwd: int


def _a16(b: int) -> int:
    return -(-b // 16) * 16


def fwd_stage(T: int, M: int, z: int) -> int:
    """One stage of K1's ring (FwdStage, csrc/gp_bound.cu): a subject's
    K0xz, iB, K0_st, iKm's row, its rows' mu, valid, log_v, LB diagonal."""
    return (_a16(T * M * z) + 2 * _a16(T * T * z) + _a16(M * z)
            + 4 * _a16(T * z))


def bwd_stage(T: int, M: int, z: int) -> int:
    """One stage of K3's ring (BwdStage): a subject's K0xz G, iB, iLB, K0_st,
    iKm's row, r, q and its rows' valid, log_v, LB diagonal."""
    return (_a16(T * M * z) + 3 * _a16(T * T * z) + _a16(M * z)
            + 5 * _a16(T * z))


def subject_smem(k: int, staged: bool, T: int, M: int, z: int,
                 rows: int = 0) -> int:
    """K1's (k = 1) or K3's (k = 3) dynamic shared bytes, as the kernels
    carve them (subject_smem, csrc/gp_bound.cu): staged, NSTAGE stages and
    the block's own (K1: r, q; K3: K0xz and K0xz G^T, a buffer each beside
    the ring, (K0xz G) K0xz^T and d iB + d iB^T, rows padded); else the
    row-tile kernels' (K1: the subject's r, q of its ``rows`` rows and a
    part of iB^T r a thread; K3: five 32 x 32 tiles, padded)."""
    if staged:
        if k == 1:
            return NSTAGE * fwd_stage(T, M, z) + 2 * _a16(T * z)
        return (NSTAGE * bwd_stage(T, M, z) + 2 * _a16(T * M * z)
                + 2 * _a16(T * (T + 1) * z))
    if k == 1:
        return _a16(T * z) + _a16(rows * z) + _a16(THREADS * z)
    return 5 * _a16(32 * 33 * z)


def ring_blocks(n: int, smem: int, sms: int) -> int:
    """A staged subject kernel's blocks: as many as the SMs hold at once
    (SUBJECT_BLOCKS_PER_SM, fewer where ``smem`` bytes a block leave room
    for fewer), at most one a subject."""
    fit = SMEM_SM // (smem + SMEM_BLOCK)
    return min(n, max(1, min(SUBJECT_BLOCKS_PER_SM, fit)) * sms)


def tile_rows(T: int) -> int:
    """A longer subject's row tile: multiples of 32 rows, at most
    MAX_TILES tiles."""
    return 32 * -(-T // (32 * MAX_TILES))


def subject_plan(L: int, S: int, T: int, M: int, itemsize: int,
                 sms: int) -> SubjectPlan:
    """The staged path for subjects of at most TP rows whose rings fit
    SMEM_MAX, its grids sized to the card (``ring_blocks``); else a subject
    in row tiles of ``tile_rows`` rows, cuBLAS taking the subjects'
    products."""
    z, n = itemsize, L * S
    f, b = subject_smem(1, True, T, M, z), subject_smem(3, True, T, M, z)
    if T <= TP and max(f, b) <= SMEM_MAX:
        return SubjectPlan(True, ring_blocks(n, f, sms),
                           ring_blocks(n, b, sms), T, 1, S, f, b)
    rows = tile_rows(T)
    if rows > THREADS:
        raise ValueError(f"gp_bound: T = {T} takes more than {MAX_TILES} "
                         f"tiles of {THREADS} rows")
    tiles = -(-T // rows)
    return SubjectPlan(False, tiles * n, tiles * n, rows, tiles, S * tiles,
                       subject_smem(1, False, T, M, z, rows),
                       subject_smem(3, False, T, M, z, rows))


def latent_smem(k: int, z: int) -> int:
    """K2's (k = 2) or K4's (k = 4) dynamic shared bytes (latent_smem,
    csrc/gp_bound.cu): two tiles of each input whose transposes it reads
    (K2 H's, K4 iK0zz's, E_mat's and H's), a tile LATENT_TILE rows of
    LATENT_TILE entries with a pad of 16 bytes after every 16 bytes of
    rows, LATENT_TILE (LATENT_TILE + 1) entries; two tiles' slots of each
    other input, LATENT_TILE ** 2 entries (K2 iK0zz's and E_mat's, and
    KziBK's in double; K4 KziBK's, R1's and R2's)."""
    tile, own = LATENT_TILE * (LATENT_TILE + 1) * z, LATENT_TILE ** 2 * z
    if k == 2:
        return 2 * tile + 4 * own + 2 * LATENT_TILE ** 2 * 8
    return 6 * tile + 6 * own


def latent_pairs(tiles: int) -> int:
    """A latent's pairs of tiles (latent_pairs, csrc/gp_bound.cu): its
    mirrored pairs (I, J), (J, I), I < J, then its diagonal tiles two at a
    time (a last one alone where ``tiles`` is odd)."""
    return tiles * (tiles - 1) // 2 + (tiles + 1) // 2


def latent_plan(L: int, M: int, itemsize: int, sms: int) -> LatentPlan:
    """The pairs of tiles of L latents' [M, M] matrices, as many blocks as
    the SMs hold at once (LATENT_BLOCKS_PER_SM), at most one a pair."""
    tiles = -(-M // LATENT_TILE)
    pairs = latent_pairs(tiles)
    blocks = min(L * pairs, LATENT_BLOCKS_PER_SM * sms)
    return LatentPlan(tiles, pairs, blocks, latent_smem(2, itemsize),
                      latent_smem(4, itemsize))


def _launch(entry: str, like: torch.Tensor, *args) -> None:
    """``fusion.launch`` of a C entry of libgp_bound.so."""
    fusion.launch("gp_bound", _COUNTERS, entry, like, *args)


def p_batch(valid: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The batch's real subjects (a subject of all padding does not count)."""
    return (valid > 0).any(dim=1).to(dtype).sum()


def kld_terms_plain(blk, LH, H, m, mu_st, log_v_st, valid):
    """The terms (A, Bt, C, D, E, F, kld_qu_pu) [7] and P_batch of the
    bound (``hlax/gp/elbo.py:183-218``), op by op; ``blk`` the
    ``SubjectBlocks``, LH the factor of H.  Differentiable through iB."""
    Ldim, M = H.shape[0], H.shape[1]
    P_batch = p_batch(valid, blk.K0xz.dtype)

    v_mask = valid[:, :, None]
    mu_m = mu_st * v_mask                                # [S, T, L]
    v_m = torch.exp(log_v_st) * v_mask

    # A: quadratic fit of K0xz iK0zz m - mu under iB
    iKm = torch.einsum("lmn,lno->lmo", blk.iK0zz, m)     # [L, M, 1]
    fit = torch.einsum("lstm,lmo->lst", blk.K0xz, iKm)   # [L, S, T]
    r = fit - mu_m.permute(2, 0, 1)                      # [L, S, T]
    A = torch.einsum("lst,lstu,lsu->", r, blk.iB, r)

    diag_iB = torch.diagonal(blk.iB, dim1=-2, dim2=-1)   # [L, S, T]
    Bt = torch.einsum("lst,stl->", diag_iB, v_m)
    C = torch.log(torch.diagonal(blk.LB, dim1=-2, dim2=-1)).sum() * 2.0

    iB_K0xz = torch.einsum("lstu,lsum->lstm", blk.iB, blk.K0xz)
    KziBK = torch.einsum("lstm,lstn->lmn", blk.K0xz, iB_K0xz)   # [L, M, M]
    D = (blk.iB * blk.K0_st).sum() - (KziBK * blk.iK0zz).sum()

    E_mat = torch.einsum("lmn,lno,lop->lmp", blk.iK0zz, H, blk.iK0zz)
    E = (E_mat * KziBK).sum()
    F = (log_v_st * v_mask).sum()

    # KL(q(u) || p(u))
    tr1 = (blk.iK0zz * H.mT).sum()
    qf1 = (m * torch.einsum("lmn,lno->lmo", blk.iK0zz, m)).sum()
    logdetK = logdet_from_chol(blk.LK0zz).sum()
    logdetH = logdet_from_chol(LH).sum()
    kld_qu_pu = 0.5 * (tr1 + qf1 - Ldim * M + logdetK - logdetH)
    return torch.stack([A, Bt, C, D, E, F, kld_qu_pu]), P_batch


def logdet_from_chol(L):
    """logdet A from the Cholesky factor L of A [..., n, n]."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def assemble(terms: torch.Tensor, P_batch, P_tot, N_tot, L_tot):
    """kld_total from the terms [7] and P_batch (global, on a mesh) of
    ``L_tot`` latents."""
    A, Bt, C, D, E, F, kld_qu_pu = terms.unbind()
    return (P_tot / P_batch * 0.5 * (A + Bt + C + D + E - F)
            + kld_qu_pu - L_tot * N_tot / 2.0)


# ------------------------------------------------------------ the kernels
#
# Each wrapper allocates its kernel's outputs and launches it on a CUDA
# tensor; on a CPU tensor it runs the kernel's plain version (the same
# function in torch operations, partial sums and all), which the CPU tests
# hold to autograd of ``kld_terms_plain`` and ``chip_smoke.py`` holds the
# kernel to on the card.

def _diag(x):
    return torch.diagonal(x, dim1=-2, dim2=-1)


def _on_card(t: torch.Tensor) -> bool:
    """Whether the kernel wrappers launch on ``t`` (else the kernels' plain
    versions run)."""
    return t.is_cuda


def fwd_subjects(K0xz, iB, K0st, LB, iKm, mu, lv, valid, sp: SubjectPlan):
    """K1: (W = iB K0xz, r, q = (iB + iB^T) r, the partials [L, S tiles,
    NSUB + M] of each subject's row tiles (staged: of each subject): A, Bt,
    sum log diag LB, sum iB o K0_st, F, then u = sum_t K0xz^T q; and for
    float inputs K0xz and W in double, else None, None)."""
    L, S, T, M = K0xz.shape
    W = torch.empty_like(K0xz)
    d = torch.float64
    K64, W64 = ((torch.empty(K0xz.shape, dtype=d, device=K0xz.device)
                 for _ in range(2)) if K0xz.dtype != d else (None, None))
    r = torch.empty((L, S, T), dtype=K0xz.dtype, device=K0xz.device)
    q = torch.empty_like(r)
    part = torch.empty((L, sp.parts, NSUB + M), dtype=d,
                       device=K0xz.device)
    if _on_card(K0xz):
        _launch("gp_bound_fwd_subjects", K0xz, K0xz.element_size(), K0xz,
                iB, K0st, LB, iKm, mu, lv, valid, W, K64, W64, r, q, part,
                fusion._counters(K0xz, 2), L, S, T, M, L, sp.blocks_fwd,
                sp.rows, int(sp.staged), sp.smem_fwd)
        if not sp.staged:      # longer subjects: the products by cuBLAS
            torch.matmul(iB, K0xz, out=W)
            if K64 is not None:
                K64.copy_(K0xz)
                torch.matmul(iB.to(d), K64, out=W64)
        return W, K64, W64, r, q, part
    vm = valid[:, :, None]
    r.copy_(torch.einsum("lstm,lm->lst", K0xz, iKm[..., 0])
            - (mu * vm).permute(2, 0, 1))
    row = torch.einsum("lstu,lsu->lst", iB, r)
    q.copy_(row + torch.einsum("lsut,lsu->lst", iB, r))
    W.copy_(iB.to(d) @ K0xz.to(d))
    if K64 is not None:
        K64.copy_(K0xz)
        W64.copy_(iB.to(d) @ K0xz.to(d))
    per = torch.stack([
        r.to(d) * row.to(d),
        (_diag(iB) * (torch.exp(lv) * vm).permute(2, 0, 1)).to(d),
        torch.log(_diag(LB)).to(d),
        (iB * K0st).to(d).sum(-1),
        (lv * vm).permute(2, 0, 1).to(d)], dim=-1)          # [L, S, T, NSUB]
    per = torch.cat([per, K0xz.to(d) * q.to(d)[..., None]], dim=-1)
    per = torch.nn.functional.pad(per, (0, 0, 0, sp.tiles * sp.rows - T))
    part.copy_(per.view(L, S, sp.tiles, sp.rows, NSUB + M).sum(3)
               .view(L, sp.parts, NSUB + M))
    return W, K64, W64, r, q, part


def _terms(sums1, sums2, L: int, M: int):
    """(A, Bt, C, D, E, F, kqu) in double from the subject blocks' five sums
    and the latent blocks' six."""
    A, Bt, C2, D1, F = sums1.unbind()
    D2, E, tr1, qf1, lk, lh = sums2.unbind()
    kqu = 0.5 * (tr1 + qf1 - float(L * M) + 2.0 * lk - 2.0 * lh)
    return torch.stack([A, Bt, 2.0 * C2, D1 - D2, E, F, kqu])


def fwd_latents(iK, Kz64, Em, H, m, iKm, LK, LH, valid, part1,
                sp: SubjectPlan, lp: LatentPlan, totals):
    """K2, from KziBK in double (``Kz64``): (u [L, M] in double, the terms
    [7], P_batch, kld_total or None)."""
    L, M = iK.shape[0], iK.shape[1]
    S, T = valid.shape
    dt, dev = iK.dtype, iK.device
    u = torch.empty((L, M), dtype=torch.float64, device=dev)
    terms = torch.empty(NTERM, dtype=dt, device=dev)
    pb = torch.empty((), dtype=dt, device=dev)
    kld = torch.empty((), dtype=dt, device=dev) if totals else None
    p_tot, n_tot = totals or (0.0, 0.0)
    if _on_card(iK):
        # the blocks' sums, a column a scalar: K1's five, the latents' six,
        # the subjects with a valid row
        part2, = fusion._scratch(torch.empty(
            (NSUB + NLAT + 1) * lp.blocks, dtype=torch.float64, device=dev))
        _launch("gp_bound_fwd_latents", iK, iK.element_size(), iK, Kz64,
                Em, H, m, iKm, LK, LH, valid, part1, sp.parts, part2, u, terms,
                pb, kld, fusion._counters(iK, 1), L, S, T, M, lp.blocks,
                float(p_tot), float(n_tot), lp.smem_fwd)
        return u, terms, pb, kld
    d = torch.float64
    u.copy_(part1[..., NSUB:].sum(1))
    sums2 = torch.stack([(Kz64 * iK).sum(), (Em * Kz64).sum(),
                         (iK * H.mT).to(d).sum(), (m * iKm).to(d).sum(),
                         torch.log(_diag(LK)).to(d).sum(),
                         torch.log(_diag(LH)).to(d).sum()])
    t = _terms(part1[..., :NSUB].sum((0, 1)), sums2, L, M)
    P = p_batch(valid, d)
    terms.copy_(t)
    pb.copy_(P)
    if kld is not None:
        A, Bt, C, D, E, F, kqu = t.unbind()
        kld.copy_(p_tot / P * 0.5 * (A + Bt + C + D + E - F) + kqu
                  - L * n_tot / 2.0)
    return u, terms, pb, kld


def term_weights(g_terms, g_kld, pb, p_tot: float) -> torch.Tensor:
    """The cotangents [7] (double) of the terms, from the Function's: the
    terms' own (None: zero) and kld_total's (None: zero)."""
    d = torch.float64
    half = p_tot / pb.to(d) * 0.5
    w = torch.zeros(NTERM, dtype=d, device=pb.device)
    if g_terms is not None:
        w = w + g_terms.to(d)
    if g_kld is not None:
        coef = torch.stack([half] * 5 + [-half, torch.ones_like(half)])
        w = w + g_kld.to(d) * coef
    return w


def bwd_latents(g_terms, g_kld, pb, p_tot, iK, Kz, Em, H, m, iKm, u, LK,
                LH, R1, R2, R3, lp: LatentPlan, need_h: bool, need_m: bool,
                need_l: bool):
    """K4: (G2 = [G | G^T] with G = d KziBK, d iK0zz, d H, d m, d LK0zz,
    d LH), the last four None where not needed (``need_h``: H and R3 =
    iK^T KziBK iK^T; ``need_l``: the factors)."""
    L, M = iK.shape[0], iK.shape[1]
    G2 = torch.empty((L, M, 2 * M), dtype=iK.dtype, device=iK.device)
    dIK = torch.empty_like(iK)
    dH = torch.empty_like(H) if need_h else None
    dm = torch.empty_like(m) if need_m else None
    dLK = torch.empty_like(LK) if need_l else None
    dLH = torch.empty_like(LH) if need_l else None
    if _on_card(iK):
        # d m's parts: each column's sums over a row tile
        dmpart = fusion._scratch(torch.empty(
            (L, lp.tiles, M), dtype=torch.float64,
            device=iK.device))[0] if need_m else None
        _launch("gp_bound_bwd_latents", iK, iK.element_size(), g_terms, g_kld,
                pb, float(p_tot), iK, Kz, Em, H, m, iKm, u, LK, LH, R1, R2,
                R3, G2, dIK, dH, dm, dLK, dLH, dmpart,
                fusion._counters(iK, 1) if need_m else None, L, M, lp.blocks,
                lp.smem_bwd)
        return G2, dIK, dH, dm, dLK, dLH
    w = term_weights(g_terms, g_kld, pb, p_tot)
    a, wd, we, k = w[0], w[3], w[4], w[6]
    d = torch.float64
    v = a * u + 0.5 * k * m[..., 0].to(d)                          # [L, M]
    G = -wd * iK.to(d) + we * Em.to(d)
    G2.copy_(torch.cat([G, G.mT], dim=-1))
    dIK.copy_(-wd * Kz.to(d) + 0.5 * k * H.mT.to(d)
              + v[:, :, None] * m[:, None, :, 0].to(d)
              + we * (R1.to(d) + R2.to(d)))
    if need_h:
        dH.copy_(0.5 * k * iK.mT.to(d) + we * R3.to(d))
    if need_m:
        dm.copy_((torch.einsum("lmn,lm->ln", iK.to(d), v)
                  + 0.5 * k * iKm[..., 0].to(d))[..., None])
    if need_l:
        dLK.copy_(torch.diag_embed(k / _diag(LK).to(d)))
        dLH.copy_(torch.diag_embed(-k / _diag(LH).to(d)))
    return G2, dIK, dH, dm, dLK, dLH


def bwd_subjects(g_terms, g_kld, pb, p_tot, K0xz, iB, iLB, K0st, LB, lv,
                 valid, r, q, iKm, Y2, sp: SubjectPlan):
    """K3: (d K0xz, d iLB, d K0_st, d LB, d mu, d log_v) from Y2 = K0xz
    [G | G^T] [L, S T, 2 M].  Longer subjects: cuBLAS's products around the
    kernel, P = (K0xz G) K0xz^T in d iLB's buffer before it, iLB (d iB +
    d iB^T) from the kernel's ``sym`` after."""
    L, S, T, M = K0xz.shape
    dK0xz = torch.empty_like(K0xz)
    diLB, dK0st, dLB = (torch.empty_like(iB) for _ in range(3))
    dmu = torch.empty((S, T, L), dtype=K0xz.dtype, device=K0xz.device)
    dlv = torch.empty_like(dmu)
    if _on_card(K0xz):
        sym = None
        if not sp.staged:      # longer subjects: the products by cuBLAS
            sym = torch.empty_like(iB)
            b = lambda t, n: t.reshape(L * S, T, n)
            Y2s = b(Y2, 2 * M)
            torch.bmm(b(iB, T), Y2s[..., M:], out=b(dK0xz, M))
            b(dK0xz, M).baddbmm_(b(iB, T).mT, Y2s[..., :M])
            torch.bmm(Y2s[..., :M], b(K0xz, M).mT, out=b(diLB, T))
        _launch("gp_bound_bwd_subjects", K0xz, K0xz.element_size(), g_terms,
                g_kld, pb, float(p_tot), K0xz, iB, iLB, K0st, LB, lv, valid,
                r, q, iKm, Y2, sym, dK0xz, diLB, dK0st, dLB, dmu, dlv,
                fusion._counters(K0xz, 2), L, S, T, M, L, sp.blocks_bwd,
                sp.rows, int(sp.staged), sp.smem_bwd)
        if not sp.staged:
            torch.bmm(b(iLB, T), b(sym, T), out=b(diLB, T))
        return dK0xz, diLB, dK0st, dLB, dmu, dlv
    w = term_weights(g_terms, g_kld, pb, p_tot).to(K0xz.dtype)
    a, b, c, wd, f = w[0], w[1], w[2], w[3], w[5]
    Y = Y2[..., :M].reshape(L, S, T, M)
    Yt = Y2[..., M:].reshape(L, S, T, M)
    dK0xz.copy_(a * q[..., None] * iKm[:, None, None, :, 0] + iB @ Yt
                + iB.mT @ Y)
    vm = valid[:, :, None]
    v = (torch.exp(lv) * vm).permute(2, 0, 1)                     # [L, S, T]
    dIB = (a * r[..., :, None] * r[..., None, :] + b * torch.diag_embed(v)
           + wd * K0st + Y @ K0xz.mT)
    diLB.copy_(iLB @ (dIB + dIB.mT))
    dK0st.copy_(wd * iB)
    dLB.copy_(torch.diag_embed(2.0 * c / _diag(LB)))
    dmu.copy_((-a * q).permute(1, 2, 0) * vm)
    dlv.copy_(f * vm + b * _diag(iB).permute(1, 2, 0) * vm * torch.exp(lv))
    return dK0xz, diLB, dK0st, dLB, dmu, dlv


class _GpBound(torch.autograd.Function):
    """The kernels' terms, P_batch and (``totals``) kld_total; the
    backward from the cotangents of the terms and kld_total."""

    @staticmethod
    @highest
    def forward(ctx, K0xz, iLB, LB, K0st, iK, LK, LH, H, m, mu, lv, iB,
                valid, totals):
        ctx.set_materialize_grads(False)
        L, S, T, M = K0xz.shape
        sms = (fusion._sm_count(K0xz.device.index) if _on_card(K0xz)
               else fusion.GP_SMS)
        sp = subject_plan(L, S, T, M, K0xz.element_size(), sms)
        lp = latent_plan(L, M, K0xz.element_size(), sms)
        iKm = torch.bmm(iK, m)                                # [L, M, 1]
        W, K64, W64, r, q, part1 = fwd_subjects(K0xz, iB, K0st, LB, iKm,
                                                mu, lv, valid, sp)
        Kz = torch.bmm(K0xz.view(L, S * T, M).mT,
                       W.view(L, S * T, M))                   # KziBK
        # the terms' KziBK in double (float inputs: see fwd_subjects)
        Kz64 = Kz if K64 is None else torch.bmm(
            K64.view(L, S * T, M).mT, W64.view(L, S * T, M))
        # E_mat in the plain version's order, (iK0zz H) iK0zz
        Em = torch.bmm(torch.bmm(iK, H), iK)
        u, terms, pb, kld = fwd_latents(iK, Kz64, Em, H, m, iKm, LK, LH,
                                        valid, part1, sp, lp, totals)
        ctx.p_tot = float(totals[0]) if totals else 0.0
        ctx.plans = (sp, lp)
        ctx.mark_non_differentiable(pb)
        ctx.save_for_backward(K0xz, iB, iLB, K0st, LB, iK, LK, LH, H, m,
                              lv, valid, iKm, Kz, Em, r, q, u, pb)
        return terms, pb, kld

    @staticmethod
    @highest
    def backward(ctx, g_terms, g_pb, g_kld):
        (K0xz, iB, iLB, K0st, LB, iK, LK, LH, H, m, lv, valid, iKm, Kz, Em,
         r, q, u, pb) = ctx.saved_tensors
        need = ctx.needs_input_grad
        if g_terms is None and g_kld is None:
            return (None,) * 14
        L, S, T, M = K0xz.shape
        sp, lp = ctx.plans
        if g_terms is not None:
            g_terms = g_terms.contiguous()
        # E_mat's backward products: iK^T KziBK, KziBK (H iK)^T,
        # H^T iK^T KziBK and (for H) iK^T KziBK iK^T
        T1 = torch.bmm(iK.mT, Kz)
        R1 = torch.bmm(Kz, torch.bmm(H, iK).mT)
        R2 = torch.bmm(H.mT, T1)
        R3 = torch.bmm(T1, iK.mT) if need[7] else None
        G2, dIK, dH, dm, dLK, dLH = bwd_latents(
            g_terms, g_kld, pb, ctx.p_tot, iK, Kz, Em, H, m, iKm, u, LK, LH,
            R1, R2, R3, lp, need[7], need[8], need[5] or need[6])
        # K0xz [G | G^T]: d KziBK's product for d K0xz and d iB
        Y2 = torch.bmm(K0xz.view(L, S * T, M), G2)
        dK0xz, diLB, dK0st, dLB, dmu, dlv = bwd_subjects(
            g_terms, g_kld, pb, ctx.p_tot, K0xz, iB, iLB, K0st, LB, lv,
            valid, r, q, iKm, Y2, sp)
        grads = (dK0xz, diLB, dLB, dK0st, dIK, dLK, dLH, dH, dm, dmu, dlv)
        return tuple(g if n else None for g, n in zip(grads, need)) + (
            None, None, None)


def kld_terms(blk, LH, H, m, mu_st, log_v_st, valid,
              totals: Optional[Tuple[float, float]] = None):
    """The bound's terms (A, Bt, C, D, E, F, kld_qu_pu) [7], P_batch and,
    with ``totals`` = (P_tot, N_tot), kld_total (else None: a mesh sums the
    terms first and then calls ``assemble``).  ``blk``: the
    ``SubjectBlocks``; LH: the factor of H [L, M, M]; m [L, M, 1]; mu_st,
    log_v_st [S, T, L]; valid [S, T].  The kernels on CUDA in float32 and
    float64, else the plain version (``kld_terms_plain``)."""
    args = (blk.K0xz, blk.iLB, blk.LB, blk.K0_st, blk.iK0zz, blk.LK0zz, LH,
            H, m, mu_st, log_v_st)
    if not fusion._uses_kernel(True, blk.K0xz, "gp_bound_plain", *args,
                               blk.iB, valid, plain=PLAIN_CUDA_CALLS):
        terms, P_batch = kld_terms_plain(blk, LH, H, m, mu_st, log_v_st,
                                         valid)
        kld = assemble(terms, P_batch, *totals, H.shape[0]) if totals \
            else None
        return terms, P_batch, kld
    args = tuple(a.contiguous() for a in args)
    return _GpBound.apply(*args, blk.iB.detach().contiguous(),
                          valid.contiguous(), totals)
