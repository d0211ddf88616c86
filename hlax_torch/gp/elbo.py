"""Sparse-GP bounds, padded-batched over subjects and latents (port of
``hlax/gp/elbo.py``): the KL-divergence bound of the training step and its
natural-gradient update, and the eval bounds ``deviance_upper_bound`` (DUBO)
and ``sample_elbo`` over the whitened factorization ``whitened_w_factor``.

Subjects are padded to a common T_max and every per-subject solve runs as
one batched factorization of shape [latent, S, T_max, T_max].  Padding
contributes exactly zero to every term: B blocks are identity on padded
rows/cols, and K matrices, mu and log_v are masked to zero there.

Factorizations go through ``hlax_torch.ops.linalg_small.chol_inv_blocked``
(the CUDA Cholesky kernels on the card, with their pivot floor) wherever
hlax takes its Pallas path (``use_pallas_chol``, hlax's defaults call by
call); with ``use_pallas_chol=False`` the bound and the natural-gradient
update take hlax's library path instead, ``library_chol_inv``.

hlax's precision split (``hlax/gp/elbo.py:31-43``): the VAE may run in TF32
(``hlax_torch.precision``), the GP never.  The bound's, the predictor's and
the natural-gradient update's entry points run under
``precision.highest``, as hlax wraps the same functions in
``_highest_precision``, and the train step's backward pass runs the GP's
gradients in full float32 too (``train.step.write_grads``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from hlax_torch.gp.kernels import KernelSpec
from hlax_torch.ops import gp_bound, natgrad
from hlax_torch.ops.fusion import gp_kernel_matrix
from hlax_torch.ops.linalg_small import chol_inv_blocked
from hlax_torch.precision import highest
from hlax_torch.profiling import region


def _gram(iL):
    """iL^T iL: the inverse of A from the inverse Cholesky factor of A."""
    return torch.einsum("lkm,lkn->lmn", iL, iL)


def library_chol_inv(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L^{-1}) of SPD [..., n, n] by the library, unguarded: hlax's
    ``use_pallas_chol=False`` path (``jnp.linalg.cholesky`` and
    ``solve_triangular``, ``hlax/gp/elbo.py:115-142``).  Where a matrix
    does not factorize (a pivot <= 0), hlax's Cholesky gives NaN on and
    below the diagonal and zeros above, not the partial factor LAPACK
    leaves, and its inverse factor is NaN throughout; so does this.  The
    failure flag stays on the device (no host sync, so a CUDA graph
    captures it) and selects the NaN factor.  Differentiable through
    PyTorch's own Cholesky and triangular-solve backward, as hlax's is
    through XLA's."""
    n = a.shape[-1]
    L, info = torch.linalg.cholesky_ex(a)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    failed = torch.full((n, n), math.nan, dtype=a.dtype,
                        device=a.device).tril()
    L = torch.where((info == 0)[..., None, None], L, failed)
    return L, torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _chol_inv(a: torch.Tensor, use_pallas_chol: bool):
    """(L, L^{-1}): the kernels (``chol_inv_blocked``) or the library."""
    return chol_inv_blocked(a) if use_pallas_chol else library_chol_inv(a)


class SubjectBlocks(NamedTuple):
    """Shared per-batch kernel quantities (padded subject-major)."""
    K0xz: torch.Tensor        # [L, S, T, M]   (masked)
    K0zz: torch.Tensor        # [L, M, M]      (+ eps I)
    LK0zz: torch.Tensor       # [L, M, M]
    iK0zz: torch.Tensor       # [L, M, M]
    K0_st: torch.Tensor       # [L, S, T, T]   (masked)
    LB: torch.Tensor          # [L, S, T, T]
    iB: torch.Tensor          # [L, S, T, T]
    iLB: torch.Tensor         # [L, S, T, T]   inverse Cholesky factor of B
    iLK: torch.Tensor         # [L, M, M]      inverse Cholesky factor of K0zz


@highest
def subject_blocks(spec0: KernelSpec, params0, spec1: KernelSpec, params1,
                   noise, z, x_st, valid, eps, extra_spd=None,
                   with_K0st: bool = True, use_pallas_chol: bool = False):
    """Build the kernel blocks shared by the bounds and the predictor.

    x_st [S, T, Q] padded covariates, valid [S, T] 0/1, z [L, M, Q],
    noise [L] GP observation noise.  ``extra_spd`` [L, M, M] (the bound's
    H) is factorized stacked with K0zz in one kernel launch; when given,
    returns ``(SubjectBlocks, (L_extra, iL_extra))``.  ``with_K0st=False``
    (the predictor) leaves K0_st empty.  ``use_pallas_chol`` (False by
    default, as hlax's): the kernels when True, else the library
    (``library_chol_inv``; iK0zz from the inverse factor in both, where
    hlax's library path solves against the identity: the same matrix to
    rounding).
    """
    L = z.shape[0]
    M = z.shape[1]
    T = x_st.shape[1]
    dt, dev = x_st.dtype, x_st.device

    vo = valid[:, :, None] * valid[:, None, :]          # [S, T, T]

    # the kernel matrices and their padding masks: one fused kernel each
    # on the card (``ops.fusion.gp_kernel_matrix``)
    K0xz = gp_kernel_matrix(spec0, params0, x_st, z, x2_batched=True,
                            row_mask=valid)                      # [L,S,T,M]
    K0zz = gp_kernel_matrix(spec0, params0, z, z, x1_batched=True,
                            x2_batched=True)
    K0zz = K0zz + eps * torch.eye(M, dtype=dt, device=dev)
    extra_fact = None
    if extra_spd is not None and use_pallas_chol:
        Ls, iLs = chol_inv_blocked(torch.cat([K0zz, extra_spd.to(dt)], dim=0))
        LK0zz, iLK = Ls[:L], iLs[:L]
        extra_fact = (Ls[L:], iLs[L:])
    else:
        LK0zz, iLK = _chol_inv(K0zz, use_pallas_chol)
        if extra_spd is not None:
            extra_fact = library_chol_inv(extra_spd.to(dt))
    iK0zz = _gram(iLK)

    K1_st = gp_kernel_matrix(spec1, params1, x_st, x_st, row_mask=valid,
                             col_mask=valid)
    eyeT = torch.eye(T, dtype=dt, device=dev)
    diag_fill = (noise[:, None, None, None] * valid[None, :, :, None]
                 + (1.0 - valid)[None, :, :, None])
    B_st = K1_st * vo[None] + eyeT * diag_fill
    LB, iLB = _chol_inv(B_st, use_pallas_chol)
    iB = torch.einsum("lskt,lsku->lstu", iLB, iLB)

    if with_K0st:
        K0_st = gp_kernel_matrix(spec0, params0, x_st, x_st,
                                 row_mask=valid, col_mask=valid)
    else:
        K0_st = torch.zeros((L, 0, 0, 0), dtype=dt, device=dev)
    blocks = SubjectBlocks(K0xz, K0zz, LK0zz, iK0zz, K0_st, LB, iB, iLB, iLK)
    return blocks if extra_spd is None else (blocks, extra_fact)


@highest
def kld_upper_bound(
    spec0: KernelSpec, params0, spec1: KernelSpec, params1,
    noise,                    # [L] GP noise
    m,                        # [L, M, 1] inducing mean
    H,                        # [L, M, M] inducing covariance (PSD)
    z,                        # [L, M, Q] inducing points
    x_st,                     # [S, T, Q] padded covariates
    valid,                    # [S, T]
    mu_st,                    # [S, T, L] encoder means (0 on padding)
    log_v_st,                 # [S, T, L] encoder log-variances
    P_tot,                    # total number of subjects in the dataset
    N_tot,                    # total number of rows in the dataset
    eps: float,
    natural_gradient: bool = False,
    nat_grad_dtype: Optional[torch.dtype] = None,
    sums=None,
    use_pallas_chol: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor],
           Optional[torch.Tensor]]:
    """Unbiased mini-batched KLD upper bound.

    Returns (kld_total, grad_m, grad_H, iH); the gradients are the
    closed-form natural-gradient quantities and iH the inverse of H for
    reuse by ``natural_gradient_update`` (all None unless
    ``natural_gradient``).  The natural-gradient chain runs in
    ``nat_grad_dtype`` (default: the input dtype), in hlax's whitened-Gram
    form (no explicit iK Kz iK product), outside the autograd graph: the
    loss does not read it.  In another dtype than the input's, K0zz and H
    are factorized again in that dtype, stacked in one ``chol_inv_blocked``
    (the float64 kernels on the card), and the returned quantities are in
    that dtype.  ``use_pallas_chol`` (False by default, as hlax's) chooses
    the kernels or the library for every factorization here, as
    ``subject_blocks``.

    On a mesh (``sums``, ``hlax_torch.parallel.mesh.MeshSums``) the inputs
    are this rank's: its subjects, and its latents of the GP (``mu_st``,
    ``log_v_st`` and the GP tensors sliced alike).  ``P_batch``, the sums
    A..F over subjects and latents, the per-latent KL of the inducing
    points and the natural-gradient accumulators ``ng_P1`` and ``C_w`` are
    then global; grad_m, grad_H and iH stay this rank's latents'.
    """
    Ldim = z.shape[0]

    blk, (LH, iLH) = subject_blocks(spec0, params0, spec1, params1, noise,
                                    z, x_st, valid, eps, extra_spd=H,
                                    use_pallas_chol=use_pallas_chol)
    iH = _gram(iLH)

    # the terms and their sum (one op: the kernels of ops.gp_bound on the
    # card); on a mesh the terms are summed over the ranks first
    terms, P_batch, kld_total = gp_bound.kld_terms(
        blk, LH, H, m, mu_st, log_v_st, valid,
        None if sums is not None else (P_tot, N_tot))
    if sums is not None:
        P_batch = sums.subjects(P_batch)
        terms = torch.cat([sums.blocks(terms[:6]), sums.latents(terms[6:])])
        kld_total = gp_bound.assemble(terms, P_batch, P_tot, N_tot, sums.L)

    if not natural_gradient:
        return kld_total, None, None, None
    with region("natural_gradient_quantities"), torch.no_grad():
        cdt = nat_grad_dtype or x_st.dtype
        # the chain's kernels on the card (ops.natgrad): K5 ng_P1, cuBLAS's
        # whitened Gram, K6 grad_m and grad_H
        ng_P1 = natgrad.fwd_subjects(blk.iB, mu_st, valid, blk.K0xz, cdt)
        if sums is not None:
            ng_P1 = sums.subjects(ng_P1)
        if cdt == blk.LK0zz.dtype:
            iLK_c, iK_c, iH_c = blk.iLK, blk.iK0zz, iH
        elif use_pallas_chol:
            iLs = chol_inv_blocked(torch.cat([blk.K0zz, H]).to(cdt))[1]
            iLK_c = iLs[:Ldim]
            iK_c, iH_c = _gram(iLK_c), _gram(iLs[Ldim:])
        else:
            iLK_c = library_chol_inv(blk.K0zz.to(cdt))[1]
            iK_c, iH_c = _gram(iLK_c), _gram(library_chol_inv(H.to(cdt))[1])
        # B_mat = iK KziBK iK + iK in whitened-Gram form:
        #   = iLK^T (I + C) iLK,  C = sum_st G^T G,  G = iLB K0xz iLK^T
        Gw = torch.einsum("lstu,lsun->lstn", blk.iLB.to(cdt),
                          torch.einsum("lstm,lnm->lstn", blk.K0xz.to(cdt),
                                       iLK_c))
        C_w = torch.einsum("lstm,lstn->lmn", Gw, Gw)          # PSD Gram sum
        if sums is not None:
            C_w = sums.subjects(C_w)
        grad_m, grad_H = natgrad.fwd_latents(iLK_c, C_w, iK_c, iH_c, ng_P1,
                                             m)
    return kld_total, grad_m, grad_H, iH_c


def whitened_w_factor(iLK, K0xz, iLB):
    """Stable factorization of W = K0zz + Kzx iB Kxz without factoring W.

    Whitening by the K0zz factor: W = LK (I + C) LK^T with
    C = sum_st G^T G, G = iLB K0xz iLK^T, an explicit Gram sum, so I + C is
    symmetric positive definite in floating point and its float32
    factorization is stable where W's is not (trained kernels make K0zz
    near-singular).  Args from ``subject_blocks``: iLK [L,M,M], K0xz
    [L,S,T,M] (masked), iLB [L,S,T,T].  Returns (iLK, LWi, iLWi):
    logdet W = logdet K0zz + 2 sum log diag LWi, and
    inv(W) = iLK^T iLWi^T iLWi iLK."""
    M = iLK.shape[-1]
    A = torch.einsum("lstm,lnm->lstn", K0xz, iLK)      # K0xz iLK^T
    G = torch.einsum("lstu,lsun->lstn", iLB, A)        # [L,S,T,M]
    C = torch.einsum("lstm,lstn->lmn", G, G)           # Gram sum: PSD
    Wi = C + torch.eye(M, dtype=C.dtype, device=C.device)
    LWi, iLWi = chol_inv_blocked(Wi)
    return iLK, LWi, iLWi


def _whitened_quadratic(blk, y_m):
    """Shared terms of the eval bounds for values y_m [L,S,T] (0 on padding):
    (logdet Sigma - logdet K0zz cancelled, y^T inv(Sigma) y, the trace term,
    iB K0xz, iLK, iLWi), with Sigma = B + Kxz iK0zz Kzx."""
    iB_K0xz = torch.einsum("lstu,lsum->lstm", blk.iB, blk.K0xz)
    KziBK = torch.einsum("lstm,lstn->lmn", blk.K0xz, iB_K0xz)
    iLK, LWi, iLWi = whitened_w_factor(blk.iLK, blk.K0xz, blk.iLB)
    # logdet Sigma = -logdet K0zz + logdet B + logdet W and
    # logdet W = logdet K0zz + logdet(I + C): the K0zz terms cancel
    logdet = (gp_bound.logdet_from_chol(blk.LB).sum(-1)
              + gp_bound.logdet_from_chol(LWi))
    iB_y = torch.einsum("lstu,lsu->lst", blk.iB, y_m)
    qf1 = torch.einsum("lst,lst->l", y_m, iB_y)
    p = torch.einsum("lstm,lst->lm", blk.K0xz, iB_y)
    sol = torch.einsum("lmn,ln->lm", iLWi,
                       torch.einsum("lmn,ln->lm", iLK, p))   # solve(LW, p)
    qf = qf1 - (sol ** 2).sum(-1)
    tr = ((blk.iB * blk.K0_st).sum(dim=(-1, -2, -3))
          - (KziBK * blk.iK0zz).sum(dim=(-1, -2)))
    return logdet, qf, tr, iB_K0xz, iLK, iLWi


@highest
def deviance_upper_bound(spec0: KernelSpec, params0, spec1: KernelSpec,
                         params1, noise, z, x_st, valid, mu_st, log_v_st,
                         eps: float) -> torch.Tensor:
    """Closed-form DUBO over a full set, padded-batched and summed over
    latent dimensions."""
    blk = subject_blocks(spec0, params0, spec1, params1, noise, z, x_st,
                         valid, eps, use_pallas_chol=True)
    v_mask = valid[:, :, None]
    mu_m = (mu_st * v_mask).permute(2, 0, 1)              # [L, S, T]
    v_m = (torch.exp(log_v_st) * v_mask).permute(2, 0, 1)
    N_valid = valid.sum()
    logDetSigma, qF, tr, iB_K0xz, iLK, iLWi = _whitened_quadratic(blk, mu_m)

    zero = torch.zeros((), dtype=log_v_st.dtype, device=log_v_st.device)
    logDetD = torch.where(valid[None] > 0, log_v_st.permute(2, 0, 1),
                          zero).sum(dim=(-1, -2))
    diag_iB = torch.diagonal(blk.iB, dim1=-2, dim2=-1)
    tr_iB_D = torch.einsum("lst,lst->l", diag_iB, v_m)
    G = iB_K0xz * torch.sqrt(v_m)[:, :, :, None]
    KziBDiBK = torch.einsum("lstm,lstn->lmn", G, G)
    # tr(iW K) with iW = iLW^T iLW and iLW = iLWi iLK
    Kw = torch.einsum("lmn,lno,lpo->lmp", iLK, KziBDiBK, iLK)
    tr_W = torch.einsum("lmn,lno,lmo->l", iLWi, Kw, iLWi)
    tr_iSigma_D = tr_iB_D - tr_W

    dubo = 0.5 * (tr_iSigma_D + qF - N_valid + logDetSigma - logDetD + tr)
    return dubo.sum()


@highest
def sample_elbo(spec0: KernelSpec, params0, spec1: KernelSpec, params1,
                noise, z, x_st, valid, y_st, eps: float) -> torch.Tensor:
    """Sample-based sparse-GP marginal-likelihood lower bound, batched over
    latent dims and padded subjects.  y_st [S, T, L]: a latent sample (0 on
    padding).  Returns the bound summed over latent dimensions."""
    blk = subject_blocks(spec0, params0, spec1, params1, noise, z, x_st,
                         valid, eps, use_pallas_chol=True)
    y_m = (y_st * valid[:, :, None]).permute(2, 0, 1)     # [L, S, T]
    N_valid = valid.sum()
    logDet, qF, tr, _, _, _ = _whitened_quadratic(blk, y_m)
    const = -0.5 * N_valid * math.log(2.0 * math.pi)
    el = const - 0.5 * (logDet + qF) - 0.5 * tr
    return el.sum()


@highest
def natural_gradient_update(m, H, grad_m, grad_H, lr: float, iH=None,
                            jitter: float = 0.0, use_pallas_chol: bool = True,
                            out=None):
    """Closed-form natural-gradient step on (m, H).

    Pass the ``iH`` returned by ``kld_upper_bound`` to skip refactorizing H.
    The arithmetic runs in the gradients' dtype (float64 after
    ``kld_upper_bound(..., nat_grad_dtype=torch.float64)``) and the result
    is cast back to the dtype of (m, H).  ``jitter``: relative diagonal
    ridge on iH_new before its factorization (scaled by the mean diagonal).
    ``use_pallas_chol`` (True by default, as hlax's): the kernels for the
    SPD inverses, else the library.  m and H share the state's dtype.  On
    the card the chain around iH_new's
    factorization is two kernels (``ops.natgrad``: K7 iH_new and the
    right-hand side, K8 H_new and m_new).  ``out`` = (m, H): the result is
    written there (by K8 itself on the card, where they must be contiguous
    in the state's dtype; the train step passes the state's own m and H)
    and returned.  Called under ``torch.no_grad()`` by
    the train step."""
    cdt = grad_H.dtype
    if iH is None:
        iH = _gram(_chol_inv(H.to(cdt), use_pallas_chol)[1])
    iH_new, rhs = natgrad.update_pre(iH, grad_H, grad_m, m, lr, jitter)
    iLA = _chol_inv(iH_new, use_pallas_chol)[1]
    return natgrad.update_finish(iLA, rhs, m.dtype, out)
