"""Sparse-GP KL-divergence bound of the training step, padded-batched over
subjects and latents (port of ``hlax/gp/elbo.py``).

Subjects are padded to a common T_max and every per-subject solve runs as
one batched factorization of shape [latent, S, T_max, T_max].  Padding
contributes exactly zero to every term: B blocks are identity on padded
rows/cols, and K matrices, mu and log_v are masked to zero there.

All factorizations go through ``hlax_torch.ops.linalg_small.chol_inv_blocked``
(the CUDA Cholesky kernels on the card).  Float32 matmuls run in full
float32: ``hlax_torch`` turns TF32 off at import, as hlax runs its GP math
at "highest" precision.

The eval bounds (``whitened_w_factor``, ``deviance_upper_bound``,
``sample_elbo``) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from hlax_torch.gp.kernels import KernelSpec, kernel_matrix
from hlax_torch.ops.linalg_small import chol_inv_blocked


def _logdet_from_chol(L):
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def _gram(iL):
    """iL^T iL: the inverse of A from the inverse Cholesky factor of A."""
    return torch.einsum("lkm,lkn->lmn", iL, iL)


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


def subject_blocks(spec0: KernelSpec, params0, spec1: KernelSpec, params1,
                   noise, z, x_st, valid, eps, extra_spd=None):
    """Build the kernel blocks shared by the bounds.

    x_st [S, T, Q] padded covariates, valid [S, T] 0/1, z [L, M, Q],
    noise [L] GP observation noise.  ``extra_spd`` [L, M, M] (the bound's
    H) is factorized stacked with K0zz in one kernel launch; when given,
    returns ``(SubjectBlocks, (L_extra, iL_extra))``.
    """
    L = z.shape[0]
    M = z.shape[1]
    T = x_st.shape[1]
    dt, dev = x_st.dtype, x_st.device

    vo = valid[:, :, None] * valid[:, None, :]          # [S, T, T]

    K0xz = kernel_matrix(spec0, params0, x_st, z, x2_batched=True)  # [L,S,T,M]
    K0xz = K0xz * valid[None, :, :, None]
    K0zz = kernel_matrix(spec0, params0, z, z, x1_batched=True, x2_batched=True)
    K0zz = K0zz + eps * torch.eye(M, dtype=dt, device=dev)
    extra_fact = None
    if extra_spd is not None:
        Ls, iLs = chol_inv_blocked(torch.cat([K0zz, extra_spd.to(dt)], dim=0))
        LK0zz, iLK = Ls[:L], iLs[:L]
        extra_fact = (Ls[L:], iLs[L:])
    else:
        LK0zz, iLK = chol_inv_blocked(K0zz)
    iK0zz = _gram(iLK)

    K1_st = kernel_matrix(spec1, params1, x_st, x_st) * vo[None]
    eyeT = torch.eye(T, dtype=dt, device=dev)
    diag_fill = (noise[:, None, None, None] * valid[None, :, :, None]
                 + (1.0 - valid)[None, :, :, None])
    B_st = K1_st * vo[None] + eyeT * diag_fill
    LB, iLB = chol_inv_blocked(B_st)
    iB = torch.einsum("lskt,lsku->lstu", iLB, iLB)

    K0_st = kernel_matrix(spec0, params0, x_st, x_st) * vo[None]
    blocks = SubjectBlocks(K0xz, K0zz, LK0zz, iK0zz, K0_st, LB, iB, iLB, iLK)
    return blocks if extra_spd is None else (blocks, extra_fact)


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
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor],
           Optional[torch.Tensor]]:
    """Unbiased mini-batched KLD upper bound.

    Returns (kld_total, grad_m, grad_H, iH); the gradients are the
    closed-form natural-gradient quantities and iH the inverse of H for
    reuse by ``natural_gradient_update`` (all None unless
    ``natural_gradient``).  The natural-gradient chain runs in the input
    dtype, in hlax's whitened-Gram form (no explicit iK Kz iK product).
    """
    Ldim = z.shape[0]
    M = z.shape[1]

    blk, (LH, iLH) = subject_blocks(spec0, params0, spec1, params1, noise,
                                    z, x_st, valid, eps, extra_spd=H)
    iH = _gram(iLH)

    # number of real subjects in the batch (all-padding subjects don't count)
    P_batch = (valid > 0).any(dim=1).to(x_st.dtype).sum()

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
    logdetK = _logdet_from_chol(blk.LK0zz).sum()
    logdetH = _logdet_from_chol(LH).sum()
    kld_qu_pu = 0.5 * (tr1 + qf1 - Ldim * M + logdetK - logdetH)

    kld_total = (P_tot / P_batch * 0.5 * (A + Bt + C + D + E - F)
                 + kld_qu_pu - Ldim * N_tot / 2.0)

    if not natural_gradient:
        return kld_total, None, None, None
    iB_mu = torch.einsum("lstu,sul->lst", blk.iB, mu_m)
    ng_P1 = torch.einsum("lstm,lst->lm", blk.K0xz, iB_mu)[:, :, None]
    # B_mat = iK KziBK iK + iK in whitened-Gram form:
    #   = iLK^T (I + C) iLK,  C = sum_st G^T G,  G = iLB K0xz iLK^T
    Gw = torch.einsum("lstu,lsun->lstn", blk.iLB,
                      torch.einsum("lstm,lnm->lstn", blk.K0xz, blk.iLK))
    C_w = torch.einsum("lstm,lstn->lmn", Gw, Gw)              # PSD Gram sum
    IpC = C_w + torch.eye(C_w.shape[-1], dtype=C_w.dtype, device=C_w.device)
    B_mat = torch.einsum("lpm,lpq,lqn->lmn", blk.iLK, IpC, blk.iLK)
    B_mat = 0.5 * (B_mat + B_mat.mT)
    grad_m = -torch.einsum("lmn,lno->lmo", blk.iK0zz, ng_P1) \
        + torch.einsum("lmn,lno->lmo", B_mat, m)
    grad_H = 0.5 * (-iH + B_mat)
    return kld_total, grad_m, grad_H, iH


def natural_gradient_update(m, H, grad_m, grad_H, lr: float, iH=None,
                            jitter: float = 0.0):
    """Closed-form natural-gradient step on (m, H).

    Pass the ``iH`` returned by ``kld_upper_bound`` to skip refactorizing H.
    ``jitter``: relative diagonal ridge on iH_new before its factorization
    (scaled by the mean diagonal).  Called under ``torch.no_grad()`` by the
    train step."""
    if iH is None:
        iH = _gram(chol_inv_blocked(H)[1])
    iH_new = iH + lr * (grad_H + grad_H.mT)
    if jitter:
        mean_diag = torch.diagonal(iH_new, dim1=-2, dim2=-1).mean(
            -1)[:, None, None]
        iH_new = iH_new + jitter * mean_diag * torch.eye(
            H.shape[-1], dtype=H.dtype, device=H.device)
    H_new = _gram(chol_inv_blocked(iH_new)[1])
    m_new = torch.einsum(
        "lmn,lno->lmo", H_new,
        torch.einsum("lmn,lno->lmo", iH, m)
        - lr * (grad_m - 2.0 * torch.einsum("lmn,lno->lmo", grad_H, m)))
    return m_new, H_new
