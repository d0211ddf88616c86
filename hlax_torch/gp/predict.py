"""Sparse-GP posterior prediction of the latent trajectory (port of
``hlax/gp/predict.py``):

    mu_tilde = iB mu - iB K0xz iH K0zx iB mu,   H = K0zz + K0zx iB K0xz
    Z_pred   = K0Xz iK0zz K0zx mu_tilde + K1Xx mu_tilde

where the K1 (subject-level) term couples test rows only to prediction rows
of the same subject (every kernel1 component involves the id covariate).
The prediction rows come padded subject-major; each test row gathers its
subject's prediction rows through a host-built index map.  In full float32,
as hlax's (``precision.highest``).
"""

from __future__ import annotations

import numpy as np
import torch

from hlax_torch.gp.elbo import subject_blocks, whitened_w_factor
from hlax_torch.gp.kernels import KernelSpec, kernel_matrix
from hlax_torch.precision import highest


def build_test_pred_map(pred_subj_ids, test_subj_ids, pred_T_max=None):
    """Host-side: for each test subject, indices of its prediction rows.

    pred_subj_ids [Np], test_subj_ids: unique subject ids of the test set in
    block order.  Returns (idx [St, Tp2], valid [St, Tp2]) where padded slots
    point at row 0 with valid 0.
    """
    pred_subj_ids = np.asarray(pred_subj_ids)
    rows = [np.nonzero(pred_subj_ids == s)[0] for s in np.asarray(test_subj_ids)]
    tp2 = pred_T_max or max((len(r) for r in rows), default=1)
    tp2 = max(tp2, 1)
    idx = np.zeros((len(rows), tp2), dtype=np.int64)
    val = np.zeros((len(rows), tp2), dtype=np.float64)
    for i, r in enumerate(rows):
        idx[i, :len(r)] = r
        val[i, :len(r)] = 1.0
    return idx, val


@highest
def batch_predict(
    spec0: KernelSpec, params0, spec1: KernelSpec, params1,
    noise,                 # [L]
    z,                     # [L, M, Q] inducing points
    pred_x_st,             # [Sp, Tp, Q] padded prediction covariates
    pred_valid,            # [Sp, Tp]
    mu_st,                 # [Sp, Tp, L] encoder means at prediction rows
    test_x,                # [Nt, Q] test covariates (flat)
    test_pred_idx,         # [St, Tp2] -> flat pred-row indices (host-built)
    test_pred_valid,       # [St, Tp2]
    test_subj_of_row,      # [Nt] row of test_pred_idx for each test row
    eps: float,
) -> torch.Tensor:
    """Posterior mean Z_pred [Nt, L] at the test covariates."""
    Sp, Tp, Q = pred_x_st.shape
    Np = Sp * Tp
    dev = pred_x_st.device
    idx = torch.as_tensor(test_pred_idx, device=dev)
    of_row = torch.as_tensor(test_subj_of_row, device=dev)
    idx_valid = torch.as_tensor(test_pred_valid, dtype=pred_x_st.dtype,
                                device=dev)

    blk = subject_blocks(spec0, params0, spec1, params1, noise, z,
                         pred_x_st, pred_valid, eps, with_K0st=False,
                         use_pallas_chol=True)

    mu_m = (mu_st * pred_valid[:, :, None]).permute(2, 0, 1)       # [L,Sp,Tp]
    iB_mu = torch.einsum("lstu,lsu->lst", blk.iB, mu_m)
    t = torch.einsum("lstm,lst->lm", blk.K0xz, iB_mu)[:, :, None]  # [L,M,1]
    # inv(H) through the whitened factorization (float32-stable):
    # inv(H) = iLK^T iLWi^T iLWi iLK
    iLK, _, iLWi = whitened_w_factor(blk.iLK, blk.K0xz, blk.iLB)
    t1 = torch.einsum("lmn,lno->lmo", iLWi,
                      torch.einsum("lmn,lno->lmo", iLK, t))
    s = torch.einsum("lnm,lno->lmo", iLK,
                     torch.einsum("lnm,lno->lmo", iLWi, t1))       # [L,M,1]
    K0xz_iH = torch.einsum("lstm,lmo->lst", blk.K0xz, s)           # [L,Sp,Tp]
    u = torch.einsum("lstu,lsu->lst", blk.iB, K0xz_iH)
    mu_tilde = (iB_mu - u).reshape(iB_mu.shape[0], Np)             # [L,Np]

    # shared-structure term: K0Xz iK0zz K0zx mu_tilde
    K0Xz = kernel_matrix(spec0, params0, test_x, z, x2_batched=True)  # [L,Nt,M]
    K0zx_mt = torch.einsum("lstm,lst->lm", blk.K0xz,
                           mu_tilde.reshape(-1, Sp, Tp))[:, :, None]
    w = torch.cholesky_solve(K0zx_mt, blk.LK0zz)                   # [L,M,1]
    term0 = torch.einsum("lnm,lmo->ln", K0Xz, w)                   # [L,Nt]

    # subject-coupling term: each test row against its subject's pred rows
    sub_x = pred_x_st.reshape(Np, Q)[idx][of_row]                  # [Nt,Tp2,Q]
    sub_valid = idx_valid[of_row]
    K1 = kernel_matrix(spec1, params1, test_x[:, None, :], sub_x)  # [L,Nt,1,Tp2]
    K1 = K1[:, :, 0, :] * sub_valid[None]                          # [L,Nt,Tp2]
    mt_rows = mu_tilde[:, idx][:, of_row]                          # [L,Nt,Tp2]
    term1 = torch.einsum("lnt,lnt->ln", K1, mt_rows)
    return (term0 + term1).T                                       # [Nt, L]
