"""Metrics kit: reconstructions, errors, partial log-likelihoods (port of
``hlax/eval/metrics.py``).  All functions work in grouped column order
(``hlax_torch.types``); ``layout.raw_inv`` maps back to original variable
order.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from hlax_torch import device_constant
from hlax_torch.types import TypeLayout


def discrete_transform(data, layout: TypeLayout):
    """Expanded data -> raw-space values [B, n_raw]: cat -> argmax code,
    ordinal -> level (sum of thermometer - 1), others passthrough."""
    blocks = []
    for g in layout.groups:
        d = data[:, g.exp_slice[0]:g.exp_slice[1]]
        if g.kind == "cat":
            blocks.append(torch.argmax(
                d.reshape(d.shape[0], g.n_vars, g.nclass), dim=2).to(d.dtype))
        elif g.kind == "ordinal":
            blocks.append(
                d.reshape(d.shape[0], g.n_vars, g.nclass).sum(dim=2) - 1.0)
        else:
            blocks.append(d)
    return torch.cat(blocks, dim=1)


def statistics(params_list, layout: TypeLayout, conv: bool,
               beta_eq_mode_value: float = 0.5):
    """Per-type point estimates from likelihood params (the per-group
    ``params`` output of ``HLVAE.loglik``).  Returns (mean, mode), each
    [B, n_raw].  The beta mode at alpha == beta == 1 is a fixed value, as in
    hlax."""
    means, modes = [], []
    for g, p in zip(layout.groups, params_list):
        if g.kind == "real":
            est_mean, _ = p
            means.append(est_mean)
            modes.append(est_mean)
        elif g.kind == "pos":
            mu, var = p
            means.append(torch.exp(mu + 0.5 * var) - 1.0)
            modes.append(torch.exp(mu - var) - 1.0)
        elif g.kind == "count":
            means.append(p)
            modes.append(torch.floor(p))
        elif g.kind in ("cat", "ordinal"):
            am = torch.argmax(p, dim=2).to(p.dtype)
            means.append(am)
            modes.append(am)
        else:   # beta
            alpha, beta = p
            ranges = np.asarray(layout.beta_ranges)
            dmin = device_constant(ranges[:, 0], alpha.dtype, alpha.device)
            dmax = device_constant(ranges[:, 1], alpha.dtype, alpha.device)
            means.append(alpha / (alpha + beta) * (dmax - dmin) + dmin)
            one = torch.ones_like(alpha)
            mode = torch.where(
                (alpha > 1) & (beta > 1),
                (alpha - 1) / (alpha + beta - 2).clamp(min=1e-12),
                torch.where((alpha > 1) & (beta <= 1), one,
                            torch.where((alpha == 1) & (beta == 1),
                                        beta_eq_mode_value * one, 0.0 * one)))
            modes.append(mode * (dmax - dmin) + dmin)
    return torch.cat(means, dim=1), torch.cat(modes, dim=1)


def sampled_reconstruction(params_list, layout: TypeLayout,
                           gen: torch.Generator, conv: bool):
    """Raw-space sampled reconstruction [B, n_raw] from likelihood params:
    one draw per cell from the ``sample_*`` companions, reported like
    ``statistics`` (cat/ordinal as 0-based class codes, numeric types in data
    units)."""
    from hlax_torch.ops import likelihoods as lik

    blocks = []
    for g, p in zip(layout.groups, params_list):
        if g.kind == "real":
            blocks.append(lik.sample_real(p, gen))
        elif g.kind == "pos":
            blocks.append(lik.sample_pos(p, gen))
        elif g.kind == "count":
            blocks.append(lik.sample_count(p, gen))
        elif g.kind == "cat":
            blocks.append(torch.argmax(lik.sample_cat(p, gen), dim=2).to(
                p.dtype))
        elif g.kind == "ordinal":
            blocks.append(lik.sample_ordinal(p, gen).sum(dim=2) - 1.0)
        else:   # beta
            ranges = torch.as_tensor(np.asarray(layout.beta_ranges),
                                     dtype=p[0].dtype, device=p[0].device)
            blocks.append(lik.sample_beta(p, gen, ranges))
    return torch.cat(blocks, dim=1)


def get_norm_terms(x, true_mask, sums=None):
    """Observed range per column (of the global batch on a mesh)."""
    big = torch.where(true_mask > 0, x, -math.inf).amax(dim=0)
    small = torch.where(true_mask > 0, x, math.inf).amin(dim=0)
    if sums is not None:
        big, small = sums.subjects_max(torch.stack([big, -small])).unbind()
        small = -small
    return big - small


def error_computation(
    x_true, x_hat, layout: TypeLayout, mask,
    conv: bool, use_ranges: bool = False,
    true_mask=None, mean_imp_error: bool = False, dim: int = 0,
    sums=None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Dict[str, torch.Tensor]]]:
    """Per-variable normalized errors split observed/missing/all.  Inputs in
    grouped raw space [B, n_raw].  Returns (error_observed [n_raw],
    error_missing [n_raw], partial dict by type).  On a mesh (``sums``,
    rows along ``dim`` = 0) the ranges and averages are the global
    batch's."""
    if true_mask is None:
        true_mask = torch.ones_like(mask)
    err_blocks = []
    for g in layout.groups:
        sl = slice(g.raw_slice[0], g.raw_slice[1])
        xt, xh = x_true[:, sl], x_hat[:, sl]
        tm = true_mask[:, sl]
        if g.kind == "cat":
            err = (xt != xh).to(xt.dtype)
        elif g.kind == "ordinal":
            err = (xt - xh).abs() / g.nclass
        else:
            if g.kind == "beta":
                if conv:
                    norm = 255.0
                elif use_ranges:
                    r = np.asarray(layout.beta_ranges)
                    norm = torch.as_tensor(r[:, 1] - r[:, 0], dtype=xt.dtype,
                                           device=xt.device)
                else:
                    norm = 1.0
            else:
                if conv:
                    norm = 1.0
                    xt = xt / 255.0
                    if mean_imp_error or g.kind in ("pos", "count"):
                        xh = xh / 255.0
                else:
                    norm = get_norm_terms(xt, tm, sums)
                    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
            err = ((xh - xt) ** 2) / norm ** 2
        err_blocks.append(err)
    all_error = torch.cat(err_blocks, dim=1)

    known_missing = true_mask * (1.0 - mask)

    def _avg(w):
        s, tot = w.sum(dim=dim), (all_error * w).sum(dim=dim)
        if sums is not None:
            s, tot = sums.subjects(torch.stack([s, tot])).unbind()
        return tot / torch.where(s == 0, torch.ones_like(s), s)

    error_observed = _avg(mask)
    error_missing = _avg(known_missing)
    error_all = _avg(true_mask)

    # RMSE for non-discrete variables
    kinds = layout.var_kinds_grouped()
    sq = device_constant(~np.isin(kinds, ("cat", "ordinal")), torch.bool,
                         all_error.device)
    rt = lambda e: torch.where(sq, torch.sqrt(e), e)
    error_observed, error_missing, error_all = (
        rt(error_observed), rt(error_missing), rt(error_all))

    partial: Dict[str, Dict[str, list]] = {}
    for g in layout.groups:
        sl = slice(g.raw_slice[0], g.raw_slice[1])
        d = partial.setdefault(g.kind, {"error_missing": [],
                                        "error_observed": [], "error_all": []})
        d["error_missing"].append(error_missing[sl])
        d["error_observed"].append(error_observed[sl])
        d["error_all"].append(error_all[sl])
    out = {k: {kk: torch.cat(v) for kk, v in d.items()}
           for k, d in partial.items()}
    return error_observed, error_missing, out


def partial_loglikelihood(log_p_x, log_p_x_missing, layout: TypeLayout,
                          mask, true_mask=None, dim: int = 0
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-type observed/missing/all mean log-likelihoods per variable."""
    if true_mask is None:
        true_mask = torch.ones_like(mask)
    known_missing = true_mask * (1.0 - mask)
    ms = mask.sum(dim=dim)
    ms = torch.where(ms == 0, torch.ones_like(ms), ms)
    kms = known_missing.sum(dim=dim)
    kms = torch.where(kms == 0, torch.ones_like(kms), kms)
    ll_obs = (log_p_x * mask).sum(dim=dim) / ms
    ll_mis = (log_p_x_missing * known_missing).sum(dim=dim) / kms
    ll_all = (log_p_x + log_p_x_missing).mean(dim=dim)

    out: Dict[str, Dict[str, list]] = {}
    for g in layout.groups:
        sl = slice(g.raw_slice[0], g.raw_slice[1])
        d = out.setdefault(g.kind, {"LL_missing": [], "LL_observed": [],
                                    "LL_all": []})
        d["LL_missing"].append(ll_mis[sl])
        d["LL_observed"].append(ll_obs[sl])
        d["LL_all"].append(ll_all[sl])
    return {k: {kk: torch.cat(v) for kk, v in d.items()}
            for k, d in out.items()}


def mean_imputation(x_true, mask, layout: TypeLayout) -> np.ndarray:
    """Observed-mode (discrete) / observed-mean (numeric) imputation
    baseline.  Host-side numpy; grouped raw space."""
    x_true = np.asarray(x_true)
    mask = np.asarray(mask)
    out = x_true.copy()
    kinds = layout.var_kinds_grouped()
    for j in range(x_true.shape[1]):
        obs = x_true[mask[:, j] == 1, j]
        if kinds[j] in ("cat", "ordinal"):
            if obs.size:
                vals, counts = np.unique(obs, return_counts=True)
                fill = vals[np.argmax(counts)]
            else:
                fill = 0.0
        else:
            fill = obs.mean() if obs.size else 0.0
        out[:, j] = x_true[:, j] * mask[:, j] + fill * (1 - mask[:, j])
    return out
