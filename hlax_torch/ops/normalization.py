"""Masked per-type batch normalization (port of ``hlax/ops/normalization.py``).

Semantics follow the reference ``batch_normalization`` (HL_VAE/utils.py:88-143):

  * real:    conv mode -> data/255 (no stats); else masked z-score with batch
             mean/var computed over observed entries only.
  * pos:     masked z-score of log1p(data); stats (mean_log, var_log) kept for
             the decoder's affine de-normalization.
  * count:   log(data) on observed entries, 0 elsewhere.
  * cat/ordinal/beta: masked passthrough.

Division guards use a tiny epsilon on mask counts, as in hlax.

On a mesh (``sums``, ``hlax_torch.parallel.mesh.MeshSums``) the moments
are the global batch's: the counts and sums, then the squared deviations
about the global mean, summed over the data group.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hlax_torch.types import TypeLayout


class NormParams(NamedTuple):
    # per real column (None in conv mode)
    real_mean: Optional[torch.Tensor]
    real_var: Optional[torch.Tensor]
    # per pos column
    pos_mean_log: Optional[torch.Tensor]
    pos_var_log: Optional[torch.Tensor]


def batch_normalization(
    data: torch.Tensor,          # [B, n_exp] grouped
    mask: torch.Tensor,          # [B, n_raw] grouped
    layout: TypeLayout,
    conv: bool,
    sums=None,
) -> tuple[torch.Tensor, NormParams]:
    out_blocks = []

    def moments(x, m):
        """Masked mean and variance of x's columns over the batch."""
        cnt, tot = m.sum(dim=0), (x * m).sum(dim=0)
        if sums is not None:
            cnt, tot = sums.subjects(torch.stack([cnt, tot])).unbind()
        cnt = cnt.clamp(min=1e-12)
        mean = tot / cnt
        sq = (((x - mean) * m) ** 2).sum(dim=0)
        if sums is not None:
            sq = sums.subjects(sq)
        return mean, sq / cnt

    real_mean = real_var = pos_mean_log = pos_var_log = None

    for g in layout.groups:
        d = data[:, g.exp_slice[0]:g.exp_slice[1]]
        m = mask[:, g.raw_slice[0]:g.raw_slice[1]]
        if g.kind == "real":
            obs = d * m
            if conv:
                blk = obs / 255.0
            else:
                mean, var = moments(obs, m)
                blk = (obs - mean[None, :]) / torch.sqrt(var + 1e-5) * m
                real_mean, real_var = mean, var
        elif g.kind == "pos":
            obs = d * m
            obs_log = torch.log1p(obs)
            mean_log, var_log = moments(obs_log, m)
            var_log = var_log.clamp(1e-6, 1e20)
            blk = (obs_log - mean_log[None, :]) / torch.sqrt(var_log + 1e-5) * m
            pos_mean_log, pos_var_log = mean_log, var_log
        elif g.kind == "count":
            obs = d * m
            # log of observed counts; exact zeros where unobserved
            blk = torch.where(m > 0, torch.log(obs.clamp(min=1e-300)),
                              torch.zeros_like(obs))
        elif g.kind in ("cat", "ordinal"):
            m_exp = torch.repeat_interleave(m, g.exp_per_var, dim=1)
            blk = d * m_exp
        else:   # beta
            blk = d * m
        out_blocks.append(blk)

    normalized = torch.cat(out_blocks, dim=1)
    return normalized, NormParams(real_mean, real_var, pos_mean_log, pos_var_log)
