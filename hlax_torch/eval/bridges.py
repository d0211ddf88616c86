"""Health-MNIST converters and the Gaussian -> categorical density bridge
(port of ``hlax/eval/bridges.py``).

These let a real-likelihood (conv) model be scored against the 5-level
categorical encoding of the quantized Health-MNIST quadrants:

  * pixel <-> 5-level code converters;
  * ``gaussian_to_categorical_density``: bucket a Gaussian decoder head into
    the 5 levels by differences of its CDF and score the one-hot data.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def convert_cat5_to_pixels(x, idx):
    """5-level codes -> pixel values 0/50/100/150/200 in the columns ``idx``
    of a tensor (a new tensor; hlax's ``.at[].set`` branch).  Anything that
    is not a tensor is returned as it is, as hlax returns what has no
    ``.at``."""
    if not torch.is_tensor(x):
        return x
    out = x.clone()
    out[..., idx] = x[..., idx] * 50.0
    return out


def _codes(v):
    """[0, 1]-scaled pixels -> 5-level codes 0..4 (thresholds 50/255,
    100/255, 150/255, 200/255)."""
    return (torch.where(v >= 200 / 255, 4,
            torch.where(v >= 150 / 255, 3,
            torch.where(v >= 100 / 255, 2,
            torch.where(v >= 50 / 255, 1, 0)))))


def convert_pixels_to_cat5(x, idx):
    """[0, 1]-scaled pixels -> 5-level codes in the columns ``idx``."""
    out = x.clone()
    out[..., idx] = _codes(x[..., idx]).to(x.dtype)
    return out


def gaussian_to_categorical_density(est_mean, est_logvar, data01):
    """Log-density of 5-level codes under a bucketed Gaussian head.

    est_mean/est_logvar [B, D] (decoder real params, [0, 1] scale);
    data01 [B, D] pixels in [0, 1].  Returns log_p [B, D]."""
    one_hot = F.one_hot(_codes(data01), 5).to(est_mean.dtype)
    sd = torch.sqrt(torch.clamp(torch.exp(est_logvar), 0.0, 1e20))
    cdf = lambda v: torch.special.ndtr((v - est_mean) / sd)
    p0 = cdf(1 / 5)
    p1 = cdf(2 / 5) - p0
    p2 = cdf(3 / 5) - p0 - p1
    p3 = cdf(4 / 5) - p0 - p1 - p2
    p4 = 1.0 - p0 - p1 - p2 - p3
    pi = torch.clamp(torch.stack([p0, p1, p2, p3, p4], dim=-1),
                     math.exp(-10.0), 1e20)
    log_pi = torch.log_softmax(torch.clamp(torch.log(pi), -10.0, 1e20),
                               dim=-1)
    return torch.sum(one_hot * log_pi, dim=-1)
