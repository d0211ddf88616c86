"""Heterogeneous log-likelihood heads (port of ``hlax/ops/likelihoods.py``).

Math parity with the reference heads (HL_VAE/loglik.py:27-256):

  * real    Gaussian; variance from a softplus-floored shared parameter
            (``extra``) or the head's logvar columns; affine
            de-normalization by batch stats.
  * pos     log-normal on log1p(data), incl. the -log(1+x) Jacobian term.
  * cat     logits with class 0 pinned at the head, log-softmax.
  * ordinal cumulative-link: softplus-threshold cumsum minus softplus mean,
            sigmoid differences, renormalized.
  * count   Poisson with softplus rate.
  * beta    mean via the Normal CDF, global dispersion.

Every head returns a dict with keys ``log_p_x`` [B, d] (mask-weighted),
``log_p_x_missing`` [B, d] ((1-mask)-weighted) and ``params`` (per-type
point-estimate parameters for the metrics kit).  The ``sample_*``
companions draw one sample per cell from the head's ``params``, from an
explicit ``torch.Generator`` (hlax's take a PRNG key; the two give different
draws of the same distributions).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MIN_LOG_VY = -8.0
_LOG_2PI = math.log(2.0 * math.pi)


def _softplus(x):
    # log(1 + e^x) without torch's linear cut-over above x = 20, which would
    # differ from jax.nn.softplus by up to 2e-9
    return torch.logaddexp(x, torch.zeros_like(x))


def loglik_real(data, mask, theta, norm_mean, norm_var, extra_log_vy, conv):
    """data [B,d] (already /255 in conv mode), theta [B,d] or [B,2d].

    norm_mean/norm_var: per-column batch stats (None in conv mode -> 0/1).
    extra_log_vy: shared per-column raw log-variance [d] or None
    (None -> variance from theta's second half; logvar_network mode).
    """
    d = data.shape[1]
    if norm_mean is None:
        data_mean = torch.zeros((d,), dtype=data.dtype, device=data.device)
        data_var = torch.ones((d,), dtype=data.dtype, device=data.device)
    else:
        data_mean = norm_mean
        data_var = norm_var.clamp(min=3e-4)   # epsilon=3e-4, loglik.py:30

    if extra_log_vy is None:
        est_mean, est_raw = theta[:, :d], theta[:, d:]
    else:
        est_mean, est_raw = theta[:, :d], extra_log_vy.reshape(1, d)
    est_log_vy = MIN_LOG_VY + _softplus(est_raw - MIN_LOG_VY)
    est_var = torch.exp(est_log_vy)

    est_mean = torch.sqrt(data_var) * est_mean + data_mean
    est_var = data_var * est_var

    log_p = (-0.5 * (data - est_mean) ** 2 / est_var
             - 0.5 * _LOG_2PI - 0.5 * torch.log(est_var))
    return {
        "log_p_x": log_p * mask,
        "log_p_x_missing": log_p * (1.0 - mask),
        "params": (est_mean, est_var.expand_as(est_mean)),
    }


def loglik_pos(data, mask, theta, norm_mean_log, norm_var_log, extra_log_vy):
    d = data.shape[1]
    log_data_var = norm_var_log.clamp(min=1e-3)   # epsilon=1e-3
    log_data = torch.log1p(data)

    est_mean = theta[:, :d]
    if extra_log_vy is None:   # logvar_network: variance from the head
        est_var = log_data_var * torch.exp(theta[:, d:])
    else:                       # shared parameter, NO softplus floor
        est_var = log_data_var * torch.exp(extra_log_vy.reshape(1, d))

    est_mean = torch.sqrt(log_data_var) * est_mean + norm_mean_log

    log_p = (-0.5 * (log_data - est_mean) ** 2 / est_var
             - 0.5 * torch.log(2.0 * math.pi * est_var) - log_data)
    return {
        "log_p_x": log_p * mask,
        "log_p_x_missing": log_p * (1.0 - mask),
        "params": (est_mean, est_var.expand_as(est_mean)),
    }


def loglik_cat(data, mask, theta, nclass):
    """data [B, d*c] one-hot, theta [B, d*c] logits (class 0 pinned to 0)."""
    b = data.shape[0]
    logits = theta.reshape(b, -1, nclass)
    log_pi = F.log_softmax(logits, dim=2)
    log_p = torch.sum(data.reshape(b, -1, nclass) * log_pi, dim=-1)
    return {
        "log_p_x": log_p * mask,
        "log_p_x_missing": log_p * (1.0 - mask),
        "params": log_pi,   # [B, d, c]
    }


def ordinal_probs(theta, nclass):
    """theta [B, d*c] -> class probabilities [B, d, c] (loglik.py:160-178)."""
    b = theta.shape[0]
    th = theta.reshape(b, -1, nclass)
    partition, mean_param = th[:, :, :-1], th[:, :, -1]
    mean_value = _softplus(mean_param)[:, :, None]
    theta_values = torch.cumsum(_softplus(partition).clamp(1e-6, 1e20), dim=2)
    sig = torch.sigmoid(theta_values - mean_value)
    ones = torch.ones(sig.shape[:-1] + (1,), dtype=sig.dtype, device=sig.device)
    zeros = torch.zeros_like(ones)
    probs = torch.cat([sig, ones], 2) - torch.cat([zeros, sig], 2)
    probs = probs.clamp(1e-6, 1.0)
    return probs / probs.sum(dim=2, keepdim=True)


def loglik_ordinal(data, mask, theta, nclass):
    """data [B, d*c] thermometer, theta [B, d*c] (c-1 thresholds + mean)."""
    b = data.shape[0]
    probs = ordinal_probs(theta, nclass)
    therm = data.reshape(b, -1, nclass)
    # thermometer -> class index: sum(therm) - 1; force 1 where unobserved
    vals = torch.sum(therm, dim=2).to(torch.int64)
    vals = torch.where(mask == 0, torch.ones_like(vals), vals)
    # one_hot(vals - 1): an out-of-range index gives an all-zero row, as in jax
    true_one_hot = ((vals - 1)[..., None]
                    == torch.arange(nclass, device=theta.device)).to(theta.dtype)
    log_p = torch.sum(true_one_hot * torch.log(probs), dim=-1)
    return {
        "log_p_x": log_p * mask,
        "log_p_x_missing": log_p * (1.0 - mask),
        "params": probs,   # [B, d, c]
    }


def loglik_count(data, mask, theta):
    lam = _softplus(theta).clamp(1e-6, 1e20)
    log_p = data * torch.log(lam) - lam - torch.lgamma(data + 1.0)
    return {
        "log_p_x": log_p * mask,
        "log_p_x_missing": log_p * (1.0 - mask),
        "params": lam,
    }


def loglik_beta(data, mask, theta, ranges, extra_disp):
    """data [B,d] in original scale, ranges [d,2] (min, max), extra_disp scalar."""
    data_min, data_max = ranges[:, 0], ranges[:, 1]
    x = (data - data_min) / (data_max - data_min) + 1e-6
    est_mean = torch.special.ndtr(theta)       # Normal(0,1) CDF
    disp = _softplus(extra_disp).clamp(1e-6, 1e20)
    alpha = disp * est_mean
    beta = disp * (1.0 - est_mean)
    log_p = ((alpha - 1.0) * torch.log(x) + (beta - 1.0) * torch.log(1.0 - x)
             - torch.lgamma(alpha) - torch.lgamma(beta)
             + torch.lgamma(alpha + beta))
    return {
        "log_p_x": log_p * mask,
        "log_p_x_missing": log_p * (1.0 - mask),
        "params": (alpha, beta),
    }


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def _randn(like, gen):
    return torch.randn(like.shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def _categorical(logits, gen):
    """Class codes [..] drawn from ``logits`` [.., c] by the Gumbel-max
    trick, as ``jax.random.categorical`` draws them."""
    u = torch.rand(logits.shape, generator=gen, dtype=logits.dtype,
                   device=logits.device)
    tiny = torch.finfo(logits.dtype).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def sample_real(params, gen):
    mean, var = params
    return mean + torch.sqrt(var) * _randn(mean, gen)


def sample_pos(params, gen):
    mean, var = params
    z = mean + torch.sqrt(var) * _randn(mean, gen)
    return (torch.exp(z) - 1.0).clamp(0.0, 1e20)


def sample_cat(params, gen):
    log_pi = params
    codes = _categorical(log_pi, gen)
    return F.one_hot(codes, log_pi.shape[-1]).to(log_pi.dtype)


def sample_ordinal(params, gen):
    probs = params
    nclass = probs.shape[-1]
    codes = 1 + _categorical(torch.log(probs.clamp(1e-6, 1e20)), gen)
    # thermometer encoding of the sampled level
    ar = torch.arange(1, nclass + 1, device=probs.device)
    return (ar <= codes[..., None]).to(probs.dtype)


def sample_count(params, gen):
    return torch.poisson(params, generator=gen)


def sample_beta(params, gen, ranges):
    alpha, beta = params
    # Beta(a, b) = Ga(a) / (Ga(a) + Ga(b))
    ga = torch._standard_gamma(alpha, generator=gen)
    gb = torch._standard_gamma(beta, generator=gen)
    s = ga / (ga + gb)
    return s * (ranges[:, 1] - ranges[:, 0]) + ranges[:, 0]
