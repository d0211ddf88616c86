"""Validation pass: full-set VAE metrics, the DUBO GP loss and a GP
extrapolation check (port of ``hlax/eval/validate.py``).  Same structure and
the same 10-row ``validation_results.csv``:

  1. full-set forward -> NLL and reconstruction errors;
  2. GP loss: the sum over groups of subjects with equal sequence length of
     the deviance upper bound (or, with ``type_KL='GPapprox'``, of the
     sampled bound) -- the reference's estimator, not one joint bound;
  3. extrapolation: condition on the training means and the first
     ``context_frames`` frames of each validation subject, predict z at
     every frame, decode, report the GP reconstruction error.

hlax's ``eval/jits.py`` (cached jitted model entry points) has no module
here: the model's ``encode``, ``forward`` and ``decode`` are called
directly, under ``torch.inference_mode()``.

Each equal-length group is padded to power-of-two (S, T) buckets, as in
hlax; padding contributes exactly zero.  On the card T = 20 becomes a 32 x 32
B block, which goes to the mid Cholesky kernel.  The GP math runs in the
checkpoint's dtype (float32) by default; ``eval_gp_f64=True`` runs it in
float64 (the float64 kernels on the card).  Sequences longer than 128 pad
to buckets of 256, 512, ..., whose B blocks go through hlax's blocked
composition (``chol_inv_blocked``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from hlax_torch import to_numpy
from hlax_torch.data.dataset import LongitudinalDataset
from hlax_torch.eval import metrics as mx
from hlax_torch.gp import elbo as gp_elbo
from hlax_torch.gp import kernels as gp_kernels
from hlax_torch.gp.predict import batch_predict, build_test_pred_map
from hlax_torch.models.hlvae import nll_from_log_p
from hlax_torch.ops.normalization import batch_normalization

VALIDATION_ROWS = ("vae_error", "GP_error", "vae_mse", "miss_vae_error",
                   "miss_GP_error", "net_loss", "GP_loss", "nll_loss",
                   "recon_loss_sum", "GP_recon_loss_sum")


def _model_device_dtype(model):
    p = next(model.parameters())
    return p.device, p.dtype


def device_het(ds: LongitudinalDataset, dtype, device):
    """(data, mask, theta_mask) of ``ds`` as tensors on ``device``, uploaded
    once per (dtype, device) and kept in ``ds.staged``: validation and the
    test battery rerun every few epochs on the same datasets."""
    key = (dtype, str(device))
    if key not in ds.staged:
        het = ds.het
        ds.staged[key] = tuple(torch.as_tensor(a, dtype=dtype, device=device)
                               for a in (het.data, het.mask, het.theta_mask))
    return ds.staged[key]


def write_rows_csv(path: str, rows: Dict[str, float],
                   header: bool = False) -> None:
    """``name,value`` lines: what pandas' ``to_csv`` writes for a one-column
    frame, with its ``,0`` header line when ``header``."""
    with open(path, "w") as f:
        if header:
            f.write(",0\n")
        for name, value in rows.items():
            f.write(f"{name},{float(value)!r}\n")


def encode_dataset(model, ds: LongitudinalDataset, chunk: int = 1000):
    """Full-dataset encoder pass in row chunks (normalization statistics per
    chunk).  Returns (mu [N, L], log_var [N, L]) as numpy."""
    dev, dt = _model_device_dtype(model)
    data_d, mask_d, _ = device_het(ds, dt, dev)
    mus, lvs = [], []
    with torch.inference_mode():
        for i in range(0, len(ds), chunk):
            mu, lv = model.encode(data_d[i:i + chunk], mask_d[i:i + chunk])
            mus.append(mu)
            lvs.append(lv)
        return to_numpy(torch.cat(mus)), to_numpy(torch.cat(lvs))


def forward_metrics(model, ds: LongitudinalDataset, eps=None, seed: int = 0):
    """Full-set forward (sampled z) -> nll sum, recon error sums, mu and
    log_var.  The reparameterization noise is ``eps`` [N, L] when given,
    else drawn from a generator seeded with ``seed``."""
    dev, dt = _model_device_dtype(model)
    data, mask, tmask = device_het(ds, dt, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode():
        if eps is not None:
            eps = torch.as_tensor(eps, dtype=dt, device=dev)
        out = model(data, mask, tmask, eps=eps, generator=gen)
        nll = nll_from_log_p(out["log_p_x"]).sum().item()
        mean_rec, _ = mx.statistics(out["params"], ds.layout, ds.conv)
        truth = mx.discrete_transform(data, ds.layout)
        rec_obs, rec_mis, _ = mx.error_computation(
            truth, mean_rec, ds.layout, mask, conv=ds.conv,
            use_ranges=ds.use_ranges)
        return {"nll": nll, "recon_loss": rec_obs.sum().item(),
                "miss_recon_loss": rec_mis.sum().item(),
                "mu": to_numpy(out["mu"]),
                "log_var": to_numpy(out["log_var"])}


def _bucket(n: int) -> int:
    """Next power of two >= n: each equal-length group pads to a bucket, as
    in hlax (the bounds mask the padding, so the values are unchanged)."""
    return 1 << max(0, int(n) - 1).bit_length()


def _gp_inputs(k0, k1, noise, zt, eps, eval_gp_f64: bool):
    """The GP state in the eval dtype: float64 with ``eval_gp_f64``, else
    zt's.  Returns (k0, k1, noise, zt, eps, dtype, device)."""
    dev = zt.device
    gdt = torch.float64 if eval_gp_f64 else zt.dtype
    cast = lambda ps: [{k: v.detach().to(gdt) for k, v in p.items()}
                       for p in ps]
    if eps is None:
        eps = gp_kernels.default_eps(gdt)
    return (cast(k0), cast(k1), noise.detach().to(gdt), zt.detach().to(gdt),
            eps, gdt, dev)


def _groups(ds: LongitudinalDataset):
    """(T, subject indices) of each group of equal sequence length."""
    lengths = ds.subject_end - ds.subject_start
    return [(int(T), np.nonzero(lengths == T)[0]) for T in np.unique(lengths)]


def _pack_group(ds, T, sel, *per_row):
    """Bucket-padded [Sb, Tb, .] covariates, valid mask and per-row arrays
    of the subjects ``sel`` (all of length T)."""
    Sb, Tb = _bucket(len(sel)), _bucket(T)
    x_st = np.zeros((Sb, Tb, ds.Q))
    valid = np.zeros((Sb, Tb))
    outs = [np.zeros((Sb, Tb, a.shape[1])) for a in per_row]
    for i, s in enumerate(sel):
        a, b = ds.subject_start[s], ds.subject_end[s]
        x_st[i, :T] = ds.labels[a:b]
        valid[i, :T] = 1.0
        for o, arr in zip(outs, per_row):
            o[i, :T] = arr[a:b]
    return x_st, valid, outs


def gp_loss_sampled(spec0, k0, spec1, k1, noise, zt, ds: LongitudinalDataset,
                    mu, log_var, num_samples: int = 1, eps=None, seed=0,
                    eval_gp_f64: bool = False):
    """type_KL='GPapprox' validation GP loss: the negative sampled sparse-GP
    bound, averaged over ``num_samples`` latent samples."""
    k0, k1, noise, zt, eps, gdt, dev = _gp_inputs(k0, k1, noise, zt, eps,
                                                  eval_gp_f64)
    mu, log_var = np.asarray(mu, np.float64), np.asarray(log_var, np.float64)
    gen = torch.Generator().manual_seed(seed)
    put = lambda a: torch.as_tensor(a, dtype=gdt, device=dev)
    total = 0.0
    with torch.inference_mode():
        for _ in range(num_samples):
            noise_s = torch.randn(mu.shape, generator=gen,
                                  dtype=torch.float64).numpy()
            z_sample = mu + noise_s * np.exp(0.5 * log_var)
            for T, sel in _groups(ds):
                x_st, valid, (y_st,) = _pack_group(ds, T, sel, z_sample)
                val = gp_elbo.sample_elbo(spec0, k0, spec1, k1, noise, zt,
                                          put(x_st), put(valid), put(y_st),
                                          eps)
                total += -val.item()
    return total / num_samples


def gp_loss_dubo(spec0, k0, spec1, k1, noise, zt, ds: LongitudinalDataset,
                 mu, log_var, eps=None, eval_gp_f64: bool = False):
    """Sum of the per-equal-length-group DUBOs."""
    k0, k1, noise, zt, eps, gdt, dev = _gp_inputs(k0, k1, noise, zt, eps,
                                                  eval_gp_f64)
    put = lambda a: torch.as_tensor(a, dtype=gdt, device=dev)
    total = 0.0
    with torch.inference_mode():
        for T, sel in _groups(ds):
            x_st, valid, (mu_st, lv_st) = _pack_group(
                ds, T, sel, np.asarray(mu), np.asarray(log_var))
            val = gp_elbo.deviance_upper_bound(
                spec0, k0, spec1, k1, noise, zt, put(x_st), put(valid),
                put(mu_st), put(lv_st), eps)
            total += val.item()
    return total


def gp_predict_dataset(spec0, k0, spec1, k1, noise, zt,
                       pred_x: np.ndarray, pred_mu: np.ndarray,
                       pred_subject_col: np.ndarray,
                       test_x: np.ndarray, test_subject_col: np.ndarray,
                       eps=None, eval_gp_f64: bool = False) -> np.ndarray:
    """Z prediction [Nt, L] at test covariates given the (pred_x, pred_mu)
    context: host-side packing of the per-subject padded structures, then
    one ``batch_predict``."""
    k0, k1, noise, zt, eps, gdt, dev = _gp_inputs(k0, k1, noise, zt, eps,
                                                  eval_gp_f64)
    L = zt.shape[0]
    # prediction rows subject-major (order of first appearance), padded to
    # power-of-two buckets
    _, first = np.unique(pred_subject_col, return_index=True)
    subj = pred_subject_col[np.sort(first)]
    rows = [np.nonzero(pred_subject_col == s)[0] for s in subj]
    Tp = _bucket(max(len(r) for r in rows))
    Sp = _bucket(len(subj))
    x_st = np.zeros((Sp, Tp, pred_x.shape[1]))
    mu_st = np.zeros((Sp, Tp, L))
    valid = np.zeros((Sp, Tp))
    for i, r in enumerate(rows):
        x_st[i, :len(r)] = pred_x[r]
        mu_st[i, :len(r)] = pred_mu[r]
        valid[i, :len(r)] = 1

    # map test rows to their subject's prediction rows; padded prediction
    # rows carry a NaN subject id, which matches no test subject
    _, t_first = np.unique(test_subject_col, return_index=True)
    test_subjects = test_subject_col[np.sort(t_first)]
    pred_flat_subj = np.repeat(np.asarray(subj, np.float64), Tp)
    pred_flat_subj = np.concatenate(
        [pred_flat_subj, np.zeros((Sp - len(subj)) * Tp)])
    pred_flat_subj[valid.reshape(-1) == 0] = np.nan
    idx, val = build_test_pred_map(pred_flat_subj, test_subjects)
    sub_index = {s: i for i, s in enumerate(test_subjects)}
    test_subj_of_row = np.asarray([sub_index[s] for s in test_subject_col])

    put = lambda a: torch.as_tensor(a, dtype=gdt, device=dev)
    with torch.inference_mode():
        z = batch_predict(spec0, k0, spec1, k1, noise, zt, put(x_st),
                          put(valid), put(mu_st), put(test_x), idx, val,
                          test_subj_of_row, eps)
        return z.cpu().numpy()


def decode_latents(model, ds: LongitudinalDataset, z_pred: np.ndarray,
                   rows: slice = slice(None)):
    """Decode the GP-predicted latents at the rows ``rows`` of ``ds``, under
    those rows' normalization statistics.  Returns the decoder output
    (log_p_x, log_p_x_missing, params, theta) and the staged (data, mask,
    theta_mask) of those rows."""
    dev, dt = _model_device_dtype(model)
    data, mask, tmask = (a[rows] for a in device_het(ds, dt, dev))
    with torch.inference_mode():
        _, norm_params = batch_normalization(data, mask, ds.layout, ds.conv)
        out = model.decode(torch.as_tensor(z_pred, dtype=dt, device=dev),
                           data, mask, tmask, norm_params)
    return out, (data, mask, tmask)


def validate(model, spec0, k0, spec1, k1, noise, zt,
             val_ds: LongitudinalDataset,
             train_mu: np.ndarray, train_x: np.ndarray,
             id_covariate: int, results_path: Optional[str],
             context_frames: Optional[int] = None,
             type_KL: str = "GPapprox_closed", num_samples: int = 1,
             eps: Optional[float] = None, noise_eps=None, seed: int = 0,
             eval_gp_f64: bool = False) -> Dict[str, float]:
    """Full validation pass -> the 10 named rows (``VALIDATION_ROWS``), also
    written to ``<results_path>/validation_results.csv``.

    ``eps`` is the GP jitter (None: the default of the GP dtype);
    ``noise_eps`` [N, L] injects the forward's reparameterization noise,
    else it is drawn from a generator seeded with ``seed``."""
    fm = forward_metrics(model, val_ds, eps=noise_eps, seed=seed)
    nll_loss_sum = fm["nll"]
    recon_loss_sum = fm["recon_loss"]
    gp = dict(eps=eps, eval_gp_f64=eval_gp_f64)
    if type_KL == "GPapprox":
        gp_loss_sum = gp_loss_sampled(spec0, k0, spec1, k1, noise, zt,
                                      val_ds, fm["mu"], fm["log_var"],
                                      num_samples, seed=seed, **gp)
    else:
        gp_loss_sum = gp_loss_dubo(spec0, k0, spec1, k1, noise, zt, val_ds,
                                   fm["mu"], fm["log_var"], **gp)
    net_loss_sum = gp_loss_sum + nll_loss_sum

    # GP extrapolation check
    k = context_frames if context_frames is not None else (
        5 if val_ds.conv else 2)
    ctx_rows = np.concatenate([
        np.arange(val_ds.subject_start[s],
                  min(val_ds.subject_start[s] + k, val_ds.subject_end[s]))
        for s in range(val_ds.P)])
    pred_x = np.concatenate([train_x, val_ds.labels[ctx_rows]])
    pred_mu = np.concatenate([train_mu, fm["mu"][ctx_rows]])
    test_x = val_ds.labels
    z_pred = gp_predict_dataset(
        spec0, k0, spec1, k1, noise, zt, pred_x, pred_mu,
        pred_x[:, id_covariate], test_x, test_x[:, id_covariate], **gp)

    (_, _, params, _), (data, mask, _) = decode_latents(model, val_ds,
                                                           z_pred)
    with torch.inference_mode():
        mean_rec, _ = mx.statistics(params, val_ds.layout, val_ds.conv)
        truth = mx.discrete_transform(data, val_ds.layout)
        gp_obs, gp_mis, _ = mx.error_computation(
            truth, mean_rec, val_ds.layout, mask, conv=val_ds.conv,
            use_ranges=val_ds.use_ranges)
        recon_loss_GP = gp_obs.sum().item()
        miss_recon_loss_GP = gp_mis.sum().item()
    n_vars = val_ds.layout.n_raw

    rows = dict(zip(VALIDATION_ROWS, [
        recon_loss_sum / len(val_ds),
        recon_loss_GP / n_vars,
        0.0,                       # vae_mse placeholder (the reference's 0)
        fm["miss_recon_loss"] / len(val_ds),
        miss_recon_loss_GP / n_vars,
        net_loss_sum,
        gp_loss_sum,
        nll_loss_sum,
        recon_loss_sum,
        recon_loss_GP,
    ]))
    if results_path:
        os.makedirs(results_path, exist_ok=True)
        write_rows_csv(os.path.join(results_path, "validation_results.csv"),
                       rows)
    return rows
