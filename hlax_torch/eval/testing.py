"""Test-time metrics battery: encode/decode test and GP future prediction
(port of ``hlax/eval/testing.py``).  Writes the same artifacts:
``result_error_{final,early_stopping}.csv`` and the partial-metrics pickles.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from hlax_torch import to_numpy
from hlax_torch.data.dataset import LongitudinalDataset
from hlax_torch.eval import metrics as mx
from hlax_torch.eval.validate import (_model_device_dtype, device_het,
                                      decode_latents, gp_predict_dataset,
                                      write_rows_csv)


def _unseen_frame_rows(ds: LongitudinalDataset, first_frames: int = 5
                       ) -> np.ndarray:
    """Frames first_frames..T-1 of each subject."""
    rows = []
    for s in range(ds.P):
        a, b = ds.subject_start[s], ds.subject_end[s]
        rows.append(np.arange(a + first_frames, b))
    return np.concatenate(rows) if rows else np.zeros(0, np.int64)


def _unseen_rows(ds: LongitudinalDataset, conv: bool,
                 training_indexes=None, first_frames: int = 5):
    """Unseen-row selection: conv datasets use frames first_frames..T-1 of
    each subject; non-conv datasets treat the LAST label column as a
    globally unique row index and keep the test rows whose index is not in
    the training set's.

    Returns ``(rows, all_rows_fallback)``; the flag marks the case where
    every test row was seen and all rows are evaluated instead."""
    if conv or training_indexes is None:
        rows = _unseen_frame_rows(ds, first_frames)
    else:
        seen = np.unique(np.asarray(training_indexes).astype(np.int64))
        last = ds.labels[:, -1].astype(np.int64)
        rows = np.nonzero(~np.isin(last, seen))[0]
    if rows.size == 0:
        print("No unseen test rows — evaluating on all rows")
        return np.arange(len(ds)), True
    return rows, False


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return to_numpy(tree)


def _metric_battery(ds, data, mask, log_p_x, log_p_x_missing, params,
                    rows: np.ndarray, sample_seed: int = 0) -> Dict:
    """Mean/mode/sampled/imputation errors and partial log-likelihoods of
    the rows ``rows``."""
    lay = ds.layout
    dev = data.device
    truth = mx.discrete_transform(data, lay)
    mean_rec, mode_rec = mx.statistics(params, lay, ds.conv)
    samp_rec = mx.sampled_reconstruction(
        params, lay, torch.Generator(device=dev).manual_seed(sample_seed),
        ds.conv)
    tm = torch.as_tensor(ds.het.true_mask, dtype=data.dtype, device=dev)
    sel = torch.as_tensor(rows, device=dev)
    sub = lambda a: a[sel]
    err = lambda rec, **kw: mx.error_computation(
        sub(truth), rec, lay, sub(mask), conv=ds.conv,
        use_ranges=ds.use_ranges, true_mask=sub(tm), **kw)[2]

    partial_mean = err(sub(mean_rec))
    partial_mode = err(sub(mode_rec))
    partial_sample = err(sub(samp_rec))
    imputed = torch.as_tensor(mx.mean_imputation(
        to_numpy(sub(truth)), to_numpy(sub(mask)), lay),
        dtype=data.dtype, device=dev)
    partial_imp = err(imputed, mean_imp_error=True)
    partial_ll = mx.partial_loglikelihood(
        sub(log_p_x), sub(log_p_x_missing), lay, sub(mask), sub(tm))
    return {
        "partial_error_mean": _to_numpy(partial_mean),
        "partial_error_mode": _to_numpy(partial_mode),
        "partial_error_sample": _to_numpy(partial_sample),
        "impt_partial_error": _to_numpy(partial_imp),
        "partial_LL": _to_numpy(partial_ll),
        "mean_rec": mean_rec, "mode_rec": mode_rec, "sample_rec": samp_rec,
        "truth": truth,
    }


def hlvae_test(model, ds: LongitudinalDataset, test: bool = False,
               id_covariate: int = 2, T: int = 20, prnt: bool = True,
               training_indexes=None) -> Dict:
    """Encode -> decode metrics over a dataset with the q(z) mean, no
    sampling; with ``test=True`` restricted to the unseen rows (frames
    5..T-1 of each subject in conv mode, the label-set difference against
    ``training_indexes`` otherwise)."""
    dev, dt = _model_device_dtype(model)
    data, mask, tmask = device_het(ds, dt, dev)
    rows, fallback = (_unseen_rows(ds, model.cfg.conv, training_indexes)
                      if test else (np.arange(len(ds)), False))
    with torch.inference_mode():
        out = model(data, mask, tmask, sample=False)
        res = _metric_battery(ds, data, mask, out["log_p_x"],
                              out["log_p_x_missing"], out["params"], rows)
        m_np = to_numpy(mask)[rows]
        lp = to_numpy(out["log_p_x"])[rows]
        lpm = to_numpy(out["log_p_x_missing"])[rows]
    obs_density = lp[m_np == 1].mean() if (m_np == 1).any() else 0.0
    mis_density = lpm[m_np == 0].mean() if (m_np == 0).any() else 0.0
    if prnt:
        print(f"Observed Density: {obs_density}")
        print(f"Missing Density: {mis_density}")
        for key in res["impt_partial_error"]:
            print(f"Mean Impt. {key} missing error: "
                  f"{np.mean(res['impt_partial_error'][key]['error_missing'])}")
            print(f"Prediction (Mean) {key} missing error: "
                  f"{np.mean(res['partial_error_mean'][key]['error_missing'])}")
    res["observed_density"] = float(obs_density)
    res["missing_density"] = float(mis_density)
    res["all_rows_fallback"] = fallback
    return res


def mse_test_gp(model, spec0, k0, spec1, k1, noise, zt,
                test_ds: LongitudinalDataset,
                prediction_x: np.ndarray, prediction_mu: np.ndarray,
                id_covariate: int, results_path: Optional[str] = None,
                test_type: str = "final", eps: Optional[float] = None,
                training_indexes=None, eval_gp_f64: bool = False) -> Dict:
    """GP-predict z at the test covariates, decode, and report against the
    imputation baseline."""
    z_pred = gp_predict_dataset(
        spec0, k0, spec1, k1, noise, zt,
        prediction_x, prediction_mu, prediction_x[:, id_covariate],
        test_ds.labels, test_ds.labels[:, id_covariate], eps,
        eval_gp_f64=eval_gp_f64)
    (log_p_x, log_p_x_missing, params, _), (data, mask, _) = \
        decode_latents(model, test_ds, z_pred)

    rows, fallback = _unseen_rows(test_ds, model.cfg.conv, training_indexes)
    with torch.inference_mode():
        res = _metric_battery(test_ds, data, mask, log_p_x, log_p_x_missing,
                              params, rows)
        sel = torch.as_tensor(rows, device=data.device)
        tm = torch.as_tensor(test_ds.het.true_mask, dtype=data.dtype,
                             device=data.device)
        rec_obs, rec_mis, _ = mx.error_computation(
            res["truth"][sel], res["mean_rec"][sel], test_ds.layout,
            mask[sel], conv=test_ds.conv, use_ranges=test_ds.use_ranges,
            true_mask=tm[sel])
        res["mean_GP_recon_loss"] = rec_obs.mean().item()
        res["miss_recon_loss_GP"] = rec_mis.mean().item()
    res["all_rows_fallback"] = fallback
    res["z_pred"] = z_pred

    if results_path:
        os.makedirs(results_path, exist_ok=True)
        # the extra all_rows_fallback row (0/1) makes the seen-rows metric
        # switch visible to CSV readers (the reference rows stay first)
        write_rows_csv(
            os.path.join(results_path, f"result_error_{test_type}.csv"),
            {"mean_GP_recon_loss": res["mean_GP_recon_loss"],
             "miss_recon_loss_GP": res["miss_recon_loss_GP"],
             "all_rows_fallback": float(fallback)})
        with open(os.path.join(results_path,
                               "partial_metrics_test_future.pickle"), "wb") as f:
            pickle.dump([res["impt_partial_error"], res["partial_error_mean"],
                         res["partial_error_mode"], res["partial_LL"]], f)
    return res
