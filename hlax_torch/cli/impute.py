"""Offline imputation CLI: fill the missing cells of a raw CSV with a trained
model (port of ``hlax/cli/impute.py``).

    python -m hlax_torch.cli.impute --model_dir <save_path> \
        --data_csv data.csv [--mask_csv mask.csv] --out_csv imputed.csv \
        [--estimator mean|mode|sample] [--early_stopping] [--ll_csv ll.csv] \
        [--use_gp --label_csv labels.csv] [--device cpu]

``model_dir`` is a training run's save_path: its ``arguments.pkl`` gives the
model and type configuration, its ``final.pt`` (``early_best.pt`` with
``--early_stopping``) the weights.  Observed cells pass through untouched;
missing cells get the decoder's per-type estimate, mapped back to the input
CSV's own value space:

  * cat/ordinal: the class index through the column's sorted unique values,
    inverting the reader's code assignment;
  * count: the +1 shift the reader applies to 0-based columns is undone;
  * real/pos/beta: the de-normalized estimate is already in data units.

Encoder mode decodes the q(z) mean of each row.  ``--use_gp`` decodes the
sparse-GP posterior mean at the rows' covariates (``--label_csv``) given the
training run's encoded rows (``plot_values.pkl``), so rows the encoder never
saw -- future time points, fully missing rows -- are imputed too.  Without
``--mask_csv`` the NaN cells are the missing ones.  ``--ll_csv`` also writes
per-row observed/missing log-density sums.  Runs on CUDA unless
``--device=cpu``; the VAE's precision comes from
``JAX_DEFAULT_MATMUL_PRECISION``, as in the training CLI.
"""

from __future__ import annotations

import argparse
import ast
import os
import pickle
from typing import Optional

import numpy as np
import torch

from hlax_torch import precision, resolve_device, to_numpy


def _load_arguments(model_dir: str) -> dict:
    path = os.path.join(model_dir, "arguments.pkl")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path} not found: --model_dir must be a training run's "
            "save_path (the directory holding arguments.pkl and final.pt)")
    with open(path, "rb") as f:
        return pickle.load(f)


def _decode_discrete(col_raw: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """Map predicted class indices back to the column's own values by
    inverting the reader's sorted-unique code assignment."""
    uniques = np.unique(col_raw[~np.isnan(col_raw)])
    if len(uniques) == 0:        # fully missing column: keep the raw codes
        return codes
    idx = np.clip(codes.astype(int), 0, len(uniques) - 1)
    return uniques[idx]


def _gp_forward(model, sd: dict, opt: dict, het, model_dir: str,
                label_csv: Optional[str], data, mask, tmask):
    """Decode from the sparse-GP latent posterior at the rows' covariates."""
    from hlax_torch.data.dataset import HEALTH_MNIST_LABEL_ORDER, _read_labels
    from hlax_torch.eval.validate import gp_predict_dataset
    from hlax_torch.gp.kernels import build_kernel_specs, noise_value
    from hlax_torch.ops.normalization import batch_normalization

    if not label_csv:
        raise ValueError("--use_gp needs --label_csv (row covariates)")
    pv_path = os.path.join(model_dir, "plot_values.pkl")
    if not os.path.isfile(pv_path):
        raise FileNotFoundError(
            f"{pv_path} not found: GP mode needs the training run's encoded "
            "rows (written at the end of training by the training CLI)")
    with open(pv_path, "rb") as f:
        train_x, train_mu = pickle.load(f)[:2]

    labels = _read_labels(label_csv)
    if het.n_variables == 1296:
        labels = labels[:, np.array(HEALTH_MNIST_LABEL_ORDER)]
    labels = np.nan_to_num(labels)

    spec0, spec1 = build_kernel_specs(
        opt.get("cat_kernel") or [], opt.get("bin_kernel") or [],
        opt.get("sqexp_kernel") or [], opt.get("cat_int_kernel") or [],
        opt.get("bin_int_kernel") or [],
        opt.get("covariate_missing_val") or [], opt["id_covariate"])
    dev = data.device
    to = lambda ps: [{k: v.to(dev) for k, v in p.items()} for p in ps]
    noise = noise_value(sd["raw_noise"].to(dev),
                        opt.get("constrain_scales", False))
    idc = opt["id_covariate"]
    train_x, train_mu = np.asarray(train_x), np.asarray(train_mu)
    z = gp_predict_dataset(
        spec0, to(sd["k0"]), spec1, to(sd["k1"]), noise, sd["zt"].to(dev),
        train_x, train_mu, train_x[:, idc], labels, labels[:, idc],
        opt.get("eps"))
    with torch.inference_mode():
        _, norm_params = batch_normalization(data, mask, het.layout,
                                             model.cfg.conv)
        log_p_x, log_p_x_missing, params, _ = model.decode(
            torch.as_tensor(z, dtype=data.dtype, device=dev), data, mask,
            tmask, norm_params)
    return {"log_p_x": log_p_x, "log_p_x_missing": log_p_x_missing,
            "params": params}


def run_impute(model_dir: str, data_csv: str, out_csv: str,
               mask_csv: Optional[str] = None, types_csv: Optional[str] = None,
               estimator: str = "mean", early_stopping: bool = False,
               ll_csv: Optional[str] = None, seed: int = 0,
               device: str = "", use_gp: bool = False,
               label_csv: Optional[str] = None) -> np.ndarray:
    from hlax_torch.cli.main import _DTYPES
    from hlax_torch.data.reader import _read_csv_matrix, read_data
    from hlax_torch.eval import metrics as mx
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.train import checkpoint as ckpt

    dev = resolve_device(device or None)
    opt = _load_arguments(model_dir)
    if types_csv is None:
        types_csv = os.path.join(opt["data_source_path"],
                                 opt["csv_types_file"])
    range_file = opt.get("csv_range_file")
    if range_file:
        range_file = os.path.join(opt["data_source_path"], range_file)

    het = read_data(data_csv, mask_csv, None, types_csv, range_file,
                    opt.get("logvar_network", False))
    raw = _read_csv_matrix(data_csv)
    if mask_csv is None:
        # no mask file: NaN cells are the missing ones
        mask_raw = (~np.isnan(raw)).astype(np.float64)
        het.mask = np.ascontiguousarray(mask_raw[:, het.layout.raw_perm])
        het.theta_mask = het.layout.expand_raw_to_theta(het.mask)

    hidden_layers = opt.get("hidden_layers") or "[500]"
    if isinstance(hidden_layers, str):
        hidden_layers = ast.literal_eval(hidden_layers)
    mcfg = HLVAEConfig(
        layout=het.layout, z_dim=opt["latent_dim"],
        h_dims=tuple(hidden_layers), y_dim=opt.get("y_dim") or 5,
        conv=bool(opt.get("conv_hivae", False)),
        logvar_network=opt.get("logvar_network", False),
        vy_init_real=opt.get("vy_init_real", 1.0),
        vy_init_pos=opt.get("vy_init_pos", 0.5),
        precision=precision.from_env())
    dt = _DTYPES[opt.get("model_dtype", "float32")]
    model = HLVAE(mcfg, torch.Generator(device=dev).manual_seed(0),
                  device=dev).to(dt)
    name = ckpt.EARLY_BEST_NAME if early_stopping else ckpt.FINAL_NAME
    sd = ckpt.load(model_dir, name)
    if sd is None:
        raise FileNotFoundError(f"no checkpoint {name}.pt in {model_dir}")
    model.load_state_dict(sd["vae"])

    put = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    data, mask, tmask = put(het.data), put(het.mask), put(het.theta_mask)
    if use_gp:
        out = _gp_forward(model, sd, opt, het, model_dir, label_csv, data,
                          mask, tmask)
    else:
        with torch.inference_mode():
            out = model(data, mask, tmask, sample=False)
    with torch.inference_mode():
        if estimator == "sample":
            # one posterior-predictive draw per cell instead of a point
            # estimate
            est_grouped = mx.sampled_reconstruction(
                out["params"], het.layout,
                torch.Generator(device=dev).manual_seed(seed + 1), mcfg.conv)
        else:
            mean_rec, mode_rec = mx.statistics(out["params"], het.layout,
                                               mcfg.conv)
            est_grouped = mean_rec if estimator == "mean" else mode_rec
        est = to_numpy(est_grouped)[:, het.layout.raw_inv]  # original order
        lp = to_numpy(out["log_p_x"])
        lpm = to_numpy(out["log_p_x_missing"])

    layout = het.layout
    imputed = np.array(raw, dtype=np.float64)
    mask_orig = np.asarray(het.mask)[:, layout.raw_inv]
    n_filled = 0
    for j in range(raw.shape[1]):
        g = layout.groups[layout.raw_group_of_var[j]]
        col_est = est[:, j]
        if g.kind in ("cat", "ordinal"):
            col_est = _decode_discrete(raw[:, j], col_est)
        elif (g.kind == "count" and not np.all(np.isnan(raw[:, j]))
              and np.nanmin(raw[:, j]) == 0):
            # undo the reader's +1 shift; rate estimates below the shift
            # floor clamp to the domain edge
            col_est = np.maximum(col_est - 1.0, 0.0)
        missing = mask_orig[:, j] == 0
        imputed[missing, j] = col_est[missing]
        n_filled += int(missing.sum())

    np.savetxt(out_csv, imputed, delimiter=",", fmt="%.10g")
    print(f"Imputed {n_filled} missing cells across {raw.shape[0]} rows "
          f"-> {out_csv}")

    if ll_csv:
        m_np = np.asarray(het.mask)
        obs = (lp * m_np).sum(axis=1)
        mis = (lpm * (1 - m_np)).sum(axis=1)
        np.savetxt(ll_csv, np.column_stack([obs, mis]), delimiter=",",
                   header="observed_ll,missing_ll", comments="")
        print(f"Per-row log-densities -> {ll_csv}")
    return imputed


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Impute missing values in a raw CSV with a trained "
                    "hlax_torch model (see module docstring)")
    p.add_argument("--model_dir", required=True,
                   help="training run's save_path (arguments.pkl + final.pt)")
    p.add_argument("--data_csv", required=True)
    p.add_argument("--mask_csv", default=None,
                   help="observation mask CSV (2-col position list or full "
                        "matrix); default: NaN cells in data_csv are missing")
    p.add_argument("--types_csv", default=None,
                   help="types CSV; default: the training run's")
    p.add_argument("--out_csv", required=True)
    p.add_argument("--estimator", choices=["mean", "mode", "sample"],
                   default="mean",
                   help="point estimate per cell (mean/mode) or one "
                        "posterior-predictive sample (sample)")
    p.add_argument("--early_stopping", action="store_true",
                   help="restore the early_best checkpoint instead of final")
    p.add_argument("--ll_csv", default=None,
                   help="also write per-row observed/missing log-density sums")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="", choices=["", "cpu", "cuda"],
                   help="device to run on (empty = cuda)")
    p.add_argument("--use_gp", action="store_true",
                   help="impute from the sparse-GP latent posterior at the "
                        "rows' covariates (needs --label_csv and the training "
                        "run's plot_values.pkl) instead of the encoder "
                        "posterior")
    p.add_argument("--label_csv", default=None,
                   help="covariate CSV for the input rows (training label "
                        "format, with header); required with --use_gp")
    a = p.parse_args(argv)
    return run_impute(a.model_dir, a.data_csv, a.out_csv, a.mask_csv,
                      a.types_csv, a.estimator, a.early_stopping, a.ll_csv,
                      a.seed, a.device, a.use_gp, a.label_csv)


if __name__ == "__main__":
    main()
