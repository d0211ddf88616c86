"""Training driver: config -> datasets -> model + GP -> train -> checkpoint
(port of the training part of ``hlax/cli/main.py``).

    python -m hlax_torch.cli.main --f=configs/hlvae_config_file.txt

Same config flags and the same per-epoch console lines as hlax.  Runs on
CUDA unless ``--device=cpu``.  Ends with ``<save_path>/final.pt``, one
``torch.save``d state dict.  Validation, tests and image generation belong
to the eval path, not ported yet: a config that asks for them is refused.
"""

from __future__ import annotations

import ast
import os
import sys
import time
from timeit import default_timer as timer

import numpy as np
import torch

from hlax_torch import resolve_device
from hlax_torch.config import ModelArgs

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# run-control flags whose feature the port has not reached, with the value
# that keeps hlax's behaviour the same as the port's
_NOT_PORTED = {
    "run_validation": (False, "the eval path (ROADMAP queue 1 item 9)"),
    "run_tests": (False, "the eval path (ROADMAP queue 1 item 9)"),
    "generate_images": (False, "the eval path (ROADMAP queue 1 item 9)"),
    "early_stopping": (False, "early stopping needs validation "
                              "(ROADMAP queue 1 item 9)"),
    "compute_dtype": ("", "compute_dtype (ROADMAP queue 1 item 4)"),
    "fused_conv": (False, "the fused conv path (ROADMAP queue 1 item 12)"),
    "nat_grad_f64": (False, "the float64 natural-gradient chain "
                            "(ROADMAP queue 1 item 7)"),
    "data_parallel": (0, "data parallelism (ROADMAP queue 1 item 11)"),
    "latent_parallel": (1, "latent parallelism (ROADMAP queue 1 item 11)"),
}


def _check_ported(opt: dict) -> None:
    for key, (ok, what) in _NOT_PORTED.items():
        if opt.get(key) and opt.get(key) != ok:
            raise NotImplementedError(
                f"--{key}={opt[key]}: {what} is not ported to hlax_torch "
                f"yet; set --{key}={ok}")
    if not opt.get("conv_hivae"):
        raise NotImplementedError(
            "--conv_hivae=False: the MLP model is not ported to hlax_torch "
            "yet (ROADMAP queue 1 item 4)")
    for key in ("model_dtype", "gp_dtype"):
        if opt.get(key, "float32") not in _DTYPES:
            raise NotImplementedError(f"--{key}={opt[key]} is not ported")


def run(opt: dict) -> dict:
    from hlax_torch.data.dataset import (epoch_subject_batches, load_dataset,
                                         stage_dataset, subject_batches)
    from hlax_torch.gp.kernels import build_kernel_specs
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.train import checkpoint as ckpt
    from hlax_torch.train import step as tstep

    _check_ported(opt)
    device = resolve_device(opt.get("device") or None)
    save_path = opt["save_path"]
    os.makedirs(save_path, exist_ok=True)

    for key in sorted(opt):
        print(f"{key}: {opt[key]}")

    model_dtype = _DTYPES[opt.get("model_dtype", "float32")]
    gp_dtype = _DTYPES[opt.get("gp_dtype", "float32")]
    id_covariate = opt["id_covariate"]
    latent_dim = opt["latent_dim"]

    dataset = load_dataset(
        opt["data_source_path"], opt["csv_file_data"], opt["csv_file_label"],
        opt.get("mask_file"), opt["csv_types_file"],
        opt.get("true_mask_file") or None, opt.get("csv_range_file"),
        id_covariate, opt.get("logvar_network", False), True,
        opt.get("use_ranges", False))
    print(f"Length of dataset:  {len(dataset)}")
    if not len(dataset):
        print("ERROR: Dataset is empty")
        sys.exit(1)

    hidden_layers = opt.get("hidden_layers") or "[500]"
    if isinstance(hidden_layers, str):
        hidden_layers = ast.literal_eval(hidden_layers)
    seed = opt.get("seed", 0)
    mcfg = HLVAEConfig(
        layout=dataset.layout, z_dim=latent_dim, h_dims=tuple(hidden_layers),
        y_dim=opt.get("y_dim") or 5, conv=True,
        logvar_network=opt.get("logvar_network", False),
        vy_init_real=opt.get("vy_init_real", 1.0),
        vy_init_pos=opt.get("vy_init_pos", 0.5))
    model = HLVAE(mcfg, torch.Generator(device=device).manual_seed(seed),
                  device=device).to(model_dtype)

    spec0, spec1 = build_kernel_specs(
        opt.get("cat_kernel") or [], opt.get("bin_kernel") or [],
        opt.get("sqexp_kernel") or [], opt.get("cat_int_kernel") or [],
        opt.get("bin_int_kernel") or [], opt.get("covariate_missing_val") or [],
        id_covariate)

    cfg = tstep.TrainConfig(
        latent_dim=latent_dim, M=opt["M"], P_tot=float(dataset.P),
        N_tot=float(len(dataset)), id_covariate=id_covariate,
        natural_gradient=opt.get("natural_gradient", True),
        natural_gradient_lr=opt.get("natural_gradient_lr", 0.01),
        constrain_scales=opt.get("constrain_scales", False),
        eps=opt.get("eps"), gp_dtype=gp_dtype,
        nat_grad_jitter=opt.get("nat_grad_jitter", 0.0))

    subjects_per_batch = opt.get("subjects_per_batch", 20)
    state = tstep.init_train_state(
        model, spec0, spec1,
        next(subject_batches(dataset, subjects_per_batch)), cfg, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Total Parameter Number is: {n_params}")

    staged = stage_dataset(dataset, model_dtype, device)
    step = tstep.make_train_step(model, spec0, spec1, cfg)
    epochs = opt.get("epochs", 0)
    rng = np.random.default_rng(seed)
    loss_arrs = {k: [] for k in ("net", "nll", "kld", "recon")}
    epoch_seconds = []
    miss_recon_loss = 0.0

    start = timer()
    for epoch in range(1, epochs + 1):
        t0 = time.time()
        idx = np.stack(list(epoch_subject_batches(dataset.P,
                                                  subjects_per_batch, rng)))
        ms = tstep.train_epoch(step, state, staged, idx)
        epoch_seconds.append(time.time() - t0)
        sums = {"net": float(ms["loss"].mean()), "nll": float(ms["nll"].mean()),
                "kld": float(ms["kld"].mean()),
                "recon": float(ms["recon"].mean())}
        recon_sum2 = float(ms["recon"].sum())
        print("Iter %d/%d - Time: %.3f  - Loss: %.3f  - GP loss: %.3f  "
              "- NLL Loss: %.3f  - Recon Loss: %.3f"
              % (epoch, epochs, epoch_seconds[-1], sums["net"], sums["kld"],
                 sums["nll"], recon_sum2), flush=True)
        for k in loss_arrs:
            loss_arrs[k].append(sums[k])
        miss_recon_loss = float(ms["miss_recon"].sum()) / len(dataset)
        print(f"Error for Training: "
              f"{recon_sum2 / (len(dataset) * dataset.het.mask.shape[1])}")

    print("Duration of training: {:.2f} seconds".format(timer() - start))
    print(f"Imputation error is {miss_recon_loss}")
    target = ckpt.save(save_path, state)
    print(f"Saved {target}")
    return {"state": state, "model": model, "loss_arrs": loss_arrs,
            "spec0": spec0, "spec1": spec1, "dataset": dataset,
            "staged": staged, "train_step": step, "steps": state.step,
            "epoch_seconds": epoch_seconds}


def main(argv=None):
    opt = ModelArgs().parse_options(argv)
    return run(opt)


if __name__ == "__main__":
    main()
