"""End-to-end entry point: config -> datasets -> model + GP -> train -> eval
(port of ``hlax/cli/main.py``).

    python -m hlax_torch.cli.main --f=configs/hlvae_config_file.txt \
        --generate_images=False

Same config flags, artifact names and console lines as hlax.  Runs on CUDA
unless ``--device=cpu``.  Trains through ``make_train_epoch`` (CUDA graphs
of the step on the card, ``--scan_unroll`` steps a graph) in bursts of up
to ``--epochs_per_dispatch`` epochs that never cross a validation or save
epoch; ``--profile_dir`` gets a torch.profiler trace of the burst that
holds epoch 2.  Validates every 5 epochs and at each save
interval when ``--run_validation``, runs the test battery at the end when
``--run_tests``.  ``<save_path>/final.pt`` (one ``torch.save``d state dict),
``diagnostics.pkl`` and ``plot_values.pkl`` are written when ``epochs > 2``
and early stopping is off, ``arguments.pkl`` when ``epochs`` is not 0, 1 or
2 and early stopping is off; a run with ``epochs`` in {0, 1, 2} or early
stopping reloads the saved ``arguments.pkl`` and overrides only the
run-control flags (an eval-only rerun of a trained model).  At each save
interval the training curves are plotted (``eval/images.py``) and, with
``--generate_images``, the reconstruction grid of the generation split; the
final grid is drawn after training.  Where matplotlib is missing these
write ``.npz`` files instead (hlax's CLI raises there), and a failed plot
never ends the run.  ``--compute_dtype=bfloat16``,
``--model_dtype=bfloat16`` and ``--fused_conv`` are hlax's options.  The
VAE's float32 matmul precision comes from ``JAX_DEFAULT_MATMUL_PRECISION``,
with JAX's names, as hlax's does (``hlax_torch.precision``: unset or
"default" is TF32 on the card, "highest" full float32); the GP runs in full
float32 either way.

``--data_parallel=D --latent_parallel=N`` (D x N > 1) trains on a mesh of
D x N processes (``hlax_torch/parallel``): subjects sharded over D, the GP
state over N.  The CLI joins a ``torchrun``-style environment
(``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) when one is
set, else starts the processes itself; rank r runs on ``cuda:r`` over NCCL
(it refuses more ranks than visible cards), or with ``--device=cpu`` on the
CPU over gloo; mesh steps run as CUDA graphs over NCCL and eagerly over
gloo (``make_train_epoch``).  At a validation or save epoch the GP state
is gathered and rank 0 validates, tests, draws and saves (``final.pt`` as
a single process writes it) while the others wait; only rank 0 prints.  A
warm start loads the whole checkpoint and shards it.
"""

from __future__ import annotations

import ast
import contextlib
import os
import pickle
import sys
import time
import traceback
from timeit import default_timer as timer

import numpy as np
import torch
import torch.distributed as dist

from hlax_torch import precision, resolve_device
from hlax_torch.config import ModelArgs

# model_dtype takes all three, gp_dtype float32 and float64 (the parser's
# choices, as in hlax)
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}

# run-control flags whose feature the port has not reached, with the value
# that keeps hlax's behaviour the same as the port's: none is left
_NOT_PORTED: dict = {}

# flags an eval-only rerun takes from its own command line; every other
# option comes from the training run's arguments.pkl
_RUN_CONTROL = ("early_stopping", "epochs", "save_interval", "results_path",
                "save_path", "gp_model_folder", "generate_images",
                "memory_dbg", "run_tests", "run_validation", "eval_gp_f64",
                "device", "data_parallel", "latent_parallel")


def _check_ported(opt: dict) -> None:
    for key, (ok, what) in _NOT_PORTED.items():
        if opt.get(key) and opt.get(key) != ok:
            raise NotImplementedError(
                f"--{key}={opt[key]}: {what} is not ported to hlax_torch "
                f"yet; set --{key}={ok}")
    for key in ("model_dtype", "gp_dtype"):
        if opt.get(key, "float32") not in _DTYPES:
            raise NotImplementedError(
                f"--{key}={opt[key]}: hlax_torch takes "
                f"{', '.join(_DTYPES)}")


def warm_start_candidates(gp_folder: str, save_path: str) -> list:
    """Checkpoint locations to probe for a warm start, in order: an absolute
    ``gp_model_folder`` as it is, then the reference's concatenation
    ``save_path + gp_model_folder`` (the canonical '/' means save_path)."""
    gp_folder = gp_folder or "/"
    cands = []
    if gp_folder != "/" and os.path.isabs(gp_folder):
        cands.append(gp_folder)
    cands.append(save_path + gp_folder)
    return cands


def _arguments_round_trip(opt: dict, write: bool = True) -> dict:
    """Write ``arguments.pkl`` for a training run (where ``write``: rank 0
    of a mesh), or merge the saved one under this run's run-control flags
    for an eval-only rerun."""
    args_pkl = os.path.join(opt["save_path"], "arguments.pkl")
    if opt.get("epochs", 0) not in (0, 1, 2) and not opt.get("early_stopping"):
        if write:
            with open(args_pkl, "wb") as f:
                pickle.dump(opt, f)
    elif os.path.isfile(args_pkl):
        with open(args_pkl, "rb") as f:
            saved = pickle.load(f)
        for k in _RUN_CONTROL:
            if k in opt:
                saved[k] = opt[k]
        return saved
    return opt


def _memory_dbg(enabled: bool, phase: str, device) -> None:
    """Peak device memory since the previous phase."""
    if not enabled or device.type != "cuda":
        return
    print(f"Max memory allocated after {phase} on {device}: "
          f"{torch.cuda.max_memory_allocated(device) / 1024 ** 2:.2f} MBs")
    torch.cuda.reset_peak_memory_stats(device)


def _start_profile(device):
    """A started torch.profiler session (device kernels too on CUDA), or
    None if the profiler fails: profiling never ends a run."""
    try:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof
    except Exception:
        print("Profiler failed to start (continuing):\n"
              + traceback.format_exc())
        return None


def _stop_profile(prof, profile_dir: str, first: int, last: int) -> None:
    """Stop ``prof`` and write its Chrome trace of epochs first..last into
    ``profile_dir``; a failure is reported, not raised."""
    try:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir,
                            f"epochs_{first}-{last}.pt.trace.json")
        prof.export_chrome_trace(path)
        print(f"Wrote a profiler trace of epochs {first}-{last} to {path}")
    except Exception:
        print("Profiler failed (continuing):\n" + traceback.format_exc())


def _mesh_shape(opt: dict):
    """(data ranks, latent ranks) the flags ask for."""
    return (max(opt.get("data_parallel") or 0, 1),
            max(opt.get("latent_parallel") or 0, 1))


def run(opt: dict) -> dict:
    """One process's run: the whole run, or one rank's part of a mesh run
    when a process group of more than one rank is initialized
    (``launch``)."""
    from hlax_torch.data.dataset import (epoch_subject_batches,
                                         epoch_subject_batches_mesh,
                                         load_dataset, stage_dataset,
                                         stage_dataset_mesh, subject_batches)
    from hlax_torch.eval import images as im
    from hlax_torch.eval import testing as tst
    from hlax_torch.eval import validate as val
    from hlax_torch.gp.kernels import build_kernel_specs, noise_value
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.parallel import mesh as pmesh
    from hlax_torch.train import checkpoint as ckpt
    from hlax_torch.train import step as tstep

    mesh = None
    if dist.is_initialized() and dist.get_world_size() > 1:
        mesh = pmesh.make_mesh(*_mesh_shape(opt))
    # rank 0 of a mesh prints, validates, tests, draws and saves
    lead = mesh is None or mesh.rank == 0
    save_path = opt["save_path"]
    results_path = save_path + (opt.get("results_path") or "/results")
    os.makedirs(save_path, exist_ok=True)
    os.makedirs(results_path, exist_ok=True)
    opt = _arguments_round_trip(opt, write=lead)
    _check_ported(opt)
    device = resolve_device(opt.get("device") or None)
    eval_gp_f64 = bool(opt.get("eval_gp_f64", False))

    for key in sorted(opt):
        print(f"{key}: {opt[key]}")

    model_dtype = _DTYPES[opt.get("model_dtype", "float32")]
    gp_dtype = _DTYPES[opt.get("gp_dtype", "float32")]
    id_covariate = opt["id_covariate"]
    latent_dim = opt["latent_dim"]

    def mk_ds(data_key, label_key, mask_key, true_key):
        return load_dataset(
            opt["data_source_path"], opt[data_key], opt[label_key],
            opt.get(mask_key), opt["csv_types_file"],
            opt.get(true_key) or None, opt.get("csv_range_file"),
            id_covariate, opt.get("logvar_network", False),
            bool(opt.get("conv_hivae")), opt.get("use_ranges", False))

    dataset = mk_ds("csv_file_data", "csv_file_label", "mask_file",
                    "true_mask_file")
    print(f"Length of dataset:  {len(dataset)}")
    if not len(dataset):
        print("ERROR: Dataset is empty")
        sys.exit(1)
    test_dataset = (mk_ds("csv_file_test_data", "csv_file_test_label",
                          "test_mask_file", "true_test_mask_file")
                    if opt.get("csv_file_test_data") else None)
    prediction_dataset = (mk_ds("csv_file_prediction_data",
                                "csv_file_prediction_label",
                                "prediction_mask_file",
                                "true_prediction_mask_file")
                          if (opt.get("run_tests")
                              or opt.get("generate_images"))
                          and opt.get("csv_file_prediction_data") else None)
    generation_dataset = (mk_ds("csv_file_generation_data",
                                "csv_file_generation_label",
                                "generation_mask_file",
                                "true_generation_mask_file")
                          if opt.get("generate_images") else None)
    validation_dataset = (mk_ds("csv_file_validation_data",
                                "csv_file_validation_label",
                                "validation_mask_file",
                                "true_validation_mask_file")
                          if opt.get("run_validation") else None)

    hidden_layers = opt.get("hidden_layers") or "[500]"
    if isinstance(hidden_layers, str):
        hidden_layers = ast.literal_eval(hidden_layers)
    seed = opt.get("seed", 0)
    mcfg = HLVAEConfig(
        layout=dataset.layout, z_dim=latent_dim, h_dims=tuple(hidden_layers),
        y_dim=opt.get("y_dim") or 5, conv=bool(opt.get("conv_hivae")),
        logvar_network=opt.get("logvar_network", False),
        vy_init_real=opt.get("vy_init_real", 1.0),
        vy_init_pos=opt.get("vy_init_pos", 0.5),
        fused_conv=bool(opt.get("fused_conv", False)),
        compute_dtype=(_DTYPES[opt["compute_dtype"]]
                       if opt.get("compute_dtype") else None),
        precision=precision.from_env())
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
        nat_grad_jitter=opt.get("nat_grad_jitter", 0.0),
        nat_grad_f64=bool(opt.get("nat_grad_f64", False)),
        use_pallas_chol=bool(opt.get("use_pallas_chol", True)))

    subjects_per_batch = opt.get("subjects_per_batch", 20)
    state = tstep.init_train_state(
        model, spec0, spec1,
        next(subject_batches(dataset, subjects_per_batch)), cfg, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Total Parameter Number is: {n_params}")

    # warm start (into the whole state, sharded below on a mesh); the
    # canonical config's '/' means save_path itself
    name = ckpt.EARLY_BEST_NAME if opt.get("early_stopping") else \
        ckpt.FINAL_NAME
    if any(ckpt.restore(base, state, name=name) for base in
           warm_start_candidates(opt.get("gp_model_folder"), save_path)):
        print("Loaded pre-trained values.")
    else:
        print("Did not load pre-trained values.")

    # the whole epoch (a burst of epochs) at a time: CUDA graphs of the step
    # on the card, the eager steps on the CPU
    unroll = max(1, opt.get("scan_unroll") or 1)
    if mesh is None:
        staged = stage_dataset(dataset, model_dtype, device)
        epoch_fn = tstep.make_train_epoch(model, spec0, spec1, cfg,
                                          unroll=unroll)
        epoch_idx = lambda rng: np.stack(list(epoch_subject_batches(
            dataset.P, subjects_per_batch, rng)))
    else:
        print(f"Running on a ({mesh.n_data} data x {mesh.n_latent} latent) "
              f"mesh of processes over {mesh.backend}; its steps run "
              + ("as CUDA graphs" if tstep.uses_graphs(device, mesh)
                 else "eagerly"))
        state = pmesh.shard_state(state, mesh, cfg)
        staged = stage_dataset_mesh(dataset, model_dtype, device,
                                    mesh.n_data, mesh.d)
        epoch_fn = tstep.make_train_epoch_mesh(model, spec0, spec1, cfg,
                                               mesh, unroll=unroll)
        epoch_idx = lambda rng: epoch_subject_batches_mesh(
            dataset.P, mesh.n_data, subjects_per_batch, rng)

    def whole_state():
        """The whole train state: on a mesh gathered from every rank (all
        ranks call it)."""
        return state if mesh is None else pmesh.gather_state(state, mesh,
                                                             cfg)

    epochs = opt.get("epochs", 0)
    validation_interval = 5
    save_interval = opt.get("save_interval", 100)
    rng = np.random.default_rng(seed)
    loss_arrs = {k: [] for k in ("net", "nll", "kld", "recon")}
    validation_curve = []
    val_arrs = {k: [] for k in ("net", "recon", "gp", "vae_error", "gp_error")}
    last_val = None
    best_value, best_epoch = np.inf, 0
    best_epoch_missing_imp_error = -1.0
    epoch_seconds = []
    curves_plotted = False
    miss_recon_loss = 0.0
    type_KL = opt.get("type_KL") or "GPapprox_closed"
    noise_fn = lambda s: noise_value(s.raw_noise, cfg.constrain_scales)

    def encode_train():
        mu, _ = val.encode_dataset(model, dataset)
        return mu, dataset.labels

    def draw_recon(st, epoch=-1):
        pred_mu, _ = val.encode_dataset(model, prediction_dataset)
        im.recon_complete_gen(
            model, spec0, st.k0, spec1, st.k1, noise_fn(st), st.zt,
            generation_dataset, prediction_dataset.labels, pred_mu,
            id_covariate, results_path, epoch=epoch, eval_gp_f64=eval_gp_f64)

    def validate(st):
        train_mu, train_x = encode_train()
        return val.validate(
            model, spec0, st.k0, spec1, st.k1, noise_fn(st), st.zt,
            validation_dataset, train_mu, train_x, id_covariate,
            results_path, type_KL=type_KL,
            num_samples=opt.get("num_samples", 1), seed=seed,
            eval_gp_f64=eval_gp_f64)

    profile_dir = opt.get("profile_dir") or ""
    # bursts of up to epochs_per_dispatch epochs in one call of the epoch
    # function, never across a validation or save boundary (those read the
    # state); the per-epoch lines come from the returned metrics, the Time
    # column is the burst's time split evenly
    epochs_per_dispatch = max(1, opt.get("epochs_per_dispatch") or 1)

    def boundary(e):
        return (e % save_interval == 0
                or (validation_dataset is not None
                    and e % validation_interval == 0))

    _memory_dbg(opt.get("memory_dbg"), "initialisation", device)
    start = timer()
    epoch = 1
    while epoch <= epochs:
        burst = 1
        while (burst < epochs_per_dispatch and epoch + burst <= epochs
               and not boundary(epoch + burst - 1)):
            burst += 1
        t0 = time.time()
        prof = (_start_profile(device) if lead and profile_dir
                and epoch <= 2 <= epoch + burst - 1 else None)
        idx = np.concatenate([epoch_idx(rng) for _ in range(burst)])
        ms_all = epoch_fn(state, staged, idx)
        if prof is not None:
            _stop_profile(prof, profile_dir, epoch, epoch + burst - 1)
        t_per = (time.time() - t0) / burst
        nb = len(ms_all["loss"]) // burst
        for j in range(burst):
            ms = {k: v[j * nb:(j + 1) * nb] for k, v in ms_all.items()}
            epoch_seconds.append(t_per)
            sums = {"net": float(ms["loss"].mean()),
                    "nll": float(ms["nll"].mean()),
                    "kld": float(ms["kld"].mean()),
                    "recon": float(ms["recon"].mean())}
            recon_sum2 = float(ms["recon"].sum())
            print("Iter %d/%d - Time: %.3f  - Loss: %.3f  - GP loss: %.3f  "
                  "- NLL Loss: %.3f  - Recon Loss: %.3f"
                  % (epoch + j, epochs, t_per, sums["net"], sums["kld"],
                     sums["nll"], recon_sum2), flush=True)
            for k in loss_arrs:
                loss_arrs[k].append(sums[k])
            miss_recon_loss = float(ms["miss_recon"].sum()) / len(dataset)
            print(f"Error for Training: "
                  f"{recon_sum2 / (len(dataset) * dataset.het.mask.shape[1])}")
        # only the burst's last epoch can be a boundary
        epoch += burst - 1

        run_val = (validation_dataset is not None
                   and (epoch % validation_interval == 0
                        or epoch % save_interval == 0))
        if not (run_val or epoch % save_interval == 0):
            epoch += 1
            continue
        st = whole_state()
        if not lead:          # rank 0 validates, draws and saves
            dist.barrier()
            epoch += 1
            continue
        if run_val:
            tv = time.time()
            try:
                rows = validate(st)
                rows["best_epoch"] = float(best_epoch)
                rows["best_epoch_missing_imp_error"] = \
                    best_epoch_missing_imp_error
                rows["missing_imp_error"] = miss_recon_loss
                last_val = rows
                validation_curve.append(rows["net_loss"])
                for k, row in (("net", "net_loss"), ("recon", "nll_loss"),
                               ("gp", "GP_loss"), ("vae_error", "vae_error"),
                               ("gp_error", "GP_error")):
                    val_arrs[k].append(rows[row])
            except Exception:   # a failed validation must not end the run
                print("Validation failed (continuing):\n"
                      + traceback.format_exc())
            print(f"Validation Duration: {time.time() - tv}")

        if epoch % save_interval == 0:
            try:   # a failed plot must not end the run
                im.plot_training_info(
                    save_path, warn=not curves_plotted,
                    net_loss=loss_arrs["net"], nll=loss_arrs["nll"],
                    kld=loss_arrs["kld"], vae_error=val_arrs["vae_error"],
                    gp_error=val_arrs["gp_error"],
                    validation_loss=validation_curve)
                curves_plotted = True
            except Exception:
                print("Training-curve plot failed (continuing):\n"
                      + traceback.format_exc())
            if last_val is not None and epochs > 50:
                # validation_df.pkl holds the rows as a dict (hlax pickles a
                # pandas frame; the port has no pandas)
                with open(os.path.join(save_path, "validation_df.pkl"),
                          "wb") as f:
                    pickle.dump(last_val, f)
                val.write_rows_csv(os.path.join(save_path,
                                                "validation_df.csv"),
                                   last_val, header=True)
                with open(os.path.join(save_path, "validation_values.pkl"),
                          "wb") as f:
                    pickle.dump([np.asarray(val_arrs[k]) for k in
                                 ("net", "recon", "gp", "vae_error",
                                  "gp_error")], f)
            try:
                res = tst.hlvae_test(model, dataset, test=False,
                                     id_covariate=id_covariate, prnt=False)
                with open(os.path.join(results_path,
                                       "partial_metrics_training_VAE.pickle"),
                          "wb") as f:
                    pickle.dump(res["partial_LL"], f)
                if generation_dataset is not None \
                        and prediction_dataset is not None \
                        and epoch != epochs:
                    draw_recon(st, epoch)
            except Exception:   # a failed extra must not end the run
                print("Save-interval eval/image-gen failed (continuing):\n"
                      + traceback.format_exc())

        if run_val and epoch > 100 and validation_curve:
            if validation_curve[-1] < best_value:
                best_value, best_epoch = validation_curve[-1], epoch
                best_epoch_missing_imp_error = miss_recon_loss
                ckpt.save(save_path, st, name=ckpt.EARLY_BEST_NAME)
        if mesh is not None:
            dist.barrier()
        epoch += 1

    print("Duration of training: {:.2f} seconds".format(timer() - start))
    print(f"Best epoch is {best_epoch}")
    print(f"Best epoch imputation error is {best_epoch_missing_imp_error}")
    print(f"Imputation error is {miss_recon_loss}")
    _memory_dbg(opt.get("memory_dbg"), "training", device)

    eval_seconds = {}

    def result():
        return {"state": state, "model": model, "loss_arrs": loss_arrs,
                "spec0": spec0, "spec1": spec1, "dataset": dataset,
                "datasets": {"train": dataset,
                             "validation": validation_dataset,
                             "test": test_dataset,
                             "prediction": prediction_dataset,
                             "generation": generation_dataset},
                "staged": staged,
                "train_step": tstep.make_train_step(model, spec0, spec1, cfg,
                                                    mesh=mesh),
                "train_epoch": epoch_fn,
                "steps": state.step,
                "epoch_seconds": epoch_seconds, "eval_seconds": eval_seconds,
                "last_validation": last_val, "results_path": results_path}

    final = whole_state()
    if not lead:              # rank 0 saves, validates, tests and draws
        dist.barrier()
        return result()

    if epochs > 2 and not opt.get("early_stopping"):
        print("Saving")
        # [penalty, net, nll, recon, kld]: the reference's order; the
        # penalty term is per-epoch zeros
        with open(os.path.join(save_path, "diagnostics.pkl"), "wb") as f:
            pickle.dump([np.zeros(len(loss_arrs["net"]))]
                        + [np.asarray(loss_arrs[k])
                           for k in ("net", "nll", "recon", "kld")], f)
        # plot_values.pkl: [train_x, mu, log_var, z_sample, row_idx]
        pv_mu, pv_lv = val.encode_dataset(model, dataset)
        pv_z = pv_mu + np.exp(0.5 * pv_lv) * np.random.default_rng(
            seed).standard_normal(pv_mu.shape)
        with open(os.path.join(save_path, "plot_values.pkl"), "wb") as f:
            pickle.dump([dataset.labels, pv_mu, pv_lv, pv_z,
                         np.arange(len(dataset))], f)
        print(f"Saved {ckpt.save(save_path, final)}")
    _memory_dbg(opt.get("memory_dbg"), "saving", device)

    if opt.get("run_validation") and validation_dataset is not None:
        t0 = time.time()
        validate(final)
        eval_seconds["validation"] = time.time() - t0

    if test_dataset is not None:
        t0 = time.time()
        pred_mu = None
        if prediction_dataset is not None:
            pred_mu, _ = val.encode_dataset(model, prediction_dataset)
        res = tst.hlvae_test(model, test_dataset, test=True,
                             id_covariate=id_covariate,
                             training_indexes=dataset.labels[:, -1])
        with open(os.path.join(results_path,
                               "partial_metrics_test_VAE.pickle"), "wb") as f:
            pickle.dump(res["partial_LL"], f)
        if opt.get("run_tests") and pred_mu is not None:
            test_type = "early_stopping" if opt.get("early_stopping") \
                else "final"
            tst.mse_test_gp(model, spec0, final.k0, spec1, final.k1,
                            noise_fn(final), final.zt, test_dataset,
                            prediction_dataset.labels, pred_mu, id_covariate,
                            results_path, test_type=test_type,
                            training_indexes=dataset.labels[:, -1],
                            eval_gp_f64=eval_gp_f64)
        eval_seconds["tests"] = time.time() - t0
    _memory_dbg(opt.get("memory_dbg"), "tests", device)

    if generation_dataset is not None and prediction_dataset is not None:
        t0 = time.time()
        try:   # a failed plot must not end the run
            draw_recon(final)
        except Exception:
            print("Image generation failed (continuing):\n"
                  + traceback.format_exc())
        eval_seconds["images"] = time.time() - t0
    if mesh is not None:
        dist.barrier()
    return result()


def _summary(out: dict, rank: int) -> dict:
    """What a mesh rank's run sends back: its curves, evaluations, step
    count and kernel launches (the counters of its own process)."""
    from hlax_torch.ops import counters

    keep = ("loss_arrs", "steps", "epoch_seconds", "eval_seconds",
            "last_validation", "results_path")
    launches, by_shape, plain = counters.read_every()
    return {**{k: out[k] for k in keep}, "rank": rank, "launches": launches,
            "launches_by_shape": by_shape, "plain_calls": plain}


def _run_rank(rank: int, world_size: int, init_method, opt: dict) -> dict:
    """Rank ``rank`` of a mesh run: its device (``cuda:<local rank>``, set
    before the process group is made), the group, ``run``; only rank 0
    prints.  Returns ``_summary``."""
    from hlax_torch.parallel import distributed as pdist

    opt = dict(opt)
    if resolve_device(opt.get("device") or None).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        opt["device"] = f"cuda:{local}"
    else:   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    pdist.initialize(init_method=init_method, world_size=world_size,
                     rank=rank, device=opt.get("device") or None)
    try:
        with open(os.devnull, "w") as null, (
                contextlib.redirect_stdout(null) if rank
                else contextlib.nullcontext()):
            return _summary(run(opt), rank)
    finally:
        pdist.destroy()


def launch(opt: dict) -> dict:
    """Run the CLI on ``opt``: ``run`` in this process, or with a mesh of
    ``--data_parallel`` x ``--latent_parallel`` > 1 ranks, this process as
    one rank of a ``torchrun``-style environment (``WORLD_SIZE`` set), or
    that many processes started here.  A mesh run returns rank 0's
    ``_summary`` with every rank's under ``"ranks"``."""
    from hlax_torch.parallel import distributed as pdist

    world = int(np.prod(_mesh_shape(opt)))
    if world == 1:
        return run(opt)
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise RuntimeError(
                f"a {' x '.join(map(str, _mesh_shape(opt)))} mesh needs "
                f"{world} processes; WORLD_SIZE is "
                f"{os.environ['WORLD_SIZE']}")
        return _run_rank(int(os.environ["RANK"]), world, None, opt)
    if resolve_device(opt.get("device") or None).type == "cuda" \
            and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"a {' x '.join(map(str, _mesh_shape(opt)))} mesh takes one card "
            f"a rank, {world} cards; {torch.cuda.device_count()} are visible")
    ranks = pdist.spawn(_run_rank, world, (opt,))
    return {**ranks[0], "ranks": ranks}


def main(argv=None):
    opt = ModelArgs().parse_options(argv)
    return launch(opt)


if __name__ == "__main__":
    main()
