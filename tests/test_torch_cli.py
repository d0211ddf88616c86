"""The port's training CLI on a tiny generated dataset (CPU): train-only,
with validation and the test battery, the eval-only rerun from
``arguments.pkl``, the early-best checkpoint, and a 2 x 2 mesh run."""
import math
import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from hlax_torch import resolve_device
from hlax_torch.cli import generate as gen_cli
from hlax_torch.cli import main as cli
from hlax_torch.config import ModelArgs
from hlax_torch.eval.validate import VALIDATION_ROWS
from hlax_torch.ops import linalg_small as ls

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "hlvae_config_file.txt")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The canonical config's prediction (training), test and validation
    files: 4 subjects x 20 time points each."""
    d = str(tmp_path_factory.mktemp("data"))
    gen_cli.main(["--destination", d, "--num_3", "2", "--num_6", "2",
                  "--datatype_config", "D4", "--seed", "3",
                  "--splits", "prediction,test,validation"])
    return d


def _argv(data_dir, save, *extra):
    return [f"--f={CONFIG}", f"--data_source_path={data_dir}",
            f"--save_path={save}", "--epochs=3", "--run_validation=False",
            "--run_tests=False", "--generate_images=False", "--device=cpu",
            "--latent_dim=4", "--M=30", "--hidden_layers=[20]",
            "--subjects_per_batch=3", *extra]


def test_two_epoch_train_only_run(data_dir, tmp_path, capsys):
    """Canonical config at toy width: 4 subjects, 3 a batch -> 2 steps an
    epoch (the second batch padded); M=30 takes the mid Cholesky path.
    Three epochs: a run of more than 2 writes the final checkpoint,
    diagnostics.pkl, plot_values.pkl and arguments.pkl (hlax's rule)."""
    ls.reset_counters()
    out = cli.main(_argv(data_dir, tmp_path / "run"))
    printed = capsys.readouterr().out
    assert all(f"Iter {e}/3 - Time:" in printed for e in (1, 2, 3))
    assert out["steps"] == 6
    assert all(math.isfinite(v) for v in out["loss_arrs"]["net"])
    run = tmp_path / "run"
    for name in ("final.pt", "arguments.pkl", "diagnostics.pkl",
                 "plot_values.pkl"):
        assert os.path.isfile(run / name), name
    sd = torch.load(run / "final.pt", weights_only=False)
    assert sd["step"] == 6 and sd["H"].shape == (4, 30, 30)
    with open(run / "plot_values.pkl", "rb") as f:
        train_x, mu = pickle.load(f)[:2]
    assert train_x.shape == (80, 6) and mu.shape == (80, 4)
    assert not os.path.isfile(run / "results" / "validation_results.csv")
    # on the CPU the plain versions run, and nothing counts as a launch
    assert ls.LAUNCHES == {"chol_inv_small_cuda": 0, "chol_inv_mid_cuda": 0,
                           "chol_inv_bwd_cuda": 0,
                           "chol_inv_mid_bwd_cuda": 0}


def test_two_epoch_run_writes_no_final_checkpoint(data_dir, tmp_path):
    """hlax saves the final checkpoint, diagnostics and plot values only
    for epochs > 2, and arguments.pkl only for epochs not in {0, 1, 2}."""
    cli.main(_argv(data_dir, tmp_path / "run", "--epochs=2"))
    for name in ("final.pt", "arguments.pkl", "diagnostics.pkl",
                 "plot_values.pkl"):
        assert not os.path.isfile(tmp_path / "run" / name), name


def _read_rows(path):
    with open(path) as f:
        return {k: float(v) for k, v in (line.split(",") for line in f)}


@pytest.mark.parametrize("flag", ["--run_validation=True",
                                  "--run_tests=True",
                                  "--generate_images=True"])
def test_eval_flags_are_refused(data_dir, tmp_path, flag):
    """Validation, the test battery and image generation each run (toy
    runs that write their CSVs, or the reconstruction grids and the
    training curves); no eval flag is refused any more."""
    extra = ("--save_interval=2",) if flag == "--generate_images=True" \
        else ()
    out = cli.main(_argv(data_dir, tmp_path / "run", flag, *extra))
    results = tmp_path / "run" / "results"
    if flag == "--run_validation=True":
        rows = _read_rows(results / "validation_results.csv")
        assert tuple(rows) == VALIDATION_ROWS
        assert all(math.isfinite(v) for v in rows.values())
        assert set(out["eval_seconds"]) == {"validation", "tests"}
    elif flag == "--run_tests=True":
        rows = _read_rows(results / "result_error_final.csv")
        assert list(rows) == ["mean_GP_recon_loss", "miss_recon_loss_GP",
                              "all_rows_fallback"]
        assert all(math.isfinite(v) for v in rows.values())
        assert os.path.isfile(results / "partial_metrics_test_future.pickle")
    else:
        # the grid after training and at the save interval (epoch 2, not
        # the last), the curves at the save interval, as hlax draws them
        assert out["datasets"]["generation"] is not None
        assert "images" in out["eval_seconds"]
        for name in ("recon_complete.pdf", "recon_complete_2.pdf"):
            assert os.path.getsize(results / name) > 0, name
        for name in ("training_net_loss.png", "training_kl_ll.png"):
            assert os.path.getsize(tmp_path / "run" / name) > 0, name


def test_config_file_alone_is_refused_until_eval_is_ported():
    """The canonical config file, images and all, passes the port's check
    unmodified, and so does it with the mesh flags: nothing is refused."""
    opt = ModelArgs().parse_options([f"--f={CONFIG}"])
    assert opt["generate_images"] is True
    cli._check_ported(opt)
    for flag in ("--data_parallel=2", "--latent_parallel=2"):
        cli._check_ported(ModelArgs().parse_options([f"--f={CONFIG}", flag]))
    assert cli._NOT_PORTED == {}


def test_toy_mesh_run_restores_in_one_process(data_dir, tmp_path, capsys):
    """``--device=cpu --data_parallel=2 --latent_parallel=2`` (hlax's
    ``test_cli_data_parallel_smoke``) as a user runs it, ``python -m
    hlax_torch.cli.main``: four gloo processes, rank 0 alone printing one
    Iter line an epoch; validation, the test battery and final.pt (one
    step an epoch: 2 subjects a shard, 2 a batch).  A single-process
    eval-only rerun warm-starts from final.pt, whose state is the whole
    GP's, and the imputation CLI reads it."""
    from hlax_torch.cli import impute

    save = tmp_path / "run"
    argv = _argv(data_dir, save, "--data_parallel=2", "--latent_parallel=2",
                 "--run_validation=True", "--run_tests=True")
    # its own session, so that a timeout kills the CLI and every rank
    proc = subprocess.Popen([sys.executable, "-m", "hlax_torch.cli.main",
                             *argv], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        printed, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert "Running on a (2 data x 2 latent) mesh of processes over gloo" \
        in printed
    for e in (1, 2, 3):
        assert printed.count(f"Iter {e}/3 - Time:") == 1
    assert printed.count("Total Parameter Number") == 1
    rows = _read_rows(save / "results" / "validation_results.csv")
    assert list(rows) == list(VALIDATION_ROWS)
    assert all(math.isfinite(v) for v in rows.values())
    assert os.path.isfile(save / "results" / "result_error_final.csv")
    sd = torch.load(save / "final.pt", weights_only=False)
    assert sd["step"] == 3 and sd["H"].shape == (4, 30, 30)
    out = cli.main(_argv(data_dir, save, "--epochs=0",
                         "--run_validation=True"))
    assert "Loaded pre-trained values." in capsys.readouterr().out
    assert out["steps"] == 3
    for k in ("zt", "m", "H"):
        torch.testing.assert_close(getattr(out["state"], k), sd[k], rtol=0,
                                   atol=0)
    imp = impute.main(["--model_dir", str(save), "--data_csv",
                       os.path.join(data_dir, "test_data_D4.csv"),
                       "--mask_csv", os.path.join(data_dir, "test_mask.csv"),
                       "--out_csv", str(tmp_path / "imputed.csv"),
                       "--device", "cpu"])
    assert imp.shape == (80, 1296) and np.isfinite(imp).all()


@pytest.mark.parametrize("flag", ["--compute_dtype=bfloat16",
                                  "--model_dtype=bfloat16",
                                  "--fused_conv=True"])
def test_toy_run_with_a_model_option(data_dir, tmp_path, flag):
    """hlax's model options run through the CLI: finite losses, the model
    built with the option, the eval-only rerun from arguments.pkl rebuilds
    it the same way."""
    save = tmp_path / "run"
    out = cli.main(_argv(data_dir, save, flag, "--run_validation=True"))
    assert all(math.isfinite(v) for v in out["loss_arrs"]["net"])
    model = out["model"]
    if flag == "--compute_dtype=bfloat16":
        assert model.cfg.compute_dtype == torch.bfloat16
        assert model.mean_layer.weight.dtype == torch.float32
    elif flag == "--model_dtype=bfloat16":
        assert model.cfg.compute_dtype is None
        assert all(p.dtype == torch.bfloat16 for p in model.parameters())
        assert out["state"].zt.dtype == torch.float32
    else:
        assert model.cfg.fused_conv
    rows = _read_rows(save / "results" / "validation_results.csv")
    assert all(math.isfinite(v) for v in rows.values())
    again = cli.main([f"--f={CONFIG}", f"--data_source_path={data_dir}",
                      f"--save_path={save}", "--epochs=0", "--device=cpu",
                      "--run_validation=False", "--run_tests=False",
                      "--generate_images=False"])
    for key in ("compute_dtype", "fused_conv", "conv", "z_dim"):
        assert getattr(again["model"].cfg, key) == getattr(model.cfg, key)
    assert next(again["model"].parameters()).dtype == \
        next(model.parameters()).dtype


def test_eval_only_rerun_reloads_arguments_and_weights(data_dir, tmp_path,
                                                       capsys):
    """A 3-epoch run saves arguments.pkl and final.pt; a rerun with
    --epochs=0 takes the model options from arguments.pkl (not from its own
    command line), warm-starts from final.pt and only evaluates."""
    save = tmp_path / "run"
    trained = cli.main(_argv(data_dir, save))
    capsys.readouterr()
    out = cli.main([f"--f={CONFIG}", f"--data_source_path={data_dir}",
                    f"--save_path={save}", "--epochs=0", "--device=cpu",
                    "--run_validation=True", "--run_tests=False",
                    "--generate_images=False"])
    assert "Loaded pre-trained values." in capsys.readouterr().out
    assert out["steps"] == 6 and out["model"].cfg.z_dim == 4
    torch.testing.assert_close(out["state"].zt, trained["state"].zt,
                               rtol=0, atol=0)
    assert os.path.isfile(save / "results" / "validation_results.csv")


def test_early_stopping_saves_the_early_best_checkpoint(data_dir, tmp_path,
                                                        capsys):
    """Under early stopping, validation after epoch 100 that improves saves
    early_best.pt, and no final checkpoint; a rerun with early stopping
    warm-starts from early_best.pt."""
    save = tmp_path / "run"
    cli.main(_argv(data_dir, save, "--epochs=105", "--subjects_per_batch=4",
                   "--early_stopping=True", "--run_validation=True"))
    printed = capsys.readouterr().out
    assert "Best epoch is 105" in printed
    assert os.path.isfile(save / "early_best.pt")
    assert not os.path.isfile(save / "final.pt")
    assert not os.path.isfile(save / "arguments.pkl")
    out = cli.main(_argv(data_dir, save, "--epochs=0", "--subjects_per_batch=4",
                         "--early_stopping=True"))
    assert "Loaded pre-trained values." in capsys.readouterr().out
    assert out["steps"] == 105


def test_entry_points_never_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
