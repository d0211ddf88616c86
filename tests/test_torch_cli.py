"""The port's training CLI, train-only, on a tiny generated dataset (CPU)."""
import math
import os

import pytest
import torch

from hlax_torch import resolve_device
from hlax_torch.cli import main as cli
from hlax_torch.config import ModelArgs
from hlax_torch.data import generate as gen
from hlax_torch.ops import linalg_small as ls

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "hlvae_config_file.txt")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    out = gen.generate(num_3=2, num_6=2, missing=25.0,
                       datatype_config="D4", seed=3)
    gen.write_csvs(out, d, "D4", prefix="prediction_")
    os.replace(os.path.join(d, "prediction_data.csv"),
               os.path.join(d, "prediction_data_D4.csv"))
    os.replace(os.path.join(d, "prediction_labels.csv"),
               os.path.join(d, "prediction_label.csv"))
    return d


def _argv(data_dir, save, *extra):
    return [f"--f={CONFIG}", f"--data_source_path={data_dir}",
            f"--save_path={save}", "--epochs=2", "--run_validation=False",
            "--run_tests=False", "--generate_images=False", "--device=cpu",
            "--latent_dim=4", "--M=30", "--hidden_layers=[20]",
            "--subjects_per_batch=3", *extra]


def test_two_epoch_train_only_run(data_dir, tmp_path, capsys):
    """Canonical config at toy width: 4 subjects, 3 a batch -> 2 steps an
    epoch (the second batch padded); M=30 takes the mid Cholesky path."""
    ls.reset_counters()
    out = cli.main(_argv(data_dir, tmp_path / "run"))
    printed = capsys.readouterr().out
    assert "Iter 1/2 - Time:" in printed and "Iter 2/2 - Time:" in printed
    assert out["steps"] == 4
    assert all(math.isfinite(v) for v in out["loss_arrs"]["net"])
    assert os.path.isfile(tmp_path / "run" / "final.pt")
    sd = torch.load(tmp_path / "run" / "final.pt", weights_only=False)
    assert sd["step"] == 4 and sd["H"].shape == (4, 30, 30)
    # on the CPU the plain versions run, and nothing counts as a launch
    assert ls.LAUNCHES == {"chol_inv_small_cuda": 0, "chol_inv_mid_cuda": 0}


@pytest.mark.parametrize("flag", ["--run_validation=True",
                                  "--run_tests=True",
                                  "--generate_images=True"])
def test_eval_flags_are_refused(data_dir, tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(_argv(data_dir, tmp_path / "run", flag))


def test_config_file_alone_is_refused_until_eval_is_ported():
    """The canonical config asks for validation, tests and images."""
    opt = ModelArgs().parse_options([f"--f={CONFIG}"])
    with pytest.raises(NotImplementedError, match="run_validation"):
        cli.run(opt)


def test_entry_points_never_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
