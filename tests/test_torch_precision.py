"""hlax's precision split in the port (``hlax_torch.precision``): the VAE's
float32 convolutions and dense layers in TF32, forward and backward, the GP
in full float32, as hlax runs its GP at "highest" (``hlax/gp/elbo.py:31-43``)
and its VAE at JAX's default precision.

The CPU has no TF32, so these tests read the flags: a dispatch mode records
every matmul and convolution with the TF32 flags in force when it runs, and
each is told to the VAE or not by where its forward operation was called
(the Python stack; in the backward pass, the autograd node's forward
traceback under anomaly mode).  On the CPU the policy must give the bits of
full float32.  The card's own checks are in ``test_torch_cuda.py``.
"""
import math
import os
import re
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from jax import lax

from hlax_torch import precision
from hlax_torch.cli import generate as gen_cli
from hlax_torch.cli import impute as timpute
from hlax_torch.cli import main as cli
from hlax_torch.data.reader import encode_raw
from hlax_torch.gp import elbo as gp_elbo
from hlax_torch.gp import kernels as tk
from hlax_torch.models import hlvae as thlvae
from hlax_torch.train import step as tstep

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "hlvae_config_file.txt")
S, T, L, M, HID = 2, 3, 4, 6, 8
N_REAL, N_CAT, NCLASS = 324, 972, 5
SPEC_ARGS = ([2], [], [0], [{"cat_covariate": 3, "cont_covariate": 0}],
             [], [], 2)
# (under inference mode the dispatch mode sees the composite operations,
# linear, einsum and conv2d, where autograd would decompose them)
MATMULS = ("mm", "addmm", "bmm", "matmul", "linear", "einsum", "conv2d",
           "conv_transpose2d", "convolution", "convolution_backward")
# the files whose operations are the VAE's convolutions and dense layers:
# the model, the conv lowerings and the TF32 Functions they call; but the
# observation heads (the model's ``_head``, the plain version of the fused
# heads kernel), which keep their 5-wide products in full float32
VAE_FILES = ("models/hlvae.py", "ops/convfuse.py", "hlax_torch/precision.py")
NOT_VAE = ("_head",)
MODELS = {"conv": {"conv": True}, "mlp": {"conv": False},
          "fused_conv": {"conv": True, "fused_conv": True}}


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _is_gp(frames) -> bool:
    """Whether ``frames`` pass through the GP (``hlax_torch/gp/``)."""
    return any("hlax_torch/gp/" in f.replace(os.sep, "/") for f, _ in frames)


def _is_vae(frames) -> bool:
    """Whether the innermost frame of the port in ``frames`` ((file,
    function), outermost first) is the VAE's."""
    port = [(f.replace(os.sep, "/"), fn) for f, fn in frames
            if "hlax_torch" in f]
    return bool(port) and port[-1][0].endswith(VAE_FILES) \
        and port[-1][1] not in NOT_VAE


class Recorder(TorchDispatchMode):
    """Every matmul and convolution run under it: (op, forward or backward,
    the VAE's or not, the TF32 flags in force, the GP's or not)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in MATMULS:
            node = torch._C._current_autograd_node()
            if node is None:
                frames = [(f.filename, f.name)
                          for f in traceback.extract_stack()]
                phase = "forward"
            else:
                tb = node.metadata.get("traceback_") or []
                frames = [m for s in tb for m in re.findall(
                    r'File "([^"]+)", line \d+, in (\S+)', s)]
                phase = "backward"
            self.ops.append((name, phase, _is_vae(frames), _flags(),
                             _is_gp(frames)))
        return func(*args, **(kwargs or {}))


def _toy(model="conv", prec=precision.DEFAULT, dtype=torch.float32,
         **model_kw):
    """A canonical-layout (D4: 324 real, 972 cat(5)) toy step: S subjects x
    T, z = L, hidden HID, M inducing points; (state, step, batch, eps)."""
    rng = np.random.default_rng(7)
    n = S * T
    raw = np.column_stack([rng.random((n, N_REAL)) * 255,
                           rng.integers(0, NCLASS, (n, N_CAT)).astype(float)])
    miss = (rng.random(raw.shape) > 0.25).astype(float)
    types = ([{"type": "real", "dim": 1, "nclass": 1}] * N_REAL
             + [{"type": "cat", "dim": 1, "nclass": NCLASS}] * N_CAT)
    het = encode_raw(raw, types, miss_mask=miss)
    labels = np.zeros((n, 5))
    labels[:, 0] = np.tile(np.arange(T), S)
    labels[:, 1] = np.repeat(rng.integers(-9, 11, S), T)
    labels[:, 2] = np.repeat(np.arange(S), T)
    labels[:, 3] = np.repeat(rng.integers(0, 2, S), T)
    # the batch and the noise in the model's dtype (the CLI's staging), the
    # GP in float32 but for the float64 model
    gdt = torch.float64 if dtype == torch.float64 else torch.float32
    batch = {k: torch.tensor(v, dtype=dtype) for k, v in (
        ("data", het.data), ("mask", het.mask),
        ("theta_mask", het.theta_mask), ("labels", labels),
        ("valid", np.ones((S, T))))}
    cfg = tstep.TrainConfig(latent_dim=L, M=M, P_tot=10.0, N_tot=30.0,
                            id_covariate=2, gp_dtype=gdt)
    mcfg = thlvae.HLVAEConfig(layout=het.layout, z_dim=L, h_dims=(HID,),
                              precision=prec, **MODELS[model], **model_kw)
    vae = thlvae.HLVAE(mcfg, torch.Generator().manual_seed(0),
                       "cpu").to(dtype)
    spec0, spec1 = tk.build_kernel_specs(*SPEC_ARGS)
    state = tstep.init_train_state(vae, spec0, spec1,
                                   {"labels": labels, "idx": np.arange(n)},
                                   cfg)
    eps = torch.randn((n, L), generator=torch.Generator().manual_seed(1)
                      ).to(dtype)
    return state, tstep.make_train_step(vae, spec0, spec1, cfg), batch, eps


@pytest.mark.parametrize("name", sorted(precision.NAMES))
def test_names_follow_jax(name):
    """Each of JAX's names means TF32 on the card exactly where JAX's GPU
    backend takes TF32: DEFAULT and HIGH; HIGHEST is float32."""
    assert precision.uses_tf32(name) == (
        lax.Precision(name) != lax.Precision.HIGHEST)


def test_every_jax_alias_is_known_and_others_are_refused(monkeypatch):
    from jax._src.lax.lax import _precision_strings

    assert {k for k in _precision_strings if isinstance(k, str)} == set(
        precision.NAMES)
    for bad in ("HIGHEST", "tf32", "F32_F32_F32"):
        with pytest.raises(ValueError):
            precision.uses_tf32(bad)
        monkeypatch.setenv(precision.ENV, bad)
        with pytest.raises(ValueError):
            precision.from_env()
    with pytest.raises(ValueError):
        thlvae.HLVAEConfig(layout=None, precision="fast")


def test_environment_variable_sets_the_precision(monkeypatch):
    monkeypatch.delenv(precision.ENV, raising=False)
    assert precision.from_env() == "default" == precision.DEFAULT
    monkeypatch.setenv(precision.ENV, "")
    assert precision.from_env() == "default"
    for name in ("highest", "tensorfloat32", "float32"):
        monkeypatch.setenv(precision.ENV, name)
        assert precision.from_env() == name


@pytest.mark.parametrize("model", sorted(MODELS))
def test_step_runs_the_vae_in_tf32_and_the_gp_in_float32(model):
    """One train step under the default policy: every VAE convolution and
    dense matmul sees TF32, forward and backward; every other matmul (the
    GP's, the heads') sees full float32; the flags are off afterwards."""
    state, step, batch, eps = _toy(model)
    rec = Recorder()
    with torch.autograd.set_detect_anomaly(True), rec:
        step(state, batch, eps=eps)
    assert _flags() == (False, False)
    vae = [(n, p) for n, p, v, *_ in rec.ops if v]
    assert all(f == (True, True) for _, _, v, f, _ in rec.ops if v), rec.ops
    assert all(f == (False, False) for _, _, v, f, _ in rec.ops if not v)
    assert ("addmm", "forward") in vae and ("mm", "backward") in vae
    if model == "conv":
        assert {("convolution", "forward"),
                ("convolution_backward", "backward")} <= set(vae)
    if model == "fused_conv":
        assert ("mm", "forward") in vae
    gp = {n for n, _, v, *_ in rec.ops if not v}
    assert "bmm" in gp


@pytest.mark.parametrize("model", sorted(MODELS))
def test_policy_gives_full_float32_bits_on_the_cpu(model):
    """The TF32 Functions make autograd's own operations: on the CPU, where
    TF32 changes nothing, three steps under "default" and under "highest"
    give the same loss and state to the bit; "highest" runs nothing under
    TF32 (the plain operations, as before the policy)."""
    runs = {}
    for prec in ("highest", "default"):
        state, step, batch, eps = _toy(model, prec)
        rec = Recorder()
        with rec:
            losses = [step(state, batch, eps=eps)["loss"] for _ in range(3)]
        runs[prec] = (losses, list(state.vae.parameters()), state.m,
                      state.H, state.zt, rec.ops)
    (la, pa, *ga, ops_a), (lb, pb, *gb, _) = runs["highest"], runs["default"]
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    assert ops_a and all(f == (False, False) for _, _, _, f, _ in ops_a)


@pytest.mark.parametrize("option", ["float64", "compute_dtype=bfloat16",
                                    "model_dtype=bfloat16"])
def test_other_dtypes_leave_the_flags_untouched(option):
    """The policy applies where the stacks compute in float32: a float64
    model and both bfloat16 options run every operation with TF32 off."""
    kw = {"float64": dict(dtype=torch.float64),
          "compute_dtype=bfloat16": dict(compute_dtype=torch.bfloat16),
          "model_dtype=bfloat16": dict(dtype=torch.bfloat16)}[option]
    state, step, batch, eps = _toy("conv", **kw)
    rec = Recorder()
    with rec:
        loss = step(state, batch, eps=eps)["loss"]
    assert math.isfinite(loss.item())
    assert rec.ops and all(f == (False, False) for _, _, _, f, _ in rec.ops)


def test_flags_are_restored_after_an_exception():
    with pytest.raises(RuntimeError, match="inside"):
        with precision.tf32():
            assert _flags() == (True, True)
            raise RuntimeError("inside")
    assert _flags() == (False, False)
    with pytest.raises(RuntimeError):
        precision.linear(torch.ones(2, 3), torch.ones(4, 5), torch.ones(4))
    assert _flags() == (False, False)
    # an ambient setting comes back as it was, not as off
    with precision.tf32():
        with precision.tf32(False):
            assert _flags() == (False, False)
        assert _flags() == (True, True)
    assert _flags() == (False, False)


def test_gp_runs_in_float32_under_an_ambient_tf32():
    """The bound, its backward pass and the natural-gradient update run
    every matmul in full float32 even inside a TF32 block: the entry points
    are under ``precision.highest`` (hlax's ``_highest_precision``), the
    step's backward under full float32."""
    state, step, batch, eps = _toy("conv")
    rec = Recorder()
    with torch.autograd.set_detect_anomaly(True), precision.tf32(), rec:
        step(state, batch, eps=eps)
        assert _flags() == (True, True)
    assert _flags() == (False, False)
    gp = [(p, f) for _, p, _, f, g in rec.ops if g]
    assert {p for p, _ in gp} == {"forward", "backward"}
    assert all(f == (False, False) for _, f in gp)
    # the natural-gradient update alone
    rec = Recorder()
    g = torch.eye(M).expand(L, M, M) * 0.1
    with precision.tf32(), rec:
        gp_elbo.natural_gradient_update(state.m, state.H, state.m * 0.1, g,
                                        0.01)
    assert rec.ops and all(f == (False, False) for _, _, _, f, _ in rec.ops)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    gen_cli.main(["--destination", d, "--num_3", "2", "--num_6", "2",
                  "--datatype_config", "D4", "--seed", "3",
                  "--splits", "prediction,test,validation"])
    return d


def test_cli_reads_the_environment_and_every_path_follows_it(
        data_dir, tmp_path, monkeypatch):
    """The training CLI (train, validation, tests) and the imputation CLI
    take the precision from JAX_DEFAULT_MATMUL_PRECISION: unset, the VAE's
    operations run in TF32 and nothing else does; "highest", nothing runs
    in TF32.  The flags are off after each entry point."""
    save = tmp_path / "run"
    argv = [f"--f={CONFIG}", f"--data_source_path={data_dir}",
            f"--save_path={save}", "--epochs=3", "--run_validation=True",
            "--run_tests=True", "--generate_images=False", "--device=cpu",
            "--latent_dim=4", "--M=30", "--hidden_layers=[20]",
            "--subjects_per_batch=3"]
    monkeypatch.delenv(precision.ENV, raising=False)
    rec = Recorder()
    with rec:
        out = cli.main(argv)
    assert out["model"].cfg.precision == "default"
    assert _flags() == (False, False)
    fwd = [(v, f) for _, p, v, f, _ in rec.ops if p == "forward"]
    assert sum(v for v, _ in fwd) > 3 * 2 * 4     # the eval passes' too
    assert all(f == (v, v) for v, f in fwd)
    csv = os.path.join(data_dir, "test_data_D4.csv")
    mask = os.path.join(data_dir, "test_mask.csv")
    for env, tf32 in (("default", True), ("highest", False)):
        monkeypatch.setenv(precision.ENV, env)
        rec = Recorder()
        with rec:
            timpute.run_impute(str(save), csv, str(tmp_path / f"{env}.csv"),
                               mask_csv=mask, device="cpu")
        assert _flags() == (False, False)
        assert any(v for _, _, v, *_ in rec.ops)
        assert all(f == (v and tf32,) * 2 for _, _, v, f, _ in rec.ops)
    monkeypatch.setenv(precision.ENV, "highest")
    again = cli.main([f"--f={CONFIG}", f"--data_source_path={data_dir}",
                      f"--save_path={save}", "--epochs=0", "--device=cpu",
                      "--run_validation=False", "--run_tests=False",
                      "--generate_images=False"])
    assert again["model"].cfg.precision == "highest"
