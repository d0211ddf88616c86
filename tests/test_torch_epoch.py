"""The port's epoch function against hlax's one-dispatch epoch, the
in-place train step, the CLI's bursts of epochs and ``--profile_dir``, on
the CPU (where ``make_train_epoch`` runs its steps eagerly; its CUDA graphs
are held against the eager steps on the card by ``chip_smoke.py``).

The hlax comparison: a conv HLVAE on generated D4 data (z=8, hidden 16,
M=30, natural gradients), 7 ragged subjects in batches of 3 (the last
padded), two epochs of three batches, float64, each step's
reparameterization noise drawn from hlax's rng chain and injected into the
port's steps; held at ``tests/test_torch_step.py``'s bar.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hlax.data import dataset as jds
from hlax.data.reader import encode_raw
from hlax.gp import kernels as jk
from hlax.models import HLVAE, HLVAEConfig
from hlax.train import step as jstep
from hlax_torch.cli import generate as gen_cli
from hlax_torch.cli import main as cli
from hlax_torch.config import ModelArgs
from hlax_torch.convert import state_from_hlax
from hlax_torch.data import dataset as tds
from hlax_torch.data import generate as tgen
from hlax_torch.data.reader import encode_raw as t_encode_raw
from hlax_torch.gp import kernels as tk
from hlax_torch.models import hlvae as thlvae
from hlax_torch.ops import linalg_small as tls
from hlax_torch.train import checkpoint as tckpt
from hlax_torch.train import step as tstep

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "hlvae_config_file.txt")
LENGTHS = [5, 4, 5, 3, 5, 5, 2]
S, L, M, HID = 3, 8, 30, 16
SPEC_ARGS = ([2], [], [0],
             [{"cat_covariate": 3, "cont_covariate": 0},
              {"cat_covariate": 4, "cont_covariate": 1},
              {"cat_covariate": 2, "cont_covariate": 0}], [], [], 2)


@pytest.fixture(scope="module")
def setup():
    """hlax's and the port's datasets, staged, and two equal train states;
    the subject batches of two epochs and each step's noise."""
    out = tgen.generate(num_3=4, num_6=3, missing=25.0, datatype_config="D4",
                        seed=9)
    keep = np.concatenate([np.arange(20 * s, 20 * s + t)
                           for s, t in enumerate(LENGTHS)])
    raw, miss = out["data"][keep], out["mask"][keep]
    labels = np.nan_to_num(
        out["labels"][keep][:, tds.HEALTH_MNIST_LABEL_ORDER])
    types = tgen.types_table("D4")
    het = encode_raw(raw, types, miss_mask=miss)
    t_het = t_encode_raw(raw, types, miss_mask=miss)
    het.labels, t_het.labels = labels, labels
    jset = jds.LongitudinalDataset(het=het, labels=labels, id_covariate=2)
    tset = tds.LongitudinalDataset(het=t_het, labels=labels, id_covariate=2)
    P, T = jset.P, jset.T_max

    rng = np.random.default_rng(7)
    cfg = HLVAEConfig(layout=het.layout, z_dim=L, h_dims=(HID,), y_dim=5,
                      conv=True, dtype=jnp.float64)
    model = HLVAE(cfg)
    key = jax.random.PRNGKey(3)
    vae = model.init(key, jnp.asarray(het.data[:4]), jnp.asarray(het.mask[:4]),
                     jnp.asarray(het.theta_mask[:4]), key)
    spec0, spec1 = jk.build_kernel_specs(*SPEC_ARGS)
    k0 = [{k: v + 0.3 * rng.standard_normal(v.shape) for k, v in p.items()}
          for p in jk.init_kernel_params(spec0, L, jnp.float64)]
    k1 = [{k: v + 0.3 * rng.standard_normal(v.shape) for k, v in p.items()}
          for p in jk.init_kernel_params(spec1, L, jnp.float64)]
    zt = np.stack([labels[rng.choice(len(labels), M)] for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    m = rng.standard_normal((L, M, 1)) * 0.1
    Hh = rng.standard_normal((L, M, M)) / 3.0
    H = Hh @ Hh.transpose(0, 2, 1) + 0.5 * np.eye(M)
    raw_noise = jk.noise_init(L, True, jnp.float64)
    jcfg = jstep.TrainConfig(latent_dim=L, M=M, P_tot=float(P),
                             N_tot=float(len(labels)), id_covariate=2,
                             natural_gradient=True, constrain_scales=True,
                             gp_dtype=jnp.float64, eps=1e-4)
    jstate = jstep.TrainState(
        vae=vae, k0=k0, k1=k1, raw_noise=raw_noise, zt=jnp.asarray(zt),
        m=jnp.asarray(m), H=jnp.asarray(H), opt_state=None,
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(42))
    jstate = jstate._replace(opt_state=jstep.make_optimizer(jcfg).init(
        jstep._trainable(jstate, jcfg)))
    tcfg = tstep.TrainConfig(latent_dim=L, M=M, P_tot=float(P),
                             N_tot=float(len(labels)), id_covariate=2,
                             natural_gradient=True, constrain_scales=True,
                             gp_dtype=torch.float64, eps=1e-4)
    tspec = tk.build_kernel_specs(*SPEC_ARGS)

    def port_state():
        tmodel = thlvae.HLVAE(thlvae.HLVAEConfig(
            layout=t_het.layout, z_dim=L, h_dims=(HID,), y_dim=5, conv=True),
            torch.Generator().manual_seed(0), "cpu").double()
        npp = lambda ps: [{k: np.asarray(v) for k, v in p.items()}
                          for p in ps]
        return state_from_hlax(vae, npp(k0), npp(k1), np.asarray(raw_noise),
                               zt, m, H, tmodel, tcfg)

    idx_rng = np.random.default_rng(0)
    epochs = [np.stack(list(jds.epoch_subject_batches(P, S, idx_rng)))
              for _ in range(2)]
    # hlax's step draws its noise from split(state.rng)[1], [S*T, z]
    noise, r = [], jstate.rng
    for _ in range(sum(len(e) for e in epochs)):
        r, sub = jax.random.split(r)
        noise.append(np.asarray(jax.random.normal(sub, (S * T, L),
                                                  jnp.float64)))
    return dict(jset=jset, tset=tset, model=model, spec=(spec0, spec1),
                tspec=tspec, jcfg=jcfg, tcfg=tcfg, jstate=jstate,
                port_state=port_state, epochs=epochs, noise=np.stack(noise),
                staged_j=jds.stage_dataset(jset, jnp.float64),
                staged_t=tds.stage_dataset(tset, torch.float64, "cpu"))


def test_gather_epoch_matches_hlax(setup):
    idx = np.concatenate(setup["epochs"])
    want = jds.gather_epoch(setup["staged_j"], jnp.asarray(idx))
    got = tds.gather_epoch(setup["staged_t"], torch.as_tensor(idx))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert (idx < 0).any()   # padding subjects are in it


@pytest.mark.parametrize("pregather", [False, True])
def test_two_epochs_match_hlax(setup, pregather):
    """Two epochs of three batches through hlax's jitted
    ``make_train_epoch`` and the port's: the metrics of every step, then
    the GP state and Adam's zt."""
    s = setup
    jepoch = jax.jit(jstep.make_train_epoch(s["model"], *s["spec"],
                                            s["jcfg"], pregather=pregather))
    jstate, tstate = s["jstate"], s["port_state"]()
    tepoch = tstep.make_train_epoch(tstate.vae, *s["tspec"], s["tcfg"],
                                    unroll=2, pregather=pregather)
    step0 = 0
    for idx in s["epochs"]:
        jstate, mj = jepoch(jstate, s["staged_j"], jnp.asarray(idx))
        mt = tepoch(tstate, s["staged_t"], idx,
                    eps=torch.as_tensor(s["noise"][step0:step0 + len(idx)]))
        step0 += len(idx)
        assert set(mt) == set(tstep.METRICS)
        for k in tstep.METRICS:
            assert mt[k].shape == (len(idx),)
            np.testing.assert_allclose(mt[k], np.asarray(mj[k]), rtol=1e-6)
    assert tstate.step == step0 == int(jstate.step)
    for a, b in ((tstate.m, jstate.m), (tstate.H, jstate.H),
                 (tstate.zt, jstate.zt)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5,
                                   atol=1e-7 * np.abs(b).max())


def _tensors(state):
    ts = {"m": state.m, "H": state.H}
    for i, p in enumerate(state.optimizer.param_groups[0]["params"]):
        ts[f"param{i}"] = p
        for k, v in state.optimizer.state[p].items():
            ts[f"adam{i}.{k}"] = v
    return ts


def _grads(state):
    return [p.grad for p in state.optimizer.param_groups[0]["params"]]


def test_step_updates_the_state_in_place(setup):
    """After the first step (which makes Adam's state), every tensor of the
    state keeps its storage: m, H, each parameter and its Adam moments.
    The gradients are not state: each step writes every one of them once,
    into a tensor of its own (a CUDA graph keeps them in its pool)."""
    state = setup["port_state"]()
    step = tstep.make_train_step(state.vae, *setup["tspec"], setup["tcfg"])
    batches = [tds.gather_batch(setup["staged_t"], torch.as_tensor(i))
               for i in setup["epochs"][0]]
    m0, H0 = state.m.clone(), state.H.clone()
    step(state, batches[0])
    ptrs = {k: t.data_ptr() for k, t in _tensors(state).items()}
    assert sum(k.startswith("adam") for k in ptrs) > 10
    for b in batches[1:]:
        before = _grads(state)
        step(state, b)
        assert all(g is not None and g is not g0
                   for g, g0 in zip(_grads(state), before))
    assert {k: t.data_ptr() for k, t in _tensors(state).items()} == ptrs
    assert not torch.equal(state.m, m0) and not torch.equal(state.H, H0)


def test_gradients_written_once_equal_zero_then_add(setup, monkeypatch):
    """The steps with each gradient written once (``write_grads``) equal,
    bit for bit, the steps that zero a persistent ``.grad`` and let the
    backward pass add into it (the step before gradients were written
    once): metrics, parameters, Adam's moments, m and H over three steps."""
    batches = [tds.gather_batch(setup["staged_t"], torch.as_tensor(i))
               for i in setup["epochs"][0]]
    eps = torch.as_tensor(setup["noise"][:len(batches)])

    def run():
        state = setup["port_state"]()
        step = tstep.make_train_step(state.vae, *setup["tspec"],
                                     setup["tcfg"])
        ms = [step(state, b, eps=e) for b, e in zip(batches, eps)]
        return state, ms

    def zero_then_add(loss, params):
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()
        if loss.requires_grad:
            loss.backward()

    once, m_once = run()
    monkeypatch.setattr(tstep, "write_grads", zero_then_add)
    added, m_added = run()
    for a, b in zip(m_once, m_added):
        assert all(torch.equal(a[k], b[k]) for k in tstep.METRICS)
    ta, tb = _tensors(once), _tensors(added)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    for ga, gb in zip(_grads(once), _grads(added)):
        assert torch.equal(ga, gb)


def test_restored_checkpoint_takes_the_same_next_step(setup, tmp_path):
    """The generator's state and Adam's come back with the checkpoint: the
    restored state's next step (noise drawn from the generator) equals the
    original's."""
    a = setup["port_state"]()
    step = tstep.make_train_step(a.vae, *setup["tspec"], setup["tcfg"])
    batches = [tds.gather_batch(setup["staged_t"], torch.as_tensor(i))
               for i in setup["epochs"][0]]
    step(a, batches[0])
    step(a, batches[1])
    tckpt.save(str(tmp_path), a)
    b = setup["port_state"]()
    assert tckpt.restore(str(tmp_path), b)
    assert b.step == 2
    step_b = tstep.make_train_step(b.vae, *setup["tspec"], setup["tcfg"])
    ma, mb = step(a, batches[2]), step_b(b, batches[2])
    for k in tstep.METRICS:
        assert ma[k].item() == mb[k].item()
    assert torch.equal(a.m, b.m) and torch.equal(a.H, b.H)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_launch_counts_taken_and_added():
    """What a capture counted comes back out of the counters, and each
    replay adds it again."""
    tls.reset_counters()
    tls.LAUNCHES["chol_inv_mid_cuda"] = 3
    before = tls._COUNTERS.snapshot()
    key = ("chol_inv_small_cuda", (2, 20, 20), "float32")
    tls.LAUNCHES["chol_inv_small_cuda"] += 2
    tls.LAUNCHES_BY_SHAPE[key] = 2
    gained = tls._COUNTERS.take_since(before)
    assert tls.LAUNCHES["chol_inv_small_cuda"] == 0
    assert tls.LAUNCHES["chol_inv_mid_cuda"] == 3 and not tls.LAUNCHES_BY_SHAPE
    tls._COUNTERS.add(gained, times=5)
    assert tls.LAUNCHES["chol_inv_small_cuda"] == 10
    assert tls.LAUNCHES_BY_SHAPE == {key: 10}
    tls.reset_counters()


# ---- the CLI -----------------------------------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    gen_cli.main(["--destination", d, "--num_3", "2", "--num_6", "2",
                  "--datatype_config", "D4", "--seed", "3",
                  "--splits", "prediction,test,validation"])
    return d


def _run(data_dir, save, *extra):
    opt = ModelArgs().parse_options([
        f"--f={CONFIG}", f"--data_source_path={data_dir}",
        f"--save_path={save}", "--run_validation=False", "--run_tests=False",
        "--generate_images=False", "--device=cpu", "--latent_dim=4",
        "--M=30", "--hidden_layers=[20]", "--subjects_per_batch=3", *extra])
    return cli.run(opt)


def _iter_lines(text):
    """The per-epoch lines without their Time column."""
    return [line.split(" - Time:")[0] + line.split("  - Loss:")[1]
            for line in text.splitlines() if line.startswith("Iter ")]


def test_bursts_give_the_per_epoch_results(data_dir, tmp_path, capsys):
    """--epochs_per_dispatch=3 trains the same epochs as 1: the same loss
    arrays and per-epoch lines (but the Time column)."""
    one = _run(data_dir, str(tmp_path / "a"), "--epochs=4")
    lines_one = _iter_lines(capsys.readouterr().out)
    three = _run(data_dir, str(tmp_path / "b"), "--epochs=4",
                 "--epochs_per_dispatch=3")
    lines_three = _iter_lines(capsys.readouterr().out)
    assert len(lines_one) == 4 and lines_three == lines_one
    assert three["loss_arrs"] == one["loss_arrs"]
    assert one["steps"] == three["steps"] == 8
    assert len(three["epoch_seconds"]) == 4
    assert three["epoch_seconds"][0] == three["epoch_seconds"][2]


def test_burst_stops_at_a_validation_epoch(data_dir, tmp_path, monkeypatch):
    """With validation every 5 epochs a burst of up to 4 never crosses
    epoch 5: the epoch function gets epochs 1-4, 5 and 6-7."""
    calls = []
    make = tstep.make_train_epoch

    def recording(*a, **kw):
        epoch = make(*a, **kw)

        def wrapped(state, staged, idx, eps=None):
            calls.append(len(idx))
            return epoch(state, staged, idx, eps)
        return wrapped

    monkeypatch.setattr(tstep, "make_train_epoch", recording)
    out = _run(data_dir, str(tmp_path / "run"), "--epochs=7",
               "--epochs_per_dispatch=4", "--run_validation=True",
               "--save_interval=100")
    nb = 2   # 4 subjects, 3 a batch
    assert calls == [4 * nb, nb, 2 * nb]
    assert out["steps"] == 7 * nb
    assert out["last_validation"] is not None


def test_profile_dir_writes_a_trace_of_epoch_2(data_dir, tmp_path, capsys,
                                               monkeypatch):
    prof = tmp_path / "prof"
    _run(data_dir, str(tmp_path / "run"), "--epochs=3",
         f"--profile_dir={prof}")
    assert os.listdir(prof) == ["epochs_2-2.pt.trace.json"]
    with open(prof / "epochs_2-2.pt.trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert "Wrote a profiler trace of epochs 2-2" in capsys.readouterr().out

    def broken(*a, **kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    out = _run(data_dir, str(tmp_path / "run2"), "--epochs=3",
               f"--profile_dir={tmp_path / 'prof2'}")
    assert out["steps"] == 6
    assert "Profiler failed to start (continuing)" in capsys.readouterr().out
