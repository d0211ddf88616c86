"""The port's MLP model (``conv=False``) and its CLI battery against hlax,
float64 on the CPU, on the tabular dataset of ``tests/test_nonconv.py``
(real, cat(3), count and pos columns; the last label column a unique row
index, which the non-conv unseen-row rule reads).

Identical weights (hlax's flax init carried across by
``hlax_torch.convert``) and noise: the model's forward and parameter
gradients are held to 1e-8, the validation rows and the test battery to
1e-6 (the bar of the port's other model-level tests).
"""
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hlax.cli import main as jmain
from hlax.config import ModelArgs as JModelArgs
from hlax.data.dataset import LongitudinalDataset
from hlax.data.reader import encode_raw
from hlax.eval import testing as jtest
from hlax.eval import validate as jval
from hlax.gp import kernels as jk
from hlax.models import HLVAE, HLVAEConfig
from hlax.models.hlvae import nll_from_log_p
from hlax.train import checkpoint as jckpt
from hlax.train import step as jstep
from hlax_torch.cli import main as tmain
from hlax_torch.convert import load_hlax_vae, state_from_hlax
from hlax_torch.data.dataset import LongitudinalDataset as TDataset
from hlax_torch.data.reader import encode_raw as t_encode_raw
from hlax_torch.eval import testing as ttest
from hlax_torch.eval import validate as tval
from hlax_torch.gp import kernels as tk
from hlax_torch.models import hlvae as thlvae
from hlax_torch.train import checkpoint as tckpt
from hlax_torch.train import step as tstep
from test_nonconv import TYPES, _make_split, _write_split

torch.set_num_threads(1)

L, M, HID, Y = 4, 8, 16, 3
SPEC_ARGS = ([2], [], [0], [{"cont_covariate": 0, "cat_covariate": 2}], [],
             [], 2)
MODEL_RTOL = 1e-6


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _models(het, t_het, logvar=False, seed=3):
    """hlax's MLP HLVAE from its flax init, and the port's with its
    weights."""
    cfg = HLVAEConfig(layout=het.layout, z_dim=L, h_dims=(HID,), y_dim=Y,
                      conv=False, logvar_network=logvar, dtype=jnp.float64)
    model = HLVAE(cfg)
    key = jax.random.PRNGKey(seed)
    params = model.init(key, jnp.asarray(het.data[:4]),
                        jnp.asarray(het.mask[:4]),
                        jnp.asarray(het.theta_mask[:4]), key)
    tmodel = thlvae.HLVAE(thlvae.HLVAEConfig(
        layout=t_het.layout, z_dim=L, h_dims=(HID,), y_dim=Y, conv=False,
        logvar_network=logvar), torch.Generator().manual_seed(0),
        "cpu").double()
    load_hlax_vae(tmodel, params)
    return model, params, tmodel


def _split(seed, n_subj, uid_start, subj_start):
    rng = np.random.default_rng(seed)
    raw, miss, labels = _make_split(rng, n_subj=n_subj, T=5,
                                    uid_start=uid_start,
                                    subj_start=subj_start)
    het = encode_raw(raw, TYPES, miss_mask=miss, logvar_network=False)
    t_het = t_encode_raw(raw, TYPES, miss_mask=miss, logvar_network=False)
    return het, t_het, labels


@pytest.mark.parametrize("logvar", [False, True])
def test_mlp_forward_and_parameter_gradients_match_hlax(logvar):
    """The MLP encoder on the normalized grouped data, ``y_layer`` reshaped
    straight to grouped order, no sigmoid on real means and no division by
    255: every output and every parameter gradient within 1e-8."""
    rng = np.random.default_rng(1)
    raw, miss, _ = _make_split(rng, n_subj=6, T=5, uid_start=0, subj_start=0)
    het = encode_raw(raw, TYPES, miss_mask=miss, logvar_network=logvar)
    t_het = t_encode_raw(raw, TYPES, miss_mask=miss, logvar_network=logvar)
    model, params, tmodel = _models(het, t_het, logvar)
    data, mask, tmask = (jnp.asarray(a, jnp.float64)
                         for a in (het.data, het.mask, het.theta_mask))
    key = jax.random.PRNGKey(11)

    def loss_j(p):
        out = model.apply(p, data, mask, tmask, key)
        loss = jnp.sum(nll_from_log_p(out["log_p_x"])) \
            + 0.1 * jnp.sum(out["mu"]) + 0.1 * jnp.sum(out["log_var"])
        return loss, out

    (lj, out_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)
    eps = (np.asarray(out_j["z"]) - np.asarray(out_j["mu"])) \
        / np.exp(0.5 * np.asarray(out_j["log_var"]))
    tmodel.zero_grad()
    out_t = tmodel(_t(het.data), _t(het.mask), _t(het.theta_mask),
                   eps=_t(eps))
    lt = thlvae.nll_from_log_p(out_t["log_p_x"]).sum() \
        + 0.1 * out_t["mu"].sum() + 0.1 * out_t["log_var"].sum()
    lt.backward()
    for k in ("mu", "log_var", "z", "log_p_x", "log_p_x_missing", "theta"):
        want = np.asarray(out_j[k])
        np.testing.assert_allclose(out_t[k].detach().numpy(), want,
                                   rtol=1e-8, atol=1e-8 * np.abs(want).max(),
                                   err_msg=k)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-8)
    gmodel = thlvae.HLVAE(tmodel.cfg, torch.Generator().manual_seed(1),
                          "cpu").double()
    load_hlax_vae(gmodel, grads_j)
    want = dict(gmodel.named_parameters())
    assert set(want) == {n for n, _ in tmodel.named_parameters()}
    assert not any(n.startswith(("conv", "deconv", "rep_")) for n in want)
    for name, p in tmodel.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        w = want[name].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=1e-8,
                                   atol=1e-8 * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)


@pytest.fixture(scope="module")
def mlp_setup():
    """Train (6 subjects), test (4, the first 5 rows' uids seen in
    training) and validation (3) splits of the non-conv dataset, the MLP
    model on both sides, and a float64 GP state with M = 8."""
    tr, t_tr, tr_lab = _split(3, 6, 0, 0)
    te, t_te, te_lab = _split(4, 4, 25, 6)
    va, t_va, va_lab = _split(5, 3, 100, 10)
    ds = {k: LongitudinalDataset(het=h, labels=lab, id_covariate=2,
                                 conv=False)
          for k, h, lab in (("train", tr, tr_lab), ("test", te, te_lab),
                            ("val", va, va_lab))}
    tds = {k: TDataset(het=h, labels=lab, id_covariate=2, conv=False)
           for k, h, lab in (("train", t_tr, tr_lab), ("test", t_te, te_lab),
                             ("val", t_va, va_lab))}
    model, params, tmodel = _models(tr, t_tr)
    rng = np.random.default_rng(9)
    spec0, spec1 = jk.build_kernel_specs(*SPEC_ARGS)
    perturb = lambda ps: [{k: np.asarray(v) + 0.3 * rng.standard_normal(
        v.shape) for k, v in p.items()} for p in ps]
    k0 = perturb(jk.init_kernel_params(spec0, L, jnp.float64))
    k1 = perturb(jk.init_kernel_params(spec1, L, jnp.float64))
    zt = np.stack([tr_lab[rng.choice(len(tr_lab), M)] for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    noise = 0.5 + rng.random(L)
    train_mu = rng.standard_normal((len(tr_lab), L))
    return dict(ds=ds, tds=tds, model=model, params=params, tmodel=tmodel,
                spec0=spec0, spec1=spec1, k0=k0, k1=k1, zt=zt, noise=noise,
                train_mu=train_mu, train_x=tr_lab, rng=rng)


def _jgp(s):
    j = lambda ps: [{k: jnp.asarray(v) for k, v in p.items()} for p in ps]
    return (s["spec0"], j(s["k0"]), s["spec1"], j(s["k1"]),
            jnp.asarray(s["noise"]), jnp.asarray(s["zt"]))


def _tgp(s):
    t0, t1 = tk.build_kernel_specs(*SPEC_ARGS)
    t = lambda ps: [{k: _t(v) for k, v in p.items()} for p in ps]
    return (t0, t(s["k0"]), t1, t(s["k1"]), _t(s["noise"]), _t(s["zt"]))


def test_mlp_validate_rows_match_hlax(mlp_setup, tmp_path):
    """The 10 validation rows with the MLP model on the non-conv
    validation split, hlax's forward noise injected into the port's."""
    s = mlp_setup
    n = len(s["ds"]["val"])
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), (n, L),
                                       jnp.float64))
    df = jval.validate(s["model"], s["params"], *_jgp(s), s["ds"]["val"],
                       s["train_mu"], s["train_x"], 2, str(tmp_path / "j"))
    rows = tval.validate(s["tmodel"], *_tgp(s), s["tds"]["val"],
                         s["train_mu"], s["train_x"], 2, str(tmp_path / "t"),
                         noise_eps=noise)
    want = np.array([float(df.loc[k].iloc[0]) for k in df.index])
    assert tuple(rows) == tuple(df.index)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(list(rows.values()), want, rtol=MODEL_RTOL)


def _compare_battery(got, want, keys):
    for key in keys:
        for kind in want[key]:
            for part in want[key][kind]:
                np.testing.assert_allclose(
                    got[key][kind][part], np.asarray(want[key][kind][part]),
                    rtol=MODEL_RTOL, atol=1e-12)


@pytest.mark.parametrize("test", [True, False])
def test_mlp_test_battery_matches_hlax(mlp_setup, test):
    """The encode -> decode battery on the test split.  With test=True the
    non-conv unseen-row rule keeps the 15 test rows whose uid (the last
    label column) the training split does not hold."""
    s = mlp_setup
    training_indexes = s["ds"]["train"].labels[:, -1]
    want = jtest.hlvae_test(s["model"], s["params"], s["ds"]["test"],
                            test=test, prnt=False,
                            training_indexes=training_indexes)
    got = ttest.hlvae_test(s["tmodel"], s["tds"]["test"], test=test,
                           prnt=False, training_indexes=training_indexes)
    _compare_battery(got, want, ("partial_error_mean", "partial_error_mode",
                                 "impt_partial_error", "partial_LL"))
    for k in ("observed_density", "missing_density"):
        np.testing.assert_allclose(got[k], want[k], rtol=MODEL_RTOL)
    assert got["all_rows_fallback"] == want["all_rows_fallback"] is False
    rows, _ = ttest._unseen_rows(s["tds"]["test"], conv=False,
                                 training_indexes=training_indexes)
    assert list(s["tds"]["test"].labels[rows, -1].astype(int)) == \
        list(range(30, 45))


def test_mlp_mse_test_gp_matches_hlax(mlp_setup, tmp_path):
    """GP prediction at the test covariates, decoded by the MLP model, and
    the battery on the unseen rows; the same ``result_error_final.csv``."""
    s = mlp_setup
    ds, tds = s["ds"]["test"], s["tds"]["test"]
    pred_x = np.concatenate([s["train_x"], ds.labels])
    pred_mu = np.concatenate([s["train_mu"],
                              s["rng"].standard_normal((len(ds), L))])
    training_indexes = s["ds"]["train"].labels[:, -1]
    want = jtest.mse_test_gp(s["model"], s["params"], *_jgp(s), ds, pred_x,
                             pred_mu, 2, str(tmp_path / "j"),
                             training_indexes=training_indexes)
    got = ttest.mse_test_gp(s["tmodel"], *_tgp(s), tds, pred_x, pred_mu, 2,
                            str(tmp_path / "t"),
                            training_indexes=training_indexes)
    for k in ("mean_GP_recon_loss", "miss_recon_loss_GP"):
        np.testing.assert_allclose(got[k], want[k], rtol=MODEL_RTOL)
    _compare_battery(got, want, ("partial_error_mean", "partial_error_mode",
                                 "impt_partial_error", "partial_LL"))


def _rows(path):
    with open(path) as f:
        pairs = [line.rstrip("\n").split(",") for line in f]
    return {p[0]: float(p[1]) for p in pairs if p[0]}


# the non-conv CLI config of tests/test_nonconv.py, float64
NONCONV_FLAGS = [
    "--results_path=/results", "--csv_types_file=types.csv",
    "--csv_file_data=train_data.csv", "--csv_file_label=train_label.csv",
    "--mask_file=train_mask.csv", "--csv_file_test_data=test_data.csv",
    "--csv_file_test_label=test_label.csv", "--test_mask_file=test_mask.csv",
    "--csv_file_prediction_data=train_data.csv",
    "--csv_file_prediction_label=train_label.csv",
    "--prediction_mask_file=train_mask.csv",
    "--csv_file_validation_data=validation_data.csv",
    "--csv_file_validation_label=validation_label.csv",
    "--validation_mask_file=validation_mask.csv", "--varying_T=True",
    f"--latent_dim={L}", "--id_covariate=2", f"--M={M}", "--P=6", "--T=5",
    "--epochs=3", "--save_interval=30", "--num_dim=4",
    "--type_KL=GPapprox_closed", "--subjects_per_batch=3",
    "--natural_gradient=True", "--constrain_scales=True",
    "--run_tests=True", "--run_validation=True", "--generate_images=False",
    "--cat_kernel=[2]", "--bin_kernel=[]", "--sqexp_kernel=[0]",
    "--cat_int_kernel=[{'cont_covariate':0,'cat_covariate':2}]",
    "--bin_int_kernel=[]", "--covariate_missing_val=[]",
    f"--hidden_layers=[{HID}]", "--conv_hivae=False", f"--y_dim={Y}",
    "--gp_dtype=float64", "--model_dtype=float64"]


@pytest.fixture(scope="module")
def nonconv_data(tmp_path_factory):
    """tests/test_nonconv.py's CSVs (the same seeds and splits)."""
    d = str(tmp_path_factory.mktemp("nonconv"))
    rng = np.random.default_rng(3)
    with open(os.path.join(d, "types.csv"), "w") as f:
        f.write("type,dim,nclass\n")
        for t in TYPES:
            f.write(f"{t['type']},{t['dim']},{t['nclass']}\n")
    _write_split(d, "train", *_make_split(rng, n_subj=6, T=5, uid_start=0,
                                          subj_start=0))
    _write_split(d, "test", *_make_split(rng, n_subj=4, T=5, uid_start=25,
                                         subj_start=6))
    _write_split(d, "validation", *_make_split(rng, n_subj=3, T=5,
                                               uid_start=100, subj_start=10))
    return d


def test_nonconv_cli_trains_the_mlp_model(nonconv_data, tmp_path):
    """The port's training CLI on the non-conv dataset: 3 epochs of the MLP
    model, validation and the test battery, finite results, and the unseen
    rows the uid rule keeps (no fallback to all rows)."""
    save = tmp_path / "run"
    out = tmain.main([f"--data_source_path={nonconv_data}",
                      f"--save_path={save}", "--device=cpu", *NONCONV_FLAGS])
    assert not out["model"].cfg.conv and out["steps"] == 6
    assert np.isfinite(out["loss_arrs"]["net"]).all()
    results = save / "results"
    val = _rows(results / "validation_results.csv")
    assert len(val) == 10 and np.isfinite(list(val.values())).all()
    err = _rows(results / "result_error_final.csv")
    assert np.isfinite(err["mean_GP_recon_loss"])
    assert err["all_rows_fallback"] == 0.0
    for name in ("final.pt", "arguments.pkl", "plot_values.pkl"):
        assert os.path.isfile(save / name)


def test_nonconv_cli_battery_matches_hlax(nonconv_data, tmp_path, capsys):
    """Both training CLIs rerun eval-only (``--epochs=0``) from the same
    trained state: hlax's orbax checkpoint and the port's ``final.pt``
    (weights carried across), beside the same ``arguments.pkl``.  The
    validation rows that do not depend on the forward's sampled noise (the
    GP rows; the others are held with injected noise by
    ``test_mlp_validate_rows_match_hlax``), ``result_error_final.csv`` and
    the test battery's pickles agree within 1e-6."""
    opt = JModelArgs().parse_options(
        [f"--data_source_path={nonconv_data}", *NONCONV_FLAGS])
    rng = np.random.default_rng(2)
    raw, miss = (np.loadtxt(os.path.join(nonconv_data, f"train_{k}.csv"),
                            delimiter=",") for k in ("data", "mask"))
    het = encode_raw(raw, TYPES, miss_mask=miss)
    t_het = t_encode_raw(raw, TYPES, miss_mask=miss)
    labels = np.loadtxt(os.path.join(nonconv_data, "train_label.csv"),
                        delimiter=",", skiprows=1)
    _, params, tmodel = _models(het, t_het, seed=6)
    spec0, spec1 = jk.build_kernel_specs(*SPEC_ARGS)
    perturb = lambda ps: [{k: np.asarray(v) + 0.3 * rng.standard_normal(
        v.shape) for k, v in p.items()} for p in ps]
    k0 = perturb(jk.init_kernel_params(spec0, L, jnp.float64))
    k1 = perturb(jk.init_kernel_params(spec1, L, jnp.float64))
    zt = np.stack([labels[rng.choice(len(labels), M)] for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    raw_noise = np.asarray(jk.noise_init(L, True, jnp.float64))
    m = rng.standard_normal((L, M, 1)) * 0.1
    H = np.eye(M) + np.zeros((L, M, M))

    dirs = {"hlax": tmp_path / "hlax", "port": tmp_path / "port"}
    for d in dirs.values():
        os.makedirs(d)
        opt_d = dict(opt, save_path=str(d))
        with open(d / "arguments.pkl", "wb") as f:
            pickle.dump(opt_d, f)
    jcfg = jstep.TrainConfig(latent_dim=L, M=M, P_tot=6.0, N_tot=30.0,
                             id_covariate=2, gp_dtype=jnp.float64,
                             constrain_scales=True)
    state = jstep.TrainState(
        vae=params, k0=k0, k1=k1, raw_noise=jnp.asarray(raw_noise),
        zt=jnp.asarray(zt), m=jnp.asarray(m), H=jnp.asarray(H),
        opt_state=None, step=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(0))
    state = state._replace(opt_state=jstep.make_optimizer(jcfg).init(
        jstep._trainable(state, jcfg)))
    jckpt.save(str(dirs["hlax"]), state)
    tcfg = tstep.TrainConfig(latent_dim=L, M=M, P_tot=6.0, N_tot=30.0,
                             id_covariate=2, gp_dtype=torch.float64,
                             constrain_scales=True)
    tckpt.save(str(dirs["port"]), state_from_hlax(params, k0, k1, raw_noise,
                                                  zt, m, H, tmodel, tcfg))

    rerun = [f"--data_source_path={nonconv_data}", "--epochs=0",
             "--run_validation=True", "--run_tests=True",
             "--generate_images=False", "--gp_model_folder=/"]
    jmain.main([*rerun, f"--save_path={dirs['hlax']}"])
    assert "Loaded pre-trained values." in capsys.readouterr().out
    out = tmain.main([*rerun, f"--save_path={dirs['port']}",
                      "--device=cpu"])
    assert "Loaded pre-trained values." in capsys.readouterr().out
    assert not out["model"].cfg.conv
    res = {k: d / "results" for k, d in dirs.items()}
    got = _rows(res["port"] / "validation_results.csv")
    want = _rows(res["hlax"] / "validation_results.csv")
    assert list(got) == list(want)
    for k in ("GP_error", "miss_GP_error", "GP_loss", "GP_recon_loss_sum"):
        np.testing.assert_allclose(got[k], want[k], rtol=MODEL_RTOL,
                                   err_msg=k)
    got = _rows(res["port"] / "result_error_final.csv")
    want = _rows(res["hlax"] / "result_error_final.csv")
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=MODEL_RTOL)
    for name in ("partial_metrics_test_VAE.pickle",
                 "partial_metrics_test_future.pickle"):
        with open(res["port"] / name, "rb") as f:
            g = pickle.load(f)
        with open(res["hlax"] / name, "rb") as f:
            w = pickle.load(f)
        _assert_tree_close(g, w, name)


def _assert_tree_close(got, want, where):
    """Nested dicts and lists of arrays, equal in structure, values within
    MODEL_RTOL."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_tree_close(got[k], want[k], f"{where} {k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_close(g, w, f"{where} [{i}]")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=MODEL_RTOL, atol=1e-12, err_msg=where)
