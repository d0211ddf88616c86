"""Port's eval path (``hlax_torch.gp`` eval bounds and predictor,
``hlax_torch.eval``) against hlax, float64 on the CPU.

Identical numpy inputs: L=4 latents, M=12 (small Cholesky path) or M=30
(mid path), the canonical kernel structure, ragged subjects of T=3..7 so
every eval group pads to its power-of-two bucket.  The GP math is held to
rtol 1e-8; the passes through the conv model (validation rows, the test
battery) to rtol 1e-6, the bar of the port's model tests.  The jitter is
1e-4, so no pivot falls below the guard's floor and hlax's CPU fallback
(XLA's Cholesky) computes the same factors as the port.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hlax.data.dataset import LongitudinalDataset
from hlax.data.reader import encode_raw
from hlax.eval import testing as jtest
from hlax.eval import validate as jval
from hlax.gp import elbo as jelbo
from hlax.gp import kernels as jk
from hlax.gp import predict as jpred
from hlax.models import HLVAE, HLVAEConfig
from hlax_torch.convert import load_hlax_vae
from hlax_torch.data import generate as tgen
from hlax_torch.data.dataset import (HEALTH_MNIST_LABEL_ORDER,
                                     LongitudinalDataset as TDataset)
from hlax_torch.data.reader import encode_raw as t_encode_raw
from hlax_torch.eval import testing as ttest
from hlax_torch.eval import validate as tval
from hlax_torch.gp import elbo as telbo
from hlax_torch.gp import kernels as tk
from hlax_torch.gp import predict as tpred
from hlax_torch.models import hlvae as thlvae

torch.set_num_threads(1)

L, Q, HID, EPS = 4, 6, 16, 1e-4
LENGTHS = [3, 5, 7, 6, 5]           # ragged: groups T = 3, 5, 6, 7
SPEC_ARGS = ([2], [], [0],
             [{"cont_covariate": 0, "cat_covariate": 2},
              {"cont_covariate": 0, "cat_covariate": 3},
              {"cont_covariate": 1, "cat_covariate": 4}], [], [], 2)
GP_RTOL, MODEL_RTOL = 1e-8, 1e-6


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _labels(rng, lengths, first_id=0):
    """Reordered Health-MNIST covariates [time_age, disease_time, subject,
    gender, disease, location] of whole subjects."""
    rows = []
    for s, t in enumerate(lengths):
        sick = rng.integers(0, 2)
        lab = np.zeros((t, Q))
        lab[:, 0] = np.arange(t)
        lab[:, 1] = (np.arange(t) - 9) * sick
        lab[:, 2] = first_id + s
        lab[:, 3] = rng.integers(0, 2)
        lab[:, 4] = sick
        lab[:, 5] = rng.integers(0, 2)
        rows.append(lab)
    return np.concatenate(rows)


def _gp_state(M, seed):
    rng = np.random.default_rng(seed)
    spec0, spec1 = jk.build_kernel_specs(*SPEC_ARGS)
    perturb = lambda ps: [{k: np.asarray(v) + 0.3 * rng.standard_normal(v.shape)
                           for k, v in p.items()} for p in ps]
    k0 = perturb(jk.init_kernel_params(spec0, L, jnp.float64))
    k1 = perturb(jk.init_kernel_params(spec1, L, jnp.float64))
    rows = _labels(rng, [8, 8, 8])
    zt = np.stack([rows[rng.choice(len(rows), M)] for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    noise = 0.5 + rng.random(L)
    return dict(spec0=spec0, spec1=spec1, k0=k0, k1=k1, zt=zt, noise=noise,
                rng=rng)


def _jgp(s):
    """hlax's positional GP arguments."""
    j = lambda ps: [{k: jnp.asarray(v) for k, v in p.items()} for p in ps]
    return (s["spec0"], j(s["k0"]), s["spec1"], j(s["k1"]),
            jnp.asarray(s["noise"]), jnp.asarray(s["zt"]))


def _tgp(s):
    """The port's positional GP arguments."""
    t0, t1 = tk.build_kernel_specs(*SPEC_ARGS)
    t = lambda ps: [{k: _t(v) for k, v in p.items()} for p in ps]
    return (t0, t(s["k0"]), t1, t(s["k1"]), _t(s["noise"]), _t(s["zt"]))


def _group(rng, lengths=(3, 5, 7, 8), T=8):
    """One padded group: covariates [S, T, Q] and valid [S, T]."""
    x = np.zeros((len(lengths), T, Q))
    valid = np.zeros((len(lengths), T))
    lab = _labels(rng, lengths)
    r = 0
    for i, t in enumerate(lengths):
        x[i, :t] = lab[r:r + t]
        valid[i, :t] = 1.0
        r += t
    return x, valid


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * 1e-2 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("M", [12, 30])
def test_whitened_w_factor_matches_hlax(M):
    s = _gp_state(M, seed=M)
    x, valid = _group(s["rng"])
    sj, st = _jgp(s), _tgp(s)
    bj = jelbo.subject_blocks(*sj, jnp.asarray(x), jnp.asarray(valid), EPS,
                              with_K0st=False, use_pallas_chol=True)
    bt = telbo.subject_blocks(*st, _t(x), _t(valid), EPS, with_K0st=False,
                              use_pallas_chol=True)
    outs_j = jelbo.whitened_w_factor(bj.iLK, bj.K0xz, bj.iLB)
    outs_t = telbo.whitened_w_factor(bt.iLK, bt.K0xz, bt.iLB)
    for got, want in zip(outs_t, outs_j):
        _close(got.numpy(), want, GP_RTOL)


@pytest.mark.parametrize("bound", ["dubo", "sample_elbo"])
@pytest.mark.parametrize("M", [12, 30])
def test_eval_bounds_match_hlax(M, bound):
    """The DUBO on encoder means and variances, and the sampled bound on an
    injected latent sample, over one padded group."""
    s = _gp_state(M, seed=100 + M)
    rng = s["rng"]
    x, valid = _group(rng)
    mu = rng.standard_normal((4, 8, L)) * valid[:, :, None]
    lv = rng.standard_normal((4, 8, L)) * 0.3 * valid[:, :, None]
    if bound == "dubo":
        want = jelbo.deviance_upper_bound(
            *_jgp(s), jnp.asarray(x), jnp.asarray(valid), jnp.asarray(mu),
            jnp.asarray(lv), EPS)
        got = telbo.deviance_upper_bound(*_tgp(s), _t(x), _t(valid), _t(mu),
                                         _t(lv), EPS)
    else:
        want = jelbo.sample_elbo(*_jgp(s), jnp.asarray(x), jnp.asarray(valid),
                                 jnp.asarray(mu), EPS)
        got = telbo.sample_elbo(*_tgp(s), _t(x), _t(valid), _t(mu), EPS)
    np.testing.assert_allclose(got.item(), float(want), rtol=GP_RTOL)


@pytest.mark.parametrize("M", [12, 30])
def test_batch_predict_matches_hlax(M):
    """Prediction rows of 4 padded subjects, test rows of 3 of them plus
    rows of a subject with no prediction rows (only the K0 term)."""
    s = _gp_state(M, seed=200 + M)
    rng = s["rng"]
    x, valid = _group(rng)
    mu = rng.standard_normal((4, 8, L)) * valid[:, :, None]
    test_x = _labels(rng, [4, 6, 2, 3])
    test_x[:, 2] = np.repeat([1.0, 2.0, 3.0, 9.0], [4, 6, 2, 3])
    flat_subj = np.where(valid.reshape(-1) > 0,
                         np.repeat(np.arange(4.0), 8), np.nan)
    test_subjects = np.array([1.0, 2.0, 3.0, 9.0])
    idx, val = jpred.build_test_pred_map(flat_subj, test_subjects)
    idx_t, val_t = tpred.build_test_pred_map(flat_subj, test_subjects)
    np.testing.assert_array_equal(idx_t, idx)
    np.testing.assert_array_equal(val_t, val)
    of_row = np.repeat(np.arange(4), [4, 6, 2, 3])
    want = jpred.batch_predict(*_jgp(s), jnp.asarray(x), jnp.asarray(valid),
                               jnp.asarray(mu), jnp.asarray(test_x), idx, val,
                               of_row, EPS)
    got = tpred.batch_predict(*_tgp(s), _t(x), _t(valid), _t(mu), _t(test_x),
                              idx, val, of_row, EPS)
    assert tuple(got.shape) == (15, L)
    _close(got.numpy(), want, GP_RTOL)


@pytest.fixture(scope="module")
def eval_setup():
    """A conv HLVAE (z=4, hidden 16) from hlax's flax init, carried into the
    port; ragged validation/test subjects cut from generated D4 data; a GP
    state with M=30; training context rows from other subjects."""
    rng = np.random.default_rng(11)
    out = tgen.generate(num_3=2, num_6=3, missing=25.0,
                        datatype_config="D4", seed=5)
    keep = np.concatenate([np.arange(20 * s, 20 * s + t)
                           for s, t in enumerate(LENGTHS)])
    raw = out["data"][keep]
    miss = out["mask"][keep]
    labels = np.nan_to_num(out["labels"][keep][:, HEALTH_MNIST_LABEL_ORDER])
    types = tgen.types_table("D4")
    het = encode_raw(raw, types, miss_mask=miss)
    t_het = t_encode_raw(raw, types, miss_mask=miss)
    het.labels, t_het.labels = labels, labels
    ds = LongitudinalDataset(het=het, labels=labels, id_covariate=2)
    tds = TDataset(het=t_het, labels=labels, id_covariate=2)

    cfg = HLVAEConfig(layout=het.layout, z_dim=L, h_dims=(HID,), y_dim=5,
                      conv=True, dtype=jnp.float64)
    model = HLVAE(cfg)
    data = jnp.asarray(het.data[:4])
    key = jax.random.PRNGKey(3)
    params = model.init(key, data, jnp.asarray(het.mask[:4]),
                        jnp.asarray(het.theta_mask[:4]), key)
    tmodel = thlvae.HLVAE(thlvae.HLVAEConfig(
        layout=t_het.layout, z_dim=L, h_dims=(HID,), y_dim=5, conv=True),
        torch.Generator().manual_seed(0), "cpu").double()
    load_hlax_vae(tmodel, params)

    s = _gp_state(30, seed=7)
    train_x = _labels(rng, [6, 6, 6], first_id=20)
    train_mu = rng.standard_normal((len(train_x), L))
    return dict(ds=ds, tds=tds, model=model, params=params, tmodel=tmodel,
                gp=s, train_x=train_x, train_mu=train_mu, rng=rng)


def test_gp_losses_match_hlax(eval_setup):
    """The bucketed per-group sums over ragged subjects: the DUBO, and the
    sampled bound at log-variance -60 (the sample is the mean to 1e-13, so
    the two generators' noise does not matter)."""
    e = eval_setup
    rng = np.random.default_rng(3)
    n = len(e["ds"])
    mu = rng.standard_normal((n, L))
    lv = rng.standard_normal((n, L)) * 0.3
    want = jval.gp_loss_dubo(*_jgp(e["gp"]), e["ds"], mu, lv, EPS)
    got = tval.gp_loss_dubo(*_tgp(e["gp"]), e["tds"], mu, lv, EPS)
    np.testing.assert_allclose(got, want, rtol=GP_RTOL)
    lv = np.full((n, L), -60.0)
    want = jval.gp_loss_sampled(*_jgp(e["gp"]), e["ds"], mu, lv, 1, EPS)
    got = tval.gp_loss_sampled(*_tgp(e["gp"]), e["tds"], mu, lv, 1, EPS)
    np.testing.assert_allclose(got, want, rtol=GP_RTOL)


def test_gp_predict_dataset_matches_hlax(eval_setup):
    """Prediction context of training subjects plus the first frames of the
    ragged subjects; prediction at every row of the ragged subjects."""
    e = eval_setup
    ds = e["ds"]
    pred_x = np.concatenate([e["train_x"], ds.labels[::2]])
    pred_mu = np.concatenate([e["train_mu"],
                              e["rng"].standard_normal((len(ds.labels[::2]),
                                                        L))])
    args = (pred_x, pred_mu, pred_x[:, 2], ds.labels, ds.labels[:, 2], EPS)
    want = jval.gp_predict_dataset(*_jgp(e["gp"]), *args)
    got = tval.gp_predict_dataset(*_tgp(e["gp"]), *args)
    assert got.shape == (len(ds), L)
    _close(got, want, GP_RTOL)


def _read_rows(path):
    with open(path) as f:
        pairs = [line.rstrip("\n").split(",") for line in f]
    return [p[0] for p in pairs], np.array([float(p[1]) for p in pairs])


def test_validate_rows_match_hlax(eval_setup, tmp_path):
    """The 10 rows of ``validate`` and its CSV, with hlax's forward noise
    (``normal(PRNGKey(0))``) injected into the port's forward."""
    e = eval_setup
    n = len(e["ds"])
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), (n, L),
                                       jnp.float64))
    df = jval.validate(e["model"], e["params"], *_jgp(e["gp"]), e["ds"],
                       e["train_mu"], e["train_x"], 2, str(tmp_path / "j"),
                       eps=EPS)
    rows = tval.validate(e["tmodel"], *_tgp(e["gp"]), e["tds"],
                         e["train_mu"], e["train_x"], 2, str(tmp_path / "t"),
                         eps=EPS, noise_eps=noise)
    assert tuple(rows) == tuple(df.index) == tval.VALIDATION_ROWS
    want = np.array([float(df.loc[k].iloc[0]) for k in df.index])
    np.testing.assert_allclose(list(rows.values()), want, rtol=MODEL_RTOL)
    assert np.isfinite(want).all() and want[5] != 0.0
    names_j, vals_j = _read_rows(tmp_path / "j" / "validation_results.csv")
    names_t, vals_t = _read_rows(tmp_path / "t" / "validation_results.csv")
    assert names_t == names_j
    np.testing.assert_allclose(vals_t, vals_j, rtol=MODEL_RTOL)


def _compare_battery(got, want, keys):
    for key in keys:
        for kind in want[key]:
            for part in want[key][kind]:
                np.testing.assert_allclose(
                    got[key][kind][part], np.asarray(want[key][kind][part]),
                    rtol=MODEL_RTOL, atol=1e-12)


@pytest.mark.parametrize("test", [True, False])
def test_hlvae_test_matches_hlax(eval_setup, test):
    """Encode -> decode battery on the unseen frames (test=True) or all rows;
    the sampled-reconstruction error draws from different generators and is
    only checked for its shape and finiteness."""
    e = eval_setup
    want = jtest.hlvae_test(e["model"], e["params"], e["ds"], test=test,
                            prnt=False)
    got = ttest.hlvae_test(e["tmodel"], e["tds"], test=test, prnt=False)
    _compare_battery(got, want, ("partial_error_mean", "partial_error_mode",
                                 "impt_partial_error", "partial_LL"))
    for k in ("observed_density", "missing_density"):
        np.testing.assert_allclose(got[k], want[k], rtol=MODEL_RTOL)
    assert got["all_rows_fallback"] == want["all_rows_fallback"] is False
    for kind, parts in want["partial_error_sample"].items():
        for part, v in parts.items():
            assert got["partial_error_sample"][kind][part].shape == \
                np.asarray(v).shape
            assert np.isfinite(got["partial_error_sample"][kind][part]).all()


def test_mse_test_gp_matches_hlax(eval_setup, tmp_path):
    """GP prediction at the test covariates, decode, and the battery on the
    unseen frames; ``result_error_final.csv`` holds the same rows."""
    e = eval_setup
    ds = e["ds"]
    pred_x = np.concatenate([e["train_x"], ds.labels])
    pred_mu = np.concatenate([e["train_mu"],
                              e["rng"].standard_normal((len(ds), L))])
    want = jtest.mse_test_gp(e["model"], e["params"], *_jgp(e["gp"]), ds,
                             pred_x, pred_mu, 2, str(tmp_path / "j"), eps=EPS)
    got = ttest.mse_test_gp(e["tmodel"], *_tgp(e["gp"]), e["tds"], pred_x,
                            pred_mu, 2, str(tmp_path / "t"), eps=EPS)
    _close(got["z_pred"], want["z_pred"], GP_RTOL)
    for k in ("mean_GP_recon_loss", "miss_recon_loss_GP"):
        np.testing.assert_allclose(got[k], want[k], rtol=MODEL_RTOL)
    _compare_battery(got, want, ("partial_error_mean", "partial_error_mode",
                                 "impt_partial_error", "partial_LL"))
    names_j, vals_j = _read_rows(tmp_path / "j" / "result_error_final.csv")
    names_t, vals_t = _read_rows(tmp_path / "t" / "result_error_final.csv")
    assert names_t == names_j
    np.testing.assert_allclose(vals_t, vals_j, rtol=MODEL_RTOL)
    assert os.path.isfile(tmp_path / "t" / "partial_metrics_test_future.pickle")


def test_eval_gp_f64_runs_the_gp_in_float64(eval_setup):
    """``eval_gp_f64`` on a float32 GP state: the bound is computed in
    float64 and equals the float64 state's."""
    e = eval_setup
    rng = np.random.default_rng(4)
    n = len(e["ds"])
    mu, lv = rng.standard_normal((n, L)), rng.standard_normal((n, L)) * 0.3
    s64 = _tgp(e["gp"])
    s32 = (s64[0], [{k: v.float() for k, v in p.items()} for p in s64[1]],
           s64[2], [{k: v.float() for k, v in p.items()} for p in s64[3]],
           s64[4].float(), s64[5].float())
    exact = tval.gp_loss_dubo(*s64, e["tds"], mu, lv, EPS)
    got = tval.gp_loss_dubo(*s32, e["tds"], mu, lv, EPS, eval_gp_f64=True)
    np.testing.assert_allclose(got, exact, rtol=1e-6)
