"""The port's imputation CLI against hlax's, on the same CSVs and the same
trained state (float64 on the CPU).

A tiny hlax state (conv HLVAE z=4, hidden 16, from hlax's flax init; M=12
inducing points) is saved both ways: hlax's orbax checkpoint and the port's
``final.pt`` (weights carried across by ``hlax_torch.convert``), each beside
the same ``arguments.pkl`` and ``plot_values.pkl``.  Both CLIs fill the same
CSV.  Both compute in float64 and write ``%.10g``, so their outputs agree to
rtol 1e-6 (the test's bar; the differences are rounding in the last digits).
"""
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hlax.cli import impute as jimpute
from hlax.data.reader import encode_raw
from hlax.gp import kernels as jk
from hlax.models import HLVAE, HLVAEConfig
from hlax.train import checkpoint as jckpt
from hlax.train import step as jstep
from hlax_torch.cli import impute as timpute
from hlax_torch.convert import state_from_hlax
from hlax_torch.data import generate as tgen
from hlax_torch.data.dataset import HEALTH_MNIST_LABEL_ORDER
from hlax_torch.data.reader import encode_raw as t_encode_raw
from hlax_torch.models import hlvae as thlvae
from hlax_torch.train import checkpoint as tckpt
from hlax_torch.train import step as tstep

torch.set_num_threads(1)

L, M, HID, EPS = 4, 12, 16, 1e-4
RTOL = 1e-6
SPEC_ARGS = ([2], [], [0],
             [{"cont_covariate": 0, "cat_covariate": 2},
              {"cont_covariate": 0, "cat_covariate": 3},
              {"cont_covariate": 1, "cat_covariate": 4}], [], [], 2)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("impute")
    data_dir = str(root / "data")
    rng = np.random.default_rng(2)
    for split, seed in (("train_", 1), ("test_", 2)):
        out = tgen.generate(num_3=1, num_6=1, missing=25.0,
                            datatype_config="D4", seed=seed)
        tgen.write_csvs(out, data_dir, "D4", prefix=split)
        if split == "train_":
            train_out = out
    types = tgen.types_table("D4")
    het = encode_raw(train_out["data"], types, miss_mask=train_out["mask"])
    t_het = t_encode_raw(train_out["data"], types,
                         miss_mask=train_out["mask"])
    train_x = np.nan_to_num(train_out["labels"][:, HEALTH_MNIST_LABEL_ORDER])

    cfg = HLVAEConfig(layout=het.layout, z_dim=L, h_dims=(HID,), y_dim=5,
                      conv=True, dtype=jnp.float64)
    key = jax.random.PRNGKey(4)
    params = HLVAE(cfg).init(key, jnp.asarray(het.data[:4]),
                             jnp.asarray(het.mask[:4]),
                             jnp.asarray(het.theta_mask[:4]), key)
    spec0, spec1 = jk.build_kernel_specs(*SPEC_ARGS)
    perturb = lambda ps: [{k: np.asarray(v) + 0.3 * rng.standard_normal(v.shape)
                           for k, v in p.items()} for p in ps]
    k0 = perturb(jk.init_kernel_params(spec0, L, jnp.float64))
    k1 = perturb(jk.init_kernel_params(spec1, L, jnp.float64))
    zt = np.stack([train_x[rng.choice(len(train_x), M)] for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    raw_noise = np.asarray(jk.noise_init(L, True, jnp.float64))
    m = rng.standard_normal((L, M, 1)) * 0.1
    H = np.eye(M) + np.zeros((L, M, M))
    train_mu = rng.standard_normal((len(train_x), L))

    opt = {"data_source_path": data_dir, "csv_types_file": "data_types_D4.csv",
           "csv_range_file": None, "logvar_network": False,
           "hidden_layers": f"[{HID}]", "latent_dim": L, "y_dim": 5,
           "conv_hivae": True, "model_dtype": "float64",
           "cat_kernel": SPEC_ARGS[0], "bin_kernel": SPEC_ARGS[1],
           "sqexp_kernel": SPEC_ARGS[2], "cat_int_kernel": SPEC_ARGS[3],
           "bin_int_kernel": [], "covariate_missing_val": [],
           "id_covariate": 2, "constrain_scales": True, "eps": EPS}
    dirs = {"hlax": str(root / "hlax"), "port": str(root / "port")}
    for d in dirs.values():
        os.makedirs(d)
        with open(os.path.join(d, "arguments.pkl"), "wb") as f:
            pickle.dump(opt, f)
        with open(os.path.join(d, "plot_values.pkl"), "wb") as f:
            pickle.dump([train_x, train_mu], f)

    jcfg = jstep.TrainConfig(latent_dim=L, M=M, P_tot=2.0, N_tot=40.0,
                             id_covariate=2, gp_dtype=jnp.float64, eps=EPS)
    state = jstep.TrainState(
        vae=params, k0=k0, k1=k1, raw_noise=jnp.asarray(raw_noise),
        zt=jnp.asarray(zt), m=jnp.asarray(m), H=jnp.asarray(H),
        opt_state=None, step=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(0))
    state = state._replace(opt_state=jstep.make_optimizer(jcfg).init(
        jstep._trainable(state, jcfg)))
    jckpt.save(dirs["hlax"], state)

    tmodel = thlvae.HLVAE(thlvae.HLVAEConfig(
        layout=t_het.layout, z_dim=L, h_dims=(HID,), y_dim=5, conv=True),
        torch.Generator().manual_seed(0), "cpu").double()
    tcfg = tstep.TrainConfig(latent_dim=L, M=M, P_tot=2.0, N_tot=40.0,
                             id_covariate=2, gp_dtype=torch.float64, eps=EPS)
    tckpt.save(dirs["port"], state_from_hlax(params, k0, k1, raw_noise, zt,
                                             m, H, tmodel, tcfg))
    return {"dirs": dirs, "data": data_dir}


def _both(trained, tmp_path, *extra, data_csv="test_data.csv",
          mask_csv="test_mask.csv"):
    d = trained["data"]
    outs = {}
    for name, cli in (("hlax", jimpute), ("port", timpute)):
        argv = ["--model_dir", trained["dirs"][name],
                "--data_csv", os.path.join(d, data_csv),
                "--out_csv", str(tmp_path / f"{name}.csv"),
                "--ll_csv", str(tmp_path / f"{name}_ll.csv"), *extra]
        if mask_csv:
            argv += ["--mask_csv", os.path.join(d, mask_csv)]
        if name == "port":
            argv += ["--device", "cpu"]
        cli.main(argv)
        outs[name] = (np.loadtxt(tmp_path / f"{name}.csv", delimiter=","),
                      np.loadtxt(tmp_path / f"{name}_ll.csv", delimiter=",",
                                 skiprows=1))
    return outs


@pytest.mark.parametrize("mode", ["encoder", "gp", "encoder_mode_estimate"])
def test_imputation_matches_hlax(trained, tmp_path, mode):
    """Encoder mode (q(z) mean), GP mode (the sparse-GP posterior at the
    rows' covariates given plot_values.pkl) and the mode estimator: same
    filled values and per-row log-densities."""
    extra = {"encoder": [], "encoder_mode_estimate": ["--estimator", "mode"],
             "gp": ["--use_gp", "--label_csv",
                    os.path.join(trained["data"], "test_labels.csv")]}[mode]
    outs = _both(trained, tmp_path, *extra)
    (imp_j, ll_j), (imp_t, ll_t) = outs["hlax"], outs["port"]
    raw = np.loadtxt(os.path.join(trained["data"], "test_data.csv"),
                     delimiter=",")
    mask = np.loadtxt(os.path.join(trained["data"], "test_mask.csv"),
                      delimiter=",")
    assert imp_t.shape == raw.shape and np.isfinite(imp_t).all()
    np.testing.assert_array_equal(imp_t[mask == 1], raw[mask == 1])
    np.testing.assert_allclose(imp_t, imp_j, rtol=RTOL)
    np.testing.assert_allclose(ll_t, ll_j, rtol=RTOL)


def test_nan_cells_are_the_missing_ones_without_a_mask(trained, tmp_path):
    d = trained["data"]
    raw = np.loadtxt(os.path.join(d, "test_data.csv"), delimiter=",")
    mask = np.loadtxt(os.path.join(d, "test_mask.csv"), delimiter=",")
    holed = raw.copy()
    holed[mask == 0] = np.nan
    np.savetxt(os.path.join(d, "holed.csv"), holed, delimiter=",")
    outs = _both(trained, tmp_path, data_csv="holed.csv", mask_csv=None)
    imp_t = outs["port"][0]
    assert np.isfinite(imp_t).all()
    np.testing.assert_array_equal(imp_t[mask == 1], raw[mask == 1])
    np.testing.assert_allclose(imp_t, outs["hlax"][0], rtol=RTOL)


def test_sample_estimator_fills_in_the_columns_value_space(trained, tmp_path):
    """One posterior-predictive draw per cell (the two generators differ, so
    no comparison with hlax's draw): observed cells pass through, cat fills
    come from the column's own values."""
    d = trained["data"]
    out = str(tmp_path / "sample.csv")
    imp = timpute.main(["--model_dir", trained["dirs"]["port"],
                        "--data_csv", os.path.join(d, "test_data.csv"),
                        "--mask_csv", os.path.join(d, "test_mask.csv"),
                        "--out_csv", out, "--estimator", "sample",
                        "--device", "cpu"])
    raw = np.loadtxt(os.path.join(d, "test_data.csv"), delimiter=",")
    mask = np.loadtxt(os.path.join(d, "test_mask.csv"), delimiter=",")
    assert np.isfinite(imp).all()
    np.testing.assert_array_equal(imp[mask == 1], raw[mask == 1])
    kinds = [t["type"] for t in tgen.types_table("D4")]
    for j in [j for j, k in enumerate(kinds) if k == "cat"][:50]:
        assert set(np.unique(imp[:, j])) <= set(np.unique(raw[:, j]))
