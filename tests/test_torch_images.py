"""The port's bridges and image path against hlax, float64 on the CPU:
``eval/bridges.py`` at float64 rounding; ``recon_complete_gen``'s grid
(truth x mask, reconstruction, labels: the arguments both packages hand to
``seqrecon_plot``) from the same weights, GP state and prediction context;
``plot_training_info``'s PNGs where matplotlib is installed, and the
``.npz`` files the port writes without it."""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hlax.data.dataset import LongitudinalDataset
from hlax.data.reader import encode_raw
from hlax.eval import bridges as jbr
from hlax.eval import images as jim
from hlax.gp import kernels as jk
from hlax.models import HLVAE, HLVAEConfig
from hlax_torch.convert import load_hlax_vae
from hlax_torch.data import generate as tgen
from hlax_torch.data.dataset import (HEALTH_MNIST_LABEL_ORDER,
                                     LongitudinalDataset as TDataset)
from hlax_torch.data.reader import encode_raw as t_encode_raw
from hlax_torch.eval import bridges as tbr
from hlax_torch.eval import images as tim
from hlax_torch.gp import kernels as tk
from hlax_torch.models import hlvae as thlvae

torch.set_num_threads(1)

L, M, HID, EPS = 4, 30, 16, 1e-4
SPEC_ARGS = ([2], [], [0],
             [{"cont_covariate": 0, "cat_covariate": 2},
              {"cont_covariate": 0, "cat_covariate": 3},
              {"cont_covariate": 1, "cat_covariate": 4}], [], [], 2)
CURVES = dict(net_loss=[5.0, 4.0, 3.5], nll=[2.0, 1.5, 1.2],
              kld=[3.0, 2.5, 2.3], vae_error=[0.5, 0.4],
              gp_error=[0.6, 0.5], validation_loss=[4.5, 4.1])
HLAX_PNGS = ["test_GP_error.png", "training_VAE_error.png",
             "training_kl_ll.png", "training_net_loss.png",
             "validation_net_loss.png"]


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


@pytest.fixture(scope="module")
def bridge_inputs():
    rng = np.random.default_rng(0)
    x01 = rng.random((6, 40))
    x01[0, :5] = [50 / 255, 100 / 255, 150 / 255, 200 / 255, 0.0]
    return dict(x01=x01, codes=rng.integers(0, 5, (6, 40)).astype(float),
                mean=rng.random((6, 40)),
                logvar=rng.normal(-3.0, 1.5, (6, 40)),
                idx=np.sort(rng.choice(40, 17, replace=False)))


@pytest.mark.parametrize("name", ["convert_cat5_to_pixels",
                                  "convert_pixels_to_cat5",
                                  "gaussian_to_categorical_density"])
def test_bridges_match_hlax(bridge_inputs, name):
    b = bridge_inputs
    if name == "gaussian_to_categorical_density":
        args = (b["mean"], b["logvar"], b["x01"])
        rtol = 1e-12
    else:
        args = (b["codes"] if name == "convert_cat5_to_pixels" else b["x01"],
                b["idx"])
        rtol = 0.0
    want = getattr(jbr, name)(*(jnp.asarray(a) for a in args))
    got = getattr(tbr, name)(*(_t(a) if a.dtype == np.float64 else a
                               for a in args))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=rtol)
    if name == "convert_cat5_to_pixels":
        # hlax returns what has no ``.at`` unchanged; so does the port with
        # what is not a tensor
        assert tbr.convert_cat5_to_pixels(b["codes"], b["idx"]) is b["codes"]


@pytest.fixture(scope="module")
def image_setup():
    """Five D4 subjects of 20 frames (the generation set), a conv HLVAE
    (z=4, hidden 16) from hlax's init carried into the port, a GP state
    with M=30 and a prediction context of the first 5 frames of each
    subject."""
    rng = np.random.default_rng(11)
    out = tgen.generate(num_3=2, num_6=3, missing=25.0,
                        datatype_config="D4", seed=5)
    labels = np.nan_to_num(out["labels"][:, HEALTH_MNIST_LABEL_ORDER])
    types = tgen.types_table("D4")
    het = encode_raw(out["data"], types, miss_mask=out["mask"])
    t_het = t_encode_raw(out["data"], types, miss_mask=out["mask"])
    het.labels, t_het.labels = labels, labels
    ds = LongitudinalDataset(het=het, labels=labels, id_covariate=2)
    tds = TDataset(het=t_het, labels=labels, id_covariate=2)

    model = HLVAE(HLVAEConfig(layout=het.layout, z_dim=L, h_dims=(HID,),
                              y_dim=5, conv=True, dtype=jnp.float64))
    key = jax.random.PRNGKey(3)
    params = model.init(key, *(jnp.asarray(a[:4]) for a in (
        het.data, het.mask, het.theta_mask)), key)
    tmodel = thlvae.HLVAE(thlvae.HLVAEConfig(
        layout=t_het.layout, z_dim=L, h_dims=(HID,), y_dim=5, conv=True),
        torch.Generator().manual_seed(0), "cpu").double()
    load_hlax_vae(tmodel, params)

    spec0, spec1 = jk.build_kernel_specs(*SPEC_ARGS)
    perturb = lambda ps: [{k: np.asarray(v) + 0.3 * rng.standard_normal(
        v.shape) for k, v in p.items()} for p in ps]
    k0 = perturb(jk.init_kernel_params(spec0, L, jnp.float64))
    k1 = perturb(jk.init_kernel_params(spec1, L, jnp.float64))
    zt = np.stack([labels[rng.choice(len(labels), M)] for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    noise = 0.5 + rng.random(L)
    ctx = np.concatenate([np.arange(20 * s, 20 * s + 5) for s in range(5)])
    pred_x, pred_mu = labels[ctx], rng.standard_normal((len(ctx), L))
    t0, t1 = tk.build_kernel_specs(*SPEC_ARGS)
    jl = lambda ps: [{k: jnp.asarray(v) for k, v in p.items()} for p in ps]
    tl = lambda ps: [{k: _t(v) for k, v in p.items()} for p in ps]
    jargs = (model, params, spec0, jl(k0), spec1, jl(k1), jnp.asarray(noise),
             jnp.asarray(zt), ds, pred_x, pred_mu, 2)
    targs = (tmodel, t0, tl(k0), t1, tl(k1), _t(noise), _t(zt), tds, pred_x,
             pred_mu, 2)
    return dict(jargs=jargs, targs=targs)


def _capture(monkeypatch, module):
    calls = []
    monkeypatch.setattr(module, "seqrecon_plot",
                        lambda *a, **kw: calls.append((a, kw)) or a[4])
    return calls


def test_recon_complete_gen_grid_matches_hlax(image_setup, tmp_path,
                                              monkeypatch):
    """Both packages hand ``seqrecon_plot`` the same grid: truth x mask
    exactly, the reconstruction to 1e-9 of 255 (sigmoid means and argmax
    codes, remapped), the same labels, sets and file name."""
    s = image_setup
    cj, ct = _capture(monkeypatch, jim), _capture(monkeypatch, tim)
    jim.recon_complete_gen(*s["jargs"], str(tmp_path / "j"), epoch=30,
                           eps=EPS)
    path = tim.recon_complete_gen(*s["targs"], str(tmp_path / "t"),
                                  epoch=30, eps=EPS)
    assert path == str(tmp_path / "t" / "recon_complete_30.pdf")
    (aj, kwj), (at, kwt) = cj[0], ct[0]
    assert kwt == kwj == {"num_sets": 5, "seq_length": 20}
    assert os.path.basename(at[4]) == os.path.basename(aj[4])
    X, recon = at[0], at[1]
    assert X.shape == recon.shape == (100, 1296)
    np.testing.assert_array_equal(X, np.asarray(aj[0]))
    np.testing.assert_allclose(recon, np.asarray(aj[1]), rtol=0,
                               atol=1e-9 * 255)
    for a, b in zip(at[2:4], aj[2:4]):
        np.testing.assert_array_equal(a, b)
    # D4's three quantized quadrants came out as pixel values
    for reg in tgen.quantized_regions("D4"):
        assert set(np.unique(recon[:, reg])) <= {0.0, 50.0, 100.0, 150.0,
                                                 200.0}
    assert recon.min() >= 0.0 and recon.max() <= 255.0


def test_plot_training_info_writes_hlax_pngs(tmp_path):
    """With matplotlib: the five PNGs hlax writes, by the same names."""
    pytest.importorskip("matplotlib")
    jim.plot_training_info(str(tmp_path / "j"), **CURVES)
    written = tim.plot_training_info(str(tmp_path / "t"), **CURVES)
    assert sorted(os.listdir(tmp_path / "j")) == HLAX_PNGS
    assert sorted(os.listdir(tmp_path / "t")) == HLAX_PNGS
    assert sorted(map(os.path.basename, written)) == HLAX_PNGS


def test_without_matplotlib_the_npz_files_are_written(image_setup, tmp_path,
                                                      monkeypatch, capsys):
    """``sys.modules["matplotlib"] = None``: nothing raises; the grid goes
    to recon_complete.npz beside the PDF's name and the curves to
    training_curves.npz, each with one line saying so (the curves' line
    only when asked to warn)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    res = tmp_path / "results"
    path = tim.recon_complete_gen(*image_setup["targs"], str(res), eps=EPS)
    assert path == str(res / "recon_complete.npz")
    with np.load(path) as z:
        assert z["X"].shape == z["recon_X"].shape == (100, 1296)
        assert np.isfinite(z["recon_X"]).all()
        assert 0.0 <= z["recon_X"].min() and z["recon_X"].max() <= 255.0
        assert z["labels_recon"].shape == (100, 6)
        assert int(z["num_sets"]) == 5 and int(z["seq_length"]) == 20
    assert not os.path.exists(res / "recon_complete.pdf")
    written = tim.plot_training_info(str(tmp_path), **CURVES)
    tim.plot_training_info(str(tmp_path), warn=False, **CURVES)
    assert written == [str(tmp_path / "training_curves.npz")]
    with np.load(written[0]) as z:
        assert sorted(z.files) == sorted(CURVES)
        np.testing.assert_array_equal(z["kld"], CURVES["kld"])
    printed = capsys.readouterr().out
    assert printed.count("needs matplotlib") == 1
    assert printed.count("plots need matplotlib") == 1
    with pytest.raises(ImportError):   # hlax's own raises here
        jim.plot_training_info(str(tmp_path / "j"), **CURVES)
