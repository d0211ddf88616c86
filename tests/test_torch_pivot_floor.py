"""The Cholesky guard's pivot floor in each dtype.

float64: the canonical float64 GP (jitter 1e-6, M = 120, L = 32, the
canonical kernels at their initial values, inducing points, m and H drawn
by ``init_train_state``) on a batch of 20 generated D4 subjects.  Its K0zz
is near-singular (inducing points repeat the data's covariate rows), so
many of its pivots sit near the jitter; hlax factorizes float64 with XLA's
unguarded Cholesky, and the port's floor (about 8 machine epsilons of
max diag A, ``linalg_small.pivot_floor_rel``) must lie below every such
pivot (887 of the 3,840 pivots lie below 1e-6 max diag, the smallest at
5.9e-7 of it).  The KLD bound, its closed-form gradients in m and H and
the DUBO are held to hlax with x64 on, at 1e-7 relative: the two
factorizations round differently, and K0zz's condition number (~8e7)
carries that into the inverses (they agree to 7e-9).  With a float64
floor of 1e-6 max diag the bound was 6 % off.

float32: the guard keeps hlax's floor of 1e-6 max diag A; a float32 input
whose rounding makes it indefinite is floored on the same columns as
before.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hlax.gp import elbo as jelbo
from hlax.gp import kernels as jk
from hlax_torch.config import ModelArgs
from hlax_torch.data import dataset as tds
from hlax_torch.data import generate as tgen
from hlax_torch.gp import elbo as telbo
from hlax_torch.gp import kernels as tk
from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
from hlax_torch.ops import linalg_small as tls
from hlax_torch.train import step as tstep

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "hlvae_config_file.txt")
L, M, S = 32, 120, 20
RTOL = 1e-7


@pytest.fixture(scope="module")
def canonical_f64(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("d4"))
    tgen.write_csvs(tgen.generate(num_3=10, num_6=10, datatype_config="D4",
                                  seed=5), d, "D4")
    data = tds.load_dataset(d, "data.csv", "labels.csv", "mask.csv",
                            "data_types_D4.csv")
    opt = ModelArgs().parse_options([f"--f={CONFIG}"])
    spec_args = (opt["cat_kernel"], opt["bin_kernel"], opt["sqexp_kernel"],
                 opt["cat_int_kernel"], opt["bin_int_kernel"],
                 opt["covariate_missing_val"], opt["id_covariate"])
    cfg = tstep.TrainConfig(latent_dim=L, M=M, P_tot=float(data.P),
                            N_tot=float(len(data)), id_covariate=2,
                            constrain_scales=True, gp_dtype=torch.float64)
    assert cfg.eps == 1e-6
    batch = next(tds.subject_batches(data, S))
    model = HLVAE(HLVAEConfig(layout=data.layout, z_dim=L, h_dims=(8,)),
                  torch.Generator().manual_seed(0), "cpu")
    t0, t1 = tk.build_kernel_specs(*spec_args)
    state = tstep.init_train_state(model, t0, t1, batch, cfg, seed=0)
    T = data.T_max
    rng = np.random.default_rng(3)
    valid = batch["valid"]
    mu = rng.standard_normal((S, T, L)) * valid[:, :, None]
    logv = rng.standard_normal((S, T, L)) * 0.3 * valid[:, :, None]
    np64 = lambda t: t.detach().numpy().astype(np.float64)
    return dict(spec_args=spec_args, cfg=cfg, x=batch["labels"].reshape(
        S, T, -1), valid=valid, mu=mu, logv=logv,
        k0=[{k: np64(v) for k, v in p.items()} for p in state.k0],
        k1=[{k: np64(v) for k, v in p.items()} for p in state.k1],
        noise=np64(tk.noise_value(state.raw_noise, True)),
        zt=np64(state.zt), m=np64(state.m), H=np64(state.H))


def _port(s, what):
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    tp = lambda ps: [{k: t(v) for k, v in p.items()} for p in ps]
    t0, t1 = tk.build_kernel_specs(*s["spec_args"])
    gp = (t0, tp(s["k0"]), t1, tp(s["k1"]), t(s["noise"]))
    if what == "kld":
        return telbo.kld_upper_bound(
            *gp, t(s["m"]), t(s["H"]), t(s["zt"]), t(s["x"]), t(s["valid"]),
            t(s["mu"]), t(s["logv"]), s["cfg"].P_tot, s["cfg"].N_tot,
            s["cfg"].eps, natural_gradient=True, use_pallas_chol=True)[:3]
    return telbo.deviance_upper_bound(*gp, t(s["zt"]), t(s["x"]),
                                      t(s["valid"]), t(s["mu"]),
                                      t(s["logv"]), s["cfg"].eps)


def _hlax(s, what):
    j = jnp.asarray
    jp = lambda ps: [{k: j(v) for k, v in p.items()} for p in ps]
    j0, j1 = jk.build_kernel_specs(*s["spec_args"])
    gp = (j0, jp(s["k0"]), j1, jp(s["k1"]), j(s["noise"]))
    if what == "kld":
        return jelbo.kld_upper_bound(
            *gp, j(s["m"]), j(s["H"]), j(s["zt"]), j(s["x"]), j(s["valid"]),
            j(s["mu"]), j(s["logv"]), s["cfg"].P_tot, s["cfg"].N_tot,
            s["cfg"].eps, natural_gradient=True, use_pallas_chol=True)[:3]
    return jelbo.deviance_upper_bound(*gp, j(s["zt"]), j(s["x"]),
                                      j(s["valid"]), j(s["mu"]),
                                      j(s["logv"]), s["cfg"].eps)


def test_canonical_k0zz_has_pivots_near_the_jitter(canonical_f64):
    """The premise: K0zz's smallest pivots are of the jitter's order, far
    below hlax's float32 floor of 1e-6 max diag, far above the float64
    one."""
    s = canonical_f64
    t0, _ = tk.build_kernel_specs(*s["spec_args"])
    zt = torch.tensor(s["zt"])
    k0 = [{k: torch.tensor(v) for k, v in p.items()} for p in s["k0"]]
    kzz = tk.kernel_matrix(t0, k0, zt, zt, True, True) \
        + s["cfg"].eps * torch.eye(M, dtype=torch.float64)
    piv = torch.diagonal(torch.linalg.cholesky(kzz), dim1=-2, dim2=-1) ** 2
    rel = piv / torch.diagonal(kzz, dim1=-2, dim2=-1).amax(-1, keepdim=True)
    assert (rel < 1e-6).sum() > 100
    assert rel.min() > 1e3 * tls.pivot_floor_rel(torch.float64)


@pytest.mark.parametrize("what", ["kld", "grad_m", "grad_H", "dubo"])
def test_float64_bound_matches_unguarded_hlax(canonical_f64, what):
    s = canonical_f64
    src = "dubo" if what == "dubo" else "kld"
    i = {"kld": 0, "grad_m": 1, "grad_H": 2, "dubo": 0}[what]
    got = _port(s, src)
    want = _hlax(s, src)
    got = (got if src == "dubo" else got[i]).detach().numpy()
    want = np.asarray(want if src == "dubo" else want[i])
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_float32_floor_is_unchanged():
    """A float32 input whose logspace(0, -10) spectrum rounding makes
    indefinite: the plain version floors its pivots at 1e-6 max diag A, as
    before, and pins those columns to sqrt(floor) e_j."""
    assert tls.pivot_floor_rel(torch.float32) == 1e-6
    rng = np.random.default_rng(11)
    n = 20
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = torch.tensor(((q * np.logspace(0, -10, n)) @ q.T).astype(np.float32))
    l, il = tls._chol_inv_plain(a)
    floor = np.float32(1e-6) * a.diagonal().max()
    pinned = [j for j in range(n)
              if abs(l[j, j] - torch.sqrt(floor)) < 1e-6 * torch.sqrt(floor)
              and not l[j + 1:, j].any()]
    assert pinned and pinned[0] > 5
    assert torch.isfinite(il).all()
    l64 = l.double()
    assert (l64 @ l64.T - a.double()).abs().max() < 1e-5
