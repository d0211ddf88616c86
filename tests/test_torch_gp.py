"""Port's GP kernels, KLD bound and natural-gradient update against hlax.

float64 on the CPU, identical inputs made with numpy.  Varying T (the last
subject is padded), M=16 (small Cholesky path) and M=30 (mid path).  The
jitter is 1e-4, so no pivot falls below the guard's floor and hlax's CPU
fallback (XLA's unguarded Cholesky) computes the same factor as the port.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hlax.gp import elbo as jelbo
from hlax.gp import kernels as jk
from hlax_torch.gp import elbo as telbo
from hlax_torch.gp import kernels as tk

torch.set_num_threads(1)

S, T, L, Q = 4, 5, 6, 6
P_TOT, N_TOT, EPS = 20.0, 100.0, 1e-4

# canonical structure (configs/hlvae_config_file.txt) plus a bin factor
SPEC_ARGS = ([2], [5], [0],
             [{"cat_covariate": 3, "cont_covariate": 0},
              {"cat_covariate": 4, "cont_covariate": 1},
              {"cat_covariate": 2, "cont_covariate": 0}], [], [], 2)


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _labels(rng):
    lab = np.zeros((S, T, Q))
    lab[:, :, 0] = np.arange(T)[None]
    lab[:, :, 1] = rng.integers(-9, 11, S)[:, None]
    lab[:, :, 2] = np.arange(S)[:, None]
    lab[:, :, 3] = rng.integers(0, 2, S)[:, None]
    lab[:, :, 4] = rng.integers(0, 2, S)[:, None]
    lab[:, :, 5] = rng.integers(0, 2, (S, T))
    return lab


def _setup(M, seed=0):
    rng = np.random.default_rng(seed)
    spec0, spec1 = jk.build_kernel_specs(*SPEC_ARGS)
    k0 = [{k: np.asarray(v) + 0.3 * rng.standard_normal(v.shape)
           for k, v in p.items()}
          for p in jk.init_kernel_params(spec0, L, jnp.float64)]
    k1 = [{k: np.asarray(v) + 0.3 * rng.standard_normal(v.shape)
           for k, v in p.items()}
          for p in jk.init_kernel_params(spec1, L, jnp.float64)]
    x = _labels(rng)
    valid = np.ones((S, T))
    valid[-1, 3:] = 0.0                       # varying T: padded subject
    x = x * valid[:, :, None]
    rows = x.reshape(-1, Q)[valid.reshape(-1) > 0]
    zt = np.stack([rows[rng.choice(len(rows), M)] for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    m = rng.standard_normal((L, M, 1))
    Hh = rng.standard_normal((L, M, M)) / 3.0
    H = Hh @ Hh.transpose(0, 2, 1) + 0.5 * np.eye(M)
    mu = rng.standard_normal((S, T, L)) * valid[:, :, None]
    logv = rng.standard_normal((S, T, L)) * 0.3 * valid[:, :, None]
    return dict(spec0=spec0, spec1=spec1, k0=k0, k1=k1, x=x, valid=valid,
                zt=zt, m=m, H=H, mu=mu, logv=logv, noise=np.ones(L))


def _tspecs():
    return tk.build_kernel_specs(*SPEC_ARGS)


def test_kernel_specs_and_init_match_hlax():
    (s0, s1), (t0, t1) = jk.build_kernel_specs(*SPEC_ARGS), _tspecs()
    for a, b in ((s0, t0), (s1, t1)):
        assert [[(f.kind, f.dim, f.num) for f in c.factors]
                for c in a.components] == \
            [[(f.kind, f.dim, f.num) for f in c.factors]
             for c in b.components]
        pj = jk.init_kernel_params(a, L, jnp.float64)
        pt = tk.init_kernel_params(b, L)
        assert [sorted(p) for p in pj] == [sorted(p) for p in pt]
        for p, q in zip(pj, pt):
            for k in p:
                np.testing.assert_array_equal(q[k].numpy(), np.asarray(p[k]))
    for cs in (True, False):
        np.testing.assert_array_equal(
            tk.noise_value(tk.noise_init(L, cs), cs).numpy(),
            np.asarray(jk.noise_value(jk.noise_init(L, cs), cs)))
    assert tk.default_eps(torch.float64) == jk.default_eps(jnp.float64)
    assert tk.default_eps(torch.float32) == jk.default_eps(jnp.float32)


@pytest.mark.parametrize("which", ["xz", "zz", "xx1", "xx0"])
def test_kernel_matrix_matches_hlax(which):
    s = _setup(16)
    t0, t1 = _tspecs()
    catmod = jk.KernelSpec((jk.KernelComponent(
        (jk.KernelFactor("catmod", 3, 2), jk.KernelFactor("rbf", 0))),))
    tcatmod = tk.KernelSpec((tk.KernelComponent(
        (tk.KernelFactor("catmod", 3, 2), tk.KernelFactor("rbf", 0))),))
    kcat = [{"raw_os": s["k0"][0]["raw_os"], "raw_ls_1": s["k0"][0]["raw_ls_0"]}]
    spec, tspec, params = {
        "xz": (s["spec0"], t0, s["k0"]), "zz": (s["spec0"], t0, s["k0"]),
        "xx1": (s["spec1"], t1, s["k1"]),
        "xx0": (catmod, tcatmod, kcat),
    }[which]
    x, z = s["x"], s["zt"]
    a, b, f1, f2 = {"xz": (x, z, False, True), "zz": (z, z, True, True),
                    "xx1": (x, x, False, False),
                    "xx0": (x, x, False, False)}[which]
    kj = jk.kernel_matrix(spec, [{k: jnp.asarray(v) for k, v in p.items()}
                                 for p in params],
                          jnp.asarray(a), jnp.asarray(b), f1, f2)
    kt = tk.kernel_matrix(tspec, [{k: _t(v) for k, v in p.items()}
                                  for p in params], _t(a), _t(b), f1, f2)
    assert tuple(kt.shape) == kj.shape
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-13,
                               atol=1e-14)


def _kld_j(s, k0, k1, zt, mu, logv):
    return jelbo.kld_upper_bound(
        s["spec0"], k0, s["spec1"], k1, jnp.asarray(s["noise"]),
        jnp.asarray(s["m"]), jnp.asarray(s["H"]), zt, jnp.asarray(s["x"]),
        jnp.asarray(s["valid"]), mu, logv, P_TOT, N_TOT, EPS,
        natural_gradient=True, use_pallas_chol=True)


@pytest.mark.parametrize("M", [16, 30])
def test_kld_bound_and_natural_gradient_quantities_match_hlax(M):
    """The bound (~1e-8 relative), its closed-form natural-gradient
    quantities and iH, and the bound's gradients with respect to the kernel
    parameters, the inducing points and the encoder outputs."""
    s = _setup(M, seed=M)
    t0, t1 = _tspecs()
    jk0 = [{k: jnp.asarray(v) for k, v in p.items()} for p in s["k0"]]
    jk1 = [{k: jnp.asarray(v) for k, v in p.items()} for p in s["k1"]]
    args_j = (jk0, jk1, jnp.asarray(s["zt"]), jnp.asarray(s["mu"]),
              jnp.asarray(s["logv"]))
    kld_j, gm_j, gH_j, iH_j = _kld_j(s, *args_j)
    grads_j = jax.grad(lambda *a: _kld_j(s, *a)[0],
                       argnums=(0, 1, 2, 3, 4))(*args_j)

    tk0 = [{k: _t(v).requires_grad_(True) for k, v in p.items()}
           for p in s["k0"]]
    tk1 = [{k: _t(v).requires_grad_(True) for k, v in p.items()}
           for p in s["k1"]]
    zt, mu, logv = (_t(s[k]).requires_grad_(True)
                    for k in ("zt", "mu", "logv"))
    kld_t, gm_t, gH_t, iH_t = telbo.kld_upper_bound(
        t0, tk0, t1, tk1, _t(s["noise"]), _t(s["m"]), _t(s["H"]), zt,
        _t(s["x"]), _t(s["valid"]), mu, logv, P_TOT, N_TOT, EPS,
        natural_gradient=True, use_pallas_chol=True)
    np.testing.assert_allclose(kld_t.item(), float(kld_j), rtol=1e-8)
    for got, want in ((gm_t, gm_j), (gH_t, gH_j), (iH_t, iH_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-8 * np.abs(want).max())

    kld_t.backward()
    flat_t = [v.grad for p in tk0 + tk1 for v in p.values()] \
        + [zt.grad, mu.grad, logv.grad]
    gk0, gk1, gz, gmu, glv = grads_j
    flat_j = [pj[k] for pj, pt in zip(gk0 + gk1, tk0 + tk1) for k in pt] \
        + [gz, gmu, glv]
    assert len(flat_t) == len(flat_j)
    # the gradients reach O(1e4) through sums with heavy cancellation, so
    # the absolute tolerance scales with the largest of them
    gmax = max(np.abs(np.asarray(w)).max() for w in flat_j)
    for got, want in zip(flat_t, flat_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-9 * gmax)


@pytest.mark.parametrize("with_ih,jitter", [(True, 0.0), (False, 0.0),
                                            (True, 1e-3)])
def test_natural_gradient_update_matches_hlax(with_ih, jitter):
    s = _setup(30, seed=3)
    rng = np.random.default_rng(13)
    gm = rng.standard_normal((L, 30, 1))
    gHs = rng.standard_normal((L, 30, 30)) / 10.0
    gH = 0.4 * (gHs + gHs.transpose(0, 2, 1))
    iH = np.linalg.inv(s["H"]) if with_ih else None
    m_j, H_j = jelbo.natural_gradient_update(
        jnp.asarray(s["m"]), jnp.asarray(s["H"]), jnp.asarray(gm),
        jnp.asarray(gH), 0.01,
        iH=None if iH is None else jnp.asarray(iH), jitter=jitter)
    m_t, H_t = telbo.natural_gradient_update(
        _t(s["m"]), _t(s["H"]), _t(gm), _t(gH), 0.01,
        iH=None if iH is None else _t(iH), jitter=jitter)
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-8,
                               atol=1e-10)
