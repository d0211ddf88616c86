"""``use_pallas_chol=False``: the port's library path against hlax's.

Under ``False`` hlax factorizes the bound's K0zz, H and B blocks and the
natural-gradient inverses with XLA's unguarded Cholesky and triangular
solves; the port with ``torch.linalg.cholesky_ex`` and ``solve_triangular``
(``gp.elbo.library_chol_inv``), where a matrix that does not factorize
gives NaN, as hlax's does.  The default (``True``) keeps the kernels'
pivot floor.  float64 on the CPU unless a test says otherwise; inputs from
numpy seeds.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hlax.gp import elbo as jelbo
from hlax_torch.cli import generate as gen_cli
from hlax_torch.cli import main as cli
from hlax_torch.gp import elbo as telbo
from hlax_torch.ops import linalg_small as ls

import test_torch_cli as tcli
import test_torch_gp as tgp
import test_torch_step as tstep_test

torch.set_num_threads(1)


def _kld(s, use_pallas_chol, dtype=np.float64, H=None):
    """The port's and hlax's kld_upper_bound with natural gradients on the
    inputs of ``test_torch_gp._setup`` in ``dtype``."""
    H = s["H"] if H is None else H
    t = lambda a: torch.tensor(np.asarray(a, dtype))
    tp = lambda ps: [{k: t(v) for k, v in p.items()} for p in ps]
    t0, t1 = tgp._tspecs()
    port = telbo.kld_upper_bound(
        t0, tp(s["k0"]), t1, tp(s["k1"]), t(s["noise"]), t(s["m"]), t(H),
        t(s["zt"]), t(s["x"]), t(s["valid"]), t(s["mu"]), t(s["logv"]),
        tgp.P_TOT, tgp.N_TOT, tgp.EPS, natural_gradient=True,
        use_pallas_chol=use_pallas_chol)
    j = lambda a: jnp.asarray(np.asarray(a, dtype))
    jp = lambda ps: [{k: j(v) for k, v in p.items()} for p in ps]
    ref = jelbo.kld_upper_bound(
        s["spec0"], jp(s["k0"]), s["spec1"], jp(s["k1"]), j(s["noise"]),
        j(s["m"]), j(H), j(s["zt"]), j(s["x"]), j(s["valid"]), j(s["mu"]),
        j(s["logv"]), tgp.P_TOT, tgp.N_TOT, tgp.EPS, natural_gradient=True,
        use_pallas_chol=False)
    return port, ref


@pytest.mark.parametrize("M", [16, 30])
def test_kld_bound_without_pallas_chol_matches_hlax(M):
    port, ref = _kld(tgp._setup(M, seed=5), use_pallas_chol=False)
    np.testing.assert_allclose(port[0].item(), float(ref[0]), rtol=1e-8)
    for got, want in zip(port[1:], ref[1:]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8,
                                   atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("with_ih", [False, True])
def test_natural_gradient_update_without_pallas_chol_matches_hlax(with_ih):
    s = tgp._setup(30, seed=3)
    rng = np.random.default_rng(13)
    gm = rng.standard_normal((tgp.L, 30, 1))
    gHs = rng.standard_normal((tgp.L, 30, 30)) / 10.0
    gH = 0.4 * (gHs + gHs.transpose(0, 2, 1))
    iH = np.linalg.inv(s["H"]) if with_ih else None
    m_j, H_j = jelbo.natural_gradient_update(
        jnp.asarray(s["m"]), jnp.asarray(s["H"]), jnp.asarray(gm),
        jnp.asarray(gH), 0.01, iH=None if iH is None else jnp.asarray(iH),
        use_pallas_chol=False)
    m_t, H_t = telbo.natural_gradient_update(
        tgp._t(s["m"]), tgp._t(s["H"]), tgp._t(gm), tgp._t(gH), 0.01,
        iH=None if iH is None else tgp._t(iH), use_pallas_chol=False)
    for got, want in ((H_t, H_j), (m_t, m_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8,
                                   atol=1e-10 * np.abs(want).max())


@pytest.fixture(scope="module")
def trajectories_false():
    return tstep_test.run_trajectories(use_pallas_chol=False)


@pytest.mark.parametrize("metric", ["loss", "nll", "kld", "recon",
                                    "miss_recon"])
def test_five_step_trajectory_without_pallas_chol_matches_hlax(
        trajectories_false, metric):
    got = [o[metric] for o in trajectories_false["out_t"]]
    want = [o[metric] for o in trajectories_false["out_j"]]
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_five_step_gp_state_without_pallas_chol_matches_hlax(
        trajectories_false):
    s, ts = trajectories_false["state"], trajectories_false["tstate"]
    assert ts.step == tstep_test.N_STEPS
    for a, b in ((ts.m, s.m), (ts.H, s.H), (ts.zt, s.zt)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-8,
                                   atol=1e-10 * np.abs(b).max())


def test_failed_factorization_gives_nan_as_hlax():
    """A matrix with a negative pivot: hlax's Cholesky gives NaN on and
    below the diagonal and zeros above (not LAPACK's partial factor), its
    inverse factor NaN throughout, and so does ``library_chol_inv``; the
    other matrices of the batch factorize as usual."""
    rng = np.random.default_rng(0)
    R = rng.standard_normal((3, 6, 6))
    A = R @ R.transpose(0, 2, 1) + 6 * np.eye(6)
    A[1, 4, 4] = -1.0
    L, iL = telbo.library_chol_inv(torch.tensor(A))
    want = jnp.linalg.cholesky(jnp.asarray(A))
    want_i = np.asarray(jax.scipy.linalg.solve_triangular(
        want, jnp.broadcast_to(jnp.eye(6), want.shape), lower=True))
    want = np.asarray(want)
    assert np.array_equal(np.isnan(want[1]), np.tril(np.ones((6, 6))) > 0)
    np.testing.assert_array_equal(L[1].numpy(), want[1])
    assert np.isnan(want_i[1]).all() and np.isnan(iL[1].numpy()).all()
    for b in (0, 2):
        np.testing.assert_allclose(L[b].numpy(), want[b], rtol=1e-12)
        np.testing.assert_allclose(iL[b].numpy(), want_i[b], rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("pivot", ["tiny", "negative"])
def test_float32_pivot_under_the_floor(pivot):
    """float32 H with a pivot under the kernels' floor (1e-6 of max diag):
    1e-8 (positive) or -1e-3 (the matrix is indefinite).  The library path
    gives hlax's unfloored inverse of H (``tiny``: 1e8 at the pivot) or its
    NaN bound (``negative``); the floored default gives neither (1e6 at the
    pivot, a finite bound).  (The float32 bound itself is ill-conditioned at
    this jitter and differs from hlax's by ~1e-3 either way, so the test
    reads what H's factorization decides.)"""
    s = tgp._setup(16, seed=2)
    H = np.broadcast_to(np.eye(16), s["H"].shape).copy()
    H[0, 5, 5] = 1e-8 if pivot == "tiny" else -1e-3
    port, ref = _kld(s, use_pallas_chol=False, dtype=np.float32, H=H)
    floored, _ = _kld(s, use_pallas_chol=True, dtype=np.float32, H=H)
    assert math.isfinite(floored[0].item())
    if pivot == "negative":
        assert math.isnan(float(ref[0])) and math.isnan(port[0].item())
        return
    assert math.isfinite(float(ref[0])) and math.isfinite(port[0].item())
    want = np.asarray(ref[3])
    np.testing.assert_allclose(port[3].numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    assert want[0, 5, 5] == pytest.approx(1e8, rel=1e-5)
    assert floored[3][0, 5, 5].item() == pytest.approx(1e6, rel=1e-5)


@pytest.mark.parametrize("flag", [True, False])
def test_cli_flag_reaches_the_step(tcli_data_dir, tmp_path, monkeypatch,
                                   flag):
    """--use_pallas_chol reaches the train step: with False every
    factorization of the training steps is the library's, with True none
    is (the plain versions of the kernels run on the CPU instead)."""
    calls = {"library": 0, "kernels": 0}
    lib, plain = telbo.library_chol_inv, ls._chol_inv_plain

    def spy_lib(a):
        calls["library"] += 1
        return lib(a)

    def spy_plain(a):
        calls["kernels"] += 1
        return plain(a)

    monkeypatch.setattr(telbo, "library_chol_inv", spy_lib)
    monkeypatch.setattr(ls, "_chol_inv_plain", spy_plain)
    out = cli.main(tcli._argv(tcli_data_dir, tmp_path / "run", "--epochs=1",
                              f"--use_pallas_chol={flag}"))
    assert out["steps"] == 2
    assert all(map(math.isfinite, out["loss_arrs"]["net"]))
    if flag:
        assert calls["library"] == 0 and calls["kernels"] > 0
    else:
        # per step: K0zz, H and the B blocks in the bound, iH_new in the
        # natural-gradient update
        assert calls["library"] == 4 * 2 and calls["kernels"] == 0


@pytest.fixture(scope="module")
def tcli_data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data"))
    gen_cli.main(["--destination", d, "--num_3", "2", "--num_6", "2",
                  "--datatype_config", "D4", "--seed", "3",
                  "--splits", "prediction,test,validation"])
    return d
