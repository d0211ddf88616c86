"""The float64 natural-gradient chain (``nat_grad_dtype`` of the KLD bound,
``--nat_grad_f64`` of the train step) on float32 inputs, against hlax with
x64 on, on the CPU.

The bound and the GP state are float32; K0zz and H are factorized again in
float64 for the chain.  The float32 parts on either side round differently
(XLA's and PyTorch's CPU kernels), so the results are held to 1e-6
relative, the float32 inputs' bar.  That bar needs well-conditioned
float32 parts: the jitter is 0.5 and M = 8 (at jitter 1e-3 and M = 16 the
float32 bounds themselves differ by 4e-4 relative, on either side of the
chain).  The chain's own float64 inverse of H agrees with hlax's to 1e-12.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hlax.gp import elbo as jelbo
from hlax.gp import kernels as jk
from hlax.train import step as jstep
from hlax_torch.gp import elbo as telbo
from hlax_torch.gp import kernels as tk
from hlax_torch.train import step as tstep

torch.set_num_threads(1)

S, T, L, Q, M = 4, 5, 4, 6, 8
P_TOT, N_TOT, EPS = 20.0, 100.0, 0.5
SPEC_ARGS = ([2], [], [0],
             [{"cat_covariate": 3, "cont_covariate": 0},
              {"cat_covariate": 4, "cont_covariate": 1},
              {"cat_covariate": 2, "cont_covariate": 0}], [], [], 2)
RTOL = 1e-6


def _setup(seed):
    """float32 GP inputs of the bound: S subjects (the last one padded),
    M inducing points, an SPD H."""
    rng = np.random.default_rng(seed)
    spec0, spec1 = jk.build_kernel_specs(*SPEC_ARGS)
    perturb = lambda ps: [{k: np.asarray(v) + 0.3 * rng.standard_normal(
        v.shape) for k, v in p.items()} for p in ps]
    k0 = perturb(jk.init_kernel_params(spec0, L, jnp.float64))
    k1 = perturb(jk.init_kernel_params(spec1, L, jnp.float64))
    x = np.zeros((S, T, Q))
    x[:, :, 0] = np.arange(T)[None]
    x[:, :, 1] = rng.integers(-9, 11, S)[:, None]
    x[:, :, 2] = np.arange(S)[:, None]
    x[:, :, 3] = rng.integers(0, 2, S)[:, None]
    x[:, :, 4] = rng.integers(0, 2, S)[:, None]
    valid = np.ones((S, T))
    valid[-1, 3:] = 0.0
    x = x * valid[:, :, None]
    rows = x.reshape(-1, Q)[valid.reshape(-1) > 0]
    zt = np.stack([rows[rng.choice(len(rows), M)] for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    m = rng.standard_normal((L, M, 1))
    Hh = rng.standard_normal((L, M, M)) / 3.0
    H = Hh @ Hh.transpose(0, 2, 1) + 0.5 * np.eye(M)
    mu = rng.standard_normal((S, T, L)) * valid[:, :, None]
    logv = rng.standard_normal((S, T, L)) * 0.3 * valid[:, :, None]
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(spec0=spec0, spec1=spec1,
                k0=[{k: f32(v) for k, v in p.items()} for p in k0],
                k1=[{k: f32(v) for k, v in p.items()} for p in k1],
                x=f32(x), valid=f32(valid), zt=f32(zt), m=f32(m), H=f32(H),
                mu=f32(mu), logv=f32(logv), noise=np.ones(L, np.float32))


def _bound(s, port, nat_dtype):
    if port:
        t0, t1 = tk.build_kernel_specs(*SPEC_ARGS)
        t = lambda a: torch.tensor(a)
        tp = lambda ps: [{k: t(v) for k, v in p.items()} for p in ps]
        return telbo.kld_upper_bound(
            t0, tp(s["k0"]), t1, tp(s["k1"]), t(s["noise"]), t(s["m"]),
            t(s["H"]), t(s["zt"]), t(s["x"]), t(s["valid"]), t(s["mu"]),
            t(s["logv"]), P_TOT, N_TOT, EPS, natural_gradient=True,
            nat_grad_dtype=nat_dtype, use_pallas_chol=True)
    j = jnp.asarray
    jp = lambda ps: [{k: j(v) for k, v in p.items()} for p in ps]
    return jelbo.kld_upper_bound(
        s["spec0"], jp(s["k0"]), s["spec1"], jp(s["k1"]), j(s["noise"]),
        j(s["m"]), j(s["H"]), j(s["zt"]), j(s["x"]), j(s["valid"]),
        j(s["mu"]), j(s["logv"]), P_TOT, N_TOT, EPS, natural_gradient=True,
        use_pallas_chol=True, nat_grad_dtype=nat_dtype)


@pytest.mark.parametrize("seed", [0, 1])
def test_kld_bound_with_float64_chain_matches_hlax(seed):
    """float32 bound, float64 grad_m, grad_H and iH: each within 1e-6
    relative of hlax's (``nat_grad_dtype=jnp.float64``)."""
    s = _setup(seed)
    kld_j, gm_j, gH_j, iH_j = _bound(s, False, jnp.float64)
    kld_t, gm_t, gH_t, iH_t = _bound(s, True, torch.float64)
    assert kld_t.dtype == torch.float32
    np.testing.assert_allclose(kld_t.item(), float(kld_j), rtol=RTOL)
    for got, want in ((gm_t, gm_j), (gH_t, gH_j), (iH_t, iH_j)):
        assert got.dtype == torch.float64 and want.dtype == jnp.float64
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
    np.testing.assert_allclose(iH_t.numpy(), np.asarray(iH_j), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(iH_j)).max())


def test_float64_chain_refactorizes_in_float64():
    """The float64 chain's iH is the float64 inverse of the float32 H, more
    accurate than the float32 chain's: closer to numpy's float64 inverse by
    orders of magnitude."""
    s = _setup(2)
    exact = np.linalg.inv(s["H"].astype(np.float64))
    iH64 = _bound(s, True, torch.float64)[3].numpy()
    iH32 = _bound(s, True, None)[3].numpy().astype(np.float64)
    err64, err32 = (np.abs(a - exact).max() / np.abs(exact).max()
                    for a in (iH64, iH32))
    assert err64 < 1e-12 and err64 < 1e-4 * err32


def test_natural_gradient_update_in_float64_casts_back():
    """float32 (m, H) with float64 gradients: the update runs in float64
    and returns float32, as hlax's does."""
    s = _setup(3)
    _, gm_j, gH_j, iH_j = _bound(s, False, jnp.float64)
    _, gm_t, gH_t, iH_t = _bound(s, True, torch.float64)
    m_j, H_j = jelbo.natural_gradient_update(
        jnp.asarray(s["m"]), jnp.asarray(s["H"]), gm_j, gH_j, 0.01, iH=iH_j)
    m_t, H_t = telbo.natural_gradient_update(
        torch.tensor(s["m"]), torch.tensor(s["H"]), gm_t, gH_t, 0.01,
        iH=iH_t)
    assert m_t.dtype == H_t.dtype == torch.float32
    for got, want in ((m_t, m_j), (H_t, H_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


N_STEPS, HID = 3, 16


def test_three_step_nat_grad_f64_trajectory_matches_hlax():
    """Three train steps with ``nat_grad_f64`` on a float32 GP (float64 MLP
    model, hlax's noise injected): the losses within rtol 1e-6, and the
    float32 (m, H) the float64 chain updates within 1e-6 of hlax's."""
    from hlax.data.reader import encode_raw
    from hlax.models import HLVAE, HLVAEConfig
    from hlax_torch.convert import state_from_hlax
    from hlax_torch.data.reader import encode_raw as t_encode_raw
    from hlax_torch.models import hlvae as thlvae
    from test_nonconv import TYPES, _make_split

    s = _setup(4)
    rng = np.random.default_rng(5)
    raw, miss, _ = _make_split(rng, n_subj=S, T=T, uid_start=0, subj_start=0)
    het = encode_raw(raw, TYPES, miss_mask=miss)
    t_het = t_encode_raw(raw, TYPES, miss_mask=miss)
    rv = s["valid"].reshape(-1)[:, None].astype(np.float64)
    batch_np = {"data": het.data * rv, "mask": het.mask * rv,
                "theta_mask": het.theta_mask * rv,
                "labels": s["x"].reshape(S * T, Q).astype(np.float64),
                "valid": s["valid"].astype(np.float64)}
    model = HLVAE(HLVAEConfig(layout=het.layout, z_dim=L, h_dims=(HID,),
                              y_dim=3, conv=False, dtype=jnp.float64))
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    key = jax.random.PRNGKey(3)
    vae = model.init(key, batch["data"], batch["mask"], batch["theta_mask"],
                     key)
    kw = dict(latent_dim=L, M=M, P_tot=P_TOT, N_tot=N_TOT, id_covariate=2,
              natural_gradient=True, constrain_scales=True, eps=EPS,
              nat_grad_f64=True)
    jcfg = jstep.TrainConfig(gp_dtype=jnp.float32, **kw)
    spec0, spec1 = jk.build_kernel_specs(*SPEC_ARGS)
    raw_noise = np.asarray(jk.noise_init(L, True, jnp.float32))
    state = jstep.TrainState(
        vae=vae, k0=[{k: jnp.asarray(v) for k, v in p.items()}
                     for p in s["k0"]],
        k1=[{k: jnp.asarray(v) for k, v in p.items()} for p in s["k1"]],
        raw_noise=jnp.asarray(raw_noise), zt=jnp.asarray(s["zt"]),
        m=jnp.asarray(s["m"]), H=jnp.asarray(s["H"]), opt_state=None,
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(42))
    state = state._replace(opt_state=jstep.make_optimizer(jcfg).init(
        jstep._trainable(state, jcfg)))
    step_j = jax.jit(jstep.make_train_step(model, spec0, spec1, jcfg))

    tcfg = tstep.TrainConfig(gp_dtype=torch.float32, **kw)
    tmodel = thlvae.HLVAE(thlvae.HLVAEConfig(
        layout=t_het.layout, z_dim=L, h_dims=(HID,), y_dim=3, conv=False),
        torch.Generator().manual_seed(0), "cpu").double()
    tstate = state_from_hlax(vae, s["k0"], s["k1"], raw_noise, s["zt"],
                             s["m"], s["H"], tmodel, tcfg)
    assert tstate.H.dtype == torch.float32
    t0, t1 = tk.build_kernel_specs(*SPEC_ARGS)
    step_t = tstep.make_train_step(tmodel, t0, t1, tcfg)
    tbatch = {k: torch.tensor(v) for k, v in batch_np.items()}
    got, want = [], []
    for _ in range(N_STEPS):
        _, sub = jax.random.split(state.rng)
        o = model.apply(state.vae, batch["data"], batch["mask"],
                        batch["theta_mask"], sub)
        eps = (np.asarray(o["z"]) - np.asarray(o["mu"])) \
            / np.exp(0.5 * np.asarray(o["log_var"]))
        state, mj = step_j(state, batch)
        want.append(float(mj["loss"]))
        got.append(step_t(tstate, tbatch, eps=torch.tensor(eps))[
            "loss"].item())
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert tstate.m.dtype == tstate.H.dtype == torch.float32
    for a, b in ((tstate.m, state.m), (tstate.H, state.H)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                   atol=RTOL * np.abs(b).max())
