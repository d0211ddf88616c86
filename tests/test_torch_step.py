"""Port's train step against hlax's jitted ``make_train_step``: five steps
from identical weights, with the reparameterization noise of each hlax step
injected into the port's step, both float64 on the CPU.

Conv HLVAE on D4 types (324 real + 972 cat(5) pixels), z=8, hidden 50,
S=4 subjects x T=5 (the last one padded), M=30 (the mid Cholesky path),
natural gradients.  The jitter is 1e-4, so no pivot falls below the guard's
floor and hlax's CPU fallback (XLA's Cholesky) computes the same factors
as the port.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hlax.data.reader import encode_raw
from hlax.gp import kernels as jk
from hlax.models import HLVAE, HLVAEConfig
from hlax.train import step as jstep
from hlax_torch.convert import state_from_hlax
from hlax_torch.data.reader import encode_raw as t_encode_raw
from hlax_torch.gp import kernels as tk
from hlax_torch.models import hlvae as thlvae
from hlax_torch.train import checkpoint as tckpt
from hlax_torch.train import step as tstep

torch.set_num_threads(1)

S, T, L, M, HID = 4, 5, 8, 30, 50
P_TOT, N_TOT, EPS = 20.0, 100.0, 1e-4
N_REAL, N_CAT, NCLASS = 324, 972, 5
N_STEPS = 5
SPEC_ARGS = ([2], [], [0],
             [{"cat_covariate": 3, "cont_covariate": 0},
              {"cat_covariate": 4, "cont_covariate": 1},
              {"cat_covariate": 2, "cont_covariate": 0}], [], [], 2)


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def run_trajectories(use_pallas_chol: bool = True):
    """hlax's and the port's N_STEPS steps from the same weights and noise,
    both with ``use_pallas_chol`` (hlax on the CPU takes XLA's Cholesky
    either way)."""
    rng = np.random.default_rng(7)
    n = S * T
    raw = np.column_stack([rng.random((n, N_REAL)) * 255,
                           rng.integers(0, NCLASS, (n, N_CAT)).astype(float)])
    miss = (rng.random(raw.shape) > 0.25).astype(float)
    types = ([{"type": "real", "dim": 1, "nclass": 1}] * N_REAL
             + [{"type": "cat", "dim": 1, "nclass": NCLASS}] * N_CAT)
    het = encode_raw(raw, types, miss_mask=miss)
    t_het = t_encode_raw(raw, types, miss_mask=miss)
    valid = np.ones((S, T))
    valid[-1, 3:] = 0.0
    rv = valid.reshape(-1)[:, None]
    labels = np.zeros((n, 6))
    labels[:, 0] = np.tile(np.arange(T), S)
    labels[:, 1] = np.repeat(rng.integers(-9, 11, S), T)
    labels[:, 2] = np.repeat(np.arange(S), T)
    labels[:, 3] = np.repeat(rng.integers(0, 2, S), T)
    labels[:, 4] = np.repeat(rng.integers(0, 2, S), T)
    batch_np = {"data": het.data * rv, "mask": het.mask * rv,
                "theta_mask": het.theta_mask * rv, "labels": labels * rv,
                "valid": valid}
    for k in ("data", "mask", "theta_mask"):
        assert np.array_equal(getattr(t_het, k) * rv, batch_np[k])

    # hlax: model, state, jitted step
    cfg = HLVAEConfig(layout=het.layout, z_dim=L, h_dims=(HID,), y_dim=5,
                      conv=True, dtype=jnp.float64)
    model = HLVAE(cfg)
    batch = {k: jnp.asarray(v, jnp.float64) for k, v in batch_np.items()}
    key = jax.random.PRNGKey(3)
    vae = model.init(key, batch["data"], batch["mask"], batch["theta_mask"],
                     key)
    spec0, spec1 = jk.build_kernel_specs(*SPEC_ARGS)
    k0 = [{k: v + 0.3 * rng.standard_normal(v.shape) for k, v in p.items()}
          for p in jk.init_kernel_params(spec0, L, jnp.float64)]
    k1 = [{k: v + 0.3 * rng.standard_normal(v.shape) for k, v in p.items()}
          for p in jk.init_kernel_params(spec1, L, jnp.float64)]
    rows = labels[valid.reshape(-1) > 0]
    zt = np.stack([rows[rng.choice(len(rows), M)] for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    m = rng.standard_normal((L, M, 1)) * 0.1
    Hh = rng.standard_normal((L, M, M)) / 3.0
    H = Hh @ Hh.transpose(0, 2, 1) + 0.5 * np.eye(M)
    raw_noise = jk.noise_init(L, True, jnp.float64)
    jcfg = jstep.TrainConfig(latent_dim=L, M=M, P_tot=P_TOT, N_tot=N_TOT,
                             id_covariate=2, natural_gradient=True,
                             constrain_scales=True, gp_dtype=jnp.float64,
                             eps=EPS, use_pallas_chol=use_pallas_chol)
    state = jstep.TrainState(
        vae=vae, k0=k0, k1=k1, raw_noise=raw_noise, zt=jnp.asarray(zt),
        m=jnp.asarray(m), H=jnp.asarray(H), opt_state=None,
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(42))
    state = state._replace(opt_state=jstep.make_optimizer(jcfg).init(
        jstep._trainable(state, jcfg)))
    step_j = jax.jit(jstep.make_train_step(model, spec0, spec1, jcfg))

    # port: the same weights and GP state
    tcfg = tstep.TrainConfig(latent_dim=L, M=M, P_tot=P_TOT, N_tot=N_TOT,
                             id_covariate=2, natural_gradient=True,
                             constrain_scales=True, gp_dtype=torch.float64,
                             eps=EPS, use_pallas_chol=use_pallas_chol)
    tmodel = thlvae.HLVAE(thlvae.HLVAEConfig(
        layout=t_het.layout, z_dim=L, h_dims=(HID,), y_dim=5, conv=True),
        torch.Generator().manual_seed(0), "cpu").double()
    t0, t1 = tk.build_kernel_specs(*SPEC_ARGS)
    tstate = state_from_hlax(vae, [{k: np.asarray(v) for k, v in p.items()}
                                   for p in k0],
                             [{k: np.asarray(v) for k, v in p.items()}
                              for p in k1], np.asarray(raw_noise), zt, m, H,
                             tmodel, tcfg)
    step_t = tstep.make_train_step(tmodel, t0, t1, tcfg)
    tbatch = {k: _t(v) for k, v in batch_np.items()}

    out_j, out_t = [], []
    for _ in range(N_STEPS):
        # the jitted step draws its noise from split(state.rng)[1]
        _, sub = jax.random.split(state.rng)
        o = model.apply(state.vae, batch["data"], batch["mask"],
                        batch["theta_mask"], sub)
        eps = (np.asarray(o["z"]) - np.asarray(o["mu"])) \
            / np.exp(0.5 * np.asarray(o["log_var"]))
        state, mj = step_j(state, batch)
        out_j.append({k: float(v) for k, v in mj.items()})
        mt = step_t(tstate, tbatch, eps=_t(eps))
        out_t.append({k: v.item() for k, v in mt.items()})
    return dict(out_j=out_j, out_t=out_t, state=state, tstate=tstate,
                tmodel=tmodel, tcfg=tcfg)


@pytest.fixture(scope="module")
def trajectories():
    return run_trajectories()


@pytest.mark.parametrize("metric", ["loss", "nll", "kld", "recon",
                                    "miss_recon"])
def test_five_step_trajectory_matches_hlax(trajectories, metric):
    got = [o[metric] for o in trajectories["out_t"]]
    want = [o[metric] for o in trajectories["out_j"]]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if metric == "loss":   # a real trajectory, not a fixed point
        assert abs(want[-1] - want[0]) > 1.0


def test_five_step_gp_state_matches_hlax(trajectories):
    """The natural-gradient (m, H) and the Adam-trained zt after 5 steps."""
    s, ts = trajectories["state"], trajectories["tstate"]
    assert ts.step == N_STEPS
    for a, b in ((ts.m, s.m), (ts.H, s.H), (ts.zt, s.zt)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5,
                                   atol=1e-7 * np.abs(b).max())


def test_checkpoint_round_trip(trajectories, tmp_path):
    """``final.pt`` restores the whole state, Adam and generator included."""
    ts = trajectories["tstate"]
    path = tckpt.save(str(tmp_path), ts)
    assert path.endswith("final.pt")
    fresh = tstep.TrainState(
        vae=thlvae.HLVAE(ts.vae.cfg, torch.Generator().manual_seed(5),
                         "cpu").double(),
        k0=[{k: torch.zeros_like(v) for k, v in p.items()} for p in ts.k0],
        k1=[{k: torch.zeros_like(v) for k, v in p.items()} for p in ts.k1],
        raw_noise=torch.zeros_like(ts.raw_noise), zt=torch.zeros_like(ts.zt),
        m=torch.zeros_like(ts.m), H=torch.zeros_like(ts.H), optimizer=None,
        generator=torch.Generator().manual_seed(9))
    fresh.optimizer = tstep.make_optimizer(fresh, trajectories["tcfg"])
    assert tckpt.restore(str(tmp_path), fresh)
    assert not tckpt.restore(str(tmp_path / "absent"), fresh)
    a, b = tckpt.state_dict(ts), tckpt.state_dict(fresh)
    for name in a["vae"]:
        torch.testing.assert_close(a["vae"][name], b["vae"][name], rtol=0,
                                   atol=0)
    for k in ("zt", "m", "H", "raw_noise"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert b["step"] == N_STEPS
    torch.testing.assert_close(a["generator"], b["generator"])
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        torch.testing.assert_close(sa[i]["exp_avg"], sb[i]["exp_avg"])
