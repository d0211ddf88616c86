"""Sequences longer than 128: the port's blocked composition of
``chol_inv_blocked`` and what runs through it (the train step's B blocks,
the eval buckets of 256) against hlax, float64 on the CPU.

hlax factorizes n > 128 on the CPU with XLA's Cholesky, and with its
composition over the Pallas mid kernel when ``FORCE_PALLAS`` runs that
kernel in interpret mode; the port runs the composition on the CPU too,
with the plain version on the diagonal blocks.  Values are held to 1e-10
relative and gradients to 1e-8, the train step and the eval bounds to
1e-8.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hlax.data.dataset import LongitudinalDataset
from hlax.data.reader import encode_raw
from hlax.eval import validate as jval
from hlax.gp import kernels as jk
from hlax.models import HLVAE, HLVAEConfig
from hlax.ops import linalg_small as ls
from hlax.train import step as jstep
from hlax_torch.convert import state_from_hlax
from hlax_torch.data.dataset import LongitudinalDataset as TDataset
from hlax_torch.data.reader import encode_raw as t_encode_raw
from hlax_torch.eval import validate as tval
from hlax_torch.gp import kernels as tk
from hlax_torch.models import hlvae as thlvae
from hlax_torch.ops import linalg_small as tls
from hlax_torch.train import step as tstep
from test_nonconv import TYPES, _make_split

torch.set_num_threads(1)

SPEC_ARGS = ([2], [], [0], [{"cont_covariate": 0, "cat_covariate": 2}], [],
             [], 2)


def _spd(rng, batch, n):
    a = rng.normal(size=(batch, n, n))
    return a @ np.swapaxes(a, -1, -2) / n + 0.5 * np.eye(n)


def _compare(n, batch, seed):
    """Values and the gradient of a loss that reads L, L^-1 and log det,
    the gradients symmetrized."""
    rng = np.random.default_rng(seed)
    a = _spd(rng, batch, n)
    wl, wi = rng.normal(size=(2, batch, n, n))

    def f_j(x):
        l, il = ls.chol_inv_blocked(x)
        return jnp.sum(l * wl) + jnp.sum(il * wi) \
            + jnp.sum(ls.logdet_from_chol(l))

    lj, ilj = ls.chol_inv_blocked(jnp.asarray(a))
    gj = np.asarray(jax.grad(f_j)(jnp.asarray(a)))
    at = torch.tensor(a, requires_grad=True)
    lt, ilt = tls.chol_inv_blocked(at)
    f = (lt * torch.tensor(wl)).sum() + (ilt * torch.tensor(wi)).sum() \
        + 2 * torch.log(torch.diagonal(lt, dim1=-2, dim2=-1)).sum()
    f.backward()
    for got, want in ((lt, lj), (ilt, ilj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
    iu = np.triu_indices(n, 1)
    assert not lt.detach().numpy()[..., iu[0], iu[1]].any()
    assert not ilt.detach().numpy()[..., iu[0], iu[1]].any()
    # the port's gradient follows _bwd_reference's lower convention, XLA's
    # Cholesky gradient is symmetric: compare G + G^T
    sym = lambda g: g + np.swapaxes(g, -1, -2)
    np.testing.assert_allclose(sym(at.grad.numpy()), sym(gj), rtol=1e-8,
                               atol=1e-8 * np.abs(sym(gj)).max())


@pytest.mark.parametrize("n", [136, 200, 256, 131])
def test_blocked_composition_matches_hlax(n):
    """n = 136, 200, 256 split into hlax's blocks (2 x 68, 2 x 100,
    2 x 128); n = 131 has no divisor in [8, 128], where hlax uses XLA's
    Cholesky and the port blocks of 66 and 65."""
    _compare(n, 2, n)


def test_blocked_composition_matches_hlax_pallas_path():
    """hlax's own composition, its diagonal blocks on the Pallas mid kernel
    in interpret mode (``FORCE_PALLAS``), one matrix of 136."""
    old = ls.FORCE_PALLAS
    ls.FORCE_PALLAS = True
    try:
        _compare(136, 1, 7)
    finally:
        ls.FORCE_PALLAS = old


def test_block_sizes():
    """hlax's ``_largest_block(n, 128)`` where n has such a divisor (the
    T = 200 and T = 500 sequences, the eval buckets), else the fewest
    blocks of at most 128 with a shorter trailing one."""
    assert tls._block_sizes(200) == [100, 100]
    assert tls._block_sizes(500) == [125] * 4
    assert tls._block_sizes(256) == [128, 128]
    assert tls._block_sizes(512) == [128] * 4
    assert tls._block_sizes(131) == [66, 65]
    assert tls._block_sizes(257) == [86, 86, 85]
    for n in range(129, 700):
        sizes = tls._block_sizes(n)
        assert sum(sizes) == n and max(sizes) <= 128
        assert min(sizes) > tls.MAX_DIAG_BLOCK or \
            tls._largest_block(n, 128) == sizes[0]
        if ls._largest_block(n, 128):
            assert sizes == [ls._largest_block(n, 128)] * len(sizes)


S, T, L, M, HID = 2, 160, 2, 16, 16
EPS = 1e-4


def test_long_sequence_train_step_matches_hlax():
    """Two train steps at T = 160 (S = 2, L = 2, M = 16, the MLP model),
    whose B blocks [2, 2, 160, 160] go through the composition (2 x 80),
    forward and backward: losses, the natural-gradient (m, H) and zt
    within 1e-8 of hlax's."""
    rng = np.random.default_rng(0)
    raw, miss, labels = _make_split(rng, n_subj=S, T=T, uid_start=0,
                                    subj_start=0)
    het = encode_raw(raw, TYPES, miss_mask=miss)
    t_het = t_encode_raw(raw, TYPES, miss_mask=miss)
    valid = np.ones((S, T))
    valid[-1, 150:] = 0.0
    rv = valid.reshape(-1)[:, None]
    batch_np = {"data": het.data * rv, "mask": het.mask * rv,
                "theta_mask": het.theta_mask * rv, "labels": labels * rv,
                "valid": valid}
    model = HLVAE(HLVAEConfig(layout=het.layout, z_dim=L, h_dims=(HID,),
                              y_dim=3, conv=False, dtype=jnp.float64))
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    key = jax.random.PRNGKey(3)
    vae = model.init(key, batch["data"], batch["mask"], batch["theta_mask"],
                     key)
    spec0, spec1 = jk.build_kernel_specs(*SPEC_ARGS)
    perturb = lambda ps: [{k: np.asarray(v) + 0.3 * rng.standard_normal(
        v.shape) for k, v in p.items()} for p in ps]
    k0 = perturb(jk.init_kernel_params(spec0, L, jnp.float64))
    k1 = perturb(jk.init_kernel_params(spec1, L, jnp.float64))
    rows = labels[valid.reshape(-1) > 0]
    zt = np.stack([rows[rng.choice(len(rows), M)] for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    m = rng.standard_normal((L, M, 1)) * 0.1
    Hh = rng.standard_normal((L, M, M)) / 3.0
    H = Hh @ Hh.transpose(0, 2, 1) + 0.5 * np.eye(M)
    raw_noise = np.asarray(jk.noise_init(L, True, jnp.float64))
    kw = dict(latent_dim=L, M=M, P_tot=10.0, N_tot=1600.0, id_covariate=2,
              natural_gradient=True, constrain_scales=True, eps=EPS)
    jcfg = jstep.TrainConfig(gp_dtype=jnp.float64, **kw)
    state = jstep.TrainState(
        vae=vae, k0=[{k: jnp.asarray(v) for k, v in p.items()} for p in k0],
        k1=[{k: jnp.asarray(v) for k, v in p.items()} for p in k1],
        raw_noise=jnp.asarray(raw_noise), zt=jnp.asarray(zt),
        m=jnp.asarray(m), H=jnp.asarray(H), opt_state=None,
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(42))
    state = state._replace(opt_state=jstep.make_optimizer(jcfg).init(
        jstep._trainable(state, jcfg)))
    step_j = jax.jit(jstep.make_train_step(model, spec0, spec1, jcfg))

    tcfg = tstep.TrainConfig(gp_dtype=torch.float64, **kw)
    tmodel = thlvae.HLVAE(thlvae.HLVAEConfig(
        layout=t_het.layout, z_dim=L, h_dims=(HID,), y_dim=3, conv=False),
        torch.Generator().manual_seed(0), "cpu").double()
    tstate = state_from_hlax(vae, k0, k1, raw_noise, zt, m, H, tmodel, tcfg)
    t0, t1 = tk.build_kernel_specs(*SPEC_ARGS)
    step_t = tstep.make_train_step(tmodel, t0, t1, tcfg)
    tbatch = {k: torch.tensor(v) for k, v in batch_np.items()}
    for _ in range(2):
        _, sub = jax.random.split(state.rng)
        o = model.apply(state.vae, batch["data"], batch["mask"],
                        batch["theta_mask"], sub)
        eps = (np.asarray(o["z"]) - np.asarray(o["mu"])) \
            / np.exp(0.5 * np.asarray(o["log_var"]))
        state, mj = step_j(state, batch)
        mt = step_t(tstate, tbatch, eps=torch.tensor(eps))
        for k in ("loss", "nll", "kld"):
            np.testing.assert_allclose(mt[k].item(), float(mj[k]), rtol=1e-8,
                                       err_msg=k)
    for a, b in ((tstate.m, state.m), (tstate.H, state.H),
                 (tstate.zt, state.zt)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-8,
                                   atol=1e-10 * np.abs(b).max())


def test_long_sequence_eval_bounds_match_hlax():
    """The DUBO over a group of 130-step subjects (the 256 bucket, B blocks
    through the composition) and the predictor with a context of 130 steps
    a subject, against hlax."""
    rng = np.random.default_rng(1)
    raw, miss, labels = _make_split(rng, n_subj=3, T=130, uid_start=0,
                                    subj_start=0)
    het = encode_raw(raw, TYPES, miss_mask=miss)
    t_het = t_encode_raw(raw, TYPES, miss_mask=miss)
    ds = LongitudinalDataset(het=het, labels=labels, id_covariate=2,
                             conv=False)
    tds = TDataset(het=t_het, labels=labels, id_covariate=2, conv=False)
    spec0, spec1 = jk.build_kernel_specs(*SPEC_ARGS)
    perturb = lambda ps: [{k: np.asarray(v) + 0.3 * rng.standard_normal(
        v.shape) for k, v in p.items()} for p in ps]
    k0 = perturb(jk.init_kernel_params(spec0, L, jnp.float64))
    k1 = perturb(jk.init_kernel_params(spec1, L, jnp.float64))
    zt = np.stack([labels[rng.choice(len(labels), M)] for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    noise = 0.5 + rng.random(L)
    mu = rng.standard_normal((len(labels), L))
    lv = rng.standard_normal((len(labels), L)) * 0.3
    jgp = (spec0, [{k: jnp.asarray(v) for k, v in p.items()} for p in k0],
           spec1, [{k: jnp.asarray(v) for k, v in p.items()} for p in k1],
           jnp.asarray(noise), jnp.asarray(zt))
    t0, t1 = tk.build_kernel_specs(*SPEC_ARGS)
    tt = lambda x: torch.tensor(np.asarray(x, np.float64))
    tgp = (t0, [{k: tt(v) for k, v in p.items()} for p in k0], t1,
           [{k: tt(v) for k, v in p.items()} for p in k1], tt(noise), tt(zt))
    want = jval.gp_loss_dubo(*jgp, ds, mu, lv, EPS)
    got = tval.gp_loss_dubo(*tgp, tds, mu, lv, EPS)
    np.testing.assert_allclose(got, want, rtol=1e-8)
    args = (labels, mu, labels[:, 2], labels, labels[:, 2], EPS)
    want = np.asarray(jval.gp_predict_dataset(*jgp, *args))
    got = tval.gp_predict_dataset(*tgp, *args)
    np.testing.assert_allclose(got, want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())
