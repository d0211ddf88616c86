"""bfloat16 in the port against hlax: ``compute_dtype=bfloat16`` (the conv
stack, the encoder/decoder MLPs and y_layer in bfloat16, everything else in
float32) and the all-bfloat16 model (``model_dtype=bfloat16``: parameters,
Adam's moments and the data in bfloat16, the GP in float32), on the conv
and the MLP models, from the same converted weights and noise.

Tolerances come from bfloat16's unit roundoff, eps = 2^-8: the two
packages round the same products in other places (flax adds a Dense
layer's bias after rounding the product, PyTorch's fused addmm before;
XLA and PyTorch sum in other orders), so single values differ by a few
bfloat16 ulps and gradients, sums of many such values, by a few eps of
their norm:

  * mu, log_var and theta within 8 eps of each output's largest
    magnitude; log_p_x summed within 1e-2 relative;
  * each parameter's gradient no further from the float64 gradient of the
    same weights and noise than twice hlax's bfloat16 gradient is, plus 8
    eps, all relative to the float64 gradient's norm (Frobenius).  A
    gradient is a sum of many rounded terms that can cancel (a bias's over
    every pixel and row): there both packages can be tens of percent off
    the float64 value, and apart by as much, while neither is wrong;
  * three train steps: each step's loss, NLL and KL term within 1e-2
    relative (2 spacings of bfloat16, 2^-6, for the all-bfloat16 model's
    loss and NLL, which are bfloat16 values); after the steps, m, H and zt within 1e-2 of their norm, and
    each VAE parameter within 2 lr a step plus 4 ulps of its largest
    magnitude: Adam's first steps move a parameter by about lr times the
    sign of its gradient, and a gradient near zero may take either sign
    under bfloat16 noise.

The float32 path is checked to the bit against a restatement of the
model's float32 forward as it was before the options existed.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from hlax.data.reader import encode_raw
from hlax.gp import kernels as jk
from hlax.models import HLVAE, HLVAEConfig
from hlax.models.hlvae import nll_from_log_p
from hlax.train import step as jstep
from hlax_torch.convert import load_hlax_vae, state_from_hlax
from hlax_torch.data.reader import encode_raw as t_encode_raw
from hlax_torch.gp import kernels as tk
from hlax_torch.models import hlvae as thlvae
from hlax_torch.ops import convfuse as tcf
from hlax_torch.train import step as tstep
from test_nonconv import TYPES as MLP_TYPES

torch.set_num_threads(1)

EPS = 2.0 ** -8
S, T, L, M, HID = 4, 5, 8, 30, 32
P_TOT, N_TOT, JITTER, LR = 20.0, 100.0, 1e-4, 1e-3
N_STEPS = 3
SPEC_ARGS = ([2], [], [0],
             [{"cat_covariate": 3, "cont_covariate": 0},
              {"cat_covariate": 4, "cont_covariate": 1},
              {"cat_covariate": 2, "cont_covariate": 0}], [], [], 2)
MODES = {"compute": (jnp.float32, jnp.bfloat16, torch.float32),
         "model": (jnp.bfloat16, None, torch.bfloat16)}


def _bf16_exact(a):
    """``a`` rounded to bfloat16 (by JAX) and held as float64: inputs both
    packages read without a rounding of their own."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float64)


def _data(kind, rng, n):
    if kind == "conv":
        types = ([{"type": "real", "dim": 1, "nclass": 1}] * 324
                 + [{"type": "cat", "dim": 1, "nclass": 5}] * 972)
        raw = np.column_stack([rng.integers(0, 256, (n, 324)),
                               rng.integers(0, 5, (n, 972))]).astype(float)
    else:
        types = MLP_TYPES
        raw = _bf16_exact(np.column_stack([
            rng.normal(0, 1, n), rng.integers(0, 3, n),
            rng.poisson(3.0, n).astype(float), rng.random(n) * 3]))
    miss = (rng.random(raw.shape) > 0.25).astype(float)
    return (encode_raw(raw, types, miss_mask=miss),
            t_encode_raw(raw, types, miss_mask=miss))


def _models(kind, mode, het, t_het, seed=3):
    """hlax's model in ``mode`` from its flax init, and the port's with the
    same weights."""
    jdt, jcdt, tdt = MODES[mode]
    conv = kind == "conv"
    y_dim = 5 if conv else 3
    cfg = HLVAEConfig(layout=het.layout, z_dim=L, h_dims=(HID,), y_dim=y_dim,
                      conv=conv, dtype=jdt, compute_dtype=jcdt)
    model = HLVAE(cfg)
    key = jax.random.PRNGKey(seed)
    params = model.init(key, *(jnp.asarray(a[:4], jdt) for a in (
        het.data, het.mask, het.theta_mask)), key)
    tmodel = thlvae.HLVAE(thlvae.HLVAEConfig(
        layout=t_het.layout, z_dim=L, h_dims=(HID,), y_dim=y_dim, conv=conv,
        compute_dtype=torch.bfloat16 if jcdt is not None else None),
        torch.Generator().manual_seed(0), "cpu").to(tdt)
    load_hlax_vae(tmodel, params)
    return model, params, tmodel


def _rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _loss_j(model, params, data, mask, tmask, key):
    out = model.apply(params, data, mask, tmask, key)
    loss = jnp.sum(nll_from_log_p(out["log_p_x"])) \
        + 0.1 * jnp.sum(out["mu"]) + 0.1 * jnp.sum(out["log_var"])
    return loss, out


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", ["conv", "mlp"])
def test_forward_loss_and_gradients_match_hlax(kind, mode):
    het, t_het = _data(kind, np.random.default_rng(7), 20)
    model, params, tmodel = _models(kind, mode, het, t_het)
    jdt, _, tdt = MODES[mode]
    data, mask, tmask = (jnp.asarray(a, jdt) for a in (
        het.data, het.mask, het.theta_mask))
    key = jax.random.PRNGKey(11)
    (loss_j, out_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: _loss_j(model, p, data, mask, tmask, key),
        has_aux=True))(params)
    # the noise hlax drew, in mu's dtype (the parameters')
    eps = jax.random.normal(key, out_j["mu"].shape, out_j["mu"].dtype)

    t = lambda a: torch.tensor(np.asarray(a, np.float64)).to(tdt)
    out_t = tmodel(t(t_het.data), t(t_het.mask), t(t_het.theta_mask),
                   eps=t(eps))
    loss_t = thlvae.nll_from_log_p(out_t["log_p_x"]).sum() \
        + 0.1 * out_t["mu"].sum() + 0.1 * out_t["log_var"].sum()
    loss_t.backward()

    for k in ("mu", "log_var", "theta"):
        assert out_t[k].dtype == tdt, k
        got = out_t[k].detach().double().numpy()
        want = np.asarray(out_j[k], np.float64)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 8 * EPS, (k, err)
    lp_t = out_t["log_p_x"].double().sum().item()
    lp_j = float(jnp.sum(out_j["log_p_x"].astype(jnp.float64)))
    assert abs(lp_t - lp_j) <= 1e-2 * abs(lp_j)
    assert abs(loss_t.item() - float(loss_j)) <= 1e-2 * abs(float(loss_j))

    # the float64 gradient of the same weights and noise (the port in
    # float64 is held to hlax in float64 by tests/test_torch_model.py)
    m64 = thlvae.HLVAE(dataclasses.replace(tmodel.cfg, compute_dtype=None),
                       torch.Generator().manual_seed(1), "cpu").double()
    load_hlax_vae(m64, params)
    t64 = lambda a: torch.tensor(np.asarray(a, np.float64))
    o64 = m64(t64(t_het.data), t64(t_het.mask), t64(t_het.theta_mask),
              eps=t64(eps))
    (thlvae.nll_from_log_p(o64["log_p_x"]).sum() + 0.1 * o64["mu"].sum()
     + 0.1 * o64["log_var"].sum()).backward()
    gmodel = thlvae.HLVAE(tmodel.cfg, torch.Generator().manual_seed(1),
                          "cpu").double()
    load_hlax_vae(gmodel, g_j)
    want = dict(gmodel.named_parameters())
    exact = dict(m64.named_parameters())
    grad = lambda p: (p.grad.double().numpy() if p.grad is not None
                      else np.zeros(p.shape))
    for name, p in tmodel.named_parameters():
        assert p.dtype == tdt, name
        g64 = grad(exact[name])
        scale = max(np.linalg.norm(g64), 1e-30)
        err_t = np.linalg.norm(grad(p) - g64) / scale
        err_j = np.linalg.norm(want[name].detach().numpy() - g64) / scale
        assert err_t <= 2 * err_j + 8 * EPS, (name, err_t, err_j)


def _step_setup(kind, mode):
    rng = np.random.default_rng(5)
    het, t_het = _data(kind, rng, S * T)
    model, params, tmodel = _models(kind, mode, het, t_het)
    jdt, _, tdt = MODES[mode]
    valid = np.ones((S, T))
    valid[-1, 3:] = 0.0
    rv = valid.reshape(-1)[:, None]
    labels = np.zeros((S * T, 6))
    labels[:, 0] = np.tile(np.arange(T), S)
    labels[:, 1] = np.repeat(rng.integers(-9, 11, S), T)
    labels[:, 2] = np.repeat(np.arange(S), T)
    labels[:, 3] = np.repeat(rng.integers(0, 2, S), T)
    labels[:, 4] = np.repeat(rng.integers(0, 2, S), T)
    batch_np = {"data": het.data * rv, "mask": het.mask * rv,
                "theta_mask": het.theta_mask * rv, "labels": labels * rv,
                "valid": valid}
    spec0, spec1 = jk.build_kernel_specs(*SPEC_ARGS)
    k0 = [{k: np.asarray(v, np.float64) + 0.3 * rng.standard_normal(v.shape)
           for k, v in p.items()}
          for p in jk.init_kernel_params(spec0, L, jnp.float32)]
    k1 = [{k: np.asarray(v, np.float64) + 0.3 * rng.standard_normal(v.shape)
           for k, v in p.items()}
          for p in jk.init_kernel_params(spec1, L, jnp.float32)]
    rows = labels[valid.reshape(-1) > 0]
    zt = np.stack([rows[rng.choice(len(rows), M)] for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    m = rng.standard_normal((L, M, 1)) * 0.1
    Hh = rng.standard_normal((L, M, M)) / 3.0
    H = Hh @ Hh.transpose(0, 2, 1) + 0.5 * np.eye(M)
    # every GP input exactly a float32 value, as both packages hold it
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)
    k0 = [{k: f32(v) for k, v in p.items()} for p in k0]
    k1 = [{k: f32(v) for k, v in p.items()} for p in k1]
    zt, m, H = f32(zt), f32(m), f32(H)
    raw_noise = np.asarray(jk.noise_init(L, True, jnp.float32), np.float64)

    jcfg = jstep.TrainConfig(latent_dim=L, M=M, P_tot=P_TOT, N_tot=N_TOT,
                             id_covariate=2, natural_gradient=True,
                             constrain_scales=True, gp_dtype=jnp.float32,
                             eps=JITTER)
    j32 = lambda a: jnp.asarray(a, jnp.float32)
    state = jstep.TrainState(
        vae=params, k0=[{k: j32(v) for k, v in p.items()} for p in k0],
        k1=[{k: j32(v) for k, v in p.items()} for p in k1],
        raw_noise=j32(raw_noise), zt=j32(zt), m=j32(m), H=j32(H),
        opt_state=None, step=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(42))
    state = state._replace(opt_state=jstep.make_optimizer(jcfg).init(
        jstep._trainable(state, jcfg)))
    batch = {k: jnp.asarray(v, jdt) for k, v in batch_np.items()}

    tcfg = tstep.TrainConfig(latent_dim=L, M=M, P_tot=P_TOT, N_tot=N_TOT,
                             id_covariate=2, natural_gradient=True,
                             constrain_scales=True, gp_dtype=torch.float32,
                             eps=JITTER)
    t0, t1 = tk.build_kernel_specs(*SPEC_ARGS)
    tstate = state_from_hlax(params, k0, k1, raw_noise, zt, m, H, tmodel,
                             tcfg)
    tbatch = {k: torch.tensor(np.asarray(v, np.float64)).to(tdt)
              for k, v in batch_np.items()}
    return dict(model=model, state=state, batch=batch, jcfg=jcfg,
                step_j=jax.jit(jstep.make_train_step(model, spec0, spec1,
                                                     jcfg)),
                tstate=tstate, tbatch=tbatch, tdt=tdt,
                step_t=tstep.make_train_step(tmodel, t0, t1, tcfg))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", ["conv", "mlp"])
def test_three_train_steps_match_hlax(kind, mode):
    s = _step_setup(kind, mode)
    state, tstate = s["state"], s["tstate"]
    for _ in range(N_STEPS):
        # the jitted step draws its noise from split(state.rng)[1], in mu's
        # dtype
        _, sub = jax.random.split(state.rng)
        mu_dt = s["batch"]["data"].dtype
        eps = jax.random.normal(sub, (S * T, L), mu_dt)
        state, mj = s["step_j"](state, s["batch"])
        mt = s["step_t"](tstate, s["tbatch"], eps=torch.tensor(
            np.asarray(eps, np.float64)).to(s["tdt"]))
        for k in ("loss", "nll", "kld"):
            got, want = mt[k].double().item(), float(mj[k])
            # a bfloat16 value is only as close as 2 of its spacings, 2^-7
            tol = 2 * 2.0 ** -7 if mt[k].dtype == torch.bfloat16 else 1e-2
            assert abs(got - want) <= tol * abs(want), (k, got, want)
    assert tstate.step == N_STEPS
    for name in ("m", "H", "zt"):
        got = getattr(tstate, name).detach().double().numpy()
        assert _rel_norm(got, getattr(state, name)) <= 1e-2, name
    gmodel = thlvae.HLVAE(tstate.vae.cfg, torch.Generator().manual_seed(1),
                          "cpu").double()
    load_hlax_vae(gmodel, state.vae)
    want = dict(gmodel.named_parameters())
    for name, p in tstate.vae.named_parameters():
        assert p.dtype == s["tdt"], name
        w = want[name].detach().numpy()
        bound = 2 * LR * N_STEPS + 4 * EPS * np.abs(w).max()
        err = np.abs(p.detach().double().numpy() - w).max()
        assert err <= bound, (name, err, bound)
    # Adam's moments in the parameters' dtype, its count in float32
    st = tstate.optimizer.state[next(tstate.vae.parameters())]
    assert st["exp_avg"].dtype == s["tdt"]
    assert st["step"].dtype == torch.float32 and st["step"].item() == N_STEPS


def _forward_f32_as_before(model, data, mask, tmask, eps):
    """The float32 conv forward as the port computed it before
    ``compute_dtype`` and ``fused_conv``: each layer called as it is."""
    from hlax_torch.ops.normalization import batch_normalization

    cfg = model.cfg
    norm_data, norm_params = batch_normalization(data, mask, cfg.layout,
                                                 cfg.conv)
    blocks = []
    for gi, g in enumerate(cfg.layout.groups):
        x_g = norm_data[:, g.exp_slice[0]:g.exp_slice[1]]
        m_g = mask[:, g.raw_slice[0]:g.raw_slice[1]]
        if g.kind in ("cat", "ordinal"):
            x3 = x_g.reshape(x_g.shape[0], g.n_vars, g.nclass)
            rep = torch.einsum("bdc,dc->bd", x3, model.rep_w[str(gi)]) \
                + model.rep_b[str(gi)]
        else:
            rep = x_g
        blocks.append(rep * m_g)
    s = cfg.image_side
    img = torch.cat(blocks, dim=1)[:, model.raw_inv].reshape(-1, 1, s, s)
    h = thlvae.max_pool_2x2(F.relu(tcf.conv3x3_same(
        img, model.conv1.weight, model.conv1.bias)))
    h = thlvae.max_pool_2x2(F.relu(tcf.conv3x3_same(
        h, model.conv2.weight, model.conv2.bias)))
    hidden = h.reshape(h.shape[0], -1)
    for layer in model.enc_mlp:
        hidden = F.relu(layer(hidden))
    mu = model.mean_layer(hidden)
    log_var = torch.clamp(model.log_var_layer(hidden), -15.0, 15.0)
    z = mu + eps * torch.exp(0.5 * log_var)
    h = z
    for layer in model.dec_mlp:
        h = F.relu(layer(h))
    feat = s // 4
    y = model.y_layer(h).reshape(-1, 32, feat, feat)
    y = F.relu(tcf.conv_transpose4x4_s2(y, model.deconv1.weight,
                                        model.deconv1.bias))
    y = tcf.conv_transpose4x4_s2(y, model.deconv2.weight, model.deconv2.bias)
    y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, cfg.y_dim)
    y = y[:, model.raw_perm, :]
    theta = model.theta_estimation(y, tmask)
    log_p_x, _, _ = model.loglik(theta, data, mask, norm_params)
    return {"mu": mu, "log_var": log_var, "z": z, "theta": theta,
            "log_p_x": log_p_x}


def test_float32_path_is_unchanged_to_the_bit():
    """With both options off the float32 model computes exactly what it
    computed before them, forward and parameter gradients; and a float32
    ``compute_dtype`` is the same path."""
    het, t_het = _data("conv", np.random.default_rng(9), 8)
    _, _, tmodel = _models("conv", "compute", het, t_het)
    tmodel = thlvae.HLVAE(dataclasses.replace(tmodel.cfg,
                                              compute_dtype=None),
                          torch.Generator().manual_seed(2), "cpu")
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    data, mask, tmask = t(t_het.data), t(t_het.mask), t(t_het.theta_mask)
    eps = torch.randn((8, L), generator=torch.Generator().manual_seed(4))
    grads = []
    for fn in (lambda: tmodel(data, mask, tmask, eps=eps),
               lambda: _forward_f32_as_before(tmodel, data, mask, tmask,
                                              eps)):
        tmodel.zero_grad(set_to_none=True)
        out = fn()
        (out["log_p_x"].sum() + out["mu"].sum()).backward()
        grads.append((out, {k: p.grad.clone()
                            for k, p in tmodel.named_parameters()
                            if p.grad is not None}))
    (a, ga), (b, gb) = grads
    for k in ("mu", "log_var", "z", "theta", "log_p_x"):
        assert torch.equal(a[k], b[k]), k
    assert ga.keys() == gb.keys()
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k
    same = thlvae.HLVAE(dataclasses.replace(tmodel.cfg,
                                            compute_dtype=torch.float32),
                        torch.Generator().manual_seed(2), "cpu")
    c = same(data, mask, tmask, eps=eps)
    assert torch.equal(c["log_p_x"], a["log_p_x"])
