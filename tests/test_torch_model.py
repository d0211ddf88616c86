"""Port's conv HLVAE, likelihood heads and normalization against hlax.

Identical weights (hlax's flax init carried across by
``hlax_torch.convert``), identical batch and reparameterization noise, both
in float64 on the CPU.  Heterogeneous Health-MNIST D4 types (324 real and
972 cat(5) pixels, 36x36), z=8, hidden 50.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hlax.data.reader import encode_raw
from hlax.models import HLVAE, HLVAEConfig
from hlax.models import hlvae as jhlvae
from hlax.models.hlvae import nll_from_log_p
from hlax.ops import likelihoods as jlik
from hlax.ops import normalization as jnorm
from hlax.types import compile_layout
from hlax_torch.convert import load_hlax_vae
from hlax_torch.data.reader import encode_raw as t_encode_raw
from hlax_torch.models import hlvae as thlvae
from hlax_torch.ops import likelihoods as tlik
from hlax_torch.ops import normalization as tnorm
from hlax_torch.types import compile_layout as t_compile_layout

torch.set_num_threads(1)

B, Z, HID = 20, 8, 50
N_REAL, N_CAT, NCLASS = 324, 972, 5


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


@pytest.fixture(scope="module")
def model_setup():
    rng = np.random.default_rng(7)
    raw = np.column_stack([rng.random((B, N_REAL)) * 255,
                           rng.integers(0, NCLASS, (B, N_CAT)).astype(float)])
    # D4-like pixel order: interleave the two kinds so the grouped
    # permutation is not the identity
    perm = rng.permutation(N_REAL + N_CAT)
    raw = raw[:, perm]
    types = np.array([{"type": "real", "dim": 1, "nclass": 1}] * N_REAL
                     + [{"type": "cat", "dim": 1, "nclass": NCLASS}] * N_CAT
                     )[perm].tolist()
    miss = (rng.random(raw.shape) > 0.25).astype(float)
    het = encode_raw(raw, types, miss_mask=miss)
    cfg = HLVAEConfig(layout=het.layout, z_dim=Z, h_dims=(HID,), y_dim=5,
                      conv=True, dtype=jnp.float64)
    model = HLVAE(cfg)
    data, mask, tmask = (jnp.asarray(a, jnp.float64)
                         for a in (het.data, het.mask, het.theta_mask))
    key = jax.random.PRNGKey(3)
    params = model.init(key, data, mask, tmask, key)

    t_het = t_encode_raw(raw, types, miss_mask=miss)
    tcfg = thlvae.HLVAEConfig(layout=t_het.layout, z_dim=Z, h_dims=(HID,),
                              y_dim=5, conv=True)
    tmodel = thlvae.HLVAE(tcfg, torch.Generator().manual_seed(0),
                          "cpu").double()
    load_hlax_vae(tmodel, params)
    return dict(het=het, t_het=t_het, model=model, params=params,
                tmodel=tmodel, data=data, mask=mask, tmask=tmask)


def _hlax_loss(model, params, s, key):
    out = model.apply(params, s["data"], s["mask"], s["tmask"], key)
    loss = jnp.sum(nll_from_log_p(out["log_p_x"])) \
        + 0.1 * jnp.sum(out["mu"]) + 0.1 * jnp.sum(out["log_var"])
    return loss, out


def _port_loss(tmodel, het, eps):
    out = tmodel(_t(het.data), _t(het.mask), _t(het.theta_mask), eps=eps)
    loss = thlvae.nll_from_log_p(out["log_p_x"]).sum() \
        + 0.1 * out["mu"].sum() + 0.1 * out["log_var"].sum()
    return loss, out


def test_forward_and_parameter_gradients_match_hlax(model_setup):
    s = model_setup
    key = jax.random.PRNGKey(11)
    (loss_j, out_j), grads_j = jax.value_and_grad(
        lambda p: _hlax_loss(s["model"], p, s, key), has_aux=True)(s["params"])
    eps = (np.asarray(out_j["z"]) - np.asarray(out_j["mu"])) \
        / np.exp(0.5 * np.asarray(out_j["log_var"]))

    tmodel = s["tmodel"]
    tmodel.zero_grad()
    loss_t, out_t = _port_loss(tmodel, s["t_het"], _t(eps))
    loss_t.backward()

    for k in ("mu", "log_var", "z", "log_p_x", "log_p_x_missing", "theta"):
        want = np.asarray(out_j[k])
        np.testing.assert_allclose(out_t[k].detach().numpy(), want,
                                   rtol=1e-9, atol=1e-9 * np.abs(want).max(),
                                   err_msg=k)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-10)

    # hlax's gradient tree, mapped by the same (linear) weight mapping
    gmodel = thlvae.HLVAE(tmodel.cfg, torch.Generator().manual_seed(1),
                          "cpu").double()
    load_hlax_vae(gmodel, grads_j)
    want = dict(gmodel.named_parameters())
    n = 0
    for name, p in tmodel.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        w = want[name].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=1e-7,
                                   atol=1e-9 * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)
        n += 1
    assert n == len(want)


def test_pool_backward_reaches_every_tied_element():
    """Tied window maxima: every tied element gets the cotangent (hlax's
    custom VJP), including an all-negative window; NCHW vs hlax's NHWC."""
    rng = np.random.default_rng(0)
    h = rng.integers(-3, 2, (2, 3, 4, 6)).astype(np.float64)   # NCHW, ties
    h[0, 0, :2, :2] = -1.0                                     # all tied, < 0
    g = rng.normal(size=(2, 3, 2, 3))
    hj = jnp.asarray(h.transpose(0, 2, 3, 1))
    o, vjp = jax.vjp(jhlvae._max_pool_2x2, hj)
    gj = np.asarray(vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))[0])
    ht = torch.tensor(h, requires_grad=True)
    ot = thlvae.max_pool_2x2(ht)
    ot.backward(torch.tensor(g))
    np.testing.assert_array_equal(ot.detach().numpy(),
                                  np.asarray(o).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(ht.grad.numpy(), gj.transpose(0, 3, 1, 2))
    assert (ht.grad.numpy()[0, 0, :2, :2] == g[0, 0, 0, 0]).all()


TYPES = [
    {"type": "real", "dim": 1, "nclass": 1},
    {"type": "cat", "dim": 1, "nclass": 3},
    {"type": "pos", "dim": 1, "nclass": 1},
    {"type": "ordinal", "dim": 1, "nclass": 4},
    {"type": "count", "dim": 1, "nclass": 1},
    {"type": "real", "dim": 1, "nclass": 1},
    {"type": "beta", "dim": 1, "nclass": 1},
]


@pytest.mark.parametrize("conv", [False, True])
def test_batch_normalization_matches_hlax(conv):
    rng = np.random.default_rng(3)
    lay, tlay = compile_layout(TYPES), t_compile_layout(TYPES)
    data = np.abs(rng.normal(size=(17, lay.n_exp))) * 3 + 0.5
    mask = (rng.random((17, lay.n_raw)) > 0.3).astype(float)
    nj, pj = jnorm.batch_normalization(jnp.asarray(data), jnp.asarray(mask),
                                       lay, conv)
    nt, pt = tnorm.batch_normalization(_t(data), _t(mask), tlay, conv)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-12,
                               atol=1e-12)
    for a, b in zip(pt, pj):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def _head_cases(rng, b=13, d=6):
    data = np.abs(rng.normal(size=(b, d))) * 2
    mask = (rng.random((b, d)) > 0.3).astype(float)
    levels = rng.integers(1, 5, (b, d))
    therm = (np.arange(1, 5)[None, None] <= levels[..., None]).astype(float)
    codes = rng.integers(0, 3, (b, d))
    onehot = np.eye(3)[codes].reshape(b, -1)
    ranges = np.column_stack([-np.ones(d), 3 + rng.random(d)])
    nm, nv = rng.normal(size=d), rng.random(d) + 0.1
    th = lambda k: rng.normal(size=(b, k))
    return {
        "real": ((data, mask, th(d), nm, nv, rng.normal(size=d), False),
                 (jlik.loglik_real, tlik.loglik_real)),
        "real_logvar": ((data, mask, th(2 * d), nm, nv, None, False),
                        (jlik.loglik_real, tlik.loglik_real)),
        "real_conv": ((data / 10, mask, th(d), None, None,
                       rng.normal(size=d), True),
                      (jlik.loglik_real, tlik.loglik_real)),
        "pos": ((data, mask, th(d), nm, nv, rng.normal(size=d) * 0.3),
                (jlik.loglik_pos, tlik.loglik_pos)),
        "cat": ((onehot, mask, th(3 * d), 3),
                (jlik.loglik_cat, tlik.loglik_cat)),
        "ordinal": ((therm.reshape(b, -1), mask, th(4 * d), 4),
                    (jlik.loglik_ordinal, tlik.loglik_ordinal)),
        "count": ((np.round(data * 3), mask, th(d) * 2),
                  (jlik.loglik_count, tlik.loglik_count)),
        "beta": ((rng.uniform(-1, 3, (b, d)), mask, th(d), ranges,
                  np.array(1.3)), (jlik.loglik_beta, tlik.loglik_beta)),
    }


@pytest.mark.parametrize("kind", ["real", "real_logvar", "real_conv", "pos",
                                  "cat", "ordinal", "count", "beta"])
def test_likelihood_heads_match_hlax(kind):
    """Values of log_p_x / log_p_x_missing / params and the theta-gradient
    of sum(log_p_x)."""
    args, (fj, ft) = _head_cases(np.random.default_rng(21))[kind]
    conv = lambda a, f: a if a is None or isinstance(a, (bool, int)) else f(a)
    targs = [conv(a, _t) for a in args]
    jargs = [conv(a, jnp.asarray) for a in args]
    theta = targs[2].clone().requires_grad_(True)
    targs[2] = theta
    out_t = ft(*targs)
    out_j = fj(*jargs)
    for k in ("log_p_x", "log_p_x_missing"):
        np.testing.assert_allclose(out_t[k].detach().numpy(),
                                   np.asarray(out_j[k]), rtol=1e-10,
                                   atol=1e-12, err_msg=k)
    pt = out_t["params"] if isinstance(out_t["params"], tuple) \
        else (out_t["params"],)
    pj = out_j["params"] if isinstance(out_j["params"], tuple) \
        else (out_j["params"],)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-10, atol=1e-12)
    out_t["log_p_x"].sum().backward()

    def f(th):
        jj = list(jargs)
        jj[2] = th
        return jnp.sum(fj(*jj)["log_p_x"])
    gj = jax.grad(f)(jargs[2])
    np.testing.assert_allclose(theta.grad.numpy(), np.asarray(gj),
                               rtol=1e-9, atol=1e-12)


def test_decode_matches_hlax(model_setup):
    """``HLVAE.decode`` of given latents under given batch statistics, the
    entry point of the eval path's GP reconstruction."""
    s = model_setup
    z = np.random.default_rng(8).standard_normal((s["data"].shape[0], Z))
    _, np_j = jnorm.batch_normalization(s["data"], s["mask"], s["het"].layout,
                                        True)
    out_j = s["model"].apply(
        s["params"], jnp.asarray(z), s["data"], s["mask"], s["tmask"], np_j,
        method=lambda m, *a: m.decode(*a))
    het = s["t_het"]
    data, mask = _t(het.data), _t(het.mask)
    _, np_t = tnorm.batch_normalization(data, mask, het.layout, True)
    with torch.inference_mode():
        out_t = s["tmodel"].decode(_t(z), data, mask, _t(het.theta_mask),
                                   np_t)
    for got, want in ((out_t[0], out_j[0]), (out_t[1], out_j[1]),
                      (out_t[3], out_j[3])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


N_DRAWS = 40000


def _sampler_params(kind, rng):
    """Head parameters of 3 variables, as the loglik heads emit them."""
    if kind in ("real", "pos"):
        return (rng.normal(0, 1, (1, 3)), rng.uniform(0.2, 1.0, (1, 3)))
    if kind == "cat":
        return np.log(np.array([[[0.2, 0.5, 0.3], [0.6, 0.3, 0.1],
                                 [0.1, 0.1, 0.8]]]))
    if kind == "ordinal":
        return np.array([[[0.1, 0.4, 0.3, 0.2], [0.5, 0.2, 0.2, 0.1],
                          [0.25, 0.25, 0.25, 0.25]]])
    if kind == "count":
        return rng.uniform(0.5, 6.0, (1, 3))
    return (rng.uniform(1.0, 4.0, (1, 3)), rng.uniform(1.0, 4.0, (1, 3)))


@pytest.mark.parametrize("kind", ["real", "pos", "cat", "ordinal", "count",
                                  "beta"])
def test_samplers_match_hlax_in_distribution(kind):
    """The ``sample_*`` companions draw from another generator than hlax's,
    so the two are compared in distribution: shapes, and the mean of
    40,000 draws of each cell within 6 standard errors of hlax's."""
    p = _sampler_params(kind, np.random.default_rng(3))
    tile = lambda a: np.repeat(a, N_DRAWS, axis=0)
    pj = tuple(map(tile, p)) if isinstance(p, tuple) else tile(p)
    key = jax.random.PRNGKey(5)
    gen = torch.Generator().manual_seed(5)
    ranges = np.array([[0.0, 2.0], [-1.0, 1.0], [0.0, 10.0]])
    if kind == "beta":
        sj = jlik.sample_beta(tuple(map(jnp.asarray, pj)), key,
                              jnp.asarray(ranges))
        st = tlik.sample_beta(tuple(map(_t, pj)), gen, _t(ranges))
    else:
        jfn, tfn = getattr(jlik, f"sample_{kind}"), getattr(tlik,
                                                            f"sample_{kind}")
        if isinstance(pj, tuple):
            sj, st = jfn(tuple(map(jnp.asarray, pj)), key), \
                tfn(tuple(map(_t, pj)), gen)
        else:
            sj, st = jfn(jnp.asarray(pj), key), tfn(_t(pj), gen)
    sj, st = np.asarray(sj), st.numpy()
    assert sj.shape == st.shape and st.dtype == np.float64
    if kind == "pos":   # heavy-tailed: compare the log1p of the draws
        sj, st = np.log1p(sj), np.log1p(st)
    se = np.sqrt((sj.var(axis=0) + st.var(axis=0)) / N_DRAWS) + 1e-12
    assert (np.abs(sj.mean(axis=0) - st.mean(axis=0)) < 6 * se).all()
