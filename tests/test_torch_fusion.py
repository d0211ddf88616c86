"""The plain versions of the fused step ops (``hlax_torch.ops.fusion``)
against hlax's functions, float64 on the CPU, inputs from numpy seeds.

On the card each op launches its kernel, which ``tests/test_torch_cuda.py``
and ``chip_smoke.py``'s ``[fusion]`` hold to these plain versions; here the
plain versions are held to hlax: the decoder's heads, routing and
likelihoods (per type: the cat and the real group of the Health-MNIST
layout), the encoder's input image (hlax's batch normalization and
representation), the train step's recon metric, and the GP kernel matrix
with its padding masks, forward and gradients against ``jax.grad``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hlax.data.reader import encode_raw
from hlax.eval import metrics as jmx
from hlax.gp import kernels as jk
from hlax.models import HLVAE, HLVAEConfig
from hlax.ops import normalization as jnorm
from hlax_torch.convert import load_hlax_vae
from hlax_torch.data.reader import encode_raw as t_encode_raw
from hlax_torch.gp import kernels as tk
from hlax_torch.models import hlvae as thlvae
from hlax_torch.ops import fusion
from hlax_torch.ops.normalization import NormParams

torch.set_num_threads(1)

B, Z, HID = 23, 4, 8
N_REAL, N_CAT, NCLASS = 324, 972, 5
RTOL = 1e-10


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


@pytest.fixture(scope="module")
def models():
    """A D4-typed conv model in hlax and in the port (hlax's weights, the
    heads and log_vy drawn away from their inits) and B rows of data with
    25 % missing cells, in an interleaved pixel order."""
    rng = np.random.default_rng(3)
    raw = np.column_stack([rng.random((B, N_REAL)) * 255,
                           rng.integers(0, NCLASS, (B, N_CAT)).astype(float)])
    perm = rng.permutation(N_REAL + N_CAT)
    raw = raw[:, perm]
    types = np.array([{"type": "real", "dim": 1, "nclass": 1}] * N_REAL
                     + [{"type": "cat", "dim": 1, "nclass": NCLASS}] * N_CAT
                     )[perm].tolist()
    miss = (rng.random(raw.shape) > 0.25).astype(float)
    het = encode_raw(raw, types, miss_mask=miss)
    t_het = t_encode_raw(raw, types, miss_mask=miss)
    model = HLVAE(HLVAEConfig(layout=het.layout, z_dim=Z, h_dims=(HID,),
                              y_dim=5, conv=True, dtype=jnp.float64))
    arrays = [jnp.asarray(a, jnp.float64)
              for a in (het.data, het.mask, het.theta_mask)]
    key = jax.random.PRNGKey(1)
    params = model.init(key, *arrays, key)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.5 * jnp.asarray(rng.standard_normal(v.shape))
        if any(getattr(k, "key", "").startswith(("obs_", "log_vy", "rep_"))
               for k in path) else v, params)
    tmodel = thlvae.HLVAE(thlvae.HLVAEConfig(layout=t_het.layout, z_dim=Z,
                                             h_dims=(HID,), y_dim=5,
                                             conv=True),
                          torch.Generator().manual_seed(0), "cpu").double()
    load_hlax_vae(tmodel, params)
    y = rng.standard_normal((B, het.layout.n_raw, 5))
    return dict(model=model, params=params, tmodel=tmodel, het=het, y=y,
                rng=rng)


def _hlax_heads(model, params, y, data, mask, tmask):
    def fn(m, y, data, mask, tmask):
        theta = m.theta_estimation(y, mask, tmask)
        return m.loglik(theta, data, mask, NormParams(None, None, None,
                                                      None)) + (theta,)
    return model.apply(params, y, data, mask, tmask, method=fn)


@pytest.mark.parametrize("kind", ["cat", "real"])
def test_heads_plain_version_matches_hlax(models, kind):
    """The heads, routing and likelihoods of one group: log p (observed and
    missing), theta, the likelihoods' parameters, and the gradients of a
    weighted sum of log p to y and to the group's head weights (and
    log_vy for real) against ``jax.grad``."""
    s = models
    het, lay = s["het"], s["het"].layout
    gi = [g.kind for g in lay.groups].index(kind)
    g = lay.groups[gi]
    cols = slice(*g.raw_slice)
    rng = np.random.default_rng(7 + gi)
    w1, w2 = rng.standard_normal((2, B, lay.n_raw))
    arrays = [jnp.asarray(a, jnp.float64)
              for a in (het.data, het.mask, het.theta_mask)]

    def loss_j(p, y):
        lp, lpm, _, _ = _hlax_heads(s["model"], p, y, *arrays)
        return jnp.sum((lp * w1)[:, cols]) + jnp.sum((lpm * w2)[:, cols])

    lp_j, lpm_j, par_j, theta_j = _hlax_heads(s["model"], s["params"],
                                              jnp.asarray(s["y"]), *arrays)
    gp_j, gy_j = jax.grad(loss_j, (0, 1))(s["params"], jnp.asarray(s["y"]))

    tm = s["tmodel"]
    tm.zero_grad()
    y = _t(s["y"]).requires_grad_(True)
    lp, lpm, par, theta = fusion.heads_loglik(
        tm, y, _t(het.theta_mask), _t(het.data), _t(het.mask),
        NormParams(None, None, None, None))
    loss = ((lp * _t(w1))[:, cols]).sum() + ((lpm * _t(w2))[:, cols]).sum()
    loss.backward()
    _close(lp[:, cols].detach(), lp_j[:, cols], "log_p_x")
    _close(lpm[:, cols].detach(), lpm_j[:, cols], "log_p_x_missing")
    _close(theta[:, slice(*g.theta_slice)].detach(),
           theta_j[:, slice(*g.theta_slice)], "theta")
    for a, b in zip(par[gi] if kind == "real" else [par[gi]],
                    par_j[gi] if kind == "real" else [par_j[gi]]):
        _close(a.detach(), b, "params")
    _close(y.grad, gy_j, "d y")
    gmodel = thlvae.HLVAE(tm.cfg, torch.Generator().manual_seed(1),
                          "cpu").double()
    load_hlax_vae(gmodel, gp_j)
    want = dict(gmodel.named_parameters())
    names = [f"obs.w_{gi}", f"obs.b_{gi}"] + (["log_vy_real"]
                                              if kind == "real" else [])
    for name, p in tm.named_parameters():
        if name in names:
            _close(p.grad, want[name].detach(), f"d {name}")


def test_rep_image_plain_version_matches_hlax(models):
    """The encoder's input image: hlax's batch normalization (conv mode),
    the one-hot representation with hlax's weights, the gather into pixel
    order; and the gradients of a weighted sum of it to the
    representation's weights and biases."""
    s = models
    het, lay = s["het"], s["het"].layout
    p = s["params"]["params"]
    gi = [g.kind for g in lay.groups].index("cat")
    w = np.random.default_rng(11).standard_normal((B, 1, 36, 36))

    def img_j(rw, rb):
        data, mask = jnp.asarray(het.data), jnp.asarray(het.mask)
        norm, _ = jnorm.batch_normalization(data, mask, lay, True)
        blocks = []
        for i, g in enumerate(lay.groups):
            x_g = norm[:, g.exp_slice[0]:g.exp_slice[1]]
            m_g = mask[:, g.raw_slice[0]:g.raw_slice[1]]
            if g.kind == "cat":
                x3 = x_g.reshape(x_g.shape[0], g.n_vars, g.nclass)
                rep = jnp.einsum("bdc,dc->bd", x3, rw) + rb
            else:
                rep = x_g
            blocks.append(rep * m_g)
        one = jnp.concatenate(blocks, axis=1)[:, jnp.asarray(lay.raw_inv)]
        return one.reshape(-1, 36, 36, 1)

    rw, rb = p[f"rep_w_{gi}"], p[f"rep_b_{gi}"]
    want = img_j(rw, rb)
    g_rw, g_rb = jax.grad(lambda a, b: jnp.sum(
        img_j(a, b) * jnp.asarray(w.transpose(0, 2, 3, 1))), (0, 1))(rw, rb)
    tm = s["tmodel"]
    tm.zero_grad()
    img = fusion.rep_image(tm, _t(het.data), _t(het.mask))
    (img * _t(w)).sum().backward()
    _close(img.detach().permute(0, 2, 3, 1), want, "image")
    _close(tm.rep_w[str(gi)].grad, g_rw, "d rep_w")
    _close(tm.rep_b[str(gi)].grad, g_rb, "d rep_b")


def _recon_j(lay, params, data, mask, row_valid, last_kind):
    """hlax's train-step recon metric (``hlax/train/step.py:207-227``)."""
    mean_rec, _ = jmx.statistics(params, lay, True)
    truth = jmx.discrete_transform(data, lay)
    true_mask = row_valid[:, None] * jnp.ones_like(mask)
    _, err_missing, partial = jmx.error_computation(
        truth, mean_rec, lay, mask * row_valid[:, None], conv=True,
        true_mask=true_mask)
    return (jnp.sum(partial[last_kind]["error_all"]) * jnp.sum(row_valid),
            jnp.sum(err_missing))


@pytest.mark.parametrize("last_kind", ["cat", "real"])
def test_recon_metric_plain_version_matches_hlax(models, last_kind):
    """The recon and missing-imputation errors of the heads' parameters
    over the valid rows (the last 5 padding), either type surviving."""
    s = models
    het, lay = s["het"], s["het"].layout
    arrays = [jnp.asarray(a, jnp.float64)
              for a in (het.data, het.mask, het.theta_mask)]
    par_j = _hlax_heads(s["model"], s["params"], jnp.asarray(s["y"]),
                        *arrays)[2]
    rv = np.ones(B)
    rv[-5:] = 0.0
    want = _recon_j(lay, par_j, arrays[0], arrays[1], jnp.asarray(rv),
                    last_kind)
    par_t = [tuple(_t(x) for x in p) if isinstance(p, tuple) else _t(p)
             for p in par_j]
    got = fusion.recon_metric(s["tmodel"].cfg.layout, True, par_t,
                              _t(het.data), _t(het.mask), _t(rv), last_kind)
    for a, b, what in zip(got, want, ("recon", "missing")):
        _close(a.item(), float(b), what)


GP_SPEC_ARGS = ([2], [5], [0],
                [{"cat_covariate": 3, "cont_covariate": 0},
                 {"cat_covariate": 4, "cont_covariate": 1},
                 {"cat_covariate": 2, "cont_covariate": 0}], [], [], 2)


@pytest.mark.parametrize("which", ["K0xz", "K0zz", "K1_st", "K0_st"])
def test_gp_kernel_matrix_plain_version_matches_hlax(which):
    """A kernel matrix of the bound with its padding masks (ragged last
    subject) and its gradients to the raw outputscales and lengthscales
    and to z, against hlax's ``kernel_matrix`` and ``jax.grad``."""
    rng = np.random.default_rng(4)
    L, S, T, M, Q = 3, 4, 5, 7, 6
    (s0, s1), (t0, t1) = (jk.build_kernel_specs(*GP_SPEC_ARGS),
                          tk.build_kernel_specs(*GP_SPEC_ARGS))
    spec_j, spec_t, k = {"K1_st": (s1, t1, 1)}.get(which, (s0, t0, 0))
    params = [{kk: np.asarray(v) + 0.3 * rng.standard_normal(v.shape)
               for kk, v in p.items()}
              for p in jk.init_kernel_params((s0, s1)[k], L, jnp.float64)]
    x = np.zeros((S, T, Q))
    x[:, :, 0] = np.arange(T)
    x[:, :, 1] = rng.integers(-9, 11, S)[:, None]
    x[:, :, 2] = np.arange(S)[:, None]
    x[:, :, 3:6] = rng.integers(0, 2, (S, 1, 3))
    valid = np.ones((S, T))
    valid[-1, 3:] = 0.0
    x = x * valid[:, :, None]
    z = x.reshape(-1, Q)[rng.integers(0, S * T, (L, M))] \
        + np.concatenate([rng.uniform(-0.5, 0.5, (L, M, 2)),
                          np.zeros((L, M, Q - 2))], axis=-1)
    out_shape = {"K0xz": (L, S, T, M), "K0zz": (L, M, M)}.get(
        which, (L, S, T, T))
    w = rng.standard_normal(out_shape)

    def matrix_j(p, zz):
        xj, vj = jnp.asarray(x), jnp.asarray(valid)
        if which == "K0xz":
            return jk.kernel_matrix(spec_j, p, xj, zz, x2_batched=True) \
                * vj[None, :, :, None]
        if which == "K0zz":
            return jk.kernel_matrix(spec_j, p, zz, zz, x1_batched=True,
                                    x2_batched=True)
        vo = vj[:, :, None] * vj[:, None, :]
        return jk.kernel_matrix(spec_j, p, xj, xj) * vo[None]

    pj = [{kk: jnp.asarray(v) for kk, v in p.items()} for p in params]
    want = matrix_j(pj, jnp.asarray(z))
    gp_j, gz_j = jax.grad(lambda p, zz: jnp.sum(matrix_j(p, zz) * w),
                          (0, 1))(pj, jnp.asarray(z))

    pt = [{kk: _t(v).requires_grad_(True) for kk, v in p.items()}
          for p in params]
    zt, xt, vt = _t(z).requires_grad_(True), _t(x), _t(valid)
    if which == "K0xz":
        out = fusion.gp_kernel_matrix(spec_t, pt, xt, zt, x2_batched=True,
                                      row_mask=vt)
    elif which == "K0zz":
        out = fusion.gp_kernel_matrix(spec_t, pt, zt, zt, x1_batched=True,
                                      x2_batched=True)
    else:
        out = fusion.gp_kernel_matrix(spec_t, pt, xt, xt, row_mask=vt,
                                      col_mask=vt)
    (out * _t(w)).sum().backward()
    _close(out.detach(), want, "kernel matrix")
    for p, q in zip(pt, gp_j):
        for kk in p:
            _close(p[kk].grad, q[kk], f"d {kk}")
    if which in ("K0xz", "K0zz"):
        _close(zt.grad, gz_j, "d z")


def test_permutation_gather_gradient_equals_index_backward():
    """``permute_columns``' backward (the gather by the inverse
    permutation) equals the index's backward bit for bit."""
    rng = np.random.default_rng(5)
    perm = rng.permutation(37)
    inv = np.argsort(perm)
    x = _t(rng.standard_normal((6, 37, 5)))
    g = _t(rng.standard_normal((6, 37, 5)))
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out_a = thlvae.permute_columns(a, torch.as_tensor(perm),
                                   torch.as_tensor(inv))
    out_b = b[:, torch.as_tensor(perm), :]
    assert torch.equal(out_a, out_b)
    out_a.backward(g)
    out_b.backward(g)
    assert torch.equal(a.grad, b.grad)


def test_plain_versions_take_cpu_tensors_uncounted(models):
    """On the CPU the ops take their plain versions and count nothing:
    counts are of CUDA tensors only."""
    s = models
    het = s["het"]
    fusion.reset_counters()
    fusion.rep_image(s["tmodel"], _t(het.data), _t(het.mask))
    fusion.heads_loglik(s["tmodel"], _t(s["y"]), _t(het.theta_mask),
                        _t(het.data), _t(het.mask),
                        NormParams(None, None, None, None))
    assert not any(fusion.LAUNCHES.values())
    assert not any(fusion.PLAIN_CUDA_CALLS.values())


def test_geometry_takes_cat_groups_and_one_real_group():
    """The kernels' view of a layout: every cat group with its classes and
    the real group; a layout with a group of another type takes the plain
    versions (None)."""
    rng = np.random.default_rng(6)
    types = ([{"type": "cat", "dim": 1, "nclass": 3}] * 4
             + [{"type": "real", "dim": 1, "nclass": 1}] * 5
             + [{"type": "cat", "dim": 1, "nclass": 7}] * 2)
    raw = np.column_stack([rng.integers(0, t["nclass"], 9).astype(float)
                           for t in types])
    lay = t_encode_raw(raw, types).layout
    geo = fusion.geometry(lay)
    assert sorted((g.nclass, g.d) for g in geo.cats) == [(3, 4), (7, 2)]
    assert geo.real.nclass == 0 and geo.real.d == 5
    for g in geo.cats + (geo.real,):
        grp = lay.groups[g.gi]
        assert (g.r0, g.e0, g.t0) == (grp.raw_slice[0], grp.exp_slice[0],
                                      grp.theta_slice[0])
    pos = types + [{"type": "pos", "dim": 1, "nclass": 1}]
    raw = np.column_stack([raw, rng.random(9)])
    assert fusion.geometry(t_encode_raw(raw, pos).layout) is None


def test_gp_chunks_cover_every_parameter_within_the_limits():
    """A spec beyond one launch's limits splits into launches within them
    whose theta rows are every raw parameter once, in the stacked order;
    the canonical spec is one launch."""
    big, _ = tk.build_kernel_specs(
        [3, 4], [3], [0, 1, 5],
        [{"cont_covariate": 0, "cat_covariate": 2},
         {"cont_covariate": 5, "cat_covariate": 3},
         {"cont_covariate": 1, "cat_covariate": 4}],
        [{"cont_covariate": 5, "bin_covariate": 4}],
        [{"covariate": 5, "mask": 4}], 2)
    chunks = fusion._gp_chunks(big)
    assert len(chunks) > 1
    rows = [r for ch in chunks for r in ch.rows]
    params = tk.init_kernel_params(big, 2)
    assert sorted(rows) == sorted((c, k) for c, p in enumerate(params)
                                  for k in p)
    for ch, p0 in zip(chunks, np.cumsum([0] + [len(c.rows)
                                               for c in chunks])):
        ncomp, nparam, nslot = ch.flat[:3]
        assert ch.p0 == p0 and nparam == len(ch.rows)
        assert ncomp <= fusion.GP_MAX["components"]
        assert nparam <= fusion.GP_MAX["params"]
        assert nslot <= fusion.GP_MAX["slots"]
    assert len(fusion._gp_chunks(tk.build_kernel_specs(*GP_SPEC_ARGS)[0])) \
        == 1
