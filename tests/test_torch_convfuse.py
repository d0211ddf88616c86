"""The port's fused conv stack (``hlax_torch.ops.convfuse``) against hlax's:
values and gradients of ``conv_pool_fused`` and ``conv_transpose_fused`` in
float32 and float64 at the four geometries of the HLVAE image path
(tests/test_convfuse.py's shapes), the fused model against the unfused one
and against hlax's fused model, and the pool window's tie and all-negative
gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlax.data.reader import encode_raw
from hlax.models import HLVAE, HLVAEConfig
from hlax.models.hlvae import nll_from_log_p
from hlax.ops import convfuse as jcf
from hlax_torch.convert import load_hlax_vae
from hlax_torch.data.reader import encode_raw as t_encode_raw
from hlax_torch.models import hlvae as thlvae
from hlax_torch.ops import convfuse as tcf

torch.set_num_threads(1)

# encoder 36x36x1->16, 18x18x16->32; decoder 9x9x32->16, 18x18x16->5
ENC = [(1, 16, 36), (16, 32, 18)]
DEC = [(32, 16, 9), (16, 5, 18)]
# the port and hlax compute the same matmuls in other summation orders:
# float64 at hlax's own bound for fused against lax, float32 likewise
TOL = {np.float64: (1e-11, 1e-9), np.float32: (2e-5, 2e-4)}
TOL_T = {np.float64: (1e-11, 1e-9), np.float32: (5e-4, 2e-3)}


def _inputs(seed, x_shape, k_shape, O, dt):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dt) for s in (x_shape, k_shape, (O,))]


def _both(fn_j, fn_t, arrays, dt, tol, gtol):
    """Values and (input, kernel, bias) gradients through one random
    cotangent, hlax against the port."""
    got_j = fn_j(*map(jnp.asarray, arrays))
    w = np.random.default_rng(99).normal(size=got_j.shape).astype(dt)
    g_j = jax.grad(lambda *a: jnp.sum(fn_j(*a) * w), (0, 1, 2))(
        *map(jnp.asarray, arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    got_t = fn_t(*ts)
    (got_t * torch.tensor(w)).sum().backward()
    assert got_t.dtype == ts[0].dtype
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(got_j),
                               rtol=tol, atol=tol)
    for t, g in zip(ts, g_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=gtol, atol=gtol)


@pytest.mark.parametrize("C,O,S", ENC)
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_conv_pool_fused_matches_hlax(C, O, S, dt):
    arrays = _inputs(C * S, (3, S, S, C), (3, 3, C, O), O, dt)
    _both(jcf.conv_pool_fused, tcf.conv_pool_fused, arrays, dt, *TOL[dt])


@pytest.mark.parametrize("C,O,S", DEC)
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_conv_transpose_fused_matches_hlax(C, O, S, dt):
    arrays = _inputs(C * S + 1, (3, S, S, C), (4, 4, C, O), O, dt)
    _both(jcf.conv_transpose_fused, tcf.conv_transpose_fused, arrays, dt,
          *TOL_T[dt])


@pytest.mark.parametrize("C,O,S", ENC)
def test_fused_stage_equals_the_port_lowering(C, O, S):
    """In the port's own layouts: conv_pool_fused on NHWC with the Conv2d
    weight converted equals conv3x3_same -> relu -> 2x2 max pool (float64),
    which on the CPU is PyTorch's convolution."""
    rng = np.random.default_rng(S)
    x = torch.tensor(rng.normal(size=(3, C, S, S)))
    w = torch.tensor(rng.normal(size=(O, C, 3, 3)))
    b = torch.tensor(rng.normal(size=(O,)))
    want = thlvae.max_pool_2x2(torch.relu(tcf.conv3x3_same(x, w, b)))
    got = tcf.conv_pool_fused(x.permute(0, 2, 3, 1), tcf.conv_kernel_hwio(w),
                              b).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, want, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("C,O,S", DEC)
def test_fused_transpose_equals_the_port_lowering(C, O, S):
    rng = np.random.default_rng(S + 1)
    x = torch.tensor(rng.normal(size=(3, C, S, S)))
    w = torch.tensor(rng.normal(size=(C, O, 4, 4)))
    b = torch.tensor(rng.normal(size=(O,)))
    want = tcf.conv_transpose4x4_s2(x, w, b)
    got = tcf.conv_transpose_fused(x.permute(0, 2, 3, 1),
                                   tcf.conv_transpose_kernel_hwio(w),
                                   b).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, want, rtol=1e-11, atol=1e-11)


def _model_pair(seed=0, n=4):
    rng = np.random.default_rng(seed)
    types = ([{"type": "real", "dim": 1, "nclass": 1}] * 324
             + [{"type": "cat", "dim": 1, "nclass": 5}] * 972)
    raw = np.column_stack([rng.random((n, 324)) * 255,
                           rng.integers(0, 5, (n, 972)).astype(float)])
    perm = rng.permutation(1296)
    raw, types = raw[:, perm], np.array(types)[perm].tolist()
    miss = (rng.random(raw.shape) > 0.25).astype(float)
    het = encode_raw(raw, types, miss_mask=miss)
    t_het = t_encode_raw(raw, types, miss_mask=miss)
    return het, t_het


def test_full_model_fused_matches_unfused_and_hlax():
    """Same weights: the port's fused model equals its unfused model and
    hlax's fused model in float64, outputs and parameter gradients."""
    het, t_het = _model_pair()
    cfg = HLVAEConfig(layout=het.layout, z_dim=8, h_dims=(32,), y_dim=5,
                      conv=True, dtype=jnp.float64, fused_conv=True)
    model = HLVAE(cfg)
    data, mask, tmask = (jnp.asarray(a, jnp.float64)
                         for a in (het.data, het.mask, het.theta_mask))
    key = jax.random.PRNGKey(0)
    params = model.init(key, data, mask, tmask, key)
    out_j = jax.jit(model.apply)(params, data, mask, tmask, key)
    eps = (np.asarray(out_j["z"]) - np.asarray(out_j["mu"])) \
        / np.exp(0.5 * np.asarray(out_j["log_var"]))
    g_j = jax.jit(jax.grad(lambda p: jnp.sum(nll_from_log_p(model.apply(
        p, data, mask, tmask, key)["log_p_x"]))))(params)

    tcfg = thlvae.HLVAEConfig(layout=t_het.layout, z_dim=8, h_dims=(32,),
                              y_dim=5, conv=True, fused_conv=True)
    outs, grads = {}, {}
    for fused in (True, False):
        m = thlvae.HLVAE(dataclasses.replace(tcfg, fused_conv=fused),
                         torch.Generator().manual_seed(0), "cpu").double()
        load_hlax_vae(m, params)
        t = lambda a: torch.tensor(np.asarray(a, np.float64))
        out = m(t(t_het.data), t(t_het.mask), t(t_het.theta_mask),
                eps=t(eps))
        thlvae.nll_from_log_p(out["log_p_x"]).sum().backward()
        outs[fused] = out
        grads[fused] = {k: p.grad.clone() for k, p in m.named_parameters()
                        if p.grad is not None}
    for k in ("mu", "log_var", "log_p_x", "theta"):
        torch.testing.assert_close(outs[True][k], outs[False][k],
                                   rtol=1e-10, atol=1e-10)
        want = np.asarray(out_j[k])
        np.testing.assert_allclose(outs[True][k].detach().numpy(), want,
                                   rtol=1e-9, atol=1e-9 * np.abs(want).max())
    assert grads[True].keys() == grads[False].keys()
    gmodel = thlvae.HLVAE(tcfg, torch.Generator().manual_seed(1),
                          "cpu").double()
    load_hlax_vae(gmodel, g_j)
    want = dict(gmodel.named_parameters())
    for k, g in grads[True].items():
        torch.testing.assert_close(g, grads[False][k], rtol=1e-8,
                                   atol=1e-9 * g.abs().max().item())
        w = want[k].detach().numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-7,
                                   atol=1e-9 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


def _relu_max_uv_grad(wins):
    y = torch.tensor(wins)[:, None, None, :, :, None].requires_grad_(True)
    tcf._ReluMaxUV.apply(y).sum().backward()
    return y.grad[:, 0, 0, :, :, 0].numpy()


def test_relu_max_uv_tie_grad_is_replicating():
    """On an exact window tie the cotangent goes to every tied positive
    element, as in hlax's custom VJP."""
    wins = np.array([[[2.0, 2.0], [-1.0, 1.0]]])
    got = _relu_max_uv_grad(wins)
    np.testing.assert_array_equal(got[0], [[1.0, 1.0], [0.0, 0.0]])
    y = jnp.asarray(wins)[:, None, None, :, :, None]
    g = jax.grad(lambda y: jnp.sum(jcf._relu_max_uv(y)))(y)
    np.testing.assert_array_equal(got, np.asarray(g)[:, 0, 0, :, :, 0])


def test_all_negative_window_grad_is_zero():
    """An all-negative window pools to 0 and sends no cotangent back (the
    ``y > 0`` guard), beside a mixed and an all-positive window; equal to
    hlax's."""
    wins = np.array([[[-1.0, -2.0], [-0.5, -3.0]],
                     [[-1.0, 4.0], [-2.0, 1.0]],
                     [[1.0, 2.0], [0.5, 3.0]]])
    want = np.array([[[0.0, 0.0], [0.0, 0.0]],
                     [[0.0, 1.0], [0.0, 0.0]],
                     [[0.0, 0.0], [0.0, 1.0]]])
    got = _relu_max_uv_grad(wins)
    np.testing.assert_array_equal(got, want)
    y = jnp.asarray(wins)[:, None, None, :, :, None]
    g = jax.grad(lambda y: jnp.sum(jcf._relu_max_uv(y)))(y)
    np.testing.assert_array_equal(got, np.asarray(g)[:, 0, 0, :, :, 0])


def test_written_gradients_take_their_parameters_strides():
    """The fused conv's kernel gradients come back from the backward pass
    permuted; the train step writes each gradient with its parameter's
    strides (the fused Adam on the card takes only matching layouts), the
    same values."""
    from hlax_torch.data import dataset as tds
    from hlax_torch.data import generate as tgen
    from hlax_torch.gp.kernels import build_kernel_specs
    from hlax_torch.train import step as tstep

    out = tgen.generate(num_3=2, num_6=2, datatype_config="D4", seed=2)
    labels = np.nan_to_num(out["labels"][:, tds.HEALTH_MNIST_LABEL_ORDER])
    het = t_encode_raw(out["data"], tgen.types_table("D4"),
                       miss_mask=out["mask"])
    data = tds.LongitudinalDataset(het=het, labels=labels, id_covariate=2)
    spec0, spec1 = build_kernel_specs(
        [2], [], [0], [{"cont_covariate": 0, "cat_covariate": 2}], [], [], 2)
    cfg = tstep.TrainConfig(latent_dim=4, M=12, P_tot=float(data.P),
                            N_tot=float(len(data)), id_covariate=2)
    model = thlvae.HLVAE(thlvae.HLVAEConfig(layout=data.layout, z_dim=4,
                                            h_dims=(8,), fused_conv=True),
                         torch.Generator().manual_seed(0), "cpu")
    state = tstep.init_train_state(model, spec0, spec1,
                                   next(tds.subject_batches(data, 2)), cfg)
    batch = tds.gather_batch(tds.stage_dataset(data, torch.float32, "cpu"),
                             torch.arange(2))
    params = state.optimizer.param_groups[0]["params"]
    raw = {}

    def spy(loss, ps):
        gs = torch.autograd.grad(loss, ps, allow_unused=True,
                                 materialize_grads=True, retain_graph=True)
        raw.update({id(p): g for p, g in zip(ps, gs)})
        write(loss, ps)

    write, tstep.write_grads = tstep.write_grads, spy
    try:
        tstep.make_train_step(model, spec0, spec1, cfg)(state, batch)
    finally:
        tstep.write_grads = write
    permuted = [p for p in params if raw[id(p)].stride() != p.stride()]
    assert len(permuted) == 4          # the four conv kernels
    for p in params:
        assert p.grad.stride() == p.stride()
        assert torch.equal(p.grad, raw[id(p)])
