"""The CUDA kernels on the card, against their plain versions.

Imports neither JAX nor hlax, so it runs on the GPU machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test skips without a CUDA device.
"""
import pytest
import torch

from hlax_torch.ops import linalg_small as tls

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.Generator(device="cuda").manual_seed(0)


def _spd(shape, gen):
    n = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float64)
    return (x @ x.mT / n + 0.5 * torch.eye(n, device="cuda",
                                           dtype=torch.float64)).float()


def _indefinite(shape, gen):
    """logspace(0, -10) spectrum: indefinite after rounding to float32."""
    n = shape[-1]
    q, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, device="cuda",
                                       dtype=torch.float64))
    a = (q * torch.logspace(0.0, -10.0, n, device="cuda",
                            dtype=torch.float64)) @ q.T
    return a.float().expand(shape).contiguous()


# the canonical B blocks, both compiled sizes of the register path and sizes
# padded to them, an odd n (scalar copies), the shared-memory path (n > 32),
# and batches that are not a multiple of the warps a block
SMALL_SHAPES = [(32, 20, 20, 20), (1001, 20, 20), (64, 4, 4), (64, 8, 8),
                (64, 16, 16), (1001, 18, 18), (33, 19, 19), (64, 24, 24),
                (1001, 32, 32), (64, 40, 40), (1001, 48, 48)]


@pytest.mark.parametrize("kind", ["spd", "indefinite"])
@pytest.mark.parametrize("shape", SMALL_SHAPES)
def test_kernel_equals_plain_version(gen, shape, kind):
    """The small kernel does its plain version's float32 operations in the
    same order (the register path with its roundings spelled out, the
    shared-memory path built with --fmad=false): the results are equal, bit
    for bit, with exact zeros above the diagonal."""
    a = (_spd if kind == "spd" else _indefinite)(shape, gen)
    before = tls.LAUNCHES["chol_inv_small_cuda"]
    l, il = tls.chol_inv_small_cuda(a)
    torch.cuda.synchronize()
    assert tls.LAUNCHES["chol_inv_small_cuda"] == before + 1
    lp, ilp = tls._chol_inv_plain(a)
    torch.testing.assert_close(l, lp, rtol=0, atol=0)
    torch.testing.assert_close(il, ilp, rtol=0, atol=0)
    assert torch.isfinite(il).all()
    assert not torch.triu(l, 1).any() and not torch.triu(il, 1).any()


@pytest.mark.parametrize("n", [18, 20])
def test_kernels_take_misaligned_tensors(gen, n):
    """A contiguous view that starts 4 bytes past a 16-byte boundary takes
    the kernels' scalar copies: the same results as an aligned tensor."""
    def shifted(t):
        buf = torch.empty(t.numel() + 1, device="cuda")
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    a = _spd((33, n, n), gen)
    l, il = tls.chol_inv_small_cuda(a)
    lm, ilm = tls.chol_inv_small_cuda(shifted(a))
    torch.testing.assert_close(lm, l, rtol=0, atol=0)
    torch.testing.assert_close(ilm, il, rtol=0, atol=0)
    lb = torch.randn(a.shape, generator=gen, device="cuda")
    ilb = torch.randn(a.shape, generator=gen, device="cuda")
    want = tls.chol_inv_bwd_cuda(l, il, lb, ilb)
    got = tls.chol_inv_bwd_cuda(shifted(l), shifted(il), shifted(lb),
                                shifted(ilb))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _f64_errors(a, l, il):
    """Max errors of L, raw L^-1 and refined L^-1 against float64
    ``torch.linalg`` on the same float32 input, and their scales."""
    l64 = torch.linalg.cholesky(a.double())
    eye = torch.eye(a.shape[-1], device=a.device, dtype=torch.float64)
    il64 = torch.linalg.solve_triangular(l64, eye.expand_as(l64), upper=False)
    got = (l, il, tls._refine_tri_inverse(l, il))
    want = (l64, il64, il64)
    return ([(g.double() - w).abs().max().item() for g, w in zip(got, want)],
            [w.abs().max().item() for w in want])


@pytest.mark.parametrize("kind", ["spd", "indefinite"])
@pytest.mark.parametrize("shape", [(64, 120, 120), (3, 40, 40), (8, 32, 32),
                                   (5, 30, 30), (2, 56, 56), (2, 128, 128)])
def test_mid_kernel_against_float64(gen, shape, kind):
    """The mid kernel's blocked path (n > 32) sums in blocked order with
    fused multiply-adds, so on SPD inputs its L, raw L^-1 and refined L^-1
    are each held against float64 on the same float32 input: its error may
    be at most 4x the plain version's plus 1e-6 of the largest entry.  On
    the float32-indefinite input the guard pins pivots that rounding
    decides: it must stay finite and factor a nearby matrix.  Above the
    diagonal it writes exact zeros.  The warp path (n <= 32) rounds as the
    plain version does: equal bit for bit."""
    a = (_spd if kind == "spd" else _indefinite)(shape, gen)
    before = tls.LAUNCHES["chol_inv_mid_cuda"]
    l, il = tls.chol_inv_mid_cuda(a)
    torch.cuda.synchronize()
    assert tls.LAUNCHES["chol_inv_mid_cuda"] == before + 1
    assert torch.isfinite(l).all() and torch.isfinite(il).all()
    assert not torch.triu(l, 1).any() and not torch.triu(il, 1).any()
    lp, ilp = tls._chol_inv_plain(a)
    if tls.mid_launch_plan(shape[-1], 1).path == "warp":
        torch.testing.assert_close(l, lp, rtol=0, atol=0)
        torch.testing.assert_close(il, ilp, rtol=0, atol=0)
    if kind == "spd":
        errs, scales = _f64_errors(a, l, il)
        plain_errs, _ = _f64_errors(a, lp, ilp)
        for err, plain, scale in zip(errs, plain_errs, scales):
            assert err <= 4 * plain + 1e-6 * scale
    else:
        l64, a64 = l.double(), a.double()
        rec = (l64 @ l64.mT - a64).norm(dim=(-2, -1)) / a64.norm(dim=(-2, -1))
        assert rec.max().item() <= 1e-4


@pytest.mark.parametrize("cotangents", ["both", "l_bar only", "il_bar only"])
@pytest.mark.parametrize("shape", [(32, 20, 20, 20), (32, 20, 16, 16),
                                   (3, 48, 48), (65, 8, 8), (1001, 20, 20),
                                   (17, 32, 32), (9, 40, 40), (33, 19, 19)])
def test_bwd_kernel_against_plain_version(gen, shape, cotangents):
    """The backward kernel and its plain version (``_bwd_reference``), both
    float32 on the card, are each held against ``_bwd_reference`` in float64
    on the same float32 inputs: the kernel sums in another order with fused
    multiply-adds, so its error may be at most 4x the plain version's plus
    1e-6 max|A_bar|.  Above the diagonal it writes exact zeros."""
    l, il = tls.chol_inv_small_cuda(_spd(shape, gen))
    lb = torch.randn(shape, generator=gen, device="cuda")
    ilb = torch.randn(shape, generator=gen, device="cuda")
    if cotangents == "l_bar only":
        ilb.zero_()
    elif cotangents == "il_bar only":
        lb.zero_()
    before = tls.LAUNCHES["chol_inv_bwd_cuda"]
    got = tls.chol_inv_bwd_cuda(l, il, lb, ilb)
    torch.cuda.synchronize()
    assert tls.LAUNCHES["chol_inv_bwd_cuda"] == before + 1
    plain = tls._chol_inv_bwd_plain(l, il, lb, ilb)
    want = tls._bwd_reference(l.double(), il.double(), lb.double(),
                              ilb.double())
    err = (got.double() - want).abs().max().item()
    err_plain = (plain.double() - want).abs().max().item()
    assert err <= 4 * err_plain + 1e-6 * want.abs().max().item()
    assert torch.isfinite(got).all()
    assert not torch.triu(got, 1).any()


def test_bwd_kernel_takes_strided_cotangents(gen):
    """Autograd may hand the backward an expanded or transposed gradient."""
    l, il = tls.chol_inv_small_cuda(_spd((5, 20, 20), gen))
    lb = torch.randn((20, 20), generator=gen, device="cuda").expand(5, 20, 20)
    ilb = torch.randn((5, 20, 20), generator=gen, device="cuda").mT
    got = tls.chol_inv_bwd_cuda(l, il, lb, ilb)
    want = tls.chol_inv_bwd_cuda(l, il, lb.contiguous(), ilb.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_autograd_path_launches_the_kernels(gen):
    """``chol_inv_blocked`` on CUDA goes through the kernels, never the
    plain versions, and the small factorization's backward is its kernel."""
    tls.reset_counters()
    for n in (20, 30, 120):   # n = 30 takes the mid kernel's one-warp path
        a = _spd((4, n, n), gen).requires_grad_(True)
        l, il = tls.chol_inv_blocked(a)
        (l.sum() + il.sum()).backward()
        assert torch.isfinite(a.grad).all()
    assert tls.LAUNCHES == {"chol_inv_small_cuda": 1, "chol_inv_mid_cuda": 2,
                            "chol_inv_bwd_cuda": 1}
    assert tls.PLAIN_CUDA_CALLS == {"chol_inv_plain": 0,
                                    "chol_inv_bwd_plain": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    a = _spd((2, 20, 20), gen)
    with pytest.raises(ValueError, match="float32 or float64"):
        tls.chol_inv_small_cuda(a.half())
    with pytest.raises(ValueError, match="contiguous"):
        tls.chol_inv_small_cuda(a.mT)
    with pytest.raises(ValueError, match="n <="):
        tls.chol_inv_small_cuda(_spd((2, 50, 50), gen))
    with pytest.raises(ValueError, match="n <= 128"):
        tls.chol_inv_mid_cuda(_spd((2, 130, 130), gen))
    l, il = tls.chol_inv_small_cuda(a)
    with pytest.raises(ValueError, match="equal shapes"):
        tls.chol_inv_bwd_cuda(l, il, l[:1], il)
    with pytest.raises(ValueError, match="one dtype"):
        tls.chol_inv_bwd_cuda(l, il, l.double(), il)
    with pytest.raises(ValueError, match="CUDA"):
        tls.chol_inv_bwd_cuda(l, il, l.cpu(), il)
    big = _spd((2, 50, 50), gen)
    with pytest.raises(ValueError, match="n <="):
        tls.chol_inv_bwd_cuda(big, big, big, big)


# ---- float64 -----------------------------------------------------------------

def _residuals(a, l, il):
    """(max |LL^T - A| / |A| over the batch, Frobenius; max |L^-1 L - I|),
    in the inputs' dtype."""
    eye = torch.eye(a.shape[-1], device=a.device, dtype=a.dtype)
    rec = ((l @ l.mT - a).norm(dim=(-2, -1)) / a.norm(dim=(-2, -1))).max()
    return rec.item(), (il @ l - eye).abs().max().item()


F64_SMALL_SHAPES = [(32, 20, 20, 20), (1001, 20, 20), (33, 19, 19),
                    (64, 24, 24), (1001, 32, 32), (64, 40, 40), (17, 48, 48)]


def _guard64(shape, gen):
    """logspace(0, -20) spectrum: indefinite after rounding to float64, so
    trailing pivots fall below the float64 floor of 2e-15 max diag A."""
    n = shape[-1]
    q, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, device="cuda",
                                       dtype=torch.float64))
    a = (q * torch.logspace(0.0, -20.0, n, device="cuda",
                            dtype=torch.float64)) @ q.T
    return (0.5 * (a + a.T)).expand(shape).contiguous()


@pytest.mark.parametrize("kind", ["spd", "indefinite", "guard"])
@pytest.mark.parametrize("shape", F64_SMALL_SHAPES)
def test_float64_small_kernel_equals_plain_version(gen, shape, kind):
    """In float64 the small kernel also does its plain version's operations
    in the same order: equal bit for bit, exact zeros above the diagonal;
    on the guard input some pivot is floored."""
    a = (_guard64(shape, gen) if kind == "guard" else
         (_spd if kind == "spd" else _indefinite)(shape, gen).double())
    before = tls.LAUNCHES["chol_inv_small_cuda"]
    l, il = tls.chol_inv_small_cuda(a)
    torch.cuda.synchronize()
    assert tls.LAUNCHES["chol_inv_small_cuda"] == before + 1
    assert l.dtype == il.dtype == torch.float64
    lp, ilp = tls._chol_inv_plain(a)
    torch.testing.assert_close(l, lp, rtol=0, atol=0)
    torch.testing.assert_close(il, ilp, rtol=0, atol=0)
    assert not torch.triu(l, 1).any() and not torch.triu(il, 1).any()
    if kind == "guard":
        floor = tls.pivot_floor_rel(torch.float64) * torch.diagonal(
            a, dim1=-2, dim2=-1).amax(-1, keepdim=True)
        d2 = torch.diagonal(l, dim1=-2, dim2=-1) ** 2
        assert ((d2 - floor).abs() < 1e-6 * floor).any()


@pytest.mark.parametrize("shape", [(64, 120, 120), (32, 120, 120),
                                   (8, 32, 32), (32, 256, 32, 32),
                                   (3, 40, 40), (2, 112, 112), (5, 113, 113),
                                   (2, 128, 128), (1, 33, 33), (1, 120, 120),
                                   (3, 127, 127), (65, 120, 120)])
def test_float64_mid_kernel_against_plain_version(gen, shape):
    """The float64 mid kernel: its one-warp path (n <= 32) bit-equal to the
    plain version; its blocked path (its own kernel, L^-1 packed beside A
    in shared memory) has residuals |LL^T - A| / |A| and |L^-1 L - I|
    within 4x the plain version's plus 1e-12, on SPD and on
    ill-conditioned (logspace(0, -6) spectrum) inputs.  On the guard input
    (logspace(0, -20), indefinite after rounding) some pivot sits on the
    float64 floor, 2e-15 max diag A, and L still factors a nearby matrix."""
    n = shape[-1]
    warp = tls.mid_launch_plan(n, 1, 8).path == "warp"
    for kind, a in (("spd", _spd(shape, gen).double()),
                    ("ill", _ill(shape, gen)),
                    ("guard", _guard64(shape, gen))):
        l, il = tls.chol_inv_mid_cuda(a)
        torch.cuda.synchronize()
        assert torch.isfinite(l).all() and torch.isfinite(il).all()
        assert not torch.triu(l, 1).any() and not torch.triu(il, 1).any()
        lp, ilp = tls._chol_inv_plain(a)
        if warp:
            torch.testing.assert_close(l, lp, rtol=0, atol=0)
            torch.testing.assert_close(il, ilp, rtol=0, atol=0)
            continue
        got, want = _residuals(a, l, il), _residuals(a, lp, ilp)
        if kind == "guard":
            floor = tls.pivot_floor_rel(torch.float64) * torch.diagonal(
                a, dim1=-2, dim2=-1).amax(-1, keepdim=True)
            d2 = torch.diagonal(l, dim1=-2, dim2=-1) ** 2
            assert ((d2 - floor).abs() < 1e-6 * floor).any()
            assert got[0] <= 1e-4, got
            continue
        for g, w in zip(got, want):
            assert g <= 4 * w + 1e-12, (kind, got, want)


def _ill(shape, gen):
    n = shape[-1]
    q, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, device="cuda",
                                       dtype=torch.float64))
    a = (q * torch.logspace(0.0, -6.0, n, device="cuda",
                            dtype=torch.float64)) @ q.T
    return (0.5 * (a + a.T)).expand(shape).contiguous()


@pytest.mark.parametrize("shape", [(32, 20, 20, 20), (3, 48, 48),
                                   (33, 19, 19), (17, 32, 32)])
def test_float64_bwd_kernel_against_plain_version(gen, shape):
    """The float64 backward kernel sums in another order than its plain
    version: its distance to the plain version on the card may be at most
    4x the distance between the plain version on the card and on the CPU
    (two orders of the same products), plus 1e-12 max|A_bar|."""
    l, il = tls.chol_inv_small_cuda(_spd(shape, gen).double())
    lb = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float64)
    ilb = torch.randn(shape, generator=gen, device="cuda",
                      dtype=torch.float64)
    before = tls.LAUNCHES["chol_inv_bwd_cuda"]
    got = tls.chol_inv_bwd_cuda(l, il, lb, ilb)
    torch.cuda.synchronize()
    assert tls.LAUNCHES["chol_inv_bwd_cuda"] == before + 1
    plain = tls._chol_inv_bwd_plain(l, il, lb, ilb)
    plain_cpu = tls._bwd_reference(l.cpu(), il.cpu(), lb.cpu(), ilb.cpu())
    err = (got - plain).abs().max().item()
    spread = (plain.cpu() - plain_cpu).abs().max().item()
    assert err <= 4 * spread + 1e-12 * plain.abs().max().item()
    assert not torch.triu(got, 1).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_composition_goes_through_the_kernels(gen, dtype):
    """n > 128 (sequences of T = 200 and the eval buckets of 256) runs
    hlax's blocked composition with the diagonal blocks on the mid kernel,
    forward and backward, in both dtypes; no plain version runs, and L and
    L^-1 match float64 torch.linalg on the same input."""
    tls.reset_counters()
    for n in (200, 256, 131):
        a = _spd((3, n, n), gen).to(dtype).requires_grad_(True)
        l, il = tls.chol_inv_blocked(a)
        (l.sum() + il.sum()).backward()
        assert torch.isfinite(a.grad).all()
        l64 = torch.linalg.cholesky(a.detach().double())
        tol = 1e-4 if dtype == torch.float32 else 1e-12
        assert (l.double() - l64).abs().max().item() <= tol
        eye = torch.eye(n, device="cuda", dtype=torch.float64)
        assert (il.double() @ l64 - eye).abs().max().item() <= 10 * tol
    assert tls.LAUNCHES["chol_inv_mid_cuda"] == 6
    assert tls.PLAIN_CUDA_CALLS == {"chol_inv_plain": 0,
                                    "chol_inv_bwd_plain": 0}
    assert all(dt == str(dtype).removeprefix("torch.") and sh[-1] <= 128
               for (_, sh, dt) in tls.LAUNCHES_BY_SHAPE)


def test_float64_autograd_path_launches_the_kernels(gen):
    """float64 on CUDA launches the float64 kernels, never a plain
    version."""
    tls.reset_counters()
    for n in (20, 30, 120):
        a = _spd((4, n, n), gen).double().requires_grad_(True)
        l, il = tls.chol_inv_blocked(a)
        (l.sum() + il.sum()).backward()
        assert torch.isfinite(a.grad).all()
    assert tls.LAUNCHES == {"chol_inv_small_cuda": 1, "chol_inv_mid_cuda": 2,
                            "chol_inv_bwd_cuda": 1}
    assert tls.PLAIN_CUDA_CALLS == {"chol_inv_plain": 0,
                                    "chol_inv_bwd_plain": 0}
    assert {dt for (_, _, dt) in tls.LAUNCHES_BY_SHAPE} == {"float64"}


# ---- the train step as CUDA graphs ------------------------------------------

@pytest.fixture
def cudnn_deterministic():
    """cuDNN's deterministic algorithms: its default weight gradient sums
    with atomics, in another order from run to run."""
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = False


@pytest.mark.parametrize("noise", ["injected", "generator"])
def test_train_epoch_graphs_equal_eager_steps(gen, cudnn_deterministic,
                                              noise):
    """``make_train_epoch``'s graphs (2 steps a graph, and the remainder's)
    against the same steps run eagerly, toy widths in float64 from one
    seed, both with cuDNN's deterministic algorithms: the losses, m, H and
    the VAE's parameters, the step count, the kernel launches counted and
    the generator's state."""
    import numpy as np

    from hlax_torch.data import dataset as ds
    from hlax_torch.data import generate as dgen
    from hlax_torch.data.reader import encode_raw
    from hlax_torch.gp.kernels import build_kernel_specs
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.train import step as tstep

    out = dgen.generate(num_3=3, num_6=3, datatype_config="D4", seed=2)
    labels = np.nan_to_num(out["labels"][:, ds.HEALTH_MNIST_LABEL_ORDER])
    het = encode_raw(out["data"], dgen.types_table("D4"),
                     miss_mask=out["mask"])
    data = ds.LongitudinalDataset(het=het, labels=labels, id_covariate=2)
    spec0, spec1 = build_kernel_specs(
        [2], [], [0], [{"cont_covariate": 0, "cat_covariate": 2},
                       {"cont_covariate": 0, "cat_covariate": 3},
                       {"cont_covariate": 1, "cat_covariate": 4}], [], [], 2)
    cfg = tstep.TrainConfig(latent_dim=8, M=30, P_tot=float(data.P),
                            N_tot=float(len(data)), id_covariate=2,
                            constrain_scales=True, gp_dtype=torch.float64)

    def state():
        model = HLVAE(HLVAEConfig(layout=data.layout, z_dim=8, h_dims=(50,)),
                      torch.Generator("cuda").manual_seed(0),
                      "cuda").double()
        return tstep.init_train_state(model, spec0, spec1,
                                      next(ds.subject_batches(data, 2)), cfg)

    staged = ds.stage_dataset(data, torch.float64, "cuda")
    rng = np.random.default_rng(0)
    idx = [np.stack(list(ds.epoch_subject_batches(data.P, 2, rng)))
           for _ in range(2)]
    eps = [torch.randn((3, 2 * data.T_max, 8), generator=gen, device="cuda",
                       dtype=torch.float64) if noise == "injected" else None
           for _ in idx]
    a, b = state(), state()
    step = tstep.make_train_step(a.vae, spec0, spec1, cfg)
    epoch = tstep.make_train_epoch(b.vae, spec0, spec1, cfg, unroll=2)
    tls.reset_counters()
    want = [step(a, ds.gather_batch(staged, torch.as_tensor(i, device="cuda")),
                 eps=None if e is None else e[j])["loss"].item()
            for ib, e in zip(idx, eps) for j, i in enumerate(ib)]
    launches = dict(tls.LAUNCHES_BY_SHAPE)
    tls.reset_counters()
    got = np.concatenate([epoch(b, staged, ib, eps=e)["loss"]
                          for ib, e in zip(idx, eps)])
    assert dict(tls.LAUNCHES_BY_SHAPE) == launches and launches
    assert a.step == b.step == 6
    np.testing.assert_allclose(got, want, rtol=1e-10)
    for x, y in [(a.m, b.m), (a.H, b.H)] + list(zip(a.vae.parameters(),
                                                    b.vae.parameters())):
        torch.testing.assert_close(y, x, rtol=1e-10, atol=1e-12)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# ---- the fused conv stack and bfloat16 ---------------------------------------

def _toy_d4(n_3=3, n_6=3):
    import numpy as np

    from hlax_torch.data import dataset as ds
    from hlax_torch.data import generate as dgen
    from hlax_torch.data.reader import encode_raw

    out = dgen.generate(num_3=n_3, num_6=n_6, datatype_config="D4", seed=2)
    labels = np.nan_to_num(out["labels"][:, ds.HEALTH_MNIST_LABEL_ORDER])
    het = encode_raw(out["data"], dgen.types_table("D4"),
                     miss_mask=out["mask"])
    return ds.LongitudinalDataset(het=het, labels=labels, id_covariate=2)


def test_fused_stack_against_cudnn(gen, cudnn_deterministic):
    """The fused conv stack (patch matmuls) and cuDNN's convolutions, one
    set of float32 weights, 120 D4 rows: mu, log_var and log_p_x, and every
    parameter's gradient within 1e-4 and 1e-3 of their norm (two float32
    summation orders of the same products, TF32 off; a bias gradient sums
    every pixel of every row, with cancellation)."""
    import dataclasses

    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig

    data = _toy_d4()
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    het = data.het
    x, m, tm = t(het.data), t(het.mask), t(het.theta_mask)
    eps = torch.randn((len(data), 8), generator=gen, device="cuda")
    cfg = HLVAEConfig(layout=data.layout, z_dim=8, h_dims=(50,))
    outs = {}
    for fused in (False, True):
        model = HLVAE(dataclasses.replace(cfg, fused_conv=fused),
                      torch.Generator("cuda").manual_seed(0), "cuda")
        out = model(x, m, tm, eps=eps)
        (out["log_p_x"].sum() + out["mu"].sum()).backward()
        outs[fused] = (out, {k: p.grad for k, p in model.named_parameters()
                             if p.grad is not None})
    (a, ga), (b, gb) = outs[False], outs[True]
    rel = lambda u, v: ((u - v).norm() / v.norm().clamp_min(1e-30)).item()
    for k in ("mu", "log_var", "log_p_x"):
        assert rel(b[k], a[k]) <= 1e-4, k
    assert ga.keys() == gb.keys()
    for k in ga:
        assert rel(gb[k], ga[k]) <= 1e-3, k


@pytest.mark.parametrize("mode", ["compute_dtype", "model_dtype"])
def test_bfloat16_graph_epoch_equals_eager_epoch(gen, cudnn_deterministic,
                                                 mode):
    """bfloat16 (the stacks with ``compute_dtype``, or the whole model) with
    the GP in float32: ``make_train_epoch``'s graphs against the same steps
    run eagerly from one seed, with injected noise.  Both run the same
    kernels in the same order: the losses within 2^-8 relative (bfloat16's
    unit roundoff), m and H within 1e-3 of their norm, the same launches
    and step counts, and finite losses throughout."""
    import numpy as np

    from hlax_torch.data import dataset as ds
    from hlax_torch.gp.kernels import build_kernel_specs
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.train import step as tstep

    data = _toy_d4()
    spec0, spec1 = build_kernel_specs(
        [2], [], [0], [{"cont_covariate": 0, "cat_covariate": 2},
                       {"cont_covariate": 0, "cat_covariate": 3},
                       {"cont_covariate": 1, "cat_covariate": 4}], [], [], 2)
    cfg = tstep.TrainConfig(latent_dim=8, M=30, P_tot=float(data.P),
                            N_tot=float(len(data)), id_covariate=2,
                            constrain_scales=True)
    mdt = torch.bfloat16 if mode == "model_dtype" else torch.float32
    mcfg = HLVAEConfig(layout=data.layout, z_dim=8, h_dims=(50,),
                       compute_dtype=torch.bfloat16
                       if mode == "compute_dtype" else None)

    def state():
        model = HLVAE(mcfg, torch.Generator("cuda").manual_seed(0),
                      "cuda").to(mdt)
        return tstep.init_train_state(model, spec0, spec1,
                                      next(ds.subject_batches(data, 2)), cfg)

    staged = ds.stage_dataset(data, mdt, "cuda")
    rng = np.random.default_rng(0)
    idx = [np.stack(list(ds.epoch_subject_batches(data.P, 2, rng)))
           for _ in range(2)]
    eps = [torch.randn((3, 2 * data.T_max, 8), generator=gen, device="cuda",
                       dtype=mdt) for _ in idx]
    a, b = state(), state()
    step = tstep.make_train_step(a.vae, spec0, spec1, cfg)
    epoch = tstep.make_train_epoch(b.vae, spec0, spec1, cfg, unroll=2)
    tls.reset_counters()
    want = [step(a, ds.gather_batch(staged, torch.as_tensor(i, device="cuda")),
                 eps=e[j])["loss"].float().item()
            for ib, e in zip(idx, eps) for j, i in enumerate(ib)]
    launches = dict(tls.LAUNCHES_BY_SHAPE)
    tls.reset_counters()
    got = np.concatenate([epoch(b, staged, ib, eps=e)["loss"]
                          for ib, e in zip(idx, eps)])
    assert dict(tls.LAUNCHES_BY_SHAPE) == launches and launches
    assert {dt for (_, _, dt) in launches} == {"float32"}
    assert a.step == b.step == 6
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8)
    for x, y in ((a.m, b.m), (a.H, b.H)):
        assert ((y - x).norm() / x.norm()).item() <= 1e-3
    assert all(p.dtype == mdt for p in b.vae.parameters())


# ---- mesh training (hlax_torch/parallel) ------------------------------------

# seconds a spawned mesh of these tests may take before its ranks are killed
MESH_LIMIT = 180
# graph steps against eager mesh steps, by dtype (those of the one-card
# graph test in float64, with cuDNN's deterministic algorithms)
MESH_GRAPH_BOUND = {torch.float64: 1e-10, torch.float32: 1e-5}


def _mesh_problem(device, dtype=torch.float64):
    """Toy D4 problem (6 subjects, L = 8, M = 30, the GP jitter of the CPU
    parity tests, 1e-4) and its whole train state in ``dtype``, made from
    one seed on ``device``."""
    from hlax_torch.data import dataset as ds
    from hlax_torch.gp.kernels import build_kernel_specs
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.train import step as tstep

    data = _toy_d4()
    spec0, spec1 = build_kernel_specs(
        [2], [], [0], [{"cont_covariate": 0, "cat_covariate": 3}], [], [], 2)
    cfg = tstep.TrainConfig(latent_dim=8, M=30, P_tot=float(data.P),
                            N_tot=float(len(data)), id_covariate=2,
                            constrain_scales=True, gp_dtype=dtype, eps=1e-4)
    model = HLVAE(HLVAEConfig(layout=data.layout, z_dim=8, h_dims=(50,)),
                  torch.Generator(device).manual_seed(0), device).to(dtype)
    state = tstep.init_train_state(model, spec0, spec1,
                                   next(ds.subject_batches(data, 2)), cfg)
    return data, spec0, spec1, cfg, state


def _mesh_idx(data, n_data, epochs=1):
    """``epochs`` epochs of 2 subjects a batch: the mesh's local indices
    [epochs, nb, n_data, S_loc] and the same batches' global indices
    [epochs, nb, 2]."""
    import numpy as np

    from hlax_torch.data import dataset as ds

    rng = np.random.default_rng(0)
    idx = np.stack([ds.epoch_subject_batches_mesh(data.P, n_data, 2, rng)
                    for _ in range(epochs)])
    P_loc = -(-data.P // n_data)
    glob = np.where(idx >= 0, idx + (np.arange(n_data) * P_loc)[
        None, None, :, None], -1).reshape(idx.shape[:2] + (-1,))
    return idx, glob


def _state_tensors(state):
    return [state.m, state.H] + list(state.vae.parameters())


def _mesh_rank(rank, world, init, backend, n_data, n_latent,
               modes=("epoch",), dtype=torch.float64, epochs=1):
    """A mesh rank (gloo: on cuda:0; NCCL: on cuda:<rank>), cuDNN's
    deterministic algorithms: for each of ``modes``, from the state made
    from the seed, ``epochs`` epochs of mesh steps, noise from the
    generator: "epoch" through ``make_train_epoch_mesh`` (CUDA graphs over
    NCCL, 2 steps a graph and the remainder's; eager over gloo), "eager"
    the same steps one by one (``train_epoch``).  Returns by mode the
    losses and the gathered state's m, H and VAE parameters."""
    import numpy as np

    from hlax_torch.data import dataset as ds
    from hlax_torch.parallel import distributed as pdist
    from hlax_torch.parallel import mesh as pmesh
    from hlax_torch.train import step as tstep

    device = f"cuda:{rank if backend == 'nccl' else 0}"
    torch.cuda.set_device(device)
    torch.backends.cudnn.deterministic = True
    pdist.initialize(backend, init, world, rank, device=device, timeout=120)
    try:
        mesh = pmesh.make_mesh(n_data, n_latent)
        data, spec0, spec1, cfg, _ = _mesh_problem(device, dtype)
        staged = ds.stage_dataset_mesh(data, dtype, device, n_data, mesh.d)
        idx = _mesh_idx(data, n_data, epochs)[0]
        out = {}
        for mode in modes:
            state = pmesh.shard_state(_mesh_problem(device, dtype)[-1], mesh,
                                      cfg)
            if mode == "epoch":
                epoch = tstep.make_train_epoch_mesh(state.vae, spec0, spec1,
                                                    cfg, mesh, unroll=2)
                loss = [epoch(state, staged, i)["loss"] for i in idx]
            else:
                step = tstep.make_train_step(state.vae, spec0, spec1, cfg,
                                             mesh=mesh)
                loss = [tstep.train_epoch(step, state, staged,
                                          i[:, mesh.d])["loss"] for i in idx]
            whole = pmesh.gather_state(state, mesh, cfg)
            out[mode] = (np.concatenate(loss), [
                t.detach().cpu() for t in _state_tensors(whole)])
        return out
    finally:
        pdist.destroy()


def _against_single_process(ranks, mode, n_data, epochs=1):
    """Each rank's losses and gathered state of ``mode`` against the single
    process's steps on the same global batches, float64 (noise from the
    generator)."""
    import numpy as np

    from hlax_torch.data import dataset as ds
    from hlax_torch.train import step as tstep

    data, spec0, spec1, cfg, state = _mesh_problem("cuda")
    step = tstep.make_train_step(state.vae, spec0, spec1, cfg)
    staged = ds.stage_dataset(data, torch.float64, "cuda")
    want = [step(state, ds.gather_batch(staged, torch.as_tensor(
        i, device="cuda")))["loss"].item()
        for ib in _mesh_idx(data, n_data, epochs)[1] for i in ib]
    for r in ranks:
        loss, tensors = r[mode]
        np.testing.assert_allclose(loss, want, rtol=1e-9)
        for a, b in zip(tensors, _state_tensors(state)):
            torch.testing.assert_close(a, b.detach().cpu(), rtol=1e-7,
                                       atol=1e-9)


def _two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (NCCL takes one a rank)")


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_gloo_mesh_on_one_card_equals_single_process(gen,
                                                     cudnn_deterministic,
                                                     shape):
    """Two gloo ranks sharing the card (data or latent parallel) take the
    single process's steps on the same global batches: losses, m, H and
    the VAE's parameters, float64; ``make_train_epoch_mesh`` runs them
    eagerly over gloo."""
    from hlax_torch.parallel import distributed as pdist

    _against_single_process(
        pdist.spawn(_mesh_rank, 2, ("gloo",) + shape, timeout=MESH_LIMIT),
        "epoch", shape[0])


def test_nccl_mesh_on_two_cards_equals_single_process(gen,
                                                      cudnn_deterministic):
    """Two NCCL ranks, one a card (data parallel), take the single
    process's steps on the same global batches, eagerly, float64."""
    from hlax_torch.parallel import distributed as pdist

    _two_cards()
    _against_single_process(
        pdist.spawn(_mesh_rank, 2, ("nccl", 2, 1, ("eager",)),
                    timeout=MESH_LIMIT), "eager", 2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_nccl_graph_mesh_epoch_equals_eager_mesh_epoch(gen,
                                                       cudnn_deterministic,
                                                       dtype):
    """Two NCCL ranks, one a card (data parallel): two epochs through
    ``make_train_epoch_mesh``'s CUDA graphs (the collectives captured; 2
    eager warm-up steps, then graphs of 2 steps and of the remainder)
    equal the same steps run eagerly from the same seed (MESH_GRAPH_BOUND:
    losses, m, H and the VAE's parameters); in float64 both equal the
    single process's steps."""
    import numpy as np

    from hlax_torch.parallel import distributed as pdist

    _two_cards()
    ranks = pdist.spawn(_mesh_rank, 2, ("nccl", 2, 1, ("eager", "epoch"),
                                        dtype, 2), timeout=MESH_LIMIT)
    bound = MESH_GRAPH_BOUND[dtype]
    for r in ranks:
        (want, a), (got, b) = r["eager"], r["epoch"]
        assert len(got) == len(want) == 6 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=bound)
        for x, y in zip(a, b):
            torch.testing.assert_close(y, x, rtol=bound, atol=bound * 1e-2)
    if dtype == torch.float64:
        for mode in ("eager", "epoch"):
            _against_single_process(ranks, mode, 2, epochs=2)
