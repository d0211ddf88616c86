"""The CUDA kernels on the card, against their plain versions.

Imports neither JAX nor hlax, so it runs on the GPU machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test skips without a CUDA device.
"""
import pathlib
import sys

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
    plain versions, and both factorizations' backward are their kernels
    (n = 30 and 120 through the mid pullback)."""
    tls.reset_counters()
    for n in (20, 30, 120):   # n = 30 takes the mid kernel's one-warp path
        a = _spd((4, n, n), gen).requires_grad_(True)
        l, il = tls.chol_inv_blocked(a)
        (l.sum() + il.sum()).backward()
        assert torch.isfinite(a.grad).all()
    assert tls.LAUNCHES == {"chol_inv_small_cuda": 1, "chol_inv_mid_cuda": 2,
                            "chol_inv_bwd_cuda": 1,
                            "chol_inv_mid_bwd_cuda": 2}
    assert tls.PLAIN_CUDA_CALLS == {"chol_inv_plain": 0,
                                    "chol_inv_bwd_plain": 0,
                                    "chol_inv_mid_bwd_plain": 0}


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
    assert tls.LAUNCHES["chol_inv_mid_bwd_cuda"] == 6
    assert tls.PLAIN_CUDA_CALLS == {"chol_inv_plain": 0,
                                    "chol_inv_bwd_plain": 0,
                                    "chol_inv_mid_bwd_plain": 0}
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
                            "chol_inv_bwd_cuda": 1,
                            "chol_inv_mid_bwd_cuda": 2}
    assert tls.PLAIN_CUDA_CALLS == {"chol_inv_plain": 0,
                                    "chol_inv_bwd_plain": 0,
                                    "chol_inv_mid_bwd_plain": 0}
    assert {dt for (_, _, dt) in tls.LAUNCHES_BY_SHAPE} == {"float64"}


# ---- the mid factorization's pullback (csrc/chol_inv_mid_bwd.cu) ----------

# the training path's K0zz with H and the natural-gradient inverse's batch,
# the long sequences' diagonal blocks (T = 200 and 500), [reference]'s toy
# M = 30; then the range's ends, one panel and a ragged last one, a single
# matrix and odd batches
MID_BWD_SHAPES = [(64, 120, 120), (32, 120, 120), (32, 4, 100, 100),
                  (32, 2, 125, 125), (16, 30, 30), (3, 25, 25), (5, 33, 33),
                  (2, 64, 64), (1, 128, 128), (7, 97, 97), (9, 127, 127)]


def _mid_factors(shape, dtype, gen):
    """(L, L^-1) as the training path saves them: the mid kernel, then its
    Newton step."""
    l, il = tls.chol_inv_mid_cuda(_spd(shape, gen).to(dtype))
    return l, tls._refine_tri_inverse(l, il)


def _hold_mid_bwd(got, l, il, lb, ilb):
    """``test_mid_bwd_kernel_against_plain_version``'s bars."""
    plain = tls._chol_inv_bwd_plain(l, il, lb, ilb, "chol_inv_mid_bwd_plain")
    assert torch.isfinite(got).all() and not torch.triu(got, 1).any()
    if got.dtype == torch.float64:
        assert (got - plain).abs().max().item() <= \
            1e-10 * plain.abs().max().item()
        return
    want = tls._bwd_reference(l.double(), il.double(), lb.double(),
                              ilb.double())
    err = (got.double() - want).abs().max().item()
    err_plain = (plain.double() - want).abs().max().item()
    assert err <= 4 * err_plain + 1e-6 * want.abs().max().item()


@pytest.mark.parametrize("cotangents", ["both", "l_bar only", "il_bar only"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", MID_BWD_SHAPES)
def test_mid_bwd_kernel_against_plain_version(gen, shape, dtype, cotangents):
    """The mid pullback's kernels against its plain version
    (``_bwd_reference``): in float32 the kernels and the plain version are
    each held against ``_bwd_reference`` in float64 on the same inputs, the
    kernels' error at most 4x the plain version's plus 1e-6 max|A_bar| (they
    sum in another order, with fused multiply-adds); in float64 within
    1e-10 of the plain version's largest entry.  Exact zeros above the
    diagonal, one count a call."""
    l, il = _mid_factors(shape, dtype, gen)
    lb = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    ilb = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    if cotangents == "l_bar only":
        ilb.zero_()
    elif cotangents == "il_bar only":
        lb.zero_()
    before = tls.LAUNCHES["chol_inv_mid_bwd_cuda"]
    got = tls.chol_inv_mid_bwd_cuda(l, il, lb, ilb)
    torch.cuda.synchronize()
    assert tls.LAUNCHES["chol_inv_mid_bwd_cuda"] == before + 1
    _hold_mid_bwd(got, l, il, lb, ilb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mid_bwd_kernel_takes_strided_and_misaligned_tensors(gen, dtype):
    """Expanded and transposed cotangents, and contiguous views one value
    past a 16-byte boundary (the kernels' one-value copies), give the
    aligned contiguous inputs' result bit for bit; n = 122, whose float32
    rows do not hold whole 16-byte copies, is held to the plain version."""
    shape = (5, 120, 120)
    l, il = _mid_factors(shape, dtype, gen)
    lb = torch.randn(shape[1:], generator=gen, device="cuda",
                     dtype=dtype).expand(shape)
    ilb = torch.randn(shape, generator=gen, device="cuda", dtype=dtype).mT
    want = tls.chol_inv_mid_bwd_cuda(l, il, lb.contiguous(),
                                     ilb.contiguous())
    got = tls.chol_inv_mid_bwd_cuda(l, il, lb, ilb)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device="cuda", dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    got = tls.chol_inv_mid_bwd_cuda(*(shifted(t.contiguous()) for t in
                                      (l, il, lb, ilb)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    l, il = _mid_factors((3, 122, 122), dtype, gen)
    lb = torch.randn(l.shape, generator=gen, device="cuda", dtype=dtype)
    ilb = torch.randn(l.shape, generator=gen, device="cuda", dtype=dtype)
    _hold_mid_bwd(tls.chol_inv_mid_bwd_cuda(l, il, lb, ilb), l, il, lb, ilb)


def test_mid_bwd_wrapper_refuses_what_the_kernels_do_not_take(gen):
    """n <= 24 (the small factorization's), n > 128 (the composition's
    blocks), mixed dtypes or shapes, a CPU tensor: a ValueError, no
    launch."""
    before = tls.LAUNCHES["chol_inv_mid_bwd_cuda"]
    for n in (24, 129):
        a = _spd((2, n, n), gen)
        with pytest.raises(ValueError, match="24 < n <= 128"):
            tls.chol_inv_mid_bwd_cuda(a, a, a, a)
    a = _spd((2, 40, 40), gen)
    with pytest.raises(ValueError, match="one dtype"):
        tls.chol_inv_mid_bwd_cuda(a, a, a.double(), a)
    with pytest.raises(ValueError, match="four equal shapes"):
        tls.chol_inv_mid_bwd_cuda(a, a, a[:1], a)
    with pytest.raises(ValueError, match="CUDA"):
        tls.chol_inv_mid_bwd_cuda(a.cpu(), a, a, a)
    assert tls.LAUNCHES["chol_inv_mid_bwd_cuda"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mid_bwd_graph_replays_eager_call(gen, dtype):
    """One call captured in a CUDA graph (its workspace from the graph's
    pool) replays the eager call's result bit for bit on new inputs."""
    shape = (64, 120, 120)
    l, il = _mid_factors(shape, dtype, gen)
    lb = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    ilb = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    tls.chol_inv_mid_bwd_cuda(l, il, lb, ilb)      # warm: build, attribute
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tls.chol_inv_mid_bwd_cuda(l, il, lb, ilb)
    for t in (lb, ilb):
        t.copy_(torch.randn(shape, generator=gen, device="cuda", dtype=dtype))
    graph.replay()
    torch.cuda.synchronize()
    want = tls.chol_inv_mid_bwd_cuda(l, il, lb, ilb)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_canonical_step_takes_the_mid_pullback(gen):
    """One float32 train step of the canonical widths (L = 32, M = 120, the
    conv model, 20 subjects of T = 20) launches the mid pullback once, on
    K0zz stacked with H, and never its plain version."""
    chip_smoke = _chip_smoke()
    from hlax_torch.config import ModelArgs
    from hlax_torch.data import dataset as ds
    from hlax_torch.gp.kernels import build_kernel_specs
    from hlax_torch.ops import counters
    from hlax_torch.train import step as tstep

    opt = ModelArgs().parse_options([f"--f={chip_smoke.CONFIG}"])
    spec0, spec1 = build_kernel_specs(
        opt["cat_kernel"], opt["bin_kernel"], opt["sqexp_kernel"],
        opt["cat_int_kernel"], opt["bin_int_kernel"],
        opt["covariate_missing_val"], opt["id_covariate"])
    data = _toy_d4(10, 10)
    state, cfg = chip_smoke.canonical_state(data, spec0, spec1,
                                            torch.float32)
    step = tstep.make_train_step(state.vae, spec0, spec1, cfg)
    staged = ds.stage_dataset(data, torch.float32, "cuda")
    batch = ds.gather_batch(staged, torch.arange(20, device="cuda"))
    counters.reset_every()
    out = step(state, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(out["loss"]).all()
    assert tls.LAUNCHES["chol_inv_mid_bwd_cuda"] == 1
    assert tls.LAUNCHES_BY_SHAPE[("chol_inv_mid_bwd_cuda", (64, 120, 120),
                                  "float32")] == 1
    assert tls.PLAIN_CUDA_CALLS["chol_inv_mid_bwd_plain"] == 0
    assert not any(counters.read_every()[2].values())


# ---- the train step as CUDA graphs ------------------------------------------

@pytest.fixture
def cudnn_deterministic():
    """cuDNN's deterministic algorithms: its default weight gradient sums
    with atomics, in another order from run to run."""
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = False


def _graphs_against_eager(gen, noise, data=None, conv=True, subjects=2,
                          **cfg_kw):
    """``make_train_epoch``'s graphs (2 steps a graph, and the remainder's)
    against the same steps run eagerly, toy widths in float64 from one
    seed on ``data`` (toy D4 by default): the losses, m, H and the VAE's
    parameters at 1e-10, the step count, the kernel launches counted (the
    Cholesky kernels' and the fused ops') and the generator's state.
    ``cfg_kw`` sets more fields of the TrainConfig."""
    import numpy as np

    from hlax_torch.data import dataset as ds
    from hlax_torch.gp.kernels import build_kernel_specs
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.ops import fusion
    from hlax_torch.train import step as tstep

    data = _toy_d4() if data is None else data
    spec0, spec1 = build_kernel_specs(
        [2], [], [0], [{"cont_covariate": 0, "cat_covariate": 2},
                       {"cont_covariate": 0, "cat_covariate": 3},
                       {"cont_covariate": 1, "cat_covariate": 4}], [], [], 2)
    cfg = tstep.TrainConfig(latent_dim=8, M=30, P_tot=float(data.P),
                            N_tot=float(len(data)), id_covariate=2,
                            constrain_scales=True, gp_dtype=torch.float64,
                            **cfg_kw)

    def state():
        model = HLVAE(HLVAEConfig(layout=data.layout, z_dim=8, h_dims=(50,),
                                  conv=conv),
                      torch.Generator("cuda").manual_seed(0),
                      "cuda").double()
        return tstep.init_train_state(
            model, spec0, spec1, next(ds.subject_batches(data, subjects)),
            cfg)

    def launches():
        return dict(tls.LAUNCHES_BY_SHAPE), dict(fusion.LAUNCHES_BY_SHAPE)

    staged = ds.stage_dataset(data, torch.float64, "cuda")
    rng = np.random.default_rng(0)
    idx = [np.stack(list(ds.epoch_subject_batches(data.P, subjects, rng)))
           for _ in range(2)]
    nb = len(idx[0])
    eps = [torch.randn((nb, subjects * data.T_max, 8), generator=gen,
                       device="cuda", dtype=torch.float64)
           if noise == "injected" else None for _ in idx]
    a, b = state(), state()
    step = tstep.make_train_step(a.vae, spec0, spec1, cfg)
    epoch = tstep.make_train_epoch(b.vae, spec0, spec1, cfg, unroll=2)
    tls.reset_counters()
    fusion.reset_counters()
    want = [step(a, ds.gather_batch(staged, torch.as_tensor(i, device="cuda")),
                 eps=None if e is None else e[j])["loss"].item()
            for ib, e in zip(idx, eps) for j, i in enumerate(ib)]
    eager = launches()
    tls.reset_counters()
    fusion.reset_counters()
    got = np.concatenate([epoch(b, staged, ib, eps=e)["loss"]
                          for ib, e in zip(idx, eps)])
    assert launches() == eager
    assert a.step == b.step == 2 * nb
    np.testing.assert_allclose(got, want, rtol=1e-10)
    for x, y in [(a.m, b.m), (a.H, b.H)] + list(zip(a.vae.parameters(),
                                                    b.vae.parameters())):
        torch.testing.assert_close(y, x, rtol=1e-10, atol=1e-12)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    return eager


@pytest.mark.parametrize("noise", ["injected", "generator"])
def test_train_epoch_graphs_equal_eager_steps(gen, cudnn_deterministic,
                                              noise):
    """The toy conv model's graph steps equal its eager steps; both go
    through the Cholesky kernels and the fused ops."""
    chol, fused = _graphs_against_eager(gen, noise)
    assert chol and {k[0] for k in fused} >= {
        "heads_cat_fwd_cuda", "heads_cat_bwd_cuda", "heads_real_fwd_cuda",
        "heads_real_bwd_cuda", "rep_image_fwd_cuda", "rep_image_bwd_cuda",
        "recon_metric_cuda"}


def test_graphs_equal_eager_steps_without_pallas_chol(gen,
                                                      cudnn_deterministic):
    """--use_pallas_chol=False: the library's Cholesky captured in the
    graphs, no Cholesky kernel launched."""
    chol, _ = _graphs_against_eager(gen, "generator", use_pallas_chol=False)
    assert not chol


def test_mlp_graphs_equal_eager_steps(gen, cudnn_deterministic):
    """The MLP model (--conv_hivae=False): its heads (the real head
    de-normalized by the batch's moments), its metric and its GP go
    through the fused kernels; it has no representation image."""
    chol, fused = _graphs_against_eager(gen, "generator", conv=False)
    names = {k[0] for k in fused}
    assert chol and names == {
        "heads_cat_fwd_cuda", "heads_cat_bwd_cuda", "heads_real_fwd_cuda",
        "heads_real_bwd_cuda", "recon_metric_cuda", "gp_kernel_fwd_cuda",
        "gp_kernel_bwd_cuda"}


def test_long_sequence_graphs_equal_eager_steps(gen, cudnn_deterministic):
    """T = 200 (4 subjects, 2 a batch): the B blocks [8, 2, 200, 200] go
    through the blocked composition on the mid kernel, captured."""
    import numpy as np

    from hlax_torch.data.dataset import LongitudinalDataset
    from hlax_torch.data.reader import encode_raw

    rng = np.random.default_rng(0)
    T, P = 200, 4
    n = T * P
    types = ([{"type": "real", "dim": 1, "nclass": 1}] * 324
             + [{"type": "cat", "dim": 1, "nclass": 5}] * 972)
    raw = np.column_stack([rng.random((n, 324)) * 255,
                           rng.integers(0, 5, (n, 972)).astype(float)])
    het = encode_raw(raw, types,
                     miss_mask=(rng.random((n, 1296)) > 0.25).astype(float))
    labels = np.zeros((n, 6))
    labels[:, 0] = np.tile(np.arange(T), P)
    labels[:, 1] = np.repeat(rng.integers(-9, 11, P), T)
    labels[:, 2] = np.repeat(np.arange(P), T)
    labels[:, 3] = np.repeat(rng.integers(0, 2, P), T)
    labels[:, 4] = np.repeat(rng.integers(0, 2, P), T)
    data = LongitudinalDataset(het=het, labels=labels, id_covariate=2,
                               conv=True)
    chol, _ = _graphs_against_eager(gen, "generator", data=data)
    assert any(k[1][-1] == 100 for k in chol)


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
    cfg = HLVAEConfig(layout=data.layout, z_dim=8, h_dims=(50,),
                      precision="highest")
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


# ---- the fused ops of the train step (hlax_torch.ops.fusion) ----------------

# the canonical batch (20 subjects x 20) and an odd, ragged one
FUSION_ROWS = [400, 37]


def _fusion_case(rows, dtype, gen):
    """A D4 conv model (z 8, hidden 16) in ``dtype`` with its head
    parameters and log_vy drawn away from their inits, and ``rows`` rows of
    D4 data (25 % missing) with decoder features y [rows, 1296, 5]."""
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig

    data = _toy_d4(n_3=10 + (rows > 400), n_6=10)
    model = HLVAE(HLVAEConfig(layout=data.layout, z_dim=8, h_dims=(16,)),
                  torch.Generator("cuda").manual_seed(0), "cuda").to(dtype)
    with torch.no_grad():
        for p in list(model.obs.values()) + list(model.rep_w.values()) \
                + list(model.rep_b.values()) + [model.log_vy_real]:
            p.add_(torch.randn(p.shape, generator=gen, device="cuda",
                               dtype=dtype) * 0.5)
    t = lambda a: torch.as_tensor(a[:rows], dtype=dtype, device="cuda")
    het = data.het
    y = torch.randn((rows, het.layout.n_raw, 5), generator=gen,
                    device="cuda", dtype=dtype)
    return model, y, t(het.data), t(het.mask), t(het.theta_mask)


def _hold(name, got, plain, ref=None):
    """float64: the kernel's result against its plain version's; float32:
    the kernel's error against ``ref`` (the plain version in float64 on the
    same inputs) within 4x the plain version's own plus 1e-6 of the
    largest entry."""
    scale = ref.abs().max().item() if ref is not None else \
        plain.abs().max().item()
    if ref is None:
        torch.testing.assert_close(got, plain, rtol=1e-10,
                                   atol=1e-12 * max(scale, 1e-30), msg=name)
        return
    err = (got.double() - ref).abs().max().item()
    err_plain = (plain.double() - ref).abs().max().item()
    assert err <= 4 * err_plain + 1e-6 * scale, (name, err, err_plain)


def _heads_grads(model, out, cot):
    lp, lpm = out[0], out[1]
    if cot == "row sums":      # the train step's -sum(lp, dim=1).sum()
        loss = -lp.sum(dim=1).sum()
    else:
        g = torch.Generator("cuda").manual_seed(5)
        w1, w2 = (torch.randn(lp.shape, generator=g, device="cuda",
                              dtype=lp.dtype) for _ in range(2))
        loss = (lp * w1).sum() + (lpm * w2).sum()
    params = list(model.obs.values()) + [model.log_vy_real]
    return torch.autograd.grad(loss, params + [out[-1]], allow_unused=True)


def _heads_run(model, y, data, mask, tmask, plain, cot):
    from hlax_torch.ops import fusion
    from hlax_torch.ops.normalization import NormParams

    y = y.detach().clone().requires_grad_(True)
    fn = fusion.heads_loglik_plain if plain else fusion.heads_loglik
    lp, lpm, params, theta = fn(model, y, tmask, data, mask,
                                NormParams(None, None, None, None))
    grads = _heads_grads(model, (lp, lpm, y), cot)
    flat = [lp, lpm, theta, params[0], params[1][0], params[1][1]]
    return [t.detach() for t in flat], [g for g in grads if g is not None]


@pytest.mark.parametrize("cot", ["row sums", "random"])
@pytest.mark.parametrize("rows", FUSION_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_heads_against_plain_version(gen, dtype, rows, cot):
    """The heads, routing and likelihoods kernels (forward: lp, lpm,
    theta, log_pi, the real means and variances; backward: y, every head
    weight and bias, log_vy) against the plain version, float64 to 1e-10,
    float32 within 4x the plain version's own error against float64."""
    from hlax_torch.ops import fusion

    model, y, data, mask, tmask = _fusion_case(rows, dtype, gen)
    before = dict(fusion.LAUNCHES)
    outs, grads = _heads_run(model, y, data, mask, tmask, False, cot)
    torch.cuda.synchronize()
    assert all(fusion.LAUNCHES[k] == before[k] + 1 for k in (
        "heads_cat_fwd_cuda", "heads_cat_bwd_cuda", "heads_real_fwd_cuda",
        "heads_real_bwd_cuda"))
    p_outs, p_grads = _heads_run(model, y, data, mask, tmask, True, cot)
    assert len(grads) == len(p_grads)
    if dtype == torch.float64:
        for i, (a, b) in enumerate(zip(outs + grads, p_outs + p_grads)):
            _hold(f"output {i}", a, b)
        return
    m64 = _fusion_case(rows, torch.float64, gen)[0]
    m64.load_state_dict({k: v.double() for k, v in
                         model.state_dict().items()})
    r_outs, r_grads = _heads_run(m64, y.double(), data.double(),
                                 mask.double(), tmask.double(), True, cot)
    for i, (a, b, r) in enumerate(zip(outs + grads, p_outs + p_grads,
                                      r_outs + r_grads)):
        _hold(f"output {i}", a, b, r)


@pytest.mark.parametrize("rows", FUSION_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_rep_image_against_plain_version(gen, dtype, rows):
    """The encoder's input image (normalization, one-hot representation,
    pixel order) and its backward to the representation's weights, against
    the plain version."""
    from hlax_torch.ops import fusion

    model, _, data, mask, _ = _fusion_case(rows, dtype, gen)
    params = list(model.rep_w.values()) + list(model.rep_b.values())
    g = torch.randn((rows, 1, 36, 36), generator=gen, device="cuda",
                    dtype=dtype)

    def run(m, fn, d, mk, gg):
        img = fn(m, d, mk)
        ps = list(m.rep_w.values()) + list(m.rep_b.values())
        return [img.detach()] + list(torch.autograd.grad((img * gg).sum(),
                                                         ps))

    got = run(model, fusion.rep_image, data, mask, g)
    assert fusion.LAUNCHES["rep_image_fwd_cuda"] and \
        fusion.LAUNCHES["rep_image_bwd_cuda"]
    plain = run(model, fusion.rep_image_plain, data, mask, g)
    assert len(params) == 2
    if dtype == torch.float64:
        for i, (a, b) in enumerate(zip(got, plain)):
            _hold(f"output {i}", a, b)
        return
    m64 = _fusion_case(rows, torch.float64, gen)[0]
    m64.load_state_dict({k: v.double() for k, v in
                         model.state_dict().items()})
    ref = run(m64, fusion.rep_image_plain, data.double(), mask.double(),
              g.double())
    for i, (a, b, r) in enumerate(zip(got, plain, ref)):
        _hold(f"output {i}", a, b, r)


@pytest.mark.parametrize("rows", FUSION_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_recon_metric_against_plain_version(gen, dtype, rows):
    """The recon and missing-imputation errors from the heads' parameters,
    with the last rows padding (row_valid 0), against the plain version,
    for either surviving type."""
    from hlax_torch.ops import fusion
    from hlax_torch.ops.normalization import NormParams

    model, y, data, mask, tmask = _fusion_case(rows, dtype, gen)
    with torch.no_grad():
        params = fusion.heads_loglik_plain(
            model, y, tmask, data, mask, NormParams(None, None, None,
                                                    None))[2]
    rv = torch.ones(rows, dtype=dtype, device="cuda")
    rv[-(rows // 5):] = 0.0
    lay = model.cfg.layout
    for last in ("cat", "real"):
        before = dict(fusion.LAUNCHES)
        got = fusion.recon_metric(lay, True, params, data, mask, rv, last)
        # one launch over both groups, the finish in it
        assert fusion.LAUNCHES["recon_metric_cuda"] == \
            before["recon_metric_cuda"] + 1
        assert fusion.LAUNCHES["recon_metric_finish_cuda"] == \
            before["recon_metric_finish_cuda"]
        plain = fusion.recon_metric_plain(lay, True, params, data, mask, rv,
                                          last)
        if dtype == torch.float64:
            for a, b in zip(got, plain):
                _hold(f"recon {last}", a, b)
            continue
        p64 = [params[0].double(), tuple(t.double() for t in params[1])]
        ref = fusion.recon_metric_plain(lay, True, p64, data.double(),
                                        mask.double(), rv.double(), last)
        for a, b, r in zip(got, plain, ref):
            _hold(f"recon {last}", a, b, r)


def test_fused_ops_refuse_nothing_silently(gen):
    """bfloat16 takes the plain versions on the card and is counted; a
    kernel that is handed it is never launched."""
    from hlax_torch.ops import fusion
    from hlax_torch.ops.normalization import NormParams

    model, y, data, mask, tmask = _fusion_case(37, torch.float32, gen)
    fusion.reset_counters()
    model16 = model.to(torch.bfloat16)
    fusion.heads_loglik(model16, y.bfloat16(), tmask.bfloat16(),
                        data.bfloat16(), mask.bfloat16(),
                        NormParams(None, None, None, None))
    assert fusion.PLAIN_CUDA_CALLS["heads_loglik_plain"] == 1
    assert not any(fusion.LAUNCHES.values())


def _gp_case(L, S, T, M, dtype, gen):
    """The canonical kernel structure's parameters drawn away from their
    inits, padded covariates x [S, T, 6] (the last subject ragged),
    inducing points z [L, M, 6] and the valid mask."""
    from hlax_torch.gp import kernels as gk

    spec0, spec1 = gk.build_kernel_specs(
        [2], [], [0], [{"cont_covariate": 0, "cat_covariate": 2},
                       {"cont_covariate": 0, "cat_covariate": 3},
                       {"cont_covariate": 1, "cat_covariate": 4}], [], [], 2)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda",
                                     dtype=torch.float64)
    params = [[{k: (v + 0.3 * rnd(*v.shape)).to(dtype) for k, v in p.items()}
               for p in gk.init_kernel_params(sp, L, torch.float64, "cuda")]
              for sp in (spec0, spec1)]
    x = torch.zeros((S, T, 6), device="cuda", dtype=torch.float64)
    x[:, :, 0] = torch.arange(T, device="cuda")
    x[:, :, 1] = torch.randint(-9, 11, (S, 1), generator=gen, device="cuda")
    x[:, :, 2] = torch.arange(S, device="cuda")[:, None]
    x[:, :, 3:5] = torch.randint(0, 2, (S, 1, 2), generator=gen,
                                 device="cuda")
    valid = torch.ones((S, T), device="cuda", dtype=torch.float64)
    valid[-1, T // 2:] = 0.0
    x = x * valid[:, :, None]
    rows = x.reshape(-1, 6)[valid.reshape(-1) > 0]
    pick = torch.randint(0, len(rows), (L, M), generator=gen, device="cuda")
    z = rows[pick] + torch.cat([0.5 * rnd(L, M, 2),
                                torch.zeros((L, M, 4), device="cuda",
                                            dtype=torch.float64)], dim=-1)
    return (spec0, spec1), params, x.to(dtype), z.to(dtype), valid.to(dtype)


def _gp_cotangent(shape, dtype):
    return torch.randn(shape, generator=torch.Generator("cuda").manual_seed(
        9), device="cuda", dtype=torch.float64).to(dtype)


def _gp_run(fn, case, which, w=None):
    """The bound's matrix ``which`` and its gradients to the raw parameters
    and (K0xz, K0zz) to z, under the cotangent ``w`` (a seeded normal)."""
    (spec0, spec1), params, x, z, valid = case
    params = [[{k: v.detach().clone().requires_grad_(True)
                for k, v in p.items()} for p in ps] for ps in params]
    z = z.detach().clone().requires_grad_(True)
    if which == "K0xz":
        out = fn(spec0, params[0], x, z, x2_batched=True, row_mask=valid)
    elif which == "K0zz":
        out = fn(spec0, params[0], z, z, x1_batched=True, x2_batched=True)
    else:
        spec, ps = (spec1, params[1]) if which == "K1_st" else \
            (spec0, params[0])
        out = fn(spec, ps, x, x, row_mask=valid, col_mask=valid)
    w = _gp_cotangent(out.shape, out.dtype) if w is None else w
    leaves = [v for p in params[1 if which == "K1_st" else 0]
              for v in p.values()]
    inputs = leaves + ([z] if which in ("K0xz", "K0zz") else [])
    grads = torch.autograd.grad((out * w).sum(), inputs)
    return [out.detach()] + list(grads)


GP_WHICH = ["K0xz", "K0zz", "K1_st", "K0_st"]


# [L, S, T, M]: the canonical shape (N2 = 120 and 20: 16-byte vectors), a
# ragged one (M = 37, T = 13: neither takes them) and T = 37 with M = 20
# (N2 below a warp's 32 lanes for K0xz and K0zz, N2 = 37 for the subject
# blocks)
@pytest.mark.parametrize("which", GP_WHICH)
@pytest.mark.parametrize("shape", [(32, 20, 20, 120), (3, 7, 13, 37),
                                   (4, 6, 37, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_gp_kernel_matrix_against_plain_version(gen, dtype, shape,
                                                      which):
    """The GP kernel matrix with its masks (the bound's K0xz, K0zz, K1_st
    and K0_st) and its gradients to the raw outputscales and lengthscales
    and to z, at the canonical [L, S, T, M] and ragged shapes, against the
    plain version."""
    from hlax_torch.ops import fusion

    case = _gp_case(*shape, dtype, gen)
    before = dict(fusion.LAUNCHES)
    got = _gp_run(fusion.gp_kernel_matrix, case, which)
    torch.cuda.synchronize()
    assert fusion.LAUNCHES["gp_kernel_fwd_cuda"] == \
        before["gp_kernel_fwd_cuda"] + 1
    assert fusion.LAUNCHES["gp_kernel_bwd_cuda"] == \
        before["gp_kernel_bwd_cuda"] + 1
    plain = _gp_run(fusion.gp_kernel_matrix_plain, case, which)
    if dtype == torch.float64:
        for i, (a, b) in enumerate(zip(got, plain)):
            _hold(f"{which} output {i}", a, b)
        return
    case64 = tuple(c if i == 0 else
                   ([[{k: v.double() for k, v in p.items()} for p in ps]
                     for ps in c] if i == 1 else c.double())
                   for i, c in enumerate(case))
    ref = _gp_run(fusion.gp_kernel_matrix_plain, case64, which)
    for i, (a, b, r) in enumerate(zip(got, plain, ref)):
        _hold(f"{which} output {i}", a, b, r)


@pytest.mark.parametrize("which", GP_WHICH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_gp_kernel_matrix_graph_replays_eager_call(gen, dtype, which):
    """Forward and backward of each of the bound's GP matrices at the
    canonical shape, captured in a CUDA graph and replayed twice: equal to
    the eager call bit for bit (the backward's sums in a fixed order, its
    counters zero again after every launch)."""
    from hlax_torch.ops import fusion

    case = _gp_case(32, 20, 20, 120, dtype, gen)
    eager = _gp_run(fusion.gp_kernel_matrix, case, which)
    w = _gp_cotangent(eager[0].shape, dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _gp_run(fusion.gp_kernel_matrix, case, which, w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _gp_run(fusion.gp_kernel_matrix, case, which, w)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(captured, eager)):
            assert torch.equal(a, b), (which, i,
                                       (a - b).abs().max().item())


# ---- the fused ops beyond the canonical sizes --------------------------------

def _layout_case(types, rows, conv, y_dim, logvar, seed):
    """A float64 model on the layout ``types`` (heads and log_vy drawn
    away from their inits) and ``rows`` rows of its data (25 % missing)
    with decoder features y [rows, n_raw, y_dim]."""
    import numpy as np

    from hlax_torch.data.reader import encode_raw
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig

    rng = np.random.default_rng(seed)
    raw = np.column_stack([rng.integers(0, t["nclass"], rows).astype(float)
                           if t["type"] == "cat" else rng.random(rows) * 255
                           for t in types])
    miss = (rng.random(raw.shape) > 0.25).astype(float)
    het = encode_raw(raw, types, miss_mask=miss, logvar_network=logvar)
    g = torch.Generator("cuda").manual_seed(seed)
    model = HLVAE(HLVAEConfig(layout=het.layout, z_dim=4, h_dims=(8,),
                              y_dim=y_dim, conv=conv,
                              logvar_network=logvar), g, "cuda").double()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g, device="cuda",
                               dtype=p.dtype) * 0.5)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                  device="cuda")
    y = torch.randn((rows, het.layout.n_raw, y_dim), generator=g,
                    device="cuda", dtype=torch.float64)
    return model, y, t(het.data), t(het.mask), t(het.theta_mask)


def _cat(n, c):
    return [{"type": "cat", "dim": 1, "nclass": c}] * n


def _real(n):
    return [{"type": "real", "dim": 1, "nclass": 1}] * n


def _mixed(n_raw, seed):
    """cat(3), cat(7) and real variables, interleaved."""
    import numpy as np

    k = n_raw // 3
    types = _cat(k, 3) + _real(n_raw - 2 * k) + _cat(k, 7)
    return [types[i] for i in np.random.default_rng(seed).permutation(
        len(types))]


def _moments(model, data, mask):
    from hlax_torch.ops.normalization import NormParams, batch_normalization

    if model.cfg.conv:
        return NormParams(None, None, None, None)
    return batch_normalization(data, mask, model.cfg.layout, False)[1]


@pytest.mark.parametrize("logvar", [False, True])
@pytest.mark.parametrize("y_dim", [5, 3])
@pytest.mark.parametrize("conv", [True, False])
def test_fused_heads_take_any_layout(gen, conv, y_dim, logvar):
    """The heads kernels on cat groups of 3 and 7 classes beside the real
    group, at y_dim 5 (compiled) and 3 (at run time), with and without the
    logvar network, in the conv and the MLP model (the real head
    de-normalized by the batch's moments): float64 against the plain
    version to 1e-10, a launch a group each way."""
    from hlax_torch.ops import fusion

    n_raw = 1296 if conv else 97
    model, y, data, mask, tmask = _layout_case(_mixed(n_raw, 1), 37, conv,
                                               y_dim, logvar, 4)
    norm = _moments(model, data, mask)
    params = list(model.parameters())
    res = []
    for fn in (fusion.heads_loglik, fusion.heads_loglik_plain):
        before = dict(fusion.LAUNCHES)
        yy = y.clone().requires_grad_(True)
        lp, lpm, par, theta = fn(model, yy, tmask, data, mask, norm)
        w = torch.randn(lp.shape, generator=torch.Generator(
            "cuda").manual_seed(5), device="cuda", dtype=lp.dtype)
        grads = torch.autograd.grad((lp * w).sum() + (lpm * w).sum()
                                    - lp.sum(dim=1).sum(), [yy] + params,
                                    allow_unused=True)
        outs = [lp, lpm, theta] + [t for p in par for t in (
            p if isinstance(p, tuple) else (p,))]
        res.append((outs, grads))
        if fn is fusion.heads_loglik:
            for k, n in (("heads_cat_fwd_cuda", 2), ("heads_cat_bwd_cuda", 2),
                         ("heads_real_fwd_cuda", 1),
                         ("heads_real_bwd_cuda", 1)):
                assert fusion.LAUNCHES[k] == before[k] + n, k
    (o, g), (po, pg) = res
    for i, (a, b) in enumerate(zip(o, po)):
        _hold(f"output {i}", a.detach(), b.detach())
    for i, (a, b) in enumerate(zip(g, pg)):
        assert (a is None) == (b is None), i
        if a is not None:
            _hold(f"gradient {i}", a, b)


# the staged real head's cases: (cat variables before the real group, real
# variables, rows, SMs the plans see, conv).  37 cat variables put the real
# group's first column off a 16-byte boundary and 45 (1259) real ones leave
# a ragged last tile; one SM makes the plans one chunk, a cluster of one
# (the conv model on a 36 x 36 image); 5 rows leave most warps of a block
# without a row; 40 and 64 are aligned whole tiles in clusters of the
# plan's 8 chunks
REAL_CASES = [(37, 45, 61, None, False), (37, 1259, 61, 1, True),
              (40, 64, 5, None, False), (40, 64, 400, None, False)]


@pytest.mark.parametrize("cot", ["row sums", "random"])
@pytest.mark.parametrize("logvar", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", REAL_CASES)
def test_staged_real_heads_against_plain_version(gen, monkeypatch, case,
                                                 dtype, logvar, cot):
    """The real head's staged forward and cluster-finished backward (y_dim
    5) on a group off a 16-byte boundary with a ragged last tile, in one
    chunk, on fewer rows than a block's warps and on aligned whole tiles,
    with and without the logvar network (the MLP's batch moments; the conv
    model's sigmoid): one launch each way, the plan's chunks; float64
    against the plain version to 1e-10, float32 within 4x the plain
    version's own error against float64."""
    from hlax_torch.ops import fusion

    n_cat, n_real, rows, sms, conv = case
    if sms is not None:
        monkeypatch.setattr(fusion, "_sm_count", lambda index: sms)
    m64, y64, d64, k64, t64 = _layout_case(_cat(n_cat, 5) + _real(n_real),
                                           rows, conv, 5, logvar, 7)
    plan = fusion.heads_real_bwd_plan(rows, n_real, 5, logvar,
                                      dtype.itemsize, fusion._sm_count(0))
    assert plan.cluster == (1 if sms == 1 else min(8, -(-rows // 8)))

    def run(model, y, data, mask, tmask, fn):
        norm = _moments(model, data, mask)
        yy = y.detach().clone().requires_grad_(True)
        lp, lpm, par, theta = fn(model, yy, tmask, data, mask, norm)
        if cot == "row sums":
            loss = -lp.sum(dim=1).sum()
        else:
            w = torch.randn(lp.shape, generator=torch.Generator(
                "cuda").manual_seed(5), device="cuda", dtype=torch.float64)
            loss = (lp * w.to(lp.dtype)).sum() + (lpm * w.to(lp.dtype)).sum()
        ps = [yy] + list(model.obs.values()) + (
            [] if logvar else [model.log_vy_real])
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
        outs = [lp, lpm, theta] + list(par[-1])
        return [t.detach() for t in outs] + [g for g in grads
                                             if g is not None]

    import copy
    model = copy.deepcopy(m64).to(dtype)
    args = [t.to(dtype) for t in (y64, d64, k64, t64)]
    before = dict(fusion.LAUNCHES)
    got = run(model, *args, fusion.heads_loglik)
    torch.cuda.synchronize()
    for k in ("heads_real_fwd_cuda", "heads_real_bwd_cuda"):
        assert fusion.LAUNCHES[k] == before[k] + 1, k
    plain = run(model, *args, fusion.heads_loglik_plain)
    assert len(got) == len(plain)
    ref = run(m64, y64, d64, k64, t64, fusion.heads_loglik_plain) \
        if dtype == torch.float32 else [None] * len(got)
    for i, (a, b, r) in enumerate(zip(got, plain, ref)):
        _hold(f"result {i}", a, b, r)


def test_fused_rep_image_takes_any_layout(gen):
    """The representation kernels on cat groups of 3 and 7 classes beside
    the real group: float64 against the plain version to 1e-10."""
    from hlax_torch.ops import fusion

    model, _, data, mask, _ = _layout_case(_mixed(1296, 2), 37, True, 5,
                                           False, 6)
    params = list(model.rep_w.values()) + list(model.rep_b.values())
    g = torch.randn((37, 1, 36, 36), generator=gen, device="cuda",
                    dtype=torch.float64)
    res = []
    for fn in (fusion.rep_image, fusion.rep_image_plain):
        img = fn(model, data, mask)
        res.append([img.detach()] + list(torch.autograd.grad(
            (img * g).sum(), params)))
    assert len(params) == 4
    for i, (a, b) in enumerate(zip(*res)):
        _hold(f"output {i}", a, b)


class _OneRankSums:
    """``MeshSums`` of a mesh of one rank: the metric's mesh path."""

    def subjects(self, x):
        return x.clone()

    def subjects_max(self, x):
        return x.clone()


@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("conv", [True, False])
def test_fused_recon_metric_takes_any_layout(gen, conv, mesh):
    """The recon metric's kernels on cat groups of 3 and 7 classes beside
    the real group, in the conv and the MLP model (its real error
    normalized by the valid rows' range), alone and on the mesh path (the
    column sums handed to the mesh's sums between the passes), the last
    rows padding: float64 against the plain version to 1e-10."""
    from hlax_torch.ops import fusion

    n_raw = 1296 if conv else 97
    model, y, data, mask, tmask = _layout_case(_mixed(n_raw, 3), 37, conv,
                                               3, False, 8)
    with torch.no_grad():
        params = fusion.heads_loglik_plain(model, y, tmask, data, mask,
                                           _moments(model, data, mask))[2]
    rv = torch.ones(37, dtype=torch.float64, device="cuda")
    rv[-7:] = 0.0
    sums = _OneRankSums() if mesh else None
    lay = model.cfg.layout
    for last in ("cat", "real"):
        before = dict(fusion.LAUNCHES)
        got = fusion.recon_metric(lay, conv, params, data, mask, rv, last,
                                  sums)
        # one launch; on the mesh path the column sums, then the finish
        assert fusion.LAUNCHES["recon_metric_cuda"] == \
            before["recon_metric_cuda"] + 1
        assert fusion.LAUNCHES["recon_metric_finish_cuda"] == \
            before["recon_metric_finish_cuda"] + int(mesh)
        want = fusion.recon_metric_plain(lay, conv, params, data, mask, rv,
                                         last, sums)
        for a, b in zip(got, want):
            _hold(f"recon {last}", a, b)


# ---- the staged kernels: heads_cat_fwd, heads_cat_bwd and rep_image_bwd at
# the compiled sizes, the metric

# the canonical batch, one row (one chunk), one row past it (a short last
# chunk)
STAGED_ROWS = [400, 1, 401]


def _padded_rows(rows, dtype):
    rv = torch.ones(rows, dtype=dtype, device="cuda")
    if rows > 1:
        rv[-max(rows // 5, 1):] = 0.0
    return rv


def _metric_params(model, y, data, mask, tmask):
    from hlax_torch.ops import fusion

    with torch.no_grad():
        return fusion.heads_loglik_plain(model, y, tmask, data, mask,
                                         _moments(model, data, mask))[2]


def _in_float64(params):
    return [tuple(t.double() for t in p) if isinstance(p, tuple)
            else p.double() for p in params]


@pytest.mark.parametrize("rows", STAGED_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_staged_reductions_against_plain_version(gen, dtype, rows):
    """The cat head's forward and backward at the compiled sizes (lp, lpm,
    theta, log_pi; dy and every head weight's gradient, under the row-sum
    and a random cotangent), the one-launch metric (the last rows padding,
    either surviving type) and the representation's backward at the
    canonical layout over 400, 1 and 401 rows: float64 to 1e-10, float32
    within 4x the plain version's own error against float64; one launch of
    each, no finish."""
    from hlax_torch.ops import fusion

    model, y, data, mask, tmask = _fusion_case(rows, dtype, gen)
    m64 = None
    if dtype == torch.float32:
        m64 = _fusion_case(rows, torch.float64, gen)[0]
        m64.load_state_dict({k: v.double() for k, v in
                             model.state_dict().items()})
    for cot in ("row sums", "random"):
        before = dict(fusion.LAUNCHES)
        outs, grads = _heads_run(model, y, data, mask, tmask, False, cot)
        assert fusion.LAUNCHES["heads_cat_bwd_cuda"] == \
            before["heads_cat_bwd_cuda"] + 1
        assert fusion.LAUNCHES["heads_cat_fwd_cuda"] == \
            before["heads_cat_fwd_cuda"] + 1
        p_outs, p_grads = _heads_run(model, y, data, mask, tmask, True, cot)
        r_outs, r_grads = ([None] * len(outs), [None] * len(grads)) \
            if m64 is None else _heads_run(
                m64, y.double(), data.double(), mask.double(),
                tmask.double(), True, cot)
        for i, (a, b, r) in enumerate(zip(outs, p_outs, r_outs)):
            _hold(f"{cot} output {i}", a, b, r)
        for i, (a, b, r) in enumerate(zip(grads, p_grads, r_grads)):
            _hold(f"{cot} gradient {i}", a, b, r)
    params = _metric_params(model, y, data, mask, tmask)
    rv = _padded_rows(rows, dtype)
    lay = model.cfg.layout
    for last in ("cat", "real"):
        before = dict(fusion.LAUNCHES)
        got = fusion.recon_metric(lay, True, params, data, mask, rv, last)
        assert fusion.LAUNCHES["recon_metric_cuda"] == \
            before["recon_metric_cuda"] + 1
        assert fusion.LAUNCHES["recon_metric_finish_cuda"] == \
            before["recon_metric_finish_cuda"]
        plain = fusion.recon_metric_plain(lay, True, params, data, mask, rv,
                                          last)
        ref = [None, None] if m64 is None else fusion.recon_metric_plain(
            lay, True, _in_float64(params), data.double(), mask.double(),
            rv.double(), last)
        for a, b, r in zip(got, plain, ref):
            _hold(f"recon {last}", a, b, r)
    g = torch.randn((rows, 1, 36, 36), generator=gen, device="cuda",
                    dtype=dtype)

    def rep(m, fn, d, mk):
        img = fn(m, d, mk)
        ps = list(m.rep_w.values()) + list(m.rep_b.values())
        return list(torch.autograd.grad((img * g.to(img.dtype)).sum(), ps))

    before = dict(fusion.LAUNCHES)
    got = rep(model, fusion.rep_image, data, mask)
    assert fusion.LAUNCHES["rep_image_bwd_cuda"] == \
        before["rep_image_bwd_cuda"] + 1
    plain = rep(model, fusion.rep_image_plain, data, mask)
    ref = [None] * len(got) if m64 is None else rep(
        m64, fusion.rep_image_plain, data.double(), mask.double())
    for i, (a, b, r) in enumerate(zip(got, plain, ref)):
        _hold(f"representation gradient {i}", a, b, r)


@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_staged_reductions_at_run_time_sizes(gen, dtype, mesh):
    """y_dim 3 (the cat head's run-time backward) over cat groups of 3 and
    7 classes beside the real group, and the metric's cat groups at run
    time in the MLP model, alone and on the mesh path (the column sums,
    then the finish): float64 to 1e-10, float32 within 4x the plain
    version's own error against float64."""
    import copy

    from hlax_torch.ops import fusion

    m64, y64, d64, k64, t64 = _layout_case(_mixed(97, 3), 37, False, 3,
                                           False, 8)
    model = m64 if dtype == torch.float64 else copy.deepcopy(m64).to(dtype)
    y, data, mask, tmask = (t.to(dtype) for t in (y64, d64, k64, t64))
    ref64 = dtype == torch.float32
    res = {}
    for who, m, args in (("kernel", model, (y, data, mask, tmask)),
                         ("plain", model, (y, data, mask, tmask)),
                         ("ref", m64, (y64, d64, k64, t64))):
        if who == "ref" and not ref64:
            continue
        fn = fusion.heads_loglik if who == "kernel" else \
            fusion.heads_loglik_plain
        yy = args[0].clone().requires_grad_(True)
        lp = fn(m, yy, args[3], args[1], args[2],
                _moments(m, args[1], args[2]))[0]
        w = torch.randn(lp.shape, generator=torch.Generator(
            "cuda").manual_seed(5), device="cuda", dtype=torch.float64)
        res[who] = list(torch.autograd.grad((lp * w.to(lp.dtype)).sum(),
                                            [yy] + list(m.obs.values()),
                                            allow_unused=True))
    for i, (a, b) in enumerate(zip(res["kernel"], res["plain"])):
        if a is not None:
            _hold(f"gradient {i}", a, b,
                  res["ref"][i] if ref64 else None)
    sums = _OneRankSums() if mesh else None
    rv = _padded_rows(37, dtype)
    params = _metric_params(model, y, data, mask, tmask)
    lay = model.cfg.layout
    before = dict(fusion.LAUNCHES)
    got = fusion.recon_metric(lay, False, params, data, mask, rv, "real",
                              sums)
    assert fusion.LAUNCHES["recon_metric_finish_cuda"] == \
        before["recon_metric_finish_cuda"] + int(mesh)
    plain = fusion.recon_metric_plain(lay, False, params, data, mask, rv,
                                      "real", sums)
    ref = [None, None]
    if ref64:
        ref = fusion.recon_metric_plain(
            lay, False, _metric_params(m64, y64, d64, k64, t64), d64, k64,
            rv.double(), "real", sums)
    for a, b, r in zip(got, plain, ref):
        _hold("recon", a, b, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_staged_reductions_replay_bit_for_bit(gen, dtype):
    """The cat and the real head's forward and backward (the real
    backward's clusters captured as any launch), the representation's
    backward and the one-launch metric at the canonical shape: two eager
    calls and two replays of a CUDA graph of a third, all equal to the bit
    (the sums in a fixed order; the counters zero again after every
    launch, none filled)."""
    from hlax_torch.ops import fusion
    from hlax_torch.ops.normalization import NormParams

    model, y, data, mask, tmask = _fusion_case(400, dtype, gen)
    params = _metric_params(model, y, data, mask, tmask)
    rv = _padded_rows(400, dtype)
    g = torch.Generator("cuda").manual_seed(5)
    w1, w2 = (torch.randn((400, 1296), generator=g, device="cuda",
                          dtype=dtype) for _ in range(2))
    obs = list(model.obs.values())
    reps = list(model.rep_w.values()) + list(model.rep_b.values())
    w3 = torch.randn((400, 1, 36, 36), generator=g, device="cuda",
                     dtype=dtype)

    def run():
        yy = y.detach().requires_grad_(True)
        lp, lpm, _, theta = fusion.heads_loglik(
            model, yy, tmask, data, mask, NormParams(None, None, None, None))
        grads = torch.autograd.grad([lp, lpm], [yy] + obs, [w1, w2],
                                    allow_unused=True)
        rec = fusion.recon_metric(model.cfg.layout, True, params, data, mask,
                                  rv, "cat")
        img = fusion.rep_image(model, data, mask)
        g_rep = torch.autograd.grad(img, reps, w3)
        return ([lp.detach(), lpm.detach(), theta]
                + [t for t in grads if t is not None] + list(rec)
                + list(g_rep))

    first, second = run(), run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for replay in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for i, (a, b, c) in enumerate(zip(first, second, captured)):
            assert torch.equal(a, b) and torch.equal(a, c), (
                replay, i, (a - c).abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_metric_argmax_takes_nan_and_ties_as_the_plain_version(gen, dtype):
    """log_pi with tied classes (the first wins), one NaN (largest) or
    several (the first wins) in a cell, and data cells of all zeros or
    ties: the one-launch metric's compiled C = 5 argmax against the plain
    version's torch.argmax; float64 to 1e-10, float32 within 4x the plain
    version's own error against the plain version in float64 on the same
    values (an argmax taken otherwise moves a mean by a whole cell)."""
    from hlax_torch.ops import fusion

    model, y, data, mask, tmask = _fusion_case(400, dtype, gen)
    params = _metric_params(model, y, data, mask, tmask)
    lpi = params[0].clone()                  # the cat group's [400, 972, 5]
    lpi[::3] = lpi[::3, :, :1]               # every class tied
    lpi[1::7, ::5, 2] = float("nan")
    lpi[2::11, ::3, 1] = float("nan")
    lpi[2::11, ::3, 3] = float("nan")
    lpi[4::13, 1::4, 2:] = lpi[4::13, 1::4, 2:3]      # classes 2-4 tied
    data = data.clone()
    cat = data[:, :972 * 5].reshape(400, 972, 5)
    cat[5::9, ::2] = 0.0                     # all zeros: class 0
    cat[6::9, 1::2, 1:3] = 1.0               # classes 1 and 2 tied
    params = [lpi] + list(params[1:])
    rv = _padded_rows(400, dtype)
    lay = model.cfg.layout
    for last in ("cat", "real"):
        got = fusion.recon_metric(lay, True, params, data, mask, rv, last)
        plain = fusion.recon_metric_plain(lay, True, params, data, mask, rv,
                                          last)
        ref = [None, None] if dtype == torch.float64 else \
            fusion.recon_metric_plain(lay, True, _in_float64(params),
                                      data.double(), mask.double(),
                                      rv.double(), last)
        for a, b, r in zip(got, plain, ref):
            _hold(f"recon {last}", a, b, r)


def test_captured_step_fills_no_counters(gen, monkeypatch,
                                         cudnn_deterministic):
    """make_train_epoch's captures of the toy conv model's steps: inside
    the fused ops (the heads and their backward, the representation and
    its backward, the metric, the GP kernel matrices' backward) no fill or
    zero op is captured: their counters come from the stream's buffer,
    which its warm-up steps allocated and zeroed."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from hlax_torch.ops import fusion

    calls = {}
    current = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if current:
                calls[current[-1]][-1].append(str(func))
            return func(*args, **(kwargs or {}))

    def inside(name, fn):
        def wrapped(*a, **k):
            if not torch.cuda.is_current_stream_capturing():
                return fn(*a, **k)
            calls.setdefault(name, []).append([])
            current.append(name)
            try:
                return fn(*a, **k)
            finally:
                current.pop()
        return wrapped

    for name in ("heads_loglik", "rep_image", "recon_metric",
                 "gp_kernel_matrix"):
        monkeypatch.setattr(fusion, name, inside(name,
                                                 getattr(fusion, name)))
    for cls in (fusion._Heads, fusion._RepImage, fusion._GpKernel):
        monkeypatch.setattr(cls, "backward", staticmethod(inside(
            f"{cls.__name__}.backward", cls.backward)))
    with Record():
        _graphs_against_eager(gen, "generator")
    assert {"heads_loglik", "rep_image", "recon_metric", "_Heads.backward",
            "_RepImage.backward", "_GpKernel.backward"} <= set(calls)
    for name, runs in calls.items():
        for ops in runs:
            assert ops, name
            fills = [op for op in ops if "fill" in op or "zero" in op]
            assert not fills, (name, fills)


def _gp_grads(fn, spec, params, x1, x2, kw, wrt):
    params = [{k: v.detach().clone().requires_grad_(True)
               for k, v in p.items()} for p in params]
    a = x1.detach().clone().requires_grad_("x1" in wrt)
    b = a if kw.pop("same", False) else \
        x2.detach().clone().requires_grad_("x2" in wrt)
    out = fn(spec, params, a, b, **kw)
    w = torch.randn(out.shape, generator=torch.Generator("cuda").manual_seed(
        9), device="cuda", dtype=out.dtype)
    ins = [v for p in params for v in p.values()] + [
        t for t, n in ((a, "x1"), (b, "x2"))
        if n in wrt and not (n == "x2" and b is a)]
    return [out.detach()] + list(torch.autograd.grad((out * w).sum(), ins))


@pytest.mark.parametrize("which", ["beyond one launch", "x1 gradient",
                                   "same x, masks differ",
                                   "x2 [L, S, N, Q] gradient",
                                   "x2 [S, N, Q] gradient",
                                   "x2 [N, Q] gradient"])
def test_fused_gp_kernel_matrix_beyond_the_bound(gen, which):
    """The GP kernel matrix where the bound does not take it: a spec of 7
    components (three launches that add up), the gradient to x1 (x2's of
    the transposed matrix), x1 is x2 under different row and column masks,
    and gradients to an x2 batched over the subjects (the batch folded
    into the latents) or not over the latents (summed over them): float64
    against the plain version to 1e-10."""
    from hlax_torch.gp import kernels as gk
    from hlax_torch.ops import fusion

    (spec0, _), params, x, z, valid = _gp_case(3, 5, 7, 11, torch.float64,
                                               gen)
    params = params[0]
    valid2 = torch.ones_like(valid)
    valid2[0, 2:] = 0.0
    spec = spec0
    if which == "beyond one launch":
        spec, _ = gk.build_kernel_specs(
            [3, 4], [3], [0, 1, 5],
            [{"cont_covariate": 0, "cat_covariate": 2},
             {"cont_covariate": 5, "cat_covariate": 3},
             {"cont_covariate": 1, "cat_covariate": 4}],
            [{"cont_covariate": 5, "bin_covariate": 4}],
            [{"covariate": 5, "mask": 4}], 2)
        assert len(fusion._gp_chunks(spec)) > 1
        params = [{k: v + 0.3 * torch.randn(v.shape, generator=gen,
                                            device="cuda",
                                            dtype=torch.float64)
                   for k, v in p.items()}
                  for p in gk.init_kernel_params(spec, 3, torch.float64,
                                                 "cuda")]
        case = (z, z, dict(x1_batched=True, x2_batched=True, same=True),
                ["x1"])
    elif which == "x1 gradient":
        case = (z, x, dict(x1_batched=True, col_mask=valid), ["x1"])
    elif which == "same x, masks differ":
        case = (x, x, dict(row_mask=valid, col_mask=valid2, same=True),
                ["x1"])
    elif which == "x2 [L, S, N, Q] gradient":
        xs = x[None].repeat(3, 1, 1, 1) + 0.1 * torch.randn(
            (3,) + x.shape, generator=gen, device="cuda",
            dtype=torch.float64)
        case = (x, xs, dict(x2_batched=True, row_mask=valid,
                            col_mask=valid2), ["x2"])
    elif which == "x2 [S, N, Q] gradient":
        case = (z, x, dict(x1_batched=True, col_mask=valid2), ["x1", "x2"])
    else:
        case = (x, z[0], dict(row_mask=valid), ["x1", "x2"])
    x1, x2, kw, wrt = case
    before = fusion.LAUNCHES["gp_kernel_bwd_cuda"]
    got = _gp_grads(fusion.gp_kernel_matrix, spec, params, x1, x2, dict(kw),
                    wrt)
    assert fusion.LAUNCHES["gp_kernel_bwd_cuda"] > before
    want = _gp_grads(fusion.gp_kernel_matrix_plain, spec, params, x1, x2,
                     dict(kw), wrt)
    for i, (a, b) in enumerate(zip(got, want)):
        _hold(f"{which} output {i}", a, b)


# ---- hlax's precision split: the VAE in TF32, the GP in full float32 --------

def _tf32_off():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (False, False)


def test_gp_bits_do_not_depend_on_the_precision(gen):
    """On the same VAE outputs and GP state, the bound, its gradients (the
    train step's backward, ``write_grads``) and the natural-gradient update
    give the same bits plainly, inside an ambient TF32 block, and after a
    TF32 forward and backward of the VAE: the GP runs in full float32."""
    from hlax_torch import precision
    from hlax_torch.data import dataset as ds
    from hlax_torch.gp import elbo as gp_elbo
    from hlax_torch.gp import kernels as gk
    from hlax_torch.train import step as tstep

    data, spec0, spec1, cfg, state = _mesh_problem("cuda", torch.float32)
    assert state.vae.cfg.precision == "default"
    staged = ds.stage_dataset(data, torch.float32, "cuda")
    batch = ds.gather_batch(staged, torch.arange(2, device="cuda"))
    out = state.vae(batch["data"], batch["mask"], batch["theta_mask"],
                    generator=gen)
    S, T = batch["valid"].shape
    mu0 = out["mu"].detach().reshape(S, T, -1)
    lv0 = out["log_var"].detach().reshape(S, T, -1)

    def gp(ambient):
        mu, lv = mu0.clone().requires_grad_(), lv0.clone().requires_grad_()
        params = [mu, lv, state.zt] + [v for p in state.k0 + state.k1
                                       for v in p.values()]
        with precision.tf32(ambient):
            kld, gm, gH, iH = gp_elbo.kld_upper_bound(
                spec0, state.k0, spec1, state.k1,
                gk.noise_value(state.raw_noise, True), state.m, state.H,
                state.zt, batch["labels"].reshape(S, T, -1), batch["valid"],
                mu, lv, cfg.P_tot, cfg.N_tot, cfg.eps, natural_gradient=True)
            tstep.write_grads(kld, params)
            with torch.no_grad():
                m, H = gp_elbo.natural_gradient_update(
                    state.m, state.H, gm.detach(), gH.detach(), 0.01,
                    iH=iH.detach())
        return [kld, m, H] + [p.grad for p in params]

    plain = gp(False)
    inside = gp(True)
    (out["log_p_x"].sum() + out["mu"].sum()).backward()   # the VAE in TF32
    after = gp(False)
    assert _tf32_off()
    for a, b, c in zip(plain, inside, after):
        assert torch.equal(a, b) and torch.equal(a, c)


def _rel(u, v):
    return ((u - v).norm() / v.norm()).item()


# the VAE's TF32 operations against full float32, relative to the result's
# norm: TF32 keeps 10 of float32's 23 mantissa bits, so a product is off by
# up to 2^-10 of itself; sums of products from random data come out a few
# such units off in norm.  A float32 result by another summation order is
# ~1e-7 off: above TF32_LOW, TF32 was taken
TF32_LOW, TF32_HIGH = 1e-5, 1e-2


@pytest.mark.parametrize("layer", ["conv2", "deconv1", "dense", "mean"])
def test_vae_layers_take_tf32(gen, layer):
    """The canonical layers' shapes (400 rows): conv2 (16 -> 32 channels at
    18 x 18), deconv1 (32 -> 16, 9 -> 18), the encoder's dense layer (2592
    -> 500) and the mean layer (500 -> 32) through ``hlax_torch.precision``
    against the plain float32 operations: output and gradients within
    TF32_HIGH of their norm, and TF32 taken (above TF32_LOW) by every
    cuBLAS product and by at least one of each convolution's three; TF32
    off afterwards.  TF32 allows cuDNN its TF32 engines; its heuristics
    pick among them and the float32 ones by shape (conv2's forward at this
    shape stays on an FFMA kernel with the card's cuDNN: [precision] in
    chip_smoke.py lists each layer's kernels)."""
    import torch.nn.functional as F

    from hlax_torch import precision

    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    fns = {
        "conv2": ((r(400, 16, 18, 18), r(32, 16, 3, 3) / 12, r(32)),
                  lambda x, w, b: precision.conv2d(x, w, b, padding=1),
                  lambda x, w, b: F.conv2d(x, w, b, padding=1)),
        "deconv1": ((r(400, 32, 9, 9), r(32, 16, 4, 4) / 22, r(16)),
                    lambda x, w, b: precision.conv_transpose2d(
                        x, w, b, stride=2, padding=1),
                    lambda x, w, b: F.conv_transpose2d(x, w, b, stride=2,
                                                       padding=1)),
        "dense": ((r(400, 2592), r(500, 2592) / 51, r(500)),
                  precision.linear, F.linear),
        "mean": ((r(400, 500), r(32, 500) / 22, r(32)), precision.linear,
                 F.linear)}
    args, tf32_fn, plain_fn = fns[layer]
    results = []
    for fn in (tf32_fn, plain_fn):
        xs = [a.clone().requires_grad_() for a in args]
        y = fn(*xs)
        y.backward(torch.ones_like(y) + 0.1 * y.detach())
        results.append([y.detach()] + [x.grad for x in xs[:2]])
    assert _tf32_off()
    rel = {name: _rel(a, b) for name, a, b in zip(
        ("output", "input gradient", "weight gradient"), *results)}
    assert all(v < TF32_HIGH for v in rel.values()), rel
    if layer in ("dense", "mean"):
        assert all(v > TF32_LOW for v in rel.values()), rel
    else:
        assert max(rel.values()) > TF32_LOW, rel


def test_tf32_graph_steps_equal_eager_steps(gen, cudnn_deterministic):
    """The toy conv model under the default precision (TF32 in the VAE),
    float32: ``make_train_epoch``'s graphs (2 steps a graph and the
    remainder's) against the same steps run eagerly, with the noise
    injected: losses, m, H and the VAE's parameters within 1e-5
    (chip_smoke.py's [graph] float32 bar); TF32 off afterwards."""
    import numpy as np

    from hlax_torch.data import dataset as ds
    from hlax_torch.train import step as tstep

    data, spec0, spec1, cfg, a = _mesh_problem("cuda", torch.float32)
    b = _mesh_problem("cuda", torch.float32)[-1]
    assert a.vae.cfg.precision == "default"
    staged = ds.stage_dataset(data, torch.float32, "cuda")
    idx = np.stack(list(ds.epoch_subject_batches(
        data.P, 2, np.random.default_rng(0))))
    eps = torch.randn((len(idx), 2 * data.T_max, 8), generator=gen,
                      device="cuda")
    step = tstep.make_train_step(a.vae, spec0, spec1, cfg)
    want = [step(a, ds.gather_batch(staged, torch.as_tensor(
        i, device="cuda")), eps=eps[j])["loss"].item()
        for j, i in enumerate(idx)]
    epoch = tstep.make_train_epoch(b.vae, spec0, spec1, cfg, unroll=2)
    got = epoch(b, staged, idx, eps=eps)["loss"]
    torch.cuda.synchronize()
    assert _tf32_off()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for x, y in [(a.m, b.m), (a.H, b.H)] + list(zip(a.vae.parameters(),
                                                    b.vae.parameters())):
        assert _rel(y, x) <= 1e-5


# ---- the KL bound's terms (ops/gp_bound.py, csrc/gp_bound.cu) ----------------

BOUND_LEAVES = ("K0xz", "iLB", "LB", "K0_st", "iK0zz", "LK0zz", "LH", "H",
                "m", "mu", "log_v")


def _bound_case(L, S, T, M, dtype):
    """``chip_smoke.bound_case``'s synthetic state of the bound's inputs on
    the card (seed 0; a subject padded from T // 2 and one all padding):
    (leaves in BOUND_LEAVES order, valid)."""
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke.bound_case(L, S, T, M, dtype)


def _bound_run(kernel, case, need_hm=True, w=None, totals=True):
    """(terms, P_batch, kld_total, the 11 leaves' gradients of kld_total +
    w . terms) by the kernels (``kernel``) or autograd of the plain
    version; H and m without gradients unless ``need_hm``; without
    ``totals`` the kernels return no kld_total (a mesh's call) and
    ``assemble`` forms it from their terms."""
    from types import SimpleNamespace

    from hlax_torch.ops import gp_bound as gb

    base, valid = case
    xs = [t.detach().clone().requires_grad_(need_hm or i not in (7, 8))
          for i, t in enumerate(base)]
    K0xz, iLB, LB, K0st, iK, LK, LH, H, m, mu, lv = xs
    iB = torch.einsum("lskt,lsku->lstu", iLB, iLB)
    sizes = (200.0, 4000.0)
    if kernel:
        terms, pb, kld = gb._GpBound.apply(K0xz, iLB, LB, K0st, iK, LK, LH,
                                           H, m, mu, lv, iB.detach(), valid,
                                           sizes if totals else None)
        if not totals:
            assert kld is None
            kld = gb.assemble(terms, pb, *sizes, K0xz.shape[0])
    else:
        blk = SimpleNamespace(K0xz=K0xz, iB=iB, LB=LB, K0_st=K0st, iK0zz=iK,
                              LK0zz=LK)
        terms, pb = gb.kld_terms_plain(blk, LH, H, m, mu, lv, valid)
        kld = gb.assemble(terms, pb, *sizes, K0xz.shape[0])
    if w is None:
        w = torch.linspace(-1.0, 1.0, 7, dtype=terms.dtype, device="cuda")
    wants = [x for x in xs if x.requires_grad]
    grads = torch.autograd.grad(kld + (terms * w).sum(), wants)
    return [terms.detach(), pb, kld.detach(), *grads]


# [L, S, T, M]: the canonical shape with a padded and an all-padding
# subject, ragged sizes (M = 37, T = 13: tiles cut at both edges), the
# T = 200 and T = 500 blocks of long sequences and a mesh rank's latents
BOUND_SHAPES = [(32, 20, 20, 120), (3, 7, 13, 37), (32, 4, 200, 120),
                (16, 10, 20, 120), (32, 2, 500, 120)]


@pytest.mark.parametrize("totals", [True, False])
@pytest.mark.parametrize("need_hm", [True, False])
@pytest.mark.parametrize("shape", BOUND_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gp_bound_kernels_against_plain_version(gen, dtype, shape, need_hm,
                                                totals):
    """The bound's terms, P_batch, kld_total and every gradient (H and m
    too where Adam trains them, ``need_hm``) through the four kernels,
    with kld_total from the kernels or (without ``totals``, a mesh's call)
    from their terms, against autograd of the plain version: float64
    within 1e-10, float32 within 4x the plain version's own error against
    float64."""
    from hlax_torch.ops import gp_bound as gb

    case = _bound_case(*shape, dtype)
    before = dict(gb.LAUNCHES)
    got = _bound_run(True, case, need_hm, totals=totals)
    torch.cuda.synchronize()
    for k in gb.LAUNCHES:
        assert gb.LAUNCHES[k] == before[k] + 1, k
    plain = _bound_run(False, case, need_hm)
    assert got[1].item() == plain[1].item() == shape[1] - 1
    if dtype == torch.float32:
        ref = _bound_run(False, ([t.double() for t in case[0]],
                                 case[1].double()), need_hm)
        for i, (a, b, r) in enumerate(zip(got, plain, ref)):
            _hold(f"output {i}", a, b, r)
        return
    g = torch.Generator("cuda").manual_seed(11)
    moved = _bound_run(False, ([t * (1 + 2.0 ** -52 * (2 * torch.randint(
        0, 2, t.shape, generator=g, device="cuda").double() - 1))
        for t in case[0]], case[1]), need_hm)
    for i, (a, b, c) in enumerate(zip(got, plain, moved)):
        _hold_bound(f"output {i}", a, b, c)


def _hold_bound(name, got, plain, moved):
    """A float64 output of the bound within 1e-10 of the plain version's
    largest entry, or within 4x how far the plain version itself moves
    (``moved``) when every input moves by one unit in the last place,
    where that is larger: the bound's B-block gradients reach their size
    through ~1e6-fold cancellation, which both versions round in other
    orders ([fusion]'s float64 bar)."""
    scale = plain.abs().max().item()
    err = (got - plain).abs().max().item()
    own = (moved - plain).abs().max().item()
    assert err <= max(1e-10 * scale, 4 * own), (name, err, scale, own)


@pytest.mark.parametrize("need_hm", [True, False])
@pytest.mark.parametrize("shape", BOUND_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gp_bound_graph_replays_eager_call(gen, dtype, shape, need_hm):
    """The bound's forward and backward (H's and m's gradients too where
    ``need_hm``: K4's last block) captured in a CUDA graph and replayed
    twice: equal to the eager call bit for bit (every sum in a fixed order,
    the last blocks' counters zero again)."""
    case = _bound_case(*shape, dtype)
    eager = _bound_run(True, case, need_hm)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _bound_run(True, case, need_hm)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _bound_run(True, case, need_hm)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(captured, eager)):
            assert torch.equal(a, b), (i, (a - b).abs().max().item())


def test_gp_bound_op_dispatch(gen):
    """``kld_terms`` on the card launches the kernels in float32 and
    float64 and counts a plain call in bfloat16; without ``totals`` (a
    mesh) it returns no kld_total."""
    from types import SimpleNamespace

    from hlax_torch.ops import gp_bound as gb

    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        (K0xz, iLB, LB, K0st, iK, LK, LH, H, m, mu, lv), valid = \
            _bound_case(3, 7, 13, 37, dtype)
        iB = torch.einsum("lskt,lsku->lstu", iLB, iLB)
        blk = SimpleNamespace(K0xz=K0xz, iB=iB, LB=LB, K0_st=K0st,
                              iK0zz=iK, LK0zz=LK, iLB=iLB)
        gb.reset_counters()
        terms, pb, kld = gb.kld_terms(blk, LH, H, m, mu, lv, valid)
        assert kld is None and terms.shape == (7,)
        kernel = dtype != torch.bfloat16
        assert gb.LAUNCHES["gp_bound_fwd_latents_cuda"] == int(kernel)
        assert gb.PLAIN_CUDA_CALLS["gp_bound_plain"] == int(not kernel)


# ---- the natural-gradient chain (ops/natgrad.py, csrc/natgrad.cu) ----------

def _chip_smoke():
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


# [L, S, T, M]: the canonical batch, a 2 x 2 mesh rank's, the ragged toy
# (M = 37: a last strip of 5 rows, K8's half tile of 5 columns, element
# copies in float), T = 40 (past TP: iB mu by cuBLAS), and K8's ring of two
# stages (M = 300 and 512; K5's two clusters a latent, the second with
# blocks past M's columns at 300)
NATGRAD_SHAPES = [(32, 20, 20, 120), (16, 10, 20, 120), (3, 7, 13, 37),
                  (4, 3, 40, 37), (2, 3, 5, 300), (2, 2, 5, 512)]
# (data and state dtype, the chain's): float32, float64, --nat_grad_f64
NATGRAD_DTYPES = [(torch.float32, None), (torch.float64, None),
                  (torch.float32, torch.float64)]


@pytest.mark.parametrize("jitter", [0.0, 1e-3])
@pytest.mark.parametrize("shape", NATGRAD_SHAPES)
@pytest.mark.parametrize("dtype, chain", NATGRAD_DTYPES)
def test_natgrad_kernels_against_plain_version(gen, dtype, chain, shape,
                                               jitter):
    """K5-K8, each on its own inputs (``chip_smoke.natgrad_case``), one
    launch each, against their plain versions: float64 within 1e-10 of the
    largest entry; float32 inputs within 4x the plain version's own error
    against float64, plus 1e-6 of it; K8's H_new exactly symmetric."""
    from hlax_torch.ops import natgrad as ng

    cs = _chip_smoke()
    case = cs.natgrad_case(*shape, dtype, chain)
    before = dict(ng.LAUNCHES)
    got = cs.natgrad_run(case, True, jitter)
    torch.cuda.synchronize()
    for k in ng.LAUNCHES:
        assert ng.LAUNCHES[k] == before[k] + 1, k
    plain = cs.natgrad_run(case, False, jitter)
    ref = None if dtype == torch.float64 else cs.natgrad_run(
        cs.natgrad_case64(case), False, jitter)
    assert torch.equal(got[-1], got[-1].mT)
    for i, (a, b) in enumerate(zip(got, plain)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        if ref is None:
            scale = b.abs().max().item()
            assert (a - b).abs().max().item() <= 1e-10 * scale, i
            continue
        r = ref[i].double()
        scale = r.abs().max().item()
        own = (b.double() - r).abs().max().item()
        err = (a.double() - r).abs().max().item()
        assert err <= 4 * own + 1e-6 * scale, (i, err, own, scale)


# K6's and K7's strips [L, M]: the ragged M (element copies in float), M =
# 300 (a last strip shorter than the plan's rows), the largest M (float64's
# rows cut by shared bytes) and a 2 x 2 mesh rank's latents
STRIP_SHAPES = [(3, 37), (2, 300), (2, 512), (16, 120)]


def _off16(t):
    """``t`` as a contiguous view one entry into a buffer of its own: its
    rows off 16 bytes (the kernels' element copies)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("jitter", [0.0, 1e-3])
@pytest.mark.parametrize("shape", STRIP_SHAPES)
@pytest.mark.parametrize("dtype, chain", NATGRAD_DTYPES)
def test_natgrad_strips_against_plain_version(gen, dtype, chain, shape,
                                              jitter, shifted):
    """K6 and K7 on ``chip_smoke.natgrad_case``'s inputs at [L, M, M], one
    launch each, against their plain versions at the bars above; where
    ``shifted``, every input a view whose rows lie off 16 bytes."""
    from hlax_torch.ops import natgrad as ng

    cs = _chip_smoke()
    L, M = shape
    case = cs.natgrad_case(L, 3, 5, M, dtype, chain)
    lat, pre = case["latents"], case["pre"]
    if shifted:
        lat, pre = tuple(map(_off16, lat)), tuple(map(_off16, pre))
        assert lat[0].data_ptr() % 16 and pre[0].data_ptr() % 16
    before = dict(ng.LAUNCHES)
    got = list(ng.latents(*lat)) + list(ng.update_pre(*pre, cs.NATGRAD_LR,
                                                      jitter))
    torch.cuda.synchronize()
    for k in ("natgrad_fwd_latents_cuda", "natgrad_update_pre_cuda"):
        assert ng.LAUNCHES[k] == before[k] + 1, k
    plain = list(ng.latents_plain(*lat)) + list(ng.update_pre_plain(
        *pre, cs.NATGRAD_LR, jitter))
    ref = None
    if dtype != torch.float64:
        c64 = cs.natgrad_case64(case)
        ref = list(ng.latents_plain(*c64["latents"])) + list(
            ng.update_pre_plain(*c64["pre"], cs.NATGRAD_LR, jitter))
    for i, (a, b) in enumerate(zip(got, plain)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        if ref is None:
            scale = b.abs().max().item()
            assert (a - b).abs().max().item() <= 1e-10 * scale, i
            continue
        r = ref[i].double()
        scale = r.abs().max().item()
        own = (b.double() - r).abs().max().item()
        err = (a.double() - r).abs().max().item()
        assert err <= 4 * own + 1e-6 * scale, (i, err, own, scale)


@pytest.mark.parametrize("T", [20, 40])
@pytest.mark.parametrize("dtype, chain", NATGRAD_DTYPES)
def test_natgrad_subjects_strided_mu(gen, dtype, chain, T):
    """K5 on a mesh rank's latents: mu a view of the second half of a
    [S, T, 2 L] tensor's columns (read at its row stride, not copied), the
    rank's [16, 10, T, 120] slice; iB mu by the kernel (T = 20) or cuBLAS
    (T = 40); against the plain version at the bars above."""
    from hlax_torch.ops import natgrad as ng

    cs = _chip_smoke()
    case = cs.natgrad_case(16, 10, T, 120, dtype, chain)
    iB, mu, valid, K0xz = case["subjects"]
    wide = torch.cat([torch.randn_like(mu), mu], dim=2)
    view = wide[..., mu.shape[2]:]
    assert ng._rows_of(view) == 2 * mu.shape[2]
    calls = cs._launches_of(ng, lambda: ng.fwd_subjects(
        iB, view, valid, K0xz, case["chain"]))
    assert calls[0][2][4].data_ptr() == view.data_ptr()
    got = calls[0][2][7]
    plain = ng.fwd_subjects_plain(iB, mu, valid, K0xz, case["chain"])
    if dtype == torch.float64:
        scale = plain.abs().max().item()
        assert (got - plain).abs().max().item() <= 1e-10 * scale
        return
    ref = ng.fwd_subjects_plain(*(t.double() for t in case["subjects"]),
                                torch.float64)
    scale = ref.abs().max().item()
    own = (plain.double() - ref).abs().max().item()
    err = (got.double() - ref).abs().max().item()
    assert err <= 4 * own + 1e-6 * scale, (err, own, scale)


@pytest.mark.parametrize("dtype, chain", NATGRAD_DTYPES)
def test_natgrad_graph_replays_eager_call(gen, dtype, chain):
    """The four kernels captured in a CUDA graph and replayed twice: equal
    to the eager calls bit for bit (every sum in a fixed order)."""
    cs = _chip_smoke()
    case = cs.natgrad_case(32, 20, 20, 120, dtype, chain)
    eager = cs.natgrad_run(case, True, 1e-3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cs.natgrad_run(case, True, 1e-3)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = cs.natgrad_run(case, True, 1e-3)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(captured, eager)):
            assert torch.equal(a, b), (i, (a - b).abs().max().item())


def test_natgrad_op_dispatch(gen):
    """On the card bfloat16 takes each kernel's plain version, counted in
    PLAIN_CUDA_CALLS, and launches nothing; the update written into the
    given (m, H) in place by K8 in float32, which refuses an (m, H) that
    is not contiguous."""
    from hlax_torch.gp import elbo
    from hlax_torch.ops import natgrad as ng

    cs = _chip_smoke()
    case = cs.natgrad_case(3, 7, 13, 37, torch.float32)
    bf = lambda ts: tuple(t.bfloat16() for t in ts)
    ng.reset_counters()
    ng.fwd_subjects(*bf(case["subjects"]), torch.bfloat16)
    ng.update_pre(*bf(case["pre"]), 0.01, 0.0)
    assert not any(ng.LAUNCHES.values())
    assert ng.PLAIN_CUDA_CALLS["natgrad_fwd_subjects_plain"] == 1
    assert ng.PLAIN_CUDA_CALLS["natgrad_update_pre_plain"] == 1
    iH, gH, gm, m = case["pre"]
    H = torch.cholesky_inverse(torch.linalg.cholesky(iH)).contiguous()
    out = (m.clone(), H.clone())
    ptrs = [t.data_ptr() for t in out]
    got = elbo.natural_gradient_update(m, H, gm, gH, 0.01, iH=iH, out=out)
    want = elbo.natural_gradient_update(m, H, gm, gH, 0.01, iH=iH)
    assert [t.data_ptr() for t in got] == ptrs
    assert ng.LAUNCHES["natgrad_update_finish_cuda"] == 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="contiguous"):
        elbo.natural_gradient_update(m, H, gm, gH, 0.01, iH=iH,
                                     out=(m.clone(), H.clone().mT))
    ng.reset_counters()
