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


@pytest.mark.parametrize("kind", ["spd", "indefinite"])
@pytest.mark.parametrize("shape", [(32, 20, 20, 20), (64, 120, 120),
                                   (3, 40, 40)])
def test_kernel_equals_plain_version(gen, shape, kind):
    """Built with --fmad=false, the kernels do the plain versions' float32
    operations in the same order: the results are equal, bit for bit."""
    a = (_spd if kind == "spd" else _indefinite)(shape, gen)
    fn = tls.chol_inv_small_cuda if shape[-1] <= tls.MAX_DIAG_BLOCK else \
        tls.chol_inv_mid_cuda
    before = tls.LAUNCHES[fn.__name__]
    l, il = fn(a)
    torch.cuda.synchronize()
    assert tls.LAUNCHES[fn.__name__] == before + 1
    lp, ilp = tls._chol_inv_plain(a)
    torch.testing.assert_close(l, lp, rtol=0, atol=0)
    torch.testing.assert_close(il, ilp, rtol=0, atol=0)
    assert torch.isfinite(il).all()
    assert not torch.triu(l, 1).any()


@pytest.mark.parametrize("cotangents", ["both", "l_bar only", "il_bar only"])
@pytest.mark.parametrize("shape", [(32, 20, 20, 20), (32, 20, 16, 16),
                                   (3, 48, 48)])
def test_bwd_kernel_against_plain_version(gen, shape, cotangents):
    """The backward kernel and its plain version (``_bwd_reference``), both
    float32 on the card, are each held against ``_bwd_reference`` in float64
    on the same float32 inputs: the kernel sums in another order, so its
    error may be at most 4x the plain version's plus 1e-6 max|A_bar|.  Above
    the diagonal it writes exact zeros."""
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
    for n in (20, 120):
        a = _spd((4, n, n), gen).requires_grad_(True)
        l, il = tls.chol_inv_blocked(a)
        (l.sum() + il.sum()).backward()
        assert torch.isfinite(a.grad).all()
    assert tls.LAUNCHES == {"chol_inv_small_cuda": 1, "chol_inv_mid_cuda": 1,
                            "chol_inv_bwd_cuda": 1}
    assert tls.PLAIN_CUDA_CALLS == {"chol_inv_plain": 0,
                                    "chol_inv_bwd_plain": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    a = _spd((2, 20, 20), gen)
    with pytest.raises(ValueError, match="float32"):
        tls.chol_inv_small_cuda(a.double())
    with pytest.raises(ValueError, match="contiguous"):
        tls.chol_inv_small_cuda(a.mT)
    with pytest.raises(ValueError, match="n <="):
        tls.chol_inv_small_cuda(_spd((2, 50, 50), gen))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tls.chol_inv_mid_cuda(_spd((2, 130, 130), gen))
    l, il = tls.chol_inv_small_cuda(a)
    with pytest.raises(ValueError, match="equal shapes"):
        tls.chol_inv_bwd_cuda(l, il, l[:1], il)
    with pytest.raises(ValueError, match="float32"):
        tls.chol_inv_bwd_cuda(l, il, l.double(), il)
    with pytest.raises(ValueError, match="CUDA"):
        tls.chol_inv_bwd_cuda(l, il, l.cpu(), il)
    big = _spd((2, 50, 50), gen)
    with pytest.raises(ValueError, match="n <="):
        tls.chol_inv_bwd_cuda(big, big, big, big)
