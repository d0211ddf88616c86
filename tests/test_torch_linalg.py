"""Port's Cholesky-plus-inverse (``hlax_torch.ops.linalg_small``) against
hlax's Pallas kernels, run in interpret mode on the CPU.

The port's plain versions are what its CUDA kernels compute (on the card
the small kernel and the mid kernel's n <= 32 path agree with them bit for
bit, the mid kernel's blocked path within float32 rounding against a
float64 reference, ``chip_smoke.py``); here the plain versions are held
against hlax ``chol_inv_small`` (``_kernel``) and
``_chol_inv_mid_batched`` (``_mid_kernel``), with gradients against hlax's
custom VJPs.  float64 unless noted; the pivot-guard case is float32, the
dtype in which the input is indefinite.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hlax.ops import linalg_small as ls
from hlax_torch.ops import linalg_small as tls

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _force_pallas():
    """Run hlax's Pallas kernels in interpret mode, and restore the flag."""
    old = ls.FORCE_PALLAS
    ls.FORCE_PALLAS = True
    try:
        yield
    finally:
        ls.FORCE_PALLAS = old


def _spd(rng, shape, n):
    a = rng.normal(size=shape + (n, n))
    return a @ np.swapaxes(a, -1, -2) / n + 0.5 * np.eye(n)


def _indefinite_f32(rng, n, batch=3):
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    a64 = (q * np.logspace(0.0, -10.0, n)) @ q.T
    a32 = np.broadcast_to(a64, (batch, n, n)).astype(np.float32)
    assert np.linalg.eigvalsh(a32[0].astype(np.float64)).min() < 0
    return a64, a32


def _hlax_fact(n):
    return ls.chol_inv_small if n <= ls.MAX_DIAG_BLOCK else \
        ls._chol_inv_mid_batched


@pytest.mark.parametrize("n,shape", [(20, (2, 3)), (56, (2,)), (120, (2,))])
def test_forward_matches_hlax_kernels(n, shape):
    """T=20 through the small kernel, M=56/120 through the mid kernel."""
    a = _spd(np.random.default_rng(n), shape, n)
    lj, ilj = _hlax_fact(n)(jnp.asarray(a))
    lt, ilt = tls.chol_inv_blocked(torch.tensor(a))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(ilt.numpy(), np.asarray(ilj), rtol=1e-9,
                               atol=1e-11)
    # exact zeros above the diagonal, in L and in L^-1
    iu = np.triu_indices(n, 1)
    assert not lt.numpy()[..., iu[0], iu[1]].any()
    assert not ilt.numpy()[..., iu[0], iu[1]].any()


def _pinned(l, floor):
    """Columns the guard pinned to sqrt(floor) * e_j."""
    below = np.tril(l, -1)
    return [j for j in range(l.shape[-1])
            if abs(l[j, j] - np.sqrt(floor)) < 1e-7 and not below[:, j].any()]


@pytest.mark.parametrize("n", [20, 56])
def test_pivot_guard_matches_hlax(n):
    """On a float32-indefinite input (logspace(0, -10) spectrum) both guarded
    factorizations are finite and factor a nearby matrix, and the port's L
    is exactly lower-triangular.  Which trailing pivots fall below the floor
    is decided by float32 rounding (hlax refines an rsqrt, the port divides
    by a sqrt), and so are the columns with tiny pivots; L is compared on
    the columns whose pivot is at least 1e-3 (the leading, well-determined
    ones), and the pinned sets must match exactly at T=20.  hlax's mid
    kernel leaves entries above the diagonal of L after a pinned pivot
    (ROADMAP queue 3); only its lower triangle is compared."""
    a64, a32 = _indefinite_f32(np.random.default_rng(11), n)
    lj, ilj = _hlax_fact(n)(jnp.asarray(a32))
    lt, ilt = tls.chol_inv_blocked(torch.tensor(a32))
    lt, ilt = lt.numpy(), ilt.numpy()
    assert np.isfinite(lt).all() and np.isfinite(ilt).all()
    assert np.isfinite(np.asarray(ilj)).all()
    iu = np.triu_indices(n, 1)
    assert not lt[..., iu[0], iu[1]].any()
    lj = np.tril(np.asarray(lj))
    for l in (lt[0], lj[0]):
        l = l.astype(np.float64)
        assert np.abs(l @ l.T - a64).max() < 1e-5
    floor = 1e-6 * np.diag(a32[0]).max()
    pin_t, pin_j = _pinned(lt[0], floor), _pinned(lj[0], floor)
    assert pin_t and pin_j
    if n == 20:
        assert pin_t == pin_j
    k = int(np.argmax(np.diagonal(lj[0]) ** 2 < 1e-3))
    assert k > 0
    np.testing.assert_allclose(lt[:, :, :k], lj[:, :, :k], rtol=1e-4,
                               atol=1e-5)


def _loss_weights(rng, shape, n):
    return rng.normal(size=shape + (n, n)), rng.normal(size=shape + (n, n))


def _sym(g):
    return g + np.swapaxes(g, -1, -2)


@pytest.mark.parametrize("n", [8, 16, 18, 20, 56, 100, 120, 125])
def test_gradients_match_hlax_vjps(n):
    """n=8, 16 and 18 reach hlax's Pallas backward kernel (``_bwd_kernel``,
    in interpret mode; hlax launches it for T <= 18), n=20 its
    ``_bwd_reference``, n=56, 100, 120 and 125 the mid kernel's VJP
    (``_mid_bwd``; 120 is M, 100 and 125 the diagonal blocks of T = 200
    and 500).  On the CPU the port runs its backward kernels' plain
    versions, ``_bwd_reference``, for all of them.  hlax's backward kernel
    returns the transpose of ``_bwd_reference``'s lower-triangular
    convention (ROADMAP queue 3), so up to n=18 the symmetrized gradients
    are compared; above, the gradients themselves, and for the mid sizes
    also with one output unused (its cotangent zero).  hlax's factorization
    runs once (``jax.vjp``); each loss's cotangents go through its
    pullback."""
    rng = np.random.default_rng(100 + n)
    a = _spd(rng, (3,), n)
    wl, wi = _loss_weights(rng, (3,), n)
    jfact = ls.chol_inv_small if n <= ls.MAX_DIAG_BLOCK else ls._chol_inv_mid
    (lj, _), pull = jax.vjp(jfact, jnp.asarray(a))
    # the loss sum(l wl) + sum(il wi) + logdet: l's cotangent takes the
    # logdet's gradient beside wl
    gl = jax.grad(lambda l: jnp.sum(l * wl)
                  + jnp.sum(ls.logdet_from_chol(l)))(lj)
    cases = [("both", (gl, jnp.asarray(wi)))]
    if n > ls.MAX_DIAG_BLOCK:
        cases += [("L only", (jnp.asarray(wl), jnp.zeros_like(lj))),
                  ("L^-1 only", (jnp.zeros_like(lj), jnp.asarray(wi)))]
    for case, cot in cases:
        gj = np.asarray(pull(cot)[0])
        at = torch.tensor(a, requires_grad=True)
        l, il = tls.chol_inv_blocked(at)
        f = {"both": (l * torch.tensor(wl)).sum()
             + (il * torch.tensor(wi)).sum()
             + 2 * torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(),
             "L only": (l * torch.tensor(wl)).sum(),
             "L^-1 only": (il * torch.tensor(wi)).sum()}[case]
        f.backward()
        gt = at.grad.numpy()
        if n <= 18:
            gt, gj = _sym(gt), _sym(gj)
        np.testing.assert_allclose(gt, gj, rtol=1e-8,
                                   atol=1e-10 * np.abs(gj).max(),
                                   err_msg=case)


def test_gradient_with_one_output_unused():
    """A loss that reads only L (or only L^-1) gets a zero cotangent for the
    other output (symmetrized: n=6 reaches hlax's backward kernel)."""
    rng = np.random.default_rng(5)
    a = _spd(rng, (2,), 6)
    for pick in (0, 1):
        at = torch.tensor(a, requires_grad=True)
        tls.chol_inv_small(at)[pick].sum().backward()
        gj = jax.grad(lambda x: jnp.sum(ls.chol_inv_small(x)[pick]))(
            jnp.asarray(a))
        np.testing.assert_allclose(_sym(at.grad.numpy()),
                                   _sym(np.asarray(gj)), rtol=1e-9,
                                   atol=1e-12)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers check device, dtype, shape and contiguity and
    raise; the autograd Functions use the plain version only on the CPU."""
    a = torch.eye(20).expand(2, 20, 20).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        tls.chol_inv_small_cuda(a)
    with pytest.raises(ValueError, match="CUDA"):
        tls.chol_inv_mid_cuda(torch.eye(120)[None].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        tls.chol_inv_bwd_cuda(a, a, a, a)
    m = torch.eye(30).expand(2, 30, 30).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        tls.chol_inv_mid_bwd_cuda(m, m, m, m)
    tls.reset_counters()
    for x in (a, m):
        x.requires_grad_(True)
        l, il = tls.chol_inv_blocked(x)
        (l.sum() + il.sum()).backward()
    assert tls.LAUNCHES == {"chol_inv_small_cuda": 0, "chol_inv_mid_cuda": 0,
                            "chol_inv_bwd_cuda": 0,
                            "chol_inv_mid_bwd_cuda": 0}
    assert tls.PLAIN_CUDA_CALLS == {"chol_inv_plain": 0,
                                    "chol_inv_bwd_plain": 0,
                                    "chol_inv_mid_bwd_plain": 0}


# the mesh ranks' local batches: [16, 120, 120] (L_loc = 16 on 2 latent
# ranks) and B blocks of [16, 10] and [32, 5] (2 x 2 and 4 x 1 meshes of the
# canonical 32 latents and 20 subjects a batch), 160 matrices
@pytest.mark.parametrize("batch", [1, 16, 32, 64, 8192])
def test_mid_launch_plan(batch):
    """Every n the mid kernel takes gets a plan within a block's 227 KB of
    shared memory whose grid covers the batch; n <= 32 takes the one-warp
    path, the rest the blocked one with 8-column panels."""
    for n in range(tls.MAX_DIAG_BLOCK + 1, tls.MAX_MID_M + 1):
        plan = tls.mid_launch_plan(n, batch)
        assert plan.smem <= 232_448
        assert plan.grid * plan.per_block >= batch
        assert (plan.grid - 1) * plan.per_block < batch
        assert plan.threads % 32 == 0
        if n <= 32:
            assert plan.path == "warp" and plan.per_block == plan.threads // 32
            assert plan.smem >= plan.per_block * 32 * 33 * 4
        else:
            np_ = -(-n // 8) * 8
            assert plan.path == "blocked" and plan.panel == 8
            assert plan.per_block == 1 and plan.threads == 512
            assert plan.smem >= 4 * 2 * np_ * np_


@pytest.mark.parametrize("batch", [1, 32, 160, 640, 1001, 8192])
def test_small_launch_plan(batch):
    """Every n the small kernel takes gets a plan within a block's 227 KB of
    shared memory whose grid covers the batch: n <= 32 on the register path
    at the smallest compiled size np >= n (exactly 20 for the canonical
    T = 20), the rest in shared memory; one warp a matrix, the warps a block
    spreading the batch over the 132 SMs no worse than four a block."""
    for n in range(1, tls.MAX_SMALL_T + 1):
        plan = tls.small_launch_plan(n, batch)
        assert plan.smem <= 232_448
        assert plan.threads == 32 * plan.per_block
        assert plan.per_block in (1, 2, 4)
        assert plan.grid * plan.per_block >= batch
        assert (plan.grid - 1) * plan.per_block < batch
        busiest = plan.per_block * -(-plan.grid // 132)
        assert busiest <= 4 * -(-(-(-batch // 4)) // 132)
        if n <= 32:
            assert plan.path == "warp" and plan.np in tls.SMALL_SIZES
            assert plan.np >= n and not any(n <= s < plan.np
                                            for s in tls.SMALL_SIZES)
            assert plan.smem >= plan.per_block * 2 * plan.np * (plan.np + 1) * 4
        else:
            assert plan.path == "smem" and plan.np == n
            assert plan.smem >= plan.per_block * 2 * n * n * 4
    assert tls.small_launch_plan(20, batch).np == 20


@pytest.mark.parametrize("batch", [1, 32, 160, 640, 1001, 8192])
@pytest.mark.parametrize("sms", [132, 114])   # H100 SXM, H100 PCIe
def test_bwd_launch_plan(batch, sms):
    """Every n the backward kernel takes gets a plan within a block's 227 KB
    of shared memory and 128 threads whose grid covers the batch, at the
    smallest compiled size np >= n (a multiple of 4), with six np x np
    buffers a matrix, one warp each, spreading the batch over the SMs no
    worse than four a block."""
    for n in range(1, tls.MAX_SMALL_T + 1):
        plan = tls.bwd_launch_plan(n, batch, sms)
        assert plan.np in tls.BWD_SIZES and plan.np % 4 == 0
        assert plan.np >= n and not any(n <= s < plan.np
                                        for s in tls.BWD_SIZES)
        assert plan.per_block in (1, 2, 4)
        assert plan.threads == 32 * plan.per_block
        assert plan.smem == plan.per_block * 6 * plan.np ** 2 * 4 <= 232_448
        assert plan.grid * plan.per_block >= batch
        assert (plan.grid - 1) * plan.per_block < batch
        busiest = plan.per_block * -(-plan.grid // sms)
        assert busiest <= 4 * -(-(-(-batch // 4)) // sms)
    assert tls.bwd_launch_plan(20, batch, sms).np == 20


def test_kernel_row_col_arithmetic():
    """The small and backward kernels split a flat index e (or a float4
    index q) into row and column without an integer division: row =
    (int)((e + 0.5f) * (1.0f / n)) in float32 arithmetic.  It must equal
    e // n for every index of every n <= 48 they take."""
    for n in range(1, tls.MAX_SMALL_T + 1):
        for width, count in ((n, n * n), (n // 4, n * n // 4)):
            if width == 0 or (width != n and n % 4):
                continue
            e = np.arange(count)
            rn = np.float32(1) / np.float32(width)
            rows = ((e.astype(np.float32) + np.float32(0.5)) * rn).astype(
                np.int64)
            np.testing.assert_array_equal(rows, e // width)


def test_kernel_build_flags(tmp_path, monkeypatch):
    """The mid and backward kernels' libraries are built with FMA
    contraction, the small kernel's without, and a library built with other
    flags than its current ones is rebuilt."""
    from hlax_torch.ops import cuda_build

    for name in ("chol_inv_mid", "chol_inv_bwd"):
        assert "--fmad=false" not in cuda_build.nvcc_flags(name)
    assert "--fmad=false" in cuda_build.nvcc_flags("chol_inv_small")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    for name in ("chol_inv_small", "chol_inv_mid"):
        assert cuda_build._stale(name)           # never built
        (tmp_path / f"lib{name}.so").write_bytes(b"")
        assert cuda_build._stale(name)           # built, no flags stamp
        (tmp_path / f"lib{name}.flags").write_text(
            " ".join(cuda_build.nvcc_flags("chol_inv_small"
                                           if name == "chol_inv_mid"
                                           else "chol_inv_mid")))
        assert cuda_build._stale(name)           # built with other flags
        (tmp_path / f"lib{name}.flags").write_text(
            " ".join(cuda_build.nvcc_flags(name)))
        assert not cuda_build._stale(name)       # newer than its sources


@pytest.mark.parametrize("batch", [1, 16, 32, 64, 160, 640, 8192])
def test_launch_plans_in_float64(batch):
    """The three plans count 8 bytes a value.  The small and backward
    kernels' shared memory doubles and still fits a block (the backward's
    six 48 x 48 buffers, 110,592 bytes, one matrix a block).  The mid
    kernel's float64 blocked path has no device workspace: A, L^-1 packed
    to the rows of its lower 8 x 8 tiles, the transposed panel and L11 all
    fit one block's shared memory for every
    n in 33..128, with 256 threads and one block a matrix; its warp path
    (n <= 32) doubles float32's."""
    for n in range(1, tls.MAX_MID_M + 1):
        if n <= tls.MAX_SMALL_T:
            for plan_of in (tls.small_launch_plan, tls.bwd_launch_plan):
                p32, p64 = plan_of(n, batch), plan_of(n, batch, 132, 8)
                assert p64.np == p32.np
                assert p64.smem == 2 * p32.smem // p32.per_block \
                    * p64.per_block <= tls.SMEM_PER_BLOCK
                assert p64.grid * p64.per_block >= batch
        if n <= tls.MAX_DIAG_BLOCK:
            continue
        p32, p64 = tls.mid_launch_plan(n, batch), tls.mid_launch_plan(
            n, batch, 8)
        assert p64.smem <= tls.SMEM_PER_BLOCK
        assert p64.grid * p64.per_block >= batch
        assert (p64.grid - 1) * p64.per_block < batch
        if n <= 32:
            assert p64 == p32._replace(smem=2 * p32.smem)
            continue
        np_, nt = -(-n // 8) * 8, -(-n // 8)
        packed = 32 * nt * (nt + 1)          # lower 8 x 8 tiles' rows
        assert p64 == ("blocked", batch, 256, 8,
                       8 * (np_ * np_ + packed + 8 * np_ + 64), 1)
    assert "work" not in tls.MidPlan._fields
    assert tls.bwd_launch_plan(48, 1, 132, 8).smem == 110_592
    assert tls.mid_launch_plan(120, batch, 8).smem == 184_832
    assert tls.mid_launch_plan(128, batch, 8).smem == 209_408 <= 232_448


@pytest.mark.parametrize("batch", [1, 16, 32, 64, 160, 640, 8192])
def test_mid_launch_plan_in_float32_unchanged(batch):
    """The float32 plan is the one the float32 kernel was designed for, for
    every n the mid kernel takes: four warps a block of 33-value-stride
    tiles for n <= 32; above, 512 threads a matrix with A and L^-1 as two
    full np x np arrays beside the transposed panel and L11."""
    for n in range(tls.MAX_DIAG_BLOCK + 1, tls.MAX_MID_M + 1):
        np_ = -(-n // 8) * 8
        want = (("warp", -(-batch // 4), 128, 0, 4 * 32 * 33 * 4, 4)
                if n <= 32 else
                ("blocked", batch, 512, 8, 4 * (2 * np_ * np_ + 8 * np_ + 64),
                 1))
        assert tls.mid_launch_plan(n, batch) == want
        assert tls.mid_launch_plan(n, batch, 4) == want


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("batch", [1, 16, 64, 128, 8192])
def test_mid_bwd_launch_plan(batch, itemsize):
    """Every n the mid pullback takes gets three launches within a block's
    227 KB of shared memory: a block a (matrix, 32-row panel) twice and a
    (matrix, lower pair of 32 x 32 tiles), 256 and 128 threads, the shared
    memory the largest panel's and the largest pair's (the layouts of
    ``_mid_bwd_model``); at n = 120, 74,880 and 49,280 bytes in float32."""
    for n in range(tls.MAX_DIAG_BLOCK + 1, tls.MAX_MID_M + 1):
        plan = tls.mid_bwd_launch_plan(n, batch, itemsize)
        panels = -(-n // 32)
        assert plan.panels == panels
        assert plan.grid_ab == batch * panels
        assert plan.grid_c == batch * panels * (panels + 1) // 2
        assert (plan.threads_ab, plan.threads_c) == (256, 128)
        assert plan.smem_ab == itemsize * max(
            _panel_values(n, p) for p in range(panels)) <= tls.SMEM_PER_BLOCK
        assert plan.smem_c == itemsize * max(
            _pair_values(n, i, j) for i in range(panels)
            for j in range(i + 1)) <= tls.SMEM_PER_BLOCK
    assert tls.mid_bwd_launch_plan(120, batch)[5:] == (74_880, 49_280)
    assert tls.mid_bwd_launch_plan(128, batch, 8).smem_ab == 167_936


def _panel_values(n, p):
    """Values a (matrix, panel) block holds: the panel's 32 columns of S^T
    (or P^T), then the first product's two k-major strips, or in their
    place the second's right factor (L^-T at a stride of cwp + 4, or
    L^-1)."""
    r0, cw = 32 * p, min(32 * p + 32, n)
    cwp = -(-cw // 4) * 4
    return cwp * 32 + max((n - r0) * (cwp + 32), cw * (cwp + 4))


def _pair_values(n, i, j):
    """Values a (matrix, tile pair) block holds: strips of L^-1 and Y from
    row 32 i, two on the diagonal and four off it, and the mirrored tile."""
    return (2 if i == j else 4) * (n - 32 * i) * 32 + 32 * 33


def _strip(m, n, row0, rows, col0, width):
    """A k-major strip as ``load_strip`` stages it: m[row0 + r][col0 + c],
    zero past column n."""
    out = np.zeros((rows, width))
    cols = min(width, n - col0)
    out[:, :cols] = m[row0:row0 + rows, col0:col0 + cols]
    return out


def _mid_bwd_model(l, il, lb, ilb):
    """A model of ``csrc/chol_inv_mid_bwd.cu``'s three launches on one
    matrix, in float64: each block's shared memory a NaN-filled array of
    the plan's size, every array at the kernel's offset, each warp's
    product over its warp-uniform k-range where the kernel runs it, the
    workspace NaN where nothing writes.  A range that missed a nonzero term,
    a read of a value nothing wrote or an array past the plan's shared
    memory shows in the result."""
    n = l.shape[-1]
    plan = tls.mid_bwd_launch_plan(n, 1, 8)
    lb2, y, abar = (np.full((n, n), np.nan) for _ in range(3))
    for launch in ("fold", "project"):
        for p in range(plan.panels):
            r0 = 32 * p
            kn, cw = n - r0, min(r0 + 32, n)
            cwp = -(-cw // 4) * 4
            smem = np.full(plan.smem_ab // 8, np.nan)
            first = smem[:cwp * 32].reshape(cwp, 32)       # S^T or P^T
            region = smem[cwp * 32:]
            u = region[:kn * cwp].reshape(kn, cwp)
            v = region[kn * cwp:kn * (cwp + 32)].reshape(kn, 32)
            u[:] = _strip(ilb if launch == "fold" else lb2, n, r0, kn, 0, cwp)
            v[:] = _strip(il if launch == "fold" else l, n, r0, kn, r0, 32)
            for w in range(8):          # tall: rows 16 w .. of S^T / P^T
                rows = np.arange(16 * w, min(16 * w + 16, cwp))
                if 16 * w >= cw:
                    continue
                acc = u[:, rows].T @ v
                if launch == "project":     # Phi in P^T's coordinates
                    i = r0 + np.arange(32)[None, :]
                    j = rows[:, None]
                    acc = np.where(i > j, acc, np.where(i == j, 0.5 * acc, 0))
                first[rows] = acc
            if launch == "fold":        # L^-T at a stride of cwp + 4
                right = region[:cw * (cwp + 4)].reshape(cw, cwp + 4)
                right[:, :cwp] = 0.0
                right[:, :cw] = il[:cw, :cw].T
            else:
                right = region[:cw * cwp].reshape(cw, cwp)
                right[:] = _strip(il, n, 0, cw, 0, cwp)
            out = lb2 if launch == "fold" else y
            for wr in range(2):         # wide: rows i, columns j
                for wc in range(4):
                    rmax = r0 + 16 * wr + 15
                    lo = 0 if launch == "fold" else 32 * wc
                    hi = min(rmax + 1, cw) if launch == "project" else \
                        min(rmax + 1, cw, 32 * wc + 32)
                    rows = np.arange(16 * wr, 16 * wr + 16)
                    cols = np.arange(32 * wc, min(32 * wc + 32, cwp))
                    acc = np.zeros((16, 32))
                    if 32 * wc <= rmax and r0 + 16 * wr < n and len(cols):
                        acc[:, :len(cols)] = (first[lo:hi, rows].T
                                              @ right[lo:hi, cols])
                    i = r0 + rows[:, None]
                    j = np.arange(32 * wc, 32 * wc + 32)[None, :]
                    keep = (i < n) & (j < n)
                    val = (lb[np.minimum(i, n - 1), np.minimum(j, n - 1)]
                           - acc if launch == "fold" else acc)
                    val = np.where(j <= i, val, 0.0)
                    out[i[keep[:, 0], 0][:, None],
                        j[0, keep[0]][None, :]] = val[keep[:, 0]][
                            :, keep[0]]
    for ti in range(plan.panels):
        for tj in range(ti + 1):
            i0, j0, kn = 32 * ti, 32 * tj, n - 32 * ti
            smem = np.full(plan.smem_c // 8, np.nan)
            strips = [smem[s * kn * 32:(s + 1) * kn * 32].reshape(kn, 32)
                      for s in range(2 if ti == tj else 4)]
            strips[0][:] = _strip(il, n, i0, kn, i0, 32)
            strips[1][:] = _strip(y, n, i0, kn, j0, 32)
            if ti != tj:
                strips[2][:] = _strip(il, n, i0, kn, j0, 32)
                strips[3][:] = _strip(y, n, i0, kn, i0, 32)
            xs_at = (2 if ti == tj else 4) * kn * 32
            xs = smem[xs_at:xs_at + 32 * 33].reshape(32, 33)
            x = np.zeros((32, 32))
            for half in range(2):       # warps 0, 1: X(I, J)
                r = slice(16 * half, 16 * half + 16)
                x[r] = strips[0][16 * half:, r].T @ strips[1][16 * half:]
            if ti == tj:
                xs[:, :32] = x
            else:                       # warps 2, 3: X(J, I)
                xs[:, :32] = strips[2].T @ strips[3]
            ii = i0 + np.arange(32)[:, None]
            jj = j0 + np.arange(32)[None, :]
            val = np.where(ii > jj, x + xs[:, :32].T,
                           np.where(ii == jj, x, 0.0))
            keep = (ii < n) & (jj < n)
            abar[ii[keep[:, 0], 0][:, None], jj[0, keep[0]][None, :]] = \
                val[keep[:, 0]][:, keep[0]]
            if ti != tj:                # the mirror tile (J, I): zeros
                abar[j0:j0 + 32, i0:min(i0 + 32, n)] = 0.0
    return abar, lb2, y


@pytest.mark.parametrize("n", [25, 30, 32, 33, 40, 64, 97, 100, 120, 125,
                               128])
def test_mid_bwd_model_matches_reference(n):
    """The model of the mid pullback's launches (``_mid_bwd_model``: their
    shared-memory layouts at the plan's sizes, the warps' products over
    their k-ranges, the skipped warps, the epilogues) equals
    ``_bwd_reference`` at 1e-12 on a float64 matrix with random
    cotangents, and with each cotangent zero; every entry of Lb2, Y and
    A_bar is written, Lb2 and Y with exact zeros above the diagonal."""
    rng = np.random.default_rng(n)
    a = torch.tensor(_spd(rng, (1,), n))
    l, il = tls._chol_inv_plain(a)
    il = tls._refine_tri_inverse(l, il)
    lb, ilb = (torch.tensor(w) for w in _loss_weights(rng, (1,), n))
    iu = np.triu_indices(n, 1)
    for lbc, ilbc in ((lb, ilb), (lb, 0 * ilb), (0 * lb, ilb)):
        want = tls._bwd_reference(l, il, lbc, ilbc)[0].numpy()
        got, lb2, y = _mid_bwd_model(*(t[0].numpy() for t in
                                       (l, il, lbc, ilbc)))
        for t in (got, lb2, y):
            assert np.isfinite(t).all() and not t[iu].any()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
