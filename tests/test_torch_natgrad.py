"""The natural-gradient chain's kernels (``hlax_torch/ops/natgrad.py``) on
the CPU.

float64 unless a test says otherwise, inputs made with numpy from a seed;
S = 5 subjects, of which one padded from T // 2 and one all padding; the
canonical kernel structure at the canonical conditioning (K0zz + 1e-6 I,
inducing points drawn from the batch's rows and moved, H = R R^T / 100 +
0.01 I as the train state draws it).  ``kld_upper_bound``'s
natural-gradient quantities and ``natural_gradient_update`` against hlax's
at ``test_torch_gp.py``'s bars (grad_m, grad_H and iH: rtol 1e-6, atol 1e-8
of the largest entry; m and H: rtol 1e-8, atol 1e-10), both through the
kernels' plain versions (what the wrappers run on a CPU tensor) and
through the wrappers' kernel path, its four launches recorded and each
done by its kernel's plain version (around them the cuBLAS products of
both paths, X = iLK^T (iLK + C_w iLK), and the kernel path's long
subjects' iB mu); the float64
chain on float32 inputs (``nat_grad_dtype``) at ``test_torch_natgrad64.py``'s
bar; the plans (K6 and K7's strips: every (latent, row) in one block; a
model of K5's clusters: every (latent, column, row) summed once, iB mu made
once a latent; a model of K8's tasks and k-walk: every entry of the lower
triangle summed once over k >= max(i, j) and written with its mirror,
m_new's terms each once; shared bytes within 227 KB); the constants and the
C entries' parameter counts of ``csrc/natgrad.cu``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hlax.gp import elbo as jelbo
from hlax.gp import kernels as jk
from hlax_torch.gp import elbo as telbo
from hlax_torch.gp import kernels as tk
from hlax_torch.ops import natgrad as ng

torch.set_num_threads(1)

S, L, Q = 5, 4, 6
P_TOT, N_TOT, EPS, LR = 20.0, 100.0, 1e-6, 0.01
CSRC = Path(ng.__file__).resolve().parents[1] / "csrc" / "natgrad.cu"
# canonical structure (configs/hlvae_config_file.txt) plus a bin factor
SPEC_ARGS = ([2], [5], [0],
             [{"cat_covariate": 3, "cont_covariate": 0},
              {"cat_covariate": 4, "cont_covariate": 1},
              {"cat_covariate": 2, "cont_covariate": 0}], [], [], 2)
# (M, T): every M of 16, 30, 120 and T of 5, 20, 33 (33: past TP, iB mu by
# cuBLAS on the kernel path)
BOUND_CASES = [(16, 5), (16, 33), (30, 20), (30, 33), (120, 20)]


def _setup(M, T, seed):
    """hlax's and the port's bound inputs (numpy, float64): subject S - 2
    padded from row T // 2, subject S - 1 all padding."""
    rng = np.random.default_rng(seed)
    spec0, spec1 = jk.build_kernel_specs(*SPEC_ARGS)
    k0, k1 = ([{k: np.asarray(v) + 0.3 * rng.standard_normal(v.shape)
                for k, v in p.items()}
               for p in jk.init_kernel_params(spec, L, jnp.float64)]
              for spec in (spec0, spec1))
    x = np.zeros((S, T, Q))
    x[:, :, 0] = np.arange(T)[None]
    x[:, :, 1] = rng.integers(-9, 11, S)[:, None]
    x[:, :, 2] = np.arange(S)[:, None]
    x[:, :, 3:5] = rng.integers(0, 2, (S, 1, 2))
    x[:, :, 5] = rng.integers(0, 2, (S, T))
    valid = np.ones((S, T))
    valid[S - 2, T // 2:] = 0.0
    valid[S - 1] = 0.0
    x = x * valid[:, :, None]
    rows = x.reshape(-1, Q)[valid.reshape(-1) > 0]
    zt = np.stack([rows[rng.choice(len(rows), M)] for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    R = rng.standard_normal((L, M, M))
    return dict(spec0=spec0, spec1=spec1, k0=k0, k1=k1, x=x, valid=valid,
                zt=zt, m=0.01 * rng.standard_normal((L, M, 1)),
                H=R @ R.transpose(0, 2, 1) / 100.0 + 0.01 * np.eye(M),
                mu=rng.standard_normal((S, T, L)) * valid[:, :, None],
                logv=0.3 * rng.standard_normal((S, T, L)) * valid[:, :, None],
                noise=np.ones(L))


_HLAX = {}


def _hlax_bound(M, T):
    """hlax's (kld, grad_m, grad_H, iH) of ``_setup(M, T)``, once a case."""
    if (M, T) not in _HLAX:
        s = _setup(M, T, seed=M + T)
        j = jnp.asarray
        jp = lambda ps: [{k: j(v) for k, v in p.items()} for p in ps]
        out = jelbo.kld_upper_bound(
            s["spec0"], jp(s["k0"]), s["spec1"], jp(s["k1"]), j(s["noise"]),
            j(s["m"]), j(s["H"]), j(s["zt"]), j(s["x"]), j(s["valid"]),
            j(s["mu"]), j(s["logv"]), P_TOT, N_TOT, EPS,
            natural_gradient=True, use_pallas_chol=True)
        _HLAX[(M, T)] = (s, [np.asarray(o) for o in out])
    return _HLAX[(M, T)]


def _port_bound(s, dtype=torch.float64, nat_dtype=None, eps=EPS):
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    tp = lambda ps: [{k: t(v) for k, v in p.items()} for p in ps]
    t0, t1 = tk.build_kernel_specs(*SPEC_ARGS)
    with torch.no_grad():
        return telbo.kld_upper_bound(
            t0, tp(s["k0"]), t1, tp(s["k1"]), t(s["noise"]), t(s["m"]),
            t(s["H"]), t(s["zt"]), t(s["x"]), t(s["valid"]), t(s["mu"]),
            t(s["logv"]), P_TOT, N_TOT, eps, natural_gradient=True,
            nat_grad_dtype=nat_dtype, use_pallas_chol=True)


def _c_params():
    """{entry: number of parameters} of csrc/natgrad.cu's C entries."""
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)',
                         CSRC.read_text()):
        out[m.group(1)] = len([p for p in m.group(2).split(",") if p.strip()])
    return out


def _emulate(calls):
    """A ``_launch`` that records each launch (its entry, its arguments)
    after checking the count against the C entry's (the stream last), and
    does the kernel's work by its plain version on the arguments."""
    params = _c_params()

    def launch(entry, like, *args):
        assert len(args) + 1 == params[entry], (entry, len(args))
        calls.append((entry, like, args))
        if entry == "natgrad_fwd_subjects":
            _, _, iB, iBmu, mu, valid, K0xz, out = args[:8]
            if iBmu is None:
                got = ng.fwd_subjects_plain(iB, mu, valid, K0xz, out.dtype)
            else:
                got = torch.einsum("lstm,lst->lm", K0xz, iBmu)[:, :, None]
            out.copy_(got)
        elif entry == "natgrad_fwd_latents":
            X, iK, iH, ngp, m, gm, gH = args[2:9]
            for o, v in zip((gm, gH), ng.latents_plain(X, iK, iH, ngp, m)):
                o.copy_(v)
        elif entry == "natgrad_update_pre":
            iH, gH, gm, m, iHn, rhs = args[2:8]
            lr, jitter = args[12:14]
            for o, v in zip((iHn, rhs), ng.update_pre_plain(iH, gH, gm, m,
                                                            lr, jitter)):
                o.copy_(v)
        else:
            iLA, rhs, m_out, H_out = args[2:6]
            for o, v in zip((m_out, H_out), ng.update_finish_plain(
                    iLA, rhs, m_out.dtype)):
                o.copy_(v)

    return launch


@pytest.fixture
def card(monkeypatch):
    """The wrappers' kernel path on CPU tensors: every launch recorded
    (``_emulate``); yields the list of (entry, like, args)."""
    calls = []
    monkeypatch.setattr(ng, "_on_card", lambda t: True)
    monkeypatch.setattr(ng, "_launch", _emulate(calls))
    yield calls


def _hold(got, want, rtol, atol_rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


@pytest.mark.parametrize("path", ["plain", "kernels"])
@pytest.mark.parametrize("M, T", BOUND_CASES)
def test_bound_quantities_match_hlax(request, M, T, path):
    """kld_upper_bound's grad_m, grad_H and iH (and the bound) against
    hlax's, through the plain versions or the kernel path (K5, cuBLAS's
    whitened Gram and triple product, K6: two launches)."""
    s, (kld_j, gm_j, gH_j, iH_j) = _hlax_bound(M, T)
    calls = request.getfixturevalue("card") if path == "kernels" else None
    kld, gm, gH, iH = _port_bound(s)
    if calls is not None:
        assert [c[0] for c in calls] == ["natgrad_fwd_subjects",
                                         "natgrad_fwd_latents"]
        iB, iBmu = calls[0][2][2:4]
        assert (iB is None) == (T > ng.TP) == (iBmu is not None)
    # the bound itself at test_torch_pivot_floor.py's bar for the canonical
    # conditioning (K0zz's condition number carries the factorizations'
    # rounding into it: 5e-8 at M = 120)
    np.testing.assert_allclose(kld.item(), float(kld_j), rtol=1e-7)
    for got, want in ((gm, gm_j), (gH, gH_j), (iH, iH_j)):
        _hold(got, want, 1e-6, 1e-8)


def _update_inputs(M, seed):
    s = _setup(M, 5, seed)
    rng = np.random.default_rng(seed + 100)
    gHs = rng.standard_normal((L, M, M)) / 10.0
    return (s["m"], s["H"], rng.standard_normal((L, M, 1)),
            0.4 * (gHs + gHs.transpose(0, 2, 1)), np.linalg.inv(s["H"]))


@pytest.mark.parametrize("path", ["plain", "kernels"])
@pytest.mark.parametrize("with_ih, jitter", [(True, 0.0), (False, 0.0),
                                             (True, 1e-3)])
@pytest.mark.parametrize("M", [16, 30, 120])
def test_update_matches_hlax(request, M, with_ih, jitter, path):
    """natural_gradient_update (K7, the inverse factor, K8: two launches)
    against hlax's on the same inputs, with and without iH and jitter; on
    the kernel path written into the given (m, H) in place."""
    m, H, gm, gH, iH = _update_inputs(M, seed=M)
    j = jnp.asarray
    m_j, H_j = jelbo.natural_gradient_update(
        j(m), j(H), j(gm), j(gH), LR, iH=j(iH) if with_ih else None,
        jitter=jitter)
    calls = request.getfixturevalue("card") if path == "kernels" else None
    t = torch.tensor
    out = (t(m), t(H))
    m_t, H_t = telbo.natural_gradient_update(
        t(m), t(H), t(gm), t(gH), LR, iH=t(iH) if with_ih else None,
        jitter=jitter, out=out)
    assert m_t is out[0] and H_t is out[1]
    if calls is not None:
        assert [c[0] for c in calls] == ["natgrad_update_pre",
                                         "natgrad_update_finish"]
        assert calls[1][2][4] is out[0] and calls[1][2][5] is out[1]
        assert calls[0][2][-1] == jitter
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-8,
                               atol=1e-10)


def _f32_setup(seed):
    """test_torch_natgrad64.py's well-conditioned float32 case (M = 8,
    jitter 0.5, H = Hh Hh^T + 0.5 I) in this file's layout."""
    s = _setup(8, 5, seed)
    Hh = np.random.default_rng(seed).standard_normal((L, 8, 8)) / 3.0
    s["H"] = Hh @ Hh.transpose(0, 2, 1) + 0.5 * np.eye(8)
    s = {k: (np.asarray(v, np.float32) if isinstance(v, np.ndarray) else v)
         for k, v in s.items()}
    for k in ("k0", "k1"):
        s[k] = [{n: np.asarray(v, np.float32) for n, v in p.items()}
                for p in s[k]]
    return s


@pytest.mark.parametrize("path", ["plain", "kernels"])
def test_float64_chain_on_float32_inputs_matches_hlax(request, path):
    """nat_grad_dtype=float64 on a float32 bound and state: K5 reads float32
    and writes a float64 ng_P1, K6-K8 run in float64 and K8 casts to the
    float32 state; grad_m, grad_H, iH and the update within 1e-6 of hlax's
    (the float32 inputs' bar, ``test_torch_natgrad64.py``)."""
    s, eps = _f32_setup(4), 0.5
    j = jnp.asarray
    jp = lambda ps: [{k: j(v) for k, v in p.items()} for p in ps]
    _, gm_j, gH_j, iH_j = jelbo.kld_upper_bound(
        s["spec0"], jp(s["k0"]), s["spec1"], jp(s["k1"]), j(s["noise"]),
        j(s["m"]), j(s["H"]), j(s["zt"]), j(s["x"]), j(s["valid"]),
        j(s["mu"]), j(s["logv"]), P_TOT, N_TOT, eps, natural_gradient=True,
        use_pallas_chol=True, nat_grad_dtype=jnp.float64)
    calls = request.getfixturevalue("card") if path == "kernels" else None
    _, gm, gH, iH = _port_bound(s, torch.float32, torch.float64, eps)
    m_j, H_j = jelbo.natural_gradient_update(j(s["m"]), j(s["H"]), gm_j,
                                             gH_j, LR, iH=iH_j)
    m_t, H_t = telbo.natural_gradient_update(
        torch.tensor(s["m"]), torch.tensor(s["H"]), gm, gH, LR, iH=iH)
    assert gm.dtype == gH.dtype == iH.dtype == torch.float64
    assert m_t.dtype == H_t.dtype == torch.float32
    if calls is not None:
        z = [(c[0], c[2][0], c[2][1]) for c in calls]
        assert z == [("natgrad_fwd_subjects", 4, 8),
                     ("natgrad_fwd_latents", 8, 4),
                     ("natgrad_update_pre", 8, 4),
                     ("natgrad_update_finish", 8, 4)]
    for got, want in ((gm, gm_j), (gH, gH_j), (iH, iH_j), (m_t, m_j),
                      (H_t, H_j)):
        _hold(got, want, 1e-6, 1e-6)


def test_wrappers_dispatch():
    """A CPU tensor takes the plain version and counts nothing; a card's
    tensor in another dtype (bfloat16), or a pair of dtypes no kernel
    compiles, takes it and is counted in PLAIN_CUDA_CALLS."""
    ng.reset_counters()
    x = torch.zeros((2, 8, 8))
    assert not ng._takes("natgrad_fwd_latents", x)
    assert not any(ng.PLAIN_CUDA_CALLS.values())
    orig = ng._on_card
    ng._on_card = lambda t: True
    try:
        assert ng._takes("natgrad_fwd_latents", x)
        assert ng._takes("natgrad_fwd_latents", x.double(), other=x.dtype,
                         mixed=ng.MIXED_LATENTS)
        assert not ng._takes("natgrad_fwd_latents", x, other=torch.float64,
                             mixed=ng.MIXED_LATENTS)
        assert not ng._takes("natgrad_update_pre", x.bfloat16())
        assert not ng._takes("natgrad_update_finish", x, x.double())
    finally:
        ng._on_card = orig
    assert ng.PLAIN_CUDA_CALLS == {"natgrad_fwd_subjects_plain": 0,
                                   "natgrad_fwd_latents_plain": 1,
                                   "natgrad_update_pre_plain": 1,
                                   "natgrad_update_finish_plain": 1}
    assert not any(ng.LAUNCHES.values())
    ng.reset_counters()


def test_wrappers_launch_the_c_entries(card):
    """Each wrapper's launch: its C entry's parameter count (``card``), the
    itemsizes, the strip plans' rows and shared bytes, K8's plan; K5
    reading a mesh's slice of mu at its row stride, and iB mu from
    cuBLAS past TP rows; K8 writing the given (m, H), which must be
    contiguous in the state's dtype."""
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64)
    Ls, M = 3, 37
    fplan = ng.finish_plan(Ls, M, 8, ng.fusion.GP_SMS)
    for T in (5, 40):
        mu_all = r(S, T, 2 * Ls)
        mu = mu_all[..., Ls:]                 # a mesh rank's latents
        ng.fwd_subjects(r(Ls, S, T, T), mu, torch.ones(S, T).double(),
                        r(Ls, S, T, M), torch.float64)
        args = card[-1][2]
        assert args[:2] == (8, 8) and args[4].data_ptr() == mu.data_ptr()
        assert args[-8:-3] == (Ls, S, T, M, 2 * Ls)
        sp = ng.subjects_plan(Ls, S, T, M, 8, T <= ng.TP, ng.fusion.GP_SMS)
        assert args[-3:] == (sp.cluster, sp.chunk, sp.smem)
        assert (args[2] is None) == (T > ng.TP)
        if T > ng.TP:
            assert args[3].shape == (Ls, S, T)
    X, iK, iH = r(Ls, M, M), r(Ls, M, M), r(Ls, M, M)
    ng.latents(X, iK, iH, r(Ls, M, 1), r(Ls, M, 1).float())
    plan = ng.strip_plan(Ls, M, 8, 4, "natgrad_fwd_latents", ng.fusion.GP_SMS)
    assert card[-1][2][:2] == (8, 4)
    assert card[-1][2][-4:] == (Ls, M, plan.rows, plan.smem)
    ng.update_pre(iH, X, r(Ls, M, 1), r(Ls, M, 1), 0.01, 1e-3)
    plan = ng.strip_plan(Ls, M, 8, 8, "natgrad_update_pre", ng.fusion.GP_SMS)
    assert card[-1][2][-6:] == (Ls, M, plan.rows, plan.smem, 0.01, 1e-3)
    iLA = torch.linalg.cholesky(X @ X.mT + M * torch.eye(M, dtype=X.dtype))
    for out in ((torch.empty(Ls, M, 1), torch.empty(Ls, M, M)), None):
        got = ng.update_finish(iLA, r(Ls, M, 1), torch.float32, out)
        args = card[-1][2]
        assert args[:2] == (8, 4)
        assert args[-6:] == (Ls, M, fplan.cluster, fplan.warps, fplan.chunk,
                             fplan.smem)
        assert args[4] is got[0] and args[5] is got[1]
        if out is not None:
            assert got[0] is out[0] and got[1] is out[1]
    with pytest.raises(ValueError, match="contiguous"):
        ng.update_finish(iLA, r(Ls, M, 1), torch.float32,
                         (torch.empty(Ls, M, 1), torch.empty(Ls, M, M).mT))


def test_strip_plan_and_k5_grid_take_every_entry_once():
    """K6 and K7's blocks cover every (latent, row) of the [M, M] matrices
    once, a warp a 16-byte unit of rows; the plan gives half the SMs a
    block where one row a strip can; K5's blocks every (latent, subject
    row) once."""
    for L_, M in ((32, 120), (16, 120), (3, 37), (1, 1), (4, 512), (2, 33)):
        for sms in (132, 114):
            for kernel in ng.STRIP_ARRAYS:
                p = ng.strip_plan(L_, M, 4, 4, kernel, sms)
                assert 1 <= p.rows <= ng.RMAX and p.strips == -(-M // p.rows)
                assert p.blocks == L_ * p.strips
                assert 2 * p.blocks >= sms or p.rows == 1
                assert p.rows == ng.RMAX or \
                    2 * L_ * -(-M // (2 * p.rows)) < sms
                assert p.threads == 32 * -(-p.rows // 4)
                assert p.threads <= 32 * ng.STRIP_WARPS
                seen = np.zeros((L_, M), int)
                for lat in range(L_):
                    for b in range(p.strips):
                        seen[lat, b * p.rows:min(M, (b + 1) * p.rows)] += 1
                assert (seen == 1).all()
            sp = ng.subjects_plan(L_, 5, 20, M, 4, True, sms)
            rows = np.zeros((L_, 100), int)     # K5: (row share, latent)
            q = -(-100 // sp.cluster)
            for lat in range(L_):
                for c in range(sp.cluster):
                    rows[lat, c * q:(c + 1) * q] += 1
            assert (rows == 1).all()
            assert sp.cluster == max(1, min(ng.CLUSTER, (sms + ng.GPCS)
                                            // (L_ + ng.GPCS)))
    with pytest.raises(ValueError):
        ng.strip_plan(2, ng.MAX_M + 1, 4, 4, "natgrad_update_pre", 132)
    with pytest.raises(ValueError):
        ng.finish_plan(2, ng.MAX_M + 1, 4, 132)


def _butterfly(parts):
    """The order a warp's butterfly (``warp_sum``, csrc/natgrad.cu) adds
    its lanes' partials in: each lane's list of terms after the five
    levels (lane a: its own, then lane a ^ o's, at o = 16 .. 1)."""
    for o in (16, 8, 4, 2, 1):
        parts = [parts[a] + parts[a ^ o] for a in range(32)]
    return parts


def _strip_model(M, p, itemsize, aligned):
    """A model of K6's and K7's walk of one latent (the grid's y takes
    each latent alike) under plan ``p``: each block (strip of ``p.rows``
    rows from i0, ``p.threads`` threads) stages its box X[0:M, i0:i0 + nr]
    (grad_H's in K7) by ``copy_box``'s copies, checked here: 16-byte copies
    only where their source (a latent base on 16 bytes where ``aligned``)
    and their place in the box start on 16 bytes, consecutive threads on
    consecutive units of a piece, each of the box's entries once; warp w
    takes rows V w .. V w + V - 1 (V a 16-byte unit's entries), its lanes
    the columns lane, lane + 32, ..., each (row, column) once, each row's
    sum over the lanes by the butterfly, and reads its rows' transposed
    entries of box row j as one 16-byte unit, a quarter warp's eight rows
    j in distinct banks.  Returns the count of each (row, column) written
    and each row's sum order."""
    V, bw = 16 // itemsize, ng.box_stride(p.rows, itemsize)
    written = np.zeros((M, M), int)
    order = {}
    assert bw >= p.rows and (bw * itemsize) % 16 == 0
    assert (bw * itemsize // 16) % 2 == 1
    assert p.threads == 32 * -(-p.rows // V)
    for b in range(p.strips):
        i0 = b * p.rows
        nr = min(p.rows, M - i0)
        ok = aligned and (M * itemsize) % 16 == 0 and (i0 * itemsize) % 16 == 0
        units = nr // V if ok else 0
        tail = nr - units * V
        box = np.zeros((M, nr), int)
        if units:
            per = p.threads // units
            for t in range(per * units):
                u = t % units
                for j in range(t // units, M, per):
                    src, dst = j * M + i0 + u * V, j * bw + u * V
                    assert (src * itemsize) % 16 == 0
                    assert (dst * itemsize) % 16 == 0
                    box[j, u * V:(u + 1) * V] += 1
        if tail:
            per = p.threads // tail
            for t in range(per * tail):
                for j in range(t // tail, M, per):
                    box[j, units * V + t % tail] += 1
        assert (box == 1).all()
        for w in range(p.threads // 32):
            r0 = w * V
            if r0 >= nr:
                continue
            assert r0 + V <= bw
            # a quarter warp's 16-byte reads of its rows, eight rows j each
            for j0 in range(0, M, 8):
                units_read = [(j * bw + r0) * itemsize // 16 % 8
                              for j in range(j0, min(M, j0 + 8))]
                assert len(set(units_read)) == len(units_read)
            for r in range(r0, min(nr, r0 + V)):
                i = i0 + r
                lanes = [list(range(lane, M, 32)) for lane in range(32)]
                for js in lanes:
                    written[i, js] += 1
                sums = _butterfly(lanes)
                assert all(sorted(t) == sorted(sums[0]) for t in sums)
                order[i] = sums[0]
    return written, order


@pytest.mark.parametrize("itemsize, state_itemsize", [(4, 4), (8, 8),
                                                      (8, 4)])
@pytest.mark.parametrize("L_", [16, 32])
@pytest.mark.parametrize("M", [5, 16, 37, 120, 300, 512])
def test_strip_plans_write_each_entry_once(M, L_, itemsize, state_itemsize):
    """K6's and K7's plans in a model of their walk (``_strip_model``),
    their box's pieces aligned and not (a latent's base off 16 bytes):
    every (row, column) of a latent written once, every row sum taking
    each column once in the butterfly's fixed order, the box covering the
    strip's columns of every row once with 16-byte copies only where both
    ends are aligned, conflict-free reads of it; the threads a warp a
    16-byte unit of rows; the shared bytes the kernel's layout and within
    227 KB; the rows the most (at most RMAX) that give half the SMs
    a block and fit."""
    sms = ng.fusion.GP_SMS
    for kernel, (arrays, vecs) in ng.STRIP_ARRAYS.items():
        p = ng.strip_plan(L_, M, itemsize, state_itemsize, kernel, sms)
        assert p.smem == ng.strip_smem(p.rows, M, itemsize, state_itemsize,
                                       kernel)
        assert p.smem == (arrays * -(-p.rows * M * itemsize // 16) * 16
                          + -(-M * ng.box_stride(p.rows, itemsize)
                              * itemsize // 16) * 16
                          + -(-vecs * M * itemsize // 16) * 16
                          + -(-M * state_itemsize // 16) * 16)
        assert p.smem <= ng.SMEM_MAX
        assert p.blocks == L_ * p.strips
        assert p.threads == ng.strip_threads(p.rows, itemsize)
        assert p.threads <= 32 * ng.STRIP_WARPS
        wider = 2 * p.rows
        assert p.rows == ng.RMAX or 2 * L_ * -(-M // wider) < sms or \
            ng.strip_smem(wider, M, itemsize, state_itemsize, kernel) \
            > ng.SMEM_MAX
        for aligned in (True, False):
            written, order = _strip_model(M, p, itemsize, aligned)
            assert (written == 1).all()
            assert sorted(order) == list(range(M))
            for i, js in order.items():
                assert sorted(js) == list(range(M)), i


# [L, S, T, M, iB mu made by the kernel]: the canonical batch, a 2 x 2
# mesh rank's, the ragged toy, subjects past TP (T = 40, 200, 500: iB mu
# by cuBLAS), more rows than a stage holds, the largest M
SUBJECT_PLANS = [(32, 20, 20, 120, True), (16, 10, 20, 120, True),
                 (3, 7, 13, 37, True), (4, 3, 40, 37, False),
                 (32, 4, 200, 120, False), (32, 2, 500, 120, False),
                 (2, 400, 32, 120, True), (2, 5, 20, 512, True)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("L_, S_, T, M, own", SUBJECT_PLANS)
def test_subjects_plan_sums_each_entry_once(L_, S_, T, M, own, itemsize):
    """K5's plan in a model of its walk (``natgrad_fwd_subjects_kernel``):
    a latent's rows split over its cluster's blocks, q each; a block's rows
    in chunks, each chunk's iB mu made by the block (or read from cuBLAS's)
    and summed into every column; the blocks' column partials added by the
    column's owner in block order.  Every (latent, row) has its iB mu made
    once, every (latent, column, row) is summed once and every column
    finished once; the shared bytes fit beside the static ones."""
    p = ng.subjects_plan(L_, S_, T, M, itemsize, own, ng.fusion.GP_SMS)
    R = S_ * T
    assert 1 <= p.cluster <= ng.CLUSTER
    assert p.cluster == 1 or (p.cluster * L_ + ng.GPCS * (p.cluster - 1)
                              <= ng.fusion.GP_SMS)
    q = -(-R // p.cluster)
    assert p.stages == (1 if p.chunk >= q else 2) and 1 <= p.chunk <= q
    assert p.smem == ng.subjects_smem(p.chunk, p.stages, M, T, own,
                                      p.cluster, itemsize)
    assert p.smem + ng.SUBJECTS_STATIC <= ng.SMEM_MAX
    assert p.stages == 1 or ng.subjects_smem(
        q, 1, M, T, own, p.cluster, itemsize) + ng.SUBJECTS_STATIC > \
        ng.SMEM_MAX
    made = np.zeros(R, int)            # one latent's
    summed = np.zeros((M, R), int)
    finished = np.zeros(M, int)
    per = -(-M // p.cluster)
    for c in range(p.cluster):
        rbeg, rend = min(R, c * q), min(R, c * q + q)
        for r0 in range(rbeg, rend, p.chunk):
            nr = min(p.chunk, rend - r0)
            made[r0:r0 + nr] += 1
            summed[:, r0:r0 + nr] += 1
        finished[c * per:min(M, (c + 1) * per)] += 1
    assert (made == 1).all() and (summed == 1).all()
    assert (finished == 1).all()


def _finish_model(M, plan):
    """A model of K8's walk (``natgrad_update_finish_kernel``) under
    ``plan``: block c of the latent's cluster takes ``finish_tasks(c)`` in
    rounds of a task a warp, or a task's rows over the warps its row tile
    was dealt (its parts in order, k-steps of 8); a task's k run over its
    stage (one resident stage from row 32 c, or the
    ring's chunks of its round from row 32 I rounded down to a chunk),
    masked to k < M.  Returns ({(i, j): (the
    task, its k in order)} of the entries each task writes (i >= j, its
    mirror from the same value), {row: the j of each of m_new's terms, in
    the order they are added}, the tasks each block takes)."""
    cl, nw, KC = plan.cluster, plan.warps, plan.chunk
    Mk = -(-M // 8) * 8
    parts = []
    entries, terms = {}, {i: [[] for _ in range(cl)] for i in range(M)}
    per_block = []
    for c in range(cl):
        tasks = ng.finish_tasks(c, cl, M)
        per_block.append(len(tasks))
        tile_parts = ng.finish_parts(c, cl, M, nw, KC >= M)
        parts.append(tile_parts)
        part_of = dict(zip(range(c, -(-M // ng.TILE), cl), tile_parts))
        slots = [(t, q) for t in tasks for q in range(part_of[t[0]])]
        assert len(slots) <= nw or tile_parts == [1] * len(tile_parts)
        for r0 in range(0, len(slots), nw):
            rnd = [t for t, q in slots[r0:r0 + nw] if q == 0]
            k0r = ng.TILE * slots[r0][0][0] // KC * KC
            for I, J, h in rnd:
                P = part_of[I]
                if KC >= M:       # one stage, rows 32 c .. M, P parts
                    assert ng.TILE * I >= ng.TILE * c
                    n = -(-(Mk - ng.TILE * I) // (8 * P)) * 8
                    ks = []
                    for part in range(P):     # added in part order
                        kb = ng.TILE * I + part * n
                        ks += list(range(kb, min(Mk, kb + n)))
                else:
                    ks = []
                    for k0 in range(k0r, M, KC):
                        ks += list(range(max(k0, ng.TILE * I),
                                         min(k0 + KC, Mk)))
                ks = [k for k in ks if k < M]
                rows = range(ng.TILE * I, min(M, ng.TILE * I + ng.TILE))
                cols = range(ng.TILE * J + ng.HALF * h,
                             min(M, ng.TILE * J + ng.HALF * h + ng.HALF))
                for i in rows:
                    for j in cols:
                        if i >= j:
                            assert (i, j) not in entries
                            entries[(i, j)] = ((I, J, h),
                                               [k for k in ks if k >= i
                                                and k >= j])
                # the round's parts in task order: rows, then columns
                for i in rows:
                    terms[i][c] += [j for j in cols if j <= i]
                for j in cols:
                    terms[j][c] += [i for i in rows if i > j]
    # each row's owner adds the blocks' partials in block order
    return (entries, {i: sum(t, []) for i, t in terms.items()}, per_block,
            parts)


@pytest.mark.parametrize("L_, cluster", [(32, True), (4, True),
                                         (32, False)])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("M", [5, 16, 37, 120, 300, 512])
def test_finish_plan_sums_each_entry_once(M, itemsize, L_, cluster):
    """K8's plan in a model of its walk (``_finish_model``): each entry of
    H_new's lower triangle is one task's, summed over k = max(i, j) .. M - 1
    once each, ascending, and written with its mirror (so H_new is exactly
    symmetric), and the lower-triangle tasks take M^3 / 6 products where
    both triangles took M^3 / 3; each row of m_new adds H_new[i, j] rhs[j]
    once for every j; a latent's blocks one legal cluster; shared bytes
    within 227 KB, the whole latent in one stage where it fits (M <= 128),
    every warp busy there (a task's rows split), else a ring of two
    stages."""
    p = ng.finish_plan(L_, M, itemsize, ng.fusion.GP_SMS, cluster)
    NI = -(-M // ng.TILE)
    assert p.cluster == (ng.cluster_blocks(L_, ng.fusion.GP_SMS, NI)
                         if cluster else 1)
    assert 1 <= p.cluster <= min(ng.CLUSTER, NI)
    assert p.cluster == 1 or (p.cluster * L_ + ng.GPCS * (p.cluster - 1)
                              <= ng.fusion.GP_SMS)
    assert 1 <= p.warps <= ng.FINISH_WARPS
    assert p.smem == ng.finish_smem(M, p.chunk, p.warps, p.cluster, itemsize)
    assert p.smem + ng.FINISH_STATIC <= ng.SMEM_MAX
    assert (p.chunk >= M) == (M <= 128 or ng.finish_smem(
        M, M, ng.FINISH_WARPS, p.cluster, itemsize) + ng.FINISH_STATIC
        <= ng.SMEM_MAX)
    assert p.stages == (1 if p.chunk >= M else 2)
    assert p.chunk >= M or (p.chunk % 8 == 0 and p.chunk <= ng.FINISH_CHUNK)
    entries, terms, per_block, parts = _finish_model(M, p)
    if p.chunk >= M:
        # every block's tasks and their parts in one round, no part's
        # tile left that a spare warp could split further
        assert p.warps == ng.FINISH_WARPS
        for c, (n, tp) in enumerate(zip(per_block, parts)):
            tasks = ng.finish_tasks(c, p.cluster, M)
            per_tile = [len([t for t in tasks if t[0] == I])
                        for I in range(c, NI, p.cluster)]
            used = sum(a * b for a, b in zip(per_tile, tp))
            assert used <= p.warps or tp == [1] * len(tp)
            assert used > p.warps or min(per_tile) > p.warps - used
    else:
        assert p.warps == min(ng.FINISH_WARPS, max(per_block))
        assert all(tp == [1] * len(tp) for tp in parts)
    assert len(entries) == M * (M + 1) // 2
    for (i, j), (_, ks) in entries.items():
        assert ks == list(range(max(i, j), M))
    products = sum(len(ks) for _, ks in entries.values())
    assert products == sum((M - i) * (i + 1) for i in range(M))
    assert 6 * products <= M ** 3 + 6 * M * M
    for i, js in terms.items():
        assert sorted(js) == list(range(M)), i


def test_constants_match_the_kernels():
    """The wrapper's constants are csrc/natgrad.cu's, its shared bytes the
    kernels' (their formulas and static arrays), and its four kernels its C
    entries."""
    src = CSRC.read_text()
    for name, value in (("NT", ng.THREADS),
                        ("TP", ng.TP), ("CLUSTER", ng.CLUSTER),
                        ("RMAX", ng.RMAX), ("SWMAX", ng.STRIP_WARPS),
                        ("MAX_M", ng.MAX_M),
                        ("FT", ng.TILE), ("FH", ng.HALF),
                        ("FWMAX", ng.FINISH_WARPS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert sorted(_c_params()) == sorted(ng.KERNELS)
    assert sorted(ng.LAUNCHES) == sorted(f"{k}_cuda" for k in ng.KERNELS)
    # the dynamic bytes' formulas
    assert "return KC >= M ? (M + 7) / 8 * 8 : KC;" in src
    assert "return (KC >= M ? al16((long)finish_rows(M, KC) * M * z)" in src
    assert "+ (long)warps * FT * FH * 8" in src
    assert ": 2L * finish_rows(M, KC) * M * z)" in src
    assert "+ (long)cl * ((M + FT - 1) / FT * FT) * 8;" in src
    assert "return al16((long)stages * chunk * M * z)" in src
    assert ("+ (iB ? al16((long)chunk * Tn * z) + al16(((long)chunk + 2 * Tn)"
            " * 8)") in src
    assert "+ al16((long)chunk * 8) + (long)cl * M * 8;" in src
    # the static bytes: K5's partials and barriers, K8's
    for decl in ("__shared__ __align__(8) uint64_t bars[3];",
                 "__shared__ double red[NT];",
                 "__shared__ __align__(8) uint64_t bars[2];",
                 "__shared__ double rh[MAX_M], mpart[MAX_M];",
                 "__shared__ double rpart[FWMAX][FT], cpart[FWMAX][FH];",
                 "__shared__ int rtask[FWMAX], parts[FWMAX];"):
        assert src.count(decl) == 1, decl
    assert ng.SUBJECTS_STATIC == (ng.THREADS + 3) * 8
    assert ng.FINISH_STATIC == (2 * ng.MAX_M + ng.FINISH_WARPS * (
        ng.TILE + ng.HALF)) * 8 + 2 * ng.FINISH_WARPS * 4 + 2 * 8
    # K6's and K7's shared bytes and box
    assert "return ((R * z + 15) / 16 | 1) * 16 / z;" in src
    assert ("return rows * al16((long)R * M * z) + al16((long)M * "
            "box_stride(R, z) * z)") in src
    assert "+ al16((long)vecs * M * z) + al16((long)M * zs);" in src
    assert "strip_smem(rows, M, itemsize, state_itemsize, 3, 1)" in src
    assert "strip_smem(rows, M, itemsize, state_itemsize, 2, 2)" in src
    assert ng.STRIP_ARRAYS == {"natgrad_fwd_latents": (3, 1),
                               "natgrad_update_pre": (2, 2)}
    for kernel in ng.STRIP_ARRAYS:   # dynamic shared bytes only
        body = src[src.index(f"void __launch_bounds__(32 * SWMAX) {kernel}"
                             "_kernel("):]
        head = body[:body.index("NG_PHASE_BEGIN")]
        assert head.count("__shared__") == 1
        assert "extern __shared__ __align__(16) unsigned char smem_raw[];" \
            in head
    assert src.count("__launch_bounds__(32 * SWMAX)") == 2
    assert ("int strip_threads(int R, int z) { return 32 * ((R * z + 15) "
            "/ 16); }") in src
    assert ng.STRIP_WARPS == ng.strip_threads(ng.RMAX, 8) // 32
    assert src.count("__launch_bounds__(NT)") == 1
    assert src.count("__launch_bounds__(FT * FWMAX)") == 1
    # K8's products on the FP64 tensor cores
    assert "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64" in src
