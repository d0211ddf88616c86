"""The KL bound's terms op (``hlax_torch/ops/gp_bound.py``) on the CPU.

float64, inputs made with numpy from a seed; S = 5 subjects, of which one
padded (varying T) and one all padding; M = 16 and 30.  The op's plain
version inside ``kld_upper_bound`` against hlax's bound and ``jax.grad``
(the kernel parameters, the inducing points, the encoder outputs, and with
``natural_gradient=False`` m and H); the kernels' plain versions (what the
wrappers run on a CPU tensor: the kernels' arithmetic in torch operations)
against autograd of the op's plain version and ``gradcheck``; the terms
summed over a mesh's split, then assembled, against the one-process
``kld_total``; the launch plans; and the wrappers' launches recorded on the
CPU against the C entries of ``csrc/gp_bound.cu``.
"""
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hlax.gp import elbo as jelbo
from hlax.gp import kernels as jk
from hlax_torch.gp import elbo as telbo
from hlax_torch.gp import kernels as tk
from hlax_torch.ops import fusion
from hlax_torch.ops import gp_bound as gb

torch.set_num_threads(1)

S, T, L, Q = 5, 5, 6, 6
P_TOT, N_TOT, EPS = 20.0, 100.0, 1e-4
CSRC = Path(gb.__file__).resolve().parents[1] / "csrc" / "gp_bound.cu"

# canonical structure (configs/hlvae_config_file.txt) plus a bin factor
SPEC_ARGS = ([2], [5], [0],
             [{"cat_covariate": 3, "cont_covariate": 0},
              {"cat_covariate": 4, "cont_covariate": 1},
              {"cat_covariate": 2, "cont_covariate": 0}], [], [], 2)


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _setup(M, seed):
    """hlax's and the port's bound inputs (numpy): subject 3 padded after
    its third row, subject 4 all padding."""
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
    valid[3, 3:] = 0.0
    valid[4] = 0.0
    x = x * valid[:, :, None]
    rows = x.reshape(-1, Q)[valid.reshape(-1) > 0]
    zt = np.stack([rows[rng.choice(len(rows), M)] for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    Hh = rng.standard_normal((L, M, M)) / 3.0 + 0.7 * np.eye(M)
    return dict(spec0=spec0, spec1=spec1, k0=k0, k1=k1, x=x, valid=valid,
                zt=zt, m=rng.standard_normal((L, M, 1)), Hh=Hh,
                H=Hh @ Hh.transpose(0, 2, 1),
                mu=rng.standard_normal((S, T, L)) * valid[:, :, None],
                logv=0.3 * rng.standard_normal((S, T, L)) * valid[:, :, None],
                noise=np.ones(L))


def _kld_j(s, natgrad, k0, k1, zt, mu, logv, m, Hh):
    # H as the train step makes it: Adam's factor (``train/step.py``)
    # without natural gradients, else the state's H
    H = Hh if natgrad else Hh @ jnp.swapaxes(Hh, -1, -2)
    return jelbo.kld_upper_bound(
        s["spec0"], k0, s["spec1"], k1, jnp.asarray(s["noise"]), m, H, zt,
        jnp.asarray(s["x"]), jnp.asarray(s["valid"]), mu, logv, P_TOT, N_TOT,
        EPS, natural_gradient=natgrad, use_pallas_chol=True)[0]


@pytest.mark.parametrize("natgrad", [True, False])
@pytest.mark.parametrize("M", [16, 30])
def test_bound_with_terms_op_matches_hlax(M, natgrad):
    """``kld_upper_bound`` through the terms op (its plain version on the
    CPU) against hlax's: the bound at 1e-8 and its gradients to the kernel
    parameters, the inducing points, mu and log_v, and without natural
    gradients (Adam trains m and H's factor, H = Hh Hh^T) to m and Hh, at
    ``test_torch_gp.py``'s tolerances."""
    s = _setup(M, seed=M + int(natgrad))
    args_j = ([{k: jnp.asarray(v) for k, v in p.items()} for p in s["k0"]],
              [{k: jnp.asarray(v) for k, v in p.items()} for p in s["k1"]],
              *(jnp.asarray(s[k]) for k in ("zt", "mu", "logv", "m",
                                            "H" if natgrad else "Hh")))
    kld_j = _kld_j(s, natgrad, *args_j)
    argnums = (0, 1, 2, 3, 4) if natgrad else (0, 1, 2, 3, 4, 5, 6)
    grads_j = jax.grad(lambda *a: _kld_j(s, natgrad, *a),
                       argnums=argnums)(*args_j)

    t0, t1 = tk.build_kernel_specs(*SPEC_ARGS)
    tk0, tk1 = ([{k: _t(v).requires_grad_(True) for k, v in p.items()}
                 for p in s[key]] for key in ("k0", "k1"))
    zt, mu, logv, m, Hh = (_t(s[k]).requires_grad_(not natgrad or
                                                   k not in ("m", "H"))
                           for k in ("zt", "mu", "logv", "m",
                                     "H" if natgrad else "Hh"))
    H = Hh if natgrad else Hh @ Hh.mT
    kld_t = telbo.kld_upper_bound(
        t0, tk0, t1, tk1, _t(s["noise"]), m, H, zt, _t(s["x"]),
        _t(s["valid"]), mu, logv, P_TOT, N_TOT, EPS,
        natural_gradient=natgrad, use_pallas_chol=True)[0]
    np.testing.assert_allclose(kld_t.item(), float(kld_j), rtol=1e-8)
    kld_t.backward()
    flat_t = [v.grad for p in tk0 + tk1 for v in p.values()] \
        + [zt.grad, mu.grad, logv.grad] + ([] if natgrad else
                                           [m.grad, Hh.grad])
    gk0, gk1, *rest = grads_j
    flat_j = [pj[k] for pj, pt in zip(gk0 + gk1, tk0 + tk1) for k in pt] \
        + list(rest)
    assert len(flat_t) == len(flat_j)
    gmax = max(np.abs(np.asarray(w)).max() for w in flat_j)
    for got, want in zip(flat_t, flat_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-9 * gmax)


# ---- the kernels' plain versions (the wrappers on a CPU tensor) -------------

def _leaves(Ls, Ss, Ts, M, seed):
    """The op's 11 inputs and valid (float64, numpy from ``seed``):
    triangular factors with a positive diagonal, a padded subject and
    (with Ss > 2) an all-padding one."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape)
    tri = lambda *shape: (np.tril(n(*shape), -1)
                          + np.eye(shape[-1]) * rng.uniform(0.5, 1.5, shape[:-1] + (1,)))
    valid = np.ones((Ss, Ts))
    valid[0, Ts // 2:] = 0.0
    if Ss > 2:
        valid[-1] = 0.0
    leaves = [n(Ls, Ss, Ts, M), tri(Ls, Ss, Ts, Ts), tri(Ls, Ss, Ts, Ts),
              n(Ls, Ss, Ts, Ts), n(Ls, M, M), tri(Ls, M, M), tri(Ls, M, M),
              n(Ls, M, M), n(Ls, M, 1), n(Ss, Ts, Ls) * valid[..., None],
              0.3 * n(Ss, Ts, Ls)]
    return [_t(x) for x in leaves], _t(valid)


def _run(kernel, leaves, valid, w, need_hm=True, totals=(P_TOT, N_TOT)):
    """(terms, P_batch, kld_total, gradients of kld_total + w . terms) by
    the kernels' plain versions (``kernel``, through the op's autograd
    Function) or by autograd of the op's plain version."""
    xs = [x.clone().requires_grad_(need_hm or i not in (7, 8))
          for i, x in enumerate(leaves)]
    K0xz, iLB, LB, K0st, iK, LK, LH, H, m, mu, lv = xs
    iB = torch.einsum("lskt,lsku->lstu", iLB, iLB)
    if kernel:
        terms, pb, kld = gb._GpBound.apply(K0xz, iLB, LB, K0st, iK, LK, LH,
                                           H, m, mu, lv, iB.detach(), valid,
                                           totals)
    else:
        blk = SimpleNamespace(K0xz=K0xz, iB=iB, LB=LB, K0_st=K0st, iK0zz=iK,
                              LK0zz=LK)
        terms, pb = gb.kld_terms_plain(blk, LH, H, m, mu, lv, valid)
        kld = gb.assemble(terms, pb, *totals, K0xz.shape[0])
    wants = [x for x in xs if x.requires_grad]
    grads = torch.autograd.grad(kld + (terms * w).sum(), wants)
    return [terms.detach(), pb, kld.detach(), *grads]


@pytest.mark.parametrize("need_hm", [True, False])
@pytest.mark.parametrize("shape", [(3, 4, 5, 16), (2, 3, 20, 30),
                                   (2, 2, 33, 7), (3, 4, 40, 16)])
def test_kernel_plain_versions_against_autograd(shape, need_hm):
    """The four kernels' plain versions, forward (terms, P_batch,
    kld_total) and the hand-written backward (every input's gradient; H's
    and m's only where asked), against autograd of the op's plain version,
    at 1e-10 of each output's largest entry; T = 5 and 20 (staged on the
    card), 33 and 40 (past TP; 40 with a padded and an all-padding
    subject)."""
    leaves, valid = _leaves(*shape, seed=sum(shape))
    w = _t(np.linspace(-1.0, 1.0, 7))
    got = _run(True, leaves, valid, w, need_hm)
    want = _run(False, leaves, valid, w, need_hm)
    assert len(got) == len(want) == 14 - 2 * (not need_hm)
    assert got[1].item() == want[1].item() == shape[1] - (shape[1] > 2)
    for a, b in zip(got, want):
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10 * scale)


def test_kernel_plain_versions_gradcheck():
    """The hand-written backward against finite differences (gradcheck,
    float64) of the terms and kld_total, iB formed from iLB inside."""
    leaves, valid = _leaves(2, 3, 4, 5, seed=1)
    xs = [x.clone().requires_grad_(True) for x in leaves]

    def f(K0xz, iLB, LB, K0st, iK, LK, LH, H, m, mu, lv):
        iB = torch.einsum("lskt,lsku->lstu", iLB, iLB).detach()
        terms, _, kld = gb._GpBound.apply(K0xz, iLB, LB, K0st, iK, LK, LH,
                                          H, m, mu, lv, iB, valid,
                                          (P_TOT, N_TOT))
        return terms, kld

    assert torch.autograd.gradcheck(f, xs, eps=1e-6, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kernel", [False, True])
def test_terms_then_assembly_equal_one_process(kernel):
    """A 2 x 2 mesh's split (subjects by data rank, latents by latent
    rank): the blocks' terms summed over every rank, the inducing points'
    KL over the latent ranks, P_batch over the data ranks, then
    ``assemble``, equal the one-process kld_total (the op's plain version
    and the kernels' plain versions)."""
    leaves, valid = _leaves(4, 6, 5, 16, seed=7)
    full = _run(kernel, leaves, valid, torch.zeros(7))
    subj, lat = (slice(0, 3), slice(3, 6)), (slice(0, 2), slice(2, 4))
    blocks = kqu = pb = 0.0
    for si, s in enumerate(subj):
        for li, l in enumerate(lat):
            part = [x[l] for x in leaves[:9]]
            part[0], part[1], part[2], part[3] = (x[:, s] for x in part[:4])
            part += [leaves[9][s][..., l], leaves[10][s][..., l]]
            xs = [x.contiguous() for x in part]
            K0xz, iLB, LB, K0st, iK, LK, LH, H, m, mu, lv = xs
            iB = torch.einsum("lskt,lsku->lstu", iLB, iLB)
            if kernel:
                terms, p, kld = gb._GpBound.apply(
                    K0xz, iLB, LB, K0st, iK, LK, LH, H, m, mu, lv, iB,
                    valid[s].contiguous(), None)
                assert kld is None
            else:
                blk = SimpleNamespace(K0xz=K0xz, iB=iB, LB=LB, K0_st=K0st,
                                      iK0zz=iK, LK0zz=LK)
                terms, p = gb.kld_terms_plain(blk, LH, H, m, mu, lv,
                                              valid[s])
            blocks = blocks + terms[:6]
            if si == 0:
                kqu = kqu + terms[6]
            if li == 0:
                pb = pb + p
    kld = gb.assemble(torch.cat([blocks, kqu[None]]), pb, P_TOT, N_TOT, 4)
    assert pb.item() == full[1].item() == 5
    torch.testing.assert_close(kld, full[2], rtol=1e-12, atol=0)


# ---- the launch plans and the wrappers' launches ------------------------------

@pytest.mark.parametrize("sms", [132, 114])
def test_launch_plans(sms):
    """The plans as pure functions of the shapes and the SM count: a
    subject a block while the (latent, subject) blocks fill the card once,
    more a block past it, every subject in one chunk; each latent's rows in
    parts covering every row once, about LATENT_BLOCKS_PER_SM blocks an SM,
    their shared bytes within SMEM_MAX (the canonical latents: 9 parts of
    14 rows, 288 blocks)."""
    assert gb.subject_plan(32, 20, 20, 120, 4, sms)[:3] == (1, 20, True)
    for Ls, Ss, Ts in ((32, 20, 20), (16, 10, 20), (32, 4, 200),
                       (64, 200, 20), (1, 1, 33)):
        for z in (4, 8):
            p = gb.subject_plan(Ls, Ss, Ts, 120, z, sms)
            assert (p.chunks - 1) * p.chunk < Ss <= p.chunks * p.chunk
            assert p.chunk == 1 or Ls * p.chunks <= \
                gb.SUBJECT_BLOCKS_PER_SM * sms + Ls
            assert p.staged == (Ts <= gb.TP)
            assert p.smem_fwd < p.smem_bwd <= gb.SMEM_MAX or not p.staged
            assert p.smem_bwd == gb.subject_smem(3, p.staged, Ts, 120, z)
    # a staged K3 of [32, 120] in float: K0xz, K0xz [G | G^T], iB, iLB,
    # K0_st, (K0xz G) K0xz^T and the symmetric cotangent, r, q, iKm, the
    # rows' scalars
    assert gb.subject_smem(3, True, 32, 120, 4) == 4 * (
        32 * 120 * 3 + 3 * 32 * 32 + 2 * 32 * 33 + 64 + 120 + 96)
    assert not gb.subject_plan(1, 1, 32, 512, 8, sms).staged
    for Ls, M, z in ((32, 120, 4), (32, 120, 8), (16, 120, 4), (3, 37, 8),
                     (1, 512, 8), (264, 7, 4)):
        p = gb.latent_plan(Ls, M, z, sms)
        assert (p.parts - 1) * p.rows < M <= p.parts * p.rows
        assert p.smem_bwd <= gb.SMEM_MAX and p.smem_fwd < p.smem_bwd
        assert p.smem_fwd == p.rows * (M + 1) * z
    assert gb.latent_plan(32, 120, 4, 132)[:2] == (14, 9)
    assert gb.latent_plan(264, 7, 4, 132)[:2] == (7, 1)
    assert gb.latent_plan(1, 512, 8, 132)[:2] == (2, 256)


def _c_params():
    """{entry: number of parameters} of csrc/gp_bound.cu's C entries."""
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)',
                         CSRC.read_text()):
        out[m.group(1)] = len([p for p in m.group(2).split(",") if p.strip()])
    return out


def test_constants_match_the_kernels():
    """The wrapper's constants are csrc/gp_bound.cu's."""
    src = CSRC.read_text()
    for name, value in (("NT", gb.THREADS), ("NSUB", gb.NSUB),
                        ("NLAT", gb.NLAT), ("NTERM", gb.NTERM)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "MAX_M = 2 * NT;" in src and gb.MAX_M == 2 * gb.THREADS
    assert f"constexpr int TP = {gb.TP}," in src


@pytest.mark.parametrize("Ts", [5, 40])
@pytest.mark.parametrize("need_hm", [True, False])
@pytest.mark.parametrize("totals", [(P_TOT, N_TOT), None])
def test_wrappers_launch_the_c_entries(monkeypatch, totals, need_hm, Ts):
    """The op's autograd Function on CPU tensors as on the card: four
    launches (forward: subjects, then latents; backward: latents, then
    subjects), each with its C entry's parameter count (the stream last),
    the plans' grids and shared bytes, a null kld_total on a mesh (no
    ``totals``) and null H and m cotangents where they need none; at T = 40
    (past TP) the subject kernels unstaged, the subjects' products by
    cuBLAS around them."""
    params, calls = _c_params(), []
    assert sorted(params) == sorted(k.removesuffix("_cuda")
                                    for k in gb.LAUNCHES)

    def launch(entry, like, *args):
        assert len(args) + 1 == params[entry], (entry, len(args))
        calls.append((entry, args))

    monkeypatch.setattr(gb, "_launch", launch)
    monkeypatch.setattr(gb, "_on_card", lambda t: True)
    monkeypatch.setattr(fusion, "_sm_count", lambda index: 132)
    monkeypatch.setattr(fusion, "_counters",
                        lambda like, n: torch.zeros(n, dtype=torch.int32))
    leaves, valid = _leaves(3, 4, Ts, 16, seed=2)
    xs = [x.clone().requires_grad_(need_hm or i not in (7, 8))
          for i, x in enumerate(leaves)]
    iB = torch.einsum("lskt,lsku->lstu", xs[1], xs[1]).detach()
    terms, pb, kld = gb._GpBound.apply(*xs, iB, valid, totals)
    assert (kld is None) == (totals is None)
    out = terms.sum() if kld is None else kld
    torch.autograd.grad(out, [x for x in xs if x.requires_grad])
    assert [c[0] for c in calls] == ["gp_bound_fwd_subjects",
                                     "gp_bound_fwd_latents",
                                     "gp_bound_bwd_latents",
                                     "gp_bound_bwd_subjects"]
    sp = gb.subject_plan(3, 4, Ts, 16, 8, 132)
    lp = gb.latent_plan(3, 16, 8, 132)
    assert sp.staged == (Ts <= gb.TP)
    fwd_s, fwd_l, bwd_l, bwd_s = (c[1] for c in calls)
    assert fwd_s[0] == 8 and fwd_s[-8:] == (3, 4, Ts, 16, 3, sp.chunk,
                                            int(sp.staged), sp.smem_fwd)
    assert fwd_s[10] is None and fwd_s[11] is None    # float64: no copies
    assert fwd_s[14].shape == (3, sp.chunks, gb.NSUB + 16)
    assert fwd_l[11] == sp.chunks and fwd_l[-4] == lp.rows
    assert fwd_l[-1] == lp.smem_fwd and (fwd_l[16] is None) == (
        totals is None)
    assert bwd_l[2] is None if totals is None else bwd_l[1] is None
    assert bwd_l[-2:] == (lp.rows, lp.smem_bwd)
    assert (bwd_l[16] is None) == (bwd_l[19] is None) == (not need_hm)
    assert (bwd_l[20] is None) == (not need_hm)
    assert bwd_s[-8:] == (3, 4, Ts, 16, 3, sp.chunk, int(sp.staged),
                          sp.smem_bwd)
    assert bwd_s[15].shape == (3, 4 * Ts, 32)       # K0xz [G | G^T]
