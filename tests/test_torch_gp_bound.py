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


def _setup(M, seed, S=S, T=T, L=L, distinct=False):
    """hlax's and the port's bound inputs (numpy): subject S - 2 padded
    after its third row, subject S - 1 all padding; the inducing points
    valid rows, ``distinct`` ones or drawn with repeats, each time moved."""
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
    valid[S - 2, 3:] = 0.0
    valid[S - 1] = 0.0
    x = x * valid[:, :, None]
    rows = x.reshape(-1, Q)[valid.reshape(-1) > 0]
    zt = np.stack([rows[rng.choice(len(rows), M, replace=not distinct)]
                   for _ in range(L)])
    zt[:, :, 0] += rng.uniform(-0.5, 0.5, (L, M))
    Hh = rng.standard_normal((L, M, M)) / 3.0 + 0.7 * np.eye(M)
    return dict(spec0=spec0, spec1=spec1, k0=k0, k1=k1, x=x, valid=valid,
                zt=zt, m=rng.standard_normal((L, M, 1)), Hh=Hh,
                H=Hh @ Hh.transpose(0, 2, 1),
                mu=rng.standard_normal((S, T, L)) * valid[:, :, None],
                logv=0.3 * rng.standard_normal((S, T, L)) * valid[:, :, None],
                noise=np.ones(L))


def _kld_j(s, natgrad, k0, k1, zt, mu, logv, m, Hh, eps=EPS):
    # H as the train step makes it: Adam's factor (``train/step.py``)
    # without natural gradients, else the state's H
    H = Hh if natgrad else Hh @ jnp.swapaxes(Hh, -1, -2)
    return jelbo.kld_upper_bound(
        s["spec0"], k0, s["spec1"], k1, jnp.asarray(s["noise"]), m, H, zt,
        jnp.asarray(s["x"]), jnp.asarray(s["valid"]), mu, logv, P_TOT, N_TOT,
        eps, natural_gradient=natgrad, use_pallas_chol=True)[0]


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


# canonical conditioning (configs/hlvae_config_file.txt: M = 120, T = 20,
# jitter 1e-6) on a few subjects (one padded, one all padding) and latents
ULP_SHAPE, ULP_EPS, ULP_SEEDS = dict(S=8, T=20, L=3), 1e-6, (1, 2)


def test_float64_one_ulp_sensitivity_of_hlax():
    """How far hlax's own float64 bound and its ``jax.grad`` move when every
    real input (the kernel parameters, the inducing points' real
    covariates, mu, log_v, m and H) moves by one unit in the last place (a
    random sign an entry, the
    largest over ULP_SEEDS), at canonical conditioning; the port's plain
    version against hlax's within 4x that movement, output by output (the
    bar the card's float64 kernels are held to against the plain version).
    Prints each output's movement and the port's difference."""
    s = _setup(120, 5, **ULP_SHAPE, distinct=True)
    rng = np.random.default_rng(0)
    leaves = ([{k: np.asarray(v, np.float64) for k, v in p.items()}
               for p in s["k0"]],
              [{k: np.asarray(v, np.float64) for k, v in p.items()}
               for p in s["k1"]],
              *(np.asarray(s[k], np.float64)
                for k in ("zt", "mu", "logv", "m", "H")))
    f = jax.jit(jax.value_and_grad(
        lambda *a: _kld_j(s, True, *a, eps=ULP_EPS), argnums=(0, 1, 2, 3, 4)))

    def flat(out):
        value, (g0, g1, *rest) = out
        return [np.asarray(value)] + [np.asarray(p[k]) for p in g0 + g1
                                      for k in sorted(p)] + \
            [np.asarray(g) for g in rest]

    def run(ls):
        return flat(f(*jax.tree_util.tree_map(jnp.asarray, ls)))

    base = run(leaves)
    move = [0.0] * len(base)
    # the inducing points' real covariates (time, the continuous one); their
    # id and categorical columns are labels the kernels compare for equality
    real = np.zeros(leaves[2].shape, bool)
    real[..., :2] = True
    for seed in ULP_SEEDS:
        g = np.random.default_rng(seed)
        ulp = lambda v: v * (1 + np.finfo(np.float64).eps
                             * g.choice([-1.0, 1.0], np.shape(v)))
        moved = jax.tree_util.tree_map(ulp, leaves)
        moved[2][~real] = leaves[2][~real]
        moved = run(moved)
        assert all(np.isfinite(b).all() for b in moved)
        move = [max(a, np.abs(b - c).max()) for a, b, c in
                zip(move, moved, base)]
    assert all(np.isfinite(b).all() for b in base)

    t0, t1 = tk.build_kernel_specs(*SPEC_ARGS)
    tk0, tk1 = ([{k: _t(v).requires_grad_(True) for k, v in p.items()}
                 for p in lv] for lv in leaves[:2])
    zt, mu, logv = (_t(v).requires_grad_(True) for v in leaves[2:5])
    kld = telbo.kld_upper_bound(
        t0, tk0, t1, tk1, _t(s["noise"]), _t(leaves[5]), _t(leaves[6]), zt,
        _t(s["x"]), _t(s["valid"]), mu, logv, P_TOT, N_TOT, ULP_EPS,
        natural_gradient=True, use_pallas_chol=True)[0]
    kld.backward()
    port = [kld.detach().numpy()] + [p[k].grad.numpy() for p in tk0 + tk1
                                     for k in sorted(p)] + \
        [zt.grad.numpy(), mu.grad.numpy(), logv.grad.numpy()]
    names = ["kld"] + [f"d k{j}[{i}].{k}" for j, ps in enumerate(leaves[:2])
                       for i, p in enumerate(ps) for k in sorted(p)] + \
        ["d zt", "d mu", "d log_v"]
    assert len(port) == len(base) == len(names)
    for name, a, b, m in zip(names, port, base, move):
        scale = np.abs(b).max()
        err = np.abs(a - b).max()
        print(f"hlax float64 one-ulp movement {name}: {m:.3e} "
              f"({m / scale:.2e} of the largest entry {scale:.3e}); the "
              f"port's plain version against hlax {err:.3e} "
              f"({err / m if m else float('inf'):.2f}x the movement)")
        assert err <= max(4 * m, 1e-13 * scale), (name, err, m, scale)


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

# [L, S, T, M]: the canonical batch, a 2 x 2 mesh rank's, the card tests'
# ragged shape, the long sequences' T = 200 and T = 500 batches
PLAN_SHAPES = [(32, 20, 20, 120), (16, 10, 20, 120), (3, 7, 13, 37),
               (32, 4, 200, 120), (32, 2, 500, 120)]


@pytest.mark.parametrize("sms", [132, 114])
def test_launch_plans(sms):
    """The plans as pure functions of the shapes and the SM count: staged,
    as many blocks as the SMs hold at once (the launch bounds' blocks an SM
    within the shared memory an SM has), at most one a subject; longer
    subjects in row tiles (multiples of 32 rows, at most MAX_TILES, K1's
    cluster), K1's partials S x tiles rows a latent; each latent's [M, M]
    matrices in square tiles of LATENT_TILE, their pairs (mirrored ones,
    then the diagonal tiles two at a time) walked by as many blocks as the
    SMs hold at once (LATENT_BLOCKS_PER_SM), at most one a pair, their
    shared bytes within SMEM_MAX (the canonical latents: 4 tiles a side, 8
    pairs a latent, 256 blocks)."""
    p = gb.subject_plan(32, 20, 20, 120, 4, sms)
    assert p[:6] == (True, 2 * sms, 2 * sms, 20, 1, 20)
    assert gb.subject_plan(32, 20, 20, 120, 8, sms)[:3] == (True, 2 * sms,
                                                            2 * sms)
    assert gb.subject_plan(16, 10, 20, 120, 4, sms)[1:3] == (160, 160)
    assert gb.subject_plan(32, 4, 200, 120, 4, sms)[:6] == (
        False, 7 * 128, 7 * 128, 32, 7, 28)
    assert gb.subject_plan(32, 2, 500, 120, 8, sms)[:6] == (
        False, 8 * 64, 8 * 64, 64, 8, 16)
    for Ls, Ss, Ts in ((32, 20, 20), (16, 10, 20), (32, 4, 200),
                       (64, 200, 20), (1, 1, 33), (32, 2, 500)):
        for z in (4, 8):
            p = gb.subject_plan(Ls, Ss, Ts, 120, z, sms)
            assert p.staged == (Ts <= gb.TP)
            assert p.parts == Ss * p.tiles
            assert p.smem_fwd == gb.subject_smem(1, p.staged, Ts, 120, z,
                                                 p.rows)
            assert p.smem_bwd == gb.subject_smem(3, p.staged, Ts, 120, z,
                                                 p.rows)
            assert max(p.smem_fwd, p.smem_bwd) <= gb.SMEM_MAX
            if p.staged:
                for blocks, smem in ((p.blocks_fwd, p.smem_fwd),
                                     (p.blocks_bwd, p.smem_bwd)):
                    on_sm = min(gb.SUBJECT_BLOCKS_PER_SM,
                                gb.SMEM_SM // (smem + gb.SMEM_BLOCK))
                    assert on_sm >= 1 and on_sm * (smem + 1024) <= \
                        gb.SMEM_SM
                    assert blocks == min(Ls * Ss, on_sm * sms)
            else:
                assert p.rows % 32 == 0 and p.tiles <= gb.MAX_TILES
                assert (p.tiles - 1) * p.rows < Ts <= p.tiles * p.rows
                assert p.blocks_fwd == p.blocks_bwd == p.tiles * Ls * Ss
    # a staged K3 of [32, 120] in float: two stages of K0xz G, iB, iLB,
    # K0_st, iKm's row, r, q and the rows' valid, log_v, LB diagonal; K0xz,
    # K0xz G^T, (K0xz G) K0xz^T and the symmetric cotangent
    assert gb.subject_smem(3, True, 32, 120, 4) == 4 * (
        2 * (32 * 120 + 3 * 32 * 32 + 120 + 5 * 32) + 2 * 32 * 120
        + 2 * 32 * 33)
    assert not gb.subject_plan(1, 1, 32, 512, 8, sms).staged
    assert gb.subject_plan(1, 1, 32, 120, 8, sms).staged      # 189 KB
    with pytest.raises(ValueError):
        gb.subject_plan(1, 1, 8 * 256 + 1, 16, 4, sms)
    lt = gb.LATENT_TILE
    for Ls, M, z in ((32, 120, 4), (32, 120, 8), (16, 120, 4), (3, 37, 8),
                     (1, 512, 8), (264, 7, 4)):
        p = gb.latent_plan(Ls, M, z, sms)
        assert (p.tiles - 1) * lt < M <= p.tiles * lt
        assert p.pairs == (p.tiles * (p.tiles - 1) // 2
                           + (p.tiles + 1) // 2)
        assert p.blocks == min(Ls * p.pairs, gb.LATENT_BLOCKS_PER_SM * sms)
        assert p.smem_fwd == gb.latent_smem(2, z) == (
            2 * lt * (lt + 1) * z + 4 * lt * lt * z + 2 * lt * lt * 8)
        assert p.smem_bwd == gb.latent_smem(4, z) == (
            6 * lt * (lt + 1) * z + 6 * lt * lt * z)
        assert p.smem_bwd <= gb.SMEM_MAX
        # the blocks an SM the plan counts on fit its shared memory
        assert gb.LATENT_BLOCKS_PER_SM * (
            max(p.smem_fwd, p.smem_bwd) + gb.SMEM_BLOCK) <= gb.SMEM_SM
    assert gb.latent_plan(32, 120, 4, 132) == (4, 8, 256, 41216, 49920)
    assert gb.latent_plan(32, 120, 8, 132) == (4, 8, 256, 66048, 99840)
    assert gb.latent_plan(32, 120, 4, 114) == (4, 8, 228, 41216, 49920)
    assert gb.latent_plan(264, 7, 4, 132)[:3] == (1, 1, 264)
    assert gb.latent_plan(1, 512, 8, 132)[:3] == (16, 128, 128)


def _ring_takes(n, blocks, seed):
    """The subjects each of ``blocks`` staged blocks computes, as csrc's
    ``ring`` takes them, the blocks' turns in a random order from ``seed``:
    block b starts with subject b, takes its next one from the queue (past
    the grid's first) part way through each subject, and stops at the
    first taken past n."""
    rng, queue = np.random.default_rng(seed), blocks
    held, done = [[b] for b in range(blocks)], [[] for _ in range(blocks)]
    live = list(range(blocks))
    while live:
        b = live[rng.integers(len(live))]
        i = held[b].pop(0)
        if i >= n:
            live.remove(b)
            continue
        done[b].append(i)
        held[b].append(queue)
        queue += 1
    return done


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_subject_plans_take_every_subject_once(shape, sms):
    """Every (latent, subject) computed by exactly one staged block, in
    any order the blocks' turns come (the ring's queue), each block's in
    rising order; the partials a subject's row each (row l S + s), so their
    order depends only on the shapes; a longer subject's every row in
    exactly one row tile, K1's partials S x tiles rows a latent; the rings'
    and tiles' shared bytes within SMEM_MAX in float and double."""
    L, S, T, M = shape
    for z in (4, 8):
        p = gb.subject_plan(L, S, T, M, z, sms)
        assert max(p.smem_fwd, p.smem_bwd) <= gb.SMEM_MAX
        if p.staged:
            assert p.parts == S and p.tiles == 1 and p.rows == T
            for blocks in (p.blocks_fwd, p.blocks_bwd):
                for seed in range(3):
                    done = _ring_takes(L * S, blocks, seed)
                    assert sorted(i for d in done for i in d) == \
                        list(range(L * S))
                    assert all(d == sorted(d) for d in done)
            continue
        rows = [t for tile in range(p.tiles)
                for t in range(tile * p.rows, min(T, (tile + 1) * p.rows))]
        assert rows == list(range(T))
        assert p.parts == S * p.tiles


def _tile_chunk(z, t, q):
    """csrc's ``tile_chunk``: chunk q of thread t (numpy arrays) of a
    latent tile, its row and first column (16 // z entries a chunk)."""
    if z == 4:
        return t >> 3, 4 * (t & 7)
    lane = t & 31
    return (4 * (t >> 5) + 2 * q + ((lane >> 3) & 1),
            2 * ((lane & 7) + 8 * (lane >> 4)))


def _tile_at(z, s, c):
    """csrc's ``tile_at``: a staged tile's entry (s, c)."""
    ce = 16 // z
    return s * gb.LATENT_TILE + ce * (s // ce) + c


def _pair_tiles(p, nt):
    """csrc's ``PairTile``: the tiles (row tile, column tile) of pair p of
    a latent's, mirrored pairs (I, J), (J, I), I < J, row by row, then the
    diagonal tiles two at a time."""
    noff = nt * (nt - 1) // 2
    if p < noff:
        i = 0
        while p >= nt - 1 - i:
            p -= nt - 1 - i
            i += 1
        return [(i, i + 1 + p), (i + 1 + p, i)]
    d = 2 * (p - noff)
    return [(a, a) for a in (d, d + 1) if a < nt]


def _latent_walk(L, M, z, plan, nchunks):
    """The entries of L latents' [M, M] matrices K2's and K4's blocks take
    (counts [L, M, M]), as csrc's kernels walk them: block b the pairs b, b
    + blocks, ... of the L pairs a latent, each pair's tiles
    (``_pair_tiles``), each thread its chunks of 16 // z entries a row
    (``tile_chunk``), cut at M; and the rows of u (counts [L, M]) and of
    K1's partials (counts [L, nchunks]) K2's pairs take."""
    lt, ce = gb.LATENT_TILE, 16 // z
    t = np.arange(gb.THREADS)
    chunks = [_tile_chunk(z, t, q) for q in range(lt * lt // ce
                                                  // gb.THREADS)]
    seen = np.zeros((L, M, M), int)
    rows, parts = np.zeros((L, M), int), np.zeros((L, nchunks), int)
    rpp, cpp = -(-M // plan.pairs), -(-nchunks // plan.pairs)
    for b in range(plan.blocks):
        for w in range(b, L * plan.pairs, plan.blocks):
            l, p = divmod(w, plan.pairs)
            for r0, c0 in _pair_tiles(p, plan.tiles):
                nr, nc = min(lt, M - lt * r0), min(lt, M - lt * c0)
                for r, c in chunks:
                    on = (r < nr) & (c < nc)
                    for k in range(ce):
                        at = on & (c + k < nc)
                        np.add.at(seen[l], (lt * r0 + r[at],
                                            lt * c0 + c[at] + k), 1)
            rows[l, p * rpp:(p + 1) * rpp] += 1
            parts[l, p * cpp:(p + 1) * cpp] += 1
    return seen, rows, parts


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("L, M, nchunks", [(32, 120, 20), (16, 120, 10),
                                           (3, 37, 7), (1, 512, 3),
                                           (264, 7, 28)])
def test_latent_plans_take_every_entry_once(L, M, nchunks, sms):
    """Every entry of each latent's [M, M] matrices taken by exactly one
    block of K2's and K4's walk (a model of the kernels' tiles, pairs and
    chunks), every row of u and of K1's partials by one pair, in float and
    double, the shared bytes within SMEM_MAX; the staged tiles' rows
    16-byte aligned, and a warp's reads down a mirrored tile's column
    (each k-th entry of its chunks) in distinct banks: 32 four-byte banks
    for the 32 lanes in float, a half-warp's 16 pairs of banks in
    double."""
    lt = gb.LATENT_TILE
    for z in (4, 8):
        p = gb.latent_plan(L, M, z, sms)
        assert p.smem_bwd <= gb.SMEM_MAX
        seen, rows, parts = _latent_walk(L, M, z, p, nchunks)
        assert (seen == 1).all()
        assert (rows[:, :M] == 1).all() and (parts == 1).all()
        ce = 16 // z
        t = np.arange(gb.THREADS)
        for q in range(lt * lt // ce // gb.THREADS):
            r, c = _tile_chunk(z, t, q)
            assert (_tile_at(z, r, c) * z % 16 == 0).all()
            for k in range(ce):
                at = _tile_at(z, c + k, r)
                for w in range(gb.THREADS // 32):
                    lanes = at[32 * w:32 * (w + 1)]
                    if z == 4:
                        assert len(set(lanes % 32)) == 32
                    else:
                        for h in (lanes[:16], lanes[16:]):
                            assert len(set(h % 16)) == 16
        assert lt * (lt + 1) * z % 16 == 0


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
    assert (f"constexpr int NSTAGE = {gb.NSTAGE}, MAX_TILES = "
            f"{gb.MAX_TILES}, TILE_BLOCKS = 3;") in src
    n = gb.SUBJECT_BLOCKS_PER_SM
    assert (f"constexpr int FWD_SUBJECT_BLOCKS = {n}, BWD_SUBJECT_BLOCKS = "
            f"{n};") in src
    assert "__launch_bounds__(NT, FWD_SUBJECT_BLOCKS)" in src
    assert "__launch_bounds__(NT, BWD_SUBJECT_BLOCKS)" in src
    assert src.count("__launch_bounds__(NT, TILE_BLOCKS)") == 2
    assert (f"constexpr int LW = {gb.LATENT_TILE}, TILE_ELEMS = LW * (LW + "
            "1);") in src
    assert (f"constexpr int LATENT_BLOCKS = {gb.LATENT_BLOCKS_PER_SM};"
            in src)
    assert src.count("__launch_bounds__(NT, LATENT_BLOCKS)") == 2
    assert "constexpr int NBLK = NSUB + NLAT + 1;" in src
    assert ("return k == 2 ? 2 * tile + 4 * own + 2 * LW * LW * 8 : 6 * "
            "tile + 6 * own;") in src


def _c_stage_bytes(name, T, M, z):
    """csrc/gp_bound.cu's ``name`` (fwd_stage, bwd_stage) at (T, M, z),
    its a16 sums read from the source and evaluated."""
    body = re.search(rf"inline int {name}\(int Tn, int M, int z\) {{\s*"
                     r"return ([^;]*);", CSRC.read_text()).group(1)
    expr = re.sub(r"\(long\)|L \*", lambda m: "" if m.group(0) == "(long)"
                  else " *", body)
    return eval(f"({expr})", {"a16": gb._a16, "Tn": T, "M": M, "z": z})


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_ring_bytes_match_the_kernels(shape):
    """The stages' bytes (FwdStage, BwdStage) and every plan's shared bytes
    are csrc/gp_bound.cu's, within SMEM_MAX, in float and double."""
    L, S, T, M = shape
    for z in (4, 8):
        assert _c_stage_bytes("fwd_stage", T, M, z) == gb.fwd_stage(T, M, z)
        assert _c_stage_bytes("bwd_stage", T, M, z) == gb.bwd_stage(T, M, z)
        p = gb.subject_plan(L, S, T, M, z, 132)
        assert max(p.smem_fwd, p.smem_bwd) <= gb.SMEM_MAX


@pytest.mark.parametrize("Ts", [5, 40, 200])
@pytest.mark.parametrize("need_hm", [True, False])
@pytest.mark.parametrize("totals", [(P_TOT, N_TOT), None])
def test_wrappers_launch_the_c_entries(monkeypatch, totals, need_hm, Ts):
    """The op's autograd Function on CPU tensors as on the card: four
    launches (forward: subjects, then latents; backward: latents, then
    subjects), each with its C entry's parameter count (the stream last),
    the plans' grids and shared bytes, K1's partials a subject's tiles
    each and K2 reading that many, a null kld_total on a mesh (no
    ``totals``) and null H and m cotangents where they need none; at T = 40
    and 200 (past TP) the subject kernels in row tiles, the subjects'
    products by cuBLAS around them (K3 writing ``sym``), staged no
    ``sym``."""
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
    assert sp.tiles == {5: 1, 40: 2, 200: 7}[Ts]
    fwd_s, fwd_l, bwd_l, bwd_s = (c[1] for c in calls)
    assert fwd_s[0] == 8 and fwd_s[-9:] == (3, 4, Ts, 16, 3, sp.blocks_fwd,
                                            sp.rows, int(sp.staged),
                                            sp.smem_fwd)
    assert fwd_s[15].shape == (2,)                  # the subject queue
    assert fwd_s[10] is None and fwd_s[11] is None    # float64: no copies
    assert fwd_s[14].shape == (3, 4 * sp.tiles, gb.NSUB + 16)
    assert fwd_l[10] is fwd_s[14] and fwd_l[11] == sp.parts
    assert fwd_l[12].shape == ((gb.NSUB + gb.NLAT + 1) * lp.blocks,)
    assert fwd_l[-4] == lp.blocks
    assert fwd_l[-1] == lp.smem_fwd and (fwd_l[16] is None) == (
        totals is None)
    assert bwd_l[2] is None if totals is None else bwd_l[1] is None
    assert bwd_l[-3:] == (16, lp.blocks, lp.smem_bwd)
    assert (bwd_l[16] is None) == (bwd_l[19] is None) == (not need_hm)
    assert (bwd_l[20] is None) == (not need_hm)
    # d m's parts (a column's sums over each row tile) and the counter
    assert (bwd_l[23] is None) == (bwd_l[24] is None) == (not need_hm)
    if need_hm:
        assert bwd_l[23].shape == (3, lp.tiles, 16)
    assert bwd_s[-9:] == (3, 4, Ts, 16, 3, sp.blocks_bwd, sp.rows,
                          int(sp.staged), sp.smem_bwd)
    assert bwd_s[15].shape == (3, 4 * Ts, 32)       # K0xz [G | G^T]
    assert (bwd_s[16] is None) == sp.staged          # sym, tiles only
    assert bwd_s[23].shape == (2,)                  # the subject queue
    if not sp.staged:
        assert bwd_s[16].shape == (3, 4, Ts, Ts)
