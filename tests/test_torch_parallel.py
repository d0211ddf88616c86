"""The port's (data x latent) mesh on the CPU (``hlax_torch/parallel``): gloo
ranks in processes of their own against hlax's mesh on the conftest's
virtual CPU devices, float64, toy widths.

Two cases, each on a 2 x 2 mesh over two epochs: the conv model on
generated D4 data (7 ragged subjects: the second data shard holds 3 and an
empty one) and the MLP model on a two-column toy (7 subjects, 3 a batch
rounded up to 2 a shard, L = 5 latents on 2 latent ranks: the GP
replicated).  The same data, initial state (hlax's, through
``hlax_torch/convert.py``), local index batches and noise (hlax's rng
chain, injected into the port) go through hlax's ``make_train_epoch_mesh``
(``jit_train_epoch``) and the port's ``make_train_epoch_mesh``; each rank
also returns its gradients of the first batch, held against the
single-process port step's, and what a CUDA graph of each of its steps
would capture (``torch_mesh_ranks.StepTrace``).  Every rank process is
killed when one fails (``hlax_torch.parallel.distributed.spawn``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_mesh_ranks as ranks
from hlax.data import dataset as jds
from hlax.data.reader import encode_raw
from hlax.gp import kernels as jk
from hlax.models import HLVAE, HLVAEConfig
from hlax.parallel import mesh as jmesh
from hlax.train import step as jstep
from hlax_torch.convert import load_hlax_vae
from hlax_torch.data import dataset as tds
from hlax_torch.data import generate as tgen
from hlax_torch.parallel import distributed as pdist
from hlax_torch.parallel import mesh as pmesh
from hlax_torch.train import step as tstep

torch.set_num_threads(1)

EPOCHS = 2
D4_SPEC_ARGS = ([2], [], [0],
                [{"cat_covariate": 3, "cont_covariate": 0},
                 {"cat_covariate": 2, "cont_covariate": 0}], [], [], 2)
TOY_SPEC_ARGS = ([2], [], [0], [{"cont_covariate": 0, "cat_covariate": 2}],
                 [], [], 2)


def _d4_case():
    """Conv model, generated D4 data, 7 subjects of 2..5 rows."""
    out = tgen.generate(num_3=4, num_6=3, missing=25.0, datatype_config="D4",
                        seed=9)
    lengths = [5, 4, 5, 3, 5, 5, 2]
    keep = np.concatenate([np.arange(20 * s, 20 * s + t)
                           for s, t in enumerate(lengths)])
    labels = np.nan_to_num(
        out["labels"][keep][:, tds.HEALTH_MNIST_LABEL_ORDER])
    return dict(raw=out["data"][keep], miss=out["mask"][keep], labels=labels,
                types=tgen.types_table("D4"), conv=True,
                spec_args=D4_SPEC_ARGS, L=4, M=10, h_dims=(16,), y_dim=5,
                jitter=1e-4, n_data=2, n_latent=2, spb=4)


def _toy_case():
    """MLP model, a real and a categorical column, 7 subjects of 3 rows;
    L = 5 does not divide the 2 latent ranks."""
    rng = np.random.default_rng(3)
    S, T = 7, 3
    n = S * T
    raw = np.column_stack([rng.normal(0, 1, n),
                           rng.integers(0, 3, n).astype(float)])
    labels = np.zeros((n, 3))
    labels[:, 0] = np.tile(np.arange(T), S)
    labels[:, 2] = np.repeat(np.arange(S), T)
    return dict(raw=raw, miss=(rng.random((n, 2)) > 0.2).astype(float),
                labels=labels,
                types=[{"type": "real", "dim": 1, "nclass": 1},
                       {"type": "cat", "dim": 1, "nclass": 3}],
                conv=False, spec_args=TOY_SPEC_ARGS, L=5, M=5, h_dims=(8,),
                y_dim=2, jitter=1e-4, n_data=2, n_latent=2, spb=3)


def _hlax_setup(case):
    """hlax's dataset, kernel specs, TrainConfig, model and initial state
    of a case; the state goes into the case as numpy, for the port."""
    het = encode_raw(case["raw"], case["types"], miss_mask=case["miss"])
    ds = jds.LongitudinalDataset(het=het, labels=case["labels"],
                                 id_covariate=2, conv=case["conv"])
    spec0, spec1 = jk.build_kernel_specs(*case["spec_args"])
    cfg = jstep.TrainConfig(latent_dim=case["L"], M=case["M"],
                            P_tot=float(ds.P), N_tot=float(len(het.data)),
                            id_covariate=2, natural_gradient=True,
                            constrain_scales=True, gp_dtype=jnp.float64,
                            eps=case["jitter"])
    model = HLVAE(HLVAEConfig(layout=ds.layout, z_dim=case["L"],
                              h_dims=case["h_dims"], y_dim=case["y_dim"],
                              conv=case["conv"], dtype=jnp.float64))
    state = jstep.init_train_state(model, spec0, spec1,
                                   next(jds.subject_batches(ds, ds.P)), cfg,
                                   seed=0)
    npy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    case["state"] = {k: npy(getattr(state, k)) for k in
                     ("vae", "k0", "k1", "raw_noise", "zt", "m", "H")}
    return ds, spec0, spec1, cfg, model, state


def _hlax(case):
    """hlax's side of a case: its initial state (into the case), the index
    batches and noise of EPOCHS epochs (into the case), and its mesh
    epochs' metrics and final state."""
    ds, spec0, spec1, cfg, model, state = _hlax_setup(case)
    D = case["n_data"]
    rng = np.random.default_rng(7)
    idx = np.stack([jds.epoch_subject_batches_mesh(ds.P, D, case["spb"], rng)
                    for _ in range(EPOCHS)])             # [E, nb, D, S_loc]
    rows = D * idx.shape[-1] * ds.T_max
    noise, r = [], state.rng
    for _ in range(idx.shape[0] * idx.shape[1]):
        r, sub = jax.random.split(r)
        noise.append(np.asarray(jax.random.normal(sub, (rows, case["L"]),
                                                  jnp.float64)))
    case["idx"] = idx
    case["eps"] = np.stack(noise).reshape(idx.shape[:2] + (rows, case["L"]))
    mesh = jmesh.make_mesh(n_data=D, n_latent=case["n_latent"])
    metrics = []
    with mesh:
        staged = jmesh.shard_staged(jds.stage_dataset_mesh(ds, jnp.float64, D),
                                    mesh)
        epoch = jmesh.jit_train_epoch(
            jstep.make_train_epoch_mesh(model, spec0, spec1, cfg), state,
            mesh, staged)
        st = jmesh.shard_state(state, mesh)
        for i in idx:
            st, m = epoch(st, staged, jnp.asarray(i))
            metrics.append({k: np.asarray(v) for k, v in m.items()})
    return {"metrics": metrics, "state": st, "P": ds.P}


@pytest.fixture(scope="module", params=["conv", "mlp"])
def case(request):
    """A case run by hlax and by a 2 x 2 port mesh of gloo processes."""
    case = _d4_case() if request.param == "conv" else _toy_case()
    want = _hlax(case)
    got = pdist.spawn(ranks.mesh_case, case["n_data"] * case["n_latent"],
                      (case,), timeout=300)
    return case, want, got


def test_mesh_epochs_match_hlax_mesh(case):
    """Every rank's metrics of every step equal hlax's mesh epochs' (loss,
    nll and kld at 1e-9); the gathered state equals hlax's sharded state
    after them: the GP tensors, the kernel parameters and the VAE's
    parameters, at hlax's own mesh bars (rtol 1e-7, atol 1e-9)."""
    case, want, got = case
    for r in got:
        for mt, mj in zip(r["metrics"], want["metrics"]):
            for k in ("loss", "nll", "kld"):
                np.testing.assert_allclose(mt[k], mj[k], rtol=1e-9)
            for k in ("recon", "miss_recon"):
                np.testing.assert_allclose(mt[k], mj[k], rtol=1e-7)
    st = want["state"]
    ref = {"m": st.m, "H": st.H, "zt": st.zt}
    for i, p in enumerate(st.k0 + st.k1):
        ref.update({f"kernel{i}.{k}": v for k, v in p.items()})
    _, _, _, _, port = ranks.port_problem(case)
    load_hlax_vae(port.vae, jax.tree_util.tree_map(np.asarray, st.vae))
    ref.update({f"vae.{k}": v.detach().numpy()
                for k, v in port.vae.named_parameters()})
    state = got[0]["state"]
    assert set(state) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(state[k], np.asarray(v), rtol=1e-7,
                                   atol=1e-9, err_msg=k)
    assert all(r["step"] == int(st.step) for r in got)


def test_mesh_gradients_match_single_process(case):
    """Each rank's gradients of the first batch, after the mesh's
    all-reduces, equal the single-process step's on the global batch: the
    VAE's whole, the GP's this rank's latent slice (all of it where the GP
    is replicated)."""
    case, _, got = case
    ds, spec0, spec1, cfg, state = ranks.port_problem(case)
    staged = tds.stage_dataset(ds, torch.float64, "cpu")
    idx = case["idx"][0, 0]
    P_loc = -(-ds.P // case["n_data"])
    glob = np.where(idx >= 0, idx + P_loc * np.arange(case["n_data"])[:, None],
                    -1).reshape(-1)
    step = tstep.make_train_step(state.vae, spec0, spec1, cfg)
    step(state, tds.gather_batch(staged, torch.as_tensor(glob)),
         eps=torch.as_tensor(case["eps"][0, 0]))
    want = [None if p.grad is None else p.grad.numpy()
            for p in tstep.trainable(state, cfg)]
    assert sum(w is not None for w in want) > 10
    for r in got:
        assert len(r["grads"]) == len(want)
        for i, (g, w) in enumerate(zip(r["grads"], want)):
            if w is None:
                assert g is None or not g.any()
                continue
            if i >= r["n_vae"]:      # a GP tensor: this rank's latents
                w = w[r["slice"]]
            np.testing.assert_allclose(g, w, rtol=1e-7,
                                       atol=1e-9 * np.abs(w).max(),
                                       err_msg=f"parameter {i}")


def test_adam_moments_and_state_round_trip(case):
    """Adam's moments of zt hold this rank's latent slice (all latents
    where L does not divide the latent ranks); gathering the state and
    sharding it again gives each rank its tensors and moments back."""
    case, _, got = case
    L, n_lat = case["L"], case["n_latent"]
    local = L // n_lat if L % n_lat == 0 else L
    for r in got:
        assert r["round_trip"]
        for shape in r["zt_moments"].values():
            assert shape[0] == local


def test_mesh_steps_issue_the_same_collectives_after_warm_up(case):
    """What lets a CUDA graph capture the mesh step over NCCL, on the 2 x 2
    gloo mesh (conv: the GP sharded; MLP: L = 5, the GP replicated, so the
    latent ranks 1 skip the backward pass): after GRAPH_WARMUP steps every
    step issues the same collectives (op, group, reduce op, shape, dtype)
    in the same order as the step before it, the ranks of each group issue
    the same sequence on it at every step, the reducer's host read of its
    agreement happens in the first step only, and the step says it is
    capturable from then on."""
    _, _, got = case
    warm = tstep.GRAPH_WARMUP
    for r in got:
        steps = r["trace"]
        assert len(steps) > warm + 1
        assert not steps[0]["capturable"] and steps[0]["host_reads"] > 0
        assert any(c[2].endswith("MAX") and len(c[1]) == len(got)
                   for c in steps[0]["calls"])       # the agreement
        for j in range(1, len(steps)):
            assert steps[j]["capturable"] and steps[j]["host_reads"] == 0, j
        for j in range(warm, len(steps)):
            assert steps[j]["calls"] == steps[j - 1]["calls"], j
        assert steps[-1]["calls"]
    groups = {c[1] for r in got for s in r["trace"] for c in s["calls"]}
    assert len(groups) > 2          # the world, data and latent groups
    for g in groups:
        for j in range(len(got[0]["trace"])):
            seqs = [[c for c in got[r]["trace"][j]["calls"] if c[1] == g]
                    for r in g]
            assert all(q == seqs[0] for q in seqs), (g, j)


@pytest.mark.parametrize("device,backend,graphs,mode", [
    ("cuda", None, True, "global"), ("cuda", "nccl", True, "thread_local"),
    ("cuda", "gloo", False, "thread_local"), ("cpu", None, False, "global"),
    ("cpu", "gloo", False, "thread_local"),
    ("cpu", "nccl", False, "thread_local")])
def test_train_epoch_captures_only_on_cuda_alone_or_over_nccl(
        device, backend, graphs, mode):
    """``make_train_epoch`` captures the step exactly when the device is
    CUDA and there is no mesh or the mesh's backend is NCCL; never over
    gloo; an NCCL mesh captures with the thread-local capture mode."""
    mesh = None if backend is None else pmesh.Mesh(2, 1, 0, None, None,
                                                   backend)
    assert tstep.uses_graphs(torch.device(device), mesh) is graphs
    assert tstep.uses_graphs(device, mesh) is graphs
    assert tstep.capture_error_mode(mesh) == mode


def test_initialize_joins_once_and_is_idempotent(case, monkeypatch):
    """Each rank's first ``initialize`` joins the group and its second is a
    harmless no-op; without a world size (argument or WORLD_SIZE) it does
    nothing."""
    _, _, got = case
    assert all(r["first"] and r["again"] for r in got)
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert pdist.initialize() is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("P,D,S,seed", [(8, 4, 4, 7), (7, 4, 3, 9),
                                        (200, 2, 20, 0), (23, 3, 5, 1)])
def test_epoch_subject_batches_mesh_matches_hlax(P, D, S, seed):
    """The same [nb, D, S_loc] local batches as hlax's from the same numpy
    rng (and the rng left in the same state); every real subject once."""
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    got = tds.epoch_subject_batches_mesh(P, D, S, a)
    want = jds.epoch_subject_batches_mesh(P, D, S, b)
    np.testing.assert_array_equal(got, want)
    assert a.integers(1 << 30) == b.integers(1 << 30)
    P_loc = -(-P // D)
    glob = np.where(got >= 0, got + P_loc * np.arange(D)[None, :, None], -1)
    assert sorted(glob[glob >= 0].tolist()) == list(range(P))


@pytest.mark.parametrize("D", [2, 3])
def test_stage_and_gather_mesh_match_hlax(D):
    """Rank d's staged block is hlax's ``stage_dataset_mesh(...)[d]``, and
    the rank's batch from its local indices (``gather_batch`` on its block)
    is hlax's ``gather_batch_mesh`` rows of shard d."""
    case = _d4_case()
    het = encode_raw(case["raw"], case["types"], miss_mask=case["miss"])
    jset = jds.LongitudinalDataset(het=het, labels=case["labels"],
                                   id_covariate=2)
    tset = ranks.port_dataset(case)
    staged_j = jds.stage_dataset_mesh(jset, jnp.float64, D)
    idx = jds.epoch_subject_batches_mesh(jset.P, D, 4,
                                         np.random.default_rng(0))[0]
    want = jds.gather_batch_mesh(staged_j, jnp.asarray(idx))
    rows = idx.shape[1] * jset.T_max
    for d in range(D):
        block = tds.stage_dataset_mesh(tset, torch.float64, "cpu", D, d)
        for k, v in block.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(staged_j[k][d]))
        got = tds.gather_batch(block, torch.as_tensor(idx[d]))
        for k, v in got.items():
            w = np.asarray(want[k])
            w = w[d * idx.shape[1]:(d + 1) * idx.shape[1]] if k == "valid" \
                else w[d * rows:(d + 1) * rows]
            np.testing.assert_array_equal(v.numpy(), w)


def test_shard_state_slices_the_gp_and_its_moments():
    """``shard_state`` without a process group (it makes none of its
    collectives): after a single-process step, latent rank 1 of 2 holds
    latents 2..3 of every GP tensor and of their Adam moments, the VAE's
    moments whole; with L = 5 on 2 latent ranks it holds everything."""
    for L, want in ((4, slice(2, 4)), (5, slice(0, 5))):
        case = _toy_case()
        case["L"] = L
        _hlax_setup(case)
        ds, spec0, spec1, cfg, whole = ranks.port_problem(case)
        staged = tds.stage_dataset(ds, torch.float64, "cpu")
        step = tstep.make_train_step(whole.vae, spec0, spec1, cfg)
        step(whole, tds.gather_batch(staged, torch.arange(3)))
        mesh = pmesh.Mesh(2, 2, 3, None, None, "gloo")   # (d, l) = (1, 1)
        assert mesh.latent_slice(L) == want
        local = pmesh.shard_state(whole, mesh, cfg)
        for a, b in zip(pmesh._gp_tensors(local), pmesh._gp_tensors(whole)):
            assert torch.equal(a, b[want])
        for pa, pb in zip(tstep.trainable(local, cfg),
                          tstep.trainable(whole, cfg)):
            sa, sb = local.optimizer.state[pa], whole.optimizer.state[pb]
            if not sb:       # a parameter the loss does not read
                assert not sa
                continue
            gp = pb is not pa
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[k], sb[k][want] if gp else sb[k])
            assert torch.equal(sa["step"], sb["step"])

