"""The ranks of the CPU mesh tests (``tests/test_torch_parallel.py``), in a
module of their own: a rank is a new process (``spawn``) that imports the
function it runs, and this module imports neither JAX nor hlax."""
import numpy as np
import torch


def port_dataset(case: dict):
    """The port's dataset of a test case."""
    from hlax_torch.data.dataset import LongitudinalDataset
    from hlax_torch.data.reader import encode_raw

    het = encode_raw(case["raw"], case["types"], miss_mask=case["miss"])
    het.labels = case["labels"]
    return LongitudinalDataset(het=het, labels=case["labels"],
                               id_covariate=2, conv=case["conv"])


def port_problem(case: dict, device="cpu"):
    """The port's dataset, kernel specs, TrainConfig and whole train state
    of a test case (numpy inputs made by the test from hlax's state)."""
    from hlax_torch.convert import state_from_hlax
    from hlax_torch.gp.kernels import build_kernel_specs
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.train import step as tstep

    ds = port_dataset(case)
    spec0, spec1 = build_kernel_specs(*case["spec_args"])
    cfg = tstep.TrainConfig(latent_dim=case["L"], M=case["M"],
                            P_tot=float(ds.P), N_tot=float(len(ds)),
                            id_covariate=2, natural_gradient=True,
                            constrain_scales=True, gp_dtype=torch.float64,
                            eps=case["jitter"])
    model = HLVAE(HLVAEConfig(layout=ds.layout, z_dim=case["L"],
                              h_dims=case["h_dims"], y_dim=case["y_dim"],
                              conv=case["conv"]),
                  torch.Generator(device=device).manual_seed(0),
                  device).double()
    s = case["state"]
    state = state_from_hlax(s["vae"], s["k0"], s["k1"], s["raw_noise"],
                            s["zt"], s["m"], s["H"], model, cfg)
    return ds, spec0, spec1, cfg, state


def gp_and_vae(state) -> dict:
    """The GP tensors and VAE parameters of a state, by name, as numpy."""
    ts = {"m": state.m, "H": state.H, "zt": state.zt}
    for i, p in enumerate(state.k0 + state.k1):
        ts.update({f"kernel{i}.{k}": v for k, v in p.items()})
    ts.update({f"vae.{k}": v for k, v in state.vae.named_parameters()})
    return {k: v.detach().cpu().numpy() for k, v in ts.items()}


def mesh_case(rank: int, world: int, init: str, case: dict) -> dict:
    """One rank of a CPU mesh case over gloo.

    Joins the group (twice: the second ``initialize`` must be a no-op),
    then from the case's whole state: (1) the first batch as one mesh step
    on a fresh share, whose gradients it returns (this rank's: the VAE's
    whole, the GP's latent slice); (2) the epochs of ``case["idx"]``
    ([epochs, nb, D, S_loc]) through ``make_train_epoch_mesh`` with the
    injected global noise, returning the metrics and the gathered state,
    and checking that Adam's GP moments are this rank's slice and that
    gathering and sharding again gives the rank's tensors back."""
    import torch.distributed as dist

    from hlax_torch.data.dataset import gather_batch, stage_dataset_mesh
    from hlax_torch.parallel import distributed as pdist
    from hlax_torch.parallel import mesh as pmesh
    from hlax_torch.train import step as tstep

    torch.set_num_threads(1)
    first = pdist.initialize("gloo", init, world, rank)
    again = pdist.initialize("gloo", init, world, rank)
    try:
        mesh = pmesh.make_mesh(case["n_data"], case["n_latent"])
        ds, spec0, spec1, cfg, whole = port_problem(case)
        staged = stage_dataset_mesh(ds, torch.float64, "cpu", mesh.n_data,
                                    mesh.d)
        idx, eps = case["idx"], case["eps"]
        rows = idx.shape[-1] * ds.T_max

        state = pmesh.shard_state(whole, mesh, cfg)
        step = tstep.make_train_step(whole.vae, spec0, spec1, cfg, mesh=mesh)
        step(state, gather_batch(staged, torch.as_tensor(idx[0, 0, mesh.d])),
             eps=torch.as_tensor(eps[0, 0, mesh.d * rows:
                                     (mesh.d + 1) * rows]))
        grads = [None if p.grad is None else p.grad.numpy().copy()
                 for p in tstep.trainable(state, cfg)]

        ds, spec0, spec1, cfg, whole = port_problem(case)
        state = pmesh.shard_state(whole, mesh, cfg)
        epoch = tstep.make_train_epoch_mesh(state.vae, spec0, spec1, cfg,
                                            mesh)
        metrics = [epoch(state, staged, i, eps=torch.as_tensor(e))
                   for i, e in zip(idx, eps)]
        gathered = pmesh.gather_state(state, mesh, cfg)
        again_state = pmesh.shard_state(gathered, mesh, cfg)
        round_trip = all(
            torch.equal(a, b) for a, b in zip(
                pmesh._gp_tensors(state), pmesh._gp_tensors(again_state)))
        moments = {k: tuple(state.optimizer.state[state.zt][k].shape)
                   for k in ("exp_avg", "exp_avg_sq")}
        round_trip &= all(
            torch.equal(v, again_state.optimizer.state[again_state.zt][k])
            for k, v in state.optimizer.state[state.zt].items())
        return {"first": first, "again": again, "grads": grads,
                "slice": mesh.latent_slice(cfg.latent_dim),
                "n_vae": len(list(state.vae.parameters())),
                "metrics": metrics, "state": gp_and_vae(gathered),
                "step": gathered.step, "round_trip": round_trip,
                "zt_moments": moments}
    finally:
        dist.destroy_process_group()
