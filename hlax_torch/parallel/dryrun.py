"""One train step on an n-rank mesh at tiny shapes (the counterpart of
``__graft_entry__.py::dryrun_multichip``).

    python -m hlax_torch.parallel.dryrun 4

The full step (VAE, KLD bound, Adam, natural gradient) on a (data x
latent) mesh: one rank a card over NCCL when ``n`` cards are visible, else
``n`` CPU processes over gloo.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def _tiny(n_data: int, n_latent: int, device):
    """hlax's dry-run problem: 2 subjects a data rank of 4 rows, real /
    cat / count / pos columns, 4 latents a latent rank, M = 8, the MLP
    model, float32; returns (dataset, specs, cfg, whole state)."""
    from hlax_torch.data.dataset import LongitudinalDataset, subject_batches
    from hlax_torch.data.reader import encode_raw
    from hlax_torch.gp.kernels import build_kernel_specs
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.train import step as tstep

    S, T, L, M = 2 * n_data, 4, 4 * n_latent, 8
    rng = np.random.default_rng(0)
    types = [{"type": "real", "dim": 1, "nclass": 1},
             {"type": "cat", "dim": 1, "nclass": 3},
             {"type": "count", "dim": 1, "nclass": 1},
             {"type": "pos", "dim": 1, "nclass": 1}]
    n = S * T
    raw = np.column_stack([rng.normal(0, 1, n), rng.integers(0, 3, n),
                           rng.poisson(3, n), rng.random(n) * 3])
    het = encode_raw(raw, types,
                     miss_mask=(rng.random((n, 4)) > 0.2).astype(float))
    labels = np.zeros((n, 3))
    labels[:, 0] = np.tile(np.arange(T), S)
    labels[:, 2] = np.repeat(np.arange(S), T)
    het.labels = labels
    ds = LongitudinalDataset(het=het, labels=labels, id_covariate=2,
                             conv=False)
    spec0, spec1 = build_kernel_specs(
        [2], [], [0], [{"cont_covariate": 0, "cat_covariate": 2}], [], [], 2)
    cfg = tstep.TrainConfig(latent_dim=L, M=M, P_tot=float(S),
                            N_tot=float(n), id_covariate=2,
                            natural_gradient=True, constrain_scales=True,
                            gp_dtype=torch.float32)
    model = HLVAE(HLVAEConfig(layout=ds.layout, z_dim=L, h_dims=(16,),
                              y_dim=3, conv=False),
                  torch.Generator(device=device).manual_seed(0),
                  device=device)
    state = tstep.init_train_state(model, spec0, spec1,
                                   next(subject_batches(ds, S)), cfg, seed=0)
    return ds, spec0, spec1, cfg, state


def _rank(rank: int, world_size: int, init_method: str, n_data: int,
          n_latent: int, on_cards: bool) -> float:
    """One rank of the dry run: its loss."""
    from hlax_torch.data.dataset import (epoch_subject_batches_mesh,
                                         gather_batch, stage_dataset_mesh)
    from hlax_torch.parallel import distributed as pdist
    from hlax_torch.parallel import mesh as pmesh
    from hlax_torch.train import step as tstep

    device = torch.device("cuda", rank) if on_cards else torch.device("cpu")
    if on_cards:
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    pdist.initialize(init_method=init_method, world_size=world_size,
                     rank=rank, device=device)
    try:
        mesh = pmesh.make_mesh(n_data, n_latent)
        ds, spec0, spec1, cfg, whole = _tiny(n_data, n_latent, device)
        state = pmesh.shard_state(whole, mesh, cfg)
        staged = stage_dataset_mesh(ds, torch.float32, device, n_data, mesh.d)
        idx = epoch_subject_batches_mesh(ds.P, n_data, ds.P,
                                         np.random.default_rng(0))
        step = tstep.make_train_step(state.vae, spec0, spec1, cfg, mesh=mesh)
        m = step(state, gather_batch(
            staged, torch.as_tensor(idx[0, mesh.d], device=device)))
        return float(m["loss"])
    finally:
        pdist.destroy()


def dryrun_multichip(n: int) -> float:
    """One train step on an ``n``-rank mesh (2 latent ranks where n is
    even, else 1); prints one ``dryrun_multichip(n): ... loss=...`` line
    and returns the loss, which must be finite and the same on every
    rank."""
    from hlax_torch.parallel import distributed as pdist

    n_latent = 2 if n % 2 == 0 else 1
    n_data = n // n_latent
    on_cards = torch.cuda.is_available() and torch.cuda.device_count() >= n
    losses = pdist.spawn(_rank, n, (n_data, n_latent, on_cards),
                         timeout=180)
    if not np.isfinite(losses).all() or len(set(losses)) != 1:
        raise RuntimeError(f"dryrun_multichip({n}): losses by rank {losses}")
    where = (f"{n} cards over NCCL" if on_cards
             else f"{n} CPU processes over gloo")
    print(f"dryrun_multichip({n}): mesh=({n_data} data x {n_latent} latent) "
          f"on {where}, one train step OK, loss={losses[0]:.3f}",
          flush=True)
    return losses[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
