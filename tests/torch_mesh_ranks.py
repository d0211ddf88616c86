"""The ranks of the CPU mesh tests (``tests/test_torch_parallel.py``,
``tests/test_torch_distributed.py``), in a module of their own: a rank is a
new process (``spawn``) that imports the function it runs, and this module
imports neither JAX nor hlax."""
import os
import sys
import time

import numpy as np
import torch

# the Tensor methods that read a value on the host (a sync on the card)
HOST_READS = ("item", "tolist", "numpy", "__bool__", "__float__", "__int__")


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


class StepTrace:
    """Records, for each train step made by ``make_train_step`` while it is
    active, what a CUDA graph of that step would capture: each collective
    (name, the ranks of its group, reduce op, shape, dtype), the port's
    host reads of tensors (``HOST_READS`` called from ``hlax_torch``; on
    the CPU Adam is not ``capturable`` and reads its step count on the
    host, which on the card it does not), and whether the step said it was
    capturable before it ran."""

    def __init__(self):
        self.steps = []
        self._in_step = False

    def _collective(self, name, fn):
        import torch.distributed as dist

        def traced(tensor_or_list, *args, group=None, **kw):
            if self._in_step:
                t = args[0] if name == "all_gather" else tensor_or_list
                op = kw.get("op", args[0] if args and name == "all_reduce"
                            else dist.ReduceOp.SUM)
                ranks = tuple(dist.get_process_group_ranks(group)) \
                    if group is not None else tuple(range(
                        dist.get_world_size()))
                self.steps[-1]["calls"].append(
                    (name, ranks, str(op), tuple(t.shape), str(t.dtype)))
            return fn(tensor_or_list, *args, group=group, **kw)
        return traced

    def _host_read(self, fn):
        port = os.sep + "hlax_torch" + os.sep

        def traced(t, *args, **kw):
            if self._in_step and port in sys._getframe(1).f_code.co_filename:
                self.steps[-1]["host_reads"] += 1
            return fn(t, *args, **kw)
        return traced

    def _make_step(self, make):
        def traced_make(*args, **kw):
            step = make(*args, **kw)

            def traced(state, batch, eps=None):
                self.steps.append({"capturable": step.capturable(state),
                                   "calls": [], "host_reads": 0})
                self._in_step = True
                try:
                    return step(state, batch, eps)
                finally:
                    self._in_step = False
            traced.capturable = step.capturable
            return traced
        return traced_make

    def __enter__(self):
        import torch.distributed as dist

        from hlax_torch.train import step as tstep

        self._saved = [(dist, n, getattr(dist, n))
                       for n in ("all_reduce", "all_gather")]
        self._saved += [(torch.Tensor, n, getattr(torch.Tensor, n))
                        for n in HOST_READS]
        self._saved.append((tstep, "make_train_step", tstep.make_train_step))
        for obj, name, fn in self._saved:
            wrap = (self._collective(name, fn) if obj is dist else
                    self._host_read(fn) if obj is torch.Tensor else
                    self._make_step(fn))
            setattr(obj, name, wrap)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)


def mesh_case(rank: int, world: int, init: str, case: dict) -> dict:
    """One rank of a CPU mesh case over gloo.

    Joins the group (twice: the second ``initialize`` must be a no-op),
    then from the case's whole state: (1) the first batch as one mesh step
    on a fresh share, whose gradients it returns (this rank's: the VAE's
    whole, the GP's latent slice); (2) the epochs of ``case["idx"]``
    ([epochs, nb, D, S_loc]) through ``make_train_epoch_mesh`` with the
    injected global noise, returning the metrics, each step's
    ``StepTrace`` and the gathered state, and checking that Adam's GP
    moments are this rank's slice and that gathering and sharding again
    gives the rank's tensors back."""
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
        with StepTrace() as trace:
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
                "metrics": metrics, "trace": trace.steps,
                "state": gp_and_vae(gathered),
                "step": gathered.step, "round_trip": round_trip,
                "zt_moments": moments}
    finally:
        pdist.destroy()


def _wait_for(path: str, limit: float = 60.0) -> None:
    end = time.monotonic() + limit
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"{path} did not appear in {limit} s")
        time.sleep(0.05)


def unjoined_collective(rank: int, world: int, init: str, tmp: str,
                        timeout: float) -> dict:
    """Two gloo ranks joined with a ``timeout``: rank 0 all-reduces, rank 1
    never joins it (it waits, outside the group, until rank 0 has given
    up).  Rank 0 returns whether the all-reduce raised and after how many
    seconds.  The ranks meet at a file barrier first, so that joining the
    group is not what takes the time."""
    import torch.distributed as dist

    from hlax_torch.parallel import distributed as pdist

    open(os.path.join(tmp, f"ready{rank}"), "w").close()
    for r in range(world):
        _wait_for(os.path.join(tmp, f"ready{r}"))
    pdist.initialize("gloo", init, world, rank, timeout=timeout)
    try:
        if rank:
            _wait_for(os.path.join(tmp, "gave_up"))
            return {}
        t0 = time.monotonic()
        try:
            dist.all_reduce(torch.ones(4))
            raised = None
        except RuntimeError as e:
            raised = type(e).__name__
        seconds = time.monotonic() - t0
        open(os.path.join(tmp, "gave_up"), "w").close()
        return {"raised": raised, "seconds": seconds}
    finally:
        pdist.destroy()


def sleep_forever(rank: int, world: int, init: str, tmp: str,
                  fail_rank: int = -1) -> None:
    """Writes this rank's pid into ``tmp``, then sleeps for an hour; rank
    ``fail_rank`` raises instead, once every rank has written its pid (so
    the others are alive when it fails)."""
    path = os.path.join(tmp, f"pid{rank}")
    with open(path + ".part", "w") as f:
        f.write(str(os.getpid()))
    os.replace(path + ".part", path)
    if rank == fail_rank:
        end = time.monotonic() + 60
        while time.monotonic() < end and not all(
                os.path.isfile(os.path.join(tmp, f"pid{r}"))
                for r in range(world)):
            time.sleep(0.05)
        raise ValueError(f"rank {rank} fails on purpose")
    time.sleep(3600)
