"""The (data x latent) mesh on ``torch.distributed`` (port of
``hlax/parallel/mesh.py``).

  * Whole subjects are sharded over the data axis; the VAE is replicated.
    Every batch reduction of the step is global: the masked moments of the
    normalization, ``P_batch``, the sums of the KLD bound, the
    natural-gradient accumulators, the log-likelihood and the metrics.
  * The GP state (``GP_STATE_FIELDS``, each with a leading latent axis) and
    its Adam moments are sharded over the latent axis.  Where the latent
    dimension does not divide the axis they are replicated instead, as
    hlax's ``_dim0_fits`` replicates such leaves.

Rank ``r`` sits at ``(d, l) = divmod(r, n_latent)``, hlax's
``reshape(n_data, n_latent)`` of the device list.  Its data group is the
ranks that share ``l``, its latent group the ranks that share ``d``.

A mesh step equals the single-process step on the global batch.  Each rank
differentiates only its own share of the loss: the sums below all-reduce
in the forward pass and pass the gradient through unchanged (an all-reduce
in the backward pass would count a replicated loss once a rank), and a
term that several ranks compute alike keeps its gradient on one of them.
After the backward pass the VAE's gradients are summed over all ranks, the
GP's over the ranks that hold the same latents (``make_gradient_reducer``);
Adam and the natural-gradient update then run on each rank's own tensors.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist

GP_STATE_FIELDS = ("k0", "k1", "raw_noise", "zt", "m", "H")


class Mesh(NamedTuple):
    """This rank's place in the mesh and its two process groups."""
    n_data: int
    n_latent: int
    rank: int
    data_group: object      # the ranks that share this rank's l
    latent_group: object    # the ranks that share this rank's d
    backend: str

    @property
    def d(self) -> int:
        return self.rank // self.n_latent

    @property
    def l(self) -> int:
        return self.rank % self.n_latent

    def shards_latents(self, L: int) -> bool:
        """Whether a GP of L latents is sharded over the latent axis (else
        replicated on every rank)."""
        return L % self.n_latent == 0

    def latent_slice(self, L: int) -> slice:
        """The latents this rank holds of a GP of L latents."""
        if not self.shards_latents(L):
            return slice(0, L)
        n = L // self.n_latent
        return slice(self.l * n, (self.l + 1) * n)


def make_mesh(n_data: Optional[int] = None, n_latent: int = 1) -> Mesh:
    """The mesh of the initialized process group: ``n_data`` (default: the
    world size over ``n_latent``) by ``n_latent`` ranks, which must be all
    of them."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = max(1, world // n_latent)
    if n_data * n_latent != world:
        raise ValueError(f"a {n_data} x {n_latent} mesh needs "
                         f"{n_data * n_latent} ranks; the process group has "
                         f"{world}")
    rank = dist.get_rank()
    data_group = latent_group = None
    # every rank creates every group, in the same order
    for l in range(n_latent):
        g = dist.new_group([d * n_latent + l for d in range(n_data)])
        if rank % n_latent == l:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_latent + l for l in range(n_latent)])
        if rank // n_latent == d:
            latent_group = g
    # one all-reduce on each group the step uses, so that every NCCL
    # communicator exists and has connected its rings (NCCL connects them
    # at a communicator's first collective) before a CUDA graph captures
    # the step; doing either inside a capture would allocate and
    # synchronize there
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    for g in (None, data_group, latent_group):
        if _group_size(g) > 1:
            dist.all_reduce(torch.zeros(1, device=dev), group=g)
    return Mesh(n_data, n_latent, rank, data_group, latent_group,
                dist.get_backend())


class _Sum(torch.autograd.Function):
    """All-reduce (sum) in the forward pass; the gradient passes through
    unchanged, so each rank differentiates its own contribution."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _group_size(group) -> int:
    return dist.get_world_size(group)


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group`` (default: every rank), with the
    gradient passed through."""
    return x if _group_size(group) == 1 else _Sum.apply(x, group)


class MeshSums:
    """The sums a train step takes over the mesh, for a GP of ``L``
    latents.  A tensor handed in is this rank's partial sum; what comes
    back is the global one, on every rank."""

    def __init__(self, mesh: Mesh, L: int):
        self.mesh, self.L = mesh, L
        self.sharded = mesh.shards_latents(L)

    def subjects(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's subjects that every rank of its latent
        group computes alike (the log-likelihood, the normalization's
        moments, the metrics; or, per latent, the natural-gradient
        accumulators): summed over the data group, differentiated on latent
        rank 0 only."""
        return all_sum(x if self.mesh.l == 0 else x.detach(),
                       self.mesh.data_group)

    def blocks(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's subjects and latents: summed over every
        rank, or over the data group where the GP is replicated."""
        if self.sharded:
            return all_sum(x)
        return self.subjects(x)

    def latents(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's latents that every rank of its data group
        computes alike (the KL of the inducing points): summed over the
        latent group, differentiated on data rank 0 only."""
        mesh = self.mesh
        if not self.sharded:
            keep = mesh.d == 0 and mesh.l == 0
            return x if keep else x.detach()
        return all_sum(x if mesh.d == 0 else x.detach(), mesh.latent_group)

    def subjects_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise largest ``x`` of the data group (no gradient)."""
        if _group_size(self.mesh.data_group) == 1:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.mesh.data_group)
        return y


def _all_reduce_flat(grads: List[torch.Tensor], group) -> None:
    """Sum ``grads`` over ``group`` in place, one all-reduce a dtype."""
    if _group_size(group) == 1:
        return
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=group)
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def make_gradient_reducer(mesh: Mesh, L: int, vae_params, gp_params
                          ) -> Callable[[], None]:
    """Returns ``reduce()``, which sums the gradients after a backward pass:
    the VAE's over every rank, the GP's over the ranks that hold the same
    latents (the data group, or every rank where the GP is replicated).

    Its first call, which must be eager (it reads the agreement on the
    host), agrees over the ranks on which parameters have a gradient: a
    rank whose share of the loss reads no parameter (a replica of a
    replicated GP) then gets zeros where the others have gradients, so
    every later call all-reduces the same tensors on every rank, in the
    same order.  ``reduce.agreed()`` says whether that first call has
    run: after it a call makes no host sync, and a CUDA graph may capture
    it."""
    vae_params, gp_params = list(vae_params), list(gp_params)
    params = vae_params + gp_params
    gp_group = mesh.data_group if mesh.shards_latents(L) else None
    chosen: List[List[torch.Tensor]] = []

    def reduce() -> None:
        if not chosen:
            dev = params[0].device
            has = torch.tensor([float(p.grad is not None) for p in params],
                               device=dev)
            dist.all_reduce(has, op=dist.ReduceOp.MAX)
            for p, h in zip(params, has.tolist()):
                if h and p.grad is None:
                    p.grad = torch.zeros_like(p)
            chosen.append([p for p in vae_params if p.grad is not None])
            chosen.append([p for p in gp_params if p.grad is not None])
        _all_reduce_flat([p.grad for p in chosen[0]], None)
        _all_reduce_flat([p.grad for p in chosen[1]], gp_group)

    reduce.agreed = lambda: bool(chosen)
    return reduce


# ---------------------------------------------------------------------------
# sharding and gathering the train state
# ---------------------------------------------------------------------------

def _gp_tensors(state) -> List[torch.Tensor]:
    """The tensors of ``GP_STATE_FIELDS``, the kernels' dicts flattened."""
    out = []
    for f in GP_STATE_FIELDS:
        v = getattr(state, f)
        out += [t for p in v for t in p.values()] if isinstance(v, list) \
            else [v]
    return out


def _rebuild(state, cfg, fn):
    """A TrainState whose GP tensors are ``fn`` of ``state``'s and whose
    Adam state is ``state``'s with ``fn`` applied to each GP parameter's
    moments; the VAE, the generator and the step count are shared."""
    from hlax_torch.train.step import (TrainState, make_optimizer,
                                       place_adam_steps, trainable)

    with torch.no_grad():
        new = TrainState(
            vae=state.vae,
            k0=[{k: fn(v) for k, v in p.items()} for p in state.k0],
            k1=[{k: fn(v) for k, v in p.items()} for p in state.k1],
            raw_noise=fn(state.raw_noise), zt=fn(state.zt), m=fn(state.m),
            H=fn(state.H), optimizer=None, generator=state.generator,
            step=state.step)
    new.optimizer = make_optimizer(new, cfg)
    gp = {id(t) for t in _gp_tensors(state)}
    src_opt, dst_opt = state.optimizer, new.optimizer
    for ps, pd in zip(trainable(state, cfg), trainable(new, cfg)):
        st = src_opt.state.get(ps)
        if not st:
            continue
        with torch.no_grad():
            dst_opt.state[pd] = {
                k: (fn(v) if id(ps) in gp and v.dim() > 0 else v.clone())
                for k, v in st.items()}
    place_adam_steps(dst_opt)
    return new


def shard_state(state, mesh: Mesh, cfg):
    """This rank's share of a whole train state: its slice of the latent
    axis of every GP tensor and of their Adam moments (all of it where the
    GP is replicated); the VAE module and the generator are shared with
    ``state``, the VAE's Adam moments copied."""
    sl = mesh.latent_slice(cfg.latent_dim)
    return _rebuild(state, cfg, lambda t: t.detach()[sl].clone())


def gather_state(state, mesh: Mesh, cfg):
    """The whole train state from every rank's share (a collective: every
    rank calls it, and every rank gets the whole state): the GP tensors
    and their Adam moments gathered over the latent group."""
    group = mesh.latent_group
    n = _group_size(group)
    if n == 1 or not mesh.shards_latents(cfg.latent_dim):
        return _rebuild(state, cfg, lambda t: t.detach().clone())

    def gather(t):
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts)

    return _rebuild(state, cfg, gather)
