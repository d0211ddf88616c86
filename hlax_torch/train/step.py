"""Training step: VAE NLL + sparse-GP KLD bound + Adam + natural gradient
(port of ``hlax/train/step.py``).

  * loss = sum(nll) * P/P_batch + KLD_upper_bound
  * Adam(lr=1e-3) over {vae, kernel0, kernel1, zt [, m, H] [, noise]};
    torch's Adam update rule is optax.adam's (eps outside the square root,
    bias correction on).
  * with natural_gradient, (m, H) leave Adam and take the closed-form
    natural-gradient update after each step, under ``torch.no_grad()``;
    ``nat_grad_f64`` runs that chain in float64 whatever the GP dtype.

The step updates the state in place: every tensor of the state (parameters,
Adam's moments and step count, m, H) keeps its storage from step to step,
which is what lets ``make_train_epoch`` capture the step in a CUDA graph
(hlax's one-dispatch epoch, ``hlax/train/step.py:297-332``).  The gradients
are not state: the backward pass writes each one once into a tensor of its
own (``write_grads``), as hlax's ``jax.grad`` returns fresh gradients, and
Adam reads it from ``.grad``; under a graph that tensor lies in the graph's
memory pool, at the same address every replay.  On CUDA Adam is PyTorch's
fused, capturable one.  ``train_epoch`` runs the same steps eagerly, one
batch at a time.

On a (data x latent) mesh (``hlax_torch.parallel.mesh``) the step takes
this rank's subjects and its latents of the GP (``shard_state``) and gives
the single-process step's loss and update of the global batch:
``make_train_step(..., mesh=...)`` and ``make_train_epoch_mesh``, whose
steps are captured as CUDA graphs over NCCL (hlax's one-dispatch mesh
epoch, ``hlax/train/step.py:335-363``) and run eagerly over gloo.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from hlax_torch import precision
from hlax_torch.gp import elbo as gp_elbo
from hlax_torch.gp import kernels as gp_kernels
from hlax_torch.models.hlvae import HLVAE, nll_from_log_p
from hlax_torch.ops import fusion
from hlax_torch.profiling import region


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    latent_dim: int
    M: int
    P_tot: float            # subjects in the dataset
    N_tot: float            # rows in the dataset
    id_covariate: int
    lr: float = 1e-3
    natural_gradient: bool = True
    natural_gradient_lr: float = 0.01
    constrain_scales: bool = True
    # GP jitter: 1e-6 in float64, 1e-4 in float32 (dtype-aware default)
    eps: Optional[float] = None
    gp_dtype: torch.dtype = torch.float32
    # relative diagonal ridge on iH_new before its factorization
    nat_grad_jitter: float = 0.0
    # float64 for the closed-form natural-gradient chain (the [L,M,M]
    # iK/B_mat/iH compositions and the (m, H) update); no effect when
    # gp_dtype is already float64
    nat_grad_f64: bool = False
    # the bound's and the natural-gradient update's factorizations through
    # the Cholesky kernels (floored pivots), as hlax's Pallas path; False:
    # the library's unguarded Cholesky (gp.elbo.library_chol_inv)
    use_pallas_chol: bool = True

    def __post_init__(self):
        if self.eps is None:
            object.__setattr__(self, "eps",
                               gp_kernels.default_eps(self.gp_dtype))


@dataclasses.dataclass
class TrainState:
    vae: HLVAE
    k0: List[Dict[str, torch.Tensor]]   # kernel0 params (leading L axis)
    k1: List[Dict[str, torch.Tensor]]
    raw_noise: torch.Tensor             # [L]
    zt: torch.Tensor                    # [L, M, Q]
    m: torch.Tensor                     # [L, M, 1]
    H: torch.Tensor                     # [L, M, M] (PSD iff natural_gradient)
    optimizer: Optional[torch.optim.Optimizer]
    generator: torch.Generator          # reparameterization noise
    step: int = 0


def trainable(state: TrainState, cfg: TrainConfig) -> List[torch.Tensor]:
    """The tensors Adam updates, in hlax's ``_trainable`` selection."""
    t = list(state.vae.parameters())
    t += [v for p in state.k0 + state.k1 for v in p.values()]
    t.append(state.zt)
    if not cfg.constrain_scales:
        t.append(state.raw_noise)
    if not cfg.natural_gradient:
        t += [state.m, state.H]
    return t


def make_optimizer(state: TrainState, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam over ``trainable``.  On CUDA it is ``fused`` (one multi-tensor
    kernel for every parameter: hlax's optax update is one XLA fusion) and
    ``capturable`` (its step count and bias corrections stay on the device,
    so a CUDA graph can capture the update), and its state is made here,
    before any step, at fixed addresses (``place_adam_steps``).  On the CPU
    it is PyTorch's default Adam, whose arithmetic the parity tests hold to
    hlax's."""
    params = trainable(state, cfg)
    for t in params:
        t.requires_grad_(True)
    cuda = params[0].is_cuda
    opt = torch.optim.Adam(params, lr=cfg.lr, capturable=cuda,
                           fused=True if cuda else None)
    if cuda:
        for p in params:
            opt.state[p] = {"step": torch.zeros((), device=p.device),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
        place_adam_steps(opt)
    return opt


def place_adam_steps(opt: torch.optim.Adam) -> None:
    """Each Adam step count where its mode keeps it: capturable, on the
    parameter's device, in float64 for a float64 parameter (Adam's own
    float32 would round that parameter's bias corrections to float32)
    unless fused (the fused kernel reads a float32 count, exact for every
    step count below 2**24, and forms the bias corrections in the
    parameter's dtype), else float32; not capturable, on the CPU as Adam
    makes it."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p)
            if not st or "step" not in st:
                continue
            cap = group["capturable"]
            st["step"] = st["step"].to(
                device=p.device if cap else "cpu",
                dtype=torch.float64 if cap and p.dtype == torch.float64
                and not group.get("fused") else torch.float32)


def write_grads(loss: torch.Tensor, params: List[torch.Tensor]) -> None:
    """Each parameter's gradient of ``loss`` into its ``.grad``, written
    once: the backward pass's own tensors (``torch.autograd.grad``), not
    added into zeroed ones, as hlax's ``jax.grad`` returns fresh gradients.
    Zeros for a parameter the loss does not reach (every parameter on a
    replica of a replicated GP, whose loss needs no gradient).  A gradient
    whose strides are not its parameter's (the fused conv's kernels come
    back permuted) is copied to them, as backward's accumulation does: the
    fused Adam takes only matching layouts."""
    if loss.requires_grad:
        # the GP's gradients in full float32, as its forward
        # (``precision.highest``); the VAE's TF32 Functions switch TF32 on
        # around their own backward operations
        with precision.tf32(False):
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
    else:
        grads = [torch.zeros_like(p) for p in params]
    for p, g in zip(params, grads):
        if g.stride() != p.stride():
            g = torch.empty_strided(p.shape, p.stride(), dtype=g.dtype,
                                    device=g.device).copy_(g)
        p.grad = g


def _rbf_dims(spec0, spec1):
    return sorted({f.dim for sp in (spec0, spec1) for c in sp.components
                   for f in c.factors if f.kind == "rbf"})


def init_train_state(model: HLVAE, spec0, spec1,
                     example_batch: Dict[str, np.ndarray], cfg: TrainConfig,
                     seed: int = 0, zt_init: Optional[np.ndarray] = None
                     ) -> TrainState:
    """Initial GP state: inducing points from random training covariates
    (nudged on the rbf dims so sampled rows do not collide), a damped
    m = 0.01 N(0, 1), and H = R R^T / 100 + 0.01 I with R ~ N(0, 1) (R / 10
    without natural gradient).  ``model`` is already initialized; its device
    is the state's."""
    dev = next(model.parameters()).device
    dt = cfg.gp_dtype
    L, M = cfg.latent_dim, cfg.M
    if zt_init is None:
        labels = np.asarray(example_batch["labels"])
        rows = labels[np.asarray(example_batch["idx"]) >= 0]
        rng = np.random.default_rng(seed)
        zt_init = np.stack([
            rows[rng.choice(len(rows), M, replace=len(rows) < M)]
            for _ in range(L)])
        rbf_dims = _rbf_dims(spec0, spec1)
        if rbf_dims:
            zt_init = zt_init.copy()
            zt_init[:, :, rbf_dims] += rng.uniform(
                -0.5, 0.5, zt_init[:, :, rbf_dims].shape)
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = 0.01 * torch.randn((L, M, 1), generator=gen, dtype=dt, device=dev)
    H = torch.randn((L, M, M), generator=gen, dtype=dt, device=dev) / 10.0
    if cfg.natural_gradient:
        H = H @ H.mT + 0.01 * torch.eye(M, dtype=dt, device=dev)
    state = TrainState(
        vae=model,
        k0=gp_kernels.init_kernel_params(spec0, L, dt, dev),
        k1=gp_kernels.init_kernel_params(spec1, L, dt, dev),
        raw_noise=gp_kernels.noise_init(L, cfg.constrain_scales, dt, dev),
        zt=torch.as_tensor(zt_init, dtype=dt, device=dev),
        m=m, H=H, optimizer=None, generator=gen)
    state.optimizer = make_optimizer(state, cfg)
    return state


def make_train_step(model: HLVAE, spec0, spec1, cfg: TrainConfig,
                    mesh=None):
    """Returns ``step(state, batch, eps=None) -> metrics``; it updates
    ``state`` in place, every tensor at its storage (the natural-gradient
    (m, H) are written into m and H, on the card by the update's last
    kernel itself; ``.grad`` is written anew,
    ``write_grads``).  ``batch`` holds S*T_max flat rows (data, mask,
    theta_mask, labels) and valid [S, T_max]; ``eps`` [S*T_max, z_dim]
    injects the reparameterization noise (else drawn from
    ``state.generator``).  Metrics are 0-dim tensors, left on the device.

    With a ``mesh`` (``hlax_torch.parallel.mesh.Mesh``) ``state`` is this
    rank's share (``shard_state``) and ``batch`` its subjects; the metrics
    are the global batch's.  The noise drawn from the generator is the
    global batch's [n_data * S * T_max, z_dim], of which the rank takes its
    own rows; an injected ``eps`` is this rank's rows.  After the backward
    pass the gradients are summed over the mesh (``make_gradient_reducer``;
    its first step must run eagerly).

    ``step.capturable(state)`` says whether a step on ``state`` may be
    captured in a CUDA graph: always without a mesh, and on a mesh once the
    gradient reducer's first call (a host sync) has run."""
    sums = lat = None
    reducers = {}
    if mesh is not None:
        from hlax_torch.parallel.mesh import MeshSums
        sums = MeshSums(mesh, cfg.latent_dim)
        lat = mesh.latent_slice(cfg.latent_dim)
    layout = model.cfg.layout
    # The reference's per-batch recon metric overwrites its value once per
    # type, so only the type whose first raw-order occurrence is LAST
    # survives.  Reproduce that.
    kinds_raw = layout.var_kinds_grouped()[np.asarray(layout.raw_inv)]
    last_kind = list(dict.fromkeys(kinds_raw))[-1]

    def recon_metric(params, data, mask, row_valid):
        return fusion.recon_metric(layout, model.cfg.conv, params, data,
                                   mask, row_valid, last_kind, sums)

    def reducer(state):
        from hlax_torch.parallel.mesh import make_gradient_reducer
        red = reducers.get(id(state.optimizer))
        if red is None:
            vae = list(state.vae.parameters())
            red = reducers[id(state.optimizer)] = make_gradient_reducer(
                mesh, cfg.latent_dim, vae, trainable(state, cfg)[len(vae):])
        return red

    def step(state: TrainState, batch, eps: Optional[torch.Tensor] = None):
        opt = state.optimizer
        if mesh is not None and eps is None:
            rows = batch["data"].shape[0]
            w = state.vae.mean_layer.weight
            eps = torch.randn((mesh.n_data * rows, cfg.latent_dim),
                              generator=state.generator, dtype=w.dtype,
                              device=w.device)[mesh.d * rows:
                                               (mesh.d + 1) * rows]
        out = state.vae(batch["data"], batch["mask"], batch["theta_mask"],
                        eps=eps, generator=state.generator, sums=sums)
        with region("nll"):
            nll = nll_from_log_p(out["log_p_x"]).sum()
        if sums is not None:
            nll = sums.subjects(nll)

        valid = batch["valid"]
        S, T = valid.shape
        gdt = cfg.gp_dtype
        with region("gp_bound"):
            x_st = batch["labels"].reshape(S, T, -1).to(gdt)
            mu_st = out["mu"].reshape(S, T, -1).to(gdt)
            log_v_st = out["log_var"].reshape(S, T, -1).to(gdt)
            if lat is not None:
                mu_st, log_v_st = mu_st[..., lat], log_v_st[..., lat]
            H = state.H if cfg.natural_gradient else state.H @ state.H.mT
            noise = gp_kernels.noise_value(state.raw_noise,
                                           cfg.constrain_scales)
            kld, gm, gH, iH = gp_elbo.kld_upper_bound(
                spec0, state.k0, spec1, state.k1, noise, state.m, H,
                state.zt, x_st, valid.to(gdt), mu_st, log_v_st, cfg.P_tot,
                cfg.N_tot, cfg.eps, natural_gradient=cfg.natural_gradient,
                nat_grad_dtype=torch.float64 if cfg.nat_grad_f64 else None,
                sums=sums, use_pallas_chol=cfg.use_pallas_chol)

        P_batch = (valid.sum(dim=1) > 0).to(nll.dtype).sum()
        if sums is not None:
            P_batch = sums.subjects(P_batch)
        nll_scaled = nll * cfg.P_tot / P_batch
        loss = nll_scaled + kld.to(nll.dtype)
        with region("backward"):
            write_grads(loss, opt.param_groups[0]["params"])
            if mesh is not None:
                reducer(state)()
        with region("adam"):
            opt.step()

        with torch.no_grad():
            with region("recon_metric"):
                row_valid = valid.reshape(-1).to(batch["mask"].dtype)
                params = [tuple(t.detach() for t in p) if isinstance(p, tuple)
                          else p.detach() for p in out["params"]]
                recon, miss = recon_metric(params, batch["data"],
                                           batch["mask"], row_valid)
            if cfg.natural_gradient:
                with region("natural_gradient"):
                    gp_elbo.natural_gradient_update(
                        state.m, state.H, gm.detach(), gH.detach(),
                        cfg.natural_gradient_lr, iH=iH.detach(),
                        jitter=cfg.nat_grad_jitter,
                        use_pallas_chol=cfg.use_pallas_chol,
                        out=(state.m, state.H))
        state.step += 1
        return {"loss": loss.detach(), "nll": nll_scaled.detach(),
                "kld": kld.detach(), "recon": recon, "miss_recon": miss}

    def capturable(state: TrainState) -> bool:
        red = reducers.get(id(state.optimizer))
        return mesh is None or (red is not None and red.agreed())

    step.capturable = capturable
    return step


METRICS = ("loss", "nll", "kld", "recon", "miss_recon")
# eager steps before the first capture: the first makes the libraries'
# handles and workspaces (cuBLAS, cuDNN, cuSOLVER) outside the capture, the
# second runs the step as every later one runs
GRAPH_WARMUP = 2


def train_epoch(step, state: TrainState, staged, idx_batches: np.ndarray
                ) -> Dict[str, np.ndarray]:
    """One epoch, eagerly: ``step`` over the batches of subject indices
    ``idx_batches`` [nb, S] (-1 = padding subject), each gathered on the
    device.  Returns the metrics stacked [nb] as numpy (one sync an
    epoch)."""
    from hlax_torch.data.dataset import gather_batch

    dev = staged["valid"].device
    idx = torch.as_tensor(np.asarray(idx_batches), device=dev)
    ms = [step(state, gather_batch(staged, i)) for i in idx]
    return {k: torch.stack([m[k] for m in ms]).cpu().numpy()
            for k in ms[0]}


def _step_inputs(staged, feed, j: int):
    """Step j's batch and noise from ``feed``: [n, ...] tensors of subject
    indices ("idx") or pregathered batches, and of noise ("eps")."""
    from hlax_torch.data.dataset import gather_batch

    if "idx" in feed:
        batch = gather_batch(staged, feed["idx"][j])
    else:
        batch = {k: feed[k][j] for k in
                 ("data", "mask", "theta_mask", "labels", "valid")}
    return batch, (feed["eps"][j] if "eps" in feed else None)


def _metrics_column(ms) -> torch.Tensor:
    """A step's metrics as one float64 [len(METRICS)] tensor."""
    return torch.stack([ms[m].to(torch.float64) for m in METRICS])


class _Replay(NamedTuple):
    """One captured graph of k consecutive train steps: the static inputs
    it reads ([k, ...]: subject indices or pregathered batches, and the
    noise when it is injected), the metrics it writes ([len(METRICS), k],
    float64) and the kernel launches it makes each replay."""
    graph: "torch.cuda.CUDAGraph"
    inputs: Dict[str, torch.Tensor]
    out: torch.Tensor
    counts: tuple


def _state_tensors(state: TrainState, staged) -> List[torch.Tensor]:
    """Every tensor a captured step reads or writes in place (not the
    gradients: the graph writes them into its own pool)."""
    ts = list(state.vae.parameters()) + list(state.vae.buffers())
    ts += [v for p in state.k0 + state.k1 for v in p.values()]
    ts += [state.raw_noise, state.zt, state.m, state.H]
    ts += [v for st in state.optimizer.state.values() for v in st.values()
           if torch.is_tensor(v)]
    return ts + list(staged.values())


class _EpochGraphs:
    """The CUDA side of ``make_train_epoch``: warm-up steps, one graph for
    each number of steps a replay takes (``unroll``, and the remainder of a
    call), replays."""

    def __init__(self, step, unroll: int, capture_error_mode: str):
        self.step, self.unroll = step, unroll
        self.capture_error_mode = capture_error_mode
        self.warm_left = GRAPH_WARMUP
        self.replays: Dict[tuple, _Replay] = {}
        self.stream = None
        self.ptrs = None
        _ALL_GRAPHS.add(self)

    def _capture(self, state, staged, feed, k: int) -> _Replay:
        from hlax_torch.ops import counters

        if not self.step.capturable(state):
            raise RuntimeError(
                "make_train_epoch: the mesh step's gradient reducer has not "
                "made its first, eager, call; it would sync with the host "
                "inside the capture")
        inputs = {name: torch.empty_like(v[:k]) for name, v in feed.items()}
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        step_count, before = state.step, counters.snapshot_all()
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode=self.capture_error_mode):
            out = torch.stack([_metrics_column(self.step(
                state, *_step_inputs(staged, inputs, u))) for u in range(k)],
                dim=1)
        state.step = step_count
        return _Replay(graph, inputs, out, counters.take_all_since(before))

    def __call__(self, state, staged, feed, nb: int, out: torch.Tensor):
        from hlax_torch.ops import counters

        if self.stream is None:
            self.stream = torch.cuda.Stream()
        j = 0
        if self.warm_left:
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                while j < nb and self.warm_left:
                    out[:, j] = _metrics_column(self.step(
                        state, *_step_inputs(staged, feed, j)))
                    j += 1
                    self.warm_left -= 1
            torch.cuda.current_stream().wait_stream(self.stream)
        if j == nb:
            return
        ptrs = [t.data_ptr() for t in _state_tensors(state, staged)]
        if self.ptrs is not None and ptrs != self.ptrs:
            raise RuntimeError(
                "make_train_epoch: the train state's or the staged data's "
                "tensors moved since the step was captured (a checkpoint "
                "restored after the first epoch?); make a new epoch "
                "function for them")
        self.ptrs = ptrs
        while j < nb:
            k = min(self.unroll, nb - j)
            key = (k, "eps" in feed)
            rep = self.replays.get(key)
            if rep is None:
                rep = self.replays[key] = self._capture(state, staged, feed,
                                                        k)
            for name, buf in rep.inputs.items():
                buf.copy_(feed[name][j:j + k])
            rep.graph.replay()
            out[:, j:j + k].copy_(rep.out)
            counters.add_all(rep.counts)
            state.step += k
            j += k


# every _EpochGraphs of this process, for release_graphs
_ALL_GRAPHS: "weakref.WeakSet[_EpochGraphs]" = weakref.WeakSet()


def release_graphs() -> None:
    """Destroy every CUDA graph ``make_train_epoch`` has captured in this
    process (an epoch function called again captures anew).  NCCL destroys
    a communicator only after every graph that captured one of its
    collectives is gone, and waits for them without a limit, so a mesh
    rank calls this (``hlax_torch.parallel.distributed.destroy``) before it
    leaves the process group."""
    if any(g.replays for g in _ALL_GRAPHS):
        torch.cuda.synchronize()
        for g in _ALL_GRAPHS:
            g.replays.clear()


def uses_graphs(device, mesh=None) -> bool:
    """Whether ``make_train_epoch`` captures the step on ``device``: on CUDA,
    alone or on an NCCL mesh; never on the CPU, and never over gloo, whose
    collectives go through the host and cannot be captured."""
    return torch.device(device).type == "cuda" and (
        mesh is None or mesh.backend == "nccl")


def capture_error_mode(mesh=None) -> str:
    """The ``cudaStreamCaptureMode`` of ``make_train_epoch``'s captures.
    Alone, "global": no thread may make an unsafe CUDA call while the step
    is captured.  On an NCCL mesh, "thread_local": ProcessGroupNCCL's
    watchdog thread queries the CUDA events of earlier collectives at any
    time, and under "global" such a query during a capture invalidates it;
    this thread's own calls stay checked.  (On the H100s a lone captured
    all-reduce ran in either mode; the mesh step was run in this one.)"""
    return "global" if mesh is None else "thread_local"


def make_train_epoch(model: HLVAE, spec0, spec1, cfg: TrainConfig,
                     unroll: int = 1, pregather: bool = False, mesh=None):
    """Returns ``epoch(state, staged, idx_batches, eps=None) -> metrics``,
    the counterpart of hlax's one-dispatch epoch (``make_train_epoch``,
    ``hlax/train/step.py:297-332``): the train step over the batches of
    subject indices ``idx_batches`` [nb, S] (-1 = padding subject), each
    gathered on the device from ``staged``, or with ``pregather`` all of
    them first in one gather (``gather_epoch``).  ``eps`` [nb, S*T, z]
    injects each step's reparameterization noise (else drawn from
    ``state.generator``).  Returns each metric of ``METRICS`` as numpy [nb],
    read from the device once a call; it updates ``state`` in place.

    On CUDA the steps run as CUDA graphs.  The first ``GRAPH_WARMUP`` steps
    of the first call run eagerly on the capture's side stream; then the
    step is captured, ``unroll`` consecutive steps to a graph (hlax's
    ``--scan_unroll``; the remainder of a call gets a graph of its own),
    reading its batch from static buffers that are filled before each
    replay, and drawing its noise from ``state.generator``, registered with
    the graph.  So no step runs twice and none is lost: the step count and
    the trajectory are the eager ones.  Capture records each kernel launch
    once, and each replay adds those counts to the kernels' counters
    (``hlax_torch.ops.counters``).
    The graphs hold the addresses of the state's tensors: restore a
    checkpoint before the first call, not after (a later call raises if
    they moved).  On the CPU the same steps run eagerly.

    With a ``mesh``, the steps are the mesh step's on this rank's share of
    the state and its block of the data (``make_train_epoch_mesh`` takes
    the mesh's index batches).  Over NCCL they are captured as above, the
    collectives in the graphs: every rank captures at the same step (the
    warm-up and ``unroll`` are the same on every rank, as is the number of
    batches) and issues the same collectives in the same order each step,
    and the gradient reducer's host sync runs in the warm-up.  Over gloo
    they run eagerly (``uses_graphs``)."""
    step = make_train_step(model, spec0, spec1, cfg, mesh=mesh)
    graphs = _EpochGraphs(step, max(1, int(unroll)),
                          capture_error_mode(mesh))
    model_dt = str(next(model.parameters()).dtype).removeprefix("torch.")
    # the eager step's dtypes (bfloat16, which numpy lacks, as float32)
    model_dt = {"bfloat16": "float32"}.get(model_dt, model_dt)
    dtypes = {m: model_dt for m in METRICS}
    dtypes["kld"] = str(cfg.gp_dtype).removeprefix("torch.")

    def epoch(state: TrainState, staged, idx_batches, eps=None
              ) -> Dict[str, np.ndarray]:
        from hlax_torch.data.dataset import gather_epoch

        dev = staged["valid"].device
        idx = torch.as_tensor(np.asarray(idx_batches), device=dev)
        nb = idx.shape[0]
        feed = gather_epoch(staged, idx) if pregather else {"idx": idx}
        if eps is not None:
            feed["eps"] = torch.as_tensor(eps, device=dev)
        out = torch.empty((len(METRICS), nb), dtype=torch.float64,
                          device=dev)
        if uses_graphs(dev, mesh):
            graphs(state, staged, feed, nb, out)
        else:
            for j in range(nb):
                out[:, j] = _metrics_column(step(
                    state, *_step_inputs(staged, feed, j)))
        host = out.cpu().numpy()
        return {m: host[i].astype(dtypes[m]) for i, m in enumerate(METRICS)}

    return epoch


def make_train_epoch_mesh(model: HLVAE, spec0, spec1, cfg: TrainConfig, mesh,
                          unroll: int = 1):
    """Returns ``epoch(state, staged, idx_batches, eps=None) -> metrics``,
    the counterpart of hlax's ``make_train_epoch_mesh``
    (``hlax/train/step.py:335-363``) on one rank of ``mesh``: ``state`` is
    the rank's share (``shard_state``), ``staged`` its block of subjects
    (``stage_dataset_mesh``), ``idx_batches`` the mesh's local indices
    [nb, n_data, S_loc] (``epoch_subject_batches_mesh``, the same on every
    rank), of which the rank takes its data shard's; ``eps`` [nb,
    n_data * S_loc * T, z] injects the global batches' noise, of which it
    takes its rows.  The metrics are the global batches'; the steps are
    ``make_train_epoch``'s with the mesh: CUDA graphs over NCCL, eager
    over gloo."""
    epoch = make_train_epoch(model, spec0, spec1, cfg, unroll=unroll,
                             mesh=mesh)

    def epoch_mesh(state: TrainState, staged, idx_batches, eps=None
                   ) -> Dict[str, np.ndarray]:
        idx = np.asarray(idx_batches)[:, mesh.d]
        if eps is not None:
            rows = idx.shape[1] * staged["valid"].shape[1]
            eps = eps[:, mesh.d * rows:(mesh.d + 1) * rows]
        return epoch(state, staged, idx, eps)

    return epoch_mesh
