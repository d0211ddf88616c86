"""Training step: VAE NLL + sparse-GP KLD bound + Adam + natural gradient
(port of ``hlax/train/step.py``).

  * loss = sum(nll) * P/P_batch + KLD_upper_bound
  * Adam(lr=1e-3) over {vae, kernel0, kernel1, zt [, m, H] [, noise]};
    torch's Adam update rule is optax.adam's (eps outside the square root,
    bias correction on).
  * with natural_gradient, (m, H) leave Adam and take the closed-form
    natural-gradient update after each step, under ``torch.no_grad()``;
    ``nat_grad_f64`` runs that chain in float64 whatever the GP dtype.

The step runs eagerly, one batch at a time; ``train_epoch`` loops it over
batches gathered on the device by ``hlax_torch.data.dataset.gather_batch``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from hlax_torch.eval import metrics as mx
from hlax_torch.gp import elbo as gp_elbo
from hlax_torch.gp import kernels as gp_kernels
from hlax_torch.models.hlvae import HLVAE, nll_from_log_p


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
    for t in trainable(state, cfg):
        t.requires_grad_(True)
    return torch.optim.Adam(trainable(state, cfg), lr=cfg.lr)


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


def make_train_step(model: HLVAE, spec0, spec1, cfg: TrainConfig):
    """Returns ``step(state, batch, eps=None) -> metrics``; it updates
    ``state`` in place.  ``batch`` holds S*T_max flat rows (data, mask,
    theta_mask, labels) and valid [S, T_max]; ``eps`` [S*T_max, z_dim]
    injects the reparameterization noise (else drawn from
    ``state.generator``).  Metrics are 0-dim tensors, left on the device."""
    layout = model.cfg.layout
    # The reference's per-batch recon metric overwrites its value once per
    # type, so only the type whose first raw-order occurrence is LAST
    # survives.  Reproduce that.
    kinds_raw = layout.var_kinds_grouped()[np.asarray(layout.raw_inv)]
    last_kind = list(dict.fromkeys(kinds_raw))[-1]

    def recon_metric(params, data, mask, row_valid):
        mean_rec, _ = mx.statistics(params, layout, model.cfg.conv)
        truth = mx.discrete_transform(data, layout)
        true_mask = row_valid[:, None] * torch.ones_like(mask)
        _, err_missing, partial = mx.error_computation(
            truth, mean_rec, layout, mask * row_valid[:, None],
            conv=model.cfg.conv, true_mask=true_mask)
        recon = partial[last_kind]["error_all"].sum() * row_valid.sum()
        return recon, err_missing.sum()

    def step(state: TrainState, batch, eps: Optional[torch.Tensor] = None):
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        out = state.vae(batch["data"], batch["mask"], batch["theta_mask"],
                        eps=eps, generator=state.generator)
        nll = nll_from_log_p(out["log_p_x"]).sum()

        valid = batch["valid"]
        S, T = valid.shape
        gdt = cfg.gp_dtype
        x_st = batch["labels"].reshape(S, T, -1).to(gdt)
        mu_st = out["mu"].reshape(S, T, -1).to(gdt)
        log_v_st = out["log_var"].reshape(S, T, -1).to(gdt)
        H = state.H if cfg.natural_gradient else state.H @ state.H.mT
        noise = gp_kernels.noise_value(state.raw_noise, cfg.constrain_scales)
        kld, gm, gH, iH = gp_elbo.kld_upper_bound(
            spec0, state.k0, spec1, state.k1, noise, state.m, H, state.zt,
            x_st, valid.to(gdt), mu_st, log_v_st, cfg.P_tot, cfg.N_tot,
            cfg.eps, natural_gradient=cfg.natural_gradient,
            nat_grad_dtype=torch.float64 if cfg.nat_grad_f64 else None)

        P_batch = (valid.sum(dim=1) > 0).to(nll.dtype).sum()
        nll_scaled = nll * cfg.P_tot / P_batch
        loss = nll_scaled + kld.to(nll.dtype)
        loss.backward()
        opt.step()

        with torch.no_grad():
            row_valid = valid.reshape(-1).to(batch["mask"].dtype)
            params = [tuple(t.detach() for t in p) if isinstance(p, tuple)
                      else p.detach() for p in out["params"]]
            recon, miss = recon_metric(params, batch["data"], batch["mask"],
                                       row_valid)
            if cfg.natural_gradient:
                state.m, state.H = gp_elbo.natural_gradient_update(
                    state.m, state.H, gm.detach(), gH.detach(),
                    cfg.natural_gradient_lr, iH=iH.detach(),
                    jitter=cfg.nat_grad_jitter)
        state.step += 1
        return {"loss": loss.detach(), "nll": nll_scaled.detach(),
                "kld": kld.detach(), "recon": recon, "miss_recon": miss}

    return step


def train_epoch(step, state: TrainState, staged, idx_batches: np.ndarray
                ) -> Dict[str, np.ndarray]:
    """One epoch: ``step`` over the batches of subject indices
    ``idx_batches`` [nb, S] (-1 = padding subject), each gathered on the
    device.  Returns the metrics stacked [nb] as numpy (one sync a
    epoch)."""
    from hlax_torch.data.dataset import gather_batch

    dev = staged["valid"].device
    idx = torch.as_tensor(np.asarray(idx_batches), device=dev)
    ms = [step(state, gather_batch(staged, i)) for i in idx]
    return {k: torch.stack([m[k] for m in ms]).cpu().numpy()
            for k in ms[0]}
