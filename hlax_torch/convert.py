"""Carry hlax's state (numpy arrays of its flax/JAX pytrees) into the port.

Weight mapping (flax -> torch):
  * Conv kernel [kh, kw, in, out] -> Conv2d weight ``transpose(3, 2, 0, 1)``
    (both are cross-correlations, no flip).
  * ConvTranspose kernel -> ConvTranspose2d weight: spatial flip, then
    ``transpose(2, 3, 0, 1)``.
  * flax flattens conv features NHWC as (h, w, c), torch NCHW as (c, h, w):
    the dense layers on either side of the flatten (``enc_mlp.Dense_0`` and
    ``y_layer``) absorb the permutation.  The MLP model (``conv=False``) has
    no conv layers, no representation layer and no flatten: its dense
    layers map as they are.
  * Dense kernel [in, out] -> Linear weight ``.T``.
Takes plain numpy arrays, so it needs neither JAX nor hlax.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from hlax_torch.models.hlvae import HLVAE
from hlax_torch.train.step import TrainConfig, TrainState, make_optimizer


def _np(x) -> np.ndarray:
    return np.array(x, dtype=np.float64)


def load_hlax_vae(model: HLVAE, vae_params) -> None:
    """Overwrite ``model``'s parameters, in place, with hlax's flax param
    tree ``vae_params`` (``{"params": {...}}`` or its inner dict)."""
    p = vae_params.get("params", vae_params)
    cfg = model.cfg
    feat = cfg.image_side // 4
    ref = next(model.parameters())

    def put(dst: torch.Tensor, src) -> None:
        src = np.ascontiguousarray(src)
        if tuple(dst.shape) != src.shape:
            raise ValueError(f"shape {src.shape} does not fit {tuple(dst.shape)}")
        dst.copy_(torch.as_tensor(src, dtype=ref.dtype))

    with torch.no_grad():
        for gi, w in model.rep_w.items():
            put(w, _np(p[f"rep_w_{gi}"]))
            put(model.rep_b[gi], _np(p[f"rep_b_{gi}"]))
        if cfg.conv:
            for name in ("conv1", "conv2"):
                put(getattr(model, name).weight,
                    _np(p[name]["kernel"]).transpose(3, 2, 0, 1))
                put(getattr(model, name).bias, _np(p[name]["bias"]))
            for name in ("deconv1", "deconv2"):
                put(getattr(model, name).weight,
                    _np(p[name]["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1))
                put(getattr(model, name).bias, _np(p[name]["bias"]))
        for i, layer in enumerate(model.enc_mlp):
            k = _np(p["enc_mlp"][f"Dense_{i}"]["kernel"])
            if i == 0 and cfg.conv:   # input (h, w, c) -> (c, h, w)
                k = k.reshape(feat, feat, 32, -1).transpose(3, 2, 0, 1)
                put(layer.weight, k.reshape(k.shape[0], -1))
            else:
                put(layer.weight, k.T)
            put(layer.bias, _np(p["enc_mlp"][f"Dense_{i}"]["bias"]))
        for i, layer in enumerate(model.dec_mlp):
            put(layer.weight, _np(p["dec_mlp"][f"Dense_{i}"]["kernel"]).T)
            put(layer.bias, _np(p["dec_mlp"][f"Dense_{i}"]["bias"]))
        for name in ("mean_layer", "log_var_layer"):
            put(getattr(model, name).weight, _np(p[name]["kernel"]).T)
            put(getattr(model, name).bias, _np(p[name]["bias"]))
        k, b = _np(p["y_layer"]["kernel"]), _np(p["y_layer"]["bias"])
        if cfg.conv:   # output (h, w, c) -> (c, h, w)
            k = k.reshape(k.shape[0], feat, feat, 32).transpose(3, 1, 2, 0)
            k = k.reshape(-1, k.shape[-1]).T
            b = b.reshape(feat, feat, 32).transpose(2, 0, 1).reshape(-1)
        put(model.y_layer.weight, k.T)
        put(model.y_layer.bias, b)
        for key, w in model.obs.items():
            put(w, _np(p[f"obs_{key}"]))
        for name in ("log_vy_real", "log_vy_pos", "disp_param"):
            if getattr(model, name) is not None:
                put(getattr(model, name), _np(p[name]))


def state_from_hlax(vae_params, k0: List[Dict], k1: List[Dict], raw_noise,
                    zt, m, H, model: HLVAE, cfg: TrainConfig,
                    seed: int = 0) -> TrainState:
    """The port's TrainState from hlax's (numpy) state: ``model`` takes the
    VAE weights in place; kernel params, noise, zt, m and H become tensors
    of ``cfg.gp_dtype`` on the model's device; Adam starts fresh, as hlax's
    ``init_train_state`` does."""
    load_hlax_vae(model, vae_params)
    dev = next(model.parameters()).device
    t = lambda x: torch.as_tensor(_np(x), dtype=cfg.gp_dtype, device=dev)
    state = TrainState(
        vae=model,
        k0=[{k: t(v) for k, v in p.items()} for p in k0],
        k1=[{k: t(v) for k, v in p.items()} for p in k1],
        raw_noise=t(raw_noise), zt=t(zt), m=t(m), H=t(H), optimizer=None,
        generator=torch.Generator(device=dev).manual_seed(seed))
    state.optimizer = make_optimizer(state, cfg)
    return state
