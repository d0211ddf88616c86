"""HLVAE: heterogeneous-likelihood VAE, conv and MLP encoder/decoder paths
(port of ``hlax/models/hlvae.py``).

Public layouts are hlax's: grouped data [B, n_exp], mask [B, n_raw], theta
mask [B, n_theta], decoder features y [B, n_raw, y_dim] in grouped order.
The image stack inside runs NCHW with torch's weight layouts;
``hlax_torch.convert`` maps hlax's flax parameters onto this module.

  * Representation_One_Hot: every cat/ordinal one-hot block is scalarized
    to one channel per raw variable before the conv stack.
  * Theta routing: each head is evaluated once and its gradient gated by
    the theta mask, ``theta = h.detach() + mask * (h - h.detach())``.
  * ``_max_pool_2x2``: its backward sends the cotangent to every tied
    element of a window, as hlax's custom VJP does (``nn.MaxPool2d`` picks
    one winner).

The MLP path (``conv=False``, the tabular panels) reads the normalized
grouped data [B, n_exp] straight into the encoder MLP, and ``y_layer``
emits n_raw * y_dim features reshaped straight to grouped order: no
representation layer, no sigmoid on real means and no division by 255.

Options, as in hlax:

  * ``fused_conv``: the image stack as hlax's pool-fused patch matmuls
    (``ops.convfuse.conv_pool_fused``/``conv_transpose_fused``, NHWC inside,
    converted at the stack's two ends) instead of cuDNN's convolutions; the
    same parameters.
  * ``compute_dtype`` (e.g. ``torch.bfloat16``): only the conv stack, the
    encoder and decoder MLPs and ``y_layer`` compute in it, each parameter
    cast at its use; the mean and log-variance layers take the hidden
    activations back up to the parameters' dtype, and the heads, the
    likelihoods and the GP stay in the model's and the GP's dtypes.
  * The all-bfloat16 model is ``model.to(torch.bfloat16)``: parameters, and
    with them everything the model computes, in bfloat16.
  * ``precision`` (JAX's names, ``hlax_torch.precision``): hlax's split
    (``hlax/gp/elbo.py:31-43``).  Its default, "default", runs the float32
    convolutions, the fused stack's patch matmuls and the dense layers
    (the MLPs, ``y_layer``, the mean and log-variance layers) in TF32,
    forward and backward, as JAX's default precision does on an H100;
    "highest" runs them in full float32.  Only where the stacks compute in
    float32: float64 and both bfloat16 options are untouched.  The GP runs
    in full float32 either way.  The observation heads (``fusion``'s
    kernels) keep their 5-wide products in full float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hlax_torch import device_constant, resolve_device
from hlax_torch import precision as prec
from hlax_torch.ops import convfuse as cf
from hlax_torch.ops import fusion
from hlax_torch.ops import likelihoods as lik
from hlax_torch.ops.normalization import NormParams, batch_normalization
from hlax_torch.profiling import region
from hlax_torch.types import TypeLayout

_INIT_STD = 0.05   # normal(0.05) init of dense layers and heads


@dataclasses.dataclass(frozen=True)
class HLVAEConfig:
    layout: TypeLayout
    z_dim: int = 32
    h_dims: Tuple[int, ...] = (500,)
    y_dim: int = 5
    conv: bool = True
    logvar_network: bool = False
    vy_init_real: float = 1.0
    vy_init_pos: float = 0.5
    vy_fixed: bool = False
    image_side: int = 36
    # the image stack as patch matmuls (``ops.convfuse``) instead of cuDNN's
    # convolutions; off by default, as in hlax
    fused_conv: bool = False
    # dtype of the conv stack, the encoder/decoder MLPs and y_layer; None =
    # the parameters' dtype
    compute_dtype: Optional[torch.dtype] = None
    # JAX's matmul precision of the VAE's float32 operations
    # (``hlax_torch.precision``): "default" = TF32 on the card
    precision: str = prec.DEFAULT

    def __post_init__(self):
        prec.uses_tf32(self.precision)    # a known name

    @property
    def n_raw(self) -> int:
        return self.layout.n_raw

    @property
    def n_exp(self) -> int:
        return self.layout.n_exp


def _log_vy_init(vy: float) -> float:
    # log(vy - exp(min_log_vy))
    return math.log(vy - math.exp(lik.MIN_LOG_VY))


class _MaxPool2x2(torch.autograd.Function):
    """2x2 stride-2 max pool over NCHW whose backward gives the cotangent to
    every element equal to its window's maximum."""

    @staticmethod
    def forward(ctx, h):
        B, C, H, W = h.shape
        hr = h.reshape(B, C, H // 2, 2, W // 2, 2)
        o = hr.amax(dim=(3, 5))
        ctx.save_for_backward(h, o)
        return o

    @staticmethod
    def backward(ctx, g):
        h, o = ctx.saved_tensors
        B, C, H, W = h.shape
        hr = h.reshape(B, C, H // 2, 2, W // 2, 2)
        tied = hr == o[:, :, :, None, :, None]
        gb = torch.where(tied, g[:, :, :, None, :, None],
                         torch.zeros((), dtype=g.dtype, device=g.device))
        return gb.reshape(h.shape)


def max_pool_2x2(h: torch.Tensor) -> torch.Tensor:
    return _MaxPool2x2.apply(h)


class _PermuteColumns(torch.autograd.Function):
    """x[:, perm] for a permutation ``perm`` of x's columns, whose backward
    is the gather by the inverse permutation ``inv``: the same values as
    the index's backward (each column receives one cotangent), without its
    sort and atomic adds."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x.index_select(1, perm)

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        return g.index_select(1, inv), None, None


def permute_columns(x: torch.Tensor, perm: torch.Tensor,
                    inv: torch.Tensor) -> torch.Tensor:
    """``x[:, perm]`` for the permutation ``perm`` (inverse ``inv``)."""
    return _PermuteColumns.apply(x, perm, inv)


def _linear(x, layer: nn.Linear, dtype: torch.dtype,
            tf32: bool) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype``: input and parameters cast to it
    (flax's ``Dense(dtype=...)``); no cast when all are in it already.  In
    TF32 when ``tf32``."""
    args = x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype)
    return prec.linear(*args) if tf32 else F.linear(*args)


def _normal(shape, gen, device, std=_INIT_STD):
    return nn.Parameter(torch.randn(shape, generator=gen, device=device) * std)


def _dense(n_in, n_out, gen, device) -> nn.Linear:
    layer = nn.Linear(n_in, n_out, device=device)
    with torch.no_grad():
        layer.weight.normal_(0.0, _INIT_STD, generator=gen)
        layer.bias.normal_(0.0, _INIT_STD, generator=gen)
    return layer


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen) -> None:
    # flax lecun_normal: truncated normal (+-2 sd) with variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class HLVAE(nn.Module):
    """Parameters are drawn from ``generator`` (flax's init distributions),
    which must live on ``device`` (CUDA unless the caller asks for the CPU);
    ``hlax_torch.convert`` overwrites them with hlax's when needed."""

    def __init__(self, cfg: HLVAEConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        lay = cfg.layout
        gen, dev = generator, device
        self._beta_ranges = np.array(lay.beta_ranges)

        # --- encoder ---------------------------------------------------
        self.rep_w = nn.ParameterDict()
        self.rep_b = nn.ParameterDict()
        self.conv1 = self.conv2 = self.deconv1 = self.deconv2 = None
        feat = cfg.image_side // 4   # 36 -> 9 after two stride-2 pools
        if cfg.conv:
            for gi, g in enumerate(lay.groups):
                if g.kind in ("cat", "ordinal"):
                    self.rep_w[str(gi)] = _normal((g.n_vars, g.nclass), gen,
                                                  dev)
                    self.rep_b[str(gi)] = _normal((g.n_vars,), gen, dev)
            self.conv1 = nn.Conv2d(1, 16, 3, padding=1, device=dev)
            self.conv2 = nn.Conv2d(16, 32, 3, padding=1, device=dev)
            dims = (32 * feat * feat,) + tuple(cfg.h_dims)
        else:
            dims = (lay.n_exp,) + tuple(cfg.h_dims)
        self.enc_mlp = nn.ModuleList(
            _dense(a, b, gen, dev) for a, b in zip(dims[:-1], dims[1:]))
        self.mean_layer = _dense(dims[-1], cfg.z_dim, gen, dev)
        self.log_var_layer = _dense(dims[-1], cfg.z_dim, gen, dev)

        # --- decoder ---------------------------------------------------
        ddims = (cfg.z_dim,) + tuple(reversed(cfg.h_dims))
        self.dec_mlp = nn.ModuleList(
            _dense(a, b, gen, dev) for a, b in zip(ddims[:-1], ddims[1:]))
        self.y_layer = _dense(ddims[-1], 32 * feat * feat if cfg.conv
                              else lay.n_raw * cfg.y_dim, gen, dev)
        if cfg.conv:
            self.deconv1 = nn.ConvTranspose2d(32, 16, 4, stride=2, padding=1,
                                              device=dev)
            self.deconv2 = nn.ConvTranspose2d(16, cfg.y_dim, 4, stride=2,
                                              padding=1, device=dev)
            for conv, fan_in in ((self.conv1, 9), (self.conv2, 9 * 16),
                                 (self.deconv1, 16 * 32),
                                 (self.deconv2, 16 * 16)):
                _lecun_normal_(conv.weight, fan_in, gen)
                nn.init.zeros_(conv.bias)

        # --- observation heads -----------------------------------------
        self.obs = nn.ParameterDict()
        for gi, g in enumerate(lay.groups):
            d = g.n_vars
            ncol = g.nclass - 1 if g.kind == "cat" else 1
            self.obs[f"w_{gi}"] = _normal((d, cfg.y_dim, ncol), gen, dev)
            self.obs[f"b_{gi}"] = _normal((d, ncol), gen, dev)
            if cfg.logvar_network and g.kind in ("real", "pos"):
                self.obs[f"wv_{gi}"] = _normal((d, cfg.y_dim, 1), gen, dev)
                self.obs[f"bv_{gi}"] = _normal((d, 1), gen, dev)
            if g.kind == "ordinal":
                self.obs[f"th_{gi}"] = nn.Parameter(
                    torch.ones((d, g.nclass - 1), device=dev))

        # --- global observation-noise parameters -----------------------
        d_real = sum(g.n_vars for g in lay.groups if g.kind == "real")
        d_pos = sum(g.n_vars for g in lay.groups if g.kind == "pos")
        self.log_vy_real = self.log_vy_pos = None
        if not cfg.logvar_network:
            if d_real:
                self.log_vy_real = nn.Parameter(torch.full(
                    (d_real,), _log_vy_init(cfg.vy_init_real), device=dev))
            if d_pos:
                self.log_vy_pos = nn.Parameter(torch.full(
                    (d_pos,), _log_vy_init(cfg.vy_init_pos), device=dev))
        self.disp_param = nn.Parameter(torch.ones((1,), device=dev))
        self.register_buffer("raw_inv", torch.as_tensor(
            lay.raw_inv, device=dev), persistent=False)
        self.register_buffer("raw_perm", torch.as_tensor(
            lay.raw_perm, device=dev), persistent=False)

    # ------------------------------------------------------------------
    # encoder
    # ------------------------------------------------------------------

    def encode(self, data, mask, norm_data=None):
        """data [B, n_exp] grouped, mask [B, n_raw] grouped -> (mu, log_var).
        ``norm_data``: the batch normalization's output, made here when
        None (the conv model's kernel, ``fusion.rep_image``, needs none)."""
        cfg = self.cfg
        dt, cdt = self._dtypes()
        tf32 = self._tf32(cdt)
        if cfg.conv:
            hidden = self._conv_features(data, mask, norm_data, cdt, tf32)
        else:
            if norm_data is None:
                norm_data, _ = batch_normalization(data, mask, cfg.layout,
                                                   cfg.conv)
            hidden = norm_data
        for layer in self.enc_mlp:
            hidden = F.relu(_linear(hidden, layer, cdt, tf32))
        # the reparameterization layers in the parameters' dtype
        hidden = hidden.to(dt)
        mu = _linear(hidden, self.mean_layer, dt, tf32)
        log_var = torch.clamp(_linear(hidden, self.log_var_layer, dt, tf32),
                              -15.0, 15.0)
        return mu, log_var

    def _dtypes(self):
        """(the parameters' dtype, the compute dtype of the stacks)."""
        dt = self.mean_layer.weight.dtype
        return dt, self.cfg.compute_dtype or dt

    def _tf32(self, cdt) -> bool:
        """Whether the VAE's operations run in TF32: under a TF32 precision
        where the parameters and the stacks are float32."""
        return (cdt == torch.float32 == self.mean_layer.weight.dtype
                and prec.uses_tf32(self.cfg.precision))

    def _conv_features(self, data, mask, norm_data, cdt, tf32):
        """The conv encoder's flattened features of the rows, computed in
        ``cdt`` (in TF32 when ``tf32``): each variable scalarized to one
        channel, in pixel order (``fusion.rep_image``), through the conv
        stack."""
        cfg = self.cfg
        img = fusion.rep_image(self, data, mask, norm_data).to(cdt)
        (w1, b1), (w2, b2) = ((c.weight.to(cdt), c.bias.to(cdt))
                              for c in (self.conv1, self.conv2))
        if cfg.fused_conv:
            h = img.permute(0, 2, 3, 1)                       # NHWC
            h = cf.conv_pool_fused(h, cf.conv_kernel_hwio(w1), b1, tf32)
            h = cf.conv_pool_fused(h, cf.conv_kernel_hwio(w2), b2, tf32)
            h = h.permute(0, 3, 1, 2)                         # NCHW
        else:
            h = max_pool_2x2(F.relu(cf.conv3x3_same(img, w1, b1, tf32)))
            h = max_pool_2x2(F.relu(cf.conv3x3_same(h, w2, b2, tf32)))
        return h.reshape(h.shape[0], -1)

    # ------------------------------------------------------------------
    # decoder
    # ------------------------------------------------------------------

    def decode_y(self, z):
        """z [B, z_dim] -> per-variable features y [B, n_raw, y_dim]
        (grouped order)."""
        cfg = self.cfg
        dt, cdt = self._dtypes()
        tf32 = self._tf32(cdt)
        h = z
        for layer in self.dec_mlp:
            h = F.relu(_linear(h, layer, cdt, tf32))
        y = _linear(h, self.y_layer, cdt, tf32)
        # the heads and the likelihoods in the parameters' dtype
        if not cfg.conv:
            return y.to(dt).reshape(-1, cfg.n_raw, cfg.y_dim)
        feat = cfg.image_side // 4
        y = y.reshape(-1, 32, feat, feat)
        (w1, b1), (w2, b2) = ((c.weight.to(cdt), c.bias.to(cdt))
                              for c in (self.deconv1, self.deconv2))
        if cfg.fused_conv:
            y = y.permute(0, 2, 3, 1)                         # NHWC
            y = F.relu(cf.conv_transpose_fused(
                y, cf.conv_transpose_kernel_hwio(w1), b1, tf32))
            y = cf.conv_transpose_fused(
                y, cf.conv_transpose_kernel_hwio(w2), b2, tf32)  # [B,36,36,y]
        else:
            y = F.relu(cf.conv_transpose4x4_s2(y, w1, b1, tf32))
            y = cf.conv_transpose4x4_s2(y, w2, b2, tf32)      # [B,y,36,36]
            y = y.permute(0, 2, 3, 1)
        # [B, 36, 36, y] -> [B, pixels, y] in pixel order -> grouped order
        y = y.to(dt).reshape(y.shape[0], -1, cfg.y_dim)
        return permute_columns(y, self.raw_perm, self.raw_inv)

    def _head(self, gi, g, y_g):
        """Observation head of group ``gi`` on y_g [B, d, y_dim]."""
        obs = self.obs
        if g.kind == "cat":
            th = torch.einsum("bdy,dyc->bdc", y_g, obs[f"w_{gi}"]) \
                + obs[f"b_{gi}"]
            th = F.pad(th, (1, 0))                      # pin class 0
            return th.reshape(th.shape[0], -1)
        mean = torch.einsum("bdy,dya->bda", y_g, obs[f"w_{gi}"]) \
            + obs[f"b_{gi}"]
        if g.kind == "ordinal":
            thr = obs[f"th_{gi}"].expand((y_g.shape[0],)
                                         + obs[f"th_{gi}"].shape)
            th = torch.cat([thr, mean], dim=-1)         # [B, d, c]
            return th.reshape(th.shape[0], -1)
        # count / real / pos / beta: mean head [B, d]
        mean = mean[..., 0]
        if g.kind == "real" and self.cfg.conv:
            mean = torch.sigmoid(mean)   # conv-real sigmoid
        if self.cfg.logvar_network and g.kind in ("real", "pos"):
            logv = (torch.einsum("bdy,dya->bda", y_g, obs[f"wv_{gi}"])
                    + obs[f"bv_{gi}"])[..., 0]
            return torch.cat([mean, logv], dim=-1)      # [means, logvars]
        return mean

    def theta_estimation(self, y, theta_mask):
        """Route features through the heads; the merged theta equals the
        reference's two-pass (observed with gradients, missing without)
        evaluation: one head pass with its gradient gated by the mask."""
        blocks = []
        for gi, g in enumerate(self.cfg.layout.groups):
            h = self._head(gi, g, y[:, g.raw_slice[0]:g.raw_slice[1], :])
            hs = h.detach()
            pm = theta_mask[:, g.theta_slice[0]:g.theta_slice[1]]
            blocks.append(hs + pm * (h - hs))
        return torch.cat(blocks, dim=1)   # [B, n_theta] grouped

    def loglik(self, theta, data, mask, norm_params: NormParams):
        """Per-type likelihoods. Returns (log_p_x [B,n_raw],
        log_p_x_missing [B,n_raw], params list)."""
        cfg = self.cfg
        lp_blocks, lpm_blocks, params = [], [], []
        for g in cfg.layout.groups:
            d_blk = data[:, g.exp_slice[0]:g.exp_slice[1]]
            m_blk = mask[:, g.raw_slice[0]:g.raw_slice[1]]
            t_blk = theta[:, g.theta_slice[0]:g.theta_slice[1]]
            if g.kind == "real":
                extra = self.log_vy_real
                if extra is not None and cfg.vy_fixed:
                    extra = extra.detach()
                if cfg.conv:
                    d_blk = d_blk / 255.0
                out = lik.loglik_real(d_blk, m_blk, t_blk,
                                      norm_params.real_mean,
                                      norm_params.real_var, extra, cfg.conv)
            elif g.kind == "pos":
                extra = self.log_vy_pos
                if extra is not None and cfg.vy_fixed:
                    extra = extra.detach()
                out = lik.loglik_pos(d_blk, m_blk, t_blk,
                                     norm_params.pos_mean_log,
                                     norm_params.pos_var_log, extra)
            elif g.kind == "cat":
                out = lik.loglik_cat(d_blk, m_blk, t_blk, g.nclass)
            elif g.kind == "ordinal":
                out = lik.loglik_ordinal(d_blk, m_blk, t_blk, g.nclass)
            elif g.kind == "count":
                out = lik.loglik_count(d_blk, m_blk, t_blk)
            else:   # beta
                ranges = device_constant(self._beta_ranges, theta.dtype,
                                         theta.device)
                out = lik.loglik_beta(d_blk, m_blk, t_blk, ranges,
                                      self.disp_param)
            lp_blocks.append(out["log_p_x"])
            lpm_blocks.append(out["log_p_x_missing"])
            params.append(out["params"])
        return (torch.cat(lp_blocks, dim=1), torch.cat(lpm_blocks, dim=1),
                params)

    def decode(self, z, data, mask, theta_mask, norm_params: NormParams):
        """z [B, z_dim] -> (log_p_x, log_p_x_missing, params, theta) of the
        rows ``data``/``mask`` under the batch statistics ``norm_params``."""
        with region("decoder"):
            y = self.decode_y(z)
        with region("heads_likelihoods"):
            return fusion.heads_loglik(self, y, theta_mask, data, mask,
                                       norm_params)

    def forward(self, data, mask, theta_mask,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                sample: bool = True, sums=None):
        """Full forward pass.  The reparameterization noise is ``eps`` when
        given, else drawn from ``generator``.  On a mesh, ``sums``
        (``hlax_torch.parallel.mesh.MeshSums``) makes the normalization's
        moments the global batch's."""
        with region("normalization"):
            if self.cfg.conv and not any(g.kind == "pos" for g in
                                         self.cfg.layout.groups):
                # conv mode takes no moments but a pos group's: the encoder
                # (``fusion.rep_image``) normalizes its own input
                norm_data, norm_params = None, NormParams(None, None, None,
                                                          None)
            else:
                norm_data, norm_params = batch_normalization(
                    data, mask, self.cfg.layout, self.cfg.conv, sums)
        with region("encoder"):
            mu, log_var = self.encode(data, mask, norm_data)
            if sample:
                if eps is None:
                    eps = torch.randn(mu.shape, generator=generator,
                                      dtype=mu.dtype, device=mu.device)
                z = mu + eps * torch.exp(0.5 * log_var)
            else:
                z = mu
        log_p_x, log_p_x_missing, params, theta = self.decode(
            z, data, mask, theta_mask, norm_params)
        return {
            "mu": mu, "log_var": log_var, "z": z,
            "log_p_x": log_p_x, "log_p_x_missing": log_p_x_missing,
            "params": params, "theta": theta,
        }


def nll_from_log_p(log_p_x):
    """-sum over columns."""
    return -torch.sum(log_p_x, dim=1)
