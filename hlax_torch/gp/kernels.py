"""GP kernels as plain tensor functions + the kernel-spec compiler.

Port of ``hlax/gp/kernels.py``.  Semantics follow the reference kernel zoo
(Bin/Cat/Rbf factors, the two-additive-kernel composition of a shared
``spec0`` and a subject-level ``spec1``) with softplus-parametrized
lengthscales and outputscales.

A spec is static metadata (tuples of factors); parameters are a list of
dicts of tensors with a leading latent axis [L].  hlax vmaps one latent's
kernel over that axis; here the latent axis is a broadcast dimension.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def softplus(x):
    # log(1 + e^x) without torch's linear cut-over above x = 20
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y: float) -> float:
    return float(np.log(np.expm1(y)))


RAW_LS_INIT = inv_softplus(2.5)    # lengthscale init 2.5
RAW_OS_INIT = 0.0                  # outputscale raw init -> softplus(0)


@dataclasses.dataclass(frozen=True)
class KernelFactor:
    kind: str   # 'cat' | 'bin' | 'rbf' | 'catmod'
    dim: int    # active covariate column
    num: int = 0   # number of instances (catmod only)


@dataclasses.dataclass(frozen=True)
class KernelComponent:
    factors: Tuple[KernelFactor, ...]


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    components: Tuple[KernelComponent, ...]

    def __len__(self):
        return len(self.components)


def build_kernel_specs(
    cat_kernel: Sequence[int],
    bin_kernel: Sequence[int],
    sqexp_kernel: Sequence[int],
    cat_int_kernel: Sequence[Dict[str, int]],
    bin_int_kernel: Sequence[Dict[str, int]],
    covariate_missing_val: Sequence[Dict[str, int]],
    id_covariate: int,
) -> Tuple[KernelSpec, KernelSpec]:
    """Compile config lists into (spec0, spec1).  spec1 collects the
    components involving the id covariate (block-diagonal across subjects),
    spec0 everything else."""
    missing = {d["covariate"]: d["mask"] for d in covariate_missing_val}

    def masked(factors: List[KernelFactor], cov: int) -> List[KernelFactor]:
        if cov in missing:
            factors.append(KernelFactor("bin", missing[cov]))
        return factors

    comps0: List[KernelComponent] = []
    comps1: List[KernelComponent] = []

    for idx in cat_kernel:
        fs = masked([KernelFactor("cat", idx)], idx)
        (comps1 if idx == id_covariate else comps0).append(
            KernelComponent(tuple(fs)))
    for idx in sqexp_kernel:
        comps0.append(KernelComponent(tuple(masked([KernelFactor("rbf", idx)], idx))))
    for idx in bin_kernel:
        comps0.append(KernelComponent(tuple(masked([KernelFactor("bin", idx)], idx))))
    for d in cat_int_kernel:
        fs = masked([KernelFactor("cat", d["cat_covariate"])], d["cat_covariate"])
        fs += masked([KernelFactor("rbf", d["cont_covariate"])], d["cont_covariate"])
        (comps1 if d["cat_covariate"] == id_covariate else comps0).append(
            KernelComponent(tuple(fs)))
    for d in bin_int_kernel:
        fs = masked([KernelFactor("bin", d["bin_covariate"])], d["bin_covariate"])
        fs += masked([KernelFactor("rbf", d["cont_covariate"])], d["cont_covariate"])
        comps0.append(KernelComponent(tuple(fs)))

    return KernelSpec(tuple(comps0)), KernelSpec(tuple(comps1))


def init_kernel_params(spec: KernelSpec, latent_dim: int,
                       dtype=torch.float64, device=None):
    """Per-component params with leading latent axis: a list of dicts
    {'raw_os': [L], 'raw_ls_<i>': [L]} (one lengthscale per rbf factor)."""
    params = []
    for comp in spec.components:
        p = {"raw_os": torch.full((latent_dim,), RAW_OS_INIT, dtype=dtype,
                                  device=device)}
        for i, f in enumerate(comp.factors):
            if f.kind == "rbf":
                p[f"raw_ls_{i}"] = torch.full((latent_dim,), RAW_LS_INIT,
                                              dtype=dtype, device=device)
        params.append(p)
    return params


def _factor_matrix(f: KernelFactor, p_comp, i: int, x1, x2, lat):
    """x1 [Lb, *, N1, Q], x2 [Lb, *, N2, Q] -> [Lb, *, N1, N2]; ``lat``
    reshapes an [L] parameter to broadcast against the result."""
    a = x1[..., :, None, f.dim]
    b = x2[..., None, :, f.dim]
    if f.kind == "cat":
        return (a == b).to(x1.dtype)
    if f.kind == "bin":
        return (a + b == 2).to(x1.dtype)
    if f.kind == "catmod":
        # centered one-vs-rest categorical kernel: 1 on match,
        # -1/(num-1) otherwise
        eq = (a == b).to(x1.dtype)
        return eq - (1.0 - eq) / (f.num - 1)
    ls = lat(softplus(p_comp[f"raw_ls_{i}"]))
    d = (a - b) / ls
    return torch.exp(-0.5 * d * d)


def kernel_matrix(spec: KernelSpec, params, x1, x2,
                  x1_batched: bool = False, x2_batched: bool = False):
    """Latent-batched kernel matrix.

    x1/x2: [*, N, Q], or [L, *, N, Q] when the corresponding ``*_batched``
    flag is set (e.g. per-latent inducing points z [L, M, Q]).
    Returns [L, *, N1, N2].
    """
    leaves = [v for p in params for v in p.values()]
    L = leaves[0].shape[0] if leaves else 1
    s1 = x1.shape[1:] if x1_batched else x1.shape
    s2 = x2.shape[1:] if x2_batched else x2.shape
    batch = torch.broadcast_shapes(s1[:-2], s2[:-2])
    if not spec.components:
        return torch.zeros((L,) + tuple(batch) + (s1[-2], s2[-2]),
                           dtype=x1.dtype, device=x1.device)

    def lift(x, batched, s):
        # [Lb, 1.., *, N, Q] with the per-latent batch dims right-aligned
        pad = (1,) * (len(batch) - len(s[:-2]))
        lead = (x.shape[0],) if batched else (1,)
        return x.reshape(lead + pad + tuple(s))

    a, b = lift(x1, x1_batched, s1), lift(x2, x2_batched, s2)
    lat = lambda v: v.reshape((L,) + (1,) * (len(batch) + 2))
    out = None
    for comp, p in zip(spec.components, params):
        k = None
        for i, f in enumerate(comp.factors):
            km = _factor_matrix(f, p, i, a, b, lat)
            k = km if k is None else k * km
        k = lat(softplus(p["raw_os"])) * k
        out = k if out is None else out + k
    return out.expand((L,) + tuple(batch) + (s1[-2], s2[-2]))


def noise_init(latent_dim: int, constrain_scales: bool, dtype=torch.float64,
               device=None):
    """GaussianLikelihood noise: softplus raw with a 1e-8 floor; with
    constrain_scales the noise is pinned to 1 and frozen."""
    if constrain_scales:
        return torch.zeros((latent_dim,), dtype=dtype, device=device)
    return torch.full((latent_dim,), inv_softplus(1.0 - 1e-8), dtype=dtype,
                      device=device)


def noise_value(raw_noise, constrain_scales: bool):
    if constrain_scales:
        return torch.ones_like(raw_noise)
    return softplus(raw_noise) + 1e-8


def default_eps(dtype) -> float:
    """Dtype-aware jitter: 1e-6 in float64; float32 Cholesky needs a larger
    floor."""
    return 1e-6 if dtype == torch.float64 else 1e-4
