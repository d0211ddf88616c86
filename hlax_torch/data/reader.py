"""Data ingestion: CSV reading + heterogeneous encoding into grouped layout.

Port of ``hlax/data/reader.py``.  Reproduces the encoding semantics of the
reference reader (HL_VAE/read_functions.py:13-203):

  * ``cat``     -> one-hot over remapped categories (unique -> 0..nclass-1)
  * ``ordinal`` -> thermometer encoding via the cumsum trick
                   (read_functions.py:84-99)
  * ``count``   -> +1 shift when the observed minimum is 0
                   (read_functions.py:102-107)
  * ``real/pos/beta`` -> passthrough, NaN->0
  * masks: either a 2-column (row, col) position list (0- or 1-based) or a
    full 0/1 matrix (read_functions.py:128-139); effective mask is
    miss_mask * true_miss_mask.

Unlike the reference, the encoded arrays are returned in *type-major grouped
column order* (see hlax_torch.types), so all downstream device code uses static
slices.  ``TypeLayout.exp_inv`` etc. map back to original order.

CSV files are read by the port's copy of hlax's C++ parser
(``hlax_torch/native``), as hlax reads them.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

from hlax_torch.native.io import read_csv_matrix
from hlax_torch.types import TypeLayout, compile_layout


@dataclasses.dataclass
class HeterogeneousData:
    """Encoded dataset in grouped column order (numpy, host-side)."""

    layout: TypeLayout
    data: np.ndarray         # [N, n_exp]  encoded data, grouped order
    mask: np.ndarray         # [N, n_raw]  effective observation mask (miss*true)
    true_mask: np.ndarray    # [N, n_raw]  known-value mask
    theta_mask: np.ndarray   # [N, n_theta] param-space observation mask
    labels: np.ndarray       # [N, Q] covariates (possibly reordered, see dataset)
    n_samples: int
    n_variables: int


def _read_csv_matrix(path: str) -> np.ndarray:
    """Float matrix; blank/empty fields -> NaN; a header row is skipped.
    The native C++ parser (``hlax_torch.native.io``) when it builds, with
    hlax's plain-Python fallback."""
    return read_csv_matrix(path)


def _read_mask(path: Optional[str], shape: Tuple[int, int]) -> np.ndarray:
    """Mask file: (row,col) position list (0/1-based) or full matrix."""
    mask = np.ones(shape, dtype=np.float64)
    if path is None or not os.path.isfile(path):
        return mask
    positions = _read_csv_matrix(path).astype(np.int64)
    if positions.size == 0:
        return mask
    if positions.shape[1] == 2:
        if positions.min() == 0:
            mask[positions[:, 0], positions[:, 1]] = 0
        else:   # 1-based indices (read_functions.py:54)
            mask[positions[:, 0] - 1, positions[:, 1] - 1] = 0
        return mask
    return positions.astype(np.float64)


def read_types_csv(path: str) -> Tuple[Mapping[str, object], ...]:
    with open(path) as f:
        return tuple(
            {k: v for k, v in row.items()}
            for row in csv.DictReader(f, skipinitialspace=True)
        )


def read_ranges_csv(path: Optional[str], types_dict) -> Tuple[Tuple[float, float], ...]:
    """Beta variable (min, max+1e-3) ranges (read_functions.py:117-119)."""
    if path is None or not os.path.isfile(path):
        return ()
    with open(path) as f:
        rows = tuple(
            {k: v for k, v in row.items()}
            for row in csv.DictReader(f, skipinitialspace=True)
        )
    out = []
    for i, t in enumerate(types_dict):
        if str(t["type"]) == "beta":
            out.append((float(int(rows[i]["min"])), float(int(rows[i]["max"])) + 1e-3))
    return tuple(out)


def encode_raw(
    raw: np.ndarray,
    types_dict: Sequence[Mapping[str, object]],
    miss_mask: Optional[np.ndarray] = None,
    true_miss_mask: Optional[np.ndarray] = None,
    logvar_network: bool = False,
    beta_ranges: Sequence[Sequence[float]] = (),
) -> HeterogeneousData:
    """Encode a raw [N, n_raw_cols] matrix into grouped heterogeneous layout."""
    norm = [{"type": str(t["type"]), "dim": int(t["dim"]), "nclass": int(t["nclass"])}
            for t in types_dict]
    n = raw.shape[0]
    n_variables = raw.shape[1]

    if true_miss_mask is None:
        true_miss_mask = np.ones((n, n_variables), dtype=np.float64)
    if miss_mask is None:
        miss_mask = np.ones((n, n_variables), dtype=np.float64)
    miss_mask = miss_mask * true_miss_mask   # read_functions.py:139

    blocks = []
    col = 0
    for t in norm:
        dim = t["dim"]
        x = raw[:, col]
        if t["type"] == "cat":
            # remap observed categories to 0..nclass-1 (read_functions.py:70-81)
            nclass = t["nclass"]
            observed = x[~np.isnan(x)]
            fill = np.unique(observed)[0] if observed.size else 0.0
            xi = np.nan_to_num(x, nan=fill).astype(np.int64)
            _, indexes = np.unique(xi, return_inverse=True)
            codes = np.arange(nclass)[np.clip(indexes, 0, nclass - 1)]
            one_hot = np.zeros((n, nclass), dtype=np.float64)
            one_hot[np.arange(n), codes] = 1.0
            one_hot[np.isnan(x), :] = 0.0
            blocks.append(one_hot)
        elif t["type"] == "ordinal":
            # thermometer via cumsum trick (read_functions.py:84-99)
            nclass = t["nclass"]
            observed = x[~np.isnan(x)]
            fill = np.unique(observed)[0] if observed.size else 0.0
            xi = np.nan_to_num(x, nan=fill).astype(np.int64)
            _, indexes = np.unique(xi, return_inverse=True)
            codes = np.arange(nclass)[np.clip(indexes, 0, nclass - 1)]
            aux = np.zeros((n, 1 + nclass), dtype=np.float64)
            aux[:, 0] = 1.0
            aux[np.arange(n), 1 + codes] = -1.0
            aux = np.cumsum(aux, axis=1)
            blocks.append(aux[:, :-1])
        elif t["type"] == "count":
            v = x.copy()
            if np.nanmin(v) == 0:
                v = v + 1.0   # read_functions.py:102-105
            blocks.append(np.nan_to_num(v, nan=0.0)[:, None])
        else:   # real / pos / beta
            blocks.append(np.nan_to_num(raw[:, col:col + dim], nan=0.0))
        col += dim

    data = np.concatenate(blocks, axis=1)

    layout = compile_layout(norm, logvar_network=logvar_network, beta_ranges=beta_ranges)
    # permute to grouped order (the single host-side gather)
    data_g = np.ascontiguousarray(data[:, layout.exp_perm])
    mask_g = np.ascontiguousarray(miss_mask[:, layout.raw_perm])
    true_g = np.ascontiguousarray(true_miss_mask[:, layout.raw_perm])
    theta_mask_g = layout.expand_raw_to_theta(mask_g)

    return HeterogeneousData(
        layout=layout,
        data=data_g,
        mask=mask_g,
        true_mask=true_g,
        theta_mask=theta_mask_g,
        labels=np.zeros((n, 0)),
        n_samples=n,
        n_variables=n_variables,
    )


def read_data(
    data_file: str,
    miss_file: Optional[str],
    true_miss_file: Optional[str],
    types_file: str,
    range_file: Optional[str] = None,
    logvar_network: bool = False,
) -> HeterogeneousData:
    """Full-file equivalent of the reference read_data (read_functions.py:13)."""
    types_dict = read_types_csv(types_file)
    beta_ranges = read_ranges_csv(range_file, types_dict)
    raw = _read_csv_matrix(data_file)
    n, n_variables = raw.shape
    true_mask = _read_mask(true_miss_file, (n, n_variables))
    miss_mask = _read_mask(miss_file, (n, n_variables))
    return encode_raw(
        raw, types_dict, miss_mask, true_mask,
        logvar_network=logvar_network, beta_ranges=beta_ranges,
    )
