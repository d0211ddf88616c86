"""Longitudinal dataset wrapper + subject-major padded batching.

Port of ``hlax/data/dataset.py``: subjects are grouped whole and padded to
T_max, so ragged subjects turn into static [S, T_max] shapes with a validity
mask.  For Health-MNIST (n_variables == 1296) the label CSV columns
[subject, digit, angle, disease, disease_time, gender, time_age, location]
are reordered to [time_age, disease_time, subject, gender, disease,
location] so id_covariate=2 is the subject.

``stage_dataset`` uploads the padded dataset once as device tensors,
``gather_batch`` builds each batch on the device from a subject-index tensor
and ``gather_epoch`` all of an epoch's batches at once.  On a mesh a rank
stages only its own block of subjects (``stage_dataset_mesh``) and gathers
its batches from it by local indices (``epoch_subject_batches_mesh``).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from hlax_torch.data.reader import HeterogeneousData, read_data

HEALTH_MNIST_LABEL_ORDER = [6, 4, 0, 5, 3, 7]


@dataclasses.dataclass
class LongitudinalDataset:
    het: HeterogeneousData
    labels: np.ndarray          # [N, Q] float64 (NaN -> 0)
    id_covariate: int
    conv: bool = True
    use_ranges: bool = False

    # derived
    subject_ids: np.ndarray = dataclasses.field(init=False)
    subject_start: np.ndarray = dataclasses.field(init=False)
    subject_end: np.ndarray = dataclasses.field(init=False)
    T_max: int = dataclasses.field(init=False)
    # device copies of (data, mask, theta_mask) by (dtype, device), made by
    # ``hlax_torch.eval.validate.device_het`` and kept with the dataset
    staged: dict = dataclasses.field(init=False, repr=False,
                                     default_factory=dict)

    def __post_init__(self):
        ids = self.labels[:, self.id_covariate]
        # subjects in order of first appearance; rows per subject contiguous
        _, first = np.unique(ids, return_index=True)
        order = np.sort(first)
        self.subject_ids = ids[order]
        starts = list(order)
        ends = starts[1:] + [len(ids)]
        self.subject_start = np.asarray(starts)
        self.subject_end = np.asarray(ends)
        self.T_max = int((self.subject_end - self.subject_start).max())

    def __len__(self):
        return self.het.n_samples

    @property
    def P(self) -> int:
        return len(self.subject_ids)

    @property
    def Q(self) -> int:
        return self.labels.shape[1]

    @property
    def layout(self):
        return self.het.layout


def _read_labels(path: str) -> np.ndarray:
    """Label CSV with a header row -> float64 matrix (empty/'nan' -> NaN)."""
    with open(path, "r") as f:
        rows = list(csv.reader(f))[1:]
    return np.asarray([[float(x) if x != "" else np.nan for x in r]
                       for r in rows if r], dtype=np.float64)


def load_dataset(
    root_dir: str,
    data_file: str,
    label_file: str,
    mask_file: Optional[str],
    types_file: str,
    true_miss_file: Optional[str] = None,
    range_file: Optional[str] = None,
    id_covariate: int = 2,
    logvar_network: bool = False,
    conv: bool = True,
    use_ranges: bool = False,
) -> LongitudinalDataset:
    """File-based constructor mirroring HeterogeneousHealthMNISTDataset."""
    j = lambda p: os.path.join(root_dir, p) if p else None
    het = read_data(j(data_file), j(mask_file), j(true_miss_file),
                    j(types_file), j(range_file), logvar_network)
    labels = _read_labels(j(label_file))
    if het.n_variables == 1296:
        labels = labels[:, np.array(HEALTH_MNIST_LABEL_ORDER)]
    lab = np.nan_to_num(labels)
    het.labels = lab
    return LongitudinalDataset(het=het, labels=lab, id_covariate=id_covariate,
                               conv=conv, use_ranges=use_ranges)


def _pad_rows(ds: LongitudinalDataset, subj_idx: np.ndarray, t_max: int
              ) -> Dict[str, np.ndarray]:
    """Gather+pad rows of the given subjects into [S*T_max, ...] arrays."""
    het = ds.het
    s_count = len(subj_idx)
    n_exp, n_raw, n_theta = het.data.shape[1], het.mask.shape[1], het.theta_mask.shape[1]
    q = ds.labels.shape[1]
    B = s_count * t_max
    out = {
        "data": np.zeros((B, n_exp)),
        "mask": np.zeros((B, n_raw)),
        "theta_mask": np.zeros((B, n_theta)),
        "labels": np.zeros((B, q)),
        "valid": np.zeros((s_count, t_max)),
        "idx": np.full((B,), -1, dtype=np.int64),
    }
    for i, s in enumerate(subj_idx):
        if s < 0:
            continue   # padding subject
        a, b = ds.subject_start[s], ds.subject_end[s]
        t = b - a
        r0 = i * t_max
        out["data"][r0:r0 + t] = het.data[a:b]
        out["mask"][r0:r0 + t] = het.mask[a:b]
        out["theta_mask"][r0:r0 + t] = het.theta_mask[a:b]
        out["labels"][r0:r0 + t] = ds.labels[a:b]
        out["valid"][i, :t] = 1.0
        out["idx"][r0:r0 + t] = np.arange(a, b)
    return out


def subject_batches(
    ds: LongitudinalDataset,
    subjects_per_batch: int,
    rng: Optional[np.random.Generator] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield shuffled whole-subject padded batches; the last batch is padded
    with empty subjects so every batch has identical shapes."""
    order = np.arange(ds.P)
    if rng is not None:
        rng.shuffle(order)
    for i in range(0, ds.P, subjects_per_batch):
        chunk = order[i:i + subjects_per_batch]
        if len(chunk) < subjects_per_batch:
            chunk = np.concatenate(
                [chunk, -np.ones(subjects_per_batch - len(chunk), np.int64)])
        yield _pad_rows(ds, chunk, ds.T_max)


def full_padded(ds: LongitudinalDataset, t_max: Optional[int] = None
                ) -> Dict[str, np.ndarray]:
    """Whole dataset as one padded subject-major batch."""
    return _pad_rows(ds, np.arange(ds.P), t_max or ds.T_max)


def n_batches(ds: LongitudinalDataset, subjects_per_batch: int) -> int:
    return (ds.P + subjects_per_batch - 1) // subjects_per_batch


def epoch_subject_batches(P: int, subjects_per_batch: int,
                          rng: Optional[np.random.Generator] = None):
    """Subject-index batches for one epoch (host side, tiny arrays)."""
    order = np.arange(P)
    if rng is not None:
        rng.shuffle(order)
    for i in range(0, P, subjects_per_batch):
        chunk = order[i:i + subjects_per_batch]
        if len(chunk) < subjects_per_batch:
            chunk = np.concatenate(
                [chunk, -np.ones(subjects_per_batch - len(chunk), np.int64)])
        yield chunk


def _stage(ds: LongitudinalDataset, subj_idx: np.ndarray, dtype: torch.dtype,
           device) -> Dict[str, torch.Tensor]:
    """The subjects ``subj_idx`` (-1 = empty subject) as padded
    [len(subj_idx), T_max, ...] device tensors."""
    full = _pad_rows(ds, subj_idx, ds.T_max)
    P, T = len(subj_idx), ds.T_max
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return {
        "data": put(full["data"].reshape(P, T, -1)),
        "mask": put(full["mask"].reshape(P, T, -1)),
        "theta_mask": put(full["theta_mask"].reshape(P, T, -1)),
        "labels": put(full["labels"].reshape(P, T, -1)),
        "valid": put(full["valid"]),
    }


def stage_dataset(ds: LongitudinalDataset, dtype: torch.dtype,
                  device) -> Dict[str, torch.Tensor]:
    """Upload the whole dataset as padded [P, T_max, ...] device tensors."""
    return _stage(ds, np.arange(ds.P), dtype, device)


def stage_dataset_mesh(ds: LongitudinalDataset, dtype: torch.dtype, device,
                       n_data: int, d: int) -> Dict[str, torch.Tensor]:
    """Data rank ``d``'s block of a dataset sharded over ``n_data`` ranks:
    subjects are dealt in contiguous blocks of P_loc = ceil(P / n_data),
    the last blocks padded with empty subjects (hlax's
    ``stage_dataset_mesh`` holds all blocks as [n_data, P_loc, ...]; a
    rank uploads only its own, [P_loc, T_max, ...]).  ``gather_batch``
    takes the block's local subject indices."""
    P_loc = -(-ds.P // n_data)
    idx = np.arange(d * P_loc, (d + 1) * P_loc)
    return _stage(ds, np.where(idx < ds.P, idx, -1), dtype, device)


def epoch_subject_batches_mesh(P: int, n_data: int, subjects_per_batch: int,
                               rng: Optional[np.random.Generator] = None
                               ) -> np.ndarray:
    """One epoch of LOCAL per-shard subject indices [nb, n_data, S_loc]
    (-1 = padding), drawing from ``rng`` as hlax's
    ``epoch_subject_batches_mesh`` does: each shard shuffles its own real
    subjects of its P_loc = ceil(P / n_data) slots, S_loc =
    ceil(subjects_per_batch / n_data), and every real subject appears once
    an epoch."""
    P_loc = -(-P // n_data)
    S_loc = -(-subjects_per_batch // n_data)
    nb = -(-P_loc // S_loc)
    out = -np.ones((nb, n_data, S_loc), np.int64)
    for d in range(n_data):
        n_real = min(P_loc, max(0, P - d * P_loc))
        order = np.arange(n_real)
        if rng is not None:
            rng.shuffle(order)
        for b in range(nb):
            chunk = order[b * S_loc:(b + 1) * S_loc]
            out[b, d, :len(chunk)] = chunk
    return out


def gather_batch(staged: Dict[str, torch.Tensor],
                 subj_idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """On-device batch gather: subj_idx [S] (-1 = padding subject) ->
    flat-row batch dict matching ``subject_batches`` output."""
    safe = subj_idx.clamp(min=0)
    alive = (subj_idx >= 0).to(staged["valid"].dtype)[:, None]
    S = subj_idx.shape[0]
    T = staged["valid"].shape[1]
    out = {}
    for k in ("data", "mask", "theta_mask", "labels"):
        v = staged[k][safe] * alive[:, :, None]
        out[k] = v.reshape(S * T, -1)
    out["valid"] = staged["valid"][safe] * alive
    return out


def gather_epoch(staged: Dict[str, torch.Tensor],
                 idx_batches: torch.Tensor) -> Dict[str, torch.Tensor]:
    """All of an epoch's batches in one gather (hlax's ``gather_epoch``):
    idx_batches [nb, S] -> the dict ``gather_batch`` builds, with a leading
    nb axis ([nb, S*T, ...], valid [nb, S, T])."""
    nb, S = idx_batches.shape
    T = staged["valid"].shape[1]
    flat = gather_batch(staged, idx_batches.reshape(-1))
    out = {k: v.reshape(nb, S * T, -1) for k, v in flat.items()
           if k != "valid"}
    out["valid"] = flat["valid"].reshape(nb, S, T)
    return out
