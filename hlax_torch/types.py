"""Type-system compiler: heterogeneous column layout as *static* metadata.

Port of ``hlax/types.py`` (numpy only, copied so the port never imports the
JAX package).  The reference (MineOgre/HL-VAE) routes heterogeneous types at
runtime with boolean masks (HL_VAE/read_functions.py:142-198).

Here the types declaration is compiled ONCE at data-load time into a
``TypeLayout``: columns are permuted into *type-major grouped order* on the
host, so that every per-type block on the device is a static slice.
Inverse permutations map results back to the original column order for
reporting parity with the reference.

Column spaces (same semantics as read_functions.py:13-203):
  * raw   — one column per declared variable (mask space), n_raw columns.
  * exp   — expanded data columns: one-hot (cat), thermometer (ordinal),
            identity otherwise.  n_exp columns.
  * theta — decoder parameter columns: cat/ordinal -> nclass per variable;
            real/pos -> dim (+dim if logvar_network); count/beta -> dim.

Within a group the theta block layout matches the reference decoder heads
(HLVAE.py:11-102): cat/ordinal are [var-major, class-minor]; real/pos with
``logvar_network`` store all means first, then all log-variances
(Observation_Real_Pos_Beta cats along the variable axis, HLVAE.py:51).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence, Tuple

import numpy as np

VALID_TYPES = ("real", "pos", "count", "cat", "ordinal", "beta")

# Types whose expanded block has nclass columns per variable.
_MULTICOL = ("cat", "ordinal")


@dataclasses.dataclass(frozen=True)
class TypeGroup:
    """One (type, nclass-or-dim) group in sorted set_of_types order."""

    kind: str                 # one of VALID_TYPES
    nclass: int               # nclass for cat/ordinal/count/real/pos; dim for beta key
    n_vars: int               # number of declared variables in this group
    raw_idx: np.ndarray       # original raw-column indices  [n_vars]
    exp_idx: np.ndarray       # original expanded-column indices [n_exp_g]
    theta_idx: np.ndarray     # original theta-column indices [n_theta_g]
    raw_slice: Tuple[int, int]    # [start, stop) in grouped raw layout
    exp_slice: Tuple[int, int]    # [start, stop) in grouped exp layout
    theta_slice: Tuple[int, int]  # [start, stop) in grouped theta layout

    @property
    def exp_per_var(self) -> int:
        return self.nclass if self.kind in _MULTICOL else 1


@dataclasses.dataclass(frozen=True)
class TypeLayout:
    """Static compiled layout over all type groups.

    ``*_perm`` arrays permute original-order columns into grouped order
    (``grouped = x[:, perm]``); ``*_inv`` undo it.  Both are host-side numpy
    and used only at ingest/report time — on-device code sees grouped order
    and static slices.
    """

    groups: Tuple[TypeGroup, ...]
    types_dict: Tuple[Mapping[str, int], ...]   # normalized declarations
    n_raw: int
    n_exp: int
    n_theta: int
    raw_perm: np.ndarray
    raw_inv: np.ndarray
    exp_perm: np.ndarray
    exp_inv: np.ndarray
    theta_perm: np.ndarray
    theta_inv: np.ndarray
    logvar_network: bool
    beta_ranges: Tuple[Tuple[float, float], ...]  # per beta variable (grouped order)
    # raw-variable group id in ORIGINAL order (reference 'data_types_indexes')
    raw_group_of_var: np.ndarray

    def var_kinds_grouped(self) -> np.ndarray:
        """Kind name per raw variable in grouped order."""
        out = []
        for g in self.groups:
            out.extend([g.kind] * g.n_vars)
        return np.array(out)

    def expand_raw_to_theta(self, m: np.ndarray) -> np.ndarray:
        """Broadcast a grouped raw-space (mask) matrix to grouped theta space.

        Matches the reference param_miss_mask semantics
        (read_functions.py:149-187) including the means-then-logvars layout
        for real/pos under logvar_network.
        """
        blocks = []
        for g in self.groups:
            blk = m[..., g.raw_slice[0]:g.raw_slice[1]]
            n_theta_g = g.theta_slice[1] - g.theta_slice[0]
            per_var = n_theta_g // max(g.n_vars, 1)
            if g.kind in _MULTICOL:
                blk = np.repeat(blk, per_var, axis=-1)
            elif per_var == 2:   # real/pos with logvar_network: [means, logvars]
                blk = np.concatenate([blk, blk], axis=-1)
            blocks.append(blk)
        return np.concatenate(blocks, axis=-1)


def _theta_cols_per_var(kind: str, nclass: int, dim: int, logvar_network: bool) -> int:
    if kind in _MULTICOL:
        return nclass
    if kind in ("real", "pos"):
        return 2 * dim if logvar_network else dim
    # count / beta
    return dim


def compile_layout(
    types_dict: Sequence[Mapping[str, object]],
    logvar_network: bool = False,
    beta_ranges: Sequence[Sequence[float]] = (),
) -> TypeLayout:
    """Compile a types declaration (list of {type, dim, nclass}) to a TypeLayout.

    Group keying and ordering match read_functions.py:145-146: groups are the
    sorted set of (type, str(dim)) for beta and (type, str(nclass)) otherwise.
    """
    norm = []
    for t in types_dict:
        kind = str(t["type"])
        if kind not in VALID_TYPES:
            raise ValueError(f"unknown type {kind!r}")
        norm.append({"type": kind, "dim": int(t["dim"]), "nclass": int(t["nclass"])})

    # group keys, sorted like the reference (string-sorted tuples)
    def key_of(t):
        if t["type"] == "beta":
            return (t["type"], str(t["dim"]))
        return (t["type"], str(t["nclass"]))

    set_of_types = sorted({key_of(t) for t in norm})
    group_id = {k: i for i, k in enumerate(set_of_types)}

    n_groups = len(set_of_types)
    raw_members = [[] for _ in range(n_groups)]   # raw var indices per group
    raw_group_of_var = np.zeros(len(norm), dtype=np.int64)

    # original-order column offsets
    exp_off = 0
    theta_off = 0
    exp_members = [[] for _ in range(n_groups)]
    theta_members = [[] for _ in range(n_groups)]
    # for logvar real/pos the reference lays the *group* block as
    # [all means, all logvars]; track mean/logvar separately then concat.
    theta_mean_members = [[] for _ in range(n_groups)]
    theta_logvar_members = [[] for _ in range(n_groups)]

    for v, t in enumerate(norm):
        gid = group_id[key_of(t)]
        raw_group_of_var[v] = gid
        raw_members[gid].append(v)
        kind, dim, nclass = t["type"], t["dim"], t["nclass"]
        n_exp_v = nclass if kind in _MULTICOL else dim
        exp_members[gid].extend(range(exp_off, exp_off + n_exp_v))
        exp_off += n_exp_v
        n_theta_v = _theta_cols_per_var(kind, nclass, dim, logvar_network)
        cols = list(range(theta_off, theta_off + n_theta_v))
        theta_off += n_theta_v
        if kind in ("real", "pos") and logvar_network:
            theta_mean_members[gid].extend(cols[:dim])
            theta_logvar_members[gid].extend(cols[dim:])
        else:
            theta_members[gid].extend(cols)

    for gid in range(n_groups):
        if theta_mean_members[gid]:
            theta_members[gid] = theta_mean_members[gid] + theta_logvar_members[gid]

    groups = []
    raw_pos = exp_pos = theta_pos = 0
    beta_ranges_grouped = []
    br = [tuple(map(float, r)) for r in beta_ranges]
    for gid, (kind, _key) in enumerate(set_of_types):
        rm = np.array(raw_members[gid], dtype=np.int64)
        em = np.array(exp_members[gid], dtype=np.int64)
        tm = np.array(theta_members[gid], dtype=np.int64)
        nclass = norm[rm[0]]["nclass"]
        g = TypeGroup(
            kind=kind,
            nclass=nclass,
            n_vars=len(rm),
            raw_idx=rm,
            exp_idx=em,
            theta_idx=tm,
            raw_slice=(raw_pos, raw_pos + len(rm)),
            exp_slice=(exp_pos, exp_pos + len(em)),
            theta_slice=(theta_pos, theta_pos + len(tm)),
        )
        groups.append(g)
        raw_pos += len(rm)
        exp_pos += len(em)
        theta_pos += len(tm)
        if kind == "beta":
            beta_ranges_grouped.extend(br[:len(rm)] if br else [(0.0, 1.0)] * len(rm))

    raw_perm = np.concatenate([g.raw_idx for g in groups]) if groups else np.zeros(0, np.int64)
    exp_perm = np.concatenate([g.exp_idx for g in groups]) if groups else np.zeros(0, np.int64)
    theta_perm = np.concatenate([g.theta_idx for g in groups]) if groups else np.zeros(0, np.int64)

    def inv(p):
        out = np.empty_like(p)
        out[p] = np.arange(len(p))
        return out

    return TypeLayout(
        groups=tuple(groups),
        types_dict=tuple(norm),
        n_raw=raw_pos,
        n_exp=exp_pos,
        n_theta=theta_pos,
        raw_perm=raw_perm,
        raw_inv=inv(raw_perm),
        exp_perm=exp_perm,
        exp_inv=inv(exp_perm),
        theta_perm=theta_perm,
        theta_inv=inv(theta_perm),
        logvar_network=bool(logvar_network),
        beta_ranges=tuple(beta_ranges_grouped),
        raw_group_of_var=raw_group_of_var,
    )
