"""Hand-written CUDA kernels for XLA's fusions of the train step.

hlax jits the whole epoch (``hlax/cli/main.py:254``) and XLA fuses the
step's elementwise chains and reductions into a few kernels; the port runs
one kernel an op unless a kernel here takes a chain (``csrc/fusion.cu``,
built by ``ops/cuda_build.py``).  Four fused ops, each with its plain
PyTorch version (the port's op-by-op code, which the CPU runs and the
parity tests hold to hlax), a launch counter, and on the card the kernel:

  * ``heads_loglik``: the decoder's observation heads, the theta routing
    and the likelihoods (``HLVAE.theta_estimation`` + ``HLVAE.loglik``),
    forward and backward (``heads_cat_*``, ``heads_real_*``): XLA's fusion
    of ``hlax/models/hlvae.py:327-415`` and ``hlax/ops/likelihoods.py:47-134``.
  * ``rep_image``: the conv model's batch normalization (a passthrough in
    conv mode), the one-hot representation and the gather into the image,
    forward and backward (``rep_image_*``): XLA's fusion of
    ``hlax/ops/normalization.py:76-135`` and ``hlax/models/hlvae.py:251-290``.
  * ``recon_metric``: the train step's recon and missing-imputation errors
    (``recon_metric``, one launch; on a mesh its column sums, the ranks'
    sums of them, then ``recon_metric_finish``): XLA's fusion of
    ``hlax/train/step.py:210-227`` over ``hlax/eval/metrics.py``.
  * ``gp_kernel_matrix``: the bound's GP kernel matrices with their padding
    masks, forward and backward (``gp_kernel_*``): XLA's fusion of
    ``hlax/gp/kernels.py:117-171`` and ``hlax/gp/elbo.py:96-146``.

The first three take any layout of cat groups (any classes) and at most
one real group, the conv and the MLP model, any y_dim, the logvar network
and a mesh; the GP kernel matrix any spec the kernel builder makes, in as
many launches as its components need.  All float32 and float64.  On a
CUDA tensor of another dtype (bfloat16), or a layout with a group of
another type (pos, count, ordinal, beta), the op takes its plain version,
counted in ``PLAIN_CUDA_CALLS``; a CPU tensor always takes it.  A failed
build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from hlax_torch.ops.counters import Counters
from hlax_torch.ops.cuda_build import check_launch, load_library

KERNEL_DTYPES = (torch.float32, torch.float64)
# the sizes csrc/fusion.cu compiles with every per-class value in registers
# (HLAX_Y, HLAX_C); other sizes take its run-time kernels, whose column
# sums go ANY_NV a block along the grid's z
HEAD_Y, NCLASS, ANY_NV = 5, 5, 8
# must match TILE, WARPS, ROWS and MAX_CHUNKS in csrc/fusion.cu: a block's
# columns and warps, the rows a block of the run-time-size kernels (and of
# rep_image_fwd) takes, the row chunks of a staged kernel (the heads and
# rep_image_bwd at the compiled sizes, recon_metric) at most
TILE, WARPS, ROWS, MAX_CHUNKS = 32, 8, 16, 16
# the row chunks of the real head's backward at most, a tile's chunks being
# one thread-block cluster: the portable cluster size (MAX_CLUSTER in
# csrc/fusion.cu)
MAX_CLUSTER = 8
# blocks an SM the staged kernels' plans aim at, as many as their launch
# bounds give them: the cat head's forward and backward two in float and one
# in double (cat_fwd_blocks: 24 weights a lane in registers; cat_bwd_blocks:
# 24 double sums a thread), the representation's backward four
# (REP_BWD_BLOCKS, within MAX_CHUNKS), the metric two; a second wave
# measured slower than fewer, longer chunks.  The real head's forward four
# in float, three with the logvar network and in double, two in double with
# it (real_fwd_blocks), by (itemsize, logvar network), in as many chunks as
# leave each warp a row (a map, its rows latency-bound), and its backward one
# block of REAL_BWD_WARPS warps (real_bwd_warps).  The wrapper reads the
# card's SM count
CAT_FWD_PER_SM = {4: 2, 8: 1}
CAT_BWD_PER_SM = {4: 2, 8: 1}
REAL_FWD_PER_SM = {(4, False): 4, (4, True): 3, (8, False): 3, (8, True): 2}
REAL_BWD_PER_SM = 1
REAL_BWD_WARPS = {(4, False): 16, (4, True): 16, (8, False): 16,
                  (8, True): 8}
REP_BWD_PER_SM = 4
METRIC_PER_SM = 2
# the GP kernel matrix's limits a launch: components, factors a component,
# raw parameters, distinct rbf dims (MAX_COMP, MAX_FACT, MAX_PARAM,
# MAX_SLOT in csrc/fusion.cu); its kernels' threads a block (GP_THREADS; the
# column kernel GP_TX x GP_TY), columns a flat tile at most (GP_COLS),
# dynamic shared bytes at most (GP_SMEM)
GP_MAX = {"components": 4, "factors": 4, "params": 8, "slots": 4}
GP_MAX_DIM = GP_MAX["components"] * GP_MAX["factors"]
GP_THREADS, GP_TX, GP_TY = 256, 32, 8
GP_COLS, GP_SMEM = 1024, 20 * 1024
GP_KINDS = {"cat": 0, "bin": 1, "rbf": 2, "catmod": 3}
# the plans aim at two blocks an SM of the H100's (the wrapper reads the
# card's own count): more, smaller blocks measured slower, each paying its
# staging again
GP_SMS = 132
# the metric's kinds of group (M_CAT, M_REAL_CONV, M_REAL in fusion.cu),
# its column sums (METRIC_NV) and the groups a launch takes
METRIC_KIND = {"cat": 0, "real_conv": 1, "real": 2}
METRIC_NV, METRIC_GROUPS = 5, 32

_COUNTERS = Counters(("heads_cat_fwd_cuda", "heads_cat_bwd_cuda",
                      "heads_real_fwd_cuda", "heads_real_bwd_cuda",
                      "rep_image_fwd_cuda", "rep_image_bwd_cuda",
                      "recon_metric_cuda", "recon_metric_finish_cuda",
                      "gp_kernel_fwd_cuda", "gp_kernel_bwd_cuda"),
                     ("heads_loglik_plain", "rep_image_plain",
                      "recon_metric_plain", "gp_kernel_plain"))
LAUNCHES = _COUNTERS.launches
LAUNCHES_BY_SHAPE = _COUNTERS.by_shape
PLAIN_CUDA_CALLS = _COUNTERS.plain
reset_counters = _COUNTERS.reset


class Group(NamedTuple):
    """A group's place: its index in the layout, variables, first column
    in the raw, expanded and theta arrays, and classes (0: real)."""
    gi: int
    d: int
    r0: int
    e0: int
    t0: int
    nclass: int


class Geometry(NamedTuple):
    n_raw: int
    n_exp: int
    n_theta: int
    cats: Tuple[Group, ...]
    real: Optional[Group]


def geometry(layout) -> Optional[Geometry]:
    """The kernels' view of ``layout``: its cat groups and its real group,
    or None where a group is of another type (or a second real group,
    which the model's one log_vy and one set of moments do not take)."""
    cats, real = [], None
    for gi, g in enumerate(layout.groups):
        if g.kind not in ("cat", "real") or (g.kind == "real" and real):
            return None
        grp = Group(gi, g.n_vars, g.raw_slice[0], g.exp_slice[0],
                    g.theta_slice[0], g.nclass if g.kind == "cat" else 0)
        if g.kind == "cat":
            cats.append(grp)
        else:
            real = grp
    return Geometry(layout.n_raw, layout.n_exp, layout.n_theta, tuple(cats),
                    real)


def _uses_kernel(takes: bool, t: torch.Tensor, plain_name: str,
                 *others, plain: Dict[str, int] = PLAIN_CUDA_CALLS) -> bool:
    """Whether the kernel takes tensor ``t`` and the tensors ``others``
    (None skipped): on CUDA, in a kernel dtype, all of one dtype and
    device, where it ``takes`` the layout; a CUDA call that does not is
    counted in ``plain`` (a kernel module's plain-version counts)."""
    if not t.is_cuda:
        return False
    if takes and t.dtype in KERNEL_DTYPES and all(
            o.dtype == t.dtype and o.device == t.device
            for o in others if o is not None):
        return True
    plain[plain_name] += 1
    return False


def _check_shapes(what: str, **shapes) -> None:
    """Raise unless each named tensor has its expected shape (before any
    pointer reaches a kernel)."""
    for name, (t, want) in shapes.items():
        if t is not None and tuple(t.shape) != tuple(want):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(want)}")


class _LongLong(int):
    """An argument the C entry takes as ``long long`` (a stride)."""


def launch(library: str, counters: Counters, entry: str,
           like: torch.Tensor, *args) -> None:
    """Call C entry ``entry`` of ``lib<library>.so``: tensors (or None) and
    host int arrays as pointers, floats as ``double``, ints as ``int``
    (``_LongLong`` as ``long long``), then the current stream; count the
    launch in ``counters`` under ``like``'s shape and dtype."""
    lib = load_library(library)
    fn = getattr(lib, entry)
    types, vals = [], []
    for a in args:
        if a is None or torch.is_tensor(a):
            types.append(ctypes.c_void_p)
            vals.append(None if a is None else a.data_ptr())
        elif isinstance(a, ctypes.Array):    # a host array of ints
            types.append(ctypes.c_void_p)
            vals.append(ctypes.cast(a, ctypes.c_void_p))
        elif isinstance(a, float):
            types.append(ctypes.c_double)
            vals.append(a)
        elif isinstance(a, _LongLong):
            types.append(ctypes.c_longlong)
            vals.append(int(a))
        else:
            types.append(ctypes.c_int)
            vals.append(int(a))
    fn.argtypes = types + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(*vals, torch.cuda.current_stream(like.device).cuda_stream)
    check_launch(lib, entry, code)
    counters.count(f"{entry}_cuda", like)


def _launch(entry: str, like: torch.Tensor, *args) -> None:
    """``launch`` of a C entry of libfusion.so."""
    launch("fusion", _COUNTERS, entry, like, *args)


def _scratch(*tensors):
    for t in tensors:
        t._scratch = True   # not data: for byte counts
    return tensors


class ReductionPlan(NamedTuple):
    """A staged kernel's grid and scratch: ``tiles`` column tiles of TILE
    columns by ``chunks`` row chunks of ``rows`` rows (the last one may be
    shorter), warp w of a block taking rows w, w + WARPS, ... of its chunk;
    a column reduction's ``part`` doubles of the chunks' partials in
    global memory (none for one chunk, for a map, or for a reduction whose
    chunks meet in a cluster), ``counters`` ints of the stream's counter
    buffer, ``smem`` shared bytes a block; for the metric, each group's
    first tile (``tile0``) and the entries the wrapper launches; for the
    real head's backward, the blocks a thread-block cluster (``cluster``: a
    tile's chunks; 0 for a launch without clusters); ``warps`` a block, warp
    w taking rows w, w + warps, ... of its chunk."""
    tiles: int
    chunks: int
    rows: int
    part: int
    counters: int
    smem: int
    tile0: Tuple[int, ...] = ()
    launches: Tuple[str, ...] = ()
    cluster: int = 0
    warps: int = WARPS


def row_chunks(B: int, tiles: int, per_sm: int, sms: int,
               most: int = MAX_CHUNKS) -> Tuple[int, int]:
    """(chunks, rows a chunk) of ``B`` rows for a grid of ``tiles`` column
    tiles: as many chunks as ``per_sm`` blocks an SM of ``sms`` take in one
    wave, at most ``most`` and no more than leave each warp a row, then
    the rows spread evenly over them."""
    n = max(1, min(per_sm * sms // tiles, most, -(-B // WARPS)))
    rows = -(-B // n)
    return -(-B // rows), rows


# stages a warp of the staged kernels' row pipelines (NST in CatFwdSmem,
# CatBwdSmem, RealFwdSmem, RealBwdSmem, RepBwdSmem and MetricSmem,
# csrc/fusion.cu)
CAT_FWD_STAGES, CAT_BWD_STAGES, REP_BWD_STAGES, METRIC_STAGES = 3, 3, 3, 4
REAL_FWD_STAGES, REAL_BWD_STAGES = 3, 4


def _cat_fwd_smem(itemsize: int, Y: int, C: int) -> int:
    """heads_cat_fwd_kernel's shared bytes (CatFwdSmem, csrc/fusion.cu):
    each warp's CAT_FWD_STAGES stages of a row's runs of y, the data and
    the mask, each with a 16-byte shift, then each warp's one buffer of a
    row's theta and log_pi runs, each with a 16-byte shift."""
    v = 16 // itemsize
    stage = (TILE * Y + v) + (TILE * C + v) + (TILE + v)
    return WARPS * (CAT_FWD_STAGES * stage + 2 * (TILE * C + v)) * itemsize


def _real_fwd_smem(itemsize: int, Y: int) -> int:
    """heads_real_fwd_kernel's shared bytes (RealFwdSmem, csrc/fusion.cu):
    each warp's REAL_FWD_STAGES stages of a row's runs of y, the data and
    the mask, each with a 16-byte shift."""
    v = 16 // itemsize
    return WARPS * REAL_FWD_STAGES * ((TILE * Y + v) + 2 * (TILE + v)) \
        * itemsize


def _real_bwd_smem(itemsize: int, Y: int, logvar: bool) -> int:
    """heads_real_bwd_kernel's shared bytes (RealBwdSmem, csrc/fusion.cu):
    each of its REAL_BWD_WARPS warps' REAL_BWD_STAGES stages of a row's runs
    of y, the data, the mask and the theta mask (two runs with the logvar
    network), each with a 16-byte shift, and its lanes' two cotangents; or
    after the rows the warps' NV double sums a column (one spare a
    column), NV = 2 Y + 2 with the logvar network, else Y + 2; then, apart,
    rank 0's slots for every rank's partials, MAX_CLUSTER x TILE x NV
    doubles."""
    v, nv = 16 // itemsize, (2 * Y + 2 if logvar else Y + 2)
    w = REAL_BWD_WARPS[itemsize, logvar]
    stage = (TILE * Y + v) + (4 if logvar else 3) * (TILE + v) + 2 * TILE
    return (max(w * REAL_BWD_STAGES * stage * itemsize,
                w * TILE * (nv + 1) * 8)
            + MAX_CLUSTER * TILE * nv * 8)


def _rep_bwd_smem(itemsize: int, C: int) -> int:
    """rep_image_bwd_kernel's shared bytes (RepBwdSmem, csrc/fusion.cu):
    each warp's REP_BWD_STAGES stages of a row's runs of the data and the
    mask, each with a 16-byte shift, and its lanes' image gradients; or
    after the rows the warps' C + 1 double sums a column (one spare a
    column)."""
    v = 16 // itemsize
    stage = (TILE * C + v) + (TILE + v) + TILE
    return max(WARPS * REP_BWD_STAGES * stage * itemsize,
               WARPS * TILE * (C + 2) * 8)


def _cat_bwd_smem(itemsize: int, Y: int, C: int) -> int:
    """heads_cat_bwd_kernel's shared bytes (CatBwdSmem, csrc/fusion.cu):
    each warp's CAT_BWD_STAGES stages of a row's runs of y, the data, the
    theta mask and the mask, each with a 16-byte shift, and its lanes' two
    cotangents, then the tile's weights and biases; or after the rows the
    warps' (Y + 1)(C - 1) double sums a column (one spare a column)."""
    v, nv = 16 // itemsize, (Y + 1) * (C - 1)
    stage = (TILE * Y + v) + 2 * (TILE * C + v) + (TILE + v) + 2 * TILE
    return max(WARPS * CAT_BWD_STAGES * stage * itemsize
               + nv * TILE * itemsize, WARPS * TILE * (nv + 1) * 8)


def _metric_smem(itemsize: int, C: int = NCLASS) -> int:
    """recon_metric_kernel's shared bytes (MetricSmem, dynamic, and its
    static tile totals): each warp's METRIC_STAGES stages of a row's runs
    of the data, log_pi or the means and the mask and its valid weight, or
    the warps' METRIC_NV sums a column and valid rows."""
    v = 16 // itemsize
    stage = 2 * (TILE * C + v) + TILE + v + v
    return (max(WARPS * METRIC_STAGES * stage * itemsize,
                WARPS * TILE * (METRIC_NV + 1) * 8)
            + TILE * (METRIC_NV + 1) * 8)


def heads_cat_fwd_plan(B: int, d: int, Y: int, C: int, itemsize: int,
                       sms: int) -> ReductionPlan:
    """The cat head's forward over ``B`` rows of a group of ``d``
    variables: at the compiled sizes (Y = HEAD_Y, C = NCLASS) the staged
    map's chunks (CAT_FWD_PER_SM blocks an SM), no scratch; else the
    run-time kernel's ROWS-row chunks."""
    tiles = -(-d // TILE)
    if (Y, C) != (HEAD_Y, NCLASS):
        return ReductionPlan(tiles, -(-B // ROWS), ROWS, 0, 0, 0)
    chunks, rows = row_chunks(B, tiles, CAT_FWD_PER_SM[itemsize], sms)
    return ReductionPlan(tiles, chunks, rows, 0, 0,
                         _cat_fwd_smem(itemsize, Y, C))


def heads_cat_bwd_plan(B: int, d: int, Y: int, C: int, itemsize: int,
                       sms: int) -> ReductionPlan:
    """The cat head's backward over ``B`` rows of a group of ``d``
    variables: at the compiled sizes (Y = HEAD_Y, C = NCLASS) the staged
    kernel's chunks (CAT_BWD_PER_SM blocks an SM), the (Y + 1)(C - 1) sums a
    variable's partials over several chunks and a counter a tile; else the
    run-time kernel's ROWS-row chunks and ANY_NV sums a z-slice."""
    tiles, nv = -(-d // TILE), (Y + 1) * (C - 1)
    if (Y, C) != (HEAD_Y, NCLASS):
        z = -(-nv // ANY_NV)
        chunks = -(-B // ROWS)
        return ReductionPlan(tiles, chunks, ROWS,
                             z * chunks * tiles * TILE * ANY_NV, z * tiles, 0)
    chunks, rows = row_chunks(B, tiles, CAT_BWD_PER_SM[itemsize], sms)
    many = chunks > 1
    return ReductionPlan(tiles, chunks, rows, chunks * d * nv if many else 0,
                         tiles if many else 0, _cat_bwd_smem(itemsize, Y, C))


def heads_real_fwd_plan(B: int, d: int, Y: int, logvar: bool, itemsize: int,
                        sms: int) -> ReductionPlan:
    """The real head's forward over ``B`` rows of a group of ``d``
    variables (with the logvar network, ``logvar``): at the compiled Y
    (HEAD_Y) the staged map's chunks (REAL_FWD_PER_SM blocks an SM, as many
    chunks as leave each warp a row: a map has no partials to bound them),
    no scratch; else the run-time kernel's ROWS-row chunks."""
    tiles = -(-d // TILE)
    if Y != HEAD_Y:
        return ReductionPlan(tiles, -(-B // ROWS), ROWS, 0, 0, 0)
    chunks, rows = row_chunks(B, tiles, REAL_FWD_PER_SM[itemsize, logvar],
                              sms, B)
    return ReductionPlan(tiles, chunks, rows, 0, 0,
                         _real_fwd_smem(itemsize, Y))


def heads_real_bwd_plan(B: int, d: int, Y: int, logvar: bool, itemsize: int,
                        sms: int) -> ReductionPlan:
    """The real head's backward over ``B`` rows of a group of ``d``
    variables (NV sums a variable: Y + 2, or 2 Y + 2 with the logvar
    network): at the compiled Y (HEAD_Y) the staged kernel's chunks (one
    block of REAL_BWD_WARPS warps an SM, at most MAX_CLUSTER chunks), a
    tile's chunks one cluster that adds their partials in its blocks'
    shared memory: no scratch, no counter; else the run-time kernel's
    ROWS-row chunks, ANY_NV sums a z-slice, their partials and a counter a
    tile and slice."""
    tiles, nv = -(-d // TILE), (2 * Y + 2 if logvar else Y + 2)
    if Y != HEAD_Y:
        z = -(-nv // ANY_NV)
        chunks = -(-B // ROWS)
        return ReductionPlan(tiles, chunks, ROWS,
                             z * chunks * tiles * TILE * ANY_NV, z * tiles, 0)
    chunks, rows = row_chunks(B, tiles, REAL_BWD_PER_SM, sms, MAX_CLUSTER)
    return ReductionPlan(tiles, chunks, rows, 0, 0,
                         _real_bwd_smem(itemsize, Y, logvar), cluster=chunks,
                         warps=REAL_BWD_WARPS[itemsize, logvar])


def rep_image_bwd_plan(B: int, d: int, C: int, itemsize: int,
                       sms: int) -> ReductionPlan:
    """The representation's backward over ``B`` rows of a cat group of
    ``d`` variables of ``C`` classes: at the compiled C (NCLASS) the staged
    kernel's chunks (REP_BWD_PER_SM blocks an SM, at most MAX_CHUNKS), the
    C + 1 sums a variable's partials over several chunks and a counter a
    tile; else the run-time kernel's ROWS-row chunks and ANY_NV sums a
    z-slice."""
    tiles, nv = -(-d // TILE), C + 1
    if C != NCLASS:
        z = -(-nv // ANY_NV)
        chunks = -(-B // ROWS)
        return ReductionPlan(tiles, chunks, ROWS,
                             z * chunks * tiles * TILE * ANY_NV, z * tiles, 0)
    chunks, rows = row_chunks(B, tiles, REP_BWD_PER_SM, sms)
    many = chunks > 1
    return ReductionPlan(tiles, chunks, rows, chunks * d * nv if many else 0,
                         tiles if many else 0, _rep_bwd_smem(itemsize, C))


def metric_plan(B: int, n_raw: int, ds, itemsize: int, sms: int,
                mesh: bool) -> ReductionPlan:
    """The recon metric over ``B`` rows of groups of ``ds`` variables (in
    the table's order) in ``n_raw`` raw columns: one grid over every
    group's tiles (METRIC_PER_SM blocks an SM); over several chunks the
    partials of each raw column's sums and each tile's valid rows, a
    chunk each; on one process each tile's pair of finish terms after
    them; a counter a tile and one over the tiles.  On one process one
    launch, the finish in it; on a mesh the column sums, which its ranks
    sum, then the finish."""
    tile0, tiles = [], 0
    for d in ds:
        tile0.append(tiles)
        tiles += -(-d // TILE)
    chunks, rows = row_chunks(B, tiles, METRIC_PER_SM, sms)
    part = chunks * (n_raw * METRIC_NV + tiles) if chunks > 1 else 0
    return ReductionPlan(
        tiles, chunks, rows, part + (0 if mesh else 2 * tiles), tiles + 1,
        _metric_smem(itemsize), tuple(tile0),
        ("recon_metric", "recon_metric_finish") if mesh else
        ("recon_metric",))


def _cols(g: Group, geo: Geometry):
    return (g.d, g.r0, g.e0, g.t0, geo.n_raw, geo.n_exp, geo.n_theta)


def _strides(g: Optional[torch.Tensor]):
    return ((_LongLong(0), _LongLong(0)) if g is None else
            (_LongLong(g.stride(0)), _LongLong(g.stride(1))))


# ---------------------------------------------------------------- heads


def heads_loglik_plain(model, y, theta_mask, data, mask, norm_params):
    """The plain version: the model's heads, routing and likelihoods op by
    op.  Returns (log_p_x, log_p_x_missing, params, theta)."""
    theta = model.theta_estimation(y, theta_mask)
    lp, lpm, params = model.loglik(theta, data, mask, norm_params)
    return lp, lpm, params, theta


class _HeadsCfg(NamedTuple):
    geo: Geometry
    Y: int
    conv: bool
    logvar: bool


def _head_params(model, geo: Geometry):
    """The heads' parameters in ``_Heads``'s order: each cat group's W, b,
    then the real group's w, b and either its logvar head's w', b' or the
    shared log_vy (detached when fixed)."""
    obs, out = model.obs, []
    for g in geo.cats:
        out += [obs[f"w_{g.gi}"], obs[f"b_{g.gi}"]]
    if geo.real is not None:
        gi = geo.real.gi
        out += [obs[f"w_{gi}"], obs[f"b_{gi}"]]
        if model.cfg.logvar_network:
            out += [obs[f"wv_{gi}"], obs[f"bv_{gi}"]]
        else:
            lv = model.log_vy_real
            out.append(lv.detach() if model.cfg.vy_fixed else lv)
    return out


class _Heads(torch.autograd.Function):
    """lp and lpm differentiable in y and the heads' parameters; theta and
    the likelihoods' parameters (outputs 3 on) are returned without a
    gradient, as every caller reads them (the metrics, the images) under
    ``no_grad`` or detached."""

    @staticmethod
    def forward(ctx, y, data, mask, tmask, nmean, nvar, hc, *params):
        geo, Y = hc.geo, hc.Y
        B = y.shape[0]
        dt, dev = y.dtype, y.device
        lp = torch.empty((B, geo.n_raw), dtype=dt, device=dev)
        lpm = torch.empty_like(lp)
        theta = torch.empty((B, geo.n_theta), dtype=dt, device=dev)
        logpis = []
        for k, g in enumerate(geo.cats):
            w, b = params[2 * k:2 * k + 2]
            logpis.append(torch.empty((B, g.d, g.nclass), dtype=dt,
                                      device=dev))
            plan = heads_cat_fwd_plan(B, g.d, Y, g.nclass, y.element_size(),
                                      _sm_count(dev.index))
            _launch("heads_cat_fwd", y, y.element_size(), y, w, b, data,
                    mask, lp, lpm, logpis[-1], theta, B, *_cols(g, geo), Y,
                    g.nclass, plan.rows)
        mean = var = None
        if geo.real is not None:
            w, b, *rest = params[2 * len(geo.cats):]
            wv, bv, logvy = (*rest, None) if hc.logvar else (None, None,
                                                            rest[0])
            g = geo.real
            mean = torch.empty((B, g.d), dtype=dt, device=dev)
            var = torch.empty((B, g.d) if hc.logvar else (g.d,), dtype=dt,
                              device=dev)
            plan = heads_real_fwd_plan(B, g.d, Y, hc.logvar,
                                       y.element_size(),
                                       _sm_count(dev.index))
            _launch("heads_real_fwd", y, y.element_size(), y, w, b, wv, bv,
                    logvy, nmean, nvar, data, mask, lp, lpm, mean, var,
                    theta, B, *_cols(g, geo), Y, int(hc.logvar),
                    int(hc.conv), plan.rows)
        ctx.hc = hc
        ctx.save_for_backward(y, data, mask, tmask, nmean, nvar, *params)
        ctx.set_materialize_grads(False)
        outs = [t for t in (theta, *logpis, mean, var) if t is not None]
        ctx.mark_non_differentiable(*outs)
        return (lp, lpm, theta, *logpis, mean, var)

    @staticmethod
    def backward(ctx, g_lp, g_lpm, *_):
        y, data, mask, tmask, nmean, nvar, *params = ctx.saved_tensors
        hc = ctx.hc
        geo, Y = hc.geo, hc.Y
        none = (None,) * 7
        if g_lp is None and g_lpm is None:
            return none + (None,) * len(params)
        B = y.shape[0]
        dy = torch.empty_like(y)
        dparams = [torch.empty_like(p) for p in params]
        strides = (*_strides(g_lp), *_strides(g_lpm))
        sms = _sm_count(y.device.index)
        for k, g in enumerate(geo.cats):
            w, b = params[2 * k:2 * k + 2]
            dw, db = dparams[2 * k:2 * k + 2]
            plan = heads_cat_bwd_plan(B, g.d, Y, g.nclass, y.element_size(),
                                      sms)
            part = _scratch(torch.empty(plan.part, dtype=torch.float64,
                                        device=y.device))[0]
            _launch("heads_cat_bwd", y, y.element_size(), y, w, b, data,
                    mask, tmask, g_lp, g_lpm, *strides, dy, dw, db, part,
                    _counters(y, plan.counters), B, *_cols(g, geo), Y,
                    g.nclass, plan.rows)
        if geo.real is not None:
            n0 = 2 * len(geo.cats)
            w, b, *rest = params[n0:]
            dw, db, *drest = dparams[n0:]
            if hc.logvar:
                (wv, bv), (dwv, dbv), logvy, dlv = rest, drest, None, None
            else:
                wv = bv = dwv = dbv = None
                logvy, dlv = rest[0], drest[0]
            g = geo.real
            plan = heads_real_bwd_plan(B, g.d, Y, hc.logvar,
                                       y.element_size(), sms)
            # the compiled Y's chunks meet in their cluster: no scratch
            part = _scratch(torch.empty(plan.part, dtype=torch.float64,
                                        device=y.device))[0] \
                if plan.part else None
            cnt = _counters(y, plan.counters) if plan.counters else None
            _launch("heads_real_bwd", y, y.element_size(), y, w, b, wv, bv,
                    logvy, nmean, nvar, data, mask, tmask, g_lp, g_lpm,
                    *strides, dy, dw, db, dwv, dbv, dlv, part, cnt, B,
                    *_cols(g, geo), Y, int(hc.logvar), int(hc.conv),
                    plan.rows)
        return (dy,) + (None,) * 6 + tuple(dparams)


def heads_loglik(model, y, theta_mask, data, mask, norm_params):
    """``HLVAE``'s heads, routing and likelihoods of the decoder features
    y [B, n_raw, y_dim] (grouped order): (log_p_x [B, n_raw],
    log_p_x_missing [B, n_raw], params (one a group, as ``HLVAE.loglik``),
    theta [B, n_theta]).  The kernels on CUDA where they take the layout
    and dtype, else the plain version."""
    cfg = model.cfg
    geo = geometry(cfg.layout)
    params = _head_params(model, geo) if geo is not None else []
    nmean, nvar = norm_params.real_mean, norm_params.real_var
    if not _uses_kernel(geo is not None, y, "heads_loglik_plain",
                        theta_mask, data, mask, nmean, nvar, *params):
        return heads_loglik_plain(model, y, theta_mask, data, mask,
                                  norm_params)
    B, Y = y.shape[0], cfg.y_dim
    d_real = geo.real.d if geo.real is not None else 0
    _check_shapes("heads_loglik", y=(y, (B, geo.n_raw, Y)),
                  theta_mask=(theta_mask, (B, geo.n_theta)),
                  data=(data, (B, geo.n_exp)), mask=(mask, (B, geo.n_raw)),
                  real_mean=(nmean, (d_real,)), real_var=(nvar, (d_real,)))
    if (nmean is None) != (nvar is None):
        raise ValueError("heads_loglik: the real group's batch mean and "
                         "variance come together")
    cont = lambda t: t.contiguous() if t is not None else None
    hc = _HeadsCfg(geo, Y, bool(cfg.conv), bool(cfg.logvar_network))
    outs = _Heads.apply(y.contiguous(), data.contiguous(), mask.contiguous(),
                        theta_mask.contiguous(), cont(nmean), cont(nvar), hc,
                        *params)
    lp, lpm, theta = outs[:3]
    logpis, (mean, var) = outs[3:3 + len(geo.cats)], outs[-2:]
    out = [None] * len(cfg.layout.groups)
    for g, lpi in zip(geo.cats, logpis):
        out[g.gi] = lpi
    if geo.real is not None:
        out[geo.real.gi] = (mean, var.expand_as(mean))
    return lp, lpm, out, theta


# ------------------------------------------------------- representation


def rep_image_plain(model, data, mask, norm_data=None):
    """The plain version: the batch normalization (unless ``norm_data`` is
    given), each variable scalarized to one channel (the one-hot
    representation of cat and ordinal groups), masked, and gathered into
    pixel order: [B, 1, side, side]."""
    from hlax_torch.models.hlvae import permute_columns
    from hlax_torch.ops.normalization import batch_normalization

    lay = model.cfg.layout
    if norm_data is None:
        norm_data, _ = batch_normalization(data, mask, lay, True)
    blocks = []
    for gi, g in enumerate(lay.groups):
        x_g = norm_data[:, g.exp_slice[0]:g.exp_slice[1]]
        m_g = mask[:, g.raw_slice[0]:g.raw_slice[1]]
        if g.kind in ("cat", "ordinal"):
            x3 = x_g.reshape(x_g.shape[0], g.n_vars, g.nclass)
            rep = torch.einsum("bdc,dc->bd", x3, model.rep_w[str(gi)])
            rep = rep + model.rep_b[str(gi)]
        else:
            rep = x_g
        blocks.append(rep * m_g)
    one_to_one = torch.cat(blocks, dim=1)            # [B, n_raw] grouped
    s = model.cfg.image_side
    img = permute_columns(one_to_one, model.raw_inv, model.raw_perm)
    return img.reshape(-1, 1, s, s)


def _rep_params(model, geo: Geometry):
    out = []
    for g in geo.cats:
        out += [model.rep_w[str(g.gi)], model.rep_b[str(g.gi)]]
    return out


class _RepImage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, mask, perm, geo, *params):
        B = data.shape[0]
        img = torch.empty((B, geo.n_raw), dtype=data.dtype,
                          device=data.device)
        groups = [(g, params[2 * k:2 * k + 2]) for k, g in
                  enumerate(geo.cats)]
        if geo.real is not None:
            groups.append((geo.real, (None, None)))
        for g, (w, b) in groups:
            _launch("rep_image_fwd", data, data.element_size(), data, mask,
                    w, b, perm, img, B, g.d, g.r0, g.e0, geo.n_raw,
                    geo.n_exp, g.nclass)
        ctx.geo = geo
        ctx.save_for_backward(data, mask, perm)
        return img

    @staticmethod
    def backward(ctx, g_img):
        geo = ctx.geo
        data, mask, perm = ctx.saved_tensors
        B, dev = data.shape[0], data.device
        g_img = g_img.contiguous()
        grads = []
        for k, g in enumerate(geo.cats):
            if not any(ctx.needs_input_grad[4 + 2 * k:6 + 2 * k]):
                grads += [None, None]
                continue
            dw = torch.empty((g.d, g.nclass), dtype=data.dtype, device=dev)
            db = torch.empty((g.d,), dtype=data.dtype, device=dev)
            plan = rep_image_bwd_plan(B, g.d, g.nclass, data.element_size(),
                                      _sm_count(dev.index))
            part = _scratch(torch.empty(plan.part, dtype=torch.float64,
                                        device=dev))[0]
            _launch("rep_image_bwd", data, data.element_size(), data, mask,
                    perm, g_img, dw, db, part,
                    _counters(data, plan.counters), B, g.d, g.r0, g.e0,
                    geo.n_raw, geo.n_exp, g.nclass, plan.rows)
            grads += [dw, db]
        return (None,) * 4 + tuple(grads)


def rep_image(model, data, mask, norm_data=None):
    """The conv encoder's input image [B, 1, side, side] of the grouped
    rows ``data`` [B, n_exp], ``mask`` [B, n_raw]: normalized (conv mode),
    scalarized, masked, in pixel order.  The kernel on CUDA where it takes
    the layout and dtype (it normalizes itself and ignores ``norm_data``),
    else the plain version (which normalizes when ``norm_data`` is
    None)."""
    geo = geometry(model.cfg.layout)
    params = _rep_params(model, geo) if geo is not None else []
    if not _uses_kernel(geo is not None, data, "rep_image_plain", mask,
                        *params):
        return rep_image_plain(model, data, mask, norm_data)
    _check_shapes("rep_image", data=(data, (data.shape[0], geo.n_exp)),
                  mask=(mask, (data.shape[0], geo.n_raw)))
    s = model.cfg.image_side
    img = _RepImage.apply(data.contiguous(), mask.contiguous(),
                          model.raw_perm, geo, *params)
    return img.reshape(-1, 1, s, s)


# ---------------------------------------------------------- recon metric


def recon_metric_plain(layout, conv, params, data, mask, row_valid,
                       last_kind, sums=None):
    """The plain version: ``statistics``, ``discrete_transform`` and
    ``error_computation`` over the valid rows, then the recon error of the
    type ``last_kind`` times the valid rows and the summed
    missing-imputation error (0-dim tensors)."""
    from hlax_torch.eval import metrics as mx

    mean_rec, _ = mx.statistics(params, layout, conv)
    truth = mx.discrete_transform(data, layout)
    true_mask = row_valid[:, None] * torch.ones_like(mask)
    _, err_missing, partial = mx.error_computation(
        truth, mean_rec, layout, mask * row_valid[:, None], conv=conv,
        true_mask=true_mask, sums=sums)
    n_rows = row_valid.sum()
    if sums is not None:
        n_rows = sums.subjects(n_rows)
    return partial[last_kind]["error_all"].sum() * n_rows, err_missing.sum()


def recon_metric(layout, conv, params, data, mask, row_valid, last_kind,
                 sums=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train step's recon and missing-imputation errors of the
    likelihoods' ``params`` (``HLVAE.loglik``'s) against the rows ``data``,
    ``mask`` whose ``row_valid`` [B] is 1; on a mesh (``sums``) the global
    batch's.  The kernel on CUDA where it takes the layout and dtype (one
    launch on one process; on a mesh the column sums, the ranks' sums of
    them, then the finish), else the plain version."""
    geo = geometry(layout)
    groups = []
    if geo is not None:
        real = (geo.real, params[geo.real.gi][0]) if geo.real else None
        groups = [(g, params[g.gi]) for g in geo.cats] + ([real] if real
                                                          else [])
    if not _uses_kernel(geo is not None, data, "recon_metric_plain", mask,
                        row_valid, *(p for _, p in groups)):
        return recon_metric_plain(layout, conv, params, data, mask,
                                  row_valid, last_kind, sums)
    if len(groups) > METRIC_GROUPS:
        raise ValueError(f"recon_metric: {len(groups)} groups, the kernel "
                         f"takes {METRIC_GROUPS}")
    B = data.shape[0]
    _check_shapes("recon_metric", data=(data, (B, geo.n_exp)),
                  mask=(mask, (B, geo.n_raw)), row_valid=(row_valid, (B,)),
                  **{f"params_{g.gi}": (p, (B, g.d, g.nclass) if g.nclass
                                        else (B, g.d)) for g, p in groups})
    data, mask = data.contiguous(), mask.contiguous()
    row_valid = row_valid.contiguous()
    dev, z = data.device, data.element_size()
    plan = metric_plan(B, geo.n_raw, [g.d for g, _ in groups], z,
                       _sm_count(dev.index), sums is not None)
    finish_apart = "recon_metric_finish" in plan.launches
    srcs, table = [], []
    for (g, p), t0 in zip(groups, plan.tile0):
        srcs.append(p.contiguous())
        kind = (METRIC_KIND["cat"] if g.nclass else
                METRIC_KIND["real_conv" if conv else "real"])
        take = int(("cat" if g.nclass else "real") == last_kind)
        table += [g.r0, g.e0, g.d, kind, g.nclass, take, t0]
    table = (ctypes.c_int * len(table))(*table)
    # a mesh's column sums [METRIC_NV, n_raw], every group's columns
    # written
    cs = (torch.empty((METRIC_NV, geo.n_raw), dtype=torch.float64,
                      device=dev) if finish_apart else None)
    out = torch.empty(2, dtype=data.dtype, device=dev)
    _launch("recon_metric", data, z, table,
            (ctypes.c_void_p * len(srcs))(*(p.data_ptr() for p in srcs)),
            len(groups), data, mask, row_valid,
            _scratch(torch.empty(plan.part, dtype=torch.float64,
                                 device=dev))[0],
            _counters(data, plan.counters), cs, None if finish_apart else out,
            B, geo.n_raw, geo.n_exp, plan.rows)
    if finish_apart:
        # the ranks' column sums and extremes, then the global valid rows
        cs = torch.cat([sums.subjects(cs[:3]), sums.subjects_max(cs[3:])])
        n_rows = sums.subjects(row_valid.sum(dtype=torch.float64))
        _launch("recon_metric_finish", data, z, table, len(groups), cs,
                row_valid, n_rows.reshape(1), out, B, geo.n_raw)
    return out[0], out[1]


# ------------------------------------------------------ GP kernel matrix


def gp_kernel_matrix_plain(spec, params, x1, x2, x1_batched=False,
                           x2_batched=False, row_mask=None, col_mask=None):
    """The plain version: ``kernel_matrix`` times the padding masks as the
    bounds apply them (``row_mask`` [S, N1] over the rows, ``col_mask``
    [S, N2] over the columns, both as their outer product)."""
    from hlax_torch.gp.kernels import kernel_matrix

    k = kernel_matrix(spec, params, x1, x2, x1_batched=x1_batched,
                      x2_batched=x2_batched)
    if row_mask is not None and col_mask is not None:
        return k * (row_mask[:, :, None] * col_mask[:, None, :])[None]
    if row_mask is not None:
        return k * row_mask[None, :, :, None]
    if col_mask is not None:
        return k * col_mask[None, :, None, :]
    return k


class _GpChunk(NamedTuple):
    flat: Tuple[int, ...]    # the launch's spec, flat (spec_from)
    p0: int                  # its first row of theta
    rows: Tuple[Tuple[int, str], ...]   # its theta rows: (component, key)
    nr: int                  # rbf factors a component may have: 1 or
                             # MAX_FACT (the backward's sums a component)


def _gp_chunks(spec) -> List[_GpChunk]:
    """The spec's components split into launches within the compiled
    limits, each with its rows of theta (outputscales, then lengthscales):
    together the rows of the stacked raw parameters.  The table puts a
    component's rbf factors first (the backward keeps each one's sums in
    registers by its place) and gives each factor its covariate's index
    among the launch's staged dims."""
    comps = spec.components
    for comp in comps:
        if len(comp.factors) > GP_MAX["factors"] or any(
                f.kind not in GP_KINDS for f in comp.factors):
            raise ValueError(f"gp_kernel_matrix: a component of "
                             f"{[f.kind for f in comp.factors]}; the kernel "
                             f"takes at most {GP_MAX['factors']} factors "
                             f"of {sorted(GP_KINDS)}")

    def counts(cs):
        rbf = [f for c in cs for f in comps[c].factors if f.kind == "rbf"]
        return (len(cs), len(cs) + len(rbf), len({f.dim for f in rbf}))

    groups, cur = [], []
    for c in range(len(comps)):
        n_c, n_p, n_s = counts(cur + [c])
        if cur and (n_c > GP_MAX["components"] or n_p > GP_MAX["params"]
                    or n_s > GP_MAX["slots"]):
            groups.append(cur)
            cur = []
        cur.append(c)
    if cur:
        groups.append(cur)
    chunks, p0 = [], 0
    for cs in groups:
        rows = [(c, "raw_os") for c in cs]
        slots, dims, table = [], [], []
        for c in cs:
            facs = []
            factors = comps[c].factors
            for i in sorted(range(len(factors)),
                            key=lambda i: factors[i].kind != "rbf"):
                f = factors[i]
                if f.dim not in dims:
                    dims.append(f.dim)
                par = slot = -1
                if f.kind == "rbf":
                    par = len(rows)
                    rows.append((c, f"raw_ls_{i}"))
                    if f.dim not in slots:
                        slots.append(f.dim)
                    slot = slots.index(f.dim)
                facs.append((GP_KINDS[f.kind], f.dim, dims.index(f.dim),
                             f.num, par, slot))
            table.append(facs)
        most_rbf = max(sum(f[0] == GP_KINDS["rbf"] for f in facs)
                       for facs in table)
        flat = [len(cs), len(rows), len(slots), len(dims)]
        flat += dims + [0] * (GP_MAX_DIM - len(dims))
        flat += slots + [0] * (GP_MAX["slots"] - len(slots))
        for k in range(GP_MAX["components"]):
            facs = table[k] if k < len(table) else []
            flat.append(len(facs))
            for f in range(GP_MAX["factors"]):
                flat += (list(facs[f]) if f < len(facs)
                         else [0, 0, 0, 0, -1, -1])
        chunks.append(_GpChunk(tuple(flat), p0, tuple(rows),
                               1 if most_rbf <= 1 else GP_MAX["factors"]))
        p0 += len(rows)
    return chunks


class _GpGeo(NamedTuple):
    L: int
    S: int
    N1: int
    N2: int
    Q: int
    x1l: int
    x1s: int
    x2l: int
    x2s: int
    masks: int               # 0 none, 1 rows, 2 both, 3 columns
    shape: Tuple[int, ...]   # the output's

    def transposed(self) -> "_GpGeo":
        """The view of the transposed matrix: x1 and x2, and the row and
        column masks, swapped."""
        return self._replace(N1=self.N2, N2=self.N1, x1l=self.x2l,
                             x1s=self.x2s, x2l=self.x1l, x2s=self.x1s,
                             masks=(0, 3, 2, 1)[self.masks],
                             shape=self.shape[:-2] + (self.N2, self.N1))


def _gp_geometry(L, x1, x2, x1_batched, x2_batched, row_mask, col_mask):
    """The kernel's view of the operands: each [N, Q] or [S, N, Q], behind
    the latents [L] when batched."""
    def view(x, batched):
        core = x.shape[1:] if batched else x.shape
        if len(core) not in (2, 3) or (batched and x.shape[0] != L):
            raise ValueError(f"gp_kernel_matrix: an operand of shape "
                             f"{tuple(x.shape)} (batched {batched}); the "
                             f"kernel takes [L,] [S,] N, Q with L = {L}")
        n, q = core[-2], core[-1]
        s = core[0] if len(core) == 3 else 1
        return (n * q * s if batched else 0), n * q, s, n, q, len(core) == 3
    v1, v2 = view(x1, x1_batched), view(x2, x2_batched)
    S = max(v1[2], v2[2])
    if v1[4] != v2[4] or v1[2] not in (1, S) or v2[2] not in (1, S):
        raise ValueError(f"gp_kernel_matrix: operands {tuple(x1.shape)} and "
                         f"{tuple(x2.shape)} do not broadcast")
    N1, N2 = v1[3], v2[3]
    for m, n in ((row_mask, N1), (col_mask, N2)):
        if m is not None and tuple(m.shape) != (S, n):
            raise ValueError(f"gp_kernel_matrix: a mask of shape "
                             f"{tuple(m.shape)}, expected {(S, n)}")
    batch = (S,) if v1[5] or v2[5] else ()
    masks = (0 if row_mask is None and col_mask is None else
             3 if row_mask is None else 1 if col_mask is None else 2)
    return _GpGeo(L, S, N1, N2, v1[4], v1[0], v1[1] if v1[2] > 1 else 0,
                  v2[0], v2[1] if v2[2] > 1 else 0, masks,
                  (L,) + batch + (N1, N2))


class _GpPlan(NamedTuple):
    """A launch's tiles and scratch: gp_fwd_kernel's and
    gp_bwd_flat_kernel's blocks of ``rows`` whole rows by ``cols`` columns,
    ``vec`` entries a load and store; gp_bwd_cols_kernel's GP_TX columns by
    a chunk of ``rows`` rows (vec 1).  ``part``, ``tpart``: doubles of x2's
    partials (the chunks') and of the parameters' (the blocks');
    ``counters``: ints the launch's counters take."""
    grid: Tuple[int, int, int]
    rows: int
    cols: int
    vec: int
    part: int
    tpart: int
    counters: int


def _gp_smem(itemsize, ndim, rows, cols, nsub, sym=False) -> int:
    """A block's shared bytes, as gp_smem (csrc/fusion.cu) lays them out:
    the rows' dims and row mask, nsub subjects' column dims and column
    mask, each row's subject, the transposed tile of G (sym), each region
    16-byte aligned.  The plans fit their tiles within GP_SMEM by it; the
    C entries work the bytes out themselves and refuse a tile beyond."""
    a16 = lambda b: -(-b // 16) * 16
    return (a16((ndim + 1) * rows * itemsize)
            + a16(nsub * (ndim + 1) * cols * itemsize) + a16(rows * 4)
            + (GP_TX * (rows + 1) * itemsize if sym else 0))


def _gp_nsub(geo: _GpGeo, rows: int) -> int:
    """The subjects whose columns a flat block of ``rows`` rows stages:
    every subject it can touch where x2 or the column mask differs by
    subject, else one (flat_tile, csrc/fusion.cu)."""
    if geo.S > 1 and (geo.x2s != 0 or geo.masks >= 2):
        return min(geo.S, (rows + geo.N1 - 2) // geo.N1 + 1)
    return 1


def gp_flat_plan(geo: _GpGeo, ndim: int, itemsize: int, sms: int = GP_SMS,
                 vectors: bool = True) -> _GpPlan:
    """The flat kernels' tiles (the forward; the backward without x2's
    gradient): whole rows of at most GP_COLS columns; 16-byte vectors where
    N2 holds whole ones (and ``vectors``, the arrays' alignment, allows);
    two to eight vectors a thread, fewer blocks than two an SM only where
    two vectors a thread leave them; the shared bytes within GP_SMEM."""
    R = geo.S * geo.N1
    vec = 16 // itemsize
    vec = vec if vectors and geo.N2 % vec == 0 else 1
    cols = min(geo.N2, GP_COLS)
    per = geo.L * R * geo.N2 // vec // (GP_THREADS * 2 * sms)
    per = min(max(per, 2), 8)
    rows = min(max(-(-GP_THREADS * vec * per // cols), 1), R)
    while _gp_smem(itemsize, ndim, rows, cols,
                   _gp_nsub(geo, rows)) > GP_SMEM:
        if cols > 64:
            cols = cols // 2 // vec * vec
        elif rows > 1:
            rows //= 2
        else:
            raise ValueError(f"gp_kernel_matrix: no tile of {geo} fits "
                             f"{GP_SMEM} bytes")
    grid = (-(-R // rows), -(-geo.N2 // cols), geo.L)
    return _GpPlan(grid, rows, cols, vec, 0,
                   grid[0] * grid[1] * geo.L * GP_MAX["params"], geo.L)


def gp_cols_plan(geo: _GpGeo, ndim: int, itemsize: int, fold: int = 1,
                 sym: bool = False, dtheta: bool = True,
                 sms: int = GP_SMS) -> _GpPlan:
    """The column kernel's chunks (the backward with x2's gradient; ``geo``
    with S = 1 where the batch is folded): rows split into as many chunks,
    each a multiple of GP_TY rows, as two blocks an SM take in one wave;
    x2's partials only over several chunks; a counter a grid z."""
    R, Lz = geo.S * geo.N1, geo.L * fold
    tiles = -(-geo.N2 // GP_TX)
    nchunks = min(max(2 * sms // (Lz * tiles), 1), -(-R // GP_TY))
    rows = -(-(-(-R // nchunks)) // GP_TY) * GP_TY
    while _gp_smem(itemsize, ndim, rows, GP_TX, 1, sym) > GP_SMEM:
        if rows == GP_TY:
            raise ValueError(f"gp_kernel_matrix: no chunk of {geo} fits "
                             f"{GP_SMEM} bytes")
        rows = max(GP_TY, rows // 2 // GP_TY * GP_TY)
    nchunks = -(-R // rows)
    part = Lz * nchunks * tiles * GP_TX * GP_MAX["slots"] if nchunks > 1 \
        else 0
    return _GpPlan((tiles, nchunks, Lz), rows, GP_TX, 1, part,
                   Lz * tiles * nchunks * GP_MAX["params"] if dtheta else 0,
                   Lz)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# The column reductions' counters, a buffer a (device, stream): zero
# between launches (a launch's last blocks zero the ones it took), so the
# launches of one stream, which run in its order, share one, and no launch
# needs a fill.  A buffer outgrown stays alive: a captured CUDA graph keeps
# its address.
_STREAM_COUNTERS: Dict[Tuple[int, int], List[torch.Tensor]] = {}


def _stream_counters(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed counters for launches on ``stream`` (its
    ``cuda_stream`` handle) of ``device``."""
    bufs = _STREAM_COUNTERS.setdefault((device.index, stream), [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32,
                                device=device))
    return bufs[-1]


def _counters(like: torch.Tensor, n: int) -> torch.Tensor:
    """The counter buffer of the current stream on ``like``'s device,
    marked as scratch."""
    dev = like.device
    return _scratch(_stream_counters(
        dev, torch.cuda.current_stream(dev).cuda_stream, n))[0]


def _geo_args(g: _GpGeo):
    return (g.L, g.S, g.N1, g.N2, g.Q, _LongLong(g.x1l), _LongLong(g.x1s),
            _LongLong(g.x2l), _LongLong(g.x2s), g.masks)


def _tile_args(p: _GpPlan):
    return (p.rows, p.cols, p.vec)


def _spec_array(flat):
    return (ctypes.c_int * len(flat))(*flat)


def _gp_backward(G, theta, x1, x2, rm, cm, chunks, geo: _GpGeo, dtheta,
                 x2_like, sym=False):
    """The launches of one side's backward: into ``dtheta`` (when given)
    the raw parameters' gradient, and x2's (returned, shaped like
    ``x2_like``, when given).  Without x2's gradient the flat kernel takes
    the parameters'; with it the column kernel takes both, but a batched
    x2's, whose launch folds the batch into the latents, leaves the
    parameters' to a flat launch.  ``sym``: x1 is x2 under symmetric masks,
    and x2's gradient is one column reduction of G + G^T (whose parameter
    sums are twice G's)."""
    dev, dt, z = theta.device, theta.dtype, theta.element_size()
    sms = _sm_count(dev.index)
    fold = geo.S if x2_like is not None and geo.x2s else 1
    passes = []
    if dtheta is not None and (x2_like is None or fold > 1):
        passes.append((geo, 1, dtheta, False))
    if x2_like is not None:
        passes.append((geo._replace(S=1) if fold > 1 else geo, fold,
                       dtheta if fold == 1 else None, True))
    vectors = G.data_ptr() % 16 == 0
    dx = None
    for g, f, dth, want_dx in passes:
        Lz = geo.L * f
        dx = (torch.empty((Lz, g.N2, g.Q), dtype=dt, device=dev) if want_dx
              else None)
        for k, ch in enumerate(chunks):
            ndim = ch.flat[3]
            plan = (gp_cols_plan(g, ndim, z, f, sym, dth is not None, sms)
                    if want_dx else
                    gp_flat_plan(g, ndim, z, sms, vectors))
            part, tpart = _scratch(
                torch.empty(plan.part, dtype=torch.float64, device=dev),
                torch.empty(plan.tpart, dtype=torch.float64, device=dev))
            rows = slice(ch.p0, ch.p0 + len(ch.rows))
            _launch("gp_kernel_bwd", G, z, _spec_array(ch.flat), ch.nr,
                    theta[rows], x1, x2, rm, cm, G,
                    None if dth is None else dth[rows], dx,
                    0.5 if sym and want_dx else 1.0, part, tpart,
                    _counters(G, plan.counters),
                    *_geo_args(g), f, int(sym and want_dx),
                    *_tile_args(plan), int(k > 0))
    if x2_like is None:
        return None
    dx = dx.reshape((geo.L, fold, geo.N2, geo.Q) if fold > 1 else
                    (geo.L, geo.N2, geo.Q))
    if not geo.x2l:      # not batched over the latents: their sum
        dx = dx.sum(dim=0)
    return dx.reshape(x2_like.shape)


class _GpKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, x1, x2, rm, cm, chunks, geo):
        out = torch.empty(geo.shape, dtype=theta.dtype, device=theta.device)
        z = theta.element_size()
        for k, ch in enumerate(chunks):
            plan = gp_flat_plan(geo, ch.flat[3], z,
                                _sm_count(theta.device.index))
            _launch("gp_kernel_fwd", out, z, _spec_array(ch.flat), ch.nr,
                    theta[ch.p0:ch.p0 + len(ch.rows)], x1, x2, rm, cm, out,
                    *_geo_args(geo), *_tile_args(plan), int(k > 0))
        ctx.chunks, ctx.geo = chunks, geo
        # one matrix of x against itself under symmetric masks
        ctx.symmetric = x1 is x2 and rm is cm
        ctx.save_for_backward(theta, x1, x2, rm, cm)
        return out

    @staticmethod
    def backward(ctx, g):
        theta, x1, x2, rm, cm = ctx.saved_tensors
        geo, chunks = ctx.geo, ctx.chunks
        need_t, need_x1, need_x2 = ctx.needs_input_grad[:3]
        g = g.contiguous()
        dtheta = torch.empty_like(theta) if need_t else None
        if need_x1 and ctx.symmetric:
            # x's gradient is one column reduction of G + G^T, read in the
            # kernel (the transposed tile staged)
            dx = _gp_backward(g, theta, x1, x2, rm, cm, chunks, geo, dtheta,
                              x2, sym=True)
            return dtheta, None, dx, None, None, None, None
        dx2 = _gp_backward(g, theta, x1, x2, rm, cm, chunks, geo, dtheta,
                           x2 if need_x2 else None)
        dx1 = None
        if need_x1:
            # x1's gradient is x2's of the transposed matrix
            dx1 = _gp_backward(g.mT.contiguous(), theta, x2, x1, cm, rm,
                               chunks, geo.transposed(), None, x1)
        return dtheta, dx1, dx2, None, None, None, None


def gp_kernel_matrix(spec, params, x1, x2, x1_batched: bool = False,
                     x2_batched: bool = False, row_mask=None,
                     col_mask=None):
    """The latent-batched kernel matrix ``kernel_matrix(spec, params, x1,
    x2, ...)`` [L, *, N1, N2] times the padding masks (``row_mask``
    [S, N1] over the rows, ``col_mask`` [S, N2] over the columns).  The
    kernel on CUDA where it takes the dtype (operands [L,] [S,] N, Q), in
    one launch a few components, else the plain version."""
    leaves = [v for p in params for v in p.values()]
    if not spec.components:     # zeros, as the plain version gives them
        return gp_kernel_matrix_plain(spec, params, x1, x2, x1_batched,
                                      x2_batched, row_mask, col_mask)
    if not _uses_kernel(True, x1, "gp_kernel_plain", x2, row_mask,
                        col_mask, *leaves):
        return gp_kernel_matrix_plain(spec, params, x1, x2, x1_batched,
                                      x2_batched, row_mask, col_mask)
    geo = _gp_geometry(leaves[0].shape[0], x1, x2, x1_batched, x2_batched,
                       row_mask, col_mask)
    chunks = _gp_chunks(spec)
    theta = torch.stack([params[c][k] for ch in chunks for c, k in ch.rows])
    masks = [m.contiguous() if m is not None else None
             for m in (row_mask, col_mask)]
    return _GpKernel.apply(theta, x1.contiguous(), x2.contiguous(), *masks,
                           tuple(chunks), geo)
