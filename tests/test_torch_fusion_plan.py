"""The staged kernels' host-side plans (``hlax_torch.ops.fusion``): the cat
and the real head's forward and backward and the representation's backward
at the compiled sizes, and the recon metric.  Their grids cover every (row,
column) once, their chunks come in a fixed order, their scratch and shared
memory fit the H100 (and mirror the kernels' own layouts in csrc/fusion.cu),
the row runs the kernels stage split into 16-byte copies and single
elements as ``stage_run`` (csrc/fusion.cu) splits them, and the wrappers
launch what their plans say with the arguments the C entries take.  CPU
only: no card, no JAX."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hlax_torch.ops import fusion

SMS = 132          # an H100's SMs
SMEM_LIMIT = 232448   # shared bytes an H100's SM gives its blocks (227 KB)
CSRC = Path(fusion.__file__).resolve().parents[1] / "csrc" / "fusion.cu"
# (B, d): the canonical batch over the cat and the real group, one row, a
# batch one row past it, a group of one variable and one past a tile
CAT_SHAPES = [(400, 972), (400, 324), (1, 972), (401, 972), (400, 1),
              (37, 33), (1, 1)]
# a rank's rows on [mesh]'s 2 x 2 mesh (10 subjects of 20) and on a 4 x 1
# NCCL mesh (5 subjects)
MESH_ROWS = (200, 100)
# (B, d) of a real group: the canonical batch over D4's real quadrant, one
# row, a batch one row past it, a group of one variable and one past a
# tile, fewer rows than a block's warps, a wide group
REAL_SHAPES = [(400, 324), (1, 324), (401, 324), (400, 1), (37, 33), (5, 45),
               (1, 1), (400, 1296)]


def _blocks(plan, B):
    """The row range of each of the plan's chunks, as a block of the
    kernel walks it: warp w takes rows w, w + warps, ... of [y rows,
    min(B, (y + 1) rows))."""
    out = []
    for y in range(plan.chunks):
        lo, hi = y * plan.rows, min(B, (y + 1) * plan.rows)
        out.append([list(range(lo + w, hi, plan.warps))
                    for w in range(plan.warps)])
    return out


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("B,d", CAT_SHAPES)
def test_cat_bwd_plan_covers_every_cell_once(B, d, itemsize):
    """Every (row, variable) in exactly one block and warp; chunks within
    MAX_CHUNKS, each warp a row where the batch allows; partials (index
    (chunk d + v) NV + i) and counters (one a tile) within the scratch, or
    none for one chunk; the shared bytes within 227 KB."""
    plan = fusion.heads_cat_bwd_plan(B, d, fusion.HEAD_Y, fusion.NCLASS,
                                     itemsize, SMS)
    nv = (fusion.HEAD_Y + 1) * (fusion.NCLASS - 1)
    assert plan.tiles == -(-d // fusion.TILE)
    assert 1 <= plan.chunks <= fusion.MAX_CHUNKS
    assert plan.chunks == -(-B // plan.rows)
    assert (_covered(plan, B, d) == 1).all()
    if plan.chunks > 1:
        top = ((plan.chunks - 1) * d + d - 1) * nv + nv - 1
        assert plan.part == top + 1 and plan.counters == plan.tiles
        assert B >= fusion.WARPS * (plan.chunks - 1)
    else:
        assert plan.part == 0 and plan.counters == 0
    assert plan.smem <= SMEM_LIMIT
    assert plan.smem > 48 * 1024     # the C entry opts in to it
    # as many blocks an SM fit the shared memory as the plan aims at
    per_sm = fusion.CAT_BWD_PER_SM[itemsize]
    assert per_sm * plan.smem <= SMEM_LIMIT


def test_cat_bwd_plan_at_the_canonical_shape():
    """31 tiles of the 972 cat variables by 8 chunks of 50 rows in float
    (248 blocks, two an SM of 132 less a few), 4 of 100 in double (one an
    SM): partials 3x and 6x fewer than 16-row chunks' 25."""
    plan = fusion.heads_cat_bwd_plan(400, 972, 5, 5, 4, SMS)
    assert (plan.tiles, plan.chunks, plan.rows) == (31, 8, 50)
    assert plan.tiles * plan.chunks <= fusion.CAT_BWD_PER_SM[4] * SMS
    assert plan.part == 8 * 972 * 24
    f64 = fusion.heads_cat_bwd_plan(400, 972, 5, 5, 8, SMS)
    assert (f64.tiles, f64.chunks, f64.rows) == (31, 4, 100)
    assert f64.part == 4 * 972 * 24 and f64.smem > plan.smem


@pytest.mark.parametrize("Y,C", [(3, 5), (5, 7), (5, 3), (1, 2)])
def test_cat_bwd_plan_at_run_time_sizes(Y, C):
    """Other Y and C keep the run-time kernel: ROWS-row chunks, ANY_NV sums
    a z-slice, a counter a tile and slice, no dynamic shared memory."""
    B, d = 37, 33
    plan = fusion.heads_cat_bwd_plan(B, d, Y, C, 8, SMS)
    z = -(-(Y + 1) * (C - 1) // fusion.ANY_NV)
    assert plan.rows == fusion.ROWS and plan.chunks == -(-B // fusion.ROWS)
    assert plan.counters == z * plan.tiles and plan.smem == 0
    assert plan.part == z * plan.chunks * plan.tiles * fusion.TILE * \
        fusion.ANY_NV


def _covered(plan, B, d):
    """How many times the plan's blocks and warps take each (row, variable)
    of a B x d group."""
    seen = np.zeros((B, d), dtype=int)
    for x in range(plan.tiles):
        v0 = x * fusion.TILE
        cols = range(v0, min(d, v0 + fusion.TILE))
        for warps in _blocks(plan, B):
            for rows in warps:
                for r in rows:
                    seen[r, cols] += 1
    return seen


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("B,d", CAT_SHAPES)
def test_cat_fwd_plan_covers_every_cell_once(B, d, itemsize):
    """The cat head's forward, a map: every (row, variable) in exactly one
    block and warp; chunks within MAX_CHUNKS, each warp a row where the
    batch allows; no scratch and no counter; the shared bytes of the blocks
    an SM the plan aims at within 227 KB."""
    plan = fusion.heads_cat_fwd_plan(B, d, fusion.HEAD_Y, fusion.NCLASS,
                                     itemsize, SMS)
    assert plan.tiles == -(-d // fusion.TILE)
    assert 1 <= plan.chunks <= fusion.MAX_CHUNKS
    assert plan.chunks == -(-B // plan.rows)
    assert plan.chunks == 1 or B >= fusion.WARPS * (plan.chunks - 1)
    assert (_covered(plan, B, d) == 1).all()
    assert plan.part == 0 and plan.counters == 0
    assert fusion.CAT_FWD_PER_SM[itemsize] * plan.smem <= SMEM_LIMIT
    assert plan.launches == ()


@pytest.mark.parametrize("B", (400,) + MESH_ROWS)
def test_cat_fwd_plan_at_the_canonical_shape_and_a_mesh_rank(B):
    """31 tiles of the 972 cat variables by as many chunks as one wave of
    two blocks an SM takes in float (8: 248 blocks), one in double (4: 124
    blocks), at the canonical batch and at a mesh rank's rows: each warp
    at most ceil(rows / 8) rows; 45,440 and 89,472 shared bytes (the C
    entry opts in to the double's)."""
    f32 = fusion.heads_cat_fwd_plan(B, 972, 5, 5, 4, SMS)
    f64 = fusion.heads_cat_fwd_plan(B, 972, 5, 5, 8, SMS)
    assert (f32.tiles, f32.chunks, f32.rows) == (31, 8, -(-B // 8))
    assert (f64.tiles, f64.chunks, f64.rows) == (31, 4, -(-B // 4))
    assert f32.tiles * f32.chunks <= fusion.CAT_FWD_PER_SM[4] * SMS
    assert f64.tiles * f64.chunks <= fusion.CAT_FWD_PER_SM[8] * SMS
    assert (f32.smem, f64.smem) == (45440, 89472)


@pytest.mark.parametrize("Y,C", [(3, 5), (5, 7), (5, 3), (1, 2)])
def test_cat_fwd_plan_at_run_time_sizes(Y, C):
    """Other Y and C keep the run-time kernel: ROWS-row chunks, no scratch,
    no dynamic shared memory."""
    plan = fusion.heads_cat_fwd_plan(37, 33, Y, C, 8, SMS)
    assert (plan.rows, plan.chunks) == (fusion.ROWS, -(-37 // fusion.ROWS))
    assert (plan.part, plan.counters, plan.smem) == (0, 0, 0)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("B,d", CAT_SHAPES)
def test_rep_bwd_plan_covers_every_cell_once(B, d, itemsize):
    """The representation's backward: every (row, variable) in exactly one
    block and warp; chunks within MAX_CHUNKS; partials (index (chunk d +
    v)(C + 1) + i) and counters (one a tile) within the scratch, or none
    for one chunk; the shared bytes of the blocks an SM the plan aims at
    within 227 KB, and within the 48 KB a block takes without opting in."""
    C = fusion.NCLASS
    plan = fusion.rep_image_bwd_plan(B, d, C, itemsize, SMS)
    assert plan.tiles == -(-d // fusion.TILE)
    assert 1 <= plan.chunks <= fusion.MAX_CHUNKS
    assert plan.chunks == -(-B // plan.rows)
    assert plan.chunks == 1 or B >= fusion.WARPS * (plan.chunks - 1)
    assert (_covered(plan, B, d) == 1).all()
    if plan.chunks > 1:
        top = ((plan.chunks - 1) * d + d - 1) * (C + 1) + C
        assert plan.part == top + 1 and plan.counters == plan.tiles
    else:
        assert plan.part == 0 and plan.counters == 0
    assert fusion.REP_BWD_PER_SM * plan.smem <= SMEM_LIMIT
    assert plan.smem <= 48 * 1024


@pytest.mark.parametrize("B", (400,) + MESH_ROWS)
def test_rep_bwd_plan_at_the_canonical_shape_and_a_mesh_rank(B):
    """31 tiles by MAX_CHUNKS chunks (four blocks an SM would take 17), or
    at a 4 x 1 rank's 100 rows 13 (a row a warp), the same in float and
    double: partials of 16 x 972 x 6 doubles at the canonical batch, 0.75
    MB, where 16-row chunks wrote 25 (1.17 MB); a counter a tile."""
    chunks = min(fusion.MAX_CHUNKS, -(-B // fusion.WARPS))
    for itemsize in (4, 8):
        plan = fusion.rep_image_bwd_plan(B, 972, 5, itemsize, SMS)
        assert (plan.tiles, plan.chunks) == (31, chunks)
        assert plan.rows == -(-B // chunks)
        assert plan.part == chunks * 972 * 6 and plan.counters == 31
    assert fusion.rep_image_bwd_plan(400, 972, 5, 4, SMS).smem == 22272
    assert fusion.rep_image_bwd_plan(400, 972, 5, 8, SMS).smem == 43776


@pytest.mark.parametrize("C", [2, 3, 7, 8])
def test_rep_bwd_plan_at_run_time_sizes(C):
    """Other C keep the run-time kernel: ROWS-row chunks, ANY_NV sums a
    z-slice, a counter a tile and slice, no dynamic shared memory."""
    B, d = 37, 33
    plan = fusion.rep_image_bwd_plan(B, d, C, 8, SMS)
    z = -(-(C + 1) // fusion.ANY_NV)
    assert plan.rows == fusion.ROWS and plan.chunks == -(-B // fusion.ROWS)
    assert plan.counters == z * plan.tiles and plan.smem == 0
    assert plan.part == z * plan.chunks * plan.tiles * fusion.TILE * \
        fusion.ANY_NV


@pytest.mark.parametrize("logvar", [False, True])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("B,d", REAL_SHAPES)
def test_real_fwd_plan_covers_every_cell_once(B, d, itemsize, logvar):
    """The real head's forward, a map: every (row, variable) in exactly one
    block and warp; no more chunks than one wave of the blocks an SM its
    launch bounds give (but one) or than leave each warp a row; no scratch,
    no counter, no cluster; the shared bytes of the blocks an SM the plan
    aims at within 227 KB, and within the 48 KB a block takes without
    opting in."""
    plan = fusion.heads_real_fwd_plan(B, d, fusion.HEAD_Y, logvar, itemsize,
                                      SMS)
    per_sm = fusion.REAL_FWD_PER_SM[itemsize, logvar]
    assert plan.tiles == -(-d // fusion.TILE)
    assert 1 <= plan.chunks <= -(-B // fusion.WARPS)
    assert plan.chunks == 1 or plan.tiles * plan.chunks <= per_sm * SMS
    assert plan.chunks == -(-B // plan.rows)
    assert plan.chunks == 1 or B >= fusion.WARPS * (plan.chunks - 1)
    assert plan.warps == fusion.WARPS
    assert (_covered(plan, B, d) == 1).all()
    assert (plan.part, plan.counters, plan.cluster) == (0, 0, 0)
    assert per_sm * plan.smem <= SMEM_LIMIT
    assert plan.smem <= 48 * 1024


@pytest.mark.parametrize("logvar", [False, True])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("B,d", REAL_SHAPES)
def test_real_bwd_plan_covers_every_cell_once(B, d, itemsize, logvar):
    """The real head's backward: every (row, variable) in exactly one block
    and warp; a tile's chunks one thread-block cluster of at most the
    portable size, each warp a row where the batch allows; no partials in
    global memory and no counter, whatever the chunks; the shared bytes of
    the blocks an SM the plan aims at within 227 KB."""
    plan = fusion.heads_real_bwd_plan(B, d, fusion.HEAD_Y, logvar, itemsize,
                                      SMS)
    assert plan.tiles == -(-d // fusion.TILE)
    assert 1 <= plan.chunks <= fusion.MAX_CLUSTER
    assert plan.cluster == plan.chunks
    assert plan.chunks == 1 or plan.tiles * plan.chunks <= \
        fusion.REAL_BWD_PER_SM * SMS
    assert plan.chunks == -(-B // plan.rows)
    assert plan.chunks == 1 or B >= fusion.WARPS * (plan.chunks - 1)
    assert plan.warps == fusion.REAL_BWD_WARPS[itemsize, logvar]
    assert (_covered(plan, B, d) == 1).all()
    assert plan.part == 0 and plan.counters == 0
    assert fusion.REAL_BWD_PER_SM * plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("B", (400,) + MESH_ROWS)
def test_real_plans_at_the_canonical_shape_and_a_mesh_rank(B):
    """D4's 324 real variables, 11 tiles: the forward in as many chunks as
    one wave of its blocks an SM or a row a warp allow (at the canonical
    batch in float 45 chunks of 9 rows, 495 blocks, four an SM; with the
    logvar network in double 24 of 17, two an SM), the backward in clusters
    of 8
    chunks (88 blocks of 16 warps, 8 in double with the logvar network),
    at the canonical batch and at a mesh rank's rows; the shared bytes of
    each."""
    for itemsize in (4, 8):
        for logvar in (False, True):
            fwd = fusion.heads_real_fwd_plan(B, 324, 5, logvar, itemsize,
                                             SMS)
            per_sm = fusion.REAL_FWD_PER_SM[itemsize, logvar]
            n = min(per_sm * SMS // 11, -(-B // fusion.WARPS))
            assert (fwd.tiles, fwd.rows) == (11, -(-B // n))
            assert fwd.chunks == -(-B // fwd.rows)
            assert fwd.tiles * fwd.chunks <= per_sm * SMS
            bwd = fusion.heads_real_bwd_plan(B, 324, 5, logvar, itemsize, SMS)
            assert (bwd.tiles, bwd.chunks, bwd.cluster) == (11, 8, 8)
            assert bwd.rows == -(-B // 8)
            assert bwd.warps == (8 if (itemsize, logvar) == (8, True) else 16)
    assert fusion.heads_real_fwd_plan(400, 324, 5, False, 4, SMS)[:3] == (
        11, 45, 9)
    assert fusion.heads_real_fwd_plan(400, 324, 5, True, 8, SMS)[:3] == (
        11, 24, 17)
    assert [fusion.heads_real_fwd_plan(400, 324, 5, False, z, SMS).smem
            for z in (4, 8)] == [22656, 44160]
    assert [fusion.heads_real_bwd_plan(400, 324, 5, lv, z, SMS).smem
            for z in (4, 8) for lv in (False, True)] == [100352, 119808,
                                                         182272, 117248]


@pytest.mark.parametrize("logvar", [False, True])
@pytest.mark.parametrize("Y", [3, 1, 7])
def test_real_plans_at_run_time_sizes(Y, logvar):
    """Other y_dims keep the run-time kernels: ROWS-row chunks; the
    backward's ANY_NV sums a z-slice with their partials and a counter a
    tile and slice; no dynamic shared memory, no cluster."""
    B, d = 37, 33
    fwd = fusion.heads_real_fwd_plan(B, d, Y, logvar, 8, SMS)
    assert (fwd.rows, fwd.chunks) == (fusion.ROWS, -(-B // fusion.ROWS))
    assert (fwd.part, fwd.counters, fwd.smem, fwd.cluster) == (0, 0, 0, 0)
    bwd = fusion.heads_real_bwd_plan(B, d, Y, logvar, 8, SMS)
    z = -(-(2 * Y + 2 if logvar else Y + 2) // fusion.ANY_NV)
    assert (bwd.rows, bwd.chunks) == (fusion.ROWS, -(-B // fusion.ROWS))
    assert bwd.counters == z * bwd.tiles and bwd.smem == bwd.cluster == 0
    assert bwd.part == z * bwd.chunks * bwd.tiles * fusion.TILE * \
        fusion.ANY_NV


def _struct_const(struct: str, name: str) -> int:
    """The value of ``static constexpr int name = <int>;`` in csrc/fusion.cu's
    struct ``struct``."""
    body = CSRC.read_text().split(f"struct {struct} {{", 1)[1].split("};")[0]
    return int(re.search(rf"int {name} = (\d+);", body).group(1))


def test_plans_mirror_the_kernels_layouts():
    """The stages the plans' shared bytes count are the kernels' (NST of
    each staged kernel's shared-memory struct), and the blocks an SM the
    plans aim at are what the launch bounds give."""
    assert _struct_const("CatFwdSmem", "NST") == fusion.CAT_FWD_STAGES
    assert _struct_const("CatBwdSmem", "NST") == fusion.CAT_BWD_STAGES
    assert _struct_const("RepBwdSmem", "NST") == fusion.REP_BWD_STAGES
    assert _struct_const("MetricSmem", "NST") == fusion.METRIC_STAGES
    assert _struct_const("RealFwdSmem", "NST") == fusion.REAL_FWD_STAGES
    assert _struct_const("RealBwdSmem", "NST") == fusion.REAL_BWD_STAGES
    src = CSRC.read_text()
    assert int(re.search(r"constexpr int REP_BWD_BLOCKS = (\d+);",
                         src).group(1)) == fusion.REP_BWD_PER_SM
    # the real head's, by (itemsize, logvar network)
    body = src.split("constexpr int real_fwd_blocks()", 1)[1].split("}")[0]
    f4, f4lv, f8lv, f8 = map(int, re.search(
        r"sizeof\(T\) == 4 \? \(LV \? (\d+) : (\d+)\) : "
        r"\(LV \? (\d+) : (\d+)\)", body).groups())
    assert fusion.REAL_FWD_PER_SM == {(4, False): f4lv, (4, True): f4,
                                      (8, False): f8, (8, True): f8lv}
    body = src.split("constexpr int real_bwd_warps()", 1)[1].split("}")[0]
    lv, other = map(int, re.search(
        r"sizeof\(T\) == 8 && LV \? (\d+) : (\d+)", body).groups())
    assert fusion.REAL_BWD_WARPS == {(4, False): other, (4, True): other,
                                     (8, False): other, (8, True): lv}
    assert "__launch_bounds__(TILE * real_bwd_warps<T, LV>(), 1)" in src
    assert fusion.REAL_BWD_PER_SM == 1
    assert int(re.search(r"constexpr int MAX_CLUSTER = (\d+);",
                         src).group(1)) == fusion.MAX_CLUSTER
    for fn, per_sm in (("cat_fwd_blocks", fusion.CAT_FWD_PER_SM),
                       ("cat_bwd_blocks", fusion.CAT_BWD_PER_SM)):
        body = src.split(f"constexpr int {fn}()", 1)[1].split("}", 1)[0]
        f, d = re.search(r"sizeof\(T\) == 4 \? (\d+) : (\d+)",
                         body).groups()
        assert (int(f), int(d)) == (per_sm[4], per_sm[8])


@pytest.mark.parametrize("plan_of", ["cat_fwd", "rep_bwd", "real_fwd",
                                     "real_bwd"])
def test_new_plans_chunk_order_is_fixed(plan_of):
    """The chunks are consecutive row ranges in increasing order, a
    function of the shapes and the SM count alone (the real head's
    backward: a tile's cluster, rank k chunk k)."""
    make = {"cat_fwd": lambda: fusion.heads_cat_fwd_plan(401, 972, 5, 5, 4,
                                                         SMS),
            "rep_bwd": lambda: fusion.rep_image_bwd_plan(401, 972, 5, 4, SMS),
            "real_fwd": lambda: fusion.heads_real_fwd_plan(401, 324, 5,
                                                           False, 4, SMS),
            "real_bwd": lambda: fusion.heads_real_bwd_plan(401, 324, 5, True,
                                                           4, SMS)}[plan_of]
    a = make()
    assert a == make()
    starts = [warps[0][0] for warps in _blocks(a, 401)]
    assert starts == sorted(starts) == [k * a.rows for k in range(a.chunks)]


def test_chunk_order_is_fixed():
    """The chunks are consecutive row ranges in increasing order, a
    function of the shapes and the SM count alone; the tile's last block
    adds chunk k's partials at offset k d NV, in k's order, whichever
    block arrives last."""
    a = fusion.heads_cat_bwd_plan(401, 972, 5, 5, 4, SMS)
    assert a == fusion.heads_cat_bwd_plan(401, 972, 5, 5, 4, SMS)
    starts = [warps[0][0] for warps in _blocks(a, 401)]
    assert starts == sorted(starts) == [k * a.rows for k in range(a.chunks)]
    nv = 24
    offsets = [k * 972 * nv for k in range(a.chunks)]
    assert offsets == sorted(set(offsets))
    assert offsets[-1] + 972 * nv == a.part


@pytest.mark.parametrize("per_sm", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 7, 8, 9, 400, 401, 4000])
def test_row_chunks(B, per_sm):
    """At most MAX_CHUNKS chunks, no more than a wave of per_sm blocks an
    SM takes (but one), no more than leave every warp a row, the rows spread
    evenly: no chunk but the last shorter, none empty."""
    for tiles in (1, 11, 31, 42, 500):
        n, rows = fusion.row_chunks(B, tiles, per_sm, SMS)
        assert 1 <= n <= fusion.MAX_CHUNKS
        assert n == 1 or n * tiles <= per_sm * SMS
        assert n == 1 or B >= fusion.WARPS * (n - 1)
        assert (n - 1) * rows < B <= n * rows


def _metric_groups(n, d_each=(972, 324, 33, 1)):
    return [d_each[k % len(d_each)] for k in range(n)]


@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("ngroups", [1, 2, 32])
@pytest.mark.parametrize("B", [400, 1, 401])
def test_metric_plan_covers_every_cell_once(B, ngroups, mesh):
    """One grid over every group's tiles: each group's first tile after the
    one before's last, every (row, raw column) of every group in one block;
    partials within the scratch, a counter a tile and one over the tiles;
    the shared bytes of the blocks an SM takes within 227 KB; one launch on
    one process, the column sums and the finish apart on a mesh."""
    ds = _metric_groups(ngroups)
    n_raw = sum(ds) + 5        # columns of groups the metric does not take
    plan = fusion.metric_plan(B, n_raw, ds, 8, SMS, mesh)
    assert plan.tiles == sum(-(-d // fusion.TILE) for d in ds)
    assert plan.tile0 == tuple(np.cumsum([0] + [-(-d // fusion.TILE)
                                                for d in ds])[:-1])
    seen = np.zeros((B, sum(ds)), dtype=int)
    r0 = np.cumsum([0] + ds)[:-1]
    for x in range(plan.tiles):
        k = max(j for j in range(ngroups) if plan.tile0[j] <= x)
        v0 = (x - plan.tile0[k]) * fusion.TILE
        cols = range(r0[k] + v0, r0[k] + min(ds[k], v0 + fusion.TILE))
        for warps in _blocks(plan, B):
            for rows in warps:
                for r in rows:
                    seen[r, cols] += 1
    assert (seen == 1).all()
    assert plan.counters == plan.tiles + 1
    # the column sums' and valid rows' partials over several chunks
    # ((chunk n_raw + column) METRIC_NV + i, then chunk tiles + tile), the
    # tiles' finish pairs on one process
    cols = plan.chunks * (n_raw * fusion.METRIC_NV + plan.tiles)
    want = (cols if plan.chunks > 1 else 0) + (0 if mesh else 2 * plan.tiles)
    assert plan.part == want
    for itemsize in (4, 8):    # as many blocks an SM as the plan aims at
        assert fusion.METRIC_PER_SM * fusion._metric_smem(itemsize) <= \
            SMEM_LIMIT
    assert plan.launches == (("recon_metric", "recon_metric_finish")
                             if mesh else ("recon_metric",))


def test_metric_plan_at_the_canonical_shape():
    """The cat group's 31 tiles and the real group's 11 by 6 chunks of 67
    rows: 252 blocks, two an SM less a few, one wave."""
    plan = fusion.metric_plan(400, 1296, [972, 324], 4, SMS, False)
    assert (plan.tiles, plan.chunks, plan.rows) == (42, 6, 67)
    assert plan.tiles * plan.chunks <= fusion.METRIC_PER_SM * SMS
    assert plan.tile0 == (0, 31)


def _stage_split(addr, n, itemsize):
    """stage_run's split (csrc/fusion.cu) of a run of n elements at byte
    address addr: (single elements, 16-byte vectors' first elements, the
    run's shared offset mis)."""
    v = 16 // itemsize
    mis = addr % 16 // itemsize
    head = min(n, v - mis) if mis else 0
    nvec = (n - head) // v
    singles = list(range(head)) + list(range(head + nvec * v, n))
    return singles, [head + k * v for k in range(nvec)], mis


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [1, 3, 5, 33, 155, 160])
def test_staged_runs_copy_every_element_once(n, itemsize):
    """A run at every misalignment (a group's r0, e0 or t0 off a 16-byte
    boundary, the ragged last tile): each element copied once, each vector
    16-byte aligned in device and in shared memory (the run lands at mis),
    nothing past the run read."""
    v = 16 // itemsize
    for shift in range(v):
        addr = 4096 + shift * itemsize
        singles, vecs, mis = _stage_split(addr, n, itemsize)
        got = sorted(singles + [e + j for e in vecs for j in range(v)])
        assert got == list(range(n))
        for e in vecs:
            assert (addr + e * itemsize) % 16 == 0
            assert (mis + e) * itemsize % 16 == 0
        assert mis + n <= fusion.TILE * 5 + v or n > fusion.TILE * 5


# ---- the wrappers' launches, on the CPU with the launches recorded --------

def _c_params():
    """{entry: number of parameters} of csrc/fusion.cu's C entries."""
    src = CSRC.read_text()
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[m.group(1)] = len([p for p in m.group(2).split(",") if p.strip()])
    return out


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers on CPU tensors as on the card: each launch recorded
    (entry, args) and held to its C entry's parameter count (the stream
    last), nothing run."""
    params, calls = _c_params(), []

    def launch(entry, like, *args):
        assert len(args) + 1 == params[entry], (entry, len(args))
        calls.append((entry, args))

    monkeypatch.setattr(fusion, "_launch", launch)
    monkeypatch.setattr(fusion, "_uses_kernel",
                        lambda takes, t, name, *others: takes)
    monkeypatch.setattr(fusion, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(fusion, "_counters",
                        lambda like, n: torch.zeros(n, dtype=torch.int32))
    return calls


def _layout(n_cat, n_real, rows, y_dim=5, seed=0, logvar=False):
    """A float64 MLP model of y_dim (with the logvar network, ``logvar``)
    on a layout of n_cat cat(5) and n_real real variables, its rows and
    decoder features."""
    from hlax_torch.data.reader import encode_raw
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig

    rng = np.random.default_rng(seed)
    types = ([{"type": "cat", "dim": 1, "nclass": 5}] * n_cat
             + [{"type": "real", "dim": 1, "nclass": 1}] * n_real)
    raw = np.column_stack([rng.integers(0, 5, rows).astype(float)
                           if t["type"] == "cat" else rng.random(rows) * 255
                           for t in types])
    het = encode_raw(raw, types, miss_mask=np.ones_like(raw),
                     logvar_network=logvar)
    model = HLVAE(HLVAEConfig(layout=het.layout, z_dim=4, h_dims=(8,),
                              y_dim=y_dim, conv=False, logvar_network=logvar),
                  torch.Generator().manual_seed(seed), "cpu").double()
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    y = torch.randn((rows, het.layout.n_raw, y_dim), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(seed))
    return model, y, t(het.data), t(het.mask), t(het.theta_mask)


class _OneRankSums:
    def subjects(self, x):
        return x.clone()

    def subjects_max(self, x):
        return x.clone()


@pytest.mark.parametrize("mesh", [False, True])
def test_metric_wrapper_launches_what_its_plan_says(recorded, mesh):
    """One process: one recon_metric launch with the output (the finish in
    it); a mesh: the column sums without it, then recon_metric_finish with
    the ranks' sums; the group table's tiles and the rows a chunk as the
    plan has them."""
    model, _, data, mask, _ = _layout(40, 9, 21)
    lay = model.cfg.layout
    params = [torch.zeros((21, 40, 5), dtype=torch.float64),
              (torch.zeros((21, 9), dtype=torch.float64),
               torch.ones((21, 9), dtype=torch.float64))]
    rv = torch.ones(21, dtype=torch.float64)
    fusion.recon_metric(lay, False, params, data, mask, rv, "cat",
                        _OneRankSums() if mesh else None)
    entries = [e for e, _ in recorded]
    plan = fusion.metric_plan(21, lay.n_raw, [40, 9], 8, SMS, mesh)
    assert tuple(entries) == plan.launches
    args = recorded[0][1]
    table = list(args[1])
    assert table == [0, 0, 40, fusion.METRIC_KIND["cat"], 5, 1, 0,
                     40, 200, 9, fusion.METRIC_KIND["real"], 0, 0, 2]
    assert args[3] == 2 and args[-1] == plan.rows
    assert (args[10] is None) == mesh      # out: the finish in the launch
    assert (args[9] is None) != mesh       # cs: the mesh's column sums
    assert args[7].numel() == plan.part
    assert args[8].numel() == plan.counters
    if mesh:
        fin = recorded[1][1]
        assert list(fin[1]) == table and fin[2] == 2


@pytest.mark.parametrize("y_dim", [5, 3])
def test_heads_backward_launches_with_its_plan(recorded, y_dim):
    """The cat head's backward takes its plan's rows, partials and counters
    (the staged kernel at y_dim 5, the run-time kernel at 3); the real
    head's backward its plan's rows, and at y_dim 5 no partials and no
    counter (its chunks meet in their cluster), at 3 the plan's."""
    from hlax_torch.ops.normalization import NormParams

    model, y, data, mask, tmask = _layout(40, 9, 21, y_dim)
    y = y.requires_grad_(True)
    lp = fusion.heads_loglik(model, y, tmask, data, mask,
                             NormParams(None, None, None, None))[0]
    torch.autograd.grad(lp.sum(), [y] + list(model.obs.values()),
                        allow_unused=True)
    calls = dict(recorded)
    assert {"heads_cat_fwd", "heads_real_fwd", "heads_cat_bwd",
            "heads_real_bwd"} <= set(calls)
    plan = fusion.heads_cat_bwd_plan(21, 40, y_dim, 5, 8, SMS)
    cat = calls["heads_cat_bwd"]
    assert cat[-1] == plan.rows and cat[-2] == 5 and cat[-3] == y_dim
    assert cat[16].numel() == plan.part and cat[17].numel() == plan.counters
    real = calls["heads_real_bwd"]
    rplan = fusion.heads_real_bwd_plan(21, 9, y_dim, False, 8, SMS)
    assert real[-1] == rplan.rows and real[-4] == y_dim
    if y_dim == fusion.HEAD_Y:
        assert real[24] is None and real[25] is None
        assert rplan.part == rplan.counters == 0
        assert rplan.cluster == rplan.chunks
    else:
        assert real[24].numel() == rplan.part
        assert real[25].numel() == rplan.counters
        assert real[25].dtype == torch.int32


@pytest.mark.parametrize("logvar", [False, True])
@pytest.mark.parametrize("y_dim", [5, 3])
def test_real_heads_launch_with_their_plans(recorded, y_dim, logvar):
    """The real head's forward and backward, one launch each, with their
    plans' rows (the staged kernels at y_dim 5, the run-time kernels' ROWS
    at 3), with and without the logvar network (its flag and the second
    head's weights and their gradients handed over, log_vy not); the
    backward's scratch as its plan has it: none at y_dim 5."""
    from hlax_torch.ops.normalization import NormParams

    B, n_real = 21, 45
    model, y, data, mask, tmask = _layout(40, n_real, B, y_dim, 1, logvar)
    y = y.requires_grad_(True)
    lp = fusion.heads_loglik(model, y, tmask, data, mask,
                             NormParams(None, None, None, None))[0]
    torch.autograd.grad(lp.sum(), [y] + list(model.obs.values()),
                        allow_unused=True)
    fwd = [a for e, a in recorded if e == "heads_real_fwd"]
    bwd = [a for e, a in recorded if e == "heads_real_bwd"]
    assert len(fwd) == len(bwd) == 1
    fwd, bwd = fwd[0], bwd[0]
    fplan = fusion.heads_real_fwd_plan(B, n_real, y_dim, logvar, 8, SMS)
    bplan = fusion.heads_real_bwd_plan(B, n_real, y_dim, logvar, 8, SMS)
    assert fwd[16:18] == (B, n_real) and fwd[24:27] == (y_dim, int(logvar),
                                                        0)
    assert fwd[-1] == fplan.rows
    assert bwd[26:28] == (B, n_real) and bwd[34:37] == (y_dim, int(logvar),
                                                        0)
    assert bwd[-1] == bplan.rows
    for i in (4, 5):            # the logvar network's weights, or none
        assert (fwd[i] is not None) == logvar
        assert (bwd[i] is not None) == logvar
    assert (fwd[6] is None) == logvar and (bwd[6] is None) == logvar
    assert (bwd[21] is not None) == logvar and (bwd[23] is None) == logvar
    assert fwd[14].shape == ((B, n_real) if logvar else (n_real,))
    if bplan.part:
        assert bwd[24].numel() == bplan.part
        assert bwd[25].numel() == bplan.counters
    else:
        assert bwd[24] is None and bwd[25] is None


def _conv_layout(n_cat, n_real, rows, nclass=5, seed=0):
    """A float64 conv model on a side x side image of n_cat cat(nclass) and
    n_real real variables (n_cat + n_real = side^2), and its rows."""
    from hlax_torch.data.reader import encode_raw
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig

    side = int(round((n_cat + n_real) ** 0.5))
    assert side * side == n_cat + n_real
    rng = np.random.default_rng(seed)
    types = ([{"type": "cat", "dim": 1, "nclass": nclass}] * n_cat
             + [{"type": "real", "dim": 1, "nclass": 1}] * n_real)
    raw = np.column_stack([rng.integers(0, nclass, rows).astype(float)
                           if t["type"] == "cat" else rng.random(rows) * 255
                           for t in types])
    het = encode_raw(raw, types, miss_mask=np.ones_like(raw))
    model = HLVAE(HLVAEConfig(layout=het.layout, z_dim=4, h_dims=(8,),
                              y_dim=5, conv=True, image_side=side),
                  torch.Generator().manual_seed(seed), "cpu").double()
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    return model, t(het.data), t(het.mask)


@pytest.mark.parametrize("y_dim", [5, 3])
def test_heads_forward_launches_with_its_plan(recorded, y_dim):
    """The cat head's forward takes its plan's rows (the staged map at
    y_dim 5, the run-time kernel's ROWS at 3), one launch a cat group."""
    from hlax_torch.ops.normalization import NormParams

    model, y, data, mask, tmask = _layout(40, 9, 21, y_dim)
    fusion.heads_loglik(model, y, tmask, data, mask,
                        NormParams(None, None, None, None))
    cats = [args for entry, args in recorded if entry == "heads_cat_fwd"]
    assert len(cats) == 1
    plan = fusion.heads_cat_fwd_plan(21, 40, y_dim, 5, 8, SMS)
    assert cats[0][-1] == plan.rows and cats[0][-2] == 5
    assert cats[0][-3] == y_dim
    assert plan.rows == (fusion.ROWS if y_dim != 5 else
                         fusion.row_chunks(21, 2, 1, SMS)[1])


@pytest.mark.parametrize("nclass", [5, 3])
def test_rep_image_backward_launches_with_its_plan(recorded, nclass):
    """The representation's backward takes its plan's rows, partials and
    counters (the staged kernel at 5 classes, the run-time kernel at 3),
    one launch a cat group, after one forward launch a group."""
    model, data, mask = _conv_layout(40, 24, 21, nclass)
    img = fusion.rep_image(model, data, mask)
    params = list(model.rep_w.values()) + list(model.rep_b.values())
    torch.autograd.grad(img.sum(), params)
    entries = [entry for entry, _ in recorded]
    assert entries == ["rep_image_fwd", "rep_image_fwd", "rep_image_bwd"]
    args = recorded[-1][1]
    plan = fusion.rep_image_bwd_plan(21, 40, nclass, 8, SMS)
    assert args[-1] == plan.rows and args[-2] == nclass
    assert args[7].numel() == plan.part and args[8].numel() == plan.counters
    assert args[9] == 21 and args[10] == 40
