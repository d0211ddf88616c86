"""The GP kernel matrix's host-side plan (``hlax_torch.ops.fusion``): the
spec table its kernels read, the map from their per-(component, factor)
sums to theta rows and x2-gradient slots, and the tiles, grids and
scratch the wrapper picks.  CPU only: no card, no JAX."""
import numpy as np
import pytest
import torch

from hlax_torch.gp import kernels as tk
from hlax_torch.ops import fusion

# the canonical config's kernels (configs/hlvae_config_file.txt)
CANONICAL = ([2], [], [0], [{"cont_covariate": 0, "cat_covariate": 2},
                            {"cont_covariate": 0, "cat_covariate": 3},
                            {"cont_covariate": 1, "cat_covariate": 4}],
             [], [], 2)
# seven components over three launches (tests/test_torch_cuda.py's)
BEYOND = ([3, 4], [3], [0, 1, 5],
          [{"cont_covariate": 0, "cat_covariate": 2},
           {"cont_covariate": 5, "cat_covariate": 3},
           {"cont_covariate": 1, "cat_covariate": 4}],
          [{"cont_covariate": 5, "bin_covariate": 4}],
          [{"covariate": 5, "mask": 4}], 2)
F, C = tk.KernelFactor, tk.KernelComponent
# two rbf factors in a component, after a cat one; a catmod
TWO_RBF = tk.KernelSpec((C((F("cat", 3), F("rbf", 0), F("rbf", 1))),
                         C((F("catmod", 4, 3), F("rbf", 1))),
                         C((F("bin", 3),))))
SPECS = {"spec0": tk.build_kernel_specs(*CANONICAL)[0],
         "spec1": tk.build_kernel_specs(*CANONICAL)[1],
         "beyond": tk.build_kernel_specs(*BEYOND)[0],
         "two rbf": TWO_RBF}
NCOMP, NFACT = fusion.GP_MAX["components"], fusion.GP_MAX["factors"]
NSLOT, NDIM = fusion.GP_MAX["slots"], fusion.GP_MAX_DIM


def _table(flat):
    """The flat table as spec_from (csrc/fusion.cu) reads it."""
    a = list(flat)
    head, a = a[:4], a[4:]
    dims, a = a[:NDIM], a[NDIM:]
    slot_dim, a = a[:NSLOT], a[NSLOT:]
    comps = []
    for _ in range(NCOMP):
        nf, a = a[0], a[1:]
        facs = [tuple(a[6 * f:6 * f + 6]) for f in range(NFACT)]
        a = a[6 * NFACT:]
        comps.append(facs[:nf])
    assert not a
    return head, dims, slot_dim, comps


@pytest.mark.parametrize("name", list(SPECS))
def test_gp_table_is_what_the_kernels_read(name):
    """Each launch's table: its size, the staged dims (distinct, every
    factor's among them at its index u), a component's rbf factors first
    and no more of them than the launch's nr, the slots' dims."""
    for ch in fusion._gp_chunks(SPECS[name]):
        assert len(ch.flat) == 4 + NDIM + NSLOT + NCOMP * (1 + 6 * NFACT)
        (ncomp, nparam, nslot, ndim), dims, slot_dim, comps = _table(ch.flat)
        assert 1 <= ncomp <= NCOMP and ncomp <= nparam
        assert len(set(dims[:ndim])) == ndim and not any(dims[ndim:])
        assert all(c == [] for c in comps[ncomp:])
        for facs in comps[:ncomp]:
            kinds = [k for k, *_ in facs]
            n_rbf = kinds.count(fusion.GP_KINDS["rbf"])
            assert kinds[:n_rbf] == [fusion.GP_KINDS["rbf"]] * n_rbf
            assert n_rbf <= ch.nr
            for kind, dim, u, num, par, slot in facs:
                assert 0 <= u < ndim and dims[u] == dim
                if kind == fusion.GP_KINDS["rbf"]:
                    assert 0 <= slot < nslot and slot_dim[slot] == dim
                else:
                    assert par == slot == -1
    nrs = {ch.nr for ch in fusion._gp_chunks(SPECS[name])}
    assert nrs == ({NFACT} if name == "two rbf" else {1})


@pytest.mark.parametrize("name", list(SPECS))
def test_gp_sums_fold_into_theta_rows_and_slots(name):
    """The backward's sums a (component, factor): an outputscale's into
    its component's raw_os row, an rbf's into its own raw_ls row (each row
    once, in the stacked order ``gp_kernel_matrix`` builds theta in) and
    its covariate's slot; the launches' rows are every raw parameter."""
    spec = SPECS[name]
    chunks = fusion._gp_chunks(spec)
    rows = [r for ch in chunks for r in ch.rows]
    params = tk.init_kernel_params(spec, 2)
    assert sorted(rows) == sorted((c, k) for c, p in enumerate(params)
                                  for k in p)
    assert len(set(rows)) == len(rows)
    for ch, p0 in zip(chunks, np.cumsum([0] + [len(c.rows)
                                               for c in chunks])):
        assert ch.p0 == p0
        (ncomp, nparam, _, _), _, slot_dim, comps = _table(ch.flat)
        assert nparam == len(ch.rows)
        comp_ids = [c for c, k in ch.rows[:ncomp]]
        assert [k for _, k in ch.rows[:ncomp]] == ["raw_os"] * ncomp
        seen = set()
        for c, facs in enumerate(comps[:ncomp]):
            comp = spec.components[comp_ids[c]]
            rbf = [(i, f) for i, f in enumerate(comp.factors)
                   if f.kind == "rbf"]
            got = [(par, dim, slot) for kind, dim, u, num, par, slot in facs
                   if kind == fusion.GP_KINDS["rbf"]]
            assert len(got) == len(rbf)
            for (i, f), (par, dim, slot) in zip(rbf, got):
                assert ch.rows[par] == (comp_ids[c], f"raw_ls_{i}")
                assert dim == f.dim and slot_dim[slot] == f.dim
                seen.add(par)
            others = sorted((fusion.GP_KINDS[f.kind], f.dim, f.num)
                            for f in comp.factors if f.kind != "rbf")
            assert sorted((k, d, n) for k, d, u, n, p, s in facs
                          if k != fusion.GP_KINDS["rbf"]) == others
        assert seen == set(range(ncomp, nparam))


def _geo(L, S, N1, N2, Q=6, x2s=0, masks=0):
    return fusion._GpGeo(L, S, N1, N2, Q, 0, 0, 0, x2s, masks,
                         (L, S, N1, N2))


# the canonical matrices ([L, S, N1, N2], x2 batched over the subjects,
# masks) and shapes off them: N2 without 16-byte vectors, below a warp,
# beyond a tile's GP_COLS, many subjects of a short row each
GEOS = {"K0xz": _geo(32, 20, 20, 120, masks=1),
        "K0zz": _geo(32, 1, 120, 120),
        "K_st": _geo(32, 20, 20, 20, x2s=120, masks=2),
        "ragged": _geo(3, 7, 13, 37, x2s=78, masks=2),
        "T = 500": _geo(32, 2, 500, 500, x2s=3000, masks=2),
        "wide": _geo(2, 3, 5, 3000, masks=3),
        "short rows": _geo(4, 256, 3, 3, x2s=18, masks=2)}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", list(GEOS))
def test_gp_flat_plan_covers_every_entry_once(name, itemsize):
    """The flat kernels' tiles: whole 16-byte vectors where N2 holds them
    (else one entry), tiles of whole vectors within GP_COLS whose grid
    covers every entry of the matrix once, the shared bytes within
    GP_SMEM, every block's subjects within those it stages, the scratch a
    block and the counters a latent."""
    geo = GEOS[name]
    ndim = 4
    p = fusion.gp_flat_plan(geo, ndim, itemsize)
    R = geo.S * geo.N1
    assert p.vec == (16 // itemsize if geo.N2 % (16 // itemsize)
                                == 0 else 1)
    assert p.cols % p.vec == 0 and p.cols <= fusion.GP_COLS
    assert p.grid == (-(-R // p.rows), -(-geo.N2 // p.cols), geo.L)
    hits = np.zeros((R, geo.N2), dtype=np.int64)
    for bx in range(p.grid[0]):
        for by in range(p.grid[1]):
            hits[bx * p.rows:(bx + 1) * p.rows,
                 by * p.cols:(by + 1) * p.cols] += 1
    assert (hits == 1).all()
    nsub = fusion._gp_nsub(geo, p.rows)
    assert fusion._gp_smem(itemsize, ndim, p.rows, p.cols,
                           nsub) <= fusion.GP_SMEM
    for bx in range(p.grid[0]):
        r0 = bx * p.rows
        nr = min(p.rows, R - r0)
        span = (r0 + nr - 1) // geo.N1 - r0 // geo.N1 + 1
        # a block stages every subject it touches where x2 or the column
        # mask differs by subject, else the one they share
        assert span <= nsub or not (geo.x2s or geo.masks >= 2)
    assert p.tpart == p.grid[0] * p.grid[1] * geo.L * fusion.GP_MAX["params"]
    assert p.counters == geo.L and p.part == 0


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", ["K0xz", "K0zz", "ragged", "T = 500"])
def test_gp_cols_plan_chunks_and_scratch(name, itemsize, sym):
    """The column kernel's chunks: a multiple of GP_TY rows that cover the
    rows, as many as two blocks an SM take in one wave (the canonical
    K0xz: 2 chunks of 200 rows), x2's partials only over several chunks (a
    chunk, column of the tiles and slot), the parameters' a block, a
    counter a latent, the transposed tile's shared bytes where sym."""
    geo = GEOS[name]
    if sym:
        geo = geo._replace(S=1, N2=geo.N1, x2s=0, masks=0)
    p = fusion.gp_cols_plan(geo, 4, itemsize, sym=sym)
    R, tiles = geo.S * geo.N1, -(-geo.N2 // fusion.GP_TX)
    nchunks = p.grid[1]
    assert p.cols == fusion.GP_TX and p.vec == 1
    assert p.rows % fusion.GP_TY == 0 and (nchunks - 1) * p.rows < R
    assert nchunks * p.rows >= R and p.grid == (tiles, nchunks, geo.L)
    assert fusion._gp_smem(itemsize, 4, p.rows, fusion.GP_TX, 1,
                           sym) <= fusion.GP_SMEM
    assert p.part == (geo.L * nchunks * tiles * fusion.GP_TX
                      * fusion.GP_MAX["slots"] if nchunks > 1 else 0)
    assert p.tpart == geo.L * tiles * nchunks * fusion.GP_MAX["params"]
    assert p.counters == geo.L
    if name == "K0xz" and not sym:
        assert (nchunks, p.rows) == (2, 200)
    want = max(1, min(2 * fusion.GP_SMS // (geo.L * tiles),
                      -(-R // fusion.GP_TY)))
    rows = -(-(-(-R // want)) // fusion.GP_TY) * fusion.GP_TY
    if fusion._gp_smem(itemsize, 4, rows, fusion.GP_TX, 1,
                       sym) <= fusion.GP_SMEM:
        assert p.rows == rows
    else:       # shorter chunks, for the shared bytes
        assert p.rows < rows
    folded = fusion.gp_cols_plan(geo._replace(S=1), 4, itemsize,
                                 fold=geo.S, dtheta=False)
    assert folded.grid[2] == geo.L * geo.S and folded.tpart == 0


def test_gp_counters_are_shared_and_outgrown_ones_kept():
    """One zeroed counter buffer a (device, stream) for every backward
    launch on that stream; another stream gets its own; a larger need makes
    a new one and keeps the old alive (a captured graph holds its
    address)."""
    dev = torch.device("cpu")
    keys = [(dev.index, 1), (dev.index, 2)]
    for k in keys:
        fusion._STREAM_COUNTERS.pop(k, None)
    a = fusion._stream_counters(dev, 1, 10)
    assert a.dtype == torch.int32 and not a.any()
    assert fusion._stream_counters(dev, 1, 100) is a
    other = fusion._stream_counters(dev, 2, 10)
    assert other is not a and not other.any()
    b = fusion._stream_counters(dev, 1, a.numel() + 1)
    assert b is not a and b.numel() > a.numel()
    assert fusion._STREAM_COUNTERS[keys[0]] == [a, b]
    assert fusion._STREAM_COUNTERS[keys[1]] == [other]
    for k in keys:
        fusion._STREAM_COUNTERS.pop(k)
