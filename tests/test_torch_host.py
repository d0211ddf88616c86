"""Port's host-side data path against hlax: type layout, config dict, CSV
reader, generator, dataset and batches, and the on-device gather."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hlax import config as jconfig
from hlax import types as jtypes
from hlax.data import dataset as jds
from hlax.data import generate as jgen
from hlax.data import reader as jreader
from hlax_torch import config as tconfig
from hlax_torch import types as ttypes
from hlax_torch.data import dataset as tds
from hlax_torch.data import generate as tgen
from hlax_torch.data import reader as treader

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TYPES = [
    {"type": "real", "dim": 1, "nclass": 1},
    {"type": "cat", "dim": 1, "nclass": 3},
    {"type": "pos", "dim": 1, "nclass": 1},
    {"type": "cat", "dim": 1, "nclass": 3},
    {"type": "ordinal", "dim": 1, "nclass": 4},
    {"type": "count", "dim": 1, "nclass": 1},
    {"type": "real", "dim": 1, "nclass": 1},
    {"type": "beta", "dim": 1, "nclass": 1},
]


def _assert_same(a, b, what=""):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{what}.{f.name}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("logvar", [False, True])
def test_layout_matches_hlax(logvar):
    ranges = [(0.0, 5.0)]
    _assert_same(jtypes.compile_layout(TYPES, logvar, ranges),
                 ttypes.compile_layout(TYPES, logvar, ranges), "layout")


def test_canonical_config_parses_to_the_same_dict():
    f = os.path.join(ROOT, "configs", "hlvae_config_file.txt")
    want = jconfig.ModelArgs().parse_options([f"--f={f}"])
    got = tconfig.ModelArgs().parse_options([f"--f={f}"])
    for d in (want, got):
        d.pop("f")
    assert got == want


def test_encode_raw_matches_hlax():
    rng = np.random.default_rng(0)
    n = 30
    raw = np.column_stack([
        rng.normal(size=n), rng.integers(0, 3, n), rng.gamma(2, 2, n),
        rng.integers(2, 5, n), rng.integers(0, 4, n), rng.poisson(3, n),
        rng.normal(size=n), rng.uniform(0, 5, n)]).astype(float)
    raw[rng.random(raw.shape) < 0.1] = np.nan
    miss = (rng.random(raw.shape) > 0.2).astype(float)
    a = jreader.encode_raw(raw, TYPES, miss_mask=miss)
    b = treader.encode_raw(raw, TYPES, miss_mask=miss)
    for k in ("data", "mask", "true_mask", "theta_mask"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    d = tmp_path_factory.mktemp("d4")
    out_j = jgen.generate(num_3=2, num_6=2, datatype_config="D4", seed=5)
    out_t = tgen.generate(num_3=2, num_6=2, datatype_config="D4", seed=5)
    jgen.write_csvs(out_j, str(d / "j"), "D4")
    tgen.write_csvs(out_t, str(d / "t"), "D4")
    return d, out_j, out_t


def test_generator_matches_hlax(generated):
    d, out_j, out_t = generated
    for k in out_j:
        np.testing.assert_array_equal(out_j[k], out_t[k], k)
    assert jgen.types_table("D4") == tgen.types_table("D4")
    for name in sorted(os.listdir(d / "j")):
        assert (d / "j" / name).read_bytes() == (d / "t" / name).read_bytes()


def test_dataset_and_batches_match_hlax(generated):
    d, _, _ = generated
    args = (str(d / "t"), "data.csv", "labels.csv", "mask.csv",
            "data_types_D4.csv")
    a, b = jds.load_dataset(*args), tds.load_dataset(*args)
    for k in ("data", "mask", "true_mask", "theta_mask"):
        np.testing.assert_array_equal(getattr(a.het, k), getattr(b.het, k))
    for k in ("labels", "subject_ids", "subject_start", "subject_end"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert (a.T_max, a.P, len(a)) == (b.T_max, b.P, len(b))
    for ba, bb in zip(jds.subject_batches(a, 3, np.random.default_rng(1)),
                      tds.subject_batches(b, 3, np.random.default_rng(1))):
        assert ba.keys() == bb.keys()
        for k in ba:
            np.testing.assert_array_equal(ba[k], bb[k], k)
    ia = list(jds.epoch_subject_batches(a.P, 3, np.random.default_rng(2)))
    ib = list(tds.epoch_subject_batches(b.P, 3, np.random.default_rng(2)))
    np.testing.assert_array_equal(np.stack(ia), np.stack(ib))

    # on-device gather, a padding subject included
    sj = jds.stage_dataset(a, jnp.float64)
    st = tds.stage_dataset(b, torch.float64, "cpu")
    idx = np.array([2, -1, 0])
    ga = jds.gather_batch(sj, idx)
    gb = tds.gather_batch(st, torch.as_tensor(idx))
    for k in ga:
        np.testing.assert_array_equal(np.asarray(ga[k]), gb[k].numpy(), k)


def test_full_padded_and_n_batches_match_hlax(generated):
    d, _, _ = generated
    args = (str(d / "t"), "data.csv", "labels.csv", "mask.csv",
            "data_types_D4.csv")
    a, b = jds.load_dataset(*args), tds.load_dataset(*args)
    for t_max in (None, a.T_max + 3):
        fa, fb = jds.full_padded(a, t_max), tds.full_padded(b, t_max)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], k)
    for spb in (1, 3, 4, 20):
        assert jds.n_batches(a, spb) == tds.n_batches(b, spb)


def test_generate_cli_splits_match_hlax(tmp_path):
    """``--splits`` writes the canonical config's files, byte for byte as
    hlax's generator CLI does (seed + i for the i-th split)."""
    from hlax.cli import generate as jgen_cli
    from hlax_torch.cli import generate as tgen_cli

    argv = ["--num_3", "1", "--num_6", "1", "--datatype_config", "D4",
            "--seed", "9", "--splits", "prediction,test,validation"]
    jgen_cli.main(["--destination", str(tmp_path / "j"), *argv])
    tgen_cli.main(["--destination", str(tmp_path / "t"), *argv])
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert {"prediction_data_D4.csv", "test_label.csv", "validation_mask.csv",
            "data_types_D4.csv"} <= set(names)
    for name in names:
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes(), name
