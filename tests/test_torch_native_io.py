"""The port's native CSV parser and its plain-Python fallback against hlax's,
bit for bit, on the four inputs of tests/test_native_io.py; the library is
built under the repository's build/ directory."""
import os
import pathlib

import numpy as np
import pytest

from hlax.native import io as jio
from hlax_torch.data import reader as treader
from hlax_torch.native import io as tio
from hlax_torch.ops.cuda_build import BUILD_DIR

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _large_random_text():
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((200, 37))
    ref[rng.random(ref.shape) < 0.1] = np.nan
    return "\n".join(",".join("" if np.isnan(v) else f"{v:.17g}" for v in row)
                     for row in ref) + "\n"


INPUTS = {
    "blank_and_nan": "1.5,2,3\n4,,6\n7,nan,9e2\n",
    "header": "a,b,c\n1,2,3\n4,5,6\n",
    "large_random": _large_random_text(),
    "signs_and_exponents": "-1.25,+2.5,1e-3\n-1E+4,0.0,-0\n",
}


def _same_bits(a, b):
    assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_native_and_fallback_equal_hlax_bit_for_bit(tmp_path, name):
    path = tmp_path / f"{name}.csv"
    path.write_text(INPUTS[name])
    want = jio.read_csv_matrix(str(path))
    _same_bits(want, jio._numpy_fallback(str(path)))
    tio.reset_parses()
    got = tio.read_csv_matrix(str(path))
    assert tio.PARSES == {"native": 1, "fallback": 0}
    _same_bits(got, want)
    _same_bits(tio.python_fallback(str(path)), want)
    # the reader's entry point goes through the native parser
    _same_bits(treader._read_csv_matrix(str(path)), want)
    assert tio.PARSES["native"] == 2


def test_library_is_built_under_build_dir():
    assert tio.native_available()
    assert tio.LIB == BUILD_DIR / "libfastcsv.so"
    assert BUILD_DIR == ROOT / "build" and tio.LIB.is_file()
    assert not list((ROOT / "hlax_torch" / "native").glob("*.so"))


def test_rejected_file_takes_the_fallback(tmp_path):
    """A ragged file (return code 6 of the native parser) is read by the
    plain-Python parser, which raises as hlax's does."""
    path = tmp_path / "ragged.csv"
    path.write_text("1,2,3\n4,5\n")
    tio.reset_parses()
    with pytest.raises(ValueError):
        tio.read_csv_matrix(str(path))
    assert tio.PARSES == {"native": 0, "fallback": 1}
    with pytest.raises(ValueError):
        jio.read_csv_matrix(str(path))


def test_failed_build_is_printed_once_and_reported(tmp_path, monkeypatch,
                                                   capsys):
    """A source that does not compile: the compiler's error is printed
    once, ``native_available()`` is False and reads take the fallback."""
    bad = tmp_path / "fastcsv.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tio, "SRC", bad)
    monkeypatch.setattr(tio, "LIB", tmp_path / "build" / "libfastcsv.so")
    monkeypatch.setattr(tio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tio, "_lib", None)
    monkeypatch.setattr(tio, "_build_failed", False)
    assert not tio.native_available()
    assert not tio.native_available()
    printed = capsys.readouterr().out
    assert printed.count("hlax_torch: building") == 1 and "error" in printed
    csv_path = tmp_path / "m.csv"
    csv_path.write_text(INPUTS["blank_and_nan"])
    tio.reset_parses()
    _same_bits(tio.read_csv_matrix(str(csv_path)),
               jio._numpy_fallback(str(csv_path)))
    assert tio.PARSES == {"native": 0, "fallback": 1}
    assert not os.path.exists(tmp_path / "build" / "libfastcsv.so")
