"""The port imports without JAX and refers to nothing of the JAX package."""
import importlib
import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "hlax_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_with_jax_blocked():
    """``sys.modules["jax"] = None`` makes any ``import jax`` raise; every
    submodule of hlax_torch and chip_smoke.py must still import, and no
    module of hlax may be loaded along the way."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import hlax_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(hlax_torch.__path__,"
        " 'hlax_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'hlax' or m.startswith('hlax.')"
        " or m == 'flax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_refers_to_jax_or_hlax_modules(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax|hlax)\b", src,
                         re.M), path
    assert not re.search(r"\bhlax\.[A-Za-z_]", src), path


def test_tf32_is_off_after_import():
    import torch
    importlib.import_module("hlax_torch")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert len(list(pkgutil.walk_packages(
        importlib.import_module("hlax_torch").__path__))) > 0
