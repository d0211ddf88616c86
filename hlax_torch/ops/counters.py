"""Launch counters of the port's hand-written kernels.

Each kernel module keeps one ``Counters``: its kernel launches and its
plain versions' calls on CUDA tensors since the last ``reset``, and the
launches by input shape and dtype, so a run can show which path it took.
A wrapper counts when it launches; under a CUDA graph that is once, at
capture, and the graph's runner takes the captured counts back out
(``take_all_since``) and adds them at each replay (``add_all``).
"""

from __future__ import annotations

import importlib
from typing import Dict, Iterable, List, Tuple

import torch


class Counters:
    """The counters of one kernel module: ``launches`` {kernel: n},
    ``by_shape`` {(kernel, shape, dtype name): n} and ``plain`` {plain
    version: calls on CUDA tensors}, dicts whose identity never changes."""

    def __init__(self, launches: Iterable[str], plain: Iterable[str]):
        self.launches: Dict[str, int] = dict.fromkeys(launches, 0)
        self.by_shape: Dict[Tuple[str, Tuple[int, ...], str], int] = {}
        self.plain: Dict[str, int] = dict.fromkeys(plain, 0)
        _ALL.append(self)

    def _dicts(self):
        return self.launches, self.by_shape, self.plain

    def reset(self) -> None:
        for d in (self.launches, self.plain):
            for k in d:
                d[k] = 0
        self.by_shape.clear()

    def snapshot(self):
        """The three counters as they stand, for ``take_since``."""
        return tuple(dict(d) for d in self._dicts())

    def take_since(self, before):
        """What the counters gained since the snapshot ``before``, taken
        back out of them: the launches a CUDA graph's capture recorded,
        which ran nothing.  ``add`` adds them back for each replay."""
        gained = tuple({k: v - b.get(k, 0) for k, v in now.items()
                        if v != b.get(k, 0)}
                       for now, b in zip(self.snapshot(), before))
        for d, b in zip(self._dicts(), before):
            d.clear()
            d.update(b)
        return gained

    def add(self, gained, times: int = 1) -> None:
        """Add ``times`` times the counts ``take_since`` returned."""
        for d, g in zip(self._dicts(), gained):
            for k, v in g.items():
                d[k] = d.get(k, 0) + v * times

    def count(self, name: str, t: torch.Tensor) -> None:
        """One launch of kernel ``name`` on an input like ``t``."""
        self.launches[name] += 1
        key = (name, tuple(t.shape), str(t.dtype).removeprefix("torch."))
        self.by_shape[key] = self.by_shape.get(key, 0) + 1


# every module's counters, in import order
_ALL: List[Counters] = []
# the modules of the port's kernels (hlax_torch.ops.<name>), a Counters each
KERNEL_MODULES = ("linalg_small", "fusion", "gp_bound", "natgrad")


def snapshot_all():
    return [c.snapshot() for c in _ALL]


def take_all_since(before):
    return [c.take_since(b) for c, b in zip(_ALL, before)]


def add_all(gained, times: int = 1) -> None:
    for c, g in zip(_ALL, gained):
        c.add(g, times)


def _every_module() -> List[Counters]:
    """The counters of every kernel module (KERNEL_MODULES, imported)."""
    for name in KERNEL_MODULES:
        importlib.import_module(f"hlax_torch.ops.{name}")
    return _ALL


def reset_every() -> None:
    """Every kernel module's counters set to 0."""
    for c in _every_module():
        c.reset()


def read_every():
    """(launches, launches by shape, plain-version calls on CUDA tensors)
    of every kernel module, each one dict."""
    return tuple({k: v for d in ds for k, v in d.items()}
                 for ds in zip(*(c._dicts() for c in _every_module())))
