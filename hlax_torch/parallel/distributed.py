"""Process groups for mesh training (port of ``hlax/parallel/distributed.py``).

``initialize`` joins a ``torch.distributed`` process group: from its
arguments, or from a ``torchrun``-style environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  ``spawn`` starts the
ranks of a run on this host itself: one process a rank, started with the
``spawn`` method, on a free ``tcp://localhost`` port; when one rank fails,
or a time limit passes, the others are killed.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device=None) -> bool:
    """Join the process group; returns whether one is initialized.

    Does nothing when a group already exists (a second call is harmless,
    the fault ``tests/test_distributed.py`` records for hlax's version) or
    when neither the arguments nor the environment name more than one
    process.  The backend defaults to NCCL for a CUDA ``device`` and gloo
    for the CPU; a caller may name it (gloo for several ranks on one
    card, which NCCL refuses).  A CUDA rank sets its device before calling.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if not world_size or world_size <= 1:
        return False
    if init_method is None and "MASTER_ADDR" not in env:
        raise RuntimeError(
            f"{world_size} processes and no address to meet at: pass "
            "init_method or set MASTER_ADDR and MASTER_PORT")
    if backend is None:
        dev = torch.device(device or "cuda")
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world_size: int, init_method: str,
               out_dir: str, args: tuple) -> None:
    result = fn(rank, world_size, init_method, *args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, world_size: int, args: tuple = (),
          timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(rank, world_size, init_method, *args)`` in ``world_size``
    new processes (the ``spawn`` start method) and return each rank's
    result, in rank order.  ``fn`` is a module-level function (it is sent
    by name) that calls ``initialize`` with the ``init_method`` it is
    given; its result must pickle.  When a rank raises, the others are
    killed and the error is raised here; so are they all, with a
    ``TimeoutError``, when they have not finished within ``timeout``
    seconds.  A rank dies with this process."""
    import time

    import torch.multiprocessing as mp

    init_method = f"tcp://localhost:{free_port()}"
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(fn, world_size, init_method, out_dir, args))
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=5.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} "
                                   f"did not finish in {timeout} s")
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
