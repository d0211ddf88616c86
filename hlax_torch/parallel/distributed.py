"""Process groups for mesh training (port of ``hlax/parallel/distributed.py``).

``initialize`` joins a ``torch.distributed`` process group: from its
arguments, or from a ``torchrun``-style environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  ``spawn`` starts the
ranks of a run on this host itself: one process a rank, started with the
``spawn`` method, on a free ``tcp://localhost`` port; when one rank fails,
or a time limit passes, the others are killed.

A hang is an error within a bounded time: a collective that does not
complete within ``initialize``'s ``timeout`` raises (gloo) or ends its
process (NCCL's watchdog), and ``spawn`` never waits more than
``SPAWN_SLACK`` seconds past its own limit, even for a rank that does not
die when it is killed.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
import time
from multiprocessing.connection import wait
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

# seconds a collective (and joining the group) may take before it fails
DEFAULT_TIMEOUT = 300.0
# seconds ``spawn`` waits for its ranks to exit after killing them
SPAWN_SLACK = 15.0


def _device_id(device) -> torch.device:
    """The card an NCCL rank binds its communicators to: ``device``'s index,
    else ``LOCAL_RANK``, else the current device."""
    dev = torch.device(device or "cuda")
    if dev.index is not None:
        return dev
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", torch.cuda.current_device())


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device=None,
               timeout: float = DEFAULT_TIMEOUT) -> bool:
    """Join the process group; returns whether one is initialized.

    Does nothing when a group already exists (a second call is harmless,
    the fault ``tests/test_distributed.py`` records for hlax's version) or
    when neither the arguments nor the environment name more than one
    process.  The backend defaults to NCCL for a CUDA ``device`` and gloo
    for the CPU; a caller may name it (gloo for several ranks on one
    card, which NCCL refuses).  A CUDA rank sets its device before calling.
    A collective that has not completed after ``timeout`` seconds fails.
    NCCL's group is bound to the rank's card (``device_id``), which makes
    its communicator now rather than at the first collective, which could
    be inside a CUDA graph's capture.
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
    extra = {"device_id": _device_id(device)} if backend == "nccl" else {}
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout),
                            **extra)
    return True


def destroy() -> None:
    """Leave the process group, if this process is in one.  First every
    CUDA graph that ``make_train_epoch`` captured here is destroyed:
    ``destroy_process_group`` waits, without a limit, for NCCL's
    communicators to be released by every graph holding their
    collectives."""
    from hlax_torch.train.step import release_graphs

    if not dist.is_initialized():
        return
    release_graphs()
    dist.destroy_process_group()


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


def _kill(processes) -> List[int]:
    """Kill every live process of ``processes`` and wait for them, at most
    SPAWN_SLACK seconds in all; returns the ranks still alive after it."""
    for p in processes:
        if p.is_alive():
            p.kill()
    end = time.monotonic() + SPAWN_SLACK
    for p in processes:
        p.join(max(0.0, end - time.monotonic()))
    return [r for r, p in enumerate(processes) if p.is_alive()]


def _wait(processes, timeout: Optional[float]) -> Optional[int]:
    """Wait until every process has exited (returns -1), one has failed
    (returns its rank) or ``timeout`` seconds have passed (returns
    None)."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        for r, p in enumerate(processes):
            if p.exitcode not in (None, 0):
                return r
        alive = [p for p in processes if p.exitcode is None]
        if not alive:
            return -1
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            return None
        wait([p.sentinel for p in alive],
             timeout=1.0 if left is None else min(1.0, left))


def _failure(error_file: str, p) -> str:
    """What a failed rank left: the traceback ``torch.multiprocessing``
    wrote for it into ``error_file``, else its exit code."""
    if os.path.isfile(error_file) and os.path.getsize(error_file):
        with open(error_file, "rb") as f:
            return pickle.load(f)
    return f"exit code {p.exitcode}"


def spawn(fn: Callable, world_size: int, args: tuple = (),
          timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(rank, world_size, init_method, *args)`` in ``world_size``
    new processes (the ``spawn`` start method) and return each rank's
    result, in rank order.  ``fn`` is a module-level function (it is sent
    by name) that calls ``initialize`` with the ``init_method`` it is
    given; its result must pickle.  When a rank fails, the others are
    killed and a ``RuntimeError`` with its traceback is raised here; when
    they have not all finished within ``timeout`` seconds, all are killed
    and a ``TimeoutError`` is raised.  Either way this returns within
    SPAWN_SLACK seconds of the kill, naming any rank that did not exit.
    An exception while it waits (an interrupt) kills every rank too."""
    import torch.multiprocessing as mp

    init_method = f"tcp://localhost:{free_port()}"
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(fn, world_size, init_method, out_dir, args))
        procs = ctx.processes
        try:
            failed = _wait(procs, timeout)
        except BaseException:        # an interrupt or an alarm: no orphans
            _kill(procs)
            raise
        if failed is None:
            stuck = _kill(procs)
            raise TimeoutError(
                f"{world_size} ranks of {fn.__name__} did not finish in "
                f"{timeout} s; killed"
                + (f", ranks {stuck} still alive {SPAWN_SLACK} s later"
                   if stuck else ""))
        if failed >= 0:
            stuck = _kill(procs)
            raise RuntimeError(
                f"rank {failed} of {world_size} ({fn.__name__}) failed"
                + (f"; ranks {stuck} did not exit when killed" if stuck
                   else "") + ":\n" + _failure(ctx.error_files[failed],
                                               procs[failed]))
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
