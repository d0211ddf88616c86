"""A hang of the port's mesh is an error within a bounded time
(``hlax_torch/parallel/distributed.py``): ``initialize`` gives the process
group a timeout and binds an NCCL group to its card, a collective that one
gloo rank never joins raises within that timeout, and ``spawn`` kills ranks
that outlive their limit, or that of a failed rank, and returns within
``SPAWN_SLACK`` seconds of the kill.  Each test takes well under 15 s."""
import datetime
import os
import time

import pytest
import torch
import torch.distributed as dist

import torch_mesh_ranks as ranks
from hlax_torch.parallel import distributed as pdist


@pytest.fixture
def init_calls(monkeypatch):
    """``init_process_group``'s keyword arguments, call by call, without
    making a group."""
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    return calls


@pytest.mark.parametrize("kw,device_id,seconds", [
    ({"backend": "nccl", "device": "cuda:1", "timeout": 7.0},
     torch.device("cuda", 1), 7.0),
    ({"device": "cuda:3"}, torch.device("cuda", 3), pdist.DEFAULT_TIMEOUT),
    ({"backend": "gloo", "device": "cpu", "timeout": 2.5}, None, 2.5),
    ({"device": "cpu"}, None, pdist.DEFAULT_TIMEOUT)])
def test_initialize_passes_timeout_and_device_id(init_calls, kw, device_id,
                                                 seconds):
    """Every group gets the timeout (a few minutes unless the caller names
    one); an NCCL group is bound to the rank's card, a gloo group to
    none."""
    assert pdist.initialize(init_method="tcp://localhost:1", world_size=2,
                            rank=0, **kw)
    (call,) = init_calls
    assert call["timeout"] == datetime.timedelta(seconds=seconds)
    assert call.get("device_id") == device_id
    assert call["backend"] == ("gloo" if device_id is None else "nccl")
    assert 60 <= pdist.DEFAULT_TIMEOUT <= 600


def test_initialize_binds_nccl_to_local_rank(init_calls, monkeypatch):
    """Without a card index, an NCCL rank binds to ``LOCAL_RANK``'s card."""
    monkeypatch.setenv("LOCAL_RANK", "2")
    pdist.initialize("nccl", "tcp://localhost:1", 4, 2, device="cuda")
    assert init_calls[0]["device_id"] == torch.device("cuda", 2)


def test_unjoined_collective_raises_within_the_timeout(tmp_path):
    """Two gloo ranks with a 3 s timeout: rank 0's all-reduce, which rank 1
    never joins, raises within it."""
    timeout = 3.0
    got = pdist.spawn(ranks.unjoined_collective, 2, (str(tmp_path), timeout),
                      timeout=60)
    assert got[0]["raised"] is not None
    assert got[0]["seconds"] < timeout + 1.5


def _pids(tmp_path, n):
    out = []
    for r in range(n):
        path = tmp_path / f"pid{r}"
        if path.exists():
            out.append(int(path.read_text()))
    return out


def _dead(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_spawn_kills_ranks_past_their_limit(tmp_path):
    """Ranks that sleep for an hour: ``spawn`` raises ``TimeoutError``
    within its limit plus ``SPAWN_SLACK`` and leaves no live process."""
    limit = 4.0
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish in 4.0 s"):
        pdist.spawn(ranks.sleep_forever, 2, (str(tmp_path),), timeout=limit)
    assert time.monotonic() - t0 < limit + pdist.SPAWN_SLACK
    pids = _pids(tmp_path, 2)
    assert len(pids) == 2 and all(_dead(p) for p in pids)


def test_spawn_reports_a_failed_rank_and_kills_the_others(tmp_path):
    """Rank 1 raises while rank 0 sleeps: ``spawn`` raises at once with rank
    1's traceback, long before its limit, and rank 0 is dead."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        pdist.spawn(ranks.sleep_forever, 2, (str(tmp_path), 1), timeout=600)
    assert time.monotonic() - t0 < 30
    pids = _pids(tmp_path, 2)
    assert len(pids) == 2 and all(_dead(p) for p in pids)


def test_destroy_releases_the_graphs_before_the_group(monkeypatch):
    """NCCL destroys a communicator only once every CUDA graph that captured
    its collectives is gone, and waits for them without a limit:
    ``destroy`` drops every graph ``make_train_epoch`` captured before it
    leaves the group, and does nothing outside a group."""
    from hlax_torch.train import step as tstep

    graphs = tstep._EpochGraphs(None, 1, "thread_local")
    graphs.replays[(1, False)] = "a captured graph"
    left = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: left.append(dict(graphs.replays)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    pdist.destroy()
    assert left == [] and graphs.replays
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    pdist.destroy()
    assert left == [{}] and not graphs.replays
