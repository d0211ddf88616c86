"""``chip_smoke.region_table`` and ``gp_rows`` on a profile's events: each
device kernel counted once, by the launch call that shares its
correlation id, in the region of the host operation, autograd node or
range around that call.  The events are stand-ins for ``torch.profiler``'s
(the fields the table reads), so no card is needed.  Also the pullback's
bound (``chip_smoke._bwd_flops``) against a count of its products' nonzero
terms.  No JAX."""
import pathlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = str(pathlib.Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


class _Span:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


def _event(name, device, id_, parent=None, span=(0, 1), seq=-1,
           annotation=False, kernels=()):
    return SimpleNamespace(name=name, device_type=f"DeviceType.{device}",
                           id=id_, cpu_parent=parent, time_range=_Span(*span),
                           sequence_nr=seq, is_user_annotation=annotation,
                           kernels=list(kernels))


def _profile():
    """gp_bound's forward: a matmul whose kernel its op and an enclosing op
    both list, and a ctypes launch in the range with no op around it; the
    matmul's backward node; a graph replay's kernel, whose id a
    synchronization in the range also carries; a kernel whose launch call
    the profile lacks; a kernel and a launch call in the range without a
    correlation id (0)."""
    bound = _event("gp_bound", "CPU", 1, span=(0, 100), annotation=True)
    matmul = _event("aten::matmul", "CPU", 4, parent=bound, span=(9, 21),
                    seq=7, kernels=["gemm"])
    mm = _event("aten::mm", "CPU", 5, parent=matmul, span=(10, 20),
                kernels=["gemm"])
    launch = _event("cudaLaunchKernel", "CPU", 77, parent=mm, span=(11, 12))
    gemm = _event("gemm", "CUDA", 77, span=(30, 33))
    ctypes_launch = _event("cudaLaunchKernelExC", "CPU", 78, parent=bound,
                           span=(40, 41))
    metric = _event("metric", "CUDA", 78, span=(50, 52))
    node = _event("autograd::engine::evaluate_function: MmBackward0", "CPU",
                  90, span=(200, 300), seq=7)
    mm_bwd = _event("aten::mm", "CPU", 91, parent=node, span=(210, 220),
                    kernels=["gemm"])
    cu_launch = _event("cuLaunchKernel", "CPU", 80, parent=mm_bwd,
                    span=(211, 212))
    gemm_bwd = _event("gemm", "CUDA", 80, span=(230, 234))
    replay = _event("cudaGraphLaunch", "CPU", 81, span=(400, 401))
    replayed = _event("gemm", "CUDA", 81, span=(410, 413))
    sync = _event("cudaStreamSynchronize", "CPU", 81, parent=bound,
                  span=(60, 61))
    lost = _event("lost", "CUDA", 82, span=(500, 501))
    no_id_launch = _event("cudaLaunchKernel", "CPU", 0, parent=bound,
                          span=(70, 71))
    no_id = _event("no_id", "CUDA", 0, span=(600, 601))
    events = [bound, matmul, mm, launch, gemm, ctypes_launch, metric, sync,
              no_id_launch, node, mm_bwd, cu_launch, gemm_bwd, replay,
              replayed, lost, no_id]
    return SimpleNamespace(events=lambda: events)


def test_each_kernel_counted_once_in_its_region():
    table = chip_smoke.region_table(_profile())
    assert table == {"gemm": {"gp_bound": [1, 3.0],
                              "backward of gp_bound": [1, 4.0]},
                     "metric": {"gp_bound": [1, 2.0]}}


def test_gp_rows_read_the_table_as_it_is():
    """A region's launches and time are the table's; the last field is the
    name's launches in the whole profile."""
    by_name = {"gemm": [3, 10.0], "metric": [1, 2.0], "lost": [1, 1.0]}
    rows = chip_smoke.gp_rows(by_name, chip_smoke.region_table(_profile()), 1)
    assert rows == {"gp_bound": [("gemm", 1.0, 0.003, 3.0),
                                 ("metric", 1.0, 0.002, 1.0)],
                    "backward of gp_bound": [("gemm", 1.0, 0.004, 3.0)]}


@pytest.mark.parametrize("n", [25, 30, 100, 120, 125, 128])
def test_bwd_bound_counts_the_triangular_terms(n):
    """The pullback's flops: the terms of each product that lower-triangular
    L and L^-1 (T) and dense cotangents (D) leave, for the entries the next
    step reads (S, the fold, P and Y lower, X whole), 2 flops a term."""
    t = np.tril(np.ones((n, n), np.int64))
    d = np.ones((n, n), np.int64)
    lower = t.astype(bool)
    terms = ((t.T @ d)[lower].sum()       # S = L^-T iLb
             + (t @ t.T)[lower].sum()     # tril(S L^-T), S lower
             + (t.T @ t)[lower].sum()     # P = Phi(L^T Lb2), Lb2 lower
             + (t @ t)[lower].sum()       # Y = P L^-1
             + (t.T @ t).sum())           # X = L^-T Y, all of it
    assert chip_smoke._bwd_flops(n) == 2 * terms
