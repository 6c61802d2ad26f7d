"""The benchmark's FLOP and byte arithmetic against closed forms worked
by hand at the cells' shapes."""
from __future__ import annotations

import json

import pytest

from bench.harness import main as M
from bench.metrics import _counts as c


def test_peaks():
    assert c.PEAK_BF16_FLOPS == 989e12 and c.PEAK_HBM_BYTES == 3.35e12


def test_dag_bounds_at_the_cells_shapes():
    cfg = json.loads((M.BENCH / "configs/paper-dag.json").read_text())
    shape = {k: tuple(v["shape"]) for k, v in cfg["operands"].items()}
    assert shape == {"matmul": (8192, 8192), "sort": (16384, 8192),
                     "copy": (262144, 1024)}
    # x @ x of (8192, 8192): 2 * 8192**3 FLOP at 989e12 FLOP/s
    assert c.matmul_flops(8192, 8192, 8192) == 1099511627776.0
    assert c.dag_chunk_bound_s("matmul", (8192, 8192), "bfloat16") == \
        pytest.approx(1099511627776.0 / 989e12)
    assert c.dag_chunk_bound_s("matmul", (8192, 8192), "bfloat16") == \
        pytest.approx(1.112e-3, rel=1e-3)
    # 512 MiB read once and written once at 3.35e12 B/s
    assert c.dag_chunk_bound_s("sort", (16384, 8192), "float32") == \
        pytest.approx(2 * 512 * 2 ** 20 / 3.35e12)
    assert c.dag_chunk_bound_s("copy", (262144, 1024), "float32") == \
        pytest.approx(2 * 2 ** 30 / 3.35e12)
    assert c.dag_chunk_bound_s("copy", (262144, 1024), "float32") == \
        pytest.approx(0.641e-3, rel=1e-3)


class _Trace:
    """A traced window of given kernels, for the readers."""

    found = True

    def __init__(self, kernels, window_s=1.0, busy_s=0.5):
        self._k, self.window_s, self.busy_s = kernels, window_s, busy_s
        self.device = [1]

    def kernels(self, part):
        got = [v for k, v in self._k.items() if part in k]
        return (sum(n for n, _ in got), sum(s for _, s in got))


def test_dag_roofline_and_idle_readers():
    cfg = json.loads((M.BENCH / "configs/paper-dag.json").read_text())
    bound = c.dag_chunk_bound_s("matmul", (8192, 8192), "bfloat16")
    tr = _Trace({"wgmma_matmul_kernel<...>": (4, 4 * 2 * bound)})
    obs = {"trace": tr, "config": cfg}
    assert M.metric_module("dag.matmul_roofline").read(obs) == \
        pytest.approx(50.0)
    assert M.metric_module("dag.sort_roofline").read(obs) is None
    assert M.metric_module("dag.device_idle").read(obs) == \
        pytest.approx(50.0)
