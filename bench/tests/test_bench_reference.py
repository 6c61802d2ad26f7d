"""The plain references of bench/reference against the port's plain
versions at a smoke size, on the CPU."""
from __future__ import annotations

import pytest
import torch

from bench.harness import weights
from bench.reference import dag_ops
from bench.tests import tiny


@pytest.mark.parametrize("cls", ["matmul", "sort", "copy"])
def test_dag_ops_are_the_ports_plain_versions(cls):
    from repro_torch import mixed_mode
    from repro_torch.kernels import ops

    spec = tiny.TINY_DAG[cls]
    x = weights.normal(spec["shape"], spec["dtype"], 3, "cpu")
    with torch.inference_mode():
        got = {"matmul": lambda: ops.matmul(x, x, force="ref"),
               "sort": lambda: ops.sort_rows(x, force="ref"),
               "copy": lambda: ops.copy(x, force="ref")}[cls]()
    want = dag_ops.reference(cls, x)
    assert mixed_mode.DTYPES[cls] == x.dtype
    if cls == "matmul":
        # the bf16 product's rounding: under 2**-9 of its largest element
        assert dag_ops.error(cls, got, want) < 2 ** -6
        assert dag_ops.error(cls, dag_ops.control(cls, x), want) > 2 ** -4
    else:
        assert dag_ops.error(cls, got, want) == 0
        assert dag_ops.error(cls, dag_ops.control(cls, x), want) > 0
