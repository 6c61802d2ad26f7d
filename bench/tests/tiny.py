"""The benchmark's cells, cut to a size that a CPU test run holds, run by
their drivers on the CPU (the kernels' plain versions), past the harness's
look for a card."""
from __future__ import annotations

import copy
import time

import torch

from bench.harness import main as M

TINY_DAG = {"matmul": {"shape": [128, 128], "dtype": "bfloat16"},
            "sort": {"shape": [8, 64], "dtype": "float32"},
            "copy": {"shape": [256, 16], "dtype": "float32"}}


def files(workload: str):
    """(cell, config, mix) of ``workload`` at its own size."""
    return M.cell_files(M.benchmark(), workload)


def cell(workload: str):
    """(cell, config, mix) of ``workload`` at a CPU test's size."""
    cell, config, mix = files(workload)
    config = copy.deepcopy(config)
    config["operands"] = copy.deepcopy(TINY_DAG)
    mix = dict(mix, n_tasks=24, warm_tasks=12, drain_s=30,
               trace_seconds=0.3)
    return cell, config, mix


def run(workload: str, seed: int = 2 ** 40 + 3, seconds: float = 0.6,
        trace: bool = False, control: bool = False) -> dict:
    """One run of ``workload`` at a CPU test's size: its observations."""
    c, config, mix = cell(workload)
    r = M.Run(c, config, mix, seed, seconds, trace, torch.device("cpu"),
              time.perf_counter(), control=control)
    return M.driver(config["driver"]).run(r)
