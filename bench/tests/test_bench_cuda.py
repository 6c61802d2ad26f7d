"""On the card, at each cell's own sizes: three seeds of a short window,
where the program's answers pass their limits and the control's (the plain
reference one precision lower, in the program's place) fail one at least.

    PYTHONPATH=src python -m pytest -q -m cuda bench/tests/test_bench_cuda.py
"""
from __future__ import annotations

import time

import pytest

from bench.harness import main as M
from bench.tests import tiny

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    M.cache_dirs()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["dag-d1.62", "dag-d8.06"])
def test_program_passes_and_control_fails(card, workload):
    cell, config, mix = tiny.files(workload)
    for seed in SEEDS:
        run = M.Run(cell, config, mix, seed, 5.0, False, card,
                    time.perf_counter(), control=True)
        obs = M.driver(config["driver"]).run(run)
        assert M.judge(obs["checks"]), (seed, obs["checks"])
        assert not M.judge(obs["control_checks"]), (seed,
                                                     obs["control_checks"])
