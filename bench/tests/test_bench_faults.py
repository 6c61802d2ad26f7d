"""A run whose timed path is broken underneath comes out not correct: a
cell, driven past the harness's look for a card at a CPU test's size, once
for each fault it can have.  One chip, so no exchange between chips to
leave out.  The control (the reference one precision lower, in the
program's place) fails the limits too."""
from __future__ import annotations

import pytest
import torch

from bench.harness import main as M
from bench.tests import tiny

DAG = "dag-d8.06"


@pytest.mark.parametrize("workload", [DAG, "dag-d1.62"])
def test_a_sound_run_is_correct(workload):
    obs = tiny.run(workload, control=True)
    assert M.judge(obs["checks"]), obs["checks"]
    assert all(v[0] < float("inf") for v in obs["checks"].values())
    # one sampled chunk of each class a DAG, several DAGs
    assert obs["dags"] >= 2
    assert obs["kept"] == {"matmul": obs["dags"], "sort": obs["dags"],
                           "copy": obs["dags"]}
    assert obs["attempted"] > 0 and obs["failed"] == 0
    # the control fails one of the cell's numbers at least
    assert not M.judge(obs["control_checks"]), obs["control_checks"]
    assert obs["setup"]["built"] is False     # plain kernels on the CPU
    assert obs["setup_s"] >= obs["setup"]["warm_s"] > 0


def _altered(fn, where):
    def broken(*a, **kw):
        out = fn(*a, **kw).clone()
        out.view(-1)[where] += 1.0 + out.view(-1)[where].abs()
        return out
    return broken


@pytest.mark.parametrize("cls", ["matmul", "sort", "copy"])
def test_dag_answer_altered_where_produced(monkeypatch, cls):
    from repro_torch import mixed_mode
    monkeypatch.setitem(mixed_mode.CHUNK_OPS, cls,
                        _altered(mixed_mode.CHUNK_OPS[cls], 5))
    assert not M.judge(tiny.run(DAG)["checks"])


@pytest.mark.parametrize("cls", ["sort", "copy"])
def test_dag_chunk_returns_its_operand(monkeypatch, cls):
    """A sort or a copy that hands back its input, not a new answer."""
    from repro_torch import mixed_mode
    monkeypatch.setitem(mixed_mode.CHUNK_OPS, cls, lambda x: x)
    checks = tiny.run(DAG)["checks"]
    assert checks["outputs_aliased"][0] > 0
    assert not M.judge(checks)


@pytest.mark.parametrize("cls", ["matmul", "sort", "copy"])
def test_dag_chunk_returns_a_stored_answer(monkeypatch, cls):
    """Each chunk of a class hands back the answer of the class's first
    chunk in the run, computed once."""
    from repro_torch import mixed_mode
    op, stored = mixed_mode.CHUNK_OPS[cls], []

    def once(x):
        if not stored:
            stored.append(op(x))
        return stored[0]
    monkeypatch.setitem(mixed_mode.CHUNK_OPS, cls, once)
    checks = tiny.run(DAG)["checks"]
    assert checks["outputs_aliased"][0] > 0
    assert checks[{"matmul": "matmul_err", "sort": "sort_mismatch",
                   "copy": "copy_mismatch"}[cls]][0] > 0
    assert not M.judge(checks)


def test_dag_half_the_chunks_left_out(monkeypatch):
    from repro_torch import mixed_mode
    bind = mixed_mode.bind_real_work

    def half(dag, operands, *, device, n_chunks, log=None):
        bind(dag, operands, device=device, n_chunks=n_chunks // 2, log=log)
    monkeypatch.setattr(mixed_mode, "bind_real_work", half)
    with pytest.raises(RuntimeError, match="warm-up DAG"):
        tiny.run(DAG)


def test_traced_runs_read_their_metrics():
    b = M.benchmark()
    obs = tiny.run(DAG, trace=True)
    got = M.read_metrics(M.metrics_for(b, DAG, True), obs)
    assert {"dag.mean_width", "dag.idle_leader_share"} <= set(got)
    assert obs["trace"].found and obs["trace"].window_s > 0
    assert M.judge(obs["checks"])
    assert torch.get_num_threads() > 0
