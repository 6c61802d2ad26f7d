"""The traffic generators repeat exactly for one seed and differ for
another."""
from __future__ import annotations

import math

import pytest

from bench.harness import traffic

BIG = 2 ** 40 + 12345


def _edges(dag):
    return [(t.type, tuple(sorted(c.id for c in t.children)))
            for t in dag.nodes]


@pytest.mark.parametrize("degree", [1.62, 8.06])
def test_closed_dag_repeats_for_a_seed(degree):
    mix = {"n_tasks": 300, "warm_tasks": 30, "degree": degree}
    a, b = traffic.closed_dag(mix, BIG), traffic.closed_dag(mix, BIG)
    assert _edges(a(0)) == _edges(b(0))
    assert _edges(a("warm")) == _edges(b("warm"))
    assert len(a("warm")) == 30
    assert _edges(a(0)) != _edges(a(1))
    assert _edges(a(0)) != _edges(traffic.closed_dag(mix, BIG + 1)(0))


@pytest.mark.parametrize("degree", [1.62, 3.03, 8.06])
def test_closed_dag_is_the_papers(degree):
    """3000 TAOs, a third of each class, at the degree asked for: TAOs over
    the critical path within 1% of it, on every seed."""
    for seed in (7, BIG):
        dag = traffic.closed_dag({"n_tasks": 3000, "degree": degree},
                                 seed)(0)
        assert len(dag) == 3000
        assert sorted(t.type for t in dag.nodes).count("matmul") == 1000
        dag.validate()
        achieved = len(dag) / dag.critical_path_length()
        assert abs(achieved - degree) < 0.01 * degree, (seed, achieved)


@pytest.mark.parametrize("n_tasks", [24, 300, 3000])
@pytest.mark.parametrize("degree", [1.0, 1.62, 8.06])
def test_layer_widths_are_the_degree_on_every_seed(n_tasks, degree):
    widths = traffic.layer_widths(n_tasks, degree)
    assert sum(widths) == n_tasks and min(widths) >= 1
    assert len(widths) == max(1, round(n_tasks / degree))
    assert max(widths) <= max(1, math.ceil(2 * degree - 1))
    # the seed orders the same widths
    layers = []
    for seed in (BIG, BIG + 1):
        dag = traffic.random_dag(n_tasks, degree, seed)
        depth = {}
        for t in dag.topological():
            depth[t.id] = 1 + max((depth[p.id] for p in t.parents),
                                  default=0)
        got = [0] * max(depth.values())
        for d in depth.values():
            got[d - 1] += 1
        assert sorted(got) == widths
        layers.append(got)
    assert n_tasks == 24 or degree == 1.0 or layers[0] != layers[1]


def test_sub_seeds_are_streams_of_their_own():
    assert traffic.sub_seed(1, "a") == traffic.sub_seed(1, "a")
    assert traffic.sub_seed(1, "a") != traffic.sub_seed(1, "b")
    assert traffic.sub_seed(1, "a") != traffic.sub_seed(2, "a")
    assert 0 <= traffic.sub_seed(2 ** 70, "a") < 2 ** 63
