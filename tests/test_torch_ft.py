"""Fault tolerance through the port: the twins of ``tests/test_ft.py``, run
through ``repro_torch.runtime_ft`` and ``repro_torch.core``, and the port
against the reference on the same seeds."""
import pytest

import repro.core as jcore
import repro.runtime_ft as jft
import repro_torch.core as tcore
import repro_torch.runtime_ft as tft
from repro_torch.core import (BIG, LITTLE, Simulator, fleet, hikey960,
                              make_policy, random_dag)
from repro_torch.runtime_ft import ElasticFleet, FleetEvent, StragglerDetector


def test_straggler_detector_flags_slow_worker():
    spec = fleet(n_big_groups=16, n_little_groups=0)
    sim = Simulator(spec, make_policy("homogeneous"), seed=0)
    sim.set_speed_multiplier(5, 0.2)   # worker 5 runs 5x slow
    dag = random_dag(n_tasks=400, target_degree=8.0, seed=0)
    sim.run(dag)
    det = StragglerDetector(sim.core.ptt, ratio_threshold=2.0)
    reports = det.scan(width=1)
    assert any(r.worker == 5 for r in reports), "straggler not detected"
    assert all(r.worker == 5 for r in reports), "false positives"
    assert 5 not in det.healthy_workers(width=1)


def test_no_false_positives_on_healthy_fleet():
    spec = fleet(n_big_groups=16, n_little_groups=0)
    sim = Simulator(spec, make_policy("homogeneous"), seed=1)
    dag = random_dag(n_tasks=400, target_degree=8.0, seed=1)
    sim.run(dag)
    det = StragglerDetector(sim.core.ptt)
    assert det.scan(width=1) == []


def test_dag_completes_with_failed_workers():
    spec = hikey960()
    sim = Simulator(spec, make_policy("molding:weight"), seed=2)
    sim.fail_worker(2)
    sim.fail_worker(6)
    dag = random_dag(n_tasks=200, target_degree=3.0, seed=2)
    res = sim.run(dag)
    assert res.completed == 200
    for rec in res.trace:
        assert 2 not in rec.participants
        assert 6 not in rec.participants


def test_elastic_fleet_death_and_remesh():
    events = []
    fl = ElasticFleet(n_groups=16, model_parallel=4, grace=10.0,
                      on_event=lambda e, info: events.append(e))
    for g in range(16):
        fl.observe(g, now=0.0)
    for g in range(16):
        if g not in (5, 6):
            fl.observe(g, now=20.0)
    dead = fl.tick(now=25.0)
    assert set(dead) == {5, 6}
    plan = fl.plan_mesh()
    assert plan.model == 4
    assert plan.data == 2
    assert 5 not in plan.groups and 6 not in plan.groups
    assert FleetEvent.DEAD in events and FleetEvent.REMESH in events


def test_elastic_fleet_rejoin():
    fl = ElasticFleet(n_groups=8, model_parallel=2, grace=5.0)
    for g in range(8):
        fl.observe(g, 0.0)
    fl.tick(10.0)
    assert fl.alive_groups() == []
    fl.observe(3, 11.0)
    assert fl.alive_groups() == [3]


def test_demoted_groups_become_little_class():
    fl = ElasticFleet(n_groups=4, model_parallel=1)
    for g in range(4):
        fl.observe(g, 0.0)
    fl.demote(2)
    spec = fl.cluster_spec()
    assert spec.classes[2] == LITTLE
    assert spec.classes[0] == BIG


def test_no_intact_block_raises():
    fl = ElasticFleet(n_groups=4, model_parallel=4)
    for g in range(4):
        fl.observe(g, 0.0)
    fl.state[1].alive = False
    with pytest.raises(RuntimeError):
        fl.plan_mesh()


def test_ptt_to_demotion_pipeline():
    spec = fleet(n_big_groups=8, n_little_groups=0)
    sim = Simulator(spec, make_policy("homogeneous"), seed=3)
    sim.set_speed_multiplier(1, 0.15)
    sim.run(random_dag(n_tasks=300, target_degree=8.0, seed=3))
    det = StragglerDetector(sim.core.ptt)
    fl = ElasticFleet(n_groups=8, model_parallel=1)
    for g in range(8):
        fl.observe(g, 0.0)
    for r in det.scan(width=1):
        fl.demote(r.worker)
    spec2 = fl.cluster_spec()
    assert spec2.classes[1] == LITTLE
    assert sum(1 for c in spec2.classes if c == LITTLE) == 1


# ------------------------------------------------- the port vs the reference
def _reports(core, ft, seed: int, slow: dict, width):
    sim = core.Simulator(core.fleet(n_big_groups=16, n_little_groups=0),
                         core.make_policy("homogeneous"), seed=seed)
    for worker, speed in slow.items():
        sim.set_speed_multiplier(worker, speed)
    sim.run(core.random_dag(n_tasks=400, target_degree=8.0, seed=seed))
    det = ft.StragglerDetector(sim.core.ptt, ratio_threshold=2.0)
    return ([vars(r) for r in det.scan(width=width)],
            sorted(det.healthy_workers(width=width)))


@pytest.mark.parametrize("seed,slow,width", [
    (0, {5: 0.2}, 1), (1, {}, 1), (4, {3: 0.25, 11: 0.3}, None)])
def test_straggler_reports_equal_the_reference(seed, slow, width):
    got = _reports(tcore, tft, seed, slow, width)
    assert got == _reports(jcore, jft, seed, slow, width)
    assert {r["worker"] for r in got[0]} <= set(slow)


@pytest.mark.parametrize("n_groups,mp,silent", [
    (16, 4, (5, 6)), (32, 2, (0, 7, 8, 30)), (8, 1, ())])
def test_mesh_plan_equals_the_reference(n_groups, mp, silent):
    def plan(ft):
        events = []
        fl = ft.ElasticFleet(n_groups=n_groups, model_parallel=mp,
                             grace=10.0,
                             on_event=lambda e, info: events.append(
                                 (e.value, sorted(info.items()))))
        for g in range(n_groups):
            fl.observe(g, 0.0)
        for g in range(n_groups):
            if g not in silent:
                fl.observe(g, 20.0)
        dead = fl.tick(25.0)
        p = fl.plan_mesh()
        return dead, (p.data, p.model, p.groups, p.n_groups), events

    assert plan(tft) == plan(jft)
