"""Shared fixtures.  NOTE: no XLA_FLAGS device-count forcing here — smoke
tests and benches must see the 1 real CPU device (the 512-device mesh is the
dry-run's private business)."""
import os
import sys

# keep test runs deterministic & quiet
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "perf: performance smoke tests (compare optimized vs baseline paths)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture(scope="session")
def rng_seed() -> int:
    return 0


# -- shared cross-vehicle serving helpers (locality invariant tests) --------
def serving_footprint_run(vehicle: str, kv_bytes_per_token: float,
                          charge: bool = True, seed: int = 1):
    """Run a small footprint-carrying serving trace on one vehicle.

    Returns ``(WorkloadResult, ClusterSpec, SchedulerCore)`` so invariant
    tests can check the tracker, the trace and the per-DAG stats together.
    The simulator leg uses the calibrated serve models; the threaded leg
    binds trivial sleep payloads (the invariants under test — conservation,
    hit/miss accounting, residency — are timing-free)."""
    import time as _time

    from repro.core import Simulator, ThreadedRuntime, hikey960, make_policy
    from repro.core.runtime import ChunkedWork
    from repro.core.serve_orchestrator import (build_serving_workload,
                                               bursty_serving_trace,
                                               serving_kernel_models)

    spec = hikey960()
    policy = make_policy("molding:weight")
    if vehicle == "sim":
        reqs = bursty_serving_trace(n_steady=6, n_burst=8, seed=seed)
        wl, by_dag = build_serving_workload(
            reqs, n_chunks=2, kv_bytes_per_token=kv_bytes_per_token)
        sim = Simulator(spec, policy,
                        kernel_models=serving_kernel_models(), seed=seed)
        sim.core.locality.charge = charge
        res = sim.run_workload(wl)
        return res, spec, sim.core
    if vehicle != "threaded":
        raise ValueError(f"unknown vehicle {vehicle!r}")

    def binder(tao, r):
        tao.work = ChunkedWork(lambda i: _time.sleep(0.0005), 1)

    reqs = bursty_serving_trace(
        n_steady=4, steady_rate=50.0, n_burst=5, burst_at=0.05,
        burst_rate=300.0, steady_prompts=(512,), steady_gens=(64, 128),
        burst_prompts=(1024,), burst_gens=(64,), seed=seed)
    wl, by_dag = build_serving_workload(
        reqs, bind=binder, kv_bytes_per_token=kv_bytes_per_token)
    rt = ThreadedRuntime(spec, policy, seed=seed)
    rt.core.locality.charge = charge
    res = rt.run_workload(wl, timeout_s=60.0)
    return res, spec, rt.core


def footprint_map(res, kv_bytes_per_token: float) -> dict:
    """``dag_id -> (nbytes, sticky)`` for :func:`replay_moved_bytes`, sized
    exactly as ``build_serving_workload`` sized the live footprints."""
    return {did: (st.tokens * kv_bytes_per_token, True)
            for did, st in res.per_dag.items()}
