"""Schedule byte-identity fingerprints and the pinned reference configs.

The implementation-variant refactor (joint (impl, width, leader) placement)
must be *invisible* whenever every TAO carries a single variant: the policies
branch onto the exact legacy code path, draw the same RNG stream, and produce
the same schedule byte for byte.  This module is the shared contract for that
guarantee — a stable fingerprint over a simulator/runtime trace, the
canonical single-variant configurations, and their pinned signatures captured
on the pre-variant stack.  ``tests/test_impl_identity.py`` asserts the pins;
``benchmarks/run.py --workload impl`` and the CI smoke re-assert them so a
violation fails loudly (identity is deterministic — never a timing flake).

The fingerprint deliberately excludes ``TraceRecord.impl``: the field did not
exist on the pre-variant stack, and single-variant runs always record
``DEFAULT_IMPL`` there anyway.
"""
from __future__ import annotations

import hashlib


def trace_signature(trace) -> str:
    """Stable 16-hex-digit fingerprint of a schedule trace.

    Hashes the scheduling-visible fields of each :class:`TraceRecord`
    (identity, placement, timing, preemption segmentation) in trace order.
    Two runs agree on this iff they made identical decisions at identical
    (virtual or measured) times.
    """
    h = hashlib.sha256()
    for t in trace:
        h.update(repr((t.tao_id, t.type, t.leader, t.width, t.start, t.end,
                       t.participants, t.dag_id, t.preempted)).encode())
    return h.hexdigest()[:16]


# -- canonical single-variant configurations --------------------------------
# Captured on the pre-variant stack (PR 6).  Any change to these values means
# the refactor altered a legacy schedule — a correctness bug, not drift.
PINNED_SIGNATURES = {
    "dag.adaptive": "d2b4c965d7a49de5",
    "dag.crit-ptt": "297877d9732e45b8",
    "dag.homogeneous": "90005c6279791de7",
    "dag.molding:adaptive": "d3f4f0201c87c883",
    "dag.molding:weight": "47f2f6b3fa2f6d6e",
    "dag.weight": "b8248ad835a1fbbf",
    "workload.molding:adaptive": "e8fbf42f2a96a319",
    "serve.molding:weight": "8141e2b0f80ad324",
    # locality-off leg (kv_bytes_per_token=0.0 explicitly): every TAO is
    # footprint-free, so the data-aware layer must be invisible — same
    # signature as the pre-locality serve pin by construction.
    "serve.locality-off": "8141e2b0f80ad324",
}

DAG_PIN_POLICIES = ("adaptive", "crit-ptt", "homogeneous", "molding:adaptive",
                    "molding:weight", "weight")


def dag_pin_trace(policy: str, **sim_kwargs):
    """The single-DAG reference run for one policy -> its trace.

    ``sim_kwargs`` forward to the :class:`~repro.core.simulator.Simulator`
    constructor — the shard-identity gate re-runs every pin with
    ``n_shards=1`` through the sharded code path.
    """
    from .dag_gen import random_dag
    from .places import hikey960
    from .policies import make_policy
    from .simulator import Simulator

    dag = random_dag(120, target_degree=3.0, seed=7, width_hint=2)
    sim = Simulator(hikey960(), make_policy(policy), seed=3, **sim_kwargs)
    return sim.run(dag).trace


def workload_pin_trace(**sim_kwargs):
    """The multi-DAG workload reference run -> its trace."""
    from .dag_gen import random_workload
    from .places import fleet
    from .policies import make_policy
    from .simulator import Simulator

    wl = random_workload(n_dags=4, rate=4.0, n_tasks=40, seed=2)
    sim = Simulator(fleet(12, 4), make_policy("molding:adaptive"), seed=9,
                    **sim_kwargs)
    return sim.run_workload(wl).trace


def serve_pin_trace(**sim_kwargs):
    """The preemptible serving reference run -> its trace."""
    from .places import hikey960
    from .policies import make_policy
    from .serve_orchestrator import bursty_serving_trace, simulate_serving

    st = simulate_serving(bursty_serving_trace(seed=1), hikey960(),
                          make_policy("molding:weight"), seed=1, n_chunks=4,
                          **sim_kwargs)
    return st.result.trace


def locality_off_pin_trace(**sim_kwargs):
    """The serving reference run with affinity explicitly OFF -> its trace.

    Identical config to :func:`serve_pin_trace` but with
    ``kv_bytes_per_token=0.0`` passed explicitly — exercising the
    locality-era signature (footprint construction skipped, penalties
    ``None``) rather than the default path.  Must reproduce the
    pre-locality serve pin byte for byte.
    """
    from .places import hikey960
    from .policies import make_policy
    from .serve_orchestrator import bursty_serving_trace, simulate_serving

    st = simulate_serving(bursty_serving_trace(seed=1), hikey960(),
                          make_policy("molding:weight"), seed=1, n_chunks=4,
                          kv_bytes_per_token=0.0, **sim_kwargs)
    return st.result.trace


def all_pin_signatures(**sim_kwargs) -> dict:
    """Recompute every pinned configuration's signature on the live stack.

    ``sim_kwargs`` forward to every pin's Simulator construction (e.g.
    ``n_shards=1`` to drive all pins through the sharded scheduler)."""
    out = {}
    for pol in DAG_PIN_POLICIES:
        out[f"dag.{pol}"] = trace_signature(dag_pin_trace(pol, **sim_kwargs))
    out["workload.molding:adaptive"] = trace_signature(
        workload_pin_trace(**sim_kwargs))
    out["serve.molding:weight"] = trace_signature(
        serve_pin_trace(**sim_kwargs))
    out["serve.locality-off"] = trace_signature(
        locality_off_pin_trace(**sim_kwargs))
    return out


def check_pins(**sim_kwargs) -> list:
    """-> list of mismatch strings (empty == byte-identity holds)."""
    live = all_pin_signatures(**sim_kwargs)
    return [f"{key}: expected {want}, got {live[key]}"
            for key, want in PINNED_SIGNATURES.items()
            if live[key] != want]
