"""Concurrent multi-DAG workloads: online arrival streams over one pool.

The paper evaluates one DAG at a time, but a production pool serves a
*stream* of mixed-mode DAGs arriving online (requests, training jobs,
pipelines) that share a single heterogeneous worker fleet.  Following the
adaptive-scheduling follow-up (arXiv:1905.00673) and the workload-centric
view of arXiv:2502.06304, the scheduling unit here is the whole stream:

* ``Workload``      — an ordered set of ``DagArrival`` events (trace-driven
  via :meth:`Workload.from_trace`; synthetic Poisson streams of random DAGs
  come from :func:`repro.core.dag_gen.random_workload`).
* ``DagStats``      — per-DAG latency accounting: arrival, first execution,
  completion; derived sojourn (completion - arrival, the end-to-end latency
  a tenant observes) and makespan (completion - first execution).
* ``WorkloadResult``— a :class:`~repro.core.simulator.SimResult` extended
  with the per-DAG table and sojourn percentiles (p50/p99).

Criticality namespaces: each admitted DAG keeps its own criticality scale
(a 5-node DAG's root must still count as critical next to a 3000-node
tenant), which ``SchedulerCore`` implements as per-``dag_id`` multisets.

Admission control: every arrival carries a *tenant* label, and both
vehicles route arrivals through an optional
:class:`~repro.core.admission.AdmissionGate` before any TAO reaches the
scheduler.  ``DagStats`` therefore distinguishes *arrival* (the stream
timestamp) from *admitted* (when the gate let the DAG in) and records
``rejected`` outcomes; ``WorkloadResult`` aggregates goodput and
per-tenant SLO attainment on top of the sojourn percentiles.

Preemption: a :class:`~repro.core.preemption.PreemptionController` may
displace a DAG's *running* TAOs at chunk boundaries.  ``DagStats`` keeps
the per-DAG ledger (``preempted_count`` displacements,
``preemption_delay`` total stop->resume gap) and ``WorkloadResult``
exposes the fairness surface on top (``n_preemptions``,
``preemptions_by_tenant`` — who actually got stopped for whom,
``mean_preemption_delay``).

This module holds only data/aggregation; execution is vehicle-agnostic —
:meth:`repro.core.simulator.Simulator.run_workload` replays the stream in
virtual time, :meth:`repro.core.runtime.ThreadedRuntime.run_workload`
admits the same stream at real wall-clock offsets into the live thread
pool.  Both return a ``WorkloadResult``.

Real payloads: a ``DagArrival`` may carry ``tokens`` (application work
units — serving attaches prompt+gen tokens, aggregated into
``WorkloadResult.tokens_by_tenant`` / ``token_throughput``) and a ``bind``
callback.  ``bind(dag)`` runs exactly once per admitted DAG, on the
admitting thread (simulator event loop / threaded admitter) right before
``SchedulerCore.prepare`` — the hook the serving orchestrator uses to
attach real jitted-kernel ``ChunkedWork`` payloads lazily, so a rejected
request never materializes its closures.

Thread-safety contract: everything here is passive data.  ``Workload`` is
built single-threaded and only read during a run; ``DagStats`` objects
are mutated by exactly one simulator event loop, or under the threaded
runtime's ``_stats_lock`` — they carry no locks of their own.  There are
no fast/slow path variants in this module: aggregation (``percentile``,
the ``WorkloadResult`` helpers) is deterministic, interpolation-free code
shared verbatim by both vehicles, which is what makes cross-vehicle
latency reports comparable.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Iterable, Sequence

from .dag import TaoDag
from .simulator import SimResult


@dataclasses.dataclass(frozen=True)
class DagArrival:
    """One DAG joining the system at an absolute time."""

    dag: TaoDag
    at: float
    dag_id: int
    name: str = ""
    # admission-control namespace: gates rate-limit / SLO-track per tenant,
    # so DAGs of one tenant share a bucket and an SLO
    tenant: str = "default"
    # units of application work this DAG represents (serving: prompt+gen
    # tokens) — pure accounting, never consulted by scheduling; flows into
    # ``DagStats.tokens`` so results can report per-tenant token throughput
    tokens: float = 0.0
    # deferred payload binding: both vehicles call ``bind(dag)`` exactly
    # once, at admission time and before ``SchedulerCore.prepare`` — so real
    # payloads (jitted-kernel ``ChunkedWork`` closures) are materialized only
    # for DAGs that actually enter the system, and a rejected arrival never
    # pays for them.  ``None`` leaves build-time payloads untouched.
    bind: Callable[[TaoDag], None] | None = None

    def __repr__(self) -> str:
        return (f"DagArrival(dag_id={self.dag_id}, at={self.at:.4f}, "
                f"n_taos={len(self.dag)}, name={self.name!r}, "
                f"tenant={self.tenant!r})")


class Workload:
    """An online stream of TAO-DAGs sharing one scheduler/pool.

    ``dag_id`` values are assigned on :meth:`add` starting from 1 —
    namespace 0 is reserved for the legacy single-DAG ``Simulator.run``
    path so mixed usage never collides.
    """

    def __init__(self) -> None:
        self._arrivals: list[DagArrival] = []
        # id() of admitted dag *objects* (duplicate-object guard) — not the
        # assigned DagArrival.dag_id namespace values
        self._seen_obj_ids: set[int] = set()
        self._ids = itertools.count(1)

    # -- construction -------------------------------------------------------
    def add(self, dag: TaoDag, at: float = 0.0, name: str = "",
            tenant: str = "default", tokens: float = 0.0,
            bind: Callable[[TaoDag], None] | None = None) -> DagArrival:
        if at < 0:
            raise ValueError(f"arrival time must be >= 0, got {at}")
        if id(dag) in self._seen_obj_ids:
            # execution state (pending counters, dag_id tags) lives on the
            # TAO nodes, so one TaoDag object cannot be in flight twice;
            # re-submitting a recurring job needs a fresh/copied DAG
            raise ValueError(
                "this TaoDag is already in the workload; build a copy to "
                "submit it again")
        did = next(self._ids)
        arr = DagArrival(dag=dag, at=float(at), dag_id=did,
                         name=name or f"dag{did}", tenant=tenant,
                         tokens=float(tokens), bind=bind)
        self._arrivals.append(arr)
        self._seen_obj_ids.add(id(dag))
        return arr

    @classmethod
    def from_trace(cls, entries: Iterable[tuple]) -> "Workload":
        """Trace-driven arrivals: iterable of ``(at, dag)``,
        ``(at, dag, name)`` or ``(at, dag, name, tenant)`` tuples (any
        order; sorted on iteration)."""
        wl = cls()
        for e in entries:
            at, dag, *rest = e
            wl.add(dag, at=at, name=rest[0] if rest else "",
                   tenant=rest[1] if len(rest) > 1 else "default")
        return wl

    # -- queries ------------------------------------------------------------
    def arrivals(self) -> list[DagArrival]:
        """Arrival events sorted by (time, dag_id) — the stream order."""
        return sorted(self._arrivals, key=lambda a: (a.at, a.dag_id))

    def total_taos(self) -> int:
        return sum(len(a.dag) for a in self._arrivals)

    def __len__(self) -> int:
        return len(self._arrivals)

    def __iter__(self):
        return iter(self.arrivals())


@dataclasses.dataclass
class DagStats:
    """Per-DAG latency accounting inside a workload run."""

    dag_id: int
    name: str
    arrival: float
    n_taos: int
    started: float = float("inf")    # first TAO execution start
    finished: float = float("nan")   # last TAO completion
    completed: int = 0               # TAOs committed so far
    tenant: str = "default"
    admitted: float = float("nan")   # when the admission gate let it in
    rejected: bool = False           # gate dropped it; never executed
    # chunk-granularity preemption accounting (repro.core.preemption):
    # displacements of this DAG's running TAOs, and the total stop->resume
    # gap its continuations spent waiting to be re-placed
    preempted_count: int = 0
    preemption_delay: float = 0.0
    # chaos accounting (repro.core.chaos): TAOs of this DAG re-admitted
    # because the workers running them were KILLed — separate from the
    # preemption ledger above, which counts *policy* displacements only
    requeued_by_failure: int = 0
    # application work units (serving: prompt+gen tokens) carried by the
    # arrival; aggregated per tenant by WorkloadResult.tokens_by_tenant
    tokens: float = 0.0
    # data-locality accounting (repro.core.locality): dispatches of this
    # DAG's footprint TAOs that landed on (hits) / off (misses) the data's
    # resident cluster, and the bytes those misses moved.  Zero-footprint
    # DAGs never touch these.
    locality_hits: int = 0
    locality_misses: int = 0
    moved_bytes: float = 0.0

    @classmethod
    def for_arrival(cls, dag_id: int, name: str, arrival: float,
                    n_taos: int, tenant: str = "default",
                    tokens: float = 0.0) -> "DagStats":
        """Stats entry for a DAG joining the system; both execution
        vehicles use this so the degenerate rule (an empty DAG is done on
        arrival) lives in exactly one place."""
        st = cls(dag_id=dag_id, name=name, arrival=arrival, n_taos=n_taos,
                 tenant=tenant, tokens=tokens)
        if n_taos == 0:
            # empty DAGs bypass the admission gate on both vehicles
            st.admitted = arrival
            st.started = st.finished = arrival
        return st

    def mark_admitted(self, t: float) -> None:
        """The admission gate let this DAG in at time ``t`` (both vehicles
        call this before releasing the DAG's roots)."""
        self.admitted = t
        if self.n_taos == 0:      # delayed empty DAG: done at admission
            self.started = self.finished = t

    def mark_rejected(self) -> None:
        """The admission gate dropped this DAG; it will never execute."""
        self.rejected = True

    def record_preemption(self) -> None:
        """One of this DAG's running TAOs was stopped at a chunk boundary
        (its continuation is being re-admitted); both vehicles call this
        at the moment the displacement takes effect."""
        self.preempted_count += 1

    def record_failure_requeue(self) -> None:
        """One of this DAG's running TAOs lost its workers to a chaos KILL
        and its continuation is being re-admitted (claimed chunks are kept;
        only unclaimed chunks are redone)."""
        self.requeued_by_failure += 1

    def record_locality(self, hit: bool, moved_bytes: float = 0.0) -> None:
        """One dispatch of this DAG's footprint TAOs was accounted by the
        locality tracker: a hit ran on the data's resident cluster, a miss
        moved ``moved_bytes`` across clusters (both vehicles call this at
        the moment the TAO is actually distributed to workers)."""
        if hit:
            self.locality_hits += 1
        else:
            self.locality_misses += 1
            self.moved_bytes += moved_bytes

    def record_completion(self, t: float) -> None:
        """One TAO of this DAG committed at time ``t``; the last one stamps
        the completion time (shared by both execution vehicles)."""
        self.completed += 1
        if self.completed == self.n_taos:
            self.finished = t

    @property
    def done(self) -> bool:
        return not self.rejected and self.completed == self.n_taos

    @property
    def was_admitted(self) -> bool:
        return math.isfinite(self.admitted)

    @property
    def has_started(self) -> bool:
        return math.isfinite(self.started)

    @property
    def has_finished(self) -> bool:
        return math.isfinite(self.finished)

    # Derived latencies are nan (not inf / inf-inf garbage) until the DAG
    # actually reaches the corresponding lifecycle point, so per-tenant
    # tables of partially-run streams aggregate and print sanely.
    @property
    def sojourn(self) -> float:
        """End-to-end latency the tenant observes: completion - arrival."""
        if not self.has_finished:
            return float("nan")
        return self.finished - self.arrival

    @property
    def makespan(self) -> float:
        """Pure execution span: completion - first TAO start (excludes
        queueing of the roots behind other tenants)."""
        if not (self.has_started and self.has_finished):
            return float("nan")
        return self.finished - self.started

    @property
    def queue_delay(self) -> float:
        """Time the DAG's first TAO waited behind other tenants."""
        if not self.has_started:
            return float("nan")
        return self.started - self.arrival

    @property
    def admission_delay(self) -> float:
        """Time the DAG was held at the admission gate before entering
        (0 for ungated / immediately-admitted DAGs; nan if never
        admitted — i.e. rejected or still queued at the gate)."""
        if not self.was_admitted:
            return float("nan")
        return self.admitted - self.arrival


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); nan on empty input.

    Deterministic and interpolation-free so latency reports are stable
    across numpy versions and list orderings.
    """
    if not values:
        return float("nan")
    if not 0 <= q <= 100:
        raise ValueError(f"percentile must be in [0, 100], got {q}")
    s = sorted(values)
    rank = max(1, -(-len(s) * q // 100))  # ceil without floats
    return float(s[int(rank) - 1])


def _slo_of(st: "DagStats", slo) -> float:
    """Resolve an SLO spec — a float (uniform), a ``tenant -> target``
    mapping (missing tenants get inf, i.e. always attained), or a
    callable ``DagStats -> target`` — to this DAG's target sojourn."""
    if callable(slo):
        return float(slo(st))
    if isinstance(slo, dict):
        return float(slo.get(st.tenant, float("inf")))
    return float(slo)


@dataclasses.dataclass
class WorkloadResult(SimResult):
    """SimResult + per-DAG latency table for a multi-tenant run."""

    per_dag: dict = dataclasses.field(default_factory=dict)  # dag_id -> DagStats
    # sharded runs only: the ShardedScheduler's exchange ledger
    # (``ShardedScheduler.exchange_stats()``) — total/in/out per shard and
    # the peak imbalance seen at an exchange; None on unsharded runs
    exchanges: dict | None = None

    def sojourns(self) -> list[float]:
        return [s.sojourn for s in self.per_dag.values() if s.done]

    # -- admission accounting ------------------------------------------------
    def admitted_dags(self) -> list:
        return [s for s in self.per_dag.values() if s.was_admitted]

    def rejected_dags(self) -> list:
        return [s for s in self.per_dag.values() if s.rejected]

    @property
    def n_rejected(self) -> int:
        return sum(1 for s in self.per_dag.values() if s.rejected)

    def mean_admission_delay(self) -> float:
        """Mean gate-queueing time over admitted DAGs (0 when ungated)."""
        ds = [s.admission_delay for s in self.admitted_dags()]
        return sum(ds) / len(ds) if ds else float("nan")

    def per_tenant(self) -> dict:
        """``tenant -> [DagStats]`` grouping, in dag_id order.

        Each ``DagStats`` row carries its preemption ledger
        (``preempted_count`` / ``preemption_delay``), so per-tenant
        *displacement fairness* — who actually got stopped for whom — is
        readable straight off this grouping; ``preemptions_by_tenant``
        is the one-number-per-tenant summary of the same data."""
        out: dict[str, list] = {}
        for _, st in sorted(self.per_dag.items()):
            out.setdefault(st.tenant, []).append(st)
        return out

    # -- preemption accounting ----------------------------------------------
    @property
    def n_preemptions(self) -> int:
        """Total chunk-boundary displacements across the whole run."""
        return sum(s.preempted_count for s in self.per_dag.values())

    def preemptions_by_tenant(self) -> dict:
        """``tenant -> displacement count`` — the fairness surface benches
        assert on (e.g. the steady tenant is never the victim)."""
        return {tenant: sum(s.preempted_count for s in stats)
                for tenant, stats in self.per_tenant().items()}

    def failure_requeues_by_tenant(self) -> dict:
        """``tenant -> TAO re-admissions caused by worker death`` (the
        chaos bench's conservation/robustness surface; disjoint from
        :meth:`preemptions_by_tenant`, which is policy displacements)."""
        return {tenant: sum(s.requeued_by_failure for s in stats)
                for tenant, stats in self.per_tenant().items()}

    def mean_preemption_delay(self) -> float:
        """Mean stop->resume gap per displacement (nan when none)."""
        n = self.n_preemptions
        if n == 0:
            return float("nan")
        return sum(s.preemption_delay for s in self.per_dag.values()) / n

    def goodput(self, slo) -> int:
        """Completed DAGs whose sojourn met their SLO (the admission
        bench's headline metric — a rejected or SLO-missing DAG is not
        good output, however fast the rest ran).  ``slo`` as in
        :func:`_slo_of`: float, ``tenant -> target`` dict, or callable."""
        return sum(1 for s in self.per_dag.values()
                   if s.done and s.sojourn <= _slo_of(s, slo))

    def slo_attainment(self, slo) -> dict:
        """``tenant -> fraction of its *arrivals* that completed within
        SLO``.  Rejected and never-finished DAGs count against the tenant
        (an operator cares what share of submitted work came back in
        time, not what share of the survivors did)."""
        out: dict[str, float] = {}
        for tenant, stats in self.per_tenant().items():
            ok = sum(1 for s in stats if s.done and s.sojourn <= _slo_of(s, slo))
            out[tenant] = ok / len(stats)
        return out

    # -- token accounting ----------------------------------------------------
    # Tokens are pure application-work units attached at Workload.add time
    # (serving: prompt+gen tokens per request).  Only *completed* DAGs count
    # toward throughput: a rejected or still-running request has not
    # delivered its tokens, however many it carried in.
    def tokens_done(self) -> float:
        """Tokens of work the completed DAGs delivered."""
        return sum(s.tokens for s in self.per_dag.values() if s.done)

    def tokens_by_tenant(self) -> dict:
        """``tenant -> delivered tokens`` over completed DAGs."""
        return {tenant: sum(s.tokens for s in stats if s.done)
                for tenant, stats in self.per_tenant().items()}

    def token_throughput(self) -> float:
        """Delivered tokens / makespan (0 when the run spans no time)."""
        if self.makespan <= 0:
            return 0.0
        return self.tokens_done() / self.makespan

    def token_throughput_by_tenant(self) -> dict:
        """``tenant -> delivered tokens / makespan`` — the per-tenant
        serving throughput surface benches report."""
        if self.makespan <= 0:
            return {t: 0.0 for t in self.per_tenant()}
        return {t: toks / self.makespan
                for t, toks in self.tokens_by_tenant().items()}

    # -- data-locality accounting -------------------------------------------
    # Hits/misses/moved-bytes are stamped per dispatch by the vehicles via
    # DagStats.record_locality; zero-footprint workloads report 0/0/0.0.
    def locality_hits(self) -> int:
        return sum(s.locality_hits for s in self.per_dag.values())

    def locality_misses(self) -> int:
        return sum(s.locality_misses for s in self.per_dag.values())

    def moved_bytes(self) -> float:
        """Total bytes moved across clusters by off-resident placements."""
        return sum(s.moved_bytes for s in self.per_dag.values())

    def cache_hit_rate(self) -> float:
        """Fraction of footprint-TAO dispatches that ran on the resident
        cluster (nan when the workload carried no footprints)."""
        hits, misses = self.locality_hits(), self.locality_misses()
        total = hits + misses
        return hits / total if total else float("nan")

    def moved_bytes_by_tenant(self) -> dict:
        return {tenant: sum(s.moved_bytes for s in stats)
                for tenant, stats in self.per_tenant().items()}

    def sojourn_p50(self) -> float:
        return percentile(self.sojourns(), 50)

    def sojourn_p99(self) -> float:
        return percentile(self.sojourns(), 99)

    def mean_sojourn(self) -> float:
        so = self.sojourns()
        return sum(so) / len(so) if so else float("nan")

    def __repr__(self) -> str:
        rej = f", rejected={self.n_rejected}" if self.n_rejected else ""
        if self.n_preemptions:
            rej += f", preemptions={self.n_preemptions}"
        return (f"WorkloadResult(dags={len(self.per_dag)}, "
                f"makespan={self.makespan:.4f}s, "
                f"p50={self.sojourn_p50():.4f}s, "
                f"p99={self.sojourn_p99():.4f}s, "
                f"completed={self.completed}{rej}, "
                f"util={self.utilization:.2%})")
