"""Chunk-granularity preemption between tenant namespaces.

Role
----
The paper models a TAO as moldable but *non-preemptible*: once scheduled,
a TAO owns its place until it finishes, so a dominant tenant's wide TAOs
on the big cluster can only be fought at the admission gate — its
*running* work is untouchable.  Following the runtime criticality/weight
steering of arXiv:1905.00673 and the dynamic re-dispatch argument of
arXiv:2502.06304, this module makes running work movable at the one
boundary a TAO already has: the **chunk**.  A TAO's embedded scheduler is
its chunk counter (paper: "a black box filled with work"); stopping a TAO
*between* chunk claims loses no work, needs no thread kill, and leaves a
well-defined continuation — the unclaimed chunks — that can be
repackaged and re-admitted through the normal ``SchedulerCore.admit``
path, with molding free to choose a fresh (leader, width).

Two pieces live here:

* :class:`ChunkCursor` — the **unified yield-point execution core**: the
  chunk-claiming state machine that used to be duplicated between
  ``ThreadedRuntime._TaoExec``'s atomic counter and the simulator's
  completion model.  Worker threads ``claim()`` chunks from it (claims
  stop once ``request_yield`` was called — the cooperative yield flag is
  observed *between* chunk claims, never mid-chunk); the simulator
  ``advance()``s it to the chunk boundary a PREEMPT event truncated the
  segment at.  Either way the cursor partitions ``[0, n_chunks)`` across
  execution segments: no chunk runs twice, none is lost.
* :class:`PreemptionController` — the pluggable policy deciding *whom*
  to displace.  Both vehicles consult it at the same two points: when a
  TAO becomes ready but finds no free capacity (``on_ready``) and when
  the admission gate throttles a tenant's arrivals (``on_gate_feedback``
  — a DELAY verdict is the gate saying this tenant is harming the pool
  right now).  Controllers see the running set as :class:`RunningView`
  snapshots and return the views to displace:

  * ``none``           — :class:`NoPreemption`: never displace (the
                         default; schedules stay byte-identical to the
                         pre-preemption behavior).
  * ``backlog``        — :class:`BacklogPreemption`: when the pool is
                         saturated and one tenant holds at least half of
                         the admitted-but-uncompleted *backlog* (the
                         SLO-dominance signal the ``slo-adaptive`` gate
                         keys on), displace that tenant's least-critical
                         running TAOs — the runtime half of the SLO story
                         whose admission half is the gate.
  * ``critical-boost`` — :class:`CriticalBoostPreemption`: when a TAO on
                         its DAG's critical path would wait because every
                         big-cluster worker is held by non-critical work,
                         displace the least-critical big-cluster occupant.

Thread-safety contract
----------------------
``ChunkCursor`` methods are individually atomic under the cursor's own
lock — ``claim`` (worker threads, concurrently), ``request_yield`` (any
thread: controller consults run on worker *and* admitter threads),
``advance``/``rearm``/``clear_yield`` (the single requeue/truncation
context).  ``preempted_at`` is written by the requeue context before the
TAO is re-enqueued and read by the context that next distributes it — the
ready-queue lock orders the two.  Controllers are **stateless** decision
functions of their inputs (``prepare(spec)`` only pins topology), which
is what makes them safe to consult from concurrent worker threads on the
threaded vehicle and what makes sim/threaded decisions identical on the
same observation trace.

Determinism / parity invariants
-------------------------------
Controller verdicts are pure functions of ``(tao, tenant, running
views, LoadSignals)`` with deterministic tie-breaks — candidates are
ordered by ``(criticality, dag_id, tao_id)`` — so the simulator (PREEMPT/
RESUME events, seq-ordered at equal timestamps) replays a fixed stream
identically run after run, and a threaded run presented with the same
observations makes the same displacement choices.  With the ``none``
controller (or no controller at all) neither vehicle's schedule changes
by a byte.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Sequence

from .admission import LoadSignals
from .dag import TAO


# ---------------------------------------------------------------------------
# The unified yield-point execution core
# ---------------------------------------------------------------------------
def chunk_count(tao: TAO) -> int:
    """How many chunk boundaries (yield points) a TAO's payload carries.

    ``ChunkedWork`` payloads declare their own ``n_chunks``; every other
    payload (cost-model scalars, ``None``) falls back to ``TAO.n_chunks``
    so simulator workloads can be chunked without carrying callables.
    """
    n = getattr(tao.work, "n_chunks", None)
    if n is None:
        n = tao.n_chunks
    return max(1, int(n))


class ChunkCursor:
    """Chunk-claiming state machine shared by both execution vehicles.

    The cursor owns the ``[0, n_chunks)`` index space of one TAO across
    *all* of its execution segments.  The threaded runtime's members call
    :meth:`claim` in a loop (the paper's embedded scheduler); the
    simulator calls :meth:`advance` when a PREEMPT event truncates a
    segment at a chunk boundary.  ``request_yield`` makes every later
    claim return ``None`` — the cooperative preemption point — and
    :meth:`rearm` re-opens the cursor for the continuation segment.
    """

    __slots__ = ("n_chunks", "preemptions", "preempted_at", "_next",
                 "_yield", "_lock")

    def __init__(self, n_chunks: int):
        self.n_chunks = max(1, int(n_chunks))
        self.preemptions = 0          # completed displacements of this TAO
        self.preempted_at = None      # vehicle clock of the last displacement
        self._next = 0
        self._yield = False
        self._lock = threading.Lock()

    def claim(self) -> int | None:
        """Claim the next chunk, or ``None`` when exhausted / yielding.

        This is the yield point: a worker that gets ``None`` stops
        executing this TAO after the chunk it already holds — no thread
        is ever killed mid-chunk."""
        with self._lock:
            if self._yield or self._next >= self.n_chunks:
                return None
            i = self._next
            self._next += 1
            return i

    def advance(self, k: int) -> None:
        """Simulator path: mark ``k`` chunks of the current segment done."""
        with self._lock:
            self._next = min(self.n_chunks, self._next + max(0, k))

    def request_yield(self) -> None:
        """Ask the running members to stop after their current chunks."""
        with self._lock:
            self._yield = True

    def clear_yield(self) -> None:
        """Drop a yield request that raced with natural completion."""
        with self._lock:
            self._yield = False

    def rearm(self, count_displacement: bool = True) -> None:
        """Re-open the cursor for the continuation segment and count the
        completed displacement.

        ``count_displacement=False`` is the chaos path: a segment cut
        short because its workers *died* is not a policy displacement, so
        it must not consume the TAO's ``max_preemptions`` budget (a TAO
        straddling repeated failures must stay re-admittable)."""
        with self._lock:
            self._yield = False
            if count_displacement:
                self.preemptions += 1

    @property
    def yield_requested(self) -> bool:
        with self._lock:
            return self._yield

    def snapshot(self) -> tuple:
        """One consistent ``(next_chunk, yield_requested, preemptions)``
        read (the vehicles' eligibility checks need all three at once)."""
        with self._lock:
            return self._next, self._yield, self.preemptions

    @property
    def next_chunk(self) -> int:
        with self._lock:
            return self._next

    @property
    def unclaimed(self) -> int:
        """Chunks no segment has claimed yet — the continuation's size."""
        with self._lock:
            return self.n_chunks - self._next

    @property
    def remaining_fraction(self) -> float:
        """Share of the TAO's work the continuation still carries."""
        with self._lock:
            return (self.n_chunks - self._next) / self.n_chunks

    def __repr__(self) -> str:
        return (f"ChunkCursor(next={self._next}/{self.n_chunks}, "
                f"yield={self._yield}, preemptions={self.preemptions})")


def ensure_cursor(tao: TAO) -> ChunkCursor:
    """The TAO's cursor, created on first use (``prepare`` resets it)."""
    cur = tao.cursor
    if cur is None:
        cur = tao.cursor = ChunkCursor(chunk_count(tao))
    return cur


# ---------------------------------------------------------------------------
# What controllers may observe
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RunningView:
    """Snapshot of one running TAO, as a controller is allowed to see it.

    ``width`` is the number of workers the place actually holds (members
    clipped to the pool — a nominal width-4 place at the pool edge may
    hold 2), contiguous from ``leader``; occupancy sums and big-cluster
    overlap scans therefore reflect real workers, not nominal widths.
    ``preemptible`` folds in everything the vehicle knows that the
    controller should not re-derive: a yield already pending, no chunk
    boundary left to stop at, no progress yet this segment, or the
    per-TAO displacement cap reached.
    """

    tao: Any                 # the TAO object (vehicles map it back to state)
    tenant: str
    leader: int
    width: int
    criticality: int
    dag_id: int
    tao_id: int
    preemptible: bool
    # the exact workers held (the simulator's water-filling may choose a
    # non-contiguous, non-leader-anchored subset of the nominal place);
    # empty means "contiguous from leader" (synthetic views in tests)
    members: tuple = ()

    @classmethod
    def of(cls, tao: TAO, tenant: str, leader: int, width: int,
           preemptible: bool, members: tuple = ()) -> "RunningView":
        return cls(tao=tao, tenant=tenant, leader=leader, width=width,
                   criticality=tao.criticality, dag_id=tao.dag_id,
                   tao_id=tao.id, preemptible=preemptible, members=members)

    @property
    def held_workers(self):
        """The workers this view's place occupies (geometry queries)."""
        return self.members or range(self.leader, self.leader + self.width)


def _victim_order(v: RunningView) -> tuple:
    """Deterministic victim ordering: least critical first, then the
    (dag_id, tao_id) namespace tie-break both vehicles share."""
    return (v.criticality, v.dag_id, v.tao_id)


def sorted_views(views: list) -> list:
    """The deterministic (dag_id, tao_id) presentation order both
    vehicles hand their snapshots to controllers in (in place)."""
    views.sort(key=lambda v: (v.dag_id, v.tao_id))
    return views


# ---------------------------------------------------------------------------
# Controllers
# ---------------------------------------------------------------------------
class PreemptionController:
    """Base controller: the interface both execution vehicles consult.

    ``max_preemptions`` bounds displacements per TAO (each preemption
    completes at least the chunks already claimed, so progress is
    guaranteed even at the cap — the cap only stops pathological
    ping-pong).  Subclasses must stay stateless between calls: the
    threaded vehicle consults from concurrent worker threads.
    """

    name = "abstract"
    max_preemptions = 8

    def __init__(self) -> None:
        self.spec = None

    def prepare(self, spec) -> None:
        """Pin the pool topology (called by the vehicle at run start)."""
        self.spec = spec

    def reset(self) -> None:
        """Controllers are stateless; subclasses with knobs stay so."""

    def wants_consult(self, signals: LoadSignals,
                      occupied_slots: int) -> bool:
        """Cheap pre-gate the vehicles check before materializing the
        running-view snapshot and per-tenant backlog on the hot enqueue
        path.  ``occupied_slots`` is the width sum of running TAOs (the
        vehicles maintain it as a counter).  Must only return ``False``
        when ``on_ready`` would certainly return no victims."""
        return True

    def on_ready(self, tao: TAO, tenant: str,
                 running: Sequence[RunningView],
                 signals: LoadSignals,
                 backlog: dict | None = None,
                 throttled: frozenset | None = None) -> list[RunningView]:
        """A TAO of ``tenant`` became ready and found no free capacity:
        return the running views to displace (possibly none).

        ``backlog`` maps ``tenant -> admitted-but-uncompleted TAO count``
        (the same admitted-minus-completed quantity the ``slo-adaptive``
        gate tracks, here split per tenant from the vehicles' DagStats
        tables); ``None`` means the vehicle has no per-tenant table
        (single-DAG runs).  ``throttled`` is the set of tenants the
        admission gate is currently holding at the door *for dominating
        the backlog* (``AdmissionDecision.dominant`` delays pending
        re-presentation); ``None`` means the run is ungated."""
        return []

    def on_gate_feedback(self, tenant: str,
                         running: Sequence[RunningView],
                         signals: LoadSignals,
                         backlog: dict | None = None) -> list[RunningView]:
        """The admission gate DELAYed an arrival of ``tenant`` for
        *dominating the pool's backlog* (the vehicles only forward
        dominance-driven verdicts, not a tenant's own degradation)."""
        return []


class NoPreemption(PreemptionController):
    """Default: never displace; byte-identical to the pre-preemption
    schedules (the vehicles also accept ``preemption=None``)."""

    name = "none"

    def wants_consult(self, signals, occupied_slots):
        return False    # never any victims: skip view/backlog building too


class BacklogPreemption(PreemptionController):
    """Displace the tenant whose *backlog* dominates a saturated pool.

    The admission layer's ``slo-adaptive`` gate already throttles the
    dominant tenant's *arrivals*; this controller is the runtime half.
    Dominance is measured on the admitted-minus-completed **backlog** the
    gate keys on (split per tenant from the vehicles' DagStats tables) —
    NOT on running-slot share, which whipsaws: while the gate holds the
    burst tenant at the door, the steady tenant briefly holds most of the
    *running* slots and a slot-share rule would displace the very tenant
    the SLO protects.  When a ready TAO of a non-dominant tenant finds
    every worker slot occupied and one tenant holds at least ``share`` of
    the pool's backlog, that tenant's least-critical running TAOs are
    stopped at their next chunk boundary — enough victims to cover the
    arrival's width hint, at most ``max_victims`` per event.  On a
    *gated* run the dominant tenant must additionally be one the gate is
    currently holding at the door for dominance (``throttled``): raw
    backlog share whipsaws in the drain phase, when the protected
    tenant's last DAGs briefly hold most of the residual backlog — the
    gate's ``AdmissionDecision.dominant`` verdicts carry the asymmetry
    that keeps the SLO story pointing the right way.  On gate feedback
    the roles flip: the dominance-DELAYed tenant itself is displaced,
    draining the backlog that got it throttled — but only while some
    *other* tenant has backlog waiting (a single-tenant or fully-drained
    pool would otherwise self-preempt for pure overhead).  A tenant is
    only ever displaced while it dominates the pool's backlog and never
    for its own arrivals — on the bursty bench the steady tenant is
    never dominance-throttled, so it is never the victim.
    """

    name = "backlog"

    def __init__(self, share: float = 0.5, max_victims: int = 2):
        super().__init__()
        if not 0.0 < share <= 1.0:
            raise ValueError(f"share must be in (0, 1], got {share}")
        if max_victims < 1:
            raise ValueError(f"max_victims must be >= 1, got {max_victims}")
        self.share = float(share)
        self.max_victims = int(max_victims)

    # -- helpers (pure functions of the inputs) -----------------------------
    def _dominant(self, backlog: dict | None) -> str | None:
        if not backlog:
            return None
        total = sum(backlog.values())
        if total <= 0:
            return None
        tenant = min(backlog, key=lambda t: (-backlog[t], t))
        return tenant if backlog[tenant] >= self.share * total else None

    def _victims(self, running: Sequence[RunningView], tenant: str,
                 want_slots: int) -> list[RunningView]:
        cands = sorted((v for v in running
                        if v.tenant == tenant and v.preemptible),
                       key=_victim_order)
        out: list[RunningView] = []
        freed = 0
        for v in cands:
            if len(out) >= self.max_victims or freed >= want_slots:
                break
            out.append(v)
            freed += v.width
        return out

    # -- consult points -----------------------------------------------------
    def wants_consult(self, signals, occupied_slots):
        # mirrors on_ready's saturation early-out: below it, no victims
        return occupied_slots >= signals.n_workers

    def on_ready(self, tao, tenant, running, signals, backlog=None,
                 throttled=None):
        occupied = sum(v.width for v in running)
        if occupied < signals.n_workers:
            return []                       # free capacity: no need to displace
        dom = self._dominant(backlog)
        if dom is None or dom == tenant:
            return []                       # no dominator, or it's us
        # gated runs: only displace a tenant the gate itself is holding at
        # the door for dominance.  Raw backlog share whipsaws in the drain
        # phase — the protected tenant's last DAGs can briefly hold most
        # of the residual backlog, and displacing *it* then inverts the
        # SLO story.  The gate's dominance verdicts carry the asymmetry.
        if throttled is not None and dom not in throttled:
            return []
        return self._victims(running, dom, max(1, tao.width_hint))

    def on_gate_feedback(self, tenant, running, signals, backlog=None):
        dom = self._dominant(backlog)
        if dom is None or dom != tenant:
            return []
        # draining the delayed tenant's running work only helps if some
        # other tenant is actually waiting behind it
        if sum(b for t, b in backlog.items() if t != tenant) <= 0:
            return []
        return self._victims(running, dom, 1)


class CriticalBoostPreemption(PreemptionController):
    """Keep big-cluster leaders available for critical-path TAOs.

    The §3.2.1 criticality signal steers *placement*; this controller
    extends it to *displacement*: when a TAO that is critical within its
    own DAG namespace becomes ready and every big-cluster worker is held
    by running work, the least-critical preemptible occupant of the big
    cluster is stopped at its next chunk boundary — unless that occupant
    is itself on the critical path of the arriving TAO's own namespace
    (criticality is only comparable within one DAG, so cross-namespace
    victims are ordered by the deterministic tie-break, not compared).
    """

    name = "critical-boost"

    def __init__(self, max_victims: int = 1):
        super().__init__()
        if max_victims < 1:
            raise ValueError(f"max_victims must be >= 1, got {max_victims}")
        self.max_victims = int(max_victims)

    def wants_consult(self, signals, occupied_slots):
        # all big workers occupied requires at least that many occupied
        # slots pool-wide (necessary, not sufficient — conservative)
        spec = self.spec
        if spec is None or not spec.big_workers:
            return False
        return occupied_slots >= len(spec.big_workers)

    def on_ready(self, tao, tenant, running, signals, backlog=None,
                 throttled=None):
        spec = self.spec
        if spec is None or not spec.big_workers:
            return []
        bigs = set(spec.big_workers)
        ns_max = max((v.criticality for v in running
                      if v.dag_id == tao.dag_id), default=0)
        if tao.criticality < ns_max:
            return []                        # the arrival is not critical
        occupied: set[int] = set()
        for v in running:
            occupied.update(m for m in v.held_workers if m in bigs)
        if len(occupied) < len(bigs):
            return []                        # a big worker is free anyway
        cands = []
        for v in running:
            if not v.preemptible:
                continue
            if not any(m in bigs for m in v.held_workers):
                continue
            if v.dag_id == tao.dag_id and v.criticality >= ns_max:
                continue     # never displace our own critical path
            cands.append(v)
        cands.sort(key=_victim_order)
        return cands[:self.max_victims]


# ---------------------------------------------------------------------------
# registry used by benchmarks / CLI
# ---------------------------------------------------------------------------
ALL_PREEMPTION_NAMES = ("none", "backlog", "critical-boost")

_CONTROLLERS = {
    "none": NoPreemption,
    "backlog": BacklogPreemption,
    "critical-boost": CriticalBoostPreemption,
}


def make_preemption(name: str, **kwargs) -> PreemptionController:
    """Factory for ``--preemption <name>``: any of
    :data:`ALL_PREEMPTION_NAMES`; ``kwargs`` forward to the controller."""
    try:
        cls = _CONTROLLERS[name]
    except KeyError:
        raise ValueError(
            f"unknown preemption controller: {name!r} "
            f"(choose from: {', '.join(ALL_PREEMPTION_NAMES)})") from None
    return cls(**kwargs)
