"""Shared scheduler core: DPA bookkeeping + commit-and-wakeup logic.

Role: both execution vehicles (the threaded runtime and the discrete-event
simulator) drive this object.  It owns the pieces the paper's policies need
to observe — the PTT registry, the running-criticality multiset (the "atomic
variable" of §3.2.1) and the load counters — and performs the wake-up
transition: parent completes -> child pending-- -> ready -> policy placement.
It also exports the load snapshot (:meth:`SchedulerCore.admission_signals`)
that admission gates consult before a DAG's roots ever reach ``admit``,
and the :meth:`SchedulerCore.release` transition preemption uses: a TAO
stopped at a chunk boundary leaves the accounting exactly as if it had
never been admitted, then re-enters through the normal ``admit`` path as
a continuation (release + admit balance to a no-op on every counter).

Thread-safety contract: one reentrant lock (``_lock``) guards all mutable
state.  ``admit`` runs the *policy* outside that lock (concurrent wake-ups
on the threaded runtime must not serialize on each other's PTT reads) and
only takes it for the accounting transition; every SchedulerContext getter
takes the lock individually so each read is internally consistent.  A
policy may therefore observe aggregates a few records stale — safe, because
the PTT is already an EWMA approximation of a drifting system (see
``admit``'s docstring).  ``commit_and_wakeup`` and ``reset_counters`` are
fully serialized under the lock.

Fast/slow-path invariant: ``fast_query=True`` (default) gives the PTT its
O(1) incremental aggregates; ``fast_query=False`` keeps the O(n_workers)
scan queries.  Both paths return bit-identical values, so schedules do not
depend on the knob — it exists purely as the perf-suite baseline.
"""
from __future__ import annotations

import heapq
import random
import threading

from .admission import LoadSignals
from .dag import TAO, TaoDag
from .locality import LocalityTracker
from .places import ClusterSpec, leader_of, place_members
from .policies import Placement, Policy
from .ptt import PTTRegistry


class _CritMultiset:
    """Max-query multiset of criticalities (lazy-deletion heap).

    ``max()`` prunes dead heap entries lazily, but a long-lived namespace
    that keeps adding *descending* criticalities (a chain drains root-first)
    never pops them — so ``remove`` drops zeroed counts eagerly and compacts
    the heap once stale entries outnumber live distinct values: memory stays
    bounded by the number of criticalities currently in flight.
    """

    def __init__(self) -> None:
        self._heap: list[int] = []      # negated values; may hold stale dupes
        self._count: dict[int, int] = {}
        self._size = 0

    def add(self, v: int) -> None:
        heapq.heappush(self._heap, -v)
        self._count[v] = self._count.get(v, 0) + 1
        self._size += 1

    def remove(self, v: int) -> None:
        c = self._count.get(v, 0)
        if c <= 0:
            raise KeyError(f"criticality {v} not present")
        if c == 1:
            del self._count[v]
        else:
            self._count[v] = c - 1
        self._size -= 1
        # heap entries for values with no live count are stale; rebuild from
        # the live distinct values when they dominate (amortized O(1))
        if len(self._heap) > 2 * max(len(self._count), 4):
            self._heap = [-u for u in self._count]
            heapq.heapify(self._heap)

    def max(self) -> int:
        while self._heap:
            v = -self._heap[0]
            if self._count.get(v, 0) > 0:
                return v
            heapq.heappop(self._heap)
        return 0

    def __len__(self) -> int:
        return self._size


class SchedulerCore:
    """DPA + commit-and-wakeup state machine (execution-vehicle agnostic).

    Implements the ``SchedulerContext`` protocol consumed by policies.
    """

    def __init__(self, spec: ClusterSpec, policy: Policy, seed: int = 0,
                 fast_query: bool = True):
        self.spec = spec
        self.policy = policy
        # fast_query=False keeps the PTT's O(n_workers) scan queries — only
        # useful as the baseline in perf/parity tests (mirrors fast_dispatch)
        self.ptt = PTTRegistry(spec, fast_query=fast_query)
        # data-locality layer: per-cluster residency, movement table and the
        # per-cluster penalty vectors policies charge for footprint TAOs.
        # Zero-footprint TAOs never consult it (pinned-signature contract).
        self.locality = LocalityTracker(spec)
        self._seed = seed
        self.rng = random.Random(seed)
        # one criticality multiset per DAG namespace: concurrent tenants must
        # not drown each other's critical paths (a small DAG's root is still
        # critical even while a 3000-node DAG holds criticality 800).
        self._crit: dict[int, _CritMultiset] = {}
        self._in_flight = 0           # ready+running TAOs (molding load signal)
        self._in_flight_ns: dict[int, int] = {}   # per-namespace breakdown
        self._completed = 0
        # displacement history (preemption-aware damping input): how often
        # each namespace — and, when a dag_id->tenant mapping is installed,
        # each tenant — has had a running TAO released at a chunk boundary
        self._displaced_ns: dict[int, int] = {}
        self._displaced_tenant: dict[str, int] = {}
        self._tenant_of: dict[int, str] = {}
        # chaos: workers currently dead (KILL, not yet RECOVERed).  Empty on
        # every non-chaotic run; policies and the PTT consult it so placement
        # never targets a place overlapping a dead worker, and
        # admission_signals reports the shrunken capacity to SLO gates.
        self._dead: frozenset = frozenset()
        self._lock = threading.RLock()

    # -- SchedulerContext ----------------------------------------------------
    # The context getters take the (reentrant) lock individually: policies
    # now run *outside* the global critical section (see admit), so each read
    # must be internally consistent — in particular _CritMultiset.max()
    # lazily mutates its heap and would corrupt under unlocked concurrency.
    def system_load(self, namespace: int | None = None) -> int:
        """Ready+running TAOs — globally, or for one DAG namespace.

        Workload-aware molding sizes widths from the *tenant's* own load
        (``namespace=tao.dag_id``) so a small DAG arriving during another
        tenant's burst still sees idle headroom; the global counter stays
        the legacy signal for single-DAG runs."""
        with self._lock:
            if namespace is None:
                return self._in_flight
            return self._in_flight_ns.get(namespace, 0)

    def active_namespaces(self) -> int:
        """Number of DAG namespaces with at least one ready/running TAO."""
        with self._lock:
            return len(self._in_flight_ns)

    def running_max_criticality(self, namespace: int = 0) -> int:
        with self._lock:
            ms = self._crit.get(namespace)
            return ms.max() if ms is not None else 0

    def displacements(self, namespace: int = 0) -> int:
        """Displacement history for one namespace's tenant.

        When :meth:`set_tenants` installed a dag_id->tenant mapping (the
        workload runners do), the count aggregates over every DAG of the
        same tenant — a serving tenant whose requests keep getting preempted
        is *chronically* displaced even though each individual request only
        loses once.  Policies damp width/impl aggressiveness on this signal
        (see ``policies._damp_level``)."""
        with self._lock:
            tenant = self._tenant_of.get(namespace)
            if tenant is not None:
                return self._displaced_tenant.get(tenant, 0)
            return self._displaced_ns.get(namespace, 0)

    def set_tenants(self, mapping: dict) -> None:
        """Install (merge) a ``dag_id -> tenant name`` mapping so displacement
        history aggregates per tenant across that tenant's DAGs."""
        with self._lock:
            self._tenant_of.update(mapping)

    def dead_workers(self) -> frozenset:
        """Workers currently failed (chaos KILL).  Empty on healthy runs."""
        return self._dead

    def set_dead(self, dead: frozenset) -> None:
        """Install the chaos dead-worker set: masks the PTT's placement
        queries (see :meth:`PTTRegistry.set_excluded`) and shrinks the
        capacity :meth:`admission_signals` reports, so SLO-adaptive gates
        throttle to the surviving fleet.  An empty set restores every
        original code path (byte-identity with chaos disabled)."""
        dead = frozenset(dead)
        with self._lock:
            self._dead = dead
        self.ptt.set_excluded(dead)

    def admission_signals(self) -> LoadSignals:
        """One internally-consistent load snapshot for admission gates
        (taken under the core lock, so in_flight/active_namespaces/
        completed all describe the same instant).  Capacity shrinks by the
        dead-worker count, so backlog limits track post-failure capacity."""
        with self._lock:
            n_failed = len(self._dead)
            return LoadSignals(in_flight=self._in_flight,
                               active_namespaces=len(self._in_flight_ns),
                               n_workers=self.spec.n_workers - n_failed,
                               completed=self._completed,
                               n_failed=n_failed)

    # -- lifecycle transitions -------------------------------------------------
    def admit(self, tao: TAO, waker: int) -> Placement:
        """A TAO became ready: run the policy, clamp the width, account it.

        Returns the placement; the execution vehicle enqueues accordingly.

        The policy's placement computation runs OUTSIDE the global lock, so
        on the threaded runtime concurrent wake-ups no longer serialize on
        each other's PTT reads.  A placement may therefore observe aggregates
        that are a few records stale relative to the accounting below — which
        is safe because the PTT is *already* an EWMA approximation of a
        drifting system (interference, DVFS, background load, paper §3.1):
        a decision computed from a snapshot a few records old is exactly as
        (in)accurate as one computed a microsecond later, and every
        individual read (PTT aggregate, load counter, criticality max) is
        internally consistent under its own lock.  The accounting transition
        itself stays atomic.
        """
        placement = self.policy.place(tao, self, waker)
        width = self._clamp_width(placement.width)
        target = placement.target % self.spec.n_workers
        # a continuation's chunk state is impl-specific: keep the variant it
        # already ran under (policies pin it too; this is the backstop)
        cursor = tao.cursor
        is_continuation = cursor is not None and \
            getattr(cursor, "next_chunk", 0) > 0
        impl = tao.assigned_impl if is_continuation else placement.impl
        with self._lock:
            tao.assigned_width = width
            tao.assigned_impl = impl
            # assigned_leader stays -1 here: the real place is derived from
            # the *popper* at DPA time (a steal moves it), so the vehicles
            # stamp it when the TAO is actually distributed/started.
            ms = self._crit.get(tao.dag_id)
            if ms is None:
                ms = self._crit[tao.dag_id] = _CritMultiset()
            ms.add(tao.criticality)
            self._in_flight += 1
            self._in_flight_ns[tao.dag_id] = \
                self._in_flight_ns.get(tao.dag_id, 0) + 1
            return Placement(target=target, width=width, impl=impl)

    def _retire_locked(self, tao: TAO) -> None:
        """Undo ``admit``-time accounting (caller holds ``_lock``): the TAO
        is no longer ready/running — either it committed, or it was
        preempted and will be re-admitted as a continuation."""
        ms = self._crit.get(tao.dag_id)
        if ms is None:
            raise KeyError(f"no criticality namespace {tao.dag_id}")
        ms.remove(tao.criticality)
        if not ms:
            # a long-lived stream admits many DAGs; drop drained
            # namespaces so memory stays bounded by concurrency
            del self._crit[tao.dag_id]
        self._in_flight -= 1
        left = self._in_flight_ns[tao.dag_id] - 1
        if left:
            self._in_flight_ns[tao.dag_id] = left
        else:
            del self._in_flight_ns[tao.dag_id]

    def release(self, tao: TAO, count_displacement: bool = True) -> None:
        """A running TAO was stopped at a chunk boundary (preempted): undo
        the admit-time accounting WITHOUT counting a completion or waking
        children.  The vehicle re-admits the continuation through the
        normal :meth:`admit` path immediately after, so molding is free to
        choose a fresh (leader, width) and the load/criticality counters
        stay balanced (release + admit == no net change).

        ``count_displacement=False`` is the chaos re-admission path: a TAO
        requeued because its workers *died* was not displaced by policy, so
        it must neither feed preemption-aware damping nor consume the
        tenant's displacement budget."""
        with self._lock:
            self._retire_locked(tao)
            # the continuation is re-placed from scratch: the old place is
            # meaningless (that is the point of preempting), so the leader
            # reverts to the not-yet-distributed sentinel
            tao.assigned_leader = -1
            if not count_displacement:
                return
            # displacement history: feed preemption-aware damping
            self._displaced_ns[tao.dag_id] = \
                self._displaced_ns.get(tao.dag_id, 0) + 1
            tenant = self._tenant_of.get(tao.dag_id)
            if tenant is not None:
                self._displaced_tenant[tenant] = \
                    self._displaced_tenant.get(tenant, 0) + 1

    def commit_and_wakeup(self, tao: TAO) -> list[TAO]:
        """Paper §3.2: executed by the last core completing a TAO.  Returns
        the children that became ready (the vehicle then calls ``admit``)."""
        with self._lock:
            self._retire_locked(tao)
            self._completed += 1
            ready = []
            for child in tao.children:
                child.pending -= 1
                if child.pending == 0:
                    ready.append(child)
            return ready

    def reset_counters(self) -> None:
        """Zero the per-run state so one core instance can execute
        consecutive runs.

        Both vehicles call this at the top of ``run``/``run_workload``:
        without it a second run on the same instance compares the
        *cumulative* completed count against the new run's total (ending
        prematurely in the threaded runtime, inflating ``completed`` /
        ``throughput`` in the simulator).  The PTT and any adaptive policy
        state survive deliberately — learned performance history is the
        point of reuse."""
        with self._lock:
            self._completed = 0
            self._in_flight = 0
            self._in_flight_ns.clear()
            self._crit.clear()
            # displacement history is per-run adaptive state, not a learned
            # profile: a fresh run starts undamped
            self._displaced_ns.clear()
            self._displaced_tenant.clear()
            self._tenant_of.clear()
        # hit/miss/moved-bytes are per-run accounting; the measured movement
        # table survives like the PTT (learned transfer rates are reusable)
        self.locality.reset_counters()

    def reset_learning(self, seed: int | None = None) -> None:
        """Forget everything *learned* — PTT profiles (all impls), adaptive
        policy state — zero the per-run counters and restart the RNG stream
        (from the construction seed unless overridden).  The benchmark
        harness calls this between A/B legs so profiles learned in one leg
        cannot leak into the next: a leg run after ``reset_learning`` is
        byte-identical to one on a freshly-built core."""
        self.ptt.reset()
        self.policy.reset()
        self.locality.reset()
        self.reset_counters()
        with self._lock:
            self.rng = random.Random(self._seed if seed is None else seed)

    def rebind_impl(self, tao: TAO, leader: int) -> str:
        """Execution-layer refinement of the joint (impl, width, leader)
        decision: work stealing may start a TAO on a *different* leader than
        the one its variant was chosen for, and on a heterogeneous pool the
        best variant differs per cluster — so the popper re-picks the variant
        for the realized ``(leader, width)`` cell just before execution.

        Single-variant TAOs return unchanged (byte-identity), and so do
        continuations (chunk state is impl-specific; ``_variant_names`` pins
        them to the impl they started under).  Damped tenants (displacement
        history) stop exploring untried cells here exactly as at admit."""
        from .policies import (DAMP_DISPLACEMENTS, _choose_impl,
                               _variant_names)

        names = _variant_names(tao)
        if len(names) <= 1:
            impl = names[0] if names else tao.assigned_impl
            return impl
        explore = self.displacements(tao.dag_id) < DAMP_DISPLACEMENTS
        impl = _choose_impl(self.ptt.table(tao.type), leader,
                            tao.assigned_width, names, explore)
        with self._lock:
            tao.assigned_impl = impl
        return impl

    def record_time(self, tao: TAO, leader: int, width: int, elapsed: float) -> None:
        """Leader-only PTT update into the TAO's (class, impl, width) cell
        (the vehicles enforce leader discipline)."""
        self.ptt.table(tao.type).record(leader, width, elapsed,
                                        impl=tao.assigned_impl)

    # -- place geometry ---------------------------------------------------------
    # Thin wrappers over the XiTAO leader formula so both execution vehicles
    # can ask the *core* for place geometry: a ShardedScheduler (repro.core.
    # shard) overrides these to translate through shard-local worker ids,
    # and the vehicles stay oblivious to whether the pool is partitioned.
    def leader_for(self, popper: int, width: int) -> int:
        """Leader of the place a pop on ``popper`` anchors."""
        return leader_of(popper, width)

    def members_for(self, leader: int, width: int) -> list:
        """Members of the place anchored at ``leader``, clipped to the pool
        edge (the vehicles' historical behavior for max-width places)."""
        n = self.spec.n_workers
        return [m for m in place_members(leader, width) if m < n]

    def learned_cells(self) -> int:
        """Tried PTT cells across every table (learning-progress scalar)."""
        return self.ptt.learned_cells()

    # -- helpers ----------------------------------------------------------------
    def _clamp_width(self, width: int) -> int:
        widths = self.spec.widths
        if width in widths:
            return width
        # round down to the nearest valid power-of-two width
        best = widths[0]
        for w in widths:
            if w <= width:
                best = w
        return best

    @property
    def completed(self) -> int:
        return self._completed

    def prepare(self, dag: TaoDag, dag_id: int = 0) -> list[TAO]:
        """Reset execution state, run the criticality pre-pass (paper: done as
        the runtime is started), tag every node with its criticality
        namespace, and return the initially-ready TAOs."""
        dag.validate()
        dag.assign_criticality()
        dag.reset_execution_state()
        for n in dag.nodes:
            n.dag_id = dag_id
        return dag.roots()
