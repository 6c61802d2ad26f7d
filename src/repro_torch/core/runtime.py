"""Threaded mixed-mode runtime: the faithful XiTAO execution vehicle.

Worker threads own a stealable *ready deque* and an *assembly queue*
(XiTAO's two-level structure).  Popping a ready TAO triggers DPA — the
popping worker computes the place ``[leader, leader+width)`` from its own id
and pushes the TAO into the assembly queues of all members.  Members claim
work *chunks* via an atomic counter and join/leave asynchronously; the last
member to finish runs commit-and-wakeup, and the *leader* records its elapsed
time into the PTT (paper §3.1-3.2).

Work payloads (``TAO.work``) are ``ChunkedWork``: ``n_chunks`` independent
chunk callables (here: jitted JAX computations, which release the GIL while
executing, so threads genuinely overlap).  This is exactly the paper's model
of a TAO as "a black box filled with work" with an embedded scheduler —
the chunk counter *is* the embedded scheduler.  That counter is the shared
:class:`~repro.core.preemption.ChunkCursor`: members claim chunks from it,
and a yield requested by a :class:`~repro.core.preemption.\
PreemptionController` is observed *between* chunk claims (cooperative — no
thread is ever killed), after which the last member repackages the
unclaimed chunks as a continuation and requeues the TAO through the normal
``SchedulerCore.admit`` path with molding free to pick a new place.

``run`` executes one DAG offline; ``run_workload`` executes a multi-DAG
``Workload`` stream *online*: an admission thread sleeps until each
arrival's wall-clock offset and releases the DAG's roots into the live
worker pool, so concurrent tenants genuinely interleave on the same
deques, assembly queues and PTT — the same stream contract the
discrete-event simulator implements, returning the same ``WorkloadResult``.

On a TPU fleet each worker would own a device group and chunks would be
``pjit`` calls on its slice; the orchestrators in ``serve_orchestrator`` /
``train_orchestrator`` build such TAOs.

Admission control: ``run_workload(..., admission=gate)`` makes the admitter
thread consult the same :class:`~repro.core.admission.AdmissionGate`
protocol as the simulator before releasing a DAG's roots — DELAY verdicts
re-queue the arrival at the gate's ``retry_at``, REJECT verdicts mark the
DAG and *shrink the completion target* (``_discount_total``), since its
TAOs will never execute.

Thread-safety contract: state is partitioned by lock — per-worker ready
deques (``_qlocks``) and assembly queues (``_alocks``), the stats/trace
table (``_stats_lock``), the completion target (``_total_lock``), the
running-execution registry (``_run_lock`` guarding ``_running_execs``),
and the park/wake machinery (``_work_cv`` guarding
``_work_epoch``/``_n_parked``).  ``SchedulerCore``/PTT/gate objects carry
their own locks.  Worker threads, the admitter thread and the caller only
communicate through these guarded structures plus the ``_done`` event;
``_error`` is published before ``_set_done`` so the join in
``_run_workers`` observes it.  The gate's ``decide`` runs only on the
admitter thread; ``on_dag_done`` is called from worker threads (outside
``_stats_lock``) and gates lock internally.

Yield-point contract: preemption controllers are consulted from worker
threads (``_enqueue_ready``) and the admitter thread (gate feedback)
concurrently — they are stateless by contract.  A victim's
``ChunkCursor.request_yield`` is a locked flag flip; members observe it
only between chunk claims, so a chunk that started always finishes on the
member that claimed it.  The last member to leave a yielded execution owns
the requeue transition (registry pop -> partial trace record ->
``core.release`` -> ``_enqueue_ready``); no other thread touches that TAO
until it reappears in a ready queue, and the queue lock orders the
hand-off (``cursor.preempted_at`` is written before the enqueue and read
by the worker that later distributes the continuation).

Fast/slow-path invariant: idle workers park on a Condition signalled on
every enqueue/distribute (epoch counter closes the missed-wakeup race) —
parking changes *when* a worker rescans, never what it may legally pop, so
schedules remain valid interleavings of the same DPA state machine the
simulator executes deterministically.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import random
import threading
import time
from collections import deque
from typing import Any, Callable

from .dag import TAO, TaoDag
from .places import ClusterSpec, place_members
from .policies import Policy
from .preemption import RunningView, ensure_cursor, sorted_views
from .scheduler import SchedulerCore
from .shard import ShardedScheduler
from .simulator import TraceRecord


@dataclasses.dataclass
class ChunkedWork:
    """A moldable work payload: ``chunk_fn(i)`` for i in [0, n_chunks)."""

    chunk_fn: Callable[[int], Any]
    n_chunks: int = 1


class _TaoExec:
    """Per-segment state of a TAO execution (membership, timing).

    Chunk claiming lives in the TAO's :class:`ChunkCursor` (shared with
    the simulator and persistent across preemption segments); this object
    only tracks the members of the *current* place."""

    __slots__ = ("tao", "leader", "width", "members", "cursor",
                 "start_claims", "remaining_members", "start_time", "lock",
                 "leader_start")

    def __init__(self, tao: TAO, leader: int, width: int, n_workers: int,
                 dead=(), popper: int | None = None, members=None):
        self.tao = tao
        self.leader = leader
        self.width = width
        if members is None:
            members = [m for m in place_members(leader, width)
                       if m < n_workers]
        self.members = [m for m in members if m not in dead]
        if not self.members:
            # the whole place died between placement and distribution: the
            # popper (always alive — dead workers never pop) runs it solo
            self.members = [popper if popper is not None else leader]
        self.cursor = ensure_cursor(tao)
        # chunks already spent when this segment began: eligibility for
        # preemption requires progress *within* the segment (mirrors the
        # simulator's at-least-one-chunk-per-segment guarantee)
        self.start_claims = self.cursor.next_chunk
        self.remaining_members = len(self.members)
        self.start_time = 0.0
        self.leader_start = 0.0
        self.lock = threading.Lock()


class ThreadedRuntime:
    """Executes a TAO-DAG on ``spec.n_workers`` threads under ``policy``.

    ``n_shards=None`` (default) uses the single ``SchedulerCore`` exactly as
    before.  ``n_shards=k`` partitions the fleet into ``k``
    :class:`~repro.core.shard.ShardedScheduler` shards, each with its own
    lock and PTT view; worker threads steal intra-shard first and only
    cross shards (a counted *work exchange*) when another shard's ready
    depth exceeds their own by the exchange threshold."""

    def __init__(self, spec: ClusterSpec, policy: Policy, seed: int = 0,
                 park_timeout_s: float = 0.05, n_shards: int | None = None,
                 exchange_threshold: int | None = None):
        self.spec = spec
        self.n_shards = n_shards
        if n_shards is None:
            self.core = SchedulerCore(spec, policy, seed=seed)
        else:
            kw = {} if exchange_threshold is None else {
                "exchange_threshold": exchange_threshold}
            self.core = ShardedScheduler(spec, policy, n_shards=n_shards,
                                         seed=seed, **kw)
        # Approximate per-shard ready-queue depth: the O(1) load signal the
        # hierarchical steal consults before paying a cross-shard exchange.
        # Updated under _qlen_lock at every enqueue/pop/drain; "approximate"
        # because a reader races with concurrent updates — the exchange
        # threshold absorbs that slack (a stale read can only delay or
        # trigger one extra exchange, never corrupt a queue).
        self._qlen = [0] * (n_shards or 1)
        self._qlen_lock = threading.Lock()
        # Guard timeout for parked workers.  Idle workers no longer
        # sleep-poll: they park on a Condition signalled whenever work is
        # enqueued/distributed (so wake-up latency is a notify, not a poll
        # period) and this timeout is only the belt-and-braces recheck
        # interval — parked workers burn ~20 wake-ups/s, not ~100k.
        self.park_timeout_s = park_timeout_s
        self._rngs = [random.Random(seed * 7919 + i) for i in range(spec.n_workers)]
        n = spec.n_workers
        self._ready: list[deque] = [deque() for _ in range(n)]
        self._assembly: list[deque] = [deque() for _ in range(n)]
        self._qlocks = [threading.Lock() for _ in range(n)]
        self._alocks = [threading.Lock() for _ in range(n)]
        self._work_cv = threading.Condition()
        self._work_epoch = 0        # bumped under _work_cv on every signal
        self._n_parked = 0
        self._done = threading.Event()
        self._total = 0
        self._error: BaseException | None = None
        self._t0 = 0.0
        self._busy = [0.0] * n                 # per-worker busy seconds
        self._trace: list[TraceRecord] = []    # workload-mode trace
        self._wl_stats: dict | None = None     # dag_id -> DagStats
        self._stats_lock = threading.Lock()
        self._total_lock = threading.Lock()    # rejection-time target shrink
        self._gate = None                      # workload-mode admission gate
        self._preempt = None                   # workload-mode controller
        self._running_execs: dict[TAO, _TaoExec] = {}
        self._occupied_slots = 0               # member sum of running execs
        self._run_lock = threading.Lock()      # guards the two above
        self._backlog_ns: dict[str, int] = {}  # tenant -> admitted-not-done
        #                                        TAOs (under _stats_lock)
        self._throttled_ns: dict[str, int] = {}  # tenant -> pending
        #                             dominance-DELAYed arrivals (ditto)
        self._tenant_of: dict[int, str] = {}   # dag_id -> tenant
        self._threads: list[threading.Thread] = []
        # chaos state (injector thread writes, workers read; the set object
        # is mutated in place so claim loops can hold one reference).  A
        # dead worker parks and refuses ready pops / steals / chunk claims
        # but still drains memberships already assembled on it, so
        # remaining_members reaches zero and the TAO commits or requeues.
        self._dead_workers: set[int] = set()
        self._speed_scale = [1.0] * n          # DEGRADE sleep-scaling
        self._chaos = None                     # active ChaosPlan or None
        self._scratch: bytearray | None = None  # measured-transfer buffer

    # ------------------------------------------------------------------ admin
    def _begin_run(self, total: int) -> None:
        """Per-run reset so one runtime instance supports consecutive runs
        (stale counters otherwise end a second run prematurely: the
        cumulative ``core.completed`` is compared against the new total)."""
        # a worker that outlived a timed-out run (blocked inside a chunk)
        # must not be revived by the _done.clear() below — it would commit
        # stale TAOs into the new run's counters/queues; refuse to start
        # until the old pool has genuinely exited
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=5.0)
                if t.is_alive():
                    raise RuntimeError(
                        "a worker thread from the previous (timed-out) run "
                        "is still executing its chunk; this runtime cannot "
                        "start a new run until that work returns")
        self._threads = []
        self.core.reset_counters()
        self._total = total
        self._gate = None
        self._preempt = None
        self._running_execs = {}
        self._occupied_slots = 0
        self._backlog_ns = {}
        self._throttled_ns = {}
        self._tenant_of = {}
        self._dead_workers = set()
        self._speed_scale = [1.0] * self.spec.n_workers
        self._chaos = None
        self.core.set_dead(frozenset())
        self._done.clear()
        self._error = None
        self._trace = []
        self._wl_stats = None
        self._busy = [0.0] * self.spec.n_workers
        for q in self._ready:       # drop leftovers from a timed-out run
            q.clear()
        for q in self._assembly:
            q.clear()
        self._qlen = [0] * (self.n_shards or 1)
        self._t0 = time.perf_counter()

    def _signal_work(self) -> None:
        """New work (or shutdown) exists: wake parked workers.

        The epoch counter pairs with the read at the top of the worker loop
        to close the classic missed-wakeup race: a worker only parks if the
        epoch is unchanged since *before* it scanned the queues, so work
        published after its scan always either bumps the epoch first (the
        park is skipped) or is found by the scan."""
        with self._work_cv:
            self._work_epoch += 1
            if self._n_parked:
                self._work_cv.notify_all()

    def _set_done(self) -> None:
        self._done.set()
        self._signal_work()

    def _enqueue_ready(self, tao: TAO, waker: int) -> None:
        placement = self.core.admit(tao, waker)
        target = placement.target
        dead = self._dead_workers
        if dead and target in dead:
            # a dead worker never pops its ready deque: redirect to the next
            # alive worker (steals still rescue anything that races past
            # this check, so the redirect is a latency fix, not correctness)
            n = self.spec.n_workers
            for off in range(1, n):
                c = (target + off) % n
                if c not in dead:
                    target = c
                    break
        with self._qlocks[target]:
            self._ready[target].append(tao)
        if self.n_shards is not None:
            s = self.core.shard_of_worker[target]
            with self._qlen_lock:
                self._qlen[s] += 1
        self._signal_work()
        # preemption consult point 1: a ready TAO may displace running work
        # (consulted after the enqueue so freed workers find it queued).
        # The cheap wants_consult pre-gate keeps the unsaturated hot path
        # from materializing views/backlog on every enqueue.
        if self._preempt is not None:
            with self._run_lock:
                occupied = self._occupied_slots
            signals = self.core.admission_signals()
            if self._preempt.wants_consult(signals, occupied):
                tenant = self._tenant_of.get(tao.dag_id, "default")
                victims = self._preempt.on_ready(
                    tao, tenant, self._running_views(), signals,
                    self._tenant_backlog(), self._throttled())
                self._yield_victims(victims)

    # -------------------------------------------------------- preemption
    def _tenant_backlog(self) -> dict:
        """Per-tenant admitted-but-uncompleted TAO counts — the
        SLO-dominance signal controllers measure against.  Maintained as
        O(1) incremental counters (admission adds ``n_taos``, every TAO
        commit subtracts one) so the hot consult path never scans the
        per-DAG stats table."""
        with self._stats_lock:
            return dict(self._backlog_ns)

    def _throttled(self) -> frozenset | None:
        """Tenants the gate currently holds at the door for *dominating*
        the backlog (``AdmissionDecision.dominant`` delays pending
        re-presentation); ``None`` on ungated runs."""
        if self._gate is None:
            return None
        with self._stats_lock:
            return frozenset(t for t, c in self._throttled_ns.items() if c > 0)

    def _running_views(self) -> list[RunningView]:
        """Controller-facing snapshot of the running set (sorted by the
        deterministic (dag_id, tao_id) key both vehicles share)."""
        cap = self._preempt.max_preemptions
        with self._run_lock:
            execs = list(self._running_execs.values())
        views = []
        for ex in execs:
            views.append(RunningView.of(
                ex.tao, self._tenant_of.get(ex.tao.dag_id, "default"),
                ex.leader, len(ex.members), self._eligible(ex, cap),
                members=tuple(ex.members)))
        return sorted_views(views)

    @staticmethod
    def _eligible(ex: _TaoExec, cap: int) -> bool:
        """May this execution be displaced?  No yield pending, chunks left
        for a continuation, at least one chunk claimed *this segment* (the
        simulator's progress guarantee: a claimed chunk always completes,
        so no displacement can be zero-progress — this also excludes
        single-chunk TAOs, matching the sim's n_seg >= 2 rule), and the
        per-TAO displacement cap not yet reached."""
        nxt, yld, pre = ex.cursor.snapshot()
        return (not yld and nxt < ex.cursor.n_chunks
                and nxt > ex.start_claims and pre < cap)

    def _yield_victims(self, victims) -> None:
        """Flip the cooperative yield flag on victims still running.

        Eligibility is re-checked under ``_run_lock`` against the exec
        *currently* registered for the TAO: between the controller's view
        snapshot and this flip the victim may have finished, or been
        displaced and re-registered as a new segment — blindly flipping
        would bypass the preemptible guard and the max_preemptions cap."""
        if not victims:
            return
        cap = self._preempt.max_preemptions
        with self._run_lock:
            for v in victims:
                ex = self._running_execs.get(v.tao)
                if ex is not None and self._eligible(ex, cap):
                    ex.cursor.request_yield()

    def _requeue_preempted(self, ex: _TaoExec, worker: int) -> None:
        """Last member of a yielded execution: repackage the unclaimed
        chunks as a continuation and requeue through the normal admit
        path (fresh molding/placement)."""
        tao, cursor = ex.tao, ex.cursor
        now_rel = time.perf_counter() - self._t0
        cursor.rearm()                      # reopen claims + count displacement
        cursor.preempted_at = now_rel
        if self._wl_stats is not None:
            with self._stats_lock:
                self._trace.append(TraceRecord(
                    tao.id, tao.type, ex.leader, ex.width,
                    ex.start_time - self._t0, now_rel, tuple(ex.members),
                    dag_id=tao.dag_id, preempted=True,
                    impl=tao.assigned_impl))
                st = self._wl_stats.get(tao.dag_id)
                if st is not None:
                    st.record_preemption()
        self.core.release(tao)              # undo admit-time accounting
        self._enqueue_ready(tao, waker=worker)

    def _requeue_failed(self, ex: _TaoExec, worker: int) -> None:
        """Last member of an execution whose claimers died: re-admit the
        unclaimed chunks as a continuation.  Unlike a policy displacement
        this spends no preemption budget and feeds no damping — the TAO
        was not displaced, its workers were killed under it."""
        tao, cursor = ex.tao, ex.cursor
        now_rel = time.perf_counter() - self._t0
        cursor.rearm(count_displacement=False)
        cursor.preempted_at = now_rel
        if self._wl_stats is not None:
            with self._stats_lock:
                self._trace.append(TraceRecord(
                    tao.id, tao.type, ex.leader, ex.width,
                    ex.start_time - self._t0, now_rel, tuple(ex.members),
                    dag_id=tao.dag_id, preempted=True,
                    impl=tao.assigned_impl))
                st = self._wl_stats.get(tao.dag_id)
                if st is not None:
                    st.record_failure_requeue()
        self.core.release(tao, count_displacement=False)
        self._enqueue_ready(tao, waker=worker)

    _COPY_CAP = 1 << 26   # 64 MiB: misses pay the real copy up to this cap

    def _measured_copy(self, nbytes: float) -> tuple[float, float]:
        """Timed host byte-copy standing in for a cross-cluster device-put.

        Copies ``min(nbytes, _COPY_CAP)`` bytes and returns
        ``(bytes_copied, elapsed_s)`` — the tracker normalizes to
        seconds-per-byte, so a capped copy still yields the true rate
        while bounding the probe's cost on pathological footprints; below
        the cap a miss genuinely pays the full move on the popping
        worker's wall clock, the physics the affinity A/B measures."""
        n = int(min(max(nbytes, 1.0), self._COPY_CAP))
        buf = self._scratch
        if buf is None or len(buf) < n:
            buf = self._scratch = bytearray(n)
        t0 = time.perf_counter()
        bytes(memoryview(buf)[:n])
        return float(n), max(time.perf_counter() - t0, 1e-9)

    def _dpa_distribute(self, tao: TAO, popper: int) -> None:
        """Dynamic Place Allocation: push into members' assembly queues."""
        width = tao.assigned_width
        # sharded cores fold the place into the popper's shard (a place
        # never spans shards); unsharded this is exactly leader_of()
        leader = self.core.leader_for(popper, width)
        # the *popper* determines the real place (a steal moves the TAO), so
        # this — not admission — is where the leader becomes truthful; the
        # impl follows the same rule for multi-variant TAOs (re-picked for
        # the realized leader's cells; single-variant TAOs and continuations
        # pass through unchanged)
        tao.assigned_leader = leader
        self.core.rebind_impl(tao, leader)
        # data-aware accounting at the realized leader: exactly one
        # tracker.place per dispatch, and each dispatch yields exactly one
        # trace record (final, or preempted via the requeue paths) — the
        # replay_moved_bytes conservation contract.  A miss pays a *measured*
        # host byte-copy (the device-put analogue on this vehicle) that
        # feeds the per-(class, src, dst) movement table.
        fp = tao.footprint
        if fp is not None:
            loc = self.core.locality
            fp_src = fp.resident
            fp_hit, fp_moved, _ = loc.place(tao.type, fp, leader)
            if not fp_hit:
                n_copied, copy_s = self._measured_copy(fp_moved)
                loc.record_transfer(tao.type, fp_src, loc.cluster_of(leader),
                                    n_copied, copy_s)
            if self._wl_stats is not None:
                st_fp = self._wl_stats.get(tao.dag_id)
                if st_fp is not None:
                    with self._stats_lock:
                        st_fp.record_locality(fp_hit, fp_moved)
        # snapshot the dead set: membership (and remaining_members) must be
        # consistent for this segment even if a kill lands mid-distribute —
        # a member that dies after assembly drains via the zero-claim exit
        ex = _TaoExec(tao, leader, width, self.spec.n_workers,
                      dead=tuple(self._dead_workers), popper=popper,
                      members=self.core.members_for(leader, width))
        ex.start_time = time.perf_counter()
        if self._preempt is not None:
            with self._run_lock:
                self._running_execs[tao] = ex
                # occupancy counts the workers the place actually holds
                # (members clipped to the pool), not the nominal width —
                # nominal widths over-report saturation at the pool edge
                self._occupied_slots += len(ex.members)
        if self._wl_stats is not None:
            st = self._wl_stats.get(tao.dag_id)
            if st is not None:
                rel = ex.start_time - self._t0
                with self._stats_lock:
                    if rel < st.started:
                        st.started = rel
                    if ex.cursor.preempted_at is not None:
                        # RESUME: the continuation reached a place again
                        st.preemption_delay += rel - ex.cursor.preempted_at
                        ex.cursor.preempted_at = None
        for m in ex.members:
            with self._alocks[m]:
                self._assembly[m].append(ex)
        self._signal_work()

    # ------------------------------------------------------------- worker loop
    def _execute_chunks(self, ex: _TaoExec, worker: int) -> None:
        # dispatch the variant chosen at admit time; payload_for falls back
        # to TAO.work for legacy single-variant TAOs.  Variant payloads
        # share the TAO's chunk structure (the ChunkCursor is
        # variant-agnostic), so a continuation resumes the same impl's
        # chunks — admit pins assigned_impl for continuations.
        work: ChunkedWork = (ex.tao.payload_for(ex.tao.assigned_impl)
                             or ChunkedWork(lambda i: None, 1))
        cursor = ex.cursor
        is_leader = worker == ex.leader
        if is_leader:
            ex.leader_start = time.perf_counter()
        dead = self._dead_workers
        chaos = self._chaos is not None
        while True:
            # death point: a killed worker refuses further claims (its
            # in-flight chunk — claimed before the kill landed — already
            # completed, preserving exactly-once chunk execution)
            if dead and worker in dead:
                break
            # yield point: claims stop once a controller requested a yield,
            # so a displaced TAO halts after its in-flight chunks
            i = cursor.claim()
            if i is None:
                break
            if chaos:
                # DEGRADE sleep-scaling: a chunk that took dt at full speed
                # takes dt/s on a worker degraded to speed s
                t_c = time.perf_counter()
                work.chunk_fn(i)
                s = self._speed_scale[worker]
                if s < 1.0:
                    time.sleep((time.perf_counter() - t_c) * (1.0 / s - 1.0))
            else:
                work.chunk_fn(i)
        # Snapshot the yield state BEFORE the member-exit decrement: once
        # we decrement, the last member may requeue the continuation and
        # rearm() the cursor, clearing the flag — a non-last leader that
        # read it afterwards would mistake its partial segment for a full
        # one and record it into the PTT.
        nxt, yld, _pre = cursor.snapshot()
        preempted = yld and nxt < cursor.n_chunks
        # member leaves; the LAST one runs commit-and-wakeup (paper §3.2)
        with ex.lock:
            ex.remaining_members -= 1
            last = ex.remaining_members == 0
        if is_leader and not preempted and not (dead and worker in dead):
            # leader-only PTT record; a preempted segment's elapsed covers
            # partial work mid-displacement and is skipped.  A
            # continuation's completing segment records as-is: it
            # understates a full TAO, but dropping it starves the model
            # and scaling by the chunk ratio destabilized placement
            # learning (see the simulator's matching comment) — the bias
            # is marginal (continuations are rare, capped by
            # max_preemptions) and policies' ratio signals are unbiased.
            elapsed = time.perf_counter() - ex.leader_start
            self.core.record_time(ex.tao, ex.leader, ex.width, max(elapsed, 1e-9))
        if last:
            if self._preempt is not None:
                with self._run_lock:
                    if self._running_execs.pop(ex.tao, None) is not None:
                        self._occupied_slots -= len(ex.members)
            if cursor.unclaimed > 0:
                # chunks left with nobody claiming them: either a controller
                # yielded the TAO, or every remaining claimer died.  Both
                # repackage the unclaimed chunks as a continuation through
                # release->admit; only the policy displacement spends the
                # preemption budget and feeds damping.
                if cursor.yield_requested:
                    self._requeue_preempted(ex, worker)
                else:
                    self._requeue_failed(ex, worker)
                return
            if cursor.yield_requested:
                cursor.clear_yield()   # yield raced with the final claim
            end_rel = time.perf_counter() - self._t0
            for child in self.core.commit_and_wakeup(ex.tao):
                self._enqueue_ready(child, waker=worker)
            if self._wl_stats is not None:
                self._record_completion(ex, end_rel)
            if self.core.completed >= self._total:
                self._set_done()

    def _record_completion(self, ex: _TaoExec, end_rel: float) -> None:
        """Workload-mode accounting: per-DAG table + trace record."""
        tao = ex.tao
        dag_done = None
        with self._stats_lock:
            self._trace.append(TraceRecord(
                tao.id, tao.type, ex.leader, ex.width,
                ex.start_time - self._t0, end_rel, tuple(ex.members),
                dag_id=tao.dag_id, impl=tao.assigned_impl))
            st = self._wl_stats.get(tao.dag_id)
            if st is not None:
                st.record_completion(end_rel)
                left = self._backlog_ns.get(st.tenant)
                if left is not None:
                    self._backlog_ns[st.tenant] = left - 1
                if st.done:
                    dag_done = st
        # gate feedback outside _stats_lock (gates lock internally; the
        # admitter thread's decide() must not wait on stats accounting)
        if dag_done is not None and self._gate is not None:
            self._gate.on_dag_done(dag_done.tenant, dag_done.sojourn, end_rel,
                                   n_taos=dag_done.n_taos)

    def _discount_total(self, n_taos: int) -> None:
        """A rejected DAG's TAOs will never execute: shrink the completion
        target, and finish the run if the remaining work is already done
        (workers re-check after each commit, the admitter after each
        rejection — between them the done transition cannot be missed)."""
        with self._total_lock:
            self._total -= n_taos
            if self.core.completed >= self._total:
                self._set_done()

    def _try_assembly(self, worker: int) -> bool:
        with self._alocks[worker]:
            ex = self._assembly[worker].popleft() if self._assembly[worker] else None
        if ex is None:
            return False
        t_in = time.perf_counter()
        self._execute_chunks(ex, worker)
        self._busy[worker] += time.perf_counter() - t_in
        return True

    def _try_ready(self, worker: int, victim: int) -> bool:
        with self._qlocks[victim]:
            dq = self._ready[victim]
            if not dq:
                return False
            tao = dq[0]
            # affinity gate on the steal path: leave a footprint TAO queued
            # on its resident cluster for that cluster's (alive) workers —
            # rescue steals off dead victims still pass and pay the move in
            # _dpa_distribute.  Zero-footprint TAOs always pass (legacy
            # schedules untouched); the worker's own deque is never gated.
            if (worker != victim and victim not in self._dead_workers
                    and self.core.locality.steal_gated(
                        tao.footprint, worker, victim)):
                return False
            dq.popleft()
        if self.n_shards is not None:
            s = self.core.shard_of_worker[victim]
            with self._qlen_lock:
                self._qlen[s] -= 1
        self._dpa_distribute(tao, popper=worker)
        return True

    def _steal_once(self, worker: int, rng) -> bool:
        """One steal attempt per scan (paper §5).

        Unsharded: a uniform draw over the other ``n - 1`` workers, as
        before.  Sharded: hierarchical — the draw stays inside the worker's
        own shard (locality: no cross-shard queue traffic while the shard
        has work); only when some other shard's approximate queue depth
        exceeds this shard's by the exchange threshold does the attempt go
        cross-shard.  That cross-shard pop is a *work exchange*: counted on
        the core (conservation-audited) and paying the data-movement cost
        in ``_dpa_distribute`` for any footprint it migrates."""
        n = self.spec.n_workers
        if self.n_shards is None:
            victim = rng.randrange(n - 1)
            if victim >= worker:
                victim += 1
            return self._try_ready(worker, victim)
        core = self.core
        s = core.shard_of_worker[worker]
        home = core.shards[s].workers
        if len(home) > 1:
            li = core.shards[s].local_of[worker]
            v = rng.randrange(len(home) - 1)
            if v >= li:
                v += 1
            if self._try_ready(worker, home[v]):
                return True
        if core.n_shards > 1:
            with self._qlen_lock:
                qlen = list(self._qlen)
            best = qlen[s] + core.exchange_threshold - 1
            donor = -1
            for d in range(core.n_shards):
                if d != s and qlen[d] > best:
                    best, donor = qlen[d], d
            if donor >= 0:
                dw = core.shards[donor].workers
                victim = dw[rng.randrange(len(dw))]
                imbalance = qlen[donor] - qlen[s]
                if self._try_ready(worker, victim):
                    core.note_exchange(donor, s, imbalance)
                    return True
        return False

    def _worker_loop(self, worker: int) -> None:
        rng = self._rngs[worker]
        n = self.spec.n_workers
        try:
            while not self._done.is_set():
                # epoch read precedes the queue scans (see _signal_work)
                epoch = self._work_epoch
                # 1) assembly work (TAOs already placed on me).  A dead
                #    worker still drains these — with claims refused it is
                #    a zero-work membership exit, which is what lets
                #    remaining_members reach zero and the TAO commit or
                #    requeue instead of hanging on the corpse.
                if self._try_assembly(worker):
                    continue
                if not self._dead_workers or worker not in self._dead_workers:
                    # 2) my own ready deque (locality)
                    if self._try_ready(worker, worker):
                        continue
                    # 3) one steal attempt, interleaved with the local
                    #    checks (paper §5) — intra-shard first, cross-shard
                    #    only on threshold imbalance (see _steal_once).
                    #    (Stealing FROM a dead worker's deque is allowed:
                    #    it rescues anything stranded there.)
                    if n > 1 and self._steal_once(worker, rng):
                        continue
                # 4) nothing anywhere: park until new work is signalled.
                #    On wake-up the loop re-runs the local checks before the
                #    next steal, preserving the paper's one-steal-per-scan
                #    discipline while parked workers burn ~0 CPU.
                with self._work_cv:
                    if self._work_epoch == epoch and not self._done.is_set():
                        self._n_parked += 1
                        self._work_cv.wait(timeout=self.park_timeout_s)
                        self._n_parked -= 1
        except BaseException as e:  # surface worker crashes to run()
            self._error = e
            self._set_done()

    # ------------------------------------------------------------------ run
    def _run_workers(self, timeout_s: float) -> float:
        """Spawn the worker pool, wait for completion, join, re-raise.

        Returns the elapsed wall-clock since ``_begin_run`` set ``_t0``."""
        threads = [
            threading.Thread(target=self._worker_loop, args=(i,), daemon=True)
            for i in range(self.spec.n_workers)
        ]
        self._threads = threads
        for t in threads:
            t.start()
        finished = self._done.wait(timeout=timeout_s)
        elapsed = time.perf_counter() - self._t0
        self._set_done()
        for t in threads:
            t.join(timeout=5.0)
        if self._error is not None:
            raise self._error
        if not finished:
            raise TimeoutError(
                f"run did not complete in {timeout_s}s "
                f"({self.core.completed}/{self._total} TAOs)")
        return elapsed

    def run(self, dag: TaoDag, timeout_s: float = 600.0) -> dict:
        """Execute one DAG offline (all roots ready at t=0)."""
        self._begin_run(len(dag))
        roots = self.core.prepare(dag)
        for r in roots:
            self._enqueue_ready(r, waker=0)
        elapsed = self._run_workers(timeout_s)
        return {
            "elapsed_s": elapsed,
            "throughput_taos_per_s": self._total / elapsed if elapsed > 0 else 0.0,
            "completed": self.core.completed,
        }

    # ------------------------------------------------------------- workload
    def _admit_arrivals(self, arrivals: list, gate=None) -> None:
        """Timer thread: release each DAG's roots at its wall-clock offset,
        consulting the admission gate (if any) first.

        DELAY verdicts re-queue the arrival at the gate's ``retry_at`` in a
        local (time, seq) heap — the same ordering the simulator's event
        queue gives gate re-evaluations, so a trace-deterministic gate
        (token-bucket) decides identically on both vehicles.  REJECT
        verdicts mark the DAG's stats row and shrink the completion target.
        """
        from .admission import DELAY, REJECT, AdmissionRequest
        pending = [(arr.at, i, arr, None) for i, arr in enumerate(arrivals)]
        heapq.heapify(pending)
        seq = itertools.count(len(arrivals))
        # requests whose pending DELAY was dominance-driven (counted in
        # _throttled_ns until re-presented); admitter-thread local
        counted: set[int] = set()
        try:
            while pending:
                delay = pending[0][0] - (time.perf_counter() - self._t0)
                if delay > 0 and self._done.wait(timeout=delay):
                    return          # run ended (error/timeout) mid-stream
                if self._done.is_set():
                    return
                _, _, arr, req = heapq.heappop(pending)
                now = time.perf_counter() - self._t0
                if req is not None and id(req) in counted:
                    counted.discard(id(req))
                    with self._stats_lock:
                        self._throttled_ns[req.tenant] -= 1
                if gate is not None:
                    if req is None:
                        req = AdmissionRequest(
                            dag_id=arr.dag_id, tenant=arr.tenant,
                            n_taos=len(arr.dag), arrival=arr.at)
                    verdict = gate.decide(req, now,
                                          self.core.admission_signals())
                    if verdict.action == DELAY:
                        req.attempts += 1
                        if verdict.dominant:
                            counted.add(id(req))
                            with self._stats_lock:
                                self._throttled_ns[req.tenant] = \
                                    self._throttled_ns.get(req.tenant, 0) + 1
                        # preemption consult point 2 (gate feedback): the
                        # gate throttled this tenant *for dominating the
                        # backlog* — displace its in-flight work too (a
                        # tenant delayed for its own degraded p99 is a
                        # victim, not a cause, and is never forwarded)
                        if self._preempt is not None and verdict.dominant:
                            self._yield_victims(self._preempt.on_gate_feedback(
                                req.tenant, self._running_views(),
                                self.core.admission_signals(),
                                self._tenant_backlog()))
                        # strictly-future retry so a zero-quantum gate
                        # cannot spin this thread
                        retry = max(verdict.retry_at, now + 1e-4)
                        heapq.heappush(pending,
                                       (retry, next(seq), arr, req))
                        continue
                    if verdict.action == REJECT:
                        with self._stats_lock:
                            self._wl_stats[arr.dag_id].mark_rejected()
                        gate.on_reject(req, now)
                        self._discount_total(len(arr.dag))
                        continue
                    gate.on_admit(req, now)
                with self._stats_lock:
                    self._wl_stats[arr.dag_id].mark_admitted(now)
                    self._backlog_ns[arr.tenant] = \
                        self._backlog_ns.get(arr.tenant, 0) + len(arr.dag)
                # deferred payload binding: materialize real ChunkedWork
                # closures only for DAGs that actually got in (rejected
                # arrivals never reach this point, so never pay for them)
                if arr.bind is not None:
                    arr.bind(arr.dag)
                roots = self.core.prepare(arr.dag, dag_id=arr.dag_id)
                for r in roots:
                    self._enqueue_ready(r, waker=0)
        except BaseException as e:  # surface admission crashes to run_workload
            self._error = e
            self._set_done()

    def _inject_chaos(self, plan) -> None:
        """Injector thread: apply each :class:`~repro.core.chaos.ChaosEvent`
        at its wall-clock offset relative to run start.

        KILL marks workers dead (they park and refuse claims; memberships
        already assembled drain as zero-claim exits), masks them out of
        placement via ``core.set_dead`` and drains their stranded ready
        TAOs back through release->admit.  DEGRADE sets the sleep-scale
        chunk multiplier.  RECOVER undoes both."""
        from .chaos import DEGRADE, KILL
        n = self.spec.n_workers
        try:
            for ev in plan.events:
                delay = ev.at - (time.perf_counter() - self._t0)
                if delay > 0 and self._done.wait(timeout=delay):
                    return          # run ended mid-plan
                if self._done.is_set():
                    return
                if ev.action == DEGRADE:
                    for w in ev.workers:
                        if w < n and w not in self._dead_workers:
                            self._speed_scale[w] = ev.speed
                    continue
                if ev.action == KILL:
                    newly = [w for w in ev.workers
                             if w < n and w not in self._dead_workers]
                    for w in newly:
                        self._dead_workers.add(w)
                        self._speed_scale[w] = 1.0
                    self.core.set_dead(frozenset(self._dead_workers))
                    # stranded ready TAOs go back through release->admit so
                    # placement sees the shrunken fleet (steals would rescue
                    # them eventually; this bounds the latency and lets the
                    # policy re-place with the dead mask applied)
                    for w in newly:
                        with self._qlocks[w]:
                            stranded = list(self._ready[w])
                            self._ready[w].clear()
                        if stranded and self.n_shards is not None:
                            sw = self.core.shard_of_worker[w]
                            with self._qlen_lock:
                                self._qlen[sw] -= len(stranded)
                        for tao in stranded:
                            if self._wl_stats is not None:
                                with self._stats_lock:
                                    st = self._wl_stats.get(tao.dag_id)
                                    if st is not None:
                                        st.record_failure_requeue()
                            self.core.release(tao, count_displacement=False)
                            self._enqueue_ready(tao, waker=w)
                    self._signal_work()   # dead workers wake to drain
                    continue
                # RECOVER: clear both kill and degrade state
                for w in ev.workers:
                    if w < n:
                        self._dead_workers.discard(w)
                        self._speed_scale[w] = 1.0
                self.core.set_dead(frozenset(self._dead_workers))
                self._signal_work()
        except BaseException as e:  # surface injector crashes to run_workload
            self._error = e
            self._set_done()

    def run_workload(self, workload, timeout_s: float = 600.0,
                     admission=None, preemption=None, chaos=None):
        """Execute a multi-DAG arrival stream on the live worker pool.

        The same contract as :meth:`Simulator.run_workload`: DAGs are
        admitted at their ``DagArrival.at`` offsets (here: real wall-clock
        seconds after the run starts), nodes are namespaced via
        ``SchedulerCore.prepare(dag, dag_id)``, and the returned
        ``WorkloadResult`` carries the per-DAG latency table (arrival /
        queue delay / makespan / sojourn, all relative to run start) plus
        the executed trace.  ``admission`` is an optional
        :class:`~repro.core.admission.AdmissionGate` consulted by the
        admitter thread; rejected DAGs appear in the table with
        ``rejected=True`` and none of their TAOs ever reach a worker.
        ``preemption`` is an optional
        :class:`~repro.core.preemption.PreemptionController`: victims it
        names get a cooperative yield flag, stop at their next chunk
        boundary, and are requeued as continuations (``None`` — the
        default — never displaces and schedules exactly as before).
        ``chaos`` is an optional :class:`~repro.core.chaos.ChaosPlan`
        applied by an injector thread at wall-clock offsets (``None``
        or an empty plan injects nothing and schedules as before)."""
        from .workload import DagStats, WorkloadResult
        arrivals = workload.arrivals()
        total = workload.total_taos()
        self._begin_run(total)
        self._gate = admission
        if chaos:
            self._chaos = chaos
        tenant_of = {a.dag_id: a.tenant for a in arrivals}
        # displacement damping aggregates per tenant (reset_counters in
        # _begin_run cleared the previous run's mapping and history)
        self.core.set_tenants(tenant_of)
        if preemption is not None:
            preemption.prepare(self.spec)
            preemption.reset()
            self._tenant_of = tenant_of
        self._preempt = preemption
        stats = {
            a.dag_id: DagStats.for_arrival(a.dag_id, a.name, a.at,
                                           len(a.dag), tenant=a.tenant,
                                           tokens=a.tokens)
            for a in arrivals
        }
        self._wl_stats = stats
        live = [a for a in arrivals if len(a.dag) > 0]
        if live:
            admitter = threading.Thread(target=self._admit_arrivals,
                                        args=(live, admission), daemon=True)
            injector = None
            if self._chaos is not None:
                injector = threading.Thread(target=self._inject_chaos,
                                            args=(self._chaos,), daemon=True)
                injector.start()
            admitter.start()
            try:
                elapsed = self._run_workers(timeout_s)
            finally:
                self._set_done()
                admitter.join(timeout=5.0)
                if injector is not None:
                    injector.join(timeout=5.0)
        else:
            elapsed = 0.0
        n = self.spec.n_workers
        completed = self.core.completed
        result = WorkloadResult(
            makespan=elapsed,
            throughput=completed / elapsed if elapsed > 0 else 0.0,
            completed=completed,
            utilization=sum(self._busy) / (elapsed * n) if elapsed > 0 else 0.0,
            trace=list(self._trace),
            per_dag=stats,
        )
        if self.n_shards is not None:
            result.exchanges = self.core.exchange_stats()
        return result
