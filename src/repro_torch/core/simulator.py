"""Deterministic discrete-event simulator for mixed-mode DAG scheduling.

The paper's claims are about *scheduling* (which core class, which width, how
much interference) — so alongside the threaded runtime we provide an
event-driven simulator that executes the exact same ``SchedulerCore`` +
``Policy`` objects against a calibrated performance model.  This is also how
the framework demonstrates policy behaviour at 1000+ worker scale
(a fleet of device groups), which no laptop can run threaded.

Worker/execution model
----------------------
* Every worker has a class ('big'/'little') and a per-kernel speed factor
  (LITTLE == 1.0).
* A TAO of width w runs on the place ``[leader, leader+w)``.  Members join
  asynchronously as they become free (XiTAO's assembly-queue semantics); the
  finish time solves the water-filling equation
  ``sum_m r_m * (T_end - join_m) = W`` over the members that join before
  T_end, where ``r_m`` is the member's effective processing rate and ``W``
  the TAO's work in reference-worker-seconds.
* Kernel classes carry the paper's Fig-4 behaviours: *matmul* scales linearly
  and is 2.4x faster on big; *sort* has a mergesort reduction (sub-linear
  efficiency) and mild cache interference; *copy* is capped by a per-cluster
  bandwidth pool that a single big core nearly saturates.
* Interference is sampled at TAO start (concurrent streaming / same-type TAOs
  per cluster) — a snapshot approximation of contention.

Work stealing: ready TAOs are pushed to the policy's target worker; idle
workers first pop locally then steal from a uniformly random non-empty victim
(paper §5: "uniform random work stealing ... interleaved with one check of
the local queues").

Admission control: ``run_workload(..., admission=gate)`` routes every DAG
arrival through an :class:`~repro.core.admission.AdmissionGate` before its
roots are enqueued — DELAY verdicts become future ARRIVE events at the
gate's ``retry_at``, REJECT verdicts mark the DAG in the per-DAG table and
discard it without a single TAO reaching a worker.  The same gate protocol
drives :meth:`repro.core.runtime.ThreadedRuntime.run_workload`, keeping the
two vehicles comparable on one gated stream.

Preemption: ``run_workload(..., preemption=controller)`` consults a
:class:`~repro.core.preemption.PreemptionController` when a ready TAO finds
no slot and on gate DELAY feedback.  A victim gets a **PREEMPT** event at
its next chunk boundary (boundaries are modeled uniform over the segment's
water-filled span; at least one chunk per segment completes): the segment
is truncated there, its members freed and their un-run busy time returned,
the TAO's :class:`~repro.core.preemption.ChunkCursor` advanced to the
boundary, and a same-timestamp **RESUME** event (seq-ordered after the
freed members re-dispatch — the deterministic tie-break) re-admits the
continuation through ``SchedulerCore.release`` + the normal ``admit``
path, with molding free to choose a new (leader, width).  A preempted
segment's COMPLETE event is stale and skipped; with ``preemption=None``
(default) no cursor is ever created and schedules are byte-identical to
the pre-preemption behavior.

Thread-safety contract: the simulator is strictly single-threaded — one
event loop mutates all state (queues, free times, interference counters,
DagStats) without locks; only the shared ``SchedulerCore``/PTT objects it
drives carry locks (they are also driven by the threaded vehicle).  Never
run one Simulator instance from two threads.

Fast/slow-path invariant: ``fast_dispatch`` (bitmask idle/non-empty sets,
O(1) interference counters, O(k) water-filling) and the PTT's
``fast_query`` change *data structures only* — for the same seed the fast
and slow paths schedule byte-identically, which ``benchmarks/perf.py``
asserts as full trace equality in CI.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import random
from collections import deque
from typing import Callable

import numpy as np

from .dag import DEFAULT_IMPL, TAO, TaoDag
from .places import BIG, LITTLE, ClusterSpec
from .policies import Policy
from .preemption import RunningView, ensure_cursor, sorted_views
from .scheduler import SchedulerCore
from .shard import ShardedScheduler


# ---------------------------------------------------------------------------
# Kernel performance models (calibrated to the paper's Fig. 4 profiles)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KernelModel:
    """Execution-time model of one TAO class on the heterogeneous pool."""

    t_ref: float                     # serial time on one LITTLE worker [s]
    speed: dict                      # class -> per-worker speed factor
    efficiency: dict                 # width -> parallel efficiency (0, 1]
    stream: bool = False             # shares the per-cluster BW pool
    bw_cap: dict | None = None       # class -> max aggregate speed (stream only)
    cache_penalty: float = 0.0       # per extra concurrent same-type TAO in cluster

    def eff(self, width: int) -> float:
        if width in self.efficiency:
            return self.efficiency[width]
        # geometric falloff beyond the calibrated widths
        ws = sorted(self.efficiency)
        lo = ws[-1]
        ratio = self.efficiency[lo] / self.efficiency[ws[-2]] if len(ws) > 1 else 1.0
        e = self.efficiency[lo]
        w = lo
        while w < width:
            e *= ratio
            w *= 2
        return max(e, 1e-3)


def paper_kernel_models() -> dict:
    """Models matching §4.2's profiling: compute / data-reuse / streaming."""
    return {
        # compute-bound: linear scaling, big 2.4x faster (paper Fig 4 top)
        "matmul": KernelModel(
            t_ref=0.010,
            speed={BIG: 2.4, LITTLE: 1.0},
            efficiency={1: 1.0, 2: 0.98, 4: 0.96, 8: 0.94},
        ),
        # data-reuse: internal mergesort reduction limits wide scaling; big
        # "only marginally better"; mild shared-L2 interference (Fig 4 middle)
        "sort": KernelModel(
            t_ref=0.010,
            speed={BIG: 1.15, LITTLE: 1.0},
            efficiency={1: 1.0, 2: 0.80, 4: 0.55, 8: 0.35},
            cache_penalty=0.12,
        ),
        # streaming: memory-BW bound; a big core nearly saturates the pool,
        # LITTLE cores are individually far from saturating it (Fig 4 bottom)
        "copy": KernelModel(
            t_ref=0.010,
            speed={BIG: 2.5, LITTLE: 1.0},
            efficiency={1: 1.0, 2: 1.0, 4: 1.0, 8: 1.0},
            stream=True,
            bw_cap={BIG: 3.0, LITTLE: 3.5},
        ),
    }


# ---------------------------------------------------------------------------
# Events & trace records
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TraceRecord:
    tao_id: int
    type: str
    leader: int
    width: int
    start: float
    end: float
    participants: tuple
    dag_id: int = 0     # which admitted DAG (0 = legacy single-DAG runs)
    # True for a segment truncated at a chunk boundary by preemption; the
    # TAO's remaining chunks appear as later records with the same tao_id
    preempted: bool = False
    # implementation variant the segment executed under (DEFAULT_IMPL for
    # legacy single-variant TAOs)
    impl: str = DEFAULT_IMPL


@dataclasses.dataclass
class _Segment:
    """Per-segment bookkeeping a preemption-enabled run keeps for every
    running TAO (absent entirely when ``preemption=None``)."""

    rec: TraceRecord
    t_begin: float            # earliest member join (work actually starts)
    t_end: float              # water-filled completion
    joins: dict               # chosen member -> join time
    n_seg: int                # chunks this segment covers
    chunks_done: int = 0      # boundary a scheduled PREEMPT stops at
    preempt_at: float | None = None
    beneficiary: TAO | None = None   # queued TAO the displacement is for
    ben_target: int = -1             # the queue the beneficiary waits in


_CHUNK = 0xFFFFFFFFFFFFFFFF          # 64-bit window for k-th-bit selection


class _BitSet:
    """Set of worker ids as one int bitmask: O(1)-ish add / discard /
    membership, and ``choice`` = the k-th *smallest* member for a uniform k.

    The simulator's dispatch hot path needs "pick a uniformly random idle
    worker" and "pick a uniformly random steal victim" — the seed path does
    an O(n_workers) scan (``[v for v in range(n) if queues[v]]``) followed by
    ``rng.choice`` / ``rng.choice(sorted(idle))``.  Because ``rng.choice(seq)``
    is exactly ``seq[rng._randbelow(len(seq))]``, picking the k-th smallest
    member with ``k = rng.randrange(len(self))`` consumes the same RNG state
    and returns the very same worker as the seed scan — so the fast dispatch
    path schedules *byte-identically* to ``fast_dispatch=False``, which is
    what lets the perf suite assert trace equality instead of similarity.

    Cost: the mask is a list of 64-bit words, so add / discard / membership
    are O(1) small-int ops at any fleet size (a single big-int mask pays a
    full O(n/64)-word copy per *update* — 12.5 KB per ``idle.discard`` at
    100k workers, and start_tao touches every chosen member); ``choice``
    walks ceil(n/64) words worst-case, all small-int arithmetic.
    """

    __slots__ = ("_words", "_count")

    def __init__(self, items=()):
        self._words: list[int] = []
        self._count = 0
        for v in items:
            self.add(v)

    @classmethod
    def full(cls, n: int) -> "_BitSet":
        """The set {0..n-1} in O(n/64).  State is identical to adding each
        element."""
        bs = cls()
        nw, rem = divmod(n, 64)
        bs._words = [_CHUNK] * nw + ([(1 << rem) - 1] if rem else [])
        bs._count = n
        return bs

    def add(self, v: int) -> None:
        w = v >> 6
        words = self._words
        if w >= len(words):
            words.extend([0] * (w + 1 - len(words)))
        bit = 1 << (v & 63)
        if not words[w] & bit:
            words[w] |= bit
            self._count += 1

    def discard(self, v: int) -> None:
        w = v >> 6
        words = self._words
        if w < len(words):
            bit = 1 << (v & 63)
            if words[w] & bit:
                words[w] ^= bit
                self._count -= 1

    def choice(self, rng: random.Random) -> int:
        k = rng.randrange(self._count)   # same draw as the seed rng.choice
        for i, chunk in enumerate(self._words):
            c = chunk.bit_count()
            if k < c:
                for _ in range(k):       # clear the k lowest set bits
                    chunk &= chunk - 1
                return (i << 6) + (chunk & -chunk).bit_length() - 1
            k -= c
        raise AssertionError("unreachable: k < count by construction")

    def __contains__(self, v: int) -> bool:
        w = v >> 6
        words = self._words
        return w < len(words) and (words[w] >> (v & 63)) & 1 == 1

    def __len__(self) -> int:
        return self._count


class _InterferenceTracker:
    """O(1) interference accounting: running TAOs per (type, cluster-set).

    The seed path rescans every running TAO at each start to count
    same-type neighbours touching the new TAO's clusters — O(running) per
    start.  Counting running TAOs keyed by the *frozenset of clusters they
    touch* makes the query a sum over intersecting keys: with C worker
    classes there are at most 2**C - 1 distinct keys (3 on a big.LITTLE
    pool), so start/finish are O(width) and the query O(1), with counts that
    equal the rescan exactly (same integers -> identical schedules).
    """

    __slots__ = ("_counts",)

    def __init__(self):
        self._counts: dict[str, dict[frozenset, int]] = {}

    def start(self, type_: str, clusters: frozenset) -> None:
        per_set = self._counts.setdefault(type_, {})
        per_set[clusters] = per_set.get(clusters, 0) + 1

    def finish(self, type_: str, clusters: frozenset) -> None:
        per_set = self._counts[type_]
        left = per_set[clusters] - 1
        if left:
            per_set[clusters] = left
        else:
            del per_set[clusters]
            if not per_set:
                del self._counts[type_]

    def query(self, type_: str, clusters: frozenset) -> int:
        per_set = self._counts.get(type_)
        if not per_set:
            return 0
        return sum(c for key, c in per_set.items() if key & clusters)


@dataclasses.dataclass
class SimResult:
    makespan: float
    throughput: float                 # TAOs / s  (the paper's metric)
    completed: int
    utilization: float                # busy worker-seconds / (makespan * n)
    trace: list

    def __repr__(self) -> str:
        return (f"SimResult(makespan={self.makespan:.4f}s, "
                f"throughput={self.throughput:.1f} TAOs/s, "
                f"completed={self.completed}, util={self.utilization:.2%})")


class Simulator:
    """Event-driven executor of a TAO-DAG under a scheduling policy."""

    def __init__(
        self,
        spec: ClusterSpec,
        policy: Policy,
        kernel_models: dict | None = None,
        seed: int = 0,
        fast_dispatch: bool = True,
        fast_query: bool = True,
        n_shards: int | None = None,
        exchange_threshold: int | None = None,
        vectorized: bool = False,
    ):
        self.spec = spec
        if n_shards is None:
            # the default path: one SchedulerCore, untouched by sharding
            self.core = SchedulerCore(spec, policy, seed=seed,
                                      fast_query=fast_query)
        else:
            # sharded scheduling state (repro.core.shard): per-shard ready
            # bitsets replace the global victim scan, so the slow-dispatch
            # baseline has no sharded analogue
            if not fast_dispatch:
                raise ValueError(
                    "sharded dispatch requires fast_dispatch=True")
            kwargs = {}
            if exchange_threshold is not None:
                kwargs["exchange_threshold"] = exchange_threshold
            self.core = ShardedScheduler(spec, policy, n_shards=n_shards,
                                         seed=seed, fast_query=fast_query,
                                         **kwargs)
        self.n_shards = n_shards
        # vectorized=True switches the event loop's per-worker state
        # (free_time, speed multipliers) to numpy arrays and water-fills /
        # rate-caps with array ops — the 100k-worker sweep path.  Float
        # summation order differs from the scalar loop, so it is NOT
        # byte-identical (completions and conservation are, timings agree
        # to float tolerance); the scalar default stays the pinned path.
        self.vectorized = vectorized
        self.models = kernel_models or paper_kernel_models()
        self._seed = seed
        self.rng = random.Random(seed ^ 0x5EED)
        # dynamic per-worker speed multipliers (straggler injection)
        self.speed_mult = [1.0] * spec.n_workers
        self.failed: set = set()
        # fast_dispatch=False keeps the original O(n_workers) victim scan,
        # sorted(idle) choice and running-TAO interference rescan;
        # fast_query=False keeps the PTT's scan queries.  Both slow paths
        # schedule byte-identically to the fast ones — they exist only as
        # the baselines the perf suite (benchmarks/perf.py) measures against.
        self.fast_dispatch = fast_dispatch

    def _model_for(self, type_: str, impl: str) -> KernelModel:
        """Per-impl cost curve: ``models[(type, impl)]`` when calibrated,
        else the type's shared model (single-variant runs never pay more
        than one failed dict probe)."""
        m = self.models.get((type_, impl))
        if m is not None:
            return m
        return self.models[type_]

    def reset_learning(self, seed: int | None = None) -> None:
        """A/B-leg reset: forget learned PTT profiles and adaptive policy
        state, restart *both* RNG streams (core + dispatch), so a run after
        this is byte-identical to one on a freshly-built Simulator.
        Fault/straggler state deliberately survives — it models the
        hardware; call :meth:`reset_faults` separately for pristine metal."""
        s = self._seed if seed is None else seed
        self.core.reset_learning(s)
        self.rng = random.Random(s ^ 0x5EED)

    # -- fault/straggler injection (used by runtime_ft tests) ---------------
    # NOTE: fault state deliberately survives reruns of the same Simulator —
    # it models the *hardware*, not one run (a straggling device group stays
    # slow across workloads).  Call reset_faults() to model repaired metal.
    def set_speed_multiplier(self, worker: int, mult: float) -> None:
        self.speed_mult[worker] = mult

    def fail_worker(self, worker: int) -> None:
        self.failed.add(worker)
        self.speed_mult[worker] = 0.0
        # mask the dead worker out of placement immediately: between the
        # injection and the next event, best_leader/dispatch must already
        # refuse it (the failed-worker-leakage regression)
        self.core.set_dead(frozenset(self.failed))

    def recover_worker(self, worker: int) -> None:
        """Undo :meth:`fail_worker` / :meth:`set_speed_multiplier` for one
        worker (timed chaos RECOVER; also usable directly by tests)."""
        self.failed.discard(worker)
        self.speed_mult[worker] = 1.0
        self.core.set_dead(frozenset(self.failed))

    def reset_faults(self) -> None:
        """Clear injected faults/stragglers (``speed_mult``/``failed``).

        ``SchedulerCore.reset_counters()`` (run at the top of every execute)
        intentionally does NOT touch these: reusing a Simulator keeps its
        injected hardware state, the way the learned PTT is kept.  A caller
        that wants a pristine pool for the next run calls this explicitly."""
        self.speed_mult = [1.0] * self.spec.n_workers
        self.failed.clear()
        self.core.set_dead(frozenset())

    # -- main entry -----------------------------------------------------------
    def run(self, dag, max_events: int | None = None,
            admission=None, preemption=None, chaos=None) -> SimResult:
        """Execute one DAG (offline, arrival at t=0) or a whole ``Workload``
        stream (online arrivals).  Returns a ``WorkloadResult`` (a
        ``SimResult`` subclass) either way; workload runs carry the per-DAG
        latency table in ``result.per_dag``.

        ``max_events`` bounds *all* processed events — TAO completions plus
        one arrival/gate-retry event per DAG, plus one PREEMPT + one RESUME
        per displacement — so budget ``n_taos + n_dags`` (plus expected
        gate re-evaluations and preemptions) when sizing it exactly."""
        from .workload import Workload
        if isinstance(dag, Workload):
            return self.run_workload(dag, max_events=max_events,
                                     admission=admission,
                                     preemption=preemption, chaos=chaos)
        return self._execute([(0.0, 0, dag, "", "default", 0.0, None)],
                             max_events, admission, preemption, chaos)

    def run_workload(self, workload, max_events: int | None = None,
                     admission=None, preemption=None, chaos=None):
        """Execute a multi-DAG arrival stream on the shared pool.

        ``admission`` is an optional
        :class:`~repro.core.admission.AdmissionGate`; ``None`` (default)
        admits everything immediately, byte-identically to the pre-gate
        behavior.  ``preemption`` is an optional
        :class:`~repro.core.preemption.PreemptionController`; ``None``
        (default) never displaces running work and schedules
        byte-identically to the pre-preemption behavior.  ``chaos`` is an
        optional :class:`~repro.core.chaos.ChaosPlan` of timed
        KILL/DEGRADE/RECOVER events executed at virtual-time offsets;
        ``None`` or an empty plan schedules byte-identically to a
        chaos-free run."""
        arrivals = [(a.at, a.dag_id, a.dag, a.name, a.tenant, a.tokens,
                     a.bind)
                    for a in workload.arrivals()]
        return self._execute(arrivals, max_events, admission, preemption,
                             chaos)

    def _execute(self, arrivals: list, max_events: int | None, gate=None,
                 ctrl=None, chaos=None):
        from .admission import DELAY, REJECT, AdmissionRequest
        from .workload import DagStats, WorkloadResult
        # per-run counter reset: a reused Simulator must not report the
        # previous runs' completions in this run's completed/throughput
        self.core.reset_counters()
        n_workers = self.spec.n_workers
        fast = self.fast_dispatch
        vec = self.vectorized
        sharded = self.n_shards is not None
        if sharded:
            # per-shard ready bitsets + O(1) queued-TAO counters: the load
            # signal the hierarchical work exchange thresholds on
            shard_of_worker = self.core.shard_of_worker
            n_shards = self.core.n_shards
            exch_threshold = self.core.exchange_threshold
            nonempty_s = [_BitSet() for _ in range(n_shards)]
            qlen = [0] * n_shards

        if vec:
            free_time = np.zeros(n_workers, dtype=np.float64)
            speed_np = np.asarray(self.speed_mult, dtype=np.float64)
            cls_names = tuple(dict.fromkeys(self.spec.classes))
            code_of = {c: i for i, c in enumerate(cls_names)}
            cls_code = np.array([code_of[c] for c in self.spec.classes])
        else:
            free_time = [0.0] * n_workers
        speed_vecs: dict = {}   # id(model) -> per-worker class-speed vector
        queues = [deque() for _ in range(n_workers)]
        if fast:
            idle = _BitSet.full(n_workers)
            for w in self.failed:
                idle.discard(w)
        else:
            idle = set(range(n_workers)) - self.failed
        # workers whose ready-queue is non-empty (maintained in fast mode so
        # steal-victim selection stops being an O(n_workers) scan)
        nonempty = _BitSet()
        # running same-type TAOs per (cluster-set): O(1) interference query
        # in fast mode; slow mode keeps the seed's running-TAO rescan
        interference = _InterferenceTracker()
        run_clusters: dict[TAO, frozenset] = {}
        busy_acc = 0.0

        ARRIVE, COMPLETE, PREEMPT, RESUME, CHAOS = 0, 1, 2, 3, 4
        # segment/cursor bookkeeping is needed by preemption controllers AND
        # by chaos KILL truncation (to compute how many chunks a victim
        # finished before its workers died); chaos=None + ctrl=None keeps
        # every seed code path untouched
        track = (ctrl is not None) or bool(chaos)
        events: list = []   # (time, seq, kind, payload)
        seq = itertools.count()
        now = 0.0
        trace: list[TraceRecord] = []
        stats: dict[int, DagStats] = {}
        # running streaming / same-type counters per cluster for interference
        running: dict[TAO, TraceRecord] = {}
        # preemption-only state: per-running-TAO segment bookkeeping, the
        # width sum of running segments (the wants_consult pre-gate) and
        # the dag_id -> tenant map controller verdicts are keyed on
        run_info: dict[TAO, _Segment] = {}
        occupied_slots = 0
        backlog_ns: dict[str, int] = {}   # tenant -> admitted-not-done TAOs
        throttled_ns: dict[str, int] = {}  # tenant -> pending dominance delays
        counted: set[int] = set()          # id(req) of counted delays
        tenant_of = {dag_id: tenant
                     for _, dag_id, _, _, tenant, _, _ in arrivals}
        # displacement damping aggregates per tenant (reset_counters above
        # cleared the previous run's mapping and history)
        self.core.set_tenants(tenant_of)
        if ctrl is not None:
            ctrl.prepare(self.spec)
            ctrl.reset()

        # ARRIVE payload: (dag_id, dag, name, tenant, tokens, bind, request)
        # — request is None until the gate first sees the DAG, then carries
        # the attempt count
        for at, dag_id, dag, name, tenant, tokens, bind in arrivals:
            heapq.heappush(events,
                           (at, next(seq), ARRIVE,
                            (dag_id, dag, name, tenant, tokens, bind, None)))
        if chaos:
            for ev in chaos.events:
                heapq.heappush(events, (ev.at, next(seq), CHAOS, ev))

        def alive_after(w: int) -> int:
            """First non-failed worker at or cyclically after ``w``
            (``w`` itself when healthy — the no-chaos identity path)."""
            if self.failed and w in self.failed:
                for off in range(1, n_workers):
                    c = (w + off) % n_workers
                    if c not in self.failed:
                        return c
            return w

        def cluster_of(worker: int) -> str:
            return self.spec.class_of(worker)

        def concurrent_same(type_: str, clusters: frozenset) -> int:
            if fast:
                return interference.query(type_, clusters)
            n = 0
            for rec in running.values():
                if rec.type == type_ and any(
                    cluster_of(m) in clusters for m in rec.participants
                ):
                    n += 1
            return n

        def model_speed(model: KernelModel) -> np.ndarray:
            """Per-worker class-speed vector for one kernel model (cached;
            vectorized path only)."""
            v = speed_vecs.get(id(model))
            if v is None:
                v = np.array([model.speed[self.spec.class_of(w)]
                              for w in range(n_workers)])
                speed_vecs[id(model)] = v
            return v

        def push_queue(worker: int, tao: TAO) -> None:
            queues[worker].append(tao)
            if sharded:
                s = shard_of_worker[worker]
                nonempty_s[s].add(worker)
                qlen[s] += 1
            elif fast:
                nonempty.add(worker)

        def pop_queue(worker: int) -> TAO:
            tao = queues[worker].popleft()
            if sharded:
                s = shard_of_worker[worker]
                qlen[s] -= 1
                if not queues[worker]:
                    nonempty_s[s].discard(worker)
            elif fast and not queues[worker]:
                nonempty.discard(worker)
            return tao

        def start_tao(tao: TAO, popper: int, t0: float) -> None:
            nonlocal busy_acc, occupied_slots
            width = tao.assigned_width
            # the core owns place geometry: a ShardedScheduler anchors the
            # place inside the popper's shard (shard-local leader formula),
            # a plain SchedulerCore is the global XiTAO formula — identical
            # to the historical inline leader_of/place_members
            leader = self.core.leader_for(popper, width)
            # the popper (possibly a stealer) fixes the real place; admission
            # leaves assigned_leader at -1 so trace consumers never see a
            # leader the steal invalidated
            tao.assigned_leader = leader
            # ...and, for multi-variant TAOs, re-picks the variant for the
            # realized leader (a steal may have moved the TAO to the cluster
            # the admit-time impl was NOT chosen for; no-op on single-variant
            # TAOs and continuations, so legacy schedules stay byte-identical)
            model = self._model_for(tao.type,
                                    self.core.rebind_impl(tao, leader))
            # data-locality accounting: exactly one tracker.place per trace
            # record (the conservation invariant replay_moved_bytes checks).
            # A miss pays the modeled transfer delay below and feeds the
            # movement table; zero-footprint TAOs skip all of it.
            fp = tao.footprint
            move_cost = 0.0
            if fp is not None:
                loc = self.core.locality
                fp_src = fp.resident
                fp_hit, fp_moved, move_cost = loc.place(tao.type, fp, leader)
                if not fp_hit:
                    loc.record_transfer(tao.type, fp_src,
                                        loc.cluster_of(leader), fp_moved,
                                        move_cost)
                st_fp = stats.get(tao.dag_id)
                if st_fp is not None:
                    st_fp.record_locality(fp_hit, fp_moved)
            members = [m for m in self.core.members_for(leader, width)
                       if m not in self.failed]
            if not members:
                members = [popper]
            # TAO.work may carry a unit-work multiplier (serving: prompt/gen
            # length; training: microbatch size) — numbers only; other
            # payload types (ChunkedWork etc.) mean "unit work" here.
            scale = tao.work if isinstance(tao.work, (int, float)) else 1.0
            work = model.t_ref * float(scale)
            # a preempted TAO's continuation only carries its unclaimed
            # chunks (cursor exists only under a preemption controller, so
            # the arithmetic is untouched otherwise)
            cursor = tao.cursor
            if cursor is not None and cursor.next_chunk:
                work *= cursor.remaining_fraction
            t_end = float("inf")
            chosen: list[int] = []
            if vec:
                # --- vectorized rates + water-fill (100k-worker path) ------
                mem = np.asarray(members, dtype=np.intp)
                mem_codes = np.unique(cls_code[mem])
                n_conc = concurrent_same(tao.type, frozenset(
                    cls_names[c] for c in mem_codes.tolist()))
                s_a = model_speed(model)[mem] * speed_np[mem]
                if model.stream and model.bw_cap:
                    codes = cls_code[mem]
                    for code in mem_codes.tolist():
                        cap = model.bw_cap[cls_names[code]] / (1 + n_conc)
                        msk = codes == code
                        agg = float(s_a[msk].sum())
                        if agg > cap > 0:
                            s_a[msk] *= cap / agg
                rates_a = s_a * (model.eff(width)
                                 / (1.0 + model.cache_penalty * n_conc))
                joins_a = np.maximum(free_time[mem], t0)
                order = np.argsort(joins_a, kind="stable")
                js = joins_a[order]
                rs = rates_a[order]
                rcum = np.cumsum(rs)
                rjcum = np.cumsum(rs * js)
                with np.errstate(divide="ignore", invalid="ignore"):
                    cand_a = (work + rjcum) / rcum
                nxt = np.empty_like(js)
                if len(js) > 1:
                    nxt[:-1] = js[1:]
                nxt[-1] = np.inf
                ok = (rcum > 0) & (cand_a >= js - 1e-12) \
                    & (cand_a <= nxt + 1e-12)
                hit_ks = np.flatnonzero(ok)
                if hit_ks.size:
                    ki = int(hit_ks[0])
                    t_end = float(cand_a[ki])
                    # .tolist() materializes python ints/floats, so nothing
                    # numpy-typed ever reaches a TraceRecord repr
                    chosen = mem[order[:ki + 1]].tolist()
                    chosen_joins = js[:ki + 1]
                    joins = dict(zip(chosen, chosen_joins.tolist()))
            else:
                # --- effective per-member rates (scalar pinned path) -------
                n_conc = concurrent_same(
                    tao.type, frozenset(cluster_of(m) for m in members))
                rates = {}
                per_cluster_speed: dict[str, float] = {}
                for m in members:
                    s = model.speed[cluster_of(m)] * self.speed_mult[m]
                    per_cluster_speed[cluster_of(m)] = per_cluster_speed.get(
                        cluster_of(m), 0.0) + s
                    rates[m] = s
                if model.stream and model.bw_cap:
                    # cap aggregate streaming rate per cluster, shared with
                    # other concurrent streaming TAOs touching the cluster
                    for cl, agg in per_cluster_speed.items():
                        cap = model.bw_cap[cl] / (1 + n_conc)
                        if agg > cap > 0:
                            scale_s = cap / agg
                            for m in members:
                                if cluster_of(m) == cl:
                                    rates[m] *= scale_s
                cache_factor = 1.0 + model.cache_penalty * n_conc
                e = model.eff(width)
                for m in rates:
                    rates[m] = rates[m] * e / cache_factor

                # --- water-filling finish time -----------------------------
                joins = {m: max(t0, free_time[m]) for m in members}
                parts = sorted(members, key=lambda m: joins[m])
                # single incremental prefix-sum pass: the k-candidate loop
                # used to recompute sum(rates) / sum(rates*joins) from
                # scratch per k (O(k^2) per TAO start).  Accumulating
                # left-to-right performs the exact same float additions in
                # the same order, so the finish times are bit-identical —
                # just O(k).
                rsum = 0.0
                rjsum = 0.0
                for k in range(1, len(parts) + 1):
                    m = parts[k - 1]
                    rsum += rates[m]
                    rjsum += rates[m] * joins[m]
                    if rsum <= 0:
                        continue
                    cand = (work + rjsum) / rsum
                    # valid if every chosen member joins before cand and the
                    # next member (if any) joins after cand
                    if cand >= joins[m] - 1e-12 and (
                        k == len(parts) or cand <= joins[parts[k]] + 1e-12
                    ):
                        t_end = cand
                        chosen = parts[:k]
                        break
            if not chosen:  # all rates zero (fully failed place): fallback
                chosen = [popper]
                joins = {popper: max(t0, float(free_time[popper]))}
                if vec:
                    chosen_joins = np.array([joins[popper]])
                t_end = t0 + work / max(
                    model.speed[cluster_of(popper)] *
                    max(self.speed_mult[popper], 1e-6), 1e-9)
            if move_cost:
                # off-resident placement: the cross-cluster transfer is
                # serialized before compute, delaying this segment's finish
                t_end += move_cost

            if vec:
                busy_acc += t_end * len(chosen) - float(chosen_joins.sum())
                free_time[np.asarray(chosen, dtype=np.intp)] = t_end
                for m in chosen:
                    idle.discard(m)
            else:
                for m in chosen:
                    busy_acc += t_end - joins[m]
                    free_time[m] = t_end
                    idle.discard(m)
            rec = TraceRecord(tao.id, tao.type, leader, width,
                              t0, t_end, tuple(chosen), dag_id=tao.dag_id,
                              impl=tao.assigned_impl)
            running[tao] = rec
            if fast:
                # key by the clusters the *chosen* participants touch — the
                # seed rescan matched against rec.participants, not members
                chosen_clusters = frozenset(cluster_of(m) for m in chosen)
                interference.start(tao.type, chosen_clusters)
                run_clusters[tao] = chosen_clusters
            trace.append(rec)
            st = stats.get(tao.dag_id)
            if st is not None and t0 < st.started:
                st.started = t0
            if track:
                cursor = ensure_cursor(tao)
                if cursor.preempted_at is not None:
                    # RESUME accounting: the continuation holds a place again
                    if st is not None:
                        st.preemption_delay += t0 - cursor.preempted_at
                    cursor.preempted_at = None
                run_info[tao] = _Segment(
                    rec=rec, t_begin=joins[chosen[0]], t_end=t_end,
                    joins={m: joins[m] for m in chosen},
                    n_seg=cursor.unclaimed)
                # occupancy counts the workers actually held (chosen
                # members), not the nominal width, which over-reports
                # saturation at the pool edge / around failed workers
                occupied_slots += len(rec.participants)
            # payload carries the segment's record so a COMPLETE that was
            # overtaken by a PREEMPT is recognizably stale
            heapq.heappush(events, (t_end, next(seq), COMPLETE, (tao, rec)))

        def steal_ok(v: int, worker: int) -> bool:
            """Affinity gate on the steal path: decline a cross-cluster
            steal of a footprint TAO queued on its resident cluster —
            UNLESS the victim is dead (rescue-stealing off a dead cluster
            pays the move instead of stranding the TAO).  Zero-footprint
            TAOs always pass, so legacy schedules are untouched."""
            if v in self.failed:
                return True
            return not self.core.locality.steal_gated(
                queues[v][0].footprint, worker, v)

        def dispatch_from(worker: int, t0: float) -> bool:
            """Worker tries local pop then one random steal (paper §5).

            Sharded runs steal hierarchically: the random victim draw is
            confined to the worker's own shard (with one shard this is the
            global draw, bit for bit); only when the whole shard is out of
            work may the worker *import* a TAO from the most-loaded other
            shard, and only if that donor's queued backlog exceeds its own
            shard's by the exchange threshold (docs/POLICIES.md) — every
            crossing is counted (conservation) and pays the locality
            movement cost at start (the global tracker sees the cross-shard
            leader as an off-resident placement)."""
            if worker in self.failed:
                return False
            if queues[worker]:
                start_tao(pop_queue(worker), worker, t0)
                return True
            if sharded:
                s = shard_of_worker[worker]
                ne = nonempty_s[s]
                if ne:
                    v = ne.choice(self.rng)
                    if not steal_ok(v, worker):
                        return False
                    start_tao(pop_queue(v), worker, t0)
                    return True
                if n_shards > 1:
                    donor = -1
                    best = qlen[s] + exch_threshold - 1
                    for d in range(n_shards):
                        if d != s and qlen[d] > best:
                            best = qlen[d]
                            donor = d
                    if donor >= 0 and nonempty_s[donor]:
                        v = nonempty_s[donor].choice(self.rng)
                        if not steal_ok(v, worker):
                            return False
                        imbalance = qlen[donor] - qlen[s]
                        start_tao(pop_queue(v), worker, t0)
                        self.core.note_exchange(donor, s, imbalance)
                        return True
                return False
            if fast:
                if nonempty:
                    v = nonempty.choice(self.rng)
                    if not steal_ok(v, worker):
                        return False
                    start_tao(pop_queue(v), worker, t0)
                    return True
                return False
            victims = [v for v in range(n_workers) if queues[v]]
            if victims:
                v = self.rng.choice(victims)
                if not steal_ok(v, worker):
                    return False
                start_tao(pop_queue(v), worker, t0)
                return True
            return False

        def gate_throttled() -> frozenset | None:
            """Tenants the gate currently holds at the door for
            *dominating* the backlog; ``None`` on ungated runs."""
            if gate is None:
                return None
            return frozenset(t for t, c in throttled_ns.items() if c > 0)

        def tenant_backlog() -> dict:
            """Per-tenant admitted-but-uncompleted TAO counts — the
            SLO-dominance signal controllers measure against (the tenant
            split of the slo-adaptive gate's backlog).  ``backlog_ns`` is
            maintained incrementally (admission adds ``n_taos``, every
            commit subtracts one), so the consult path never scans the
            per-DAG stats table."""
            return dict(backlog_ns)

        def running_views() -> list:
            """Controller-facing snapshot of the running set (sorted by
            the deterministic (dag_id, tao_id) key both vehicles share)."""
            cap = ctrl.max_preemptions
            views = []
            for tao2, seg in run_info.items():
                c = tao2.cursor
                preemptible = (seg.preempt_at is None and seg.n_seg >= 2
                               and c.preemptions < cap)
                views.append(RunningView.of(
                    tao2, tenant_of.get(tao2.dag_id, "default"),
                    seg.rec.leader, len(seg.rec.participants), preemptible,
                    members=seg.rec.participants))
            return sorted_views(views)

        def schedule_preempt(view, t_req: float, beneficiary: TAO | None = None,
                             ben_target: int = -1) -> None:
            """Stop ``view``'s TAO at its next chunk boundary >= t_req.

            Boundaries are modeled uniform over the segment's water-filled
            span; at least one chunk of every segment completes, so a
            repeatedly displaced TAO still makes progress.  ``beneficiary``
            (the queued TAO the displacement is for) gets the freed slot
            handed to it directly at truncation time if it is still
            waiting in queue ``ben_target``."""
            tao2 = view.tao
            seg = run_info.get(tao2)
            if seg is None or seg.preempt_at is not None:
                return
            span = seg.t_end - seg.t_begin
            if seg.n_seg < 2 or span <= 0:
                return
            frac = (t_req - seg.t_begin) / span
            j = max(1, math.ceil(frac * seg.n_seg - 1e-9))
            if j >= seg.n_seg:
                return            # past the last boundary: completes anyway
            t_p = seg.t_begin + span * j / seg.n_seg
            if t_p < t_req:
                t_p = t_req       # float guard: never truncate in the past
            seg.preempt_at = t_p
            seg.chunks_done = j
            seg.beneficiary = beneficiary
            seg.ben_target = ben_target
            heapq.heappush(events, (t_p, next(seq), PREEMPT, (tao2, seg)))

        def take_from_queue(tao2: TAO, target: int) -> bool:
            """Remove a still-queued TAO for a targeted hand-off."""
            if target < 0:
                return False
            q = queues[target]
            try:
                q.remove(tao2)
            except ValueError:
                return False
            if sharded:
                s = shard_of_worker[target]
                qlen[s] -= 1
                if not q:
                    nonempty_s[s].discard(target)
            elif fast and not q:
                nonempty.discard(target)
            return True

        def enqueue_ready(tao: TAO, waker: int, t0: float) -> None:
            enqueue_admitted(tao, self.core.admit(tao, waker), t0)

        def enqueue_admitted(tao: TAO, placement, t0: float) -> None:
            # a dead target would strand the TAO forever (a dead worker
            # never pops, and at the tail no future event triggers a
            # steal): redirect to the next alive worker deterministically.
            # Policies already mask dead workers, so this fires only for
            # placements pinned by construction (e.g. homogeneous waker
            # affinity) — and never on healthy runs.
            target = alive_after(placement.target)
            push_queue(target, tao)
            # an idle worker picks it up immediately: locality first
            if target in idle and free_time[target] <= t0 + 1e-12:
                idle.discard(target)
                dispatch_from(target, t0)
            elif idle:
                w = idle.choice(self.rng) if fast \
                    else self.rng.choice(sorted(idle))
                if free_time[w] <= t0 + 1e-12:
                    idle.discard(w)
                    if not dispatch_from(w, t0):
                        idle.add(w)     # affinity-gated steal: stay idle
            # preemption consult point 1: the TAO stayed queued (start_tao
            # would have stamped assigned_leader) and may displace running
            # work at the controller's discretion; it is the beneficiary of
            # whatever slot the displacement frees.  The wants_consult
            # pre-gate keeps the unsaturated hot path from materializing
            # views/backlog on every enqueue.
            if ctrl is not None and tao.assigned_leader == -1:
                signals = self.core.admission_signals()
                if ctrl.wants_consult(signals, occupied_slots):
                    victims = ctrl.on_ready(
                        tao, tenant_of.get(tao.dag_id, "default"),
                        running_views(), signals, tenant_backlog(),
                        gate_throttled())
                    for v in victims:
                        schedule_preempt(v, t0, beneficiary=tao,
                                         ben_target=target)

        n_events = 0
        while events:
            n_events += 1
            if max_events is not None and n_events > max_events:
                raise RuntimeError("simulator exceeded max_events (livelock?)")
            now, _, kind, payload = heapq.heappop(events)
            if kind == CHAOS:
                from .chaos import DEGRADE as C_DEGRADE, KILL as C_KILL
                ev = payload
                if ev.action == C_DEGRADE:
                    # running segments keep their snapshot t_end — the same
                    # start-time-sampling approximation the interference
                    # model makes; new starts see the degraded rate
                    for w in ev.workers:
                        if w < n_workers and w not in self.failed:
                            self.speed_mult[w] = ev.speed
                    if vec:
                        speed_np[:] = self.speed_mult
                    continue
                if ev.action == C_KILL:
                    newly = [w for w in ev.workers
                             if w < n_workers and w not in self.failed]
                    if not newly:
                        continue
                    for w in newly:
                        self.failed.add(w)
                        self.speed_mult[w] = 0.0
                        idle.discard(w)
                    if vec:
                        speed_np[:] = self.speed_mult
                    dead = set(newly)
                    self.core.set_dead(frozenset(self.failed))
                    # 1) truncate running segments that lost a participant:
                    #    chunks whose boundary passed are kept (mirrors the
                    #    threaded claim discipline — a claimed chunk always
                    #    completes), the rest are re-admitted as a
                    #    continuation through release->admit
                    victims = [(t2, r) for t2, r in running.items()
                               if any(m in dead for m in r.participants)]
                    requeue = []
                    for tao, rec in victims:
                        running.pop(tao)
                        seg = run_info.pop(tao)
                        occupied_slots -= len(rec.participants)
                        if fast:
                            interference.finish(tao.type,
                                                run_clusters.pop(tao))
                        for m in rec.participants:
                            new_free = max(seg.joins.get(m, now), now)
                            busy_acc -= seg.t_end - new_free
                            free_time[m] = new_free
                        rec.end = now
                        rec.preempted = True
                        span = seg.t_end - seg.t_begin
                        done = 0
                        if seg.n_seg > 1 and span > 0 and now > seg.t_begin:
                            done = min(seg.n_seg - 1,
                                       int((now - seg.t_begin)
                                           / span * seg.n_seg))
                        cursor = ensure_cursor(tao)
                        if done:
                            cursor.advance(done)
                        # a failure requeue is not a policy displacement:
                        # no preemption budget spent, no damping fed
                        cursor.rearm(count_displacement=False)
                        cursor.preempted_at = now
                        st = stats.get(tao.dag_id)
                        if st is not None:
                            st.record_failure_requeue()
                        self.core.release(tao, count_displacement=False)
                        requeue.append((tao, rec.leader, rec.participants))
                    # 2) ready TAOs stranded on a dead worker's queue go
                    #    back through release->admit so placement sees the
                    #    shrunken fleet
                    for w in newly:
                        while queues[w]:
                            tao = queues[w].popleft()
                            if sharded:
                                qlen[shard_of_worker[w]] -= 1
                            st = stats.get(tao.dag_id)
                            if st is not None:
                                st.record_failure_requeue()
                            self.core.release(tao, count_displacement=False)
                            requeue.append((tao, w, ()))
                        if sharded:
                            nonempty_s[shard_of_worker[w]].discard(w)
                        elif fast:
                            nonempty.discard(w)
                    # 3) re-admit, then let surviving freed members look
                    #    for work (they are not in `idle` yet, so the
                    #    re-admissions above queue rather than dispatch)
                    for tao, waker, _ in requeue:
                        enqueue_ready(tao, waker=alive_after(waker), t0=now)
                    for _, _, participants in requeue:
                        for m in participants:
                            if m not in self.failed \
                                    and free_time[m] <= now + 1e-12:
                                if not dispatch_from(m, now):
                                    idle.add(m)
                    continue
                # RECOVER: clear both kill and degrade state
                revived = []
                for w in ev.workers:
                    if w >= n_workers:
                        continue
                    if w in self.failed:
                        self.failed.discard(w)
                        free_time[w] = max(free_time[w], now)
                        revived.append(w)
                    self.speed_mult[w] = 1.0
                if vec:
                    speed_np[:] = self.speed_mult
                self.core.set_dead(frozenset(self.failed))
                for w in revived:
                    if not dispatch_from(w, now):
                        idle.add(w)
                continue
            if kind == ARRIVE:
                dag_id, dag, name, tenant, tokens, bind, req = payload
                st = stats.get(dag_id)
                if st is None:   # first evaluation: now == DagArrival.at
                    st = DagStats.for_arrival(dag_id, name, now, len(dag),
                                              tenant=tenant, tokens=tokens)
                    stats[dag_id] = st
                # empty DAGs bypass the gate (done on arrival, consume
                # nothing); everything else asks admit/delay/reject
                if req is not None and id(req) in counted:
                    # the delayed arrival is being re-presented: it no
                    # longer counts as held-at-the-door
                    counted.discard(id(req))
                    throttled_ns[tenant] -= 1
                if gate is not None and len(dag) > 0:
                    if req is None:
                        req = AdmissionRequest(dag_id=dag_id, tenant=tenant,
                                               n_taos=len(dag), arrival=now)
                    verdict = gate.decide(req, now,
                                          self.core.admission_signals())
                    if verdict.action == DELAY:
                        req.attempts += 1
                        if verdict.dominant:
                            counted.add(id(req))
                            throttled_ns[tenant] = \
                                throttled_ns.get(tenant, 0) + 1
                        # preemption consult point 2 (gate feedback): the
                        # gate throttled this tenant *for dominating the
                        # backlog* — displace its in-flight work too (a
                        # tenant delayed for its own degraded p99 is a
                        # victim, not a cause, and is never forwarded)
                        if ctrl is not None and verdict.dominant:
                            for v in ctrl.on_gate_feedback(
                                    tenant, running_views(),
                                    self.core.admission_signals(),
                                    tenant_backlog()):
                                schedule_preempt(v, now)
                        # strictly-future retry: a gate bug must surface as
                        # max_events, not an infinite same-time loop
                        retry = max(verdict.retry_at, now + 1e-9)
                        heapq.heappush(events,
                                       (retry, next(seq), ARRIVE,
                                        (dag_id, dag, name, tenant, tokens,
                                         bind, req)))
                        continue
                    if verdict.action == REJECT:
                        st.mark_rejected()
                        gate.on_reject(req, now)
                        continue
                    gate.on_admit(req, now)
                st.mark_admitted(now)
                if ctrl is not None:
                    backlog_ns[tenant] = backlog_ns.get(tenant, 0) + len(dag)
                # deferred payload binding, mirroring the threaded admitter:
                # bind runs once, for admitted DAGs only (rejected arrivals
                # never materialize their payload closures)
                if bind is not None:
                    bind(dag)
                roots = self.core.prepare(dag, dag_id=dag_id)
                if sharded and len(roots) > 1:
                    # batched admission: one shard-grouped pass through the
                    # shard map, then the per-TAO enqueue/idle-pickup steps
                    # in the original order (byte-identical at one shard —
                    # core and dispatch RNG streams each keep their internal
                    # order, and no admission reads dispatch-side state)
                    placements = self.core.admit_batch(
                        [(r, 0) for r in roots])
                    for r, p in zip(roots, placements):
                        enqueue_admitted(r, p, now)
                else:
                    for r in roots:
                        enqueue_ready(r, waker=0, t0=now)
                continue
            if kind == PREEMPT:
                tao, seg = payload
                if running.get(tao) is not seg.rec:
                    continue    # the segment completed first: nothing to stop
                rec = seg.rec
                running.pop(tao)
                run_info.pop(tao, None)
                occupied_slots -= len(rec.participants)
                if fast:
                    interference.finish(tao.type, run_clusters.pop(tao))
                # truncate at the chunk boundary: members are freed now and
                # their un-run busy time returned (a member whose join lay
                # past the boundary never ran this segment at all)
                for m in rec.participants:
                    new_free = max(seg.joins[m], now)
                    busy_acc -= seg.t_end - new_free
                    free_time[m] = new_free
                rec.end = now
                rec.preempted = True
                cursor = ensure_cursor(tao)
                cursor.advance(seg.chunks_done)
                cursor.rearm()
                cursor.preempted_at = now
                st = stats.get(tao.dag_id)
                if st is not None:
                    st.record_preemption()
                # targeted hand-off: the ready TAO this displacement was
                # for takes the freed slot directly if it is still queued
                # (random stealing would likely hand the slot right back to
                # the dominant tenant's plentiful queued TAOs)
                ben = seg.beneficiary
                freed = [m for m in rec.participants
                         if free_time[m] <= now + 1e-12
                         and m not in self.failed]
                if (ben is not None and freed and ben.assigned_leader == -1
                        and take_from_queue(ben, seg.ben_target)):
                    popper = rec.leader if rec.leader in freed else freed[0]
                    start_tao(ben, popper, now)
                # the continuation re-enters via its own RESUME event at the
                # same timestamp: freed members re-dispatch first (seq order
                # is the deterministic tie-break), then the unclaimed chunks
                # go back through the normal release->admit path
                heapq.heappush(events, (now, next(seq), RESUME,
                                        (tao, rec.leader)))
                for m in rec.participants:
                    if free_time[m] <= now + 1e-12 and m not in self.failed:
                        if not dispatch_from(m, now):
                            idle.add(m)
                continue
            if kind == RESUME:
                tao, old_leader = payload
                self.core.release(tao)
                enqueue_ready(tao, waker=old_leader, t0=now)
                continue
            tao, rec = payload
            if running.get(tao) is not rec:
                continue        # stale COMPLETE: this segment was preempted
            running.pop(tao)
            seg = run_info.pop(tao, None)
            if fast:
                interference.finish(tao.type, run_clusters.pop(tao))
            if track:
                # the whole segment ran: all its chunks are spent
                cursor = ensure_cursor(tao)
                cursor.advance(cursor.n_chunks)
                occupied_slots -= len(rec.participants)
            # leader-only PTT record: leader's elapsed view.  Preempted
            # segments never record (their truncated end is a displacement
            # artifact, not a sample); a continuation's completing segment
            # records its elapsed as-is — it understates a full TAO, but
            # both alternatives evaluated worse: dropping it starves the
            # model, and scaling it up by the chunk ratio destabilized
            # placement learning on the bursty A/B (continuations are
            # rare and bounded by max_preemptions, so the EWMA bias is
            # marginal while the ratio signals policies use are unbiased).
            if rec.leader in rec.participants:
                elapsed = rec.end - max(rec.start, 0.0)
                self.core.record_time(tao, rec.leader, rec.width, elapsed)
            # commit-and-wakeup
            for child in self.core.commit_and_wakeup(tao):
                enqueue_ready(child, waker=rec.leader, t0=now)
            st = stats.get(tao.dag_id)
            if st is not None:
                st.record_completion(now)
                if ctrl is not None:
                    backlog_ns[st.tenant] = backlog_ns.get(st.tenant, 0) - 1
                if gate is not None and st.done:
                    # feedback signal for adaptive gates (sojourn EWMAs)
                    gate.on_dag_done(st.tenant, st.sojourn, now,
                                     n_taos=st.n_taos)
            # freed members look for work
            for m in rec.participants:
                if free_time[m] <= now + 1e-12 and m not in self.failed:
                    if not dispatch_from(m, now):
                        idle.add(m)

        makespan = now
        completed = self.core.completed
        util = busy_acc / (makespan * max(1, n_workers - len(self.failed))) \
            if makespan > 0 else 0.0
        result = WorkloadResult(
            makespan=makespan,
            throughput=completed / makespan if makespan > 0 else 0.0,
            completed=completed,
            utilization=util,
            trace=trace,
            per_dag=stats,
        )
        if sharded:
            result.exchanges = self.core.exchange_stats()
        return result


def run_policy(dag_factory: Callable[[], TaoDag], spec: ClusterSpec,
               policy: Policy, kernel_models: dict | None = None,
               seed: int = 0) -> SimResult:
    """Convenience: fresh DAG + fresh simulator, one run.

    A fresh Simulator always starts fault-free; callers *reusing* a
    simulator across runs keep its injected fault/straggler state by design
    and call :meth:`Simulator.reset_faults` for a pristine pool."""
    sim = Simulator(spec, policy, kernel_models=kernel_models, seed=seed)
    return sim.run(dag_factory())
