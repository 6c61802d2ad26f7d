"""Sharded scheduler: partitioned cores + hierarchical work exchange.

PR 3 made every per-TAO decision O(1)-amortized, but all decisions still
funnel through one :class:`~repro.core.scheduler.SchedulerCore` under one
lock — at fleet sizes (10k-100k workers) the *central scheduler* is the
ceiling, not the workers.  This module partitions scheduling state the way
the source paper's random-work-stealing baseline stays scalable
(decentralization), while keeping the PTT-driven placement the paper adds:

* :class:`ShardMap` — a deterministic, capacity-weighted ``dag_id -> shard``
  route.  A pure function of the dag_id, so admission *order* can never
  change where a DAG's TAOs are accounted (the routing-stability property
  ``tests/test_shard.py`` asserts).
* :func:`~repro.core.places.partition_workers` — proportional slices of
  every contiguous class run, so each shard stays heterogeneous.
* :class:`ShardedScheduler` — owns N ``SchedulerCore`` shards, each with
  its own lock, criticality multisets, load counters and PTT view over its
  sub-spec (the per-group decision state of arXiv:1905.00673); the *policy
  object is shared* across shards, composing shard-local PTT views with
  global weight learning exactly as that paper's adaptive scheduler does.
  It implements the full core surface both execution vehicles drive
  (``admit`` / ``release`` / ``commit_and_wakeup`` / ``record_time`` /
  ``rebind_impl`` / ``set_dead`` / ``admission_signals`` / resets), with
  global<->local worker-id translation at the boundary.

Load balancing becomes **hierarchical stealing**: within a shard the
vehicles steal exactly as today (bitmask victim draw); across shards a
worker may *import* work only when the imbalance threshold
(``policies.EXCHANGE_THRESHOLD``, see docs/POLICIES.md) is met, judged from
the O(1) per-shard queued-TAO counters the vehicles maintain.  Exchanges
are counted here (:meth:`ShardedScheduler.note_exchange`) and pay the PR 9
locality movement cost through the *global* :class:`~repro.core.locality.
LocalityTracker` — data-resident work is never bounced between shards for
free.  Conservation (every exchange has one donor and one recipient, no
TAO lost or duplicated) is checkable via :meth:`exchange_conserved`.

Identity contract (the PR 3/7/9 pattern): with ``n_shards=1`` the single
shard *is* the full spec — same seed, same policy object, same
``LocalityTracker`` instance, identity id-translation — so every pinned
trace signature reproduces byte-for-byte through the sharded code path
(CI-gated via ``benchmarks/perf.py --shards``).  ``reset_counters`` /
``reset_learning`` clear the exchange/imbalance state alongside the
per-shard core state, preserving the PR 7 leg-identity guarantee.

Whole-shard failure composes with chaos: ``set_dead`` masks each shard's
local view, and a DAG homed on a fully-dead shard is re-routed to the next
alive shard at admission (release/commit follow the recorded route, so the
accounting stays balanced while the dead shard's queues drain through the
existing release->admit re-admission path).
"""
from __future__ import annotations

import threading

from .admission import LoadSignals
from .dag import TAO, TaoDag
from .locality import LocalityTracker
from .places import ClusterSpec, leader_of, partition_workers, place_members
from .policies import EXCHANGE_THRESHOLD, Placement, Policy
from .scheduler import SchedulerCore

# Knuth's multiplicative-hash constant: spreads consecutive dag_ids
# uniformly over [0, 2^64) so capacity-weighted routing stays balanced on
# the sequential ids the workload generators produce.
_GOLDEN = 0x9E3779B97F4A7C15
_U64 = 0xFFFFFFFFFFFFFFFF
# Per-shard RNG stream separation; shard 0 keeps the construction seed so a
# 1-shard scheduler draws the exact stream a plain SchedulerCore would.
_SEED_STRIDE = 0x9E37


class ShardMap:
    """Deterministic, capacity-weighted ``dag_id -> shard`` routing.

    The unit interval is split into segments proportional to each shard's
    worker count; a dag_id hashes (multiplicative, golden-ratio constant)
    to a point in [0, 1) and lands in the segment covering it.  Pure in
    ``dag_id`` — no state, no RNG — so the route is independent of
    admission order, retries, or interleaving with other tenants.
    """

    def __init__(self, capacities):
        caps = list(capacities)
        if not caps or min(caps) <= 0:
            raise ValueError(f"capacities must be positive, got {caps}")
        total = float(sum(caps))
        bounds = []
        acc = 0.0
        for c in caps[:-1]:
            acc += c / total
            bounds.append(acc)
        self._bounds = tuple(bounds)     # n_shards - 1 segment boundaries
        self.n_shards = len(caps)
        self.capacities = tuple(caps)

    def shard_of(self, dag_id: int) -> int:
        if self.n_shards == 1:
            return 0
        x = ((dag_id * _GOLDEN) & _U64) / 2.0 ** 64
        lo, hi = 0, len(self._bounds)
        while lo < hi:                    # bisect_right over the boundaries
            mid = (lo + hi) // 2
            if x < self._bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo


class Shard:
    """One partition of the pool: a ``SchedulerCore`` over a sub-spec plus
    the global<->local worker-id translation tables."""

    __slots__ = ("index", "workers", "local_of", "core")

    def __init__(self, index: int, workers, core: SchedulerCore):
        self.index = index
        self.workers = tuple(workers)            # local id -> global id
        self.local_of = {w: i for i, w in enumerate(self.workers)}
        self.core = core

    @property
    def n_workers(self) -> int:
        return len(self.workers)

    def fully_dead(self) -> bool:
        return len(self.core.dead_workers()) >= len(self.workers)


class ShardedScheduler:
    """N ``SchedulerCore`` shards behind the single-core interface.

    Drop-in for :class:`~repro.core.scheduler.SchedulerCore` from both
    execution vehicles' point of view; all worker ids crossing the boundary
    are *global*.  See the module docstring for the architecture.
    """

    def __init__(self, spec: ClusterSpec, policy: Policy, n_shards: int = 1,
                 seed: int = 0, fast_query: bool = True,
                 exchange_threshold: int = EXCHANGE_THRESHOLD):
        self.spec = spec
        self.policy = policy
        self.n_shards = int(n_shards)
        self.exchange_threshold = int(exchange_threshold)
        self._seed = seed
        parts = partition_workers(spec, self.n_shards)
        shards = []
        shard_of_worker = [0] * spec.n_workers
        for s, workers in enumerate(parts):
            if self.n_shards == 1:
                # the single shard IS the full spec: reusing the object (not
                # an equal copy) keeps every cached-tuple identity the PTT
                # fast path relies on — byte-identity by construction
                sub = spec
            else:
                sub = ClusterSpec(
                    classes=tuple(spec.class_of(w) for w in workers))
            core = SchedulerCore(sub, policy,
                                 seed=self._shard_seed(seed, s),
                                 fast_query=fast_query)
            shards.append(Shard(s, workers, core))
            for w in workers:
                shard_of_worker[w] = s
        self.shards = tuple(shards)
        self.shard_of_worker = tuple(shard_of_worker)
        self.map = ShardMap([sh.n_workers for sh in shards])
        if self.n_shards == 1:
            # same tracker object the shard's policies consult: placement,
            # steal gating and accounting all see one residency state,
            # exactly as on an unsharded core
            self.locality = self.shards[0].core.locality
        else:
            # ONE global tracker does all dispatch accounting and steal
            # gating (cluster indices are global, so cross-shard exchanges
            # pay real movement cost); the per-shard trackers are switched
            # to charge=False so policies take the legacy placement path —
            # shard-local placement is locality-blind by design (a shard
            # cannot price clusters it does not own), the exchange gate is
            # where data affinity is enforced.
            self.locality = LocalityTracker(spec)
            for sh in self.shards:
                sh.core.locality.charge = False
        self._dead: frozenset = frozenset()
        # admit-time route memo: release/commit must undo accounting in the
        # shard that admitted the TAO, even if the home shard's alive-ness
        # changed in between (chaos KILL/RECOVER of a whole shard)
        self._route: dict[int, int] = {}
        self._route_lock = threading.Lock()
        # exchange/imbalance state (cleared by reset_counters, satellite of
        # the PR 7 leg-identity guarantee)
        self._xlock = threading.Lock()
        self.exchanges_in = [0] * self.n_shards
        self.exchanges_out = [0] * self.n_shards
        self.exchange_total = 0
        self.imbalance_peak = 0

    @staticmethod
    def _shard_seed(seed: int, s: int) -> int:
        return seed if s == 0 else seed + _SEED_STRIDE * s

    # -- routing ------------------------------------------------------------
    def _home(self, dag_id: int) -> Shard:
        """Admission shard for a DAG: its deterministic home, or — only
        while the home shard is fully dead — the next alive shard."""
        sh = self.shards[self.map.shard_of(dag_id)]
        if self._dead and sh.fully_dead():
            for off in range(1, self.n_shards):
                cand = self.shards[(sh.index + off) % self.n_shards]
                if not cand.fully_dead():
                    return cand
        return sh

    # -- place geometry (global ids) ----------------------------------------
    def leader_for(self, popper: int, width: int) -> int:
        """Global leader of the place a pop on ``popper`` anchors: the
        XiTAO leader formula applied in the popper's shard-local ids."""
        sh = self.shards[self.shard_of_worker[popper]]
        return sh.workers[leader_of(sh.local_of[popper], width)]

    def members_for(self, leader: int, width: int) -> list:
        """Global members of the place anchored at ``leader`` (clipped to
        the leader's shard, mirroring the pool-edge clip of the unsharded
        vehicles)."""
        sh = self.shards[self.shard_of_worker[leader]]
        ll = sh.local_of[leader]
        n = sh.n_workers
        return [sh.workers[m] for m in place_members(ll, width) if m < n]

    # -- lifecycle transitions ----------------------------------------------
    def admit(self, tao: TAO, waker: int) -> Placement:
        """Route by dag_id, admit on the home shard (policy runs in local
        ids against the shard's PTT view), translate the target back to a
        global worker id, and memo the route for release/commit."""
        sh = self._home(tao.dag_id)
        local_waker = sh.local_of.get(waker)
        if local_waker is None:
            local_waker = waker % sh.n_workers
        p = sh.core.admit(tao, local_waker)
        with self._route_lock:
            self._route[id(tao)] = sh.index
        return Placement(target=sh.workers[p.target], width=p.width,
                         impl=p.impl)

    def admit_batch(self, pairs) -> list:
        """Batched admission: ``[(tao, waker), ...] -> [Placement, ...]``.

        Admissions are grouped by home shard so each shard's lock is taken
        in one burst instead of bouncing between shards per TAO; within a
        shard the original order (and therefore every per-TAO accounting
        and RNG step) is preserved, so a batch of same-DAG roots admits
        byte-identically to sequential calls.
        """
        out: list = [None] * len(pairs)
        groups: dict[int, list] = {}
        for i, (tao, _waker) in enumerate(pairs):
            groups.setdefault(self.map.shard_of(tao.dag_id), []).append(i)
        for _s, idxs in sorted(groups.items()):
            for i in idxs:
                tao, waker = pairs[i]
                out[i] = self.admit(tao, waker)
        return out

    def _pop_route(self, tao: TAO) -> Shard:
        with self._route_lock:
            s = self._route.pop(id(tao), None)
        if s is None:   # never admitted here (defensive): fall back to home
            s = self.map.shard_of(tao.dag_id)
        return self.shards[s]

    def release(self, tao: TAO, count_displacement: bool = True) -> None:
        self._pop_route(tao).core.release(
            tao, count_displacement=count_displacement)

    def commit_and_wakeup(self, tao: TAO) -> list:
        return self._pop_route(tao).core.commit_and_wakeup(tao)

    def prepare(self, dag: TaoDag, dag_id: int = 0) -> list:
        return self.shards[self.map.shard_of(dag_id)].core.prepare(
            dag, dag_id=dag_id)

    # -- learning / execution-layer hooks (routed by worker ownership) ------
    def record_time(self, tao: TAO, leader: int, width: int,
                    elapsed: float) -> None:
        """PTT learning lives with the shard that OWNS the executing
        worker (an exchanged TAO teaches the recipient shard's PTT — the
        shard whose workers will see that placement again).  Widths wider
        than the executing shard clamp to its widest place, matching the
        member clip of :meth:`members_for`."""
        sh = self.shards[self.shard_of_worker[leader]]
        w = sh.core._clamp_width(width)
        sh.core.record_time(tao, sh.local_of[leader], w, elapsed)

    def rebind_impl(self, tao: TAO, leader: int) -> str:
        sh = self.shards[self.shard_of_worker[leader]]
        return sh.core.rebind_impl(tao, sh.local_of[leader])

    # -- chaos / signals -----------------------------------------------------
    def set_dead(self, dead: frozenset) -> None:
        dead = frozenset(dead)
        self._dead = dead
        for sh in self.shards:
            sh.core.set_dead(frozenset(
                sh.local_of[w] for w in dead if w in sh.local_of))

    def dead_workers(self) -> frozenset:
        return self._dead

    def set_tenants(self, mapping: dict) -> None:
        for sh in self.shards:
            sh.core.set_tenants(mapping)

    def admission_signals(self) -> LoadSignals:
        in_flight = namespaces = completed = 0
        for sh in self.shards:
            sig = sh.core.admission_signals()
            in_flight += sig.in_flight
            namespaces += sig.active_namespaces
            completed += sig.completed
        n_failed = len(self._dead)
        return LoadSignals(in_flight=in_flight,
                           active_namespaces=namespaces,
                           n_workers=self.spec.n_workers - n_failed,
                           completed=completed,
                           n_failed=n_failed)

    def system_load(self, namespace: int | None = None) -> int:
        if namespace is not None:
            return self.shards[self.map.shard_of(namespace)].core.system_load(
                namespace)
        return sum(sh.core.system_load() for sh in self.shards)

    def active_namespaces(self) -> int:
        return sum(sh.core.active_namespaces() for sh in self.shards)

    def displacements(self, namespace: int = 0) -> int:
        return self.shards[self.map.shard_of(namespace)].core.displacements(
            namespace)

    @property
    def completed(self) -> int:
        return sum(sh.core.completed for sh in self.shards)

    @property
    def ptt(self):
        """Shard 0's PTT registry — the *whole* registry at ``n_shards=1``
        (profile snapshots are exact there); a one-shard window otherwise
        (each shard learns its own view; use :meth:`learned_cells` for the
        aggregate)."""
        return self.shards[0].core.ptt

    def learned_cells(self) -> int:
        """Learned (nonzero-EWMA) PTT cells across every shard's view."""
        return sum(sh.core.ptt.learned_cells() for sh in self.shards)

    # -- exchange accounting -------------------------------------------------
    def note_exchange(self, src_shard: int, dst_shard: int,
                      imbalance: int = 0) -> None:
        """One TAO crossed shards: ``src`` donated, ``dst`` imported.
        Called by the vehicles on every threshold-passing steal."""
        with self._xlock:
            self.exchanges_out[src_shard] += 1
            self.exchanges_in[dst_shard] += 1
            self.exchange_total += 1
            if imbalance > self.imbalance_peak:
                self.imbalance_peak = imbalance

    def exchange_conserved(self) -> bool:
        """Donations and imports must balance exactly (no TAO lost or
        duplicated crossing a shard boundary)."""
        with self._xlock:
            return (sum(self.exchanges_out) == self.exchange_total
                    and sum(self.exchanges_in) == self.exchange_total)

    def exchange_stats(self) -> dict:
        with self._xlock:
            return {
                "n_shards": self.n_shards,
                "threshold": self.exchange_threshold,
                "total": self.exchange_total,
                "in": list(self.exchanges_in),
                "out": list(self.exchanges_out),
                "imbalance_peak": self.imbalance_peak,
            }

    # -- lifecycle ------------------------------------------------------------
    def _clear_exchange_state(self) -> None:
        with self._xlock:
            self.exchanges_in = [0] * self.n_shards
            self.exchanges_out = [0] * self.n_shards
            self.exchange_total = 0
            self.imbalance_peak = 0

    def reset_counters(self) -> None:
        """Per-run reset: every shard's counters, the global locality
        accounting, the route memo, and the exchange/imbalance state (the
        PR 7 leg-identity contract extends to shard state)."""
        for sh in self.shards:
            sh.core.reset_counters()
        if self.n_shards > 1:     # n_shards == 1 shares the shard's tracker
            self.locality.reset_counters()
        with self._route_lock:
            self._route.clear()
        self._clear_exchange_state()

    def reset_learning(self, seed: int | None = None) -> None:
        """A/B-leg reset: per-shard PTT/policy/RNG state (seeds re-derived
        per shard from the same stride as construction), global locality
        measurements, and the exchange state — a leg run after this is
        byte-identical to one on a freshly-built ShardedScheduler."""
        base = self._seed if seed is None else seed
        for s, sh in enumerate(self.shards):
            sh.core.reset_learning(self._shard_seed(base, s))
        if self.n_shards > 1:
            self.locality.reset()
            for sh in self.shards:   # reset_learning re-enables charging
                sh.core.locality.charge = False
        with self._route_lock:
            self._route.clear()
        self._clear_exchange_state()
