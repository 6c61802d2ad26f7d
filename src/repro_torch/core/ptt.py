"""Performance Trace Table (PTT) — the paper's §3.1 contribution.

One table per TAO *type*, organised ``(impl) x (worker) x (width-index)``,
recording an exponentially-weighted moving average of execution time with
weight 1:4::

    saved = (4 * old + new) / 5

Fields initialise to 0, which marks *untried* configurations and "ensures that
all configurations will be tested at runtime" (paper).  Only the *leader* of a
place records into its row, which in the C++ original keeps each row in a
single cache line with a single writer; here it keeps the same semantics
(single-writer rows) in a numpy table.

The PTT doubles as an online model of the system: because recorded times
include interference, DVFS and background load, policies built on it adapt to
*temporal* heterogeneity too (paper §3.1, last paragraph).  The fleet runtime
additionally uses it as a straggler detector (see ``repro.runtime_ft``).

Implementation variants (arXiv:2108.13871)
------------------------------------------
A TAO may carry several interchangeable implementations (reference jax vs
Pallas vs block-size variants) with different resource shapes; on
big.LITTLE-style pools the best implementation differs per cluster class.  The
table therefore keys its cells per ``(class, impl, width)``: every query and
``record()`` takes an ``impl`` keyword (default: the single legacy variant,
``DEFAULT_IMPL``), and each impl owns its own EWMA block *and* its own
fast-query structures, so the PR-3 O(1) machinery is preserved per impl.  Two
joint queries serve the decision layer: :meth:`best_impl` (best variant for a
fixed leader) and :meth:`best_cell` (joint (impl, leader) minimum for a
width, untried cells first in variant order).

Constant-time queries (``fast_query``, default on)
--------------------------------------------------
The paper's pitch is that placement decisions are cheap table lookups, yet the
obvious implementations of ``best_leader`` and ``cluster_time`` are
O(n_workers) scans with per-element numpy scalar reads — the dominant cost of
weight-based placement at fleet scale.  With ``fast_query=True`` each impl's
block maintains three incremental structures, updated on ``record()``:

* **per-(class, width) aggregates** — sum and count of tried cells, so
  ``cluster_time`` over a whole worker class is a ratio read.  The sums are
  kept as *exact integers*: every finite double is an integer multiple of
  2^-1074, so cells are accumulated at that fixed scale and the mean is
  rounded to float only at query time.  Exact integer arithmetic is
  order-independent, which is what makes the incremental aggregate equal a
  from-scratch recompute bit for bit — and therefore the fast and slow query
  paths schedule *identically* (a hard requirement of the perf test suite).
* **an untried-cell cursor per width** — zero-init exploration returns the
  first untried eligible leader; cells never become untried again, so a
  monotone cursor over the (ordered) eligible leaders finds it in amortized
  O(1) instead of rescanning the tried prefix on every wake-up.
* **a lazy best-leader cache per width** — ``(time, candidate-rank)`` of the
  current minimum.  A record that beats the cache replaces it in O(1); a
  record that *worsens* the cached best merely invalidates it, and the next
  query recomputes by scanning only that width's eligible leaders.  Ties are
  broken by candidate rank, matching the scan path's first-wins strict ``<``.

``PTT(..., fast_query=False)`` keeps the pure scan paths as the A/B baseline,
mirroring the simulator's ``fast_dispatch`` knob.
"""
from __future__ import annotations

import math
import threading
from fractions import Fraction
from typing import Iterable, Sequence

import numpy as np

from .dag import DEFAULT_IMPL
from .places import ClusterSpec, leader_of

EWMA_OLD_WEIGHT = 4  # paper: saved = (4*old + new) / 5

# 0.0 is the "untried" sentinel, so a genuinely-zero elapsed time (possible
# with coarse clocks) must not leave a recorded cell looking untried while
# samples() > 0 — clamp to a tiny epsilon instead.
MIN_ELAPSED = 1e-12

# Every finite double is an integer multiple of 2**-1074 (the smallest
# subnormal), so sums of doubles are exact at this fixed scale.
_SCALE_BITS = 1074


def _to_scaled(t: float) -> int:
    """Exact integer representation of ``t`` at scale 2**-1074."""
    m, e = math.frexp(t)             # t == m * 2**e, m in [0.5, 1)
    mi = int(m * (1 << 53))          # exact: doubles carry <= 53 mantissa bits
    shift = e - 53 + _SCALE_BITS
    return mi << shift if shift >= 0 else mi >> -shift


def _mean_from_scaled(ssum: int, count: int) -> float:
    """Correctly-rounded float mean of ``count`` scaled-integer doubles."""
    if count == 0:
        return 0.0
    return float(Fraction(ssum, count << _SCALE_BITS))


class _ImplBlock:
    """One impl's ``(worker) x (width)`` EWMA block plus fast-query state.

    Owned by a :class:`PTT`; all access is mediated (and locked) by the owner,
    so the block itself is a plain bag of state.  Each impl having its *own*
    aggregates/cursor/best-cache is what keeps every PR-3 O(1) invariant valid
    per (class, impl) cell.
    """

    __slots__ = ("_t", "_n", "_cls_sum", "_cls_cnt", "_cursor", "_best",
                 "_ccur", "_cbest")

    def __init__(self, spec: ClusterSpec, fast_query: bool):
        self._t = np.zeros((spec.n_workers, len(spec.widths)), dtype=np.float64)
        # Number of recorded samples per cell; used only for introspection /
        # straggler statistics, not by the paper's policies.
        self._n = np.zeros((spec.n_workers, len(spec.widths)), dtype=np.int64)
        if fast_query:
            nw = len(spec.widths)
            self._cls_sum = {c: [0] * nw for c in dict.fromkeys(spec.classes)}
            self._cls_cnt = {c: [0] * nw for c in dict.fromkeys(spec.classes)}
            self._cursor = [0] * nw            # first possibly-untried rank
            # per width: (time, rank, worker) of the fastest tried leader, or
            # None when unknown/invalidated (lazily recomputed on query)
            self._best: list = [None] * nw
            # per-cluster twins of cursor/best, serving the locality-penalised
            # queries: [width][cluster] untried cursor and lazy best cache
            nc = len(spec.clusters())
            self._ccur = [[0] * nc for _ in range(nw)]
            self._cbest: list = [[None] * nc for _ in range(nw)]


class PTT:
    """Trace table for one TAO type (all of its implementation variants)."""

    def __init__(self, spec: ClusterSpec, fast_query: bool = True):
        self.spec = spec
        self.fast_query = fast_query
        self._lock = threading.Lock()
        # eligible leaders per width index, in candidate (scan) order
        self._eligible = [spec.eligible_leaders(w) for w in spec.widths]
        # chaos mask: workers currently dead.  Empty (the overwhelmingly
        # common case) keeps every query on its original path; non-empty
        # masks dead workers out of leader choice and cluster means.
        self._excluded: frozenset = frozenset()
        self._elig_alive = self._eligible
        if fast_query:
            # (class-group tuple, class) pairs for O(1) identity detection in
            # cluster_time: ClusterSpec caches workers_of(), so policies pass
            # the very same tuple object on every call.
            self._groups = tuple(
                (spec.workers_of(c), c) for c in dict.fromkeys(spec.classes))
        # cluster topology for the locality-penalised queries: worker ->
        # cluster index, and per (width, cluster) the eligible leaders with
        # their global candidate ranks (clusters are contiguous class runs,
        # so per-cluster rank order is consistent with the global scan order)
        clusters = spec.clusters()
        cluster_of = [0] * spec.n_workers
        for ci, (_cls, workers) in enumerate(clusters):
            for w in workers:
                cluster_of[w] = ci
        self._cluster_of = tuple(cluster_of)
        self._celig = [
            tuple([(leader // w, leader) for leader in elig
                   if cluster_of[leader] == ci]
                  for ci in range(len(clusters)))
            for w, elig in zip(spec.widths, self._eligible)]
        # impl name -> its cell block; the legacy variant exists from birth so
        # single-impl paths never pay the creation branch.
        self._blocks: dict = {DEFAULT_IMPL: _ImplBlock(spec, fast_query)}

    def _block(self, impl: str) -> _ImplBlock:
        blk = self._blocks.get(impl)
        if blk is None:
            with self._lock:
                blk = self._blocks.setdefault(
                    impl, _ImplBlock(self.spec, self.fast_query))
        return blk

    def impls(self) -> tuple:
        """Impl names with materialised cell blocks (recorded *or* queried)."""
        return tuple(self._blocks)

    @property
    def excluded(self) -> frozenset:
        """The current dead-worker mask (empty when all workers are live)."""
        return self._excluded

    def set_excluded(self, excluded: frozenset) -> None:
        """Mask ``excluded`` workers out of every placement query.

        While the mask is non-empty ``best_leader`` bypasses the fast-query
        structures entirely (the monotone untried cursor and the lazy best
        cache assume the *global* candidate list) and scans the filtered
        eligible leaders instead; the incremental aggregates keep updating
        on ``record()`` throughout, so clearing the mask returns queries to
        the O(1) paths with state that never went stale.
        """
        excluded = frozenset(excluded)
        with self._lock:
            self._excluded = excluded
            if excluded:
                self._elig_alive = [
                    self.spec.eligible_leaders(w, exclude=excluded)
                    for w in self.spec.widths]
            else:
                self._elig_alive = self._eligible

    # -- recording ---------------------------------------------------------
    def record(self, worker: int, width: int, elapsed: float,
               impl: str = DEFAULT_IMPL) -> None:
        """EWMA-record ``elapsed`` for (impl, worker, width).

        ``worker`` must be the *leader* of the executing place; callers are
        responsible for the leader-only discipline (the runtime enforces it).
        """
        if elapsed < 0 or not math.isfinite(elapsed):
            raise ValueError(f"bad elapsed time {elapsed!r}")
        elapsed = max(elapsed, MIN_ELAPSED)  # keep the 0.0 untried sentinel
        wi = self.spec.width_index(width)
        blk = self._block(impl)
        with self._lock:
            old = float(blk._t[worker, wi])
            if old == 0.0:
                new = elapsed
            else:
                new = (EWMA_OLD_WEIGHT * old + elapsed) / (
                    EWMA_OLD_WEIGHT + 1
                )
            blk._t[worker, wi] = new
            blk._n[worker, wi] += 1
            if self.fast_query:
                self._update_aggregates(blk, worker, wi, width, old, new)

    def _update_aggregates(self, blk: _ImplBlock, worker: int, wi: int,
                           width: int, old: float, new: float) -> None:
        """O(1) incremental maintenance; caller holds the lock."""
        cls = self.spec.class_of(worker)
        blk._cls_sum[cls][wi] += _to_scaled(new) - (
            _to_scaled(old) if old != 0.0 else 0)
        if old == 0.0:
            blk._cls_cnt[cls][wi] += 1
        # best-leader cache: only eligible-leader rows participate
        if worker % width or worker + width > self.spec.n_workers:
            return
        rank = worker // width
        best = blk._best[wi]
        if best is not None:
            t_b, r_b, w_b = best
            if worker == w_b:
                if new <= t_b:
                    blk._best[wi] = (new, r_b, w_b)  # improved: still best
                else:
                    blk._best[wi] = None             # worsened: lazy recompute
            elif (new, rank) < (t_b, r_b):
                blk._best[wi] = (new, rank, worker)
        # per-cluster twin (locality-penalised queries), same lazy discipline
        ci = self._cluster_of[worker]
        cbest = blk._cbest[wi][ci]
        if cbest is None:
            return                     # already dirty; recomputed on query
        t_c, r_c, w_c = cbest
        if worker == w_c:
            if new <= t_c:
                blk._cbest[wi][ci] = (new, r_c, w_c)
            else:
                blk._cbest[wi][ci] = None
        elif (new, rank) < (t_c, r_c):
            blk._cbest[wi][ci] = (new, rank, worker)

    # -- queries -----------------------------------------------------------
    def time(self, worker: int, width: int, impl: str = DEFAULT_IMPL) -> float:
        """Recorded EWMA time; 0.0 means untried."""
        blk = self._blocks.get(impl)
        if blk is None:
            return 0.0
        return float(blk._t[worker, self.spec.width_index(width)])

    def samples(self, worker: int, width: int,
                impl: str = DEFAULT_IMPL) -> int:
        blk = self._blocks.get(impl)
        if blk is None:
            return 0
        return int(blk._n[worker, self.spec.width_index(width)])

    def untried(self, worker: int, width: int,
                impl: str = DEFAULT_IMPL) -> bool:
        return self.time(worker, width, impl=impl) == 0.0

    def best_leader(self, width: int, candidates: Iterable[int] | None = None,
                    impl: str = DEFAULT_IMPL):
        """Fastest recorded leader for ``(impl, width)``; untried leaders (0)
        come first so every configuration gets explored (paper: zero-init).

        Returns ``(leader, time)`` where time==0.0 flags an untried pick, or
        ``(None, inf)`` when there are no candidates.
        """
        wi = self.spec.width_index(width)
        blk = self._block(impl)
        dead = self._excluded
        if self.fast_query and candidates is None and not dead:
            return self._best_leader_fast(blk, wi)
        if candidates is None:
            candidates = self._elig_alive[wi]
        best = (None, math.inf)
        for c in candidates:
            if leader_of(c, width) != c:
                continue  # not an eligible leader for this width
            if dead and any(m in dead for m in range(c, c + width)):
                continue  # place overlaps a dead worker
            t = float(blk._t[c, wi])
            if t == 0.0:
                return (c, 0.0)  # force exploration
            if t < best[1]:
                best = (c, t)
        return best

    def _best_leader_fast(self, blk: _ImplBlock, wi: int):
        """Amortized-O(1) best_leader: untried cursor, then the lazy cache."""
        elig = self._eligible[wi]
        if not elig:
            return (None, math.inf)
        with self._lock:
            cur = blk._cursor[wi]
            t_col = blk._t[:, wi]
            while cur < len(elig) and t_col[elig[cur]] != 0.0:
                cur += 1               # cells never revert to untried:
            blk._cursor[wi] = cur      # the cursor only ever advances
            if cur < len(elig):
                return (elig[cur], 0.0)
            best = blk._best[wi]
            if best is None:           # invalidated: rescan this width only
                best = min((float(t_col[c]), r, c)
                           for r, c in enumerate(elig))
                blk._best[wi] = best
            return (best[2], best[0])

    # -- locality-penalised queries ---------------------------------------
    def best_leader_penalized(self, width: int, penalty: Sequence[float],
                              impl: str = DEFAULT_IMPL,
                              candidates: Iterable[int] | None = None):
        """``best_leader`` charging ``penalty[cluster_of(leader)]`` seconds
        on top of each cell — the data-movement cost of placing a footprint
        TAO off its resident cluster (arXiv:2502.06304).

        Untried cells still cost their cluster's penalty (an untried remote
        leader can lose to a tried local one: affinity holds unless the
        remote cluster is genuinely worth the move), so exploration is
        affinity-shaped rather than unconditional.  Returns ``(leader,
        raw_time)`` with raw_time==0.0 flagging an untried pick.  The fast
        path is O(#clusters) over per-cluster cursor/best caches; the scan
        baseline (``fast_query=False``, dead-masked, or explicit candidates)
        picks identically — min ``(time + penalty, candidate-rank)``.
        """
        leader, t, _cost = self._penalized_pick(width, penalty, impl,
                                                candidates)
        return (leader, t)

    def _penalized_pick(self, width: int, penalty: Sequence[float],
                        impl: str, candidates: Iterable[int] | None):
        """Internal: returns ``(leader, raw_time, penalised_cost)``."""
        wi = self.spec.width_index(width)
        blk = self._block(impl)
        dead = self._excluded
        if self.fast_query and candidates is None and not dead:
            return self._penalized_pick_fast(blk, wi, penalty)
        if candidates is None:
            candidates = self._elig_alive[wi]
        best = (None, math.inf, math.inf)
        for c in candidates:
            if leader_of(c, width) != c:
                continue
            if dead and any(m in dead for m in range(c, c + width)):
                continue
            t = float(blk._t[c, wi])
            cost = t + penalty[self._cluster_of[c]]
            if cost < best[2]:         # strict <: first (lowest rank) wins
                best = (c, t, cost)
        return best

    def _penalized_pick_fast(self, blk: _ImplBlock, wi: int,
                             penalty: Sequence[float]):
        """O(#clusters) penalised pick: each cluster contributes its first
        untried leader (cost = penalty alone) or its cached best tried cell
        (cost = time + penalty); min ``(cost, rank)`` across clusters matches
        the scan baseline exactly (within a cluster, any untried cell beats
        every tried one on cost since EWMA times are >= MIN_ELAPSED)."""
        best = (math.inf, math.inf, None, math.inf)  # cost, rank, leader, t
        with self._lock:
            t_col = blk._t[:, wi]
            for ci, elig in enumerate(self._celig[wi]):
                if not elig:
                    continue
                cur = blk._ccur[wi][ci]
                while cur < len(elig) and t_col[elig[cur][1]] != 0.0:
                    cur += 1           # monotone: cells never revert untried
                blk._ccur[wi][ci] = cur
                if cur < len(elig):
                    rank, leader = elig[cur]
                    cand = (penalty[ci], rank, leader, 0.0)
                else:
                    cbest = blk._cbest[wi][ci]
                    if cbest is None:  # invalidated: rescan this cluster only
                        cbest = min((float(t_col[ld]), r, ld)
                                    for r, ld in elig)
                        blk._cbest[wi][ci] = cbest
                    t_c, r_c, l_c = cbest
                    cand = (t_c + penalty[ci], r_c, l_c, t_c)
                if cand[:2] < best[:2]:
                    best = cand
        if best[2] is None:
            return (None, math.inf, math.inf)
        return (best[2], best[3], best[0])

    def best_cell_penalized(self, width: int, impls: Sequence[str],
                            penalty: Sequence[float],
                            candidates: Iterable[int] | None = None):
        """Joint ``(impl, leader)`` minimum of penalised cost for ``width``.

        Unlike :meth:`best_cell`'s impl-major exploration, untried cells
        here compete at their cluster's penalty (see
        :meth:`best_leader_penalized`); ties break in declared variant
        order.  Returns ``(impl, leader, raw_time)``.
        """
        best = (None, None, math.inf, math.inf)  # impl, leader, t, cost
        for name in impls:
            leader, t, cost = self._penalized_pick(width, penalty, name,
                                                   candidates)
            if leader is None:
                continue
            if cost < best[3]:         # strict <: first variant wins ties
                best = (name, leader, t, cost)
        return (best[0], best[1], best[2])

    def cluster_time(self, workers: Iterable[int], width: int,
                     impl: str = DEFAULT_IMPL) -> float:
        """Mean recorded time over a set of workers at ``width`` (0 if none).

        Used by weight-based scheduling to estimate the per-class execution
        time of a TAO type.  When ``workers`` is one of the spec's class
        groups (the only callers on the hot path) and ``fast_query`` is on,
        this is an O(1) ratio read of the incremental aggregates; arbitrary
        worker subsets fall back to the scan, which computes the identical
        exact-integer mean.
        """
        wi = self.spec.width_index(width)
        blk = self._block(impl)
        dead = self._excluded
        if self.fast_query and not dead:
            for group, cls in self._groups:
                if workers is group:
                    with self._lock:
                        return _mean_from_scaled(blk._cls_sum[cls][wi],
                                                 blk._cls_cnt[cls][wi])
        ssum, cnt = 0, 0
        for w in workers:
            if dead and w in dead:
                continue    # dead workers drop out of class estimates
            t = float(blk._t[w, wi])
            if t > 0.0:
                ssum += _to_scaled(t)
                cnt += 1
        return _mean_from_scaled(ssum, cnt)

    def best_width(self, leader: int, widths: Iterable[int] | None = None,
                   impl: str = DEFAULT_IMPL):
        """History-based molding query (paper §3.3).

        Looks *within the leader's row* for the width with the best
        resource-efficiency, i.e. minimising ``time(width) * width``.  Untried
        widths are returned first (exploration).  Returns ``(width, cost)``
        with cost = time*width (0.0 when exploring).  The row has only
        O(log n_workers) cells, so this stays a (short) scan.
        """
        if widths is None:
            widths = self.spec.widths
        dead = self._excluded
        best = (None, math.inf)
        for w in widths:
            if leader_of(leader, w) != leader:
                continue  # this worker cannot lead at width w
            if dead and any(m in dead for m in range(leader, leader + w)):
                continue  # widening would pull in a dead worker
            t = self.time(leader, w, impl=impl)
            if t == 0.0:
                return (w, 0.0)
            cost = t * w
            if cost < best[1]:
                best = (w, cost)
        return best

    # -- joint (impl, ...) queries ----------------------------------------
    def best_impl(self, leader: int, width: int, impls: Sequence[str]):
        """Best variant for a fixed ``(leader, width)`` cell.

        Untried variants come first, in the TAO's declared variant order (the
        per-impl analogue of zero-init exploration); otherwise the minimum
        EWMA time wins with first-wins strict ``<`` over that same order.
        Returns ``(impl, time)`` with time==0.0 flagging exploration.
        """
        best = (None, math.inf)
        for name in impls:
            t = self.time(leader, width, impl=name)
            if t == 0.0:
                return (name, 0.0)
            if t < best[1]:
                best = (name, t)
        return best

    def best_cell(self, width: int, impls: Sequence[str],
                  candidates: Iterable[int] | None = None):
        """Joint ``(impl, leader)`` minimum for ``width``.

        Exploration is impl-major: the first variant (in declared order) with
        an untried eligible leader is returned with that leader and time 0.0.
        Once every (impl, leader) cell at this width is tried, the minimum
        ``(time, impl-rank)`` wins — each impl's candidate contributed by the
        per-impl ``best_leader`` machinery, so the joint query stays amortized
        O(#impls).  Returns ``(impl, leader, time)`` or ``(None, None, inf)``
        when no variant has an eligible leader.
        """
        best = (None, None, math.inf)
        for name in impls:
            leader, t = self.best_leader(width, candidates=candidates,
                                         impl=name)
            if leader is None:
                continue
            if t == 0.0:
                return (name, leader, 0.0)
            if t < best[2]:
                best = (name, leader, t)
        return best

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        """Forget every recorded sample (all impls), back to the zero-init
        exploration state.  Benchmark harnesses call this between A/B legs so
        profiles learned in one leg cannot leak into the next."""
        with self._lock:
            self._blocks = {DEFAULT_IMPL: _ImplBlock(self.spec,
                                                     self.fast_query)}

    def snapshot(self, impl: str = DEFAULT_IMPL) -> np.ndarray:
        blk = self._blocks.get(impl)
        if blk is None:
            return np.zeros((self.spec.n_workers, len(self.spec.widths)),
                            dtype=np.float64)
        return blk._t.copy()

    def learned_cells(self) -> int:
        """Number of tried (worker, width, impl) cells across all variants —
        the table's learning-progress scalar (benchmarks report it per shard
        to show how the sharded scheduler partitions profile coverage)."""
        with self._lock:
            return int(sum(np.count_nonzero(blk._t)
                           for blk in self._blocks.values()))


class PTTRegistry:
    """``{tao_type: PTT}`` — one table per TAO class, lazily created."""

    def __init__(self, spec: ClusterSpec, fast_query: bool = True):
        self.spec = spec
        self.fast_query = fast_query
        self._tables: dict[str, PTT] = {}
        self._lock = threading.Lock()
        self._excluded: frozenset = frozenset()

    def table(self, tao_type: str) -> PTT:
        tbl = self._tables.get(tao_type)
        if tbl is None:
            with self._lock:
                tbl = self._tables.get(tao_type)
                if tbl is None:
                    tbl = PTT(self.spec, fast_query=self.fast_query)
                    if self._excluded:
                        tbl.set_excluded(self._excluded)
                    self._tables[tao_type] = tbl
        return tbl

    @property
    def excluded(self) -> frozenset:
        """The registry-wide dead-worker mask (see :meth:`set_excluded`)."""
        return self._excluded

    def set_excluded(self, excluded: frozenset) -> None:
        """Propagate the dead-worker mask to every (current and future)
        table; an empty mask restores the original fast-query paths."""
        excluded = frozenset(excluded)
        with self._lock:
            self._excluded = excluded
            tables = tuple(self._tables.values())
        for tbl in tables:
            tbl.set_excluded(excluded)

    def __contains__(self, tao_type: str) -> bool:
        return tao_type in self._tables

    def types(self) -> tuple[str, ...]:
        return tuple(self._tables)

    def reset(self) -> None:
        """Reset every existing table in place (held references stay valid
        and come back zero-initialised)."""
        with self._lock:
            tables = tuple(self._tables.values())
        for tbl in tables:
            tbl.reset()

    def learned_cells(self) -> int:
        """Tried cells summed over every table (see :meth:`PTT.learned_cells`)."""
        with self._lock:
            tables = tuple(self._tables.values())
        return sum(tbl.learned_cells() for tbl in tables)
