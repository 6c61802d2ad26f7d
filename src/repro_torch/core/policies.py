"""Scheduling policies (paper §3.2-§3.3).

All policies implement ``place(tao, ctx, waker) -> Placement`` and are invoked
from the commit-and-wakeup mechanism when a TAO becomes ready.  They are
shared verbatim between the threaded runtime and the discrete-event simulator
through the small ``SchedulerContext`` interface.

Implemented policies:

* ``HomogeneousPolicy``    — the paper's base case: DPA + random work stealing,
                             programmer width hints, no heterogeneity awareness.
* ``CriticalityAwarePolicy``— CATS-style, *heterogeneity-aware* variant:
                             critical TAOs -> random big core, rest -> LITTLE.
* ``CriticalityPTTPolicy`` — CATS-style, *unaware* variant: critical TAOs ->
                             best core learned from the PTT, rest -> random.
* ``WeightBasedPolicy``    — Bias-style: weight = t_LITTLE / t_big from the
                             PTT vs an adaptive threshold (init 1.5, EWMA 1:6).
* ``MoldingPolicy``        — width molding wrapper: load-based first,
                             history-based (time*width) otherwise; composes
                             with any placement policy above.

Implementation variants (arXiv:2108.13871): every policy picks the TAO's
implementation *jointly* with leader and width.  Single-variant TAOs (the
default) take the exact legacy code path — same PTT reads, same RNG draws —
so pre-variant schedules reproduce byte-identically; TAOs declaring several
``ImplVariant``s route through the per-(class, impl, width) PTT cells:
untried (impl, width) cells are explored first (zero-init, impl-major in
declared order), then the EWMA-best cell wins.  Preemption-aware damping
(displacement history via ``SchedulerContext.displacements``) shrinks the
width/impl aggressiveness of chronically-preempted tenants: a damped tenant
stops exploring untried variant cells and molds narrower.
"""
from __future__ import annotations

import dataclasses
import math
import random
import threading
from typing import Protocol, Sequence

from .dag import DEFAULT_IMPL, TAO
from .places import BIG, LITTLE, ClusterSpec, leader_of
from .ptt import PTT, PTTRegistry

# one width halving (and exploration shut-off) per this many displacements,
# capped: displacement counts accumulate over a whole run, and an uncapped
# level would crush a long-running bursty tenant's widths to 1 (and its
# throughput/goodput with them) instead of gently de-escalating it
DAMP_DISPLACEMENTS = 4
DAMP_MAX_LEVEL = 2

# Inter-shard work-exchange imbalance threshold (docs/POLICIES.md "Exchange
# threshold").  A worker whose own shard has no stealable work may import a
# TAO from the most-loaded *other* shard only when the donor's queued
# backlog exceeds its own shard's by at least this many TAOs:
# ``qlen[donor] >= qlen[own] + EXCHANGE_THRESHOLD``.  Below the threshold
# the imbalance is noise-level and the exchange would pay cross-shard data
# movement (the PR 9 locality cost) for no structural gain.
EXCHANGE_THRESHOLD = 4


@dataclasses.dataclass(frozen=True)
class Placement:
    """Outcome of a wake-up decision."""

    target: int   # worker whose ready-queue receives the TAO
    width: int    # resource width chosen for the TAO
    impl: str = DEFAULT_IMPL  # implementation variant chosen for the TAO


class SchedulerContext(Protocol):
    """What policies may observe about the running system."""

    spec: ClusterSpec
    ptt: PTTRegistry
    rng: random.Random

    def system_load(self, namespace: int | None = None) -> int:
        """Number of ready + running TAOs (the molding load signal) —
        globally by default, or restricted to one DAG namespace."""
        ...

    def active_namespaces(self) -> int:
        """Number of DAG namespaces with at least one ready/running TAO."""
        ...

    def running_max_criticality(self, namespace: int = 0) -> int:
        """Maximum criticality among currently scheduled, unfinished TAOs of
        one DAG namespace (criticalities are only comparable within a DAG)."""
        ...

    def displacements(self, namespace: int = 0) -> int:
        """How often this namespace's tenant has been preempted (displacement
        history).  Policies damp width/impl aggressiveness as it grows."""
        ...

    def dead_workers(self) -> frozenset:
        """Workers currently failed (chaos KILL); empty on healthy runs.
        Policies read it through ``getattr`` so synthetic contexts without
        the method behave as fully healthy."""
        ...


# ---------------------------------------------------------------------------
# shared joint-decision helpers
# ---------------------------------------------------------------------------
def _variant_names(tao: TAO) -> tuple:
    """Variant names the policy may choose from for this wake-up.

    A preempted TAO's continuation is pinned to the variant it already ran
    under — its chunk state is impl-specific, so switching mid-TAO would
    resume the wrong payload.
    """
    cursor = tao.cursor
    if cursor is not None and getattr(cursor, "next_chunk", 0) > 0:
        return (tao.assigned_impl,)
    return tao.impl_names()


def _damp_level(tao: TAO, ctx: SchedulerContext) -> int:
    """Width-halving / exploration-suppression level from displacement
    history (0 = undamped; byte-identity for preemption-free runs)."""
    fn = getattr(ctx, "displacements", None)
    if fn is None:
        return 0
    return min(fn(tao.dag_id) // DAMP_DISPLACEMENTS, DAMP_MAX_LEVEL)


def _dead_set(ctx) -> frozenset:
    """Workers currently failed (chaos KILL); empty on healthy runs (and
    for synthetic contexts that predate the chaos engine)."""
    fn = getattr(ctx, "dead_workers", None)
    return fn() if fn is not None else frozenset()


def _alive_pool(ctx, pool):
    """Filter a placement pool against the dead-worker set.

    With no dead workers this returns ``pool`` itself — the very same
    tuple object — so ``rng.choice`` consumes identical state and healthy
    schedules stay byte-identical.  If every pool member is dead the
    original pool is returned (the vehicle redirects off dead targets)."""
    dead = _dead_set(ctx)
    if not dead:
        return pool
    alive = tuple(w for w in pool if w not in dead)
    return alive or pool


def _move_penalty(tao: TAO, ctx) -> tuple | None:
    """Per-cluster movement-cost vector for this TAO's data footprint.

    ``None`` — the overwhelmingly common case: no footprint, residency not
    yet materialised, no :class:`~repro.core.locality.LocalityTracker` on the
    context, or affinity charging switched off — is the signal to take the
    exact legacy decision path.  Zero-footprint TAOs pay a single attribute
    read here and nothing else (pinned-signature requirement)."""
    fp = tao.footprint
    if fp is None:
        return None
    loc = getattr(ctx, "locality", None)
    if loc is None:
        return None
    return loc.penalties(tao.type, fp)


def _class_penalties(ctx, penalty: Sequence[float]) -> tuple:
    """Collapse the per-cluster penalty vector to ``(p_big, p_little)`` for
    the cluster-mean policies (optimistic min when a class spans several
    clusters; exact on the contiguous-run specs where class == cluster)."""
    loc = ctx.locality
    p_big = min((penalty[c] for c in loc.clusters_of_class(BIG)),
                default=0.0)
    p_little = min((penalty[c] for c in loc.clusters_of_class(LITTLE)),
                   default=0.0)
    return p_big, p_little


def _clamp_width(spec: ClusterSpec, width: int) -> int:
    """Round down to a valid power-of-two width (mirrors the core's clamp,
    needed here so joint queries address real PTT cells)."""
    widths = spec.widths
    if width in widths:
        return width
    best = widths[0]
    for w in widths:
        if w <= width:
            best = w
    return best


def _choose_impl(table: PTT, leader: int, width: int, names: Sequence[str],
                 explore: bool) -> str:
    """Pick a variant for a fixed (leader, width) cell.

    ``explore=True``: untried variants first in declared order, then
    EWMA-best (:meth:`PTT.best_impl`).  ``explore=False`` (damped tenants):
    best among *tried* cells only, falling back to the first variant.
    """
    if explore:
        impl, _t = table.best_impl(leader, width, names)
        return impl if impl is not None else names[0]
    best = (None, math.inf)
    for nm in names:
        t = table.time(leader, width, impl=nm)
        if t > 0.0 and t < best[1]:
            best = (nm, t)
    return best[0] if best[0] is not None else names[0]


class Policy:
    name = "abstract"

    def place(self, tao: TAO, ctx: SchedulerContext, waker: int) -> Placement:
        raise NotImplementedError

    def reset(self) -> None:
        """Clear adaptive state between runs (threshold etc.)."""


# ---------------------------------------------------------------------------
# Base case: homogeneous DPA + random work stealing
# ---------------------------------------------------------------------------
class HomogeneousPolicy(Policy):
    """The paper's baseline: wake up locally, rely on random stealing.

    With variants: the leader is fixed (local wake-up), so the joint decision
    degenerates to :func:`_choose_impl` at the waker's place — no RNG, so
    single-variant TAOs keep the draw-free legacy behaviour trivially."""

    name = "homogeneous"

    def place(self, tao: TAO, ctx: SchedulerContext, waker: int) -> Placement:
        names = _variant_names(tao)
        if len(names) == 1:
            return Placement(target=waker, width=tao.width_hint, impl=names[0])
        width = _clamp_width(ctx.spec, tao.width_hint)
        leader = leader_of(waker % ctx.spec.n_workers, width)
        impl = _choose_impl(ctx.ptt.table(tao.type), leader, width, names,
                            explore=_damp_level(tao, ctx) == 0)
        return Placement(target=waker, width=tao.width_hint, impl=impl)


# ---------------------------------------------------------------------------
# Criticality-based scheduling (paper §3.2.1)
# ---------------------------------------------------------------------------
def _is_critical(tao: TAO, ctx: SchedulerContext) -> bool:
    """Compare against the max criticality currently in flight (atomic var in
    the C++ original; the runtime keeps an equivalent multiset).  The
    comparison is namespaced per DAG: under a concurrent multi-DAG workload a
    tenant's critical path is judged against its own TAOs only."""
    return tao.criticality >= ctx.running_max_criticality(tao.dag_id)


class CriticalityAwarePolicy(Policy):
    """Heterogeneity-*aware*: needs the static big/LITTLE map."""

    name = "crit-aware"

    def place(self, tao: TAO, ctx: SchedulerContext, waker: int) -> Placement:
        if _is_critical(tao, ctx):
            pool = ctx.spec.big_workers or ctx.spec.little_workers
        else:
            pool = ctx.spec.little_workers or ctx.spec.big_workers
        target = ctx.rng.choice(_alive_pool(ctx, pool))
        names = _variant_names(tao)
        if len(names) == 1:
            return Placement(target=target, width=tao.width_hint,
                             impl=names[0])
        # joint decision at the drawn place: the cluster choice stays the
        # criticality signal's; the variant adapts to that cluster's cells
        width = _clamp_width(ctx.spec, tao.width_hint)
        impl = _choose_impl(ctx.ptt.table(tao.type),
                            leader_of(target, width), width, names,
                            explore=_damp_level(tao, ctx) == 0)
        return Placement(target=target, width=tao.width_hint, impl=impl)


class CriticalityPTTPolicy(Policy):
    """Heterogeneity-*unaware*: critical TAOs go to the PTT-best core for the
    TAO's width (untried cores explored first); non-critical go random."""

    name = "crit-ptt"

    @staticmethod
    def _random_target(ctx: SchedulerContext) -> int:
        """Uniform random worker; dead workers masked out under chaos
        (the healthy path keeps the original single randrange draw)."""
        dead = _dead_set(ctx)
        if dead:
            alive = tuple(w for w in range(ctx.spec.n_workers)
                          if w not in dead)
            if alive:
                return ctx.rng.choice(alive)
        return ctx.rng.randrange(ctx.spec.n_workers)

    def place(self, tao: TAO, ctx: SchedulerContext, waker: int) -> Placement:
        width = tao.width_hint
        names = _variant_names(tao)
        penalty = _move_penalty(tao, ctx)
        if len(names) == 1:
            if _is_critical(tao, ctx):
                table = ctx.ptt.table(tao.type)
                if penalty is None:
                    leader, _t = table.best_leader(width, impl=names[0])
                else:
                    leader, _t = table.best_leader_penalized(
                        width, penalty, impl=names[0])
                if leader is not None:
                    return Placement(target=leader, width=width,
                                     impl=names[0])
            return Placement(target=self._random_target(ctx),
                             width=width, impl=names[0])
        table = ctx.ptt.table(tao.type)
        explore = _damp_level(tao, ctx) == 0
        cw = _clamp_width(ctx.spec, width)
        if _is_critical(tao, ctx):
            # fully joint: best (impl, leader) cell for the width, untried
            # cells first (impl-major) unless the tenant is damped; footprint
            # TAOs charge the movement cost inside the cell comparison
            if explore and penalty is not None:
                impl, leader, _t = table.best_cell_penalized(cw, names,
                                                             penalty)
            elif explore:
                impl, leader, _t = table.best_cell(cw, names)
            else:
                impl, leader = None, None
                best_t = math.inf
                for nm in names:
                    cand, t = table.best_leader(cw, impl=nm)
                    if cand is not None and 0.0 < t < best_t:
                        impl, leader, best_t = nm, cand, t
            if leader is not None:
                return Placement(target=leader, width=width, impl=impl)
        target = self._random_target(ctx)
        impl = _choose_impl(table, leader_of(target, cw), cw, names,
                            explore=explore)
        return Placement(target=target, width=width, impl=impl)


# ---------------------------------------------------------------------------
# Weight-based scheduling (paper §3.2.2)
# ---------------------------------------------------------------------------
class WeightBasedPolicy(Policy):
    """Bias-style: ``weight = t_LITTLE / t_big`` vs an adaptive threshold.

    threshold_0 = 1.5;  threshold <- (potential_weight + 6*threshold) / 7
    (paper: "updated at every comparison with a weighted ratio of 1:6").
    """

    name = "weight"
    INITIAL_THRESHOLD = 1.5
    OLD_WEIGHT = 6

    def __init__(self) -> None:
        self.threshold = self.INITIAL_THRESHOLD
        # Policies run OUTSIDE the SchedulerCore lock (see admit), so the
        # threshold EWMA read-modify-write needs its own tiny lock on the
        # threaded runtime — otherwise concurrent wake-ups silently drop
        # blends.  Never held while ctx locks are taken, so no ordering
        # hazard with the core lock.
        self._tlock = threading.Lock()

    def reset(self) -> None:
        self.threshold = self.INITIAL_THRESHOLD

    # -- threshold storage / decision hooks (AdaptivePolicy overrides) ------
    def _threshold(self, tao: TAO) -> float:
        return self.threshold

    def _store_threshold(self, tao: TAO, value: float) -> None:
        self.threshold = value

    def _goes_big(self, tao: TAO, ctx: SchedulerContext, weight: float,
                  threshold: float) -> bool:
        return weight > threshold

    def _cluster_times(self, table: PTT, spec: ClusterSpec, width: int,
                       impl: str) -> tuple:
        """(t_big, t_little) for one variant, with the molded-width fallback:
        under a molding wrapper the PTT only ever records the *molded*
        widths, so the hinted width's rows can stay at zero forever — fall
        back to the first width with data for both clusters (the
        t_LITTLE/t_big speed ratio is what matters, not the absolute times
        at the hinted width)."""
        bigs, littles = spec.big_workers, spec.little_workers
        t_big = table.cluster_time(bigs, width, impl=impl)
        t_little = table.cluster_time(littles, width, impl=impl)
        if t_big == 0.0 and t_little == 0.0:
            for w in spec.widths:
                tb = table.cluster_time(bigs, w, impl=impl)
                tl = table.cluster_time(littles, w, impl=impl)
                if tb > 0.0 and tl > 0.0:
                    t_big, t_little = tb, tl
                    break
        return t_big, t_little

    def place(self, tao: TAO, ctx: SchedulerContext, waker: int) -> Placement:
        width = tao.width_hint
        spec = ctx.spec
        bigs, littles = spec.big_workers, spec.little_workers
        names = _variant_names(tao)
        if not bigs or not littles:  # homogeneous pool: nothing to bias
            return Placement(target=waker, width=width, impl=names[0])
        table = ctx.ptt.table(tao.type)
        penalty = _move_penalty(tao, ctx)
        if len(names) > 1:
            return self._place_joint(tao, ctx, table, names, width,
                                     penalty=penalty)
        impl = names[0]
        t_big, t_little = self._cluster_times(table, spec, width, impl)
        if penalty is not None:
            return self._place_affine(tao, ctx, t_big, t_little, width, impl,
                                      penalty)
        # zero-init exploration: measure the untried cluster first
        if t_big == 0.0 and t_little == 0.0:
            pool = bigs if ctx.rng.random() < 0.5 else littles
            return Placement(target=ctx.rng.choice(_alive_pool(ctx, pool)),
                             width=width, impl=impl)
        if t_big == 0.0:
            return Placement(target=ctx.rng.choice(_alive_pool(ctx, bigs)),
                             width=width, impl=impl)
        if t_little == 0.0:
            return Placement(target=ctx.rng.choice(_alive_pool(ctx, littles)),
                             width=width, impl=impl)
        return self._biased(tao, ctx, t_big, t_little, width, impl)

    def _place_affine(self, tao: TAO, ctx: SchedulerContext, t_big: float,
                      t_little: float, width: int, impl: str,
                      penalty: Sequence[float]) -> Placement:
        """Placement for a TAO whose data is resident somewhere.

        Fully-measured clusters go through the weight decision on
        *effective* times (compute + movement); while either cluster is
        unmeasured, exploration is affinity-first — the TAO runs where its
        data lives (the cheapest-penalty pool), so the resident cluster gets
        measured and the data never moves just to fill a PTT cell.  Remote
        cells still get measured through steals and rescue redirects, which
        is when paying the move is already justified."""
        p_big, p_little = _class_penalties(ctx, penalty)
        if t_big > 0.0 and t_little > 0.0:
            return self._biased(tao, ctx, t_big, t_little, width, impl,
                                penalty2=(p_big, p_little))
        if p_big < p_little:
            pool = ctx.spec.big_workers
        elif p_little < p_big:
            pool = ctx.spec.little_workers
        else:  # equidistant (or zero-cost): fall back to measured preference
            pool = (ctx.spec.big_workers if t_big > 0.0
                    else ctx.spec.little_workers)
        return Placement(target=ctx.rng.choice(_alive_pool(ctx, pool)),
                         width=width, impl=impl)

    def _biased(self, tao: TAO, ctx: SchedulerContext, t_big: float,
                t_little: float, width: int, impl: str,
                penalty2: tuple | None = None) -> Placement:
        """The weight-vs-threshold decision for fully-measured times.

        ``penalty2 = (p_big, p_little)`` movement costs make the *decision*
        weight the ratio of effective times; the threshold EWMA still blends
        the pure compute weight, so footprint-specific movement costs never
        pollute the learned compute profile."""
        weight = t_little / t_big
        # adaptive threshold: EWMA 1:6 toward the mean weight of the system.
        # Read and blend atomically (the decision below uses the pre-update
        # threshold, as before; _goes_big stays outside the lock because it
        # may take the SchedulerCore lock via running_max_criticality).
        with self._tlock:
            threshold = self._threshold(tao)
            self._store_threshold(tao, (weight + self.OLD_WEIGHT * threshold)
                                  / (self.OLD_WEIGHT + 1))
        decide = weight
        if penalty2 is not None:
            p_big, p_little = penalty2
            decide = (t_little + p_little) / (t_big + p_big)
        goes_big = self._goes_big(tao, ctx, decide, threshold)
        pool = ctx.spec.big_workers if goes_big else ctx.spec.little_workers
        return Placement(target=ctx.rng.choice(_alive_pool(ctx, pool)),
                         width=width, impl=impl)

    def _place_joint(self, tao: TAO, ctx: SchedulerContext, table: PTT,
                     names: Sequence[str], width: int,
                     penalty: Sequence[float] | None = None) -> Placement:
        """Joint variant x cluster decision for multi-variant TAOs.

        Exploration is impl-major in declared order (the per-variant analogue
        of the zero-init branches above): the first variant missing a
        cluster measurement gets measured there, unless the tenant is damped.
        Once every variant has both cluster times, the variant whose *faster*
        cluster is fastest wins, and its own t_LITTLE/t_big weight feeds the
        shared threshold EWMA — so the big/LITTLE bias is always judged on
        the times of the variant actually being placed.
        """
        spec = ctx.spec
        bigs, littles = spec.big_workers, spec.little_workers
        explore = _damp_level(tao, ctx) == 0
        if penalty is not None:
            # joint decision under data gravity: fully-measured variants
            # compete on effective (compute + movement) times; with nothing
            # fully measured, affinity-first exploration places the first
            # variant where the data lives (see _place_affine)
            p_big, p_little = _class_penalties(ctx, penalty)
            measured = []
            for impl in names:
                t_big, t_little = self._cluster_times(table, spec, width,
                                                      impl)
                if t_big > 0.0 and t_little > 0.0:
                    measured.append((min(t_big + p_big, t_little + p_little),
                                     t_big, t_little, impl))
            if measured:
                _best, t_big, t_little, impl = min(measured)
                return self._biased(tao, ctx, t_big, t_little, width, impl,
                                    penalty2=(p_big, p_little))
            impl = names[0]
            t_big, t_little = self._cluster_times(table, spec, width, impl)
            return self._place_affine(tao, ctx, t_big, t_little, width,
                                      impl, penalty)
        measured = []
        for impl in names:
            t_big, t_little = self._cluster_times(table, spec, width, impl)
            if explore:
                if t_big == 0.0 and t_little == 0.0:
                    pool = bigs if ctx.rng.random() < 0.5 else littles
                    return Placement(
                        target=ctx.rng.choice(_alive_pool(ctx, pool)),
                        width=width, impl=impl)
                if t_big == 0.0:
                    return Placement(
                        target=ctx.rng.choice(_alive_pool(ctx, bigs)),
                        width=width, impl=impl)
                if t_little == 0.0:
                    return Placement(
                        target=ctx.rng.choice(_alive_pool(ctx, littles)),
                        width=width, impl=impl)
            if t_big > 0.0 and t_little > 0.0:
                measured.append((min(t_big, t_little), t_big, t_little, impl))
        if not measured:
            # damped and nothing fully measured: place the first variant as
            # the single-variant path would, without exploring new cells
            impl = names[0]
            t_big, t_little = self._cluster_times(table, spec, width, impl)
            if t_big > 0.0 and t_little > 0.0:
                return self._biased(tao, ctx, t_big, t_little, width, impl)
            if t_big == 0.0 and t_little == 0.0:
                pool = bigs if ctx.rng.random() < 0.5 else littles
            elif t_big == 0.0:
                pool = bigs
            else:
                pool = littles
            return Placement(target=ctx.rng.choice(_alive_pool(ctx, pool)),
                             width=width, impl=impl)
        _best, t_big, t_little, impl = min(measured)
        return self._biased(tao, ctx, t_big, t_little, width, impl)


# ---------------------------------------------------------------------------
# Adaptive per-type thresholds (arXiv:1905.00673-style)
# ---------------------------------------------------------------------------
class AdaptivePolicy(WeightBasedPolicy):
    """Weight-based placement with *per-type* adaptive thresholds.

    ``WeightBasedPolicy`` keeps one global EWMA threshold, so under a mixed
    stream every kernel class is compared against the mixture mean: a copy
    TAO arriving after a burst of matmuls sees a threshold dragged up by
    matmul weights.  The adaptive follow-up (arXiv:1905.00673) keeps the
    comparison *per task type* — each type's threshold tracks the EWMA of
    that type's own weights, so the big/LITTLE split adapts independently
    per class as load and interference drift.

    Two changes over the single-threshold policy (the placement protocol —
    exploration, EWMA blend — is inherited):

    * ``thresholds[type]`` — independent EWMA (same 1:6 blend, same 1.5
      init) per TAO type.
    * criticality boost — a TAO on its DAG's critical path with weight >= 1
      (big is at least as fast) goes big even below threshold, folding the
      §3.2.1 criticality signal into the weight decision.
    """

    name = "adaptive"

    def __init__(self) -> None:
        super().__init__()   # keep the base `threshold` attribute contract
        self.thresholds: dict[str, float] = {}

    def reset(self) -> None:
        super().reset()
        self.thresholds.clear()

    def _threshold(self, tao: TAO) -> float:
        return self.thresholds.get(tao.type, self.INITIAL_THRESHOLD)

    def _store_threshold(self, tao: TAO, value: float) -> None:
        self.thresholds[tao.type] = value

    def _goes_big(self, tao: TAO, ctx: SchedulerContext, weight: float,
                  threshold: float) -> bool:
        return weight > threshold or (weight >= 1.0 and _is_critical(tao, ctx))


# ---------------------------------------------------------------------------
# Task molding (paper §3.3)
# ---------------------------------------------------------------------------
class MoldingPolicy(Policy):
    """Width molding wrapper: *load-based* primarily, *history-based* when the
    system is loaded; placement is delegated to ``inner``.

    * load-based: when the load is lower than the available resources, widen
      to the fair share (rounded down to a valid power-of-two width) so idle
      resources get exploited.  With ``workload_aware=True`` (the default)
      the sizing is *per tenant*: each active DAG namespace gets an equal
      quota of the pool (``n_workers // active_namespaces``) and the TAO's
      width is its namespace's share of that quota — so a 5-node tenant
      arriving during a 3000-node tenant's burst still gets widened, instead
      of seeing the global in-flight counter already past ``n_workers``.
      With a single active namespace this reduces exactly to the legacy
      global-counter formula (``workload_aware=False`` keeps that formula
      unconditionally).
    * history-based: within the (tentative) leader's PTT row, adopt width w
      only if ``time[w] * w < time[cur]`` — i.e. extra resources must pay for
      themselves (paper: "the recorded execution time for that width x the
      width has to be lower than the current execution time").  Untried widths
      are explored first (zero-init).

    Continuations: a preempted TAO re-entering ``admit`` carries a
    mid-way :class:`~repro.core.preemption.ChunkCursor`; its molded width
    is capped at the chunks it has left (extra members would join an
    exhausted cursor and claim nothing).  Fresh TAOs are untouched.
    """

    name = "molding"

    def __init__(self, inner: Policy, workload_aware: bool = True):
        self.inner = inner
        self.workload_aware = workload_aware
        self.name = f"molding({inner.name})"

    def reset(self) -> None:
        self.inner.reset()

    # -- width selection ----------------------------------------------------
    def _load_based_width(self, tao: TAO, ctx: SchedulerContext,
                          cur: int) -> int | None:
        n = ctx.spec.n_workers
        if self.workload_aware:
            # fair share across active tenants, then across the TAO's own
            # namespace load (the TAO itself is not yet admitted, so a
            # just-arrived tenant sees load 0 -> the full quota)
            quota = n // max(ctx.active_namespaces(), 1)
            load = ctx.system_load(tao.dag_id)
        else:
            quota = n
            load = ctx.system_load()
        if load >= quota:
            return None  # tenant quota busy: no idle-resource justification
        share = quota // max(load, 1)
        w = 1
        while w * 2 <= share and w * 2 <= ctx.spec.max_width:
            w *= 2
        return max(w, cur) if w > cur else cur

    def _history_based_width(self, tao: TAO, ctx: SchedulerContext,
                             leader: int, cur: int,
                             impl: str = DEFAULT_IMPL) -> int:
        table = ctx.ptt.table(tao.type)
        # the current width is itself a configuration to test: explore it
        # before hopping elsewhere (zero-init exploration, paper §3.1)
        if (cur in ctx.spec.widths
                and leader_of(leader, cur) == leader
                and table.untried(leader, cur, impl=impl)):
            return cur
        best_w, best_cost = table.best_width(leader, impl=impl)
        if best_w is None:
            return cur
        if best_cost == 0.0:     # some other width untried: explore it
            return best_w
        t_cur = (table.time(leader, cur, impl=impl)
                 if cur in ctx.spec.widths and leader_of(leader, cur) == leader
                 else 0.0)
        if t_cur == 0.0:
            return cur
        return best_w if best_cost < t_cur else cur

    def place(self, tao: TAO, ctx: SchedulerContext, waker: int) -> Placement:
        base = self.inner.place(tao, ctx, waker)
        cur = base.width
        molded = self._load_based_width(tao, ctx, cur)
        if molded is None:
            leader = leader_of(base.target, cur)
            # fair-share/history sizing applies per chosen impl: the width
            # that pays for itself under the ref variant may not under the
            # Pallas one, so the (time*width) query reads the impl's cells
            molded = self._history_based_width(tao, ctx, leader, cur,
                                               impl=base.impl)
        # chosen variant's declared width bounds (no-op for legacy TAOs)
        lo, hi = tao.width_bounds(base.impl)
        if hi > 0:
            while molded > hi:
                molded //= 2
        while molded < lo and molded * 2 <= ctx.spec.max_width:
            molded *= 2
        # preemption-aware damping: a chronically-displaced tenant molds
        # narrower (one halving per DAMP_DISPLACEMENTS displacements), so
        # its continuations stop grabbing places it keeps losing.  Level 0
        # (any preemption-free run) leaves the width untouched.
        for _ in range(_damp_level(tao, ctx)):
            if molded <= max(lo, 1):
                break
            molded //= 2
        # a preempted TAO's continuation (cursor mid-way) carries fewer
        # chunks than the original: never mold it wider than the chunks it
        # has left — extra members would join and find nothing to claim.
        # Fresh TAOs (cursor absent or at 0) are untouched, so schedules
        # without preemption stay byte-identical.
        cursor = tao.cursor
        if cursor is not None and cursor.next_chunk > 0:
            rem = max(1, cursor.unclaimed)
            while molded > rem:
                molded //= 2
        return Placement(target=base.target, width=molded, impl=base.impl)


# ---------------------------------------------------------------------------
# registry used by benchmarks / CLI
# ---------------------------------------------------------------------------
def make_policy(name: str) -> Policy:
    """Factory: 'homogeneous', 'crit-aware', 'crit-ptt', 'weight',
    'adaptive', and any of them wrapped as 'molding:<name>' (per-namespace
    workload-aware sizing) or 'molding-global:<name>' (legacy global
    in-flight counter)."""
    if name.startswith("molding:"):
        return MoldingPolicy(make_policy(name.split(":", 1)[1]))
    if name.startswith("molding-global:"):
        return MoldingPolicy(make_policy(name.split(":", 1)[1]),
                             workload_aware=False)
    return {
        "homogeneous": HomogeneousPolicy,
        "crit-aware": CriticalityAwarePolicy,
        "crit-ptt": CriticalityPTTPolicy,
        "weight": WeightBasedPolicy,
        "adaptive": AdaptivePolicy,
    }[name]()


ALL_POLICY_NAMES = (
    "homogeneous",
    "crit-aware",
    "crit-ptt",
    "weight",
    "adaptive",
    "molding:crit-ptt",
    "molding:weight",
    "molding:adaptive",
)
