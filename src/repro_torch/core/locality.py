"""Data-locality layer: per-cluster residency and a movement-cost model.

The PTT (``repro.core.ptt``) models *compute* time per (class, impl, width)
but charges nothing for moving a TAO's data between clusters — yet on the
irregular heterogeneous workloads the source paper targets, data movement is
what "Data-aware Dynamic Execution of Irregular Workloads on Heterogeneous
Systems" (arXiv:2502.06304) shows dominating.  This module supplies the
missing half of the model:

* :class:`LocalityTracker` — owned by the :class:`~repro.core.scheduler.
  SchedulerCore`, it maps workers to *cluster indices* (positions in
  ``ClusterSpec.clusters()``), keeps per-cluster resident-byte totals, and
  prices a cross-cluster move of a :class:`~repro.core.dag.DataFootprint`.
* **movement table** — per ``(tao_type, src_cluster, dst_cluster)`` EWMA of
  measured seconds-per-byte, living alongside the PTT with the same 1:4
  blending.  The simulator feeds it *modeled* bytes/bandwidth numbers; the
  threaded runtime feeds it *measured* host-copy (device-put analogue)
  timings.  Untried cells fall back to the modeled ``1 / bandwidth``.
* :func:`replay_moved_bytes` — recomputes moved bytes from a finished trace
  by replaying the residency automaton, the independent side of the
  conservation invariant (bytes moved == off-resident placements x footprint
  bytes) the bench and the property tests assert.

Placement charging itself happens in ``repro.core.policies`` via
``LocalityTracker.penalties`` (a per-cluster extra-seconds vector handed to
the PTT's penalised queries); zero-footprint TAOs never reach any of it.
"""
from __future__ import annotations

import threading
from typing import Iterable, Sequence

from .dag import DataFootprint
from .places import ClusterSpec

# Modeled cross-cluster bandwidth (bytes/second) used until a cell of the
# movement table has a measurement: a DDR-class interconnect between the
# big and LITTLE clusters of the paper's hikey960 board.
DEFAULT_BANDWIDTH = 8.0 * (1 << 30)

# Movement-table EWMA blending, matching the PTT's saved = (4*old + new)/5.
EWMA_OLD_WEIGHT = 4


class LocalityTracker:
    """Residency + movement-cost bookkeeping for one scheduler core.

    ``charge`` is the affinity A/B knob: when ``False`` the tracker still
    *accounts* (hits, misses, moved bytes — the physics of the workload) but
    :meth:`penalties` returns ``None`` so placement decisions ignore data
    location entirely (the affinity-off leg of ``--workload locality``).
    """

    def __init__(self, spec: ClusterSpec, bandwidth: float = DEFAULT_BANDWIDTH,
                 charge: bool = True):
        self.spec = spec
        self.bandwidth = float(bandwidth)
        self.charge = charge
        self._clusters = spec.clusters()
        self.n_clusters = len(self._clusters)
        cluster_of = [0] * spec.n_workers
        for ci, (_cls, workers) in enumerate(self._clusters):
            for w in workers:
                cluster_of[w] = ci
        self._cluster_of = tuple(cluster_of)
        self._lock = threading.Lock()
        # (tao_type, src, dst) -> EWMA measured seconds-per-byte
        self._measured: dict = {}
        self.resident_bytes = [0.0] * self.n_clusters
        self.hits = 0
        self.misses = 0
        self.moved_bytes = 0.0

    # -- topology ----------------------------------------------------------
    def cluster_of(self, worker: int) -> int:
        """Cluster index (position in ``spec.clusters()``) of ``worker``."""
        return self._cluster_of[worker]

    def clusters_of_class(self, cls: str) -> tuple:
        """Cluster indices whose workers are of class ``cls``."""
        return tuple(ci for ci, (c, _w) in enumerate(self._clusters)
                     if c == cls)

    # -- movement-cost model ----------------------------------------------
    def seconds_per_byte(self, tao_type: str, src: int, dst: int) -> float:
        """Measured EWMA transfer rate for the cell, modeled fallback."""
        if src == dst:
            return 0.0
        m = self._measured.get((tao_type, src, dst))
        return m if m is not None else 1.0 / self.bandwidth

    def move_cost(self, tao_type: str, fp: DataFootprint | None,
                  leader: int) -> float:
        """Seconds to bring ``fp`` to ``leader``'s cluster (0 if resident,
        unmaterialised, or absent)."""
        if fp is None or fp.resident < 0:
            return 0.0
        dst = self._cluster_of[leader]
        return fp.nbytes * self.seconds_per_byte(tao_type, fp.resident, dst)

    def penalties(self, tao_type: str, fp: DataFootprint | None):
        """Per-cluster extra seconds for placing ``fp``'s TAO off-resident.

        ``None`` means "nothing to charge" — no footprint, residency not yet
        materialised, or the affinity knob is off — and is the signal for
        policies to take the exact legacy path.
        """
        if not self.charge or fp is None or fp.resident < 0:
            return None
        src = fp.resident
        return tuple(fp.nbytes * self.seconds_per_byte(tao_type, src, dst)
                     for dst in range(self.n_clusters))

    def steal_gated(self, fp: DataFootprint | None, stealer: int,
                    victim: int) -> bool:
        """True when a *steal* must be declined on affinity grounds.

        The gate fires only for the narrow case where stealing is pure
        movement: the TAO sits queued on its data's resident cluster and
        the stealer lives on another one.  Everything else passes — no
        footprint, residency unmaterialised, charging off, same-cluster
        steals, and TAOs already queued off-resident (stealing those can
        only help).  Rescue steals off *dead* victims are the caller's
        business: both vehicles check their own failed set first, so
        rescue-stealing off a dead cluster still pays the move (the
        dispatch-side :meth:`place` charges it) but affinity otherwise
        holds.
        """
        if not self.charge or fp is None or fp.resident < 0:
            return False
        return (self.cluster_of(stealer) != fp.resident
                and self.cluster_of(victim) == fp.resident)

    def record_transfer(self, tao_type: str, src: int, dst: int,
                        nbytes: float, elapsed: float) -> None:
        """Feed one observed transfer into the movement table.

        The simulator records its modeled delays; the threaded runtime
        records wall-clock host-copy timings — both as seconds-per-byte so
        the table is vehicle-agnostic.
        """
        if nbytes <= 0.0 or src == dst:
            return
        rate = max(elapsed, 0.0) / nbytes
        key = (tao_type, src, dst)
        with self._lock:
            old = self._measured.get(key)
            if old is None:
                self._measured[key] = rate
            else:
                self._measured[key] = (EWMA_OLD_WEIGHT * old + rate) / (
                    EWMA_OLD_WEIGHT + 1)

    def movement_table(self) -> dict:
        """Snapshot ``{(tao_type, src, dst): seconds_per_byte}`` (measured
        cells only)."""
        with self._lock:
            return dict(self._measured)

    # -- dispatch accounting ----------------------------------------------
    def place(self, tao_type: str, fp: DataFootprint, leader: int):
        """Account one dispatch of a footprint TAO onto ``leader``.

        Returns ``(hit, moved_bytes, cost_seconds)``.  First touch
        materialises residency on the executing cluster and counts as a hit
        (nothing moved); an off-resident placement is a miss that moves the
        full footprint (sticky data streams it, movable data migrates its
        residency).  Exactly one call per executed trace record is the
        contract :func:`replay_moved_bytes` verifies.
        """
        dst = self._cluster_of[leader]
        with self._lock:
            if fp.resident < 0:
                fp.resident = dst
                self.resident_bytes[dst] += fp.nbytes
                self.hits += 1
                return (True, 0.0, 0.0)
            if dst == fp.resident:
                self.hits += 1
                return (True, 0.0, 0.0)
            src = fp.resident
            self.misses += 1
            self.moved_bytes += fp.nbytes
            if not fp.sticky:
                self.resident_bytes[src] -= fp.nbytes
                self.resident_bytes[dst] += fp.nbytes
                fp.resident = dst
        return (False, fp.nbytes,
                fp.nbytes * self.seconds_per_byte(tao_type, src, dst))

    # -- lifecycle ---------------------------------------------------------
    def reset_counters(self) -> None:
        """Zero the per-run accounting (movement table survives, like the
        PTT across a ``reset_counters``)."""
        with self._lock:
            self.hits = 0
            self.misses = 0
            self.moved_bytes = 0.0
            self.resident_bytes = [0.0] * self.n_clusters

    def reset(self) -> None:
        """Forget measurements *and* counters (the reset_learning analogue)."""
        with self._lock:
            self._measured.clear()
        self.reset_counters()


def replay_moved_bytes(trace: Iterable, spec: ClusterSpec,
                       footprints: dict) -> float:
    """Recompute total moved bytes by replaying a finished trace.

    ``footprints`` maps ``dag_id -> (nbytes, sticky)``.  Each trace record of
    a footprint DAG is one dispatch: the first record materialises residency,
    later off-resident records move ``nbytes`` (and migrate residency when
    movable).  Records are replayed in start-time order, which is dispatch
    order on both vehicles; the return value must equal the sum of
    ``moved_bytes`` the vehicles accounted live — the conservation check.
    """
    clusters = spec.clusters()
    cluster_of = [0] * spec.n_workers
    for ci, (_cls, workers) in enumerate(clusters):
        for w in workers:
            cluster_of[w] = ci
    resident: dict = {}
    moved = 0.0
    for rec in sorted(trace, key=lambda r: (r.start, r.end)):
        fp = footprints.get(rec.dag_id)
        if fp is None:
            continue
        nbytes, sticky = fp
        dst = cluster_of[rec.leader]
        cur = resident.get(rec.dag_id, -1)
        if cur < 0:
            resident[rec.dag_id] = dst
            continue
        if dst != cur:
            moved += nbytes
            if not sticky:
                resident[rec.dag_id] = dst
    return moved
