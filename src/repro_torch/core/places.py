"""Elastic places: worker topology, resource widths and the leader formula.

The paper schedules moldable tasks (TAOs) onto *elastic places* — contiguous
groups of ``width`` workers.  The leader of a place is computed with the
XiTAO formula ``leader = floor(core / width) * width`` so that only aligned
workers are eligible leaders for wide places (paper §3.1).

On the TPU fleet a "worker" is a *device group* (a chip, host or pod slice);
on the HiKey960 reproduction it is a core.  ``WorkerClass`` captures the
single-ISA heterogeneity (big.LITTLE on the board; fast/efficient slice
classes on a fleet).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

BIG = "big"
LITTLE = "little"


def leader_of(core: int, width: int) -> int:
    """XiTAO leader formula: ``floor(core/width) * width`` (paper §3.1)."""
    if width <= 0:
        raise ValueError(f"width must be positive, got {width}")
    return (core // width) * width


def place_members(leader: int, width: int) -> range:
    """Workers participating in the place anchored at ``leader``."""
    return range(leader, leader + width)


def valid_widths(n_workers: int) -> tuple[int, ...]:
    """Power-of-two widths 1..n_workers (paper: k = log2(#cores) widths)."""
    ws = []
    w = 1
    while w <= n_workers:
        ws.append(w)
        w *= 2
    return tuple(ws)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Topology of the heterogeneous worker pool.

    ``classes[i]`` gives the class ('big'/'little') of worker ``i``.  Workers
    of one class are contiguous (as on big.LITTLE and on a fleet where a
    "cluster" is a pod of a given generation).
    """

    classes: tuple[str, ...]

    def __post_init__(self) -> None:
        if not self.classes:
            raise ValueError("ClusterSpec needs at least one worker")
        # Precomputed topology queries.  These sit on the scheduling hot path
        # (PTT.record/width_index per TAO completion, big_workers/
        # little_workers per placement), so they must not rebuild tuples per
        # call; returning the *same* tuple object every time also lets the
        # PTT detect class groups by identity in O(1).  The spec is frozen,
        # so the caches can never go stale (object.__setattr__ bypasses the
        # frozen guard; the extra attrs are not dataclass fields, so eq/hash
        # semantics are unchanged).
        n = len(self.classes)
        widths = valid_widths(n)
        object.__setattr__(self, "_widths", widths)
        object.__setattr__(self, "_width_index",
                           {w: i for i, w in enumerate(widths)})
        object.__setattr__(self, "_workers_by_cls", {
            cls: tuple(i for i, c in enumerate(self.classes) if c == cls)
            for cls in dict.fromkeys(self.classes)
        })
        object.__setattr__(self, "_eligible", {
            w: tuple(range(0, n - w + 1, w)) for w in widths
        })

    # -- basic queries ----------------------------------------------------
    @property
    def n_workers(self) -> int:
        return len(self.classes)

    @property
    def widths(self) -> tuple[int, ...]:
        return self._widths

    @property
    def max_width(self) -> int:
        return self._widths[-1]

    def workers_of(self, cls: str) -> tuple[int, ...]:
        return self._workers_by_cls.get(cls, ())

    @property
    def big_workers(self) -> tuple[int, ...]:
        return self.workers_of(BIG)

    @property
    def little_workers(self) -> tuple[int, ...]:
        return self.workers_of(LITTLE)

    def class_of(self, worker: int) -> str:
        return self.classes[worker]

    def width_index(self, width: int) -> int:
        try:
            return self._width_index[width]
        except KeyError:
            raise ValueError(
                f"width {width} not a valid width for {self.n_workers} workers"
            ) from None

    def eligible_leaders(self, width: int,
                         exclude: frozenset | tuple = ()) -> tuple[int, ...]:
        """Workers that can lead a place of ``width`` (aligned, in-range).

        ``exclude`` masks dead workers (chaos KILL): a place whose *any*
        member is excluded cannot be led.  The empty-mask call returns the
        cached tuple *object* itself, which callers (the PTT) rely on for
        identity checks — chaos disabled must stay byte-identical.
        """
        elig = self._eligible.get(width)
        if elig is None:  # non-power-of-two widths: compute on demand
            elig = tuple(range(0, self.n_workers - width + 1, width))
        if exclude:
            elig = tuple(c for c in elig
                         if not any(m in exclude
                                    for m in range(c, c + width)))
        return elig

    def clusters(self) -> tuple[tuple[str, tuple[int, ...]], ...]:
        """Contiguous (class, workers) runs."""
        runs: list[tuple[str, list[int]]] = []
        for i, c in enumerate(self.classes):
            if runs and runs[-1][0] == c:
                runs[-1][1].append(i)
            else:
                runs.append((c, [i]))
        return tuple((c, tuple(ws)) for c, ws in runs)


def partition_workers(spec: ClusterSpec,
                      n_shards: int) -> tuple[tuple[int, ...], ...]:
    """Split the pool into ``n_shards`` disjoint worker groups for the
    sharded scheduler (`repro.core.shard`).

    Every contiguous class run is sliced proportionally, so each shard
    stays as heterogeneous as the pool allows (a shard of a big.LITTLE
    fleet gets both big and LITTLE workers whenever the runs are large
    enough).  Slices keep global worker ids in ascending order; shards left
    empty by small runs are topped up from the largest shard, so every
    shard owns at least one worker.  Deterministic: a pure function of
    ``(spec, n_shards)``.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards > spec.n_workers:
        raise ValueError(
            f"n_shards={n_shards} exceeds n_workers={spec.n_workers}")
    parts: list[list[int]] = [[] for _ in range(n_shards)]
    for _cls, workers in spec.clusters():
        q, r = divmod(len(workers), n_shards)
        lo = 0
        for s in range(n_shards):
            hi = lo + q + (1 if s < r else 0)
            parts[s].extend(workers[lo:hi])
            lo = hi
    for s in range(n_shards):
        if not parts[s]:
            donor = max(range(n_shards),
                        key=lambda d: (len(parts[d]), -d))
            parts[s].append(parts[donor].pop())
    return tuple(tuple(sorted(p)) for p in parts)


def hikey960() -> ClusterSpec:
    """The paper's evaluation platform: 4 LITTLE (A53) + 4 big (A73).

    Worker ids 0-3 are LITTLE, 4-7 are big (matching a common Linux cpu
    enumeration on HiKey960; the scheduler never relies on which side is
    first, only on ``classes``).
    """
    return ClusterSpec(classes=(LITTLE,) * 4 + (BIG,) * 4)


def homogeneous(n_workers: int, cls: str = BIG) -> ClusterSpec:
    return ClusterSpec(classes=(cls,) * n_workers)


def fleet(n_big_groups: int, n_little_groups: int) -> ClusterSpec:
    """A TPU-fleet style pool: fast slices first, efficient slices after."""
    return ClusterSpec(classes=(BIG,) * n_big_groups + (LITTLE,) * n_little_groups)
