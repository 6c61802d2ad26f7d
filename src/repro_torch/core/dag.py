"""TAO-DAG: mixed-mode task graphs and the criticality pre-pass.

A TAO (Task Assembly Object) is a *moldable* parallel node of the global DAG:
the runtime may execute it on an elastic place of any valid width.  ``work``
is deliberately abstract — the threaded runtime binds it to real (jitted JAX)
chunk functions, the simulator binds it to a cost model, and the LM
orchestrators bind it to pjit'd train/serve steps on mesh slices.

Criticality (paper §3.2.1): a recursive top-down pass assigns
``crit(n) = 1 + max(crit(children))`` so the first node of the longest path
carries the highest value.  We implement it iteratively (reverse topological
order) — the paper's DAGs have 3000 nodes and the fleet DAGs far more, so
Python recursion is not an option.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Callable, Iterable, Sequence

# Name of the implicit implementation variant carried by every TAO that does
# not declare alternatives.  Single-variant TAOs must schedule byte-identically
# to the pre-variant stack, so this is both the legacy PTT key and the
# ``assigned_impl`` of every TAO the policies treat via the legacy code path.
DEFAULT_IMPL = "default"


@dataclasses.dataclass
class DataFootprint:
    """The data a TAO touches, for locality-aware placement (arXiv:2502.06304).

    ``nbytes`` is the operand/cache size the TAO reads; ``resident`` is the
    *cluster index* (a position in ``ClusterSpec.clusters()``) currently
    holding that data, with ``-1`` meaning "not materialised yet" — the first
    execution stamps residency on whatever cluster ran it.  ``sticky`` data
    stays resident where it was materialised even when a TAO executes
    elsewhere (a KV cache pinned to the cluster that ran prefill, streamed on
    off-cluster decodes); movable data migrates with the compute (a training
    operand that re-shards onto the executing cluster).

    The object is deliberately *shared and mutable*: every TAO of one serving
    request (prefill + its decode chain) carries the same instance, so the
    residency the prefill stamps at dispatch time is what the decode TAOs'
    placement decisions later read.  ``home`` is the pre-pinned residency a
    constructor may declare (a shard-local training operand lives on its
    shard's cluster before any TAO runs); ``reset()`` — called per run by
    ``TaoDag.reset_execution_state`` — rewinds ``resident`` to it, so re-runs
    of one workload re-materialise cleanly while pre-pins survive.  TAOs
    without a footprint take the exact legacy scheduling path.
    """

    nbytes: float
    resident: int = -1
    sticky: bool = True
    home: int = -1

    def __post_init__(self) -> None:
        if self.resident < 0 and self.home >= 0:
            self.resident = self.home

    def reset(self) -> None:
        """Rewind run-time residency to the pre-pinned ``home`` (or unset)."""
        self.resident = self.home


@dataclasses.dataclass(frozen=True)
class ImplVariant:
    """One named implementation alternative of a TAO (arXiv:2108.13871).

    ``payload`` is the runtime-specific work for this variant (same contract
    as ``TAO.work``); ``None`` means "reuse ``TAO.work``", which lets cost-only
    variants share a simulator payload.  ``min_width``/``max_width`` bound the
    widths this variant can execute at (``max_width=0`` = unbounded); the
    scheduler clamps its molding decision into ``[min_width, max_width]``
    after choosing the variant.

    Variant payloads must share the TAO's chunk structure (same ``n_chunks``)
    — the preemption :class:`~repro.core.preemption.ChunkCursor` is
    variant-agnostic, and a continuation resumes under the impl it started
    with (the scheduler pins ``assigned_impl`` across preemption segments).
    """

    name: str
    payload: Any = None
    min_width: int = 1
    max_width: int = 0  # 0 = no upper bound beyond the spec's widths


@dataclasses.dataclass
class TAO:
    """One moldable node of the TAO-DAG."""

    type: str
    work: Any = None          # runtime-specific payload (chunks / cost key / step fn)
    width_hint: int = 1       # programmer resource hint (molding may override)
    id: int = -1
    criticality: int = 0
    # wiring (filled by TaoDag.add / add_edge)
    children: list["TAO"] = dataclasses.field(default_factory=list)
    parents: list["TAO"] = dataclasses.field(default_factory=list)
    # execution bookkeeping
    pending: int = 0          # unfinished parents (runtime decrements)
    assigned_width: int = 0   # width chosen at wake-up (0 = not yet scheduled)
    assigned_leader: int = -1
    # multi-tenant: which admitted DAG this node belongs to.  Criticality is
    # only comparable within one DAG, so the scheduler keeps one criticality
    # namespace per dag_id (0 = the legacy single-DAG namespace).
    dag_id: int = 0
    # chunk boundaries (preemption yield points) for payloads that carry no
    # chunk structure of their own; ChunkedWork payloads declare n_chunks
    # themselves and take precedence (see repro.core.preemption.chunk_count)
    n_chunks: int = 1
    # ChunkCursor execution state, created lazily by the vehicles when the
    # TAO first executes under a preemption-capable path; cleared per run
    cursor: Any = None
    # alternative implementations (ordered; empty = the single legacy variant
    # named DEFAULT_IMPL whose payload is ``work``) and the variant chosen at
    # wake-up.  Continuations keep their impl: chunk state is impl-specific.
    impls: tuple = ()
    assigned_impl: str = DEFAULT_IMPL
    # data footprint for locality-aware placement; ``None`` (the default)
    # keeps the TAO on the exact legacy scheduling path.  Workload data like
    # ``impls``/``work`` — reset_execution_state only rewinds its run-time
    # residency (DataFootprint.reset), never detaches it.
    footprint: "DataFootprint | None" = None

    # -- implementation variants ------------------------------------------
    def impl_names(self) -> tuple:
        """Ordered variant names; ``(DEFAULT_IMPL,)`` when none declared."""
        if not self.impls:
            return (DEFAULT_IMPL,)
        return tuple(v.name for v in self.impls)

    def variant(self, name: str) -> ImplVariant | None:
        for v in self.impls:
            if v.name == name:
                return v
        return None

    def payload_for(self, name: str):
        """The runtime payload of variant ``name`` (falls back to ``work``)."""
        v = self.variant(name)
        if v is not None and v.payload is not None:
            return v.payload
        return self.work

    def width_bounds(self, name: str) -> tuple:
        """``(min_width, max_width)`` of variant ``name`` (0 = unbounded)."""
        v = self.variant(name)
        if v is None:
            return (1, 0)
        return (v.min_width, v.max_width)

    def __hash__(self) -> int:  # identity hash: TAOs are unique nodes
        return id(self)

    def __eq__(self, other: object) -> bool:
        return self is other

    def __repr__(self) -> str:
        return (f"TAO(id={self.id}, type={self.type!r}, hint={self.width_hint}, "
                f"crit={self.criticality})")


class TaoDag:
    """A mixed-mode task DAG with criticality assignment."""

    def __init__(self) -> None:
        self.nodes: list[TAO] = []
        self._ids = itertools.count()

    # -- construction -------------------------------------------------------
    def add(self, tao: TAO) -> TAO:
        tao.id = next(self._ids)
        self.nodes.append(tao)
        return tao

    def add_task(self, type: str, work: Any = None, width_hint: int = 1,
                 deps: Sequence[TAO] = (),
                 impls: Sequence[ImplVariant] = ()) -> TAO:
        tao = self.add(TAO(type=type, work=work, width_hint=width_hint,
                           impls=tuple(impls)))
        for d in deps:
            self.add_edge(d, tao)
        return tao

    def add_edge(self, src: TAO, dst: TAO) -> None:
        src.children.append(dst)
        dst.parents.append(src)

    def __len__(self) -> int:
        return len(self.nodes)

    # -- structural queries ---------------------------------------------------
    def roots(self) -> list[TAO]:
        return [n for n in self.nodes if not n.parents]

    def sinks(self) -> list[TAO]:
        return [n for n in self.nodes if not n.children]

    def topological(self) -> list[TAO]:
        """Kahn topological order; raises on cycles."""
        indeg = {n: len(n.parents) for n in self.nodes}
        q = deque(n for n in self.nodes if indeg[n] == 0)
        out: list[TAO] = []
        while q:
            n = q.popleft()
            out.append(n)
            for c in n.children:
                indeg[c] -= 1
                if indeg[c] == 0:
                    q.append(c)
        if len(out) != len(self.nodes):
            raise ValueError("TAO-DAG contains a cycle")
        return out

    # -- the paper's §3.2.1 criticality pre-pass ------------------------------
    def assign_criticality(self) -> None:
        """crit(n) = 1 + max(crit(children)); sinks get 1.

        Equivalent to the paper's recursive top-down traversal, computed
        bottom-up over a topological order so it is O(V+E) and
        recursion-free.  After the pass, the entry of the longest path holds
        the largest value (== critical-path length in nodes).
        """
        for n in reversed(self.topological()):
            if not n.children:
                n.criticality = 1
            else:
                n.criticality = 1 + max(c.criticality for c in n.children)

    def critical_path_length(self) -> int:
        """Length (in nodes) of the longest path."""
        if not self.nodes:
            return 0
        if any(n.criticality == 0 for n in self.nodes):
            self.assign_criticality()
        return max(n.criticality for n in self.nodes)

    def parallelism_degree(self) -> float:
        """Paper §4.4: degree = #TAOs / Cp."""
        cp = self.critical_path_length()
        return len(self.nodes) / cp if cp else 0.0

    # -- execution prep -------------------------------------------------------
    def reset_execution_state(self) -> None:
        for n in self.nodes:
            n.pending = len(n.parents)
            n.assigned_width = 0
            n.assigned_leader = -1
            n.cursor = None
            n.assigned_impl = n.impls[0].name if n.impls else DEFAULT_IMPL
            if n.footprint is not None:
                n.footprint.reset()  # idempotent for shared footprints

    def validate(self) -> None:
        self.topological()  # raises on cycle
        for n in self.nodes:
            for c in n.children:
                if n not in c.parents:
                    raise ValueError(f"edge {n.id}->{c.id} missing back-pointer")


def chain(dag: TaoDag, type: str, n: int, work: Any = None,
          width_hint: int = 1) -> list[TAO]:
    """Utility: a sequential chain of n TAOs (used by kernel profiling)."""
    prev: TAO | None = None
    out = []
    for _ in range(n):
        t = dag.add_task(type, work=work, width_hint=width_hint,
                         deps=[prev] if prev else [])
        out.append(t)
        prev = t
    return out
