"""Elastic fleet management: heartbeats, node loss, re-mesh, restart.

Flow on a real fleet (and simulated deterministically in tests):

1. every device group heartbeats; ``ElasticFleet.observe`` ingests them
2. a missed-heartbeat group is declared DEAD after ``grace`` seconds
3. the manager proposes a new mesh from the survivors (largest power-of-two
   data axis that keeps the model axis intact — TP slices must stay whole)
4. the training driver restores the latest COMPLETE checkpoint into the new
   mesh's shardings (see ``checkpointing``) and resumes; in-flight TAOs on
   dead groups are simply re-admitted (TAOs are idempotent)

Straggler mitigation composes: ``StragglerDetector`` flags slow-but-alive
groups; the fleet manager can demote them to LITTLE class (so the paper's
weight-based policy steers critical work away) or exclude them like failures.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable

from ..core.places import BIG, LITTLE, ClusterSpec


class FleetEvent(enum.Enum):
    HEARTBEAT = "heartbeat"
    DEAD = "dead"
    DEMOTED = "demoted"
    REMESH = "remesh"


@dataclasses.dataclass
class GroupState:
    last_heartbeat: float
    alive: bool = True
    demoted: bool = False


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A (data, model) grid over surviving groups."""

    data: int
    model: int
    groups: tuple[int, ...]  # surviving group ids, row-major into the grid

    @property
    def n_groups(self) -> int:
        return self.data * self.model


class ElasticFleet:
    def __init__(self, n_groups: int, model_parallel: int, grace: float = 30.0,
                 on_event: Callable[[FleetEvent, dict], None] | None = None):
        if n_groups % model_parallel:
            raise ValueError("n_groups must divide by model_parallel")
        self.model_parallel = model_parallel
        self.grace = grace
        self.state = {g: GroupState(last_heartbeat=0.0) for g in range(n_groups)}
        self.on_event = on_event or (lambda e, info: None)

    # -- heartbeat ingestion --------------------------------------------------
    def observe(self, group: int, now: float) -> None:
        st = self.state[group]
        st.last_heartbeat = now
        if not st.alive:
            st.alive = True  # groups may rejoin (elastic scale-up)
        self.on_event(FleetEvent.HEARTBEAT, {"group": group, "now": now})

    def tick(self, now: float) -> list[int]:
        """Mark groups dead after the grace period; returns newly dead ids."""
        newly_dead = []
        for g, st in self.state.items():
            if st.alive and now - st.last_heartbeat > self.grace:
                st.alive = False
                newly_dead.append(g)
                self.on_event(FleetEvent.DEAD, {"group": g, "now": now})
        return newly_dead

    def demote(self, group: int) -> None:
        self.state[group].demoted = True
        self.on_event(FleetEvent.DEMOTED, {"group": group})

    # -- re-meshing -------------------------------------------------------------
    def alive_groups(self) -> list[int]:
        return [g for g, st in self.state.items() if st.alive]

    def plan_mesh(self) -> MeshPlan:
        """Largest power-of-two data axis over survivors, model axis intact.

        TP shards cannot be split across a dead chip, so survivors are taken
        in aligned blocks of ``model_parallel`` contiguous groups.
        """
        alive = set(self.alive_groups())
        mp = self.model_parallel
        blocks = []
        for start in range(0, len(self.state), mp):
            block = tuple(range(start, start + mp))
            if all(g in alive for g in block):
                blocks.append(block)
        if not blocks:
            raise RuntimeError("no intact model-parallel block survives")
        data = 2 ** int(math.floor(math.log2(len(blocks))))
        chosen = blocks[:data]
        plan = MeshPlan(data=data, model=mp,
                        groups=tuple(g for b in chosen for g in b))
        self.on_event(FleetEvent.REMESH,
                      {"data": plan.data, "model": plan.model})
        return plan

    def cluster_spec(self, base_classes=None) -> ClusterSpec:
        """Scheduler view: demoted/slow groups become LITTLE class.

        ``base_classes`` (one class per group, e.g. the original
        ``ClusterSpec.classes``) preserves genuinely-LITTLE groups through
        the rebuild; the default keeps the legacy all-BIG assumption."""
        alive = self.alive_groups()
        if base_classes is None:
            return ClusterSpec(classes=tuple(
                LITTLE if self.state[g].demoted else BIG for g in alive))
        return ClusterSpec(classes=tuple(
            LITTLE if self.state[g].demoted else base_classes[g]
            for g in alive))
