"""Deterministic fault-injection plans shared by both execution vehicles.

A :class:`ChaosPlan` is pure data: a time-sorted tuple of
:class:`ChaosEvent` records, each saying *when* (``at``, seconds —
virtual time on the simulator, wall-clock offset from run start on the
threaded runtime), *what* (``KILL`` / ``DEGRADE`` / ``RECOVER``) and *to
whom* (a tuple of worker ids).  The plan carries no execution logic;
each vehicle interprets the same events through its own fault hooks:

* the simulator schedules one CHAOS event per record on its virtual
  event heap (``fail_worker`` / ``set_speed_multiplier`` /
  ``recover_worker``), so a chaotic run is exactly as deterministic and
  replayable as a fault-free one;
* :class:`~repro.core.runtime.ThreadedRuntime` runs an injector thread
  that sleeps to each wall-clock offset and flips the shared
  dead/degraded state that workers consult at chunk-claim time.

An *empty or absent* plan must be byte-invisible: both vehicles guard
every chaos branch behind "is there a plan / a dead worker" checks, so
the 8 pinned identity signatures keep reproducing with chaos disabled.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence, Tuple

KILL = "kill"          # worker stops claiming work; in-flight chunks redone
DEGRADE = "degrade"    # worker keeps running, slowed by 1/speed
RECOVER = "recover"    # clears both KILL and DEGRADE

_ACTIONS = (KILL, DEGRADE, RECOVER)


@dataclass(frozen=True)
class ChaosEvent:
    """One timed fault transition over a group of workers."""
    at: float                      # seconds from run start
    action: str                    # KILL | DEGRADE | RECOVER
    workers: Tuple[int, ...]       # target worker ids
    speed: float = 1.0             # DEGRADE only: speed multiplier (<1 = slow)

    def __post_init__(self) -> None:
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown chaos action: {self.action!r} "
                             f"(choose from {_ACTIONS})")
        if self.at < 0.0:
            raise ValueError(f"chaos event time must be >= 0, got {self.at}")
        if self.action == DEGRADE and not self.speed > 0.0:
            raise ValueError(f"DEGRADE speed must be > 0, got {self.speed}")
        object.__setattr__(self, "workers", tuple(self.workers))


@dataclass(frozen=True)
class ChaosPlan:
    """A deterministic, time-sorted fault schedule.

    Build directly from events or with the fluent helpers::

        plan = (ChaosPlan.builder()
                .kill(0.05, (4, 5, 6, 7))
                .degrade(0.02, (1,), speed=0.25)
                .recover(0.40, (4, 5, 6, 7))
                .build())
    """
    events: Tuple[ChaosEvent, ...] = ()

    def __post_init__(self) -> None:
        evts = tuple(sorted(self.events, key=lambda e: (e.at, e.action)))
        object.__setattr__(self, "events", evts)

    def __bool__(self) -> bool:
        return bool(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def targets(self) -> Tuple[int, ...]:
        """All worker ids any event touches (sorted, deduplicated)."""
        seen: set = set()
        for e in self.events:
            seen.update(e.workers)
        return tuple(sorted(seen))

    def max_time(self) -> float:
        return max((e.at for e in self.events), default=0.0)

    @staticmethod
    def builder() -> "ChaosPlanBuilder":
        return ChaosPlanBuilder()


@dataclass
class ChaosPlanBuilder:
    _events: list = field(default_factory=list)

    def kill(self, at: float, workers: Iterable[int]) -> "ChaosPlanBuilder":
        self._events.append(ChaosEvent(at, KILL, tuple(workers)))
        return self

    def degrade(self, at: float, workers: Iterable[int],
                speed: float) -> "ChaosPlanBuilder":
        self._events.append(ChaosEvent(at, DEGRADE, tuple(workers),
                                       speed=speed))
        return self

    def recover(self, at: float, workers: Iterable[int]) -> "ChaosPlanBuilder":
        self._events.append(ChaosEvent(at, RECOVER, tuple(workers)))
        return self

    def build(self) -> ChaosPlan:
        return ChaosPlan(tuple(self._events))


def group_kill_plan(workers: Sequence[int], kill_at: float,
                    recover_at: float | None = None) -> ChaosPlan:
    """The canonical mid-stream group-kill scenario."""
    b = ChaosPlan.builder().kill(kill_at, workers)
    if recover_at is not None:
        b.recover(recover_at, workers)
    return b.build()
