"""What the runtime's worker threads share on every path of the port: the
device, a CUDA stream of each thread's own, and the opt-in log that checks a
run.

On the card a chunk launches on the calling worker thread's own stream and
returns once that stream has drained, so a leader's wall time, which is what
the PTT learns, covers the device work and not only the launch.  The JAX
payloads get the same from ``jax.block_until_ready``.  The ctypes launch and
``Stream.synchronize()`` both release the interpreter lock, so the threads
overlap.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return dev


def on_own_stream(payloads: dict, device) -> dict:
    """``payloads`` (any keys to callables) as payloads for worker threads.
    On a CUDA device each call runs its payload on the calling thread's own
    stream, one per thread shared by all of ``payloads``, and synchronises
    that stream before returning the payload's result; on the CPU each
    payload is itself."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dict(payloads)
    local = threading.local()

    def own_stream(fn):
        def run(*args):
            s = getattr(local, "stream", None)
            if s is None:
                s = local.stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(s):
                out = fn(*args)
            s.synchronize()
            return out
        return run
    return {key: own_stream(fn) for key, fn in payloads.items()}


@dataclasses.dataclass(frozen=True)
class PTTRecord:
    """One PTT update: the leader's wall time for one segment of a TAO, how
    many of that segment's chunks the leader itself ran (0 when the other
    members of its place claimed them all first), and the TAO's DAG."""

    cls: str
    leader: int
    width: int
    elapsed_s: float
    leader_chunks: int
    dag_id: int


def _segment(tao) -> int:
    # a preempted TAO resumes as a continuation segment; the cursor counts
    # the displacements, so chunks of one segment share this number
    return tao.cursor.preemptions if tao.cursor is not None else 0


class ChunkLog:
    """What the chunks of one run did, for checking a run: how often each
    (DAG, TAO, chunk) ran (``runs``), per worker thread how many chunks of
    each TAO segment that thread ran, and every PTT update (``records``).
    Opt-in: a run takes its cost only when a caller passes one."""

    def __init__(self) -> None:
        self.runs: collections.Counter = collections.Counter()
        self.records: list[PTTRecord] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def note(self, tao, i: int) -> None:
        with self._lock:
            self.runs[(tao.dag_id, tao.id, i)] += 1
        mine = getattr(self._local, "ran", None)
        if mine is None:
            mine = self._local.ran = collections.Counter()
        mine[tao, _segment(tao)] += 1

    def ran_here(self, tao) -> int:
        """Chunks of ``tao``'s current segment that the calling thread ran."""
        mine = getattr(self._local, "ran", None)
        return mine[tao, _segment(tao)] if mine else 0

    def wrap(self, chunk_fn: Callable, tao) -> Callable:
        """``chunk_fn`` that notes each chunk it runs of ``tao``."""
        def logged(i):
            out = chunk_fn(i)
            self.note(tao, i)
            return out
        return logged

    def watch(self, core) -> None:
        """Note every PTT update that ``core`` (a ``SchedulerCore``) takes."""
        record_time = core.record_time

        def record(tao, leader, width, elapsed):
            # runs on the leader's own thread, so ran_here counts its chunks
            self.records.append(PTTRecord(tao.type, leader, width, elapsed,
                                          self.ran_here(tao), tao.dag_id))
            record_time(tao, leader, width, elapsed)

        core.record_time = record
