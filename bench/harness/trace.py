"""The device trace of a traced run (``--trace 1``): ``torch.profiler`` over
``trace_seconds`` of the measured window, on every thread of the process,
and the arithmetic that reduces its events to what the per-layer metrics
read.

The traced window is the span ``bench.trace_window``, opened just after the
profiler starts and closed just before it stops.  A device operation (a
kernel, a copy or a fill) counts where its interval meets the window, clipped
to it; the device is busy over the union of those intervals, and idle
elsewhere (1 - busy / window, the arithmetic of the program's
``trace_main_path.traced``).
"""
from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time

WINDOW_SPAN = "bench.trace_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


class Tracer:
    """Profiles [``start_at``, ``start_at + seconds``] (``time.perf_counter``
    seconds) from a thread of its own; ``stop()`` ends it early and
    ``result()`` waits for the events and reduces them (``Trace``)."""

    def __init__(self, start_at: float, seconds: float):
        self.start_at, self.seconds = start_at, seconds
        self._stop = threading.Event()
        self._events = None
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "Tracer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        try:
            self._stop.wait(max(0.0, self.start_at - time.perf_counter()))
            self._events = trace_events(
                lambda: self._stop.wait(max(0.0, self.start_at + self.seconds
                                            - time.perf_counter())))
        except Exception as e:   # surfaced by result()
            self._error = e

    def result(self) -> "Trace":
        self._stop.set()
        self._thread.join()
        if self._error is not None:
            raise self._error
        return Trace(self._events)


def prepare() -> None:
    """Start and stop the profiler once on the calling (main) thread, in
    set-up: its client registers with the card's tracer there, and a first
    start from another thread would trace almost nothing."""
    trace_events(lambda: None)


def profiler(**kw):
    """``torch.profiler.profile`` of the CPU and the card, on every thread
    of the process where the installed torch offers it."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        from torch.profiler import _ExperimentalConfig
        return profile(activities=acts, experimental_config=
                       _ExperimentalConfig(profile_all_threads=True), **kw)
    except (ImportError, TypeError):
        return profile(activities=acts, **kw)


def trace_events(run) -> list:
    """``run()`` under the profiler, inside the span ``WINDOW_SPAN``: the
    chrome-trace events, read back from a file under ``TMPDIR`` that is
    deleted at once."""
    import torch
    from torch.profiler import record_function
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profiler() as prof:
            with record_function(WINDOW_SPAN):
                run()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


class Trace:
    """The reduced events of one traced window."""

    def __init__(self, events: list):
        self.events = events
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW_SPAN]
        self.found = bool(win)
        if not win:
            self.lo = self.hi = 0.0
            self.device = []
            return
        self.lo = win[0]["ts"]
        self.hi = self.lo + win[0]["dur"]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and e["ts"] < self.hi and e["ts"] + e["dur"] > self.lo]

    def clip(self, e) -> tuple:
        return max(e["ts"], self.lo), min(e["ts"] + e["dur"], self.hi)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us(self.clip(e) for e in self.device) / 1e6

    def kernels(self, name_part: str) -> list:
        """(count, summed device seconds) of the kernels in the window whose
        name holds ``name_part``, each at its whole duration."""
        ks = [e for e in self.device if e.get("cat") == "kernel"
              and name_part in e.get("name", "")]
        return len(ks), sum(e["dur"] for e in ks) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The ``top`` device operations by clipped seconds, and the ``top``
        longest idle gaps, each named by the shortest host event (on any
        thread) that spans the gap's middle."""
        by_name = collections.defaultdict(float)
        for e in self.device:
            a, b = self.clip(e)
            by_name[e.get("name", "?")] += (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], self.lo
        for a, b in sorted(self.clip(e) for e in self.device):
            if a > end:
                gaps.append((a - end, end, a))
            end = max(end, b)
        if self.hi > end:
            gaps.append((self.hi - end, end, self.hi))
        gaps.sort(reverse=True)
        host = [e for e in self.events if e.get("cat") in HOST_CATS
                and e.get("name") != WINDOW_SPAN and "dur" in e]
        named = []
        for dur, a, b in gaps[:top]:
            mid = (a + b) / 2
            covering = [e for e in host
                        if e["ts"] <= mid <= e["ts"] + e["dur"]]
            name = min(covering, key=lambda e: e["dur"])["name"] \
                if covering else "no host event"
            named.append([name, dur / 1e6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
