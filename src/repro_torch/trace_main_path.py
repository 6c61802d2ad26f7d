"""Where the main path's time goes on the card.

First prints, for each class, the wall time of one chunk run alone on one
thread, which set beside the kernel's device time gives the host's cost per
chunk.  Then, for each policy, it runs the paper's full-size mixed-mode DAG
``REPEATS`` times without a ``ChunkLog`` and ``REPEATS`` times with one,
interleaved, and prints one JSON line with every run's elapsed time: the
run-to-run spread of TAOs/s, and the log's cost read against it.  Last it
runs each policy once under ``torch.profiler`` and prints one JSON line with
the card's busy time (the union of all kernel intervals inside the run), its
idle share, and device time and launches by kernel name.

Run on a card:  PYTHONPATH=src python -m repro_torch.trace_main_path
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import mixed_mode
from .core import random_dag

N_TASKS = 3000  # the main path's size (mixed_mode.run's default)
REPEATS = 5     # runs of each policy without and with a ChunkLog


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def chunk_costs(reps: int = 50) -> None:
    """Median wall time of one chunk (launch, stream sync, return) run alone
    on one thread."""
    operands = mixed_mode.operands_from_numpy(mixed_mode.make_arrays(),
                                              "cuda")
    torch.cuda.synchronize()
    dag = random_dag(n_tasks=3, target_degree=1.0, seed=0)
    mixed_mode.bind_real_work(dag, operands, device="cuda")
    for node in dag.nodes:
        fn = node.work.chunk_fn
        for _ in range(5):
            fn(0)
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(0)
            walls.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({"chunk": node.type,
                          "wall_ms": statistics.median(walls)}), flush=True)


def spread(policy: str) -> dict:
    """Elapsed seconds of ``REPEATS`` runs without a log and ``REPEATS`` with
    one, interleaved, so that drift on the host hits both alike."""
    plain, logged = [], []
    for _ in range(REPEATS):
        plain.append(mixed_mode.run(policy, N_TASKS)["elapsed_s"])
        logged.append(mixed_mode.run(policy, N_TASKS,
                                     log=mixed_mode.ChunkLog())["elapsed_s"])
    rate = [N_TASKS / t for t in plain]
    return {"policy": policy, "n_tasks": N_TASKS, "elapsed_s": plain,
            "logged_elapsed_s": logged,
            "taos_per_s_median": statistics.median(rate),
            "taos_per_s_min": min(rate), "taos_per_s_max": max(rate),
            "logged_over_plain_median": (statistics.median(logged)
                                         / statistics.median(plain))}


def traced_run(policy: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = mixed_mode.run(policy, N_TASKS)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == mixed_mode.RUN_SPAN]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    intervals = []
    if window:
        lo = window[0]["ts"]
        hi = lo + window[0]["dur"]
        for e in kernels:
            start, stop = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if stop > start:
                intervals.append((start, stop))
                by_name[e["name"]][0] += 1
                by_name[e["name"]][1] += e["dur"] / 1e3
    busy_ms = _union_us(intervals) / 1e3
    window_ms = window[0]["dur"] / 1e3 if window else None
    return {
        "policy": policy, "n_tasks": N_TASKS,
        "traced_elapsed_s": traced["elapsed_s"],
        "trace_window_ms": window_ms,
        "kernel_events": len(intervals),
        "device_busy_ms": busy_ms if window else None,
        "device_idle_share": 1 - busy_ms / window_ms if window else None,
        "kernels": {name: {"launches": n, "device_ms": ms}
                    for name, (n, ms) in sorted(by_name.items())},
    }


def main() -> None:
    mixed_mode.resolve_device("cuda")
    chunk_costs()
    for policy in mixed_mode.POLICIES:
        print(json.dumps(spread(policy)), flush=True)
    for policy in mixed_mode.POLICIES:
        print(json.dumps(traced_run(policy)), flush=True)


if __name__ == "__main__":
    main()
