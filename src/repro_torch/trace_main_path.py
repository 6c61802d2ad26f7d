"""Where the ported paths' time goes on the card.

Mixed-mode DAG (slice 1).  First prints, for each class, the wall time of
one chunk run alone on one thread, which set beside the kernel's device time
gives the host's cost per chunk.  Then, for each policy, it runs the paper's
full-size mixed-mode DAG ``REPEATS`` times without a ``ChunkLog`` and
``REPEATS`` times with one, interleaved, and prints one JSON line with every
run's elapsed time: the run-to-run spread of TAOs/s, and the log's cost read
against it.

Model serving (slice 3).  ``REPEATS`` runs of ``serve --arch llama3.2-1b
--orchestrate`` at full size: prefill and decode times, orchestrated
tokens/s and p99 sojourn of every run.

Zoo serving (slices 2 and 3).  The wall time of one prefill and one decode
chunk of each tenant alone, then ``REPEATS`` runs of each serving path of
``chip_smoke.py`` (the entry point's trace, gate and controller; the full
backlog with neither) through a warm zoo of the JAX pairing (a llama3.2-1b
transformer tenant and a kernel tenant at llama3.2-1b widths), with tokens/s
and p99 sojourn per tenant of every run.

Last it runs each mixed-mode policy, ``serve --arch`` and each zoo path once
under ``torch.profiler`` and prints one JSON line each with the card's busy
time (the union of all kernel intervals inside the run's span), its idle
share, and device time and launches by kernel name.

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
from .launch import serve, zoo

N_TASKS = 3000  # the main path's size (mixed_mode.run's default)
REPEATS = 5     # runs of each policy without and with a ChunkLog
ARCH = "llama3.2-1b"


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


def serve_chunk_costs(tenants: dict, reps: int = 20) -> None:
    """Median wall time of one prefill and one decode chunk of each tenant
    alone."""
    for name, tenant in tenants.items():
        for typ in ("prefill", "decode"):
            fn = tenant._chunks[None, typ]
            for _ in range(3):
                fn(0)
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn(0)
                walls.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps({"tenant": name, "flavor": tenant.flavor,
                              "chunk": typ,
                              "wall_ms": statistics.median(walls)}),
                  flush=True)


def arch_spread() -> dict:
    """``REPEATS`` runs of ``serve --arch llama3.2-1b --orchestrate``."""
    runs = []
    for _ in range(REPEATS):
        out = serve.run_arch(ARCH, orchestrate=True)
        st = out["stats"]
        runs.append({"prefill_s": out["prefill_s"],
                     "decode_s": out["decode_s"],
                     "orchestrated_tokens_per_s": st.tokens_per_s,
                     "orchestrated_p99_sojourn_s": st.p99_latency})
    rate = [r["orchestrated_tokens_per_s"] for r in runs]
    return {"path": "serve:model", "runs": runs,
            "decode_s_median": statistics.median(r["decode_s"] for r in runs),
            "tokens_per_s_median": statistics.median(rate),
            "tokens_per_s_min": min(rate), "tokens_per_s_max": max(rate)}


def serve_spread(path: str, tenants: dict) -> dict:
    """``REPEATS`` runs of one serving path: tokens/s and p99 sojourns."""
    trace, controls = serve.PATHS[path]
    runs = []
    for _ in range(REPEATS):
        st = serve.run_zoo(trace(), tenants, **controls())
        runs.append({"makespan_s": st.makespan,
                     "tokens_per_s": st.tokens_per_s,
                     "p99_sojourn_s_by_tenant": st.p99_by_tenant(),
                     "rejected": st.result.n_rejected,
                     "preemptions": st.result.n_preemptions})
    rate = [r["tokens_per_s"] for r in runs]
    return {"path": path, "runs": runs,
            "tokens_per_s_median": statistics.median(rate),
            "tokens_per_s_min": min(rate), "tokens_per_s_max": max(rate)}


def traced(label: str, span: str, run) -> dict:
    """``run()`` once under ``torch.profiler``: the card's busy time and idle
    share inside the profiler span named ``span``."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == span]
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
        "run": label,
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
    print(json.dumps(arch_spread()), flush=True)
    tenants = zoo.default_zoo()
    zoo.warm_zoo(tenants)
    serve_chunk_costs(tenants)
    for path in serve.PATHS:
        print(json.dumps(serve_spread(path, tenants)), flush=True)
    for policy in mixed_mode.POLICIES:
        print(json.dumps(traced(
            f"mixed_mode:{policy}", mixed_mode.RUN_SPAN,
            lambda: mixed_mode.run(policy, N_TASKS))), flush=True)
    print(json.dumps(traced("serve:model", serve.ARCH_SPAN,
                            lambda: serve.run_arch(ARCH, orchestrate=True))),
          flush=True)
    for path, (trace, controls) in serve.PATHS.items():
        requests, kw = trace(), controls()
        print(json.dumps(traced(path, serve.SERVE_SPAN, lambda: serve.run_zoo(
            requests, tenants, **kw))), flush=True)


if __name__ == "__main__":
    main()
