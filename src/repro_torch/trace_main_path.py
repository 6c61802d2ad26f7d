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

Training (slice 7).  ``REPEATS`` runs of ``launch.train --arch
llama3.2-1b`` at full size (20 steps of batch 4 x seq 128) and of its
``--orchestrate --microbatches 2`` run for 4 steps: steps/s and training
tokens/s (the first step, which warms, left out), the first step's time,
and peak device memory of every run.

MoE and sliding-window decoders, patch frontend (slice 8, ``--moe-only``).
``REPEATS`` runs of each of ``serve.ARCH_RUNS`` (mixtral-8x22b and
moonshot-v1-16b-a3b at their published widths cut in depth, internvl2-2b
whole), each once under the profiler as below; then, for the MoE decoders,
one prefill and one decode step alone under the profiler: the device time of
the kernels launched in each of ``moe_ffn``'s stage spans (router, sort,
dispatch, experts, combine), summed over the layers, and the host ms of a
decode step with those spans opened and without (``span_cost``).

State-space, hybrid and encoder families (slice 9, ``--families-only``).
``REPEATS`` runs of ``serve:mamba2`` and ``serve:hymba`` (``run_arch``
orchestrated on mamba2-780m and hymba-1.5b whole) and of ``encode:hubert``
(``run_encode`` on hubert-xlarge whole, 4 clips of 500 frames), each once
under the profiler as below; then one prefill and one decode step of each
decoding family (the encode step for hubert) alone under the profiler: the
card's busy ms and the device ms by op class, the SSD scan and the conv
(the kernels launched in the ``ssm.scan`` and ``ssm.conv`` spans), the
norms and flash attention (the port's kernels), the products (cuBLAS's
GEMM and GEMV kernels) and the rest.

Last it runs each mixed-mode policy, ``serve --arch``, each zoo path and
both training runs once under ``torch.profiler`` and prints one JSON line
each with the card's busy time (the union of all kernel intervals inside the
run's span), its idle share, and device time and launches by kernel name.

It prints the card's name and power limit first.

Run on a card:  PYTHONPATH=src python -m repro_torch.trace_main_path
``--serve-only`` leaves out the mixed-mode DAG and training: the serving
paths alone; ``--train-only`` runs the training paths alone;
``--moe-only`` the slice-8 serving runs alone; ``--families-only`` the
slice-9 runs alone.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import mixed_mode
from .core import random_dag
from .launch import serve, train, zoo
from .models import (get_model, layers, make_decode_step, make_encode_step,
                     make_prefill_step)

N_TASKS = 3000  # the main path's size (mixed_mode.run's default)
REPEATS = 5     # runs of each policy without and with a ChunkLog
ARCH = "llama3.2-1b"
# the training runs: launch.train's defaults, and the orchestrated run's
# cut (4 steps of 2 microbatches)
TRAIN_RUNS = {"train": dict(steps=20),
              "train_orchestrated": dict(steps=4, orchestrate=True,
                                         microbatches=2)}
TRAIN_BATCH, TRAIN_SEQ = 4, 128


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


def arch_spread(path: str = "serve:model", **run) -> dict:
    """``REPEATS`` runs of ``serve.run_arch(**run)``, by default ``serve
    --arch llama3.2-1b --orchestrate``."""
    run = run or dict(arch=ARCH, orchestrate=True)
    runs = []
    for _ in range(REPEATS):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = serve.run_arch(**run)
        st = out["stats"]
        runs.append({"prefill_s": out["prefill_s"],
                     "decode_s": out["decode_s"],
                     "orchestrated_tokens_per_s": st.tokens_per_s,
                     "orchestrated_p99_sojourn_s": st.p99_latency,
                     "peak_memory_gib": torch.cuda.max_memory_allocated()
                     / 2 ** 30})
        del out
    rate = [r["orchestrated_tokens_per_s"] for r in runs]
    return {"path": path, "runs": runs,
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


def train_run(label: str) -> dict:
    """One training run at full size, freed after: its times and peak
    memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train.run(ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    **TRAIN_RUNS[label])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = TRAIN_BATCH * TRAIN_SEQ
    if "stats" in out:
        st = out["stats"]
        row = {"elapsed_s": st["elapsed_s"],
               "tokens_per_s": tokens * TRAIN_RUNS[label]["steps"]
               / st["elapsed_s"]}
    else:
        warm = sum(out["step_s"][1:])
        row = {"first_step_s": out["step_s"][0],
               "steps_per_s": (len(out["step_s"]) - 1) / warm,
               "tokens_per_s": tokens * (len(out["step_s"]) - 1) / warm}
    row.update(wall_s=wall, peak_memory_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30)
    del out
    torch.cuda.empty_cache()
    return row


def train_spread(label: str) -> dict:
    """``REPEATS`` runs of one training run."""
    runs = [train_run(label) for _ in range(REPEATS)]
    rate = [r["tokens_per_s"] for r in runs]
    return {"path": label, "runs": runs,
            "tokens_per_s_median": statistics.median(rate),
            "tokens_per_s_min": min(rate), "tokens_per_s_max": max(rate)}


def trace_events(run) -> list:
    """``run()`` once under ``torch.profiler``: its chrome-trace events."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def span_device_ms(events: list, prefix: str) -> dict:
    """Device ms of the kernels launched inside each host span whose name
    starts with ``prefix``, by span name: a kernel belongs to the span in
    which its launch call (same thread, same correlation id) fell."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(prefix)]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = collections.defaultdict(float)
    for k in (e for e in events if e.get("cat") == "kernel"):
        call = launch.get(k.get("args", {}).get("correlation"))
        if call is None:
            continue
        for sp in spans:
            if sp["tid"] == call["tid"] and \
                    sp["ts"] <= call["ts"] <= sp["ts"] + sp["dur"]:
                out[sp["name"]] += k["dur"] / 1e3
                break
    return dict(sorted(out.items()))


def moe_ops(path: str) -> dict:
    """One prefill and one decode step of ``serve.ARCH_RUNS[path]``'s MoE
    decoder, warm, each alone under the profiler: the card's busy ms and
    the device ms of each ``moe_ffn`` stage, over all layers."""
    run = serve.arch_run(path)
    cfg = run["config"]
    model = get_model(cfg)
    weights = model.bf16_copy(model.init(
        torch.Generator("cuda").manual_seed(0)))
    toks = torch.randint(0, cfg.vocab_size, (run["batch"], run["prompt_len"]),
                         device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    logits, cache = prefill(weights, {"tokens": toks})
    nxt = logits.argmax(-1)
    decode(weights, nxt, cache)
    torch.cuda.synchronize()
    row = {"path": path, "arch": cfg.name, "layers": cfg.n_layers}
    for name, fn in (("prefill", lambda: prefill(weights, {"tokens": toks})),
                     ("decode_step", lambda: decode(weights, nxt, cache))):
        events = trace_events(fn)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        row[name] = {
            "device_busy_ms": _union_us((e["ts"], e["ts"] + e["dur"])
                                        for e in kernels) / 1e3,
            "kernels": len(kernels),
            "moe_device_ms": span_device_ms(events, "moe.")}
    row["decode_step_host_ms"] = span_cost(lambda: decode(weights, nxt,
                                                          cache))
    del weights, cache
    torch.cuda.empty_cache()
    return row


def span_cost(step, reps: int = 50) -> dict:
    """Median wall ms of ``step()`` (a decode step, synced) with
    ``moe_ffn``'s stage spans opened, as under a profiler, and as served,
    without: turns off, on, on, off of ``reps`` steps each."""
    walls = {"spans_off": [], "spans_on": []}
    gated = layers._span
    try:
        for mode in ("spans_off", "spans_on", "spans_on", "spans_off"):
            layers._span = gated if mode == "spans_off" else record_function
            for _ in range(reps):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                walls[mode].append((time.perf_counter() - t0) * 1e3)
    finally:
        layers._span = gated
    return {mode: statistics.median(w) for mode, w in walls.items()}


def traced(label: str, span: str, run) -> dict:
    """``run()`` once under ``torch.profiler``: the card's busy time and idle
    share inside the profiler span named ``span``."""
    events = trace_events(run)
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    legs = ap.add_mutually_exclusive_group()
    legs.add_argument("--serve-only", action="store_true",
                      help="the serving paths alone")
    legs.add_argument("--train-only", action="store_true",
                      help="the training paths alone")
    legs.add_argument("--moe-only", action="store_true",
                      help="the MoE, sliding-window and patch decoders' "
                           "serving runs alone")
    legs.add_argument("--families-only", action="store_true",
                      help="the ssm, hybrid and encoder families' runs "
                           "alone")
    args = ap.parse_args(argv)
    mixed_mode.resolve_device("cuda")
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]}), flush=True)
    if args.train_only:
        trace_training()
        return
    if args.moe_only:
        trace_moe()
        return
    if args.families_only:
        trace_families()
        return
    policies = () if args.serve_only else mixed_mode.POLICIES
    if policies:
        chunk_costs()
    for policy in policies:
        print(json.dumps(spread(policy)), flush=True)
    print(json.dumps(arch_spread()), flush=True)
    tenants = zoo.default_zoo()
    zoo.warm_zoo(tenants)
    serve_chunk_costs(tenants)
    for path in serve.PATHS:
        print(json.dumps(serve_spread(path, tenants)), flush=True)
    for policy in policies:
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
    if not args.serve_only:
        del tenants
        trace_training()


MOE_PATHS = ("serve:mixtral", "serve:moonshot", "serve:internvl2")
FAMILY_PATHS = ("serve:mamba2", "serve:hymba")


def trace_moe() -> None:
    """Each of ``MOE_PATHS``: its spread, one traced run, and for the MoE
    decoders the stage times of a prefill and a decode step."""
    for path in MOE_PATHS:
        run = serve.arch_run(path)
        print(json.dumps(arch_spread(path, **run)), flush=True)
        print(json.dumps(traced(path, serve.ARCH_SPAN,
                                lambda: serve.run_arch(**run))), flush=True)
        torch.cuda.empty_cache()
        if run["config"].is_moe:
            print(json.dumps(moe_ops(path)), flush=True)


def op_class(name: str) -> str:
    """The op class of a kernel outside the ssm spans, by its name."""
    low = name.lower()
    if "rmsnorm" in low:
        return "rmsnorm"
    if "flash" in low:
        return "flash_attention"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "sm90",
                              "nvjet")):
        return "products"
    return "other"


def op_device_ms(events: list) -> dict:
    """Device ms of every kernel in ``events`` by op class: ``ssd_scan`` or
    ``conv`` for a kernel launched inside an ``ssm.scan`` or ``ssm.conv``
    span (its launch call on the same thread inside the span, as
    ``span_device_ms`` matches them), else ``op_class`` of its name."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "") in ("ssm.scan", "ssm.conv")]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = collections.defaultdict(float)
    for k in (e for e in events if e.get("cat") == "kernel"):
        call = launch.get(k.get("args", {}).get("correlation"))
        cls = op_class(k["name"])
        for sp in spans if call is not None else ():
            if sp["tid"] == call["tid"] and \
                    sp["ts"] <= call["ts"] <= sp["ts"] + sp["dur"]:
                cls = {"ssm.scan": "ssd_scan", "ssm.conv": "conv"}[sp["name"]]
                break
        out[cls] += k["dur"] / 1e3
    return {"device_ms_total": sum(out.values()),
            "by_op": dict(sorted(out.items()))}


def family_ops(path: str) -> dict:
    """One prefill and one decode step of ``serve.ARCH_RUNS[path]`` (or
    the encode step of ``serve.ENCODE_RUNS[path]``), warm, each alone under
    the profiler: the card's busy ms, the kernels launched and the device
    ms by op class (``op_device_ms``)."""
    if path in serve.ENCODE_RUNS:
        out = serve.run_encode(path)
        model, weights, batch = out["model"], out["weights"], out["batch"]
        del out
        step = make_encode_step(model)
        calls = (("encode", lambda: step(weights, batch)),)
        cfg = model.cfg
    else:
        run = serve.arch_run(path)
        cfg = run["config"]
        model = get_model(cfg)
        weights = model.bf16_copy(model.init(
            torch.Generator("cuda").manual_seed(0)))
        toks = torch.randint(0, cfg.vocab_size,
                             (run["batch"], run["prompt_len"]),
                             device="cuda",
                             generator=torch.Generator("cuda").manual_seed(1))
        prefill, decode = make_prefill_step(model), make_decode_step(model)
        logits, cache = prefill(weights, {"tokens": toks})
        nxt = logits.argmax(-1)
        calls = (("prefill", lambda: prefill(weights, {"tokens": toks})),
                 ("decode_step", lambda: decode(weights, nxt, cache)))
    for _, fn in calls:
        fn()
    torch.cuda.synchronize()
    row = {"path": path, "arch": cfg.name, "layers": cfg.n_layers}
    for name, fn in calls:
        events = trace_events(fn)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        row[name] = {
            "device_busy_ms": _union_us((e["ts"], e["ts"] + e["dur"])
                                        for e in kernels) / 1e3,
            "kernels": len(kernels), **op_device_ms(events)}
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        row[name]["wall_ms_median"] = statistics.median(walls)
    row["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del weights, calls
    torch.cuda.empty_cache()
    return row


def encode_spread(path: str) -> dict:
    """``REPEATS`` runs of ``serve.run_encode(path)``, each encoding its
    batch twice (the first warms): the second encode's time."""
    runs = []
    for _ in range(REPEATS):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = serve.run_encode(path, repeats=2)
        runs.append({"encode_s": out["encode_s"],
                     "peak_memory_gib": torch.cuda.max_memory_allocated()
                     / 2 ** 30})
        del out
    warm = [r["encode_s"][-1] for r in runs]
    return {"path": path, "runs": runs,
            "encode_s_median": statistics.median(warm),
            "encode_s_min": min(warm), "encode_s_max": max(warm)}


def trace_families() -> None:
    """serve:mamba2 and serve:hymba (spread and one traced run each),
    encode:hubert likewise, then each path's op breakdown
    (``family_ops``)."""
    for path in FAMILY_PATHS:
        run = serve.arch_run(path)
        print(json.dumps(arch_spread(path, **run)), flush=True)
        print(json.dumps(traced(path, serve.ARCH_SPAN,
                                lambda: serve.run_arch(**run))), flush=True)
        torch.cuda.empty_cache()
    for path in serve.ENCODE_RUNS:
        print(json.dumps(encode_spread(path)), flush=True)
        print(json.dumps(traced(path, serve.ENCODE_SPAN,
                                lambda: serve.run_encode(path, repeats=2))),
              flush=True)
        torch.cuda.empty_cache()
    for path in FAMILY_PATHS + tuple(serve.ENCODE_RUNS):
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps(family_ops(path)), flush=True)


def trace_training() -> None:
    """The training runs' spread, then each once under the profiler."""
    for label in TRAIN_RUNS:
        print(json.dumps(train_spread(label)), flush=True)
    for label, kw in TRAIN_RUNS.items():
        print(json.dumps(traced(label, train.TRAIN_SPAN, lambda: train.run(
            ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ, **kw))), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
