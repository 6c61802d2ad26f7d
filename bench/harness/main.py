"""The benchmark's one entry: run one cell of ``BENCHMARK.json`` and print its
result line.

Everything that belongs to one configuration, traffic mix or metric is a file
of its own, found by the name that ``BENCHMARK.json`` gives:

    bench/configs/<file>         a configuration (BENCHMARK.json's ``file``),
                                 whose ``driver`` is bench/drivers/<driver>.py
    bench/traffic/<traffic>.json a traffic mix, read by harness/traffic.py
    bench/metrics/<metric>.py    a metric's reader: read(obs) -> number, None

A driver's ``run(run)`` sets the cell up, measures its window and checks its
answers; it returns the observations (``obs``) that the metric readers read:
``setup_s``, ``attempted``, ``failed``, ``checks`` (name -> (number, limit)),
``memory_peak_bytes``, ``trace`` (a ``trace.Trace`` in a traced run),
``setup`` (its parts, and ``built``: whether this run built the program's
kernels, as a checkout's first run does), and whatever else its metrics
need.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a driver is given."""

    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float           # time.perf_counter() at process start
    control: bool = False    # also judge the control (bench/tools.py)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell_files(bench: dict, workload: str, root: Path = ROOT) -> tuple:
    """(cell, configuration dict, mix dict) of the cell named ``workload``."""
    cell = find(bench["workloads"], workload, "workload")
    entry = find(bench["configs"], cell["config"], "config")
    config = load_json(root / entry["file"])
    mix = load_json(root / "bench" / "traffic" / f"{cell['traffic']}.json")
    return cell, config, mix


def driver(name: str):
    return importlib.import_module(f"bench.drivers.{name}")


def metric_module(name: str, root: Path = ROOT):
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones.  An entry without a
    ``workloads`` key applies to every cell (a per-layer one to every cell
    that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def read_metrics(entries: list, obs: dict, root: Path = ROOT) -> dict:
    out = {}
    for m in entries:
        value = metric_module(m["name"], root).read(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (whole names: ``repro_torch`` is the
    port)."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def card(device) -> dict:
    """The card's name, and its power limit as ``nvidia-smi`` reads it."""
    import torch
    out = {"kind": torch.cuda.get_device_name(device)}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        out["power_limit"] = line.split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = "unread"
    return out


def cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache a run may make, at fixed paths inside the
    checkout (the port builds its CUDA library under
    src/repro_torch/kernels/build/, also inside it)."""
    base = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def judge(checks: dict) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())


def report(obs: dict, metrics: dict, dev: dict, trace: bool) -> dict:
    checks = obs["checks"]
    line = {"correct": judge(checks), "attempted": int(obs["attempted"]),
            "failed": int(obs["failed"]), "metrics": metrics, "device": dev}
    if trace and obs.get("trace") is not None and obs["trace"].found:
        line["breakdown"] = obs["trace"].breakdown()
    if "setup" in obs:
        line["setup"] = obs["setup"]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(t_start: float, argv=None) -> int:
    args = parse(argv)
    bench = benchmark()
    cell, config, mix = cell_files(bench, args.workload)
    cache_dirs()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    info = card(device)
    run = Run(cell, config, mix, args.seed, args.seconds, bool(args.trace),
              device, t_start)
    obs = driver(config["driver"]).run(run)
    metrics = read_metrics(metrics_for(bench, args.workload, run.trace), obs)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": info["kind"], "count": cell["chips"],
           "memory_peak_bytes": int(obs["memory_peak_bytes"]),
           "power_limit": info["power_limit"]}
    if run.trace:
        tr = obs.get("trace")
        dev["busy_s"] = tr.busy_s if tr is not None and tr.found else 0.0
        dev["window_s"] = tr.window_s if tr is not None and tr.found else 0.0
    line = report(obs, metrics, dev, run.trace)
    print(f"card: {info['kind']}, power limit {info['power_limit']}; peaks "
          f"989e12 FLOP/s bf16, 3.35e12 B/s", file=sys.stderr)
    if "setup" in obs:
        print(f"setup: {json.dumps(obs['setup'])}", file=sys.stderr)
    for name, (value, limit) in obs["checks"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
