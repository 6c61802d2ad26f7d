"""Serving launcher of the port: ``python -m repro_torch.launch.serve --zoo``.

Twin of ``repro.launch.serve``'s ``--zoo`` path (``_run_zoo``): a bursty
two-tenant request trace becomes tenant-labelled DAG arrivals on
``ThreadedRuntime`` behind a token-bucket admission gate and the
``critical-boost`` preemption controller, under ``molding:weight``, and
every TAO runs the tenant zoo's kernel payloads.  The single-model path
(``--arch``) serves a model and waits for the port's models (ROADMAP.md,
Queue 1 item 3): this launcher offers ``--zoo`` only.

On the card the kernel tenants run at llama3.2-1b widths; on the CPU
(``--device cpu``) the plain versions run at the JAX tenant's own shapes.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve --zoo [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..core import ThreadedRuntime, hikey960, make_policy
from ..core.admission import make_gate
from ..core.preemption import make_preemption
from ..core.serve_orchestrator import (ServeStats, bursty_serving_trace,
                                       run_serving_workload_threaded)
from ..workers import ChunkLog, resolve_device
from .zoo import SERVE_SHAPES, ZOO_SHAPES, default_zoo, warm_zoo, zoo_binder

SERVE_SPAN = "serve.run"  # profiler span around the runtime's run
KERNEL_TENANTS = {"steady": "kernel", "burst": "kernel"}


def entry_trace() -> list:
    """The trace ``repro.launch.serve --zoo`` serves (serve.py:101-103)."""
    return bursty_serving_trace(n_steady=12, n_burst=12, burst_at=0.2,
                                steady_prompts=(512, 1024), steady_gens=(64,),
                                burst_prompts=(2048, 4096), burst_gens=(64,))


def entry_controls() -> dict:
    """Its admission gate and preemption controller (serve.py:106-108)."""
    return {"admission": make_gate("token-bucket", rate=40.0, burst=8,
                                   max_delay=2.0),
            "preemption": make_preemption("critical-boost")}


# path -> (trace, controls) factories: the serving runs that chip_smoke.py
# checks and trace_main_path.py profiles
PATHS = {
    "serve:entry": (entry_trace, entry_controls),
    # the JAX default trace under none+none (benchmarks/run.py:484-497)
    "serve:backlog": (lambda: bursty_serving_trace(seed=1), dict),
}


def run_zoo(requests, zoo: dict, *, policy: str = "molding:weight",
            admission=None, preemption=None, log: ChunkLog | None = None,
            timeout_s: float = 300.0) -> ServeStats:
    """Serve ``requests`` through ``zoo`` on a fresh ``ThreadedRuntime`` over
    ``hikey960()``.  With a ``log``, every chunk and PTT update of the run
    is noted in it."""
    spec, pol = hikey960(), make_policy(policy)
    rt = ThreadedRuntime(spec, pol, seed=0)
    if log is not None:
        log.watch(rt.core)
    with torch.profiler.record_function(SERVE_SPAN):
        return run_serving_workload_threaded(
            requests, spec, pol, zoo_binder(zoo, log), timeout_s=timeout_s,
            admission=admission, preemption=preemption, runtime=rt)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="Only --zoo is ported; --arch waits for the port's models "
               "(ROADMAP.md, Queue 1 item 3).")
    ap.add_argument("--zoo", action="store_true", required=True,
                    help="orchestrate a bursty two-tenant trace through the "
                         "tenant zoo (the only path of this launcher)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (llama3.2-1b widths) or cpu (the plain "
                         "versions at the JAX tenant's shapes)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    zoo = default_zoo(KERNEL_TENANTS, device=dev, shapes=(
        SERVE_SHAPES if dev.type == "cuda" else ZOO_SHAPES))
    print(f"warming zoo: { {n: t.flavor for n, t in zoo.items()} }")
    warm_zoo(zoo)
    stats = run_zoo(entry_trace(), zoo, **entry_controls())
    print(f"zoo: {stats.result.completed} TAOs, "
          f"{stats.tokens_per_s:.0f} tok/s, p99 sojourn "
          f"{stats.p99_latency:.3f}s")
    for tenant, p99 in sorted(stats.p99_by_tenant().items()):
        tps = stats.tokens_per_s_by_tenant.get(tenant, 0.0)
        print(f"  {tenant:8s} p99={p99:.3f}s tok/s={tps:.0f}")
    for typ, cells in sorted(stats.ptt_profiles.items()):
        if cells:
            fastest = min(cells.values())
            print(f"  PTT[{typ}]: {len(cells)} measured cells, "
                  f"fastest {fastest * 1e3:.2f} ms")


if __name__ == "__main__":
    main()
