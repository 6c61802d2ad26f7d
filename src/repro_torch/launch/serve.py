"""Serving launcher of the port: ``python -m repro_torch.launch.serve
--arch <id> [...]`` or ``--zoo``.  Twin of ``repro.launch.serve``.

``--arch``: batched prefill and greedy decode of one model of the port's zoo
(the full config unless ``--smoke``), then with ``--orchestrate`` the same
prefill and decode scheduled through ``ThreadedRuntime`` under
``molding:weight``.  Every norm runs the RMSNorm kernel and every prefill
attention the flash-attention kernel.

``--zoo``: a bursty two-tenant request trace becomes tenant-labelled DAG
arrivals on ``ThreadedRuntime`` behind a token-bucket admission gate and the
``critical-boost`` preemption controller, under ``molding:weight``, and every
TAO runs the tenant zoo's payloads: the JAX pairing, a ``transformer``
steady tenant and a ``kernel`` burst tenant.

Both run on the card unless ``--device cpu`` is given: the plain versions of
the kernels on the CPU, for the smoke config and the JAX tenants' shapes.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
      PYTHONPATH=src python -m repro_torch.launch.serve --zoo [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core import ThreadedRuntime, hikey960, make_policy
from ..core.admission import make_gate
from ..core.preemption import make_preemption
from ..core.serve_orchestrator import (ServeRequest, ServeStats,
                                       bursty_serving_trace,
                                       run_serving_threaded,
                                       run_serving_workload_threaded)
from ..models import get_model, make_decode_step, make_prefill_step
from ..workers import ChunkLog, on_own_stream, resolve_device
from .zoo import SERVE_SHAPES, ZOO_SHAPES, default_zoo, warm_zoo, zoo_binder

SERVE_SPAN = "serve.run"  # profiler span around the runtime's run
ARCH_SPAN = "serve.arch"  # and around --arch's prefill, decode, orchestration


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


# path -> (trace, controls) factories: the zoo's serving runs that
# chip_smoke.py checks and trace_main_path.py profiles
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


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_arch(arch: str, *, smoke: bool = False, batch: int = 4,
             prompt_len: int = 64, gen: int = 32, orchestrate: bool = False,
             device="cuda") -> dict:
    """``--arch``'s run (serve.py:36-86), printing the JAX launcher's lines.
    Returns what it made: the model, its weights (``bf16_copy`` of the fp32
    masters, which are dropped), the prompt ``tokens``, the prefill's last
    logits, the greedy ``out_tokens`` (B, gen), the final ``cache`` and,
    with ``orchestrate``, the run's ``stats``."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.family == "encoder":
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    model = get_model(cfg)
    weights = model.bf16_copy(model.init(torch.Generator(dev).manual_seed(0)))
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    max_len = prompt_len + gen + 1

    prefill_step, decode_step = make_prefill_step(model), \
        make_decode_step(model)

    def prefill():
        return prefill_step(weights, {"tokens": toks}, max_len=max_len)

    def decode(tok, cache):
        return decode_step(weights, tok, cache)

    with torch.profiler.record_function(ARCH_SPAN):
        out = _generate(prefill, decode, gen, dev)
        cache, next_tok = out["cache"], out["next_tok"]
        print(f"arch={cfg.name} batch={batch} prompt={prompt_len} gen={gen}")
        print(f"prefill: {out['prefill_s']:.3f}s "
              f"({batch * prompt_len / out['prefill_s']:.0f} tok/s)")
        print(f"decode:  {out['decode_s']:.3f}s "
              f"({batch * gen / out['decode_s']:.0f} tok/s)")
        out.update(model=model, weights=weights, tokens=toks)
        if orchestrate:
            out["stats"] = _orchestrate(prefill, decode, next_tok, cache,
                                        batch * 4, prompt_len, gen, dev)
    return out


def _generate(prefill, decode, gen: int, dev) -> dict:
    """Prefill, then ``gen`` greedy decode steps, each timed to the end of
    the device's work."""
    t0 = time.perf_counter()
    logits, cache = prefill()
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    first = logits

    out_tokens = []
    next_tok = torch.argmax(logits[:, -1:], dim=-1)
    t0 = time.perf_counter()
    for _ in range(gen):
        out_tokens.append(next_tok)
        logits, cache = decode(next_tok, cache)
        next_tok = torch.argmax(logits[:, -1:], dim=-1)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    return {"logits": first, "cache": cache, "next_tok": next_tok,
            "out_tokens": torch.cat(out_tokens, dim=1),
            "prefill_s": t_prefill, "decode_s": t_decode}


def _orchestrate(prefill, decode, next_tok, cache, n_requests: int,
                 prompt_len: int, gen: int, dev) -> ServeStats:
    """The same prefill and decode as payloads of ``n_requests`` requests on
    ``ThreadedRuntime`` under ``molding:weight``.  The final cache has one
    free slot, so every decode payload steps from it (``decode_step`` leaves
    it as it was)."""
    chunks = on_own_stream({
        "prefill": lambda r: prefill()[0],
        "decode": lambda r, i: decode(next_tok, cache)[0]}, dev)
    reqs = [ServeRequest(i, prompt_len, gen) for i in range(n_requests)]
    stats = run_serving_threaded(
        reqs, hikey960(), make_policy("molding:weight"),
        prefill_fn=chunks["prefill"], decode_fn=chunks["decode"])
    print(f"orchestrated: {stats.result.completed} TAOs, "
          f"{stats.tokens_per_s:.0f} tok/s, "
          f"mean sojourn {stats.mean_latency * 1e3:.1f} ms, "
          f"p99 {stats.p99_latency * 1e3:.1f} ms")
    return stats


def run_entry_zoo(device="cuda") -> ServeStats:
    """``--zoo``'s run: the JAX pairing at ``SERVE_SHAPES`` on the card or
    ``ZOO_SHAPES`` on the CPU, warmed, serving the entry trace."""
    dev = resolve_device(device)
    zoo = default_zoo(device=dev, shapes=(
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
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--orchestrate", action="store_true")
    ap.add_argument("--zoo", action="store_true",
                    help="orchestrate a bursty two-tenant trace through the "
                         "tenant zoo instead of a single-model batch")
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions (the smoke "
                         "config; the JAX tenants' shapes)")
    args = ap.parse_args(argv)
    if args.zoo:
        run_entry_zoo(args.device)
        return
    if args.arch is None:
        ap.error("one of --arch or --zoo is required")
    run_arch(args.arch, smoke=args.smoke, batch=args.batch,
             prompt_len=args.prompt_len, gen=args.gen,
             orchestrate=args.orchestrate, device=args.device)


if __name__ == "__main__":
    main()
