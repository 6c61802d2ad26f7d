"""Serve a small model with batched requests through the paper's scheduler.
Twin of ``examples/serve_lm.py``.

The weight-based policy + PTT *learn online* that prefill TAOs (compute
bound) belong on big device groups and decode TAOs (HBM-BW bound) on
efficient ones -- the paper's mechanism discovering disaggregated
prefill/decode serving.  First the simulator study, then a 4-layer,
256-wide decoder served on ``run_serving_threaded``: on the card each
prefill and decode call runs the RMSNorm and flash-attention kernels on its
worker thread's own stream and returns once that stream has drained.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse
import random

import torch

from ..core import hikey960, make_policy
from ..core.serve_orchestrator import (ServeRequest, run_serving_threaded,
                                       simulate_serving)
from ..models import (ModelConfig, get_model, make_decode_step,
                      make_prefill_step)
from ..workers import on_own_stream, resolve_device


PROMPT_LEN = 64  # tokens of the prompt every served request runs


def demo_config() -> ModelConfig:
    return ModelConfig(name="serve-demo", family="decoder", n_layers=4,
                       d_model=256, n_heads=4, n_kv_heads=2, d_ff=1024,
                       vocab_size=32000)


def scheduling_study() -> dict:
    """The fleet-scale study on the simulator: policy -> ServeStats."""
    rng = random.Random(0)
    reqs = [ServeRequest(i, rng.choice([512, 2048, 8192]),
                         rng.choice([64, 128, 256])) for i in range(100)]
    print("=== scheduling study (4 big + 4 LITTLE groups, 100 requests) ===")
    out = {}
    for policy in ("homogeneous", "weight", "molding:weight"):
        st = out[policy] = simulate_serving(reqs, hikey960(),
                                            make_policy(policy), seed=0)
        print(f"  {policy:16s} {st.tokens_per_s:8.0f} tok/s   "
              f"mean latency {st.mean_latency:.3f}s   "
              f"p99 {st.p99_latency:.3f}s")
    return out


def serve_model(device="cuda"):
    """``demo_config()``'s decoder (weights from seed 0, a ``PROMPT_LEN``-token
    prompt from seed 1) serving 8 requests on the threaded runtime; returns the
    ServeStats."""
    dev = resolve_device(device)
    cfg = demo_config()
    model = get_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    _, cache = prefill(params, {"tokens": toks})     # warm: builds kernels
    decode(params, toks[:, -1:], cache)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    calls = on_own_stream({
        "prefill": lambda r: prefill(params, {"tokens": toks})[0],
        "decode": lambda r, i: decode(params, toks[:, -1:], cache)[0]}, dev)

    small = [ServeRequest(i, 512, 64, arrival=0.02 * i) for i in range(8)]
    out = run_serving_threaded(
        small, hikey960(), make_policy("molding:weight"),
        prefill_fn=calls["prefill"], decode_fn=calls["decode"])
    print(f"\n=== real model on the threaded runtime ({dev}) ===\n"
          f"  {out.result.completed} TAOs in {out.makespan:.2f}s "
          f"({out.tokens_per_s:.0f} tok/s, p99 sojourn "
          f"{out.p99_latency * 1e3:.1f} ms)")
    for typ, cells in sorted(out.ptt_profiles.items()):
        if not cells:
            continue
        # keys are (leader, width) for the default implementation and
        # (leader, width, impl) for measured variants (multi-impl zoo
        # tenants): fold them into a per-(impl, width) view of what the
        # scheduler learned
        by_impl_width: dict = {}
        for key, t in cells.items():
            impl = key[2] if len(key) == 3 else "default"
            by_impl_width.setdefault((impl, key[1]), []).append(t)
        print(f"  measured PTT[{typ}]: {len(cells)} cells")
        for (impl, width), ts in sorted(by_impl_width.items()):
            print(f"    impl={impl:10s} w={width}: {len(ts):2d} cells, "
                  f"fastest {min(ts) * 1e3:.2f} ms")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions")
    args = ap.parse_args(argv)
    return {"study": scheduling_study(), "served": serve_model(args.device)}


if __name__ == "__main__":
    main()
