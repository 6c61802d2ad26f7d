"""End-to-end driver: train a ~100M-param llama-style model for a few
hundred steps with the full substrate (data pipeline, AdamW + cosine,
async checkpoint/restart).  Twin of ``examples/train_lm.py``: on the card
every norm runs the RMSNorm kernel and every attention the flash-attention
kernel, forward, through their autograd Functions.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200]
      [--device cpu] [--ckpt DIR]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..checkpointing import CheckpointManager
from ..data import SyntheticLM
from ..models import ModelConfig, get_model, make_train_step
from ..optimizer import adamw_init, cosine_schedule
from ..workers import resolve_device


STEPS, BATCH, SEQ = 200, 8, 256  # the run's defaults


def config_100m() -> ModelConfig:
    """~100M params: 8L x 512 wide, GQA 8/4, llama-style."""
    return ModelConfig(
        name="llama-100m", family="decoder", n_layers=8, d_model=512,
        n_heads=8, n_kv_heads=4, d_ff=2048, vocab_size=32000,
        rope_theta=10000.0, dense_attn_max_seq=4096,
    )


def main(argv=None) -> dict:
    """Train, print every 20th step, checkpoint every 100 steps (async) and
    at the end.  Returns the ``model``, final ``params`` and ``opt``, every
    step's ``losses``, the checkpoint manager ``mgr`` and ``seconds``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config_100m()
    model = get_model(cfg)
    print(f"{cfg.name}: {model.param_count() / 1e6:.1f}M params")

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch)
    sched = cosine_schedule(3e-4, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(model, lr_schedule=sched)

    params = model.init(torch.Generator(dev).manual_seed(0))
    opt = adamw_init(params)
    mgr = CheckpointManager(args.ckpt, keep=2)

    t0 = time.time()
    tokens_done = 0
    losses = []
    for step in range(args.steps):
        batch = data.batch(step, device=dev)
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(metrics["loss"])
        tokens_done += args.batch * args.seq
        if step % 20 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"{tokens_done / max(dt, 1e-9):.0f} tok/s")
        if (step + 1) % 100 == 0:
            mgr.async_save(step + 1, {"params": params, "opt": opt})
    mgr.save(args.steps, {"params": params, "opt": opt})
    seconds = time.time() - t0
    print(f"final checkpoint at step {mgr.latest()}; "
          f"{args.steps} steps in {seconds:.1f}s")
    return {"model": model, "params": params, "opt": opt,
            "losses": torch.stack(losses).tolist(), "mgr": mgr,
            "seconds": seconds}


if __name__ == "__main__":
    main()
