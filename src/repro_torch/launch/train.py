"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch <id> [...]``.  Twin of ``repro.launch.train``.

Trains one model of the port's zoo (the full config unless ``--smoke``) with
the whole substrate engaged: the synthetic data pipeline, AdamW under a
cosine schedule with global-norm clipping, checkpoint and restart, and with
``--orchestrate`` the microbatches scheduled through ``ThreadedRuntime``
(``molding:crit-ptt`` on ``hikey960()``).  On the card every norm runs the
RMSNorm kernel and every attention the flash-attention kernel, forward,
through their autograd Functions; ``--device cpu`` runs the plain versions.

As in the reference, ``--orchestrate`` updates at a constant ``--lr``
without clipping and saves no checkpoint (ROADMAP.md, Queue 3, fault 4),
and an encoder on the ``frames`` frontend (hubert) cannot train here: the
launcher feeds token batches, which carry no ``frames`` (fault 8).  The
reference stops with ``KeyError: 'frames'`` at its first step; this one
exits before it builds the model.

Run:  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b
      PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
          --smoke --device cpu [--orchestrate]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpointing import CheckpointManager
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..data import SyntheticLM
from ..models import get_model, loss_and_grads, make_train_step
from ..optimizer import adamw_init, adamw_update, cosine_schedule
from ..workers import resolve_device

TRAIN_SPAN = "train.run"  # profiler span around the training steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(arch: str, *, smoke: bool = False, steps: int = 20, batch: int = 4,
        seq: int = 128, lr: float = 3e-4, checkpoint_dir=None,
        checkpoint_every: int = 50, resume: bool = False,
        orchestrate: bool = False, microbatches: int = 2,
        device="cuda") -> dict:
    """The launcher's run (train.py:26-88), printing its lines.  Returns the
    ``model``, the first step run (``start_step``), the final ``params`` and
    ``opt``, and for the plain loop each step's ``losses``, ``grad_norms``,
    ``lrs`` and ``step_s`` (wall time, to the end of the device's work);
    with ``orchestrate`` the runtime's ``stats`` instead."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.frontend == "frames":
        raise SystemExit(
            f"{cfg.name} reads batch['frames'] and the launcher feeds "
            f"SyntheticLM token batches: it cannot train here, as in the "
            f"reference (ROADMAP.md, Queue 3, fault 8)")
    model = get_model(cfg)
    print(f"arch={cfg.name} params={model.param_count():,}")

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       global_batch=batch)
    sched = cosine_schedule(lr, warmup_steps=max(steps // 20, 2),
                            total_steps=steps)

    params = model.init(torch.Generator(dev).manual_seed(0))
    opt = adamw_init(params)
    start_step = 0

    mgr = None
    if checkpoint_dir:
        mgr = CheckpointManager(checkpoint_dir)
        if resume and mgr.latest() is not None:
            like = {"params": params, "opt": opt}
            start_step, tree = mgr.restore(like)
            params, opt = tree["params"], tree["opt"]
            print(f"resumed from step {start_step}")

    out = {"model": model, "start_step": start_step}
    if orchestrate:
        # the reference returns here, before the manager saves anything.
        # The runtime keeps the only reference to the state it trains, so
        # that the first update frees the initial one (at 1.5 B parameters
        # the two would not fit on the card beside the update's own)
        state = {"params": params, "opt": opt}
        del params, opt
        with torch.profiler.record_function(TRAIN_SPAN):
            out.update(_train_orchestrated(model, state, data, start_step,
                                           steps, lr, microbatches, dev))
        return out

    step_fn = make_train_step(model, lr_schedule=sched)
    losses, gnorms, lrs, step_s = [], [], [], []
    t0 = time.perf_counter()
    with torch.profiler.record_function(TRAIN_SPAN):
        for step in range(start_step, steps):
            t_step = time.perf_counter()
            params, opt, metrics = step_fn(params, opt,
                                           data.batch(step, device=dev))
            losses.append(metrics["loss"].item())  # waits for the step
            step_s.append(time.perf_counter() - t_step)
            gnorms.append(metrics["grad_norm"].item())
            lrs.append(metrics["lr"].item())
            del metrics
            if step % 5 == 0 or step == steps - 1:
                print(f"step {step:5d} loss={losses[-1]:.4f} "
                      f"gnorm={gnorms[-1]:.3f} lr={lrs[-1]:.2e} "
                      f"({time.perf_counter() - t0:.1f}s)")
            if mgr and (step + 1) % checkpoint_every == 0:
                mgr.async_save(step + 1, {"params": params, "opt": opt})
    if mgr:
        mgr.save(steps, {"params": params, "opt": opt})
    print(f"done: {steps - start_step} steps in "
          f"{time.perf_counter() - t0:.1f}s")
    out.update(params=params, opt=opt, losses=losses, grad_norms=gnorms,
               lrs=lrs, step_s=step_s)
    return out


def microbatch_batches(data: SyntheticLM, start_step: int, steps: int,
                       microbatches: int, dev) -> list:
    """[step][microbatch] slices of each step's global batch."""
    batches = []
    for s in range(start_step, steps):
        full = data.batch(s, device=dev)
        bs = full["tokens"].shape[0] // microbatches
        batches.append([{k: v[i * bs:(i + 1) * bs] for k, v in full.items()}
                        for i in range(microbatches)])
    return batches


def _train_orchestrated(model, state: dict, data, start_step, steps, lr,
                        microbatches, dev) -> dict:
    """Microbatch DAG through the paper's scheduler (train.py:91-121), from
    the ``params`` and ``opt`` that it takes out of ``state``."""
    from ..core import hikey960, make_policy
    from ..train_orchestrator import run_training_threaded

    def grad_fn(p, b):
        return loss_and_grads(model, p, b)

    def update_fn(p, g, o):
        return adamw_update(p, g, o, lr=lr)

    batches = microbatch_batches(data, start_step, steps, microbatches, dev)
    _sync(dev)
    stats = run_training_threaded(
        hikey960(), make_policy("molding:crit-ptt"), state.pop("params"),
        state.pop("opt"), grad_fn, update_fn, batches)
    print(f"orchestrated: {stats['completed']} TAOs in "
          f"{stats['elapsed_s']:.1f}s; last losses "
          f"{[round(l, 3) for l in stats['losses'][-3:]]}")
    return {"params": stats.pop("params"), "opt": stats.pop("opt"),
            "stats": stats}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--orchestrate", action="store_true",
                    help="run microbatches through the XiTAO scheduler")
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions (the smoke "
                         "config)")
    args = ap.parse_args(argv)
    run(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        orchestrate=args.orchestrate, microbatches=args.microbatches,
        device=args.device)


if __name__ == "__main__":
    main()
