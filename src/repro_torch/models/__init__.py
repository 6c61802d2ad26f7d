"""repro_torch.models -- the port's model zoo and its generic train and
serve steps.  Twin of ``repro.models``: the decoder family (dense, MoE with
sliding windows, the patch frontend) and the encoder (hubert, the frames
frontend) in ``DecoderLM``, the ``ssm`` family (mamba2) in ``Mamba2LM`` and
the ``hybrid`` family (hymba) in ``HymbaLM``."""
from __future__ import annotations

from typing import Callable

import torch

from ..parallel.sharding import is_sharded
from .hybrid import HymbaLM
from .mamba2 import Mamba2LM
from .model_api import BaseModel, ModelConfig, ParamDef
from .transformer import DecoderLM


def get_model(cfg: ModelConfig) -> BaseModel:
    if cfg.family in ("decoder", "encoder"):
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        return Mamba2LM(cfg)
    if cfg.family == "hybrid":
        return HymbaLM(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


def loss_and_grads(model: BaseModel, params: dict, batch: dict
                   ) -> tuple[dict, dict]:
    """``model.loss`` at ``params`` and its grads, the twin of
    ``jax.value_and_grad(model.loss, has_aux=True)``: (grads keyed as
    ``params``, detached metrics).  The grads are taken of detached copies
    that require grad, so ``params`` stay as they were.  Grad mode is per
    thread, so this turns it on itself (and inference mode off) for a
    caller on any thread.  A parameter that the loss does not read (the
    token embedding of an encoder on frames) gets zeros, as ``jax.grad``
    gives it.

    Under a mesh each grad lands where its parameter lives, as
    ``jax.value_and_grad`` under a sharded jit gives it: a DTensor grad,
    which the backward leaves a partial sum over ``data`` (and over
    ``model`` where a body on local shards split the work), is
    redistributed once to its parameter's mesh and placements, one
    reduce-scatter (an all-reduce for a replicated weight), so that the
    clip and AdamW meet no partial sum and the step hands its state back
    as it took it.  A plain tensor is returned as the backward left it."""
    with torch.inference_mode(False), torch.enable_grad():
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss, metrics = model.loss(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _placed_like(g, p)
             for p, g in zip(leaves.values(), grads)]
    return (dict(zip(leaves, grads)),
            {k: v.detach() for k, v in metrics.items()})


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` in ``p``'s mesh and placements where both are DTensors and the
    placements differ; else ``g`` itself."""
    if not is_sharded(g) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _hold_placements(before: dict, after: dict, what: str) -> None:
    """Raise ``AssertionError`` naming the first tensor of ``after`` whose
    placements are not its twin's in ``before`` (DTensors alone; a tuple
    comparison, no collective)."""
    for k, p in before.items():
        if is_sharded(p) and tuple(after[k].placements) != tuple(
                p.placements):
            raise AssertionError(
                f"the train step moved {what} {k!r} from {p.placements} "
                f"to {after[k].placements}")


def make_train_step(model: BaseModel, lr_schedule: Callable | float = 3e-4,
                    max_grad_norm: float = 1.0):
    """(params, opt_state, batch) -> (params, opt_state, metrics): grads of
    ``model.loss``, clipped to ``max_grad_norm``, then AdamW at
    ``lr_schedule(opt_state.step + 1)``.  ``metrics`` holds ``loss``,
    ``ppl_proxy``, ``grad_norm`` and ``lr``.  Functional, as JAX's step.
    Under a mesh it hands back every parameter and moment in the
    placements it took them in, so that the next step takes its outputs
    (as the reference's jitted step takes its donated state), and raises
    ``AssertionError`` naming the first that differs."""
    from ..optimizer import adamw_update, clip_by_global_norm, constant_lr

    sched = lr_schedule if callable(lr_schedule) else constant_lr(lr_schedule)

    def train_step(params, opt_state, batch):
        grads, metrics = loss_and_grads(model, params, batch)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = sched(opt_state.step + 1)
        new, new_state = adamw_update(params, grads, opt_state, lr)
        _hold_placements(params, new, "parameter")
        _hold_placements(opt_state.mu, new_state.mu, "first moment")
        _hold_placements(opt_state.nu, new_state.nu, "second moment")
        params, opt_state = new, new_state
        metrics.update({"grad_norm": gnorm, "lr": lr})
        return params, opt_state, metrics

    return train_step


def _serve_mode(params: dict):
    """``torch.inference_mode()``, or ``torch.no_grad()`` where the
    parameters are DTensors (``abstract_params`` under a mesh): DTensor
    slices (``unbound``) set a version counter, which an inference tensor
    refuses."""
    if is_sharded(next(iter(params.values()))):
        return torch.no_grad()
    return torch.inference_mode()


def make_prefill_step(model: BaseModel):
    """``model.prefill`` under ``_serve_mode``.  Grad mode is per thread, so
    a payload on a worker thread takes the step, not the bare method.
    ``max_len`` passes through."""
    def prefill_step(params, batch, **kw):
        with _serve_mode(params):
            return model.prefill(params, batch, **kw)
    return prefill_step


def make_decode_step(model: BaseModel):
    """``model.decode_step`` under ``_serve_mode``, as
    ``make_prefill_step``."""
    def decode_step(params, tokens, cache):
        with _serve_mode(params):
            return model.decode_step(params, tokens, cache)
    return decode_step


def make_encode_step(model: BaseModel):
    """Encoder-only serve step, full forward -> per-frame logits
    (``model.forward``), under ``_serve_mode`` as ``make_prefill_step``."""
    def encode_step(params, batch):
        with _serve_mode(params):
            return model.forward(params, batch)
    return encode_step


__all__ = ["BaseModel", "ModelConfig", "ParamDef", "DecoderLM", "Mamba2LM",
           "HymbaLM", "get_model", "loss_and_grads", "make_train_step",
           "make_prefill_step", "make_decode_step", "make_encode_step"]
