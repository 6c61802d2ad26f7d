"""Distributed-optimization collectives: compressed gradient reduction with
error feedback, on ``torch.distributed``.  Twin of
``repro.parallel.collectives``.

``compressed_psum`` all-reduces an int8-quantized tensor (per-tensor scale,
symmetric) with an **error-feedback accumulator**, so the quantization error
is re-injected the next step (Karimireddy et al.-style EF-SGD).  The
arithmetic is the reference's: scale ``amax / 127``, round half to even,
clip to +-127, dequantize in fp32, transmit the bf16 of that grid, take the
residual against the transmitted value, and reduce in fp32 (sum over the
group, divided by its size).

The reduction's group is a mesh axis name, resolved against the current
sharding context's mesh (``mesh.get_group(axis)``), or a ``ProcessGroup``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import current_ctx


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization -> (q, scale).  The scale is
    ``amax / 127`` in ``x``'s dtype, then fp32; ``x / scale`` divides in
    fp32, as JAX promotes it.  Both are true divisions by a tensor on
    ``x``'s device: CUDA divides by a Python scalar as ``x * (1 / d)``,
    which moves grid points."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, _div(amax, 127.0), 1.0).to(torch.float32)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device."""
    return x / x.new_full((), d)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _group(axis):
    """The process group of a mesh axis name under the current context, or
    ``axis`` itself when it is a group."""
    if not isinstance(axis, str):
        return axis
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None:
        raise RuntimeError(f"axis {axis!r} names no group outside a mesh "
                           f"(use_sharding(mesh))")
    return ctx.mesh.get_group(axis)


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` in ``x``'s dtype, divided by the
    group's size."""
    total = x.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return _div(total, dist.get_world_size(group))


def compressed_psum(x: torch.Tensor, axis, error: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce over ``axis`` with error feedback.

    Returns (mean-reduced tensor, new error accumulator).  ``error`` is the
    residual from the previous step (zeros to start)."""
    if error is not None:
        x = x + error
    q, scale = quantize_int8(x)
    # wire format: bf16 of the dequantized int8 grid; the residual is taken
    # against the value actually transmitted, so its bf16 rounding is
    # re-injected too
    wire = dequantize_int8(q, scale).to(torch.bfloat16)
    new_error = x - wire.to(x.dtype)
    return _mean(wire.float(), _group(axis)).to(x.dtype), new_error


def grad_sync_tree(grads, axis, errors=None, compress: bool = True):
    """All-reduce a gradient tree (nested dicts of tensors) over ``axis``
    (mean), optionally compressed with per-leaf error feedback.  Returns
    (reduced tree, new error tree), each shaped as ``grads``."""
    if isinstance(grads, dict):
        pairs = {k: grad_sync_tree(g, axis,
                                   None if errors is None else errors[k],
                                   compress)
                 for k, g in grads.items()}
        return ({k: r for k, (r, _) in pairs.items()},
                {k: e for k, (_, e) in pairs.items()})
    if not compress:
        return _mean(grads, _group(axis)), torch.zeros_like(grads)
    if errors is None:
        errors = torch.zeros_like(grads)
    return compressed_psum(grads, axis, errors)
