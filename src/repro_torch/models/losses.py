"""LM cross-entropy, both variants of ``repro.models.losses``,
differentiable on either device (the kernels under ``DecoderLM.loss`` launch
through ``autograd.Function``s where a graph is recorded).

``gather`` takes the gold logit with ``gather`` over the vocab dim;
``onehot`` sums ``logits * one_hot(targets)``.  The JAX package keeps both
because they shard differently (src/repro/models/losses.py:1-13); on one
card they compute the same values.  On DTensor logits (under a mesh) each
runs the reference's program under GSPMD (``_sharded_nll``):

  * ``gather`` all-gathers the fp32 logits over the vocab, as XLA lowers
    ``take_along_axis`` on a sharded vocab, and takes the gold logit from
    each rank's whole rows;
  * ``onehot`` is a vocab-parallel cross-entropy: each rank reduces its own
    vocab shard, the max, the sum of exponentials and the gold logit, and
    all-reduces those (B, S) fp32 values over the mesh dims that split the
    vocab.  No (B, S, V) tensor is gathered.
"""
from __future__ import annotations

import torch

from ..parallel.sharding import (all_reduce_over, is_shard, is_sharded,
                                 on_local_shards, replicate_as, shard_bounds)


def lm_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                     onehot: bool = False,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    if is_sharded(logits):
        nll = _sharded_nll(logits, replicate_as(targets, logits), onehot)
    else:
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        if onehot:
            iota = torch.arange(lf.shape[-1], device=lf.device)
            sel = iota == targets[..., None].long()
            gold = torch.where(sel, lf, torch.zeros_like(lf)).sum(dim=-1)
        else:
            gold = lf.gather(-1, targets[..., None].long())[..., 0]
        nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _sharded_nll(logits: torch.Tensor, targets: torch.Tensor,
                 onehot: bool) -> torch.Tensor:
    """The (B, S) negative log-likelihoods of DTensor ``logits`` (B, S, V)
    on each rank's local shards (``on_local_shards``), laid out as the
    logits' batch and sequence.  ``onehot`` keeps the vocab sharded as the
    logits have it and reduces it across the ranks (``_VocabNLL``);
    otherwise the fp32 logits are first replicated over the vocab, each
    rank's rows whole.  A rank's piece of the vocab starts at its offset
    (``shard_bounds``)."""
    from torch.distributed.tensor import Replicate

    mesh, last = logits.device_mesh, logits.ndim - 1
    if not onehot:
        logits = logits.float()
    pls = [p if is_shard(p) and (onehot or p.dim != last) else Replicate()
           for p in logits.placements]
    vocab_dims = [m for m, p in enumerate(pls) if is_shard(p)
                  and p.dim == last]
    start = shard_bounds(logits.shape, mesh, pls, last)[0] \
        if vocab_dims else 0
    tpls = [Replicate() if m in vocab_dims else p
            for m, p in enumerate(pls)]

    def all_reduce(t, op):
        return all_reduce_over(t, op, mesh, vocab_dims)

    return on_local_shards(
        lambda lg, tg: _VocabNLL.apply(lg, tg, start, all_reduce),
        [(logits, pls), (targets, tpls)], [tpls])[0]


class _VocabNLL(torch.autograd.Function):
    """logsumexp(l) - l[target] of a rank's logits ``l`` (B, S, Vl), the
    columns ``start`` .. ``start + Vl - 1`` of the vocab, with
    ``all_reduce(t, op)`` over the ranks that split the vocab (none: the
    whole vocab is local): the local max and its all-reduce ``max``, the
    local sum of exp(l - m) and its all-reduce ``sum``, the gold logit as a
    masked sum over the rank's own range and its all-reduce ``sum``.  The
    collectives carry (B, S) fp32 values.  Backward, local to the rank:
    (exp(l - lse) - onehot) g, in l's dtype; funcol's collectives have no
    autograd, and this one needs none."""

    @staticmethod
    def forward(ctx, logits, targets, start, all_reduce):
        # fp32 values with no fp32 copy of bf16 logits: the max and the
        # gold logit are exact in l's dtype, the difference promotes
        m = all_reduce(logits.amax(dim=-1).float(), "max")
        total = all_reduce(torch.sub(logits, m[..., None]).exp_().sum(
            dim=-1), "sum")
        lse = m + torch.log(total)
        local = targets.long() - start
        inside = (local >= 0) & (local < logits.shape[-1])
        gold = logits.gather(-1, torch.where(inside, local, 0)[..., None])
        gold = all_reduce(torch.where(inside, gold[..., 0].float(), 0.0),
                          "sum")
        ctx.save_for_backward(logits, lse, local, inside)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, inside = ctx.saved_tensors
        p = torch.sub(logits, lse[..., None]).exp_()
        hit = torch.where(inside, -1.0, 0.0).to(p.dtype)
        p.scatter_add_(-1, torch.where(inside, local, 0)[..., None],
                       hit[..., None])
        return p.mul_(g[..., None]).to(logits.dtype), None, None, None
