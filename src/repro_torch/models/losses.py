"""LM cross-entropy, both variants of ``repro.models.losses``,
differentiable on either device (the kernels under ``DecoderLM.loss`` launch
through ``autograd.Function``s where a graph is recorded).

``gather`` takes the gold logit with ``gather`` over the vocab dim;
``onehot`` sums ``logits * one_hot(targets)``.  The JAX package keeps both
because they shard differently; on one card they compute the same values.
On DTensor logits (under a mesh) the loss takes ``onehot`` whatever the
flag: its gold logit is a masked sum over the vocab, which runs on each
vocab shard and ends in an all-reduce of (B, S) values, as GSPMD runs it
(src/repro/models/losses.py:1-13).  DTensor has no sharded rule for a
``gather`` along a sharded dim.  So ``ce_onehot`` has no effect on a mesh,
and the dry run refuses ``--set ce_onehot`` (``launch.dryrun.
MESH_NO_EFFECT``).
"""
from __future__ import annotations

import torch

from ..parallel.sharding import is_sharded, replicate_as


def lm_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                     onehot: bool = False,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    if onehot or is_sharded(lf):
        iota = replicate_as(torch.arange(lf.shape[-1], device=lf.device), lf)
        sel = iota == targets[..., None].long()
        gold = torch.where(sel, lf, torch.zeros_like(lf)).sum(dim=-1)
    else:
        gold = lf.gather(-1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
