"""LM cross-entropy, both variants of ``repro.models.losses`` (forward
only: training waits for ROADMAP.md, Queue 1 item 4).

``gather`` takes the gold logit with ``gather`` over the vocab dim;
``onehot`` sums ``logits * one_hot(targets)``.  The JAX package keeps both
because they shard differently; on one card they compute the same values.
"""
from __future__ import annotations

import torch


def lm_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                     onehot: bool = False,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
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
