"""Deterministic synthetic data pipeline.  Twin of
``repro.data.pipeline``.

The generators are the JAX package's own numpy code (per-host iterator,
global-batch assembly, seeding by (seed, step, host), a Zipf-ish token
source), so both packages draw the same batches bit for bit; only the final
arrays become tensors, on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel.sharding import abstract_tensor
from ..workers import resolve_device


@dataclasses.dataclass
class SyntheticLM:
    """Zipf-distributed token stream -> (tokens, targets) batches."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    def __post_init__(self):
        if self.global_batch % self.host_count:
            raise ValueError("global_batch must divide by host_count")
        self._host_batch = self.global_batch // self.host_count

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.host_index)

    def host_batch(self, step: int) -> dict:
        """The shard of the global batch this host produces (int32 numpy)."""
        rng = self._rng(step)
        # Zipf-ish marginal over the vocab (heavy head like natural text)
        z = rng.zipf(1.3, size=(self._host_batch, self.seq_len + 1))
        tokens = np.minimum(z - 1, self.vocab_size - 1).astype(np.int32)
        return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}

    def batch(self, step: int, device="cuda") -> dict:
        """Single-host convenience: the full global batch as int32 tensors
        on ``device``."""
        dev = resolve_device(device)
        out = [self.host_batch(step)] if self.host_count == 1 else [
            dataclasses.replace(self, host_index=h).host_batch(step)
            for h in range(self.host_count)]
        cat = {k: np.concatenate([o[k] for o in out]) for k in out[0]}
        return {k: torch.from_numpy(v).to(dev) for k, v in cat.items()}


@dataclasses.dataclass
class SyntheticFrames:
    """Precomputed frame/patch embeddings for [audio]/[vlm] stub frontends."""

    d_model: int
    seq_len: int
    global_batch: int
    n_classes: int = 504
    seed: int = 0

    def batch(self, step: int, device="cuda") -> dict:
        """bf16 ``frames`` (the fp32 draws rounded to nearest even, as
        ``jnp.asarray(.., jnp.bfloat16)`` rounds them) and int32
        ``targets``, on ``device``."""
        dev = resolve_device(device)
        rng = np.random.default_rng(self.seed * 7 + step)
        feats = rng.standard_normal(
            (self.global_batch, self.seq_len, self.d_model)).astype(np.float32)
        labels = rng.integers(
            0, self.n_classes,
            size=(self.global_batch, self.seq_len)).astype(np.int32)
        return {"frames": torch.from_numpy(feats).to(dev, torch.bfloat16),
                "targets": torch.from_numpy(labels).to(dev)}


def make_batch_specs(batch: dict, shardings: dict | None = None) -> dict:
    """Meta mirror of a batch (the dry run's stand-in): each tensor's shape
    and dtype, a DTensor where ``shardings`` gives its key a
    ``(mesh, placements)`` (``parallel.sharding.logical_sharding``'s)."""
    return {k: abstract_tensor(v.shape, v.dtype,
                               None if shardings is None else
                               shardings.get(k))
            for k, v in batch.items()}
