"""The benchmark's inputs that stand for weights and data: drawn on the device
from the run's seed by a ``torch.Generator`` there, one call a tensor, in the
dtype they are served in.  Both sides of a comparison read these tensors."""
from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(int(seed) % (2 ** 63))


def fill_normal(t: torch.Tensor, seed: int) -> torch.Tensor:
    """``t`` redrawn in place, standard normal, from ``seed``: the same seed
    gives the same values."""
    return torch.randn(t.shape, generator=generator(t.device, seed),
                       dtype=t.dtype, device=t.device, out=t)


def normal(shape, dtype: str, seed: int, device) -> torch.Tensor:
    """One standard-normal tensor of ``shape`` in ``dtype``."""
    return fill_normal(torch.empty(shape, dtype=DTYPES[dtype],
                                   device=device), seed)
