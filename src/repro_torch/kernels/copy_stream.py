"""Streaming copy: the paper's *memory-bound* class, as a CUDA kernel for
Hopper.

Counterpart of the Pallas ``copy`` (src/repro/kernels/copy_stream.py:23,
32-47).  ``copy`` launches ``csrc/copy_stream.cu``, which copies bytes with
16-byte vectors and so takes any element size; ``plain`` is the same function
in PyTorch.  Both always write a new buffer.  The ``block_rows`` check of the
TPU kernel lives in ``ops.copy``.
"""
from __future__ import annotations

import torch

from . import _build

launches = _build.LaunchCounter()


def plain(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` in a new buffer."""
    return x.clone()


def copy(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream: a new buffer equal to ``x``."""
    if x.device.type != "cuda":
        raise ValueError(f"copy kernel takes a CUDA tensor, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("copy kernel takes a contiguous tensor")
    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    if nbytes == 0:
        return out
    lib = _build.load()
    code = lib.repro_copy(x.data_ptr(), out.data_ptr(), nbytes,
                          x.device.index,
                          torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "copy")
    launches.add()
    return out
