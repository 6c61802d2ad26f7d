"""Streaming kernels: the paper's *memory-bound* class, as CUDA kernels for
Hopper.

Counterpart of the Pallas ``copy`` (src/repro/kernels/copy_stream.py:23,
32-47).  ``copy`` launches ``csrc/copy_stream.cu``, which copies bytes with
16-byte vectors and so takes any element size; ``plain`` is the same function
in PyTorch.  Both always write a new buffer.

Counterpart of the Pallas ``triad`` (copy_stream.py:27-28, 51-74): ``triad``
launches the same source's ``a * x + y`` pass for fp32 or bf16, and
``plain_triad`` is the same function in PyTorch, ``a`` cast to x's dtype as
``repro.kernels.ref.triad`` casts it.  Each kernel has its own counter.  The
``block_rows`` and shape checks of the TPU kernels live in ``ops``.
"""
from __future__ import annotations

import torch

from . import _build

launches = _build.LaunchCounter()
triad_launches = _build.LaunchCounter()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def plain_triad(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a * x + y`` with ``a`` cast to x's dtype."""
    return torch.as_tensor(a, dtype=x.dtype, device=x.device) * x + y


def triad(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch the triad kernel on the current stream: a new ``a * x + y``."""
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"triad kernel takes CUDA tensors on one device, "
                         f"got {x.device} and {y.device}")
    if x.dtype not in _DTYPE_CODES or y.dtype != x.dtype:
        raise ValueError(f"triad kernel takes x and y both float32 or both "
                         f"bfloat16, got {x.dtype} and {y.dtype}")
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("triad kernel takes contiguous x and y")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    a_cast = float(torch.as_tensor(a, dtype=x.dtype))
    lib = _build.load()
    code = lib.repro_triad(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                           x.numel(), _DTYPE_CODES[x.dtype], a_cast,
                           x.device.index,
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "triad")
    triad_launches.add()
    return out
