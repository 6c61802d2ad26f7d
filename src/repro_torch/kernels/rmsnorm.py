"""Fused RMSNorm, as a CUDA kernel for Hopper.

Counterpart of the Pallas ``rmsnorm`` (src/repro/kernels/rmsnorm.py:19-47):
``x * rsqrt(mean(x^2) + eps) * w`` for each row of (rows, d), in fp32, cast
back to x's dtype.  ``rmsnorm`` launches ``csrc/rmsnorm.cu`` (one block per
row, the row cached in registers as 16-byte vectors, one read and one write);
``plain`` is the same function in PyTorch, following ``ref.rmsnorm``
(src/repro/kernels/ref.py:27-30) and the models' own ``layers.rmsnorm``
(src/repro/models/layers.py:27-31).  The port's decoder calls it through
``ops.rmsnorm`` for every norm.  The TPU kernel's checks (``w`` of shape
(d,), ``rows % block_rows``) live in ``ops.rmsnorm``.
"""
from __future__ import annotations

import torch

from . import _build

launches = _build.LaunchCounter()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_THREADS, _MAX_VEC = 256, 8   # the kernel's block and register cache


def plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
          ) -> torch.Tensor:
    """RMSNorm of the rows of ``x`` (..., d) by ``w`` (d,)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def max_width(dtype: torch.dtype) -> int:
    """The widest row the kernel takes: its register cache of 16-byte
    vectors per thread."""
    return _MAX_THREADS * _MAX_VEC * 16 // torch.empty((), dtype=dtype
                                                       ).element_size()


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Launch the kernel on the current stream: (rows, d) out in x's dtype.
    ``x`` is fp32 or bf16; ``w`` is fp32 or x's dtype."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm kernel takes CUDA tensors on one device, "
                         f"got {x.device} and {w.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype not in (torch.float32,
                                                      x.dtype):
        raise ValueError(f"rmsnorm kernel takes x float32 or bfloat16 and w "
                         f"float32 or x's dtype, got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm kernel takes x (rows, d) and w (d,), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and w")
    rows, d = x.shape
    per_vec = 16 // x.element_size()
    if d % per_vec or not 0 < d <= max_width(x.dtype):
        raise ValueError(f"rmsnorm kernel takes d a multiple of {per_vec} up "
                         f"to {max_width(x.dtype)} for {x.dtype}, got {d}")
    if rows >= 2 ** 31:
        raise ValueError(f"rmsnorm kernel: {rows} rows out of range")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("rmsnorm kernel loads 16-byte vectors: x and w must "
                         "be 16-byte aligned")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.load()
    code = lib.repro_rmsnorm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                             rows, d, _DTYPE_CODES[x.dtype],
                             _DTYPE_CODES[w.dtype], float(eps),
                             x.device.index,
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "rmsnorm")
    launches.add()
    return out
