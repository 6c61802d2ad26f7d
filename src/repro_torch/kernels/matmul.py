"""Matmul: the paper's *compute-bound* class, as a CUDA kernel for Hopper.

Counterpart of the Pallas ``matmul`` (src/repro/kernels/matmul.py:25-77).
``matmul`` launches ``csrc/matmul.cu``: for bf16, ``wgmma`` fed by a TMA
ring when m > 16 and a streaming kernel that reads y once when m <= 16 (the
decode GEMV), one launch either way; for fp32, FMA without TF32.  ``plain``
is the same function in PyTorch, the reference the tests and
``chip_smoke.py`` hold the kernel to.
The tiling checks of the TPU kernel live in ``ops.matmul``, which takes
``MatmulFunction`` (the launch with a plain backward) where a graph is being
recorded.
"""
from __future__ import annotations

import torch

from . import _build

launches = _build.LaunchCounter()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def plain(x: torch.Tensor, y: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``x @ y`` in float32, cast to ``out_dtype`` (default ``x.dtype``)."""
    return (_build.wide(x) @ _build.wide(y)).to(out_dtype or x.dtype)


class MatmulFunction(torch.autograd.Function):
    """``matmul`` (the kernel, one count) forward; backward ``g @ y^T`` and
    ``x^T @ g`` in fp32, each cast to its operand's dtype."""

    @staticmethod
    def forward(ctx, x, y, out_dtype):
        ctx.save_for_backward(x, y)
        return matmul(x, y, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        gf = _build.wide(g)
        dx = (gf @ _build.wide(y).T).to(x.dtype) \
            if ctx.needs_input_grad[0] else None
        dy = (_build.wide(x).T @ gf).to(y.dtype) \
            if ctx.needs_input_grad[1] else None
        return dx, dy, None


def matmul(x: torch.Tensor, y: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Launch the kernel on the current stream: (m, k) @ (k, n) -> (m, n)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"matmul kernel takes CUDA tensors on one device, "
                         f"got {x.device} and {y.device}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"contracting dims mismatch: {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    if x.dtype != y.dtype or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"matmul kernel takes two float32 or two bfloat16 "
                         f"operands, got {x.dtype} and {y.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"matmul kernel writes float32 or bfloat16, "
                         f"not {out_dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul kernel takes contiguous operands")
    (m, k), n = x.shape, y.shape[1]
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"matmul kernel takes dims below 2**31, got "
                         f"({m},{k})x({k},{n})")
    if x.dtype == torch.bfloat16 and (
            k % 8 or n % 8 or x.data_ptr() % 16 or y.data_ptr() % 16):
        raise ValueError("bf16 matmul kernel loads 16-byte vectors and TMA "
                         "boxes: k and n must be multiples of 8 and the "
                         "operands 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = _build.load()
    code = lib.repro_matmul(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "matmul")
    launches.add()
    return out
