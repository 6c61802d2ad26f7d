"""Fused RMSNorm, as a CUDA kernel for Hopper.

Counterpart of the Pallas ``rmsnorm`` (src/repro/kernels/rmsnorm.py:19-47):
``x * rsqrt(mean(x^2) + eps) * w`` for each row of (rows, d), in fp32, cast
back to x's dtype.  ``rmsnorm`` launches ``csrc/rmsnorm.cu`` (a row owned by
the fewest warps that cache it in registers as 16-byte vectors, one warp at
the decoder's d = 2048, several rows a block; one read and one write);
``plain`` is the same function in PyTorch, following ``ref.rmsnorm``
(src/repro/kernels/ref.py:27-30) and the models' own ``layers.rmsnorm``
(src/repro/models/layers.py:27-31).  The port's decoder calls it through
``ops.rmsnorm`` for every norm.  The TPU kernel's checks (``w`` of shape
(d,), ``rows % block_rows``) live in ``ops.rmsnorm``.

``RMSNormFunction`` is the kernel's launch with a plain PyTorch backward,
which ``ops.rmsnorm`` takes where a graph is being recorded: the Pallas
kernel has no backward of its own (no ``custom_vjp``), and the JAX models
differentiate the jnp layer.
"""
from __future__ import annotations

import torch

from . import _build

launches = _build.LaunchCounter()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's geometry: a row is owned by 1, 2, 4 or 8 warps, the fewest
# that keep each lane at 8 or fewer 16-byte vectors of x
_WARPS_PER_ROW, _MAX_VEC = (1, 2, 4, 8), 8
# row counts on both sides of each step of the launch's geometry on 132
# SMs: up to 32 rows a row gets 8 warps; above, a block holds
# ceil(rows / 132) rows (at most 8), so one row a block up to 132, and the
# grid steps past 128 blocks at 257 (2 a block) and 1025 (8 a block)
EDGE_ROWS = (1, 2, 3, 4, 5, 31, 32, 33, 132, 133, 255, 256, 257, 1023, 1024,
             1025)


def plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
          ) -> torch.Tensor:
    """RMSNorm of the rows of ``x`` (..., d) by ``w`` (d,)."""
    xf = _build.wide(x)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * _build.wide(w)).to(x.dtype)


class RMSNormFunction(torch.autograd.Function):
    """``rmsnorm`` (the kernel's launch, one count) forward; backward in
    fp32 by the closed form, from the saved x and w and the per-row
    r = rsqrt(mean(x^2) + eps):
        dx = r (w g) - x r^3 mean(x w g),   dw = sum over rows of g x r."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xf, wf, gf = _build.wide(x), _build.wide(w), _build.wide(g)
        r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + ctx.eps)
        wg = wf * gf
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (r * wg - xf * r ** 3 * (xf * wg).mean(dim=-1, keepdim=True)
                  ).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (gf * xf * r).sum(dim=0).to(w.dtype)
        return dx, dw, None


def max_width(dtype: torch.dtype) -> int:
    """The widest row the kernel takes: 8 warps of lanes caching 8
    16-byte vectors each."""
    return geometry_edges(dtype)[-1]


def geometry_edges(dtype: torch.dtype) -> list[int]:
    """The widths d around which the kernel's geometry changes: one vector,
    and one vector either side of each warps-per-row step (the last is the
    widest row it takes)."""
    per_vec = 16 // torch.empty((), dtype=dtype).element_size()
    vecs = {1}
    for wpr in _WARPS_PER_ROW:
        step = 32 * wpr * _MAX_VEC
        vecs |= {step - 1, step} | ({step + 1} if wpr < 8 else set())
    return [v * per_vec for v in sorted(vecs)]


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
