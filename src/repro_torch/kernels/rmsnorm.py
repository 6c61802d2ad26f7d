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

``sumsq`` and ``scale`` are the two halves of the same function where a
row is split across ranks (its columns sharded): each row's fp32 sum of
squares over the local columns, then, given the totals all-reduced over
the ranks that split the row, ``x * rsqrt(total / d_full + eps) * w`` on
the local columns.  Both launch ``csrc/rmsnorm.cu``'s split entry points (a
warp a row); ``plain_sumsq`` and ``plain_scale`` are their PyTorch
versions.  ``models.layers.rmsnorm`` runs them under a mesh, with the
all-reduce between them.

``RMSNormFunction`` is the kernel's launch with a plain PyTorch backward,
which ``ops.rmsnorm`` takes where a graph is being recorded: the Pallas
kernel has no backward of its own (no ``custom_vjp``), and the JAX models
differentiate the jnp layer.
"""
from __future__ import annotations

import torch

from . import _build

launches = _build.LaunchCounter()
sumsq_launches = _build.LaunchCounter()
scale_launches = _build.LaunchCounter()

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


def plain_sumsq(x: torch.Tensor) -> torch.Tensor:
    """The sum of squares of each row of ``x`` (..., d), in fp32."""
    xf = _build.wide(x)
    return (xf * xf).sum(dim=-1)


def plain_scale(x: torch.Tensor, w: torch.Tensor, total: torch.Tensor,
                d_full: int, eps: float = 1e-6) -> torch.Tensor:
    """``x`` (..., d) by ``w`` (d,), each row scaled by rsqrt(total /
    d_full + eps) of its entry of ``total`` (...), the whole row's sum of
    squares: the ``plain`` norm's arithmetic, in x's dtype."""
    r = torch.rsqrt(_build.wide(total) / d_full + eps)
    return (_build.wide(x) * r[..., None] * _build.wide(w)).to(x.dtype)


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


def _check(what: str, x: torch.Tensor, w: torch.Tensor | None,
           widest: int) -> None:
    """The checks every entry point makes: CUDA tensors on one device, x
    (rows, d) fp32 or bf16 and w (d,) fp32 or x's dtype, contiguous and
    16-byte aligned, d a whole number of 16-byte vectors up to ``widest``."""
    others = () if w is None else (w,)
    if x.device.type != "cuda" or any(t.device != x.device for t in others):
        raise ValueError(f"{what} kernel takes CUDA tensors on one device, "
                         f"got {[str(t.device) for t in (x, *others)]}")
    if x.dtype not in _DTYPE_CODES or any(
            t.dtype not in (torch.float32, x.dtype) for t in others):
        raise ValueError(f"{what} kernel takes x float32 or bfloat16 and w "
                         f"float32 or x's dtype, got "
                         f"{[t.dtype for t in (x, *others)]}")
    if x.dim() != 2 or any(t.shape != (x.shape[1],) for t in others):
        raise ValueError(f"{what} kernel takes x (rows, d) and w (d,), got "
                         f"{[tuple(t.shape) for t in (x, *others)]}")
    if not all(t.is_contiguous() for t in (x, *others)):
        raise ValueError(f"{what} kernel takes contiguous x and w")
    rows, d = x.shape
    per_vec = 16 // x.element_size()
    if d % per_vec or not 0 < d <= widest:
        raise ValueError(f"{what} kernel takes d a multiple of {per_vec} up "
                         f"to {widest} for {x.dtype}, got {d}")
    if rows >= 2 ** 31:
        raise ValueError(f"{what} kernel: {rows} rows out of range")
    if any(t.data_ptr() % 16 for t in (x, *others)):
        raise ValueError(f"{what} kernel loads 16-byte vectors: x and w must "
                         f"be 16-byte aligned")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Launch the kernel on the current stream: (rows, d) out in x's dtype.
    ``x`` is fp32 or bf16; ``w`` is fp32 or x's dtype."""
    _check("rmsnorm", x, w, max_width(x.dtype))
    rows, d = x.shape
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


def sumsq(x: torch.Tensor) -> torch.Tensor:
    """Launch the split norm's first half on the current stream: (rows,)
    fp32, each row's sum of squares over the d columns of ``x`` (rows, d),
    fp32 or bf16, of any width."""
    _check("rmsnorm_sumsq", x, None, 2 ** 31 - 1)
    rows, d = x.shape
    out = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return out
    lib = _build.load()
    code = lib.repro_rmsnorm_sumsq(
        x.data_ptr(), out.data_ptr(), rows, d, _DTYPE_CODES[x.dtype],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "rmsnorm_sumsq")
    sumsq_launches.add()
    return out


def scale(x: torch.Tensor, w: torch.Tensor, total: torch.Tensor,
          d_full: int, eps: float = 1e-6) -> torch.Tensor:
    """Launch the split norm's second half on the current stream: (rows, d)
    in x's dtype, ``x * rsqrt(total / d_full + eps) * w`` in fp32, ``total``
    (rows,) fp32 the whole rows' sums of squares over ``d_full`` columns."""
    _check("rmsnorm_scale", x, w, 2 ** 31 - 1)
    rows, d = x.shape
    if total.dtype != torch.float32 or total.shape != (rows,) or \
            total.device != x.device or not total.is_contiguous():
        raise ValueError(f"rmsnorm_scale kernel takes total ({rows},) "
                         f"float32 contiguous on {x.device}, got "
                         f"{tuple(total.shape)} {total.dtype} on "
                         f"{total.device}")
    if not d <= d_full < 2 ** 31:
        raise ValueError(f"rmsnorm_scale kernel: d_full {d_full} must be at "
                         f"least the local width {d}")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.load()
    code = lib.repro_rmsnorm_scale(
        x.data_ptr(), w.data_ptr(), total.data_ptr(), out.data_ptr(), rows,
        d, d_full, _DTYPE_CODES[x.dtype], _DTYPE_CODES[w.dtype], float(eps),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "rmsnorm_scale")
    scale_launches.add()
    return out
