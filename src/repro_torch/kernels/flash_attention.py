"""Flash attention (forward) with GQA, causal and sliding-window masks, as a
CUDA kernel for Hopper.

Counterpart of the Pallas ``flash_attention``
(src/repro/kernels/flash_attention.py:33-146).  ``flash_attention``
launches ``csrc/flash_attention.cu`` (one block per (batch, head, 64-row q
tile), looping over 64-key tiles with the softmax state in registers;
q . k^T on the tensor cores for bf16, fmaf without TF32 for fp32; P . V in
fp32).  ``plain`` is the dense PyTorch version, following ``ref.attention``
(src/repro/kernels/ref.py:33-62), the reference the tests and
``chip_smoke.py`` hold the kernel to.  Both output 0 for a row that sees no
key.  The tiling checks of the TPU kernel (``S % bq``, ``Sk % bk``) live in
``ops.flash_attention``, which checks the heads once and then calls
``launch`` or ``plain``.
"""
from __future__ import annotations

import math

import torch

from . import _build

launches = _build.LaunchCounter()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)  # the head sizes the kernel is compiled for


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The TPU kernel's checks on the heads (flash_attention.py:110-115)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[3] != k.shape[3] or q.shape[0] != k.shape[0]:
        raise ValueError(f"bad kv shapes {tuple(k.shape)} {tuple(v.shape)} "
                         f"for q {tuple(q.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads "
                         f"{k.shape[1]}")


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True, window: int | None = None,
          sm_scale: float | None = None) -> torch.Tensor:
    """Dense attention: q (B, Hq, S, D), k and v (B, Hkv, Sk, D).  Masks on
    absolute, top-left indices; a row that sees no key outputs 0."""
    _, hq, s, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    out = torch.where(mask.any(dim=-1)[:, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream: (B, Hq, S, D) out."""
    check_shapes(q, k, v)
    return launch(q, k, v, causal=causal, window=window, sm_scale=sm_scale)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int | None,
           sm_scale: float | None) -> torch.Tensor:
    """``flash_attention`` on heads that ``check_shapes`` has passed."""
    tensors = (q, k, v)
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError(f"flash_attention kernel takes CUDA tensors on one "
                         f"device, got {[str(x.device) for x in tensors]}")
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in tensors):
        raise ValueError(f"flash_attention kernel takes q, k, v all float32 "
                         f"or all bfloat16, got "
                         f"{[str(x.dtype) for x in tensors]}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("flash_attention kernel takes contiguous q, k, v")
    b, hq, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if max(b, hq, s, sk) >= 2 ** 30 or b > 65535 or hq > 65535:
        raise ValueError(f"flash_attention kernel: shape q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} out of range")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("flash_attention kernel loads 16-byte vectors: q, "
                         "k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if sk == 0:
        return out.zero_()
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    # a window >= S lets every column through and one <= -Sk none: clamp
    # into [-Sk, S] so that row - window stays inside int32 on the card
    win = 0 if window is None else max(-sk, min(int(window), s))
    lib = _build.load()
    code = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        s, sk, d, _DTYPE_CODES[q.dtype], int(bool(causal)),
        int(window is not None), win, float(scale), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention")
    launches.add()
    return out
