"""Flash attention (forward) with GQA, causal and sliding-window masks, as a
CUDA kernel for Hopper.

Counterpart of the Pallas ``flash_attention``
(src/repro/kernels/flash_attention.py:33-146).  ``flash_attention``
launches ``csrc/flash_attention.cu`` (one block per (batch, head, 64-row q
tile), looping over 64-key tiles with the softmax state in registers; for
bf16 both products on the tensor cores, P kept in registers as a bf16 high
and low part, K/V tiles double-buffered by cp.async; for fp32 fmaf without
TF32).  ``plain`` is the dense PyTorch version, following ``ref.attention``
(src/repro/kernels/ref.py:33-62), the reference the tests and
``chip_smoke.py`` hold the kernel to.  Both output 0 for a row that sees no
key.  ``plain_chunked`` is the same function one q chunk at a time, the
twin of the reference model's q-chunked and block-skipping attention, and
``plain_backward`` its grads chunk by chunk: neither makes an (S, Sk)
tensor.  The tiling checks of the TPU kernel (``S % bq``, ``Sk % bk``) live
in ``ops.flash_attention``, which checks the heads once and then calls
``launch``, ``plain`` or ``plain_chunked``, or ``FlashAttentionFunction``
(the launch with a plain backward, dense or chunk-wise) where a graph is
being recorded.
"""
from __future__ import annotations

import math

import torch

from . import _build

launches = _build.LaunchCounter()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)  # the head sizes the kernel is compiled for


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
    return _rows(q, k, v, 0, 0, causal, window, sm_scale)


def _rows(q, k, v, q_lo: int, k_lo: int, causal: bool, window: int | None,
          sm_scale: float | None) -> torch.Tensor:
    """Attention of the rows q_lo.. (q) over the keys k_lo.. (k, v), masked
    on those absolute indices, fp32 inside, cast to q's dtype."""
    _, hq, s, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    kr = _build.wide(k.repeat_interleave(group, dim=1))
    vr = _build.wide(v.repeat_interleave(group, dim=1))
    scores = torch.einsum("bhqd,bhkd->bhqk", _build.wide(q), kr) * scale
    # (s, sk) made from the scores, so a DTensor's mask is one on its mesh
    mask = scores.new_ones((s, sk), dtype=torch.bool)
    if causal:
        mask = mask.tril(q_lo - k_lo)                 # col <= row
    if window is not None:
        mask = mask.triu(q_lo - k_lo - window + 1)    # col > row - window
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    out = torch.where(mask.any(dim=-1)[:, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def chunk_keys(q_lo: int, sk: int, *, causal: bool, window: int | None,
               chunk: int, block_skip: bool) -> tuple[int, int]:
    """The keys lo..hi-1 that the q chunk starting at row ``q_lo`` reads:
    all of them, or under ``block_skip`` the reference's static slice
    (layers.py:141-145): up to the chunk's last row if causal, from its
    first row's window start rounded down to a multiple of ``chunk``."""
    if not block_skip:
        return 0, sk
    hi = min(q_lo + chunk, sk) if causal else sk
    lo = 0
    if window is not None:
        lo = max(0, q_lo - (window - 1)) // chunk * chunk
    return lo, hi


def _chunks(s: int, chunk: int) -> range:
    if chunk <= 0 or s % chunk:
        raise ValueError(f"seq {s} not divisible by attn chunk {chunk}")
    return range(0, s, chunk)


def plain_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  sm_scale: float | None = None, chunk: int,
                  block_skip: bool = False) -> torch.Tensor:
    """``plain`` one q chunk of ``chunk`` rows at a time, the twin of the
    reference's ``_chunked_attention`` and ``_chunked_attention_skip``
    (src/repro/models/layers.py:92-153): each chunk's fp32 scores span
    the keys ``chunk_keys`` gives it, so the largest transient is (B, Hq,
    chunk, Sk), never (B, Hq, S, Sk).  S must be a multiple of ``chunk``."""
    outs = []
    for a in _chunks(q.shape[2], chunk):
        lo, hi = chunk_keys(a, k.shape[2], causal=causal, window=window,
                            chunk=chunk, block_skip=block_skip)
        outs.append(_rows(q[:, :, a:a + chunk], k[:, :, lo:hi],
                          v[:, :, lo:hi], a, lo, causal, window, sm_scale))
    return torch.cat(outs, dim=2)


def plain_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, *, causal: bool = True,
                   window: int | None = None, sm_scale: float | None = None,
                   chunk: int, block_skip: bool = False) -> tuple:
    """The grads (dq, dk, dv) of ``plain_chunked``'s output against ``g``,
    one q chunk at a time: each chunk's attention recomputed from q, k and
    v under ``enable_grad`` and differentiated, dq's rows written, dk and
    dv summed in fp32 over the chunks and cast once at the end.  The
    largest transient is a chunk's (B, Hq, chunk, Sk) fp32 scores."""
    dq = torch.empty_like(q)
    dk = k.new_zeros(k.shape, dtype=torch.promote_types(k.dtype,
                                                        torch.float32))
    dv = torch.zeros_like(dk)
    for a in _chunks(q.shape[2], chunk):
        lo, hi = chunk_keys(a, k.shape[2], causal=causal, window=window,
                            chunk=chunk, block_skip=block_skip)
        qc = q[:, :, a:a + chunk].detach().requires_grad_()
        kc, vc = (_build.wide(t[:, :, lo:hi].detach()).requires_grad_()
                  for t in (k, v))
        with torch.enable_grad():
            out = _rows(qc, kc, vc, a, lo, causal, window, sm_scale)
        gq, gk, gv = torch.autograd.grad(out, (qc, kc, vc),
                                         g[:, :, a:a + chunk])
        dq[:, :, a:a + chunk] = gq
        dk[:, :, lo:hi] += gk
        dv[:, :, lo:hi] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """``launch`` (the kernel, one count) forward.  Backward: without a
    ``chunk``, ``plain`` recomputed on the saved q, k and v under
    ``enable_grad`` (fp32 inside, the same causal, window and GQA
    arguments) and differentiated; with one, ``plain_backward``, chunk by
    chunk.  A row that sees no key outputs 0 through a ``where``, so it
    passes back no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale, chunk=None,
                block_skip=False):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(causal=causal, window=window, sm_scale=sm_scale)
        ctx.chunks = None if chunk is None else dict(chunk=chunk,
                                                     block_skip=block_skip)
        return launch(q, k, v, **ctx.args)

    @staticmethod
    def backward(ctx, g):
        if ctx.chunks is not None:
            grads = plain_backward(*ctx.saved_tensors, g, **ctx.args,
                                   **ctx.chunks)
        else:
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            with torch.enable_grad():
                out = plain(*qkv, **ctx.args)
            grads = torch.autograd.grad(out, qkv, g)
        return (*(gr if need else None for gr, need in
                  zip(grads, ctx.needs_input_grad)), None, None, None, None,
                None)


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
