"""Shared model layers of the port: RMSNorm, RoPE, GQA attention (prefill
and decode) and SwiGLU.  Twin of ``repro.models.layers``.

Two of them run the port's kernels through ``kernels.ops``, which launches
the CUDA kernel for a tensor on the card and takes its plain PyTorch version
on the CPU:
  * ``rmsnorm`` runs the RMSNorm kernel, which computes exactly the JAX
    layer's function (fp32 inside, cast back to x's dtype);
  * ``attention`` runs the flash-attention kernel.  The JAX layer computes the
    same function in jnp, dense up to ``dense_max_seq`` and q-chunked above
    it; the kernel takes any length, so the port has one path.
``decode_attention`` and ``swiglu`` stay plain PyTorch, as the JAX package
leaves them to XLA outside any Pallas kernel.  ``moe_ffn`` waits for the MoE
port (ROADMAP.md, Queue 1 item 3).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim of ``x`` by ``w`` (fp32 masters with bf16
    activations, as the models pass them).  All rows go to one kernel call:
    ``block_rows=rows`` keeps the Pallas path's tiling check satisfiable at a
    decode step's 1-4 rows (the JAX models never called the Pallas kernel,
    so there is no reference tiling)."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    out = ops.rmsnorm(x2, w, eps=eps, block_rows=max(1, x2.shape[0]))
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(hd: int, theta: float, fraction: float = 1.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies (fp32) for the rotated sub-dimension."""
    rot = int(hd * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (S,) or (B, S).  Rotates interleaved lane
    pairs (0::2, 1::2) with fp32 angles, as the JAX layer does (not the
    split-half layout).  ``fraction < 1`` rotates only the leading sub-dim
    (ChatGLM-style partial RoPE)."""
    b, s, h, d = x.shape
    inv = rope_freqs(d, theta, fraction, device=x.device)
    rot = inv.shape[0] * 2
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, :, None].float() * inv[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]  # (B, S, 1, rot/2)
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(b, s, h, rot).to(x.dtype)
    return torch.cat([out, x[..., rot:]], dim=-1) if rot < d else out


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention over a whole sequence.  q: (B, Hq, S, D); k, v:
    (B, Hkv, S, D).  Positions are 0..S-1, as in every model path, so the
    kernel's top-left mask on indices is the JAX layer's mask on positions;
    every row sees a key, so the JAX bias fill of -1e30 and the kernel agree.
    ``bq = bk = S`` satisfy the TPU kernel's tiling check at any length; the
    CUDA kernel tiles by itself."""
    s = q.shape[2]
    return ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True, bq=s, bk=s)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *,
                     valid_mask: torch.Tensor) -> torch.Tensor:
    """Single-position attention over a cache.  q: (B, Hq, 1, D); k/v_cache:
    (B, Hkv, S, D); ``valid_mask`` (B, S) or (S,) says which entries are
    visible."""
    b, hq, _, d = q.shape
    g = hq // k_cache.shape[1]
    qg = q.reshape(b, k_cache.shape[1], g, d)
    scores = torch.einsum("bhgd,bhkd->bhgk", qg.float(),
                          k_cache.float()) / math.sqrt(d)
    if valid_mask.dim() == 1:
        valid_mask = valid_mask[None, :]
    scores = torch.where(valid_mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return o.reshape(b, hq, 1, d).to(q.dtype)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------
def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """x: (..., M); w1/w3: (M, F); w2: (F, M)."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2
