"""Decoder-only transformer LM of the port: the dense decoders of the JAX
package's zoo (llama3/3.2, chatglm3, minicpm).  Twin of
``repro.models.transformer``.

Structure per layer (pre-norm):
    x += attn(rmsnorm(x))          # GQA + RoPE (+ optional qkv bias)
    x += swiglu(rmsnorm(x))

Every norm runs the RMSNorm kernel and every prefill or forward attention
the flash-attention kernel (``layers``); the projections are plain
``torch.matmul``, as the JAX package leaves them to XLA.  The layers run in
a Python loop over the stacked parameters, where JAX scans.

Numerics follow JAX: activations are bf16 (the embedding is gathered from
the fp32 table, then cast), every weight matrix is cast to bf16 where it is
used, norm weights are read in fp32.  The casts are ``.to(bf16)``, which is
free on a tensor that is bf16 already: ``bf16_copy`` casts the matrices once
at load, with identical values, and the serving paths pass that copy.

Scope: dense decoders with full causal attention over token inputs.  MoE
dispatch, a sliding ``window`` (its rolling and ring-buffer caches), the
patch and frame frontends, bidirectional encoders and ``logits_chunk > 1``
raise ``NotImplementedError`` (ROADMAP.md, Queue 1 item 3).
"""
from __future__ import annotations

import torch

from .layers import apply_rope, attention, decode_attention, rmsnorm, swiglu
from .losses import lm_cross_entropy
from .model_api import BaseModel, ModelConfig, ParamDef

ACT_DTYPE = torch.bfloat16
_NORMS = ("final_norm.w", "layers.attn_norm.w", "layers.mlp_norm.w")


def _unsupported(cfg: ModelConfig) -> str | None:
    if cfg.is_moe:
        return "MoE dispatch"
    if cfg.window is not None:
        return "a sliding window (rolling and ring-buffer caches)"
    if cfg.frontend != "none":
        return f"the {cfg.frontend!r} frontend"
    if not cfg.causal:
        return "bidirectional (encoder) attention"
    if cfg.logits_chunk > 1:
        return "sequence-chunked cross-entropy (logits_chunk > 1)"
    return None


class DecoderLM(BaseModel):
    """Dense decoder with full causal attention."""

    def __init__(self, cfg: ModelConfig):
        what = _unsupported(cfg)
        if what is not None:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet (ROADMAP.md, Queue 1 "
                f"item 3)")
        super().__init__(cfg)

    # ------------------------------------------------------------- params --
    def param_defs(self) -> dict:
        cfg = self.cfg
        L, M, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
        HD, Hq, Hkv, F = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
        defs: dict[str, ParamDef] = {
            "embed.w": ParamDef((V, M), ("vocab", "embed")),
            "final_norm.w": ParamDef((M,), (None,), init="ones"),
        }
        if not cfg.tie_embeddings:
            defs["head.w"] = ParamDef((M, V), ("embed", "vocab"))
        lyr = {
            "attn_norm.w": ParamDef((L, M), ("layers", None), init="ones"),
            "attn.wq": ParamDef((L, M, Hq * HD), ("layers", "embed", "heads")),
            "attn.wk": ParamDef((L, M, Hkv * HD), ("layers", "embed", "kv_heads")),
            "attn.wv": ParamDef((L, M, Hkv * HD), ("layers", "embed", "kv_heads")),
            "attn.wo": ParamDef((L, Hq * HD, M), ("layers", "heads", "embed")),
            "mlp_norm.w": ParamDef((L, M), ("layers", None), init="ones"),
            "mlp.w1": ParamDef((L, M, F), ("layers", "embed", "ff")),
            "mlp.w3": ParamDef((L, M, F), ("layers", "embed", "ff")),
            "mlp.w2": ParamDef((L, F, M), ("layers", "ff", "embed")),
        }
        if cfg.qkv_bias:
            lyr["attn.bq"] = ParamDef((L, Hq * HD), ("layers", "heads"), init="zeros")
            lyr["attn.bk"] = ParamDef((L, Hkv * HD), ("layers", "kv_heads"), init="zeros")
            lyr["attn.bv"] = ParamDef((L, Hkv * HD), ("layers", "kv_heads"), init="zeros")
        defs.update({f"layers.{k}": v for k, v in lyr.items()})
        return defs

    @staticmethod
    def bf16_copy(params: dict) -> dict:
        """``params`` with every weight that JAX casts to bf16 at use
        (transformer.py:89-95, 115, 125-127, 144, 182) cast once; the
        norm weights stay as they are, since rmsnorm reads them in fp32."""
        return {k: v if k in _NORMS else v.to(ACT_DTYPE)
                for k, v in params.items()}

    # ------------------------------------------------------------ forward --
    def _qkv(self, p: dict, h: torch.Tensor, positions: torch.Tensor):
        """Projections, biases and RoPE: q (B, Hq, S, HD), k and v
        (B, Hkv, S, HD)."""
        cfg = self.cfg
        B, S, _ = h.shape
        q = h @ p["attn.wq"].to(h.dtype)
        k = h @ p["attn.wk"].to(h.dtype)
        v = h @ p["attn.wv"].to(h.dtype)
        if cfg.qkv_bias:
            q = q + p["attn.bq"].to(h.dtype)
            k = k + p["attn.bk"].to(h.dtype)
            v = v + p["attn.bv"].to(h.dtype)
        q = q.reshape(B, S, cfg.n_heads, cfg.hd)
        k = k.reshape(B, S, cfg.n_kv_heads, cfg.hd)
        v = v.reshape(B, S, cfg.n_kv_heads, cfg.hd)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
        return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

    def _mlp(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(x, p["mlp_norm.w"], self.cfg.norm_eps)
        return x + swiglu(h, p["mlp.w1"].to(h.dtype), p["mlp.w3"].to(h.dtype),
                          p["mlp.w2"].to(h.dtype))

    def _layer(self, p: dict, x: torch.Tensor, *, positions: torch.Tensor):
        """One decoder layer (full-sequence path).  Returns (x, (k, v)), k and
        v (B, Hkv, S, HD) the layer's cache contribution."""
        cfg = self.cfg
        B, S, _ = x.shape
        h = rmsnorm(x, p["attn_norm.w"], cfg.norm_eps)
        qT, kT, vT = self._qkv(p, h, positions)
        o = attention(qT, kT, vT)
        o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
        x = x + (o @ p["attn.wo"].to(o.dtype))
        return self._mlp(p, x), (kT, vT)

    @staticmethod
    def _split_params(params: dict) -> tuple[dict, dict]:
        stacked = {k[len("layers."):]: v for k, v in params.items()
                   if k.startswith("layers.")}
        top = {k: v for k, v in params.items() if not k.startswith("layers.")}
        return top, stacked

    def _head(self, top: dict) -> torch.Tensor:
        return top["embed.w"].T if self.cfg.tie_embeddings else top["head.w"]

    def _layers(self, params: dict, tokens: torch.Tensor):
        """Backbone over ``tokens`` (B, S): yields (x, (k, v)) after each
        layer; ``x`` enters as the bf16 embedding."""
        top, stacked = self._split_params(params)
        x = top["embed.w"][tokens].to(ACT_DTYPE)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=x.device)
        for i in range(self.cfg.n_layers):
            x, kv = self._layer({k: v[i] for k, v in stacked.items()}, x,
                                positions=positions)
            yield x, kv

    def forward(self, params: dict, batch: dict) -> torch.Tensor:
        """Full-sequence forward -> logits (B, S, V)."""
        x = None
        for x, _ in self._layers(params, batch["tokens"]):
            pass
        top, _ = self._split_params(params)
        x = rmsnorm(x, top["final_norm.w"], self.cfg.norm_eps)
        return x @ self._head(top).to(x.dtype)

    # --------------------------------------------------------------- loss --
    def loss(self, params: dict, batch: dict):
        logits = self.forward(params, batch)
        loss = lm_cross_entropy(logits, batch["targets"],
                                onehot=self.cfg.ce_onehot)
        return loss, {"loss": loss,
                      "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}

    # -------------------------------------------------------------- serve --
    def prefill(self, params: dict, batch: dict, max_len: int | None = None):
        """Returns (last-token logits (B, 1, V), KV cache).  The cache holds
        ``max_len`` positions (default prompt + 64) so that decode steps have
        room to insert; ``pos`` is the prompt length."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        max_len = max(max_len or S + 64, S)
        cache = self.init_cache(B, max_len, device=tokens.device)
        x = None
        for i, (x, (k, v)) in enumerate(self._layers(params, tokens)):
            cache["k"][i, :, :, :S] = k
            cache["v"][i, :, :, :S] = v
        top, _ = self._split_params(params)
        x = rmsnorm(x, top["final_norm.w"], cfg.norm_eps)
        logits = x[:, -1:] @ self._head(top).to(x.dtype)
        cache["pos"] = torch.tensor(S, dtype=torch.int32)
        return logits, cache

    def init_cache(self, batch_size: int, max_len: int, device="cpu") -> dict:
        """An empty cache: ``k``, ``v`` (L, B, Hkv, max_len, HD) bf16 on
        ``device``; ``pos``, the next position to write, a 0-dim int32 on
        the CPU (the host reads it to index, so keeping it there spares a
        device sync per step)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_len, cfg.hd)
        return {"k": torch.zeros(shape, dtype=ACT_DTYPE, device=device),
                "v": torch.zeros(shape, dtype=ACT_DTYPE, device=device),
                "pos": torch.zeros((), dtype=torch.int32)}

    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict):
        """One-token decode.  tokens: (B, 1).  Functional, as JAX's
        ``dynamic_update_slice`` is: returns the logits (B, 1, V) and a new
        cache, and leaves ``cache`` as it was, so that several threads may
        step from one cache at once.  Raises where the cache has no room
        (JAX clamps the write onto the last slot instead: ROADMAP.md,
        Queue 3)."""
        cfg = self.cfg
        top, stacked = self._split_params(params)
        pos = int(cache["pos"])
        eff = cache["k"].shape[3]
        if not 0 <= pos < eff:
            raise ValueError(f"decode at position {pos} past the cache's "
                             f"{eff} slots")
        B = tokens.shape[0]
        x = top["embed.w"][tokens].to(ACT_DTYPE)
        positions = torch.full((1,), pos, dtype=torch.int32,
                               device=x.device)
        valid = torch.arange(eff, device=x.device) <= pos
        new_k, new_v = cache["k"].clone(), cache["v"].clone()
        for i in range(cfg.n_layers):
            p = {k: v[i] for k, v in stacked.items()}
            h = rmsnorm(x, p["attn_norm.w"], cfg.norm_eps)
            qT, kT, vT = self._qkv(p, h, positions)
            new_k[i, :, :, pos] = kT[:, :, 0]
            new_v[i, :, :, pos] = vT[:, :, 0]
            o = decode_attention(qT, new_k[i], new_v[i], valid_mask=valid)
            o = o.transpose(1, 2).reshape(B, 1, cfg.n_heads * cfg.hd)
            x = x + o @ p["attn.wo"].to(o.dtype)
            x = self._mlp(p, x)
        x = rmsnorm(x, top["final_norm.w"], cfg.norm_eps)
        logits = x @ self._head(top).to(x.dtype)
        return logits, {"k": new_k, "v": new_v,
                        "pos": torch.tensor(pos + 1, dtype=torch.int32)}
