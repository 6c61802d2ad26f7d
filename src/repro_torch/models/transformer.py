"""Decoder-only transformer LM of the port: the dense, MoE and VLM-backbone
decoders of the JAX package's zoo (llama3/3.2, chatglm3, minicpm, mixtral,
moonshot, internvl2's InternLM2), and the encoder (hubert) through
``causal=False``.  Twin of ``repro.models.transformer``.

Structure per layer (pre-norm):
    x += attn(rmsnorm(x))          # GQA + RoPE (+ optional SWA, qkv bias)
    x += ffn(rmsnorm(x))           # SwiGLU, or MoE top-k routed SwiGLU

Every norm runs the RMSNorm kernel and every prefill or forward attention
the flash-attention kernel, sliding windows included (``layers``); the
projections and the MoE dispatch are plain PyTorch, as the JAX package
leaves them to XLA.  The layers run in a Python loop over the stacked
parameters, where JAX scans; a training forward recomputes each layer in
the backward under ``cfg.remat`` (``layers.remat``), as JAX checkpoints
each.

Numerics follow JAX: activations are bf16 (the embedding is gathered from
the fp32 table, then cast), every weight matrix is cast to bf16 where it is
used, norm weights and the MoE router are read in fp32.  The casts are
``.to(bf16)``, which is free on a tensor that is bf16 already: ``bf16_copy``
casts the matrices once at load, with identical values, and the serving
paths pass that copy.

Caches follow JAX branch for branch: a sliding-window model whose prompt
reaches the window keeps a rolling W-slot cache (shifted each step, or a
ring buffer under ``swa_ring_buffer``); any other cache is padded to
``max_len`` and written at ``pos``.  A windowed model on that positional
cache decodes with full attention past the window, as the reference does
(ROADMAP.md, Queue 3, fault 5), and a positional cache padded to exactly W
slots is decoded as a rolling one, as the reference does too (fault 7).

Frontends: ``patch`` (internvl2) splices ``patch_embeds`` over the first
positions; ``frames`` (hubert's audio stub) takes the batch's precomputed
``frames`` (B, S, M) in place of token embeddings.
"""
from __future__ import annotations

import torch

from ..parallel.sharding import (constrain, replicate_as, roll_slots,
                                 write_slots)
from .layers import (apply_rope, attention, decode_attention, embed,
                     merge_heads, moe_ffn, remat, rmsnorm, split_heads,
                     swiglu)
from .losses import lm_cross_entropy
from .model_api import (BaseModel, ParamDef, cache_pos, cache_tensor,
                        split_params, unbound)

ACT_DTYPE = torch.bfloat16
# read in fp32 where used: the norm weights, and the router (layers.py:227)
_FP32 = ("final_norm.w", "layers.attn_norm.w", "layers.mlp_norm.w",
         "layers.moe.router")


class DecoderLM(BaseModel):
    """Dense / MoE / VLM-backbone decoder (and bidirectional encoder)."""

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
        }
        if cfg.qkv_bias:
            lyr["attn.bq"] = ParamDef((L, Hq * HD), ("layers", "heads"), init="zeros")
            lyr["attn.bk"] = ParamDef((L, Hkv * HD), ("layers", "kv_heads"), init="zeros")
            lyr["attn.bv"] = ParamDef((L, Hkv * HD), ("layers", "kv_heads"), init="zeros")
        if cfg.is_moe:
            E = cfg.n_experts
            lyr.update({
                "moe.router": ParamDef((L, M, E), ("layers", "embed", None)),
                "moe.experts.w1": ParamDef((L, E, M, F),
                                           ("layers", "expert", "embed", "ff")),
                "moe.experts.w3": ParamDef((L, E, M, F),
                                           ("layers", "expert", "embed", "ff")),
                "moe.experts.w2": ParamDef((L, E, F, M),
                                           ("layers", "expert", "ff", "embed")),
            })
        else:
            lyr.update({
                "mlp.w1": ParamDef((L, M, F), ("layers", "embed", "ff")),
                "mlp.w3": ParamDef((L, M, F), ("layers", "embed", "ff")),
                "mlp.w2": ParamDef((L, F, M), ("layers", "ff", "embed")),
            })
        defs.update({f"layers.{k}": v for k, v in lyr.items()})
        return defs

    @staticmethod
    def bf16_copy(params: dict) -> dict:
        """``params`` with every weight that JAX casts to bf16 at use
        (transformer.py:89-95, 115, 125-127, 144, 182; the experts at
        layers.py:265-267) cast once; the norm weights and the router stay
        as they are, since JAX reads them in fp32."""
        return {k: v if k in _FP32 else v.to(ACT_DTYPE)
                for k, v in params.items()}

    # ------------------------------------------------------------ forward --
    def _qkv(self, p: dict, h: torch.Tensor, positions: torch.Tensor,
             shard: bool = False):
        """Projections, biases and RoPE: q (B, Hq, S, HD), k and v
        (B, Hkv, S, HD); ``shard`` (the full-sequence layer) constrains q
        and k as the reference's layer does (transformer.py:101-102)."""
        cfg = self.cfg
        q = h @ p["attn.wq"].to(h.dtype)
        k = h @ p["attn.wk"].to(h.dtype)
        v = h @ p["attn.wv"].to(h.dtype)
        if cfg.qkv_bias:
            q = q + p["attn.bq"].to(h.dtype)
            k = k + p["attn.bk"].to(h.dtype)
            v = v + p["attn.bv"].to(h.dtype)
        q = split_heads(q, cfg.n_heads)
        k = split_heads(k, cfg.n_kv_heads)
        v = split_heads(v, cfg.n_kv_heads)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
        if shard:
            q = constrain(q, "batch", "seq", "act_heads", None)
            k = constrain(k, "batch", "seq", "act_heads", None)
        return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

    def _mlp(self, p: dict, x: torch.Tensor, group_tokens: int,
             no_fsdp: bool = False) -> torch.Tensor:
        """x + ffn(rmsnorm(x)); the MoE routes each batch row of
        ``group_tokens`` tokens at ``moe_capacity(group_tokens)``.
        ``no_fsdp`` (a decode step of a ``decode_no_fsdp`` model) replicates
        the token activations into the FFN and shards its output over the
        batch, in place of the FFN's own constraints (transformer.py:353-
        371)."""
        cfg = self.cfg
        h = rmsnorm(x, p["mlp_norm.w"], cfg.norm_eps)
        if no_fsdp:
            h = constrain(h, None, None, None)
        if cfg.is_moe:
            y = moe_ffn(h, p["moe.router"], p["moe.experts.w1"],
                        p["moe.experts.w3"], p["moe.experts.w2"],
                        n_experts=cfg.n_experts, top_k=cfg.experts_per_token,
                        capacity=cfg.moe_capacity(group_tokens),
                        shard_acts=not no_fsdp)
        else:
            y = swiglu(h, p["mlp.w1"].to(h.dtype), p["mlp.w3"].to(h.dtype),
                       p["mlp.w2"].to(h.dtype), shard_acts=not no_fsdp)
        if no_fsdp:
            y = constrain(y, "batch", None, None)
        return x + y

    def _layer(self, p: dict, x: torch.Tensor, *, positions: torch.Tensor):
        """One decoder layer (full-sequence path).  Returns (x, (k, v)), k and
        v (B, Hkv, S, HD) the layer's cache contribution."""
        cfg = self.cfg
        S = x.shape[1]
        h = rmsnorm(x, p["attn_norm.w"], cfg.norm_eps)
        qT, kT, vT = self._qkv(p, h, positions, shard=True)
        o = attention(qT, kT, vT, causal=cfg.causal, window=cfg.window,
                      dense_max_seq=cfg.dense_attn_max_seq,
                      chunk=cfg.attn_chunk, block_skip=cfg.swa_block_skip)
        o = merge_heads(o.transpose(1, 2))
        x = constrain(x + (o @ p["attn.wo"].to(o.dtype)),
                      "batch", "seq", "act_embed")
        x = constrain(self._mlp(p, x, S), "batch", "seq", "act_embed")
        return x, (kT, vT)

    def _head(self, top: dict) -> torch.Tensor:
        return top["embed.w"].T if self.cfg.tie_embeddings else top["head.w"]

    def _embed_inputs(self, top: dict, batch: dict) -> torch.Tensor:
        """bf16 token embeddings (B, S, M); under the ``patch`` frontend the
        batch's ``patch_embeds`` (B, P, M), where given, replace the first P
        positions; under ``frames`` the batch's ``frames`` (B, S, M) are the
        inputs (transformer.py:138-148)."""
        if self.cfg.frontend == "frames":
            return batch["frames"].to(ACT_DTYPE)
        x = embed(top["embed.w"], batch["tokens"]).to(ACT_DTYPE)
        if self.cfg.frontend == "patch" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(ACT_DTYPE)
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        return x

    def _backbone_inputs(self, params: dict, batch: dict):
        """(x as it enters the first layer, its positions, the stacked
        layer parameters)."""
        top, stacked = split_params(params)
        x = constrain(self._embed_inputs(top, batch),
                      "batch", "seq", "act_embed")
        positions = replicate_as(torch.arange(
            x.shape[1], dtype=torch.int32, device=x.device), x)
        return x, positions, stacked

    def _layers(self, params: dict, batch: dict):
        """Backbone over ``batch``'s inputs: yields (x, (k, v)) after each
        layer; ``x`` enters as ``_embed_inputs``."""
        x, positions, stacked = self._backbone_inputs(params, batch)
        for p in unbound(stacked):
            x, kv = self._layer(p, x, positions=positions)
            yield x, kv

    def _hidden(self, params: dict, batch: dict):
        """Backbone -> (final-normed hidden (B, S, M), LM head (M, V)).
        Under ``cfg.remat`` each layer runs under ``remat`` with
        ``cfg.remat_policy``, keeping its output and dropping its (k, v),
        as the reference's ``_hidden`` does (transformer.py:161-163)."""
        cfg = self.cfg
        x, positions, stacked = self._backbone_inputs(params, batch)

        def layer(p, x):
            return self._layer(p, x, positions=positions)[0]

        if cfg.remat:
            layer = remat(layer, cfg.remat_policy)
        for p in unbound(stacked):
            x = layer(p, x)
        top, _ = split_params(params)
        return rmsnorm(x, top["final_norm.w"], cfg.norm_eps), \
            self._head(top)

    def forward(self, params: dict, batch: dict) -> torch.Tensor:
        """Full-sequence forward -> logits (B, S, V)."""
        x, head = self._hidden(params, batch)
        return constrain(x @ head.to(x.dtype), "batch", "seq", "vocab")

    # --------------------------------------------------------------- loss --
    def loss(self, params: dict, batch: dict):
        cfg = self.cfg
        targets = batch["targets"]
        mask = None
        if cfg.frontend == "patch":  # VLM: patch positions carry no LM loss
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=targets.device)
            mask[:, :cfg.n_patches] = 0.0
            mask = replicate_as(mask, targets)
        if cfg.logits_chunk > 1:
            loss = self._chunked_ce(params, batch, targets, mask)
        else:
            loss = lm_cross_entropy(self.forward(params, batch), targets,
                                    onehot=cfg.ce_onehot, mask=mask)
        return loss, {"loss": loss,
                      "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}

    def _chunked_ce(self, params: dict, batch: dict, targets: torch.Tensor,
                    mask: torch.Tensor | None) -> torch.Tensor:
        """Cross-entropy over ``logits_chunk`` chunks of the sequence, one
        (B, S/K, V) logits chunk at a time: a loop where JAX scans
        (transformer.py:202-230), the same sums in the same order.  Under
        ``cfg.remat`` each chunk's logits and loss run under ``remat``, as
        the reference checkpoints each chunk (transformer.py:228-229), so
        that one chunk's logits are live in the backward too."""
        cfg = self.cfg
        x, head = self._hidden(params, batch)
        B, S, _ = x.shape
        K = cfg.logits_chunk
        if S % K:
            raise ValueError(f"seq {S} not divisible by logits_chunk {K}")
        cs = S // K
        headc = head.to(x.dtype)

        def chunk(xi, headc, ti, mi):
            return lm_cross_entropy(xi @ headc, ti, onehot=cfg.ce_onehot,
                                    mask=mi)

        if cfg.remat:
            chunk = remat(chunk)
        tot = cnt = replicate_as(torch.zeros((), dtype=torch.float32,
                                             device=x.device), x)
        for i in range(K):
            part = slice(i * cs, (i + 1) * cs)
            mi = (mask[:, part] if mask is not None else replicate_as(
                torch.ones((B, cs), dtype=torch.float32, device=x.device), x))
            nll = chunk(x[:, part], headc, targets[:, part], mi)
            tot = tot + nll * torch.clamp(mi.sum(), min=1.0)
            cnt = cnt + mi.sum()
        return tot / torch.clamp(cnt, min=1.0)

    # -------------------------------------------------------------- serve --
    def prefill(self, params: dict, batch: dict, max_len: int | None = None):
        """Returns (last-token logits (B, 1, V), KV cache); ``pos`` is the
        prompt length S.  A sliding-window model whose prompt reaches the
        window W keeps the last W positions (rolled by S % W under
        ``swa_ring_buffer``, so that position p sits at slot p % W); any
        other cache holds ``max_len`` positions (default S + 64), the prompt
        first, so that decode steps have room to insert
        (transformer.py:235-273)."""
        cfg = self.cfg
        W = cfg.window
        tokens = batch["tokens"]
        B, S = tokens.shape
        rolling = W is not None and S >= W
        length = W if rolling else max(max_len or S + 64, S)
        cache = self._empty_cache(B, length, tokens.device)
        x = None
        for i, (x, (k, v)) in enumerate(self._layers(params, batch)):
            if rolling:
                k, v = k[:, :, -W:], v[:, :, -W:]
                if cfg.swa_ring_buffer:
                    k = torch.roll(k, S % W, dims=2)
                    v = torch.roll(v, S % W, dims=2)
            write_slots(cache["k"], k, 0, layer=i)
            write_slots(cache["v"], v, 0, layer=i)
        top, _ = split_params(params)
        x = rmsnorm(x, top["final_norm.w"], cfg.norm_eps)
        logits = x[:, -1:] @ self._head(top).to(x.dtype)
        cache["pos"] = torch.tensor(S, dtype=torch.int32)
        return logits, cache

    def _empty_cache(self, batch_size: int, length: int, device) -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, length, cfg.hd)
        names = ("layers", "batch", "kv_heads",
                 "kv_seq" if cfg.shard_kv_seq else None, None)
        return {"k": cache_tensor(shape, names, ACT_DTYPE, device),
                "v": cache_tensor(shape, names, ACT_DTYPE, device),
                "pos": cache_pos(device)}

    def init_cache(self, batch_size: int, max_len: int, *, device) -> dict:
        """An empty cache: ``k``, ``v`` (L, B, Hkv, eff, HD) bf16 on
        ``device``, eff = min(max_len, window) (transformer.py:276-290);
        ``pos`` a 0-dim int32 on the CPU (``cache_pos``).  On ``"meta"`` an
        abstract cache, sharded by the names of JAX's abstract one."""
        W = self.cfg.window
        eff = min(max_len, W) if W else max_len
        return self._empty_cache(batch_size, eff, device)

    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict):
        """One-token decode.  tokens: (B, 1).  Functional, as JAX's
        ``dynamic_update_slice`` is: returns the logits (B, 1, V) and a new
        cache, and leaves ``cache`` as it was, so that several threads may
        step from one cache at once.

        The cache is rolling when the model has a window W and the cache W
        slots (transformer.py:306-346): a ring buffer writes slot pos % W
        and sees the slots holding positions in (pos - W, pos]; otherwise
        the slots shift left by one, the new entry goes last and the last
        min(pos + 1, W) are seen.  Any other cache is written at ``pos`` and
        sees slots 0..pos, with no window (fault 5, ROADMAP.md Queue 3), and
        raises where it has no room (JAX clamps the write onto the last slot
        instead: fault 3)."""
        cfg = self.cfg
        top, stacked = split_params(params)
        pos = int(cache["pos"])
        eff = cache["k"].shape[3]
        rolling = cfg.window is not None and eff == cfg.window
        x = embed(top["embed.w"], tokens).to(ACT_DTYPE)
        dev = x.device
        slots = replicate_as(torch.arange(eff, device=dev), x)
        if rolling and cfg.swa_ring_buffer:
            at = pos % eff
            valid = pos - torch.remainder(pos - slots, eff) >= 0
            new_k, new_v = cache["k"].clone(), cache["v"].clone()
        elif rolling:
            at = eff - 1
            valid = slots >= eff - min(pos + 1, eff)
            new_k = roll_slots(cache["k"], 3)
            new_v = roll_slots(cache["v"], 3)
        else:
            if not 0 <= pos < eff:
                raise ValueError(f"decode at position {pos} past the "
                                 f"cache's {eff} slots")
            at = pos
            valid = slots <= pos
            new_k, new_v = cache["k"].clone(), cache["v"].clone()
        positions = replicate_as(
            torch.full((1,), pos, dtype=torch.int32, device=dev), x)
        for i in range(cfg.n_layers):
            p = {k: v[i] for k, v in stacked.items()}
            h = rmsnorm(x, p["attn_norm.w"], cfg.norm_eps)
            qT, kT, vT = self._qkv(p, h, positions)
            write_slots(new_k, kT, at, layer=i)
            write_slots(new_v, vT, at, layer=i)
            o = decode_attention(qT, new_k[i], new_v[i], valid_mask=valid)
            o = merge_heads(o.transpose(1, 2))
            x = x + o @ p["attn.wo"].to(o.dtype)
            x = self._mlp(p, x, 1, no_fsdp=cfg.decode_no_fsdp)
        x = rmsnorm(x, top["final_norm.w"], cfg.norm_eps)
        logits = x @ self._head(top).to(x.dtype)
        return logits, {"k": new_k, "v": new_v,
                        "pos": torch.tensor(pos + 1, dtype=torch.int32)}
