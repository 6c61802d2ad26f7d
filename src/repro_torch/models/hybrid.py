"""Hymba-style hybrid-head model (arXiv:2411.13676) of the port.  Twin of
``repro.models.hybrid``.

Every layer runs attention heads and Mamba/SSD heads in parallel on one
norm of its input and fuses their RMS-normalised outputs, each scaled by a
learnable per-dim ``beta``.  Most layers attend within a sliding window;
``cfg.global_layers`` (0, 15 and 31 of hymba-1.5b's 32) attend to every
earlier position.  Meta-tokens and cross-layer KV sharing are left out, as
in the reference.

Every norm (four a layer and the final one) runs the RMSNorm kernel and
every prefill or forward attention the flash-attention kernel, windowed
where the layer is; the SSM branch is ``mamba2``'s plain PyTorch, and the
projections, the SwiGLU and the decode attention are plain PyTorch, as the
JAX package leaves them to XLA.  Numerics follow JAX as in ``mamba2``: bf16
activations, the matrices, conv weights and ``beta`` scales cast to bf16
where used (``bf16_copy`` casts them once), the norm weights and the SSD's
scalars read in fp32.

Caches follow JAX branch for branch (hybrid.py:168-326): a tuple of K and a
tuple of V, one (B, Hkv, len, HD) bf16 tensor a layer, of another length
for a windowed and a global layer.  A windowed layer whose prompt reaches
the window W keeps the last W positions and rolls (shifted left one slot a
step).  Any other layer's cache is padded to ``max_len`` and written at
``pos``; a windowed layer there attends past the window, as in the decoder
(fault 5).  A padded cache whose length equals W is taken as rolling by
``decode_step``, which then shifts out a real token and keeps the padding
(ROADMAP.md, Queue 3, fault 7): the port follows the reference there too.
"""
from __future__ import annotations

import torch

from ..parallel.sharding import (constrain, replicate_as, shift_in,
                                 write_slots)
from .layers import (apply_rope, attention, decode_attention, embed,
                     merge_heads, remat, rmsnorm, split_heads, swiglu)
from .losses import lm_cross_entropy
from .mamba2 import (CONV_NAMES, SSD_NAMES, ssm_branch_full,
                     ssm_branch_step, stacked_states)
from .model_api import (BaseModel, ParamDef, cache_pos, cache_tensor,
                        split_params, unbound)

ACT_DTYPE = torch.bfloat16
# read in fp32 where used: the norm weights and the SSD's scalars a head
_FP32 = ("final_norm.w", "layers.norm.w", "layers.mlp_norm.w",
         "layers.fuse.attn_norm", "layers.fuse.ssm_norm", "layers.ssm.a_log",
         "layers.ssm.d_skip", "layers.ssm.dt_bias")
KV_NAMES = ("batch", "kv_heads", "kv_seq", None)  # a layer's K or V


class HymbaLM(BaseModel):
    """Parallel attention and SSM heads a layer (hymba-1.5b)."""

    # ------------------------------------------------------------ params --
    def param_defs(self) -> dict:
        cfg = self.cfg
        L, M, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
        HD, Hq, Hkv, F = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
        DI, N = cfg.d_inner_hybrid, cfg.ssm_state
        conv_dim = DI + 2 * N
        H = DI // cfg.ssm_head_dim
        lyr = {
            "norm.w": ParamDef((L, M), ("layers", None), init="ones"),
            # attention branch
            "attn.wq": ParamDef((L, M, Hq * HD), ("layers", "embed", "heads")),
            "attn.wk": ParamDef((L, M, Hkv * HD),
                                ("layers", "embed", "kv_heads")),
            "attn.wv": ParamDef((L, M, Hkv * HD),
                                ("layers", "embed", "kv_heads")),
            # ssm branch
            "ssm.in_proj": ParamDef((L, M, 2 * DI + 2 * N + H),
                                    ("layers", "embed", "ff")),
            "ssm.conv.w": ParamDef((L, cfg.ssm_conv, conv_dim),
                                   ("layers", None, "ff")),
            "ssm.conv.b": ParamDef((L, conv_dim), ("layers", "ff"),
                                   init="zeros"),
            "ssm.a_log": ParamDef((L, H), ("layers", None), init="ssm_a"),
            "ssm.d_skip": ParamDef((L, H), ("layers", None), init="ones"),
            "ssm.dt_bias": ParamDef((L, H), ("layers", None), init="ssm_dt"),
            # fusion and output
            "fuse.attn_norm": ParamDef((L, Hq * HD), ("layers", None),
                                       init="ones"),
            "fuse.ssm_norm": ParamDef((L, DI), ("layers", None), init="ones"),
            "fuse.beta_attn": ParamDef((L, Hq * HD), ("layers", None),
                                       init="ones"),
            "fuse.beta_ssm": ParamDef((L, DI), ("layers", None), init="ones"),
            "attn.wo": ParamDef((L, Hq * HD, M), ("layers", "heads", "embed")),
            # mlp
            "mlp_norm.w": ParamDef((L, M), ("layers", None), init="ones"),
            "mlp.w1": ParamDef((L, M, F), ("layers", "embed", "ff")),
            "mlp.w3": ParamDef((L, M, F), ("layers", "embed", "ff")),
            "mlp.w2": ParamDef((L, F, M), ("layers", "ff", "embed")),
        }
        defs = {
            "embed.w": ParamDef((V, M), ("vocab", "embed")),
            "final_norm.w": ParamDef((M,), (None,), init="ones"),
            "head.w": ParamDef((M, V), ("embed", "vocab")),
        }
        defs.update({f"layers.{k}": v for k, v in lyr.items()})
        return defs

    @staticmethod
    def bf16_copy(params: dict) -> dict:
        """``params`` with every weight that JAX casts to bf16 at use
        (hybrid.py:85-145, 194-226) cast once; the norm weights,
        ``a_log``, ``dt_bias`` and ``d_skip`` stay fp32."""
        return {k: v if k in _FP32 else v.to(ACT_DTYPE)
                for k, v in params.items()}

    def window(self, layer: int) -> int | None:
        """The attention window of layer ``layer``: None for a global one."""
        cfg = self.cfg
        return None if layer in cfg.global_layers else cfg.window

    def _branch_kw(self) -> dict:
        cfg = self.cfg
        return dict(d_inner=cfg.d_inner_hybrid, n=cfg.ssm_state,
                    head_dim=cfg.ssm_head_dim)

    # ------------------------------------------------------------- layer --
    def _qkv(self, p: dict, h: torch.Tensor, positions: torch.Tensor):
        """q (B, Hq, S, HD), k and v (B, Hkv, S, HD), RoPE'd."""
        cfg = self.cfg
        q = split_heads(h @ p["attn.wq"].to(h.dtype), cfg.n_heads)
        k = split_heads(h @ p["attn.wk"].to(h.dtype), cfg.n_kv_heads)
        v = split_heads(h @ p["attn.wv"].to(h.dtype), cfg.n_kv_heads)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def _fuse_out(self, p: dict, x: torch.Tensor, attn_out: torch.Tensor,
                  ssm_out: torch.Tensor) -> torch.Tensor:
        """x + wo(the fused branches), then + the SwiGLU of its norm
        (hybrid.py:113-134)."""
        cfg = self.cfg
        a = rmsnorm(attn_out, p["fuse.attn_norm"], cfg.norm_eps)
        s = rmsnorm(ssm_out, p["fuse.ssm_norm"], cfg.norm_eps)
        a = a * p["fuse.beta_attn"].to(a.dtype)
        s = s * p["fuse.beta_ssm"].to(s.dtype)
        fused = 0.5 * (a + s)
        x = constrain(x + fused @ p["attn.wo"].to(fused.dtype),
                      "batch", "seq", "act_embed")
        h2 = rmsnorm(x, p["mlp_norm.w"], cfg.norm_eps)
        return x + swiglu(h2, p["mlp.w1"].to(h2.dtype),
                          p["mlp.w3"].to(h2.dtype), p["mlp.w2"].to(h2.dtype))

    def _ssm_kw(self, p: dict) -> dict:
        return dict(in_proj=p["ssm.in_proj"], conv_w=p["ssm.conv.w"],
                    conv_b=p["ssm.conv.b"], a_log=p["ssm.a_log"],
                    dt_bias=p["ssm.dt_bias"], d_skip=p["ssm.d_skip"],
                    **self._branch_kw())

    def _layer_full(self, p: dict, x: torch.Tensor, positions: torch.Tensor,
                    window: int | None):
        """One layer over the whole sequence: (x, ((k, v), (conv state,
        SSD state)))."""
        cfg = self.cfg
        h = rmsnorm(x, p["norm.w"], cfg.norm_eps)
        qT, kT, vT = self._qkv(p, h, positions)
        o = attention(qT, kT, vT, causal=True, window=window,
                      dense_max_seq=cfg.dense_attn_max_seq,
                      chunk=cfg.attn_chunk, block_skip=cfg.swa_block_skip)
        attn_out = merge_heads(o.transpose(1, 2))
        ssm_out, state = ssm_branch_full(h, chunk=cfg.ssm_chunk,
                                         shard_acts=cfg.ssd_shard_acts,
                                         **self._ssm_kw(p))
        x = constrain(self._fuse_out(p, x, attn_out, ssm_out),
                      "batch", "seq", "act_embed")
        return x, ((kT, vT), state)

    def _layers(self, params: dict, tokens: torch.Tensor):
        """Backbone over ``tokens``: yields (layer, x, (kv, state)) after
        each layer."""
        x, positions, stacked = self._backbone_inputs(params, tokens)
        for i, p in enumerate(unbound(stacked)):
            x, kv_state = self._layer_full(p, x, positions, self.window(i))
            yield i, x, kv_state

    def _backbone_inputs(self, params: dict, tokens: torch.Tensor):
        """(the embeddings, their positions, the stacked layer
        parameters)."""
        _, stacked = split_params(params)
        x = embed(params["embed.w"], tokens).to(ACT_DTYPE)
        positions = replicate_as(torch.arange(
            x.shape[1], dtype=torch.int32, device=x.device), x)
        return x, positions, stacked

    def _head(self, params: dict, x: torch.Tensor, last: bool = False
              ) -> torch.Tensor:
        """Final norm and LM head; ``last``: the head of the last position
        alone (the norm runs over every position first, as in JAX)."""
        x = rmsnorm(x, params["final_norm.w"], self.cfg.norm_eps)
        if last:
            x = x[:, -1:]
        return x @ params["head.w"].to(x.dtype)

    # ----------------------------------------------------------- forward --
    def forward(self, params: dict, batch: dict) -> torch.Tensor:
        """Full-sequence forward -> logits (B, S, V).  Under ``cfg.remat``
        each layer runs under ``remat``, policy ``"nothing"`` whatever
        ``remat_policy`` says, as the reference's forward does
        (hybrid.py:160-162)."""
        x, positions, stacked = self._backbone_inputs(params,
                                                      batch["tokens"])
        for i, p in enumerate(unbound(stacked)):
            def layer(p, x, window=self.window(i)):
                return self._layer_full(p, x, positions, window)[0]

            if self.cfg.remat:
                layer = remat(layer)
            x = layer(p, x)
        return constrain(self._head(params, x), "batch", "seq", "vocab")

    def loss(self, params: dict, batch: dict):
        loss = lm_cross_entropy(self.forward(params, batch),
                                batch["targets"], onehot=self.cfg.ce_onehot)
        return loss, {"loss": loss}

    # ------------------------------------------------------------- serve --
    def init_cache(self, batch_size: int, max_len: int, *, device
                   ) -> dict:
        """An empty cache (hybrid.py:168-203): ``k``, ``v`` tuples of
        (B, Hkv, eff, HD) bf16 a layer, eff = max_len for a global layer
        and min(max_len, W) for a windowed one; ``conv`` and ``ssd`` as
        mamba2's; ``pos`` a 0-dim int32 on the CPU.  On ``"meta"`` an
        abstract cache, sharded by JAX's names."""
        cfg = self.cfg
        DI, N, P = cfg.d_inner_hybrid, cfg.ssm_state, cfg.ssm_head_dim
        ks, vs = [], []
        for i in range(cfg.n_layers):
            win = self.window(i)
            eff = max_len if win is None else min(max_len, win)
            shape = (batch_size, cfg.n_kv_heads, eff, cfg.hd)
            ks.append(cache_tensor(shape, KV_NAMES, ACT_DTYPE, device))
            vs.append(cache_tensor(shape, KV_NAMES, ACT_DTYPE, device))
        return {
            "k": tuple(ks), "v": tuple(vs),
            "conv": cache_tensor(
                (cfg.n_layers, batch_size, cfg.ssm_conv - 1, DI + 2 * N),
                CONV_NAMES, ACT_DTYPE, device),
            "ssd": cache_tensor((cfg.n_layers, batch_size, DI // P, N, P),
                                SSD_NAMES, torch.float32, device),
            "pos": cache_pos(device)}

    def prefill(self, params: dict, batch: dict, max_len: int | None = None):
        """(last-token logits (B, 1, V), cache), ``pos`` the prompt length S
        (hybrid.py:198-227).  A windowed layer whose prompt reaches its
        window W keeps the last W positions; any other layer's K and V are
        padded with zeros to ``max_len`` (default S + 64) where that is
        longer than S."""
        tokens = batch["tokens"]
        S = tokens.shape[1]
        max_len = max_len or S + 64
        ks, vs, convs, ssds = [], [], [], []
        x = None
        for i, x, ((k, v), (conv, ssd)) in self._layers(params, tokens):
            win = self.window(i)
            if win is not None and S >= win:
                k, v = k[:, :, -win:], v[:, :, -win:]
            elif max_len > S:
                pad = (0, 0, 0, max_len - S)
                k = torch.nn.functional.pad(k, pad)
                v = torch.nn.functional.pad(v, pad)
            ks.append(constrain(k.contiguous(), *KV_NAMES))
            vs.append(constrain(v.contiguous(), *KV_NAMES))
            convs.append(conv)
            ssds.append(ssd)
        logits = self._head(params, x, last=True)
        return logits, {"k": tuple(ks), "v": tuple(vs),
                        **stacked_states(convs, ssds),
                        "pos": torch.tensor(S, dtype=torch.int32)}

    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict):
        """One-token decode, tokens (B, 1) -> (logits (B, 1, V), a new
        cache); ``cache`` is left as it was (hybrid.py:242-319).

        A windowed layer whose cache has W slots rolls: the slots shift
        left by one, the new entry goes last, and the last min(pos + 1, W)
        are seen.  Any other cache is written at ``pos`` and sees slots
        0..pos, and raises where it has no room (JAX clamps the write onto
        the last slot instead: fault 3)."""
        cfg = self.cfg
        top, stacked = split_params(params)
        pos = int(cache["pos"])
        x = embed(top["embed.w"], tokens).to(ACT_DTYPE)     # (B, 1, M)
        positions = replicate_as(
            torch.full((1,), pos, dtype=torch.int32, device=x.device), x)
        new_k, new_v, convs, ssds = [], [], [], []
        for i, p in enumerate(unbound(stacked)):
            win = self.window(i)
            h = rmsnorm(x, p["norm.w"], cfg.norm_eps)
            qT, kT, vT = self._qkv(p, h, positions)
            k_c, v_c = cache["k"][i], cache["v"][i]
            eff = k_c.shape[2]
            slots = replicate_as(torch.arange(eff, device=x.device), x)
            if win is not None and eff == win:
                k_c, v_c = shift_in(k_c, kT), shift_in(v_c, vT)
                valid = slots >= eff - min(pos + 1, eff)
            else:
                if not 0 <= pos < eff:
                    raise ValueError(f"decode at position {pos} past layer "
                                     f"{i}'s {eff} cache slots")
                k_c, v_c = k_c.clone(), v_c.clone()
                write_slots(k_c, kT, pos)
                write_slots(v_c, vT, pos)
                valid = slots <= pos
            o = decode_attention(qT, k_c, v_c, valid_mask=valid)
            attn_out = merge_heads(o.transpose(1, 2))
            y, (conv, ssd) = ssm_branch_step(h[:, 0], cache["conv"][i],
                                             cache["ssd"][i],
                                             **self._ssm_kw(p))
            x = self._fuse_out(p, x, attn_out, y[:, None, :])
            new_k.append(constrain(k_c, *KV_NAMES))
            new_v.append(constrain(v_c, *KV_NAMES))
            convs.append(conv)
            ssds.append(ssd)
        logits = self._head(top, x)
        return logits, {"k": tuple(new_k), "v": tuple(new_v),
                        **stacked_states(convs, ssds),
                        "pos": torch.tensor(pos + 1, dtype=torch.int32)}
