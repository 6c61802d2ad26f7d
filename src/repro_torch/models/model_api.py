"""Model API of the port: the config dataclass and the parameter-definition
machinery.  Twin of ``repro.models.model_api``.

Every model exposes:
  * ``param_defs()``      -- {name: ParamDef(shape, logical names, init)}
  * ``init(generator)``   -- concrete fp32 params on the generator's device
  * ``loss(params, batch)``              -- scalar loss + metrics
  * ``prefill(params, batch)``           -- logits + populated cache
  * ``decode_step(params, tokens, cache)`` -- one-token serve step
  * ``init_cache``                       -- decode cache

Parameters are a plain dict keyed by the JAX names, with layer parameters
stacked along a leading "layers" dim, so a dict carried across from the JAX
package (``convert.params_from_numpy``) is the port's own.  The logical axis
names of each ``ParamDef`` are kept for the ``parallel`` port;
``abstract_params`` waits for it (ROADMAP.md, Queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


def pad_to_multiple(n: int, multiple: int) -> int:
    """Round up (vocab padding), as ``repro.parallel.sharding`` does."""
    return int(math.ceil(n / multiple) * multiple)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # decoder | ssm | hybrid | encoder
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- attention ---
    window: int | None = None            # sliding-window size (None = full)
    global_layers: tuple = ()            # layer idxs with full attention (hybrid)
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0           # chatglm "2d" RoPE rotates half dims
    qkv_bias: bool = False
    causal: bool = True                  # encoders set False
    # --- SSM ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- misc ---
    norm_eps: float = 1e-5
    vocab_pad_multiple: int = 256
    tie_embeddings: bool = False
    frontend: str = "none"               # none | patch (vlm) | frames (audio)
    n_patches: int = 256                 # vlm stub patch count
    # --- execution knobs of the JAX package, kept so that configs carry
    # across unchanged; the port's eager decoder reads only ce_onehot and
    # logits_chunk (it raises above 1) ---
    remat: bool = True
    remat_policy: str = "nothing"
    attn_chunk: int = 1024
    dense_attn_max_seq: int = 1024
    scan_layers: bool = True
    logits_chunk: int = 0                # 0 = unchunked CE
    ce_onehot: bool = False
    ssd_shard_acts: bool = False
    swa_block_skip: bool = False
    swa_ring_buffer: bool = False
    shard_kv_seq: bool = True
    decode_no_fsdp: bool = False

    # -- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, self.vocab_pad_multiple)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


# ---------------------------------------------------------------------------
# Param definitions
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    names: tuple                 # logical axis names (for the parallel port)
    init: str = "normal"         # normal | zeros | ones
    scale: float = 0.02
    dtype: Any = torch.float32


def init_param(generator: torch.Generator, d: ParamDef) -> torch.Tensor:
    """One parameter on ``generator``'s device, drawn from ``generator``.
    The draws differ from ``jax.random``'s: parity tests carry the JAX
    package's parameters across instead (``convert.params_from_numpy``)."""
    dev = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=dev)
    if d.init == "normal":
        return (torch.randn(d.shape, generator=generator, device=dev)
                * d.scale).to(d.dtype)
    # the ssm inits (ssm_a, ssm_dt) come with the ssm models
    raise ValueError(f"unknown init {d.init!r}")


class BaseModel:
    """Shared init machinery."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # subclasses provide --------------------------------------------------
    def param_defs(self) -> dict:
        raise NotImplementedError

    def loss(self, params, batch):
        raise NotImplementedError

    # shared ----------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        """Every parameter, in sorted name order, drawn in turn from
        ``generator`` (seed it for a deterministic init)."""
        return {name: init_param(generator, d)
                for name, d in sorted(self.param_defs().items())}

    def param_count(self) -> int:
        return int(sum(math.prod(d.shape)
                       for d in self.param_defs().values()))
