"""Model API of the port: the config dataclass and the parameter-definition
machinery.  Twin of ``repro.models.model_api``.

Every model exposes:
  * ``param_defs()``      -- {name: ParamDef(shape, logical names, init)}
  * ``init(generator)``   -- concrete fp32 params on the generator's device
  * ``abstract_params()`` -- meta tensors, DTensors with the placements of
                             their logical names under a mesh context
  * ``loss(params, batch)``              -- scalar loss + metrics
  * ``prefill(params, batch)``           -- logits + populated cache
  * ``decode_step(params, tokens, cache)`` -- one-token serve step
  * ``init_cache(..., device=)``         -- decode cache (``"meta"``:
                                            abstract, as ``abstract_params``)

Parameters are a plain dict keyed by the JAX names, with layer parameters
stacked along a leading "layers" dim, so a dict carried across from the JAX
package (``convert.params_from_numpy``) is the port's own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..parallel.sharding import (abstract_tensor, logical_sharding,
                                 pad_to_multiple, place)


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
    # across unchanged; the port reads remat and remat_policy (the training
    # forwards' recompute, layers.remat), ce_onehot (on a mesh True is
    # the vocab-parallel loss: losses.lm_cross_entropy), logits_chunk,
    # attn_chunk, dense_attn_max_seq and swa_block_skip (the q-chunked and
    # block-skipping attention of layers.attention), swa_ring_buffer,
    # ssd_shard_acts, shard_kv_seq and decode_no_fsdp; no model of it
    # reads scan_layers, XLA's layer scan (launch.dryrun.NO_EFFECT) ---
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

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def d_inner_hybrid(self) -> int:
        """Hybrid (hymba) SSM branch width == attention branch width, so the
        normalized branch outputs fuse elementwise."""
        return self.n_heads * self.hd

    def moe_capacity(self, group_tokens: int) -> int:
        """Slots an expert has for a group (one batch row) of
        ``group_tokens`` tokens: their share of the top-k assignments times
        ``capacity_factor``, rounded up to a multiple of 8, at least 8."""
        c = math.ceil(group_tokens * self.experts_per_token *
                      self.capacity_factor / self.n_experts)
        return max(8, pad_to_multiple(c, 8))


# ---------------------------------------------------------------------------
# Param definitions
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    names: tuple                 # logical axis names (see parallel.sharding)
    init: str = "normal"         # normal | zeros | ones | ssm_a | ssm_dt
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
    if d.init in SSM_INITS:
        lo, hi = SSM_INITS[d.init]
        u = torch.rand(d.shape, generator=generator, device=dev) \
            * (hi - lo) + lo
        return ssm_init(d.init, u).to(d.dtype)
    raise ValueError(f"unknown init {d.init!r}")


# the ssm inits (model_api.py:147-152): a uniform draw on [lo, hi), mapped
# to mamba's A_log = log(u) or its dt bias = softplus^-1(u)
SSM_INITS = {"ssm_a": (1.0, 16.0), "ssm_dt": (1e-3, 1e-1)}


def ssm_init(init: str, u):
    """``init``'s map of uniform draws ``u`` (a tensor or a numpy array)."""
    lib = torch if isinstance(u, torch.Tensor) else np
    return lib.log(u) if init == "ssm_a" else lib.log(lib.expm1(u))


def cache_tensor(shape: tuple, names: tuple, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """One decode-cache tensor: zeros on ``device``, or on ``"meta"`` an
    abstract one, both laid out by ``logical_sharding(shape, names)`` under
    a mesh, as JAX's caches are: a concrete one is then a DTensor of zeros
    on the mesh's device, each rank holding its own shard."""
    sharding = logical_sharding(shape, names)
    if torch.device(device).type == "meta":
        return abstract_tensor(shape, dtype, sharding)
    if sharding is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import zeros

    mesh, pls = sharding
    if torch.device(device).type != mesh.device_type:
        raise ValueError(f"a cache on {device} under a mesh of "
                         f"{mesh.device_type} devices")
    return zeros(shape, dtype=dtype, device_mesh=mesh, placements=pls)


def cache_pos(device) -> torch.Tensor:
    """A cache's ``pos``, the next position to write: a 0-dim int32 on the
    CPU (the host reads it to index, so keeping it there spares a device
    sync per step), or on the meta device for an abstract cache."""
    meta = torch.device(device).type == "meta"
    return torch.zeros((), dtype=torch.int32,
                       device="meta" if meta else "cpu")


def split_params(params: dict) -> tuple[dict, dict]:
    """(top-level params, stacked layer params without their ``layers.``
    prefix)."""
    stacked = {k[len("layers."):]: v for k, v in params.items()
               if k.startswith("layers.")}
    top = {k: v for k, v in params.items() if not k.startswith("layers.")}
    return top, stacked


def unbound(stacked: dict):
    """Each layer's parameters of a stacked dict, in order.  Each stacked
    parameter is unbound once, not indexed (``v[i]``) a layer: where a graph
    is recorded, the backward of L indexings writes L zeroed (L, ...)
    tensors and sums them into the grad, where unbind's backward stacks the
    L slices once."""
    for vals in zip(*(v.unbind(0) for v in stacked.values())):
        yield dict(zip(stacked, vals))


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

    def abstract_params(self) -> dict:
        """Every parameter, in sorted name order, as a meta tensor of its
        ``ParamDef``'s shape and dtype; under a mesh context a DTensor with
        the placements of its logical names, whose ``.to_local()`` has one
        device's shape."""
        return {name: abstract_tensor(d.shape, d.dtype,
                                      logical_sharding(d.shape, d.names))
                for name, d in sorted(self.param_defs().items())}

    def place(self, params: dict) -> dict:
        """``params``, whole tensors that every rank holds alike, laid out
        by their ``ParamDef``s' logical names under the context's mesh, as
        ``abstract_params`` lays out the stand-ins (each rank keeps its own
        shard); unchanged outside a mesh."""
        defs = self.param_defs()
        return {k: place(v, defs[k].names) for k, v in params.items()}

    def param_count(self) -> int:
        return int(sum(math.prod(d.shape)
                       for d in self.param_defs().values()))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k of the experts)."""
        cfg = self.cfg
        total = 0
        for name, d in self.param_defs().items():
            n = math.prod(d.shape)
            if cfg.is_moe and ".experts." in name:
                n = n * cfg.experts_per_token // cfg.n_experts
            total += n
        return int(total)
