"""repro_torch.configs -- the 10 architectures of ``repro.configs``, the 4
input shapes, and the (arch x shape) cell matrix with structural-skip
logic.  ``get_config`` gives an architecture at its published widths and
depth, ``get_smoke_config`` its reduced variant for the CPU tests.  Each
module is the JAX package's own, importing the port's ``ModelConfig``.
``input_specs`` gives a cell's inputs as meta tensors (DTensors under a
mesh context), the port's ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Iterable

import torch

from ..models import ModelConfig, get_model
from ..parallel.sharding import abstract_tensor, logical_sharding

ARCH_IDS = (
    "internvl2-2b",
    "mamba2-780m",
    "moonshot-v1-16b-a3b",
    "mixtral-8x22b",
    "hubert-xlarge",
    "minicpm-2b",
    "llama3.2-1b",
    "chatglm3-6b",
    "llama3-8b",
    "hymba-1.5b",
)

_MODULES = {
    "internvl2-2b": "internvl2_2b",
    "mamba2-780m": "mamba2_780m",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "hubert-xlarge": "hubert_xlarge",
    "minicpm-2b": "minicpm_2b",
    "llama3.2-1b": "llama3_2_1b",
    "chatglm3-6b": "chatglm3_6b",
    "llama3-8b": "llama3_8b",
    "hymba-1.5b": "hymba_1_5b",
}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
SHAPE_NAMES = tuple(SHAPES)


def cell_skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> str | None:
    """None if the (arch, shape) cell runs; otherwise the structural reason."""
    if cfg.family == "encoder" and shape.kind == "decode":
        return "encoder-only: no decode step"
    if shape.name == "long_500k":
        sub_quadratic = (cfg.family in ("ssm", "hybrid")
                         or cfg.window is not None)
        if not sub_quadratic:
            return "full attention: 500k decode needs sub-quadratic attention"
    return None


def valid_cells(archs: Iterable[str] = ARCH_IDS,
                shapes: Iterable[str] = SHAPE_NAMES):
    """All runnable (arch, shape) pairs + the skip list."""
    run, skip = [], []
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            reason = cell_skip_reason(cfg, SHAPES[s])
            if reason is None:
                run.append((a, s))
            else:
                skip.append((a, s, reason))
    return run, skip


# ---------------------------------------------------------------------------
# input specs (the dry run's stand-ins; no allocation)
# ---------------------------------------------------------------------------
def decode_pos(shape: ShapeSpec) -> int:
    """The position a decode cell's stand-in cache is at: its last slot,
    the step that fills a cache of ``seq_len``."""
    return shape.seq_len - 1


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors for every model input of this (arch, shape) cell.

    ``train``   -> the training batch
    ``prefill`` -> the request batch (full prompt)
    ``decode``  -> one-token batch + a KV/state cache of seq_len
    Under a mesh context each is a DTensor with the placements of its
    logical names (batch over pod x data).  The one concrete input is a
    decode cache's ``pos``, a 0-dim int32 on the CPU as every cache of the
    port holds it (``model_api.cache_pos``), set to ``decode_pos(shape)``:
    the decode steps index the cache with it on the host, where JAX traces
    an abstract ``pos`` into the program.  A step attends over every slot
    under a mask, so its work does not depend on the value."""
    B, S = shape.global_batch, shape.seq_len

    def sds(shp, dtype, names):
        return abstract_tensor(shp, dtype, logical_sharding(shp, names))

    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "frames":
            batch = {"frames": sds((B, S, cfg.d_model), torch.bfloat16,
                                   ("batch", "seq", None))}
        else:
            batch = {"tokens": sds((B, S), torch.int32, ("batch", "seq"))}
        if shape.kind == "train":
            batch["targets"] = sds((B, S), torch.int32, ("batch", "seq"))
        if cfg.frontend == "patch":
            batch["patch_embeds"] = sds(
                (B, cfg.n_patches, cfg.d_model), torch.bfloat16,
                ("batch", None, None))
        return {"batch": batch}

    if shape.kind == "decode":
        cache = get_model(cfg).init_cache(B, S, device="meta")
        cache["pos"] = torch.tensor(decode_pos(shape), dtype=torch.int32)
        tokens = sds((B, 1), torch.int32, ("batch", None))
        return {"tokens": tokens, "cache": cache}

    raise ValueError(f"unknown shape kind {shape.kind}")


__all__ = [
    "ARCH_IDS", "SHAPES", "SHAPE_NAMES", "ShapeSpec", "get_config",
    "get_smoke_config", "cell_skip_reason", "valid_cells", "input_specs",
    "decode_pos",
]
