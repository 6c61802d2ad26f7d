"""repro_torch.models -- the port's model zoo and its serve-step builders.
Twin of ``repro.models``; this slice has the dense decoder.  The ``ssm``
(mamba2) and ``hybrid`` (hymba) families and ``make_train_step`` wait for
later slices (ROADMAP.md, Queue 1 items 3 and 4)."""
from __future__ import annotations

import torch

from .model_api import BaseModel, ModelConfig, ParamDef
from .transformer import DecoderLM


def get_model(cfg: ModelConfig) -> BaseModel:
    if cfg.family in ("decoder", "encoder"):
        return DecoderLM(cfg)
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP.md, Queue 1 item 3)")
    raise ValueError(f"unknown family {cfg.family!r}")


def make_prefill_step(model: BaseModel):
    """``model.prefill`` under ``torch.inference_mode()``.  Grad mode is per
    thread, so a payload on a worker thread takes the step, not the bare
    method.  ``max_len`` passes through."""
    def prefill_step(params, batch, **kw):
        with torch.inference_mode():
            return model.prefill(params, batch, **kw)
    return prefill_step


def make_decode_step(model: BaseModel):
    """``model.decode_step`` under ``torch.inference_mode()``, as
    ``make_prefill_step``."""
    def decode_step(params, tokens, cache):
        with torch.inference_mode():
            return model.decode_step(params, tokens, cache)
    return decode_step


__all__ = ["BaseModel", "ModelConfig", "ParamDef", "DecoderLM", "get_model",
           "make_prefill_step", "make_decode_step"]
