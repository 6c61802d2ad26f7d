"""repro_torch.configs -- the 10 architectures of ``repro.configs``, as plain
data: ``get_config`` gives an architecture at its published widths and
depth, ``get_smoke_config`` its reduced variant for the CPU tests.  Each
module is the JAX package's own, importing the port's ``ModelConfig``.  The
shape table and cell matrix (``input_specs``, ``valid_cells``) wait for the
``parallel`` port (ROADMAP.md, Queue 1 item 6).
"""
from __future__ import annotations

import importlib

from ..models.model_api import ModelConfig

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


__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]
