"""chatglm3-6b [dense] — 2d (partial) RoPE, extreme GQA (kv=2), qkv bias.
[arXiv:2406.12793]

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
long_500k skipped: full attention.
"""
from ..models.model_api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="decoder",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab_size=65024,
        qkv_bias=True, rope_fraction=0.5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-smoke", family="decoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=503, qkv_bias=True, rope_fraction=0.5,
    )
