"""llama3-8b [dense] — GQA, 128k vocab.  [arXiv:2407.21783]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
long_500k skipped: full attention.
"""
from ..models.model_api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="decoder",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=128256,
        rope_theta=500_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-smoke", family="decoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=503, rope_theta=500_000.0,
    )
