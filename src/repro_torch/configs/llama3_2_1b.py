"""llama3.2-1b [dense] — small llama3.  [hf:meta-llama/Llama-3.2-1B]

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
long_500k skipped: full attention.
"""
from ..models.model_api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="decoder",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab_size=128256,
        head_dim=64, rope_theta=500_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke", family="decoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=503, head_dim=16, rope_theta=500_000.0,
    )
