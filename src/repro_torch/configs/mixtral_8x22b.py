"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2,
SWA window 4096.  long_500k RUNS via the sliding window (KV capped at W).
"""
from ..models.model_api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="decoder",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=32768,
        n_experts=8, experts_per_token=2,
        window=4096, rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="decoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab_size=503,
        n_experts=4, experts_per_token=2, window=32,
    )
