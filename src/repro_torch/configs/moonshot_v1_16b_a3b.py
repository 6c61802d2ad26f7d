"""moonshot-v1-16b-a3b [moe] — Moonlight-16B-A3B, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B]

48L d_model=2048 16H (GQA kv=16) d_ff=1408 (per expert) vocab=163840,
MoE 64e top-6.  long_500k skipped: full attention.
"""
from ..models.model_api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="decoder",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=163840,
        n_experts=64, experts_per_token=6,
        rope_theta=50_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", family="decoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab_size=503,
        n_experts=8, experts_per_token=2,
    )
