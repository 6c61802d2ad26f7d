"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer.
[arXiv:2411.13676]

32L d_model=1600 25H (GQA kv=5, head_dim 64) d_ff=5504 vocab=32001,
ssm_state=16.  SWA (window 1024) everywhere except 3 full-attention layers
(first/middle/last, per the paper).  Meta-tokens and cross-layer KV sharing
are omitted (DESIGN.md §2).  long_500k RUNS: SSM state + windowed KV.
"""
from ..models.model_api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab_size=32001,
        head_dim=64, ssm_state=16, ssm_head_dim=64, ssm_conv=4,
        ssm_chunk=256,
        window=1024, global_layers=(0, 15, 31),
        vocab_pad_multiple=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="hybrid",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=503,
        head_dim=16, ssm_state=8, ssm_head_dim=16, ssm_chunk=16,
        window=32, global_layers=(0,), vocab_pad_multiple=16,
    )
