"""internvl2-2b [vlm] — InternViT frontend (STUB: precomputed patch
embeddings) + InternLM2-1.8B backbone.  [arXiv:2404.16821; hf]

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553 (padded to 92672 for
TP divisibility).  long_500k skipped: full attention (see DESIGN.md §4).
"""
from ..models.model_api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b", family="decoder",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab_size=92553,
        rope_theta=1_000_000.0,
        frontend="patch", n_patches=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b-smoke", family="decoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=503, rope_theta=1e6,
        frontend="patch", n_patches=8,
    )
