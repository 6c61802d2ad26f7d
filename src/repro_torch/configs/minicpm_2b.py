"""minicpm-2b [dense] — llama-like arch, WSD schedule, tied embeddings.
[arXiv:2404.06395]

40L d_model=2304 36H (GQA kv=36, i.e. MHA) d_ff=5760 vocab=122753
(padded to 122880).  long_500k skipped: full attention.
"""
from ..models.model_api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="decoder",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab_size=122753,
        tie_embeddings=True,
    )


# train_schedule, MiniCPM's warmup-stable-decay schedule, waits for the
# optimizer's port (ROADMAP.md, Queue 1 item 4).


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-smoke", family="decoder",
        n_layers=2, d_model=72, n_heads=6, n_kv_heads=6,
        d_ff=144, vocab_size=503, tie_embeddings=True,
    )
