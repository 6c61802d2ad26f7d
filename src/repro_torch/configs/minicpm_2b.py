"""minicpm-2b [dense] — llama-like arch, WSD schedule, tied embeddings.
[arXiv:2404.06395]

40L d_model=2304 36H (GQA kv=36, i.e. MHA) d_ff=5760 vocab=122753
(padded to 122880).  long_500k skipped: full attention.
"""
from ..models.model_api import ModelConfig
from ..optimizer import wsd_schedule


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="decoder",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab_size=122753,
        tie_embeddings=True,
    )


def train_schedule(total_steps: int = 10_000):
    """MiniCPM's warmup-stable-decay schedule."""
    warm = max(total_steps // 100, 10)
    decay = max(total_steps // 10, 10)
    return wsd_schedule(1e-2, warm, total_steps - warm - decay, decay)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-smoke", family="decoder",
        n_layers=2, d_model=72, n_heads=6, n_kv_heads=6,
        d_ff=144, vocab_size=503, tie_embeddings=True,
    )
