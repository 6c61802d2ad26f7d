"""hubert-xlarge [audio] — encoder-only transformer backbone (the conv
feature extractor is a STUB: ``input_specs`` provides precomputed frame
embeddings).  [arXiv:2106.07447]

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (cluster targets).
Encoder-only: no decode step -> decode_32k and long_500k are skipped;
prefill_32k runs as a full bidirectional encode.
"""
from ..models.model_api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="encoder",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab_size=504,
        causal=False, frontend="frames",
        vocab_pad_multiple=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke", family="encoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=31, causal=False, frontend="frames",
        vocab_pad_multiple=8,
    )
