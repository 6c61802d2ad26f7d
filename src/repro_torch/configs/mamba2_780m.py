"""mamba2-780m [ssm] — SSD (state-space duality).  [arXiv:2405.21060]

48L d_model=1536 (attention-free) vocab=50280, ssm_state=128, expand=2
(d_inner=3072, 48 SSD heads of P=64).  long_500k RUNS: O(1)-state decode.
"""
from ..models.model_api import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
        ssm_chunk=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=503,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4,
        ssm_chunk=16,
    )
