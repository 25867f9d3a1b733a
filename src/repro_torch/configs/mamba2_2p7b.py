"""mamba2-2.7b [ssm] — 64L d_model=2560 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=80, n_kv_heads=80,  # heads = d_inner/64
        d_ff=0, vocab=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=256),
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, vocab=512,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk=16),
        dtype="float32", param_dtype="float32", attn_chunk=64,
    )
