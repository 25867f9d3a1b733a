"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

38 Mamba2 layers with ONE shared attention+MLP block (single param set)
applied every 19 layers (2 applications), matching the weight-sharing idea.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab=32000,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, d_conv=4, chunk=256),
        shared_attn_period=19, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, shared_attn_period=2,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk=16),
        dtype="float32", param_dtype="float32", attn_chunk=64,
    )
