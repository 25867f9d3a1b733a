"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT + InternLM2 [arXiv:2404.16821; unverified].

The vision frontend is a STUB per the brief: input_specs provides
precomputed patch embeddings [B, 256, d_model] prepended to the tokens.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=28672, vocab=128256,
        frontend="vision", n_frontend_embeds=256,
        remat="full", n_microbatches=4,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, n_frontend_embeds=8,
        dtype="float32", param_dtype="float32", attn_chunk=64,
    )
