"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix, SWA [arXiv:2401.16818; unverified].

Sliding-window attention (4096) makes decode sub-quadratic with a
ring-buffer KV cache -> long_500k runs for this arch (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense",
        n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
        d_ff=10240, vocab=32000, sliding_window=4096,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, sliding_window=32,
        dtype="float32", param_dtype="float32", attn_chunk=64,
    )
