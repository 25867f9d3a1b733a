"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].

Encoder-decoder: 12 encoder + 12 decoder layers. The audio frontend is a
STUB per the brief: input_specs provides precomputed frame embeddings
[B, S_src, d_model] for the encoder.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec",
        n_layers=12, enc_layers=12, dec_layers=12,
        d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, vocab=256206, frontend="audio",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, enc_layers=2, dec_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, dtype="float32", param_dtype="float32",
        attn_chunk=64,
    )
