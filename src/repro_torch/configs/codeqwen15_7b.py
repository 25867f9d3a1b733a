"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32, i.e. MHA)
d_ff=13440 vocab=92416 — qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B; hf]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
        d_ff=13440, vocab=92416,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, dtype="float32", param_dtype="float32",
        attn_chunk=64,
    )
