"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

15 heads do not divide the 16-way 'model' axis: the baseline auto-replicates
the head dim (dist/sharding.py guard); pad_heads_to_mesh is the optimized
variant (§Perf).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
        d_ff=2560, vocab=49152, tie_embeddings=True,
        # §Perf cell A optimum: padded heads (15->16, 5->16) + 1k attn chunks
        pad_heads_to_mesh=True, attn_chunk=1024,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, head_dim=20,
        d_ff=128, vocab=512, dtype="float32", param_dtype="float32",
        attn_chunk=64,
    )
