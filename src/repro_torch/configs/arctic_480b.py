"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual [hf:Snowflake/snowflake-arctic-base; hf]."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=4864, vocab=32000,
        moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                      dense_residual_ff=4864, capacity_factor=1.25),
        # 480B params: factored optimizer state so train fits the pod
        optimizer="adafactor", remat="full", n_microbatches=4,
        # §Perf cell C optimum: 56->64 q heads / 8->16 kv heads (zero-padded)
        pad_heads_to_mesh=True,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96,
                      dense_residual_ff=96, capacity_factor=2.0),
        dtype="float32", param_dtype="float32", attn_chunk=64,
    )
