"""LM layers of the port (``repro/nn`` counterpart): RMSNorm, RoPE, SwiGLU,
GQA attention, the routed MoE, the Mamba2 SSD block and the decoder-only
transformer (dense, MoE, SSM and hybrid families)."""
