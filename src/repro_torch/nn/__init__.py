"""LM layers of the port (``repro/nn`` counterpart): RMSNorm, RoPE, SwiGLU,
GQA attention and the dense decoder-only transformer."""
