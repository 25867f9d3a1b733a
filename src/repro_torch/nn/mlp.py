"""SwiGLU MLP (port of ``repro/nn/mlp.py``; the reference's tensor-parallel
``shard`` constraints are no-ops on one device and are dropped)."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype
           ) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in fp32 on ``gen``'s device, then cast."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


def init_mlp(gen: torch.Generator, d: int, d_ff: int, n_layers: int,
             param_dtype: torch.dtype) -> Dict:
    s = 1.0 / math.sqrt(d)
    return {
        "w_gate": normal(gen, (d, d_ff), s, param_dtype),
        "w_up": normal(gen, (d, d_ff), s, param_dtype),
        "w_down": normal(gen, (d_ff, d), s / math.sqrt(2 * n_layers),
                         param_dtype),
    }


def mlp_block(params: Dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]
