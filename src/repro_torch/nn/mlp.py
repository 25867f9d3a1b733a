"""SwiGLU MLP (port of ``repro/nn/mlp.py``) with the reference's tensor
parallelism over ``'model'`` (Megatron: up and gate column-sharded, down
row-sharded, so one all-reduce a block; a reduce-scatter over the sequence
under ``seq_shard``).  The ``shard`` constraints are no-ops off a mesh."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import BATCH, MODEL, gather_seq, shard


class MetaGenerator:
    """Stands for a generator in the ``init_*`` functions: every weight
    they draw on it is a meta tensor of its shape and dtype (a model's
    layout, with no storage: the dry run, ``analytic_param_counts``)."""

    device = torch.device("meta")


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype
           ) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in fp32 on ``gen``'s device, then cast
    (a meta tensor for a :class:`MetaGenerator`)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
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


def mlp_block(params: Dict, x: torch.Tensor,
              seq_shard: bool = False) -> torch.Tensor:
    x = gather_seq(x)
    g = shard(x @ params["w_gate"], BATCH, None, MODEL)
    u = shard(x @ params["w_up"], BATCH, None, MODEL)
    out = (F.silu(g) * u) @ params["w_down"]
    return shard(out, BATCH, MODEL if seq_shard else None, None)
