"""RMSNorm, computed in fp32 and cast back (port of ``repro/nn/norm.py``)."""
from __future__ import annotations

import torch


def init_rmsnorm(d: int, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * g).to(x.dtype)
