"""Rotary position embeddings with arbitrary position offsets (port of
``repro/nn/rope.py``).  The pairs are interleaved: ``(x[2i], x[2i+1])``
rotate by ``pos * theta^(-2i/Dh)``, not the rotate-half layout."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple:
    """``cos, sin`` of the angles at ``positions`` (``[..., S]``), shaped
    ``[..., S, 1, Dh/2]`` to broadcast over the heads."""
    freqs = rope_freqs(head_dim, theta, positions.device)  # [Dh/2]
    ang = positions[..., None].float() * freqs  # [..., S, Dh/2]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """x: ``[..., S, H, Dh]`` rotated by the tables of ``rope_tables``."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: ``[..., S, H, Dh]``; positions: broadcastable to ``[..., S]``."""
    return rotate(x, *rope_tables(positions.to(x.device), x.shape[-1],
                                  theta))
