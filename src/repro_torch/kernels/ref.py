"""Plain PyTorch versions of the kernels of the port (port of the matching
oracles in ``repro/kernels/ref.py``).

Each hand-written kernel in ``kernels/`` has its plain version here with the
same contract.  The CPU runs these (the wrappers take them for a CPU
tensor), the tests hold them against the JAX oracles and the Pallas kernels
in interpret mode, and ``chip_smoke.py`` holds each CUDA kernel against its
plain version on the card.
"""
from __future__ import annotations

from typing import Dict

import torch

_NEG = -1e9


def segment_spmm(
    h_src: torch.Tensor,  # [M, D]
    nbr: torch.Tensor,  # [N, K] int
    mask: torch.Tensor,  # [N, K] float weights (0 = no neighbour)
    mean: bool = True,
) -> torch.Tensor:
    """Padded-neighbour sum/mean aggregation: ``out[n] = sum_k mask[n, k] *
    h_src[nbr[n, k]]``, divided by ``max(sum_k mask[n, k], 1)`` when
    ``mean``.  ``mask`` is a float weight, not only {0, 1}; an all-zero row
    comes out exactly 0.  Returns ``[N, D]``."""
    hn = h_src[nbr.long()]  # [N, K, D]
    s = (hn * mask[..., None].to(h_src.dtype)).sum(dim=1)
    if mean:
        d = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
        s = s / d.to(h_src.dtype)
    return s


def fused_fp_na(
    x_src: torch.Tensor,  # [M, F] raw features
    w: torch.Tensor,  # [F, D] projection
    nbr: torch.Tensor,  # [N, K]
    mask: torch.Tensor,  # [N, K]
    mean: bool = True,
) -> torch.Tensor:
    """Fused Feature Projection + Neighbour Aggregation by linearity:
    ``mean_k(x[nbr]) @ W == mean_k(x[nbr] @ W)``.  Returns ``[N, D]``."""
    return segment_spmm(x_src, nbr, mask, mean=mean) @ w


def gat_na(
    p: Dict[str, torch.Tensor],  # a_dst/a_src [H, Dh] ([S, H, Dh] stacked)
    h_dst: torch.Tensor,  # [N, H, Dh]
    h_src: torch.Tensor,  # [M, H, Dh]
    nbr: torch.Tensor,  # [N, K] int ([S, N, K] stacked)
    mask: torch.Tensor,  # [N, K] {0,1} float ([S, N, K] stacked)
) -> torch.Tensor:
    """Fused multi-head GAT NA: SDDMM + masked segment-softmax + weighted
    reduce for all heads.  Returns ``[N, H, Dh]`` (``[S, N, H, Dh]``)."""
    if nbr.dim() == 3:
        return torch.stack([
            gat_na({k: v[s] for k, v in p.items()}, h_dst, h_src, nbr[s],
                   mask[s])
            for s in range(nbr.shape[0])])
    idx = nbr.long()
    e_dst = (h_dst * p["a_dst"]).sum(-1)  # [N, H]
    e_src = (h_src * p["a_src"]).sum(-1)  # [M, H]
    e = e_dst[:, None, :] + e_src[idx]  # [N, K, H]  SDDMM
    e = torch.where(e >= 0, e, 0.2 * e)
    live = mask[..., None] != 0
    e = torch.where(live, e, torch.full_like(e, _NEG))
    e = e - e.amax(dim=1, keepdim=True)
    w = torch.exp(e) * mask[..., None]
    alpha = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)
    return torch.einsum("nkh,nkhd->nhd", alpha, h_src[idx])


def gat_na_fused_sa(p, h_dst, h_src, nbr, mask, w, b, q):
    """``gat_na`` with the fused NA→SA epilogue: returns the elu-activated
    NA output ``z`` and the semantic-score partial
    ``w_s = mean_n q·tanh(z_s W + b)``: ``(z [S, N, H, Dh], w [S])``,
    stacked form only."""
    z = torch.nn.functional.elu(gat_na(p, h_dst, h_src, nbr, mask))
    s_dim, n = z.shape[0], z.shape[1]
    sc = torch.tanh(z.reshape(s_dim, n, -1) @ w + b)  # [S, N, Hs]
    wp = (sc @ q).mean(dim=1)  # [S]
    return z, wp


def semantic_combine(z: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """SA pass 2: ``out[n] = sum_p beta_p z[p, n]``, summed over ``p`` in
    order in fp32 — the arithmetic of the kernel, written out."""
    out = beta[0] * z[0]
    for i in range(1, z.shape[0]):
        out = out + beta[i] * z[i]
    return out


def semantic_attention(z, w, b, q) -> torch.Tensor:
    """HAN semantic attention over the stacked ``[P, N, D]`` input."""
    s = torch.tanh(z @ w + b)  # [P, N, Hs]
    wp = (s @ q).mean(dim=1)  # [P]
    return semantic_combine(z, torch.softmax(wp, dim=0))
