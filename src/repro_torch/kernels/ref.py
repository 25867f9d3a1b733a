"""Plain PyTorch versions of the kernels of the port (port of the matching
oracles in ``repro/kernels/ref.py``).

Each hand-written kernel in ``kernels/`` has its plain version here with the
same contract.  The CPU runs these (the wrappers take them for a CPU
tensor), the tests hold them against the JAX oracles and the Pallas kernels
in interpret mode, and ``chip_smoke.py`` holds each CUDA kernel against its
plain version on the card.  The two attention oracles are also the LM's
plain arm (``nn/attention.py``) at up to 1024 tokens and in decode.
"""
from __future__ import annotations

import math
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


def cached_gather(
    table: torch.Tensor,  # [N, D]
    hot: torch.Tensor,  # [C] int hot row ids
    idx: torch.Tensor,  # [...] int indices into the extended pool [0, N+C)
) -> torch.Tensor:
    """Hot-row cache gather: the extended pool is the table with the hot
    rows' bitwise copies appended.  Returns ``idx.shape + (D,)``."""
    pool = torch.cat([table, table[hot.long()]])
    return pool[idx.long()]


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


def semantic_scores(z, w, b, q) -> torch.Tensor:
    """SA pass 1: ``w_p = mean_n q·tanh(z_p,n W + b)`` over ``z [P, N, D]``
    -> ``[P]``."""
    return (torch.tanh(z @ w + b) @ q).mean(dim=1)


def semantic_attention(z, w, b, q) -> torch.Tensor:
    """HAN semantic attention over the stacked ``[P, N, D]`` input."""
    return semantic_combine(z, torch.softmax(semantic_scores(z, w, b, q),
                                             dim=0))


def _attention_probs(scores: torch.Tensor, dh: int, valid: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Scale, mask with -1e30, softmax in fp32, cast to ``dtype``."""
    scores = torch.where(valid, scores.float() / math.sqrt(dh), -1e30)
    return torch.softmax(scores, dim=-1).to(dtype)


def mha_attention(
    q: torch.Tensor,  # [B, S, H, Dh]
    k: torch.Tensor,  # [B, S, KVH, Dh]
    v: torch.Tensor,  # [B, S, KVH, Dh]
    causal: bool = True,
    window: int = 0,  # 0 = full; else sliding window size
) -> torch.Tensor:
    """GQA/MHA attention oracle (fp32 softmax).  The scores are computed in
    ``q.dtype`` and the probabilities cast back to it before ``p @ v``, as
    the reference's oracle does."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k)
    ids = torch.arange(s, device=q.device)
    m = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (ids[:, None] >= ids[None, :])
    if window:
        m = m & (ids[:, None] - ids[None, :] < window)
    p = _attention_probs(scores, dh, m, q.dtype)
    return torch.einsum("bkgst,btkd->bskgd", p, v).reshape(b, s, h, dh)


def decode_attention(
    q: torch.Tensor,  # [B, H, Dh] the new token
    k: torch.Tensor,  # [B, S, KVH, Dh] cache
    v: torch.Tensor,  # [B, S, KVH, Dh]
    kv_len,  # [B] int tensor or int: valid cache length
) -> torch.Tensor:
    """One-token GQA attention over the first ``kv_len[b]`` cache rows."""
    b, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k)
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(s, device=q.device)[None, :] < kv_len
    p = _attention_probs(scores, dh, valid[:, None, None, :], q.dtype)
    return torch.einsum("bkgt,btkd->bkgd", p, v).reshape(b, h, dh)
