"""The paper's HGNN execution stages in PyTorch (port of
``repro/core/stages.py:55-200`` and ``:226-317``).

Stage 2 — Feature Projection (FP): type-specific dense matmul (DM-Type).
Stage 3 — Neighbor Aggregation (NA): graph-topology gather + reduce
(TB-Type) with element-wise attention math (EW-Type).
Stage 4 — Semantic Aggregation (SA): :mod:`repro_torch.core.semantics`.

The reference wraps these in ``shard(...)`` constraints for its device
mesh; on one device those are no-ops, so the port drops them and calls
the plain functions.  Parameter init draws the
reference's shapes and scales from a ``torch.Generator`` on the CPU; the
numbers differ from ``jax.random``'s, so parity tests carry the
reference's own parameters across through ``repro_torch.interop``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale


# ---------------------------------------------------------------------------
# Stage 2: Feature Projection
# ---------------------------------------------------------------------------


def init_feature_projection(gen: torch.Generator, feat_dims: Dict[str, int],
                            hidden: int) -> Dict[str, torch.Tensor]:
    return {t: _normal(gen, (d, hidden), 1.0 / math.sqrt(d))
            for t, d in sorted(feat_dims.items())}


def feature_projection(params: Dict[str, torch.Tensor],
                       feats: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Project per-type raw features into the shared latent space."""
    return {t: feats[t] @ params[t] for t in feats}


# ---------------------------------------------------------------------------
# Stage 3: Neighbor Aggregation
# ---------------------------------------------------------------------------


def init_gat(gen: torch.Generator, n_heads: int,
             head_dim: int) -> Dict[str, torch.Tensor]:
    s = 1.0 / math.sqrt(head_dim)
    return {"a_dst": _normal(gen, (n_heads, head_dim), s),
            "a_src": _normal(gen, (n_heads, head_dim), s)}


def _leaky_relu(x, slope=0.2):
    return torch.where(x >= 0, x, slope * x)


def gat_aggregate_padded(
    p: Dict[str, torch.Tensor],
    h_dst: torch.Tensor,  # [N, H, Dh] projected features of target nodes
    h_src: torch.Tensor,  # [M, H, Dh] projected neighbor pool
    nbr: torch.Tensor,  # [N, K] int
    mask: torch.Tensor,  # [N, K] float
) -> torch.Tensor:
    """GAT neighbor aggregation over a padded subgraph. Returns [N, H, Dh]."""
    idx = nbr.long()
    e_dst = (h_dst * p["a_dst"]).sum(-1)  # [N, H]   EW
    hn = h_src[idx]  # [N, K, H, Dh]  TB gather
    e_nbr = (h_src * p["a_src"]).sum(-1)[idx]  # [N, K, H]
    e = _leaky_relu(e_dst[:, None, :] + e_nbr)
    e = torch.where(mask[..., None] > 0, e, torch.full_like(e, -1e9))
    e = e - e.amax(dim=1, keepdim=True)
    w = torch.exp(e) * mask[..., None]
    alpha = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)
    return torch.einsum("nkh,nkhd->nhd", alpha, hn)  # reduction tree


def gat_aggregate_padded_stacked(
    p_stacked: Dict[str, torch.Tensor],
    h: torch.Tensor,
    nbr: torch.Tensor,  # [P, N, K] stacked per-metapath subgraphs
    mask: torch.Tensor,
    stacked_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Inter-subgraph-parallel NA over stacked padded subgraphs, gathering
    from the destination table ``h``: the plain body looped over the stack
    (the reference's vmap), or ``stacked_fn`` consuming the whole
    ``[P, N, K]`` stack in one call — the kernel path, ONE launch per
    stack."""
    if stacked_fn is not None:
        return stacked_fn(p_stacked, h, h, nbr, mask)
    return torch.stack([
        gat_aggregate_padded({k: v[i] for k, v in p_stacked.items()}, h, h,
                             nbr[i], mask[i])
        for i in range(nbr.shape[0])])


def mean_aggregate_padded(h_src: torch.Tensor, nbr: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Mean NA (RGCN). h_src [M, D] -> [N, D]."""
    s = (h_src[nbr.long()] * mask[..., None]).sum(dim=1)  # [N, K, D] gather
    d = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    return s / d


def mean_aggregate_bucketed(
    h_src: torch.Tensor,  # [M, D]
    buckets: Sequence,  # (row_ids [n_b], nbr [n_b, K_b], mask) per bucket
    n_rows: int,
    agg_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Mean NA over a degree-bucketed layout: each bucket runs the padded
    mean at its own degree cap ``K_b`` and is copied back to node order
    through ``row_ids``; ``agg_fn`` swaps in the ``segment_spmm`` kernel.

    The reference scatters with ``out.at[row_ids].set``, which drops
    out-of-range ids; ``index_copy_`` raises on them instead.  Full-graph
    ``row_ids`` partition ``[0, n_rows)`` exactly, so none is out of range
    here (the sampled slice's pad ids are ROADMAP Queue 3 check (a))."""
    base = agg_fn or mean_aggregate_padded
    out = torch.zeros((n_rows, h_src.shape[-1]), dtype=h_src.dtype,
                      device=h_src.device)
    for row_ids, nbr, mask in buckets:
        out.index_copy_(0, row_ids.long(), base(h_src, nbr, mask))
    return out


def mean_aggregate_csr(h_src: torch.Tensor, seg: torch.Tensor,
                       idx: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Mean NA over a flat edge list (the DGL-faithful baseline):
    ``jax.ops.segment_sum`` becomes ``index_add_``.  On a CUDA tensor
    ``index_add_`` adds with atomics, so this arm is not bitwise
    reproducible from run to run there (ROADMAP Queue 3)."""
    seg = seg.long()
    s = torch.zeros((n_nodes, h_src.shape[-1]), dtype=h_src.dtype,
                    device=h_src.device).index_add_(0, seg, h_src[idx.long()])
    d = torch.zeros((n_nodes,), dtype=h_src.dtype,
                    device=h_src.device).index_add_(
        0, seg, torch.ones_like(seg, dtype=h_src.dtype))
    return s / torch.clamp(d[:, None], min=1.0)


def csr_to_edges(indptr: np.ndarray,
                 indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: CSR -> (segment_ids, indices) flat edge list."""
    degrees = np.diff(indptr)
    seg = np.repeat(np.arange(len(degrees), dtype=np.int32), degrees)
    return seg, indices.astype(np.int32)
