"""The paper's HGNN execution stages in PyTorch (port of
``repro/core/stages.py:55-223``, ``:226-317`` and ``:325-364``).

The bucketed and edge-list arms take ``sink=True`` for sampled batches:
their pad rows and pad edges name the row one past the table, which JAX
drops and torch's ``index_copy_`` / ``index_add_`` would not.

Stage 2 — Feature Projection (FP): type-specific dense matmul (DM-Type).
Stage 3 — Neighbor Aggregation (NA): graph-topology gather + reduce
(TB-Type) with element-wise attention math (EW-Type).
Stage 4 — Semantic Aggregation (SA): :mod:`repro_torch.core.semantics`.

Stage-aware partitioning on a device mesh (the paper's taxonomy drives
the specs, :data:`HGNN_STAGE_SPECS`, as in the reference): FP (DM-Type)
shards its weights over ``'model'`` and its node rows over the ``BATCH``
axes; NA (TB-Type) shards destination nodes over ``BATCH`` and keeps the
source pool replicated, so every gather stays local; SA (EW-Type) rides
the NA layout.  The ``*_sharded`` functions and the stacked NA apply those
``shard`` constraints and run the aggregation (a kernel or its plain
version) on each rank's shards through ``dist.sharding.local``; off a
mesh the constraints are no-ops and the aggregation runs as it is.
Parameter init draws the
reference's shapes and scales from a ``torch.Generator`` on the CPU; the
numbers differ from ``jax.random``'s, so parity tests carry the
reference's own parameters across through ``repro_torch.interop``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import (BATCH, MODEL, is_dtensor,
                                       lead_placements, local,
                                       replicate, shard)
from repro_torch.kernels import ops

# Stage-aware partitioning strategy; every entry is a logical per-dim spec
# resolved by dist.sharding.resolve_spec.
HGNN_STAGE_SPECS: Dict[str, Tuple] = {
    "fp_weight": (None, MODEL),          # [F_t, hidden]
    "fp_out": (BATCH, MODEL),            # [N_t, hidden]
    "na_dst": (BATCH, None, None),       # [N, H, Dh]
    "na_src": (None, None, None),        # [M, H, Dh] replicated gather pool
    "na_nbr": (BATCH, None),             # [N, K]  (also [N, I] instance masks)
    "na_out": (BATCH, None, None),       # [N, H, Dh]
    "na_inst_nodes": (BATCH, None, None),  # [N, I, L] MAGNN instance tables
    "na_flat_out": (BATCH, None),        # [N, D] flattened NA output
    "sa_stacked": (None, BATCH, None),   # [P, N, D]
}
_REP = (None, None, None, None)  # a replicated weight, any rank up to 4


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


def feature_projection_sharded(params: Dict[str, torch.Tensor],
                               feats: Dict[str, torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
    """FP with the stage-aware partitioning: the one HGNN stage that shards
    like an LM layer, weights column-sharded over ``'model'``, node rows
    over the ``BATCH`` axes.  No-op off a mesh."""
    return {t: shard(feats[t] @ shard(params[t],
                                      *HGNN_STAGE_SPECS["fp_weight"]),
                     *HGNN_STAGE_SPECS["fp_out"])
            for t in feats}


def na_inputs(h_dst, h_src, nbr, mask, lead: Tuple = ()):
    """The NA inputs under the stage-aware constraints: destinations and
    their neighbour tables over ``BATCH`` (after the ``lead`` dims of a
    stack), the source pool replicated."""
    specs = HGNN_STAGE_SPECS
    return (None if h_dst is None else shard(h_dst, *specs["na_dst"]),
            shard(h_src, *specs["na_src"]),
            shard(nbr, *lead, *specs["na_nbr"]),
            shard(mask, *lead, *specs["na_nbr"]))


def local_na(fn, p: Dict[str, torch.Tensor], tables: Tuple, specs: Tuple,
             out_like):
    """``fn(p, *tables)`` on each rank's shards (``dist.sharding.local``):
    the parameters replicated, ``tables`` under ``specs``, the result laid
    out as ``out_like`` is (the neighbour table whose rows it follows)."""
    keys = sorted(p)
    out_pl = list(out_like.placements) if hasattr(out_like,
                                                  "placements") else None
    return local(lambda *a: fn(dict(zip(keys, a[:len(keys)])),
                               *a[len(keys):]),
                 tuple(p[k] for k in keys) + tuple(tables),
                 tuple(_REP[:p[k].dim()] for k in keys) + tuple(specs),
                 out_pl)


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
    h_src: Optional[torch.Tensor],  # [M, H, Dh] projected neighbor pool
    nbr: Optional[torch.Tensor],  # [N, K] int (None with hn and e_nbr)
    mask: torch.Tensor,  # [N, K] float
    hn: Optional[torch.Tensor] = None,  # [N, K, H, Dh] pre-gathered rows
    e_nbr: Optional[torch.Tensor] = None,  # [N, K, H] pre-gathered scores
) -> torch.Tensor:
    """GAT neighbor aggregation over a padded subgraph. Returns [N, H, Dh].

    ``hn`` / ``e_nbr`` let the schedule's own/halo split hand in the two
    gathers already merged (:func:`gather_own`, :func:`gather_merge`):
    pure row selections, so the attention math below gives the bits of
    the gather from ``h_src``."""
    idx = nbr.long() if hn is None or e_nbr is None else None
    e_dst = (h_dst * p["a_dst"]).sum(-1)  # [N, H]   EW
    if hn is None:
        hn = h_src[idx]  # [N, K, H, Dh]  TB gather
    if e_nbr is None:
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
    h_src: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inter-subgraph-parallel NA over stacked padded subgraphs: the plain
    body looped over the stack (the reference's vmap), or ``stacked_fn``
    consuming the whole ``[P, N, K]`` stack in one call — the kernel path,
    ONE launch per stack.  ``h_src`` swaps the gather pool (default: the
    destination table ``h``; the residency arm passes the cache-extended
    pool)."""
    specs = HGNN_STAGE_SPECS
    h, h_src, nbr, mask = na_inputs(h, h if h_src is None else h_src, nbr,
                                    mask, lead=(None,))

    def agg(p, h, h_src, nbr, mask):
        if stacked_fn is not None:
            return stacked_fn(p, h, h_src, nbr, mask)
        return torch.stack([
            gat_aggregate_padded({k: v[i] for k, v in p.items()}, h, h_src,
                                 nbr[i], mask[i])
            for i in range(nbr.shape[0])])

    z = local_na(agg, p_stacked, (h, h_src, nbr, mask),
                 (specs["na_dst"], specs["na_src"], (None,) + specs["na_nbr"],
                  (None,) + specs["na_nbr"]), nbr)
    return shard(z, None, *specs["na_out"])


def gat_aggregate_padded_sharded(p: Dict[str, torch.Tensor],
                                 h_dst: torch.Tensor, h_src: torch.Tensor,
                                 nbr: torch.Tensor, mask: torch.Tensor,
                                 agg_fn: Optional[Callable] = None
                                 ) -> torch.Tensor:
    """Padded NA with the stage-aware partitioning: destination nodes (and
    their neighbour lists) over ``BATCH``, the source pool replicated, so
    the TB-Type gather stays local.  ``agg_fn`` swaps in the unstacked
    ``gat_na`` kernel.  No-op off a mesh."""
    specs = HGNN_STAGE_SPECS
    tables = na_inputs(h_dst, h_src, nbr, mask)
    out = local_na(agg_fn or gat_aggregate_padded, p, tables,
                   (specs["na_dst"], specs["na_src"], specs["na_nbr"],
                    specs["na_nbr"]), tables[2])
    return shard(out, *specs["na_out"])


def gat_aggregate_csr(
    p: Dict[str, torch.Tensor],
    h_dst: torch.Tensor,  # [N, H, Dh]
    h_src: torch.Tensor,  # [M, H, Dh]
    seg: torch.Tensor,  # [E] int32 destination (segment) id per edge, sorted
    idx: torch.Tensor,  # [E] int32 source id per edge
    n_nodes: int,
) -> torch.Tensor:
    """DGL-faithful GAT: SDDMM (edge scores), segment max, segment softmax,
    SpMM, as separate steps (the paper's multi-kernel baseline, Fig. 5c).
    The segment max is ``scatter_reduce("amax")``, exact in any order; the
    softmax denominator and the SpMM are the fixed-order ``segment_sum``.
    A segment with no edge comes out 0, never NaN: it has no edge to read
    its (unset) max, and its sums are 0.  Returns ``[N, H, Dh]``."""
    seg_l, idx_l = seg.long(), idx.long()
    e_dst = (h_dst * p["a_dst"]).sum(-1)  # [N, H]
    e_src = (h_src * p["a_src"]).sum(-1)  # [M, H]
    e = _leaky_relu(e_dst[seg_l] + e_src[idx_l])  # [E, H]  SDDMM
    m = torch.zeros((n_nodes, e.shape[1]), dtype=e.dtype,
                    device=e.device).scatter_reduce(
        0, seg_l[:, None].expand_as(e), e, "amax", include_self=False)
    w = torch.exp(e - m[seg_l])
    denom = ops.segment_sum(w, seg, n_nodes)
    alpha = w / torch.clamp(denom[seg_l], min=1e-9)  # [E, H]
    msg = h_src[idx_l] * alpha[..., None]  # [E, H, Dh]
    out = ops.segment_sum(msg.flatten(1), seg, n_nodes)  # SpMM
    return out.reshape((n_nodes,) + tuple(h_src.shape[1:]))


def gat_aggregate_bucketed(
    p: Dict[str, torch.Tensor],
    h_dst: torch.Tensor,  # [N, H, Dh]
    h_src: torch.Tensor,  # [M, H, Dh]
    buckets: Sequence,  # (row_ids [n_b], nbr [n_b, K_b], mask) per bucket
    agg_fn: Optional[Callable] = None,
    sink: bool = False,
) -> torch.Tensor:
    """GAT NA over a degree-bucketed layout: each bucket runs the padded
    aggregation at its own degree cap ``K_b`` on the gathered rows
    ``h_dst[row_ids]`` (a fresh contiguous table, as the kernel wants) and
    is copied back to node order through ``row_ids``; ``agg_fn`` swaps in
    the unstacked ``gat_na`` kernel, one launch a bucket.  Full-graph
    ``row_ids`` partition the rows exactly.  ``sink`` is the sampled
    batches' arm (:func:`mean_aggregate_bucketed` says why): a pad row id
    ``N`` gathers row ``N - 1`` instead — its slots are all masked, so its
    output is exactly 0 whichever row it reads — and lands in the sink."""
    base = agg_fn or gat_aggregate_padded
    n = h_dst.shape[0]

    def bucket(p, h_dst, h_src, row_ids, nbr, mask):
        rows = row_ids.long()
        src = rows.clamp(max=n - 1) if sink else rows
        return base(p, h_dst.index_select(0, src), h_src, nbr, mask)

    return _bucketed(bucket, p, (h_dst, h_src), buckets,
                     (n + sink,) + tuple(h_dst.shape[1:]), h_dst.dtype, n)


def _bucketed(bucket, p: Dict, tables: Tuple, buckets: Sequence,
              shape: Tuple, dtype, n: int) -> torch.Tensor:
    """The bucketed layouts' loop: ``bucket(p, *tables, row_ids, nbr,
    mask)`` for each bucket, copied to node order through ``row_ids``
    into zeros of ``shape`` (``shape[0] > n``: the sink row, sliced away).

    On a mesh a bucket's rows lie over ``BATCH`` (``BUCKETED_BATCH_SPECS``)
    while its ``row_ids`` name rows that any rank may own: each rank
    aggregates its rows of a bucket (``local``, the tables whole), the
    buckets' results and row ids are gathered whole, and every rank
    copies them into the whole output, laid out as NA's output after.  A
    copy, not a sum, so the rows keep their bits."""
    on_mesh = any(is_dtensor(t) for t in tables)
    if on_mesh:
        tables = tuple(replicate(t) for t in tables)
    rows_all, z_all = [], []
    for row_ids, nbr, mask in buckets:
        row_ids = shard(row_ids, BATCH)
        nbr, mask = shard(nbr, BATCH, None), shard(mask, BATCH, None)
        z = local(bucket, (p, *tables, row_ids, nbr, mask), None,
                  lead_placements(nbr))
        rows_all.append(replicate(row_ids))
        z_all.append(replicate(z))

    def scatter(like, rows_all, z_all):
        out = torch.zeros(shape, dtype=dtype, device=like.device)
        for rows, z in zip(rows_all, z_all):
            out.index_copy_(0, rows.long(), z)
        return out[:n] if shape[0] > n else out

    out = local(scatter, (tables[0], rows_all, z_all), None,
                lead_placements(tables[0]))
    return shard(out, BATCH, *([None] * (out.dim() - 1))) if on_mesh \
        else out


# ---------------------------------------------------------------------------
# Instance aggregation (MAGNN intra-metapath)
# ---------------------------------------------------------------------------


def init_instance_attention(gen: torch.Generator, n_heads: int,
                            head_dim: int) -> Dict[str, torch.Tensor]:
    return init_gat(gen, n_heads, head_dim)


def rotate_encoder(h_path: torch.Tensor) -> torch.Tensor:
    """MAGNN's relational rotation (RotatE-style) instance encoder.

    ``h_path``: [N, I, L, H, Dh] projected features along each instance.
    Treats the feature pairs (even, odd) as complex numbers, composes the
    positions by cumulative rotation along the path, averages, and
    interleaves the pairs back.  The mean when L == 1."""
    n, i, l, h, dh = h_path.shape
    re, im = h_path[..., 0::2], h_path[..., 1::2]
    acc_re, acc_im = re[:, :, 0], im[:, :, 0]
    out_re, out_im = acc_re, acc_im
    for pos in range(1, l):
        r, s = re[:, :, pos], im[:, :, pos]
        acc_re, acc_im = acc_re * r - acc_im * s, acc_re * s + acc_im * r
        out_re = out_re + acc_re
        out_im = out_im + acc_im
    return torch.stack([out_re / l, out_im / l], dim=-1).reshape(n, i, h, dh)


def instance_aggregate(
    p: Dict[str, torch.Tensor],
    h_tgt: torch.Tensor,  # [N, H, Dh]
    enc: torch.Tensor,  # [N, I, H, Dh] encoded instances
    mask: torch.Tensor,  # [N, I]
) -> torch.Tensor:
    """Attention over metapath instances per target node -> [N, H, Dh]."""
    e_t = (h_tgt * p["a_dst"]).sum(-1)  # [N, H]
    e_i = (enc * p["a_src"]).sum(-1)  # [N, I, H]
    e = _leaky_relu(e_t[:, None, :] + e_i)
    e = torch.where(mask[..., None] > 0, e, torch.full_like(e, -1e9))
    e = e - e.amax(dim=1, keepdim=True)
    w = torch.exp(e) * mask[..., None]
    alpha = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)
    return torch.einsum("nih,nihd->nhd", alpha, enc)


def mean_aggregate_padded(h_src: Optional[torch.Tensor], nbr: torch.Tensor,
                          mask: torch.Tensor,
                          hn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean NA (RGCN). h_src [M, D] -> [N, D].  ``hn`` hands in the gather
    already merged (the schedule's own/halo split): the same rows, the
    same sum."""
    if hn is None:
        hn = h_src[nbr.long()]  # [N, K, D] gather
    s = (hn * mask[..., None]).sum(dim=1)
    d = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    return s / d


def mean_aggregate_padded_sharded(h_src: torch.Tensor, nbr: torch.Tensor,
                                  mask: torch.Tensor,
                                  agg_fn: Optional[Callable] = None
                                  ) -> torch.Tensor:
    """Mean NA (RGCN) with the stage-aware partitioning: destinations over
    ``BATCH``, the source pool replicated (spec entries past ``h_src``'s
    rank are ignored).  ``agg_fn`` swaps in the ``segment_spmm`` kernel.
    No-op off a mesh."""
    specs = HGNN_STAGE_SPECS
    _, h_src, nbr, mask = na_inputs(None, h_src, nbr, mask)
    out = local_na(lambda p, *t: (agg_fn or mean_aggregate_padded)(*t), {},
                   (h_src, nbr, mask),
                   (specs["na_src"][:h_src.dim()], specs["na_nbr"],
                    specs["na_nbr"]), nbr)
    return shard(out, BATCH, None)


def gather_own(own: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The owned half of a split own/halo gather (:func:`gather_merge`):
    ``own[idx]`` with every index clamped into the owned table.  An index
    past it names a halo row, and the merge takes the halo side there, so
    the clamped row never reaches the output (ROADMAP Queue 3 check (a)).
    It reads the owned table alone, so the schedule runs it while the
    halo exchange is still in flight."""
    return own[idx.long().clamp(0, own.shape[0] - 1)]


def gather_merge(own_sel: torch.Tensor, halo: torch.Tensor,
                 idx: torch.Tensor, n_own: int) -> torch.Tensor:
    """Merge the split gather: ``concat([own, halo])[idx]`` as a select
    between ``own_sel = gather_own(own, idx)`` and the halo rows
    ``halo[idx - n_own]`` (clamped into ``[0, H_max)``).  Row copies only,
    so bitwise the gather from the concatenated table; ``H_max = 0``
    leaves ``own_sel`` as it is."""
    if halo.shape[0] == 0:
        return own_sel
    v = idx.long()
    halo_sel = halo[(v - n_own).clamp(0, halo.shape[0] - 1)]
    cond = (v < n_own).reshape(tuple(v.shape) + (1,) * (halo.dim() - 1))
    return torch.where(cond, own_sel, halo_sel)


def mean_aggregate_bucketed(
    h_src: torch.Tensor,  # [M, D]
    buckets: Sequence,  # (row_ids [n_b], nbr [n_b, K_b], mask) per bucket
    n_rows: int,
    agg_fn: Optional[Callable] = None,
    sink: bool = False,
) -> torch.Tensor:
    """Mean NA over a degree-bucketed layout: each bucket runs the padded
    mean at its own degree cap ``K_b`` and is copied back to node order
    through ``row_ids``; ``agg_fn`` swaps in the ``segment_spmm`` kernel.

    The reference scatters with ``out.at[row_ids].set``, which drops
    out-of-range ids; ``index_copy_`` raises on them on the CPU and
    device-asserts on the card.  Full-graph ``row_ids`` partition ``[0,
    n_rows)`` exactly.  The sampler pads every bucket of a rung to ``cap``
    rows whose pad ids are ``cap = n_rows`` (ROADMAP Queue 3 check (a)):
    with ``sink`` the scatter goes into ``n_rows + 1`` rows and the last
    one, the sink that takes the pads, is sliced away — no host sync, and
    shapes stay a pure function of the rung."""
    base = agg_fn or mean_aggregate_padded
    return _bucketed(lambda p, h_src, row_ids, nbr, mask: base(h_src, nbr,
                                                                mask),
                     {}, (h_src,), buckets, (n_rows + sink, h_src.shape[-1]),
                     h_src.dtype, n_rows)


def mean_aggregate_csr(h_src: torch.Tensor, seg: torch.Tensor,
                       idx: torch.Tensor, n_nodes: int,
                       sink: bool = False,
                       hot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean NA over a flat edge list (the DGL-faithful baseline):
    ``segment_sum(h_src[idx], seg) / max(count, 1)``.  The sum is the
    fixed-order ``segment_sum`` (the CPU's plain version or the card's
    kernel, by the device alone, as the reference's ``csr`` arm is the same
    under both values of ``use_pallas``), so the arm gives the same bits on
    every run, and cached == uncached holds bitwise on the card too.
    ``sink``: the sampled edge lists' pad edges name segment ``n_nodes``
    (a sorted suffix, so the kernel's bound search still holds), summed
    into one more segment that is sliced away.  ``hot`` is the residency
    arm: ``idx`` addresses ``concat(h_src, h_src[hot])`` and a cache index
    ``v >= M`` reads ``h_src[hot[v - M]]``, the row the cache section
    would hold, so no extended pool is built."""
    out = ops.segment_sum(h_src, seg, n_nodes + sink, idx=idx, mean=True,
                          hot=hot)
    return out[:n_nodes] if sink else out


def csr_to_edges(indptr: np.ndarray,
                 indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: CSR -> (segment_ids, indices) flat edge list."""
    degrees = np.diff(indptr)
    seg = np.repeat(np.arange(len(degrees), dtype=np.int32), degrees)
    return seg, indices.astype(np.int32)
