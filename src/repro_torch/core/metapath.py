"""Subgraph Build (stage 1 of the paper's four-stage HGNN semantic).

Port note: a copy of ``src/repro/core/metapath.py`` (numpy/scipy only).
It is copied, not imported, because importing any ``repro.core``
module pulls in jax; the tests hold the outputs of the two copies
byte-equal.

Runs on the host (numpy/scipy) before inference — exactly as the paper
observes for DGL.  Produces device-ready layouts:

* ``PaddedSubgraph`` — degree-capped padded neighbor lists ``[N, K]``.  This is
  the TPU adaptation of the GPU's CSR SpMM: irregular gather becomes a dense
  blocked gather + masked reduction (reduction tree) that tiles into VMEM.
* ``CSRSubgraph`` — flat CSR (indptr/indices) for the segment-sum execution
  path (the DGL-faithful baseline we characterize).
* ``InstanceBatch`` — MAGNN metapath *instances* (node id per path position),
  sampled with a per-node cap.

Stacking: HAN/MAGNN aggregate per metapath then across metapaths.  The
baseline keeps one subgraph per metapath (and the Semantic Aggregation stage
pays the paper's DR-Type concat); the optimized path stacks all subgraphs into
``[P, N, K]`` up front (inter-subgraph parallelism, guideline §5) so no
rearrangement ever happens on device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as sp

from repro_torch.core.hgraph import HeteroGraph, metapath_adjacency


@dataclass
class PaddedSubgraph:
    """Degree-capped padded neighbor layout for one metapath subgraph."""

    nbr: np.ndarray  # [N, K] int32 neighbor ids (0-padded)
    mask: np.ndarray  # [N, K] float32 {0,1}
    node_path: List[str]

    @property
    def n_nodes(self) -> int:
        return self.nbr.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbr.shape[1]


@dataclass
class DegreeBuckets:
    """Degree-bucketed padded layout: rows binned into a few K-caps.

    One ``K = max_degree`` pad wastes reduction-tree steps on every
    low-degree row (power-law graphs: most rows).  Binning rows into 2-3
    buckets with per-bucket caps ``K_b`` cuts the padded edge count
    (``sum_b n_b * K_b`` vs ``N * K``) while keeping each bucket a dense
    TPU-friendly ``[n_b, K_b]`` tile.  ``row_ids[b]`` maps bucket rows back
    to the original node order (the NA dispatch scatters outputs through it).
    Empty buckets are dropped at build time.
    """

    row_ids: List[np.ndarray]  # per bucket: [n_b] int32 original row ids
    nbr: List[np.ndarray]  # per bucket: [n_b, K_b] int32
    mask: List[np.ndarray]  # per bucket: [n_b, K_b] float32
    n_nodes: int
    node_path: List[str]

    @property
    def n_buckets(self) -> int:
        return len(self.row_ids)

    @property
    def padded_edges(self) -> int:
        return sum(nb.size for nb in self.nbr)


@dataclass
class CSRSubgraph:
    indptr: np.ndarray  # [N+1] int32
    indices: np.ndarray  # [nnz] int32
    node_path: List[str]

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1


@dataclass
class InstanceBatch:
    """MAGNN metapath instances: ``nodes[i, j]`` = node id at position j of
    instance i (position 0 = target).  ``types`` gives the node type per
    position.  Instances are grouped per target: ``[N, I, L+1]`` with mask.
    """

    nodes: np.ndarray  # [N, I, L+1] int32
    mask: np.ndarray  # [N, I] float32
    types: List[str]


def build_padded(
    hg: HeteroGraph,
    node_path: Sequence[str],
    max_degree: int = 64,
    rng: Optional[np.random.Generator] = None,
    add_self_loop: bool = True,
) -> PaddedSubgraph:
    adj = metapath_adjacency(hg, list(node_path))
    if add_self_loop:
        adj = (adj + sp.eye(adj.shape[0], adj.shape[1], format="csr")).tocsr()
        adj.data = np.ones_like(adj.data)
    rng = rng or np.random.default_rng(0)
    n = adj.shape[0]
    nbr = np.zeros((n, max_degree), np.int32)
    mask = np.zeros((n, max_degree), np.float32)
    indptr, indices = adj.indptr, adj.indices
    for u in range(n):
        nbrs = indices[indptr[u] : indptr[u + 1]]
        if len(nbrs) > max_degree:
            nbrs = rng.choice(nbrs, size=max_degree, replace=False)
        k = len(nbrs)
        nbr[u, :k] = nbrs
        mask[u, :k] = 1.0
    return PaddedSubgraph(nbr, mask, list(node_path))


def bucket_padded(
    sub: PaddedSubgraph, n_buckets: int = 3, round_to: int = 8
) -> DegreeBuckets:
    """Bin a padded subgraph's rows into ``n_buckets`` degree buckets.

    Caps are degree quantiles rounded up to a multiple of ``round_to`` (lane
    friendliness); the last cap is always ``max_degree`` so no edge is
    dropped.  Duplicate caps collapse, so fewer buckets than requested can
    come back (e.g. a degree-uniform graph yields one).
    """
    deg = sub.mask.sum(axis=1).astype(np.int64)  # [N]
    caps: List[int] = []
    for i in range(1, n_buckets):
        q = int(np.ceil(np.quantile(deg, i / n_buckets))) if len(deg) else 1
        caps.append(max(round_to, int(np.ceil(max(q, 1) / round_to)) * round_to))
    caps.append(sub.max_degree)
    caps = sorted(set(min(c, sub.max_degree) for c in caps))
    row_ids, nbrs, masks = [], [], []
    assigned = np.zeros(sub.n_nodes, bool)
    for cap in caps:
        rows = np.flatnonzero(~assigned & (deg <= cap))
        assigned[rows] = True
        if len(rows) == 0:
            continue
        row_ids.append(rows.astype(np.int32))
        nbrs.append(sub.nbr[rows, :cap])
        masks.append(sub.mask[rows, :cap])
    return DegreeBuckets(row_ids, nbrs, masks, sub.n_nodes, sub.node_path)


def build_degree_bucketed(
    hg: HeteroGraph,
    node_path: Sequence[str],
    max_degree: int = 64,
    n_buckets: int = 3,
    rng: Optional[np.random.Generator] = None,
) -> DegreeBuckets:
    """Subgraph Build straight into the degree-bucketed layout."""
    return bucket_padded(build_padded(hg, node_path, max_degree, rng),
                         n_buckets=n_buckets)


def build_csr(
    hg: HeteroGraph, node_path: Sequence[str], add_self_loop: bool = True
) -> CSRSubgraph:
    adj = metapath_adjacency(hg, list(node_path))
    if add_self_loop:
        adj = (adj + sp.eye(adj.shape[0], adj.shape[1], format="csr")).tocsr()
        adj.data = np.ones_like(adj.data)
    return CSRSubgraph(
        adj.indptr.astype(np.int32), adj.indices.astype(np.int32), list(node_path)
    )


def stack_padded(subgraphs: List[PaddedSubgraph]) -> "tuple[np.ndarray, np.ndarray]":
    """Stack P subgraphs (same target type) into [P, N, Kmax] — the optimized
    inter-subgraph-parallel layout (no device-side concat)."""
    n = subgraphs[0].n_nodes
    kmax = max(s.max_degree for s in subgraphs)
    p = len(subgraphs)
    nbr = np.zeros((p, n, kmax), np.int32)
    mask = np.zeros((p, n, kmax), np.float32)
    for i, s in enumerate(subgraphs):
        assert s.n_nodes == n, "stacked subgraphs must share the target node set"
        nbr[i, :, : s.max_degree] = s.nbr
        mask[i, :, : s.max_degree] = s.mask
    return nbr, mask


def enumerate_instances(
    hg: HeteroGraph,
    node_path: Sequence[str],
    max_instances: int = 16,
    max_fanout: int = 8,
    rng: Optional[np.random.Generator] = None,
    max_frontier: int = 2_000_000,
) -> InstanceBatch:
    """Sample metapath instances per target node (MAGNN Subgraph Build).

    Full enumeration explodes combinatorially (e.g. DBLP A-P-V-P-A through a
    20-venue hub); MAGNN implementations sample, and so do we.  Fully
    vectorized BFS expansion (no per-row Python loop): per hop each partial
    instance extends by its first ``max_fanout`` CSR neighbors; the frontier
    is down-sampled to ``max_frontier`` rows between hops; a vectorized
    per-target reservoir keeps ``max_instances`` instances.
    """
    rng = rng or np.random.default_rng(0)
    path = list(node_path)
    n_tgt = hg.node_counts[path[0]]
    frontier = np.arange(n_tgt, dtype=np.int64)[:, None]
    for a, b in zip(path[:-1], path[1:]):
        adj = hg.rel(a, b).tocsr()
        rows = frontier[:, -1]
        indptr, indices = adj.indptr, adj.indices
        take = np.minimum(indptr[rows + 1] - indptr[rows], max_fanout)
        total = int(take.sum())
        if total == 0:
            frontier = np.zeros((0, frontier.shape[1] + 1), np.int64)
            break
        rep = np.repeat(np.arange(len(frontier)), take)
        offs = np.arange(total) - np.repeat(np.cumsum(take) - take, take)
        nxt = indices[indptr[rows][rep] + offs].astype(np.int64)
        frontier = np.concatenate([frontier[rep], nxt[:, None]], axis=1)
        if len(frontier) > max_frontier:  # hub-explosion guard
            pick = rng.choice(len(frontier), max_frontier, replace=False)
            frontier = frontier[pick]

    L = len(path)
    nodes = np.zeros((n_tgt, max_instances, L), np.int32)
    mask = np.zeros((n_tgt, max_instances), np.float32)
    if len(frontier):
        frontier = frontier[rng.permutation(len(frontier))]
        order = np.argsort(frontier[:, 0], kind="stable")
        f = frontier[order]
        tgt = f[:, 0]
        counts = np.bincount(tgt, minlength=n_tgt)
        starts = np.cumsum(counts) - counts
        pos = np.arange(len(f)) - np.repeat(starts, counts)
        keep = pos < max_instances
        kept, kpos = f[keep], pos[keep]
        nodes[kept[:, 0], kpos] = kept
        mask[kept[:, 0], kpos] = 1.0
    return InstanceBatch(nodes, mask, path)
