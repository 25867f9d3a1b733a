"""Heterogeneous graph container (host side).

Port note: a copy of ``src/repro/core/hgraph.py`` (numpy/scipy only).
It is copied, not imported, because importing any ``repro.core``
module pulls in jax; the tests hold the outputs of the two copies
byte-equal.

A :class:`HeteroGraph` is the paper's HG: multiple node types, multiple edge
types (relations).  Relations are stored as ``scipy.sparse`` CSR adjacency
matrices with shape ``(n_src, n_dst)``.  All of *Subgraph Build* (metapath /
relation walk) happens on the host with scipy — matching the paper's
observation that Subgraph Build "is executed in CPU before inference phase".

Device-side layouts produced from this container live in
:mod:`repro_torch.core.metapath`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse as sp

Relation = Tuple[str, str, str]  # (src_type, rel_name, dst_type)


@dataclass
class HeteroGraph:
    # node type -> count
    node_counts: Dict[str, int]
    # node type -> [n_type, feat_dim] float32 raw features (per-type dims differ!)
    features: Dict[str, np.ndarray]
    # (src_type, rel_name, dst_type) -> csr (n_src, n_dst)
    relations: Dict[Relation, sp.csr_matrix]
    name: str = "hg"

    def rel(self, src: str, dst: str) -> sp.csr_matrix:
        """Find the (unique) relation src->dst by node types."""
        for (s, _, d), a in self.relations.items():
            if s == src and d == dst:
                return a
        raise KeyError(f"no relation {src}->{dst} in {self.name}")

    @property
    def n_edges(self) -> int:
        return int(sum(a.nnz for a in self.relations.values()))

    def feat_dim(self, t: str) -> int:
        return int(self.features[t].shape[1])

    def in_neighbors(self, key: Relation, u: int) -> np.ndarray:
        """Global source ids with an edge into destination node ``u`` under
        ``key`` — the request-path sampler's ground truth: every neighbor a
        sampled minibatch wires for (key, u) must be in this set."""
        adj_in = self.relations[key].T.tocsr()
        return adj_in.indices[adj_in.indptr[u]: adj_in.indptr[u + 1]]

    def validate(self) -> None:
        for (s, r, d), a in self.relations.items():
            assert a.shape == (self.node_counts[s], self.node_counts[d]), (
                f"relation {(s, r, d)} shape {a.shape} != "
                f"({self.node_counts[s]}, {self.node_counts[d]})"
            )
        for t, n in self.node_counts.items():
            assert self.features[t].shape[0] == n, t


def metapath_adjacency(hg: HeteroGraph, node_path: List[str]) -> sp.csr_matrix:
    """Adjacency of metapath-based neighbors: product of relation adjacencies.

    ``node_path`` is the node-type sequence, e.g. ``["M", "D", "M"]`` for the
    MDM metapath.  Returns a binarized csr of shape ``(n_t0, n_tL)``: entry
    (u, v) != 0 iff v is a metapath-based neighbor of u.
    """
    assert len(node_path) >= 2
    acc = hg.rel(node_path[0], node_path[1]).astype(np.float32)
    for a, b in zip(node_path[1:-1], node_path[2:]):
        acc = acc @ hg.rel(a, b).astype(np.float32)
        acc.data = np.minimum(acc.data, 1.0)  # binarize counts to reachability
    acc = acc.tocsr()
    acc.data = np.ones_like(acc.data)
    acc.eliminate_zeros()
    return acc


def sparsity(a: sp.csr_matrix) -> float:
    """Fraction of *zero* entries (the paper's Fig. 6a metric)."""
    return 1.0 - a.nnz / float(a.shape[0] * a.shape[1])
