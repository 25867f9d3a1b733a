"""Synthetic heterogeneous graphs matching the paper's Table 2 statistics.

Port note: a copy of ``src/repro/data/synthetic.py`` (numpy/scipy only).
It is copied, not imported, because importing any ``repro.core``
module pulls in jax; the tests hold the outputs of the two copies
byte-equal.

No network access is available offline, so IMDB / ACM / DBLP are generated
randomly with the *exact* node counts, raw feature dimensions and relation
edge counts of Table 2, with power-law-ish degree distributions (real HGs are
heavy-tailed; degree skew is what drives the paper's "irregular memory access"
observation, so we preserve it).

Reddit (used in the paper only for the HAN-vs-GCN comparison, Fig. 5) is
generated at a configurable scale of the real 233k-node / 115M-edge graph —
the default 0.1 scale keeps CPU benchmark time sane while preserving the
average degree (~492).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse as sp

from repro_torch.core.hgraph import HeteroGraph, Relation


def _powerlaw_weights(n: int, rng: np.random.Generator, alpha: float = 1.3) -> np.ndarray:
    w = rng.pareto(alpha, size=n) + 1.0
    return w / w.sum()


def _random_bipartite(
    n_src: int, n_dst: int, n_edges: int, rng: np.random.Generator
) -> sp.csr_matrix:
    """Random bipartite edges with power-law dst popularity, deduplicated."""
    p_dst = _powerlaw_weights(n_dst, rng)
    # oversample then dedup to land close to the requested count
    m = int(n_edges * 1.3) + 16
    src = rng.integers(0, n_src, size=m)
    dst = rng.choice(n_dst, size=m, p=p_dst)
    key = src.astype(np.int64) * n_dst + dst
    _, idx = np.unique(key, return_index=True)
    idx = idx[:n_edges]
    a = sp.csr_matrix(
        (np.ones(len(idx), np.float32), (src[idx], dst[idx])),
        shape=(n_src, n_dst),
    )
    return a


def _features(counts: Dict[str, int], dims: Dict[str, int], rng) -> Dict[str, np.ndarray]:
    return {
        t: rng.standard_normal((counts[t], dims[t]), dtype=np.float32) * 0.1
        for t in counts
    }


def make_imdb(seed: int = 0) -> HeteroGraph:
    """IMDB: movie 4278 / director 2081 / actor 5257; M-D 4278, M-A 12828."""
    rng = np.random.default_rng(seed)
    counts = {"M": 4278, "D": 2081, "A": 5257}
    dims = {"M": 3066, "D": 2081, "A": 5257}
    md = _random_bipartite(counts["M"], counts["D"], 4278, rng)
    ma = _random_bipartite(counts["M"], counts["A"], 12828, rng)
    relations: Dict[Relation, sp.csr_matrix] = {
        ("M", "md", "D"): md,
        ("D", "dm", "M"): md.T.tocsr(),
        ("M", "ma", "A"): ma,
        ("A", "am", "M"): ma.T.tocsr(),
    }
    g = HeteroGraph(counts, _features(counts, dims, rng), relations, name="imdb")
    g.validate()
    return g


def make_acm(seed: int = 0) -> HeteroGraph:
    """ACM: author 5912 / paper 3025 / subject 57; P-A 9936, P-S 3025."""
    rng = np.random.default_rng(seed + 1)
    counts = {"A": 5912, "P": 3025, "S": 57}
    dims = {"A": 1902, "P": 1902, "S": 1902}
    pa = _random_bipartite(counts["P"], counts["A"], 9936, rng)
    ps = _random_bipartite(counts["P"], counts["S"], 3025, rng)
    relations: Dict[Relation, sp.csr_matrix] = {
        ("P", "pa", "A"): pa,
        ("A", "ap", "P"): pa.T.tocsr(),
        ("P", "ps", "S"): ps,
        ("S", "sp", "P"): ps.T.tocsr(),
    }
    g = HeteroGraph(counts, _features(counts, dims, rng), relations, name="acm")
    g.validate()
    return g


def make_dblp(seed: int = 0) -> HeteroGraph:
    """DBLP: author 4057 / paper 14328 / term 7723 / venue 20."""
    rng = np.random.default_rng(seed + 2)
    counts = {"A": 4057, "P": 14328, "T": 7723, "V": 20}
    dims = {"A": 334, "P": 14328, "T": 7723, "V": 20}
    pa = _random_bipartite(counts["P"], counts["A"], 19645, rng)
    pt = _random_bipartite(counts["P"], counts["T"], 85810, rng)
    pv = _random_bipartite(counts["P"], counts["V"], 14328, rng)
    relations: Dict[Relation, sp.csr_matrix] = {
        ("P", "pa", "A"): pa,
        ("A", "ap", "P"): pa.T.tocsr(),
        ("P", "pt", "T"): pt,
        ("T", "tp", "P"): pt.T.tocsr(),
        ("P", "pv", "V"): pv,
        ("V", "vp", "P"): pv.T.tocsr(),
    }
    g = HeteroGraph(counts, _features(counts, dims, rng), relations, name="dblp")
    g.validate()
    return g


def make_reddit_like(scale: float = 0.1, seed: int = 0) -> HeteroGraph:
    """Homogeneous Reddit-like graph (232,965 nodes / 114.6M edges / 602 feats)
    at ``scale``, preserving the ~492 average degree. Stored as a one-type HG
    so the same machinery runs GCN (paper's comparison baseline) and HAN.
    """
    rng = np.random.default_rng(seed + 3)
    n = max(64, int(232_965 * scale))
    avg_deg = 114_615_892 / 232_965
    n_edges = int(n * avg_deg * scale) if scale < 1.0 else 114_615_892
    n_edges = max(n * 4, min(n_edges, 4_000_000))  # CPU-tractable cap
    a = _random_bipartite(n, n, n_edges, rng)
    a = ((a + a.T) > 0).astype(np.float32).tocsr()  # symmetrize
    counts = {"N": n}
    feats = {"N": rng.standard_normal((n, 602), dtype=np.float32) * 0.1}
    g = HeteroGraph(counts, feats, {("N", "nn", "N"): a}, name="reddit")
    g.validate()
    return g


# Target node type + the standard HAN/MAGNN metapath sets per dataset.
DATASET_TARGET = {"imdb": "M", "acm": "P", "dblp": "A", "reddit": "N"}
DATASET_METAPATHS: Dict[str, List[List[str]]] = {
    "imdb": [["M", "D", "M"], ["M", "A", "M"]],
    "acm": [["P", "A", "P"], ["P", "S", "P"]],
    "dblp": [["A", "P", "A"], ["A", "P", "T", "P", "A"], ["A", "P", "V", "P", "A"]],
    "reddit": [["N", "N"]],
}


def make_dataset(name: str, seed: int = 0, scale: float = 0.1) -> HeteroGraph:
    if name == "imdb":
        return make_imdb(seed)
    if name == "acm":
        return make_acm(seed)
    if name == "dblp":
        return make_dblp(seed)
    if name == "reddit":
        return make_reddit_like(scale=scale, seed=seed)
    raise ValueError(f"unknown dataset {name}")
