"""HGNN configuration (port of ``repro/configs/base.py:HGNNConfig``).

Field names, defaults and ``__post_init__`` equal the reference's, so one
set of keyword arguments builds the same model in both packages (a test
holds them equal).  ``use_pallas`` keeps its name and means "run the
hand-written kernels": the Hopper CUDA kernels of ``repro_torch/kernels``
in place of the TPU's Pallas kernels.  The LM ``ModelConfig`` of the
reference is not ported yet (ROADMAP Queue 1 item 17).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class HGNNConfig:
    model: str = "han"  # rgcn | han | magnn | gcn
    dataset: str = "imdb"  # imdb | acm | dblp | reddit
    hidden: int = 64
    n_classes: int = 8
    n_heads: int = 8  # GAT heads in Neighbor Aggregation
    attn_hidden: int = 128  # semantic-attention hidden dim
    max_degree: int = 64  # padded-neighbor cap (dense [N, K] layout)
    max_instances: int = 16  # MAGNN instances sampled per target node
    # Optimized execution path: stacked subgraphs (inter-subgraph
    # parallelism), concat-free SA, optionally the hand-written kernels.
    fused: bool = False
    # Hand-written kernels (Hopper CUDA) on the hot loop; the name is the
    # reference's, where it selects the Pallas kernels.
    use_pallas: bool = False
    # Degree-bucketed padded NA layout (>1); ported for RGCN, not for HAN.
    degree_buckets: int = 0
    # Fused NA→SA epilogue: the semantic-score pass-1 partial accumulates
    # inside the NA kernel, saving one full [P, N, D] read.  Stacked only.
    fuse_na_sa: bool = False
    # Graph-partitioned execution (>= 1); not ported yet.
    partitions: int = 0
    # Stacked FP->NA->SA layers; the graph-side index tables are built once.
    layers: int = 1
    # Request-path sampled serving (>= 1); not ported yet.
    fanout: int = 0
    sample_ladder: Tuple[Tuple[int, int], ...] = ()
    # Hot-feature residency (>= 1); not ported yet.
    cache_rows: int = 0
    # Async stage-graph schedule (>= 1); not ported yet.
    overlap: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.layers < 1:
            raise ValueError(
                f"HGNNConfig.layers must be >= 1 (got {self.layers})")

    def replace(self, **kw) -> "HGNNConfig":
        return dataclasses.replace(self, **kw)
