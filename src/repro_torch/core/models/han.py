"""HAN — Heterogeneous Graph Attention Network (Wang et al., WWW'19); port
of ``repro/core/models/han.py``.

Stages (paper Table 1): Metapath Walk | Linear Transformation | GAT |
Attention Sum.  Execution is a :class:`StagePlan` run by the stage-graph
executor (:mod:`repro_torch.core.pipeline`); this module owns the
host-side Subgraph Build and the plan.

Ported: the optimized plan (``cfg.fused=True``), layout ``stacked``
``[P, N, K]``; ``cfg.use_pallas`` runs the hand-written ``gat_na`` kernel,
``cfg.fuse_na_sa`` fuses the SA pass-1 epilogue into it; ``cfg.cache_rows``
turns on single-device hot-feature residency.  The baseline ``csr`` layout
and the ``bucketed`` one, and the partitioned, sampled and overlap modes
raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import HGNNConfig
from repro_torch.core import metapath as mp
from repro_torch.core.hgraph import HeteroGraph
from repro_torch.core.pipeline import PlannedModel, not_ported
from repro_torch.core.plan import (FPSpec, HeadSpec, LayerPlan, NASpec,
                                   ResidencySpec, SASpec, StagePlan)
from repro_torch.data.synthetic import DATASET_METAPATHS, DATASET_TARGET
from repro_torch.interop import resolve_device


class HAN(PlannedModel):
    def __init__(self, cfg: HGNNConfig):
        super().__init__(cfg)
        self.metapaths = DATASET_METAPATHS[cfg.dataset]
        self.target = DATASET_TARGET[cfg.dataset]

    def plan(self) -> StagePlan:
        cfg = self.cfg
        if not cfg.fused:
            raise not_ported("HAN's baseline csr layout (fused=False)", 6)
        if cfg.degree_buckets > 1:
            raise not_ported("HAN's bucketed layout (degree_buckets > 1)", 6)
        if cfg.partitions >= 1:
            raise not_ported("graph-partitioned execution (partitions)", 12)
        if cfg.fanout >= 1:
            raise not_ported("request-path sampled serving (fanout)", 13)
        if cfg.overlap >= 1:
            raise not_ported("the async stage-graph schedule (overlap)", 14)
        na = NASpec(kind="gat", layout="stacked", activation="elu",
                    use_pallas=cfg.use_pallas)
        sa = SASpec(kind="attention", stacked=True,
                    fuse_epilogue=cfg.fuse_na_sa)
        residency = (ResidencySpec(cache_rows=cfg.cache_rows)
                     if cfg.cache_rows >= 1 else None)
        # layer 0 projects the raw per-type features; the metapath graphs
        # are target->target, so every hidden layer re-projects only the
        # previous SA output (a dense [D, D] matmul, reshaped to heads)
        return StagePlan(
            model="han",
            target=self.target,
            layers=tuple(
                LayerPlan(
                    fp=(FPSpec(kind="per_type", heads=True) if l == 0
                        else FPSpec(kind="dense", heads=True)),
                    na=na, sa=sa, handoff="target", residency=residency)
                for l in range(cfg.layers)),
            head=HeadSpec(kind="linear"),
            metapaths=tuple(tuple(p) for p in self.metapaths),
        )

    # ---------------- Stage 1: Subgraph Build (host) ----------------
    def prepare(self, hg: HeteroGraph, device=None) -> Dict:
        """Build the stacked ``[P, N, K]`` neighbor tables on the host (the
        reference's RNG stream, so the tables are byte-equal to its own),
        apply residency to them, and place the batch on ``device``
        (default: the CUDA device)."""
        cfg = self.cfg
        dev = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        subs = [mp.build_padded(hg, p, cfg.max_degree, rng)
                for p in self.metapaths]
        nbr, mask = mp.stack_padded(subs)
        return self._finalize({
            "feats": dict(hg.features),
            "n_nodes": hg.node_counts[self.target],
            "nbr": nbr,  # [P, N, K] int32
            "mask": mask,
            "feat_dims": {t: hg.feat_dim(t) for t in hg.features},
        }, dev)
