"""GCN (Kipf & Welling) — the paper's GNN comparison baseline (§4.5, Fig.
5a); port of ``repro/core/models/gcn.py``.

Two stages only: Aggregation (mean over neighbors) + Combination (dense
matmul), on the homogeneous Reddit-like graph, to contrast with HAN's
metapath-scaled Neighbor Aggregation.

As a :class:`StagePlan`: FP is the first Combination (``x @ w1`` — mean
aggregation and the dense matmul commute), NA covers both aggregation
layers (two segment means over the edge list, the fixed-order
``segment_sum`` kernel on the card; GCN has no semantic stage:
``sa.kind="none"``), the head is the second Combination (``w2``).
``cfg.cache_rows`` turns on single-device hot-feature residency;
``cfg.fanout >= 1`` declares the plan's ``SampleSpec`` for request-path
serving; ``cfg.overlap >= 1`` declares the async stage-graph schedule
(one NA stage a layer, so nothing runs side by side; it drives the
serving sampler prefetch), and ``partitions`` raises the reference's
``ValueError``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import HGNNConfig
from repro_torch.core import metapath as mp
from repro_torch.core import stages
from repro_torch.core.hgraph import HeteroGraph
from repro_torch.core.pipeline import PlannedModel
from repro_torch.core.plan import (FPSpec, HeadSpec, LayerPlan, NASpec,
                                   ResidencySpec, SASpec, SampleSpec,
                                   ScheduleSpec, StagePlan,
                                   default_sample_ladder)
from repro_torch.data.synthetic import DATASET_TARGET
from repro_torch.interop import resolve_device


class GCN(PlannedModel):
    def __init__(self, cfg: HGNNConfig):
        super().__init__(cfg)
        self.target = DATASET_TARGET[cfg.dataset]

    def plan(self) -> StagePlan:
        cfg = self.cfg
        if cfg.partitions >= 1:
            raise ValueError("gcn runs the homogeneous CSR baseline; it has "
                             "no partitioned execution layout")
        sample = None
        if cfg.fanout >= 1:
            # each LayerPlan runs TWO csr aggregations -> 2 hops per layer
            sample = SampleSpec(
                fanout=cfg.fanout,
                ladder=(cfg.sample_ladder or default_sample_ladder(
                    cfg.fanout, cfg.fanout, 2 * cfg.layers)),
                seed=cfg.seed)
        residency = (ResidencySpec(cache_rows=cfg.cache_rows)
                     if cfg.cache_rows >= 1 else None)
        # one LayerPlan = one agg(relu(agg(h @ w))) block (the paper's
        # 2-conv GCN); extra layers stack that block with fresh [D, D]
        # combination weights before the classifier head
        return StagePlan(
            model="gcn",
            target=self.target,
            layers=tuple(
                LayerPlan(fp=FPSpec(kind="dense", sharded=False),
                          na=NASpec(kind="gcn", layout="csr",
                                    activation="relu"),
                          sa=SASpec(kind="none"), handoff="target",
                          residency=residency)
                for _ in range(cfg.layers)),
            head=HeadSpec(kind="linear", param="w2"),
            sample=sample,
            schedule=(ScheduleSpec(depth=cfg.overlap)
                      if cfg.overlap >= 1 else None),
        )

    def prepare(self, hg: HeteroGraph, device=None) -> Dict:
        """The target type's CSR (self-loops added) as a sorted ``(seg,
        idx)`` edge list, byte-equal to the reference's, with residency
        applied, placed on ``device`` (default: the CUDA device)."""
        dev = resolve_device(device)
        t = self.target
        csr = mp.build_csr(hg, [t, t])
        seg, idx = stages.csr_to_edges(csr.indptr, csr.indices)
        return self._finalize({
            "x": hg.features[t],
            "seg": seg,
            "idx": idx,
            "n_nodes": hg.node_counts[t],
            "feat_dim": hg.feat_dim(t),
        }, dev)
