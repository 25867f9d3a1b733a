"""MAGNN — Metapath Aggregated GNN (Fu et al., WWW'20); port of
``repro/core/models/magnn.py``.

Stages (paper Table 1): Metapath Walk | Linear | GAT | Attention Sum.
Unlike HAN, Neighbor Aggregation operates on metapath *instances*: every
instance is encoded from the projected features of ALL nodes along the
path (relational-rotation encoder), then attention aggregates the
instances per target.  Instance enumeration is sampled (a cap per target
node), as in the reference.

Execution is a :class:`StagePlan` with NA layout ``instances`` run by the
stage-graph executor (:mod:`repro_torch.core.pipeline`); the per-position
node types ride the plan (``metapaths``), so the batch holds arrays only.
``cfg.use_pallas`` runs the unstacked ``gat_na`` kernel over the encoded
instances; ``cfg.cache_rows`` turns on hot-feature residency, whose
single-device instance gathers go through the ``cached_gather`` kernel;
``cfg.partitions >= 1`` declares graph-partitioned execution over ``K``
partitions; ``cfg.fanout >= 1`` declares the plan's ``SampleSpec`` for
request-path serving (:mod:`repro_torch.serve`); ``cfg.overlap >= 1``
declares the async stage-graph schedule (``ScheduleSpec(depth=
cfg.overlap)``: one NA stage a metapath, partitioned NA split at the
gather, serving's sampler prefetch).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import HGNNConfig
from repro_torch.core import metapath as mp
from repro_torch.core.hgraph import HeteroGraph
from repro_torch.core.pipeline import PlannedModel
from repro_torch.core.plan import (INSTANCE_BATCH_SPECS,
                                   PARTITION_BATCH_SPECS, FPSpec, HeadSpec,
                                   LayerPlan, NASpec,
                                   PartitionSpec, ResidencySpec, SASpec,
                                   SampleSpec, ScheduleSpec, StagePlan,
                                   default_sample_ladder)
from repro_torch.data.synthetic import DATASET_METAPATHS, DATASET_TARGET
from repro_torch.interop import resolve_device


class MAGNN(PlannedModel):
    def __init__(self, cfg: HGNNConfig):
        super().__init__(cfg)
        self.metapaths = DATASET_METAPATHS[cfg.dataset]
        self.target = DATASET_TARGET[cfg.dataset]

    def plan(self) -> StagePlan:
        cfg = self.cfg
        part = (PartitionSpec(k=cfg.partitions) if cfg.partitions >= 1
                else None)
        na = NASpec(kind="instance", layout="instances", activation="elu",
                    use_pallas=cfg.use_pallas)
        sa = SASpec(kind="attention", stacked=False)
        # instance gathers touch every metapath position's type, so hidden
        # layers carry the non-target positions forward from this layer's
        # FP (handoff="target+carry") and re-project all of them ([D, D]
        # per type) before the next round of gathers
        carry = tuple(sorted({ty for p in self.metapaths for ty in p}
                             - {self.target}))
        sample = None
        if cfg.fanout >= 1:
            # instances per target are the MAGNN fan-out knob; every kept
            # instance pulls its full node path into the frontier
            k = min(cfg.fanout, cfg.max_instances)
            width = (len(self.metapaths) * k
                     * max(len(p) for p in self.metapaths))
            sample = SampleSpec(
                fanout=cfg.fanout,
                ladder=(cfg.sample_ladder
                        or default_sample_ladder(cfg.fanout, width,
                                                 cfg.layers)),
                seed=cfg.seed)
        residency = (ResidencySpec(cache_rows=cfg.cache_rows)
                     if cfg.cache_rows >= 1 else None)
        return StagePlan(
            model="magnn",
            target=self.target,
            layers=tuple(
                LayerPlan(fp=FPSpec(kind="per_type", sharded=False),
                          na=na, sa=sa, handoff="target+carry", carry=carry,
                          residency=residency)
                for _ in range(cfg.layers)),
            head=HeadSpec(kind="linear"),
            metapaths=tuple(tuple(p) for p in self.metapaths),
            batch_specs=(PARTITION_BATCH_SPECS if part is not None
                         else INSTANCE_BATCH_SPECS),
            partition=part,
            sample=sample,
            schedule=(ScheduleSpec(depth=cfg.overlap)
                      if cfg.overlap >= 1 else None),
        )

    # ---------------- Stage 1: Subgraph Build (host, sampled instances) ----
    def prepare(self, hg: HeteroGraph, device=None) -> Dict:
        """Sample the instance tables on the host — one
        ``np.random.default_rng(cfg.seed)`` over the metapaths in order, as
        in the reference, so they are byte-equal to its own — apply
        residency to them, and place the batch on ``device`` (default: the
        CUDA device)."""
        cfg = self.cfg
        dev = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        insts = [mp.enumerate_instances(hg, p, cfg.max_instances, rng=rng)
                 for p in self.metapaths]
        return self._finalize({
            "feats": dict(hg.features),
            "feat_dims": {t: hg.feat_dim(t) for t in hg.features},
            # node types per path position are static (plan.metapaths)
            "instances": [(ib.nodes, ib.mask) for ib in insts],
            "n_nodes": hg.node_counts[self.target],
        }, dev)
