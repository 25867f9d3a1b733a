"""HAN — Heterogeneous Graph Attention Network (Wang et al., WWW'19); port
of ``repro/core/models/han.py``.

Stages (paper Table 1): Metapath Walk | Linear Transformation | GAT |
Attention Sum.  Execution is a :class:`StagePlan` run by the stage-graph
executor (:mod:`repro_torch.core.pipeline`); this module owns the
host-side Subgraph Build and the plan.

Layouts, as in the reference:

* baseline (``cfg.fused=False``): ``csr`` — one edge list a metapath,
  separate kernels (SDDMM, segment max, segment softmax, SpMM; the sums
  are the fixed-order ``segment_sum`` kernel on the card), SA pays the
  DR-Type concat;
* optimized (``cfg.fused=True``): ``stacked`` ``[P, N, K]``, or
  ``bucketed`` when ``cfg.degree_buckets > 1``.  ``cfg.use_pallas`` runs
  the hand-written ``gat_na`` kernel (one launch for the stack, or one a
  degree bucket); ``cfg.fuse_na_sa`` fuses the SA pass-1 epilogue into it
  (stacked only).

``cfg.cache_rows`` turns on hot-feature residency; ``cfg.partitions >= 1``
declares graph-partitioned execution over ``K`` partitions (stacked
layout only, with the epilogue off); ``cfg.fanout >= 1`` declares the
plan's ``SampleSpec`` for request-path serving (:mod:`repro_torch.serve`).
``cfg.overlap >= 1`` declares the async stage-graph schedule
(``ScheduleSpec(depth=cfg.overlap)``): ``forward_overlapped`` runs the
``bucketed`` and ``csr`` layouts' metapaths as stages of their own and
splits partitioned NA at the gather, and serving prefetches the next
step's sample.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import HGNNConfig
from repro_torch.core import metapath as mp
from repro_torch.core import stages
from repro_torch.core.hgraph import HeteroGraph
from repro_torch.core.pipeline import PlannedModel
from repro_torch.core.plan import (BUCKETED_BATCH_SPECS,
                                   PARTITION_BATCH_SPECS,
                                   STACKED_BATCH_SPECS, FPSpec, HeadSpec,
                                   LayerPlan, NASpec, PartitionSpec,
                                   ResidencySpec, SASpec, SampleSpec,
                                   ScheduleSpec, StagePlan,
                                   default_sample_ladder)
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
            layout = "csr"
        elif cfg.degree_buckets > 1:
            layout = "bucketed"
        else:
            layout = "stacked"
        part = None
        if cfg.partitions >= 1:
            if layout != "stacked":
                raise ValueError(
                    "partitioned HAN execution needs the stacked layout "
                    "(fused=True, no degree buckets); got "
                    f"layout={layout!r}")
            part = PartitionSpec(k=cfg.partitions)
        na = NASpec(kind="gat", layout=layout, activation="elu",
                    use_pallas=cfg.use_pallas)
        # the epilogue's score mean needs the single-table stack
        sa = SASpec(kind="attention", stacked=cfg.fused,
                    fuse_epilogue=(cfg.fuse_na_sa and layout == "stacked"
                                   and part is None))
        sample = None
        if cfg.fanout >= 1:
            # per-hop width: every metapath contributes up to the padded
            # table's effective fan-out per target row
            k = min(cfg.fanout, cfg.max_degree)
            sample = SampleSpec(
                fanout=cfg.fanout,
                ladder=(cfg.sample_ladder or default_sample_ladder(
                    cfg.fanout, len(self.metapaths) * k, cfg.layers)),
                seed=cfg.seed)
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
            batch_specs=(PARTITION_BATCH_SPECS if part is not None
                         else BUCKETED_BATCH_SPECS if layout == "bucketed"
                         else STACKED_BATCH_SPECS),
            partition=part,
            sample=sample,
            schedule=(ScheduleSpec(depth=cfg.overlap)
                      if cfg.overlap >= 1 else None),
        )

    # ---------------- Stage 1: Subgraph Build (host) ----------------
    def prepare(self, hg: HeteroGraph, device=None) -> Dict:
        """Build the layout's tables on the host, apply residency to them,
        partition it when the plan says so, and place the batch on
        ``device`` (default: the CUDA device): the
        stacked ``[P, N, K]`` neighbor tables, per metapath a list of
        ``(row_ids, nbr, mask)`` degree buckets, or per metapath the
        ``(seg, idx)`` edge list of its CSR subgraph.  The padded tables
        draw from one ``np.random.default_rng(cfg.seed)`` over the
        metapaths, as in the reference, so every table is byte-equal to
        its own."""
        cfg = self.cfg
        dev = resolve_device(device)
        batch: Dict = {"feats": dict(hg.features),
                       "n_nodes": hg.node_counts[self.target]}
        if cfg.fused:
            rng = np.random.default_rng(cfg.seed)
            subs = [mp.build_padded(hg, p, cfg.max_degree, rng)
                    for p in self.metapaths]
            if cfg.degree_buckets > 1:
                batch["buckets"] = [
                    [(b.row_ids[i], b.nbr[i], b.mask[i])
                     for i in range(b.n_buckets)]
                    for b in (mp.bucket_padded(s, cfg.degree_buckets)
                              for s in subs)]
            else:
                batch["nbr"], batch["mask"] = mp.stack_padded(subs)
        else:
            batch["edges"] = []
            for p in self.metapaths:
                csr = mp.build_csr(hg, p)
                batch["edges"].append(stages.csr_to_edges(csr.indptr,
                                                          csr.indices))
        batch["feat_dims"] = {t: hg.feat_dim(t) for t in hg.features}
        return self._finalize(batch, dev)
