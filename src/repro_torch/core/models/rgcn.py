"""R-GCN — Relational GCN (Schlichtkrull et al., ESWC'18); port of
``repro/core/models/rgcn.py``.

Stages (paper Table 1): Relation Walk | per-relation Linear | Mean | Sum.
The early-stage HGNN: Semantic Aggregation is a plain sum (Reduce kernel,
memory-bound only — §4.4 of the paper).

Updates every node type: h'_d = relu(W_0 h_d + Σ_{r: s->d} mean_{N_r}(h_s) W_r).

Execution is a :class:`StagePlan` run by the stage-graph executor
(:mod:`repro_torch.core.pipeline`): NA layout ``csr`` (baseline),
``padded`` (``cfg.fused``), or ``bucketed`` (``cfg.degree_buckets > 1``);
``cfg.use_pallas`` runs the hand-written ``segment_spmm`` kernel on the
padded and bucketed layouts; ``cfg.cache_rows`` turns on hot-feature
residency; ``cfg.partitions >= 1`` declares graph-partitioned execution
over ``K`` partitions (padded layout only); ``cfg.fanout >= 1`` declares
the plan's ``SampleSpec`` for request-path serving; ``cfg.overlap >=
1`` declares the async stage-graph schedule (``ScheduleSpec(depth=
cfg.overlap)``: partitioned NA split at the gather, serving's sampler
prefetch).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.configs.base import HGNNConfig
from repro_torch.core import metapath as mp
from repro_torch.core import stages
from repro_torch.core.hgraph import HeteroGraph
from repro_torch.core.pipeline import PlannedModel
from repro_torch.core.plan import (PARTITION_BATCH_SPECS,
                                   RELATION_BATCH_SPECS, FPSpec, HeadSpec,
                                   LayerPlan, NASpec,
                                   PartitionSpec, ResidencySpec, SASpec,
                                   SampleSpec, ScheduleSpec, StagePlan,
                                   default_sample_ladder)
from repro_torch.data.synthetic import DATASET_TARGET
from repro_torch.interop import resolve_device


class RGCN(PlannedModel):
    def __init__(self, cfg: HGNNConfig):
        super().__init__(cfg)
        self.target = DATASET_TARGET[cfg.dataset]
        self.rel_keys: List[Tuple[str, str, str]] = []

    def plan(self) -> StagePlan:
        cfg = self.cfg
        if not cfg.fused:
            layout = "csr"
        elif cfg.degree_buckets > 1:
            layout = "bucketed"
        else:
            layout = "padded"
        part = None
        if cfg.partitions >= 1:
            if layout != "padded":
                raise ValueError(
                    "partitioned RGCN execution needs the padded per-relation "
                    f"layout (fused=True, no degree buckets); got {layout!r}")
            part = PartitionSpec(k=cfg.partitions)
        na = NASpec(kind="mean", layout=layout, use_pallas=cfg.use_pallas)
        sample = None
        if cfg.fanout >= 1:
            # the relation count is graph-side (plan() has no hg); size the
            # auto ladder for a nominal 4 relations — the sampler clamps
            # per-type and counts any truncation
            k = min(cfg.fanout, cfg.max_degree)
            sample = SampleSpec(
                fanout=cfg.fanout,
                ladder=(cfg.sample_ladder or default_sample_ladder(
                    cfg.fanout, 4 * k, cfg.layers)),
                seed=cfg.seed)
        residency = (ResidencySpec(cache_rows=cfg.cache_rows)
                     if cfg.cache_rows >= 1 else None)
        # rel_sum SA updates EVERY node type (handoff="all"); hidden layers
        # need no FP — the per-layer w_rel / w_self matmuls inside NA/SA are
        # the layer's linear transform (h' = relu(W_0 h + sum mean(h_s) W_r))
        return StagePlan(
            model="rgcn",
            target=self.target,
            layers=tuple(
                LayerPlan(
                    fp=(FPSpec(kind="per_type", sharded=True) if l == 0
                        else FPSpec(kind="identity")),
                    na=na, sa=SASpec(kind="rel_sum"), handoff="all",
                    residency=residency)
                for l in range(cfg.layers)),
            head=HeadSpec(kind="select_linear", target=self.target),
            batch_specs=(PARTITION_BATCH_SPECS if part is not None
                         else RELATION_BATCH_SPECS),
            partition=part,
            sample=sample,
            schedule=(ScheduleSpec(depth=cfg.overlap)
                      if cfg.overlap >= 1 else None),
        )

    # ---------------- Stage 1: Relation Walk (host) ----------------
    def prepare(self, hg: HeteroGraph, device=None) -> Dict:
        """Build the per-relation incoming-neighbour tables on the host,
        apply residency to them, and place the batch on ``device``
        (default: the CUDA device).  One
        ``np.random.default_rng(cfg.seed)`` runs over the sorted relation
        keys, as in the reference, so rows over the degree cap draw the
        same neighbours and every table is byte-equal to the reference's:
        ``(nbr, mask)`` padded, a list of ``(row_ids, nbr, mask)`` buckets,
        or the ``(seg, idx)`` edge list of the ``csr`` baseline."""
        cfg = self.cfg
        dev = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        self.rel_keys = sorted(hg.relations.keys())
        batch: Dict = {
            "feats": dict(hg.features),
            "counts": dict(hg.node_counts),
            "feat_dims": {ty: hg.feat_dim(ty) for ty in hg.features},
            "rels": {},
        }
        for key in self.rel_keys:
            s, _, d = key
            # incoming edges to type d from type s
            adj_in = hg.relations[key].T.tocsr()
            if not cfg.fused:
                seg, idx = stages.csr_to_edges(adj_in.indptr, adj_in.indices)
                batch["rels"][key] = (seg, idx)
                continue
            nbr = np.zeros((adj_in.shape[0], cfg.max_degree), np.int32)
            mask = np.zeros((adj_in.shape[0], cfg.max_degree), np.float32)
            indptr, indices = adj_in.indptr, adj_in.indices
            for u in range(adj_in.shape[0]):
                nbrs = indices[indptr[u]: indptr[u + 1]]
                if len(nbrs) > cfg.max_degree:
                    nbrs = rng.choice(nbrs, cfg.max_degree, replace=False)
                nbr[u, : len(nbrs)] = nbrs
                mask[u, : len(nbrs)] = 1.0
            if cfg.degree_buckets > 1:
                # same quantile K-caps as HAN's buckets, copied back to node
                # order through row_ids
                bk = mp.bucket_padded(mp.PaddedSubgraph(nbr, mask, [s, d]),
                                      cfg.degree_buckets)
                batch["rels"][key] = [
                    (bk.row_ids[i], bk.nbr[i], bk.mask[i])
                    for i in range(bk.n_buckets)]
            else:
                batch["rels"][key] = (nbr, mask)
        return self._finalize(batch, dev)
