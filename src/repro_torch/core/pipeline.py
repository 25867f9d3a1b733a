"""The stage-graph executor: one interpreter for every :class:`StagePlan`
(port of ``repro/core/pipeline.py``).

A plan is an L-layer stack of FP→NA→SA rounds; the executor loops them
with the per-type feature tables as the carried state over the
layer-invariant index tables built once in ``prepare()``.  Layer 0's
parameters live at the root of the parameter dict and hidden layers under
``params["layers"][l-1]`` with the same leaf names, as in the reference,
so the reference's own parameters carry across unchanged
(``repro_torch.interop.params_from_numpy``).

Ported arms — HAN (slices 1 and 9), RGCN (slice 2), MAGNN (slice 3) and
GCN (slice 9) inference over the full graph or over a sampled, rung-padded
minibatch of request-path serving (slice 11, ``plan.sample``), each with
hot-feature residency, and HAN, RGCN and MAGNN graph-partitioned over
``K`` partitions on one device (slice 12, ``plan.partition``):

* FP ``per_type`` (layer 0; reshaped to heads when ``fp.heads``), the
  ``dense`` re-projection of HAN's hidden layers with the ``target``
  handoff, the ``identity`` FP of RGCN's hidden layers with the ``all``
  handoff, MAGNN's ``per_type`` hidden FP over the carried tables with
  the ``target+carry`` handoff, and GCN's ``dense`` FP (``x @ w1``, then
  ``[D, D]`` per hidden layer);
* NA ``gat`` on the ``stacked`` ``[P, N, K]`` layout — plain, or ONE
  ``gat_na`` kernel launch for the whole stack (``na.use_pallas``), or that
  launch with the fused NA→SA epilogue (``sa.fuse_epilogue``); on the
  ``bucketed`` layout — plain, or one unstacked ``gat_na`` launch a degree
  bucket; on the ``csr`` edge lists — SDDMM, segment max, segment softmax
  and SpMM as separate steps, whose sums are the fixed-order
  ``segment_sum`` kernel on the card whatever ``na.use_pallas`` says (the
  reference's ``csr`` arm ignores it too);
* NA ``mean`` per relation on the ``padded``, ``bucketed`` and ``csr``
  layouts — with ``na.use_pallas`` the padded and bucketed arms launch the
  ``segment_spmm`` kernel (one launch per relation, per bucket); the
  ``csr`` arm is the ``segment_sum`` kernel's segment mean on the card;
* NA ``gcn``: ``agg(pool(relu(agg(pool(h)))))``, two segment means over
  GCN's edge list;
* NA ``instance`` on the ``instances`` layout (MAGNN): per metapath the
  positions' rows gathered, rotation-encoded and attended — plain, or one
  unstacked ``gat_na`` launch over the encoded instances;
* residency (``plan.residency``): the NA gathers read a pool extended by
  the cache section of the hot rows (``_res_pool``), and MAGNN's hot
  instance positions go through the ``cached_gather`` kernel;
* SA ``attention`` on the stack or on a list (MAGNN, HAN's ``csr``), or,
  after the fused epilogue, the O(P) softmax plus the ``semantic_combine``
  kernel (with the reference's closed-form ``row_mask`` correction for
  padded rows); SA ``rel_sum``; SA ``none`` (GCN);
* the ``linear`` and ``select_linear`` heads;
* sampled batches (``plan.sample``): the bucketed and edge-list arms drop
  the sampler's pad rows and pad edges into a sink row (``stages``), and
  SA keeps pad rows out of its score means through ``row_mask``;
* partitioned batches (``plan.partition``, :mod:`repro_torch.dist.
  partition`): FP projects each partition's owned rows
  (``[K, n_t, F_t] @ W_t``), the ``gather_halo`` stage appends each
  type's halo rows to its owned table (the flat gather; with residency,
  hot halo rows are selected from the partition-local cache instead), NA
  runs a partition at a time on ``concat(own, halo)`` through the same
  arm the unpartitioned layout takes — with ``na.use_pallas`` one
  stacked ``gat_na`` launch a partition (HAN), one ``segment_spmm``
  launch a relation and partition (RGCN), and one unstacked ``gat_na``
  launch a metapath over the encoded instances of every partition
  (MAGNN) — SA averages its scores in global row order, and the head
  restores global row order through the inverse permutation ``inv``.
  Each row is reduced in a fixed order whatever ``K`` is, so ``K = 1``
  gives the unpartitioned arm's bits;
* the async stage-graph schedule (slice 13, ``plan.schedule``):
  :meth:`~StageGraphExecutor.forward_overlapped` walks the plan's stage
  DAG (:meth:`~StageGraphExecutor.schedule_edges`) stage by stage through
  a bounded :class:`~repro_torch.kernels.streaming.InflightWindow`.  Where
  the serial forward loops metapaths (HAN ``bucketed`` and ``csr``,
  MAGNN), each metapath's NA is a stage of its own (``NA.p{i}``); a
  partitioned plan splits NA at the gather: ``NA.own`` pre-gathers the
  owned rows while ``gather_halo`` (the exchange alone) runs, and the
  merge NA selects the halo rows in and runs the serial arm's kernels on
  the merged rows.  Each stage is compiled once under the reference's
  jit key (``FP0``, ``NA.p0.1``, ``halo_exchange``, ...; a
  ``graphs.compiled`` wrapper kept in ``_ov_jit``), so on the card every
  stage replays a CUDA graph.  A sibling branch (``NA.p{i}`` for i > 0,
  ``NA.own``) is captured on a capture stream of its own and replays on
  a side stream of the executor's, ordered by CUDA events.  The split
  stages are row selections and elementwise rearrangements, so the
  logits are bitwise the serial forward's.

:func:`check_ported` accepts exactly HAN's, RGCN's, MAGNN's and GCN's
combinations of these arms.  Arms of later slices raise
``NotImplementedError`` naming their ROADMAP item, and combinations that
no model of the reference declares raise too; no arm is served by another
one.

On a device mesh (``dist.sharding.use_mesh``, DTensor parameters and
batch: ``launch/serve.build_hgnn_infer(mesh=...)``) the executor applies
the reference's ``shard`` constraints at its sites (FP ``:195-238``, the
fused epilogue ``:400-407``, the padded mean ``:437``, the instance NA
``:455-487``, the partitioned NA ``:543``, the stacked SA ``:766``) and
each NA arm runs on a rank's shards (``local``), so
every kernel call takes local tensors: NA's destination rows and
neighbour tables over the ``BATCH`` axes, its source pool whole on every
rank (with residency, extended there); a degree bucket's rows over
``BATCH``, its results gathered whole and copied to node order on every
rank; MAGNN's instance round on a rank's target rows; a partitioned plan
a rank's partitions (``K`` over ``BATCH``), its halo rows exchanged by
``dist.partition.gather_halo`` in the plan's ``halo`` mode, its SA and
head on the whole stack (the score means in global row order, as off the
mesh).  The fused epilogue's score means are averaged over the ranks in
rank order.  A plan with a schedule runs the serial :meth:`forward`
there, as the reference's does.  Off a mesh every constraint is a no-op
and every arm is the one-device one.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten

from repro_torch import graphs
from repro_torch.core import residency, semantics, stages
from repro_torch.core.plan import StagePlan
from repro_torch.dist import partition as dpart
from repro_torch.dist.sharding import (BATCH, MODEL, current_mesh,
                                       is_dtensor, lead_placements, local,
                                       replicate, shard, split_heads)
from repro_torch.dist.partition import HALO_MODES
from repro_torch.kernels import ops
from repro_torch.kernels.streaming import InflightWindow

_ACT = {None: lambda x: x, "elu": F.elu, "relu": F.relu}


def no_such_arm(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: no model of the reference declares this combination, so "
        "repro_torch has no arm for it")


def _fp_kinds(plan: StagePlan):
    return [(lp.fp.kind, lp.fp.heads) for lp in plan.layers]


def _check_han_arms(plan: StagePlan) -> None:
    layout, sa = plan.na.layout, plan.sa
    if layout not in ("stacked", "bucketed", "csr"):
        raise no_such_arm(f"GAT NA on the {layout!r} layout")
    # the csr arm hands SA a list; the fused epilogue is the stacked arm's
    if sa.stacked != (layout != "csr") or (sa.fuse_epilogue
                                           and layout != "stacked"):
        raise no_such_arm(f"SA (stacked={sa.stacked}, fuse_epilogue="
                          f"{sa.fuse_epilogue}) after GAT NA on the "
                          f"{layout!r} layout")
    if plan.sa.kind != "attention":
        raise no_such_arm(f"SA kind {plan.sa.kind!r} after GAT NA")
    fp_kinds = _fp_kinds(plan)
    if fp_kinds != [("per_type", True)] + [("dense", True)] * (
            plan.n_layers - 1) or plan.layers[0].handoff != "target":
        raise no_such_arm(f"GAT NA with FP kinds {fp_kinds} and handoff "
                          f"{plan.layers[0].handoff!r}")
    if plan.head.kind != "linear":
        raise no_such_arm(f"head kind {plan.head.kind!r} after GAT NA")


def _check_rgcn_arms(plan: StagePlan) -> None:
    if plan.na.layout not in ("padded", "bucketed", "csr"):
        raise no_such_arm(f"mean NA on the {plan.na.layout!r} layout")
    if plan.na.activation is not None:
        raise no_such_arm(f"mean NA with activation {plan.na.activation!r}")
    if plan.sa.kind != "rel_sum" or plan.sa.fuse_epilogue:
        raise no_such_arm(f"SA kind {plan.sa.kind!r} (fuse_epilogue="
                          f"{plan.sa.fuse_epilogue}) after mean NA")
    fp_kinds = _fp_kinds(plan)
    if fp_kinds != [("per_type", False)] + [("identity", False)] * (
            plan.n_layers - 1) or plan.layers[0].handoff != "all":
        raise no_such_arm(f"mean NA with FP kinds {fp_kinds} and handoff "
                          f"{plan.layers[0].handoff!r}")
    if plan.head.kind != "select_linear" or plan.head.target != plan.target:
        raise no_such_arm(f"head {plan.head} after mean NA")


def _check_magnn_arms(plan: StagePlan) -> None:
    if plan.na.layout != "instances" or plan.na.activation != "elu":
        raise no_such_arm(f"instance NA on the {plan.na.layout!r} layout "
                          f"with activation {plan.na.activation!r}")
    if plan.sa.kind != "attention" or plan.sa.stacked \
            or plan.sa.fuse_epilogue:
        raise no_such_arm(f"SA {plan.sa} after instance NA")
    fp_kinds = _fp_kinds(plan)
    if fp_kinds != [("per_type", False)] * plan.n_layers \
            or plan.layers[0].handoff != "target+carry":
        raise no_such_arm(f"instance NA with FP kinds {fp_kinds} and handoff "
                          f"{plan.layers[0].handoff!r}")
    if plan.head.kind != "linear":
        raise no_such_arm(f"head kind {plan.head.kind!r} after instance NA")


def _check_gcn_arms(plan: StagePlan) -> None:
    if plan.na.layout != "csr" or plan.na.activation != "relu":
        raise no_such_arm(f"GCN NA on the {plan.na.layout!r} layout with "
                          f"activation {plan.na.activation!r}")
    if plan.sa.kind != "none":
        raise no_such_arm(f"SA kind {plan.sa.kind!r} after GCN NA")
    fp_kinds = _fp_kinds(plan)
    if fp_kinds != [("dense", False)] * plan.n_layers \
            or plan.layers[0].handoff != "target":
        raise no_such_arm(f"GCN NA with FP kinds {fp_kinds} and handoff "
                          f"{plan.layers[0].handoff!r}")
    if plan.head.kind != "linear" or plan.head.param != "w2":
        raise no_such_arm(f"head {plan.head} after GCN NA")


# the NA layout that each NA kind partitions (``dist.partition_batch``)
_PARTITIONED_LAYOUTS = {"gat": "stacked", "mean": "padded",
                        "instance": "instances"}


def _check_partitioned(plan: StagePlan) -> None:
    kind, layout = plan.na.kind, plan.na.layout
    if _PARTITIONED_LAYOUTS.get(kind) != layout or plan.sa.fuse_epilogue:
        raise no_such_arm(f"graph-partitioned {kind} NA on the {layout!r} "
                          f"layout (fuse_epilogue={plan.sa.fuse_epilogue})")
    if plan.partition.halo not in HALO_MODES:
        raise ValueError(f"unknown halo mode {plan.partition.halo!r} "
                         f"(one of {HALO_MODES})")


def check_ported(plan: StagePlan) -> None:
    """Raise for any plan outside the ported slices (HAN's, RGCN's,
    MAGNN's and GCN's combinations of arms, each with or without
    residency, sampling and the async schedule, the first three also
    graph-partitioned), so that no arm is silently served by another
    one."""
    if plan.partition is not None:
        _check_partitioned(plan)
    kind = plan.na.kind
    if kind == "gat":
        _check_han_arms(plan)
    elif kind == "mean":
        _check_rgcn_arms(plan)
    elif kind == "instance":
        _check_magnn_arms(plan)
    elif kind == "gcn":
        _check_gcn_arms(plan)
    else:
        raise ValueError(f"unknown NA kind {kind!r}")


class StageGraphExecutor:
    """Executes a :class:`StagePlan` over a prepared device batch."""

    def __init__(self, plan: StagePlan, cfg):
        check_ported(plan)
        self.plan = plan
        self.cfg = cfg
        # sampled batches name pad rows and pad edges one past the table:
        # the bucketed and edge-list arms drop them into a sink row
        self._sink = plan.sample is not None
        # the async schedule's side streams, a list a CUDA device (made at
        # first use, kept, so their kernel scratch is made once)
        self._streams: Dict = {}
        # forward_overlapped's compiled stages, one a stage key, kept across
        # calls as the reference keeps its per-stage jits
        self._ov_jit: Dict[str, graphs.Compiled] = {}
        # the last forward_overlapped's dispatch trace
        self.last_dispatch: Dict = {}

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator, batch: Dict) -> Dict:
        """Parameters of the reference's shapes and scales, drawn on the CPU
        from ``gen`` (so every device gets the same numbers) and placed on
        the batch's device."""
        params = self._init_layer0(gen, batch)
        if self.plan.n_layers > 1:
            params["layers"] = [self._init_hidden_layer(gen, batch)
                                for _ in range(1, self.plan.n_layers)]
        return _to_device(params, _batch_device(batch))

    def _init_layer0(self, gen: torch.Generator, batch: Dict) -> Dict:
        cfg = self.cfg
        d = cfg.hidden
        if self.plan.na.kind == "gcn":
            d_in = batch["feat_dim"]
            return {"w1": torch.randn((d_in, d), generator=gen)
                    / math.sqrt(d_in),
                    "w2": torch.randn((d, cfg.n_classes), generator=gen)
                    / math.sqrt(d)}
        params: Dict = {
            "fp": stages.init_feature_projection(gen, batch["feat_dims"], d)}
        params.update(self._init_na_sa(gen, batch))
        params["cls"] = torch.randn((d, cfg.n_classes),
                                    generator=gen) / math.sqrt(d)
        return params

    def _init_na_sa(self, gen: torch.Generator, batch: Dict) -> Dict:
        """The NA/SA block shared by layer 0 and every hidden layer: the
        per-metapath GAT vectors, stacked ``[P, H, Dh]`` for the stacked
        layout (one launch) and a list for the others (no uniform K), and
        the semantic attention (HAN),
        per-metapath instance attention and the semantic attention (MAGNN),
        or per-relation ``w_rel`` keyed by the relation tuples and per-type
        ``w_self`` (RGCN)."""
        cfg = self.cfg
        d = cfg.hidden

        def square():
            return torch.randn((d, d), generator=gen) / math.sqrt(d)

        if self.plan.na.kind == "mean":
            return {"w_rel": {key: square() for key in sorted(batch["rels"])},
                    "w_self": {t: square() for t in sorted(batch["counts"])}}
        sem = semantics.init_semantic_attention(gen, d, cfg.attn_hidden)
        if self.plan.na.kind == "instance":
            return {"att": [stages.init_instance_attention(
                gen, cfg.n_heads, d // cfg.n_heads)
                for _ in self.plan.metapaths], "sem": sem}
        gat = [stages.init_gat(gen, cfg.n_heads, d // cfg.n_heads)
               for _ in self.plan.metapaths]
        if self.plan.na.layout == "stacked":
            # one stacked param set -> ONE kernel launch for the stack
            gat = {k: torch.stack([g[k] for g in gat]) for k in gat[0]}
        return {"gat": gat, "sem": sem}

    def _init_hidden_layer(self, gen: torch.Generator, batch: Dict) -> Dict:
        """Params for one layer >= 1: HAN's square [D, D] re-projection of
        the carried target table, MAGNN's one per carried type and the
        target (RGCN's hidden FP is the identity: its ``w_rel``/``w_self``
        are the layer's transform) plus a fresh NA/SA block; GCN's [D, D]
        combination weight alone."""
        plan = self.plan
        d = self.cfg.hidden
        if plan.na.kind == "gcn":
            return {"fp": torch.randn((d, d), generator=gen) / math.sqrt(d)}
        p: Dict = {}
        if plan.na.kind == "gat":
            p["fp"] = torch.randn((d, d), generator=gen) / math.sqrt(d)
        elif plan.na.kind == "instance":
            types = sorted(set(plan.layers[0].carry) | {plan.target})
            p["fp"] = {t: torch.randn((d, d), generator=gen) / math.sqrt(d)
                       for t in types}
        p.update(self._init_na_sa(gen, batch))
        return p

    def _layer_params(self, params: Dict, l: int) -> Dict:
        return params if l == 0 else params["layers"][l - 1]

    # ------------------------------------------------------------------
    # Stage 2: Feature Projection
    # ------------------------------------------------------------------
    def fp(self, params: Dict, batch: Dict):
        """Layer 0: per-type projection of the raw features.  With
        ``fp.heads`` only the target type's table goes on, as
        ``[N, H, Dh]``; otherwise every type's ``[N_t, D]`` table.  GCN's
        ``dense`` FP is its first combination, ``x @ w1``.  Partitioned:
        every type's owned rows, ``[K, n_t, F_t] @ W_t``."""
        plan = self.plan
        if plan.partition is not None:
            return {t: shard(f @ self._fp_w(plan.fp, params["fp"][t]),
                             BATCH, None, MODEL)
                    for t, f in batch["part"]["feats"].items()}
        if plan.fp.kind == "dense":
            return batch["x"] @ params["w1"]
        if plan.fp.heads:  # the other types' tables are not used
            t = plan.target
            ht = batch["feats"][t] @ self._fp_w(plan.fp, params["fp"][t])
            if plan.fp.sharded:
                ht = shard(ht, *stages.HGNN_STAGE_SPECS["fp_out"])
            return self._heads(ht)
        if plan.fp.sharded:
            return stages.feature_projection_sharded(params["fp"],
                                                     batch["feats"])
        return stages.feature_projection(params["fp"], batch["feats"])

    @staticmethod
    def _fp_w(fp, w):
        """An FP weight under the stage-aware constraint (``fp.sharded``)."""
        if fp.sharded:
            return shard(w, *stages.HGNN_STAGE_SPECS["fp_weight"])
        return w

    def _heads(self, h):
        """``[N, D]`` as ``[N, H, Dh]`` (on a mesh, the heads over
        ``'model'`` where they divide it)."""
        return split_heads(h, self.cfg.n_heads,
                           h.shape[-1] // self.cfg.n_heads, lead=(BATCH,))

    def _fp_hidden(self, lp, p_l: Dict, state: Dict):
        """Layers >= 1: ``identity`` passes the carried tables through
        (RGCN: the relation weights are the layer's transform); ``per_type``
        re-projects every carried table (MAGNN); ``dense`` is a [D, D]
        re-projection of the carried target table, reshaped to heads when
        ``fp.heads`` (partitioned: ``[K, n, D]``, kept in a dict for
        ``gather_halo``; the partitioned NA makes the heads)."""
        if lp.fp.kind == "identity":
            return state
        if lp.fp.kind == "per_type":
            project = (stages.feature_projection_sharded if lp.fp.sharded
                       else stages.feature_projection)
            return project(p_l["fp"], state)
        t = self.plan.target
        w = self._fp_w(lp.fp, p_l["fp"])
        if self.plan.partition is not None:
            return {t: shard(state[t] @ w, BATCH, None, MODEL)}
        h = state[t] @ w
        if lp.fp.sharded:
            h = shard(h, *stages.HGNN_STAGE_SPECS["fp_out"])
        if lp.fp.heads:
            return self._heads(h)
        return h

    def _handoff(self, lp, batch: Dict, h, out) -> Dict:
        """Package one layer's outputs as the next layer's state: ``all``
        (rel_sum already returned every type's table), ``target`` (the
        metapath graphs are target->target, so only this layer's SA output)
        or ``target+carry`` (MAGNN: the SA output plus this layer's FP
        output ``h`` for the carried types; partitioned, their owned rows
        only, since the halos are exchanged again, laid out contiguously as
        whichever flow made ``h``, so the next FP's product is the same)."""
        if lp.handoff == "all":
            return out
        state = {self.plan.target: out}
        if lp.handoff == "target+carry":
            part = batch.get("part")
            for ty in lp.carry:
                state[ty] = (h[ty] if part is None else h[ty][
                    :, : part["feats"][ty].shape[1]].contiguous())
        return state

    # ------------------------------------------------------------------
    # partitioned flow: the halo exchange
    # ------------------------------------------------------------------
    def halo_exchange(self, batch: Dict, h_own: Dict) -> Dict:
        """The exchange alone: each type's halo rows ``[K, H_max, ...]``
        fetched from the partitions' owned tables by one flat gather, not
        yet appended to the local tables (the async schedule runs it
        beside NA's owned-rows pre-gather).  With residency, a hot halo
        entry is read from the partition-local cache of hot rows, whose
        merged index ``where(slot >= 0, hot_flat[slot], halo_src)``
        (:func:`residency.partition_overlay`, on the host) names the same
        flat owned row as ``halo_src``: the cached exchange is this same
        one gather, bitwise."""
        part = batch["part"]
        mode = self.plan.partition.halo
        return {t: dpart.gather_halo(h, part["halo_src"][t], mode=mode)
                for t, h in h_own.items()}

    def gather_halo(self, batch: Dict, h_own: Dict) -> Dict:
        """The partitioned flow's exchange stage: each type's local source
        table, ``concat(own, halo)`` along the rows (:meth:`halo_exchange`
        and a concat; on a mesh, a partition's rows whole on its rank)."""
        halos = self.halo_exchange(batch, h_own)
        out = {}
        for t, h in h_own.items():
            h = shard(h, BATCH, *([None] * (h.dim() - 1)))
            out[t] = local(lambda a, b: torch.cat([a, b], dim=1),
                           (h, halos[t]), None, lead_placements(h))
        return out

    # ------------------------------------------------------------------
    # Stage 3: Neighbor Aggregation
    # ------------------------------------------------------------------
    @staticmethod
    def _hot(batch: Dict, t: str):
        """Type ``t``'s hot rows under residency, else None."""
        res = batch.get("residency")
        return None if res is None else res.get("hot", {}).get(t)

    def _res_pool(self, batch: Dict, t: str, x: torch.Tensor):
        """Residency arm: extend type ``t``'s source pool with the cache
        section — bitwise copies of the hot rows, which the remapped index
        tables address.  The hot sets are layer-invariant, so every layer
        reuses the same resident rows; an NA stage extends each type's
        pool once.  Uncached batches pass through.  The edge-list mean
        arms build no pool: their ``segment_sum`` reads a cache index
        through the hot ids (:meth:`_hot`)."""
        hot = self._hot(batch, t)
        if hot is None:
            return x
        # on a mesh the pool is whole on every rank (NA's source spec)
        x = replicate(x)
        return local(lambda a, i: torch.cat([a, a.index_select(0, i)]),
                     (x, replicate(hot)), None, lead_placements(x))

    def na(self, params: Dict, batch: Dict, h):
        kind = self.plan.na.kind
        if self.plan.partition is not None:
            return self._na_partitioned(params, batch, h)
        if kind == "mean":
            return self._na_mean(params, batch, h)
        if kind == "instance":
            return self._na_instance(params, batch, h)
        if kind == "gcn":
            return self._na_gcn(batch, h)
        return self._na_gat(params, batch, h)  # check_ported: gat

    def _na_gcn(self, batch: Dict, h: torch.Tensor):
        """GCN's two aggregation layers, both NA work (the paper's GNN
        comparison has no semantic stage): segment means over the edge
        list, the second over the relu of the first.  Residency covers
        both: the second re-gathers z over the same remapped table (the
        inter-layer reuse), each cache index read through the hot ids."""
        t = self.plan.target
        hot = self._hot(batch, t)
        z = F.relu(stages.mean_aggregate_csr(
            h, batch["seg"], batch["idx"], h.shape[0], sink=self._sink,
            hot=hot))
        return stages.mean_aggregate_csr(
            z, batch["seg"], batch["idx"], z.shape[0], sink=self._sink,
            hot=hot)

    def _na_gat(self, params: Dict, batch: Dict, h: torch.Tensor):
        """HAN's NA: the ``csr`` baseline (one edge list a metapath,
        separate kernels; returns a list of ``[N, D]``), the ``bucketed``
        layout (one unstacked ``gat_na`` launch a degree bucket with
        ``na.use_pallas``) or the ``stacked`` one (one launch for the
        stack); both return ``[P, N, D]``."""
        plan = self.plan
        if plan.sa.fuse_epilogue:
            return self._na_gat_fused_sa(params, batch, h)
        act = _ACT[plan.na.activation]
        pool = self._res_pool(batch, plan.target, h)
        if plan.na.layout == "csr":
            return [act(z).reshape(z.shape[0], -1) for z in (
                self._gat_metapath(p_i, batch, h, pool, i)
                for i, p_i in enumerate(params["gat"]))]
        if plan.na.layout == "bucketed":
            # the activation a metapath, then the stack, as the schedule's
            # NA.p{i} stages apply it: elementwise, but the CPU's vectorised
            # loop rounds the elements at a thread's chunk end by its
            # scalar path, so the bits follow the tensor it is applied to
            z = torch.stack([act(self._gat_metapath(p_i, batch, h, pool, i))
                             for i, p_i in enumerate(params["gat"])])
            return z.reshape(z.shape[0], z.shape[1], -1)  # [P, N, D]
        stacked_fn = None
        if plan.na.use_pallas:
            stacked_fn = functools.partial(ops.gat_aggregate_stacked,
                                           use_pallas=True)
        z = stages.gat_aggregate_padded_stacked(
            params["gat"], h, batch["nbr"], batch["mask"],
            stacked_fn=stacked_fn, h_src=pool)
        z = act(z)
        return z.reshape(z.shape[0], z.shape[1], -1)  # [P, N, D]

    def _gat_metapath(self, p_i: Dict, batch: Dict, h: torch.Tensor,
                      pool: torch.Tensor, i: int) -> torch.Tensor:
        """Metapath ``i``'s GAT NA on the ``csr`` or ``bucketed`` layout,
        before the activation: ``[N, H, Dh]`` (the serial loop's body and
        the schedule's ``NA.p{i}`` stage)."""
        if self.plan.na.layout == "csr":
            seg, idx = batch["edges"][i]
            return stages.gat_aggregate_csr(p_i, h, pool, seg, idx,
                                            h.shape[0])
        agg_fn = None
        if self.plan.na.use_pallas:
            agg_fn = functools.partial(ops.gat_aggregate, use_pallas=True)
        return stages.gat_aggregate_bucketed(p_i, h, pool,
                                             batch["buckets"][i],
                                             agg_fn=agg_fn, sink=self._sink)

    def _na_gat_fused_sa(self, params: Dict, batch: Dict, h: torch.Tensor):
        """Stacked NA with the SA pass-1 epilogue fused in: returns
        ``(z [P, N, D] activation applied, wp [P] semantic-score means)``."""
        if self.plan.na.activation != "elu":
            # the kernel epilogue bakes the NA activation in (elu)
            raise ValueError("sa.fuse_epilogue requires na.activation='elu' "
                             f"(got {self.plan.na.activation!r})")
        pool = self._res_pool(batch, self.plan.target, h)
        if current_mesh() is None or not is_dtensor(batch["nbr"]):
            z4, wp = ops.gat_aggregate_stacked_fused_sa(
                params["gat"], h, pool, batch["nbr"], batch["mask"],
                params["sem"], use_pallas=self.plan.na.use_pallas)
        else:
            z4, wp = self._fused_sa_on_mesh(params["gat"], params["sem"], h,
                                            pool, batch["nbr"], batch["mask"])
        return z4.reshape(z4.shape[0], z4.shape[1], -1), wp

    def _fused_sa_on_mesh(self, p: Dict, sem: Dict, h, pool, nbr, mask):
        """The fused NA→SA epilogue on a mesh: destination rows and their
        neighbour tables over ``BATCH``, the pool and the weights
        replicated, one kernel call a rank on its rows (``local``).  Each
        rank's ``w`` is the score mean over its rows; the ranks hold equal
        row counts (else the rows stay replicated), so the global mean is
        the mean of the ranks' means, added in rank order after they are
        gathered (one rank: its ``w`` as it is)."""
        from torch.distributed.tensor import Replicate, Shard

        specs = stages.HGNN_STAGE_SPECS
        h, pool, nbr, mask = stages.na_inputs(h, pool, nbr, mask,
                                              lead=(None,))
        pk, sk = list(p), list(sem)
        use_pallas = self.plan.na.use_pallas

        def body(*a):
            pp = dict(zip(pk, a[:len(pk)]))
            ss = dict(zip(sk, a[len(pk):len(pk) + len(sk)]))
            z4, wp = ops.gat_aggregate_stacked_fused_sa(
                pp, *a[len(pk) + len(sk):], ss, use_pallas=use_pallas)
            return z4, wp[None]

        weights = [p[k] for k in pk] + [sem[k] for k in sk]
        w_pl = [Shard(0) if pl.is_shard(1) else Replicate()
                for pl in nbr.placements]
        z4, parts = local(
            body, (*weights, h, pool, nbr, mask),
            tuple((None,) * w.dim() for w in weights)
            + (specs["na_dst"], specs["na_src"], (None,) + specs["na_nbr"],
               (None,) + specs["na_nbr"]),
            (list(nbr.placements), w_pl))
        z4 = shard(z4, None, *specs["na_out"])
        parts = shard(parts, None, None)  # every rank's w, on every rank
        wp = parts[0]
        for r in range(1, parts.shape[0]):
            wp = wp + parts[r]
        return z4, (wp / parts.shape[0] if parts.shape[0] > 1 else wp)

    def _na_mean(self, params: Dict, batch: Dict, h: Dict):
        """RGCN's NA: per relation (sorted keys), the mean of the source
        type's rows over the incoming neighbours, projected by ``w_rel``.
        With ``na.use_pallas`` the padded and bucketed layouts run the
        ``segment_spmm`` kernel; ``csr`` is the ``segment_sum`` segment
        mean.  With residency each source type's pool is extended once
        for all its relations; the ``csr`` arm reads the cache indices
        through the hot ids instead."""
        plan = self.plan
        # "__h__" rides along for the self-loop term in SA (rel_sum)
        out: Dict = {"__h__": h}
        agg_fn = None
        if plan.na.use_pallas and plan.na.layout != "csr":
            agg_fn = functools.partial(ops.segment_spmm, mean=True,
                                       use_pallas=True)
        pools: Dict = {}
        for key in sorted(batch["rels"]):
            s, _, d = key
            rel = batch["rels"][key]
            if plan.na.layout != "csr" and s not in pools:
                pools[s] = self._res_pool(batch, s, h[s])
            if plan.na.layout == "csr":
                agg = stages.mean_aggregate_csr(h[s], rel[0], rel[1],
                                                h[d].shape[0],
                                                hot=self._hot(batch, s))
            elif plan.na.layout == "bucketed":
                agg = stages.mean_aggregate_bucketed(
                    pools[s], rel, h[d].shape[0], agg_fn=agg_fn,
                    sink=self._sink)
            else:  # padded
                agg = stages.mean_aggregate_padded_sharded(
                    pools[s], rel[0], rel[1], agg_fn=agg_fn)
            out["|".join(key)] = agg @ params["w_rel"][key]
        return out

    def _na_instance_one(self, params: Dict, batch: Dict, h: Dict,
                         i_path: int) -> torch.Tensor:
        """One metapath's instance-attention NA (MAGNN): gather each path
        position's projected rows — through the ``cached_gather`` kernel
        where the position's type is hot, whichever arm runs, since the
        remapped ids address the cache section, and through ``ops.
        gather_rows`` elsewhere, which the records count by the same rule
        — encode the instances by rotation, attend over them per target.
        The kernel arm is the unstacked ``gat_na`` with the encoded
        instances as the source pool and an ``arange`` neighbour grid.  On
        a mesh the round runs on each rank's target rows (``local``): the
        instance tables and the target rows over ``BATCH``, the gathered
        types' tables and hot sets whole."""
        res = batch.get("residency")
        types = self.plan.metapaths[i_path]
        pools = {ty: h[ty] for ty in types}
        hot = {ty: x for ty, x in (res["hot"] if res is not None
                                   else {}).items() if ty in pools}
        specs = stages.HGNN_STAGE_SPECS
        nodes, mask = batch["instances"][i_path]
        nodes = shard(nodes, *specs["na_inst_nodes"])
        mask = shard(mask, *specs["na_nbr"])
        h_tgt = shard(h[self.plan.target], BATCH, None)
        if is_dtensor(nodes):
            pools = {ty: replicate(x) for ty, x in pools.items()}
            hot = {ty: replicate(x) for ty, x in hot.items()}
        z = local(functools.partial(self._instance_round, types),
                  (params["att"][i_path], pools, hot, h_tgt, nodes, mask),
                  None, lead_placements(nodes))
        return shard(z, *specs["na_flat_out"])  # [N, D]

    def _instance_round(self, types, p_i: Dict, pools: Dict, hot: Dict,
                        h_tgt: torch.Tensor, nodes: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
        """:meth:`_na_instance_one`'s body on whole or local tables:
        ``nodes [N, I, L]`` into ``pools``, ``h_tgt [N, D]`` -> ``[N, D]``
        after the activation."""
        plan = self.plan
        heads = self.cfg.n_heads
        n, i, l = nodes.shape

        def gather(j):
            ty = types[j]
            if ty in hot:
                return ops.cached_gather(pools[ty], hot[ty], nodes[:, :, j],
                                         use_pallas=plan.na.use_pallas)
            return ops.gather_rows(pools[ty], nodes[:, :, j],
                                   use_pallas=plan.na.use_pallas)

        h_path = torch.stack([gather(j) for j in range(l)], dim=2)
        h_path = h_path.reshape(n, i, l, heads, -1)  # [N, I, L, H, Dh]
        enc = stages.rotate_encoder(h_path)  # [N, I, H, Dh]
        h_tgt = h_tgt.reshape(-1, heads, h_path.shape[-1])
        if plan.na.use_pallas:
            flat = enc.reshape(n * i, heads, enc.shape[-1])
            nbr_inst = torch.arange(n * i, dtype=torch.int32,
                                    device=flat.device).reshape(n, i)
            z = ops.gat_aggregate(p_i, h_tgt, flat, nbr_inst, mask,
                                  use_pallas=True)
        else:
            z = stages.instance_aggregate(p_i, h_tgt, enc, mask)
        return _ACT[plan.na.activation](z).reshape(n, -1)

    def _na_instance(self, params: Dict, batch: Dict, h: Dict):
        return [self._na_instance_one(params, batch, h, i)
                for i in range(len(self.plan.metapaths))]

    def _na_metapath(self, params: Dict, batch: Dict, h, i: int):
        """Metapath ``i``'s NA as a stage of its own (the async schedule,
        one device): the ``bucketed`` or ``csr`` GAT loop body, or one
        MAGNN instance round, with the activation applied here, as the
        serial loop applies it, so SA's re-stack (:meth:`_sa_entry`) has
        the serial bits.  Returns ``[N, D]``."""
        if self.plan.na.kind == "instance":
            return self._na_instance_one(params, batch, h, i)
        pool = self._res_pool(batch, self.plan.target, h)
        z = self._gat_metapath(params["gat"][i], batch, h, pool, i)
        return _ACT[self.plan.na.activation](z).reshape(z.shape[0], -1)

    def _na_partitioned(self, params: Dict, batch: Dict, h_loc: Dict):
        """NA over partition-local tables: destinations are each
        partition's owned rows, sources its ``concat(own, halo)`` table
        from ``gather_halo``.  The reference vmaps the plain padded bodies
        over the partitions; here each partition goes through the arm the
        unpartitioned layout takes, so with ``na.use_pallas`` on the card
        it launches the same kernels: HAN one stacked ``gat_na`` a
        partition, RGCN one ``segment_spmm`` a relation and partition, and
        MAGNN, whose instances address no shared table once encoded, one
        unstacked ``gat_na`` a metapath over every partition's rows.  On a
        mesh each rank runs this on its partitions: every table of
        ``batch["part"]`` leads with ``K``, laid out over ``BATCH`` (all
        of them, or none where the axes do not divide ``K``), ``h_loc``
        too, row for row, and the NA weights whole; each partition's
        arithmetic and kernel launches are the one-device arm's."""
        t = self.plan.target
        if current_mesh() is not None and is_dtensor(h_loc[t]):
            h_loc = {ty: shard(x, BATCH, *([None] * (x.dim() - 1)))
                     for ty, x in h_loc.items()}
            return local(self._na_partitioned, (params, batch, h_loc), None,
                         lead_placements(batch["part"]["feats"][t]))
        plan = self.plan
        part = batch["part"]
        t = plan.target
        act = _ACT[plan.na.activation]
        heads = self.cfg.n_heads

        def own(ty):
            # the owned rows laid out as the schedule's merge gets them
            # (FP's output): a product on a strided view of the local table
            # is a batched product to cuBLAS, another kernel, other bits
            return h_loc[ty][:, : part["feats"][ty].shape[1]].contiguous()

        if plan.na.kind == "gat":
            n_own = part["feats"][t].shape[1]
            pools = h_loc[t].reshape(h_loc[t].shape[0], h_loc[t].shape[1],
                                     heads, -1)  # [K, n + halo, H, Dh]
            stacked_fn = None
            if plan.na.use_pallas:
                stacked_fn = functools.partial(ops.gat_aggregate_stacked,
                                               use_pallas=True)
            z = act(torch.stack([
                stages.gat_aggregate_padded_stacked(
                    params["gat"], pool[:n_own], nbr, mask,
                    stacked_fn=stacked_fn, h_src=pool)
                for pool, nbr, mask in zip(pools, part["nbr"],
                                           part["mask"])]))
            return shard(z.reshape(z.shape[0], z.shape[1], z.shape[2], -1),
                         BATCH, None, None, None)  # [K, P, n, D]
        if plan.na.kind == "mean":
            agg_fn = stages.mean_aggregate_padded
            if plan.na.use_pallas:
                agg_fn = functools.partial(ops.segment_spmm, mean=True,
                                           use_pallas=True)
            out = self._mean_self_rows(own, part["feats"])
            for key in sorted(part["rels"]):
                nbr, mask = part["rels"][key]
                agg = torch.stack([agg_fn(pool, nn, mm) for pool, nn, mm
                                   in zip(h_loc[key[0]], nbr, mask)])
                out["|".join(key)] = agg @ params["w_rel"][key]  # [K, n, D]
            return out
        # instance (check_ported)
        k_idx = torch.arange(h_loc[t].shape[0],
                             device=h_loc[t].device)[:, None, None]
        return [self._instance_partitioned(
            p_i, own(t), torch.stack([
                h_loc[types[j]][k_idx, nodes[..., j].long()]
                for j in range(nodes.shape[3])], dim=3), mask)
            for p_i, (nodes, mask), types in zip(
                params["att"], part["instances"], plan.metapaths)]

    def _mean_self_rows(self, rows, types) -> Dict:
        """The partitioned mean NA's ``"__h__"`` entry, for the rel_sum
        self-loop: ``rows(ty)``, the owned rows of every type when every
        type updates (L > 1), else of the target."""
        if self.plan.n_layers > 1:
            return {"__h__": {ty: rows(ty) for ty in types}}
        return {"__h__": rows(self.plan.target)}

    def _instance_partitioned(self, p_i: Dict, h_tgt: torch.Tensor,
                              h_path: torch.Tensor, mask: torch.Tensor):
        """One metapath's instance attention over every partition: the
        partitions' rows flattened to ``[K * n]``, the gathered positions
        ``h_path [K, n, I, L, D]`` rotation-encoded, then one unstacked
        ``gat_na`` launch over the encoded instances (``na.use_pallas``)
        or the plain attention.  Returns ``[K, n, D]``."""
        heads = self.cfg.n_heads
        k, n, i, l = h_path.shape[:4]
        h_tgt = h_tgt.reshape(k * n, heads, -1)
        enc = stages.rotate_encoder(
            h_path.reshape(k * n, i, l, heads, -1))  # [K*n, I, H, Dh]
        mask = mask.reshape(k * n, i)
        if self.plan.na.use_pallas:
            flat = enc.reshape(k * n * i, heads, enc.shape[-1])
            nbr_inst = torch.arange(k * n * i, dtype=torch.int32,
                                    device=flat.device).reshape(k * n, i)
            z = ops.gat_aggregate(p_i, h_tgt, flat, nbr_inst, mask,
                                  use_pallas=True)
        else:
            z = stages.instance_aggregate(p_i, h_tgt, enc, mask)
        return _ACT[self.plan.na.activation](z).reshape(k, n, -1)

    # ------------------------------------------------------------------
    # partitioned flow, async schedule: the own/halo NA split.  The serial
    # partitioned NA gathers from concat(own, halo), so it waits for the
    # exchange.  A gather is a row selection, so it splits at the gather,
    # never at a float reduction: the owned side pre-gathers against the
    # owned table while the exchange runs, and the merge selects the halo
    # rows in (stages.gather_own / gather_merge, bitwise the gather from
    # the concatenation).  Every sum runs once, in the merge, on the same
    # rows in the same order.
    # ------------------------------------------------------------------
    def _na_partitioned_own(self, params: Dict, batch: Dict, h_own: Dict):
        """The owned-rows pre-gather: all that partitioned NA can do from
        FP's output alone (it runs beside :meth:`halo_exchange`).  Per
        partition: HAN the ``[P, n, Kd, H, Dh]`` rows (and, on the plain
        arm, the source scores ``[P, n, Kd, H]``, row-local math), RGCN a
        relation's ``[n_d, Kd, D]`` rows, MAGNN a metapath position's
        ``[n, I, D]`` rows.  Returns what :meth:`_na_partitioned_merge`
        takes."""
        plan = self.plan
        part = batch["part"]
        t = plan.target
        if plan.na.kind == "gat":
            hs = h_own[t].reshape(h_own[t].shape[0], h_own[t].shape[1],
                                  self.cfg.n_heads, -1)  # [K, n, H, Dh]
            pre: Dict = {"hn": [stages.gather_own(hs_k, nbr_k)
                                for hs_k, nbr_k in zip(hs, part["nbr"])]}
            if not plan.na.use_pallas:
                a_src = params["gat"]["a_src"]
                pre["e"] = [torch.stack([
                    stages.gather_own((hs_k * a_src[p]).sum(-1), nbr_k[p])
                    for p in range(nbr_k.shape[0])])
                    for hs_k, nbr_k in zip(hs, part["nbr"])]
            return pre
        if plan.na.kind == "mean":
            return {"|".join(key): [
                stages.gather_own(own_k, nbr_k) for own_k, nbr_k in zip(
                    h_own[key[0]], part["rels"][key][0])]
                for key in sorted(part["rels"])}
        # instance (check_ported): per metapath, per position
        return [[[stages.gather_own(own_k, idx_k) for own_k, idx_k in zip(
            h_own[types[j]], nodes[..., j])] for j in range(nodes.shape[3])]
            for (nodes, _), types in zip(part["instances"], plan.metapaths)]

    def _na_partitioned_merge(self, params: Dict, batch: Dict, h_own: Dict,
                              halos: Dict, pre):
        """The merge: select the exchanged halo rows into the pre-gathered
        owned rows, then the serial partitioned arm's aggregation on the
        merged rows.  With ``na.use_pallas`` it runs the same kernels over
        the merged rows laid flat, with an ``arange`` neighbour grid: HAN
        one stacked ``gat_na`` a partition (``nbr[p]`` offset into the
        flat ``[P * n * Kd]`` rows), RGCN one ``segment_spmm`` a relation
        and partition; MAGNN as in the serial arm.  Bitwise
        ``_na_partitioned(params, batch, gather_halo(batch, h_own))``."""
        plan = self.plan
        part = batch["part"]
        t = plan.target
        heads = self.cfg.n_heads
        act = _ACT[plan.na.activation]

        def n_of(ty):
            return part["feats"][ty].shape[1]

        if plan.na.kind == "gat":
            def as_heads(x):
                return x.reshape(x.shape[0], x.shape[1], heads, -1)

            hd, hh = as_heads(h_own[t]), as_heads(halos[t])
            zs = []
            for k, (nbr_k, mask_k) in enumerate(zip(part["nbr"],
                                                    part["mask"])):
                hn = stages.gather_merge(pre["hn"][k], hh[k], nbr_k, n_of(t))
                if plan.na.use_pallas:
                    grid = torch.arange(nbr_k.numel(), dtype=torch.int32,
                                        device=nbr_k.device
                                        ).reshape(nbr_k.shape)
                    zs.append(ops.gat_aggregate_stacked(
                        params["gat"], hd[k], hn.reshape(
                            (-1,) + tuple(hn.shape[3:])), grid, mask_k,
                        use_pallas=True))
                    continue
                a_src = params["gat"]["a_src"]
                zs.append(torch.stack([stages.gat_aggregate_padded(
                    {n: v[p] for n, v in params["gat"].items()}, hd[k],
                    None, None, mask_k[p], hn=hn[p],
                    e_nbr=stages.gather_merge(
                        pre["e"][k][p], (hh[k] * a_src[p]).sum(-1),
                        nbr_k[p], n_of(t)))
                    for p in range(nbr_k.shape[0])]))
            z = act(torch.stack(zs))  # [K, P, n, H, Dh]
            return z.reshape(z.shape[0], z.shape[1], z.shape[2], -1)
        if plan.na.kind == "mean":
            out = self._mean_self_rows(lambda ty: h_own[ty], part["feats"])
            for key in sorted(part["rels"]):
                s = key[0]
                aggs = []
                for k, (nbr_k, mask_k) in enumerate(zip(*part["rels"][key])):
                    hn = stages.gather_merge(pre["|".join(key)][k],
                                             halos[s][k], nbr_k, n_of(s))
                    if plan.na.use_pallas:
                        grid = torch.arange(nbr_k.numel(), dtype=torch.int32,
                                            device=nbr_k.device
                                            ).reshape(nbr_k.shape)
                        aggs.append(ops.segment_spmm(
                            hn.reshape(-1, hn.shape[-1]), grid, mask_k,
                            mean=True, use_pallas=True))
                    else:
                        aggs.append(stages.mean_aggregate_padded(
                            None, nbr_k, mask_k, hn=hn))
                out["|".join(key)] = torch.stack(aggs) @ params["w_rel"][key]
            return out
        # instance (check_ported)
        return [self._instance_partitioned(
            p_i, h_own[t], torch.stack([torch.stack([
                stages.gather_merge(pre_i[j][k], halos[types[j]][k],
                                    nodes[k, ..., j], n_of(types[j]))
                for k in range(nodes.shape[0])])
                for j in range(nodes.shape[3])], dim=3), mask)
            for p_i, (nodes, mask), types, pre_i in zip(
                params["att"], part["instances"], plan.metapaths, pre)]

    # ------------------------------------------------------------------
    # Stage 4: Semantic Aggregation
    # ------------------------------------------------------------------
    def _rel_sum(self, params: Dict, h_own: Dict, z: Dict) -> Dict:
        """RGCN's SA: per type, the relation aggregates into that type
        summed in relation order (Reduce) onto the ``w_self`` self-loop,
        then relu.  ``z`` is the NA output keyed by ``"s|r|d"``."""
        h_new: Dict = {}
        for t in sorted(h_own):
            acc = None
            for key, v in z.items():
                if key != "__h__" and key.split("|")[2] == t:
                    acc = v if acc is None else acc + v  # Reduce (sum)
            h_self = h_own[t] @ params["w_self"][t]
            h_new[t] = F.relu(h_self if acc is None else h_self + acc)
        return h_new

    def sa(self, params: Dict, batch: Dict, z):
        plan = self.plan
        if plan.partition is not None:
            return self._sa_partitioned(params, batch, z)
        if plan.sa.kind == "none":
            return z
        if plan.sa.kind == "rel_sum":
            return self._rel_sum(params, z["__h__"], z)
        row_mask = batch.get("row_mask")
        if isinstance(z, tuple):  # fused NA→SA epilogue: (z, pass-1 scores)
            z_stack, wp = z
            if row_mask is not None:
                # the kernel's pass-1 mean ran over every row incl. the pad
                # rows; a pad row aggregates to 0 and contributes exactly
                # c = q·tanh(b): remove them in closed form
                sem = params["sem"]
                c = torch.tanh(sem["b"]) @ sem["q"]
                n_real = torch.clamp(row_mask.sum(), min=1.0)
                n_pad = row_mask.shape[0] - row_mask.sum()
                wp = wp + n_pad * (wp - c) / n_real
            beta = torch.softmax(wp, dim=0)  # O(P) softmax
            # pass 2 (combine) is the only remaining full read of z
            return local(
                functools.partial(ops.semantic_combine,
                                  use_pallas=plan.na.use_pallas),
                (z_stack, beta),
                (stages.HGNN_STAGE_SPECS["sa_stacked"], (None,)),
                _rows_of(z_stack))
        if not plan.sa.stacked:  # MAGNN, HAN csr: a list of [N, D]
            return semantics.semantic_attention_list(params["sem"], z,
                                                     row_mask)
        z = shard(z, *stages.HGNN_STAGE_SPECS["sa_stacked"])
        return semantics.semantic_attention(params["sem"], z, row_mask)

    def _sa_entry(self, p_l: Dict, batch: Dict, z):
        """SA as the schedule enters it: after per-metapath NA stages, a
        stacked SA gets the metapaths' outputs re-stacked (the activation
        already applied a metapath, as in the serial arm)."""
        if self._split_metapaths() and self.plan.sa.stacked:
            z = torch.stack(z)  # [P, N, D]
        return self.sa(p_l, batch, z)

    def _sa_partitioned(self, params: Dict, batch: Dict, z):
        """SA on the partition-local stacks: rel_sum partition-local (pad
        rows stay zero: zero features, zero aggregates, relu(0)); attention
        over HAN's ``[K, P, n, D]`` or MAGNN's list of ``[K, n, D]``, its
        score means taken in global row order (``inv``).  The reference's
        partitioned SA reads no ``row_mask``: a sampled batch's rung pads
        are rows of the partitioned graph like any other."""
        plan = self.plan
        if plan.sa.kind == "rel_sum":
            if plan.n_layers > 1:
                return self._rel_sum(params, z["__h__"], z)
            return self._rel_sum(params, {plan.target: z["__h__"]},
                                 z)[plan.target]
        if isinstance(z, list):
            z = torch.stack(z, dim=1)  # [K, P, n, D]
        # on a mesh the stack is whole on every rank: the score means run in
        # global row order (inv), as off it, and the rows are laid back out
        # over the partitions
        z = replicate(z)
        out = local(semantics.semantic_attention_partitioned,
                    (params["sem"], z, replicate(batch["part"]["inv"])),
                    None, lead_placements(z))  # [K, n, D]
        return shard(out, BATCH, None, None)

    # ------------------------------------------------------------------
    # head + forward
    # ------------------------------------------------------------------
    def head(self, params: Dict, z, batch: Dict = None) -> torch.Tensor:
        """The classifier; partitioned, on each partition's owned target
        rows (the multi-layer rel_sum returns every type: the target is
        selected), then back to global row order through ``inv``."""
        head = self.plan.head
        if self.plan.partition is not None:
            if isinstance(z, dict):
                z = z[self.plan.target]

            def restore(z, w, inv):
                out = z @ w  # [K, n, C]
                return out.reshape(-1, out.shape[-1]).index_select(0, inv)

            # on a mesh every rank restores the whole table
            z = replicate(z)
            return local(restore, (z, replicate(params[head.param]),
                                   replicate(batch["part"]["inv"])), None,
                         lead_placements(z))
        if head.kind == "select_linear":
            return z[head.target] @ params[head.param]
        return z @ params[head.param]

    def forward(self, params: Dict, batch: Dict) -> torch.Tensor:
        """The L-layer loop: layer 0 reads the prepared batch, hidden
        layers the previous handoff.  The partitioned flow exchanges the
        updated halo rows every layer over the graph-invariant maps."""
        state = out = None
        for l, lp in enumerate(self.plan.layers):
            p_l = self._layer_params(params, l)
            h = (self.fp(params, batch) if l == 0
                 else self._fp_hidden(lp, p_l, state))
            if self.plan.partition is not None:
                h = self.gather_halo(batch, h)
            z = self.na(p_l, batch, h)
            out = self.sa(p_l, batch, z)
            state = self._handoff(lp, batch, h, out)
        return self.head(params, out, batch)

    # ------------------------------------------------------------------
    # the async stage-graph schedule (plan.schedule)
    # ------------------------------------------------------------------
    def _split_halo(self) -> bool:
        """Does the schedule split partitioned NA into own/halo passes?"""
        s = self.plan.schedule
        return (s is not None and s.overlap_halo
                and self.plan.partition is not None)

    def _split_metapaths(self) -> bool:
        """Does the schedule run each metapath's NA as a stage?  Only
        where the serial arm loops metapaths (``bucketed`` / ``csr`` GAT,
        MAGNN's instances): the stacked layout is one launch by design,
        and one metapath has nothing to overlap."""
        plan, s = self.plan, self.plan.schedule
        return (s is not None and s.overlap_metapaths
                and plan.partition is None
                and len(plan.metapaths) > 1
                and ((plan.na.kind == "gat"
                      and plan.na.layout in ("csr", "bucketed"))
                     or plan.na.kind == "instance"))

    def schedule_edges(self) -> Dict[str, Tuple[str, ...]]:
        """The plan's stage DAG: stage name -> the stages it waits for, in
        topological order (the reference's, ``:861``).  The partitioned
        split runs ``gather_halo`` (the exchange alone) and ``NA.own``
        side by side and merges them in ``NA``; the metapath split fans
        ``FP`` out into ``NA.p{i}`` stages that join at ``SA``."""
        plan = self.plan
        edges: Dict[str, Tuple[str, ...]] = {}
        prev = None
        for l in range(plan.n_layers):
            pre = f"L{l + 1}." if plan.n_layers > 1 else ""
            edges[pre + "FP"] = (prev,) if prev else ()
            if plan.partition is not None:
                edges[pre + "gather_halo"] = (pre + "FP",)
                if self._split_halo():
                    edges[pre + "NA.own"] = (pre + "FP",)
                    edges[pre + "NA"] = (pre + "NA.own", pre + "gather_halo")
                else:
                    edges[pre + "NA"] = (pre + "gather_halo",)
                sa_deps: Tuple[str, ...] = (pre + "NA",)
            elif self._split_metapaths():
                names = [pre + f"NA.p{i}"
                         for i in range(len(plan.metapaths))]
                for nm in names:
                    edges[nm] = (pre + "FP",)
                sa_deps = tuple(names)
            else:
                edges[pre + "NA"] = (pre + "FP",)
                sa_deps = (pre + "NA",)
            edges[pre + "SA"] = sa_deps
            prev = pre + "SA"
        edges["head"] = (prev,)
        return edges

    def overlap_record(self) -> Dict:
        """The schedule's counters, pure functions of the plan (the
        reference's, ``:897``): the DAG's size and the pairs of stages
        that no path orders, the concurrency the schedule can use."""
        edges = self.schedule_edges()
        names = list(edges)
        anc: Dict[str, set] = {}
        for n in names:  # topological by construction
            a = set()
            for d in edges[n]:
                a.add(d)
                a |= anc[d]
            anc[n] = a
        pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]
                 if a not in anc[b] and b not in anc[a]]
        sched = self.plan.schedule
        return {
            "depth": sched.depth if sched is not None else 1,
            "stages": len(names),
            "edges": sum(len(d) for d in edges.values()),
            "concurrent_pairs": len(pairs),
            "overlapped_stages": len({s for p in pairs for s in p}),
            "pairs": [f"{a}|{b}" for a, b in pairs],
        }

    def _ovjit(self, key: str, fn, copied=(), stream: int = 0
               ) -> graphs.Compiled:
        """The stage ``key``'s compiled callable, made at its first use
        and kept (the reference's ``_ovjit``, ``:924``): one wrapper, and
        so one memory pool, a key."""
        f = self._ov_jit.get(key)
        if f is None:
            f = self._ov_jit[key] = graphs.compiled(fn, copied=copied,
                                                     stream=stream)
        return f

    def _walk_schedule(self, params: Dict, batch: Dict, emit):
        """Walk the stage DAG in topological order, each stage through
        ``emit(name, key, fn, args) -> value``: ``name`` as in
        :meth:`schedule_edges`, ``key`` the reference's jit-cache key
        (layer-indexed, but ``halo_exchange`` and ``gather_halo``, which
        every layer shares: ``FP0``, ``FP{l}``, ``NA{l}``, ``NA.p{l}.{i}``,
        ``NA.own{l}``, ``NA.merge{l}``, ``SA{l}``, ``head``).  The async
        dispatcher and the per-stage timing walk this one graph.  One device
        only: on a mesh a plan with a schedule runs the serial
        :meth:`forward`, as the reference's does
        (``launch/serve.build_hgnn_infer``)."""
        if current_mesh() is not None:
            raise ValueError("the async stage-graph schedule runs on one "
                             "device; on a mesh the serial forward runs")
        plan = self.plan
        n_l = plan.n_layers
        state = out = None
        for l, lp in enumerate(plan.layers):
            pre = f"L{l + 1}." if n_l > 1 else ""
            if l == 0:
                h = emit(pre + "FP", "FP0", lambda p, b: self.fp(p, b),
                         (params, batch))
            else:
                h = emit(pre + "FP", f"FP{l}",
                         lambda p, s, lp=lp, l=l: self._fp_hidden(
                             lp, self._layer_params(p, l), s),
                         (params, state))
            if plan.partition is not None:
                if self._split_halo():
                    # both read FP's output alone: they run side by side
                    halos = emit(pre + "gather_halo", "halo_exchange",
                                 lambda b, hh: self.halo_exchange(b, hh),
                                 (batch, h))
                    pre_g = emit(pre + "NA.own", f"NA.own{l}",
                                 lambda p, b, hh, l=l:
                                 self._na_partitioned_own(
                                     self._layer_params(p, l), b, hh),
                                 (params, batch, h))
                    z = emit(pre + "NA", f"NA.merge{l}",
                             lambda p, b, hh, ha, pg, l=l:
                             self._na_partitioned_merge(
                                 self._layer_params(p, l), b, hh, ha, pg),
                             (params, batch, h, halos, pre_g))
                else:
                    h = emit(pre + "gather_halo", "gather_halo",
                             lambda b, hh: self.gather_halo(b, hh),
                             (batch, h))
                    z = emit(pre + "NA", f"NA{l}",
                             lambda p, b, hh, l=l: self.na(
                                 self._layer_params(p, l), b, hh),
                             (params, batch, h))
            elif self._split_metapaths():
                z = [emit(pre + f"NA.p{i}", f"NA.p{l}.{i}",
                          lambda p, b, hh, l=l, i=i: self._na_metapath(
                              self._layer_params(p, l), b, hh, i),
                          (params, batch, h))
                     for i in range(len(plan.metapaths))]
            else:
                z = emit(pre + "NA", f"NA{l}", lambda p, b, hh, l=l: self.na(
                    self._layer_params(p, l), b, hh), (params, batch, h))
            out = emit(pre + "SA", f"SA{l}",
                       lambda p, b, zz, l=l: self._sa_entry(
                           self._layer_params(p, l), b, zz),
                       (params, batch, z))
            if l + 1 < n_l:
                # host-side repackaging of the owned rows, no stage
                state = self._handoff(lp, batch, h, out)
        return emit("head", "head", lambda p, b, oo: self.head(p, oo, b),
                    (params, batch, out))

    @staticmethod
    def _branch(name: str) -> int:
        """The side stream a stage runs on, 0 for the current stream: a
        sibling branch of the DAG (``NA.p{i}``, i > 0, beside ``NA.p0``;
        ``NA.own`` beside ``gather_halo``) gets one of its own."""
        layered = name[:1] == "L" and name[1:2].isdigit()
        base = name.split(".", 1)[1] if layered else name
        if base == "NA.own":
            return 1
        if base.startswith("NA.p") and base != "NA.p0":
            return int(base[len("NA.p"):])
        return 0

    def _side_stream(self, dev: torch.device, i: int):
        streams = self._streams.setdefault(dev, [])
        while len(streams) < i:
            streams.append(torch.cuda.Stream(dev))
        return streams[i - 1]

    def forward_overlapped(self, params: Dict, batch: Dict) -> torch.Tensor:
        """``forward``'s layer loop over the plan's stage DAG: each stage
        admitted to an :class:`InflightWindow` of ``plan.schedule.depth``
        (``depth=1``: every stage waited for, the serial baseline), the
        window drained at the end.  Each stage is its compiled callable
        (:meth:`_ovjit`, the reference's per-stage jit): on the card its
        first call captures a CUDA graph and later calls replay it, with
        ``params`` and ``batch`` held and every earlier stage's output
        copied into the graph's buffers; off the card it is the stage
        function itself.  On the card the stages of one branch run on the
        current stream, and a sibling branch (:meth:`_branch`) on a side
        stream of the executor's own, its graph captured on the device's
        capture stream of that branch, so that two siblings replayed at
        once never share a kernel's scratch; a stage waits for the CUDA
        events of the stages it depends on and records its own, and a
        tensor made on one stream and read on another is recorded on the
        reader (``record_stream``), so the allocator cannot hand its block
        out early.  The split stages are row selections and elementwise
        rearrangements, so the logits are bitwise :meth:`forward`'s.
        ``last_dispatch`` keeps the stages in dispatch order,
        ``max_inflight`` and ``depth``.  The cached wrappers' ``fn`` are
        the eager stages."""
        sched = self.plan.schedule
        win = InflightWindow(sched.depth if sched is not None else 1)
        edges = self.schedule_edges()
        dev = _batch_device(batch)
        cuda = dev.type == "cuda"
        main = torch.cuda.current_stream(dev) if cuda else None
        done: Dict[str, Tuple] = {}  # stage -> (event, stream)

        def emit(name, key, fn, args):
            i = self._branch(name)
            # earlier stages' outputs: copied in, and read on this stream
            copied = [j for j, a in enumerate(args)
                      if a is not params and a is not batch]
            f = self._ovjit(key, fn, copied, i)
            if not cuda:
                return win.admit(name, f(*args))
            stream = main if i == 0 else self._side_stream(dev, i)
            if stream is not main and self.plan.sa.fuse_epilogue:
                # the epilogue's score sum launches with programmatic
                # stream serialization; it stays on the current stream
                raise AssertionError(f"stage {name} of a fused-epilogue "
                                     "plan on a side stream")
            for d in edges[name]:
                event, d_stream = done[d]
                if d_stream is not stream:
                    stream.wait_event(event)
            if stream is not main:
                for x in _tensors([args[j] for j in copied]):
                    x.record_stream(stream)
            with torch.cuda.stream(stream):
                out = f(*args)
                event = torch.cuda.Event()
                event.record(stream)
                win.admit(name, out)
            if stream is not main:
                for x in _tensors(out):
                    x.record_stream(main)
            done[name] = (event, stream)
            return out

        out = self._walk_schedule(params, batch, emit)
        win.drain()
        self.last_dispatch = {"dispatched": list(win.admitted),
                              "max_inflight": win.max_inflight,
                              "depth": win.depth}
        return out

    def overlap_stage_fns(self, params: Dict, batch: Dict
                          ) -> Dict[str, Tuple]:
        """One compiled callable a node of :meth:`schedule_edges`, made
        anew here as the reference jits anew (``:1077``), chained on
        concrete intermediates (``name -> (fn, args)``, each run once
        here, on the current stream; on the card that call captures it and
        later calls replay, every argument held; ``fn.fn`` is the eager
        stage): what the per-stage walls of
        ``characterize.overlap_accounting`` time."""
        fns: Dict[str, Tuple] = {}

        def emit(name, key, fn, args):
            f = graphs.compiled(fn)
            fns[name] = (f, args)
            return f(*args)

        with torch.inference_mode():
            self._walk_schedule(params, batch, emit)
        return fns

    # ------------------------------------------------------------------
    # per-stage characterization hooks
    # ------------------------------------------------------------------
    def stage_fns(self, params: Dict, batch: Dict) -> Dict[str, Tuple]:
        """One compiled callable per stage (``graphs.compiled``, made anew
        here as the reference jits each stage anew, ``:1032``; separate
        calls expose the NA→SA barrier, paper Fig. 5c), chained on
        concrete intermediates: ``name -> (fn, args)``, each run once here
        to make the next one's input.  On the card that call captures the
        stage and later calls replay it, its arguments held (the exchange,
        one callable for every layer as in the reference, copies its
        table in); ``fn.fn`` is the eager stage.  A one-layer plan names
        its stages ``FP``/``NA``/``SA``/``head`` (partitioned: ``FP``/
        ``gather_halo``/``NA``/...); an L-layer stack prefixes every
        per-layer stage with ``L{i}.`` (1-based)."""
        n_l = self.plan.n_layers
        fns: Dict[str, Tuple] = {}
        state = out = None
        gh = (None if self.plan.partition is None
              else graphs.compiled(lambda hh: self.gather_halo(batch, hh),
                                   copied=(0,)))
        with torch.inference_mode():
            for l, lp in enumerate(self.plan.layers):
                pre = f"L{l + 1}." if n_l > 1 else ""
                if l == 0:
                    fp = graphs.compiled(lambda p: self.fp(p, batch))
                    args: Tuple = (params,)
                else:
                    fp = graphs.compiled(
                        lambda p, s, lp=lp, l=l: self._fp_hidden(
                            lp, self._layer_params(p, l), s))
                    args = (params, state)
                fns[pre + "FP"] = (fp, args)
                h = fp(*args)
                if gh is not None:
                    fns[pre + "gather_halo"] = (gh, (h,))
                    h = gh(h)
                na = graphs.compiled(lambda p, hh, l=l: self.na(
                    self._layer_params(p, l), batch, hh))
                fns[pre + "NA"] = (na, (params, h))
                z = na(params, h)
                sa = graphs.compiled(lambda p, zz, l=l: self.sa(
                    self._layer_params(p, l), batch, zz))
                fns[pre + "SA"] = (sa, (params, z))
                out = sa(params, z)
                state = self._handoff(lp, batch, h, out)
        fns["head"] = (graphs.compiled(lambda p, oo: self.head(p, oo, batch)),
                       (params, out))
        return fns

    def stage_records(self, params: Dict, batch: Dict, n_chips: int = 1,
                      sample_meta: Dict = None, timed: bool = False
                      ) -> Dict:
        """Per-stage characterization (the reference's schema, ``:1093``):
        stage name -> ``flops``, ``hbm_bytes``, ``flops_by_class``,
        ``hbm_bytes_by_class`` and the H100 ``roofline``, counted by
        ``core/characterize.py``'s recorder over the exact stage callables
        of :meth:`stage_fns` run eagerly (``fn.fn``: a capture would run a
        stage's ops twice, a replay none); ``total`` is the sum over the
        stages.  With
        residency, ``residency`` holds the batch's counters priced at
        ``4 * hidden`` bytes a row, and each NA record's bytes drop by the
        hot rows it did not re-read (its TB bytes too), the cache fill
        charged at the first NA stage only.

        ``timed=True`` (a CUDA batch only: walls count only on the card)
        adds to each stage ``time_us``, the median of CUDA events around
        its compiled callable (a replay, as the reference times its jitted
        stage) over 20 calls, synchronised, after warm-up, and
        ``device_us`` / ``device_us_by_class`` / ``other_kernels``, the
        eager stage's device kernels under ``torch.profiler``, each stage
        in a window of its own (the replay runs the same kernels, but
        without the aten op around each launch that classes it).

        ``sample_meta`` (request-path serving): the sampler's host-side
        batch metadata; adds the SAMPLE stage (``characterize.
        sample_traffic``, the Subgraph Build of a sampled batch) as the
        first record, kept out of ``total``, which sums the device stages.

        A partitioned plan adds a ``gather_halo`` stage a layer, each with
        its ``halo_bytes`` and ``cut_edges``, and ``partition``, the
        reference's ``characterize.partition_traffic`` over every layer's
        exchange; with residency the hot-halo savings land on the
        ``gather_halo`` records (``halo_bytes_saved_total`` in
        ``partition``) instead of the NA records."""
        from repro_torch.core import characterize as ch

        dev = _batch_device(batch)
        if timed and dev.type != "cuda":
            raise ValueError(f"stage_records(timed=True) measures on a CUDA "
                             f"device; this batch is on {dev}")
        fns = self.stage_fns(params, batch)
        recs: Dict[str, Dict] = {}
        with torch.inference_mode():
            for name, (fn, args) in fns.items():
                with ch.Recorder() as rec:
                    fn.fn(*args)
                rep = rec.report()
                recs[name] = {
                    "flops": rep["total_flops"],
                    "hbm_bytes": rep["total_hbm_bytes"],
                    "flops_by_class": rep["flops_by_class"],
                    "hbm_bytes_by_class": rep["hbm_bytes_by_class"],
                    "roofline": ch.roofline(rep, n_chips, 0.0),
                }
            if timed:
                # a stage of no op (GCN's SA) launches no kernel
                on_card = ch.device_times_us({
                    name: functools.partial(fn.fn, *args)
                    for name, (fn, args) in fns.items()
                    if recs[name]["hbm_bytes"]})
                for name, (fn, args) in fns.items():
                    dev_us, by_class, other = on_card.get(name,
                                                          (0.0, {}, []))
                    recs[name].update(
                        time_us=ch.stage_time_us(
                            functools.partial(fn, *args)),
                        device_us=dev_us, device_us_by_class=by_class,
                        other_kernels=other)
        res = batch.get("residency")
        rr = None
        if res is not None:
            # the recorder charges every gather at its structural size, so
            # the cache's effect — hot rows served from the resident section
            # instead of re-read — comes from the deterministic counters;
            # the hot set is layer-invariant, so only the first cached stage
            # pays the fill
            cached = [n for n in fns if n.endswith(
                "gather_halo" if self.plan.partition is not None else "NA")]
            rr = ch.residency_record(res["counters"], 4 * self.cfg.hidden,
                                     layers=len(cached))
            for i, name in enumerate(cached):
                saved = rr["bytes_saved_per_layer"] - (
                    rr["fill_bytes"] if i == 0 else 0)
                r = recs[name]
                r["residency_bytes_saved"] = saved
                r["hit_rate"] = rr["hit_rate"]
                r["hbm_bytes"] = max(r["hbm_bytes"] - saved, 0)
                by_class = r["hbm_bytes_by_class"]
                by_class["TB"] = by_class.get("TB", 0.0) - saved
        total = {"flops": sum(r["flops"] for r in recs.values()),
                 "hbm_bytes": sum(r["hbm_bytes"] for r in recs.values())}
        if sample_meta is not None:
            recs = {"SAMPLE": ch.sample_traffic(sample_meta), **recs}
        out = {"stages": recs, "total": total}
        if rr is not None:
            out["residency"] = rr
        if self.plan.schedule is not None:
            # the DAG's counters (measured walls go through
            # characterize.overlap_accounting, not the records)
            out["overlap"] = self.overlap_record()
        gh_names = [n for n in fns if n.endswith("gather_halo")]
        if gh_names:
            # every layer exchanges the updated rows over the same maps
            for name in gh_names:
                tr = ch.partition_traffic(batch["part"], fns[name][1][0])
                recs[name]["halo_bytes"] = tr["halo_bytes"]
                recs[name]["cut_edges"] = tr["cut_edges"]
            out["partition"] = ch.partition_traffic(
                batch["part"], fns[gh_names[0]][1][0], layers=len(gh_names))
            if rr is not None:
                out["partition"]["halo_bytes_saved_total"] = (
                    rr["bytes_saved_total"])
        return out


def _rows_of(z_stack):
    """The placements of ``sum_p beta_p z_p`` of a stack ``[P, N, D]``
    laid out on a mesh: its rows as the stack's are (None off a mesh)."""
    if not is_dtensor(z_stack):
        return None
    from torch.distributed.tensor import Shard

    return [Shard(0) if p.is_shard(1) else p for p in z_stack.placements]


def _batch_device(batch: Dict) -> torch.device:
    if "x" in batch:
        return batch["x"].device
    feats = batch["feats"] if "feats" in batch else batch["part"]["feats"]
    return next(iter(feats.values())).device


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a tree of dicts, lists and tuples."""
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _to_device(tree, device):
    """A tree of dicts, lists and tuples with every array (numpy or torch)
    placed on ``device`` as a tensor; Python scalars stay as they are."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return torch.as_tensor(tree, device=device)
    return tree


class PlannedModel:
    """Base for the model zoo: host-side ``prepare()`` and ``plan()``;
    every device-side stage delegates to the shared executor."""

    def __init__(self, cfg):
        self.cfg = cfg

    def plan(self) -> StagePlan:
        raise NotImplementedError

    @property
    def executor(self) -> StageGraphExecutor:
        ex = self.__dict__.get("_executor")
        if ex is None:
            ex = self.__dict__["_executor"] = StageGraphExecutor(
                self.plan(), self.cfg)
        return ex

    def prepare(self, hg, device=None) -> Dict:
        raise NotImplementedError

    def _finalize(self, batch: Dict, device) -> Dict:
        """End-of-``prepare`` hook (port of the reference's
        ``_maybe_partition``): with ``plan.residency``, pick the hot sets
        from the *unpartitioned* tables (degree ordering is a property of
        the whole graph); with ``plan.partition``, rewrite the batch into
        the partitioned layout and attach the hot-halo overlay maps,
        otherwise remap the tables into the cache-extended pool; then place
        the batch on ``device``, once."""
        plan = self.plan()
        tables = (residency.build_tables(plan, batch)
                  if plan.residency is not None else None)
        if plan.partition is not None:
            batch = dpart.partition_batch(plan, batch)
            if tables is not None:
                batch["residency"] = residency.partition_overlay(tables,
                                                                 batch)
        elif tables is not None:
            batch = residency.apply(plan, batch, tables)
        return _to_device(batch, device)

    def init(self, gen: torch.Generator, batch: Dict) -> Dict:
        return self.executor.init(gen, batch)

    def fp(self, params: Dict, batch: Dict):
        return self.executor.fp(params, batch)

    def na(self, params: Dict, batch: Dict, h):
        return self.executor.na(params, batch, h)

    def sa(self, params: Dict, batch: Dict, z):
        return self.executor.sa(params, batch, z)

    def head(self, params: Dict, z, batch: Dict = None):
        return self.executor.head(params, z, batch)

    def forward(self, params: Dict, batch: Dict) -> torch.Tensor:
        return self.executor.forward(params, batch)

    def forward_overlapped(self, params: Dict, batch: Dict) -> torch.Tensor:
        return self.executor.forward_overlapped(params, batch)

    def stage_records(self, params: Dict, batch: Dict, n_chips: int = 1,
                      **kw) -> Dict:
        return self.executor.stage_records(params, batch, n_chips=n_chips,
                                           **kw)
