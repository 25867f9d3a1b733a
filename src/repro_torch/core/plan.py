"""Declarative stage plans — each HGNN model's execution as data (port of
``repro/core/plan.py``).

A :class:`StagePlan` is an L-layer stack of :class:`LayerPlan`\\ s, each
with its FP/NA/SA specs and the inter-layer handoff; one executor
(:mod:`repro_torch.core.pipeline`) interprets it.  The spec dataclasses and
their ``__post_init__`` checks are the reference's.

Plan fields double as the sharding contract, as in the reference:
``batch_specs`` / ``param_specs`` are declarative (leaf name, ndim) ->
logical-spec rules (:data:`ShardRule`) that ``launch/serve.
hgnn_shardings`` resolves on a mesh, with no model-specific branch there.
The rule sets follow ``stages.HGNN_STAGE_SPECS``: destination nodes over
the ``BATCH`` axes, source pools replicated, FP weights over ``'model'``.

The executor of the port serves the arms of HAN, RGCN, MAGNN and GCN,
full-graph or sampled, and graph-partitioned for the first three
(``pipeline.check_ported``); a plan that names another arm raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.dist.sharding import BATCH, MODEL

# (leaf-or-container key, ndim, logical per-dim spec): a batch or param
# tree leaf whose dict path contains ``key`` and whose rank is ``ndim``
# gets the spec; everything else replicates (``launch/serve.
# hgnn_shardings``).
ShardRule = Tuple[str, int, Tuple]


@dataclass(frozen=True)
class FPSpec:
    """Stage 2 — Feature Projection: ``per_type`` | ``dense`` | ``identity``."""

    kind: str = "per_type"
    sharded: bool = True  # stage-aware shard constraints (no-op off-mesh)
    heads: bool = False  # reshape the target type to [N, H, Dh]


@dataclass(frozen=True)
class NASpec:
    """Stage 3 — Neighbor Aggregation (TB-Type gather + EW attention math)."""

    kind: str  # gat | mean | instance | gcn
    layout: str  # csr | stacked | bucketed | padded | instances
    activation: Optional[str] = None  # elu | relu | None (post-aggregation)
    use_pallas: bool = False  # hand-written kernels on the hot loop


@dataclass(frozen=True)
class SASpec:
    """Stage 4 — Semantic Aggregation."""

    kind: str  # attention | rel_sum | none
    stacked: bool = True  # concat-free [P, N, D] input vs per-metapath list
    # Fused NA→SA epilogue: the semantic-score pass-1 partial accumulates
    # inside the NA kernel.  Honoured only on the stacked layout.
    fuse_epilogue: bool = False


@dataclass(frozen=True)
class HeadSpec:
    """Classifier head."""

    kind: str = "linear"  # linear (z @ W) | select_linear (z[target] @ W)
    target: Optional[str] = None
    param: str = "cls"


@dataclass(frozen=True)
class PartitionSpec:
    """Graph-partitioned execution (:mod:`repro_torch.dist.partition`).

    The vertex and feature tables are split into ``k`` edge-cut partitions
    (metapath-aware target assignment, reference-majority source
    assignment); FP and NA run a partition at a time on its owned rows,
    and the one exchange between partitions is the ``gather_halo`` stage.
    ``halo`` is the reference's exchange mode: ``"auto"`` all-gathers the
    owned tables over a device mesh's ``BATCH`` axes when they divide
    ``k``, ``"xla"`` leaves the redistribution to DTensor; both take the
    flat gather on one device, as the reference does off a mesh.
    ``static_shapes`` pads every per-type table to
    assignment-independent capacities (``ceil(n / k)`` owned rows,
    ``n`` halo rows), so a sampled batch's partitioned shapes depend on its
    rung alone (the serve engine sets it); the pads are zero rows under a
    zero mask, so outputs keep their bits."""

    k: int  # number of graph partitions (>= 1; 1 = trivial, empty halos)
    halo: str = "auto"
    static_shapes: bool = False


@dataclass(frozen=True)
class SampleSpec:
    """Request-path neighbor sampling (:mod:`repro_torch.serve.sampler`).

    ``fanout`` caps the neighbours kept per hop (per metapath or relation;
    the padded width is ``min(fanout, cfg.max_degree)``, or
    ``cfg.max_instances`` for MAGNN).  ``ladder`` is the tuple of ``(t_cap,
    f_cap)`` rungs, small to large: ``t_cap`` bounds the targets of a
    batch, ``f_cap`` each type's local vertex table (clamped to the type's
    population).  A batch is padded to the smallest rung that fits, so its
    shapes are a pure function of the rung.  ``seed`` is ``cfg.seed``, so
    the sampler's full tables replay ``prepare()``'s RNG stream."""

    fanout: int
    ladder: Tuple[Tuple[int, int], ...]
    seed: int = 0


@dataclass(frozen=True)
class ResidencySpec:
    """Hot-feature residency: ``cache_rows`` hot rows per node type in a
    cache section of the gather pool (one device).  ``pin_targets`` pins
    a serving step's in-flight targets in the serve engine's live
    :class:`~repro_torch.core.residency.HotRowCache`."""

    cache_rows: int
    pin_targets: bool = True


@dataclass(frozen=True)
class ScheduleSpec:
    """Async stage-graph schedule (``StageGraphExecutor.
    forward_overlapped``): ``depth`` stage results in flight (1: each
    waited for, the serial baseline); ``overlap_halo`` splits partitioned
    NA into an owned-rows pass beside the halo exchange and a merge;
    ``overlap_metapaths`` runs each metapath's NA as a stage of its own
    where the serial arm loops them; ``prefetch`` lets the serve engine
    sample the next step on a worker thread."""

    depth: int = 2
    overlap_halo: bool = True
    overlap_metapaths: bool = True
    prefetch: bool = True

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError(f"ScheduleSpec.depth must be >= 1: {self.depth}")


def default_sample_ladder(
    fanout: int, width: int, hops: int = 1,
    t_rungs: Tuple[int, ...] = (8, 32, 128),
) -> Tuple[Tuple[int, int], ...]:
    """The automatic ``(t_cap, f_cap)`` ladder of a :class:`SampleSpec`:
    ``f_cap = t_cap * (1 + width * hops)``, where ``width`` is the model's
    nominal per-target per-hop frontier (metapaths × padded degree for
    HAN, ...) and ``hops`` the expansion depth.  The sampler clamps
    ``f_cap`` to each type's population and counts any truncation."""
    return tuple((t, t * (1 + max(width, 1) * max(hops, 1)))
                 for t in t_rungs)


@dataclass(frozen=True)
class LayerPlan:
    """One FP→NA→SA round of an L-layer stack; ``handoff`` names which
    per-type tables this layer materializes for the next one
    (``target`` | ``all`` | ``target+carry``)."""

    fp: FPSpec
    na: NASpec
    sa: SASpec
    handoff: str = "target"
    carry: Tuple[str, ...] = ()
    residency: Optional[ResidencySpec] = None


@dataclass(frozen=True)
class StagePlan:
    """One model's whole execution, declared as data."""

    model: str
    target: str  # target node type (classification rows)
    layers: Tuple[LayerPlan, ...]
    head: HeadSpec
    metapaths: Tuple[Tuple[str, ...], ...] = ()
    batch_specs: Tuple[ShardRule, ...] = ()
    param_specs: Tuple[ShardRule, ...] = (("fp", 2, (None, MODEL)),)
    partition: Optional[PartitionSpec] = None
    sample: Optional[SampleSpec] = None
    schedule: Optional[ScheduleSpec] = None

    def __post_init__(self):
        if not self.layers:
            raise ValueError("a StagePlan needs at least one LayerPlan")
        lp0 = self.layers[0]
        for i, lp in enumerate(self.layers[1:], start=1):
            # the executor dispatches every layer on layer 0's NA/SA specs,
            # so a differing hidden spec would be silently ignored
            if (lp.na != lp0.na or lp.sa != lp0.sa
                    or lp.residency != lp0.residency
                    or (lp.handoff, lp.carry) != (lp0.handoff, lp0.carry)):
                raise ValueError(
                    "NA/SA/residency specs and the handoff/carry contract "
                    "must be layer-uniform (the host-side index tables are "
                    "built once and the executor dispatches every layer on "
                    f"layer 0's specs); layer {i} declares "
                    f"{(lp.na, lp.sa, lp.residency, lp.handoff, lp.carry)} "
                    f"vs layer 0's "
                    f"{(lp0.na, lp0.sa, lp0.residency, lp0.handoff, lp0.carry)}")

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def fp(self) -> FPSpec:
        return self.layers[0].fp

    @property
    def na(self) -> NASpec:
        return self.layers[0].na

    @property
    def sa(self) -> SASpec:
        return self.layers[0].sa

    @property
    def residency(self) -> Optional[ResidencySpec]:
        return self.layers[0].residency

    @property
    def shards_on_mesh(self) -> bool:
        """CSR gather/scatter cannot shard; every padded layout can."""
        return self.na.layout != "csr"


# Shared batch-sharding rule sets (destination nodes over BATCH, source
# pools replicated: the stage-aware strategy of `stages.HGNN_STAGE_SPECS`).
STACKED_BATCH_SPECS: Tuple[ShardRule, ...] = (
    ("nbr", 3, (None, BATCH, None)),  # HAN [P, N, K]
    ("mask", 3, (None, BATCH, None)),
)
BUCKETED_BATCH_SPECS: Tuple[ShardRule, ...] = (
    ("buckets", 2, (BATCH, None)),  # per-bucket nbr / mask [n_b, K_b]
    ("buckets", 1, (BATCH,)),  # per-bucket row_ids
)
RELATION_BATCH_SPECS: Tuple[ShardRule, ...] = (
    ("rels", 2, (BATCH, None)),  # per-relation nbr / mask [N_d, K]
    ("rels", 1, (BATCH,)),  # per-relation bucket row_ids
)
INSTANCE_BATCH_SPECS: Tuple[ShardRule, ...] = (
    ("instances", 3, (BATCH, None, None)),  # [N, I, L] instance node tables
    ("instances", 2, (BATCH, None)),  # [N, I] instance masks
)
# Partitioned batches: every table under batch["part"] leads with the
# partition dim K, which shards over the BATCH axes; the 1-d leaves (the
# output inverse permutation) stay replicated.
PARTITION_BATCH_SPECS: Tuple[ShardRule, ...] = (
    ("part", 4, (BATCH, None, None, None)),  # [K, P, n, Kd] / [K, n, I, L]
    ("part", 3, (BATCH, None, None)),  # [K, n, F] feats / [K, n, Kd] rels
    ("part", 2, (BATCH, None)),  # [K, n] masks / [K, H] halo maps
)
