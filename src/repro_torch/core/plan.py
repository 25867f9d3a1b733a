"""Declarative stage plans — each HGNN model's execution as data (port of
``repro/core/plan.py``).

A :class:`StagePlan` is an L-layer stack of :class:`LayerPlan`\\ s, each
with its FP/NA/SA specs and the inter-layer handoff; one executor
(:mod:`repro_torch.core.pipeline`) interprets it.  The spec dataclasses and
their ``__post_init__`` checks are the reference's.  The reference's
sharding rule tables (``batch_specs`` / ``param_specs`` and the mesh axis
names) are dropped: the port runs on one device, where they are no-ops.

The executor of the port serves the arms of HAN, RGCN and MAGNN
(``pipeline.check_ported``); a plan that names another arm raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class FPSpec:
    """Stage 2 — Feature Projection: ``per_type`` | ``dense`` | ``identity``."""

    kind: str = "per_type"
    sharded: bool = True  # the reference's shard constraints; no-op here
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
    """Graph-partitioned execution (not ported yet: ROADMAP Queue 1 item 12)."""

    k: int
    halo: str = "auto"
    static_shapes: bool = False


@dataclass(frozen=True)
class SampleSpec:
    """Request-path neighbor sampling (not ported yet: Queue 1 item 13)."""

    fanout: int
    ladder: Tuple[Tuple[int, int], ...]
    seed: int = 0


@dataclass(frozen=True)
class ResidencySpec:
    """Hot-feature residency: ``cache_rows`` hot rows per node type in a
    cache section of the gather pool (one device; ``pin_targets`` is the
    serving cache's, not ported yet: Queue 1 item 13)."""

    cache_rows: int
    pin_targets: bool = True


@dataclass(frozen=True)
class ScheduleSpec:
    """Async stage-graph schedule (not ported yet: Queue 1 item 14)."""

    depth: int = 2
    overlap_halo: bool = True
    overlap_metapaths: bool = True
    prefetch: bool = True

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError(f"ScheduleSpec.depth must be >= 1: {self.depth}")


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
