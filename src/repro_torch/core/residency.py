"""Hot-feature residency on one device: a degree-ordered feature cache for
the NA gathers (port of the single-device part of
``repro/core/residency.py:60-231``).

Per source type, the top-``cache_rows`` rows by *reference count* under
the plan's own index tables (degree ordering) become the hot set.  The
neighbour tables are remapped through a LUT so hot references address a
contiguous cache section appended to the source pool
(``pool = concat(h, h[hot])`` — the executor's residency arm, or the
``cached_gather`` kernel on MAGNN's instance gathers).  The section is a
bitwise row copy, so outputs are bit-exact by construction.  The hot set
and the remap are computed once from the layer-invariant index tables, so
every layer of an L-layer stack reuses the same resident rows.

Everything here is host-side numpy, run by ``prepare()`` before the batch
is placed on its device.  The reference's ``partition_overlay`` waits for
graph partitioning (ROADMAP Queue 1 item 12), and ``graph_degrees`` and
``HotRowCache`` for sampled serving (item 13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.core.plan import StagePlan


def hot_set(counts: np.ndarray, capacity: int) -> np.ndarray:
    """Top-``capacity`` row ids by ``(count desc, id asc)`` — slot 0 is the
    hottest row.  Deterministic: ties break toward the smaller row id, and
    the capacity clamps to the population."""
    n = len(counts)
    c = int(min(max(capacity, 0), n))
    order = np.lexsort((np.arange(n), -np.asarray(counts)))
    return order[:c].astype(np.int32)


def _populations(batch: Dict) -> Dict[str, int]:
    return {t: int(f.shape[0]) for t, f in batch["feats"].items()}


def _iter_gathers(plan: StagePlan, batch: Dict) -> Iterator[Tuple]:
    """Yield ``(src_type, idx_array, valid_mask_or_None)`` for every NA
    gather table of a prepared batch, in a fixed order.  ``None`` means
    every entry is a real reference (edge lists)."""
    kind, layout = plan.na.kind, plan.na.layout
    if kind == "gat":  # the stacked layout is the only ported GAT one
        yield plan.target, batch["nbr"], batch["mask"]
    elif kind == "mean":
        for key in sorted(batch["rels"]):
            s = key[0]
            rel = batch["rels"][key]
            if layout == "csr":
                yield s, rel[1], None
            elif layout == "bucketed":
                for _row_ids, nbr, mask in rel:
                    yield s, nbr, mask
            else:  # padded
                yield s, rel[0], rel[1]
    elif kind == "instance":
        for (nodes, mask), types in zip(batch["instances"], plan.metapaths):
            for j, ty in enumerate(types):
                yield ty, nodes[..., j], mask
    else:
        raise ValueError(f"no residency gather walk for NA kind {kind!r}")


@dataclass
class ResidencyTables:
    """Host-side product of :func:`build_tables` for one prepared batch."""

    hot: Dict[str, np.ndarray]  # type -> [C_t] hot row ids, degree-ordered
    rank: Dict[str, np.ndarray]  # type -> [N_t] row -> cache slot (-1 cold)
    lut: Dict[str, np.ndarray]  # type -> [N_t] row -> extended-pool index
    counts: Dict[str, np.ndarray]  # type -> [N_t] reference counts
    populations: Dict[str, int]
    cache_rows: int


def build_tables(plan: StagePlan, batch: Dict) -> ResidencyTables:
    """Reference-count every NA gather table and select per-type hot
    sets."""
    spec = plan.residency
    pops = _populations(batch)
    counts: Dict[str, np.ndarray] = {}
    for t, idx, mask in _iter_gathers(plan, batch):
        a = np.asarray(idx)
        a = a[np.asarray(mask) > 0] if mask is not None else a.reshape(-1)
        c = counts.get(t)
        if c is None:
            c = np.zeros(pops[t], np.int64)
        counts[t] = c + np.bincount(a.astype(np.int64), minlength=pops[t])
    hot = {t: hot_set(c, spec.cache_rows) for t, c in counts.items()}
    rank, lut = {}, {}
    for t, ht in hot.items():
        n = pops[t]
        r = np.full(n, -1, np.int32)
        r[ht] = np.arange(len(ht), dtype=np.int32)
        rank[t] = r
        m = np.arange(n, dtype=np.int32)
        m[ht] = n + np.arange(len(ht), dtype=np.int32)
        lut[t] = m
    return ResidencyTables(hot=hot, rank=rank, lut=lut, counts=counts,
                           populations=pops, cache_rows=spec.cache_rows)


def _count_hits(plan: StagePlan, batch: Dict,
                tables: ResidencyTables) -> Dict[str, int]:
    """Deterministic hit/miss counters over one full pass of the gather
    tables: hits = valid references addressing a hot row, and
    ``hits + misses == rows`` (total gathered rows) by construction."""
    hits = rows = 0
    for t, idx, mask in _iter_gathers(plan, batch):
        a = np.asarray(idx)
        a = a[np.asarray(mask) > 0] if mask is not None else a.reshape(-1)
        rows += int(a.size)
        hits += int((tables.rank[t][a] >= 0).sum())
    return {
        "hits": hits,
        "misses": rows - hits,
        "rows": rows,
        "cache_rows": int(sum(len(h) for h in tables.hot.values())),
    }


def apply(plan: StagePlan, batch: Dict, tables: ResidencyTables) -> Dict:
    """Remap every NA index table through the LUT (hot references -> the
    cache section appended to the source pool) and attach
    ``batch["residency"]``: the hot sets for the executor's pool arm and
    the deterministic counters.  Pad entries remap too — their masks
    zero-weight them in every aggregation, so the substitution is
    bit-exact."""
    counters = _count_hits(plan, batch, tables)
    lut = tables.lut
    out = dict(batch)

    def remap(t, a):
        if t not in lut:
            return a
        return lut[t][np.asarray(a)]

    kind, layout = plan.na.kind, plan.na.layout
    if kind == "gat":
        out["nbr"] = remap(plan.target, batch["nbr"])
    elif kind == "mean":
        rels = {}
        for key, rel in batch["rels"].items():
            s = key[0]
            if layout == "csr":
                rels[key] = (rel[0], remap(s, rel[1]))
            elif layout == "bucketed":
                rels[key] = [(rid, remap(s, nbr), m) for rid, nbr, m in rel]
            else:
                rels[key] = (remap(s, rel[0]), rel[1])
        out["rels"] = rels
    elif kind == "instance":
        inst = []
        for (nodes, mask), types in zip(batch["instances"], plan.metapaths):
            nn = np.asarray(nodes).copy()
            for j, ty in enumerate(types):
                if ty in lut:
                    nn[..., j] = lut[ty][nn[..., j]]
            inst.append((nn, mask))
        out["instances"] = inst
    out["residency"] = {
        "hot": {t: np.asarray(h, np.int32) for t, h in tables.hot.items()},
        "counters": counters,
    }
    return out
