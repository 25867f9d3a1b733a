"""Hot-feature residency: a degree-ordered feature cache for the NA
gathers (port of ``repro/core/residency.py``), for every ported layout: HAN's
``stacked``, ``bucketed`` and ``csr`` GAT tables, RGCN's relation tables,
MAGNN's instance positions and GCN's edge list.

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
is placed on its device.  ``partition_overlay`` (port of ``:234``) is
the partitioned plans' arm: the hot sets still come from the
unpartitioned tables, and each partition selects the hot rows of its halo
from a partition-local cache instead of exchanging them (the executor's
``gather_halo``).  ``graph_degrees`` and ``HotRowCache`` (port of
``:287-369``) are the serve engine's live per-type cache over the sampled
frontier.
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


def _populations(plan: StagePlan, batch: Dict) -> Dict[str, int]:
    if "feats" in batch:
        return {t: int(f.shape[0]) for t, f in batch["feats"].items()}
    # GCN: one homogeneous table
    return {plan.target: int(batch["x"].shape[0])}


def _iter_gathers(plan: StagePlan, batch: Dict) -> Iterator[Tuple]:
    """Yield ``(src_type, idx_array, valid_mask_or_None)`` for every NA
    gather table of a prepared batch, in a fixed order.  ``None`` means
    every entry is a real reference (edge lists)."""
    kind, layout = plan.na.kind, plan.na.layout
    if kind == "gat":
        t = plan.target
        if layout == "csr":
            for _seg, idx in batch["edges"]:
                yield t, idx, None
        elif layout == "bucketed":
            for bks in batch["buckets"]:
                for _row_ids, nbr, mask in bks:
                    yield t, nbr, mask
        else:  # stacked
            yield t, batch["nbr"], batch["mask"]
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
    elif kind == "gcn":
        yield plan.target, batch["idx"], None
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
    pops = _populations(plan, batch)
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
        t = plan.target
        if layout == "csr":
            out["edges"] = [(seg, remap(t, idx))
                            for seg, idx in batch["edges"]]
        elif layout == "bucketed":
            out["buckets"] = [[(rid, remap(t, nbr), m) for rid, nbr, m in bks]
                              for bks in batch["buckets"]]
        else:
            out["nbr"] = remap(t, batch["nbr"])
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
    elif kind == "gcn":
        out["idx"] = remap(plan.target, batch["idx"])
    out["residency"] = {
        "hot": {t: np.asarray(h, np.int32) for t, h in tables.hot.items()},
        "counters": counters,
    }
    return out


def partition_overlay(tables: ResidencyTables, batch: Dict) -> Dict:
    """Partitioned residency (port of ``:234``): the per-partition overlay
    tables of an already-partitioned batch, from hot sets chosen on the
    unpartitioned tables.

    ``hot_flat[t]``  [C] flat own-order indices (``owner * n_max + local``)
                     of the hot rows: each partition-local cache row is a
                     bitwise copy of an owned row.
    ``halo_slot[t]`` [K, H_max] cache slot of each halo entry, -1 where the
                     entry's global vertex is cold (or a pad): slot >= 0
                     entries are read from the cache, so hot halo rows
                     skip the exchange.

    The cached exchange's index is merged here, on the host, once:
    ``where(slot >= 0, hot_flat[slot], halo_src)``.  A hot entry's cache
    row is its vertex's flat owned row, the row ``halo_src`` names, so the
    merged index is ``halo_src`` itself (checked here) and the executor's
    cached exchange is the uncached one flat gather, bit for bit.
    """
    part = batch["part"]
    hot_flat: Dict = {}
    halo_slot: Dict = {}
    hits = rows = 0
    for t, hot_g in tables.hot.items():
        if t not in part.get("own", {}):
            continue
        own = np.asarray(part["own"][t])
        om = np.asarray(part["own_mask"][t]).reshape(-1) > 0
        of = own.reshape(-1)
        n_t = tables.populations[t]
        g2f = np.full(n_t, -1, np.int64)
        g2f[of[om]] = np.nonzero(om)[0]
        hf = g2f[hot_g]
        if not (hf >= 0).all():
            raise ValueError(f"hot rows of type {t!r} must all be owned")
        rank = tables.rank[t]
        hs = np.asarray(part["halo_src"][t])
        hm = np.asarray(part["halo_mask"][t]) > 0
        halo_g = of[hs.reshape(-1)].reshape(hs.shape)
        slot = np.where(hm, rank[halo_g], -1).astype(np.int32)
        merged = np.where(slot >= 0, hf[np.maximum(slot, 0)], hs)
        if not np.array_equal(merged, hs):
            raise ValueError(f"type {t!r}: a hot halo entry's cache row is "
                             "not the owned row its halo_src names")
        hot_flat[t] = hf.astype(np.int32)
        halo_slot[t] = slot
        hits += int((slot >= 0).sum())
        rows += int(hm.sum())
    return {
        "hot_flat": hot_flat,
        "halo_slot": halo_slot,
        "counters": {
            "hits": hits,
            "misses": rows - hits,
            "rows": rows,
            "cache_rows": int(sum(len(h) for h in tables.hot.values())),
        },
    }


# ---------------------------------------------------------------------------
# the live cache (serving's per-step sampled frontier)
# ---------------------------------------------------------------------------


def graph_degrees(hg) -> Dict[str, np.ndarray]:
    """Per-type source degrees — how often each vertex is gathered as a
    neighbor source across every relation.  The serving cache's priority
    ordering (a degree proxy for the request-time reference counts)."""
    deg = {t: np.zeros(n, np.int64) for t, n in hg.node_counts.items()}
    for (s, _r, _d), a in hg.relations.items():
        deg[s] += np.asarray(a.sum(axis=1)).reshape(-1).astype(np.int64)
    return deg


class HotRowCache:
    """Deterministic degree-priority hot-row cache (host-side simulator and
    the serving engine's live per-type cache).

    Priority of row ``r`` is ``(degree[r], -r)`` — higher is better, and no
    two rows tie.  On a miss with a full cache, the candidate is admitted
    only if it outranks the lowest-priority *unpinned* resident, which is
    evicted; pinned rows are never evicted.  Replaying the same access
    trace therefore always reproduces the same resident set and counters.
    """

    def __init__(self, capacity: int, degree: np.ndarray):
        self.degree = np.asarray(degree)
        self.capacity = int(min(max(capacity, 0), len(self.degree)))
        self.resident: set = set()
        self.pinned: set = set()
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0

    def _prio(self, r: int) -> Tuple[int, int]:
        return (int(self.degree[r]), -int(r))

    def access(self, row) -> bool:
        """One gather of ``row``: returns True on a cache hit; a miss runs
        the deterministic admission/eviction policy."""
        row = int(row)
        if row in self.resident:
            self.hits += 1
            return True
        self.misses += 1
        if self.capacity == 0:
            return False
        if len(self.resident) < self.capacity:
            self.resident.add(row)
            self.inserts += 1
            return False
        unpinned = [r for r in self.resident if r not in self.pinned]
        if not unpinned:
            return False  # everything pinned by the in-flight batch
        victim = min(unpinned, key=self._prio)
        if self._prio(row) > self._prio(victim):
            self.resident.discard(victim)
            self.evictions += 1
            self.resident.add(row)
            self.inserts += 1
        return False

    def access_many(self, rows) -> Tuple[int, int]:
        h0, m0 = self.hits, self.misses
        for r in np.asarray(rows).reshape(-1):
            self.access(r)
        return self.hits - h0, self.misses - m0

    def pin(self, rows) -> None:
        self.pinned.update(int(r) for r in np.asarray(rows).reshape(-1))

    def unpin(self, rows) -> None:
        self.pinned.difference_update(
            int(r) for r in np.asarray(rows).reshape(-1))

    @property
    def counters(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "rows": self.hits + self.misses,
            "inserts": self.inserts,
            "evictions": self.evictions,
            "resident": len(self.resident),
            "capacity": self.capacity,
        }
