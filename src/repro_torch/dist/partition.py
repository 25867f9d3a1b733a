"""Graph-partitioned execution: the host-side partitioner and the halo
gather (port of ``repro/dist/partition.py``).

The paper's dominant stage, Neighbor Aggregation, is bound by irregular
neighbour traffic; at serving scale the vertex and feature tables are
split into partitions rather than replicated.  This module owns what the
partitioned execution mode needs:

* **Per-type vertex assignment**: a metapath-aware greedy edge-cut
  partitioner (:func:`edge_cut_assign`) for the target type, and a
  reference-majority assignment (:func:`reference_assign`) for every other
  gathered type.
* **Halo index maps**: per partition and per type, the non-owned vertices
  its local NA reads, padded per type to a uniform ``[K, H_max]`` table of
  *flat own-order indices* (``owner * n_max + local``), so the halo
  exchange is one gather over the stacked owned tables.
* **Per-partition relabeling**: neighbour, relation and instance tables
  rewritten from global vertex ids into partition-local coordinates
  (``0..n_max-1`` owned rows, ``n_max..`` halo rows), so every NA gather
  of the partitioned flow reads ``concat(own, halo)``.
* **The halo exchange**: :func:`gather_halo`.  With all K partitions on
  one device it is the reference's flat gather
  (``repro/dist/partition.py:245-247``); on a device mesh whose ``BATCH``
  axes divide K it is one all-gather of the owned tables over those axes
  (``halo="auto"``, the reference's ``shard_map`` arm) or DTensor's
  redistribution (``halo="xla"``), the same bits either way.

``partition_batch`` is the entry point: it rewrites a model's prepared
(unpartitioned) host batch into the layout that ``plan.partition`` declares,
for the ``stacked`` (HAN), ``padded`` relational (RGCN) and ``instances``
(MAGNN) NA layouts.  Everything here but :func:`gather_halo` is host numpy
(Subgraph Build, stage 1 of the paper), and every array it makes is
byte-equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import (BATCH, all_gather_rows, batch_group,
                                       current_mesh, is_dtensor,
                                       lead_placements, local,
                                       replicate, shard)


# ---------------------------------------------------------------------------
# vertex assignment
# ---------------------------------------------------------------------------


def edge_cut_assign(neigh: Sequence[np.ndarray], n_tokens: int,
                    k: int) -> np.ndarray:
    """Greedy streaming edge-cut assignment of ``len(neigh)`` vertices.

    ``neigh[v]`` lists the (type-offset) tokens vertex ``v``'s Neighbor
    Aggregation reads.  LDG-style: ``v`` goes to the partition whose
    assigned vertices share the most tokens with it, damped by a load
    penalty and capped at ``ceil(n / k)``.  Deterministic (ties break
    toward the lighter, lower-indexed partition)."""
    n = len(neigh)
    cap = -(-n // k) if n else 1
    owner = np.zeros(n, np.int32)
    loads = np.zeros(k, np.float64)
    # token -> per-partition count of assigned vertices that read it
    counts = np.zeros((max(n_tokens, 1), k), np.float64)
    for v in range(n):
        toks = neigh[v]
        if toks.size:
            score = counts[toks].sum(axis=0)
        else:
            score = np.zeros(k)
        score = score * (1.0 - loads / cap) - 1e-9 * loads
        score[loads >= cap] = -np.inf
        j = int(np.argmax(score))
        owner[v] = j
        loads[j] += 1.0
        if toks.size:
            counts[toks, j] += 1.0
    return owner


def reference_assign(votes: np.ndarray, k: int) -> np.ndarray:
    """Assign source-type vertices by reference majority: ``votes[v, j]``
    counts the partition-``j`` destination rows that read ``v``; each
    vertex goes to its strongest reader (capacity ``ceil(n / k)``,
    strongest preferences placed first); unreferenced vertices fill the
    lightest partitions."""
    n = votes.shape[0]
    cap = -(-n // k) if n else 1
    owner = np.zeros(n, np.int32)
    loads = np.zeros(k, np.int64)
    order = np.argsort(-votes.max(axis=1), kind="stable")
    for v in order:
        pref = np.argsort(-(votes[v] - 1e-9 * loads), kind="stable")
        for j in pref:
            if loads[j] < cap:
                owner[v] = j
                loads[j] += 1
                break
    return owner


# ---------------------------------------------------------------------------
# per-type partition + halo tables
# ---------------------------------------------------------------------------


@dataclass
class TypePartition:
    """One node type's vertex assignment in own-order coordinates."""

    owner: np.ndarray  # [N] int32 partition id per global vertex
    local: np.ndarray  # [N] int32 position within the owner's table
    own: np.ndarray  # [K, n_max] int32 global ids (0-padded)
    own_mask: np.ndarray  # [K, n_max] float32 {0,1}

    @property
    def n_max(self) -> int:
        return self.own.shape[1]

    @property
    def flat(self) -> np.ndarray:
        """[N] flat own-order index (``owner * n_max + local``)."""
        return (self.owner.astype(np.int64) * self.n_max
                + self.local.astype(np.int64))


def build_type_partition(owner: np.ndarray, k: int,
                         pad_to: int = 0) -> TypePartition:
    """Own-order tables of one type.  ``pad_to`` raises ``n_max`` to an
    assignment-independent capacity (``ceil(n / k)``) for static-shape
    plans; pad rows carry ``own_mask = 0`` and zero features."""
    n = len(owner)
    sizes = np.bincount(owner, minlength=k) if n else np.zeros(k, np.int64)
    n_max = max(int(sizes.max()) if n else 0, 1, int(pad_to))
    own = np.zeros((k, n_max), np.int32)
    own_mask = np.zeros((k, n_max), np.float32)
    local = np.zeros(n, np.int32)
    for j in range(k):
        rows = np.flatnonzero(owner == j)
        own[j, : len(rows)] = rows
        own_mask[j, : len(rows)] = 1.0
        local[rows] = np.arange(len(rows), dtype=np.int32)
    return TypePartition(owner.astype(np.int32), local, own, own_mask)


def build_halo(tp: TypePartition, referenced: Sequence[np.ndarray],
               k: int, pad_to: int = 0
               ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """Halo maps of one type: per partition the non-owned vertices it
    reads, padded to ``[K, H_max]`` flat own-order indices and a mask, and
    the raw per-partition halo id lists.  ``pad_to`` raises ``H_max`` to the
    type's vertex count for static-shape plans; pad entries point at flat
    index 0 with ``halo_mask = 0``, and no relabeled table addresses them."""
    halos: List[np.ndarray] = []
    for j in range(k):
        refs = np.unique(referenced[j]).astype(np.int64)
        halos.append(refs[tp.owner[refs] != j])
    h_max = max(max((len(h) for h in halos), default=0), int(pad_to))
    halo_src = np.zeros((k, h_max), np.int32)
    halo_mask = np.zeros((k, h_max), np.float32)
    for j, hj in enumerate(halos):
        if len(hj):
            halo_src[j, : len(hj)] = tp.flat[hj]
            halo_mask[j, : len(hj)] = 1.0
    return halo_src, halo_mask, halos


def local_lut(tp: TypePartition, halos: Sequence[np.ndarray],
              k: int) -> np.ndarray:
    """``lut[j, g]``: partition ``j``'s local coordinate of global vertex
    ``g`` (owned rows first, halo rows after ``n_max``), ``-1`` where ``j``
    never references it."""
    n = len(tp.owner)
    lut = np.full((k, max(n, 1)), -1, np.int64)
    for j in range(k):
        rows = np.flatnonzero(tp.owner == j)
        lut[j, rows] = tp.local[rows]
        if len(halos[j]):
            lut[j, halos[j]] = tp.n_max + np.arange(len(halos[j]))
    return lut


# ---------------------------------------------------------------------------
# the halo feature exchange (device side)
# ---------------------------------------------------------------------------


# the reference's exchange modes (``PartitionSpec.halo``); with every
# partition on one device both are the flat gather
HALO_MODES = ("auto", "xla")


def _flat_gather(h_own: torch.Tensor, halo_src: torch.Tensor
                 ) -> torch.Tensor:
    """``h_own [K, n, ...]`` read at the flat own-order rows ``halo_src
    [K', H_max]`` -> ``[K', H_max, ...]``."""
    k, n = h_own.shape[:2]
    tail = tuple(h_own.shape[2:])
    out = h_own.reshape((k * n,) + tail).index_select(0, halo_src.reshape(-1))
    return out.reshape(tuple(halo_src.shape) + tail)


def gather_halo(h_own: torch.Tensor, halo_src: torch.Tensor,
                mode: str = "auto") -> torch.Tensor:
    """Fetch halo feature rows from the stacked owned tables:
    ``h_own [K, n_max, ...]``, ``halo_src [K, H_max]`` flat own-order
    indices -> ``[K, H_max, ...]`` (the reference's ``:207-240``).  Pad
    entries name flat index 0, a row of the table, so no index ever leaves
    it.

    On a mesh (``use_mesh``, DTensor tables) the partition dim ``K`` lies
    over the ``BATCH`` axes.  With ``mode="auto"``, when those axes have a
    size above 1 that divides ``K`` and there are halo rows, each rank
    all-gathers the owned tables once over the ``BATCH`` group
    (``sharding.all_gather_rows`` inside a ``local`` region, the
    counterpart of the reference's ``shard_map``) and reads its
    partitions' halo rows locally: the one communication step of the
    partitioned flow.  Otherwise (``mode="xla"``, a size of 1, a size that
    does not divide ``K``) the table is laid out whole on every rank by
    DTensor's redistribution and each rank reads its rows from it.  Both
    are row selections of the same table, so they give the same bits;
    off a mesh this is the flat gather."""
    if current_mesh() is None or not is_dtensor(h_own):
        return _flat_gather(h_own, halo_src)
    k = h_own.shape[0]
    lead = (BATCH,) + (None,) * (h_own.dim() - 1)
    h_own = shard(h_own, *lead)  # a partition's rows whole on its rank
    halo_src = shard(halo_src, BATCH, None)
    size, group = batch_group(current_mesh())
    if (mode == "auto" and size > 1 and k % size == 0
            and halo_src.shape[1] > 0):
        return local(
            lambda h, idx: _flat_gather(all_gather_rows(h, group), idx),
            (h_own, halo_src), None, lead_placements(halo_src))
    return local(_flat_gather, (replicate(h_own), halo_src), None,
                 lead_placements(halo_src))


# ---------------------------------------------------------------------------
# batch partitioning (host side, per NA layout)
# ---------------------------------------------------------------------------


def partition_batch(plan, batch: Dict) -> Dict:
    """Rewrite a prepared (unpartitioned) host batch into the partitioned
    layout of ``plan.partition``, by NA layout; raises for layouts with no
    partitioned mode (``csr`` baselines, degree-bucketed tiles)."""
    spec = plan.partition
    if spec is None:
        return batch
    if plan.na.layout == "stacked":
        return _partition_stacked(plan, batch, spec.k)
    if plan.na.layout == "padded" and plan.na.kind == "mean":
        # a multi-layer rel_sum stack updates every node type a layer, so
        # every relation partitions, each on its destination type's owners
        if plan.n_layers > 1:
            return _partition_relational_ml(plan, batch, spec.k)
        return _partition_relational(plan, batch, spec.k)
    if plan.na.layout == "instances":
        return _partition_instances(plan, batch, spec.k)
    raise ValueError(
        f"partitioned execution supports the stacked / padded / instances NA "
        f"layouts, not {plan.na.layout!r} (model {plan.model!r}): baselines "
        "and degree-bucketed tiles have no per-partition relabeling")


def _part_feats(feats: np.ndarray, tp: TypePartition) -> np.ndarray:
    """Raw feature rows at their owners ([K, n_max, F], zero pads)."""
    return (feats[tp.own] * tp.own_mask[..., None]).astype(feats.dtype)


def _static_pads(plan, counts: Dict[str, int], k: int):
    """Per-type ``(n_pad, h_pad)`` capacities of ``static_shapes`` plans:
    ``ceil(n_ty / k)`` owned rows and ``n_ty`` halo rows, so every table
    shape is a function of the unpartitioned shapes and ``k``; ``({}, {})``
    (minimal shapes) otherwise."""
    if plan.partition is None or not plan.partition.static_shapes:
        return {}, {}
    return ({ty: max(-(-int(c) // k), 1) for ty, c in counts.items()},
            {ty: int(c) for ty, c in counts.items()})


EdgeLists = Dict[str, List[Tuple[np.ndarray, np.ndarray]]]


def _source_partitions(
    tp_t: TypePartition, edge_lists: EdgeLists, counts: Dict[str, int],
    k: int, tps: Dict[str, TypePartition],
    pads: Tuple[Dict[str, int], Dict[str, int]] = ({}, {}),
) -> Tuple[Dict, Dict, Dict, int, int]:
    """The shared middle of every layout: assign each gathered source type
    (types already in ``tps`` keep theirs), build its halo tables and
    relabeling LUTs, count the cut.  ``edge_lists``: type -> list of
    ``(dst_global, src_global)`` arrays of the mask-valid edges."""
    n_pad, h_pad = pads
    halo_src: Dict[str, np.ndarray] = {}
    halo_mask: Dict[str, np.ndarray] = {}
    luts: Dict[str, np.ndarray] = {}
    cut = total = 0
    for s in sorted(edge_lists):
        pairs = edge_lists[s]
        if s not in tps:
            votes = np.zeros((counts[s], k), np.float64)
            for dst, src in pairs:
                np.add.at(votes, (src, tp_t.owner[dst]), 1.0)
            tps[s] = build_type_partition(reference_assign(votes, k), k,
                                          pad_to=n_pad.get(s, 0))
        referenced = []
        for j in range(k):
            ids = [src[tp_t.owner[dst] == j] for dst, src in pairs]
            referenced.append(np.unique(np.concatenate(ids)) if ids
                              else np.zeros(0, np.int64))
        hs, hm, halos = build_halo(tps[s], referenced, k,
                                   pad_to=h_pad.get(s, 0))
        halo_src[s], halo_mask[s] = hs, hm
        luts[s] = local_lut(tps[s], halos, k)
        for dst, src in pairs:
            cut += int((tps[s].owner[src] != tp_t.owner[dst]).sum())
            total += len(dst)
    return halo_src, halo_mask, luts, cut, total


def _part_tables(tps: Dict[str, TypePartition], halo_src: Dict,
                 halo_mask: Dict, feats: Dict, tp_t: TypePartition, k: int,
                 cut: int, total: int) -> Dict:
    """The layout-independent part of the ``part`` dict: owned feature
    shards, ownership and halo maps, the output's inverse permutation."""
    return {
        "feats": {s: _part_feats(np.asarray(feats[s]), tps[s])
                  for s in sorted(tps)},
        "own": {s: tps[s].own for s in sorted(tps)},
        "own_mask": {s: tps[s].own_mask for s in sorted(tps)},
        "halo_src": {s: halo_src[s] for s in sorted(halo_src)},
        "halo_mask": {s: halo_mask[s] for s in sorted(halo_mask)},
        "inv": tp_t.flat.astype(np.int32),
        "meta": {"k": k, "cut_edges": cut, "edges_total": total},
    }


def _partition_stacked(plan, batch: Dict, k: int) -> Dict:
    """HAN's ``[P, N, Kd]`` stacked layout: destination = source = target
    type, one halo table, the neighbour stack relabeled per partition."""
    nbr = np.asarray(batch["nbr"])
    mask = np.asarray(batch["mask"])
    p_, n, kd = nbr.shape
    t = plan.target
    valid = mask > 0
    neigh = [np.unique(nbr[:, v][valid[:, v]]) for v in range(n)]
    pads = _static_pads(plan, {t: n}, k)
    tp = build_type_partition(edge_cut_assign(neigh, n, k), k,
                              pad_to=pads[0].get(t, 0))
    tps = {t: tp}
    pi, ni, ki = np.nonzero(valid)
    halo_src, halo_mask, luts, cut, total = _source_partitions(
        tp, {t: [(ni, nbr[pi, ni, ki])]}, {t: n}, k, tps, pads=pads)
    nbr_p = np.zeros((k, p_, tp.n_max, kd), np.int32)
    mask_p = np.zeros((k, p_, tp.n_max, kd), np.float32)
    for j in range(k):
        rows = np.flatnonzero(tp.owner == j)
        nbr_p[j, :, : len(rows)] = np.maximum(luts[t][j, nbr[:, rows]], 0)
        mask_p[j, :, : len(rows)] = mask[:, rows]
    part = _part_tables(tps, halo_src, halo_mask, batch["feats"], tp, k,
                        cut, total)
    part["nbr"] = nbr_p
    part["mask"] = mask_p
    return {"feat_dims": batch["feat_dims"], "n_nodes": batch["n_nodes"],
            "part": part}


def _target_edge_cut(rels_t: Dict, counts: Dict[str, int], n: int,
                     k: int, pad_to: int = 0) -> TypePartition:
    """Edge-cut assignment of the target type from its incoming padded
    relations: a destination row's tokens are the (type-offset) union of
    its source reads."""
    src_types = sorted({key[0] for key in rels_t})
    offs, off = {}, 0
    for s in src_types:
        offs[s] = off
        off += counts[s]
    neigh = []
    for v in range(n):
        toks = [r_nbr[v][r_mask[v] > 0] + offs[key[0]]
                for key, (r_nbr, r_mask) in sorted(rels_t.items())]
        neigh.append(np.unique(np.concatenate(toks)) if toks
                     else np.zeros(0, np.int64))
    return build_type_partition(edge_cut_assign(neigh, max(off, 1), k), k,
                                pad_to=pad_to)


def _relabel_rel(r_nbr, r_mask, tpd: TypePartition, lut: np.ndarray,
                 k: int) -> Tuple[np.ndarray, np.ndarray]:
    """One ``[N_d, Kd]`` relation table on its destination's owners."""
    kd = r_nbr.shape[1]
    nbr_p = np.zeros((k, tpd.n_max, kd), np.int32)
    mask_p = np.zeros((k, tpd.n_max, kd), np.float32)
    for j in range(k):
        rows = np.flatnonzero(tpd.owner == j)
        nbr_p[j, : len(rows)] = np.maximum(lut[j, r_nbr[rows]], 0)
        mask_p[j, : len(rows)] = r_mask[rows]
    return nbr_p, mask_p


def _relational_batch(batch: Dict, part: Dict) -> Dict:
    return {"feat_dims": batch["feat_dims"], "counts": batch["counts"],
            # keys only (init draws w_rel per sorted key); tables in `part`
            "rels": {key: () for key in batch["rels"]}, "part": part}


def _partition_relational(plan, batch: Dict, k: int) -> Dict:
    """RGCN's per-relation ``[N_d, Kd]`` layout, one layer: only relations
    into the target feed the head; the target is edge-cut assigned, every
    source type reference-assigned, one halo table a source type."""
    t = plan.target
    rels = {key: (np.asarray(v[0]), np.asarray(v[1]))
            for key, v in batch["rels"].items() if key[2] == t}
    counts = {ty: int(c) for ty, c in batch["counts"].items()}
    pads = _static_pads(plan, counts, k)
    tp_t = _target_edge_cut(rels, counts, counts[t], k,
                            pad_to=pads[0].get(t, 0))
    tps: Dict[str, TypePartition] = {t: tp_t}  # self-relations reuse it
    edge_lists: EdgeLists = {t: []}  # the target always gets a halo table
    for key, (r_nbr, r_mask) in sorted(rels.items()):
        di, ci = np.nonzero(r_mask > 0)
        edge_lists.setdefault(key[0], []).append((di, r_nbr[di, ci]))
    halo_src, halo_mask, luts, cut, total = _source_partitions(
        tp_t, edge_lists, counts, k, tps, pads=pads)
    part = _part_tables(tps, halo_src, halo_mask, batch["feats"], tp_t, k,
                        cut, total)
    part["rels"] = {key: _relabel_rel(r_nbr, r_mask, tp_t, luts[key[0]], k)
                    for key, (r_nbr, r_mask) in rels.items()}
    return _relational_batch(batch, part)


def _partition_relational_ml(plan, batch: Dict, k: int) -> Dict:
    """RGCN's padded layout for an L-layer stack: hidden rel_sum layers
    update every node type, so every relation partitions on its
    destination type's owners and every type gets halo tables covering
    the reads of all its readers.  The maps are graph-invariant, so
    ``gather_halo`` re-runs a layer on the updated features.  The target
    keeps the edge-cut; the other types are reference-majority assigned
    from relations whose destination is already settled (breadth-first
    from the target); types nobody reads fill round-robin."""
    t = plan.target
    rels = {key: (np.asarray(v[0]), np.asarray(v[1]))
            for key, v in batch["rels"].items()}
    counts = {ty: int(c) for ty, c in batch["counts"].items()}
    n_pad, h_pad = _static_pads(plan, counts, k)
    rels_t = {key: v for key, v in rels.items() if key[2] == t}
    tps: Dict[str, TypePartition] = {
        t: _target_edge_cut(rels_t, counts, counts[t], k,
                            pad_to=n_pad.get(t, 0))}
    remaining = [ty for ty in sorted(counts) if ty not in tps]
    while remaining:
        progress = False
        for ty in list(remaining):
            votes = np.zeros((counts[ty], k), np.float64)
            seen = False
            for key, (r_nbr, r_mask) in sorted(rels.items()):
                s, _, d = key
                if s != ty or d not in tps:
                    continue
                di, ci = np.nonzero(r_mask > 0)
                np.add.at(votes, (r_nbr[di, ci], tps[d].owner[di]), 1.0)
                seen = True
            if seen:
                tps[ty] = build_type_partition(reference_assign(votes, k), k,
                                               pad_to=n_pad.get(ty, 0))
                remaining.remove(ty)
                progress = True
        if not progress:  # types unreachable from the target: round-robin
            for ty in remaining:
                owner = (np.arange(counts[ty]) % k).astype(np.int32)
                tps[ty] = build_type_partition(owner, k,
                                               pad_to=n_pad.get(ty, 0))
            remaining = []
    halo_src: Dict[str, np.ndarray] = {}
    halo_mask: Dict[str, np.ndarray] = {}
    luts: Dict[str, np.ndarray] = {}
    cut = total = 0
    for s in sorted(counts):
        pairs = []  # (dst owner per edge, src global ids)
        for key, (r_nbr, r_mask) in sorted(rels.items()):
            if key[0] != s:
                continue
            di, ci = np.nonzero(r_mask > 0)
            pairs.append((tps[key[2]].owner[di], r_nbr[di, ci]))
        referenced = []
        for j in range(k):
            ids = [src[downer == j] for downer, src in pairs]
            referenced.append(np.unique(np.concatenate(ids)) if ids
                              else np.zeros(0, np.int64))
        hs, hm, halos = build_halo(tps[s], referenced, k,
                                   pad_to=h_pad.get(s, 0))
        halo_src[s], halo_mask[s] = hs, hm
        luts[s] = local_lut(tps[s], halos, k)
        for downer, src in pairs:
            cut += int((tps[s].owner[src] != downer).sum())
            total += len(src)
    part = _part_tables(tps, halo_src, halo_mask, batch["feats"], tps[t], k,
                        cut, total)
    part["rels"] = {key: _relabel_rel(r_nbr, r_mask, tps[key[2]],
                                      luts[key[0]], k)
                    for key, (r_nbr, r_mask) in rels.items()}
    return _relational_batch(batch, part)


def _partition_instances(plan, batch: Dict, k: int) -> Dict:
    """MAGNN's ``[N, I, L]`` instance tables: every path position is a
    typed gather, so each referenced type gets its own halo table and the
    node ids relabel per position through that type's LUT."""
    t = plan.target
    insts = [(np.asarray(nodes), np.asarray(m))
             for nodes, m in batch["instances"]]
    counts = {ty: int(f.shape[0]) for ty, f in batch["feats"].items()}
    n = counts[t]
    types_used = sorted({ty for path in plan.metapaths for ty in path})
    offs, off = {}, 0
    for ty in types_used:
        offs[ty] = off
        off += counts[ty]
    neigh = []
    for v in range(n):
        toks = []
        for (nodes, m), path in zip(insts, plan.metapaths):
            rows = nodes[v][m[v] > 0]  # [i_valid, L]
            for j, ty in enumerate(path):
                if j == 0:
                    continue  # position 0 is the target row itself
                toks.append(rows[:, j].astype(np.int64) + offs[ty])
        neigh.append(np.unique(np.concatenate(toks)) if toks
                     else np.zeros(0, np.int64))
    pads = _static_pads(plan, counts, k)
    tp_t = build_type_partition(edge_cut_assign(neigh, max(off, 1), k), k,
                                pad_to=pads[0].get(t, 0))
    tps: Dict[str, TypePartition] = {t: tp_t}
    edge_lists: EdgeLists = {t: []}  # the target always gets a halo table
    for (nodes, m), path in zip(insts, plan.metapaths):
        di, ii = np.nonzero(m > 0)
        for j, ty in enumerate(path):
            if j == 0:
                continue  # position 0 is the (owned) target row itself
            edge_lists.setdefault(ty, []).append((di, nodes[di, ii, j]))
    halo_src, halo_mask, luts, cut, total = _source_partitions(
        tp_t, edge_lists, counts, k, tps, pads=pads)
    insts_p = []
    for (nodes, m), path in zip(insts, plan.metapaths):
        _, i, l = nodes.shape
        nodes_p = np.zeros((k, tp_t.n_max, i, l), np.int32)
        mask_p = np.zeros((k, tp_t.n_max, i), np.float32)
        for part_j in range(k):
            rows = np.flatnonzero(tp_t.owner == part_j)
            relab = np.stack(
                [np.maximum(luts[path[j]][part_j, nodes[rows][:, :, j]], 0)
                 for j in range(l)], axis=-1)
            nodes_p[part_j, : len(rows)] = relab
            mask_p[part_j, : len(rows)] = m[rows]
        insts_p.append((nodes_p, mask_p))
    part = _part_tables(tps, halo_src, halo_mask, batch["feats"], tp_t, k,
                        cut, total)
    part["instances"] = insts_p
    return {"feat_dims": batch["feat_dims"], "n_nodes": batch["n_nodes"],
            "part": part}


# ---------------------------------------------------------------------------
# partition failover (serving resilience)
# ---------------------------------------------------------------------------


def surviving_partition_spec(spec, failed: Sequence[int]):
    """The spec over the survivors when partitions are lost mid-serve:
    the next sampled batch is re-partitioned over ``k - len(failed)``
    partitions from scratch (assignment, halo maps and relabeling are pure
    functions of the batch and ``k``), and the head's inverse permutation
    restores global row order, so the logits stay those of a never-failed
    run."""
    lost = {int(f) for f in failed}
    bad = [f for f in lost if not 0 <= f < spec.k]
    if bad:
        raise ValueError(f"failed partition ids {sorted(bad)} out of range "
                         f"for k={spec.k}")
    keep = spec.k - len(lost)
    if keep < 1:
        raise RuntimeError("no surviving partitions")
    return dataclasses.replace(spec, k=keep)
