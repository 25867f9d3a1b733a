"""Request-path neighbor sampling (serving-side Subgraph Build); port of
``repro/serve/sampler.py``.

The host arrays are the reference's byte for byte, dtypes included (int32
index tables, float32 masks): the sampler is numpy, and the batch's
arrays become CPU tensors through ``torch.from_numpy`` (no copy); the
serve engine places each batch on its device.

Serving traffic arrives as requests — "classify these target vertices, now"
— not as a full-graph forward.  :class:`HGNNSampler` extracts, for a set of
target vertices, the k-hop / per-metapath neighborhood of the graph and
relabels it into the *same* device layouts the stage-graph executor already
dispatches on (stacked ``[P, N, K]`` metapath tables for HAN, per-relation
padded tables for RGCN, instance tables for MAGNN, flat edge lists for
GCN), so the executor's arms — baseline / fused / bucketed / epilogue,
L ≥ 1 — run unchanged on the minibatch.

Two properties make this serving-grade rather than a toy:

* **Shape bucketing.**  Every sampled batch is padded to a rung of the
  plan's ``SampleSpec.ladder`` — a small fixed set of ``(t_cap, f_cap)``
  shapes.  Warmup runs one forward per rung (:meth:`dummy_batch`), which
  sizes every kernel scratch buffer, and serving never meets a new shape.
  Pad rows carry all-masked neighbor lists (the padded aggregators emit
  exact zeros for them) and the batch's ``row_mask`` keeps them out of the
  semantic-attention score means.  Pad bucket rows and pad edges name the
  row ``cap``, one past the table; the executor's sampled arms drop them
  into a sink row (``core/stages.py``).

* **Parity by identity.**  The sampler precomputes the full-graph tables
  with *exactly* the model ``prepare()``'s RNG stream (same seed, same
  build-call order).  Whenever a rung's clamped cap covers a whole node
  type, that type is relabeled by the identity and its tables are reused
  verbatim — so a minibatch over *all* targets with fan-out ≥ max degree is
  bit-exact against the full-graph forward.

Fan-out caps: per hop, each row keeps the first ``min(fanout, K_table)``
entries of its precomputed padded row (deterministic; the table itself was
degree-capped with the model's RNG).  Overflowing a rung truncates the
*frontier*, farthest hop first — never the targets — and reports the count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import metapath as mp
from repro_torch.core.hgraph import HeteroGraph
from repro_torch.core.plan import StagePlan


_t = torch.from_numpy  # a host array as a CPU tensor, sharing its memory


@dataclasses.dataclass
class SampledBatch:
    """One relabeled, rung-padded minibatch plus its host-side metadata."""

    batch: Dict  # host batch (CPU tensors) for StageGraphExecutor.forward
    target_ids: np.ndarray  # [n_targets] global ids, request order
    target_rows: np.ndarray  # [n_targets] local row in the logits table
    rung: Tuple[int, int]
    rung_index: int
    local: Dict[str, np.ndarray]  # type -> [n_real] local->global id map
    meta: Dict  # deterministic traffic record (characterize.sample_traffic)

    @property
    def n_targets(self) -> int:
        return len(self.target_ids)


class _TypeTable:
    """Per-type local vertex table: [targets | frontier (hop order) | pads].

    ``identity`` short-circuits the relabeling when the rung cap covers the
    whole type — local ids == global ids and downstream index tables are
    reused verbatim (the parity path).
    """

    def __init__(self, n_type: int, cap: int, targets: np.ndarray,
                 frontier: np.ndarray):
        self.n_type = n_type
        self.cap = cap
        self.identity = cap == n_type
        if self.identity:
            self.ids = np.arange(n_type, dtype=np.int64)
            self.truncated = 0
        else:
            ids = np.concatenate([targets, frontier])
            self.truncated = max(0, len(ids) - cap)
            if self.truncated:
                # never drop targets: the engine sizes chunks to t_cap and
                # the frontier is hop-ordered, so the tail is the far rim
                assert len(targets) <= cap, (
                    f"targets ({len(targets)}) overflow the rung cap ({cap})")
                ids = ids[:cap]
            self.ids = ids
        self.n_real = len(self.ids)
        self._lut = np.full(n_type, -1, np.int64)
        self._lut[self.ids[::-1]] = np.arange(self.n_real)[::-1]
        # duplicate target ids map to their first occurrence

    def relabel(self, ids: np.ndarray) -> np.ndarray:
        """Global -> local; dropped (truncated) ids come back as -1."""
        return self._lut[ids]

    def rows(self, feats: np.ndarray, out: Optional[np.ndarray] = None
             ) -> np.ndarray:
        """The local feature table, zero rows past ``n_real``; written into
        ``out`` (``[cap, ...]`` of ``feats``' dtype) when it is given."""
        if self.identity:
            return feats
        if out is None:
            out = np.zeros((self.cap,) + feats.shape[1:], feats.dtype)
            out[: self.n_real] = feats[self.ids]
            return out
        np.take(feats, self.ids, axis=0, out=out[: self.n_real])
        out[self.n_real:] = 0
        return out


def _rows(table: _TypeTable, t: str, feats: np.ndarray, alloc) -> np.ndarray:
    """``table.rows(feats)``, into ``alloc(t, shape, dtype)`` if given."""
    if alloc is None or table.identity:
        return table.rows(feats)
    return table.rows(feats, alloc(t, (table.cap,) + feats.shape[1:],
                                   feats.dtype))


class HGNNSampler:
    """Neighbor sampler for one (plan, graph) pair.

    ``plan.sample`` must be set (models declare it when ``cfg.fanout >= 1``).
    The constructor precomputes the full-graph index tables with the model
    ``prepare()``'s exact RNG stream; :meth:`sample` then extracts / relabels
    / rung-pads per request batch — pure numpy, handed over as CPU tensors.
    """

    def __init__(self, plan: StagePlan, cfg, hg: HeteroGraph):
        if plan.sample is None:
            raise ValueError(
                f"{plan.model}'s plan has no SampleSpec — set "
                "cfg.fanout >= 1")
        if plan.na.layout == "csr" and plan.na.kind != "gcn":
            raise ValueError(
                "request-path sampling needs a padded NA layout (the csr "
                "edge lists have no shape-stable minibatch form): set "
                "cfg.fused=True")
        self.plan = plan
        self.cfg = cfg
        self.hg = hg
        self.spec = plan.sample
        self.ladder = tuple(self.spec.ladder)
        self.target = plan.target
        self.n_target_type = hg.node_counts[self.target]
        self.feat_dims = {t: hg.feat_dim(t) for t in hg.features}
        self._build_full_tables()

    # ------------------------------------------------------------------
    # full-graph tables (prepare()'s exact RNG stream)
    # ------------------------------------------------------------------
    def _build_full_tables(self) -> None:
        cfg, plan = self.cfg, self.plan
        rng = np.random.default_rng(cfg.seed)
        kind = plan.na.kind
        if kind == "gat":  # HAN
            self.k_eff = min(self.spec.fanout, cfg.max_degree)
            self.subs = [
                mp.build_padded(self.hg, list(p), cfg.max_degree, rng)
                for p in plan.metapaths
            ]
            if plan.na.layout == "bucketed":
                self.full_buckets = [
                    mp.bucket_padded(s, cfg.degree_buckets) for s in self.subs
                ]
        elif kind == "mean":  # RGCN — replicate prepare()'s loop + RNG order
            self.k_eff = min(self.spec.fanout, cfg.max_degree)
            self.rel_keys = sorted(self.hg.relations.keys())
            self.rel_tables: Dict = {}
            for key in self.rel_keys:
                adj_in = self.hg.relations[key].T.tocsr()
                nbr = np.zeros((adj_in.shape[0], cfg.max_degree), np.int32)
                mask = np.zeros((adj_in.shape[0], cfg.max_degree), np.float32)
                indptr, indices = adj_in.indptr, adj_in.indices
                for u in range(adj_in.shape[0]):
                    nbrs = indices[indptr[u]: indptr[u + 1]]
                    if len(nbrs) > cfg.max_degree:
                        nbrs = rng.choice(nbrs, cfg.max_degree, replace=False)
                    nbr[u, : len(nbrs)] = nbrs
                    mask[u, : len(nbrs)] = 1.0
                self.rel_tables[key] = (nbr, mask)
            if plan.na.layout == "bucketed":
                self.full_buckets = {
                    key: mp.bucket_padded(
                        mp.PaddedSubgraph(nbr, mask, [key[0], key[2]]),
                        cfg.degree_buckets)
                    for key, (nbr, mask) in self.rel_tables.items()
                }
        elif kind == "instance":  # MAGNN
            self.k_eff = min(self.spec.fanout, cfg.max_instances)
            self.insts = [
                mp.enumerate_instances(self.hg, list(p), cfg.max_instances,
                                       rng=rng)
                for p in plan.metapaths
            ]
        elif kind == "gcn":
            csr = mp.build_csr(self.hg, [self.target, self.target])
            self.csr = csr
            deg = np.diff(csr.indptr)
            self.max_deg = int(deg.max()) if len(deg) else 1
            self.k_eff = min(self.spec.fanout, self.max_deg)
        else:
            raise ValueError(f"unknown NA kind {kind!r}")

    # ------------------------------------------------------------------
    # rung selection
    # ------------------------------------------------------------------
    def _clamp(self, f_cap: int, t: str) -> int:
        return min(f_cap, self.hg.node_counts[t])

    def pick_rung(self, n_targets: int, need: Dict[str, int],
                  max_rung: Optional[int] = None) -> int:
        """Smallest rung fitting the targets and every type's real rows;
        overflow falls through to the largest allowed rung (frontier
        truncation).  ``max_rung`` clamps the choice — the serve engine's
        degradation controller passes it to fan work *down* the ladder
        under pressure while staying inside the warmed rung set."""
        ladder = self.spec.ladder
        hi = (len(ladder) - 1 if max_rung is None
              else min(int(max_rung), len(ladder) - 1))
        for i, (t_cap, f_cap) in enumerate(ladder[: hi + 1]):
            if n_targets > t_cap:
                continue
            if all(n <= self._clamp(f_cap, ty) for ty, n in need.items()):
                return i
        if n_targets > max(t for t, _ in ladder[: hi + 1]):
            raise ValueError(
                f"{n_targets} targets overflow the ladder's largest "
                f"allowed t_cap {max(t for t, _ in ladder[: hi + 1])} — "
                "chunk requests (the serve engine's slot_targets does this)")
        return hi

    # ------------------------------------------------------------------
    # sampling entry points
    # ------------------------------------------------------------------
    def sample(self, targets: np.ndarray, rung: Optional[int] = None,
               max_rung: Optional[int] = None,
               alloc=None) -> SampledBatch:
        """The rung-padded batch of ``targets``.  ``alloc(type, shape,
        dtype)``, if given, returns the array that a relabeled type's
        feature table is written into (the bulk of a batch's bytes; the
        serve engine hands out pinned host memory), else a new one."""
        targets = np.asarray(targets, np.int64).reshape(-1)
        if len(targets) and (targets.min() < 0
                             or targets.max() >= self.n_target_type):
            raise ValueError(f"target ids out of range for type "
                             f"{self.target!r} ({self.n_target_type} nodes)")
        kind = self.plan.na.kind
        if kind == "gat":
            return self._sample_gat(targets, rung, max_rung, alloc)
        if kind == "mean":
            return self._sample_mean(targets, rung, max_rung, alloc)
        if kind == "instance":
            return self._sample_instance(targets, rung, max_rung, alloc)
        return self._sample_gcn(targets, rung, max_rung, alloc)

    def dummy_batch(self, rung: int, alloc=None) -> SampledBatch:
        """An all-pad batch at the rung's exact shapes — warmup runs one
        forward per rung, so serving meets no new shape."""
        return self.sample(np.zeros(0, np.int64), rung=rung, alloc=alloc)

    # ------------------------------------------------------------------
    # shared pieces
    # ------------------------------------------------------------------
    def _frontier_order(self, hop_sets: List[np.ndarray],
                        exclude: np.ndarray) -> np.ndarray:
        """Frontier ids in (hop, id) order, minus ``exclude`` — the
        truncation order drops the farthest rim first."""
        seen = set(exclude.tolist())
        out: List[int] = []
        for ids in hop_sets:
            for g in np.unique(ids).tolist():
                if g not in seen:
                    seen.add(g)
                    out.append(g)
        return np.asarray(out, np.int64)

    def _meta(self, rung_i: int, targets: np.ndarray,
              tables: Dict[str, _TypeTable], index_bytes: int) -> Dict:
        frontier_rows = {
            t: int(tb.n_real - (len(targets) if t == self.target else 0))
            for t, tb in tables.items()
        }
        frontier_bytes = sum(
            rows * self.feat_dims[t] * 4 for t, rows in frontier_rows.items())
        return {
            "model": self.plan.model,
            "rung": tuple(self.spec.ladder[rung_i]),
            "rung_index": rung_i,
            "n_targets": int(len(targets)),
            "frontier_rows": int(sum(frontier_rows.values())),
            "frontier_bytes": int(frontier_bytes),
            "index_bytes": int(index_bytes),
            "truncated_rows": int(sum(tb.truncated for tb in tables.values())),
            "fanout": int(self.spec.fanout),
        }

    def _finish(self, batch: Dict, targets: np.ndarray, rung_i: int,
                tables: Dict[str, _TypeTable], index_bytes: int,
                ) -> SampledBatch:
        tt = tables[self.target]
        target_rows = (targets.copy() if tt.identity
                       else tt.relabel(targets))
        return SampledBatch(
            batch=batch,
            target_ids=targets,
            target_rows=target_rows,
            rung=tuple(self.spec.ladder[rung_i]),
            rung_index=rung_i,
            local={t: tb.ids for t, tb in tables.items()},
            meta=self._meta(rung_i, targets, tables, index_bytes),
        )

    def _row_mask(self, table: _TypeTable) -> torch.Tensor:
        m = np.zeros(table.cap, np.float32)
        m[: table.n_real] = 1.0
        return _t(m)

    # ------------------------------------------------------------------
    # HAN — stacked / bucketed metapath tables (target->target graphs)
    # ------------------------------------------------------------------
    def _expand_gat(self, targets: np.ndarray) -> List[np.ndarray]:
        """Per-hop frontier over the union of the metapath graphs; hop
        count = n_layers (each layer re-aggregates the same graphs)."""
        k = self.k_eff
        hop_sets: List[np.ndarray] = []
        cur = np.unique(targets)
        known = set(cur.tolist())
        for _ in range(self.plan.n_layers):
            nxt: List[np.ndarray] = []
            for sub in self.subs:
                nbr = sub.nbr[cur, :k]
                msk = sub.mask[cur, :k] > 0
                nxt.append(np.unique(nbr[msk]).astype(np.int64))
            new = (np.unique(np.concatenate(nxt)) if nxt
                   else np.zeros(0, np.int64))
            new = np.asarray([g for g in new.tolist() if g not in known],
                             np.int64)
            if len(new) == 0:
                break
            hop_sets.append(new)
            known.update(new.tolist())
            cur = new
        return hop_sets

    def _sample_gat(self, targets: np.ndarray, rung: Optional[int],
                    max_rung: Optional[int] = None,
                    alloc=None) -> SampledBatch:
        cfg, plan = self.cfg, self.plan
        k = self.k_eff
        hop_sets = self._expand_gat(targets)
        frontier = self._frontier_order(hop_sets, targets)
        need = {self.target: len(targets) + len(frontier)}
        rung_i = (self.pick_rung(len(targets), need, max_rung)
                  if rung is None else rung)
        f_cap = self._clamp(self.spec.ladder[rung_i][1], self.target)
        table = _TypeTable(self.n_target_type, f_cap, targets, frontier)
        tables = {self.target: table}

        feats = _rows(table, self.target, self.hg.features[self.target],
                      alloc)
        batch: Dict = {
            "feats": {self.target: _t(feats)},
            "feat_dims": {self.target: self.feat_dims[self.target]},
            "n_nodes": table.cap,
            "row_mask": self._row_mask(table),
        }
        index_bytes = 0
        if plan.na.layout == "bucketed":
            bks = []
            for b in self.full_buckets:
                bks.append(self._local_buckets(b, table, k))
                index_bytes += sum(r.nbytes + n.nbytes + m.nbytes
                                   for r, n, m in bks[-1])
            batch["buckets"] = [
                [(_t(r), _t(n), _t(m)) for r, n, m in bk] for bk in bks
            ]
        else:  # stacked
            if table.identity and k == cfg.max_degree:
                nbr, mask = mp.stack_padded(self.subs)
            else:
                locs = [self._local_padded(s.nbr[:, :k], s.mask[:, :k], table,
                                           table)
                        for s in self.subs]
                nbr, mask = mp.stack_padded([
                    mp.PaddedSubgraph(n, m, list(p))
                    for (n, m), p in zip(locs, plan.metapaths)
                ])
            index_bytes += nbr.nbytes + mask.nbytes
            batch["nbr"] = _t(nbr)
            batch["mask"] = _t(mask)
        return self._finish(batch, targets, rung_i, tables, index_bytes)

    def _local_padded(self, nbr: np.ndarray, mask: np.ndarray,
                      dst: _TypeTable, src: _TypeTable,
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Slice a full padded table to ``dst``'s local rows and relabel the
        entries into ``src``'s local ids; entries outside the local source
        set (or rung pads) mask out."""
        rows_g = dst.ids
        sub_n = nbr[rows_g]  # [n_real, K]
        sub_m = mask[rows_g].copy()
        loc = src.relabel(sub_n.reshape(-1)).reshape(sub_n.shape)
        sub_m[loc < 0] = 0.0
        loc = np.where(loc < 0, 0, loc)
        out_n = np.zeros((dst.cap, nbr.shape[1]), np.int32)
        out_m = np.zeros((dst.cap, nbr.shape[1]), np.float32)
        out_n[: len(rows_g)] = loc
        out_m[: len(rows_g)] = sub_m
        return out_n, out_m

    def _local_buckets(self, full: mp.DegreeBuckets, table: _TypeTable,
                       k: int) -> List[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]]:
        """Rung-shaped degree buckets: full-graph caps (static), every
        bucket padded to ``table.cap`` rows with out-of-range pad row_ids
        (the scatter drops them).  Identity + full fan-out reuses the full
        tables verbatim — the bucketed parity path."""
        if table.identity and k >= max(n.shape[1] for n in full.nbr):
            return [(full.row_ids[i], full.nbr[i], full.mask[i])
                    for i in range(full.n_buckets)]
        # rebuild the full padded view, then re-bin local rows by the full
        # caps so bucket shapes stay rung-static
        caps = [n.shape[1] for n in full.nbr]
        n_full = full.n_nodes
        nbr_f = np.zeros((n_full, max(caps)), np.int32)
        mask_f = np.zeros((n_full, max(caps)), np.float32)
        for i in range(full.n_buckets):
            rows, cap = full.row_ids[i], caps[i]
            nbr_f[rows, :cap] = full.nbr[i]
            mask_f[rows, :cap] = full.mask[i]
        kk = min(k, max(caps))
        loc_n, loc_m = self._local_padded(nbr_f[:, :kk], mask_f[:, :kk],
                                          table, table)
        deg = loc_m.sum(axis=1)
        out = []
        assigned = np.zeros(table.cap, bool)
        for cap in caps:
            cap_k = min(cap, kk)
            rows = np.flatnonzero(~assigned & (deg <= cap_k)
                                  & (np.arange(table.cap) < table.n_real))
            assigned[rows] = True
            row_ids = np.full(table.cap, table.cap, np.int32)  # sink pads
            row_ids[: len(rows)] = rows
            b_n = np.zeros((table.cap, cap_k), np.int32)
            b_m = np.zeros((table.cap, cap_k), np.float32)
            b_n[: len(rows)] = loc_n[rows, :cap_k]
            b_m[: len(rows)] = loc_m[rows, :cap_k]
            out.append((row_ids, b_n, b_m))
        return out

    # ------------------------------------------------------------------
    # RGCN — per-relation padded (or bucketed) tables, typed k-hop ball
    # ------------------------------------------------------------------
    def _sample_mean(self, targets: np.ndarray, rung: Optional[int],
                     max_rung: Optional[int] = None,
                     alloc=None) -> SampledBatch:
        cfg, plan = self.cfg, self.plan
        k = self.k_eff
        # typed frontier expansion: per hop, every relation (s, r, d) pulls
        # the in-neighbors (type s) of the currently-needed rows of type d
        per_type_hops: Dict[str, List[np.ndarray]] = {
            t: [] for t in self.hg.node_counts}
        known: Dict[str, set] = {t: set() for t in self.hg.node_counts}
        cur: Dict[str, np.ndarray] = {
            t: np.zeros(0, np.int64) for t in self.hg.node_counts}
        cur[self.target] = np.unique(targets)
        known[self.target].update(cur[self.target].tolist())
        for _ in range(plan.n_layers):
            nxt: Dict[str, List[np.ndarray]] = {
                t: [] for t in self.hg.node_counts}
            for key in self.rel_keys:
                s, _, d = key
                rows = cur[d]
                if len(rows) == 0:
                    continue
                nbr, mask = self.rel_tables[key]
                sub_n, sub_m = nbr[rows, :k], mask[rows, :k] > 0
                nxt[s].append(np.unique(sub_n[sub_m]).astype(np.int64))
            new_cur: Dict[str, np.ndarray] = {}
            for t in self.hg.node_counts:
                cand = (np.unique(np.concatenate(nxt[t])) if nxt[t]
                        else np.zeros(0, np.int64))
                new = np.asarray(
                    [g for g in cand.tolist() if g not in known[t]], np.int64)
                if len(new):
                    per_type_hops[t].append(new)
                    known[t].update(new.tolist())
                new_cur[t] = new
            cur = new_cur
            if not any(len(v) for v in cur.values()):
                break

        tables: Dict[str, _TypeTable] = {}
        need: Dict[str, int] = {}
        for t in self.hg.node_counts:
            tgt = targets if t == self.target else np.zeros(0, np.int64)
            frontier = self._frontier_order(per_type_hops[t], tgt)
            need[t] = len(tgt) + len(frontier)
        rung_i = (self.pick_rung(len(targets), need, max_rung)
                  if rung is None else rung)
        f_cap = self.spec.ladder[rung_i][1]
        for t in self.hg.node_counts:
            tgt = targets if t == self.target else np.zeros(0, np.int64)
            frontier = self._frontier_order(per_type_hops[t], tgt)
            tables[t] = _TypeTable(self.hg.node_counts[t],
                                   self._clamp(f_cap, t), tgt, frontier)

        batch: Dict = {
            "feats": {t: _t(_rows(tables[t], t, self.hg.features[t], alloc))
                      for t in self.hg.features},
            "counts": {t: tables[t].cap for t in self.hg.node_counts},
            "feat_dims": dict(self.feat_dims),
            "rels": {},
        }
        index_bytes = 0
        for key in self.rel_keys:
            s, _, d = key
            if plan.na.layout == "bucketed":
                bk = self._local_buckets_rel(key, tables[d], tables[s], k)
                index_bytes += sum(r.nbytes + n.nbytes + m.nbytes
                                   for r, n, m in bk)
                batch["rels"][key] = [
                    (_t(r), _t(n), _t(m)) for r, n, m in bk
                ]
            else:
                nbr, mask = self.rel_tables[key]
                if (tables[d].identity and tables[s].identity
                        and k == cfg.max_degree):
                    loc_n, loc_m = nbr, mask
                else:
                    loc_n, loc_m = self._local_padded(
                        nbr[:, :k], mask[:, :k], tables[d], tables[s])
                index_bytes += loc_n.nbytes + loc_m.nbytes
                batch["rels"][key] = (_t(loc_n), _t(loc_m))
        return self._finish(batch, targets, rung_i, tables, index_bytes)

    def _local_buckets_rel(self, key, dst: _TypeTable, src: _TypeTable,
                           k: int) -> List[Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]]:
        full = self.full_buckets[key]
        if (dst.identity and src.identity
                and k >= max(n.shape[1] for n in full.nbr)):
            return [(full.row_ids[i], full.nbr[i], full.mask[i])
                    for i in range(full.n_buckets)]
        caps = [n.shape[1] for n in full.nbr]
        nbr, mask = self.rel_tables[key]
        kk = min(k, max(caps))
        loc_n, loc_m = self._local_padded(nbr[:, :kk], mask[:, :kk], dst, src)
        deg = loc_m.sum(axis=1)
        out = []
        assigned = np.zeros(dst.cap, bool)
        for cap in caps:
            cap_k = min(cap, kk)
            rows = np.flatnonzero(~assigned & (deg <= cap_k)
                                  & (np.arange(dst.cap) < dst.n_real))
            assigned[rows] = True
            row_ids = np.full(dst.cap, dst.cap, np.int32)  # sink pads
            row_ids[: len(rows)] = rows
            b_n = np.zeros((dst.cap, cap_k), np.int32)
            b_m = np.zeros((dst.cap, cap_k), np.float32)
            b_n[: len(rows)] = loc_n[rows, :cap_k]
            b_m[: len(rows)] = loc_m[rows, :cap_k]
            out.append((row_ids, b_n, b_m))
        return out

    # ------------------------------------------------------------------
    # MAGNN — instance tables; frontier = instance node sets
    # ------------------------------------------------------------------
    def _sample_instance(self, targets: np.ndarray, rung: Optional[int],
                         max_rung: Optional[int] = None,
                         alloc=None) -> SampledBatch:
        plan, cfg = self.plan, self.cfg
        i_cap = self.k_eff  # instances per target (the MAGNN fan-out knob)
        # target-type rows that need REAL instance rows: the requested
        # targets plus, per extra layer, the target-type nodes appearing in
        # already-kept instances (layer l's gathers read layer l-1's
        # updated tables)
        rows = np.unique(targets)
        known = set(rows.tolist())
        tgt_hops: List[np.ndarray] = []
        cur = rows
        for _ in range(plan.n_layers - 1):
            nxt: List[np.ndarray] = []
            for ib, p in zip(self.insts, plan.metapaths):
                nodes = ib.nodes[cur, :i_cap]  # [n, I, L]
                msk = ib.mask[cur, :i_cap] > 0
                for j, ty in enumerate(p):
                    if ty == self.target:
                        nxt.append(np.unique(nodes[:, :, j][msk])
                                   .astype(np.int64))
            cand = (np.unique(np.concatenate(nxt)) if nxt
                    else np.zeros(0, np.int64))
            new = np.asarray([g for g in cand.tolist() if g not in known],
                             np.int64)
            if len(new) == 0:
                break
            tgt_hops.append(new)
            known.update(new.tolist())
            cur = new
        inst_rows = (np.concatenate([np.unique(targets)] + tgt_hops)
                     if len(targets) or tgt_hops else np.zeros(0, np.int64))

        # per-type frontiers: every node on a kept instance
        per_type: Dict[str, List[np.ndarray]] = {
            t: [] for t in self.hg.node_counts}
        for ib, p in zip(self.insts, plan.metapaths):
            if len(inst_rows) == 0:
                continue
            nodes = ib.nodes[inst_rows, :i_cap]
            msk = ib.mask[inst_rows, :i_cap] > 0
            for j, ty in enumerate(p):
                per_type[ty].append(
                    np.unique(nodes[:, :, j][msk]).astype(np.int64))

        tables: Dict[str, _TypeTable] = {}
        need: Dict[str, int] = {}
        types_used = {ty for p in plan.metapaths for ty in p} | {self.target}
        fr: Dict[str, np.ndarray] = {}
        for t in sorted(types_used):
            tgt = targets if t == self.target else np.zeros(0, np.int64)
            hops = ([np.asarray(sorted(set(
                np.concatenate(per_type[t]).tolist())), np.int64)]
                if per_type[t] else [])
            fr[t] = self._frontier_order(hops, tgt)
            need[t] = len(tgt) + len(fr[t])
        rung_i = (self.pick_rung(len(targets), need, max_rung)
                  if rung is None else rung)
        f_cap = self.spec.ladder[rung_i][1]
        for t in sorted(types_used):
            tgt = targets if t == self.target else np.zeros(0, np.int64)
            tables[t] = _TypeTable(self.hg.node_counts[t],
                                   self._clamp(f_cap, t), tgt, fr[t])

        tt = tables[self.target]
        batch: Dict = {
            "feats": {t: _t(_rows(tables[t], t, self.hg.features[t], alloc))
                      for t in sorted(types_used)},
            "feat_dims": {t: self.feat_dims[t] for t in sorted(types_used)},
            "n_nodes": tt.cap,
            "row_mask": self._row_mask(tt),
        }
        index_bytes = 0
        instances = []
        for ib, p in zip(self.insts, plan.metapaths):
            if tt.identity and i_cap == cfg.max_instances and all(
                    tables[ty].identity for ty in p):
                nodes, mask = ib.nodes, ib.mask
            else:
                nodes = np.zeros((tt.cap, i_cap, len(p)), np.int32)
                mask = np.zeros((tt.cap, i_cap), np.float32)
                src_rows = ib.nodes[tt.ids, :i_cap]  # [n_real, I, L]
                src_mask = ib.mask[tt.ids, :i_cap].copy()
                for j, ty in enumerate(p):
                    loc = tables[ty].relabel(src_rows[:, :, j].reshape(-1))
                    loc = loc.reshape(src_rows.shape[:2])
                    # an instance touching a truncated node drops entirely
                    src_mask[(loc < 0) & (src_mask > 0)] = 0.0
                    nodes[: tt.n_real, :, j] = np.where(loc < 0, 0, loc)
                mask[: tt.n_real] = src_mask
                nodes[mask == 0] = 0
            index_bytes += nodes.nbytes + mask.nbytes
            instances.append((_t(nodes), _t(mask)))
        batch["instances"] = instances
        return self._finish(batch, targets, rung_i, tables, index_bytes)

    # ------------------------------------------------------------------
    # GCN — homogeneous edge list, 2 aggregation hops per layer
    # ------------------------------------------------------------------
    def _sample_gcn(self, targets: np.ndarray, rung: Optional[int],
                    max_rung: Optional[int] = None,
                    alloc=None) -> SampledBatch:
        plan = self.plan
        k = self.k_eff
        indptr, indices = self.csr.indptr, self.csr.indices
        cur = np.unique(targets)
        known = set(cur.tolist())
        hop_sets: List[np.ndarray] = []
        for _ in range(2 * plan.n_layers):  # 2 aggregations per layer
            nxt: List[np.ndarray] = []
            for g in cur.tolist():
                nbrs = indices[indptr[g]: indptr[g] + min(
                    k, indptr[g + 1] - indptr[g])]
                nxt.append(nbrs.astype(np.int64))
            cand = (np.unique(np.concatenate(nxt)) if nxt
                    else np.zeros(0, np.int64))
            new = np.asarray([g for g in cand.tolist() if g not in known],
                             np.int64)
            if len(new) == 0:
                break
            hop_sets.append(new)
            known.update(new.tolist())
            cur = new
        frontier = self._frontier_order(hop_sets, targets)
        need = {self.target: len(targets) + len(frontier)}
        rung_i = (self.pick_rung(len(targets), need, max_rung)
                  if rung is None else rung)
        f_cap = self._clamp(self.spec.ladder[rung_i][1], self.target)
        table = _TypeTable(self.n_target_type, f_cap, targets, frontier)

        if table.identity and k == self.max_deg:
            seg, idx = (np.repeat(np.arange(table.cap, dtype=np.int32),
                                  np.diff(indptr)),
                        indices.astype(np.int32))
        else:
            e_cap = table.cap * max(k, 1)
            seg = np.full(e_cap, table.cap, np.int32)  # sink segment
            idx = np.zeros(e_cap, np.int32)
            e = 0
            for u_loc in range(table.n_real):
                g = table.ids[u_loc]
                nbrs = indices[indptr[g]: indptr[g] + min(
                    k, indptr[g + 1] - indptr[g])]
                loc = table.relabel(nbrs.astype(np.int64))
                loc = loc[loc >= 0][: k]
                seg[e: e + len(loc)] = u_loc
                idx[e: e + len(loc)] = loc
                e += len(loc)
        batch: Dict = {
            "x": _t(_rows(table, self.target, self.hg.features[self.target],
                          alloc)),
            "seg": _t(seg),
            "idx": _t(idx),
            "n_nodes": table.cap,
            "feat_dim": self.feat_dims[self.target],
        }
        return self._finish(batch, targets, rung_i, {self.target: table},
                            int(seg.nbytes + idx.nbytes))
