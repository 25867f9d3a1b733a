"""The stage-graph executor: one interpreter for every :class:`StagePlan`
(port of ``repro/core/pipeline.py``).

A plan is an L-layer stack of FP→NA→SA rounds; the executor loops them
with the per-type feature tables as the carried state over the
layer-invariant index tables built once in ``prepare()``.  Layer 0's
parameters live at the root of the parameter dict and hidden layers under
``params["layers"][l-1]`` with the same leaf names, as in the reference,
so the reference's own parameters carry across unchanged
(``repro_torch.interop.params_from_numpy``).

Ported arms — HAN (slice 1) and RGCN (slice 2) full-graph inference:

* FP ``per_type`` (layer 0; reshaped to heads when ``fp.heads``), the
  ``dense`` re-projection of HAN's hidden layers with the ``target``
  handoff, and the ``identity`` FP of RGCN's hidden layers with the
  ``all`` handoff;
* NA ``gat`` on the ``stacked`` ``[P, N, K]`` layout — plain, or ONE
  ``gat_na`` kernel launch for the whole stack (``na.use_pallas``), or that
  launch with the fused NA→SA epilogue (``sa.fuse_epilogue``);
* NA ``mean`` per relation on the ``padded``, ``bucketed`` and ``csr``
  layouts — with ``na.use_pallas`` the padded and bucketed arms launch the
  ``segment_spmm`` kernel (one launch per relation, per bucket);
* SA ``attention`` on the stack, or, after the fused epilogue, the O(P)
  softmax plus the ``semantic_combine`` kernel (with the reference's
  closed-form ``row_mask`` correction for padded rows); SA ``rel_sum``;
* the ``linear`` and ``select_linear`` heads.

:func:`check_ported` accepts exactly HAN's and RGCN's combinations of these
arms.  Arms of later slices raise ``NotImplementedError`` naming their
ROADMAP item, and combinations that no model of the reference declares
raise too; no arm is served by another one.  The reference's sharding
constraints are no-ops on one device and are dropped.
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core import semantics, stages
from repro_torch.core.plan import StagePlan
from repro_torch.kernels import ops

_ACT = {None: lambda x: x, "elu": F.elu, "relu": F.relu}

# NA kinds of later slices -> the ROADMAP Queue 1 item that ports them
_NA_KIND_ITEM = {"instance": 9, "gcn": 10}


def not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1 item "
        f"{item})")


def no_such_arm(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: no model of the reference declares this combination, so "
        "repro_torch has no arm for it")


def _fp_kinds(plan: StagePlan):
    return [(lp.fp.kind, lp.fp.heads) for lp in plan.layers]


def _check_han_arms(plan: StagePlan) -> None:
    if plan.na.layout != "stacked" or not plan.sa.stacked:
        raise not_ported(f"the {plan.na.layout!r} GAT layout", 6)
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


def check_ported(plan: StagePlan) -> None:
    """Raise for any plan outside the ported slices (HAN's and RGCN's
    combinations of arms), so that no arm is silently served by another
    one."""
    if plan.partition is not None:
        raise not_ported("graph-partitioned execution", 12)
    if plan.sample is not None:
        raise not_ported("request-path sampled serving", 13)
    if plan.residency is not None:
        raise not_ported("hot-feature residency", 11)
    if plan.schedule is not None:
        raise not_ported("the async stage-graph schedule", 14)
    kind = plan.na.kind
    if kind in _NA_KIND_ITEM:
        raise not_ported(f"NA kind {kind!r}", _NA_KIND_ITEM[kind])
    if kind == "gat":
        _check_han_arms(plan)
    elif kind == "mean":
        _check_rgcn_arms(plan)
    else:
        raise ValueError(f"unknown NA kind {kind!r}")


class StageGraphExecutor:
    """Executes a :class:`StagePlan` over a prepared device batch."""

    def __init__(self, plan: StagePlan, cfg):
        check_ported(plan)
        self.plan = plan
        self.cfg = cfg

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
        device = next(iter(batch["feats"].values())).device
        return _to_device(params, device)

    def _init_layer0(self, gen: torch.Generator, batch: Dict) -> Dict:
        cfg = self.cfg
        d = cfg.hidden
        params: Dict = {
            "fp": stages.init_feature_projection(gen, batch["feat_dims"], d)}
        params.update(self._init_na_sa(gen, batch))
        params["cls"] = torch.randn((d, cfg.n_classes),
                                    generator=gen) / math.sqrt(d)
        return params

    def _init_na_sa(self, gen: torch.Generator, batch: Dict) -> Dict:
        """The NA/SA block shared by layer 0 and every hidden layer: the
        stacked per-metapath GAT vectors and the semantic attention (HAN),
        or per-relation ``w_rel`` keyed by the relation tuples and per-type
        ``w_self`` (RGCN)."""
        cfg = self.cfg
        d = cfg.hidden

        def square():
            return torch.randn((d, d), generator=gen) / math.sqrt(d)

        if self.plan.na.kind == "mean":
            return {"w_rel": {key: square() for key in sorted(batch["rels"])},
                    "w_self": {t: square() for t in sorted(batch["counts"])}}
        gat = [stages.init_gat(gen, cfg.n_heads, d // cfg.n_heads)
               for _ in self.plan.metapaths]
        return {
            # one stacked param set -> ONE kernel launch for the stack
            "gat": {k: torch.stack([g[k] for g in gat]) for k in gat[0]},
            "sem": semantics.init_semantic_attention(gen, d, cfg.attn_hidden),
        }

    def _init_hidden_layer(self, gen: torch.Generator, batch: Dict) -> Dict:
        """Params for one layer >= 1: HAN's square [D, D] re-projection of
        the carried target table (RGCN's hidden FP is the identity: its
        ``w_rel``/``w_self`` are the layer's transform) plus a fresh NA/SA
        block."""
        d = self.cfg.hidden
        p: Dict = {}
        if self.plan.na.kind == "gat":
            p["fp"] = torch.randn((d, d), generator=gen) / math.sqrt(d)
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
        ``[N, H, Dh]``; otherwise every type's ``[N_t, D]`` table."""
        h = stages.feature_projection(params["fp"], batch["feats"])
        if self.plan.fp.heads:
            ht = h[self.plan.target]
            return ht.reshape(ht.shape[0], self.cfg.n_heads, -1)
        return h

    def _fp_hidden(self, lp, p_l: Dict, state: Dict):
        """Layers >= 1: ``identity`` passes the carried tables through
        (RGCN: the relation weights are the layer's transform); ``dense`` is
        a [D, D] re-projection of the carried target table, reshaped to
        heads when ``fp.heads``."""
        if lp.fp.kind == "identity":
            return state
        h = state[self.plan.target] @ p_l["fp"]
        if lp.fp.heads:
            return h.reshape(h.shape[0], self.cfg.n_heads, -1)
        return h

    def _handoff(self, lp, out) -> Dict:
        """Package one layer's SA output as the next layer's state: ``all``
        (rel_sum already returned every type's table) or ``target`` (the
        metapath graphs are target->target, so only this layer's output)."""
        if lp.handoff == "all":
            return out
        return {self.plan.target: out}

    # ------------------------------------------------------------------
    # Stage 3: Neighbor Aggregation
    # ------------------------------------------------------------------
    def na(self, params: Dict, batch: Dict, h):
        if self.plan.na.kind == "mean":
            return self._na_mean(params, batch, h)
        return self._na_gat(params, batch, h)  # check_ported: gat/stacked

    def _na_gat(self, params: Dict, batch: Dict, h: torch.Tensor):
        plan = self.plan
        if plan.sa.fuse_epilogue:
            return self._na_gat_fused_sa(params, batch, h)
        stacked_fn = None
        if plan.na.use_pallas:
            stacked_fn = functools.partial(ops.gat_aggregate_stacked,
                                           use_pallas=True)
        z = stages.gat_aggregate_padded_stacked(
            params["gat"], h, batch["nbr"], batch["mask"],
            stacked_fn=stacked_fn)
        z = _ACT[plan.na.activation](z)
        return z.reshape(z.shape[0], z.shape[1], -1)  # [P, N, D]

    def _na_gat_fused_sa(self, params: Dict, batch: Dict, h: torch.Tensor):
        """Stacked NA with the SA pass-1 epilogue fused in: returns
        ``(z [P, N, D] activation applied, wp [P] semantic-score means)``."""
        if self.plan.na.activation != "elu":
            # the kernel epilogue bakes the NA activation in (elu)
            raise ValueError("sa.fuse_epilogue requires na.activation='elu' "
                             f"(got {self.plan.na.activation!r})")
        z4, wp = ops.gat_aggregate_stacked_fused_sa(
            params["gat"], h, h, batch["nbr"], batch["mask"], params["sem"],
            use_pallas=self.plan.na.use_pallas)
        return z4.reshape(z4.shape[0], z4.shape[1], -1), wp

    def _na_mean(self, params: Dict, batch: Dict, h: Dict):
        """RGCN's NA: per relation (sorted keys), the mean of the source
        type's rows over the incoming neighbours, projected by ``w_rel``.
        With ``na.use_pallas`` the padded and bucketed layouts run the
        ``segment_spmm`` kernel; ``csr`` is the plain segment mean."""
        plan = self.plan
        # "__h__" rides along for the self-loop term in SA (rel_sum)
        out: Dict = {"__h__": h}
        agg_fn = None
        if plan.na.use_pallas and plan.na.layout != "csr":
            agg_fn = functools.partial(ops.segment_spmm, mean=True,
                                       use_pallas=True)
        for key in sorted(batch["rels"]):
            s, _, d = key
            rel = batch["rels"][key]
            if plan.na.layout == "csr":
                agg = stages.mean_aggregate_csr(h[s], rel[0], rel[1],
                                                h[d].shape[0])
            elif plan.na.layout == "bucketed":
                agg = stages.mean_aggregate_bucketed(h[s], rel, h[d].shape[0],
                                                     agg_fn=agg_fn)
            else:  # padded
                agg = (agg_fn or stages.mean_aggregate_padded)(h[s], rel[0],
                                                               rel[1])
            out["|".join(key)] = agg @ params["w_rel"][key]
        return out

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
            return ops.semantic_combine(z_stack, beta,
                                      use_pallas=plan.na.use_pallas)
        return semantics.semantic_attention(params["sem"], z, row_mask)

    # ------------------------------------------------------------------
    # head + forward
    # ------------------------------------------------------------------
    def head(self, params: Dict, z, batch: Dict = None) -> torch.Tensor:
        head = self.plan.head
        if head.kind == "select_linear":
            return z[head.target] @ params[head.param]
        return z @ params[head.param]

    def forward(self, params: Dict, batch: Dict) -> torch.Tensor:
        """The L-layer loop: layer 0 reads the prepared batch, hidden
        layers the previous handoff."""
        state = out = None
        for l, lp in enumerate(self.plan.layers):
            p_l = self._layer_params(params, l)
            h = (self.fp(params, batch) if l == 0
                 else self._fp_hidden(lp, p_l, state))
            z = self.na(p_l, batch, h)
            out = self.sa(p_l, batch, z)
            state = self._handoff(lp, out)
        return self.head(params, out, batch)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


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
