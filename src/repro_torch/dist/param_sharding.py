"""Parameter partitioning (port of ``repro/dist/param_sharding.py``): a
parameter tree -> the matching tree of :class:`~repro_torch.dist.sharding.
NamedSharding`, by each leaf's key path, with the reference's rules:

* column-sharded projections (``wq``/``wk``/``wv``, ``w_gate``/``w_up``,
  Mamba2 ``w_z``/``w_x``/``w_dt``, ``lm_head``): the output (last) dim
  over ``'model'``;
* row-sharded contractions (``wo``, ``w_down``, ``out_proj``): the input
  (second-to-last) dim over ``'model'``, so each block ends in one
  all-reduce;
* expert weights (``w_gate``/``w_up``/``w_down`` under a ``'moe'`` dict):
  the expert dim over ``'model'``;
* ``embed``: vocab over ``'model'`` and, under FSDP, ``d_model`` over
  ``'data'``;
* everything else (norms, biases, attention and SSM vectors, routers,
  conv taps, the HGNN attention vectors) replicated.

FSDP shards one more dim of each large matrix over ``'data'`` (``fsdp=``
for dense weights, ``fsdp_experts=`` for expert weights).  The rules work
on trailing dims, so one covers a bare block, a stacked run ``[L, ...]``
and stacked experts ``[L, E, ...]``; every spec goes through
``resolve_spec``, so a dim that does not divide stays replicated.  Leaves
may be tensors of any device, meta included.
"""
from __future__ import annotations

from typing import Any, Tuple

from repro_torch import tree
from repro_torch.dist.sharding import DATA, MODEL, named

# Column-sharded: output (last) dim over 'model'.
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w_z", "w_x", "w_dt", "lm_head"}
# Row-sharded: input (second-to-last) dim over 'model'.
_ROW = {"wo", "w_down", "out_proj"}
# Expert-parallel leaves when the enclosing block is a 'moe' dict.
_EXPERT = {"w_gate", "w_up", "w_down"}


def _dict_keys(path: Tuple[Any, ...]) -> Tuple[Any, ...]:
    return tuple(k.key for k in path if isinstance(k, tree.DictKey))


def _leaf_spec(path, leaf, fsdp: bool, fsdp_experts: bool) -> Tuple:
    """The logical per-dim spec of one leaf, before mesh resolution."""
    names = _dict_keys(path)
    name = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    nd = leaf.dim()
    spec = [None] * nd
    if name == "embed" and nd == 2:
        spec[0] = MODEL
        if fsdp:
            spec[1] = DATA
    elif parent == "moe" and name in _EXPERT and nd >= 3:
        spec[-3] = MODEL  # expert dim
        if fsdp_experts:
            spec[-2] = DATA
    elif name in _COL and nd >= 2:
        spec[-1] = MODEL
        if fsdp:
            spec[-2] = DATA
    elif name in _ROW and nd >= 2:
        spec[-2] = MODEL
        if fsdp:
            spec[-1] = DATA
    return tuple(spec)


def param_specs(params: Any, mesh, fsdp: bool = True,
                fsdp_experts: bool = True) -> Any:
    """The tree of ``NamedSharding`` matching ``params``."""
    return tree.map_with_path(
        lambda path, leaf: named(mesh, leaf.shape,
                                 _leaf_spec(path, leaf, fsdp, fsdp_experts)),
        params)
