"""Axis-name conventions and the resolve-or-replicate sharding contract
(port of ``repro/dist/sharding.py``), on ``torch.distributed``'s
``DeviceMesh`` and DTensor.

Axis names
----------
Every mesh is built from (a subset of) three named axes: ``"pod"`` (pure
data parallelism across slices), ``"data"`` (data parallelism within a
pod, also the FSDP axis) and ``"model"`` (tensor and expert parallelism).
Layer code names two logical axes only: ``BATCH = ("pod", "data")`` for
batch-like dims (tokens, the destination nodes of the HGNN Neighbor
Aggregation stage) and ``MODEL = "model"`` for hidden, head, expert and
vocab dims.

The resolve-or-replicate contract
---------------------------------
``resolve_spec(shape, spec, mesh)`` turns a logical per-dim spec into a
concrete :class:`PartitionSpec` for this mesh, as the reference does:

1. axes absent from ``mesh.axis_names`` are dropped (a smoke mesh has no
   ``"pod"``, so ``BATCH`` resolves to ``"data"``);
2. a dim whose size the surviving axes' product does not divide is
   replicated (``None``);
3. single-axis tuples collapse to the bare name, and the result has
   ``min(len(spec), len(shape))`` entries (entries past the shape, or
   missing ones, mean replicated).

A mesh is anything with ``axis_names`` and ``shape`` (name -> size), as
the reference duck-types it, so a spec table resolves against a plain
description of a production mesh.  A :class:`Mesh` made over the ranks of
a process group also carries its ``DeviceMesh`` (``device_mesh``), and
:func:`placements` turns a resolved spec into DTensor placements on it:
``Shard(d)`` on every mesh dimension named by tensor dim ``d``'s entry,
``Replicate()`` on the others.

``shard(x, *spec)`` is the reference's ``with_sharding_constraint``: on a
DTensor under :func:`use_mesh` it redistributes ``x`` to the resolved
placements (a no-op where they already hold), and under autograd the
gradient goes back laid out as ``x`` was, as JAX transposes the
constraint; on a plain tensor, or with no mesh installed, it returns
``x``, so the one-device paths run the same layer code unchanged.
:func:`gather_seq`, :func:`split_heads` and :func:`merge_heads` are the
constraints around a matmul that DTensor needs spelled out: the sequence
whole before a column-parallel product, the heads' layout kept across a
``[..., H * Dh]`` <-> ``[..., H, Dh]`` view.

A hand-written kernel never receives a DTensor.  :func:`local` runs a
function on the local shards of the DTensor leaves of its arguments (the
counterpart of ``shard_map``; what ``torch.distributed.tensor.
experimental.local_map`` does, for trees of arguments and outputs), with
the input placements checked against the specs the reference's
constraints name where the caller gives them: an argument laid out
otherwise raises instead of being moved silently.  An input's gradient
is a partial sum where the input is replicated over an axis another
input is split on.  Off a mesh it calls the function as it is.
"""
from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

# Logical axis names (see module docstring).
POD = "pod"
DATA = "data"
MODEL = "model"
BATCH = (POD, DATA)


class PartitionSpec(tuple):
    """A resolved per-dim spec: each entry ``None``, an axis name, or a
    tuple of axis names (the port's own ``jax.sharding.PartitionSpec``;
    ``tuple(spec)`` compares equal to ``tuple()`` of the reference's)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """Named mesh axes with their sizes, and the ``DeviceMesh`` over the
    process group's ranks when there is one (``None``: an abstract mesh,
    which resolves specs but places nothing)."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int],
                 device_mesh=None):
        if len(axis_names) != len(sizes):
            raise ValueError(f"Mesh: {len(axis_names)} axis names for "
                             f"{len(sizes)} sizes")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in sizes)))
        self.device_mesh = device_mesh

    @classmethod
    def from_device_mesh(cls, device_mesh) -> "Mesh":
        return cls(device_mesh.mesh_dim_names, device_mesh.shape,
                   device_mesh)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        kind = "abstract" if self.device_mesh is None else \
            self.device_mesh.device_type
        return f"Mesh({self.shape}, {kind})"


@dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a mesh (the reference's ``NamedSharding``); a
    leaf of the port's trees, not a container."""
    mesh: Any
    spec: PartitionSpec

    def placements(self) -> List:
        return placements(self.spec, self.mesh)


# A stack, not a slot: a step builder nests (the dry run builds a step
# while a launcher's mesh is installed).  Tracing is single-threaded.
_MESH_STACK: List[Any] = []


def current_mesh():
    """The innermost mesh installed by :func:`use_mesh` (None outside)."""
    return _MESH_STACK[-1] if _MESH_STACK else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as the target of :func:`shard` and :func:`local`;
    on a mesh with a ``DeviceMesh``, a plain tensor that meets a DTensor
    in an op counts as replicated (``implicit_replication``)."""
    _MESH_STACK.append(mesh)
    try:
        if getattr(mesh, "device_mesh", None) is None:
            yield mesh
        else:
            # a plain tensor made inside (positions, RoPE tables, masks) is
            # the same on every rank: replicated, as a constant the
            # reference's jit captures
            from torch.distributed.tensor.experimental import (
                implicit_replication)

            with implicit_replication():
                yield mesh
    finally:
        _MESH_STACK.pop()


def _flatten_axes(entry: Any) -> Tuple[str, ...]:
    """Flatten a spec entry (name | nested tuples/lists of names) to names."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    out: List[str] = []
    for e in entry:
        out.extend(_flatten_axes(e))
    return tuple(out)


def resolve_spec(shape: Sequence[int], spec: Sequence[Any],
                 mesh) -> PartitionSpec:
    """Resolve a logical per-dim spec against ``mesh`` (module
    docstring).  Returns ``min(len(spec), len(shape))`` entries."""
    axis_sizes = dict(mesh.shape)
    out: List[Any] = []
    for dim, entry in zip(shape, spec):
        names = [n for n in _flatten_axes(entry) if n in axis_sizes]
        if not names:
            out.append(None)
            continue
        total = 1
        for n in names:
            total *= axis_sizes[n]
        if int(dim) % total != 0:  # divisibility guard -> replicate
            out.append(None)
        elif len(names) == 1:
            out.append(names[0])
        else:
            out.append(tuple(names))
    return PartitionSpec(*out)


def named(mesh, shape: Sequence[int], spec: Sequence[Any]) -> NamedSharding:
    """``NamedSharding(mesh, resolve_spec(shape, spec, mesh))``."""
    return NamedSharding(mesh, resolve_spec(shape, spec, mesh))


def placements(spec: Sequence[Any], mesh) -> List:
    """DTensor placements of a resolved spec, one a mesh dimension:
    ``Shard(d)`` where tensor dim ``d``'s entry names the axis, else
    ``Replicate()``.  An axis named by two dims raises."""
    from torch.distributed.tensor import Replicate, Shard

    out: List = []
    for name in mesh.axis_names:
        dims = [d for d, e in enumerate(spec) if name in _flatten_axes(e)]
        if len(dims) > 1:
            raise ValueError(f"placements: axis {name!r} shards dims {dims} "
                             f"of {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _device_mesh(mesh):
    if mesh is None or mesh.device_mesh is None:
        raise ValueError(f"no DeviceMesh to place tensors on: {mesh!r}")
    return mesh.device_mesh


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def whole(x: torch.Tensor) -> torch.Tensor:
    """``x`` as one full tensor on this rank: a plain tensor as it is, a
    DTensor replicated on every mesh dimension from the rank's own copy
    (no collective), any other DTensor gathered over its mesh (a
    collective every rank of the mesh enters; a ``Partial`` one summed)."""
    if not is_dtensor(x):
        return x
    if all(p.is_replicate() for p in x.placements):
        return _waited(x.to_local())
    return x.full_tensor()


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (the same full tensor on every rank) laid out as
    ``sharding`` says: a DTensor holding this rank's shard, cut from its
    own copy (``src_data_rank=None``: no broadcast or scatter)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, _device_mesh(sharding.mesh),
                             sharding.placements(), src_data_rank=None)


def distribute_tree(values, shardings):
    """Every tensor of ``values`` laid out as the matching
    ``NamedSharding`` of ``shardings`` (a tree of ``values``' structure)
    says: a plain tensor (the same full tensor on every rank) is
    distributed, a DTensor on the same mesh redistributed; other leaves
    (host integers, ``None``) stay as they are.

    A DTensor on another mesh (``jax.device_put`` onto another mesh) is
    made whole on this rank first: a leaf replicated on its old mesh from
    the rank's own copy, with no collective, so the ranks of a surviving
    mesh go on without the lost ones; a sharded leaf by gathering it over
    its old mesh, which needs every rank of that mesh alive.  The whole
    tensor is then distributed onto the new mesh as :func:`distribute`
    does.  Sharded state crosses a failure only through a checkpoint, as
    in the reference (``train/checkpoint.restore(shardings=)``)."""
    from repro_torch import tree

    if isinstance(shardings, NamedSharding):
        if not isinstance(values, torch.Tensor):
            return values
        if is_dtensor(values):
            dm = _device_mesh(shardings.mesh)
            if values.device_mesh != dm:
                return distribute(whole(values), shardings)
            want = tuple(shardings.placements())
            if tuple(values.placements) == want:
                return values
            return values.redistribute(dm, want)
        return distribute(values, shardings)
    if shardings is None:
        return values
    if isinstance(shardings, dict):
        return {k: distribute_tree(values[k], shardings[k])
                for k in shardings}
    kids = [distribute_tree(v, s) for v, s in zip(values, shardings)]
    if tree._is_namedtuple(values):
        return type(values)(*kids)
    return type(values)(kids)


# shard()'s placements by (mesh axes, shape, spec): a layer asks the same
# questions every step
_PLACEMENTS: Dict[Any, Tuple] = {}


def shard(x, *spec: Any):
    """Constrain ``x`` to the resolved spec on the active mesh: a DTensor
    is redistributed to it; a plain tensor, or any tensor off a mesh, is
    returned as it is.  ``spec`` is one logical entry per dim of ``x``."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    key = (tuple(mesh.shape.items()), tuple(x.shape), spec)
    want = _PLACEMENTS.get(key)
    if want is None:
        want = _PLACEMENTS[key] = tuple(
            placements(resolve_spec(x.shape, spec, mesh), mesh))
    if torch.is_grad_enabled() and x.requires_grad:
        return _Redistribute.apply(x, _device_mesh(mesh), want)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(_device_mesh(mesh), want)


class _Redistribute(torch.autograd.Function):
    """``x.redistribute(mesh, want)`` whose gradient goes back laid out as
    ``x`` was (a pending sum, ``Partial``, as replicated): the constraint
    holds for the cotangent too, as JAX transposes
    ``with_sharding_constraint``.  DTensor's own backward can leave a
    gradient sharded over the sequence where the next matmul's backward
    must fold the batch and the sequence into one dim."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        from torch.distributed.tensor import Replicate

        ctx.mesh = mesh
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.back:
            grad = grad.redistribute(ctx.mesh, ctx.back)
        return grad, None, None



def gather_seq(x):
    """``x [B, S, d]`` with the sequence whole on every rank: the
    all-gather Megatron's sequence parallelism makes before a
    column-parallel matmul (the reference leaves it to XLA; a DTensor
    matmul folds ``B`` and ``S`` into one dim, which a sharded ``S``
    cannot take).  A no-op off a mesh."""
    return shard(x, BATCH, None, None)


def split_heads(y, heads: int, dh: int, lead: Tuple = (BATCH, None)):
    """``y [..., heads * dh]`` as ``[..., heads, dh]`` under the
    constraint ``(*lead, MODEL, None)`` (the reference's ``shard(...,
    BATCH, None, MODEL, None)`` of an LM's ``[B, S, H, Dh]``; an HGNN's
    ``[N, H, Dh]`` takes ``lead=(BATCH,)``).  On a mesh the flat dim is
    first laid out as the heads will be (over ``'model'`` only where
    ``heads`` divides it), so the view splits no shard."""
    shape = tuple(y.shape[:-1]) + (heads, dh)
    mesh = current_mesh()
    if mesh is not None and is_dtensor(y):
        spec = resolve_spec(shape, tuple(lead) + (MODEL, None), mesh)
        y = shard(y, *spec[:-1])
    return shard(y.reshape(shape), *lead, MODEL, None)


def merge_heads(o, lead: Tuple = (BATCH, None)):
    """``o [..., H, Dh]`` as ``[..., H * Dh]``, the flat dim laid out as the
    heads were (over ``'model'`` where ``H`` divides it, else whole); the
    constraint holds for the gradient too, so the view's backward never
    splits a head across ranks."""
    y = o.reshape(tuple(o.shape[:-2]) + (-1,))
    mesh = current_mesh()
    if mesh is not None and is_dtensor(o):
        spec = resolve_spec(tuple(o.shape), tuple(lead) + (MODEL, None),
                            mesh)
        y = shard(y, *spec[:-1])
    return y


def local(fn, args: Sequence[Any], in_specs: Optional[Sequence[Any]],
          out_placements: Any):
    """``fn(*args)`` on the local shards of the DTensor leaves of ``args``
    (module docstring).

    ``args`` may be trees of dicts, lists and tuples.  ``in_specs`` is
    ``None`` (every DTensor taken as it is laid out: the caller lays it
    out first, :func:`shard`, :func:`replicate`) or gives, for each
    argument, a logical spec (a tuple, resolved against that argument's
    shape), a placement list, or ``None`` (a non-tensor, or a tree taken
    as laid out); a DTensor laid out otherwise raises.  Every tensor leaf
    of the output is laid out as ``out_placements``, a placement list; a
    tuple gives one an output leaf (``None`` for a non-tensor).  The
    gradient of an input's local shard is laid out as the input, except
    on a mesh dimension where the input is replicated and another input
    is sharded: each rank's computation there used only its part, so its
    gradient is a partial sum (``Partial()``).  Off a mesh, or with no
    DTensor among the leaves, ``fn(*args)`` runs as it is."""
    mesh = current_mesh()
    if mesh is None:
        return fn(*args)
    from torch.utils import _pytree as pytree

    leaves, arg_tree = pytree.tree_flatten(list(args))
    if not any(is_dtensor(a) for a in leaves):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Placement

    for a, s in zip(args, in_specs or ()):
        if s is None or not is_dtensor(a):
            continue
        want = (list(s) if s and all(isinstance(p, Placement) for p in s)
                else placements(resolve_spec(a.shape, s, mesh), mesh))
        if tuple(a.placements) != tuple(want):
            raise ValueError(f"local: an argument laid out as "
                             f"{a.placements}, not {tuple(want)}")
    in_pl = [list(a.placements) if is_dtensor(a) else None for a in leaves]
    local_leaves = [_waited(a.to_local(grad_placements=g))
                    if is_dtensor(a) else a
                    for a, g in zip(leaves, _grad_placements(in_pl))]
    out = fn(*pytree.tree_unflatten(
        [_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor)
         and a.requires_grad else a for a in local_leaves], arg_tree))
    flat, out_tree = pytree.tree_flatten(out)
    per = (out_placements if isinstance(out_placements, tuple)
           else (out_placements,) * len(flat))
    dm = _device_mesh(mesh)
    return pytree.tree_unflatten(
        [DTensor.from_local(t, dm, p, run_check=False)
         if isinstance(t, torch.Tensor) else t for t, p in zip(flat, per)],
        out_tree)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    gradient that leaves a ``local`` body laid out as the body's own ops
    left it (a transpose, say) would meet DTensor's views outside, which
    take only strides a view can keep."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _grad_placements(in_pl):
    """``local``'s gradient placements (its docstring)."""
    from torch.distributed.tensor import Partial

    split = [any(pl is not None and pl[i].is_shard() for pl in in_pl)
             for i in range(max(len(pl) for pl in in_pl if pl is not None))]
    return tuple(None if pl is None else
                 [Partial() if p.is_replicate() and split[i] else p
                  for i, p in enumerate(pl)] for pl in in_pl)


def _waited(t):
    """A local shard that a pending collective still writes (DTensor's
    ``AsyncCollectiveTensor``), waited for; any other tensor as it is.
    On the card the wait orders the current stream after the collective's
    (c10d's ``wait_tensor``), and the host goes on, so a CUDA-graph capture
    records it (``graphs.compiled``).  Under ``TORCH_NCCL_BLOCKING_WAIT``
    the host would block on the device, which a capture cannot: that
    raises."""
    from torch.distributed._functional_collectives import (
        AsyncCollectiveTensor)

    if not isinstance(t, AsyncCollectiveTensor):
        return t
    if (t.is_cuda and torch.cuda.is_current_stream_capturing()
            and os.environ.get("TORCH_NCCL_BLOCKING_WAIT", "0") not in
            ("0", "")):
        raise RuntimeError(
            "a collective's wait under TORCH_NCCL_BLOCKING_WAIT blocks the "
            "host, which a CUDA-graph capture cannot")
    return t.wait()


def replicate(x):
    """``x`` whole on every rank (:func:`shard` to no split at all)."""
    if not is_dtensor(x):
        return x
    return shard(x, *([None] * x.dim()))


def lead_placements(x) -> List:
    """The placements of a result whose rows follow ``x``'s and whose
    other dims are whole: ``Shard(0)`` where ``x``'s rows are split,
    else ``Replicate()`` (None off a mesh)."""
    if not is_dtensor(x):
        return None
    from torch.distributed.tensor import Replicate

    return [p if p.is_shard(0) else Replicate() for p in x.placements]


def batch_group(mesh):
    """The size of the mesh's ``BATCH`` axes and the group that spans them
    for a collective of ``_functional_collectives``: ``(device_mesh,
    dim)`` for one axis, the flattened sub-mesh for two (``('pod',
    'data')``, pod-major, the order JAX's tiled all-gather concatenates
    in).  ``(1, None)`` when the mesh has no batch axis."""
    names = tuple(a for a in BATCH if a in mesh.shape)
    if not names:
        return 1, None
    size = math.prod(mesh.shape[a] for a in names)
    dm = _device_mesh(mesh)
    if len(names) == 1:
        return size, (dm, mesh.axis_names.index(names[0]))
    return size, dm[names]._flatten()


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """A local shard's rows gathered over ``group`` (:func:`batch_group`),
    in rank order: one all-gather (the counterpart of ``jax.lax.
    all_gather(..., tiled=True)`` inside ``shard_map``)."""
    from torch.distributed import _functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor
    return _waited(gather(x.contiguous(), 0, group))


def mesh_coordinate(mesh, axis: str) -> int:
    """This rank's coordinate along mesh axis ``axis``."""
    return _device_mesh(mesh).get_local_rank(axis)


def replicated(x):
    """A plain tensor (the same on every rank) as a DTensor replicated on
    the active mesh; a DTensor, or any tensor off a mesh, as it is."""
    mesh = current_mesh()
    if mesh is None or mesh.device_mesh is None or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh.device_mesh,
                              [Replicate()] * len(mesh.axis_names),
                              run_check=False)


def copy_into(dst, src) -> None:
    """``dst.copy_(src)``; a DTensor ``dst`` (a view of a larger one, as a
    layer's slot of a stacked cache) takes ``src`` laid out as it is, shard
    by shard, so each rank writes its own rows in place."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    if not is_dtensor(src):
        src = replicated(src)
    if tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst._local_tensor.copy_(src._local_tensor)
