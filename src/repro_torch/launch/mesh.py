"""Production and smoke meshes (port of ``repro/launch/mesh.py``).

Functions, so importing this module touches no process group.

* :func:`make_production_mesh`: 16 x 16 = 256 ranks ``(data, model)``, or
  2 x 16 x 16 = 512 ``(pod, data, model)`` (``'pod'`` is pure data
  parallelism across slices).  Over a default process group of the
  ``"fake"`` backend with as many ranks (the dry run,
  :mod:`repro_torch.launch.dryrun`) it carries a ``DeviceMesh`` (of
  meta tensors); otherwise it is abstract: it resolves specs and places
  nothing.
* :func:`make_smoke_mesh`: ``data x model`` over the first ranks of the
  default process group (NCCL on the card, gloo on the CPU); with too
  few ranks it raises, as the reference does with too few devices.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.dist.sharding import Mesh


def _device_type() -> str:
    # the fake group's mesh is a CPU mesh; its tensors are meta tensors
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _device_mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 (data, model).  Multi-pod: 2x16x16 (pod, data,
    model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if (dist.is_initialized() and dist.get_backend() == "fake"
            and dist.get_world_size() == n):
        return Mesh(axes, shape, _device_mesh(shape, axes))
    return Mesh(axes, shape)


def make_smoke_mesh(data: int = 2, model: int = 2) -> Mesh:
    """A small ``(data, model)`` mesh over the default process group's
    ranks (tests, the CLI's ``--mesh-data`` / ``--mesh-model``)."""
    n = data * model
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")
    if have != n:
        raise RuntimeError(f"a smoke mesh of {n} ranks needs a process "
                           f"group of {n}, have {have}")
    return Mesh(("data", "model"), (data, model),
                _device_mesh((data, model), ("data", "model")))
