"""Elastic scaling, failure handling and straggler policy (port of
``repro/train/elastic.py``).

On a multi-slice deployment the controller observes slice health and
restarts the job with the surviving topology; this is the framework side
that makes that restart cheap and deterministic:

  * ``surviving_mesh`` — rebuild a ``(pod, data, model)`` mesh from the
    surviving pods (drop the failed ``'pod'`` slices; a single-pod
    ``(data, model)`` mesh when one remains).
  * ``reshard_state`` — lay a state out onto ANY mesh (composes with
    ``checkpoint.restore(shardings=)``: a state checkpointed on one mesh
    restarts on another).
  * ``data_shard`` — deterministic (step, host) -> sample-range mapping:
    no central dispatcher, so no straggler head-of-line blocking on input;
    a restarted host recomputes exactly the batch slice it owes.
  * ``StepTimer`` — flags a step slower than ``threshold`` x the running
    median (the signal the launcher prints as ``[straggler]``).

A mesh here is ``dist/sharding.Mesh``.  Building the survivors'
``DeviceMesh`` creates its process groups, each a collective over the
default group: every rank of that group enters ``surviving_mesh``, the
ranks of the failed pods too, and a rank outside the surviving pods gets
a mesh in which it has no coordinate and must run no step on it.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import Mesh, distribute_tree


def surviving_mesh(mesh: Mesh, failed_pods: Sequence[int]) -> Mesh:
    """Drop failed 'pod' slices from a (pod, data, model) mesh.

    An abstract mesh gives an abstract survivor; a mesh with a
    ``DeviceMesh`` gives one over the surviving pods' ranks, with the same
    axis names (module docstring: every rank enters)."""
    if "pod" not in mesh.axis_names:
        raise ValueError("surviving_mesh expects a multi-pod mesh")
    pod_axis = mesh.axis_names.index("pod")
    failed = set(failed_pods)
    keep = [i for i in range(mesh.shape["pod"]) if i not in failed]
    if not keep:
        raise RuntimeError("no surviving pods")
    names = list(mesh.axis_names)
    sizes = [mesh.shape[n] for n in names]
    sizes[pod_axis] = len(keep)
    if len(keep) == 1:  # collapse to single-pod topology
        del names[pod_axis], sizes[pod_axis]
    if mesh.device_mesh is None:
        return Mesh(names, sizes)
    from torch.distributed.device_mesh import DeviceMesh

    ranks = mesh.device_mesh.mesh.index_select(pod_axis, torch.tensor(keep))
    dm = DeviceMesh(mesh.device_mesh.device_type, ranks.reshape(sizes),
                    mesh_dim_names=tuple(names))
    return Mesh.from_device_mesh(dm)


def reshard_state(state: Any, shardings: Any) -> Any:
    """Every leaf laid out with the target sharding (a tree of
    ``NamedSharding`` matching ``state``; a ``None`` sharding passes its
    leaf through): ``dist.sharding.distribute_tree``, which moves a DTensor
    onto another mesh too."""
    return distribute_tree(state, shardings)


def data_shard(step: int, host_id: int, n_hosts: int, global_batch: int,
               dataset_size: int) -> Tuple[int, int]:
    """Deterministic [start, end) sample range for (step, host).

    Pure function of its arguments: any host (or its replacement) can
    recompute its slice after a restart without coordination.
    """
    per_host = global_batch // n_hosts
    start = (step * global_batch + host_id * per_host) % dataset_size
    return start, start + per_host


class StepTimer:
    """Bounded-staleness straggler detector: flags steps slower than
    ``threshold`` x the running median of the last ``window`` steps."""

    def __init__(self, threshold: float = 3.0, window: int = 50):
        self.threshold = threshold
        self.times: List[float] = []
        self.window = window

    def observe(self, seconds: float) -> bool:
        self.times.append(seconds)
        self.times = self.times[-self.window:]
        if len(self.times) < 5:
            return False
        med = float(np.median(self.times))
        return seconds > self.threshold * med
