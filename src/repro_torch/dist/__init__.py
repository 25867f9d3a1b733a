"""Distributed runtime (port of ``repro/dist/``): the mesh axis names, the
``shard`` constraint, ``use_mesh`` and the resolve-or-replicate spec
resolver (:mod:`repro_torch.dist.sharding`), parameter partitioning
(:mod:`repro_torch.dist.param_sharding`), and graph-partitioned execution
(:mod:`repro_torch.dist.partition`)."""
from repro_torch.dist.sharding import (  # noqa: F401
    BATCH,
    DATA,
    MODEL,
    POD,
    current_mesh,
    resolve_spec,
    shard,
    use_mesh,
)
from repro_torch.dist.param_sharding import param_specs  # noqa: F401
