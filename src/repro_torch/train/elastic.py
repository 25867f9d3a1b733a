"""Elastic scaling helpers (port of ``repro/train/elastic.py``, the part
that needs no device mesh).

  * ``data_shard`` — deterministic (step, host) -> sample-range mapping:
    no central dispatcher, so no straggler head-of-line blocking on input;
    a restarted host recomputes exactly the batch slice it owes.
  * ``StepTimer`` — flags a step slower than ``threshold`` x the running
    median (the signal the launcher prints as ``[straggler]``).

The reference's ``surviving_mesh`` (rebuild the mesh from the surviving
pods) and ``reshard_state`` (place a restored checkpoint onto any mesh)
need multi-rank training on real ranks; they wait for the next slice of
ROADMAP Queue 1 item 19 (the mesh layer itself, ``dist/sharding.py`` and
``train_step.state_shardings``, is ported).  On one device
``checkpoint.restore(..., device=)`` is the whole restore.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


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
