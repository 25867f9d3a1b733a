"""Deterministic, seeded fault injection for the HGNN request path (port
of ``repro/serve/faults.py``, numpy only, unchanged in behaviour).

The serving resilience layer (``repro_torch.serve.resilience`` policies
threaded through ``HGNNServeEngine.serve``) is only trustworthy if its
recovery behavior can be *measured*, and chaos that can't be replayed
can't be gated.  :class:`FaultInjector` therefore holds an explicit
schedule of :class:`Fault` events — sampler exceptions, forward
exceptions, injected step latency, partition loss — and the engine
consults it at fixed hook points:

* ``check("sampler", step, attempt)`` — before the sampler call of every
  retry attempt; raises :class:`InjectedFault` while ``attempt`` is below
  the fault's ``attempts`` count (so ``attempts=1`` is a transient blip the
  first retry absorbs, ``attempts > max_retries`` is a persistent error
  that fails the step's requests).
* ``check("forward", step, attempt)`` — same, before the forward.
* ``latency_s(step)`` — extra seconds added to the step's *observed* wall
  (the SLO/degradation signal) without sleeping, so latency-pressure tests
  and benchmarks stay fast and deterministic.
* ``partition_loss(step)`` — the partition id lost at this step, or None;
  on a partitioned plan the engine's failover re-assigns the lost
  partition's vertices over the survivors
  (``repro_torch.dist.partition.surviving_partition_spec``); an
  unpartitioned plan never consults it.

``FaultInjector.seeded`` derives a schedule from an integer seed with
``np.random.default_rng`` — same seed, same queue, same schedule, same
counters — which is what lets CI's chaos smoke and
``benchmarks/bench_resilience.py`` assert exact retry/failure/degrade
counts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


class InjectedFault(RuntimeError):
    """Raised by :meth:`FaultInjector.check` at a scheduled fault point."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    ``kind``: ``"sampler"`` / ``"forward"`` (exceptions), ``"latency"``
    (extra observed wall), or ``"partition"`` (partition loss).  For
    exception kinds, ``attempts`` is how many consecutive retry attempts
    at ``step`` raise.
    """
    step: int
    kind: str
    attempts: int = 1
    latency_s: float = 0.0
    partition: int = 0

    def __post_init__(self):
        if self.kind not in ("sampler", "forward", "latency", "partition"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultInjector:
    """A replayable fault schedule plus the counters of what actually fired.

    Deterministic by construction: the schedule is fixed before serving
    starts and the engine's hook points consume it by (kind, step), so two
    runs over the same queue observe byte-identical fault sequences.
    """

    def __init__(self, faults: Sequence[Fault] = ()):
        self._by_kind: Dict[str, Dict[int, Fault]] = {}
        for f in faults:
            self._by_kind.setdefault(f.kind, {})[f.step] = f
        self.faults = tuple(faults)
        self.counters: Dict[str, int] = {
            "injected_sampler": 0, "injected_forward": 0,
            "injected_latency_steps": 0, "injected_partition_losses": 0,
        }

    # ------------------------------------------------------------------
    # engine hook points
    # ------------------------------------------------------------------
    def check(self, kind: str, step: int, attempt: int) -> None:
        """Raise :class:`InjectedFault` if a ``kind`` fault is scheduled at
        ``step`` and this ``attempt`` is still within its failing window."""
        f = self._by_kind.get(kind, {}).get(step)
        if f is not None and attempt < f.attempts:
            self.counters[f"injected_{kind}"] += 1
            raise InjectedFault(
                f"injected {kind} fault at step {step} (attempt {attempt})")

    def latency_s(self, step: int) -> float:
        """Extra observed wall seconds for this step (0.0 = none)."""
        f = self._by_kind.get("latency", {}).get(step)
        if f is None:
            return 0.0
        self.counters["injected_latency_steps"] += 1
        return float(f.latency_s)

    def partition_loss(self, step: int) -> Optional[int]:
        """Partition id lost at this step, or None."""
        f = self._by_kind.get("partition", {}).get(step)
        if f is None:
            return None
        self.counters["injected_partition_losses"] += 1
        return int(f.partition)

    # ------------------------------------------------------------------
    # seeded schedules
    # ------------------------------------------------------------------
    @classmethod
    def seeded(cls, seed: int, n_steps: int = 16, sampler: int = 0,
               forward: int = 0, persistent_sampler: int = 0,
               latency_steps: int = 0, latency_s: float = 0.05,
               partition_loss_step: Optional[int] = None, partition: int = 0,
               persistent_attempts: int = 64) -> "FaultInjector":
        """Derive a deterministic schedule from ``seed``.

        Transient faults (``sampler`` / ``forward`` counts, ``attempts=1``)
        and ``latency_steps`` latency events land on distinct rng-chosen
        steps in ``[1, n_steps)``; ``persistent_sampler`` faults get
        ``persistent_attempts`` so every retry budget is exhausted.  Steps
        past the actual serve length simply never fire — the schedule stays
        replay-identical either way.
        """
        rng = np.random.default_rng(seed)
        faults: List[Fault] = []

        def draw(n: int, used: set) -> List[int]:
            pool = [s for s in range(1, max(n_steps, 2)) if s not in used]
            take = list(rng.choice(pool, size=min(n, len(pool)),
                                   replace=False)) if pool and n else []
            used.update(int(s) for s in take)
            return [int(s) for s in take]

        used: set = set()
        for s in draw(sampler, used):
            faults.append(Fault(step=s, kind="sampler", attempts=1))
        for s in draw(persistent_sampler, used):
            faults.append(Fault(step=s, kind="sampler",
                                attempts=persistent_attempts))
        for s in draw(forward, used):
            faults.append(Fault(step=s, kind="forward", attempts=1))
        lat_used: set = set()
        for s in draw(latency_steps, lat_used):
            faults.append(Fault(step=s, kind="latency", latency_s=latency_s))
        if partition_loss_step is not None:
            faults.append(Fault(step=int(partition_loss_step),
                                kind="partition", partition=int(partition)))
        return cls(faults)
