"""Serving resilience policies for the HGNN request path (port of
``repro/serve/resilience.py``, numpy only, unchanged in behaviour).

The paper's core observation — HGNN stage behavior is *predictable and
measurable* — is what makes principled degradation possible on the serve
path: the per-step walls and SAMPLE counters the engine already records are
the load signals, and the sampler's fixed shape-bucket ladder is a
ready-made degradation axis (serving a smaller rung costs frontier
coverage, never a recompile).  This module holds the policy objects
``HGNNServeEngine.serve`` threads through its slot loop:

* :class:`ResilienceConfig` — one knob surface: admission bounds,
  per-request deadline default, per-step wall budget, SLO target, retry
  budget/backoff, degradation patience.
* :class:`AdmissionController` — validates a request before it can touch
  the union batch (integer dtype, id range, size cap), dedups duplicate
  target ids (served once, fanned back out on completion), completes
  zero-target requests immediately, and sheds on a bounded queue.  The
  result is a structured per-request status instead of a mid-batch crash.
* :class:`DegradationController` — a pressure level driven by SLO/step
  budget breaches.  Level ``l`` shrinks the per-slot target chunk
  (``slot_targets >> l``) and clamps the sampler's rung choice to
  ``n_rungs - 1 - l`` — both moves stay strictly inside the warmed ladder,
  so ``compiles_after_warmup`` stays 0 while pressure lasts, and the level
  steps back down after ``recover_patience`` healthy steps.
* :class:`RetryPolicy` — bounded retry-with-backoff around the sampler
  call and the forward; persistent errors surface as
  :class:`StepFailure` and fail only the affected slots' requests.

Status lifecycle (terminal states are what ``serve`` returns)::

    NEW --admit--> QUEUED --slot--> ACTIVE --all rows served--> OK
      |               |                |--deadline expired----> PARTIAL
      |               |--deadline----> PARTIAL (0 rows)
      |               '--(queue full)  REJECTED [shed]
      '--(bad dtype / id range / size) REJECTED
                      ACTIVE --persistent step error----------> FAILED
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# Terminal request statuses (see the lifecycle diagram above).
OK = "OK"
PARTIAL = "PARTIAL"
REJECTED = "REJECTED"
FAILED = "FAILED"
TERMINAL = (OK, PARTIAL, REJECTED, FAILED)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs for the serve path's resilience policies.

    Defaults are deliberately inert where behavior could change for
    existing callers: no deadline, no SLO, unbounded queue, no size cap.
    Retries default on (2) because without an injector the only effect is
    surviving a transient host error that previously crashed the loop.
    """
    max_queue: Optional[int] = None       # admission bound; None = unbounded
    max_request_targets: Optional[int] = None  # per-request size cap
    deadline_ms: Optional[float] = None   # default per-request deadline
    step_budget_ms: Optional[float] = None  # per-step wall budget (pressure)
    slo_ms: Optional[float] = None        # SLO target driving degradation
    max_retries: int = 2                  # attempts = max_retries + 1
    backoff_base_s: float = 0.0           # sleep base * 2**attempt between
    degrade_patience: int = 2             # breaches before stepping level up
    recover_patience: int = 3             # healthy steps before stepping down
    # Which wall feeds the SLO comparison: "observed" (real step wall +
    # injected latency — production semantics) or "injected" (the
    # FaultInjector's latency schedule only — replay-deterministic, so the
    # chaos bench/CI can gate exact degrade/recover counters on any host).
    slo_signal: str = "observed"


class StepFailure(RuntimeError):
    """A serve step exhausted its retry budget (``stage`` names which call)."""

    def __init__(self, stage: str, cause: Exception):
        super().__init__(f"{stage} failed after retries: {cause}")
        self.stage = stage
        self.cause = cause


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


class AdmissionController:
    """Validate/normalize requests before they can reach the union batch.

    ``admit`` mutates the request in place (statuses, the deduped serve-id
    view) and returns True only for requests that should enter the queue;
    everything else reaches a terminal status here.  Counters are the
    deterministic admission half of ``HGNNServeEngine.stats()``.
    """

    def __init__(self, res: ResilienceConfig, n_target_type: int,
                 n_classes: int):
        self.res = res
        self.n_target_type = n_target_type
        self.n_classes = n_classes
        self.counters: Dict[str, int] = {
            "admitted": 0, "rejected": 0, "shed": 0, "deduped_rows": 0,
            "degenerate_completed": 0,
        }

    def _reject(self, r, reason: str, shed: bool = False) -> bool:
        r.status = REJECTED
        r.error = reason
        r.logits = np.zeros((0, self.n_classes), np.float32)
        r.served = np.zeros(0, np.int64)
        self.counters["rejected"] += 1
        if shed:
            self.counters["shed"] += 1
        return False

    def admit(self, r, queue_len: int, now: float) -> bool:
        res = self.res
        targets = np.asarray(r.targets)
        if targets.size and not np.issubdtype(targets.dtype, np.integer):
            return self._reject(r, f"non-integer target dtype "
                                   f"{targets.dtype}")
        targets = targets.astype(np.int64).reshape(-1)
        if targets.size and (targets.min() < 0
                             or targets.max() >= self.n_target_type):
            return self._reject(
                r, f"target ids out of range [0, {self.n_target_type})")
        if (res.max_request_targets is not None
                and len(targets) > res.max_request_targets):
            return self._reject(
                r, f"{len(targets)} targets exceed the "
                   f"{res.max_request_targets}-target request cap")
        if len(targets) == 0:
            # degenerate: complete at admission so it never occupies a
            # refill iteration or a slot (the class dim is n_classes so
            # downstream concatenation over requests stays well-formed)
            r.status = OK
            r.logits = np.zeros((0, self.n_classes), np.float32)
            r.served = np.zeros(0, np.int64)
            self.counters["degenerate_completed"] += 1
            return False
        if res.max_queue is not None and queue_len >= res.max_queue:
            return self._reject(r, f"queue full ({res.max_queue})", shed=True)
        # dedup: duplicate target ids are served once and fanned back out
        # to every duplicate row at completion
        uniq, inv = np.unique(targets, return_inverse=True)
        self.counters["deduped_rows"] += int(len(targets) - len(uniq))
        r._serve_ids = uniq
        r._inv = inv.astype(np.int64)
        r._buf = None
        r._done = 0
        deadline_ms = (r.deadline_ms if r.deadline_ms is not None
                       else res.deadline_ms)
        r._deadline = (now + deadline_ms / 1e3
                       if deadline_ms is not None else None)
        r.status = "QUEUED"
        self.counters["admitted"] += 1
        return True


# ---------------------------------------------------------------------------
# graceful degradation over the warmed ladder
# ---------------------------------------------------------------------------


class DegradationController:
    """SLO-pressure level mapping to (chunk, rung-limit) degradation.

    Both degradation axes stay inside the shape space ``warmup()`` already
    compiled: shrinking the per-slot chunk only changes how many target
    rows are real in a rung's padded batch, and clamping the rung choice
    picks a *smaller warmed rung* (costing frontier truncation, which the
    sampler counts).  Nothing here can introduce a new shape, so
    ``compiles_after_warmup`` stays 0 under any pressure trajectory.
    """

    def __init__(self, res: ResilienceConfig, n_rungs: int,
                 slot_targets: int):
        self.res = res
        self.n_rungs = n_rungs
        self.slot_targets = slot_targets
        # level exhausts both axes: chunk -> 1 and rung limit -> 0
        self.max_level = (n_rungs - 1) + max(
            0, int(np.ceil(np.log2(max(slot_targets, 1)))))
        self.level = 0
        self._breach_streak = 0
        self._ok_streak = 0
        self.counters: Dict[str, int] = {
            "degrade_steps": 0, "degrade_transitions": 0,
            "recover_transitions": 0, "max_degrade_level": 0,
            "over_budget_steps": 0,
        }

    @property
    def active(self) -> bool:
        return (self.res.slo_ms is not None
                or self.res.step_budget_ms is not None)

    def chunk(self) -> int:
        """Per-slot target chunk at the current pressure level."""
        return max(1, self.slot_targets >> self.level)

    def rung_limit(self) -> int:
        """Largest ladder rung index the sampler may pick right now."""
        return max(0, self.n_rungs - 1 - self.level)

    def observe(self, wall_s: float) -> int:
        """Feed one step's observed wall; returns the (new) level."""
        res = self.res
        if self.level > 0:
            self.counters["degrade_steps"] += 1
        if not self.active:
            return self.level
        over_budget = (res.step_budget_ms is not None
                       and wall_s * 1e3 > res.step_budget_ms)
        if over_budget:
            self.counters["over_budget_steps"] += 1
        breach = over_budget or (res.slo_ms is not None
                                 and wall_s * 1e3 > res.slo_ms)
        if breach:
            self._breach_streak += 1
            self._ok_streak = 0
            if (self._breach_streak >= res.degrade_patience
                    and self.level < self.max_level):
                self.level += 1
                self._breach_streak = 0
                self.counters["degrade_transitions"] += 1
                self.counters["max_degrade_level"] = max(
                    self.counters["max_degrade_level"], self.level)
        else:
            self._ok_streak += 1
            self._breach_streak = 0
            if self._ok_streak >= res.recover_patience and self.level > 0:
                self.level -= 1
                self._ok_streak = 0
                self.counters["recover_transitions"] += 1
        return self.level


# ---------------------------------------------------------------------------
# bounded retry-with-backoff
# ---------------------------------------------------------------------------


class RetryPolicy:
    """Retry a callable up to ``max_retries`` extra attempts with
    exponential backoff; raise :class:`StepFailure` on exhaustion.

    Every exception is retried, as in the reference: a kernel that fails
    to build or launch turns into ``FAILED`` requests, not a raise out of
    ``serve``.  So a run that must prove its kernels ran checks
    ``failed_steps == 0`` and ``retries == 0`` in ``stats()``.

    ``hook(attempt)`` runs before each attempt — the engine points it at
    ``FaultInjector.check`` so injected and real exceptions share the
    exact same recovery path.
    """

    def __init__(self, res: ResilienceConfig):
        self.res = res
        self.counters: Dict[str, int] = {
            "sampler_retries": 0, "forward_retries": 0, "failed_steps": 0,
        }

    def run(self, stage: str, call: Callable,
            hook: Optional[Callable[[int], None]] = None):
        last: Optional[Exception] = None
        for attempt in range(self.res.max_retries + 1):
            try:
                if hook is not None:
                    hook(attempt)
                return call()
            except Exception as e:  # noqa: BLE001 — every error is retryable
                last = e
                if attempt < self.res.max_retries:
                    self.counters[f"{stage}_retries"] += 1
                    if self.res.backoff_base_s > 0:
                        time.sleep(self.res.backoff_base_s * (2 ** attempt))
        self.counters["failed_steps"] += 1
        raise StepFailure(stage, last)


# ---------------------------------------------------------------------------
# request finalization (shared by deadline / failure / completion paths)
# ---------------------------------------------------------------------------


def finalize_request(r, status: str, n_classes: int,
                     error: Optional[str] = None) -> None:
    """Move an admitted request to a terminal status, expanding the deduped
    working buffer back to request order.

    ``OK``: every unique id served — ``logits`` has one row per original
    target (duplicates fanned out).  ``PARTIAL``/``FAILED``: only rows
    whose unique id was served survive, compacted in request order, with
    ``served`` naming the target ids those rows answer.
    """
    if r._serve_ids is None:  # rejected/degenerate: already finalized
        r.status = status
        if error is not None:
            r.error = error
        return
    done = int(r._done)
    buf = (r._buf if r._buf is not None
           else np.zeros((len(r._serve_ids), n_classes), np.float32))
    if done >= len(r._serve_ids) and status == OK:
        r.logits = buf[r._inv]
        r.served = np.asarray(r.targets).reshape(-1).copy()
    else:
        mask = r._inv < done
        r.logits = buf[r._inv[mask]]
        r.served = np.asarray(r.targets).reshape(-1)[mask]
    r.status = status
    if error is not None:
        r.error = error


def expire_requests(requests: List, now: float, n_classes: int,
                    ) -> Tuple[List, int]:
    """Split ``requests`` into (still-live, expired-count); expired ones
    finalize as PARTIAL with the rows served so far."""
    live: List = []
    expired = 0
    for r in requests:
        if r is None:
            live.append(r)
            continue
        if r._deadline is not None and now >= r._deadline:
            finalize_request(r, PARTIAL, n_classes, error="deadline expired")
            expired += 1
            live.append(None)
        else:
            live.append(r)
    return live, expired
