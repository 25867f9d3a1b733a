"""Serving engines (port of ``repro/serve/engine.py:32-89, 162-646``).

``HGNNInferEngine`` — HGNN inference driven by a :class:`StagePlan`: the
engine holds the stage-graph executor (not a model class) and serves the
forward over the prepared batch, and ``characterize`` gives the per-stage
records of ``core/characterize.py`` from the same plan.

``HGNNServeEngine`` — request-path serving: slot-based continuous
batching of :class:`HGNNRequest` objects over sampled, rung-padded
minibatches (:mod:`repro_torch.serve.sampler`), with the reference's
resilience policies (:mod:`repro_torch.serve.resilience`), fault hooks
(:mod:`repro_torch.serve.faults`) and live hot-row caches, and every
counter and status name of the reference's ``stats()``.  Partitioned
plans re-partition each sampled batch over a ``static_shapes`` spec and
fail over to the surviving partitions when the fault injector reports a
partition lost.  A plan with an async schedule (``plan.schedule`` with
``prefetch``) samples the predicted next step's batch on a worker thread
while the current step's forward runs (``_SamplerPrefetcher``).

``ServeEngine`` — LM serving over the prefill / decode step functions of
``nn/transformer.py``: each wave of up to ``batch_slots`` requests is
left-padded to one length (with token 0, attended, as the reference does),
prefilled once, grafted into the decode caches, and decoded in lock-step.
Sampling is greedy, or categorical at a per-slot temperature from the
engine's own seeded ``torch.Generator`` (``jax.random`` streams cannot be
reproduced).

The reference jits the forward and the decode step; here the engines run
them through ``graphs.compiled`` (a CUDA graph captured once a signature
and replayed; off the card the function itself), under
``torch.inference_mode``.  A caller that passes ``fn=`` to an HGNN engine
gets that function as given: ``fn=executor.forward`` is the eager arm.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import graphs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import build
from repro_torch.nn import transformer as tf
from repro_torch.nn.ssm import MambaCache
from repro_torch.serve import resilience
from repro_torch.serve.resilience import (
    FAILED, OK, PARTIAL, AdmissionController, DegradationController,
    ResilienceConfig, RetryPolicy, StepFailure, finalize_request)


class HGNNInferEngine:
    """Plan-driven HGNN serving over one prepared full-graph batch.  With
    ``fn=None`` the forward is ``graphs.compiled(executor.forward)``: on
    the card the batch and parameters are held where they lie and each
    ``infer`` after the first replays one captured graph."""

    def __init__(self, executor, params, batch, fn=None):
        self.executor = executor
        self.plan = executor.plan
        self.params = params
        self.batch = batch
        self.fn = fn if fn is not None else graphs.compiled(executor.forward)

    def infer(self) -> torch.Tensor:
        """One full forward over the prepared batch -> logits."""
        with torch.inference_mode():
            return self.fn(self.params, self.batch)

    def characterize(self, n_chips: int = 1, timed: bool = False
                     ) -> Dict[str, Dict]:
        """Per-stage (FP/NA/SA/head) FLOPs, HBM bytes and roofline records
        from the serving code path — the paper's Fig. 3 breakdown; with
        ``timed`` (on the card) the stage and device times and the device
        time by kernel class too (Fig. 2 and Fig. 3 measured)."""
        return self.executor.stage_records(self.params, self.batch,
                                           n_chips=n_chips,
                                           timed=timed)["stages"]


@dataclasses.dataclass
class HGNNRequest:
    """One HGNN inference request: classify ``targets`` (global target-type
    vertex ids).

    ``serve`` leaves every request in a terminal ``status``
    (``OK`` / ``PARTIAL`` / ``REJECTED`` / ``FAILED`` — see
    ``repro_torch.serve.resilience``) with ``logits`` rows for exactly the
    target ids named by ``served`` (all of ``targets`` when ``OK``; the
    rows completed before the deadline/failure otherwise; always
    ``n_classes`` wide).  ``deadline_ms`` overrides the engine-wide
    default."""
    targets: np.ndarray  # [n] integer, global ids of the plan's target type
    logits: Optional[np.ndarray] = None  # [n_served, n_classes] when done
    deadline_ms: Optional[float] = None  # per-request deadline override
    status: str = "NEW"
    error: Optional[str] = None          # reject/failure reason
    served: Optional[np.ndarray] = None  # target ids the logits rows answer
    _done: int = 0  # host cursor into _serve_ids: rows < _done are served
    _serve_ids: Optional[np.ndarray] = None  # admission's deduped id view
    _inv: Optional[np.ndarray] = None        # original row -> _serve_ids row
    _buf: Optional[np.ndarray] = None        # [len(_serve_ids), C] working
    _deadline: Optional[float] = None        # absolute perf_counter deadline

    @property
    def finished(self) -> bool:
        return self.status in resilience.TERMINAL


def _shapes(tree, path=()) -> tuple:
    """Every array of a batch with its place, shape and dtype: two batches
    with the same signature run the forward on the same shapes."""
    if isinstance(tree, dict):
        return tuple(x for k, v in tree.items()
                     for x in _shapes(v, path + (k,)))
    if isinstance(tree, (list, tuple)):
        return tuple(x for i, v in enumerate(tree)
                     for x in _shapes(v, path + (i,)))
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return ((path, tuple(tree.shape), str(tree.dtype)),)
    return ()


def _served_params(params):
    """``params`` with each DTensor leaf as the rank's local copy; only a
    leaf replicated on every mesh dimension holds the whole weight."""
    from repro_torch import tree
    from repro_torch.dist.sharding import is_dtensor

    def one(x):
        if not is_dtensor(x):
            return x
        if not all(p.is_replicate() for p in x.placements):
            raise ValueError(
                f"HGNNServeEngine serves replicated parameters; a leaf "
                f"{tuple(x.shape)} is laid out as {x.placements} on "
                f"{x.device_mesh}")
        return x.to_local()

    return tree.map(one, params)


def _first_tensor(tree):
    if torch.is_tensor(tree):
        return tree
    values = (tree.values() if isinstance(tree, dict)
              else tree if isinstance(tree, (list, tuple)) else ())
    for v in values:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


class _SamplerPrefetcher:
    """Async host-side sampler refill (the reference's, ``:91``), one of
    the stage-graph schedule's overlap sources (``ScheduleSpec.
    prefetch``): while step ``t``'s forward runs, one worker thread
    samples the *predicted* step ``t+1`` union batch (``HGNNServeEngine.
    _predict_next``).  A wrong prediction (deadline expiry, a degradation
    shift, a failed step) makes :meth:`take` discard the batch, and the
    engine samples on its own thread instead.  Always correct:
    ``HGNNSampler.sample`` is a pure function of ``(ids, rung)``, so a
    discarded call changes nothing.  The worker runs the host numpy
    sampler alone: it calls no kernel and touches no CUDA state (the
    batch is placed on the card by the serving thread)."""

    def __init__(self, sampler):
        from concurrent.futures import ThreadPoolExecutor

        self.sampler = sampler
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._future = None
        self._key = None
        self.counters: Dict[str, int] = {
            "issued": 0, "hits": 0, "mispredicts": 0, "cold": 0}

    @staticmethod
    def _mk_key(ids: np.ndarray, rung_limit: int):
        return (np.asarray(ids, np.int64).tobytes(), int(rung_limit))

    def submit(self, ids: np.ndarray, rung_limit: int, alloc=None) -> None:
        """Start sampling a speculative next-step batch (at most one in
        flight; a pending one keeps its slot); ``alloc`` as the sampler
        takes it (``_PinnedRows``: no CUDA call, so the worker makes
        none)."""
        if self._future is not None:
            return
        self._key = self._mk_key(ids, rung_limit)
        self.counters["issued"] += 1
        self._future = self._pool.submit(
            self.sampler.sample, np.asarray(ids, np.int64),
            max_rung=int(rung_limit), alloc=alloc)

    def take(self, ids: np.ndarray, rung_limit: int):
        """The prefetched batch if it answers exactly ``(ids,
        rung_limit)``; None (sample on the serving thread) otherwise."""
        fut, self._future = self._future, None
        if fut is None:
            self.counters["cold"] += 1
            return None
        try:
            sb = fut.result()
        except Exception:  # noqa: BLE001 — the retried sync call re-raises
            sb = None
        if sb is None or self._key != self._mk_key(ids, rung_limit):
            self.counters["mispredicts"] += 1
            return None
        self.counters["hits"] += 1
        return sb

    def drain(self) -> None:
        """Wait for any speculation in flight and stop the worker: a serve
        leaves no sampler thread running, whether it ended clean, expired
        every request or failed over."""
        if self._future is not None:
            try:
                self._future.result()
            except Exception:  # noqa: BLE001 — speculation is disposable
                pass
            self._future = None
        self._pool.shutdown(wait=True)


class _PinnedRows:
    """Pinned host arrays for the sampler to write a served batch's feature
    tables into (its ``alloc``), so that the compiled forward copies them
    to the card straight from where they lie, with no host copy.

    :meth:`reserve` (the serving thread, at warmup) pins ``DEPTH`` arrays
    for a table's ``(type, shape, dtype)``; a call hands out the next of
    them, in turn, and makes no CUDA call, so the prefetch worker may call
    it.  A table not reserved comes back as a new pageable array.  A
    batch's tables are rewritten ``DEPTH`` batches of that rung later: the
    engine holds at most three at once (the step's, the prefetched one and
    ``last_sb``), and the forward has read a step's before it returns."""

    DEPTH = 4

    def __init__(self):
        self._rings: Dict[tuple, list] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(t, shape, dtype) -> tuple:
        return (t, tuple(shape), np.dtype(dtype).str)

    def reserve(self, t, shape, dtype) -> np.ndarray:
        """Pin the arrays of a table (once) and hand out the next."""
        key = self._key(t, shape, dtype)
        if key not in self._rings:
            dt = torch.from_numpy(np.empty(0, dtype)).dtype
            self._rings[key] = [0] + [
                graphs._card.staging(tuple(shape), dt).numpy()
                for _ in range(self.DEPTH)]
        return self(t, shape, dtype)

    def __call__(self, t, shape, dtype) -> np.ndarray:
        ring = self._rings.get(self._key(t, shape, dtype))
        if ring is None:
            return np.empty(shape, dtype)
        with self._lock:
            ring[0] = ring[0] % self.DEPTH + 1
            return ring[ring[0]]


class HGNNServeEngine:
    """Slot-based continuous batching for HGNN requests.

    Requests occupy fixed batch slots; each step every active slot
    contributes up to ``slot_targets`` of its remaining target vertices to
    a union minibatch, the sampler extracts one rung-padded subgraph for
    the union, one forward serves it on the parameters' device, and the
    logits scatter back per request through ``SampledBatch.target_rows``.  Finished slots refill from the queue
    without stopping the step loop.

    The forward is ``graphs.compiled(executor.forward)`` (with ``fn=None``
    or a compiled ``fn``, whose eager function it compiles anew for this
    engine); a plain ``fn`` runs as given, on a batch placed by
    :meth:`place`.  On the card the compiled forward holds the parameters
    and takes each sampled host batch as it is: the sampler writes the
    feature tables (most of a batch's bytes) into pinned arrays that the
    engine reserved at warmup (``_PinnedRows``), the wrapper copies them
    to the signature's own device buffers straight from there and the
    rest through its pinned staging, and replays the rung's graph.
    ``warmup()`` runs one forward per ladder rung on an all-pad batch: one
    capture a rung.
    ``stats()["compiles_after_warmup"]`` counts, over this engine's own
    forwards since warmup, the new signatures of the compiled forward
    (``Compiled.signatures``: a graph captured on the card, what one
    would be made for off it) or, for a plain ``fn``, the batches whose
    shapes no earlier forward had — what the reference's jit would trace
    anew — plus what was made at run time: kernel-library loads and new
    or grown kernel
    scratch buffers (``kernels/build.py``'s process-wide ``created``), so
    another engine or kernel call in the process is not counted against
    it.  It stays 0 while a batch's shapes are a pure function of its
    rung; a partition failover changes ``K`` and with it the partitioned
    shapes, which counts one for each rung served after it (one capture
    a rung and ``K``), as in the reference.

    Partitioned plans (``plan.partition``) are served through a
    ``static_shapes`` copy of the spec: every sampled batch is partitioned
    on the host (``dist.partition_batch``) to tables whose shapes depend
    on the rung and ``K`` alone.  When the injector reports a partition
    lost, the next batches are partitioned over the survivors
    (``dist.surviving_partition_spec``); the head's inverse permutation
    keeps global row order, so the logits keep their bits.

    Resilience, as in the reference: admission control with per-request
    statuses, per-request deadlines (expired requests complete
    ``PARTIAL``), SLO-driven degradation inside the warmed ladder, and
    bounded retry around the sampler call and the forward.  The retry
    layer retries every exception, kernel errors included, so a run that
    must show its kernels ran checks ``failed_steps == 0`` and
    ``retries == 0``.  ``step_log`` entries add ``sample_s`` (the host
    sampler), ``forward_s`` (partitioning, upload, forward and read-back)
    and ``partition_s`` (the host partitioner alone, about 0 unpartitioned)
    to the reference's ``wall_s``.

    With ``plan.schedule.prefetch`` the next step's batch is sampled on a
    worker thread while this step's forward runs (``_SamplerPrefetcher``);
    ``stats()["prefetch"]`` counts its hits, and the logits are bitwise
    those of a serve without it.

    Parameters laid out replicated on a mesh (``train/elastic.
    reshard_state`` after a pod loss) are served from the rank's own copy
    (no collective, the same bits) on the rank's device; a parameter laid
    out otherwise raises.  No mesh is installed: each serving rank runs
    the whole forward.
    """

    def __init__(self, executor, params, sampler, slots: int = 8,
                 slot_targets: int = 4, fn=None,
                 resilience_cfg: Optional[ResilienceConfig] = None,
                 injector=None):
        self.executor = executor
        self.plan = executor.plan
        self.params = _served_params(params)
        self.sampler = sampler
        self.slots = slots
        self.slot_targets = slot_targets
        if fn is None or isinstance(fn, graphs.Compiled):
            fn = graphs.compiled(executor.forward if fn is None else fn.fn)
        self.fn = fn
        self.device = _first_tensor(self.params).device
        # the compiled forward on the card: host batches go to it as they are
        self._captured = (isinstance(fn, graphs.Compiled)
                          and graphs.on_card(self.params))
        # pinned feature tables for the sampler to write into (warmup)
        self._rows = _PinnedRows() if self._captured else None
        max_t = max(t for t, _ in sampler.ladder)
        if slots * slot_targets > max_t:
            raise ValueError(
                f"slots*slot_targets={slots * slot_targets} exceeds the "
                f"largest ladder rung's target cap {max_t}; widen the "
                "ladder or shrink the slot plan")
        self.res = (resilience_cfg if resilience_cfg is not None
                    else ResilienceConfig())
        self.injector = injector
        self.n_classes = int(executor.cfg.n_classes)
        self._made_after_warmup: Optional[int] = None
        self._shapes_seen: set = set()
        self.last_partition_s = 0.0
        # failover swaps in a survivors-only spec; partitioned serving
        # pins static table shapes (see the class docstring)
        self._serve_plan = self.plan
        if self.plan.partition is not None:
            self._serve_plan = dataclasses.replace(
                self.plan, partition=dataclasses.replace(
                    self.plan.partition, static_shapes=True))
        self.step_log: List[Dict] = []
        self.last_sb = None
        # residency: live per-type hot-row caches over the sampled frontier,
        # keyed by global vertex ids and owned by the engine, so rung
        # changes and degradation never touch them
        self.caches: Optional[Dict] = None
        if self.plan.residency is not None:
            from repro_torch.core.residency import HotRowCache, graph_degrees

            cap = self.plan.residency.cache_rows
            self.caches = {t: HotRowCache(cap, d)
                           for t, d in graph_degrees(sampler.hg).items()}
        self._fresh_policies()

    def _fresh_policies(self) -> None:
        """Per-serve policy state (counters reset each ``serve`` call)."""
        self.admission = AdmissionController(
            self.res, self.sampler.n_target_type, self.n_classes)
        self.degrade = DegradationController(
            self.res, len(self.sampler.ladder), self.slot_targets)
        self.retry = RetryPolicy(self.res)
        # the schedule's sampler prefetch: step t+1 sampled while step t's
        # forward runs
        sched = self.plan.schedule
        self.prefetch = (_SamplerPrefetcher(self.sampler)
                         if sched is not None and sched.prefetch else None)
        self._deadline_expired = 0
        self._failovers = 0
        self._lost_partitions: List[int] = []
        self._status_counts: Dict[str, int] = {}

    def _cache_step(self, ids: np.ndarray, sb) -> None:
        """One serving step's residency traffic: pin the in-flight targets,
        run every type's sampled local->global table through the live
        caches' deterministic admission policy, then unpin."""
        spec = self.plan.residency
        tgt = self.plan.target
        pin = spec.pin_targets and tgt in self.caches
        if pin:
            self.caches[tgt].pin(ids)
        for t, loc in sb.local.items():
            if t in self.caches:
                self.caches[t].access_many(loc)
        if pin:
            self.caches[tgt].unpin(ids)

    def place(self, batch: Dict) -> Dict:
        """A sampled host batch (CPU tensors) on the engine's device
        (pageable copies; the compiled forward on the card uploads from
        pinned memory instead)."""
        from repro_torch.core.pipeline import _to_device

        return _to_device(batch, self.device)

    def _forward_batch(self, batch: Dict) -> Dict:
        """A sampled host batch in the layout the serve plan runs:
        partitioned on the host over the current (static-shape) spec, or
        as it is.  The partitioner's per-step record (``part["meta"]``: K
        and the cut edges), which no forward reads, is left out, so that
        the batch's signature is a function of its rung and K."""
        if self._serve_plan.partition is None:
            return batch
        from repro_torch.dist.partition import partition_batch

        batch = partition_batch(self._serve_plan, batch)
        part = dict(batch["part"])
        part.pop("meta", None)
        return dict(batch, part=part)

    def _forward(self, batch: Dict) -> np.ndarray:
        """Partition a sampled host batch if the plan says so, upload it to
        the engine's device, run the forward and read the logits back;
        after warmup, count a new signature (the compiled forward's) or a
        batch of new shapes (a plain ``fn``), and what the forward made
        (``build.created``'s change).  The host partitioner's seconds go
        to ``last_partition_s``."""
        t0 = time.perf_counter()
        batch = self._forward_batch(batch)
        self.last_partition_s = time.perf_counter() - t0
        made = build.created
        if isinstance(self.fn, graphs.Compiled):
            sigs = self.fn.signatures
            with torch.inference_mode():
                out = self.fn(self.params, batch if self._captured
                              else self.place(batch)).cpu().numpy()
            new = self.fn.signatures - sigs
        else:  # the eager arm
            sig = _shapes(batch)
            with torch.inference_mode():
                out = self.fn(self.params, self.place(batch)).cpu().numpy()
            new = int(sig not in self._shapes_seen)
            self._shapes_seen.add(sig)
        if self._made_after_warmup is not None:
            self._made_after_warmup += build.created - made + new
        return out

    def _predict_next(self, active, q, chunks):
        """The next step's ``(union ids, rung limit)``, predicted by
        running this step's completion forward (the reference's,
        ``:281``): each chunk advances its request's cursor, exhausted
        slots refill from the queue in slot order, and the chunking runs
        again at the current degradation level.  A guess only: deadline
        expiry, a degradation shift or a failed step makes it wrong, and
        ``_SamplerPrefetcher.take`` then discards the batch.  None when
        no step would follow."""
        done = {id(r): start + len(cids) for r, start, cids in chunks}
        qi = list(q)
        qpos = 0
        cursors = []
        for r in active:
            cur = None
            if r is not None:
                d = done.get(id(r), r._done)
                if d < len(r._serve_ids):
                    cur = (r, d)
            if cur is None and qpos < len(qi):
                cur = (qi[qpos], qi[qpos]._done)
                qpos += 1
            cursors.append(cur)
        chunk = self.degrade.chunk()
        rung_limit = self.degrade.rung_limit()
        t_budget = self.sampler.ladder[rung_limit][0]
        parts = []
        n_union = 0
        for cur in cursors:
            if cur is None:
                continue
            if n_union >= t_budget:
                break
            r, d = cur
            take = min(chunk, t_budget - n_union, len(r._serve_ids) - d)
            parts.append(np.asarray(r._serve_ids[d: d + take], np.int64))
            n_union += take
        if not parts:
            return None
        return np.concatenate(parts), rung_limit

    def _maybe_failover(self, step: int) -> None:
        """An injected partition loss: every later batch is partitioned over
        the survivors (``surviving_partition_spec``)."""
        if self.injector is None or self._serve_plan.partition is None:
            return
        lost = self.injector.partition_loss(step)
        if lost is None:
            return
        from repro_torch.dist.partition import surviving_partition_spec

        spec = surviving_partition_spec(self._serve_plan.partition, [lost])
        self._serve_plan = dataclasses.replace(self._serve_plan,
                                               partition=spec)
        self._failovers += 1
        self._lost_partitions.append(int(lost))

    def warmup(self) -> int:
        """One forward per ladder rung on an all-pad batch: builds the
        kernels and sizes every scratch buffer; then starts the count that
        ``stats`` reports as ``compiles_after_warmup`` at 0.  Returns the
        number of rungs warmed."""
        alloc = self._rows.reserve if self._rows is not None else None
        for i in range(len(self.sampler.ladder)):
            self._forward(self.sampler.dummy_batch(i, alloc=alloc).batch)
        self._made_after_warmup = 0
        return len(self.sampler.ladder)

    def serve(self, requests: List[HGNNRequest]) -> List[HGNNRequest]:
        """Run the slot loop until every request reaches a terminal status.

        Never raises for admissible traffic: bad requests are REJECTED at
        admission, deadline-expired ones complete PARTIAL, and persistent
        step errors FAIL only the requests in the affected slots.
        """
        self._fresh_policies()
        adm, deg, retry = self.admission, self.degrade, self.retry
        now = time.perf_counter()
        q: collections.deque = collections.deque()
        for r in requests:
            if adm.admit(r, len(q), now):
                q.append(r)
        active: List[Optional[HGNNRequest]] = [None] * self.slots
        self.step_log = []
        step = 0
        while q or any(r is not None for r in active):
            now = time.perf_counter()
            # deadline expiry: active slots and queued requests complete
            # PARTIAL (rows served so far) without blocking the loop
            active, n_exp = resilience.expire_requests(
                active, now, self.n_classes)
            self._deadline_expired += n_exp
            if q:
                live: collections.deque = collections.deque()
                for r in q:
                    if r._deadline is not None and now >= r._deadline:
                        finalize_request(r, PARTIAL, self.n_classes,
                                         error="deadline expired")
                        self._deadline_expired += 1
                    else:
                        live.append(r)
                q = live
            # refill: every queued request is servable and takes one slot
            for s in range(self.slots):
                if active[s] is None and q:
                    active[s] = q.popleft()
                    active[s].status = "ACTIVE"
            # degradation: per-slot chunk + rung clamp (warmed rungs only)
            level_used = deg.level
            chunk = deg.chunk()
            rung_limit = deg.rung_limit()
            t_budget = self.sampler.ladder[rung_limit][0]
            chunks = []  # (request, start_row_in_request, ids)
            n_union = 0
            for r in active:
                if r is None:
                    continue
                if n_union >= t_budget:
                    break  # degraded union budget: remaining slots wait
                take = min(chunk, t_budget - n_union,
                           len(r._serve_ids) - r._done)
                ids = r._serve_ids[r._done: r._done + take]
                chunks.append((r, r._done, np.asarray(ids, np.int64)))
                n_union += take
            if not chunks:  # everything expired this pass
                continue
            self._maybe_failover(step)
            ids = np.concatenate([c[2] for c in chunks])
            t0 = time.perf_counter()
            inj = self.injector
            t_sampled = t0
            # a prefetched batch stands in for the sampler call, under the
            # same retry policy and fault hook, so injected sampler faults
            # fire alike whether the batch was prefetched or not
            sb_pre = (self.prefetch.take(ids, rung_limit)
                      if self.prefetch is not None else None)
            sample_call = ((lambda: sb_pre) if sb_pre is not None else
                           (lambda: self.sampler.sample(
                               ids, max_rung=rung_limit, alloc=self._rows)))
            try:
                sb = retry.run(
                    "sampler", sample_call,
                    hook=(lambda a: inj.check("sampler", step, a))
                    if inj else None)
                t_sampled = time.perf_counter()
                if self.prefetch is not None:
                    nxt = self._predict_next(active, q, chunks)
                    if nxt is not None:
                        self.prefetch.submit(*nxt, alloc=self._rows)
                out = retry.run(
                    "forward", lambda: self._forward(sb.batch),
                    hook=(lambda a: inj.check("forward", step, a))
                    if inj else None)
            except StepFailure as e:
                wall = time.perf_counter() - t0
                inj_lat = inj.latency_s(step) if inj else 0.0
                wall_obs = wall + inj_lat
                for r, _start, _cids in chunks:
                    finalize_request(r, FAILED, self.n_classes,
                                     error=str(e))
                for s in range(self.slots):
                    if active[s] is not None and active[s].status == FAILED:
                        active[s] = None
                deg.observe(inj_lat if self.res.slo_signal == "injected"
                            else wall_obs)
                self.step_log.append({
                    "active_slots": len(chunks), "queue_len": len(q),
                    "n_targets": int(len(ids)), "rung_index": -1,
                    "frontier_bytes": 0.0, "truncated_rows": 0,
                    "wall_s": wall, "wall_observed_s": wall_obs,
                    "degrade_level": level_used, "failed": True,
                    "error": str(e),
                })
                step += 1
                continue
            rows = out[sb.target_rows]
            t_end = time.perf_counter()
            wall = t_end - t0
            if self.caches is not None:  # host bookkeeping, untimed
                self._cache_step(ids, sb)
            inj_lat = inj.latency_s(step) if inj else 0.0
            wall_obs = wall + inj_lat
            off = 0
            for r, start, cids in chunks:
                n = len(cids)
                if r._buf is None:
                    r._buf = np.zeros((len(r._serve_ids), rows.shape[1]),
                                      rows.dtype)
                r._buf[start: start + n] = rows[off: off + n]
                r._done = start + n
                off += n
            for s in range(self.slots):
                r = active[s]
                if r is not None and r._done >= len(r._serve_ids):
                    finalize_request(r, OK, self.n_classes)
                    active[s] = None
            deg.observe(inj_lat if self.res.slo_signal == "injected"
                        else wall_obs)
            self.step_log.append({
                "active_slots": len(chunks),
                "queue_len": len(q),
                "n_targets": int(sb.n_targets),
                "rung_index": int(sb.rung_index),
                "frontier_bytes": float(sb.meta["frontier_bytes"]),
                "truncated_rows": int(sb.meta["truncated_rows"]),
                "wall_s": wall,
                "wall_observed_s": wall_obs,
                "degrade_level": level_used,
                "sample_s": t_sampled - t0,
                "forward_s": t_end - t_sampled,
                "partition_s": self.last_partition_s,
            })
            self.last_sb = sb
            step += 1
        if self.prefetch is not None:
            self.prefetch.drain()
        for r in requests:
            self._status_counts[r.status] = (
                self._status_counts.get(r.status, 0) + 1)
        return requests

    def stats(self) -> Dict:
        """Deterministic serving counters (walls reported, never gated):
        the reference's keys.  ``compiles_after_warmup`` is ``None`` until
        :meth:`warmup` has run."""
        rung_hits: Dict[int, int] = {}
        for e in self.step_log:
            if e.get("failed"):
                continue  # failed steps sample no rung
            rung_hits[e["rung_index"]] = rung_hits.get(e["rung_index"], 0) + 1
        compiles = self._made_after_warmup
        walls = [e["wall_s"] for e in self.step_log]
        deg, retry, adm = self.degrade, self.retry, self.admission
        inj_counts = dict(self.injector.counters) if self.injector else {}
        out = {
            "steps": len(self.step_log),
            "rung_hits": {int(k): int(v)
                          for k, v in sorted(rung_hits.items())},
            "frontier_bytes": float(
                sum(e["frontier_bytes"] for e in self.step_log)),
            "truncated_rows": int(
                sum(e["truncated_rows"] for e in self.step_log)),
            "compiles_after_warmup": compiles,
            "wall_total_s": float(sum(walls)),
            "wall_mean_ms": float(1e3 * np.mean(walls)) if walls else 0.0,
            "resilience": {
                **{k: int(v) for k, v in adm.counters.items()},
                **{k: int(v) for k, v in retry.counters.items()},
                **{k: int(v) for k, v in deg.counters.items()},
                "retries": int(retry.counters["sampler_retries"]
                               + retry.counters["forward_retries"]),
                "deadline_expired": int(self._deadline_expired),
                "failed_requests": int(
                    self._status_counts.get(FAILED, 0)),
                "partial_requests": int(
                    self._status_counts.get(PARTIAL, 0)),
                "ok_requests": int(self._status_counts.get(OK, 0)),
                "partition_failovers": int(self._failovers),
                "lost_partitions": list(self._lost_partitions),
                "statuses": dict(self._status_counts),
                "injected": inj_counts,
            },
        }
        if self.prefetch is not None:
            out["prefetch"] = {k: int(v)
                               for k, v in self.prefetch.counters.items()}
        if self.caches is not None:
            hits = sum(c.hits for c in self.caches.values())
            misses = sum(c.misses for c in self.caches.values())
            out["residency"] = {
                "per_type": {t: dict(c.counters)
                             for t, c in sorted(self.caches.items())},
                "hits": int(hits),
                "misses": int(misses),
                "rows": int(hits + misses),
                "hit_rate": float(hits / max(hits + misses, 1)),
                "evictions": int(sum(c.evictions
                                     for c in self.caches.values())),
                "cache_rows": int(sum(c.capacity
                                      for c in self.caches.values())),
            }
        return out


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # [T] int32
    max_tokens: int = 32
    temperature: float = 0.0
    out_tokens: Optional[List[int]] = None


class ServeEngine:
    """LM serving engine; runs on the device of ``params["embed"]``.

    The decode step is ``graphs.compiled(lm_decode_step)``, as the
    reference jits it: on the card one graph a wave batch size, captured
    at the first wave of that size.  Everything it reads is held where it
    lies: the parameters, the decode caches, the token and the position.
    The engine owns one set of caches for ``batch_slots`` rows, made at
    its first wave; a wave of ``b`` decodes in their first ``b`` rows
    (views at the same addresses), zeroed and grafted in place, so the
    caches of one full wave are all it ever holds.  The token buffer is
    sliced the same way, and the position advances in place after each
    step.  The prefill, the sampling and the read-back stay outside it,
    as in the reference.

    ``timings`` holds, per wave, the host-clock seconds to the first token
    (prefill, graft and the first sample) and of the decode steps, and the
    number of decode steps; both spans end where the engine reads tokens
    back to the host, which waits for the device."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 8,
                 max_len: int = 512, rng_seed: int = 0, eos_id: int = -1):
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = params["embed"].device
        self.gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.timings: List[dict] = []
        self._decode = graphs.compiled(
            lambda p, t, c, pos: tf.lm_decode_step(p, cfg, t, c, pos))
        self._caches: Optional[List] = None  # batch_slots rows, made once
        self._token = torch.zeros((batch_slots, 1), dtype=torch.int64,
                                  device=self.device)
        self._pos = torch.zeros((), dtype=torch.int64, device=self.device)

    def _sample(self, logits: torch.Tensor,
                temps: Optional[torch.Tensor]) -> torch.Tensor:
        """Per-slot sampling: greedy where the temperature is <= 0,
        categorical otherwise.  ``temps`` is built once per wave; None
        means an all-greedy wave."""
        greedy = torch.argmax(logits, dim=-1)
        if temps is None:
            return greedy
        probs = torch.softmax(
            logits.float() / torch.clamp(temps, min=1e-6)[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        return torch.where(temps > 0.0, sampled, greedy)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Pad prompts to a common length per wave, prefill once, then
        decode lock-step."""
        out: List[Request] = []
        with torch.inference_mode():
            for wave_start in range(0, len(requests), self.slots):
                wave = requests[wave_start: wave_start + self.slots]
                out.extend(self._run_wave(wave))
        return out

    def _wave_caches(self, b: int, prefill, t0: int) -> List:
        """The decode caches of a wave of ``b`` with the prefill grafted in:
        the first ``b`` rows of the engine's caches (each run's ``[L, B,
        ...]`` sliced on ``B``, so a layer's rows stay contiguous and every
        wave of ``b`` finds them where its graph captured them).  The
        attention rows are zeroed, as fresh caches are, before the graft,
        and each Mamba run's prefill state is copied into its rows."""
        if self._caches is None:
            self._caches = tf.init_kv_caches(self.cfg, self.slots,
                                             self.max_len, self.device)
        held = [MambaCache(*[f[:, :b] for f in c])
                if isinstance(c, MambaCache)
                else {"k": c["k"][:, :b], "v": c["v"][:, :b]}
                for c in self._caches]
        for c in held:
            if not isinstance(c, MambaCache):
                c["k"].zero_()
                c["v"].zero_()
        grafted = tf.graft_prefill_caches(self.cfg, list(held), prefill, t0)
        for h, g in zip(held, grafted):
            if isinstance(h, MambaCache):
                for dst, src in zip(h, g):
                    if dst.shape != src.shape or dst.dtype != src.dtype:
                        raise ValueError(
                            f"a Mamba prefill state {tuple(src.shape)} "
                            f"{src.dtype} does not fit the held "
                            f"{tuple(dst.shape)} {dst.dtype}")
                    dst.copy_(src)
        return held

    def _run_wave(self, wave: List[Request]) -> List[Request]:
        cfg, dev = self.cfg, self.device
        t_start = time.perf_counter()
        b = len(wave)
        t0 = max(len(r.prompt) for r in wave)
        toks = np.zeros((b, t0), np.int32)
        for i, r in enumerate(wave):
            toks[i, t0 - len(r.prompt):] = r.prompt  # left-pad
        logits, pf_caches = tf.lm_prefill(
            self.params, cfg, torch.from_numpy(toks).to(dev))
        caches = self._wave_caches(b, pf_caches, t0)
        del pf_caches
        token, pos = self._token[:b], self._pos
        max_new = max(r.max_tokens for r in wave)
        temps_host = np.array([r.temperature for r in wave], np.float32)
        temps = (torch.from_numpy(temps_host).to(dev)
                 if (temps_host > 0).any() else None)
        cur = self._sample(logits[:, 0], temps)
        outs = [[t] for t in cur.tolist()]
        t_first = time.perf_counter()
        done = np.zeros(b, bool)
        pos.fill_(t0)  # advanced on the device
        steps = 0
        for step in range(1, max_new):
            token.copy_(cur[:, None])
            logits, caches = self._decode(self.params, token, caches, pos)
            pos.add_(1)
            steps += 1
            cur = self._sample(logits[:, 0], temps)
            cur_host = cur.tolist()
            for i in range(b):
                if done[i] or step >= wave[i].max_tokens:
                    done[i] = True
                    continue
                outs[i].append(cur_host[i])
                if cur_host[i] == self.eos_id:
                    done[i] = True
            if done.all():
                break
        self.timings.append({"prefill_s": t_first - t_start,
                             "decode_s": time.perf_counter() - t_first,
                             "decode_steps": steps})
        for r, o in zip(wave, outs):
            r.out_tokens = o[: r.max_tokens]
        return wave
