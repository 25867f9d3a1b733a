"""Serving launcher (port of ``repro/launch/serve.py``: the LM branch of
``main``, ``:309-418``, the full-graph ``--hgnn`` path with its
stage-aware sharding on a device mesh, ``:45-130, 228-274``, and
request-path serving, ``:131-227``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --reduced [--requests N] [--prompt-len T] [--max-tokens M] \
      [--temperature X] [--slots B] [--use-pallas]

  PYTHONPATH=src python -m repro_torch.launch.serve --hgnn han \\
      --dataset imdb --use-pallas --fuse-na-sa [--layers L] [--iters N]
  PYTHONPATH=src python -m repro_torch.launch.serve --hgnn han \\
      --dataset imdb --use-pallas --degree-buckets 3 [--layers L]
  PYTHONPATH=src python -m repro_torch.launch.serve --hgnn rgcn \\
      --dataset imdb --use-pallas [--degree-buckets 3] [--layers L]
  PYTHONPATH=src python -m repro_torch.launch.serve --hgnn gcn \\
      --dataset reddit [--cache-rows 256] [--layers L]
  PYTHONPATH=src python -m repro_torch.launch.serve --hgnn magnn \\
      --dataset imdb --use-pallas [--cache-rows 256] [--layers L]
  PYTHONPATH=src python -m repro_torch.launch.serve --hgnn han \\
      --dataset imdb --use-pallas --fuse-na-sa --fanout 8 --slots 8 \\
      --slot-targets 4 --requests 32 [--deadline-ms D] [--slo-ms S] \\
      [--max-queue Q] [--inject-faults SEED] [--slo-signal injected]
  PYTHONPATH=src python -m repro_torch.launch.serve --hgnn han \\
      --dataset imdb --use-pallas --partitions 4 [--layers L] \\
      [--cache-rows C] [--characterize] [--fanout 8 --inject-faults SEED]
  PYTHONPATH=src python -m repro_torch.launch.serve --hgnn rgcn \
      --dataset imdb --use-pallas --partitions 4 --layers 2 --overlap 2
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --hgnn han \
      --dataset imdb --use-pallas --fuse-na-sa --mesh-data 2 --device cpu

runs on the CUDA device; ``--device cpu`` runs on the CPU (the kernels'
plain versions).  Without ``--hgnn`` it serves the decoder-only LM
``--arch`` (dense, moe, ssm, hybrid or vlm; full size, or ``--reduced``)
through ``ServeEngine`` with random weights from seed 0, and prints the
reference's ``reqN: [...]`` lines and ``N tokens in Xs (Y tok/s)``.  ``--use-pallas`` sets ``ModelConfig.use_pallas`` there:
prefill through the ``flash_attention`` kernel and decode through
``decode_attention`` (the reference's flag reaches only its HGNN branch).
A vlm serves as the reference's CLI serves it, as its dense stack with
no frontend embeddings (the engine passes none); the encdec family exits
as the reference does (``nn/encdec.py`` serves it: ``encdec_prefill``,
``encdec_decode_step``).  An SSM or hybrid prompt longer than the SSD
chunk (256 at full size) must be a multiple of it, as in the reference.

With ``--hgnn``, ``--cache-rows C`` turns on hot-feature residency for
any of the four models; ``--hgnn gcn`` needs ``--dataset reddit`` (the
reference's rule), and the CLI builds the fused layouts, as the
reference's does (HAN's baseline ``csr`` layout is ``HGNNConfig(fused=
False)``, in both packages).  It prints the device, then the reference's
line

  han/imdb [na=gat/stacked +fused-sa] logits (4278, 8) on single-device: ... ms/iter
  han/imdb [na=gat/stacked +partitions=4] logits (4278, 8) on single-device: ... ms/iter
  han/imdb [na=gat/bucketed] logits (4278, 8) on single-device: ... ms/iter
  rgcn/imdb [na=mean/padded] logits (4278, 8) on single-device: ... ms/iter
  magnn/imdb [na=instance/instances] logits (4278, 8) on single-device: ... ms/iter
  gcn/reddit [na=gcn/csr] logits (23296, 8) on single-device: ... ms/iter

with the time per forward on the host clock, after one warm-up forward,
synchronised with the device, and with residency the reference's counters

  residency: cache_rows=... hits=... misses=... rows=... hit_rate=...

``--partitions K`` (K >= 1) runs HAN, RGCN or MAGNN graph-partitioned
over K partitions on the one device (the fused epilogue is off there, as
in the reference).

``--characterize`` then prints the reference's line for each stage of
the executor's ``stage_records`` (``FP``/``NA``/``SA``/``head``, with
``gather_halo`` after ``FP`` when partitioned, ``L{i}.``-prefixed with
``--layers``)

  FP: flops=... hbm_bytes=... bound=...

and on the card, where the stages are timed, also ``time_us=...
device_us=... DM=...% TB=...% EW=...% DR=...%`` (the device time's shares
by kernel class) and ``OTHER=[...]`` naming any kernel left unclassed; a
``gather_halo`` line ends in ``halo_bytes=...``, and a partitioned run
adds the reference's summary

  partition: k=... cut_ratio=... halo_rows=... halo_bytes=... (xL layers = ... total)

``--fanout K`` (K >= 1) serves instead: ``--requests`` requests of 1 to
``2 * --slot-targets`` target ids drawn with ``default_rng(0)``, through
``HGNNSampler`` and ``HGNNServeEngine`` (``--slots`` slots), after the
per-rung warmup, and prints the reference's lines

  serve han/imdb[ +partitions=K] requests=... targets=... slots=...
      slot_targets=... fanout=... steps=... recompiles=0
      frontier_bytes=... truncated=... rung_hits=0:..;1:.. warmup_ms=...
      wall_ms=... step_ms=...
  resilience: ok=... partial=... failed=... rejected=... shed=...
      retries=... failed_steps=... deadline_expired=... degrade_steps=...
      max_degrade_level=... failovers=...

(``recompiles`` is ``compiles_after_warmup``), the residency line with
``--cache-rows``, and with ``--characterize`` the last step's ``SAMPLE``
record and stage records.  ``--inject-faults SEED`` runs the reference's
seeded chaos schedule through the serve loop; with ``--partitions K``
(K > 1) the schedule also loses partition 0 at step 3, and the engine
fails over to the K - 1 survivors (``failovers=1``; ``recompiles`` then
counts the batches of the new shapes).

``--overlap D`` (D >= 1) declares the async stage-graph schedule: the
forward runs through ``forward_overlapped`` (the stage DAG, ``D`` stage
results in flight; on the card each stage a replayed CUDA graph and
sibling branches on side streams; ``1`` is the serial baseline), the tag gains `` +overlap=D``, and the reference's
line follows the timing line

  overlap: depth=... stages=... edges=... concurrent_pairs=...
      overlapped_stages=... max_inflight=...

(the counters are pure functions of the plan); with ``--fanout`` the
forward stays the serial one and the engine samples the next step on a
worker thread, which adds the line

  prefetch: issued=... hits=... mispredicts=... cold=...

``--mesh-data D`` and/or ``--mesh-model M`` (a missing one is 1) runs
the forward on a ``(data, model)`` device mesh over the default process
group's D * M ranks (``launch/mesh.make_smoke_mesh``): the process group
is initialised from the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; NCCL on the card, gloo
with ``--device cpu``), or, with no such environment and D * M = 1, as a
group of one rank.  :func:`build_hgnn_infer` lays the parameters and the
batch out by the plan's sharding rules (:func:`hgnn_shardings`: FP weights
over ``'model'``, destination-node tables over the ``BATCH`` axes, source
pools replicated) and runs the forward under ``use_mesh``; each kernel
call runs on a rank's shards (``dist.sharding.local``).  On the card the
mesh forward is compiled as the one-device forward is (``graphs.compiled``:
captured once, replayed); a collective in it (``--partitions`` over more
than one rank) is captured with it, which no run on one card exercises.
Rank 0 prints the
reference's line with the mesh in place of ``single-device``:

  han/imdb [na=gat/stacked +fused-sa] logits (4278, 8) on {'data': 2, 'model': 1}: ... ms/iter

Every plan of HAN, RGCN and MAGNN runs on a mesh, with ``--partitions``
(the halo exchange one all-gather over the ``data`` axis when it divides
K), ``--degree-buckets``, ``--layers``, ``--cache-rows`` and
``--overlap`` (the serial forward, as in the reference: no overlap line);
a ``csr`` plan raises the reference's ``ValueError``, and ``--fanout`` is
refused, as the reference's CLI refuses it.  ``--characterize`` on a mesh
prints the stage records of the mesh forward.
"""
from __future__ import annotations

import argparse
import contextlib
import time
import warnings
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import graphs, tree
from repro_torch.configs.base import HGNNConfig
from repro_torch.dist.sharding import (NamedSharding, P, distribute_tree,
                                       named, use_mesh)
from repro_torch.interop import DeviceLike, resolve_device


class BuiltHGNNInfer(NamedTuple):
    fn: Any  # (params, batch) -> logits
    params: Any
    batch: Any
    plan: Any = None  # the StagePlan the executor runs
    executor: Any = None  # StageGraphExecutor


def hgnn_shardings(plan, params: Any, batch: Any, mesh):
    """A plan's declarative sharding tables resolved on ``mesh``: the
    ``NamedSharding`` trees of ``params`` and ``batch``.

    ``plan.param_specs`` / ``plan.batch_specs`` are (key, ndim, logical
    spec) rules (``core/plan.py``): a leaf whose dict path contains
    ``key`` and whose rank is ``ndim`` gets the resolved spec; every other
    leaf (attention vectors, the classifier, feature pools, the host
    integers of a batch) is replicated.  ``mesh`` may be a plain
    description of one (``axis_names`` and ``shape``)."""
    rep = NamedSharding(mesh, P())

    def resolver(rules):
        def fn(path, leaf):
            keys = [k.key for k in path if isinstance(k, tree.DictKey)]
            nd = leaf.dim() if isinstance(leaf, torch.Tensor) else None
            for key, ndim, spec in rules:
                if nd == ndim and key in keys:
                    return named(mesh, leaf.shape, spec)
            return rep
        return fn

    return (tree.map_with_path(resolver(plan.param_specs), params),
            tree.map_with_path(resolver(plan.batch_specs), batch))


def _check_mesh_plan(plan) -> None:
    """The reference's refusal on a mesh (a ``csr`` plan: gather/scatter
    cannot shard), and its CLI's (request-path serving runs single-device
    or graph-partitioned)."""
    if not plan.shards_on_mesh:
        raise ValueError(
            f"sharded HGNN inference needs a padded NA layout, but "
            f"{plan.model}'s plan resolved to 'csr' (gather/scatter cannot "
            "shard): set cfg.fused=True for HAN/RGCN; GCN has no sharded "
            "layout")
    if plan.sample is not None:
        raise ValueError(
            f"{plan.model}: request-path serving (a sampled plan, "
            "cfg.fanout >= 1) runs single-device or graph-partitioned "
            "(--partitions); it does not combine with a device mesh")


def build_hgnn_infer(cfg: HGNNConfig, hg, device: DeviceLike = None,
                     gen: Optional[torch.Generator] = None,
                     mesh=None) -> BuiltHGNNInfer:
    """Plan-driven HGNN inference entry point (default device: the CUDA
    device).  Parameters come from ``gen`` (default: a generator seeded
    with ``cfg.seed``); they are drawn on the CPU, so every device gets the
    same model.

    The paper's finding (FP is dense DM-Type, NA irregular TB-Type, SA
    EW-Type) is the partitioning strategy on a ``mesh``: FP shards its
    projection over ``'model'``, padded NA shards destination nodes over
    the batch axes with a replicated source pool, SA rides the NA layout.
    With a mesh (one with a ``DeviceMesh``, ``launch/mesh``) the
    parameters and the batch are laid out by :func:`hgnn_shardings` (the
    same full tensors on every rank, each keeping its shard) and ``fn``
    runs the forward under ``use_mesh``, returning the logits as a DTensor.
    Every plan but a ``csr`` one (refused, as in the reference) and a
    sampled one (refused, as the reference's CLI refuses it) runs there:
    the stacked, bucketed and padded layouts, MAGNN's instances, hidden
    layers, residency, partitioned plans (``gather_halo`` by
    ``plan.partition.halo``), and a plan with a schedule as the serial
    forward, as in the reference.  With ``mesh=None`` this is the
    one-device path, bit for bit.  On the card ``fn`` is compiled
    (``graphs.compiled``, the reference's ``jax.jit``; the prepared batch
    and the parameters held, DTensors on a mesh through their local
    tensors; ``fn.fn`` is the eager forward), but for a plan with an async
    schedule off a mesh: ``fn`` is then ``forward_overlapped`` itself, as
    in the reference, which compiles each stage (one CUDA graph a stage
    key on the card)."""
    from repro_torch.core.models import get_model

    dev = resolve_device(device)
    model = get_model(cfg)
    plan = model.plan()
    if cfg.fuse_na_sa and not plan.sa.fuse_epilogue:
        warnings.warn(
            f"fuse_na_sa requested but {plan.model}'s NA layout "
            f"({plan.na.layout!r}) does not support the NA→SA epilogue "
            "(stacked only); running two-pass SA", stacklevel=2)
    if mesh is not None:
        _check_mesh_plan(plan)
    batch = model.prepare(hg, dev)
    if gen is None:
        gen = torch.Generator().manual_seed(cfg.seed)
    params = model.init(gen, batch)
    if mesh is None:
        # an async schedule serves the overlapped dispatcher (bitwise the
        # serial forward), which compiles each of its stages; sampled
        # serving keeps the serial forward, its overlap being the engine's
        # sampler prefetch, as in the reference.  The serial forward on the
        # card is compiled (the reference's jax.jit): one CUDA graph a
        # signature, the batch held
        if plan.schedule is not None and plan.sample is None:
            fn = model.executor.forward_overlapped
        elif dev.type == "cuda":
            fn = graphs.compiled(model.forward)
        else:
            fn = model.forward
        return BuiltHGNNInfer(fn, params, batch, plan, model.executor)

    def fn(p, b):
        with use_mesh(mesh):
            return model.forward(p, b)

    p_sh, b_sh = hgnn_shardings(plan, params, batch, mesh)
    params = distribute_tree(params, p_sh)
    batch = distribute_tree(batch, b_sh)
    if dev.type == "cuda":  # the reference's jax.jit(fn) on the mesh
        fn = graphs.compiled(fn)
    return BuiltHGNNInfer(fn, params, batch, plan, model.executor)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_fault_injector(args, part) -> Any:
    """``--inject-faults SEED`` -> the chaos-smoke schedule: two transient
    sampler faults + one transient forward fault (absorbed by retries), one
    persistent sampler fault (fails the step's requests), injected latency
    on three steps (drives the degradation ladder when --slo-ms is set),
    and — partitioned runs only — one partition loss at step 3 (failover
    re-partitions over the survivors).  Deterministic per seed."""
    from repro_torch.serve.faults import FaultInjector

    return FaultInjector.seeded(
        seed=args.inject_faults, n_steps=max(args.requests, 8),
        sampler=2, forward=1, persistent_sampler=1, latency_steps=3,
        latency_s=(args.slo_ms or 50.0) / 250.0,
        partition_loss_step=3 if part is not None and part.k > 1 else None,
        partition=0)


def request_queue(n_t: int, slot_targets: int, n_requests: int,
                  pool: Optional[int] = None, seed: int = 0) -> list:
    """The serve CLI's request queue: ``n_requests`` requests of 1 to
    ``2 * slot_targets`` target ids drawn with ``default_rng(seed)``
    below ``n_t`` (below ``min(pool, n_t)`` with ``pool``, as the
    reference's chaos bench draws)."""
    import numpy as np

    from repro_torch.serve.engine import HGNNRequest

    rng = np.random.default_rng(seed)
    hi = n_t if pool is None else min(pool, n_t)
    return [HGNNRequest(targets=rng.integers(
        0, hi, size=int(rng.integers(1, 2 * slot_targets + 1))))
        for _ in range(n_requests)]


def run_hgnn_serve(args, cfg: HGNNConfig, hg, built: BuiltHGNNInfer):
    """Request-path serving: neighbor-sampled minibatches through the
    slot-based continuous-batching engine (``--fanout >= 1``).  Returns
    the engine and its requests."""
    from repro_torch.serve.engine import HGNNServeEngine
    from repro_torch.serve.resilience import ResilienceConfig
    from repro_torch.serve.sampler import HGNNSampler

    sampler = HGNNSampler(built.plan, cfg, hg)
    part = built.plan.partition
    res = ResilienceConfig(max_queue=args.max_queue,
                           deadline_ms=args.deadline_ms,
                           slo_ms=args.slo_ms,
                           slo_signal=args.slo_signal)
    injector = (build_fault_injector(args, part)
                if args.inject_faults is not None else None)
    engine = HGNNServeEngine(built.executor, built.params, sampler,
                             slots=args.slots,
                             slot_targets=args.slot_targets, fn=built.fn,
                             resilience_cfg=res, injector=injector)
    reqs = request_queue(sampler.n_target_type, args.slot_targets,
                         args.requests)
    n_targets = sum(len(r.targets) for r in reqs)
    t0 = time.time()
    engine.warmup()
    warm = time.time() - t0
    t0 = time.time()
    engine.serve(reqs)
    dt = time.time() - t0
    st = engine.stats()
    rungs = ";".join(f"{i}:{n}" for i, n in st["rung_hits"].items())
    print(f"serve {cfg.model}/{cfg.dataset}"
          f"{f' +partitions={part.k}' if part is not None else ''} "
          f"requests={len(reqs)} targets={n_targets} slots={args.slots} "
          f"slot_targets={args.slot_targets} fanout={cfg.fanout} "
          f"steps={st['steps']} recompiles={st['compiles_after_warmup']} "
          f"frontier_bytes={st['frontier_bytes']:.0f} "
          f"truncated={st['truncated_rows']} rung_hits={rungs} "
          f"warmup_ms={warm*1e3:.2f} wall_ms={dt*1e3:.2f} "
          f"step_ms={st['wall_mean_ms']:.3f}")
    rs = st["resilience"]
    print(f"  resilience: ok={rs['ok_requests']} "
          f"partial={rs['partial_requests']} failed={rs['failed_requests']} "
          f"rejected={rs['rejected']} shed={rs['shed']} "
          f"retries={rs['retries']} failed_steps={rs['failed_steps']} "
          f"deadline_expired={rs['deadline_expired']} "
          f"degrade_steps={rs['degrade_steps']} "
          f"max_degrade_level={rs['max_degrade_level']} "
          f"failovers={rs['partition_failovers']}")
    if "prefetch" in st:
        pf = st["prefetch"]
        print(f"  prefetch: issued={pf['issued']} hits={pf['hits']} "
              f"mispredicts={pf['mispredicts']} cold={pf['cold']}")
    if "residency" in st:
        rd = st["residency"]
        print(f"  residency: cache_rows={rd['cache_rows']} "
              f"hits={rd['hits']} misses={rd['misses']} rows={rd['rows']} "
              f"hit_rate={rd['hit_rate']:.3f} evictions={rd['evictions']}")
    if args.characterize:
        sb = engine.last_sb
        # the batch as the forward ran it (partitioned under --partitions)
        recs = built.executor.stage_records(
            built.params, engine.place(engine._forward_batch(sb.batch)),
            sample_meta=sb.meta)
        sm = recs["stages"]["SAMPLE"]
        print(f"  SAMPLE: rung={sm['rung']} n_targets={sm['n_targets']} "
              f"frontier_rows={sm['frontier_rows']} "
              f"frontier_bytes={sm['frontier_bytes']:.3g} "
              f"index_bytes={sm['index_bytes']:.3g}")
        for stage, rec in recs["stages"].items():
            if stage != "SAMPLE":
                print(f"  {stage}: {stage_line(rec)}")
    return engine, reqs


@contextlib.contextmanager
def _mesh(args, dev: torch.device):
    """``(device, mesh)`` for ``--hgnn``: with ``--mesh-data`` or
    ``--mesh-model`` given, a ``(data, model)`` mesh (a missing one is 1)
    over the default process group, joined from the ``torchrun``
    environment, else as a group of one rank, and left at the end if
    joined here; the device is ``LOCAL_RANK``'s card.  Without either,
    ``(dev, None)``."""
    import os

    import torch.distributed as dist

    if args.mesh_data is None and args.mesh_model is None:
        yield dev, None
        return
    if args.fanout >= 1:
        raise SystemExit("--fanout serving runs single-device or "
                         "graph-partitioned (--partitions); it does not "
                         "combine with a --mesh-data/--mesh-model mesh")
    from repro_torch.launch.mesh import make_smoke_mesh

    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    created = not dist.is_initialized()
    if created:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    try:
        yield dev, make_smoke_mesh(data=args.mesh_data or 1,
                                   model=args.mesh_model or 1)
    finally:
        if created:
            dist.destroy_process_group()


def run_hgnn(args) -> None:
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.serve.engine import HGNNInferEngine

    if args.hgnn == "gcn" and args.dataset != "reddit":
        raise SystemExit("--hgnn gcn runs the paper's homogeneous GNN "
                         "comparison: use --dataset reddit")
    cfg = HGNNConfig(model=args.hgnn, dataset=args.dataset, fused=True,
                     use_pallas=args.use_pallas,
                     degree_buckets=args.degree_buckets,
                     fuse_na_sa=args.fuse_na_sa,
                     partitions=args.partitions, layers=args.layers,
                     fanout=args.fanout, cache_rows=args.cache_rows,
                     overlap=args.overlap)
    hg = make_dataset(args.dataset)
    with _mesh(args, resolve_device(args.device)) as (dev, mesh):
        built = build_hgnn_infer(cfg, hg, dev, mesh=mesh)
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "host CPU")
        if args.fanout >= 1:
            print(f"device: {dev} ({name})")
            run_hgnn_serve(args, cfg, hg, built)
            return
        engine = HGNNInferEngine(built.executor, built.params, built.batch,
                                 fn=built.fn)
        logits = engine.infer()  # warm-up (builds the kernels on first use)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            logits = engine.infer()
        _sync(dev)
        dt = (time.perf_counter() - t0) / max(args.iters, 1)
        if mesh is not None and torch.distributed.get_rank() != 0:
            return
        print(f"device: {dev} ({name})")
        na = built.plan.na
        part = built.plan.partition
        n_l = built.plan.n_layers
        print(f"{cfg.model}/{cfg.dataset} [na={na.kind}/{na.layout}"
              f"{' +fused-sa' if built.plan.sa.fuse_epilogue else ''}"
              f"{f' +partitions={part.k}' if part is not None else ''}"
              f"{f' x{n_l}layers' if n_l > 1 else ''}"
              f"{f' +overlap={cfg.overlap}' if built.plan.schedule else ''}] "
              f"logits {tuple(logits.shape)} on "
              f"{dict(mesh.shape) if mesh is not None else 'single-device'}: "
              f"{dt*1e3:.2f} ms/iter")
        if built.plan.schedule is not None and mesh is None:
            ov = built.executor.overlap_record()
            d = built.executor.last_dispatch
            print(f"  overlap: depth={ov['depth']} stages={ov['stages']} "
                  f"edges={ov['edges']} "
                  f"concurrent_pairs={ov['concurrent_pairs']} "
                  f"overlapped_stages={ov['overlapped_stages']} "
                  f"max_inflight={d.get('max_inflight', 1)}")
        res = built.batch.get("residency")
        if res is not None:
            ct = res["counters"]
            print(f"  residency: cache_rows={ct['cache_rows']} "
                  f"hits={ct['hits']} misses={ct['misses']} rows={ct['rows']} "
                  f"hit_rate={ct['hits'] / max(ct['rows'], 1):.3f}")
        if args.characterize:
            # one stage_records call gives the stage lines and the partition
            # summary
            with use_mesh(mesh) if mesh is not None else \
                    contextlib.nullcontext():
                recs = built.executor.stage_records(
                    built.params, built.batch, timed=dev.type == "cuda")
            for stage, rec in recs["stages"].items():
                print(f"  {stage}: {stage_line(rec)}")
            if "partition" in recs:
                pt = recs["partition"]
                print(f"  partition: k={pt['k']} "
                      f"cut_ratio={pt['cut_ratio']:.3f} "
                      f"halo_rows={pt['halo_rows']:.0f} "
                      f"halo_bytes={pt['halo_bytes']:.3g} "
                      f"(x{pt['layers']} layers = "
                      f"{pt['halo_bytes_total']:.3g} total)")


def stage_line(rec) -> str:
    """A stage record as the CLI prints it: the reference's FLOPs, bytes
    and bound, then, for a timed record, the stage and device times and
    the device time's shares by kernel class."""
    line = (f"flops={rec['flops']:.3g} hbm_bytes={rec['hbm_bytes']:.3g} "
            f"bound={rec['roofline']['bound']}")
    if "device_us" in rec:
        dev_us = rec["device_us"]
        shares = " ".join(
            f"{c}={100 * rec['device_us_by_class'].get(c, 0.0) / dev_us:.1f}%"
            for c in ("DM", "TB", "EW", "DR")) if dev_us else ""
        line += (f" time_us={rec['time_us']:.1f} device_us={dev_us:.1f} "
                 f"{shares}")
        if rec["other_kernels"]:
            line += f" OTHER={rec['other_kernels']}"
    if "halo_bytes" in rec:
        line += f" halo_bytes={rec['halo_bytes']:.3g}"
    return line


def run_lm(args) -> None:
    import numpy as np

    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.nn.transformer import init_lm_params
    from repro_torch.serve.engine import Request, ServeEngine

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family == "encdec":
        raise SystemExit("serve launcher covers decoder-only archs; "
                         "see examples/serve_decode.py for enc-dec")
    if args.use_pallas:
        cfg = cfg.replace(use_pallas=True)
    params = init_lm_params(torch.Generator(device=dev).manual_seed(0), cfg)
    engine = ServeEngine(cfg, params, batch_slots=args.slots,
                         max_len=args.prompt_len + args.max_tokens)
    rng = np.random.default_rng(0)
    reqs = [
        Request(prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(
            np.int32), max_tokens=args.max_tokens,
            temperature=args.temperature)
        for _ in range(args.requests)
    ]
    t0 = time.time()
    done = engine.generate(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(r.out_tokens) for r in done)
    for i, r in enumerate(done):
        print(f"req{i}: {r.out_tokens}")
    print(f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/max(dt,1e-9):.1f} tok/s)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--hgnn", default=None,
                    choices=["han", "rgcn", "magnn", "gcn"],
                    help="serve an HGNN model instead of an LM (gcn needs "
                         "--dataset reddit)")
    ap.add_argument("--dataset", default="imdb",
                    choices=["imdb", "acm", "dblp", "reddit"])
    ap.add_argument("--use-pallas", action="store_true",
                    help="hand-written CUDA kernels on the hot loop (HGNN: "
                         "gat_na, semantic_combine, segment_spmm, "
                         "cached_gather; LM: flash_attention, "
                         "decode_attention); the csr arms' segment_sum "
                         "runs on the card either way")
    ap.add_argument("--fuse-na-sa", action="store_true",
                    help="fused NA→SA epilogue: SA pass-1 scores accumulate "
                         "inside the NA kernel (stacked layout)")
    ap.add_argument("--degree-buckets", type=int, default=0,
                    help="degree-bucketed padded NA layout with that many "
                         "buckets (HAN metapaths, RGCN relations)")
    ap.add_argument("--partitions", type=int, default=0,
                    help=">=1: graph-partitioned execution over that many "
                         "edge-cut partitions on the one device (HAN "
                         "stacked, RGCN padded, MAGNN), the halo rows "
                         "exchanged by a gather_halo stage a layer")
    ap.add_argument("--cache-rows", type=int, default=0,
                    help="hot-feature residency: keep that many hot rows per "
                         "node type in a cache section of the gather pool")
    ap.add_argument("--layers", type=int, default=1,
                    help="stack that many FP->NA->SA layers")
    ap.add_argument("--overlap", type=int, default=0,
                    help=">=1: async stage-graph schedule with that "
                         "in-flight stage depth: the halo exchange beside "
                         "the owned-rows NA, one NA stage a metapath, side "
                         "streams on the card, and serving samples the "
                         "next step while the device computes (1 = the "
                         "serial baseline)")
    ap.add_argument("--fanout", type=int, default=0,
                    help=">=1: request-path serving — neighbor-sampled "
                         "minibatch inference (per-hop fan-out cap) through "
                         "the slot-based continuous-batching engine; "
                         "--requests/--slots/--slot-targets size the queue")
    ap.add_argument("--slot-targets", type=int, default=4,
                    help="target vertices each slot contributes per serving "
                         "step (HGNN serving mode)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline: expired requests complete "
                         "PARTIAL with the rows served so far")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-step SLO target: walls breaching it drive the "
                         "degradation ladder (smaller chunks + smaller "
                         "warmed rungs; restores when pressure drops)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission bound: requests beyond this queue depth "
                         "are shed (status REJECTED)")
    ap.add_argument("--inject-faults", type=int, default=None,
                    help="seed a deterministic fault schedule (transient + "
                         "persistent sampler/forward faults, injected "
                         "latency) through the serve loop")
    ap.add_argument("--slo-signal", choices=("observed", "injected"),
                    default="observed",
                    help="wall feeding the SLO comparison: 'observed' = real "
                         "step wall + injected latency; 'injected' = the "
                         "fault schedule's latency alone (replayable)")
    ap.add_argument("--characterize", action="store_true",
                    help="print the per-stage FLOPs/bytes/roofline records "
                         "(and, on the card, stage and device times by "
                         "kernel class)")
    ap.add_argument("--mesh-data", type=int, default=None,
                    help="--hgnn on a (data, model) device mesh: its data "
                         "axis (the default process group's ranks)")
    ap.add_argument("--mesh-model", type=int, default=None,
                    help="the mesh's model axis")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions on the CPU)")
    args = ap.parse_args()
    if args.hgnn:
        run_hgnn(args)
        return
    run_lm(args)


if __name__ == "__main__":
    main()
