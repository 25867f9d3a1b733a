#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc`` (``nvcc``, at first use), holds each kernel against its plain
PyTorch version at the shapes of the main paths, drives the main paths
through ``build_hgnn_infer`` and ``HGNNInferEngine`` at full width —
HAN full-graph inference on synthetic IMDB (hidden 64, 8 heads, K = 64,
4278 target rows) for 1 and 2 layers with the fused NA→SA epilogue on and
off, and RGCN full-graph inference on synthetic IMDB (hidden 64, K = 64,
every relation) for 1 and 2 layers on the padded and the 3-bucket layouts,
plus one RGCN forward on synthetic DBLP, and MAGNN full-graph inference on
synthetic IMDB (hidden 64, 8 heads, 16 instances a target, metapaths MDM
and MAM) for 1 and 2 layers with and without hot-feature residency (256
rows a type), plus HAN and RGCN with residency; HAN on synthetic IMDB in
its baseline ``csr`` layout (separate SDDMM, segment max, segment softmax
and SpMM, whose sums are the fixed-order ``segment_sum`` kernel) and its
3-bucket layout (one unstacked ``gat_na`` launch a degree bucket), for 1
and 2 layers, with and without residency, and the paper's Fig. 5c (HAN's
NA device time by layout); GCN on the synthetic Reddit-like graph (602
features, hidden 64) at the CLI's scale 0.1 for 1 and 2 layers, with and
without residency, and one forward at the paper's 232,965 nodes — and LM
serving of
granite-8b: the prefill and decode kernels against their plain versions at
the granite and h2o-danube shapes, granite at full width and 2 layers in
fp32 (kernel arm against plain arm, teacher-forced), and the full 36-layer
bf16 granite through ``ServeEngine.generate`` (4 prompts of 2048 tokens,
32 greedy tokens each, twice).  It checks the logits (the kernel arm
against the plain arm, cached against uncached bitwise, two runs bitwise
on the new paths) and the kernels' launch counts, and times every kernel
beside its bound (the work formulas beside the kernels' wrappers, held to
the numbers they gave before they moved there).  Phase 3l is the
paper's characterization on this card: per-stage records through
``HGNNInferEngine.characterize(timed=True)`` for HAN/imdb's baseline and
optimized plans, RGCN/imdb's and MAGNN/imdb's baselines, MAGNN/imdb with
residency and GCN/Reddit, the FLOPs and bytes held equal to the CPU's
records, every device kernel in a class, each stage's wall its CUDA
graph's replay printed beside the eager stage's, the replay's kernels
held to the eager stage's.  Phase 3m is request-path
serving: ``HGNNSampler`` and ``HGNNServeEngine`` serve 32 requests of the
CLI's queue (fan-out 8, 8 slots of 4 targets) for HAN/imdb through the
``gat_na`` epilogue and ``semantic_combine``, RGCN/imdb on rung-padded
degree buckets, MAGNN/imdb and GCN/Reddit 0.1, each held against the same
queue served on the CPU by the plain arm, with exact launch counts, no
failed step or retry, nothing made after warmup, and each kernel call of a
served step against its plain version; an identity-rung serve of all 4278
HAN/imdb targets is bitwise the full-graph forward, and a seeded chaos
serve's counters equal ``BENCH_hgnn.json``'s.  Phase 3p is graph-partitioned
execution: HAN/imdb and RGCN/imdb for L ∈ {1, 2} and MAGNN/imdb at full
width over K ∈ {1, 2, 4} partitions through the same kernels (one stacked
``gat_na`` a partition, one ``segment_spmm`` a relation and partition, one
unstacked ``gat_na`` a metapath), with exact launches, K = 1 bitwise the
unpartitioned kernel arm for every K, the CPU's plain arm on the same
partitioned batch, partitioned residency bitwise;
``bench_partition.py``'s sweep (counters equal ``BENCH_hgnn.json``'s
``partition`` and ``layers/*/halo`` rows, NA and ``gather_halo`` timed)
and ``bench_resilience.py``'s failover serve (its row reproduced, bitwise
the never-failed serve).  Phase 3o is the async stage-graph schedule:
``bench_overlap.py``'s cases (HAN/imdb on 3 degree buckets, MAGNN/imdb,
HAN/imdb and RGCN/imdb at K = 4 and L = 2) and HAN/imdb ``csr`` through
``forward_overlapped`` (each stage a CUDA graph replayed, one a stage key
of the reference's; sibling stages captured on capture streams of their
own and replayed on side streams), bitwise the serial kernel arm with the
same launches and ``BENCH_hgnn.json``'s ``overlap`` counters, no capture
and no scratch after the first forward, the eager walk bitwise too; the
forward walls of the eager and the captured overlapped and serial
forwards in turns, the stage walls' critical path, the kernels that
overlap in a profiled captured and eager forward; then the
sampler-prefetch serves (HAN/imdb, RGCN/imdb, the failover serve) bitwise
the serves without it.  Phase 6 is LM training of smollm-360m: the
embedding's gradient through ``segment_sum`` bitwise its CPU version and
the chunked attention's backward against the CPU at smollm's shapes; the
model at full width with 2 layers in fp32, its gradients and one
``make_train_step`` step against the CPU, the three remat modes bitwise,
checkpoints bitwise; then the full 32-layer bf16 model through
``launch.train``'s step (seq 2048, global batch 8 as 2 microbatches):
a falling loss on a repeated batch, two runs bitwise, exact
``segment_sum`` launches, step ms, tokens/s, model TFLOP/s, peak memory
and a profiled step.  Phase 7 is the MoE, SSM and hybrid LM families:
phi3.5-moe and zamba2 at full width with 2 layers in fp32, the kernel arm
against the plain arm teacher-forced (2 x 1536 prompts, 8 steps; exact
``flash_attention`` / ``decode_attention`` launches), mamba2-2.7b with 2
layers on the card against the CPU; then mamba2-2.7b and zamba2-1.2b
whole and phi3.5-moe at full width with 24 of its 32 layers, bf16,
through ``ServeEngine.generate`` (4 prompts of 2048 tokens, 32 greedy
tokens, twice, bitwise, exact launches), with prefill and decode times,
peak memory, a profiled prefill and decode step, and one zamba2 wave
sampled at temperature 0.7 twice from one seed.  Phase 5e serves
h2o-danube3-4b whole past its 4096-token window (4 prompts of 4608
tokens: the ring cache wraps).  Phase 8 is the VLM and encoder-decoder
families: internvl2-76b (256 frontend embeddings before the tokens) and
seamless-m4t-medium (an encoder over 1024 audio frames, a decoder with
cross-attention, the ``flash_attention`` kernel's cross form) at full
width with 2 (+ 2) layers in fp32, the kernel arm against the plain arm
(seamless also prefill + 253 teacher-forced decode steps against the
forward); then internvl2-76b with 32 of its 80 layers and
seamless-m4t-medium whole, bf16: a wave of 4 (256 embeddings + 1024
tokens, 32 greedy tokens; 1024 frames, a 2-token prefix, 64 greedy
tokens) twice, bitwise, exact launches, prefill and decode times, peak
memory, the plain arm teacher-forced on the served tokens (its logit
difference recorded), a profiled prefill and decode step.  Phase 5 holds
both kernels at every shape phases 5e, 7b and 8b serve.  Phase 9 is the
device mesh: a 1-rank NCCL process group and a ``(data=1, model=1)``
mesh, HAN/imdb through ``build_hgnn_infer(mesh=...)`` (9a) and granite-8b
whole through ``launch/steps``' prefill and decode steps (9b, 4 x 2048
tokens and 32 greedy steps) bitwise the mesh-less paths with the same
launches, each timed beside them; every other padded HGNN plan at full
IMDB width on the same mesh (9d: HAN bucketed and at 2 layers, RGCN
padded and bucketed, MAGNN, HAN/RGCN/MAGNN partitioned at K = 4, MAGNN
with 256 hot rows, HAN with the async schedule), each bitwise with the
mesh-less launches and no collective, timed in turns; the decode
kernel's log-sum-exp form against its plain version and a cache split
into 2 and 4 shards combined against the whole-cache kernel (9e); then
the granite-8b dry run on the 16x16 production mesh over the fake
process group (9c, a subprocess a shape, no device memory).  Phase 10,
elastic restart on a 1-rank NCCL mesh: smollm-360m at full width trained
on the mesh from ``reshard_state(state, state_shardings(...))`` bitwise
the mesh-less step (10a), checkpointed from the mesh, restored with
``restore(shardings=)`` onto a fresh mesh and trained on bitwise an
uninterrupted run (10b), HAN/imdb partitioned in two served with its
parameters replicated on a ``(pod, data, model)`` mesh and on the mesh
``surviving_mesh`` collapses it to, bitwise with the same launches
(10c), and ``launch/train.py --distributed`` under ``torchrun`` giving
the single process's losses (10d).  Phase 11 is the compiled step
(``graphs.compiled``, the port's counterpart of the reference's
``jax.jit``): the engines and ``build_hgnn_infer`` replay a CUDA graph
captured once a signature in every phase above (``forward_overlapped``
and the characterization's stages a graph a stage, phases 3o and 3l;
phases 6c, 9 and 10 hold their eager gates on the eager arms, ``fn.fn``
and ``jit_step(...).fn``), with the launch counts of a replay
added back, so every exact launch check holds; the first replay of every
graph is traced and its device kernels, mapped to the wrapper counters,
must be what it adds (``measured_card``); HAN fused, RGCN padded,
MAGNN and GCN/Reddit 0.1 forwards at L = 1 and 2 bitwise the eager
``fn=model.forward`` engine, walls of both in turns and a profiled
captured forward; phase 3m's 1024-request serves by the eager engine in
turns with the captured ones (logits bitwise, one capture a rung, the
upload pageable against pinned); phase 3p's failover serve (one
capture a rung and K, bitwise the eager serve); granite-8b's decode in
phase 5c (tokens and every decode step's logits bitwise an eager
``lm_decode_step`` loop, ms a step of both in turns, busy shares); the
family serves of phases 7b and 8b run captured; 11m, beside phase 9
on its mesh: 9a's HAN/imdb forward and 9d's ten plans captured on the
mesh (``captured_mesh``: bitwise the eager mesh forward, one capture with
no collective, the replays' launches traced), granite-8b's prefill and
32 decode steps through the compiled ``jit_step`` (tokens and logits
bitwise the eager mesh wave, the caches donated), walls of both;
11t, beside phases 6c and 10a: smollm-360m's compiled step with the
state donated, mesh-less through ``launch/train.setup`` and on the mesh
through ``jit_step`` (``captured_train``: loss, grad_norm and every
state leaf bitwise the eager steps, the same tensors back from every
call, one capture, ms a step and peak memory).  It imports nothing of
jax or of the JAX package ``repro``.

Output: progress lines, then the card's name and power limit as
``nvidia-smi`` prints them, a ``{"kernels": [...]}`` JSON line, and as the
last line ``{"ok": true, "device": {...}}``.  It exits non-zero, with no
result line, when there is no CUDA device, when the port is not beside it,
or when any phase fails.
"""
from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # TF32 on the tensor cores
ITERS = 3  # infer() calls per main-path configuration
TOL_Z = dict(atol=1e-5, rtol=1e-5)  # per-slot online vs one-shot softmax
TOL_W = dict(atol=1e-4, rtol=1e-4)  # 4278 row scores summed in another order
TOL_LOGITS = dict(atol=1e-5, rtol=1e-5)  # kernel arm vs plain arm, one card
TOL_CPU = dict(atol=1e-4, rtol=1e-4)  # card vs CPU: FP sums F=3066 differently
TOL_SPMM = dict(atol=1e-5, rtol=1e-5)  # slot order vs the plain sum's order
# fused_fp_na: F = 3066 products accumulated on the tensor cores in 3xTF32
# (about fp32's precision), against the plain aggregate-then-matmul and the
# executor's matmul-then-aggregate
TOL_FFN = dict(atol=1e-5, rtol=1e-5)
# semantic_scores: the zW products with FMA in feature order, the row
# scores summed per block then over blocks, against the matmul and mean
TOL_SCORES = dict(atol=1e-5, rtol=1e-5)
CACHE_ROWS = 256  # hot rows a node type on the residency paths
# (bytes, operations[, TF32 operations]) of each kernels-line entry's
# bound as this script reckoned them on an H100 before its formulas moved
# beside the kernels (``work(..., live_only=True)``): the inputs are made
# from seeds, so the moved formulas must give the same numbers
BOUND_WORK = {
    "gat_na": (7667200, 40767824), "gat_na_fused_sa": (7701000, 185886140),
    "semantic_combine": (3285512, 821376),
    "segment_spmm": (10954476, 5210880),
    "fused_fp_na": (29705028, 29957886, 2450052864),
    "cached_gather": (110692352, 0), "gat_na_unstacked": (21958656, 21214880),
    "semantic_scores": (2224136, 143475564),
    "segment_sum": (30432736, 149532416),
    "gat_na_bucketed": (9725312, 41157968),
    "flash_attention": (167772160, 137506062336),
    "decode_attention": (21078032, 84049920),
}

failures: list = []


def fail_now(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, what: str) -> bool:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        failures.append(what)
    return ok


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail_now(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def close(a, b, atol, rtol) -> bool:
    import torch

    return bool(torch.allclose(a, b, atol=atol, rtol=rtol))


def time_ms(fn, reps: int, flush=None) -> float:
    """Median device time of one call, by CUDA events around each call.
    A device-side sleep before the start event keeps the device busy while
    the host enqueues the call, so the host's launch cost stays out of the
    number.  With ``flush`` (a 64 MB buffer) the 50 MB L2 is evicted before
    each call by reading it, which leaves no dirty lines behind."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    host_s = (time.perf_counter() - t0) / 5
    torch.cuda.synchronize()
    cycles = int((3 * host_s + 50e-6) * 2e9)  # SM clock below 2 GHz
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.sum()
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def wall_ms(engine, reps: int = 20) -> float:
    """Host-clock ms per infer() over back-to-back forwards, synchronised
    at the end: what a caller of the engine waits per forward."""
    import torch

    for _ in range(3):
        engine.infer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.infer()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def profile_forward(engine, tag: str, reps: int = 10, warmup: int = 3
                    ) -> dict:
    """Device time by kernel over ``reps`` forwards (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        engine.infer()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.infer()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    # device-side events only: a CPU op such as aten::mm also carries the
    # device time of the kernels it launched, which would count them twice
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in rows) / reps / 1e3
    print(f"  profile {tag}: wall {wall:.4f} ms/forward under the profiler, "
          f"kernels {busy:.4f} ms/forward ({100 * busy / wall:.1f}% of it)")
    for e in rows[:10]:
        print(f"    {e.self_device_time_total / reps / 1e3:.5f} ms/forward "
              f"x{e.count // reps}  {e.key[:90]}")
    return {"wall_ms": wall, "device_busy_ms": busy,
            "top": [(e.key[:90], e.self_device_time_total / reps / 1e3,
                     e.count / reps) for e in rows[:10]]}


def eager(built):
    """``build_hgnn_infer``'s result with its eager forward: a forward
    compiled on the card (``graphs.Compiled``) gives way to ``fn.fn``.
    The kernel calls of one forward are recorded, and a mesh forward is
    compared, on it."""
    from repro_torch import graphs

    if isinstance(built.fn, graphs.Compiled):
        return built._replace(fn=built.fn.fn)
    return built


def to_device(tree, device):
    """A parameter or batch tree (dicts, also tuple-keyed, lists, tuples)
    with every tensor moved to ``device``."""
    import torch

    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


def bound(n_bytes: float, n_ops: float, peak_flops: float = PEAK_FP32_FLOPS,
          tf32_ops: float = 0.0):
    """The least time (ms) for the work, and what sets it: the bytes at the
    memory rate, or the operations at the peak of their type (``n_ops`` at
    ``peak_flops``, plus ``tf32_ops`` on the tensor cores in TF32)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (n_ops / peak_flops + tf32_ops / PEAK_TF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")



LEAD_IN = 64  # lead-in kernels a profile starts with (a late trace drops
# its first events: 36 of a granite decode step late in a run)
# the host calls that put one event each on the card's queue
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy",
                "cudaMemset")


def traced_call(fn):
    """One call of ``fn`` under torch.profiler, between ``LEAD_IN``
    lead-in kernels (``torch.cuda._sleep``, named ``spin_kernel``), waited
    for, and one tail kernel: ``(the trace's device events in time order,
    the launch and copy calls made on the host, the indices of the spin
    kernels in the events)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
    evs = prof.events()
    names = [e.name for e in sorted(
        (e for e in evs if e.device_type == DeviceType.CUDA),
        key=lambda e: e.time_range.start)]
    calls = sum(1 for e in evs if e.device_type != DeviceType.CUDA
                and e.name.startswith(LAUNCH_CALLS))
    spins = [i for i, n in enumerate(names) if "spin_kernel" in n]
    return names, calls, spins


def device_kernels(fn, whole: bool = False):
    """Names of the device kernels (and copies) that one call of ``fn``
    runs, in time order, by torch.profiler, after a warm-up call.  The
    device trace can start late and drop the first events after the
    profiler is switched on, so each profile first runs ``LEAD_IN``
    lead-in kernels (``torch.cuda._sleep``, named ``spin_kernel``) and
    waits for them, then calls ``fn``, then runs one more and waits: the
    answer is the device events between the last lead-in that the trace
    kept and that tail.  A profile that lost every lead-in or the tail, or
    holds nothing between them (a call runs at least one kernel), is a
    failed trace, not an answer: it is taken again, up to three times, and
    the last one's events are returned.  With ``whole``, a trace that
    holds fewer events of the call than the call made launch and copy
    calls on the host fails too, and the answer is ``(names, whether the
    last trace was whole)``."""
    import torch

    fn()
    torch.cuda.synchronize()
    ok = False
    for attempt in range(3):
        names, calls, spins = traced_call(fn)
        ok = (len(spins) >= 2 and spins[-1] == len(names) - 1
              and spins[-1] - spins[-2] > 1)
        # the call's own events against the call's own launches (the
        # lead-ins and the tail made LEAD_IN + 1 of the calls)
        if ok and (not whole
                   or spins[-1] - spins[-2] - 1 >= calls - LEAD_IN - 1):
            names = names[spins[-2] + 1:spins[-1]]
            break
        ok = False
        print(f"  (profile {attempt + 1} lacks a lead-in, the tail or the "
              f"call{', or events' if whole else ''}: {len(names)} device "
              f"events for {calls} launch and copy calls, lead-in and tail "
              f"at {spins[:2]}..{spins[-1:]}; again)")
    return (names, ok) if whole else names


def bucket_times(h_src, nbr, mask, flush) -> list:
    """``segment_spmm`` timed on each degree bucket of one relation (the
    bucketed layout's own launches, ``bucket_padded`` with 3 buckets, as
    RGCN's ``prepare`` builds them): which rows set the padded launch's
    time."""
    import torch
    from repro_torch.core import metapath as mp
    from repro_torch.kernels import segment_spmm as tspmm

    bk = mp.bucket_padded(mp.PaddedSubgraph(nbr.cpu().numpy(),
                                            mask.cpu().numpy(), []), 3)
    out = []
    for b_nbr, b_mask in zip(bk.nbr, bk.mask):
        b_nbr = torch.as_tensor(b_nbr, device=nbr.device)
        b_mask = torch.as_tensor(b_mask, device=nbr.device)
        out.append({
            "k": b_nbr.shape[1], "rows": b_nbr.shape[0],
            "live": int((b_mask != 0).sum()),
            "ms": time_ms(lambda: tspmm.segment_spmm(h_src, b_nbr, b_mask),
                          50, flush),
            "warm_ms": time_ms(lambda: tspmm.segment_spmm(h_src, b_nbr,
                                                          b_mask), 50)})
    return out


def mean_csr(nbr, mask, n_src: int):
    """The CSR matrix ``S`` of mean weights ``mask / max(deg, 1)``, so that
    ``S @ h_src`` is ``segment_spmm(h_src, nbr, mask)``: the library
    call's operand, built once before timing."""
    import torch

    n, k = nbr.shape
    w = mask / torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    live = mask != 0
    rows = torch.arange(n, device=nbr.device)[:, None].expand(n, k)[live]
    s = torch.sparse_coo_tensor(torch.stack([rows, nbr[live].long()]),
                                w[live], (n, n_src)).coalesce()
    return s.to_sparse_csr()


def rgcn_kernels_vs_plain(built, results: dict):
    """Phase 2 for RGCN/imdb: ``segment_spmm`` against its plain version on
    each relation of layer 0 (mean on and off, deterministic, bitwise equal
    to its emulation), with weighted masks and all-masked rows; then
    ``fused_fp_na`` at the ``(M, md, D)`` relation against its plain
    version and against ``segment_spmm(x_M @ W)``.  Returns the timing
    inputs: ``[(key, h_src, nbr, mask)]`` and ``(x, W, nbr, mask)``."""
    import numpy as np
    import torch
    from repro_torch.kernels import fused_fp_na as tffn
    from repro_torch.kernels import segment_spmm as tspmm

    params, batch = built.params, built.batch
    errs = []
    with torch.inference_mode():
        h = built.executor.fp(params, batch)  # every type's [N_t, 64]
        rels = [(key, h[key[0]], *batch["rels"][key])
                for key in sorted(batch["rels"])]
        for key, h_src, nbr, mask in rels:
            tag = "|".join(key)
            live = mask != 0
            deg = live.sum(dim=1)
            print(f"  segment_spmm {tag}: h_src {tuple(h_src.shape)} nbr/mask "
                  f"{tuple(nbr.shape)}; live slots {int(live.sum())} of "
                  f"{mask.numel()}, rows at the cap "
                  f"{int((deg == nbr.shape[1]).sum())}")
            for mean in (True, False):
                out = tspmm.segment_spmm(h_src, nbr, mask, mean=mean)
                want = tspmm.segment_spmm_plain(h_src, nbr, mask, mean=mean)
                torch.cuda.synchronize()
                errs.append(max_err(out, want))
                check(close(out, want, **TOL_SPMM),
                      f"segment_spmm {tag} mean={mean} vs plain: max |err| "
                      f"{errs[-1]:.3e} (tol {TOL_SPMM})")
            out = tspmm.segment_spmm(h_src, nbr, mask)
            check(torch.equal(out, tspmm.segment_spmm(h_src, nbr, mask)),
                  f"segment_spmm {tag}: two runs give the same bits")
            check(torch.equal(out, tspmm.segment_spmm_emulate(h_src, nbr,
                                                              mask)),
                  f"segment_spmm {tag}: bitwise equal to its emulation")
        names = device_kernels(lambda: tspmm.segment_spmm(*rels[0][1:]))
        check(len(names) == 1 and "segment_spmm_kernel" in names[0],
              f"segment_spmm: one device kernel a call ({names})")
        # real weights in the mask and every fifth row all-masked, on the
        # relation with the most destination rows
        key, h_src, nbr, mask = max(rels, key=lambda r: r[2].shape[0])
        weights = torch.as_tensor(
            np.random.default_rng(0).random(mask.shape) * 2.0,
            dtype=torch.float32, device=mask.device)
        dead = mask * weights
        dead[::5] = 0.0
        for mean in (True, False):
            out = tspmm.segment_spmm(h_src, nbr, dead, mean=mean)
            want = tspmm.segment_spmm_plain(h_src, nbr, dead, mean=mean)
            torch.cuda.synchronize()
            errs.append(max_err(out, want))
            check(close(out, want, **TOL_SPMM),
                  f"segment_spmm {'|'.join(key)} weighted mask mean={mean} "
                  f"vs plain: max |err| {errs[-1]:.3e}")
            check(bool((out[::5] == 0).all()),
                  f"segment_spmm mean={mean}: all-masked rows exactly 0")
        results["segment_spmm"] = {"max_abs_err": max(errs),
                                   "tolerance": TOL_SPMM}

        # fused FP + NA at the (M, md, D) relation: x_M [4278, 3066],
        # layer-0 fp["M"] [3066, 64], nbr/mask [2081, 64]
        nbr, mask = batch["rels"][("M", "md", "D")]
        x, w = batch["feats"]["M"], params["fp"]["M"]
        print(f"  fused_fp_na M|md|D: x {tuple(x.shape)} W {tuple(w.shape)} "
              f"nbr/mask {tuple(nbr.shape)}")
        errs = []
        for mean in (True, False):
            out = tffn.fused_fp_na(x, w, nbr, mask, mean=mean)
            want = tffn.fused_fp_na_plain(x, w, nbr, mask, mean=mean)
            torch.cuda.synchronize()
            errs.append(max_err(out, want))
            check(close(out, want, **TOL_FFN),
                  f"fused_fp_na mean={mean} vs plain: max |err| "
                  f"{errs[-1]:.3e} (tol {TOL_FFN}; |out| <= "
                  f"{float(out.abs().max()):.3f})")
        out = tffn.fused_fp_na(x, w, nbr, mask)
        order = tspmm.segment_spmm(x @ w, nbr, mask)
        err_o = max_err(out, order)
        check(close(out, order, **TOL_FFN),
              f"fused_fp_na vs segment_spmm(x @ W), the executor's FP-then-NA "
              f"order: max |err| {err_o:.3e}")
        check(torch.equal(out, tffn.fused_fp_na(x, w, nbr, mask)),
              "fused_fp_na: two runs give the same bits")
        dead = mask.clone()
        dead[::5] = 0.0
        check(bool((tffn.fused_fp_na(x, w, nbr, dead)[::5] == 0).all()),
              "fused_fp_na: all-masked rows exactly 0")
        results["fused_fp_na"] = {"max_abs_err": max(errs),
                                  "vs_fp_then_na_max_abs_err": err_o,
                                  "tolerance": TOL_FFN}
    return rels, (x, w, nbr, mask)


def magnn_kernels_vs_plain(built, results: dict):
    """Phase 2 for MAGNN/imdb with residency: ``cached_gather`` at each of
    the six instance positions of a layer, bitwise against its plain
    version and its emulation; the unstacked ``gat_na`` at both metapaths
    against plain (all-masked rows exactly 0); ``semantic_scores`` on the
    stacked NA output against plain and against a second run.  Returns the
    timing inputs: the six gathers ``[(tag, table, hot, idx)]``, the two
    ``gat_na`` calls ``{metapath: args}`` and ``(z, W, b, q)``."""
    import torch
    from repro_torch.core import stages
    from repro_torch.kernels import build
    from repro_torch.kernels import feature_cache as tfc
    from repro_torch.kernels import gat_na as tgat
    from repro_torch.kernels import semantic_attn as tsem

    ex, params, batch, plan = (built.executor, built.params, built.batch,
                               built.plan)
    hot = batch["residency"]["hot"]
    heads = ex.cfg.n_heads
    gathers, gat_args, errs, gat_errs = [], {}, [0.0], []
    with torch.inference_mode():
        h = ex.fp(params, batch)  # every type's [N_t, 64]
        for i_path, ((nodes, mask), types) in enumerate(
                zip(batch["instances"], plan.metapaths)):
            mp_tag = "".join(types)
            n, i, l = nodes.shape
            rows = []
            for j, ty in enumerate(types):
                table, idx = h[ty], nodes[:, :, j]
                tag = f"{mp_tag}[{j}]={ty}"
                gathers.append((tag, table, hot[ty], idx))
                out = tfc.cached_gather(table, hot[ty], idx)
                want = tfc.cached_gather_plain(table, hot[ty], idx)
                torch.cuda.synchronize()
                errs.append(max_err(out, want))
                check(torch.equal(out, want) and torch.equal(
                    out, tfc.cached_gather_emulate(table, hot[ty], idx)),
                    f"cached_gather {tag}: table {tuple(table.shape)}, C "
                    f"{hot[ty].numel()}, idx {tuple(idx.shape)} strides "
                    f"{idx.stride()}, {int((idx >= table.shape[0]).sum())} "
                    f"of {idx.numel()} indices hot: bitwise equal to plain "
                    f"and to its emulation")
                rows.append(out)
            if i_path == 0:
                names = device_kernels(
                    lambda: tfc.cached_gather(table, hot[ty], idx))
                check(len(names) == 1 and "cached_gather_kernel" in names[0],
                      f"cached_gather: one device kernel a call, no fill "
                      f"({names})")
            h_path = torch.stack(rows, dim=2).reshape(n, i, l, heads, -1)
            flat = stages.rotate_encoder(h_path).reshape(n * i, heads, -1)
            nbr = torch.arange(n * i, dtype=torch.int32,
                               device=flat.device).reshape(n, i)
            h_tgt = h[plan.target].reshape(-1, heads, flat.shape[-1])
            args = (params["att"][i_path], h_tgt, flat, nbr, mask)
            gat_args[mp_tag] = args
            out = tgat.gat_na(*args)
            want = tgat.gat_na_plain(*args)
            torch.cuda.synchronize()
            gat_errs.append(max_err(out, want))
            dead = mask.sum(dim=1) == 0
            check(close(out, want, **TOL_Z),
                  f"gat_na unstacked {mp_tag}: h_src {tuple(flat.shape)}, "
                  f"nbr {tuple(nbr.shape)}, {int((mask != 0).sum())} live "
                  f"instances: vs plain max |err| {gat_errs[-1]:.3e} (tol "
                  f"{TOL_Z})")
            check(bool((out[dead] == 0).all()),
                  f"gat_na unstacked {mp_tag}: the {int(dead.sum())} rows "
                  f"with no live instance come out exactly 0")
        results["gat_na_unstacked"] = {"max_abs_err": max(gat_errs),
                                       "tolerance": TOL_Z}
        results["cached_gather"] = {"max_abs_err": max(errs),
                                    "tolerance": "bitwise"}

        sem = params["sem"]
        z = torch.stack(ex.na(params, batch, h))  # [2, 4278, 64]
        sa = (z, sem["W"], sem["b"], sem["q"])
        w = tsem.semantic_scores(*sa)
        want = tsem.semantic_scores_plain(*sa)
        torch.cuda.synchronize()
        err = max_err(w, want)
        check(close(w, want, **TOL_SCORES),
              f"semantic_scores z {tuple(z.shape)} W {tuple(sem['W'].shape)}"
              f": {w.tolist()} vs plain {want.tolist()}, max |err| "
              f"{err:.3e} (tol {TOL_SCORES})")
        tile = tsem.tile_rows(z, sem["W"])
        check(close(w, tsem.semantic_scores_emulate(*sa, tile), **TOL_SCORES),
              f"semantic_scores vs its emulation ({tile}-row tiles)")
        check(torch.equal(w, tsem.semantic_scores(*sa)),
              "semantic_scores: two runs give the same bits")
        names = device_kernels(lambda: tsem.semantic_scores(*sa))
        check(len(names) == 1 and "semantic_scores_kernel" in names[0],
              f"semantic_scores: one device kernel a call ({names})")
        done = build.scratch("semantic_scores done", 1, torch.int32, z.device,
                             torch.cuda.current_stream().cuda_stream)
        check(int(done.item()) == 0,
              "semantic_scores: its last-block counter is back at 0")
        results["semantic_scores"] = {"max_abs_err": err,
                                      "tolerance": TOL_SCORES}
    return gathers, gat_args, sa


# a kernel's name in a trace -> the wrapper counter that its launch ticks
KERNEL_COUNTERS = {
    "gat_na_kernel": "gat_na",
    "sum_scores_kernel": "gat_na_fused_sa",
    "semantic_combine_kernel": "semantic_combine",
    "segment_spmm_kernel": "segment_spmm",
    "segment_sum_kernel": "segment_sum",
    "fused_fp_na_kernel": "fused_fp_na",
    "cached_gather_kernel": "cached_gather",
    "semantic_scores_kernel": "semantic_scores",
    "flash_attention_kernel": "flash_attention",
    "flash_attention_tc_kernel": "flash_attention",
    "decode_split_kernel": "decode_attention",
}
# kernels that one wrapper call launches beside the counted one, once each
PAIRED_KERNELS = {"segment_sum_long_kernel": "segment_sum_kernel",
                  "decode_combine_kernel": "decode_split_kernel"}
# CUDA-graph replays over the run, from the measured card: launches by
# counter (each graph's traced launches a replay, times its replays),
# graphs traced, and graphs replayed but never traced
REPLAYS = {"launches": {}, "graphs_traced": 0, "replays": 0,
           "untraced": []}


def kernel_counts(names) -> dict:
    """Device kernel names -> launches by wrapper counter, and the paired
    kernels' counts beside their partners' (``KERNEL_COUNTERS``)."""
    seen: dict = {}
    for n in names:
        m = re.search(r"(\w+_kernel)\s*[<(]", n)
        if m:
            seen[m.group(1)] = seen.get(m.group(1), 0) + 1
    counts: dict = {}
    for kname, counter in KERNEL_COUNTERS.items():
        if seen.get(kname):
            counts[counter] = counts.get(counter, 0) + seen[kname]
    pairs = {k: (seen.get(k, 0), seen.get(v, 0))
             for k, v in PAIRED_KERNELS.items()}
    return counts, pairs


def measured_card():
    """``graphs._Card`` whose ``replay`` traces the first replay of every
    graph (``traced_call``) and maps the device kernels in the trace to
    the wrapper counters (``kernel_counts``): the graph's launches, which
    ``graphs.compiled`` adds to the counters on every replay, must be
    those, checked before that replay is added.  Every later replay adds
    the traced launches to ``REPLAYS``.  A replay under another profiler,
    or one whose trace lost its lead-in or tail, is not traced; the next
    one is, and a graph that ends its life replayed but never traced is
    listed in ``REPLAYS["untraced"]``."""
    import weakref

    import torch
    from repro_torch import graphs

    def add(measured, n):
        tot = REPLAYS["launches"]
        for k, v in measured.items():
            tot[k] = tot.get(k, 0) + v * n
        REPLAYS["replays"] += n

    def lost(launches, pending):
        if pending[0]:
            REPLAYS["untraced"].append(
                {"replays": pending[0], "launches_a_replay": launches})

    class MeasuredCard(graphs._Card):
        def replay(self, g):
            measured = getattr(g, "measured", None)
            if measured is not None:
                g.graph.replay()
                add(measured, 1)
                return
            if not hasattr(g, "pending"):
                g.pending = [0]
                g.finalizer = weakref.finalize(
                    g, lost, {k: v for k, v in g.launches.items() if v},
                    g.pending)
            if torch.autograd._profiler_enabled():
                g.graph.replay()
                g.pending[0] += 1
                return
            names, _, spins = traced_call(g.graph.replay)
            credit = {k: v for k, v in g.launches.items() if v}
            # nothing between the last lead-in and the tail is a whole
            # trace of a graph that launches no kernel of a wrapper (an
            # identity stage's graph is empty)
            if not (len(spins) >= 2 and spins[-1] == len(names) - 1
                    and (spins[-1] - spins[-2] > 1 or not credit)):
                print(f"  (a graph's first traced replay lost its lead-in "
                      f"or tail: {len(names)} device events; the next "
                      "replay is traced)")
                g.pending[0] += 1
                return
            counts, pairs = kernel_counts(names[spins[-2] + 1:spins[-1]])
            check(counts == credit and credit.get(
                "decode_attention_lse", 0) == 0
                and all(a == b for a, b in pairs.values()),
                f"11: a captured graph's replay traced {counts} (paired "
                f"kernels {pairs}) = the launches it adds to the counters "
                f"{credit}")
            g.measured = counts
            g.finalizer.detach()
            REPLAYS["graphs_traced"] += 1
            add(counts, 1 + g.pending[0])

    return MeasuredCard()


def drive_variant(cfg, hg, dev, tag: str, per_forward, cpu_check: bool,
                  forward_ms: dict, profiles: dict, twice: bool = False,
                  keep: dict = None, compiled: dict = None) -> dict:
    """Drive one configuration through ``build_hgnn_infer`` +
    ``HGNNInferEngine`` (its forward compiled: the first call warms up and
    captures, the others replay): ITERS forwards with every launch count
    set to 0 just before and read just after, held equal to
    ``per_forward(batch)`` (kernel -> launches a forward; the rest 0)
    times ITERS; logits finite and of the target's shape; with ``twice``,
    a further forward bitwise equal to the last; against the plain arm on
    the card and, with ``cpu_check``, on the CPU; then walls and a
    profile; with ``compiled``, phase 11's captured-against-eager record
    (``captured_vs_eager``).  Returns the counts and the logits; ``keep``
    receives the built model."""
    import torch
    from repro_torch.core.models import get_model
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_hgnn_infer
    from repro_torch.serve.engine import HGNNInferEngine

    t0 = time.perf_counter()
    b = build_hgnn_infer(cfg, hg, dev)
    torch.cuda.synchronize()
    print(f"  {tag}: build_hgnn_infer (host tables, residency, copy to the "
          f"card) {time.perf_counter() - t0:.2f} s", flush=True)
    if keep is not None:
        keep["built"] = b
    engine = HGNNInferEngine(b.executor, b.params, b.batch, fn=b.fn)
    ops.reset_launch_counts()
    for _ in range(ITERS):
        logits = engine.infer()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update({k: v * ITERS for k, v in per_forward(b.batch).items()})
    check(counts == want, f"{tag}: launches {counts} over {ITERS} forwards")
    rows = hg.node_counts[b.plan.target]
    check(tuple(logits.shape) == (rows, cfg.n_classes)
          and bool(torch.isfinite(logits).all()),
          f"{tag}: logits {tuple(logits.shape)} finite")
    if twice:
        check(torch.equal(engine.infer(), logits),
              f"{tag}: a second run gives the same bits")
    plain_model = get_model(cfg.replace(use_pallas=False))
    with torch.inference_mode():
        plain = plain_model.forward(b.params, b.batch)
    torch.cuda.synchronize()
    err = max_err(logits, plain)
    check(close(logits, plain, **TOL_LOGITS),
          f"{tag}: logits vs plain arm on the card: max |err| "
          f"{err:.3e} (|logits| <= {float(logits.abs().max()):.3f})")
    if cpu_check:
        with torch.inference_mode():
            on_cpu = plain_model.forward(to_device(b.params, "cpu"),
                                         plain_model.prepare(hg, "cpu"))
        err = max_err(logits.cpu(), on_cpu)
        check(close(logits.cpu(), on_cpu, **TOL_CPU),
              f"{tag}: logits vs the plain arm on the CPU: max "
              f"|err| {err:.3e} (tol {TOL_CPU})")
    plain_engine = HGNNInferEngine(plain_model.executor, b.params, b.batch)
    forward_ms[tag] = wall_ms(engine)
    forward_ms[tag + " plain"] = wall_ms(plain_engine)
    print(f"  {tag}: forward {forward_ms[tag]:.4f} ms/iter wall "
          f"(plain arm {forward_ms[tag + ' plain']:.4f} ms/iter)", flush=True)
    profiles[tag] = profile_forward(engine, tag)
    if compiled is not None:
        compiled[tag] = captured_vs_eager(tag, b, engine, logits,
                                          per_forward, profiles[tag])
    return counts, logits


def captured_vs_eager(tag, b, engine, logits, per_forward, prof) -> dict:
    """Phase 11 on one full-graph forward: the compiled engine's logits
    bitwise the eager ``fn=model.forward`` engine's, a second ``infer()``
    leaving the first result as it was, one capture, ITERS replays
    launching what the graph's traced replay launched times ITERS (=
    ``per_forward`` each; ``measured_card``), the walls of both engines
    in turns (eager, captured, captured, eager; 20 forwards each) and the
    busy share of the profiled captured forward (``prof``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import HGNNInferEngine

    eager_eng = HGNNInferEngine(b.executor, b.params, b.batch,
                                fn=eager(b).fn)
    first = engine.infer()
    kept = first.clone()
    want = eager_eng.infer()
    second = engine.infer()
    torch.cuda.synchronize()
    check(torch.equal(first, want) and torch.equal(logits, want),
          f"11 {tag}: captured logits bitwise the eager engine's (max "
          f"|diff| {max_err(first, want):.3g})")
    check(torch.equal(first, kept) and torch.equal(second, want),
          f"11 {tag}: a second infer() leaves the first result as it was")
    fn = engine.fn
    ops.reset_launch_counts()
    r0 = fn.replays
    for _ in range(ITERS):
        engine.infer()
    torch.cuda.synchronize()
    counts, n = ops.launch_counts(), fn.replays - r0
    g = fn.graph_of(b.params, b.batch)
    per = {k: v for k, v in per_forward(b.batch).items() if v}
    traced = getattr(g, "measured", None)
    check(fn.captures == 1 and n == ITERS and traced == per
          and {k: v for k, v in counts.items() if v}
          == {k: v * n for k, v in traced.items()},
          f"11 {tag}: {fn.captures} capture, {n} replays launching "
          f"{ {k: v for k, v in counts.items() if v} } (the graph's traced "
          f"replay {traced} x {n}; a forward's {per})")
    walls = {"eager": [], "captured": []}
    for arm in ("eager", "captured", "captured", "eager"):
        walls[arm].append(wall_ms(eager_eng if arm == "eager" else engine))
    rec = {"eager_ms": float(np.mean(walls["eager"])),
           "captured_ms": float(np.mean(walls["captured"])),
           "walls_in_turns": walls,
           "captured_busy_share": prof["device_busy_ms"] / prof["wall_ms"],
           "captures": fn.captures, "replays": fn.replays,
           "launches_a_replay_traced": traced}
    print(f"  11 {tag}: forward wall eager {rec['eager_ms']:.4f} ms, "
          f"captured {rec['captured_ms']:.4f} ms (in turns: {walls}); "
          f"captured busy {100 * rec['captured_busy_share']:.1f}%; "
          f"{fn.captures} capture, {fn.replays} replays", flush=True)
    return rec


def segment_spmm_launches(layers: int):
    """Launches a forward of RGCN: one ``segment_spmm`` per relation per
    layer, or per degree bucket when bucketed."""
    def per_forward(batch):
        return {"segment_spmm": layers * sum(
            len(r) if isinstance(r, list) else 1
            for r in batch["rels"].values())}
    return per_forward


def rgcn_dblp(dev, forward_ms: dict, profiles: dict) -> int:
    """RGCN on synthetic DBLP (L=1, padded, kernels on; six relations, a
    14,328-row paper table), through :func:`drive_variant`.  Returns the
    launches."""
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.data.synthetic import make_dataset

    t0 = time.perf_counter()
    hg = make_dataset("dblp")
    print(f"  dblp built in {time.perf_counter() - t0:.2f} s")
    cfg = HGNNConfig(model="rgcn", dataset="dblp", fused=True,
                     use_pallas=True)
    return drive_variant(cfg, hg, dev, "rgcn/dblp L=1 padded",
                         segment_spmm_launches(1), False, forward_ms,
                         profiles)[0]["segment_spmm"]



def capture_segment_sums(fn) -> list:
    """Run ``fn`` once with ``ops.segment_sum``, the stages' entry to the
    kernel, recorded: the ``(vals, seg, n, idx, mean)`` of each call in
    order, the main path's own inputs."""
    import torch
    from repro_torch.kernels import ops

    calls = []
    orig = ops.segment_sum

    def record(vals, seg, n, idx=None, mean=False, hot=None):
        if hot is not None:
            raise ValueError("capture_segment_sums: a residency call")
        calls.append((vals, seg, n, idx, mean))
        return orig(vals, seg, n, idx=idx, mean=mean)

    ops.segment_sum = record
    try:
        with torch.inference_mode():
            fn()
    finally:
        ops.segment_sum = orig
    return calls


def segment_sum_vs_plain(tag: str, calls: list, results: dict) -> None:
    """Phase 2d: each recorded call's kernel output bitwise against the
    plain version run on the CPU (``index_add_``, index order) and against
    a second run; one device kernel a call."""
    import torch
    from repro_torch.kernels import segment_sum as tss

    rec = results.setdefault("segment_sum", {
        "max_abs_err": 0.0, "tolerance": "bitwise (vs the plain version "
        "on the CPU)", "checked": []})
    with torch.inference_mode():
        for i, (vals, seg, n, idx, mean) in enumerate(calls):
            out = tss.segment_sum(vals, seg, n, idx=idx, mean=mean)
            want = tss.segment_sum_plain(
                vals.cpu(), seg.cpu(), n,
                idx=None if idx is None else idx.cpu(), mean=mean)
            err = max_err(out.cpu(), want)
            lens = torch.bincount(seg.long(), minlength=n)
            form = "gather mean" if idx is not None else "sum"
            what = (f"segment_sum {tag} call {i} ({form}): vals "
                    f"{tuple(vals.shape)}, E {seg.numel()}, N {n}, "
                    f"{int((lens == 0).sum())} empty segments, the longest "
                    f"{int(lens.max())}")
            print(f"  {what}")
            check(torch.equal(out.cpu(), want),
                  f"{what}: bitwise equal to the plain version on the CPU "
                  f"(max |err| {err:.3e})")
            check(torch.equal(out, tss.segment_sum(vals, seg, n, idx=idx,
                                                   mean=mean)),
                  f"segment_sum {tag} call {i}: two runs give the same bits")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["checked"].append({"case": f"{tag} call {i} ({form})",
                                   "E": int(seg.numel()), "N": n,
                                   "C": int(vals.shape[1]),
                                   "max_abs_err": err})
        vals, seg, n, idx, mean = calls[0]
        names = device_kernels(lambda: tss.segment_sum(vals, seg, n, idx=idx,
                                                       mean=mean))
        check(len(names) == 2 and "segment_sum_kernel" in names[0]
              and "segment_sum_long_kernel" in names[1],
              f"segment_sum {tag}: two device kernels a call, the segments "
              f"then the long ones ({names})")


def bucket_calls(built) -> list:
    """The unstacked ``gat_na`` calls of HAN's bucketed layer 0, one a
    degree bucket: ``[(tag, (p, h_dst, h_src, nbr, mask))]``."""
    import torch

    ex, params, batch = built.executor, built.params, built.batch
    with torch.inference_mode():
        h = ex.fp(params, batch)  # [N, H, Dh]
    calls = []
    for (path, bks), p_i in zip(zip(built.plan.metapaths, batch["buckets"]),
                                params["gat"]):
        for rid, nbr, mask in bks:
            calls.append((f"{''.join(path)} K={nbr.shape[1]}",
                          (p_i, h.index_select(0, rid.long()), h, nbr,
                           mask)))
    return calls


def gat_na_buckets_vs_plain(calls: list, results: dict) -> None:
    """Phase 2e: the unstacked ``gat_na`` on each HAN/imdb degree bucket
    against its plain version; rows with no live slot exactly 0; the same
    bits twice."""
    import torch
    from repro_torch.kernels import gat_na as tgat

    errs = []
    with torch.inference_mode():
        for tag, args in calls:
            out = tgat.gat_na(*args)
            want = tgat.gat_na_plain(*args)
            torch.cuda.synchronize()
            errs.append(max_err(out, want))
            mask = args[4]
            dead = mask.sum(dim=1) == 0
            check(close(out, want, **TOL_Z)
                  and bool((out[dead] == 0).all())
                  and torch.equal(out, tgat.gat_na(*args)),
                  f"gat_na bucket {tag}: {mask.shape[0]} rows, "
                  f"{int((mask != 0).sum())} live slots: vs plain max |err| "
                  f"{errs[-1]:.3e} (tol {TOL_Z}); {int(dead.sum())} rows with "
                  f"no live slot exactly 0; the same bits twice")
    results["gat_na_bucketed"] = {"max_abs_err": max(errs),
                                  "tolerance": TOL_Z}


def na_profile(built, tag: str, profiles: dict) -> float:
    """Device ms of one NA stage (layer 0, after its FP) under the
    profiler: the paper's Fig. 5c measures NA alone."""
    import torch

    ex, params, batch = built.executor, built.params, built.batch
    with torch.inference_mode():
        h = ex.fp(params, batch)

    def na():
        with torch.inference_mode():
            return ex.na(params, batch, h)

    profiles[tag] = profile_forward(types.SimpleNamespace(infer=na), tag)
    return profiles[tag]["device_busy_ms"]


def segment_sum_timing(call, flush) -> dict:
    """One ``segment_sum`` call timed cold and warm beside its bound, its
    plain version on the card, ``index_add_`` (one call, atomic, on rows
    gathered beforehand: the sum alone) and, for the gather mean,
    ``torch.sparse.mm`` by the matrix of 1/len weights (the whole
    function in one call)."""
    import torch
    from repro_torch.kernels import segment_sum as tss

    vals, seg, n, idx, mean = call
    seg_l = seg.long()
    rows = vals if idx is None else vals[idx.long()]
    acc = torch.zeros((n, vals.shape[1]), device=vals.device)
    kern = lambda: tss.segment_sum(vals, seg, n, idx=idx,  # noqa: E731
                                   mean=mean)
    n_bytes, n_ops = tss.work(vals, seg, n, idx, mean, live_only=True)
    b_ms, b_by = bound(n_bytes, n_ops)
    rec = {"ms": time_ms(kern, 50, flush), "warm_ms": time_ms(kern, 50),
           "plain_ms": time_ms(lambda: tss.segment_sum_plain(
               vals, seg, n, idx=idx, mean=mean), 20, flush),
           "library_ms": time_ms(lambda: acc.index_add_(0, seg_l, rows), 50,
                                 flush),
           "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
           "operations": n_ops, "E": int(seg.numel()), "N": n,
           "C": int(vals.shape[1])}
    if idx is not None:
        lens = torch.bincount(seg_l, minlength=n).clamp(min=1)
        w = (1.0 / lens.float())[seg_l]
        csr = torch.sparse_coo_tensor(torch.stack([seg_l, idx.long()]), w,
                                      (n, vals.shape[0])).coalesce()
        csr = csr.to_sparse_csr()
        rec["sparse_mm_ms"] = time_ms(lambda: torch.sparse.mm(csr, vals), 50,
                                      flush)
    return rec


# Request-path serving (phase 3m): HAN/imdb through the gat_na epilogue and
# semantic_combine, RGCN/imdb on rung-padded buckets, MAGNN/imdb, and GCN
# on the Reddit-like graph, each sampled and served by HGNNServeEngine

SERVE_REQUESTS = 32  # the CLI's --requests: the checked serve
SERVE_SLOTS, SERVE_SLOT_TARGETS, SERVE_FANOUT = 8, 4, 8
# the timed serves: the same CLI traffic, long enough (~220 steps) that a
# serve's p99 step wall rests on a tail, repeated for the spread
SERVE_TIMED_REQUESTS, SERVE_REPEATS = 1024, 3


def capture_served_calls(fn) -> list:
    """Run ``fn`` once with the kernel entries of ``kernels/ops.py`` that
    a served step reaches recorded: ``[(kernel, args)]`` at the shapes the
    step gave them (sink row and pad slots included)."""
    import torch
    from repro_torch.kernels import ops

    calls = []
    orig = {n: getattr(ops, n) for n in ("_gat_na", "semantic_combine",
                                         "segment_spmm", "segment_sum")}

    def gat(p, h_dst, h_src, nbr, mask, sem=None):
        calls.append(("gat_na", (p, h_dst, h_src, nbr, mask, sem)))
        return orig["_gat_na"](p, h_dst, h_src, nbr, mask, sem=sem)

    def combine(z, beta, use_pallas=False):
        if use_pallas:
            calls.append(("semantic_combine", (z, beta)))
        return orig["semantic_combine"](z, beta, use_pallas=use_pallas)

    def spmm(h_src, nbr, mask, mean=True, use_pallas=False):
        if use_pallas:
            calls.append(("segment_spmm", (h_src, nbr, mask, mean)))
        return orig["segment_spmm"](h_src, nbr, mask, mean=mean,
                                    use_pallas=use_pallas)

    def ssum(vals, seg, n, idx=None, mean=False, hot=None):
        if hot is not None:
            raise ValueError("capture_served_calls: a residency call")
        calls.append(("segment_sum", (vals, seg, n, idx, mean)))
        return orig["segment_sum"](vals, seg, n, idx=idx, mean=mean)

    for name, f in (("_gat_na", gat), ("semantic_combine", combine),
                    ("segment_spmm", spmm), ("segment_sum", ssum)):
        setattr(ops, name, f)
    try:
        with torch.inference_mode():
            fn()
    finally:
        for name, f in orig.items():
            setattr(ops, name, f)
    return calls


def served_calls_vs_plain(tag: str, calls: list, errs: dict,
                          what: str = "served call") -> None:
    """Each captured call's kernel against its plain version on the same
    inputs: ``gat_na`` (z at TOL_Z, the epilogue's w at TOL_W),
    ``semantic_combine`` at 1e-6, ``segment_spmm`` at TOL_SPMM, and
    ``segment_sum`` bitwise against its plain version on the CPU."""
    import torch
    from repro_torch.kernels import gat_na as tgat
    from repro_torch.kernels import segment_spmm as tspmm
    from repro_torch.kernels import segment_sum as tss
    from repro_torch.kernels import semantic_attn as tsem

    with torch.inference_mode():
        for i, (name, a) in enumerate(calls):
            if name == "gat_na":
                p, h_dst, h_src, nbr, mask, sem = a
                key = "gat_na_fused_sa" if sem is not None else "gat_na"
                if sem is None:
                    out = tgat.gat_na(p, h_dst, h_src, nbr, mask)
                    want = tgat.gat_na_plain(p, h_dst, h_src, nbr, mask)
                    err = max_err(out, want)
                    ok = close(out, want, **TOL_Z) and bool(
                        (out[mask.sum(dim=-1) == 0] == 0).all())
                else:
                    (z, w), (zp, wp) = (
                        tgat.gat_na(p, h_dst, h_src, nbr, mask, sem=sem),
                        tgat.gat_na_plain(p, h_dst, h_src, nbr, mask, sem))
                    err = max(max_err(z, zp), max_err(w, wp))
                    ok = close(z, zp, **TOL_Z) and close(w, wp, **TOL_W)
                shape = f"nbr {tuple(nbr.shape)}, h_src {tuple(h_src.shape)}"
            elif name == "semantic_combine":
                z, beta = a
                key = name
                out = tsem.semantic_combine(z, beta)
                want = tsem.semantic_combine_plain(z, beta)
                err = max_err(out, want)
                ok = close(out, want, atol=1e-6, rtol=1e-6)
                shape = f"z {tuple(z.shape)}"
            elif name == "segment_spmm":
                h_src, nbr, mask, mean = a
                key = name
                out = tspmm.segment_spmm(h_src, nbr, mask, mean=mean)
                want = tspmm.segment_spmm_plain(h_src, nbr, mask, mean=mean)
                err = max_err(out, want)
                ok = close(out, want, **TOL_SPMM) and bool(
                    (out[mask.sum(dim=1) == 0] == 0).all())
                shape = (f"nbr {tuple(nbr.shape)}, "
                         f"{int((mask.sum(dim=1) == 0).sum())} rows "
                         f"without a live slot")
            else:
                vals, seg, n, idx, mean = a
                key = name
                out = tss.segment_sum(vals, seg, n, idx=idx, mean=mean)
                want = tss.segment_sum_plain(
                    vals.cpu(), seg.cpu(), n,
                    idx=None if idx is None else idx.cpu(), mean=mean)
                err = max_err(out.cpu(), want)
                ok = torch.equal(out.cpu(), want)
                shape = (f"E {seg.numel()}, N {n} (sink segment "
                         f"{n - 1}: {int((seg == n - 1).sum())} pad edges)")
            torch.cuda.synchronize()
            errs[key] = max(errs.get(key, 0.0), err)
            check(ok, f"{tag} {what} {i} {name}: {shape}: vs plain "
                      f"max |err| {err:.3e}")


def busy_over(fn) -> dict:
    """Device time of one call of ``fn`` under torch.profiler: kernels and
    copies apart, over the profiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    copy = sum(e.self_device_time_total for e in rows
               if "memcpy" in e.key.lower()) / 1e3
    kern = sum(e.self_device_time_total for e in rows) / 1e3 - copy
    return {"wall_ms": wall, "kernel_ms": kern, "copy_ms": copy}


def serve_case(tag, cfg, hg, dev, per_forward, serve_counts: dict,
               errs: dict, out: dict, slots=SERVE_SLOTS,
               slot_targets=SERVE_SLOT_TARGETS) -> None:
    """One model served on the card through ``build_hgnn_infer``,
    ``HGNNSampler`` and ``HGNNServeEngine``: the launch counts of the
    warmup and the serve (set to 0 just before, read just after) exactly
    ``per_forward(sampler)`` a forward times (rungs + steps); no failed
    step, no retry, every request OK, nothing made after warmup; each
    request's logits against the same queue served on the CPU by the
    plain arm (TOL_CPU) with every counter equal; each kernel call of one
    served step against its plain version, their number that of one
    forward's launches; one capture a rung; then ``SERVE_REPEATS`` timed
    serves of ``SERVE_TIMED_REQUESTS`` requests of the same traffic (step
    wall p50/p99 and targets/s of each, their median and range) in turns
    with two by the eager engine (``fn=model.forward``; phase 11: the
    logits bitwise), the host sampler and the upload a step (pageable, and
    the compiled forward's from pinned memory: the sampled feature tables
    straight from the engine's pinned rows, the rest through its staging),
    and the device's busy
    share over one more, profiled, serve."""
    import numpy as np
    import torch
    from repro_torch.core.models import get_model
    from repro_torch.kernels import ops
    from repro_torch import tree
    from repro_torch.launch.serve import build_hgnn_infer, request_queue
    from repro_torch.serve.engine import HGNNServeEngine, _shapes
    from repro_torch.serve.sampler import HGNNSampler

    b = build_hgnn_infer(cfg, hg, dev)
    t0 = time.perf_counter()
    sampler = HGNNSampler(b.plan, cfg, hg)
    print(f"  {tag}: sampler tables {time.perf_counter() - t0:.2f} s, "
          f"ladder {sampler.ladder}", flush=True)
    eng = HGNNServeEngine(b.executor, b.params, sampler, slots=slots,
                          slot_targets=slot_targets, fn=b.fn)
    reqs = request_queue(sampler.n_target_type, slot_targets,
                         SERVE_REQUESTS)
    ops.reset_launch_counts()
    eng.warmup()
    eng.serve(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    st = eng.stats()
    rs = st["resilience"]
    n_fw = len(sampler.ladder) + st["steps"]
    want = dict.fromkeys(counts, 0)
    want.update({k: v * n_fw for k, v in per_forward(sampler).items()})
    check(counts == want, f"{tag}: launches {counts} over {n_fw} forwards "
                          f"({len(sampler.ladder)} rungs + {st['steps']} "
                          f"steps)")
    for name in ("gat_na_fused_sa", "semantic_combine", "segment_spmm",
                 "segment_sum"):
        serve_counts[name] += counts[name]
    serve_counts["gat_na_unstacked"] += counts["gat_na"] - counts[
        "gat_na_fused_sa"]
    check(rs["failed_steps"] == 0 and rs["retries"] == 0
          and all(r.status == "OK" for r in reqs)
          and st["compiles_after_warmup"] == 0,
          f"{tag}: failed_steps {rs['failed_steps']}, retries "
          f"{rs['retries']}, statuses {rs['statuses']}, "
          f"compiles_after_warmup {st['compiles_after_warmup']}")
    rung_sigs = {_shapes(sampler.dummy_batch(i).batch)
                 for i in range(len(sampler.ladder))}
    check(eng.fn is not b.fn and eng.fn.captures == len(rung_sigs)
          == len(sampler.ladder) and eng.fn.replays == st["steps"],
          f"11 {tag}: {eng.fn.captures} captures for {len(sampler.ladder)} "
          f"rungs ({len(rung_sigs)} distinct), {eng.fn.replays} replays "
          f"for {st['steps']} steps")

    plain = get_model(cfg.replace(use_pallas=False))
    cpu_eng = HGNNServeEngine(plain.executor, to_device(b.params, "cpu"),
                              sampler, slots=slots,
                              slot_targets=slot_targets)
    cpu_reqs = request_queue(sampler.n_target_type, slot_targets,
                             SERVE_REQUESTS)
    cpu_eng.warmup()
    cpu_eng.serve(cpu_reqs)
    cst = cpu_eng.stats()
    err = max(max_err(torch.from_numpy(r.logits), torch.from_numpy(c.logits))
              for r, c in zip(reqs, cpu_reqs))
    check(all(np.array_equal(r.served, c.served)
              and close(torch.from_numpy(r.logits),
                        torch.from_numpy(c.logits), **TOL_CPU)
              for r, c in zip(reqs, cpu_reqs)),
          f"{tag}: every request's logits vs the CPU plain-arm serve: max "
          f"|err| {err:.3e} (tol {TOL_CPU})")
    same = {k: st[k] == cst[k] for k in ("steps", "rung_hits",
                                         "frontier_bytes", "truncated_rows",
                                         "compiles_after_warmup")}
    check(all(same.values()) and rs == cst["resilience"],
          f"{tag}: counters equal the CPU serve's exactly ({same}; "
          f"resilience equal: {rs == cst['resilience']})")

    calls = capture_served_calls(lambda: eager(b).fn(
        b.params, eng.place(eng.last_sb.batch)))
    got = {}
    for name, a in calls:
        got[name] = got.get(name, 0) + 1
        if name == "gat_na" and a[-1] is not None:
            got["gat_na_fused_sa"] = got.get("gat_na_fused_sa", 0) + 1
    check(got == per_forward(sampler),
          f"{tag}: one served step's captured kernel calls {got} = one "
          f"forward's launches {per_forward(sampler)}")
    served_calls_vs_plain(tag, calls, errs)

    sb = eng.last_sb
    # the pageable upload of the same batch, from a copy in pageable memory
    # (the compiled engine's batch has its feature tables in pinned rows)
    paged = tree.map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                     else np.array(x) if isinstance(x, np.ndarray) else x,
                     sb.batch)
    h2d = []
    for _ in range(10):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.place(paged)
        torch.cuda.synchronize()
        h2d.append((time.perf_counter() - t1) * 1e3)
    h2d_mb = sum(t.numel() * t.element_size() for t in
                 _tensors(paged)) / 2 ** 20
    check(not any(t.is_pinned() for t in _tensors(paged))
          and any(t.is_pinned() for t in _tensors(sb.batch)),
          f"{tag}: the served batch's feature tables lie in pinned memory, "
          f"its pageable copy's do not")

    def timed_queue():
        return request_queue(sampler.n_target_type, slot_targets,
                             SERVE_TIMED_REQUESTS)

    # phase 11: the pinned upload of the compiled forward (the same batch)
    g = eng.fn.graph_of(eng.params, sb.batch)
    flat = tree.leaves((eng.params, sb.batch))
    pinned = []
    for _ in range(10):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g.upload(flat)
        torch.cuda.synchronize()
        pinned.append((time.perf_counter() - t1) * 1e3)
    # the eager engine (fn=model.forward, pageable place) beside it
    eager_eng = HGNNServeEngine(b.executor, b.params, sampler, slots=slots,
                                slot_targets=slot_targets, fn=eager(b).fn)
    eager_eng.warmup()

    n_targets = sum(len(r.targets) for r in timed_queue())
    serves, sample, fwd, clean = [], [], [], True
    eager_serves, served = [], {}
    # in turns: eager, the captured repeats, eager
    for arm in ["eager"] + ["captured"] * SERVE_REPEATS + ["eager"]:
        e = eager_eng if arm == "eager" else eng
        reqs = timed_queue()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = e.stats()
        rs = st["resilience"]
        clean &= (rs["failed_steps"] == 0 and rs["retries"] == 0
                  and st["compiles_after_warmup"] == 0
                  and all(r.status == "OK" for r in reqs))
        served.setdefault(arm, reqs)
        walls = np.array([x["wall_s"] for x in e.step_log]) * 1e3
        rec_s = {"steps": st["steps"], "rung_hits": st["rung_hits"],
                 "wall_ms": wall * 1e3,
                 "step_wall_p50_ms": float(np.percentile(walls, 50)),
                 "step_wall_p99_ms": float(np.percentile(walls, 99)),
                 "targets_per_s": n_targets / wall}
        if arm == "eager":
            eager_serves.append(rec_s)
            continue
        sample += [x["sample_s"] * 1e3 for x in e.step_log]
        fwd += [x["forward_s"] * 1e3 for x in e.step_log]
        serves.append(rec_s)
    check(clean, f"{tag}: {SERVE_REPEATS} timed serves of "
                 f"{SERVE_TIMED_REQUESTS} requests and 2 eager ones: no "
                 f"failed step, no retry, every request OK, nothing made "
                 f"after warmup")
    check(all(np.array_equal(a.logits, c.logits)
              for a, c in zip(served["captured"], served["eager"])),
          f"11 {tag}: the {SERVE_TIMED_REQUESTS} served requests' logits "
          f"bitwise the eager engine's")
    prof = busy_over(lambda: eng.serve(timed_queue()))

    def spread(key):
        v = [x[key] for x in serves]
        return {"median": float(np.median(v)), "min": float(min(v)),
                "max": float(max(v))}

    rec = {"requests": SERVE_TIMED_REQUESTS, "targets": n_targets,
           "serves": serves, "step_wall_p50_ms": spread("step_wall_p50_ms"),
           "step_wall_p99_ms": spread("step_wall_p99_ms"),
           "targets_per_s": spread("targets_per_s"),
           "sampler_ms_per_step": float(np.mean(sample)),
           "forward_ms_per_step": float(np.mean(fwd)),
           "h2d_ms_last_batch": float(np.median(h2d)),
           "h2d_mib_last_batch": h2d_mb,
           "pinned_upload_ms_last_batch": float(np.median(pinned)),
           "pinned_upload_mib_last_batch": g.upload_bytes / 2 ** 20,
           "eager": {k: float(np.median([x[k] for x in eager_serves]))
                     for k in ("step_wall_p50_ms", "step_wall_p99_ms",
                               "targets_per_s")},
           "eager_serves": eager_serves,
           "captures": eng.fn.captures, "replays": eng.fn.replays,
           "profiled_serve": prof,
           "busy_share": (prof["kernel_ms"] + prof["copy_ms"])
           / prof["wall_ms"],
           "kernel_share": prof["kernel_ms"] / prof["wall_ms"]}
    out[tag] = rec

    def line(key, fmt):
        v = rec[key]
        return (f"{v['median']:{fmt}} [{v['min']:{fmt}}, "
                f"{v['max']:{fmt}}]")

    print(f"  {tag}: {SERVE_REPEATS} serves of {SERVE_TIMED_REQUESTS} "
          f"requests ({n_targets} targets; steps "
          f"{[x['steps'] for x in serves]}, rung_hits "
          f"{serves[0]['rung_hits']}), median [min, max] over the serves: "
          f"step wall p50 {line('step_wall_p50_ms', '.3f')} ms, p99 "
          f"{line('step_wall_p99_ms', '.3f')} ms; "
          f"{line('targets_per_s', '.1f')} targets/s (serve walls "
          f"{[round(x['wall_ms'], 2) for x in serves]} ms)")
    print(f"  {tag}: a step: host sampler {rec['sampler_ms_per_step']:.3f} "
          f"ms, upload + forward + read-back "
          f"{rec['forward_ms_per_step']:.3f} ms (the last batch's upload: "
          f"{h2d_mb:.2f} MiB in {rec['h2d_ms_last_batch']:.3f} ms pageable, "
          f"{rec['pinned_upload_mib_last_batch']:.2f} MiB in "
          f"{rec['pinned_upload_ms_last_batch']:.3f} ms from pinned "
          f"memory)")
    ev = rec["eager"]
    print(f"  11 {tag}: eager engine (2 serves, in turns with the captured "
          f"3): step wall p50 {ev['step_wall_p50_ms']:.3f} ms, p99 "
          f"{ev['step_wall_p99_ms']:.3f} ms, {ev['targets_per_s']:.1f} "
          f"targets/s; captured {line('step_wall_p50_ms', '.3f')} ms, "
          f"{line('step_wall_p99_ms', '.3f')} ms, "
          f"{line('targets_per_s', '.1f')} targets/s; {eng.fn.captures} "
          f"captures, {eng.fn.replays} replays")
    print(f"  {tag}: profiled serve {prof['wall_ms']:.2f} ms wall, kernels "
          f"{prof['kernel_ms']:.3f} ms, copies {prof['copy_ms']:.3f} ms: "
          f"device busy {100 * rec['busy_share']:.1f}% (kernels alone "
          f"{100 * rec['kernel_share']:.1f}%)", flush=True)
    del b, eng, cpu_eng, eager_eng, g
    torch.cuda.empty_cache()


def _tensors(tree):
    import torch

    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


def serving(hg, hg_r, dev, serve_counts: dict, results: dict) -> dict:
    """Phase 3m: the HAN/imdb serve of the CLI's command (fan-out 8, 8
    slots of 4 targets, 32 requests checked, then the same traffic timed
    at 1024 requests) and the RGCN/imdb 3-bucket, MAGNN/imdb
    and GCN/Reddit (0.1) serves through :func:`serve_case`; the
    identity-rung HAN/imdb serve of all 4278 targets bitwise against the
    card's full-graph forward; one seeded chaos serve whose counters equal
    ``BENCH_hgnn.json``'s ``resilience`` row ``han/imdb/chaos``."""
    import numpy as np
    import torch
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.core.characterize import resilience_record
    from repro_torch.launch.serve import build_hgnn_infer, request_queue
    from repro_torch.serve.engine import HGNNRequest, HGNNServeEngine
    from repro_torch.serve.faults import FaultInjector
    from repro_torch.serve.resilience import ResilienceConfig
    from repro_torch.serve.sampler import HGNNSampler

    out, errs = {}, {}
    han = HGNNConfig(model="han", dataset="imdb", fused=True,
                     use_pallas=True, fuse_na_sa=True, fanout=SERVE_FANOUT)
    serve_case("serve han/imdb", han, hg, dev,
               lambda s: {"gat_na": 1, "gat_na_fused_sa": 1,
                          "semantic_combine": 1}, serve_counts, errs, out)
    serve_case("serve rgcn/imdb bucketed 3",
               HGNNConfig(model="rgcn", dataset="imdb", fused=True,
                          use_pallas=True, degree_buckets=3,
                          fanout=SERVE_FANOUT), hg, dev,
               lambda s: {"segment_spmm": sum(
                   b.n_buckets for b in s.full_buckets.values())},
               serve_counts, errs, out)
    serve_case("serve magnn/imdb",
               HGNNConfig(model="magnn", dataset="imdb", use_pallas=True,
                          fanout=SERVE_FANOUT), hg, dev,
               lambda s: {"gat_na": len(s.plan.metapaths)}, serve_counts,
               errs, out)
    serve_case("serve gcn/reddit-0.1",
               HGNNConfig(model="gcn", dataset="reddit",
                          fanout=SERVE_FANOUT), hg_r, dev,
               lambda s: {"segment_sum": 2}, serve_counts, errs, out)
    results["served_max_abs_err"] = errs

    n = hg.node_counts["M"]
    ident = han.replace(fanout=64, sample_ladder=((n, n),))
    b = build_hgnn_infer(ident, hg, dev)
    eng = HGNNServeEngine(b.executor, b.params, HGNNSampler(b.plan, ident,
                                                            hg),
                          slots=1, slot_targets=n, fn=b.fn)
    eng.warmup()
    req = HGNNRequest(targets=np.arange(n))
    eng.serve([req])
    with torch.inference_mode():
        full = b.fn(b.params, b.batch).cpu().numpy()
    check(req.status == "OK" and eng.stats()["rung_hits"] == {0: 1}
          and np.array_equal(req.logits, full),
          f"han/imdb identity rung ({n}, {n}), fan-out 64: all {n} targets "
          f"served in one step bitwise equal to the card's full-graph "
          f"forward")
    del b, eng

    bench = json.loads((ROOT / "BENCH_hgnn.json").read_text())[
        "resilience"]["han/imdb/chaos"]
    cfg = HGNNConfig(model="han", dataset="imdb", hidden=64, n_heads=8,
                     n_classes=8, max_degree=32, fused=True, use_pallas=True,
                     fanout=8)
    b = build_hgnn_infer(cfg, hg, dev)
    sampler = HGNNSampler(b.plan, cfg, hg)
    eng = HGNNServeEngine(
        b.executor, b.params, sampler, slots=4, slot_targets=2, fn=b.fn,
        resilience_cfg=ResilienceConfig(
            max_queue=24, deadline_ms=60_000.0, slo_ms=50.0,
            slo_signal="injected", degrade_patience=1, recover_patience=2),
        injector=FaultInjector.seeded(0, n_steps=16, sampler=2, forward=1,
                                      persistent_sampler=1, latency_steps=4,
                                      latency_s=0.2))
    eng.warmup()
    eng.serve(request_queue(sampler.n_target_type, 4, SERVE_REQUESTS,
                            pool=48))
    got = resilience_record(eng.stats())
    diff = {k: (got[k], v) for k, v in bench.items()
            if k in got and got[k] != v}
    check(not diff, f"han/imdb chaos serve (seed 0, bench_resilience.py's "
                    f"config): counters equal BENCH_hgnn.json's "
                    f"han/imdb/chaos row (differences: {diff}; steps "
                    f"{got['steps']}, retries {got['retries']}, "
                    f"failed_steps {got['failed_steps']})")
    out["chaos han/imdb"] = got
    del b, eng
    torch.cuda.empty_cache()
    return out


# graph-partitioned execution (phase 3p): the full-width forwards, the
# reference bench's partition sweep, and its failover serve
PART_KS = (1, 2, 4)
PART_CASES = (("han", 1), ("han", 2), ("rgcn", 1), ("rgcn", 2), ("magnn", 1))
# benchmarks/bench_partition.py's, bench_layers.py's and
# bench_resilience.py's settings (BENCH_hgnn.json's rows)
PART_BENCH = dict(dataset="imdb", hidden=64, n_heads=8, n_classes=8,
                  max_degree=32, fused=True, use_pallas=True)


def part_launches(model: str, layers: int, k: int):
    """Launches of one partitioned forward, from its batch: HAN one
    stacked ``gat_na`` a partition and layer; RGCN one ``segment_spmm`` a
    partitioned relation, partition and layer (L = 1: the relations into
    the target); MAGNN one unstacked ``gat_na`` a metapath and layer over
    every partition's rows."""
    def per_forward(batch):
        part = batch["part"]
        if model == "han":
            return {"gat_na": k * layers}
        if model == "rgcn":
            return {"segment_spmm": layers * k * len(part["rels"])}
        return {"gat_na": layers * len(part["instances"])}
    return per_forward


def partitioned(hg, dev, main_counts: dict, results: dict) -> dict:
    """Phase 3p.  Per case of ``PART_CASES`` at full width (hidden 64, 8
    heads, K = 64 slots, 16 instances), the unpartitioned kernel arm and
    then K in ``PART_KS`` partitions through ``build_hgnn_infer`` on the
    same parameters: exact launches over ITERS forwards (set to 0 just
    before, read just after), logits finite, K = 1 bitwise the
    unpartitioned kernel arm for every K, the card against the same
    partitioned batch through the plain arm on the CPU (TOL_CPU), forward
    walls; at K = 4 each kernel call of a forward against its plain
    version, a profile of the L = 1 forwards, and partitioned residency
    (256 hot rows a type) bitwise the uncached run.  Then
    ``bench_partition.py``'s sweep (HAN and RGCN, K = 1, 2, 4): the
    counters equal ``BENCH_hgnn.json``'s ``partition`` rows, the NA and
    ``gather_halo`` stages timed; ``bench_layers.py``'s halo rows (K = 4,
    L = 1, 2, 3); and ``bench_resilience.py``'s failover serve (HAN/imdb,
    fan-out 8, K = 3, partition 0 lost at step 3) against its never-failed
    twin and the row ``han/imdb/failover``."""
    import numpy as np
    import torch
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.core import characterize as ch
    from repro_torch.core.models import get_model
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_hgnn_infer, request_queue
    from repro_torch.serve.engine import HGNNInferEngine, HGNNServeEngine
    from repro_torch.serve.faults import Fault, FaultInjector
    from repro_torch.serve.sampler import HGNNSampler

    bench = json.loads((ROOT / "BENCH_hgnn.json").read_text())
    out = {"forwards": {}, "sweep": {}, "layers_halo": {}, "residency": {},
           "profiles": {}}
    halo_in = {}  # (model, relabeling variant) -> (part, FP output)
    errs: dict = {}
    for model, layers in PART_CASES:
        base = HGNNConfig(model=model, dataset="imdb", fused=True,
                          use_pallas=True, layers=layers)
        flat = build_hgnn_infer(base, hg, dev)
        flat_eng = HGNNInferEngine(flat.executor, flat.params, flat.batch,
                                   fn=flat.fn)
        flat_logits = flat_eng.infer()
        flat_ms = wall_ms(flat_eng)
        for k in PART_KS:
            tag = f"{model}/imdb K={k} L={layers}"
            t0 = time.perf_counter()
            b = build_hgnn_infer(base.replace(partitions=k), hg, dev)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            eng = HGNNInferEngine(b.executor, flat.params, b.batch, fn=b.fn)
            ops.reset_launch_counts()
            for _ in range(ITERS):
                logits = eng.infer()
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            want = dict.fromkeys(counts, 0)
            per = part_launches(model, layers, k)(b.batch)
            want.update({n: v * ITERS for n, v in per.items()})
            check(counts == want, f"{tag}: launches {counts} over {ITERS} "
                                  f"forwards")
            key = ("segment_spmm" if model == "rgcn" else
                   "gat_na" if model == "han" else "gat_na_unstacked")
            main_counts[key] += sum(want.values())
            check(tuple(logits.shape) == (4278, 8)
                  and bool(torch.isfinite(logits).all()),
                  f"{tag}: logits {tuple(logits.shape)} finite")
            # every row is reduced in an order that does not depend on K
            # (the kernels' slot order, SA's scores in global row order),
            # and cuBLAS keeps one order for these row counts
            bitwise = bool(torch.equal(logits, flat_logits))
            err = max_err(logits, flat_logits)
            check(bitwise, f"{tag}: bitwise the unpartitioned kernel arm "
                           f"(max |err| {err:.3e})")
            plain = get_model(base.replace(partitions=k, use_pallas=False))
            with torch.inference_mode():
                on_cpu = plain.forward(to_device(flat.params, "cpu"),
                                       to_device(b.batch, "cpu"))
            cpu_err = max_err(logits.cpu(), on_cpu)
            check(close(logits.cpu(), on_cpu, **TOL_CPU),
                  f"{tag}: vs the plain arm on the CPU, same partitioned "
                  f"batch: max |err| {cpu_err:.3e} (tol {TOL_CPU})")
            part_ms = wall_ms(eng)
            meta = b.batch["part"]["meta"]
            out["forwards"][tag] = {
                "wall_ms": part_ms, "unpartitioned_wall_ms": flat_ms,
                "build_s": build_s, "bitwise_vs_unpartitioned": bitwise,
                "max_abs_err_vs_unpartitioned": err,
                "max_abs_err_vs_cpu": cpu_err, "launches": per,
                "cut_edges": meta["cut_edges"],
                "edges_total": meta["edges_total"]}
            print(f"  {tag}: forward {part_ms:.4f} ms/iter wall "
                  f"(unpartitioned kernel arm {flat_ms:.4f}); host build "
                  f"with the partitioner {build_s:.2f} s; cut "
                  f"{meta['cut_edges']} of {meta['edges_total']} edges",
                  flush=True)
            if k == 4:
                calls = capture_served_calls(lambda: eager(b).fn(
                    flat.params, b.batch))
                got = {}
                for name, _ in calls:
                    got[name] = got.get(name, 0) + 1
                check(got == per, f"{tag}: one forward's captured kernel "
                                  f"calls {got} = its launches {per}")
                served_calls_vs_plain(tag, calls, errs, what="call")
                if layers == 1:
                    out["profiles"][tag] = profile_forward(eng, tag)
                    c = build_hgnn_infer(base.replace(
                        partitions=k, cache_rows=CACHE_ROWS), hg, dev)
                    with torch.inference_mode():
                        cached = c.fn(flat.params, c.batch)
                    ct = c.batch["residency"]["counters"]
                    check(torch.equal(cached, logits),
                          f"{tag} cache_rows={CACHE_ROWS}: bitwise the "
                          f"uncached run ({ct['hits']} of {ct['rows']} halo "
                          f"rows hot)")
                    out["residency"][tag] = ct
                    del c
            del b, eng
        del flat, flat_eng
        torch.cuda.empty_cache()
    results["partitioned_max_abs_err"] = errs

    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=dev)
    for model in ("han", "rgcn"):
        base = HGNNConfig(model=model, **PART_BENCH)
        flat = build_hgnn_infer(base, hg, dev)
        # the eager stages (fn.fn): a replay would add its output's copy
        fns = flat.executor.stage_fns(flat.params, flat.batch)
        with torch.inference_mode():
            na_flat = time_ms(lambda: fns["NA"][0].fn(*fns["NA"][1]), 20,
                              flush)
        print(f"  sweep {model}/imdb (max_degree 32) unpartitioned: NA "
              f"{na_flat:.5f} ms cold", flush=True)
        out["sweep"][f"{model}/imdb/unpartitioned"] = {"na_ms": na_flat}
        for k in PART_KS:
            b = build_hgnn_infer(base.replace(partitions=k), hg, dev)
            fns = b.executor.stage_fns(flat.params, b.batch)
            gh_fn, gh_args = fns["gather_halo"]
            gh_fn = gh_fn.fn
            tr = ch.partition_traffic(b.batch["part"], gh_args[0])
            got = {"cut_edges": tr["cut_edges"],
                   "cut_ratio": round(tr["cut_ratio"], 4),
                   "halo_rows": tr["halo_rows"],
                   "halo_bytes": tr["halo_bytes"]}
            row = bench["partition"][f"{model}/imdb/k{k}"]
            check(got == {n: row[n] for n in got},
                  f"partition {model}/imdb/k{k}: {got} equal "
                  f"BENCH_hgnn.json's")
            na_fn, na_args = fns["NA"]
            na_fn = na_fn.fn
            with torch.inference_mode():
                t = {"na_ms": time_ms(lambda: na_fn(*na_args), 20, flush),
                     "na_warm_ms": time_ms(lambda: na_fn(*na_args), 20),
                     "gather_halo_ms": time_ms(lambda: gh_fn(*gh_args), 20,
                                               flush),
                     "gather_halo_warm_ms": time_ms(lambda: gh_fn(*gh_args),
                                                    20)}
            out["sweep"][f"{model}/imdb/k{k}"] = {**got, **t}
            print(f"  sweep {model}/imdb/k{k}: NA {t['na_ms']:.5f} ms cold "
                  f"({t['na_warm_ms']:.5f} warm); gather_halo "
                  f"{t['gather_halo_ms']:.5f} ms cold "
                  f"({t['gather_halo_warm_ms']:.5f} warm), "
                  f"{tr['halo_rows']:.0f} halo rows", flush=True)
            if k == 4:
                halo_in[(model, 1)] = (b.batch["part"], gh_args[0])
            del b
        if model == "rgcn":  # L > 1 relabels every relation
            b = build_hgnn_infer(base.replace(partitions=4, layers=2), hg,
                                 dev)
            with torch.inference_mode():
                h_own = b.executor.fp(b.params, b.batch)
            halo_in[(model, 2)] = (b.batch["part"], h_own)
            del b
        for depth in (1, 2, 3):
            part, h_own = halo_in[(model, min(depth, 2) if model == "rgcn"
                                   else 1)]
            tr = ch.partition_traffic(part, h_own, layers=depth)
            got = {"k": float(tr["k"]), "layers": float(tr["layers"]),
                   "halo_bytes": tr["halo_bytes"],
                   "halo_bytes_total": tr["halo_bytes_total"],
                   "cut_edges": float(tr["cut_edges"])}
            row = bench["layers"][f"{model}/imdb/L{depth}"]["halo"]
            check(got == row, f"layers {model}/imdb/L{depth}/halo: {got} "
                              f"equal BENCH_hgnn.json's")
            out["layers_halo"][f"{model}/imdb/L{depth}"] = got
        del flat
    del halo_in
    torch.cuda.empty_cache()

    cfg = HGNNConfig(model="han", fanout=SERVE_FANOUT, partitions=3,
                     **PART_BENCH)
    b = build_hgnn_infer(cfg, hg, dev)
    sampler = HGNNSampler(b.plan, cfg, hg)
    runs = []
    # the failover serve, the never-failed one, and (phase 11) the failover
    # serve by the eager engine
    for inj, fn in ((FaultInjector([Fault(step=3, kind="partition",
                                          partition=0)]), b.fn),
                    (None, b.fn),
                    (FaultInjector([Fault(step=3, kind="partition",
                                          partition=0)]), eager(b).fn)):
        eng = HGNNServeEngine(b.executor, b.params, sampler, slots=8,
                              slot_targets=4, fn=fn, injector=inj)
        reqs = request_queue(sampler.n_target_type, 4, SERVE_REQUESTS,
                             pool=48)
        ops.reset_launch_counts()
        eng.warmup()
        eng.serve(reqs)
        torch.cuda.synchronize()
        runs.append((eng, reqs, ops.launch_counts()))
    ((eng, reqs, counts), (never, never_reqs, never_counts),
     (eager_eng, eager_reqs, eager_counts)) = runs
    st, rs = eng.stats(), eng.stats()["resilience"]
    got = {"bitexact": int(all(np.array_equal(a.logits, c.logits)
                               for a, c in zip(reqs, never_reqs))),
           "ok_requests": rs["ok_requests"],
           "partition_failovers": rs["partition_failovers"],
           "requests": len(reqs), "steps": st["steps"],
           "surviving_k": eng._serve_plan.partition.k}
    row = bench["resilience"]["han/imdb/failover"]
    diff = {n: (v, row[n]) for n, v in got.items() if row[n] != v}
    check(not diff, f"han/imdb failover serve (K=3, partition 0 lost at "
                    f"step 3): {got} equal BENCH_hgnn.json's "
                    f"han/imdb/failover row (differences: {diff})")
    rungs = [e["rung_index"] for e in eng.step_log]
    k_of_step = [3] * 3 + [2] * (len(rungs) - 3)
    want = 3 * len(sampler.ladder) + sum(k_of_step)
    check(counts["gat_na"] == want
          and never_counts["gat_na"] == 3 * (len(sampler.ladder)
                                             + never.stats()["steps"]),
          f"failover serve: stacked gat_na launches {counts['gat_na']} "
          f"(want {want}: K=3 over {len(sampler.ladder)} warmup rungs and "
          f"steps 0-2, K=2 after), never-failed {never_counts['gat_na']}")
    main_counts["gat_na"] += counts["gat_na"] + never_counts["gat_na"]
    new_shapes = len(set(rungs[3:]))
    check(rs["failed_steps"] == 0 and rs["retries"] == 0
          and st["compiles_after_warmup"] == new_shapes
          and never.stats()["compiles_after_warmup"] == 0,
          f"failover serve: failed_steps {rs['failed_steps']}, retries "
          f"{rs['retries']}, compiles_after_warmup "
          f"{st['compiles_after_warmup']} (the {new_shapes} rungs served at "
          f"K=2, as the reference's jit counts), never-failed "
          f"{never.stats()['compiles_after_warmup']}")
    # one capture a rung at K=3, and one a rung served at K=2 after it
    check(eng.fn.captures == len(sampler.ladder) + new_shapes
          and never.fn.captures == len(sampler.ladder)
          and all(np.array_equal(a.logits, c.logits)
                  for a, c in zip(reqs, eager_reqs))
          and eager_counts == counts
          and eager_eng.stats()["compiles_after_warmup"] == new_shapes,
          f"11 failover serve: {eng.fn.captures} captures "
          f"({len(sampler.ladder)} rungs at K=3 + {new_shapes} at K=2), "
          f"never-failed "
          f"{never.fn.captures}; logits bitwise the eager engine's failover "
          f"serve, the same launches ({eager_counts == counts}) and "
          f"compiles_after_warmup "
          f"({eager_eng.stats()['compiles_after_warmup']})")
    plain = get_model(cfg.replace(use_pallas=False))
    cpu_eng = HGNNServeEngine(
        plain.executor, to_device(b.params, "cpu"), sampler, slots=8,
        slot_targets=4,
        injector=FaultInjector([Fault(step=3, kind="partition",
                                      partition=0)]))
    cpu_reqs = request_queue(sampler.n_target_type, 4, SERVE_REQUESTS,
                             pool=48)
    cpu_eng.warmup()
    cpu_eng.serve(cpu_reqs)
    err = max(max_err(torch.from_numpy(r.logits), torch.from_numpy(c.logits))
              for r, c in zip(reqs, cpu_reqs))
    check(all(close(torch.from_numpy(r.logits), torch.from_numpy(c.logits),
                    **TOL_CPU) for r, c in zip(reqs, cpu_reqs))
          and cpu_eng.stats()["resilience"] == rs,
          f"failover serve vs the same serve on the CPU (plain arm): max "
          f"|err| {err:.3e} (tol {TOL_CPU}), resilience counters equal")
    fail = {}
    for name, e in (("failover", eng), ("never failed", never),
                    ("failover, eager", eager_eng)):
        walls = np.array([x["wall_s"] for x in e.step_log]) * 1e3
        fail[name] = {
            "step_wall_p50_ms": float(np.percentile(walls, 50)),
            "step_wall_p99_ms": float(np.percentile(walls, 99)),
            "sampler_ms": float(np.median([x["sample_s"] * 1e3
                                           for x in e.step_log])),
            "partition_ms": float(np.median([x["partition_s"] * 1e3
                                             for x in e.step_log])),
            "forward_ms": float(np.median([x["forward_s"] * 1e3
                                           for x in e.step_log]))}
        f = fail[name]
        print(f"  serve han/imdb K=3 ({name}): step wall p50 "
              f"{f['step_wall_p50_ms']:.3f} ms, p99 "
              f"{f['step_wall_p99_ms']:.3f} ms over {len(walls)} steps; "
              f"medians a step: sampler {f['sampler_ms']:.3f} ms, host "
              f"partitioner {f['partition_ms']:.3f} ms (inside) partition + "
              f"upload + forward + read-back {f['forward_ms']:.3f} ms",
              flush=True)
    out["failover"] = {"row": got, "steps": fail, "rungs": rungs,
                       "compiles_after_warmup": st["compiles_after_warmup"],
                       "captures": eng.fn.captures}
    del b, eng, never, cpu_eng, eager_eng
    torch.cuda.empty_cache()
    return out


# the async stage-graph schedule (phase 3o): benchmarks/bench_overlap.py's
# cases at its settings, HAN's csr layout, and the sampler-prefetch serves
OV_BENCH = dict(dataset="imdb", hidden=64, n_heads=8, n_classes=8,
                max_degree=32, fused=True, use_pallas=True)
# the reference's per-stage jit keys (src/repro/core/pipeline.py:941-996)
# of a one-layer metapath split and of the two-layer own/halo split, and
# the pairs of sibling stages each runs at once
OV_KEYS_METAPATHS = (("FP0", "NA.p0.0", "NA.p0.1", "SA0", "head"),
                     (("NA.p0.0", "NA.p0.1"),))
OV_KEYS_K4L2 = (("FP0", "FP1", "NA.merge0", "NA.merge1", "NA.own0",
                 "NA.own1", "SA0", "SA1", "halo_exchange", "head"),
                (("halo_exchange", "NA.own0"), ("halo_exchange", "NA.own1")))
# (BENCH_hgnn.json overlap row or a tag, model, config, main_counts key of
# the NA kernel the case launches, stage keys and sibling pairs)
OV_CASES = (("han/imdb/bucketed", "han", dict(degree_buckets=3),
             ("gat_na", "gat_na_bucketed"), OV_KEYS_METAPATHS),
            ("magnn/imdb/base", "magnn", {}, ("gat_na", "gat_na_unstacked"),
             OV_KEYS_METAPATHS),
            ("han/imdb/k4L2", "han", dict(partitions=4, layers=2),
             ("gat_na", "gat_na"), OV_KEYS_K4L2),
            ("rgcn/imdb/k4L2", "rgcn", dict(partitions=4, layers=2),
             ("segment_spmm", "segment_spmm"), OV_KEYS_K4L2),
            ("han/imdb/csr", "han", dict(fused=False),
             ("segment_sum", "segment_sum"), OV_KEYS_METAPATHS))
OV_REPS = 20  # forward walls a schedule, interleaved
OV_DAG_KEYS = ("depth", "stages", "edges", "concurrent_pairs",
               "overlapped_stages", "bitexact")


def stream_overlap(fn) -> dict:
    """One call of ``fn`` under torch.profiler: the device time of its
    kernels and copies summed, the time at least one ran, the time two or
    more ran at once (kernels of two streams overlapping), the streams
    they ran on, and the profiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace with no device event is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if evs:
            break
    else:
        fail_now("three profiles of an overlapped forward held no device "
                 "event")
    edges = sorted([(e.time_range.start, 1) for e in evs]
                   + [(e.time_range.end, -1) for e in evs])
    busy = both = 0.0
    live, last = 0, edges[0][0]
    for t, d in edges:
        if live >= 1:
            busy += t - last
        if live >= 2:
            both += t - last
        live, last = live + d, t
    return {"device_us": float(sum(e.time_range.end - e.time_range.start
                                   for e in evs)),
            "busy_us": float(busy), "overlapped_us": float(both),
            "busy_share": float(busy / wall) if wall else 0.0,
            "wall_us": float(wall), "kernels": len(evs),
            "streams": len({getattr(e, "device_resource_id", None)
                            for e in evs})}


def overlap_serve(tag, cfg, hg, dev, ov_counts: dict, out: dict,
                  injector=None) -> None:
    """One model served at ``--overlap 2`` (the sampler prefetch) on the
    CLI's queue, and the same queue without it on the same parameters:
    every request OK and bitwise the serve without prefetch, the same
    launches, no failed step or retry; the prefetch counters equal those
    of the same serve on the CPU (plain arm, prefetch on); the worker
    stopped; then two timed serves of ``SERVE_TIMED_REQUESTS`` requests
    each way, in turns, for the sampler's ms left on a step's path."""
    import numpy as np
    import torch
    from repro_torch.core.models import get_model
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_hgnn_infer, request_queue
    from repro_torch.serve.engine import HGNNServeEngine
    from repro_torch.serve.sampler import HGNNSampler

    b = build_hgnn_infer(cfg, hg, dev)
    sampler = HGNNSampler(b.plan, cfg, hg)
    no_pf = get_model(cfg.replace(overlap=0)).executor
    pool = 48 if injector is not None else None

    def serve(executor, n_req, fn=None, inj=None, params=None):
        eng = HGNNServeEngine(executor, b.params if params is None
                              else params, sampler, slots=SERVE_SLOTS,
                              slot_targets=SERVE_SLOT_TARGETS, fn=fn,
                              injector=inj() if inj else None)
        reqs = request_queue(sampler.n_target_type, SERVE_SLOT_TARGETS,
                             n_req, pool=pool)
        ops.reset_launch_counts()
        eng.warmup()
        eng.serve(reqs)
        torch.cuda.synchronize()
        return eng, reqs, ops.launch_counts()

    eng, reqs, counts = serve(b.executor, SERVE_REQUESTS, fn=b.fn,
                              inj=injector)
    ref, ref_reqs, ref_counts = serve(no_pf, SERVE_REQUESTS, inj=injector)
    st, rs = eng.stats(), eng.stats()["resilience"]
    same = all(a.status == c.status == "OK"
               and np.array_equal(a.logits, c.logits)
               for a, c in zip(reqs, ref_reqs))
    check(same and counts == ref_counts,
          f"{tag}: every request OK and bitwise the serve without prefetch, "
          f"launches {counts} the same")
    check(rs["failed_steps"] == 0 and rs["retries"] == 0
          and st["compiles_after_warmup"]
          == ref.stats()["compiles_after_warmup"],
          f"{tag}: failed_steps {rs['failed_steps']}, retries "
          f"{rs['retries']}, compiles_after_warmup "
          f"{st['compiles_after_warmup']} (without prefetch "
          f"{ref.stats()['compiles_after_warmup']})")
    cpu_eng, _, _ = serve(get_model(cfg.replace(use_pallas=False)).executor,
                          SERVE_REQUESTS, inj=injector,
                          params=to_device(b.params, "cpu"))
    pf, cpu_pf = st["prefetch"], cpu_eng.stats()["prefetch"]
    check(pf == cpu_pf and pf["hits"] > 0
          and pf["hits"] + pf["mispredicts"] + pf["cold"] == st["steps"],
          f"{tag}: prefetch {pf} equal the CPU serve's {cpu_pf}")
    check(eng.prefetch._future is None and eng.prefetch._pool._shutdown,
          f"{tag}: the prefetch worker drained and stopped")
    for name in ("gat_na_fused_sa", "semantic_combine", "segment_spmm"):
        ov_counts[name] += counts[name]
    ov_counts["gat_na"] += counts["gat_na"] - counts["gat_na_fused_sa"]
    timed = {"without": [], "with": []}
    if injector is None:
        for name in ("without", "with", "with", "without"):
            e, _, _ = serve(no_pf if name == "without" else b.executor,
                            SERVE_TIMED_REQUESTS,
                            fn=None if name == "without" else b.fn)
            timed[name].append(e)
    else:
        timed = {"without": [ref], "with": [eng]}
    rec = {"prefetch": pf, "launches": counts}
    for name, engines in timed.items():
        logs = [x for e in engines for x in e.step_log]
        walls = np.array([x["wall_s"] for x in logs]) * 1e3
        rec[name] = {"sampler_ms": float(np.median([x["sample_s"] * 1e3
                                                    for x in logs])),
                     "step_wall_p50_ms": float(np.percentile(walls, 50)),
                     "step_wall_p99_ms": float(np.percentile(walls, 99)),
                     "steps": len(logs)}
    a, w = rec["without"], rec["with"]
    print(f"  {tag}: sampler ms on a step's path (median) "
          f"{a['sampler_ms']:.3f} without prefetch -> {w['sampler_ms']:.3f} "
          f"with; step wall p50 {a['step_wall_p50_ms']:.3f} -> "
          f"{w['step_wall_p50_ms']:.3f} ms, p99 {a['step_wall_p99_ms']:.3f} "
          f"-> {w['step_wall_p99_ms']:.3f} ms ({w['steps']} steps); "
          f"prefetch {pf}", flush=True)
    out[tag] = rec
    del b, eng, ref, cpu_eng, timed
    torch.cuda.empty_cache()


def overlapped(hg, dev, main_counts: dict, results: dict) -> dict:
    """Phase 3o.  Per case of ``OV_CASES`` at ``bench_overlap.py``'s
    settings, on the overlapped build's batch and parameters: its logits
    through ``HGNNInferEngine`` (``build_hgnn_infer`` serves
    ``forward_overlapped``, each stage a CUDA graph replayed) bitwise the
    serial kernel arm's, ``depth=1`` bitwise with one stage in flight,
    launches over ITERS forwards (set to 0 just before, read just after)
    equal to the serial forward's kernel by kernel, the DAG counters and
    ``bitexact`` equal to ``BENCH_hgnn.json``'s ``overlap`` row, one
    capture a stage key with the reference's keys, each sibling pair's
    graphs captured on distinct capture streams with no scratch buffer in
    common, no capture and no scratch buffer made after the first
    forward, the eager walk (each cached stage's ``fn``) bitwise too;
    the forward walls of the eager and the captured overlapped forward,
    the eager serial forward and the captured one (``graphs.compiled``),
    median of ``OV_REPS`` each, in turns; the stage walls (replays) by
    CUDA events folded through ``characterize.overlap_accounting``, one
    profiled captured and one eager forward's kernels that overlap in
    time, and the merge NA's device time beside the serial partitioned
    NA's (the eager stages).  Then HAN/imdb and RGCN/imdb served at
    ``--overlap 2 --fanout 8`` and ``bench_resilience.py``'s failover serve
    with the prefetch on (:func:`overlap_serve`)."""
    import functools

    import numpy as np
    import torch
    from repro_torch import graphs
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.core import characterize as ch
    from repro_torch.core.models import get_model
    from repro_torch.kernels import build, ops
    from repro_torch.launch.serve import build_hgnn_infer
    from repro_torch.serve.engine import HGNNInferEngine
    from repro_torch.serve.faults import Fault, FaultInjector

    bench = json.loads((ROOT / "BENCH_hgnn.json").read_text())["overlap"]
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=dev)
    out = {"forwards": {}, "serves": {}}
    ov_counts = dict.fromkeys(main_counts, 0)  # this phase's launches
    card = card_line()
    for case, model, kw, (kernel, key), (want_keys, siblings) in OV_CASES:
        tag = f"overlap {case}"
        cfg = HGNNConfig(model=model, overlap=2, **dict(OV_BENCH, **kw))
        b = build_hgnn_infer(cfg, hg, dev)
        eng = HGNNInferEngine(b.executor, b.params, b.batch, fn=b.fn)
        check(b.fn == b.executor.forward_overlapped,
              f"{tag}: build_hgnn_infer serves forward_overlapped")
        serial_ex = get_model(cfg.replace(overlap=0)).executor
        depth1 = get_model(cfg.replace(overlap=1)).executor
        serial_c = graphs.compiled(serial_ex.forward)

        def serial():
            return serial_ex.forward(b.params, b.batch)

        def serial_captured():
            return serial_c(b.params, b.batch)

        ops.reset_launch_counts()
        with torch.inference_mode():
            want = serial()
        torch.cuda.synchronize()
        per = ops.launch_counts()
        logits = eng.infer()
        ov = b.executor._ov_jit
        caps = {k: c.captures for k, c in ov.items()}
        check(sorted(ov) == sorted(want_keys)
              and all(n == len(ov[k].graphs) == 1 for k, n in caps.items()),
              f"{tag}: one capture a stage key {caps}, the reference's "
              f"keys {sorted(want_keys)}")
        for a, c in siblings:
            (g_a,), (g_c,) = ov[a].graphs.values(), ov[c].graphs.values()
            shared = ({id(x) for x in g_a.scratch}
                      & {id(x) for x in g_c.scratch})
            check(g_a.stream is not g_c.stream
                  and ov[a].stream != ov[c].stream and not shared,
                  f"{tag}: siblings {a} and {c} captured on capture streams "
                  f"{ov[a].stream} and {ov[c].stream}, {len(g_a.scratch)} "
                  f"and {len(g_c.scratch)} scratch buffers, "
                  f"{len(shared)} in common")
        with torch.inference_mode():
            one = depth1.forward_overlapped(b.params, b.batch)
        # each executor owns its side streams, each branch its capture
        # stream, and a stream its scratch
        made = build.created
        ops.reset_launch_counts()
        for _ in range(ITERS):
            logits = eng.infer()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(build.created == made,
              f"{tag}: no scratch buffer made after the first overlapped "
              f"forward ({build.created - made} made)")
        check({k: c.captures for k, c in ov.items()} == caps,
              f"{tag}: no capture after the first overlapped forward")
        check(counts == {n: v * ITERS for n, v in per.items()}
              and per[kernel] > 0,
              f"{tag}: launches {counts} over {ITERS} forwards = the serial "
              f"forward's {per} x {ITERS}")
        ov_counts[key] += counts[kernel]
        bitwise = bool(torch.equal(logits, want))
        check(bitwise and tuple(logits.shape) == (4278, 8),
              f"{tag}: overlapped logits bitwise the serial kernel arm's "
              f"(max |err| {max_err(logits, want):.3e})")
        check(torch.equal(one, want)
              and depth1.last_dispatch["max_inflight"] == 1,
              f"{tag}: depth=1 bitwise, max_inflight "
              f"{depth1.last_dispatch['max_inflight']}")
        # the eager walk: the same schedule over each cached stage's fn
        eager_ex = get_model(cfg).executor
        eager_ex._ov_jit = {k: c.fn for k, c in ov.items()}

        def eager_overlapped():
            return eager_ex.forward_overlapped(b.params, b.batch)

        with torch.inference_mode():
            check(torch.equal(eager_overlapped(), want)
                  and torch.equal(serial_captured(), want),
                  f"{tag}: the eager walk and the captured serial forward "
                  f"bitwise the serial kernel arm")
        rec = dict(b.executor.overlap_record(), bitexact=int(bitwise))
        rec.pop("pairs")
        if case in bench:
            row = {k: bench[case][k] for k in OV_DAG_KEYS}
            got = {k: rec[k] for k in OV_DAG_KEYS}
            check(got == row, f"{tag}: {got} equal BENCH_hgnn.json's "
                              f"overlap row")
        turns = (("eager_overlapped", eager_overlapped),
                 ("overlapped", eng.infer), ("eager_serial", serial),
                 ("serial", serial_captured))
        walls = {name: [] for name, _ in turns}
        with torch.inference_mode():
            for _ in range(3):
                for _, fn in turns:
                    fn()
            for _ in range(OV_REPS):
                for name, fn in turns:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls[name].append((time.perf_counter() - t0) * 1e3)
        med = {n: float(np.median(v)) for n, v in walls.items()}
        # the host time a stage call spends on its signature: every leaf
        # of params and batch described (ov["FP0"]'s own arguments)
        t0 = time.perf_counter()
        for _ in range(200):
            ov["FP0"]._leaves((b.params, b.batch))
        sign_us = (time.perf_counter() - t0) / 200 * 1e6
        fns = b.executor.overlap_stage_fns(b.params, b.batch)
        with torch.inference_mode():
            stage_us = {n: ch.stage_time_us(functools.partial(f, *a))
                        for n, (f, a) in fns.items()}
            acct = ch.overlap_accounting(b.executor.schedule_edges(),
                                         stage_us)
            prof = stream_overlap(eng.infer)
            prof_eager = stream_overlap(eager_overlapped)
        rec.update(wall_ms=med, stage_us=stage_us, accounting=acct,
                   profile=prof, profile_eager=prof_eager, launches=per,
                   captures=caps, signature_us=sign_us, card=card)
        if "partitions" in kw:
            sfns = serial_ex.stage_fns(b.params, b.batch)
            with torch.inference_mode():
                merge = fns["L1.NA"]
                rec["merge_na_ms"] = time_ms(
                    lambda: merge[0].fn(*merge[1]), 20, flush)
                own = fns["L1.NA.own"]
                rec["own_na_ms"] = time_ms(lambda: own[0].fn(*own[1]), 20,
                                           flush)
                na = sfns["L1.NA"]
                rec["serial_na_ms"] = time_ms(lambda: na[0].fn(*na[1]), 20,
                                              flush)
            print(f"  {tag}: L1 NA device time cold: merge "
                  f"{rec['merge_na_ms']:.5f} ms + NA.own "
                  f"{rec['own_na_ms']:.5f} ms, serial partitioned NA "
                  f"{rec['serial_na_ms']:.5f} ms", flush=True)
        print(f"  {tag}: forward wall median of {OV_REPS} in turns: "
              f"overlapped eager {med['eager_overlapped']:.4f} ms, captured "
              f"{med['overlapped']:.4f} ms; serial eager "
              f"{med['eager_serial']:.4f} ms, captured {med['serial']:.4f} "
              f"ms ({card}); {sum(caps.values())} stage graphs, "
              f"{sign_us:.1f} us of host time to sign params and batch a "
              f"stage; stages "
              f"{rec['stages']}, concurrent pairs {rec['concurrent_pairs']}; "
              f"stage walls (replays): serial sum "
              f"{acct['serial_sum_us']:.1f} us, critical path "
              f"{acct['critical_path_us']:.1f} us, saved "
              f"{acct['overlap_saved_us']:.1f} us", flush=True)
        for name, pr in (("captured", prof), ("eager", prof_eager)):
            print(f"  {tag}: profiled {name} overlapped forward: "
                  f"{pr['kernels']} device events on {pr['streams']} "
                  f"streams, {pr['overlapped_us']:.1f} us with two or more "
                  f"at once, busy {pr['busy_us']:.1f} of "
                  f"{pr['wall_us']:.1f} us "
                  f"({100 * pr['busy_share']:.1f}%)", flush=True)
        out["forwards"][case] = rec
        del b, eng, serial_ex, depth1, fns, serial_c, eager_ex, ov
        gc.collect()  # an executor and its compiled stages are a cycle
        torch.cuda.empty_cache()

    serve_cfg = dict(dataset="imdb", fused=True, use_pallas=True,
                     fanout=SERVE_FANOUT, overlap=2)
    overlap_serve("serve han/imdb --overlap 2",
                  HGNNConfig(model="han", fuse_na_sa=True, **serve_cfg), hg,
                  dev, ov_counts, out["serves"])
    overlap_serve("serve rgcn/imdb bucketed 3 --overlap 2",
                  HGNNConfig(model="rgcn", degree_buckets=3, **serve_cfg),
                  hg, dev, ov_counts, out["serves"])
    overlap_serve("failover serve han/imdb K=3 --overlap 2",
                  HGNNConfig(model="han", fanout=SERVE_FANOUT, partitions=3,
                             overlap=2, **PART_BENCH), hg, dev, ov_counts,
                  out["serves"],
                  injector=lambda: FaultInjector([Fault(
                      step=3, kind="partition", partition=0)]))
    for name, n in ov_counts.items():
        main_counts[name] += n
    out["launches"] = {n: v for n, v in ov_counts.items() if v}
    print(f"  phase 3o launches on its main paths: {out['launches']}",
          flush=True)
    del flush
    torch.cuda.empty_cache()
    return out


# LM serving (granite-8b): its two kernels, the 2-layer full-width arm
# check, the 36-layer serve, and their timing
GRANITE = "granite-8b"
LM_PROMPT, LM_NEW, LM_SLOTS = 2048, 32, 4  # the served wave
TOL_ATTN = {"float32": dict(atol=2e-4, rtol=2e-4),  # tests/test_kernels.py
            "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# a bf16 output against the fp32 computation cast to bf16: one bf16 ulp
# (at most 2^-7 of the value) apart where the two fp32 sums round apart
TOL_BF16_OUT = dict(atol=1e-3, rtol=8e-3)
TOL_LM = dict(atol=1e-4, rtol=1e-4)  # 2 layers fp32: kernel vs plain arm
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak


def attn_inputs(gen, b, s, h, kvh, dh, dtype, decode=False, sk=None):
    """q, k, v drawn on the card: ``N(0, 1)``, the scale of RoPE'd
    projections of RMS-normed activations; k and v of ``sk`` rows (the
    cross form) or ``s``."""
    import torch

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(dtype)

    q = draw(b, h, dh) if decode else draw(b, s, h, dh)
    sk = s if sk is None else sk
    return q, draw(b, sk, kvh, dh), draw(b, sk, kvh, dh)


def lm_kernels_vs_plain(dev) -> dict:
    """Both kernels against their plain versions at the main path's
    shapes, and twice on the same input for the same bits.  A bf16 case is
    held twice: against the plain version on the same bf16 inputs at the
    reference's bf16 tolerance, and against the plain version on the fp32
    upcasts, cast to bf16, at the rounding of a bf16 output (the kernels
    compute in fp32, so that reference is exact for bf16 inputs)."""
    import torch
    from repro_torch.kernels import decode_attention as tdec
    from repro_torch.kernels import flash_attention as tflash

    gen = torch.Generator(device=dev).manual_seed(15)
    out = {}

    def hold(name, tag, dt, fn, plain, args, again):
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(close(got.float(), want.float(), **TOL_ATTN[dt]),
              f"{name} {tag} vs plain: max |err| {err:.3e} "
              f"(tol {TOL_ATTN[dt]})")
        rec = {"case": tag, "max_abs_err": err}
        if dt == "bfloat16":
            up = [a.float() if a.is_floating_point() else a for a in args]
            exact = plain(*up).to(got.dtype)
            err_up = max_err(got, exact)
            check(close(got.float(), exact.float(), **TOL_BF16_OUT),
                  f"{name} {tag} vs plain on the fp32 upcasts, cast to "
                  f"bf16: max |err| {err_up:.3e} (tol {TOL_BF16_OUT})")
            rec["vs_fp32_plain_max_abs_err"] = err_up
            del exact
        check(torch.equal(got, again()),
              f"{name} {tag}: two runs give the same bits")
        out.setdefault(name, {"max_abs_err": err, "tolerance": TOL_ATTN[dt],
                              "checked": []})
        out[name]["checked"].append(rec)

    cases = [  # (tag, B, S, H, KVH, Dh, causal, window, dtype[, Sk])
        ("granite prefill bf16", 4, 2048, 32, 8, 128, True, 0, "bfloat16"),
        ("granite prefill fp32", 1, 2048, 32, 8, 128, True, 0, "float32"),
        ("danube window 4096 bf16", 1, 4608, 32, 8, 120, True, 4096,
         "bfloat16"),
        ("danube window 4096 fp32", 1, 4608, 32, 8, 120, True, 4096,
         "float32"),
        ("granite tail S=2000 fp32", 1, 2000, 32, 8, 128, True, 0,
         "float32"),
        # zamba2's shared block (phase 7b): no GQA, Dh 64, the bf16
        # kernel's m64n64k16 P.V branch
        ("zamba2 prefill bf16", 4, 2048, 32, 32, 64, True, 0, "bfloat16"),
    ]
    for dt in ("bfloat16", "float32"):  # phase 8's shapes
        cases += [
            # internvl2's prefill: 256 embeddings + 1024 tokens, G 8
            (f"internvl2 prefill {dt}", 4, 1280, 64, 8, 128, True, 0, dt),
            # seamless's encoder: bidirectional, Dh 64, no GQA
            (f"seamless encoder {dt}", 4, 1024, 16, 16, 64, False, 0, dt),
            # the cross form: the decoder's queries over the encoder's
            # keys, ragged, and fewer keys than queries
            (f"seamless cross {dt}", 4, 256, 16, 16, 64, False, 0, dt, 1024),
            (f"cross ragged {dt}", 4, 130, 16, 16, 64, False, 0, dt, 1000),
            (f"cross Sk < Sq {dt}", 4, 1024, 16, 16, 64, False, 0, dt, 200),
        ]
    cases += [  # phase 8b's seamless prefill: the 2-token target prefix,
        # causal, and its cross form over the 1024 frames (2 of a q tile's
        # 64 rows live)
        ("seamless prefix S=2 bfloat16", 4, 2, 16, 16, 64, True, 0,
         "bfloat16"),
        ("seamless prefix cross bfloat16", 4, 2, 16, 16, 64, False, 0,
         "bfloat16", 1024),
    ]
    granite_len = (1, 1000, 2049, 2080)
    decode_cases = [  # (tag, cache B, S, H, KVH, Dh, dtype, kv_len)
        ("granite", 4, 2080, 32, 8, 128, "bfloat16", granite_len),
        ("granite", 4, 2080, 32, 8, 128, "float32", granite_len),
        ("zamba2", 4, 2080, 32, 32, 64, "bfloat16", granite_len),
        # phase 8b's internvl2 after its 1280-row prefill: G 8, the
        # kernel's two-pass branch
        ("internvl2", 4, 1312, 64, 8, 128, "bfloat16", (1, 700, 1281, 1312)),
        # phase 5e's danube ring of 4096 rows (wrapped: every row live)
        ("danube ring", 4, 4096, 32, 8, 120, "bfloat16",
         (1, 2049, 4095, 4096)),
        # phase 8b's seamless decoder self-attention: 2 + 64 rows
        ("seamless", 4, 66, 16, 16, 64, "bfloat16", (1, 2, 33, 66)),
    ]
    with torch.inference_mode():
        for tag, b, s, h, kvh, dh, causal, window, dt, *sk in cases:
            q, k, v = attn_inputs(gen, b, s, h, kvh, dh, getattr(torch, dt),
                                  sk=sk[0] if sk else None)

            def flash(q, k, v, fn=tflash.flash_attention):
                return fn(q, k, v, causal=causal, window=window)

            def flash_plain(q, k, v):
                return flash(q, k, v, fn=tflash.flash_attention_plain)

            hold("flash_attention", f"{tag} {tuple(q.shape)}"
                 + (f" over k/v {tuple(k.shape)}" if sk else ""), dt, flash,
                 flash_plain, (q, k, v), lambda: flash(q, k, v))
            del q, k, v
        for tag, b, s, h, kvh, dh, dt, lens in decode_cases:
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            q, k, v = attn_inputs(gen, b, s, h, kvh, dh, getattr(torch, dt),
                                  decode=True)
            hold("decode_attention",
                 f"{tag} {dt} q {tuple(q.shape)} cache {tuple(k.shape)} "
                 f"kv_len {kv_len.tolist()}", dt, tdec.decode_attention,
                 tdec.decode_attention_plain, (q, k, v, kv_len),
                 lambda: tdec.decode_attention(q, k, v, kv_len))
            del q, k, v
    return out


def teacher_forced(tf, params, cfg, prompts, feed, max_len,
                   extra_embeds=None):
    """Prefill on ``prompts [B, T0]`` (after ``extra_embeds [B, E, d]``,
    if given), then one decode step per column of ``feed [B, N]``: the
    ``1 + N`` steps' logits ``[1 + N, B, V]``, fp32."""
    import torch

    t0 = prompts.shape[1] + (0 if extra_embeds is None
                             else extra_embeds.shape[1])
    with torch.inference_mode():
        lg, pf = tf.lm_prefill(params, cfg, prompts,
                               extra_embeds=extra_embeds)
        caches = tf.graft_prefill_caches(
            cfg, tf.init_kv_caches(cfg, prompts.shape[0], max_len,
                                   prompts.device), pf, t0)
        del pf
        steps = [lg[:, 0].float()]
        for i in range(feed.shape[1]):
            lg, caches = tf.lm_decode_step(params, cfg, feed[:, i:i + 1],
                                           caches, t0 + i)
            steps.append(lg[:, 0].float())
    return torch.stack(steps)


def teacher_forced_encdec(ed, params, cfg, frames, prefix, feed, max_len):
    """``encdec_prefill`` on ``frames`` and ``prefix [B, T0]``, then one
    ``encdec_decode_step`` per column of ``feed [B, N]``: the ``1 + N``
    steps' logits ``[1 + N, B, V]``, fp32."""
    import torch

    t0 = prefix.shape[1]
    with torch.inference_mode():
        lg, pf = ed.encdec_prefill(params, cfg, frames, prefix)
        caches = ed.graft_encdec_caches(cfg, pf, max_len)
        del pf
        steps = [lg[:, 0].float()]
        for i in range(feed.shape[1]):
            lg, caches = ed.encdec_decode_step(params, cfg, feed[:, i:i + 1],
                                               caches, t0 + i)
            steps.append(lg[:, 0].float())
    return torch.stack(steps)


def arms_vs_tokens(tag, kern_arm, plain_arm, toks) -> dict:
    """The kernel arm replayed teacher-forced on a served wave's tokens
    ``toks [B, N]`` (``kern_arm()`` -> logits ``[N, B, V]``, the served
    computation, so its argmax must give those tokens), then the plain arm
    on the same tokens, where there is one: their largest logit difference
    and argmax agreement, recorded, not gated."""
    import torch

    kern = kern_arm()
    check(bool(torch.isfinite(kern).all()),
          f"{tag}: all {tuple(kern.shape)} teacher-forced logits finite")
    check(torch.equal(kern.argmax(dim=-1).T, toks),
          f"{tag}: the kernel arm's teacher-forced argmax gives the served "
          "tokens")
    if plain_arm is None:
        return {"logits_plain_vs_kernel_max_abs_err": None,
                "argmax_agreement": None}
    plain = plain_arm()
    err = max_err(kern, plain)
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"  {tag}: logits kernel arm vs plain arm (teacher-forced, bf16, "
          f"recorded, not gated): max |err| {err:.4e} of max |logit| "
          f"{float(plain.abs().max()):.3f}; argmax agreement {agree:.4f}")
    return {"logits_plain_vs_kernel_max_abs_err": err,
            "argmax_agreement": agree}


def arms_two_layers(dev, ops, cfg, tag: str, flash: int, decode: int
                    ) -> dict:
    """``cfg`` (full width, 2 layers, fp32): the kernel arm against the
    plain arm on the same weights, prefill of 2 x 1536 tokens then 8 decode
    steps teacher-forced on the same tokens; ``flash`` flash_attention
    launches a prefill and ``decode`` decode_attention launches a step."""
    import torch
    from repro_torch.nn import transformer as tf

    params = tf.init_lm_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    rng = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 1536 + 8), generator=rng,
                         device=dev)
    prompts, forced = toks[:, :1536], toks[:, 1536:]  # 8 decode steps
    plain = teacher_forced(tf, params, cfg, prompts, forced, 1544)
    ops.reset_launch_counts()
    kern = teacher_forced(tf, params, cfg.replace(use_pallas=True), prompts,
                          forced, 1544)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts == dict(dict.fromkeys(counts, 0), flash_attention=flash,
                         decode_attention=decode * 8),
          f"{tag} 2-layer fp32 kernel arm: launches {counts} (want {flash} "
          f"flash_attention, {decode * 8} decode_attention)")
    err = max_err(kern, plain)
    check(bool(torch.isfinite(kern).all()) and close(kern, plain, **TOL_LM),
          f"{tag} 2-layer fp32 (d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, Dh {cfg.resolved_head_dim}, prefill "
          f"2x1536 + 8 teacher-forced steps): logits kernel arm vs "
          f"plain arm max |err| {err:.3e} of max |logit| "
          f"{float(plain.abs().max()):.3f} (tol {TOL_LM})")
    del params
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "tolerance": TOL_LM, "launches": counts}


def granite_two_layers(dev, ops) -> dict:
    """granite-8b at full width, 2 layers, fp32: the kernel arm against the
    plain arm (``arms_two_layers``)."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(GRANITE).replace(n_layers=2, dtype="float32",
                                      param_dtype="float32")
    return arms_two_layers(dev, ops, cfg, "granite", 2, 2)


def granite_serve(dev, ops, profiles: dict) -> dict:
    """granite-8b, full config (36 layers, bf16), through
    ``ServeEngine.generate`` (``lm_serve``)."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(GRANITE).replace(use_pallas=True)
    return lm_serve(dev, ops, profiles, cfg, "granite", cfg.n_layers,
                    eager_check=True)


DANUBE = "h2o-danube-3-4b"
DANUBE_PROMPT = 4608  # past the 4096 window: the ring cache wraps


def danube_serve(dev, ops, profiles: dict) -> dict:
    """h2o-danube3-4b whole (24 layers, bf16, sliding window 4096) through
    ``ServeEngine.generate`` (``lm_serve``) with prompts of
    ``DANUBE_PROMPT`` tokens: the prefill's windowed kernel, the graft into
    a ring of 4096 rows that has wrapped, and 31 decode steps over it."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(DANUBE).replace(use_pallas=True)
    ring = min(DANUBE_PROMPT + LM_NEW, cfg.sliding_window)
    check(ring < DANUBE_PROMPT,
          f"danube: a ring of {ring} cache rows for {DANUBE_PROMPT}-token "
          f"prompts (window {cfg.sliding_window}): the graft wraps it")
    rec = lm_serve(dev, ops, profiles, cfg, "danube", cfg.n_layers,
                   prompt_len=DANUBE_PROMPT)
    rec.update(ring_rows=ring, prompt_len=DANUBE_PROMPT)
    return rec


class DecodeStepAsForward:
    """One decode step of ``cfg`` on a grafted 4 x 2048 prompt, as a
    ``profile_forward`` "engine": each ``infer()`` runs the step at the
    same position (it rewrites the same cache row); with ``compiled``
    through ``graphs.compiled``, as ``ServeEngine`` runs it (the token and
    caches held, one capture, then replays)."""

    def __init__(self, params, cfg, prompts, compiled: bool = False):
        import torch
        from repro_torch import graphs
        from repro_torch.nn import transformer as tf

        self.params = params

        def step(p, t, c, pos):
            return tf.lm_decode_step(p, cfg, t, c, pos)

        self.step = graphs.compiled(step) if compiled else step
        t0 = prompts.shape[1]
        with torch.inference_mode():
            lg, pf = tf.lm_prefill(params, cfg, prompts)
            self.caches = tf.graft_prefill_caches(
                cfg, tf.init_kv_caches(cfg, prompts.shape[0], t0 + LM_NEW,
                                       prompts.device), pf, t0)
        self.token = lg[:, 0].argmax(dim=-1)[:, None]
        # a captured step takes its position from the card, as the engine's
        self.pos = (torch.tensor(t0, device=prompts.device) if compiled
                    else t0)

    def infer(self):
        import torch

        with torch.inference_mode():
            self.step(self.params, self.token, self.caches, self.pos)


def busy_shares(tag, prefill, step, profiles: dict) -> dict:
    """One profiled prefill and five profiled decode steps (after warm-ups):
    their busy shares."""
    import torch

    def quiet(fn):
        def run():
            with torch.inference_mode():
                fn()
        return types.SimpleNamespace(infer=run)

    out = {}
    for name, key, fn, reps, warmup in (
            ("prefill", "prefill", prefill, 1, 1),
            ("decode step", "decode", step, 5, 2)):
        prof = profile_forward(quiet(fn), f"{tag} {name}", reps=reps,
                               warmup=warmup)
        profiles[f"{tag} {name}"] = prof
        out[f"{key}_busy_share"] = prof["device_busy_ms"] / prof["wall_ms"]
    return out


def lm_serve(dev, ops, profiles: dict, cfg, tag: str, attn_layers: int,
             sampled: bool = False, prompt_len: int = LM_PROMPT,
             eager_check: bool = False) -> dict:
    """``cfg`` (``use_pallas``) through ``ServeEngine.generate``: 4 requests
    of ``prompt_len``-token prompts and 32 greedy tokens, twice; exact
    launch counts (``attn_layers`` flash_attention a prefill and
    decode_attention a step); one decode capture (one wave size); the peak
    memory; the plain arm teacher-forced on the kernel arm's tokens where
    there is attention (``arms_vs_tokens``); a profiled prefill and decode
    step, eager and captured (busy share, top device ops); with
    ``eager_check`` phase 11's ``decode_vs_eager``; with ``sampled`` one
    more wave on the same weights, sampled at a temperature
    (``sampled_wave``)."""
    import numpy as np
    import torch
    from repro_torch.nn import transformer as tf
    from repro_torch.serve.engine import Request, ServeEngine

    t0 = time.perf_counter()
    params = tf.init_lm_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    torch.cuda.synchronize()
    n_params = tf.param_count(params)
    print(f"  {cfg.name}: {cfg.n_layers} layers "
          f"{tf.layer_runs(cfg)}, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, Dh "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.param_dtype}: {n_params} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; memory allocated "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
               for _ in range(LM_SLOTS)]
    max_len = prompt_len + LM_NEW
    engine = ServeEngine(cfg, params, batch_slots=LM_SLOTS, max_len=max_len)
    runs, counts = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        ops.reset_launch_counts()
        done = engine.generate([Request(prompt=p, max_tokens=LM_NEW)
                                for p in prompts])
        torch.cuda.synchronize()
        counts.append(ops.launch_counts())
        runs.append([r.out_tokens for r in done])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = LM_NEW - 1
    for i, c in enumerate(counts):
        check(c == dict(dict.fromkeys(c, 0), flash_attention=attn_layers,
                        decode_attention=attn_layers * steps),
              f"{tag} serve run {i}: launches {c} (want {attn_layers} "
              f"flash_attention a prefill, {attn_layers} decode_attention "
              f"a step x {steps} steps)")
    toks = runs[0]
    check(all(len(t) == LM_NEW and all(0 <= x < cfg.vocab for x in t)
              for t in toks),
          f"{tag} serve: {LM_SLOTS} x {LM_NEW} token ids in [0, "
          f"{cfg.vocab})")
    check(runs[1] == toks, f"{tag} serve: the same tokens on a second run")
    dec = engine._decode
    check(dec.captures == 1 and dec.replays == 2 * steps - 1,
          f"{tag} serve: {dec.captures} decode capture (one wave size), "
          f"{dec.replays} replays (want {2 * steps - 1})")
    timings = engine.timings[1]
    prefill_ms = timings["prefill_s"] * 1e3
    decode_ms = timings["decode_s"] * 1e3 / max(timings["decode_steps"], 1)
    n_tok = LM_SLOTS * LM_NEW
    wall = timings["prefill_s"] + timings["decode_s"]
    print(f"  {tag} serve (run 2): prefill {LM_SLOTS}x{prompt_len} "
          f"{prefill_ms:.2f} ms to the first token; decode "
          f"{decode_ms:.3f} ms a token (one step of {LM_SLOTS} slots); "
          f"{n_tok} tokens "
          f"in {wall:.3f} s ({n_tok / wall:.1f} tok/s); run 1: prefill "
          f"{engine.timings[0]['prefill_s'] * 1e3:.2f} ms, decode "
          f"{engine.timings[0]['decode_s'] * 1e3 / steps:.3f} ms a step; "
          f"peak memory allocated {peak:.2f} GiB")
    print(f"  tokens req0: {toks[0]}")

    tp = torch.as_tensor(np.stack(prompts), device=dev)
    tt = torch.as_tensor(toks, device=dev)

    def arm(c):
        return lambda: teacher_forced(tf, params, c, tp, tt[:, :-1], max_len)

    arms = arms_vs_tokens(f"{tag} serve", arm(cfg),
                          arm(cfg.replace(use_pallas=False))
                          if attn_layers else None, tt)
    step = DecodeStepAsForward(params, cfg, tp)
    busy = busy_shares(tag, lambda: tf.lm_prefill(params, cfg, tp),
                       step.infer, profiles)
    del step
    step = DecodeStepAsForward(params, cfg, tp, compiled=True)
    prof = profile_forward(step, f"{tag} captured decode step", reps=5,
                           warmup=2)
    profiles[f"{tag} captured decode step"] = prof
    busy["captured_decode_busy_share"] = (prof["device_busy_ms"]
                                          / prof["wall_ms"])
    del step
    rec = {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
           "tokens_per_s": n_tok / wall, "tokens": n_tok,
           "run1": engine.timings[0], "run2": timings,
           **arms, "launches": counts[0],
           "decode_captures": dec.captures,
           "params": n_params, "peak_gib": peak, **busy}
    if eager_check:
        rec["compiled"] = decode_vs_eager(tag, engine, params, cfg, prompts,
                                          max_len, ops, rec)
    if sampled:
        rec["sampled"] = sampled_wave(dev, cfg, params)
    return rec


def eager_wave(params, cfg, prompts, max_len: int, n_new: int):
    """The engine's greedy wave as the eager loop the compiled decode step
    replaced: prefill, graft into fresh caches, then ``lm_decode_step``,
    argmax and a read-back each step.  Returns the tokens, every decode
    step's logits and the decode ms a step (host clock, from the first
    token to the last read-back)."""
    import numpy as np
    import torch
    from repro_torch.nn import transformer as tf

    dev = params["embed"].device
    b, t0 = len(prompts), max(len(p) for p in prompts)
    toks = np.zeros((b, t0), np.int32)
    for i, p in enumerate(prompts):
        toks[i, t0 - len(p):] = p
    with torch.inference_mode():
        lg, pf = tf.lm_prefill(params, cfg, torch.from_numpy(toks).to(dev))
        caches = tf.graft_prefill_caches(
            cfg, tf.init_kv_caches(cfg, b, max_len, dev), pf, t0)
        del pf
        cur = torch.argmax(lg[:, 0], dim=-1)
        outs = [[t] for t in cur.tolist()]
        t1 = time.perf_counter()
        pos = torch.tensor(t0, device=dev)
        logits = []
        for _ in range(n_new - 1):
            lg, caches = tf.lm_decode_step(params, cfg, cur[:, None], caches,
                                           pos)
            pos = pos + 1
            logits.append(lg)
            cur = torch.argmax(lg[:, 0], dim=-1)
            for o, t in zip(outs, cur.tolist()):
                o.append(t)
        ms = (time.perf_counter() - t1) * 1e3 / (n_new - 1)
    return outs, logits, ms


def decode_vs_eager(tag, engine, params, cfg, prompts, max_len: int, ops,
                    rec: dict) -> dict:
    """Phase 11 on the LM decode: the engine's greedy wave (its decode step
    captured) against ``eager_wave`` in turns (eager, captured, captured,
    eager): tokens and every decode step's logits bitwise, the same
    launches, decode ms a step of each; the captured step's busy share
    from ``rec``."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import Request

    dec = engine._decode
    seen = []

    def recorded(*a):
        out = dec(*a)
        seen.append(out[0])
        return out

    ms = {"eager": [], "captured": []}
    toks, logits, counts = {}, {}, {}
    for i, arm in enumerate(("eager", "captured", "captured", "eager")):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        if arm == "eager":
            t, lg, step_ms = eager_wave(params, cfg, prompts, max_len,
                                        LM_NEW)
        else:
            seen.clear()
            engine._decode = recorded
            try:
                done = engine.generate([Request(prompt=p, max_tokens=LM_NEW)
                                        for p in prompts])
            finally:
                engine._decode = dec
            t, lg = [r.out_tokens for r in done], list(seen)
            tm = engine.timings[-1]
            step_ms = tm["decode_s"] * 1e3 / tm["decode_steps"]
        torch.cuda.synchronize()
        ms[arm].append(step_ms)
        if arm not in toks:
            toks[arm], logits[arm] = t, lg
            counts[arm] = ops.launch_counts()
        check(t == toks[arm], f"11 {tag} {arm} wave {i}: the same tokens")
    same = (len(logits["eager"]) == len(logits["captured"]) == LM_NEW - 1
            and all(torch.equal(a, c) for a, c in
                    zip(logits["eager"], logits["captured"])))
    check(toks["captured"] == toks["eager"] and same,
          f"11 {tag}: greedy tokens and the {LM_NEW - 1} decode steps' "
          f"logits of the captured step bitwise the eager lm_decode_step "
          f"loop's")
    check(counts["captured"] == counts["eager"] and dec.captures == 1,
          f"11 {tag}: launches captured {counts['captured']} = eager "
          f"{counts['eager']}; {dec.captures} decode capture")
    out = {"decode_ms_per_step": {k: float(np.mean(v))
                                  for k, v in ms.items()},
           "in_turns": ms, "captures": dec.captures, "replays": dec.replays,
           "captured_decode_busy_share": rec["captured_decode_busy_share"],
           "eager_decode_busy_share": rec["decode_busy_share"]}
    print(f"  11 {tag} decode: eager {out['decode_ms_per_step']['eager']:.3f}"
          f" ms a step, captured "
          f"{out['decode_ms_per_step']['captured']:.3f} ms (in turns: "
          f"{ms}); busy eager {100 * rec['decode_busy_share']:.1f}%, "
          f"captured {100 * rec['captured_decode_busy_share']:.1f}%; "
          f"{dec.captures} capture, {dec.replays} replays", flush=True)
    return out


SASS_KERNELS = ("flash_attention_tc_kernel", "decode_split_kernel",
                "fused_fp_na_kernel", "segment_spmm_kernel", "gat_na_kernel",
                "semantic_scores_kernel", "semantic_combine_kernel",
                "segment_sum_long_kernel")


def sass_counts(lib_path: str):
    """Tensor-core (``HGMMA``: wgmma; ``HMMA``: mma.sync),
    asynchronous-copy (``LDGSTS``; ``.128``: 16 bytes), 16-byte shared-load
    (``LDS.128``), 16-byte global-load (``LDG.128``) and fp32 FMA
    (``FFMA``) instructions in the built library's SASS, summed over the
    instantiations of each kernel of ``SASS_KERNELS`` (``gat_na_kernel``
    split by its epilogue flag), by ``cuobjdump -sass``; None where the
    toolkit has none."""
    from repro_torch.kernels import build

    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                          text=True, timeout=300).stdout
    keys = ("HGMMA", "HMMA", "LDGSTS", "LDGSTS.128", "LDS.128", "LDG.128",
            "FFMA")
    names = [n for n in SASS_KERNELS if n != "gat_na_kernel"]
    names += ["gat_na_kernel fused", "gat_na_kernel"]
    counts = {name: dict.fromkeys(keys, 0) for name in names}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            fn = next((n for n in SASS_KERNELS if n in mangled), None)
            if fn == "gat_na_kernel" and re.search(r"ILi\dELb1E", mangled):
                fn = "gat_na_kernel fused"
            continue
        if fn is None:
            continue
        c = counts[fn]
        c["HGMMA"] += "HGMMA" in line
        c["HMMA"] += "HMMA" in line
        c["LDGSTS"] += "LDGSTS" in line
        c["LDGSTS.128"] += bool(re.search(r"LDGSTS[.\w]*\.128\b", line))
        c["LDS.128"] += bool(re.search(r"\bLDS(\.U)?\.128\b", line))
        c["LDG.128"] += bool(re.search(r"\bLDG(\.\w+)*\.128\b", line))
        c["FFMA"] += bool(re.search(r"\bFFMA\b", line))
    return counts


def hgnn_instructions() -> dict:
    """The SASS of the HGNN kernels redesigned for Hopper: fused_fp_na's
    gathers through a cp.async ring (LDGSTS) and its 3xTF32 product on the
    tensor cores (HMMA), gat_na's epilogue, whose W arrives by cp.async
    and whose z is read in 16-byte shared loads, segment_spmm's gathers
    through a cp.async ring (LDGSTS), semantic_scores' W and z staged by
    16-byte cp.async and multiplied by FFMA from 16-byte shared loads, and
    semantic_combine's 16-byte global loads; a check fails if the SASS
    lacks them."""
    from repro_torch.kernels import build

    counts = sass_counts(build.library()._name)
    if counts is None:
        print("  SASS not read: no cuobjdump beside nvcc")
        return {}
    ffn, gat = counts["fused_fp_na_kernel"], counts["gat_na_kernel fused"]
    spmm = counts["segment_spmm_kernel"]
    sc, comb = counts["semantic_scores_kernel"], counts[
        "semantic_combine_kernel"]
    ssum = counts["segment_sum_long_kernel"]
    print(f"  SASS: fused_fp_na_kernel HMMA {ffn['HMMA']}, LDGSTS "
          f"{ffn['LDGSTS']}; gat_na_kernel<fused> LDGSTS {gat['LDGSTS']} "
          f"(16-byte {gat['LDGSTS.128']}), LDS.128 {gat['LDS.128']}, FFMA "
          f"{gat['FFMA']}; gat_na_kernel<unfused> LDGSTS "
          f"{counts['gat_na_kernel']['LDGSTS']}; segment_spmm_kernel LDGSTS "
          f"{spmm['LDGSTS']} (16-byte {spmm['LDGSTS.128']}); "
          f"semantic_scores_kernel LDGSTS {sc['LDGSTS']} (16-byte "
          f"{sc['LDGSTS.128']}), LDS.128 {sc['LDS.128']}, HMMA {sc['HMMA']}, "
          f"FFMA {sc['FFMA']}; semantic_combine_kernel LDG.128 "
          f"{comb['LDG.128']}; segment_sum_long_kernel LDGSTS "
          f"{ssum['LDGSTS']} (16-byte {ssum['LDGSTS.128']})")
    check(ffn["HMMA"] > 0 and ffn["LDGSTS"] > 0,
          "fused_fp_na gathers by cp.async (LDGSTS) and multiplies on the "
          "tensor cores (HMMA)")
    check(gat["LDGSTS"] > 0 and gat["LDS.128"] > 0,
          "gat_na's epilogue copies W by cp.async (LDGSTS) and reads z in "
          "16-byte shared loads")
    check(spmm["LDGSTS.128"] > 0,
          "segment_spmm gathers by cp.async (16-byte LDGSTS)")
    check(sc["LDGSTS.128"] > 0 and sc["LDS.128"] > 0 and sc["FFMA"] > 0,
          "semantic_scores stages W and z by cp.async (16-byte LDGSTS) and "
          "multiplies by FFMA from 16-byte shared loads")
    check(comb["LDG.128"] > 0,
          "semantic_combine reads z in 16-byte global loads (LDG.128)")
    check(ssum["LDGSTS.128"] > 0,
          "segment_sum's long-segment kernel streams rows by cp.async "
          "(16-byte LDGSTS)")
    return {name: counts[name] for name in
            ("fused_fp_na_kernel", "gat_na_kernel fused", "gat_na_kernel",
             "segment_spmm_kernel", "semantic_scores_kernel",
             "semantic_combine_kernel", "segment_sum_long_kernel")}


def attention_instructions() -> dict:
    """What the bf16 flash kernel issues on the tensor cores (its C entry
    names it) and the SASS counts that show it, with the decode kernel's
    16-byte asynchronous copies; a check fails if the SASS lacks them."""
    from repro_torch.kernels import build

    lib = build.library()
    instr = lib.flash_attention_bf16_instruction().decode()
    counts = sass_counts(lib._name)
    print(f"  flash_attention bf16 kernel: {instr}")
    if counts is None:
        print("  SASS not read: no cuobjdump beside nvcc")
    else:
        fa, dec = counts["flash_attention_tc_kernel"], counts[
            "decode_split_kernel"]
        print(f"  SASS: flash_attention_tc_kernel HGMMA {fa['HGMMA']}, HMMA "
              f"{fa['HMMA']}, LDGSTS "
              f"{fa['LDGSTS']} (16-byte {fa['LDGSTS.128']}); "
              f"decode_split_kernel LDGSTS {dec['LDGSTS']} (16-byte "
              f"{dec['LDGSTS.128']})")
        check(fa["HGMMA"] + fa["HMMA"] > 0 and fa["LDGSTS.128"] > 0,
              "the bf16 flash kernel issues tensor-core MMAs and 16-byte "
              "LDGSTS")
        check(dec["LDGSTS.128"] > 0,
              "the decode split kernel issues 16-byte LDGSTS")
    return {"flash_bf16_instruction": instr, "sass": counts}


def lm_kernel_times(dev, flush, results: dict, main_counts: dict) -> list:
    """Both kernels timed cold and warm at the granite shapes, beside their
    bound, their plain version and SDPA (the yardstick only); the flash
    kernel's fp32 arm on a line of its own."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as tdec
    from repro_torch.kernels import flash_attention as tflash

    gen = torch.Generator(device=dev).manual_seed(16)
    entries = []
    arms = attention_instructions()
    with torch.inference_mode():
        q, k, v = attn_inputs(gen, 4, 2048, 32, 8, 128, torch.float32)
        n_bytes, n_ops = tflash.work(q, k, True, 0)
        fp32_fn = lambda: tflash.flash_attention(q, k, v)  # noqa: E731
        fp32_ms = time_ms(fp32_fn, 10, flush)
        fp32_warm_ms = time_ms(fp32_fn, 10)
        fp32_bound, fp32_by = bound(n_bytes, n_ops)
        print(f"  flash_attention fp32 arm (FMA kernel), granite prefill "
              f"fp32: {fp32_ms:.5f} ms cold, {fp32_warm_ms:.5f} ms warm "
              f"(bound {fp32_bound:.5f} ms by {fp32_by} at 67 TFLOP/s fp32)")
        arms.update({"fp32_ms": fp32_ms, "fp32_warm_ms": fp32_warm_ms,
                     "fp32_bound_ms": fp32_bound})
        del q, k, v
        q, k, v = attn_inputs(gen, 4, 2048, 32, 8, 128, torch.bfloat16)
        n_bytes, n_ops = tflash.work(q, k, True, 0)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)
        err = max_err(sdpa().transpose(1, 2), tflash.flash_attention(q, k, v))
        print(f"  SDPA vs flash_attention at the granite prefill: max |err| "
              f"{err:.3e}")
        timed = [("flash_attention",
                  lambda: tflash.flash_attention(q, k, v),
                  lambda: tflash.flash_attention_plain(q, k, v), sdpa,
                  n_bytes, n_ops,
                  "granite prefill: q [4, 2048, 32, 128], k/v [4, 2048, 8, "
                  "128], causal, bf16",
                  "F.scaled_dot_product_attention(is_causal=True, "
                  "enable_gqa=True)",
                  "src/repro/kernels/flash_attention.py:83")]
        dq, dk, dv = attn_inputs(gen, 4, 2080, 32, 8, 128, torch.bfloat16,
                                 decode=True)
        kv_len = torch.tensor([1, 1000, 2049, 2080], dtype=torch.int32,
                              device=dev)
        live = torch.arange(dk.shape[1], device=dev)[None, :] < kv_len[:, None]
        mask = live[:, None, None, :]
        sdpa_dec = lambda: F.scaled_dot_product_attention(  # noqa: E731
            dq[:, :, None], dk.transpose(1, 2), dv.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
        err = max_err(sdpa_dec()[:, :, 0],
                      tdec.decode_attention(dq, dk, dv, kv_len))
        print(f"  SDPA vs decode_attention at the granite decode: max |err| "
              f"{err:.3e}")
        n_bytes, n_ops = tdec.work(dq, dk, kv_len)
        timed.append(("decode_attention",
                      lambda: tdec.decode_attention(dq, dk, dv, kv_len),
                      lambda: tdec.decode_attention_plain(dq, dk, dv, kv_len),
                      sdpa_dec, n_bytes, n_ops,
                      "granite decode: q [4, 32, 128], cache [4, 2080, 8, "
                      "128], kv_len (1, 1000, 2049, 2080), bf16",
                      "F.scaled_dot_product_attention(attn_mask=kv_len "
                      "mask, enable_gqa=True)",
                      "src/repro/kernels/decode_attention.py:72"))
        for (name, kern, plain, lib, n_bytes, n_ops, shape, lib_name,
             replaces) in timed:
            ms = time_ms(kern, 20, flush)
            warm_ms = time_ms(kern, 20)
            plain_ms = time_ms(plain, 5, flush)
            lib_ms = time_ms(lib, 20, flush)
            b_ms, b_by = bound(n_bytes, n_ops, PEAK_BF16_FLOPS)
            check((n_bytes, n_ops) == BOUND_WORK[name],
                  f"{name}: bound work {(n_bytes, n_ops)} as before the "
                  f"formulas moved ({BOUND_WORK[name]})")
            entries.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": main_counts[name],
                **results[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "warm_ms": warm_ms, "bytes": n_bytes, "operations": n_ops,
                "shape": shape, "library": lib_name,
                "peak": "989 TFLOP/s bf16 dense, 3.35 TB/s",
                **(arms if name == "flash_attention" else {})})
            print(f"  {name}: {ms:.5f} ms cold, {warm_ms:.5f} ms warm "
                  f"(plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms by {b_by}, "
                  f"SDPA {lib_ms:.5f} ms)")
        entries[0]["cross_form"] = cross_form_times(gen, flush)
    return entries


def cross_form_times(gen, flush) -> dict:
    """The kernel's cross form, bf16, non-causal, over the encoder's k/v
    [4, 1024, 16, 64]: at phase 8a's 256 target queries, and at phase 8b's
    served prefill (the 2-token prefix: one q tile, 2 of its 64 rows
    live); each timed cold and warm beside its bound, its plain version
    and SDPA (which takes ``Sq != Sk`` when not causal)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as tflash

    out = {}
    for key, sq in (("st256", 256), ("served", 2)):
        q, k, v = attn_inputs(gen, 4, sq, 16, 16, 64, torch.bfloat16,
                              sk=1024)

        def kern():
            return tflash.flash_attention(q, k, v, causal=False)

        def plain():
            return tflash.flash_attention_plain(q, k, v, causal=False)

        def sdpa():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

        err = max_err(sdpa().transpose(1, 2), kern())
        n_bytes, n_ops = tflash.work(q, k, causal=False)
        b_ms, b_by = bound(n_bytes, n_ops, PEAK_BF16_FLOPS)
        rec = {"shape": f"seamless cross: q [4, {sq}, 16, 64], k/v [4, 1024, "
                        "16, 64], non-causal, bf16",
               "ms": time_ms(kern, 20, flush), "warm_ms": time_ms(kern, 20),
               "plain_ms": time_ms(plain, 5, flush),
               "library_ms": time_ms(sdpa, 20, flush), "bound_ms": b_ms,
               "bound_by": b_by, "bytes": n_bytes, "operations": n_ops,
               "sdpa_max_abs_err": err,
               "library": "F.scaled_dot_product_attention (Sq != Sk, no "
                          "mask)"}
        print(f"  flash_attention cross form, {rec['shape']}: "
              f"{rec['ms']:.5f} ms cold, {rec['warm_ms']:.5f} ms warm (plain "
              f"{rec['plain_ms']:.5f} ms, bound {b_ms:.5f} ms by {b_by}, SDPA "
              f"{rec['library_ms']:.5f} ms; SDPA vs kernel max |err| "
              f"{err:.3e})")
        out[key] = rec
        del q, k, v
    return out


# the MoE, SSM and hybrid LM families (phase 7)
PHI_MOE, MAMBA2, ZAMBA2 = "phi3.5-moe-42b-a6.6b", "mamba2-2.7b", "zamba2-1.2b"
PHI_LAYERS = 24  # of 32: 58.6 GiB of bf16 weights, room for the serve
FAMILY_TEMPERATURE = 0.7  # the sampled zamba2 wave


def families_two_layers(dev, ops) -> dict:
    """Phase 7a: phi3.5-moe and zamba2 at full width, 2 layers, fp32, the
    kernel arm against the plain arm (``arms_two_layers``; zamba2 as 2
    Mamba layers then one shared block application); mamba2-2.7b at full
    width, 2 layers, fp32, the card against the CPU on a 1 x 256 prompt
    and 4 teacher-forced decode steps."""
    import gc

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.nn import transformer as tf

    fp32 = dict(n_layers=2, dtype="float32", param_dtype="float32")
    out = {"phi3.5-moe": arms_two_layers(
        dev, ops, get_config(PHI_MOE).replace(**fp32), "phi3.5-moe", 2, 2)}
    out["zamba2"] = arms_two_layers(
        dev, ops, get_config(ZAMBA2).replace(shared_attn_period=2, **fp32),
        "zamba2", 1, 1)
    cfg = get_config(MAMBA2).replace(**fp32)
    params = tf.init_lm_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    rng = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (1, 256 + 4), generator=rng,
                         device=dev)
    card = teacher_forced(tf, params, cfg, toks[:, :256], toks[:, 256:], 260)
    host = teacher_forced(tf, to_device(params, torch.device("cpu")), cfg,
                          toks[:, :256].cpu(), toks[:, 256:].cpu(), 260)
    err = max_err(card.cpu(), host)
    check(bool(torch.isfinite(card).all())
          and close(card.cpu(), host, **TOL_LM),
          f"mamba2 2-layer fp32 (d_model {cfg.d_model}, d_state "
          f"{cfg.ssm.d_state}, chunk {cfg.ssm.chunk}, prefill 1x256 + 4 "
          f"teacher-forced steps): logits card vs CPU max |err| {err:.3e} "
          f"of max |logit| {float(host.abs().max()):.3f} (tol {TOL_LM})")
    out["mamba2"] = {"max_abs_err": err, "tolerance": TOL_LM}
    del params, card, host
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sampled_wave(dev, cfg, params) -> dict:
    """One wave of 4 x 2048-token prompts and 32 tokens sampled at
    ``FAMILY_TEMPERATURE``, by two engines from the same seed: the tokens
    are in the vocabulary and equal."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import Request, ServeEngine

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, LM_PROMPT).astype(np.int32)
               for _ in range(LM_SLOTS)]
    runs = []
    for _ in range(2):
        engine = ServeEngine(cfg, params, batch_slots=LM_SLOTS,
                             max_len=LM_PROMPT + LM_NEW, rng_seed=7)
        done = engine.generate([Request(prompt=p, max_tokens=LM_NEW,
                                        temperature=FAMILY_TEMPERATURE)
                                for p in prompts])
        torch.cuda.synchronize()
        runs.append([r.out_tokens for r in done])
    check(all(len(t) == LM_NEW and all(0 <= x < cfg.vocab for x in t)
              for t in runs[0]),
          f"{cfg.name} sampled at temperature {FAMILY_TEMPERATURE}: "
          f"{LM_SLOTS} x {LM_NEW} token ids in [0, {cfg.vocab})")
    check(runs[1] == runs[0],
          f"{cfg.name} sampled at temperature {FAMILY_TEMPERATURE}: two "
          f"waves from the same engine seed give the same tokens")
    print(f"  sampled tokens req0: {runs[0][0]}")
    return {"temperature": FAMILY_TEMPERATURE, "tokens_req0": runs[0][0]}


def families_serve(dev, ops, profiles: dict) -> dict:
    """Phase 7b: mamba2-2.7b (64 layers) and zamba2-1.2b (38 Mamba layers,
    the shared block twice) whole, and phi3.5-moe at full width with
    ``PHI_LAYERS`` layers, bf16, through ``lm_serve``; then one zamba2 wave
    sampled at a temperature."""
    import gc

    import torch
    from repro_torch.configs.registry import get_config

    out = {}
    for tag, cfg, attn_layers in (
            ("mamba2", get_config(MAMBA2), 0),
            ("zamba2", get_config(ZAMBA2), 2),
            ("phi3.5-moe", get_config(PHI_MOE).replace(n_layers=PHI_LAYERS),
             PHI_LAYERS)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg = cfg.replace(use_pallas=True)
        out[tag] = lm_serve(dev, ops, profiles, cfg, tag, attn_layers,
                            sampled=tag == "zamba2")
        print(f"  {tag}: {time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the VLM and encoder-decoder families (phase 8)
INTERNVL2, SEAMLESS = "internvl2-76b", "seamless-m4t-medium"
# of 80: 32 layers hold 54.9 GiB of bf16 weights (embedding and head
# included); all 80 would be 131.4 GiB
INTERNVL2_LAYERS = 32
VLM_TEXT, VLM_NEW = 1024, 32  # 256 image embeddings + 1024 text tokens
SRC_LEN, TGT_NEW = 1024, 64  # 1024 audio frames, 64 greedy tokens
# a translation decode starts from BOS and a target-language tag; the
# weights are random, so the tag is a fixed id standing for one
BOS, LANG_TAG = 0, 256047


def frontend_embeds(cfg, b, e, seed, dev):
    """``[b, e, d]`` seeded frontend stubs, ``N(0, 1) * 0.1`` as the
    loader draws them (``data/loader.py``), in ``cfg.dtype``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, e, cfg.d_model)) * 0.1).astype(np.float32)
    return torch.as_tensor(x, device=dev).to(getattr(torch, cfg.dtype))


def vlm_encdec_two_layers(dev, ops) -> dict:
    """Phase 8a: internvl2-76b at full width, 2 layers, fp32: ``lm_forward``
    of 256 embeddings + 256 tokens, the kernel arm against the plain arm;
    seamless-m4t-medium at full width, 2 + 2 layers, fp32: ``encdec_forward``
    of 1024 frames and 256 target tokens, kernel arm against plain arm,
    then the kernel arm's ``encdec_prefill`` of 2 tokens and 254
    teacher-forced ``encdec_decode_step``s against the plain arm's forward
    at every position; exact launches."""
    import gc

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.nn import encdec as ed
    from repro_torch.nn import transformer as tf

    fp32 = dict(dtype="float32", param_dtype="float32")
    out = {}

    def arms(tag, run, cfg, flash, decode=0):
        plain = run(cfg)
        ops.reset_launch_counts()
        kern = run(cfg.replace(use_pallas=True))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(counts == dict(dict.fromkeys(counts, 0), flash_attention=flash,
                             decode_attention=decode),
              f"{tag}: launches {counts} (want {flash} flash_attention, "
              f"{decode} decode_attention)")
        return kern, plain, counts

    cfg = get_config(INTERNVL2).replace(n_layers=2, **fp32)
    params = tf.init_lm_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    e = cfg.n_frontend_embeds
    extra = frontend_embeds(cfg, 2, e, 3, dev)
    toks = torch.randint(0, cfg.vocab, (2, 256), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))

    def vlm_forward(c):
        with torch.inference_mode():
            return tf.lm_forward(params, c, toks, extra_embeds=extra)[0]

    kern, plain, counts = arms("internvl2 2-layer fp32 lm_forward",
                               vlm_forward, cfg, 2)
    err = max_err(kern, plain)
    check(kern.shape == (2, 256, cfg.vocab) and bool(
        torch.isfinite(kern).all()) and close(kern, plain, **TOL_LM),
          f"internvl2 2-layer fp32 (d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, {e} embeddings + 256 tokens): logits "
          f"kernel arm vs plain arm max |err| {err:.3e} of max |logit| "
          f"{float(plain.abs().max()):.3f} (tol {TOL_LM})")
    out["internvl2"] = {"max_abs_err": err, "tolerance": TOL_LM,
                        "launches": counts}
    del params, kern, plain, extra
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config(SEAMLESS).replace(enc_layers=2, dec_layers=2, **fp32)
    params = ed.init_encdec_params(
        torch.Generator(device=dev).manual_seed(0), cfg)
    frames = frontend_embeds(cfg, 2, SRC_LEN, 5, dev)
    toks = torch.randint(0, cfg.vocab, (2, 256), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(6))

    def forward(c):
        with torch.inference_mode():
            return ed.encdec_forward(params, c, frames, toks)

    kern, plain, counts = arms("seamless 2+2-layer fp32 encdec_forward",
                               forward, cfg, 2 + 2 * 2)
    err = max_err(kern, plain)
    check(bool(torch.isfinite(kern).all()) and close(kern, plain, **TOL_LM),
          f"seamless 2+2-layer fp32 (d_model {cfg.d_model}, Ss {SRC_LEN}, "
          f"St 256): logits kernel arm vs plain arm max |err| {err:.3e} of "
          f"max |logit| {float(plain.abs().max()):.3f} (tol {TOL_LM})")
    rec = {"max_abs_err": err, "tolerance": TOL_LM, "launches": counts}
    del kern

    ops.reset_launch_counts()
    steps = teacher_forced_encdec(  # positions 1 .. 254
        ed, params, cfg.replace(use_pallas=True), frames, toks[:, :2],
        toks[:, 2:255], 256).transpose(0, 1)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts == dict(dict.fromkeys(counts, 0), flash_attention=6,
                         decode_attention=2 * 253),
          f"seamless teacher-forced: launches {counts} (want 6 "
          f"flash_attention, {2 * 253} decode_attention)")
    err_tf = max_err(steps, plain[:, 1:255])
    check(close(steps, plain[:, 1:255], **TOL_LM),
          f"seamless 2+2-layer fp32: encdec_prefill of 2 tokens + 253 "
          f"teacher-forced encdec_decode_steps (kernel arm) vs the plain "
          f"arm's encdec_forward at every position: max |err| "
          f"{err_tf:.3e} (tol {TOL_LM})")
    rec.update(teacher_forced_max_abs_err=err_tf,
               teacher_forced_launches=counts)
    out["seamless"] = rec
    del params, plain, steps, frames
    gc.collect()
    torch.cuda.empty_cache()
    return out


def greedy_waves(tag, prefill, decode, n_new, want_flash, want_decode, ops
                 ) -> dict:
    """Two greedy waves: ``prefill()`` -> ``(logits [B, 1, V], state)``,
    then ``n_new - 1`` steps ``decode(token [B, 1], state, i)`` -> logits
    (``i`` the step's index); tokens argmaxed on the card and read once at
    the end, as positions stay on the card, so no step waits for the
    host.  Gates:
    the two waves' tokens and prefill logits bitwise, launches exact
    (``want_flash`` a prefill, ``want_decode`` a step).  Returns the
    second wave's prefill ms (to the first token), decode ms a step,
    tokens/s, peak memory and the first request's tokens, and the wave's
    tokens ``[B, n_new]`` on the card."""
    import torch

    runs = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            lg, state = prefill()
            tok = lg[:, 0].argmax(dim=-1)[:, None]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            first = ops.launch_counts()
            outs = [tok]
            for i in range(n_new - 1):
                tok = decode(tok, state, i)[:, 0].argmax(dim=-1)[:, None]
                outs.append(tok)
            toks = torch.cat(outs, dim=1).tolist()
        t2 = time.perf_counter()
        counts = ops.launch_counts()
        runs.append({"prefill_ms": (t1 - t0) * 1e3,
                     "decode_ms_per_step": (t2 - t1) * 1e3 / (n_new - 1),
                     "tokens": toks, "logits": lg, "first": first,
                     "counts": counts, "wall_s": t2 - t0})
        del state
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = n_new - 1
    for i, r in enumerate(runs):
        want = dict(dict.fromkeys(r["counts"], 0),
                    flash_attention=want_flash,
                    decode_attention=want_decode * steps)
        check(r["counts"] == want
              and r["first"]["flash_attention"] == want_flash
              and r["first"]["decode_attention"] == 0,
              f"{tag} run {i}: launches {r['counts']} (want {want_flash} "
              f"flash_attention a prefill, {want_decode} decode_attention a "
              f"step x {steps})")
    check(runs[1]["tokens"] == runs[0]["tokens"]
          and torch.equal(runs[1]["logits"], runs[0]["logits"]),
          f"{tag}: two waves give the same prefill logits and tokens")
    r = runs[1]
    b = len(r["tokens"])
    check(all(len(t) == n_new for t in r["tokens"])
          and bool(torch.isfinite(r["logits"]).all()),
          f"{tag}: {b} x {n_new} tokens, finite prefill logits")
    n_tok = b * n_new
    rec = {"prefill_ms": r["prefill_ms"],
           "decode_ms_per_step": r["decode_ms_per_step"],
           "tokens_per_s": n_tok / r["wall_s"], "tokens": n_tok,
           "run1": {k: runs[0][k] for k in ("prefill_ms",
                                            "decode_ms_per_step")},
           "launches": r["counts"], "peak_gib": peak,
           "tokens_req0": r["tokens"][0]}
    print(f"  {tag} (run 2): prefill {r['prefill_ms']:.2f} ms to the first "
          f"token; decode {r['decode_ms_per_step']:.3f} ms a step; {n_tok} "
          f"tokens in {r['wall_s']:.3f} s ({rec['tokens_per_s']:.1f} tok/s); "
          f"run 1: prefill {runs[0]['prefill_ms']:.2f} ms, decode "
          f"{runs[0]['decode_ms_per_step']:.3f} ms a step; peak memory "
          f"allocated {peak:.2f} GiB")
    print(f"  tokens req0: {r['tokens'][0]}")
    return rec, torch.tensor(r["tokens"], device=r["logits"].device)


def vlm_serve(dev, ops, profiles: dict) -> dict:
    """Phase 8b: internvl2-76b at full width with ``INTERNVL2_LAYERS`` of
    its 80 layers, bf16: one wave of 4 requests, each 256 seeded image
    embeddings plus 1024 text tokens, then 32 greedy tokens, through
    ``lm_prefill(extra_embeds=...)`` -> ``graft_prefill_caches`` ->
    ``lm_decode_step`` at positions from 1280 (``greedy_waves``)."""
    import gc

    import torch
    from repro_torch import graphs
    from repro_torch.configs.registry import get_config
    from repro_torch.nn import transformer as tf

    cfg = get_config(INTERNVL2).replace(n_layers=INTERNVL2_LAYERS,
                                        use_pallas=True)
    t0 = time.perf_counter()
    params = tf.init_lm_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    torch.cuda.synchronize()
    n_params = tf.param_count(params)
    print(f"  {cfg.name}: {cfg.n_layers} of 80 layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, Dh "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.param_dtype}: {n_params} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; memory allocated "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    e = cfg.n_frontend_embeds
    b = LM_SLOTS
    extra = frontend_embeds(cfg, b, e, 7, dev)
    toks = torch.randint(0, cfg.vocab, (b, VLM_TEXT), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(8))
    t_first = e + VLM_TEXT
    max_len = t_first + VLM_NEW
    # the decode step compiled as ServeEngine compiles it: the caches, the
    # token and the position held in buffers made once
    held = tf.init_kv_caches(cfg, b, max_len, dev)
    tok_buf = torch.zeros((b, 1), dtype=torch.long, device=dev)
    pos_buf = torch.zeros((), dtype=torch.long, device=dev)
    step = graphs.compiled(
        lambda p, t, c, pos: tf.lm_decode_step(p, cfg, t, c, pos))

    def prefill():
        lg, pf = tf.lm_prefill(params, cfg, toks, extra_embeds=extra)
        for c in held:
            c["k"].zero_()
            c["v"].zero_()
        return lg, tf.graft_prefill_caches(cfg, held, pf, t_first)

    def decode(tok, caches, i):  # the position stays on the card
        tok_buf.copy_(tok)
        pos_buf.fill_(t_first + i)
        return step(params, tok_buf, caches, pos_buf)[0]

    rec, served = greedy_waves(f"internvl2 ({cfg.n_layers} layers) {b}x("
                               f"{e}+{VLM_TEXT})", prefill, decode, VLM_NEW,
                               cfg.n_layers, cfg.n_layers, ops)

    def arm(c):
        return lambda: teacher_forced(tf, params, c, toks, served[:, :-1],
                                      max_len, extra_embeds=extra)

    rec.update(arms_vs_tokens("internvl2", arm(cfg),
                              arm(cfg.replace(use_pallas=False)), served))
    with torch.inference_mode():
        _, caches = prefill()
    tok = torch.zeros((b, 1), dtype=torch.long, device=dev)
    rec.update(busy_shares(
        "internvl2", lambda: tf.lm_prefill(params, cfg, toks,
                                           extra_embeds=extra),
        lambda: decode(tok, caches, 0), profiles))
    check(step.captures == 1,
          f"internvl2: {step.captures} decode capture, {step.replays} "
          f"replays")
    rec.update(params=n_params, layers=cfg.n_layers, embeds=e,
               text_tokens=VLM_TEXT, decode_captures=step.captures,
               decode_replays=step.replays)
    del params, caches, extra, held, step
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def encdec_serve(dev, ops, profiles: dict) -> dict:
    """Phase 8b: seamless-m4t-medium whole, bf16: 4 clips of 1024 seeded
    frames, the target prefix (BOS, a language tag), then 64 greedy
    tokens through ``encdec_prefill`` -> ``init_encdec_caches`` ->
    ``encdec_decode_step`` (``examples/serve_decode.py``'s loop,
    ``greedy_waves``); the encoder alone timed too."""
    import gc

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.nn import encdec as ed
    from repro_torch.nn import transformer as tf

    cfg = get_config(SEAMLESS).replace(use_pallas=True)
    params = ed.init_encdec_params(
        torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = tf.param_count(params)
    print(f"  {cfg.name}: {cfg.enc_layers} + {cfg.dec_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads, Dh "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab}, {cfg.param_dtype}: "
          f"{n_params} parameters", flush=True)
    b = LM_SLOTS
    frames = frontend_embeds(cfg, b, SRC_LEN, 9, dev)
    prefix = torch.tensor([[BOS, LANG_TAG]] * b, device=dev)
    t_prefix = prefix.shape[1]

    def prefill():
        lg, pf = ed.encdec_prefill(params, cfg, frames, prefix)
        return lg, ed.graft_encdec_caches(cfg, pf, t_prefix + TGT_NEW)

    first_pos = torch.tensor(t_prefix, device=dev)

    def decode(tok, caches, i):  # the position stays on the card
        return ed.encdec_decode_step(params, cfg, tok, caches,
                                     first_pos + i)[0]

    n_layers = cfg.enc_layers + 2 * cfg.dec_layers
    rec, served = greedy_waves(f"seamless {b}x{SRC_LEN} frames, {TGT_NEW} "
                               f"tokens", prefill, decode, TGT_NEW, n_layers,
                               cfg.dec_layers, ops)

    def arm(c):
        return lambda: teacher_forced_encdec(ed, params, c, frames, prefix,
                                             served[:, :-1],
                                             t_prefix + TGT_NEW)

    rec.update(arms_vs_tokens("seamless", arm(cfg),
                              arm(cfg.replace(use_pallas=False)), served))

    def encode():
        with torch.inference_mode():
            ed.encode(params, cfg, frames)
        torch.cuda.synchronize()

    encode()
    t0 = time.perf_counter()
    for _ in range(3):
        encode()
    rec["encode_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    print(f"  seamless encode {b}x{SRC_LEN} frames: {rec['encode_ms']:.2f} "
          f"ms (of the prefill's {rec['prefill_ms']:.2f})")
    with torch.inference_mode():
        _, caches = prefill()
    tok = prefix[:, 1:]
    rec.update(busy_shares(
        "seamless", lambda: ed.encdec_prefill(params, cfg, frames, prefix),
        lambda: decode(tok, caches, 0), profiles))
    rec.update(params=n_params, src_len=SRC_LEN, prefix=t_prefix)
    del params, caches, frames
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# LM training (phase 6): smollm-360m, the default --arch of the train CLI
SMOLLM = "smollm-360m"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MB = 2048, 8, 2  # cut from train_4k (4096, 256)
TRAIN_WARMUP, TRAIN_TIMED = 2, 8  # steps on the repeated batch: 10 in all


def train_pieces_vs_plain(dev, flush) -> dict:
    """Phase 6a: the embedding's gradient through ``segment_sum`` at the
    shapes phase 6c's microbatch gives it (V 49,152, d 960, 4 x 2048 =
    8192 ids, a bf16 table as the full config has), bitwise the plain
    version on the CPU and timed at that call, and the
    chunked attention's backward at smollm's full shapes (16 q and 16 kv
    heads after padding, Dh 64, S 2048, chunk 1024, causal): dQ, dK, dV on
    the card against the same call on the CPU."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.nn import attention as tattn
    from repro_torch.nn import transformer as tf

    cfg = get_config(SMOLLM)
    gen = torch.Generator(device="cpu").manual_seed(60)
    out = {}
    # one microbatch of phase 6c: the ids one _EmbedGather backward sums
    ids = torch.randint(0, cfg.vocab, (TRAIN_BATCH // TRAIN_MB * TRAIN_SEQ,),
                        generator=gen, dtype=torch.int32)
    table = (torch.randn((cfg.vocab, cfg.d_model), generator=gen) * 0.02
             ).to(torch.bfloat16)
    dx = (torch.randn((ids.numel(), cfg.d_model), generator=gen) * 1e-3
          ).to(torch.bfloat16)

    def embed_grad(device):
        t = table.to(device).requires_grad_()
        y = tf._EmbedGather.apply(t, ids.to(device))
        (g,) = torch.autograd.grad(y, t, grad_outputs=dx.to(device))
        return g

    got = embed_grad(dev)
    want = embed_grad("cpu")
    again = embed_grad(dev)
    torch.cuda.synchronize()
    err = max_err(got.cpu(), want)
    check(torch.equal(got.cpu(), want),
          f"embedding gradient via segment_sum, table {tuple(table.shape)} "
          f"bf16, {ids.numel()} ids ({int(ids.unique().numel())} distinct): "
          f"bitwise the plain version on the CPU (max |err| {err:.3e})")
    check(torch.equal(got, again),
          "embedding gradient: two runs give the same bits")
    out["embed_grad_max_abs_err"] = err
    # the training call form timed beside its bound (the kernels line's
    # segment_sum entry keeps phase 4's GCN/Reddit call)
    sorted_ids, order = torch.sort(ids.to(dev), stable=True)
    call = (dx.to(dev).float().contiguous(), sorted_ids.to(torch.int32),
            cfg.vocab, order.to(torch.int32), False)
    with torch.inference_mode():
        rec = segment_sum_timing(call, flush)
    rec.pop("sparse_mm_ms", None)  # a mean's weights: not this call's sum
    print(f"  segment_sum, the embedding-gradient form (vals [{ids.numel()}, "
          f"{cfg.d_model}] fp32, N {cfg.vocab}): {rec['ms']:.5f} ms cold, "
          f"{rec['warm_ms']:.5f} ms warm (plain {rec['plain_ms']:.5f} ms, "
          f"bound {rec['bound_ms']:.5f} ms by {rec['bound_by']}, index_add_ "
          f"{rec['library_ms']:.5f} ms)")
    out["segment_sum_embed_grad"] = rec

    h, kvh = tattn._heads(cfg)
    dh = cfg.resolved_head_dim
    q, k, v = (torch.randn(shape, generator=gen) * 0.5 for shape in
               ((1, TRAIN_SEQ, h, dh), (1, TRAIN_SEQ, kvh, dh),
                (1, TRAIN_SEQ, kvh, dh)))
    w = torch.randn((1, TRAIN_SEQ, h, dh), generator=gen)
    chunk = tattn._chunk_for(TRAIN_SEQ, cfg.attn_chunk)

    def attn_grads(device):
        xs = [x.to(device).requires_grad_() for x in (q, k, v)]
        o = tattn.chunked_attention(*xs, causal=True, chunk_q=chunk,
                                    chunk_k=chunk)
        return torch.autograd.grad((o * w.to(device)).sum(), xs)

    t0 = time.perf_counter()
    got = attn_grads(dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    want = attn_grads("cpu")
    errs = []
    for name, a, b in zip(("dQ", "dK", "dV"), got, want):
        err = max_err(a.cpu(), b)
        errs.append(err)
        check(close(a.cpu(), b, **TOL_CPU),
              f"chunked attention backward {name} {tuple(a.shape)} (H {h}, "
              f"KVH {kvh}, Dh {dh}, S {TRAIN_SEQ}, chunk {chunk}, causal) on "
              f"the card vs the CPU: max |err| {err:.3e} of max "
              f"{float(b.abs().max()):.3e} (tol {TOL_CPU})")
    print(f"  chunked attention forward + backward on the card: "
          f"{1e3 * card_s:.1f} ms (first call)")
    out["chunked_backward_max_abs_err"] = max(errs)
    return out


def train_two_layers(dev) -> dict:
    """Phase 6b: smollm-360m at full width, 2 layers, fp32, seq 2048 (the
    chunked arm), batch 1.  The gradients and one ``make_train_step`` step
    on the card against the same on the CPU from the same state; the three
    remat modes bitwise on the card; save -> restore bitwise for an fp32
    and a bf16 copy of the state after the step."""
    import shutil

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.loader import synth_batch
    from repro_torch.nn import attention as tattn
    from repro_torch.train import checkpoint as ckpt
    from repro_torch import tree
    from repro_torch.train.optimizer import build_optimizer, lr_schedule
    from repro_torch.train.train_step import (init_train_state, loss_fn_for,
                                              make_train_step, value_and_grad)

    cfg = get_config(SMOLLM).replace(n_layers=2, dtype="float32",
                                     param_dtype="float32")
    total_steps = 10
    opt = build_optimizer(cfg, total_steps=total_steps)
    state_cpu = init_train_state(torch.Generator().manual_seed(0), cfg, opt)
    state = tree.map(lambda x: x.to(dev), state_cpu)
    batch_np = synth_batch(cfg, ShapeConfig("6b", TRAIN_SEQ, 1, "train"), 0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_np.items()}
    batch_cpu = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    out = {}

    loss_fn = loss_fn_for(cfg)
    loss, grads = value_and_grad(loss_fn, state.params, batch)
    loss_c, grads_c = value_and_grad(loss_fn, state_cpu.params, batch_cpu)
    err = max(max_err(a.cpu(), b) for a, b in zip(tree.leaves(grads),
                                                   tree.leaves(grads_c)))
    ok = all(close(a.cpu(), b, **TOL_CPU) for a, b in zip(
        tree.leaves(grads), tree.leaves(grads_c)))
    check(ok and close(loss.cpu(), loss_c, **TOL_CPU),
          f"smollm 2-layer fp32 (d_model {cfg.d_model}, heads padded to "
          f"{'/'.join(map(str, tattn._heads(cfg)))}, seq {TRAIN_SEQ}): loss {float(loss):.6f} (CPU "
          f"{float(loss_c):.6f}) and all {len(tree.leaves(grads))} gradient "
          f"leaves on the card vs the CPU: max |err| {err:.3e} (tol "
          f"{TOL_CPU})")
    out["grads_max_abs_err"] = err
    for mode in ("full", "dots"):
        l2, g2 = value_and_grad(loss_fn_for(cfg.replace(remat=mode)),
                                state.params, batch)
        same = torch.equal(l2, loss) and all(torch.equal(a, b) for a, b in
                                             zip(tree.leaves(g2),
                                                 tree.leaves(grads)))
        check(same, f"smollm 2-layer: remat {mode} gives remat none's loss "
                    f"and gradients bitwise")
    del grads, grads_c

    step = make_train_step(cfg, opt)
    new, m = step(state, batch)
    new_c, m_c = make_train_step(cfg, opt)(state_cpu, batch_cpu)
    lr = float(lr_schedule(total_steps)(0))
    for key in ("loss", "grad_norm"):
        check(close(m[key].cpu(), m_c[key], **TOL_CPU),
              f"smollm 2-layer train step: {key} {float(m[key]):.6f} on the "
              f"card, {float(m_c[key]):.6f} on the CPU (tol {TOL_CPU})")
    perr = max(max_err(a.cpu(), b) for a, b in zip(tree.leaves(new.params),
                                                    tree.leaves(new_c.params)))
    check(perr <= lr, f"smollm 2-layer train step: params after the step "
                      f"on the card vs the CPU: max |err| {perr:.3e} (atol "
                      f"the step's lr {lr:.3e})")
    out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               params_max_abs_err=perr)
    del state_cpu, new_c

    root = ROOT / "build" / "train_ckpt_smoke"
    try:
        for dtype in (torch.float32, torch.bfloat16):
            snap = tree.map(lambda x: x.to(dtype)
                            if x.is_floating_point() else x, new)
            t0 = time.perf_counter()
            ckpt.save(snap, str(root), step=1)
            save_s = time.perf_counter() - t0
            got = ckpt.restore(str(root), snap, device=dev)
            same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                       zip(tree.leaves(got), tree.leaves(snap)))
            n_bytes = sum(x.numel() * x.element_size()
                          for x in tree.leaves(snap))
            check(same, f"checkpoint save -> restore of the {dtype} state "
                        f"({n_bytes / 2 ** 20:.1f} MiB, saved in "
                        f"{save_s:.2f} s): bitwise")
            shutil.rmtree(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def captured_train(tag: str, step, state, batches, want, ops) -> dict:
    """11t: ``step`` (``graphs.compiled`` with the state donated, or a
    ``jit_step`` over it) from ``state`` over ``batches``: each step's
    loss and grad_norm bitwise the eager run's (``want[i]``: loss,
    grad_norm and the eager state after that step, or None) and, where
    given, every state leaf (``want[i]`` None: a step only timed); every
    call returning the tensors of the state it was given; one capture
    (the first step warms up and captures), the other steps replays, each
    launching what the graph's traced replay launched (``measured_card``):
    ``TRAIN_MB`` ``segment_sum`` (the embedding gradient, a microbatch
    each).  The walls of the steps (the median of the replays after the
    traced first one is the step's ms) and the peak memory allocated over
    them."""
    import contextlib
    import statistics

    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import graphs, tree
    from repro_torch.dist.sharding import whole

    fn = step if isinstance(step, graphs.Compiled) else step.compiled
    gc.collect()  # the eager runs' autograd cycles, before the baseline
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    leaves = tree.leaves(state)
    ops.reset_launch_counts()
    walls, same, ok = [], [], []
    comm = CommDebugMode()  # the capturing step's collectives, recorded
    for i, (b, w) in enumerate(zip(batches, want)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with comm if i == 0 else contextlib.nullcontext():
            state, m = step(state, b)
        float(whole(m["loss"]))  # the launcher's one read a step
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        same.append(all(x is y for x, y in zip(tree.leaves(state), leaves)))
        ok.append(w is None or (
            bitwise(m["loss"], w[0]) and bitwise(m["grad_norm"], w[1])
            and (w[2] is None or bitwise(state, w[2]))))
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    traced = [getattr(g, "measured", None) for g in fn.graphs.values()]
    n = len(batches)
    check(all(ok), f"11t {tag}: {n} captured steps' loss, grad_norm and "
          f"state (where the eager run has it) bitwise the eager steps "
          f"({ok})")
    check(all(same), f"11t {tag}: every call returns the state tensors "
          f"it was given ({same})")
    check(fn.captures == 1 and fn.replays == n - 1
          and traced == [{"segment_sum": TRAIN_MB}]
          and counts == {"segment_sum": TRAIN_MB * n},
          f"11t {tag}: {fn.captures} capture, {fn.replays} replays, "
          f"launches {counts} (the graph's traced replay {traced}; want "
          f"{TRAIN_MB} segment_sum a step)")
    med = statistics.median(walls[2:])
    print(f"  11t {tag} train step (batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{TRAIN_MB} microbatches), captured: the capturing step "
          f"{walls[0]:.2f} ms, the first replay (traced) {walls[1]:.2f} ms, "
          f"then {' / '.join(f'{w:.2f}' for w in walls[2:])} ms (median "
          f"{med:.2f}); peak memory allocated {peak:.2f} GiB ({held_gib:.2f} "
          f"GiB held before the first step), reserved after {reserved:.2f} "
          f"GiB; the capturing step's c10d collectives (warm-up and "
          f"capture) {dict(comm.get_comm_counts())}; card {card_line()}",
          flush=True)
    return {"step_ms": walls, "replay_ms_median": med, "peak_gib": peak,
            "capture_collectives": {str(k): v for k, v in
                                    comm.get_comm_counts().items()},
            "held_gib": held_gib, "reserved_gib": reserved,
            "captures": fn.captures, "replays": fn.replays,
            "launches_a_replay_traced": traced}


def train_full(dev, ops, profiles: dict) -> dict:
    """Phase 6c: smollm-360m as its config gives it (32 layers, bf16, remat
    full, heads padded 15 -> 16 and 5 -> 16) through ``launch.train``'s
    setup and step, seq 2048, global batch 8 as 2 microbatches of 4.  Ten
    steps on one repeated batch (the loss must fall; the last 8 timed),
    two runs of the same 3 steps from one state (bitwise), exact
    ``segment_sum`` launches, the peak memory and a profiled step, all
    through the eager step (``step_fn.fn``); 11t: the compiled step that
    the launcher runs on the card (the state donated) over the first
    run's 3 steps and two more, on the loader's numpy batches
    (``captured_train``)."""
    import gc
    import math

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.loader import synth_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.nn import attention as tattn
    from repro_torch.nn import transformer as tf
    from repro_torch import tree

    gc.collect()  # the earlier phases' autograd cycles
    torch.cuda.empty_cache()
    cfg = get_config(SMOLLM)
    t_phase = t0 = time.perf_counter()
    run = launch_train.setup(cfg, steps=TRAIN_WARMUP + TRAIN_TIMED,
                             seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                             microbatches=TRAIN_MB, device=dev)
    torch.cuda.synchronize()
    n_params = tf.param_count(run.state.params)
    h, kvh = tattn._heads(cfg)
    print(f"  smollm-360m: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} padded to {h}/{kvh}, Dh "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.param_dtype}, remat {cfg.remat}, {cfg.optimizer} "
          f"({cfg.opt_state_dtype} moments): {n_params} parameters, state "
          f"drawn in {time.perf_counter() - t0:.2f} s; allocated "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    batch = launch_train.to_device(synth_batch(cfg, run.shape, 0), dev)
    tokens = TRAIN_BATCH * TRAIN_SEQ

    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step = run.step_fn.fn  # the eager step; 11t: the compiled one
    state, losses, walls = run.state, [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))  # the launcher's one read a step
        torch.cuda.synchronize()  # the optimizer's update too
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    check(counts == dict(dict.fromkeys(counts, 0),
                         segment_sum=TRAIN_MB * n_steps),
          f"smollm train: launches {counts} (want {TRAIN_MB * n_steps} "
          f"segment_sum: {TRAIN_MB} microbatches x {n_steps} steps)")
    check(all(math.isfinite(x) for x in losses),
          f"smollm train: all {n_steps} losses finite")
    check(losses[-1] < losses[0],
          f"smollm train, one batch repeated: loss {losses[0]:.4f} at step "
          f"1 -> {losses[-1]:.4f} at step {n_steps} (falls)")
    print("  losses: " + " ".join(f"{x:.4f}" for x in losses))
    timed = sorted(walls[TRAIN_WARMUP:])
    med = timed[len(timed) // 2]
    attn_flops = 12 * cfg.n_layers * h * cfg.resolved_head_dim * TRAIN_SEQ
    flops = tokens * (6 * n_params + attn_flops)
    print(f"  smollm train step (global batch {TRAIN_BATCH} x {TRAIN_SEQ} = "
          f"{tokens} tokens, {TRAIN_MB} microbatches): {med:.2f} ms median "
          f"[{timed[0]:.2f}, {timed[-1]:.2f}] of {TRAIN_TIMED} steps after "
          f"{TRAIN_WARMUP} warm-up (first {walls[0]:.2f} ms); "
          f"{tokens / med * 1e3:.1f} tokens/s; model "
          f"{flops / med / 1e9:.2f} TFLOP/s (6 x {n_params} params x "
          f"{tokens} tokens + 12 x {cfg.n_layers} layers x {h} heads x "
          f"{cfg.resolved_head_dim} Dh x {TRAIN_SEQ} seq x {tokens} tokens "
          f"= {flops:.4e} FLOP a step; {100 * flops / med / 1e9 / 989:.2f}% "
          f"of 989 TFLOP/s bf16)")
    print(f"  peak memory allocated over the {n_steps} steps "
          f"(torch.cuda.max_memory_allocated): {peak:.2f} GiB, of which "
          f"{held:.2f} GiB held before the first step (the state at step 0, "
          f"which this script keeps for the runs below); "
          f"{time.perf_counter() - t_phase:.1f} s so far")
    del state

    runs, run_counts = [], []
    for _ in range(2):
        ops.reset_launch_counts()
        s, ls, gs = run.state, [], []
        for i in range(3):
            s, m = step(s, launch_train.to_device(
                synth_batch(cfg, run.shape, i), dev))
            ls.append(m["loss"])
            gs.append(m["grad_norm"])
        torch.cuda.synchronize()
        run_counts.append(ops.launch_counts()["segment_sum"])
        runs.append((torch.stack(ls), s, gs))
        del s
    check(torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(a, b) for a, b in zip(tree.leaves(runs[0][1]),
                                          tree.leaves(runs[1][1]))),
          f"smollm train: two runs of the same 3 steps give the same losses "
          f"{runs[0][0].tolist()} and parameters, bitwise")
    check(run_counts == [3 * TRAIN_MB] * 2,
          f"smollm train, 3 steps: segment_sum launches {run_counts} (want "
          f"{3 * TRAIN_MB} each)")
    # 11t: the launcher's compiled step over the first run's 3 steps and
    # two more (timed only: three replays after the traced one), from a
    # copy of the state at step 0 (donated: overwritten step by step)
    rec11 = captured_train(
        "smollm-360m mesh-less", run.step_fn,
        tree.map(torch.clone, run.state),
        [synth_batch(cfg, run.shape, i) for i in range(5)],
        [(runs[0][0][i], runs[0][2][i], runs[0][1] if i == 2 else None)
         for i in range(3)] + [None, None], ops)
    rec11["eager_step_ms_median"] = med
    rec11["eager_peak_gib"] = peak
    s = runs[0][1]
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {time.perf_counter() - t_phase:.1f} s so far")
    # one "forward" of the profile below is one whole train step
    prof = profile_forward(types.SimpleNamespace(
        infer=lambda: step(s, batch)), "smollm train step", reps=1,
        warmup=0)
    profiles["smollm train step"] = prof
    busy = prof["device_busy_ms"] / prof["wall_ms"]
    print(f"  {time.perf_counter() - t_phase:.1f} s with the profiled step")
    return {"step_ms_median": med, "step_ms_min": timed[0],
            "step_ms_max": timed[-1], "step_ms_all": walls,
            "tokens_per_s": tokens / med * 1e3,
            "model_tflops_per_s": flops / med / 1e9,
            "flop_per_step": flops, "params": n_params,
            "peak_gib": peak, "held_gib": held, "busy_share": busy,
            "losses": losses,
            "launches": counts["segment_sum"], "compiled": rec11}


# ---------------------------------------------------------------------------
# the device mesh (phase 9): a 1-rank NCCL mesh (data=1, model=1) on the
# card, the mesh paths bitwise the mesh-less ones, and the dry run
# ---------------------------------------------------------------------------

MESH_REPS = 10  # interleaved forwards a 9a path is timed over
MESH_DECODE_STEPS = 32
DRYRUN_TIMEOUT_S = 240


def wall_median_ms(fns: dict, reps: int) -> dict:
    """Host wall of each callable, synchronised, median over ``reps``
    calls made in turns (one of each a round)."""
    import statistics

    import torch

    walls = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in walls.items()}


def dtensor_ops(fn):
    """The ops ``fn()`` dispatches on DTensors, by name (a dispatch mode
    that counts them and hands them on to DTensor)."""
    import collections

    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class DTensorOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                self.ops[func._overloadpacket.__name__] += 1
                return NotImplemented
            return func(*args, **(kwargs or {}))

    counter = DTensorOps()
    with counter:
        fn()
    torch.cuda.synchronize()
    return counter.ops


def mesh_overheads(tag: str, plain, meshed, extra_ms: float) -> dict:
    """What the 1-rank mesh adds to one call of ``meshed`` over ``plain``
    (the same work off the mesh): the c10d collectives the mesh call
    issues (``CommDebugMode``), the ops it dispatches on DTensors (a
    dispatch mode that counts them and hands them on), ``extra_ms`` (the
    mesh call's wall less the plain one's) over that count, and the device
    kernels of each call (``device_kernels(whole=True)``).  Checked: no
    collective and no NCCL kernel on the mesh (DTensor skips the size-1
    mesh dims), and, where both traces kept every event, the same device
    kernels, copies included, on and off the mesh: the mesh moves and
    copies nothing.  A trace that dropped events in all three tries
    decides nothing, and the line says so."""
    import collections

    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    names, whole_plain = device_kernels(plain, whole=True)
    k_plain = collections.Counter(names)
    names, whole_mesh = device_kernels(meshed, whole=True)
    k_mesh = collections.Counter(names)
    comm = CommDebugMode()
    with comm:
        meshed()
    torch.cuda.synchronize()
    ops_seen = dtensor_ops(meshed)
    n_ops = sum(ops_seen.values())
    n_coll = comm.get_total_counts()
    nccl = sum(n for k, n in k_mesh.items() if "nccl" in k.lower())

    def copies(c):
        return sum(n for k, n in c.items()
                   if "copy" in k.lower() or "memcpy" in k.lower())

    check(nccl == 0 and n_coll == 0,
          f"{tag}: the 1-rank mesh call issues {n_coll} c10d collectives "
          f"and launches {nccl} NCCL kernels (0 each)")
    more, fewer = k_mesh - k_plain, k_plain - k_mesh
    line = (f"{tag}: device kernels on the mesh {sum(k_mesh.values())} "
            f"({copies(k_mesh)} copies), off it {sum(k_plain.values())} "
            f"({copies(k_plain)} copies); more on the mesh "
            f"{dict(more.most_common(6))}, fewer {dict(fewer.most_common(6))}")
    whole = whole_plain and whole_mesh
    if whole:
        check(not more and not fewer, f"the same device kernels: {line}")
    else:
        print(f"  {line} (a trace dropped events: not decided)")
    per_op_us = extra_ms * 1e3 / n_ops if n_ops else float("nan")
    print(f"  {tag} a call: {n_ops} ops dispatched on DTensors "
          f"(top {dict(ops_seen.most_common(8))}); the mesh adds "
          f"{extra_ms:.4f} ms of wall, {per_op_us:.2f} us a DTensor op")
    return {"dtensor_ops": n_ops, "collectives": n_coll,
            "nccl_kernels": nccl, "traces_whole": whole,
            "kernels": {"mesh": sum(k_mesh.values()),
                        "plain": sum(k_plain.values())},
            "copies": {"mesh": copies(k_mesh), "plain": copies(k_plain)},
            "same_kernels": not more and not fewer,
            "extra_ms": extra_ms, "us_per_dtensor_op": per_op_us}


def captured_mesh(tag: str, b, want, counts: dict, ops) -> dict:
    """11m on one mesh forward: ``b.fn`` (``graphs.compiled`` of the mesh
    forward, as ``build_hgnn_infer(mesh=...)`` returns it on the card)
    warmed up and captured on the mesh under ``CommDebugMode``, then
    ITERS replays: every result bitwise the eager mesh forward's ``want``
    (a DTensor: local tensor and placements), one capture, no c10d
    collective in the capture, and the replays launching what the
    graph's traced replay launched (``measured_card``), which must be
    ``counts`` (the eager mesh forward's launches), times ITERS."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import graphs

    fn = b.fn
    check(isinstance(fn, graphs.Compiled),
          f"11m {tag}: build_hgnn_infer(mesh=...) compiles its forward on "
          f"the card ({type(fn).__name__})")
    comm = CommDebugMode()
    with comm, torch.inference_mode():
        outs = [fn(b.params, b.batch)]
    ops.reset_launch_counts()
    with torch.inference_mode():
        outs += [fn(b.params, b.batch) for _ in range(ITERS)]
    torch.cuda.synchronize()
    replayed = {k: v for k, v in ops.launch_counts().items() if v}
    traced = getattr(fn.graph_of(b.params, b.batch), "measured", None)
    per = {k: v for k, v in counts.items() if v}
    same = all(type(o).__name__ == "DTensor"
               and o.placements == want.placements
               and torch.equal(o.to_local(), want.to_local()) for o in outs)
    check(same, f"11m {tag}: {len(outs)} captured mesh forwards (the "
          f"capture's and {ITERS} replays) bitwise the eager mesh forward")
    n_coll = comm.get_total_counts()
    check(fn.captures == 1 and fn.replays == ITERS and traced == per
          and replayed == {k: v * ITERS for k, v in per.items()}
          and n_coll == 0,
          f"11m {tag}: {fn.captures} capture with {n_coll} c10d "
          f"collectives, {fn.replays} replays launching {replayed} (the "
          f"graph's traced replay {traced} x {ITERS}; the eager mesh "
          f"forward's {per})")
    return {"captures": fn.captures, "replays": fn.replays,
            "collectives": n_coll, "launches_a_replay_traced": traced}


def mesh_han(dev, ops, hg, mesh) -> dict:
    """9a: HAN/imdb full graph (fused, kernels, the NA->SA epilogue)
    through ``build_hgnn_infer(mesh=...)`` against the mesh-less build:
    the same weights (both from ``cfg.seed``), logits bitwise, the same
    ``gat_na`` (sem=) and ``semantic_combine`` launches."""
    import torch
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.launch.serve import build_hgnn_infer

    cfg = HGNNConfig(model="han", dataset="imdb", fused=True,
                     use_pallas=True, fuse_na_sa=True)
    plain = eager(build_hgnn_infer(cfg, hg, dev))
    compiled = build_hgnn_infer(cfg, hg, dev, mesh=mesh)
    meshed = eager(compiled)  # the eager mesh forward; 11m: the captured
    runs = {}
    for tag, b in (("mesh-less", plain), ("mesh", meshed)):
        ops.reset_launch_counts()
        with torch.inference_mode():
            out = b.fn(b.params, b.batch)
        torch.cuda.synchronize()
        runs[tag] = (out, ops.launch_counts())
    want, c_plain = runs["mesh-less"]
    got_mesh, c_mesh = runs["mesh"]
    check(type(got_mesh).__name__ == "DTensor",
          f"9a: the mesh forward returns a DTensor "
          f"({type(got_mesh).__name__})")
    got = got_mesh.full_tensor()
    check(got.shape == want.shape == (4278, 8)
          and bool(torch.isfinite(got).all()),
          f"9a: logits {tuple(got.shape)} finite")
    check(torch.equal(got, want),
          "9a: HAN/imdb mesh logits bitwise the mesh-less forward (max "
          f"|diff| {max_err(got, want):.3g})")
    check(c_mesh == c_plain and c_plain["gat_na_fused_sa"] == 1
          and c_plain["semantic_combine"] == 1,
          f"9a: launches on the mesh {c_mesh} = mesh-less {c_plain} (one "
          "gat_na sem= and one semantic_combine a forward)")

    def fwd(b):
        def go():
            with torch.inference_mode():
                b.fn(b.params, b.batch)
        return go

    rec11 = captured_mesh("9a HAN/imdb", compiled, got_mesh, c_mesh, ops)
    ms = wall_median_ms({"mesh-less": fwd(plain), "mesh": fwd(meshed),
                         "mesh captured": fwd(compiled)}, MESH_REPS)
    print(f"  9a HAN/imdb forward wall (median of {MESH_REPS}, in turns): "
          f"mesh {ms['mesh']:.4f} ms, mesh-less {ms['mesh-less']:.4f} ms; "
          f"launches {c_mesh['gat_na_fused_sa']} gat_na (sem=) + "
          f"{c_mesh['semantic_combine']} semantic_combine a forward")
    print(f"  11m HAN/imdb mesh forward wall (median of {MESH_REPS}, in "
          f"turns with the above): eager {ms['mesh']:.4f} ms, captured "
          f"{ms['mesh captured']:.4f} ms; card {card_line()}")
    over = mesh_overheads("9a HAN/imdb forward", fwd(plain), fwd(meshed),
                          ms["mesh"] - ms["mesh-less"])
    rec11["forward_ms"] = {"eager": ms["mesh"],
                           "captured": ms["mesh captured"]}
    return {"forward_ms": ms, "overheads": over, "compiled": rec11,
            "launches": {
        "gat_na_fused_sa": c_mesh["gat_na_fused_sa"],
        "semantic_combine": c_mesh["semantic_combine"]},
        "lse_launches": c_mesh["decode_attention_lse"]}


def mesh_granite(dev, ops, mesh) -> dict:
    """9b: granite-8b at full width (36 layers, bf16, the kernels): the
    prefill of 4 x 2048 tokens and 32 greedy decode steps through
    ``build_prefill_step`` / ``build_decode_step`` (``jit_step``'s eager
    arm, ``.fn``) on the mesh against ``lm_prefill`` / ``lm_decode_step``
    called directly: logits and tokens bitwise, the same flash_attention
    and decode_attention launches (36 a prefill, 36 a step); 11m: the same
    wave through the compiled ``jit_step`` (prefill captured, decode
    captured at its first step, the caches donated), bitwise the eager
    mesh wave, one capture each with no collective; then one more step
    through the step function on each path (``mesh_overheads``)."""
    import numpy as np
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.sharding import distribute_tree
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step, jit_step)
    from repro_torch.nn import transformer as tf

    cfg = get_config(GRANITE).replace(use_pallas=True)
    b, s, n = LM_SLOTS, LM_PROMPT, MESH_DECODE_STEPS
    params = tf.init_lm_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    rng = np.random.default_rng(9)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)).astype(
        np.int32), device=dev)
    pre = build_prefill_step(cfg, ShapeConfig("p", s, b, "prefill"), mesh)
    dec = build_decode_step(cfg, ShapeConfig("d", s + n, b, "decode"), mesh)
    with torch.inference_mode():  # DTensor views: inference tensors
        # laid out once, not a call
        p_mesh = distribute_tree(params, pre.in_shardings[0])
    prefill, decode = jit_step(pre), jit_step(dec)

    comm = {}  # 11m: the c10d collectives of each capture

    def wave(arm: str):
        """The prefill and ``n`` greedy steps: ``direct`` (no mesh),
        ``mesh`` (``jit_step``'s eager arm) or ``captured`` (``jit_step``
        compiled: its prefill captured and replayed once, traced, before
        the clock starts; its first decode step the decode's capture and
        its second the traced first replay, both timed apart)."""
        meshed = arm != "direct"
        pre_fn = prefill.fn if arm == "mesh" else prefill
        dec_fn = decode.fn if arm == "mesh" else decode
        logits_all, toks = [], []
        if arm == "captured":
            comm["prefill"] = CommDebugMode()
            with comm["prefill"], torch.inference_mode():
                pre_fn(p_mesh, {"tokens": tokens})
            with torch.inference_mode():  # the first replay: traced
                pre_fn(p_mesh, {"tokens": tokens})
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            if meshed:
                lg, pf = pre_fn(p_mesh, {"tokens": tokens})
                lg = lg.full_tensor()
                pf = tree.map(lambda c: c.full_tensor(), pf)
            else:
                lg, pf = tf.lm_prefill(params, cfg, tokens)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            caches = tf.graft_prefill_caches(
                cfg, tf.init_kv_caches(cfg, b, s + n, dev), pf, s)
            if meshed:
                caches = distribute_tree(caches, dec.in_shardings[2])
            del pf
            c_pre = ops.launch_counts()
            tok = lg[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
            logits_all.append(lg)
            toks.append(tok)
            torch.cuda.synchronize()
            t_steps = time.perf_counter()
            apart = []  # the capturing step and the traced first replay
            for i in range(n):
                pos = torch.tensor(s + i, dtype=torch.int32, device=dev)
                if meshed:
                    if arm == "captured" and i == 0:
                        comm["decode"] = CommDebugMode()
                        with comm["decode"]:
                            lg, caches = dec_fn(p_mesh, tok, caches, pos)
                    else:
                        lg, caches = dec_fn(p_mesh, tok, caches, pos)
                    lg = lg.full_tensor()
                else:
                    lg, caches = tf.lm_decode_step(params, cfg, tok, caches,
                                                   pos)
                tok = lg[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
                logits_all.append(lg)
                toks.append(tok)
                if arm == "captured" and i < 2:
                    torch.cuda.synchronize()
                    now = time.perf_counter()
                    apart.append((now - t_steps) * 1e3)
                    t_steps = now
            torch.cuda.synchronize()
            t_dec = time.perf_counter() - t_steps
        c_all = ops.launch_counts()
        per_step = t_dec * 1e3 / (n - len(apart))
        return (logits_all, torch.cat(toks, dim=1), c_pre, c_all,
                t_pre * 1e3, per_step, (tok, caches), apart)

    direct = wave("direct")
    meshed = wave("mesh")
    direct2 = wave("direct")  # the mesh-less times again, after the mesh's
    check(all(torch.equal(a, c) for a, c in zip(meshed[0], direct[0])),
          f"9b: granite logits on the mesh bitwise the direct calls over "
          f"the prefill and {n} decode steps")
    check(torch.equal(meshed[1], direct[1]) and torch.equal(direct2[1],
                                                             direct[1]),
          "9b: the same greedy tokens")
    captured = wave("captured")
    check(all(torch.equal(a, c) for a, c in zip(captured[0], meshed[0]))
          and torch.equal(captured[1], meshed[1]),
          f"11m granite-8b: the captured mesh prefill and {n} decode steps "
          f"give the eager mesh wave's tokens and every logit bitwise")
    layers = cfg.n_layers
    want_pre = dict(flash_attention=layers, decode_attention=0)
    want_all = dict(flash_attention=layers, decode_attention=layers * n)
    for tag, r in (("mesh", meshed), ("direct", direct),
                   ("11m captured", captured)):
        pre_c = {k: r[2][k] for k in want_pre}
        all_c = {k: r[3][k] for k in want_all}
        check(pre_c == want_pre and all_c == want_all,
              f"9b {tag}: launches prefill {pre_c}, whole {all_c} (want "
              f"{want_pre}, {want_all})")
    traced = {k: [getattr(g, "measured", None)
                  for g in j.compiled.graphs.values()]
              for k, j in (("prefill", prefill), ("decode", decode))}
    n_coll = {k: c.get_total_counts() for k, c in comm.items()}
    check((prefill.compiled.captures, prefill.compiled.replays,
           decode.compiled.captures, decode.compiled.replays)
          == (1, 2, 1, n - 1)
          and traced == {"prefill": [{"flash_attention": layers}],
                         "decode": [{"decode_attention": layers}]}
          and n_coll == {"prefill": 0, "decode": 0},
          f"11m granite-8b: one capture each (prefill "
          f"{prefill.compiled.captures}, decode {decode.compiled.captures}) "
          f"with {n_coll} c10d collectives, replays prefill "
          f"{prefill.compiled.replays} decode {decode.compiled.replays}, "
          f"each graph's traced replay {traced}")
    print(f"  11m granite-8b 4x{s} on the mesh: prefill eager "
          f"{meshed[4]:.2f} ms, captured {captured[4]:.2f} ms (its second "
          f"replay); decode a step eager {meshed[5]:.3f} ms, captured "
          f"{captured[5]:.3f} ms (the last {n - 2} steps; the capturing "
          f"step {captured[7][0]:.1f} ms, the traced first replay "
          f"{captured[7][1]:.1f} ms); card {card_line()}")
    compiled11 = {"prefill_ms": {"eager": meshed[4], "captured": captured[4]},
                  "decode_ms_per_step": {"eager": meshed[5],
                                         "captured": captured[5]},
                  "capture_step_ms": captured[7][0],
                  "traced_replay_step_ms": captured[7][1],
                  "collectives": n_coll,
                  "launches_a_replay_traced": traced}
    del captured, prefill, decode
    meshed_ms, direct_ms, direct2_ms = (r[4:6] for r in (meshed, direct,
                                                         direct2))
    launches = {k: meshed[3][k] for k in want_all}
    lse_launches = meshed[3]["decode_attention_lse"]
    print(f"  9b granite-8b 4x{s} prefill: mesh {meshed[4]:.2f} ms, direct "
          f"{direct[4]:.2f} / {direct2[4]:.2f} ms (before / after); decode "
          f"a step: mesh {meshed[5]:.3f} ms, direct {direct[5]:.3f} / "
          f"{direct2[5]:.3f} ms; launches on the mesh "
          f"{meshed[3]['flash_attention']} flash_attention + "
          f"{meshed[3]['decode_attention']} decode_attention")
    print(f"  tokens req0 (mesh): {meshed[1][0].tolist()}")
    # one decode step more at the last position, on each wave's caches:
    # the step function itself (dec.fn), its token and position laid out
    # once as jit_step lays them out each call
    last = torch.tensor(s + n - 1, dtype=torch.int32, device=dev)

    def step(meshed_step: bool):
        tok, caches = (meshed if meshed_step else direct2)[6]
        if meshed_step:
            with torch.inference_mode():
                tok, pos = (distribute_tree(x, sh) for x, sh in zip(
                    (tok, last), (dec.in_shardings[1], dec.in_shardings[3])))

        def go():
            with torch.inference_mode():
                if meshed_step:
                    dec.fn(p_mesh, tok, caches, pos)
                else:
                    tf.lm_decode_step(params, cfg, tok, caches, last)
        return go

    over = mesh_overheads("9b granite-8b decode step", step(False),
                          step(True), meshed[5] - direct2[5])
    del p_mesh, params, direct, meshed, direct2
    torch.cuda.empty_cache()
    return {"prefill_ms": {"mesh": meshed_ms[0], "direct": direct_ms[0],
                           "direct_after": direct2_ms[0]},
            "decode_ms_per_step": {"mesh": meshed_ms[1],
                                   "direct": direct_ms[1],
                                   "direct_after": direct2_ms[1]},
            "decode_overheads": over, "launches": launches,
            "lse_launches": lse_launches, "compiled": compiled11}


# 9d: every padded HGNN plan on the mesh: (tag, HGNNConfig kwargs, the
# kernels-line entry its gat_na launches belong to)
MESH_PLANS = (
    ("han/bucketed3", dict(model="han", fused=True, degree_buckets=3),
     "gat_na_bucketed"),
    ("han/layers2", dict(model="han", fused=True, layers=2), "gat_na"),
    ("rgcn/padded", dict(model="rgcn", fused=True), None),
    ("rgcn/bucketed3", dict(model="rgcn", fused=True, degree_buckets=3), None),
    ("magnn", dict(model="magnn"), "gat_na_unstacked"),
    ("han/partitions4", dict(model="han", fused=True, partitions=4), "gat_na"),
    ("rgcn/partitions4", dict(model="rgcn", fused=True, partitions=4), None),
    ("magnn/partitions4", dict(model="magnn", partitions=4),
     "gat_na_unstacked"),
    ("magnn/cache256", dict(model="magnn", cache_rows=CACHE_ROWS),
     "gat_na_unstacked"),
    ("han/overlap2", dict(model="han", fused=True, overlap=2), "gat_na"),
)
MESH_PLAN_REPS = 5  # interleaved forwards a 9d plan is timed over


def mesh_plans(dev, ops, hg, mesh) -> dict:
    """9d: every padded HGNN plan of MESH_PLANS at full IMDB width through
    ``build_hgnn_infer(mesh=...)`` under ``use_pallas`` against the
    mesh-less build (the same weights, from ``cfg.seed``): logits bitwise,
    no c10d collective, each kernel's launches as mesh-less; the walls in
    turns and the ops dispatched on DTensors a call.  Returns the records
    and the launches a kernels-line entry got."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.launch.serve import build_hgnn_infer

    recs, launches = {}, {}
    for tag, kw, gat_entry in MESH_PLANS:
        t0 = time.perf_counter()
        cfg = HGNNConfig(dataset="imdb", use_pallas=True, **kw)
        plain = eager(build_hgnn_infer(cfg, hg, dev))
        compiled = build_hgnn_infer(cfg, hg, dev, mesh=mesh)
        meshed = eager(compiled)
        runs = []
        for b in (plain, meshed):
            ops.reset_launch_counts()
            comm = CommDebugMode()
            with comm, torch.inference_mode():
                out = b.fn(b.params, b.batch)
            torch.cuda.synchronize()
            runs.append((out, ops.launch_counts(), comm.get_total_counts()))
        (want, c_plain, _), (got_mesh, c_mesh, n_coll) = runs
        got = got_mesh.full_tensor()
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape
              == (4278, 8), f"9d {tag}: logits {tuple(got.shape)} finite")
        check(torch.equal(got, want), f"9d {tag}: mesh logits bitwise the "
              f"mesh-less forward (max |diff| {max_err(got, want):.3g})")
        check(n_coll == 0, f"9d {tag}: {n_coll} c10d collectives (0)")
        used = {k: n for k, n in c_mesh.items() if n}
        check(c_mesh == c_plain and used,
              f"9d {tag}: launches on the mesh {used} = mesh-less "
              f"{ {k: n for k, n in c_plain.items() if n} }")

        def fwd(b):
            def go():
                with torch.inference_mode():
                    b.fn(b.params, b.batch)
            return go

        rec11 = captured_mesh(f"9d {tag}", compiled, got_mesh, c_mesh, ops)
        ms = wall_median_ms({"mesh-less": fwd(plain), "mesh": fwd(meshed),
                             "mesh captured": fwd(compiled)},
                            MESH_PLAN_REPS)
        seen = dtensor_ops(fwd(meshed))
        n_ops = sum(seen.values())
        print(f"  9d {tag}: forward wall (median of {MESH_PLAN_REPS}, in "
              f"turns) mesh {ms['mesh']:.4f} ms, mesh-less "
              f"{ms['mesh-less']:.4f} ms, 11m mesh captured "
              f"{ms['mesh captured']:.4f} ms; {n_ops} DTensor ops a call "
              f"(top {dict(seen.most_common(5))}); launches {used}; "
              f"{time.perf_counter() - t0:.1f} s")
        recs[tag] = {"forward_ms": ms, "dtensor_ops": n_ops,
                     "top_ops": dict(seen.most_common(8)),
                     "launches": used, "compiled": rec11}
        for name, n in used.items():
            entry = gat_entry if name == "gat_na" else name
            launches[entry] = launches.get(entry, 0) + n
        del plain, meshed, compiled
    return {"plans": recs, "launches": launches}


# 9e: the decode kernel's log-sum-exp form: (tag, (B, S, H, KVH, Dh),
# dtype, kv_len); phase 5c's granite decode shape, then a bf16 and an fp32
# case with a row of no live cache row
LSE_CASES = (
    ("granite decode bf16", (4, 2080, 32, 8, 128), "bfloat16",
     (1, 1000, 2049, 2080)),
    ("G 1 bf16", (2, 300, 8, 8, 64), "bfloat16", (0, 300)),
    ("odd Dh fp32", (2, 130, 6, 2, 7), "float32", (129, 0)),
)
TOL_LSE = dict(atol=1e-5, rtol=1e-5)  # fp32 lse, kernel vs plain
# the combined shards against the whole-cache kernel: fp32 sums in another
# order; in bf16 each shard's o is rounded to bf16 before the combine, so
# the bf16 result is held to a bf16 ulp or two of the whole-cache one
TOL_SPLIT = {"float32": dict(atol=1e-5, rtol=1e-5),
             "bfloat16": TOL_BF16_OUT}


def decode_lse(dev, flush) -> dict:
    """9e: ``decode_attention(..., return_lse=True)`` on the card: ``o``
    bitwise the kernel's output without the form, ``lse`` against the
    plain version on the fp32 values at 1e-5, ``o = 0`` and ``lse =
    -1e30`` on a row with no live row; granite's decode cache split into 2
    and 4 contiguous shards (one with no live row of some batch rows), the
    form run on each and the partials combined by
    ``nn/attention._combine_partials``, against the whole-cache kernel.
    Then the form timed at the 2-way split's first shard, cold and warm,
    beside its bound, its plain version and
    ``aten._scaled_dot_product_efficient_attention(compute_log_sumexp=
    True)`` (the kv heads repeated to the query heads beforehand)."""
    import torch
    from repro_torch.kernels import decode_attention as tdec
    from repro_torch.nn.attention import _combine_partials

    gen = torch.Generator(device=dev).manual_seed(29)
    before = tdec.decode_attention.lse_launches
    rec = {"cases": {}, "splits": {}}
    with torch.inference_mode():
        for tag, (b, s, h, kvh, dh), dt, lens in LSE_CASES:
            dtype = getattr(torch, dt)
            q, k, v = attn_inputs(gen, b, s, h, kvh, dh, dtype, decode=True)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            o, lse = tdec.decode_attention(q, k, v, kv_len, return_lse=True)
            o_then = tdec.decode_attention(q, k, v, kv_len)
            o_p, lse_p = tdec.decode_attention_plain(
                q.float(), k.float(), v.float(), kv_len, return_lse=True)
            torch.cuda.synchronize()
            dead = kv_len == 0
            err_lse, err_o = max_err(lse, lse_p), max_err(o, o_p)
            check(torch.equal(o, o_then), f"9e {tag}: o of the form bitwise "
                  "the kernel's output without it")
            check(close(lse, lse_p, **TOL_LSE), f"9e {tag}: lse vs plain max "
                  f"|err| {err_lse:.3e} (tol {TOL_LSE})")
            check(close(o.float(), o_p, **TOL_ATTN[dt]), f"9e {tag}: o vs "
                  f"plain max |err| {err_o:.3e} (tol {TOL_ATTN[dt]})")
            check(bool((o[dead] == 0).all() and (lse[dead] == -1e30).all()),
                  f"9e {tag}: {int(dead.sum())} rows with no live row give "
                  "o = 0, lse = -1e30")
            rec["cases"][tag] = {"max_abs_err_lse": err_lse,
                                 "max_abs_err_o": err_o}
        b, s, h, kvh, dh = LSE_CASES[0][1]
        kv_len = torch.tensor(LSE_CASES[0][3], dtype=torch.int32, device=dev)
        for dt in ("bfloat16", "float32"):
            q, k, v = attn_inputs(gen, b, s, h, kvh, dh, getattr(torch, dt),
                                  decode=True)
            whole = tdec.decode_attention(q, k, v, kv_len)
            for n in (2, 4):
                s_loc = s // n
                parts = [tdec.decode_attention(
                    q, k[:, r * s_loc:(r + 1) * s_loc].contiguous(),
                    v[:, r * s_loc:(r + 1) * s_loc].contiguous(),
                    torch.clamp(kv_len - r * s_loc, 0, s_loc).to(torch.int32),
                    return_lse=True) for r in range(n)]
                got = _combine_partials(torch.stack([p[0] for p in parts]),
                                        torch.stack([p[1] for p in parts]),
                                        q.dtype)
                torch.cuda.synchronize()
                empty = sum(int((p[1] == -1e30).all(dim=1).sum())
                            for p in parts)
                err = max_err(got, whole)
                check(empty > 0 and close(got.float(), whole.float(),
                                          **TOL_SPLIT[dt]),
                      f"9e {dt} cache in {n} shards ({empty} shard rows with "
                      f"no live row), combined vs the whole-cache kernel: "
                      f"max |err| {err:.3e} (tol {TOL_SPLIT[dt]})")
                rec["splits"][f"{dt} x{n}"] = {"max_abs_err": err,
                                               "empty_shard_rows": empty}
        # the form at the 2-way split's first shard, bf16, as a rank holds it
        q, k, v = attn_inputs(gen, b, s, h, kvh, dh, torch.bfloat16,
                              decode=True)
        s_loc = s // 2
        ks, vs = k[:, :s_loc].contiguous(), v[:, :s_loc].contiguous()
        kl = torch.clamp(kv_len, 0, s_loc).to(torch.int32)
        form = lambda: tdec.decode_attention(q, ks, vs, kl,  # noqa: E731
                                             return_lse=True)
        plain = lambda: tdec.decode_attention_plain(  # noqa: E731
            q, ks, vs, kl, return_lse=True)
        ms, warm_ms = time_ms(form, 20, flush), time_ms(form, 20)
        plain_ms = time_ms(plain, 5, flush)
        n_bytes, n_ops = tdec.work(q, ks, kl, return_lse=True)
        b_ms, b_by = bound(n_bytes, n_ops, PEAK_BF16_FLOPS)
        lib_ms, lib_note = None, None
        try:
            g = h // kvh
            qe = q[:, :, None]  # [B, H, 1, Dh]
            ke = ks.transpose(1, 2).repeat_interleave(g, dim=1)
            ve = vs.transpose(1, 2).repeat_interleave(g, dim=1)
            live = (torch.arange(s_loc, device=dev)[None, :]
                    < kl[:, None])[:, None, None, :]
            bias = torch.where(live, 0.0, float("-inf")).to(
                q.dtype).expand(b, h, 1, s_loc).contiguous()
            eff = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(  # noqa: E731,E501
                qe, ke, ve, bias, True)
            o_l, lse_l = eff()[:2]
            o_k, lse_k = form()
            lib_note = (f"o max |err| {max_err(o_l[:, :, 0], o_k):.3e}, lse "
                        f"max |err| {max_err(lse_l[:, :, 0], lse_k):.3e} "
                        "against the form (not gated)")
            lib_ms = time_ms(eff, 20, flush)
        except Exception as e:  # the yardstick only: the port never calls it
            lib_note = f"none: {type(e).__name__}: {str(e)[:200]}"
        rec["timing"] = {
            "shape": f"q [4, 32, 128], cache shard [4, {s_loc}, 8, 128] of "
                     f"the 2-way split, kv_len {kl.tolist()}, bf16",
            "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            "operations": n_ops, "library_ms": lib_ms,
            "library": "aten._scaled_dot_product_efficient_attention("
                       "compute_log_sumexp=True), kv heads repeated",
            "library_note": lib_note}
        print(f"  9e log-sum-exp form at the 2-way split's first shard: "
              f"{ms:.5f} ms cold, {warm_ms:.5f} ms warm (plain "
              f"{plain_ms:.5f} ms, bound {b_ms:.5f} ms by {b_by}, efficient "
              f"attention "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.5f} ms'}; "
              f"{lib_note})")
    rec["check_launches"] = tdec.decode_attention.lse_launches - before
    return rec


def mesh_dryrun() -> dict:
    """9c: ``python -m repro_torch.launch.dryrun --arch granite-8b`` over
    its three shapes on 16x16 (the fake process group, no device memory):
    one subprocess a shape, the three at once, each under a timeout; one
    line a cell."""
    import os

    out_dir = ROOT / "build" / "dryrun"  # git-ignored
    if out_dir.is_dir():
        for f in out_dir.glob("granite-8b__*.json"):
            f.unlink()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    shapes = ("train_4k", "prefill_32k", "decode_32k")
    t0 = time.perf_counter()
    procs = {shape: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-8b", "--shape", shape, "--out", str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for shape in shapes}
    cells = {}
    for shape, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=max(
                1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        check(proc.returncode == 0, f"9c: the {shape} dry run exited "
              f"{proc.returncode}: {out[-3000:]}")
        path = out_dir / f"granite-8b__{shape}__16x16.json"
        if not check(path.is_file(), f"9c: {path.name} written"):
            continue
        rep = json.loads(path.read_text())
        dev_rec = rep["per_device"]
        cells[shape] = {
            "argument_gib": dev_rec["argument_bytes"] / 2 ** 30,
            "output_gib": dev_rec["output_bytes"] / 2 ** 30,
            "flops": dev_rec["total_flops"],
            "hbm_bytes": dev_rec["total_hbm_bytes"],
            "collective_bytes": dev_rec["collective_bytes"],
            "bound": rep["roofline"]["bound"],
            "step_time_s": rep["roofline"]["step_time_s"],
            "run_s": rep["run_s"]}
        c = cells[shape]
        print(f"  9c granite-8b {shape} 16x16, per device: arguments "
              f"{c['argument_gib']:.4f} GiB, FLOPs {c['flops']:.6g}, HBM "
              f"bytes {c['hbm_bytes']:.6g}, collective bytes "
              f"{c['collective_bytes']:.6g}, bound {c['bound']} "
              f"({c['step_time_s'] * 1e3:.4f} ms at the H100's rates; "
              f"{c['run_s']} s on the host)")
    dt = time.perf_counter() - t0
    print(f"  9c dry run: {dt:.1f} s (three processes at once)")
    return {"cells": cells, "seconds": dt}


def mesh_phase(dev, ops, hg, flush) -> dict:
    """Phase 9: a 1-rank NCCL process group (``HashStore``) and a ``(data=
    1, model=1)`` mesh for 9a, 9b and 9d, destroyed at the end of them;
    then 9e (one card, no mesh) and 9c, which needs no card."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_smoke_mesh(data=1, model=1)
        print(f"  mesh: {mesh}")
        rec = {"han": mesh_han(dev, ops, hg, mesh)}
        rec["granite"] = mesh_granite(dev, ops, mesh)
        t = time.perf_counter()
        print("  9d: every padded HGNN plan on the mesh, HAN/RGCN/MAGNN "
              "imdb at full width, use_pallas")
        rec["plans"] = mesh_plans(dev, ops, hg, mesh)
        print(f"  9d: {time.perf_counter() - t:.1f} s")
        # the decode kernel's log-sum-exp form, counted over 9a, 9b and 9d
        rec["lse_form_launches"] = (
            rec["han"]["lse_launches"] + rec["granite"]["lse_launches"]
            + rec["plans"]["launches"].get("decode_attention_lse", 0))
        print(f"  9a/9b/9d: the decode kernel's log-sum-exp form launched "
              f"{rec['lse_form_launches']} times (a cache of one rank is "
              f"never split over the sequence)")
    finally:
        dist.destroy_process_group()
    t = time.perf_counter()
    print("  9e: decode_attention's log-sum-exp form, and a cache split "
          "into shards combined")
    rec["lse"] = decode_lse(dev, flush)
    print(f"  9e: {time.perf_counter() - t:.1f} s")
    rec["dryrun"] = mesh_dryrun()
    return rec


# ---------------------------------------------------------------------------
# elastic restart (phase 10): smollm-360m trained on a 1-rank NCCL mesh,
# checkpointed and restarted onto a fresh mesh, HAN/imdb served after a
# mesh collapse, and the training launcher under torchrun
# ---------------------------------------------------------------------------

ELASTIC_STEPS = 2  # mesh steps before the checkpoint, and after the restart
LAUNCH_ARGS = ("--arch", "smollm-360m", "--steps", "3", "--seq-len", "128",
               "--batch", "8")
LAUNCH_TIMEOUT_S = 300


def cuda_mesh(shape, names):
    """A ``dist.sharding.Mesh`` over the default NCCL group's ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.sharding import Mesh

    return Mesh.from_device_mesh(init_device_mesh("cuda", shape,
                                                  mesh_dim_names=names))


def bitwise(a, b) -> bool:
    """Two trees of the same structure, leaf for leaf the same dtype and
    bits (a DTensor leaf made whole first)."""
    import torch
    from repro_torch import tree
    from repro_torch.dist.sharding import whole

    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(whole(x), whole(y))
        for x, y in zip(la, lb))


def elastic_train(dev, ops) -> dict:
    """10a and 10b: smollm-360m as phase 6c trains it (32 layers, bf16,
    remat full, fp32 AdamW, seq 2048, global batch 8 in 2 microbatches),
    its state laid out on a ``(data=1, model=1)`` NCCL mesh by
    ``reshard_state(state, state_shardings(...))`` and trained through
    ``build_train_step`` / ``jit_step`` (its eager arm, ``.fn``): two
    steps bitwise the mesh-less ``make_train_step`` with the same
    ``segment_sum`` launches, the steps of the two arms taken and timed in
    turns.  The mesh state after two steps saved through
    ``AsyncCheckpointer`` (bytes from the manifest, save and restore
    seconds), restored with ``restore(shardings=)`` onto the mesh that
    ``surviving_mesh`` leaves of a ``(pod=1, data=1, model=1)`` mesh, two
    more steps there bitwise the uninterrupted four-step mesh run.  At 2
    layers, the mesh save's digest equals the mesh-less save's.  11t: the
    compiled ``jit_step`` (the state donated) from a copy of the state at
    step 0 over the four steps of the uninterrupted mesh run, bitwise it,
    and one more (``captured_train``)."""
    import dataclasses
    import gc
    import math
    import shutil

    import torch
    from repro_torch import tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.loader import synth_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.steps import build_train_step, jit_step
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import reshard_state, surviving_mesh
    from repro_torch.train.optimizer import build_optimizer
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step,
                                              state_shardings)

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(SMOLLM)
    shape = ShapeConfig("10a", TRAIN_SEQ, TRAIN_BATCH, "train")
    opt = build_optimizer(cfg)
    state = init_train_state(torch.Generator(device=dev).manual_seed(0),
                             cfg, opt)
    batches = [launch_train.to_device(synth_batch(cfg, shape, i), dev)
               for i in range(2 * ELASTIC_STEPS)]
    mesh = cuda_mesh((1, 1), ("data", "model"))

    def layout(m):
        return state_shardings(state, opt, m, fsdp=cfg.fsdp,
                               fsdp_experts=cfg.fsdp_experts)

    def mesh_step(m):
        return jit_step(build_train_step(cfg, shape, m,
                                         n_microbatches=TRAIN_MB))

    plain = make_train_step(cfg, opt, n_microbatches=TRAIN_MB)
    step = mesh_step(mesh)
    laid = reshard_state(state, layout(mesh))

    def run(fn, s, todo):
        ops.reset_launch_counts()
        losses, gnorms = [], []
        for b in todo:
            s, m = fn(s, b)
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
        torch.cuda.synchronize()
        return s, losses, ops.launch_counts(), gnorms

    # the first steps of both arms in turns (mesh-less, mesh, ...), each
    # timed and its launches counted alone; the mesh arm is jit_step's
    # eager one (11t: the compiled one)
    arms = {"mesh-less": [plain, state, [], {}, [], []],
            "mesh": [step.fn, laid, [], {}, [], []]}
    for b in batches[:ELASTIC_STEPS]:
        for arm in arms.values():
            fn, s_in, losses, counts, walls, gnorms = arm
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            arm[1], m = fn(s_in, b)
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            for n, v in ops.launch_counts().items():
                counts[n] = counts.get(n, 0) + v
    _, s_plain, l_plain, c_plain, w_plain, _ = arms["mesh-less"]
    _, s_mesh, l_mesh, c_mesh, w_mesh, g_mesh = arms["mesh"]
    del arms
    want_ss = TRAIN_MB * ELASTIC_STEPS
    check(type(l_mesh[0]).__name__ == "DTensor"
          and bitwise(l_mesh, l_plain),
          f"10a: {ELASTIC_STEPS} mesh steps' losses "
          f"{[float(x.full_tensor()) for x in l_mesh]} bitwise the "
          f"mesh-less make_train_step's {[float(x) for x in l_plain]}")
    check(bitwise(s_mesh, s_plain),
          f"10a: every state leaf after {ELASTIC_STEPS} mesh steps bitwise "
          f"the mesh-less run's")
    check(c_mesh == c_plain == dict(dict.fromkeys(c_plain, 0),
                                    segment_sum=want_ss),
          f"10a: launches on the mesh {c_mesh}, mesh-less {c_plain} (want "
          f"{want_ss} segment_sum)")
    del s_plain
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  10a smollm-360m train step (batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{TRAIN_MB} microbatches), steps 1 / 2 of each arm taken in "
          f"turns: mesh {' / '.join(f'{w:.2f}' for w in w_mesh)} ms, "
          f"mesh-less {' / '.join(f'{w:.2f}' for w in w_plain)} ms")
    print(f"  card: {card_line()}")

    # 10b: the checkpoint of the mesh state, and the restart
    root = ROOT / "build" / "phase10_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    try:
        saver = ckpt.AsyncCheckpointer(str(root / "mesh"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saver.submit(s_mesh, ELASTIC_STEPS)
        submit_s = time.perf_counter() - t0
        saver.close()
        save_s = time.perf_counter() - t0
        d = root / "mesh" / f"step_{ELASTIC_STEPS:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        size = {"bfloat16": 2, "float32": 4, "int32": 4}
        n_bytes = sum(math.prod(sh) * size[dt] for sh, dt in
                      zip(manifest["shapes"], manifest["dtypes"]))
        file_bytes = (d / "shard_00000.npz").stat().st_size
        by_dtype = {}
        for sh, dt in zip(manifest["shapes"], manifest["dtypes"]):
            by_dtype[dt] = by_dtype.get(dt, 0) + math.prod(sh) * size[dt]
        print(f"  10b checkpoint of the mesh state at step {ELASTIC_STEPS}: "
              f"{manifest['n_leaves']} leaves, {n_bytes} bytes by the "
              f"manifest ({by_dtype}), a {file_bytes}-byte .npz; "
              f"AsyncCheckpointer.submit (gather + copy to the host) "
              f"{submit_s:.2f} s, submit to close (written, digest, "
              f"published) {save_s:.2f} s")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held_gib = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        whole, l_whole, c_whole, g_whole = run(step.fn, s_mesh,
                                               batches[ELASTIC_STEPS:])
        eager_peak = {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "held_gib": held_gib}
        print(f"  10b the uninterrupted mesh run's steps 3 and 4 (eager): "
              f"peak memory allocated {eager_peak['peak_gib']:.2f} GiB "
              f"({held_gib:.2f} GiB held before them)")
        # 11t: the compiled jit_step from a copy of the state at step 0
        # (donated), over the steps of the eager mesh run and one more
        # (timed only: three replays after the traced one)
        want = [(loss, g, None) for loss, g in zip(l_mesh + l_whole,
                                                   g_mesh + g_whole)]
        want[ELASTIC_STEPS - 1] = want[ELASTIC_STEPS - 1][:2] + (s_mesh,)
        want[-1] = want[-1][:2] + (whole,)
        rec11 = captured_train(
            "smollm-360m on the mesh", step,
            reshard_state(tree.map(torch.clone, state), layout(mesh)),
            batches + batches[:1], want + [None], ops)
        rec11["eager_step_ms"] = w_mesh
        rec11["eager_memory"] = eager_peak
        gc.collect()
        torch.cuda.empty_cache()
        fresh = surviving_mesh(cuda_mesh((1, 1, 1), ("pod", "data",
                                                      "model")), [])
        check(fresh.axis_names == ("data", "model")
              and fresh.device_mesh.device_type == "cuda",
              f"10b: surviving_mesh of (pod=1, data=1, model=1) with no "
              f"pod lost: {fresh}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = ckpt.restore(str(root / "mesh"), state,
                            shardings=layout(fresh))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        print(f"  10b restore(shardings=) onto the fresh mesh: "
              f"{restore_s:.2f} s (read, digest, upload, lay out)")
        check(bitwise(back, s_mesh) and all(
            x.device_mesh == fresh.device_mesh
            for x in tree.leaves(back)),
              "10b: the restored state bitwise the saved one, on the fresh "
              "mesh")
        del s_mesh
        restarted, l_restart, c_restart, _ = run(mesh_step(fresh).fn, back,
                                                 batches[ELASTIC_STEPS:])
        check(bitwise(l_restart, l_whole) and bitwise(restarted, whole),
              f"10b: {ELASTIC_STEPS} steps after the restart: losses "
              f"{[float(x.full_tensor()) for x in l_restart]} and state "
              f"bitwise the uninterrupted {2 * ELASTIC_STEPS}-step mesh run")
        check(c_restart == c_whole == c_mesh,
              f"10b: launches after the restart {c_restart}, uninterrupted "
              f"{c_whole}")
        del back, restarted, whole
        gc.collect()
        torch.cuda.empty_cache()

        # the digest at 2 layers of full width
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        opt2 = build_optimizer(cfg2)
        st2 = init_train_state(torch.Generator(device=dev).manual_seed(1),
                               cfg2, opt2)
        laid2 = reshard_state(st2, state_shardings(
            st2, opt2, mesh, fsdp=cfg2.fsdp, fsdp_experts=cfg2.fsdp_experts))
        digests = {}
        for tag, s in (("mesh", laid2), ("mesh-less", st2)):
            ckpt.save(s, str(root / f"two_{tag}"), step=0)
            dd = root / f"two_{tag}" / "step_00000000"
            digests[tag] = (json.loads((dd / "manifest.json").read_text()),
                            (dd / "shard_00000.npz").read_bytes())
        check(digests["mesh"] == digests["mesh-less"],
              f"10b: at 2 layers the mesh save's manifest (digest "
              f"{digests['mesh'][0]['digest']['0'][:16]}...) and .npz equal "
              f"the mesh-less save's (digest "
              f"{digests['mesh-less'][0]['digest']['0'][:16]}...)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"step_ms": {"mesh": w_mesh, "mesh-less": w_plain},
            "compiled": rec11,
            "losses": [float(x) for x in l_plain],
            "launches": {"mesh": c_mesh["segment_sum"]
                         + c_whole["segment_sum"]
                         + c_restart["segment_sum"],
                         "mesh-less": c_plain["segment_sum"]},
            "checkpoint": {"bytes": n_bytes, "file_bytes": file_bytes,
                           "by_dtype": by_dtype,
                           "n_leaves": manifest["n_leaves"],
                           "submit_s": submit_s, "save_s": save_s,
                           "restore_s": restore_s}}


def elastic_serve(dev, ops, hg) -> dict:
    """10c: HAN/imdb at full width (fused, partitioned in 2, use_pallas) on
    the serve CLI's request mix (32 requests, 8 slots of 4 targets, fan-out
    8), its parameters replicated on a ``(pod=1, data=1, model=1)`` NCCL
    mesh and resharded onto ``surviving_mesh(mesh, [])`` (the collapse to
    ``(data, model)``): each serve bitwise the mesh-less one with the same
    ``gat_na`` launches (unstacked, one a partition; the partitioned SA
    runs its plain version, as the reference's partitioned forward runs
    XLA only), and a serve losing partition 0 at step 3 bitwise too."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.dist.sharding import NamedSharding, P
    from repro_torch.launch.serve import build_hgnn_infer, request_queue
    from repro_torch.serve.engine import HGNNServeEngine
    from repro_torch.serve.faults import Fault, FaultInjector
    from repro_torch.serve.sampler import HGNNSampler
    from repro_torch.train.elastic import reshard_state, surviving_mesh

    cfg = HGNNConfig(model="han", dataset="imdb", fused=True, partitions=2,
                     use_pallas=True, fanout=SERVE_FANOUT)
    b = build_hgnn_infer(cfg, hg, dev)
    sampler = HGNNSampler(b.plan, cfg, hg)
    pods = cuda_mesh((1, 1, 1), ("pod", "data", "model"))
    survivors = surviving_mesh(pods, failed_pods=[])
    check(survivors.axis_names == ("data", "model")
          and tuple(survivors.shape.values()) == (1, 1),
          f"10c: surviving_mesh of {pods} with no pod lost collapses to "
          f"{survivors}")

    def replicated(m):
        return tree.map(lambda _: NamedSharding(m, P()), b.params)

    p_pods = reshard_state(b.params, replicated(pods))
    p_surv = reshard_state(p_pods, replicated(survivors))
    check(all(x.device_mesh == survivors.device_mesh
              for x in tree.leaves(p_surv) if torch.is_tensor(x)),
          "10c: every parameter replicated on the survivors' mesh")

    def serve(params, inj=None):
        eng = HGNNServeEngine(b.executor, params, sampler,
                              slots=SERVE_SLOTS,
                              slot_targets=SERVE_SLOT_TARGETS, fn=b.fn,
                              injector=inj)
        reqs = request_queue(sampler.n_target_type, SERVE_SLOT_TARGETS,
                             SERVE_REQUESTS)
        ops.reset_launch_counts()
        eng.warmup()
        eng.serve(reqs)
        torch.cuda.synchronize()
        return eng, reqs, ops.launch_counts()

    runs = {"mesh-less": serve(b.params), "pods": serve(p_pods),
            "survivors": serve(p_surv),
            "failover": serve(p_surv, FaultInjector(
                [Fault(step=3, kind="partition", partition=0)]))}
    _, want, c_plain = runs["mesh-less"]
    for tag, (eng, reqs, counts) in runs.items():
        rs = eng.stats()["resilience"]
        check(all(r.status == "OK" for r in reqs) and rs["failed_steps"] == 0
              and rs["retries"] == 0 and eng.device.type == "cuda",
              f"10c {tag}: {len(reqs)} requests OK on {eng.device}, no "
              f"failed step, no retry")
        if tag == "mesh-less":
            continue
        check(all(np.array_equal(r.logits, w.logits)
                  for r, w in zip(reqs, want)),
              f"10c {tag}: every request's logits bitwise the mesh-less "
              f"serve's")
    for tag in ("pods", "survivors"):
        counts = runs[tag][2]
        check(counts == c_plain == dict(dict.fromkeys(c_plain, 0),
                                        gat_na=c_plain["gat_na"])
              and c_plain["gat_na"] > 0,
              f"10c {tag}: launches {counts} = mesh-less {c_plain} (gat_na "
              f"only)")
    eng_f = runs["failover"][0]
    check(eng_f.stats()["resilience"]["partition_failovers"] == 1
          and eng_f._serve_plan.partition.k == 1,
          f"10c failover: partition 0 lost at step 3, "
          f"{eng_f._serve_plan.partition.k} partition served after it")
    c_fail = runs["failover"][2]
    n_targets = sum(len(r.targets) for r in want)
    print(f"  10c han/imdb +partitions=2 served {len(want)} requests "
          f"({n_targets} targets, {runs['mesh-less'][0].stats()['steps']} "
          f"steps) on the mesh-less, pod-mesh, survivors' and failover "
          f"runs; launches a run {c_plain}, failover {c_fail}")
    mesh_launches = {"gat_na": sum(runs[t][2]["gat_na"] for t in
                                   ("pods", "survivors", "failover"))}
    return {"launches": mesh_launches, "mesh_less_launches": c_plain,
            "failover_launches": c_fail, "requests": len(want),
            "targets": n_targets}


def elastic_launcher() -> dict:
    """10d: ``launch/train.py`` under ``torchrun --standalone
    --nproc_per_node 1 ... --distributed`` (one NCCL rank on the card) and
    without it, each a subprocess with a timeout: the same step losses."""
    import os
    import signal

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmds = {"torchrun": [sys.executable, "-m", "torch.distributed.run",
                         "--standalone", "--nproc_per_node", "1", "-m",
                         "repro_torch.launch.train", "--distributed",
                         *LAUNCH_ARGS],
            "single": [sys.executable, "-m", "repro_torch.launch.train",
                       *LAUNCH_ARGS]}
    out = {}
    for tag, cmd in cmds.items():
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env,
                                cwd=ROOT, start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            stdout, stderr = proc.communicate()
        lines = [ln for ln in stdout.splitlines() if ln.startswith("step")]
        out[tag] = {"rc": proc.returncode, "seconds":
                    time.perf_counter() - t0,
                    "losses": [ln.split()[3] for ln in lines]}
        check(proc.returncode == 0 and len(lines) == 3,
              f"10d {tag}: rc {proc.returncode}, {len(lines)} step lines in "
              f"{out[tag]['seconds']:.1f} s"
              + ("" if proc.returncode == 0 else f": {stderr[-2000:]}"))
        for ln in stdout.splitlines()[:1] + lines:
            print(f"    {tag}: {ln}")
    check(out["torchrun"]["losses"] == out["single"]["losses"],
          f"10d: the distributed launcher's losses "
          f"{out['torchrun']['losses']} = the single process's "
          f"{out['single']['losses']}")
    return out


def elastic_phase(dev, ops, hg) -> dict:
    """Phase 10: a 1-rank NCCL process group (``HashStore``) for 10a, 10b
    and 10c, destroyed at the end of them; then 10d, whose torchrun opens
    its own."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        t = time.perf_counter()
        rec = {"train": elastic_train(dev, ops)}
        print(f"  10a/10b: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        rec["serve"] = elastic_serve(dev, ops, hg)
        print(f"  10c: {time.perf_counter() - t:.1f} s")
    finally:
        dist.destroy_process_group()
    t = time.perf_counter()
    rec["launcher"] = elastic_launcher()
    print(f"  10d: {time.perf_counter() - t:.1f} s")
    return rec


def characterization(hg, hg_r, dev) -> dict:
    """Phase 3l: ``stage_records(timed=True)`` through
    ``HGNNInferEngine.characterize`` on HAN/imdb's baseline (``csr``) and
    optimized (fused, the epilogue) plans, RGCN/imdb's and MAGNN/imdb's
    baselines, MAGNN/imdb optimized with 256 hot rows and GCN/Reddit at
    scale 0.1.  Checked: the card's FLOPs and bytes equal the CPU's records
    of the same plan exactly (the batch moved to the CPU, the same
    parameters); each stage's device time by class sums to its device
    time; no device kernel lands in OTHER; each stage's ``time_us`` is its
    CUDA graph's replay (``stage_fns`` compiles each stage, as the
    reference jits it) while its records and ``device_us`` come from the
    eager stage, so the replay's device kernels must be the eager stage's,
    name for name and count for count (memory copies and sets aside).
    Printed: a line a stage, as the CLI prints it, with the eager stage's
    wall beside the replay's, the Fig. 2 shares of each case's device
    time, and the stages' summed times beside the forward's wall (the
    stage split adds a synchronisation a stage: a line to read, not a
    check)."""
    import functools
    import math
    from collections import Counter

    import torch
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.core import characterize as ch
    from repro_torch.launch.serve import build_hgnn_infer, stage_line
    from repro_torch.serve.engine import HGNNInferEngine

    han = HGNNConfig(model="han", dataset="imdb")
    cases = [
        ("han/imdb baseline", han.replace(fused=False), hg),
        ("han/imdb optimized", han.replace(fused=True, use_pallas=True,
                                           fuse_na_sa=True), hg),
        ("rgcn/imdb baseline",
         HGNNConfig(model="rgcn", dataset="imdb", fused=False), hg),
        ("magnn/imdb baseline", HGNNConfig(model="magnn", dataset="imdb"),
         hg),
        (f"magnn/imdb optimized cache_rows={CACHE_ROWS}",
         HGNNConfig(model="magnn", dataset="imdb", use_pallas=True,
                    cache_rows=CACHE_ROWS), hg),
        ("gcn/reddit-0.1", HGNNConfig(model="gcn", dataset="reddit"), hg_r),
    ]
    keys = ("flops", "hbm_bytes", "flops_by_class", "hbm_bytes_by_class")
    out = {}
    for tag, cfg, graph in cases:
        b = build_hgnn_infer(cfg, graph, dev)
        engine = HGNNInferEngine(b.executor, b.params, b.batch, fn=b.fn)
        recs = engine.characterize(timed=True)
        on_cpu = b.executor.stage_records(to_device(b.params, "cpu"),
                                          to_device(b.batch, "cpu"))
        same = list(recs) == list(on_cpu["stages"]) and all(
            recs[n][k] == on_cpu["stages"][n][k] for n in recs for k in keys)
        check(same, f"{tag}: the card's records (FLOPs, bytes, by class) "
                    f"equal the CPU's exactly")
        fns = b.executor.stage_fns(b.params, b.batch)

        def kernels_of(fn):
            return Counter(n for n in device_kernels(fn)
                           if not n.startswith(("Memcpy", "Memset")))

        eager_us = {}
        with torch.inference_mode():
            for name, (f, a) in fns.items():
                f(*a)  # the head's capture: the chain runs every other
                eager_us[name] = ch.stage_time_us(functools.partial(f.fn,
                                                                    *a))
                if not recs[name]["hbm_bytes"]:
                    continue  # a stage of no op launches no kernel
                eager_k = kernels_of(functools.partial(f.fn, *a))
                replay_k = kernels_of(f.graph_of(*a).graph.replay)
                check(eager_k == replay_k,
                      f"{tag} {name}: the replay's device kernels "
                      f"{dict(replay_k)} are the eager stage's "
                      f"{dict(eager_k)}")
        for name, rec in recs.items():
            rec["eager_time_us"] = eager_us[name]
            print(f"  {tag} {name}: {stage_line(rec)} (replay; eager stage "
                  f"{eager_us[name]:.1f} us)")
            check(math.isclose(sum(rec["device_us_by_class"].values()),
                               rec["device_us"], rel_tol=1e-9),
                  f"{tag} {name}: device time by class sums to "
                  f"{rec['device_us']:.3f} us")
            check(not rec["other_kernels"],
                  f"{tag} {name}: no device kernel in OTHER "
                  f"{rec['other_kernels']}")
        dev_total = sum(r["device_us"] for r in recs.values())
        time_total = sum(r["time_us"] for r in recs.values())
        wall = wall_ms(engine)
        print(f"  Fig. 2 {tag}: device {dev_total:.1f} us, " + ", ".join(
            f"{n} {100 * r['device_us'] / dev_total:.1f}%"
            for n, r in recs.items()) + "; stage walls " + ", ".join(
            f"{n} {100 * r['time_us'] / time_total:.1f}%"
            for n, r in recs.items()))
        print(f"  {tag}: stages' time_us sum {time_total:.1f} us beside the "
              f"forward wall {1e3 * wall:.1f} us")
        out[tag] = {"stages": recs, "time_us_sum": time_total,
                    "eager_time_us_sum": sum(eager_us.values()),
                    "wall_us": 1e3 * wall}
        del b, engine, fns
        gc.collect()
        torch.cuda.empty_cache()
    return out


def compiled_phase(phase11: dict, serve_rec: dict, part_rec: dict,
                   serve: dict, mesh_rec: dict, train_rec: dict,
                   elastic_rec: dict) -> dict:
    """Phase 11's record: the full-graph forwards ``drive_variant``
    recorded (``captured_vs_eager``), the served requests of phase 3m
    eager against captured with the upload pageable against pinned, the
    failover serve's captures (3p), granite-8b's decode
    (``decode_vs_eager``, 5c), the mesh steps captured beside phase 9
    (11m: ``captured_mesh``, granite's ``jit_step`` wave) and the training
    steps captured beside phases 6c and 10a (11t: ``captured_train``)."""
    want11 = {f"{pre}L={n}{post}" for n in (1, 2) for pre, post in (
        ("", " fuse_na_sa=True"), ("rgcn ", " padded"),
        ("magnn ", " cache_rows=0"), ("gcn/reddit ", " cache_rows=0"))}
    check(set(phase11) == want11,
          f"11: the full-graph forwards recorded {sorted(phase11)}")
    for tag, r in sorted(phase11.items()):
        print(f"  11 forward {tag}: eager {r['eager_ms']:.4f} ms, captured "
              f"{r['captured_ms']:.4f} ms; captured busy "
              f"{100 * r['captured_busy_share']:.1f}%")
    served11 = {}
    for tag, r in serve_rec.items():
        if "eager" not in r:
            continue
        served11[tag] = {
            "step_wall_p50_ms": {"eager": r["eager"]["step_wall_p50_ms"],
                                 "captured": r["step_wall_p50_ms"]["median"]},
            "step_wall_p99_ms": {"eager": r["eager"]["step_wall_p99_ms"],
                                 "captured": r["step_wall_p99_ms"]["median"]},
            "targets_per_s": {"eager": r["eager"]["targets_per_s"],
                              "captured": r["targets_per_s"]["median"]},
            "upload": {"pageable_mib": r["h2d_mib_last_batch"],
                       "pageable_ms": r["h2d_ms_last_batch"],
                       "pinned_mib": r["pinned_upload_mib_last_batch"],
                       "pinned_ms": r["pinned_upload_ms_last_batch"]},
            "captures": r["captures"], "replays": r["replays"]}
        v = served11[tag]
        print(f"  11 {tag}: step p50 {v['step_wall_p50_ms']}, p99 "
              f"{v['step_wall_p99_ms']}, targets/s {v['targets_per_s']} "
              f"(eager, captured); upload {v['upload']}")
    g11 = serve["compiled"]
    print(f"  11 granite-8b decode ms a step {g11['decode_ms_per_step']} "
          f"(eager, captured); busy eager "
          f"{100 * g11['eager_decode_busy_share']:.1f}%, captured "
          f"{100 * g11['captured_decode_busy_share']:.1f}%")
    mesh11 = {"han": mesh_rec["han"]["compiled"],
              "plans": {k: r["compiled"]
                        for k, r in mesh_rec["plans"]["plans"].items()},
              "granite": mesh_rec["granite"]["compiled"]}
    card = card_line()
    h = mesh11["han"]["forward_ms"]
    print(f"  11m HAN/imdb mesh forward: eager {h['eager']:.4f} ms, "
          f"captured {h['captured']:.4f} ms; card {card}")
    for tag, r in sorted(mesh_rec["plans"]["plans"].items()):
        print(f"  11m {tag} mesh forward: eager {r['forward_ms']['mesh']:.4f}"
              f" ms, captured {r['forward_ms']['mesh captured']:.4f} ms")
    g = mesh11["granite"]
    print(f"  11m granite-8b mesh prefill ms {g['prefill_ms']}, decode ms a "
          f"step {g['decode_ms_per_step']} (eager, captured); card {card}")
    train11 = {"mesh-less": train_rec["compiled"],
               "mesh": elastic_rec["train"]["compiled"]}
    t = train11["mesh-less"]
    print(f"  11t smollm-360m step mesh-less: eager "
          f"{t['eager_step_ms_median']:.2f} ms (6c median), captured "
          f"{t['replay_ms_median']:.2f} ms (replays); peak GiB eager "
          f"{t['eager_peak_gib']:.2f}, captured {t['peak_gib']:.2f}; card "
          f"{card}")
    t = train11["mesh"]
    print(f"  11t smollm-360m step on the mesh: eager "
          f"{' / '.join(f'{w:.2f}' for w in t['eager_step_ms'])} ms (10a), "
          f"captured {t['replay_ms_median']:.2f} ms (replays); peak GiB "
          f"eager {t['eager_memory']['peak_gib']:.2f} (10b's steps 3-4), "
          f"captured {t['peak_gib']:.2f}; card {card}")
    return {"forwards": phase11, "served": served11,
            "failover_captures": part_rec["failover"]["captures"],
            "granite_decode": g11, "mesh": mesh11, "train": train11}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail_now("no CUDA device: this smoke test runs on a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail_now(f"the port (src/repro_torch) is not beside {__file__}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # every module of the main paths, imported before the check below
    from repro_torch import graphs  # noqa: F401
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.core.models import get_model  # noqa: F401
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.dist import partition  # noqa: F401
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import feature_cache as tfc
    from repro_torch.kernels import fused_fp_na as tffn
    from repro_torch.kernels import gat_na as tgat
    from repro_torch.kernels import segment_spmm as tspmm
    from repro_torch.kernels import segment_sum as tss
    from repro_torch.kernels import semantic_attn as tsem
    from repro_torch.launch.serve import build_hgnn_infer
    from repro_torch.launch import dryrun  # noqa: F401
    from repro_torch.launch import steps  # noqa: F401
    from repro_torch.launch import train as launch_train  # noqa: F401
    from repro_torch.nn import transformer  # noqa: F401
    from repro_torch.serve.engine import HGNNInferEngine  # noqa: F401
    from repro_torch.serve.engine import HGNNServeEngine  # noqa: F401
    from repro_torch.serve.engine import ServeEngine  # noqa: F401
    from repro_torch.serve.sampler import HGNNSampler  # noqa: F401

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        fail_now(f"the port imported {bad}")
    # every graph's first replay traced and held to what it adds to the
    # launch counters (measured_card)
    graphs._card = measured_card()

    # ---------------- phase 1: the card and the build ----------------
    card = card_line()
    dev = torch.device("cuda")
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds:.2f} s, "
          f"{len(build.sources())} sources)", flush=True)
    for line in build.build_log.splitlines():  # ptxas -v: regs, spills
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            m = re.search(r"gat_na_kernelILi(\d)ELb(\d)E", name)
            print("  ptxas " + (f"gat_na_kernel<NF={m[1]}, fused={m[2]}>"
                                if m else name))
        elif "registers" in line or "spill" in line:
            print(f"    {line.strip()}")
    hgnn_sass = hgnn_instructions()

    # ---------------- phase 2: kernels vs plain versions ----------------
    print("phase 2: kernels against their plain versions (main-path shapes)")
    t0 = time.perf_counter()
    hg = make_dataset("imdb")
    print(f"  imdb built in {time.perf_counter() - t0:.2f} s")
    cfg1 = HGNNConfig(model="han", dataset="imdb", fused=True,
                      use_pallas=True, fuse_na_sa=True)
    built = build_hgnn_infer(cfg1, hg, dev)
    params, batch = built.params, built.batch
    with torch.inference_mode():
        h = built.executor.fp(params, batch)  # [N, H, Dh]
    p_gat, sem = params["gat"], params["sem"]
    nbr, mask = batch["nbr"], batch["mask"]
    s_dim, n, k = nbr.shape
    print(f"  shapes: h {tuple(h.shape)} nbr/mask {tuple(nbr.shape)} "
          f"W {tuple(sem['W'].shape)}; live slots "
          f"{int((mask != 0).sum())} of {mask.numel()}")
    results = {}
    with torch.inference_mode():
        out = tgat.gat_na(p_gat, h, h, nbr, mask)
        want = tgat.gat_na_plain(p_gat, h, h, nbr, mask)
        torch.cuda.synchronize()
        err = max_err(out, want)
        check(close(out, want, **TOL_Z),
              f"gat_na vs plain: max |err| {err:.3e} (tol {TOL_Z})")
        results["gat_na"] = {"max_abs_err": err, "tolerance": TOL_Z}

        z, w = tgat.gat_na(p_gat, h, h, nbr, mask, sem=sem)
        zp, wp = tgat.gat_na_plain(p_gat, h, h, nbr, mask, sem)
        torch.cuda.synchronize()
        err_z, err_w = max_err(z, zp), max_err(w, wp)
        check(close(z, zp, **TOL_Z),
              f"gat_na_fused_sa z vs plain: max |err| {err_z:.3e}")
        check(close(w, wp, **TOL_W),
              f"gat_na_fused_sa w vs plain: max |err| {err_w:.3e} "
              f"(w = {w.tolist()}, plain {wp.tolist()}, tol {TOL_W})")
        z2, w2 = tgat.gat_na(p_gat, h, h, nbr, mask, sem=sem)
        check(torch.equal(z, z2) and torch.equal(w, w2),
              "gat_na_fused_sa: two runs give the same bits")
        results["gat_na_fused_sa"] = {"max_abs_err": err_z,
                                      "w_max_abs_err": err_w,
                                      "tolerance": TOL_Z, "w_tolerance": TOL_W}

        dead = mask.clone()
        dead[:, ::5] = 0  # every fifth row of each metapath: all masked
        out_d = tgat.gat_na(p_gat, h, h, nbr, dead)
        z_d, w_d = tgat.gat_na(p_gat, h, h, nbr, dead, sem=sem)
        zp_d, wp_d = tgat.gat_na_plain(p_gat, h, h, nbr, dead, sem)
        check(bool((out_d[:, ::5] == 0).all() and (z_d[:, ::5] == 0).all()),
              "all-masked rows come out exactly 0 (both variants)")
        check(close(out_d, tgat.gat_na_plain(p_gat, h, h, nbr, dead), **TOL_Z)
              and close(z_d, zp_d, **TOL_Z) and close(w_d, wp_d, **TOL_W),
              "all-masked input: both variants agree with plain")

        z_stack = z.reshape(s_dim, n, -1)
        beta = torch.softmax(w, dim=0)
        comb = tsem.semantic_combine(z_stack, beta)
        comb_p = tsem.semantic_combine_plain(z_stack, beta)
        torch.cuda.synchronize()
        err_c = max_err(comb, comb_p)
        check(close(comb, comb_p, atol=1e-6, rtol=1e-6),
              f"semantic_combine vs plain: max |err| {err_c:.3e} "
              f"(bitwise: {torch.equal(comb, comb_p)})")
        results["semantic_combine"] = {"max_abs_err": err_c,
                                       "tolerance": dict(atol=1e-6, rtol=1e-6)}

    print("phase 2b: segment_spmm and fused_fp_na at the RGCN/imdb shapes")
    rgcn_built = build_hgnn_infer(
        HGNNConfig(model="rgcn", dataset="imdb", fused=True, use_pallas=True),
        hg, dev)
    spmm_rels, ffn_args = rgcn_kernels_vs_plain(rgcn_built, results)

    print("phase 2c: cached_gather, the unstacked gat_na and semantic_scores "
          f"at the MAGNN/imdb shapes (cache_rows={CACHE_ROWS})")
    magnn_built = build_hgnn_infer(
        HGNNConfig(model="magnn", dataset="imdb", use_pallas=True,
                   cache_rows=CACHE_ROWS), hg, dev)
    gathers, gat_args, sa_args = magnn_kernels_vs_plain(magnn_built, results)

    print("phase 2d: segment_sum at the GCN/Reddit (scale 0.1) and the "
          "HAN/imdb csr shapes, bitwise against its plain version on the CPU")
    t0 = time.perf_counter()
    hg_r = make_dataset("reddit")
    print(f"  reddit (scale 0.1) built in {time.perf_counter() - t0:.2f} s: "
          f"{hg_r.node_counts['N']} nodes, "
          f"{hg_r.relations[('N', 'nn', 'N')].nnz} edges after symmetrising")
    cfg_g = HGNNConfig(model="gcn", dataset="reddit")
    gcn_built = build_hgnn_infer(cfg_g, hg_r, dev)
    with torch.inference_mode():
        h_g = gcn_built.executor.fp(gcn_built.params, gcn_built.batch)
    gcn_calls = capture_segment_sums(lambda: gcn_built.executor.na(
        gcn_built.params, gcn_built.batch, h_g))
    check(len(gcn_calls) == 2, f"GCN NA: {len(gcn_calls)} segment sums (2)")
    segment_sum_vs_plain("gcn/reddit", gcn_calls, results)
    cfg_hc = HGNNConfig(model="han", dataset="imdb", fused=False,
                        use_pallas=True)
    han_csr = build_hgnn_infer(cfg_hc, hg, dev)
    for path, (seg_p, _) in zip(han_csr.plan.metapaths,
                                han_csr.batch["edges"]):
        print(f"  HAN/imdb csr {''.join(path)}: E = {seg_p.numel()} edges "
              f"(msg [E, H, Dh] is {seg_p.numel() * 64 * 4 / 2 ** 20:.1f} "
              f"MiB)")
    with torch.inference_mode():
        h_c = han_csr.executor.fp(han_csr.params, han_csr.batch)
    csr_calls = capture_segment_sums(lambda: han_csr.executor.na(
        han_csr.params, han_csr.batch, h_c))
    check(len(csr_calls) == 4,
          f"HAN csr NA: {len(csr_calls)} segment sums (2 a metapath)")
    segment_sum_vs_plain("han/imdb csr", csr_calls, results)

    print("phase 2e: the unstacked gat_na on each HAN/imdb degree bucket "
          "(bucket_padded, 3 buckets a metapath)")
    cfg_hb = HGNNConfig(model="han", dataset="imdb", fused=True,
                        degree_buckets=3, use_pallas=True)
    han_bk = build_hgnn_infer(cfg_hb, hg, dev)
    bk_calls = bucket_calls(han_bk)
    gat_na_buckets_vs_plain(bk_calls, results)

    # ---------------- phase 3: the main paths ----------------
    # phase 11's full-graph forwards, recorded by drive_variant as the
    # phase 3 paths run them (HAN fused, RGCN padded, MAGNN, GCN/Reddit 0.1)
    phase11: dict = {}
    print("phase 3: HAN/imdb full-graph inference through the entry points")
    main_counts = {"gat_na": 0, "gat_na_fused_sa": 0, "semantic_combine": 0,
                   "segment_spmm": 0, "fused_fp_na": 0, "cached_gather": 0,
                   "gat_na_unstacked": 0, "semantic_scores": 0,
                   "segment_sum": 0, "gat_na_bucketed": 0}
    forward_ms, profiles, logits_of = {}, {}, {}

    def add_counts(counts):  # a HAN or RGCN variant's launches
        fused = counts["gat_na_fused_sa"]
        main_counts["gat_na"] += counts["gat_na"] - fused
        for name in ("gat_na_fused_sa", "semantic_combine", "segment_spmm"):
            main_counts[name] += counts[name]

    def han_launches(layers, fuse):
        return lambda batch: {"gat_na": layers,
                              "gat_na_fused_sa": layers if fuse else 0,
                              "semantic_combine": layers if fuse else 0}

    for layers in (1, 2):
        for fuse in (True, False):
            tag = f"L={layers} fuse_na_sa={fuse}"
            counts, logits_of[tag] = drive_variant(
                cfg1.replace(layers=layers, fuse_na_sa=fuse), hg, dev, tag,
                han_launches(layers, fuse), layers == 1 and fuse,
                forward_ms, profiles, compiled=phase11 if fuse else None)
            add_counts(counts)

    print("phase 3b: RGCN/imdb full-graph inference through the entry points")
    cfg_r = HGNNConfig(model="rgcn", dataset="imdb", fused=True,
                       use_pallas=True)
    for layers in (1, 2):
        for buckets in (0, 3):
            tag = (f"rgcn L={layers} "
                   f"{f'bucketed {buckets}' if buckets else 'padded'}")
            counts, logits_of[tag] = drive_variant(
                cfg_r.replace(layers=layers, degree_buckets=buckets), hg, dev,
                tag, segment_spmm_launches(layers),
                layers == 1 and not buckets, forward_ms, profiles,
                compiled=None if buckets else phase11)
            add_counts(counts)
    print("phase 3c: RGCN/dblp")
    main_counts["segment_spmm"] += rgcn_dblp(dev, forward_ms, profiles)
    print("phase 3d: fused FP + NA through its entry point ops.fused_fp_na "
          "(no executor path reaches it)")
    ops.reset_launch_counts()
    with torch.inference_mode():
        for _ in range(ITERS):
            ops.fused_fp_na(*ffn_args, mean=True, use_pallas=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts == dict(dict.fromkeys(counts, 0), fused_fp_na=ITERS),
          f"ops.fused_fp_na: launches {counts} over {ITERS} calls")
    main_counts["fused_fp_na"] += counts["fused_fp_na"]

    print("phase 3e: MAGNN/imdb full-graph inference through the entry "
          "points, without and with residency")
    cfg_m = HGNNConfig(model="magnn", dataset="imdb", use_pallas=True)
    for layers in (1, 2):
        for c in (0, CACHE_ROWS):
            tag = f"magnn L={layers} cache_rows={c}"
            counts, logits_of[tag] = drive_variant(
                cfg_m.replace(layers=layers, cache_rows=c), hg, dev, tag,
                lambda batch: {"gat_na": 2 * layers,
                               "cached_gather": 6 * layers if c else 0},
                layers == 1 and c == 0, forward_ms, profiles,
                compiled=None if c else phase11)
            main_counts["gat_na_unstacked"] += counts["gat_na"]
            main_counts["cached_gather"] += counts["cached_gather"]
        check(torch.equal(logits_of[f"magnn L={layers} cache_rows=0"],
                          logits_of[tag]),
              f"magnn L={layers}: cached logits bitwise equal to uncached")

    print("phase 3f: HAN and RGCN with residency "
          f"(cache_rows={CACHE_ROWS}) against their uncached runs")
    for base_tag, cfg, per_forward in (
            ("L=1 fuse_na_sa=True", cfg1, han_launches(1, True)),
            ("rgcn L=1 padded", cfg_r, segment_spmm_launches(1)),
            ("rgcn L=1 bucketed 3", cfg_r.replace(degree_buckets=3),
             segment_spmm_launches(1))):
        tag = f"{base_tag} cache_rows={CACHE_ROWS}"
        counts, logits_of[tag] = drive_variant(
            cfg.replace(cache_rows=CACHE_ROWS), hg, dev, tag, per_forward,
            False, forward_ms, profiles)
        check(torch.equal(logits_of[tag], logits_of[base_tag]),
              f"{tag}: logits bitwise equal to the uncached run")
        add_counts(counts)

    # the csr arm's segment mean is the fixed-order segment_sum kernel:
    # held bitwise to the uncached run (and still by tolerance)
    cfg_csr = HGNNConfig(model="rgcn", dataset="imdb", fused=False)
    with torch.inference_mode():
        csr_runs = {}
        for c in (0, CACHE_ROWS):
            b = build_hgnn_infer(cfg_csr.replace(cache_rows=c), hg, dev)
            csr_runs[c] = [b.fn(b.params, b.batch) for _ in range(2)]
        torch.cuda.synchronize()
    err = max_err(csr_runs[0][0], csr_runs[CACHE_ROWS][0])
    check(close(csr_runs[0][0], csr_runs[CACHE_ROWS][0], **TOL_LOGITS),
          f"rgcn L=1 csr cache_rows={CACHE_ROWS}: logits vs the uncached run "
          f"max |err| {err:.3e} (tol {TOL_LOGITS}; two uncached runs "
          f"bitwise equal: {torch.equal(*csr_runs[0])})")
    check(torch.equal(csr_runs[0][0], csr_runs[CACHE_ROWS][0]),
          f"rgcn L=1 csr cache_rows={CACHE_ROWS}: logits bitwise equal to "
          f"the uncached run")
    check(torch.equal(*csr_runs[0]) and torch.equal(*csr_runs[CACHE_ROWS]),
          "rgcn L=1 csr: two runs give the same bits, cached and uncached")

    print("phase 3g: both SA passes through their entry point "
          "ops.semantic_attention (no executor path reaches it)")
    with torch.inference_mode():
        plain_sa = ops.semantic_attention(*sa_args, use_pallas=False)
        ops.reset_launch_counts()
        for _ in range(ITERS):
            got_sa = ops.semantic_attention(*sa_args, use_pallas=True)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts == dict(dict.fromkeys(counts, 0), semantic_scores=ITERS,
                         semantic_combine=ITERS),
          f"ops.semantic_attention: launches {counts} over {ITERS} calls")
    err = max_err(got_sa, plain_sa)
    check(close(got_sa, plain_sa, **TOL_LOGITS),
          f"ops.semantic_attention kernel arm vs plain arm: max |err| "
          f"{err:.3e} (tol {TOL_LOGITS})")
    main_counts["semantic_scores"] += counts["semantic_scores"]
    main_counts["semantic_combine"] += counts["semantic_combine"]
    profiles["ops.semantic_attention"] = profile_forward(
        types.SimpleNamespace(infer=lambda: ops.semantic_attention(
            *sa_args, use_pallas=True)), "ops.semantic_attention")

    print("phase 3h: HAN/imdb in the csr and 3-bucket layouts through the "
          "entry points, without and with residency")

    def han_layout_launches(layout, layers):
        if layout == "csr":  # the denominator and the SpMM a metapath
            return lambda batch: {"segment_sum": 2 * layers
                                  * len(batch["edges"])}
        return lambda batch: {"gat_na": layers * sum(
            len(bks) for bks in batch["buckets"])}

    han_layouts = (("csr", cfg_hc), ("bucketed 3", cfg_hb))
    for layers in (1, 2):
        for name, cfg in han_layouts:
            tag = f"han L={layers} {name}"
            counts, logits_of[tag] = drive_variant(
                cfg.replace(layers=layers), hg, dev, tag,
                han_layout_launches(name, layers), True, forward_ms,
                profiles, twice=True)
            main_counts["segment_sum"] += counts["segment_sum"]
            main_counts["gat_na_bucketed"] += counts["gat_na"]
    for name, cfg in han_layouts:
        tag = f"han L=1 {name} cache_rows={CACHE_ROWS}"
        counts, logits_of[tag] = drive_variant(
            cfg.replace(cache_rows=CACHE_ROWS), hg, dev, tag,
            han_layout_launches(name, 1), False, forward_ms, profiles,
            twice=True)
        check(torch.equal(logits_of[tag], logits_of[f"han L=1 {name}"]),
              f"{tag}: logits bitwise equal to the uncached run")
        main_counts["segment_sum"] += counts["segment_sum"]
        main_counts["gat_na_bucketed"] += counts["gat_na"]

    print("phase 3i: GCN on the Reddit-like graph (scale 0.1) through the "
          "entry points, without and with residency")
    for layers in (1, 2):
        for c in (0, CACHE_ROWS):
            tag = f"gcn/reddit L={layers} cache_rows={c}"
            counts, logits_of[tag] = drive_variant(
                cfg_g.replace(layers=layers, cache_rows=c), hg_r, dev, tag,
                lambda batch, n=layers: {"segment_sum": 2 * n},
                layers == 1 and c == 0, forward_ms, profiles, twice=True,
                compiled=None if c else phase11)
            main_counts["segment_sum"] += counts["segment_sum"]
        check(torch.equal(logits_of[tag],
                          logits_of[f"gcn/reddit L={layers} cache_rows=0"]),
              f"gcn/reddit L={layers}: cached logits bitwise equal to "
              f"uncached")

    print("phase 3j: GCN on the Reddit-like graph at the paper's size "
          "(scale 1.0), one layer")
    t0 = time.perf_counter()
    hg_big = make_dataset("reddit", scale=1.0)
    print(f"  reddit (scale 1.0) built in {time.perf_counter() - t0:.2f} s "
          f"on the host: {hg_big.node_counts['N']} nodes x 602 features, "
          f"{hg_big.relations[('N', 'nn', 'N')].nnz} edges after "
          f"symmetrising", flush=True)
    keep = {}
    counts, logits_big = drive_variant(
        cfg_g, hg_big, dev, "gcn/reddit-1.0 L=1",
        lambda batch: {"segment_sum": 2}, False, forward_ms, profiles,
        twice=True, keep=keep)
    main_counts["segment_sum"] += counts["segment_sum"]
    big = keep.pop("built")
    with torch.inference_mode():
        h_big = big.executor.fp(big.params, big.batch)
    big_calls = capture_segment_sums(lambda: big.executor.na(
        big.params, big.batch, h_big))
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        segment_sum_shapes = {"gcn/reddit-1.0 aggregation 1":
                              segment_sum_timing(big_calls[0], flush)}
    del big, h_big, big_calls, hg_big, logits_big, keep
    torch.cuda.empty_cache()

    print("phase 3k: the paper's Fig. 5c on this card: HAN/imdb NA device "
          "time by layout (layer 0, profiler)")
    fig5c = {}
    for name, cfg in (
            ("csr", cfg_hc), ("bucketed 3", cfg_hb),
            ("stacked", cfg1.replace(fuse_na_sa=False)),
            ("stacked +fused SA pass 1", cfg1),
            ("bucketed 3 plain", cfg_hb.replace(use_pallas=False)),
            ("stacked plain", cfg1.replace(fuse_na_sa=False,
                                           use_pallas=False))):
        fig5c[name] = na_profile(build_hgnn_infer(cfg, hg, dev),
                                 f"han/imdb NA {name}", profiles)
    print("  Fig. 5c, HAN/imdb NA device ms a forward: " + ", ".join(
        f"{k} {v:.4f}" for k, v in fig5c.items()))

    print("phase 3l: characterization, the paper's Fig. 2 and Fig. 3 on this "
          "card: per-stage records through HGNNInferEngine.characterize("
          "timed=True), against the CPU's records of the same plans")
    char = characterization(hg, hg_r, dev)

    print("phase 3m: request-path serving on the card: HAN/imdb (fan-out "
          f"{SERVE_FANOUT}, {SERVE_SLOTS} slots of {SERVE_SLOT_TARGETS} "
          f"targets, {SERVE_REQUESTS} requests checked, "
          f"{SERVE_REPEATS} x {SERVE_TIMED_REQUESTS} timed) through the "
          "gat_na epilogue and semantic_combine, RGCN/imdb on rung-padded "
          "buckets, MAGNN/imdb, GCN/Reddit 0.1")
    serve_counts = dict.fromkeys(("gat_na_fused_sa", "semantic_combine",
                                  "segment_spmm", "gat_na_unstacked",
                                  "segment_sum"), 0)
    serve_rec = serving(hg, hg_r, dev, serve_counts, results)
    for name, n_launch in serve_counts.items():
        check(n_launch > 0, f"{name} launched {n_launch} times on the "
                            f"request path")
        main_counts[name] += n_launch
    serve_rec["launches"] = serve_counts

    print("phase 3p: graph-partitioned execution on the card: HAN/imdb L "
          "1, 2, RGCN/imdb L 1, 2 and MAGNN/imdb at K = 1, 2, 4 through the "
          "kernels, bench_partition.py's sweep and bench_resilience.py's "
          "failover serve")
    part_rec = partitioned(hg, dev, main_counts, results)

    print("phase 3o: the async stage-graph schedule on the card: "
          "bench_overlap.py's cases (HAN/imdb 3 buckets, MAGNN/imdb, "
          "HAN/imdb and RGCN/imdb K=4 L=2) and HAN/imdb csr, overlapped "
          "against serial, then the sampler-prefetch serves")
    ov_rec = overlapped(hg, dev, main_counts, results)

    # ---------------- phase 4: timing ----------------
    print("phase 4: kernel times (CUDA events, median; cold = L2 flushed)")
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=dev)
    hs = sem["W"].shape[1]
    per_relation = {}
    with torch.inference_mode():
        timed = {
            "gat_na": (lambda: tgat.gat_na(p_gat, h, h, nbr, mask),
                       lambda: tgat.gat_na_plain(p_gat, h, h, nbr, mask),
                       None, tgat.work(h, h, nbr, mask, 0, live_only=True)),
            "gat_na_fused_sa": (
                lambda: tgat.gat_na(p_gat, h, h, nbr, mask, sem=sem),
                lambda: tgat.gat_na_plain(p_gat, h, h, nbr, mask, sem),
                None, tgat.work(h, h, nbr, mask, hs, live_only=True)),
            "semantic_combine": (
                lambda: tsem.semantic_combine(z_stack, beta),
                lambda: tsem.semantic_combine_plain(z_stack, beta),
                lambda: torch.einsum("p,pnd->nd", beta, z_stack),
                tsem.combine_work(z_stack, beta)),
        }
        # segment_spmm per relation, then one RGCN/imdb layer's four
        # launches together (the kernels line's entry)
        layer_work = [0, 0]
        spmm_csr = []
        for key, h_src, r_nbr, r_mask in spmm_rels:
            csr = mean_csr(r_nbr, r_mask, h_src.shape[0])
            spmm_csr.append(csr)
            n_bytes, n_ops = tspmm.work(h_src.shape[1], r_nbr, r_mask,
                                        live_only=True)
            layer_work[0] += n_bytes
            layer_work[1] += n_ops
            ms = time_ms(lambda: tspmm.segment_spmm(h_src, r_nbr, r_mask),
                         50, flush)
            warm_ms = time_ms(lambda: tspmm.segment_spmm(h_src, r_nbr,
                                                         r_mask), 50)
            plain_ms = time_ms(lambda: tspmm.segment_spmm_plain(
                h_src, r_nbr, r_mask), 20, flush)
            lib_ms = time_ms(lambda: torch.sparse.mm(csr, h_src), 50, flush)
            b_ms, b_by = bound(n_bytes, n_ops)
            per_relation["|".join(key)] = {
                "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                "bytes": n_bytes, "operations": n_ops,
                "buckets": bucket_times(h_src, r_nbr, r_mask, flush)}
            print(f"  segment_spmm {'|'.join(key)}: {ms:.5f} ms cold, "
                  f"{warm_ms:.5f} ms warm (plain {plain_ms:.5f} ms, bound "
                  f"{b_ms:.5f} ms by {b_by}, torch.sparse.mm {lib_ms:.5f} ms)")
            for bk in per_relation["|".join(key)]["buckets"]:
                print(f"    bucket K={bk['k']}: {bk['rows']} rows, "
                      f"{bk['live']} live slots: {bk['ms']:.5f} ms cold, "
                      f"{bk['warm_ms']:.5f} ms warm")

        def spmm_layer(fn):
            def run():
                for _, h_src, r_nbr, r_mask in spmm_rels:
                    fn(h_src, r_nbr, r_mask)
            return run

        def sparse_layer():
            for (_, h_src, _, _), csr in zip(spmm_rels, spmm_csr):
                torch.sparse.mm(csr, h_src)

        timed["segment_spmm"] = (spmm_layer(tspmm.segment_spmm),
                                 spmm_layer(tspmm.segment_spmm_plain),
                                 sparse_layer, tuple(layer_work))
        x, w, f_nbr, f_mask = ffn_args
        f_csr = mean_csr(f_nbr, f_mask, x.shape[0])
        timed["fused_fp_na"] = (
            lambda: tffn.fused_fp_na(x, w, f_nbr, f_mask),
            lambda: tffn.fused_fp_na_plain(x, w, f_nbr, f_mask),
            lambda: torch.sparse.mm(f_csr, x) @ w,
            tffn.work(x, w, f_nbr, f_mask, live_only=True))

        # MAGNN/imdb: each of a layer's six cached gathers and two unstacked
        # gat_na launches on its own, then each layer's launches together
        # (the kernels line's entries); the library call gathers from the
        # pool built beforehand
        pools = [torch.cat([t, t.index_select(0, hh)])
                 for _, t, hh, _ in gathers]
        magnn_per_launch = {}
        singles = [(f"cached_gather {tag}",
                    lambda t=t, hh=hh, idx=idx: tfc.cached_gather(t, hh, idx),
                    lambda t=t, hh=hh, idx=idx: tfc.cached_gather_plain(
                        t, hh, idx),
                    lambda pool=pool, idx=idx: pool[idx],
                    tfc.work(t, hh, idx, live_only=True))
                   for (tag, t, hh, idx), pool in zip(gathers, pools)]
        singles += [(f"gat_na unstacked {mp_tag}",
                     lambda a=a: tgat.gat_na(*a),
                     lambda a=a: tgat.gat_na_plain(*a), None,
                     tgat.work(a[1], a[2], a[3], a[4], live_only=True))
                    for mp_tag, a in gat_args.items()]
        for tag, kern, plain, lib, (n_bytes, n_ops) in singles:
            ms, warm_ms = time_ms(kern, 50, flush), time_ms(kern, 50)
            plain_ms = time_ms(plain, 20, flush)
            lib_ms = time_ms(lib, 50, flush) if lib is not None else None
            b_ms, b_by = bound(n_bytes, n_ops)
            magnn_per_launch[tag] = {
                "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                "bytes": n_bytes, "operations": n_ops}
            print(f"  {tag}: {ms:.5f} ms cold, {warm_ms:.5f} ms warm (plain "
                  f"{plain_ms:.5f} ms, bound {b_ms:.5f} ms by {b_by}, "
                  f"library {'n/a' if lib_ms is None else f'{lib_ms:.5f} ms'})")

        def layer_of(fns):
            def run():
                for fn in fns:
                    fn()
            return run

        def summed(works):
            return (sum(wk[0] for wk in works), sum(wk[1] for wk in works))

        n_g = len(gathers)
        timed["cached_gather"] = (
            layer_of([g[1] for g in singles[:n_g]]),
            layer_of([g[2] for g in singles[:n_g]]),
            layer_of([g[3] for g in singles[:n_g]]),
            summed([g[4] for g in singles[:n_g]]))
        timed["gat_na_unstacked"] = (
            layer_of([g[1] for g in singles[n_g:]]),
            layer_of([g[2] for g in singles[n_g:]]), None,
            summed([g[4] for g in singles[n_g:]]))
        timed["semantic_scores"] = (
            lambda: tsem.semantic_scores(*sa_args),
            lambda: tsem.semantic_scores_plain(*sa_args), None,
            tsem.scores_work(sa_args[0], sa_args[1]))
        # segment_sum: GCN/Reddit's first aggregation (scale 0.1), with
        # index_add_ of the gathered rows as the library yardstick; each
        # HAN/imdb csr call and GCN's second aggregation on their own
        vals_g, seg_g, n_g_seg, idx_g, mean_g = gcn_calls[0]
        rows_g = vals_g[idx_g.long()]
        acc_g = torch.zeros((n_g_seg, vals_g.shape[1]), device=dev)
        seg_gl = seg_g.long()
        timed["segment_sum"] = (
            lambda: tss.segment_sum(vals_g, seg_g, n_g_seg, idx=idx_g,
                                    mean=mean_g),
            lambda: tss.segment_sum_plain(vals_g, seg_g, n_g_seg, idx=idx_g,
                                          mean=mean_g),
            lambda: acc_g.index_add_(0, seg_gl, rows_g),
            tss.work(vals_g, seg_g, n_g_seg, idx_g, mean_g, live_only=True))
        segment_sum_shapes["gcn/reddit aggregation 2"] = segment_sum_timing(
            gcn_calls[1], flush)
        for i, call in enumerate(csr_calls):
            segment_sum_shapes[
                f"han/imdb csr {''.join(han_csr.plan.metapaths[i // 2])} "
                f"{'denominator' if i % 2 == 0 else 'SpMM'}"] = \
                segment_sum_timing(call, flush)
        for tag, rec in segment_sum_shapes.items():
            print(f"  segment_sum {tag} (E {rec['E']}, N {rec['N']}, C "
                  f"{rec['C']}): {rec['ms']:.5f} ms cold, {rec['warm_ms']:.5f} "
                  f"ms warm (plain {rec['plain_ms']:.5f}, bound "
                  f"{rec['bound_ms']:.5f} by {rec['bound_by']}, index_add_ "
                  f"{rec['library_ms']:.5f}"
                  + (f", sparse.mm {rec['sparse_mm_ms']:.5f}"
                     if "sparse_mm_ms" in rec else "") + ")")
        # gat_na on the buckets: each launch alone, then one HAN/imdb
        # layer's launches together (the kernels line's entry)
        for tag, a in bk_calls:
            bk_ms = time_ms(lambda a=a: tgat.gat_na(*a), 50, flush)
            print(f"  gat_na bucket {tag}: {a[4].shape[0]} rows, "
                  f"{bk_ms:.5f} ms cold")
        timed["gat_na_bucketed"] = (
            layer_of([lambda a=a: tgat.gat_na(*a) for _, a in bk_calls]),
            layer_of([lambda a=a: tgat.gat_na_plain(*a)
                      for _, a in bk_calls]), None,
            summed([tgat.work(a[1], a[2], a[3], a[4], live_only=True)
                    for _, a in bk_calls]))
        shapes = {
            "segment_spmm": "one RGCN/imdb layer: 4 launches, one per "
                            "relation, K=64, D=64",
            "fused_fp_na": f"RGCN/imdb M|md|D: x {tuple(x.shape)}, W "
                           f"{tuple(w.shape)}, nbr/mask {tuple(f_nbr.shape)}",
            "cached_gather": f"one MAGNN/imdb layer: {n_g} launches, one per "
                             f"instance position, C={CACHE_ROWS}, idx "
                             f"{tuple(gathers[0][3].shape)} strided, D=64",
            "gat_na_unstacked": "one MAGNN/imdb layer: 2 launches (MDM, MAM), "
                                "nbr = arange [4278, 16], h_src = encoded "
                                "instances [68448, 8, 8]",
            "semantic_scores": f"z {tuple(sa_args[0].shape)}, W "
                               f"{tuple(sa_args[1].shape)}",
            "segment_sum": f"GCN/Reddit (scale 0.1) aggregation 1: table "
                           f"{tuple(vals_g.shape)}, E {seg_g.numel()}, N "
                           f"{n_g_seg}, gather mean",
            "gat_na_bucketed": f"one HAN/imdb bucketed layer: {len(bk_calls)} "
                               f"launches, one a degree bucket (K "
                               f"{[a[3].shape[1] for _, a in bk_calls]}), "
                               f"h_src [4278, 8, 8]",
        }
        library = {"semantic_combine": "torch.einsum",
                   "segment_spmm": "torch.sparse.mm (CSR of mask/deg, one "
                                   "call per relation)",
                   "fused_fp_na": "torch.sparse.mm then @ W (two calls)",
                   "cached_gather": "pool[idx] on the pre-built pool (one "
                                    "call per launch)",
                   "segment_sum": "index_add_ of the rows gathered "
                                  "beforehand (one call, float atomics; "
                                  "the sum alone, no gather, no divide)"}
        kernels = []
        source = {"gat_na": "src/repro_torch/kernels/csrc/gat_na.cu",
                  "gat_na_fused_sa": "src/repro_torch/kernels/csrc/gat_na.cu",
                  "semantic_combine":
                      "src/repro_torch/kernels/csrc/semantic_combine.cu",
                  "segment_spmm":
                      "src/repro_torch/kernels/csrc/segment_spmm.cu",
                  "fused_fp_na": "src/repro_torch/kernels/csrc/fused_fp_na.cu",
                  "cached_gather":
                      "src/repro_torch/kernels/csrc/feature_cache.cu",
                  "gat_na_unstacked": "src/repro_torch/kernels/csrc/gat_na.cu",
                  "semantic_scores":
                      "src/repro_torch/kernels/csrc/semantic_scores.cu",
                  "segment_sum": "src/repro_torch/kernels/csrc/segment_sum.cu",
                  "gat_na_bucketed": "src/repro_torch/kernels/csrc/gat_na.cu"}
        replaces = {"gat_na": "src/repro/kernels/gat_na.py:225",
                    "gat_na_fused_sa": "src/repro/kernels/gat_na.py:225",
                    "semantic_combine":
                        "src/repro/kernels/semantic_attn.py:153",
                    "segment_spmm": "src/repro/kernels/segment_spmm.py:93",
                    "fused_fp_na": "src/repro/kernels/fused_fp_na.py:91",
                    "cached_gather": "src/repro/kernels/feature_cache.py:34",
                    "gat_na_unstacked": "src/repro/kernels/gat_na.py:225",
                    "semantic_scores":
                        "src/repro/kernels/semantic_attn.py:100",
                    # port-only: XLA's jax.ops.segment_sum, no Pallas kernel
                    "segment_sum": "src/repro/core/stages.py:308",
                    "gat_na_bucketed": "src/repro/kernels/gat_na.py:225"}
        for name, (kern, plain, lib, work) in timed.items():
            ms = time_ms(kern, 50, flush)
            plain_ms = time_ms(plain, 20, flush)
            lib_ms = time_ms(lib, 50, flush) if lib is not None else None
            warm_ms = time_ms(kern, 50)
            n_bytes, n_ops = work[:2]
            tf32_ops = work[2] if len(work) > 2 else 0
            b_ms, b_by = bound(n_bytes, n_ops, tf32_ops=tf32_ops)
            entry = {"name": name, "route": "cuda", "source": source[name],
                     "replaces": replaces[name],
                     "launches": main_counts[name], **results[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms,
                     "warm_ms": warm_ms, "bytes": n_bytes,
                     "operations": n_ops}
            if tf32_ops:
                entry["tf32_operations"] = tf32_ops
            if name in shapes:
                entry["shape"] = shapes[name]
            if name in library:
                entry["library"] = library[name]
            if name == "segment_sum":
                entry["note"] = ("port-only: the reference's "
                                 "jax.ops.segment_sum runs in XLA, with no "
                                 "TPU kernel behind it")
            kernels.append(entry)
            check(tuple(work) == BOUND_WORK[name],
                  f"{name}: bound work {tuple(work)} as before the formulas "
                  f"moved ({BOUND_WORK[name]})")
            print(f"  {name}: {ms:.5f} ms cold, {warm_ms:.5f} ms warm "
                  f"(plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms by "
                  f"{b_by}, library "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.5f} ms'})")
        for name in main_counts:
            check(main_counts[name] > 0,
                  f"{name} launched {main_counts[name]} times on the main path")

    # ---------------- phase 5: LM serving (granite-8b) ----------------
    print("phase 5: flash_attention and decode_attention against their "
          "plain versions (granite-8b, h2o-danube-3-4b and zamba2-1.2b "
          "shapes)")
    lm_results = lm_kernels_vs_plain(dev)
    print("phase 5b: granite-8b at full width, 2 layers, fp32: the kernel "
          "arm against the plain arm")
    two_layers = granite_two_layers(dev, ops)
    print("phase 5c: granite-8b, 36 layers, bf16, through "
          "ServeEngine.generate")
    serve = granite_serve(dev, ops, profiles)
    print("phase 5e: h2o-danube3-4b, 24 layers, bf16, 4 x "
          f"{DANUBE_PROMPT}-token prompts past its 4096 window, through "
          "ServeEngine.generate")
    t5e = time.perf_counter()
    danube = danube_serve(dev, ops, profiles)
    print(f"phase 5e: {time.perf_counter() - t5e:.1f} s")
    lm_counts = {name: serve["launches"][name] + danube["launches"][name]
                 for name in ("flash_attention", "decode_attention")}
    for name, n in lm_counts.items():
        check(n > 0, f"{name} launched {n} times on the main path")
    print("phase 5d: LM kernel times (CUDA events, median; cold = L2 "
          "flushed)")
    kernels += lm_kernel_times(dev, flush, lm_results, lm_counts)

    # ---------------- phase 6: LM training (smollm-360m) ----------------
    t6 = time.perf_counter()
    print("phase 6a: the embedding gradient (segment_sum) and the chunked "
          "attention's backward at smollm-360m's shapes, card vs CPU")
    train_pieces = train_pieces_vs_plain(dev, flush)
    print("phase 6b: smollm-360m at full width, 2 layers, fp32, seq 2048: "
          "gradients and one train step, card vs CPU; remat modes; "
          "checkpoints")
    train_small = train_two_layers(dev)
    print("phase 6c: smollm-360m, 32 layers, bf16, remat full, through "
          "launch.train's step (seq 2048, global batch 8, 2 microbatches)")
    print(f"  card: {card_line()}")
    train_rec = train_full(dev, ops, profiles)
    check(train_rec["launches"] > 0,
          f"segment_sum launched {train_rec['launches']} times on the "
          f"training path")
    for entry in kernels:
        if entry["name"] == "segment_sum":
            entry["launches"] += train_rec["launches"]
            entry["training_call"] = train_pieces["segment_sum_embed_grad"]
    print(f"phase 6: {time.perf_counter() - t6:.1f} s")

    # ---------------- phase 7: the MoE, SSM and hybrid families ----------
    t7 = time.perf_counter()
    print("phase 7a: phi3.5-moe and zamba2 at full width, 2 layers, fp32: "
          "the kernel arm against the plain arm; mamba2-2.7b, 2 layers, "
          "card vs CPU")
    fam_small = families_two_layers(dev, ops)
    print("phase 7b: mamba2-2.7b, zamba2-1.2b and phi3.5-moe "
          f"({PHI_LAYERS} layers), bf16, through ServeEngine.generate")
    print(f"  card: {card_line()}")
    fam_serve = families_serve(dev, ops, profiles)
    for entry in kernels:
        if entry["name"] in ("flash_attention", "decode_attention"):
            n = sum(rec["launches"][entry["name"]]
                    for rec in fam_serve.values())
            check(n > 0, f"{entry['name']} launched {n} times on the LM "
                  f"families' serving paths")
            entry["launches"] += n
            entry["families_launches"] = n
    print(f"phase 7: {time.perf_counter() - t7:.1f} s")

    # ---------------- phase 8: the VLM and encoder-decoder families -------
    t8 = time.perf_counter()
    print("phase 8a: internvl2-76b and seamless-m4t-medium at full width, 2 "
          "(+ 2) layers, fp32: the kernel arm against the plain arm")
    ved_small = vlm_encdec_two_layers(dev, ops)
    print(f"phase 8b: internvl2-76b ({INTERNVL2_LAYERS} of 80 layers) and "
          "seamless-m4t-medium, bf16, prefill and greedy decode")
    print(f"  card: {card_line()}")
    ved_serve = {"internvl2": vlm_serve(dev, ops, profiles),
                 "seamless": encdec_serve(dev, ops, profiles)}
    for entry in kernels:
        if entry["name"] in ("flash_attention", "decode_attention"):
            n = sum(rec["launches"][entry["name"]]
                    for rec in ved_serve.values())
            check(n > 0, f"{entry['name']} launched {n} times on the VLM and "
                  f"encdec serving paths")
            entry["launches"] += n
            entry["vlm_encdec_launches"] = n
    print(f"phase 8: {time.perf_counter() - t8:.1f} s")

    # ---------------- phase 9: the device mesh ----------------
    t9 = time.perf_counter()
    print("phase 9: a 1-rank NCCL mesh (data=1, model=1): 9a HAN/imdb and "
          "9b granite-8b through the mesh entry points, bitwise the "
          "mesh-less paths; 9d every padded HGNN plan on it; 9e the decode "
          "kernel's log-sum-exp form; 9c the granite-8b dry run on 16x16")
    print(f"  card: {card_line()}")
    mesh_rec = mesh_phase(dev, ops, hg, flush)
    mesh_launches = {**mesh_rec["han"]["launches"],
                     **mesh_rec["granite"]["launches"]}
    for name, n in mesh_rec["plans"]["launches"].items():
        mesh_launches[name] = mesh_launches.get(name, 0) + n
    for entry in kernels:
        if entry["name"] in mesh_launches:
            n = mesh_launches[entry["name"]]
            check(n > 0, f"{entry['name']} launched {n} times on the mesh "
                  f"paths")
            entry["launches"] += n
            entry["mesh_launches"] = n
        if entry["name"] == "decode_attention":
            # the form's launches on the mesh paths (9a, 9b, 9d), counted,
            # beside those of 9e's checks
            entry["lse_form"] = dict(mesh_rec["lse"]["timing"],
                                     check_launches=mesh_rec["lse"][
                                         "check_launches"],
                                     main_path_launches=mesh_rec[
                                         "lse_form_launches"])
    print(f"phase 9: {time.perf_counter() - t9:.1f} s")

    # ---------------- phase 10: elastic restart ----------------
    t10 = time.perf_counter()
    print("phase 10: elastic restart on a 1-rank NCCL mesh: 10a smollm-360m "
          "trained on the mesh bitwise the mesh-less step; 10b its "
          "checkpoint restored onto a fresh mesh and trained on, bitwise an "
          "uninterrupted run; 10c HAN/imdb served after the mesh collapses "
          "(surviving_mesh); 10d launch/train.py --distributed under "
          "torchrun")
    print(f"  card: {card_line()}")
    elastic_rec = elastic_phase(dev, ops, hg)
    elastic_launches = {"segment_sum":
                        elastic_rec["train"]["launches"]["mesh"],
                        **elastic_rec["serve"]["launches"]}
    for entry in kernels:
        if entry["name"] in elastic_launches:
            n = elastic_launches[entry["name"]]
            check(n > 0, f"{entry['name']} launched {n} times on the elastic "
                  f"paths")
            entry["launches"] += n
            entry["elastic_launches"] = n
    print(f"phase 10: {time.perf_counter() - t10:.1f} s")

    # ---------------- phase 11: the compiled steps ----------------
    print("phase 11: the compiled steps (graphs.compiled: a CUDA graph a "
          "signature, replayed) against the eager calls they stand for, "
          "as phases 3, 3m, 3p and 5c ran them; 11m the mesh steps (9a, "
          "9b, 9d) and 11t the training steps (6c, 10a)")
    compiled_rec = compiled_phase(phase11, serve_rec, part_rec, serve,
                                  mesh_rec, train_rec, elastic_rec)
    gc.collect()
    replayed = REPLAYS["launches"]
    check(not REPLAYS["untraced"],
          f"11: every replayed graph traced ({REPLAYS['graphs_traced']} "
          f"graphs; replayed, never traced: {REPLAYS['untraced']})")
    for entry in kernels:
        # the gat_na counter holds every form; the epilogue's has its own
        name = entry["name"]
        if name in ("gat_na", "gat_na_unstacked", "gat_na_bucketed"):
            entry["graph_replay_launches"] = (
                replayed.get("gat_na", 0)
                - replayed.get("gat_na_fused_sa", 0))
            entry["graph_replay_note"] = ("every gat_na form but the "
                                          "epilogue's, together; traced "
                                          "kernels a replay x replays")
        else:
            entry["graph_replay_launches"] = replayed.get(name, 0)
    compiled_rec["graph_replays"] = REPLAYS
    print(f"  11: launches of CUDA-graph replays over the run (each graph's "
          f"first replay traced, {REPLAYS['graphs_traced']} graphs; traced "
          f"kernels a replay x its {REPLAYS['replays']} replays): "
          f"{replayed}")

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(f"clocks.sm, clocks.max.sm, power.draw, temperature: {clocks}")
    print(json.dumps({"forward_ms_per_iter": forward_ms,
                      "hgnn_sass": hgnn_sass,
                      "segment_spmm_per_relation": per_relation,
                      "magnn_per_launch": magnn_per_launch,
                      "segment_sum_shapes": segment_sum_shapes,
                      "fig5c_han_na_device_ms": fig5c,
                      "lm": {"granite_2_layers_fp32": two_layers,
                             "granite_serve": serve,
                             "danube_serve": danube},
                      "lm_vlm_encdec": {"two_layers_fp32": ved_small,
                                        "serve": ved_serve},
                      "lm_families": {"two_layers_fp32": fam_small,
                                      "serve": fam_serve},
                      "lm_train": {"pieces": train_pieces,
                                   "smollm_2_layers_fp32": train_small,
                                   "smollm_full": train_rec},
                      "characterization": char,
                      "serving": serve_rec,
                      "partitioned": part_rec,
                      "overlap": ov_rec,
                      "mesh": mesh_rec,
                      "elastic": elastic_rec,
                      "compiled": compiled_rec,
                      "profiles": profiles}))
    if failures:
        print(f"FAILED: {failures}", file=sys.stderr)
        sys.exit(1)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
