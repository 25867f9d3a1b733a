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
rows a type), plus HAN and RGCN with residency — and LM serving of
granite-8b: the prefill and decode kernels against their plain versions at
the granite and h2o-danube shapes, granite at full width and 2 layers in
fp32 (kernel arm against plain arm, teacher-forced), and the full 36-layer
bf16 granite through ``ServeEngine.generate`` (4 prompts of 2048 tokens,
32 greedy tokens each, twice).  It checks the logits (the kernel arm
against the plain arm, cached against uncached bitwise) and the kernels'
launch counts, and times every kernel beside its bound.  It imports
nothing of jax or of the JAX package ``repro``.

Output: progress lines, then the card's name and power limit as
``nvidia-smi`` prints them, a ``{"kernels": [...]}`` JSON line, and as the
last line ``{"ok": true, "device": {...}}``.  It exits non-zero, with no
result line, when there is no CUDA device, when the port is not beside it,
or when any phase fails.
"""
from __future__ import annotations

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


def gat_na_work(h_dst, h_src, nbr, mask, hs: int):
    """Bytes the function must move and operations it must do on these
    inputs, whatever the algorithm: each input read once, each output
    written once, only the source rows that live slots name; e_src = a_src·h
    once per named source row of each metapath, and per live slot the score
    and softmax terms per head plus the weighted reduce."""
    import torch

    s_dim, n, k = nbr.shape
    heads = h_dst.shape[1]
    hd = heads * h_dst.shape[2]
    live = int((mask != 0).sum())
    named = [nbr[s][mask[s] != 0].unique() for s in range(s_dim)]
    n_bytes = 2 * nbr.numel() * 4 + n * hd * 4 + s_dim * n * hd * 4
    n_bytes += 2 * s_dim * hd * 4  # a_dst, a_src
    if h_src.data_ptr() != h_dst.data_ptr():
        n_bytes += int(torch.cat(named).unique().numel()) * hd * 4
    n_ops = 2 * s_dim * n * hd  # e_dst
    n_ops += 2 * hd * sum(int(r.numel()) for r in named)  # e_src
    # per live slot: add, leaky relu, max, shift, exp, denominator per head;
    # multiply-add per feature
    n_ops += live * (6 * heads + 2 * hd)
    n_ops += s_dim * n * hd  # the final divide
    if hs:
        n_bytes += (hd * hs + 2 * hs) * 4 + s_dim * 4  # W, b, q; w
        # per row: elu, zW + b, tanh, the q dot; then the mean
        n_ops += s_dim * n * (hd + 2 * hd * hs + 4 * hs) + s_dim * n
    return n_bytes, n_ops, live


def device_kernels(fn) -> list:
    """Names of the device kernels (and copies) that one call of ``fn``
    runs, by torch.profiler, after a warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def spmm_work(n_src_cols: int, nbr, mask):
    """Bytes and operations of ``segment_spmm`` on these inputs: the mask
    once (4 bytes a slot), the index of each live slot (a dead slot's index
    is never needed), each source row that a live slot names once, the
    output once; per live slot a multiply-add per column, the divide per
    output column."""
    n, k = nbr.shape
    live = mask != 0
    n_live = int(live.sum())
    named = int(nbr[live].unique().numel())
    n_bytes = 4 * n * k + 4 * n_live + named * n_src_cols * 4
    n_ops = 2 * n_live * n_src_cols + n * n_src_cols
    return n_bytes + n * n_src_cols * 4, n_ops, n_live


def ffn_work(x, w, nbr, mask):
    """Bytes, fp32 operations and TF32 tensor-core operations of
    ``fused_fp_na`` on these inputs: ``segment_spmm``'s reads of the mask,
    the live indices and the named raw rows, plus W once and the [N, D]
    output once; the aggregate's multiply-adds in fp32; the product
    ``2*N*F*D`` three times over (the kernel's 3xTF32 split)."""
    n, f, d = nbr.shape[0], x.shape[1], w.shape[1]
    n_bytes, n_ops, _ = spmm_work(f, nbr, mask)
    n_bytes += f * d * 4 + n * d * 4 - n * f * 4  # out is [N, D], not [N, F]
    return n_bytes, n_ops, 3 * 2 * n * f * d


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


def gather_work(table, hot, idx):
    """Bytes of ``cached_gather`` on these inputs: the output and the
    indices once, the hot ids once, and each table row that an index names
    (directly, or through its hot id: the kernel reads no cache section)
    once; it computes nothing."""
    import torch

    n, d = table.shape
    v = idx.long().reshape(-1)
    rows = torch.where(v >= n, hot.long()[(v - n).clamp(0, hot.numel() - 1)],
                       v)
    n_bytes = idx.numel() * 4 * (1 + d) + hot.numel() * 4
    n_bytes += int(rows.unique().numel()) * d * 4
    return n_bytes, 0


def scores_work(z, w):
    """Bytes and operations of ``semantic_scores``: z, W, b, q read once,
    w written once; per row ``zW + b`` (2*D*Hs: the kernel's D FFMAs a
    column from b), tanh and the q dot (3*Hs), and the mean.  The kernel
    does all of it in fp32 outside the tensor cores, so the bound takes
    the fp32 peak."""
    p, n, d = z.shape
    hs = w.shape[1]
    n_bytes = (z.numel() + d * hs + 2 * hs + p) * 4
    return n_bytes, p * n * (2 * d * hs + 3 * hs + 1)


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


def drive_variant(cfg, hg, dev, tag: str, per_forward, cpu_check: bool,
                  forward_ms: dict, profiles: dict) -> dict:
    """Drive one configuration through ``build_hgnn_infer`` +
    ``HGNNInferEngine``: ITERS forwards with every launch count set to 0
    just before and read just after, held equal to ``per_forward(batch)``
    (kernel -> launches a forward; the rest 0) times ITERS; logits finite
    and of the target's shape; against the plain arm on the card and, with
    ``cpu_check``, on the CPU; then walls and a profile.  Returns the
    counts and the logits."""
    import torch
    from repro_torch.core.models import get_model
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_hgnn_infer
    from repro_torch.serve.engine import HGNNInferEngine

    b = build_hgnn_infer(cfg, hg, dev)
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
    return counts, logits


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


def attn_inputs(gen, b, s, h, kvh, dh, dtype, decode=False):
    """q, k, v drawn on the card: ``N(0, 1)``, the scale of RoPE'd
    projections of RMS-normed activations."""
    import torch

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(dtype)

    q = draw(b, h, dh) if decode else draw(b, s, h, dh)
    return q, draw(b, s, kvh, dh), draw(b, s, kvh, dh)


def flash_work(q, k, causal: bool, window: int):
    """Bytes (q, k, v read once, out written once) and operations (a dot
    and a multiply-add per head dim per live pair: 4 Dh) of one call."""
    b, s, h, dh = q.shape
    rows = range(s)
    lo = [max(0, i - window + 1) if window else 0 for i in rows]
    hi = [i + 1 if causal else s for i in rows]
    pairs = sum(max(0, e - a) for a, e in zip(lo, hi))
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return n_bytes, 4 * b * h * dh * pairs


def decode_work(q, k, kv_len):
    """Bytes of the live cache rows (k and v), q, out and kv_len, and the
    operations (4 Dh a head a live row) of one call."""
    b, h, dh = q.shape
    live = int(kv_len.clamp(max=k.shape[1]).sum())
    n_bytes = ((2 * live * k.shape[2] * dh + 2 * q.numel()) * q.element_size()
               + 4 * b)
    return n_bytes, 4 * live * h * dh


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

    cases = [  # (tag, B, S, H, KVH, Dh, causal, window, dtype)
        ("granite prefill bf16", 4, 2048, 32, 8, 128, True, 0, "bfloat16"),
        ("granite prefill fp32", 1, 2048, 32, 8, 128, True, 0, "float32"),
        ("danube window 4096 bf16", 1, 4608, 32, 8, 120, True, 4096,
         "bfloat16"),
        ("danube window 4096 fp32", 1, 4608, 32, 8, 120, True, 4096,
         "float32"),
        ("granite tail S=2000 fp32", 1, 2000, 32, 8, 128, True, 0,
         "float32"),
    ]
    with torch.inference_mode():
        for tag, b, s, h, kvh, dh, causal, window, dt in cases:
            q, k, v = attn_inputs(gen, b, s, h, kvh, dh, getattr(torch, dt))

            def flash(q, k, v, fn=tflash.flash_attention):
                return fn(q, k, v, causal=causal, window=window)

            def flash_plain(q, k, v):
                return flash(q, k, v, fn=tflash.flash_attention_plain)

            hold("flash_attention", f"{tag} {tuple(q.shape)}", dt, flash,
                 flash_plain, (q, k, v), lambda: flash(q, k, v))
            del q, k, v
        for dt in ("bfloat16", "float32"):
            q, k, v = attn_inputs(gen, 4, 2080, 32, 8, 128,
                                  getattr(torch, dt), decode=True)
            kv_len = torch.tensor([1, 1000, 2049, 2080], dtype=torch.int32,
                                  device=dev)
            hold("decode_attention",
                 f"granite {dt} q {tuple(q.shape)} cache {tuple(k.shape)} "
                 f"kv_len {kv_len.tolist()}", dt, tdec.decode_attention,
                 tdec.decode_attention_plain, (q, k, v, kv_len),
                 lambda: tdec.decode_attention(q, k, v, kv_len))
    return out


def teacher_forced(tf, params, cfg, prompts, feed, max_len):
    """Prefill on ``prompts [B, T0]``, then one decode step per column of
    ``feed [B, N]``: the ``1 + N`` steps' logits ``[1 + N, B, V]``, fp32."""
    import torch

    t0 = prompts.shape[1]
    with torch.inference_mode():
        lg, pf = tf.lm_prefill(params, cfg, prompts)
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


def granite_two_layers(dev, ops) -> dict:
    """granite-8b at full width, 2 layers, fp32: the kernel arm against the
    plain arm on the same weights, prefill of 2 x 1536 tokens then 8 decode
    steps teacher-forced on the same tokens."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.nn import transformer as tf

    cfg = get_config(GRANITE).replace(n_layers=2, dtype="float32",
                                      param_dtype="float32")
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
    check(counts == dict(dict.fromkeys(counts, 0), flash_attention=2,
                         decode_attention=2 * 8),
          f"granite 2-layer fp32 kernel arm: launches {counts} (want 2 "
          f"flash_attention, 16 decode_attention)")
    err = max_err(kern, plain)
    check(bool(torch.isfinite(kern).all()) and close(kern, plain, **TOL_LM),
          f"granite 2-layer fp32 (d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, Dh {cfg.resolved_head_dim}, prefill "
          f"2x1536 + 8 teacher-forced steps): logits kernel arm vs "
          f"plain arm max |err| {err:.3e} of max |logit| "
          f"{float(plain.abs().max()):.3f} (tol {TOL_LM})")
    del params
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "tolerance": TOL_LM, "launches": counts}


def granite_serve(dev, ops, profiles: dict) -> dict:
    """granite-8b, full config (36 layers, bf16), through
    ``ServeEngine.generate``: 4 requests of 2048-token prompts and 32 greedy
    tokens, twice; exact launch counts; the plain arm teacher-forced on the
    kernel arm's tokens (its largest logit difference is recorded, not
    gated)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.nn import transformer as tf
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(GRANITE).replace(use_pallas=True)
    t0 = time.perf_counter()
    params = tf.init_lm_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    torch.cuda.synchronize()
    n_params = tf.param_count(params)
    print(f"  granite-8b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, Dh {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_dtype}: {n_params} "
          f"parameters drawn on the card in {time.perf_counter() - t0:.2f} "
          f"s; memory allocated "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, LM_PROMPT).astype(np.int32)
               for _ in range(LM_SLOTS)]
    max_len = LM_PROMPT + LM_NEW
    engine = ServeEngine(cfg, params, batch_slots=LM_SLOTS, max_len=max_len)
    runs, counts = [], []
    for _ in range(2):
        ops.reset_launch_counts()
        done = engine.generate([Request(prompt=p, max_tokens=LM_NEW)
                                for p in prompts])
        torch.cuda.synchronize()
        counts.append(ops.launch_counts())
        runs.append([r.out_tokens for r in done])
    steps = LM_NEW - 1
    for i, c in enumerate(counts):
        check(c == dict(dict.fromkeys(c, 0), flash_attention=cfg.n_layers,
                        decode_attention=cfg.n_layers * steps),
              f"granite serve run {i}: launches {c} (want {cfg.n_layers} "
              f"flash_attention a prefill, {cfg.n_layers} decode_attention "
              f"a step x {steps} steps)")
    toks = runs[0]
    check(all(len(t) == LM_NEW and all(0 <= x < cfg.vocab for x in t)
              for t in toks),
          f"granite serve: {LM_SLOTS} x {LM_NEW} token ids in [0, "
          f"{cfg.vocab})")
    check(runs[1] == toks, "granite serve: the same tokens on a second run")
    timings = engine.timings[-1]
    prefill_ms = timings["prefill_s"] * 1e3
    decode_ms = timings["decode_s"] * 1e3 / max(timings["decode_steps"], 1)
    n_tok = LM_SLOTS * LM_NEW
    wall = timings["prefill_s"] + timings["decode_s"]
    print(f"  granite serve (run 2): prefill {LM_SLOTS}x{LM_PROMPT} "
          f"{prefill_ms:.2f} ms to the first token; decode "
          f"{decode_ms:.3f} ms a token (one step of {LM_SLOTS} slots); "
          f"{n_tok} tokens "
          f"in {wall:.3f} s ({n_tok / wall:.1f} tok/s); run 1: prefill "
          f"{engine.timings[0]['prefill_s'] * 1e3:.2f} ms, decode "
          f"{engine.timings[0]['decode_s'] * 1e3 / steps:.3f} ms a step")
    print(f"  tokens req0: {toks[0]}")

    # logits: the kernel arm replayed teacher-forced on its own tokens (the
    # engine's computation, so its argmax must give the engine's tokens),
    # then the plain arm on the same tokens
    tp = torch.as_tensor(np.stack(prompts), device=dev)
    tt = torch.as_tensor(toks, device=dev)
    kern = teacher_forced(tf, params, cfg, tp, tt[:, :-1], max_len)
    check(bool(torch.isfinite(kern).all()),
          f"granite serve: all {tuple(kern.shape)} logits finite")
    check(torch.equal(kern.argmax(dim=-1).T, tt),
          "granite serve: the kernel arm's teacher-forced argmax gives the "
          "engine's tokens")
    plain = teacher_forced(tf, params, cfg.replace(use_pallas=False), tp,
                           tt[:, :-1], max_len)
    err = max_err(kern, plain)
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"  granite serve: logits kernel arm vs plain arm (teacher-forced, "
          f"bf16, recorded, not gated): max |err| {err:.4e} of max |logit| "
          f"{float(plain.abs().max()):.3f}; argmax agreement {agree:.4f}")
    del kern, plain
    profiles["granite serve"] = profile_forward(
        types.SimpleNamespace(infer=lambda: engine.generate(
            [Request(prompt=p, max_tokens=LM_NEW) for p in prompts])),
        "granite serve (one generate)", reps=1, warmup=0)
    return {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "tokens_per_s": n_tok / wall, "tokens": n_tok,
            "run1": engine.timings[0], "run2": timings,
            "logits_plain_vs_kernel_max_abs_err": err,
            "argmax_agreement": agree, "launches": counts[0],
            "params": n_params}


SASS_KERNELS = ("flash_attention_tc_kernel", "decode_split_kernel",
                "fused_fp_na_kernel", "segment_spmm_kernel", "gat_na_kernel",
                "semantic_scores_kernel", "semantic_combine_kernel")


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
    print(f"  SASS: fused_fp_na_kernel HMMA {ffn['HMMA']}, LDGSTS "
          f"{ffn['LDGSTS']}; gat_na_kernel<fused> LDGSTS {gat['LDGSTS']} "
          f"(16-byte {gat['LDGSTS.128']}), LDS.128 {gat['LDS.128']}, FFMA "
          f"{gat['FFMA']}; gat_na_kernel<unfused> LDGSTS "
          f"{counts['gat_na_kernel']['LDGSTS']}; segment_spmm_kernel LDGSTS "
          f"{spmm['LDGSTS']} (16-byte {spmm['LDGSTS.128']}); "
          f"semantic_scores_kernel LDGSTS {sc['LDGSTS']} (16-byte "
          f"{sc['LDGSTS.128']}), LDS.128 {sc['LDS.128']}, HMMA {sc['HMMA']}, "
          f"FFMA {sc['FFMA']}; semantic_combine_kernel LDG.128 "
          f"{comb['LDG.128']}")
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
    return {name: counts[name] for name in
            ("fused_fp_na_kernel", "gat_na_kernel fused", "gat_na_kernel",
             "segment_spmm_kernel", "semantic_scores_kernel",
             "semantic_combine_kernel")}


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
        n_bytes, n_ops = flash_work(q, k, True, 0)
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
        n_bytes, n_ops = flash_work(q, k, True, 0)
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
        n_bytes, n_ops = decode_work(dq, dk, kv_len)
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
    return entries


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
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.core.models import get_model  # noqa: F401
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import feature_cache as tfc
    from repro_torch.kernels import fused_fp_na as tffn
    from repro_torch.kernels import gat_na as tgat
    from repro_torch.kernels import segment_spmm as tspmm
    from repro_torch.kernels import semantic_attn as tsem
    from repro_torch.launch.serve import build_hgnn_infer
    from repro_torch.nn import transformer  # noqa: F401
    from repro_torch.serve.engine import HGNNInferEngine  # noqa: F401
    from repro_torch.serve.engine import ServeEngine  # noqa: F401

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if bad:
        fail_now(f"the port imported {bad}")

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

    # ---------------- phase 3: the main paths ----------------
    print("phase 3: HAN/imdb full-graph inference through the entry points")
    main_counts = {"gat_na": 0, "gat_na_fused_sa": 0, "semantic_combine": 0,
                   "segment_spmm": 0, "fused_fp_na": 0, "cached_gather": 0,
                   "gat_na_unstacked": 0, "semantic_scores": 0}
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
                forward_ms, profiles)
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
                layers == 1 and not buckets, forward_ms, profiles)
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
                layers == 1 and c == 0, forward_ms, profiles)
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

    # the csr arm sums with index_add_, which adds with atomics on the
    # card (ROADMAP Queue 3 check (d)): held by tolerance, not bitwise
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

    # ---------------- phase 4: timing ----------------
    print("phase 4: kernel times (CUDA events, median; cold = L2 flushed)")
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=dev)
    hs = sem["W"].shape[1]
    per_relation = {}
    with torch.inference_mode():
        timed = {
            "gat_na": (lambda: tgat.gat_na(p_gat, h, h, nbr, mask),
                       lambda: tgat.gat_na_plain(p_gat, h, h, nbr, mask),
                       None, gat_na_work(h, h, nbr, mask, 0)[:2]),
            "gat_na_fused_sa": (
                lambda: tgat.gat_na(p_gat, h, h, nbr, mask, sem=sem),
                lambda: tgat.gat_na_plain(p_gat, h, h, nbr, mask, sem),
                None, gat_na_work(h, h, nbr, mask, hs)[:2]),
            "semantic_combine": (
                lambda: tsem.semantic_combine(z_stack, beta),
                lambda: tsem.semantic_combine_plain(z_stack, beta),
                lambda: torch.einsum("p,pnd->nd", beta, z_stack),
                (z_stack.numel() * 4 + s_dim * 4 + n * z_stack.shape[2] * 4,
                 (2 * s_dim - 1) * n * z_stack.shape[2])),
        }
        # segment_spmm per relation, then one RGCN/imdb layer's four
        # launches together (the kernels line's entry)
        layer_work = [0, 0]
        spmm_csr = []
        for key, h_src, r_nbr, r_mask in spmm_rels:
            csr = mean_csr(r_nbr, r_mask, h_src.shape[0])
            spmm_csr.append(csr)
            n_bytes, n_ops, _ = spmm_work(h_src.shape[1], r_nbr, r_mask)
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
            ffn_work(x, w, f_nbr, f_mask))

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
                    gather_work(t, hh, idx))
                   for (tag, t, hh, idx), pool in zip(gathers, pools)]
        singles += [(f"gat_na unstacked {mp_tag}",
                     lambda a=a: tgat.gat_na(*a),
                     lambda a=a: tgat.gat_na_plain(*a), None,
                     gat_na_work(a[1], a[2], a[3][None], a[4][None], 0)[:2])
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
            scores_work(sa_args[0], sa_args[1]))
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
        }
        library = {"semantic_combine": "torch.einsum",
                   "segment_spmm": "torch.sparse.mm (CSR of mask/deg, one "
                                   "call per relation)",
                   "fused_fp_na": "torch.sparse.mm then @ W (two calls)",
                   "cached_gather": "pool[idx] on the pre-built pool (one "
                                    "call per launch)"}
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
                      "src/repro_torch/kernels/csrc/semantic_scores.cu"}
        replaces = {"gat_na": "src/repro/kernels/gat_na.py:225",
                    "gat_na_fused_sa": "src/repro/kernels/gat_na.py:225",
                    "semantic_combine":
                        "src/repro/kernels/semantic_attn.py:153",
                    "segment_spmm": "src/repro/kernels/segment_spmm.py:93",
                    "fused_fp_na": "src/repro/kernels/fused_fp_na.py:91",
                    "cached_gather": "src/repro/kernels/feature_cache.py:34",
                    "gat_na_unstacked": "src/repro/kernels/gat_na.py:225",
                    "semantic_scores":
                        "src/repro/kernels/semantic_attn.py:100"}
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
            kernels.append(entry)
            print(f"  {name}: {ms:.5f} ms cold, {warm_ms:.5f} ms warm "
                  f"(plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms by "
                  f"{b_by}, library "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.5f} ms'})")
        for name in main_counts:
            check(main_counts[name] > 0,
                  f"{name} launched {main_counts[name]} times on the main path")

    # ---------------- phase 5: LM serving (granite-8b) ----------------
    print("phase 5: flash_attention and decode_attention against their "
          "plain versions (granite-8b and h2o-danube-3-4b shapes)")
    lm_results = lm_kernels_vs_plain(dev)
    print("phase 5b: granite-8b at full width, 2 layers, fp32: the kernel "
          "arm against the plain arm")
    two_layers = granite_two_layers(dev, ops)
    print("phase 5c: granite-8b, 36 layers, bf16, through "
          "ServeEngine.generate")
    serve = granite_serve(dev, ops, profiles)
    lm_counts = {name: serve["launches"][name]
                 for name in ("flash_attention", "decode_attention")}
    for name, n in lm_counts.items():
        check(n > 0, f"{name} launched {n} times on the main path")
    print("phase 5d: LM kernel times (CUDA events, median; cold = L2 "
          "flushed)")
    kernels += lm_kernel_times(dev, flush, lm_results, lm_counts)

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(f"clocks.sm, clocks.max.sm, power.draw, temperature: {clocks}")
    print(json.dumps({"forward_ms_per_iter": forward_ms,
                      "hgnn_sass": hgnn_sass,
                      "segment_spmm_per_relation": per_relation,
                      "magnn_per_launch": magnn_per_launch,
                      "lm": {"granite_2_layers_fp32": two_layers,
                             "granite_serve": serve},
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
