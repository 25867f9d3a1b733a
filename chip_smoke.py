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
plus one RGCN forward on synthetic DBLP — checks the logits and the
kernels' launch counts, and times every kernel beside its bound.  It
imports nothing of jax or of the JAX package ``repro``.

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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
ITERS = 3  # infer() calls per main-path configuration
TOL_Z = dict(atol=1e-5, rtol=1e-5)  # per-slot online vs one-shot softmax
TOL_W = dict(atol=1e-4, rtol=1e-4)  # 4278 row scores summed in another order
TOL_LOGITS = dict(atol=1e-5, rtol=1e-5)  # kernel arm vs plain arm, one card
TOL_CPU = dict(atol=1e-4, rtol=1e-4)  # card vs CPU: FP sums F=3066 differently
TOL_SPMM = dict(atol=1e-5, rtol=1e-5)  # slot order vs the plain sum's order
# fused_fp_na: F = 3066 products accumulated in order with FMA, against the
# plain aggregate-then-matmul and the executor's matmul-then-aggregate
TOL_FFN = dict(atol=1e-5, rtol=1e-5)

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


def profile_forward(engine, tag: str, reps: int = 10) -> dict:
    """Device time by kernel over ``reps`` forwards (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
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


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
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


def spmm_work(n_src_cols: int, nbr, mask, d_out: int = 0):
    """Bytes and operations of ``segment_spmm`` (``d_out == 0``) or of
    ``fused_fp_na`` (``d_out = D``, ``n_src_cols = F``) on these inputs:
    the mask once (4 bytes a slot), the index of each live slot (a dead
    slot's index is never needed), each source row that a live slot names
    once, the output once; per live slot a multiply-add per column, the
    divide per output column; the fused form adds W once and the
    ``2*N*F*D`` operations of the product."""
    n, k = nbr.shape
    live = mask != 0
    n_live = int(live.sum())
    named = int(nbr[live].unique().numel())
    n_bytes = 4 * n * k + 4 * n_live + named * n_src_cols * 4
    n_ops = 2 * n_live * n_src_cols + n * n_src_cols
    if d_out:
        n_bytes += n_src_cols * d_out * 4 + n * d_out * 4
        n_ops += 2 * n * n_src_cols * d_out
    else:
        n_bytes += n * n_src_cols * 4
    return n_bytes, n_ops, n_live


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


def drive_variant(cfg, hg, dev, tag: str, per_forward, cpu_check: bool,
                  forward_ms: dict, profiles: dict) -> dict:
    """Drive one configuration through ``build_hgnn_infer`` +
    ``HGNNInferEngine``: ITERS forwards with every launch count set to 0
    just before and read just after, held equal to ``per_forward(batch)``
    (kernel -> launches a forward; the rest 0) times ITERS; logits finite
    and of the target's shape; against the plain arm on the card and, with
    ``cpu_check``, on the CPU; then walls and a profile.  Returns the
    counts."""
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
    return counts


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
                         profiles)["segment_spmm"]


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
    from repro_torch.kernels import fused_fp_na as tffn
    from repro_torch.kernels import gat_na as tgat
    from repro_torch.kernels import segment_spmm as tspmm
    from repro_torch.kernels import semantic_attn as tsem
    from repro_torch.launch.serve import build_hgnn_infer
    from repro_torch.serve.engine import HGNNInferEngine  # noqa: F401

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

    # ---------------- phase 3: the main paths ----------------
    print("phase 3: HAN/imdb full-graph inference through the entry points")
    main_counts = {"gat_na": 0, "gat_na_fused_sa": 0, "semantic_combine": 0,
                   "segment_spmm": 0, "fused_fp_na": 0}
    forward_ms, profiles = {}, {}
    for layers in (1, 2):
        for fuse in (True, False):
            counts = drive_variant(
                cfg1.replace(layers=layers, fuse_na_sa=fuse), hg, dev,
                f"L={layers} fuse_na_sa={fuse}",
                lambda batch: {"gat_na": layers,
                               "gat_na_fused_sa": layers if fuse else 0,
                               "semantic_combine": layers if fuse else 0},
                layers == 1 and fuse, forward_ms, profiles)
            fused = counts["gat_na_fused_sa"]
            main_counts["gat_na"] += counts["gat_na"] - fused
            main_counts["gat_na_fused_sa"] += fused
            main_counts["semantic_combine"] += counts["semantic_combine"]

    print("phase 3b: RGCN/imdb full-graph inference through the entry points")
    cfg_r = HGNNConfig(model="rgcn", dataset="imdb", fused=True,
                       use_pallas=True)
    for layers in (1, 2):
        for buckets in (0, 3):
            counts = drive_variant(
                cfg_r.replace(layers=layers, degree_buckets=buckets), hg, dev,
                f"rgcn L={layers} "
                f"{f'bucketed {buckets}' if buckets else 'padded'}",
                segment_spmm_launches(layers), layers == 1 and not buckets,
                forward_ms, profiles)
            main_counts["segment_spmm"] += counts["segment_spmm"]
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
            spmm_work(x.shape[1], f_nbr, f_mask, w.shape[1])[:2])
        shapes = {
            "segment_spmm": "one RGCN/imdb layer: 4 launches, one per "
                            "relation, K=64, D=64",
            "fused_fp_na": f"RGCN/imdb M|md|D: x {tuple(x.shape)}, W "
                           f"{tuple(w.shape)}, nbr/mask {tuple(f_nbr.shape)}",
        }
        library = {"semantic_combine": "torch.einsum",
                   "segment_spmm": "torch.sparse.mm (CSR of mask/deg, one "
                                   "call per relation)",
                   "fused_fp_na": "torch.sparse.mm then @ W (two calls)"}
        kernels = []
        source = {"gat_na": "src/repro_torch/kernels/csrc/gat_na.cu",
                  "gat_na_fused_sa": "src/repro_torch/kernels/csrc/gat_na.cu",
                  "semantic_combine":
                      "src/repro_torch/kernels/csrc/semantic_combine.cu",
                  "segment_spmm":
                      "src/repro_torch/kernels/csrc/segment_spmm.cu",
                  "fused_fp_na": "src/repro_torch/kernels/csrc/fused_fp_na.cu"}
        replaces = {"gat_na": "src/repro/kernels/gat_na.py:225",
                    "gat_na_fused_sa": "src/repro/kernels/gat_na.py:225",
                    "semantic_combine":
                        "src/repro/kernels/semantic_attn.py:153",
                    "segment_spmm": "src/repro/kernels/segment_spmm.py:93",
                    "fused_fp_na": "src/repro/kernels/fused_fp_na.py:91"}
        for name, (kern, plain, lib, (n_bytes, n_ops)) in timed.items():
            ms = time_ms(kern, 50, flush)
            plain_ms = time_ms(plain, 20, flush)
            lib_ms = time_ms(lib, 50, flush) if lib is not None else None
            warm_ms = time_ms(kern, 50)
            b_ms, b_by = bound(n_bytes, n_ops)
            entry = {"name": name, "route": "cuda", "source": source[name],
                     "replaces": replaces[name],
                     "launches": main_counts[name], **results[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms,
                     "warm_ms": warm_ms, "bytes": n_bytes,
                     "operations": n_ops}
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

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(f"clocks.sm, clocks.max.sm, power.draw, temperature: {clocks}")
    print(json.dumps({"forward_ms_per_iter": forward_ms,
                      "segment_spmm_per_relation": per_relation,
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
