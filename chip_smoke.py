#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc`` (``nvcc``, at first use), holds each kernel against its plain
PyTorch version at the shapes of the main path, drives the main path —
HAN full-graph inference on synthetic IMDB at full width (hidden 64, 8
heads, K = 64, 4278 target rows) through ``build_hgnn_infer`` and
``HGNNInferEngine`` for 1 and 2 layers, with the fused NA→SA epilogue on
and off — checks the logits and the kernels' launch counts, and times
every kernel beside its bound.  It imports nothing of jax or of the JAX
package ``repro``.

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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail_now("no CUDA device: this smoke test runs on a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail_now(f"the port (src/repro_torch) is not beside {__file__}")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.base import HGNNConfig
    from repro_torch.core.models import get_model
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import gat_na as tgat
    from repro_torch.kernels import semantic_attn as tsem
    from repro_torch.launch.serve import build_hgnn_infer
    from repro_torch.serve.engine import HGNNInferEngine

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

    # ---------------- phase 3: the main path ----------------
    print("phase 3: HAN/imdb full-graph inference through the entry points")
    main_counts = {"gat_na": 0, "gat_na_fused_sa": 0, "semantic_combine": 0}
    forward_ms, profiles = {}, {}
    cpu_batch = None
    for layers in (1, 2):
        for fuse in (True, False):
            cfg = cfg1.replace(layers=layers, fuse_na_sa=fuse)
            tag = f"L={layers} fuse_na_sa={fuse}"
            b = build_hgnn_infer(cfg, hg, dev)
            engine = HGNNInferEngine(b.executor, b.params, b.batch, fn=b.fn)
            ops.reset_launch_counts()
            for _ in range(ITERS):
                logits = engine.infer()
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            fused = counts["gat_na_fused_sa"]
            main_counts["gat_na"] += counts["gat_na"] - fused
            main_counts["gat_na_fused_sa"] += fused
            main_counts["semantic_combine"] += counts["semantic_combine"]
            per = layers * ITERS
            check(counts == {"gat_na": per,
                             "gat_na_fused_sa": per if fuse else 0,
                             "semantic_combine": per if fuse else 0},
                  f"{tag}: launches {counts} over {ITERS} forwards")
            check(tuple(logits.shape) == (4278, 8)
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
            if layers == 1 and fuse:
                if cpu_batch is None:
                    cpu_batch = plain_model.prepare(hg, "cpu")
                cpu_params = {kk: (vv.cpu() if torch.is_tensor(vv) else
                                   {a: t.cpu() for a, t in vv.items()})
                              for kk, vv in b.params.items()}
                with torch.inference_mode():
                    on_cpu = plain_model.forward(cpu_params, cpu_batch)
                err = max_err(logits.cpu(), on_cpu)
                check(close(logits.cpu(), on_cpu, **TOL_CPU),
                      f"{tag}: logits vs the plain arm on the CPU: max "
                      f"|err| {err:.3e} (tol {TOL_CPU})")
            plain_engine = HGNNInferEngine(plain_model.executor, b.params,
                                           b.batch)
            forward_ms[tag] = wall_ms(engine)
            forward_ms[tag + " plain"] = wall_ms(plain_engine)
            print(f"  {tag}: forward {forward_ms[tag]:.4f} ms/iter wall "
                  f"(plain arm {forward_ms[tag + ' plain']:.4f} ms/iter)",
                  flush=True)
            profiles[tag] = profile_forward(engine, tag)

    # ---------------- phase 4: timing ----------------
    print("phase 4: kernel times (CUDA events, median; cold = L2 flushed)")
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=dev)
    hs = sem["W"].shape[1]
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
        kernels = []
        source = {"gat_na": "src/repro_torch/kernels/csrc/gat_na.cu",
                  "gat_na_fused_sa": "src/repro_torch/kernels/csrc/gat_na.cu",
                  "semantic_combine":
                      "src/repro_torch/kernels/csrc/semantic_combine.cu"}
        replaces = {"gat_na": "src/repro/kernels/gat_na.py:225",
                    "gat_na_fused_sa": "src/repro/kernels/gat_na.py:225",
                    "semantic_combine":
                        "src/repro/kernels/semantic_attn.py:153"}
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
            kernels.append(entry)
            print(f"  {name}: {ms:.5f} ms cold, {warm_ms:.5f} ms warm "
                  f"(plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms by "
                  f"{b_by}, library "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.5f} ms'})")
        for name in ("gat_na", "gat_na_fused_sa", "semantic_combine"):
            check(main_counts[name] > 0,
                  f"{name} launched {main_counts[name]} times on the main path")

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(f"clocks.sm, clocks.max.sm, power.draw, temperature: {clocks}")
    print(json.dumps({"forward_ms_per_iter": forward_ms,
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
