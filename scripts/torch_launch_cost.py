#!/usr/bin/env python3
"""Host cost of the port's HGNN kernel launches, and the HGNN forward walls
they sit in, on one GPU.

    python3 scripts/torch_launch_cost.py [--src DIR] [--rounds 5]
    python3 scripts/torch_launch_cost.py --launchers ROOT [ROOT ...]

``--src`` names the ``src`` directory whose ``repro_torch`` is measured
(default: this checkout's), so that one copy of the script can measure two
trees on one machine, run in turns.  Each number is the median
over ``--rounds`` rounds:

- ``host_us``: host microseconds a wrapper call of ``gat_na`` (unstacked
  at the MAGNN/imdb shape; stacked with ``sem=`` at the HAN/imdb shape),
  of ``fused_fp_na`` (RGCN/imdb (M, md, D) shape), of ``segment_spmm``
  (RGCN/imdb (A, am, M) shape), of ``cached_gather`` (one MAGNN/imdb
  instance position: a strided ``[4278, 16]`` index view, 256 hot rows),
  of ``semantic_scores`` (``[2, 4278, 64]``, Hs = 128) and of
  ``semantic_combine`` (``[2, 4278, 64]``), over 200 calls back to back
  with no synchronisation: what the host spends to issue one launch, the
  wrapper's checks and allocations included (random inputs at those
  shapes, from a seed; the device runs behind);
- ``wall_ms``: ms a forward of HAN/imdb L=1 with the fused NA→SA epilogue,
  MAGNN/imdb L=1 and RGCN/imdb L=1 padded through ``HGNNInferEngine``
  (20 ``infer()`` calls after 3 warm-ups, synchronised at the end);
- ``issue_ms``: host ms a forward over the same 20 calls before the
  synchronisation: where it is close to the wall, the host sets the pace.

``--launchers`` compares checkouts within one process: each named
checkout's ``kernels/build.py`` is loaded on its own and builds that
checkout's library, and its ``repro_torch`` package is imported on its
own; then in every round each checkout's C launchers ``gat_na_launch``
(the two launches above), ``fused_fp_na_launch``, ``segment_spmm_launch``,
``cached_gather_launch``, ``semantic_scores_launch`` and
``semantic_combine_launch`` (``launcher_us``, no Python wrapper; a
launcher that takes a filled cache section gets one made beforehand, one
that takes scratch gets it zeroed) and
its wrappers (``wrapper_us``) are timed in turn on the same inputs, 200
calls back to back.  Taking the checkouts in turns within
one process keeps the host's drift, which moves a host clock by tens of
percent between processes, out of the comparison.

The last line is one JSON object with every median and every round.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def host_us(fn, calls: int = 200) -> float:
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / calls * 1e6


def forward_ms(engine, reps: int = 20):
    import torch

    for _ in range(3):
        engine.infer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.infer()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall / reps * 1e3, issued / reps * 1e3


def launch_inputs(dev):
    """The seven launches at their main-path shapes, random from a seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    n, inst, h, dh, hs = 4278, 16, 8, 8, 128
    magnn = ({"a_dst": t(rng.standard_normal((h, dh)) * 0.3),
              "a_src": t(rng.standard_normal((h, dh)) * 0.3)},
             t(rng.standard_normal((n, h, dh))),
             t(rng.standard_normal((n * inst, h, dh))),
             torch.arange(n * inst, dtype=torch.int32,
                          device=dev).reshape(n, inst),
             t(rng.random((n, inst)) < 0.4))
    s_dim, k = 2, 64
    sem = {"W": t(rng.standard_normal((h * dh, hs)) / np.sqrt(h * dh)),
           "b": t(rng.standard_normal(hs) * 0.1),
           "q": t(rng.standard_normal(hs) / np.sqrt(hs))}
    han = ({"a_dst": t(rng.standard_normal((s_dim, h, dh)) * 0.3),
            "a_src": t(rng.standard_normal((s_dim, h, dh)) * 0.3)},
           t(rng.standard_normal((n, h, dh))),
           t(rng.standard_normal((n, h, dh))),
           t(rng.integers(0, n, (s_dim, n, k)), torch.int32),
           t(rng.random((s_dim, n, k)) < 0.4))
    rows, m, f = 2081, 4278, 3066
    rgcn = (t(rng.standard_normal((m, f))),
            t(rng.standard_normal((f, 64)) / np.sqrt(f)),
            t(rng.integers(0, m, (rows, k)), torch.int32),
            t(rng.random((rows, k)) < 0.03))
    m_a = 5257  # (A, am, M): actor rows as the source, movie rows
    spmm = (t(rng.standard_normal((m_a, 64))),
            t(rng.integers(0, m_a, (n, k)), torch.int32),
            t(rng.random((n, k)) < 0.047))
    nodes = t(rng.integers(0, n + 256, (n, inst, 3)), torch.int32)
    gather = (t(rng.standard_normal((n, 64))),
              t(rng.permutation(n)[:256], torch.int32), nodes[:, :, 1])
    z = t(rng.standard_normal((s_dim, n, h * dh)))
    scores = (z, sem["W"], sem["b"], sem["q"])
    combine = (z, torch.softmax(t(rng.standard_normal(s_dim)), 0))
    return magnn, han, sem, rgcn, spmm, gather, scores, combine


def c_launches(root: Path, tag: str, dev, magnn, han, sem, rgcn, spmm,
               gather, scores, combine) -> dict:
    """Calls of one checkout's C launchers on the given inputs, with its
    own argument lists (a launcher that takes scratch buffers gets them
    zeroed, as its wrapper keeps them)."""
    import torch

    spec = importlib.util.spec_from_file_location(
        f"build_{tag}", root / "src" / "repro_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gat_work = len(mod.SIGNATURES["gat_na_launch"][0]) == 20
    ffn_scratch = len(mod.SIGNATURES["fused_fp_na_launch"][0]) == 13
    # the launcher that reads a filled cache section takes a copy flag
    # where the fill-free one takes the stride of the hot ids
    gather_fill = mod.SIGNATURES["cached_gather_launch"][0][-2] is not \
        ctypes.c_longlong
    # the one-launch scores kernel takes a last-block counter
    scores_done = len(mod.SIGNATURES["semantic_scores_launch"][0]) == 12

    def gat(p, h_dst, h_src, nbr, mask, sem=None):
        s_dim, n, k = (1,) * (3 - nbr.dim()) + tuple(nbr.shape)
        heads, dh = h_src.shape[1:]
        out = torch.empty((s_dim, n, heads, dh), device=dev)
        score = torch.empty(s_dim * n, device=dev)
        w = torch.empty(s_dim, device=dev)
        work = torch.zeros(1, dtype=torch.int32, device=dev)
        t = [h_dst, h_src, nbr, mask, p["a_dst"], p["a_src"]]
        t += [sem["W"], sem["b"], sem["q"]] if sem else [None] * 3
        t += [out] + ([score, w] if sem else [None, None])
        t += [work] if gat_work else []
        ptrs = [None if x is None else x.data_ptr() for x in t]
        ints = [s_dim, n, k, heads, dh, sem["W"].shape[1] if sem else 0]
        return lambda keep=t: mod.check(
            lib.gat_na_launch(*ptrs, *ints, stream), "gat_na")

    def ffn(x, w, nbr, mask):
        n, k = nbr.shape
        tiles = -(-n // 64)
        out = torch.empty((n, w.shape[1]), device=dev)
        t = [x, w, nbr, mask, out]
        if ffn_scratch:
            t += [torch.empty(8 * tiles * 64 * w.shape[1], device=dev),
                  torch.zeros(tiles, dtype=torch.int32, device=dev)]
        ptrs = [x.data_ptr() for x in t]
        ints = [n, k, x.shape[1], w.shape[1], 1]
        return lambda keep=t: mod.check(
            lib.fused_fp_na_launch(*ptrs, *ints, stream), "fused_fp_na")

    def seg(h_src, nbr, mask):
        n, k = nbr.shape
        out = torch.empty((n, h_src.shape[1]), device=dev)
        t = [h_src, nbr, mask, out]
        ptrs = [x.data_ptr() for x in t]
        return lambda keep=t: mod.check(
            lib.segment_spmm_launch(*ptrs, n, k, h_src.shape[1], 1, stream),
            "segment_spmm")

    def gat_pos(table, hot, idx):
        (n, d), (rows, cols) = table.shape, idx.shape
        out = torch.empty((rows, cols, d), device=dev)
        if gather_fill:
            cache = table.index_select(0, hot)
            t = [table, cache, idx, out]
            rest = [n, hot.shape[0], d, rows, cols, *idx.stride(), 1]
        else:
            t = [table, hot, idx, out]
            rest = [n, hot.shape[0], d, hot.stride(0), rows, cols,
                    *idx.stride()]
        ptrs = [x.data_ptr() for x in t]
        return lambda keep=t: mod.check(
            lib.cached_gather_launch(*ptrs, *rest, stream), "cached_gather")

    def sc(z, w, b, q):
        p, n, d = z.shape
        out = torch.empty(p, device=dev)
        part = torch.zeros(p * -(-n // 32), device=dev)  # either tile
        t = [z, w, b, q, part]
        t += [torch.zeros(1, dtype=torch.int32, device=dev)] \
            if scores_done else []
        t += [out]
        ptrs = [x.data_ptr() for x in t]
        return lambda keep=t: mod.check(
            lib.semantic_scores_launch(*ptrs, p, n, d, w.shape[1], stream),
            "semantic_scores")

    def comb(z, beta):
        p, n, d = z.shape
        out = torch.empty((n, d), device=dev)
        return lambda keep=(z, beta, out): mod.check(
            lib.semantic_combine_launch(z.data_ptr(), beta.data_ptr(),
                                        out.data_ptr(), p, n * d, stream),
            "semantic_combine")

    return {"gat_na unstacked (MAGNN/imdb)": gat(*magnn),
            "gat_na sem= (HAN/imdb)": gat(*han, sem=sem),
            "fused_fp_na (RGCN/imdb M|md|D)": ffn(*rgcn),
            "segment_spmm (RGCN/imdb A|am|M)": seg(*spmm),
            "cached_gather (MAGNN/imdb position)": gat_pos(*gather),
            "semantic_scores ([2, 4278, 64], Hs 128)": sc(*scores),
            "semantic_combine ([2, 4278, 64])": comb(*combine)}


def wrapper_calls(root: Path, magnn, han, sem, rgcn, spmm, gather, scores,
                  combine) -> dict:
    """Calls of one checkout's Python wrappers: its ``repro_torch`` is
    imported with no other in ``sys.modules``, and the wrappers keep the
    modules they were imported with."""
    def drop():
        for name in [m for m in sys.modules
                     if m.split(".")[0] == "repro_torch"]:
            del sys.modules[name]

    drop()
    sys.path.insert(0, str(root / "src"))
    try:
        from repro_torch.kernels import feature_cache as tfc
        from repro_torch.kernels import fused_fp_na as tffn
        from repro_torch.kernels import gat_na as tgat
        from repro_torch.kernels import segment_spmm as tspmm
        from repro_torch.kernels import semantic_attn as tsem
    finally:
        sys.path.remove(str(root / "src"))
        drop()
    return {"gat_na unstacked (MAGNN/imdb)": lambda: tgat.gat_na(*magnn),
            "gat_na sem= (HAN/imdb)": lambda: tgat.gat_na(*han, sem=sem),
            "fused_fp_na (RGCN/imdb M|md|D)": lambda: tffn.fused_fp_na(
                *rgcn),
            "segment_spmm (RGCN/imdb A|am|M)": lambda: tspmm.segment_spmm(
                *spmm),
            "cached_gather (MAGNN/imdb position)":
                lambda: tfc.cached_gather(*gather),
            "semantic_scores ([2, 4278, 64], Hs 128)":
                lambda: tsem.semantic_scores(*scores),
            "semantic_combine ([2, 4278, 64])":
                lambda: tsem.semantic_combine(*combine)}


def compare_launchers(roots, rounds: int) -> dict:
    import torch

    dev = torch.device("cuda")
    inputs = launch_inputs(dev)
    calls = {}
    for i, root in enumerate(roots):
        root = Path(root).resolve()
        calls[f"launcher_us {i}:{root.name}"] = c_launches(root, str(i), dev,
                                                           *inputs)
        calls[f"wrapper_us {i}:{root.name}"] = wrapper_calls(root, *inputs)
    times = {tree: {k: [] for k in fns} for tree, fns in calls.items()}
    with torch.inference_mode():
        for _ in range(rounds):
            for tree, fns in calls.items():
                for k, fn in fns.items():
                    times[tree][k].append(host_us(fn))
    return times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--launchers", nargs="+", metavar="ROOT")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures a GPU")
    if args.launchers:
        times = compare_launchers(args.launchers, args.rounds)
        medians = {tree: {k: statistics.median(v) for k, v in per.items()}
                   for tree, per in times.items()}
        for tree, per in medians.items():
            for k, v in per.items():
                print(f"  {tree} {k}: {v:.3f} (rounds "
                      f"{', '.join(f'{x:.3f}' for x in times[tree][k])})")
        print(card_line())
        print(json.dumps({"card": card_line(), "median": medians,
                          "rounds": times}))
        return
    sys.path.insert(0, str(Path(args.src).resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import feature_cache as tfc
    from repro_torch.kernels import fused_fp_na as tffn
    from repro_torch.kernels import gat_na as tgat
    from repro_torch.kernels import segment_spmm as tspmm
    from repro_torch.kernels import semantic_attn as tsem
    from repro_torch.launch.serve import build_hgnn_infer
    from repro_torch.serve.engine import HGNNInferEngine

    import repro_torch
    print(f"repro_torch from {Path(repro_torch.__file__).parent}")
    dev = torch.device("cuda")
    magnn, han, sem, rgcn, spmm, gather, scores, combine = launch_inputs(dev)
    launches = {
        "gat_na unstacked (MAGNN/imdb)": lambda: tgat.gat_na(*magnn),
        "gat_na sem= (HAN/imdb)": lambda: tgat.gat_na(*han, sem=sem),
        "fused_fp_na (RGCN/imdb M|md|D)": lambda: tffn.fused_fp_na(*rgcn),
        "segment_spmm (RGCN/imdb A|am|M)": lambda: tspmm.segment_spmm(
            *spmm),
        "cached_gather (MAGNN/imdb position)": lambda: tfc.cached_gather(
            *gather),
        "semantic_scores ([2, 4278, 64], Hs 128)":
            lambda: tsem.semantic_scores(*scores),
        "semantic_combine ([2, 4278, 64])":
            lambda: tsem.semantic_combine(*combine),
    }
    hg = make_dataset("imdb")
    engines = {}
    for tag, cfg in (
            ("han L=1 fused", HGNNConfig(model="han", dataset="imdb",
                                         fused=True, use_pallas=True,
                                         fuse_na_sa=True)),
            ("magnn L=1", HGNNConfig(model="magnn", dataset="imdb",
                                     use_pallas=True)),
            ("rgcn L=1 padded", HGNNConfig(model="rgcn", dataset="imdb",
                                           fused=True, use_pallas=True))):
        b = build_hgnn_infer(cfg, hg, dev)
        engines[tag] = HGNNInferEngine(b.executor, b.params, b.batch,
                                       fn=b.fn)
    rounds = {"host_us": {k: [] for k in launches},
              "wall_ms": {k: [] for k in engines},
              "issue_ms": {k: [] for k in engines}}
    with torch.inference_mode():
        for _ in range(args.rounds):
            for tag, fn in launches.items():
                rounds["host_us"][tag].append(host_us(fn))
            for tag, engine in engines.items():
                wall, issued = forward_ms(engine)
                rounds["wall_ms"][tag].append(wall)
                rounds["issue_ms"][tag].append(issued)
    medians = {kind: {tag: statistics.median(v) for tag, v in per.items()}
               for kind, per in rounds.items()}
    for kind, per in medians.items():
        for tag, v in per.items():
            print(f"  {kind} {tag}: {v:.4f} (rounds "
                  f"{', '.join(f'{x:.4f}' for x in rounds[kind][tag])})")
    print(card_line())
    print(json.dumps({"card": card_line(), "src": args.src,
                      "median": medians, "rounds": rounds}))


if __name__ == "__main__":
    main()
