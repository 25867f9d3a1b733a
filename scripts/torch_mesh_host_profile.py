#!/usr/bin/env python3
"""Where the HAN/imdb forward on a 1-rank mesh spends its host time.

    PYTHONPATH=src python3 scripts/torch_mesh_host_profile.py [--device cpu]

Builds HAN/imdb (fused, the kernels, the NA->SA epilogue) through
``launch/serve.build_hgnn_infer`` with and without a ``(data=1, model=1)``
mesh over a process group of one rank (NCCL on the card, gloo with
``--device cpu``), times an eager forward of each (``fn.fn`` where the
card compiles ``fn``; median of ``--reps``, in turns), and runs ``--reps``
eager mesh forwards under cProfile.  It reports the
mesh forward's calls into DTensor's uncached sharding propagation
(``_propagate_op_sharding_dispatch_slow_path``: a fake-tensor run of the
op to learn its output's shape) and their share of the profiled time, and
prints the functions with the most cumulative time.  The last line is one
JSON object.
"""
import argparse
import cProfile
import io
import json
import os
import pstats
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOW_PATH = "_propagate_op_sharding_dispatch_slow_path"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import HGNNConfig
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.serve import build_hgnn_infer

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        cfg = HGNNConfig(model="han", dataset="imdb", fused=True,
                         use_pallas=True, fuse_na_sa=True)
        hg = make_dataset("imdb")
        built = {"mesh-less": build_hgnn_infer(cfg, hg, dev),
                 "mesh": build_hgnn_infer(cfg, hg, dev,
                                          mesh=make_smoke_mesh(1, 1))}

        def forward(b):  # the eager forward: what a capture pays once
            with torch.inference_mode():
                getattr(b.fn, "fn", b.fn)(b.params, b.batch)

        for _ in range(5):
            for b in built.values():
                forward(b)
        walls = {k: [] for k in built}
        for _ in range(args.reps):
            for k, b in built.items():
                sync()
                t0 = time.perf_counter()
                forward(b)
                sync()
                walls[k].append((time.perf_counter() - t0) * 1e3)
        ms = {k: statistics.median(v) for k, v in walls.items()}
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(args.reps):
            forward(built["mesh"])
        sync()
        prof.disable()
    finally:
        dist.destroy_process_group()
    stats = pstats.Stats(prof)
    total = stats.total_tt
    slow = [(v[1], v[3]) for k, v in stats.stats.items() if k[2] == SLOW_PATH]
    calls = sum(c for c, _ in slow)
    cum = sum(t for _, t in slow)
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(25)
    print(text.getvalue())
    name = torch.cuda.get_device_name(dev) if cuda else "host CPU"
    print(f"{name}: HAN/imdb forward wall (median of {args.reps}) mesh "
          f"{ms['mesh']:.4f} ms, mesh-less {ms['mesh-less']:.4f} ms; under "
          f"cProfile {total / args.reps * 1e3:.4f} ms a mesh forward, of "
          f"which DTensor's uncached sharding propagation "
          f"{cum / args.reps * 1e3:.4f} ms ({100 * cum / total:.1f}%) in "
          f"{calls / args.reps:g} calls")
    print(json.dumps({"device": name, "wall_ms": ms,
                      "profiled_ms_per_forward": total / args.reps * 1e3,
                      "slow_path_ms_per_forward": cum / args.reps * 1e3,
                      "slow_path_share": cum / total,
                      "slow_path_calls_per_forward": calls / args.reps}))


if __name__ == "__main__":
    main()
