#!/usr/bin/env python3
"""Where the async stage-graph schedule's time goes on one GPU: a trace of
one overlapped forward, stage by stage.

    python3 scripts/torch_overlap_trace.py [--cases han-csr han-bucketed]

For each case (HAN/imdb ``csr``, HAN/imdb on 3 degree buckets, RGCN/imdb
at K = 4 and L = 2; ``bench_overlap.py``'s settings: hidden 64, 8 heads,
``max_degree`` 32, ``overlap=2``) one ``forward_overlapped`` call runs
under ``torch.profiler`` after 3 warm-ups (the first captures each
stage's CUDA graph, the later ones replay them, as the traced call does),
each stage's dispatch (its stream switch, event waits, the replay and the
window's admission) wrapped in a ``record_function`` window.  It prints, per stage, the host window
that issued it and the device window of its kernels (first start, last
end) with the stream they ran on, in µs from the forward's first event;
then the device time that two streams' kernels overlapped.  So one can
read whether a side-stream stage started while its sibling still ran,
and what the host did meanwhile.

Two controls, timed by CUDA events over 20 calls after 3 warm-ups (median
ms): the two sibling NA stages of the ``csr`` case issued back to back on
the current stream, and issued on two streams (the second on a fresh
``torch.cuda.Stream``, after an event wait on the first's input) with no
window and no ``record_stream``.  Whether the second is faster says
whether the card runs these kernels side by side at all.  The flags of
the executor's side stream (``cuStreamGetFlags``: 1 = non-blocking) are
printed too.

The last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = dict(dataset="imdb", hidden=64, n_heads=8, n_classes=8,
             max_degree=32, fused=True, use_pallas=True, overlap=2)
CASES = {"han-csr": ("han", dict(fused=False)),
         "han-bucketed": ("han", dict(degree_buckets=3)),
         "rgcn-k4L2": ("rgcn", dict(partitions=4, layers=2))}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi failed"


def events_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def stream_flags(stream) -> int:
    """``cuStreamGetFlags`` of a torch stream, through the driver library
    every CUDA process has loaded (-1 if it cannot be asked)."""
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return -1
    flags = ctypes.c_uint(0)
    err = cuda.cuStreamGetFlags(ctypes.c_void_p(stream.cuda_stream),
                                ctypes.byref(flags))
    return int(flags.value) if err == 0 else -1


def trace(built) -> dict:
    """One overlapped forward under the profiler, each stage's dispatch
    in a ``stage::<name>`` window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    ex = built.executor
    walk = ex._walk_schedule

    def traced(params, batch, emit):
        def wrapped(name, key, fn, args):
            with record_function(f"stage::{name}"):
                return emit(name, key, fn, args)
        return walk(params, batch, wrapped)

    ex._walk_schedule = traced
    try:
        with torch.inference_mode():
            for _ in range(3):
                ex.forward_overlapped(built.params, built.batch)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                ex.forward_overlapped(built.params, built.batch)
                torch.cuda.synchronize()
    finally:
        ex._walk_schedule = walk
    evs = prof.events()
    windows = [(e.name[len("stage::"):], e.time_range.start,
                e.time_range.end) for e in evs
               if e.name.startswith("stage::")
               and e.device_type == DeviceType.CPU]
    host = [e for e in evs if e.device_type == DeviceType.CPU]
    launch_at = {e.id: e.time_range.start for e in host
                 if e.name.startswith("cu")}
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA]
    t0 = min([w[1] for w in windows] + [k.time_range.start for k in kernels])
    stages = {}
    for name, a, b in windows:
        mine = [k for k in kernels
                if a <= launch_at.get(k.id, -1.0) <= b]
        stages[name] = {
            "host_us": [a - t0, b - t0],
            "device_us": ([min(k.time_range.start for k in mine) - t0,
                           max(k.time_range.end for k in mine) - t0]
                          if mine else None),
            "kernels": len(mine),
            "streams": sorted({int(getattr(k, "device_resource_id", -1))
                               for k in mine})}
    edges = sorted([(k.time_range.start, 1) for k in kernels]
                   + [(k.time_range.end, -1) for k in kernels])
    both, live, last = 0.0, 0, edges[0][0] if edges else 0.0
    for t, d in edges:
        if live >= 2:
            both += t - last
        live, last = live + d, t
    return {"stages": stages, "overlapped_us": both,
            "kernels": len(kernels)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=list(CASES))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script traces a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.launch.serve import build_hgnn_infer

    print(card_line(), flush=True)
    dev = torch.device("cuda")
    hg = make_dataset("imdb")
    out = {}
    for case in args.cases:
        model, kw = CASES[case]
        b = build_hgnn_infer(HGNNConfig(model=model, **dict(BENCH, **kw)),
                             hg, dev)
        rec = trace(b)
        print(f"{case}: {rec['kernels']} device events, "
              f"{rec['overlapped_us']:.1f} us with two or more at once")
        for name, st in rec["stages"].items():
            d = st["device_us"]
            dev_s = (f"device [{d[0]:.1f}, {d[1]:.1f}]" if d
                     else "no kernel")
            print(f"  {name}: host [{st['host_us'][0]:.1f}, "
                  f"{st['host_us'][1]:.1f}] us, {dev_s} us, "
                  f"{st['kernels']} kernels on streams {st['streams']}")
        streams = [s for ss in b.executor._streams.values() for s in ss]
        rec["side_stream_flags"] = [stream_flags(s) for s in streams]
        print(f"  side stream flags {rec['side_stream_flags']} "
              f"(1 = cudaStreamNonBlocking)")
        if case == "han-csr":
            ex, p, bt = b.executor, b.params, b.batch
            with torch.inference_mode():
                h = ex.fp(p, bt)
                side = torch.cuda.Stream(dev)

                def one_stream():
                    ex._na_metapath(p, bt, h, 0)
                    ex._na_metapath(p, bt, h, 1)

                def two_streams():
                    ready = torch.cuda.Event()
                    ready.record()
                    side.wait_event(ready)
                    ex._na_metapath(p, bt, h, 0)
                    with torch.cuda.stream(side):
                        ex._na_metapath(p, bt, h, 1)
                    done = torch.cuda.Event()
                    done.record(side)
                    torch.cuda.current_stream().wait_event(done)

                rec["one_stream_ms"] = events_ms(one_stream)
                rec["two_streams_ms"] = events_ms(two_streams)
                rec["one_stream_again_ms"] = events_ms(one_stream)
            print(f"  the two NA.p stages: one stream "
                  f"{rec['one_stream_ms']:.4f} ms, two streams "
                  f"{rec['two_streams_ms']:.4f} ms, one stream again "
                  f"{rec['one_stream_again_ms']:.4f} ms (CUDA events, "
                  f"median of 20)", flush=True)
        out[case] = rec
        del b
        torch.cuda.empty_cache()
    print(card_line())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
