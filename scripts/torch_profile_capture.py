#!/usr/bin/env python3
"""How often a torch.profiler capture of one kernel call loses a kernel, on
one GPU, with and without ``chip_smoke.device_kernels``'s lead-in.

    python3 scripts/torch_profile_capture.py [--reps 150]

The call is one ``segment_sum`` at HAN/imdb's ``csr`` shape (E 174,346
sorted segment ids drawn from a seed, N 4278, C 8), which runs two kernels,
the segments then the long ones.  Each round takes two captures in turn:

- ``bare``: ``fn`` once under the profiler, the device events as they come;
- ``lead_in``: ``chip_smoke.device_kernels(fn)``, which runs lead-in
  kernels first and a tail kernel after, and counts only what lies
  between the last lead-in kept and the tail, retrying a capture that
  lacks them or the call.

A capture is short when it does not hold the two kernels in order.  Prints
the count of short captures of each kind, then one JSON line.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=150)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.kernels import segment_sum as tss

    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on a GPU")
        return 1
    g = torch.Generator().manual_seed(0)
    n, e, c = 4278, 174346, 8
    seg = torch.sort(torch.randint(0, n, (e,), generator=g)).values
    seg = seg.int().cuda()
    vals = torch.randn(e, c, generator=g).cuda()

    def fn():
        return tss.segment_sum(vals, seg, n)

    def bare():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [ev.name for ev in prof.events()
                if ev.device_type == DeviceType.CUDA]

    def whole(names):
        return (len(names) == 2 and "segment_sum_kernel" in names[0]
                and "segment_sum_long_kernel" in names[1])

    short = {"bare": 0, "lead_in": 0}
    t0 = time.perf_counter()
    for i in range(args.reps):
        for kind, take in (("bare", bare),
                           ("lead_in", lambda: chip_smoke.device_kernels(fn))):
            names = take()
            if not whole(names):
                short[kind] += 1
                print(f"  round {i} {kind}: short capture {names}")
    secs = time.perf_counter() - t0
    print(f"short captures of {args.reps}: bare {short['bare']}, "
          f"lead-in {short['lead_in']} ({secs:.1f} s; "
          f"{torch.cuda.get_device_name(0)})")
    print(json.dumps({"reps": args.reps, "short": short, "seconds": secs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
