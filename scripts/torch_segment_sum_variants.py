#!/usr/bin/env python3
"""Design variants of the port's ``segment_sum`` CUDA kernel, timed against
each other on one GPU, in one process.

    python3 scripts/torch_segment_sum_variants.py [--scale1]

Each variant is this checkout's ``csrc/segment_sum.cu`` with a few of its
constants or lines replaced (``VARIANTS`` below), built on its own with
``kernels/build.py``'s flags into ``build/variants/ssum_<name>/`` by
``torch_kernel_variants.build_all`` and called through its C launcher with
``ctypes``.  A variant that keeps the
kernel's arithmetic is held bitwise against the port's own kernel on the
same inputs; the ``diag_`` ones drop a part of the work and are timing
only.

Inputs: the segment sums of GCN's NA on the Reddit-like graph at scale 0.1
(23,296 nodes, 2.3M edges with the self-loops, the gather mean of the
projected ``[23296, 64]`` table), with ``--scale1`` also at scale 1.0
(232,965 nodes, 8.2M edges), and the four of HAN/imdb's ``csr`` NA (the
softmax denominators ``[E, 8]`` and the SpMMs ``[E, 64]``).  Times are
CUDA events, the median of 20 calls, cold (the 50 MB L2 flushed before
each call) and warm, by ``chip_smoke.time_ms``.  The last line is one JSON
object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

from torch_kernel_variants import build_all, variant_text

ROOT = Path(__file__).resolve().parents[1]
_P, _I = ctypes.c_void_p, ctypes.c_int

# name -> [(text in csrc/segment_sum.cu, replacement)]
VARIANTS = {
    "kept": [],
    # every segment to the warp kernel: the first design of this kernel
    "one_warp_a_segment": [("constexpr int kLong = 256;",
                            "constexpr int kLong = 1 << 30;")],
    "long128": [("constexpr int kLong = 256;", "constexpr int kLong = 128;")],
    "long1024": [("constexpr int kLong = 256;",
                  "constexpr int kLong = 1024;")],
    # the block kernel's ring: 8 KB stages, 12 of them (its first ring);
    # 16 KB stages, 12 of them (6 kept)
    "stage8k_x12": [("constexpr int kStages = 6;",
                     "constexpr int kStages = 12;"),
                    ("constexpr int kStageFloats = 4096;",
                     "constexpr int kStageFloats = 2048;")],
    "stages12": [("constexpr int kStages = 6;", "constexpr int kStages = 12;")],
    # the warp kernel with 16 rows in flight a batch (8 kept)
    "batch16": [("return NF <= 2 ? 8 : (NF == 4 ? 4 : 2);",
                 "return NF <= 2 ? 16 : (NF == 4 ? 8 : 4);")],
    # timing only: the block kernel without its sums, or without its copies
    "diag_no_sum": [("    if (t < CB && c0 + t < C) {\n      const float* st",
                     "    if (false) {\n      const float* st")],
    "diag_no_copy": [("    if (k >= n_chunks || e >= end) return;\n",
                      "    if (k >= 0) return;\n")],
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale1", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels import segment_sum as tss
    from repro_torch.launch.serve import build_hgnn_infer

    print(cs.card_line())
    libs, _ = build_all([(f"ssum_{n}", variant_text(
        build.CSRC / "segment_sum.cu", v)) for n, v in VARIANTS.items()],
        build)
    libs = {n: libs[f"ssum_{n}"] for n in VARIANTS}
    for lib in libs.values():
        lib.segment_sum_launch.argtypes = [_P] * 6 + [_I] * 4 + [_P]
        lib.segment_sum_launch.restype = _I
    dev = torch.device("cuda")
    cases = []
    inputs = [("gcn/reddit-0.1", "gcn", "reddit", 0.1),
              ("han/imdb csr", "han", "imdb", 0.1)]
    if args.scale1:
        inputs.append(("gcn/reddit-1.0", "gcn", "reddit", 1.0))
    for tag, model, dataset, scale in inputs:
        cfg = HGNNConfig(model=model, dataset=dataset)  # han: fused=False
        hg = make_dataset(dataset, scale=scale)
        b = build_hgnn_infer(cfg, hg, dev)
        with torch.inference_mode():
            h = b.executor.fp(b.params, b.batch)
        calls = cs.capture_segment_sums(lambda: b.executor.na(
            b.params, b.batch, h))
        cases += [(f"{tag} call {i}", c) for i, c in enumerate(calls)]
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {}
    with torch.inference_mode():
        for tag, (vals, seg, n, idx, mean) in cases:
            e, c = seg.shape[0], vals.shape[1]
            longs = torch.zeros(3 * (e // 2 + 1), dtype=torch.int32,
                                device=dev)  # room for any kLong >= 1
            ctr = torch.zeros(2, dtype=torch.int32, device=dev)
            want = tss.segment_sum(vals, seg, n, idx=idx, mean=mean)
            lens = torch.bincount(seg.long(), minlength=n)
            print(f"{tag}: E {e}, N {n}, C {c}, the longest segment "
                  f"{int(lens.max())}, {int((lens > tss.LONG).sum())} longer "
                  f"than {tss.LONG}")
            res[tag] = {}
            for name, lib in libs.items():
                out = torch.empty((n, c), device=dev)

                def run(lib=lib, out=out):
                    err = lib.segment_sum_launch(
                        vals.data_ptr(),
                        None if idx is None else idx.data_ptr(),
                        seg.data_ptr(), out.data_ptr(), longs.data_ptr(),
                        ctr.data_ptr(), e, n, c, int(mean), stream)
                    build.check(err, f"segment_sum variant {name}")
                    return out

                run()
                torch.cuda.synchronize()
                same = bool(torch.equal(out, want))
                if not name.startswith("diag_") and not same:
                    sys.exit(f"{tag}: variant {name} is not bitwise the "
                             "kernel")
                res[tag][name] = {"ms": cs.time_ms(run, 20, flush),
                                  "warm_ms": cs.time_ms(run, 20),
                                  "bitwise": same}
                print(f"  {name}: {res[tag][name]['ms']:.5f} ms cold, "
                      f"{res[tag][name]['warm_ms']:.5f} ms warm"
                      f"{'' if same else ' (timing only)'}", flush=True)
    print(json.dumps({"card": cs.card_line(), "variants": res}))


if __name__ == "__main__":
    main()
