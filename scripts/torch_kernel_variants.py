#!/usr/bin/env python3
"""Design variants of the port's ``segment_spmm`` and ``cached_gather`` CUDA
kernels, timed against each other on one GPU, in one process.

    python3 scripts/torch_kernel_variants.py [--parent ROOT] [--stamps]

Each variant is this checkout's CUDA source with a few of its constants or
lines replaced (``SPMM`` and ``GATHER`` below), built on its own with
``kernels/build.py``'s flags into ``build/variants/<name>/`` and called
through its C launcher with ``ctypes``.  ``--parent ROOT`` adds another
checkout's two sources as they are (either launcher signature of
``cached_gather``: the one that takes a filled cache section is given one,
filled inside the timed call as its wrapper fills it).  Every variant's
output is held bitwise against the port's own kernel on the same inputs.

Inputs: the four relations of RGCN/imdb (layer-0 projected features as
``h_src``, the padded ``[N, 64]`` layout) and the K = 64 buckets of their
3-bucket layout; the six instance positions of a MAGNN/imdb layer with 256
hot rows a type (strided ``[4278, 16]`` index views).  Times are CUDA
events, the median of 50 calls, cold (the 50 MB L2 flushed before each
call) and warm, as ``chip_smoke.py`` times its kernels; a ``layer`` is the
launches of one layer back to back.  ``launch_only`` is the kept
``segment_spmm`` returning at once: the floor that launching and timing
one kernel sets.  ``fill_`` and ``copy_`` of one position's output (17.5
MB) are the yardstick of writing it.

``--stamps`` also runs the kept ``segment_spmm`` with ``clock64`` stamps at
its phases (thread 0 of every block) and prints each phase's median and
largest cycles over the blocks.  The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# name -> [(text in csrc/segment_spmm.cu, replacement)]
SPMM = {
    "kept": [],
    "rows32": [("constexpr int kRows = 16;", "constexpr int kRows = 32;")],
    "chunk64": [("constexpr int kChunk = 128;", "constexpr int kChunk = 64;")],
    "chunk64_stages4": [
        ("constexpr int kChunk = 128;", "constexpr int kChunk = 64;"),
        ("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
    "unroll4": [("#pragma unroll 8\n      for (int e = max(off, lo)",
                 "#pragma unroll 4\n      for (int e = max(off, lo)")],
    "launch_only": [("  extern __shared__ __align__(16) float smem[];\n",
                     "  extern __shared__ __align__(16) float smem[];\n"
                     "  if (K >= 0) return;\n")],
}
# name -> [(text in csrc/feature_cache.cu, replacement)]
GATHER = {
    "kept": [],
    "plain_stores": [("__stcs(reinterpret_cast<float4*>(out",
                      "__stwb(reinterpret_cast<float4*>(out"),
                     ("__stcs(out + ", "__stwb(out + ")],
    "unroll2": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    "unroll8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    "blocks4": [("constexpr int kBlocksPerSM = 8;",
                 "constexpr int kBlocksPerSM = 4;")],
    "no_prefetch": [
        ("    if (tile + gridDim.x < n_tiles)\n",
         "    if (false)\n"),
        ("  for (; tile < n_tiles; tile += gridDim.x) {\n",
         "  for (; tile < n_tiles; tile += gridDim.x) {\n"
         "    load_indices(idx, tile, grp, cols, stride_r, stride_c, total,"
         " i, v);\n")],
}
STAMP_NAMES = ["mask + ballot", "barrier 1", "offsets + list", "barrier 2",
               "first chunk landed", "sums", "mean + store"]
_STAMP = ("if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x < 4096) "
          "g_clk[{p}][blockIdx.x] = clock64();\n")
STAMPS = [  # the kept segment_spmm, a clock64 stamp at each phase
    ("namespace {\n", "namespace {\n__device__ long long g_clk[8][4096];\n"),
    ("  float deg = 0.f;\n", "  float deg = 0.f;\n  " + _STAMP.format(p=0)),
    ("    if (t % kLanesRow == 0) s_cnt[rr] = cnt;\n    __syncthreads();\n",
     "    if (w0 == 0) " + _STAMP.format(p=1) +
     "    if (t % kLanesRow == 0) s_cnt[rr] = cnt;\n    __syncthreads();\n"
     "    if (w0 == 0) " + _STAMP.format(p=2)),
    ("        ++at;\n      }\n    }\n    __syncthreads();\n",
     "        ++at;\n      }\n    }\n    if (w0 == 0) " + _STAMP.format(p=3) +
     "    __syncthreads();\n    if (w0 == 0) " + _STAMP.format(p=4)),
    ("      __syncthreads();  // every thread's copies of chunk ch have "
     "landed\n",
     "      __syncthreads();  // every thread's copies of chunk ch have "
     "landed\n      if (w0 == 0 && ch == 0) " + _STAMP.format(p=5)),
    ("  // 4. the mean", "  " + _STAMP.format(p=6) + "  // 4. the mean"),
    ("          if (cq + 4 * h + u < cw) o[4 * h + u] = av[u];\n      }\n"
     "    }\n  }\n",
     "          if (cq + 4 * h + u < cw) o[4 * h + u] = av[u];\n      }\n"
     "    }\n  }\n  " + _STAMP.format(p=7)),
    ("}  // namespace\n",
     "}  // namespace\nextern \"C\" int segment_spmm_stamps(long long* c) {\n"
     "  return (int)cudaMemcpyFromSymbol(c, g_clk, sizeof(g_clk));\n}\n"),
]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def build_all(jobs, build):
    """Compile ``[(name, source text)]`` in parallel; name -> CDLL."""
    nvcc = build.find_nvcc()
    procs = []
    for name, text in jobs:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        src = d / "kernel.cu"
        src.write_text(text)
        procs.append((name, src, subprocess.Popen(
            [nvcc, *build.CFLAGS, "-shared", str(src), "-o",
             str(d / "kernel.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs, ptxas = {}, {}
    for name, src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on variant {name}:\n{out}")
        ptxas[name] = [ln.strip() for ln in out.splitlines()
                       if "registers" in ln or "spill" in ln]
        libs[name] = ctypes.CDLL(str(src.with_name("kernel.so")))
    return libs, ptxas


def variant_text(path: Path, subs) -> str:
    text = path.read_text()
    for old, new in subs:
        if old not in text:
            sys.exit(f"{path.name}: variant text not found: {old!r}")
        text = text.replace(old, new)
    return text


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="ROOT")
    ap.add_argument("--stamps", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.core import metapath as mp
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels import feature_cache as tfc
    from repro_torch.kernels import segment_spmm as tspmm
    from repro_torch.launch.serve import build_hgnn_infer

    card = card_line()
    print(card)
    csrc = build.CSRC
    jobs = [("spmm " + k, variant_text(csrc / "segment_spmm.cu", v))
            for k, v in SPMM.items()]
    jobs += [("gather " + k, variant_text(csrc / "feature_cache.cu", v))
             for k, v in GATHER.items()]
    if args.stamps:
        jobs.append(("spmm stamps", variant_text(csrc / "segment_spmm.cu",
                                                 STAMPS)))
    old_gather = False
    if args.parent:
        pc = Path(args.parent).resolve() / "src/repro_torch/kernels/csrc"
        jobs.append(("spmm parent", (pc / "segment_spmm.cu").read_text()))
        text = (pc / "feature_cache.cu").read_text()
        old_gather = "int vec, void* stream" in re.sub(r"\s+", " ", text)
        jobs.append(("gather parent", text))
    libs, ptxas = build_all([(n.replace(" ", "_"), t) for n, t in jobs],
                            build)
    libs = {n: libs[n.replace(" ", "_")] for n, _ in jobs}
    ptxas = {n: ptxas[n.replace(" ", "_")] for n, _ in jobs}
    for name, lib in libs.items():
        if name.startswith("spmm"):
            lib.segment_spmm_launch.argtypes = [_P] * 4 + [_I] * 4 + [_P]
            lib.segment_spmm_launch.restype = _I
        elif name == "gather parent" and old_gather:
            lib.cached_gather_launch.argtypes = ([_P] * 4 + [_I] * 3 +
                                                 [_L] * 4 + [_I, _P])
            lib.cached_gather_launch.restype = _I
        else:
            lib.cached_gather_launch.argtypes = ([_P] * 4 + [_I] * 3 +
                                                 [_L] * 5 + [_P])
            lib.cached_gather_launch.restype = _I
    for name, lines in ptxas.items():
        print(f"  ptxas {name}: {' | '.join(lines)}")

    dev = torch.device("cuda")
    hg = make_dataset("imdb")
    rgcn = build_hgnn_infer(HGNNConfig(model="rgcn", dataset="imdb",
                                       fused=True, use_pallas=True), hg, dev)
    magnn = build_hgnn_infer(HGNNConfig(model="magnn", dataset="imdb",
                                        use_pallas=True, cache_rows=256),
                             hg, dev)
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=dev)

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def spmm_call(lib, h_src, nbr, mask):
        out = torch.empty((nbr.shape[0], h_src.shape[1]), device=dev)

        def run():
            err = lib.segment_spmm_launch(
                h_src.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                out.data_ptr(), nbr.shape[0], nbr.shape[1], h_src.shape[1],
                1, stream())
            build.check(err, "segment_spmm variant")
            return out
        return run

    def gather_call(name, table, hot, idx):
        lib = libs[name]
        (n, d), (rows, cols) = table.shape, idx.shape
        out = torch.empty((rows, cols, d), device=dev)

        def run():
            if name == "gather parent" and old_gather:
                cache = table.index_select(0, hot)  # as its wrapper fills
                err = lib.cached_gather_launch(
                    table.data_ptr(), cache.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), n, hot.shape[0], d, rows, cols,
                    *idx.stride(), 1, stream())
            else:
                err = lib.cached_gather_launch(
                    table.data_ptr(), hot.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), n, hot.shape[0], d, hot.stride(0), rows,
                    cols, *idx.stride(), stream())
            build.check(err, "cached_gather variant")
            return out
        return run

    def times(fn):
        return cs.time_ms(fn, 50, flush), cs.time_ms(fn, 50)

    res = {"card": card, "ptxas": ptxas, "segment_spmm": {},
           "cached_gather": {}, "reference": {}, "equal": {}}
    spmm_names = [n for n in libs if n.startswith("spmm")
                  and n != "spmm stamps"]
    gather_names = [n for n in libs if n.startswith("gather")]
    with torch.inference_mode():
        h = rgcn.executor.fp(rgcn.params, rgcn.batch)
        rels = [("|".join(k), h[k[0]], *rgcn.batch["rels"][k])
                for k in sorted(rgcn.batch["rels"])]
        cases = list(rels)
        for tag, h_src, nbr, mask in rels:
            bk = mp.bucket_padded(mp.PaddedSubgraph(
                nbr.cpu().numpy(), mask.cpu().numpy(), []), 3)
            cases += [(f"{tag} K=64 bucket", h_src,
                       torch.as_tensor(b_nbr, device=dev),
                       torch.as_tensor(b_mask, device=dev))
                      for b_nbr, b_mask in zip(bk.nbr, bk.mask)
                      if b_nbr.shape[1] == 64]
        for tag, h_src, nbr, mask in cases:
            want = tspmm.segment_spmm(h_src, nbr, mask)
            for name in spmm_names:
                if name == "spmm launch_only":
                    continue
                got = spmm_call(libs[name], h_src, nbr, mask)()
                res["equal"][f"{name} {tag}"] = bool(torch.equal(got, want))
            for name in spmm_names:
                cold, warm = times(spmm_call(libs[name], h_src, nbr, mask))
                res["segment_spmm"][f"{name} {tag}"] = [cold, warm]
                print(f"  {name} {tag}: {cold * 1e3:.2f} us cold, "
                      f"{warm * 1e3:.2f} us warm")
        for name in spmm_names:
            calls = [spmm_call(libs[name], *c[1:]) for c in rels]

            def layer(calls=calls):
                for fn in calls:
                    fn()
            cold, warm = times(layer)
            res["segment_spmm"][f"{name} layer"] = [cold, warm]
            print(f"  {name} layer (4 launches): {cold * 1e3:.2f} us cold, "
                  f"{warm * 1e3:.2f} us warm")

        if args.stamps:
            lib = libs["spmm stamps"]
            lib.segment_spmm_stamps.argtypes = [_P]
            lib.segment_spmm_stamps.restype = _I
            clk = (ctypes.c_longlong * (8 * 4096))()
            for tag, h_src, nbr, mask in cases:
                fn = spmm_call(lib, h_src, nbr, mask)
                fn()
                flush.sum()
                fn()
                torch.cuda.synchronize()
                build.check(lib.segment_spmm_stamps(clk), "stamps")
                blocks = -(-nbr.shape[0] // tspmm.ROWS)
                c = np.ctypeslib.as_array(clk).reshape(8, 4096)[:, :blocks]
                phase = np.diff(c.astype(np.float64), axis=0)
                # blocks with no live slot skip the ring: no chunk stamp
                live = (mask != 0).reshape(-1).cpu().numpy()
                pad = blocks * tspmm.ROWS * nbr.shape[1] - live.size
                ok = np.concatenate([live, np.zeros(pad, bool)]).reshape(
                    blocks, -1).any(axis=1)
                phase = phase[:, ok]
                total = (c[7] - c[0])[ok]
                res.setdefault("stamps", {})[tag] = {
                    "median": [float(np.median(p)) for p in phase],
                    "max": [float(p.max()) for p in phase],
                    "block_median": float(np.median(total)),
                    "block_max": float(total.max())}
                print(f"  stamps {tag} (cycles, median / max over "
                      f"{int(ok.sum())} blocks): " + ", ".join(
                          f"{nm} {np.median(p):.0f} / {p.max():.0f}"
                          for nm, p in zip(STAMP_NAMES, phase)) +
                      f"; a block {np.median(total):.0f} / {total.max():.0f}")

        hm = magnn.executor.fp(magnn.params, magnn.batch)
        hot = magnn.batch["residency"]["hot"]
        gathers = [(hm[ty], hot[ty], nodes[:, :, j])
                   for (nodes, _), types in zip(magnn.batch["instances"],
                                                magnn.plan.metapaths)
                   for j, ty in enumerate(types)]
        for g in gathers:
            want = tfc.cached_gather(*g)
            for name in gather_names:
                key = f"{name} layer"
                res["equal"][key] = res["equal"].get(key, True) and bool(
                    torch.equal(gather_call(name, *g)(), want))
        out = torch.empty((4278 * 16, 64), device=dev)
        src = torch.randn((4278 * 16, 64), device=dev)
        for name, fn in (("fill_", lambda: out.fill_(1.0)),
                         ("copy_", lambda: out.copy_(src))):
            cold, warm = times(fn)
            res["reference"][f"{name} 17.5 MB"] = [cold, warm]
            print(f"  {name} of one position's output (17.5 MB): "
                  f"{cold * 1e3:.2f} us cold, {warm * 1e3:.2f} us warm")
        for name in gather_names:
            calls = [gather_call(name, *g) for g in gathers]

            def layer(calls=calls):
                for fn in calls:
                    fn()
            cold, warm = times(layer)
            one = cs.time_ms(calls[0], 50, flush)
            res["cached_gather"][f"{name} layer"] = [cold, warm]
            res["cached_gather"][f"{name} one position"] = [one, None]
            print(f"  {name} layer (6 launches): {cold * 1e3:.2f} us cold, "
                  f"{warm * 1e3:.2f} us warm; one position "
                  f"{one * 1e3:.2f} us cold")
    bad = sorted(k for k, v in res["equal"].items() if not v)
    print(f"  variants bitwise equal to the port's kernels: "
          f"{'all' if not bad else 'not ' + ', '.join(bad)}")
    print(card)
    print(json.dumps(res))
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
