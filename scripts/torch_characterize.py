#!/usr/bin/env python3
"""The paper's Fig. 2 and Fig. 3 measured on one GPU: per-stage device
time of RGCN, HAN and MAGNN on synthetic IMDB, ACM and DBLP, and its split
by kernel class.

    python3 scripts/torch_characterize.py

Each case is built at the reference benchmark's settings
(``benchmarks/hgnn_setup.py``: hidden 64, 8 heads, 8 classes,
``max_degree`` 32, ``max_instances`` 8, one layer, parameters from seed 0)
in two plans: the baseline ``fused=False`` that Fig. 2 measures (the
plain PyTorch arms; HAN's and RGCN's ``csr`` layouts) and the optimized
``fused=True, use_pallas=True`` (HAN with the fused NA→SA epilogue), and
characterized through ``HGNNInferEngine.characterize(timed=True)``
(``core/characterize.py``): each stage's ``time_us`` (CUDA events around
the replay of the stage's CUDA graph, as the reference times its jitted
stage, median of 20 calls) and ``device_us`` (the eager stage's kernels
under ``torch.profiler``) with the device time by class (DM, TB, EW, DR).

It prints, per case and plan, the FP/NA/SA shares of the device time
(the paper's Fig. 2 method) and of the stage walls, and the class shares
of each stage (Fig. 3); then the average NA share of the device time over
the nine baseline cases, beside the paper's 74%.  The card's name and
power limit (``nvidia-smi``) come first; the last line is one JSON object,
also written to ``chiprun_out/torch_characterize.json``.  It runs on a
CUDA device only and raises without one.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODELS = ("rgcn", "han", "magnn")
DATASETS = ("imdb", "acm", "dblp")
STAGES = ("FP", "NA", "SA")
CLASSES = ("DM", "TB", "EW", "DR")
PAPER_NA_SHARE = 74.0  # the paper's average NA share (Fig. 2)


def plans(model: str, dataset: str):
    """(name, HGNNConfig) of the baseline and the optimized plan."""
    from repro_torch.configs.base import HGNNConfig

    cfg = HGNNConfig(model=model, dataset=dataset, hidden=64, n_heads=8,
                     n_classes=8, max_degree=32, max_instances=8, seed=0)
    opt = cfg.replace(fused=True, use_pallas=True,
                      fuse_na_sa=model == "han")
    return [("baseline", cfg.replace(fused=False)), ("optimized", opt)]


def shares(recs: dict, key: str) -> dict:
    total = sum(recs[s][key] for s in STAGES)
    return {s: 100.0 * recs[s][key] / total for s in STAGES}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_characterize.py measures on a CUDA device "
                         "and none is available")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.launch.serve import build_hgnn_infer, stage_line
    from repro_torch.serve.engine import HGNNInferEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    out = {"card": card, "cases": {}}
    na_base = []
    for dataset in DATASETS:
        t0 = time.perf_counter()
        hg = make_dataset(dataset)
        print(f"{dataset} built in {time.perf_counter() - t0:.2f} s",
              flush=True)
        for model in MODELS:
            for plan, cfg in plans(model, dataset):
                tag = f"{model}/{dataset} {plan}"
                b = build_hgnn_infer(cfg, hg, dev)
                engine = HGNNInferEngine(b.executor, b.params, b.batch,
                                         fn=b.fn)
                recs = engine.characterize(timed=True)
                na = b.plan.na
                print(f"{tag} [na={na.kind}/{na.layout}"
                      f"{' +fused-sa' if b.plan.sa.fuse_epilogue else ''}]")
                for name, rec in recs.items():
                    print(f"  {name}: {stage_line(rec)}")
                dev_sh, wall_sh = shares(recs, "device_us"), shares(
                    recs, "time_us")
                print("  Fig. 2 device: " + ", ".join(
                    f"{s} {dev_sh[s]:.1f}%" for s in STAGES)
                    + "; stage walls: " + ", ".join(
                    f"{s} {wall_sh[s]:.1f}%" for s in STAGES), flush=True)
                fig3 = {s: {c: 100.0 * recs[s]["device_us_by_class"].get(
                    c, 0.0) / recs[s]["device_us"] for c in CLASSES}
                    for s in STAGES}
                for s in STAGES:
                    print(f"  Fig. 3 {s}: " + ", ".join(
                        f"{c} {fig3[s][c]:.1f}%" for c in CLASSES))
                if plan == "baseline":
                    na_base.append(dev_sh["NA"])
                out["cases"][tag] = {"layout": f"{na.kind}/{na.layout}",
                                     "fig2_device_pct": dev_sh,
                                     "fig2_wall_pct": wall_sh,
                                     "fig3_device_pct": fig3,
                                     "stages": recs}
                del b, engine
                torch.cuda.empty_cache()
    if na_base:
        avg = sum(na_base) / len(na_base)
        out["avg_na_share_pct"] = avg
        print(f"average NA share of the device time over the "
              f"{len(na_base)} baseline cases: {avg:.1f}% (paper: "
              f"{PAPER_NA_SHARE:.0f}%)")
    print(card)
    line = json.dumps(out)
    dest = ROOT / "chiprun_out" / "torch_characterize.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
