"""HGNN inference launcher (port of the full-graph ``--hgnn`` path of
``repro/launch/serve.py:76-120,228-274``).

  PYTHONPATH=src python -m repro_torch.launch.serve --hgnn han \\
      --dataset imdb --use-pallas --fuse-na-sa [--layers L] [--iters N]
  PYTHONPATH=src python -m repro_torch.launch.serve --hgnn rgcn \\
      --dataset imdb --use-pallas [--degree-buckets 3] [--layers L]

runs on the CUDA device; ``--device cpu`` runs on the CPU (the kernels'
plain versions).  It prints the device, then the reference's line

  han/imdb [na=gat/stacked +fused-sa] logits (4278, 8) on single-device: ... ms/iter
  rgcn/imdb [na=mean/padded] logits (4278, 8) on single-device: ... ms/iter

with the time per forward on the host clock, after one warm-up forward,
synchronised with the device.  The reference's device mesh, sampled
serving, characterization and LM serving are not ported yet.
"""
from __future__ import annotations

import argparse
import time
import warnings
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import HGNNConfig
from repro_torch.interop import DeviceLike, resolve_device


class BuiltHGNNInfer(NamedTuple):
    fn: Any  # (params, batch) -> logits
    params: Any
    batch: Any
    plan: Any = None  # the StagePlan the executor runs
    executor: Any = None  # StageGraphExecutor


def build_hgnn_infer(cfg: HGNNConfig, hg, device: DeviceLike = None,
                     gen: Optional[torch.Generator] = None) -> BuiltHGNNInfer:
    """Plan-driven HGNN inference entry point on one device (default: the
    CUDA device).  Parameters come from ``gen`` (default: a generator seeded
    with ``cfg.seed``); they are drawn on the CPU, so every device gets the
    same model."""
    from repro_torch.core.models import get_model

    dev = resolve_device(device)
    model = get_model(cfg)
    plan = model.plan()
    if cfg.fuse_na_sa and not plan.sa.fuse_epilogue:
        warnings.warn(
            f"fuse_na_sa requested but {plan.model}'s NA layout "
            f"({plan.na.layout!r}) does not support the NA→SA epilogue "
            "(stacked only); running two-pass SA", stacklevel=2)
    batch = model.prepare(hg, dev)
    if gen is None:
        gen = torch.Generator().manual_seed(cfg.seed)
    params = model.init(gen, batch)
    return BuiltHGNNInfer(model.forward, params, batch, plan, model.executor)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_hgnn(args) -> None:
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.serve.engine import HGNNInferEngine

    dev = resolve_device(args.device)
    cfg = HGNNConfig(model=args.hgnn, dataset=args.dataset, fused=True,
                     use_pallas=args.use_pallas,
                     degree_buckets=args.degree_buckets,
                     fuse_na_sa=args.fuse_na_sa, layers=args.layers)
    hg = make_dataset(args.dataset)
    built = build_hgnn_infer(cfg, hg, dev)
    engine = HGNNInferEngine(built.executor, built.params, built.batch,
                             fn=built.fn)
    logits = engine.infer()  # warm-up (builds the kernels on first use)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        logits = engine.infer()
    _sync(dev)
    dt = (time.perf_counter() - t0) / max(args.iters, 1)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "host CPU")
    print(f"device: {dev} ({name})")
    na = built.plan.na
    n_l = built.plan.n_layers
    print(f"{cfg.model}/{cfg.dataset} [na={na.kind}/{na.layout}"
          f"{' +fused-sa' if built.plan.sa.fuse_epilogue else ''}"
          f"{f' x{n_l}layers' if n_l > 1 else ''}] "
          f"logits {tuple(logits.shape)} on single-device: "
          f"{dt*1e3:.2f} ms/iter")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hgnn", required=True,
                    choices=["han", "rgcn", "magnn", "gcn"],
                    help="HGNN model (HAN and RGCN are ported; the others "
                         "raise)")
    ap.add_argument("--dataset", default="imdb",
                    choices=["imdb", "acm", "dblp", "reddit"])
    ap.add_argument("--use-pallas", action="store_true",
                    help="hand-written CUDA kernels (gat_na, "
                         "semantic_combine, segment_spmm) on the hot loop")
    ap.add_argument("--fuse-na-sa", action="store_true",
                    help="fused NA→SA epilogue: SA pass-1 scores accumulate "
                         "inside the NA kernel (stacked layout)")
    ap.add_argument("--degree-buckets", type=int, default=0,
                    help="degree-bucketed padded NA layout with that many "
                         "buckets (RGCN relations)")
    ap.add_argument("--layers", type=int, default=1,
                    help="stack that many FP->NA->SA layers")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions on the CPU)")
    run_hgnn(ap.parse_args())


if __name__ == "__main__":
    main()
