"""Serving launcher (port of ``repro/launch/serve.py``: the LM branch of
``main``, ``:309-418``, and the full-graph ``--hgnn`` path, ``:76-120,
228-274``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --reduced [--requests N] [--prompt-len T] [--max-tokens M] \
      [--temperature X] [--slots B] [--use-pallas]

  PYTHONPATH=src python -m repro_torch.launch.serve --hgnn han \\
      --dataset imdb --use-pallas --fuse-na-sa [--layers L] [--iters N]
  PYTHONPATH=src python -m repro_torch.launch.serve --hgnn rgcn \\
      --dataset imdb --use-pallas [--degree-buckets 3] [--layers L]
  PYTHONPATH=src python -m repro_torch.launch.serve --hgnn magnn \\
      --dataset imdb --use-pallas [--cache-rows 256] [--layers L]

runs on the CUDA device; ``--device cpu`` runs on the CPU (the kernels'
plain versions).  Without ``--hgnn`` it serves the dense LM ``--arch`` (full
size, or ``--reduced``) through ``ServeEngine`` with random weights from
seed 0, and prints the reference's ``reqN: [...]`` lines and ``N tokens in
Xs (Y tok/s)``.  ``--use-pallas`` sets ``ModelConfig.use_pallas`` there:
prefill through the ``flash_attention`` kernel and decode through
``decode_attention`` (the reference's flag reaches only its HGNN branch).
The encdec family exits as the reference does; the other non-dense
families raise ``NotImplementedError``.

With ``--hgnn``, ``--cache-rows C`` turns on hot-feature residency for
any of the three models.  It prints the device, then the reference's line

  han/imdb [na=gat/stacked +fused-sa] logits (4278, 8) on single-device: ... ms/iter
  rgcn/imdb [na=mean/padded] logits (4278, 8) on single-device: ... ms/iter
  magnn/imdb [na=instance/instances] logits (4278, 8) on single-device: ... ms/iter

with the time per forward on the host clock, after one warm-up forward,
synchronised with the device, and with residency the reference's counters

  residency: cache_rows=... hits=... misses=... rows=... hit_rate=...

The reference's device mesh, graph partitioning, sampled serving, the
overlap schedule and characterization are not ported yet.
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
                     fuse_na_sa=args.fuse_na_sa, layers=args.layers,
                     cache_rows=args.cache_rows)
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
    res = built.batch.get("residency")
    if res is not None:
        ct = res["counters"]
        print(f"  residency: cache_rows={ct['cache_rows']} "
              f"hits={ct['hits']} misses={ct['misses']} rows={ct['rows']} "
              f"hit_rate={ct['hits'] / max(ct['rows'], 1):.3f}")


def run_lm(args) -> None:
    import numpy as np

    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.nn.transformer import init_lm_params
    from repro_torch.serve.engine import Request, ServeEngine

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family == "encdec":
        raise SystemExit("serve launcher covers decoder-only archs; "
                         "see examples/serve_decode.py for enc-dec")
    if args.use_pallas:
        cfg = cfg.replace(use_pallas=True)
    params = init_lm_params(torch.Generator(device=dev).manual_seed(0), cfg)
    engine = ServeEngine(cfg, params, batch_slots=args.slots,
                         max_len=args.prompt_len + args.max_tokens)
    rng = np.random.default_rng(0)
    reqs = [
        Request(prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(
            np.int32), max_tokens=args.max_tokens,
            temperature=args.temperature)
        for _ in range(args.requests)
    ]
    t0 = time.time()
    done = engine.generate(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(r.out_tokens) for r in done)
    for i, r in enumerate(done):
        print(f"req{i}: {r.out_tokens}")
    print(f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/max(dt,1e-9):.1f} tok/s)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--hgnn", default=None,
                    choices=["han", "rgcn", "magnn", "gcn"],
                    help="serve an HGNN model instead of an LM (HAN, RGCN "
                         "and MAGNN are ported; GCN raises)")
    ap.add_argument("--dataset", default="imdb",
                    choices=["imdb", "acm", "dblp", "reddit"])
    ap.add_argument("--use-pallas", action="store_true",
                    help="hand-written CUDA kernels on the hot loop (HGNN: "
                         "gat_na, semantic_combine, segment_spmm, "
                         "cached_gather; LM: flash_attention, "
                         "decode_attention)")
    ap.add_argument("--fuse-na-sa", action="store_true",
                    help="fused NA→SA epilogue: SA pass-1 scores accumulate "
                         "inside the NA kernel (stacked layout)")
    ap.add_argument("--degree-buckets", type=int, default=0,
                    help="degree-bucketed padded NA layout with that many "
                         "buckets (RGCN relations)")
    ap.add_argument("--cache-rows", type=int, default=0,
                    help="hot-feature residency: keep that many hot rows per "
                         "node type in a cache section of the gather pool")
    ap.add_argument("--layers", type=int, default=1,
                    help="stack that many FP->NA->SA layers")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions on the CPU)")
    args = ap.parse_args()
    if args.hgnn:
        run_hgnn(args)
        return
    run_lm(args)


if __name__ == "__main__":
    main()
