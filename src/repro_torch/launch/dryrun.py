"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): lay every (arch x
shape) cell out on the production meshes and record one rank's work.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      [--shape train_4k] [--multi-pod | --both-meshes] [--out DIR] \\
      [--override '{"remat": "none"}'] [--tag T]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

For each mesh the process joins a default process group of the
``"fake"`` backend with as many ranks as the mesh (256 or 512) and acts as
rank 0.  Each cell's step (``launch/steps.build_step``) runs on meta
tensors: its weights, inputs and state are DTensors laid out by the
step's shardings over ``launch/mesh.make_production_mesh``, DTensor
computes each op's local shapes and issues its collectives to the fake
group (which moves no data), and ``core/characterize.analyze_step``
counts what rank 0 does.  Nothing is allocated on a device and no GPU is
needed.  The fake group lives in ``torch.testing._internal.distributed.
fake_pg``, a private module of PyTorch; this is the one module that
imports it.

One JSON a cell in ``--out`` (``<arch>__<shape>__<mesh>[__tag].json``)
with the per-device record (FLOPs, HBM and collective bytes by class,
``argument_bytes`` / ``output_bytes``), the H100 roofline, the parameter
counts and the model FLOPs; a cell already written is skipped (unless
``--override``).  The ``long_500k`` cells of archs with full attention
are skipped, as in the reference.  A line a cell:

  OK granite-8b__train_4k__16x16: args=... GiB flops=... coll_bytes=... bound=...
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch.distributed as dist

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, \
    long_context_supported
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch.mesh import make_production_mesh


def _join_fake_group(world_size: int) -> None:
    """Be rank 0 of a fake process group of ``world_size`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", world_size=world_size, rank=0,
                            store=FakeStore())


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(cfg: ModelConfig, shape: ShapeConfig, multi_pod: bool,
             overrides=None) -> dict:
    from repro_torch.core.characterize import analyze_step
    from repro_torch.launch.steps import build_step

    _join_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    if overrides:
        cfg = cfg.replace(**overrides)
    t0 = time.time()
    built = build_step(cfg, shape, mesh)
    t_build = time.time() - t0
    t0 = time.time()
    report = analyze_step(built, cfg=cfg, shape=shape, mesh=mesh)
    t_run = time.time() - t0
    dev = report["per_device"]
    report.update({
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh_name(multi_pod),
        "n_chips": mesh.size,
        "build_s": round(t_build, 2),
        "run_s": round(t_run, 2),
        "memory": {
            "argument_bytes": dev["argument_bytes"],
            "output_bytes": dev["output_bytes"],
            "argument_gib": round(dev["argument_bytes"] / 2 ** 30, 3),
        },
    })
    return report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    overrides = json.loads(args.override) if args.override else None

    failures = 0
    try:
        for arch in archs:
            cfg = get_config(arch)
            for shape_name in shapes:
                shape = SHAPES[shape_name]
                if (shape.name == "long_500k"
                        and not long_context_supported(cfg)):
                    print(f"SKIP {arch} x {shape_name}: full attention at "
                          "500k")
                    continue
                for mp in meshes:
                    tag = f"{arch}__{shape_name}__{mesh_name(mp)}"
                    if args.tag:
                        tag += f"__{args.tag}"
                    path = os.path.join(args.out, tag + ".json")
                    if os.path.exists(path) and overrides is None:
                        print(f"CACHED {tag}")
                        continue
                    print(f"RUN {tag} ...", flush=True)
                    try:
                        rep = run_cell(cfg, shape, mp, overrides)
                        with open(path, "w") as f:
                            json.dump(rep, f, indent=1)
                        dev = rep["per_device"]
                        print(f"OK  {tag}: "
                              f"args={rep['memory']['argument_gib']}GiB "
                              f"flops={dev['total_flops']:.4g} "
                              f"coll_bytes={dev['collective_bytes']:.4g} "
                              f"bound={rep['roofline']['bound']} "
                              f"run={rep['run_s']}s", flush=True)
                    except Exception:
                        failures += 1
                        print(f"FAIL {tag}\n{traceback.format_exc()}",
                              flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{failures} cells failed")
    print("dry-run complete")


if __name__ == "__main__":
    main()
