"""Training launcher (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --reduced --steps 50 --ckpt-dir /tmp/ckpt [--device cpu]

The reference's flags, plus ``--device``: the run is on the CUDA device
unless ``--device cpu`` asks for the CPU (there is no silent fallback).
The weights are drawn from seed 0 on the device (``init_lm_params``, or
``init_encdec_params`` for seamless; the reference's come from
``jax.random``, so the two runs start from other weights).  The loader's
batches carry internvl2's ``extra_embeds`` and seamless's ``frames``.  One line names the device, then one line a step, as the
reference prints it; the host reads the loss back once a step.

On the card the step is compiled with the state donated, as the
reference's ``jax.jit(step_fn, donate_argnums=(0,))``: the first step
warms up and captures a CUDA graph (``graphs.compiled(step_fn,
donate=(0,))``), every later one replays it.  Each step writes the new
state into the tensors of the state it was given and returns them, so
the loop passes the same tensors every step; the loader's numpy batch
goes to the step as it is and is uploaded through the graph's pinned
staging.  A checkpoint's ``submit`` copies the state to the host before
it returns, before the next step overwrites it.  ``--resume`` restores
the state before the first step, so the graph is captured on the
restored tensors.  Off the card the step runs eagerly on tensors.

On a cluster: one process a device, ``--distributed`` (the reference's
``jax.distributed.initialize()``), started by ``torchrun``:

  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
      --distributed --arch smollm-360m

joins the default process group (``init_process_group()`` with torch's
``env://`` defaults, unless the caller has joined one: NCCL on the card,
gloo with ``--device cpu``) and runs on ``cuda:LOCAL_RANK``.  Then comes
the same loop: as in the reference, the launcher builds no mesh, and each
process runs its own step on its device.  Only rank 0 writes checkpoints
(each reference process writes the same ``shard_00000``: ROADMAP Queue 3
check (k)); every rank reads one on ``--resume``.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, NamedTuple

import torch

from repro_torch import graphs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.data.loader import PrefetchLoader
from repro_torch.interop import DeviceLike, resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import StepTimer
from repro_torch.train.optimizer import Optimizer, build_optimizer
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step)


class TrainRun(NamedTuple):
    """What the launcher trains: the config, the batch shape, the
    optimizer, the step function (on the card ``graphs.compiled`` with the
    state donated; ``step_fn.fn`` is the eager step) and the initial
    state."""
    cfg: ModelConfig
    shape: ShapeConfig
    optimizer: Optimizer
    step_fn: Callable
    state: TrainState


def setup(cfg: ModelConfig, steps: int, seq_len: int, batch: int,
          microbatches: int = 1, device: DeviceLike = None) -> TrainRun:
    """The launcher's model, optimizer (``build_optimizer`` over
    ``max(steps, 10)`` steps), step and state at step 0 on ``device``.  On
    the card the step is ``graphs.compiled(step_fn, donate=(0,))`` (the
    module docstring); on the CPU it is ``step_fn`` itself."""
    dev = resolve_device(device)
    shape = ShapeConfig("custom", seq_len, batch, "train")
    opt = build_optimizer(cfg, total_steps=max(steps, 10))
    step_fn = make_train_step(cfg, opt, n_microbatches=microbatches)
    if dev.type == "cuda":
        step_fn = graphs.compiled(step_fn, donate=(0,))
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg,
                             opt)
    return TrainRun(cfg, shape, opt, step_fn, state)


def to_device(batch, device: torch.device):
    """A loader batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-runnable reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--distributed", action="store_true",
                    help="join the default process group (torchrun's "
                         "env://): one process a device")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; default: the CUDA device")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    joined, rank = False, 0
    if args.distributed:
        import torch.distributed as dist

        if not dist.is_initialized():
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
            joined = True
        rank = dist.get_rank()
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
    try:
        _train(args, dev, rank)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, dev: torch.device, rank: int) -> None:
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "host CPU")
    print(f"device: {dev.type} ({name})", flush=True)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    run = setup(cfg, args.steps, args.seq_len, args.batch, args.microbatches,
                dev)
    state = run.state
    start = 0
    if (args.resume and args.ckpt_dir
            and ckpt.latest_step(args.ckpt_dir) is not None):
        state = ckpt.restore(args.ckpt_dir, state, device=dev)
        start = int(state.step)
        print(f"resumed from step {start}")

    saver = (ckpt.AsyncCheckpointer(args.ckpt_dir)
             if args.ckpt_dir and rank == 0 else None)
    timer = StepTimer()
    loader = PrefetchLoader(cfg, run.shape, start_step=start)
    try:
        for i in range(start, start + args.steps):
            batch = next(loader)
            if dev.type != "cuda":  # the compiled step uploads numpy
                batch = to_device(batch, dev)
            t0 = time.time()
            state, metrics = run.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            straggler = timer.observe(dt)
            print(f"step {i:5d} loss {loss:8.4f} gnorm "
                  f"{float(metrics['grad_norm']):7.3f} {dt*1e3:7.1f} ms"
                  + ("  [straggler]" if straggler else ""), flush=True)
            if saver and (i + 1) % args.ckpt_every == 0:
                saver.submit(state, i + 1)
        if saver:
            saver.submit(state, start + args.steps)
    finally:
        loader.close()
        if saver:
            saver.close()


if __name__ == "__main__":
    main()
