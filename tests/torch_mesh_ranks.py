"""Run the port's mesh paths on two gloo ranks of the CPU (the helper of
``tests/test_torch_mesh_gloo.py``; not a test module, and it imports no
jax).

  python tests/torch_mesh_ranks.py WORKDIR

``WORKDIR/inputs.pt`` (``torch.save``; the ranks start before it is
there and wait for it, so it must appear whole, by a rename) holds the HAN configs, graph and
metapaths and the HAN and granite parameters (as ``interop.params_from_numpy`` makes
them) and the prompt.  Two processes join a gloo group through a
``FileStore`` in WORKDIR; each runs:

* HAN full-graph inference on a ``(data=2, model=1)`` mesh
  (``launch/serve.build_hgnn_infer(mesh=...)`` with the given weights);
* the prefill of ``configs/registry.get_reduced("granite-8b")`` on a
  ``(data=1, model=2)`` mesh (``launch/steps.build_prefill_step`` through
  ``jit_step``), and one decode step after it;
* one train step (``launch/steps.build_train_step``) of each config in
  ``inputs["train"]`` on the mesh it names, from the given state.

Rank 0 writes the gathered logits, losses and states to
``WORKDIR/outputs.pt``.
"""
from __future__ import annotations

import os
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
INPUTS_TIMEOUT_S = 120


def _rank(rank: int, workdir: str) -> None:
    from repro_torch import tree
    from repro_torch.configs.base import HGNNConfig, ShapeConfig
    from repro_torch.configs.registry import get_reduced
    from repro_torch.data import synthetic as syn
    from repro_torch.dist.sharding import distribute_tree
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.serve import build_hgnn_infer, hgnn_shardings
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step,
                                          build_train_step, jit_step)
    from repro_torch.nn.transformer import graft_prefill_caches

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    try:
        path = os.path.join(workdir, "inputs.pt")
        deadline = time.monotonic() + INPUTS_TIMEOUT_S
        while not os.path.exists(path):  # written while the ranks start
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {path} after {INPUTS_TIMEOUT_S} s")
            time.sleep(0.05)
        inp = torch.load(path, weights_only=False)
        out = {}
        for name, paths in inp["metapaths"].items():
            syn.DATASET_METAPATHS[name] = paths
            syn.DATASET_TARGET[name] = inp["targets"][name]
        # HAN on (data=2, model=1): the rows over the ranks
        mesh = make_smoke_mesh(data=2, model=1)
        for name, kw in inp["han_cfgs"].items():
            cfg = HGNNConfig(**kw)
            built = build_hgnn_infer(cfg, inp["hg"], "cpu", mesh=mesh)
            p_sh, _ = hgnn_shardings(built.plan, inp["han_params"],
                                     built.batch, mesh)
            params = distribute_tree(inp["han_params"], p_sh)
            with torch.inference_mode():
                logits = built.fn(params, built.batch)
            out[name] = logits.full_tensor()
        dist.barrier()
        # granite reduced on (data=1, model=2): heads, vocab and the
        # decode cache's sequence over the ranks
        mesh = make_smoke_mesh(data=1, model=2)
        cfg = get_reduced("granite-8b")
        tokens = inp["tokens"]
        b, s = tokens.shape
        pre = build_prefill_step(cfg, ShapeConfig("p", s, b, "prefill"),
                                 mesh)
        with torch.inference_mode():
            logits, caches = jit_step(pre)(inp["lm_params"],
                                           {"tokens": tokens})
        out["granite_prefill"] = logits.full_tensor()
        dec = build_decode_step(cfg, ShapeConfig("d", s + 8, b, "decode"),
                                mesh)
        from repro_torch.nn.transformer import init_kv_caches

        skel = init_kv_caches(cfg, b, s + 8, device="cpu")
        full = tree.map(lambda c: c.full_tensor(), caches)
        grafted = graft_prefill_caches(cfg, skel, full, s)
        nxt = out["granite_prefill"][:, -1].argmax(-1)[:, None].int()
        with torch.inference_mode():
            logits, _ = jit_step(dec)(inp["lm_params"], nxt, grafted,
                                      torch.tensor(s, dtype=torch.int32))
        out["granite_decode"] = logits.full_tensor()
        out["granite_next"] = nxt
        for name, case in inp["train"].items():
            mesh = make_smoke_mesh(*case["mesh"])
            cfg = get_reduced(case["arch"])
            b, s = case["batch"]["tokens"].shape
            built = build_train_step(cfg, ShapeConfig("t", s, b, "train"),
                                     mesh)
            state, metrics = jit_step(built)(case["state"], case["batch"])
            out[name] = {"state": tree.map(lambda t: t.full_tensor(), state),
                         "loss": metrics["loss"].full_tensor(),
                         "grad_norm": metrics["grad_norm"].full_tensor()}
        if rank == 0:
            torch.save(out, os.path.join(workdir, "outputs.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> None:
    mp.spawn(_rank, args=(sys.argv[1],), nprocs=2, join=True)


if __name__ == "__main__":
    main()
