"""Run every padded HGNN plan of the port and an LM decode step under the
decode kernel's log-sum-exp form on two gloo ranks of the CPU (the helper
of ``tests/test_torch_mesh_plans_gloo.py`` and of
``tests/test_torch_mesh_plans_gpu.py``; not a test module, and it imports
no jax).

  python tests/torch_mesh_plans_ranks.py WORKDIR

``WORKDIR/inputs.pt`` (``torch.save``; the ranks start before it is there
and wait for it, so it must appear whole, by a rename) holds the tiny
graph, its metapaths and target, and

* ``hgnn``: name -> ``{"cfg": HGNNConfig kwargs, "mesh": (data, model),
  "halo": None | "auto" | "xla", "params": the weights or None}``; each
  case runs through ``launch/serve.build_hgnn_infer(mesh=...)`` with the
  given weights (None: the build's own, drawn from ``cfg.seed``), the
  plan's ``PartitionSpec.halo`` set to ``halo`` where given;
* ``lm``: ``{"arch", "params", "tokens", "mesh"}``: the reduced config's
  prefill off the mesh, then one decode step under ``use_pallas`` on the
  mesh (``launch/steps.build_decode_step``), the cache's sequence over
  ``'model'``;
* ``plain``: True to run each case off the mesh too, on rank 0.

Two processes join a gloo group through a ``FileStore`` in WORKDIR.  Rank
0 writes ``WORKDIR/outputs.pt``: each case's gathered logits, the c10d
collectives each ``halo_exchange`` call issued (``CommDebugMode``, by op
name, beside the number of node types exchanged), the log-sum-exp
form's calls in the decode step (the cache shard of each), and with
``plain`` the mesh-less results.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
INPUTS_TIMEOUT_S = 120
# the cases of the two-rank tests: name -> (HGNNConfig kwargs, (data,
# model), halo mode or None), at the tiny graph's size
SMALL = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             attn_hidden=8, max_degree=16)
UNPARTITIONED = {
    "han_bucketed": (dict(model="han", fused=True, degree_buckets=3), (2, 1)),
    "han_layers2": (dict(model="han", fused=True, layers=2), (2, 1)),
    "rgcn_padded": (dict(model="rgcn", fused=True), (2, 1)),
    "rgcn_bucketed": (dict(model="rgcn", fused=True, degree_buckets=3),
                      (2, 1)),
    "magnn": (dict(model="magnn"), (2, 1)),
    "magnn_cached": (dict(model="magnn", cache_rows=8), (2, 1)),
    "rgcn_padded_model2": (dict(model="rgcn", fused=True), (1, 2)),
}
PARTITIONED = {
    "han_k4": dict(model="han", fused=True, partitions=4),
    "rgcn_k4": dict(model="rgcn", fused=True, partitions=4),
    "magnn_k4": dict(model="magnn", partitions=4),
    "han_k4_layers2": dict(model="han", fused=True, partitions=4, layers=2),
    "rgcn_k4_layers2": dict(model="rgcn", fused=True, partitions=4,
                            layers=2),
    # the hot-halo overlay names the rows halo_src names, in either mode
    "han_k4_cached": dict(model="han", fused=True, partitions=4,
                          cache_rows=8),
}
CASES = {f"{name}/{arm}": (dict(SMALL, **kw, use_pallas=arm == "kernel"),
                           mesh, None)
         for name, (kw, mesh) in UNPARTITIONED.items()
         for arm in ("plain", "kernel")}
CASES.update({f"{name}/{halo}": (dict(SMALL, **kw, use_pallas=True), (2, 1),
                                 halo)
              for name, kw in PARTITIONED.items() for halo in ("auto", "xla")})


def _wait_for(path: str) -> None:
    deadline = time.monotonic() + INPUTS_TIMEOUT_S
    while not os.path.exists(path):  # written while the ranks start
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {INPUTS_TIMEOUT_S} s")
        time.sleep(0.05)


def _count_halo_collectives(executor, calls: list) -> None:
    """Record the collectives of each ``halo_exchange`` call."""
    from torch.distributed.tensor.debug import CommDebugMode

    exchange = executor.halo_exchange

    def counted(batch, h_own):
        comm = CommDebugMode()
        with comm:
            out = exchange(batch, h_own)
        calls.append({"types": len(h_own), **{
            str(k).split(".")[-1]: v
            for k, v in comm.get_comm_counts().items()}})
        return out

    executor.halo_exchange = counted


def _hgnn(inp, out: dict, plain: dict) -> None:
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.dist.sharding import distribute_tree
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.serve import build_hgnn_infer, hgnn_shardings

    out["hgnn"], out["halo_comm"] = {}, {}
    for name, case in inp["hgnn"].items():
        cfg = HGNNConfig(**case["cfg"])
        mesh = make_smoke_mesh(*case["mesh"])
        built = build_hgnn_infer(cfg, inp["hg"], "cpu", mesh=mesh)
        if case.get("halo") is not None:
            pl = built.executor.plan
            built.executor.plan = dataclasses.replace(
                pl, partition=dataclasses.replace(pl.partition,
                                                  halo=case["halo"]))
        params = built.params
        if case.get("params") is not None:
            p_sh, _ = hgnn_shardings(built.plan, case["params"], built.batch,
                                     mesh)
            params = distribute_tree(case["params"], p_sh)
        calls: list = []
        _count_halo_collectives(built.executor, calls)
        with torch.inference_mode():
            logits = built.fn(params, built.batch)
        out["hgnn"][name] = logits.full_tensor()
        out["halo_comm"][name] = calls
        if inp.get("plain") and dist.get_rank() == 0:
            ref = build_hgnn_infer(cfg, inp["hg"], "cpu")
            with torch.inference_mode():
                plain[name] = ref.fn(case.get("params") or ref.params,
                                     ref.batch)
        dist.barrier()


def _lm(inp, out: dict, plain: dict) -> None:
    from repro_torch import tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_decode_step, jit_step
    from repro_torch.nn import transformer as tf

    lm = inp["lm"]
    cfg = get_reduced(lm["arch"]).replace(use_pallas=True)
    tokens, params = lm["tokens"], lm["params"]
    b, s = tokens.shape
    with torch.inference_mode():
        logits, caches = tf.lm_prefill(params, cfg, tokens)
    nxt = logits[:, -1].argmax(-1)[:, None].int()
    grafted = tf.graft_prefill_caches(
        cfg, tf.init_kv_caches(cfg, b, s + 8, device="cpu"), caches, s)
    pos = torch.tensor(s, dtype=torch.int32)
    lse_calls = []
    decode_attention = ops.decode_attention

    def counted(*a, **kw):
        if kw.get("return_lse") and kw.get("use_pallas"):
            lse_calls.append(tuple(a[1].shape))
        return decode_attention(*a, **kw)

    ops.decode_attention = counted
    try:
        mesh = make_smoke_mesh(*lm["mesh"])
        dec = build_decode_step(cfg, ShapeConfig("d", s + 8, b, "decode"),
                                mesh)
        with torch.inference_mode():
            got, _ = jit_step(dec)(params, nxt, tree.map(
                lambda c: c.clone(), grafted), pos)
    finally:
        ops.decode_attention = decode_attention
    out["granite_decode"] = got.full_tensor()
    out["granite_next"] = nxt
    out["lse_calls"] = lse_calls
    if inp.get("plain") and dist.get_rank() == 0:
        with torch.inference_mode():
            plain["granite_decode"], _ = tf.lm_decode_step(
                params, cfg, nxt, grafted, pos)


def _rank(rank: int, workdir: str) -> None:
    from repro_torch.data import synthetic as syn

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    try:
        path = os.path.join(workdir, "inputs.pt")
        _wait_for(path)
        inp = torch.load(path, weights_only=False)
        for name, paths in inp["metapaths"].items():
            syn.DATASET_METAPATHS[name] = paths
            syn.DATASET_TARGET[name] = inp["targets"][name]
        out, plain = {}, {}
        _hgnn(inp, out, plain)
        if "lm" in inp:
            _lm(inp, out, plain)
        if rank == 0:
            out["plain"] = plain
            torch.save(out, os.path.join(workdir, "outputs.pt.part"))
            os.replace(os.path.join(workdir, "outputs.pt.part"),
                       os.path.join(workdir, "outputs.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> None:
    mp.spawn(_rank, args=(sys.argv[1],), nprocs=2, join=True)


if __name__ == "__main__":
    main()
