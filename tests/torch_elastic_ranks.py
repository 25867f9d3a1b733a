"""Elastic restart on four gloo ranks of the CPU (the helper of
``tests/test_torch_elastic_gloo.py`` and ``tests/test_torch_elastic_gpu.
py``; not a test module, and it imports no jax).

  python tests/torch_elastic_ranks.py WORKDIR

``WORKDIR/inputs.pt`` (``torch.save``; the ranks start before it is there
and wait for it, so it must appear whole, by a rename) holds the tiny
graph, its metapaths and target, and

* ``serve``: ``{"cfg": HGNNConfig kwargs, "params": the HAN weights,
  "requests": the targets of each request}``.  For each arm of ``ARMS``
  and each case of ``POD_CASES`` every rank serves the requests with the
  weights replicated on a ``(pod, data, model)`` mesh of the four ranks
  (the never-failed run); every rank enters ``surviving_mesh``; the
  survivors lay the weights out replicated on its mesh (``reshard_state``)
  and serve again, then once more losing a partition at step 2;
* ``restore``: ``{"arch", "state", "batch"}``: the reduced config's state
  laid out on ``(data=2, model=2)`` by ``state_shardings``, saved by
  ``checkpoint.save`` and by ``AsyncCheckpointer`` from every rank,
  restored onto ``(data=1, model=2)`` over ranks 2 and 3 with
  ``restore(shardings=)``, and trained one step there
  (``launch/steps.build_train_step``);
* ``launch``: the arguments of ``launch/train.py``, run with
  ``--distributed --device cpu`` on ranks 0 and 1 of a new two-rank group
  (the four-rank group left first), each rank's ``checkpoint.save`` calls
  recorded.

The ranks meet through ``FileStore``s in WORKDIR.  Each rank writes
``WORKDIR/outputs_<rank>.pt``: its mesh coordinates, the logits it served,
the restored and trained state gathered whole, its launcher lines.
"""
from __future__ import annotations

import contextlib
import io
import os
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
INPUTS_TIMEOUT_S = 120
WORLD = 4
ARMS = {"plain": False, "kernel": True}  # use_pallas
# name -> ((pod, data, model), failed pods): the reference's two pod-loss
# tests (tests/test_elastic_hgnn.py) on four ranks, and a loss that leaves
# three pods (the 'pod' axis kept)
POD_CASES = {"pod_loss": ((2, 2, 1), [0]),
             "collapse": ((4, 1, 1), [0, 1, 3]),
             "three_pods_left": ((4, 1, 1), [1])}
RESTORE_BIG, RESTORE_SMALL = (2, 2), [[2, 3]]  # (data, model) rank grids
PARTITION_FAULT = dict(step=2, kind="partition", partition=1)


def _wait_for(path: str) -> None:
    deadline = time.monotonic() + INPUTS_TIMEOUT_S
    while not os.path.exists(path):  # written while the ranks start
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {INPUTS_TIMEOUT_S} s")
        time.sleep(0.05)


def _mesh(ranks, names):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import Mesh

    return Mesh.from_device_mesh(DeviceMesh("cpu", torch.tensor(ranks),
                                            mesh_dim_names=names))


def _replicated(params, mesh):
    from repro_torch import tree
    from repro_torch.dist.sharding import NamedSharding, P

    return tree.map(lambda _: NamedSharding(mesh, P()), params)


def _serve(cfg, hg, params, requests, fault=None):
    from repro_torch.core.models import get_model
    from repro_torch.serve.engine import HGNNRequest, HGNNServeEngine
    from repro_torch.serve.faults import Fault, FaultInjector
    from repro_torch.serve.sampler import HGNNSampler

    m = get_model(cfg)
    eng = HGNNServeEngine(m.executor, params, HGNNSampler(m.plan(), cfg, hg),
                          slots=2, slot_targets=2,
                          injector=FaultInjector([Fault(**fault)])
                          if fault else None)
    eng.warmup()
    reqs = [HGNNRequest(targets=t) for t in requests]
    eng.serve(reqs)
    assert all(r.status == "OK" for r in reqs), [r.status for r in reqs]
    return {"logits": [torch.from_numpy(r.logits) for r in reqs],
            "device": str(eng.device),
            "failovers": eng.stats()["resilience"]["partition_failovers"]}


def _pod_loss(rank: int, inp, out: dict) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.dist.sharding import Mesh
    from repro_torch.train.elastic import reshard_state, surviving_mesh

    srv = inp["serve"]
    out["serve"] = {}
    for arm, use_pallas in ARMS.items():
        cfg = HGNNConfig(**srv["cfg"], use_pallas=use_pallas)
        for case, (shape, failed) in POD_CASES.items():
            mesh = Mesh.from_device_mesh(init_device_mesh(
                "cpu", shape, mesh_dim_names=("pod", "data", "model")))
            p_full = reshard_state(srv["params"],
                                   _replicated(srv["params"], mesh))
            rec = {"never_failed": _serve(cfg, inp["hg"], p_full,
                                          srv["requests"])}
            m2 = surviving_mesh(mesh, failed_pods=failed)
            rec["axis_names"] = m2.axis_names
            rec["shape"] = tuple(m2.shape.values())
            rec["ranks"] = m2.device_mesh.mesh.tolist()
            rec["coordinate"] = m2.device_mesh.get_coordinate()
            if rec["coordinate"] is not None:  # a survivor
                p_surv = reshard_state(p_full,
                                       _replicated(srv["params"], m2))
                rec["on_survivors"] = all(
                    x.device_mesh == m2.device_mesh
                    for x in tree.leaves(p_surv) if torch.is_tensor(x))
                rec["survivors"] = _serve(cfg, inp["hg"], p_surv,
                                          srv["requests"])
                rec["failover"] = _serve(cfg, inp["hg"], p_surv,
                                         srv["requests"], PARTITION_FAULT)
                rec["leaves_equal"] = all(
                    torch.equal(a.to_local(), b.to_local())
                    for a, b in zip(tree.leaves(p_full),
                                    tree.leaves(p_surv))
                    if torch.is_tensor(a))
            out["serve"][f"{case}/{arm}"] = rec
            dist.barrier()


def _restore(rank: int, inp, out: dict, workdir: str) -> None:
    from repro_torch import tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_reduced
    from repro_torch.launch.steps import build_train_step, jit_step
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import reshard_state
    from repro_torch.train.optimizer import build_optimizer
    from repro_torch.train.train_step import state_shardings

    case = inp["restore"]
    cfg = get_reduced(case["arch"])
    opt = build_optimizer(cfg)
    state = case["state"]
    big = _mesh(torch.arange(WORLD).reshape(RESTORE_BIG).tolist(),
                ("data", "model"))
    laid = reshard_state(state, state_shardings(state, opt, big))
    out["sharded_leaves"] = sum(
        any(p.is_shard() for p in x.placements) for x in tree.leaves(laid))
    ckpt.save(laid, os.path.join(workdir, "ck_sync"), step=3)
    saver = ckpt.AsyncCheckpointer(os.path.join(workdir, "ck_async"))
    saver.submit(laid, 3)
    saver.close()
    dist.barrier()  # the writer has published both
    small = _mesh(RESTORE_SMALL, ("data", "model"))
    if small.device_mesh.get_coordinate() is None:
        return
    sh = state_shardings(state, opt, small)
    restored = ckpt.restore(os.path.join(workdir, "ck_sync"), state,
                            shardings=sh)
    out["restored"] = tree.map(lambda t: t.full_tensor(), restored)
    out["restored_placements_ok"] = all(
        tuple(a.placements) == tuple(s.placements())
        and a.device_mesh == small.device_mesh
        for a, s in zip(tree.leaves(restored), tree.leaves(sh)))
    b, s = case["batch"]["tokens"].shape
    built = build_train_step(cfg, ShapeConfig("t", s, b, "train"), small)
    new, metrics = jit_step(built)(restored, case["batch"])
    out["trained"] = {"state": tree.map(lambda t: t.full_tensor(), new),
                      "loss": metrics["loss"].full_tensor(),
                      "grad_norm": metrics["grad_norm"].full_tensor()}


def _launch(rank: int, inp, out: dict, workdir: str) -> None:
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ckpt

    store = dist.FileStore(os.path.join(workdir, "store_launch"), 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    saves = []
    save = ckpt.save

    def recorded(state, ckpt_dir, step, host_id=0):
        saves.append(step)
        return save(state, ckpt_dir, step, host_id)

    ckpt.save = recorded
    argv = sys.argv
    buf = io.StringIO()
    try:
        sys.argv = ["repro_torch.launch.train", *inp["launch"],
                    "--distributed", "--device", "cpu", "--ckpt-dir",
                    os.path.join(workdir, "ck_launch")]
        with contextlib.redirect_stdout(buf):
            launch_train.main()
        out["launch"] = {"lines": buf.getvalue().splitlines(),
                         "saves": saves,
                         "still_joined": dist.is_initialized()}
    finally:
        sys.argv = argv
        ckpt.save = save
        dist.destroy_process_group()


def _rank(rank: int, workdir: str) -> None:
    from repro_torch.data import synthetic as syn

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD)
    out = {"rank": rank}
    try:
        path = os.path.join(workdir, "inputs.pt")
        _wait_for(path)
        inp = torch.load(path, weights_only=False)
        for name, paths in inp["metapaths"].items():
            syn.DATASET_METAPATHS[name] = paths
            syn.DATASET_TARGET[name] = inp["targets"][name]
        if inp.get("serve") is not None:
            _pod_loss(rank, inp, out)
        if inp.get("restore") is not None:
            _restore(rank, inp, out, workdir)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if inp.get("launch") is not None and rank < 2:
        _launch(rank, inp, out, workdir)
    torch.save(out, os.path.join(workdir, f"outputs_{rank}.pt"))


def main() -> None:
    mp.spawn(_rank, args=(sys.argv[1],), nprocs=WORLD, join=True)


if __name__ == "__main__":
    main()
