"""Run the port's compiled mesh steps on two gloo ranks of the CPU (the
helper of ``tests/test_torch_graphs_mesh_gloo.py``; not a test module, and
it imports no jax).

  python tests/torch_graphs_mesh_ranks.py WORKDIR

``WORKDIR/inputs.pt`` (written whole, by a rename, while the ranks start)
holds the HAN config, graph, metapaths and weights, the reduced granite's
weights, a prompt and a train state and batches.  Two processes join a
gloo group through a ``FileStore`` in WORKDIR.  Each installs the stand-in
card of ``tests/torch_fake_card.py`` with every tensor counting as one on
the card (so a held tensor, a copied per-step input and a donated state
each take their own path through ``graphs.compiled``), and runs:

* HAN on a ``(data=2, model=1)`` mesh: ``build_hgnn_infer(mesh=...)``'s
  forward eagerly and through ``graphs.compiled``, three calls (a capture
  and two replays); the signature's static parts; the same forward on
  the weights replicated (other placements: a second graph); weights whose
  local tensors moved (raises);
* the reduced granite on ``(data=1, model=2)``: ``jit_step``'s prefill and
  two decode steps, eagerly (``.fn``) and compiled, the token of each step
  made by an ``argmax``; the output placements and the caches returned;
* two train steps of the reduced granite on ``(1, 2)`` through
  ``jit_step``, eagerly and compiled (the state donated).

Rank 0 writes the gathered results to ``WORKDIR/outputs.pt``.
"""
from __future__ import annotations

import os
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)
INPUTS_TIMEOUT_S = 120


def _whole(t):
    """Every DTensor of ``t`` gathered, as a copy (a replicated one's
    ``full_tensor`` is its local tensor, which a donated step overwrites)."""
    from repro_torch import tree

    return tree.map(lambda x: x.full_tensor().clone(), t)


def _bitwise(a, b) -> bool:
    from repro_torch import tree

    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        type(x) is type(y) and x.placements == y.placements
        and torch.equal(x.to_local(), y.to_local()) for x, y in zip(la, lb))


def _han(inp, out):
    from repro_torch import graphs, tree
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.dist.sharding import NamedSharding, P, distribute_tree
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.serve import build_hgnn_infer, hgnn_shardings
    from torch_fake_card import on_card

    mesh = make_smoke_mesh(data=2, model=1)
    built = build_hgnn_infer(HGNNConfig(**inp["han_cfg"]), inp["hg"], "cpu",
                             mesh=mesh)
    p_sh, _ = hgnn_shardings(built.plan, inp["han_params"], built.batch,
                             mesh)
    params = on_card(distribute_tree(inp["han_params"], p_sh))
    batch = on_card(built.batch)
    f = graphs.compiled(built.fn)
    with torch.inference_mode():
        want = built.fn(params, batch)
        got = [f(params, batch) for _ in range(3)]
    out["han_eager"] = want.full_tensor()
    out["han_compiled"] = [g.full_tensor() for g in got]
    out["han_bitwise"] = all(_bitwise(g, want) for g in got)
    out["han_counts"] = (f.captures, f.replays)
    out["han_placements"] = (tuple(got[0].placements), tuple(want.placements))
    g = f.graph_of(params, batch)
    sig = next(k for k, v in f.graphs.items() if v is g)
    flat = tree.leaves((params, batch))
    out["han_sig_specs"] = [
        (d[0], tuple(d[-1].placements)) for x, d in zip(flat, sig[1])
        if type(x).__name__ == "DTensor"]
    out["han_placements_in"] = [tuple(x.placements) for x in flat
                                if type(x).__name__ == "DTensor"]
    # the weights replicated: other placements, another graph, the same bits
    rep = on_card(distribute_tree(inp["han_params"], tree.map(
        lambda _: NamedSharding(mesh, P()), p_sh)))
    with torch.inference_mode():
        r = f(rep, batch)
    out["han_replicated_bitwise"] = torch.equal(r.full_tensor(),
                                                want.full_tensor())
    out["han_graphs"] = len(f.graphs)
    moved = on_card(tree.map(lambda x: x.clone(), params))
    try:
        with torch.inference_mode():
            f(moved, batch)
        out["han_moved"] = "no error"
    except RuntimeError as e:
        out["han_moved"] = str(e)


def _granite(inp, out):
    from repro_torch import tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_reduced
    from repro_torch.dist.sharding import distribute_tree
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step, jit_step)
    from repro_torch.nn.transformer import (graft_prefill_caches,
                                            init_kv_caches)
    from torch_fake_card import on_card

    mesh = make_smoke_mesh(data=1, model=2)
    cfg = get_reduced("granite-8b")
    tokens = inp["tokens"]
    b, s = tokens.shape
    pre = jit_step(build_prefill_step(cfg, ShapeConfig("p", s, b, "prefill"),
                                      mesh))
    dec_built = build_decode_step(cfg, ShapeConfig("d", s + 8, b, "decode"),
                                  mesh)
    dec = jit_step(dec_built)
    with torch.inference_mode():
        params = on_card(distribute_tree(inp["lm_params"],
                                         pre.built.in_shardings[0]))
        runs = {}
        for arm in ("eager", "compiled"):
            prefill = pre.fn if arm == "eager" else pre
            decode = dec.fn if arm == "eager" else dec
            logits, caches = prefill(params, {"tokens": tokens})
            if arm == "compiled":  # a replay of the captured prefill
                again, _ = prefill(params, {"tokens": tokens})
                out["prefill_replay_bitwise"] = _bitwise(again, logits)
                out["prefill_placements"] = (
                    tuple(logits.placements),
                    tuple(pre.built.out_shardings[0].placements()))
            full = _whole(caches)
            grafted = graft_prefill_caches(
                cfg, init_kv_caches(cfg, b, s + 8, device="cpu"), full, s)
            held = on_card(distribute_tree(grafted,
                                           dec_built.in_shardings[2]))
            logit_list, toks = [logits], []
            for i in range(2):
                tok = logit_list[-1].full_tensor()[:, -1].argmax(-1)[
                    :, None].int()
                toks.append(tok)
                lg, back = decode(params, tok, held,
                                  torch.tensor(s + i, dtype=torch.int32))
                if arm == "compiled":
                    out.setdefault("caches_returned", []).append(all(
                        x is y for x, y in zip(tree.leaves(back),
                                               tree.leaves(held))))
                logit_list.append(lg)
            runs[arm] = (logit_list, toks, held)
    (le, te, ce), (lc, tc, cc) = runs["eager"], runs["compiled"]
    out["granite_bitwise"] = (
        all(_bitwise(x, y) for x, y in zip(lc, le))
        and all(torch.equal(x, y) for x, y in zip(tc, te))
        and _bitwise(cc, ce))
    out["granite_prefill"] = lc[0].full_tensor()
    out["granite_decode"] = [x.full_tensor() for x in lc[1:]]
    out["granite_tokens"] = tc
    out["granite_counts"] = {
        "prefill": (pre.compiled.captures, pre.compiled.replays),
        "decode": (dec.compiled.captures, dec.compiled.replays)}
    out["decode_kinds"] = sorted({d[0] for d in next(iter(
        dec.compiled.graphs))[1]})


def _train(inp, out):
    from repro_torch import tree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_reduced
    from repro_torch.dist.sharding import distribute_tree
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_train_step, jit_step
    from torch_fake_card import on_card

    mesh = make_smoke_mesh(data=1, model=2)
    cfg = get_reduced("granite-8b")
    batches = inp["train_batches"]
    b, s = batches[0]["tokens"].shape
    step = jit_step(build_train_step(cfg, ShapeConfig("t", s, b, "train"),
                                     mesh))
    sh = step.built.in_shardings[0]
    eager = distribute_tree(inp["train_state"], sh)
    held = on_card(distribute_tree(tree.map(torch.clone, inp["train_state"]),
                                   sh))
    leaves = tree.leaves(held)
    res = {"same_tensors": [], "bitwise": [], "metrics": [], "states": []}
    for batch in batches:
        eager, em = step.fn(eager, batch)
        held, m = step(held, batch)
        res["same_tensors"].append(all(
            x is y for x, y in zip(tree.leaves(held), leaves)))
        res["bitwise"].append(_bitwise(held, eager) and all(
            _bitwise(m[k], em[k]) for k in ("loss", "grad_norm")))
        res["metrics"].append({k: m[k].full_tensor()
                               for k in ("loss", "grad_norm")})
        res["states"].append(_whole(held))
    res["counts"] = (step.compiled.captures, step.compiled.replays)
    out["train"] = res


def _rank(rank: int, workdir: str) -> None:
    from repro_torch import graphs
    from repro_torch.data import synthetic as syn
    from torch_fake_card import FakeCard

    class EveryTensorOnTheCard(FakeCard):
        @staticmethod
        def resident(x):
            return True

    torch.set_num_threads(1)
    graphs._card = EveryTensorOnTheCard()
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
        for name, paths in inp["metapaths"].items():
            syn.DATASET_METAPATHS[name] = paths
            syn.DATASET_TARGET[name] = inp["targets"][name]
        out = {}
        _han(inp, out)
        dist.barrier()
        _granite(inp, out)
        dist.barrier()
        _train(inp, out)
        if rank == 0:
            torch.save(out, os.path.join(workdir, "outputs.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> None:
    mp.spawn(_rank, args=(sys.argv[1],), nprocs=2, join=True)


if __name__ == "__main__":
    main()
