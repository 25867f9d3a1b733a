"""The compiled mesh steps and the compiled training step on the card
(``graphs.compiled`` with DTensor leaves and ``donate=``), at a tiny size.

On a 1-rank NCCL mesh (data=1, model=1): the HAN forward that
``build_hgnn_infer(mesh=...)`` compiles, three calls (a capture and two
replays) bitwise the eager mesh forward (``fn.fn``), the replays adding
the capture's launches, no c10d collective; ``jit_step``'s prefill and
decode of the reduced granite under ``use_pallas``, the captured wave's
tokens and logits bitwise the eager wave's (``.fn``), the caches given
back, no collective; two train steps of the reduced smollm through
``jit_step``, the state donated, bitwise the eager steps.  Off the mesh:
``launch/train.setup``'s compiled step, three steps on the loader's numpy
batches bitwise ``step_fn.fn`` on tensors, the same tensors returned; the
training CLI with a checkpoint and ``--resume`` losing no step.  Every
test needs a CUDA device and skips without one.  The file imports no jax:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_graphs_mesh_gpu.py
"""
import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch import graphs, tree
from repro_torch.configs.base import HGNNConfig, ShapeConfig
from repro_torch.configs.registry import get_reduced
from repro_torch.core.hgraph import HeteroGraph
from repro_torch.data import synthetic as syn
from repro_torch.data.loader import synth_batch
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mesh(cuda):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_smoke_mesh(data=1, model=1)
    finally:
        dist.destroy_process_group()


@pytest.fixture
def tiny_graph(monkeypatch):
    monkeypatch.setitem(syn.DATASET_METAPATHS, "tiny",
                        [["M", "D", "M"], ["M", "A", "M"]])
    monkeypatch.setitem(syn.DATASET_TARGET, "tiny", "M")
    rng = np.random.default_rng(7)
    counts = {"M": 40, "D": 15, "A": 25}
    dims = {"M": 12, "D": 8, "A": 10}
    feats = {t: rng.standard_normal((n, dims[t])).astype(np.float32)
             for t, n in counts.items()}

    def rel(ns, nd, e):
        return sp.csr_matrix((np.ones(e, np.float32),
                              (rng.integers(0, ns, e),
                               rng.integers(0, nd, e))), shape=(ns, nd))

    md, ma = rel(40, 15, 60), rel(40, 25, 80)
    return HeteroGraph(counts, feats, {("M", "md", "D"): md,
                                       ("D", "dm", "M"): md.T.tocsr(),
                                       ("M", "ma", "A"): ma,
                                       ("A", "am", "M"): ma.T.tocsr()},
                       name="tiny")


def _bitwise(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        type(x) is type(y) and getattr(x, "placements", None) == getattr(
            y, "placements", None)
        and torch.equal(getattr(x, "_local_tensor", x),
                        getattr(y, "_local_tensor", y))
        for x, y in zip(la, lb))


def test_han_mesh_forward_replays_the_eager_mesh_forward(mesh, tiny_graph):
    from repro_torch.launch.serve import build_hgnn_infer

    cfg = HGNNConfig(model="han", dataset="tiny", hidden=16, n_heads=4,
                     n_classes=3, attn_hidden=8, max_degree=16, fused=True,
                     use_pallas=True, fuse_na_sa=True)
    b = build_hgnn_infer(cfg, tiny_graph, "cuda", mesh=mesh)
    assert isinstance(b.fn, graphs.Compiled)
    ops.reset_launch_counts()
    with torch.inference_mode():
        want = b.fn.fn(b.params, b.batch)
    torch.cuda.synchronize()
    eager = ops.launch_counts()
    comm = CommDebugMode()
    ops.reset_launch_counts()
    with comm, torch.inference_mode():
        got = [b.fn(b.params, b.batch) for _ in range(3)]
    torch.cuda.synchronize()
    assert comm.get_total_counts() == 0
    assert (b.fn.captures, b.fn.replays) == (1, 2)
    assert ops.launch_counts() == {k: 3 * n for k, n in eager.items()}
    assert eager["gat_na_fused_sa"] == 1 and eager["semantic_combine"] == 1
    assert all(_bitwise(g, want) for g in got)


def test_jit_step_prefill_and_decode_replay_the_eager_wave(mesh):
    from repro_torch.dist.sharding import distribute_tree
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step, jit_step)
    from repro_torch.nn.transformer import (graft_prefill_caches,
                                            init_kv_caches, init_lm_params)

    cfg = get_reduced("granite-8b").replace(use_pallas=True)
    b, s, n = 2, 16, 4
    params = init_lm_params(torch.Generator(device="cuda").manual_seed(1),
                            cfg)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, s)).astype(np.int32), device="cuda")
    pre = jit_step(build_prefill_step(cfg, ShapeConfig("p", s, b, "prefill"),
                                      mesh))
    dec_built = build_decode_step(cfg, ShapeConfig("d", s + n, b, "decode"),
                                  mesh)
    dec = jit_step(dec_built)
    comm = CommDebugMode()
    waves = {}
    with comm, torch.inference_mode():
        p_mesh = distribute_tree(params, pre.built.in_shardings[0])
        for arm in ("eager", "compiled"):
            prefill = pre.fn if arm == "eager" else pre
            decode = dec.fn if arm == "eager" else dec
            lg, pf = prefill(p_mesh, {"tokens": tokens})
            pf = tree.map(lambda c: c.full_tensor(), pf)
            caches = distribute_tree(graft_prefill_caches(
                cfg, init_kv_caches(cfg, b, s + n, "cuda"), pf, s),
                dec_built.in_shardings[2])
            logits, toks = [lg.full_tensor()], []
            for i in range(n):
                tok = logits[-1][:, -1].argmax(-1)[:, None].to(torch.int32)
                toks.append(tok)
                lg, back = decode(p_mesh, tok, caches, torch.tensor(
                    s + i, dtype=torch.int32, device="cuda"))
                if arm == "compiled":
                    assert all(x is y for x, y in zip(tree.leaves(back),
                                                      tree.leaves(caches)))
                logits.append(lg.full_tensor())
            waves[arm] = (logits, toks)
    torch.cuda.synchronize()
    assert comm.get_total_counts() == 0
    (le, te), (lc, tc) = waves["eager"], waves["compiled"]
    assert all(torch.equal(x, y) for x, y in zip(lc, le))
    assert all(torch.equal(x, y) for x, y in zip(tc, te))
    assert (pre.compiled.captures, dec.compiled.captures) == (1, 1)
    assert dec.compiled.replays == n - 1


def test_jit_step_train_donates_the_mesh_state(mesh):
    from repro_torch.dist.sharding import distribute_tree
    from repro_torch.launch.steps import build_train_step, jit_step
    from repro_torch.train.optimizer import build_optimizer
    from repro_torch.train.train_step import init_train_state

    cfg = get_reduced("smollm-360m")
    shape = ShapeConfig("t", 32, 4, "train")
    step = jit_step(build_train_step(cfg, shape, mesh))
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, build_optimizer(cfg))
    sh = step.built.in_shardings[0]
    eager = distribute_tree(state, sh)
    held = distribute_tree(tree.map(torch.clone, state), sh)
    leaves = tree.leaves(held)
    for i in range(3):
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in synth_batch(cfg, shape, i).items()}
        eager, em = step.fn(eager, batch)
        held, m = step(held, batch)
        assert all(x is y for x, y in zip(tree.leaves(held), leaves))
        assert _bitwise(held, eager)
        assert all(_bitwise(m[k], em[k]) for k in ("loss", "grad_norm"))
    assert (step.compiled.captures, step.compiled.replays) == (1, 2)


def test_launch_train_step_is_compiled_and_bitwise_eager(cuda):
    from repro_torch.launch import train as launch_train

    cfg = get_reduced("smollm-360m")
    run = launch_train.setup(cfg, steps=3, seq_len=32, batch=4,
                             microbatches=2, device=cuda)
    assert isinstance(run.step_fn, graphs.Compiled)
    assert run.step_fn.donate == (0,)
    eager = tree.map(torch.clone, run.state)
    held = run.state
    leaves = tree.leaves(held)
    ops.reset_launch_counts()
    for i in range(3):
        batch = synth_batch(cfg, run.shape, i)  # numpy, as the loader's
        held, m = run.step_fn(held, batch)
        eager, em = run.step_fn.fn(eager, launch_train.to_device(batch,
                                                                 cuda))
        assert all(x is y for x, y in zip(tree.leaves(held), leaves))
        assert torch.equal(m["loss"], em["loss"])
        assert torch.equal(m["grad_norm"], em["grad_norm"])
        assert _bitwise(held, eager)
    torch.cuda.synchronize()
    assert (run.step_fn.captures, run.step_fn.replays) == (1, 2)
    # the embedding gradient: one segment_sum a microbatch, either arm
    assert ops.launch_counts()["segment_sum"] == 2 * 2 * 3


def test_train_cli_resumes_onto_the_compiled_step(cuda, tmp_path,
                                                  monkeypatch):
    from repro_torch.launch import train as launch_train

    def cli(*extra):
        argv = ["train", "--arch", "smollm-360m", "--reduced", "--seq-len",
                "32", "--batch", "4", *extra]
        monkeypatch.setattr(sys, "argv", argv)
        buf = io.StringIO()
        with redirect_stdout(buf):
            launch_train.main()
        return [line.split()[3] for line in buf.getvalue().splitlines()
                if line.startswith("step")]

    whole = cli("--steps", "4")
    first = cli("--steps", "2", "--ckpt-dir", str(tmp_path))
    rest = cli("--steps", "2", "--ckpt-dir", str(tmp_path), "--resume")
    assert len(whole) == 4 and first + rest == whole
