"""The port's mesh paths on the card, on a 1-rank NCCL mesh (data=1,
model=1), bitwise the mesh-less paths at small sizes: HAN on the tiny
graph through ``build_hgnn_infer(mesh=...)`` (the fused ``gat_na``
epilogue and ``semantic_combine``), and the reduced granite's prefill and
decode steps through ``launch/steps`` (``flash_attention`` and
``decode_attention``), with exact launches and no c10d collective (the
mesh's dims are size 1).  Every test needs a CUDA device and skips
without one.  The file imports no jax:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_mesh_gpu.py
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch import tree
from repro_torch.configs.base import HGNNConfig, ShapeConfig
from repro_torch.configs.registry import get_reduced
from repro_torch.core.hgraph import HeteroGraph
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu
HAN = dict(model="han", dataset="tiny", hidden=16, n_heads=4, n_classes=3,
           attn_hidden=8, max_degree=16, fused=True, use_pallas=True,
           fuse_na_sa=True)


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def test_han_on_the_mesh_is_bitwise_the_meshless_forward(mesh, tiny_graph):
    from repro_torch.launch.serve import build_hgnn_infer

    cfg = HGNNConfig(**HAN)
    plain = build_hgnn_infer(cfg, tiny_graph, "cuda")
    comm = CommDebugMode()
    with comm:
        meshed = build_hgnn_infer(cfg, tiny_graph, "cuda", mesh=mesh)
    counts = {}
    outs = {}
    for tag, b in (("plain", plain), ("mesh", meshed)):
        ops.reset_launch_counts()
        with comm, torch.inference_mode():
            outs[tag] = b.fn(b.params, b.batch)
        torch.cuda.synchronize()
        counts[tag] = ops.launch_counts()
    assert comm.get_total_counts() == 0, comm.get_comm_counts()
    assert type(outs["mesh"]).__name__ == "DTensor"
    assert torch.equal(outs["mesh"].full_tensor(), outs["plain"])
    assert counts["mesh"] == counts["plain"]
    assert counts["plain"]["gat_na_fused_sa"] == 1
    assert counts["plain"]["semantic_combine"] == 1


def test_granite_steps_on_the_mesh_are_bitwise_the_direct_calls(mesh):
    from repro_torch.dist.sharding import distribute_tree
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step, jit_step)
    from repro_torch.nn import transformer as tf

    cfg = get_reduced("granite-8b").replace(use_pallas=True)
    dev = torch.device("cuda")
    params = tf.init_lm_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    b, s, n = 2, 64, 4
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)).astype(
        np.int32), device=dev)
    pre = build_prefill_step(cfg, ShapeConfig("p", s, b, "prefill"), mesh)
    dec = build_decode_step(cfg, ShapeConfig("d", s + n, b, "decode"), mesh)
    with torch.inference_mode():
        p_mesh = distribute_tree(params, pre.in_shardings[0])

    def run(meshed):
        ops.reset_launch_counts()
        logits = []
        with torch.inference_mode():
            if meshed:
                lg, pf = jit_step(pre)(p_mesh, {"tokens": tokens})
                lg = lg.full_tensor()
                pf = tree.map(lambda c: c.full_tensor(), pf)
            else:
                lg, pf = tf.lm_prefill(params, cfg, tokens)
            caches = tf.graft_prefill_caches(
                cfg, tf.init_kv_caches(cfg, b, s + n, dev), pf, s)
            if meshed:
                caches = distribute_tree(caches, dec.in_shardings[2])
            logits.append(lg)
            tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
            for i in range(n):
                pos = torch.tensor(s + i, dtype=torch.int32, device=dev)
                if meshed:
                    lg, caches = jit_step(dec)(p_mesh, tok, caches, pos)
                    lg = lg.full_tensor()
                else:
                    lg, caches = tf.lm_decode_step(params, cfg, tok, caches,
                                                   pos)
                logits.append(lg)
                tok = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        return logits, ops.launch_counts()

    want, c_plain = run(False)
    comm = CommDebugMode()
    with comm:
        got, c_mesh = run(True)
    assert comm.get_total_counts() == 0, comm.get_comm_counts()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    layers = cfg.n_layers
    for c in (c_plain, c_mesh):
        assert c["flash_attention"] == layers
        assert c["decode_attention"] == layers * n


def test_a_dtensor_reaching_a_kernel_wrapper_raises(mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor

    q = distribute_tensor(torch.randn(2, 1, 4, 16, device="cuda"),
                          mesh.device_mesh, [Replicate(), Replicate()])
    with pytest.raises(TypeError, match="DTensor"):
        ops.flash_attention(q, q, q, use_pallas=True)
