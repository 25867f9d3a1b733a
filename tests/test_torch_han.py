"""The port's first slice end to end: HAN full-graph inference
(``core/models/han.py``, ``core/pipeline.py``, ``interop.py``,
``serve/engine.py``, ``launch/serve.py``) against the JAX forward with the
reference's own parameters carried across.

Tolerance: atol = rtol = 1e-5 on the logits in fp32 (the same math in
another summation order; see ROADMAP invariant 2)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import HGNNConfig as RefConfig
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro_torch import interop
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph, plan
from repro_torch.core.models import get_model
from repro_torch.core.pipeline import StageGraphExecutor
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.launch.serve import build_hgnn_infer
from repro_torch.serve.engine import HGNNInferEngine

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(model="han", dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             attn_hidden=8, max_degree=6, fused=True)


@pytest.fixture(autouse=True)
def _tiny_tables():
    """Register the tiny graph's metapaths in both packages' tables, as
    tests/test_pallas_model_equivalence.py does for the reference."""
    for mod in (ref_syn, syn):
        mod.DATASET_METAPATHS["tiny"] = [["M", "D", "M"], ["M", "A", "M"]]
        mod.DATASET_TARGET["tiny"] = "M"


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


def _both(tiny_hg, **kw):
    """(reference logits, port logits, port model, port params, port batch)
    for one config, with the reference's parameters carried across."""
    ref_m = ref_get_model(RefConfig(**SMALL, **kw))
    ref_b = ref_m.prepare(tiny_hg)
    ref_p = ref_m.init(jax.random.key(0), ref_b)
    want = np.asarray(ref_m.forward(ref_p, ref_b))
    m = get_model(HGNNConfig(**SMALL, **kw))
    b = m.prepare(_port_hg(tiny_hg), device="cpu")
    p = interop.params_from_numpy(ref_p, device="cpu")
    return want, m.forward(p, b), m, p, b, ref_b


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
def test_han_forward_matches_jax(tiny_hg, layers, fuse, use_pallas):
    want, got, *_ = _both(tiny_hg, layers=layers, fuse_na_sa=fuse,
                          use_pallas=use_pallas)
    assert got.shape == want.shape == (40, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_han_batch_byte_equal_to_reference(tiny_hg):
    *_, b, ref_b = _both(tiny_hg)
    conv = interop.batch_from_numpy(ref_b, device="cpu")
    for key in ("nbr", "mask"):
        assert b[key].dtype == conv[key].dtype
        assert torch.equal(b[key], conv[key])
    for t in ref_b["feats"]:
        assert torch.equal(b["feats"][t], conv["feats"][t])
    assert b["n_nodes"] == conv["n_nodes"] == 40
    assert b["feat_dims"] == conv["feat_dims"]


def test_cpu_forward_with_kernels_counts_no_launch(tiny_hg):
    ops.reset_launch_counts()
    _both(tiny_hg, layers=2, fuse_na_sa=True, use_pallas=True)
    assert set(ops.launch_counts().values()) == {0}


def test_fused_sa_row_mask_correction_matches_jax(tiny_hg):
    """The closed-form removal of pad rows from the fused pass-1 mean."""
    ref_m = ref_get_model(RefConfig(**SMALL, fuse_na_sa=True))
    ref_b = ref_m.prepare(tiny_hg)
    ref_p = ref_m.init(jax.random.key(1), ref_b)
    row_mask = (np.arange(40) < 33).astype(np.float32)
    ref_b["row_mask"] = jax.numpy.asarray(row_mask)
    h = ref_m.fp(ref_p, ref_b)
    want = np.asarray(ref_m.sa(ref_p, ref_b, ref_m.na(ref_p, ref_b, h)))
    m = get_model(HGNNConfig(**SMALL, fuse_na_sa=True))
    b = interop.batch_from_numpy(ref_b, device="cpu")
    p = interop.params_from_numpy(ref_p, device="cpu")
    got = m.sa(p, b, m.na(p, b, m.fp(p, b)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_port_init_mirrors_reference_tree(tiny_hg):
    """The port's own init: the reference's tree, shapes and scales,
    deterministic in the generator's seed."""
    cfg = dict(SMALL, layers=2)
    ref_m = ref_get_model(RefConfig(**cfg))
    ref_p = ref_m.init(jax.random.key(0), ref_m.prepare(tiny_hg))
    m = get_model(HGNNConfig(**cfg))
    b = m.prepare(_port_hg(tiny_hg), device="cpu")
    p1 = m.init(torch.Generator().manual_seed(0), b)
    p2 = m.init(torch.Generator().manual_seed(0), b)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_p)[0]
    for path, leaf in flat_ref:
        node1, node2 = p1, p2
        for k in path:
            key = k.key if hasattr(k, "key") else k.idx
            node1, node2 = node1[key], node2[key]
        assert tuple(node1.shape) == tuple(leaf.shape), path
        assert torch.equal(node1, node2)
    assert torch.equal(p1["sem"]["b"], torch.zeros(8))
    assert p1["gat"]["a_dst"].shape == (2, 4, 4)


def test_engine_serves_the_forward(tiny_hg):
    cfg = HGNNConfig(**SMALL, fuse_na_sa=True, use_pallas=True)
    built = build_hgnn_infer(cfg, _port_hg(tiny_hg), device="cpu")
    eng = HGNNInferEngine(built.executor, built.params, built.batch,
                          fn=built.fn)
    out = eng.infer()
    assert out.shape == (40, 3) and torch.isfinite(out).all()
    assert torch.equal(out, built.executor.forward(built.params,
                                                   built.batch))
    assert built.plan.sa.fuse_epilogue and built.plan.na.use_pallas


def test_entry_points_need_a_device_without_cuda(tiny_hg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_hgnn_infer(HGNNConfig(**SMALL), _port_hg(tiny_hg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.params_from_numpy({"w": np.zeros(2)})
    assert interop.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kw,item", [
    (dict(model="gcn", fanout=4, overlap=2), "item 14"),
    (dict(model="gcn", overlap=2), "item 14"),
    (dict(partitions=2, overlap=2), "item 14"),
    (dict(fanout=4, partitions=2, overlap=2), "item 14"),
    (dict(cache_rows=8, partitions=2, overlap=2), "item 14"),
    (dict(overlap=2), "item 14"),
    (dict(model="rgcn", partitions=2, overlap=2), "item 14"),
    (dict(model="magnn", fanout=4, partitions=2, overlap=2), "item 14"),
    (dict(fused=False, fanout=4, overlap=2), "item 14"),
])
def test_arms_outside_the_slice_raise(tiny_hg, kw, item):
    """These configs declare the async schedule (``item``: ROADMAP Queue
    1 item 14, ported): each plan carries the reference's schedule and
    stage DAG, and runs as the reference does with it — a full-graph
    plan's overlapped forward bitwise its serial forward; a sampled plan
    serves through the engine's prefetch (tests/test_torch_overlap.py
    holds those serves bitwise and against the JAX engine)."""
    cfg = dict(SMALL, **kw)
    if cfg.get("model") == "gcn":
        cfg["dataset"] = "reddit"
    ref_m = ref_get_model(RefConfig(**cfg))
    m = get_model(HGNNConfig(**cfg))
    pl = m.plan()
    assert pl.schedule == plan.ScheduleSpec(depth=2) and item == "item 14"
    assert m.executor.schedule_edges() == ref_m.executor.schedule_edges()
    assert m.executor.overlap_record() == ref_m.executor.overlap_record()
    if pl.sample is not None or pl.na.kind == "gcn":
        return
    b = m.prepare(_port_hg(tiny_hg), device="cpu")
    p = m.init(torch.Generator().manual_seed(0), b)
    with torch.inference_mode():
        assert torch.equal(m.executor.forward_overlapped(p, b),
                           m.forward(p, b))


@pytest.mark.parametrize("edit,item", [
    (lambda pl: dataclasses.replace(pl, head=plan.HeadSpec(
        kind="select_linear", target="M")), "no model of the reference"),
    (lambda pl: dataclasses.replace(pl, partition=plan.PartitionSpec(k=2),
                                    layers=tuple(dataclasses.replace(
                                        lp, sa=dataclasses.replace(
                                            lp.sa, fuse_epilogue=True))
                                        for lp in pl.layers)),
     "no model of the reference"),
    (lambda pl: dataclasses.replace(pl, layers=tuple(
        dataclasses.replace(lp, na=dataclasses.replace(lp.na, kind="mean"))
        for lp in pl.layers)), "no model of the reference"),
    (lambda pl: dataclasses.replace(pl, layers=tuple(
        dataclasses.replace(lp, na=dataclasses.replace(
            lp.na, layout="bucketed"), sa=dataclasses.replace(
            lp.sa, fuse_epilogue=True)) for lp in pl.layers)),
     "no model of the reference"),
    (lambda pl: dataclasses.replace(pl, layers=tuple(
        dataclasses.replace(lp, handoff="all") for lp in pl.layers)),
     "no model of the reference"),
])
def test_executor_refuses_hand_built_plans_outside_the_slice(edit, item):
    """A plan that HAN.plan() would not make still cannot run on an arm
    that serves something else."""
    good = get_model(HGNNConfig(**SMALL, layers=2)).plan()
    StageGraphExecutor(good, HGNNConfig(**SMALL, layers=2))
    with pytest.raises(NotImplementedError, match=item):
        StageGraphExecutor(edit(good), HGNNConfig(**SMALL, layers=2))


def test_cli_prints_the_reference_line_on_cpu():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--hgnn", "han",
         "--dataset", "imdb", "--fuse-na-sa", "--use-pallas", "--device",
         "cpu", "--iters", "1"],
        capture_output=True, text=True, timeout=600, env=env, cwd=root)
    assert out.returncode == 0, out.stderr
    assert ("han/imdb [na=gat/stacked +fused-sa] logits (4278, 8) on "
            "single-device:") in out.stdout
