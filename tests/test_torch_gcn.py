"""GCN full-graph inference of the port (``core/models/gcn.py``, the
executor's ``dense`` FP, ``gcn`` NA and ``none`` SA arms, the segment mean
on ``kernels/segment_sum.py``, ``launch/serve.py --hgnn gcn``) against the
JAX forward on the Reddit-like graph at a small scale, with the
reference's parameters carried across.

Tolerance: atol = rtol = 1e-5 on the logits in fp32 (the same math in
another summation order; ROADMAP invariant 2).  Host tables are held
byte-equal."""
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
from repro.core import metapath as ref_mp
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro_torch import interop
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph
from repro_torch.core import metapath as mp
from repro_torch.core.models import get_model
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.launch.serve import build_hgnn_infer

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(model="gcn", dataset="reddit", hidden=16, n_classes=5)
SCALE = 0.005  # 1164 nodes, ~9k edges with the self-loops


@pytest.fixture(scope="module")
def reddit():
    """(the reference's graph, the port's graph) at SCALE."""
    return (ref_syn.make_reddit_like(scale=SCALE),
            syn.make_reddit_like(scale=SCALE))


def _both(reddit, **kw):
    """(reference logits, port logits, port batch, reference batch,
    reference params) for one config."""
    ref_hg, hg = reddit
    ref_m = ref_get_model(RefConfig(**SMALL, **kw))
    ref_b = ref_m.prepare(ref_hg)
    ref_p = ref_m.init(jax.random.key(0), ref_b)
    want = np.asarray(ref_m.forward(ref_p, ref_b))
    m = get_model(HGNNConfig(**SMALL, **kw))
    b = m.prepare(hg, device="cpu")
    with torch.inference_mode():
        got = m.forward(interop.params_from_numpy(ref_p, device="cpu"), b)
    return want, got, b, ref_b, ref_p


@pytest.mark.parametrize("cache_rows", [0, 64])
@pytest.mark.parametrize("layers", [1, 2])
def test_gcn_forward_matches_jax(reddit, layers, cache_rows):
    want, got, *_ = _both(reddit, layers=layers, cache_rows=cache_rows)
    assert got.shape == want.shape == (1164, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_reddit_graph_byte_equal_to_reference(reddit):
    ref_hg, hg = reddit
    assert hg.node_counts == ref_hg.node_counts == {"N": 1164}
    assert hg.features["N"].tobytes() == ref_hg.features["N"].tobytes()
    a, b = hg.relations[("N", "nn", "N")], ref_hg.relations[("N", "nn", "N")]
    for field in ("indptr", "indices", "data"):
        assert getattr(a, field).tobytes() == getattr(b, field).tobytes()


def test_csr_and_edge_list_byte_equal_to_reference(reddit):
    ref_hg, hg = reddit
    csr, ref_csr = mp.build_csr(hg, ["N", "N"]), ref_mp.build_csr(
        ref_hg, ["N", "N"])
    for field in ("indptr", "indices"):
        mine, theirs = getattr(csr, field), getattr(ref_csr, field)
        assert mine.dtype == theirs.dtype
        assert mine.tobytes() == theirs.tobytes()
    *_, b, ref_b, _ = _both(reddit)
    for key in ("x", "seg", "idx"):
        mine, theirs = b[key].numpy(), np.asarray(ref_b[key])
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        assert mine.tobytes() == theirs.tobytes()
    assert (np.diff(b["seg"].numpy()) >= 0).all()  # sorted segments
    assert b["n_nodes"] == ref_b["n_nodes"] == 1164
    assert b["feat_dim"] == ref_b["feat_dim"] == 602


def test_plan_mirrors_reference(reddit):
    for layers in (1, 3):
        mine = get_model(HGNNConfig(**SMALL, layers=layers)).plan()
        ref = ref_get_model(RefConfig(**SMALL, layers=layers)).plan()
        assert mine.model == ref.model == "gcn" and mine.target == ref.target
        assert dataclasses.asdict(mine.head) == dataclasses.asdict(ref.head)
        for lp, rlp in zip(mine.layers, ref.layers, strict=True):
            for f in ("fp", "na", "sa"):
                assert dataclasses.asdict(getattr(lp, f)) == \
                    dataclasses.asdict(getattr(rlp, f))
            assert (lp.handoff, lp.carry) == (rlp.handoff, rlp.carry)


def test_port_init_mirrors_reference_tree(reddit):
    """The port's own init: the reference's leaves, shapes and scales,
    deterministic in the generator's seed."""
    *_, b, _, ref_p = _both(reddit, layers=2)
    m = get_model(HGNNConfig(**SMALL, layers=2))
    p1 = m.init(torch.Generator().manual_seed(0), b)
    p2 = m.init(torch.Generator().manual_seed(0), b)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_p)[0]
    assert len(flat_ref) == 3
    for path, leaf in flat_ref:
        node1, node2 = p1, p2
        for k in path:
            key = k.key if hasattr(k, "key") else k.idx
            node1, node2 = node1[key], node2[key]
        assert tuple(node1.shape) == tuple(leaf.shape), path
        assert torch.equal(node1, node2)
    assert p1["w1"].shape == (602, 16) and p1["w2"].shape == (16, 5)
    assert abs(float(p1["w1"].std()) - 602 ** -0.5) < 0.005


def test_engine_runs_gcn_without_a_launch_on_cpu(reddit):
    ops.reset_launch_counts()
    built = build_hgnn_infer(HGNNConfig(**SMALL, layers=2), reddit[1],
                             device="cpu")
    with torch.inference_mode():
        out = built.fn(built.params, built.batch)
    assert out.shape == (1164, 5) and torch.isfinite(out).all()
    assert set(ops.launch_counts().values()) == {0}
    assert built.plan.na.kind == "gcn" and built.plan.sa.kind == "none"


@pytest.mark.parametrize("kw,err,match", [
    (dict(partitions=2), ValueError, "no partitioned execution layout"),
    (dict(fanout=4, overlap=2), NotImplementedError, "item 14"),
    (dict(overlap=2), NotImplementedError, "item 14"),
])
def test_gcn_modes_outside_the_slice_raise(reddit, kw, err, match):
    """``partitions`` raises the reference's ``ValueError``.  The overlap
    cases (the async schedule, ROADMAP Queue 1 item 14, which ``match``
    names) are ported: the plan declares the reference's schedule, and the
    overlapped forward is bitwise the serial one (GCN's chain has no
    sibling stages, so nothing runs side by side)."""
    if match != "item 14":
        with pytest.raises(err, match=match):
            get_model(HGNNConfig(**SMALL, **kw)).plan()
        return
    ref_plan = ref_get_model(RefConfig(**SMALL, **kw)).plan()
    m = get_model(HGNNConfig(**SMALL, **kw))
    pl = m.plan()
    assert pl.schedule.depth == ref_plan.schedule.depth == 2
    assert (pl.sample is None) == (ref_plan.sample is None)
    assert m.executor.schedule_edges() == ref_get_model(
        RefConfig(**SMALL, **kw)).executor.schedule_edges()
    b = m.prepare(reddit[1], device="cpu")
    p = m.init(torch.Generator().manual_seed(0), b)
    with torch.inference_mode():
        assert torch.equal(m.executor.forward_overlapped(p, b),
                           m.forward(p, b))


def _cli(*args):
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, timeout=600, env=env, cwd=root)


def test_cli_prints_the_reference_line_on_cpu():
    out = _cli("--hgnn", "gcn", "--dataset", "reddit", "--device", "cpu",
               "--iters", "1")
    assert out.returncode == 0, out.stderr
    assert ("gcn/reddit [na=gcn/csr] logits (23296, 8) on single-device:"
            in out.stdout)


def test_cli_refuses_gcn_off_reddit():
    out = _cli("--hgnn", "gcn", "--dataset", "imdb", "--device", "cpu")
    assert out.returncode != 0
    assert "use --dataset reddit" in out.stderr
    assert "logits" not in out.stdout
