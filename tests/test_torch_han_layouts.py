"""HAN's baseline ``csr`` layout and its ``bucketed`` one in the port
(``core/models/han.py`` prepare and plan, the executor's ``csr`` and
``bucketed`` GAT arms, ``stages.gat_aggregate_csr`` /
``gat_aggregate_bucketed``, the unstacked ``gat_na`` a degree bucket)
against the JAX forward with the reference's parameters carried across.
Where the reference's arm reaches a Pallas kernel (the bucketed arm with
``use_pallas``: ``ops.gat_aggregate`` a bucket), it runs in interpret mode,
as ``tests/test_pallas_model_equivalence.py`` runs it.

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
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro.kernels import ops as ref_ops
from repro_torch import interop
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph
from repro_torch.core.models import get_model
from repro_torch.core.pipeline import StageGraphExecutor
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.launch.serve import build_hgnn_infer

TOL = dict(atol=1e-5, rtol=1e-5)
# max_degree 16 gives the tiny graph two degree buckets a metapath (K 8, 16)
SMALL = dict(model="han", dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             attn_hidden=8, max_degree=16)
LAYOUTS = {"csr": dict(fused=False),
           "bucketed": dict(fused=True, degree_buckets=3)}


@pytest.fixture(autouse=True)
def _tiny_tables():
    for mod in (ref_syn, syn):
        mod.DATASET_METAPATHS["tiny"] = [["M", "D", "M"], ["M", "A", "M"]]
        mod.DATASET_TARGET["tiny"] = "M"


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


def _interpret(monkeypatch):
    """The reference's unstacked GAT kernel wrapper onto the Pallas kernel
    in interpret mode."""
    orig = ref_ops.gat_aggregate
    monkeypatch.setattr(
        ref_ops, "gat_aggregate",
        lambda *a, use_pallas=False, interpret=False, **kw:
        orig(*a, use_pallas=True, interpret=True, **kw))


def _both(tiny_hg, **kw):
    ref_m = ref_get_model(RefConfig(**SMALL, **kw))
    ref_b = ref_m.prepare(tiny_hg)
    ref_p = ref_m.init(jax.random.key(0), ref_b)
    want = np.asarray(ref_m.forward(ref_p, ref_b))
    m = get_model(HGNNConfig(**SMALL, **kw))
    b = m.prepare(_port_hg(tiny_hg), device="cpu")
    p = interop.params_from_numpy(ref_p, device="cpu")
    with torch.inference_mode():
        got = m.forward(p, b)
    return want, got, b, ref_b, ref_p


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_han_layout_matches_jax(tiny_hg, monkeypatch, layout, use_pallas,
                                layers):
    if use_pallas and layout == "bucketed":
        _interpret(monkeypatch)
    want, got, *_ = _both(tiny_hg, **LAYOUTS[layout], use_pallas=use_pallas,
                          layers=layers)
    assert got.shape == want.shape == (40, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _same_tree(port, ref):
    if isinstance(ref, dict):
        assert sorted(port, key=str) == sorted(ref, key=str)
        for k in ref:
            _same_tree(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert type(port) is type(ref) and len(port) == len(ref)
        for a, b in zip(port, ref):
            _same_tree(a, b)
    elif isinstance(port, torch.Tensor):
        a, b = port.numpy(), np.asarray(ref)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert port == ref


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layout_tables_byte_equal_to_reference(tiny_hg, layout):
    """``edges`` (per metapath the CSR's ``(seg, idx)``) and ``buckets``
    (per metapath a list of ``(row_ids, nbr, mask)``), drawn from the
    reference's RNG stream, and the rest of the batch."""
    *_, b, ref_b, _ = _both(tiny_hg, **LAYOUTS[layout])
    key = "edges" if layout == "csr" else "buckets"
    assert key in b and "nbr" not in b
    _same_tree(b, ref_b)
    if layout == "bucketed":
        ks = [[nbr.shape[1] for _, nbr, _ in bks] for bks in b["buckets"]]
        assert all(len(k) > 1 for k in ks), ks  # more than one bucket
        for bks in b["buckets"]:
            rows = torch.cat([r for r, _, _ in bks]).sort().values
            assert torch.equal(rows, torch.arange(40, dtype=torch.int32))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_port_init_keeps_the_per_metapath_list(tiny_hg, layout):
    """Off the stacked layout ``gat`` is a list of per-metapath dicts, as
    in the reference, in every layer; the port's own init mirrors the
    tree."""
    *_, b, _, ref_p = _both(tiny_hg, **LAYOUTS[layout], layers=2)
    m = get_model(HGNNConfig(**SMALL, **LAYOUTS[layout], layers=2))
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
    for tree in (p1, p1["layers"][0]):
        assert isinstance(tree["gat"], list) and len(tree["gat"]) == 2
        assert tree["gat"][0]["a_dst"].shape == (4, 4)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plan_mirrors_reference(layout):
    kw = dict(SMALL, **LAYOUTS[layout], use_pallas=True, fuse_na_sa=True)
    mine = get_model(HGNNConfig(**kw)).plan()
    ref = ref_get_model(RefConfig(**kw)).plan()
    assert mine.metapaths == ref.metapaths
    for f in ("na", "sa"):
        assert dataclasses.asdict(getattr(mine, f)) == \
            dataclasses.asdict(getattr(ref, f))
    assert not mine.sa.fuse_epilogue  # the epilogue is the stacked arm's


def test_bucketed_kernel_arm_calls_gat_na_once_a_bucket(tiny_hg,
                                                        monkeypatch):
    """With ``use_pallas`` the bucketed arm calls the unstacked kernel
    wrapper once a bucket a layer; on the CPU it runs the plain version,
    so no launch is counted."""
    calls = []
    orig = ops.gat_aggregate

    def counted(*a, **kw):
        calls.append(tuple(a[3].shape))
        return orig(*a, **kw)

    monkeypatch.setattr(ops, "gat_aggregate", counted)
    ops.reset_launch_counts()
    built = build_hgnn_infer(
        HGNNConfig(**SMALL, **LAYOUTS["bucketed"], use_pallas=True,
                   layers=2), _port_hg(tiny_hg), device="cpu")
    with torch.inference_mode():
        built.fn(built.params, built.batch)
    n_b = sum(len(bks) for bks in built.batch["buckets"])
    assert len(calls) == 2 * n_b
    assert [k for _, k in calls[:n_b]] == [
        nbr.shape[1] for bks in built.batch["buckets"] for _, nbr, _ in bks]
    assert set(ops.launch_counts().values()) == {0}


def test_csr_arm_ignores_use_pallas_as_the_reference_does(tiny_hg):
    outs = []
    for use_pallas in (False, True):
        built = build_hgnn_infer(
            HGNNConfig(**SMALL, **LAYOUTS["csr"], use_pallas=use_pallas),
            _port_hg(tiny_hg), device="cpu")
        with torch.inference_mode():
            outs.append(built.fn(built.params, built.batch))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("edit", [
    lambda sa: dataclasses.replace(sa, stacked=True),
    lambda sa: dataclasses.replace(sa, fuse_epilogue=True),
])
def test_executor_refuses_csr_plans_no_model_declares(edit):
    good = get_model(HGNNConfig(**SMALL, **LAYOUTS["csr"])).plan()
    StageGraphExecutor(good, HGNNConfig(**SMALL))
    bad = dataclasses.replace(good, layers=tuple(
        dataclasses.replace(lp, sa=edit(lp.sa)) for lp in good.layers))
    with pytest.raises(NotImplementedError, match="no model of the reference"):
        StageGraphExecutor(bad, HGNNConfig(**SMALL))


def test_partitions_off_the_stacked_layout_raise_the_reference_error():
    with pytest.raises(ValueError, match="needs the stacked layout"):
        get_model(HGNNConfig(**SMALL, fused=False, partitions=2)).plan()


def test_cli_runs_the_bucketed_layout_on_cpu():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--hgnn", "han",
         "--dataset", "imdb", "--degree-buckets", "3", "--use-pallas",
         "--device", "cpu", "--iters", "1"],
        capture_output=True, text=True, timeout=600, env=env, cwd=root)
    assert out.returncode == 0, out.stderr
    assert ("han/imdb [na=gat/bucketed] logits (4278, 8) on single-device:"
            in out.stdout)
