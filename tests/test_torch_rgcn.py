"""The port's second slice end to end: RGCN full-graph inference
(``core/models/rgcn.py``, the mean-NA / rel_sum / select_linear arms of
``core/pipeline.py``, the ``mean_aggregate_*`` stages, ``launch/serve.py``)
against the JAX forward with the reference's own parameters carried
across, on the ``padded``, ``bucketed`` and ``csr`` layouts.

With ``use_pallas`` the JAX side runs its Pallas ``segment_spmm`` in
interpret mode (forced by a monkeypatch of ``repro.kernels.ops``, as
``tests/test_pallas_model_equivalence.py`` does), and the port runs the
kernel wrapper, which takes its plain version for a CPU tensor.

Tolerance: atol = rtol = 1e-5 on the logits in fp32 (the same math in
another summation order; ROADMAP invariant 2)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.configs.base import HGNNConfig as RefConfig
from repro.core import stages as ref_stages
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro.kernels import ops as jops
from repro.kernels import segment_spmm as jspmm
from repro_torch import interop
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph, stages
from repro_torch.core.models import get_model
from repro_torch.core.pipeline import StageGraphExecutor
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.launch.serve import build_hgnn_infer
from repro_torch.serve.engine import HGNNInferEngine

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(model="rgcn", dataset="tiny", hidden=16, n_classes=3,
             max_degree=4)
LAYOUTS = {"padded": dict(fused=True),
           "bucketed": dict(fused=True, degree_buckets=3),
           "csr": dict(fused=False)}


@pytest.fixture(autouse=True)
def _tiny_tables():
    for mod in (ref_syn, syn):
        mod.DATASET_METAPATHS["tiny"] = [["M", "D", "M"], ["M", "A", "M"]]
        mod.DATASET_TARGET["tiny"] = "M"


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


def _force_interpret(monkeypatch):
    """The reference's ``ops.segment_spmm`` runs its jnp ref on the CPU even
    with ``use_pallas=True``; force the Pallas kernel in interpret mode."""
    orig = jops.segment_spmm
    monkeypatch.setattr(
        jops, "segment_spmm",
        lambda *args, use_pallas=False, interpret=False, **kw:
        orig(*args, use_pallas=True, interpret=True, **kw))


def _force_streaming(monkeypatch):
    """Route the reference straight into the streaming Pallas kernel (small
    chunks, so the double-buffered DMA path runs), as
    ``tests/test_stage_pipeline.py`` does."""
    monkeypatch.setattr(
        jops, "segment_spmm",
        lambda hs, nn, mm, mean=True, **kw: jspmm.segment_spmm(
            hs, nn, mm, mean=mean, block_n=16, block_m=8, interpret=True))


def _both(tiny_hg, **kw):
    """(reference logits, port logits, port batch, reference batch, port
    model, reference model) with the reference's parameters carried
    across."""
    ref_m = ref_get_model(RefConfig(**dict(SMALL, **kw)))
    ref_b = ref_m.prepare(tiny_hg)
    ref_p = ref_m.init(jax.random.key(0), ref_b)
    want = np.asarray(ref_m.forward(ref_p, ref_b))
    m = get_model(HGNNConfig(**dict(SMALL, **kw)))
    b = m.prepare(_port_hg(tiny_hg), device="cpu")
    p = interop.params_from_numpy(ref_p, device="cpu")
    return want, m.forward(p, b), b, ref_b, m, ref_m


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_rgcn_forward_matches_jax(tiny_hg, monkeypatch, layout, layers,
                                  use_pallas):
    if use_pallas:
        _force_interpret(monkeypatch)
    want, got, *_ = _both(tiny_hg, layers=layers, use_pallas=use_pallas,
                          **LAYOUTS[layout])
    assert got.shape == want.shape == (40, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("layout", ["padded", "bucketed"])
def test_rgcn_forward_matches_jax_streaming_kernel(tiny_hg, monkeypatch,
                                                   layout):
    _force_streaming(monkeypatch)
    want, got, *_ = _both(tiny_hg, layers=2, use_pallas=True,
                          **LAYOUTS[layout])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_rgcn_tables_byte_equal_to_reference(tiny_hg, layout):
    m = get_model(HGNNConfig(**SMALL, **LAYOUTS[layout]))
    ref_m = ref_get_model(RefConfig(**SMALL, **LAYOUTS[layout]))
    b = m.prepare(_port_hg(tiny_hg), device="cpu")
    ref_b = ref_m.prepare(tiny_hg)
    assert m.rel_keys == ref_m.rel_keys == sorted(tiny_hg.relations)
    assert list(b["rels"]) == list(ref_b["rels"])
    for key, ref_rel in ref_b["rels"].items():
        rel = b["rels"][key]
        assert type(rel) is type(ref_rel) and len(rel) == len(ref_rel)
        if layout == "bucketed":
            for bucket, ref_bucket in zip(rel, ref_rel):
                for t, r in zip(bucket, ref_bucket):
                    _same(t.numpy(), r)
        else:
            for t, r in zip(rel, ref_rel):
                _same(t.numpy(), r)
    for t in ref_b["feats"]:
        _same(b["feats"][t].numpy(), ref_b["feats"][t])
    assert b["counts"] == ref_b["counts"]
    assert b["feat_dims"] == ref_b["feat_dims"]
    # the degree cap bites, so the shared RNG stream is exercised
    degs = [np.diff(a.T.tocsr().indptr).max()
            for a in tiny_hg.relations.values()]
    assert max(degs) > SMALL["max_degree"]


@pytest.fixture(scope="module")
def dense_hg():
    """A tiny graph whose in-degrees pass the bucket caps' round-to of 8,
    so the bucketed layout really splits rows over several caps."""
    from repro.core.hgraph import HeteroGraph

    rng = np.random.default_rng(11)
    counts = {"M": 40, "D": 6, "A": 25}
    feats = {t: rng.standard_normal((n, 5 + len(t))).astype(np.float32)
             for t, n in counts.items()}

    def rel(ns, nd, e):
        a = sp.csr_matrix((np.ones(e, np.float32), (rng.integers(0, ns, e),
                                                    rng.integers(0, nd, e))),
                          shape=(ns, nd))
        a.data[:] = 1.0
        return a

    md, ma = rel(40, 6, 90), rel(40, 25, 70)
    g = HeteroGraph(counts, feats,
                    {("M", "md", "D"): md, ("D", "dm", "M"): md.T.tocsr(),
                     ("M", "ma", "A"): ma, ("A", "am", "M"): ma.T.tocsr()},
                    name="tiny")
    g.validate()
    return g


@pytest.mark.parametrize("use_pallas", [False, True])
def test_rgcn_bucketed_forward_with_several_caps(dense_hg, monkeypatch,
                                                 use_pallas):
    if use_pallas:
        _force_interpret(monkeypatch)
    want, got, b, *_ = _both(dense_hg, layers=2, use_pallas=use_pallas,
                             fused=True, degree_buckets=3, max_degree=12)
    caps = {nbr.shape[1] for rel in b["rels"].values() for _, nbr, _ in rel}
    assert caps == {8, 12}
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_rgcn_plan_equal_to_reference(layout, layers):
    kw = dict(SMALL, layers=layers, use_pallas=True, **LAYOUTS[layout])
    got = get_model(HGNNConfig(**kw)).plan()
    want = ref_get_model(RefConfig(**kw)).plan()
    for field in ("model", "target", "metapaths", "partition", "sample",
                  "schedule"):
        assert getattr(got, field) == getattr(want, field), field
    assert dataclasses.asdict(got.head) == dataclasses.asdict(want.head)
    assert len(got.layers) == len(want.layers) == layers
    for lp, ref_lp in zip(got.layers, want.layers):
        assert dataclasses.asdict(lp) == dataclasses.asdict(ref_lp)


def test_rgcn_port_init_mirrors_reference_tree(tiny_hg):
    """The port's own init: the reference's tree (tuple-keyed ``w_rel``,
    type-keyed ``w_self``, no hidden ``fp``), shapes and scales,
    deterministic in the generator's seed."""
    cfg = dict(SMALL, layers=2)
    ref_m = ref_get_model(RefConfig(**cfg))
    ref_p = ref_m.init(jax.random.key(0), ref_m.prepare(tiny_hg))
    m = get_model(HGNNConfig(**cfg))
    b = m.prepare(_port_hg(tiny_hg), device="cpu")
    p1 = m.init(torch.Generator().manual_seed(0), b)
    p2 = m.init(torch.Generator().manual_seed(0), b)
    flat_ref, tree_ref = jax.tree_util.tree_flatten(ref_p)
    flat1, tree1 = jax.tree_util.tree_flatten(
        p1, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert tree1 == tree_ref
    flat2 = jax.tree_util.tree_leaves(
        p2, is_leaf=lambda x: isinstance(x, torch.Tensor))
    for a, b2, r in zip(flat1, flat2, flat_ref):
        assert tuple(a.shape) == tuple(r.shape)
        assert torch.equal(a, b2)
    assert sorted(p1["w_rel"]) == sorted(tiny_hg.relations)
    assert "fp" not in p1["layers"][0]
    w = p1["w_rel"][("A", "am", "M")]
    assert 0.5 < float(w.std() * np.sqrt(16)) < 1.5  # 1/sqrt(d) scale


def test_interop_carries_tuple_keys_and_tuple_values(tiny_hg):
    ref_m = ref_get_model(RefConfig(**SMALL, **LAYOUTS["bucketed"]))
    ref_b = ref_m.prepare(tiny_hg)
    ref_p = ref_m.init(jax.random.key(0), ref_b)
    p = interop.params_from_numpy(ref_p, device="cpu")
    b = interop.batch_from_numpy(ref_b, device="cpu")
    key = ("M", "md", "D")
    assert isinstance(p["w_rel"][key], torch.Tensor)
    np.testing.assert_array_equal(p["w_rel"][key].numpy(),
                                  np.asarray(ref_p["w_rel"][key]))
    assert isinstance(b["rels"][key], list)
    assert all(isinstance(bk, tuple) and len(bk) == 3
               for bk in b["rels"][key])
    assert b["counts"] == ref_b["counts"]


def test_rgcn_cpu_forward_with_kernels_counts_no_launch(tiny_hg):
    ops.reset_launch_counts()
    m = get_model(HGNNConfig(**SMALL, layers=2, use_pallas=True))
    b = m.prepare(_port_hg(tiny_hg), device="cpu")
    m.forward(m.init(torch.Generator().manual_seed(0), b), b)
    assert set(ops.launch_counts().values()) == {0}


def test_rgcn_engine_serves_the_forward(tiny_hg):
    cfg = HGNNConfig(**SMALL, use_pallas=True, degree_buckets=3, layers=2,
                     fused=True)
    built = build_hgnn_infer(cfg, _port_hg(tiny_hg), device="cpu")
    eng = HGNNInferEngine(built.executor, built.params, built.batch,
                          fn=built.fn)
    out = eng.infer()
    assert out.shape == (40, 3) and torch.isfinite(out).all()
    assert torch.equal(out, built.executor.forward(built.params,
                                                   built.batch))
    assert built.plan.na.layout == "bucketed" and built.plan.na.use_pallas


def test_fuse_na_sa_on_rgcn_warns_and_runs_two_pass(tiny_hg):
    cfg = HGNNConfig(**SMALL, fused=True, fuse_na_sa=True)
    with pytest.warns(UserWarning, match="fuse_na_sa"):
        built = build_hgnn_infer(cfg, _port_hg(tiny_hg), device="cpu")
    assert not built.plan.sa.fuse_epilogue


# ---------------------------------------------------------------------------
# the mean-NA stages against the reference's
# ---------------------------------------------------------------------------


def _stage_case(seed, n, m, k, d):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((m, d)).astype(np.float32)
    nbr = rng.integers(0, m, (n, k)).astype(np.int32)
    mask = (rng.random((n, k)) < 0.6).astype(np.float32)
    mask[::5] = 0.0  # all-masked rows
    return h, nbr, mask


def test_mean_aggregate_padded_matches_reference():
    h, nbr, mask = _stage_case(1, 37, 20, 7, 9)
    want = np.asarray(ref_stages.mean_aggregate_padded(
        jnp.asarray(h), jnp.asarray(nbr), jnp.asarray(mask)))
    got = stages.mean_aggregate_padded(torch.from_numpy(h),
                                       torch.from_numpy(nbr),
                                       torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got[::5] == 0).all()


def test_mean_aggregate_bucketed_matches_reference():
    from repro.core import metapath as ref_mp
    from repro_torch.core import metapath as mp

    h, nbr, mask = _stage_case(2, 50, 30, 16, 8)
    mask[:, 5:] *= (np.arange(50) % 3 == 0)[:, None]  # spread the degrees
    ref_bk = ref_mp.bucket_padded(ref_mp.PaddedSubgraph(nbr, mask, ["a", "b"]),
                                  3)
    bk = mp.bucket_padded(mp.PaddedSubgraph(nbr, mask, ["a", "b"]), 3)
    assert bk.n_buckets == ref_bk.n_buckets > 1
    want = np.asarray(ref_stages.mean_aggregate_bucketed(
        jnp.asarray(h), [tuple(map(jnp.asarray, t)) for t in
                         zip(ref_bk.row_ids, ref_bk.nbr, ref_bk.mask)], 50))
    got = stages.mean_aggregate_bucketed(
        torch.from_numpy(h), [tuple(map(torch.from_numpy, t)) for t in
                              zip(bk.row_ids, bk.nbr, bk.mask)], 50)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mean_aggregate_csr_and_edges_match_reference(tiny_hg):
    adj = tiny_hg.relations[("M", "ma", "A")].T.tocsr()
    seg, idx = stages.csr_to_edges(adj.indptr, adj.indices)
    ref_seg, ref_idx = ref_stages.csr_to_edges(adj.indptr, adj.indices)
    _same(seg, ref_seg)
    _same(idx, ref_idx)
    h = np.random.default_rng(3).standard_normal((40, 6)).astype(np.float32)
    want = np.asarray(ref_stages.mean_aggregate_csr(
        jnp.asarray(h), jnp.asarray(seg), jnp.asarray(idx), 25))
    got = stages.mean_aggregate_csr(torch.from_numpy(h),
                                    torch.from_numpy(seg),
                                    torch.from_numpy(idx), 25)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("edit", [
    lambda pl: dataclasses.replace(pl, layers=tuple(
        dataclasses.replace(lp, na=dataclasses.replace(lp.na,
                                                       layout="stacked"))
        for lp in pl.layers)),
    lambda pl: dataclasses.replace(pl, layers=tuple(
        dataclasses.replace(lp, handoff="target") for lp in pl.layers)),
    lambda pl: dataclasses.replace(pl, layers=tuple(
        dataclasses.replace(lp, sa=dataclasses.replace(lp.sa,
                                                       kind="attention"))
        for lp in pl.layers)),
    lambda pl: dataclasses.replace(pl, head=dataclasses.replace(
        pl.head, kind="linear")),
])
def test_executor_refuses_rgcn_plans_outside_the_slice(edit):
    good = get_model(HGNNConfig(**SMALL, layers=2)).plan()
    StageGraphExecutor(good, HGNNConfig(**SMALL, layers=2))
    with pytest.raises(NotImplementedError, match="no model of the reference"):
        StageGraphExecutor(edit(good), HGNNConfig(**SMALL, layers=2))


def test_cli_prints_the_reference_rgcn_line_on_cpu():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--hgnn", "rgcn",
         "--dataset", "imdb", "--use-pallas", "--device", "cpu", "--iters",
         "1"],
        capture_output=True, text=True, timeout=600, env=env, cwd=root)
    assert out.returncode == 0, out.stderr
    assert ("rgcn/imdb [na=mean/padded] logits (4278, 8) on "
            "single-device:") in out.stdout
