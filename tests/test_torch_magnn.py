"""The port's third slice end to end: MAGNN full-graph inference
(``core/models/magnn.py``, the instance-NA / list-SA / ``target+carry``
arms of ``core/pipeline.py``, ``rotate_encoder`` and
``instance_aggregate``, ``launch/serve.py``) against the JAX forward with
the reference's own parameters carried across, with and without
single-device residency.

Each arm of the port is held to the same arm of the JAX package: the plain
arm to its ``instance_aggregate``, the kernel arm to its
``ops.gat_aggregate`` over the encoded instances (which runs ``ref.gat_na``
on the CPU, or the Pallas kernel in interpret mode when forced).  The two
arms differ from each other by up to 3e-4
(``tests/test_pallas_model_equivalence.py``), so they are never compared
with each other here.

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
import torch

from repro.configs.base import HGNNConfig as RefConfig
from repro.core import stages as ref_stages
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph, plan, stages
from repro_torch.core.models import get_model
from repro_torch.core.pipeline import StageGraphExecutor
from repro_torch.data import synthetic as syn
from repro_torch.kernels import feature_cache as tfc
from repro_torch.kernels import gat_na as tgat
from repro_torch.kernels import ops

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(model="magnn", dataset="tiny", hidden=16, n_heads=4,
             n_classes=3, attn_hidden=8, max_instances=4)


@pytest.fixture(autouse=True)
def _tiny_tables():
    for mod in (ref_syn, syn):
        mod.DATASET_METAPATHS["tiny"] = [["M", "D", "M"], ["M", "A", "M"]]
        mod.DATASET_TARGET["tiny"] = "M"


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


def _both(tiny_hg, **kw):
    """(reference logits, port logits, port batch, reference batch) with
    the reference's parameters carried across."""
    ref_m = ref_get_model(RefConfig(**dict(SMALL, **kw)))
    ref_b = ref_m.prepare(tiny_hg)
    ref_p = ref_m.init(jax.random.key(0), ref_b)
    want = np.asarray(ref_m.forward(ref_p, ref_b))
    m = get_model(HGNNConfig(**dict(SMALL, **kw)))
    b = m.prepare(_port_hg(tiny_hg), device="cpu")
    p = interop.params_from_numpy(ref_p, device="cpu")
    return want, m.forward(p, b), b, ref_b


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("cache_rows", [0, 3])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
def test_magnn_forward_matches_jax(tiny_hg, layers, use_pallas, cache_rows):
    want, got, b, _ = _both(tiny_hg, layers=layers, use_pallas=use_pallas,
                            cache_rows=cache_rows)
    assert got.shape == want.shape == (40, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert ("residency" in b) == bool(cache_rows)


def _force_interpret(monkeypatch, name):
    orig = getattr(jops, name)
    monkeypatch.setattr(
        jops, name,
        lambda *args, use_pallas=False, interpret=False, **kw:
        orig(*args, use_pallas=True, interpret=True, **kw))


def test_magnn_kernel_arm_matches_the_pallas_kernels(tiny_hg, monkeypatch):
    """The JAX side forced into its Pallas ``gat_na`` and
    ``cached_gather`` in interpret mode."""
    _force_interpret(monkeypatch, "gat_aggregate")
    _force_interpret(monkeypatch, "cached_gather")
    want, got, *_ = _both(tiny_hg, layers=2, use_pallas=True, cache_rows=3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("max_instances", [4, 16])
def test_instance_tables_byte_equal_to_reference(tiny_hg, max_instances):
    *_, b, ref_b = _both(tiny_hg, max_instances=max_instances)
    assert len(b["instances"]) == len(ref_b["instances"]) == 2
    for (nodes, mask), (ref_nodes, ref_mask) in zip(b["instances"],
                                                    ref_b["instances"]):
        _same(nodes.numpy(), ref_nodes)
        _same(mask.numpy(), ref_mask)
    for t in ref_b["feats"]:
        _same(b["feats"][t].numpy(), ref_b["feats"][t])
    assert b["feat_dims"] == ref_b["feat_dims"]
    assert b["n_nodes"] == ref_b["n_nodes"] == 40


def test_imdb_instance_tables_byte_equal_to_reference():
    """Synthetic IMDB at the default ``max_instances`` 16: the reservoir
    sampling runs one RNG over both metapaths (host numpy only)."""
    cfg = dict(model="magnn", dataset="imdb")
    ref_b = ref_get_model(RefConfig(**cfg)).prepare(
        ref_syn.make_dataset("imdb"))
    b = get_model(HGNNConfig(**cfg)).prepare(syn.make_dataset("imdb"),
                                             device="cpu")
    for (nodes, mask), (ref_nodes, ref_mask) in zip(b["instances"],
                                                    ref_b["instances"]):
        assert nodes.shape == (4278, 16, 3)
        _same(nodes.numpy(), ref_nodes)
        _same(mask.numpy(), ref_mask)


def test_rotate_encoder_and_instance_aggregate_match_jax():
    rng = np.random.default_rng(5)
    f32 = np.float32
    for l in (1, 2, 3):
        h_path = rng.standard_normal((13, 4, l, 2, 6)).astype(f32)
        want = np.asarray(ref_stages.rotate_encoder(jnp.asarray(h_path)))
        got = stages.rotate_encoder(torch.from_numpy(h_path))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    enc = rng.standard_normal((13, 4, 2, 6)).astype(f32)
    h_tgt = rng.standard_normal((13, 2, 6)).astype(f32)
    mask = (rng.random((13, 4)) < 0.6).astype(f32)
    mask[[0, 7]] = 0.0
    p = {"a_dst": rng.standard_normal((2, 6)).astype(f32),
         "a_src": rng.standard_normal((2, 6)).astype(f32)}
    want = np.asarray(ref_stages.instance_aggregate(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h_tgt),
        jnp.asarray(enc), jnp.asarray(mask)))
    got = stages.instance_aggregate(
        {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(h_tgt), torch.from_numpy(enc),
        torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.all(got.numpy()[[0, 7]] == 0.0)


@pytest.mark.parametrize("cache_rows", [0, 3])
@pytest.mark.parametrize("layers", [1, 2])
def test_kernel_arm_calls_each_kernel_wrapper_per_layer(tiny_hg, monkeypatch,
                                                        layers, cache_rows):
    """On the CPU the wrappers run their plain versions and launch nothing;
    the calls they receive are the launches a card would make: ``gat_na``
    once a metapath a layer, ``cached_gather`` once a hot instance
    position a layer (all three types are hot: 2 metapaths x 3
    positions)."""
    calls = {"gat_na": 0, "cached_gather": 0}

    def spy(mod, name):
        orig = getattr(mod, name)

        def counted(*args, **kw):
            calls[name] += 1
            return orig(*args, **kw)
        monkeypatch.setattr(mod, name, counted)

    spy(tgat, "gat_na")
    spy(tfc, "cached_gather")
    ops.reset_launch_counts()
    _both(tiny_hg, layers=layers, use_pallas=True, cache_rows=cache_rows)
    assert calls == {"gat_na": 2 * layers,
                     "cached_gather": 6 * layers if cache_rows else 0}
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("layers", [1, 2])
def test_magnn_plan_equal_to_reference(layers):
    kw = dict(SMALL, layers=layers, use_pallas=True, cache_rows=3)
    got = get_model(HGNNConfig(**kw)).plan()
    want = ref_get_model(RefConfig(**kw)).plan()
    for field in ("model", "target", "metapaths", "partition", "sample",
                  "schedule"):
        assert getattr(got, field) == getattr(want, field), field
    assert dataclasses.asdict(got.head) == dataclasses.asdict(want.head)
    for lp, ref_lp in zip(got.layers, want.layers):
        assert dataclasses.asdict(lp) == dataclasses.asdict(ref_lp)
    assert got.layers[0].carry == ("A", "D")


def test_magnn_port_init_mirrors_reference_tree(tiny_hg):
    """The port's own init: the reference's tree (per-metapath ``att``
    list, per-type hidden ``fp``), shapes, deterministic in the seed."""
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
    assert sorted(p1["layers"][0]["fp"]) == ["A", "D", "M"]


def test_executor_accepts_magnn_and_runs_it(tiny_hg):
    cfg = HGNNConfig(**SMALL, layers=2, use_pallas=True, cache_rows=3)
    m = get_model(cfg)
    StageGraphExecutor(m.plan(), cfg)
    b = m.prepare(_port_hg(tiny_hg), device="cpu")
    out = m.forward(m.init(torch.Generator().manual_seed(1), b), b)
    assert out.shape == (40, 3) and torch.isfinite(out).all()


def _layers(pl, **kw):
    return dataclasses.replace(pl, layers=tuple(
        dataclasses.replace(lp, **kw) for lp in pl.layers))


@pytest.mark.parametrize("edit,match", [
    (lambda pl: dataclasses.replace(pl, partition=plan.PartitionSpec(k=2)),
     "item 12"),
    (lambda pl: dataclasses.replace(pl, sample=plan.SampleSpec(
        fanout=2, ladder=((8, 8),))), "item 13"),
    (lambda pl: dataclasses.replace(pl, schedule=plan.ScheduleSpec()),
     "item 14"),
    (lambda pl: dataclasses.replace(
        _layers(pl, residency=plan.ResidencySpec(cache_rows=3)),
        partition=plan.PartitionSpec(k=2)), "residency .*item 12"),
    (lambda pl: _layers(pl, handoff="target"), "no model of the reference"),
    (lambda pl: _layers(pl, sa=plan.SASpec(kind="attention", stacked=True)),
     "no model of the reference"),
    (lambda pl: _layers(pl, fp=plan.FPSpec(kind="dense")),
     "no model of the reference"),
    (lambda pl: dataclasses.replace(pl, head=plan.HeadSpec(
        kind="select_linear", target="M")), "no model of the reference"),
])
def test_executor_refuses_magnn_plans_outside_the_slice(edit, match):
    cfg = HGNNConfig(**SMALL, layers=2)
    good = get_model(cfg).plan()
    StageGraphExecutor(good, cfg)
    with pytest.raises(NotImplementedError, match=match):
        StageGraphExecutor(edit(good), cfg)


@pytest.mark.parametrize("kw,item", [
    (dict(partitions=2), "item 12"),
    (dict(fanout=4), "item 13"),
    (dict(overlap=2), "item 14"),
])
def test_magnn_modes_outside_the_slice_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        get_model(HGNNConfig(**dict(SMALL, **kw))).plan()


def test_cli_prints_the_reference_magnn_lines_on_cpu():
    """The logits line, and the residency counters of the reference's own
    tables for the same flags."""
    cfg = RefConfig(model="magnn", dataset="imdb", fused=True,
                    use_pallas=True, cache_rows=256)
    ref_b = ref_get_model(cfg).prepare(ref_syn.make_dataset("imdb"))
    ct = ref_b["residency"]["counters"]
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--hgnn", "magnn",
         "--dataset", "imdb", "--use-pallas", "--cache-rows", "256",
         "--device", "cpu", "--iters", "1"],
        capture_output=True, text=True, timeout=600, env=env, cwd=root)
    assert out.returncode == 0, out.stderr
    assert ("magnn/imdb [na=instance/instances] logits (4278, 8) on "
            "single-device:") in out.stdout
    assert (f"  residency: cache_rows={ct['cache_rows']} hits={ct['hits']} "
            f"misses={ct['misses']} rows={ct['rows']} "
            f"hit_rate={ct['hits'] / ct['rows']:.3f}") in out.stdout
