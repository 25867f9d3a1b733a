"""Single-device hot-feature residency of the port (``core/residency.py``,
the finalize hook of ``PlannedModel``, the executor's ``_res_pool`` arm
and MAGNN's ``cached_gather`` arm) against ``repro.core.residency``.

Host tables (hot sets, LUTs, remapped index tables) and counters are held
byte-equal; on synthetic IMDB, at ``benchmarks/bench_residency.py``'s own
config, the counters equal ``BENCH_hgnn.json``'s ``residency`` section
(read only).  The cache section holds bitwise copies of the hot rows, so
cached and uncached logits are held bitwise equal (ROADMAP invariant 3)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.base import HGNNConfig as RefConfig
from repro.core import residency as ref_rsd
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph, residency
from repro_torch.core.models import get_model
from repro_torch.data import synthetic as syn
from repro_torch.launch.serve import build_hgnn_infer

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             attn_hidden=8, max_degree=6, max_instances=4, fused=True)
# every layout of every ported model, as HGNNConfig keywords (GCN runs on
# the Reddit-like graph, the others on the tiny one)
VARIANTS = {
    "han": dict(model="han"),
    "han-fused": dict(model="han", fuse_na_sa=True),
    "han-csr": dict(model="han", fused=False),
    "han-bucketed": dict(model="han", degree_buckets=3, max_degree=16),
    "rgcn-padded": dict(model="rgcn"),
    "rgcn-bucketed": dict(model="rgcn", degree_buckets=3),
    "rgcn-csr": dict(model="rgcn", fused=False),
    "magnn": dict(model="magnn"),
    "gcn": dict(model="gcn", dataset="reddit"),
}


@pytest.fixture(autouse=True)
def _tiny_tables():
    for mod in (ref_syn, syn):
        mod.DATASET_METAPATHS["tiny"] = [["M", "D", "M"], ["M", "A", "M"]]
        mod.DATASET_TARGET["tiny"] = "M"


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


@pytest.fixture(scope="module")
def reddit_hg():
    return ref_syn.make_reddit_like(scale=0.005)


@pytest.fixture
def graph_of(tiny_hg, reddit_hg):
    """The reference's graph a variant runs on."""
    return lambda variant: (reddit_hg if VARIANTS[variant].get("dataset")
                            == "reddit" else tiny_hg)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_tree(port, ref):
    """Tensors of the port's batch byte-equal to the reference's arrays,
    structure and Python scalars equal."""
    if isinstance(ref, dict):
        assert sorted(port, key=str) == sorted(ref, key=str)
        for k in ref:
            _same_tree(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert type(port) is type(ref) and len(port) == len(ref)
        for a, b in zip(port, ref):
            _same_tree(a, b)
    elif isinstance(port, torch.Tensor):
        _same(port.numpy(), ref)
    else:
        assert port == ref


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cached_batch_byte_equal_to_reference(graph_of, variant):
    """Hot sets, remapped tables and counters after the finalize hook."""
    kw = dict(SMALL, **VARIANTS[variant], cache_rows=5)
    hg = graph_of(variant)
    ref_b = ref_get_model(RefConfig(**kw)).prepare(hg)
    b = get_model(HGNNConfig(**kw)).prepare(_port_hg(hg), device="cpu")
    assert ref_b["residency"]["counters"]["hits"] > 0
    _same_tree(b, ref_b)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tables_equal_to_reference(graph_of, variant):
    """``build_tables`` on the uncached host tables: hot sets, ranks, LUTs
    and reference counts; then ``_count_hits``."""
    kw = dict(SMALL, **VARIANTS[variant])
    hg = graph_of(variant)
    ref_m = ref_get_model(RefConfig(**kw, cache_rows=7))
    ref_b = ref_get_model(RefConfig(**kw)).prepare(hg)
    m = get_model(HGNNConfig(**kw, cache_rows=7))
    host = get_model(HGNNConfig(**kw)).prepare(_port_hg(hg), device="cpu")
    want = ref_rsd.build_tables(ref_m.plan(), ref_b)
    got = residency.build_tables(m.plan(), host)
    assert got.populations == want.populations
    assert got.cache_rows == want.cache_rows == 7
    for field in ("hot", "rank", "lut", "counts"):
        mine, theirs = getattr(got, field), getattr(want, field)
        assert sorted(mine) == sorted(theirs)
        for t in theirs:
            _same(mine[t], theirs[t])
    assert residency._count_hits(m.plan(), host, got) == \
        ref_rsd._count_hits(ref_m.plan(), ref_b, want)


def test_hot_set_order_matches_reference():
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 5, 200)
    for cap in (0, 1, 17, 200, 500):
        _same(residency.hot_set(counts, cap), ref_rsd.hot_set(counts, cap))


@pytest.fixture(scope="module")
def imdb():
    return syn.make_dataset("imdb")


@pytest.mark.parametrize("c", [64, 256, 1024])
@pytest.mark.parametrize("model", ["han", "rgcn"])
def test_imdb_counters_equal_the_bench_record(imdb, model, c):
    """``benchmarks/bench_residency.py``'s config (hidden 64, 8 heads,
    ``max_degree`` 32, ``fused``); ``BENCH_hgnn.json`` is only read."""
    rec = json.loads((ROOT / "BENCH_hgnn.json").read_text())[
        "residency"][f"{model}/imdb/c{c}"]
    cfg = HGNNConfig(model=model, dataset="imdb", hidden=64, n_heads=8,
                     n_classes=8, max_degree=32, fused=True, cache_rows=c)
    ct = get_model(cfg).prepare(imdb, device="cpu")["residency"]["counters"]
    assert {k: ct[k] for k in ("hits", "misses", "rows", "cache_rows")} == \
        {k: rec[k] for k in ("hits", "misses", "rows", "cache_rows")}
    assert all(type(v) is int for v in ct.values())


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cached_logits_bitwise_equal_uncached(graph_of, variant, use_pallas,
                                              layers):
    kw = dict(SMALL, **VARIANTS[variant], use_pallas=use_pallas,
              layers=layers)
    outs = []
    for c in (0, 5):
        built = build_hgnn_infer(HGNNConfig(**kw, cache_rows=c),
                                 _port_hg(graph_of(variant)), device="cpu")
        assert ("residency" in built.batch) == bool(c)
        with torch.inference_mode():
            outs.append(built.fn(built.params, built.batch))
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])
