"""Request-path neighbor sampling of the port (``serve/sampler.py``,
``plan.default_sample_ladder``, the models' ``SampleSpec``) against
``repro.serve.sampler``.

The sampler is host-side numpy, so its batches are held byte-equal to the
reference's: every array of ``SampledBatch.batch`` (dtype, shape and
bytes: int32 index tables, float32 masks and features), and
``target_rows``, ``local`` and ``meta`` equal, for HAN (stacked and
bucketed), RGCN (padded and bucketed), MAGNN and GCN, at several seeds and
at every rung of the ladder, on the tiny graph of
``tests/test_stage_pipeline.py`` (GCN: the Reddit-like graph at scale
0.005).  It also pins ROADMAP Queue 3 check (e): a repeated target id is a
second row of the local table, byte for byte as in the reference."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.configs.base import HGNNConfig as RefConfig
from repro.core import plan as ref_plan
from repro.core.hgraph import HeteroGraph as RefGraph
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro.serve.sampler import HGNNSampler as RefSampler
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph, plan
from repro_torch.core.models import get_model
from repro_torch.data import synthetic as syn
from repro_torch.serve.sampler import HGNNSampler

SMALL = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             max_degree=6, max_instances=4, fused=True)
# every sampled layout, as HGNNConfig keywords (GCN on the Reddit-like
# graph, the others on the tiny one)
VARIANTS = {
    "han-stacked": dict(model="han", fanout=3),
    "han-stacked-L2": dict(model="han", fanout=2, layers=2),
    "han-bucketed": dict(model="han", fanout=3, degree_buckets=3),
    "rgcn-padded": dict(model="rgcn", fanout=3),
    "rgcn-padded-L2": dict(model="rgcn", fanout=2, layers=2),
    "rgcn-bucketed": dict(model="rgcn", fanout=4, degree_buckets=3),
    "magnn": dict(model="magnn", fanout=2),
    "magnn-L2": dict(model="magnn", fanout=3, layers=2),
    "gcn": dict(model="gcn", dataset="reddit", fanout=3),
}


@pytest.fixture(autouse=True)
def _tiny_tables():
    for mod in (ref_syn, syn):
        for name in ("tiny", "sampt"):
            mod.DATASET_METAPATHS[name] = [["M", "D", "M"], ["M", "A", "M"]]
            mod.DATASET_TARGET[name] = "M"


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


@pytest.fixture(scope="module")
def reddit_hg():
    return ref_syn.make_reddit_like(scale=0.005)


def _samplers(hg, **kw):
    """The reference's sampler and the port's on one graph and config."""
    kw = dict(SMALL, **kw)
    ref_cfg, cfg = RefConfig(**kw), HGNNConfig(**kw)
    return (RefSampler(ref_get_model(ref_cfg).plan(), ref_cfg, hg),
            HGNNSampler(get_model(cfg).plan(), cfg, _port_hg(hg)))


def _leaves(tree, path=""):
    """``path -> leaf`` over nested dicts (tuple keys too), lists, tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{path}[{i}]"))
        return out
    return {path: tree}


def assert_same_batch(ref_sb, sb):
    """Every array byte-equal, dtypes included; every scalar equal; the
    port's arrays are CPU tensors."""
    want, got = _leaves(ref_sb.batch), _leaves(sb.batch)
    assert sorted(want) == sorted(got)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, (int, np.integer)):
            assert g == w, key
            continue
        assert torch.is_tensor(g) and g.device.type == "cpu", key
        w, g = np.asarray(w), g.numpy()
        assert (g.dtype, g.shape) == (w.dtype, w.shape), key
        assert g.tobytes() == w.tobytes(), key
    np.testing.assert_array_equal(sb.target_ids, ref_sb.target_ids)
    assert sb.target_rows.dtype == ref_sb.target_rows.dtype
    np.testing.assert_array_equal(sb.target_rows, ref_sb.target_rows)
    assert sorted(sb.local) == sorted(ref_sb.local)
    for t, ids in ref_sb.local.items():
        assert sb.local[t].dtype == ids.dtype
        np.testing.assert_array_equal(sb.local[t], ids)
    assert sb.meta == ref_sb.meta
    assert (sb.rung, sb.rung_index) == (ref_sb.rung, ref_sb.rung_index)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sampled_batches_byte_equal_to_reference(tiny_hg, reddit_hg,
                                                 variant, seed):
    """At the rung the sampler picks, at every rung forced (frontier
    truncation on the small ones), and for the all-pad warmup batch."""
    kw = VARIANTS[variant]
    hg = reddit_hg if kw.get("dataset") == "reddit" else tiny_hg
    ref_s, s = _samplers(hg, **kw)
    assert s.ladder == ref_s.ladder and s.k_eff == ref_s.k_eff
    n_t = hg.node_counts[s.target]
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, n_t, size=int(rng.integers(1, 9)))
    assert_same_batch(ref_s.sample(targets), s.sample(targets))
    for rung in range(len(s.ladder)):
        assert_same_batch(ref_s.sample(targets, rung=rung),
                          s.sample(targets, rung=rung))
        assert_same_batch(ref_s.dummy_batch(rung), s.dummy_batch(rung))
    assert_same_batch(ref_s.sample(targets, max_rung=0),
                      s.sample(targets, max_rung=0))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_identity_rung_reuses_the_full_tables(tiny_hg, reddit_hg, variant):
    """Full fan-out and an exact-size rung: every target relabels by the
    identity, byte-equal to the reference, and the index tables are the
    full graph's own (the full-fan-out parity path)."""
    kw = dict(VARIANTS[variant], fanout=4096)
    hg = reddit_hg if kw.get("dataset") == "reddit" else tiny_hg
    n = hg.node_counts["N" if kw.get("dataset") == "reddit" else "M"]
    kw["sample_ladder"] = ((n, n),)
    ref_s, s = _samplers(hg, **kw)
    ref_sb, sb = ref_s.sample(np.arange(n)), s.sample(np.arange(n))
    assert_same_batch(ref_sb, sb)
    np.testing.assert_array_equal(sb.target_rows, np.arange(n))
    assert sb.meta["truncated_rows"] == 0


def test_duplicate_targets_are_second_rows_as_in_the_reference():
    """ROADMAP Queue 3 check (e), pinned: on the reference's sampler test
    graph of seed 316 with a starved ladder, targets ``[9, 6, 6]`` give
    the local table ``M = [9, 6, 6, 0, 1, 2, 3, 4, 7, 8]``: the repeated
    id keeps a second row (the LUT maps it to the first) and costs a
    frontier row, ``truncated_rows`` 1; every target row stays real."""
    rng = np.random.default_rng(316)
    nm, nd, na = (int(rng.integers(12, 40)), int(rng.integers(5, 16)),
                  int(rng.integers(6, 20)))
    counts = {"M": nm, "D": nd, "A": na}
    feats = {t: rng.standard_normal((n, d)).astype(np.float32)
             for (t, n), d in zip(counts.items(), (6, 5, 4))}

    def rr(ns, nd_, e):
        r = rng.integers(0, ns, e)
        c = rng.integers(0, nd_, e)
        return sp.csr_matrix((np.ones(e, np.float32), (r, c)),
                             shape=(ns, nd_))

    md, ma = rr(nm, nd, 3 * nm), rr(nm, na, 3 * nm)
    hg = RefGraph(counts, feats,
                  {("M", "md", "D"): md, ("D", "dm", "M"): md.T.tocsr(),
                   ("M", "ma", "A"): ma, ("A", "am", "M"): ma.T.tocsr()},
                  name="sampt")
    targets = np.random.default_rng(316 + 1000).integers(
        0, nm, size=3).astype(np.int64)
    np.testing.assert_array_equal(targets, [9, 6, 6])
    kw = dict(model="han", dataset="sampt", hidden=8, n_heads=2,
              n_classes=3, max_degree=6, max_instances=3, fused=True,
              fanout=6, sample_ladder=((8, 10),))
    ref_cfg, cfg = RefConfig(**kw), HGNNConfig(**kw)
    ref_sb = RefSampler(ref_get_model(ref_cfg).plan(), ref_cfg,
                        hg).sample(targets)
    sb = HGNNSampler(get_model(cfg).plan(), cfg, _port_hg(hg)).sample(
        targets)
    assert_same_batch(ref_sb, sb)
    np.testing.assert_array_equal(sb.local["M"], [9, 6, 6, 0, 1, 2, 3, 4,
                                                  7, 8])
    assert sb.meta["truncated_rows"] == 1
    np.testing.assert_array_equal(sb.target_rows, [0, 1, 1])
    assert (sb.batch["row_mask"].numpy()[sb.target_rows] == 1.0).all()


@pytest.mark.parametrize("args", [
    (8, 16), (8, 16, 2), (3, 120, 4), (1, 0), (64, 128, 1, (4, 16)),
])
def test_default_sample_ladder_is_the_reference(args):
    assert plan.default_sample_ladder(*args) == \
        ref_plan.default_sample_ladder(*args)


@pytest.mark.parametrize("kw", [
    dict(model="han", fanout=8), dict(model="han", fanout=80, layers=2),
    dict(model="han", fanout=4, degree_buckets=3),
    dict(model="han", fanout=4, fuse_na_sa=True),
    dict(model="han", fanout=4, fused=False),
    dict(model="rgcn", fanout=8), dict(model="rgcn", fanout=3, layers=3),
    dict(model="magnn", fanout=8), dict(model="magnn", fanout=2, layers=2),
    dict(model="gcn", dataset="reddit", fanout=8),
    dict(model="han", fanout=4, sample_ladder=((2, 6), (4, 12))),
    dict(model="rgcn", fanout=4, cache_rows=8),
])
def test_sample_spec_is_the_reference(kw):
    """``cfg.fanout >= 1`` builds the reference's ``SampleSpec`` (fan-out,
    ladder, seed) for every model and layout; residency keeps its
    ``pin_targets``."""
    kw = dict(SMALL, **kw)
    ref_pl = ref_get_model(RefConfig(**kw)).plan()
    pl = get_model(HGNNConfig(**kw)).plan()
    assert (pl.sample.fanout, pl.sample.ladder, pl.sample.seed) == (
        ref_pl.sample.fanout, ref_pl.sample.ladder, ref_pl.sample.seed)
    if ref_pl.residency is not None:
        assert pl.residency.pin_targets == ref_pl.residency.pin_targets


def test_sampler_refusals_and_rung_choice_are_the_reference(tiny_hg):
    """No ``SampleSpec`` and HAN's ``csr`` layout are refused with the
    reference's messages; ``pick_rung`` prefers the smallest fit and
    refuses targets past every rung."""
    for kw, match in ((dict(model="han"), "SampleSpec"),
                      (dict(model="han", fused=False, fanout=4), "csr")):
        cfg = HGNNConfig(**dict(SMALL, **kw))
        with pytest.raises(ValueError, match=match):
            HGNNSampler(get_model(cfg).plan(), cfg, _port_hg(tiny_hg))
    _, s = _samplers(tiny_hg, model="han", fanout=2,
                     sample_ladder=((2, 8), (4, 16), (8, 64)))
    assert s.pick_rung(1, {"M": 3}) == 0
    assert s.pick_rung(3, {"M": 3}) == 1
    assert s.pick_rung(1, {"M": 12}) == 1
    assert s.pick_rung(8, {"M": 200}) == 2
    assert s.pick_rung(1, {"M": 200}, max_rung=1) == 1
    with pytest.raises(ValueError, match="overflow"):
        s.pick_rung(9, {"M": 1})
    with pytest.raises(ValueError, match="out of range"):
        s.sample(np.array([40]))
