"""Host graph build of the port (``core/hgraph.py``, ``data/synthetic.py``,
``core/metapath.py``, HAN's ``prepare``): every array byte-equal to the
reference's on the same graph and seed."""
import numpy as np
import pytest

from repro.core import hgraph as ref_hgraph
from repro.core import metapath as ref_mp
from repro.data import synthetic as ref_syn
from repro_torch.core import hgraph, metapath as mp
from repro_torch.data import synthetic as syn


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


def _same_graph(g, r):
    assert g.name == r.name and g.node_counts == r.node_counts
    assert sorted(g.features) == sorted(r.features)
    for t in r.features:
        _same(g.features[t], r.features[t])
    assert list(g.relations) == list(r.relations)
    for key, a in r.relations.items():
        b = g.relations[key]
        assert b.shape == a.shape
        _same(b.indptr, a.indptr)
        _same(b.indices, a.indices)
        _same(b.data, a.data)


@pytest.fixture(scope="module")
def imdb_pair():
    return syn.make_dataset("imdb"), ref_syn.make_dataset("imdb")


def test_make_dataset_imdb_byte_equal(imdb_pair):
    _same_graph(*imdb_pair)


def test_make_dataset_acm_byte_equal():
    _same_graph(syn.make_dataset("acm", seed=1),
                ref_syn.make_dataset("acm", seed=1))


def test_dataset_tables_equal():
    # the built-in datasets only: tests register small graphs of their own
    for name in ("imdb", "acm", "dblp", "reddit"):
        assert syn.DATASET_TARGET[name] == ref_syn.DATASET_TARGET[name]
        assert syn.DATASET_METAPATHS[name] == ref_syn.DATASET_METAPATHS[name]


def test_build_padded_and_stack_imdb_byte_equal(imdb_pair):
    g, r = imdb_pair
    paths = ref_syn.DATASET_METAPATHS["imdb"]
    rng_p, rng_r = np.random.default_rng(0), np.random.default_rng(0)
    subs = [mp.build_padded(g, p, 64, rng_p) for p in paths]
    refs = [ref_mp.build_padded(r, p, 64, rng_r) for p in paths]
    for s, t in zip(subs, refs):
        _same(s.nbr, t.nbr)
        _same(s.mask, t.mask)
        assert s.node_path == t.node_path
    for got, want in zip(mp.stack_padded(subs), ref_mp.stack_padded(refs)):
        _same(got, want)


@pytest.mark.parametrize("path", [["M", "D", "M"], ["M", "A", "M"],
                                  ["D", "M", "D"], ["A", "M", "A"]])
@pytest.mark.parametrize("k", [2, 6, 48])
def test_build_padded_tiny_byte_equal(tiny_hg, path, k):
    rng_p, rng_r = np.random.default_rng(5), np.random.default_rng(5)
    got = mp.build_padded(_port_hg(tiny_hg), path, k, rng_p)
    want = ref_mp.build_padded(tiny_hg, path, k, rng_r)
    _same(got.nbr, want.nbr)
    _same(got.mask, want.mask)


def test_stack_padded_uneven_caps_tiny(tiny_hg):
    """Subgraphs with different K caps stack to [P, N, Kmax] alike."""
    g = _port_hg(tiny_hg)
    subs = [mp.build_padded(g, ["M", "D", "M"], 3),
            mp.build_padded(g, ["M", "A", "M"], 7)]
    refs = [ref_mp.build_padded(tiny_hg, ["M", "D", "M"], 3),
            ref_mp.build_padded(tiny_hg, ["M", "A", "M"], 7)]
    for got, want in zip(mp.stack_padded(subs), ref_mp.stack_padded(refs)):
        _same(got, want)


@pytest.mark.parametrize("path", [["M", "D", "M"], ["M", "A", "M"]])
def test_csr_buckets_instances_tiny_byte_equal(tiny_hg, path):
    g = _port_hg(tiny_hg)
    got, want = mp.build_csr(g, path), ref_mp.build_csr(tiny_hg, path)
    _same(got.indptr, want.indptr)
    _same(got.indices, want.indices)
    b_got = mp.build_degree_bucketed(g, path, 16, 3)
    b_want = ref_mp.build_degree_bucketed(tiny_hg, path, 16, 3)
    assert b_got.n_buckets == b_want.n_buckets
    for i in range(b_want.n_buckets):
        _same(b_got.row_ids[i], b_want.row_ids[i])
        _same(b_got.nbr[i], b_want.nbr[i])
        _same(b_got.mask[i], b_want.mask[i])
    i_got = mp.enumerate_instances(g, path, 4, 3)
    i_want = ref_mp.enumerate_instances(tiny_hg, path, 4, 3)
    _same(i_got.nodes, i_want.nodes)
    _same(i_got.mask, i_want.mask)


def test_metapath_adjacency_and_sparsity_tiny(tiny_hg):
    g = _port_hg(tiny_hg)
    for path in (["M", "D", "M"], ["M", "A", "M", "D", "M"]):
        a = hgraph.metapath_adjacency(g, path)
        b = ref_hgraph.metapath_adjacency(tiny_hg, path)
        _same(a.indptr, b.indptr)
        _same(a.indices, b.indices)
        assert hgraph.sparsity(a) == ref_hgraph.sparsity(b)
    assert g.n_edges == tiny_hg.n_edges
