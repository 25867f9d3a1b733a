"""The port's host-side partitioner (``repro_torch/dist/partition.py``)
against ``repro.dist.partition``: every array that the partitioner makes
is byte-equal to the reference's (ownership, the inverse permutation, the
halo maps, the relabeled neighbour, relation and instance tables, the
static-shape pads, the owned feature shards), the residency overlay is
too, ``gather_halo`` is the flat gather, ``surviving_partition_spec``
raises as the reference does, and the counters of ``BENCH_hgnn.json``'s
``partition`` and ``layers/*/halo`` rows and of its failover row come out
exactly on the full-size synthetic IMDB.

Stability: every input comes from a fixed numpy seed or a fixed graph;
no wall clock is read, no process group, socket or subprocess is made;
the dataset registries of both packages are touched only through
``monkeypatch``."""
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import HGNNConfig as RefConfig
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro.dist import partition as ref_dp
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import characterize as ch
from repro_torch.core import hgraph
from repro_torch.core.models import get_model
from repro_torch.core.pipeline import _to_device
from repro_torch.data import synthetic as syn
from repro_torch.dist import partition as dp
from repro_torch.launch.serve import request_queue
from repro_torch.serve.engine import HGNNServeEngine
from repro_torch.serve.faults import Fault, FaultInjector
from repro_torch.serve.sampler import HGNNSampler

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             max_degree=6, max_instances=4, fused=True)
# the reference bench's settings (benchmarks/bench_partition.py,
# bench_layers.py, bench_resilience.py)
BENCH = dict(dataset="imdb", hidden=64, n_heads=8, n_classes=8,
             max_degree=32, fused=True)


@pytest.fixture(autouse=True)
def _tiny_tables(monkeypatch):
    for mod in (ref_syn, syn):
        monkeypatch.setitem(mod.DATASET_METAPATHS, "tiny",
                            [["M", "D", "M"], ["M", "A", "M"]])
        monkeypatch.setitem(mod.DATASET_TARGET, "tiny", "M")


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_tree(got, want, path="batch"):
    """Equal structure, and every array of equal dtype, shape and bytes;
    Python scalars equal."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, (int, float, str)):
        assert got == want, path
    else:
        g, w = _np(got), np.asarray(want)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), path
        assert g.tobytes() == w.tobytes(), path


def _both(hg, **kw):
    """(reference batch, port batch) of one config, prepared on the host."""
    ref_b = ref_get_model(RefConfig(**dict(SMALL, **kw))).prepare(hg)
    b = get_model(HGNNConfig(**dict(SMALL, **kw))).prepare(_port_hg(hg),
                                                            device="cpu")
    return ref_b, b


# ---------------------------------------------------------------------------
# assignment primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(40, 4), (17, 4), (5, 8), (0, 2)])
def test_assignment_primitives_equal_the_reference(n, k):
    rng = np.random.default_rng(n + k)
    neigh = [rng.integers(0, max(n, 1), rng.integers(0, 6)).astype(np.int64)
             for _ in range(n)]
    owner = dp.edge_cut_assign(neigh, max(n, 1), k)
    _same_tree(owner, ref_dp.edge_cut_assign(neigh, max(n, 1), k))
    if n:
        assert np.bincount(owner, minlength=k).max() <= -(-n // k)
    votes = rng.integers(0, 4, (n, k)).astype(np.float64)
    _same_tree(dp.reference_assign(votes, k), ref_dp.reference_assign(
        votes, k))
    for pad in (0, -(-n // k) + 2):
        tp = dp.build_type_partition(owner, k, pad_to=pad)
        ref_tp = ref_dp.build_type_partition(owner, k, pad_to=pad)
        for field in ("owner", "local", "own", "own_mask", "flat"):
            _same_tree(getattr(tp, field), getattr(ref_tp, field), field)
        refs = [rng.integers(0, max(n, 1), 7) if n else np.zeros(0, np.int64)
                for _ in range(k)]
        for h_pad in (0, n):
            got = dp.build_halo(tp, refs, k, pad_to=h_pad)
            want = ref_dp.build_halo(ref_tp, refs, k, pad_to=h_pad)
            _same_tree(got[:2], want[:2])
            _same_tree(got[2], want[2])
            _same_tree(dp.local_lut(tp, got[2], k),
                       ref_dp.local_lut(ref_tp, want[2], k))


# ---------------------------------------------------------------------------
# partitioned batches, byte-equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,kw", [
    ("han", dict(partitions=1)),
    ("han", dict(partitions=3)),
    ("rgcn", dict(partitions=3)),             # relations into the target
    ("rgcn", dict(partitions=3, layers=2)),   # every relation, every type
    ("magnn", dict(partitions=3)),
    ("han", dict(partitions=3, cache_rows=6)),
    ("rgcn", dict(partitions=4, cache_rows=6, layers=2)),
    ("magnn", dict(partitions=3, cache_rows=6))])
def test_partitioned_batches_byte_equal_to_the_reference(tiny_hg, model, kw):
    ref_b, b = _both(tiny_hg, model=model, **kw)
    _same_tree(b, ref_b)
    if kw["partitions"] > 1:
        assert b["part"]["meta"]["cut_edges"] > 0


@pytest.mark.parametrize("model,layers", [("han", 1), ("rgcn", 1),
                                          ("rgcn", 2), ("magnn", 1)])
def test_static_shape_pads_byte_equal_to_the_reference(tiny_hg, model,
                                                       layers):
    """``static_shapes``: ``ceil(n / k)`` owned rows and ``n`` halo rows a
    type, whatever the assignment."""
    kw = dict(SMALL, model=model, layers=layers, partitions=3)
    ref_m, m = ref_get_model(RefConfig(**kw)), get_model(HGNNConfig(**kw))
    ref_plan = ref_m.plan()
    ref_plan = dataclasses.replace(ref_plan, partition=dataclasses.replace(
        ref_plan.partition, static_shapes=True))
    pl = m.plan()
    pl = dataclasses.replace(pl, partition=dataclasses.replace(
        pl.partition, static_shapes=True))
    kw.pop("partitions")
    ref_flat = ref_get_model(RefConfig(**kw)).prepare(tiny_hg)
    flat = get_model(HGNNConfig(**kw)).prepare(_port_hg(tiny_hg),
                                               device="cpu")
    want = ref_dp.partition_batch(ref_plan, ref_flat)
    got = dp.partition_batch(pl, flat)
    _same_tree(got, want)
    for ty, own in got["part"]["own"].items():
        n_ty = tiny_hg.node_counts[ty]
        assert own.shape == (3, -(-n_ty // 3))
        assert got["part"]["halo_src"][ty].shape == (3, n_ty)


def test_partition_batch_rejects_layouts_without_relabeling(tiny_hg):
    from repro_torch.core.plan import PartitionSpec

    m = get_model(HGNNConfig(**dict(SMALL, model="han", degree_buckets=3)))
    pl = dataclasses.replace(m.plan(), partition=PartitionSpec(k=2))
    batch = m.prepare(_port_hg(tiny_hg), device="cpu")
    with pytest.raises(ValueError, match="no per-partition relabeling"):
        dp.partition_batch(pl, batch)
    with pytest.raises(ValueError, match="stacked layout"):
        get_model(HGNNConfig(**dict(SMALL, model="han", degree_buckets=3,
                                    partitions=2))).plan()
    with pytest.raises(ValueError, match="padded per-relation"):
        get_model(HGNNConfig(**dict(SMALL, model="rgcn", fused=False,
                                    partitions=2))).plan()
    with pytest.raises(ValueError, match="no partitioned execution"):
        get_model(HGNNConfig(model="gcn", dataset="reddit",
                             partitions=2)).plan()


# ---------------------------------------------------------------------------
# the halo gather, failover specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tail", [(), (8,), (4, 2)])
def test_gather_halo_is_the_flat_gather(tail):
    rng = np.random.default_rng(3)
    k, n, h = 4, 6, 5
    h_own = rng.standard_normal((k, n) + tail).astype(np.float32)
    halo_src = rng.integers(0, k * n, (k, h)).astype(np.int32)
    want = h_own.reshape((k * n,) + tail)[halo_src]
    got = dp.gather_halo(torch.from_numpy(h_own), torch.from_numpy(halo_src))
    _same_tree(got, want)
    ref = np.asarray(ref_dp.gather_halo(jax.numpy.asarray(h_own),
                                        jax.numpy.asarray(halo_src)))
    _same_tree(got, ref)


def test_gather_halo_empty_halo():
    h_own = torch.ones((2, 3, 4))
    empty = torch.zeros((2, 0), dtype=torch.int32)
    assert dp.gather_halo(h_own, empty).shape == (2, 0, 4)


def test_surviving_partition_spec_matches_the_reference():
    from repro.core.plan import PartitionSpec as RefSpec
    from repro_torch.core.plan import PartitionSpec

    spec, ref_spec = PartitionSpec(k=4, static_shapes=True), RefSpec(
        k=4, static_shapes=True)
    for failed in ([1], [0, 3], [2, 2]):
        got = dp.surviving_partition_spec(spec, failed)
        want = ref_dp.surviving_partition_spec(ref_spec, failed)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for failed, err, match in (([4], ValueError, r"\[4\] out of range"),
                               ([-1], ValueError, "out of range"),
                               ([0, 1, 2, 3], RuntimeError, "no surviving")):
        with pytest.raises(err, match=match):
            dp.surviving_partition_spec(spec, failed)
        with pytest.raises(err, match=match):
            ref_dp.surviving_partition_spec(ref_spec, failed)


# ---------------------------------------------------------------------------
# BENCH_hgnn.json's rows, exactly, on the full-size synthetic IMDB
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def imdb():
    """The full-size synthetic IMDB, its unpartitioned HAN and RGCN batches
    at the bench's settings, and their FP outputs at K = 1 (a halo row is
    priced at the projected width)."""
    hg = syn.make_dataset("imdb")
    out = {"hg": hg}
    for model in ("han", "rgcn"):
        m = get_model(HGNNConfig(model=model, **BENCH))
        batch = m.prepare(hg, device="cpu")
        params = m.init(torch.Generator().manual_seed(0), batch)
        out[model] = (m, batch, params)
    return out


def _bench():
    return json.loads((ROOT / "BENCH_hgnn.json").read_text())


def _traffic(imdb, model, k, layers=1):
    m, batch, params = imdb[model]
    cfg = HGNNConfig(model=model, partitions=k, layers=layers, **BENCH)
    mk = get_model(cfg)
    part = _to_device(dp.partition_batch(mk.plan(), batch),
                      torch.device("cpu"))
    with torch.inference_mode():
        h_own = mk.executor.fp(params, part)
    return ch.partition_traffic(part["part"], h_own, layers=layers)


@pytest.mark.parametrize("model", ["han", "rgcn"])
def test_partition_rows_of_bench_hgnn_json(imdb, model):
    want = _bench()["partition"]
    for k in (1, 2, 4):
        tr = _traffic(imdb, model, k)
        row = want[f"{model}/imdb/k{k}"]
        got = {"cut_edges": tr["cut_edges"],
               "cut_ratio": round(tr["cut_ratio"], 4),
               "halo_rows": tr["halo_rows"], "halo_bytes": tr["halo_bytes"]}
        assert got == {key: row[key] for key in got}, (model, k)


@pytest.mark.parametrize("model", ["han", "rgcn"])
def test_layers_halo_rows_of_bench_hgnn_json(imdb, model):
    """K = 4; the halo maps are graph-invariant, so an L-layer stack
    exchanges halo_bytes x L (RGCN relabels every relation once L > 1)."""
    want = _bench()["layers"]
    for depth in (1, 2, 3):
        tr = _traffic(imdb, model, 4, layers=depth)
        row = want[f"{model}/imdb/L{depth}"]["halo"]
        got = {"k": float(tr["k"]), "layers": float(tr["layers"]),
               "halo_bytes": tr["halo_bytes"],
               "halo_bytes_total": tr["halo_bytes_total"],
               "cut_edges": float(tr["cut_edges"])}
        assert got == row, (model, depth)


def test_failover_row_of_bench_hgnn_json(imdb):
    """``benchmarks/bench_resilience.py``'s failover case: HAN/imdb at fan-out
    8 and K = 3 loses partition 0 at step 3; 32 requests (8 slots of 4
    targets, ids below 48) all come back, each bitwise the never-failed
    serve's logits."""
    cfg = HGNNConfig(model="han", fanout=8, partitions=3, **BENCH)
    m = get_model(cfg)
    _, batch, params = imdb["han"]
    sampler = HGNNSampler(m.plan(), cfg, imdb["hg"])
    runs = []
    for inj in (FaultInjector([Fault(step=3, kind="partition", partition=0)]),
                None):
        eng = HGNNServeEngine(m.executor, params, sampler, slots=8,
                              slot_targets=4, injector=inj)
        eng.warmup()
        reqs = request_queue(sampler.n_target_type, 4, 32, pool=48)
        eng.serve(reqs)
        runs.append((eng, reqs))
    (eng, reqs), (_, never) = runs
    st = eng.stats()
    rs = st["resilience"]
    got = {"bitexact": int(all(np.array_equal(a.logits, b.logits)
                               for a, b in zip(reqs, never))),
           "ok_requests": rs["ok_requests"],
           "partition_failovers": rs["partition_failovers"],
           "requests": len(reqs), "steps": st["steps"],
           "surviving_k": eng._serve_plan.partition.k}
    want = _bench()["resilience"]["han/imdb/failover"]
    assert got == {key: want[key] for key in got}
    # after the loss, steps run at the new K on rungs 1 and 0: two batches
    # of new shapes, the two traces the reference's jit makes there
    assert st["rung_hits"] == {0: 1, 1: 6}
    assert [e["rung_index"] for e in eng.step_log] == [1] * 6 + [0]
    assert st["compiles_after_warmup"] == 2
    assert runs[1][0].stats()["compiles_after_warmup"] == 0
