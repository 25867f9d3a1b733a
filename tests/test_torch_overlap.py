"""The async stage-graph schedule of the port (``StageGraphExecutor.
schedule_edges`` / ``overlap_record`` / ``forward_overlapped``, the
per-metapath NA stage, the own/halo NA split, ``kernels/streaming.py``'s
``InflightWindow``, ``stages.gather_own`` / ``gather_merge``, the serve
engine's sampler prefetch and the CLI's ``--overlap``) against ``repro``.

On the tiny graph of ``tests/conftest.py`` with the reference's own
parameters (``interop.params_from_numpy``): over the reference's 13-case
matrix (``tests/test_overlap.py``) the port's overlapped forward is
bitwise its serial forward, on the plain and on the kernel arm, and
within ``atol=rtol=1e-5`` of the JAX ``forward_overlapped``; the stage
DAG, its counters and the dispatch order equal the reference's exactly;
served logits with the prefetch thread are bitwise those without it, and
the prefetch counters equal the JAX engine's.

Stability: every input comes from a fixed numpy seed or a fixed graph; no
wall clock is read, no process group, socket or subprocess is made; the
dataset registries of both packages are touched only through
``monkeypatch``.  The prefetch thread runs the host sampler alone."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HGNNConfig as RefConfig
from repro.core import stages as ref_stages
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro.kernels.streaming import InflightWindow as RefWindow
from repro.serve.engine import HGNNRequest as RefRequest
from repro.serve.engine import HGNNServeEngine as RefEngine
from repro.serve.faults import Fault as RefFault
from repro.serve.faults import FaultInjector as RefInjector
from repro.serve.resilience import ResilienceConfig as RefResilience
from repro.serve.sampler import HGNNSampler as RefSampler
from repro_torch import interop
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph, stages
from repro_torch.core.models import get_model
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.kernels.streaming import InflightWindow
from repro_torch.launch.serve import build_hgnn_infer
from repro_torch.serve.engine import HGNNRequest, HGNNServeEngine
from repro_torch.serve.faults import Fault, FaultInjector
from repro_torch.serve.resilience import OK, PARTIAL, ResilienceConfig
from repro_torch.serve.sampler import HGNNSampler

TOL = dict(atol=1e-5, rtol=1e-5)
# the reference's tests/test_overlap.py settings
BASE = dict(hidden=16, n_heads=4, n_classes=3, max_degree=48,
            max_instances=4, fused=True)

MATRIX = [
    ("han", {}),                               # stacked: one NA launch
    ("han", {"degree_buckets": 3}),            # bucketed: metapath fan-out
    ("han", {"fused": False}),                 # csr: metapath fan-out
    ("rgcn", {}),
    ("magnn", {}),                             # instances: metapath fan-out
    ("han", {"layers": 2}),
    ("rgcn", {"layers": 2}),
    ("magnn", {"layers": 2}),
    ("han", {"partitions": 4}),                # halo/compute split
    ("rgcn", {"partitions": 4}),
    ("magnn", {"partitions": 4}),
    ("han", {"partitions": 4, "layers": 2}),
    ("rgcn", {"partitions": 4, "layers": 2}),
]
IDS = [f"{m}-{'-'.join(f'{k}{v}' for k, v in kw.items()) or 'base'}"
       for m, kw in MATRIX]


@pytest.fixture(autouse=True)
def _tiny_tables(monkeypatch):
    for mod in (ref_syn, syn):
        monkeypatch.setitem(mod.DATASET_METAPATHS, "tiny",
                            [["M", "D", "M"], ["M", "A", "M"]])
        monkeypatch.setitem(mod.DATASET_TARGET, "tiny", "M")
        monkeypatch.setitem(mod.DATASET_METAPATHS, "tiny1", [["M", "D", "M"]])
        monkeypatch.setitem(mod.DATASET_TARGET, "tiny1", "M")


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


def _kw(model, **kw):
    return dict(BASE, model=model, dataset=kw.pop("dataset", "tiny"), **kw)


_REF: dict = {}  # config -> the reference's (model, batch, params, outputs)


def _ref(hg, model, kw, overlap=2):
    """The reference's model, batch, parameters, and its serial and
    overlapped logits with the dispatch trace, made once a config."""
    key = (model, tuple(sorted(kw.items())), overlap)
    if key not in _REF:
        m = ref_get_model(RefConfig(**_kw(model, overlap=overlap, **kw)))
        b = m.prepare(hg)
        p = m.init(jax.random.key(0), b)
        serial = np.asarray(jax.jit(m.forward)(p, b))
        over = np.asarray(m.forward_overlapped(p, b))
        _REF[key] = (m, b, p, serial, over, dict(m.executor.last_dispatch))
    return _REF[key]


def _port(hg, ref_p, model, kw, overlap=2, use_pallas=True):
    m = get_model(HGNNConfig(**_kw(model, overlap=overlap,
                                   use_pallas=use_pallas, **kw)))
    b = m.prepare(_port_hg(hg), device="cpu")
    return m, b, interop.params_from_numpy(ref_p, device="cpu")


def _both_forwards(m, p, b):
    with torch.inference_mode():
        return m.forward(p, b), m.forward_overlapped(p, b)


# ---------------------------------------------------------------------------
# the matrix: overlapped == serial bitwise, and the JAX forward_overlapped
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("model,kw", MATRIX, ids=IDS)
def test_overlapped_forward_is_bitwise_the_serial(tiny_hg, model, kw,
                                                  use_pallas):
    _, _, ref_p, *_ = _ref(tiny_hg, model, kw)
    m, b, p = _port(tiny_hg, ref_p, model, kw, use_pallas=use_pallas)
    serial, over = _both_forwards(m, p, b)
    assert torch.equal(serial, over)
    d = m.executor.last_dispatch
    assert d["depth"] == 2
    assert d["dispatched"] == list(m.executor.schedule_edges())


@pytest.mark.parametrize("model,kw", MATRIX, ids=IDS)
def test_overlapped_forward_and_dag_match_jax(tiny_hg, model, kw):
    ref_m, _, ref_p, ref_serial, ref_over, ref_d = _ref(tiny_hg, model, kw)
    np.testing.assert_array_equal(ref_serial, ref_over)
    m, b, p = _port(tiny_hg, ref_p, model, kw)
    _, over = _both_forwards(m, p, b)
    np.testing.assert_allclose(over.numpy(), ref_over, **TOL)
    assert m.executor.schedule_edges() == ref_m.executor.schedule_edges()
    assert m.executor.overlap_record() == ref_m.executor.overlap_record()
    assert m.executor.last_dispatch == ref_d


def test_depth_one_is_the_serial_baseline(tiny_hg):
    """``overlap=1``: every stage is waited for, one in flight at most,
    and the same stage functions give the same bits."""
    for model, kw in [("han", {"degree_buckets": 3}),
                      ("rgcn", {"partitions": 4, "layers": 2})]:
        _, _, ref_p, _, _, ref_d = _ref(tiny_hg, model, kw, overlap=1)
        m, b, p = _port(tiny_hg, ref_p, model, kw, overlap=1)
        serial, over = _both_forwards(m, p, b)
        assert torch.equal(serial, over)
        assert m.executor.last_dispatch["max_inflight"] == 1
        assert m.executor.last_dispatch == ref_d


def test_repeated_overlapped_calls_give_the_same_bits(tiny_hg):
    _, _, ref_p, *_ = _ref(tiny_hg, "han", {"partitions": 4})
    m, b, p = _port(tiny_hg, ref_p, "han", {"partitions": 4})
    with torch.inference_mode():
        first = m.forward_overlapped(p, b)
        assert torch.equal(first, m.forward_overlapped(p, b))


# ---------------------------------------------------------------------------
# the plan's DAG
# ---------------------------------------------------------------------------


def test_schedule_edges_of_the_partitioned_split():
    m = get_model(HGNNConfig(**_kw("han", partitions=4, layers=2,
                                   overlap=2)))
    edges = m.executor.schedule_edges()
    assert edges["L1.gather_halo"] == ("L1.FP",)
    assert edges["L1.NA.own"] == ("L1.FP",)
    assert edges["L1.NA"] == ("L1.NA.own", "L1.gather_halo")
    assert edges["L2.FP"] == ("L1.SA",)
    rec = m.executor.overlap_record()
    assert rec["concurrent_pairs"] == 2
    assert {"L1.gather_halo|L1.NA.own", "L2.gather_halo|L2.NA.own"} == \
        set(rec["pairs"])


def test_schedule_edges_of_the_metapath_split():
    m = get_model(HGNNConfig(**_kw("han", degree_buckets=3, overlap=2)))
    edges = m.executor.schedule_edges()
    assert edges["NA.p0"] == edges["NA.p1"] == ("FP",)
    assert edges["SA"] == ("NA.p0", "NA.p1")
    assert m.executor.overlap_record()["concurrent_pairs"] == 1


def test_single_metapath_plan_skips_the_fan_out(tiny_hg):
    """One metapath has nothing to overlap: the serial chain, no pair,
    and still bitwise."""
    kw = {"dataset": "tiny1", "degree_buckets": 3}
    _, _, ref_p, *_ = _ref(tiny_hg, "han", dict(kw))
    m, b, p = _port(tiny_hg, ref_p, "han", dict(kw))
    serial, over = _both_forwards(m, p, b)
    assert torch.equal(serial, over)
    edges = m.executor.schedule_edges()
    assert "NA" in edges and not any(n.startswith("NA.p") for n in edges)
    assert m.executor.overlap_record()["concurrent_pairs"] == 0


def test_stacked_layout_keeps_one_na_launch(tiny_hg, monkeypatch):
    """HAN's stacked layout is one launch for the stack: the schedule
    does not fan it out, and the overlapped forward calls the stacked
    kernel once, as the serial one does."""
    calls = []
    stacked = ops.gat_aggregate_stacked

    def counting(*a, **k):
        calls.append(1)
        return stacked(*a, **k)

    _, _, ref_p, *_ = _ref(tiny_hg, "han", {})
    m, b, p = _port(tiny_hg, ref_p, "han", {})
    monkeypatch.setattr(ops, "gat_aggregate_stacked", counting)
    edges = m.executor.schedule_edges()
    assert "NA" in edges and not any(n.startswith("NA.p") for n in edges)
    with torch.inference_mode():
        m.forward(p, b)
        n_serial = len(calls)
        m.forward_overlapped(p, b)
    assert n_serial == 1 and len(calls) == 2


def test_metapath_stages_reach_the_unstacked_kernel_once_a_bucket(
        tiny_hg, monkeypatch):
    """The per-metapath stage of the ``bucketed`` layout calls the
    unstacked ``gat_na`` once a degree bucket, as the serial loop does."""
    calls = []
    unstacked = ops.gat_aggregate

    def counting(*a, **k):
        calls.append(1)
        return unstacked(*a, **k)

    _, _, ref_p, *_ = _ref(tiny_hg, "han", {"degree_buckets": 3})
    m, b, p = _port(tiny_hg, ref_p, "han", {"degree_buckets": 3})
    monkeypatch.setattr(ops, "gat_aggregate", counting)
    with torch.inference_mode():
        m.forward(p, b)
        n_serial = len(calls)
        m.forward_overlapped(p, b)
    assert n_serial == sum(len(bk) for bk in b["buckets"]) > 2
    assert len(calls) == 2 * n_serial


def test_stage_records_carry_the_overlap_record(tiny_hg):
    _, _, ref_p, *_ = _ref(tiny_hg, "han", {"degree_buckets": 3})
    m, b, p = _port(tiny_hg, ref_p, "han", {"degree_buckets": 3})
    recs = m.executor.stage_records(p, b)
    assert recs["overlap"] == m.executor.overlap_record()
    assert recs["overlap"]["concurrent_pairs"] == 1
    m0, b0, _ = _port(tiny_hg, ref_p, "han", {"degree_buckets": 3},
                      overlap=0)
    assert "overlap" not in m0.executor.stage_records(p, b0)


def test_overlap_stage_fns_chain_to_the_logits(tiny_hg):
    """One callable a DAG node, chained on concrete intermediates: the
    head's gives the forward's logits."""
    _, _, ref_p, *_ = _ref(tiny_hg, "rgcn", {"partitions": 4, "layers": 2})
    m, b, p = _port(tiny_hg, ref_p, "rgcn", {"partitions": 4, "layers": 2})
    fns = m.executor.overlap_stage_fns(p, b)
    assert list(fns) == list(m.executor.schedule_edges())
    fn, args = fns["head"]
    with torch.inference_mode():
        assert torch.equal(fn(*args), m.forward(p, b))


def test_build_hgnn_infer_serves_the_overlapped_forward(tiny_hg):
    built = build_hgnn_infer(HGNNConfig(**_kw("han", degree_buckets=3,
                                              overlap=2)),
                             _port_hg(tiny_hg), device="cpu")
    assert built.fn == built.executor.forward_overlapped
    sampled = build_hgnn_infer(HGNNConfig(**_kw("han", fanout=4,
                                                overlap=2)),
                               _port_hg(tiny_hg), device="cpu")
    assert sampled.fn != sampled.executor.forward_overlapped


# ---------------------------------------------------------------------------
# the window and the split gathers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth,admits", [(0, 3), (1, 4), (2, 5), (3, 2)])
def test_inflight_window_depth_rules(depth, admits):
    """The reference's counters: ``depth <= 1`` clamps to the serial
    baseline; past ``depth`` the window blocks on the oldest, having held
    ``depth + 1`` for a moment."""
    win, ref_win = InflightWindow(depth), RefWindow(depth)
    for i in range(admits):
        assert torch.equal(win.admit(f"s{i}", torch.ones(4) * i),
                           torch.ones(4) * i)
        ref_win.admit(f"s{i}", jnp.ones(4) * i)
    assert (win.depth, win.max_inflight, win.admitted) == (
        ref_win.depth, ref_win.max_inflight, ref_win.admitted)
    assert win.depth == max(depth, 1)
    win.drain()
    assert win._live == []


@pytest.mark.parametrize("n_own,h_max,tail", [(7, 5, (3,)), (7, 0, (3,)),
                                              (4, 9, (2, 3)), (1, 1, ())])
def test_split_gather_is_the_gather_from_the_concatenation(n_own, h_max,
                                                           tail):
    """``gather_merge(gather_own(own, idx), halo, idx, n_own)`` is
    byte-equal to ``concat(own, halo)[idx]`` and to the reference's split,
    ``H_max = 0`` included; indices past the table are clamped on the
    owned side and never reach the output (check (a))."""
    rng = np.random.default_rng(100 * n_own + h_max)
    own = rng.standard_normal((n_own,) + tail).astype(np.float32)
    halo = rng.standard_normal((h_max,) + tail).astype(np.float32)
    idx = rng.integers(0, n_own + h_max, (6, 4)).astype(np.int32)
    t_own, t_halo, t_idx = map(torch.from_numpy, (own, halo, idx))
    got = stages.gather_merge(stages.gather_own(t_own, t_idx), t_halo,
                              t_idx, n_own)
    want = np.concatenate([own, halo])[idx]
    assert got.numpy().tobytes() == want.tobytes()
    ref = ref_stages.gather_merge(
        ref_stages.gather_own(jnp.asarray(own), jnp.asarray(idx)),
        jnp.asarray(halo), jnp.asarray(idx), n_own)
    assert got.numpy().tobytes() == np.asarray(ref).tobytes()


def test_pre_gathered_aggregations_are_bitwise_the_gathers():
    """``gat_aggregate_padded(hn=, e_nbr=)`` and ``mean_aggregate_padded(
    hn=)`` give the bits of their gathers from the pool."""
    rng = np.random.default_rng(5)
    pool = torch.as_tensor(rng.standard_normal((9, 2, 4)),
                           dtype=torch.float32)
    nbr = torch.as_tensor(rng.integers(0, 9, (6, 3)), dtype=torch.int32)
    mask = torch.as_tensor((rng.random((6, 3)) < 0.7).astype(np.float32))
    p = {"a_dst": torch.randn(2, 4, generator=torch.Generator().manual_seed(
        1)), "a_src": torch.randn(2, 4, generator=torch.Generator(
            ).manual_seed(2))}
    want = stages.gat_aggregate_padded(p, pool[:6], pool, nbr, mask)
    got = stages.gat_aggregate_padded(
        p, pool[:6], None, None, mask, hn=pool[nbr.long()],
        e_nbr=(pool * p["a_src"]).sum(-1)[nbr.long()])
    assert torch.equal(got, want)
    flat = pool.reshape(9, -1)
    assert torch.equal(
        stages.mean_aggregate_padded(None, nbr, mask, hn=flat[nbr.long()]),
        stages.mean_aggregate_padded(flat, nbr, mask))


# ---------------------------------------------------------------------------
# the cached halo exchange (fault (f))
# ---------------------------------------------------------------------------


def test_cached_halo_index_is_halo_src(tiny_hg):
    """On the tiny graph at K = 4 with 12 hot rows a type, the merged
    cached index ``where(slot >= 0, hot_flat[slot], halo_src)`` names the
    rows ``halo_src`` names, so the cached exchange is the uncached one
    gather, and the cached forward is bitwise the uncached one."""
    kw = dict(partitions=4, layers=2)
    _, _, ref_p, *_ = _ref(tiny_hg, "han", kw)
    m, b, p = _port(tiny_hg, ref_p, "han", dict(kw, cache_rows=12),
                    overlap=0)
    res, part = b["residency"], b["part"]
    hits = 0
    for t, slot in res["halo_slot"].items():
        hot_flat, src = res["hot_flat"][t], part["halo_src"][t]
        merged = torch.where(slot >= 0, hot_flat[slot.clamp(min=0).long()],
                             src)
        assert torch.equal(merged, src), t
        hits += int((slot >= 0).sum())
    assert hits == res["counters"]["hits"] > 0
    m0, b0, _ = _port(tiny_hg, ref_p, "han", kw, overlap=0)
    with torch.inference_mode():
        assert torch.equal(m.forward(p, b), m0.forward(p, b0))


# ---------------------------------------------------------------------------
# serving: the sampler prefetch
# ---------------------------------------------------------------------------


def _requests(cls, n, seed=3, n_nodes=40):
    rng = np.random.default_rng(seed)
    return [cls(targets=rng.integers(0, n_nodes, size=int(rng.integers(1, 9))))
            for _ in range(n)]


def _serve_port(tiny_hg, ref_p, model, overlap, partitions=0, res=None,
                injector=None, n_req=10):
    cfg = HGNNConfig(**_kw(model, fanout=8, partitions=partitions,
                           overlap=overlap, use_pallas=True))
    m = get_model(cfg)
    hg = _port_hg(tiny_hg)
    p = interop.params_from_numpy(ref_p, device="cpu")
    eng = HGNNServeEngine(m.executor, p, HGNNSampler(m.plan(), cfg, hg),
                          slots=4, slot_targets=2, resilience_cfg=res,
                          injector=injector)
    eng.warmup()
    return eng.serve(_requests(HGNNRequest, n_req)), eng


_REF_SERVE: dict = {}


def _serve_ref(tiny_hg, model, partitions=0, fault=None):
    """The JAX engine's serve with prefetch (``overlap=2``), made once."""
    key = (model, partitions, tuple(sorted((fault or {}).items())))
    if key not in _REF_SERVE:
        cfg = RefConfig(**_kw(model, fanout=8, partitions=partitions,
                              overlap=2))
        m = ref_get_model(cfg)
        b = m.prepare(tiny_hg)
        p = m.init(jax.random.key(0), b)
        eng = RefEngine(m.executor, p, RefSampler(m.plan(), cfg, tiny_hg),
                        slots=4, slot_targets=2,
                        injector=(RefInjector([RefFault(**fault)])
                                  if fault else None))
        eng.warmup()
        reqs = eng.serve(_requests(RefRequest, 10))
        _REF_SERVE[key] = (p, reqs, eng.stats())
    return _REF_SERVE[key]


@pytest.mark.parametrize("model,partitions", [
    ("han", 0), ("rgcn", 0), ("magnn", 0),
    ("han", 4), ("rgcn", 4), ("magnn", 4)],
    ids=["han", "rgcn", "magnn", "han-k4", "rgcn-k4", "magnn-k4"])
def test_serving_prefetch_is_bitwise_and_counts_as_the_jax_engine(
        tiny_hg, model, partitions):
    """The prefetch thread changes walls only: statuses and logits are
    bitwise those of the serve without it; its counters (and the serve's)
    equal the JAX engine's, and the logits agree with it at 1e-5."""
    ref_p, ref_reqs, ref_st = _serve_ref(tiny_hg, model, partitions)
    r_sync, e_sync = _serve_port(tiny_hg, ref_p, model, 0, partitions)
    r_pf, e_pf = _serve_port(tiny_hg, ref_p, model, 2, partitions)
    assert e_sync.prefetch is None and e_pf.prefetch is not None
    for a, b, w in zip(r_sync, r_pf, ref_reqs):
        assert a.status == b.status == w.status == OK
        assert np.array_equal(a.logits, b.logits)
        np.testing.assert_allclose(b.logits, w.logits, **TOL)
    st = e_pf.stats()
    assert st["prefetch"] == ref_st["prefetch"]
    pf = st["prefetch"]
    assert pf["hits"] > 0 and pf["cold"] == 1
    assert pf["hits"] + pf["mispredicts"] + pf["cold"] == st["steps"]
    for key in ("steps", "rung_hits", "frontier_bytes", "truncated_rows",
                "compiles_after_warmup"):
        assert st[key] == ref_st[key], key
    assert "prefetch" not in e_sync.stats()
    assert e_pf.prefetch._future is None and e_pf.prefetch._pool._shutdown


def test_prefetch_drains_on_deadline_expiry(tiny_hg):
    """Every request expires before a step runs: no speculation is taken,
    and the worker still stops."""
    ref_p, *_ = _serve_ref(tiny_hg, "han")
    reqs, eng = _serve_port(tiny_hg, ref_p, "han", 2,
                            res=ResilienceConfig(deadline_ms=0.0), n_req=5)
    assert all(r.status == PARTIAL for r in reqs)
    assert eng.stats()["prefetch"] == {"issued": 0, "hits": 0,
                                       "mispredicts": 0, "cold": 0}
    assert eng.prefetch._future is None and eng.prefetch._pool._shutdown
    cfg = RefConfig(**_kw("han", fanout=8, overlap=2))
    m = ref_get_model(cfg)
    b = m.prepare(tiny_hg)
    ref_eng = RefEngine(m.executor, m.init(jax.random.key(0), b),
                        RefSampler(m.plan(), cfg, tiny_hg), slots=4,
                        slot_targets=2,
                        resilience_cfg=RefResilience(deadline_ms=0.0))
    ref_eng.serve(_requests(RefRequest, 5))
    assert eng.stats()["prefetch"] == ref_eng.stats()["prefetch"]


def test_prefetch_drains_through_partition_failover(tiny_hg):
    """A partition lost mid-serve: the sampler does not see partitions, so
    the speculation in flight stays valid; every request completes OK,
    the counters are the JAX engine's, and the worker stops."""
    fault = dict(step=1, kind="partition", partition=2)
    ref_p, ref_reqs, ref_st = _serve_ref(tiny_hg, "han", 4, fault)
    reqs, eng = _serve_port(tiny_hg, ref_p, "han", 2, partitions=4,
                            injector=FaultInjector([Fault(**fault)]))
    assert all(r.status == OK for r in reqs)
    st = eng.stats()
    rs = st["resilience"]
    assert rs["partition_failovers"] == 1 and rs["lost_partitions"] == [2]
    assert st["prefetch"] == ref_st["prefetch"]
    assert st["prefetch"]["issued"] > 0
    for a, w in zip(reqs, ref_reqs):
        np.testing.assert_allclose(a.logits, w.logits, **TOL)
    assert eng.prefetch._future is None and eng.prefetch._pool._shutdown


def test_prefetch_off_in_the_schedule_keeps_the_sync_sampler(tiny_hg):
    ref_p, *_ = _serve_ref(tiny_hg, "han")
    cfg = HGNNConfig(**_kw("han", fanout=8, overlap=2, use_pallas=True))
    m = get_model(cfg)
    pl = m.plan()
    pl = dataclasses.replace(pl, schedule=dataclasses.replace(
        pl.schedule, prefetch=False))
    ex = type(m.executor)(pl, cfg)
    eng = HGNNServeEngine(ex, interop.params_from_numpy(ref_p, device="cpu"),
                          HGNNSampler(pl, cfg, _port_hg(tiny_hg)), slots=4,
                          slot_targets=2)
    eng.serve(_requests(HGNNRequest, 4))
    assert eng.prefetch is None and "prefetch" not in eng.stats()


# ---------------------------------------------------------------------------
# the CLI (in process, on the CPU)
# ---------------------------------------------------------------------------


def _cli(monkeypatch, capsys, *args):
    from repro_torch.launch import serve as cli

    monkeypatch.setattr("sys.argv", ["serve", "--dataset", "imdb",
                                     "--use-pallas", "--device", "cpu",
                                     *args])
    cli.main()
    return capsys.readouterr().out.splitlines()


def test_cli_overlap_line_is_the_reference_line(monkeypatch, capsys):
    """``--partitions 4 --layers 2 --overlap 2``: the reference CLI's tag
    and ``overlap:`` line (its verify recipe greps the same counters)."""
    lines = _cli(monkeypatch, capsys, "--hgnn", "rgcn", "--partitions", "4",
                 "--layers", "2", "--overlap", "2", "--iters", "1")
    assert lines[1].startswith(
        "rgcn/imdb [na=mean/padded +partitions=4 x2layers +overlap=2] "
        "logits (4278, 8) on single-device: ")
    assert lines[2] == ("  overlap: depth=2 stages=11 edges=12 "
                        "concurrent_pairs=2 overlapped_stages=4 "
                        "max_inflight=3")


def test_cli_serve_prints_the_prefetch_line(monkeypatch, capsys):
    lines = _cli(monkeypatch, capsys, "--hgnn", "han", "--fuse-na-sa",
                 "--fanout", "8", "--slots", "8", "--slot-targets", "4",
                 "--requests", "32", "--overlap", "2")
    serve = lines[1].split()
    steps = int(next(w for w in serve if w.startswith("steps="))[6:])
    assert lines[3].startswith("  prefetch: issued=")
    pf = dict(w.split("=") for w in lines[3].split()[1:])
    assert int(pf["hits"]) + int(pf["mispredicts"]) + int(pf["cold"]) == \
        steps
    assert int(pf["cold"]) == 1 and int(pf["hits"]) > 0
