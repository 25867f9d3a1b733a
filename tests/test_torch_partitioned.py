"""Graph-partitioned execution of the port (the executor's partitioned
FP / ``gather_halo`` / NA / SA / head arms, ``semantics.
semantic_attention_partitioned``, ``residency.partition_overlay``, the
``partition`` record of ``stage_records``, and the serve engine's
partitioned arm with failover) against ``repro``.

The same graph goes through the reference's partitioned forward and the
port's, on the reference's own parameters (``interop.params_from_numpy``),
on the tiny graph of ``tests/conftest.py``: the logits agree within
``atol=rtol=1e-5`` (the same math in other summation orders; the port's
SA averages its scores in global row order where the reference sums them
over ``(K, n)``).  Inside the port, ``K = 1`` is bitwise the unpartitioned
forward, cached is bitwise uncached, and a serve that loses a partition
is bitwise the never-failed serve (ROADMAP invariant 3).

Stability: every input comes from a fixed numpy seed or a fixed graph; no
wall clock is read, no process group, socket or subprocess is made; the
dataset registries of both packages are touched only through
``monkeypatch``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import HGNNConfig as RefConfig
from repro.core import semantics as ref_semantics
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro.serve.engine import HGNNRequest as RefRequest
from repro.serve.engine import HGNNServeEngine as RefEngine
from repro.serve.faults import Fault as RefFault
from repro.serve.faults import FaultInjector as RefInjector
from repro.serve.sampler import HGNNSampler as RefSampler
from repro_torch import interop
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph, plan, semantics
from repro_torch.core.models import get_model
from repro_torch.core.pipeline import StageGraphExecutor
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.serve.engine import HGNNRequest, HGNNServeEngine
from repro_torch.serve.faults import Fault, FaultInjector
from repro_torch.serve.sampler import HGNNSampler

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             attn_hidden=8, max_degree=6, max_instances=4, fused=True)
MODELS = ("han", "rgcn", "magnn")


@pytest.fixture(autouse=True)
def _tiny_tables(monkeypatch):
    for mod in (ref_syn, syn):
        monkeypatch.setitem(mod.DATASET_METAPATHS, "tiny",
                            [["M", "D", "M"], ["M", "A", "M"]])
        monkeypatch.setitem(mod.DATASET_TARGET, "tiny", "M")


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


_REF: dict = {}  # the reference's (model, batch, params, logits) a config


def _ref(hg, **kw):
    """The reference's model, batch and parameters of one config, made
    once.  Its partitioned forward is XLA only (``core/pipeline.py:
    518-522``), so ``use_pallas`` changes nothing there: the reference
    runs with it off."""
    kw.pop("use_pallas", None)
    key = tuple(sorted(kw.items()))
    if key not in _REF:
        m = ref_get_model(RefConfig(**dict(SMALL, **kw)))
        b = m.prepare(hg)
        _REF[key] = [m, b, m.init(jax.random.key(0), b), None]
    return tuple(_REF[key][:3])


def _ref_logits(hg, **kw):
    _ref(hg, **kw)
    kw.pop("use_pallas", None)
    entry = _REF[tuple(sorted(kw.items()))]
    if entry[3] is None:
        m, b, p, _ = entry
        entry[3] = np.asarray(m.forward(p, b))
    return entry[3]


def _port(hg, ref_p, **kw):
    m = get_model(HGNNConfig(**dict(SMALL, **kw)))
    b = m.prepare(_port_hg(hg), device="cpu")
    return m, b, interop.params_from_numpy(ref_p, device="cpu")


def _run(m, p, b):
    with torch.inference_mode():
        return m.forward(p, b)


# ---------------------------------------------------------------------------
# logits against the JAX forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("model,layers", [
    ("han", 1), ("han", 2), ("rgcn", 1), ("rgcn", 2), ("magnn", 1),
    ("magnn", 2)])
def test_partitioned_logits_match_jax(tiny_hg, model, layers, use_pallas):
    kw = dict(model=model, layers=layers, partitions=4, use_pallas=use_pallas)
    _, _, ref_p = _ref(tiny_hg, **kw)
    want = _ref_logits(tiny_hg, **kw)
    m, b, p = _port(tiny_hg, ref_p, **kw)
    got = _run(m, p, b)
    assert got.shape == want.shape == (40, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("model", MODELS)
def test_partitioned_cached_logits_match_jax(tiny_hg, model):
    """Partitioned residency: hot halo rows selected from the
    partition-local cache; the same logits as the reference."""
    kw = dict(model=model, partitions=3, cache_rows=6, use_pallas=True)
    _, ref_b, ref_p = _ref(tiny_hg, **kw)
    want = _ref_logits(tiny_hg, **kw)
    m, b, p = _port(tiny_hg, ref_p, **kw)
    np.testing.assert_allclose(_run(m, p, b).numpy(), want, **TOL)
    assert b["residency"]["counters"] == ref_b["residency"]["counters"]
    assert b["residency"]["counters"]["hits"] > 0


def test_semantic_attention_partitioned_matches_jax(tiny_hg):
    """The SA of a partitioned batch: scores averaged in global row order
    (the port) against the masked sum over ``(K, n)`` (the reference)."""
    ref_m, ref_b, _ = _ref(tiny_hg, model="han", partitions=4)
    part = ref_b["part"]
    mask = np.asarray(part["own_mask"]["M"])
    rng = np.random.default_rng(5)
    k, n = mask.shape
    z = (rng.standard_normal((k, 2, n, 16)).astype(np.float32)
         * mask[:, None, :, None])
    p = {"W": rng.standard_normal((16, 8)).astype(np.float32) / 4,
         "b": rng.standard_normal(8).astype(np.float32) / 4,
         "q": rng.standard_normal(8).astype(np.float32) / 3}
    want = np.asarray(ref_semantics.semantic_attention_partitioned(
        {n_: jax.numpy.asarray(v) for n_, v in p.items()},
        jax.numpy.asarray(z), jax.numpy.asarray(mask)))
    got = semantics.semantic_attention_partitioned(
        {n_: torch.from_numpy(v) for n_, v in p.items()},
        torch.from_numpy(z),
        torch.from_numpy(np.array(part["inv"])))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# the identities, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("model", MODELS)
def test_one_partition_is_bitwise_the_unpartitioned_forward(
        tiny_hg, model, layers, use_pallas):
    kw = dict(model=model, layers=layers, use_pallas=use_pallas)
    _, _, ref_p = _ref(tiny_hg, **kw)
    m1, b1, p = _port(tiny_hg, ref_p, partitions=1, **kw)
    m0, b0, _ = _port(tiny_hg, ref_p, **kw)
    assert m1.plan().partition.k == 1 and m0.plan().partition is None
    assert b1["part"]["halo_src"]["M"].shape[1] == 0
    torch.testing.assert_close(_run(m1, p, b1), _run(m0, p, b0), rtol=0,
                               atol=0)


@pytest.mark.parametrize("model", MODELS)
def test_partitioned_cached_is_bitwise_uncached(tiny_hg, model):
    kw = dict(model=model, partitions=3, layers=2, use_pallas=True)
    _, _, ref_p = _ref(tiny_hg, **kw)
    m, b, p = _port(tiny_hg, ref_p, **kw)
    mc, bc, _ = _port(tiny_hg, ref_p, cache_rows=6, **kw)
    assert bc["residency"]["counters"]["hits"] > 0
    torch.testing.assert_close(_run(mc, p, bc), _run(m, p, b), rtol=0,
                               atol=0)


@pytest.mark.parametrize("model", MODELS)
def test_partition_count_moves_no_logit_beyond_tolerance(tiny_hg, model):
    """K = 2, 3, 4 and the unpartitioned forward: one model, within 1e-5
    (the reduction orders inside a row do not depend on K, so on this CPU
    they agree to the bit; the tolerance is what the reference holds)."""
    kw = dict(model=model, use_pallas=True)
    _, _, ref_p = _ref(tiny_hg, **kw)
    m0, b0, p = _port(tiny_hg, ref_p, **kw)
    base = _run(m0, p, b0)
    for k in (2, 3, 4):
        m, b, _ = _port(tiny_hg, ref_p, partitions=k, **kw)
        torch.testing.assert_close(_run(m, p, b), base, **TOL)


# ---------------------------------------------------------------------------
# launches, plans, records
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,layers,want", [
    ("han", 2, {"gat_na": 3 * 2}),                 # K x L stacked launches
    ("rgcn", 1, {"segment_spmm": 3 * 2}),          # K x relations into M
    ("rgcn", 2, {"segment_spmm": 2 * 3 * 4}),      # L x K x every relation
    ("magnn", 2, {"gat_na": 2 * 2})])              # L x metapaths
def test_partitioned_kernel_arm_calls_each_kernel_per_partition(
        tiny_hg, monkeypatch, model, layers, want):
    """With ``use_pallas`` each partition's NA goes through the kernel
    wrappers (on the CPU their plain versions); the calls are counted at
    the wrappers, as the card's launches are."""
    from repro_torch.kernels import gat_na, segment_spmm

    calls = {"gat_na": 0, "segment_spmm": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(gat_na, "gat_na", counting("gat_na", gat_na.gat_na))
    monkeypatch.setattr(segment_spmm, "segment_spmm",
                        counting("segment_spmm", segment_spmm.segment_spmm))
    kw = dict(model=model, layers=layers, partitions=3, use_pallas=True)
    _, _, ref_p = _ref(tiny_hg, **kw)
    m, b, p = _port(tiny_hg, ref_p, **kw)
    _run(m, p, b)
    assert {k: v for k, v in calls.items() if v} == want


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("cache_rows", [0, 6])
def test_executor_accepts_partitioned_plans(model, cache_rows):
    cfg = HGNNConfig(**dict(SMALL, model=model, partitions=2,
                            cache_rows=cache_rows))
    pl = get_model(cfg).plan()
    assert pl.partition == plan.PartitionSpec(k=2)
    StageGraphExecutor(pl, cfg)
    # with the async schedule (ported), as the reference's executor: its
    # DAG splits NA at the gather
    ex = StageGraphExecutor(dataclasses.replace(
        pl, schedule=plan.ScheduleSpec()), cfg)
    assert ex.schedule_edges()["NA"] == ("NA.own", "gather_halo")


@pytest.mark.parametrize("kw,match", [
    (dict(model="han", degree_buckets=3), "no model of the reference"),
    (dict(model="han", fused=False), "no model of the reference"),
    (dict(model="rgcn", degree_buckets=3), "no model of the reference"),
    (dict(model="gcn", dataset="reddit"), "no model of the reference")])
def test_executor_refuses_partitioned_layouts_without_relabeling(kw, match):
    cfg = HGNNConfig(**dict(SMALL, **kw))
    pl = dataclasses.replace(get_model(cfg).plan(),
                             partition=plan.PartitionSpec(k=2))
    with pytest.raises(NotImplementedError, match=match):
        StageGraphExecutor(pl, cfg)


def test_executor_refuses_an_unknown_halo_mode():
    cfg = HGNNConfig(**dict(SMALL, model="han", partitions=2))
    pl = get_model(cfg).plan()
    StageGraphExecutor(dataclasses.replace(
        pl, partition=plan.PartitionSpec(k=2, halo="xla")), cfg)
    with pytest.raises(ValueError, match="halo mode"):
        StageGraphExecutor(dataclasses.replace(
            pl, partition=plan.PartitionSpec(k=2, halo="nccl")), cfg)


@pytest.mark.parametrize("model,fuse", [("han", True), ("rgcn", False),
                                        ("magnn", False)])
def test_partitioned_plans_equal_the_reference(model, fuse):
    kw = dict(SMALL, model=model, partitions=4, fuse_na_sa=fuse, layers=2)
    got = get_model(HGNNConfig(**kw)).plan()
    want = ref_get_model(RefConfig(**kw)).plan()
    assert dataclasses.asdict(got.partition) == dataclasses.asdict(
        want.partition)
    assert got.sa.fuse_epilogue is want.sa.fuse_epilogue is False
    assert (got.na.kind, got.na.layout) == (want.na.kind, want.na.layout)


@pytest.mark.parametrize("model,layers,cache_rows", [
    ("han", 1, 0), ("han", 2, 6), ("rgcn", 2, 0), ("magnn", 1, 6)])
def test_partition_record_equals_the_reference(tiny_hg, model, layers,
                                               cache_rows):
    kw = dict(model=model, layers=layers, partitions=4, cache_rows=cache_rows)
    ref_m, ref_b, ref_p = _ref(tiny_hg, **kw)
    want = ref_m.executor.stage_records(ref_p, ref_b)
    m, b, p = _port(tiny_hg, ref_p, **kw)
    got = m.stage_records(p, b)
    assert list(got["stages"]) == list(want["stages"])
    assert got["partition"] == want["partition"]
    for name, rec in want["stages"].items():
        if name.endswith("gather_halo"):
            assert got["stages"][name]["halo_bytes"] == rec["halo_bytes"]
            assert got["stages"][name]["cut_edges"] == rec["cut_edges"]
    if cache_rows:
        assert got["residency"] == want["residency"]


# ---------------------------------------------------------------------------
# serving: the partitioned arm and failover
# ---------------------------------------------------------------------------


def _requests(cls, n, seed=3, n_nodes=40):
    rng = np.random.default_rng(seed)
    return [cls(targets=rng.integers(0, n_nodes, size=int(rng.integers(1, 9))))
            for _ in range(n)]


def _serve_both(tiny_hg, fault=None, **kw):
    kw = dict(SMALL, **{"model": "han", "fanout": 3, "partitions": 4, **kw})
    ref_cfg = RefConfig(**kw)
    ref_m = ref_get_model(ref_cfg)
    ref_b = ref_m.prepare(tiny_hg)
    ref_p = ref_m.init(jax.random.key(0), ref_b)
    ref_eng = RefEngine(
        ref_m.executor, ref_p, RefSampler(ref_m.plan(), ref_cfg, tiny_hg),
        slots=4, slot_targets=2, fn=jax.jit(ref_m.executor.forward),
        injector=RefInjector([RefFault(**fault)]) if fault else None)
    ref_eng.warmup()
    ref_reqs = _requests(RefRequest, 10)
    ref_eng.serve(ref_reqs)
    cfg = HGNNConfig(**kw)
    m = get_model(cfg)
    hg = _port_hg(tiny_hg)
    p = interop.params_from_numpy(ref_p, device="cpu")
    eng = HGNNServeEngine(m.executor, p, HGNNSampler(m.plan(), cfg, hg),
                          slots=4, slot_targets=2,
                          injector=(FaultInjector([Fault(**fault)])
                                    if fault else None))
    eng.warmup()
    reqs = _requests(HGNNRequest, 10)
    eng.serve(reqs)
    return (ref_eng, ref_reqs), (eng, reqs)


@pytest.mark.parametrize("fault", [None, dict(step=2, kind="partition",
                                              partition=1)])
@pytest.mark.parametrize("model", MODELS)
def test_partitioned_serve_matches_the_jax_engine(tiny_hg, model, fault):
    (ref_eng, ref_reqs), (eng, reqs) = _serve_both(tiny_hg, fault=fault,
                                                   model=model)
    for a, b in zip(reqs, ref_reqs):
        assert a.status == b.status == "OK"
        np.testing.assert_allclose(a.logits, b.logits, **TOL)
    st, ref_st = eng.stats(), ref_eng.stats()
    for key in ("steps", "rung_hits", "frontier_bytes", "truncated_rows",
                "compiles_after_warmup"):
        assert st[key] == ref_st[key], key
    for key in ("partition_failovers", "lost_partitions", "ok_requests",
                "failed_steps", "retries"):
        assert st["resilience"][key] == ref_st["resilience"][key], key
    assert eng._serve_plan.partition.k == ref_eng._serve_plan.partition.k
    assert eng._serve_plan.partition.static_shapes


@pytest.mark.parametrize("cache_rows", [0, 8])
def test_failover_logits_are_bitwise_the_never_failed_serve(tiny_hg,
                                                            cache_rows):
    """K = 4 loses partition 1 at step 2 and re-partitions over 3: every
    request's logits are bitwise those of the serve that never failed,
    and both are the full-graph partitioned forward's rows."""
    kw = dict(SMALL, model="han", fanout=64, max_degree=48, partitions=4,
              cache_rows=cache_rows)
    cfg = HGNNConfig(**kw)
    ref_m, ref_b, ref_p = _ref(tiny_hg, **dict(kw, dataset="tiny"))
    m = get_model(cfg)
    hg = _port_hg(tiny_hg)
    b = m.prepare(hg, device="cpu")
    p = interop.params_from_numpy(ref_p, device="cpu")
    full = _run(m, p, b).numpy()

    def serve(inj):
        eng = HGNNServeEngine(m.executor, p, HGNNSampler(m.plan(), cfg, hg),
                              slots=4, slot_targets=2, injector=inj)
        eng.warmup()
        reqs = _requests(HGNNRequest, 10)
        eng.serve(reqs)
        return eng, reqs

    e1, r1 = serve(FaultInjector([Fault(step=2, kind="partition",
                                        partition=1)]))
    e2, r2 = serve(None)
    rs = e1.stats()["resilience"]
    assert rs["partition_failovers"] == 1 and rs["lost_partitions"] == [1]
    assert e1._serve_plan.partition.k == 3
    assert e2._serve_plan.partition.k == 4
    assert e2.stats()["resilience"]["partition_failovers"] == 0
    for a, c in zip(r1, r2):
        assert a.status == c.status == "OK"
        np.testing.assert_array_equal(a.logits, c.logits)
        np.testing.assert_array_equal(a.logits, full[a.targets])
    if cache_rows:
        assert e1.stats()["residency"] == e2.stats()["residency"]


def test_partition_loss_on_an_unpartitioned_plan_is_ignored(tiny_hg):
    cfg = HGNNConfig(**dict(SMALL, model="han", fanout=3))
    m = get_model(cfg)
    hg = _port_hg(tiny_hg)
    b = m.prepare(hg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0), b)
    inj = FaultInjector([Fault(step=1, kind="partition", partition=0)])
    eng = HGNNServeEngine(m.executor, p, HGNNSampler(m.plan(), cfg, hg),
                          slots=4, slot_targets=2, injector=inj)
    eng.warmup()
    eng.serve(_requests(HGNNRequest, 4))
    rs = eng.stats()["resilience"]
    assert rs["partition_failovers"] == 0 and rs["lost_partitions"] == []
    assert inj.counters["injected_partition_losses"] == 0


# ---------------------------------------------------------------------------
# the CLI (in process, on the CPU)
# ---------------------------------------------------------------------------


def _cli(monkeypatch, capsys, *args):
    from repro_torch.launch import serve as cli

    monkeypatch.setattr("sys.argv", ["serve", "--hgnn", "han", "--dataset",
                                     "imdb", "--use-pallas", "--device",
                                     "cpu", *args])
    cli.main()
    return capsys.readouterr().out.splitlines()


def test_cli_partitioned_forward_and_records(monkeypatch, capsys):
    """``--partitions 4 --characterize``: the reference's tag, a
    ``gather_halo`` stage line with its halo bytes, and the ``partition:``
    summary (IMDB at the CLI's ``max_degree`` 64; the reference CLI prints
    the same ``halo_bytes`` and ``partition:`` line for these flags)."""
    lines = _cli(monkeypatch, capsys, "--partitions", "4", "--iters", "1",
                 "--characterize")
    assert lines[1].startswith("han/imdb [na=gat/stacked +partitions=4] "
                               "logits (4278, 8) on single-device: ")
    assert [ln.split(":")[0] for ln in lines[2:]] == [
        "  FP", "  gather_halo", "  NA", "  SA", "  head", "  partition"]
    assert lines[3].endswith(" halo_bytes=2.1e+06")
    assert lines[-1] == ("  partition: k=4 cut_ratio=0.654 halo_rows=8204 "
                         "halo_bytes=2.1e+06 (x1 layers = 2.1e+06 total)")


def test_cli_partitioned_serve_fails_over(monkeypatch, capsys):
    """``--partitions 3 --fanout 8 --inject-faults 0``: partition 0 is lost
    at step 3 and the serve fails over to 2; the counters are the
    reference CLI's for the same flags (``serve han/imdb +partitions=3
    requests=32 targets=164 slots=8 slot_targets=4 fanout=8 steps=7
    recompiles=1 frontier_bytes=15845088 truncated=0 rung_hits=1:7``,
    ``failovers=1``)."""
    lines = _cli(monkeypatch, capsys, "--partitions", "3", "--fanout", "8",
                 "--slots", "8", "--slot-targets", "4", "--requests", "32",
                 "--inject-faults", "0")
    assert lines[1].startswith(
        "serve han/imdb +partitions=3 requests=32 targets=164 slots=8 "
        "slot_targets=4 fanout=8 steps=7 recompiles=1 "
        "frontier_bytes=15845088 truncated=0 rung_hits=1:7 warmup_ms=")
    assert lines[2] == (
        "  resilience: ok=32 partial=0 failed=0 rejected=0 shed=0 "
        "retries=0 failed_steps=0 deadline_expired=0 degrade_steps=0 "
        "max_degrade_level=0 failovers=1")
