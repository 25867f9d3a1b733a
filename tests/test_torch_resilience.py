"""Serving resilience of the port (``serve/resilience.py``,
``serve/faults.py``, the engine's retry / admission / degradation /
deadline paths) and the executor's sink-row arms for sampled batches,
against ``repro.serve``.

The policies are numpy; their counters are held exactly equal to the
reference's on the same inputs, and seeded ``FaultInjector`` serves of the
port's engine give the reference engine's counters and statuses exactly.
On synthetic IMDB, at ``benchmarks/bench_serving.py``'s and
``benchmarks/bench_resilience.py``'s own configs (hidden 64, 8 heads,
``max_degree`` 32, fan-out 8, ``default_rng(0)`` requests), the counters
equal ``BENCH_hgnn.json``'s ``serving`` and ``resilience/*/chaos`` rows
(read only).  The sink-row arms (ROADMAP Queue 3 check (a)) give exact
zeros for pad rows and never index past a table."""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import HGNNConfig as RefConfig
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro.serve import faults as ref_faults
from repro.serve import resilience as ref_res
from repro.serve.engine import HGNNRequest as RefRequest
from repro.serve.engine import HGNNServeEngine as RefEngine
from repro.serve.sampler import HGNNSampler as RefSampler
from repro_torch import interop
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import characterize as ch
from repro_torch.core import hgraph, stages
from repro_torch.core.models import get_model
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import request_queue
from repro_torch.serve import faults, resilience
from repro_torch.serve.engine import HGNNRequest, HGNNServeEngine
from repro_torch.serve.sampler import HGNNSampler

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             attn_hidden=8, max_degree=6, max_instances=4, fused=True)
# the counters bench_resilience.py gates (benchmarks/bench_resilience.py)
CHAOS_KEYS = ("ok_requests", "partial_requests", "failed_requests",
              "rejected", "shed", "deduped_rows", "retries", "failed_steps",
              "deadline_expired", "degrade_transitions",
              "recover_transitions", "max_degrade_level",
              "partition_failovers", "steps", "recompiles")


@pytest.fixture(autouse=True)
def _tiny_tables():
    for mod in (ref_syn, syn):
        mod.DATASET_METAPATHS["tiny"] = [["M", "D", "M"], ["M", "A", "M"]]
        mod.DATASET_TARGET["tiny"] = "M"


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


# ---------------------------------------------------------------------------
# the policies: the reference's counters on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(seed=0, n_steps=16, sampler=2, forward=1, persistent_sampler=1,
         latency_steps=4, latency_s=0.2),
    dict(seed=7, n_steps=32, sampler=3, forward=2, latency_steps=3,
         partition_loss_step=3, partition=1),
    dict(seed=3, n_steps=2, sampler=5),
])
def test_seeded_fault_schedule_is_the_reference(kw):
    assert faults.FaultInjector.seeded(**kw).faults == tuple(
        faults.Fault(**vars(f))
        for f in ref_faults.FaultInjector.seeded(**kw).faults)


def test_fault_hooks_and_counters_are_the_reference():
    sched = [dict(step=1, kind="sampler", attempts=2),
             dict(step=2, kind="forward"),
             dict(step=2, kind="latency", latency_s=0.5),
             dict(step=4, kind="partition", partition=2)]
    got = faults.FaultInjector([faults.Fault(**f) for f in sched])
    want = ref_faults.FaultInjector([ref_faults.Fault(**f) for f in sched])
    for inj, err in ((got, faults.InjectedFault),
                     (want, ref_faults.InjectedFault)):
        for step in range(5):
            for kind in ("sampler", "forward"):
                for attempt in range(3):
                    try:
                        inj.check(kind, step, attempt)
                    except err:
                        pass
            inj.latency_s(step)
            inj.partition_loss(step)
    assert got.counters == want.counters
    assert got.latency_s(2) == want.latency_s(2) == 0.5
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.Fault(step=0, kind="disk")


def test_admission_degradation_and_retry_are_the_reference():
    cfg = dict(max_queue=2, max_request_targets=5, slo_ms=10.0,
               degrade_patience=1, recover_patience=2, max_retries=1)
    outs = []
    for mod in (resilience, ref_res):
        res = mod.ResilienceConfig(**cfg)
        adm = mod.AdmissionController(res, n_target_type=10, n_classes=3)
        reqs = [RefRequest(targets=t) for t in (
            np.array([1, 1, 2]), np.array([0.5]), np.array([11]),
            np.zeros(0, np.int64), np.arange(6), np.array([3]),
            np.array([4]))]
        admitted = [adm.admit(r, i % 3, 0.0) for i, r in enumerate(reqs)]
        deg = mod.DegradationController(res, n_rungs=3, slot_targets=4)
        levels = [deg.observe(w) for w in (0.02, 0.02, 0.001, 0.001, 0.02,
                                           0.001, 0.001, 0.001)]
        retry = mod.RetryPolicy(res)
        calls = iter([ValueError("x"), 1, ValueError("y"), ValueError("z")])

        def call():
            v = next(calls)
            if isinstance(v, Exception):
                raise v
            return v

        first = retry.run("sampler", call)
        with pytest.raises(mod.StepFailure, match="forward failed"):
            retry.run("forward", call)
        outs.append((admitted, [(r.status, r.error) for r in reqs],
                     adm.counters, levels, deg.counters, deg.chunk(),
                     deg.rung_limit(), first, retry.counters))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# seeded chaos through the engines: the reference's counters exactly
# ---------------------------------------------------------------------------

def _engines(hg, res_kw, inj_kw, model="han", **kw):
    kw = dict(SMALL, model=model, fanout=3, use_pallas=True, **kw)
    ref_cfg, cfg = RefConfig(**kw), HGNNConfig(**kw)
    rm = ref_get_model(ref_cfg)
    rp = rm.init(jax.random.key(0), rm.prepare(hg))
    m = get_model(cfg)
    p = interop.params_from_numpy(rp, device="cpu")
    phg = _port_hg(hg)
    ref_eng = RefEngine(
        rm.executor, rp, RefSampler(rm.plan(), ref_cfg, hg), slots=4,
        slot_targets=2, fn=jax.jit(rm.forward),
        resilience_cfg=ref_res.ResilienceConfig(**res_kw),
        injector=ref_faults.FaultInjector.seeded(**inj_kw))
    eng = HGNNServeEngine(
        m.executor, p, HGNNSampler(m.plan(), cfg, phg), slots=4,
        slot_targets=2, resilience_cfg=resilience.ResilienceConfig(**res_kw),
        injector=faults.FaultInjector.seeded(**inj_kw))
    return ref_eng, eng


def _chaos_requests(cls, n=24, pool=30, seed=0):
    return [cls(targets=r.targets)
            for r in request_queue(pool, 4, n, seed=seed)]


CHAOS = {
    "han-stacked": dict(),
    "han-epilogue": dict(fuse_na_sa=True),
    "rgcn-bucketed": dict(model="rgcn", degree_buckets=3),
    "magnn": dict(model="magnn"),
}


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("variant", list(CHAOS))
def test_seeded_chaos_counters_equal_the_reference(tiny_hg, variant, seed):
    """Transient and persistent sampler faults, a forward fault, injected
    latency over the SLO (``slo_signal="injected"``: replayable), a
    bounded queue: every counter, status and served row set of the port's
    engine equals the reference engine's; OK requests' logits agree."""
    res_kw = dict(max_queue=16, deadline_ms=60_000.0, slo_ms=50.0,
                  slo_signal="injected", degrade_patience=1,
                  recover_patience=2)
    inj_kw = dict(seed=seed, n_steps=16, sampler=2, forward=1,
                  persistent_sampler=1, latency_steps=4, latency_s=0.2)
    ref_eng, eng = _engines(tiny_hg, res_kw, inj_kw, **CHAOS[variant])
    ref_reqs, reqs = (_chaos_requests(RefRequest, seed=seed),
                      _chaos_requests(HGNNRequest, seed=seed))
    for e, rr in ((ref_eng, ref_reqs), (eng, reqs)):
        e.warmup()
        e.serve(rr)
    ref_st, st = ref_eng.stats(), eng.stats()
    assert st["resilience"] == ref_st["resilience"]
    for key in ("steps", "rung_hits", "frontier_bytes", "truncated_rows",
                "compiles_after_warmup"):
        assert st[key] == ref_st[key], key
    assert ch.resilience_record(st) == ch.resilience_record(ref_st)
    assert st["resilience"]["retries"] >= 1  # the schedule fired
    for a, b in zip(ref_reqs, reqs):
        assert (b.status, b.error) == (a.status, a.error)
        np.testing.assert_array_equal(b.served, a.served)
        np.testing.assert_allclose(b.logits, np.asarray(a.logits),
                                   atol=1e-5, rtol=1e-5)
    assert [e.get("failed", False) for e in eng.step_log] == [
        e.get("failed", False) for e in ref_eng.step_log]


def test_deadlines_and_shedding_are_the_reference(tiny_hg):
    """An expired deadline completes PARTIAL (zero rows served), a full
    queue sheds, a malformed request is REJECTED: the reference's
    statuses and counters."""
    res_kw = dict(max_queue=3, deadline_ms=0.0)
    inj_kw = dict(seed=0, n_steps=4)
    ref_eng, eng = _engines(tiny_hg, res_kw, inj_kw)
    out = []
    for e, cls in ((ref_eng, RefRequest), (eng, HGNNRequest)):
        e.warmup()
        reqs = [cls(targets=np.array([1, 2])), cls(targets=np.array([99])),
                cls(targets=np.array([3]), deadline_ms=60_000.0),
                cls(targets=np.array([4])), cls(targets=np.array([5]))]
        e.serve(reqs)
        out.append(([(r.status, r.error, len(r.logits)) for r in reqs],
                    e.stats()["resilience"]))
    assert out[0] == out[1]
    statuses = [s for s, _, _ in out[1][0]]
    assert statuses == ["PARTIAL", "REJECTED", "OK", "PARTIAL", "REJECTED"]


# ---------------------------------------------------------------------------
# BENCH_hgnn.json's serving and chaos rows, at the bench scripts' configs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def imdb():
    return syn.make_dataset("imdb")


@pytest.fixture(scope="module")
def bench_models(imdb):
    """bench_serving.py / bench_resilience.py's model config, built once a
    model: the port's model, parameters (any: the gated counters do not
    read the logits) and sampler."""
    out = {}
    for model in ("han", "rgcn"):
        cfg = HGNNConfig(model=model, dataset="imdb", hidden=64, n_heads=8,
                         n_classes=8, max_degree=32, fused=True, fanout=8)
        m = get_model(cfg)
        batch = m.prepare(imdb, device="cpu")
        params = m.init(torch.Generator().manual_seed(0), batch)
        out[model] = (m, params, HGNNSampler(m.plan(), cfg, imdb))
    return out


def _bench():
    return json.loads((ROOT / "BENCH_hgnn.json").read_text())


@pytest.mark.parametrize("model,slots", [("han", 4), ("han", 8),
                                         ("rgcn", 4), ("rgcn", 8)])
def test_imdb_serving_counters_equal_the_bench_record(bench_models, model,
                                                      slots):
    rec = _bench()["serving"][f"{model}/imdb/s{slots}"]
    m, params, sampler = bench_models[model]
    n_t = sampler.n_target_type
    eng = HGNNServeEngine(m.executor, params, sampler, slots=slots,
                          slot_targets=4)
    eng.warmup()
    reqs = request_queue(n_t, 4, 32)
    eng.serve(reqs)
    st = eng.stats()
    assert sum(len(r.targets) for r in reqs) == rec["targets"]
    assert st["steps"] == rec["steps"]
    assert st["rung_hits"] == {int(k): v for k, v in rec["rung_hits"].items()}
    assert st["frontier_bytes"] == rec["frontier_bytes"]
    assert st["truncated_rows"] == rec["truncated"]
    assert st["compiles_after_warmup"] == rec["recompiles"] == 0
    assert all(r.status == "OK" for r in reqs)


@pytest.mark.parametrize("model", ["han", "rgcn"])
def test_imdb_chaos_counters_equal_the_bench_record(bench_models, model):
    rec = _bench()["resilience"][f"{model}/imdb/chaos"]
    m, params, sampler = bench_models[model]
    inj = faults.FaultInjector.seeded(
        0, n_steps=16, sampler=2, forward=1, persistent_sampler=1,
        latency_steps=4, latency_s=0.2)
    res = resilience.ResilienceConfig(
        max_queue=24, deadline_ms=60_000.0, slo_ms=50.0,
        slo_signal="injected", degrade_patience=1, recover_patience=2)
    eng = HGNNServeEngine(m.executor, params, sampler, slots=4,
                          slot_targets=2, resilience_cfg=res, injector=inj)
    eng.warmup()
    eng.serve(request_queue(sampler.n_target_type, 4, 32, pool=48))
    got = ch.resilience_record(eng.stats())
    assert {k: got[k] for k in CHAOS_KEYS} == {k: rec[k] for k in CHAOS_KEYS}


# ---------------------------------------------------------------------------
# the sink-row arms (ROADMAP Queue 3 check (a))
# ---------------------------------------------------------------------------

def _pad_buckets(n, caps, gen):
    """Rung-shaped buckets as the sampler makes them: each padded to ``n``
    rows, pad row ids ``n`` (one past the table), pad rows all masked."""
    rows = torch.randperm(n, generator=gen)
    live = torch.tensor_split(rows[: n - 3], len(caps))  # 3 rows in none
    out = []
    for part, k in zip(live, caps):
        rid = torch.full((n,), n, dtype=torch.int32)
        rid[: len(part)] = part.int()
        nbr = torch.randint(0, n, (n, k), generator=gen, dtype=torch.int32)
        mask = (torch.rand((n, k), generator=gen) > 0.3).float()
        mask[len(part):] = 0.0
        nbr[len(part):] = 0
        out.append((rid, nbr, mask))
    return out, torch.cat(live)


@pytest.mark.parametrize("use_kernel_arm", [False, True])
def test_bucketed_sink_arms_drop_pad_rows(use_kernel_arm):
    gen = torch.Generator().manual_seed(0)
    n, d = 12, 8
    bks, live = _pad_buckets(n, (2, 4, 6), gen)
    h = torch.randn((n, d), generator=gen)
    agg = (lambda hs, nb, mk: ops.segment_spmm(hs, nb, mk, use_pallas=True)
           ) if use_kernel_arm else None
    with pytest.raises(IndexError):  # the full-graph arm: no pad id allowed
        stages.mean_aggregate_bucketed(h, bks, n, agg_fn=agg)
    out = stages.mean_aggregate_bucketed(h, bks, n, agg_fn=agg, sink=True)
    assert out.shape == (n, d)
    want = torch.zeros((n, d))
    for rid, nbr, mask in bks:
        real = rid < n
        want[rid[real].long()] = ref.segment_spmm(h, nbr[real], mask[real])
    assert torch.equal(out, want)
    dead = torch.ones(n, dtype=torch.bool)
    dead[live] = False
    assert dead.sum() == 3 and (out[dead] == 0).all()

    hh = torch.randn((n, 2, 4), generator=gen)
    p = {"a_dst": torch.randn((2, 4), generator=gen),
         "a_src": torch.randn((2, 4), generator=gen)}
    gat = (lambda *a: ops.gat_aggregate(*a, use_pallas=True)
           ) if use_kernel_arm else None
    out = stages.gat_aggregate_bucketed(p, hh, hh, bks, agg_fn=gat,
                                        sink=True)
    want = torch.zeros_like(hh)
    for rid, nbr, mask in bks:
        real = rid < n
        want[rid[real].long()] = stages.gat_aggregate_padded(
            p, hh[rid[real].long()], hh, nbr[real], mask[real])
    assert out.shape == hh.shape and torch.equal(out, want)
    assert (out[dead] == 0).all()


def test_edge_list_sink_segment_drops_pad_edges():
    """GCN's sampled edge list: pad edges name segment ``n`` (a sorted
    suffix) and gather row 0; with ``sink`` they are summed into a
    segment past the table and sliced away."""
    gen = torch.Generator().manual_seed(1)
    n, d, e_real, e_cap = 9, 5, 14, 27
    seg = torch.full((e_cap,), n, dtype=torch.int32)
    seg[:e_real] = torch.sort(torch.randint(0, n - 2, (e_real,),
                                            generator=gen)).values.int()
    idx = torch.zeros(e_cap, dtype=torch.int32)
    idx[:e_real] = torch.randint(0, n, (e_real,), generator=gen).int()
    h = torch.randn((n, d), generator=gen)
    with pytest.raises(RuntimeError, match="out of bounds"):
        stages.mean_aggregate_csr(h, seg, idx, n)
    out = stages.mean_aggregate_csr(h, seg, idx, n, sink=True)
    want = stages.mean_aggregate_csr(h, seg[:e_real], idx[:e_real], n)
    assert out.shape == (n, d) and torch.equal(out, want)
    assert (out[n - 2:] == 0).all()
