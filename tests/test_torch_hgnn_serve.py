"""Request-path serving of the port (``serve/engine.py``'s
``HGNNServeEngine`` and ``HGNNRequest``, the executor's sampled arms,
``stage_records(sample_meta=...)``, the CLI's ``--fanout``) against
``repro.serve.engine``.

The same requests go through the reference's engine and the port's, on
the reference's own parameters (``interop.params_from_numpy``), on the
tiny graph of ``tests/test_stage_pipeline.py`` (GCN: the Reddit-like
graph at scale 0.005): each request's logits agree within
``atol=rtol=1e-5``; statuses, ``rung_hits``, ``steps``,
``frontier_bytes``, ``truncated_rows`` and the residency counters are
exactly equal; ``compiles_after_warmup`` is 0.  Full fan-out at an
identity rung over every target is bitwise the full-graph forward (ROADMAP
invariant 3)."""
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
from repro.serve.engine import HGNNRequest as RefRequest
from repro.serve.engine import HGNNServeEngine as RefEngine
from repro.serve.sampler import HGNNSampler as RefSampler
from repro_torch import interop
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import characterize as ch
from repro_torch.core import hgraph
from repro_torch.core.models import get_model
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.launch.serve import request_queue
from repro_torch.serve.engine import HGNNRequest, HGNNServeEngine
from repro_torch.serve.sampler import HGNNSampler

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             attn_hidden=8, max_degree=6, max_instances=4, fused=True)
# sampled serving per executor arm; small fan-outs subsample, and every
# batch carries pad rows (and, bucketed, pad row ids; GCN, pad edges)
VARIANTS = {
    "han-stacked": dict(model="han", fanout=3, use_pallas=True),
    "han-epilogue": dict(model="han", fanout=3, use_pallas=True,
                         fuse_na_sa=True),
    "han-epilogue-L2": dict(model="han", fanout=2, use_pallas=True,
                            fuse_na_sa=True, layers=2),
    "han-bucketed": dict(model="han", fanout=4, use_pallas=True,
                         degree_buckets=3),
    "rgcn-padded": dict(model="rgcn", fanout=3, use_pallas=True),
    "rgcn-bucketed-L2": dict(model="rgcn", fanout=4, use_pallas=True,
                             degree_buckets=3, layers=2),
    "magnn": dict(model="magnn", fanout=2, use_pallas=True),
    "gcn": dict(model="gcn", dataset="reddit", fanout=3),
}


@pytest.fixture(autouse=True)
def _tiny_tables():
    for mod in (ref_syn, syn):
        mod.DATASET_METAPATHS["tiny"] = [["M", "D", "M"], ["M", "A", "M"]]
        mod.DATASET_TARGET["tiny"] = "M"


@pytest.fixture(scope="module")
def reddit_hg():
    return ref_syn.make_reddit_like(scale=0.005)


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


def _build(hg, **kw):
    """Both packages' model, parameters (the reference's) and sampler."""
    kw = dict(SMALL, **kw)
    ref_cfg, cfg = RefConfig(**kw), HGNNConfig(**kw)
    rm = ref_get_model(ref_cfg)
    rb = rm.prepare(hg)
    rp = rm.init(jax.random.key(0), rb)
    m = get_model(cfg)
    phg = _port_hg(hg)
    b = m.prepare(phg, device="cpu")
    p = interop.params_from_numpy(rp, device="cpu")
    return (rm, rp, rb, RefSampler(rm.plan(), ref_cfg, hg),
            m, p, b, HGNNSampler(m.plan(), cfg, phg))


def _requests(cls, n, n_nodes, seed=3, pool=None):
    return [cls(targets=r.targets) for r in request_queue(
        n_nodes, 4, n, pool=pool, seed=seed)]


def _same_counters(ref_st, st):
    for key in ("steps", "rung_hits", "frontier_bytes", "truncated_rows"):
        assert st[key] == ref_st[key], key
    assert st["compiles_after_warmup"] == 0
    assert ref_st["compiles_after_warmup"] == 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_served_logits_and_counters_equal_the_reference(tiny_hg, reddit_hg,
                                                        variant):
    kw = VARIANTS[variant]
    hg = reddit_hg if kw.get("dataset") == "reddit" else tiny_hg
    rm, rp, _, rs, m, p, _, s = _build(hg, **kw)
    n_t = hg.node_counts[s.target]
    ref_eng = RefEngine(rm.executor, rp, rs, slots=4, slot_targets=2,
                        fn=jax.jit(rm.forward))
    eng = HGNNServeEngine(m.executor, p, s, slots=4, slot_targets=2)
    assert eng.device == torch.device("cpu")
    ref_reqs, reqs = (_requests(RefRequest, 10, n_t),
                      _requests(HGNNRequest, 10, n_t))
    ref_eng.warmup()
    eng.warmup()
    ref_eng.serve(ref_reqs)
    ops.reset_launch_counts()
    assert eng.serve(reqs) is reqs
    # on the CPU the kernel arms run their plain versions: no launch
    assert set(ops.launch_counts().values()) == {0}
    for a, b in zip(ref_reqs, reqs):
        assert (b.status, b.error) == (a.status, a.error) == ("OK", None)
        np.testing.assert_array_equal(b.served, a.served)
        assert b.logits.dtype == np.float32
        np.testing.assert_allclose(b.logits, np.asarray(a.logits), **TOL)
    ref_st, st = ref_eng.stats(), eng.stats()
    _same_counters(ref_st, st)
    assert st["resilience"] == ref_st["resilience"]
    assert len(st["rung_hits"]) >= 1 and st["steps"] > 1
    for e in eng.step_log:
        assert e["sample_s"] + e["forward_s"] <= e["wall_s"] + 1e-9


SAMPLED_MATRIX = {
    "han-stacked": dict(model="han"),
    "han-stacked-L2": dict(model="han", layers=2),
    "han-epilogue": dict(model="han", fuse_na_sa=True),
    "han-bucketed": dict(model="han", degree_buckets=3),
    "han-bucketed-L2": dict(model="han", degree_buckets=3, layers=2),
    "rgcn-padded": dict(model="rgcn"),
    "rgcn-padded-L2": dict(model="rgcn", layers=2),
    "rgcn-bucketed": dict(model="rgcn", degree_buckets=3),
    "magnn": dict(model="magnn"),
    "magnn-L2": dict(model="magnn", layers=2),
    "gcn": dict(model="gcn", dataset="reddit"),
    "gcn-L2": dict(model="gcn", dataset="reddit", layers=2),
}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("variant", list(SAMPLED_MATRIX))
def test_full_fanout_identity_serve_is_bitwise_the_full_graph(
        tiny_hg, reddit_hg, variant, use_pallas):
    """Fan-out past every degree and one exact-size rung: the engine
    serves all targets in one step of the identity relabeling, and each
    request's rows are bitwise the full-graph forward's (the sink rows of
    the bucketed and edge-list arms change nothing)."""
    kw = dict(SAMPLED_MATRIX[variant], fanout=4096, use_pallas=use_pallas)
    hg = reddit_hg if kw.get("dataset") == "reddit" else tiny_hg
    n = hg.node_counts["N" if kw.get("dataset") == "reddit" else "M"]
    kw["sample_ladder"] = ((n, n),)
    _, _, _, _, m, p, b, s = _build(hg, **kw)
    with torch.inference_mode():
        full = m.forward(p, b).numpy()
    eng = HGNNServeEngine(m.executor, p, s, slots=1, slot_targets=n)
    eng.warmup()
    reqs = [HGNNRequest(targets=np.arange(n)[::-1].copy()),
            HGNNRequest(targets=np.array([3, 1, 3]))]
    eng.serve(reqs)
    st = eng.stats()
    assert st["rung_hits"] == {0: 2} and st["truncated_rows"] == 0
    assert st["compiles_after_warmup"] == 0
    for r in reqs:
        assert r.status == "OK"
        np.testing.assert_array_equal(r.logits, full[r.targets])


def test_cached_serving_counters_equal_the_reference(tiny_hg):
    """With residency the engine runs every step's sampled frontier
    through its live per-type ``HotRowCache`` (in-flight targets pinned):
    the counters equal the reference engine's, and the logits are the
    uncached serve's, bitwise."""
    out = {}
    for c in (0, 6):
        kw = dict(model="rgcn", fanout=3, cache_rows=c)
        rm, rp, _, rs, m, p, _, s = _build(tiny_hg, **kw)
        ref_eng = RefEngine(rm.executor, rp, rs, slots=3, slot_targets=2,
                            fn=jax.jit(rm.forward))
        eng = HGNNServeEngine(m.executor, p, s, slots=3, slot_targets=2)
        ref_reqs = _requests(RefRequest, 8, 40, seed=5)
        reqs = _requests(HGNNRequest, 8, 40, seed=5)
        ref_eng.warmup()
        eng.warmup()
        ref_eng.serve(ref_reqs)
        eng.serve(reqs)
        ref_st, st = ref_eng.stats(), eng.stats()
        _same_counters(ref_st, st)
        assert st.get("residency") == ref_st.get("residency")
        out[c] = [r.logits for r in reqs]
    assert out[6] and all(np.array_equal(a, b)
                          for a, b in zip(out[0], out[6]))
    assert out and "residency" in st and st["residency"]["hits"] > 0


def test_sample_stage_record_rides_stage_records(tiny_hg):
    """``stage_records(sample_meta=...)`` adds the SAMPLE record first —
    the reference's ``sample_traffic`` of the batch's meta — and keeps it
    out of ``total``."""
    _, _, _, rs, m, p, _, s = _build(tiny_hg, model="han", fanout=4,
                                     use_pallas=True, fuse_na_sa=True)
    sb = s.sample(np.arange(10))
    recs = m.executor.stage_records(p, sb.batch, sample_meta=sb.meta)
    names = list(recs["stages"])
    assert names == ["SAMPLE", "FP", "NA", "SA", "head"]
    from repro.core.characterize import sample_traffic

    assert recs["stages"]["SAMPLE"] == sample_traffic(rs.sample(
        np.arange(10)).meta) == ch.sample_traffic(sb.meta)
    assert recs["total"]["flops"] == pytest.approx(
        sum(r["flops"] for n, r in recs["stages"].items() if n != "SAMPLE"))
    plain = m.executor.stage_records(p, sb.batch)
    assert plain["total"] == recs["total"]


def test_serve_engine_refusals_and_stats_before_warmup(tiny_hg):
    _, _, _, _, m, p, _, s = _build(tiny_hg, model="han", fanout=3)
    with pytest.raises(ValueError, match="slots\\*slot_targets"):
        HGNNServeEngine(m.executor, p, s, slots=8, slot_targets=32)
    eng = HGNNServeEngine(m.executor, p, s, slots=2, slot_targets=2)
    assert eng.stats()["compiles_after_warmup"] is None
    assert eng.warmup() == len(s.ladder)
    assert eng.stats()["compiles_after_warmup"] == 0


def test_compiles_after_warmup_counts_only_this_engines_forwards(tiny_hg):
    """What another engine or kernel call in the process makes after this
    engine's warmup is not counted against it; what its own forwards make
    is."""
    from repro_torch.kernels import build

    _, _, _, _, m, p, _, s = _build(tiny_hg, model="han", fanout=3)
    made = {"n": 0}

    def fn(params, batch):
        build.created += made["n"]
        return m.forward(params, batch)

    eng = HGNNServeEngine(m.executor, p, s, slots=2, slot_targets=2, fn=fn)
    before = build.created
    try:
        made["n"] = 1  # each warmup forward makes one buffer: not counted
        eng.warmup()
        build.created += 5  # another caller in the process
        made["n"] = 0
        eng.serve(_requests(HGNNRequest, 3, s.n_target_type))
        assert eng.stats()["compiles_after_warmup"] == 0
        made["n"] = 1  # now every served forward makes one
        eng.serve(_requests(HGNNRequest, 3, s.n_target_type))
        assert eng.stats()["compiles_after_warmup"] == eng.stats()["steps"]
    finally:
        build.created = before


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)


def test_cli_serves_han_imdb_with_the_reference_counters():
    """The slice's command on the CPU: the reference CLI's counters for
    the same flags (``max_degree`` 64; the reference prints
    ``frontier_bytes=15845088 ... rung_hits=1:7``), zero recompiles,
    every request OK, and the SAMPLE line."""
    out = _cli("--hgnn", "han", "--dataset", "imdb", "--use-pallas",
               "--fuse-na-sa", "--fanout", "8", "--slots", "8",
               "--slot-targets", "4", "--requests", "32", "--device", "cpu",
               "--characterize")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "device: cpu (host CPU)"
    assert lines[1].startswith(
        "serve han/imdb requests=32 targets=164 slots=8 slot_targets=4 "
        "fanout=8 steps=7 recompiles=0 frontier_bytes=15845088 "
        "truncated=0 rung_hits=1:7 warmup_ms=")
    assert lines[2] == (
        "  resilience: ok=32 partial=0 failed=0 rejected=0 shed=0 "
        "retries=0 failed_steps=0 deadline_expired=0 degrade_steps=0 "
        "max_degrade_level=0 failovers=0")
    assert lines[3] == ("  SAMPLE: rung=[32, 544] n_targets=10 "
                        "frontier_rows=32 frontier_bytes=3.92e+05 "
                        "index_bytes=6.96e+04")
    assert [ln.split(":")[0] for ln in lines[4:]] == [
        "  FP", "  NA", "  SA", "  head"]
