"""The port's compiled step (``src/repro_torch/graphs.py``, the counterpart
of the reference's ``jax.jit``), its use by the engines and
``build_hgnn_infer``, and the launch counters it replays.

There is no card here, so capture and replay are driven through a stand-in
for the module's CUDA calls (``tests/torch_fake_card.FakeCard``, installed
with ``monkeypatch``): a tensor whose storage ``on_card`` marked (or a view
of it) counts as one on the card, staging is "pinned", a "graph" is ``fn``
itself (a capture puts the marked storages back as they were, since a
real capture runs nothing), and its replay runs ``fn`` again on the
graph's static upload buffers and copies the result into the captured
output, with the launch counters left as a real replay leaves them.  On it: one capture a
signature (a rung of a tiny-graph serve, a rung and K after a failover),
``compiles_after_warmup`` equal to the JAX engine's, a held tensor that
moved raising, each replay adding its capture's launches (a capture that
records other launches than its warm-up ran raising), outputs never
aliased across calls, served logits bitwise the eager engine's with the
feature tables uploaded straight from the engine's pinned rows, and one
set of decode caches held over waves of two sizes.  Off the stand-in,
``compiled`` calls ``fn`` itself, bitwise, and counts its signatures;
the sampler's ``alloc`` gives the same batch.

Stability: inputs from fixed numpy seeds and a fixed graph; no clock, no
subprocess; the dataset registries and the module seams are touched only
through ``monkeypatch``.  Well under 30 s on one worker."""
import importlib
import pkgutil

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import HGNNConfig as RefConfig
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro.serve.engine import HGNNRequest as RefRequest
from repro.serve.engine import HGNNServeEngine as RefEngine
from repro.serve.faults import Fault as RefFault
from repro.serve.faults import FaultInjector as RefInjector
from repro.serve.sampler import HGNNSampler as RefSampler
from repro_torch import graphs, interop, tree
from repro_torch import kernels as kernel_pkg
from repro_torch.configs.base import HGNNConfig
from repro_torch.configs.registry import get_reduced
from repro_torch.core import hgraph
from repro_torch.core.models import get_model
from repro_torch.data import synthetic as syn
from repro_torch.kernels import build, ops
from repro_torch.launch.serve import build_hgnn_infer
from repro_torch.serve.engine import (HGNNInferEngine, HGNNRequest,
                                      HGNNServeEngine, Request, ServeEngine,
                                      _shapes)
from repro_torch.serve.faults import Fault, FaultInjector
from repro_torch.serve.sampler import HGNNSampler
from torch_fake_card import ON_CARD, FakeCard, on_card

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             attn_hidden=8, max_degree=6, max_instances=4, fused=True)
# (t_cap, f_cap) rungs of distinct shapes on the 40-movie tiny graph
LADDER = ((4, 12), (8, 24), (16, 40))


@pytest.fixture
def card(monkeypatch):
    fake = FakeCard()
    monkeypatch.setattr(graphs, "_card", fake)
    ops.reset_launch_counts()
    ON_CARD.clear()
    yield fake
    ON_CARD.clear()
    ops.reset_launch_counts()


@pytest.fixture(autouse=True)
def _tiny_tables(monkeypatch):
    for mod in (ref_syn, syn):
        monkeypatch.setitem(mod.DATASET_METAPATHS, "tiny",
                            [["M", "D", "M"], ["M", "A", "M"]])
        monkeypatch.setitem(mod.DATASET_TARGET, "tiny", "M")


def _step(p, x, scale):
    """A stand-in step: two "launches" of ``segment_sum`` a call."""
    import repro_torch.kernels.segment_sum as ssum

    ssum.segment_sum.launches += 2
    return {"y": x.float() @ p["w"] * scale, "n": x.shape[0]}


def _params(rng, d=4):
    return on_card({"w": torch.from_numpy(
        rng.standard_normal((d, 3)).astype(np.float32))})


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def test_off_the_card_fn_is_called_as_it_is(monkeypatch):
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.standard_normal((4, 3)).astype(
        np.float32))}
    x = torch.from_numpy(rng.standard_normal((5, 4)).astype(np.float32))
    seen = []

    def fn(p, x):
        seen.append(x)
        return x @ p["w"]

    f = graphs.compiled(fn)
    out = f(p, x)
    assert seen == [x]  # the caller's own tensor, no copy, no upload
    assert torch.equal(out, x @ p["w"])
    assert (f.captures, f.replays, f.graphs) == (0, 0, {})
    assert not graphs.on_card((p, x))


def test_one_capture_a_signature_and_launches_once_a_call(card):
    rng = np.random.default_rng(1)
    p = _params(rng)
    f = graphs.compiled(_step)
    xs = [rng.standard_normal((5, 4)).astype(np.float32) for _ in range(3)]
    wide = rng.standard_normal((7, 4)).astype(np.float32)
    for i, x in enumerate(xs):
        out = f(p, x, 0.5)
        # each call sees its own host batch: uploaded into the buffers
        np.testing.assert_array_equal(
            out["y"].numpy(), (torch.from_numpy(x) @ p["w"] * 0.5).numpy())
        assert out["n"] == 5
        assert ops.launch_counts()["segment_sum"] == 2 * (i + 1)
    assert (f.captures, f.replays, card.captured) == (1, 2, 1)
    f(p, wide, 0.5)  # a new shape
    f(p, xs[0], 2.0)  # a new scalar
    f(p, torch.from_numpy(xs[0]), 0.5)  # a CPU tensor: the same signature
    assert (f.captures, f.replays) == (3, 3)
    assert ops.launch_counts()["segment_sum"] == 2 * 6
    g = next(iter(f.graphs.values()))
    assert g.launches["segment_sum"] == sum(g.launches.values()) == 2
    assert g.upload_bytes == 5 * 4 * 4


def test_a_held_tensor_that_moved_raises(card):
    rng = np.random.default_rng(2)
    p = _params(rng)
    x = rng.standard_normal((5, 4)).astype(np.float32)
    f = graphs.compiled(_step)
    f(p, x, 1.0)
    f(p, x, 1.0)
    moved = on_card({"w": p["w"].clone()})
    with pytest.raises(RuntimeError, match="moved since its graph"):
        f(moved, x, 1.0)
    square = on_card({"w": torch.zeros(4, 4)})
    g = graphs.compiled(lambda p, x: x @ p["w"])
    g(square, x)
    strided = on_card({"w": square["w"].t()})  # same address, new strides
    with pytest.raises(RuntimeError, match="moved since its graph"):
        g(strided, x)
    assert (f.captures, f.replays) == (1, 1)


def test_outputs_are_the_callers_and_held_outputs_are_the_inputs(card):
    rng = np.random.default_rng(3)
    cache = on_card(torch.zeros(5, 3))

    def fn(p, x, cache):
        y = x @ p["w"]
        cache.copy_(y)  # a held input written in place, as the decode's
        return y, cache

    p = _params(rng)
    f = graphs.compiled(fn)
    xs = [rng.standard_normal((5, 4)).astype(np.float32) for _ in range(3)]
    outs = [f(p, x, cache) for x in xs]
    firsts = [o[0].clone() for o in outs]
    for (y, c), x, kept in zip(outs, xs, firsts):
        assert c is cache
        assert torch.equal(y, kept)  # unchanged by the later replays
        assert torch.equal(y, torch.from_numpy(x) @ p["w"])
    g = next(iter(f.graphs.values()))
    ptrs = {o[0].data_ptr() for o in outs} | {g.out[0].data_ptr()}
    assert len(ptrs) == 4
    assert torch.equal(cache, outs[-1][0])


def test_launches_are_the_captures_and_must_be_the_warm_ups(card):
    """A graph's launches are what its capture recorded; a step whose
    capture records other launches than its warm-up ran raises."""
    import repro_torch.kernels.segment_sum as ssum

    rng = np.random.default_rng(4)
    p = _params(rng)
    calls = []

    def drifting(p, x):
        calls.append(1)
        ssum.segment_sum.launches += len(calls)  # 1 at warm-up, 2 captured
        return x @ p["w"]

    f = graphs.compiled(drifting)
    with pytest.raises(RuntimeError, match="does not launch the same"):
        f(p, rng.standard_normal((5, 4)).astype(np.float32))
    assert f.captures == 0 and f.graphs == {}


def test_signatures_are_counted_off_the_card_too():
    rng = np.random.default_rng(6)
    p = {"w": torch.from_numpy(rng.standard_normal((4, 3)).astype(
        np.float32))}
    f = graphs.compiled(_step)
    def x(n):
        return torch.from_numpy(rng.standard_normal((n, 4)).astype(
            np.float32))

    for n in (5, 5, 7, 5):
        f(p, x(n), 1.0)
    f(p, x(5), 2.0)
    assert (f.signatures, f.captures, f.replays) == (3, 0, 0)


def _no_group_mesh(monkeypatch):
    """A one-rank ``DeviceMesh`` on the CPU with no process group (this
    process's rank taken as 0): DTensor metadata and dispatch, no
    collective."""
    import torch.distributed.device_mesh as dm

    monkeypatch.setattr(dm, "get_rank", lambda *a, **k: 0)
    return dm.DeviceMesh("cpu", [0], _init_backend=False)


@pytest.mark.parametrize("leaf", ["unhashable", "dtensor"])
def test_a_dtensor_or_an_unhashable_leaf_raises(card, monkeypatch, leaf):
    """An unhashable leaf raises; a DTensor leaf, which raised before the
    mesh steps were compiled, is held through its local tensor, with its
    mesh and placements in the signature."""
    class Unhashable:
        __hash__ = None

    if leaf == "unhashable":
        f = graphs.compiled(lambda *a: a)
        with pytest.raises(TypeError, match="neither an array nor hashable"):
            f(on_card(torch.zeros(2)), Unhashable())
        assert f.captures == 0
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = _no_group_mesh(monkeypatch)
    rng = np.random.default_rng(5)
    w = on_card(torch.from_numpy(rng.standard_normal((6, 3)).astype(
        np.float32)))
    d = DTensor.from_local(w, mesh, [Shard(0)], run_check=False)
    f = graphs.compiled(lambda w, x: w * x)
    for x in (2.0, 2.0, 3.0):
        out = f(d, x)
        assert isinstance(out, DTensor) and out.placements == (Shard(0),)
        assert torch.equal(out.to_local(), w * x)
    assert (f.captures, f.replays) == (2, 1)
    g = f.graph_of(d, 2.0)
    assert [i for i, _, _ in g.held] == [0]
    assert g.held[0][1] == w.data_ptr()
    sig = next(k for k, v in f.graphs.items() if v is g)
    assert sig[1][0][0] == "held"
    spec = sig[1][0][-1]  # the DTensorSpec: mesh, placements, shape, stride
    assert spec.mesh == mesh and spec.placements == (Shard(0),)
    assert tuple(spec.tensor_meta.shape) == (6, 3)
    assert tuple(spec.tensor_meta.stride) == (3, 1)
    rep = DTensor.from_local(w, mesh, [Replicate()], run_check=False)
    f(rep, 2.0)  # other placements: another signature
    assert f.captures == 3
    moved = DTensor.from_local(on_card(w.clone()), mesh, [Shard(0)],
                               run_check=False)
    with pytest.raises(RuntimeError, match="moved since its graph"):
        f(moved, 2.0)


# ---------------------------------------------------------------------------
# the launch counters
# ---------------------------------------------------------------------------


def test_pinned_rows_hand_out_a_ring_of_reserved_tables(card):
    from repro_torch.serve.engine import _PinnedRows

    rows = _PinnedRows()
    first = rows.reserve("M", (6, 3), np.float32)
    ring = [first] + [rows("M", (6, 3), np.float32)
                      for _ in range(rows.DEPTH)]
    assert ring[-1] is first  # DEPTH tables, in turn
    assert len({id(a) for a in ring}) == rows.DEPTH
    assert all(card.pinned(torch.from_numpy(a)) for a in ring)
    other = rows("M", (7, 3), np.float32)  # not reserved: a new array
    assert other.shape == (7, 3) and not card.pinned(torch.from_numpy(other))


@pytest.mark.parametrize("model", ["han", "rgcn", "magnn", "gcn"])
def test_sampler_alloc_gives_the_same_batch(tiny_hg, model):
    """Feature tables written into arrays the caller hands out (dirty, as
    a reused pinned row is) are byte-equal to the sampler's own."""
    kw = dict(SMALL, model=model, fanout=3, sample_ladder=LADDER,
              use_pallas=True)
    hg = _port_hg(tiny_hg)
    if model == "gcn":
        kw.update(dataset="reddit", sample_ladder=((4, 40), (8, 80)))
        hg = syn.make_reddit_like(scale=0.005)
    cfg = HGNNConfig(**kw)
    m = get_model(cfg)
    sampler = HGNNSampler(m.plan(), cfg, hg)
    handed = []

    def alloc(t, shape, dtype):
        handed.append(t)
        return np.full(shape, 7, dtype)

    rng = np.random.default_rng(8)
    for n in (3, 8):
        ids = rng.choice(sampler.n_target_type, n, replace=False)
        want = tree.leaves(sampler.sample(ids).batch)
        got = tree.leaves(sampler.sample(ids, alloc=alloc).batch)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b)
            else:
                assert a == b
    assert handed


def test_launch_counts_cover_every_kernel_counter():
    found = set()
    for info in pkgutil.iter_modules(kernel_pkg.__path__):
        mod = importlib.import_module(f"repro_torch.kernels.{info.name}")
        for obj in vars(mod).values():
            if callable(obj) and getattr(obj, "__module__", None) == \
                    mod.__name__:
                found |= {(obj, a) for a in vars(obj) if a.endswith(
                    "launches")}
    assert found and found == set(ops.COUNTERS.values())
    assert set(ops.launch_counts()) == set(ops.COUNTERS)
    ops.reset_launch_counts()
    ops.add_launch_counts({"decode_attention_lse": 3, "gat_na": 1})
    counts = ops.launch_counts()
    assert counts["decode_attention_lse"] == 3 and counts["gat_na"] == 1
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


def test_scratch_is_never_made_or_grown_in_a_capture(monkeypatch):
    monkeypatch.setattr(build, "_scratch", {})
    monkeypatch.setattr(build, "created", 0)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    first = build.scratch("t", 8, torch.int32, "cpu", 7)
    capturing[0] = True
    with pytest.raises(RuntimeError, match="keeps none"):
        build.scratch("t", 8, torch.int32, "cpu", 7)
    kept = []
    with build.keeping(kept):
        with pytest.raises(RuntimeError, match="while the stream captures"):
            build.scratch("t", 9, torch.int32, "cpu", 7)
        with pytest.raises(RuntimeError, match="while the stream captures"):
            build.scratch("u", 1, torch.int32, "cpu", 7)
        assert build.scratch("t", 8, torch.int32, "cpu", 7) is first
        assert build.scratch("t", 4, torch.int32, "cpu", 7) is first
    assert kept == [first] and build._taken is None
    capturing[0] = False
    grown = build.scratch("t", 16, torch.int32, "cpu", 7)
    assert grown is not first and grown.numel() == 16
    assert kept == [first]  # the graph's buffer stays with the graph
    assert build.created == 2


# ---------------------------------------------------------------------------
# the engines and build_hgnn_infer
# ---------------------------------------------------------------------------


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


def _requests(cls, n, seed=3, n_nodes=40):
    rng = np.random.default_rng(seed)
    return [cls(targets=rng.integers(0, n_nodes, size=int(rng.integers(1, 9))))
            for _ in range(n)]


def test_build_hgnn_infer_and_engine_on_the_cpu_run_fn(tiny_hg):
    cfg = HGNNConfig(**dict(SMALL, model="han", use_pallas=True))
    b = build_hgnn_infer(cfg, _port_hg(tiny_hg), "cpu")
    assert not isinstance(b.fn, graphs.Compiled)
    eng = HGNNInferEngine(b.executor, b.params, b.batch)
    assert isinstance(eng.fn, graphs.Compiled)
    with torch.inference_mode():
        want = b.fn(b.params, b.batch)
    assert torch.equal(eng.infer(), want)
    assert (eng.fn.captures, eng.fn.replays) == (0, 0)


@pytest.mark.parametrize("model", ["han", "rgcn", "magnn"])
def test_infer_engine_replays_bitwise_the_eager_forward(card, tiny_hg, model):
    cfg = HGNNConfig(**dict(SMALL, model=model, use_pallas=True))
    b = build_hgnn_infer(cfg, _port_hg(tiny_hg), "cpu")
    on_card((b.params, b.batch))
    eager = HGNNInferEngine(b.executor, b.params, b.batch, fn=b.fn)
    eng = HGNNInferEngine(b.executor, b.params, b.batch)
    want = eager.infer()
    first = eng.infer()
    kept = first.clone()
    second = eng.infer()
    assert torch.equal(first, want) and torch.equal(second, want)
    assert torch.equal(first, kept) and first.data_ptr() != \
        second.data_ptr()
    assert (eng.fn.captures, eng.fn.replays) == (1, 1)
    assert next(iter(eng.fn.graphs.values())).uploads == []  # held, whole


def _serve_both(tiny_hg, fault=None, **kw):
    """The JAX engine and the port's on the fake card (parameters held,
    each sampled batch uploaded), and the port's eager engine, on the same
    requests and the reference's parameters."""
    kw = dict(SMALL, fanout=3, sample_ladder=LADDER, **kw)
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
    out = []
    for fn, params in ((m.executor.forward, p), (None, on_card(
            tree.map(torch.clone, p)))):
        eng = HGNNServeEngine(m.executor, params,
                              HGNNSampler(m.plan(), cfg, hg), slots=4,
                              slot_targets=2, fn=fn,
                              injector=(FaultInjector([Fault(**fault)])
                                        if fault else None))
        rungs = eng.warmup()
        reqs = _requests(HGNNRequest, 10)
        eng.serve(reqs)
        out.append((eng, reqs, rungs))
    return (ref_eng, ref_reqs), out[0], out[1]


def _served_rungs(eng, after=0):
    return {e["rung_index"] for e in eng.step_log[after:]
            if not e.get("failed")}


@pytest.mark.parametrize("model", ["han", "rgcn"])
def test_serve_captures_one_graph_a_rung(card, tiny_hg, model):
    (ref_eng, ref_reqs), (eager, e_reqs, _), (eng, reqs, rungs) = \
        _serve_both(tiny_hg, model=model, use_pallas=True)
    assert eng._captured and not eager._captured
    sigs = {_shapes(eng.sampler.dummy_batch(i).batch) for i in range(rungs)}
    assert eng.fn.captures == len(eng.fn.graphs) == len(sigs) == rungs == 3
    assert eng.fn.replays == eng.stats()["steps"]
    st, ref_st = eng.stats(), ref_eng.stats()
    assert st["compiles_after_warmup"] == ref_st["compiles_after_warmup"] \
        == eager.stats()["compiles_after_warmup"] == 0
    for key in ("steps", "rung_hits", "frontier_bytes", "truncated_rows"):
        assert st[key] == ref_st[key], key
    for a, e, r in zip(reqs, e_reqs, ref_reqs):
        assert a.status == e.status == r.status == "OK"
        np.testing.assert_array_equal(a.logits, e.logits)
        np.testing.assert_allclose(a.logits, np.asarray(r.logits), **TOL)
    # every upload buffer is the engine's own: no sampled batch is held;
    # the feature tables of the two smaller rungs come straight from the
    # engine's pinned rows (no staging made for them; the largest rung
    # covers the tiny graph, whose own tables it takes), the index tables
    # through staging
    direct = []
    for g in eng.fn.graphs.values():
        assert g.uploads and not any(
            graphs._card.resident(g.inputs[i]) for i, _, _ in g.uploads)
        assert any(pin is not None for _, pin, _ in g.uploads)
        direct.append(sum(pin is None for _, pin, _ in g.uploads))
    assert sorted(direct)[1] > 0 and eng._rows._rings and eager._rows is None


@pytest.mark.parametrize("model", ["han", "magnn"])
def test_failover_captures_one_graph_a_rung_and_k(card, tiny_hg, model):
    fault = dict(step=2, kind="partition", partition=1)
    (ref_eng, ref_reqs), (eager, e_reqs, _), (eng, reqs, rungs) = \
        _serve_both(tiny_hg, fault=fault, model=model, partitions=4,
                    use_pallas=True)
    st, ref_st = eng.stats(), ref_eng.stats()
    assert st["resilience"]["partition_failovers"] == 1
    assert eng._serve_plan.partition.k == 3
    after = _served_rungs(eng, after=2)
    assert eng.fn.captures == rungs + len(after)
    assert st["compiles_after_warmup"] == len(after) \
        == ref_st["compiles_after_warmup"] \
        == eager.stats()["compiles_after_warmup"]
    for a, e, r in zip(reqs, e_reqs, ref_reqs):
        assert a.status == e.status == r.status == "OK"
        np.testing.assert_array_equal(a.logits, e.logits)
        np.testing.assert_allclose(a.logits, np.asarray(r.logits), **TOL)


@pytest.mark.parametrize("name", ["granite-8b", "mamba2-2.7b",
                                  "zamba2-1.2b"])
def test_decode_caches_kept_across_waves_give_fresh_caches_tokens(name):
    """The engine keeps one set of decode caches a wave batch size and
    grafts each wave into them (attention zeroed first, Mamba states
    copied in): a wave after a longer one gives the tokens of an engine
    that serves it first, on fresh caches."""
    cfg = get_reduced(name)
    params = _params_lm(cfg)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (32, 16, 16, 16)]

    def reqs(ps):
        return [Request(prompt=p, max_tokens=5) for p in ps]

    eng = ServeEngine(cfg, params, batch_slots=2, max_len=40)
    both = eng.generate(reqs(prompts))
    assert all(t.shape[1] == 2 for c in eng._caches
               for t in (c if isinstance(c, tuple) else c.values()))
    alone = ServeEngine(cfg, params, batch_slots=2, max_len=40).generate(
        reqs(prompts[2:]))
    assert [r.out_tokens for r in both[2:]] == [r.out_tokens for r in alone]
    assert all(len(r.out_tokens) == 5 for r in both)


def _params_lm(cfg):
    from repro_torch.nn import transformer as tf

    return tf.init_lm_params(torch.Generator().manual_seed(0), cfg)


def _tensor_bytes(ts):
    """Bytes of the distinct storages under ``ts``."""
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in ts}.values())


def test_decode_holds_one_cache_set_over_waves_of_two_sizes(card,
                                                            monkeypatch):
    """Waves of 3 and 1, served twice over on the stand-in card: one graph a
    wave size, both reading rows of the one set of caches the engine made
    for its 3 slots; the engine holds those caches and nothing of a
    second set; the tokens are an uncompiled engine's."""
    from repro_torch.serve import engine as engine_mod

    cfg = get_reduced("granite-8b")
    params = _params_lm(cfg)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (24, 16, 8, 16)]

    def reqs():
        return [Request(prompt=p, max_tokens=4) for p in prompts]

    want = ServeEngine(cfg, params, batch_slots=3, max_len=32).generate(
        reqs())
    made = []

    def init(*a, **k):
        made.append(on_card(engine_mod.tf.init_kv_caches.__wrapped__(
            *a, **k)))
        return made[-1]

    init.__wrapped__ = engine_mod.tf.init_kv_caches
    monkeypatch.setattr(engine_mod.tf, "init_kv_caches", init)
    eng = ServeEngine(cfg, on_card(tree.map(torch.clone, params)),
                      batch_slots=3, max_len=32)
    on_card([eng._token, eng._pos])
    got = eng.generate(reqs()) + eng.generate(reqs())
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want] * 2
    assert len(made) == 1 and eng._caches is made[0]
    dec = eng._decode
    assert dec.captures == len(dec.graphs) == 2  # waves of 3 and of 1
    assert dec.replays == 2 * 2 * 3 - 2
    held = [g.inputs[i] for g in dec.graphs.values() for i, _, _ in g.held]
    one_set = _tensor_bytes(tree.leaves(
        engine_mod.tf.init_kv_caches.__wrapped__(cfg, 3, 32, "cpu")))
    caches = tree.leaves(eng._caches)
    assert _tensor_bytes(caches) == one_set
    params_bytes = _tensor_bytes(tree.leaves(eng.params))
    assert _tensor_bytes(held) == params_bytes + one_set + _tensor_bytes(
        [eng._token, eng._pos])
