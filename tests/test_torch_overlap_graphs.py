"""Per-stage capture of the async schedule and of the characterization's
stage callables (``StageGraphExecutor.forward_overlapped`` through
``_ovjit``, ``overlap_stage_fns``, ``stage_fns`` and ``stage_records``:
``graphs.compiled`` at the reference's per-stage ``jax.jit`` sites).

There is no card here, so capture and replay go through the stand-in of
``tests/torch_fake_card.py`` (installed with ``monkeypatch``): the
parameters and the prepared batch are marked as on the card, and so is
every output a compiled stage returns, as a real one returns a tensor on
the card.  On it: one capture a stage key and only replays after the
first forward, the logits bitwise the eager walk's (HAN on 3 degree
buckets, MAGNN, HAN and RGCN at K = 4 and L = 2, HAN ``csr``), a sibling
branch's graph captured on its branch's capture stream, the
characterization's records counted on the eager stages alone.  Off the
stand-in the executor keeps one compiled callable under each of the
reference's keys: ``sorted(_ov_jit)`` equals the JAX executor's.

Stability: inputs from the fixed tiny graph of ``tests/conftest.py`` and
the reference's parameters from a fixed key; no clock, no subprocess; the
dataset registries and the module seams are touched only through
``monkeypatch``.  Well under 30 s on one worker."""
import jax
import pytest
import torch

from repro.configs.base import HGNNConfig as RefConfig
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro_torch import graphs, interop
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph
from repro_torch.core.models import get_model
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from torch_fake_card import ON_CARD, FakeCard, on_card

# the reference's tests/test_overlap.py settings
BASE = dict(hidden=16, n_heads=4, n_classes=3, max_degree=48,
            max_instances=4, fused=True, use_pallas=True, overlap=2)
CASES = [
    ("han", {"degree_buckets": 3}),
    ("magnn", {}),
    ("han", {"partitions": 4, "layers": 2}),
    ("rgcn", {"partitions": 4, "layers": 2}),
    ("han", {"fused": False}),
]
IDS = ["-".join([m] + [f"{k}{v}" for k, v in kw.items()]) for m, kw in CASES]
RECORD_KEYS = ("flops", "hbm_bytes", "flops_by_class", "hbm_bytes_by_class")


@pytest.fixture(autouse=True)
def _tiny_tables(monkeypatch):
    for mod in (ref_syn, syn):
        monkeypatch.setitem(mod.DATASET_METAPATHS, "tiny",
                            [["M", "D", "M"], ["M", "A", "M"]])
        monkeypatch.setitem(mod.DATASET_TARGET, "tiny", "M")


@pytest.fixture
def card(monkeypatch):
    """The stand-in card, with a compiled call's outputs on it."""
    fake = FakeCard()
    monkeypatch.setattr(graphs, "_card", fake)
    result = graphs._Graph.result
    monkeypatch.setattr(graphs._Graph, "result",
                        lambda g, out, flat: on_card(result(g, out, flat)))
    ops.reset_launch_counts()
    ON_CARD.clear()
    yield fake
    ON_CARD.clear()
    ops.reset_launch_counts()


_REF: dict = {}  # case -> the reference's model and parameters


def _ref(hg, model, kw):
    key = (model, tuple(sorted(kw.items())))
    if key not in _REF:
        m = ref_get_model(RefConfig(**dict(BASE, model=model,
                                           dataset="tiny", **kw)))
        b = m.prepare(hg)
        _REF[key] = (m, b, m.init(jax.random.key(0), b))
    return _REF[key]


def _port(hg, model, kw):
    _, _, ref_p = _ref(hg, model, kw)
    m = get_model(HGNNConfig(**dict(BASE, model=model, dataset="tiny",
                                    **kw)))
    port_hg = hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                                 name=hg.name)
    b = m.prepare(port_hg, device="cpu")
    return m, b, interop.params_from_numpy(ref_p, device="cpu")


def _eager(m, p, b):
    """The eager walk: the schedule with each cached stage's ``fn``."""
    with torch.inference_mode():
        m.executor.forward_overlapped(p, b)  # off the card: fills _ov_jit
    eager = get_model(m.cfg).executor
    eager._ov_jit = {k: c.fn for k, c in m.executor._ov_jit.items()}
    with torch.inference_mode():
        return eager.forward_overlapped(p, b)


@pytest.mark.parametrize("model,kw", CASES, ids=IDS)
def test_stage_keys_equal_the_references(tiny_hg, model, kw):
    ref_m, ref_b, ref_p = _ref(tiny_hg, model, kw)
    ref_m.forward_overlapped(ref_p, ref_b)
    m, b, p = _port(tiny_hg, model, kw)
    with torch.inference_mode():
        m.forward_overlapped(p, b)
    assert sorted(m.executor._ov_jit) == sorted(ref_m.executor._ov_jit)
    assert all(isinstance(c, graphs.Compiled)
               for c in m.executor._ov_jit.values())
    # off the card nothing is captured
    assert not any(c.graphs for c in m.executor._ov_jit.values())


@pytest.mark.parametrize("model,kw", CASES, ids=IDS)
def test_overlapped_stages_replay_bitwise_the_eager_walk(tiny_hg, card,
                                                          model, kw):
    m, b, p = _port(tiny_hg, model, kw)
    want = _eager(m, p, b)
    with torch.inference_mode():
        assert torch.equal(want, m.forward(p, b))
    ex = get_model(m.cfg).executor
    on_card((p, b))
    with torch.inference_mode():
        first = ex.forward_overlapped(p, b)
        wrappers = dict(ex._ov_jit)
        caps = {k: c.captures for k, c in wrappers.items()}
        second = ex.forward_overlapped(p, b)
    assert torch.equal(first, want) and torch.equal(second, want)
    assert ex._ov_jit == wrappers  # the same wrapper a key, kept
    # one graph a signature of a key, all captured by the first forward
    assert {k: c.captures for k, c in ex._ov_jit.items()} == caps
    assert all(n == len(wrappers[k].graphs) >= 1 for k, n in caps.items())
    assert sum(caps.values()) == card.captured
    # the second forward replayed every stage it dispatched
    dispatched = len(ex.last_dispatch["dispatched"])
    replays = sum(c.replays for c in ex._ov_jit.values())
    assert replays == dispatched + dispatched - sum(caps.values())


def test_a_sibling_branch_is_captured_on_its_branch_stream(tiny_hg, card):
    for (model, kw), main_key, side_key in [
            (CASES[0], "NA.p0.0", "NA.p0.1"),
            (CASES[3], "halo_exchange", "NA.own0")]:
        m, b, p = _port(tiny_hg, model, kw)
        on_card((p, b))
        ex = m.executor
        with torch.inference_mode():
            ex.forward_overlapped(p, b)
        main, side = ex._ov_jit[main_key], ex._ov_jit[side_key]
        assert (main.stream, side.stream) == (0, 1)
        (g_main,), (g_side,) = main.graphs.values(), side.graphs.values()
        assert g_main.stream is card.stream(None, 0)
        assert g_side.stream is card.stream(None, 1)
        # every branch-0 stage shares capture stream 0
        assert all(g.stream is card.stream(None, 0)
                   for k, c in ex._ov_jit.items() if c.stream == 0
                   for g in c.graphs.values())


def test_earlier_outputs_are_copied_and_params_batch_held(tiny_hg, card):
    m, b, p = _port(tiny_hg, "rgcn", {"partitions": 4, "layers": 2})
    on_card((p, b))
    ex = m.executor
    with torch.inference_mode():
        ex.forward_overlapped(p, b)
    want = {"FP0": set(), "FP1": {1}, "halo_exchange": {1},
            "NA.own0": {2}, "NA.merge0": {2, 3, 4}, "SA0": {2},
            "head": {2}}
    for key, copied in want.items():
        assert ex._ov_jit[key].copied == copied, key
    (g,) = ex._ov_jit["FP0"].graphs.values()
    assert not g.copies and g.held  # params and batch where they lie
    (g,) = ex._ov_jit["NA.merge0"].graphs.values()
    assert g.copies and not g.uploads


@pytest.mark.parametrize("model,kw", [CASES[0], CASES[3], CASES[4]],
                         ids=[IDS[0], IDS[3], IDS[4]])
def test_stage_records_are_counted_on_the_eager_stages(tiny_hg, card,
                                                        model, kw):
    """The records on the stand-in card equal those off it: the recorder
    sees each eager stage once, whatever the compiled one has done (a
    capture runs a stage's ops twice, a replay none)."""
    m, b, p = _port(tiny_hg, model, kw)
    off = m.executor.stage_records(p, b)
    on_card((p, b))
    on = m.executor.stage_records(p, b)
    assert list(on["stages"]) == list(off["stages"])
    for name, rec in off["stages"].items():
        assert {k: on["stages"][name][k] for k in RECORD_KEYS} == \
            {k: rec[k] for k in RECORD_KEYS}, name
    assert on["total"] == off["total"] and on["total"]["flops"] > 0


def test_stage_fns_are_compiled_and_replay_bitwise(tiny_hg, card):
    m, b, p = _port(tiny_hg, "han", {"partitions": 4, "layers": 2})
    on_card((p, b))
    fns = m.executor.stage_fns(p, b)
    # one exchange callable for every layer, as in the reference
    assert fns["L1.gather_halo"][0] is fns["L2.gather_halo"][0]
    with torch.inference_mode():
        for name, (fn, args) in fns.items():
            assert isinstance(fn, graphs.Compiled), name
            fn(*args)  # the head's capture: the chain does not run it
            before = fn.replays
            got = fn(*args)
            assert fn.replays == before + 1, name
            want = fn.fn(*args)
            for x, y in zip(torch.utils._pytree.tree_leaves(got),
                            torch.utils._pytree.tree_leaves(want)):
                assert torch.equal(x, y), name
        head, args = fns["head"]
        assert torch.equal(head(*args), m.forward(p, b))


def test_overlap_stage_fns_are_compiled_anew(tiny_hg, card):
    m, b, p = _port(tiny_hg, "han", {"degree_buckets": 3})
    on_card((p, b))
    first = m.executor.overlap_stage_fns(p, b)
    again = m.executor.overlap_stage_fns(p, b)
    assert list(first) == list(m.executor.schedule_edges())
    with torch.inference_mode():
        for name, (fn, args) in first.items():
            assert fn is not again[name][0]
            assert (fn.captures, fn.replays) == (1, 0), name
        fn, args = first["head"]
        assert torch.equal(fn(*args), m.forward(p, b))
        assert fn.replays == 1
