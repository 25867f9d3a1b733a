"""Per-stage characterization of the port (``core/characterize.py``, the
executor's ``stage_fns``/``stage_records``, ``HGNNInferEngine.
characterize``, ``launch/serve.py --characterize``, the kernels' declared
work at ``kernels/ops.py``) against ``repro.core.characterize`` and the
reference's ``StageGraphExecutor.stage_records``, on the tiny graph of
``tests/test_stage_pipeline.py`` (hidden 16, 4 heads) and the Reddit-like
graph at scale 0.005, with the reference's parameters carried across.

Exact, not by tolerance: FLOPs and bytes are counts.  The ``FP`` and
``head`` records equal the reference's: both count a plain ``x @ W`` per
type by the rule for an unfused op.  Two differences are reckoned, not
waived: HAN's two-pass semantic attention combines by fixed-order
elementwise multiply-adds (``kernels/ref.py::semantic_combine``) where the
reference contracts with a dot, so its SA DM FLOPs are the reference's
less ``2·P·N·D``; and RGCN's hidden-layer FP is the identity, which the
port runs as no op where the reference's jit copies the carried tables to
its outputs (``2 ×`` their bytes, DR)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import HGNNConfig as RefConfig
from repro.core import characterize as ref_ch
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro_torch import interop
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import characterize as ch
from repro_torch.core import hgraph
from repro_torch.core.models import get_model
from repro_torch.data import synthetic as syn
from repro_torch.kernels import feature_cache as tfc
from repro_torch.kernels import fused_fp_na as tffn
from repro_torch.kernels import gat_na as tgat
from repro_torch.kernels import ops
from repro_torch.kernels import segment_spmm as tspmm
from repro_torch.kernels import segment_sum as tss
from repro_torch.kernels import semantic_attn as tsem
from repro_torch.launch.serve import build_hgnn_infer
from repro_torch.serve.engine import HGNNInferEngine

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
            max_degree=48, max_instances=4)
REDDIT = dict(model="gcn", dataset="reddit", hidden=16, n_classes=5)
# every ported plan, as HGNNConfig keywords (the reference runs its plain
# arm; the port its kernel arm where the plan has one)
VARIANTS = {
    "han-stacked": dict(model="han", fused=True),
    "han-epilogue": dict(model="han", fused=True, fuse_na_sa=True),
    "han-csr": dict(model="han", fused=False),
    "han-bucketed": dict(model="han", fused=True, degree_buckets=3),
    "rgcn-padded": dict(model="rgcn", fused=True),
    "rgcn-bucketed": dict(model="rgcn", fused=True, degree_buckets=3),
    "rgcn-csr": dict(model="rgcn", fused=False),
    "magnn": dict(model="magnn"),
    "gcn": REDDIT,
}
RECORD_KEYS = ("flops", "hbm_bytes", "flops_by_class", "hbm_bytes_by_class")


@pytest.fixture(autouse=True)
def _tiny_tables():
    for mod in (ref_syn, syn):
        mod.DATASET_METAPATHS["tiny"] = [["M", "D", "M"], ["M", "A", "M"]]
        mod.DATASET_TARGET["tiny"] = "M"


@pytest.fixture(scope="module")
def reddit_hg():
    return ref_syn.make_reddit_like(scale=0.005)


def _kw(variant, **extra):
    kw = dict(VARIANTS[variant], **extra)
    return kw if kw.get("dataset") == "reddit" else dict(TINY, **kw)


def _graphs(variant, tiny_hg, reddit_hg):
    hg = reddit_hg if VARIANTS[variant].get("dataset") == "reddit" \
        else tiny_hg
    return hg, hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                                  name=hg.name)


_REF_CACHE = {}


def _both(variant, tiny_hg, reddit_hg, port_pallas=True, **extra):
    """(reference records, port records, port model, port params, port
    batch) for one plan, the port on the CPU with the reference's
    parameters.  The reference's records are computed once a plan."""
    kw = _kw(variant, **extra)
    ref_hg, hg = _graphs(variant, tiny_hg, reddit_hg)
    key = tuple(sorted(kw.items()))
    if key not in _REF_CACHE:
        ref_m = ref_get_model(RefConfig(**kw))
        ref_b = ref_m.prepare(ref_hg)
        ref_p = ref_m.init(jax.random.key(0), ref_b)
        _REF_CACHE[key] = (ref_m.stage_records(ref_p, ref_b), ref_p)
    want, ref_p = _REF_CACHE[key]
    m = get_model(HGNNConfig(**kw, use_pallas=port_pallas))
    b = m.prepare(hg, device="cpu")
    p = interop.params_from_numpy(ref_p, device="cpu")
    return want, m.stage_records(p, b), m, p, b


def _carried_bytes(batch):
    return sum(4 * 16 * n for n in batch["counts"].values())


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fp_and_head_records_match_reference(tiny_hg, reddit_hg, variant,
                                             layers):
    want, got, m, _, b = _both(variant, tiny_hg, reddit_hg, layers=layers)
    assert list(got["stages"]) == list(want["stages"])
    for name in got["stages"]:
        if not (name.endswith("FP") or name == "head"):
            continue
        g, w = got["stages"][name], want["stages"][name]
        if name == "L2.FP" and variant.startswith("rgcn"):
            # the identity FP: no op here; the reference's jit copies the
            # carried tables to its outputs
            assert (g["flops"], g["hbm_bytes"]) == (0.0, 0.0)
            assert g["flops_by_class"] == g["hbm_bytes_by_class"] == {}
            assert w["hbm_bytes_by_class"] == {"DR": 2.0 * _carried_bytes(b)}
            assert w["flops"] == 0.0
            continue
        for k in RECORD_KEYS:
            assert g[k] == w[k], (name, k)


def test_fp_records_are_the_reported_reference_numbers(tiny_hg, reddit_hg):
    """HAN's FP is a plain ``x_M @ W`` (15,360 FLOPs, 5,248 bytes), RGCN's
    one such product a type (27,200 and 10,440)."""
    for variant, flops, n_bytes in (("han-stacked", 15360.0, 5248.0),
                                    ("rgcn-padded", 27200.0, 10440.0)):
        _, got, *_ = _both(variant, tiny_hg, reddit_hg)
        fp = got["stages"]["FP"]
        assert fp["flops_by_class"] == {"DM": flops}
        assert fp["hbm_bytes_by_class"] == {"DM": n_bytes}


def test_two_pass_sa_dm_flops_are_the_reference_less_the_combine(
        tiny_hg, reddit_hg):
    want, got, _, _, b = _both("han-stacked", tiny_hg, reddit_hg,
                               port_pallas=False)
    p_dim, n, d = len(b["nbr"]), b["nbr"].shape[1], 16
    ref_dm = want["stages"]["SA"]["flops_by_class"]["DM"]
    assert ref_dm == 350720.0
    assert got["stages"]["SA"]["flops_by_class"]["DM"] == \
        ref_dm - 2 * p_dim * n * d


@pytest.mark.parametrize("variant", ["han-stacked", "rgcn-csr"])
def test_residency_records_match_reference(tiny_hg, reddit_hg, variant):
    want, got, *_ = _both(variant, tiny_hg, reddit_hg, layers=2,
                          cache_rows=12)
    assert got["residency"] == want["residency"]
    assert got["residency"]["hits"] > 0
    for name in ("L1.NA", "L2.NA"):
        for k in ("residency_bytes_saved", "hit_rate"):
            assert got["stages"][name][k] == want["stages"][name][k]


# ---------------------------------------------------------------------------
# the reference's invariants
# ---------------------------------------------------------------------------


def _records(tiny_hg, **kw):
    m = get_model(HGNNConfig(**dict(TINY, **kw)))
    b = m.prepare(_graphs("han-stacked", tiny_hg, None)[1], device="cpu")
    p = m.init(torch.Generator().manual_seed(0), b)
    return m, p, b, m.stage_records(p, b)


def _sums_to_totals(recs):
    for name, r in recs["stages"].items():
        assert r["flops"] == sum(r["flops_by_class"].values()), name
        assert r["hbm_bytes"] == sum(r["hbm_bytes_by_class"].values()), name
    assert recs["total"]["flops"] == sum(
        r["flops"] for r in recs["stages"].values())
    assert recs["total"]["hbm_bytes"] == sum(
        r["hbm_bytes"] for r in recs["stages"].values())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_stage_records_sum_to_totals(tiny_hg, use_pallas):
    *_, recs = _records(tiny_hg, model="han", fused=True,
                        use_pallas=use_pallas)
    assert set(recs["stages"]) == {"FP", "NA", "SA", "head"}
    for name, r in recs["stages"].items():
        assert r["flops"] > 0 and r["hbm_bytes"] > 0, name
        assert r["roofline"]["bound"] in ("compute", "memory", "collective")
    _sums_to_totals(recs)


def test_multilayer_stage_records_per_layer(tiny_hg):
    *_, recs = _records(tiny_hg, model="han", fused=True, layers=2)
    assert set(recs["stages"]) == {
        "L1.FP", "L1.NA", "L1.SA", "L2.FP", "L2.NA", "L2.SA", "head"}
    for name, r in recs["stages"].items():
        assert r["flops"] > 0 and r["hbm_bytes"] > 0, name
    _sums_to_totals(recs)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fused_epilogue_saves_an_hbm_pass(tiny_hg, use_pallas):
    """With the epilogue, the SA stage moves at least one full ``[P, N,
    D]`` pass less."""
    def sa_bytes(**kw):
        m, p, b, recs = _records(tiny_hg, model="han", fused=True,
                                 use_pallas=use_pallas, **kw)
        z = m.executor.stage_fns(p, b)["SA"][1][1]
        z = z[0] if isinstance(z, tuple) else z
        return recs["stages"]["SA"]["hbm_bytes"], z.numel() * 4

    two_pass, z_bytes = sa_bytes()
    fused, _ = sa_bytes(fuse_na_sa=True)
    assert two_pass - fused >= 0.9 * z_bytes, (two_pass, fused, z_bytes)


@pytest.mark.parametrize("kw", [dict(), dict(fuse_na_sa=True),
                                dict(degree_buckets=3),
                                dict(model="rgcn", fused=False),
                                dict(partitions=4), dict(model="magnn")])
def test_cached_stage_records_na_bytes_strictly_decrease(tiny_hg, kw):
    """With the cache, every cached stage's bytes strictly decrease (hits
    × row bytes saved; the fill charged once, at the first cached stage)
    and no other stage's record moves: the reference's cases (HAN, RGCN
    ``fused=False`` and HAN ``partitions=4``, whose ``gather_halo``
    records carry the savings) on the kernel arm, and MAGNN's.  It holds
    because the code does no extra work for the cache: HAN's ``gat_na``
    reads a row a slot with or without it, RGCN's ``csr`` mean reads a
    cache index through the hot ids instead of an extended pool, the
    cached halo exchange is the uncached one gather, and MAGNN's cached
    and uncached gathers are counted by one rule.  The padded RGCN and
    the plain arms still copy the extended pool once a type and layer
    (ROADMAP Queue 3 check (f))."""
    kw = {"model": "han", "fused": True, **kw}
    model = kw.pop("model")
    suffix = "gather_halo" if kw.get("partitions") else "NA"
    m0, p, b0, r0 = _records(tiny_hg, model=model, layers=2,
                             use_pallas=True, **kw)
    m1 = get_model(HGNNConfig(**dict(TINY, model=model, layers=2,
                                     use_pallas=True, cache_rows=12,
                                     **kw)))
    b1 = m1.prepare(_graphs("han-stacked", tiny_hg, None)[1], device="cpu")
    r1 = m1.stage_records(p, b1)
    rr = r1["residency"]
    assert rr["hits"] > 0
    assert rr["hit_rate"] == rr["hits"] / rr["rows"]
    names = [n for n in r1["stages"] if n.endswith(suffix)]
    assert len(names) == 2
    for i, n in enumerate(names):
        assert r1["stages"][n]["hbm_bytes"] < r0["stages"][n]["hbm_bytes"]
        assert r1["stages"][n]["residency_bytes_saved"] == \
            rr["bytes_saved_per_layer"] - (rr["fill_bytes"] if i == 0 else 0)
    for n in r1["stages"]:
        if not n.endswith(suffix):
            assert r1["stages"][n]["hbm_bytes"] == r0["stages"][n]["hbm_bytes"]
    assert r1["total"]["hbm_bytes"] < r0["total"]["hbm_bytes"]
    _sums_to_totals(r1)
    with torch.inference_mode():
        assert torch.equal(m1.forward(p, b1), m0.forward(p, b0))


def test_characterizer_reproduces_paper_stage_structure(tiny_hg):
    """Paper §4.2/§4.3: FP is DM-dominated; the ``csr`` NA is TB-heavy."""
    *_, recs = _records(tiny_hg, model="han", fused=False)
    fp, na = recs["stages"]["FP"], recs["stages"]["NA"]
    assert fp["flops_by_class"].get("DM", 0) >= 0.9 * fp["flops"]
    assert na["hbm_bytes_by_class"].get("TB", 0) >= 0.3 * na["hbm_bytes"]


def test_hgnn_infer_engine_serves_and_characterizes(tiny_hg):
    hg = _graphs("han-stacked", tiny_hg, None)[1]
    built = build_hgnn_infer(HGNNConfig(**TINY, model="han", fused=True),
                             hg, "cpu")
    engine = HGNNInferEngine(built.executor, built.params, built.batch,
                             fn=built.fn)
    assert tuple(engine.infer().shape) == (40, 3)
    recs = engine.characterize()
    assert set(recs) == {"FP", "NA", "SA", "head"}
    assert engine.plan.na.layout == "stacked"
    with pytest.raises(ValueError, match="CUDA"):
        engine.characterize(timed=True)


# ---------------------------------------------------------------------------
# the recorder and the declared work
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_bitwise_the_same_under_the_recorder(tiny_hg, reddit_hg,
                                                    variant):
    """Both arms give the same bits with the recorder on and off, and the
    stage chain of ``stage_fns`` gives the forward's logits."""
    hg = _graphs(variant, tiny_hg, reddit_hg)[1]
    for use_pallas in (False, True):
        cfg = HGNNConfig(**_kw(variant, use_pallas=use_pallas))
        m = get_model(cfg)
        b = m.prepare(hg, device="cpu")
        p = m.init(torch.Generator().manual_seed(0), b)
        with torch.inference_mode():
            off = m.forward(p, b)
            with ch.Recorder():
                on = m.forward(p, b)
        assert torch.equal(on, off), use_pallas
        fn, args = m.executor.stage_fns(p, b)["head"]
        with torch.inference_mode():
            assert torch.equal(fn(*args), off)


def _recorded(fn):
    with torch.inference_mode(), ch.Recorder() as rec:
        fn()
    return rec.report()


def _gat_case(rng, s_dim=2, n=12, k=5, heads=2, dh=4, hs=6):
    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    mask = torch.as_tensor((rng.random((s_dim, n, k)) < 0.6)
                           .astype(np.float32))
    nbr = torch.as_tensor(rng.integers(0, n, (s_dim, n, k)),
                          dtype=torch.int32)
    p = {"a_dst": t(s_dim, heads, dh), "a_src": t(s_dim, heads, dh)}
    sem = {"W": t(heads * dh, hs), "b": t(hs), "q": t(hs)}
    return p, t(n, heads, dh), nbr, mask, sem


def test_kernel_arm_records_each_call_once_by_its_declared_work():
    """A kernel-arm ``ops.*`` call counts once, by its ``work`` helper
    (gathers structurally), however many aten ops its plain version runs
    on the CPU; a plain-arm call counts its aten ops."""
    rng = np.random.default_rng(0)
    p, h, nbr, mask, sem = _gat_case(rng)
    hs = sem["W"].shape[1]
    cases = [
        (lambda: ops.gat_aggregate_stacked(p, h, h, nbr, mask, True), "TB",
         tgat.work(h, h, nbr, mask)),
        (lambda: ops.gat_aggregate_stacked_fused_sa(p, h, h, nbr, mask, sem,
                                                    True), "TB",
         tgat.work(h, h, nbr, mask, hs)),
        (lambda: ops.gat_aggregate({k: v[0] for k, v in p.items()}, h, h,
                                   nbr[0], mask[0], True), "TB",
         tgat.work(h, h, nbr[0], mask[0])),
    ]
    x = h.reshape(h.shape[0], -1)
    cases.append((lambda: ops.segment_spmm(x, nbr[0], mask[0], True, True),
                  "TB", tspmm.work(x.shape[1], nbr[0], mask[0])))
    w = sem["W"]
    ffn = tffn.work(x, w, nbr[0], mask[0])
    cases.append((lambda: ops.fused_fp_na(x, w, nbr[0], mask[0], True, True),
                  "DM", (ffn[0], ffn[1] + ffn[2] // 3)))
    hot = torch.tensor([3, 7], dtype=torch.int32)
    idx = torch.as_tensor(rng.integers(0, x.shape[0] + 2, (9, 3)),
                          dtype=torch.int32)
    cases.append((lambda: ops.cached_gather(x, hot, idx, True), "TB",
                  tfc.work(x, hot, idx)))
    seg = torch.sort(torch.as_tensor(rng.integers(0, 6, 20),
                                     dtype=torch.int32)).values
    src = torch.as_tensor(rng.integers(0, x.shape[0], 20), dtype=torch.int32)
    cases.append((lambda: ops.segment_sum(x, seg, 6, idx=src, mean=True),
                  "TB", tss.work(x, seg, 6, src, True)))
    z = torch.as_tensor(rng.standard_normal((3, 12, 8)), dtype=torch.float32)
    beta = torch.softmax(torch.ones(3), 0)
    cases.append((lambda: ops.semantic_combine(z, beta, True), "EW",
                  tsem.combine_work(z, beta)))
    for fn, cls, work in cases:
        n_bytes, n_ops = work[:2]
        rep = _recorded(fn)
        assert rep["op_counts"] == {cls: 1}
        assert rep["hbm_bytes_by_class"] == {cls: float(n_bytes)}
        assert rep["flops_by_class"] == {cls: float(n_ops)}
        twice = _recorded(lambda: (fn(), fn()))
        assert twice["total_hbm_bytes"] == 2 * n_bytes
    # the plain arm is counted op by op: more than one op, no declaration
    rep = _recorded(lambda: ops.gat_aggregate_stacked(p, h, h, nbr, mask))
    assert sum(rep["op_counts"].values()) > 1
    assert rep["total_hbm_bytes"] != float(tgat.work(h, h, nbr, mask)[0])
    # both SA passes: the scores kernel, the softmax's aten ops, the combine
    rep = _recorded(lambda: ops.semantic_attention(z, w[:8], sem["b"],
                                                   sem["q"], True))
    assert rep["op_counts"]["DM"] == 1 and rep["op_counts"]["EW"] >= 2
    assert rep["flops_by_class"]["DM"] == tsem.scores_work(z, w[:8])[1]


def test_recorder_counts_by_the_unfused_op_rule():
    x, w = torch.randn(40, 12), torch.randn(12, 16)
    z, q = torch.randn(3, 40, 16), torch.randn(16)
    rep = _recorded(lambda: x @ w)  # mm
    assert rep["flops_by_class"] == {"DM": 2.0 * 40 * 16 * 12}
    assert rep["hbm_bytes_by_class"] == {"DM": 4.0 * (40 * 12 + 12 * 16
                                                      + 40 * 16)}
    rep = _recorded(lambda: z @ q)  # view, mv, _unsafe_view
    assert rep["op_counts"] == {"DM": 1}
    assert rep["flops_by_class"] == {"DM": 2.0 * 3 * 40 * 16}
    rep = _recorded(lambda: torch.addmm(q, x @ w, torch.randn(16, 16)))
    assert rep["flops_by_class"]["DM"] == 2.0 * 40 * 16 * (12 + 16)
    rep = _recorded(lambda: torch.bmm(z, z.transpose(1, 2)))
    assert rep["flops_by_class"] == {"DM": 2.0 * 3 * 40 * 40 * 16}
    rep = _recorded(lambda: (z.reshape(120, 16), z.transpose(0, 1), z[1],
                             z.unsqueeze(0), torch.empty(5)))
    assert rep["op_counts"] == {}  # views and allocations are free
    rep = _recorded(lambda: torch.tanh(z))
    assert rep["flops_by_class"] == {"EW": float(z.numel())}
    assert rep["hbm_bytes_by_class"] == {"EW": 8.0 * z.numel()}
    rep = _recorded(lambda: torch.zeros(10).fill_(2.0))  # fills read nothing
    assert rep["hbm_bytes_by_class"] == {"DR": 80.0}
    assert rep["flops_by_class"] == {}
    idx = torch.tensor([0, 2, 2])
    rep = _recorded(lambda: torch.zeros(4, 16).index_add_(
        0, idx, torch.ones(3, 16)))
    # zeros 256 B (DR); ones 192 (DR); index_add_: idx 24 + rows 192, the
    # written table once as the result, 256
    assert rep["hbm_bytes_by_class"] == {"DR": 256.0 + 192.0,
                                         "TB": 24.0 + 192.0 + 256.0}
    rep = _recorded(lambda: torch.cat([x, x]).contiguous())
    assert rep["hbm_bytes_by_class"] == {"DR": 4.0 * 4 * 40 * 12}
    rep = _recorded(lambda: x.t().contiguous())  # clone of a view
    assert rep["hbm_bytes_by_class"] == {"DR": 2 * 4.0 * 40 * 12}


def test_op_and_kernel_classes():
    assert ch.op_class("aten::mm") == ch.op_class("addmm") == "DM"
    for name in ("aten::index", "aten::index_select", "aten::gather",
                 "aten::scatter_reduce", "aten::scatter_add_",
                 "aten::index_add_", "aten::index_put_", "aten::embedding",
                 "aten::take", "aten::index_copy_"):
        assert ch.op_class(name) == "TB", name
    for name in ("aten::copy_", "aten::cat", "aten::stack", "aten::clone",
                 "aten::_to_copy", "aten::constant_pad_nd", "aten::fill_",
                 "aten::zero_", "aten::zeros"):
        assert ch.op_class(name) == "DR", name
    for name in ("aten::add", "aten::exp", "aten::amax", "aten::_softmax",
                 "aten::where", "aten::mul_", "aten::arange"):
        assert ch.op_class(name) == "EW", name
    assert ch.op_class("aten::empty_strided") == "ZERO"
    assert ch.op_class("aten::sort") == "OTHER"
    assert ch.op_class("c10d::allreduce_") == "COLL"
    assert ch.kernel_class("void gat_na_kernel<2, true>(Args)") == "TB"
    assert ch.kernel_class("segment_sum_long_kernel(float const*)") == "TB"
    assert ch.kernel_class("semantic_combine_kernel") == "EW"
    assert ch.kernel_class("void fused_fp_na_kernel<4>(x)") == "DM"
    assert ch.kernel_class("Memset (Device)") == "DR"
    assert ch.kernel_class("Memcpy DtoD (Device -> Device)") == "DR"
    assert ch.kernel_class("void at::native::vectorized_elementwise_kernel"
                           "<4, at::native::AbsFunctor<float>>") is None


def test_every_cuda_kernel_has_a_class():
    """Each ``__global__`` function of ``kernels/csrc`` is classed by
    symbol, so none of the port's kernels lands in OTHER on the card."""
    found = set()
    for src in (ROOT / "src/repro_torch/kernels/csrc").glob("*.cu"):
        found |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*"
            r"\))*\)\s+)?(\w+)\s*\(", src.read_text()))
    assert found and found == set(ch.KERNEL_CLASS), found ^ set(
        ch.KERNEL_CLASS)


def test_timed_records_raise_on_the_cpu(tiny_hg):
    m, p, b, _ = _records(tiny_hg, model="rgcn", fused=True)
    with pytest.raises(ValueError, match="CUDA"):
        m.stage_records(p, b, timed=True)


def test_sampled_partitioned_and_overlap_paths_raise(tiny_hg):
    """The sampled path is ported (its SAMPLE record is the reference's
    ``sample_traffic``, ahead of the device stages and out of ``total``);
    so are the partitioned one (its records: tests/test_torch_partitioned
    .py) and the overlap plans, partitioned or not, which the reference
    runs too: their records add the reference's ``overlap`` counters and
    keep the serial stages' records."""
    m, p, b, recs = _records(tiny_hg, model="han", fused=True)
    meta = {"rung": (8, 64), "rung_index": 1, "n_targets": 5,
            "frontier_rows": 211, "frontier_bytes": 54016,
            "index_bytes": 9000, "truncated_rows": 3, "fanout": 8}
    sampled = m.stage_records(p, b, sample_meta=meta)
    assert list(sampled["stages"]) == ["SAMPLE"] + list(recs["stages"])
    assert sampled["stages"]["SAMPLE"] == ref_ch.sample_traffic(meta)
    assert sampled["total"] == recs["total"]
    for kw, item in ((dict(partitions=4, overlap=2), 14),
                     (dict(overlap=2), 14)):
        m1, p1, b1, r1 = _records(tiny_hg, model="han", fused=True, **kw)
        m0, _, b0, r0 = _records(tiny_hg, model="han", fused=True,
                                 **dict(kw, overlap=0))
        assert m1.plan().schedule.depth == 2
        assert r1["overlap"] == m1.executor.overlap_record()
        assert r1["stages"] == r0["stages"] and r1["total"] == r0["total"]
        with torch.inference_mode():
            assert torch.equal(m1.executor.forward_overlapped(p1, b1),
                               m0.forward(p1, b0))


def test_roofline_at_the_h100_rates():
    per_dev = {"total_flops": 67e12, "total_hbm_bytes": 3.35e12 / 2,
               "collective_bytes": 0.0}
    r = ch.roofline(per_dev, n_chips=1, model_fl=67e12)
    assert r["compute_s"] == pytest.approx(1.0)
    assert r["memory_s"] == pytest.approx(0.5)
    assert r["bound"] == "compute" and r["mfu_proxy"] == pytest.approx(1.0)
    r = ch.roofline(dict(per_dev, total_flops=989e12), 1, 0.0,
                    dtype=torch.bfloat16)
    assert r["compute_s"] == pytest.approx(1.0)
    per_dev["collective_bytes"] = 900e9 * 3
    assert ch.roofline(per_dev, 1, 0.0)["bound"] == "collective"
    assert set(r) == set(ref_ch.roofline(per_dev, 1, 0.0))


# ---------------------------------------------------------------------------
# the pure-Python records: the reference's dicts on the same inputs
# ---------------------------------------------------------------------------


def test_partition_traffic_matches_reference():
    rng = np.random.default_rng(3)
    masks = {"M": rng.random((4, 10)) < 0.3, "D": rng.random((4, 6)) < 0.5}
    h_own = {"M": np.zeros((4, 10, 2, 8), np.float32),
             "D": np.zeros((4, 6, 16), np.float32)}
    meta = {"k": 4, "cut_edges": 37, "edges_total": 120}
    want = ref_ch.partition_traffic({"halo_mask": masks, "meta": meta},
                                    h_own, layers=2)
    part = {"halo_mask": {t: torch.as_tensor(m) for t, m in masks.items()},
            "meta": meta}
    got = ch.partition_traffic(
        part, {t: torch.as_tensor(h) for t, h in h_own.items()}, layers=2)
    assert got == want


def test_sample_traffic_matches_reference():
    meta = {"rung": (8, 64), "rung_index": 1, "n_targets": 5,
            "frontier_rows": 211, "frontier_bytes": 54016,
            "index_bytes": 9000, "truncated_rows": 3, "fanout": 8}
    assert ch.sample_traffic(meta) == ref_ch.sample_traffic(meta)


def test_residency_record_matches_reference():
    counters = {"hits": 79924, "misses": 113222, "rows": 193146,
                "cache_rows": 768}
    for layers in (1, 2):
        assert ch.residency_record(counters, 256, layers) == \
            ref_ch.residency_record(counters, 256, layers)


def test_resilience_record_matches_reference():
    stats = {"steps": 40, "compiles_after_warmup": 0, "resilience": {
        "ok_requests": 30, "partial_requests": 2, "failed_requests": 1,
        "rejected": 4, "shed": 3, "deduped_rows": 9, "retries": 5,
        "failed_steps": 2, "deadline_expired": 1, "degrade_transitions": 2,
        "recover_transitions": 1, "max_degrade_level": 2,
        "partition_failovers": 1, "lost_partitions": (3,)}}
    assert ch.resilience_record(stats) == ref_ch.resilience_record(stats)
    assert ch.resilience_record({}) == ref_ch.resilience_record({})


def test_overlap_accounting_matches_reference():
    edges = {"FP": (), "gh": ("FP",), "NA_own": ("FP",),
             "NA_halo": ("gh",), "SA": ("NA_own", "NA_halo"), "head": ("SA",)}
    walls = {"FP": 10.0, "gh": 4.0, "NA_own": 30.0, "NA_halo": 7.5,
             "SA": 6.0, "head": 1.0}
    assert ch.overlap_accounting(edges, walls) == \
        ref_ch.overlap_accounting(edges, walls)


# ---------------------------------------------------------------------------
# the bounds' formulas: the live-slot counts chip_smoke.py reckoned before
# they moved beside the kernels (kept here as they were)
# ---------------------------------------------------------------------------


def _gat_na_work_before(h_dst, h_src, nbr, mask, hs):
    s_dim, n, k = nbr.shape
    heads = h_dst.shape[1]
    hd = heads * h_dst.shape[2]
    live = int((mask != 0).sum())
    named = [nbr[s][mask[s] != 0].unique() for s in range(s_dim)]
    n_bytes = 2 * nbr.numel() * 4 + n * hd * 4 + s_dim * n * hd * 4
    n_bytes += 2 * s_dim * hd * 4
    if h_src.data_ptr() != h_dst.data_ptr():
        n_bytes += int(torch.cat(named).unique().numel()) * hd * 4
    n_ops = 2 * s_dim * n * hd
    n_ops += 2 * hd * sum(int(r.numel()) for r in named)
    n_ops += live * (6 * heads + 2 * hd)
    n_ops += s_dim * n * hd
    if hs:
        n_bytes += (hd * hs + 2 * hs) * 4 + s_dim * 4
        n_ops += s_dim * n * (hd + 2 * hd * hs + 4 * hs) + s_dim * n
    return n_bytes, n_ops


def _spmm_work_before(n_src_cols, nbr, mask):
    n, k = nbr.shape
    live = mask != 0
    n_live = int(live.sum())
    named = int(nbr[live].unique().numel())
    n_bytes = 4 * n * k + 4 * n_live + named * n_src_cols * 4
    return n_bytes + n * n_src_cols * 4, 2 * n_live * n_src_cols + n * \
        n_src_cols


def _gather_work_before(table, hot, idx):
    n, d = table.shape
    v = idx.long().reshape(-1)
    rows = torch.where(v >= n, hot.long()[(v - n).clamp(0, hot.numel() - 1)],
                       v)
    n_bytes = idx.numel() * 4 * (1 + d) + hot.numel() * 4
    return n_bytes + int(rows.unique().numel()) * d * 4, 0


def test_live_only_work_is_the_bound_reckoned_before():
    rng = np.random.default_rng(5)
    p, h, nbr, mask, sem = _gat_case(rng, n=30, k=9)
    other = h.clone()
    for hs in (0, 6):
        assert tgat.work(h, h, nbr, mask, hs, live_only=True) == \
            _gat_na_work_before(h, h, nbr, mask, hs)
        assert tgat.work(other, h, nbr, mask, hs, live_only=True) == \
            _gat_na_work_before(other, h, nbr, mask, hs)
    assert tspmm.work(8, nbr[0], mask[0], live_only=True) == \
        _spmm_work_before(8, nbr[0], mask[0])
    x, w = torch.randn(30, 20), torch.randn(20, 8)
    b, o = _spmm_work_before(20, nbr[0], mask[0])
    assert tffn.work(x, w, nbr[0], mask[0], live_only=True) == (
        b + 20 * 8 * 4 + 30 * 8 * 4 - 30 * 20 * 4, o, 3 * 2 * 30 * 20 * 8)
    hot = torch.tensor([4, 9, 11], dtype=torch.int32)
    idx = torch.as_tensor(rng.integers(0, 33, (12, 5)), dtype=torch.int32)
    assert tfc.work(x, hot, idx, live_only=True) == \
        _gather_work_before(x, hot, idx)
    seg = torch.sort(torch.as_tensor(rng.integers(0, 7, 40),
                                     dtype=torch.int32)).values
    src = torch.as_tensor(rng.integers(0, 30, 40), dtype=torch.int32)
    for mean in (False, True):
        rows = int(src.unique().numel())
        assert tss.work(x, seg, 7, src, mean, live_only=True) == (
            4 * 40 * 2 + 4 * rows * 20 + 4 * 7 * 20,
            40 * 20 + (7 * 20 if mean else 0))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_characterize_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--hgnn", "rgcn",
         "--dataset", "imdb", "--use-pallas", "--layers", "2", "--device",
         "cpu", "--iters", "1", "--characterize"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    for stage in ("L1.FP", "L1.NA", "L1.SA", "L2.FP", "L2.NA", "L2.SA",
                  "head"):
        assert any(re.fullmatch(rf"  {re.escape(stage)}: flops=\S+ "
                                r"hbm_bytes=\S+ bound=(compute|memory|"
                                r"collective)", ln) for ln in lines), stage
    assert "time_us" not in out.stdout
