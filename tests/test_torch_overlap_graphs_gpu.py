"""Per-stage capture of the async schedule on the card: each stage of
``StageGraphExecutor.forward_overlapped`` replays the CUDA graph of its
stage key (``graphs.compiled`` under ``_ovjit``), bitwise the serial
kernel arm and the eager walk with the same launches; two sibling graphs
replayed at once on two streams keep their bits (each was captured on a
capture stream of its own, so their kernels' scratch counters are not
shared); a timed ``stage_records`` counts the eager stages and times the
replays.  Every test needs a CUDA device and skips without one.  The file
imports no jax:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_overlap_graphs_gpu.py
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph
from repro_torch.core.models import get_model
from repro_torch.data import synthetic as syn
from repro_torch.kernels import build, ops

pytestmark = pytest.mark.gpu
TINY = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
            max_degree=6, max_instances=4, fused=True, use_pallas=True)
CASES = [
    ("han", {"degree_buckets": 3}),
    ("han", {"fused": False}),
    ("magnn", {}),
    ("han", {"partitions": 4, "layers": 2}),
    ("rgcn", {"partitions": 4, "layers": 2}),
]
RECORD_KEYS = ("flops", "hbm_bytes", "flops_by_class", "hbm_bytes_by_class")


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    monkeypatch.setitem(syn.DATASET_METAPATHS, "tiny",
                        [["M", "D", "M"], ["M", "A", "M"]])
    monkeypatch.setitem(syn.DATASET_TARGET, "tiny", "M")
    return torch.device("cuda")


def _graph():
    rng = np.random.default_rng(7)
    counts = {"M": 40, "D": 15, "A": 25}
    dims = {"M": 12, "D": 8, "A": 10}
    feats = {t: rng.standard_normal((n, dims[t])).astype(np.float32)
             for t, n in counts.items()}

    def rel(ns, nd, e):
        r, c = rng.integers(0, ns, e), rng.integers(0, nd, e)
        return sp.csr_matrix((np.ones(e, np.float32), (r, c)),
                             shape=(ns, nd))

    md, ma = rel(40, 15, 60), rel(40, 25, 80)
    return hgraph.HeteroGraph(
        counts, feats, {("M", "md", "D"): md, ("D", "dm", "M"): md.T.tocsr(),
                        ("M", "ma", "A"): ma, ("A", "am", "M"): ma.T.tocsr()},
        name="tiny")


def _model(cfg, hg, device):
    m = get_model(cfg)
    b = m.prepare(hg, device=device)
    return m, b, m.init(torch.Generator().manual_seed(0), b)


def _eager_walk(m, p, b):
    """The schedule walked with each cached stage's eager ``fn``."""
    eager = get_model(m.cfg).executor
    eager._ov_jit = {k: c.fn for k, c in m.executor._ov_jit.items()}
    return eager.forward_overlapped(p, b)


@pytest.mark.parametrize("model,kw", CASES, ids=[
    "-".join([m] + [f"{k}{v}" for k, v in kw.items()]) for m, kw in CASES])
def test_captured_overlapped_forward_bitwise_with_the_same_launches(
        cuda, model, kw):
    """The first forward captures one graph a stage key and signature;
    later ones replay them: bitwise the serial kernel arm and the eager
    walk, launches over three forwards the serial forward's times three,
    no capture and no scratch buffer after the first."""
    cfg = HGNNConfig(**dict(TINY, model=model, overlap=2, **kw))
    m, b, p = _model(cfg, _graph(), cuda)
    ex = m.executor
    ops.reset_launch_counts()
    with torch.inference_mode():
        serial = m.forward(p, b)
    torch.cuda.synchronize()
    per = ops.launch_counts()
    ops.reset_launch_counts()
    with torch.inference_mode():
        outs = [ex.forward_overlapped(p, b)]
        caps = {k: c.captures for k, c in ex._ov_jit.items()}
        made = build.created
        outs += [ex.forward_overlapped(p, b) for _ in range(2)]
    torch.cuda.synchronize()
    assert ops.launch_counts() == {k: 3 * n for k, n in per.items()}
    assert sum(per.values()) > 0
    assert all(torch.equal(o, serial) for o in outs)
    assert {k: c.captures for k, c in ex._ov_jit.items()} == caps
    assert all(n == len(ex._ov_jit[k].graphs) for k, n in caps.items())
    assert build.created == made
    with torch.inference_mode():
        assert torch.equal(_eager_walk(m, p, b), serial)


def test_sibling_graphs_replayed_at_once_keep_their_bits(cuda):
    """HAN/imdb on 3 degree buckets at full width: the two metapaths'
    NA graphs (``gat_na`` a bucket, each counting rows in its scratch)
    replayed 50 times each on two streams with no wait between them, both
    streams held back by a device sleep until the host has queued every
    replay, so that the two queues then run side by side; every result
    bitwise its eager stage's."""
    cfg = HGNNConfig(model="han", dataset="imdb", hidden=64, n_heads=8,
                     n_classes=8, max_degree=32, fused=True, use_pallas=True,
                     degree_buckets=3, overlap=2)
    m, b, p = _model(cfg, syn.make_dataset("imdb"), cuda)
    ex = m.executor
    with torch.inference_mode():
        ex.forward_overlapped(p, b)
        h = ex.fp(p, b)
        na = [ex._ov_jit["NA.p0.0"], ex._ov_jit["NA.p0.1"]]
        assert [c.stream for c in na] == [0, 1]
        (g0,), (g1,) = na[0].graphs.values(), na[1].graphs.values()
        assert g0.stream is not g1.stream
        assert not {id(x) for x in g0.scratch} & {id(x) for x in g1.scratch}
        want = [c.fn(p, b, h) for c in na]
        main, side = torch.cuda.current_stream(), torch.cuda.Stream()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's clocks
        side.wait_stream(main)
        got = [[], []]
        for _ in range(50):
            got[0].append(na[0](p, b, h))
            with torch.cuda.stream(side):
                got[1].append(na[1](p, b, h))
        main.wait_stream(side)
        torch.cuda.synchronize()
    assert all(torch.equal(x, want[i]) for i in (0, 1) for x in got[i])


def test_timed_stage_records_count_the_eager_stages(cuda):
    """``stage_records(timed=True)`` on the card: FLOPs and bytes equal the
    CPU's records of the same plan, ``time_us`` from the replays."""
    for model, kw in [("han", {"fused": False}),
                      ("rgcn", {"partitions": 4, "layers": 2})]:
        cfg = HGNNConfig(**dict(TINY, model=model, **kw))
        m, b, p = _model(cfg, _graph(), cuda)
        _, b_cpu, p_cpu = _model(cfg, _graph(), "cpu")
        recs = m.executor.stage_records(p, b, timed=True)["stages"]
        want = m.executor.stage_records(p_cpu, b_cpu)["stages"]
        assert list(recs) == list(want)
        for name, rec in recs.items():
            assert {k: rec[k] for k in RECORD_KEYS} == \
                {k: want[name][k] for k in RECORD_KEYS}, name
            assert rec["time_us"] > 0, name
            assert rec["device_us"] > 0 or rec["hbm_bytes"] == 0, name
