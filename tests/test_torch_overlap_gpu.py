"""The async stage-graph schedule on the card (``StageGraphExecutor.
forward_overlapped``, each stage a replayed CUDA graph, with side streams,
CUDA events and ``record_stream``;
``kernels/streaming.py``'s ``InflightWindow``; the serve engine's sampler
prefetch) and the ``segment_sum`` kernel's residency form: on a small
graph, every overlapped forward bitwise the serial kernel arm's on the
card, with the same launches; sibling stages on a side stream of the
executor's; ``depth=1`` synchronising every stage.  Every test needs a
CUDA device and skips without one.  The file imports no jax:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_overlap_gpu.py
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
from repro_torch.kernels import segment_sum as tss
from repro_torch.kernels.streaming import InflightWindow
from repro_torch.serve.engine import HGNNRequest, HGNNServeEngine
from repro_torch.serve.sampler import HGNNSampler

pytestmark = pytest.mark.gpu
TINY = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
            max_degree=6, max_instances=4, fused=True, use_pallas=True)
CASES = [
    ("han", {"degree_buckets": 3}),
    ("han", {"fused": False}),
    ("magnn", {}),
    ("magnn", {"layers": 2}),
    ("han", {"partitions": 4, "layers": 2}),
    ("rgcn", {"partitions": 4, "layers": 2}),
    ("magnn", {"partitions": 4}),
    ("magnn", {"partitions": 4, "layers": 2}),
    ("rgcn", {"partitions": 4}),
    ("han", {"partitions": 4, "cache_rows": 6}),
    ("rgcn", {"layers": 2}),
]


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


def _model(device, model, kw, overlap=2):
    m = get_model(HGNNConfig(**dict(TINY, model=model, overlap=overlap,
                                    **kw)))
    b = m.prepare(_graph(), device=device)
    return m, b, m.init(torch.Generator().manual_seed(0), b)


def _launches(fn):
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts()


@pytest.mark.parametrize("model,kw", CASES, ids=[
    "-".join([m] + [f"{k}{v}" for k, v in kw.items()]) for m, kw in CASES])
def test_overlapped_forward_bitwise_the_serial_kernel_arm(cuda, model, kw):
    """Same kernels, same launches, same bits; a second overlapped call
    makes no scratch buffer (each side stream's was made by the first)."""
    m, b, p = _model(cuda, model, kw)
    serial, n_serial = _launches(lambda: m.forward(p, b))
    over, n_over = _launches(lambda: m.forward_overlapped(p, b))
    assert torch.equal(serial, over)
    assert n_over == n_serial and sum(n_serial.values()) > 0
    made = build.created
    again, _ = _launches(lambda: m.forward_overlapped(p, b))
    assert build.created == made and torch.equal(again, serial)
    d = m.executor.last_dispatch
    assert d["dispatched"] == list(m.executor.schedule_edges())
    assert d["max_inflight"] == 3


def test_sibling_stages_run_on_a_side_stream(cuda, monkeypatch):
    """``NA.p1`` and ``NA.own`` are called (their graphs replayed) on a
    side stream of the executor's, the rest on the caller's stream, and a
    tensor that crosses streams is recorded on its reader."""
    seen = {}
    recorded = []
    orig_record = torch.Tensor.record_stream

    def record(self, stream):
        recorded.append(stream)
        return orig_record(self, stream)

    monkeypatch.setattr(torch.Tensor, "record_stream", record)
    for model, kw, side in [("han", {"degree_buckets": 3}, "NA.p0.1"),
                            ("rgcn", {"partitions": 4}, "NA.own0")]:
        m, b, p = _model(cuda, model, kw)
        ovjit = m.executor._ovjit

        def spy(key, fn, copied=(), stream=0, ovjit=ovjit):
            f = ovjit(key, fn, copied, stream)

            def call(*a):
                seen[key] = torch.cuda.current_stream()
                return f(*a)
            return call

        monkeypatch.setattr(m.executor, "_ovjit", spy)
        main = torch.cuda.current_stream()
        recorded.clear()
        with torch.inference_mode():
            out = m.forward_overlapped(p, b)
        torch.cuda.synchronize()
        assert seen[side] != main
        assert all(s == main for n, s in seen.items() if n != side)
        assert seen[side] in recorded and main in recorded
        with torch.inference_mode():
            assert torch.equal(out, m.forward(p, b))
        seen.clear()


def test_fused_epilogue_stays_on_the_callers_stream(cuda):
    """The stacked ``sem=`` form launches its score sum with programmatic
    stream serialization: a fused-epilogue plan has no sibling stage, so
    it never reaches a side stream, and its overlapped forward is its
    serial one."""
    m, b, p = _model(cuda, "han", {"fuse_na_sa": True})
    assert m.plan().sa.fuse_epilogue
    assert not any(m.executor._branch(n)
                   for n in m.executor.schedule_edges())
    with torch.inference_mode():
        assert torch.equal(m.forward_overlapped(p, b), m.forward(p, b))


def test_depth_one_waits_for_every_stage(cuda):
    m, b, p = _model(cuda, "han", {"partitions": 4, "layers": 2}, overlap=1)
    with torch.inference_mode():
        assert torch.equal(m.forward_overlapped(p, b), m.forward(p, b))
    assert m.executor.last_dispatch["max_inflight"] == 1


def test_inflight_window_records_an_event_a_stage(cuda):
    win = InflightWindow(2)
    x = torch.ones(1 << 20, device=cuda)
    for i in range(5):
        win.admit(f"s{i}", x * i)
    assert win.max_inflight == 3 and len(win._live) == 2
    assert all(isinstance(e, torch.cuda.Event) for e in win._live)
    win.drain()
    assert win._live == []


@pytest.mark.parametrize("model", ["han", "rgcn"])
def test_prefetch_serve_bitwise_the_serve_without(cuda, model):
    """The sampler prefetch changes no bit of a served logit, and its
    worker stops at the end of the serve."""
    outs = []
    for overlap in (0, 2):
        cfg = HGNNConfig(**dict(TINY, model=model, fanout=4,
                                overlap=overlap))
        m = get_model(cfg)
        b = m.prepare(_graph(), device=cuda)
        p = m.init(torch.Generator().manual_seed(0), b)
        eng = HGNNServeEngine(m.executor, p,
                              HGNNSampler(m.plan(), cfg, _graph()), slots=4,
                              slot_targets=2)
        eng.warmup()
        rng = np.random.default_rng(3)
        reqs = [HGNNRequest(targets=rng.integers(0, 40, int(
            rng.integers(1, 9)))) for _ in range(10)]
        eng.serve(reqs)
        outs.append((reqs, eng))
    (sync, _), (pf, eng) = outs
    for a, c in zip(sync, pf):
        assert a.status == c.status == "OK"
        assert np.array_equal(a.logits, c.logits)
    assert eng.stats()["prefetch"]["hits"] > 0
    assert eng.prefetch._future is None and eng.prefetch._pool._shutdown


@pytest.mark.parametrize("n_rows,cols", [(300, 64), (40, 16), (3000, 8)])
def test_segment_sum_reads_cache_indices_through_the_hot_ids(cuda, n_rows,
                                                              cols):
    """The residency form: ``idx`` addresses ``concat(table,
    table[hot])``; the kernel reads a cache index's hot row, bitwise the
    plain version over the extended pool, and long segments (the block
    kernel) too."""
    rng = np.random.default_rng(n_rows)
    n = max(n_rows // 10, 2)
    e = 20 * n_rows
    seg = np.sort(rng.integers(0, n, e)).astype(np.int32)
    seg[: 600] = 0  # one segment past the block kernel's threshold
    seg = np.sort(seg)
    hot = rng.choice(n_rows, size=min(12, n_rows), replace=False).astype(
        np.int32)
    idx = rng.integers(0, n_rows + len(hot), e).astype(np.int32)
    table = rng.standard_normal((n_rows, cols)).astype(np.float32)
    v, s, i, h = (torch.from_numpy(a) for a in (table, seg, idx, hot))
    for mean in (False, True):
        want = tss.segment_sum_plain(v, s, n, idx=i, mean=mean, hot=h)
        got = tss.segment_sum(v.to(cuda), s.to(cuda), n, idx=i.to(cuda),
                              mean=mean, hot=h.to(cuda))
        assert torch.equal(got.cpu(), want)
