"""Graph-partitioned execution on the card (``repro_torch/dist/
partition.py``, the executor's partitioned arms, the serve engine's
failover): on a small graph, every partitioned plan with the hand kernels
against the same plan's plain arm on the CPU, the kernel launches a
partition, and the identities bitwise on the card (``K = 1`` is the
unpartitioned kernel arm, cached is uncached, a serve that loses a
partition is the never-failed serve).  Every test needs a CUDA device and
skips without one.  The file imports no jax, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_partition_gpu.py

Tolerance against the CPU's plain arm: atol = rtol = 1e-4 (the kernels
reduce in their own fixed orders, another device's libraries the rest)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph
from repro_torch.core.models import get_model
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.serve.engine import HGNNRequest, HGNNServeEngine
from repro_torch.serve.faults import Fault, FaultInjector
from repro_torch.serve.sampler import HGNNSampler

pytestmark = pytest.mark.gpu
TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
            max_degree=6, max_instances=4, fused=True)
# (model, layers) -> launches of one forward at K partitions
LAUNCHES = {
    ("han", 1): lambda k: {"gat_na": k},
    ("han", 2): lambda k: {"gat_na": 2 * k},
    ("rgcn", 1): lambda k: {"segment_spmm": 2 * k},  # relations into M
    ("rgcn", 2): lambda k: {"segment_spmm": 2 * 4 * k},  # every relation
    ("magnn", 1): lambda k: {"gat_na": 2},  # a metapath, every partition
    ("magnn", 2): lambda k: {"gat_na": 2 * 2},
}


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


def _forward(device, seed=0, **kw):
    """Logits of one plan on ``device``, parameters from ``seed`` (drawn on
    the CPU, so every device gets the same numbers), and the launches of
    that forward."""
    m = get_model(HGNNConfig(**dict(TINY, **kw)))
    b = m.prepare(_graph(), device=device)
    p = m.init(torch.Generator().manual_seed(seed), b)
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = m.forward(p, b)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out.cpu(), {k: v for k, v in ops.launch_counts().items() if v}


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("model,layers", sorted(LAUNCHES))
def test_partitioned_kernel_arm_matches_the_cpu_plain_arm(cuda, model,
                                                          layers, k):
    kw = dict(model=model, layers=layers, partitions=k)
    got, launches = _forward(cuda, use_pallas=True, **kw)
    want, _ = _forward(torch.device("cpu"), use_pallas=False, **kw)
    assert launches == LAUNCHES[(model, layers)](k)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("model,layers", sorted(LAUNCHES))
def test_one_partition_is_bitwise_the_unpartitioned_kernel_arm(cuda, model,
                                                               layers):
    kw = dict(model=model, layers=layers, use_pallas=True)
    one, _ = _forward(cuda, partitions=1, **kw)
    flat, _ = _forward(cuda, **kw)
    torch.testing.assert_close(one, flat, rtol=0, atol=0)


@pytest.mark.parametrize("model", ["han", "rgcn", "magnn"])
def test_partition_counts_agree_on_the_card(cuda, model):
    kw = dict(model=model, use_pallas=True)
    flat, _ = _forward(cuda, **kw)
    for k in (2, 3, 4):
        got, _ = _forward(cuda, partitions=k, **kw)
        torch.testing.assert_close(got, flat, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("model", ["han", "rgcn", "magnn"])
def test_partitioned_cached_is_bitwise_uncached_on_the_card(cuda, model):
    kw = dict(model=model, layers=2, partitions=3, use_pallas=True)
    cached, _ = _forward(cuda, cache_rows=6, **kw)
    plain, _ = _forward(cuda, **kw)
    torch.testing.assert_close(cached, plain, rtol=0, atol=0)


def test_failover_serve_is_bitwise_the_never_failed_serve(cuda):
    cfg = HGNNConfig(**dict(TINY, model="han", fanout=64, max_degree=48,
                            partitions=4, use_pallas=True))
    m = get_model(cfg)
    hg = _graph()
    b = m.prepare(hg, device=cuda)
    p = m.init(torch.Generator().manual_seed(0), b)
    with torch.inference_mode():
        full = m.forward(p, b).cpu().numpy()

    def serve(inj):
        eng = HGNNServeEngine(m.executor, p, HGNNSampler(m.plan(), cfg, hg),
                              slots=4, slot_targets=2, injector=inj)
        eng.warmup()
        rng = np.random.default_rng(3)
        reqs = [HGNNRequest(targets=rng.integers(
            0, 40, size=int(rng.integers(1, 9)))) for _ in range(10)]
        eng.serve(reqs)
        return eng, reqs

    ops.reset_launch_counts()
    e1, r1 = serve(FaultInjector([Fault(step=2, kind="partition",
                                        partition=1)]))
    # 3 warmup rungs + 6 steps, one stacked launch a partition: K = 4 for
    # the warmup and steps 0-1, K = 3 after the loss
    assert ops.launch_counts()["gat_na"] == 4 * (3 + 2) + 3 * 4
    e2, r2 = serve(None)
    st = e1.stats()
    assert st["resilience"]["partition_failovers"] == 1
    assert st["resilience"]["failed_steps"] == st["resilience"]["retries"] \
        == 0
    assert st["compiles_after_warmup"] == 1  # one rung served at K = 3
    assert e2.stats()["compiles_after_warmup"] == 0
    for a, c in zip(r1, r2):
        assert a.status == c.status == "OK"
        np.testing.assert_array_equal(a.logits, c.logits)
        np.testing.assert_array_equal(a.logits, full[a.targets])
