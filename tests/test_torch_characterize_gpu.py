"""Per-stage characterization on the card (``core/characterize.py``,
``StageGraphExecutor.stage_records``): every ported plan on a small graph,
its records on the card against its records on the CPU, and its timed
records.  Every test needs a CUDA device and skips without one.  The file
imports no jax, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_characterize_gpu.py

Exact, not by tolerance: FLOPs and bytes are counts, and the kernels
declare the same work on both devices.  A device time by class is a sum
of the same kernel durations as the stage's device time, so the two agree
to float rounding (rel 1e-9)."""
import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph
from repro_torch.core.models import get_model
from repro_torch.data import synthetic as syn

pytestmark = pytest.mark.gpu
TINY = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
            max_degree=48, max_instances=4, use_pallas=True)
VARIANTS = {
    "han-stacked": dict(model="han", fused=True),
    "han-epilogue": dict(model="han", fused=True, fuse_na_sa=True),
    "han-csr": dict(model="han", fused=False),
    "han-bucketed": dict(model="han", fused=True, degree_buckets=3),
    "han-cached": dict(model="han", fused=True, cache_rows=12),
    "rgcn-padded": dict(model="rgcn", fused=True),
    "rgcn-bucketed": dict(model="rgcn", fused=True, degree_buckets=3),
    "rgcn-csr": dict(model="rgcn", fused=False),
    "magnn": dict(model="magnn"),
    "magnn-cached": dict(model="magnn", cache_rows=12),
    "gcn": dict(model="gcn", dataset="reddit", hidden=16, n_classes=5,
                use_pallas=True),
}
KEYS = ("flops", "hbm_bytes", "flops_by_class", "hbm_bytes_by_class")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    syn.DATASET_METAPATHS["tiny"] = [["M", "D", "M"], ["M", "A", "M"]]
    syn.DATASET_TARGET["tiny"] = "M"
    return torch.device("cuda")


def _graph(variant):
    if VARIANTS[variant].get("dataset") == "reddit":
        return syn.make_reddit_like(scale=0.005)
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


def _model(variant):
    kw = VARIANTS[variant]
    return get_model(HGNNConfig(**(kw if "dataset" in kw
                                   else dict(TINY, **kw))))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_card_records_equal_the_cpu_records(cuda, variant):
    m, hg = _model(variant), _graph(variant)
    b_cpu = m.prepare(hg, device="cpu")
    p_cpu = m.init(torch.Generator().manual_seed(0), b_cpu)
    b = m.prepare(hg, device=cuda)
    p = m.init(torch.Generator().manual_seed(0), b)
    on_card, on_cpu = m.stage_records(p, b), m.stage_records(p_cpu, b_cpu)
    assert list(on_card["stages"]) == list(on_cpu["stages"])
    for name, rec in on_card["stages"].items():
        for k in KEYS:
            assert rec[k] == on_cpu["stages"][name][k], (name, k)
    assert on_card["total"] == on_cpu["total"]
    assert on_card.get("residency") == on_cpu.get("residency")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_timed_records_sum_by_class_with_no_other_kernel(cuda, variant):
    m, hg = _model(variant), _graph(variant)
    b = m.prepare(hg, device=cuda)
    p = m.init(torch.Generator().manual_seed(0), b)
    recs = m.stage_records(p, b, timed=True)["stages"]
    for name, rec in recs.items():
        assert rec["flops"] == sum(rec["flops_by_class"].values()), name
        assert rec["hbm_bytes"] == sum(rec["hbm_bytes_by_class"].values())
        assert rec["time_us"] > 0, name
        assert math.isclose(sum(rec["device_us_by_class"].values()),
                            rec["device_us"], rel_tol=1e-9), name
        assert rec["other_kernels"] == [], (name, rec["other_kernels"])
        if rec["hbm_bytes"]:
            assert rec["device_us"] > 0, name
    assert recs["FP"]["device_us_by_class"].get("DM", 0) > 0
