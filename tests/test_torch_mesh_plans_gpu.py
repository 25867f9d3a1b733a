"""Every padded HGNN plan and the decode kernel's log-sum-exp form on the
card.  On a 1-rank NCCL mesh (data=1, model=1), at the tiny graph's size,
each plan of ``chip_smoke.py``'s phase 9d through ``build_hgnn_infer(mesh=
...)`` under ``use_pallas``: logits bitwise the mesh-less forward's, the
same kernel launches, no c10d collective.  The log-sum-exp form of
``decode_attention``: its ``o`` bitwise the kernel's output without it,
its ``lse`` against the plain version at 1e-5 in fp32, ``o = 0`` and
``lse = -1e30`` on a row with no live cache row, and the split of one
cache into 2 and 4 contiguous shards, each run through the form and
combined (``nn/attention._combine_partials``), against the whole-cache
kernel.  And the two-rank gloo cases of ``tests/test_torch_mesh_plans_
gloo.py`` on this machine's torch, on its CPU, against the mesh-less
forward (DTensor's layouts differ between torch versions).  Every test
needs a CUDA device and skips without one.  The file imports no jax:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_mesh_plans_gpu.py
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch.configs.base import HGNNConfig
from repro_torch.core.hgraph import HeteroGraph
from repro_torch.data import synthetic as syn
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ops
from repro_torch.nn.attention import _combine_partials

pytestmark = pytest.mark.gpu
SMALL = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             attn_hidden=8, max_degree=16, use_pallas=True)
PLANS = {  # chip_smoke.py's phase 9d
    "han_bucketed": dict(model="han", fused=True, degree_buckets=3),
    "han_layers2": dict(model="han", fused=True, layers=2),
    "rgcn_padded": dict(model="rgcn", fused=True),
    "rgcn_bucketed": dict(model="rgcn", fused=True, degree_buckets=3),
    "magnn": dict(model="magnn"),
    "han_partitioned": dict(model="han", fused=True, partitions=4),
    "rgcn_partitioned": dict(model="rgcn", fused=True, partitions=4),
    "magnn_partitioned": dict(model="magnn", partitions=4),
    "magnn_cached": dict(model="magnn", cache_rows=8),
    "han_overlap": dict(model="han", fused=True, overlap=2),
}
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       # bf16 partials (each o rounded to bf16) against one bf16 output:
       # a bf16 ulp or two, chip_smoke.py's TOL_BF16_OUT
       torch.bfloat16: dict(atol=1e-3, rtol=8e-3)}
HELPER = Path(__file__).with_name("torch_mesh_plans_ranks.py")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mesh(cuda):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_smoke_mesh(data=1, model=1)
    finally:
        dist.destroy_process_group()


def _tiny_graph():
    rng = np.random.default_rng(7)
    counts = {"M": 40, "D": 15, "A": 25}
    dims = {"M": 12, "D": 8, "A": 10}
    feats = {t: rng.standard_normal((n, dims[t])).astype(np.float32)
             for t, n in counts.items()}

    def rel(ns, nd, e):
        return sp.csr_matrix((np.ones(e, np.float32),
                              (rng.integers(0, ns, e),
                               rng.integers(0, nd, e))), shape=(ns, nd))

    md, ma = rel(40, 15, 60), rel(40, 25, 80)
    return HeteroGraph(counts, feats, {("M", "md", "D"): md,
                                       ("D", "dm", "M"): md.T.tocsr(),
                                       ("M", "ma", "A"): ma,
                                       ("A", "am", "M"): ma.T.tocsr()},
                       name="tiny")


@pytest.fixture
def tiny_graph(monkeypatch):
    monkeypatch.setitem(syn.DATASET_METAPATHS, "tiny",
                        [["M", "D", "M"], ["M", "A", "M"]])
    monkeypatch.setitem(syn.DATASET_TARGET, "tiny", "M")
    return _tiny_graph()


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_on_the_mesh_is_bitwise_the_meshless_forward(mesh, tiny_graph,
                                                          name):
    from repro_torch.launch.serve import build_hgnn_infer

    cfg = HGNNConfig(**SMALL, **PLANS[name])
    plain = build_hgnn_infer(cfg, tiny_graph, "cuda")
    meshed = build_hgnn_infer(cfg, tiny_graph, "cuda", mesh=mesh)
    runs = []
    for b in (plain, meshed):
        ops.reset_launch_counts()
        comm = CommDebugMode()
        with comm, torch.inference_mode():
            out = b.fn(b.params, b.batch)
        torch.cuda.synchronize()
        runs.append((out, ops.launch_counts(), comm.get_total_counts()))
    (want, c_plain, _), (got, c_mesh, n_coll) = runs
    assert n_coll == 0
    assert sum(c_plain.values()) > 0 and c_mesh == c_plain
    assert torch.equal(got.full_tensor(), want)


def _draw(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


# (B, S, H, KVH, Dh, kv_len): phase 5c's granite decode shape at its served
# lengths, a G 1 and an odd-Dh case, each with a row of no live row
LSE_CASES = [
    (4, 2080, 32, 8, 128, [1, 1000, 2049, 0]),
    (2, 300, 8, 8, 64, [0, 300]),
    (2, 130, 6, 2, 7, [129, 0]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LSE_CASES)
def test_lse_form_keeps_o_and_matches_the_plain_lse(cuda, case, dtype):
    b, s, h, kvh, dh, lens = case
    gen = torch.Generator(device=cuda).manual_seed(b * s + dh)
    q = _draw(gen, (b, h, dh), dtype)
    k, v = _draw(gen, (b, s, kvh, dh), dtype), _draw(gen, (b, s, kvh, dh),
                                                      dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = tdec.decode_attention.launches
    lse_before = tdec.decode_attention.lse_launches
    o, lse = tdec.decode_attention(q, k, v, kv_len, return_lse=True)
    torch.cuda.synchronize()
    assert tdec.decode_attention.launches == before + 1
    assert tdec.decode_attention.lse_launches == lse_before + 1
    assert torch.equal(o, tdec.decode_attention(q, k, v, kv_len))
    assert lse.dtype == torch.float32 and lse.shape == (b, h)
    dead = kv_len == 0
    assert torch.all(o[dead] == 0) and torch.all(lse[dead] == -1e30)
    # the plain lse on the fp32 values of the same inputs
    _, want = tdec.decode_attention_plain(q.float(), k.float(), v.float(),
                                          kv_len, return_lse=True)
    torch.testing.assert_close(lse, want, **TOL[torch.float32])
    assert torch.equal(lse, tdec.decode_attention(q, k, v, kv_len,
                                                  return_lse=True)[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
def test_split_cache_combines_to_the_whole_cache_kernel(cuda, n, dtype):
    b, s, h, kvh, dh = 4, 2080, 32, 8, 128
    gen = torch.Generator(device=cuda).manual_seed(n)
    q = _draw(gen, (b, h, dh), dtype)
    k, v = _draw(gen, (b, s, kvh, dh), dtype), _draw(gen, (b, s, kvh, dh),
                                                      dtype)
    # the last shard holds no live row of batch rows 0 and 1
    kv_len = torch.tensor([1, s // n, 1500, s], dtype=torch.int32,
                          device=cuda)
    whole = tdec.decode_attention(q, k, v, kv_len)
    s_loc = s // n
    parts = [tdec.decode_attention(
        q, k[:, r * s_loc:(r + 1) * s_loc].contiguous(),
        v[:, r * s_loc:(r + 1) * s_loc].contiguous(),
        torch.clamp(kv_len - r * s_loc, 0, s_loc).to(torch.int32),
        return_lse=True) for r in range(n)]
    got = _combine_partials(torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts]), dtype)
    torch.cuda.synchronize()
    assert torch.all(parts[-1][1][:2] == -1e30)
    assert torch.all(parts[-1][0][:2] == 0)
    torch.testing.assert_close(got.float(), whole.float(), **TOL[dtype])


def test_two_gloo_ranks_on_this_torch_match_the_meshless_forward(
        cuda, tmp_path):
    """The ranks of ``tests/test_torch_mesh_plans_gloo.py`` on this
    machine's torch (gloo, its CPU), with the port's own weights, against
    the mesh-less forward and decode step at 1e-5; ``"auto"`` one
    all-gather a node type and layer, bitwise ``"xla"``."""
    sys.path.insert(0, str(HELPER.parent))
    from torch_mesh_plans_ranks import CASES, PARTITIONED

    from repro_torch.configs.registry import get_reduced
    from repro_torch.nn.transformer import init_lm_params

    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(HELPER), str(tmp_path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        cfg = get_reduced("granite-8b")
        tokens = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, (2, 16)).astype(np.int32))
        torch.save({"hg": _tiny_graph(),
                    "metapaths": {"tiny": [["M", "D", "M"],
                                           ["M", "A", "M"]]},
                    "targets": {"tiny": "M"}, "plain": True,
                    "hgnn": {name: {"cfg": kw, "mesh": m, "halo": halo,
                                    "params": None}
                             for name, (kw, m, halo) in CASES.items()},
                    "lm": {"arch": "granite-8b", "mesh": (1, 2),
                           "tokens": tokens, "params": init_lm_params(
                               torch.Generator().manual_seed(1), cfg)}},
                   tmp_path / "inputs.pt.part")
        os.replace(tmp_path / "inputs.pt.part", tmp_path / "inputs.pt")
        _, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    got = torch.load(tmp_path / "outputs.pt", weights_only=False)
    for name, logits in got["hgnn"].items():
        torch.testing.assert_close(logits, got["plain"][name],
                                   **TOL[torch.float32], msg=name)
    for name in PARTITIONED:
        for c in got["halo_comm"][f"{name}/auto"]:
            assert c == {"types": c["types"],
                         "all_gather_into_tensor": c["types"]}, (name, c)
        assert torch.equal(got["hgnn"][f"{name}/auto"],
                           got["hgnn"][f"{name}/xla"])
    assert len(got["lse_calls"]) == cfg.n_layers
    torch.testing.assert_close(got["granite_decode"],
                               got["plain"]["granite_decode"],
                               **TOL[torch.float32])
