"""The compiled step on the card (``src/repro_torch/graphs.py``): captured
CUDA graphs held bitwise against the eager calls they stand for, at small
sizes.  Every test needs a CUDA device and skips without one.  The file
imports no jax:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_graphs_gpu.py

Checked: HGNN forwards from ``build_hgnn_infer`` (HAN with the fused
epilogue, RGCN padded, MAGNN, GCN ``csr``) and ``HGNNInferEngine`` with
``fn=None``, bitwise their eager ``fn.fn`` with the same launches a call;
a served ladder (one capture a rung, ``compiles_after_warmup`` 0, logits
bitwise the eager engine's); ``ServeEngine``'s decode for 2-layer fp32
granite, MoE, SSM and hybrid configs, tokens and decode logits bitwise an
eager ``lm_decode_step`` loop with the same launches, one capture a wave
batch size; scratch buffers made before the capture and kept after a
larger one grew them; both programmatic-dependent launches (``gat_na``'s
score sum, ``decode_attention``'s combine) captured and replayed.  Each
graph keeps the scratch buffers that its kernels read, and the decode
reads one set of caches for the engine's slots at every wave size.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch import graphs
from repro_torch.configs.base import HGNNConfig
from repro_torch.configs.registry import get_reduced
from repro_torch.core import hgraph
from repro_torch.data import synthetic as syn
from repro_torch.kernels import build, ops
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import gat_na as tgat
from repro_torch.launch.serve import build_hgnn_infer, request_queue
from repro_torch.nn import transformer as tf
from repro_torch.serve.engine import (HGNNInferEngine, HGNNServeEngine,
                                      Request, ServeEngine)
from repro_torch.serve.sampler import HGNNSampler

pytestmark = pytest.mark.gpu
TINY = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
            max_degree=6, max_instances=4, fused=True, use_pallas=True)
PLANS = {
    "han-fused": dict(model="han", fuse_na_sa=True),
    "rgcn-padded": dict(model="rgcn"),
    "magnn": dict(model="magnn"),
    "gcn-csr": dict(model="gcn", dataset="reddit"),
}
FAMILIES = ("granite-8b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
            "zamba2-1.2b")


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


def _hg(kw):
    if kw.get("dataset") == "reddit":
        return syn.make_reddit_like(scale=0.005)
    return _graph()


def _counted(fn):
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts()


@pytest.mark.parametrize("name", sorted(PLANS))
def test_captured_forward_is_bitwise_the_eager_one(cuda, name):
    kw = dict(TINY, **PLANS[name])
    b = build_hgnn_infer(HGNNConfig(**kw), _hg(kw), cuda)
    assert isinstance(b.fn, graphs.Compiled)
    want, c_eager = _counted(lambda: b.fn.fn(b.params, b.batch))
    assert sum(c_eager.values()) > 0
    outs = []
    for i in range(3):
        out, c = _counted(lambda: b.fn(b.params, b.batch))
        assert c == c_eager, (i, c, c_eager)
        assert torch.equal(out, want)
        outs.append(out)
    assert torch.equal(outs[0], want)  # unchanged by the replays
    assert (b.fn.captures, b.fn.replays) == (1, 2)
    eng = HGNNInferEngine(b.executor, b.params, b.batch)
    assert torch.equal(eng.infer(), want) and torch.equal(eng.infer(), want)
    assert (eng.fn.captures, eng.fn.replays) == (1, 1)


def test_served_ladder_one_capture_a_rung_bitwise_the_eager_serve(cuda):
    cfg = HGNNConfig(**dict(TINY, model="han", fanout=3,
                            sample_ladder=((4, 12), (8, 24), (16, 40))))
    hg = _graph()
    b = build_hgnn_infer(cfg, hg, cuda)
    runs = []
    for fn in (b.fn, b.executor.forward):
        sampler = HGNNSampler(b.plan, cfg, hg)
        eng = HGNNServeEngine(b.executor, b.params, sampler, slots=4,
                              slot_targets=2, fn=fn)
        reqs = request_queue(sampler.n_target_type, 2, 12, seed=3)
        ops.reset_launch_counts()
        eng.warmup()
        eng.serve(reqs)
        torch.cuda.synchronize()
        runs.append((eng, reqs, ops.launch_counts()))
    (eng, reqs, counts), (eager, e_reqs, e_counts) = runs
    assert eng._captured and not eager._captured
    assert eng.fn is not b.fn and eng.fn.captures == 3
    assert eng.fn.replays == eng.stats()["steps"]
    assert counts == e_counts and counts["gat_na"] > 0
    st = eng.stats()
    assert st["compiles_after_warmup"] == 0
    assert st["resilience"]["failed_steps"] == st["resilience"]["retries"] \
        == 0
    for a, e in zip(reqs, e_reqs):
        assert a.status == e.status == "OK"
        np.testing.assert_array_equal(a.logits, e.logits)
    # the rungs' scratch: made before each capture, kept by the graphs
    assert all(g.scratch for g in eng.fn.graphs.values())


def _eager_waves(cfg, params, prompts, slots, n_new, max_len):
    """The engine's greedy waves as an eager ``lm_decode_step`` loop:
    tokens and every decode step's logits."""
    toks, logits = [], []
    with torch.inference_mode():
        for w in range(0, len(prompts), slots):
            wave = prompts[w:w + slots]
            t0 = max(len(p) for p in wave)
            x = np.zeros((len(wave), t0), np.int32)
            for i, p in enumerate(wave):
                x[i, t0 - len(p):] = p
            lg, pf = tf.lm_prefill(params, cfg, torch.from_numpy(x).cuda())
            caches = tf.graft_prefill_caches(
                cfg, tf.init_kv_caches(cfg, len(wave), max_len, "cuda"), pf,
                t0)
            cur = lg[:, 0].argmax(-1)
            out = [cur]
            pos = torch.tensor(t0, device="cuda")
            for _ in range(n_new - 1):
                lg, caches = tf.lm_decode_step(params, cfg, cur[:, None],
                                               caches, pos)
                pos = pos + 1
                logits.append(lg.clone())
                cur = lg[:, 0].argmax(-1)
                out.append(cur)
            toks += torch.stack(out, 1).tolist()
    return toks, logits


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_captured_bitwise_the_eager_loop(cuda, name):
    cfg = get_reduced(name).replace(use_pallas=True)
    params = tf.init_lm_params(torch.Generator(device=cuda).manual_seed(0),
                               cfg)
    rng = np.random.default_rng(5)
    # two waves of 2 and one of 1: the second wave reuses the first's
    # graph and caches (a shorter prompt over a cache that held a longer)
    lens = (32, 16, 16, 16, 32)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    n_new, max_len = 6, 40
    ops.reset_launch_counts()
    want, want_logits = _eager_waves(cfg, params, prompts, 2, n_new, max_len)
    c_eager = ops.launch_counts()
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=max_len)
    seen = []
    decode = eng._decode

    def recorded(*a):
        out = decode(*a)
        seen.append(out[0].clone())
        return out

    eng._decode = recorded
    ops.reset_launch_counts()
    got = eng.generate([Request(prompt=p, max_tokens=n_new)
                        for p in prompts])
    torch.cuda.synchronize()
    assert ops.launch_counts() == c_eager
    assert [r.out_tokens for r in got] == want
    assert len(seen) == len(want_logits)
    assert all(torch.equal(a, b) for a, b in zip(seen, want_logits))
    assert (decode.captures, decode.replays) == (2, len(seen) - 2)
    # one set of caches, for the engine's 2 slots, read by both graphs
    assert all(t.shape[1] == 2 for c in eng._caches
               for t in (c if isinstance(c, tuple) else c.values()))
    assert (c_eager["decode_attention"] > 0) == (name != "mamba2-2.7b")


def test_pdl_launchers_capture_and_replay(cuda):
    """``gat_na``'s score sum and ``decode_attention``'s combine are
    launched with programmatic stream serialization; both are captured
    and replayed bitwise the eager launch."""
    gen = torch.Generator(device=cuda).manual_seed(3)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    s, n, k, h, dh, hs, m = 2, 300, 8, 4, 8, 16, 500
    p = {"a_dst": rand(s, h, dh), "a_src": rand(s, h, dh)}
    sem = {"W": rand(h * dh, hs), "b": rand(hs), "q": rand(hs)}
    nbr = torch.randint(0, m, (s, n, k), generator=gen, device=cuda,
                        dtype=torch.int32)
    mask = (torch.rand((s, n, k), generator=gen, device=cuda) > 0.3).float()
    h_dst, h_src = rand(n, h, dh), rand(m, h, dh)
    q, kc, vc = rand(4, 8, 64), rand(4, 96, 2, 64), rand(4, 96, 2, 64)
    kv_len = torch.tensor([1, 40, 96, 70], dtype=torch.int32, device=cuda)
    for call in (lambda: tgat.gat_na(p, h_dst, h_src, nbr, mask, sem=sem),
                 lambda: tdec.decode_attention(q, kc, vc, kv_len)):
        want = call()
        f = graphs.compiled(lambda *_: call())
        outs = [f(q) for _ in range(3)]
        torch.cuda.synchronize()
        for out in outs:
            for a, b in zip(out if isinstance(out, tuple) else (out,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.equal(a, b)
        assert (f.captures, f.replays) == (1, 2)
