"""The port's dense LM (``nn/norm.py``, ``nn/rope.py``, ``nn/mlp.py``,
``nn/attention.py``, ``nn/transformer.py``) against the reference on the
same parameters: each tree is made by the reference's ``init_lm_params``
and carried across by ``interop.params_from_numpy``.

Held at atol = rtol = 1e-5 in fp32 (the same model in two frameworks: the
matmuls and softmax sums differ in order) for ``lm_forward``, ``lm_prefill``
and its caches, ``graft_prefill_caches`` and 8 decode steps, on the dense
and sliding-window families of ``tests/test_transformer.py`` and the
reduced smollm-360m (heads padded 3 -> 16), granite-8b and h2o-danube-3-4b,
each with ``use_pallas`` off and on (on the CPU the kernel entry points run
their plain versions)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import get_reduced as j_get_reduced
from repro.nn import attention as jattn
from repro.nn import mlp as jmlp
from repro.nn import norm as jnorm
from repro.nn import rope as jrope
from repro.nn import transformer as jtf
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_reduced
from repro_torch.interop import params_from_numpy
from repro_torch.nn import attention as tattn
from repro_torch.nn import mlp as tmlp
from repro_torch.nn import norm as tnorm
from repro_torch.nn import rope as trope
from repro_torch.nn import transformer as ttf

TOL = dict(atol=1e-5, rtol=1e-5)
CONFIGS = ["dense", "swa", "smollm-360m", "granite-8b", "h2o-danube-3-4b"]
B, S, T0 = 2, 40, 32  # 8 decode steps; S passes every ring's window


def _j_cfg(name, tiny):
    """The reference config: ``tests/test_transformer.py``'s dense and
    sliding-window families on ``tiny_cfg_base``, or a reduced arch."""
    if name == "dense":
        return jbase.ModelConfig(name="d", family="dense", **dict(tiny))
    if name == "swa":
        return jbase.ModelConfig(name="w", family="dense", sliding_window=16,
                                 **dict(tiny))
    return j_get_reduced(name)


def _t_cfg(name, tiny, use_pallas):
    fields = dataclasses.asdict(_j_cfg(name, tiny))
    return tbase.ModelConfig(**fields).replace(use_pallas=use_pallas)


@pytest.fixture
def tiny(tiny_cfg_base):
    return tuple(sorted(tiny_cfg_base.items()))  # hashable, for the cache


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _jit_decode(cfg):
    """The reference's decode step, jitted as its ``ServeEngine`` does."""
    return jax.jit(lambda p, t, c, pos: jtf.lm_decode_step(p, cfg, t, c, pos))


@functools.lru_cache(maxsize=None)
def _reference_run(name, tiny):
    """The JAX model's parameters, tokens and every output compared."""
    cfg = _j_cfg(name, tiny)
    params = jtf.init_lm_params(jax.random.key(0), cfg)
    tokens = np.random.default_rng(len(name)).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    logits, _ = jtf.lm_forward(params, cfg, jnp.asarray(tokens))
    lg, pf = jtf.lm_prefill(params, cfg, jnp.asarray(tokens[:, :T0]))
    caches = jtf.graft_prefill_caches(cfg, jtf.init_kv_caches(cfg, B, S),
                                      pf, T0)
    out = {"params": params, "tokens": tokens, "forward": _np(logits),
           "prefill": _np(lg), "prefill_kv": [(_np(c["k"]), _np(c["v"]))
                                              for c in pf],
           "graft": [(_np(c["k"]), _np(c["v"])) for c in caches],
           "decode": []}
    step = _jit_decode(cfg)
    for t in range(T0, S):
        lg, caches = step(params, jnp.asarray(tokens[:, t:t + 1]), caches,
                          jnp.int32(t))
        out["decode"].append(_np(lg))
    out["decode_kv"] = [(_np(c["k"]), _np(c["v"])) for c in caches]
    return out


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", CONFIGS)
def test_forward_prefill_graft_decode_match_reference(tiny, name,
                                                      use_pallas):
    ref = _reference_run(name, tiny)
    cfg = _t_cfg(name, tiny, use_pallas)
    params = params_from_numpy(ref["params"], "cpu")
    tokens = torch.from_numpy(ref["tokens"])
    with torch.inference_mode():
        logits, aux = ttf.lm_forward(params, cfg, tokens)
        _close(logits, ref["forward"])
        assert float(aux) == 0.0
        lg, pf = ttf.lm_prefill(params, cfg, tokens[:, :T0])
        _close(lg, ref["prefill"])
        for got, (k, v) in zip(pf, ref["prefill_kv"]):
            _close(got["k"], k)
            _close(got["v"], v)
        caches = ttf.graft_prefill_caches(
            cfg, ttf.init_kv_caches(cfg, B, S, "cpu"), pf, T0)
        for got, (k, v) in zip(caches, ref["graft"]):
            assert got["k"].shape == k.shape
            _close(got["k"], k)
            _close(got["v"], v)
        for i, t in enumerate(range(T0, S)):
            lg, caches = ttf.lm_decode_step(params, cfg, tokens[:, t:t + 1],
                                            caches, t)
            _close(lg, ref["decode"][i])
        for got, (k, v) in zip(caches, ref["decode_kv"]):
            _close(got["k"], k)
            _close(got["v"], v)


def test_swa_ring_cache_long_decode(tiny_cfg_base):
    """The reference's ring-cache test (``tests/test_transformer.py``) as a
    port-versus-JAX check: 32 decode steps from an empty ring of 8 slots,
    every step's logits held to the reference's."""
    jcfg = jbase.ModelConfig(name="w", family="dense", sliding_window=8,
                             **tiny_cfg_base)
    tcfg = tbase.ModelConfig(name="w", family="dense", sliding_window=8,
                             **tiny_cfg_base)
    jp = jtf.init_lm_params(jax.random.key(0), jcfg)
    tp = params_from_numpy(jp, "cpu")
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (1, 32))
    jc, tc = (jtf.init_kv_caches(jcfg, 1, 32),
              ttf.init_kv_caches(tcfg, 1, 32, "cpu"))
    assert tc[0]["k"].shape == jc[0]["k"].shape == (2, 1, 8, 2, 8)
    step = _jit_decode(jcfg)
    with torch.inference_mode():
        for t in range(32):
            jl, jc = step(jp, jnp.asarray(tokens[:, t:t + 1], jnp.int32), jc,
                          jnp.int32(t))
            tl, tc = ttf.lm_decode_step(tp, tcfg, torch.from_numpy(
                tokens[:, t:t + 1]), tc, torch.tensor(t))
            _close(tl, jl)
        _close(tc[0]["k"], jc[0]["k"])
        full, _ = ttf.lm_forward(tp, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(tl[:, 0]), _np(full[:, -1]), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 300),
                                           (False, 0)])
def test_chunked_attention_matches_reference_at_2048(causal, window):
    """The plain arm above 1024 tokens: 512-token chunks over S = 2048."""
    rng = np.random.default_rng(window + causal)
    arrs = [(rng.standard_normal(sh) * 0.5).astype(np.float32)
            for sh in ((1, 2048, 4, 16), (1, 2048, 2, 16), (1, 2048, 2, 16))]
    want = jattn.chunked_attention(*map(jnp.asarray, arrs), causal=causal,
                                   window=window, chunk_q=512, chunk_k=512)
    got = tattn.chunked_attention(*map(torch.from_numpy, arrs),
                                  causal=causal, window=window, chunk_q=512,
                                  chunk_k=512)
    _close(got, want)


@pytest.mark.parametrize("name,s", [("dense", 12), ("swa", 40)])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_block_matches_reference(tiny, name, s, use_pallas):
    jcfg, tcfg = _j_cfg(name, tiny), _t_cfg(name, tiny, use_pallas)
    p = jattn.init_attention(jax.random.key(1), jcfg)
    x = np.random.default_rng(s).standard_normal((2, s, 32)).astype(
        np.float32)
    pos = np.arange(s)
    want, (wk, wv) = jattn.attention_block(p, jcfg, jnp.asarray(x),
                                           jnp.asarray(pos), return_kv=True)
    got, (k, v) = tattn.attention_block(params_from_numpy(p, "cpu"), tcfg,
                                        torch.from_numpy(x),
                                        torch.from_numpy(pos),
                                        return_kv=True)
    _close(got, want)
    _close(k, wk)
    _close(v, wv)


def test_norm_rope_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    _close(tnorm.rmsnorm(torch.from_numpy(g), torch.from_numpy(x), 1e-5),
           jnorm.rmsnorm(jnp.asarray(g), jnp.asarray(x), 1e-5))
    pos = np.array([[3, 4, 5, 6, 7], [100, 101, 102, 103, 104]])
    _close(trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    # interleaved pairs: (x0, x1) rotate together, not (x0, x8)
    e0 = torch.zeros(1, 1, 1, 16)
    e0[..., 0] = 1.0
    y = trope.apply_rope(e0, torch.tensor([1]), 1e4)
    assert y[..., 2:].abs().max() == 0 and y[..., 1].abs() > 0.5
    p = jmlp.init_mlp(jax.random.key(2), 16, 24, 2, jnp.float32)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    _close(tmlp.mlp_block(params_from_numpy(p, "cpu"), torch.from_numpy(h)),
           jmlp.mlp_block(p, jnp.asarray(h)))


@pytest.mark.parametrize("name", CONFIGS)
def test_init_lm_params_mirrors_the_reference_tree(tiny, name):
    """Same tree, shapes and dtypes as the reference's ``init_lm_params``,
    zero padded head slices, drawn on the generator's device."""
    jcfg, tcfg = _j_cfg(name, tiny), _t_cfg(name, tiny, False)
    jp = jax.eval_shape(lambda: jtf.init_lm_params(jax.random.key(0), jcfg))
    tp = ttf.init_lm_params(torch.Generator().manual_seed(0), tcfg)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == \
        [jax.tree_util.keystr(k) for k, _ in tflat]
    for (_, a), (_, t) in zip(jflat, tflat):
        assert tuple(a.shape) == tuple(t.shape)
        assert str(a.dtype) == str(t.dtype).replace("torch.", "")
        assert t.device.type == "cpu"
    assert ttf.param_count(tp) == jtf.param_count(jp)
    h, kvh = tattn._heads(tcfg)
    dh = tcfg.resolved_head_dim
    attn = tp["runs"][0]["attn"]
    assert attn["wq"][:, :, tcfg.n_heads * dh:].abs().max().item() == 0 \
        if h > tcfg.n_heads else True
    assert attn["wo"][:, tcfg.n_heads * dh:].abs().sum().item() == 0
    assert attn["wk"][:, :, :tcfg.n_kv_heads * dh].std() > 0
    # the second layer is drawn anew, not a copy of the first
    assert not torch.equal(attn["wq"][0], attn["wq"][1])


def test_bf16_tree_carries_across_bitwise(tiny_cfg_base):
    """A bf16 reference LM tree (``param_dtype="bfloat16"``, as every
    full-size config has) crosses ``params_from_numpy`` exactly."""
    cfg = jbase.ModelConfig(name="d", family="dense",
                            **dict(tiny_cfg_base, dtype="bfloat16",
                                   param_dtype="bfloat16"))
    jp = jtf.init_lm_params(jax.random.key(3), cfg)
    tp = params_from_numpy(jp, "cpu")
    jflat = jax.tree_util.tree_leaves(jp)
    tflat = jax.tree_util.tree_leaves(tp)
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["ln_f"].dtype == torch.float32
    for a, t in zip(jflat, tflat):
        assert str(a.dtype) == str(t.dtype).replace("torch.", "")
        want = np.asarray(a.astype(jnp.float32)).view(np.uint32)
        assert np.array_equal(t.float().numpy().view(np.uint32), want)


@pytest.mark.parametrize("family", ["vlm"])
def test_other_families_are_not_ported_yet(tiny_cfg_base, family):
    """Every family is ported: a vlm runs the dense stack, and the encdec
    family, which ``nn/encdec.py`` runs, has no layer runs: both packages'
    ``layer_runs`` raise ``ValueError`` for it."""
    cfg = tbase.ModelConfig(name="x", family=family, **tiny_cfg_base)
    jcfg = jbase.ModelConfig(name="x", family=family, **tiny_cfg_base)
    assert ttf.layer_runs(cfg) == jtf.layer_runs(jcfg) == [
        ("attn", cfg.n_layers)]
    with pytest.raises(ValueError):
        jtf.layer_runs(jcfg.replace(family="encdec"))
    with pytest.raises(ValueError):
        ttf.layer_runs(cfg.replace(family="encdec"))


def test_kv_caches_need_a_device_without_cuda(tiny_cfg_base, monkeypatch):
    """``init_kv_caches`` follows the entry points' device rule: the CUDA
    device unless the caller names one, and no silent CPU fallback."""
    cfg = tbase.ModelConfig(name="d", family="dense", **tiny_cfg_base)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttf.init_kv_caches(cfg, 1, 8)
    caches = ttf.init_kv_caches(cfg, 1, 8, "cpu")
    assert caches[0]["k"].device == torch.device("cpu")
