"""The port's MoE, SSM and hybrid LM families (``nn/moe.py``, ``nn/ssm.py``,
the moe / mamba / shared_attn arms of ``nn/transformer.py``, their serving
and training) against the JAX reference on the same parameters, on the
CPU: each tree is made by the reference's own ``init`` and carried across
by ``interop.params_from_numpy``; inputs are drawn from numpy seeds.

Configs: the reduced phi3.5-moe (4 experts, top-2), arctic (the dense
residual FFN, heads padded to 16; Adafactor), mamba2 (SSD chunk 16) and
zamba2 (2 Mamba layers, then the shared attention block, twice).

Tolerances, fp32 (the same model in two frameworks: the matmuls, the
softmax and the scans sum in other orders): ``moe_block``'s output and the
SSD at atol = rtol = 1e-5, the Switch aux loss at 1e-6; the dropped
(token, choice) set exactly; logits at 1e-5; greedy tokens equal;
``lm_loss`` at 1e-5 and its gradients at atol = 1e-5, rtol = 1e-4; the
remat modes bitwise; one train step's loss and gradient norm at 1e-5, its
optimizer state at atol = 1e-5, rtol = 1e-4 and its parameters at an atol
of the step's learning rate (``tests/test_torch_train.py``'s reasons).
"""
import argparse
import dataclasses
import functools
import io
import json
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_reduced as j_get_reduced
from repro.nn import moe as jmoe
from repro.nn import ssm as jssm
from repro.nn import transformer as jtf
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.configs.registry import get_reduced as t_get_reduced
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.nn import moe as tmoe
from repro_torch.nn import encdec as ted
from repro_torch.nn import ssm as tssm
from repro_torch.nn import transformer as ttf
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch import tree

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_AUX = dict(atol=1e-6, rtol=1e-6)
TOL_GRAD = dict(atol=1e-5, rtol=1e-4)
PHI, ARCTIC, MAMBA, ZAMBA = ("phi3.5-moe-42b-a6.6b", "arctic-480b",
                             "mamba2-2.7b", "zamba2-1.2b")
FAMILIES = [PHI, ARCTIC, MAMBA, ZAMBA]
B, S, T0 = 2, 40, 32  # 8 decode steps; T0 is two SSD chunks of 16


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _t_cfg(name, **kw):
    cfg = t_get_reduced(name).replace(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        j_get_reduced(name).replace(**kw))
    return cfg


def _moe_cfgs(name, cf=None):
    j, t = j_get_reduced(name).moe, t_get_reduced(name).moe
    if cf is not None:
        j = dataclasses.replace(j, capacity_factor=cf)
        t = dataclasses.replace(t, capacity_factor=cf)
    return j, t


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# nn/moe.py
# ---------------------------------------------------------------------------

def _reference_keep(params, x, cfg_moe):
    """The reference's kept choices (``repro/nn/moe.py:62-87``), one group
    a sequence: ``[G, Tg * k]`` bool."""
    b, s, d = x.shape
    cap = jmoe._capacity(s, cfg_moe)
    probs = jax.nn.softmax(x.reshape(b, s, d) @ params["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, cfg_moe.top_k)
    e_flat = gate_idx.reshape(b, s * cfg_moe.top_k)
    onehot = jax.nn.one_hot(e_flat, cfg_moe.n_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    pos_in_e = jnp.take_along_axis(pos, e_flat[..., None], axis=2)[..., 0]
    return np.asarray(pos_in_e < cap)


@pytest.mark.parametrize("name,cf,drops", [
    (PHI, None, False),  # capacity 24 of 24 tokens: nothing dropped
    (ARCTIC, None, False),  # the dense residual FFN beside the experts
    (PHI, 0.5, True),  # capacity 8: about a third of the choices dropped
])
def test_moe_block_matches_reference(name, cf, drops):
    jm, tm = _moe_cfgs(name, cf)
    jp = jmoe.init_moe(jax.random.key(5), 64, jm, 2, "float32")
    tp = params_from_numpy(jp, "cpu")
    rng = np.random.default_rng(7)
    x = _normal(rng, (2, 24, 64))
    w = _normal(rng, (2, 24, 64))

    def jf(p, x):
        out, aux = jmoe.moe_block(p, x, jm)
        return (out * w).sum() + aux, (out, aux)

    (_, (want, want_aux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    flat = [t.requires_grad_() for t in tree.leaves(tp)]
    tpr = tree.unflatten(tp, flat)
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_block(tpr, tx, tm)
    _close(out, want)
    _close(aux, want_aux, TOL_AUX)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                [tx] + flat)
    _close(grads[0], jgx, TOL_GRAD)
    for a, b in zip(grads[1:], jax.tree.leaves(jgp)):
        _close(a, b, TOL_GRAD)

    cap = tmoe._capacity(24, tm)
    r = tmoe.route(tp["router"], torch.from_numpy(x), tm, cap)
    keep = _reference_keep(jp, jnp.asarray(x), jm)
    assert np.array_equal(r.keep.numpy(), keep)
    assert (~keep).any() == drops
    # the inverse map: each kept choice's slot names it back, once
    kept = np.flatnonzero(keep[0])
    assert np.array_equal(r.src[0].numpy()[r.slot[0].numpy()[kept]], kept)
    assert int((r.src < 24 * tm.top_k).sum()) == int(keep.sum())


def test_moe_decode_group_of_one_token():
    """The decode step's routing: a group a sequence of one token, ``cap =
    8``, against the reference."""
    jm, tm = _moe_cfgs(PHI)
    jp = jmoe.init_moe(jax.random.key(6), 64, jm, 2, "float32")
    x = _normal(np.random.default_rng(8), (3, 1, 64))
    assert tmoe._capacity(1, tm) == jmoe._capacity(1, jm) == 8
    want, want_aux = jmoe.moe_block(jp, jnp.asarray(x), jm)
    got, aux = tmoe.moe_block(params_from_numpy(jp, "cpu"),
                              torch.from_numpy(x), tm)
    _close(got, want)
    _close(aux, want_aux, TOL_AUX)


@pytest.mark.parametrize("t,e,k,cf", [(8, 4, 2, 1.25), (24, 4, 2, 0.5),
                                      (2048, 16, 2, 1.25), (100, 128, 2, 1.0),
                                      (64, 2, 1, 0.01)])
def test_capacity_equals_reference(t, e, k, cf):
    jm = jmoe.MoEConfig(n_experts=e, top_k=k, d_ff_expert=8,
                        capacity_factor=cf)
    tm = tbase.MoEConfig(n_experts=e, top_k=k, d_ff_expert=8,
                         capacity_factor=cf)
    assert tmoe._capacity(t, tm) == jmoe._capacity(t, jm)


# ---------------------------------------------------------------------------
# nn/ssm.py
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b, s, nh, hd, n, dt_scale=0.5):
    """``tests/test_ssm.py``'s distributions."""
    rng = np.random.default_rng(seed)
    x = _normal(rng, (b, s, nh, hd), 0.5)
    dt = (rng.random((b, s, nh)) * dt_scale + 0.01).astype(np.float32)
    a = -(rng.random(nh) * 2 + 0.1).astype(np.float32)
    bp = _normal(rng, (b, s, n), 0.3)
    cp = _normal(rng, (b, s, n), 0.3)
    return x, dt, a, bp, cp


@pytest.mark.parametrize("s,chunk,init", [(48, 16, False), (64, 16, True),
                                          (32, 8, False), (12, 16, False)])
def test_ssd_chunked_matches_reference_and_sequential(s, chunk, init):
    x, dt, a, bp, cp = _ssd_inputs(s + chunk, 2, s, 3, 8, 12)
    st = (_normal(np.random.default_rng(1), (2, 3, 8, 12), 0.3) if init
          else None)
    jin = [jnp.asarray(v) for v in (x, dt, a, bp, cp)]
    tin = [torch.from_numpy(v) for v in (x, dt, a, bp, cp)]
    wy, ws = jssm.ssd_chunked(*jin, chunk, None if st is None
                              else jnp.asarray(st))
    y, state = tssm.ssd_chunked(*tin, chunk, None if st is None
                                else torch.from_numpy(st))
    _close(y, wy)
    _close(state, ws)
    sy, ss = tssm.ssd_sequential(*tin, None if st is None
                                 else torch.from_numpy(st))
    wsy, wss = jssm.ssd_sequential(*jin, None if st is None
                                   else jnp.asarray(st))
    _close(sy, wsy)
    _close(ss, wss)
    # the chunked form equals the per-step oracle (tests/test_ssm.py's 2e-4)
    np.testing.assert_allclose(_np(y), _np(sy), rtol=2e-4, atol=2e-4)


def test_ssd_refuses_a_length_past_the_chunk_not_a_multiple():
    """``S % L`` must be 0 once ``S > chunk``, in both packages: no silent
    padding."""
    x, dt, a, bp, cp = _ssd_inputs(3, 1, 40, 2, 4, 4)
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bp, cp)), 16)
    with pytest.raises(AssertionError):
        tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bp, cp)), 16)


def test_ssd_gradient_finite_where_the_masked_decay_overflows():
    """With ``dt * |a|`` large the masked exponents ``cum_t - cum_s`` (t <
    s) pass 88, where ``exp`` overflows to inf in fp32.  The forward keeps
    the per-step oracle's values, and the gradients stay finite and equal
    the oracle's (the reference's ``where`` after the ``exp`` alone would
    give ``inf * 0 = nan`` there)."""
    x, dt, a, bp, cp = _ssd_inputs(4, 1, 32, 2, 4, 4)
    dt = dt * 0 + 4.0
    a = a * 0 - 2.0  # 8 a step: 16 steps reach 128
    ins = [torch.from_numpy(v).requires_grad_() for v in (x, dt, a, bp, cp)]
    w = torch.from_numpy(_normal(np.random.default_rng(9), (1, 32, 2, 4)))
    y, _ = tssm.ssd_chunked(*ins, 16)
    got = torch.autograd.grad((y * w).sum(), ins)
    ys, _ = tssm.ssd_sequential(*ins)
    want = torch.autograd.grad((ys * w).sum(), ins)
    np.testing.assert_allclose(_np(y), _np(ys), rtol=2e-4, atol=2e-4)
    for g, gw in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(_np(g), _np(gw), rtol=1e-3, atol=1e-3)


def test_mamba2_block_prefill_then_decode_matches_reference():
    """zamba2 reduced: prefill 32 tokens (two chunks) with ``return_state``,
    then 6 decode steps from that cache, against the reference's."""
    cfg = _t_cfg(ZAMBA)
    jcfg = j_get_reduced(ZAMBA)
    jp = jssm.init_mamba2(jax.random.key(2), 64, jcfg.ssm, 2, "float32")
    tp = params_from_numpy(jp, "cpu")
    x = _normal(np.random.default_rng(3), (2, 38, 64), 0.5)
    want, wc = jax.jit(lambda p, x: jssm.mamba2_block(
        p, jcfg, x, return_state=True))(jp, jnp.asarray(x[:, :32]))
    got, c = tssm.mamba2_block(tp, cfg, torch.from_numpy(x[:, :32]),
                               return_state=True)
    _close(got, want)
    for a, b in zip(c, wc):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)
    step = jax.jit(lambda p, x, c: jssm.mamba2_block(p, jcfg, x, cache=c))
    for t in range(32, 38):
        want, wc = step(jp, jnp.asarray(x[:, t:t + 1]), wc)
        got, c = tssm.mamba2_block(tp, cfg, torch.from_numpy(x[:, t:t + 1]),
                                   cache=c)
        _close(got, want)
    for a, b in zip(c, wc):
        _close(a, b)
    # the cache skeleton: the reference's shapes and dtypes
    for a, b in zip(tssm.init_mamba_cache(cfg, 2, torch.float32, "cpu"),
                    jssm.init_mamba_cache(jcfg, 2, jnp.float32)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        assert not a.any()


# ---------------------------------------------------------------------------
# nn/transformer.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(J_ARCHS))
@pytest.mark.parametrize("reduced", [False, True])
def test_layer_runs_equal_the_reference(name, reduced):
    j = j_get_reduced(name) if reduced else j_get_config(name)
    t = t_get_reduced(name) if reduced else t_get_config(name)
    try:
        want = jtf.layer_runs(j)
    except ValueError:  # encdec: the reference's raise
        with pytest.raises(ValueError):
            ttf.layer_runs(t)
        return
    assert ttf.layer_runs(t) == want


@pytest.mark.parametrize("n_layers,period", [(38, 19), (2, 2), (5, 2),
                                             (4, 3), (3, 0), (7, 7), (1, 5),
                                             (6, 2)])
def test_hybrid_layer_runs_equal_the_reference(n_layers, period):
    kw = dict(n_layers=n_layers, shared_attn_period=period)
    assert (ttf.layer_runs(t_get_config(ZAMBA).replace(**kw))
            == jtf.layer_runs(j_get_config(ZAMBA).replace(**kw)))


@pytest.mark.parametrize("name", FAMILIES)
def test_init_lm_params_mirrors_the_reference_tree(name):
    """Same tree (the shared block once, ``{}`` at each application),
    shapes and dtypes as the reference's ``init_lm_params``, the
    reference's constants, drawn on the generator's device."""
    jcfg, tcfg = j_get_reduced(name), _t_cfg(name)
    jp = jtf.init_lm_params(jax.random.key(0), jcfg)
    tp = ttf.init_lm_params(torch.Generator().manual_seed(0), tcfg)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == \
        [jax.tree_util.keystr(k) for k, _ in tflat]
    for (path, a), (_, t) in zip(jflat, tflat):
        assert tuple(a.shape) == tuple(t.shape)
        assert str(a.dtype) == str(t.dtype).replace("torch.", "")
        key = jax.tree_util.keystr(path)
        if any(c in key for c in ("conv_B", "conv_C", "A_log", "'D'",
                                  "dt_bias", "norm_g", "conv_bias")):
            _close(t, a, TOL)  # constants, not draws
    assert ttf.param_count(tp) == jtf.param_count(jp)
    assert len(tp["runs"]) == len(jtf.layer_runs(jcfg))
    if tcfg.family == "hybrid":
        assert "shared" in tp and all(
            r == {} for r, (k, _) in zip(tp["runs"], ttf.layer_runs(tcfg))
            if k == "shared_attn")


@functools.lru_cache(maxsize=None)
def _reference_run(name):
    """The JAX model's parameters, tokens and every output compared."""
    cfg = j_get_reduced(name)
    params = jtf.init_lm_params(jax.random.key(0), cfg)
    tokens = np.random.default_rng(len(name)).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    logits, aux = jax.jit(lambda p, t: jtf.lm_forward(p, cfg, t))(
        params, jnp.asarray(tokens[:, :T0]))
    lg, pf = jax.jit(lambda p, t: jtf.lm_prefill(p, cfg, t))(
        params, jnp.asarray(tokens[:, :T0]))
    caches = jtf.graft_prefill_caches(cfg, jtf.init_kv_caches(cfg, B, S),
                                      pf, T0)
    out = {"params": params, "tokens": tokens, "forward": _np(logits),
           "aux": float(aux), "prefill": _np(lg),
           "prefill_caches": jax.tree.map(_np, pf), "decode": []}
    step = jax.jit(lambda p, t, c, pos: jtf.lm_decode_step(p, cfg, t, c, pos))
    for t in range(T0, S):
        lg, caches = step(params, jnp.asarray(tokens[:, t:t + 1]), caches,
                          jnp.int32(t))
        out["decode"].append(_np(lg))
    out["decode_caches"] = jax.tree.map(_np, caches)
    return out


def _close_caches(got, want):
    """Run caches: a ``{"k", "v"}`` dict or a ``MambaCache`` each."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        gl, wl = tree.leaves(g), jax.tree.leaves(w)
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            assert tuple(a.shape) == tuple(b.shape)
            _close(a, b)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_prefill_graft_decode_match_reference(name, use_pallas):
    ref = _reference_run(name)
    cfg = _t_cfg(name, use_pallas=use_pallas)
    params = params_from_numpy(ref["params"], "cpu")
    tokens = torch.from_numpy(ref["tokens"])
    with torch.inference_mode():
        logits, aux = ttf.lm_forward(params, cfg, tokens[:, :T0])
        _close(logits, ref["forward"])
        _close(aux, ref["aux"], TOL_AUX)
        assert (float(aux) > 0) == (cfg.family == "moe")
        lg, pf = ttf.lm_prefill(params, cfg, tokens[:, :T0])
        _close(lg, ref["prefill"])
        _close_caches(pf, ref["prefill_caches"])
        caches = ttf.graft_prefill_caches(
            cfg, ttf.init_kv_caches(cfg, B, S, "cpu"), pf, T0)
        for i, t in enumerate(range(T0, S)):
            lg, caches = ttf.lm_decode_step(params, cfg, tokens[:, t:t + 1],
                                            caches, t)
            _close(lg, ref["decode"][i])
        _close_caches(caches, ref["decode_caches"])


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("name", FAMILIES)
def test_greedy_tokens_equal_the_reference_engine(name):
    """Ragged prompts in one wave, left-padded with token 0 to one SSD
    chunk (attended, and run through the Mamba layers, as the reference
    does)."""
    ref = _reference_run(name)
    jcfg, cfg = j_get_reduced(name), _t_cfg(name)
    prompts = _prompts(11, [5, 16, 9], cfg.vocab)
    want = JEngine(jcfg, ref["params"], batch_slots=3, max_len=28).generate(
        [JRequest(prompt=p, max_tokens=8) for p in prompts])
    engine = ServeEngine(cfg, params_from_numpy(ref["params"], "cpu"),
                         batch_slots=3, max_len=28)
    got = engine.generate([Request(prompt=p, max_tokens=8) for p in prompts])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(len(r.out_tokens) == 8 for r in got)
    assert engine.timings[0]["decode_steps"] == 7


# ---------------------------------------------------------------------------
# training: lm_loss, its gradients, one train step
# ---------------------------------------------------------------------------

def _batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    labels[0, :5] = -1
    return {"tokens": toks, "labels": labels}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", FAMILIES)
def test_lm_loss_and_grads_match_jax(name):
    """``lm_loss`` (the MoE aux loss in ``+ 0.01 * aux``) and every
    parameter's gradient against ``jax.grad``; the remat modes bitwise."""
    jcfg = j_get_reduced(name)
    params = jtf.init_lm_params(jax.random.key(1), jcfg)
    batch = _batch(jcfg.vocab, 2, 32, seed=len(name))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jtf.lm_loss(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})))(params)
    runs = {}
    for remat in ("none", "full", "dots"):
        cfg = _t_cfg(name, remat=remat)
        runs[remat] = tts.value_and_grad(
            lambda p, batch, cfg=cfg: ttf.lm_loss(p, cfg, batch),
            params_from_numpy(params, "cpu"), _t(batch))
    loss, grads = runs["none"]
    _close(loss, jl)
    assert len(tree.leaves(grads)) == len(jax.tree.leaves(jg))
    for a, b in zip(tree.leaves(grads), jax.tree.leaves(jg)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, TOL_GRAD)
    for remat in ("full", "dots"):
        l2, g2 = runs[remat]
        assert torch.equal(l2, loss), remat
        assert all(torch.equal(a, b) for a, b in
                   zip(tree.leaves(g2), tree.leaves(grads))), remat


# backward nodes that add into their destination, with float atomics on
# the card where the destinations repeat
_ADDING = ("IndexSelectBackward", "IndexBackward", "IndexPutBackward",
           "EmbeddingBackward", "IndexAddBackward", "ScatterAddBackward",
           "GatherBackward")


@pytest.mark.parametrize("name", [PHI, ZAMBA])
def test_no_adding_backward_but_the_ce_gold_gather(name):
    """Every node of ``lm_loss``'s graph whose backward adds into repeated
    destinations (a float atomic on the card) is absent, but one: the
    cross-entropy's gold-logit gather, whose index has one entry a row
    (``[..., 1]`` along the vocabulary), so its backward's destinations are
    unique.  The MoE dispatch and combine and the embedding are custom
    backward gathers (``_RowGather``, ``_EmbedGather``)."""
    cfg = _t_cfg(name, remat="none")
    params = ttf.init_lm_params(torch.Generator().manual_seed(0), cfg)
    flat = [p.requires_grad_() for p in tree.leaves(params)]
    loss = ttf.lm_loss(tree.unflatten(params, flat), cfg,
                       _t(_batch(cfg.vocab, 2, 32, seed=3)))
    seen, stack, names, gathers = set(), [loss.grad_fn], set(), []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        if type(node).__name__.startswith("GatherBackward"):
            gathers.append(node)
        stack.extend(f for f, _ in node.next_functions)
    assert "_RowGatherBackward" in names or cfg.family != "moe"
    assert "_EmbedGatherBackward" in names
    bad = [n for n in names if n.startswith(_ADDING)
           and not n.startswith("GatherBackward")]
    assert not bad, bad
    assert gathers  # the CE's, one a chunk
    for node in gathers:
        idx, dim = node._saved_index, node._saved_dim
        dim = dim - 2 ** 64 if dim >= 2 ** 63 else dim  # stored unsigned
        assert dim % idx.dim() == idx.dim() - 1 and idx.shape[-1] == 1


@pytest.mark.parametrize("name", [PHI, ARCTIC, ZAMBA])
def test_train_step_from_the_reference_state(name):
    """One train step from ``interop.state_from_numpy`` of the reference's
    step-0 state (arctic: Adafactor; the others AdamW), on one batch;
    zamba2's Mamba layers stand for mamba2's."""
    jcfg, tcfg = j_get_reduced(name), _t_cfg(name)
    jo = jopt.build_optimizer(jcfg, total_steps=10)
    to = topt.build_optimizer(tcfg, total_steps=10)
    jstate = jts.init_train_state(jax.random.key(0), jcfg, jo)
    tstate = state_from_numpy(jstate, "cpu")
    batch = _batch(jcfg.vocab, 4, 16, seed=40)
    jstate, jm = jax.jit(jts.make_train_step(jcfg, jo))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = tts.make_train_step(tcfg, to)(tstate, _t(batch))
    _close(tm["loss"], jm["loss"])
    _close(tm["grad_norm"], jm["grad_norm"])
    assert int(tstate.step) == int(jstate.step) == 1
    for a, b in zip(tree.leaves(tstate.opt), jax.tree.leaves(jstate.opt)):
        _close(a, b, TOL_GRAD)
    lr = float(topt.lr_schedule(10)(0))
    for a, b in zip(tree.leaves(tstate.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(_np(a), _np(b), atol=lr, rtol=0)


def test_loss_fn_for_raises_only_for_encdec():
    """Every family has a loss now: ``lm_loss`` for the decoder-only
    ones, ``encdec_loss`` for seamless (``tests/test_torch_lm_vlm_encdec.py``
    holds it against the reference)."""
    for name in sorted(J_ARCHS):
        fn = tts.loss_fn_for(t_get_reduced(name))
        want = (ted.encdec_loss if t_get_reduced(name).family == "encdec"
                else ttf.lm_loss)
        assert fn.func is want, name


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [PHI, MAMBA, ZAMBA])
def test_serve_cli_reduced_on_cpu(capsys, name):
    tserve.run_lm(argparse.Namespace(
        arch=name, reduced=True, requests=3, prompt_len=16, max_tokens=4,
        temperature=0.0, slots=2, use_pallas=True, device="cpu"))
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in out[:3]] == ["req0", "req1", "req2"]
    assert all(len(json.loads(ln.split(": ", 1)[1])) == 4 for ln in out[:3])
    assert out[3].startswith("12 tokens in ")


@pytest.mark.parametrize("name", [PHI, MAMBA, ZAMBA])
def test_train_cli_reduced_on_cpu(monkeypatch, name):
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", name, "--reduced", "--device", "cpu", "--steps",
        "2", "--seq-len", "32", "--batch", "2"])
    out = io.StringIO()
    with redirect_stdout(out):
        tlaunch.main()
    lines = out.getvalue().splitlines()
    assert lines[0] == "device: cpu (host CPU)"
    steps = [ln.split() for ln in lines[1:]]
    assert [int(s[1]) for s in steps] == [0, 1]
    losses = [float(s[3]) for s in steps]
    assert all(np.isfinite(losses)) and abs(losses[0] - np.log(512)) < 1.0
