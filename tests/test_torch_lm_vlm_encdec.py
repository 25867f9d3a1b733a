"""The port's VLM and encoder-decoder families (``extra_embeds`` in
``nn/transformer.py``, ``nn/encdec.py``, the cross-attention path of
``nn/attention.py`` and the ``flash_attention`` kernel's cross form)
against the JAX reference on the same parameters, on the CPU: each tree is
made by the reference's own ``init`` and carried across by
``interop.params_from_numpy``; inputs are drawn from numpy seeds.

Configs: the reduced internvl2-76b (2 layers, d_model 64, 8 frontend
embeddings) and seamless-m4t-medium (2 + 2 layers, d_model 64, 4 heads of
16, ``attn_chunk`` 64).

Tolerances, fp32 (the same model in two frameworks: the matmuls and the
softmax sum in other orders; ``ROADMAP.md`` invariant 2): attention
blocks, logits and losses at atol = rtol = 1e-5; gradients at atol =
1e-5, rtol = 1e-4; a decode after a prefill against the full forward at
1e-4 (the one-token step sums each product in another order than the
full-sequence matmul); greedy tokens equal; remat modes bitwise; one train
step's optimizer state at atol = 1e-5, rtol = 1e-4 and its parameters at
an atol of the step's learning rate (``tests/test_torch_train.py``'s
reasons).  The kernel's cross form: its emulation against the plain
version at 2e-4 in fp32 and 2e-2 in bf16 (``tests/test_torch_flash_
attention.py``'s reasons).
"""
import argparse
import dataclasses
import functools
import io
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as j_get_reduced
from repro.kernels import ref as jref
from repro.nn import attention as jattn
from repro.nn import encdec as jed
from repro.nn import transformer as jtf
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import tree
from repro_torch.configs.registry import get_reduced as t_get_reduced
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.nn import attention as tattn
from repro_torch.nn import encdec as ted
from repro_torch.nn import transformer as ttf
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_GRAD = dict(atol=1e-5, rtol=1e-4)
TOL_STEP = dict(atol=1e-4, rtol=1e-4)
TOL_KERNEL = {"float32": dict(atol=2e-4, rtol=2e-4),
              "bfloat16": dict(atol=2e-2, rtol=2e-2)}
VLM, ENCDEC = "internvl2-76b", "seamless-m4t-medium"


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


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tt(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jt(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the cross-attention path: attention_block(kv_override, use_rope=False)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("sq,sk", [(24, 16), (16, 24), (64, 1100),
                                   (1100, 64)])
def test_cross_attention_block_matches_reference(sq, sk, use_pallas):
    """Rope-free queries over the encoder's keys: the plain arm (the
    reference's ``_plain_cross``) below 1024 on both sides, the chunked
    arm above (``chunk_k`` from ``Sk``); under ``use_pallas`` the CPU
    takes the kernel's plain version.  The
    reference's CPU arm is the oracle (its Pallas kernel has one length,
    ROADMAP Queue 3 check (i))."""
    jcfg = j_get_reduced(ENCDEC)
    cfg = _t_cfg(ENCDEC, use_pallas=use_pallas)
    jp = jattn.init_attention(jax.random.key(3), jcfg)
    rng = np.random.default_rng(sq * 7 + sk)
    x = _normal(rng, (2, sq, 64))
    k = _normal(rng, (2, sk, 4, 16))
    v = _normal(rng, (2, sk, 4, 16))
    want = jattn.attention_block(
        jp, jcfg, jnp.asarray(x), jnp.arange(sq), causal=False,
        kv_override=(jnp.asarray(k), jnp.asarray(v)), use_rope=False)
    with torch.inference_mode():
        got = tattn.attention_block(
            params_from_numpy(jp, "cpu"), cfg, torch.from_numpy(x),
            torch.arange(sq), causal=False,
            kv_override=(torch.from_numpy(k), torch.from_numpy(v)),
            use_rope=False)
    _close(got, want)


def test_attention_block_rope_free_only_on_the_cross_path():
    """``use_rope=False`` belongs to the cross path; the self-attention
    path refuses it, where no caller of either package asks for it."""
    cfg = _t_cfg(ENCDEC)
    params = params_from_numpy(
        jattn.init_attention(jax.random.key(3), j_get_reduced(ENCDEC)),
        "cpu")
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="cross path"):
        tattn.attention_block(params, cfg, x, torch.arange(4),
                              use_rope=False)


def test_plain_cross_matches_reference():
    """The port's plain arm of the cross form is ``ref.mha_attention``
    with neither mask: the reference's ``_plain_cross``."""
    rng = np.random.default_rng(4)
    q, k, v = (_normal(rng, (2, 20, 6, 16)), _normal(rng, (2, 33, 3, 16)),
               _normal(rng, (2, 33, 3, 16)))
    want = jattn._plain_cross(*map(jnp.asarray, (q, k, v)))
    _close(ref.mha_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=False), want)
    with pytest.raises(ValueError, match="causal=False"):
        ref.mha_attention(*map(torch.from_numpy, (q, k, v)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(70, 1), (70, 63), (70, 64), (130, 65),
                                   (64, 1000), (1000, 64)])
def test_cross_form_emulation_matches_plain(sq, sk, dtype):
    """The kernels' tile loop over ``Sk`` keys (``kv_tiles`` to ``Sk``,
    the tail masked) against the plain version and, in fp32, the
    reference's ``_plain_cross``; ``work`` counts ``Sq x Sk`` pairs."""
    rng = np.random.default_rng(sq + 3 * sk)
    arrs = [_normal(rng, shape, 0.5) for shape in
            ((1, sq, 4, 16), (1, sk, 2, 16), (1, sk, 2, 16))]
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    emu = tflash.flash_attention_emulate(q, k, v, causal=False)
    plain = ref.mha_attention(q, k, v, causal=False)
    assert emu.dtype == plain.dtype == q.dtype and emu.shape == q.shape
    assert torch.isfinite(emu).all()
    _close(emu, plain, TOL_KERNEL[dtype])
    if dtype == "float32":
        _close(emu, jattn._plain_cross(*map(jnp.asarray, arrs)),
               TOL_KERNEL[dtype])
    assert list(tflash.kv_tiles(0, sk, False, 0)) == list(
        range(-(-sk // tflash.BLOCK_K)))
    n_bytes, n_ops = tflash.work(q, k, causal=False)
    assert n_ops == 4 * 4 * 16 * sq * sk
    assert n_bytes == (2 * q.numel() + 2 * k.numel()) * q.element_size()
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(ops.flash_attention(q, k, v, causal=False,
                                           use_pallas=True), plain)


def test_cross_form_needs_neither_causal_nor_window():
    q = torch.zeros((1, 8, 2, 16))
    k = torch.zeros((1, 12, 2, 16))
    tflash.check_kernel_args(q, k, k, causal=False)
    with pytest.raises(ValueError, match="cross form"):
        tflash.check_kernel_args(q, k, k)  # causal by default
    with pytest.raises(ValueError, match="cross form"):
        tflash.check_kernel_args(q, k, k, window=4, causal=False)
    with pytest.raises(ValueError, match="do not match"):
        tflash.check_kernel_args(q, k[..., :8], k[..., :8], causal=False)
    with pytest.raises(ValueError, match="causal=False"):
        ref.mha_attention(q, k, k, causal=False, window=4)


# ---------------------------------------------------------------------------
# the VLM family: extra_embeds
# ---------------------------------------------------------------------------

B, S, T0 = 2, 24, 16  # VLM: 8 decode steps after a 16-token prefill


@functools.lru_cache(maxsize=None)
def _vlm_reference():
    cfg = j_get_reduced(VLM)
    params = jtf.init_lm_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(29)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extra = _normal(rng, (B, cfg.n_frontend_embeds, cfg.d_model), 0.1)
    je = jnp.asarray(extra)
    logits, _ = jax.jit(lambda p, t: jtf.lm_forward(
        p, cfg, t, extra_embeds=je))(params, jnp.asarray(tokens))
    lg, pf = jax.jit(lambda p, t: jtf.lm_prefill(
        p, cfg, t, extra_embeds=je))(params, jnp.asarray(tokens[:, :T0]))
    e = cfg.n_frontend_embeds
    caches = jtf.graft_prefill_caches(
        cfg, jtf.init_kv_caches(cfg, B, e + S), pf, e + T0)
    out = {"params": params, "tokens": tokens, "extra": extra,
           "forward": _np(logits), "prefill": _np(lg),
           "prefill_k": _np(pf[0]["k"]), "decode": []}
    step = jax.jit(lambda p, t, c, pos: jtf.lm_decode_step(p, cfg, t, c, pos))
    for t in range(T0, S):
        lg, caches = step(params, jnp.asarray(tokens[:, t:t + 1]), caches,
                          jnp.int32(e + t))
        out["decode"].append(_np(lg))
    return out


@pytest.mark.parametrize("use_pallas", [False, True])
def test_vlm_forward_prefill_decode_match_reference(use_pallas):
    """``lm_forward`` and ``lm_prefill`` with the embeddings prepended, and
    a decode after the VLM prefill at positions ``E + t``: against the
    reference, and against the port's own forward at every position."""
    ref_ = _vlm_reference()
    cfg = _t_cfg(VLM, use_pallas=use_pallas)
    e = cfg.n_frontend_embeds
    params = params_from_numpy(ref_["params"], "cpu")
    tokens = torch.from_numpy(ref_["tokens"])
    extra = torch.from_numpy(ref_["extra"])
    with torch.inference_mode():
        logits, aux = ttf.lm_forward(params, cfg, tokens, extra_embeds=extra)
        assert logits.shape == (B, S, cfg.vocab) and float(aux) == 0.0
        _close(logits, ref_["forward"])
        lg, pf = ttf.lm_prefill(params, cfg, tokens[:, :T0],
                                extra_embeds=extra)
        _close(lg, ref_["prefill"])
        assert pf[0]["k"].shape[2] == e + T0
        _close(pf[0]["k"], ref_["prefill_k"])
        _close(lg[:, 0], logits[:, T0 - 1], TOL_STEP)
        caches = ttf.graft_prefill_caches(
            cfg, ttf.init_kv_caches(cfg, B, e + S, "cpu"), pf, e + T0)
        for i, t in enumerate(range(T0, S)):
            lg, caches = ttf.lm_decode_step(params, cfg, tokens[:, t:t + 1],
                                            caches, e + t)
            _close(lg, ref_["decode"][i])
            if t + 1 < S:
                _close(lg[:, 0], logits[:, t], TOL_STEP)
        # the embeddings reach the text logits
        moved, _ = ttf.lm_forward(params, cfg, tokens, extra_embeds=extra * 2)
        assert float((moved - logits).abs().max()) > 1e-3


def _vlm_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    return {"tokens": toks, "labels": labels,
            "extra_embeds": _normal(rng, (2, cfg.n_frontend_embeds,
                                          cfg.d_model), 0.1)}


def _grads_match(name, loss_t, loss_j, init_j, batch):
    """``loss_t`` and every gradient against ``jax.value_and_grad`` of
    ``loss_j`` on the reference's parameters, the remat modes bitwise."""
    jcfg = j_get_reduced(name)
    params = init_j(jax.random.key(1), jcfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: loss_j(p, jcfg, _jt(batch))))(params)
    runs = {}
    for remat in ("none", "full", "dots"):
        cfg = _t_cfg(name, remat=remat)
        runs[remat] = tts.value_and_grad(
            lambda p, batch, cfg=cfg: loss_t(p, cfg, batch),
            params_from_numpy(params, "cpu"), _tt(batch))
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


def test_vlm_loss_and_grads_match_jax():
    """``lm_loss`` with ``extra_embeds`` (the frontend positions carry no
    label) and every gradient against ``jax.grad``."""
    _grads_match(VLM, ttf.lm_loss, jtf.lm_loss, jtf.init_lm_params,
                 _vlm_batch(t_get_reduced(VLM), seed=5))


# ---------------------------------------------------------------------------
# the encoder-decoder family: nn/encdec.py
# ---------------------------------------------------------------------------

def test_init_encdec_params_mirrors_the_reference_tree():
    jcfg, tcfg = j_get_reduced(ENCDEC), _t_cfg(ENCDEC)
    jp = jed.init_encdec_params(jax.random.key(0), jcfg)
    tp = ted.init_encdec_params(torch.Generator().manual_seed(0), tcfg)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == \
        [jax.tree_util.keystr(k) for k, _ in tflat]
    for (_, a), (_, t) in zip(jflat, tflat):
        assert tuple(a.shape) == tuple(t.shape)
        assert str(a.dtype) == str(t.dtype).replace("torch.", "")
    assert ttf.param_count(tp) == jtf.param_count(jp)
    for name in ("ln_enc", "ln_f"):
        assert torch.equal(tp[name], torch.ones(tcfg.d_model))
    # the reference's scales: embed 0.02, lm_head 1/sqrt(d)
    assert abs(float(tp["embed"].std()) - 0.02) < 2e-3
    assert abs(float(tp["lm_head"].std()) - tcfg.d_model ** -0.5) < 1e-2


SS, ST, ET0 = 16, 24, 16  # tests/test_transformer.py::test_encdec_roundtrip


@functools.lru_cache(maxsize=None)
def _encdec_reference():
    cfg = j_get_reduced(ENCDEC)
    params = jed.init_encdec_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(31)
    frames = _normal(rng, (2, SS, cfg.d_model), 0.3)
    tokens = rng.integers(0, cfg.vocab, (2, ST)).astype(np.int32)
    jf, jt = jnp.asarray(frames), jnp.asarray(tokens)
    out = {"params": params, "frames": frames, "tokens": tokens,
           "encode": _np(jed.encode(params, cfg, jf)),
           "forward": _np(jed.encdec_forward(params, cfg, jf, jt))}
    lg, caches = jed.encdec_prefill(params, cfg, jf, jt[:, :ET0])
    out["prefill"] = _np(lg)
    out["prefill_caches"] = {k: _np(c) for k, c in caches.items()}
    full = jed.init_encdec_caches(cfg, 2, 32, SS)
    caches = {k: jax.lax.dynamic_update_slice(
        full[k], caches[k].astype(full[k].dtype), (0,) * full[k].ndim)
        for k in full}
    out["decode"] = []
    for t in range(ET0, ST):
        lg, caches = jed.encdec_decode_step(params, cfg, jt[:, t:t + 1],
                                            caches, jnp.int32(t))
        out["decode"].append(_np(lg))
    out["decode_self_k"] = _np(caches["self_k"])
    return out


def test_graft_encdec_caches_matches_the_reference_update():
    """The prefill's caches in zeroed decode caches of 32 target rows, as
    the reference's ``init_encdec_caches`` + ``dynamic_update_slice``
    make them: bitwise."""
    r = _encdec_reference()
    pf = r["prefill_caches"]
    full = jed.init_encdec_caches(j_get_reduced(ENCDEC), 2, 32, SS)
    got = ted.graft_encdec_caches(
        _t_cfg(ENCDEC),
        {k: torch.from_numpy(np.array(c)) for k, c in pf.items()}, 32)
    assert sorted(got) == sorted(full)
    for k, f in full.items():
        want = jax.lax.dynamic_update_slice(
            f, jnp.asarray(pf[k]).astype(f.dtype), (0,) * f.ndim)
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_encdec_forward_prefill_decode_match_reference(use_pallas):
    """``encode``, ``encdec_forward``, ``encdec_prefill`` (its logits and
    four caches) and decode steps at the reference test's shapes, and each
    step against the port's own forward."""
    r = _encdec_reference()
    cfg = _t_cfg(ENCDEC, use_pallas=use_pallas)
    params = params_from_numpy(r["params"], "cpu")
    frames, tokens = torch.from_numpy(r["frames"]), torch.from_numpy(
        r["tokens"])
    with torch.inference_mode():
        _close(ted.encode(params, cfg, frames), r["encode"])
        logits = ted.encdec_forward(params, cfg, frames, tokens)
        assert logits.shape == (2, ST, cfg.vocab)
        _close(logits, r["forward"])
        lg, caches = ted.encdec_prefill(params, cfg, frames, tokens[:, :ET0])
        _close(lg, r["prefill"])
        _close(lg[:, 0], logits[:, ET0 - 1], TOL_STEP)
        assert sorted(caches) == sorted(r["prefill_caches"])
        for name, c in caches.items():
            assert tuple(c.shape) == r["prefill_caches"][name].shape
            _close(c, r["prefill_caches"][name])
        caches = ted.graft_encdec_caches(cfg, caches, 32)
        for i, t in enumerate(range(ET0, ST)):
            lg, caches = ted.encdec_decode_step(params, cfg,
                                                tokens[:, t:t + 1], caches, t)
            _close(lg, r["decode"][i])
            _close(lg[:, 0], logits[:, t], TOL_STEP)
        _close(caches["self_k"], r["decode_self_k"])


def test_encdec_greedy_tokens_equal_the_reference_loop():
    """``examples/serve_decode.py``'s enc-dec loop (2 clips of 24 frames,
    a BOS, 9 greedy steps, caches of 16) on both packages."""
    jcfg, cfg = j_get_reduced(ENCDEC), _t_cfg(ENCDEC)
    jp = jed.init_encdec_params(jax.random.key(1), jcfg)
    rng = np.random.default_rng(1)
    frames = (rng.standard_normal((2, 24, jcfg.d_model)) * 0.3).astype(
        np.float32)
    bos = np.zeros((2, 1), np.int32)

    def loop_jax():
        logits, caches = jed.encdec_prefill(jp, jcfg, jnp.asarray(frames),
                                            jnp.asarray(bos))
        full = jed.init_encdec_caches(jcfg, 2, 16, 24)
        caches = {k: jax.lax.dynamic_update_slice(
            full[k], caches[k].astype(full[k].dtype), (0,) * full[k].ndim)
            for k in full}
        tok = jnp.argmax(logits[:, 0], -1)[:, None].astype(jnp.int32)
        outs = [tok]
        step = jax.jit(lambda p, t, c, pos: jed.encdec_decode_step(
            p, jcfg, t, c, pos))
        for t in range(1, 10):
            logits, caches = step(jp, tok, caches, jnp.int32(t))
            tok = jnp.argmax(logits[:, 0], -1)[:, None].astype(jnp.int32)
            outs.append(tok)
        return np.asarray(jnp.concatenate(outs, 1))

    params = params_from_numpy(jp, "cpu")
    with torch.inference_mode():
        logits, caches = ted.encdec_prefill(params, cfg,
                                            torch.from_numpy(frames),
                                            torch.from_numpy(bos))
        caches = ted.graft_encdec_caches(cfg, caches, 16)
        tok = logits[:, 0].argmax(-1)[:, None]
        outs = [tok]
        for t in range(1, 10):
            logits, caches = ted.encdec_decode_step(params, cfg, tok, caches,
                                                    t)
            tok = logits[:, 0].argmax(-1)[:, None]
            outs.append(tok)
    assert torch.cat(outs, 1).tolist() == loop_jax().tolist()


def _encdec_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    labels[0, :4] = -1
    return {"tokens": toks, "labels": labels,
            "frames": _normal(rng, (2, 20, cfg.d_model), 0.1)}


def test_encdec_loss_and_grads_match_jax():
    """``encdec_loss`` and every gradient (through the cross-attention's
    keys into the encoder) against ``jax.grad``; remat modes bitwise."""
    _grads_match(ENCDEC, ted.encdec_loss, jed.encdec_loss,
                 jed.init_encdec_params,
                 _encdec_batch(t_get_reduced(ENCDEC), seed=6))


# ---------------------------------------------------------------------------
# training and the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [VLM, ENCDEC])
def test_train_step_from_the_reference_state(name):
    """One AdamW step from ``interop.state_from_numpy`` of the reference's
    step-0 state (the encdec tree, or the vlm's dense one) on a batch of
    the family's inputs."""
    jcfg, tcfg = j_get_reduced(name), _t_cfg(name)
    jo = jopt.build_optimizer(jcfg, total_steps=10)
    to = topt.build_optimizer(tcfg, total_steps=10)
    jstate = jts.init_train_state(jax.random.key(0), jcfg, jo)
    tstate = state_from_numpy(jstate, "cpu")
    batch = (_encdec_batch if name == ENCDEC else _vlm_batch)(tcfg, 40)
    jstate, jm = jax.jit(jts.make_train_step(jcfg, jo))(jstate, _jt(batch))
    tstate, tm = tts.make_train_step(tcfg, to)(tstate, _tt(batch))
    _close(tm["loss"], jm["loss"])
    _close(tm["grad_norm"], jm["grad_norm"])
    assert int(tstate.step) == int(jstate.step) == 1
    for a, b in zip(tree.leaves(tstate.opt), jax.tree.leaves(jstate.opt)):
        _close(a, b, TOL_GRAD)
    lr = float(topt.lr_schedule(10)(0))
    for a, b in zip(tree.leaves(tstate.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(_np(a), _np(b), atol=lr, rtol=0)


@pytest.mark.parametrize("name", [VLM, ENCDEC])
def test_train_cli_reduced_on_cpu(monkeypatch, name):
    """``launch.train`` trains both families from the loader's batches
    (``extra_embeds`` for internvl2, ``frames`` for seamless)."""
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", name, "--reduced", "--device", "cpu", "--steps",
        "2", "--seq-len", "16", "--batch", "2"])
    out = io.StringIO()
    with redirect_stdout(out):
        tlaunch.main()
    lines = out.getvalue().splitlines()
    assert lines[0] == "device: cpu (host CPU)"
    steps = [ln.split() for ln in lines[1:]]
    assert [int(s[1]) for s in steps] == [0, 1]
    losses = [float(s[3]) for s in steps]
    assert all(np.isfinite(losses)) and abs(losses[0] - np.log(512)) < 1.0


def test_init_train_state_draws_the_encdec_tree():
    cfg = _t_cfg(ENCDEC)
    state = tts.init_train_state(torch.Generator().manual_seed(0), cfg,
                                 topt.build_optimizer(cfg))
    assert sorted(state.params) == ["dec", "embed", "enc", "lm_head",
                                    "ln_enc", "ln_f"]
    assert state.params["enc"]["attn"]["wq"].shape[0] == cfg.enc_layers
    assert state.params["dec"]["cross_attn"]["wk"].shape[0] == cfg.dec_layers


def test_serve_cli_serves_reduced_internvl2(capsys):
    """The reference's CLI serves a vlm as its dense stack with no frontend
    embeddings: the same tokens as ``ServeEngine`` on a dense config of
    the same weights."""
    tserve.run_lm(argparse.Namespace(
        arch=VLM, reduced=True, requests=3, prompt_len=12, max_tokens=4,
        temperature=0.0, slots=2, use_pallas=True, device="cpu"))
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in out[:3]] == ["req0", "req1", "req2"]
    assert out[3].startswith("12 tokens in ")
    cfg = t_get_reduced(VLM)
    assert ttf.layer_runs(cfg) == ttf.layer_runs(cfg.replace(family="dense"))


def test_use_pallas_decode_cross_attention_is_the_plain_function():
    """A decode step's cross-attention is ``ref.decode_attention`` on both
    arms (the reference reaches no Pallas kernel there), so the step's
    logits are the same bits with ``use_pallas`` on or off on the CPU."""
    r = _encdec_reference()
    params = params_from_numpy(r["params"], "cpu")
    frames = torch.from_numpy(r["frames"])
    tokens = torch.from_numpy(r["tokens"])
    outs = []
    for use_pallas in (False, True):
        cfg = _t_cfg(ENCDEC, use_pallas=use_pallas)
        with torch.inference_mode():
            _, caches = ted.encdec_prefill(params, cfg, frames,
                                           tokens[:, :ET0])
            caches = ted.graft_encdec_caches(cfg, caches, 32)
            lg, _ = ted.encdec_decode_step(params, cfg,
                                           tokens[:, ET0:ET0 + 1], caches,
                                           ET0)
        outs.append(lg)
    assert torch.equal(outs[0], outs[1])
    # and the cross step is the reference's one-token oracle
    q = torch.from_numpy(_normal(np.random.default_rng(0), (2, 4, 16)))
    k = torch.from_numpy(_normal(np.random.default_rng(1), (2, SS, 4, 16)))
    _close(ref.decode_attention(q, k, k, SS),
           jref.decode_attention(*map(jnp.asarray, (q.numpy(), k.numpy(),
                                                    k.numpy())), SS))
