"""The port's LM training path (``data/loader.py``, ``train/optimizer.py``,
``train/elastic.py``, ``train/train_step.py``, ``train/checkpoint.py``,
``nn/attention.py``'s chunked backward, ``nn/transformer.py``'s
``lm_loss``, ``launch/train.py``) against the JAX reference on the same
inputs, on the CPU.

Tolerances: host arrays (batches, shards) byte-equal; the schedule, the
norms and the optimizers on identical fp32 parameters and gradients at
atol = rtol = 1e-6 (the same fp32 formulas, reductions summed in another
order); the chunked attention's dQ, dK, dV at atol = rtol = 1e-5;
``lm_loss`` at 1e-5 and its gradients at atol = 1e-5, rtol = 1e-4 (the
same model in two frameworks: the matmuls and the softmax sums differ in
order, and a gradient sums over every token); the remat modes bitwise.  A
train step's loss and gradient norm at 1e-5 and its optimizer state at
atol = 1e-5, rtol = 1e-4; its parameters at an atol of the step's
learning rate, since AdamW's first step is about ``lr * sign(g)`` and a
gradient element near 0 may round to the other side of it.  Checkpoints
bitwise.
"""
import dataclasses
import io
import json
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import get_reduced as j_get_reduced
from repro.data import loader as jloader
from repro.nn import attention as jattn
from repro.nn import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import elastic as jelastic
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_reduced as t_get_reduced
from repro_torch.data import loader as tloader
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.launch import train as tlaunch
from repro_torch.nn import attention as tattn
from repro_torch.nn import transformer as ttf
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import elastic as telastic
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch import tree

TOL_OPT = dict(atol=1e-6, rtol=1e-6)
TOL_ATTN = dict(atol=1e-5, rtol=1e-5)
TOL_LOSS = dict(atol=1e-5, rtol=1e-5)
TOL_GRAD = dict(atol=1e-5, rtol=1e-4)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _cfgs(tiny, **kw):
    """The reference's and the port's dense config on ``tiny_cfg_base``."""
    j = jbase.ModelConfig(name="d", family="dense", **dict(tiny, **kw))
    return j, tbase.ModelConfig(**dataclasses.asdict(j))


def _batch(cfg, b, s, seed):
    """Tokens and next-token labels, with -1 pads at the end of every row
    and at the start of row 0."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    labels[0, :5] = -1
    return {"tokens": toks, "labels": labels}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# data/loader.py, train/elastic.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "internvl2-76b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("step,host_id,n_hosts", [(0, 0, 1), (7, 0, 1),
                                                  (3, 1, 2), (123, 3, 4)])
def test_synth_batch_byte_equal(arch, step, host_id, n_hosts):
    shape = jbase.ShapeConfig("t", 24, 8, "train")
    want = jloader.synth_batch(j_get_reduced(arch), shape, step, host_id,
                               n_hosts)
    got = tloader.synth_batch(t_get_reduced(arch),
                              tbase.ShapeConfig("t", 24, 8, "train"), step,
                              host_id, n_hosts)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_prefetch_loader_first_batches_byte_equal():
    shape = jbase.ShapeConfig("t", 16, 4, "train")
    j = jloader.PrefetchLoader(j_get_reduced("smollm-360m"), shape,
                               start_step=5)
    t = tloader.PrefetchLoader(t_get_reduced("smollm-360m"),
                               tbase.ShapeConfig("t", 16, 4, "train"),
                               start_step=5)
    try:
        for _ in range(3):
            a, b = next(j), next(t)
            for k in a:
                assert a[k].tobytes() == b[k].tobytes()
    finally:
        j.close()
        t.close()
    assert not t._t.is_alive()


def test_data_shard_and_step_timer_equal():
    for args in [(0, 0, 1, 8, 100), (5, 1, 2, 8, 100), (37, 3, 4, 256, 1000),
                 (9, 2, 3, 12, 7)]:
        assert telastic.data_shard(*args) == jelastic.data_shard(*args)
    tj, tt = jelastic.StepTimer(), telastic.StepTimer()
    times = [0.1, 0.11, 0.09, 0.1, 0.5, 0.1, 0.35, 0.1, 0.1, 0.12]
    flags = [(tj.observe(x), tt.observe(x)) for x in times]
    assert all(a == b for a, b in flags)
    assert any(a for a, _ in flags)


# ---------------------------------------------------------------------------
# train/optimizer.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 4, 9, 10, 50, 99, 150])
def test_warmup_cosine_matches_reference(step):
    j = jopt.warmup_cosine(3e-4, 10, 100)
    t = topt.warmup_cosine(3e-4, 10, 100)
    _close(t(torch.tensor(step, dtype=torch.int32)), j(jnp.int32(step)),
           TOL_OPT)
    _close(t(step), j(jnp.int32(step)), TOL_OPT)


@pytest.mark.parametrize("total_steps", [10, 10_000])
def test_lr_schedule_is_build_optimizers(total_steps):
    """``lr_schedule`` is the schedule the reference's ``build_optimizer``
    hands its optimizers (``repro/train/optimizer.py:184-188``)."""
    j = jopt.warmup_cosine(3e-4, min(500, total_steps // 10 + 1), total_steps)
    t = topt.lr_schedule(total_steps)
    for step in (0, 1, 2, total_steps // 2, total_steps - 1, total_steps):
        _close(t(step), j(jnp.int32(step)), TOL_OPT)


def _opt_tree(seed):
    """Parameters with rank 1, 2 and 3 leaves, as numpy."""
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal(7).astype(np.float32),
            "w": rng.standard_normal((5, 6)).astype(np.float32),
            "stack": {"k": rng.standard_normal((3, 4, 5)).astype(np.float32)}}


def test_global_norm_and_clip_match_reference():
    g = _opt_tree(1)
    tg = params_from_numpy(g, "cpu")
    _close(topt.global_norm(tg), jopt.global_norm(g), TOL_OPT)
    for max_norm in (0.5, 100.0):
        tc, tn = topt.clip_by_global_norm(tg, max_norm)
        jc, jn = jopt.clip_by_global_norm(g, max_norm)
        _close(tn, jn, TOL_OPT)
        for a, b in zip(tree.leaves(tc), jax.tree.leaves(jc)):
            _close(a, b, TOL_OPT)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference(name):
    lr_j = jopt.warmup_cosine(1e-2, 2, 10)
    lr_t = topt.warmup_cosine(1e-2, 2, 10)
    j = getattr(jopt, name)(lr_j)
    t = getattr(topt, name)(lr_t)
    jp = _opt_tree(0)
    tp = params_from_numpy(jp, "cpu")
    js, ts = j.init(jp), t.init(tp)
    assert type(ts).__name__ == type(js).__name__
    for i in range(3):
        g = _opt_tree(10 + i)
        jp, js = j.update(g, js, jp, jnp.int32(i))
        tp, ts = t.update(params_from_numpy(g, "cpu"), ts, tp,
                          torch.tensor(i, dtype=torch.int32))
        for a, b in zip(tree.leaves(tp), jax.tree.leaves(jp)):
            _close(a, b, TOL_OPT)
        for a, b in zip(tree.leaves(ts), jax.tree.leaves(js)):
            assert tuple(a.shape) == tuple(b.shape)
            _close(a, b, TOL_OPT)


# ---------------------------------------------------------------------------
# nn/attention.py: the chunked path's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48)])
@pytest.mark.parametrize("cq,ck", [(32, 32), (64, 128), (128, 64)])
def test_chunked_attention_grads_match_jax(causal, window, cq, ck):
    """``tests/test_attention.py``'s cases: dQ, dK, dV of a weighted sum of
    the output through the port's ``_Chunked5`` against ``jax.grad``
    through the reference's ``custom_vjp``."""
    rng = np.random.default_rng(cq + ck + window + causal)
    q = (rng.standard_normal((2, 128, 4, 32)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((2, 128, 2, 32)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((2, 128, 2, 32)) * 0.5).astype(np.float32)
    w = rng.standard_normal((2, 128, 4, 32)).astype(np.float32)

    def jf(q, k, v):
        return (jattn.chunked_attention(q, k, v, causal=causal, window=window,
                                        chunk_q=cq, chunk_k=ck) * w).sum()

    want = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                  chunk_q=cq, chunk_k=ck)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for a, b in zip(got, want):
        _close(a, b, TOL_ATTN)


# ---------------------------------------------------------------------------
# nn/transformer.py: lm_loss and its gradients
# ---------------------------------------------------------------------------

def _port_value_and_grad(cfg, params, batch):
    loss_fn = lambda p, batch: ttf.lm_loss(p, cfg, batch)  # noqa: E731
    return tts.value_and_grad(loss_fn, params, _t(batch))


@pytest.mark.parametrize("tied,seq,chunk", [
    (True, 16, 16),  # the plain attention arm
    (False, 16, 16),
    (True, 1536, 512),  # the chunked arm (above 1024 tokens)
])
def test_lm_loss_and_grads_match_jax(tiny_cfg_base, tied, seq, chunk):
    jcfg, tcfg = _cfgs(tiny_cfg_base, tie_embeddings=tied, attn_chunk=chunk)
    params = jtf.init_lm_params(jax.random.key(0), jcfg)
    batch = _batch(jcfg, 2 if seq < 1024 else 1, seq, seed=seq + tied)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jtf.lm_loss(
        p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})))(params)
    runs = {}
    for remat in ("none", "full", "dots"):
        runs[remat] = _port_value_and_grad(tcfg.replace(remat=remat),
                                           params_from_numpy(params, "cpu"),
                                           batch)
    loss, grads = runs["none"]
    _close(loss, jl, TOL_LOSS)
    assert len(tree.leaves(grads)) == len(jax.tree.leaves(jg))
    for a, b in zip(tree.leaves(grads), jax.tree.leaves(jg)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, TOL_GRAD)
    for remat in ("full", "dots"):
        l2, g2 = runs[remat]
        assert torch.equal(l2, loss), remat
        assert all(torch.equal(a, b) for a, b in
                   zip(tree.leaves(g2), tree.leaves(grads))), remat


def test_embedding_gradient_is_the_index_select_gradient():
    """``_EmbedGather``'s fixed-order backward (``segment_sum`` over the
    stably sorted ids) gives ``index_select``'s gradient, bitwise on the
    CPU where both add each id's rows in token order."""
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.standard_normal((50, 12)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 50, 200).astype(np.int32))
    dx = torch.from_numpy(rng.standard_normal((200, 12)).astype(np.float32))
    a = table.clone().requires_grad_()
    (ga,) = torch.autograd.grad((ttf._EmbedGather.apply(a, ids) * dx).sum(),
                                a)
    b = table.clone().requires_grad_()
    (gb,) = torch.autograd.grad((b.index_select(0, ids.long()) * dx).sum(), b)
    assert torch.equal(ga, gb)
    # a bf16 table: the bf16 row gradients summed in fp32, then cast
    bf = table.to(torch.bfloat16).requires_grad_()
    dx16 = dx.to(torch.bfloat16)
    (gbf,) = torch.autograd.grad((ttf._EmbedGather.apply(bf, ids) * dx16)
                                 .float().sum(), bf)
    want = torch.zeros(50, 12).index_add_(0, ids.long(), dx16.float())
    assert gbf.dtype == torch.bfloat16
    assert torch.equal(gbf, want.to(torch.bfloat16))


def test_other_families_raise_citing_item_17():
    """The vlm and encdec families train on the plain arm
    (``tests/test_torch_lm_vlm_encdec.py``); under ``use_pallas`` their
    train steps raise, as the dense one does: the kernel has no
    backward."""
    for name in ("internvl2-76b", "seamless-m4t-medium"):
        cfg = t_get_reduced(name).replace(use_pallas=True)
        opt = topt.build_optimizer(cfg)
        state = tts.init_train_state(torch.Generator().manual_seed(0), cfg,
                                     opt)
        batch = {k: torch.as_tensor(v) for k, v in tloader.synth_batch(
            cfg, tbase.ShapeConfig("t", 8, 2, "train"), 0).items()}
        with pytest.raises(NotImplementedError, match="item 17"):
            tts.make_train_step(cfg, opt)(state, batch)


# ---------------------------------------------------------------------------
# use_pallas: the kernel has no backward
# ---------------------------------------------------------------------------

def test_use_pallas_under_grad_raises(tiny_cfg_base):
    jcfg, tcfg = _cfgs(tiny_cfg_base)
    params = params_from_numpy(jtf.init_lm_params(jax.random.key(0), jcfg),
                               "cpu")
    batch = _batch(jcfg, 2, 16, seed=0)
    with pytest.raises(NotImplementedError, match="item 17"):
        _port_value_and_grad(tcfg.replace(use_pallas=True), params, batch)
    step = tts.make_train_step(tcfg.replace(use_pallas=True),
                               topt.build_optimizer(tcfg))
    state = tts.TrainState(torch.tensor(0, dtype=torch.int32), params,
                           topt.build_optimizer(tcfg).init(params))
    with pytest.raises(NotImplementedError, match="item 17"):
        step(state, _t(batch))


def test_use_pallas_serving_still_runs(tiny_cfg_base):
    """Weights that need no gradient take the kernel arm as before, with
    grad mode on or off."""
    jcfg, tcfg = _cfgs(tiny_cfg_base)
    params = params_from_numpy(jtf.init_lm_params(jax.random.key(0), jcfg),
                               "cpu")
    tokens = torch.from_numpy(_batch(jcfg, 2, 16, seed=1)["tokens"])
    with torch.inference_mode():
        want, _ = ttf.lm_forward(params, tcfg, tokens)
        got, _ = ttf.lm_forward(params, tcfg.replace(use_pallas=True), tokens)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    got2, _ = ttf.lm_forward(params, tcfg.replace(use_pallas=True), tokens)
    assert not got2.requires_grad
    assert torch.equal(got2, got)


# ---------------------------------------------------------------------------
# train/train_step.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("n_mb", [1, 2])
def test_train_step_matches_jax(tiny_cfg_base, optimizer, n_mb):
    jcfg, tcfg = _cfgs(tiny_cfg_base, optimizer=optimizer)
    total_steps = 10
    jo = jopt.build_optimizer(jcfg, total_steps=total_steps)
    to = topt.build_optimizer(tcfg, total_steps=total_steps)
    jstate = jts.init_train_state(jax.random.key(0), jcfg, jo)
    tstate = state_from_numpy(jstate, "cpu")
    assert isinstance(tstate.opt, getattr(topt, type(jstate.opt).__name__))
    jstep = jax.jit(jts.make_train_step(jcfg, jo, n_microbatches=n_mb))
    tstep = tts.make_train_step(tcfg, to, n_microbatches=n_mb)
    for i in range(2):
        batch = _batch(jcfg, 4, 16, seed=20 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, _t(batch))
        assert tm["loss"].dim() == 0 and tm["grad_norm"].dim() == 0
        _close(tm["loss"], jm["loss"], TOL_LOSS)
        _close(tm["grad_norm"], jm["grad_norm"], TOL_LOSS)
        assert int(tstate.step) == int(jstate.step) == i + 1
        for a, b in zip(tree.leaves(tstate.opt), jax.tree.leaves(jstate.opt)):
            _close(a, b, TOL_GRAD)
        lr = float(topt.lr_schedule(total_steps)(i))
        for a, b in zip(tree.leaves(tstate.params),
                        jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(_np(a), _np(b), atol=lr, rtol=0)


def test_gradients_of_the_step_state_match_jax(tiny_cfg_base):
    """The gradients a step starts from, on the state after one step of
    each package (AdamW), held at the gradient tolerance."""
    jcfg, tcfg = _cfgs(tiny_cfg_base)
    jo = jopt.build_optimizer(jcfg, total_steps=10)
    jstate = jts.init_train_state(jax.random.key(0), jcfg, jo)
    batch = _batch(jcfg, 4, 16, seed=30)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, _ = jax.jit(jts.make_train_step(jcfg, jo))(jstate, jb)
    tstate = state_from_numpy(jstate, "cpu")
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jb)))(jstate.params)
    tl, tg = _port_value_and_grad(tcfg, tstate.params, batch)
    _close(tl, jl, TOL_LOSS)
    for a, b in zip(tree.leaves(tg), jax.tree.leaves(jg)):
        _close(a, b, TOL_GRAD)


# ---------------------------------------------------------------------------
# train/checkpoint.py
# ---------------------------------------------------------------------------

def _j_state(tiny, dtype):
    jcfg, _ = _cfgs(tiny, dtype=dtype, param_dtype=dtype)
    jo = jopt.build_optimizer(jcfg)
    return jts.init_train_state(jax.random.key(0), jcfg, jo)


def _bits(x):
    """A leaf's bytes: a bf16 leaf as its 16-bit patterns."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes()
        return x.numpy().tobytes()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16).tobytes()
    return a.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_restores_the_reference_checkpoint(tmp_path, tiny_cfg_base,
                                                dtype):
    jstate = _j_state(tiny_cfg_base, dtype)
    d = str(tmp_path / "ck")
    jckpt.save(jstate, d, step=7)
    like = state_from_numpy(jstate, "cpu")
    got = tckpt.restore(d, like, device="cpu")
    assert isinstance(got, tts.TrainState)
    flat = tree.leaves(got)
    assert len(flat) == len(jax.tree.leaves(jstate))
    for a, b in zip(flat, jax.tree.leaves(jstate)):
        assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype)
        assert _bits(a) == _bits(b)


def test_reference_cannot_restore_its_bf16_checkpoint(tmp_path,
                                                      tiny_cfg_base):
    """ROADMAP Queue 3 check (h): the reference's ``restore`` hands the
    ``|V2`` leaf of a bf16 checkpoint to ``jax.numpy.asarray``."""
    jstate = _j_state(tiny_cfg_base, "bfloat16")
    d = str(tmp_path / "ck")
    jckpt.save(jstate, d, step=1)
    with pytest.raises(TypeError):
        jckpt.restore(d, jstate)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_manifest_equals_the_reference(tmp_path, tiny_cfg_base, dtype):
    jstate = _j_state(tiny_cfg_base, dtype)
    jckpt.save(jstate, str(tmp_path / "j"), step=3)
    tckpt.save(state_from_numpy(jstate, "cpu"), str(tmp_path / "t"), step=3)

    def manifest(root):
        with open(os.path.join(root, "step_00000003", "manifest.json")) as f:
            m = json.load(f)
        assert set(m["digest"]) == {"0"}
        del m["digest"]
        return m

    assert manifest(str(tmp_path / "t")) == manifest(str(tmp_path / "j"))
    with np.load(str(tmp_path / "t" / "step_00000003" / "shard_00000.npz")) \
            as t, np.load(str(tmp_path / "j" / "step_00000003" /
                              "shard_00000.npz")) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype
            assert t[k].tobytes() == j[k].tobytes()


def test_reference_restores_the_port_fp32_checkpoint(tmp_path, tiny_cfg_base):
    jstate = _j_state(tiny_cfg_base, "float32")
    d = str(tmp_path / "ck")
    tckpt.save(state_from_numpy(jstate, "cpu"), d, step=5)
    assert jckpt.latest_step(d) == 5
    got = jckpt.restore(d, jstate)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        assert _bits(a) == _bits(b)


def test_checkpoint_corruption_atomic_publish_and_async(tmp_path,
                                                        tiny_cfg_base):
    state = state_from_numpy(_j_state(tiny_cfg_base, "bfloat16"), "cpu")
    d = str(tmp_path / "ck")
    path = tckpt.save(state, d, step=1)
    assert not os.path.exists(path + ".tmp")
    assert tckpt.latest_step(d) == 1
    shard = os.path.join(path, "shard_00000.npz")
    with open(shard, "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(IOError):
        tckpt.restore(d, state, device="cpu")
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), state, device="cpu")

    saver = tckpt.AsyncCheckpointer(d)
    saver.submit(state, 2)
    later = state._replace(step=state.step + 3)
    saver.submit(later, 4)
    saver.close()
    assert tckpt.latest_step(d) == 4
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    got = tckpt.restore(d, state, device="cpu")
    assert int(got.step) == int(state.step) + 3
    for a, b in zip(tree.leaves(got), tree.leaves(later)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------

def _cli(monkeypatch, *argv):
    monkeypatch.setattr(sys, "argv", ["repro_torch.launch.train", *argv])
    out = io.StringIO()
    with redirect_stdout(out):
        tlaunch.main()
    return out.getvalue().splitlines()


def test_train_cli_steps_and_resume(monkeypatch, tmp_path):
    d = str(tmp_path / "ck")
    common = ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
              "--seq-len", "32", "--batch", "4", "--ckpt-dir", d]
    lines = _cli(monkeypatch, *common, "--steps", "3", "--ckpt-every", "2")
    assert lines[0] == "device: cpu (host CPU)"
    steps = [ln.split() for ln in lines[1:]]
    assert [int(s[1]) for s in steps] == [0, 1, 2]
    losses = [float(s[3]) for s in steps]
    assert all(np.isfinite(losses)) and abs(losses[0] - np.log(512)) < 0.5
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]

    lines = _cli(monkeypatch, *common, "--steps", "2", "--resume",
                 "--microbatches", "2")
    assert lines[1] == "resumed from step 3"
    assert [int(ln.split()[1]) for ln in lines[2:]] == [3, 4]
    assert tckpt.latest_step(d) == 5

    # --distributed joins the default group from torchrun's env://
    # variables; without them, and with no group joined, torch's own
    # rendezvous raises (before it opens any socket)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(sys, "argv", ["train", "--distributed", *common])
    with pytest.raises(ValueError, match="environment variable"):
        tlaunch.main()
    assert not torch.distributed.is_initialized()
