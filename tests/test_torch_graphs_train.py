"""The compiled training step (``graphs.compiled(step, donate=(0,))``,
the reference's ``jax.jit(step_fn, donate_argnums=(0,))``) on the CPU.

There is no card here, so capture and replay are driven through the
stand-in of ``tests/torch_fake_card.py`` (a capture puts the card's
storages back as they were, as a real capture runs nothing).  On it: a
tiny LM's train steps through the donated step, bitwise the eager
``make_train_step`` and held to the JAX train step (loss and gradient
norm at 1e-5, the optimizer state at atol 1e-5 / rtol 1e-4 and the
parameters at an atol of the step's learning rate, as
``tests/test_torch_train.py`` holds a step); every call returning the
state tensors it was given; an ``AsyncCheckpointer`` snapshot taken
between two steps equal to the eager state of its step; a donated leaf
off the card, or an output with no counterpart, refused.  Off the
stand-in, ``launch/train.setup`` on the CPU returns the step itself.

Stability: inputs from fixed numpy seeds, no clock, no subprocess; the
module seam is touched only through ``monkeypatch``.  About 15 s on one
worker.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import graphs, tree
from repro_torch.configs import base as tbase
from repro_torch.interop import state_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import train as tlaunch
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from torch_fake_card import ON_CARD, FakeCard, on_card

TOL_LOSS = dict(atol=1e-5, rtol=1e-5)
TOL_GRAD = dict(atol=1e-5, rtol=1e-4)
TOTAL_STEPS = 10


@pytest.fixture
def card(monkeypatch):
    fake = FakeCard()
    monkeypatch.setattr(graphs, "_card", fake)
    ops.reset_launch_counts()
    ON_CARD.clear()
    yield fake
    ON_CARD.clear()
    ops.reset_launch_counts()


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else \
        np.asarray(x, np.float32)


def _batch(vocab, seed, b=4, s=16):
    """Tokens and next-token labels, with -1 pads at the end of every row."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    return {"tokens": toks, "labels": labels}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _setup(tiny, optimizer="adamw", n_mb=1):
    """The reference's and the port's config, optimizer, step and state
    (the port's from the reference's, ``interop.state_from_numpy``)."""
    jcfg = jbase.ModelConfig(name="d", family="dense",
                             **dict(tiny, optimizer=optimizer))
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    jo = jopt.build_optimizer(jcfg, total_steps=TOTAL_STEPS)
    to = topt.build_optimizer(tcfg, total_steps=TOTAL_STEPS)
    jstate = jts.init_train_state(jax.random.key(0), jcfg, jo)
    jstep = jax.jit(jts.make_train_step(jcfg, jo, n_microbatches=n_mb))
    tstep = tts.make_train_step(tcfg, to, n_microbatches=n_mb)
    return jcfg, jstate, jstep, tstep


def _bitwise(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("optimizer,n_mb", [("adamw", 1), ("adamw", 2),
                                            ("adafactor", 1)])
def test_donated_steps_are_the_eager_steps_and_the_jax_steps(
        card, tiny_cfg_base, optimizer, n_mb):
    jcfg, jstate, jstep, tstep = _setup(tiny_cfg_base, optimizer, n_mb)
    eager = state_from_numpy(jstate, "cpu")
    held = on_card(state_from_numpy(jstate, "cpu"))
    leaves = tree.leaves(held)
    step = graphs.compiled(tstep, donate=(0,))
    for i in range(3):
        batch = _batch(jcfg.vocab, seed=30 + i)
        eager, em = tstep(eager, _t(batch))
        # the loader's numpy batch, uploaded, as launch/train.py passes it
        out, m = step(held, batch)
        assert all(a is b for a, b in zip(tree.leaves(out), leaves))
        held = out
        assert torch.equal(m["loss"], em["loss"])
        assert torch.equal(m["grad_norm"], em["grad_norm"])
        assert _bitwise(held, eager)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        np.testing.assert_allclose(_np(m["loss"]), _np(jm["loss"]),
                                   **TOL_LOSS)
        np.testing.assert_allclose(_np(m["grad_norm"]),
                                   _np(jm["grad_norm"]), **TOL_LOSS)
        assert int(held.step) == int(jstate.step) == i + 1
        for a, b in zip(tree.leaves(held.opt), jax.tree.leaves(jstate.opt)):
            np.testing.assert_allclose(_np(a), _np(b), **TOL_GRAD)
        lr = float(topt.lr_schedule(TOTAL_STEPS)(i))
        for a, b in zip(tree.leaves(held.params),
                        jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(_np(a), _np(b), atol=lr, rtol=0)
    assert (step.captures, step.replays, card.captured) == (1, 2, 1)
    g = next(iter(step.graphs.values()))  # every state leaf held
    assert [i for i, _, _ in g.held] == list(range(len(leaves)))


def test_a_checkpoint_between_steps_is_its_steps_state(card, tiny_cfg_base,
                                                       tmp_path):
    """``AsyncCheckpointer.submit`` copies the state to the host before
    it returns, so the next step, which overwrites the donated state,
    leaves the snapshot as it was."""
    jcfg, jstate, _, tstep = _setup(tiny_cfg_base)
    eager = state_from_numpy(jstate, "cpu")
    held = on_card(state_from_numpy(jstate, "cpu"))
    step = graphs.compiled(tstep, donate=(0,))
    saver = tckpt.AsyncCheckpointer(str(tmp_path))
    try:
        for i in range(3):
            batch = _batch(jcfg.vocab, seed=40 + i)
            held, _ = step(held, batch)
            if i < 2:
                eager, _ = tstep(eager, _t(batch))
            if i == 1:
                saver.submit(held, 2)
    finally:
        saver.close()
    assert int(held.step) == 3
    like = state_from_numpy(jstate, "cpu")
    back = tckpt.restore(str(tmp_path), like, device="cpu")
    assert int(back.step) == 2
    assert _bitwise(back, eager)
    assert not _bitwise(back, held)


def test_donation_wants_card_leaves_and_a_counterpart(card):
    rng = np.random.default_rng(7)
    w = on_card(torch.from_numpy(rng.standard_normal((4, 3)).astype(
        np.float32)))

    def sgd(p, x):
        return {"w": p["w"] - 0.1 * x}, p["w"].sum()

    x = rng.standard_normal((4, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="not a tensor on the card"):
        graphs.compiled(sgd, donate=(1,))({"w": w}, x)
    with pytest.raises(ValueError, match="no element of the output"):
        graphs.compiled(lambda p, x: (p["w"].sum(), x), donate=(0,))(
            {"w": w}, x)
    f = graphs.compiled(sgd, donate=(0,))
    want = w.clone()
    for _ in range(3):
        p, total = f({"w": w}, x)
        want = want - 0.1 * torch.from_numpy(x)
        assert p["w"] is w and torch.equal(w, want)
    assert (f.captures, f.replays) == (1, 2)


def test_launch_setup_on_the_cpu_returns_the_step_itself(tiny_cfg_base):
    cfg = tbase.ModelConfig(name="d", family="dense", **tiny_cfg_base)
    run = tlaunch.setup(cfg, steps=2, seq_len=16, batch=4, device="cpu")
    assert not isinstance(run.step_fn, graphs.Compiled)
    plain = tts.make_train_step(cfg, run.optimizer)
    batch = tlaunch.to_device(_batch(cfg.vocab, seed=50), "cpu")
    got, gm = run.step_fn(run.state, batch)
    want, wm = plain(run.state, batch)
    assert torch.equal(gm["loss"], wm["loss"])
    assert _bitwise(got, want)
