"""The compiled mesh steps (``graphs.compiled`` of DTensor steps) on two
real ranks (gloo on the CPU), held to their eager calls bitwise and to
JAX at 1e-5: the HAN forward of ``build_hgnn_infer(mesh=...)`` on a
``(data=2, model=1)`` mesh, and ``jit_step``'s prefill, decode and train
steps of the reduced granite on ``(data=1, model=2)``.

There is no card, so the ranks install the stand-in card of
``tests/torch_fake_card.py`` with every tensor counting as one on the
card: weights and caches are held, the per-step token, position and batch
are copied into the signature's buffers, the train state is donated.
Checked: a DTensor's signature holds its placements (the weights
replicated make a second graph), local tensors that moved raise, outputs
come back as DTensors laid out as ``out_shardings`` says, the decode
returns the caches it was given and the train step the state tensors.

The ranks run in one subprocess (``tests/torch_graphs_mesh_ranks.py``,
which imports no jax) with a 180 s timeout, started first: they wait for
their inputs while the module's fixture makes them with JAX, and run
while it computes the JAX side; each check is a test on their results.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.configs.base import HGNNConfig as RefConfig
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro.nn.transformer import graft_prefill_caches as ref_graft
from repro.nn.transformer import init_kv_caches as ref_init_caches
from repro.nn.transformer import init_lm_params as ref_init_lm
from repro.nn.transformer import lm_decode_step as ref_decode
from repro.nn.transformer import lm_prefill as ref_prefill
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch import interop, tree
from repro_torch.core import hgraph

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_GRAD = dict(atol=1e-5, rtol=1e-4)  # tests/test_torch_train.py's
HELPER = Path(__file__).with_name("torch_graphs_mesh_ranks.py")
METAPATHS = [["M", "D", "M"], ["M", "A", "M"]]
HAN = dict(model="han", dataset="tiny", hidden=16, n_heads=4, n_classes=3,
           attn_hidden=8, max_degree=16, fused=True, use_pallas=True,
           fuse_na_sa=True)
DECODE_STEPS = 2


@pytest.fixture(scope="module")
def ranks(tiny_hg, tmp_path_factory):
    """Start the two ranks, hand them the inputs, compute the JAX side
    while they run; ``(outputs, wants)``."""
    tmp = tmp_path_factory.mktemp("graphs_mesh")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, str(HELPER), str(tmp)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    saved = {k: dict(d) for k, d in (("m", ref_syn.DATASET_METAPATHS),
                                     ("t", ref_syn.DATASET_TARGET))}
    ref_syn.DATASET_METAPATHS["tiny"] = METAPATHS
    ref_syn.DATASET_TARGET["tiny"] = "M"
    try:
        yield _run(proc, tiny_hg, tmp)
    finally:
        proc.kill()
        ref_syn.DATASET_METAPATHS.clear()
        ref_syn.DATASET_METAPATHS.update(saved["m"])
        ref_syn.DATASET_TARGET.clear()
        ref_syn.DATASET_TARGET.update(saved["t"])


def _run(proc, tiny_hg, tmp):
    m = ref_get_model(RefConfig(**{k: v for k, v in HAN.items()
                                   if k != "use_pallas"}))
    b = m.prepare(tiny_hg)
    han_p = m.init(jax.random.key(0), b)
    cfg = ref_get_reduced("granite-8b")
    lm_p = ref_init_lm(jax.random.key(1), cfg)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    jo = ref_opt.build_optimizer(cfg)
    jstate = ref_ts.init_train_state(jax.random.key(4), cfg, jo)
    batches = []
    for i in range(2):
        r = np.random.default_rng(20 + i)
        batches.append({k: r.integers(0, cfg.vocab, (4, 16)).astype(
            np.int32) for k in ("tokens", "labels")})
    hg = hgraph.HeteroGraph(tiny_hg.node_counts, tiny_hg.features,
                            tiny_hg.relations, name=tiny_hg.name)
    torch.save({"han_cfg": HAN, "hg": hg, "metapaths": {"tiny": METAPATHS},
                "targets": {"tiny": "M"},
                "han_params": interop.params_from_numpy(han_p, device="cpu"),
                "lm_params": interop.params_from_numpy(lm_p, device="cpu"),
                "tokens": torch.from_numpy(tokens),
                "train_state": interop.state_from_numpy(jstate, "cpu"),
                "train_batches": [{k: torch.from_numpy(v)
                                   for k, v in bb.items()} for bb in batches]},
               tmp / "inputs.pt.part")
    os.replace(tmp / "inputs.pt.part", tmp / "inputs.pt")
    # the JAX side while the ranks run
    want = {"han": np.asarray(m.forward(han_p, b))}
    logits, caches = ref_prefill(lm_p, cfg, jnp.asarray(tokens))
    want["prefill"] = np.asarray(logits)
    caches = ref_graft(cfg, ref_init_caches(cfg, 2, 24), caches, 16)
    toks, dec = [], []
    for i in range(DECODE_STEPS):
        nxt = np.asarray(logits)[:, -1].argmax(-1)[:, None].astype(np.int32)
        toks.append(nxt)
        logits, caches = ref_decode(lm_p, cfg, jnp.asarray(nxt), caches,
                                    jnp.asarray(16 + i, jnp.int32))
        dec.append(np.asarray(logits))
    want["tokens"], want["decode"] = toks, dec
    jstep = jax.jit(ref_ts.make_train_step(cfg, jo))
    want["train"] = []
    for bb in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in bb.items()})
        want["train"].append((jstate, jm))
    _, err = proc.communicate(timeout=180)
    assert proc.returncode == 0, err[-4000:]
    return torch.load(tmp / "outputs.pt", weights_only=False), want


def test_a_dtensor_signature_holds_its_placements_and_a_moved_one_raises(
        ranks):
    got, _ = ranks
    assert got["han_sig_specs"] == [("held", p)
                                    for p in got["han_placements_in"]]
    assert got["han_graphs"] == 2 and got["han_replicated_bitwise"]
    assert "moved since its graph was captured" in got["han_moved"]


def test_compiled_han_mesh_forward_is_eager_and_jax(ranks):
    got, want = ranks
    assert got["han_bitwise"] and got["han_counts"] == (1, 2)
    placements, eager_placements = got["han_placements"]
    assert placements == eager_placements
    for x in got["han_compiled"]:
        np.testing.assert_allclose(x.numpy(), want["han"], **TOL)


def test_compiled_prefill_and_decode_are_eager_and_jax(ranks):
    got, want = ranks
    assert got["granite_bitwise"] and got["prefill_replay_bitwise"]
    placements, laid_out = got["prefill_placements"]
    assert placements == laid_out
    assert got["caches_returned"] == [True] * DECODE_STEPS
    assert got["granite_counts"] == {"prefill": (1, 1),
                                     "decode": (1, DECODE_STEPS - 1)}
    assert got["decode_kinds"] == ["copied", "held"]
    np.testing.assert_allclose(got["granite_prefill"].numpy(),
                               want["prefill"], **TOL)
    for t, w in zip(got["granite_tokens"], want["tokens"]):
        assert np.array_equal(t.numpy(), w)
    for x, w in zip(got["granite_decode"], want["decode"]):
        np.testing.assert_allclose(x.numpy(), w, **TOL)


def test_compiled_train_steps_donate_the_state_and_are_eager_and_jax(ranks):
    got, want = ranks
    res = got["train"]
    assert res["counts"] == (1, 1)
    assert res["same_tensors"] == [True, True]
    assert res["bitwise"] == [True, True]
    for i, (jstate, jm) in enumerate(want["train"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(res["metrics"][i][key].numpy(),
                                       np.asarray(jm[key]), **TOL)
        state = res["states"][i]
        assert int(state.step) == int(jstate.step) == i + 1
        for a, b in zip(tree.leaves(state.opt), jax.tree.leaves(jstate.opt)):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(
                b, np.float32), **TOL_GRAD)
        for a, b in zip(tree.leaves(state.params),
                        jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(
                b, np.float32), **TOL_GRAD)
