"""The port's mesh paths on two real ranks (gloo on the CPU), held to the
JAX forward: HAN on a ``(data=2, model=1)`` mesh (destination rows over
the ranks, the fused epilogue's score means reduced across them), the
reduced granite prefill and a decode step on a ``(data=1, model=2)`` mesh
(heads, vocab and the decode cache's sequence over the ranks), and one
train step of the reduced granite on ``(1, 2)`` and of the reduced zamba2
(the SSD on each rank's rows) on ``(2, 1)`` held to the JAX train step
(the gradients' layouts: partial sums reduced across the ranks).

The ranks run in one subprocess (``tests/torch_mesh_ranks.py``, which
imports no jax) with a 180 s timeout, started first: they wait for their
inputs while the test makes them with JAX, and run while it computes the
JAX side; they meet through a ``FileStore`` under ``tmp_path``.  This is the one process-group test of tier 1
(ROADMAP invariant 4 allows gloo tests for item 19, each with a timeout).
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
from repro.nn.transformer import init_lm_params as ref_init_lm
from repro.nn.transformer import init_kv_caches as ref_init_caches
from repro.nn.transformer import graft_prefill_caches as ref_graft
from repro.nn.transformer import lm_decode_step as ref_decode
from repro.nn.transformer import lm_prefill as ref_prefill
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch import interop, tree
from repro_torch.core import hgraph

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_GRAD = dict(atol=1e-5, rtol=1e-4)  # tests/test_torch_train.py's
TRAIN = {"granite_train": ("granite-8b", (1, 2), 4),
         "zamba2_train": ("zamba2-1.2b", (2, 1), 5)}
HELPER = Path(__file__).with_name("torch_mesh_ranks.py")
METAPATHS = [["M", "D", "M"], ["M", "A", "M"]]
HAN = dict(model="han", dataset="tiny", hidden=16, n_heads=4, n_classes=3,
           attn_hidden=8, max_degree=16, fused=True)
CASES = {"han_kernel_fused": dict(use_pallas=True, fuse_na_sa=True),
         "han_plain": dict(use_pallas=False)}


@pytest.fixture
def _tiny_tables(monkeypatch):
    monkeypatch.setitem(ref_syn.DATASET_METAPATHS, "tiny", METAPATHS)
    monkeypatch.setitem(ref_syn.DATASET_TARGET, "tiny", "M")


def test_two_gloo_ranks_match_the_jax_forward(tiny_hg, tmp_path,
                                              _tiny_tables):
    # the ranks start (and wait for their inputs) while JAX makes them
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, str(HELPER), str(tmp_path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        _ranks_match_the_jax_forward(proc, tiny_hg, tmp_path)
    finally:
        proc.kill()


def _ranks_match_the_jax_forward(proc, tiny_hg, tmp_path):
    models = {}
    for name, kw in CASES.items():
        m = ref_get_model(RefConfig(**HAN, **kw))
        models[name] = (m, m.prepare(tiny_hg))
    m, b = models["han_kernel_fused"]
    ref_params = m.init(jax.random.key(0), b)
    cfg = ref_get_reduced("granite-8b")
    lm_p = ref_init_lm(jax.random.key(1), cfg)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    train, jtrain = {}, {}
    for name, (arch, mesh, seed) in TRAIN.items():
        jcfg = ref_get_reduced(arch)
        jo = ref_opt.build_optimizer(jcfg)
        jstate = ref_ts.init_train_state(jax.random.key(seed), jcfg, jo)
        r = np.random.default_rng(seed)
        batch = {k: r.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
                 for k in ("tokens", "labels")}
        train[name] = {"arch": arch, "mesh": mesh,
                       "state": interop.state_from_numpy(jstate, "cpu"),
                       "batch": {k: torch.from_numpy(v)
                                 for k, v in batch.items()}}
        jtrain[name] = (jcfg, jo, jstate, batch)
    hg = hgraph.HeteroGraph(tiny_hg.node_counts, tiny_hg.features,
                            tiny_hg.relations, name=tiny_hg.name)
    torch.save({"han_cfgs": {n: dict(HAN, **kw) for n, kw in CASES.items()},
                "hg": hg, "metapaths": {"tiny": METAPATHS},
                "targets": {"tiny": "M"},
                "han_params": interop.params_from_numpy(ref_params,
                                                        device="cpu"),
                "lm_params": interop.params_from_numpy(lm_p, device="cpu"),
                "tokens": torch.from_numpy(tokens), "train": train},
               tmp_path / "inputs.pt.part")
    os.replace(tmp_path / "inputs.pt.part", tmp_path / "inputs.pt")
    # the JAX side while the ranks run
    want = {name: np.asarray(m.forward(ref_params, b))
            for name, (m, b) in models.items()}
    logits, caches = ref_prefill(lm_p, cfg, jnp.asarray(tokens))
    want["granite_prefill"] = np.asarray(logits)
    nxt = np.asarray(logits)[:, -1].argmax(-1)[:, None].astype(np.int32)
    grafted = ref_graft(cfg, ref_init_caches(cfg, 2, 24), caches, 16)
    dec, _ = ref_decode(lm_p, cfg, jnp.asarray(nxt), grafted,
                        jnp.asarray(16, jnp.int32))
    want["granite_decode"] = np.asarray(dec)
    want_train = {
        name: jax.jit(ref_ts.make_train_step(jcfg, jo))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        for name, (jcfg, jo, jstate, batch) in jtrain.items()}
    _, err = proc.communicate(timeout=180)
    assert proc.returncode == 0, err[-4000:]
    got = torch.load(tmp_path / "outputs.pt", weights_only=False)
    assert np.array_equal(got["granite_next"].numpy(), nxt)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)
    for name, (jstate, jm) in want_train.items():
        g = got[name]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key].numpy(), np.asarray(jm[key]),
                                       **TOL, err_msg=f"{name} {key}")
        assert int(g["state"].step) == int(jstate.step) == 1
        for a, b in zip(tree.leaves(g["state"].opt),
                        jax.tree.leaves(jstate.opt)):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(
                b, np.float32), **TOL_GRAD, err_msg=f"{name} opt")
        for a, b in zip(tree.leaves(g["state"].params),
                        jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(
                b, np.float32), **TOL_GRAD, err_msg=f"{name} params")
