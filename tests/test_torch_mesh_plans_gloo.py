"""Every padded HGNN plan of the port on two real ranks (gloo on the CPU),
held to the JAX single-device forward at 1e-5 on the JAX weights: on
``(data=2, model=1)`` HAN bucketed and at two layers, RGCN padded and
bucketed, MAGNN uncached and with hot rows (each arm); on ``(data=1,
model=2)`` RGCN padded (FP's columns over the ranks); on ``(2, 1)`` HAN,
RGCN and MAGNN partitioned at K = 4, HAN and RGCN at two layers and HAN
with hot rows, under both halo modes, ``"auto"`` issuing one all-gather a
node type and layer and giving the bits of ``"xla"``.  And the reduced granite's decode step on ``(1,
2)`` under ``use_pallas`` with the cache's sequence over the ranks: each
rank runs the decode kernel's log-sum-exp form on its shard (its plain
version here) and the partials are combined, held to the JAX step.

The ranks run in one subprocess (``tests/torch_mesh_plans_ranks.py``,
which imports no jax) with a 180 s timeout, started first: they wait for
their inputs while the module's fixture makes them with JAX, and run while
it computes the JAX side; each case is a test on their results.
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
from repro_torch import interop
from repro_torch.core import hgraph
from torch_mesh_plans_ranks import CASES, PARTITIONED

TOL = dict(atol=1e-5, rtol=1e-5)
HELPER = Path(__file__).with_name("torch_mesh_plans_ranks.py")
METAPATHS = [["M", "D", "M"], ["M", "A", "M"]]


def _jax_forward(tiny_hg, kw):
    kw = {k: v for k, v in kw.items() if k != "use_pallas"}
    m = ref_get_model(RefConfig(**kw))
    b = m.prepare(tiny_hg)
    p = m.init(jax.random.key(0), b)
    return p, lambda: np.asarray(m.forward(p, b))


@pytest.fixture(scope="module")
def ranks(tiny_hg, tmp_path_factory):
    """Start the two ranks, hand them the inputs, compute the JAX side
    while they run; ``(outputs, wants)``."""
    workdir = tmp_path_factory.mktemp("mesh_plans")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, str(HELPER), str(workdir)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(ref_syn.DATASET_METAPATHS, "tiny", METAPATHS)
            mp.setitem(ref_syn.DATASET_TARGET, "tiny", "M")
            yield _run(proc, tiny_hg, workdir)
    finally:
        proc.kill()


def _run(proc, tiny_hg, workdir):
    jax_cases, hgnn = {}, {}
    for name, (kw, mesh, halo) in CASES.items():
        key = name.split("/")[0]
        if key not in jax_cases:
            jax_cases[key] = _jax_forward(tiny_hg, kw)
        hgnn[name] = {"cfg": kw, "mesh": mesh, "halo": halo,
                      "params": interop.params_from_numpy(
                          jax_cases[key][0], device="cpu")}
    cfg = ref_get_reduced("granite-8b")
    lm_p = ref_init_lm(jax.random.key(1), cfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)
    hg = hgraph.HeteroGraph(tiny_hg.node_counts, tiny_hg.features,
                            tiny_hg.relations, name=tiny_hg.name)
    torch.save({"hg": hg, "metapaths": {"tiny": METAPATHS},
                "targets": {"tiny": "M"}, "hgnn": hgnn,
                "lm": {"arch": "granite-8b", "mesh": (1, 2),
                       "params": interop.params_from_numpy(lm_p,
                                                           device="cpu"),
                       "tokens": torch.from_numpy(tokens)}},
               workdir / "inputs.pt.part")
    os.replace(workdir / "inputs.pt.part", workdir / "inputs.pt")
    # the JAX side while the ranks run
    want = {key: fwd() for key, (_, fwd) in jax_cases.items()}
    logits, caches = ref_prefill(lm_p, cfg, jnp.asarray(tokens))
    nxt = np.asarray(logits)[:, -1].argmax(-1)[:, None].astype(np.int32)
    grafted = ref_graft(cfg, ref_init_caches(cfg, 2, 24), caches, 16)
    dec, _ = ref_decode(lm_p, cfg, jnp.asarray(nxt), grafted,
                        jnp.asarray(16, jnp.int32))
    want["granite_decode"] = np.asarray(dec)
    want["granite_next"] = nxt
    want["granite_layers"] = cfg.n_layers
    _, err = proc.communicate(timeout=180)
    assert proc.returncode == 0, err[-4000:]
    return torch.load(workdir / "outputs.pt", weights_only=False), want


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_the_jax_forward(ranks, case):
    got, want = ranks
    g = got["hgnn"][case].numpy()
    w = want[case.split("/")[0]]
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("name", sorted(PARTITIONED))
def test_auto_halo_is_one_all_gather_a_type_and_layer(ranks, name):
    got, _ = ranks
    calls = got["halo_comm"][f"{name}/auto"]
    assert len(calls) == PARTITIONED[name].get("layers", 1)
    for c in calls:
        assert c == {"types": c["types"],
                     "all_gather_into_tensor": c["types"]}, c
    assert torch.equal(got["hgnn"][f"{name}/auto"],
                       got["hgnn"][f"{name}/xla"])


def test_decode_over_a_sequence_sharded_cache_matches_jax(ranks):
    got, want = ranks
    assert np.array_equal(got["granite_next"].numpy(), want["granite_next"])
    # every layer's decode ran the log-sum-exp form on a rank's half of
    # the 24-row cache
    assert len(got["lse_calls"]) == want["granite_layers"]
    assert all(s[1] == 12 for s in got["lse_calls"])
    np.testing.assert_allclose(got["granite_decode"].numpy(),
                               want["granite_decode"], **TOL)
