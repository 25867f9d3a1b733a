"""Elastic restart on four real ranks (gloo on the CPU), held to the JAX
package: the reference's ``tests/test_dist.py::
test_elastic_restore_onto_smaller_mesh`` (the reduced granite's state laid
out on ``(data=2, model=2)``, saved, restored onto ``(data=1, model=2)``
over two of the ranks: bitwise, and one train step there against the JAX
train step), its ``tests/test_elastic_hgnn.py`` pod-loss cases on
``(pod=2, data=2, model=1)`` losing pod 0 and on ``(pod=4, data=1,
model=1)`` losing pods 0, 1 and 3 (the collapse to ``(data, model)``):
HAN partitioned in two, plain and kernel arm, the survivors' logits
bitwise the never-failed run's and the JAX engine's at 1e-5, a partition
loss on the survivors too, and the same on ``(pod=4, ...)`` losing pod 1
(three pods left, the ``'pod'`` axis kept); and ``launch/train.py
--distributed`` on two ranks of a joined group: both ranks print the
single-process run's losses, and only rank 0 saves.

The ranks run in one subprocess (``tests/torch_elastic_ranks.py``, which
imports no jax) with a 180 s timeout, started first: they wait for their
inputs while the fixture makes them with JAX, and run while it computes
the JAX side and the single-process launcher; each case is a test on
their results.
"""
from __future__ import annotations

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HGNNConfig as RefConfig
from repro.configs.registry import get_reduced as ref_get_reduced
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro.serve.engine import HGNNRequest as RefRequest
from repro.serve.engine import HGNNServeEngine as RefEngine
from repro.serve.sampler import HGNNSampler as RefSampler
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch import interop, tree
from repro_torch.core import hgraph
from repro_torch.launch import train as launch_train
from repro_torch.train import checkpoint as ckpt
from torch_elastic_ranks import ARMS, POD_CASES, RESTORE_SMALL

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_GRAD = dict(atol=1e-5, rtol=1e-4)  # tests/test_torch_train.py's
HELPER = Path(__file__).with_name("torch_elastic_ranks.py")
METAPATHS = [["M", "D", "M"], ["M", "A", "M"]]
# the reference test's serving config (tests/test_elastic_hgnn.py)
SERVE = dict(model="han", dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             fanout=64, max_degree=48, fused=True, partitions=2)
ARCH = "granite-8b"
LAUNCH = ["--arch", "smollm-360m", "--reduced", "--seq-len", "32",
          "--batch", "4", "--steps", "3", "--ckpt-every", "2"]


def _requests(n=6, seed=3):
    r = np.random.default_rng(seed)
    return [r.integers(0, 40, size=int(r.integers(1, 9))) for _ in range(n)]


@pytest.fixture(scope="module")
def ranks(tiny_hg, tmp_path_factory):
    """Start the four ranks, hand them the inputs, compute the JAX side and
    the single-process launcher while they run; ``(outputs by rank,
    wants)``."""
    workdir = tmp_path_factory.mktemp("elastic")
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
    rcfg = RefConfig(**SERVE)
    rm = ref_get_model(rcfg)
    rp = rm.init(jax.random.key(0), rm.prepare(tiny_hg))
    jcfg = ref_get_reduced(ARCH)
    jo = ref_opt.build_optimizer(jcfg)
    jstate = ref_ts.init_train_state(jax.random.key(0), jcfg, jo)
    r = np.random.default_rng(5)
    batch = {k: r.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    state = interop.state_from_numpy(jstate, "cpu")
    hg = hgraph.HeteroGraph(tiny_hg.node_counts, tiny_hg.features,
                            tiny_hg.relations, name=tiny_hg.name)
    torch.save({"hg": hg, "metapaths": {"tiny": METAPATHS},
                "targets": {"tiny": "M"},
                "serve": {"cfg": SERVE,
                          "params": interop.params_from_numpy(rp, "cpu"),
                          "requests": _requests()},
                "restore": {"arch": ARCH, "state": state,
                            "batch": {k: torch.from_numpy(v)
                                      for k, v in batch.items()}},
                "launch": LAUNCH},
               workdir / "inputs.pt.part")
    os.replace(workdir / "inputs.pt.part", workdir / "inputs.pt")
    # the JAX side, the mesh-less save and the single-process launcher
    # while the ranks run
    eng = RefEngine(rm.executor, rp, RefSampler(rm.plan(), rcfg, tiny_hg),
                    slots=2, slot_targets=2, fn=jax.jit(rm.executor.forward))
    eng.warmup()
    reqs = [RefRequest(targets=t) for t in _requests()]
    eng.serve(reqs)
    assert all(q.status == "OK" for q in reqs)
    want = {"logits": [q.logits for q in reqs], "jstate": jstate,
            "state": state}
    want["trained"] = jax.jit(ref_ts.make_train_step(jcfg, jo))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    ckpt.save(state, str(workdir / "ck_plain"), step=3)
    argv = sys.argv
    buf = io.StringIO()
    try:
        sys.argv = ["repro_torch.launch.train", *LAUNCH, "--device", "cpu"]
        with redirect_stdout(buf):
            launch_train.main()
    finally:
        sys.argv = argv
    want["launch"] = buf.getvalue().splitlines()
    _, err = proc.communicate(timeout=180)
    assert proc.returncode == 0, err[-4000:]
    got = {r: torch.load(workdir / f"outputs_{r}.pt", weights_only=False)
           for r in range(4)}
    want["workdir"] = workdir
    return got, want


def _bits(x):
    if torch.is_tensor(x):
        x = x.detach()
        name = str(x.dtype).split(".")[-1]
        return name, (x.view(torch.int16) if x.dtype == torch.bfloat16
                      else x).numpy().tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.tobytes()


def _files(root):
    d = os.path.join(root, "step_00000003")
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


# ---------------------------------------------------------------------------
# the reference's test_elastic_restore_onto_smaller_mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_mesh_checkpoint_equals_the_mesh_less_save(ranks, kind):
    got, want = ranks
    assert got[0]["sharded_leaves"] > 0  # the save gathered shards
    wd = str(want["workdir"])
    assert _files(os.path.join(wd, f"ck_{kind}")) == \
        _files(os.path.join(wd, "ck_plain"))


@pytest.mark.parametrize("rank", [r for row in RESTORE_SMALL for r in row])
def test_restore_onto_a_smaller_mesh_is_bitwise(ranks, rank):
    got, want = ranks
    out = got[rank]
    assert out["restored_placements_ok"]
    for a, b in zip(tree.leaves(out["restored"]),
                    tree.leaves(want["state"])):
        assert _bits(a) == _bits(b)
    for r in range(4):
        if r not in (x for row in RESTORE_SMALL for x in row):
            assert "restored" not in got[r]


def test_train_step_on_the_smaller_mesh_matches_jax(ranks):
    got, want = ranks
    jstate, jm = want["trained"]
    g = got[RESTORE_SMALL[0][0]]["trained"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(g[key].numpy(), np.asarray(jm[key]),
                                   **TOL, err_msg=key)
    assert int(g["state"].step) == int(jstate.step) == 1
    for part in ("opt", "params"):
        for a, b in zip(tree.leaves(getattr(g["state"], part)),
                        jax.tree.leaves(getattr(jstate, part))):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(
                b, np.float32), **TOL_GRAD, err_msg=part)
    other = got[RESTORE_SMALL[0][1]]["trained"]
    assert torch.equal(other["loss"], g["loss"])


# ---------------------------------------------------------------------------
# the reference's tests/test_elastic_hgnn.py on four ranks
# ---------------------------------------------------------------------------

SERVE_CASES = sorted(f"{c}/{a}" for c in POD_CASES for a in ARMS)


@pytest.mark.parametrize("case", SERVE_CASES)
def test_surviving_mesh_on_real_ranks(ranks, case):
    got, _ = ranks
    shape, failed = POD_CASES[case.split("/")[0]]
    keep = [p for p in range(shape[0]) if p not in failed]
    grid = np.arange(4).reshape(shape)[keep]
    if len(keep) == 1:
        names, grid = ("data", "model"), grid[0]
    else:
        names = ("pod", "data", "model")
    for r in range(4):
        rec = got[r]["serve"][case]
        assert rec["axis_names"] == names
        assert rec["shape"] == grid.shape
        assert rec["ranks"] == grid.tolist()
        if r in grid:
            assert rec["coordinate"] is not None and rec["on_survivors"]
        else:
            assert rec["coordinate"] is None and "survivors" not in rec


@pytest.mark.parametrize("case", SERVE_CASES)
def test_pod_loss_serving_stays_bit_exact(ranks, case):
    got, want = ranks
    survivors = [r for r in range(4) if "survivors" in got[r]["serve"][case]]
    assert survivors
    for r in survivors:
        rec = got[r]["serve"][case]
        assert rec["leaves_equal"]
        assert rec["survivors"]["device"] == "cpu"
        assert rec["failover"]["failovers"] == 1
        for a, b, c, w in zip(rec["survivors"]["logits"],
                              rec["never_failed"]["logits"],
                              rec["failover"]["logits"], want["logits"]):
            assert torch.equal(a, b) and torch.equal(c, b)
            np.testing.assert_allclose(a.numpy(), w, **TOL)


# ---------------------------------------------------------------------------
# launch/train.py --distributed
# ---------------------------------------------------------------------------


def _losses(lines):
    return [(s[1], s[3], s[5]) for s in (ln.split() for ln in lines)
            if s[0] == "step"]


@pytest.mark.parametrize("rank", [0, 1])
def test_distributed_launcher_prints_the_single_process_losses(ranks, rank):
    got, want = ranks
    out = got[rank]["launch"]
    assert out["lines"][0] == "device: cpu (host CPU)"
    assert _losses(out["lines"]) == _losses(want["launch"])
    assert len(_losses(out["lines"])) == 3
    assert out["still_joined"]  # the caller's group is left to the caller
    # only rank 0 checkpoints: step 2 (--ckpt-every 2) and the last, 3
    assert out["saves"] == ([2, 3] if rank == 0 else [])
    assert "launch" not in got[2] and "launch" not in got[3]
