"""Elastic restart on the card, at a tiny size (``chip_smoke.py`` phase
10's checks).  On a 1-rank NCCL mesh: the reduced smollm's state laid out
by ``reshard_state(state, state_shardings(...))`` trains through
``launch/steps.build_train_step`` / ``jit_step`` (compiled, the state
donated) bitwise the mesh-less
``make_train_step`` with the same ``segment_sum`` launches; saved from the
mesh after two steps (``AsyncCheckpointer``) it is byte-equal to the
mesh-less save, restores with ``restore(shardings=)`` onto the mesh that
``surviving_mesh`` leaves of a ``(pod=1, data=1, model=1)`` mesh, and two
more steps there are bitwise an uninterrupted four-step run.  HAN
partitioned in two under ``use_pallas``, its weights replicated on the
pod mesh and resharded onto the collapsed one, serves the mesh-less
logits with the same launches, a partition loss included.  And the four
gloo ranks of ``tests/test_torch_elastic_gloo.py`` on this machine's
torch (its CPU), with the port's own weights.  Every test needs a CUDA
device and skips without one.  The file imports no jax:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        -m gpu tests/test_torch_elastic_gpu.py
"""
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch import tree
from repro_torch.configs.base import HGNNConfig, ShapeConfig
from repro_torch.configs.registry import get_reduced
from repro_torch.core.hgraph import HeteroGraph
from repro_torch.data import synthetic as syn
from repro_torch.dist.sharding import Mesh, NamedSharding, P, is_dtensor
from repro_torch.kernels import ops
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import reshard_state, surviving_mesh

pytestmark = pytest.mark.gpu
HELPER = Path(__file__).with_name("torch_elastic_ranks.py")
SERVE = dict(model="han", dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             fanout=64, max_degree=48, fused=True, partitions=2)
ARCH = "smollm-360m"


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def group(cuda):
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh.from_device_mesh(init_device_mesh("cuda", shape,
                                                  mesh_dim_names=names))


def _tiny_graph():
    rng = np.random.default_rng(7)
    counts = {"M": 40, "D": 15, "A": 25}
    dims = {"M": 12, "D": 8, "A": 10}
    feats = {t: rng.standard_normal((n, dims[t])).astype(np.float32)
             for t, n in counts.items()}

    def rel(ns, nd, e):
        return sp.csr_matrix((np.ones(e, np.float32),
                              (rng.integers(0, ns, e),
                               rng.integers(0, nd, e))), shape=(ns, nd))

    md, ma = rel(40, 15, 60), rel(40, 25, 80)
    return HeteroGraph(counts, feats, {("M", "md", "D"): md,
                                       ("D", "dm", "M"): md.T.tocsr(),
                                       ("M", "ma", "A"): ma,
                                       ("A", "am", "M"): ma.T.tocsr()},
                       name="tiny")


def _equal(a, b) -> bool:
    if is_dtensor(a):
        a = a.full_tensor()
    if is_dtensor(b):
        b = b.full_tensor()
    return a.dtype == b.dtype and torch.equal(a, b)


def _files(root, step):
    d = os.path.join(root, f"step_{step:08d}")
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_training_checkpoint_and_restart_are_bitwise(group, cuda,
                                                          tmp_path, dtype):
    import dataclasses

    from repro_torch.data.loader import synth_batch
    from repro_torch.launch.steps import build_train_step, jit_step
    from repro_torch.train.optimizer import build_optimizer
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step,
                                              state_shardings)

    cfg = dataclasses.replace(get_reduced(ARCH), dtype=dtype,
                              param_dtype=dtype)
    shape = ShapeConfig("t", 32, 4, "train")
    opt = build_optimizer(cfg)
    state = init_train_state(torch.Generator(device=cuda).manual_seed(0),
                             cfg, opt)
    batches = [{k: torch.as_tensor(v, device=cuda)
                for k, v in synth_batch(cfg, shape, i).items()}
               for i in range(4)]
    mesh = _mesh((1, 1), ("data", "model"))
    step = jit_step(build_train_step(cfg, shape, mesh))
    plain_step = make_train_step(cfg, opt)

    def run(fn, s, todo):
        ops.reset_launch_counts()
        losses = []
        for b in todo:
            s, m = fn(s, b)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        return s, losses, ops.launch_counts()["segment_sum"]

    # jit_step's step donates the state it is given: the mesh run starts
    # from a copy, and a state compared later is copied before a step
    laid = reshard_state(tree.map(torch.clone, state),
                         state_shardings(state, opt, mesh))
    s_plain, l_plain, n_plain = run(plain_step, state, batches[:2])
    s_mesh, l_mesh, n_mesh = run(step, laid, batches[:2])
    assert n_mesh == n_plain == 2
    assert all(_equal(a, b) for a, b in zip(l_mesh, l_plain))
    assert all(_equal(a, b) for a, b in zip(tree.leaves(s_mesh),
                                            tree.leaves(s_plain)))
    saver = ckpt.AsyncCheckpointer(str(tmp_path / "mesh"))
    saver.submit(s_mesh, 2)
    saver.close()
    ckpt.save(s_plain, str(tmp_path / "plain"), step=2)
    assert _files(str(tmp_path / "mesh"), 2) == \
        _files(str(tmp_path / "plain"), 2)

    saved = tree.map(torch.clone, s_mesh)
    whole, l_whole, _ = run(step, s_mesh, batches[2:])
    fresh = surviving_mesh(_mesh((1, 1, 1), ("pod", "data", "model")), [])
    assert fresh.axis_names == ("data", "model")
    back = ckpt.restore(str(tmp_path / "mesh"), state, shardings=
                        state_shardings(state, opt, fresh))
    assert all(_equal(a, b) for a, b in zip(tree.leaves(back),
                                            tree.leaves(saved)))
    assert int(back.step.full_tensor()) == 2
    restarted, l_restart, _ = run(
        jit_step(build_train_step(cfg, shape, fresh)), back, batches[2:])
    assert all(_equal(a, b) for a, b in zip(l_restart, l_whole))
    assert all(_equal(a, b) for a, b in zip(tree.leaves(restarted),
                                            tree.leaves(whole)))


def test_collapse_serve_is_bitwise_with_the_same_launches(group, cuda,
                                                          monkeypatch):
    from repro_torch.core.models import get_model
    from repro_torch.serve.engine import HGNNRequest, HGNNServeEngine
    from repro_torch.serve.faults import Fault, FaultInjector
    from repro_torch.serve.sampler import HGNNSampler

    monkeypatch.setitem(syn.DATASET_METAPATHS, "tiny",
                        [["M", "D", "M"], ["M", "A", "M"]])
    monkeypatch.setitem(syn.DATASET_TARGET, "tiny", "M")
    hg = _tiny_graph()
    cfg = HGNNConfig(**SERVE, use_pallas=True)
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0),
                    m.prepare(hg, device=cuda))

    def serve(p, fault=None):
        eng = HGNNServeEngine(m.executor, p, HGNNSampler(m.plan(), cfg, hg),
                              slots=2, slot_targets=2,
                              injector=FaultInjector([Fault(**fault)])
                              if fault else None)
        eng.warmup()
        rng = np.random.default_rng(3)
        reqs = [HGNNRequest(targets=rng.integers(0, 40, size=int(
            rng.integers(1, 9)))) for _ in range(6)]
        ops.reset_launch_counts()
        eng.serve(reqs)
        torch.cuda.synchronize()
        assert all(r.status == "OK" for r in reqs)
        assert eng.device.type == "cuda"
        return [r.logits for r in reqs], ops.launch_counts()

    want, c_plain = serve(params)
    pods = _mesh((1, 1, 1), ("pod", "data", "model"))
    full = reshard_state(params, tree.map(
        lambda _: NamedSharding(pods, P()), params))
    small = surviving_mesh(pods, failed_pods=[])
    assert small.axis_names == ("data", "model")
    moved = reshard_state(full, tree.map(
        lambda _: NamedSharding(small, P()), params))
    got, c_mesh = serve(moved)
    # one gat_na launch a partition; the partitioned SA runs plain
    assert c_plain["gat_na"] > 0 and c_mesh == c_plain
    lost, _ = serve(moved, dict(step=2, kind="partition", partition=1))
    for a, b, c in zip(got, want, lost):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)


def test_four_gloo_ranks_on_this_torch(cuda, tmp_path, monkeypatch):
    """The ranks of ``tests/test_torch_elastic_gloo.py`` on this machine's
    torch (gloo, its CPU), with the port's own weights: survivors'
    logits bitwise the never-failed run's, the restore onto two ranks
    bitwise, the mesh checkpoints byte-equal to the mesh-less save, the
    distributed launcher's losses those of one process."""
    sys.path.insert(0, str(HELPER.parent))
    from torch_elastic_ranks import POD_CASES

    from repro_torch.core.models import get_model
    from repro_torch.launch import train as launch_train
    from repro_torch.train.optimizer import build_optimizer
    from repro_torch.train.train_step import init_train_state

    launch = ["--arch", ARCH, "--reduced", "--seq-len", "32", "--batch", "4",
              "--steps", "3", "--ckpt-every", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(HELPER), str(tmp_path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        monkeypatch.setitem(syn.DATASET_METAPATHS, "tiny",
                            [["M", "D", "M"], ["M", "A", "M"]])
        monkeypatch.setitem(syn.DATASET_TARGET, "tiny", "M")
        hg = _tiny_graph()
        m = get_model(HGNNConfig(**SERVE))
        params = m.init(torch.Generator().manual_seed(0),
                        m.prepare(hg, device="cpu"))
        cfg = get_reduced("granite-8b")
        state = init_train_state(torch.Generator().manual_seed(0), cfg,
                                 build_optimizer(cfg))
        rng = np.random.default_rng(5)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))
                                     .astype(np.int32))
                 for k in ("tokens", "labels")}
        rng = np.random.default_rng(3)
        requests = [rng.integers(0, 40, size=int(rng.integers(1, 9)))
                    for _ in range(6)]
        torch.save({"hg": hg, "metapaths": {"tiny": [["M", "D", "M"],
                                                     ["M", "A", "M"]]},
                    "targets": {"tiny": "M"},
                    "serve": {"cfg": SERVE, "params": params,
                              "requests": requests},
                    "restore": {"arch": "granite-8b", "state": state,
                                "batch": batch},
                    "launch": launch}, tmp_path / "inputs.pt.part")
        os.replace(tmp_path / "inputs.pt.part", tmp_path / "inputs.pt")
        ckpt.save(state, str(tmp_path / "ck_plain"), step=3)
        argv, buf = sys.argv, io.StringIO()
        try:
            sys.argv = ["train", *launch, "--device", "cpu"]
            with redirect_stdout(buf):
                launch_train.main()
        finally:
            sys.argv = argv
        _, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    got = {r: torch.load(tmp_path / f"outputs_{r}.pt", weights_only=False)
           for r in range(4)}
    for case in got[0]["serve"]:
        served = 0
        for r in range(4):
            rec = got[r]["serve"][case]
            if "survivors" not in rec:
                continue
            served += 1
            for a, b, c in zip(rec["survivors"]["logits"],
                               rec["never_failed"]["logits"],
                               rec["failover"]["logits"]):
                assert torch.equal(a, b) and torch.equal(c, b)
        shape, failed = POD_CASES[case.split("/")[0]]
        assert served == 4 // shape[0] * (shape[0] - len(failed)), case
    for kind in ("sync", "async"):
        assert _files(str(tmp_path / f"ck_{kind}"), 3) == \
            _files(str(tmp_path / "ck_plain"), 3)
    for a, b in zip(tree.leaves(got[2]["restored"]), tree.leaves(state)):
        assert _equal(a, b)

    def losses(lines):
        return [ln.split()[1:6:2] for ln in lines if ln.startswith("step")]

    single = losses(buf.getvalue().splitlines())
    assert len(single) == 3
    for r in (0, 1):
        assert losses(got[r]["launch"]["lines"]) == single
    assert got[0]["launch"]["saves"] == [2, 3]
    assert got[1]["launch"]["saves"] == []
