"""Elastic restart in the port, against the JAX package, in one process.

``train/elastic.surviving_mesh`` on abstract meshes against the
reference's (on a ``jax.sharding.Mesh`` of one repeated CPU device, which
the reference's function takes as it takes any device grid), and its two
guards.  On a one-rank gloo group (``HashStore``): the reduced granite's
state laid out by ``state_shardings`` and saved from the mesh (``save``
and ``AsyncCheckpointer``) is byte-equal to the mesh-less save, ``.npz``
and manifest; ``restore(shardings=)`` gives it back bitwise in fp32 and
bf16; the reference's ``restore`` reads the port's fp32 mesh checkpoint
and the port restores the reference's checkpoints onto the mesh;
``reshard_state`` onto another mesh moves bytes, never values, and issues
no collective; a train step on the survivors' mesh is bitwise the
mesh-less step; ``HGNNServeEngine`` serves replicated parameters bitwise
and refuses a sharded one.  Four ranks: ``tests/test_torch_elastic_gloo.
py``.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced as ref_get_reduced
from repro.data import synthetic as ref_syn
from repro.train import checkpoint as ref_ckpt
from repro.train import elastic as ref_elastic
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch import tree
from repro_torch.configs.base import HGNNConfig, ShapeConfig
from repro_torch.configs.registry import get_reduced
from repro_torch.core import hgraph
from repro_torch.core.models import get_model
from repro_torch.data import synthetic as syn
from repro_torch.dist.sharding import Mesh, NamedSharding, P, is_dtensor
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.serve.engine import HGNNRequest, HGNNServeEngine
from repro_torch.serve.faults import Fault, FaultInjector
from repro_torch.serve.sampler import HGNNSampler
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import reshard_state, surviving_mesh
from repro_torch.train.optimizer import build_optimizer
from repro_torch.train.train_step import make_train_step, state_shardings

ARCH = "granite-8b"
# the reference test's serving config (tests/test_elastic_hgnn.py)
SERVE = dict(model="han", dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             fanout=64, max_degree=48, fused=True, partitions=2)


# ---------------------------------------------------------------------------
# surviving_mesh on abstract meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,failed", [
    ((2, 2, 2), [0]), ((2, 2, 2), [1]),       # one pod lost of two
    ((4, 2, 2), [0, 1, 3]),                    # three of four
    ((4, 2, 2), [2]),                          # one of four: pods stay
    ((2, 16, 16), [1]),                        # the production mesh
])
def test_surviving_mesh_matches_the_reference(shape, failed):
    names = ("pod", "data", "model")
    dev = jax.devices("cpu")[0]
    grid = np.array([dev] * int(np.prod(shape)), dtype=object)
    want = ref_elastic.surviving_mesh(
        jax.sharding.Mesh(grid.reshape(shape), names), failed)
    mesh = (make_production_mesh(multi_pod=True) if shape == (2, 16, 16)
            else Mesh(names, shape))
    got = surviving_mesh(mesh, failed)
    assert got.device_mesh is None
    assert got.axis_names == tuple(want.axis_names)
    assert tuple(got.shape.values()) == want.devices.shape


def test_surviving_mesh_guards():
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2))
    with pytest.raises(RuntimeError, match="no surviving pods"):
        surviving_mesh(mesh, failed_pods=[0, 1])
    with pytest.raises(ValueError, match="multi-pod mesh"):
        surviving_mesh(Mesh(("data", "model"), (4, 2)), failed_pods=[0])


# ---------------------------------------------------------------------------
# one gloo rank: checkpoints of a state on a mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def group():
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape=(1, 1), names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh.from_device_mesh(init_device_mesh("cpu", shape,
                                                  mesh_dim_names=names))


def _granite(dtype):
    """The reduced granite's reference state and config in ``dtype``, and
    the port's copy of the state."""
    jcfg = ref_get_reduced(ARCH)
    jcfg = dataclasses.replace(jcfg, dtype=dtype, param_dtype=dtype)
    jo = ref_opt.build_optimizer(jcfg)
    jstate = ref_ts.init_train_state(jax.random.key(0), jcfg, jo)
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=dtype,
                              param_dtype=dtype)
    return jstate, cfg, state_from_numpy(jstate, "cpu")


def _bits(x):
    """A leaf's dtype name and bytes (a bf16 one as its 16-bit patterns)."""
    if is_dtensor(x):
        x = x.full_tensor()
    if torch.is_tensor(x):
        name = str(x.dtype).split(".")[-1]
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return name, x.numpy().tobytes()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.view(np.int16).tobytes()
    return a.dtype.name, a.tobytes()


def _files(root, step):
    d = os.path.join(root, f"step_{step:08d}")
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _on_mesh(cfg, state, mesh):
    sh = state_shardings(state, build_optimizer(cfg), mesh)
    return reshard_state(state, sh), sh


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_save_is_byte_equal_to_the_mesh_less_save(group, tmp_path,
                                                       dtype):
    _, cfg, state = _granite(dtype)
    laid, _ = _on_mesh(cfg, state, _mesh())
    assert all(is_dtensor(x) for x in tree.leaves(laid))
    ckpt.save(state, str(tmp_path / "plain"), step=3)
    ckpt.save(laid, str(tmp_path / "mesh"), step=3)
    saver = ckpt.AsyncCheckpointer(str(tmp_path / "async"))
    saver.submit(laid, 3)
    saver.close()
    want = _files(str(tmp_path / "plain"), 3)
    assert sorted(want) == ["manifest.json", "shard_00000.npz"]
    assert _files(str(tmp_path / "mesh"), 3) == want
    assert _files(str(tmp_path / "async"), 3) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_onto_a_mesh_is_bitwise(group, tmp_path, dtype):
    _, cfg, state = _granite(dtype)
    laid, sh = _on_mesh(cfg, state, _mesh())
    ckpt.save(laid, str(tmp_path), step=5)
    got = ckpt.restore(str(tmp_path), state, shardings=sh)
    assert type(got).__name__ == "TrainState"
    for a, b, s in zip(tree.leaves(got), tree.leaves(state),
                       tree.leaves(sh)):
        assert is_dtensor(a)
        assert tuple(a.placements) == tuple(s.placements())
        assert _bits(a) == _bits(b)


def test_reference_restores_the_port_mesh_checkpoint(group, tmp_path):
    jstate, cfg, state = _granite("float32")
    laid, _ = _on_mesh(cfg, state, _mesh())
    ckpt.save(laid, str(tmp_path), step=2)
    got = ref_ckpt.restore(str(tmp_path), jstate)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_restores_the_reference_checkpoint_onto_a_mesh(group, tmp_path,
                                                           dtype):
    jstate, cfg, state = _granite(dtype)
    ref_ckpt.save(jstate, str(tmp_path), step=4)
    sh = state_shardings(state, build_optimizer(cfg), _mesh())
    got = ckpt.restore(str(tmp_path), state, shardings=sh)
    for a, b in zip(tree.leaves(got), jax.tree.leaves(jstate)):
        assert is_dtensor(a) and _bits(a) == _bits(b)


def test_restore_takes_shardings_or_device_not_both(group, tmp_path):
    _, cfg, state = _granite("float32")
    ckpt.save(state, str(tmp_path), step=1)
    sh = state_shardings(state, build_optimizer(cfg), _mesh())
    with pytest.raises(ValueError, match="not both"):
        ckpt.restore(str(tmp_path), state, shardings=sh, device="cpu")


def test_reshard_state_onto_another_mesh_moves_bytes_not_values(group):
    """A state on a ``(pod=1, data=1, model=1)`` mesh moved onto its
    survivors' ``(data, model)`` mesh (the collapse): every leaf on the
    new mesh as ``state_shardings`` lays it out there, bitwise, and no
    collective."""
    from torch.distributed.tensor.debug import CommDebugMode

    _, cfg, state = _granite("float32")
    pods = _mesh((1, 1, 1), ("pod", "data", "model"))
    laid, _ = _on_mesh(cfg, state, pods)
    small = surviving_mesh(pods, failed_pods=[])
    assert small.axis_names == ("data", "model")
    assert small.device_mesh is not None
    sh = state_shardings(state, build_optimizer(cfg), small)
    comm = CommDebugMode()
    with comm:
        moved = reshard_state(laid, sh)
    assert comm.get_total_counts() == 0, comm.get_comm_counts()
    for a, b, s in zip(tree.leaves(moved), tree.leaves(state),
                       tree.leaves(sh)):
        assert a.device_mesh == small.device_mesh
        assert tuple(a.placements) == tuple(s.placements())
        assert _bits(a) == _bits(b)


def test_train_step_on_the_survivors_mesh_is_bitwise_the_meshless(group):
    from repro_torch.launch.steps import build_train_step, jit_step

    _, cfg, state = _granite("float32")
    small = surviving_mesh(_mesh((1, 1, 1), ("pod", "data", "model")), [])
    laid = reshard_state(state, state_shardings(
        state, build_optimizer(cfg), small))
    rng = np.random.default_rng(11)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(
        np.int32)) for k in ("tokens", "labels")}
    step = jit_step(build_train_step(cfg, ShapeConfig("t", 16, 4, "train"),
                                     small))
    got, gm = step(laid, batch)
    want, wm = make_train_step(cfg, build_optimizer(cfg))(state, batch)
    for key in ("loss", "grad_norm"):
        assert torch.equal(gm[key].full_tensor(), wm[key])
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert _bits(a) == _bits(b)


# ---------------------------------------------------------------------------
# HGNNServeEngine on replicated parameters
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny(tiny_hg, monkeypatch):
    for mod in (ref_syn, syn):
        monkeypatch.setitem(mod.DATASET_METAPATHS, "tiny",
                            [["M", "D", "M"], ["M", "A", "M"]])
        monkeypatch.setitem(mod.DATASET_TARGET, "tiny", "M")
    return hgraph.HeteroGraph(tiny_hg.node_counts, tiny_hg.features,
                              tiny_hg.relations, name=tiny_hg.name)


def _serve(cfg, hg, params, injector=None):
    m = get_model(cfg)
    eng = HGNNServeEngine(m.executor, params, HGNNSampler(m.plan(), cfg, hg),
                          slots=2, slot_targets=2, injector=injector)
    eng.warmup()
    rng = np.random.default_rng(3)
    reqs = [HGNNRequest(targets=rng.integers(0, 40, size=int(
        rng.integers(1, 9)))) for _ in range(6)]
    eng.serve(reqs)
    assert all(r.status == "OK" for r in reqs), [r.status for r in reqs]
    return eng, [r.logits for r in reqs]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_engine_serves_replicated_parameters_bitwise(group, tiny,
                                                     use_pallas):
    """The collapse on one rank: parameters replicated on a ``(pod=1,
    data=1, model=1)`` mesh, then resharded onto ``surviving_mesh(...,
    [])``, serve the logits of the plain parameters, with and without a
    partition loss; the engine runs on the rank's device."""
    cfg = HGNNConfig(**SERVE, use_pallas=use_pallas)
    m = get_model(cfg)
    params = m.init(torch.Generator().manual_seed(0),
                    m.prepare(tiny, device="cpu"))
    _, want = _serve(cfg, tiny, params)
    pods = _mesh((1, 1, 1), ("pod", "data", "model"))

    def replicated(mesh):
        return tree.map(lambda _: NamedSharding(mesh, P()), params)

    full = reshard_state(params, replicated(pods))
    small = surviving_mesh(pods, failed_pods=[])
    moved = reshard_state(full, replicated(small))
    assert all(is_dtensor(x) and x.device_mesh == small.device_mesh
               for x in tree.leaves(moved) if torch.is_tensor(x))
    eng, got = _serve(cfg, tiny, moved)
    assert eng.device == torch.device("cpu")
    assert not any(is_dtensor(x) for x in tree.leaves(eng.params))
    fault = FaultInjector([Fault(step=2, kind="partition", partition=1)])
    eng_f, failed_over = _serve(cfg, tiny, moved, fault)
    assert eng_f.stats()["resilience"]["partition_failovers"] == 1
    for a, b, c in zip(got, want, failed_over):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)


def test_engine_refuses_a_sharded_parameter(group, tiny):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    cfg = HGNNConfig(**SERVE)
    m = get_model(cfg)
    params = dict(m.init(torch.Generator().manual_seed(0),
                         m.prepare(tiny, device="cpu")))
    mesh = _mesh()
    params["cls"] = tree.map(lambda x: distribute_tensor(
        x, mesh.device_mesh, [Shard(0), Replicate()], src_data_rank=None),
        params["cls"])
    with pytest.raises(ValueError, match="serves replicated parameters"):
        HGNNServeEngine(m.executor, params, HGNNSampler(m.plan(), cfg, tiny),
                        slots=2, slot_targets=2)


def test_replicated_reference_weights_serve_as_the_jax_engine(group, tiny):
    """The reference's weights (``params_from_numpy``) replicated on a mesh:
    the port's engine serves the reference engine's logits at 1e-5."""
    from repro.configs.base import HGNNConfig as RefConfig
    from repro.core.hgraph import HeteroGraph as RefGraph
    from repro.core.models import get_model as ref_get_model
    from repro.serve.engine import HGNNRequest as RefRequest
    from repro.serve.engine import HGNNServeEngine as RefEngine
    from repro.serve.sampler import HGNNSampler as RefSampler

    ref_hg = RefGraph(tiny.node_counts, tiny.features, tiny.relations,
                      name=tiny.name)
    rcfg = RefConfig(**SERVE)
    rm = ref_get_model(rcfg)
    rp = rm.init(jax.random.key(0), rm.prepare(ref_hg))
    ref_eng = RefEngine(rm.executor, rp, RefSampler(rm.plan(), rcfg, ref_hg),
                        slots=2, slot_targets=2,
                        fn=jax.jit(rm.executor.forward))
    ref_eng.warmup()
    rng = np.random.default_rng(3)
    reqs = [RefRequest(targets=rng.integers(0, 40, size=int(
        rng.integers(1, 9)))) for _ in range(6)]
    ref_eng.serve(reqs)
    params = params_from_numpy(rp, device="cpu")
    mesh = _mesh()
    moved = reshard_state(params, tree.map(
        lambda _: NamedSharding(mesh, P()), params))
    _, got = _serve(HGNNConfig(**SERVE), tiny, moved)
    for a, r in zip(got, reqs):
        np.testing.assert_allclose(a, r.logits, atol=1e-5, rtol=1e-5)
