"""The port's mesh layer against the reference's, without a process group:
``resolve_spec`` case for case with ``tests/test_sharding_unit.py`` on
duck meshes, ``shard`` off a mesh, ``use_mesh`` nesting, ``placements``,
and, for every config of the registry at full size on the production
meshes (16x16 and 2x16x16), the resolved spec of every leaf of
``param_specs``, ``state_shardings`` (AdamW and Adafactor),
``input_shardings`` and ``cache_shardings`` equal to the reference's
(the reference resolves on a ``jax.sharding.AbstractMesh``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import specs as ref_specs
from repro.dist.param_sharding import param_specs as ref_param_specs
from repro.train import optimizer as ref_opt
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import state_shardings as ref_state_shardings
from repro_torch import tree
from repro_torch.configs import specs
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.dist import sharding
from repro_torch.dist.param_sharding import param_specs
from repro_torch.dist.sharding import (BATCH, MODEL, P, current_mesh,
                                       resolve_spec, shard, use_mesh)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import _params_abstract
from repro_torch.nn.mlp import MetaGenerator
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import init_train_state, state_shardings


class FakeMesh(NamedTuple):
    """Just enough mesh surface for resolve_spec (axis_names + shape)."""

    axis_names: tuple
    shape: dict


MESH_2x4 = FakeMesh(("data", "model"), {"data": 2, "model": 4})
UNIT = FakeMesh(("data", "model"), {"data": 1, "model": 1})


# ---------------------------------------------------------------------------
# resolve_spec, case for case with the reference's unit tests
# ---------------------------------------------------------------------------

RESOLVE_CASES = [
    ((8, 16), (), MESH_2x4, P()),
    ((8, 16, 32), ("data",), MESH_2x4, P("data")),
    ((8,), ("data", "model"), MESH_2x4, P("data")),
    ((8, 15), (None, "model"), MESH_2x4, P(None, None)),
    ((7, 16), ("data", "model"), MESH_2x4, P(None, "model")),
    ((8, 16), (("pod", "data"), None), MESH_2x4, P("data", None)),
    ((8,), ("pod",), MESH_2x4, P(None)),
    ((16,), ((("pod", "data"), "model"),), MESH_2x4, P(("data", "model"))),
    ((8,), (("data", "model"),), MESH_2x4, P(("data", "model"))),
    ((12,), (("data", "model"),), MESH_2x4, P(None)),
    ((7, 13), ("data", "model"), UNIT, P("data", "model")),
    ((7,), (BATCH,), UNIT, P("data")),
    ((8, 16), (BATCH, MODEL), MESH_2x4, P("data", "model")),
]


@pytest.mark.parametrize("shape,spec,mesh,want", RESOLVE_CASES)
def test_resolve_spec_as_the_reference(shape, spec, mesh, want):
    from repro.dist.sharding import resolve_spec as ref_resolve

    got = resolve_spec(shape, spec, mesh)
    assert got == want
    assert tuple(got) == tuple(ref_resolve(shape, spec, mesh))


def test_shard_is_a_noop_off_a_mesh_and_on_plain_tensors():
    x = torch.ones(4, 4)
    assert current_mesh() is None
    assert shard(x, BATCH, MODEL) is x
    with use_mesh(MESH_2x4):  # a duck mesh: a plain tensor passes through
        assert shard(x, BATCH, MODEL) is x


def test_use_mesh_nests_and_restores():
    with use_mesh(MESH_2x4) as m1:
        assert current_mesh() is m1
        with use_mesh(UNIT):
            assert current_mesh() is UNIT
        assert current_mesh() is m1
    assert current_mesh() is None


def test_placements_name_the_sharded_dim_a_mesh_axis():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh(("pod", "data", "model"),
                    {"pod": 2, "data": 16, "model": 16})
    spec = resolve_spec((64, 32, 8), (BATCH, None, MODEL), mesh)
    assert spec == P(("pod", "data"), None, None)  # 8 % 16: replicated
    assert sharding.placements(spec, mesh) == [Shard(0), Shard(0),
                                               Replicate()]
    assert sharding.placements(P(None, "model"), MESH_2x4) == [
        Replicate(), Shard(1)]
    with pytest.raises(ValueError):
        sharding.placements(P("model", "model"), MESH_2x4)


def test_production_mesh_without_a_fake_group_is_abstract():
    for mp, want in ((False, {"data": 16, "model": 16}),
                     (True, {"pod": 2, "data": 16, "model": 16})):
        mesh = make_production_mesh(multi_pod=mp)
        assert mesh.shape == want and mesh.device_mesh is None
        assert mesh.size == (512 if mp else 256)


# ---------------------------------------------------------------------------
# every config at full size, leaf by leaf against the reference
# ---------------------------------------------------------------------------

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_mesh(name):
    return AbstractMesh(*MESHES[name])


def _mesh(name):
    shape, axes = MESHES[name]
    return sharding.Mesh(axes, shape)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_get_config(arch)
    if cfg.family == "encdec":
        from repro.nn.encdec import init_encdec_params as init
    else:
        from repro.nn.transformer import init_lm_params as init
    return jax.eval_shape(lambda: init(jax.random.key(0), cfg))


def _same_specs(port, ref, what):
    got = tree.leaves(port)
    want = jax.tree.leaves(ref)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, sharding.NamedSharding), (what, i)
        assert tuple(g.spec) == tuple(w.spec), (what, i, g.spec, w.spec)


def _same_shapes(port, ref, what):
    got = [tuple(x.shape) for x in tree.leaves(port)]
    want = [tuple(x.shape) for x in jax.tree.leaves(ref)]
    assert got == want, what


@pytest.mark.parametrize("arch", list_archs())
def test_param_and_state_specs_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    params = _params_abstract(cfg)
    ref_params = _ref_params(arch)
    _same_shapes(params, ref_params, "params")
    states = {}
    for which in ("adamw", "adafactor"):
        o = getattr(opt, which)(lambda s: 1e-3)
        ro = getattr(ref_opt, which)(lambda s: 1e-3)
        # the reference's init_train_state on the weights already traced
        ref_state = RefTrainState(jax.ShapeDtypeStruct((), np.int32),
                                  ref_params,
                                  jax.eval_shape(ro.init, ref_params))
        states[which] = (o, init_train_state(MetaGenerator(), cfg, o), ro,
                         ref_state)
        _same_shapes(states[which][1], ref_state, f"state {which}")
    for name in MESHES:
        mesh, ref_mesh = _mesh(name), _ref_mesh(name)
        for fsdp in (cfg.fsdp, not cfg.fsdp):
            _same_specs(
                param_specs(params, mesh, fsdp=fsdp,
                            fsdp_experts=cfg.fsdp_experts),
                ref_param_specs(ref_params, ref_mesh, fsdp=fsdp,
                                fsdp_experts=ref_cfg.fsdp_experts),
                f"param_specs {name} fsdp={fsdp}")
        for which, (o, state, ro, ref_state) in states.items():
            _same_specs(
                state_shardings(state, o, mesh, fsdp=cfg.fsdp,
                                fsdp_experts=cfg.fsdp_experts),
                ref_state_shardings(ref_state, ro, ref_mesh,
                                    fsdp=ref_cfg.fsdp,
                                    fsdp_experts=ref_cfg.fsdp_experts),
                f"state_shardings {which} {name}")


@pytest.mark.parametrize("arch", list_archs())
def test_input_and_cache_shardings_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for shape_name, shape in SHAPES.items():
        ref_shape = REF_SHAPES[shape_name]
        ins = specs.input_specs(cfg, shape)
        ref_ins = ref_specs.input_specs(ref_cfg, ref_shape)
        _same_shapes(ins, ref_ins, f"input_specs {shape_name}")
        assert [x.dtype for x in tree.leaves(ins)] == [
            getattr(torch, np.dtype(x.dtype).name) if np.dtype(
                x.dtype).name != "bfloat16" else torch.bfloat16
            for x in jax.tree.leaves(ref_ins)]
        for name in MESHES:
            mesh, ref_mesh = _mesh(name), _ref_mesh(name)
            _same_specs(specs.input_shardings(cfg, shape, mesh),
                        ref_specs.input_shardings(ref_cfg, ref_shape,
                                                  ref_mesh),
                        f"input_shardings {shape_name} {name}")
            if shape.kind == "decode":
                _same_specs(
                    specs.cache_shardings(cfg, mesh, ins["caches"]),
                    ref_specs.cache_shardings(ref_cfg, ref_mesh,
                                              ref_ins["caches"]),
                    f"cache_shardings {shape_name} {name}")
