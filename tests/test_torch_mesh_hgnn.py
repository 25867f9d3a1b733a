"""Stage-aware sharded HGNN inference in the port, without a process
group: ``hgnn_shardings`` equal to the reference's leaf by leaf on a
``(data=2, model=4)`` duck mesh (the reference's on an ``AbstractMesh``)
for HAN, RGCN and MAGNN on the tiny graph (each plan's rule tables:
stacked, bucketed, per-relation, instance and partitioned), the stage
functions and executor off a mesh bitwise what they were,
``build_hgnn_infer(mesh=None)`` unchanged, and the ``csr`` refusal.  Two
real ranks: ``tests/test_torch_mesh_gloo.py``; every other plan on a mesh:
``tests/test_torch_mesh_plans.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import HGNNConfig as RefConfig
from repro.core.models import get_model as ref_get_model
from repro.core.stages import HGNN_STAGE_SPECS as REF_STAGE_SPECS
from repro.data import synthetic as ref_syn
from repro.launch.serve import hgnn_shardings as ref_hgnn_shardings
from repro_torch import interop, tree
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph, plan as plan_mod, stages
from repro_torch.core.models import get_model
from repro_torch.data import synthetic as syn
from repro_torch.launch.serve import build_hgnn_infer, hgnn_shardings

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             attn_hidden=8, max_degree=16)
CASES = {
    "han_stacked": dict(model="han", fused=True),
    "han_bucketed": dict(model="han", fused=True, degree_buckets=3),
    "han_partitioned": dict(model="han", fused=True, partitions=2),
    "han_stacked_l2": dict(model="han", fused=True, layers=2),
    "rgcn_padded": dict(model="rgcn", fused=True),
    "rgcn_bucketed": dict(model="rgcn", fused=True, degree_buckets=3),
    "magnn": dict(model="magnn"),
    "magnn_partitioned": dict(model="magnn", partitions=2),
}


class FakeMesh(NamedTuple):
    axis_names: tuple
    shape: dict


MESH_2x4 = FakeMesh(("data", "model"), {"data": 2, "model": 4})


@pytest.fixture(autouse=True)
def _tiny_tables(monkeypatch):
    for mod in (ref_syn, syn):
        monkeypatch.setitem(mod.DATASET_METAPATHS, "tiny",
                            [["M", "D", "M"], ["M", "A", "M"]])
        monkeypatch.setitem(mod.DATASET_TARGET, "tiny", "M")


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


def _specs(shardings):
    return [tuple(s.spec) for s in tree.leaves(shardings)]


def _ref_specs(shardings):
    return [tuple(s.spec) for s in jax.tree.leaves(shardings)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_hgnn_shardings_equal_the_reference(tiny_hg, case):
    kw = dict(SMALL, **CASES[case])
    ref_m = ref_get_model(RefConfig(**kw))
    ref_b = ref_m.prepare(tiny_hg)
    ref_p = ref_m.init(jax.random.key(0), ref_b)
    m = get_model(HGNNConfig(**kw))
    b = m.prepare(_port_hg(tiny_hg), device="cpu")
    p = interop.params_from_numpy(ref_p, device="cpu")
    plan, ref_plan = m.plan(), ref_m.plan()
    assert plan.batch_specs == ref_plan.batch_specs
    assert plan.param_specs == ref_plan.param_specs
    assert plan.shards_on_mesh == ref_plan.shards_on_mesh
    p_sh, b_sh = hgnn_shardings(plan, p, b, MESH_2x4)
    rp_sh, rb_sh = ref_hgnn_shardings(ref_plan, ref_p, ref_b,
                                      AbstractMesh((2, 4), ("data", "model")))
    assert _specs(p_sh) == _ref_specs(rp_sh)
    assert _specs(b_sh) == _ref_specs(rb_sh)
    # something shards: the FP weights over 'model', destination tables
    # over 'data' (the partitioned layout's K = 2 over 'data')
    assert any("model" in s for s in _specs(p_sh))
    assert any("data" in s for s in _specs(b_sh))


def test_stage_specs_and_rule_sets_are_the_reference():
    from repro.core import plan as ref_plan

    assert stages.HGNN_STAGE_SPECS == REF_STAGE_SPECS
    for name in ("STACKED_BATCH_SPECS", "BUCKETED_BATCH_SPECS",
                 "RELATION_BATCH_SPECS", "INSTANCE_BATCH_SPECS",
                 "PARTITION_BATCH_SPECS"):
        assert getattr(plan_mod, name) == getattr(ref_plan, name), name


@pytest.mark.parametrize("kind", ["gat", "mean"])
def test_sharded_stage_functions_off_a_mesh_are_the_plain_ones(kind):
    rng = np.random.default_rng(5)
    n, k, heads, dh = 12, 4, 2, 3
    nbr = torch.from_numpy(rng.integers(0, n, (n, k)).astype(np.int32))
    mask = torch.from_numpy((rng.random((n, k)) > 0.3).astype(np.float32))
    if kind == "gat":
        h = torch.from_numpy(rng.standard_normal((n, heads, dh)).astype(
            np.float32))
        p = {"a_dst": torch.from_numpy(rng.standard_normal(
                 (heads, dh)).astype(np.float32)),
             "a_src": torch.from_numpy(rng.standard_normal(
                 (heads, dh)).astype(np.float32))}
        want = stages.gat_aggregate_padded(p, h, h, nbr, mask)
        got = stages.gat_aggregate_padded_sharded(p, h, h, nbr, mask)
    else:
        h = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32))
        want = stages.mean_aggregate_padded(h, nbr, mask)
        got = stages.mean_aggregate_padded_sharded(h, nbr, mask)
    assert torch.equal(got, want)
    feats = {"M": torch.from_numpy(rng.standard_normal((n, 6)).astype(
        np.float32))}
    w = {"M": torch.from_numpy(rng.standard_normal((6, 4)).astype(
        np.float32))}
    assert torch.equal(stages.feature_projection_sharded(w, feats)["M"],
                       stages.feature_projection(w, feats)["M"])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_build_hgnn_infer_without_a_mesh_is_the_forward(tiny_hg,
                                                        use_pallas):
    kw = dict(SMALL, model="han", fused=True, use_pallas=use_pallas,
              fuse_na_sa=use_pallas)
    ref_m = ref_get_model(RefConfig(**kw))
    ref_b = ref_m.prepare(tiny_hg)
    ref_p = ref_m.init(jax.random.key(0), ref_b)
    want = np.asarray(ref_m.forward(ref_p, ref_b))
    built = build_hgnn_infer(HGNNConfig(**kw), _port_hg(tiny_hg), "cpu")
    p = interop.params_from_numpy(ref_p, device="cpu")
    with torch.inference_mode():
        got = built.fn(p, built.batch)
        direct = built.executor.forward(p, built.batch)
    assert not hasattr(got, "placements")
    assert torch.equal(got, direct)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_csr_plan_is_refused_on_a_mesh(tiny_hg):
    with pytest.raises(ValueError, match="padded NA layout"):
        build_hgnn_infer(HGNNConfig(**SMALL, model="han", fused=False),
                         _port_hg(tiny_hg), "cpu", mesh=MESH_2x4)


@pytest.mark.parametrize("flags", [("--mesh-data", "1"),
                                   ("--mesh-model", "1")])
def test_cli_runs_on_a_one_rank_mesh(tiny_hg, monkeypatch, capsys, flags):
    """``--mesh-data`` or ``--mesh-model`` alone runs the ``--hgnn``
    forward on a ``(1, 1)`` mesh over a gloo group of one rank, which the
    CLI joins and leaves; the line names the mesh in place of
    ``single-device``, and ``--fanout`` is refused on a mesh.  The tiny
    graph stands in for IMDB (the same node types and metapaths)."""
    import torch.distributed as dist

    from repro_torch.launch import serve as cli

    monkeypatch.setattr(syn, "make_dataset", lambda name: _port_hg(tiny_hg))
    base = ["serve", "--hgnn", "han", "--dataset", "imdb", "--use-pallas",
            "--fuse-na-sa", "--device", "cpu", "--iters", "1", *flags]
    monkeypatch.setattr("sys.argv", base)
    cli.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu (host CPU)"
    assert lines[1].startswith(
        "han/imdb [na=gat/stacked +fused-sa] logits (40, 8) on "
        "{'data': 1, 'model': 1}: ")
    assert not dist.is_initialized()
    monkeypatch.setattr("sys.argv", base + ["--fanout", "4"])
    with pytest.raises(SystemExit, match="does not combine"):
        cli.main()
    assert not dist.is_initialized()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_one_rank_mesh_moves_nothing(tiny_hg, use_pallas):
    """On a ``(1, 1)`` mesh over a gloo group of one rank, laying HAN's
    parameters and batch out and running its forward issue no c10d
    collective (each rank cuts its shard from its own full tensor; DTensor
    skips size-1 mesh dims), and the logits are bitwise the mesh-less
    forward's."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.mesh import make_smoke_mesh

    cfg = HGNNConfig(**SMALL, model="han", fused=True, use_pallas=use_pallas,
                     fuse_na_sa=use_pallas)
    hg = _port_hg(tiny_hg)
    plain = build_hgnn_infer(cfg, hg, "cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        comm = CommDebugMode()
        with comm, torch.inference_mode():
            meshed = build_hgnn_infer(cfg, hg, "cpu",
                                      mesh=make_smoke_mesh(data=1, model=1))
            got = meshed.fn(meshed.params, meshed.batch)
            want = plain.fn(plain.params, plain.batch)
        assert comm.get_total_counts() == 0, comm.get_comm_counts()
        assert torch.equal(got.full_tensor(), want)
    finally:
        dist.destroy_process_group()
