"""Every padded HGNN plan of the port on a device mesh of one rank (a gloo
group of one, ``HashStore``), on the CPU: HAN bucketed and at two layers,
RGCN padded and bucketed, MAGNN uncached and with hot rows, HAN, RGCN and
MAGNN partitioned at K = 4, and HAN with the async schedule (the serial
forward on a mesh, as in the reference), each on the plain and the kernel
arm.  The logits are bitwise the mesh-less forward's with no c10d
collective, and the mesh-less forward holds to the JAX forward at 1e-5 on
the JAX weights.  Also: the CLI on a one-rank mesh with ``--partitions``
and ``--degree-buckets``, ``stage_records`` of a partitioned mesh forward
(halo bytes and cut edges as off the mesh), the refusal of a sampled plan,
and the decode kernel's log-sum-exp form (its plain version and its tile
emulation against ``kernels/ref.decode_partial``, the plain arm's partial
over a rank's shard of a sequence-sharded cache).  Two ranks:
``tests/test_torch_mesh_plans_gloo.py``.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor.debug import CommDebugMode

from repro.configs.base import HGNNConfig as RefConfig
from repro.core.models import get_model as ref_get_model
from repro.data import synthetic as ref_syn
from repro_torch import interop
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import hgraph
from repro_torch.data import synthetic as syn
from repro_torch.dist import partition as dpart
from repro_torch.dist import sharding
from repro_torch.dist.sharding import distribute_tree, use_mesh
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ref as kref
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.serve import build_hgnn_infer, hgnn_shardings

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(dataset="tiny", hidden=16, n_heads=4, n_classes=3,
             attn_hidden=8, max_degree=16)
# chip_smoke.py's phase 9d plans, at the tiny size
PLANS = {
    "han_bucketed": dict(model="han", fused=True, degree_buckets=3),
    "han_layers2": dict(model="han", fused=True, layers=2),
    "rgcn_padded": dict(model="rgcn", fused=True),
    "rgcn_bucketed": dict(model="rgcn", fused=True, degree_buckets=3),
    "magnn": dict(model="magnn"),
    "han_partitioned": dict(model="han", fused=True, partitions=4),
    "rgcn_partitioned": dict(model="rgcn", fused=True, partitions=4),
    "magnn_partitioned": dict(model="magnn", partitions=4),
    "magnn_cached": dict(model="magnn", cache_rows=8),
    "han_overlap": dict(model="han", fused=True, overlap=2),
}


@pytest.fixture(autouse=True)
def _tiny_tables(monkeypatch):
    for mod in (ref_syn, syn):
        monkeypatch.setitem(mod.DATASET_METAPATHS, "tiny",
                            [["M", "D", "M"], ["M", "A", "M"]])
        monkeypatch.setitem(mod.DATASET_TARGET, "tiny", "M")


@pytest.fixture
def one_rank():
    """A gloo group of one rank and a ``(1, 1)`` mesh over it."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_smoke_mesh(data=1, model=1)
    finally:
        dist.destroy_process_group()


def _port_hg(hg):
    return hgraph.HeteroGraph(hg.node_counts, hg.features, hg.relations,
                              name=hg.name)


_JAX: dict = {}


def _jax_case(tiny_hg, name):
    """The JAX weights and logits of a plan (made once a module)."""
    if name not in _JAX:
        m = ref_get_model(RefConfig(**SMALL, **PLANS[name]))
        b = m.prepare(tiny_hg)
        p = m.init(jax.random.key(0), b)
        _JAX[name] = (p, np.asarray(m.forward(p, b)))
    return _JAX[name]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_on_a_one_rank_mesh_is_bitwise_the_meshless_forward(
        tiny_hg, one_rank, name, use_pallas):
    ref_p, want = _jax_case(tiny_hg, name)
    cfg = HGNNConfig(**SMALL, **PLANS[name], use_pallas=use_pallas)
    hg = _port_hg(tiny_hg)
    params = interop.params_from_numpy(ref_p, device="cpu")
    plain = build_hgnn_infer(cfg, hg, "cpu")
    comm = CommDebugMode()
    with comm, torch.inference_mode():
        meshed = build_hgnn_infer(cfg, hg, "cpu", mesh=one_rank)
        p_sh, _ = hgnn_shardings(meshed.plan, params, meshed.batch, one_rank)
        got = meshed.fn(distribute_tree(params, p_sh), meshed.batch)
        direct = plain.fn(params, plain.batch)
    assert comm.get_total_counts() == 0, comm.get_comm_counts()
    assert type(got).__name__ == "DTensor"
    assert torch.equal(got.full_tensor(), direct)
    np.testing.assert_allclose(direct.numpy(), want, **TOL)


@pytest.mark.parametrize("flags,tag", [
    (("--partitions", "2"), "na=gat/stacked +partitions=2"),
    (("--degree-buckets", "3"), "na=gat/bucketed")])
def test_cli_runs_the_plan_on_a_one_rank_mesh(tiny_hg, monkeypatch, capsys,
                                               flags, tag):
    """``--mesh-data 1`` with ``--partitions`` or ``--degree-buckets``:
    the forward on a ``(1, 1)`` mesh over a gloo group of one rank that the
    CLI joins and leaves; ``--characterize`` prints the stage lines of the
    mesh forward (a ``gather_halo`` line when partitioned).  The tiny
    graph stands in for IMDB (the same node types and metapaths)."""
    from repro_torch.launch import serve as cli

    monkeypatch.setattr(syn, "make_dataset", lambda name: _port_hg(tiny_hg))
    monkeypatch.setattr("sys.argv", [
        "serve", "--hgnn", "han", "--dataset", "imdb", "--use-pallas",
        "--device", "cpu", "--iters", "1", "--mesh-data", "1",
        "--characterize", *flags])
    cli.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].startswith(f"han/imdb [{tag}] logits (40, 8) on "
                               "{'data': 1, 'model': 1}: ")
    stages = [ln.split(":")[0].strip() for ln in lines[2:]]
    assert stages[:2] == ["FP", "gather_halo" if "partitions" in tag
                          else "NA"]
    assert not dist.is_initialized()


@pytest.mark.parametrize("model", ["han", "rgcn", "magnn"])
def test_stage_records_of_a_partitioned_mesh_forward(tiny_hg, one_rank,
                                                     model):
    kw = dict(SMALL, **PLANS[f"{model}_partitioned"], layers=2)
    cfg = HGNNConfig(**kw)
    hg = _port_hg(tiny_hg)
    plain = build_hgnn_infer(cfg, hg, "cpu")
    meshed = build_hgnn_infer(cfg, hg, "cpu", mesh=one_rank)
    want = plain.executor.stage_records(plain.params, plain.batch)
    with use_mesh(one_rank):
        got = meshed.executor.stage_records(meshed.params, meshed.batch)
    names = [n for n in want["stages"] if n.endswith("gather_halo")]
    assert names == ["L1.gather_halo", "L2.gather_halo"]
    assert [n for n in got["stages"] if n.endswith("gather_halo")] == names
    for n in names:
        for key in ("halo_bytes", "cut_edges"):
            assert got["stages"][n][key] == want["stages"][n][key] > 0
    assert got["partition"] == want["partition"]
    for n, rec in want["stages"].items():  # the recorder sees global shapes
        assert (got["stages"][n]["flops"], got["stages"][n]["hbm_bytes"]) \
            == (rec["flops"], rec["hbm_bytes"]), n


def test_sampled_plan_is_refused_on_a_mesh(tiny_hg, one_rank):
    cfg = HGNNConfig(**SMALL, model="han", fused=True, fanout=4)
    with pytest.raises(ValueError, match="does not combine with a device "
                                         "mesh") as err:
        build_hgnn_infer(cfg, _port_hg(tiny_hg), "cpu", mesh=one_rank)
    assert "item 19" not in str(err.value)


@pytest.mark.parametrize("mode", dpart.HALO_MODES)
def test_gather_halo_modes_are_the_flat_gather_off_a_mesh(mode):
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.standard_normal((4, 5, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 20, (4, 6)).astype(np.int32))
    want = h.reshape(20, 3)[idx.long()]
    assert torch.equal(dpart.gather_halo(h, idx, mode=mode), want)


def test_the_schedule_refuses_a_mesh(tiny_hg, one_rank):
    cfg = HGNNConfig(**SMALL, **PLANS["han_overlap"], degree_buckets=3)
    built = build_hgnn_infer(cfg, _port_hg(tiny_hg), "cpu", mesh=one_rank)
    with use_mesh(one_rank), pytest.raises(ValueError, match="one device"):
        built.executor.forward_overlapped(built.params, built.batch)


def test_local_runs_trees_on_the_local_shards(one_rank):
    """``dist.sharding.local`` takes trees in and out: every DTensor leaf
    as it is laid out, the outputs laid out as asked (one list for every
    leaf, or a tuple a leaf), the gradient back through the shards."""
    from torch.distributed.tensor import Replicate, Shard

    rows = [Shard(0), Replicate()]
    whole = [Replicate(), Replicate()]
    x = torch.arange(12.0).reshape(4, 3)
    w = torch.full((3,), 0.5)
    with use_mesh(one_rank):
        xd = distribute_tree(x, sharding.named(one_rank, x.shape, ("data",)))
        wd = distribute_tree(w, sharding.named(one_rank, w.shape, ()))
        xd.requires_grad_(True)

        def body(tabs, scale):
            y = tabs["x"] * tabs["w"] * scale
            return {"y": y, "n": scale}, [y.sum(dim=1)]

        (out, (s,)) = sharding.local(body, ({"x": xd, "w": wd}, 2), None,
                                     rows)
        assert out["n"] == 2 and list(out["y"].placements) == rows
        assert list(s.placements) == rows
        assert torch.equal(out["y"].full_tensor(), x * w * 2)
        out["y"].sum().backward()
        assert torch.equal(xd.grad.full_tensor(), torch.full((4, 3), 1.0))
        (y2, s2) = sharding.local(lambda a: (a, a.sum(dim=1)), (xd,),
                                  (("data", None),), (rows, whole))
        assert list(y2.placements) == rows and list(s2.placements) == whole


def test_local_refuses_an_input_laid_out_otherwise(one_rank):
    with use_mesh(one_rank):
        x = distribute_tree(torch.ones(4, 3),
                            sharding.named(one_rank, (4, 3), ()))
        with pytest.raises(ValueError, match="laid out as"):
            sharding.local(lambda a: a, (x,), (("data", None),),
                           list(x.placements))


def _decode_inputs(seed, b, s, h, kvh, dh):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return t(b, h, dh), t(b, s, kvh, dh), t(b, s, kvh, dh)


@pytest.mark.parametrize("shape,kv_len", [
    ((3, 200, 8, 2, 16), (0, 77, 200)),  # G 4, a row with no live row
    ((2, 64, 4, 4, 8), (64, 0)),  # G 1, one whole split
    ((2, 130, 32, 8, 128), (129, 1)),  # granite's heads, ragged tiles
    ((1, 9, 2, 1, 5), (9,)),  # odd Dh, one tile and a row
])
def test_decode_lse_form_matches_the_partial(shape, kv_len):
    b, s, h, kvh, dh = shape
    q, k, v = _decode_inputs(sum(shape), b, s, h, kvh, dh)
    lens = torch.tensor(kv_len, dtype=torch.int32)
    want_o, want_lse = kref.decode_partial(q, k, v, lens)
    for o, lse in (kref.decode_attention(q, k, v, lens, return_lse=True),
                   tdec.decode_attention(q, k, v, lens, return_lse=True),
                   tdec.decode_attention_emulate(q, k, v, lens,
                                                 return_lse=True)):
        np.testing.assert_allclose(o.numpy(), want_o.numpy(), **TOL)
        np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **TOL)
        dead = lens == 0
        assert torch.all(o[dead] == 0)
        assert torch.all(lse[dead] == -1e30)
    # the form's o is the kernel's o (the emulation's, bit for bit)
    assert torch.equal(tdec.decode_attention_emulate(q, k, v, lens),
                       tdec.decode_attention_emulate(
                           q, k, v, lens, return_lse=True)[0])
