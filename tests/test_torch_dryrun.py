"""The LM records and the dry run of the port against the reference:
``analytic_param_counts`` and ``model_flops`` exactly equal for every
arch and shape, and ``analyze_step`` on a fake 2x4 mesh for the reduced
zamba2 (train, prefill, decode), whose per-rank ``argument_bytes`` equal
the reference's ``compiled.memory_analysis().argument_size_in_bytes`` on
an 8-device host mesh.  Each side runs in a subprocess with a timeout,
the two at once: the port's joins a fake process group (no data moves),
the reference's forces 8 host devices, as ``tests/test_dist.py`` does.  And the dry run's
one-tile counting of the chunked attention's loops equals the full
loops' counts.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.core import characterize as ref_char
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core import characterize
from repro_torch.nn import attention

ENV = {**os.environ, "PYTHONPATH": "src"}
ENV.pop("XLA_FLAGS", None)
CELL = ("zamba2-1.2b", 64, 8)  # reduced config, seq, global batch


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_and_model_flops_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    got = characterize.analytic_param_counts(cfg)
    want = ref_char.analytic_param_counts(ref_cfg)
    assert got == want
    for name, shape in SHAPES.items():
        assert characterize.model_flops(cfg, shape, *got) == \
            ref_char.model_flops(ref_cfg, REF_SHAPES[name], *want), name


def _start(code: str, env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _result(proc: subprocess.Popen, timeout: int = 180) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


def test_dry_run_argument_bytes_equal_the_reference_on_2x4():
    arch, seq, batch = CELL
    port = _start(f"""
        import json
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.configs.registry import get_reduced
        from repro_torch.core.characterize import analyze_step
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.launch.steps import build_step

        dist.init_process_group("fake", world_size=8, rank=0,
                                store=FakeStore())
        mesh = make_smoke_mesh(data=2, model=4)
        cfg = get_reduced("{arch}")
        out = {{}}
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig("s", {seq}, {batch}, kind)
            rep = analyze_step(build_step(cfg, shape, mesh), cfg=cfg,
                               shape=shape, mesh=mesh)
            dev = rep["per_device"]
            out[kind] = dict(args=dev["argument_bytes"],
                             flops=dev["total_flops"],
                             coll=dev["collective_bytes"],
                             bound=rep["roofline"]["bound"])
        dist.destroy_process_group()
        print(json.dumps(out))
    """, ENV)
    ref = _start(f"""
        import json
        import jax
        from repro.configs import get_reduced
        from repro.configs.base import ShapeConfig
        from repro.launch.mesh import make_smoke_mesh
        from repro.launch.steps import build_step

        cfg = get_reduced("{arch}")
        out = {{}}
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig("s", {seq}, {batch}, kind)
            mesh = make_smoke_mesh(data=2, model=4)
            built = build_step(cfg, shape, mesh)
            c = jax.jit(built.fn, in_shardings=built.in_shardings,
                        out_shardings=built.out_shardings,
                        donate_argnums=built.donate).lower(
                *built.in_specs).compile()
            out[kind] = c.memory_analysis().argument_size_in_bytes
        print(json.dumps(out))
    """, dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    port, ref = _result(port), _result(ref)  # the two ran at once
    for kind in ("train", "prefill", "decode"):
        assert port[kind]["args"] == ref[kind], (kind, port[kind], ref[kind])
        assert port[kind]["flops"] > 0
        assert port[kind]["bound"] in ("compute", "memory", "collective")
    # the step's layout moves data: the train step reduces its gradients
    assert port["train"]["coll"] > 0


def test_meta_tile_loops_count_what_the_full_loops_count(monkeypatch):
    """On meta tensors the chunked attention runs one tile of each loop
    and counts it for all (``attention._tiles``); the counts equal those
    of the loops run tile by tile."""
    def record():
        q = torch.empty(2, 2, 2, 64, 8, device="meta")
        k = torch.empty(2, 2, 64, 8, device="meta")
        with characterize.Recorder() as rec:
            out, lse = attention._fwd_scan(q, k, k, True, 0, 16, 16, 0.3)
            attention._bwd_scan(q, k, k, out, lse, out, True, 0, 16, 16,
                                0.3)
        return rec.report()

    one_tile = record()
    monkeypatch.setattr(attention, "_tiles",
                        lambda total, step, meta: range(0, total, step))
    every_tile = record()
    for key in ("total_flops", "total_hbm_bytes", "op_counts"):
        assert one_tile[key] == every_tile[key], key
    assert one_tile["op_counts"]["DM"] == 144
