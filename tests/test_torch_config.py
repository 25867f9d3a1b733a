"""Port of the HGNN configuration and the stage plans: the port's
``HGNNConfig`` and plan dataclasses against the reference's, and the
port's import hygiene (no jax, no ``repro``, no GPU toolchain)."""
import dataclasses
import subprocess
import sys

import pytest

from repro.configs.base import HGNNConfig as RefConfig
from repro.core import plan as ref_plan
from repro_torch.configs.base import HGNNConfig
from repro_torch.core import plan


def _fields(cls):
    return [(f.name, f.default, f.type) for f in dataclasses.fields(cls)]


def test_hgnn_config_fields_and_defaults_equal():
    assert _fields(HGNNConfig) == _fields(RefConfig)
    assert dataclasses.asdict(HGNNConfig()) == dataclasses.asdict(RefConfig())


@pytest.mark.parametrize("kw", [
    dict(layers=2, fuse_na_sa=True, use_pallas=True, fused=True),
    dict(model="rgcn", hidden=16, n_heads=4, seed=3),
    dict(sample_ladder=((8, 64), (32, 256)), fanout=4),
])
def test_hgnn_config_replace_matches_reference(kw):
    got = HGNNConfig().replace(**kw)
    want = RefConfig().replace(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("layers", [0, -2])
def test_hgnn_config_rejects_fewer_than_one_layer(layers):
    with pytest.raises(ValueError):
        RefConfig(layers=layers)
    with pytest.raises(ValueError):
        HGNNConfig(layers=layers)


@pytest.mark.parametrize("name", [
    "FPSpec", "NASpec", "SASpec", "HeadSpec", "PartitionSpec", "SampleSpec",
    "ResidencySpec", "ScheduleSpec", "LayerPlan"])
def test_plan_spec_fields_equal(name):
    assert _fields(getattr(plan, name)) == _fields(getattr(ref_plan, name))


def test_stage_plan_checks_match_reference():
    """Both reject a hidden layer whose NA spec differs from layer 0's, and
    a schedule depth below 1."""
    for mod in (plan, ref_plan):
        na = mod.NASpec(kind="gat", layout="stacked", activation="elu")
        sa = mod.SASpec(kind="attention")
        l0 = mod.LayerPlan(fp=mod.FPSpec(), na=na, sa=sa)
        l1 = mod.LayerPlan(fp=mod.FPSpec(kind="dense"),
                           na=dataclasses.replace(na, use_pallas=True), sa=sa)
        with pytest.raises(ValueError, match="layer-uniform"):
            mod.StagePlan(model="han", target="M", layers=(l0, l1),
                          head=mod.HeadSpec())
        with pytest.raises(ValueError):
            mod.StagePlan(model="han", target="M", layers=(),
                          head=mod.HeadSpec())
        with pytest.raises(ValueError):
            mod.ScheduleSpec(depth=0)
        ok = mod.StagePlan(model="han", target="M", layers=(l0, l0),
                           head=mod.HeadSpec())
        assert ok.n_layers == 2 and ok.na == na and ok.sa == sa


def test_port_imports_no_jax_no_reference_no_toolchain():
    """Importing every module of the port (CLI included) loads no jax, no
    ``repro`` module and no triton, and builds nothing."""
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import repro_torch.launch.serve\n"
        "from repro_torch.kernels import build\n"
        "assert build._lib is None, 'kernels built at import'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
