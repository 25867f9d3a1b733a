"""Port of the configurations and the stage plans: the port's
``HGNNConfig``, LM ``ModelConfig`` family, arch registry and plan
dataclasses against the reference's, and the port's import hygiene (no
jax, no ``repro``, no GPU toolchain)."""
import dataclasses
import subprocess
import sys

import pytest

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro.configs.base import HGNNConfig as RefConfig
from repro.core import plan as ref_plan
from repro_torch.configs import base, registry
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


@pytest.mark.parametrize("name", ["ModelConfig", "MoEConfig", "SSMConfig",
                                  "ShapeConfig"])
def test_lm_config_fields_and_defaults_equal(name):
    assert _fields(getattr(base, name)) == _fields(getattr(ref_base, name))


def test_lm_shapes_and_long_context_equal():
    assert base.SHAPES == {k: base.ShapeConfig(**dataclasses.asdict(v))
                           for k, v in ref_base.SHAPES.items()}
    assert base.LONG_CONTEXT_ARCHS == ref_base.LONG_CONTEXT_ARCHS
    for arch in ref_registry.list_archs():
        assert base.long_context_supported(registry.get_config(arch)) == \
            ref_base.long_context_supported(ref_registry.get_config(arch))


@pytest.mark.parametrize("arch", ref_registry.list_archs())
def test_registry_configs_equal_reference(arch):
    assert registry.list_archs() == ref_registry.list_archs()
    for get, ref_get in ((registry.get_config, ref_registry.get_config),
                         (registry.get_reduced, ref_registry.get_reduced)):
        got, want = get(arch), ref_get(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.resolved_head_dim == want.resolved_head_dim
    kw = dict(n_layers=3, use_pallas=True, dtype="float32")
    assert dataclasses.asdict(registry.get_config(arch).replace(**kw)) == \
        dataclasses.asdict(ref_registry.get_config(arch).replace(**kw))
    with pytest.raises(KeyError):
        registry.get_config("no-such-arch")


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
        "need = {'repro_torch.nn.transformer', 'repro_torch.nn.attention',\n"
        "        'repro_torch.kernels.flash_attention',\n"
        "        'repro_torch.kernels.decode_attention',\n"
        "        'repro_torch.configs.registry',\n"
        "        'repro_torch.configs.granite_8b', 'repro_torch.serve.engine'}\n"
        "assert need <= set(mods), need - set(mods)\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 49
