"""Architecture registry: ``--arch <id>`` -> ModelConfig."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

ARCHS = {
    "arctic-480b": "arctic_480b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "internvl2-76b": "internvl2_76b",
    "mamba2-2.7b": "mamba2_2p7b",
    "granite-8b": "granite_8b",
    "smollm-360m": "smollm_360m",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "zamba2-1.2b": "zamba2_1p2b",
}


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


def list_archs() -> List[str]:
    return sorted(ARCHS)
