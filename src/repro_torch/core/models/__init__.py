"""HGNN model zoo (port of ``repro/core/models``).  HAN, RGCN and MAGNN
are ported; GCN is a later slice of the port."""
from repro_torch.configs.base import HGNNConfig
from repro_torch.core.models.han import HAN
from repro_torch.core.models.magnn import MAGNN
from repro_torch.core.models.rgcn import RGCN
from repro_torch.core.pipeline import not_ported

_MODELS = {"han": HAN, "rgcn": RGCN, "magnn": MAGNN}


def get_model(cfg: HGNNConfig):
    if cfg.model in _MODELS:
        return _MODELS[cfg.model](cfg)
    if cfg.model == "gcn":
        raise not_ported("the GCN model", 10)
    raise ValueError(f"unknown HGNN model {cfg.model!r}")
