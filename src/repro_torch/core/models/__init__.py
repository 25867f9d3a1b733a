"""HGNN model zoo (port of ``repro/core/models``).  HAN and RGCN are
ported; MAGNN and GCN are later slices of the port."""
from repro_torch.configs.base import HGNNConfig
from repro_torch.core.models.han import HAN
from repro_torch.core.models.rgcn import RGCN
from repro_torch.core.pipeline import not_ported

_LATER = {"magnn": ("MAGNN", 9), "gcn": ("GCN", 10)}


def get_model(cfg: HGNNConfig):
    if cfg.model == "han":
        return HAN(cfg)
    if cfg.model == "rgcn":
        return RGCN(cfg)
    if cfg.model in _LATER:
        name, item = _LATER[cfg.model]
        raise not_ported(f"the {name} model", item)
    raise ValueError(f"unknown HGNN model {cfg.model!r}")
