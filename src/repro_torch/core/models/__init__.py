"""HGNN model zoo (port of ``repro/core/models``): the paper's three HGNNs
(RGCN, HAN, MAGNN) and the GCN comparison baseline."""
from repro_torch.configs.base import HGNNConfig
from repro_torch.core.models.gcn import GCN
from repro_torch.core.models.han import HAN
from repro_torch.core.models.magnn import MAGNN
from repro_torch.core.models.rgcn import RGCN

_MODELS = {"han": HAN, "rgcn": RGCN, "magnn": MAGNN, "gcn": GCN}


def get_model(cfg: HGNNConfig):
    if cfg.model not in _MODELS:
        raise ValueError(f"unknown HGNN model {cfg.model!r}")
    return _MODELS[cfg.model](cfg)
