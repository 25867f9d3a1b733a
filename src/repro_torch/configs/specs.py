"""Abstract inputs and their shardings for every (arch x shape) cell (port
of ``repro/configs/specs.py``).

``input_specs(cfg, shape)`` returns the inputs a step takes as meta
tensors (the port's ``jax.ShapeDtypeStruct``: shape and dtype, no
storage); ``input_shardings`` the matching tree of ``NamedSharding``.
Both follow the shape's kind:

  train   -> {tokens, labels [, extra_embeds | frames]}
  prefill -> {tokens [, extra_embeds | frames]}
  decode  -> {token, pos, caches}   (the KV / SSM caches are inputs)
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import BATCH, MODEL, NamedSharding, P, named
from repro_torch.nn.ssm import MambaCache
from repro_torch.nn.transformer import init_kv_caches, layer_runs


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=getattr(torch, dtype),
                       device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    dt = cfg.dtype
    if shape.kind in ("train", "prefill"):
        out: Dict[str, Any] = {"tokens": _sds((b, s), "int32")}
        if shape.kind == "train":
            out["labels"] = _sds((b, s), "int32")
        if cfg.family == "vlm":
            out["extra_embeds"] = _sds((b, cfg.n_frontend_embeds,
                                        cfg.d_model), dt)
        if cfg.family == "encdec":
            out["frames"] = _sds((b, s, cfg.d_model), dt)
        return out
    # decode: one new token against an s-long cache
    if cfg.family == "encdec":
        from repro_torch.nn.encdec import init_encdec_caches

        caches = init_encdec_caches(cfg, b, s, s, device="meta")
    else:
        caches = init_kv_caches(cfg, b, s, device="meta")
    return {"token": _sds((b, 1), "int32"), "pos": _sds((), "int32"),
            "caches": caches}


def cache_shardings(cfg: ModelConfig, mesh, caches) -> Any:
    """Shardings matching the cache tree (a list a run, or the encdec
    dict): the sequence over ``'model'`` under ``cfg.decode_kv_shard_seq``,
    else the kv heads; Mamba state heads and ``conv_x`` channels over
    ``'model'``."""
    seq = MODEL if cfg.decode_kv_shard_seq else None
    kvh = None if cfg.decode_kv_shard_seq else MODEL
    if isinstance(caches, dict):  # encdec: stacked [L, B, S, KVH, Dh]
        return {k: named(mesh, v.shape, (None, BATCH, seq, kvh, None))
                for k, v in caches.items()}
    out = []
    for (kind, count), c in zip(layer_runs(cfg), caches):
        if isinstance(c, MambaCache):
            out.append(MambaCache(
                state=named(mesh, c.state.shape,
                            (None, BATCH, MODEL, None, None)),
                conv_x=named(mesh, c.conv_x.shape, (None, BATCH, None, MODEL)),
                conv_B=named(mesh, c.conv_B.shape, (None, BATCH, None, None)),
                conv_C=named(mesh, c.conv_C.shape, (None, BATCH, None, None)),
            ))
        else:
            out.append({k: named(mesh, c[k].shape,
                                 (None, BATCH, seq, kvh, None))
                        for k in ("k", "v")})
    return out


def input_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Any:
    out: Dict[str, Any] = {}
    for name, sds in input_specs(cfg, shape).items():
        if name in ("tokens", "labels", "token"):
            out[name] = named(mesh, sds.shape, (BATCH, None))
        elif name in ("extra_embeds", "frames"):
            out[name] = named(mesh, sds.shape, (BATCH, None, None))
        elif name == "pos":
            out[name] = NamedSharding(mesh, P())
        elif name == "caches":
            out[name] = cache_shardings(cfg, mesh, sds)
        else:
            raise KeyError(name)
    return out
