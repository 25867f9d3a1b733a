"""Decoder-only transformer, dense family (port of the serving part of
``repro/nn/transformer.py``).

Layers are stacked ``[L, ...]`` tensors, one stack per homogeneous run
(``layer_runs``), as in the reference, so a parameter tree made by the
reference's ``init_lm_params`` carries across one to one
(``interop.params_from_numpy``).  A Python loop over the layers replaces
``lax.scan``.  The KV cache is preallocated ``[L, B, S, KVH, Dh]``; prefill
writes it per layer and each decode step writes one row in place.

Public entry points: ``init_lm_params``, ``lm_forward``, ``lm_prefill``,
``init_kv_caches`` + ``graft_prefill_caches``, ``lm_decode_step``.  The MoE,
SSM, hybrid and VLM families, and training (``lm_loss``), are not ported
yet (ROADMAP Queue 1 item 17).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.interop import resolve_device
from repro_torch.nn import attention as attn
from repro_torch.nn.mlp import init_mlp, mlp_block, normal
from repro_torch.nn.norm import init_rmsnorm, rmsnorm


def layer_runs(cfg: ModelConfig) -> List[Tuple[str, int]]:
    fam = cfg.family
    if fam == "dense":
        return [("attn", cfg.n_layers)]
    if fam in ("moe", "ssm", "hybrid", "vlm"):
        raise NotImplementedError(
            f"layer_runs: the {fam} family is not ported yet (ROADMAP Queue "
            "1 item 17); the port runs the dense family")
    raise ValueError(f"layer_runs: unsupported family {fam}")


def _init_block(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {
        "ln1": init_rmsnorm(d, gen.device),
        "attn": attn.init_attention(gen, cfg),
        "ln2": init_rmsnorm(d, gen.device),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.n_layers,
                        getattr(torch, cfg.param_dtype)),
    }


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(stack: Dict, j: int) -> Dict:
    """Layer ``j`` of a stacked run (views)."""
    return _map(lambda x: x[j], stack)


def init_lm_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random weights drawn on ``gen``'s device, in fp32 and then cast to
    ``cfg.param_dtype``, with the reference's distributions: embed ``N(0,
    0.02^2)``, lm_head ``N(0, 1/d)``, the block weights of
    ``nn/attention.py`` and ``nn/mlp.py``.  Each layer is drawn straight
    into its slot of the stack, so a full-size model is never held twice."""
    d, v = cfg.d_model, cfg.vocab
    pd = getattr(torch, cfg.param_dtype)
    params: Dict = {
        "embed": normal(gen, (v, d), 0.02, pd),
        "ln_f": init_rmsnorm(d, gen.device),
        "runs": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(gen, (d, v), d ** -0.5, pd)
    for kind, count in layer_runs(cfg):
        first = _init_block(gen, cfg)
        stack = _map(lambda x: x.new_empty((count,) + x.shape), first)
        for j in range(count):
            block = first if j == 0 else _init_block(gen, cfg)
            _copy_into(_layer(stack, j), block)
        params["runs"].append(stack)
    return params


def _copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(x.numel() for x in _leaves(params))


# ---------------------------------------------------------------------------
# full-sequence forward (prefill trunk)
# ---------------------------------------------------------------------------


def _embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor
                  ) -> torch.Tensor:
    x = params["embed"].index_select(0, tokens.reshape(-1))
    return x.reshape(*tokens.shape, -1).to(getattr(torch, cfg.dtype))


def lm_backbone(params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, causal: bool = True,
                collect_kv: bool = False):
    """Run all layer runs.  Returns ``(hidden, aux, kv_caches | None)``;
    with ``collect_kv`` each run's keys and values (after RoPE) are written
    into one ``[L, B, S, KVH, Dh]`` pair per run."""
    caches = [] if collect_kv else None
    eps = cfg.norm_eps
    for (kind, count), stack in zip(layer_runs(cfg), params["runs"]):
        kv = None
        for j in range(count):
            p = _layer(stack, j)
            h, (k, v) = attn.attention_block(
                p["attn"], cfg, rmsnorm(p["ln1"], x, eps), positions, causal,
                return_kv=True)
            x = x + h
            x = x + mlp_block(p["mlp"], rmsnorm(p["ln2"], x, eps))
            if collect_kv:
                if kv is None:
                    kv = {"k": k.new_empty((count,) + k.shape),
                          "v": v.new_empty((count,) + v.shape)}
                kv["k"][j] = k
                kv["v"][j] = v
        if collect_kv:
            caches.append(kv)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, caches


def lm_logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head  # [B, S, V]


def lm_forward(params, cfg: ModelConfig, tokens: torch.Tensor):
    x = _embed_inputs(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    h, aux, _ = lm_backbone(params, cfg, x, positions)
    return lm_logits(params, cfg, h), aux


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode
# ---------------------------------------------------------------------------


def init_kv_caches(cfg: ModelConfig, batch: int, max_len: int,
                   device=None) -> List[Dict]:
    """Zeroed decode caches ``[L, B, S, KVH, Dh]`` per run on ``device``
    (default: the CUDA device; there is no silent CPU fallback); ``S`` is
    ``min(max_len, window)`` under a sliding window (a ring)."""
    dh = cfg.resolved_head_dim
    _, kvh = attn._heads(cfg)
    dt = getattr(torch, cfg.dtype)
    device = resolve_device(device)
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return [{"k": torch.zeros((count, batch, s, kvh, dh), dtype=dt,
                              device=device),
             "v": torch.zeros((count, batch, s, kvh, dh), dtype=dt,
                              device=device)}
            for _, count in layer_runs(cfg)]


def graft_prefill_caches(cfg: ModelConfig, skeleton, prefill, t0: int):
    """Place the prefill KV (length ``t0``) into the decode caches, in
    place, and return them.

    Under a sliding window the cache is a ring: slot ``r`` holds the newest
    prompt position ``p = r (mod W)``; a slot with no valid position stays
    zero (``kv_len`` masks it until it is overwritten)."""
    for sk, pf in zip(skeleton, prefill):
        smax = sk["k"].shape[2]
        if not cfg.sliding_window:
            for name in ("k", "v"):
                sk[name][:, :, :t0] = pf[name]
            continue
        r = torch.arange(smax, device=sk["k"].device)
        p = (t0 - 1) - ((t0 - 1 - r) % smax)
        valid = (p >= 0) & (p > t0 - 1 - smax)
        src = torch.clamp(p, 0, t0 - 1)
        for name in ("k", "v"):
            g = pf[name].index_select(2, src).to(sk[name].dtype)
            sk[name].copy_(torch.where(valid[None, None, :, None, None], g,
                                       0))
    return skeleton


def lm_prefill(params, cfg: ModelConfig, tokens: torch.Tensor):
    """Full-sequence forward returning the last position's logits ``[B, 1,
    V]`` and the caches."""
    x = _embed_inputs(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    h, _, caches = lm_backbone(params, cfg, x, positions, collect_kv=True)
    return lm_logits(params, cfg, h[:, -1:]), caches


def lm_decode_step(params, cfg: ModelConfig, token: torch.Tensor, caches,
                   pos):
    """``token [B, 1]``; ``caches`` from ``init_kv_caches`` (grafted), which
    this step writes in place; ``pos`` an int or a 0-d device tensor.
    Returns ``(logits [B, 1, V], caches)``."""
    x = _embed_inputs(params, cfg, token)  # [B, 1, d]
    eps = cfg.norm_eps
    for (kind, count), stack, cache in zip(layer_runs(cfg), params["runs"],
                                           caches):
        step = attn.decode_step(cfg, pos, x.shape[0], cache["k"].shape[2],
                                x.device)
        for j in range(count):
            p = _layer(stack, j)
            h, _, _ = attn.decode_attention_block(
                p["attn"], cfg, rmsnorm(p["ln1"], x, eps), cache["k"][j],
                cache["v"][j], step)
            x = x + h
            x = x + mlp_block(p["mlp"], rmsnorm(p["ln2"], x, eps))
    return lm_logits(params, cfg, x), caches
