"""Encoder-decoder transformer, the seamless-m4t backbone (port of
``repro/nn/encdec.py``).

The encoder takes precomputed audio frame embeddings (``frames [B, Ss,
d]``: the modality frontend is a stub, as in the reference) through
bidirectional self-attention; the decoder runs causal self-attention (with
a KV cache when serving), cross-attention over the encoder's output (its
keys and values projected once a layer, rope-free) and a SwiGLU MLP.  Both
sides are stacks ``[L, ...]`` made by the reference's
``init_encdec_params`` layout (``embed``, ``enc``, ``dec``, ``ln_enc``,
``ln_f``, ``lm_head``), so ``interop.params_from_numpy`` carries the
reference's tree across one to one.  A Python loop over the layers
replaces ``lax.scan``; ``encode`` and ``decode_train`` put each layer under
``cfg.remat`` (``nn/transformer.py``'s ``_remat``), as the reference does.

Attention paths are ``nn/attention.py``'s: under ``cfg.use_pallas`` the
encoder's and the decoder's self-attention and the prefill's
cross-attention (``Sq != Sk``) run the ``flash_attention`` kernel, and the
decoder's self-attention decodes through ``decode_attention``.  The
cross-attention of a decode step is ``ref.decode_attention`` on either
arm (``attention.decode_attend`` with ``use_pallas=False``), as in the
reference (``:189-195``), which reaches no Pallas kernel there: that step
mirrors the reference, it does not fall back from a kernel.  A decode
step writes the new self-attention key and value into the cache in
place.  On a mesh the reference's ``shard`` sites hold (``:70-96``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import BATCH, gather_seq, merge_heads, shard
from repro_torch.interop import DeviceLike, resolve_device
from repro_torch.nn import attention as attn
from repro_torch.nn.mlp import init_mlp, mlp_block, normal
from repro_torch.nn.norm import init_rmsnorm, rmsnorm
from repro_torch.nn.transformer import (_embed_inputs, _layer, _remat,
                                        _unbind, chunked_ce, stacked)


def _enc_block_init(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {"ln1": init_rmsnorm(d, gen.device),
            "attn": attn.init_attention(gen, cfg),
            "ln2": init_rmsnorm(d, gen.device),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.n_layers,
                            getattr(torch, cfg.param_dtype))}


def _dec_block_init(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {"ln1": init_rmsnorm(d, gen.device),
            "self_attn": attn.init_attention(gen, cfg),
            "ln2": init_rmsnorm(d, gen.device),
            "cross_attn": attn.init_attention(gen, cfg),
            "ln3": init_rmsnorm(d, gen.device),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.n_layers,
                            getattr(torch, cfg.param_dtype))}


def init_encdec_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random weights drawn on ``gen``'s device with the reference's
    distributions (embed ``N(0, 0.02^2)``, lm_head ``N(0, 1/d)``, the
    blocks of ``nn/attention.py`` and ``nn/mlp.py``), each layer straight
    into its slot of the ``enc`` / ``dec`` stack."""
    d, v = cfg.d_model, cfg.vocab
    pd = getattr(torch, cfg.param_dtype)
    return {
        "embed": normal(gen, (v, d), 0.02, pd),
        "enc": stacked(gen, cfg.enc_layers,
                       lambda g: _enc_block_init(g, cfg)),
        "dec": stacked(gen, cfg.dec_layers,
                       lambda g: _dec_block_init(g, cfg)),
        "ln_enc": init_rmsnorm(d, gen.device),
        "ln_f": init_rmsnorm(d, gen.device),
        "lm_head": normal(gen, (d, v), d ** -0.5, pd),
    }


def _enc_layer(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    eps = cfg.norm_eps
    x = x + attn.attention_block(p["attn"], cfg, rmsnorm(p["ln1"], x, eps),
                                 positions, causal=False)
    return x + mlp_block(p["mlp"], rmsnorm(p["ln2"], x, eps))


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """``frames [B, Ss, d]`` -> encoder hidden ``[B, Ss, d]``
    (bidirectional)."""
    x = shard(frames.to(getattr(torch, cfg.dtype)), BATCH, None, None)
    positions = torch.arange(x.shape[1], device=x.device)
    layer = _remat(_enc_layer, cfg.remat)
    for p in _unbind(params["enc"], cfg.enc_layers):
        x = layer(p, cfg, x, positions)
    return rmsnorm(params["ln_enc"], x, cfg.norm_eps)


def _cross_kv(p: Dict, cfg: ModelConfig, enc_out: torch.Tensor):
    """The cross-attention's keys and values of the encoder's output,
    ``[B, Ss, KVH, Dh]`` each, rope-free."""
    _, kvh = attn._heads(cfg)
    return tuple(attn._project(enc_out, p[w], kvh, cfg, None, False)
                 for w in ("wk", "wv"))


def _dec_layer(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               enc_out: torch.Tensor, positions: torch.Tensor,
               return_kv: bool = False):
    """One decoder layer of the full target sequence: causal
    self-attention, cross-attention over ``enc_out``, the MLP.  Returns
    ``x``, or with ``return_kv`` ``(x, self (k, v), cross (k, v))``."""
    eps = cfg.norm_eps
    h, kv_self = attn.attention_block(p["self_attn"], cfg,
                                      rmsnorm(p["ln1"], x, eps), positions,
                                      causal=True, return_kv=True)
    x = x + h
    kv_cross = _cross_kv(p["cross_attn"], cfg, enc_out)
    x = x + attn.attention_block(p["cross_attn"], cfg,
                                 rmsnorm(p["ln2"], x, eps), positions,
                                 causal=False, kv_override=kv_cross,
                                 use_rope=False)
    x = x + mlp_block(p["mlp"], rmsnorm(p["ln3"], x, eps))
    return (x, kv_self, kv_cross) if return_kv else x


def decode_train(params, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass -> hidden ``[B, St, d]``."""
    x = _embed_inputs(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    layer = _remat(_dec_layer, cfg.remat)
    for p in _unbind(params["dec"], cfg.dec_layers):
        x = layer(p, cfg, x, enc_out, positions)
    return x


def encdec_forward(params, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Logits ``[B, St, V]`` of the target tokens given the frames."""
    h = decode_train(params, cfg, tokens, encode(params, cfg, frames))
    return rmsnorm(params["ln_f"], gather_seq(h), cfg.norm_eps) @ \
        params["lm_head"]


def encdec_loss(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """batch: ``frames [B, Ss, d]``, ``tokens [B, St]``, ``labels [B, St]``
    (-1 = pad).  The mean cross-entropy of the unmasked tokens
    (``transformer.chunked_ce``)."""
    h = decode_train(params, cfg, batch["tokens"],
                     encode(params, cfg, batch["frames"]))
    h = rmsnorm(params["ln_f"], gather_seq(h), cfg.norm_eps)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    chunk_tokens = max(8, int(2 ** 24 / max(cfg.vocab, 1)))
    return chunked_ce(h, params["lm_head"], torch.clamp(labels, min=0), mask,
                      chunk_tokens)


# ---------------- serving ----------------


def encdec_prefill(params, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor):
    """Encode + teacher-forced prefix -> ``(last logits [B, 1, V],
    caches)``; ``caches`` holds ``self_k`` / ``self_v`` ``[L, B, St, KVH,
    Dh]`` (after RoPE) and ``cross_k`` / ``cross_v`` ``[L, B, Ss, KVH,
    Dh]``."""
    enc_out = encode(params, cfg, frames)
    x = _embed_inputs(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    per_layer = []
    for j in range(cfg.dec_layers):
        x, kv_self, kv_cross = _dec_layer(_layer(params["dec"], j), cfg, x,
                                          enc_out, positions, return_kv=True)
        per_layer.append(kv_self + kv_cross)
    caches = {name: torch.stack([c[i] for c in per_layer])
              for i, name in enumerate(("self_k", "self_v", "cross_k",
                                        "cross_v"))}
    h = rmsnorm(params["ln_f"], gather_seq(x)[:, -1:], cfg.norm_eps)
    return h @ params["lm_head"], caches


def init_encdec_caches(cfg: ModelConfig, batch: int, max_len: int,
                       src_len: int, device: DeviceLike = None) -> Dict:
    """Zeroed decode caches on ``device`` (default: the CUDA device; there
    is no silent CPU fallback): ``self_k`` / ``self_v`` ``[L, B, max_len,
    KVH, Dh]``, ``cross_k`` / ``cross_v`` ``[L, B, src_len, KVH, Dh]``."""
    dh = cfg.resolved_head_dim
    _, kvh = attn._heads(cfg)
    dt = getattr(torch, cfg.dtype)
    device = resolve_device(device)
    L = cfg.dec_layers
    shape = {"self_k": max_len, "self_v": max_len, "cross_k": src_len,
             "cross_v": src_len}
    return {name: torch.zeros((L, batch, s, kvh, dh), dtype=dt,
                              device=device)
            for name, s in shape.items()}


def graft_encdec_caches(cfg: ModelConfig, prefill: Dict, max_len: int
                        ) -> Dict:
    """``encdec_prefill``'s caches written into zeroed decode caches of
    ``max_len`` target rows (``init_encdec_caches``, on the prefill's
    device) at rows ``[0, St)``, as the reference's
    ``dynamic_update_slice`` does (``examples/serve_decode.py``)."""
    _, b, src_len = prefill["cross_k"].shape[:3]
    caches = init_encdec_caches(cfg, b, max_len, src_len,
                                prefill["cross_k"].device)
    for name, t in prefill.items():
        caches[name][:, :, :t.shape[2]] = t
    return caches


def encdec_decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                       caches: Dict, pos):
    """``token [B, 1]``; ``caches`` as ``graft_encdec_caches`` makes
    them, whose self-attention rows this step
    writes in place; ``pos`` an int or a 0-d device tensor.  Returns
    ``(logits [B, 1, V], caches)``."""
    x = _embed_inputs(params, cfg, token)  # [B, 1, d]
    eps = cfg.norm_eps
    b = x.shape[0]
    h, _ = attn._heads(cfg)
    src_len = caches["cross_k"].shape[2]
    step = attn.decode_step(cfg, pos, b, caches["self_k"].shape[2], x.device)
    for j in range(cfg.dec_layers):
        p = _layer(params["dec"], j)
        o, _, _ = attn.decode_attention_block(
            p["self_attn"], cfg, rmsnorm(p["ln1"], x, eps),
            caches["self_k"][j], caches["self_v"][j], step)
        x = x + o
        # cross-attention: the rope-free query over the static cross KV
        q = attn._project(rmsnorm(p["ln2"], x, eps), p["cross_attn"]["wq"],
                          h, cfg, None, False)[:, 0]
        o = attn.decode_attend(cfg, q, caches["cross_k"][j],
                               caches["cross_v"][j], src_len, False)
        x = x + merge_heads(o[:, None]) @ p["cross_attn"]["wo"]
        x = x + mlp_block(p["mlp"], rmsnorm(p["ln3"], x, eps))
    return rmsnorm(params["ln_f"], x, eps) @ params["lm_head"], caches
