"""GQA attention of the LM (port of ``repro/nn/attention.py``, self-attention
and decode; the cross-attention of the encdec family and the chunked
path's backward are not ported yet).

Execution paths, one semantics (oracle: ``kernels/ref.py``):

* plain — ``ref.mha_attention`` with materialized scores, up to 1024
  tokens (the reference's plain arm, ``:292-295``);
* chunked — the reference's pure-JAX FlashAttention-2 forward
  (``_fwd_scan``, ``:55-100``): q chunks outside, kv chunks inside, online
  softmax over every chunk pair, above 1024 tokens;
* the hand-written ``flash_attention`` kernel when ``cfg.use_pallas``
  (``ops.flash_attention``: the kernel on a CUDA tensor, the plain oracle
  on a CPU tensor);
* decode — ``ops.decode_attention`` over the KV cache, the kernel under
  ``cfg.use_pallas`` and ``ref.decode_attention`` otherwise.

Layouts: q ``[B, S, H, Dh]``; k/v ``[B, S, KVH, Dh]``.  The reference's
sharding constraints are no-ops on one device and are dropped.  The decode
step writes the new key and value into the cache in place.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.nn.mlp import normal
from repro_torch.nn.rope import apply_rope, rope_tables, rotate

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# chunked flash attention (plain PyTorch, forward only)
# ---------------------------------------------------------------------------


def _chunk_for(s: int, target: int) -> int:
    """Largest chunk <= target that divides s."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _mask(rows, cols, causal: bool, window: int) -> torch.Tensor:
    m = torch.ones(torch.broadcast_shapes(rows.shape, cols.shape),
                   dtype=torch.bool, device=rows.device)
    if causal:
        m &= rows >= cols
    if window:
        m &= rows - cols < window
    return m


def chunked_attention(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Sk, KVH, Dh]
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    chunk_q: int = 1024,
    chunk_k: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over ``[chunk_q, chunk_k]`` score tiles, the
    reference's forward scan: fp32 scores (``* scale`` after the dot), every
    chunk pair visited, ``p`` cast to ``v.dtype`` before ``p @ v``."""
    b, sq, h, dh = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    cq, ck = min(chunk_q, sq), min(chunk_k, sk)
    assert sq % cq == 0 and sk % ck == 0, (sq, cq, sk, ck)
    g = h // kvh
    dev = q.device
    q5 = q.permute(0, 2, 1, 3).reshape(b, kvh, g, sq, dh)
    k4 = k.permute(0, 2, 1, 3)
    v4 = v.permute(0, 2, 1, 3)
    scale = 1.0 / math.sqrt(dh)
    out = torch.empty((b, kvh, g, sq, dh), dtype=q.dtype, device=dev)
    for q0 in range(0, sq, cq):
        rows = torch.arange(q0, q0 + cq, device=dev)
        qc = q5[:, :, :, q0:q0 + cq].float()
        m = torch.full((b, kvh, g, cq), NEG_INF, device=dev)
        l = torch.zeros((b, kvh, g, cq), device=dev)
        acc = torch.zeros((b, kvh, g, cq, dh), device=dev)
        for k0 in range(0, sk, ck):
            cols = torch.arange(k0, k0 + ck, device=dev)
            kc, vc = k4[:, :, k0:k0 + ck], v4[:, :, k0:k0 + ck]
            s = torch.einsum("bkgqd,bktd->bkgqt", qc, kc.float()) * scale
            msk = _mask(rows[:, None], cols[None, :], causal, window)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,bktd->bkgqd", p.to(vc.dtype).float(), vc.float())
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        out[:, :, :, q0:q0 + cq] = (acc / l_safe[..., None]).to(q.dtype)
    return out.reshape(b, h, sq, dh).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# attention block (projections + rope + path select + KV cache decode)
# ---------------------------------------------------------------------------


def _padded_heads(cfg) -> Tuple[int, int]:
    """Heads padded up to a multiple of 16 (the reference's 'model' axis);
    the padded slices are zero, so the model computes the same logits."""
    pad = lambda n: int(-(-n // 16) * 16)
    return pad(cfg.n_heads), pad(cfg.n_kv_heads)


def _heads(cfg) -> Tuple[int, int]:
    return (_padded_heads(cfg) if cfg.pad_heads_to_mesh
            else (cfg.n_heads, cfg.n_kv_heads))


def init_attention(gen: torch.Generator, cfg) -> Dict:
    """``wq [d, H*Dh]``, ``wk``/``wv [d, KVH*Dh]``, ``wo [H*Dh, d]`` drawn
    on ``gen``'s device; padded head slices are zero (``:218-244``)."""
    d = cfg.d_model
    dh = cfg.resolved_head_dim
    h0, kvh0 = cfg.n_heads, cfg.n_kv_heads
    h, kvh = _heads(cfg)
    pd = getattr(torch, cfg.param_dtype)
    s = 1.0 / math.sqrt(d)

    def padded(shape0, shape, scale):
        w = torch.zeros(shape, dtype=pd, device=gen.device)
        w[:shape0[0], :shape0[1]] = normal(gen, shape0, scale, pd)
        return w

    return {
        "wq": padded((d, h0 * dh), (d, h * dh), s),
        "wk": padded((d, kvh0 * dh), (d, kvh * dh), s),
        "wv": padded((d, kvh0 * dh), (d, kvh * dh), s),
        "wo": padded((h0 * dh, d), (h * dh, d),
                     s / math.sqrt(2 * cfg.n_layers)),
    }


def qkv(params: Dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Project + rope. x ``[B, S, d]`` -> q ``[B, S, H, Dh]``, k/v ``[B, S,
    KVH, Dh]``."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    h, kvh = _heads(cfg)
    q = (x @ params["wq"]).reshape(b, s, h, dh)
    k = (x @ params["wk"]).reshape(b, s, kvh, dh)
    v = (x @ params["wv"]).reshape(b, s, kvh, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(params: Dict, cfg, x: torch.Tensor,
                    positions: torch.Tensor, causal: bool = True,
                    return_kv: bool = False):
    """Full-sequence self-attention (prefill)."""
    b, s, _ = x.shape
    q, k, v = qkv(params, cfg, x, positions)
    window = cfg.sliding_window
    if cfg.use_pallas:
        o = ops.flash_attention(q, k, v, causal=causal, window=window,
                                use_pallas=True)
    elif s <= 1024:
        o = kref.mha_attention(q, k, v, causal=causal, window=window)
    else:
        c = _chunk_for(s, cfg.attn_chunk)
        o = chunked_attention(q, k, v, causal=causal, window=window,
                              chunk_q=c, chunk_k=c)
    out = o.reshape(b, s, -1) @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out


# ---------------- decode (single token, KV cache) ----------------


class DecodeStep(NamedTuple):
    """What one decode step's layers share, made once a step by
    ``decode_step``."""
    widx: torch.Tensor  # [1]: the cache row written (the ring slot)
    kv_len: torch.Tensor  # [B] int32: the cache rows attended
    cos: torch.Tensor  # RoPE tables at the position, [B, 1, 1, Dh/2]
    sin: torch.Tensor


def decode_step(cfg, pos, batch: int, smax: int, device) -> DecodeStep:
    """The step-wide values at position ``pos`` (an int or a 0-d integer
    tensor, the same across the batch) for a cache of ``smax`` rows: the
    row written is ``pos`` clamped into the cache, as the reference's
    dynamic_update_slice clamps, or the ring slot ``pos % smax`` under a
    sliding window; ``kv_len = min(pos + 1, smax)``.  ``pos`` may stay on
    the device: nothing here reads it on the host."""
    pos = torch.as_tensor(pos, device=device).long().reshape(())
    widx = pos % smax if cfg.sliding_window else torch.clamp(pos, max=smax - 1)
    kv_len = torch.clamp(pos + 1, max=smax).to(torch.int32).expand(batch)
    cos, sin = rope_tables(pos.expand(batch)[:, None],
                           cfg.resolved_head_dim, cfg.rope_theta)
    return DecodeStep(widx.reshape(1), kv_len.contiguous(), cos, sin)


def decode_attention_block(
    params: Dict,
    cfg,
    x: torch.Tensor,  # [B, 1, d]
    cache_k: torch.Tensor,  # [B, S, KVH, Dh], written in place
    cache_v: torch.Tensor,
    step: DecodeStep,
):
    """One decode step: write the new key and value at ``step.widx``,
    attend over the first ``step.kv_len`` cache rows.  Returns ``(out,
    cache_k, cache_v)``."""
    b = x.shape[0]
    dh = cfg.resolved_head_dim
    h, kvh = _heads(cfg)
    q = rotate((x @ params["wq"]).reshape(b, 1, h, dh), step.cos, step.sin)
    k_new = rotate((x @ params["wk"]).reshape(b, 1, kvh, dh), step.cos,
                   step.sin)
    v_new = (x @ params["wv"]).reshape(b, 1, kvh, dh)
    cache_k.index_copy_(1, step.widx, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, step.widx, v_new.to(cache_v.dtype))
    o = ops.decode_attention(q[:, 0], cache_k, cache_v, step.kv_len,
                             use_pallas=cfg.use_pallas)
    out = o.reshape(b, 1, -1) @ params["wo"]
    return out, cache_k, cache_v
