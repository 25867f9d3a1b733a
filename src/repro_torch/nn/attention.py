"""GQA attention of the LM (port of ``repro/nn/attention.py``): causal
self-attention, the encoder's bidirectional self-attention, the decoder's
cross-attention over the encoder's keys (``kv_override``, rope-free), its
backward, and decode.

Execution paths, one semantics (oracle: ``kernels/ref.py``):

* plain — ``ref.mha_attention`` with materialized scores, up to 1024
  queries and 1024 keys (the reference's plain arm, ``:292-295``, and its
  ``_plain_cross`` when the two lengths differ); autograd differentiates
  it;
* chunked — the reference's pure-JAX FlashAttention-2 (``_chunked5``,
  ``:55-189``), above 1024 tokens: q chunks outside, kv chunks inside,
  online softmax over every chunk pair; a ``torch.autograd.Function``
  saves only ``q, k, v``, the output and the row log-sum-exp, and its
  backward recomputes the score tiles in fp32, as the reference's
  ``custom_vjp`` does;
* the hand-written ``flash_attention`` kernel when ``cfg.use_pallas``
  (``ops.flash_attention``: the kernel on a CUDA tensor, the plain oracle
  on a CPU tensor), cross-attention included: the kernel takes ``Sk !=
  Sq`` when not causal, where the reference's Pallas kernel has one length
  (ROADMAP Queue 3 check (i)).  It has no backward, nor has the
  reference's, so ``attention_block`` refuses to record a graph through
  it;
* decode — ``ops.decode_attention`` over the KV cache, the kernel under
  ``cfg.use_pallas`` and ``ref.decode_attention`` otherwise.

Layouts: q ``[B, S, H, Dh]``; k/v ``[B, Sk, KVH, Dh]``.  The decode step
writes the new key and value into the cache in place.

On a mesh (``dist.sharding.use_mesh``, DTensor parameters) the reference's
``shard`` sites hold (``:263-265, 299, 302, 352-363``): q, k and v
``(BATCH, None, MODEL, None)``, the attention output likewise, the block's
output ``(BATCH, MODEL if cfg.seq_shard_activations, None)``; the decode
caches ``(BATCH, seq, kvh, None)`` with the sequence over ``'model'``
under ``cfg.decode_kv_shard_seq`` and the kv heads over it otherwise, the
decode output ``(BATCH, MODEL, None)``.  The attention itself (kernel,
plain or chunked) runs on each rank's shards through ``dist.sharding.
local``: a rank whose q heads are sharded but whose kv heads are not
(KVH does not divide the axis) reads the kv heads its q heads use.  A
decode over a sequence-sharded cache of more than one rank
writes the new row on the rank that holds it and combines the ranks'
partial softmaxes in rank order by their log-sum-exps (the plain arm's
``ref.decode_partial``, or under ``cfg.use_pallas`` the decode kernel's
log-sum-exp form on each rank's shard).  Off a mesh
every constraint is a no-op and the code is the one-device path.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.dist.sharding import (BATCH, MODEL, current_mesh,
                                      gather_seq, is_dtensor, local,
                                      merge_heads, mesh_coordinate,
                                      replicated, shard, split_heads)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.nn.mlp import normal
from repro_torch.nn.rope import apply_rope, rope_tables, rotate

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# chunked flash attention (plain PyTorch, with its backward)
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


def _tiles(total: int, step: int, meta: bool):
    """A tile loop's chunk starts.  On meta tensors (the dry run) every
    tile does the same work on shapes alone, so the first tile runs and
    what the loop body runs is counted for all of them
    (``characterize.repeated``, held open while the body runs)."""
    if not meta:
        yield from range(0, total, step)
        return
    from repro_torch.core.characterize import repeated

    with repeated(len(range(0, total, step))):
        yield 0


def _fwd_scan(q5, k4, v4, causal, window, cq, ck, scale):
    """The reference's forward scan (``:55-100``): q5 ``[B, KVH, G, Sq,
    Dh]``; k4/v4 ``[B, KVH, Sk, Dh]`` -> ``(out5, lse [B, KVH, G, Sq])``.
    fp32 scores (``* scale`` after the dot), every chunk pair visited,
    ``p`` cast to ``v.dtype`` before ``p @ v``."""
    b, kvh, g, sq, dh = q5.shape
    sk = k4.shape[2]
    dev = q5.device
    out = torch.empty_like(q5)
    lse = torch.empty((b, kvh, g, sq), device=dev)
    meta = q5.is_meta
    for q0 in _tiles(sq, cq, meta):
        rows = torch.arange(q0, q0 + cq, device=dev)
        qc = q5[:, :, :, q0:q0 + cq].float()
        m = torch.full((b, kvh, g, cq), NEG_INF, device=dev)
        l = torch.zeros((b, kvh, g, cq), device=dev)
        acc = torch.zeros((b, kvh, g, cq, dh), device=dev)
        for k0 in _tiles(sk, ck, meta):
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
        out[:, :, :, q0:q0 + cq] = (acc / l_safe[..., None]).to(q5.dtype)
        lse[:, :, :, q0:q0 + cq] = m + torch.log(l_safe)
    return out, lse


def _bwd_scan(q5, k4, v4, out, lse, dout, causal, window, cq, ck, scale):
    """The reference's ``_chunked5_bwd`` (``:116-186``): score tiles
    recomputed in fp32 under the same mask, ``delta = sum(dout * out)``;
    pass 1 gives dQ (each q chunk scans the kv chunks), pass 2 dK and dV
    (each kv chunk scans the q chunks).  Returns ``(dq, dk, dv)`` in the
    inputs' dtypes."""
    b, kvh, g, sq, dh = q5.shape
    sk = k4.shape[2]
    dev = q5.device
    dout = dout.float()
    delta = (dout * out.float()).sum(dim=-1)  # [B, KVH, G, Sq]

    def p_tile(qc, kc, rows, cols, lse_c):
        s = torch.einsum("bkgqd,bktd->bkgqt", qc, kc) * scale
        msk = _mask(rows[:, None], cols[None, :], causal, window)
        p = torch.exp(torch.where(msk, s, NEG_INF) - lse_c[..., None])
        return torch.where(msk, p, 0.0)

    def q_chunk(q0):
        sl = slice(q0, q0 + cq)
        return (torch.arange(q0, q0 + cq, device=dev),
                q5[:, :, :, sl].float(), dout[:, :, :, sl],
                lse[:, :, :, sl], delta[:, :, :, sl])

    def kv_chunk(k0):
        return (torch.arange(k0, k0 + ck, device=dev),
                k4[:, :, k0:k0 + ck].float(), v4[:, :, k0:k0 + ck].float())

    meta = q5.is_meta
    # pass 1: dQ -- for each q chunk, scan the kv chunks
    dq = torch.empty((b, kvh, g, sq, dh), device=dev)
    for q0 in _tiles(sq, cq, meta):
        rows, qc, do, lse_c, d_c = q_chunk(q0)
        dqc = torch.zeros((b, kvh, g, cq, dh), device=dev)
        for k0 in _tiles(sk, ck, meta):
            cols, kc, vc = kv_chunk(k0)
            p = p_tile(qc, kc, rows, cols, lse_c)
            dp = torch.einsum("bkgqd,bktd->bkgqt", do, vc)
            ds = p * (dp - d_c[..., None])
            dqc = dqc + scale * torch.einsum("bkgqt,bktd->bkgqd", ds, kc)
        dq[:, :, :, q0:q0 + cq] = dqc

    # pass 2: dK, dV -- for each kv chunk, scan the q chunks
    dk = torch.empty((b, kvh, sk, dh), device=dev)
    dv = torch.empty((b, kvh, sk, dh), device=dev)
    for k0 in _tiles(sk, ck, meta):
        cols, kc, vc = kv_chunk(k0)
        dkc = torch.zeros((b, kvh, ck, dh), device=dev)
        dvc = torch.zeros((b, kvh, ck, dh), device=dev)
        for q0 in _tiles(sq, cq, meta):
            rows, qc, do, lse_c, d_c = q_chunk(q0)
            p = p_tile(qc, kc, rows, cols, lse_c)
            dvc = dvc + torch.einsum("bkgqt,bkgqd->bktd", p, do)
            dp = torch.einsum("bkgqd,bktd->bkgqt", do, vc)
            ds = p * (dp - d_c[..., None])
            dkc = dkc + scale * torch.einsum("bkgqt,bkgqd->bktd", ds, qc)
        dk[:, :, k0:k0 + ck] = dkc
        dv[:, :, k0:k0 + ck] = dvc
    return dq.to(q5.dtype), dk.to(k4.dtype), dv.to(v4.dtype)


class _Chunked5(torch.autograd.Function):
    """The reference's ``_chunked5`` custom VJP: the forward saves only
    ``q, k, v``, the output and the row log-sum-exp, and the backward
    recomputes the score tiles from them."""

    @staticmethod
    def forward(ctx, q5, k4, v4, causal, window, cq, ck):
        scale = 1.0 / math.sqrt(q5.shape[-1])
        out, lse = _fwd_scan(q5, k4, v4, causal, window, cq, ck, scale)
        ctx.save_for_backward(q5, k4, v4, out, lse)
        ctx.tiling = (causal, window, cq, ck, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q5, k4, v4, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_scan(q5, k4, v4, out, lse, dout, *ctx.tiling)
        return dq, dk, dv, None, None, None, None


def chunked_attention(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Sk, KVH, Dh]
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    chunk_q: int = 1024,
    chunk_k: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over ``[chunk_q, chunk_k]`` score tiles,
    differentiable through :class:`_Chunked5`."""
    b, sq, h, dh = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    cq, ck = min(chunk_q, sq), min(chunk_k, sk)
    assert sq % cq == 0 and sk % ck == 0, (sq, cq, sk, ck)
    q5 = q.permute(0, 2, 1, 3).reshape(b, kvh, h // kvh, sq, dh)
    k4 = k.permute(0, 2, 1, 3)
    v4 = v.permute(0, 2, 1, 3)
    o5 = _Chunked5.apply(q5, k4, v4, causal, window, cq, ck)
    return o5.reshape(b, h, sq, dh).permute(0, 2, 1, 3)


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


def _project(x: torch.Tensor, w: torch.Tensor, heads: int, cfg,
             positions: torch.Tensor, use_rope: bool) -> torch.Tensor:
    """``x @ w`` as ``[B, S, heads, Dh]``, rotated when ``use_rope``."""
    y = split_heads(gather_seq(x) @ w, heads, cfg.resolved_head_dim)
    return apply_rope(y, positions, cfg.rope_theta) if use_rope else y


def qkv(params: Dict, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Project + rope. x ``[B, S, d]`` -> q ``[B, S, H, Dh]``, k/v ``[B, S,
    KVH, Dh]``."""
    h, kvh = _heads(cfg)
    return (_project(x, params["wq"], h, cfg, positions, True),
            _project(x, params["wk"], kvh, cfg, positions, True),
            _project(x, params["wv"], kvh, cfg, positions, False))


def attention_block(params: Dict, cfg, x: torch.Tensor,
                    positions: torch.Tensor, causal: bool = True,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    return_kv: bool = False, use_rope: bool = True):
    """Full-sequence attention (prefill, encoder, cross).  With
    ``kv_override = (k, v)`` (``[B, Sk, KVH, Dh]``, the encoder's) the
    queries of ``x`` attend over those keys; ``x``'s own keys and values,
    which the reference computes and drops, are not computed.
    ``use_rope=False`` (rope-free queries) is the cross path's; the
    self-attention path always rotates, as every caller of either package
    asks."""
    if kv_override is None:
        if not use_rope:
            raise ValueError("attention_block: use_rope=False is the cross "
                             "path's (kv_override)")
        q, k, v = qkv(params, cfg, x, positions)
    else:  # cross-attention: kv from the encoder
        q = _project(x, params["wq"], _heads(cfg)[0], cfg, positions,
                     use_rope)
        k, v = kv_override
    if cfg.use_pallas and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "attention_block: the flash_attention kernel has no backward "
            "(nor has the reference's Pallas kernel), so training under "
            "cfg.use_pallas is not ported (ROADMAP Queue 1 item 17); "
            "train with use_pallas=False")
    spec = (BATCH, None, MODEL, None)
    q, k, v = shard(q, *spec), shard(k, *spec), shard(v, *spec)
    kv_sel = _kv_heads_of(q, k)
    o = local(lambda q, k, v: _attend(cfg, kv_sel(q, k), kv_sel(q, v),
                                      q, causal),
              (q, k, v), (spec, spec, spec), _placements_of(q))
    o = shard(o, *spec)
    out = merge_heads(o) @ params["wo"]
    # the sequence-parallel epilogue (Megatron SP) scatters the sequence
    out = shard(out, BATCH, MODEL if cfg.seq_shard_activations else None,
                None)
    if return_kv:
        return out, (k, v)
    return out


def _attend(cfg, k, v, q, causal: bool) -> torch.Tensor:
    """The path select on (local) tensors: the kernel under
    ``cfg.use_pallas``, the plain oracle up to 1024 queries and keys, the
    chunked attention above."""
    s, sk = q.shape[1], k.shape[1]
    window = cfg.sliding_window
    if cfg.use_pallas:
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   use_pallas=True)
    if s <= 1024 and sk <= 1024:  # Sk != S: the reference's _plain_cross
        return kref.mha_attention(q, k, v, causal=causal, window=window)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             chunk_q=_chunk_for(s, cfg.attn_chunk),
                             chunk_k=_chunk_for(sk, cfg.attn_chunk))


def _placements_of(x):
    return list(x.placements) if is_dtensor(x) else None


def _kv_heads_of(q, k, head_dim: int = 2):
    """On a mesh where q's heads (dim ``head_dim``) are sharded over
    ``'model'`` and k's are not, a function ``(q_local, kv_local)`` ->
    the kv heads this rank's q heads use (GQA: q head ``i`` reads kv head
    ``i // (H / KVH)``); otherwise the identity."""
    mesh = current_mesh()
    if (mesh is None or not is_dtensor(q) or not is_dtensor(k)
            or MODEL not in mesh.shape):
        return lambda q, kv: kv
    m_dim = mesh.axis_names.index(MODEL)
    q_sh = q.placements[m_dim].is_shard(head_dim)
    kv_sh = k.placements[m_dim].is_shard(head_dim)
    if not q_sh or kv_sh:
        return lambda q, kv: kv
    h, kvh = q.shape[head_dim], k.shape[head_dim]
    g = h // kvh
    h_loc = h // mesh.shape[MODEL]
    h0 = mesh_coordinate(mesh, MODEL) * h_loc
    kv0, kv1 = h0 // g, (h0 + h_loc - 1) // g + 1
    return lambda q, kv: kv.narrow(head_dim, kv0, kv1 - kv0)


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
    if is_dtensor(pos):  # replicated: every rank holds the position
        pos = pos.to_local()
    pos = torch.as_tensor(pos, device=device).long().reshape(())
    widx = pos % smax if cfg.sliding_window else torch.clamp(pos, max=smax - 1)
    kv_len = torch.clamp(pos + 1, max=smax).to(torch.int32).expand(batch)
    cos, sin = rope_tables(pos.expand(batch)[:, None],
                           cfg.resolved_head_dim, cfg.rope_theta)
    step = DecodeStep(widx.reshape(1), kv_len.contiguous(), cos, sin)
    if current_mesh() is not None and current_mesh().device_mesh is not None:
        # on a mesh, once a step: the same values on every rank, the
        # lengths laid out over the batch axes as the cache rows are
        step = DecodeStep(replicated(step.widx),
                          shard(replicated(step.kv_len), BATCH),
                          replicated(step.cos), replicated(step.sin))
    return step


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
    dh = cfg.resolved_head_dim
    h, kvh = _heads(cfg)
    q = rotate(split_heads(x @ params["wq"], h, dh), step.cos, step.sin)
    k_new = rotate(split_heads(x @ params["wk"], kvh, dh), step.cos,
                   step.sin)
    v_new = split_heads(x @ params["wv"], kvh, dh)
    o = decode_attend(cfg, q[:, 0], cache_k, cache_v, step.kv_len,
                      cfg.use_pallas, new=(k_new, v_new), widx=step.widx)
    o = shard(o, BATCH, MODEL, None)
    out = shard(merge_heads(o[:, None]) @ params["wo"], BATCH, None, None)
    return out, cache_k, cache_v


def cache_spec(cfg) -> Tuple:
    """A layer's decode cache ``[B, S, KVH, Dh]``: the sequence over
    ``'model'`` under ``cfg.decode_kv_shard_seq`` (the flash-decode
    layout), else the kv heads."""
    if cfg.decode_kv_shard_seq:
        return (BATCH, MODEL, None, None)
    return (BATCH, None, MODEL, None)


def decode_attend(cfg, q, cache_k, cache_v, kv_len, use_pallas: bool,
                  new=None, widx=None):
    """One query token over the first ``kv_len`` rows of a cache: ``q [B,
    H, Dh]``, the caches ``[B, S, KVH, Dh]``.  With ``new = (k, v)`` ``[B,
    1, KVH, Dh]`` the step first writes them at row ``widx``, in place.
    Off a mesh this is ``ops.decode_attention`` (``use_pallas``: the
    kernel); on a mesh each rank runs it on its cache shard (``local``),
    the caches laid out by :func:`cache_spec`."""
    if current_mesh() is None or not is_dtensor(cache_k):
        if new is not None:
            cache_k.index_copy_(1, widx, new[0].to(cache_k.dtype))
            cache_v.index_copy_(1, widx, new[1].to(cache_v.dtype))
        return ops.decode_attention(q, cache_k, cache_v, kv_len,
                                    use_pallas=use_pallas)
    mesh = current_mesh()
    cspec = cache_spec(cfg)
    cache_k, cache_v = shard(cache_k, *cspec), shard(cache_v, *cspec)
    seq_split = cache_k.placements[mesh.axis_names.index(MODEL)].is_shard(1) \
        if MODEL in mesh.shape else False
    if seq_split:
        q = shard(q, BATCH, None, None)  # every rank: all its rows' heads
    else:
        q = shard(q, BATCH, MODEL, None)
    if not is_dtensor(kv_len):
        kv_len = replicated(torch.full((q.shape[0],), kv_len,
                                       dtype=torch.int32, device=q.device))
    kv_len = shard(kv_len, BATCH)
    kv_sel = _kv_heads_of(q, cache_k, head_dim=1)
    n_seq = mesh.shape[MODEL] if seq_split else 1
    s_loc = cache_k.shape[1] // n_seq
    s0 = mesh_coordinate(mesh, MODEL) * s_loc if n_seq > 1 else 0

    def write(cache, row, widx):
        row = row.to(cache.dtype)
        if n_seq == 1:
            cache.index_copy_(1, widx, row)
            return
        # the row lives on one rank: elsewhere the row read is written back
        idx = widx - s0
        inside = (idx >= 0) & (idx < s_loc)
        idx = torch.clamp(idx, 0, s_loc - 1)
        cache.index_copy_(1, idx, torch.where(inside, row,
                                              cache.index_select(1, idx)))

    def body(q, ck, cv, kv_len, *step):
        if step:  # (k_new, v_new, widx)
            write(ck, step[0], step[2])
            write(cv, step[1], step[2])
        if n_seq == 1:
            return ops.decode_attention(q, kv_sel(q, ck), kv_sel(q, cv),
                                        kv_len, use_pallas=use_pallas)
        # this rank's live rows of its shard; the partials are combined
        # by their log-sum-exps below
        live = torch.clamp(kv_len - s0, 0, s_loc)
        if use_pallas:  # under bf16 o is rounded before the combine, once
            # more than the plain arm's fp32 partials
            o, lse = ops.decode_attention(q, ck, cv, live.to(torch.int32),
                                          use_pallas=True, return_lse=True)
        else:
            o, lse = kref.decode_partial(q, ck, cv, live)
        return o[None], lse[None]

    args = [q, cache_k, cache_v, kv_len]
    if new is not None:
        spec = (BATCH, None, None, None) if seq_split else \
            (BATCH, None, MODEL, None)
        args += [shard(new[0], *spec), shard(new[1], *spec), widx]
    in_specs = [_placements_of(a) for a in args]
    if n_seq == 1:
        return local(body, args, in_specs, _placements_of(q))
    # a partial a rank: [R, B, H, Dh] and [R, B, H], R over 'model'
    from torch.distributed.tensor import Shard
    m_dim = mesh.axis_names.index(MODEL)
    part = [Shard(0) if i == m_dim else Shard(1) if p.is_shard(0) else p
            for i, p in enumerate(q.placements)]
    o_r, lse_r = local(body, args, in_specs, (part, part))
    return _combine_partials(shard(o_r, None, BATCH, None, None),
                             shard(lse_r, None, BATCH, None), q.dtype)


def _combine_partials(o_r, lse_r, dtype: torch.dtype):
    """Combine per-rank partial attentions ``o_r [R, B, H, Dh]``,
    ``lse_r [R, B, H]`` (``R`` replicated) in rank order."""
    m = lse_r.amax(dim=0)
    w = torch.exp(lse_r - m)  # [R, B, H]
    num = w[0][..., None] * o_r[0]
    den = w[0]
    for r in range(1, o_r.shape[0]):
        num = num + w[r][..., None] * o_r[r]
        den = den + w[r]
    return (num / den[..., None]).to(dtype)
