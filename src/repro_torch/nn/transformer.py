"""Decoder-only transformer composition: dense / MoE / SSM / hybrid / VLM
(port of ``repro/nn/transformer.py``): the forward, the training loss and
the serving entry points.  A VLM is the dense stack with precomputed
frontend embeddings (``extra_embeds [B, E, d]``, the vision stub)
prepended to the token embeddings; ``lm_forward`` and ``lm_loss`` drop
their ``E`` positions from the output, and a decode after a VLM prefill
continues at position ``E + S``.

Layers are stacked ``[L, ...]`` tensors, one stack per homogeneous run
(``layer_runs``), as in the reference, so a parameter tree made by the
reference's ``init_lm_params`` carries across one to one
(``interop.params_from_numpy``).  zamba2's shared attention block has ONE
param set (``params["shared"]``, an empty ``{}`` in ``runs`` at each of
its applications) referenced at every application, each application with
its own KV cache.  A Python loop over the layers replaces ``lax.scan``;
each run's stack is unbound once, so the gradient of a stack is one
``stack`` of its layers' gradients.  The KV cache is preallocated ``[L,
B, S, KVH, Dh]``; prefill writes it per layer and each decode step writes
one row in place; a Mamba run's cache is a ``MambaCache`` stacked ``[L,
...]``, which each decode step overwrites in place.

Training (``lm_loss``) differentiates the backbone with autograd.  Each
layer is rematerialised as ``cfg.remat`` says (``_remat``): ``none``,
``full`` (``torch.utils.checkpoint`` around the layer) or ``dots`` (the
layer's matmul outputs saved, the rest recomputed); the mode changes
memory only, not a bit of the loss or the gradients.  The cross-entropy is
taken a chunk of tokens at a time, each chunk checkpointed, so ``[B, S,
V]`` is never held in fp32 (``chunked_ce``); the MoE layers' aux losses
enter it as ``+ 0.01 * aux``.  The embedding's gradient is summed in a
fixed order by the ``segment_sum`` kernel on the card (``_EmbedGather``)
and the MoE's dispatch and combine are gathers both ways
(``nn/moe.py``), so no float atomic is on the training path.

Public entry points: ``init_lm_params``, ``lm_forward``, ``lm_loss``,
``lm_prefill``, ``init_kv_caches`` + ``graft_prefill_caches``,
``lm_decode_step``.  The encoder-decoder family is ``nn/encdec.py``.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (BATCH, MODEL, copy_into, gather_seq,
                                      is_dtensor, local, replicated, shard)
from repro_torch.interop import resolve_device
from repro_torch.kernels import ops
from repro_torch.nn import attention as attn
from repro_torch.nn.mlp import init_mlp, mlp_block, normal
from repro_torch.nn.moe import init_moe, moe_block
from repro_torch.nn.norm import init_rmsnorm, rmsnorm
from repro_torch.nn.ssm import (MambaCache, init_mamba2, init_mamba_cache,
                                mamba2_block)


def layer_runs(cfg: ModelConfig) -> List[Tuple[str, int]]:
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return [("attn", cfg.n_layers)]
    if fam == "moe":
        return [("moe", cfg.n_layers)]
    if fam == "ssm":
        return [("mamba", cfg.n_layers)]
    if fam == "hybrid":
        runs: List[Tuple[str, int]] = []
        period = cfg.shared_attn_period or cfg.n_layers
        left = cfg.n_layers
        while left > 0:
            k = min(period, left)
            runs.append(("mamba", k))
            left -= k
            if left > 0 or k == period:
                runs.append(("shared_attn", 1))
        return runs
    raise ValueError(f"layer_runs: unsupported family {fam}")


# the matmuls whose outputs the "dots" mode saves: products with no batch
# dimension (``x @ W``), as the reference's
# ``checkpoint_dots_with_no_batch_dims``; the attention's batched products
# (``bmm``) are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    """``fn`` under the remat ``mode`` (``cfg.remat``; the reference's
    ``:62-69``); a call with no graph being recorded runs ``fn`` as it
    is."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn
    if mode == "dots":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _save_dots)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=context)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Dict:
    d = cfg.d_model
    pd = getattr(torch, cfg.param_dtype)
    if kind == "mamba":
        return {"ln1": init_rmsnorm(d, gen.device),
                "mamba": init_mamba2(gen, d, cfg.ssm, cfg.n_layers, pd)}
    if kind not in ("attn", "shared_attn", "moe"):
        raise ValueError(kind)
    block = {"ln1": init_rmsnorm(d, gen.device),
             "attn": attn.init_attention(gen, cfg),
             "ln2": init_rmsnorm(d, gen.device)}
    if kind == "moe":
        block["moe"] = init_moe(gen, d, cfg.moe, cfg.n_layers, pd)
    else:
        block["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.n_layers, pd)
    return block


def stacked(gen: torch.Generator, count: int, init_one) -> Dict:
    """``count`` blocks of ``init_one(gen)`` stacked ``[count, ...]``, each
    drawn straight into its slot, so a full-size model is never held
    twice."""
    first = init_one(gen)
    stack = tree.map(lambda x: x.new_empty((count,) + x.shape), first)
    for j in range(count):
        block = first if j == 0 else init_one(gen)
        tree.map(lambda dst, src: dst.copy_(src), _layer(stack, j), block)
    return stack


def _layer(stack: Dict, j: int) -> Dict:
    """Layer ``j`` of a stacked run (views)."""
    return tree.map(lambda x: x[j], stack)


def _unbind(stack: Dict, count: int) -> List[Dict]:
    """The ``count`` layers of a stacked run, each a dict of views, made by
    one ``unbind`` a leaf (whose backward stacks the layers' gradients)."""
    if isinstance(stack, dict):
        parts = {k: _unbind(v, count) for k, v in stack.items()}
        return [{k: parts[k][j] for k in stack} for j in range(count)]
    return stack.unbind(0)


def init_lm_params(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random weights drawn on ``gen``'s device, in fp32 and then cast to
    ``cfg.param_dtype``, with the reference's distributions: embed ``N(0,
    0.02^2)``, lm_head ``N(0, 1/d)``, the block weights of
    ``nn/attention.py``, ``nn/mlp.py``, ``nn/moe.py`` and ``nn/ssm.py``.
    Each layer is drawn straight into its slot of the stack, so a
    full-size model is never held twice.  The shared block (hybrid) is
    drawn once, at its first application, into ``params["shared"]``."""
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
        if kind == "shared_attn":
            if "shared" not in params:
                params["shared"] = _init_block(gen, cfg, kind)
            params["runs"].append({})  # placeholder (weights in 'shared')
            continue
        params["runs"].append(stacked(
            gen, count, lambda g, kind=kind: _init_block(g, cfg, kind)))
    return params


def param_count(params) -> int:
    return sum(x.numel() for x in tree.leaves(params))


# ---------------------------------------------------------------------------
# full-sequence forward (prefill trunk)
# ---------------------------------------------------------------------------


class _EmbedGather(torch.autograd.Function):
    """``table[ids]``, whose backward sums the rows' gradients into the
    table in a fixed order: the ids sorted stably, each id's rows added in
    token order in fp32 by ``ops.segment_sum`` (the hand kernel on the card,
    its plain version on the CPU), then cast to the table's dtype.  The
    ``index_select`` backward would add them with float atomics on the
    card (ROADMAP Queue 3 check (d))."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, dx):
        if not ctx.needs_input_grad[0]:
            return None, None
        (ids,) = ctx.saved_tensors
        sorted_ids, order = torch.sort(ids, stable=True)
        grad = ops.segment_sum(dx.float().contiguous(),
                               sorted_ids.to(torch.int32), ctx.rows,
                               idx=order.to(torch.int32))
        return grad.to(ctx.dtype), None


def _embed_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``_EmbedGather`` of ``ids``.  On a mesh the table is the gather's
    source pool, replicated, and each rank gathers its own ids' rows
    (``local``); the table's gradient from a rank is a partial sum,
    reduced across the ranks."""
    if not is_dtensor(table):
        return _EmbedGather.apply(table, ids)
    table = shard(table, None, None)
    ids = shard(replicated(ids), BATCH)
    return local(_EmbedGather.apply, (table, ids), ((None, None), (BATCH,)),
                 list(ids.placements))


def _embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor,
                  extra_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The tokens' embeddings in ``cfg.dtype``, after ``extra_embeds [B,
    E, d]`` (the modality frontend stub) when given."""
    x = _embed_gather(params["embed"], tokens.reshape(-1))
    x = x.reshape(*tokens.shape, -1).to(getattr(torch, cfg.dtype))
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return shard(x, BATCH, None, None)


def _seq_shard(on: bool):
    """The reference's sequence-parallel residual constraint (``_seq_shard``
    under ``cfg.seq_shard_activations``; the forward and the loss, not the
    prefill): ``(BATCH, MODEL, None)``, a no-op off a mesh."""
    if on:
        return lambda x: shard(x, BATCH, MODEL, None)
    return lambda x: x


def _ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor, seq: bool = False):
    """The feed-forward half of an attention layer on the RMS-normed
    residual stream: the MLP, or the routed experts of a MoE layer.
    ``seq``: the sequence-parallel constraints.  Returns ``(x, aux |
    None)``."""
    h = _seq_shard(seq)(rmsnorm(p["ln2"], x, cfg.norm_eps))
    if "moe" in p:
        hh, aux = moe_block(p["moe"], h, cfg.moe)
        return x + hh, aux
    return x + mlp_block(p["mlp"], h, seq_shard=seq), None


def _block(p: Dict, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor, causal: bool, seq: bool = False):
    """One dense or MoE layer (or the shared block): attention, then
    ``_ffn``.  Returns ``(x, (k, v), aux | None)``, the layer's keys and
    values after RoPE."""
    ss = _seq_shard(seq)
    h, kv = attn.attention_block(p["attn"], cfg,
                                 ss(rmsnorm(p["ln1"], x, cfg.norm_eps)),
                                 positions, causal, return_kv=True)
    x, aux = _ffn(p, cfg, x + h, seq)
    return ss(x), kv, aux


def _mamba_layer(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 return_state: bool, seq: bool = False):
    """One Mamba2 layer.  Returns ``(x, MambaCache | None, None)``."""
    ss = _seq_shard(seq)
    h, cache = mamba2_block(p["mamba"], cfg,
                            ss(rmsnorm(p["ln1"], x, cfg.norm_eps)),
                            return_state=return_state)
    return ss(x + h), cache, None


def _new_stack(count: int, cache):
    """An empty ``[count, ...]`` run cache shaped after one layer's:
    ``{"k", "v"}`` from ``(k, v)``, or a ``MambaCache``."""
    if isinstance(cache, MambaCache):
        return MambaCache(*[f.new_empty((count,) + f.shape) for f in cache])
    k, v = cache
    return {"k": k.new_empty((count,) + k.shape),
            "v": v.new_empty((count,) + v.shape)}


def _write_layer(stack, j: int, cache) -> None:
    """Layer ``j``'s cache into its slot of a run's stack."""
    if isinstance(stack, MambaCache):
        for dst, src in zip(stack, cache):
            dst[j] = src
    else:
        stack["k"][j], stack["v"][j] = cache


def lm_backbone(params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, causal: bool = True,
                collect_kv: bool = False):
    """Run all layer runs.  Returns ``(hidden, aux, caches | None)``: the
    MoE layers' aux losses summed in layer order; with ``collect_kv`` each
    attention run's keys and values (after RoPE) in one ``[L, B, S, KVH,
    Dh]`` pair (``[1, ...]`` for each application of the shared block),
    and each Mamba run's prefill ``MambaCache`` stacked ``[L, ...]``."""
    caches = [] if collect_kv else None
    seq = cfg.seq_shard_activations and not collect_kv
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for (kind, count), stack in zip(layer_runs(cfg), params["runs"]):
        if kind == "shared_attn":  # one param set, no remat (:180-192)
            x, (k, v), _ = _block(params["shared"], cfg, x, positions,
                                  causal, seq)
            if collect_kv:
                caches.append({"k": k[None], "v": v[None]})
            continue
        run_cache = None
        layers = []  # on a mesh, each layer's cache, stacked at the end
        for j, p in enumerate(_unbind(stack, count)):
            if kind == "mamba":
                x, c, a = _remat(_mamba_layer, cfg.remat)(p, cfg, x,
                                                          collect_kv, seq)
            else:
                x, c, a = _remat(_block, cfg.remat)(p, cfg, x, positions,
                                                    causal, seq)
            if a is not None:
                aux = aux + a
            if collect_kv and is_dtensor(x):
                layers.append(c)
            elif collect_kv:
                if run_cache is None:
                    run_cache = _new_stack(count, c)
                _write_layer(run_cache, j, c)
        if collect_kv:
            caches.append(_stack_layers(layers) if layers else run_cache)
    return x, aux, caches


def _stack_layers(layers: List):
    """A run's stacked cache from its layers' caches (the mesh path: a
    DTensor is not written into a slot of another)."""
    if isinstance(layers[0], MambaCache):
        return MambaCache(*[torch.stack(f) for f in zip(*layers)])
    return {"k": torch.stack([k for k, _ in layers]),
            "v": torch.stack([v for _, v in layers])}


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    """The output projection ``[d, V]``: ``lm_head``, or the tied
    embedding's transpose, on a mesh with the embedding's FSDP dim gathered
    (vocab over ``'model'`` where it divides), so both uses of the table
    give its gradient back in its own layout."""
    if not cfg.tie_embeddings:
        return params["lm_head"]
    return shard(params["embed"], MODEL, None).T


def lm_logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(params["ln_f"], gather_seq(h), cfg.norm_eps)
    return h @ _head(params, cfg)  # [B, S, V]


def lm_forward(params, cfg: ModelConfig, tokens: torch.Tensor,
               extra_embeds: Optional[torch.Tensor] = None):
    """``(logits [B, S, V], aux)`` of the tokens; with ``extra_embeds [B,
    E, d]`` prepended, the logits of the ``S`` token positions only."""
    x = _embed_inputs(params, cfg, tokens, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    h, aux, _ = lm_backbone(params, cfg, x, positions)
    if extra_embeds is not None:
        h = h[:, extra_embeds.shape[1]:]
    return lm_logits(params, cfg, h), aux


# ---------------------------------------------------------------------------
# loss (sequence-chunked cross-entropy: never materializes [B,S,V] in fp32)
# ---------------------------------------------------------------------------


def _ce_chunk(h_c, head, labels_c, mask_c) -> torch.Tensor:
    """The masked sum of one chunk's token losses, in fp32."""
    logits = (h_c @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        # vocab sharded over 'model': the gold logit as a masked sum over
        # the vocab (one term), which a rank computes on its own shard
        vocab = torch.arange(logits.shape[-1], device=labels_c.device)
        gold = torch.where(labels_c[..., None].long() == vocab, logits,
                           0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, labels_c[..., None].long())[..., 0]
    return ((lse - gold) * mask_c).sum()


def chunked_ce(h, head, labels, mask, chunk_tokens: int) -> torch.Tensor:
    """Mean token loss over the unmasked tokens (the reference's
    ``:246-269``): the sequence in chunks of ``c`` positions (the largest
    divisor of ``S`` up to ``chunk_tokens``), each chunk's ``[B, c, V]``
    logits made, reduced and dropped, and made again in the backward
    (``checkpoint``); the chunks' sums added in order."""
    b, s, d = h.shape
    c = max(1, min(s, chunk_tokens))
    while s % c:
        c -= 1
    ce = _remat(_ce_chunk, "full")
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, c):
        tot = tot + ce(h[:, i:i + c], head, labels[:, i:i + c],
                       mask[:, i:i + c])
        cnt = cnt + mask[:, i:i + c].sum()
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """batch: ``tokens [B, S]``, ``labels [B, S]`` (-1 = pad), optional
    ``extra_embeds [B, E, d]`` (vision / audio stub, prepended and carrying
    no label).  The mean cross-entropy of the unmasked tokens, ``+ 0.01 *
    aux`` (the MoE layers' Switch loss; 0 for the other families)."""
    tokens = batch["tokens"]
    extra = batch.get("extra_embeds")
    x = _embed_inputs(params, cfg, tokens, extra)
    positions = torch.arange(x.shape[1], device=x.device)
    h, aux, _ = lm_backbone(params, cfg, x, positions)
    if extra is not None:
        h = h[:, extra.shape[1]:]
    h = rmsnorm(params["ln_f"], gather_seq(h), cfg.norm_eps)
    head = _head(params, cfg)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    chunk_tokens = max(8, int(2 ** 24 / max(cfg.vocab, 1)))
    loss = chunked_ce(h, head, torch.clamp(labels, min=0), mask, chunk_tokens)
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode
# ---------------------------------------------------------------------------


def init_kv_caches(cfg: ModelConfig, batch: int, max_len: int,
                   device=None) -> List:
    """Zeroed decode caches per run on ``device`` (default: the CUDA
    device; there is no silent CPU fallback): ``{"k", "v"}`` of ``[L, B,
    S, KVH, Dh]`` for an attention run, where ``S`` is ``min(max_len,
    window)`` under a sliding window (a ring); a ``MambaCache`` stacked
    ``[L, ...]`` for a Mamba run."""
    dh = cfg.resolved_head_dim
    _, kvh = attn._heads(cfg)
    dt = getattr(torch, cfg.dtype)
    device = resolve_device(device)
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    caches: List = []
    for kind, count in layer_runs(cfg):
        if kind == "mamba":
            c0 = init_mamba_cache(cfg, batch, dt, device)
            caches.append(MambaCache(*[f.new_zeros((count,) + f.shape)
                                       for f in c0]))
        else:
            caches.append({
                "k": torch.zeros((count, batch, s, kvh, dh), dtype=dt,
                                 device=device),
                "v": torch.zeros((count, batch, s, kvh, dh), dtype=dt,
                                 device=device)})
    return caches


def graft_prefill_caches(cfg: ModelConfig, skeleton, prefill, t0: int):
    """Place the prefill KV (length ``t0``) into the decode caches, in
    place, and return them.

    Under a sliding window the cache is a ring: slot ``r`` holds the newest
    prompt position ``p = r (mod W)``; a slot with no valid position stays
    zero (``kv_len`` masks it until it is overwritten).  A Mamba run's
    prefill ``MambaCache`` takes its skeleton's place as it is."""
    for i, (sk, pf) in enumerate(zip(skeleton, prefill)):
        if isinstance(pf, MambaCache):
            skeleton[i] = pf
            continue
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


def lm_prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
               extra_embeds: Optional[torch.Tensor] = None):
    """Full-sequence forward returning the last position's logits ``[B, 1,
    V]`` and the caches (of ``E + S`` positions with ``extra_embeds [B, E,
    d]`` prepended; the next decode position is ``E + S``)."""
    x = _embed_inputs(params, cfg, tokens, extra_embeds)
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
    step = None  # the attention runs' step-wide values, made once
    for (kind, count), stack, cache in zip(layer_runs(cfg), params["runs"],
                                           caches):
        if kind == "mamba":
            for j in range(count):
                p = _layer(stack, j)
                c = MambaCache(*[f[j] for f in cache])
                h, new = mamba2_block(p["mamba"], cfg,
                                      rmsnorm(p["ln1"], x, eps), cache=c)
                x = x + h
                for dst, src in zip(c, new):
                    copy_into(dst, src)
            continue
        if step is None:
            step = attn.decode_step(cfg, pos, x.shape[0],
                                    cache["k"].shape[2], x.device)
        for j in range(count):
            p = params["shared"] if kind == "shared_attn" else _layer(stack, j)
            h, _, _ = attn.decode_attention_block(
                p["attn"], cfg, rmsnorm(p["ln1"], x, eps), cache["k"][j],
                cache["v"][j], step)
            x, _ = _ffn(p, cfg, x + h)
    return lm_logits(params, cfg, x), caches
