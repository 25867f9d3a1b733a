"""Top-k routed Mixture-of-Experts (port of ``repro/nn/moe.py``).

Token-choice top-k routing with a static per-expert capacity ``C =
max(8, ceil8(ceil(T/E * k * capacity_factor)))``, group-local (GShard
local groups, one group a sequence by default): a choice that finds its
expert full is dropped to the residual stream (arctic: beside its dense
FFN).  The router, the Switch load-balancing loss and the capacity
positions are the reference's (``:62-92``); the positions are a cumsum
over the flattened ``[Tg * k]`` choices, token-major and choice-minor, so
the same (token, choice) pairs are dropped.

The reference dispatches and combines with ``.at[...].add`` (``:97``,
``:114``).  Here both are gathers through the routing maps of
:func:`route`: each slot holds at most one kept choice, so the dispatch
gathers its token's row (an empty slot reads a zero row), and the combine
gathers each choice's expert output and sums a token's ``k`` choices in
order ``j = 0..k-1``.  The backward of each gather is the other map's
gather (:class:`_RowGather`), so no float atomic add is on the card path,
forward or backward.  The expert FFN is SiLU-gated and batched over the
experts (``torch.einsum``: the reference computes it outside any Pallas
kernel).  The reference's sharding constraints hold on a mesh (``:69,
103, 109, 116``): the groups' tokens over ``BATCH``, the dispatch buffer
and the experts' outputs expert-sharded over ``'model'``, the block's
output over ``BATCH``; off a mesh they are no-ops.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.dist.sharding import BATCH, MODEL, is_dtensor, local, shard
from repro_torch.nn.mlp import init_mlp, mlp_block, normal


def init_moe(gen: torch.Generator, d: int, cfg_moe: MoEConfig,
             n_layers: int, param_dtype: torch.dtype) -> Dict:
    """The reference's distributions: the router ``N(0, 1/d)`` in fp32,
    the experts' ``w_gate``/``w_up`` ``N(0, 1/d)`` and ``w_down`` scaled
    by ``1/sqrt(2 n_layers)`` more; arctic's dense residual FFN beside."""
    e, ff = cfg_moe.n_experts, cfg_moe.d_ff_expert
    s = 1.0 / math.sqrt(d)
    params = {
        "router": normal(gen, (d, e), s, torch.float32),
        "w_gate": normal(gen, (e, d, ff), s, param_dtype),
        "w_up": normal(gen, (e, d, ff), s, param_dtype),
        "w_down": normal(gen, (e, ff, d), s / math.sqrt(2 * n_layers),
                         param_dtype),
    }
    if cfg_moe.dense_residual_ff:
        params["dense"] = init_mlp(gen, d, cfg_moe.dense_residual_ff,
                                   n_layers, param_dtype)
    return params


def _capacity(t: int, cfg_moe: MoEConfig) -> int:
    c = int(math.ceil(t * cfg_moe.top_k / cfg_moe.n_experts
                      * cfg_moe.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to multiple of 8


class Routing(NamedTuple):
    """One group-local routing of ``[G, Tg]`` tokens over ``E`` experts of
    ``cap`` slots; choice ``i = token * k + j``, slot ``e * cap + pos``."""
    gate_w: torch.Tensor  # [G, Tg * k] fp32, renormalised, 0 where dropped
    keep: torch.Tensor  # [G, Tg * k] bool
    slot: torch.Tensor  # [G, Tg * k] the choice's slot; E * cap if dropped
    src: torch.Tensor  # [G, E * cap] the slot's choice; Tg * k if empty
    aux: torch.Tensor  # [] fp32, the Switch load-balancing loss


def route(router: torch.Tensor, xt: torch.Tensor, cfg_moe: MoEConfig,
          cap: int) -> Routing:
    """The reference's router (``:71-92``) on ``xt [G, Tg, d]``: fp32
    logits, softmax, top-k, gate weights renormalised by ``max(sum,
    1e-9)``; the aux loss ``E * sum(me * ce)`` with ``ce`` counting every
    choice, dropped ones too; positions by a cumsum over the token-major,
    choice-minor ``[Tg * k]`` choices; the choices at positions past
    ``cap`` dropped."""
    g_n, tg, _ = xt.shape
    e, k = cfg_moe.n_experts, cfg_moe.top_k
    logits = xt.float() @ router  # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, k, dim=-1)  # [G, Tg, k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    e_flat = gate_idx.reshape(g_n, tg * k)  # expert id per choice
    onehot = F.one_hot(e_flat, e)  # [G, Tg*k, E] int64
    me = probs.mean((0, 1))
    ce = onehot.sum((0, 1)).float() / (g_n * tg * k)
    aux = e * torch.sum(me * ce)

    pos = torch.cumsum(onehot, dim=1) - onehot
    pos_in_e = torch.gather(pos, 2, e_flat[..., None])[..., 0]
    keep = pos_in_e < cap
    n_slots = e * cap
    slot = torch.where(keep, e_flat * cap + pos_in_e, n_slots)
    # the inverse map: kept slots are distinct, and every dropped choice
    # writes the spare last column, which is cut off
    src = torch.full((g_n, n_slots + 1), tg * k, dtype=slot.dtype,
                     device=slot.device)
    choice = torch.arange(tg * k, device=slot.device).expand(g_n, -1)
    src = src.scatter(1, slot, choice)[:, :n_slots]
    w_flat = gate_w.reshape(g_n, tg * k) * keep.float()
    return Routing(w_flat, keep, slot, src, aux)


def _pad_gather(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows [G, R, d]`` with a zero row appended, gathered at ``idx [G,
    M]`` (values in ``[0, R]``) -> ``[G, M, d]``."""
    g_n, r, d = rows.shape
    pad = torch.cat([rows, rows.new_zeros((g_n, 1, d))], dim=1)
    base = torch.arange(g_n, device=idx.device)[:, None] * (r + 1)
    flat = pad.reshape(g_n * (r + 1), d).index_select(0,
                                                      (idx + base).reshape(-1))
    return flat.reshape(g_n, idx.shape[1], d)


class _RowGather(torch.autograd.Function):
    """``out[g, m] = rows[g, idx[g, m]]`` (the zero row where ``idx = R``),
    whose backward is a gather too: ``grad_rows[g, r] = sum_j
    grad_out[g, inv[g, r, j]]`` over ``j = 0..J-1`` in order (a zero row
    where ``inv = M``).  ``inv`` lists every ``m`` with ``idx[g, m] = r``;
    the gradient of the zero row is dropped.  Autograd's backward of a
    gather would add with float atomics on the card."""

    @staticmethod
    def forward(ctx, rows, idx, inv):
        ctx.save_for_backward(idx, inv)
        ctx.rows = rows.shape[1]
        return _pad_gather(rows, idx)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        idx, inv = ctx.saved_tensors
        g_n, r, j_n = inv.shape
        parts = _pad_gather(grad_out.contiguous(), inv.reshape(g_n, r * j_n))
        parts = parts.reshape(g_n, r, j_n, -1)
        grad = parts[:, :, 0]
        for j in range(1, j_n):
            grad = grad + parts[:, :, j]
        return grad, None, None


def _expert_ffn(w_gate, w_up, w_down, xe):
    """The SiLU-gated FFN of each expert on its slots: ``xe [G, E, cap,
    d]`` -> ``[G, E, cap, d]``."""
    gact = F.silu(torch.einsum("gecd,edf->gecf", xe, w_gate))
    u = torch.einsum("gecd,edf->gecf", xe, w_up)
    return torch.einsum("gecf,efd->gecd", gact * u, w_down)


def moe_block(params: Dict, x: torch.Tensor, cfg_moe: MoEConfig,
              n_groups: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> ``(out [B, S, d], aux_loss [])``, group-local:
    ``n_groups`` groups along the batch (default: one a sequence), each
    routing its ``Tg`` tokens into ``cap`` slots an expert."""
    b, s, d = x.shape
    e, k = cfg_moe.n_experts, cfg_moe.top_k
    g_n = n_groups or b
    tg = b * s // g_n  # tokens per group
    cap = _capacity(tg, cfg_moe)
    xt = shard(x.reshape(g_n, tg, d), BATCH, None, None)
    r = route(params["router"], xt, cfg_moe, cap)

    # dispatch: each slot reads its choice's token row (TB-Type)
    tok = torch.div(r.src, k, rounding_mode="floor")  # tg for an empty slot
    xe = _RowGather.apply(xt, tok, r.slot.reshape(g_n, tg, k))
    xe = shard(xe.reshape(g_n, e, cap, d), None, MODEL, None, None)

    # expert FFN (DM-Type, batched over experts), on a mesh a rank's
    # experts on its shards: the weights' FSDP dim gathered, the experts
    # over 'model' as the dispatch buffer's
    espec, xspec = (MODEL, None, None), (None, MODEL, None, None)
    ws = [shard(params[k], *espec) for k in ("w_gate", "w_up", "w_down")]
    ye = local(_expert_ffn, (*ws, xe), (espec, espec, espec, xspec),
               list(xe.placements) if is_dtensor(xe) else None)
    ye = shard(ye, *xspec)

    # combine: each choice reads its slot's output, weighted, and a token
    # sums its k choices in order
    yt = _RowGather.apply(ye.reshape(g_n, e * cap, d), r.slot,
                          r.src.reshape(g_n, e * cap, 1))
    yt = (yt * r.gate_w[..., None].to(x.dtype)).reshape(g_n, tg, k, d)
    out = yt[:, :, 0]
    for j in range(1, k):
        out = out + yt[:, :, j]
    out = shard(out.reshape(b, s, d), BATCH, None, None)

    if "dense" in params:  # arctic: parallel dense residual FFN
        out = out + mlp_block(params["dense"], x)
    return out, r.aux
