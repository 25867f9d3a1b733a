"""Mamba2 — the SSD (state-space duality) block, chunked (port of
``repro/nn/ssm.py``).

Within a chunk the recurrence is dense matmuls; across chunks a Python
loop carries the ``[B, NH, HD, N]`` state in fp32, where the reference
runs a ``lax.scan``.  Projections are split per segment (z / x / B / C /
dt) and the depthwise conv likewise (conv_x, conv_B, conv_C), as in the
reference, so a reference parameter tree carries across one to one.  Its
sharding constraints hold on a mesh (``:174-208``: z, x and dt over
``'model'``, the heads of ``x`` likewise, the output over ``BATCH``) and
are no-ops off one.  The SSD
and ``dt`` run in fp32 and are cast back to the activations' dtype.

The intra-chunk decay ``exp(cum_t - cum_s)`` is taken of the exponent
masked to 0 above the diagonal and then masked again (the reference masks
after the ``exp`` only): the selected entries keep their bits, and a
masked exponent large enough to overflow cannot reach the gradient as
``inf * 0``.

Oracle for tests: :func:`ssd_sequential` (the per-step recurrence), also
the decode step.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.dist.sharding import (BATCH, MODEL, gather_seq,
                                      is_dtensor, local, merge_heads, shard,
                                      split_heads)
from repro_torch.nn.mlp import normal
from repro_torch.nn.norm import rmsnorm


def dims(d_model: int, ssm: SSMConfig) -> Tuple[int, int, int]:
    d_inner = ssm.expand * d_model
    n_heads = d_inner // ssm.head_dim
    return d_inner, n_heads, ssm.d_state


def init_mamba2(gen: torch.Generator, d_model: int, ssm: SSMConfig,
                n_layers: int, param_dtype: torch.dtype) -> Dict:
    """The reference's distributions and constants: projections ``N(0,
    1/d)`` (``out_proj`` scaled by ``1/sqrt(2 n_layers)`` more),
    ``conv_x`` ``N(0, 0.04)``, ``conv_B``/``conv_C`` zero with a last row
    of 1, ``A_log = log(linspace(1, 16, nh))``, ``D = 1``, ``dt_bias =
    -4.6`` (softplus^-1(0.01)), ``norm_g = 1``; the last four fp32."""
    di, nh, n = dims(d_model, ssm)
    dev = gen.device
    s = 1.0 / math.sqrt(d_model)

    def last_row_one(cols):
        w = torch.zeros((ssm.d_conv, cols), dtype=param_dtype, device=dev)
        w[-1] = 1.0
        return w

    return {
        "w_z": normal(gen, (d_model, di), s, param_dtype),
        "w_x": normal(gen, (d_model, di), s, param_dtype),
        "w_B": normal(gen, (d_model, n), s, param_dtype),
        "w_C": normal(gen, (d_model, n), s, param_dtype),
        "w_dt": normal(gen, (d_model, nh), s, param_dtype),
        "conv_x": normal(gen, (ssm.d_conv, di), 0.2, param_dtype),
        "conv_B": last_row_one(n),
        "conv_C": last_row_one(n),
        "conv_bias": torch.zeros((di,), dtype=param_dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "D": torch.ones((nh,), device=dev),
        "dt_bias": torch.full((nh,), -4.6, device=dev),
        "norm_g": torch.ones((di,), device=dev),
        "out_proj": normal(gen, (di, d_model),
                           s / math.sqrt(2 * n_layers), param_dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias=None,
                 channels=None) -> torch.Tensor:
    """Depthwise causal conv via shifted adds. x [B,S,C], w [K,C].  On a
    mesh each rank convolves its shards (``local``): the rows over
    ``BATCH``, the channels over ``channels`` (``MODEL`` for ``conv_x``,
    replicated for ``conv_B`` / ``conv_C``, as the reference lays them
    out), the sequence whole."""
    spec = (BATCH, None, channels)
    x = shard(x, *spec)
    args = (x, shard(w, None, channels)) + (
        () if bias is None else (shard(bias, channels),))
    return local(_causal_conv_local, args,
                 (spec, (None, channels), (channels,))[:len(args)],
                 list(x.placements) if is_dtensor(x) else None)


def _causal_conv_local(x: torch.Tensor, w: torch.Tensor, bias=None
                       ) -> torch.Tensor:
    k = w.shape[0]
    out = x * w[-1]
    for j in range(k - 1):
        sh = k - 1 - j
        out = out + F.pad(x, (0, 0, sh, 0))[:, : x.shape[1]] * w[j]
    if bias is not None:
        out = out + bias
    return out


def _conv_step(buf: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor,
               bias=None):
    """Single-step conv from a [B, K-1, C] trailing buffer. Returns (y
    [B,1,C], new_buf)."""
    full = torch.cat([buf, x_new], dim=1)  # [B, K, C]
    y = (full * w).sum(dim=1, keepdim=True)
    if bias is not None:
        y = y + bias
    return y, full[:, 1:]


def ssd_chunked(
    x: torch.Tensor,  # [B, S, NH, HD]
    dt: torch.Tensor,  # [B, S, NH] (post-softplus)
    a_neg: torch.Tensor,  # [NH] negative decay rate (-exp(A_log))
    b_proj: torch.Tensor,  # [B, S, N]
    c_proj: torch.Tensor,  # [B, S, N]
    chunk: int,
    init_state: torch.Tensor = None,  # [B, NH, HD, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (the reference's ``:80-130``). Returns (y [B,S,NH,HD],
    final_state).  ``S`` must be at most ``chunk`` or a multiple of it."""
    bsz, s, nh, hd = x.shape
    n = b_proj.shape[-1]
    L = min(chunk, s)
    assert s % L == 0, (s, L)
    f32 = torch.float32
    xf, dtf, bf, cf = (t.to(f32) for t in (x, dt, b_proj, c_proj))
    state = (torch.zeros((bsz, nh, hd, n), dtype=f32, device=x.device)
             if init_state is None else init_state)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))

    ys = []
    for c0 in range(0, s, L):
        sl = slice(c0, c0 + L)
        xch, dch, bch, cch = xf[:, sl], dtf[:, sl], bf[:, sl], cf[:, sl]
        aa = dch * a_neg  # [B,L,NH] log-decay per step (negative)
        cum = torch.cumsum(aa, dim=1)  # [B,L,NH]
        cum_h = cum.movedim(-1, 1)  # [B,NH,L]
        # intra-chunk: masked decay matrix [B,NH,L,L]
        diff = cum_h[:, :, :, None] - cum_h[:, :, None, :]
        dec = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
        cb = torch.einsum("btn,bsn->bts", cch, bch)  # [B,L,L]
        dts = dch.movedim(-1, 1)  # [B,NH,L] (source dt)
        m = cb[:, None] * dec * dts[:, :, None, :]  # [B,NH,L,L]
        x_h = xch.movedim(2, 1)  # [B,NH,L,HD]
        y_intra = torch.einsum("bhts,bhsd->bhtd", m, x_h)
        # inter-chunk: contribution of carried state
        y_inter = (torch.einsum("btn,bhdn->bhtd", cch, state)
                   * torch.exp(cum_h)[..., None])
        # state update
        total = cum_h[:, :, -1]  # [B,NH]
        w_src = torch.exp(total[:, :, None] - cum_h) * dts  # [B,NH,L]
        s_in = torch.einsum("bhs,bhsd,bsn->bhdn", w_src, x_h, bch)
        state = torch.exp(total)[:, :, None, None] * state + s_in
        ys.append((y_intra + y_inter).movedim(1, 2))  # [B,L,NH,HD]
    y = torch.cat(ys, dim=1)
    return y.to(x.dtype), state


def _ssd_local(x, dt, a_neg, b_proj, c_proj, chunk: int,
               want_state: bool):
    """``ssd_chunked`` on each rank's shards (``local``): a head's
    recurrence and a batch row's are independent, so the rows go over
    ``BATCH`` and the heads over ``'model'`` as the reference lays ``x``
    and ``dt`` out; ``B`` and ``C`` are replicated over ``'model'``.
    Returns ``(y, final state or None)``: the state leaves the body only
    when ``want_state`` (an output nothing reads would take a zero
    gradient DTensor cannot lay out)."""
    xs, hs = (BATCH, None, MODEL, None), (BATCH, None, MODEL)
    x, dt = shard(x, *xs), shard(dt, *hs)
    b_proj, c_proj = shard(b_proj, BATCH, None, None), shard(
        c_proj, BATCH, None, None)
    a_neg = shard(a_neg, hs[2])
    out_pl = None
    if is_dtensor(x):  # y as x; the state [B, NH, HD, N]: heads at dim 1
        from torch.distributed.tensor import Shard

        out_pl = (list(x.placements),
                  [Shard(1) if p.is_shard(2) else p for p in x.placements])
        if not want_state:
            out_pl = out_pl[0]

    def body(*a):
        y, state = ssd_chunked(*a, chunk)
        return (y, state) if want_state else y

    out = local(body, (x, dt, a_neg, b_proj, c_proj),
                (xs, hs, (MODEL,), (BATCH, None, None), (BATCH, None, None)),
                out_pl)
    return out if want_state else (out, None)


def ssd_sequential(x, dt, a_neg, b_proj, c_proj, init_state=None):
    """Per-step oracle: S_t = exp(dt_t a) S_{t-1} + dt_t x_t (x) B_t ; y =
    C_t.S_t, in fp32 (the reference's type promotion)."""
    bsz, s, nh, hd = x.shape
    n = b_proj.shape[-1]
    state = (torch.zeros((bsz, nh, hd, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state)
    ys = []
    for t in range(s):
        xt, dtt = x[:, t].float(), dt[:, t].float()  # [B,NH,HD], [B,NH]
        bt, ct = b_proj[:, t].float(), c_proj[:, t].float()  # [B,N]
        decay = torch.exp(dtt * a_neg)[..., None, None]  # [B,NH,1,1]
        inc = torch.einsum("bhd,bn->bhdn", xt * dtt[..., None], bt)
        state = decay * state + inc
        ys.append(torch.einsum("bn,bhdn->bhd", ct, state))
    return torch.stack(ys, dim=1).to(x.dtype), state


class MambaCache(NamedTuple):
    state: torch.Tensor  # [B, NH, HD, N]
    conv_x: torch.Tensor  # [B, d_conv-1, di]
    conv_B: torch.Tensor  # [B, d_conv-1, N]
    conv_C: torch.Tensor  # [B, d_conv-1, N]


def mamba2_block(params: Dict, cfg, x: torch.Tensor,
                 cache: MambaCache = None, return_state: bool = False):
    """Full Mamba2 block. x [B,S,d]. With ``cache`` set, S must be 1
    (decode).

    ``return_state=True`` (prefill) additionally returns the post-sequence
    MambaCache (the final state and the conv tails of the raw
    projections) so decoding can continue from the prompt.
    Returns (out, new_cache_or_None).
    """
    ssm = cfg.ssm
    bsz, s, d_model = x.shape
    di, nh, n = dims(d_model, ssm)
    x = gather_seq(x)
    z = shard(x @ params["w_z"], BATCH, None, MODEL)
    xc_raw = shard(x @ params["w_x"], BATCH, None, MODEL)
    b_raw = x @ params["w_B"]
    c_raw = x @ params["w_C"]
    dt_raw = x @ params["w_dt"]

    if cache is None:
        new_conv = ((xc_raw[:, -(ssm.d_conv - 1):],
                     b_raw[:, -(ssm.d_conv - 1):],
                     c_raw[:, -(ssm.d_conv - 1):]) if return_state
                    else None)
        xc = F.silu(_causal_conv(xc_raw, params["conv_x"],
                                 params["conv_bias"], MODEL))
        b = F.silu(_causal_conv(b_raw, params["conv_B"]))
        c = F.silu(_causal_conv(c_raw, params["conv_C"]))
    else:
        xc, nbx = _conv_step(cache.conv_x, xc_raw, params["conv_x"],
                             params["conv_bias"])
        b, nbb = _conv_step(cache.conv_B, b_raw, params["conv_B"])
        c, nbc = _conv_step(cache.conv_C, c_raw, params["conv_C"])
        xc, b, c = F.silu(xc), F.silu(b), F.silu(c)
        new_conv = (nbx, nbb, nbc)

    xh = split_heads(xc, nh, ssm.head_dim)
    dt = shard(F.softplus(dt_raw.float() + params["dt_bias"]), BATCH, None,
               MODEL)
    a_neg = -torch.exp(params["A_log"])

    if cache is None:
        y, new_state = _ssd_local(xh, dt, a_neg, b, c, ssm.chunk,
                                  return_state)
    else:
        y, new_state = ssd_sequential(xh, dt, a_neg, b, c, cache.state)

    y = y + params["D"][:, None].to(y.dtype) * xh  # skip
    y = merge_heads(y)
    y = rmsnorm(params["norm_g"], y * F.silu(z))
    out = shard(y @ params["out_proj"], BATCH, None, None)
    if cache is None and not return_state:
        return out, None
    return out, MambaCache(new_state, *new_conv)


def init_mamba_cache(cfg, batch: int, dtype: torch.dtype,
                     device=None) -> MambaCache:
    ssm = cfg.ssm
    di, nh, n = dims(cfg.d_model, ssm)
    k = ssm.d_conv - 1
    return MambaCache(
        state=torch.zeros((batch, nh, ssm.head_dim, n), dtype=torch.float32,
                          device=device),
        conv_x=torch.zeros((batch, k, di), dtype=dtype, device=device),
        conv_B=torch.zeros((batch, k, n), dtype=dtype, device=device),
        conv_C=torch.zeros((batch, k, n), dtype=dtype, device=device),
    )
