"""One-token GQA attention over a KV cache (the LM's decode step): Hopper
CUDA kernels + wrapper.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py::
decode_attention`` (``:72``; body ``_kernel :28``): the new token's query
``q [B, H, Dh]`` attends over the first ``kv_len[b]`` rows of the cache
``k, v [B, S, KVH, Dh]`` (query head ``h`` reads KV head ``h // G``), fp32
arithmetic whatever the input type, output in ``q.dtype``.  The CUDA source
is ``csrc/decode_attention.cu``; its header says how the kernels work.  In
short: split-KV — one warp per (cache split of :data:`SPLIT_ROWS` rows,
KV head, batch row) computes the online-softmax partials ``(m, l, acc)``
of the group's query heads (four at a time) over :data:`TILE`-row tiles
that arrive by ``cp.async`` through a ring of :data:`STAGES` stages of its
own, a split at or past ``kv_len`` returns at once, and a second kernel
combines the live splits in split order (no atomics: the same bits on
every run).  ``kv_len`` stays on
the device.

The log-sum-exp form (``return_lse=True``) also returns ``lse [B, H]``
fp32, each row's ``m + log(l)`` over its live rows, written by the
combine kernel beside ``o`` (``o`` is the same bits either way); a row
with no live row gives ``o = 0`` and ``lse = -1e30``.  A rank of a
sequence-sharded cache runs it on its shard, and the ranks' partials are
combined by their log-sum-exps (``nn/attention.py::_combine_partials``).
No TPU kernel has this form: the reference leaves a sequence-sharded
decode to XLA's partial softmaxes.

What bounds it on an H100: bytes — the live K and V rows.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (:func:`decode_attention_plain`, ``kernels/ref.py``'s oracle); a
CUDA tensor launches the kernels or raises.  ``decode_attention.launches``
counts the launches (one a call: both kernels);
``decode_attention.lse_launches`` counts those of the log-sum-exp form
among them (``ops.launch_counts()["decode_attention_lse"]``).
:func:`decode_attention_emulate` replays the split loop in PyTorch, so the
CPU tests check the design, not only the contract.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

decode_attention_plain = ref.decode_attention

SPLIT_ROWS = 64  # cache rows of one split (a warp; four splits a block)
TILE = 8  # cache rows of a ring stage: one softmax step (kTile)
STAGES = 4  # a warp's copy ring (kStages): a split's 8 tiles go round twice
MAX_HEAD_DIM = 128
NEG_INF = -1e30


def decode_attention_emulate(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, kv_len,
                             return_lse: bool = False):
    """The CUDA kernels' algorithm in PyTorch, for the CPU tests: for each
    batch row, the splits holding a row below ``kv_len`` (never a row at or
    past it), each an online softmax over its :data:`TILE`-row tiles in
    fp32 (``q`` scaled before the dot, ``l`` clamped at ``1e-30``), then
    the partials rescaled to their common max and summed in split order.
    ``return_lse``: also each row's ``m + log(max(l, 1e-30))``, ``-1e30``
    for a row with no live row, as the combine kernel writes it."""
    b, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / dh ** 0.5
    lens = torch.as_tensor(kv_len).reshape(-1).expand(b).tolist()
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device)
    for bi in range(b):
        n = min(int(lens[bi]), s)
        qb = q[bi].float() * scale  # [H, Dh]
        kb = k[bi].float().repeat_interleave(g, dim=1)  # [S, H, Dh]
        vb = v[bi].float().repeat_interleave(g, dim=1)
        parts = []
        for r0 in range(0, n, SPLIT_ROWS):
            r1 = min(r0 + SPLIT_ROWS, n)
            m = torch.full((h, 1), NEG_INF, device=q.device)
            l = torch.zeros((h, 1), device=q.device)
            acc = torch.zeros((h, dh), device=q.device)
            for t0 in range(r0, r1, TILE):
                t1 = min(t0 + TILE, r1)
                sc = torch.einsum("hd,thd->ht", qb, kb[t0:t1])
                m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
                p = torch.exp(sc - m_new)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + torch.einsum("ht,thd->hd", p, vb[t0:t1])
                m = m_new
            parts.append((m, l, acc))
        if not parts:
            out[bi] = 0.0
            continue
        m_all = torch.stack([p[0] for p in parts]).amax(dim=0)
        l_all = torch.zeros_like(m_all)
        acc_all = torch.zeros((h, dh), device=q.device)
        for m, l, acc in parts:  # split order
            w = torch.exp(m - m_all)
            l_all = l_all + l * w
            acc_all = acc_all + acc * w
        out[bi] = acc_all / torch.clamp(l_all, min=1e-30)
        lse[bi] = (m_all + torch.log(torch.clamp(l_all, min=1e-30)))[:, 0]
    if return_lse:
        return out.to(q.dtype), lse
    return out.to(q.dtype)


def check_kernel_args(q, k, v, kv_len) -> None:
    """Raise on what the CUDA kernels do not take."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention: needs q [B, H, Dh] and k/v "
                         f"[B, S, KVH, Dh], got {tuple(q.shape)} / "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    b, h, dh = q.shape
    if (k.shape[0], k.shape[3]) != (b, dh):
        raise ValueError(f"decode_attention: cache {tuple(k.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"decode_attention: {h} query heads are not a "
                         f"multiple of {k.shape[2]} KV heads")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {dh} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attention: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    if (not torch.is_tensor(kv_len) or kv_len.dtype != torch.int32
            or kv_len.shape != (b,) or kv_len.device != q.device):
        raise ValueError("decode_attention: kv_len must be an int32 [B] "
                         "tensor on q's device")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len, return_lse: bool = False):
    """``q [B, H, Dh]`` over the first ``kv_len[b]`` rows of ``k, v [B, S,
    KVH, Dh]`` -> ``[B, H, Dh]`` in ``q.dtype``; with ``return_lse``
    ``(o, lse [B, H] fp32)`` (the module docstring).  On the card
    ``kv_len`` is an int32 ``[B]`` tensor on the same device, never read
    by the host."""
    dev = build.device_of("decode_attention", (q, k, v))
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len, return_lse=return_lse)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {dev}")
    check_kernel_args(q, k, v, kv_len)
    lib = build.library()
    b, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    nsplit = max(-(-s // SPLIT_ROWS), 1)
    part_ml = torch.empty((b, h, nsplit, 2), dtype=torch.float32, device=dev)
    part_acc = torch.empty((b, h, nsplit, dh), dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h), dtype=torch.float32, device=dev)
           if return_lse else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, h, kvh, dh,
        SPLIT_ROWS, nsplit, 1.0 / dh ** 0.5, int(q.dtype == torch.bfloat16),
        stream)
    build.check(err, "decode_attention")
    decode_attention.launches += 1
    if return_lse:
        decode_attention.lse_launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
decode_attention.lse_launches = 0


def work(q, k, kv_len, return_lse: bool = False):
    """``(bytes, operations)`` of one call: the live cache rows of k and v,
    q, the output, kv_len and, in the log-sum-exp form, the fp32 ``lse``;
    4 Dh operations a head a live row."""
    b, h, dh = q.shape
    lens = torch.as_tensor(kv_len).reshape(-1).expand(b)
    live = int(lens.clamp(min=0, max=k.shape[1]).sum())
    n_bytes = ((2 * live * k.shape[2] * dh + 2 * q.numel())
               * q.element_size() + 4 * b + 4 * b * h * return_lse)
    return n_bytes, 4 * live * h * dh
