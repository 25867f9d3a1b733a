"""Causal / windowed GQA flash attention (the LM's prefill): Hopper CUDA
kernels + wrapper.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention`` (``:83``; body ``_kernel :30``): online-softmax attention
of ``q [B, S, H, Dh]`` over ``k, v [B, S, KVH, Dh]`` (query head ``h``
reads KV head ``h // G``), causal and/or within a sliding window, output
in ``q.dtype``.  The CUDA source is ``csrc/flash_attention.cu``; its header
says how the kernels work.  In short: one block per (64-row query tile,
head, batch), the kv tiles that hold no live pair for the block never
loaded, and two kernels picked by the input type:

- bf16 (the served model): QKᵀ and P·V on the tensor cores (``wgmma``,
  bf16 operands, fp32 accumulators), K copied as bf16 by ``cp.async``
  through a two-stage ring and V into one buffer.  ``scale`` multiplies the
  fp32 score after the dot (inside the exponent), and P enters P·V as two
  bf16 halves (:func:`split_hi_lo`), so P carries about 16 mantissa bits.
- fp32 (the parity arm): fp32 FMA with ``q`` scaled before the dot and P
  fp32, the TPU kernel's numbers exactly.

Unlike the TPU kernel they take any ``S`` (the tail is masked) and any
``Dh <= 128``.  What bounds them on an H100: operations (``4 * Dh`` per
live pair; the bf16 kernel does ``6 * Dh`` on the tensor cores).

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (:func:`flash_attention_plain`, ``kernels/ref.py``'s oracle); a
CUDA tensor launches the kernel of its type or raises.
``flash_attention.launches`` counts the launches.
:func:`flash_attention_emulate` replays the kernels' tile loop in PyTorch,
each arm with its own numbers, so the CPU tests check the design, not only
the contract.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

flash_attention_plain = ref.mha_attention

BLOCK_Q = 64  # query rows of a block, both kernels (kBQ, kTcBQ)
BLOCK_K = 64  # key rows of a tile (kBK)
LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 128
NEG_INF = -1e30


def kv_tiles(q0: int, s: int, causal: bool, window: int) -> range:
    """The kv tiles the kernels visit for the query tile starting at row
    ``q0``: every tile holding a live pair for some row of the tile.  A
    causal tile entirely in the future, or a tile entirely outside the
    window, is skipped (the TPU kernel's ``run`` test, ``:47-51``)."""
    k_end = min(s, q0 + BLOCK_Q) if causal else s
    first = q0 - window + 1
    lo = first // BLOCK_K if window and first > 0 else 0
    return range(lo, -(-k_end // BLOCK_K))


def split_hi_lo(p: torch.Tensor):
    """fp32 ``p`` as two bf16 halves, ``hi = bf16(p)`` and ``lo =
    bf16(p - hi)`` (``p - hi`` is exact in fp32), returned as fp32: ``hi +
    lo`` is ``p`` to about 16 mantissa bits, and 0 splits to 0 + 0.  The
    bf16 kernel multiplies both halves by V on the tensor cores."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def flash_attention_emulate(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """The CUDA kernels' algorithm in PyTorch, for the CPU tests (the
    counterpart of running a Pallas kernel in interpret mode): 64-row query
    tiles, the kv tiles of :func:`kv_tiles` in order, each an online-softmax
    step in fp32 (``-1e30`` masked scores, ``p`` zeroed after the exp, ``l``
    clamped at ``1e-30``).  fp32 inputs take the fp32 kernel's numbers
    (``q`` scaled before the dot, ``p = exp(s - m)``, P fp32 into P·V);
    bf16 inputs the tensor-core kernel's (the max taken on the unscaled
    dots, ``scale`` applied after the dot inside the exponent, ``p =
    2^((s - m) scale log2 e)``, P·V as ``P_hi V + P_lo V``).  A kv tile with
    no live pair would leave ``m``, ``l`` and ``acc`` as they are (``alpha =
    1``, ``p = 0``), so skipping it keeps the bits."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    scale = 1.0 / dh ** 0.5
    tc = q.dtype == torch.bfloat16  # the tensor-core kernel's numbers
    cl = scale * LOG2E
    qf = q.float().permute(0, 2, 1, 3)  # [B, H, S, Dh]
    if not tc:
        qf = qf * scale
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    out = torch.empty((b, h, s, dh), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, BLOCK_Q):
        rows = torch.arange(q0, min(q0 + BLOCK_Q, s), device=q.device)
        qt = qf[:, :, q0:q0 + BLOCK_Q]
        m = torch.full((b, h, len(rows), 1), NEG_INF, device=q.device)
        l = torch.zeros((b, h, len(rows), 1), device=q.device)
        acc = torch.zeros((b, h, len(rows), dh), device=q.device)
        for kt in kv_tiles(q0, s, causal, window):
            k0 = kt * BLOCK_K
            cols = torch.arange(k0, min(k0 + BLOCK_K, s), device=q.device)
            sc = qt @ kf[:, :, k0:k0 + BLOCK_K].transpose(-1, -2)
            live = torch.ones((len(rows), len(cols)), dtype=torch.bool,
                              device=q.device)
            if causal:
                live &= rows[:, None] >= cols[None, :]
            if window:
                live &= rows[:, None] - cols[None, :] < window
            sc = torch.where(live, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            vt = vf[:, :, k0:k0 + BLOCK_K]
            if tc:
                alpha = torch.exp2((m - m_new) * cl)
                p = torch.where(live, torch.exp2(sc * cl - m_new * cl), 0.0)
                p_hi, p_lo = split_hi_lo(p)
                pv = p_hi @ vt + p_lo @ vt
            else:
                alpha = torch.exp(m - m_new)
                p = torch.where(live, torch.exp(sc - m_new), 0.0)
                pv = p @ vt
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + pv
            m = m_new
        out[:, :, q0:q0 + BLOCK_Q] = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def check_kernel_args(q, k, v, window: int = 0) -> None:
    """Raise on what the CUDA kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: needs q [B, S, H, Dh] and k/v "
                         f"[B, S, KVH, Dh], got {tuple(q.shape)} / "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    b, s, h, dh = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, dh):
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (self-attention only)")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {k.shape[2]} KV heads")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {dh} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """``q [B, S, H, Dh]``, ``k, v [B, S, KVH, Dh]`` -> ``[B, S, H, Dh]``
    in ``q.dtype``; ``window`` 0 means no window."""
    dev = build.device_of("flash_attention", (q, k, v))
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    check_kernel_args(q, k, v, window)
    lib = build.library()
    b, s, h, dh = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        k.shape[2], dh, int(causal), int(window), 1.0 / dh ** 0.5,
        int(q.dtype == torch.bfloat16), stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
