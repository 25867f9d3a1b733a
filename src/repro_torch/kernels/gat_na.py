"""Fused multi-head GAT Neighbor Aggregation: Hopper CUDA kernel + wrapper.

Replaces the TPU kernel ``src/repro/kernels/gat_na.py::gat_na`` (``:225``;
``_tile_update :62``, ``_resident_kernel :144``, ``_streaming_kernel :168``
and the fused NA→SA epilogue ``_sa_epilogue :109``).  The CUDA source is
``csrc/gat_na.cu``; its header says how the kernel works.  In short: one
warp per destination row, the K neighbour slots walked in order with an
online softmax, every live slot gathering one source row once, and with
``sem=`` the epilogue ``z = elu(out)``, ``w_s = mean_n q·tanh(z W + b)``
computed in the kernel body with ``W`` staged in shared memory and the row
scores reduced in a fixed order (no float atomics).

What bounds it on an H100: bytes — ``nbr``/``mask`` (8 bytes a slot), one
``h_src`` row per live slot at most (the 1.1 MB HAN/imdb table stays in the
50 MB L2), ``h_dst`` once and ``z`` written once.  The TPU kernel's
resident-versus-streaming split (an 8 MB VMEM budget) has no counterpart:
the source table is read through L2 by every row, so one kernel covers
both, and ``streaming.chunk_schedule`` is not needed.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (:func:`gat_na_plain`, from ``kernels/ref.py``); a CUDA tensor
launches the kernel or raises.  ``gat_na.launches`` counts the launches
(``gat_na.fused_launches`` the ones with the epilogue).
:func:`gat_na_emulate` replays the kernel's own algorithm (slot order,
online softmax, block-ordered score sum) in PyTorch, so the CPU tests
check the design, not only the contract.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import build, ref

# csrc/gat_na.cu's kRowsPerBlock and kMaxChunks * 32 (the GPU tests hold
# them equal to the library's gat_na_rows_per_block / gat_na_max_features)
ROWS_PER_BLOCK = 16
MAX_FEATURES = 256


def gat_na_plain(p: Dict[str, torch.Tensor], h_dst, h_src, nbr, mask,
                 sem: Optional[Dict[str, torch.Tensor]] = None):
    """The plain PyTorch version of :func:`gat_na`, same contract."""
    if sem is None:
        return ref.gat_na(p, h_dst, h_src, nbr, mask)
    return ref.gat_na_fused_sa(p, h_dst, h_src, nbr, mask, sem["W"],
                               sem["b"], sem["q"])


def gat_na_emulate(p: Dict[str, torch.Tensor], h_dst, h_src, nbr, mask,
                   sem: Optional[Dict[str, torch.Tensor]] = None):
    """The CUDA kernel's algorithm in PyTorch, for the CPU tests (the
    counterpart of running a Pallas kernel in interpret mode): the slots
    j = 0..K-1 in order, masked ones skipped, an online softmax per head
    (running max from -1e9, denominator, rescaled accumulator), the
    ``max(denom, 1e-9)`` finish, and with ``sem`` the row scores summed per
    block of ``ROWS_PER_BLOCK`` rows, then over blocks, then / N.  Stacked
    form only (``nbr [S, N, K]``)."""
    s_dim, n, k = nbr.shape
    idx = nbr.long()
    e_dst = (h_dst[None] * p["a_dst"][:, None]).sum(-1)  # [S, N, H]
    a_src = p["a_src"][:, None]  # [S, 1, H, Dh]
    m = torch.full_like(e_dst, ref._NEG)
    den = torch.zeros_like(e_dst)
    acc = torch.zeros((s_dim,) + tuple(h_dst.shape), dtype=h_dst.dtype,
                      device=h_dst.device)
    for j in range(k):  # slot order, as the kernel walks it
        live = (mask[:, :, j] != 0)[..., None]  # [S, N, 1]
        h = h_src[idx[:, :, j]]  # [S, N, H, Dh]
        e = e_dst + (a_src * h).sum(-1)
        e = torch.where(e >= 0, e, 0.2 * e)
        m_new = torch.maximum(m, e)
        scale = torch.exp(m - m_new)
        pw = torch.exp(e - m_new)
        den = torch.where(live, den * scale + pw, den)
        acc = torch.where(live[..., None],
                          acc * scale[..., None] + pw[..., None] * h, acc)
        m = torch.where(live, m_new, m)
    out = acc / torch.clamp(den, min=1e-9)[..., None]
    if sem is None:
        return out
    z = torch.nn.functional.elu(out)
    score = torch.tanh(z.reshape(s_dim, n, -1) @ sem["W"] + sem["b"])
    score = (score * sem["q"]).sum(-1)  # [S, N] one score a row
    n_blocks = -(-n // ROWS_PER_BLOCK)
    score = torch.nn.functional.pad(score,
                                    (0, n_blocks * ROWS_PER_BLOCK - n))
    partial = score.reshape(s_dim, n_blocks, ROWS_PER_BLOCK).sum(-1)
    return z, partial.sum(-1) / n



def check_kernel_args(p, h_dst, h_src, nbr, mask, sem=None) -> None:
    """Raise on what the CUDA kernel does not take (stacked form)."""
    if nbr.dim() != 3 or mask.shape != nbr.shape:
        raise ValueError(f"gat_na: nbr/mask must be [S, N, K] of one shape, "
                         f"got {tuple(nbr.shape)} / {tuple(mask.shape)}")
    s_dim, n, k = nbr.shape
    if h_dst.dim() != 3 or h_src.dim() != 3:
        raise ValueError("gat_na: h_dst/h_src must be [rows, H, Dh]")
    _, n_heads, dh = h_src.shape
    if tuple(h_dst.shape) != (n, n_heads, dh):
        raise ValueError(f"gat_na: h_dst {tuple(h_dst.shape)} != "
                         f"({n}, {n_heads}, {dh})")
    for name in ("a_dst", "a_src"):
        if tuple(p[name].shape) != (s_dim, n_heads, dh):
            raise ValueError(f"gat_na: {name} {tuple(p[name].shape)} != "
                             f"({s_dim}, {n_heads}, {dh})")
    if n == 0 or k == 0 or s_dim == 0 or h_src.shape[0] == 0:
        raise ValueError("gat_na: the kernel takes no empty inputs")
    if 32 % dh != 0:
        raise ValueError(f"gat_na: the kernel needs a head dim that divides "
                         f"32, got Dh={dh}")
    if n_heads * dh > MAX_FEATURES:
        raise ValueError(f"gat_na: the kernel takes H*Dh <= {MAX_FEATURES}, "
                         f"got {n_heads * dh}")
    tensors = {"h_dst": h_dst, "h_src": h_src, "mask": mask,
               "a_dst": p["a_dst"], "a_src": p["a_src"]}
    if sem is not None:
        hs = sem["W"].shape[1]
        if (tuple(sem["W"].shape) != (n_heads * dh, hs)
                or tuple(sem["b"].shape) != (hs,)
                or tuple(sem["q"].shape) != (hs,)):
            raise ValueError("gat_na: sem needs W [H*Dh, Hs], b [Hs], q [Hs]")
        if 4 * (n_heads * dh * hs + ROWS_PER_BLOCK) > 232448:
            raise ValueError("gat_na: W does not fit one block's shared memory")
        tensors.update(W=sem["W"], b=sem["b"], q=sem["q"])
    if nbr.dtype != torch.int32:
        raise ValueError(f"gat_na: nbr must be int32, got {nbr.dtype}")
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"gat_na: {name} must be float32, got {t.dtype}")
    for name, t in dict(tensors, nbr=nbr).items():
        if not t.is_contiguous():
            raise ValueError(f"gat_na: {name} must be contiguous")


def _launch(p, h_dst, h_src, nbr, mask, sem):
    lib = build.library()
    check_kernel_args(p, h_dst, h_src, nbr, mask, sem)
    s_dim, n, k = nbr.shape
    _, n_heads, dh = h_src.shape
    out = torch.empty((s_dim, n, n_heads, dh), dtype=torch.float32,
                      device=h_dst.device)
    sem_w = sem_b = sem_q = partial = w = None
    hs = 0
    if sem is not None:
        sem_w, sem_b, sem_q = sem["W"], sem["b"], sem["q"]
        hs = sem_w.shape[1]
        partial = torch.empty((s_dim, -(-n // ROWS_PER_BLOCK)),
                              dtype=torch.float32, device=h_dst.device)
        w = torch.empty((s_dim,), dtype=torch.float32, device=h_dst.device)

    def ptr(t):  # ctypes passes None as a null pointer
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(h_dst.device).cuda_stream
    err = lib.gat_na_launch(
        h_dst.data_ptr(), h_src.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
        p["a_dst"].data_ptr(), p["a_src"].data_ptr(), ptr(sem_w), ptr(sem_b),
        ptr(sem_q), out.data_ptr(), ptr(partial), ptr(w),
        s_dim, n, k, n_heads, dh, hs, stream)
    build.check(err, "gat_na")
    gat_na.launches += 1
    if sem is not None:
        gat_na.fused_launches += 1
        return out, w
    return out


def gat_na(p: Dict[str, torch.Tensor], h_dst: torch.Tensor,
           h_src: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
           sem: Optional[Dict[str, torch.Tensor]] = None):
    """Fused multi-head GAT NA; one launch for the whole metapath stack.

    ``p`` holds ``a_dst``/``a_src`` ``[S, H, Dh]``, ``h_dst [N, H, Dh]``,
    ``h_src [M, H, Dh]``, ``nbr``/``mask`` ``[S, N, K]``.  Returns
    ``[S, N, H, Dh]``; with ``sem`` (``W [H*Dh, Hs]``, ``b``, ``q [Hs]``)
    returns ``(z, w [S])`` with ``z = elu(out)`` and
    ``w_s = mean_n q·tanh(z_s W + b)``.
    """
    if nbr.dim() != 3:
        raise ValueError(f"gat_na: takes the stacked form nbr/mask "
                         f"[S, N, K], got nbr {tuple(nbr.shape)}")
    sem_t = tuple(sem.values()) if sem is not None else ()
    dev = build.device_of("gat_na", (h_dst, h_src, nbr, mask, *p.values(),
                                     *sem_t))
    if dev.type == "cpu":
        return gat_na_plain(p, h_dst, h_src, nbr, mask, sem)
    if dev.type != "cuda":
        raise ValueError(f"gat_na: no kernel for device {dev}")
    return _launch(p, h_dst, h_src, nbr, mask, sem)


gat_na.launches = 0
gat_na.fused_launches = 0
