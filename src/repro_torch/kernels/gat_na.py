"""Fused multi-head GAT Neighbor Aggregation: Hopper CUDA kernel + wrapper.

Replaces the TPU kernel ``src/repro/kernels/gat_na.py::gat_na`` (``:225``;
``_tile_update :62``, ``_resident_kernel :144``, ``_streaming_kernel :168``
and the fused NA→SA epilogue ``_sa_epilogue :109``).  The CUDA source is
``csrc/gat_na.cu``; its header says how the kernel works.  In short: a
persistent grid whose warps take destination rows from a work counter, the
K neighbour slots taken 32 at a time with one ballot that compacts the
live ones, their source rows gathered a batch at a time (every load of a
batch in flight together) and fed to an online softmax in slot order, and
with ``sem=`` the epilogue ``z = elu(out)``, ``w_s = mean_n q·tanh(z W +
b)`` as a register-blocked tile product of a warp's last 4 ``z`` rows and
``W`` (copied to shared memory by ``cp.async`` once a block), the row
scores then summed by a second kernel in a fixed order (no float
atomics).

What bounds it on an H100: bytes — ``nbr``/``mask`` (8 bytes a slot), one
``h_src`` row per live slot at most (the 1.1 MB HAN/imdb table stays in the
50 MB L2), ``h_dst`` once and ``z`` written once; at HAN/imdb that is a few
microseconds, so latency and the per-slot softmax instructions set the
time.  The TPU kernel's resident-versus-streaming split (an 8 MB VMEM
budget) has no counterpart: the source table is read through L2 by every
row, so one kernel covers both, and ``streaming.chunk_schedule`` is not
needed.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (:func:`gat_na_plain`, from ``kernels/ref.py``); a CUDA tensor
launches the kernel or raises.  ``gat_na.launches`` counts the launches
(``gat_na.fused_launches`` the ones with the epilogue).  The unstacked
call form (``nbr``/``mask`` ``[N, K]``, ``a_dst``/``a_src`` ``[H, Dh]``,
MAGNN's instance attention) is lifted to the stacked one with S = 1, as
the reference's ``_normalize`` does (``gat_na.py:217-222``).
:func:`gat_na_emulate` replays the kernel's own algorithm (slot order,
online softmax, block-ordered score sum) in PyTorch, so the CPU tests
check the design, not only the contract.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import build, ref

# csrc/gat_na.cu's kRowsPerBlock (rows a partial of the score sum) and
# kMaxChunks * 32 (the GPU tests hold them equal to the library's
# gat_na_rows_per_block / gat_na_max_features)
ROWS_PER_BLOCK = 16
MAX_FEATURES = 256
EPILOGUE_COLS = 128  # the epilogue's columns a pass: 4 a lane
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100


def smem_bytes(hd: int, hs: int) -> int:
    """Shared memory of the kernel with the epilogue, as ``csrc/gat_na.cu``'s
    ``smem_bytes`` reckons it (the GPU tests hold the two equal through the
    library's ``gat_na_smem_bytes``): slot indices, ``W`` with rows padded
    to 4, and each warp's 4 ``z`` rows (32 warps a block up to 64 features,
    else 16)."""
    warps = 32 if hd <= 64 else 16
    return 4 * (warps * 32 + hd * (-(-hs // 4) * 4) + warps * hd * 4)


def _butterfly(x: torch.Tensor) -> torch.Tensor:
    """An xor-shuffle sum over the last dim of 32 lanes, as lane 0 ends it:
    halves added pairwise, 16 then 8, 4, 2, 1 apart."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _lift(p: Dict[str, torch.Tensor], nbr, mask):
    """``(p, nbr, mask, stacked)`` in the stacked form: the unstacked call
    form ``[N, K]`` gains a metapath dim of 1."""
    if nbr.dim() == 2:
        return {k: v[None] for k, v in p.items()}, nbr[None], mask[None], False
    return p, nbr, mask, True


def _unlift(out, stacked: bool):
    if stacked:
        return out
    if isinstance(out, tuple):  # (z, w) of the epilogue
        return out[0][0], out[1][0]
    return out[0]


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
    ``max(denom, 1e-9)`` finish (the kernel's batched gathers do not change
    this arithmetic), and with ``sem`` the kernel's score order: per row,
    ``q·tanh(zW + b)`` summed over a lane's columns (``128 j + 4 lane + c``)
    in order, then over the 32 lanes by a butterfly; then the rows in
    blocks of ``ROWS_PER_BLOCK`` in order, the blocks lane-strided over 32
    lanes in order, the lanes by a butterfly, / N.  Either call form."""
    p, nbr, mask, stacked = _lift(p, nbr, mask)
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
        return _unlift(out, stacked)
    z = torch.nn.functional.elu(out)
    hs = sem["W"].shape[1]
    val = sem["q"] * torch.tanh(z.reshape(s_dim, n, -1) @ sem["W"]
                                + sem["b"])  # [S, N, Hs]
    n_cb = -(-hs // EPILOGUE_COLS)
    val = torch.nn.functional.pad(val, (0, n_cb * EPILOGUE_COLS - hs))
    val = val.reshape(s_dim, n, n_cb, 32, 4)  # column 128 j + 4 lane + c
    per_lane = torch.zeros((s_dim, n, 32), dtype=val.dtype,
                           device=val.device)
    for j in range(n_cb):  # a lane's columns in order
        for c in range(4):
            per_lane = per_lane + val[:, :, j, :, c]
    score = _butterfly(per_lane)  # [S, N] one score a row
    n_blocks = -(-n // ROWS_PER_BLOCK)
    score = torch.nn.functional.pad(score,
                                    (0, n_blocks * ROWS_PER_BLOCK - n))
    score = score.reshape(s_dim, n_blocks, ROWS_PER_BLOCK)
    partial = torch.zeros((s_dim, n_blocks), dtype=score.dtype,
                          device=score.device)
    for r in range(ROWS_PER_BLOCK):  # a block's rows in order
        partial = partial + score[:, :, r]
    n_lanes = -(-n_blocks // 32) * 32
    partial = torch.nn.functional.pad(partial, (0, n_lanes - n_blocks))
    partial = partial.reshape(s_dim, n_lanes // 32, 32)
    lanes = torch.zeros((s_dim, 32), dtype=score.dtype, device=score.device)
    for i in range(partial.shape[1]):  # lane l: blocks l, l + 32, ...
        lanes = lanes + partial[:, i]
    return _unlift((z, _butterfly(lanes) / n), stacked)


def check_kernel_args(p, h_dst, h_src, nbr, mask, sem=None) -> None:
    """Raise on what the CUDA kernel does not take (either call form),
    among it a ``W`` whose epilogue does not fit a block's shared memory
    (:func:`smem_bytes`: ``Hs`` above 764 at ``H*Dh = 64``, above 160 at
    256)."""
    if nbr.dim() not in (2, 3) or mask.shape != nbr.shape:
        raise ValueError(f"gat_na: nbr/mask must be [S, N, K] or [N, K] of "
                         f"one shape, got {tuple(nbr.shape)} / "
                         f"{tuple(mask.shape)}")
    p, nbr, mask, _ = _lift(p, nbr, mask)
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
        if smem_bytes(n_heads * dh, hs) > SMEM_LIMIT:
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
    stream = torch.cuda.current_stream(h_dst.device).cuda_stream
    sem_w = sem_b = sem_q = score = w = None
    hs = 0
    if sem is not None:
        sem_w, sem_b, sem_q = sem["W"], sem["b"], sem["q"]
        hs = sem_w.shape[1]
        score = build.scratch("gat_na score", s_dim * n, torch.float32,
                              h_dst.device, stream)  # one score a row
        w = torch.empty((s_dim,), dtype=torch.float32, device=h_dst.device)
    # the rows' work counter: 0 between launches (the kernel resets it)
    work = build.scratch("gat_na work", 1, torch.int32, h_dst.device, stream)

    def ptr(t):  # ctypes passes None as a null pointer
        return None if t is None else t.data_ptr()

    err = lib.gat_na_launch(
        h_dst.data_ptr(), h_src.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
        p["a_dst"].data_ptr(), p["a_src"].data_ptr(), ptr(sem_w), ptr(sem_b),
        ptr(sem_q), out.data_ptr(), ptr(score), ptr(w), work.data_ptr(),
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
    ``w_s = mean_n q·tanh(z_s W + b)``.  The unstacked form (``[H, Dh]``
    params, ``[N, K]`` tables) returns ``[N, H, Dh]`` (``(z, w)`` with a
    scalar ``w``).
    """
    if nbr.dim() not in (2, 3):
        raise ValueError(f"gat_na: takes nbr/mask [S, N, K] or [N, K], "
                         f"got nbr {tuple(nbr.shape)}")
    sem_t = tuple(sem.values()) if sem is not None else ()
    dev = build.device_of("gat_na", (h_dst, h_src, nbr, mask, *p.values(),
                                     *sem_t))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gat_na: no kernel for device {dev}")
    p, nbr, mask, stacked = _lift(p, nbr, mask)
    run = gat_na_plain if dev.type == "cpu" else _launch
    return _unlift(run(p, h_dst, h_src, nbr, mask, sem), stacked)


gat_na.launches = 0
gat_na.fused_launches = 0


def work(h_dst, h_src, nbr, mask, hs: int = 0, live_only: bool = False):
    """``(bytes, operations)`` of one call on these inputs, either call
    form: ``nbr``/``mask`` (8 bytes a slot), ``h_dst`` and ``a_dst``/
    ``a_src`` read once, the output written once; ``e_dst`` per row and
    head, ``e_src = a_src·h`` per source row read, and per slot the
    add, leaky relu, max, shift, exp and denominator per head plus a
    multiply-add per feature; the final divide.  With ``hs`` (the ``sem=``
    epilogue's width) also ``W``, ``b``, ``q`` read and ``w`` written, and
    per row the elu, ``zW + b``, the tanh and the ``q`` dot, then the mean.

    ``live_only=False`` counts the gather structurally, one source row read
    a slot, live or masked (as the reference's HLO walker charges a gather:
    the characterization record).  ``live_only=True`` counts what the
    function must do on these data: only the slots that are live, each
    named source row read once and not at all when ``h_src`` is ``h_dst``
    (the roofline bound of ``chip_smoke.py``)."""
    if nbr.dim() == 2:
        nbr, mask = nbr[None], mask[None]
    s_dim, n, k = nbr.shape
    heads = h_dst.shape[1]
    hd = heads * h_dst.shape[2]
    n_bytes = 2 * nbr.numel() * 4 + n * hd * 4 + s_dim * n * hd * 4
    n_bytes += 2 * s_dim * hd * 4  # a_dst, a_src
    if live_only:
        live = int((mask != 0).sum())
        named = [nbr[s][mask[s] != 0].unique() for s in range(s_dim)]
        if h_src.data_ptr() != h_dst.data_ptr():
            n_bytes += int(torch.cat(named).unique().numel()) * hd * 4
        src_rows = sum(int(r.numel()) for r in named)
    else:
        live = src_rows = nbr.numel()
        n_bytes += src_rows * hd * 4
    n_ops = 2 * s_dim * n * hd  # e_dst
    n_ops += 2 * hd * src_rows  # e_src
    n_ops += live * (6 * heads + 2 * hd)
    n_ops += s_dim * n * hd  # the final divide
    if hs:
        n_bytes += (hd * hs + 2 * hs) * 4 + s_dim * 4  # W, b, q; w
        n_ops += s_dim * n * (hd + 2 * hd * hs + 4 * hs) + s_dim * n
    return n_bytes, n_ops
