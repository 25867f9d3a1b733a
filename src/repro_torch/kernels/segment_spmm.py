"""Padded-neighbour sum/mean aggregation (RGCN's Neighbor Aggregation hot
loop): Hopper CUDA kernel + wrapper.

Replaces the TPU kernel ``src/repro/kernels/segment_spmm.py::segment_spmm``
(``:93``; ``_accumulate :31``, ``_mean :44``, ``_kernel :52``,
``_stream_kernel :60``): ``out[n] = sum_k mask[n, k] * h_src[nbr[n, k]]``,
divided by ``max(sum_k mask[n, k], 1)`` when ``mean``.  The CUDA source is
``csrc/segment_spmm.cu``; its header says how the kernel works.  In short:
a block owns ``ROWS`` destination rows and a 64-column group and walks K in
windows of ``WINDOW`` slots; per window it compacts its rows' live slots
into one list (rows in order, slots in order), streams the listed source
rows through a ring of ``STAGES`` chunks of ``CHUNK`` entries in shared
memory, all in flight together, and each row's 16 threads (4 columns
each) add its entries in slot order with every product and sum rounded on
its own (the TPU tile's arithmetic), then one IEEE division.  So a row
with many live slots costs shared-memory steps, not dependent DRAM round
trips.

What bounds it on an H100: bytes — ``mask`` (4 bytes a slot), ``nbr`` at
the live slots, the source rows that live slots name, ``out`` once.  The TPU kernel's
resident-versus-streaming split and ``streaming.chunk_schedule`` have no
counterpart: the source table is read through L2 by every block.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (:func:`segment_spmm_plain`, from ``kernels/ref.py``); a CUDA tensor
launches the kernel or raises.  ``segment_spmm.launches`` counts the
launches.  :func:`segment_spmm_emulate` replays the kernel's walk (blocks,
windows, the compacted list, ring chunks) in PyTorch, so the CPU tests
check the design, not only the contract.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

segment_spmm_plain = ref.segment_spmm


# csrc/segment_spmm.cu's kRows, kWin, kChunk and kStages (the GPU tests
# hold them equal to the library's segment_spmm_geometry)
ROWS = 16  # destination rows a block
WINDOW = 64  # slots a window
CHUNK = 128  # list entries a ring stage
STAGES = 2  # ring stages, all in flight together


def segment_spmm_emulate(h_src: torch.Tensor, nbr: torch.Tensor,
                         mask: torch.Tensor, mean: bool = True
                         ) -> torch.Tensor:
    """The CUDA kernel's algorithm in PyTorch, for the CPU tests (the
    counterpart of running a Pallas kernel in interpret mode), every block
    at once: the rows in blocks of ``ROWS`` (the last one padded with rows
    that have no live slot); per window of ``WINDOW`` slots, each block's
    live slots compacted into one list, rows in order and slots in order
    (a masked slot's index is never read); the list's source rows gathered
    a ring chunk of ``CHUNK`` entries at a time; each entry added to its
    row in list order, ``acc = acc + row * m`` and ``deg = deg + m``
    rounded step by step, the sums carried across chunks and windows; then
    ``acc / max(deg, 1)``."""
    n, k = nbr.shape
    d = h_src.shape[1]
    dev = h_src.device
    blocks = -(-n // ROWS)
    pad = blocks * ROWS - n
    m_b = torch.nn.functional.pad(mask.to(torch.float32), (0, 0, 0, pad))
    n_b = torch.nn.functional.pad(nbr, (0, 0, 0, pad))
    m_b = m_b.reshape(blocks, ROWS, k)
    n_b = n_b.reshape(blocks, ROWS, k)
    acc = torch.zeros((blocks, ROWS, d), dtype=torch.float32, device=dev)
    deg = torch.zeros((blocks, ROWS, 1), dtype=torch.float32, device=dev)
    b_ids = torch.arange(blocks, device=dev)
    for w0 in range(0, k, WINDOW):
        width = min(WINDOW, k - w0)
        m_w = m_b[:, :, w0:w0 + width].reshape(blocks, ROWS * width)
        n_w = n_b[:, :, w0:w0 + width].reshape(blocks, ROWS * width)
        live = m_w != 0
        n_live = live.sum(dim=1)
        # the list: the live slots first, in row-major (row, slot) order
        order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
        s_row = order // width
        s_m = m_w.gather(1, order)
        s_ok = torch.arange(order.shape[1], device=dev)[None] < n_live[:, None]
        s_idx = torch.where(s_ok, n_w.gather(1, order), 0).long()
        for lo in range(0, int(n_live.max()) if blocks else 0, CHUNK):
            stage = h_src[s_idx[:, lo:lo + CHUNK]]  # the ring chunk
            for u in range(stage.shape[1]):
                e = lo + u
                ok = s_ok[:, e, None]
                r = s_row[:, e]
                m = s_m[:, e, None]
                cur = acc[b_ids, r]
                acc[b_ids, r] = torch.where(ok, cur + stage[:, u] * m, cur)
                cur = deg[b_ids, r]
                deg[b_ids, r] = torch.where(ok, cur + m, cur)
    if mean:
        acc = acc / torch.clamp(deg, min=1.0)
    return acc.reshape(blocks * ROWS, d)[:n]


def check_kernel_args(h_src, nbr, mask) -> None:
    """Raise on what the CUDA kernel does not take."""
    if h_src.dim() != 2 or nbr.dim() != 2 or mask.shape != nbr.shape:
        raise ValueError(f"segment_spmm: needs h_src [M, D] and nbr/mask "
                         f"[N, K] of one shape, got {tuple(h_src.shape)} / "
                         f"{tuple(nbr.shape)} / {tuple(mask.shape)}")
    if nbr.dtype != torch.int32:
        raise ValueError(f"segment_spmm: nbr must be int32, got {nbr.dtype}")
    for name, t in (("h_src", h_src), ("mask", mask)):
        if t.dtype != torch.float32:
            raise ValueError(
                f"segment_spmm: {name} must be float32, got {t.dtype}")
    for name, t in (("h_src", h_src), ("nbr", nbr), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"segment_spmm: {name} must be contiguous")


def segment_spmm(h_src: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
                 mean: bool = True) -> torch.Tensor:
    """``h_src [M, D]``, ``nbr``/``mask`` ``[N, K]`` -> ``[N, D]``.  Live
    slots (``mask != 0``) must name rows of ``h_src``."""
    dev = build.device_of("segment_spmm", (h_src, nbr, mask))
    if dev.type == "cpu":
        return segment_spmm_plain(h_src, nbr, mask, mean=mean)
    if dev.type != "cuda":
        raise ValueError(f"segment_spmm: no kernel for device {dev}")
    lib = build.library()
    check_kernel_args(h_src, nbr, mask)
    n, k = nbr.shape
    d = h_src.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.segment_spmm_launch(h_src.data_ptr(), nbr.data_ptr(),
                                  mask.data_ptr(), out.data_ptr(), n, k, d,
                                  int(mean), stream)
    build.check(err, "segment_spmm")
    segment_spmm.launches += 1
    return out


segment_spmm.launches = 0
