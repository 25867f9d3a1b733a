"""Padded-neighbour sum/mean aggregation (RGCN's Neighbor Aggregation hot
loop): Hopper CUDA kernel + wrapper.

Replaces the TPU kernel ``src/repro/kernels/segment_spmm.py::segment_spmm``
(``:93``; ``_accumulate :31``, ``_mean :44``, ``_kernel :52``,
``_stream_kernel :60``): ``out[n] = sum_k mask[n, k] * h_src[nbr[n, k]]``,
divided by ``max(sum_k mask[n, k], 1)`` when ``mean``.  The CUDA source is
``csrc/segment_spmm.cu``; its header says how the kernel works.  In short:
one warp per destination row and 64-column group, a ballot over 32 mask
values at a time so dead slots cost one load, the live slots accumulated in
slot order with every product and sum rounded on its own (the TPU tile's
arithmetic), then one IEEE division.

What bounds it on an H100: bytes — ``mask`` (4 bytes a slot), ``nbr`` at
the live slots, the source rows that live slots name, ``out`` once.  The TPU kernel's
resident-versus-streaming split and ``streaming.chunk_schedule`` have no
counterpart: the source table is read through L2 by every warp.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (:func:`segment_spmm_plain`, from ``kernels/ref.py``); a CUDA tensor
launches the kernel or raises.  ``segment_spmm.launches`` counts the
launches.  :func:`segment_spmm_emulate` replays the kernel's slot walk in
PyTorch, so the CPU tests check the design, not only the contract.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

segment_spmm_plain = ref.segment_spmm


def segment_spmm_emulate(h_src: torch.Tensor, nbr: torch.Tensor,
                         mask: torch.Tensor, mean: bool = True
                         ) -> torch.Tensor:
    """The CUDA kernel's algorithm in PyTorch, for the CPU tests (the
    counterpart of running a Pallas kernel in interpret mode): slots
    j = 0..K-1 in order, a masked slot skipped without reading ``h_src``,
    ``acc = acc + row * m`` and ``deg = deg + m`` rounded step by step,
    then ``acc / max(deg, 1)``."""
    n, k = nbr.shape
    acc = torch.zeros((n, h_src.shape[1]), dtype=torch.float32,
                      device=h_src.device)
    deg = torch.zeros((n, 1), dtype=torch.float32, device=h_src.device)
    for j in range(k):
        m = mask[:, j:j + 1].to(torch.float32)
        live = m != 0
        idx = torch.where(live[:, 0], nbr[:, j].long(), 0)
        acc = torch.where(live, acc + h_src[idx] * m, acc)
        deg = torch.where(live, deg + m, deg)
    if mean:
        acc = acc / torch.clamp(deg, min=1.0)
    return acc


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
