"""Fused Feature Projection + Neighbour Aggregation: Hopper CUDA kernel +
wrapper.

Replaces the TPU kernel ``src/repro/kernels/fused_fp_na.py::fused_fp_na``
(``:91``; ``_kernel :43``, ``_stream_kernel :54``, ``_write_partial
:32``): ``out = mean_k(x[nbr]) @ W`` by linearity, the raw features
aggregated per F-tile and the aggregate projected inside the kernel.  The
CUDA source is ``csrc/fused_fp_na.cu``; its header says how the kernel
works.  In short: one block per 16 destination rows, the
live slots compacted once, then per F-tile of ``BLOCK_F`` columns the
aggregate tile built in shared memory with :mod:`segment_spmm`'s slot walk
and ``W``'s rows staged beside it, and the ``[rows, D]`` product
accumulated in registers (fp32 FMA, k in order).  ``out`` is written once;
no partial goes to device memory and nothing is summed across blocks.

What bounds it on an H100: the raw rows that live slots name and the
``2*N*F*D`` operations of the product, about equally at the RGCN/imdb
``(M, md, D)`` shape.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (:func:`fused_fp_na_plain`, from ``kernels/ref.py``); a CUDA tensor
launches the kernel or raises.  ``fused_fp_na.launches`` counts the
launches.  :func:`fused_fp_na_emulate` replays the kernel's F-tile loop in
PyTorch for the CPU tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.segment_spmm import segment_spmm_emulate

BLOCK_F = 64  # csrc/fused_fp_na.cu's kBF: raw-feature columns per F-tile

fused_fp_na_plain = ref.fused_fp_na


def fused_fp_na_emulate(x_src: torch.Tensor, w: torch.Tensor,
                        nbr: torch.Tensor, mask: torch.Tensor,
                        mean: bool = True) -> torch.Tensor:
    """The CUDA kernel's algorithm in PyTorch, for the CPU tests: F-tiles
    of ``BLOCK_F`` columns in order (the last one partial), each tile's
    aggregate from :func:`segment_spmm_emulate` (the mean taken per tile),
    and the product accumulated over the features in order."""
    n, f = nbr.shape[0], x_src.shape[1]
    out = torch.zeros((n, w.shape[1]), dtype=torch.float32,
                      device=x_src.device)
    for f0 in range(0, f, BLOCK_F):
        agg = segment_spmm_emulate(x_src[:, f0:f0 + BLOCK_F], nbr, mask,
                                   mean=mean)
        for kk in range(agg.shape[1]):
            out = torch.addcmul(out, agg[:, kk:kk + 1], w[f0 + kk])
    return out


def check_kernel_args(x_src, w, nbr, mask) -> None:
    """Raise on layouts the CUDA kernel does not take.  Its launcher refuses
    a ``D`` other than 64 and a ``K`` whose shared memory does not fit a
    block, which :func:`build.check` turns into an error."""
    if (x_src.dim() != 2 or w.dim() != 2 or nbr.dim() != 2
            or mask.shape != nbr.shape or w.shape[0] != x_src.shape[1]):
        raise ValueError(f"fused_fp_na: needs x [M, F], W [F, D] and "
                         f"nbr/mask [N, K] of one shape, got "
                         f"{tuple(x_src.shape)} / {tuple(w.shape)} / "
                         f"{tuple(nbr.shape)} / {tuple(mask.shape)}")
    if nbr.dtype != torch.int32:
        raise ValueError(f"fused_fp_na: nbr must be int32, got {nbr.dtype}")
    for name, t in (("x", x_src), ("W", w), ("mask", mask)):
        if t.dtype != torch.float32:
            raise ValueError(
                f"fused_fp_na: {name} must be float32, got {t.dtype}")
    for name, t in (("x", x_src), ("W", w), ("nbr", nbr), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"fused_fp_na: {name} must be contiguous")


def fused_fp_na(x_src: torch.Tensor, w: torch.Tensor, nbr: torch.Tensor,
                mask: torch.Tensor, mean: bool = True) -> torch.Tensor:
    """``x [M, F]``, ``W [F, D]``, ``nbr``/``mask`` ``[N, K]`` ->
    ``[N, D]``.  Live slots (``mask != 0``) must name rows of ``x``."""
    dev = build.device_of("fused_fp_na", (x_src, w, nbr, mask))
    if dev.type == "cpu":
        return fused_fp_na_plain(x_src, w, nbr, mask, mean=mean)
    if dev.type != "cuda":
        raise ValueError(f"fused_fp_na: no kernel for device {dev}")
    lib = build.library()
    check_kernel_args(x_src, w, nbr, mask)
    n, k = nbr.shape
    f, d = w.shape
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fused_fp_na_launch(x_src.data_ptr(), w.data_ptr(),
                                 nbr.data_ptr(), mask.data_ptr(),
                                 out.data_ptr(), n, k, f, d, int(mean),
                                 stream)
    build.check(err, "fused_fp_na")
    fused_fp_na.launches += 1
    return out


fused_fp_na.launches = 0
