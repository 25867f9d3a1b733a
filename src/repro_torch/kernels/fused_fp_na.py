"""Fused Feature Projection + Neighbour Aggregation: Hopper CUDA kernel +
wrapper.

Replaces the TPU kernel ``src/repro/kernels/fused_fp_na.py::fused_fp_na``
(``:91``; ``_kernel :43``, ``_stream_kernel :54``, ``_write_partial
:32``): ``out = mean_k(x[nbr]) @ W`` by linearity, the raw features
aggregated per F-tile and the aggregate projected inside the kernel.  The
CUDA source is ``csrc/fused_fp_na.cu``; its header says how the kernel
works.  In short: the grid is ``SLICES`` F-slices by tiles of ``ROWS``
destination rows; each block compacts its rows' live slots once into one
list, then per F-tile of ``BLOCK_F`` columns streams the listed rows
through a ``cp.async`` ring in shared memory (the whole block's gathers in
flight together, whichever row they serve), builds the masked-sum tile
with :mod:`segment_spmm`'s arithmetic (a thread a column of every fourth
row) and multiplies it by ``W``'s tile on the tensor cores with a 3xTF32
split (:func:`tf32_split`), which keeps about fp32's precision; the
slices' ``[rows, D]`` partials go to a scratch buffer and the row tile's
last block sums them in slice order and, for the mean, divides by the
degree once an output (by linearity the TPU kernel's per-tile mean).
``out`` is written once; neither the aggregate nor the projected table
goes to device memory, and no float is summed with atomics.

What bounds it on an H100: the ``2*N*F*D`` operations of the product,
then the raw rows that live slots name, at the RGCN/imdb ``(M, md, D)``
shape.

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
SLICES = 8  # its kSlices: F-slices a row tile
ROWS = 64  # its kRows: destination rows a block (the GPU tests hold both
# equal to the library's fused_fp_na_slices / fused_fp_na_rows)

fused_fp_na_plain = ref.fused_fp_na


def tf32_split(a: torch.Tensor):
    """``a = hi + lo`` as the kernel splits an operand: ``hi`` is ``a``
    rounded to TF32 (10 mantissa bits, to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``), ``lo`` is ``a - hi`` rounded the same
    way."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(a)
    return hi, rna(a - hi)


def fused_fp_na_emulate(x_src: torch.Tensor, w: torch.Tensor,
                        nbr: torch.Tensor, mask: torch.Tensor,
                        mean: bool = True) -> torch.Tensor:
    """The CUDA kernel's algorithm in PyTorch, for the CPU tests: the F-tiles
    of ``BLOCK_F`` columns (the last one partial) dealt to ``SLICES``
    slices of ``ceil(tiles / SLICES)`` tiles in order; per tile the masked
    sum from :func:`segment_spmm_emulate`; per slice the product
    accumulated over its features in steps of 8 from 0, each step the
    kernel's 3xTF32 split (``lo·hi + hi·lo + hi·hi``, see
    :func:`tf32_split`); then the slice partials summed in slice order,
    partial 0 first, and with ``mean`` divided by ``max(deg, 1)``, ``deg``
    the row's mask summed in slot order."""
    n, f = nbr.shape[0], x_src.shape[1]
    n_tiles = -(-f // BLOCK_F)
    per = -(-n_tiles // SLICES)
    out = None
    for s in range(SLICES):
        part = torch.zeros((n, w.shape[1]), dtype=torch.float32,
                           device=x_src.device)
        for t in range(min(n_tiles, s * per), min(n_tiles, (s + 1) * per)):
            f0 = t * BLOCK_F
            agg = segment_spmm_emulate(x_src[:, f0:f0 + BLOCK_F], nbr, mask,
                                       mean=False)
            for k0 in range(0, agg.shape[1], 8):
                a_hi, a_lo = tf32_split(agg[:, k0:k0 + 8])
                b_hi, b_lo = tf32_split(w[f0 + k0:f0 + k0 + 8])
                part = part + a_lo @ b_hi
                part = part + a_hi @ b_lo
                part = part + a_hi @ b_hi
        out = part if out is None else out + part
    if mean:
        deg = torch.zeros((n, 1), dtype=torch.float32, device=x_src.device)
        for j in range(nbr.shape[1]):  # slot order
            deg = deg + mask[:, j:j + 1].to(torch.float32)
        out = out / torch.clamp(deg, min=1.0)
    return out


def check_kernel_args(x_src, w, nbr, mask) -> None:
    """Raise on layouts the CUDA kernel does not take.  Its launcher refuses
    a ``D`` other than 64, a ``W`` off a 16-byte boundary and a ``K`` whose
    shared memory does not fit a block (``K`` above 334: a row tile's slot
    list holds ``ROWS * K`` entries), which :func:`build.check` turns into
    an error."""
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
    if w.data_ptr() % 16:
        raise ValueError("fused_fp_na: W must start on a 16-byte boundary "
                         "(the kernel reads its rows in 16-byte loads)")


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
    tiles = -(-n // ROWS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the slices' partials, and a finished-slice count per row tile that is
    # 0 between launches (the kernel resets it)
    part = build.scratch("fused_fp_na part", SLICES * tiles * ROWS * d,
                         torch.float32, dev, stream)
    done = build.scratch("fused_fp_na done", tiles, torch.int32, dev, stream)
    err = lib.fused_fp_na_launch(x_src.data_ptr(), w.data_ptr(),
                                 nbr.data_ptr(), mask.data_ptr(),
                                 out.data_ptr(), part.data_ptr(),
                                 done.data_ptr(), n, k, f, d, int(mean),
                                 stream)
    build.check(err, "fused_fp_na")
    fused_fp_na.launches += 1
    return out


fused_fp_na.launches = 0
