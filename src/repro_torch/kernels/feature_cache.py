"""Hot-row feature-cache gather (the residency arm of MAGNN's instance
gathers): Hopper CUDA kernel + wrapper.

Replaces the TPU kernel ``src/repro/kernels/feature_cache.py::
cached_gather`` (``:34``; body ``_kernel :26``): a gather from the extended
pool ``concat(table, table[hot])``, whose indices ``>= N`` address the
cache section of the hot rows.  The CUDA source is
``csrc/feature_cache.cu``; its header says how the kernel works.  In short:
one launch and no fill — an index ``v >= N`` reads ``table[hot[v - N]]``
directly, which is bitwise the cache row the fill would have copied, and
an index ``v < N`` reads ``table[v]``; 16 lanes an index with 16-byte
copies, several indices in flight a thread, a persistent grid, the output
written once, the index read through its strides (a position of MAGNN's
``[N, I, L]`` instance table is a strided view), every row clamped into
the table.

What bounds it on an H100: bytes — the output once, the indices and the
hot ids once, at most the table once.  The hot rows stay in the 50 MB L2
after their first touch: the counterpart of the TPU kernel's VMEM-resident
cache block.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (:func:`cached_gather_plain`, from ``kernels/ref.py``); a CUDA
tensor launches the kernel or raises.  ``cached_gather.launches`` counts
the launches.  :func:`cached_gather_emulate` replays the kernel's
per-index choice in PyTorch, so the CPU tests check the design, not only
the contract.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

cached_gather_plain = ref.cached_gather


def cached_gather_emulate(table: torch.Tensor, hot: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's algorithm in PyTorch, for the CPU tests (the
    counterpart of running a Pallas kernel in interpret mode): per index
    the table row ``hot[min(idx - N, C - 1)]`` (clamped into the table)
    when ``idx >= N``, else the table row ``max(idx, 0)``; no cache is
    filled."""
    n, c = table.shape[0], hot.shape[0]
    v = idx.long()
    hot_ids = hot.long()[torch.clamp(v - n, 0, c - 1)]
    hot_rows = table[torch.clamp(hot_ids, 0, n - 1)]
    cold_rows = table[torch.clamp(v, 0, n - 1)]
    return torch.where((v >= n)[..., None], hot_rows, cold_rows)


def check_kernel_args(table, hot, idx) -> None:
    """Raise on what the CUDA kernel does not take.  ``idx`` and ``hot``
    may be strided views (their strides go to the kernel); ``table`` must
    be contiguous."""
    if table.dim() != 2 or hot.dim() != 1 or idx.dim() not in (1, 2):
        raise ValueError(f"cached_gather: needs table [N, D], hot [C] and "
                         f"idx [R] or [R, I], got {tuple(table.shape)} / "
                         f"{tuple(hot.shape)} / {tuple(idx.shape)}")
    if table.shape[0] == 0 or table.shape[1] == 0 or hot.shape[0] == 0 \
            or idx.numel() == 0:
        raise ValueError("cached_gather: the kernel takes no empty inputs")
    if table.shape[0] + hot.shape[0] >= 2 ** 31:
        raise ValueError("cached_gather: the pool must have < 2**31 rows")
    if table.dtype != torch.float32:
        raise ValueError(
            f"cached_gather: table must be float32, got {table.dtype}")
    for name, t in (("hot", hot), ("idx", idx)):
        if t.dtype != torch.int32:
            raise ValueError(
                f"cached_gather: {name} must be int32, got {t.dtype}")
    if not table.is_contiguous():
        raise ValueError("cached_gather: table must be contiguous")


def cached_gather(table: torch.Tensor, hot: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """``table [N, D]``, ``hot [C]``, ``idx`` with values in ``[0, N+C)``
    -> ``idx.shape + (D,)``: the rows of ``concat(table, table[hot])``."""
    dev = build.device_of("cached_gather", (table, hot, idx))
    if dev.type == "cpu":
        return cached_gather_plain(table, hot, idx)
    if dev.type != "cuda":
        raise ValueError(f"cached_gather: no kernel for device {dev}")
    lib = build.library()
    check_kernel_args(table, hot, idx)
    n, d = table.shape
    out = torch.empty(tuple(idx.shape) + (d,), dtype=torch.float32,
                      device=dev)
    if idx.dim() == 1:
        rows, cols, stride_r, stride_c = idx.shape[0], 1, idx.stride(0), 0
    else:
        (rows, cols), (stride_r, stride_c) = idx.shape, idx.stride()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.cached_gather_launch(
        table.data_ptr(), hot.data_ptr(), idx.data_ptr(), out.data_ptr(),
        n, hot.shape[0], d, hot.stride(0), rows, cols, stride_r, stride_c,
        stream)
    build.check(err, "cached_gather")
    cached_gather.launches += 1
    return out


cached_gather.launches = 0
