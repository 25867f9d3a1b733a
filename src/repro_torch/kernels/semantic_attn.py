"""Semantic Aggregation pass 2 (the weighted combine): Hopper CUDA kernel +
wrapper.

Replaces the TPU kernel ``src/repro/kernels/semantic_attn.py::
semantic_combine`` (``:153``, body ``_combine_kernel :50``):
``out[n] = sum_p beta_p z[p, n]`` in fp32, one read of the ``[P, N, D]``
stack.  The CUDA source is ``csrc/semantic_combine.cu``: one thread per
output element, ``p`` walked in order, products and sums rounded one by one
as the plain version rounds them.

What bounds it on an H100: bytes (``P*N*D*4`` read, ``N*D*4`` written; 3.3
MB at the main shape, about 1 us at 3.35 TB/s), so the design is one pass
with coalesced accesses.

SA pass 1 (``semantic_scores``, ``:100``) is not on the port's path — the
fused NA epilogue computes the scores, and the unfused SA is plain PyTorch
as in the reference — so it is still to port (ROADMAP Queue 2).

Dispatch is by device: a CPU tensor takes :func:`semantic_combine_plain`
(``kernels/ref.py``); a CUDA tensor launches the kernel or raises.
``semantic_combine.launches`` counts the launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

semantic_combine_plain = ref.semantic_combine


def check_kernel_args(z: torch.Tensor, beta: torch.Tensor) -> None:
    """Raise on what the CUDA kernel does not take."""
    if z.dim() != 3 or beta.shape != (z.shape[0],) or z.shape[0] == 0:
        raise ValueError(f"semantic_combine: needs z [P, N, D] and beta [P], "
                         f"got {tuple(z.shape)} / {tuple(beta.shape)}")
    for name, t in (("z", z), ("beta", beta)):
        if t.dtype != torch.float32:
            raise ValueError(
                f"semantic_combine: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"semantic_combine: {name} must be contiguous")


def semantic_combine(z: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """``z [P, N, D]``, ``beta [P]`` -> ``[N, D]``."""
    if z.device != beta.device:
        raise ValueError(f"semantic_combine: z on {z.device}, beta on "
                         f"{beta.device}")
    if z.device.type == "cpu":
        return semantic_combine_plain(z, beta)
    if z.device.type != "cuda":
        raise ValueError(f"semantic_combine: no kernel for device {z.device}")
    lib = build.library()
    check_kernel_args(z, beta)
    p, n, d = z.shape
    out = torch.empty((n, d), dtype=torch.float32, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = lib.semantic_combine_launch(z.data_ptr(), beta.data_ptr(),
                                      out.data_ptr(), p, n * d, stream)
    build.check(err, "semantic_combine")
    semantic_combine.launches += 1
    return out


semantic_combine.launches = 0
