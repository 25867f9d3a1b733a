"""Semantic Aggregation (SA) of the stacked ``[P, N, D]`` input: Hopper
CUDA kernels for both passes + wrappers.

Pass 2, the weighted combine, replaces the TPU kernel
``src/repro/kernels/semantic_attn.py::semantic_combine`` (``:153``, body
``_combine_kernel :50``): ``out[n] = sum_p beta_p z[p, n]`` in fp32, one
read of the stack.  The CUDA source is ``csrc/semantic_combine.cu``: one
thread per output element, ``p`` walked in order, products and sums
rounded one by one as the plain version rounds them.  Bound by bytes
(``P*N*D*4`` read, ``N*D*4`` written; 3.3 MB at the main shape, about 1 us
at 3.35 TB/s), so the design is one pass with coalesced accesses.

Pass 1, the scores, replaces ``semantic_scores`` (``:100``; bodies
``_score_kernel :27``, ``_score_stream_kernel :58``):
``w_p = mean_n q·tanh(z_p,n W + b)``.  The CUDA source is
``csrc/semantic_scores.cu``: ``W`` staged in shared memory, a warp four
rows with their columns' FMA chains in registers, row scores summed per
block of ``ROWS_PER_BLOCK`` rows in row order, then over blocks in a
second kernel (no float atomics).  Bound by operations
(``2*P*N*D*Hs``; 1.4e8 at ``[2, 4278, 64]`` with Hs = 128, 2.1 us at 67
TFLOP/s).  The TPU kernel's streaming twin has no counterpart: one design
covers every N.

:func:`semantic_attention` composes the two as the reference does
(``:175``): scores, softmax over ``P``, combine.  No executor path calls
it — the fused NA epilogue computes HAN's scores and the unfused SA is
plain PyTorch, as in the reference — so it is reached through
``ops.semantic_attention``.

Dispatch is by device: a CPU tensor takes the plain version
(``kernels/ref.py``); a CUDA tensor launches the kernel or raises.
``semantic_combine.launches`` and ``semantic_scores.launches`` count the
launches.  :func:`semantic_scores_emulate` replays the scores kernel's
block-ordered sum in PyTorch for the CPU tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

semantic_combine_plain = ref.semantic_combine
semantic_scores_plain = ref.semantic_scores
# csrc/semantic_scores.cu's kRowsPerBlock and kMaxColChunks * 32
ROWS_PER_BLOCK = 32
MAX_HS = 256


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


def semantic_scores_emulate(z: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The scores kernel's algorithm in PyTorch, for the CPU tests: one
    score ``q·tanh(z W + b)`` a row, the rows of each block of
    ``ROWS_PER_BLOCK`` summed in row order (rows past N add 0), the blocks
    summed in block order, then / N."""
    p, n, _ = z.shape
    score = (torch.tanh(z @ w + b) * q).sum(-1)  # [P, N]
    n_blocks = -(-n // ROWS_PER_BLOCK)
    score = torch.nn.functional.pad(score, (0, n_blocks * ROWS_PER_BLOCK - n))
    score = score.reshape(p, n_blocks, ROWS_PER_BLOCK)
    partial = torch.zeros((p, n_blocks), dtype=z.dtype, device=z.device)
    for r in range(ROWS_PER_BLOCK):
        partial = partial + score[:, :, r]
    total = torch.zeros((p,), dtype=z.dtype, device=z.device)
    for i in range(n_blocks):
        total = total + partial[:, i]
    return total / n


def check_scores_args(z, w, b, q) -> None:
    """Raise on what the scores kernel does not take."""
    if z.dim() != 3 or w.dim() != 2 or w.shape[0] != z.shape[2] \
            or b.shape != (w.shape[1],) or q.shape != (w.shape[1],):
        raise ValueError(f"semantic_scores: needs z [P, N, D], W [D, Hs], "
                         f"b [Hs], q [Hs], got {tuple(z.shape)} / "
                         f"{tuple(w.shape)} / {tuple(b.shape)} / "
                         f"{tuple(q.shape)}")
    if 0 in tuple(z.shape) or w.shape[1] == 0:
        raise ValueError("semantic_scores: the kernel takes no empty inputs")
    d, hs = w.shape
    if hs > MAX_HS:
        raise ValueError(f"semantic_scores: the kernel takes Hs <= {MAX_HS}, "
                         f"got {hs}")
    if 4 * (d * hs + ROWS_PER_BLOCK * (d + 1)) > 232448:
        raise ValueError("semantic_scores: W does not fit one block's shared "
                         "memory")
    for name, t in (("z", z), ("W", w), ("b", b), ("q", q)):
        if t.dtype != torch.float32:
            raise ValueError(
                f"semantic_scores: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"semantic_scores: {name} must be contiguous")


def semantic_scores(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    """SA pass 1: ``z [P, N, D]``, ``W [D, Hs]``, ``b``/``q [Hs]`` ->
    ``w [P]`` with ``w_p = mean_n q·tanh(z_p,n W + b)``."""
    dev = build.device_of("semantic_scores", (z, w, b, q))
    if dev.type == "cpu":
        return semantic_scores_plain(z, w, b, q)
    if dev.type != "cuda":
        raise ValueError(f"semantic_scores: no kernel for device {dev}")
    lib = build.library()
    check_scores_args(z, w, b, q)
    p, n, d = z.shape
    partial = torch.empty((p, -(-n // ROWS_PER_BLOCK)), dtype=torch.float32,
                          device=dev)
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.semantic_scores_launch(z.data_ptr(), w.data_ptr(), b.data_ptr(),
                                     q.data_ptr(), partial.data_ptr(),
                                     out.data_ptr(), p, n, d, w.shape[1],
                                     stream)
    build.check(err, "semantic_scores")
    semantic_scores.launches += 1
    return out


semantic_scores.launches = 0


def semantic_attention(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       q: torch.Tensor) -> torch.Tensor:
    """Both SA passes: the scores, the softmax over ``P``, the combine."""
    beta = torch.softmax(semantic_scores(z, w, b, q), dim=0)
    return semantic_combine(z, beta)
