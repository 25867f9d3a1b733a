"""Semantic Aggregation (SA) of the stacked ``[P, N, D]`` input: Hopper
CUDA kernels for both passes + wrappers.

Pass 2, the weighted combine, replaces the TPU kernel
``src/repro/kernels/semantic_attn.py::semantic_combine`` (``:153``, body
``_combine_kernel :50``): ``out[n] = sum_p beta_p z[p, n]`` in fp32, one
read of the stack.  The CUDA source is ``csrc/semantic_combine.cu``: a
thread two 16-byte vectors of the output (4-byte ones where z or out is
off a 16-byte boundary or ``N*D % 4 != 0``), ``p`` walked in order,
products and sums rounded one by one as the plain version rounds them.
Bound by bytes (``P*N*D*4`` read, ``N*D*4`` written; 3.3 MB at the main
shape, about 1 us at 3.35 TB/s).

Pass 1, the scores, replaces ``semantic_scores`` (``:100``; bodies
``_score_kernel :27``, ``_score_stream_kernel :58``):
``w_p = mean_n q·tanh(z_p,n W + b)``.  The CUDA source is
``csrc/semantic_scores.cu``: one launch of at most one block an SM; a
block stages ``W`` in shared memory once and walks tiles of 64 to 128
rows (the launcher picks the least that fits every tile in one wave:
``tile_rows``) through a ``cp.async`` ring, their products by FMA from
shared memory; each tile's row scores are summed in row order into a
partial indexed by tile, and the last block to finish sums each
metapath's partials in a fixed order (no float atomics).  Bound by
operations (``2*P*N*D*Hs``; 1.4e8 at ``[2, 4278, 64]`` with Hs = 128, 2.1
us at 67 TFLOP/s).  The TPU kernel's streaming twin has no counterpart:
one design covers every N.

``ops.semantic_attention`` composes the two as the reference's
``semantic_attention`` does (``:175``): scores, softmax over ``P``,
combine.  No executor path calls it — the fused NA epilogue computes
HAN's scores and the unfused SA is plain PyTorch, as in the reference.

Dispatch is by device: a CPU tensor takes the plain version
(``kernels/ref.py``); a CUDA tensor launches the kernel or raises.
``semantic_combine.launches`` and ``semantic_scores.launches`` count the
launches.  :func:`semantic_scores_emulate` replays the scores kernel's
order of sums in PyTorch for the CPU tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.gat_na import SMEM_LIMIT

semantic_combine_plain = ref.semantic_combine
semantic_scores_plain = ref.semantic_scores
# csrc/semantic_scores.cu: the fewest rows a tile (8 warps of 8 rows),
# kFC and kMaxHs
MIN_TILE_ROWS = 64
RING_FEATURES = 32
MAX_HS = 256


def smem_bytes(d: int, hs: int) -> int:
    """The scores kernel's shared memory at its smallest tile (its
    ``semantic_scores_smem_bytes``): W zero-padded to ``[round4(D),
    round4(Hs)]``, the two-stage z ring and a tile's row scores."""
    def round4(x):
        return (x + 3) // 4 * 4

    return 4 * (round4(d) * round4(hs) + (2 * RING_FEATURES + 1) *
                MIN_TILE_ROWS)


def tile_rows(z: torch.Tensor, w: torch.Tensor) -> int:
    """The rows of a tile that the scores kernel takes at these shapes on
    this card (64 to 128: the least that fits every tile in one wave)."""
    p, n, d = z.shape
    return build.library().semantic_scores_tile_rows(p, n, d, w.shape[1])


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
    build.device_of("semantic_combine", (z,))  # a DTensor raises
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


def combine_work(z, beta):
    """``(bytes, operations)`` of one combine: z and beta read once, the
    ``[N, D]`` output written once; ``P`` multiplies and ``P - 1`` adds an
    output element."""
    p, n, d = z.shape
    return z.numel() * 4 + p * 4 + n * d * 4, (2 * p - 1) * n * d


def semantic_scores_emulate(z: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, q: torch.Tensor,
                            tile: int = MIN_TILE_ROWS) -> torch.Tensor:
    """The scores kernel's order of sums in PyTorch, for the CPU tests: one
    score ``q·tanh(z W + b)`` a row; the rows of each tile of ``tile`` rows
    (the kernel's: :func:`tile_rows`) summed in row order (rows past N add
    0); lane ``l`` of 32 sums tiles ``l, l + 32, ...`` in order; the lanes
    by the kernel's xor butterfly (halves added pairwise: 16, 8, 4, 2, 1);
    then / N."""
    p, n, _ = z.shape
    score = (torch.tanh(z @ w + b) * q).sum(-1)  # [P, N]
    n_tiles = -(-n // tile)
    score = torch.nn.functional.pad(score, (0, n_tiles * tile - n))
    score = score.reshape(p, n_tiles, tile)
    partial = torch.zeros((p, n_tiles), dtype=z.dtype, device=z.device)
    for r in range(tile):
        partial = partial + score[:, :, r]
    partial = torch.nn.functional.pad(partial, (0, -n_tiles % 32))
    lanes = torch.zeros((p, 32), dtype=z.dtype, device=z.device)
    for t in range(0, partial.shape[1], 32):
        lanes = lanes + partial[:, t:t + 32]
    while lanes.shape[1] > 1:
        half = lanes.shape[1] // 2
        lanes = lanes[:, :half] + lanes[:, half:]
    return lanes[:, 0] / n


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
    if smem_bytes(d, hs) > SMEM_LIMIT:
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = build.scratch("semantic_scores partial",
                            p * -(-n // MIN_TILE_ROWS), torch.float32, dev,
                            stream)
    done = build.scratch("semantic_scores done", 1, torch.int32, dev, stream)
    out = torch.empty((p,), dtype=torch.float32, device=dev)
    err = lib.semantic_scores_launch(z.data_ptr(), w.data_ptr(), b.data_ptr(),
                                     q.data_ptr(), partial.data_ptr(),
                                     done.data_ptr(), out.data_ptr(), p, n, d,
                                     w.shape[1], stream)
    build.check(err, "semantic_scores")
    semantic_scores.launches += 1
    return out


semantic_scores.launches = 0


def scores_work(z, w):
    """``(bytes, operations)`` of one scores call: z, W, b, q read once, w
    written once; per row ``zW + b`` (2*D*Hs: the kernel's D FFMAs a
    column from b), the tanh and the q dot (3*Hs), and the mean.  The
    kernel does all of it in fp32 outside the tensor cores."""
    p, n, d = z.shape
    hs = w.shape[1]
    n_bytes = (z.numel() + d * hs + 2 * hs + p) * 4
    return n_bytes, p * n * (2 * d * hs + 3 * hs + 1)

