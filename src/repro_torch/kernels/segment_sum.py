"""Fixed-order segment sum over a sorted segment list: Hopper CUDA kernel +
wrapper.

The port's ``jax.ops.segment_sum``.  No TPU kernel stands behind it: the
reference leaves it to XLA in the DGL-style ``csr`` arms, the segment mean
of RGCN's and GCN's NA (``src/repro/core/stages.py:305-310``) and the
softmax denominator and SpMM of the ``csr`` GAT (``:134-151``).  The CUDA
source is ``csrc/segment_sum.cu``; its header says how the kernel works.
In short: one warp a segment, the columns across the lanes, the segment's
first edge found in the sorted ``seg`` by a 32-ary search (:func:`
lower_bound_emulate` replays it), its edges added in edge order, one
rounded add after another, with no float atomics; a segment of more than
:data:`LONG` edges is listed by its warp and summed by a second kernel, one
block a segment, its rows streamed through a shared-memory ring and added
in the same order.  So a run gives the same bits every time, and the same
bits as the plain version on the CPU (``index_add_`` there adds in index
order).

What bounds it on an H100: bytes — ``seg`` (and ``idx``) once, each named
row once, the output once.

Two call forms, one kernel: the plain sum of ``vals [E, C]`` (the ``csr``
GAT's denominator over ``[E, H]`` and its SpMM over ``[E, H*Dh]``), and
the gather form ``vals[idx]`` with ``mean`` (the segment mean of the
``csr`` mean NA and of GCN), whose divisor is the segment's edge count.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (:func:`segment_sum_plain`, from ``kernels/ref.py``); a CUDA tensor
launches the kernel or raises.  ``segment_sum.launches`` counts the
launches.  :func:`segment_sum_emulate` replays the kernel's walk in
PyTorch, so the CPU tests check the design, not only the contract.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build, ref

segment_sum_plain = ref.segment_sum

# csrc/segment_sum.cu's kLong (the GPU tests hold it equal to the library's
# segment_sum_long_edges): longer segments go to the block kernel
LONG = 256


def lower_bound_emulate(seg: np.ndarray, lo: int, hi: int, s: int) -> int:
    """``csrc/segment_sum.cu``'s ``lower_bound_warp``: the first ``e`` in
    ``[lo, hi)`` with ``seg[e] >= s`` (``hi`` when there is none), by steps
    of 32 probes ``lo + l * step``; the probes below ``s`` are a prefix of
    the lanes, and their count ``c`` narrows the range to ``(probe c - 1,
    probe c]``."""
    lanes = np.arange(32)
    while hi - lo > 32:
        step = -(-(hi - lo) // 32)
        p = lo + lanes * step
        ok = p < hi
        c = int((seg[p[ok]] < s).sum())
        if c == 0:
            return lo
        lo, hi = lo + (c - 1) * step + 1, min(lo + c * step, hi)
    p = np.arange(lo, hi)
    return lo + int((seg[p] < s).sum())


def segment_bounds_emulate(seg: np.ndarray, n: int):
    """Each segment's ``[start, end)`` as the kernel finds them: the start
    by a search over the whole list, the end by one 32-edge ballot or, for
    a longer segment, a second search from ``start + 32``."""
    e = len(seg)
    starts = np.zeros(n, np.int64)
    ends = np.zeros(n, np.int64)
    for s in range(n):
        a = lower_bound_emulate(seg, 0, e, s)
        window = seg[a:min(a + 32, e)]
        inside = int((window <= s).sum())
        b = (a + inside if inside < 32
             else lower_bound_emulate(seg, a + 32, e, s + 1))
        starts[s], ends[s] = a, b
    return starts, ends


def _resolve(vals: torch.Tensor, idx: torch.Tensor,
             hot: Optional[torch.Tensor]) -> torch.Tensor:
    """The table row each index reads: ``hot[v - M]`` for a cache index
    ``v >= M`` (``M`` the table's rows), else ``v``."""
    v = idx.long()
    if hot is None:
        return v
    m = vals.shape[0]
    return torch.where(v >= m, hot.long()[(v - m).clamp(0, hot.numel() - 1)],
                       v)


def segment_sum_emulate(vals: torch.Tensor, seg: torch.Tensor, n: int,
                        idx: Optional[torch.Tensor] = None,
                        mean: bool = False,
                        hot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The CUDA kernel's algorithm in PyTorch, for the CPU tests (the
    counterpart of running a Pallas kernel in interpret mode), every
    segment at once: the bounds by the kernel's searches, then the
    segment's k-th edge added at step k, ``acc = acc + row`` rounded step
    by step from ``+0``, then ``acc / max(len, 1)`` for the mean.  A
    segment of more than :data:`LONG` edges takes the block kernel on the
    card, whose adds are the same, in the same order.  With ``hot`` a
    cache index reads the hot row it names."""
    rows_of = None if idx is None else _resolve(vals, idx, hot)
    starts, ends = segment_bounds_emulate(seg.cpu().numpy(), n)
    starts = torch.as_tensor(starts, device=vals.device)
    lens = torch.as_tensor(ends, device=vals.device) - starts
    acc = torch.zeros((n, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    for k in range(int(lens.max()) if n else 0):
        on = lens > k
        e = (starts + k)[on]
        rows = vals[e if rows_of is None else rows_of[e]]
        acc[on] = acc[on] + rows
    if mean:
        acc = acc / torch.clamp(lens.to(vals.dtype), min=1.0)[:, None]
    return acc


def check_kernel_args(vals, seg, n, idx, hot=None) -> None:
    """Raise on what the CUDA kernel does not take.  That ``seg`` is
    sorted is the caller's contract (``stages.csr_to_edges`` makes it so);
    checking it would cost a device sync."""
    if vals.dim() != 2 or seg.dim() != 1:
        raise ValueError(f"segment_sum: needs vals [E or M, C] and seg [E], "
                         f"got {tuple(vals.shape)} / {tuple(seg.shape)}")
    if idx is None and vals.shape[0] != seg.shape[0]:
        raise ValueError(f"segment_sum: vals has {vals.shape[0]} rows for "
                         f"{seg.shape[0]} edges")
    if idx is not None and idx.shape != seg.shape:
        raise ValueError(f"segment_sum: idx {tuple(idx.shape)} != seg "
                         f"{tuple(seg.shape)}")
    if n < 1 or vals.shape[1] < 1:
        raise ValueError("segment_sum: the kernel takes no empty output")
    if vals.dtype != torch.float32:
        raise ValueError(f"segment_sum: vals must be float32, got "
                         f"{vals.dtype}")
    if hot is not None and (idx is None or hot.dim() != 1
                            or hot.numel() == 0):
        raise ValueError("segment_sum: hot needs idx and is a non-empty "
                         "[C] list")
    ints = {"seg": seg} if idx is None else {"seg": seg, "idx": idx}
    if hot is not None:
        ints["hot"] = hot
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"segment_sum: {name} must be int32, got "
                             f"{t.dtype}")
    for name, t in dict(ints, vals=vals).items():
        if not t.is_contiguous():
            raise ValueError(f"segment_sum: {name} must be contiguous")


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int,
                idx: Optional[torch.Tensor] = None,
                mean: bool = False,
                hot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[s] = sum`` over the edges of segment ``s`` (``seg`` sorted
    ascending) of ``vals[e]``, or of ``vals[idx[e]]`` with ``idx``, in edge
    order; divided by ``max(len_s, 1)`` when ``mean``.  Returns ``[n, C]``;
    a segment with no edge comes out 0.  ``hot`` (residency): ``idx``
    addresses ``concat(vals, vals[hot])``, and a cache index ``v >= M``
    reads the table row ``hot[v - M]``, so no extended pool is built."""
    ts = tuple(t for t in (vals, seg, idx, hot) if t is not None)
    dev = build.device_of("segment_sum", ts)
    if dev.type in ("cpu", "meta"):  # meta: shapes only (the dry run)
        return segment_sum_plain(vals, seg, n, idx=idx, mean=mean, hot=hot)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum: no kernel for device {dev}")
    lib = build.library()
    check_kernel_args(vals, seg, n, idx, hot)
    c, e = vals.shape[1], seg.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the long segments' list, (segment, start, end) each, and its two
    # counters, 0 between launches (the kernels reset them)
    longs = build.scratch("segment_sum longs", 3 * (e // (LONG + 1) + 1),
                          torch.int32, dev, stream)
    ctr = build.scratch("segment_sum counters", 2, torch.int32, dev, stream)
    err = lib.segment_sum_hot_launch(
        vals.data_ptr(), None if idx is None else idx.data_ptr(),
        None if hot is None else hot.data_ptr(), vals.shape[0],
        seg.data_ptr(), out.data_ptr(), longs.data_ptr(), ctr.data_ptr(), e,
        n, c, int(mean), stream)
    build.check(err, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


def work(vals, seg, n: int, idx=None, mean: bool = False,
         live_only: bool = False, hot=None):
    """``(bytes, operations)`` of one call: ``seg`` (and ``idx``) once,
    the rows summed, the output once; an add per edge and column, and a
    divide per output for the mean.  The plain form reads each value once.
    The gather form reads one table row an edge with ``live_only=False``
    (the characterization record, as the reference's HLO walker charges a
    gather) and each named row once with ``live_only=True`` (the roofline
    bound).  With ``hot`` its ids once more, as ``cached_gather``'s
    work counts them."""
    e, c = seg.shape[0], vals.shape[1]
    rows = e if idx is None or not live_only else int(
        _resolve(vals, idx, hot).unique().numel())
    n_bytes = 4 * e * (1 if idx is None else 2) + 4 * rows * c + 4 * n * c
    if hot is not None:
        n_bytes += 4 * hot.numel()
    return n_bytes, e * c + (n * c if mean else 0)
