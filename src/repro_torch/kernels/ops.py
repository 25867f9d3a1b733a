"""Public kernel entry points (port of ``repro/kernels/ops.py:30-139``, and
of the kernel calls of the LM's ``nn/attention.py:288-291, 355-358``).

Dispatch policy:

* ``use_pallas=False`` is the plan's own plain arm (the counterpart of the
  reference's XLA arm): the plain PyTorch versions of ``kernels/ref.py``
  on any device.
* ``use_pallas=True`` goes to the kernel wrapper, which picks by the
  tensors' device and by nothing else: a CPU tensor runs the plain version
  (this is how the CPU tests run the kernel path), a CUDA tensor launches
  the hand-written kernel and raises if the build or the launch fails.
  There is no fallback from a CUDA tensor to the plain version.

Every kernel is called here, so this is where a kernel-arm call declares
its work to the characterization recorder (``core/characterize.py``): its
class, FLOPs and bytes from the ``work`` helper beside its wrapper, with
gathers counted structurally, in place of the aten ops that the call runs
(the wrapper's allocations on the card, the plain version on the CPU, so
that both give the same records).  ``segment_sum`` declares on any device;
a ``use_pallas=False`` call declares nothing, and its aten ops are counted
one by one.  With no recorder active a call costs one check of an empty
list more.

The name ``use_pallas`` is the reference's; here it means "hand-written
kernels".  ``flash_attention`` and ``decode_attention`` serve the LM's
prefill and decode (``nn/attention.py``); the reference takes its Pallas
kernels there only on a TPU backend, which here is the device rule above.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.characterize import declared
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import feature_cache as _fc
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_fp_na as _ffn
from repro_torch.kernels import gat_na as _gat
from repro_torch.kernels import ref
from repro_torch.kernels import segment_spmm as _spmm
from repro_torch.kernels import segment_sum as _ssum
from repro_torch.kernels import semantic_attn as _sem


def _ffn_work(x, w, nbr, mask):
    """``fused_fp_na``'s declared work: the product counted once (the
    kernel's 3xTF32 split runs it three times over) beside the
    aggregate's operations."""
    n_bytes, n_ops, tf32_ops = _ffn.work(x, w, nbr, mask)
    return n_bytes, n_ops + tf32_ops // 3


def _gat_na(p, h_dst, h_src, nbr, mask, sem=None):
    """The ``gat_na`` kernel, every call form, with its declared work."""
    hs = 0 if sem is None else sem["W"].shape[1]
    return declared(
        "TB", lambda: _gat.work(h_dst, h_src, nbr, mask, hs),
        _gat.gat_na, p, h_dst, h_src, nbr, mask, sem=sem)


def segment_spmm(h_src, nbr, mask, mean: bool = True,
                 use_pallas: bool = False) -> torch.Tensor:
    """Padded-neighbour sum/mean aggregation (RGCN's mean NA):
    ``h_src [M, D]``, ``nbr``/``mask`` ``[N, K]`` -> ``[N, D]``."""
    if use_pallas:
        return declared(
            "TB", lambda: _spmm.work(h_src.shape[1], nbr, mask),
            _spmm.segment_spmm, h_src, nbr, mask, mean=mean)
    return ref.segment_spmm(h_src, nbr, mask, mean=mean)


def segment_sum(vals, seg, n: int, idx=None, mean: bool = False,
                hot=None) -> torch.Tensor:
    """Fixed-order segment sum over a sorted edge list (the ``csr`` arms'
    ``jax.ops.segment_sum``): ``vals [E, C]``, or the rows ``vals[idx]``,
    summed per segment in edge order -> ``[n, C]`` (``mean``: divided by
    each segment's edge count).  The reference's ``csr`` arms do not
    depend on ``use_pallas``, so this dispatches by the tensors' device
    alone: the CPU's plain version or the card's kernel.  The stages call
    it here, so a harness can record their calls in one place.  ``hot``:
    the residency arm's hot rows, read through the cache indices."""
    return declared(
        "TB", lambda: _ssum.work(vals, seg, n, idx, mean, hot=hot),
        _ssum.segment_sum, vals, seg, n, idx=idx, mean=mean, hot=hot)


def fused_fp_na(x_src, w, nbr, mask, mean: bool = True,
                use_pallas: bool = False) -> torch.Tensor:
    """Fused FP + NA: ``mean_k(x[nbr]) @ W`` with the projection in the
    kernel body: ``x [M, F]``, ``W [F, D]`` -> ``[N, D]``."""
    if use_pallas:
        return declared("DM", lambda: _ffn_work(x_src, w, nbr, mask),
                        _ffn.fused_fp_na, x_src, w, nbr, mask, mean=mean)
    return ref.fused_fp_na(x_src, w, nbr, mask, mean=mean)


def semantic_attention(z, w, b, q, use_pallas: bool = False) -> torch.Tensor:
    """Both SA passes over the stacked ``[P, N, D]`` input: the scores
    kernel, the softmax over ``P``, the combine kernel."""
    if use_pallas:
        scores = declared(
            "DM", lambda: _sem.scores_work(z, w),
            _sem.semantic_scores, z, w, b, q)
        return semantic_combine(z, torch.softmax(scores, dim=0),
                                use_pallas=True)
    return ref.semantic_attention(z, w, b, q)


def cached_gather(table, hot, idx, use_pallas: bool = False) -> torch.Tensor:
    """Hot-row cache gather (``core/residency.py``): the rows of the
    extended pool ``concat(table, table[hot])``; indices ``>= len(table)``
    hit the cache section."""
    if use_pallas:
        return declared(
            "TB", lambda: _fc.work(table, hot, idx),
            _fc.cached_gather, table, hot, idx)
    return ref.cached_gather(table, hot, idx)


def gather_rows(table, idx, use_pallas: bool = False) -> torch.Tensor:
    """``table[idx]``, a plain row gather on every device (MAGNN's
    instance positions of a type with no hot rows).  On the kernel arm it
    is counted by :func:`cached_gather`'s rule, a row read an index, so
    the records count the cached and the uncached gathers of one arm
    alike; on the plain arm it is the aten op, as the plain cached gather
    is."""
    if use_pallas:
        return declared(
            "TB", lambda: _fc.work(table, idx.new_empty(0), idx),
            _plain_gather, table, idx)
    return _plain_gather(table, idx)


def _plain_gather(table, idx):
    return table[idx.long()]


def gat_aggregate(p: Dict, h_dst, h_src, nbr, mask,
                  use_pallas: bool = False) -> torch.Tensor:
    """Unstacked GAT NA: ``nbr/mask [N, K]``, params ``[H, Dh]`` ->
    ``[N, H, Dh]`` (MAGNN's instance attention, one launch a metapath)."""
    if use_pallas:
        return _gat_na(p, h_dst, h_src, nbr, mask)
    return ref.gat_na(p, h_dst, h_src, nbr, mask)


def gat_aggregate_stacked(p_stacked: Dict, h_dst, h_src, nbr, mask,
                          use_pallas: bool = False) -> torch.Tensor:
    """Stacked GAT NA: ``nbr/mask [P, N, K]``, params ``[P, H, Dh]`` — the
    whole metapath stack is ONE kernel launch."""
    if use_pallas:
        return _gat_na(p_stacked, h_dst, h_src, nbr, mask)
    return ref.gat_na(p_stacked, h_dst, h_src, nbr, mask)


def gat_aggregate_stacked_fused_sa(p_stacked: Dict, h_dst, h_src, nbr, mask,
                                   sem: Dict, use_pallas: bool = False):
    """Stacked GAT NA with the fused NA→SA epilogue.  Returns
    ``(z [P, N, H, Dh] elu-activated, w [P])``."""
    if use_pallas:
        return _gat_na(p_stacked, h_dst, h_src, nbr, mask, sem=sem)
    return ref.gat_na_fused_sa(p_stacked, h_dst, h_src, nbr, mask,
                               sem["W"], sem["b"], sem["q"])


def semantic_combine(z, beta, use_pallas: bool = False) -> torch.Tensor:
    """SA pass 2 only: ``sum_p beta_p z_p`` — one read of the stack."""
    if use_pallas:
        return declared(
            "EW", lambda: _sem.combine_work(z, beta),
            _sem.semantic_combine, z, beta)
    return ref.semantic_combine(z, beta)


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    use_pallas: bool = False) -> torch.Tensor:
    """GQA attention: ``q [B, S, H, Dh]``, ``k, v [B, Sk, KVH, Dh]`` ->
    ``[B, S, H, Dh]``, causal and/or windowed (the LM's prefill) or neither
    (the encoder's self-attention; with ``Sk != S`` the decoder's
    cross-attention)."""
    if use_pallas:
        return declared(
            "DM", lambda: _flash.work(q, k, causal, window),
            _flash.flash_attention, q, k, v, causal=causal, window=window)
    return ref.mha_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, kv_len, use_pallas: bool = False,
                     return_lse: bool = False):
    """One-token GQA attention over the first ``kv_len[b]`` cache rows:
    ``q [B, H, Dh]``, ``k, v [B, S, KVH, Dh]`` -> ``[B, H, Dh]``; with
    ``return_lse`` also each row's log-sum-exp ``[B, H]`` fp32 (a rank's
    partial over its shard of a sequence-sharded cache)."""
    if use_pallas:
        return declared(
            "DM", lambda: _dec.work(q, k, kv_len, return_lse),
            _dec.decode_attention, q, k, v, kv_len, return_lse=return_lse)
    return ref.decode_attention(q, k, v, kv_len, return_lse=return_lse)


# every launch counter of the kernel wrappers: name -> (wrapper, attribute)
COUNTERS = {
    "gat_na": (_gat.gat_na, "launches"),
    "gat_na_fused_sa": (_gat.gat_na, "fused_launches"),
    "semantic_combine": (_sem.semantic_combine, "launches"),
    "segment_spmm": (_spmm.segment_spmm, "launches"),
    "segment_sum": (_ssum.segment_sum, "launches"),
    "fused_fp_na": (_ffn.fused_fp_na, "launches"),
    "cached_gather": (_fc.cached_gather, "launches"),
    "semantic_scores": (_sem.semantic_scores, "launches"),
    "flash_attention": (_flash.flash_attention, "launches"),
    "decode_attention": (_dec.decode_attention, "launches"),
    "decode_attention_lse": (_dec.decode_attention, "lse_launches"),
}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count, by name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` (by name, as :func:`launch_counts` gives) to the
    counts: a replayed CUDA graph launches its kernels without running
    their wrappers (``graphs.compiled``)."""
    for name, n in delta.items():
        if n:
            fn, attr = COUNTERS[name]
            setattr(fn, attr, getattr(fn, attr) + n)
