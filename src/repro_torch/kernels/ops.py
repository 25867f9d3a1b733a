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

The name ``use_pallas`` is the reference's; here it means "hand-written
kernels".  ``flash_attention`` and ``decode_attention`` serve the LM's
prefill and decode (``nn/attention.py``); the reference takes its Pallas
kernels there only on a TPU backend, which here is the device rule above.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import feature_cache as _fc
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_fp_na as _ffn
from repro_torch.kernels import gat_na as _gat
from repro_torch.kernels import ref
from repro_torch.kernels import segment_spmm as _spmm
from repro_torch.kernels import semantic_attn as _sem


def segment_spmm(h_src, nbr, mask, mean: bool = True,
                 use_pallas: bool = False) -> torch.Tensor:
    """Padded-neighbour sum/mean aggregation (RGCN's mean NA):
    ``h_src [M, D]``, ``nbr``/``mask`` ``[N, K]`` -> ``[N, D]``."""
    if use_pallas:
        return _spmm.segment_spmm(h_src, nbr, mask, mean=mean)
    return ref.segment_spmm(h_src, nbr, mask, mean=mean)


def fused_fp_na(x_src, w, nbr, mask, mean: bool = True,
                use_pallas: bool = False) -> torch.Tensor:
    """Fused FP + NA: ``mean_k(x[nbr]) @ W`` with the projection in the
    kernel body: ``x [M, F]``, ``W [F, D]`` -> ``[N, D]``."""
    if use_pallas:
        return _ffn.fused_fp_na(x_src, w, nbr, mask, mean=mean)
    return ref.fused_fp_na(x_src, w, nbr, mask, mean=mean)


def semantic_attention(z, w, b, q, use_pallas: bool = False) -> torch.Tensor:
    """Both SA passes over the stacked ``[P, N, D]`` input: the scores
    kernel, the softmax over ``P``, the combine kernel."""
    if use_pallas:
        return _sem.semantic_attention(z, w, b, q)
    return ref.semantic_attention(z, w, b, q)


def cached_gather(table, hot, idx, use_pallas: bool = False) -> torch.Tensor:
    """Hot-row cache gather (``core/residency.py``): the rows of the
    extended pool ``concat(table, table[hot])``; indices ``>= len(table)``
    hit the cache section."""
    if use_pallas:
        return _fc.cached_gather(table, hot, idx)
    return ref.cached_gather(table, hot, idx)


def gat_aggregate(p: Dict, h_dst, h_src, nbr, mask,
                  use_pallas: bool = False) -> torch.Tensor:
    """Unstacked GAT NA: ``nbr/mask [N, K]``, params ``[H, Dh]`` ->
    ``[N, H, Dh]`` (MAGNN's instance attention, one launch a metapath)."""
    if use_pallas:
        return _gat.gat_na(p, h_dst, h_src, nbr, mask)
    return ref.gat_na(p, h_dst, h_src, nbr, mask)


def gat_aggregate_stacked(p_stacked: Dict, h_dst, h_src, nbr, mask,
                          use_pallas: bool = False) -> torch.Tensor:
    """Stacked GAT NA: ``nbr/mask [P, N, K]``, params ``[P, H, Dh]`` — the
    whole metapath stack is ONE kernel launch."""
    if use_pallas:
        return _gat.gat_na(p_stacked, h_dst, h_src, nbr, mask)
    return ref.gat_na(p_stacked, h_dst, h_src, nbr, mask)


def gat_aggregate_stacked_fused_sa(p_stacked: Dict, h_dst, h_src, nbr, mask,
                                   sem: Dict, use_pallas: bool = False):
    """Stacked GAT NA with the fused NA→SA epilogue.  Returns
    ``(z [P, N, H, Dh] elu-activated, w [P])``."""
    if use_pallas:
        return _gat.gat_na(p_stacked, h_dst, h_src, nbr, mask, sem=sem)
    return ref.gat_na_fused_sa(p_stacked, h_dst, h_src, nbr, mask,
                               sem["W"], sem["b"], sem["q"])


def semantic_combine(z, beta, use_pallas: bool = False) -> torch.Tensor:
    """SA pass 2 only: ``sum_p beta_p z_p`` — one read of the stack."""
    if use_pallas:
        return _sem.semantic_combine(z, beta)
    return ref.semantic_combine(z, beta)


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    use_pallas: bool = False) -> torch.Tensor:
    """Causal / windowed GQA attention: ``q [B, S, H, Dh]``, ``k, v [B, S,
    KVH, Dh]`` -> ``[B, S, H, Dh]`` (the LM's prefill)."""
    if use_pallas:
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return ref.mha_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, kv_len, use_pallas: bool = False
                     ) -> torch.Tensor:
    """One-token GQA attention over the first ``kv_len[b]`` cache rows:
    ``q [B, H, Dh]``, ``k, v [B, S, KVH, Dh]`` -> ``[B, H, Dh]``."""
    if use_pallas:
        return _dec.decode_attention(q, k, v, kv_len)
    return ref.decode_attention(q, k, v, kv_len)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    _gat.gat_na.launches = 0
    _gat.gat_na.fused_launches = 0
    _sem.semantic_combine.launches = 0
    _spmm.segment_spmm.launches = 0
    _ffn.fused_fp_na.launches = 0
    _fc.cached_gather.launches = 0
    _sem.semantic_scores.launches = 0
    _flash.flash_attention.launches = 0
    _dec.decode_attention.launches = 0


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count, by name."""
    return {"gat_na": _gat.gat_na.launches,
            "gat_na_fused_sa": _gat.gat_na.fused_launches,
            "semantic_combine": _sem.semantic_combine.launches,
            "segment_spmm": _spmm.segment_spmm.launches,
            "fused_fp_na": _ffn.fused_fp_na.launches,
            "cached_gather": _fc.cached_gather.launches,
            "semantic_scores": _sem.semantic_scores.launches,
            "flash_attention": _flash.flash_attention.launches,
            "decode_attention": _dec.decode_attention.launches}
