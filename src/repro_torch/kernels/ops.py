"""Public kernel entry points of the executor (port of the HGNN part of
``repro/kernels/ops.py:104-139``).

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
kernels".  The other wrappers of the reference (``cached_gather``,
``semantic_attention``, ``flash_attention``, ``decode_attention``, the
unstacked ``gat_aggregate``) serve paths that are not ported yet (ROADMAP
Queue 2).
"""
from __future__ import annotations

from typing import Dict

import torch

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


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    _gat.gat_na.launches = 0
    _gat.gat_na.fused_launches = 0
    _sem.semantic_combine.launches = 0
    _spmm.segment_spmm.launches = 0
    _ffn.fused_fp_na.launches = 0


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count, by name."""
    return {"gat_na": _gat.gat_na.launches,
            "gat_na_fused_sa": _gat.gat_na.fused_launches,
            "semantic_combine": _sem.semantic_combine.launches,
            "segment_spmm": _spmm.segment_spmm.launches,
            "fused_fp_na": _ffn.fused_fp_na.launches}
