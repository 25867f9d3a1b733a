"""Stage 4 — Semantic Aggregation (SA) (port of
``repro/core/semantics.py:19-77``).

Baseline: the per-metapath NA results arrive as a list and are stacked
explicitly (the paper's DR-Type concat).  Optimized: NA already produced
the stacked ``[P, N, D]`` tensor, so SA runs concat-free.  The weighted
combine is ``kernels/ref.py::semantic_combine`` (sum over ``p`` in order),
the arithmetic the CUDA combine kernel repeats.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import ref


def init_semantic_attention(gen: torch.Generator, d_in: int,
                            d_hidden: int) -> Dict[str, torch.Tensor]:
    return {
        "W": torch.randn((d_in, d_hidden), generator=gen) / math.sqrt(d_in),
        "b": torch.zeros((d_hidden,), dtype=torch.float32),
        "q": torch.randn((d_hidden,), generator=gen) / math.sqrt(d_hidden),
    }


def semantic_attention(p: Dict[str, torch.Tensor], z: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HAN-style semantic attention. ``z``: [P, N, D] -> [N, D].

    ``mask`` ([N], optional): row validity for sampled minibatches — the
    per-metapath score mean runs over the real rows only.
    """
    s = torch.tanh(z @ p["W"] + p["b"])  # [P, N, H]   DM + EW
    sc = s @ p["q"]  # [P, N]
    if mask is None:
        w = sc.mean(dim=1)  # [P]  Reduce
    else:
        w = (sc * mask[None, :]).sum(dim=1) / torch.clamp(mask.sum(), min=1.0)
    beta = torch.softmax(w, dim=0)  # [P]
    return ref.semantic_combine(z, beta)  # weighted Reduce


def semantic_attention_list(p: Dict[str, torch.Tensor],
                            z_list: List[torch.Tensor],
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Baseline SA: explicit stack (DR-Type concat) then attention."""
    return semantic_attention(p, torch.stack(z_list, dim=0), mask)


def semantic_attention_partitioned(p: Dict[str, torch.Tensor],
                                   z: torch.Tensor,
                                   inv: torch.Tensor) -> torch.Tensor:
    """Semantic attention over partition-local stacks: ``z [K, P, n, D]``
    (pad rows zero) -> ``[K, n, D]``.

    ``inv [N]`` is the head's inverse permutation, global row -> flat
    own-order slot, so it names every real row once and no pad row.  The
    reference sums the masked scores over ``(K, n)`` (``:74``), an order
    that depends on ``K``; here the scores go to global row order through
    ``inv`` first and are averaged as the unpartitioned arm averages them,
    so ``w`` does not depend on ``K`` or the assignment, and at ``K = 1``
    it has the unpartitioned arm's bits.  The combine stays
    partition-local, summed over ``p`` in order."""
    s = torch.tanh(z @ p["W"] + p["b"])  # [K, P, n, H]   DM + EW
    sc = s @ p["q"]  # [K, P, n]
    k, n_p, n = sc.shape
    sc = sc.transpose(0, 1).reshape(n_p, k * n).index_select(1, inv)
    beta = torch.softmax(sc.mean(dim=1), dim=0)  # [P] over the N real rows
    return ref.semantic_combine(z.transpose(0, 1), beta)  # [K, n, D]
