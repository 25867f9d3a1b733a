"""The parity bridge: host arrays into the port's tensors, and the port's
device rule.

``params_from_numpy`` carries a parameter tree made by the reference's own
``init`` into the port unchanged, so the two packages can run the same
model (``jax.random`` streams cannot be reproduced in torch): the HGNN trees
(``fp{t}``, ``cls``, ``gat{a_dst, a_src}`` stacked ``[P, H, Dh]``, ``sem{W,
b, q}``, ``layers[l-1]{fp, gat, sem}``) and the LM tree (``embed``,
``ln_f``, ``lm_head``, ``runs[i]{ln1, attn{wq, wk, wv, wo}, ln2, mlp{...}}``
stacked ``[L, ...]``).  ``batch_from_numpy`` does the same for a prepared
batch.  Leaves are copied with ``np.array`` (not ``np.asarray``, whose
buffer behind a JAX array is read-only) and handed to ``torch.from_numpy``.
numpy has no bfloat16 of its own: a leaf whose dtype is named
``bfloat16`` goes through float32 (exact) into a ``torch.bfloat16``
tensor.  Python scalars (``n_nodes``, ``feat_dims``) stay as they are.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device of an entry point: the caller's, else the CUDA device.
    Without a GPU, the caller has to ask for the CPU (``device="cpu"``):
    there is no silent fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' (CLI: --device cpu) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _tree(x: Any, device: torch.device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(v, device) for v in x)
    if x is None or isinstance(x, (bool, int, float, str, np.integer,
                                   np.floating)):
        return x
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device: DeviceLike = None):
    """Map a parameter tree of arrays (numpy or JAX) to torch tensors."""
    return _tree(tree, resolve_device(device))


def batch_from_numpy(batch: Any, device: DeviceLike = None):
    """Map a prepared batch (dict of arrays, nested dicts and lists, Python
    scalars) to torch tensors on ``device``."""
    return _tree(batch, resolve_device(device))
