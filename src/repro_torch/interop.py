"""The parity bridge: host arrays into the port's tensors, and the port's
device rule.

``params_from_numpy`` carries a parameter tree made by the reference's own
``init`` into the port unchanged, so the two packages can run the same
model (``jax.random`` streams cannot be reproduced in torch): the HGNN trees
(``fp{t}``, ``cls``, ``gat{a_dst, a_src}`` stacked ``[P, H, Dh]`` — or,
for HAN's ``csr`` and ``bucketed`` layouts, a list of ``P`` such dicts of
``[H, Dh]`` — ``sem{W, b, q}``, ``layers[l-1]{fp, gat, sem}``; GCN's
``w1``, ``w2``, ``layers[l-1]{fp}``) and the LM tree (``embed``,
``ln_f``, ``lm_head``, ``runs[i]`` stacked ``[L, ...]``: ``{ln1, attn{wq,
wk, wv, wo}, ln2, mlp{w_gate, w_up, w_down}}`` for a dense run, ``mlp``
replaced by ``moe{router, w_gate, w_up, w_down[, dense{...}]}`` (experts
``[L, E, ...]``) for a MoE run, ``{ln1, mamba{w_z, w_x, w_B, w_C, w_dt,
conv_x, conv_B, conv_C, conv_bias, A_log, D, dt_bias, norm_g, out_proj}}``
for a Mamba run, and ``{}`` for each application of zamba2's ``shared``
block, whose one unstacked ``{ln1, attn, ln2, mlp}`` sits beside
``runs``; a vlm's tree is a dense one), and the encdec tree (``embed``,
``enc`` stacked ``[L, ...]`` ``{ln1, attn, ln2, mlp}``, ``dec`` stacked
``{ln1, self_attn, ln2, cross_attn, ln3, mlp}``, ``ln_enc``, ``ln_f``,
``lm_head``).  ``batch_from_numpy`` does the same for a prepared
batch.  Leaves are copied with ``np.array`` (not ``np.asarray``, whose
buffer behind a JAX array is read-only) and handed to ``torch.from_numpy``.
numpy has no bfloat16 of its own: a leaf whose dtype is named
``bfloat16`` goes through float32 (exact) into a ``torch.bfloat16``
tensor.  Python scalars (``n_nodes``, ``feat_dims``) stay as they are.
``state_from_numpy`` carries a reference ``TrainState`` (step, parameters,
AdamW or Adafactor state) into the port's, so the two packages can train
from one state.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.tree import map as map_leaves

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


def _leaf(x: Any, device: torch.device):
    if isinstance(x, (bool, int, float, str, np.integer, np.floating)):
        return x
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device)


def _tree(x: Any, device: torch.device):
    return map_leaves(lambda leaf: _leaf(leaf, device), x)


def params_from_numpy(tree: Any, device: DeviceLike = None):
    """Map a parameter tree of arrays (numpy or JAX) to torch tensors."""
    return _tree(tree, resolve_device(device))


def batch_from_numpy(batch: Any, device: DeviceLike = None):
    """Map a prepared batch (dict of arrays, nested dicts and lists, Python
    scalars) to torch tensors on ``device``."""
    return _tree(batch, resolve_device(device))


def state_from_numpy(state: Any, device: DeviceLike = None):
    """A reference ``TrainState(step, params, opt)`` (numpy or JAX arrays)
    as the port's ``train_step.TrainState``: ``step`` a 0-d int32 tensor,
    the parameters as :func:`params_from_numpy` maps them, the optimizer
    state (``AdamWState(mu, nu)`` or ``AdafactorState(vr, vc, v)``) as the
    port's NamedTuple of the same name and fields."""
    from repro_torch.train import optimizer, train_step

    device = resolve_device(device)
    # the reference's NamedTuple becomes the port's of the same name
    opt = getattr(optimizer, type(state.opt).__name__)(
        *_tree(tuple(state.opt), device))
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=device)
    return train_step.TrainState(step, _tree(state.params, device), opt)
