"""Train step (port of ``repro/train/train_step.py``): loss -> gradients ->
clip -> optimizer, with optional microbatch gradient accumulation.

Gradients are taken by ``torch.autograd.grad`` with respect to the leaves
of the parameter tree, in the model dtype, as the reference's
``jax.value_and_grad``.  With microbatches the batch is sliced along its
first axis as the reference's ``dynamic_slice_in_dim`` slices it, the
gradients are added in fp32 in microbatch order and divided by the count,
and so is the loss.  The optimizer update is fp32 (``train/optimizer.py``).
A step reads nothing back to the host: the loss and the gradient norm come
back as 0-d tensors on the device.  ``state_shardings`` lays a state out on
a mesh as the reference does (``param_specs`` for the weights, the
optimizer's ``state_specs`` for its state, the step replicated); a step
on DTensors of that layout runs through the same code (``launch/
steps.py``), on any mesh a state is moved or restored onto
(``train/elastic.reshard_state``, ``train/checkpoint.restore(
shardings=)``).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.param_sharding import param_specs
from repro_torch.dist.sharding import NamedSharding, P
from repro_torch.train.optimizer import Optimizer, clip_by_global_norm


class TrainState(NamedTuple):
    step: torch.Tensor  # [] int32
    params: Any
    opt: Any


def loss_fn_for(cfg: ModelConfig) -> Callable:
    if cfg.family == "encdec":
        from repro_torch.nn.encdec import encdec_loss

        return functools.partial(encdec_loss, cfg=cfg)
    from repro_torch.nn.transformer import lm_loss

    return functools.partial(lm_loss, cfg=cfg)


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     optimizer: Optimizer) -> TrainState:
    """Step 0, the weights of ``init_encdec_params`` (the encdec family) or
    ``init_lm_params`` drawn on ``gen``'s device, and the optimizer's zero
    state beside them."""
    if cfg.family == "encdec":
        from repro_torch.nn.encdec import init_encdec_params

        params = init_encdec_params(gen, cfg)
    else:
        from repro_torch.nn.transformer import init_lm_params

        params = init_lm_params(gen, cfg)
    return TrainState(torch.zeros((), dtype=torch.int32, device=gen.device),
                      params, optimizer.init(params))


def state_shardings(state_shapes: TrainState, optimizer: Optimizer, mesh,
                    fsdp: bool = True, fsdp_experts: bool = True
                    ) -> TrainState:
    """The ``NamedSharding`` tree of a train state."""
    pspecs = param_specs(state_shapes.params, mesh, fsdp=fsdp,
                         fsdp_experts=fsdp_experts)
    return TrainState(step=NamedSharding(mesh, P()), params=pspecs,
                      opt=optimizer.state_specs(pspecs, mesh))


def value_and_grad(loss_fn: Callable, params, batch) -> Tuple[torch.Tensor,
                                                              Any]:
    """``(loss, grads)`` of ``loss_fn(params, batch=batch)``, the grads in
    ``params``' structure and dtypes."""
    flat = [p.detach().requires_grad_() for p in tree.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree.unflatten(params, flat), batch=batch)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), tree.unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    n_microbatches: int = 1, clip_norm: float = 1.0):
    loss_fn = loss_fn_for(cfg)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        if n_microbatches <= 1:
            loss, grads = value_and_grad(loss_fn, state.params, batch)
        else:
            def slice_mb(x, i):
                mb = x.shape[0] // n_microbatches
                return x[i * mb:(i + 1) * mb]

            grads = tree.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            for i in range(n_microbatches):
                mb = tree.map(lambda x: slice_mb(x, i), batch)
                mb_loss, mb_grads = value_and_grad(loss_fn, state.params, mb)
                grads = tree.map(lambda a, g: a + g.float(), grads, mb_grads)
                loss = loss + mb_loss
                del mb_grads
            grads = tree.map(lambda g: g / n_microbatches, grads)
            loss = loss / n_microbatches

        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            params, opt = optimizer.update(grads, state.opt, state.params,
                                           state.step)
        new_state = TrainState(state.step + 1, params, opt)
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
