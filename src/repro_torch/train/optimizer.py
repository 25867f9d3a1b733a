"""Optimizers from scratch (port of ``repro/train/optimizer.py``): AdamW and
Adafactor (factored second moment), the warmup + cosine schedule and
global-norm clipping.

Each optimizer is an ``Optimizer(init, update, state_specs)`` over trees
of tensors and is functional, as in the reference: ``update(grads, state, params, step)
-> (params, state)`` returns new tensors and changes none it is given.  The
update is computed in fp32, in the reference's order of operations, and
each parameter is cast back to its dtype.  ``torch.optim`` is not used: its
bias correction and its weight-decay order compute another update.  The
schedule reads ``step`` as a tensor on the device, so an update makes no
host sync.  ``state_specs(param_specs, mesh)`` lays the state out on a
mesh as the reference does: AdamW's moments as their parameters,
Adafactor's factored statistics as their parameter with the reduced dim
dropped, its full statistics of rank < 2 leaves as theirs.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree
from repro_torch.dist.sharding import NamedSharding, P

# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine to
    ``floor * peak_lr`` at ``total``.  ``lr(step)`` takes an int or an
    integer tensor and returns an fp32 tensor on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * (step + 1) / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr


def global_norm(grads) -> torch.Tensor:
    """``sqrt`` of the sum over leaves of each leaf's fp32 sum of squares."""
    sums = [torch.sum(torch.square(x.float())) for x in tree.leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-9))`` (in fp32,
    cast back).  Returns ``(grads, norm)``."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree.map(lambda x: (x.float() * scale).to(x.dtype), grads), gn


class Optimizer(NamedTuple):
    init: Callable  # params -> state
    update: Callable  # (grads, state, params, step) -> (new_params, new_state)
    state_specs: Callable = None  # (param NamedShardings, mesh) -> state's


def _unzip(params, out, n: int, state_cls):
    """``(params, state_cls(...))`` from the per-leaf update tuples ``out``
    (in ``params``' leaf order), each field a tree of ``params``' shape."""
    trees = [tree.unflatten(params, [o[i] for o in out]) for i in range(n)]
    return trees[0], state_cls(*trees[1:])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


class AdamWState(NamedTuple):
    mu: Any
    nu: Any


def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          state_dtype="float32") -> Optimizer:
    sd = getattr(torch, state_dtype)

    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=sd, device=p.device)

        return AdamWState(tree.map(z, params), tree.map(z, params))

    @torch.no_grad()
    def update(grads, state, params, step):
        step = torch.as_tensor(step)
        lr = lr_fn(step)
        t = (step + 1).to(torch.float32)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)

        def upd(g, m, v, p):
            g = g.float()
            pf = p.float()
            m_new = b1 * m.float() + (1 - b1) * g
            v_new = b2 * v.float() + (1 - b2) * g * g
            step_v = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            p_new = pf - lr * (step_v + weight_decay * pf)
            return p_new.to(p.dtype), m_new.to(sd), v_new.to(sd)

        out = [upd(*xs) for xs in zip(*map(tree.leaves, (
            grads, state.mu, state.nu, params)))]
        return _unzip(params, out, 3, AdamWState)

    def state_specs(param_specs, mesh):
        return AdamWState(param_specs, param_specs)

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum)
# ---------------------------------------------------------------------------


class AdafactorState(NamedTuple):
    vr: Any  # row stats: the param reduced over dim -1
    vc: Any  # column stats: the param reduced over dim -2
    v: Any  # full stats for rank < 2 leaves (a [1] placeholder elsewhere)


def _factored(p) -> bool:
    return p.dim() >= 2


def adafactor(lr_fn, decay=0.99, eps=1e-30, clip_thresh=1.0,
              weight_decay=0.0) -> Optimizer:
    def init(params):
        def zeros(p, shape):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vr(p):
            return zeros(p, p.shape[:-1] if _factored(p) else (1,))

        def vc(p):
            return zeros(p, p.shape[:-2] + p.shape[-1:] if _factored(p)
                         else (1,))

        def v(p):
            return zeros(p, (1,) if _factored(p) else p.shape)

        return AdafactorState(tree.map(vr, params), tree.map(vc, params),
                              tree.map(v, params))

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_fn(torch.as_tensor(step))

        def upd(g, vr, vc, v, p):
            g = g.float()
            g2 = g * g + eps
            if _factored(p):
                vr_new = decay * vr + (1 - decay) * g2.mean(dim=-1)
                vc_new = decay * vc + (1 - decay) * g2.mean(dim=-2)
                denom = (vr_new[..., None] / torch.clamp(
                    vr_new.mean(dim=-1, keepdim=True)[..., None], min=eps)
                ) * vc_new[..., None, :]
                u = g / torch.sqrt(torch.clamp(denom, min=eps))
                v_new = v
            else:
                v_new = decay * v + (1 - decay) * g2
                u = g / torch.sqrt(torch.clamp(v_new, min=eps))
                vr_new, vc_new = vr, vc
            # update clipping (RMS(u) <= clip_thresh)
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms / clip_thresh, min=1.0)
            pf = p.float()
            p_new = pf - lr * (u + weight_decay * pf)
            return p_new.to(p.dtype), vr_new, vc_new, v_new

        out = [upd(*xs) for xs in zip(*map(tree.leaves, (
            grads, state.vr, state.vc, state.v, params)))]
        return _unzip(params, out, 4, AdafactorState)

    def state_specs(param_specs, mesh):
        def vr_spec(ns):
            s = list(ns.spec)
            return NamedSharding(mesh, P(*s[:-1]) if len(s) >= 2 else P())

        def vc_spec(ns):
            s = list(ns.spec)
            return NamedSharding(mesh, P(*(s[:-2] + s[-1:])) if len(s) >= 2
                                 else P())

        def v_spec(ns):
            return ns if len(ns.spec) < 2 else NamedSharding(mesh, P())

        return AdafactorState(tree.map(vr_spec, param_specs),
                              tree.map(vc_spec, param_specs),
                              tree.map(v_spec, param_specs))

    return Optimizer(init, update, state_specs)


def lr_schedule(total_steps: int = 10_000):
    """``build_optimizer``'s learning rate over a run of ``total_steps``:
    a peak of 3e-4 after a warmup of a tenth of the run (at most 500
    steps), then a cosine down to a tenth of the peak."""
    return warmup_cosine(3e-4, min(500, total_steps // 10 + 1), total_steps)


def build_optimizer(cfg, total_steps: int = 10_000) -> Optimizer:
    lr = lr_schedule(total_steps)
    if cfg.optimizer == "adafactor":
        return adafactor(lr)
    return adamw(lr, state_dtype=cfg.opt_state_dtype)
