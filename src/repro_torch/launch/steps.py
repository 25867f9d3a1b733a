"""Step builders (port of ``repro/launch/steps.py``): (arch config, shape,
mesh) -> a step function with its abstract inputs and their shardings.

One builder a shape kind:

  train    -> train_step(state, batch) -> (state, {loss, grad_norm})
  prefill  -> prefill(params, batch) -> (logits, caches)
  decode   -> decode(params, token, caches, pos) -> (logits, caches)

``in_specs`` are meta tensors (the port's ``ShapeDtypeStruct``; the
weights come from a meta-device init, :class:`~repro_torch.nn.mlp.
MetaGenerator`); ``in_shardings`` / ``out_shardings`` are trees of
:class:`~repro_torch.dist.sharding.NamedSharding`.  Each step runs its
function under ``use_mesh(mesh)``, so the layers' ``shard`` constraints
name this mesh's axes.  The output shapes are derived from the config
(the reference traces the function with ``jax.eval_shape``).

:func:`jit_step` is the reference's ``jax.jit`` with the shardings and
``donate_argnums``: its call lays each input out as ``in_shardings`` says
(``distribute_tensor`` of a full tensor, a redistribute of a DTensor, a
DTensor already laid out as it is), outside the graph, and hands the
DTensors to ``graphs.compiled`` of ``fn`` together with the
``out_shardings`` layout of its outputs.  On the card the first call of a
signature warms up and captures one CUDA graph, and later calls replay it,
so the DTensor dispatch is paid once (``graphs``'s module docstring); off
the card (the CPU, a gloo mesh) the step runs eagerly.  Its ``fn`` is the
eager arm: the same layout and ``fn`` with no capture.

What each argument is to the graph:

* the weights (position 0 of prefill and decode) are held: lay them out
  once (``distribute_tree``) and pass the same DTensors every call;
* what ``built.donate`` names is donated, as in the reference: the train
  step's state and the decode step's caches.  Each call copies the step's
  new state (or caches) into the tensors passed and returns them, so a
  loop passes the same addresses every call; the caller's old state is
  gone after the call.  The decode writes its caches in place, so there
  the copy is empty;
* every other argument (a batch, the token that an ``argmax`` made, the
  position) is new each step: it is copied into the signature's own
  device buffers before the replay (``copied=``), so it need not stay
  where it lies.  A held tensor that moved still raises.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import graphs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.specs import (cache_shardings, input_shardings,
                                       input_specs)
from repro_torch.dist.param_sharding import param_specs
from repro_torch.dist.sharding import (BATCH, MODEL, NamedSharding, P,
                                       distribute_tree, named, use_mesh)
from repro_torch.nn.mlp import MetaGenerator
from repro_torch.train.optimizer import build_optimizer
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          state_shardings)


class BuiltStep(NamedTuple):
    fn: Any  # the step function
    in_specs: Tuple  # abstract inputs (meta tensors), positional
    in_shardings: Tuple
    out_shardings: Any
    donate: Tuple  # the donated positions (jit_step's donate=)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _logits_sharding(mesh, shape) -> NamedSharding:
    """``[B, S, V]``: batch over (pod, data), vocab over model, with the
    divisibility guard (mamba2's 50280 or seamless's 256206 vocab, a
    batch of 1)."""
    return named(mesh, shape, (BATCH, None, MODEL))


def _params_abstract(cfg: ModelConfig):
    if cfg.family == "encdec":
        from repro_torch.nn.encdec import init_encdec_params

        return init_encdec_params(MetaGenerator(), cfg)
    from repro_torch.nn.transformer import init_lm_params

    return init_lm_params(MetaGenerator(), cfg)


def _prefill_caches_abstract(cfg: ModelConfig, batch: int, seq: int):
    """The caches a prefill of ``seq`` positions returns, as meta tensors:
    the encdec dict, or a run's ``{"k", "v"}`` ``[L, B, S, KVH, Dh]``
    (the whole prompt, no ring) or its ``MambaCache``."""
    from repro_torch.nn import attention as attn
    from repro_torch.nn.ssm import MambaCache, init_mamba_cache
    from repro_torch.nn.transformer import layer_runs

    dt = getattr(torch, cfg.dtype)
    _, kvh = attn._heads(cfg)
    dh = cfg.resolved_head_dim
    if cfg.family == "encdec":
        def kv(s):
            return _meta((cfg.dec_layers, batch, s, kvh, dh), dt)
        return {"self_k": kv(seq), "self_v": kv(seq), "cross_k": kv(seq),
                "cross_v": kv(seq)}
    out = []
    for kind, count in layer_runs(cfg):
        if kind == "mamba":
            c0 = init_mamba_cache(cfg, batch, dt, "meta")
            out.append(MambaCache(*[_meta((count,) + f.shape, f.dtype)
                                    for f in c0]))
        else:
            out.append({k: _meta((count, batch, seq, kvh, dh), dt)
                        for k in ("k", "v")})
    return out


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     n_microbatches: int = 0) -> BuiltStep:
    opt = build_optimizer(cfg)
    step_fn = make_train_step(
        cfg, opt, n_microbatches=n_microbatches or cfg.n_microbatches)

    def fn(state, batch):
        with use_mesh(mesh):
            return step_fn(state, batch)

    state_abs = init_train_state(MetaGenerator(), cfg, opt)
    st_sh = state_shardings(state_abs, opt, mesh, fsdp=cfg.fsdp,
                            fsdp_experts=cfg.fsdp_experts)
    metrics_sh = {"loss": NamedSharding(mesh, P()),
                  "grad_norm": NamedSharding(mesh, P())}
    return BuiltStep(fn=fn,
                     in_specs=(state_abs, input_specs(cfg, shape)),
                     in_shardings=(st_sh, input_shardings(cfg, shape, mesh)),
                     out_shardings=(st_sh, metrics_sh), donate=(0,))


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                       mesh) -> BuiltStep:
    if cfg.family == "encdec":
        from repro_torch.nn.encdec import encdec_prefill

        def fn(params, batch):
            with use_mesh(mesh):
                return encdec_prefill(params, cfg, batch["frames"],
                                      batch["tokens"])
    else:
        from repro_torch.nn.transformer import lm_prefill

        def fn(params, batch):
            with use_mesh(mesh):
                return lm_prefill(params, cfg, batch["tokens"],
                                  batch.get("extra_embeds"))

    params_abs = _params_abstract(cfg)
    p_sh = param_specs(params_abs, mesh, fsdp=cfg.fsdp,
                       fsdp_experts=cfg.fsdp_experts)
    b = shape.global_batch
    seq = shape.seq_len + (cfg.n_frontend_embeds if cfg.family == "vlm"
                           else 0)
    caches_abs = _prefill_caches_abstract(cfg, b, seq)
    return BuiltStep(
        fn=fn,
        in_specs=(params_abs, input_specs(cfg, shape)),
        in_shardings=(p_sh, input_shardings(cfg, shape, mesh)),
        out_shardings=(_logits_sharding(mesh, (b, 1, cfg.vocab)),
                       cache_shardings(cfg, mesh, caches_abs)),
        donate=())


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig,
                      mesh) -> BuiltStep:
    if cfg.family == "encdec":
        from repro_torch.nn.encdec import encdec_decode_step as step
    else:
        from repro_torch.nn.transformer import lm_decode_step as step

    def fn(params, token, caches, pos):
        with use_mesh(mesh):
            return step(params, cfg, token, caches, pos)

    params_abs = _params_abstract(cfg)
    p_sh = param_specs(params_abs, mesh, fsdp=cfg.fsdp,
                       fsdp_experts=cfg.fsdp_experts)
    ins = input_specs(cfg, shape)
    ins_sh = input_shardings(cfg, shape, mesh)
    logits_sh = _logits_sharding(mesh, (shape.global_batch, 1, cfg.vocab))
    return BuiltStep(
        fn=fn,
        in_specs=(params_abs, ins["token"], ins["caches"], ins["pos"]),
        in_shardings=(p_sh, ins_sh["token"], ins_sh["caches"],
                      ins_sh["pos"]),
        out_shardings=(logits_sh, ins_sh["caches"]),
        donate=(2,))


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
               **kw) -> BuiltStep:
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh)
    return build_decode_step(cfg, shape, mesh)


class JitStep:
    """:func:`jit_step`'s call (module docstring); ``fn`` is its eager arm
    and ``compiled`` the ``graphs.Compiled`` it replays."""

    def __init__(self, built: BuiltStep):
        self.built = built

        def step(*args):
            return distribute_tree(built.fn(*args), built.out_shardings)

        self.step = step
        # the per-step inputs: every position neither the weights or
        # state (0) nor donated
        self.compiled = graphs.compiled(
            step, donate=built.donate,
            copied=[i for i in range(1, len(built.in_shardings))
                    if i not in built.donate])

    def _laid(self, args) -> tuple:
        return tuple(distribute_tree(a, s)
                     for a, s in zip(args, self.built.in_shardings))

    def __call__(self, *args):
        return self.compiled(*self._laid(args))

    def fn(self, *args):
        """The step eagerly: the same layout, no capture, no donation."""
        return self.step(*self._laid(args))


def jit_step(built: BuiltStep) -> JitStep:
    """The reference's ``jax.jit(fn, in_shardings, out_shardings,
    donate_argnums)`` (module docstring)."""
    return JitStep(built)
